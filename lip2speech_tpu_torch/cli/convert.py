"""Checkpoint conversion CLI: a published reference .pt -> a port
checkpoint file (JAX reference: cli/convert.py, which writes orbax trees).

  stage1      a fairseq stage-1 checkpoint of any preset -> a file holding
              {"model": MultiTargetModel state_dict}; `infer --checkpoint`
              reads it
  vocoder_g   g_######## -> {"generator": MelCodeGenerator state_dict};
              `vocode --checkpoint` reads it
  vocoder_do  do_######## -> {"mpd", "msd"} state_dicts (the MSD's with its
              spectral-norm u buffers)
  speaker     the RTVC speaker encoder (a flat state_dict) -> {"speaker":
              SpeakerEncoder state_dict}
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--kind", required=True,
                   choices=["stage1", "vocoder_g", "vocoder_do", "speaker"])
    p.add_argument("--preset", default="multi_target", help="stage1 only: the variant's preset")
    p.add_argument("--input", required=True, help="reference .pt checkpoint")
    p.add_argument("--output", required=True, help="port checkpoint file")
    args = p.parse_args(argv)

    from lip2speech_tpu_torch.convert import from_reference as conv
    from lip2speech_tpu_torch.core.config import preset
    from lip2speech_tpu_torch.train import checkpoint

    sd = conv.load_torch_state(args.input)
    if args.kind == "stage1":
        content = {"model": conv.stage1_state_dict(sd, preset(args.preset).model)}
    elif args.kind == "vocoder_g":
        content = {"generator": conv.generator_state_dict(sd, preset(args.preset).vocoder)}
    elif args.kind == "vocoder_do":
        content = conv.discriminator_state_dicts(sd)
    else:
        from lip2speech_tpu_torch.models.speaker import convert_rtvc_encoder

        content = {"speaker": convert_rtvc_encoder(sd)}
    checkpoint.save(args.output, content)
    n = sum(t.numel() for part in content.values() for t in part.values())
    print(json.dumps({"kind": args.kind, "output": args.output, "n_params": int(n)}))


if __name__ == "__main__":
    main()
