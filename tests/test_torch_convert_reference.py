"""The port's converter of published reference checkpoints
(lip2speech_tpu_torch/convert/from_reference.py) against the JAX package's
(convert/torch_to_jax.py followed by the port's from_jax): exactly the same
state_dicts for the four stage-1 frontends, the vocoder generator and the
discriminators, from reference-layout modules (tests/ref_mirror.py and the
converter tests' mirrors); the reference's envelopes (fairseq "model", g_
"generator", do_ "mpd" / "msd"); the tiny reference models' outputs through
the port's models; and the convert CLI."""

import argparse

import numpy as np
import pytest
import torch
import torch.nn as tnn
from torch.nn.utils import spectral_norm, weight_norm

from lip2speech_tpu.convert import torch_to_jax as jconv
from lip2speech_tpu.core import config as jcfg
from lip2speech_tpu_torch.cli import convert as convert_cli
from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.convert import from_reference as conv
from lip2speech_tpu_torch.core import config as tcfg
from lip2speech_tpu_torch.models.multi_target import MultiTargetModel
from lip2speech_tpu_torch.models.vocoder import (
    MelCodeGenerator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
)
from lip2speech_tpu_torch.train import checkpoint as ckpt

from ref_mirror import RefConformerModule, RefFrontend, RefMelCodeGenerator, RefMultiTarget
from test_converter_auto_avsr import RefAutoAVSRModel
from test_converter_avhubert import TorchAVHubert
from test_converter_raven import RavenEncoder
from torch_tmp import tmp_path  # noqa: F401  (removed when the test passes)

D_FE = 32                    # the avhubert and raven mirrors' width


def _np(model) -> dict:
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (tnn.BatchNorm1d, tnn.BatchNorm2d, tnn.BatchNorm3d)):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 2.0)
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _trunk(in_dim: int) -> dict:
    """The trainable conformer of a frozen-frontend variant under
    "conformer.", with proj_in (frontend width -> trunk width)."""
    trunk = RefConformerModule(d=64, ff=128, h=4, layers=2, k=7, vocab=204)
    del trunk.encoder.frontend
    trunk.proj_in = tnn.Linear(in_dim, 64)
    trunk.encoder.embed = tnn.Sequential(tnn.Linear(64, 64))
    return {f"conformer.{k}": v for k, v in _np(trunk).items()}


def _frozen(c, kind, dim, heads, ffn):
    return c.MultiTargetConfig(
        frontend=c.FrontendConfig(kind=kind, frozen=True, encoder_dim=dim, encoder_heads=heads,
                                  encoder_ffn_dim=ffn, encoder_layers=2),
        conformer=c.ConformerConfig(dim=64, ffn_dim=128, heads=4, layers=2, conv_kernel=7,
                                    input_dim=dim))


def _reference(kind: str):
    """(reference-layout state_dict, port config, JAX config) of a small
    stage-1 model with the given frontend."""
    torch.manual_seed(0)
    if kind == "resnet3d":
        sd = _np(RefMultiTarget(d=32, ff=64, h=2, layers=1, k=31, vocab=204))
        return sd, tcfg.preset("tiny").model, jcfg.preset("tiny").model
    if kind == "auto_avsr":
        sd = _np(RefAutoAVSRModel())
        return sd, _frozen(tcfg, kind, 48, 2, 96), _frozen(jcfg, kind, 48, 2, 96)
    if kind == "avhubert":
        sd = {f"encoder.w2v_model.{k}": v for k, v in _np(TorchAVHubert()).items()}
        sd.update(_trunk(D_FE))
        return sd, _frozen(tcfg, kind, D_FE, 2, 64), _frozen(jcfg, kind, D_FE, 2, 64)
    enc = RavenEncoder()
    enc.embed = tnn.Sequential(tnn.Linear(512, D_FE))
    sd = {f"encoder.encoder.{k}": v for k, v in _np(enc).items()}
    sd.update({f"encoder.encoder.frontend.{k}": v for k, v in _np(RefFrontend()).items()})
    sd.update(_trunk(D_FE))
    return sd, _frozen(tcfg, kind, D_FE, 2, 64), _frozen(jcfg, kind, D_FE, 2, 64)


def _assert_state_dicts_equal(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("kind", ["resnet3d", "avhubert", "auto_avsr", "raven"])
def test_stage1_conversion_equals_the_jax_converters(kind):
    """Exactly the JAX converter's tree moved by from_jax, and a state_dict
    the port's model loads strict."""
    sd, tc, jc = _reference(kind)
    got = conv.stage1_state_dict(sd, tc)
    _assert_state_dicts_equal(got, from_jax.stage1_state_dict(jconv.convert_multi_target(sd, jc)))
    MultiTargetModel(tc).load_state_dict(got, strict=True)


def test_tiny_reference_multi_target_outputs_through_the_port():
    """The tiny preset's reference model and the port's from the converted
    state_dict, eval mode, a ragged batch: units and mel within 1e-4."""
    torch.manual_seed(0)
    ref_model = RefMultiTarget(d=32, ff=64, h=2, layers=1, k=31, vocab=204).eval()
    sd = _np(ref_model)
    model = MultiTargetModel(tcfg.preset("tiny").model)
    model.load_state_dict(conv.stage1_state_dict(sd, tcfg.preset("tiny").model), strict=True)
    model.eval()
    rng = np.random.default_rng(0)
    video = torch.from_numpy(rng.standard_normal((2, 6, 40, 40), dtype=np.float32))
    mask = torch.from_numpy(np.arange(6)[None, :] < np.array([[6], [4]]))
    spk = torch.from_numpy(rng.standard_normal((2, 256), dtype=np.float32))
    with torch.no_grad():
        ref_units, ref_mel, _ = ref_model(video[:, None], mask, spk)
        out = model(video[..., None], mask, spk)
    valid2, valid4 = mask.repeat_interleave(2, 1), mask.repeat_interleave(4, 1)
    np.testing.assert_allclose(out["unit_logits"][valid2].numpy(), ref_units[valid2].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(out["mel"][valid4].numpy(), ref_mel[valid4].numpy(), atol=1e-4)


def test_tiny_reference_generator_conversion_and_waveform():
    torch.manual_seed(1)
    vcfg = tcfg.preset("tiny").vocoder
    ref_model = RefMelCodeGenerator(vcfg).eval()
    sd = _np(ref_model)
    got = conv.generator_state_dict(sd, vcfg)
    _assert_state_dicts_equal(got, from_jax.vocoder_state_dict(
        jconv.convert_vocoder_generator(sd, jcfg.preset("tiny").vocoder)))
    gen = MelCodeGenerator(vcfg)
    gen.load_state_dict(got, strict=True)
    gen.eval()
    rng = np.random.default_rng(1)
    code = torch.from_numpy(rng.integers(0, 200, (2, 6)))
    mel = torch.from_numpy(rng.standard_normal((2, 12, 80), dtype=np.float32))
    spk = torch.from_numpy(rng.standard_normal((2, 256), dtype=np.float32))
    with torch.no_grad():
        ref = ref_model(code, mel.transpose(1, 2), spk)[:, 0]
        out = gen(code, mel, spk)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4)


class _DP(tnn.Module):
    def __init__(self):
        super().__init__()
        chans = [(1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024)]
        self.convs = tnn.ModuleList([
            weight_norm(tnn.Conv2d(i, o, (5, 1), (3, 1) if j < 4 else 1, padding=(2, 0)))
            for j, (i, o) in enumerate(chans)])
        self.conv_post = weight_norm(tnn.Conv2d(1024, 1, (3, 1), 1, padding=(1, 0)))


class _DS(tnn.Module):
    def __init__(self, use_sn):
        super().__init__()
        f = spectral_norm if use_sn else weight_norm
        self.convs = tnn.ModuleList([
            f(tnn.Conv1d(1, 128, 15, 1, padding=7)),
            f(tnn.Conv1d(128, 128, 41, 2, groups=4, padding=20)),
            f(tnn.Conv1d(128, 256, 41, 2, groups=16, padding=20)),
            f(tnn.Conv1d(256, 512, 41, 4, groups=16, padding=20)),
            f(tnn.Conv1d(512, 1024, 41, 4, groups=16, padding=20)),
            f(tnn.Conv1d(1024, 1024, 41, 1, groups=16, padding=20)),
            f(tnn.Conv1d(1024, 1024, 5, 1, padding=2))])
        self.conv_post = f(tnn.Conv1d(1024, 1, 3, 1, padding=1))


def _reference_discriminators():
    """The reference's do_ modules: mpd.discriminators (5 periods), msd.
    discriminators (spectral norm on the first scale)."""
    torch.manual_seed(2)
    mpd, msd = tnn.Module(), tnn.Module()
    mpd.discriminators = tnn.ModuleList([_DP() for _ in range(5)])
    msd.discriminators = tnn.ModuleList([_DS(True), _DS(False), _DS(False)])
    return mpd, msd


def test_discriminator_conversion_and_the_do_envelope(tmp_path):
    """A do_ file as the reference writes it (state_dicts of mpd and msd
    beside the optimizers, steps, epoch), read, flattened, converted: the
    JAX converter's trees moved by from_jax, loadable strict; the same
    through the convert CLI's vocoder_do kind."""
    mpd, msd = _reference_discriminators()
    torch.save({"mpd": mpd.state_dict(), "msd": msd.state_dict(), "optim_g": {}, "optim_d": {},
                "steps": 40, "epoch": 2}, tmp_path / "do_00000040")
    sd = conv.load_torch_state(tmp_path / "do_00000040")
    assert len(sd) == len(mpd.state_dict()) + len(msd.state_dict())
    got = conv.discriminator_state_dicts(sd)
    jmpd, jmsd, jspec = jconv.convert_vocoder_discriminators(sd)
    _assert_state_dicts_equal(got["mpd"], from_jax.discriminator_state_dict(jmpd))
    _assert_state_dicts_equal(got["msd"], from_jax.discriminator_state_dict(jmsd, jspec))
    MultiPeriodDiscriminator().load_state_dict(got["mpd"], strict=True)
    MultiScaleDiscriminator().load_state_dict(got["msd"], strict=True)
    convert_cli.main(["--kind", "vocoder_do", "--input", str(tmp_path / "do_00000040"),
                      "--output", str(tmp_path / "port_do")])
    written = ckpt.load(tmp_path / "port_do")
    for name in ("mpd", "msd"):
        _assert_state_dicts_equal(written[name], got[name])


def test_weight_loaders_read_port_files_and_reference_envelopes(tmp_path):
    """load_stage1_weights / load_generator_weights read weights-only: a
    port file as it is; a fairseq envelope of tensors and a reference g_
    file converted; a fairseq file whose config is a pickled object is
    refused (it would run code on load) and reads once cli.convert has
    converted it."""
    sd, tc, _ = _reference("resnet3d")
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    want = conv.stage1_state_dict(sd, tc)
    torch.save({"model": tensors}, tmp_path / "envelope.pt")
    _assert_state_dicts_equal(conv.load_stage1_weights(tmp_path / "envelope.pt", tc), want)
    torch.save({"args": argparse.Namespace(arch="multi_target"), "model": tensors},
               tmp_path / "checkpoint_best.pt")
    with pytest.raises(ValueError, match="cli.convert"):
        conv.load_stage1_weights(tmp_path / "checkpoint_best.pt", tc)
    convert_cli.main(["--kind", "stage1", "--preset", "tiny",
                      "--input", str(tmp_path / "checkpoint_best.pt"),
                      "--output", str(tmp_path / "port.pt")])
    _assert_state_dicts_equal(conv.load_stage1_weights(tmp_path / "port.pt", tc), want)

    vcfg = tcfg.preset("tiny").vocoder
    torch.manual_seed(1)
    ref_gen = RefMelCodeGenerator(vcfg)
    torch.save({"generator": ref_gen.state_dict()}, tmp_path / "g_00000001")
    want = conv.generator_state_dict(_np(ref_gen), vcfg)
    _assert_state_dicts_equal(conv.load_generator_weights(tmp_path / "g_00000001", vcfg), want)
    ckpt.save(tmp_path / "g_port", {"generator": want})
    _assert_state_dicts_equal(conv.load_generator_weights(tmp_path / "g_port", vcfg), want)


def test_fold_weight_norm_matches_jax():
    rng = np.random.default_rng(3)
    v, g = rng.standard_normal((4, 3, 5)).astype(np.float32), rng.uniform(0.5, 2, 5)
    from lip2speech_tpu.ops.nn import fold_weight_norm as jfold

    np.testing.assert_array_equal(conv.fold_weight_norm(v, g, dim=2), jfold(v, g, dim=2))


def test_convert_cli_writes_port_checkpoints(tmp_path, capsys):
    sd, tc, _ = _reference("resnet3d")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, tmp_path / "s1.pt")
    convert_cli.main(["--kind", "stage1", "--preset", "tiny", "--input", str(tmp_path / "s1.pt"),
                      "--output", str(tmp_path / "out" / "s1.pt")])
    _assert_state_dicts_equal(ckpt.load(tmp_path / "out" / "s1.pt")["model"],
                              conv.stage1_state_dict(sd, tc))
    vcfg = tcfg.preset("tiny").vocoder
    torch.manual_seed(1)
    ref_gen = RefMelCodeGenerator(vcfg)
    torch.save({"generator": ref_gen.state_dict()}, tmp_path / "g_1")
    convert_cli.main(["--kind", "vocoder_g", "--preset", "tiny", "--input", str(tmp_path / "g_1"),
                      "--output", str(tmp_path / "out" / "g_1")])
    gen = MelCodeGenerator(vcfg)
    gen.load_state_dict(ckpt.load(tmp_path / "out" / "g_1")["generator"], strict=True)
    assert '"kind": "vocoder_g"' in capsys.readouterr().out
    with pytest.raises(SystemExit):         # a kind the CLI does not know
        convert_cli.main(["--kind", "nope", "--input", "x", "--output", "y"])
