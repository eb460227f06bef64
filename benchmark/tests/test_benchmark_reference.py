"""The plain reference against the port's plain path (the CPU runs every
kernel's plain version) on the tiny widths, with the same weights."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import stage1, train, vocoder
from benchmark.tests import tiny


@pytest.mark.parametrize("config", ["multi_target", "multi_target_avhubert"])
def test_stage1_and_vocoder(config):
    from lip2speech_tpu_torch.models.multi_target import MultiTargetModel
    from lip2speech_tpu_torch.models.vocoder import MelCodeGenerator

    cell, overrides = tiny.cell("multi_target_avhubert.serve.long.f32", config)
    arch = cell.config["arch"]
    cfg = harness.port_config(cell.config, overrides)
    s1, voc = harness.make_weights(cfg, 11, "cpu")
    model, gen = MultiTargetModel(cfg.model), MelCodeGenerator(cfg.vocoder)
    model.load_state_dict(s1)
    gen.load_state_dict(voc)
    model.eval()
    gen.eval()
    g = torch.Generator().manual_seed(3)
    video = torch.randn(2, 24, 88, 88, 1, generator=g)
    mask = torch.arange(24)[None] < torch.tensor([24, 17])[:, None]
    spk = torch.randn(2, 256, generator=g)
    with torch.no_grad():
        want = model(video, mask, spk)
        got = stage1.forward(s1, arch, video, mask, spk)
        for k in ("unit_logits", "mel"):
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)
        code = torch.randint(0, 200, (2, 48), generator=g)
        torch.testing.assert_close(vocoder.generate(voc, arch["vocoder"], code, got["mel"], spk),
                                   gen(code, got["mel"], spk), rtol=1e-5, atol=1e-6)


def test_training_steps():
    """Two updates with dropout from the same seed: the same losses, first
    gradients and changes."""
    from lip2speech_tpu_torch.train import stage1 as port

    from benchmark.drivers import train_step

    cell, overrides = tiny.cell("multi_target.train.f32")
    conf, tr = cell.config, cell.traffic
    cfg = harness.port_config(conf, {"stage1.update_freq": conf["update_freq"],
                                     "stage1.batch_size": tr["batch_size"], **overrides})
    sd, _ = harness.make_weights(cfg, 5, "cpu", vocoder=False)
    batches, _ = train_step.make_batches(cfg, tr, 99, torch.device("cpu"))
    seed = 2 ** 32 + 3
    state = port.create_train_state(cfg, seed=seed, device="cpu", state_dict=sd)
    step = port.make_train_step(cfg)
    p0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    losses = []
    for i in range(2):
        state, logs = step(state, batches[i])
        losses.append(float(logs["loss"]))
    ref = train.run_steps(sd, {**conf["arch"], "pad": 1}, conf["optimizer"], batches[:2], seed,
                          torch.device("cpu"))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    # leaves whose gradient is nought to rounding (a key's bias under the
    # softmax) move by round-off alone, in either version
    median = float(np.median(list(ref["grad_norms"].values())))
    for n, p in state.model.named_parameters():
        if ref["grad_norms"][n] < 1e-3 * median:
            continue
        assert abs(float((p.detach() - p0[n]).norm()) - ref["delta_norms"][n]) <= \
            1e-2 * max(ref["delta_norms"][n], 1e-9), n
