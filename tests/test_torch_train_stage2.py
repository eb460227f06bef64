"""The port's stage-2 GAN training (lip2speech_tpu_torch/train/stage2.py) and
its host data (data/stage2.py) against the JAX package on the CPU: two GAN
steps from carried weights with the generator's dropout neutralised on both
sides (logs, first-step gradients by name, parameters of G, MPD and MSD,
the spectral u), the per-epoch rate, validation_mel_l1, the state's
construction, and the dataset's batches on a small dataset on disk."""

import dataclasses
import time

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from lip2speech_tpu.core import config as jcfg
from lip2speech_tpu.data import stage2 as jdata
from lip2speech_tpu.models import vocoder as jvoc
from lip2speech_tpu.train import checkpoint as jckpt
from lip2speech_tpu.train import stage2 as jstage2
from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.core import config as tcfg
from lip2speech_tpu_torch.data import stage2 as tdata
from lip2speech_tpu_torch.train import stage2 as tstage2

from test_torch_asr import run_once
from test_torch_modules import _np_tree

SEG = 1_280


def _cfg(c):
    """The TINY_VOC generator of tests/test_train_steps.py at a 1,280-sample
    segment; the discriminators' widths are fixed."""
    voc = c.VocoderConfig(model_in_dim=80 + 2 * 8, embedding_dim=8, upsample_initial_channel=64,
                          resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
                          segment_size=SEG)
    return dataclasses.replace(c.PipelineConfig(), vocoder=voc,
                               stage2=c.Stage2TrainConfig(batch_size=2))


def _batch(seed, b=2, n=SEG):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16_000
    audio = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400, (b, 1)) * t)
    return {"audio": (audio + 0.05 * rng.standard_normal((b, n))).astype(np.float32),
            "code": rng.integers(0, 200, (b, n // 320)).astype(np.int32),
            "mel": rng.standard_normal((b, n // 160, 80)).astype(np.float32),
            "spk_emb": rng.standard_normal((b, 256)).astype(np.float32)}


def _no_dropout(next_fun, args, kwargs, context):
    """flax interceptor: every nn.Dropout returns its input."""
    if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _jax_state(cfg, batch):
    """jstage2.create_gan_state's state, with the three inits jitted (the
    eager init of the ~70 M discriminator parameters takes several times as
    long); the same keys, parameters and optimizers."""
    gen, mpd, msd = (jvoc.MelCodeGenerator(cfg.vocoder), jvoc.MultiPeriodDiscriminator(),
                     jvoc.MultiScaleDiscriminator())
    g_rng, p_rng, s_rng = jax.random.split(jax.random.PRNGKey(0), 3)
    code, mel, spk, audio = (jnp.asarray(batch[k]) for k in ("code", "mel", "spk_emb", "audio"))
    gv = jax.jit(lambda k: gen.init({"params": k}, code, mel, spk))(g_rng)
    pv = jax.jit(lambda k: mpd.init({"params": k}, audio, audio))(p_rng)
    sv = jax.jit(lambda k: msd.init({"params": k}, audio, audio))(s_rng)
    txs = (jstage2._make_tx(cfg.stage2), jstage2._make_tx(cfg.stage2))
    state = jstage2.GanState(
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32), gen_params=gv["params"],
        mpd_params=pv["params"], msd_params=sv["params"], msd_spectral=sv["spectral"],
        gen_opt=txs[0].init(gv["params"]),
        disc_opt=txs[1].init({"mpd": pv["params"], "msd": sv["params"]}))
    return (gen, mpd, msd), txs, state


def _port_dicts(state) -> dict:
    return {"generator": from_jax.vocoder_state_dict(_np_tree(state.gen_params)),
            "mpd": from_jax.discriminator_state_dict(_np_tree(state.mpd_params)),
            "msd": from_jax.discriminator_state_dict(_np_tree(state.msd_params),
                                                      _np_tree(state.msd_spectral))}


def _first_moments(state) -> dict:
    """The port's Adam first moments by the names of the JAX trees."""
    out = {n: state.gen_opt.state[p]["exp_avg"].clone()
           for n, p in state.generator.named_parameters()}
    for pre, m in (("mpd", state.mpd), ("msd", state.msd)):
        out.update({f"{pre}.{n}": state.disc_opt.state[p]["exp_avg"].clone()
                    for n, p in m.named_parameters()})
    return out


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def _jax_two_steps(batches, shared=None) -> dict:
    """The JAX half of two_steps, all numpy: the starting weights (as port
    state_dicts), both steps' logs with the generator's dropout neutralised
    (flax.linen.intercept_methods on Dropout), the first step's gradients
    (the Adam first moments, (1 - b1) x the gradients, by port name), the
    final weights, the injected rate and validation_mel_l1 after next_epoch.
    The JAX step is compiled once, here. With `shared` (run_once's
    directory) the state between the steps (after next_epoch) is also saved
    there by the JAX package's save_stage2, as g_00000001 / do_00000001."""
    jc = _cfg(jcfg)
    models, txs, jstate = _jax_state(jc, batches[0])
    start = _port_dicts(jstate)
    jstep = jstage2.make_gan_step(models, txs, jc)
    jlogs = []
    for i, batch in enumerate(batches):
        with nn.intercept_methods(_no_dropout):
            jstate, lg = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.PRNGKey(5))
        jlogs.append({k: float(v) for k, v in lg.items()})
        if i == 0:
            grads = {**from_jax.jax_tree_to_state_dict(_np_tree(jstate.gen_opt.inner_state[0].mu)),
                     **from_jax.jax_tree_to_state_dict(_np_tree(jstate.disc_opt.inner_state[0].mu))}
            jstate = jstage2.next_epoch(jstate)
            if shared is not None:
                jckpt.save_stage2(shared, jstate, 1)
    val = jax.jit(lambda p, b: jstage2.validation_mel_l1(models[0], p, b, jc))(
        jstate.gen_params, {k: jnp.asarray(v) for k, v in batches[1].items()})
    return _to_numpy({"start": start, "jlogs": jlogs, "grads": grads,
                      "final": _port_dicts(jstate),
                      "jax_rate": float(jstate.gen_opt.hyperparams["learning_rate"]),
                      "jax_val": float(val)})


@pytest.fixture(scope="module")
def two_steps(tmp_path_factory):
    """Two GAN steps of both implementations from the same weights on two
    batches, the second after next_epoch; the generator's dropout
    neutralised on both sides (flax.linen.intercept_methods on Dropout; the
    port's code_dropout). The JAX half runs once per test run (run_once:
    under pytest-xdist the first worker to get here computes it and leaves
    it in the workers' common temporary directory, behind a file lock; the
    others read it), the port's here."""
    t0 = time.perf_counter()
    tc = _cfg(tcfg)
    batches = [_batch(10), _batch(11)]
    ref = _to_torch(run_once(tmp_path_factory, "stage2_jax_two_steps",
                             lambda shared: _jax_two_steps(batches, shared))[1])
    tstate = tstage2.create_gan_state(tc, device="cpu", state_dicts=ref["start"])
    tstate.generator.code_dropout = 0.0
    tstep = tstage2.make_gan_step(tc)
    tlogs = []
    for i, batch in enumerate(batches):
        tstate, lg = tstep(tstate, batch)
        tlogs.append({k: float(v) for k, v in lg.items()})
        if i == 0:
            # the Adam first moments after one step are (1 - b1) x the gradients
            grads = {"jax": ref["grads"], "port": _first_moments(tstate)}
            tstate = tstage2.next_epoch(tstate)
    print(f"two GAN steps, both implementations: {time.perf_counter() - t0:.1f} s")
    return {"cfg": tc, "batches": batches, "jlogs": ref["jlogs"], "tlogs": tlogs, "grads": grads,
            "start": ref["start"], "final": ref["final"], "tstate": tstate,
            "jax_rate": ref["jax_rate"], "jax_val": ref["jax_val"]}


def test_gan_step_logs_match_jax(two_steps):
    """loss_disc, loss_gen, loss_mel (before x45), loss_fm, loss_adv of both
    steps; 1e-5 relative (f32 sums in another order; read: up to 9e-7)."""
    for ref, got in zip(two_steps["jlogs"], two_steps["tlogs"]):
        assert set(got) == set(ref) == {"loss_disc", "loss_gen", "loss_mel", "loss_fm", "loss_adv"}
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    assert two_steps["tstate"].step == 2 and two_steps["tstate"].epoch == 1


def test_gan_step_first_gradients_match_jax_by_name(two_steps):
    """The first step's gradients of every parameter of G (the G step's) and
    of MPD and MSD (the D step's), by name. Each tensor's largest error over
    the largest gradient element of its side: 1e-5 for the discriminators
    (read: 1.4e-7), 2e-4 for the generator (read: 5.5e-5, in conv_post's
    14-element weight_v, whose weight-norm gradient is a difference of two
    near-equal terms). The generator's upstream gradients are ~1e-8 of its
    largest and carry ~1% f32 rounding in either framework: an f64 run of
    the port puts both 0.3-1.4% away."""
    ref, got = two_steps["grads"]["jax"], two_steps["grads"]["port"]
    assert set(ref) == set(got)
    for side, tol in (("generator", 2e-4), ("disc", 1e-5)):
        names = [n for n in ref if n.startswith(("mpd.", "msd.")) == (side == "disc")]
        scale = max(float(ref[n].abs().max()) for n in names)
        for n in names:
            err = float((got[n] - ref[n]).abs().max())
            assert err <= tol * scale, (n, err / scale)
    assert len(ref) == 119 + 90 + 64


def test_gan_step_parameters_match_jax(two_steps):
    """Parameters of G, MPD and MSD after two AdamW steps (rates 2e-4, then
    2e-4 x 0.999). Adam's first step is lr x sign(g) for any |g| above its
    eps (1e-8), so an element whose gradient is rounding noise steps by the
    full rate in a direction the noise picks, in either framework. Compared
    are the tensors whose first-step gradients agree with JAX's to 1e-3 in
    the 2-norm (above rounding), on their elements whose first-step gradient
    is at least a tenth of the tensor's largest: 2e-5 absolute, a tenth of a
    step (read: up to 3.2e-6). At least a twentieth of all elements is
    compared, every tensor moved."""
    tstate, final, start = two_steps["tstate"], two_steps["final"], two_steps["start"]
    ref_g, got_g = two_steps["grads"]["jax"], two_steps["grads"]["port"]
    compared = total = 0
    for side, module in (("generator", tstate.generator), ("mpd", tstate.mpd),
                         ("msd", tstate.msd)):
        prefix = "" if side == "generator" else f"{side}."
        ref = final[side]
        for n, p in module.named_parameters():
            total += p.numel()
            assert not torch.equal(ref[n], start[side][n]), n
            g_ref, g_got = ref_g[prefix + n], got_g[prefix + n]
            if float((g_got - g_ref).norm()) > 1e-3 * float(g_ref.norm()):
                continue
            inside = g_ref.abs() >= 0.1 * g_ref.abs().max()
            compared += int(inside.sum())
            np.testing.assert_allclose(p.detach()[inside].numpy(), ref[n][inside].numpy(),
                                       atol=2e-5, err_msg=side + "." + n)
    assert compared >= total // 20


def test_gan_step_spectral_u_matches_jax(two_steps):
    """u after two steps: the D steps' iterations kept, the G steps' thrown
    away, as in JAX; 1e-5 (a unit vector; read: 2e-7). One more training
    call moves u by more than ten times that, so keeping the G step's would
    show."""
    tstate = two_steps["tstate"]
    ref = two_steps["final"]["msd"]
    us = dict(tstate.msd.named_buffers())
    assert len(us) == 8
    for k, u in us.items():
        np.testing.assert_allclose(u.numpy(), ref[k].numpy(), atol=1e-5, err_msg=k)
    saved = {k: u.clone() for k, u in us.items()}
    y = torch.from_numpy(two_steps["batches"][1]["audio"])
    with torch.no_grad():
        tstate.msd(y, y)
        moved = max(float((u - saved[k]).abs().max()) for k, u in us.items())
        for k, u in us.items():
            u.copy_(saved[k])
    assert moved > 1e-4


def test_next_epoch_rate_and_optimizers(two_steps):
    """The second step ran at lr x 0.999 in both optimizers, as the JAX
    state's injected rate; one AdamW covers MPD and MSD together, with
    optax.adamw's betas, eps and weight decay."""
    tstate = two_steps["tstate"]
    s2 = two_steps["cfg"].stage2
    for opt in (tstate.gen_opt, tstate.disc_opt):
        (group,) = opt.param_groups
        assert group["lr"] == pytest.approx(s2.lr * s2.lr_decay, rel=1e-12)
        assert group["lr"] == pytest.approx(two_steps["jax_rate"], rel=1e-6)
        assert group["betas"] == (0.8, 0.99) and group["eps"] == 1e-8
        assert group["weight_decay"] == 0.01
    n_disc = sum(1 for m in (tstate.mpd, tstate.msd) for _ in m.parameters())
    assert len(tstate.disc_opt.param_groups[0]["params"]) == n_disc == 90 + 64


def test_validation_mel_l1_matches_jax_and_restores_the_mode(two_steps):
    tstate = two_steps["tstate"]
    got = tstage2.validation_mel_l1(tstate.generator, two_steps["batches"][1], two_steps["cfg"])
    np.testing.assert_allclose(float(got), two_steps["jax_val"], rtol=1e-5)
    assert tstate.generator.training


def test_stage2_train_config_matches_jax_defaults():
    """The fields the port reads carry the JAX defaults; of the JAX stage-2
    config only lambda_fm (read by neither trainer) and mel_aug (the
    dataset's argument) are left out."""
    js, ts = dataclasses.asdict(jcfg.Stage2TrainConfig()), dataclasses.asdict(
        tcfg.Stage2TrainConfig())
    assert ts == {k: js[k] for k in ts} and set(js) - set(ts) == {"lambda_fm", "mel_aug"}
    ja, ta = dataclasses.asdict(jcfg.AudioConfig()), dataclasses.asdict(tcfg.AudioConfig())
    assert ta == {k: ja[k] for k in ta} and "loss_n_fft" in ta
    jv, tv = jcfg.VocoderConfig(), tcfg.VocoderConfig()
    for f in ("segment_size", "code_hop_size", "mel_hop_size"):
        assert getattr(tv, f) == getattr(jv, f), f
    assert not hasattr(tv, "fused_tail_kernel")


def test_gan_state_is_seeded_and_its_noise_is_the_state_rng(monkeypatch):
    """The same seed gives the same weights, u (an unnormalised normal draw,
    as JAX starts it) and step; the dropout comes from the state's rng (a
    dropped unit feature passes no gradient, so the unit upsampler's
    gradient, kept in Adam's first moment, shows the mask)."""
    cfg = _cfg(tcfg)
    step = tstage2.make_gan_step(cfg)
    batch = _batch(3)
    after = []
    for seed, rng_seed in ((1, None), (1, None), (1, 9)):
        state = tstage2.create_gan_state(cfg, seed=seed, device="cpu")
        if rng_seed is not None:
            state.rng.manual_seed(rng_seed)
        assert float(state.msd.disc_s0.convs_0.u.norm()) > 2.0
        step(state, batch)
        after.append({k: v.clone() for k, v in state.generator.state_dict().items()})
        after[-1]["grad"] = state.gen_opt.state[state.generator.code_upsample.weight_v]["exp_avg"]
    assert all(torch.equal(v, after[1][k]) for k, v in after[0].items())
    assert not torch.equal(after[0]["grad"], after[2]["grad"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstage2.create_gan_state(cfg)


# --------------------------------------------------------------------- data

def _write_dataset(root, n_utts=5, seed=0):
    from lip2speech_tpu_torch.utils.audio_io import write_wav

    rng = np.random.default_rng(seed)
    rows, units = [str(root)], []
    for i in range(n_utts):
        frames = int(rng.integers(6, 30))
        n_samples = frames * 640 + int(rng.integers(-200, 200))
        uid = f"spk{i % 2}/clip{i}"
        write_wav(root / "audio" / f"{uid}.wav",
                  0.4 * rng.standard_normal(n_samples).clip(-2, 2) / 2, 16_000)
        for sub, arr in (("mel", rng.standard_normal((frames * 4 + 1, 80))),
                         ("spk_emb", rng.standard_normal(256))):
            (root / sub / f"spk{i % 2}").mkdir(parents=True, exist_ok=True)
            np.save(root / sub / f"{uid}.npy", arr.astype(np.float32))
        rows.append(f"{uid}\tvideo/{uid}.mp4\taudio/{uid}.wav\t{frames}\t{n_samples}")
        units.append(" ".join(str(u) for u in rng.integers(0, 200, 2 * frames + int(rng.integers(-2, 3)))))
    (root / "train.tsv").write_text("\n".join(rows) + "\n")
    (root / "train.unt").write_text("\n".join(units) + "\n")
    return root / "train.tsv", root / "train.unt"


@pytest.mark.parametrize("train,mel_aug", [(True, False), (True, True), (False, False)])
def test_stage2_dataset_batches_match_jax(tmp_path, train, mel_aug):
    """The same batches, exactly, for the same seed: peak normalisation,
    the hop-aligned trim, tiling of short clips, the random aligned segment
    and the mel corruption draw the same numbers in the same order."""
    tsv, unt = _write_dataset(tmp_path)
    kw = dict(train=train, mel_aug=mel_aug, seed=3)
    ref = jdata.Stage2Dataset(tsv, unt, jcfg.VocoderConfig(segment_size=3_200), **kw)
    got = tdata.Stage2Dataset(tsv, unt, tcfg.VocoderConfig(segment_size=3_200), **kw)
    assert got.utts[0].mel_path == ref.utts[0].mel_path
    assert got.utts[0].spk_emb_path == ref.utts[0].spk_emb_path
    n = 0
    for _ in range(2):
        for rb, gb in zip(ref.batches(2), got.batches(2), strict=True):
            assert gb["ids"] == rb["ids"]
            for k in ("audio", "code", "mel", "spk_emb"):
                assert gb[k].dtype == rb[k].dtype
                np.testing.assert_array_equal(gb[k], rb[k], err_msg=k)
            if train:
                assert gb["audio"].shape == (2, 3_200) and gb["mel"].shape == (2, 20, 80)
            n += 1
    assert n == 4
