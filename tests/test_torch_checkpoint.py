"""The port's checkpoints (lip2speech_tpu_torch/train/checkpoint.py) and the
orbax converter (scripts/orbax_to_torch.py) on the CPU: round trips of both
stages, the scan and resume rules, resumed training equal to uninterrupted
training bit for bit (dropout on, so the noise generators' states count),
and JAX checkpoints converted and restored into the port giving the JAX
package's outputs."""

import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lip2speech_tpu.core import config as jcfg
from lip2speech_tpu.models import vocoder as jvoc
from lip2speech_tpu.train import checkpoint as jckpt
from lip2speech_tpu.train import stage1 as jstage1
from lip2speech_tpu_torch.core import config as tcfg
from lip2speech_tpu_torch.models.vocoder import MelCodeGenerator
from lip2speech_tpu_torch.train import checkpoint as ckpt
from lip2speech_tpu_torch.train import stage1, stage2

from test_torch_train_stage1 import _batch as s1_batch
from test_torch_train_stage1 import _cfg as s1_cfg
from test_torch_train_stage2 import _batch as gan_batch
from test_torch_train_stage2 import _cfg as gan_cfg
from torch_tmp import tmp_path  # noqa: F401  (removed when the test passes)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _s1_cfg():
    """Stage 1 at dim 32, 2 layers, 24x24 video, dropout 0.1."""
    return s1_cfg(tcfg, dropout=0.1, warmup_updates=1)


def _assert_tree_equal(got, ref, where=""):
    if isinstance(ref, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == ref.dtype, where
        assert torch.equal(got.cpu(), ref.cpu()), where
    elif isinstance(ref, dict):
        assert got.keys() == ref.keys(), where
        for k in ref:
            _assert_tree_equal(got[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_tree_equal(g, r, f"{where}[{i}]")
    else:
        assert got == ref, where


def _stage1_snapshot(state) -> dict:
    return ckpt._cpu(ckpt.stage1_content(state))


def _gan_snapshot(state) -> dict:
    return ckpt._cpu({"generator": state.generator.state_dict(), "mpd": state.mpd.state_dict(),
                      "msd": state.msd.state_dict(), "gen_opt": state.gen_opt.state_dict(),
                      "disc_opt": state.disc_opt.state_dict(), "step": state.step,
                      "epoch": state.epoch, "rng": state.rng.get_state()})


def test_scan_takes_the_newest_and_resume_skips_the_best(tmp_path):
    assert ckpt.scan_checkpoints(tmp_path / "absent", "s1_") is None
    for name in ("s1_00000000.pt", "s1_00000010.pt", "s1_00000009.pt", "s1_00000100.pt.tmp",
                 "g_00000200", "do_00000200", "g_00000030", "best.json"):
        (tmp_path / name).touch()
    assert ckpt.scan_checkpoints(tmp_path, "s1_").name == "s1_00000010.pt"
    assert ckpt.scan_checkpoints(tmp_path, "g_").name == "g_00000200"

    state = stage1.create_train_state(_s1_cfg(), seed=0, device="cpu")
    only_best = tmp_path / "only_best"
    ckpt.save_stage1(only_best, state, 0)
    restored, update = ckpt.restore_stage1(only_best, state)
    assert update == 0 and restored is state
    assert ckpt.restore_stage2(tmp_path / "absent", None) == (None, 0)


def test_stage1_round_trip_restores_every_tensor_and_generator(tmp_path):
    cfg = _s1_cfg()
    state = stage1.create_train_state(cfg, seed=0, device="cpu")
    state, _ = stage1.make_train_step(cfg)(state, s1_batch(0))
    saved = _stage1_snapshot(state)
    path = ckpt.save_stage1(tmp_path, state, 7)
    assert path.name == "s1_00000007.pt"
    raw = torch.load(path, weights_only=True)
    assert raw["format"] == ckpt.FORMAT and raw["step"] == 1
    fresh = stage1.create_train_state(cfg, seed=99, device="cpu")
    fresh, update = ckpt.restore_stage1(tmp_path, fresh)
    assert update == 7 and fresh.step == 1
    _assert_tree_equal(_stage1_snapshot(fresh), saved)
    assert fresh.optimizer.state[next(iter(fresh.model.parameters()))]["exp_avg"].abs().sum() > 0


def test_stage1_resumed_training_equals_uninterrupted_bitwise(tmp_path):
    """Three updates straight against two, a save, a restore into a fresh
    state (other seed) and one more: logs, weights, statistics, optimizer
    and generators equal bit for bit, with dropout 0.1 on."""
    cfg = _s1_cfg()
    batches = [s1_batch(seed) for seed in (0, 1, 2)]
    step = stage1.make_train_step(cfg)
    straight = stage1.create_train_state(cfg, seed=0, device="cpu")
    logs_straight = [step(straight, b)[1] for b in batches]

    first = stage1.create_train_state(cfg, seed=0, device="cpu")
    for b in batches[:2]:
        step(first, b)
    ckpt.save_stage1(tmp_path, first, 2)
    resumed, update = ckpt.restore_stage1(tmp_path, stage1.create_train_state(cfg, seed=5,
                                                                              device="cpu"))
    assert update == 2
    _, last = step(resumed, batches[2])
    _assert_tree_equal(ckpt._cpu(last), ckpt._cpu(logs_straight[2]))
    _assert_tree_equal(_stage1_snapshot(resumed), _stage1_snapshot(straight))
    # the noise mattered: a fresh generator state gives another update
    other = stage1.create_train_state(cfg, seed=5, device="cpu")
    ckpt.load_stage1(tmp_path / "s1_00000002.pt", other)
    other.gen.manual_seed(123)
    assert not torch.equal(step(other, batches[2])[1]["loss"], last["loss"])


def test_gan_resumed_training_equals_uninterrupted_bitwise(tmp_path):
    """Two GAN steps with next_epoch between, straight against one step,
    next_epoch, a save (g_ / do_), a restore into a fresh state (other seed)
    and one more: equal bit for bit, with the generator's dropout on and the
    second step's rate set by the restored epoch."""
    cfg = gan_cfg(tcfg)
    batches = [gan_batch(10, b=1), gan_batch(11, b=1)]
    step = stage2.make_gan_step(cfg)
    straight = stage2.create_gan_state(cfg, seed=0, device="cpu")
    step(straight, batches[0])
    stage2.next_epoch(straight)
    _, logs = step(straight, batches[1])

    first = stage2.create_gan_state(cfg, seed=0, device="cpu")
    step(first, batches[0])
    stage2.next_epoch(first)
    g_path, do_path = ckpt.save_stage2(tmp_path, first, 1)
    assert (g_path.name, do_path.name) == ("g_00000001", "do_00000001")
    assert set(torch.load(g_path, weights_only=True)) == {"format", "generator"}
    resumed, steps = ckpt.restore_stage2(tmp_path, stage2.create_gan_state(cfg, seed=3,
                                                                          device="cpu"))
    assert (steps, resumed.step, resumed.epoch) == (1, 1, 1)
    _assert_tree_equal(_gan_snapshot(resumed), _gan_snapshot(first))
    _, got = step(resumed, batches[1])
    _assert_tree_equal(ckpt._cpu(got), ckpt._cpu(logs))
    _assert_tree_equal(_gan_snapshot(resumed), _gan_snapshot(straight))


@pytest.mark.parametrize("gens", ["absent", "of the other device type"])
def test_generator_states_restore_only_into_their_own_kind(tmp_path, gens):
    """A file without generator states (a converted JAX run), or with states
    of a CUDA generator (a run on the card), restored into CPU states: the
    tensors, optimizer and step come back, the freshly seeded generators are
    kept. A CUDA generator's state is its seed and offset, 16 bytes."""
    cfg = _s1_cfg()
    state = stage1.create_train_state(cfg, seed=0, device="cpu")
    state, _ = stage1.make_train_step(cfg)(state, s1_batch(0))
    content = ckpt.stage1_content(state)
    gan = stage2.create_gan_state(gan_cfg(tcfg), seed=0, device="cpu")
    ckpt.save_stage2(tmp_path / "s2", gan, 1)
    do = ckpt.load(tmp_path / "s2" / "do_00000001")
    if gens == "absent":
        del content["gen"], content["seed_gen"], do["rng"]
    else:
        cuda = {"device": "cuda", "state": torch.zeros(16, dtype=torch.uint8)}
        content.update(gen=cuda, seed_gen=cuda)
        do["rng"] = cuda
    ckpt.save(tmp_path / "s1" / "s1_00000001.pt", content)
    ckpt.save(tmp_path / "s2" / "do_00000001", do)

    fresh = stage1.create_train_state(cfg, seed=5, device="cpu")
    want = {k: getattr(fresh, k).get_state() for k in ("gen", "seed_gen")}
    fresh, update = ckpt.restore_stage1(tmp_path / "s1", fresh)
    assert update == 1
    saved = _stage1_snapshot(state)
    del saved["gen"], saved["seed_gen"]
    got = _stage1_snapshot(fresh)
    for k in ("gen", "seed_gen"):
        assert torch.equal(got.pop(k)["state"], want[k]), k
    _assert_tree_equal(got, saved)

    fresh_gan = stage2.create_gan_state(gan_cfg(tcfg), seed=3, device="cpu")
    want_rng = fresh_gan.rng.get_state()
    fresh_gan, steps = ckpt.restore_stage2(tmp_path / "s2", fresh_gan)
    assert steps == 1 and torch.equal(fresh_gan.rng.get_state(), want_rng)
    _assert_tree_equal(_gan_snapshot(fresh_gan)["mpd"], _gan_snapshot(gan)["mpd"])


def test_loading_a_foreign_file_as_a_port_checkpoint_raises(tmp_path):
    torch.save({"generator": {}}, tmp_path / "g_00000001")
    with pytest.raises(ValueError, match="not a checkpoint"):
        ckpt.load(tmp_path / "g_00000001")


# ------------------------------------------------------- orbax -> the port

@pytest.fixture(scope="module")
def orbax_to_torch():
    spec = importlib.util.spec_from_file_location("orbax_to_torch",
                                                  REPO / "scripts" / "orbax_to_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_orbax_stage1_converted_and_restored_gives_jax_outputs(tmp_path, orbax_to_torch):
    """A JAX train state after one update (so AdamW's moments are not zero;
    the step and batch of test_recipe_eps_update_matches_jax_where_conditioned),
    saved by the JAX package's save_stage1, converted and resumed by the
    port: eval outputs within 1e-4; the moments and the step carried."""
    jc, tc = s1_cfg(jcfg, warmup_updates=1), s1_cfg(tcfg, warmup_updates=1)
    batch = s1_batch(6, dummy=False)
    micro0 = {k: v[0] for k, v in batch.items()}
    model, tx, jstate = jstage1.create_train_state(jc, jax.random.PRNGKey(0), micro0)
    jstate, _ = jstage1.make_train_step(model, tx, jc, mesh=None)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(10))
    jckpt.save_stage1(tmp_path / "jax", jstate, 1)
    tree = jckpt.load_pytree(tmp_path / "jax" / "s1_00000001")
    ckpt.save(tmp_path / "port" / "s1_00000001.pt", orbax_to_torch.convert_stage1(tree, tc))
    state = stage1.create_train_state(tc, seed=9, device="cpu")
    seeded = state.gen.get_state()
    state, update = ckpt.restore_stage1(tmp_path / "port", state)
    assert update == 1 and state.step == 1
    assert torch.equal(state.gen.get_state(), seeded)      # the file holds no generators
    ref = model.apply({"params": jstate.params, "batch_stats": jstate.batch_stats},
                      jnp.asarray(micro0["video"]), jnp.asarray(micro0["frames_mask"]),
                      jnp.asarray(micro0["spk_emb"]), train=False)
    state.model.eval()
    with torch.no_grad():
        got = state.model(*(torch.as_tensor(micro0[k]) for k in ("video", "frames_mask",
                                                                 "spk_emb")))
    for k in ("unit_logits", "mel"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, err_msg=k)
    mu = jstate.opt_state.inner_states["train"].inner_state[1][0].mu
    name = "unit_head.last.weight"
    p = dict(state.model.named_parameters())[name]
    np.testing.assert_array_equal(state.optimizer.state[p]["exp_avg"].numpy(),
                                  np.asarray(mu["unit_head"]["last"]["weight"]).T)
    assert float(state.optimizer.state[p]["step"]) == 1.0


def test_orbax_generator_converted_gives_jax_waveform(tmp_path, orbax_to_torch):
    """The JAX package's save_stage2 (its discriminator and optimizer parts
    stand-ins: the converter reads only the g_ directory), converted: the
    port's generator gives the JAX waveform within 1e-4."""
    jc, tc = gan_cfg(jcfg), gan_cfg(tcfg)
    batch = gan_batch(3)
    gen = jvoc.MelCodeGenerator(jc.vocoder)
    code, mel, spk = (jnp.asarray(batch[k]) for k in ("code", "mel", "spk_emb"))
    params = jax.jit(lambda k: gen.init({"params": k}, code, mel, spk))(
        jax.random.PRNGKey(0))["params"]
    stand_in = {"x": np.zeros(1, np.float32)}
    jstate = types.SimpleNamespace(gen_params=params, mpd_params=stand_in, msd_params=stand_in,
                                   msd_spectral=stand_in, gen_opt=stand_in, disc_opt=stand_in,
                                   step=np.int32(4), epoch=np.int32(1))
    g_dir, _ = jckpt.save_stage2(tmp_path / "jax", jstate, 4)
    orbax_to_torch.main(["--input", str(g_dir), "--output", str(tmp_path / "port" / "g_00000004")])
    port = MelCodeGenerator(tc.vocoder)
    port.load_state_dict(ckpt.load(tmp_path / "port" / "g_00000004")["generator"], strict=True)
    port.eval()
    ref = gen.apply({"params": params}, code, mel, spk, deterministic=True)
    with torch.no_grad():
        got = port(torch.as_tensor(batch["code"]).long(), torch.as_tensor(batch["mel"]),
                   torch.as_tensor(batch["spk_emb"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_orbax_do_converted_resumes_the_jax_gan_run(tmp_path, tmp_path_factory, orbax_to_torch):
    """The JAX GAN state after one step and next_epoch (the cached half of
    test_torch_train_stage2.py, which saves it with the JAX package's
    save_stage2), its g_ and do_ converted (the `do_` kind) and restored by
    the port's restore_stage2: generator, MPD, MSD (its u vectors too), both
    AdamW states (exp_avg / exp_avg_sq of every parameter, step = optax's
    count) within 1e-6 of the JAX trees, step and epoch equal. Then one port
    GAN step from it against the JAX package's second make_gan_step from the
    same state, as test_torch_train_stage2.py holds its steps: logs 1e-5
    relative; parameters 2e-5 absolute on the elements whose first-step
    gradient is at least a tenth of the tensor's largest; u 1e-5."""
    import shutil

    from lip2speech_tpu_torch.convert import from_jax

    from test_torch_asr import run_once
    from test_torch_modules import _np_tree
    from test_torch_train_stage2 import _jax_two_steps, _to_torch

    tc = gan_cfg(tcfg)
    batches = [gan_batch(10), gan_batch(11)]
    shared, ref = run_once(tmp_path_factory, "stage2_jax_two_steps",
                           lambda shared: _jax_two_steps(batches, shared))
    ref = _to_torch(ref)
    port_dir = tmp_path / "port"
    orbax_to_torch.main(["--input", str(shared / "g_00000001"),
                         "--output", str(port_dir / "g_00000001")])
    tree = jckpt.load_pytree(shared / "do_00000001")
    gen_tree = jckpt.load_pytree(shared / "g_00000001")["generator"]
    ckpt.save(port_dir / "do_00000001", orbax_to_torch.convert_stage2_do(tree, tc))
    for name in ("g_00000001", "do_00000001"):      # read once, by this test
        shutil.rmtree(shared / name)

    state, steps = ckpt.restore_stage2(port_dir, stage2.create_gan_state(tc, seed=3, device="cpu"))
    assert steps == 1 and (state.step, state.epoch) == (1, 1)
    want = {"generator": from_jax.vocoder_state_dict(_np_tree(gen_tree)),
            "mpd": from_jax.discriminator_state_dict(_np_tree(tree["mpd"])),
            "msd": from_jax.discriminator_state_dict(_np_tree(tree["msd"]),
                                                      _np_tree(tree["msd_spectral"]))}
    for side, sd in want.items():
        got = getattr(state, side).state_dict()
        assert got.keys() == sd.keys(), side
        for k, v in sd.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6, err_msg=side + k)
    for opt, named, jopt in (
            (state.gen_opt, list(state.generator.named_parameters()), tree["gen_opt"]),
            (state.disc_opt, [(f"{pre}.{n}", p) for pre, m in (("mpd", state.mpd),
                                                                ("msd", state.msd))
                              for n, p in m.named_parameters()], tree["disc_opt"])):
        adam = orbax_to_torch._adam_state(jopt)
        assert int(np.asarray(adam["count"])) == 1
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            jm = from_jax.jax_tree_to_state_dict(_np_tree(adam[moment]))
            assert {n for n, _ in named} == set(jm)
            for n, p in named:
                np.testing.assert_allclose(opt.state[p][key].numpy(), jm[n].numpy(),
                                           atol=1e-6, err_msg=n)
                assert float(opt.state[p]["step"]) == 1.0
    state.generator.code_dropout = 0.0
    state, logs = stage2.make_gan_step(tc)(state, batches[1])
    for k, v in ref["jlogs"][1].items():
        np.testing.assert_allclose(float(logs[k]), v, rtol=1e-5, err_msg=k)
    grads = ref["grads"]
    compared = 0
    for side in ("generator", "mpd", "msd"):
        prefix = "" if side == "generator" else f"{side}."
        for n, p in getattr(state, side).named_parameters():
            g = grads[prefix + n]
            inside = g.abs() >= 0.1 * g.abs().max()
            compared += int(inside.sum())
            np.testing.assert_allclose(p.detach()[inside].numpy(),
                                       ref["final"][side][n][inside].numpy(), atol=2e-5,
                                       err_msg=side + "." + n)
    assert compared > 0
    for k, u in state.msd.named_buffers():
        np.testing.assert_allclose(u.numpy(), ref["final"]["msd"][k].numpy(), atol=1e-5, err_msg=k)
