"""The port's stage-1 training (lip2speech_tpu_torch/train/stage1.py and the
training mode of its modules) against the JAX package at tiny width on the
CPU: the learning-rate schedule against optax, batch_norm_train, three
train steps at dropout 0 and accumulation 2 from carried weights (logs,
running statistics, parameters; a frozen frontend stays as it was), the host
batch helpers, and the training noise (deterministic per generator seed,
absent in eval mode)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lip2speech_tpu.core import config as jcfg
from lip2speech_tpu.ops import nn as jops
from lip2speech_tpu.train import stage1 as jstage1
from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.core import config as tcfg
from lip2speech_tpu_torch.ops import nn as tops
from lip2speech_tpu_torch.train import stage1 as tstage1

from test_torch_asr import run_once
from test_torch_modules import _np_tree

PAD = 1


def _cfg(c, kind="resnet3d", dropout=0.0, **stage1):
    """dim 32, 2 layers, conv kernel 7; the avhubert frontend 2 layers of
    dim 64, frozen."""
    if kind == "resnet3d":
        frontend, input_dim = c.FrontendConfig(), 512
    else:
        frontend, input_dim = c.FrontendConfig(kind=kind, frozen=True, encoder_dim=64,
                                               encoder_heads=4, encoder_ffn_dim=128,
                                               encoder_layers=2), 64
    conformer = c.ConformerConfig(dim=32, ffn_dim=64, heads=2, layers=2, conv_kernel=7,
                                  input_dim=input_dim, dropout=dropout,
                                  attention_dropout=dropout)
    s1 = dict(update_freq=2, batch_size=3, warmup_updates=2, max_updates=10)
    s1.update(stage1)
    return c.PipelineConfig(
        model=c.MultiTargetConfig(frontend=frontend, conformer=conformer, final_dropout=dropout),
        stage1=c.Stage1TrainConfig(**s1))


def _batch(seed, accum=2, b=3, t=6, size=24, dummy=True):
    """Ragged micro-batches in the (accum, B, ...) layout; with `dummy` the
    last row of the second micro-batch is an all-masked dummy."""
    rng = np.random.default_rng(seed)
    lens = np.array([[t, t - 2, t - 1], [t - 1, t, 0 if dummy else t - 3]])[:accum, :b]
    tu = 2 * t + 1
    tok = rng.integers(4, 204, (accum, b, tu))
    pos = np.arange(tu)[None, None, :]
    tok = np.where(pos < 2 * lens[..., None], tok, PAD)
    tok = np.where((pos == 2 * lens[..., None]) & (lens[..., None] > 0), 2, tok)
    return {"video": rng.standard_normal((accum, b, t, size, size, 1)).astype(np.float32),
            "frames_mask": np.arange(t)[None, None, :] < lens[..., None],
            "spk_emb": rng.standard_normal((accum, b, 256)).astype(np.float32),
            "unit_tokens": tok.astype(np.int32),
            "mel": rng.standard_normal((accum, b, 4 * t, 80)).astype(np.float32)}


# ------------------------------------------------------------------ schedule

@pytest.mark.parametrize("warmup,max_updates", [(10_000, 150_000), (2, 10), (5, 4), (1, 1)])
def test_lr_schedule_matches_optax(warmup, max_updates):
    jc = jcfg.Stage1TrainConfig(warmup_updates=warmup, max_updates=max_updates)
    tc = tcfg.Stage1TrainConfig(warmup_updates=warmup, max_updates=max_updates)
    ref, got = jstage1.lr_schedule(jc), tstage1.lr_schedule(tc)
    w = min(warmup, max(max_updates - 1, 1))
    counts = sorted({0, 1, w - 1, w, w + 1, (w + max_updates) // 2, max_updates - 1,
                     max_updates, max_updates + 7} - {-1})
    for n in counts:
        # optax evaluates the cosine in f32, the port in Python floats
        np.testing.assert_allclose(got(n), float(ref(n)), rtol=1e-5, atol=1e-10,
                                   err_msg=f"update {n}")
    assert got(0) == 0.0
    assert got(w) == pytest.approx(tc.lr)


def test_stage1_train_config_matches_jax_defaults():
    assert dataclasses.asdict(tcfg.Stage1TrainConfig()) == dataclasses.asdict(
        jcfg.Stage1TrainConfig())
    j, t = jcfg.preset("multi_target"), tcfg.preset("multi_target")
    for field in ("dropout", "attention_dropout", "drop_path"):
        assert getattr(t.model.conformer, field) == getattr(j.model.conformer, field)
    assert t.model.final_dropout == j.model.final_dropout
    assert t.model.units.pad == j.model.units.pad == PAD


# --------------------------------------------------------------- batch norm

@pytest.mark.parametrize("shape", [(4, 5, 7), (3, 6, 4, 4)])
def test_batch_norm_train_matches_jax(shape):
    """JAX is channel-last, the port channel-first; 1e-5: f32 means of a few
    hundred values in another order."""
    rng = np.random.default_rng(0)
    c = shape[1]
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    mean, var = rng.normal(0, 0.1, c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    gamma, beta = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.normal(0, 0.1, c).astype(np.float32)
    x_last = np.moveaxis(x, 1, -1)
    ref = jops.batch_norm_train(*map(jnp.asarray, (x_last, mean, var, gamma, beta)))
    got = tops.batch_norm_train(*map(torch.from_numpy, (x, mean, var, gamma, beta)))
    np.testing.assert_allclose(got[0].numpy(), np.moveaxis(np.asarray(ref[0]), -1, 1), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-5)


def test_batch_norm_train_bf16_keeps_f32_statistics():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((8, 4, 16)).astype(np.float32))
    ones, zeros = torch.ones(4), torch.zeros(4)
    y, mean, var = tops.batch_norm_train(x.bfloat16(), zeros, ones, ones.bfloat16(), zeros.bfloat16())
    assert y.dtype == torch.bfloat16 and mean.dtype == var.dtype == torch.float32
    _, mean32, var32 = tops.batch_norm_train(x.bfloat16().float(), zeros, ones, ones, zeros)
    assert torch.equal(mean, mean32) and torch.equal(var, var32)


def test_batch_norm_module_follows_training_flag():
    from lip2speech_tpu_torch.models.layers import BatchNorm, init_weights

    bn = BatchNorm(4)
    init_weights(bn, torch.Generator().manual_seed(0))
    x = torch.randn(6, 4, 5, generator=torch.Generator().manual_seed(1)) + 3.0
    bn.eval()
    y_eval = bn(x)
    assert torch.equal(bn.running_mean, torch.zeros(4))
    bn.train()
    y_train = bn(x)
    assert not torch.allclose(y_eval, y_train)
    assert float(bn.running_mean.mean()) == pytest.approx(0.3, abs=0.1)   # momentum 0.1
    assert abs(float(y_train.mean())) < 1e-5


def test_dequantize_video_matches_jax():
    u8 = np.random.default_rng(0).integers(0, 256, (2, 3, 4, 4, 1), dtype=np.uint8)
    np.testing.assert_allclose(tops.dequantize_video(torch.from_numpy(u8)).numpy(),
                               np.asarray(jops.dequantize_video(jnp.asarray(u8))), atol=1e-6)
    f = torch.zeros(2, 3)
    assert tops.dequantize_video(f) is f


# --------------------------------------------------------------- train step

def _jax_three_steps(kind):
    """The JAX half of three_steps: the starting variables, the logs of three
    steps and the final variables, as numpy."""
    jc = _cfg(jcfg, kind, adam_eps=1e-3)
    batches = [_batch(seed) for seed in (0, 1, 2)]
    micro0 = {k: v[0] for k, v in batches[0].items()}
    model, tx, jstate = jstage1.create_train_state(jc, jax.random.PRNGKey(0), micro0)
    start = {"params": _np_tree(jstate.params), "batch_stats": _np_tree(jstate.batch_stats)}
    jstep = jstage1.make_train_step(model, tx, jc, mesh=None)
    jlogs = []
    for i, batch in enumerate(batches):
        jstate, lg = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(10 + i))
        jlogs.append({k: float(v) for k, v in lg.items()})
    return {"jlogs": jlogs, "start": start,
            "final": {"params": _np_tree(jstate.params),
                      "batch_stats": _np_tree(jstate.batch_stats)}}


@pytest.fixture(scope="module")
def three_steps(tmp_path_factory):
    """kind -> three optimizer steps of both implementations from the same
    weights on the same three batches: per-step logs, the starting and the
    JAX package's final variables by the port's names, and the port's state.
    The JAX half runs once per test run (run_once: under pytest-xdist the
    first worker to need it leaves it in the workers' common temporary
    directory, behind a file lock), the port's once per worker.

    Adam's eps is 1e-3 here, not the recipe's 1e-8: a gradient that is zero
    in exact arithmetic (a bias in front of a BatchNorm, the key bias under
    the softmax) is rounding noise in both frameworks, and at eps 1e-8 Adam
    steps such a parameter by up to the full rate in a direction the noise
    picks, which would then shift the running statistics behind it too. At
    1e-3, the size of the smaller real gradient elements, the update follows
    the same formula and the noise moves nothing. The recipe's eps is held
    against JAX in test_recipe_eps_update_matches_jax_where_conditioned."""

    @functools.lru_cache(maxsize=None)
    def run(kind):
        ref = run_once(tmp_path_factory, f"stage1_three_steps_{kind}",
                       lambda shared: _jax_three_steps(kind))[1]
        tc = _cfg(tcfg, kind, adam_eps=1e-3)
        sd = from_jax.stage1_state_dict(ref["start"])
        tstate = tstage1.create_train_state(tc, device="cpu", state_dict=sd)
        tstep = tstage1.make_train_step(tc)
        tlogs = []
        for batch in [_batch(seed) for seed in (0, 1, 2)]:
            tstate, lg = tstep(tstate, batch)
            tlogs.append({k: float(v) for k, v in lg.items()})
        return ref["jlogs"], tlogs, sd, from_jax.stage1_state_dict(ref["final"]), tstate

    return run


@pytest.mark.parametrize("kind", ["resnet3d", "avhubert"])
def test_train_step_logs_match_jax(kind, three_steps):
    """1e-4 relative: f32 losses summed over ~10^3 terms and a gradient norm
    over ~10^5 elements, in another order."""
    jlogs, tlogs, _, _, tstate = three_steps(kind)
    assert tstate.step == 3
    for ref, got in zip(jlogs, tlogs):
        assert set(got) == set(ref)
        assert got["sample_size"] == ref["sample_size"] == 5.0    # one dummy row of 6
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["resnet3d", "avhubert"])
def test_train_step_running_statistics_match_jax(kind, three_steps):
    """BatchNorm statistics after 3 steps x 2 micro-batches carried one
    into the next; 1e-4 absolute."""
    _, _, start, final, tstate = three_steps(kind)
    got = tstate.model.state_dict()
    stats = [k for k in final if k.endswith(("running_mean", "running_var"))]
    assert stats
    trained = [k for k in stats if not (kind == "avhubert" and k.startswith("frontend"))]
    assert trained
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), final[k].numpy(), atol=1e-4, err_msg=k)
    for k in trained:
        assert not torch.allclose(final[k], start[k]), k


@pytest.mark.parametrize("kind", ["resnet3d", "avhubert"])
def test_train_step_parameters_match_jax(kind, three_steps):
    """Parameters after three AdamW updates (rates 0, 5e-4, 1e-3): 2e-5
    absolute, a fiftieth of the last step."""
    _, _, start, final, tstate = three_steps(kind)
    got = tstate.model.state_dict()
    assert set(got) == set(final)
    moved = 0
    for k, ref in final.items():
        if k.endswith(("running_mean", "running_var")):
            continue
        np.testing.assert_allclose(got[k].numpy(), ref.numpy(), atol=2e-5, err_msg=k)
        moved += int(not torch.equal(ref, start[k]))
    assert moved > 20


def test_recipe_eps_update_matches_jax_where_conditioned():
    """Two AdamW updates (rates 0, 1e-3) at the recipe's eps 1e-8. Adam
    divides by sqrt(v), so an element whose gradient is rounding noise (zero
    in exact arithmetic, or far below its tensor's scale) steps by the full
    rate in a direction the noise picks, in either framework. Compared are
    the elements whose gradient history r = sqrt(v_hat) of the port's
    optimizer is at least a tenth of their tensor's largest, in tensors
    whose largest r is at least 1e-4 of the model's: 2e-5 absolute, a
    fiftieth of the step; they must be a tenth of all elements at least."""
    jc, tc = _cfg(jcfg, warmup_updates=1), _cfg(tcfg, warmup_updates=1)
    assert tc.stage1.adam_eps == jc.stage1.adam_eps == 1e-8
    batches = [_batch(seed, dummy=False) for seed in (6, 7)]
    micro0 = {k: v[0] for k, v in batches[0].items()}
    model, tx, jstate = jstage1.create_train_state(jc, jax.random.PRNGKey(0), micro0)
    sd = from_jax.stage1_state_dict({"params": _np_tree(jstate.params),
                                     "batch_stats": _np_tree(jstate.batch_stats)})
    tstate = tstage1.create_train_state(tc, device="cpu", state_dict=sd)
    jstep, tstep = jstage1.make_train_step(model, tx, jc, mesh=None), tstage1.make_train_step(tc)
    for i, batch in enumerate(batches):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(10 + i))
        tstate, _ = tstep(tstate, batch)
    ref = from_jax.jax_tree_to_state_dict(_np_tree(jstate.params))
    r = {n: (tstate.optimizer.state[p]["exp_avg_sq"] / (1 - tc.stage1.adam_b2 ** 2)).sqrt()
         for n, p in tstate.model.named_parameters()}
    r_max = max(float(x.max()) for x in r.values())
    compared = total = moved = 0
    for n, p in tstate.model.named_parameters():
        total += p.numel()
        if float(r[n].max()) < 1e-4 * r_max:
            continue
        inside = r[n] >= 0.1 * r[n].max()
        compared += int(inside.sum())
        np.testing.assert_allclose(p.detach()[inside].numpy(), ref[n][inside].numpy(), atol=2e-5,
                                   err_msg=n)
        moved += int(not torch.equal(ref[n], sd[n]))
    assert compared >= total // 10 and moved > 20


def test_frozen_frontend_is_unchanged_and_without_gradient(three_steps):
    _, _, start, final, tstate = three_steps("avhubert")
    got = tstate.model.state_dict()
    frontend = [k for k in start if k.startswith("frontend")]
    assert len(frontend) > 50
    for k in frontend:
        assert torch.equal(got[k], start[k]), k
        assert torch.equal(final[k], start[k]), k          # JAX leaves it alone too
    assert all(not p.requires_grad and p.grad is None
               for m in tstate.model.frontend_modules() for p in m.parameters())
    names = {n for n, _ in tstate.model.named_parameters()}
    in_optimizer = sum(len(g["params"]) for g in tstate.optimizer.param_groups)
    assert in_optimizer == len([n for n in names if not n.startswith("frontend")])
    assert not any(m.training for fm in tstate.model.frontend_modules() for m in fm.modules())
    assert tstate.model.conformer.training


def test_first_step_gradients_match_jax_by_name():
    """The divided gradients of one accumulated step, by parameter name;
    each tensor to 1e-4 of the largest gradient element of the step."""
    jc, tc = _cfg(jcfg), _cfg(tcfg)
    batch = _batch(3, dummy=False)      # the JAX mel loss has no finite gradient on a dummy row
    micro0 = {k: v[0] for k, v in batch.items()}
    model, tx, jstate = jstage1.create_train_state(jc, jax.random.PRNGKey(0), micro0)
    sd = from_jax.stage1_state_dict({"params": _np_tree(jstate.params),
                                     "batch_stats": _np_tree(jstate.batch_stats)})

    def jloss(params, stats, micro):
        from lip2speech_tpu.train.losses import stage1_loss

        out, mut = model.apply({"params": params, "batch_stats": stats}, micro["video"],
                               micro["frames_mask"], micro["spk_emb"], train=True,
                               rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        loss, ss, _ = stage1_loss(out, micro, PAD)
        return loss, (ss, mut["batch_stats"])

    grads, ss_sum, stats = None, 0.0, jstate.batch_stats
    for i in range(2):
        micro = {k: jnp.asarray(v[i]) for k, v in batch.items()}
        (_, (ss, stats)), g = jax.value_and_grad(jloss, has_aux=True)(jstate.params, stats, micro)
        grads = g if grads is None else jax.tree_util.tree_map(jnp.add, grads, g)
        ss_sum += float(ss)
    tstate = tstage1.create_train_state(tc, device="cpu", state_dict=sd)
    ref = from_jax.jax_tree_to_state_dict(_np_tree(grads))
    assert set(ref) == {name for name, _ in tstate.model.named_parameters()}

    from lip2speech_tpu_torch.train.losses import stage1_loss

    for i in range(2):
        micro = {k: torch.as_tensor(v[i]) for k, v in batch.items()}
        out = tstate.model(micro["video"], micro["frames_mask"], micro["spk_emb"])
        stage1_loss(out, micro, PAD)[0].backward()
    scale = max(float(r.abs().max()) for r in ref.values())
    for name, p in tstate.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=1e-4 * scale,
                                   err_msg=name)


def test_bf16_compute_keeps_f32_master_weights_and_statistics():
    cfg = _cfg(tcfg, bf16_compute=True)
    state = tstage1.create_train_state(cfg, seed=0, device="cpu")
    ref = tstage1.create_train_state(_cfg(tcfg), seed=0, device="cpu")
    step = tstage1.make_train_step(cfg)
    batch = _batch(4)
    for _ in range(2):
        state, logs = step(state, batch)
        ref, ref_logs = tstage1.make_train_step(_cfg(tcfg))(ref, batch)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(b.dtype == torch.float32 for b in state.model.buffers())
    assert all(v.dtype == torch.float32 for v in logs.values() if v.is_floating_point())
    # bf16 arithmetic: the same training function to bf16 accuracy
    assert float(logs["loss"]) == pytest.approx(float(ref_logs["loss"]), rel=2e-2)
    assert float(logs["grad_norm"]) == pytest.approx(float(ref_logs["grad_norm"]), rel=0.1)


# ------------------------------------------------------------- batch helpers

def _host_batch(rng, b, t, uint8=False):
    video = (rng.integers(0, 256, (b, t, 8, 8, 1), dtype=np.uint8) if uint8
             else rng.standard_normal((b, t, 8, 8, 1)).astype(np.float32))
    return {"video": video, "frames_mask": np.ones((b, t), bool),
            "spk_emb": rng.standard_normal((b, 256)).astype(np.float32),
            "unit_tokens": rng.integers(4, 204, (b, 2 * t + 1)).astype(np.int32),
            "mel": rng.standard_normal((b, 4 * t, 80)).astype(np.float32),
            "ids": [f"clip{i}" for i in range(b)]}


@pytest.mark.parametrize("uint8", [False, True])
def test_pad_batch_rows_and_stack_accum_match_jax(uint8):
    rng = np.random.default_rng(0)
    batches = [_host_batch(rng, 3, 5, uint8), _host_batch(rng, 2, 4, uint8)]
    ref = jstage1.pad_batch_rows(batches[1], 4, PAD)
    got = tstage1.pad_batch_rows(batches[1], 4, PAD)
    assert got["ids"] == ref["ids"]
    for k in ref:
        if k != "ids":
            np.testing.assert_array_equal(got[k], ref[k])
    if uint8:
        assert (got["video"][2:] == tstage1.UINT8_FILL).all() and tstage1.UINT8_FILL == 107
    assert tstage1.pad_batch_rows(batches[0], 3, PAD) is batches[0]
    ref = jstage1.stack_accum(batches, pad_id=PAD, batch_size=4)
    got = tstage1.stack_accum(batches, pad_id=PAD, batch_size=4)
    assert set(got) == set(ref) and "ids" not in got
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])
    assert got["video"].shape[:3] == (2, 4, 5)
    same = [_host_batch(rng, 2, 4), _host_batch(rng, 2, 4)]
    np.testing.assert_array_equal(tstage1.stack_accum(same)["mel"],
                                  jstage1.stack_accum(same)["mel"])


def test_dummy_rows_add_no_loss_and_no_sample_size():
    cfg = _cfg(tcfg, update_freq=1)
    rng = np.random.default_rng(1)
    one = {k: v for k, v in _host_batch(rng, 2, 4).items()}
    one["video"] = rng.standard_normal((2, 4, 24, 24, 1)).astype(np.float32)
    plain = tstage1.stack_accum([one])
    padded = tstage1.stack_accum([one], pad_id=PAD, batch_size=4)
    assert padded["video"].shape[1] == 4
    logs = []
    for batch in (plain, padded):
        state = tstage1.create_train_state(cfg, seed=0, device="cpu")
        state.model.eval()                      # batch statistics would see the dummy rows
        out = state.model(*(torch.as_tensor(batch[k][0]) for k in ("video", "frames_mask", "spk_emb")))
        from lip2speech_tpu_torch.train.losses import stage1_loss
        loss, ss, _ = stage1_loss(out, {k: torch.as_tensor(v[0]) for k, v in batch.items()}, PAD)
        logs.append((float(loss), int(ss)))
    assert logs[0][1] == logs[1][1] == 2
    assert logs[0][0] == pytest.approx(logs[1][0], rel=1e-5)


# ---------------------------------------------------------------- eval step

def test_eval_step_matches_jax_and_leaves_the_mode():
    jc, tc = _cfg(jcfg), _cfg(tcfg)
    batch = {k: v[0] for k, v in _batch(5).items()}
    model, _, jstate = jstage1.create_train_state(jc, jax.random.PRNGKey(0), batch)
    sd = from_jax.stage1_state_dict({"params": _np_tree(jstate.params),
                                     "batch_stats": _np_tree(jstate.batch_stats)})
    tstate = tstage1.create_train_state(tc, device="cpu", state_dict=sd)
    ref = jstage1.make_eval_step(model, jc)(jstate.params, jstate.batch_stats,
                                            {k: jnp.asarray(v) for k, v in batch.items()})
    got = tstage1.make_eval_step(tc)(tstate.model, batch)
    assert int(got[0]) == int(ref[0]) and int(got[1]) == int(ref[1])
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-5)
    assert tstate.model.training

    class _Dataset:
        def batches(self, batch_size, shuffle):
            assert batch_size == 3 and shuffle is False
            yield {**batch, "ids": ["a", "b", "c"]}
            yield {**batch, "ids": ["d", "e", "f"]}

    res = tstage1.evaluate(tstate, _Dataset(), 3, tc)
    assert res["n_tokens"] == 2 * int(ref[1])
    assert res["nll"] == pytest.approx(float(ref[2]) / float(ref[1]), rel=1e-5)


# -------------------------------------------------------------------- noise

def _noisy_outputs(model, batch, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        out = model(torch.as_tensor(batch["video"][0]), torch.as_tensor(batch["frames_mask"][0]),
                    torch.as_tensor(batch["spk_emb"][0]), gen=gen)
    return out["unit_logits"], out["mel"]


@pytest.mark.parametrize("kind", ["resnet3d", "raven"])
def test_training_noise_is_deterministic_per_seed_and_off_in_eval(kind):
    """Dropout 0.2 everywhere (attention dropout through the mask of
    ops/dropout_mask.py); raven adds drop-path in its frontend encoder once
    that is unfrozen."""
    cfg = _cfg(tcfg, kind, dropout=0.2)
    if kind == "raven":
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, frontend=dataclasses.replace(cfg.model.frontend, frozen=False)))
    state = tstage1.create_train_state(cfg, seed=0, device="cpu")
    model, batch = state.model, _batch(6)
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    a, a2, b = (_noisy_outputs(model, batch, s) for s in (1, 1, 2))
    for x, y in zip(a, a2):
        assert torch.equal(x, y)
    assert not torch.allclose(a[0], b[0]) and not torch.allclose(a[1], b[1])
    model.load_state_dict(stats, strict=False)
    model.eval()
    e1, e2 = (_noisy_outputs(model, batch, s) for s in (1, 2))
    for x, y in zip(e1, e2):
        assert torch.equal(x, y)
    assert not torch.allclose(e1[0], a[0])


def test_drop_path_and_dropout_ops():
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    x = torch.ones(64, 5, 7)
    y = tops.drop_path(x, 0.25, gen())
    per_sample = y.reshape(64, -1)
    assert ((per_sample == 0).all(1) | (per_sample == 1 / 0.75).all(1)).all()   # whole samples
    assert 0 < int((per_sample == 0).all(1).sum()) < 64
    assert torch.equal(y, tops.drop_path(x, 0.25, gen()))
    assert tops.drop_path(x, 0.0, None) is x and tops.dropout(x, 0.0, None) is x
    d = tops.dropout(torch.ones(100_000), 0.3, gen())
    assert sorted(d.unique().tolist()) == pytest.approx([0.0, 1 / 0.7])
    assert float((d != 0).float().mean()) == pytest.approx(0.7, abs=0.01)
    # the conformer's drop-path rate rises linearly over the layers, as in the JAX module
    from lip2speech_tpu_torch.models.conformer import ConformerEncoder
    enc = ConformerEncoder(8, 8, 16, 2, layers=3, conv_kernel=3, drop_path=0.1)
    assert [getattr(enc, f"layers_{i}").drop_path for i in range(3)] == [0.0, 0.05, 0.1]


def test_modality_dropout_draws_once_per_forward():
    from lip2speech_tpu_torch.models.avhubert import fuse_modality_features

    a, v = torch.ones(2, 3, 4), 2 * torch.ones(2, 3, 4)
    seen = set()
    for seed in range(40):
        fa, fv = fuse_modality_features(a, v, 0.8, 0.5, True, torch.Generator().manual_seed(seed))
        assert float(fa.min()) == float(fa.max()) and float(fv.min()) == float(fv.max())
        seen.add((float(fa[0, 0, 0]), float(fv[0, 0, 0])))
    assert seen == {(1.0, 2.0), (0.0, 2.0), (1.0, 0.0)}          # never both
    fa, fv = fuse_modality_features(a, v, 0.8, 0.5, False)
    assert torch.equal(fa, a) and torch.equal(fv, v)
    fa, fv = fuse_modality_features(None, v, 0.8, 0.5, True)
    assert torch.equal(fa, torch.zeros_like(v)) and torch.equal(fv, v)


def test_create_train_state_without_cuda_raises_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstage1.create_train_state(_cfg(tcfg))
    assert tstage1.create_train_state(_cfg(tcfg), device="cpu").device == torch.device("cpu")
