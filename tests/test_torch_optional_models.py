"""The port's optional modules (lip2speech_tpu_torch/models/resnet1d.py,
shufflenet.py, vq.py, convert/from_jax.vq_state_dict) against the JAX
package's on the CPU: flax weights with non-trivial BatchNorm statistics
and PReLU alphas, carried across by the converter; the same numpy inputs on
both sides; eval mode and training mode (BatchNorm on the batch statistics,
the running statistics against flax's mutable batch_stats; the VQ's EMA
update against its mutable vq_stats). Tolerance 1e-4 of max |ref|, the VQ's
1e-6 (quantized, commit, metrics) and 1e-5 (the EMA state), codes equal.

The VQ's dead-code restart departs from JAX on purpose (ROADMAP §3): the
port draws its rows from the caller's torch.Generator. To compare every
other element of the update, the JAX module's jax.random.randint is made to
return the port's draws; test_vq_dead_code_restarts_at_a_row_of_the_input
shows the departure itself."""

import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lip2speech_tpu.models import resnet1d as jr1
from lip2speech_tpu.models import shufflenet as jsh
from lip2speech_tpu.models import vq as jvq
from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.models import resnet1d as tr1
from lip2speech_tpu_torch.models import shufflenet as tsh
from lip2speech_tpu_torch.models import vq as tvq

from test_torch_modules import _perturb

TOL = 1e-4


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, f"{what}: {got.shape} vs {ref.shape}"
    err, scale = np.abs(got - ref).max(), max(np.abs(ref).max(), 1e-30)
    assert err <= tol * scale, f"{what}: max err {err:.3e} of max |ref| {scale:.3e}"


@functools.lru_cache(maxsize=None)
def _jax_variables(jm, shape: tuple, init_seed: int):
    """Perturbed flax weights of jm (a hashable flax module) for inputs of
    `shape`, made once a process."""
    return _perturb(jax.tree_util.tree_map(np.asarray, dict(jm.init(
        jax.random.PRNGKey(init_seed), jnp.zeros(shape, jnp.float32)))), seed=init_seed)


def _against_jax(jm, tm, x: np.ndarray, train: bool, init_seed: int):
    """The flax weights into the port module; both run on x. Returns (port
    output, JAX output, port state_dict, JAX batch_stats as a state_dict)."""
    v = _jax_variables(jm, x.shape, init_seed)
    tm.load_state_dict(from_jax.stage1_state_dict(v), strict=True)
    tm.train(train)
    if train:
        ref, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        stats = from_jax.jax_tree_to_state_dict(jax.tree_util.tree_map(np.asarray, dict(upd)["batch_stats"]))
    else:
        ref, stats = jm.apply(v, jnp.asarray(x)), {}
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    return got, np.asarray(ref), tm.state_dict(), stats


def _check_stats(sd, stats, what):
    assert stats
    for k, ref in stats.items():
        _close(sd[k], ref.numpy(), f"{what} {k}")


# ------------------------------------------------------------------ Conv1D ResNet

@pytest.mark.parametrize("relu_type,ratio", [("prelu", 1), ("swish", 1), ("swish", 2)])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_conv1d_resnet_frontend(relu_type, ratio, train):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4 * 640 + 250, 1)).astype(np.float32)   # cut to 2,560 samples
    got, ref, sd, stats = _against_jax(jr1.Conv1dResNetFrontend(relu_type, ratio),
                                       tr1.Conv1dResNetFrontend(relu_type, ratio), x, train, 1)
    assert got.shape == (2, 4 * ratio, 512)
    _close(got, ref, f"resnet1d {relu_type}")
    if relu_type == "prelu":
        assert "act.weight" in sd and "trunk_layer2_0.act2.weight" in sd
    if train:
        _check_stats(sd, stats, "resnet1d")


# ------------------------------------------------------------------ ShuffleNetV2

def test_channel_shuffle_matches_the_channel_last_order():
    x = np.random.default_rng(2).standard_normal((2, 3, 4, 10)).astype(np.float32)   # (N, H, W, C)
    ref = np.asarray(jsh.channel_shuffle(jnp.asarray(x), 2))
    got = tsh.channel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_shufflenet_frontend(train):
    # 64 x 64 crops: the last stage's BatchNorm then sees 2 x 2 positions a
    # frame (at 32 x 32 one, and its batch variance amplifies rounding)
    x = np.random.default_rng(3).standard_normal((2, 2, 64, 64, 1)).astype(np.float32)
    got, ref, sd, stats = _against_jax(jsh.ShuffleNet3DFrontend(), tsh.ShuffleNet3DFrontend(),
                                       x, train, 2)
    assert got.shape == (2, 2, 1024)
    assert sd["trunk.stage2_0.b1_dw.conv.weight"].shape == (24, 1, 3, 3)    # depthwise, groups=24
    _close(got, ref, "shufflenet")
    if train:
        _check_stats(sd, stats, "shufflenet")


# ------------------------------------------------------------------ VQ

K, D = 8, 4


@contextlib.contextmanager
def _jax_draws(draws: list):
    """jax.random.randint returns the next of `draws` (the port's restart
    rows) instead of threefry's."""
    real = jax.random.randint
    queue = list(draws)
    jax.random.randint = lambda *args, **kwargs: jnp.asarray(queue.pop(0))
    try:
        yield
    finally:
        jax.random.randint = real


def _vq_variables(x):
    """The JAX init's codebook, with code K-1 moved far away and its count
    low: it wins no input and is dead at the first update."""
    v = jax.tree_util.tree_map(np.asarray, dict(jvq.VQBottleneck(K, D, mu=0.5).init(
        jax.random.PRNGKey(0), jnp.asarray(x))))
    stats = {k: np.array(a) for k, a in v["vq_stats"].items()}
    stats["codebook"][K - 1] = 50.0
    stats["ema_sum"][K - 1] = 50.0
    stats["ema_count"][K - 1] = 0.2
    return {"vq_stats": stats}


def _vq_inputs(n=3):
    rng = np.random.default_rng(4)
    return [rng.standard_normal((2, 16, D)).astype(np.float32) for _ in range(n)]


def test_vq_bottleneck_matches_jax_with_a_straight_through_gradient():
    x = _vq_inputs(1)[0]
    v = _vq_variables(x)
    jm = jvq.VQBottleneck(K, D, mu=0.5)
    codes_r, q_r, commit_r, metrics_r = jm.apply(v, jnp.asarray(x))
    tm = tvq.VQBottleneck(K, D, mu=0.5)
    tm.load_state_dict(from_jax.vq_state_dict(v), strict=True)
    tm.eval()
    xt = torch.from_numpy(x).requires_grad_()
    codes, q, commit, metrics = tm(xt)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_r))
    _close(q.detach(), q_r, "quantized", 1e-6)
    _close(float(commit.detach()), float(commit_r), "commit", 1e-6)
    assert set(metrics) == set(metrics_r)
    for k in metrics:
        _close(float(metrics[k]), float(metrics_r[k]), k, 1e-6)
    (q * 2.0).sum().backward()
    g_ref = jax.grad(lambda a: jnp.sum(jm.apply(v, a)[1] * 2.0))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(g_ref))
    np.testing.assert_array_equal(xt.grad.numpy(), np.full_like(x, 2.0))


def test_vq_three_ema_updates_match_jax():
    xs = _vq_inputs()
    v = _vq_variables(xs[0])
    draws_gen = torch.Generator().manual_seed(5)
    draws = [torch.randint(0, 32, (K,), generator=draws_gen).numpy() for _ in xs]
    tm = tvq.VQBottleneck(K, D, mu=0.5)
    tm.load_state_dict(from_jax.vq_state_dict(v), strict=True)
    tm.train()
    gen = torch.Generator().manual_seed(5)
    jm = jvq.VQBottleneck(K, D, mu=0.5)
    state = v
    with _jax_draws(draws):
        for i, x in enumerate(xs):
            (codes_r, _, _, _), upd = jm.apply(state, jnp.asarray(x), train=True, mutable=["vq_stats"])
            state = jax.tree_util.tree_map(np.asarray, dict(upd))
            with torch.no_grad():
                codes, _, _, _ = tm(torch.from_numpy(x), gen)
            np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_r))
            for k, ref in from_jax.vq_state_dict(state).items():
                _close(tm.state_dict()[k], ref.numpy(), f"update {i + 1} {k}", 1e-5)
    # code K-1 was dead at the first update and restarted at an input row
    assert not np.isclose(tm.codebook[K - 1].numpy(), 50.0).any()


def test_vq_dead_code_restarts_at_a_row_of_the_input():
    """The departure (ROADMAP §3): the restart row comes from the caller's
    generator, so it is a row of the input that the JAX module's fixed
    PRNGKey(0) does not pick; two runs from one seed restart alike."""
    x = _vq_inputs(1)[0]
    v = _vq_variables(x)
    _, upd = jvq.VQBottleneck(K, D, mu=0.5).apply(v, jnp.asarray(x), train=True, mutable=["vq_stats"])
    jax_row = np.asarray(upd["vq_stats"]["codebook"][K - 1])
    rows = []
    for _ in range(2):
        tm = tvq.VQBottleneck(K, D, mu=0.5)
        tm.load_state_dict(from_jax.vq_state_dict(v), strict=True)
        with torch.no_grad():
            tm.train()(torch.from_numpy(x), torch.Generator().manual_seed(7))
        rows.append(tm.codebook[K - 1].numpy())
    idx = torch.randint(0, 32, (K,), generator=torch.Generator().manual_seed(7))[K - 1]
    np.testing.assert_array_equal(rows[0], x.reshape(-1, D)[idx])
    np.testing.assert_array_equal(rows[0], rows[1])
    assert any(np.array_equal(jax_row, r) for r in x.reshape(-1, D))     # JAX: a row of the input too
    assert not np.array_equal(rows[0], jax_row)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_vq_encoder_decoder_and_quantizer(train):
    x = np.random.default_rng(6).standard_normal((2, 32, 1)).astype(np.float32)
    jm = jvq.VQQuantizer(dim=16, codebook_size=8, strides=(2, 2))
    v = jax.tree_util.tree_map(np.asarray, dict(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))))
    tm = tvq.VQQuantizer(dim=16, codebook_size=8, strides=(2, 2))
    tm.load_state_dict(from_jax.vq_state_dict(v), strict=True)
    tm.train(train)
    with _jax_draws([np.zeros(8, np.int32)]):
        (recon_r, codes_r, commit_r, metrics_r), upd = jm.apply(
            v, jnp.asarray(x), train=train, mutable=["vq_stats"])
    h_ref = jvq.VQEncoder(16, (2, 2)).apply({"params": v["params"]["encoder"]}, jnp.asarray(x))
    with torch.no_grad():
        h = tm.encoder(torch.from_numpy(x))
        y_ref = jvq.VQDecoder(16, 1, (2, 2)).apply({"params": v["params"]["decoder"]}, h_ref)
        y = tm.decoder(torch.from_numpy(np.array(h_ref)))
        with _zero_draws():
            recon, codes, commit, metrics = tm(torch.from_numpy(x))
    _close(h, h_ref, "encoder")
    _close(y, y_ref, "decoder")
    assert recon.shape == x.shape
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_r))
    _close(recon, recon_r, "recon")
    _close(float(commit), float(commit_r), "commit")
    for k in metrics:
        _close(float(metrics[k]), float(metrics_r[k]), k)
    for k, ref in from_jax.vq_state_dict({"vq_stats": dict(upd)["vq_stats"]}).items():
        _close(tm.state_dict()[k], np.asarray(ref), k, 1e-5)


@contextlib.contextmanager
def _zero_draws():
    """The port's restart rows all 0, as _jax_draws gives the JAX module."""
    real = torch.randint
    torch.randint = lambda low, high, size, **kwargs: torch.zeros(size, dtype=torch.long)
    try:
        yield
    finally:
        torch.randint = real


def test_vq_converter_is_strict():
    x = _vq_inputs(1)[0]
    v = _vq_variables(x)
    tm = tvq.VQBottleneck(K, D)
    with pytest.raises(KeyError, match="vq_stats"):
        from_jax.vq_state_dict({"params": {}})
    with pytest.raises(KeyError, match="batch_stats"):
        from_jax.vq_state_dict({**v, "batch_stats": {}})
    stats = {k: a for k, a in v["vq_stats"].items() if k != "ema_sum"}
    with pytest.raises(RuntimeError, match="ema_sum"):
        tm.load_state_dict(from_jax.vq_state_dict({"vq_stats": stats}), strict=True)
    with pytest.raises(RuntimeError, match="stray"):
        tm.load_state_dict(from_jax.vq_state_dict(
            {"vq_stats": {**v["vq_stats"], "stray": np.zeros(2, np.float32)}}), strict=True)
