"""The port's stage-2 modules (lip2speech_tpu_torch/models/vocoder.py) against
the JAX package on the CPU: the multi-period and multi-scale discriminators
from carried weights (scores, every feature map, the spectral-norm u after a
training call, eval mode), the three GAN losses, the generator's training
mode (dropout after the unit upsampler's GELU) and its fused-tail switch,
and TrioFn: the trio kernel's autograd wrapper, with the kernel's place
taken by the plain version (no card here)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lip2speech_tpu.models import vocoder as jvoc
from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.core import config as tcfg
from lip2speech_tpu_torch.models import vocoder as tvoc
from lip2speech_tpu_torch.models.layers import init_weights
from lip2speech_tpu_torch.ops import fused_tail as tft

from test_torch_modules import _np_tree

T = 1_283                        # a multiple of none of the periods 2, 3, 5, 7, 11


def _gains(params, seed):
    """Weight-norm gains away from ||v|| (JAX initialises g = ||v||)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                (v * rng.uniform(0.5, 1.5, v.shape).astype(np.float32) if k == "weight_g" else v)
                for k, v in node.items()}

    return walk(_np_tree(params))


@pytest.fixture(scope="module")
def discs():
    """Both discriminators of the JAX package, initialised once (jitted: the
    eager init of ~70 M parameters takes several times as long), and the
    port's twins carrying the same weights and u."""
    rng = np.random.default_rng(0)
    y = (0.5 * np.sin(np.arange(T) / 7.0)[None] + 0.1 * rng.standard_normal((2, T))).astype(np.float32)
    y_hat = (0.3 * rng.standard_normal((2, T))).astype(np.float32)
    a = jnp.asarray(y)
    mpd, msd = jvoc.MultiPeriodDiscriminator(), jvoc.MultiScaleDiscriminator()
    mv = jax.jit(lambda k: mpd.init({"params": k}, a, a))(jax.random.PRNGKey(1))
    sv = jax.jit(lambda k: msd.init({"params": k}, a, a))(jax.random.PRNGKey(2))
    mparams, sparams, spectral = _gains(mv["params"], 1), _gains(sv["params"], 2), _np_tree(sv["spectral"])
    tmpd, tmsd = tvoc.MultiPeriodDiscriminator(), tvoc.MultiScaleDiscriminator()
    tmpd.load_state_dict(from_jax.discriminator_state_dict(mparams), strict=True)
    tmsd.load_state_dict(from_jax.discriminator_state_dict(sparams, spectral), strict=True)
    yy = (jnp.asarray(y), jnp.asarray(y_hat))
    ref = {"mpd": jax.jit(lambda p: mpd.apply({"params": p}, *yy, train=True))(mparams),
           "msd_train": jax.jit(lambda p, s: msd.apply({"params": p, "spectral": s}, *yy, train=True,
                                                       mutable=["spectral"]))(sparams, spectral),
           "msd_eval": jax.jit(lambda p, s: msd.apply({"params": p, "spectral": s}, *yy))(
               sparams, spectral)}
    return {"y": torch.from_numpy(y), "y_hat": torch.from_numpy(y_hat), "ref": ref,
            "tmpd": tmpd, "tmsd": tmsd}


def _check_outputs(ref, got, fmap_layout, atol):
    """ref / got: (real scores, generated scores, real fmaps, generated fmaps)."""
    for r_list, g_list in zip(ref[:2], got[:2]):
        assert len(r_list) == len(g_list)
        for r, g in zip(r_list, g_list):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), atol=atol)
    n_maps = 0
    for r_all, g_all in zip(ref[2:], got[2:]):
        for r_disc, g_disc in zip(r_all, g_all):
            assert len(r_disc) == len(g_disc)
            for r, g in zip(r_disc, g_disc):
                np.testing.assert_allclose(fmap_layout(g).detach().numpy(), np.asarray(r), atol=atol)
                n_maps += 1
    return n_maps


def test_mpd_scores_and_feature_maps_match_jax(discs):
    """Five periods, each folding a reflect-padded waveform; the port keeps
    the reference (B, C, T/p, p) layout, JAX (B, T/p, p, C). 1e-5 absolute
    (f32 convs of up to 1024 x 5 taps)."""
    ref = discs["ref"]["mpd"]
    got = discs["tmpd"](discs["y"], discs["y_hat"])
    assert _check_outputs(ref, got, lambda f: f.permute(0, 2, 3, 1), 1e-5) == 2 * 5 * 6
    assert [s.shape[1] % p for s, p in zip(got[0], (2, 3, 5, 7, 11))] == [0] * 5


def test_msd_train_call_matches_jax_and_advances_u(discs):
    """A training call: disc_s0 takes one power iteration per waveform (real,
    then generated) and keeps u; the outputs use the new u. Scores and
    feature maps 1e-5, u 1e-6 (a unit vector)."""
    tmsd = discs["tmsd"]
    u0 = {k: v.clone() for k, v in tmsd.named_buffers()}
    tmsd.train()
    ref, mutated = discs["ref"]["msd_train"]
    got = tmsd(discs["y"], discs["y_hat"])
    assert _check_outputs(ref, got, lambda f: f.transpose(1, 2), 1e-5) == 2 * 3 * 8
    new_u = from_jax.jax_tree_to_state_dict(_np_tree(mutated["spectral"]))
    assert set(new_u) == set(u0) and len(u0) == 8
    for k, v in tmsd.named_buffers():
        np.testing.assert_allclose(v.numpy(), new_u[k].numpy(), atol=1e-6, err_msg=k)
        assert not torch.allclose(v, u0[k])
        assert float(v.norm()) == pytest.approx(1.0, abs=1e-5)
    with torch.no_grad():
        for k, v in tmsd.named_buffers():
            v.copy_(u0[k])


def test_msd_eval_call_matches_jax_and_keeps_u(discs):
    """An eval call: sigma from u as it is (JAX's u starts unnormalised),
    u unchanged; 1e-5. sigma is also held against its definition."""
    tmsd = discs["tmsd"].eval()
    u0 = {k: v.clone() for k, v in tmsd.named_buffers()}
    assert float(u0["disc_s0.convs_0.u"].norm()) > 2.0
    ref = discs["ref"]["msd_eval"]
    got = tmsd(discs["y"], discs["y_hat"])
    _check_outputs(ref, got, lambda f: f.transpose(1, 2), 1e-5)
    assert all(torch.equal(v, u0[k]) for k, v in tmsd.named_buffers())
    conv = tmsd.disc_s0.convs_3
    w2d = conv.weight.detach().reshape(conv.weight.shape[0], -1).double()
    u = conv.u.double()
    v = w2d.T @ u
    v = v / v.norm()
    sigma = float(u @ w2d @ v)
    np.testing.assert_allclose(conv.normalised_weight().detach().numpy(),
                               (conv.weight.detach().double() / sigma).numpy(), rtol=1e-5)
    tmsd.train()


def test_spectral_weight_gradient_keeps_u_and_v_constant():
    """d(w / sigma)/dw with u and v held (torch spectral_norm's and the JAX
    stop_gradient): the same as autograd through w / (u^T w v) with u, v
    taken as constants after the iteration."""
    conv = tvoc.SpectralConv1d(4, 6, 3)
    init_weights(conv, torch.Generator().manual_seed(0))
    conv.train()
    u_before = conv.u.clone()
    w_norm = conv.normalised_weight()
    g = torch.randn(w_norm.shape, generator=torch.Generator().manual_seed(1))
    (dw,) = torch.autograd.grad(w_norm, conv.weight, g)
    w2d = conv.weight.detach().reshape(6, -1)
    v = w2d.T @ u_before
    v = v / v.norm()
    u = conv.u.clone()                         # after the iteration
    assert torch.allclose(u, (w2d @ v) / (w2d @ v).norm())
    w = conv.weight.detach().clone().requires_grad_()
    (ref,) = torch.autograd.grad(w / (u @ (w.reshape(6, -1) @ v)), w, g)
    torch.testing.assert_close(dw, ref)


def test_gan_losses_match_jax(discs):
    """feature_loss (x 2 inside), discriminator_loss and generator_adv_loss
    on both discriminators' outputs; 1e-5 relative."""
    ref = discs["ref"]["mpd"]
    with torch.no_grad():
        got = discs["tmpd"](discs["y"], discs["y_hat"])
    pairs = [(jvoc.feature_loss(ref[2], ref[3]), tvoc.feature_loss(got[2], got[3])),
             (jvoc.discriminator_loss(ref[0], ref[1]), tvoc.discriminator_loss(got[0], got[1])),
             (jvoc.generator_adv_loss(ref[1]), tvoc.generator_adv_loss(got[1]))]
    for r, g in pairs:
        np.testing.assert_allclose(float(g), float(r), rtol=1e-5)
    assert float(pairs[0][1]) > 0 and float(pairs[1][1]) > 0


def test_avg_pool1d_matches_jax():
    from lip2speech_tpu.ops import nn as jops
    from lip2speech_tpu_torch.ops import nn as tops

    x = np.random.default_rng(0).standard_normal((2, 3, 37)).astype(np.float32)
    ref = np.asarray(jops.avg_pool1d(jnp.asarray(x.transpose(0, 2, 1)), 4, 2, 2)).transpose(0, 2, 1)
    np.testing.assert_allclose(tops.avg_pool1d(torch.from_numpy(x), 4, 2, 2).numpy(), ref, atol=1e-6)


# ------------------------------------------------------------------ generator

def _tiny_generator(seed=0):
    h = tcfg.VocoderConfig(model_in_dim=96, embedding_dim=8, upsample_initial_channel=64,
                           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),))
    g = tvoc.MelCodeGenerator(h)
    init_weights(g, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    inputs = (torch.from_numpy(rng.integers(0, 200, (2, 4))).long(),
              torch.from_numpy(rng.standard_normal((2, 8, 80)).astype(np.float32)),
              torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32)))
    return g, inputs


def test_generator_training_dropout_rate_and_determinism():
    """Training mode drops the upsampled units at 0.1 and scales the rest by
    1/0.9, the same mask for the same seed; eval mode draws nothing."""
    g, inputs = _tiny_generator()
    seen = []
    g.code_fc.register_forward_pre_hook(lambda m, args: seen.append(args[0].detach().clone()))
    g.eval()
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    with torch.no_grad():
        clean = g(*inputs, gen=gen)
        assert torch.equal(gen.get_state(), state)
        g.train()
        for seed in (1, 1, 2):
            g(*inputs, gen=torch.Generator().manual_seed(seed))
    x_eval, x_a, x_b, x_c = seen
    assert torch.equal(x_a, x_b) and not torch.equal(x_a, x_c)
    for x_train in (x_a, x_c):
        dropped = x_train == 0
        assert 0 < float(dropped.float().mean()) < 0.3
        torch.testing.assert_close(x_train[~dropped], x_eval[~dropped] / 0.9)
    big = torch.ones(200_000)
    kept = tvoc.ops.dropout(big, g.code_dropout, torch.Generator().manual_seed(3)) != 0
    assert g.code_dropout == 0.1
    assert float(kept.float().mean()) == pytest.approx(0.9, abs=0.003)
    g.code_dropout = 0.0
    torch.testing.assert_close(g(*inputs, gen=torch.Generator().manual_seed(1)).detach(), clean)


@pytest.mark.parametrize("width,fused", [(64, [32, 16, 8, 4, 2]), (512, [128, 64, 32, 16])])
def test_generator_routes_narrow_stages_through_the_trio(monkeypatch, width, fused):
    """Every stage of at most 128 channels goes through fused_resblock_trio
    (the kernel on the card; no config switch picks the plain trio there),
    the wider ones through the per-resblock loop; on the CPU the trio is the
    plain math of that loop (the mean of two resblocks here)."""
    h = tcfg.VocoderConfig(model_in_dim=96, upsample_initial_channel=width,
                           resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)))
    g = tvoc.HiFiGANGenerator(h).eval()
    init_weights(g, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 96, 4)).astype(np.float32))
    calls = []
    real = tvoc.fused_resblock_trio
    monkeypatch.setattr(tvoc, "fused_resblock_trio",
                        lambda *a: calls.append(a[0].shape[1]) or real(*a))
    with torch.no_grad():
        got = g(x)
        assert calls == fused
        monkeypatch.setattr(tvoc, "FUSED_MAX_CHANNELS", 0)    # the loop at every stage
        ref = g(x)
    assert calls == fused
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------- TrioFn

KS, DILS = (3, 5), ((1, 3), (1, 2))


def _trio_convs(c, seed=0):
    convs = [[(tvoc.WNConv1d(c, c, k), tvoc.WNConv1d(c, c, k)) for _ in d] for k, d in zip(KS, DILS)]
    gen = torch.Generator().manual_seed(seed)
    for rb in convs:
        for pair in rb:
            for conv in pair:
                conv.init_random(gen)
                with torch.no_grad():
                    conv.weight_v.mul_(20.0)          # weights of order 1/sqrt(C K)
                    conv.weight_g.mul_(torch.rand(conv.weight_g.shape, generator=gen) + 0.5)
    return convs


def _weights(convs):
    return [[tuple((c.weight(), c.bias) for c in pair) for pair in rb] for rb in convs]


def test_bare_kernel_refuses_inputs_that_require_grad():
    """The first check, before the device check: under grad, the bare kernel
    would cut the graph, so it raises and launches nothing."""
    convs = _trio_convs(8)
    x = torch.randn(1, 8, 20)
    before = tft.fused_resblock_trio_kernel.launches
    with pytest.raises(RuntimeError, match="no gradient"):
        tft.fused_resblock_trio_kernel(x.requires_grad_(), _weights(convs), KS, DILS)
    with pytest.raises(RuntimeError, match="no gradient"):
        tft.fused_resblock_trio_kernel(x.detach(), _weights(convs), KS, DILS)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tft.fused_resblock_trio_kernel(x, _weights(convs), KS, DILS)
    assert tft.fused_resblock_trio_kernel.launches == before


def test_trio_fn_gradients_match_autograd_through_the_plain_trio(monkeypatch):
    """TrioFn with the kernel's place taken by the plain version: the same
    output, and dx and the gradients of every weight_v, weight_g and bias
    equal autograd through trio_plain (the backward is that recompute)."""
    ran = []

    def plain_kernel(x, weights, ks, dils):
        assert not torch.is_grad_enabled()
        ran.append(x.shape)
        return tft.trio_plain(x, weights, ks, dils)

    monkeypatch.setattr(tft, "fused_resblock_trio_kernel", plain_kernel)
    convs = _trio_convs(8)
    params = [p for rb in convs for pair in rb for c in pair for p in c.parameters()]
    x0 = torch.randn(2, 8, 37, generator=torch.Generator().manual_seed(2))
    g = torch.randn(2, 8, 37, generator=torch.Generator().manual_seed(3))
    grads = {}
    for route in ("plain", "trio_fn"):
        x = x0.clone().requires_grad_()
        w = _weights(convs)
        if route == "plain":
            out = tft.trio_plain(x, w, KS, DILS)
        else:
            out = tft.TrioFn.apply(x, KS, DILS, tft._nesting(w), *tft._flat(w))
            assert out.grad_fn is not None
        grads[route] = (out.detach(), *torch.autograd.grad(out, [x, *params], g))
    assert ran == [(2, 8, 37)]
    assert len(params) == 2 * 2 * 2 * 3 and len(grads["plain"]) == 2 + len(params)
    for a, b in zip(grads["trio_fn"], grads["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
