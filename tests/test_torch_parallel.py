"""The port's parallel layer (lip2speech_tpu_torch/parallel/, the data- and
tensor-parallel train steps, data-parallel serving) against the JAX
package's mesh programs on the CPU.

Two ranks of torch.distributed (gloo over a FileStore, spawned once for the
module by tests/torch_parallel_ranks.py, one intra-op thread each) run, one
after the other: three stage-1 steps on a data axis of 2 (2 + 2 rows of
each micro-batch) and on a model axis of 2 (DP1 x TP2: 1 head of 2 a rank,
half the FFN units), each held to the JAX make_train_step(..., mesh) on the
conftest's virtual CPU devices (make_mesh(data=2) / make_mesh(data=1,
model=2)) at the tolerances of test_torch_train_stage1.py, BatchNorm
running statistics included; the TP conformer forward against the
replicated JAX forward of tests/test_tensor_parallel.py; and two GAN steps
on a data axis of 2 (1 + 1 rows) against the JAX single-device step on the
global batch (test_torch_train_stage2.py's, shared through run_once; the
JAX package's own test_stage2_gan_step_on_mesh_matches_single_device holds
its mesh step to it). Serving on a mesh of two CPU replicas is held to the
JAX pipeline on make_mesh(data=2) with a ragged batch of 3, which pads one
row."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lip2speech_tpu.core import config as jcfg
from lip2speech_tpu.models.conformer import ConformerEncoder as JaxEncoder
from lip2speech_tpu.parallel.mesh import make_mesh as jax_mesh
from lip2speech_tpu.pipeline.synthesise import Lip2SpeechPipeline as JaxPipeline
from lip2speech_tpu.train import stage1 as jstage1
from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.core import config as tcfg
from lip2speech_tpu_torch.parallel.mesh import make_mesh
from lip2speech_tpu_torch.pipeline.synthesise import Lip2SpeechPipeline as TorchPipeline

import torch_parallel_ranks as ranks
from test_torch_asr import run_once
from test_torch_modules import _np_tree
from test_torch_server import _weights as tiny_weights
from test_torch_train_stage1 import PAD, _cfg
from test_torch_train_stage2 import _batch as gan_batch
from test_torch_train_stage2 import _cfg as gan_cfg
from test_torch_train_stage2 import _jax_two_steps, _to_torch

MESHES = {"dp2": (2, 1), "tp2": (1, 2)}            # (data, model) of the stage-1 steps
ENC = dict(dim=32, ffn_dim=64, heads=4, layers=2, conv_kernel=7)   # test_tensor_parallel.py


def _batch(seed, accum=2, b=4, t=6, size=24):
    """Ragged micro-batches of 4 rows in the (accum, B, ...) layout, one
    all-masked dummy row."""
    rng = np.random.default_rng(seed)
    lens = np.array([[t, t - 2, t - 1, t - 3], [t - 1, t, 0, t - 2]])[:accum]
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


def _stage1_batches():
    return [_batch(seed) for seed in (20, 21, 22)]


def _jax_stage1():
    """The JAX half: the starting variables, and per mesh the logs of three
    steps and the final variables, as numpy."""
    jc = _cfg(jcfg, adam_eps=1e-3, batch_size=4)
    batches = _stage1_batches()
    micro0 = {k: v[0] for k, v in batches[0].items()}
    _, _, jstate = jstage1.create_train_state(jc, jax.random.PRNGKey(0), micro0)
    out = {"start": {"params": _np_tree(jstate.params),
                     "batch_stats": _np_tree(jstate.batch_stats)}}
    for name, (data, model) in MESHES.items():
        mesh = jax_mesh(data=data, model=model, devices=jax.devices()[: data * model])
        jmodel, tx, jstate = jstage1.create_train_state(jc, jax.random.PRNGKey(0), micro0,
                                                        mesh=mesh)
        jstep = jstage1.make_train_step(jmodel, tx, jc, mesh)
        logs = []
        for i, batch in enumerate(batches):
            jstate, lg = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.PRNGKey(10 + i))
            logs.append({k: float(v) for k, v in lg.items()})
        out[name] = {"logs": logs, "final": {"params": _np_tree(jstate.params),
                                             "batch_stats": _np_tree(jstate.batch_stats)}}
    return out


def _jax_encoder():
    """tests/test_tensor_parallel.py's conformer, its input and its
    replicated forward."""
    enc = JaxEncoder(**ENC, dropout=0.0, attention_dropout=0.0, positional_dropout=0.0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 12, ENC["dim"]), dtype=np.float32)
    mask = np.ones((4, 12), bool)
    mask[1, 9:] = False
    variables = enc.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    ref, _ = jax.jit(lambda v, x, m: enc.apply(v, x, m, train=False))(variables, x, mask)
    sd = from_jax.jax_tree_to_state_dict(_np_tree(variables["params"]))
    sd.update(from_jax.jax_tree_to_state_dict(_np_tree(variables["batch_stats"])))
    return {"sd": sd, "x": x, "mask": mask, "ref": np.asarray(ref)}


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """Every rank scenario of the module in one 2-rank group, beside the JAX
    halves; each computed once per test run (run_once: under pytest-xdist
    the first worker to get here leaves it in the workers' common temporary
    directory)."""
    jref = run_once(tmp_path_factory, "parallel_stage1_jax", lambda shared: _jax_stage1())[1]
    enc = run_once(tmp_path_factory, "parallel_encoder_jax", lambda shared: _jax_encoder())[1]
    gan_batches = [gan_batch(10), gan_batch(11)]
    gref = _to_torch(run_once(tmp_path_factory, "stage2_jax_two_steps",
                              lambda shared: _jax_two_steps(gan_batches, shared))[1])
    tc = _cfg(tcfg, adam_eps=1e-3, batch_size=4)
    sd = from_jax.stage1_state_dict(jref["start"])
    jobs = [(name, ranks.stage1_steps, (tc, sd, _stage1_batches(), data, model))
            for name, (data, model) in MESHES.items()]
    jobs.append(("forward", ranks.tp_forward,
                 (dict(input_dim=ENC["dim"], **ENC), enc["sd"], enc["x"], enc["mask"], 2)))
    jobs.append(("gan", ranks.gan_steps, (gan_cfg(tcfg), gref["start"], gan_batches)))
    got = run_once(tmp_path_factory, "parallel_ranks",
                   lambda shared: ranks.spawn(ranks.run_all, 2, shared, jobs))[1]
    return {"jax": jref, "encoder": enc, "gan_jax": gref, "ranks": got, "start": sd}


# ------------------------------------------------------------------- stage 1

@pytest.mark.parametrize("mesh", list(MESHES))
def test_stage1_logs_match_the_jax_mesh_step(ranked, mesh):
    """The global logs of three steps on every rank: 1e-4 relative."""
    ref = ranked["jax"][mesh]["logs"]
    for r in ranked["ranks"]:
        for want, got in zip(ref, r[mesh]["logs"]):
            assert set(got) == set(want)
            assert got["sample_size"] == want["sample_size"] == 7.0   # one dummy row of 8
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_stage1_state_matches_the_jax_mesh_step(ranked, mesh):
    """Parameters after three AdamW updates (2e-5 absolute) and BatchNorm
    running statistics (1e-4) in the single-card layout, gathered from the
    ranks; the statistics moved."""
    final = from_jax.stage1_state_dict(ranked["jax"][mesh]["final"])
    got, start = ranked["ranks"][0][mesh]["model"], ranked["start"]
    assert set(got) == set(final)
    moved = 0
    for k, ref in final.items():
        assert got[k].shape == ref.shape, k
        stat = k.endswith(("running_mean", "running_var"))
        np.testing.assert_allclose(got[k].numpy(), ref.numpy(), atol=1e-4 if stat else 2e-5,
                                   err_msg=k)
        moved += int(not torch.equal(ref, start[k]))
    assert moved > 20


def test_stage1_ranks_split_rows_and_heads(ranked):
    """DP: rank r trains on rows [2r, 2r + 2) of each micro-batch. TP: each
    rank holds 1 of the 2 heads and half the FFN units, and the file
    save_stage1 writes from the gathered state reads back into each rank's
    part exactly."""
    batch = _stage1_batches()[0]
    for r, got in enumerate(ranked["ranks"]):
        np.testing.assert_array_equal(got["dp2"]["rows"], batch["spk_emb"][0, 2 * r: 2 * r + 2])
        np.testing.assert_array_equal(got["tp2"]["rows"], batch["spk_emb"][0])
        assert (got["dp2"]["heads"], got["tp2"]["heads"]) == (2, 1)
        assert got["dp2"]["split"] == []
        assert "conformer.layers_0.feed_forward.w_1.weight" in got["tp2"]["split"]
        assert "conformer.layers_0.self_attn.linear_pos.weight" not in got["tp2"]["split"]
        assert got["dp2"]["restored_equal"] and got["tp2"]["restored_equal"]


def test_tp_conformer_forward_matches_the_replicated_jax_forward(ranked):
    """4 heads and 64 FFN units split over 2 ranks: 1e-5 absolute, as the
    JAX package's GSPMD forward; the split weights are halves."""
    enc = ranked["encoder"]
    for r in ranked["ranks"]:
        got = r["forward"]
        np.testing.assert_allclose(got["out"], enc["ref"], atol=1e-5)
        assert got["shapes"]["layers_0.feed_forward.w_1.weight"] == (ENC["ffn_dim"] // 2, ENC["dim"])
        assert got["shapes"]["layers_0.self_attn.linear_out.weight"] == (ENC["dim"], ENC["dim"] // 2)
        assert got["shapes"]["layers_0.self_attn.pos_bias_u"] == (ENC["heads"] // 2, 8)
        assert got["shapes"]["layers_0.self_attn.linear_pos.weight"] == (ENC["dim"], ENC["dim"])


# ------------------------------------------------------------------- stage 2

def test_gan_step_logs_match_jax(ranked):
    """Both steps' global logs (rank means of equal shards): 1e-5 relative."""
    for r in ranked["ranks"]:
        for ref, got in zip(ranked["gan_jax"]["jlogs"], r["gan"]["logs"]):
            assert set(got) == set(ref)
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


def test_gan_step_gradients_and_state_match_jax(ranked):
    """The first step's averaged gradients by name (Adam's first moments;
    each tensor's error over its side's largest element: 2e-4 generator,
    1e-5 discriminators, as test_torch_train_stage2.py), the spectral u
    after two steps (1e-5), and the two ranks' parameters equal."""
    ref, got = ranked["gan_jax"]["grads"], ranked["ranks"][0]["gan"]["first_moments"]
    assert set(ref) == set(got)
    for side, tol in (("generator", 2e-4), ("disc", 1e-5)):
        names = [n for n in ref if n.startswith(("mpd.", "msd.")) == (side == "disc")]
        scale = max(float(ref[n].abs().max()) for n in names)
        for n in names:
            assert float((got[n] - ref[n]).abs().max()) <= tol * scale, n
    final = ranked["gan_jax"]["final"]["msd"]
    state0, state1 = (r["gan"]["state"] for r in ranked["ranks"])
    us = [k for k in state0["msd"] if k.endswith(".u")]
    assert len(us) == 8
    for k in us:
        np.testing.assert_allclose(state0["msd"][k].numpy(), final[k].numpy(), atol=1e-5,
                                   err_msg=k)
    for part in state0:
        for k, v in state0[part].items():
            assert torch.equal(v, state1[part][k]), (part, k)


# -------------------------------------------------------------------- serving

@functools.lru_cache(maxsize=1)
def _serving_batch():
    rng = np.random.default_rng(3)
    video = rng.standard_normal((3, 8, 88, 88, 1)).astype(np.float32)
    mask = np.arange(8)[None, :] < np.array([[8], [5], [7]])
    return video, mask, rng.standard_normal((3, 256)).astype(np.float32)


def test_data_parallel_serving_matches_the_jax_mesh_pipeline():
    """The tiny preset on two CPU replicas (3 rows: one zero, fully masked
    pad row) against the JAX pipeline on make_mesh(data=2): units equal,
    PCM16 within 1 step, f16 mels within 5e-3; the same call without the
    mesh gives the same."""
    s1, voc = tiny_weights(1)
    ref = JaxPipeline(jcfg.preset("tiny"), s1, voc, emit_int16=True,
                      mesh=jax_mesh(data=2, devices=jax.devices()[:2]))
    pipe = TorchPipeline.from_jax_variables(tcfg.preset("tiny"), s1, voc, emit_int16=True,
                                            device="cpu")
    single = pipe.synthesise_batch(*_serving_batch())
    pipe.set_mesh(make_mesh(devices=["cpu", "cpu"]))
    try:
        got = pipe.synthesise_batch(*_serving_batch())
    finally:
        pipe.set_mesh(None)
    want = ref.synthesise_batch(*_serving_batch())
    assert len(got) == len(want) == 3 and pipe.mesh is None
    for g, r, s, n in zip(got, want, single, (8, 5, 7)):
        assert g.wav.shape == r.wav.shape == (640 * n,)
        np.testing.assert_array_equal(g.units, r.units)
        np.testing.assert_array_equal(g.units, s.units)
        for other in (r, s):
            assert np.abs(g.wav.astype(np.int32) - other.wav.astype(np.int32)).max() <= 1
            np.testing.assert_allclose(g.mel.astype(np.float32), other.mel.astype(np.float32),
                                       atol=5e-3)
