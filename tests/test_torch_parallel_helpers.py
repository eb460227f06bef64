"""The port's parallel helpers against the JAX package's (parallel/mesh.py,
multihost.py, sharding_rules.py) on the CPU, the training CLI over two ranks
under a launcher's environment, and the ways a parallel run must fail.

Meshes of CPU devices stand in for cards here; meshes of ranks come from
tests/torch_parallel_ranks.py (gloo, spawned)."""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
from jax.sharding import PartitionSpec as JP

from lip2speech_tpu.core import config as jcfg
from lip2speech_tpu.models.multi_target import MultiTargetModel as JaxModel
from lip2speech_tpu.parallel import mesh as jmesh
from lip2speech_tpu.parallel import sharding_rules as jrules
from lip2speech_tpu_torch.cli import infer, train_stage1
from lip2speech_tpu_torch.core import config as tcfg
from lip2speech_tpu_torch.data.stage1 import Stage1Dataset
from lip2speech_tpu_torch.models.conformer import ConformerEncoder
from lip2speech_tpu_torch.models.multi_target import MultiTargetModel
from lip2speech_tpu_torch.parallel import mesh as tmesh
from lip2speech_tpu_torch.parallel import multihost
from lip2speech_tpu_torch.parallel import sharding_rules as trules
from lip2speech_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, P
from lip2speech_tpu_torch.train import checkpoint as ckpt
from lip2speech_tpu_torch.train import stage1

import torch_parallel_ranks as ranks
from test_torch_cli import _files, dataset  # noqa: F401  (the fixture)
from test_torch_train_stage1 import _cfg
from torch_tmp import tmp_path  # noqa: F401  (removed when the test passes)


def _cpus(n):
    return ["cpu"] * n


# ---------------------------------------------------------------------- mesh

@pytest.mark.parametrize("batch,n,model", [(8, 8, 1), (6, 8, 1), (7, 8, 1), (3, 8, 2),
                                           (12, 8, 2), (1, 8, 1), (5, 4, 1), (16, 8, 4)])
def test_fitting_mesh_matches_jax(batch, n, model):
    ref = jmesh.fitting_mesh(batch, model=model, devices=jax.devices()[:n])
    got = tmesh.fitting_mesh(batch, model=model, devices=_cpus(n))
    assert dict(got.shape) == dict(ref.shape)
    assert got.devices.shape == ref.devices.shape and not got.distributed


@pytest.mark.parametrize("data,model,n", [(-1, 1, 8), (-1, 2, 8), (2, 2, 8), (3, 1, 4)])
def test_make_mesh_shapes_and_errors_match_jax(data, model, n):
    ref = jmesh.make_mesh(data=data, model=model, devices=jax.devices()[:n])
    got = tmesh.make_mesh(data=data, model=model, devices=_cpus(n))
    assert dict(got.shape) == dict(ref.shape) == {DATA_AXIS: ref.shape[DATA_AXIS],
                                                  MODEL_AXIS: model}
    for bad in ({"model": 0}, {"model": 3}, {"data": n, "model": 2}):
        with pytest.raises(ValueError):
            jmesh.make_mesh(devices=jax.devices()[:n], **bad)
        with pytest.raises(ValueError):
            tmesh.make_mesh(devices=_cpus(n), **bad)


def test_a_mesh_of_ranks_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(devices=[0, 1])


@pytest.mark.parametrize("multiple", [1, 3, 4])
def test_pad_batch_to_multiple_matches_jax(multiple):
    rng = np.random.default_rng(0)
    tree = {"video": rng.standard_normal((5, 3, 2)).astype(np.float32),
            "mask": rng.random((5, 3)) > 0.5}
    ref, ref_n = jmesh.pad_batch_to_multiple(tree, multiple)
    got, got_n = tmesh.pad_batch_to_multiple(tree, multiple)
    assert got_n == ref_n == 5
    for k in tree:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
    as_torch, _ = tmesh.pad_batch_to_multiple({k: torch.as_tensor(v) for k, v in tree.items()},
                                              multiple)
    for k in tree:
        np.testing.assert_array_equal(as_torch[k].numpy(), np.asarray(ref[k]))


def test_shard_batch_takes_contiguous_rows_and_refuses_a_batch_that_does_not_divide():
    mesh = tmesh.make_mesh(devices=_cpus(2))
    batch = {"x": np.arange(12).reshape(2, 6), "ids": list("abcdef")}
    assert tmesh.shard_batch(mesh, batch, axis=1, index=1)["x"].tolist() == [[3, 4, 5],
                                                                             [9, 10, 11]]
    assert tmesh.shard_batch(mesh, {"ids": list("abcd")}, index=1)["ids"] == ["c", "d"]
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_batch(mesh, {"x": np.zeros((3, 2))})
    assert tmesh.batch_sharding(mesh).spec == P(DATA_AXIS) and tmesh.replicated(mesh).spec == P()
    assert tmesh.active_mesh() is None
    with tmesh.use_mesh(mesh):
        assert tmesh.active_mesh() is mesh
    assert tmesh.active_mesh() is None


# ------------------------------------------------------------ sharding rules

@pytest.fixture(scope="module")
def flagship_params():
    """The JAX and port parameters of a tiny multi_target with the AV-HuBERT
    frontend (conformer and wav2vec2 blocks both): JAX's abstract, the
    port's unfilled."""
    jc, tc = _cfg(jcfg, "avhubert"), _cfg(tcfg, "avhubert")
    k = jax.random.PRNGKey(0)
    abstract = jax.eval_shape(lambda: JaxModel(jc.model).init(
        {"params": k, "dropout": k}, jax.numpy.zeros((1, 4, 24, 24, 1)),
        jax.numpy.ones((1, 4), bool), jax.numpy.zeros((1, 256)), train=False))
    return abstract["params"], MultiTargetModel(tc.model)


def _jax_specs_by_name(params) -> dict:
    specs = jrules.param_specs(params)
    out = {}

    def walk(node, spec, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, spec[key], prefix + (key,))
            else:
                out[".".join(prefix + (key,))] = spec[key]

    walk(params, specs, ())
    return out


def test_param_specs_are_the_jax_rules_in_the_port_layout(flagship_params):
    """Every JAX spec on the model axis is the port's, transposed for a
    Linear weight ((out, in) here, (in, out) there); the port adds the
    q/k/v biases and pos_bias_u/v, which GSPMD can leave whole and a local
    matmul cannot; the rest is replicated in both."""
    jparams, model = flagship_params
    ref = _jax_specs_by_name(jparams)
    got = trules.param_specs(model)
    assert set(got) == set(ref)
    added = 0
    for name, spec in got.items():
        want = tuple(reversed(ref[name])) if len(ref[name]) == 2 else tuple(ref[name])
        if MODEL_AXIS in (ref[name] or ()):
            assert tuple(spec) == want, name
        elif MODEL_AXIS in spec:
            added += 1
            assert name.endswith(("_proj.bias", "linear_q.bias", "linear_k.bias",
                                  "linear_v.bias", "pos_bias_u", "pos_bias_v")), name
        else:
            assert spec == P(), name
    assert added == 2 * 5 + 2 * 3       # (q/k/v biases, pos_bias_u/v) x 2 conformer layers,
                                        # q/k/v biases x 2 wav2vec2 layers
    assert ref["conformer.layers_0.feed_forward.w_1.weight"] == JP(None, MODEL_AXIS)
    assert got["conformer.layers_0.feed_forward.w_1.weight"] == P(MODEL_AXIS, None)


def test_param_shardings_split_whole_blocks_only(flagship_params):
    """On a model axis of 2 every conformer and wav2vec2 block splits; the
    unit head's fc1, which matches a rule outside a block the port can
    split, stays replicated (GSPMD splits it)."""
    _, model = flagship_params
    shard = trules.param_shardings(model, tmesh.make_mesh(data=1, model=2, devices=_cpus(2)))
    specs = trules.param_specs(model)
    split = {n for n, s in shard.items() if s.spec != P()}
    assert split == {n for n, s in specs.items() if MODEL_AXIS in s} - {
        n for n in specs if n.startswith("unit_head.fc1")}
    one = trules.param_shardings(model, tmesh.make_mesh(data=2, model=1, devices=_cpus(2)))
    assert all(s.spec == P() for s in one.values())


def test_tp_fallback_on_indivisible_dims():
    """ffn=10 and 2 heads on a model axis of 4: both blocks stay replicated
    whole (tests/test_tensor_parallel.py::test_tp_fallback_on_indivisible_dims);
    on an axis of 2 both split."""
    enc = ConformerEncoder(8, 8, 10, 2, 1, 3)
    four = trules.param_shardings(enc, tmesh.make_mesh(data=2, model=4, devices=_cpus(8)))
    assert all(s.spec == P() for s in four.values())
    two = trules.param_shardings(enc, tmesh.make_mesh(data=4, model=2, devices=_cpus(8)))
    assert two["layers_0.feed_forward.w_1.weight"].spec == P(MODEL_AXIS, None)
    assert two["layers_0.self_attn.linear_out.weight"].spec == P(None, MODEL_AXIS)


# ----------------------------------------------------------------- multihost

def test_process_shard_and_batch_size_single_process():
    assert multihost.process_shard(10) == slice(0, 10)
    assert multihost.process_shard(0) == slice(0, 0)
    assert multihost.host_local_batch_size(8) == 8


def _patch_topology(monkeypatch, count, index):
    monkeypatch.setattr(multihost, "process_count", lambda: count)
    monkeypatch.setattr(multihost, "process_index", lambda: index)


def test_process_shard_multi_process(monkeypatch):
    shards = []
    for rank in range(4):
        _patch_topology(monkeypatch, 4, rank)
        shards.append(multihost.process_shard(10))
    assert shards == [slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 10)]
    _patch_topology(monkeypatch, 8, 7)
    s = multihost.process_shard(3)
    assert s.start >= s.stop or s.stop <= 3
    _patch_topology(monkeypatch, 4, 1)
    assert multihost.host_local_batch_size(32) == 8
    with pytest.raises(ValueError, match="not divisible"):
        multihost.host_local_batch_size(30)


def _fake_init(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    return calls


def test_initialize_env_plumbing(monkeypatch):
    """The JAX names, torchrun's, explicit arguments over the environment,
    and a group of one without either; gloo on the CPU."""
    calls = _fake_init(monkeypatch)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "2")
    info = multihost.initialize(device="cpu")
    assert calls[-1] == ("gloo", {"init_method": "tcp://10.0.0.1:1234", "rank": 2,
                                  "world_size": 4})
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                    "global_devices": 1}
    multihost.initialize(coordinator_address="host:2", num_processes=2, process_id=1,
                         device="cpu", timeout=5)
    assert calls[-1][1]["init_method"] == "tcp://host:2" and calls[-1][1]["rank"] == 1
    assert calls[-1][1]["timeout"].total_seconds() == 5
    calls = _fake_init(monkeypatch)
    for k, v in dict(RANK="1", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT="9").items():
        monkeypatch.setenv(k, v)
    assert multihost.launcher_environment()
    multihost.initialize(device="cpu")
    assert calls[-1] == ("gloo", {"init_method": "env://", "rank": 1, "world_size": 2})
    calls = _fake_init(monkeypatch)
    assert not multihost.launcher_environment()
    multihost.initialize(device="cpu")
    assert calls[-1][1]["world_size"] == 1 and "store" in calls[-1][1]


# ------------------------------------------------------------------------ CLI

def test_train_stage1_over_two_ranks_writes_one_file_for_one_card(dataset, tmp_path):
    """train_stage1 started as two ranks under torchrun's environment with
    --device cpu: the ranks together train on the single-process stream's
    update (rank r on rows [r, r + 1) of each micro-batch of 2); rank 0
    alone writes the files a single-process run writes; the 1-card infer
    reads the update's file and a 1-card state restores it as --resume does."""
    tsv, unt = str(dataset / "all.tsv"), str(dataset / "all.unt")
    two = tmp_path / "two"
    args = ["--preset", "tiny", "--train-tsv", tsv, "--train-unt", unt, "--device", "cpu",
            "--batch-size", "2", "--update-freq", "2", "--save-interval", "1",
            "--checkpoint-dir", str(two), "--max-updates", "1"]
    got = ranks.spawn(ranks.cli_train_stage1, 2, tmp_path / "ranks", args, launcher=True)
    assert [(g["step"], g["mesh"]) for g in got] == [(1, {DATA_AXIS: 2, MODEL_AXIS: 1})] * 2
    cfg = tcfg.with_overrides(tcfg.preset("tiny"), {"stage1.batch_size": 2,
                                                    "stage1.update_freq": 2})
    ds = Stage1Dataset(tsv, unt, train=True, random_erase=True, time_mask=True, seed=1337)
    whole = next(train_stage1.accum_stream(ds, cfg.stage1, cfg.model.units.pad))
    for k in ("spk_emb", "video"):
        assert len(got[0]["rows"]) == 1 and got[0]["rows"][0][k].shape[:2] == (2, 1)
        np.testing.assert_array_equal(
            np.concatenate([got[0]["rows"][0][k], got[1]["rows"][0][k]], axis=1), whole[k])
    assert _files(two) == {"s1_00000000.pt", "s1_00000001.pt", "best.json", "logs/scalars.jsonl"}
    stats = infer.main(["--preset", "tiny", "--checkpoint", str(two / "s1_00000001.pt"),
                        "--tsv", tsv, "--unt", unt, "--results-path", str(tmp_path / "infer"),
                        "--batch-size", "2", "--device", "cpu"])
    assert stats["n_utts"] == 4 and stats["n_failed"] == 0
    state, update = ckpt.restore_stage1(two, stage1.create_train_state(cfg, seed=1337,
                                                                        device="cpu"))
    assert update == state.step == 1 and state.mesh is None


# ------------------------------------------------------------------- failures

def test_a_world_the_batch_does_not_fit_fails_every_rank(tmp_path):
    """Two ranks and a batch of 3: fitting_mesh takes one rank, so the run
    raises on both, and spawn raises."""
    with pytest.raises(mp.ProcessRaisedException, match="fits a data axis of 1"):
        ranks.spawn(ranks.unfitting_world, 2, tmp_path, 3)


def test_a_collective_that_times_out_fails_the_run(tmp_path):
    """Rank 0 waits on an all-reduce rank 1 never joins: the group's 3 s
    timeout raises on rank 0, and spawn raises."""
    with pytest.raises(mp.ProcessRaisedException):
        ranks.spawn(ranks.stalled_collective, 2, tmp_path, 3.0)


def test_the_train_steps_take_a_mesh_of_ranks_only():
    """A mesh of local devices is for serving: the train steps refuse it."""
    from lip2speech_tpu_torch.train import stage2

    mesh = tmesh.make_mesh(devices=_cpus(2))
    for make in (stage1.make_train_step, stage2.make_gan_step):
        with pytest.raises(ValueError, match="a mesh of ranks"):
            make(_cfg(tcfg), mesh)
