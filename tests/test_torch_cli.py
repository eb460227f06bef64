"""The port's command-line tools and file entry point on the CPU at the
`tiny` preset: train_stage1 (with --resume) -> infer -> train_stage2 (with
--resume) -> vocode through their mains with --device cpu, and the JAX
package's run_inference, run_vocoder and synthesise_file against the port's
from carried weights: mels and waveforms within 1e-4, units and WER equal,
the same artifact files."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lip2speech_tpu.cli import infer as jinfer
from lip2speech_tpu.cli import vocode as jvocode
from lip2speech_tpu.core import config as jcfg
from lip2speech_tpu.pipeline.synthesise import Lip2SpeechPipeline as JaxPipeline
from lip2speech_tpu_torch.cli import infer, train_stage1, train_stage2, vocode
from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.core import config as tcfg
from lip2speech_tpu_torch.data.manifest import (
    Utterance,
    write_manifest,
    write_unit_dictionary,
    write_units,
)
from lip2speech_tpu_torch.data.video_io import save_video_gray
from lip2speech_tpu_torch.pipeline.synthesise import Lip2SpeechPipeline
from lip2speech_tpu_torch.train import checkpoint as ckpt
from lip2speech_tpu_torch.utils.audio_io import read_wav, write_wav
from lip2speech_tpu_torch.utils.metrics_log import read_scalars

from test_torch_modules import _perturb
from torch_tmp import tmp_path  # noqa: F401  (removed when the test passes)

LENS = (12, 17, 20, 26)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """4 clips (96x96 uint8 .npy video, 16 kHz wav, speaker embedding, 4
    mel frames and 2 units a video frame) under one root, with the manifest
    of all four and one of the first two."""
    root = tmp_path_factory.mktemp("cli_data")
    rng = np.random.default_rng(0)
    utts, rows = [], []
    for i, n in enumerate(LENS):
        uid = f"spk{i % 2}/clip{i}"
        save_video_gray(root / "video" / f"{uid}.mp4",
                        rng.integers(0, 256, (n, 96, 96), dtype=np.uint8))
        t = np.arange(n * 640) / 16_000
        write_wav(root / "audio" / f"{uid}.wav",
                  0.4 * np.sin(2 * np.pi * (150 + 40 * i) * t) + 0.02 * rng.standard_normal(t.size),
                  16_000)
        for sub, arr in (("spk_emb", rng.standard_normal(256)),
                         ("mel", rng.standard_normal((4 * n, 80)))):
            (root / sub / f"spk{i % 2}").mkdir(parents=True, exist_ok=True)
            np.save(root / sub / f"{uid}.npy", arr.astype(np.float32))
        utts.append(Utterance(uid, root / "video" / f"{uid}.mp4", root / "audio" / f"{uid}.wav",
                              n, n * 640))
        rows.append(rng.integers(0, 200, 2 * n))
    label = root / "label"
    write_manifest(label / "all.tsv", root, utts)
    write_units(label / "all.unt", rows)
    write_manifest(label / "two.tsv", root, utts[:2])
    write_units(label / "two.unt", rows[:2])
    write_unit_dictionary(label / "dict.unt.txt")
    return label


def _files(root: Path) -> set[str]:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


def test_cli_chain_on_the_cpu(dataset, tmp_path, capsys):
    """train_stage1 (2 updates with validation, then --resume to 3) -> infer
    from s1_3 -> train_stage2 (1 epoch with validation, then --resume for a
    second) -> vocode from the last g_: the reference's files and names,
    resume from the newest, the best checkpoint by validation accuracy, the
    validation snapshots."""
    tsv, unt = str(dataset / "all.tsv"), str(dataset / "all.unt")
    valid = ["--valid-tsv", str(dataset / "two.tsv"), "--valid-unt", str(dataset / "two.unt")]
    s1_dir = tmp_path / "s1"
    s1_args = ["--preset", "tiny", "--train-tsv", tsv, "--train-unt", unt, "--device", "cpu",
               "--checkpoint-dir", str(s1_dir), "--batch-size", "2", "--update-freq", "1",
               "--save-interval", "2", "--log-interval", "1"]
    state = train_stage1.main(s1_args + ["--max-updates", "2"] + valid)
    assert state.step == 2 and state.device == torch.device("cpu")
    best = json.loads((s1_dir / "best.json").read_text())
    assert (best["metric"], best["update"]) == ("valid_accuracy", 2)
    state = train_stage1.main(s1_args + ["--max-updates", "3", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from update 2" in out and "done: 3 updates" in out
    assert state.step == 3
    assert {"s1_00000000.pt", "s1_00000002.pt", "s1_00000003.pt", "best.json",
            "logs/scalars.jsonl"} == _files(s1_dir)

    results = tmp_path / "infer"
    stats = infer.main(["--preset", "tiny", "--checkpoint", str(s1_dir / "s1_00000003.pt"),
                        "--tsv", tsv, "--unt", unt, "--results-path", str(results),
                        "--batch-size", "2", "--device", "cpu"])
    assert stats["n_utts"] == 4 and stats["n_failed"] == 0
    files = _files(results)
    uids = [f"spk{i % 2}/clip{i}" for i in range(4)]
    assert {f"pred_mel/{u}.npy" for u in uids} | {f"pred_unit/{u}.txt" for u in uids} <= files
    assert len([f for f in files if f.startswith(("hypo-", "wer."))]) == 2 and len(files) == 10
    for i, uid in enumerate(uids):
        assert np.load(results / "pred_mel" / f"{uid}.npy").shape == (4 * LENS[i], 80)
        assert len((results / "pred_unit" / f"{uid}.txt").read_text().split()) == 2 * LENS[i]

    s2_dir = tmp_path / "s2"
    s2_args = ["--preset", "tiny", "--train-tsv", str(dataset / "two.tsv"), "--train-unt",
               str(dataset / "two.unt"), "--device", "cpu", "--checkpoint-dir", str(s2_dir),
               "--batch-size", "2", "--log-interval", "1"]
    gan = train_stage2.main(s2_args + ["--epochs", "1", "--validation-interval", "1"] + valid)
    assert (gan.step, gan.epoch) == (1, 1)
    gan = train_stage2.main(s2_args + ["--epochs", "2", "--resume"])
    assert "resumed from step 1, epoch 1" in capsys.readouterr().out
    assert (gan.step, gan.epoch) == (2, 2)
    files = _files(s2_dir)
    assert {"g_00000001", "do_00000001", "g_00000002", "do_00000002", "logs/scalars.jsonl",
            "logs/audio/val_pred_00000001.wav", "logs/mel/val_pred_spec_00000001.npy",
            "logs/mel/val_gt_spec_00000001.npy"} <= files
    assert all(f.startswith(("g_", "do_", "logs/")) for f in files)
    assert any(np.isfinite(r.get("val_mel_l1", np.nan)) for r in read_scalars(s2_dir / "logs"))

    voc = tmp_path / "voc"
    stats = vocode.main(["--preset", "tiny", "--checkpoint", str(s2_dir / "g_00000002"),
                         "--tsv", tsv, "--unt", unt, "--out-dir", str(voc), "--device", "cpu"])
    assert stats["n_utts"] == 4 and stats["rtf"] > 0
    assert _files(voc) == {f"pred_wav/{u}.wav" for u in uids}
    wav, sr = read_wav(voc / "pred_wav" / f"{uids[0]}.wav")
    assert sr == 16_000 and wav.shape == (LENS[0] * 640,)


@pytest.fixture(scope="module")
def weights():
    """The tiny preset's weights, made by flax (BatchNorm statistics and
    weight-norm gains perturbed) and carried into the port."""
    jp = JaxPipeline.initialize_random(jcfg.preset("tiny"), seed=0, frames=4)
    s1 = _perturb(jp.stage1_variables, seed=1)
    voc = _perturb({"params": jp.vocoder_params}, seed=2)["params"]
    return {"jax": (s1, voc), "port": (from_jax.stage1_state_dict(s1),
                                       from_jax.vocoder_state_dict(voc))}


def test_run_inference_matches_jax(dataset, weights, tmp_path):
    tsv, unt = dataset / "all.tsv", dataset / "all.unt"
    ref = jinfer.run_inference(jcfg.preset("tiny"), weights["jax"][0], tsv, unt,
                               tmp_path / "jax", batch_size=2)
    got = infer.run_inference(tcfg.preset("tiny"), weights["port"][0], tsv, unt,
                              tmp_path / "port", batch_size=2, device="cpu")
    for k in ("wer", "accuracy", "n_utts", "n_failed"):
        assert got[k] == ref[k], k
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for f in _files(tmp_path / "jax"):
        if f.endswith(".npy"):
            np.testing.assert_allclose(np.load(tmp_path / "port" / f),
                                       np.load(tmp_path / "jax" / f), atol=1e-4, err_msg=f)
        else:
            assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text(), f


def test_run_vocoder_matches_jax(dataset, weights, tmp_path):
    tsv, unt = dataset / "two.tsv", dataset / "two.unt"
    ref = jvocode.run_vocoder(jcfg.preset("tiny"), weights["jax"][1], tsv, unt, tmp_path / "jax")
    got = vocode.run_vocoder(tcfg.preset("tiny"), weights["port"][1], tsv, unt,
                             tmp_path / "port", device="cpu", keep_wavs=True)
    assert (got["n_utts"], got["audio_s"]) == (ref["n_utts"], ref["audio_s"])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert {f"pred_wav/{u}.wav" for u in got["wavs"]} == _files(tmp_path / "port")
    for f in _files(tmp_path / "jax"):
        written = read_wav(tmp_path / "port" / f)[0]
        np.testing.assert_allclose(written, read_wav(tmp_path / "jax" / f)[0], atol=1e-4,
                                   err_msg=f)
        kept = got["wavs"][f[len("pred_wav/"):-len(".wav")]]      # before PCM16
        assert kept.dtype == np.float32 and kept.shape == written.shape
        np.testing.assert_allclose(written, kept, atol=1 / 32768, err_msg=f)


def test_synthesise_file_matches_jax(dataset, weights):
    video = dataset.parent / "video" / "spk1" / "clip1.mp4"
    spk = np.load(dataset.parent / "spk_emb" / "spk1" / "clip1.npy")
    ref = JaxPipeline(jcfg.preset("tiny"), *weights["jax"]).synthesise_file(video, spk)
    got = Lip2SpeechPipeline(tcfg.preset("tiny"), *weights["port"],
                             device="cpu").synthesise_file(video, spk)
    n = LENS[1]
    assert got.wav.shape == (640 * n,) and got.units.shape == (2 * n,)
    np.testing.assert_array_equal(got.units, np.asarray(ref.units))
    np.testing.assert_allclose(got.mel, np.asarray(ref.mel), atol=1e-4)
    np.testing.assert_allclose(got.wav, np.asarray(ref.wav), atol=1e-4)


def test_clis_without_a_card_raise_unless_cpu_requested(dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tsv, unt = str(dataset / "two.tsv"), str(dataset / "two.unt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_stage1.main(["--preset", "tiny", "--train-tsv", tsv, "--train-unt", unt,
                           "--checkpoint-dir", str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_stage2.main(["--preset", "tiny", "--train-tsv", tsv, "--train-unt", unt,
                           "--checkpoint-dir", str(tmp_path / "b")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.run_inference(tcfg.preset("tiny"), {}, tsv, unt, tmp_path / "c")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vocode.run_vocoder(tcfg.preset("tiny"), {}, tsv, unt, tmp_path / "d")
    assert ckpt.scan_checkpoints(tmp_path / "a", "s1_") is None
