"""The port's dataset CLI (lip2speech_tpu_torch/cli/create_dataset.py)
against the JAX package's, through both CLIs on the same raw clips (the
recipe of tests/test_create_dataset_full.py: 240 x 320 frames with a bright
mouth patch, 68-point landmarks, sine wavs): `init` with landmarks and a
GE2E encoder (a numpy-drawn tree saved by the JAX package as an orbax
directory; the port reads it through the `speaker` kind of
scripts/orbax_to_torch.py), then `manifests`, `vocoder` and `combine`,
compared file by file: the crops, wavs, manifests and unit rows equal, the
mels within 1e-4 of max |ref|, the d-vectors within 1e-5. Also the
encoder's other forms (`random`, an RTVC .pt, an orbax directory refused)
and the card as the default device."""

import filecmp
import importlib.util
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

from lip2speech_tpu.cli import create_dataset as jcds
from lip2speech_tpu.pipeline import mouth_crop as jmc
from lip2speech_tpu.train.checkpoint import save_pytree
from lip2speech_tpu_torch.cli import create_dataset as tcds
from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.models import speaker as tspeaker
from lip2speech_tpu_torch.train import checkpoint as ckpt
from lip2speech_tpu_torch.utils.audio_io import write_wav

from test_torch_speaker_denoise import speaker_params
from torch_tmp import tmp_path  # noqa: F401  (removed when the test passes)

REPO = pathlib.Path(__file__).resolve().parent.parent
MEL_TOL = 1e-4          # of max |ref|
SPK_TOL = 1e-5          # absolute, unit-norm d-vectors


def _orbax_to_torch():
    spec = importlib.util.spec_from_file_location("orbax_to_torch",
                                                  REPO / "scripts" / "orbax_to_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax(argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["create_dataset", *argv])
        jcds.main()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Three raw clips (the last without a landmark-free path: all three
    have landmarks), `init` through both CLIs with --workers 2, the port on
    the CPU with the JAX encoder converted by the `speaker` kind."""
    tmp = tmp_path_factory.mktemp("create_dataset")
    mean_face = jmc.default_mean_face()
    rng = np.random.default_rng(11)
    videos, audios, lms_files = [], [], []
    for c in range(3):
        t, h, w = 12 + 4 * c, 240, 320
        frames = rng.integers(0, 40, (t, h, w), dtype=np.uint8)
        lms = []
        for i in range(t):
            lm = mean_face * 0.9 + np.array([70 + c * 5 + i, 40])
            mx, my = (int(v) for v in lm[48:68].mean(axis=0))
            frames[i, my - 3: my + 4, mx - 3: mx + 4] = 255
            lms.append(lm)
        np.save(tmp / f"c{c}.npy", frames)
        np.save(tmp / f"c{c}.lms.npy", np.stack(lms))
        sig = 0.3 * np.sin(2 * np.pi * (180 + 40 * c) * np.arange(t * 640) / 16000)
        write_wav(tmp / f"c{c}.wav", sig + 0.01 * rng.standard_normal(sig.size), 16000)
        videos.append(str(tmp / f"c{c}.npy"))
        audios.append(str(tmp / f"c{c}.wav"))
        lms_files.append(str(tmp / f"c{c}.lms.npy"))
    params = speaker_params(7)
    save_pytree(tmp / "ge2e_orbax", params)
    _orbax_to_torch().main(["--input", str(tmp / "ge2e_orbax"), "--output", str(tmp / "ge2e.pt")])
    common = ["init", "--videos", *videos, "--audios", *audios, "--landmarks", *lms_files,
              "--workers", "2", "--split", "test"]
    _run_jax(common + ["--speaker-encoder", str(tmp / "ge2e_orbax"),
                       "--out-root", str(tmp / "jax")])
    utts = tcds.main(common + ["--speaker-encoder", str(tmp / "ge2e.pt"), "--device", "cpu",
                               "--out-root", str(tmp / "port")])
    return {"tmp": tmp, "jax": tmp / "jax", "port": tmp / "port", "utts": utts,
            "params": params, "videos": videos, "audios": audios}


def _files(root: pathlib.Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _label_text(path: pathlib.Path, root: pathlib.Path) -> str:
    """A label file with its root line (a .tsv's first) written as ROOT."""
    return path.read_text().replace(str(root), "ROOT")


def assert_trees_match(got: pathlib.Path, ref: pathlib.Path):
    """Equal file lists; .npy arrays equal (mel and spk_emb within tolerance),
    every other file equal byte for byte (label files up to their root)."""
    assert _files(got) == _files(ref)
    for rel in _files(ref):
        g, r = got / rel, ref / rel
        if rel.startswith("mel/"):
            a, b = np.load(g), np.load(r)
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32, rel
            assert np.abs(a - b).max() <= MEL_TOL * np.abs(b).max(), rel
        elif rel.startswith("spk_emb/"):
            np.testing.assert_allclose(np.load(g), np.load(r), atol=SPK_TOL, err_msg=rel)
        elif rel.startswith("label/"):
            assert _label_text(g, got) == _label_text(r, ref), rel
        else:
            assert filecmp.cmp(g, r, shallow=False), rel


def test_init_matches_jax_file_by_file(trees):
    """Mouth crops (96 x 96, equal frames), the copied wavs, mels, GE2E
    d-vectors (non-zero, unit norm, distinct), .tsv / .unt / dict."""
    assert_trees_match(trees["port"], trees["jax"])
    e = [np.load(trees["port"] / f"spk_emb/test/clip/{i:05d}.npy") for i in range(3)]
    assert all(abs(np.linalg.norm(x) - 1) < 1e-3 for x in e) and not np.allclose(e[0], e[1])
    crop = np.load(trees["port"] / "video/test/clip/00000.npy")
    assert crop.shape == (12, 96, 96)
    assert [u.n_frames for u in trees["utts"]] == [12, 16, 20]


def test_manifests_matches_jax(trees, tmp_path, capsys):
    """`manifests` rebuilds label/test.tsv (and keeps the .unt) from the
    tree alone; a stale .unt is replaced by placeholders."""
    roots = {}
    for side in ("jax", "port"):
        roots[side] = tmp_path / side
        shutil.copytree(trees[side], roots[side])
        (roots[side] / "label" / "test.tsv").unlink()
    _run_jax(["manifests", "--root", str(roots["jax"]), "--split", "test"])
    utts = tcds.main(["manifests", "--root", str(roots["port"]), "--split", "test"])
    assert capsys.readouterr().out.count("wrote manifests for 3 utterances") == 2
    assert len(utts) == 3
    assert_trees_match(roots["port"], roots["jax"])
    for side in roots.values():
        (side / "label" / "test.unt").write_text("1 2\n")
    _run_jax(["manifests", "--root", str(roots["jax"]), "--split", "test"])
    tcds.main(["manifests", "--root", str(roots["port"]), "--split", "test"])
    assert_trees_match(roots["port"], roots["jax"])


def test_vocoder_matches_jax(trees, tmp_path):
    """`vocoder` from stage-1 predictions (pred_mel / pred_unit of two of the
    three clips): the same stage-2 tree."""
    synth = tmp_path / "synth"
    rng = np.random.default_rng(5)
    for i in (0, 2):
        uid = f"test/clip/{i:05d}"
        (synth / "pred_mel" / "test/clip").mkdir(parents=True, exist_ok=True)
        (synth / "pred_unit" / "test/clip").mkdir(parents=True, exist_ok=True)
        np.save(synth / "pred_mel" / f"{uid}.npy", rng.standard_normal((48, 80)).astype(np.float32))
        (synth / "pred_unit" / f"{uid}.txt").write_text(
            " ".join(str(x) for x in rng.integers(0, 200, 24)))
    for side in ("jax", "port"):
        argv = ["vocoder", "--dataset-root", str(trees[side]), "--synthesis-dir", str(synth),
                "--out-root", str(tmp_path / f"voc_{side}")]
        _run_jax(argv) if side == "jax" else tcds.main(argv)
    assert_trees_match(tmp_path / "voc_port", tmp_path / "voc_jax")
    assert len(_files(tmp_path / "voc_port" / "mel")) == 2


def test_combine_matches_jax(trees, tmp_path):
    """`combine` of the init tree with itself: the same links (to the same
    files) under the new ids and the same manifests."""
    for side in ("jax", "port"):
        argv = ["combine", "--roots", str(trees["port"]), str(trees["port"]),
                "--out-root", str(tmp_path / f"comb_{side}"), "--split", "test"]
        _run_jax(argv) if side == "jax" else tcds.main(argv)
    got, ref = tmp_path / "comb_port", tmp_path / "comb_jax"
    assert _files(got) == _files(ref) and len(_files(got)) > 20
    for rel in _files(ref):
        if not rel.startswith("label/"):
            assert (got / rel).is_symlink() and (got / rel).resolve() == (ref / rel).resolve()
    assert_trees_match(got, ref)


def test_dvectors_match_jax_from_carried_weights(trees):
    """The d-vectors of the clips' own audio with the GE2E weights carried
    across (from_jax.speaker_state_dict): within 1e-5 of the JAX
    embed_utterance, on the CPU."""
    from lip2speech_tpu.models import speaker as jspeaker
    from lip2speech_tpu.utils.audio_io import read_wav as jread_wav

    enc = tspeaker.SpeakerEncoder()
    enc.load_state_dict(from_jax.speaker_state_dict(trees["params"]))
    for a in trees["audios"]:
        wav, sr = jread_wav(a)
        np.testing.assert_allclose(tspeaker.embed_utterance(enc, wav, sr),
                                   jspeaker.embed_utterance(trees["params"], wav, sr), atol=SPK_TOL)


def test_speaker_encoder_forms(trees, tmp_path):
    """The `speaker` orbax kind writes {"speaker": speaker_state_dict};
    an RTVC .pt (a flat state_dict of nn.LSTM's names) loads through
    convert_rtvc_encoder; `random` is seeded (the same twice, and not the
    JAX package's jax.random draw: ROADMAP §3); an orbax directory is
    refused."""
    sd = from_jax.speaker_state_dict(trees["params"])
    port_file = ckpt.load(trees["tmp"] / "ge2e.pt")
    assert port_file["speaker"].keys() == sd.keys()
    for k in sd:
        assert torch.equal(port_file["speaker"][k], sd[k])
    torch.save(dict(sd, **{"similarity_weight": torch.ones(1)}), tmp_path / "encoder.pt")
    rtvc = tcds.load_speaker_encoder(str(tmp_path / "encoder.pt"), "cpu").state_dict()
    assert all(torch.equal(rtvc[k], sd[k]) for k in sd)
    a, b = (tcds.load_speaker_encoder("random", "cpu").state_dict() for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    bound = 1 / np.sqrt(tspeaker.EMBED_DIM)
    assert all(float(v.abs().max()) <= bound for v in a.values())
    with pytest.raises(ValueError, match="orbax_to_torch"):
        tcds.load_speaker_encoder(str(trees["tmp"] / "ge2e_orbax"), "cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only refusal")
def test_init_runs_on_the_card_unless_told(trees, tmp_path):
    """Without --device the mel and d-vectors go to the card: with no card,
    init raises rather than fall back to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcds.main(["init", "--videos", trees["videos"][0], "--audios", trees["audios"][0],
                   "--out-root", str(tmp_path / "x")])
