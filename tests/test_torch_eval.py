"""The port's host-side evaluation and text code (lip2speech_tpu_torch:
eval/metrics, eval/pesq_p862, eval/harness, data/text, decode/units, the
native C helpers) against the JAX package, and the native helpers against
their pure-Python oracles, on the CPU.

Tolerances: tokens and texts exactly equal; the metrics within 1e-9 of
max(1, |ref|) (the same numpy code in f64); beam_units' scores within 1e-4
of max(1, |ref|) (log-softmax in f32 by two frameworks).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lip2speech_tpu.data import text as jtext
from lip2speech_tpu.decode import units as junits
from lip2speech_tpu.eval import harness as jharness
from lip2speech_tpu.eval import metrics as jmetrics
from lip2speech_tpu.eval import pesq_p862 as jpesq
from lip2speech_tpu_torch import native
from lip2speech_tpu_torch.data import text as ttext
from lip2speech_tpu_torch.data.manifest import Utterance, write_manifest
from lip2speech_tpu_torch.decode import units as tunits
from lip2speech_tpu_torch.eval import harness as tharness
from lip2speech_tpu_torch.eval import metrics as tmetrics
from lip2speech_tpu_torch.eval import pesq_p862 as tpesq
from lip2speech_tpu_torch.utils.audio_io import write_wav

from test_torch_asr import run_once

FS = 16_000
METRIC_TOL = 1e-9
REFS = ["bin blue at f two now", "place red with x nine again", "Set it, now!", "lay green",
        "", "the quick brown fox"]
HYPS = ["bin blue at two now", "place bread with nine again please", "set it now", "",
        "lay", "the quack brown fix"]


def _speechlike(seconds, seed):
    """A modulated multi-tone with pauses."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * FS)) / FS
    phase = np.cumsum(2 * np.pi * (120.0 + 30.0 * np.sin(2 * np.pi * 1.7 * t)) / FS)
    x = sum(a * np.sin(h * phase + rng.uniform(0, np.pi))
            for h, a in [(1, 1.0), (2, 0.6), (3, 0.4), (5, 0.25)])
    x = x * np.clip(np.sin(2 * np.pi * 2.3 * t) + 0.4, 0.0, None)
    x[: FS // 5] = 0.0
    return 0.5 * x / np.max(np.abs(x))


def _pairs():
    """(clean, degraded) pairs: noise at 20 and 5 dB SNR, a gain and a shift."""
    out = []
    for i, (snr, gain, shift) in enumerate([(20, 1.0, 0), (5, 0.7, 0), (10, 1.0, 40)]):
        clean = _speechlike(1.6, i)
        noise = np.random.default_rng(10 + i).standard_normal(len(clean))
        noise *= np.sqrt(np.mean(clean ** 2) / np.mean(noise ** 2) / 10 ** (snr / 10))
        out.append((clean, np.roll(gain * clean + noise, shift)))
    return out


class FakeASR:
    """A readback stand-in: a text that depends on the waveform's length."""

    def run(self, wav):
        return HYPS[len(wav) % len(HYPS)]


def _write_synthesis(root):
    """A manifest of three ground-truth wavs and the predicted wavs beside
    them (one missing, one too short for STOI)."""
    utts, pred_dir = [], root / "pred"
    pred_dir.mkdir(parents=True, exist_ok=True)
    for i, (clean, degraded) in enumerate(_pairs() + [(_speechlike(0.3, 9), None)]):
        uid = f"spk0/utt{i}"
        write_wav(root / "audio" / f"{uid}.wav", clean, FS)
        if degraded is not None and i != 1:
            write_wav(pred_dir / f"utt{i}.wav", degraded, FS)
        elif degraded is None:
            write_wav(pred_dir / f"utt{i}.wav", clean, FS)
        utts.append(Utterance(uid, root / "video" / f"{uid}.mp4", root / "audio" / f"{uid}.wav",
                              len(clean) // 640, len(clean)))
    write_manifest(root / "label" / "test.tsv", root, utts)
    (root / "gt.csv").write_text("Video Name,Phrase\n" + "".join(
        f"{u.uid},{REFS[i]}\n" for i, u in enumerate(utts)))
    return pred_dir, root / "label" / "test.tsv", root / "gt.csv"


def _jax_metrics(shared):
    pairs = _pairs()
    pred_dir, tsv, csv = _write_synthesis(shared)
    gt = jharness.load_groundtruth_csv(csv)
    res = jharness.evaluate_synthesis(pred_dir, tsv, groundtruth_text=gt, asr=FakeASR())
    return {"stoi": [jmetrics.stoi(c, d) for c, d in pairs],
            "estoi": [jmetrics.estoi(c, d) for c, d in pairs],
            "stoi_8k": jmetrics.stoi(pairs[0][0][::2], pairs[0][1][::2], fs=8_000),
            "pesq": {(i, mode): jpesq.pesq(c, d, FS, mode) for i, (c, d) in enumerate(pairs)
                     for mode in ("nb", "wb")},
            "pesq_score": jmetrics.pesq_score(*pairs[1]), "pesq_impl": jmetrics.pesq_impl(),
            "pair": jharness.evaluate_pair(pairs[2][1], pairs[2][0]),
            "wer": [jmetrics.wer(r, h) for r, h in zip(REFS, HYPS)],
            "corpus_wer": jmetrics.corpus_wer(REFS, HYPS),
            "viseme": [jmetrics.viseme_distance(r, h) for r, h in zip(REFS, HYPS)],
            "viseme_lexicon": jmetrics.viseme_distance("bin blue", "bin glue",
                                                       {"bin": ["B", "IH1", "N"]}),
            "normalized": [jmetrics.normalize_text(r) for r in REFS],
            "gt": gt, "synthesis": res.__dict__, "synthesis_json": res.to_json()}


@pytest.fixture(scope="module")
def jax_metrics(tmp_path_factory):
    return run_once(tmp_path_factory, "eval_metrics", _jax_metrics)


def _close(got, ref, tol=METRIC_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))), (got, ref)


@pytest.mark.parametrize("which", ["stoi", "estoi"])
def test_stoi_and_estoi_match_jax(jax_metrics, which):
    fn = tmetrics.stoi if which == "stoi" else tmetrics.estoi
    _close([fn(c, d) for c, d in _pairs()], jax_metrics[1][which])
    if which == "stoi":
        pair = _pairs()[0]
        _close(tmetrics.stoi(pair[0][::2], pair[1][::2], fs=8_000), jax_metrics[1]["stoi_8k"])
    with pytest.raises(ValueError, match="too short"):
        fn(np.ones(1_000), np.ones(1_000))


@pytest.mark.parametrize("mode", ["nb", "wb"])
def test_in_tree_pesq_matches_jax(jax_metrics, mode):
    ref = jax_metrics[1]
    for i, (c, d) in enumerate(_pairs()):
        _close(tpesq.pesq(c, d, FS, mode), ref["pesq"][(i, mode)])
    if mode == "nb":
        assert tmetrics.pesq_impl() == ref["pesq_impl"]
        _close(tmetrics.pesq_score(*_pairs()[1]), ref["pesq_score"])


def test_text_metrics_match_jax(jax_metrics):
    ref = jax_metrics[1]
    assert [tmetrics.normalize_text(r) for r in REFS] == ref["normalized"]
    _close([tmetrics.wer(r, h) for r, h in zip(REFS, HYPS)], ref["wer"])
    _close(tmetrics.corpus_wer(REFS, HYPS), ref["corpus_wer"])
    _close([tmetrics.viseme_distance(r, h) for r, h in zip(REFS, HYPS)], ref["viseme"])
    _close(tmetrics.viseme_distance("bin blue", "bin glue", {"bin": ["B", "IH1", "N"]}),
           ref["viseme_lexicon"])


def test_evaluate_synthesis_matches_jax(jax_metrics, tmp_path):
    """The corpus harness over three pairs on disk (one prediction missing,
    one clip too short for STOI) with a stand-in readback: per-utterance
    metrics and corpus means equal, the same JSON; evaluate_pair and the
    ground-truth CSV reader."""
    shared, ref = jax_metrics
    pred_dir, tsv, csv = _write_synthesis(tmp_path)
    gt = tharness.load_groundtruth_csv(csv)
    assert gt == ref["gt"]
    res = tharness.evaluate_synthesis(pred_dir, tsv, groundtruth_text=gt, asr=FakeASR())
    want = ref["synthesis"]
    assert res.n_utts == want["n_utts"] == 2
    assert res.per_utt.keys() == want["per_utt"].keys()
    for uid, row in want["per_utt"].items():
        assert res.per_utt[uid].keys() == row.keys()
        for k, v in row.items():
            if isinstance(v, float):
                _close(res.per_utt[uid][k], v)
            else:
                assert res.per_utt[uid][k] == v, (uid, k)
    for k in ("stoi", "estoi", "pesq", "wer", "viseme_dist"):
        _close(getattr(res, k), want[k])
    assert res.pesq_anchor == want["pesq_anchor"]
    got_json, want_json = json.loads(res.to_json()), json.loads(ref["synthesis_json"])
    assert got_json.keys() == want_json.keys()
    for k, v in want_json.items():
        if isinstance(v, float):
            _close(got_json[k], v)
        else:
            assert got_json[k] == v, k
    pair = tharness.evaluate_pair(_pairs()[2][1], _pairs()[2][0])
    assert pair.keys() == ref["pair"].keys()
    _close([pair[k] for k in ("stoi", "estoi", "pesq")], [ref["pair"][k] for k in
                                                            ("stoi", "estoi", "pesq")])


# ------------------------------------------------------------------- text

def test_char_processor_matches_jax():
    t, j = ttext.SentenceProcessor(), jtext.SentenceProcessor()
    assert t.num_classes == j.num_classes == 39 and ttext.CHARS == jtext.CHARS
    s = "bin blue at f two now's 9"
    np.testing.assert_array_equal(t.encode(s), j.encode(s))
    assert t.decode(t.encode(s)) == s
    ids = [0, 2, 2, 0, 2, 5, 5, 0, 0, 37, 1]
    assert t.collapse_ctc(ids) == j.collapse_ctc(ids)
    assert (t.is_valid("ab c"), t.is_valid("A!")) == (j.is_valid("ab c"), j.is_valid("A!"))


def test_unigram_tokenizer_matches_jax(tmp_path):
    """Viterbi over a made-up .vocab (pieces with scores, specials, an
    unknown character) and decoding with ⁇ for unk."""
    pieces = [("<pad>", 0.0), ("<s>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁", -2.0),
              ("▁the", -3.0), ("▁th", -4.0), ("e", -2.5), ("▁b", -3.5), ("in", -3.0),
              ("▁bin", -5.0), ("▁blue", -6.0), ("b", -4.0), ("l", -4.0), ("u", -4.0),
              ("t", -4.0), ("h", -4.0), ("i", -4.0), ("n", -4.0)]
    vocab = tmp_path / "m.vocab"
    vocab.write_text("".join(f"{p}\t{s}\n" for p, s in pieces), encoding="utf-8")
    t, j = ttext.SentenceProcessor(str(vocab)), jtext.SentenceProcessor(str(vocab))
    assert t.num_classes == j.num_classes == len(pieces)
    for s in ("the bin blue", "  blue  bin the ", "bin zebra", ""):
        np.testing.assert_array_equal(t.encode(s), j.encode(s))
        assert t.decode(t.encode(s)) == j.decode(j.encode(s))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_ctc_beam_matches_python_oracle(seed):
    """The C prefix beam against the Python one (use_native=False) and the
    JAX package's Python one: labels equal, score within 1e-6."""
    rng = np.random.default_rng(seed)
    t, c = (30, 8) if seed < 2 else (1, 5)
    lp = np.log(rng.dirichlet(np.full(c, 0.5), t)).astype(np.float32)
    got = ttext.ctc_beam_search(lp, beam_width=6)
    ref = ttext.ctc_beam_search(lp, beam_width=6, use_native=False)
    jref = jtext.ctc_beam_search(lp, beam_width=6, use_native=False)
    assert got[0] == ref[0] == jref[0]
    np.testing.assert_allclose([got[1], ref[1]], [jref[1], jref[1]], rtol=1e-6)


def test_native_edit_distance_matches_python_oracle():
    rng = np.random.default_rng(3)
    cases = [([], []), ([1, 2], []), ([], [3]), ([1, 2, 3], [1, 3])]
    cases += [(list(rng.integers(0, 5, rng.integers(0, 40))), list(rng.integers(0, 5, 30)))
              for _ in range(20)]
    for a, b in cases:
        assert native.edit_distance(a, b) == tunits.unit_edit_distance(list(a), list(b))


def test_native_build_raises_without_a_compiler(tmp_path, monkeypatch):
    """No `cc` on PATH: the loader raises instead of falling back to Python,
    and so does a source the compiler rejects."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="no C compiler"):
        native.edit_distance([1, 2], [2])
    with pytest.raises(RuntimeError, match="no C compiler"):
        ttext.ctc_beam_search(np.zeros((3, 4), np.float32))
    monkeypatch.undo()
    src = tmp_path / "src"
    src.mkdir()
    (src / "editdistance.c").write_text("this is not C\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})
    with pytest.raises(RuntimeError, match="cc exited"):
        native.edit_distance([1], [1])


# ------------------------------------------------------------------- units

def test_beam_units_and_unit_helpers_match_jax():
    """beam_units' exact n-best against the JAX heap (tokens exactly,
    scores within 1e-4 of max(1, |ref|)), with a masked tail; units_to_text,
    dedup_units and unit_wer (native edit distance)."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 6, 12)).astype(np.float32)
    mask = np.ones((2, 6), bool)
    mask[1, 4:] = False
    got, got_s = tunits.beam_units(torch.from_numpy(logits), torch.from_numpy(mask), 5,
                                   return_scores=True)
    ref, ref_s = junits.beam_units(jnp.asarray(logits), jnp.asarray(mask), 5,
                                   return_scores=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=1e-4, atol=1e-4)
    assert tunits.units_to_text(got[1, 0].numpy()) == junits.units_to_text(np.asarray(ref)[1, 0])
    seq = [3, 3, 1, 1, 1, 4, 3]
    assert tunits.dedup_units(seq) == junits.dedup_units(seq) == [3, 1, 4, 3]
    hyps = [list(rng.integers(0, 9, 20)), list(rng.integers(0, 9, 7)), []]
    refs = [list(rng.integers(0, 9, 18)), list(rng.integers(0, 9, 9)), [1, 2]]
    assert tunits.unit_wer(hyps, refs) == junits.unit_wer(hyps, refs)
