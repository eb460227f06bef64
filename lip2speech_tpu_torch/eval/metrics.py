"""Evaluation metrics: STOI / ESTOI, WER, viseme distance (the port's own
copy of the JAX package's eval/metrics.py; numpy on the host).

The reference evaluates with STOI/ESTOI/PESQ (README tables; SURVEY.md §6)
computed by external packages, Whisper-WER + viseme distance in
test_compare.py:14-130. Here STOI/ESTOI are implemented from the published
algorithms (Taal et al. 2011; Jensen & Taal 2016) in numpy — numerically
equivalent to pystoi. PESQ (ITU-T P.862) is in-tree (eval/pesq_p862.py),
upgraded to the bit-exact ITU code when the optional `pesq` package is
installed. WER is a standard word-level Levenshtein (jiwer equivalent).
"""

from __future__ import annotations

import numpy as np
from scipy.signal import resample_poly

FS_STOI = 10_000
N_FRAME = 256
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N_SEG = 30          # analysis window: 30 frames = 384 ms
BETA = -15.0        # clipping lower SDR bound (STOI only)
DYN_RANGE = 40.0


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=float)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = min_freq * 2.0 ** ((k - 0.5) / 3.0)
    hi = min_freq * 2.0 ** ((k + 0.5) / 3.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        fl = int(np.argmin((f - lo[i]) ** 2))
        fh = int(np.argmin((f - hi[i]) ** 2))
        obm[i, fl:fh] = 1.0
    return obm, cf


def _frames(x: np.ndarray, win: np.ndarray, hop: int) -> np.ndarray:
    n = (len(x) - N_FRAME) // hop + 1
    if n <= 0:
        return np.zeros((0, N_FRAME))
    idx = np.arange(n)[:, None] * hop + np.arange(N_FRAME)[None, :]
    return x[idx] * win


def _remove_silent_frames(x, y, dyn_range=DYN_RANGE, hop=N_FRAME // 2):
    win = np.hanning(N_FRAME + 2)[1:-1]
    xf = _frames(x, win, hop)
    yf = _frames(y, win, hop)
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-10)
    mask = energies > (np.max(energies) - dyn_range)
    xf, yf = xf[mask], yf[mask]

    # overlap-add back
    n = len(xf)
    out_len = (n - 1) * hop + N_FRAME if n else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(n):
        xs[i * hop : i * hop + N_FRAME] += xf[i]
        ys[i * hop : i * hop + N_FRAME] += yf[i]
    return xs, ys


def _spectrogram_bands(x: np.ndarray, obm: np.ndarray) -> np.ndarray:
    win = np.hanning(N_FRAME + 2)[1:-1]
    frames = _frames(x, win, N_FRAME // 2)
    spec = np.abs(np.fft.rfft(frames, NFFT, axis=1)) ** 2   # (T, F)
    return np.sqrt(obm @ spec.T)                            # (bands, T)


def stoi(clean: np.ndarray, degraded: np.ndarray, fs: int = 16_000,
         extended: bool = False) -> float:
    """Short-Time Objective Intelligibility of `degraded` w.r.t. `clean`."""
    clean = np.asarray(clean, dtype=np.float64)
    degraded = np.asarray(degraded, dtype=np.float64)
    n = min(len(clean), len(degraded))
    clean, degraded = clean[:n], degraded[:n]
    if fs != FS_STOI:
        clean = resample_poly(clean, FS_STOI, fs)
        degraded = resample_poly(degraded, FS_STOI, fs)

    clean, degraded = _remove_silent_frames(clean, degraded)
    obm, _ = _thirdoct(FS_STOI, NFFT, NUM_BANDS, MIN_FREQ)
    x = _spectrogram_bands(clean, obm)       # (J, T)
    y = _spectrogram_bands(degraded, obm)
    if x.shape[1] < N_SEG:
        raise ValueError("signal too short for STOI (needs >= 384 ms of speech)")

    if not extended:
        scores = []
        for m in range(N_SEG, x.shape[1] + 1):
            xs = x[:, m - N_SEG : m]                         # (J, N)
            ys = y[:, m - N_SEG : m]
            alpha = np.linalg.norm(xs, axis=1, keepdims=True) / (
                np.linalg.norm(ys, axis=1, keepdims=True) + 1e-10)
            ys_c = np.minimum(alpha * ys, xs * (1 + 10 ** (-BETA / 20)))
            xm = xs - xs.mean(axis=1, keepdims=True)
            ym = ys_c - ys_c.mean(axis=1, keepdims=True)
            corr = np.sum(xm * ym, axis=1) / (
                np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-10)
            scores.append(corr.mean())
        return float(np.mean(scores))

    # ESTOI (Jensen & Taal 2016): row+column normalization, mean correlation
    scores = []
    for m in range(N_SEG, x.shape[1] + 1):
        xs = x[:, m - N_SEG : m].copy()
        ys = y[:, m - N_SEG : m].copy()
        # row (band) normalization
        xs = xs - xs.mean(axis=1, keepdims=True)
        xs = xs / (np.linalg.norm(xs, axis=1, keepdims=True) + 1e-10)
        ys = ys - ys.mean(axis=1, keepdims=True)
        ys = ys / (np.linalg.norm(ys, axis=1, keepdims=True) + 1e-10)
        # column (frame) normalization
        xs = xs - xs.mean(axis=0, keepdims=True)
        xs = xs / (np.linalg.norm(xs, axis=0, keepdims=True) + 1e-10)
        ys = ys - ys.mean(axis=0, keepdims=True)
        ys = ys / (np.linalg.norm(ys, axis=0, keepdims=True) + 1e-10)
        scores.append(np.sum(xs * ys) / N_SEG)
    return float(np.mean(scores))


def estoi(clean, degraded, fs: int = 16_000) -> float:
    return stoi(clean, degraded, fs, extended=True)


def pesq_score(clean, degraded, fs: int = 16_000, mode: str = "nb") -> float:
    """ITU-T P.862 PESQ MOS-LQO.

    NOTE: the default mode is "nb" (P.862.1 narrowband MOS-LQO) because the
    in-tree fallback implements narrowband P.862; scores are NOT comparable
    with wideband ("wb") figures — the eval harness records the mode next to
    the score (`pesq_mode`) so artifacts are never cross-compared silently.

    Uses the external `pesq` package when installed (bit-exact ITU code),
    otherwise the in-tree implementation (eval/pesq_p862.py) so the
    reference's STOI/ESTOI/PESQ metric triple (README.md:103-122) is
    always computable in this image."""
    try:
        from pesq import pesq as _pesq

        return float(_pesq(fs, np.asarray(clean), np.asarray(degraded), mode))
    except ImportError:
        from lip2speech_tpu_torch.eval.pesq_p862 import pesq as _pesq_intree

        return float(_pesq_intree(np.asarray(clean), np.asarray(degraded), fs, mode))


def pesq_impl() -> str:
    """Which PESQ implementation `pesq_score` will use: "itu" (external
    `pesq` package, bit-exact ITU code) or "intree-approx" (eval/pesq_p862.py,
    a faithful but UNANCHORED P.862 implementation — its absolute MOS-LQO has
    never been validated against the ITU reference binaries, so scores are
    RELATIVE-ONLY: valid for comparing systems within this harness, not for
    quoting next to published PESQ figures)."""
    try:
        import pesq  # noqa: F401

        return "itu"
    except ImportError:
        return "intree-approx"


# ---------------------------------------------------------------------------
# Text metrics
# ---------------------------------------------------------------------------


def _edit_distance(a: list, b: list) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def normalize_text(s: str) -> str:
    import re

    s = s.lower().strip()
    s = re.sub(r"[^a-z0-9' ]+", " ", s)
    return re.sub(r"\s+", " ", s).strip()


def wer(reference: str, hypothesis: str) -> float:
    """Word error rate (jiwer.wer equivalent on normalized text)."""
    ref = normalize_text(reference).split()
    hyp = normalize_text(hypothesis).split()
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(ref, hyp) / len(ref)


def corpus_wer(references: list[str], hypotheses: list[str]) -> float:
    errs = total = 0
    for r, h in zip(references, hypotheses):
        ref = normalize_text(r).split()
        hyp = normalize_text(h).split()
        errs += _edit_distance(ref, hyp)
        total += len(ref)
    return errs / max(total, 1)


# ---------------------------------------------------------------------------
# Viseme distance (test_compare.py semantics: map words -> viseme strings,
# then normalized edit distance). The word->phoneme lexicon is pluggable; a
# grapheme fallback keeps the metric usable without CMUdict.
# ---------------------------------------------------------------------------

# Lee & Yook (2002)-style ARPAbet phoneme -> viseme classes
PHONEME_TO_VISEME = {
    **dict.fromkeys(["P", "B", "M"], "p"),
    **dict.fromkeys(["F", "V"], "f"),
    **dict.fromkeys(["TH", "DH"], "th"),
    **dict.fromkeys(["T", "D", "S", "Z", "N", "L"], "t"),
    **dict.fromkeys(["SH", "ZH", "CH", "JH"], "sh"),
    **dict.fromkeys(["K", "G", "NG", "HH", "Y"], "k"),
    **dict.fromkeys(["R", "ER"], "r"),
    **dict.fromkeys(["W"], "w"),
    **dict.fromkeys(["IY", "IH", "EY", "EH", "AE"], "iy"),
    **dict.fromkeys(["AA", "AH", "AY", "AW"], "aa"),
    **dict.fromkeys(["AO", "OY", "OW"], "ao"),
    **dict.fromkeys(["UW", "UH"], "uw"),
}

_GRAPHEME_FALLBACK = {
    "p": "p", "b": "p", "m": "p", "f": "f", "v": "f",
    "t": "t", "d": "t", "s": "t", "z": "t", "n": "t", "l": "t",
    "c": "k", "k": "k", "g": "k", "q": "k", "h": "k", "j": "sh", "x": "t",
    "r": "r", "w": "w", "y": "k",
    "i": "iy", "e": "iy", "a": "aa", "o": "ao", "u": "uw",
}


def word_to_visemes(word: str, lexicon: dict[str, list[str]] | None = None) -> list[str]:
    word = word.lower()
    if lexicon and word in lexicon:
        phones = [p.rstrip("012") for p in lexicon[word]]
        return [PHONEME_TO_VISEME.get(p, "t") for p in phones]
    return [_GRAPHEME_FALLBACK[c] for c in word if c in _GRAPHEME_FALLBACK]


def viseme_distance(reference: str, hypothesis: str,
                    lexicon: dict[str, list[str]] | None = None) -> float:
    """Normalized viseme edit distance between two transcripts."""
    ref = [v for w in normalize_text(reference).split() for v in word_to_visemes(w, lexicon)]
    hyp = [v for w in normalize_text(hypothesis).split() for v in word_to_visemes(w, lexicon)]
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(ref, hyp) / len(ref)
