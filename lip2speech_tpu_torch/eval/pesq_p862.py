"""PESQ (ITU-T P.862) — in-tree numpy implementation (the port's own copy of
the JAX package's eval/pesq_p862.py).

The reference reports STOI/ESTOI/PESQ for every headline row
(reference README.md:103-122) but computes PESQ with an external
package; this module makes the triple reproducible in-image.

Pipeline structure follows the standard (P.862 §10, and the P.862.2
wideband extension):

  1. level alignment to the PESQ target power over the speech band
  2. input filtering (IRS-receive approximation for NB; the P.862.2
     wideband input high-pass for WB)
  3. envelope-based crude delay estimation + parabolic fine alignment
  4. psychoacoustic model per 32 ms Hann frame (50% overlap):
     power spectrum -> Bark band energies -> partial frequency
     compensation (ref toward deg) -> short-term gain compensation
     (deg toward ref) -> Zwicker loudness -> masked difference ->
     asymmetry weighting
  5. Lp aggregation: L3 over bands (weighted by band width), frame
     weighting by reference activity, L6 within 20-frame "split
     seconds", L2 across split seconds
  6. raw score 4.5 - 0.1 d_sym - 0.0309 d_asym, then the published
     logistic MOS-LQO mapping (P.862.1 for NB, P.862.2 for WB)

Scope and fidelity notes (honest labeling):
  * The ITU reference implementation hard-codes 49-band Bark tables and
    per-band hearing thresholds. Those tables are NOT copied here; they
    are regenerated analytically from the PSQM Hz->Bark transform
    z = 7 asinh(f/650) (uniform division, bins mapped by center) and the
    Terhardt threshold-in-quiet formula. Scores therefore track P.862
    closely but are not bit-identical; `tests/test_pesq.py` gates an
    exact comparison on the optional `pesq` package and pins in-image
    anchors (identity ceiling, SNR monotonicity, mapping range).
  * Time alignment handles constant delays (our synthesis pipeline is
    sample-aligned by construction); P.862's per-utterance delay-jump
    splitting is not implemented.
"""

from __future__ import annotations

import numpy as np

# --- framing ---------------------------------------------------------------
FRAME = 512          # 32 ms at 16 kHz
HOP = 256
NB_BANDS = 49        # P.862 uses 49 Bark bands at 16 kHz
TARGET_POWER = 1e7   # PESQ internal level (P.862 fix_power_level)
ZWICKER_GAMMA = 0.23


def _hz_to_bark(f):
    return 7.0 * np.arcsinh(np.asarray(f, dtype=np.float64) / 650.0)


def _bark_to_hz(z):
    return 650.0 * np.sinh(np.asarray(z, dtype=np.float64) / 7.0)


class _BandTables:
    """Bark band geometry + hearing thresholds, derived analytically."""

    def __init__(self, fs: int = 16_000):
        nyq = fs / 2.0
        n_bins = FRAME // 2 + 1
        self.bin_hz = np.arange(n_bins) * fs / FRAME
        z_edges = np.linspace(_hz_to_bark(0.0), _hz_to_bark(nyq), NB_BANDS + 1)
        self.centre_bark = 0.5 * (z_edges[:-1] + z_edges[1:])
        hz_edges = _bark_to_hz(z_edges)
        self.centre_hz = _bark_to_hz(self.centre_bark)
        self.width_hz = np.diff(hz_edges)
        self.width_bark = np.diff(z_edges)
        # map FFT bins (excluding DC) to bands by bin-center frequency
        idx = np.clip(np.searchsorted(hz_edges, self.bin_hz, side="right") - 1,
                      0, NB_BANDS - 1)
        self.bin_band = idx
        self.bin_valid = np.arange(n_bins) >= 1
        # Terhardt threshold in quiet (dB SPL), converted to PESQ power
        # units via the same scale used for spectra (see _bark_spectrum)
        khz = np.maximum(self.centre_hz, 20.0) / 1000.0
        thr_db = (3.64 * khz ** -0.8
                  - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
                  + 1e-3 * khz ** 4)
        self.abs_thresh = 10.0 ** (np.clip(thr_db, -10.0, 96.0) / 10.0)
        # modified Zwicker exponent: steeper below 4 Bark (P.862 §10.2.3)
        h = np.where(self.centre_bark < 4.0,
                     6.0 / (self.centre_bark + 2.0), 1.0)
        self.gamma = ZWICKER_GAMMA * np.maximum(h, 1.0) ** 0.15


_TABLES: dict[int, _BandTables] = {}


def _tables(fs: int) -> _BandTables:
    if fs not in _TABLES:
        _TABLES[fs] = _BandTables(fs)
    return _TABLES[fs]


# ---------------------------------------------------------------------------
# stage 1-2: level alignment + input filter
# ---------------------------------------------------------------------------


def _band_power(x: np.ndarray, fs: int, lo: float, hi: float) -> float:
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(len(x), 1.0 / fs)
    sel = (f >= lo) & (f <= hi)
    return float(np.sum(np.abs(spec[sel]) ** 2) / (len(x) ** 2) * 2.0)


def _fix_level(x: np.ndarray, fs: int) -> np.ndarray:
    """Scale to the PESQ target power measured over 300-3000 Hz."""
    p = _band_power(x, fs, 300.0, 3000.0)
    if p <= 0:
        return x
    return x * np.sqrt(TARGET_POWER / (p * len(x)) * len(x))


_IRS_POINTS_DB = [  # IRS receive characteristic, piecewise-linear in log-f
    (0, -200.0), (50, -40.0), (100, -20.0), (125, -12.0), (160, -6.0),
    (200, 0.0), (250, 4.0), (300, 6.0), (350, 8.0), (400, 10.0),
    (500, 11.0), (600, 12.0), (700, 12.0), (800, 12.0), (1000, 12.0),
    (1300, 12.0), (1600, 12.0), (2000, 12.0), (2500, 12.0), (3000, 12.0),
    (3250, 12.0), (3500, 4.0), (4000, -200.0), (5000, -200.0),
    (6300, -200.0), (8000, -200.0),
]

_WB_POINTS_DB = [  # P.862.2 wideband input filter: flat with 100 Hz high-pass
    (0, -500.0), (50, -500.0), (100, -31.0), (125, -21.0), (160, -12.0),
    (200, -6.5), (250, -3.5), (300, -1.5), (350, -0.75), (400, 0.0),
    (8000, 0.0),
]


def _apply_fft_filter(x: np.ndarray, fs: int, points) -> np.ndarray:
    n = len(x)
    f = np.fft.rfftfreq(n, 1.0 / fs)
    pf = np.array([p[0] for p in points], dtype=np.float64)
    pdb = np.array([p[1] for p in points], dtype=np.float64)
    gain_db = np.interp(f, pf, pdb, left=pdb[0], right=pdb[-1])
    spec = np.fft.rfft(x) * 10.0 ** (gain_db / 20.0)
    return np.fft.irfft(spec, n)


# ---------------------------------------------------------------------------
# stage 3: alignment
# ---------------------------------------------------------------------------


def _envelope(x: np.ndarray, frame: int = 64) -> np.ndarray:
    n = len(x) // frame
    e = np.square(x[: n * frame].reshape(n, frame)).sum(axis=1)
    return np.log(e + 1e-10)


def _crude_delay(ref: np.ndarray, deg: np.ndarray, fs: int) -> int:
    """Envelope cross-correlation delay estimate (P.862 crude_align)."""
    frame = 64
    er = _envelope(ref, frame)
    ed = _envelope(deg, frame)
    er = er - er.mean()
    ed = ed - ed.mean()
    n = len(er) + len(ed)
    corr = np.fft.irfft(np.fft.rfft(ed, 2 * n) * np.conj(np.fft.rfft(er, 2 * n)))
    lags = np.concatenate([np.arange(0, n), np.arange(-n, 0)])
    best = int(np.argmax(corr))
    return int(lags[best]) * frame


def _align(ref: np.ndarray, deg: np.ndarray, fs: int):
    d = _crude_delay(ref, deg, fs)
    if d > 0:            # degraded lags: drop its leading samples
        deg = deg[d:]
    elif d < 0:
        ref = ref[-d:]
    n = min(len(ref), len(deg))
    return ref[:n], deg[:n]


# ---------------------------------------------------------------------------
# stage 4: psychoacoustic model
# ---------------------------------------------------------------------------


def _bark_spectrum(x: np.ndarray, fs: int, t: _BandTables) -> np.ndarray:
    """(T, NB_BANDS) Bark-band power densities per 32 ms Hann frame."""
    n = (len(x) - FRAME) // HOP + 1
    if n <= 0:
        return np.zeros((0, NB_BANDS))
    idx = np.arange(n)[:, None] * HOP + np.arange(FRAME)[None, :]
    win = np.hanning(FRAME + 2)[1:-1]
    spec = np.abs(np.fft.rfft(x[idx] * win, axis=1)) ** 2    # (T, F)
    # sum bin powers into bands, normalize to per-Hz density x band width
    out = np.zeros((n, NB_BANDS))
    np.add.at(out.T, _band_bins(t), spec.T[t.bin_valid])
    # scale so a full-scale calibration tone lands near the model's knee
    return out * (2.0 / FRAME ** 2) * 1e10 / TARGET_POWER * 1e7


def _band_bins(t: _BandTables) -> np.ndarray:
    return t.bin_band[t.bin_valid]


def _total_audible(frames: np.ndarray, t: _BandTables, factor: float) -> np.ndarray:
    """Per-frame audible power: sum of band power above factor x threshold."""
    aud = np.where(frames > t.abs_thresh * factor, frames, 0.0)
    return aud @ t.width_bark


def _loudness(frames: np.ndarray, t: _BandTables) -> np.ndarray:
    """Zwicker loudness density (P.862 §10.2.3, modified low-band exponent)."""
    p0 = t.abs_thresh
    g = t.gamma
    sl = 1.866055e-1 / NB_BANDS
    base = (p0 / 0.5) ** g
    ratio = np.maximum(frames / p0, 0.0)
    loud = sl * base * ((0.5 + 0.5 * ratio) ** g - 1.0)
    return np.where(frames > p0, loud, 0.0)


def _psycho_disturbance(ref: np.ndarray, deg: np.ndarray, fs: int):
    t = _tables(fs)
    br = _bark_spectrum(ref, fs, t)
    bd = _bark_spectrum(deg, fs, t)
    n = min(len(br), len(bd))
    br, bd = br[:n], bd[:n]
    if n == 0:
        return np.zeros(0), np.zeros(0), np.zeros(0)

    frame_pow = _total_audible(br, t, 1.0)
    active = frame_pow > 1e-2 * frame_pow.max() if frame_pow.size else frame_pow
    if not np.any(active):
        active = np.ones(n, bool)

    # partial frequency-response compensation: scale REF toward DEG
    avg_r = br[active].mean(axis=0)
    avg_d = bd[active].mean(axis=0)
    fcomp = np.clip((avg_d + 1e3 * _eps(avg_d)) / (avg_r + 1e3 * _eps(avg_r)),
                    0.01, 100.0) ** 0.2
    br = br * fcomp[None, :]

    # short-term gain compensation: scale DEG toward REF, smoothed 0.8
    aud_r = _total_audible(br, t, 1.0)
    aud_d = _total_audible(bd, t, 1.0)
    gain = (aud_r + 5e-4) / (aud_d + 5e-4)
    sm = np.empty_like(gain)
    g = 1.0
    for i in range(n):
        g = 0.8 * g + 0.2 * np.clip(gain[i], 3e-4, 5.0)
        sm[i] = g
    bd = bd * sm[:, None]

    lr = _loudness(br, t)
    ld = _loudness(bd, t)

    # masked (deadzone) difference
    d = ld - lr
    dead = 0.25 * np.minimum(ld, lr)
    d = np.sign(d) * np.maximum(np.abs(d) - dead, 0.0)

    # asymmetry factor: additive distortion weighs more than omission
    ratio = ((bd + 50.0 * _eps(bd)) / (br + 50.0 * _eps(br))) ** 1.2
    asym = np.where(ratio < 3.0, 0.0, np.minimum(ratio, 12.0))

    w = t.width_bark
    d_frame = _lp_bands(np.abs(d), w, p=2.0)
    da_frame = _lp_bands(np.abs(d) * asym, w, p=1.0)
    # emphasize quiet reference frames (P.862 frame weighting)
    weight = ((frame_pow + 1e5 * _eps(frame_pow)) /
              (frame_pow.max() + 1e5 * _eps(frame_pow))) ** 0.04
    weight = np.clip(weight, 0.5, 1.0)
    return np.minimum(d_frame / weight, 45.0), np.minimum(da_frame / weight, 45.0), active


def _eps(x: np.ndarray) -> float:
    m = float(np.max(x)) if x.size else 0.0
    return m * 1e-7 + 1e-30


def _lp_bands(d: np.ndarray, w: np.ndarray, p: float) -> np.ndarray:
    return (np.sum((d ** p) * w, axis=1) / np.sum(w)) ** (1.0 / p)


def _lpq_time(d: np.ndarray, p: float = 6.0, q: float = 2.0,
              group: int = 20) -> float:
    """L6 within 20-frame split-seconds, L2 across (P.862 §10.2.6)."""
    if len(d) == 0:
        return 0.0
    n_groups = max(1, int(np.ceil(len(d) / group)))
    pad = n_groups * group - len(d)
    dd = np.pad(d, (0, pad))
    counts = np.minimum(group, len(d) - np.arange(n_groups) * group)
    gs = (np.sum(dd.reshape(n_groups, group) ** p, axis=1) /
          np.maximum(counts, 1)) ** (1.0 / p)
    return float((np.mean(gs ** q)) ** (1.0 / q))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _mos_map_nb(x: float) -> float:
    # P.862.1 raw-score -> MOS-LQO mapping
    return 0.999 + (4.999 - 0.999) / (1.0 + np.exp(-1.4945 * x + 4.6607))


def _mos_map_wb(x: float) -> float:
    # P.862.2 wideband mapping
    return 0.999 + (4.999 - 0.999) / (1.0 + np.exp(-1.3669 * x + 3.8224))


def pesq(ref: np.ndarray, deg: np.ndarray, fs: int = 16_000,
         mode: str = "nb") -> float:
    """PESQ MOS-LQO of `deg` against `ref`.

    mode="nb": IRS-filtered narrowband model + P.862.1 mapping (what the
    reference tables report at 16 kHz); mode="wb": P.862.2.
    """
    if fs != 16_000:
        raise ValueError("in-tree PESQ supports 16 kHz input (pipeline rate)")
    ref = np.asarray(ref, dtype=np.float64)
    deg = np.asarray(deg, dtype=np.float64)
    n = min(len(ref), len(deg))
    if n < 4 * FRAME:
        raise ValueError("signal too short for PESQ (needs >= 128 ms)")
    ref, deg = ref[:n], deg[:n]

    ref = _fix_level(ref, fs)
    deg = _fix_level(deg, fs)
    points = _IRS_POINTS_DB if mode == "nb" else _WB_POINTS_DB
    ref = _apply_fft_filter(ref, fs, points)
    deg = _apply_fft_filter(deg, fs, points)
    ref, deg = _align(ref, deg, fs)

    d_frame, da_frame, _ = _psycho_disturbance(ref, deg, fs)
    d_sym = _lpq_time(d_frame)
    d_asym = _lpq_time(da_frame)
    raw = 4.5 - 0.1 * d_sym - 0.0309 * d_asym
    mapped = _mos_map_nb(raw) if mode == "nb" else _mos_map_wb(raw)
    return float(np.clip(mapped, 1.0, 4.644))
