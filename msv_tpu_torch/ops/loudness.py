"""Loudness metering — ITU-R BS.1770-4 / EBU R128, ported from
``msv_tpu/ops/loudness.py``.

K-weighted, gated program loudness (LUFS), short-term loudness, loudness
range and true peak.

* **IIR on the device.**  The K-weighting pre-filter is two biquads, each
  run as scans (``ops/scan.py``) with msv_tpu's per-stage choice: real (or
  near-real) poles as the FIR stencil and two cascaded first-order pole
  scans, complex poles (the shelf, radius 0.86) as the 2x2 state-matrix
  scan.  ``k_weighting_coeffs`` is a copy of msv_tpu's, pinned by
  tests/test_torch_host.py.
* **Chunks.**  Long files filter in 2^21-sample spans that overlap by 8192
  warm-up samples whose output is discarded, as in msv_tpu.  msv_tpu padded
  each span to a fixed shape to bound its compile cache; the padding is
  zeros past the end of a causal filter, so the port runs exact lengths.
* **Gating.**  Each span's squared K-weighted samples are summed in float64
  on the device and only the cumulative sums at the 100 ms grid points go
  to the host, which applies the gates (400 ms blocks at 75 % overlap,
  absolute gate at -70 LUFS, relative gate 10 LU under the absolutely-gated
  mean) in float64 numpy, as msv_tpu does.
* **True peak.**  Each segment is oversampled by the port's polyphase
  ``resample_poly`` and reduced to its peak and the two neighbours on the
  device; msv_tpu's parabolic refinement runs on those three values.

Every function takes (T,) or (n_ch, T) audio as numpy (to the card unless
``device`` says otherwise) or as a tensor (on its own device).
"""

import functools
import math

import numpy as np
import torch

from ..utils.device import as_f32
from .scan import _f32, matrix_scan, pole_scan



@functools.lru_cache(maxsize=16)
def k_weighting_coeffs(sr: int):
    """((b, a) shelf, (b, a) highpass) f64 biquad coefficients for
    ``sr``; a[0] == 1."""
    if sr < 1000:
        raise ValueError(f"sample rate too low for K-weighting: {sr}")
    # stage 1: spherical-head high shelf
    db, f0, q = 3.999843853973347, 1681.974450955533, 0.7071752369554196
    k = math.tan(math.pi * f0 / sr)
    vh = 10.0 ** (db / 20.0)
    vb = vh ** 0.4996667741545416
    a0 = 1.0 + k / q + k * k
    shelf_b = np.array([
        (vh + vb * k / q + k * k) / a0,
        2.0 * (k * k - vh) / a0,
        (vh - vb * k / q + k * k) / a0,
    ])
    shelf_a = np.array([
        1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0,
    ])
    # stage 2: rumble high-pass
    f0, q = 38.13547087602444, 0.5003270373238773
    k = math.tan(math.pi * f0 / sr)
    a0 = 1.0 + k / q + k * k
    hp_b = np.array([1.0, -2.0, 1.0])
    hp_a = np.array([
        1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0,
    ])
    return (shelf_b, shelf_a), (hp_b, hp_a)

def _biquad_scan(x, b, a):
    """One biquad (a[0]=1) as scans.

    Real (or near-real) poles: numerator stencil, then two cascaded
    first-order pole scans — the well-conditioned form.  Complex poles
    (used by the shelf stage, pole radius 0.86): the 2x2 state-matrix
    scan, fine at that damping."""
    b0, b1, b2 = (float(v) for v in b)
    a1, a2 = float(a[1]), float(a[2])
    disc = a1 * a1 - 4.0 * a2
    pad = torch.nn.functional.pad
    if disc >= -1e-6:
        # z^2 + a1 z + a2 = (z - p)(z - q); clamp a hair-negative
        # discriminant (the 48 kHz high-pass: -1.5e-8) to a double pole —
        # a <=1e-4 pole shift, far below f32 filtering noise
        root = math.sqrt(max(disc, 0.0)) / 2.0
        p, q = -a1 / 2.0 + root, -a1 / 2.0 - root
        fir = (_f32(b0) * x + _f32(b1) * pad(x[:-1], (1, 0))
               + _f32(b2) * pad(x[:-2], (2, 0)))
        return pole_scan(pole_scan(fir, p), q)
    # s[n] = A s[n-1] + u[n];  A = [[-a1, 1], [-a2, 0]],
    # u[n] = [(b1 - a1 b0) x, (b2 - a2 b0) x];  y[n] = b0 x[n] + s1[n-1]
    s0, _ = matrix_scan(_f32(b1 - a1 * b0) * x, _f32(b2 - a2 * b0) * x,
                        [[-a1, 1.0], [-a2, 0.0]])
    return _f32(b0) * x + pad(s0[:-1], (1, 0))


def _k_weight(x, sr):
    """Both K-weighting stages over a 1-D f32 tensor."""
    (sb, sa), (hb, ha) = k_weighting_coeffs(sr)
    return _biquad_scan(_biquad_scan(x, sb, sa), hb, ha)


_CHUNK = 1 << 21      # ~2M samples per span (~50 MB of scan state)
_WARMUP = 8192        # slowest pole 0.995^8192 = e^-41: past f32 noise


def _k_weight_chunked(x, sr):
    """Yield K-weighted spans of the 1-D f32 tensor ``x`` on its device,
    in order, with bounded device memory.

    Spans overlap by ``_WARMUP`` samples whose output is discarded — the
    filters' state has fully forgotten anything older (slowest pole
    radius 0.995), so the stitched result equals the one-scan answer to
    f32 noise (pinned in tests)."""
    n = x.shape[0]
    if n <= _CHUNK:
        yield _k_weight(x, sr)
        return
    for a in range(0, n, _CHUNK):
        w0 = max(0, a - _WARMUP)
        y = _k_weight(x[w0:a + _CHUNK], sr)
        yield y[a - w0:]


# surround weighting, BS.1770-4 table 3: L/R/C 1.0, Ls/Rs 1.41 (LFE
# excluded upstream — pass it no row)
_CH_WEIGHTS = (1.0, 1.0, 1.0, 1.41, 1.41)


def _validated(wav, device=None):
    """(n_ch, T) f32 tensor of ``wav`` on its device (see the module
    docstring)."""
    wav = as_f32(wav, device)
    if wav.ndim == 1:
        wav = wav[None]
    if wav.ndim != 2:
        raise ValueError(
            f"wav must be (T,) or (n_ch, T), got {tuple(wav.shape)}")
    if wav.shape[0] > len(_CH_WEIGHTS):
        raise ValueError(
            f"{wav.shape[0]} channels: BS.1770 weights cover up to 5 "
            "(L R C Ls Rs, LFE excluded)"
        )
    return wav


def _block_powers(wav, sr: int, cells: int):
    """Channel-weighted K-weighted mean square of every ``cells``-cell
    sliding block on the 100 ms hop grid -> (n_blocks,) f64 numpy.

    The shared engine behind integrated (4 cells = 400 ms) and short-term
    (30 cells = 3 s) metering: per span, the span's f64 power cumsum on
    the device, read at the span's hop-grid samples and offset by the sum
    so far — O(n_blocks) host memory however long the file is.
    """
    hop = int(round(0.100 * sr))
    block = cells * hop
    if wav.shape[1] < block:
        raise ValueError(
            f"need at least one {cells * 100} ms block ({block} "
            f"samples), got {wav.shape[1]}"
        )
    n_blocks = 1 + (wav.shape[1] - block) // hop
    n_grid = n_blocks + cells - 1

    z = np.zeros(n_blocks, np.float64)
    for ch in range(wav.shape[0]):
        csg = torch.zeros(n_grid + 1, dtype=torch.float64, device=wav.device)
        off = torch.zeros((), dtype=torch.float64, device=wav.device)
        pos = 0
        for y in _k_weight_chunked(wav[ch], sr):
            y2 = y.double()
            lcs = torch.nn.functional.pad(torch.cumsum(y2 * y2, 0), (1, 0))
            g0 = -(-pos // hop)
            g1 = min((pos + len(y)) // hop, n_grid)
            if g1 >= g0:
                gs = torch.arange(g0, g1 + 1, device=wav.device)
                csg[g0:g1 + 1] = off + lcs[gs * hop - pos]
            off = off + lcs[-1]
            pos += len(y)
        csg = csg.cpu().numpy()
        ms = (csg[cells:cells + n_blocks] - csg[:n_blocks]) / block
        z += _CH_WEIGHTS[ch] * ms
    return z


def integrated_loudness(wav, sr: int, *, device=None) -> float:
    """Gated integrated loudness in LUFS of (T,) mono or (n_ch, T)
    multichannel audio (channel order L R C Ls Rs; omit the LFE row).

    Returns ``-inf`` for silence / nothing above the -70 LUFS absolute
    gate.  The filtering (two scanned biquads per channel) runs on the
    device in spans with discarded warm-up overlap (see
    :func:`_k_weight_chunked`), and the host keeps only the f64 power
    cumsum at 100 ms grid points.
    """
    wav = _validated(wav, device)
    z = _block_powers(wav, sr, 4)

    with np.errstate(divide="ignore"):
        lb = -0.691 + 10.0 * np.log10(np.maximum(z, 1e-30))
    abs_gated = z[lb > -70.0]
    if abs_gated.size == 0:
        return float("-inf")
    rel_thresh = (-0.691 + 10.0 * math.log10(abs_gated.mean())) - 10.0
    final = z[(lb > -70.0) & (lb > rel_thresh)]
    if final.size == 0:
        return float("-inf")
    return -0.691 + 10.0 * math.log10(float(final.mean()))


def short_term_loudness(wav, sr: int, *, device=None) -> np.ndarray:
    """Short-term loudness series in LUFS: 3 s sliding window on the
    100 ms hop grid (10 Hz update, EBU R128 "S").  Value i covers
    samples [i*hop, i*hop + 3 s); silence reads as a large negative
    number (the -0.691 + 10*log10(1e-30) floor), not -inf, so the
    series stays plottable.
    """
    wav = _validated(wav, device)
    z = _block_powers(wav, sr, 30)
    with np.errstate(divide="ignore"):
        return -0.691 + 10.0 * np.log10(np.maximum(z, 1e-30))


def loudness_range(wav, sr: int, *, device=None) -> float:
    """Loudness range (LRA) in LU, EBU Tech 3342.

    Distribution of short-term (3 s) loudness, absolute-gated at
    -70 LUFS, then relative-gated 20 LU under the power mean of the
    absolutely gated values; LRA = the spread between the 10th and
    95th percentiles of what survives.  Returns 0.0 when the gates
    leave fewer than two blocks (silence or sub-3 s-scale programs
    have no meaningful range).
    """
    wav = _validated(wav, device)
    z = _block_powers(wav, sr, 30)
    with np.errstate(divide="ignore"):
        ls = -0.691 + 10.0 * np.log10(np.maximum(z, 1e-30))
    abs_gated = z[ls > -70.0]
    if abs_gated.size == 0:
        return 0.0
    rel_thresh = (-0.691 + 10.0 * math.log10(abs_gated.mean())) - 20.0
    final = ls[(ls > -70.0) & (ls > rel_thresh)]
    if final.size < 2:
        return 0.0
    lo, hi = np.percentile(final, [10.0, 95.0])
    return float(hi - lo)


def true_peak(wav, sr: int, *, device=None) -> float:
    """True-peak level in dBTP (BS.1770-4 annex 2: inter-sample peaks
    via oversampling to >= 192 kHz before taking max |x|).

    Uses the polyphase resampler (ops/resample.py) at the smallest
    integer factor reaching 192 kHz — 4x at 48 kHz, the annex's
    reference design — per channel, unweighted (no K filter), plus
    msv_tpu's parabolic refinement of |y| around the grid peak (the
    plain max under-reads by up to ``1 - cos(pi f / sr_os)``).  Returns
    ``-inf`` for digital silence.  Long files oversample in fixed-length
    segments with filter context, as in msv_tpu.
    """
    wav = _validated(wav, device)
    if wav.shape[1] < 32:
        raise ValueError(f"need at least 32 samples, got {wav.shape[1]}")
    factor = max(1, -(-192000 // int(sr)))
    peak = 0.0
    for ch in wav:
        peak = max(peak, _channel_true_peak(ch, factor))
    if peak <= 0.0:
        return float("-inf")
    return 20.0 * math.log10(peak)


_TP_SEG = 1 << 20   # input samples per oversampling launch (~4 MB f32)
_TP_CTX = 16        # filter reach: half_len/up = 10 input samples


def _parabolic_peak(y: np.ndarray) -> float:
    """max of |y| with a 3-point parabolic fit around the grid peak."""
    i = int(np.argmax(y))
    p = float(y[i])
    if 0 < i < len(y) - 1:
        y0, y2 = float(y[i - 1]), float(y[i + 1])
        den = y0 - 2.0 * p + y2
        if den < -1e-12:
            d = 0.5 * (y0 - y2) / den
            if -1.0 < d < 1.0:
                p = p - 0.25 * (y0 - y2) * d
    return p

def _segment_peak(y) -> float:
    """:func:`_parabolic_peak` of the 1-D tensor ``|y|`` from its grid peak
    and two neighbours, taken on the device (``argmax`` gives the first
    maximum, as numpy's does, so the window holds the same three values
    the whole array would give)."""
    y = y.abs()
    i = int(torch.argmax(y))
    return _parabolic_peak(y[max(0, i - 1):i + 2].cpu().numpy())


def _channel_true_peak(ch, factor: int) -> float:
    from .resample import resample_poly

    if factor == 1:
        return _segment_peak(ch)
    n = ch.shape[0]
    if n <= _TP_SEG:
        return _segment_peak(resample_poly(ch, factor, 1))
    # fixed-length segments + context: values match the one-shot op
    # (upfirdn with down=1 is shift-invariant and the zero extension
    # equals scipy's)
    buf_len = _TP_SEG + 2 * _TP_CTX
    peak = 0.0
    for a in range(0, n, _TP_SEG):
        lo = a - _TP_CTX
        seg = ch[max(0, lo):a + _TP_SEG + _TP_CTX]
        buf = ch.new_zeros(buf_len)
        buf[max(0, -lo):max(0, -lo) + len(seg)] = seg
        y = resample_poly(buf, factor, 1)
        # interior outputs for [a, a+_TP_SEG), +-1 sample of margin so
        # the parabolic fit sees its grid neighbors across seams
        o0 = _TP_CTX * factor
        o1 = o0 + min(_TP_SEG, n - a) * factor
        peak = max(peak, _segment_peak(y[max(0, o0 - 1):o1 + 1]))
    return peak


def r128_stats(wav, sr: int, *, device=None) -> dict:
    """One-call EBU R128 summary: ``{"lufs", "lra", "dbtp"}``,
    JSON-ready (rounded; ``None`` where unmeasurable: silence for
    lufs/dbtp, programs shorter than one 3 s short-term block for
    lra).  The single source of the CLI's `info --loudness` and the
    viewer's /api/loudness.  Raises ValueError below one 400 ms block,
    like :func:`integrated_loudness`.
    """
    wav = _validated(wav, device)
    lufs = integrated_loudness(wav, sr)
    tp = true_peak(wav, sr)
    # the REAL short-term requirement (30 cells of round(0.1*sr)), not
    # 3*sr: they differ at rates where 0.1*sr rounds up
    lra = (loudness_range(wav, sr)
           if wav.shape[1] >= 30 * int(round(0.100 * sr)) else None)
    return {
        "lufs": None if lufs == float("-inf") else round(lufs, 2),
        "lra": None if lra is None else round(lra, 1),
        "dbtp": None if tp == float("-inf") else round(tp, 2),
    }
