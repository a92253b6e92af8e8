"""Automatic click/pop repair — LPC-residual detection and patch
resynthesis, ported from ``msv_tpu/ops/declick.py``.

Detection is two-pass LPC whitening (``ops/lpc.py::lpc`` on the device)
with a robust per-chunk residual scale and a local-contrast gate; repair
is two-sided AR interpolation for short spans and the phase-coherent
spectral patch (``ops/specedit.py``) for longer ones.  The residual of
every sample, ``e(t) = x(t) + sum_k a_k(t) x(t-k)``, is ``order + 1``
shifted slices weighted and summed on the device in msv_tpu's order; the
per-sample coefficients are gathered from the frames' on the device too
(msv_tpu gathers them on the host, 1.15 GB for a 240 s 48 kHz channel,
and uploads them for each residual).
The rest is msv_tpu's host numpy: ``find_clicks``, ``_ar_coef``,
``_ar_fill`` and ``declick`` are copies, pinned by
tests/test_torch_host.py (``find_clicks`` and ``declick`` with named line
edits: the device of the LPC fit, the residual and the patch).

LPC is ill-conditioned on periodic frames (ROADMAP, queue 3), so a residual
ratio near the threshold can flip a flag between this port and msv_tpu;
clicks whose ratio is decisive (measured 430-14 500x against a 13.5x
gate) give the same spans.
"""

import numpy as np
import torch

from ..utils.device import as_f32
from .lpc import lpc
from .specedit import Box, spectral_edit

__all__ = ["find_clicks", "declick"]


def _residual_core(padded_sig, a_up, *, order, n, device=None):
    """e(t) = x(t) + sum_k a_k(t) x(t-k) over the zero-padded signal
    (``order`` leading zeros) and the per-sample coefficients
    (n, order + 1), on ``device``; host float32 out."""
    x = as_f32(padded_sig, device)
    a = as_f32(a_up, device)
    acc = torch.zeros(n, dtype=torch.float32, device=x.device)
    for k in range(order + 1):
        acc = acc + a[:, k] * x[order - k:order - k + n]
    return acc.cpu().numpy()


def find_clicks(
    wav,
    sr: int,
    *,
    thresh: float = 9.0,
    frame_length: int = 1024,
    order: int | None = None,
    merge_ms: float = 1.5,
    pad_ms: float = 0.4,
    max_click_ms: float = 15.0,
    contrast: float = 1.5, device=None,
):
    """Detect click spans -> list of ``(a, b)`` sample ranges.

    ``thresh`` is the robust outlier factor against each frame's median
    absolute LPC residual (9 is conservative: Gaussian noise residuals
    sit ~1, true clicks decades higher).  Nearby flags merge within
    ``merge_ms`` and each span grows by ``pad_ms`` per side; spans
    longer than ``max_click_ms`` are not clicks and are dropped.

    ``contrast`` gates each span on LOCAL isolation: its peak residual
    must exceed ``contrast * thresh`` times the median residual of the
    +-10 ms surround.  Musical transients (drum hits, note attacks)
    elevate the residual across their whole neighborhood and fail the
    gate; a genuine click is an isolated spike and passes by decades.
    Measured on sample_44k1 with 12 planted clicks: 423 false spans
    ungated -> ~20 at the default 1.5x (clicks-in-noise keep a 1.6x
    margin: their contrast is ~21x vs the 13.5x gate; music transients
    bulk below it; true clicks run 430-14500x).  ``contrast=0``
    disables the gate.
    """
    wav = np.asarray(wav, np.float32)
    if wav.ndim != 1:
        raise ValueError(f"wav must be 1-D, got {wav.shape}")
    if thresh <= 1.0:
        raise ValueError(f"thresh must be > 1, got {thresh}")
    n = len(wav)
    hop = frame_length // 2
    if n < frame_length:
        return []
    if order is None:
        order = min(int(2 + sr / 1000), 24)

    def fit(model_sig):
        a, _, _ = lpc(model_sig, order=order,
                      frame_length=frame_length, hop_length=hop, device=device)
        # a stays on the device, where a[fi] gathers the rows
        fi = np.clip(np.round(np.arange(n) / hop).astype(np.int64), 0,
                     a.shape[0] - 1)
        return a[fi]

    def residual_of(a_up, of_sig):
        padded = np.concatenate([np.zeros(order, np.float32), of_sig])
        r = np.array(_residual_core(
            padded, a_up, order=order, n=n, device=device))
        r[:order] = 0.0  # no context: the zero-pad makes these spike
        return np.abs(r)

    def chunk_scale(absr):
        # robust local scale: per-hop-chunk medians (a click is a
        # minority of its chunk), max-smoothed with neighbors so flags
        # near chunk seams don't see a half-sized scale
        n_chunks = (n + hop - 1) // hop
        absr_p = np.pad(absr, (0, n_chunks * hop - n), mode="edge")
        m = np.median(absr_p.reshape(n_chunks, hop), axis=1)
        m = np.maximum(m, np.maximum(np.roll(m, 1), np.roll(m, -1)))
        return np.repeat(m, hop)[:n]

    merge = int(merge_ms / 1000.0 * sr)
    pad = int(pad_ms / 1000.0 * sr)
    lim = int(max_click_ms / 1000.0 * sr)

    # pass 1: lenient flags off the possibly click-corrupted models,
    # then interpolate the suspects out of the MODEL signal
    absr1 = residual_of(fit(wav), wav)
    floor1 = max(float(np.median(absr1)) * 0.1, 1e-8)
    sus = absr1 > np.float32(0.5 * thresh) * np.maximum(
        chunk_scale(absr1), floor1)
    if not sus.any():
        return []
    grow = np.convolve(sus.astype(np.float32),
                       np.ones(9, np.float32), mode="same") > 0
    clean = wav.astype(np.float64).copy()
    keep = ~grow
    if keep.sum() >= 2:
        ki = np.flatnonzero(keep)
        clean[grow] = np.interp(np.flatnonzero(grow), ki, clean[ki])
    clean = clean.astype(np.float32)

    # pass 2: click-free models; residual of the ORIGINAL signal,
    # scale from the cleaned signal's own residual
    a2 = fit(clean)
    absr2 = residual_of(a2, wav)
    scale2 = chunk_scale(residual_of(a2, clean))
    floor = max(float(np.median(absr2)) * 0.1, 1e-8)
    denom = np.maximum(scale2, floor)
    ratio = absr2 / denom
    flags = ratio > np.float32(thresh)
    if not flags.any():
        return []
    idx = np.flatnonzero(flags)
    spans = []
    a0 = b0 = idx[0]
    for t in idx[1:]:
        if t - b0 <= merge:
            b0 = t
        else:
            spans.append((a0, b0 + 1))
            a0 = b0 = t
    spans.append((a0, b0 + 1))
    win_c = int(0.010 * sr)  # +-10 ms isolation surround
    out = []
    for (s0, s1) in spans:
        # local-contrast gate (regular spans only; over-long edge smears
        # below keep their own 5x peak-vs-scale criterion): a click's
        # spike towers over its surround, a musical transient does not
        if contrast > 0 and s1 - s0 <= lim:
            lo = max(0, s0 - win_c)
            hi = min(n, s1 + win_c)
            surround = np.concatenate([absr2[lo:s0], absr2[s1:hi]])
            med = float(np.median(surround)) if len(surround) else 0.0
            if float(absr2[s0:s1].max()) <= contrast * thresh * max(
                    med, floor):
                continue
        s0 = max(s0 - pad, 0)
        s1 = min(s1 + pad, n)
        # Over-long spans are not clicks — EXCEPT at the signal edges,
        # where they are kept (reported) when they contain a decisively
        # click-like spike: the first/last LPC frames are half zero-pad,
        # so pass 1 interpolates a large fraction of the edge chunk out
        # and the pass-2 re-fit flags a residual smear across the whole
        # edge that merges with any true edge click.  Dropping that
        # merged span would silently LOSE the click (measured: the click
        # at 0.004 s vanished); keeping it lets downstream classify it
        # as too-close-to-edge-to-patch.  The 5x-thresh peak gate keeps
        # smears WITHOUT a click out (true clicks run decades above
        # threshold — measured 2257x vs 1.6x for a click-free smear).
        edge_hit = ((s0 < frame_length or s1 > n - frame_length)
                    and float(ratio[s0:s1].max()) > 5.0 * thresh)
        if s1 - s0 <= lim or edge_hit:
            if out and s0 <= out[-1][1]:
                out[-1] = (out[-1][0], s1)
            else:
                out.append((s0, s1))
    return out


def _ar_coef(ctx: np.ndarray, p: int) -> np.ndarray:
    """Autocorrelation-method AR(p) predictor coefficients (Levinson),
    float64; returns c with prediction x[t] ~= sum c[k] * x[t-1-k].

    Third sibling of the same recursion in the tree, each shaped by its
    host: ops/lpc.py::_levinson (batched torch loop for device frame
    grids) and native/wirepack2.cc::lpc_fit_block (single-block C for
    the packer).  This one runs once per detected click on the host
    with per-call regularization — keep the three numerically aligned
    if the recursion or its floors ever change."""
    c = np.asarray(ctx, np.float64)
    n = len(c)
    ac = np.array([np.dot(c[: n - k], c[k:]) for k in range(p + 1)])
    ac[0] = ac[0] * (1 + 1e-9) + 1e-12
    a = np.zeros(p + 1)
    a[0] = 1.0
    e = ac[0]
    for i in range(1, p + 1):
        acc = ac[i] + np.dot(a[1:i], ac[i - 1:0:-1])
        k = -acc / e
        a_new = a.copy()
        for j in range(1, i):
            a_new[j] = a[j] + k * a[i - j]
        a_new[i] = k
        a = a_new
        e = max(e * (1 - k * k), 1e-15)
    return -a[1:]


def _ar_fill(left_ctx: np.ndarray, right_ctx: np.ndarray, gap: int,
             p: int = 64) -> np.ndarray:
    """Two-sided AR interpolation of a ``gap``-sample hole: forward
    extrapolation from the left context and backward from the right,
    crossfaded — the classic short-click restorer (each side only has to
    stay coherent for half the gap)."""
    p = min(p, len(left_ctx) // 2, len(right_ctx) // 2)
    cf = _ar_coef(left_ctx, p)
    hist = list(np.asarray(left_ctx[-p:], np.float64))
    fwd = np.empty(gap)
    for t in range(gap):
        v = float(np.dot(cf, hist[: -p - 1: -1]))
        fwd[t] = v
        hist.append(v)
    cb = _ar_coef(right_ctx[::-1], p)
    hist = list(np.asarray(right_ctx[: p][::-1], np.float64))
    bwd = np.empty(gap)
    for t in range(gap):
        v = float(np.dot(cb, hist[: -p - 1: -1]))
        bwd[t] = v
        hist.append(v)
    bwd = bwd[::-1]
    w = (np.arange(gap) + 0.5) / gap
    return ((1.0 - w) * fwd + w * bwd).astype(np.float32)


def declick(
    wav,
    sr: int,
    *,
    thresh: float = 9.0,
    frame_length: int = 1024,
    order: int | None = None,
    repair_win: int = 256,
    ar_max_ms: float = 4.0,
    ar_ctx: int = 512, device=None,
    **find_kw,
):
    """Find and repair clicks -> ``(repaired, spans, skipped)``.

    ``spans`` are the repaired sample ranges, ``skipped`` the detected
    spans too close to the signal edges for the repairs' clean-context
    requirement (reported, left untouched).  Signals without clicks
    return the input unchanged (no STFT roundtrip).

    Two repair engines by gap length: spans up to ``ar_max_ms`` get
    two-sided AR interpolation (forward/backward extrapolation from
    ``ar_ctx`` samples of context, crossfaded — the classic short-click
    restorer, far better than spectral patching on dense material:
    measured +21 dB at click sites on sample_44k1); longer spans fall
    back to the phase-coherent spectral patch (ops/specedit.py).
    """
    wav = np.asarray(wav, np.float32)
    spans = find_clicks(wav, sr, thresh=thresh,
                        frame_length=frame_length, order=order,
                        device=device, **find_kw)
    if not spans:
        return wav, [], []
    ar_max = int(ar_max_ms / 1000.0 * sr)
    hop = repair_win // 4
    # each span is widened by win/2 per side before boxing: the patch's
    # "clean" boundary frames (fa-1 left, fb right) overlap the raw span
    # by up to win/2 - hop samples, so an unwidened box interpolates from
    # click-contaminated endpoints (measured: -9.7 dB repair vs -70 dB
    # widened).  The edge guard grows by the same amount so a widened
    # box still has its clean frames inside the signal.
    widen = repair_win // 2
    lead = 4 * hop + repair_win // 2 + widen
    lim = int(find_kw.get("max_click_ms", 15.0) / 1000.0 * sr)
    near_edge = frame_length  # find_clicks' edge-keep criterion
    ok, ar_spans, skipped = [], [], []
    for (s0, s1) in spans:
        over_long_edge = s1 - s0 > lim and (
            s0 < near_edge or s1 > len(wav) - near_edge)
        if s0 < lead or s1 > len(wav) - lead or over_long_edge:
            # too close to an edge for the patch's clean-frame
            # requirement, or an over-long EDGE smear (find_clicks keeps
            # those so the click inside is reported, not silently lost).
            # Mid-signal spans that merged past lim after padding stay
            # repairable — only edge smears take this path.
            skipped.append((s0, s1))
        elif s1 - s0 <= ar_max:
            ar_spans.append((s0, s1))
        else:
            ok.append((max(s0 - widen, 0), min(s1 + widen, len(wav))))
    out_ar = wav
    if ar_spans:
        out_ar = wav.copy()
        for (s0, s1) in ar_spans:
            # context never includes OTHER detected spans' samples?  AR
            # contexts are short (ar_ctx) and spans merge within
            # merge_ms, so a neighboring click inside the context is
            # possible but rare; the crossfade bounds the damage.
            lc = out_ar[max(s0 - ar_ctx, 0):s0]
            rc = out_ar[s1:s1 + ar_ctx]
            out_ar[s0:s1] = _ar_fill(lc, rc, s1 - s0)
    if not ok:
        return out_ar, sorted(ar_spans), skipped
    # merge spans whose repair boxes would overlap in frames
    min_gap = 4 * hop
    merged = [list(ok[0])]
    for (s0, s1) in ok[1:]:
        if s0 - merged[-1][1] < min_gap:
            merged[-1][1] = s1
        else:
            merged.append([s0, s1])
    boxes = [Box(s0 / sr, s1 / sr, 0.0, sr / 2.0, mode="patch")
             for (s0, s1) in merged]
    out = spectral_edit(
        out_ar, sr, boxes, win_length=repair_win, hop_length=hop,
        n_fft=repair_win, feather_ms=1000.0 * hop / sr, feather_hz=0.0, device=device)
    return (out, sorted([tuple(s) for s in merged] + ar_spans), skipped)
