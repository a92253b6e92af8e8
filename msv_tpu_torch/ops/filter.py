"""General digital filtering, ported from ``msv_tpu/ops/filter.py``: IIR
design on the host, execution as scans on the device.

* **Design (host, f64 numpy).**  Copies of msv_tpu's from-scratch
  Butterworth zpk design (analog prototype -> lp/hp/bp/bs -> bilinear with
  prewarp -> conjugate-paired second-order sections), the RBJ Audio-EQ
  Cookbook biquads, ``sos_response``, ``_section_plan``,
  ``sosfilt_zi_step`` and ``firwin``, pinned to their originals by
  tests/test_torch_host.py.
* **Execution (device, f32).**  Each biquad is its FIR stencil and then
  msv_tpu's per-section plan on ``ops/scan.py``: two cascaded real
  first-order scans for real poles, one complex-pole scan projected as
  ``y = 2*Re(A*w)`` for a conjugate pair.  Every power of a pole in the
  scan is at most 1 in modulus.
* **State carry.**  Every section exposes ``(x[-1], x[-2], s1, s2)``, so
  :func:`sosfilt_streamed` is exact across chunks, and :func:`filtfilt`
  reproduces ``scipy.signal.sosfiltfilt``'s pad method.

msv_tpu padded lengths to 64k buckets to bound its compile cache; no
program here is keyed on length, and the padding is zeros past the end of a
causal filter, so the port runs the exact length.  The functions take a
numpy array (to the card unless ``device`` says otherwise) or a tensor (on
its own device) and return host numpy, as msv_tpu's do.
"""

import math

import numpy as np
import torch

from ..config import precision_for
from ..utils.device import as_f32, target_device
from .scan import _f32, pole_scan


__all__ = [
    "butter_sos",
    "peaking_eq",
    "low_shelf",
    "high_shelf",
    "notch",
    "sosfilt",
    "sosfilt_streamed",
    "sosfilt_zi_step",
    "filtfilt",
    "firwin",
    "fir_filter",
    "sos_response",
]


# ---------------------------------------------------------------------------
# design: Butterworth (host, f64)
# ---------------------------------------------------------------------------

def _buttap(order):
    """Analog Butterworth prototype poles (unit cutoff), gain 1."""
    m = np.arange(-order + 1, order, 2)
    p = -np.exp(1j * np.pi * m / (2 * order))
    return np.array([], complex), p, 1.0


def _lp2lp(z, p, k, wo):
    deg = len(p) - len(z)
    return z * wo, p * wo, k * wo ** deg


def _lp2hp(z, p, k, wo):
    deg = len(p) - len(z)
    zh = wo / z if len(z) else np.array([], complex)
    ph = wo / p
    zh = np.append(zh, np.zeros(deg))
    k = k * np.real(np.prod(-z) / np.prod(-p))
    return zh, ph, k


def _lp2bp(z, p, k, wo, bw):
    deg = len(p) - len(z)
    zl, pl = z * bw / 2, p * bw / 2
    zb = np.concatenate([zl + np.sqrt(zl ** 2 - wo ** 2 + 0j),
                         zl - np.sqrt(zl ** 2 - wo ** 2 + 0j)])
    pb = np.concatenate([pl + np.sqrt(pl ** 2 - wo ** 2 + 0j),
                         pl - np.sqrt(pl ** 2 - wo ** 2 + 0j)])
    zb = np.append(zb, np.zeros(deg))
    return zb, pb, k * bw ** deg


def _lp2bs(z, p, k, wo, bw):
    deg = len(p) - len(z)
    zh = (bw / 2) / z if len(z) else np.array([], complex)
    ph = (bw / 2) / p
    zb = np.concatenate([zh + np.sqrt(zh ** 2 - wo ** 2 + 0j),
                         zh - np.sqrt(zh ** 2 - wo ** 2 + 0j)])
    pb = np.concatenate([ph + np.sqrt(ph ** 2 - wo ** 2 + 0j),
                         ph - np.sqrt(ph ** 2 - wo ** 2 + 0j)])
    zb = np.concatenate([zb, 1j * wo * np.ones(deg), -1j * wo * np.ones(deg)])
    k = k * np.real(np.prod(-z) / np.prod(-p))
    return zb, pb, k


def _bilinear(z, p, k, fs):
    fs2 = 2.0 * fs
    zd = (fs2 + z) / (fs2 - z)
    pd = (fs2 + p) / (fs2 - p)
    zd = np.append(zd, -np.ones(len(p) - len(z)))
    kd = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return zd, pd, kd


def _pair_conjugates(roots):
    """Split roots into (conjugate pairs, reals); tolerant matching."""
    roots = np.asarray(roots, complex)
    used = np.zeros(len(roots), bool)
    pairs, reals = [], []
    order = np.argsort(np.abs(roots.imag))  # reals first
    for i in order:
        if used[i]:
            continue
        r = roots[i]
        if abs(r.imag) <= 1e-10 * max(1.0, abs(r.real)):
            used[i] = True
            reals.append(r.real)
            continue
        # find the closest unused conjugate
        cand = [j for j in range(len(roots)) if not used[j] and j != i]
        if not cand:
            raise ValueError("unpaired complex root in filter design")
        j = min(cand, key=lambda j: abs(roots[j] - np.conj(r)))
        used[i] = used[j] = True
        pairs.append((r, roots[j]))
    return pairs, reals


def _zpk2sos(z, p, k):
    """Conjugate-paired second-order sections, overall gain on the first.

    Any pairing realizes the same transfer function; sections are
    ordered low-damping-first so the overall gain multiplies the most
    forgiving section.  Each pole pair greedily takes the nearest
    remaining zeros (keeps section peak gains tame for bp/bs designs).
    """
    zp, zr = _pair_conjugates(z)
    pp, pr = _pair_conjugates(p)
    # pack real roots two per section (count parity matches: bilinear
    # design gives len(z) == len(p))
    zsec = [np.array(q) for q in zp] + [
        np.array(zr[i:i + 2]) for i in range(0, len(zr), 2)]
    psec = [np.array(q) for q in pp] + [
        np.array(pr[i:i + 2]) for i in range(0, len(pr), 2)]
    # order poles by radius descending (closest to the circle first)
    psec.sort(key=lambda q: -np.max(np.abs(q)))
    sos = []
    remaining = list(zsec)
    for q in psec:
        if remaining:
            ctr = np.mean(q)
            i = min(range(len(remaining)),
                    key=lambda i: abs(np.mean(remaining[i]) - ctr))
            zz = remaining.pop(i)
        else:
            zz = np.array([], complex)
        b = np.real(np.poly(zz)) if len(zz) else np.array([1.0])
        a = np.real(np.poly(q)) if len(q) else np.array([1.0])
        b = np.pad(b, (0, 3 - len(b)))
        a = np.pad(a, (0, 3 - len(a)))
        sos.append(np.concatenate([b, a]))
    sos = np.array(sos) if sos else np.zeros((0, 6))
    if len(sos):
        sos[0, :3] *= k
    return sos


def butter_sos(order, cutoff, btype="lowpass", *, sr):
    """Digital Butterworth filter as (n_sections, 6) f64 SOS rows.

    ``cutoff`` is in Hz: a scalar for lowpass/highpass, an (lo, hi)
    pair for bandpass/bandstop.  Transfer-function parity with
    ``scipy.signal.butter(..., output='sos')`` is pinned in tests.
    """
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    btype = {"low": "lowpass", "high": "highpass", "bp": "bandpass",
             "bs": "bandstop"}.get(btype, btype)
    z, p, k = _buttap(order)
    fs = 2.0
    if btype in ("lowpass", "highpass"):
        f = float(np.squeeze(cutoff))
        if not 0.0 < f < sr / 2:
            raise ValueError(f"cutoff {f} Hz outside (0, {sr / 2}) at sr={sr}")
        warped = 2 * fs * math.tan(math.pi * f / sr)
        z, p, k = (_lp2lp if btype == "lowpass" else _lp2hp)(z, p, k, warped)
    elif btype in ("bandpass", "bandstop"):
        lo, hi = (float(v) for v in cutoff)
        if not 0.0 < lo < hi < sr / 2:
            raise ValueError(
                f"band edges ({lo}, {hi}) must satisfy 0 < lo < hi < {sr / 2}")
        w1 = 2 * fs * math.tan(math.pi * lo / sr)
        w2 = 2 * fs * math.tan(math.pi * hi / sr)
        wo, bw = math.sqrt(w1 * w2), w2 - w1
        z, p, k = (_lp2bp if btype == "bandpass" else _lp2bs)(z, p, k, wo, bw)
    else:
        raise ValueError(f"unknown btype {btype!r}")
    z, p, k = _bilinear(z, p, k, fs)
    return _zpk2sos(z, p, k)


# ---------------------------------------------------------------------------
# design: RBJ Audio-EQ Cookbook biquads (host, f64)
# ---------------------------------------------------------------------------

def _rbj_common(sr, f0, q):
    if not 0.0 < f0 < sr / 2:
        raise ValueError(f"f0 {f0} Hz outside (0, {sr / 2}) at sr={sr}")
    if q <= 0:
        raise ValueError(f"q must be positive, got {q}")
    w0 = 2 * math.pi * f0 / sr
    return w0, math.sin(w0) / (2 * q)


def peaking_eq(sr, f0, gain_db, q=1.0):
    """Peaking EQ: ``gain_db`` boost/cut at ``f0``, unity far away."""
    w0, alpha = _rbj_common(sr, f0, q)
    A = 10.0 ** (gain_db / 40.0)
    b = [1 + alpha * A, -2 * math.cos(w0), 1 - alpha * A]
    a = [1 + alpha / A, -2 * math.cos(w0), 1 - alpha / A]
    return (np.array([b + a]) / a[0]).reshape(1, 6)


def _shelf(sr, f0, gain_db, s, *, high):
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2 * math.pi * f0 / sr
    if not 0.0 < f0 < sr / 2:
        raise ValueError(f"f0 {f0} Hz outside (0, {sr / 2}) at sr={sr}")
    alpha = math.sin(w0) / 2 * math.sqrt((A + 1 / A) * (1 / s - 1) + 2)
    cw = math.cos(w0)
    sq = 2 * math.sqrt(A) * alpha
    sgn = 1.0 if high else -1.0
    b = [A * ((A + 1) + sgn * (A - 1) * cw + sq),
         -2 * sgn * A * ((A - 1) + sgn * (A + 1) * cw),
         A * ((A + 1) + sgn * (A - 1) * cw - sq)]
    a = [(A + 1) - sgn * (A - 1) * cw + sq,
         2 * sgn * ((A - 1) - sgn * (A + 1) * cw),
         (A + 1) - sgn * (A - 1) * cw - sq]
    return (np.array([b + a]) / a[0]).reshape(1, 6)


def low_shelf(sr, f0, gain_db, slope=1.0):
    """Low shelf: ``gain_db`` below ``f0``, unity above (RBJ S=slope)."""
    return _shelf(sr, f0, gain_db, slope, high=False)


def high_shelf(sr, f0, gain_db, slope=1.0):
    """High shelf: ``gain_db`` above ``f0``, unity below."""
    return _shelf(sr, f0, gain_db, slope, high=True)


def notch(sr, f0, q=30.0):
    """Notch: null at ``f0``, unity elsewhere."""
    w0, alpha = _rbj_common(sr, f0, q)
    b = [1.0, -2 * math.cos(w0), 1.0]
    a = [1 + alpha, -2 * math.cos(w0), 1 - alpha]
    return (np.array([b + a]) / a[0]).reshape(1, 6)


def sos_response(sos, freqs, sr):
    """|H(e^{j2πf/sr})| of an SOS cascade at ``freqs`` Hz (host f64)."""
    z = np.exp(-2j * np.pi * np.asarray(freqs, float) / sr)
    h = np.ones_like(z)
    for b0, b1, b2, a0, a1, a2 in np.asarray(sos, float):
        h *= (b0 + b1 * z + b2 * z * z) / (a0 + a1 * z + a2 * z * z)
    return np.abs(h)


# ---------------------------------------------------------------------------
# execution (device, f32)
# ---------------------------------------------------------------------------

def _section_plan(sos):
    """Static per-section execution plans from (n, 6) f64 SOS rows.

    ('real', b0, b1, b2, p, q): two cascaded real first-order scans.
    ('cplx', b0, b1, b2, p_re, p_im, A_re, A_im): one split-complex
    first-order scan, output 2*Re(A*w).
    """
    plans = []
    for row in np.asarray(sos, float):
        b0, b1, b2, a0, a1, a2 = (float(v) for v in row)
        if abs(a0 - 1.0) > 1e-12:
            b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
        disc = a1 * a1 - 4.0 * a2
        if disc >= -1e-12 * max(1.0, a1 * a1):
            root = math.sqrt(max(disc, 0.0)) / 2.0
            plans.append(("real", b0, b1, b2, -a1 / 2 + root, -a1 / 2 - root))
        else:
            pre, pim = -a1 / 2.0, math.sqrt(-disc) / 2.0
            # partial fractions: 1/((1-pz)(1-p̄z)) = A/(1-pz) + Ā/(1-p̄z),
            # A = p/(p - p̄) = p/(2j·im)
            A = complex(pre, pim) / complex(0.0, 2.0 * pim)
            plans.append(("cplx", b0, b1, b2, pre, pim, A.real, A.imag))
    return tuple(plans)

def _apply_section(x, state, plan):
    """One biquad over ``x`` ((n,) f32 tensor).

    ``state`` is this section's carried (x1, x2, s1, s2): the last two
    section INPUT samples and the two scan states at sample -1.
    Returns (y, new_state)."""
    n = x.shape[0]
    x1, x2, s1, s2 = state.unbind()
    kind, b0, b1, b2 = plan[0], plan[1], plan[2], plan[3]
    xm1 = torch.cat([x1[None], x])[:n]
    xm2 = torch.cat([x2[None], x1[None], x])[:n]
    fir = _f32(b0) * x + _f32(b1) * xm1 + _f32(b2) * xm2
    nx1, nx2 = x[n - 1], (x[n - 2] if n >= 2 else x1)
    if kind == "real":
        p, q = plan[4], plan[5]
        fir[0] += _f32(p) * s1
        y1 = pole_scan(fir, p)
        ns1 = y1[n - 1].clone()
        y1[0] += _f32(q) * s2
        y = pole_scan(y1, q)
        ns2 = y[n - 1]
    else:
        pre, pim, are, aim = plan[4], plan[5], plan[6], plan[7]
        u = torch.complex(fir, torch.zeros_like(fir))
        u[0] += _f32(complex(pre, pim)) * torch.complex(s1, s2)
        w = pole_scan(u, complex(pre, pim))
        y = 2.0 * (_f32(are) * w.real - _f32(aim) * w.imag)
        ns1, ns2 = w.real[n - 1], w.imag[n - 1]
    return y, torch.stack([nx1, nx2, ns1, ns2])


def _sosfilt_device(x, state, plans):
    """The cascade over a 1-D f32 tensor from the (n_sections, 4) ``state``
    on its device: (y, zf) tensors, no host sync."""
    zf = []
    for i, plan in enumerate(plans):
        x, s = _apply_section(x, state[i], plan)
        zf.append(s)
    return x, torch.stack(zf)


def sosfilt(sos, x, zi=None, *, return_zf=False, device=None):
    """Filter 1-D ``x`` through the SOS cascade on the device.

    ``zi``: optional (n_sections, 4) f32 carried state per section —
    ``(x[-1], x[-2], s1, s2)`` in this module's scan-state convention
    (NOT scipy's direct-form-II state).  Build it with
    :func:`sosfilt_zi_step` or carry it from a previous call's ``zf``.
    Returns host float32 (and the host ``zf`` with ``return_zf``).
    """
    sos = np.atleast_2d(np.asarray(sos, float))
    plans = _section_plan(sos)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.float32)
    if x.ndim != 1:
        raise ValueError(f"sosfilt expects 1-D input, got shape "
                         f"{tuple(x.shape)}")
    if len(x) == 0:
        raise ValueError("sosfilt: empty input")
    x = as_f32(x, device)
    state = (torch.zeros((len(plans), 4), dtype=torch.float32,
                         device=x.device) if zi is None
             else as_f32(zi, x.device))
    if state.shape != (len(plans), 4):
        raise ValueError(
            f"zi shape {tuple(state.shape)} != ({len(plans)}, 4)")
    y, zf = _sosfilt_device(x, state, plans)
    y = y.cpu().numpy()
    return (y, zf.cpu().numpy()) if return_zf else y


def sosfilt_streamed(sos, x, *, chunk=1 << 21, device=None):
    """Exact chunked :func:`sosfilt` — sequential scans carrying the
    per-section state on the device, O(chunk) device memory at any
    length."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.float32)
    if len(x) <= chunk:
        return sosfilt(sos, x, device=device)
    plans = _section_plan(np.atleast_2d(np.asarray(sos, float)))
    dev = target_device(x, device)
    out = np.empty(len(x), np.float32)
    state = torch.zeros((len(plans), 4), dtype=torch.float32, device=dev)
    for a in range(0, len(x), chunk):
        seg = as_f32(x[a:a + chunk], dev)
        y, state = _sosfilt_device(seg, state, plans)
        out[a:a + len(seg)] = y.cpu().numpy()
    return out


def sosfilt_zi_step(sos, c=1.0):
    """Steady-state carried state for a constant input ``c`` (host f64).

    The per-section analogue of ``scipy.signal.sosfilt_zi`` in this
    module's state convention; used by :func:`filtfilt` to suppress
    edge transients the way scipy's pad method does.
    """
    sos = np.atleast_2d(np.asarray(sos, float))
    plans = _section_plan(sos)
    state = np.zeros((len(plans), 4), np.float32)
    v = float(c)
    for i, plan in enumerate(plans):
        kind, b0, b1, b2 = plan[0], plan[1], plan[2], plan[3]
        fir_ss = v * (b0 + b1 + b2)
        if kind == "real":
            p, q = plan[4], plan[5]
            s1 = fir_ss / (1.0 - p)
            s2 = s1 / (1.0 - q)
            y_ss = s2
        else:
            pre, pim, are, aim = plan[4], plan[5], plan[6], plan[7]
            w = complex(fir_ss) / (1.0 - complex(pre, pim))
            s1, s2 = w.real, w.imag
            y_ss = 2.0 * (are * w.real - aim * w.imag)
        state[i] = (v, v, s1, s2)
        v = y_ss
    return state

def filtfilt(sos, x, *, padlen=None, device=None):
    """Zero-phase forward-backward filtering (scipy ``sosfiltfilt``
    pad method: odd extension + step steady-state initial conditions).
    The extension is built on the host as in msv_tpu; both passes and the
    reversal between them stay on the device."""
    sos = np.atleast_2d(np.asarray(sos, float))
    dev = target_device(x, device)
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x = np.asarray(x, np.float32)
    if padlen is None:
        padlen = 3 * (2 * len(sos) + 1)
    if padlen >= len(x):
        raise ValueError(
            f"input length {len(x)} must exceed padlen {padlen}")
    if padlen:
        front = 2 * x[0] - x[padlen:0:-1]
        back = 2 * x[-1] - x[-2:-padlen - 2:-1]
        ext = np.concatenate([front, x, back])
    else:
        ext = x
    plans = _section_plan(sos)
    y, _ = _sosfilt_device(as_f32(ext, dev),
                           as_f32(sosfilt_zi_step(sos, ext[0]), dev), plans)
    y = y.flip(0)
    y, _ = _sosfilt_device(
        y, as_f32(sosfilt_zi_step(sos, y[0].cpu().numpy()), dev), plans)
    y = y.flip(0).cpu().numpy()
    return y[padlen:len(y) - padlen] if padlen else y


# ---------------------------------------------------------------------------
# FIR (host design + device conv)
# ---------------------------------------------------------------------------

def firwin(numtaps, cutoff, *, sr, window="hamming", pass_zero=True):
    """Window-method linear-phase FIR design (``scipy.signal.firwin``
    parity, pinned in tests): windowed ideal-bandsum sinc, normalized
    to unit gain at the band center."""
    if numtaps < 1:
        raise ValueError(f"numtaps must be >= 1, got {numtaps}")
    cutoff = np.atleast_1d(np.asarray(cutoff, float)) / (sr / 2.0)
    if np.any(cutoff <= 0) or np.any(cutoff >= 1):
        raise ValueError("cutoffs must be inside (0, sr/2)")
    if np.any(np.diff(cutoff) <= 0):
        raise ValueError("cutoffs must be strictly increasing")
    pass_nyq = bool(len(cutoff) % 2) ^ bool(pass_zero)
    if pass_nyq and numtaps % 2 == 0:
        raise ValueError("a filter passing Nyquist needs odd numtaps")
    bands = np.concatenate([
        [0.0] if pass_zero else [], cutoff, [1.0] if pass_nyq else []])
    bands = bands.reshape(-1, 2)
    m = np.arange(numtaps) - (numtaps - 1) / 2.0
    h = np.zeros(numtaps)
    for lo, hi in bands:
        h += hi * np.sinc(hi * m) - lo * np.sinc(lo * m)
    if window == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(numtaps)
                                 / (numtaps - 1)) if numtaps > 1 else \
            np.ones(1)
    elif window == "hann":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(numtaps)
                               / (numtaps - 1)) if numtaps > 1 else \
            np.ones(1)
    elif window == "blackman":
        t = 2 * np.pi * np.arange(numtaps) / (numtaps - 1) \
            if numtaps > 1 else np.zeros(1)
        w = 0.42 - 0.5 * np.cos(t) + 0.08 * np.cos(2 * t)
    else:
        raise ValueError(f"unknown window {window!r}")
    h *= w
    # normalize at the first passband's center (scipy's rule: DC for a
    # zero-anchored band, Nyquist for a Nyquist-anchored one)
    lo, hi = bands[0]
    if lo == 0.0:
        fc = 0.0
    elif hi == 1.0:
        fc = 1.0
    else:
        fc = (lo + hi) / 2
    s = np.sum(h * np.cos(np.pi * m * fc))
    return h / s

def fir_filter(x, taps, *, device=None):
    """'same'-mode FIR filtering as ONE device convolution (true f32:
    ``conv1d`` is a cross-correlation, so the taps are flipped, as msv_tpu
    flips them for ``conv_general_dilated``)."""
    x = as_f32(x, device)
    taps = as_f32(taps, x.device)
    ntaps = taps.shape[0]
    left = (ntaps - 1) // 2
    xp = torch.nn.functional.pad(x[None, None], (left, ntaps - 1 - left))
    with precision_for("parity"):
        y = torch.nn.functional.conv1d(xp, taps.flip(0)[None, None])
    return y[0, 0].cpu().numpy()
