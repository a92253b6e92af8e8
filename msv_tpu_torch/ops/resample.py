"""Rational sample-rate conversion (polyphase Kaiser-windowed sinc), ported
from ``msv_tpu/ops/resample.py``.

The reference never resamples: every track computes at its native rate
(audio.rs keeps sr per track) and the session aligns renders in the
frequency domain (lib.rs:231-248 up_ratio).  The resampler is the bridge to
the ML frontend, whose features are defined at one rate (16 kHz), and the
``resample`` command's converter.

msv_tpu runs the whole upfirdn (zero-stuff by ``up``, FIR lowpass, keep
every ``down``-th sample) as one dilated convolution.  The port runs its
polyphase form and never builds the zero-stuffed signal (for 44.1 -> 16 kHz,
``up`` is 160: a 240 s track stuffed would be 6.8 GB of f32): output ``i =
m * up + a`` is the correlation of the input, from sample ``m * down``, with
phase ``a``'s taps of the filter.  So one ``conv1d`` over the input with
``up`` output channels (each phase's taps, placed at its own input offset)
and stride ``down``, then the channels interleaved, gives every output
sample.  A channel's taps are about ``flen / up`` long; the offsets of the
``up`` phases spread over at most ``down`` input samples, so each channel's
kernel is ``flen / up + down`` wide, zeros included.  The memory is the
input and the output; the products are ``n_out * (flen / up + down)``.
The filter matches ``scipy.signal.resample_poly``'s default design in f64
(windowed sinc, kaiser beta 5.0, 10 taps per phase, unit DC gain), and the
convolution runs in true f32 (``precision_for("parity")``: TF32 off).
"""

import functools
import math

import numpy as np
import torch

from ..config import precision_for
from ..utils.device import as_f32


@functools.lru_cache(maxsize=64)
def _poly_filter(up: int, down: int, beta: float) -> np.ndarray:
    """scipy.signal.resample_poly's default filter, from scratch.

    Windowed-sinc lowpass at 1/max(up, down) x Nyquist, 10 taps per
    phase (half_len = 10 * max_rate), kaiser(beta) window, normalized to
    unit DC gain, scaled by ``up`` to preserve amplitude through the
    zero-stuffing.  f64 throughout (the design is host-side, one-time).
    """
    max_rate = max(up, down)
    half_len = 10 * max_rate
    n = 2 * half_len + 1
    m = np.arange(n, dtype=np.float64) - half_len
    h = np.sinc(m / max_rate) / max_rate * np.kaiser(n, beta)
    h /= h.sum()  # firwin's unit passband (DC) gain
    return (h * up).astype(np.float64)


@functools.lru_cache(maxsize=64)
def _polyphase_weights(up: int, down: int, beta: float):
    """((up, W) f32 taps, t_min): output ``m * up + a`` is the sum over tau
    of ``x[m * down + t_min + tau] * w[a, tau]`` (``x`` zero outside).

    The filter is msv_tpu's, centred as scipy centres it: the full
    convolution of the zero-stuffed input with ``h`` pre-padded by
    ``(-half_len) % down`` zeros, read at ``(n_pre_remove + i) * down``.
    Output ``i = m * up + a`` reads ``x[n]`` through tap ``K_a + m * up *
    down - n * up`` with ``K_a = (n_pre_remove + a) * down``, so with ``n =
    m * down + t`` through tap ``K_a - t * up`` whatever ``m``."""
    h = _poly_filter(up, down, beta)
    half_len = (len(h) - 1) // 2
    pre_pad = (-half_len) % down
    n_pre_remove = (half_len + pre_pad) // down
    hp = np.concatenate([np.zeros(pre_pad), h])
    flen = len(hp)
    k = (n_pre_remove + np.arange(up)) * down
    t_lo = -((flen - 1 - k) // up)  # ceil((k - flen + 1) / up)
    t_hi = k // up
    t_min = int(t_lo.min())
    w = np.zeros((up, int(t_hi.max()) - t_min + 1), np.float64)
    for a in range(up):
        t = np.arange(t_lo[a], t_hi[a] + 1)
        w[a, t - t_min] = hp[k[a] - t * up]
    return w.astype(np.float32), t_min


@functools.lru_cache(maxsize=64)
def _device_taps(up: int, down: int, beta: float, device):
    """The (up, 1, W) taps of ``_polyphase_weights`` on ``device``, shipped
    once: a copy from pageable memory would wait for the device at every
    call."""
    return torch.from_numpy(_polyphase_weights(up, down, beta)[0]).to(
        device)[:, None, :]


def resample_poly(x, up: int, down: int, *, beta: float = 5.0, device=None):
    """Resample the last axis by the rational factor ``up / down``.

    Mirrors ``scipy.signal.resample_poly(x, up, down)`` (default kaiser
    design, zero edge handling): output length ``ceil(n * up / down)``,
    filter centered so sample 0 maps to sample 0.  Takes a numpy array or
    a tensor of shape (..., n); returns an f32 tensor on ``device``.
    """
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError(f"up/down must be positive, got {up}/{down}")
    g = math.gcd(up, down)
    up, down = up // g, down // g
    x = as_f32(x, device)
    if x.ndim == 0 or x.shape[-1] < 2:
        raise ValueError(f"need at least 2 samples, got {tuple(x.shape)}")
    if up == 1 and down == 1:
        return x
    lead, n_in = x.shape[:-1], x.shape[-1]
    n_out = n_in * up // down + bool(n_in * up % down)
    w, t_min = _polyphase_weights(up, down, float(beta))
    width = w.shape[1]
    n_blocks = -(-n_out // up)
    need = (n_blocks - 1) * down + width
    # xp[j] = x[j + t_min], zero outside the signal
    x2 = x.reshape(-1, n_in)
    xp = x2.new_zeros((x2.shape[0], 1, need))
    lo, src = max(0, -t_min), max(0, t_min)
    take = min(n_in - src, need - lo)
    if take > 0:
        xp[:, 0, lo:lo + take] = x2[:, src:src + take]
    taps = _device_taps(up, down, float(beta), x.device)
    with precision_for("parity"):
        y = torch.nn.functional.conv1d(xp, taps, stride=down)  # (B, up, M)
    y = y.transpose(1, 2).reshape(x2.shape[0], n_blocks * up)[:, :n_out]
    return y.reshape(*lead, n_out)


def resample(x, sr_in: int, sr_out: int, *, beta: float = 5.0, device=None):
    """Convert the last axis from ``sr_in`` to ``sr_out`` Hz.

    ``resample(wav, 48000, 16000)`` is the bridge from session-native
    audio to the 16 kHz ML frontend.
    """
    if sr_in <= 0 or sr_out <= 0:
        raise ValueError(f"rates must be positive, got {sr_in}->{sr_out}")
    g = math.gcd(int(sr_in), int(sr_out))
    return resample_poly(x, int(sr_out) // g, int(sr_in) // g, beta=beta,
                         device=device)


def resample_streamed(x, sr_in: int, sr_out: int, *, seg_s: float = 30.0,
                      beta: float = 5.0, device=None) -> np.ndarray:
    """:func:`resample`, segment-at-a-time: same values, bounded memory.

    Splits the input into fixed ``seg_s``-second segments plus filter
    context on both sides and runs each through :func:`resample_poly` on
    ``device``.  The FIR's input reach from any output sample is bounded by
    ``half_len / up`` and upfirdn is shift-invariant under input shifts of
    ``down`` (output shifts of ``up``), so each segment sees exactly the
    samples the one-shot computation would use; edge segments see the same
    zero extension scipy assumes.  The segment plan (context, segment
    length, output offsets) is msv_tpu's.  Values agree with the one-shot
    op to a few f32 ulp (convolutions of other lengths may sum the taps in
    another order).  Device memory holds one segment.  Returns host float32
    (..., ceil(n * up / down)).
    """
    if sr_in <= 0 or sr_out <= 0:
        raise ValueError(f"rates must be positive, got {sr_in}->{sr_out}")
    if seg_s <= 0:
        raise ValueError(f"seg_s must be positive, got {seg_s}")
    g = math.gcd(int(sr_in), int(sr_out))
    up, down = int(sr_out) // g, int(sr_in) // g
    if isinstance(x, torch.Tensor):
        device = device or x.device
        x = x.detach().cpu().numpy()
    x = np.asarray(x, np.float32)
    n_in = x.shape[-1]
    if n_in < 2:
        raise ValueError(f"need at least 2 samples, got {x.shape}")
    if up == 1 and down == 1:
        return x
    n_out = n_in * up // down + bool(n_in * up % down)

    # context (input samples, multiple of `down` so segment-local output
    # offsets stay integral): the filter reaches half_len/up input
    # samples from an output's center; + down covers the decimation
    # grid's worst-case phase
    half_len = 10 * max(up, down)
    ctx = -(-(half_len + down) // up)
    ctx = -(-ctx // down) * down
    seg = max(int(seg_s * sr_in), down)
    seg = -(-seg // down) * down
    if n_in <= seg + 2 * ctx:  # one-shot is already this small
        return resample_poly(x, up, down, beta=beta,
                             device=device).cpu().numpy()

    lead = x.shape[:-1]
    x2 = x.reshape(-1, n_in)
    n_segs = -(-n_in // seg)
    padded = np.zeros((x2.shape[0], ctx + n_segs * seg + ctx), np.float32)
    padded[:, ctx:ctx + n_in] = x2
    out_per_seg = seg * up // down
    o = ctx // down * up
    out = np.empty((x2.shape[0], n_segs * out_per_seg), np.float32)
    for i in range(n_segs):
        y = resample_poly(padded[:, i * seg:(i + 1) * seg + 2 * ctx],
                          up, down, beta=beta, device=device)
        out[:, i * out_per_seg:(i + 1) * out_per_seg] = (
            y[:, o:o + out_per_seg].cpu().numpy())
    return out[:, :n_out].reshape(*lead, n_out)
