"""Linear predictive coding, ported from ``msv_tpu/ops/lpc.py``: all-pole
spectral envelope and formant tracks.

  * the per-frame autocorrelation at lags 0..p is Wiener-Khinchin: one
    end-padded Hamming-windowed real-DFT GEMM pair -> power -> one inverse
    rDFT, lags sliced to [0, p] (``n_fft >= win + p`` keeps the linear ACF
    free of circular aliasing), in true f32 (``precision_for("parity")``,
    as msv_tpu's HIGHEST);
  * Levinson-Durbin is a Python loop over the order (10-50 steps), each
    step elementwise across all frames; the coefficient and lag reversals
    are plain slices of a zero-extended, flipped copy.  The reflection
    clamp at +-0.9999 and the 1e-6 ridge on the zero lag are msv_tpu's;
  * the envelope |G|^2/|A(e^{jw})|^2 on a frequency grid is one
    (frames, p+1) x (p+1, n_grid) GEMM pair;
  * formants: local maxima of the grid envelope, the K lowest-frequency
    ones by ``topk`` of +inf-masked bin indices (NaN where a frame has
    fewer), refined by a 3-point parabola in log-power.

msv_tpu padded the frame count to 128 (its compile cache); the port runs
the exact count.  ``_eval_grid_matrices`` and ``_prep_signal`` are copies
of msv_tpu's host code, pinned by tests/test_torch_host.py.
"""

import functools
import math

import numpy as np
import torch

from ..config import precision_for
from ..utils import next_pow2
from ..utils.device import as_f32, target_device
from .dft import end_padded_rdft_matrices, inverse_rdft
from .stft import frame_device
from .windows import hamming


def _levinson(r, order: int):
    """Batched Levinson-Durbin: Toeplitz(r[:order]) a[1:] = -r[1:].

    ``r``: (N, order+1) autocorrelation rows.  Returns ``(a, g2)`` with
    ``a`` (N, order+1), ``a[:, 0] == 1`` (prediction polynomial
    A(z) = 1 + a1 z^-1 + ... + ap z^-p) and ``g2`` (N,) the prediction
    error power.  All-zero rows (digital silence) return a = [1, 0, ...]
    and g2 ~ 1e-30 (the clamped zero lag), as msv_tpu's.
    """
    n, p1 = r.shape
    assert p1 == order + 1
    # normalize by r0 for conditioning; ridge the zero lag so the system
    # is strictly positive definite even for pure sinusoids
    r0 = torch.clamp(r[:, :1], min=1e-30)
    rn = r / r0
    rn = torch.cat([torch.full((n, 1), 1.0 + 1e-6, dtype=torch.float32,
                               device=r.device), rn[:, 1:]], dim=1)
    rf_ext = torch.cat([rn.flip(1), torch.zeros_like(rn)], dim=1)
    a = torch.zeros((n, p1), dtype=torch.float32, device=r.device)
    a[:, 0] = 1.0
    err = rn[:, 0]
    for m in range(1, order + 1):
        # v[i] = rn[m - i] (zeros for i > m): a slice of the reversed lags
        v = rf_ext[:, p1 - 1 - m: 2 * p1 - 1 - m]
        acc = torch.sum(a * v, dim=1)  # a_i == 0 for i >= m by induction
        # |reflection| < 1 holds for an exact PD system; the clamp makes
        # f32 rounding on near-singular frames degrade gracefully instead
        # of driving err negative and the recursion to NaN
        lam = torch.clamp(-acc / err, -0.9999, 0.9999)
        # u[i] = a[m - i] (zeros for i > m): the same slice of the coeffs
        a_ext = torch.cat([a.flip(1), torch.zeros_like(a)], dim=1)
        u = a_ext[:, p1 - 1 - m: 2 * p1 - 1 - m]
        a = a + lam[:, None] * u
        err = torch.clamp(err * (1.0 - lam * lam), min=1e-12)
    return a, err * r0[:, 0]


def _lpc_core(padded, cw, sw, *, win, hop, n_frames, n_fft, order):
    frames = frame_device(padded, win, hop, n_frames)
    with precision_for("parity"):
        re = frames @ cw
        im = frames @ sw
        power = re * re + im * im
        # Wiener-Khinchin: irfft(|X|^2) is the (windowed) linear ACF for
        # lags < n_fft - win
        r = inverse_rdft((power, torch.zeros_like(power)),
                         n_fft)[:, : order + 1]
    return _levinson(r, order)


def _envelope_core(a, g2, cg, sg):
    with precision_for("parity"):
        are = a @ cg
        aim = a @ sg
    denom = torch.clamp(are * are + aim * aim, min=1e-20)
    return g2[:, None] / denom


@functools.lru_cache(maxsize=16)
def _eval_grid_matrices(order: int, n_grid: int, w_max: float):
    """A(e^{jw}) evaluation matrices on ``n_grid`` points of [0, w_max]:
    (order+1, n_grid) cos / -sin of w*k."""
    k = np.arange(order + 1, dtype=np.float64)[:, None]
    w = np.linspace(0.0, w_max, n_grid, dtype=np.float64)[None, :]
    return (np.cos(w * k).astype(np.float32),
            (-np.sin(w * k)).astype(np.float32))


def _prep_signal(wav, preemphasis: float):
    wav = np.asarray(wav, np.float32)
    if wav.ndim != 1:
        raise ValueError(f"wav must be 1-D, got {wav.shape}")
    if len(wav) < 2:
        raise ValueError("signal too short for LPC")
    if preemphasis:
        wav = np.concatenate(
            [wav[:1], wav[1:] - np.float32(preemphasis) * wav[:-1]]
        )
    return wav


def lpc(
    wav,
    *,
    order: int,
    frame_length: int = 1024,
    hop_length: int | None = None,
    preemphasis: float = 0.0,
    device=None,
):
    """Per-frame LPC coefficients by the autocorrelation method.

    Centered Hamming-windowed frames (half-frame zero pad at the edges,
    hop default ``frame_length//4``).  Returns ``(a, g2, hop)`` where ``a``
    is an (n_frames, order+1) float32 tensor with ``a[:, 0] == 1`` and
    ``g2`` (n_frames,) is the prediction-error power.  ``wav``: numpy (to
    the card unless ``device`` says otherwise) or a tensor (on its own
    device).
    """
    if not (0 < order < frame_length):
        raise ValueError(f"need 0 < order < frame_length, got {order}")
    if hop_length is None:
        hop_length = frame_length // 4
    if hop_length < 1:
        raise ValueError(f"hop_length must be >= 1, got {hop_length}")
    dev = target_device(wav, device)
    if isinstance(wav, torch.Tensor):  # pre-emphasis on the host, as msv_tpu
        wav = wav.cpu().numpy()
    wav = as_f32(_prep_signal(wav, preemphasis), dev)
    half = frame_length // 2
    n = wav.shape[0]
    n_frames = 1 + (n + 2 * half - frame_length) // hop_length
    need = (n_frames - 1) * hop_length + frame_length
    padded = wav.new_zeros(max(need, half + n))
    padded[half: half + n] = wav

    n_fft = next_pow2(frame_length + order + 1)
    cw, sw = end_padded_rdft_matrices(frame_length, n_fft)
    win = hamming(frame_length).astype(np.float64)
    cw = (win[:, None] * cw).astype(np.float32)
    sw = (win[:, None] * sw).astype(np.float32)
    a, g2 = _lpc_core(
        padded, torch.from_numpy(cw).to(wav.device),
        torch.from_numpy(sw).to(wav.device), win=frame_length,
        hop=hop_length, n_frames=n_frames, n_fft=n_fft, order=order,
    )
    return a, g2, hop_length


def _grid(order, n_grid, device):
    return tuple(torch.from_numpy(m).to(device)
                 for m in _eval_grid_matrices(order, n_grid, math.pi))


def lpc_envelope_db(
    wav,
    sr: int,
    *,
    order: int | None = None,
    frame_length: int = 1024,
    hop_length: int | None = None,
    n_grid: int = 513,
    preemphasis: float = 0.0,
    amin: float = 1e-20,
    device=None,
):
    """All-pole spectral envelope in dB on ``n_grid`` points of [0, sr/2]:
    ((n_frames, n_grid) float32 tensor, hop).

    ``order`` defaults to the classic ``2 + sr/1000`` rule of thumb.  The
    absolute scale is the AR-model PSD (prediction-error power over
    |A|^2), the smooth envelope of the windowed periodogram.
    """
    if order is None:
        order = int(2 + sr / 1000)
    a, g2, hop = lpc(
        wav, order=order, frame_length=frame_length,
        hop_length=hop_length, preemphasis=preemphasis, device=device,
    )
    env = _envelope_core(a, g2, *_grid(order, n_grid, a.device))
    return 10.0 * torch.log10(torch.clamp(env, min=float(
        np.float32(amin)))), hop


def _formant_core(a, g2, cg, sg, step, fmask, *, n_grid, n_formants):
    env = _envelope_core(a, g2, cg, sg)
    loge = torch.log(torch.clamp(env, min=float(np.float32(1e-30))))
    prev, mid, nxt = loge[:, :-2], loge[:, 1:-1], loge[:, 2:]
    is_peak = (mid > prev) & (mid >= nxt) & fmask[None, 1:-1]
    # keep the K lowest-FREQUENCY peaks, in order: the K smallest of the
    # +inf-masked bin indices
    idx = torch.arange(1, n_grid - 1, dtype=torch.float32, device=a.device)
    keys = torch.where(is_peak, idx[None, :], float("inf"))
    picked = torch.topk(keys, min(n_formants, keys.shape[1]), dim=1,
                        largest=False, sorted=True).values
    valid = torch.isfinite(picked)
    pick_i = torch.where(valid, picked, 1.0).to(torch.int64)

    def take(off):
        return torch.gather(loge, 1, pick_i + off)

    va, vb, vc = take(-1), take(0), take(1)
    den = va - 2.0 * vb + vc
    shift = torch.where(torch.abs(den) > 1e-12,
                        torch.clamp(0.5 * (va - vc) / den, -0.5, 0.5),
                        torch.zeros_like(den))
    f_hz = (pick_i.to(torch.float32) + shift) * step
    return torch.where(valid, f_hz, float("nan"))


def formant_track(
    wav,
    sr: int,
    *,
    n_formants: int = 5,
    fmax: float = 5500.0,
    order: int | None = None,
    frame_length_s: float = 0.025,
    hop_length_s: float = 0.010,
    preemphasis: float | None = None,
    n_grid: int = 1024,
    device=None,
):
    """Praat-style formant tracking: ((n_frames, n_formants) Hz tensor, NaN
    where fewer peaks exist, hop_s, t0_s).

    The Praat recipe with autocorrelation LPC: resample to 2*``fmax`` on
    the device (the analysis bandwidth caps the highest formant),
    pre-emphasize ~50 Hz, order ``2*n_formants``, pick peaks in
    [50, fmax-50] Hz ordered by frequency.  Frames are centered, so frame i
    is at ``t0_s + i*hop_s`` with ``t0_s = 0``.
    """
    if n_formants < 1:
        raise ValueError("n_formants must be >= 1")
    if not (200.0 <= fmax <= sr * 4):
        raise ValueError(f"fmax {fmax} out of range")
    if np.ndim(wav) != 1:
        raise ValueError(f"wav must be 1-D, got {tuple(np.shape(wav))}")
    wav = as_f32(wav, device)
    sr_a = int(round(2 * fmax))
    if sr_a < sr:
        from .resample import resample

        wav = resample(wav, sr, sr_a)
    else:
        sr_a = sr
    if preemphasis is None:
        # Praat: +6 dB/oct above 50 Hz
        preemphasis = math.exp(-2.0 * math.pi * 50.0 / sr_a)
    if order is None:
        order = 2 * n_formants
    frame_length = max(int(round(frame_length_s * sr_a)), order + 2)
    hop_length = max(int(round(hop_length_s * sr_a)), 1)
    a, g2, hop = lpc(
        wav, order=order, frame_length=frame_length,
        hop_length=hop_length, preemphasis=preemphasis,
    )
    fgrid = np.linspace(0.0, sr_a / 2.0, n_grid, dtype=np.float32)
    fmask = (fgrid > 50.0) & (fgrid < min(fmax, sr_a / 2.0) - 50.0)
    f = _formant_core(
        a, g2, *_grid(order, n_grid, a.device),
        float(fgrid[1] - fgrid[0]), torch.from_numpy(fmask).to(a.device),
        n_grid=n_grid, n_formants=n_formants,
    )
    return f, hop / sr_a, 0.0
