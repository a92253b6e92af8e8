"""Cross-track time alignment, ported from ``msv_tpu/ops/align.py``:
coarse normalized cross-correlation of RMS envelopes, then GCC-PHAT
refinement.

1. **Coarse** (any lag up to ``max_lag_s``): RMS envelopes at ~100 fps
   (``ops/effects.py::_frame_rms``), zero-meaned; the normalized
   cross-correlation over every lag is one grouped ``conv1d`` (blocks of
   one envelope against sliding windows of the other, framed by a strided
   view, ``groups=n_blocks``; ``conv1d`` correlates, as msv_tpu's
   convolution does, so the taps are not flipped) and a sliding-energy
   ``conv1d`` of the same shape normalizes per-lag overlap.
2. **Refine** (sub-sample): after shifting by the coarse estimate,
   GCC-PHAT on the overlap: Hann-windowed real-DFT GEMM pairs, the
   per-frame phase transform of ``conj(Xa) Xb``, the mean over frames,
   one inverse rDFT, parabolic peak interpolation.

Every convolution and GEMM runs in true f32 (``precision_for("parity")``:
TF32 off in cuBLAS and cuDNN), as msv_tpu's unqualified dots and
convolutions are on its CPU reference.  Sign convention: ``offset_s > 0``
means ``b``'s content happens LATER, ``b(t + offset_s) ~ a(t)``.  Rates may
differ: both sides resample to a common working rate first
(``ops/resample.py``, on the device).  msv_tpu bucketed the block count to
8 and the refinement frames to 128 (zero blocks and masked frames); the
port runs the true counts.  ``AlignResult`` and ``_parabolic`` are copies
of msv_tpu's, pinned by tests/test_torch_host.py.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import precision_for
from ..utils import round_up_to
from .dft import inverse_rdft, windowed_dft_matrices
from .stft import frame_device
from .windows import hann

__all__ = ["align_offset", "AlignResult"]


class AlignResult(NamedTuple):
    offset_s: float      # b(t + offset_s) ≈ a(t)
    confidence: float    # coarse NCC peak: ~1 same material, ~0 unrelated
    coarse_s: float      # envelope-stage estimate (for diagnostics)


_ENV_FPS = 100           # coarse envelope rate
_BLOCK = 4096            # grouped-conv block width (envelope samples)
_REFINE_WIN = 4096       # GCC frame length at the working rate
_REFINE_NFFT = 8192      # zero-padded, so ±win/2 lags are acyclic
_REFINE_HOP = 2048
_MAX_REFINE_FRAMES = 512


def _lag_corr_core(a_pad, b_blocks, mask_blocks, *, n_blocks, w, b):
    """corr[k] = sum_t a_pad[t+k] b[t] and slide[k] = sum_t a_pad[t+k]^2
    1[t<Tb] for k in [0, w-b], as two grouped convolutions over blocks."""
    frames = frame_device(a_pad, w, b, n_blocks)          # (n_blocks, w)
    lhs = frames[None]                                    # (1, nb, w)
    with precision_for("parity"):
        corr = torch.nn.functional.conv1d(
            lhs, b_blocks[:, None, :], groups=n_blocks)[0]  # (nb, w-b+1)
        slide = torch.nn.functional.conv1d(
            lhs * lhs, mask_blocks[:, None, :], groups=n_blocks)[0]
    return corr.sum(0), slide.sum(0)


def _envelope(x: np.ndarray, sr: int, device) -> np.ndarray:
    from .effects import _frame_rms

    hop = max(1, sr // _ENV_FPS)
    env = _frame_rms(np.asarray(x, np.float32), 2 * hop, hop, device)
    return env - float(env.mean())


def _coarse_lag(ea: np.ndarray, eb: np.ndarray, max_lag: int, device):
    """Best lag k* of ``eb`` inside ``ea`` over k in [-max_lag, max_lag]
    (in envelope frames) by overlap-normalized cross-correlation."""
    # round the half-width so 2K is a _BLOCK multiple, as msv_tpu does
    k = round_up_to(max(max_lag, 1), _BLOCK // 2)
    tb = len(eb)
    n_blocks = max(1, -(-tb // _BLOCK))
    tb_pad = n_blocks * _BLOCK
    w = _BLOCK + 2 * k
    need = tb_pad + 2 * k
    a_pad = np.zeros(need, np.float32)
    a_pad[k:k + min(len(ea), tb_pad + k)] = ea[:tb_pad + k]
    b_blocks = np.zeros(tb_pad, np.float32)
    b_blocks[:tb] = eb
    mask = np.zeros(tb_pad, np.float32)
    mask[:tb] = 1.0
    corr, slide = _lag_corr_core(
        *(torch.from_numpy(v).to(device) for v in (
            a_pad, b_blocks.reshape(n_blocks, _BLOCK),
            mask.reshape(n_blocks, _BLOCK))),
        n_blocks=n_blocks, w=w, b=_BLOCK)
    corr, slide = corr.cpu().numpy(), slide.cpu().numpy()
    nb = float(np.sqrt(np.sum(eb * eb))) or 1.0
    ncc = corr / (np.sqrt(np.maximum(slide, 1e-12)) * nb)
    # restrict to the caller's actual lag range (k was rounded up)
    lo, hi = k - max_lag, k + max_lag + 1
    ncc_win = ncc[lo:hi]
    i = int(np.argmax(ncc_win))
    return i - max_lag, float(ncc_win[i])


def _parabolic(y3) -> float:
    y0, y1, y2 = (float(v) for v in y3)
    denom = y0 - 2.0 * y1 + y2
    if abs(denom) < 1e-12:
        return 0.0
    return float(np.clip(0.5 * (y0 - y2) / denom, -1.0, 1.0))


def _gcc_phat_core(fa, fb, c, s):
    """Mean per-frame PHAT-weighted cross-spectrum -> (n_fft,) GCC."""
    n_true = fa.shape[0]
    with precision_for("parity"):
        xar, xai = fa @ c, fa @ s
        xbr, xbi = fb @ c, fb @ s
        # conj(Xa) Xb: peak index of the inverse transform = delay of b
        rre = xar * xbr + xai * xbi
        rim = xar * xbi - xai * xbr
        mag = torch.sqrt(rre * rre + rim * rim) + 1e-12
        scale = 1.0 / (mag * n_true)
        mre = torch.sum(rre * scale, dim=0)
        mim = torch.sum(rim * scale, dim=0)
        return inverse_rdft((mre, mim), _REFINE_NFFT)


def _refine(a: np.ndarray, b: np.ndarray, sr: int, search: int, device):
    """Sub-sample GCC-PHAT delay of ``b`` vs ``a`` (both already
    coarse-aligned), searched over +-``search`` samples.  Returns
    (delay_samples, peak_value)."""
    win, hop, n_fft = _REFINE_WIN, _REFINE_HOP, _REFINE_NFFT
    t = min(len(a), len(b))
    if t < win:
        pad = win - t
        a = np.pad(a[:t], (0, pad))
        b = np.pad(b[:t], (0, pad))
        t = win
    n_true = min(1 + (t - win) // hop, _MAX_REFINE_FRAMES)
    # center the analyzed span for the frame budget
    if 1 + (t - win) // hop > n_true:
        start = ((1 + (t - win) // hop - n_true) // 2) * hop
        a, b = a[start:], b[start:]
    need = (n_true - 1) * hop + win
    a = np.pad(a, (0, max(0, need - len(a))))[:need]
    b = np.pad(b, (0, max(0, need - len(b))))[:need]
    c, s = (torch.from_numpy(m).to(device)
            for m in windowed_dft_matrices(hann(win), n_fft))
    fa, fb = (frame_device(torch.from_numpy(np.ascontiguousarray(
        v, np.float32)).to(device), win, hop, n_true) for v in (a, b))
    gcc = _gcc_phat_core(fa, fb, c, s).cpu().numpy()
    # circular lags: index l = delay l, index n_fft-l = delay -l
    search = int(min(search, win // 2 - 1))
    lags = np.arange(-search, search + 1)
    vals = gcc[lags % n_fft]
    i = int(np.argmax(vals))
    frac = _parabolic(vals[max(i - 1, 0):i + 2]) if 0 < i < len(vals) - 1 \
        else 0.0
    return float(lags[i]) + frac, float(vals[i])


def align_offset(a, sr_a: int, b, sr_b: int, *, max_lag_s: float = 30.0,
                 work_sr: int | None = None, refine: bool = True,
                 device=None) -> AlignResult:
    """Estimate how much later ``b``'s content occurs than ``a``'s.

    ``a``/``b``: (T,) mono float arrays at ``sr_a``/``sr_b`` (rates may
    differ).  Searches offsets in +-``max_lag_s`` seconds on ``device``
    (default the card; "cpu" runs the plain ops).  Precision: ~1/``work_sr``
    with ``refine=True`` (default: the smaller of the two rates, capped at
    16 kHz), ~10 ms without.
    """
    a = np.asarray(a, np.float32).reshape(-1)
    b = np.asarray(b, np.float32).reshape(-1)
    if not len(a) or not len(b):
        raise ValueError("align_offset: empty input")
    if max_lag_s <= 0:
        raise ValueError(f"max_lag_s must be positive, got {max_lag_s}")
    if work_sr is None:
        work_sr = min(int(sr_a), int(sr_b), 16000)
    if work_sr < 2 * _ENV_FPS:
        raise ValueError(f"work_sr too low: {work_sr}")
    device = torch.device(device or "cuda")
    from .resample import resample

    if sr_a != work_sr:
        a = resample(a, int(sr_a), work_sr, device=device).cpu().numpy()
    if sr_b != work_sr:
        b = resample(b, int(sr_b), work_sr, device=device).cpu().numpy()

    hop = max(1, work_sr // _ENV_FPS)
    max_lag = max(1, int(math.ceil(max_lag_s * work_sr / hop)))
    lag_env, conf = _coarse_lag(_envelope(a, work_sr, device),
                                _envelope(b, work_sr, device), max_lag,
                                device)
    # _coarse_lag peaks at l with eb[t] ~ ea[t+l]; a delayed copy
    # eb[t] = ea[t-d] peaks at l = -d, so b is later by -l frames
    coarse = -lag_env * hop  # samples at work_sr; b later by `coarse`
    coarse_s = coarse / work_sr
    if not refine:
        return AlignResult(coarse_s, conf, coarse_s)

    # shift b back by the coarse offset, refine on the overlap
    if coarse >= 0:
        a2, b2 = a, b[coarse:]
    else:
        a2, b2 = a[-coarse:], b
    delay, _peak = _refine(a2, b2, work_sr, 4 * hop, device)
    total = (coarse + delay) / work_sr
    return AlignResult(float(total), conf, float(coarse_s))
