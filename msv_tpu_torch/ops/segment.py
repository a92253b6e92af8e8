"""Structure segmentation, ported from ``msv_tpu/ops/segment.py``:
self-similarity, Foote novelty, boundaries.

The self-similarity matrix is one GEMM of L2-normalized feature rows.
Foote's Gaussian-tapered checkerboard kernel is separable, ``K = u u^T``
with ``u = gauss * sign``, so the sliding quadratic form ``nov[t] = u^T
S[t-L:t+L, t-L:t+L] u`` is ``sum(U * (S U), axis=0)`` with U the (T, T)
band ``U[t+i, t] = u_i``: one more GEMM and an elementwise reduce.  The
band is built on the device per call, one ``fill_`` of a diagonal view per
offset (2L launches, no host loop over rows).  Both GEMMs run in
``precision_for("parity")``; "fast" rounds their operands to bf16 first,
as ``features._rounder`` does.  At the hour's size (7 200 pooled frames)
the matrix and the band are 207 MB each in f32; ``MAX_SSM_FRAMES`` caps T.

``segment`` takes its log-mel frames from
:func:`msv_tpu_torch.features.log_mel_spectrogram`, which launches the mel
kernel of the chosen precision (bf16 fast by default), pools and centers
them on the device, and picks peaks on the host with
``features._peak_pick``.  msv_tpu padded T to 128 (its compile cache); the
padded rows and columns of its band only met zero rows of the padded
matrix, so the port's exact T gives the same novelty.  ``_checker_u`` and
``oracle_novelty_np`` are copies of msv_tpu's host code, pinned by
tests/test_torch_host.py.
"""

import numpy as np
import torch

from ..config import precision_for
from ..utils.device import as_f32

MAX_SSM_FRAMES = 8192  # (T, T) f32 = 256 MB at the cap


def _ssm_core(feats, *, mode):
    from ..features import _rounder

    rnd = _rounder(mode)
    norm = torch.sqrt(torch.sum(feats * feats, dim=1, keepdim=True))
    unit = rnd(feats / torch.clamp(norm, min=1e-12))
    with precision_for("parity"):
        return unit @ unit.T


def _novelty_core(ssm, u_band, *, mode):
    from ..features import _rounder

    rnd = _rounder(mode)
    with precision_for("parity"):
        m = rnd(ssm) @ rnd(u_band)
    return torch.sum(u_band * m, dim=0)


def self_similarity(feats, *, precision: str | None = None, device=None):
    """Cosine self-similarity of feature frames: (T, D) -> (T, T) f32
    tensor in [-1, 1] (ones on the diagonal for nonzero frames).  ``feats``:
    numpy (to the card unless ``device`` says otherwise) or a tensor (on
    its own device)."""
    from ..features import _check_precision

    precision = _check_precision(precision)
    if np.ndim(feats) != 2:
        raise ValueError(f"feats must be (T, D), got {np.shape(feats)}")
    t = np.shape(feats)[0]
    if t < 1:
        raise ValueError("empty feature sequence")
    if t > MAX_SSM_FRAMES:
        raise ValueError(
            f"{t} frames exceeds MAX_SSM_FRAMES={MAX_SSM_FRAMES}; pool "
            "the features coarser (see novelty(pool=...))")
    return _ssm_core(as_f32(feats, device), mode=precision)


def _checker_u(kernel_size: int) -> np.ndarray:
    """Half of the separable checkerboard: Gaussian taper times sign.
    ``kernel_size`` = L half-width; u has 2L entries for offsets
    -L..L-1 (no zero-offset row: the checkerboard is antisymmetric
    around the evaluation point)."""
    off = np.arange(-kernel_size, kernel_size, dtype=np.float64) + 0.5
    g = np.exp(-0.5 * (off / (kernel_size / 2.0)) ** 2)
    return (g * np.sign(off)).astype(np.float32)


def checker_band(t: int, kernel_size: int, device):
    """The (t, t) band ``U[c + off, c] = u[off + L]`` for offsets -L..L-1,
    built on ``device`` one diagonal at a time."""
    u = _checker_u(kernel_size)
    band = torch.zeros((t, t), dtype=torch.float32, device=device)
    for i, ui in enumerate(u):
        off = i - kernel_size
        if abs(off) < t:  # U[r, c] with r - c = off: diagonal -off
            band.diagonal(-off).fill_(float(ui))
    return band


def novelty_from_ssm(ssm, *, kernel_size: int = 16,
                     precision: str | None = None, device=None):
    """Foote checkerboard novelty of a (T, T) self-similarity matrix ->
    (T,) f32 host array, >= 0, on an ABSOLUTE scale: the kernel is
    normalized so a perfect boundary between internally-coherent,
    mutually-orthogonal blocks scores ~2 (each quadrant sum is divided by
    the taper mass; homogeneous similarity cancels to ~0).
    ``kernel_size`` is the half-width L in frames (the kernel spans 2L).
    The first/last L values are ZEROED: there the truncated checkerboard
    loses its cancellation and a homogeneous block would read as a
    spurious full-strength edge.  The absolute scale is what lets
    :func:`segment_boundaries` threshold without max-normalizing."""
    from ..features import _check_precision

    precision = _check_precision(precision)
    if np.ndim(ssm) != 2 or np.shape(ssm)[0] != np.shape(ssm)[1]:
        raise ValueError(f"ssm must be square, got {np.shape(ssm)}")
    t = np.shape(ssm)[0]
    if kernel_size < 2:
        raise ValueError(f"kernel_size must be >= 2, got {kernel_size}")
    if t < 2 * kernel_size:
        return np.zeros(t, np.float32)
    ssm = as_f32(ssm, device)
    u = _checker_u(kernel_size)
    nov = _novelty_core(ssm, checker_band(t, kernel_size, ssm.device),
                        mode=precision).cpu().numpy()
    nov = nov / (np.abs(u).sum() / 2.0) ** 2  # per-quadrant taper mass
    nov[:kernel_size] = 0.0
    nov[-kernel_size:] = 0.0
    return np.maximum(nov, 0.0)


def segment_boundaries(feats, *, kernel_size: int = 16,
                       delta: float = 0.1, min_gap: int | None = None,
                       precision: str | None = None, device=None):
    """Novelty-peak segment boundaries from feature frames: (T, D) ->
    ascending frame indices (int64).  ``delta`` is the required rise of a
    peak above its local mean on the novelty curve's ABSOLUTE scale (~2 at
    a perfect boundary, ~0 inside a homogeneous section); ``min_gap``
    frames between boundaries (default ``kernel_size``)."""
    from ..features import _peak_pick

    ssm = self_similarity(feats, precision=precision, device=device)
    nov = novelty_from_ssm(ssm, kernel_size=kernel_size,
                           precision=precision)
    del ssm
    if float(nov.max()) <= 0.0:
        return np.empty(0, np.int64)
    gap = kernel_size if min_gap is None else int(min_gap)
    return _peak_pick(nov, pre_max=gap, post_max=gap, pre_avg=2 * gap,
                      post_avg=2 * gap, delta=float(delta), wait=gap)


def segment(wav, sr: int, *, hop_s: float = 0.5, kernel_s: float = 8.0,
            n_mel: int = 64, delta: float = 0.1,
            precision: str | None = None, device=None):
    """Section boundaries straight from audio: (T,) samples -> ascending
    float64 seconds.

    Log-mel frames (the mel kernel, 10 ms hop) are mean-pooled to
    ``hop_s``-second columns (structure lives at the seconds scale, and
    pooling keeps the (T, T) similarity matrix small at any track length:
    1 h at 0.5 s = 7200 frames), then CENTERED over time (each mel band
    minus its track mean: raw dB vectors share a common floor that pins
    every cosine near +1).  The checkerboard half-width is ``kernel_s``
    seconds.
    """
    from ..features import log_mel_spectrogram

    if np.ndim(wav) != 1:
        raise ValueError("segment takes a single (T,) signal")
    if hop_s <= 0 or kernel_s <= hop_s:
        raise ValueError(
            f"need 0 < hop_s < kernel_s, got {hop_s}, {kernel_s}")
    mel = log_mel_spectrogram(wav, sr, n_mel=n_mel, hop_ms=10.0,
                              precision=precision, device=device)
    pool = max(1, int(round(hop_s / 0.010)))
    t = (mel.shape[0] // pool) * pool
    if t == 0:
        return np.empty(0, np.float64)
    pooled = mel[:t].reshape(-1, pool, mel.shape[1]).mean(dim=1)
    del mel
    pooled = pooled - pooled.mean(dim=0, keepdim=True)
    kernel = max(2, int(round(kernel_s / hop_s)))
    idx = segment_boundaries(pooled, kernel_size=kernel, delta=delta,
                             precision=precision)
    return idx.astype(np.float64) * hop_s


def oracle_novelty_np(ssm: np.ndarray, kernel_size: int) -> np.ndarray:
    """From-scratch numpy oracle of :func:`novelty_from_ssm`'s spec
    (tests only): direct O(T * L^2) sliding quadratic form on the
    zero-padded matrix."""
    ssm = np.asarray(ssm, np.float64)
    t = ssm.shape[0]
    el = kernel_size
    u = _checker_u(el).astype(np.float64)
    pad = np.zeros((t + 2 * el, t + 2 * el))
    pad[el: el + t, el: el + t] = ssm
    out = np.zeros(t)
    for i in range(t):
        patch = pad[i: i + 2 * el, i: i + 2 * el]
        out[i] = u @ patch @ u
    out /= (np.abs(u).sum() / 2.0) ** 2
    out[:el] = 0.0
    out[-el:] = 0.0
    return np.maximum(out, 0.0)
