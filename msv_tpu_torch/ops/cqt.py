"""Constant-Q transform — log-frequency analysis at constant
frequency-to-bandwidth ratio (Brown 1991), ported from
``msv_tpu/ops/cqt.py``.

The direct form: all kernels live in one (frame_len, n_bins) cos/sin
matrix pair (each column a centered, windowed complex exponential, zero
outside its own support; ``_cqt_kernels`` and ``cqt_frequencies`` are
copies of msv_tpu's host f64 design, pinned by tests/test_torch_host.py),
and the transform is framing and two true-f32 GEMMs
(``precision_for("parity")``) on the device.  C1's support at 48 kHz makes
``frame_len`` 32 768, so a 240 s song's frame matrix would be 2.9 GB: the
frames are taken in blocks (``stft.frame_blocks``).  Frames are
independent, so msv_tpu's 128-frame bucket (its compile cache) is not
carried over.

Spec:
  Q = filter_scale / (2^(1/bins_per_octave) - 1)
  f_k = fmin * 2^(k / bins_per_octave)
  N_k = ceil(Q * sr / f_k)   (kernel support, hann-windowed,
                              L1-normalized: a unit tone reads 0.5)
Frames are centered with zero padding (hop_length apart); output is
the magnitude (n_frames, n_bins).
"""

import functools

import numpy as np
import torch

from ..config import precision_for
from ..utils import next_pow2
from ..utils.device import as_f32
from .stft import frame_blocks


@functools.lru_cache(maxsize=8)
def _cqt_kernels(sr: int, fmin: float, n_bins: int, bins_per_octave: int,
                 filter_scale: float):
    """(frame_len, n_bins) cos/sin kernel matrices, f64 design -> f32."""
    q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    if freqs[-1] > sr / 2.0:
        raise ValueError(
            f"top CQT bin {freqs[-1]:.1f} Hz above Nyquist ({sr / 2}); "
            "lower n_bins or fmin"
        )
    lengths = np.ceil(q * sr / freqs).astype(int)
    frame_len = next_pow2(int(lengths[0]))
    c = np.zeros((frame_len, n_bins), np.float64)
    s = np.zeros((frame_len, n_bins), np.float64)
    center = frame_len // 2
    for k in range(n_bins):
        n = int(lengths[k])
        t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
        # periodic-symmetric hann over the support
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
        w /= w.sum()  # L1: a unit tone at f_k reads 0.5 (analytic half)
        ang = 2.0 * np.pi * freqs[k] * t / sr
        a = center - n // 2
        c[a:a + n, k] = w * np.cos(ang)
        s[a:a + n, k] = w * np.sin(ang)
    return (c.astype(np.float32), s.astype(np.float32), frame_len,
            freqs.astype(np.float32))


def cqt_frequencies(fmin: float = 32.70319566257483, n_bins: int = 84,
                    bins_per_octave: int = 12) -> np.ndarray:
    """Center frequency (Hz) of each CQT bin (fmin defaults to C1)."""
    return (fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
            ).astype(np.float32)


def _cqt_core(padded_b, c, s, *, frame_len, hop, n_frames):
    """|frames @ (c, s)| for every row of ``padded_b``, in frame blocks."""
    out = padded_b.new_empty((padded_b.shape[0], n_frames, c.shape[1]))
    for f0, nf, frames in frame_blocks(padded_b, frame_len, hop, n_frames,
                                       c.shape[1]):
        re, im = frames @ c, frames @ s
        out[:, f0:f0 + nf] = torch.sqrt(re * re + im * im)
    return out


def cqt(
    wav,
    sr: int,
    *,
    fmin: float = 32.70319566257483,  # C1
    n_bins: int = 84,                 # 7 octaves
    bins_per_octave: int = 12,
    hop_length: int = 512,
    filter_scale: float = 1.0,
    device=None,
):
    """Constant-Q magnitude: (T,) or (B, T) -> (B?, n_frames, n_bins)
    tensor on the device (numpy input goes to the card unless ``device``
    says otherwise; a tensor's own device).

    Centered zero-padded frames ``hop_length`` apart; bin k peaks at
    ``cqt_frequencies(...)[k]`` with constant f/bandwidth ratio Q.  A
    unit-amplitude tone at a bin center reads ~0.5 in that bin (the
    analytic-kernel half, the classic convention).
    """
    if n_bins < 1 or bins_per_octave < 1:
        raise ValueError(
            f"need n_bins/bins_per_octave >= 1, got "
            f"{n_bins}/{bins_per_octave}"
        )
    if fmin <= 0 or filter_scale <= 0:
        raise ValueError(
            f"fmin and filter_scale must be positive, got "
            f"{fmin}/{filter_scale}"
        )
    if hop_length < 1:
        raise ValueError(f"hop_length must be >= 1, got {hop_length}")
    wav = as_f32(wav, device)
    squeeze = wav.ndim == 1
    if squeeze:
        wav = wav[None]
    if wav.ndim != 2:
        raise ValueError(
            f"wav must be (T,) or (B, T), got {tuple(wav.shape)}")
    c, s, frame_len, _ = _cqt_kernels(
        int(sr), float(fmin), int(n_bins), int(bins_per_octave),
        float(filter_scale),
    )
    n = wav.shape[1]
    half = frame_len // 2
    n_frames = 1 + n // hop_length
    need = (n_frames - 1) * hop_length + frame_len
    padded = wav.new_zeros((wav.shape[0], need))
    padded[:, half:half + n] = wav[:, :need - half]
    with precision_for("parity"):
        out = _cqt_core(padded, as_f32(c, wav.device), as_f32(s, wav.device),
                        frame_len=frame_len, hop=hop_length,
                        n_frames=n_frames)
    return out[0] if squeeze else out
