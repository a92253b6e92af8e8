"""Tonal analysis, ported from ``msv_tpu/ops/tonal.py``: tonnetz (tonal
centroid) features and Krumhansl-Schmuckler key estimation, on the
chromagram of :func:`msv_tpu_torch.features.chroma_stft`.

The tonnetz projection (Harte, Sandler & Gasser 2006) is one more GEMM
after the chroma GEMM: per-frame L1-normalized chroma times a constant
(n_chroma, 6) basis of interval-circle coordinates.  It runs in
``precision_for("parity")``; "fast" rounds its operands to bf16 first, as
``features._rounder`` does (msv_tpu's single-pass MXU precision).  Key
estimation correlates the time-aggregated chroma with the 24 rotated
Krumhansl-Kessler profiles: a 24 x 12 product on the host, as in msv_tpu.

``KEY_NAMES``, the profiles, ``tonnetz_basis``, ``_pearson_rows``,
``estimate_key_from_chroma`` and ``oracle_tonnetz_np`` are copies of
msv_tpu's host code, pinned by tests/test_torch_host.py.
"""

import numpy as np
import torch

from ..config import precision_for
from ..utils.device import as_f32

#: Pitch-class names, index 0 == C (matches chroma_stft's base_c=True).
KEY_NAMES = ("C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#",
             "B")

# Krumhansl-Kessler probe-tone profiles (Krumhansl 1990, "Cognitive
# Foundations of Musical Pitch", Table 2.1), tonic first.
_KK_MAJOR = np.array(
    [6.35, 2.23, 3.48, 2.33, 4.38, 4.09, 2.52, 5.19, 2.39, 3.66, 2.29,
     2.88])
_KK_MINOR = np.array(
    [6.33, 2.68, 3.52, 5.38, 2.60, 3.53, 2.54, 4.75, 3.98, 2.69, 3.34,
     3.17])


def tonnetz_basis(n_chroma: int = 12) -> np.ndarray:
    """Tonal-centroid basis -> (n_chroma, 6) f32.

    Host-side constant builder in the repo convention (chroma classes as
    ROWS so application is one ``chroma @ basis`` GEMM).  Columns are
    (sin, cos) pairs on three interval circles: fifths (radius 1, 7
    semitone steps per class step), minor thirds (radius 1, 3 steps),
    major thirds (radius 0.5, 4 steps) — the Harte 2006 geometry.
    """
    if n_chroma < 2:
        raise ValueError(f"n_chroma must be >= 2, got {n_chroma}")
    # Fractional pitch class of each chroma bin (0..12 over the bins).
    dim = np.linspace(0, 12, num=n_chroma, endpoint=False)
    scale = np.array([7.0 / 6, 7.0 / 6, 3.0 / 2, 3.0 / 2, 2.0 / 3,
                      2.0 / 3])
    v = scale[:, None] * dim[None, :]
    v[::2] -= 0.5  # sin rows: sin(pi x) == cos(pi (x - 0.5))
    radius = np.array([1.0, 1.0, 1.0, 1.0, 0.5, 0.5])
    phi = radius[:, None] * np.cos(np.pi * v)
    return np.ascontiguousarray(phi.T, dtype=np.float32)


def _tonnetz_core(chroma_b, basis, *, mode):
    from ..features import _rounder

    rnd = _rounder(mode)
    l1 = torch.sum(torch.abs(chroma_b), dim=-1, keepdim=True)
    unit = chroma_b / torch.clamp(l1, min=1e-10)
    with precision_for("parity"):
        return rnd(unit) @ rnd(basis)


def tonnetz_from_chroma(chroma, *, precision: str | None = None,
                        device=None):
    """Tonal centroids from a chromagram: (..., T, n_chroma) -> (..., T, 6)
    tensor.

    Each frame's chroma vector is L1-normalized (so any per-frame positive
    scaling of the input, e.g. chroma_stft's 'inf' vs 'none' norm, yields
    the same tonnetz) and projected onto :func:`tonnetz_basis`.  All-zero
    frames map to the origin.  ``chroma``: numpy (to the card unless
    ``device`` says otherwise) or a tensor (on its own device).
    """
    from ..features import _check_precision

    precision = _check_precision(precision)
    if np.ndim(chroma) < 2:
        raise ValueError(
            f"chroma must be (..., T, n_chroma), got {np.shape(chroma)}")
    chroma = as_f32(chroma, device)
    basis = torch.from_numpy(tonnetz_basis(chroma.shape[-1])).to(
        chroma.device)
    return _tonnetz_core(chroma, basis, mode=precision)


def tonnetz(wav, sr: int, *, n_chroma: int = 12,
            precision: str | None = None, device=None, **chroma_kwargs):
    """Tonnetz features straight from audio: (T,) or (B, T) samples ->
    (B?, n_frames, 6) tensor.  Computes
    :func:`msv_tpu_torch.features.chroma_stft` (extra keywords pass
    through) and projects each frame onto the tonal-centroid basis."""
    from ..features import chroma_stft  # runtime: features imports ops

    ch = chroma_stft(wav, sr, n_chroma=n_chroma, precision=precision,
                     device=device, **chroma_kwargs)
    return tonnetz_from_chroma(ch, precision=precision)


def _pearson_rows(profiles: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Pearson r of vector ``x`` against each row of ``profiles``."""
    px = profiles - profiles.mean(axis=1, keepdims=True)
    xx = x - x.mean()
    denom = np.sqrt((px * px).sum(axis=1) * (xx * xx).sum())
    return (px @ xx) / np.maximum(denom, 1e-20)


def estimate_key_from_chroma(chroma):
    """Krumhansl-Schmuckler key estimate from a chromagram.

    ``chroma``: (T, 12) or (12,) — class 0 must be C (chroma_stft's
    default).  Frames are mean-aggregated (energy-weighted when the
    chroma is unnormalized).  Returns ``(tonic, mode, correlation,
    scores)``: tonic in :data:`KEY_NAMES`, mode 'major'|'minor',
    the winning Pearson correlation, and the full (24,) score vector
    (12 major keys C..B then 12 minor).  A flat/empty chroma returns
    ``(None, None, 0.0, zeros)``.
    """
    ch = np.asarray(chroma, np.float64)
    if ch.ndim == 2:
        ch = ch.mean(axis=0)
    if ch.shape != (12,):
        raise ValueError(
            f"chroma must aggregate to 12 classes, got {np.shape(chroma)}")
    profiles = np.stack(
        [np.roll(_KK_MAJOR, k) for k in range(12)]
        + [np.roll(_KK_MINOR, k) for k in range(12)]
    )
    if not np.isfinite(ch).all() or np.allclose(ch, ch[0]):
        return None, None, 0.0, np.zeros(24)
    scores = _pearson_rows(profiles, ch)
    best = int(np.argmax(scores))
    tonic = KEY_NAMES[best % 12]
    mode = "major" if best < 12 else "minor"
    return tonic, mode, float(scores[best]), scores


def estimate_key(wav, sr: int, *, precision: str | None = None,
                 device=None, **chroma_kwargs):
    """Global key straight from audio: (T,) samples -> (tonic, mode,
    correlation, scores).  Uses an UNNORMALIZED chromagram (norm='none')
    so loud frames weigh more, per the classic K-S aggregation; the
    chromagram is computed on the device and aggregated on the host."""
    from ..features import chroma_stft

    if np.ndim(wav) != 1:
        raise ValueError("estimate_key takes a single (T,) signal")
    chroma_kwargs.setdefault("norm", "none")
    ch = chroma_stft(wav, sr, precision=precision, device=device,
                     **chroma_kwargs)
    return estimate_key_from_chroma(ch.cpu().numpy().astype(np.float64))


def oracle_tonnetz_np(chroma: np.ndarray) -> np.ndarray:
    """From-scratch numpy oracle of :func:`tonnetz_from_chroma`'s spec
    (tests only): per-frame L1 normalize, project on sin/cos interval
    circles built directly from the interval step sizes."""
    ch = np.asarray(chroma, np.float64)
    n_chroma = ch.shape[-1]
    cls = np.arange(n_chroma) * (12.0 / n_chroma)
    out = np.zeros(ch.shape[:-1] + (6,))
    unit = ch / np.maximum(np.abs(ch).sum(-1, keepdims=True), 1e-10)
    # Angle per chroma class on each interval circle, in units of
    # 2*pi/12: fifths 7, minor thirds 9 (3*pi/2 per class), major
    # thirds 4 (2*pi/3 per class) — the Harte 2006 geometry.
    for j, (steps, r, trig) in enumerate([
        (7, 1.0, np.sin), (7, 1.0, np.cos),
        (9, 1.0, np.sin), (9, 1.0, np.cos),
        (4, 0.5, np.sin), (4, 0.5, np.cos),
    ]):
        angle = 2.0 * np.pi * steps * cls / 12.0
        out[..., j] = unit @ (r * trig(angle))
    return out
