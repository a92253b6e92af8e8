"""Multitaper (Thomson DPSS) spectrogram — the low-variance spectral
view, ported from ``msv_tpu/ops/multitaper.py``.

Each frame is analyzed with K orthogonal DPSS tapers and the K
eigenspectra are averaged with their eigenvalue weights: one true-f32
GEMM pair (``precision_for("parity")``) against a horizontally stacked
(win, K*n_freq) matrix pair from the engine's phase-folded windowed-DFT
builder, taken in frame blocks (``stft.frame_blocks``).
``_dpss_bank`` (scipy's ``dpss`` on the host) is a copy of msv_tpu's,
pinned by tests/test_torch_host.py.  Frames are independent, so msv_tpu's
128-frame bucket (its compile cache) is not carried over.

Conventions match :func:`msv_tpu_torch.ops.stft.perform_stft`: centered
reflect padding, frames ``hop_length`` apart, zero-pad to ``n_fft``
folded into the matrix phase.  Tapers are unit-energy (||w||_2 = 1,
scipy's ``norm=2``).
"""

import functools

import numpy as np
import torch

from ..config import precision_for
from ..utils.device import as_f32, host_f32, target_device
from .decibel import power_to_db
from .dft import windowed_dft_matrices
from .framing import n_frames_for, reflect_pad_center
from .stft import frame_blocks


@functools.lru_cache(maxsize=16)
def _dpss_bank(win_length: int, n_fft: int, nw: float, n_tapers: int):
    """Stacked (win, K*n_freq) cos/sin matrices + eigenvalue weights.

    Each taper's matrix comes from the engine's own phase-folded
    windowed-DFT builder, so per-taper columns are bit-identical to
    running that taper through the standard path.
    """
    from scipy.signal import windows as _w

    tapers, ratios = _w.dpss(win_length, nw, Kmax=n_tapers, sym=False,
                             norm=2, return_ratios=True)
    tapers = np.atleast_2d(tapers)
    cs = [windowed_dft_matrices(t.astype(np.float32), n_fft)
          for t in tapers]
    c = np.concatenate([m[0] for m in cs], axis=1)
    s = np.concatenate([m[1] for m in cs], axis=1)
    # eigenvalue (energy-concentration) weights, normalized to sum 1
    lam = np.asarray(ratios, np.float64)
    w = (lam / lam.sum()).astype(np.float32)
    return c, s, w


def _mt_core(padded_b, c, s, lam, *, win, hop, n_frames, n_freq, k):
    out = padded_b.new_empty((padded_b.shape[0], n_frames, n_freq))
    for f0, nf, frames in frame_blocks(padded_b, win, hop, n_frames,
                                       k * n_freq):
        re, im = frames @ c, frames @ s
        p = (re * re + im * im).reshape(-1, nf, k, n_freq)
        out[:, f0:f0 + nf] = torch.einsum("btkf,k->btf", p, lam)
    return out


def multitaper_spectrogram(
    wav,
    sr: int,
    *,
    win_length: int = 1024,
    hop_length: int = 256,
    n_fft: int | None = None,
    nw: float = 3.0,
    n_tapers: int | None = None,
    device=None,
):
    """Multitaper power spectrogram: (T,) or (B, T) -> (B?, frames, n_freq)
    tensor on the device (numpy input goes to the card unless ``device``
    says otherwise; a tensor's own device).

    ``nw`` is the time-bandwidth product (resolution widens to ~2*nw
    DFT bins); ``n_tapers`` defaults to the Thomson choice
    ``floor(2*nw) - 1`` (all tapers with eigenvalue ~1).  Eigenvalue-
    weighted average of the K unit-energy eigenspectra; frame centers
    match :func:`perform_stft` (centered, reflect padding).
    """
    if n_fft is None:
        n_fft = win_length
    if n_fft < win_length:
        raise ValueError(f"n_fft ({n_fft}) must be >= win_length "
                         f"({win_length})")
    if nw <= 0.5:
        raise ValueError(f"time-bandwidth nw must be > 0.5, got {nw}")
    if n_tapers is None:
        n_tapers = max(1, int(2 * nw) - 1)
    if not 1 <= n_tapers <= win_length:
        raise ValueError(f"n_tapers must be in [1, win_length], got "
                         f"{n_tapers}")
    if n_tapers >= 2 * nw:
        raise ValueError(
            f"n_tapers={n_tapers} exceeds the 2*NW-1={int(2 * nw) - 1} "
            f"well-concentrated count for nw={nw}; raise nw or lower "
            "n_tapers"
        )
    if hop_length < 1:
        raise ValueError(f"hop_length must be >= 1, got {hop_length}")

    dev = target_device(wav, device)
    wav_np = host_f32(wav)
    squeeze = wav_np.ndim == 1
    if squeeze:
        wav_np = wav_np[None]
    if wav_np.ndim != 2:
        raise ValueError(f"wav must be (T,) or (B, T), got {wav_np.shape}")
    n = wav_np.shape[1]
    half = win_length // 2
    if n < half + 1:
        raise ValueError(
            f"signal too short for win_length={win_length}: need at "
            f"least {half + 1} samples, got {n}"
        )

    c, s, lam = _dpss_bank(int(win_length), int(n_fft), float(nw),
                           int(n_tapers))
    n_frames = n_frames_for(n, win_length, hop_length)
    need = (n_frames - 1) * hop_length + win_length
    padded = np.zeros((wav_np.shape[0], need), np.float32)
    for i, w in enumerate(wav_np):
        r = reflect_pad_center(w, win_length)
        padded[i, :min(len(r), need)] = r[:need]
    with precision_for("parity"):
        out = _mt_core(
            as_f32(padded, dev), as_f32(c, dev), as_f32(s, dev),
            as_f32(lam, dev), win=int(win_length), hop=int(hop_length),
            n_frames=n_frames, n_freq=int(n_fft) // 2 + 1, k=int(n_tapers),
        )
    return out[0] if squeeze else out


def multitaper_spec_db(wav, sr: int, *, top_db: float | None = 80.0,
                       **kw):
    """dB view of :func:`multitaper_spectrogram` (power -> 10*log10,
    strict ``> amin`` floor per the repo's decibel convention), clamped
    to ``max - top_db`` like the feature frontend."""
    if top_db is not None and top_db <= 0:
        raise ValueError(f"top_db must be positive, got {top_db}")
    db = power_to_db(multitaper_spectrogram(wav, sr, **kw))
    if top_db is not None:
        peak = db.amax(dim=(-2, -1), keepdim=True)
        db = torch.maximum(db, peak - float(np.float32(top_db)))
    return db
