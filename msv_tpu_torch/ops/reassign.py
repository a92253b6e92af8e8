"""Time-frequency reassignment — the sharpened spectrogram, ported from
``msv_tpu/ops/reassign.py``.

The three analyses (window h, time-ramped t*h, derivative dh/dt) are one
true-f32 GEMM pair (``precision_for("parity")``) against a horizontally
stacked (win, 3*n_freq) matrix pair, taken in frame blocks
(``stft.frame_blocks``) on the device; the corrections are elementwise:

  t_hat = t_frame + Re(X_th * conj(X_h)) / |X_h|^2        [samples]
  f_hat = f_bin  - Im(X_dh * conj(X_h)) / |X_h|^2 / (2pi) [cycles/sample]

The sharpened image is msv_tpu's host f64 ``bincount`` of the power at
the reassigned cells (nearest cell): a fixed-order sum, so two runs give
the same image, where device f32 atomics would not.
``_window_and_derivatives``, ``_reassign_bank`` and
``reassigned_spec_db`` are copies of msv_tpu's, pinned by
tests/test_torch_host.py (``reassigned_spec_db`` with named line edits:
the device).  Frames are independent, so msv_tpu's 128-frame bucket (its
compile cache) is not carried over.
"""

import functools
import math

import numpy as np
import torch

from ..config import precision_for
from ..utils.device import as_f32, host_f32, target_device
from .dft import windowed_dft_matrices
from .framing import n_frames_for, reflect_pad_center
from .stft import frame_blocks
from .windows import hann


def _window_and_derivatives(win_length: int):
    """(h, t*h, dh/dt) for the periodic hann, all f64 -> f32.

    t is in samples relative to the frame center (win//2 — the sample
    the centered-STFT convention aligns with t_frame); dh/dt is the
    ANALYTIC derivative of the continuous hann the periodic samples
    come from (exact, unlike a finite difference).
    """
    h = np.asarray(hann(win_length), np.float64)
    j = np.arange(win_length, dtype=np.float64)
    t = j - win_length // 2
    # periodic hann h(j) = 0.5 - 0.5 cos(2 pi j / N)  ->
    # dh/dj = (pi / N) sin(2 pi j / N)
    dh = (np.pi / win_length) * np.sin(2.0 * np.pi * j / win_length)
    return (h.astype(np.float32), (t * h).astype(np.float32),
            dh.astype(np.float32))


@functools.lru_cache(maxsize=16)
def _reassign_bank(win_length: int, n_fft: int):
    """Stacked (win, 3*n_freq) cos/sin matrices for (h, t*h, dh/dt)."""
    mats = [windowed_dft_matrices(w, n_fft)
            for w in _window_and_derivatives(win_length)]
    c = np.concatenate([m[0] for m in mats], axis=1)
    s = np.concatenate([m[1] for m in mats], axis=1)
    return c, s


def _reassign_core(padded, c, s, *, win, hop, n_frames, n_freq):
    """(power, dt samples, dw cycles/sample), each (n_frames, n_freq)."""
    outs = [padded.new_empty((n_frames, n_freq)) for _ in range(3)]
    for f0, nf, frames in frame_blocks(padded, win, hop, n_frames,
                                       3 * n_freq):
        re = (frames @ c).reshape(nf, 3, n_freq)
        im = (frames @ s).reshape(nf, 3, n_freq)
        re_h, re_th, re_dh = re[:, 0], re[:, 1], re[:, 2]
        im_h, im_th, im_dh = im[:, 0], im[:, 1], im[:, 2]
        p = re_h * re_h + im_h * im_h
        safe = torch.clamp(p, min=float(np.float32(1e-30)))
        # X_a * conj(X_h):  Re = ra*rh + ia*ih,  Im = ia*rh - ra*ih
        dt = (re_th * re_h + im_th * im_h) / safe
        dw = -(im_dh * re_h - re_dh * im_h) / safe / float(
            np.float32(2.0 * math.pi))
        for o, v in zip(outs, (p, dt, dw)):
            o[f0:f0 + nf] = v
    return outs


def reassigned_stft(
    wav,
    sr: int,
    *,
    win_length: int = 1024,
    hop_length: int = 256,
    n_fft: int | None = None,
    device=None,
):
    """Reassigned coordinates: (T,) -> host (power, times_hat, freqs_hat),
    computed on ``device`` (numpy input goes to the card unless ``device``
    says otherwise; a tensor's own device).

    All three outputs are (n_frames, n_freq) float32: the plain hann
    STFT power, the reassigned time of each cell in SECONDS, and the
    reassigned frequency in Hz.  Frame/pad conventions match
    :func:`perform_stft` (centered, reflect pad, zero-pad fold);
    near-zero cells (|X_h|^2 <= 1e-30) keep their nominal coordinates.
    """
    if n_fft is None:
        n_fft = win_length
    if n_fft < win_length:
        raise ValueError(f"n_fft ({n_fft}) must be >= win_length "
                         f"({win_length})")
    if hop_length < 1:
        raise ValueError(f"hop_length must be >= 1, got {hop_length}")
    dev = target_device(wav, device)
    wav = host_f32(wav)
    if wav.ndim != 1:
        raise ValueError(f"wav must be 1-D, got {wav.shape}")
    half = win_length // 2
    if len(wav) < half + 1:
        raise ValueError(
            f"signal too short for win_length={win_length}: need at "
            f"least {half + 1} samples, got {len(wav)}"
        )
    c, s = _reassign_bank(int(win_length), int(n_fft))
    n_freq = int(n_fft) // 2 + 1
    n_frames = n_frames_for(len(wav), win_length, hop_length)
    need = (n_frames - 1) * hop_length + win_length
    row = reflect_pad_center(wav, win_length)
    padded = np.zeros(need, np.float32)
    padded[:min(len(row), need)] = row[:need]
    with precision_for("parity"):
        p, dt, dw = (a.cpu().numpy() for a in _reassign_core(
            as_f32(padded, dev), as_f32(c, dev), as_f32(s, dev),
            win=int(win_length), hop=int(hop_length), n_frames=n_frames,
            n_freq=n_freq))
    # nominal grids: frame i is anchored at sample i*hop, bin k at
    # k*sr/n_fft; corrections are already relative to those anchors
    t_nom = (np.arange(n_frames, dtype=np.float32)[:, None]
             * np.float32(hop_length))
    f_nom = (np.arange(n_freq, dtype=np.float32)[None, :]
             * np.float32(sr / n_fft))
    live = p > 1e-30
    times = (t_nom + np.where(live, dt, 0.0)) / np.float32(sr)
    freqs = f_nom + np.where(live, dw, 0.0) * np.float32(sr)
    return p, times, freqs


def reassigned_spec_db(
    wav,
    sr: int,
    *,
    win_length: int = 1024,
    hop_length: int = 256,
    n_fft: int | None = None,
    rel_thresh: float = 1e-6,
    top_db: float | None = 80.0, device=None,
):
    """Sharpened spectrogram image: (n_frames, n_freq) dB.

    Power is histogrammed at its reassigned coordinates onto the
    ORIGINAL (frame, bin) grid (nearest cell; coordinates clipped to
    the grid edges), so axes/shape drop into any pipeline that took
    the plain dB plane.  Cells below ``rel_thresh * max_power`` stay
    at their nominal position (reassigning numerical noise scatters
    it); total energy is conserved exactly.  Host paint, like the
    render/ stages.

    Cross-backend note: nearest-cell rounding makes individual cells
    backend-sensitive when a coordinate lands ON a cell boundary
    (measured TPU-vs-CPU on the 44 s reference sample: 4 of 1.4 M
    cells differ, total power equal to 6e-7) — compare totals or
    smoothed images across backends, not single cells.
    """
    if rel_thresh < 0:
        raise ValueError(f"rel_thresh must be >= 0, got {rel_thresh}")
    p, times, freqs = reassigned_stft(
        wav, sr, win_length=win_length, hop_length=hop_length,
        n_fft=n_fft, device=device)
    n_frames, n_freq = p.shape
    thr = p.max() * rel_thresh
    live = p > thr
    ti = np.rint(times * sr / hop_length).astype(np.int64)
    fi = np.rint(freqs * (n_fft or win_length) / sr).astype(np.int64)
    t_nom, f_nom = np.meshgrid(np.arange(n_frames), np.arange(n_freq),
                               indexing="ij")
    ti = np.clip(np.where(live, ti, t_nom), 0, n_frames - 1)
    fi = np.clip(np.where(live, fi, f_nom), 0, n_freq - 1)
    flat = np.bincount((ti * n_freq + fi).ravel(), weights=p.ravel(),
                       minlength=n_frames * n_freq)
    img = flat.reshape(n_frames, n_freq).astype(np.float32)

    from .decibel import power_to_db

    db = power_to_db(as_f32(img, target_device(wav, device))).cpu().numpy()
    if top_db is not None:
        if top_db <= 0:
            raise ValueError(f"top_db must be positive, got {top_db}")
        db = np.maximum(db, db.max() - np.float32(top_db))
    return db
