"""Centered STFT (reference: ``perform_stft``, lib.rs:388-471), ported from
``msv_tpu/ops/stft.py`` as torch ops:

    frames = padded.unfold(win, hop)     (a strided view, no copy)
    re = frames @ C, im = frames @ S     (windowed real DFT GEMMs, f32)

The GEMMs are true f32 on the card (``MultiTrack`` and the tests set TF32
off), so every precision mode computes the same numbers here: the linear
route has no bf16 variant.  Rows >= n_frames of a bucketed frame count come
from zero padding and are masked or sliced downstream.  ``parallel`` is
accepted for API parity and ignored: the batch dimension of the GEMM is the
frame parallelism.
"""

import numpy as np
import torch

from ..utils import round_up_to
from .dft import inverse_rdft, n_pad_split, windowed_dft_matrices
from .framing import n_frames_for, reflect_pad_center
from .windows import default_stft_window

FRAME_BUCKET = 256  # frame-count granularity of stft_magnitude


def frame_device(padded, win: int, hop: int, n_frames: int):
    """(..., n_frames, win) view of a padded signal over its last axis:
    frame k is ``padded[..., k*hop : k*hop + win]``.  ``unfold`` makes a
    strided view (no gather, no copy); any hop is allowed."""
    return padded[..., : (n_frames - 1) * hop + win].unfold(-1, win, hop)


def _stft_core(padded, c, s, *, win: int, hop: int, n_frames: int):
    """(re, im) of the windowed DFT of every frame: two f32 GEMMs."""
    frames = frame_device(padded, win, hop, n_frames)
    return frames @ c, frames @ s


def dft_magnitude(padded, c, s, *, win: int, hop: int, n_frames: int):
    """|windowed DFT| of every frame, (..., n_frames, n_freq) f32: the
    linear scale's spectrum (``stft_magnitude``, ``spec_pipeline``,
    streaming's torch-op route)."""
    re, im = _stft_core(padded, c, s, win=win, hop=hop, n_frames=n_frames)
    return torch.sqrt(re * re + im * im)


def _window(win, n_fft, window):
    if window is None:
        return default_stft_window(win, n_fft)
    window = np.ascontiguousarray(window, dtype=np.float32)
    if len(window) != win:
        raise ValueError(
            f"window length {len(window)} != win_length {win} (lib.rs:404)")
    return window


def _prepare(wav, win, hop, n_fft, window, pad_frames_to, device):
    """(padded, C, S) as f32 tensors on ``device``, n_frames, n_frames_pad."""
    wav = np.ascontiguousarray(wav, dtype=np.float32)
    window = _window(win, n_fft, window)
    n_frames = n_frames_for(len(wav), win, hop)
    n_frames_pad = round_up_to(max(n_frames, 1), pad_frames_to or 1)
    padded = reflect_pad_center(wav, win)
    need = (n_frames_pad - 1) * hop + win
    if len(padded) < need:
        padded = np.pad(padded, (0, need - len(padded)))
    c, s = windowed_dft_matrices(window, n_fft)
    padded, c, s = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in (padded, c, s))
    return padded, c, s, n_frames, n_frames_pad


def perform_stft(
    wav,
    win_length: int,
    hop_length: int,
    n_fft: int,
    window=None,
    fft_module=None,
    parallel: bool = False,
    *,
    device="cuda",
):
    """Centered STFT -> complex64 tensor (n_frames, n_fft//2+1) on
    ``device``.

    API-parity port of ``perform_stft`` (lib.rs:388-396): default window is
    periodic hann / n_fft (lib.rs:407 — the 1/n_fft scale lives in the
    window).

    ``fft_module`` mirrors the reference's ``Option<&mut RealFFT>``
    injection slot: a callable (or an object with a ``process`` method,
    RealFFT's shape) taking the batch of windowed zero-padded frames
    ``(n_frames, n_fft)`` f32 — a tensor on ``device``, bit-faithful to the
    reference's piecewise framing (lib.rs:367-435, via
    ``reference_framing_oracle``) — and returning the half-spectrum
    ``(n_frames, n_fft//2+1)`` complex, e.g. ``torch.fft.rfft``.  A numpy
    result is moved to ``device``.
    """
    del parallel
    if fft_module is not None:
        from .framing import reference_framing_oracle

        w = _window(win_length, n_fft, window)
        frames = reference_framing_oracle(
            np.ascontiguousarray(wav, np.float32), win_length, hop_length,
            n_fft, w)
        fn = getattr(fft_module, "process", fft_module)
        if not callable(fn):
            raise TypeError(
                "fft_module must be callable or have a .process method")
        out = fn(torch.from_numpy(np.ascontiguousarray(frames)).to(device))
        out = torch.as_tensor(np.asarray(out) if not isinstance(
            out, torch.Tensor) else out).to(device)
        want = (frames.shape[0], n_fft // 2 + 1)
        if tuple(out.shape) != want:
            raise ValueError(
                f"fft_module returned shape {tuple(out.shape)}, "
                f"expected {want}")
        return out.to(torch.complex64)
    padded, c, s, n_frames, n_frames_pad = _prepare(
        wav, win_length, hop_length, n_fft, window, None, device)
    re, im = _stft_core(padded, c, s, win=win_length, hop=hop_length,
                        n_frames=n_frames_pad)
    return torch.complex(re, im)[:n_frames]


def inverse_stft(
    spec,
    win_length: int,
    hop_length: int,
    n_fft: int,
    window=None,
    length: int | None = None,
    *,
    device=None,
):
    """Overlap-add inverse of :func:`perform_stft` -> real f32 signal.

    Inverse rDFT per frame -> crop the centered win_length region ->
    synthesis-window overlap-add -> COLA normalization -> trim the
    reflect-pad half-windows.  ``window`` defaults to the analysis default
    (hann/n_fft, lib.rs:407); the forward pass baked 1/n_fft into it and the
    inverse rDFT applies 1/n_fft again, so the matched-window OLA
    reconstructs the signal.

    ``spec`` is a complex (n_frames, n_freq) tensor or array, or a ``(re,
    im)`` pair of real ones; ``device`` defaults to the tensor's, or to the
    card for numpy input.  On the card the overlap-add sums with atomics, so
    its f32 summation order varies from run to run.
    """
    def to_dev(a, dtype):
        if isinstance(a, torch.Tensor):
            return a.to(device or a.device, dtype)
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device or "cuda", dtype)

    if isinstance(spec, tuple):
        spec = (to_dev(spec[0], torch.float32), to_dev(spec[1], torch.float32))
        n_frames = spec[0].shape[0]
        dev = spec[0].device
    else:
        spec = to_dev(spec, torch.complex64)
        n_frames = spec.shape[0]
        dev = spec.device
    syn = _window(win_length, n_fft, window)  # matched window

    frames = inverse_rdft(spec, n_fft)
    pl, _ = n_pad_split(n_fft, win_length)
    frames = frames[:, pl : pl + win_length] * torch.from_numpy(syn).to(dev)

    total = (n_frames - 1) * hop_length + win_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(win_length)[None, :]).ravel()
    sig = torch.zeros(total, dtype=torch.float32, device=dev).index_add_(
        0, torch.from_numpy(idx).to(dev), frames.reshape(-1))
    wsq = np.zeros(total, np.float32)
    np.add.at(wsq, idx, np.tile((syn * syn).astype(np.float32), n_frames))
    sig = sig / torch.from_numpy(np.maximum(wsq, np.float32(1e-24))).to(dev)

    half = win_length // 2
    out = sig[half:]
    return out[:length] if length is not None else out[: total - 2 * half]


def stft_magnitude(
    wav,
    win_length: int,
    hop_length: int,
    n_fft: int,
    window=None,
    pad_frames_to: int = FRAME_BUCKET,
    *,
    device="cuda",
):
    """|STFT| with bucketed frame count.

    Returns (mag, n_frames): mag is (n_frames_padded, n_freq) float32 on
    ``device``; rows >= n_frames are garbage from zero-padding and must be
    masked/sliced by the caller.
    """
    padded, c, s, n_frames, n_frames_pad = _prepare(
        wav, win_length, hop_length, n_fft, window, pad_frames_to, device)
    mag = dft_magnitude(padded, c, s, win=win_length, hop=hop_length,
                        n_frames=n_frames_pad)
    return mag, n_frames
