"""Harmonic/percussive source separation (median-filtering HPSS), ported
from ``msv_tpu/ops/hpss.py``.

Framing -> windowed-DFT GEMM pair -> time and frequency running medians ->
soft (or hard) Wiener masks -> inverse-rDFT GEMM -> overlap-add, as torch
ops on the device.  The GEMMs are true f32 (``precision_for("parity")``),
as msv_tpu's HIGHEST dots.  The overlap-add is
``ops/reconstruct.py::overlap_add`` (``fold``, a fixed-order sum), never
``index_add_``, so two runs give the same audio.

The frame count stays padded to a multiple of 128, as in msv_tpu, because
it changes the result: the zeroed pad rows enter the time median at the
tail, so without them the last ``kernel_time // 2`` frames would differ.
The medians take ``k`` shifted copies and their sorted middle, as msv_tpu
does, but in blocks along the axis they do not filter
(``stft.BLOCK_ELEMENTS`` elements of stacked copies at a time): a 240 s
48 kHz plane stacked 31 times is 3.1 GB, an hour's 46 GB, and a median is
independent per line, so the blocks change no value.

``_roundtrip`` and ``_masked_istft`` are the STFT round trip the denoiser,
the spectral editor and the NMF separator share with this module.
"""

import numpy as np
import torch

from ..config import precision_for
from ..utils.device import as_f32, host_f32, target_device
from .dft import inverse_rdft, n_pad_split
from .reconstruct import _ola_norm, overlap_add
from .stft import _prepare, _window, block_rows, frame_device

FRAME_BUCKET = 128  # msv_tpu's frame-count granularity of the round trip


def _median_axis(x, k: int, axis: int):
    """Running median of odd width ``k`` along ``axis`` (0 or 1) of a 2-D
    tensor, symmetric edge padding (scipy.ndimage 'reflect'): the middle
    of the ``k`` sorted shifted copies, in blocks along the other axis."""
    h = k // 2
    xt = x if axis == 0 else x.T
    n, m = xt.shape
    xp = torch.cat([xt[:h].flip(0), xt, xt[n - h:].flip(0)]) if h else xt
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    step = block_rows(n * k)
    for j in range(0, m, step):
        win = xp[:, j:j + step].unfold(0, k, 1)  # (n, cols, k) view
        out[:, j:j + step] = win.sort(dim=-1).values[..., h]
    return out if axis == 0 else out.T


def _softmask(x, x_ref, power: float):
    """librosa.util.softmask(split_zeros=False): Wiener-style ratio of
    ``power``-th powers, computed on max-normalized operands so large
    magnitudes never overflow; 0 where both inputs underflow."""
    z = torch.maximum(x, x_ref)
    bad = z < float(np.finfo(np.float32).tiny)
    zs = torch.where(bad, 1.0, z)
    if np.isinf(power):
        return torch.where(bad, 0.0, (x > x_ref).to(torch.float32))
    xn = (x / zs) ** power
    rn = (x_ref / zs) ** power
    return torch.where(bad, 0.0, xn / (xn + rn))


def _check_args(kernel_time: int, kernel_freq: int, margin):
    if kernel_time < 1 or kernel_time % 2 == 0:
        raise ValueError(f"kernel_time must be odd >= 1, got {kernel_time}")
    if kernel_freq < 1 or kernel_freq % 2 == 0:
        raise ValueError(f"kernel_freq must be odd >= 1, got {kernel_freq}")
    mh, mp = margin if isinstance(margin, tuple) else (margin, margin)
    if mh < 1.0 or mp < 1.0:
        raise ValueError(f"margins must be >= 1, got {margin}")
    return float(mh), float(mp)


def _masks(mag, kt, kf, power, mh, mp):
    harm = _median_axis(mag, kt, axis=0)
    perc = _median_axis(mag, kf, axis=1)
    return (_softmask(harm, perc * mh, power),
            _softmask(perc, harm * mp, power))


def hpss_masks(mag, *, kernel_time: int = 31, kernel_freq: int = 31,
               power: float = 2.0, margin: float | tuple = 1.0,
               device=None):
    """(n_frames, n_freq) magnitude -> (harmonic_mask, percussive_mask)
    tensors on the device (``mag``: numpy, to the card unless ``device``
    says otherwise, or a tensor, on its own device).

    Median-filter the magnitude along time (suppresses transients ->
    harmonic enhancement) and along frequency (suppresses tones ->
    percussive enhancement), then convert to soft Wiener masks
    (``power``; ``np.inf`` = hard binary masks).  ``margin`` (scalar or
    ``(margin_harm, margin_perc)``) > 1 carves a residual: masks then
    sum to < 1 and H + P no longer reconstructs the input.
    """
    mh, mp = _check_args(kernel_time, kernel_freq, margin)
    mag = as_f32(mag, device)
    if mag.ndim != 2:
        raise ValueError(
            f"mag must be (n_frames, n_freq), got {tuple(mag.shape)}")
    if mag.shape[0] <= kernel_time // 2 or mag.shape[1] <= kernel_freq // 2:
        raise ValueError(
            f"spectrogram {tuple(mag.shape)} too small for kernels "
            f"({kernel_time}, {kernel_freq}): symmetric padding needs "
            "dim > kernel//2 (use a longer signal or smaller kernels)"
        )
    return _masks(mag, kernel_time, kernel_freq, float(power), mh, mp)


def _roundtrip(wav, win, hop, n_fft, window, device):
    """Operands of msv_tpu's masked STFT round trip on the device: the
    reflect-padded signal zero-extended to the 128-frame bucket, the DFT
    pair, the synthesis window, the true frames' overlap-add normalizer
    (1e-24 past them), and (n_frames, n_pad)."""
    window = _window(win, n_fft, window)
    padded, c, s, n_frames, n_pad = _prepare(wav, win, hop, n_fft, window,
                                             FRAME_BUCKET, device)
    wsq = _ola_norm(n_frames, win, hop, window)
    total_pad = (n_pad - 1) * hop + win
    wsq = np.pad(wsq, (0, total_pad - len(wsq)),
                 constant_values=np.float32(1e-24))
    syn, wsq = (torch.from_numpy(a).to(padded.device) for a in (window, wsq))
    return padded, c, s, syn, wsq, n_frames, n_pad


def _spectrum(padded, c, s, *, win, hop, n_frames, n_pad):
    """(re, im) of every bucket frame, the pad rows zeroed: they analyze
    samples shared with the last true frames, and their overlap-add mass
    has no window energy in the true frames' normalizer."""
    frames = frame_device(padded, win, hop, n_pad)
    re, im = frames @ c, frames @ s
    re[n_frames:] = 0.0
    im[n_frames:] = 0.0
    return re, im


def _masked_istft(re, im, m, syn, wsq, *, win, hop, n_fft):
    """Inverse STFT of the masked spectrum ``(re * m, im * m)`` over the
    whole bucket timeline."""
    pl, _ = n_pad_split(n_fft, win)
    fr = inverse_rdft((re * m, im * m), n_fft)[:, pl:pl + win]
    return overlap_add(fr, syn, hop, wsq)


def hpss(
    wav,
    win_length: int,
    hop_length: int,
    n_fft: int,
    *,
    kernel_time: int = 31,
    kernel_freq: int = 31,
    power: float = 2.0,
    margin: float | tuple = 1.0,
    window=None,
    device=None,
):
    """Split ``wav`` into (harmonic, percussive) host float32 signals of
    the same length, computed on ``device`` (numpy input goes to the card
    unless ``device`` says otherwise; a tensor's own device).

    STFT conventions match :func:`msv_tpu_torch.ops.stft.perform_stft`
    (centered, reflect padding; ``window`` defaults to the session's
    hann/n_fft — the scale cancels through the masked roundtrip).  With
    the default ``margin=1.0`` the soft masks sum to one wherever the
    spectrogram is nonzero, so ``harmonic + percussive`` reconstructs
    the input to OLA rounding.  See :func:`hpss_masks` for the
    separation parameters.
    """
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
    mh, mp = _check_args(kernel_time, kernel_freq, margin)
    padded, c, s, syn, wsq, n_frames, n_pad = _roundtrip(
        wav, win_length, hop_length, n_fft, window, dev)
    if n_frames <= kernel_time // 2 or n_fft // 2 + 1 <= kernel_freq // 2:
        raise ValueError(
            f"spectrogram ({n_frames}, {n_fft // 2 + 1}) too small for "
            f"kernels ({kernel_time}, {kernel_freq}): symmetric padding "
            "needs dim > kernel//2 (longer signal or smaller kernels)"
        )
    geo = {"win": win_length, "hop": hop_length}
    with precision_for("parity"):
        re, im = _spectrum(padded, c, s, n_frames=n_frames, n_pad=n_pad,
                           **geo)
        mask_h, mask_p = _masks(torch.sqrt(re * re + im * im),
                                int(kernel_time), int(kernel_freq),
                                float(power), mh, mp)
        h, p = (_masked_istft(re, im, m, syn, wsq, n_fft=n_fft, **geo)
                [half:half + len(wav)].cpu().numpy()
                for m in (mask_h, mask_p))
    return h, p
