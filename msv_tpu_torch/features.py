"""Batched log-mel feature extraction, ported from ``msv_tpu/features.py``
(``log_mel_spectrogram`` and ``log_mel_spectrogram_ragged``).

The conventions of msv_tpu's frontend, which differ from the viewer session
on purpose:
  * the analysis window is UNSCALED hann (the session's 1/n_fft scale is a
    viewer normalization);
  * mel norm defaults to 'slaney' (librosa-compatible), not 'sum';
  * optional ``top_db`` floor relative to each clip's max, librosa-style;
  * precision defaults to 'fast' (bf16 operands, f32 accumulation), unless
    the session-wide mode was set explicitly; 'parity' is true f32.

Routes: ``log="amp_db"`` with ``spec="magnitude"`` runs the fused mel dB
kernel of the chosen precision (``kernels/spectrogram_cuda.py``), one
batched ``(B, L)`` launch; every other ``log``/``spec`` runs
``_features_core`` as torch ops (msv_tpu left that core to XLA).  The
kernel takes every hop, so msv_tpu's routing on ``win % hop`` and the
engine switch (a TPU constraint) are not carried over; the ``shard_map``
route waits for multi-GPU (ROADMAP queue 1 item 10).
"""

import functools

import numpy as np
import torch

from .config import (get_precision_mode, precision_for,
                     precision_mode_is_explicit)
from .kernels.spectrogram_cuda import (mel_spectrogram_cuda, operands_bf16,
                                       operands_from_numpy, prepare_operands,
                                       round_bf16)
from .ops.decibel import amp_to_db, power_to_db
from .ops.dft import windowed_dft_matrices
from .ops.framing import n_frames_for, reflect_pad_center
from .ops.mel import calc_mel_fb
from .ops.stft import frame_device
from .ops.windows import hann
from .utils import next_pow2


def _features_core(padded_b, c, s, fb, *, win, hop, n_frames, log, mode,
                   spec="magnitude"):
    """Frames -> DFT GEMM pair -> |X| or |X|^2 -> mel GEMM -> ``log``, as
    torch ops over a (B, L) batch.  ``mode="fast"`` rounds each GEMM's
    operands to bf16 (f32 accumulation), as the TPU's single-pass MXU
    precision does; the GEMMs themselves are true f32 in both modes
    (``precision_for("parity")``), so fast mode's numbers are those bf16
    operands' and no TF32 rounding comes on top."""
    rnd = round_bf16 if mode == "fast" else (lambda x: x)
    with precision_for("parity"):
        frames = rnd(frame_device(padded_b, win, hop, n_frames))
        re = frames @ rnd(c)
        im = frames @ rnd(s)
        if spec == "power":
            # mel on the POWER spectrum (|X|^2 @ fb), librosa's
            # melspectrogram(power=2.0); not the square of the magnitude-mel
            x = re * re + im * im
        else:
            x = torch.sqrt(re * re + im * im)
        mel = rnd(x) @ rnd(fb)
    if log == "amp_db":
        if spec == "power":
            return power_to_db(mel)  # power-domain: 10*log10 IS amp dB
        return amp_to_db(mel)
    if log == "power_db":
        return power_to_db(mel if spec == "power" else mel * mel)
    if log == "linear":
        return mel  # raw mel spectrum (PCEN's input)
    return torch.log(torch.clamp(mel, min=1e-10))  # 'ln'


@functools.lru_cache(maxsize=32)
def feature_operands(sr, win, n_fft, n_mel, fmin, fmax, mel_norm, mode,
                     device):
    """(C, S, fb) of the frontend on ``device``: unscaled hann DFT pair and
    the ``mel_norm`` filterbank, f32 for parity and bf16 for fast (kept
    apart from the session's operands, whose window and norm differ)."""
    c, s = windowed_dft_matrices(hann(win, False), n_fft)
    fb = calc_mel_fb(sr, n_fft, n_mel, fmin, fmax, mel_norm, np.float32)
    ops = operands_from_numpy(c, s, fb, device)
    return operands_bf16(*ops) if mode == "fast" else ops


@functools.lru_cache(maxsize=32)
def feature_kernel_operands(sr, win, n_fft, n_mel, fmin, fmax, mel_norm,
                            mode, device):
    """``feature_operands`` laid out for the ``mode`` kernel
    (``prepare_operands``), made once per setting and device."""
    return prepare_operands(*feature_operands(
        sr, win, n_fft, n_mel, fmin, fmax, mel_norm, mode, device), mode)


def pad_batch(wav, win):
    """Centered reflect pad of a (B, T) batch: a tensor is padded on its
    device, a numpy array on the host.  Same short-signal contract as
    ``reflect_pad_center`` (lib.rs:412-433 panics below win//2 + 1)."""
    half = win // 2
    if isinstance(wav, np.ndarray):
        return torch.from_numpy(
            np.stack([reflect_pad_center(w, win) for w in wav]))
    if wav.shape[1] < half + 1:
        raise ValueError(
            f"signal too short for win_length={win}: "
            f"need at least {half + 1} samples, got {wav.shape[1]}"
        )
    return torch.nn.functional.pad(wav, (half, half), mode="reflect")


def log_mel_spectrogram(
    wav,
    sr: int,
    *,
    n_mel: int = 128,
    win_length: int | None = None,
    hop_length: int | None = None,
    n_fft: int | None = None,
    win_ms: float = 25.0,
    hop_ms: float = 10.0,
    fmin: float = 0.0,
    fmax: float | None = None,
    mel_norm="slaney",
    log: str = "amp_db",
    top_db: float | None = None,
    precision: str | None = None,
    spec: str = "magnitude",
    device=None,
):
    """Batched log-mel features: (T,) or (B, T) -> (B?, n_frames, n_mel)
    float32 tensor on the device.

    ``log``: 'amp_db' (20·log10 with the reference floor), 'power_db', 'ln'
    (natural log of the mel magnitude) or 'linear'.  ``spec``: 'magnitude'
    (mel weights |X|, the viewer convention) or 'power' (mel weights |X|^2,
    librosa's convention).  ``top_db`` clamps at (max - top_db) per clip.
    ``precision``: 'fast' (bf16 operands) or 'parity' (f32); when None, an
    explicit session-wide set_precision_mode() takes precedence over the
    'fast' default.

    ``wav`` may be a tensor: it stays on its device and is padded there (the
    device-resident form).  A numpy ``wav`` is padded on the host and
    shipped to ``device`` (default "cuda"; "cpu" runs the plain versions).
    """
    if isinstance(wav, torch.Tensor):
        wav = wav.to(torch.float32)
        if device is not None and torch.device(device) != wav.device:
            raise ValueError(f"wav is on {wav.device}, device={device!r}")
        device = wav.device
    else:
        wav = np.asarray(wav, dtype=np.float32)
        device = torch.device(device or "cuda")
    squeeze = wav.ndim == 1
    if squeeze:
        wav = wav[None]
    if win_length is None:
        win_length = int(round(win_ms * sr / 1000.0))
    if hop_length is None:
        hop_length = int(round(hop_ms * sr / 1000.0))
    if n_fft is None:
        n_fft = next_pow2(win_length)
    if precision is None:
        # features default to 'fast', but an explicit session-wide
        # set_precision_mode('parity') wins
        precision = (
            get_precision_mode() if precision_mode_is_explicit() else "fast"
        )
    if precision not in ("fast", "parity"):
        raise ValueError(f"unknown precision: {precision!r}")

    padded = pad_batch(wav, win_length).to(device)
    n_frames = n_frames_for(wav.shape[1], win_length, hop_length)
    fused = log == "amp_db" and spec == "magnitude"
    setting = (sr, win_length, n_fft, n_mel, float(fmin),
               None if fmax is None else float(fmax), mel_norm)
    if fused:
        out = mel_spectrogram_cuda(
            padded.contiguous(),
            feature_kernel_operands(*setting, precision, device),
            win=win_length, hop=hop_length, n_frames=n_frames,
            mode=precision)
    else:
        c, s, fb = feature_operands(*setting, "parity", device)
        out = _features_core(padded, c, s, fb, win=win_length,
                             hop=hop_length, n_frames=n_frames, log=log,
                             mode=precision, spec=spec)
    if top_db is not None:
        # per-clip clamp (librosa semantics): a batch-global max would
        # couple a quiet clip's floor to its loudest batchmate
        out = torch.maximum(
            out, out.amax(dim=(-2, -1), keepdim=True) - top_db)
    return out[0] if squeeze else out


def log_mel_spectrogram_ragged(wavs, sr: int, *, top_db: float | None = None,
                               **kw):
    """Variable-length clips -> list of (n_frames_i, n_mel) f32 numpy arrays.

    Clips are grouped by exact length, so equal-length clips batch into one
    launch.  ``top_db`` clamps per clip.  Remaining keyword arguments
    (``device`` among them) pass through to :func:`log_mel_spectrogram`.
    """
    groups: dict[int, list[int]] = {}
    for i, w in enumerate(wavs):
        if np.ndim(w) != 1:
            raise ValueError(
                f"clip {i} has ndim {np.ndim(w)}; ragged batching takes "
                "1-D mono clips (mix channels first)"
            )
        groups.setdefault(int(np.shape(w)[-1]), []).append(i)
    out = [None] * len(wavs)
    for idxs in groups.values():
        batch = np.stack(
            [np.asarray(wavs[i], dtype=np.float32) for i in idxs]
        )
        feats = log_mel_spectrogram(batch, sr, **kw).cpu().numpy()
        for j, i in enumerate(idxs):
            f = feats[j]
            if top_db is not None:
                f = np.maximum(f, f.max() - np.float32(top_db))
            out[i] = f
    return out
