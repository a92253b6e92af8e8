"""Batched ML features, ported from ``msv_tpu/features.py``: the log-mel
frontend (``log_mel_spectrogram``, ``log_mel_spectrogram_ragged``) and the
rest of the feature set (``whisper_log_mel``, ``mfcc``, ``pcen``,
``delta``, ``spectral_features``, ``spectral_contrast``, ``chroma_stft``,
``onset_strength``, ``onset_detect``) and ``analyze``, the report
of the whole analysis stack.

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
``_features_core`` as torch ops (msv_tpu left that core to XLA), and so do
the other features, which msv_tpu also left to XLA.  Every GEMM runs in
``precision_for("parity")`` (TF32 off); "fast" rounds its operands to bf16
first.  The kernel takes every hop, so msv_tpu's routing on ``win % hop``
(a TPU constraint) is not carried over, nor are its 128-frame buckets (no
program is keyed on shape here; the pad frames are sliced off).  Under
``config.set_engine("xla")`` the fused route runs the kernel's plain
version on the same device.  A dp-split ``ShardedArray`` batch runs one
launch per shard and keeps its split (msv_tpu's ``shard_map`` route).
``_dct2_matrix``, ``_contrast_bands``, ``chroma_filterbank``,
``_peak_pick`` and ``analyze`` (with named line edits: each op's device)
are copies of msv_tpu's host code, pinned by tests/test_torch_host.py.
``analyze`` opens no precision scope of its own: each op keeps its own
short one, so a background report never holds one while the viewer's
renders wait.
"""

import functools
import math

import numpy as np
import torch

from .config import (get_precision_mode, precision_for,
                     precision_mode_is_explicit)
from .kernels.spectrogram_cuda import (MelRoute, mel_spectrogram_cuda,
                                       operands_from_numpy, round_bf16)
from .ops.decibel import amp_to_db, power_to_db
from .ops.dft import windowed_dft_matrices
from .ops.framing import n_frames_for, reflect_pad_center
from .ops.mel import calc_mel_fb
from .ops.scan import _f32, pole_scan
from .ops.stft import frame_device
from .ops.windows import hann
from .parallel.sharded import Shard, ShardedArray
from .utils import next_pow2
from .utils.device import as_f32


def _rounder(mode):
    """Operand rounding of a GEMM of precision ``mode``: bf16 for "fast"
    (the TPU's single-pass MXU operands), none for "parity".  The GEMMs
    themselves run in ``precision_for("parity")``."""
    return round_bf16 if mode == "fast" else (lambda x: x)


def _dft_pair(padded, c, s, *, win, hop, n_frames, mode):
    """(frames, re, im) of a (B, L) padded batch, in the caller's parity
    scope; ``frames`` unrounded (the spectral core's RMS and crossings
    read the samples themselves)."""
    rnd = _rounder(mode)
    frames = frame_device(padded, win, hop, n_frames)
    fr = rnd(frames)
    return frames, fr @ rnd(c), fr @ rnd(s)


def _features_core(padded_b, c, s, fb, *, win, hop, n_frames, log, mode,
                   spec="magnitude"):
    """Frames -> DFT GEMM pair -> |X| or |X|^2 -> mel GEMM -> ``log``, as
    torch ops over a (B, L) batch.  ``mode="fast"`` rounds each GEMM's
    operands to bf16 (f32 accumulation), as the TPU's single-pass MXU
    precision does; the GEMMs themselves are true f32 in both modes
    (``precision_for("parity")``), so fast mode's numbers are those bf16
    operands' and no TF32 rounding comes on top."""
    rnd = _rounder(mode)
    with precision_for("parity"):
        _, re, im = _dft_pair(padded_b, c, s, win=win, hop=hop,
                              n_frames=n_frames, mode=mode)
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
def _feature_fb(sr, n_fft, n_mel, fmin, fmax, mel_norm):
    return calc_mel_fb(sr, n_fft, n_mel, fmin, fmax, mel_norm, np.float32)


@functools.lru_cache(maxsize=32)
def feature_operands(sr, win, n_fft, n_mel, fmin, fmax, mel_norm, device):
    """(C, S, fb) of the frontend on ``device`` in f32: unscaled hann DFT
    pair and the ``mel_norm`` filterbank (kept apart from the session's
    operands, whose window and norm differ)."""
    c, s = windowed_dft_matrices(hann(win, False), n_fft)
    fb = _feature_fb(sr, n_fft, n_mel, fmin, fmax, mel_norm)
    return operands_from_numpy(c, s, fb, device)


@functools.lru_cache(maxsize=32)
def _feature_route(sr, win, n_fft, n_mel, fmin, fmax, mel_norm, device,
                   hop):
    """The fused route of the frontend (``MelRoute``: unscaled hann, the
    ``mel_norm`` filterbank), one per setting, device and hop, its C and S
    those of ``feature_operands``, built where a launch reads them."""
    return MelRoute(hann(win, False),
                    _feature_fb(sr, n_fft, n_mel, fmin, fmax, mel_norm),
                    win=win, hop=hop, n_fft=n_fft, device=device,
                    dense=lambda: feature_operands(
                        sr, win, n_fft, n_mel, fmin, fmax, mel_norm,
                        device)[:2])


def _check_precision(precision, default="fast"):
    if precision is None:
        # features default to 'fast', but an explicit session-wide
        # set_precision_mode('parity') wins
        precision = (
            get_precision_mode() if precision_mode_is_explicit() else default
        )
    if precision not in ("fast", "parity"):
        raise ValueError(f"unknown precision: {precision!r}")
    return precision


def _batch(wav, device):
    """(wav as a (B, T) f32 tensor or numpy array, squeeze, device): a
    tensor stays on its device (``device``, if given, must be that one),
    numpy goes to ``device`` (default the card) once padded."""
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
    if wav.ndim != 2:
        raise ValueError(f"wav must be (L,) or (B, L), got "
                         f"{tuple(wav.shape)}")
    return wav, squeeze, device


def _geometry(sr, win_length, hop_length, n_fft, win_ms, hop_ms):
    if win_length is None:
        win_length = int(round(win_ms * sr / 1000.0))
    if hop_length is None:
        hop_length = int(round(hop_ms * sr / 1000.0))
    if n_fft is None:
        n_fft = next_pow2(win_length)
    return win_length, hop_length, n_fft


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

    ``wav`` may also be a ``parallel.sharded.ShardedArray`` (B, L): split
    on its first axis only, with the rows dividing evenly, each shard runs
    its own launch on its device and the result keeps that split (a
    ``ShardedArray`` (B, n_frames, n_mel)); any other split is gathered to
    its first device and runs the torch-op core, as msv_tpu's partitioned
    XLA route does.  Under ``config.set_engine("xla")`` the fused route
    runs the kernel's plain version on the same device.
    """
    kw = dict(n_mel=n_mel, win_length=win_length, hop_length=hop_length,
              n_fft=n_fft, win_ms=win_ms, hop_ms=hop_ms, fmin=fmin,
              fmax=fmax, mel_norm=mel_norm, log=log, top_db=top_db,
              precision=precision, spec=spec, device=device)
    if isinstance(wav, ShardedArray):
        return _log_mel_sharded(wav, sr, kw)
    return _log_mel(wav, sr, **kw)


def _log_mel_sharded(wav, sr, kw):
    """:func:`log_mel_spectrogram` of a sharded (B, L) batch."""
    axis = wav.spec[0]
    if (wav.ndim != 2 or not isinstance(axis, str) or wav.spec[1] is not None
            or wav.shape[0] % wav.mesh.shape[axis]):
        return _log_mel(wav.gather(), sr, fused=False,
                        **dict(kw, device=None))
    shards = [Shard((sh.index[0], slice(None), slice(None)),
                    _log_mel(sh.data, sr, **dict(kw, device=None)))
              for sh in wav.shards]
    n_frames, n_out = shards[0].data.shape[1:]
    return ShardedArray((wav.shape[0], n_frames, n_out), wav.mesh,
                        (axis, None, None), shards)


def _log_mel(wav, sr, *, n_mel, win_length, hop_length, n_fft, win_ms,
             hop_ms, fmin, fmax, mel_norm, log, top_db, precision, spec,
             device, fused=True):
    wav, squeeze, device = _batch(wav, device)
    win_length, hop_length, n_fft = _geometry(sr, win_length, hop_length,
                                              n_fft, win_ms, hop_ms)
    precision = _check_precision(precision)

    padded = pad_batch(wav, win_length).to(device)
    n_frames = n_frames_for(wav.shape[1], win_length, hop_length)
    fused = fused and log == "amp_db" and spec == "magnitude"
    setting = (sr, win_length, n_fft, n_mel, float(fmin),
               None if fmax is None else float(fmax), mel_norm)
    if fused:
        out = _feature_route(*setting, device, hop_length)(
            padded.contiguous(), n_frames, mode=precision,
            launch=mel_spectrogram_cuda)
    else:
        c, s, fb = feature_operands(*setting, device)
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


# ---------------------------------------------------------------------------
# the rest of the feature set (msv_tpu/features.py:313-1158)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _dft_operands(win, n_fft, device):
    """(C, S) of the frontend's unscaled hann on ``device``."""
    return tuple(torch.from_numpy(m).to(device) for m in
                 windowed_dft_matrices(hann(win, False), n_fft))


def _whisper_core(padded_b, c, s, fb, *, win, hop, n_frames, n_valid, mode):
    """Whisper's exact feature math: mel on the POWER spectrum (|X|^2 @
    fb — NOT (|X| @ fb)^2, so it needs its own core), log10 with a 1e-10
    floor, per-clip dynamic-range clamp at max - 8, then (x + 4) / 4."""
    rnd = _rounder(mode)
    with precision_for("parity"):
        _, re, im = _dft_pair(padded_b, c, s, win=win, hop=hop,
                              n_frames=n_frames, mode=mode)
        mel = rnd(re * re + im * im) @ rnd(fb)
    log_spec = torch.log10(torch.clamp(mel[:, :n_valid], min=1e-10))
    log_spec = torch.maximum(
        log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(1, 2)  # (B, n_mel, n_valid)


def whisper_log_mel(wav, sr: int = 16000, *, n_mel: int = 80,
                    chunk_length: float = 30.0,
                    precision: str | None = None, device=None):
    """Drop-in Whisper input features: (B?, L) 16 kHz mono -> (B?, n_mel,
    3000) f32 tensor, msv_tpu's ``transformers.WhisperFeatureExtractor``
    contract: clips pad/truncate to 30 s, centered reflect-pad STFT (hann
    400, hop 160), the LAST frame dropped (3001 -> 3000), mel = power
    spectrum @ slaney-normed slaney-scale filterbank (fmin 0, fmax 8000),
    log10 clamped at 1e-10, per-CLIP clamp at max - 8.0, then (x + 4) / 4.
    ``n_mel=128`` gives whisper-large-v3 features.

    ``precision`` defaults to 'parity' (true f32); 'fast' rounds the GEMM
    operands to bf16.  ``wav`` may be a tensor (padded on its device).
    """
    if sr != 16000:
        raise ValueError(
            f"whisper features are defined at 16 kHz, got sr={sr} "
            "(convert first: msv_tpu_torch.ops.resample.resample(wav, sr, "
            "16000))"
        )
    if precision is None:
        precision = "parity"
    precision = _check_precision(precision)
    win, hop, n_fft = 400, 160, 400
    n_samples = int(round(chunk_length * sr))
    n_valid = n_samples // hop  # 3000: whisper drops the last frame
    wav, squeeze, device = _batch(wav, device)
    # pad/truncate to the 30 s chunk (WhisperFeatureExtractor padding=
    # 'max_length', truncation=True)
    if wav.shape[1] >= n_samples:
        wav = wav[:, :n_samples]
    elif isinstance(wav, torch.Tensor):
        wav = torch.nn.functional.pad(wav, (0, n_samples - wav.shape[1]))
    else:
        wav = np.pad(wav, ((0, 0), (0, n_samples - wav.shape[1])))
    padded = pad_batch(wav, win).to(device)
    c, s, fb = feature_operands(sr, win, n_fft, n_mel, 0.0, 8000.0,
                                "slaney", device)
    out = _whisper_core(padded, c, s, fb, win=win, hop=hop,
                        n_frames=n_frames_for(n_samples, win, hop),
                        n_valid=n_valid, mode=precision)
    return out[0] if squeeze else out


def _dct2_matrix(n_mfcc: int, n_mel: int, norm: str = "ortho") -> np.ndarray:
    """DCT-II basis as a (n_mel, n_mfcc) f32 GEMM operand.

    ``feats @ D`` equals ``scipy.fft.dct(feats, type=2, norm=norm,
    axis=-1)[..., :n_mfcc]`` (pinned in tests/test_features.py): row n,
    column k holds ``2*cos(pi*k*(2n+1)/(2*n_mel))`` with the orthonormal
    scaling ``sqrt(1/(4N))`` for k=0 and ``sqrt(1/(2N))`` otherwise.
    Built host-side in f64, shipped f32 — a tiny constant per
    (n_mel, n_mfcc) pair.
    """
    n = np.arange(n_mel, dtype=np.float64)[:, None]
    k = np.arange(n_mfcc, dtype=np.float64)[None, :]
    d = 2.0 * np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_mel))
    if norm == "ortho":
        f = np.full(n_mfcc, np.sqrt(1.0 / (2.0 * n_mel)))
        f[0] = np.sqrt(1.0 / (4.0 * n_mel))
        d = d * f[None, :]
    elif norm is not None:
        raise ValueError(f"unknown dct norm: {norm!r}")
    return d.astype(np.float32)

def mfcc(
    wav,
    sr: int,
    *,
    n_mfcc: int = 13,
    n_mel: int = 128,
    lifter: float = 0.0,
    log: str = "power_db",
    spec: str = "power",
    top_db: float | None = None,
    **mel_kwargs,
):
    """Batched MFCCs: (T,) or (B, T) -> (B?, n_frames, n_mfcc) tensor.

    librosa-convention pipeline: mel on the POWER spectrum
    (``spec='power'``), ``power_to_db``, then an orthonormal DCT-II along
    the mel axis as one true-f32 (n_frames, n_mel) x (n_mel, n_mfcc) GEMM.
    ``lifter`` applies librosa's sinusoidal liftering
    ``1 + (L/2)·sin(pi·(1..n_mfcc)/L)``.  Remaining keyword arguments
    (win_ms, hop_ms, fmin, fmax, precision, device, ...) pass through to
    :func:`log_mel_spectrogram`.
    """
    feats = log_mel_spectrogram(
        wav, sr, n_mel=n_mel, log=log, spec=spec, top_db=top_db,
        **mel_kwargs,
    )
    d = torch.from_numpy(_dct2_matrix(n_mfcc, n_mel)).to(feats.device)
    with precision_for("parity"):
        out = feats @ d
    if lifter:
        if lifter < 0:
            raise ValueError(f"lifter must be >= 0, got {lifter}")
        idx = np.arange(1, n_mfcc + 1, dtype=np.float64)
        li = (1.0 + (lifter / 2.0) * np.sin(np.pi * idx / lifter)).astype(
            np.float32
        )
        out = out * torch.from_numpy(li).to(out.device)
    return out


def _pcen_core(mel, gain, bias, power, eps, b):
    """Smoother + compression on a (B, T, n_mel) mel-power batch.

    The per-band first-order IIR  M[t] = (1-b) M[t-1] + b E[t]  runs as a
    pole scan along the frame axis (``ops/scan.py``), M[0] = E[0]:
    steady-state init, no attack transient at the clip start."""
    u = torch.cat([mel[:, :1], _f32(b) * mel[:, 1:]], dim=1)
    m = pole_scan(u, 1.0 - _f32(b), dim=1)
    f32 = np.float32
    smooth = torch.exp(-float(f32(gain)) * torch.log(float(f32(eps)) + m))
    bias = float(f32(bias))
    power = float(f32(power))
    return (mel * smooth + bias) ** power - float(f32(bias ** power))


def pcen(
    wav,
    sr: int,
    *,
    n_mel: int = 128,
    win_ms: float = 25.0,
    hop_ms: float = 10.0,
    gain: float = 0.98,
    bias: float = 2.0,
    power: float = 0.5,
    time_constant: float = 0.4,
    eps: float = 1e-6,
    precision: str | None = None,
    **mel_kwargs,
):
    """Per-channel energy normalization: (T,) or (B, T) ->
    (B?, n_frames, n_mel) tensor.

    An AGC stage divides the mel POWER spectrogram by a per-band temporal
    smoother raised to ``gain``, then a root compression
    ``(x + bias)^power - bias^power`` (Wang et al. 2017).  The smoother
    ``M[t] = (1-b) M[t-1] + b E[t]`` is one scan over the frame axis for
    every band and batch row, with ``M[0] = E[0]``; ``b`` derives from
    ``time_constant`` seconds as ``(sqrt(1 + 4 t^2) - 1) / (2 t^2)`` with
    ``t = time_constant * sr / hop_length``.  ``**mel_kwargs`` pass
    through to :func:`log_mel_spectrogram` (fmin/fmax/win_length/device).
    """
    if not 0.0 <= gain <= 1.0:
        raise ValueError(f"gain must be in [0, 1], got {gain}")
    if bias < 0 or eps <= 0 or power <= 0 or time_constant <= 0:
        raise ValueError(
            f"need bias >= 0, eps > 0, power > 0, time_constant > 0: "
            f"{bias}, {eps}, {power}, {time_constant}"
        )
    hop_length = mel_kwargs.get("hop_length") or int(
        round(hop_ms * sr / 1000.0))
    mel = log_mel_spectrogram(
        wav, sr, n_mel=n_mel, win_ms=win_ms, hop_ms=hop_ms,
        spec="power", log="linear", precision=precision, **mel_kwargs,
    )
    squeeze = mel.ndim == 2
    if squeeze:
        mel = mel[None]
    t = time_constant * sr / hop_length
    b = (math.sqrt(1.0 + 4.0 * t * t) - 1.0) / (2.0 * t * t)
    out = _pcen_core(mel, gain, bias, power, eps, b)
    return out[0] if squeeze else out


def delta(feats, *, width: int = 9, order: int = 1, axis: int = -2,
          device=None):
    """Local polynomial-fit derivative of a feature sequence — a
    Savitzky-Golay filter with ``polyorder = deriv = order`` over an odd
    ``width``-frame window (librosa.feature.delta's parameterization),
    with replicated edges (scipy's ``mode='nearest'``), as one true-f32
    convolution on the device.

    ``feats``: (..., n_frames, n_feat) by default (``axis=-2`` is the
    frame axis, matching this module's outputs), numpy or a tensor.
    """
    if width < 3 or width % 2 != 1:
        raise ValueError(f"width must be an odd integer >= 3, got {width}")
    if order < 1 or order >= width:
        raise ValueError(f"order must be in [1, width), got {order}")
    from scipy.signal import savgol_coeffs

    # ordered for convolution (use='conv'); conv1d correlates, so the
    # kernel goes in flipped
    k = savgol_coeffs(width, order, deriv=order,
                      delta=1.0).astype(np.float32)[::-1].copy()
    x = as_f32(feats, device)
    x = torch.movedim(x, axis, -1)  # (..., n_feat, n_frames)
    half = width // 2
    xp = torch.cat([x[..., :1].expand(*x.shape[:-1], half), x,
                    x[..., -1:].expand(*x.shape[:-1], half)], dim=-1)
    lead = xp.shape[:-1]
    with precision_for("parity"):
        y = torch.nn.functional.conv1d(
            xp.reshape(-1, 1, xp.shape[-1]),
            torch.from_numpy(k).to(x.device)[None, None])
    return torch.movedim(y.reshape(*lead, x.shape[-1]), -1, axis)


def _spectral_core(padded_b, c, s, *, win, hop, n_frames, mode, sr,
                   rolloff_pct):
    n_freq = c.shape[1]
    freqs = (torch.arange(n_freq, dtype=torch.float32, device=c.device)
             * _f32(sr / 2.0) / _f32(n_freq - 1))
    with precision_for("parity"):
        frames, re, im = _dft_pair(padded_b, c, s, win=win, hop=hop,
                                   n_frames=n_frames, mode=mode)
    p = re * re + im * im  # power spectrum (B, n_frames, n_freq)
    tot = p.sum(dim=-1)
    safe = torch.clamp(tot, min=1e-20)
    centroid = (p * freqs).sum(dim=-1) / safe
    spread = (p * (freqs - centroid[..., None]) ** 2).sum(dim=-1) / safe
    bandwidth = torch.sqrt(spread)
    # rolloff: lowest frequency where cumulative power >= pct * total
    hit = torch.cumsum(p, dim=-1) >= (_f32(rolloff_pct) * tot)[..., None]
    idx = torch.argmax(hit.to(torch.int32), dim=-1)  # first True (none: 0)
    rolloff = freqs[idx]
    # flatness: geometric / arithmetic mean of the power spectrum
    pc = torch.clamp(p, min=1e-10)
    flatness = torch.exp(torch.log(pc).mean(dim=-1)) / pc.mean(dim=-1)
    # frame RMS and zero-crossing rate from the raw frames
    rms = torch.sqrt((frames * frames).mean(dim=-1))
    sgn = torch.where(frames >= 0, 1.0, -1.0)
    crossings = ((sgn[..., 1:] - sgn[..., :-1]).abs() * 0.5).sum(dim=-1)
    zcr = crossings * _f32(sr / win)  # crossings per second
    return torch.stack([centroid, bandwidth, rolloff, flatness, rms, zcr],
                       dim=-1)



SPECTRAL_FEATURE_NAMES = (
    "centroid_hz", "bandwidth_hz", "rolloff_hz", "flatness", "rms",
    "zcr_hz",
)

def spectral_features(
    wav,
    sr: int,
    *,
    win_length: int | None = None,
    hop_length: int | None = None,
    n_fft: int | None = None,
    win_ms: float = 25.0,
    hop_ms: float = 10.0,
    rolloff_pct: float = 0.85,
    precision: str | None = None,
    device=None,
):
    """Per-frame spectral descriptors: (T,) or (B, T) -> (B?, n_frames, 6)
    tensor.

    Columns (``SPECTRAL_FEATURE_NAMES``): power-weighted spectral centroid
    and bandwidth (Hz), ``rolloff_pct`` spectral rolloff (Hz), spectral
    flatness, frame RMS, and zero-crossing rate (crossings/s), from one
    framing and one windowed-DFT GEMM pair.  Framing/windowing conventions
    match :func:`log_mel_spectrogram` (centered, reflect-padded, unscaled
    periodic hann).
    """
    wav, squeeze, device = _batch(wav, device)
    win_length, hop_length, n_fft = _geometry(sr, win_length, hop_length,
                                              n_fft, win_ms, hop_ms)
    if not (0.0 < rolloff_pct <= 1.0):
        raise ValueError(f"rolloff_pct must be in (0, 1], got {rolloff_pct}")
    precision = _check_precision(precision)
    c, s = _dft_operands(win_length, n_fft, device)
    out = _spectral_core(
        pad_batch(wav, win_length).to(device), c, s, win=win_length,
        hop=hop_length, n_frames=n_frames_for(wav.shape[1], win_length,
                                              hop_length),
        mode=precision, sr=sr, rolloff_pct=float(rolloff_pct))
    return out[0] if squeeze else out


def _contrast_bands(sr: int, n_fft: int, fmin: float, n_bands: int,
                    quantile: float):
    """Static octave-band slices for :func:`spectral_contrast`.

    Host-side derivation (band edges are data-independent, so the device
    core sees them as static slice bounds): band k spans
    ``[fmin * 2^(k-1), fmin * 2^k]`` Hz (band 0 starts at 0).  Following
    the classic formulation (Jiang 2002 / librosa.feature
    .spectral_contrast), band k > 0 also includes the bin just below its
    first, the top band extends to Nyquist, the quantile count is taken
    on that widened width, and every band but the top drops its last bin
    before the quantile means.  Returns ``((start, stop, q), ...)``.
    """
    n_freq = n_fft // 2 + 1
    freq = np.arange(n_freq) * (sr / n_fft)
    octa = np.zeros(n_bands + 2)
    octa[1:] = fmin * (2.0 ** np.arange(0, n_bands + 1))
    if np.any(octa[:-1] >= 0.5 * sr):
        raise ValueError(
            f"octave bands exceed Nyquist: fmin={fmin}, n_bands={n_bands} "
            f"needs sr > {2 * octa[-2]:g}")
    bands = []
    for k in range(n_bands + 1):
        idx = np.flatnonzero((freq >= octa[k]) & (freq <= octa[k + 1]))
        if idx.size == 0:
            raise ValueError(
                f"octave band {k} ({octa[k]:g}-{octa[k + 1]:g} Hz) has no "
                f"FFT bins; increase n_fft or lower fmin")
        start = idx[0] - 1 if k > 0 else idx[0]
        full_stop = n_freq if k == n_bands else idx[-1] + 1
        q = max(1, int(np.rint(quantile * (full_stop - start))))
        stop = full_stop if k == n_bands else full_stop - 1  # drop last bin
        bands.append((int(start), int(max(stop, start + 1)), int(q)))
    return tuple(bands)

def _contrast_core(padded_b, c, s, *, win, hop, n_frames, mode, bands,
                   linear):
    amin = 1e-10
    with precision_for("parity"):
        _, re, im = _dft_pair(padded_b, c, s, win=win, hop=hop,
                              n_frames=n_frames, mode=mode)
    mag = torch.sqrt(re * re + im * im)  # magnitude, per the classic spec
    cols = []
    for start, stop, q in bands:
        srt = torch.sort(mag[..., start:stop], dim=-1).values
        valley = torch.clamp(srt[..., :q].mean(dim=-1), min=amin)
        peak = torch.clamp(srt[..., -q:].mean(dim=-1), min=amin)
        if linear:
            cols.append(peak / valley)
        else:
            cols.append(10.0 * (torch.log10(peak) - torch.log10(valley)))
    return torch.stack(cols, dim=-1)


def spectral_contrast(
    wav,
    sr: int,
    *,
    win_length: int | None = None,
    hop_length: int | None = None,
    n_fft: int | None = None,
    win_ms: float = 25.0,
    hop_ms: float = 10.0,
    fmin: float = 200.0,
    n_bands: int = 6,
    quantile: float = 0.02,
    linear: bool = False,
    precision: str | None = None,
    device=None,
):
    """Octave-band spectral contrast: (T,) or (B, T) -> (B?, n_frames,
    n_bands + 1) tensor.

    Per frame and octave band (band 0 = [0, fmin], band k = one octave up
    each), sort the band's magnitude bins, average the top and bottom
    ``quantile`` fractions, and report ``10*log10(peak/valley)`` dB
    (``linear=True`` returns the raw ratio) — the Jiang 2002 feature, with
    no top_db display clamp.  Framing/windowing conventions match
    :func:`log_mel_spectrogram`.
    """
    wav, squeeze, device = _batch(wav, device)
    win_length, hop_length, n_fft = _geometry(sr, win_length, hop_length,
                                              n_fft, win_ms, hop_ms)
    if not (0.0 < quantile < 1.0):
        raise ValueError(f"quantile must be in (0, 1), got {quantile}")
    if n_bands < 1:
        raise ValueError(f"n_bands must be >= 1, got {n_bands}")
    if fmin <= 0:
        raise ValueError(f"fmin must be > 0, got {fmin}")
    precision = _check_precision(precision)
    bands = _contrast_bands(sr, n_fft, float(fmin), int(n_bands),
                            float(quantile))
    c, s = _dft_operands(win_length, n_fft, device)
    out = _contrast_core(
        pad_batch(wav, win_length).to(device), c, s, win=win_length,
        hop=hop_length, n_frames=n_frames_for(wav.shape[1], win_length,
                                              hop_length),
        mode=precision, bands=bands, linear=bool(linear))
    return out[0] if squeeze else out


def chroma_filterbank(
    sr: int,
    n_fft: int,
    *,
    n_chroma: int = 12,
    tuning: float = 0.0,
    ctroct: float = 5.0,
    octwidth: float = 2.0,
    base_c: bool = True,
) -> np.ndarray:
    """Chroma (pitch-class) filterbank -> (n_fft//2+1, n_chroma) f32.

    Host-side constant builder in the repo convention (bins as ROWS so
    application is one ``spec @ fb`` GEMM).  The design follows the
    classic Ellis chromagram (librosa.filters.chroma; librosa is not in
    this image): each FFT bin's pitch measured in fractional chroma bins
    above A0 (27.5 Hz), a Gaussian of one-bin-gap width around each of
    the ``n_chroma`` classes with wrap-around distance, per-bin L2
    normalization, and a log-frequency Gaussian envelope centered
    ``ctroct`` octaves up (soft-ignores very low/high bins).  ``base_c``
    rotates class 0 to C (otherwise A).
    """
    if n_chroma < 2:
        raise ValueError(f"n_chroma must be >= 2, got {n_chroma}")
    n_freq = n_fft // 2 + 1
    freqs = np.arange(1, n_fft, dtype=np.float64) * sr / n_fft  # skip DC
    a0 = 27.5 * 2.0 ** (tuning / n_chroma)
    frqbins = n_chroma * np.log2(freqs / a0)
    frqbins = np.concatenate([[frqbins[0] - 1.5 * n_chroma], frqbins])
    binwidth = np.concatenate(
        [np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]]
    )
    d = frqbins[None, :] - np.arange(n_chroma, dtype=np.float64)[:, None]
    half = round(n_chroma / 2)
    d = np.remainder(d + half + 10 * n_chroma, n_chroma) - half
    wts = np.exp(-0.5 * (2.0 * d / binwidth[None, :]) ** 2)
    wts /= np.maximum(np.sqrt((wts**2).sum(axis=0)), 1e-30)[None, :]
    if octwidth is not None and octwidth > 0:
        wts *= np.exp(
            -0.5 * ((frqbins / n_chroma - ctroct) / octwidth) ** 2
        )[None, :]
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, :n_freq].T, dtype=np.float32)

def _chroma_core(padded_b, c, s, fb, *, win, hop, n_frames, mode, norm):
    rnd = _rounder(mode)
    with precision_for("parity"):
        _, re, im = _dft_pair(padded_b, c, s, win=win, hop=hop,
                              n_frames=n_frames, mode=mode)
        ch = rnd(re * re + im * im) @ rnd(fb)
    if norm == "inf":
        ch = ch / torch.clamp(ch.amax(dim=-1, keepdim=True), min=1e-30)
    elif norm == "l2":
        ch = ch / torch.clamp(
            torch.sqrt((ch * ch).sum(dim=-1, keepdim=True)), min=1e-30)
    return ch


def chroma_stft(
    wav,
    sr: int,
    *,
    n_chroma: int = 12,
    win_length: int | None = None,
    hop_length: int | None = None,
    n_fft: int | None = None,
    win_ms: float = 25.0,
    hop_ms: float = 10.0,
    tuning: float = 0.0,
    norm: str = "inf",
    precision: str | None = None,
    device=None,
):
    """Chromagram: (T,) or (B, T) -> (B?, n_frames, n_chroma) tensor.

    Power spectrum projected onto pitch classes (one more GEMM after the
    windowed-DFT pair) and normalized per frame (``norm``: 'inf' — each
    frame's max is 1 — 'l2', or 'none').  Class 0 is C.
    Framing/windowing conventions match :func:`log_mel_spectrogram`.
    """
    wav, squeeze, device = _batch(wav, device)
    win_length, hop_length, n_fft = _geometry(sr, win_length, hop_length,
                                              n_fft, win_ms, hop_ms)
    if norm not in ("inf", "l2", "none"):
        raise ValueError(f"unknown norm: {norm!r}")
    precision = _check_precision(precision)
    c, s = _dft_operands(win_length, n_fft, device)
    fb = torch.from_numpy(chroma_filterbank(
        sr, n_fft, n_chroma=n_chroma, tuning=tuning)).to(device)
    out = _chroma_core(
        pad_batch(wav, win_length).to(device), c, s, fb, win=win_length,
        hop=hop_length, n_frames=n_frames_for(wav.shape[1], win_length,
                                              hop_length),
        mode=precision, norm=norm)
    return out[0] if squeeze else out


def onset_strength(
    wav,
    sr: int,
    *,
    n_mel: int = 128,
    win_ms: float = 25.0,
    hop_ms: float = 10.0,
    lag: int = 1,
    precision: str | None = None,
    device=None,
):
    """Spectral-flux onset envelope: (T,) or (B, T) -> (B?, n_frames)
    tensor on the device.

    Mean over mel bands of the positive log-power increase
    ``max(0, dB[t] - dB[t - lag])``.  First ``lag`` frames are 0.
    """
    if lag < 1:
        raise ValueError(f"lag must be >= 1, got {lag}")
    # top_db=80 is load-bearing: without the clamp, near-floor mel bands
    # wobble by tens of dB frame-to-frame (log of leakage noise) and the
    # band-mean flux of a STEADY tone drowns real onsets
    s_db = log_mel_spectrogram(
        wav, sr, n_mel=n_mel, win_ms=win_ms, hop_ms=hop_ms,
        spec="power", log="power_db", top_db=80.0, precision=precision,
        device=device,
    )
    diff = torch.clamp(
        s_db[..., lag:, :] - s_db[..., :-lag, :], min=0.0).mean(dim=-1)
    env = torch.nn.functional.pad(diff, (lag, 0))
    # frames whose window crosses the signal END see the reflection's
    # time-reversal corner — a broadband burst that reads as a large
    # fake onset.  Zero them; the matching START corner is the genuine
    # signal-begins onset and stays.
    n = wav.shape[-1] if hasattr(wav, "shape") else len(wav)
    win = int(round(win_ms * sr / 1000.0))
    hop = int(round(hop_ms * sr / 1000.0))
    first_bad = max(0, int(np.floor((n - win / 2) / hop)) + 1)
    if first_bad < env.shape[-1]:
        env[..., first_bad:] = 0.0
    return env


def _peak_pick(env: np.ndarray, pre_max: int, post_max: int, pre_avg: int,
               post_avg: int, delta: float, wait: int) -> np.ndarray:
    """Greedy novelty peak picking (the standard librosa-style rule):
    a frame is an onset iff it is the max of [i-pre_max, i+post_max],
    exceeds the local mean of [i-pre_avg, i+post_avg] by ``delta``, and
    is at least ``wait`` frames after the previous onset.  Host-side —
    the envelope is tiny and the wait rule is inherently greedy."""
    n = len(env)
    idx = []
    last = -(wait + 1)
    for i in range(n):
        seg = env[max(0, i - pre_max): i + post_max + 1]
        if env[i] < seg.max():
            continue
        ref = env[max(0, i - pre_avg): i + post_avg + 1].mean()
        if env[i] >= ref + delta and i - last > wait:
            idx.append(i)
            last = i
    return np.asarray(idx, np.int64)

def onset_detect(
    wav,
    sr: int,
    *,
    n_mel: int = 128,
    win_ms: float = 25.0,
    hop_ms: float = 10.0,
    delta: float = 3.0,
    units: str = "time",
    precision: str | None = None,
    device=None,
):
    """Onset times: (T,) -> 1-D host array of seconds (``units='frames'``
    for frame indices).

    :func:`onset_strength` (device) followed by msv_tpu's greedy peak
    picking on the host with the 30 ms max / 100 ms mean / 30 ms wait
    windows; ``delta`` is absolute, in the envelope's units (mean positive
    dB rise per band).
    """
    if units not in ("time", "frames"):
        raise ValueError(f"units must be 'time'|'frames': {units!r}")
    env = onset_strength(
        wav, sr, n_mel=n_mel, win_ms=win_ms, hop_ms=hop_ms,
        precision=precision, device=device,
    ).cpu().numpy()
    if env.ndim != 1:
        raise ValueError("onset_detect takes a single (T,) signal")
    hop_s = hop_ms / 1000.0
    to_frames = lambda sec: max(1, int(round(sec / hop_s)))  # noqa: E731
    idx = _peak_pick(env, pre_max=to_frames(0.03), post_max=to_frames(0.0),
                     pre_avg=to_frames(0.1), post_avg=to_frames(0.1),
                     delta=delta, wait=to_frames(0.03))
    if units == "frames":
        return idx
    return idx.astype(np.float64) * hop_s


def analyze(wav, sr: int, *, device=None) -> dict:
    """One mono (T,) signal -> the full analysis report dict.

    Runs the whole analysis stack — BS.1770 loudness, tempo + beat
    count, Krumhansl-Schmuckler key, structure boundaries, onsets,
    Viterbi-decoded pitch/voicing, spectral descriptor medians over
    NON-SILENT frames, RMS-gated active span — every field from an
    oracle-pinned op.  Shared by ``msv_tpu_torch analyze`` and the viewer's
    ``/api/analyze/<id>``; JSON-serializable output."""
    from .ops.declick import find_clicks
    from .ops.effects import trim
    from .ops.loudness import r128_stats
    from .ops.rhythm import beat_track
    from .ops.segment import segment
    from .ops.sequence import yin_smoothed
    from .ops.tonal import estimate_key

    dur = len(wav) / sr
    r128 = r128_stats(wav, sr, device=device)
    bpm, beats = beat_track(wav, sr, device=device)
    tonic, mode, r, _ = estimate_key(wav, sr, device=device)
    bounds = segment(wav, sr, device=device) if dur >= 4.0 else np.empty(0)
    onsets = onset_detect(wav, sr, device=device)
    fmax = min(2093.0, sr / 2.0 * 0.99)
    f0, voiced = yin_smoothed(wav, sr, fmax=fmax, device=device)
    spec = spectral_features(wav, sr, device=device).cpu().numpy()
    # descriptor medians over NON-SILENT frames (same -60 dB gate as
    # split): a sparse signal's median frame is silence, whose zero
    # centroid/flatness describe nothing
    act = spec[:, 4] > spec[:, 4].max() * 10.0 ** (-60.0 / 20.0)
    spec = spec[act] if act.any() else spec
    _, (a, b) = trim(wav, sr, device=device)
    return {
        "duration_s": round(dur, 3),
        "loudness_lufs": r128["lufs"],
        "loudness_range_lu": r128["lra"],
        "true_peak_dbtp": r128["dbtp"],
        "tempo_bpm": round(float(bpm), 1),
        "n_beats": int(len(beats)),
        "key": None if tonic is None else {
            "tonic": tonic, "mode": mode, "r": round(float(r), 3)},
        "segments_s": [round(float(v), 3) for v in bounds],
        "n_onsets": int(len(onsets)),
        "voiced_fraction": round(float(voiced.mean()), 3)
        if len(voiced) else 0.0,
        "f0_median_hz": (round(float(np.median(f0[voiced])), 1)
                         if voiced.any() else None),
        "spectral": {
            "centroid_hz": round(float(np.median(spec[:, 0])), 1),
            "flatness": round(float(np.median(spec[:, 3])), 4),
            "rms": round(float(np.median(spec[:, 4])), 5),
        },
        "active_s": [round(a / sr, 3), round(b / sr, 3)],
        # defect scan (ops/declick.py): contrast-gated LPC click
        # detection; a clean recording reports 0 or a handful.  Skipped
        # (None) past 10 minutes — the two-pass AR fit over an hour
        # track would dominate the whole report's wall
        "n_clicks": (int(len(find_clicks(
            np.asarray(wav, np.float32), sr, device=device))) if dur <= 600.0 else None),
    }
