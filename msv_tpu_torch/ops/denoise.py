"""Stationary-noise reduction — noise-profile Wiener gating, ported from
``msv_tpu/ops/denoise.py``.

Framing -> windowed-rDFT GEMM pair -> power -> noise-PSD estimate ->
spectral-subtraction gain with an attenuation floor -> short time-median
gain smoothing -> masked inverse-rDFT GEMM -> overlap-add, as torch ops on
the device (the STFT round trip of ``ops/hpss.py``: true f32 GEMMs, a
``fold`` overlap-add, msv_tpu's 128-frame bucket).

Noise estimators: ``noise_span=(a_s, b_s)`` takes the mean power of the
frames in that span; otherwise the per-bin ``percentile`` of power over
the true frames, bias-corrected for exponential bin power.  The
percentile's row is msv_tpu's f32 index ``floor(f32(q) / 100 *
(n_valid - 1))``, taken on the host in f32 (an f64 index picks a
neighbouring row whenever the product lands near an integer), and read by
``kthvalue`` in column blocks (a sort of the whole plane would hold an
hour's int64 indices).  Gain: ``g = clip(1 - oversub·N_k / P_tk, floor,
1)``, ``floor = 10^(-reduction_db/20)``; the time median reflects the pad
rows across the last true row first, as msv_tpu does.
"""

import numpy as np
import torch

from ..config import precision_for
from ..utils.device import host_f32, target_device
from .hpss import _masked_istft, _median_axis, _roundtrip, _spectrum
from .stft import block_rows

__all__ = ["denoise", "wiener_gain"]


def wiener_gain(power, noise_psd, *, oversub: float, floor: float):
    """Spectral-subtraction gain (amplitude domain): see module doc."""
    g = 1.0 - float(np.float32(oversub)) * noise_psd[None, :] / torch.clamp(
        power, min=float(np.float32(1e-30)))
    return torch.clamp(g, float(np.float32(floor)), 1.0)


def _percentile_row(power, k: int):
    """Per column, the ``k``-th smallest (0-based) of the rows."""
    n, m = power.shape
    out = torch.empty(m, dtype=power.dtype, device=power.device)
    step = block_rows(n)
    for j in range(0, m, step):
        out[j:j + step] = torch.kthvalue(power[:, j:j + step], k + 1,
                                         dim=0).values
    return out


def _noise_psd(power, n_valid, f0, f1, kind, q):
    if kind == "span":
        return power[f0:f1].sum(0) / float(max(f1 - f0, 1))
    k = int(np.floor(np.float32(q) / np.float32(100.0)
                     * np.float32(n_valid - 1)))
    # bias correction: Gaussian-noise bin power is exponential, whose
    # q-th percentile is -ln(1-q/100) of the mean
    return _percentile_row(power[:n_valid], min(max(k, 0), n_valid - 1)) * (
        float(np.float32(1.0 / -np.log1p(-q / 100.0))))


def _denoise_gain(power, n_valid, f0, f1, *, kind, q, oversub, floor,
                  smooth):
    npsd = _noise_psd(power, n_valid, f0, f1, kind, q)
    g = wiener_gain(power, npsd, oversub=oversub, floor=floor)
    if smooth > 1:
        # pad rows take their reflection across the last true row
        # (scipy's mode="reflect" at any length, as msv_tpu)
        i = torch.arange(power.shape[0], device=power.device)
        src = torch.clamp(torch.where(i < n_valid, i, 2 * n_valid - 1 - i),
                          0, max(n_valid - 1, 0))
        g = _median_axis(g[src], smooth, axis=0)
    return g


def denoise(
    wav,
    win_length: int,
    hop_length: int,
    n_fft: int,
    *,
    sr: int | None = None,
    noise_span: tuple | None = None,
    percentile: float = 20.0,
    oversub: float = 1.5,
    reduction_db: float = 25.0,
    smooth_time: int = 5,
    window=None,
    device=None,
):
    """Reduce stationary noise in ``wav`` -> same-length host float32,
    computed on ``device`` (numpy input goes to the card unless ``device``
    says otherwise; a tensor's own device).

    ``noise_span=(a_s, b_s)`` profiles noise from that span in seconds
    (requires ``sr``); otherwise the per-bin ``percentile`` of power
    profiles it blind.  ``reduction_db`` caps the attenuation (the gain
    floor); ``oversub`` > 1 over-subtracts to push residual noise under
    the floor; ``smooth_time`` (odd) median-smooths the gain across
    frames.  STFT conventions match
    :func:`~msv_tpu_torch.ops.stft.perform_stft` (centered, reflect
    padding; window scale cancels in the roundtrip).
    """
    dev = target_device(wav, device)
    wav = host_f32(wav)
    if wav.ndim != 1:
        raise ValueError(f"wav must be 1-D, got {wav.shape}")
    half = win_length // 2
    if len(wav) < half + 1:
        raise ValueError(
            f"signal too short for win_length={win_length}: need at "
            f"least {half + 1} samples, got {len(wav)}")
    if smooth_time < 1 or smooth_time % 2 == 0:
        raise ValueError(f"smooth_time must be odd >= 1, got {smooth_time}")
    if not 0.0 < percentile < 100.0:
        # open interval: the exponential bias correction
        # 1/-log1p(-q/100) is infinite at 0 (NaN/fully-floored output)
        # and zero at 100 (silent no-op)
        raise ValueError(f"percentile outside (0, 100): {percentile}")
    if oversub <= 0:
        raise ValueError(f"oversub must be positive, got {oversub}")
    if reduction_db <= 0:
        raise ValueError(
            f"reduction_db must be positive, got {reduction_db}")
    padded, c, s, syn, wsq, n_frames, n_pad = _roundtrip(
        wav, win_length, hop_length, n_fft, window, dev)
    f0 = f1 = 0
    kind = "pct"
    if noise_span is not None:
        if sr is None:
            raise ValueError("noise_span needs sr")
        a_s, b_s = (float(v) for v in noise_span)
        if not 0.0 <= a_s < b_s:
            raise ValueError(f"bad noise_span {noise_span}")
        f0 = int(a_s * sr / hop_length)
        f1 = min(int(b_s * sr / hop_length), n_frames)
        if f1 - f0 < 3:
            raise ValueError(
                f"noise_span {noise_span} covers {f1 - f0} frames; "
                "need at least 3")
        kind = "span"
    geo = {"win": win_length, "hop": hop_length}
    with precision_for("parity"):
        re, im = _spectrum(padded, c, s, n_frames=n_frames, n_pad=n_pad,
                           **geo)
        g = _denoise_gain(
            re * re + im * im, n_frames, f0, f1, kind=kind,
            q=float(percentile), oversub=float(oversub),
            floor=float(10.0 ** (-reduction_db / 20.0)),
            smooth=int(smooth_time))
        out = _masked_istft(re, im, g, syn, wsq, n_fft=n_fft, **geo)
    return out[half:half + len(wav)].cpu().numpy()
