"""The dB plane of a track on either frequency scale and the session's dB
window, in float32 with TF32 off: reflect-padded centered frames, a
periodic Hann window divided by n_fft, an FFT of n_fft points, the
magnitude, on the mel scale the mel product, and 20 log10 with the 1e-18
floor (thesia src_rust/lib.rs:112-136, 388-433; decibel.rs:33-56)."""

import math

import numpy as np
import torch

from .melfb import hz_to_mel, mel_fb_auto

f32 = np.float32
AMIN = 1e-18
BLOCK_FRAMES = 16384


def stft_params(sr: int, setting: dict):
    """(win, hop, n_fft) of a rate (lib.rs:43-46, in float32): hop is
    win_ms * sr / 1000 / t_overlap rounded half away from zero."""
    win_f = f32(setting["win_ms"]) * f32(sr) / f32(1000.0)
    hop = int(np.floor(win_f / f32(setting["t_overlap"]) + f32(0.5)))
    win = hop * setting["t_overlap"]
    n_fft = (1 << max(win - 1, 0).bit_length()) * setting["f_overlap"]
    return win, hop, n_fft


def n_frames(n_samples: int, win: int, hop: int) -> int:
    return (n_samples + 2 * (win // 2) - win) // hop + 1


def up_ratio(sr: int, max_sr: int) -> float:
    """mel(max_sr / 2) / mel(sr / 2) in float32 (lib.rs:231-248)."""
    return float(hz_to_mel(f32(max_sr) / f32(2.0))
                 / hz_to_mel(f32(sr) / f32(2.0)))


def up_ratio_for(sr: int, max_sr: int, freq_scale: str) -> float:
    """The grey's alignment ratio on the session's scale: max_sr / sr in
    float32 on the linear scale, :func:`up_ratio` on the mel scale
    (lib.rs:231-248)."""
    if freq_scale == "linear":
        return float(f32(max_sr) / f32(sr))
    return up_ratio(sr, max_sr)


def grey_height(n_bins: int, ratio: float) -> int:
    v = f32(n_bins) * f32(ratio)
    return int(np.floor(v + f32(0.5)))


def mono_f32(pcm: np.ndarray) -> np.ndarray:
    """(channels, n) int16 -> the channel sum in float32 units of 2^-15."""
    s = pcm.astype(np.int32).sum(axis=0, dtype=np.int32)
    return s.astype(np.float32) * f32(2.0 ** -15)


def mel_db(mono: np.ndarray, sr: int, setting: dict, device) -> torch.Tensor:
    """(n_frames, n_mel) float32 dB plane on ``device``, in blocks of
    BLOCK_FRAMES frames."""
    _, _, n_fft = stft_params(sr, setting)
    return _db_plane(mono, sr, setting, device, mel_fb_auto(sr, n_fft))


def linear_db(mono: np.ndarray, sr: int, setting: dict,
              device) -> torch.Tensor:
    """(n_frames, n_fft // 2 + 1) float32 dB plane on ``device``, in blocks
    of BLOCK_FRAMES frames: the magnitude's bins as they are."""
    return _db_plane(mono, sr, setting, device, None)


def _db_plane(mono, sr, setting, device, fb) -> torch.Tensor:
    """The frames' magnitudes, times ``fb`` where it is not None, in dB."""
    win, hop, n_fft = stft_params(sr, setting)
    nf = n_frames(len(mono), win, hop)
    half = win // 2
    x = torch.from_numpy(np.pad(mono, (half, half), mode="reflect")).to(device)
    window = np.arange(win + 1, dtype=np.float32)
    window = (f32(0.5) - f32(0.5) * np.cos(f32(2.0) * (f32(np.pi) * window
                                                       / f32(win))))[:win]
    window = torch.from_numpy((window / f32(n_fft)).astype(np.float32)).to(
        device)
    left = (n_fft - win) // 2
    if fb is not None:
        fb = torch.from_numpy(fb).to(device)
    n_out = n_fft // 2 + 1 if fb is None else fb.shape[1]
    out = torch.empty((nf, n_out), dtype=torch.float32, device=device)
    floor = 20.0 * math.log10(AMIN)
    tf32 = torch.backends.cuda.matmul
    prev = tf32.allow_tf32
    tf32.allow_tf32 = False
    try:
        for a in range(0, nf, BLOCK_FRAMES):
            b = min(nf, a + BLOCK_FRAMES)
            seg = x[a * hop:(b - 1) * hop + win]
            fr = seg.unfold(0, win, hop) * window
            fr = torch.nn.functional.pad(fr, (left, n_fft - win - left))
            mag = torch.fft.rfft(fr, n=n_fft).abs()
            if fb is not None:
                mag = mag @ fb
            out[a:b] = torch.where(mag > AMIN, 20.0 * torch.log10(mag),
                                   torch.full_like(mag, floor))
    finally:
        tf32.allow_tf32 = prev
    return out


def db_window(smins, smaxs, db_range: float):
    """(max_db, min_db) of a session: max_db = min(global max, 0), min_db =
    max(global min, max_db - db_range) (lib.rs:193-218)."""
    gmax = min(max(smaxs), 0.0)
    return gmax, max(min(smins), gmax - db_range)
