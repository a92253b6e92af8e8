"""The mel dB plane of a track and the session's dB window, in float32
with TF32 off: reflect-padded centered frames, a periodic Hann window
divided by n_fft, an FFT of n_fft points, the magnitude, the mel product
and 20 log10 with the 1e-18 floor (thesia src_rust/lib.rs:112-136,
388-433; decibel.rs:33-56)."""

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


def grey_height(n_mel: int, ratio: float) -> int:
    v = f32(n_mel) * f32(ratio)
    return int(np.floor(v + f32(0.5)))


def mono_f32(pcm: np.ndarray) -> np.ndarray:
    """(channels, n) int16 -> the channel sum in float32 units of 2^-15."""
    s = pcm.astype(np.int32).sum(axis=0, dtype=np.int32)
    return s.astype(np.float32) * f32(2.0 ** -15)


def mel_db(mono: np.ndarray, sr: int, setting: dict, device) -> torch.Tensor:
    """(n_frames, n_mel) float32 dB plane on ``device``, in blocks of
    BLOCK_FRAMES frames."""
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
    fb = torch.from_numpy(mel_fb_auto(sr, n_fft)).to(device)
    out = torch.empty((nf, fb.shape[1]), dtype=torch.float32, device=device)
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
            mel = torch.fft.rfft(fr, n=n_fft).abs() @ fb
            out[a:b] = torch.where(mel > AMIN, 20.0 * torch.log10(mel),
                                   torch.full_like(mel, floor))
    finally:
        tf32.allow_tf32 = prev
    return out


def db_window(smins, smaxs, db_range: float):
    """(max_db, min_db) of a session: max_db = min(global max, 0), min_db =
    max(global min, max_db - db_range) (lib.rs:193-218)."""
    gmax = min(max(smaxs), 0.0)
    return gmax, max(min(smins), gmax - db_range)
