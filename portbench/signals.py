"""Seeded test audio, made on the run's device in a few large calls and
written as PCM16 WAVs: swept harmonic tones over noise (the signal of the
port's chip smoke run).

``song``: per channel, four harmonics of a base frequency in 80-600 Hz
with a slow vibrato and a slow gain swing, over 0.03 white noise, at half
scale.  ``hour``: four such rows of one minute, each minute one of them at
a gain in 0.3-0.9 over fresh 0.01 noise.  The same seed gives the same
samples on the same device.
"""

import math
import os
import struct

import numpy as np
import torch


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _tones(g, sr, n, rows, device):
    """(rows, n) float64 swept tones with a gain swing, peak about 0.5."""
    t = torch.arange(n, dtype=torch.float64, device=device) / sr
    f0 = 80.0 + 520.0 * torch.rand(rows, 1, generator=g, device=device,
                                   dtype=torch.float64)
    vib = 3.0 * torch.sin(2 * math.pi * 0.1 * t)
    sig = sum((0.25 / k) * torch.sin(2 * math.pi * k * f0 * t + vib)
              for k in (1, 2, 3, 5))
    r = torch.arange(rows, device=device, dtype=torch.float64)[:, None]
    return sig * (0.55 + 0.45 * torch.sin(2 * math.pi * 0.05 * t + r))


def _pcm16(x):
    return torch.clamp(torch.round(x * 32767.0), -32768, 32767).to(
        torch.int16)


def song(g, sr, seconds, channels, device):
    n = int(round(seconds * sr))
    x = _tones(g, sr, n, channels, device)
    x = x + 0.03 * torch.randn(x.shape, generator=g, device=device,
                               dtype=torch.float32).double()
    return _pcm16(0.5 * x).cpu().numpy()


def hour(g, sr, seconds, channels, device):
    minute = 60 * sr
    minutes = int(round(seconds / 60))
    base = _tones(g, sr, minute, 4, device).float()
    gains = 0.3 + 0.6 * torch.rand(minutes, generator=g, device=device)
    out = np.empty((channels, minutes * minute), np.int16)
    for m in range(minutes):
        x = base[m % 4] * gains[m] + 0.01 * torch.randn(
            (channels, minute), generator=g, device=device)
        out[:, m * minute:(m + 1) * minute] = _pcm16(x).cpu().numpy()
    return out


KINDS = {"song": song, "hour": hour}


def write_wav(path: str, pcm: np.ndarray, sr: int) -> None:
    """PCM16 WAV of (channels, n) int16 samples."""
    ch, n = pcm.shape
    data = n * ch * 2
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + data) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, sr, sr * ch * 2,
                                      ch * 2, 16))
        f.write(b"data" + struct.pack("<I", data))
        f.write(np.ascontiguousarray(pcm.T).astype("<i2").tobytes())


def make_tracks(config: dict, seed: int, directory: str, device):
    """Write the configuration's tracks into ``directory``.  Returns one
    dict a track: path, sr, pcm ((channels, n) int16)."""
    g = _generator(seed, device)
    out = []
    for i, tr in enumerate(config["tracks"]):
        pcm = KINDS[tr["signal"]](g, tr["sr"], tr["seconds"],
                                  tr["channels"], device)
        path = os.path.join(directory, f"track{i}_{tr['sr']}.wav")
        write_wav(path, pcm, tr["sr"])
        out.append({"path": path, "sr": tr["sr"], "pcm": pcm})
    return out
