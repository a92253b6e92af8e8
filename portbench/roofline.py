"""Peaks of the card and the least time of the dB functions of either
frequency scale.

The least time counts the work of the function, not of a kernel that
implements it: a real FFT of n_fft points a frame, the magnitude and, on
the mel scale, the band-sparse mel product; the track's PCM16 samples read
once, the f32 dB plane written once, the nonzero filterbank weights read
once.  So any implementation of the same planes is held to the same floor.
"""

import math

import numpy as np

from .reference.melfb import mel_fb_auto
from .reference.spec import n_frames, stft_params

# NVIDIA H100 SXM, published dense rates at the 700 W limit.
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_HBM_BYTES_PER_S = 3.35e12
PCM_BYTES = 2  # the files are PCM16


def mel_work(n_samples: int, sr: int, setting: dict):
    """(operations, bytes) of one track's mel dB plane."""
    win, hop, n_fft = stft_params(sr, setting)
    fb = mel_fb_auto(sr, n_fft)
    n_freq, n_mel = fb.shape
    w = int(np.count_nonzero(fb))
    f = n_frames(n_samples, win, hop)
    ops = f * (2.5 * n_fft * math.log2(n_fft) + 3 * n_freq + 2 * w)
    nbytes = PCM_BYTES * n_samples + 4 * f * n_mel + 4 * w
    return ops, nbytes


def linear_work(n_samples: int, sr: int, setting: dict):
    """(operations, bytes) of one track's linear-scale dB plane: the mel
    plane's terms less the filterbank's, with n_fft // 2 + 1 bins out."""
    win, hop, n_fft = stft_params(sr, setting)
    n_freq = n_fft // 2 + 1
    f = n_frames(n_samples, win, hop)
    ops = f * (2.5 * n_fft * math.log2(n_fft) + 3 * n_freq)
    nbytes = PCM_BYTES * n_samples + 4 * f * n_freq
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
