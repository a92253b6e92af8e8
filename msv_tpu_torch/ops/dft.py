"""Windowed real DFT as a GEMM: the host builders of ``msv_tpu/ops/dft.py``
(:26-96: the windowed pair, the end-padded pair, the numpy rfft oracle),
and its inverse as two GEMMs (``inverse_rdft``, :99-124).

The device computes  re = frames @ C,  im = frames @ S  with C, S of shape
(win_length, n_freq) built here on the host (f64 twiddles, cast to f32).
The analysis window and the frame's zero-pad to n_fft (lib.rs:400-401) are
folded into the matrices.  FLOPs: 2 * win * n_freq * 2 per frame.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def n_pad_split(n_fft: int, win_length: int):
    """(n_pad_left, n_pad_right) of the frame zero-pad (lib.rs:400-401)."""
    n_pad_left = (n_fft - win_length) // 2
    n_pad_right = int(np.ceil((n_fft - win_length) / 2.0))
    return n_pad_left, n_pad_right


# Rows of C and S whose f64 twiddles are made at a time, by a pool of
# threads (numpy's cos and sin release the GIL): the same values as the
# whole matrix at once, with temporaries of ROWS x n_freq (a 384 kHz
# window, 15 360 x 8193, would otherwise hold four 1 GB f64 arrays, and its
# cos and sin would run on one core).
_TWIDDLE_ROWS = 256
_TWIDDLE_THREADS = min(8, os.cpu_count() or 1)


@functools.lru_cache(maxsize=64)
def _dft_matrices_cached(win_length: int, n_fft: int, window_key, dtype_str: str):
    window = np.frombuffer(window_key, dtype=np.float32).astype(np.float64)
    n_freq = n_fft // 2 + 1
    n_pad_left, _ = n_pad_split(n_fft, win_length)
    k = np.arange(n_freq, dtype=np.float64)[None, :]
    dt = np.dtype(dtype_str)
    c = np.empty((win_length, n_freq), dt)
    s = np.empty((win_length, n_freq), dt)

    def rows(a):
        b = min(a + _TWIDDLE_ROWS, win_length)
        j = np.arange(a, b, dtype=np.float64)[:, None] + n_pad_left
        phase = -2.0 * np.pi * j * k / n_fft
        c[a:b] = window[a:b, None] * np.cos(phase)
        s[a:b] = window[a:b, None] * np.sin(phase)

    with ThreadPoolExecutor(_TWIDDLE_THREADS) as pool:
        list(pool.map(rows, range(0, win_length, _TWIDDLE_ROWS)))
    return c, s


def windowed_dft_matrices(window: np.ndarray, n_fft: int, dtype=np.float32):
    """Real/imag windowed-DFT matrices, each (win_length, n_freq).

    ``frames_raw @ C + 1j * frames_raw @ S`` equals the reference's
    rFFT of (window*frame zero-padded to n_fft)  (realfft.rs:105 output
    convention: unnormalized forward transform, n_freq = n_fft//2+1 bins).
    """
    window = np.ascontiguousarray(window, dtype=np.float32)
    return _dft_matrices_cached(
        len(window), n_fft, window.tobytes(), np.dtype(dtype).str
    )


def rdft_reference_np(frames: np.ndarray) -> np.ndarray:
    """Oracle: numpy rfft of already windowed+padded frames (tests only)."""
    return np.fft.rfft(frames, axis=-1)


@functools.lru_cache(maxsize=32)
def _irdft_matrices_cached(n_fft: int, dtype_str: str):
    n_freq = n_fft // 2 + 1
    j = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freq, dtype=np.float64)[None, :]
    phase = 2.0 * np.pi * j * k / n_fft
    # real-input inverse: x_j = (1/n) * sum_k w_k (re_k cos - im_k sin),
    # with w_k = 2 except DC and (for even n) Nyquist.
    w = np.full(n_freq, 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    dt = np.dtype(dtype_str)
    ci = (np.cos(phase) * w / n_fft).astype(dt)  # (n_fft, n_freq)
    si = (-np.sin(phase) * w / n_fft).astype(dt)
    return ci, si


@functools.lru_cache(maxsize=16)
def end_padded_rdft_matrices(n_rows: int, n_fft: int):
    """Real-DFT matrices for END-zero-padded rows, (n_rows, n_freq) each.

    Correlation-style analyses (YIN difference function, LPC
    autocorrelation) need the signal anchored at index 0, unlike the
    session's centered pad.  Standard rFFT sign convention:
    ``rows @ C + 1j * rows @ S == np.fft.rfft(rows, n_fft)``.
    """
    j = np.arange(n_rows, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * j * k / n_fft
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


def inverse_rdft(spec, n_fft: int):
    """Inverse of the real DFT (reference: ``InvRealFFT``, realfft.rs:166-242),
    as two f32 GEMMs (TF32 off on the card, as every caller's forward).

    ``spec``: (..., n_fft//2+1) complex tensor, or a (re, im) pair of real
    tensors.  Returns the real signal (..., n_fft), normalized by 1/n_fft
    (a true inverse of the unnormalized forward transform)."""
    import torch

    re, im = spec if isinstance(spec, tuple) else (spec.real, spec.imag)
    ci, si = (torch.from_numpy(a).to(re.device)
              for a in _irdft_matrices_cached(n_fft, "<f4"))
    return re @ ci.T + im @ si.T
