"""Windowed real DFT as a GEMM: the host builders of ``msv_tpu/ops/dft.py``
(:26-96), and its inverse as two GEMMs (``inverse_rdft``, :99-124).

The device computes  re = frames @ C,  im = frames @ S  with C, S of shape
(win_length, n_freq) built here on the host (f64 twiddles, cast to f32).
The analysis window and the frame's zero-pad to n_fft (lib.rs:400-401) are
folded into the matrices.  FLOPs: 2 * win * n_freq * 2 per frame.
"""

import functools

import numpy as np


def n_pad_split(n_fft: int, win_length: int):
    """(n_pad_left, n_pad_right) of the frame zero-pad (lib.rs:400-401)."""
    n_pad_left = (n_fft - win_length) // 2
    n_pad_right = int(np.ceil((n_fft - win_length) / 2.0))
    return n_pad_left, n_pad_right


@functools.lru_cache(maxsize=64)
def _dft_matrices_cached(win_length: int, n_fft: int, window_key, dtype_str: str):
    window = np.frombuffer(window_key, dtype=np.float32).astype(np.float64)
    n_freq = n_fft // 2 + 1
    n_pad_left, _ = n_pad_split(n_fft, win_length)
    j = np.arange(win_length, dtype=np.float64)[:, None] + n_pad_left
    k = np.arange(n_freq, dtype=np.float64)[None, :]
    phase = -2.0 * np.pi * j * k / n_fft
    c = window[:, None] * np.cos(phase)
    s = window[:, None] * np.sin(phase)
    dt = np.dtype(dtype_str)
    return c.astype(dt), s.astype(dt)


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
