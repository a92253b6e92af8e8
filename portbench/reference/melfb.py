"""Slaney-style triangular mel filterbank with the automatic band count,
frozen from the viewer's definition (thesia src_rust/mel.rs:33-99: librosa
0.8 ``filters.mel``, htk=False, each column divided by its sampled sum).

Host numpy in float32, as the definition computes it.
"""

import numpy as np

MIN_LOG_MEL = 15
MIN_LOG_HZ = 1000.0
LOGSTEP = 0.06875177742094912  # ln(6.4) / 27
LINEARSCALE = 200.0 / 3.0
f32 = np.float32


def hz_to_mel(freq):
    """Forward mel scale in the argument's float type (float32 here)."""
    freq = np.asarray(freq, np.float32)
    lin = freq / f32(LINEARSCALE)
    with np.errstate(divide="ignore", invalid="ignore"):
        log = f32(MIN_LOG_MEL) + np.log(freq / f32(MIN_LOG_HZ)) / f32(LOGSTEP)
    out = np.where(freq < f32(MIN_LOG_HZ), lin, log).astype(np.float32)
    return out[()] if out.ndim == 0 else out


def mel_to_hz(mel):
    mel = np.asarray(mel, np.float32)
    lin = f32(LINEARSCALE) * mel
    log = f32(MIN_LOG_HZ) * np.exp(f32(LOGSTEP) * (mel - f32(MIN_LOG_MEL)))
    out = np.where(mel < f32(MIN_LOG_MEL), lin, log).astype(np.float32)
    return out[()] if out.ndim == 0 else out


def _linspace(start, stop, num):
    step = (f32(stop) - f32(start)) / f32(num - 1)
    return (f32(start) + step * np.arange(num, dtype=np.float32)).astype(
        np.float32)


def mel_fb(sr: int, n_fft: int, n_mel: int) -> np.ndarray:
    """(n_fft // 2 + 1, n_mel) float32 weights, 0 Hz to Nyquist."""
    nyq = f32(f32(sr) / f32(2.0))
    n_freq = n_fft // 2 + 1
    f = _linspace(0.0, nyq, n_freq)[:, None]
    m = mel_to_hz(_linspace(hz_to_mel(f32(0.0)), hz_to_mel(nyq), n_mel + 2))
    m0, m1, m2 = m[None, :-2], m[None, 1:-1], m[None, 2:]
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.where((m0 < f) & (f < m1), (f - m0) / (m1 - m0),
                     np.where(f == m1, f32(1.0),
                              np.where((m1 < f) & (f < m2),
                                       (m2 - f) / (m2 - m1), f32(0.0))))
    w = w.astype(np.float32)
    s = np.maximum(w.sum(axis=0, dtype=np.float32), np.finfo(np.float32).eps)
    return (w / s).astype(np.float32)


def mel_fb_auto(sr: int, n_fft: int) -> np.ndarray:
    """The viewer's filterbank: start at floor(2 mel(sr/2) / mel(sr/n_fft)
    - 1) bands (at most n_freq) and drop bands until none is empty."""
    n_mel = int(f32(2.0) * hz_to_mel(f32(sr) / f32(2.0))
                / hz_to_mel(f32(sr) / f32(n_fft)) - f32(1.0))
    n_mel = min(n_mel, n_fft // 2 + 1)
    while True:
        fb = mel_fb(sr, n_fft, n_mel)
        if (fb.sum(axis=0) > 0).all():
            return fb
        n_mel -= 1
