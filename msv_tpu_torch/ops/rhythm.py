"""Rhythm analysis, ported from ``msv_tpu/ops/rhythm.py``:
autocorrelation tempogram, global tempo, beat tracking.

The local autocorrelation of the onset envelope is computed for all
tempogram frames at once as GEMMs on the device: a windowed real-DFT pair
(the window and zero-pad phase folded into the matrices, ops/dft.py), a
per-frame power spectrum, and one inverse rDFT (Wiener-Khinchin), all in
true f32 (``precision_for("parity")``, as msv_tpu's HIGHEST).
``n_fft >= 2 * win_length`` keeps the circular ACF equal to the linear ACF
on the kept lag range [0, win_length).  msv_tpu padded the frame count to
128 to bound its compile cache; the pad frames only read zeros past the
envelope, so the port computes the exact frame count.

Tempo estimation (a log-normal prior over the aggregated tempogram) and
the Ellis 2007 dynamic-programming beat tracker run on the host as in
msv_tpu: the envelope is a few KB and the DP is sequential.
``_bpm_prior``, ``tempo_from_tempogram``, ``beat_track_from_envelope`` and
``oracle_tempogram_np`` are copies of msv_tpu's, pinned by
tests/test_torch_host.py.
"""

import numpy as np
import torch

from ..config import precision_for
from ..utils import next_pow2
from ..utils.device import as_f32
from .dft import inverse_rdft, windowed_dft_matrices
from .stft import frame_device
from .windows import hann


def _tempogram_core(padded, c, s, *, win, hop, n_frames, n_fft):
    with precision_for("parity"):
        frames = frame_device(padded, win, hop, n_frames)
        re = frames @ c
        im = frames @ s
        power = re * re + im * im
        # Wiener-Khinchin: IDFT of the power spectrum is the circular ACF
        # of the (windowed, zero-padded) frame; n_fft >= 2*win makes lags
        # [0, win) linear.  The centered zero-pad inside the DFT matrices
        # is a pure time shift, which the power spectrum is invariant to.
        acf = inverse_rdft((power, torch.zeros_like(power)), n_fft)[:, :win]
    return acf / torch.clamp(acf[:, :1], min=1e-10)


def tempogram_from_envelope(env, fps: float, *, win_length: int = 384,
                            hop: int = 1, device=None):
    """Local-autocorrelation tempogram of an onset envelope.

    ``env``: (T,) onset strength, numpy (to the card unless ``device``
    says otherwise) or a tensor (on its own device).  ``fps``: envelope
    frame rate (frames per second; 1000/hop_ms for the spectral-flux
    envelope).  Frames are centered (zero pad ``win_length // 2`` each
    side — the envelope is a novelty signal, zeros are the natural
    continuation) and Hann-windowed.  Returns an (n_frames, win_length)
    float32 tensor: row t, column l is the normalized ACF of the envelope
    around frame ``t * hop`` at lag ``l`` (lag 0 == 1 unless the window
    is all-zero, then the whole row is ~0).  BPM of column l (l >= 1) is
    ``60 * fps / l``.
    """
    if win_length < 4:
        raise ValueError(f"win_length must be >= 4, got {win_length}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    env = as_f32(env, device)
    if env.ndim != 1:
        raise ValueError(f"env must be 1-D, got {tuple(env.shape)}")
    t = env.shape[0]
    if t < 1:
        raise ValueError("empty envelope")
    half = win_length // 2
    n_frames = max(1 + (t + 2 * half - win_length) // hop, 1)
    need = (n_frames - 1) * hop + win_length
    padded = env.new_zeros(max(need, half + t))
    padded[half:half + t] = env
    n_fft = next_pow2(2 * win_length)
    c, s = (torch.from_numpy(m).to(env.device) for m in
            windowed_dft_matrices(hann(win_length, False), n_fft))
    return _tempogram_core(padded, c, s, win=win_length, hop=hop,
                           n_frames=n_frames, n_fft=n_fft)


def _bpm_prior(bpms: np.ndarray, start_bpm: float, std_bpm: float):
    """Log-normal perceptual tempo prior (max 1 at ``start_bpm``)."""
    with np.errstate(divide="ignore"):
        x = np.log2(np.maximum(bpms, 1e-12) / start_bpm) / std_bpm
    return np.exp(-0.5 * x * x)


def tempo_from_tempogram(tg, fps: float, *, start_bpm: float = 120.0,
                         std_bpm: float = 1.0, min_bpm: float = 30.0,
                         max_bpm: float = 320.0) -> float:
    """Global tempo (BPM) from a tempogram: aggregate rows (mean), weight
    each lag's BPM by the log-normal prior, take the best lag.  Returns
    0.0 when no lag in [min_bpm, max_bpm] exists (degenerate fps/window).
    """
    if not (0 < min_bpm < max_bpm):
        raise ValueError(f"need 0 < min_bpm < max_bpm: {min_bpm}, {max_bpm}")
    ac = np.asarray(tg, np.float64).mean(axis=0)
    lags = np.arange(len(ac), dtype=np.float64)
    with np.errstate(divide="ignore"):
        bpms = np.where(lags > 0, 60.0 * fps / np.maximum(lags, 1), np.inf)
    valid = (bpms >= min_bpm) & (bpms <= max_bpm)
    if not valid.any():
        return 0.0
    score = np.where(valid, ac * _bpm_prior(bpms, start_bpm, std_bpm),
                     -np.inf)
    return float(bpms[int(np.argmax(score))])


def beat_track_from_envelope(env, fps: float, *, bpm: float | None = None,
                             tightness: float = 100.0,
                             start_bpm: float = 120.0, device=None):
    """Beat frame indices via the Ellis 2007 dynamic program.

    ``env``: (T,) onset strength.  ``bpm``: target tempo (estimated from
    the tempogram when None).  Returns ``(bpm, beats)`` with ``beats`` an
    ascending int64 array of envelope frame indices (empty for an
    all-zero envelope — silence has no beats).

    DP spec (documented here because it IS the oracle contract):
    env is scaled by 1/std (Ellis' normalization, making ``tightness``
    signal-level-independent); candidates for a beat at i are beats at
    j in [i - 2*period, i - period//2]; transition score is
    ``-tightness * log(gap / period)^2``;
    ``cum[i] = env[i] + max(0, max_j(cum[j] + tx))`` — the max with 0
    lets a chain start anywhere without penalty.  Backtrace starts at
    the best cumulative score within the final ``period`` frames.
    """
    env = np.asarray(env, np.float64).ravel()
    n = len(env)
    if n == 0 or not np.any(env > 0):
        return (float(bpm) if bpm else 0.0,
                np.empty(0, np.int64))
    if bpm is None:
        tg = tempogram_from_envelope(
            env.astype(np.float32), fps,
            win_length=min(384, max(4, 2 * (n // 2))), device=device)
        bpm = tempo_from_tempogram(tg.cpu().numpy(), fps,
                                   start_bpm=start_bpm)
        if bpm <= 0:
            return 0.0, np.empty(0, np.int64)
    period = max(1, int(round(60.0 * fps / bpm)))
    sd = env.std()
    loc = env / sd if sd > 0 else env

    lo, hi = 2 * period, max(1, period // 2)   # gap in [hi, lo]
    gaps = np.arange(hi, lo + 1, dtype=np.float64)
    tx = -tightness * np.log(gaps / period) ** 2  # score per gap
    cum = loc.copy()
    backlink = np.full(n, -1, np.int64)
    for i in range(hi, n):
        j0 = max(0, i - lo)
        j1 = i - hi            # inclusive
        # gap for candidate j is i - j, so tx index is (i - j) - hi
        window = cum[j0: j1 + 1] + tx[(i - np.arange(j0, j1 + 1)) - hi]
        k = int(np.argmax(window))
        best = window[k]
        if best > 0:
            cum[i] = loc[i] + best
            backlink[i] = j0 + k
        # else: cum[i] stays loc[i], chain starts here

    t0 = max(0, n - period)
    end = t0 + int(np.argmax(cum[t0:]))
    beats = [end]
    while backlink[beats[-1]] >= 0:
        beats.append(int(backlink[beats[-1]]))
    beats = np.asarray(beats[::-1], np.int64)
    # Edge trim (librosa's __trim_beats remedy for the raw DP's boundary
    # wart): the backtrace starts at the best cumulative score in the
    # final period, and a near-period gap costs ~0, so a noise frame at
    # the very edge can out-score the true last beat by its own tiny
    # onset value and append a spurious beat (found by fresh-seed sweep:
    # 40 exact beats + one 0.49 s past the last click).  Trim leading/
    # trailing beats whose smoothed onset strength falls under half the
    # beat-aligned RMS; interior beats are never touched.
    if len(beats) > 1:
        w = np.hanning(5)
        sm = np.convolve(loc, w / w.sum(), mode="same")
        thr = 0.5 * float(np.sqrt(np.mean(sm[beats] ** 2)))
        lo_i, hi_i = 0, len(beats)
        while hi_i - lo_i > 1 and sm[beats[hi_i - 1]] < thr:
            hi_i -= 1
        while hi_i - lo_i > 1 and sm[beats[lo_i]] < thr:
            lo_i += 1
        beats = beats[lo_i:hi_i]
    return float(bpm), beats

def beat_track(wav, sr: int, *, hop_ms: float = 10.0, n_mel: int = 128,
               bpm: float | None = None, start_bpm: float = 120.0,
               tightness: float = 100.0, precision: str | None = None,
               device=None):
    """Tempo + beat times straight from audio: (T,) samples -> (bpm,
    beat_seconds).  The onset envelope (device GEMMs,
    :func:`msv_tpu_torch.features.onset_strength`) feeds the tempogram and
    the Ellis DP; ``beat_seconds`` is float64 seconds from signal start."""
    from ..features import onset_strength  # runtime: features imports ops

    env = onset_strength(wav, sr, n_mel=n_mel, hop_ms=hop_ms,
                         precision=precision, device=device)
    if env.ndim != 1:
        raise ValueError("beat_track takes a single (T,) signal")
    fps = 1000.0 / hop_ms
    got_bpm, beats = beat_track_from_envelope(
        env.cpu().numpy(), fps, bpm=bpm, tightness=tightness,
        start_bpm=start_bpm, device=env.device)
    return got_bpm, beats.astype(np.float64) / fps


def oracle_tempogram_np(env: np.ndarray, win_length: int,
                        hop: int = 1) -> np.ndarray:
    """From-scratch numpy oracle of :func:`tempogram_from_envelope`'s
    spec (tests only): direct O(W^2) windowed linear ACF per frame."""
    env = np.asarray(env, np.float64)
    half = win_length // 2
    padded = np.pad(env, (half, half + win_length))
    w = hann(win_length, False).astype(np.float64)
    n_frames = 1 + (len(env) + 2 * half - win_length) // hop
    out = np.zeros((n_frames, win_length))
    for t in range(n_frames):
        x = padded[t * hop: t * hop + win_length] * w
        full = np.correlate(x, x, mode="full")
        acf = full[win_length - 1: win_length - 1 + win_length]
        out[t] = acf / max(acf[0], 1e-10)
    return out
