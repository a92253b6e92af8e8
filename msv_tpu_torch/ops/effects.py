"""Time-scale and pitch modification and silence trimming, ported from
``msv_tpu/ops/effects.py``: the phase vocoder, ``split`` and ``trim``.

``time_stretch`` runs framing, the windowed-DFT GEMM pair, magnitude
interpolation, phase accumulation, the inverse-rDFT GEMM and the
overlap-add on the device with no per-frame host loop.  The GEMMs follow
the session's precision mode (msv_tpu's ``effects.py:42``): they run in
``precision_for("parity")``, and "fast" rounds the forward GEMM's operands
to bf16 first, as ``features._rounder`` does; the inverse is true f32 in
both, as msv_tpu's HIGHEST inverse.  Magnitude and angle reads at
``floor(t)``/``floor(t)+1`` are row gathers.  The phase recursion is one
f32 ``cumsum`` over the steps (its order differs from XLA's), and only of
the bounded deviation: the linear part ``i * phi``, exactly periodic mod
2pi with period ``P = n_fft / gcd(hop, n_fft)``, comes from msv_tpu's
host-f64 ``(P, n_freq)`` table.  Identity phase locking finds each bin's
nearest peak with ``torch.cummax`` and a ``torch.cummin`` of the flipped
rows.  The overlap-add is ``ops/reconstruct.py::overlap_add`` (``fold``, a
fixed-order sum), never ``index_add_``, so two runs give the same audio.
The spectrum is complex only as (re, im) pairs of real tensors, as in
msv_tpu.

msv_tpu bucketed frames and steps to 256 and frame RMS to 128 (its compile
cache, masked pad rows); the port runs the true counts, so nothing is
masked.  ``_phase_tables``, ``_stretch_plan`` (called with a bucket of
1), ``split`` and ``trim`` (each with a ``device``) are copies of
msv_tpu's host code, pinned by tests/test_torch_host.py.
"""

import math
from fractions import Fraction

import numpy as np
import torch

from ..config import get_precision_mode, precision_for
from ..utils import round_up_to
from ..utils.device import as_f32, target_device
from .dft import inverse_rdft, n_pad_split
from .reconstruct import _ola_norm, overlap_add
from .stft import _prepare, frame_device

_TWO_PI = 2.0 * math.pi


def _phase_tables(hop: int, n_fft: int):
    """Host f64 phase constants: (phi mod 2pi, the (P, n_freq) linear-
    phase table with rows ``(i * phi) mod 2pi``)."""
    n_freq = n_fft // 2 + 1
    k = np.arange(n_freq, dtype=np.float64)
    phi = _TWO_PI * hop * k / n_fft  # nominal per-step advance
    period = n_fft // math.gcd(hop, n_fft)
    i = np.arange(period, dtype=np.float64)[:, None]
    table = np.mod(i * phi[None, :], _TWO_PI).astype(np.float32)
    return np.mod(phi, _TWO_PI).astype(np.float32), table


def _nearest_peak(mag):
    """Per row of a (S, K) magnitude tensor: the index of the nearest
    local maximum (ties to the left; rows without peaks lock to self),
    from a forward ``cummax`` and a backward ``cummin``."""
    s, k = mag.shape
    neg = torch.full((s, 1), -float("inf"), dtype=mag.dtype,
                     device=mag.device)
    prev = torch.cat([neg, mag[:, :-1]], dim=1)
    nxt = torch.cat([mag[:, 1:], neg], dim=1)
    is_peak = (mag > prev) & (mag >= nxt)
    ks = torch.arange(k, device=mag.device)[None, :].expand(s, k)
    fwd = torch.cummax(torch.where(is_peak, ks, -1), dim=1).values
    bwd = torch.cummin(torch.where(is_peak, ks, 2 * k).flip(1),
                       dim=1).values.flip(1)
    dl = torch.where(fwd >= 0, ks - fwd, k + 1)
    dr = torch.where(bwd < k, bwd - ks, k + 1)
    p = torch.where(dl <= dr, fwd, bwd)
    p = torch.where((fwd >= 0) | (bwd < k), p, ks)
    return torch.clamp(p, 0, k - 1)


def _vocode(re, im, sel, frac, lin, phi, phase_lock):
    """Phase-vocode an (F, n_freq) re/im spectrogram to (S, n_freq).

    ``sel``/``frac`` are the host-built floor/fraction of the fractional
    frame positions and ``lin`` the per-step linear phase (mod 2pi).  With
    ``phase_lock`` (identity phase locking, Laroche & Dolson 1999) only
    spectral peaks carry accumulated phase; every other bin takes its
    nearest peak's accumulated phase plus the ORIGINAL peak-relative phase
    of the analysis frame, which keeps each component's main lobe
    vertically coherent."""
    n_true = re.shape[0]
    mag = torch.sqrt(re * re + im * im)
    ang = torch.atan2(im, re)

    sel1 = torch.clamp(sel + 1, max=n_true - 1)
    # column t+1 reads as zero past the true frames (the zero-pad column
    # of the textbook formulation)
    m1 = ((sel + 1) < n_true)[:, None].to(re.dtype)
    m0 = mag[sel]
    a0 = ang[sel]
    m1v = mag[sel1] * m1
    a1 = ang[sel1] * m1

    frac = frac[:, None]
    mag_o = (1.0 - frac) * m0 + frac * m1v

    d = a1 - a0 - phi[None, :]
    d = d - _TWO_PI * torch.round(d / _TWO_PI)  # wrap to [-pi, pi]
    dev = torch.cumsum(d, dim=0)
    dev = torch.cat([torch.zeros_like(dev[:1]), dev[:-1]], dim=0)
    phase = ang[0][None, :] + lin + dev
    if phase_lock:
        p = _nearest_peak(mag_o)
        phase = (torch.gather(phase, 1, p) + a0 - torch.gather(a0, 1, p))
    return mag_o * torch.cos(phase), mag_o * torch.sin(phase)


def _pv_spec(padded, c, s, sel, frac, lin, phi, *, win, hop, n_frames,
             mode, phase_lock):
    """Analysis GEMM pair of precision ``mode``, then the vocoder."""
    from ..features import _rounder

    rnd = _rounder(mode)
    fr = rnd(frame_device(padded, win, hop, n_frames))
    with precision_for("parity"):
        re = fr @ rnd(c)
        im = fr @ rnd(s)
    return _vocode(re, im, sel, frac, lin, phi, phase_lock)


def _stretch_plan(n_frames: int, rate: float, bucket: int):
    """Host step grid: (sel int32, frac f32, s_true), bucketed."""
    steps = np.arange(0, n_frames, rate, dtype=np.float64)
    s_true = len(steps)
    sel = np.floor(steps).astype(np.int32)
    frac = (steps - sel).astype(np.float32)
    s_pad = round_up_to(max(s_true, 1), bucket)
    sel = np.pad(sel, (0, s_pad - s_true))
    frac = np.pad(frac, (0, s_pad - s_true))
    return sel, frac, s_true


def _time_stretch_device(wav, rate, *, win_length, hop_length, n_fft,
                         window, precision, phase_lock, device):
    """:func:`time_stretch` up to the output slice: a tensor on the
    device."""
    if n_fft is None:
        n_fft = win_length
    dev = target_device(wav, device)
    host = (wav.detach().cpu().numpy() if isinstance(wav, torch.Tensor)
            else wav)
    out_len = int(round(len(host) / rate))
    padded, c, s, n_frames, _ = _prepare(
        host, win_length, hop_length, n_fft, window, None, dev)
    sel, frac, s_true = _stretch_plan(n_frames, float(rate), 1)
    phi, table = _phase_tables(hop_length, n_fft)
    lin = table[np.arange(s_true) % table.shape[0]]

    if window is None:
        from .windows import default_stft_window

        window = default_stft_window(win_length, n_fft)
    syn = np.ascontiguousarray(window, dtype=np.float32)
    wsq = _ola_norm(s_true, win_length, hop_length, syn)
    mode = precision or get_precision_mode()
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for a in (sel.astype(np.int64), frac, lin, phi, syn, wsq)]
    sel_t, frac_t, lin_t, phi_t, syn_t, wsq_t = t
    out_re, out_im = _pv_spec(
        padded, c, s, sel_t, frac_t, lin_t, phi_t, win=win_length,
        hop=hop_length, n_frames=n_frames, mode=mode,
        phase_lock=bool(phase_lock))
    pl, _ = n_pad_split(n_fft, win_length)
    with precision_for("parity"):
        frames_o = inverse_rdft((out_re, out_im), n_fft)[:, pl:pl + win_length]
    sig = overlap_add(frames_o, syn_t, hop_length, wsq_t)
    half = win_length // 2
    out = sig[half:half + out_len]
    if out.shape[0] < out_len:  # OLA ran a few samples short of round(T/rate)
        out = torch.nn.functional.pad(out, (0, out_len - out.shape[0]))
    return out


def time_stretch(
    wav,
    rate: float,
    *,
    win_length: int = 1024,
    hop_length: int = 256,
    n_fft: int | None = None,
    window=None,
    precision: str | None = None,
    phase_lock: bool = True,
    device=None,
):
    """Stretch a (T,) signal in time by ``1/rate`` without changing pitch:
    host float32 of ``round(T / rate)`` samples.

    ``rate > 1`` speeds up (shorter output), ``rate < 1`` slows down.
    Phase vocoder: magnitudes linearly interpolated at fractional frame
    positions ``i * rate``, phases advanced by the nominal hop phase plus
    the wrapped instantaneous deviation measured between the straddling
    frame pair, with identity phase locking by default (``phase_lock=
    False`` gives the textbook per-bin accumulator).  ``rate == 1``
    short-circuits to the identity.  ``wav``: numpy (computed on the card
    unless ``device`` says otherwise) or a tensor (on its own device).

    Defaults (win 1024, hop 256, n_fft = win) are effect-quality analysis
    parameters independent of the viewer's session settings.
    """
    if not rate > 0:
        raise ValueError(f"rate must be positive, got {rate}")
    if np.ndim(wav) != 1:
        raise ValueError(f"wav must be 1-D, got shape {np.shape(wav)}")
    if not isinstance(wav, torch.Tensor):
        wav = np.ascontiguousarray(wav, dtype=np.float32)
    if rate == 1.0:
        return (wav.detach().cpu().numpy().astype(np.float32)
                if isinstance(wav, torch.Tensor) else wav.copy())
    return _time_stretch_device(
        wav, rate, win_length=win_length, hop_length=hop_length,
        n_fft=n_fft, window=window, precision=precision,
        phase_lock=phase_lock, device=device).cpu().numpy()


def pitch_shift(
    wav,
    sr: int,
    n_steps: float,
    *,
    bins_per_octave: int = 12,
    win_length: int = 1024,
    hop_length: int = 256,
    n_fft: int | None = None,
    precision: str | None = None,
    phase_lock: bool = True,
    device=None,
):
    """Shift pitch by ``n_steps`` semitones (``bins_per_octave`` per
    octave) at constant duration: host float32 of the input's length.

    Phase-vocoder stretch by ``2**(-n_steps/bins_per_octave)`` (an upshift
    first SLOWS the signal down), then the stretched signal, still on the
    device, resampled back to the original length
    (:func:`msv_tpu_torch.ops.resample.resample_poly`), which scales every
    frequency by ``2**(n_steps/bins_per_octave)``.  The irrational semitone
    ratio is approximated by ``Fraction.limit_denominator(1000)`` (<= 0.02
    cent error)."""
    if bins_per_octave < 1:
        raise ValueError(
            f"bins_per_octave must be >= 1, got {bins_per_octave}"
        )
    if not isinstance(wav, torch.Tensor):
        wav = np.ascontiguousarray(wav, dtype=np.float32)
    n = np.shape(wav)[-1]
    if n_steps == 0:
        return (wav.detach().cpu().numpy().astype(np.float32)
                if isinstance(wav, torch.Tensor) else wav.copy())
    if np.ndim(wav) != 1:
        raise ValueError(f"wav must be 1-D, got shape {np.shape(wav)}")
    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    y = _time_stretch_device(
        wav, rate, win_length=win_length, hop_length=hop_length,
        n_fft=n_fft, window=None, precision=precision,
        phase_lock=phase_lock, device=device)
    frac = Fraction(rate).limit_denominator(1000)
    from .resample import resample_poly

    out = resample_poly(y, frac.numerator, frac.denominator)
    if out.shape[0] < n:
        out = torch.nn.functional.pad(out, (0, n - out.shape[0]))
    return out[:n].cpu().numpy()


# ------------------------------------------------------------- trim/split

def _frame_rms(wav, frame_length: int, hop_length: int, device=None):
    """Centered per-frame RMS of a (T,) signal -> (n_frames,) f32 host
    array, on ``device``.  Framing conventions match the feature frontend
    (centered, reflect-padded)."""
    from .framing import n_frames_for

    x = as_f32(wav, device)
    half = frame_length // 2
    n_frames = n_frames_for(x.shape[0], frame_length, hop_length)
    if x.shape[0] < half + 1:
        raise ValueError(
            f"signal too short for win_length={frame_length}: "
            f"need at least {half + 1} samples, got {x.shape[0]}")
    padded = torch.nn.functional.pad(x[None], (half, half),
                                     mode="reflect")[0]
    frames = frame_device(padded, frame_length, hop_length, n_frames)
    return torch.sqrt(torch.mean(frames * frames, dim=1)).cpu().numpy()


def split(wav, sr: int | None = None, *, top_db: float = 60.0,
          frame_length: int = 2048, hop_length: int = 512, device=None):
    """Non-silent intervals: (T,) -> (N, 2) int64 sample [start, end)
    pairs.

    A frame is silent when its RMS sits more than ``top_db`` below the
    loudest frame's (librosa.effects.split semantics; librosa is not
    in this image — pinned against a from-scratch oracle and
    constructed signals in tests/test_effects.py).  Frame RMS runs on
    device (one framing + reduce); the run-length extraction is host
    numpy on the tiny boolean vector.  ``sr`` is accepted for call-site
    symmetry but unused (thresholds are relative).  An all-silent
    (all-zero) signal returns an empty (0, 2) array.
    """
    del sr
    wav = np.ascontiguousarray(wav, dtype=np.float32)
    if wav.ndim != 1:
        raise ValueError(f"wav must be 1-D, got {wav.shape}")
    if len(wav) == 0:
        return np.empty((0, 2), np.int64)
    if top_db <= 0:
        raise ValueError(f"top_db must be > 0, got {top_db}")
    if not (0 < hop_length <= frame_length):
        raise ValueError(
            f"need 0 < hop_length <= frame_length, got {hop_length}, "
            f"{frame_length}")
    if len(wav) < frame_length:  # short clip: shrink the analysis frame
        frame_length = max(2, len(wav))
        hop_length = min(hop_length, frame_length)
    rms = _frame_rms(wav, frame_length, hop_length, device)
    ref = float(rms.max())
    if ref <= 0.0:
        return np.empty((0, 2), np.int64)
    # strict > floor, matching the dB convention used everywhere else
    loud = 20.0 * np.log10(np.maximum(rms, 1e-20) / ref) > -top_db
    edges = np.diff(loud.astype(np.int8))
    starts = np.flatnonzero(edges == 1) + 1
    ends = np.flatnonzero(edges == -1) + 1
    if loud[0]:
        starts = np.concatenate([[0], starts])
    if loud[-1]:
        ends = np.concatenate([ends, [len(loud)]])
    n = len(wav)
    out = np.stack([starts, ends], axis=1) * hop_length
    return np.minimum(out, n).astype(np.int64)


def trim(wav, sr: int | None = None, *, top_db: float = 60.0,
         frame_length: int = 2048, hop_length: int = 512, device=None):
    """Strip leading/trailing silence: (T,) -> (trimmed, (start, end))
    with ``trimmed = wav[start:end]`` (librosa.effects.trim semantics).
    An all-silent signal returns an empty slice at (0, 0)."""
    iv = split(wav, sr, top_db=top_db, frame_length=frame_length,
               hop_length=hop_length, device=device)
    wav = np.ascontiguousarray(wav, dtype=np.float32)
    if len(iv) == 0:
        return wav[:0], (0, 0)
    a, b = int(iv[0, 0]), int(iv[-1, 1])
    return wav[a:b], (a, b)
