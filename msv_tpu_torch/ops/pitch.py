"""Fundamental-frequency (pitch) tracking, ported from
``msv_tpu/ops/pitch.py``: YIN (de Cheveigne & Kawahara 2002).

The per-frame difference function d(tau) = sum_j (x_j - x_{j+tau})^2
expands to e(0) + e(tau) - 2 r(tau): the running energies e are one
cumsum, and the correlation r of every frame with its own windowed prefix
is three GEMMs on the device (an end-padded real-DFT pair, the cross-power,
one inverse rDFT), in true f32 (``precision_for("parity")``, as msv_tpu's
HIGHEST).  Trough selection is loop-free: a local-minimum mask, ``argmax``
of the below-threshold mask (cast to uint8: ``torch.argmax`` takes no
bool, and returns the first maximum), a lowest-trough fallback, and
parabolic interpolation off a three-point ``gather``.

msv_tpu padded the frame count to 128 to bound its compile cache; the port
computes the exact frame count (a frame reads only its own samples, so the
true frames are the same).
"""

import math

import numpy as np
import torch

from ..config import precision_for
from ..utils import next_pow2
from ..utils.device import as_f32
from .dft import end_padded_rdft_matrices, inverse_rdft
from .stft import frame_device


def _yin_core(padded, cx, sx, cw, sw, *, frame_length, win_length, hop,
              n_frames, n_fft, pmin, pmax, threshold):
    frames = frame_device(padded, frame_length, hop, n_frames)
    with precision_for("parity"):
        # r(tau), tau = 0..pmax: circular cross-correlation of each frame
        # with its own windowed prefix; n_fft >= pmax + win_length keeps
        # the negative-lag tail clear of [0, pmax]
        a = frames @ cx
        b = frames @ sx
        w = frames[:, :win_length]
        c = w @ cw
        d_ = w @ sw
        re = a * c + b * d_          # X * conj(W)
        im = b * c - a * d_
        r = inverse_rdft((re, im), n_fft)[:, : pmax + 1]

    # e(tau) = sum x[tau : tau+W]^2 via one cumsum
    cs = torch.nn.functional.pad(torch.cumsum(frames * frames, dim=1),
                                 (1, 0))
    e = cs[:, win_length: win_length + pmax + 1] - cs[:, : pmax + 1]
    d = torch.clamp(e[:, :1] + e - 2.0 * r, min=0.0)  # difference fn, >= 0

    # cumulative mean normalized difference; d'(0) = 1 by definition
    tau = torch.arange(pmax + 1, dtype=torch.float32, device=d.device)
    cum = torch.cumsum(d, dim=1)
    cmnd = torch.where(tau[None, :] > 0,
                       d * tau[None, :] / torch.clamp(cum, min=1e-12),
                       torch.ones_like(d))

    # troughs within [pmin, pmax-1] (parabolic neighbours must exist)
    prev, mid, nxt = cmnd[:, :-2], cmnd[:, 1:-1], cmnd[:, 2:]
    is_trough = (mid < prev) & (mid <= nxt)
    t_idx = torch.arange(1, pmax, device=d.device)
    in_range = (t_idx >= pmin)[None, :]
    trough = is_trough & in_range
    below = trough & (mid < np.float32(threshold))
    has_below = below.any(dim=1)
    first_below = torch.argmax(below.to(torch.uint8), dim=1)
    # fallback: the lowest in-range trough; with no trough at all
    # (monotone cmnd) the masked argmin lands on the in-range minimum
    inf = float("inf")
    masked = torch.where(trough, mid, inf)
    any_trough = torch.isfinite(masked).any(dim=1)
    global_min = torch.argmin(masked, dim=1)
    plain_min = torch.argmin(torch.where(in_range, mid, inf), dim=1)
    fallback = torch.where(any_trough, global_min, plain_min)
    best = torch.where(has_below, first_below, fallback) + 1  # cmnd index

    def take(off):
        return torch.gather(cmnd, 1, (best + off)[:, None])[:, 0]

    va, vb, vc = take(-1), take(0), take(1)
    # parabolic vertex of (va, vb, vc) around integer lag `best`
    denom = va - 2.0 * vb + vc
    shift = torch.where(torch.abs(denom) > 1e-12,
                        torch.clamp(0.5 * (va - vc) / denom, -0.5, 0.5),
                        torch.zeros_like(denom))
    period = best.to(torch.float32) + shift
    ap = torch.clamp(vb + 0.25 * (va - vc) * shift, min=0.0)
    # digital silence: d(tau) == 0 at every lag makes the CMND 0/0, which
    # the 1e-12 clamp resolves to 0 ("perfectly periodic"): report fully
    # aperiodic instead so voicing gates drop the frame
    ap = torch.where(cum[:, -1] > 0.0, ap, torch.ones_like(ap))
    return period, ap


def yin(
    wav,
    sr: int,
    *,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    frame_length: int = 2048,
    win_length: int | None = None,
    hop_length: int | None = None,
    trough_threshold: float = 0.1,
    with_aperiodicity: bool = False,
    device=None,
):
    """Per-frame f0 in Hz: (T,) -> (n_frames,) float32 tensor.

    Centered frames (``frame_length``, hop default ``frame_length//4``)
    with zero padding; the difference-function window defaults to
    ``frame_length//2``.  Search band [``fmin``, ``fmax``] Hz.  Frames with
    no trough below ``trough_threshold`` fall back to the lowest trough
    (the librosa convention): gate on the aperiodicity to drop unvoiced
    frames: ``with_aperiodicity=True`` returns ``(f0, ap)`` where ``ap`` is
    the CMND trough depth (~0 pure periodicity, ~1 noise).  ``wav``: numpy
    (to the card unless ``device`` says otherwise) or a tensor (on its own
    device).
    """
    if np.ndim(wav) != 1:
        raise ValueError(f"wav must be 1-D, got {tuple(np.shape(wav))}")
    if win_length is None:
        win_length = frame_length // 2
    if hop_length is None:
        hop_length = frame_length // 4
    if not (0 < win_length < frame_length):
        raise ValueError(
            f"win_length must be in (0, frame_length), got {win_length}"
        )
    if hop_length < 1:
        raise ValueError(f"hop_length must be >= 1, got {hop_length}")
    if not (0.0 < fmin < fmax):
        raise ValueError(f"need 0 < fmin < fmax, got {fmin}, {fmax}")
    if fmax > sr / 2:
        raise ValueError(f"fmax {fmax} above Nyquist ({sr / 2})")
    pmin = max(int(math.floor(sr / fmax)), 1)
    pmax = min(int(math.ceil(sr / fmin)), frame_length - win_length - 1)
    if pmax <= pmin + 1:
        raise ValueError(
            f"period range [{pmin}, {pmax}] too narrow: raise "
            "frame_length or widen [fmin, fmax]"
        )
    half = frame_length // 2
    n = np.shape(wav)[0]
    if n < 1:
        raise ValueError("empty signal")
    wav = as_f32(wav, device)
    n_frames = 1 + (n + 2 * half - frame_length) // hop_length
    need = (n_frames - 1) * hop_length + frame_length
    padded = wav.new_zeros(max(need, half + n))
    padded[half: half + n] = wav

    n_fft = next_pow2(frame_length)
    assert n_fft >= pmax + win_length  # circular-correlation safety
    mats = [torch.from_numpy(m).to(wav.device) for m in (
        *end_padded_rdft_matrices(frame_length, n_fft),
        *end_padded_rdft_matrices(win_length, n_fft))]
    period, ap = _yin_core(
        padded, *mats, frame_length=frame_length, win_length=win_length,
        hop=hop_length, n_frames=n_frames, n_fft=n_fft, pmin=pmin,
        pmax=pmax, threshold=float(trough_threshold),
    )
    f0 = torch.full_like(period, float(sr)) / period
    if with_aperiodicity:
        return f0, ap
    return f0
