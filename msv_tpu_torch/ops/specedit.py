"""Spectral editing — time-frequency box gain / erase / patch repair,
ported from ``msv_tpu/ops/specedit.py``.

Framing -> windowed-rDFT GEMM pair -> per-cell gain and patch ->
inverse-rDFT GEMM -> overlap-add, as torch ops on the device (the STFT
round trip of ``ops/hpss.py``: true f32 GEMMs, a ``fold`` overlap-add,
msv_tpu's 128-frame bucket).  The box geometry is host numpy: ``Box``,
``_feather`` and ``_build_masks`` are copies of msv_tpu's, pinned by
tests/test_torch_host.py; the device takes the gain mask and the patch
weights as operands.  A patch replaces each cell by the magnitude
interpolated between the clean frames either side (two row gathers) with
phase propagated from the left boundary at each bin's measured frequency,
``ph_l + steps * (nom + dev)``; ``torch.round`` rounds half to even as
``jnp.round`` does.

The bucket changes no output value here (the pad rows are zeroed before
the gain and the patch, and their overlap-add is zero); it stays so that
the round trip is msv_tpu's, the timeline's tail included.
"""

import math

import numpy as np
import torch

from ..config import precision_for
from ..utils.device import host_f32, target_device
from .hpss import _masked_istft, _roundtrip, _spectrum

__all__ = ["spectral_edit", "Box"]


class Box:
    """One edit region: seconds x Hz, either a gain or a patch.

    ``gain_db`` < 0 ducks (e.g. -18), very negative erases (-80);
    ``mode="patch"`` ignores gain_db and linearly interpolates each
    bin's magnitude across the time span from the clean frame on each
    side (phase kept).
    """

    __slots__ = ("t0", "t1", "f0", "f1", "gain_db", "mode")

    def __init__(self, t0, t1, f0, f1, gain_db=-80.0, mode="gain"):
        self.t0, self.t1 = float(t0), float(t1)
        self.f0, self.f1 = float(f0), float(f1)
        self.gain_db = float(gain_db)
        self.mode = str(mode)
        if not (0.0 <= self.t0 < self.t1):
            raise ValueError(f"bad time span [{t0}, {t1})")
        if not (0.0 <= self.f0 < self.f1):
            raise ValueError(f"bad frequency band [{f0}, {f1})")
        if self.mode not in ("gain", "patch"):
            raise ValueError(f"mode must be 'gain' or 'patch': {mode}")


def _feather(length: int, ramp: int, lo: bool = True, hi: bool = True):
    """1.0 plateau with raised-cosine ramps of ``ramp`` cells inward.

    ``lo``/``hi`` disable the ramp on an edge that sits on a physical
    boundary (DC/Nyquist, signal start/end) — there is nothing beyond
    it to blend with, and feathering there LEAKS the region being
    edited (measured: a DC-side ramp passed enough of a click's
    low-frequency energy to halve the patch's repair)."""
    w = np.ones(length, np.float32)
    r = min(ramp, length // 2)
    if r > 0:
        edge = 0.5 - 0.5 * np.cos(
            np.pi * (np.arange(1, r + 1, dtype=np.float64)) / (r + 1))
        if lo:
            w[:r] = edge
        if hi:
            w[length - r:] = edge[::-1]
    return w


def _build_masks(boxes, sr, n_frames, n_freq, hop, n_fft,
                 feather_t, feather_f):
    """Host geometry: the (n_frames, n_freq) linear gain mask for gain
    boxes, plus the patch weight/indices (see module doc)."""
    gain = np.ones((n_frames, n_freq), np.float32)
    patch_w = np.zeros((n_frames, n_freq), np.float32)
    left = np.arange(n_frames, dtype=np.int32)
    right = np.arange(n_frames, dtype=np.int32)
    alpha = np.zeros(n_frames, np.float32)
    steps = np.zeros(n_frames, np.float32)  # frames since left boundary
    hz_per_bin = sr / n_fft
    spans = []
    for b in boxes:
        fa = max(int(math.floor(b.t0 * sr / hop)), 0)
        fb = min(int(math.ceil(b.t1 * sr / hop)) + 1, n_frames)
        ka = max(int(math.floor(b.f0 / hz_per_bin)), 0)
        kb = min(int(math.ceil(b.f1 / hz_per_bin)) + 1, n_freq)
        if fb - fa < 1 or kb - ka < 1:
            continue  # fully outside the signal/band
        ft = _feather(fb - fa, feather_t, lo=fa > 0, hi=fb < n_frames)
        ff = _feather(kb - ka, feather_f, lo=ka > 0, hi=kb < n_freq)
        w = ft[:, None] * ff[None, :]
        if b.mode == "gain":
            g = np.float32(10.0 ** (b.gain_db / 20.0))
            # compose: each box pulls its cells toward its gain by its
            # feather weight; overlapping boxes multiply
            gain[fa:fb, ka:kb] *= (1.0 - w) + w * g
        else:
            if fa < 2 or fb >= n_frames:
                raise ValueError(
                    "patch box needs two clean frames on the left and "
                    "one on the right (the phase-velocity estimate) — "
                    f"got frames [{fa}, {fb}) of {n_frames}")
            for a0, b0 in spans:
                if fa < b0 and a0 < fb:
                    raise ValueError(
                        "patch boxes must not overlap in time")
            spans.append((fa, fb))
            patch_w[fa:fb, ka:kb] = np.maximum(
                patch_w[fa:fb, ka:kb], w)
            t = np.arange(fa, fb, dtype=np.float64)
            left[fa:fb] = fa - 1
            right[fa:fb] = fb
            alpha[fa:fb] = ((t - (fa - 1)) / (fb - (fa - 1))).astype(
                np.float32)
            steps[fa:fb] = (t - (fa - 1)).astype(np.float32)
    return gain, patch_w, left, right, alpha, steps


def _specedit_core(re, im, gain, patch_w, left, right, alpha, steps, *,
                   hop, n_fft):
    """The edited spectrum (re, im): gain boxes scale each cell, patch
    boxes replace it (see the module docstring)."""
    mag = torch.sqrt(re * re + im * im)
    a = alpha[:, None]
    target = (1.0 - a) * mag[left] + a * mag[right]
    re_l, im_l = re[left], im[left]
    l2 = torch.clamp(left - 1, min=0)
    nom = float(np.float32(2.0 * math.pi) * np.float32(hop)
                / np.float32(n_fft)) * torch.arange(
        re.shape[1], dtype=torch.float32, device=re.device)[None, :]
    ph_l = torch.atan2(im_l, re_l)
    dev = ph_l - torch.atan2(im[l2], re[l2]) - nom
    two_pi = float(np.float32(2.0 * np.pi))
    dev = dev - two_pi * torch.round(dev / two_pi)  # principal value
    ph = ph_l + steps[:, None] * (nom + dev)
    re_o = (1.0 - patch_w) * (re * gain) + patch_w * target * torch.cos(ph)
    im_o = (1.0 - patch_w) * (im * gain) + patch_w * target * torch.sin(ph)
    return re_o, im_o


def spectral_edit(
    wav,
    sr: int,
    boxes,
    *,
    win_length: int = 1024,
    hop_length: int = 256,
    n_fft: int | None = None,
    feather_ms: float = 20.0,
    feather_hz: float = 60.0,
    window=None,
    device=None,
):
    """Apply time-frequency box edits to ``wav`` -> same-length host
    float32, computed on ``device`` (numpy input goes to the card unless
    ``device`` says otherwise; a tensor's own device).

    ``boxes``: iterable of :class:`Box` (or dicts with the same keys).
    STFT conventions match :func:`~msv_tpu_torch.ops.stft.perform_stft`
    (centered, reflect padding; the window scale cancels in the
    roundtrip).  Feathering defaults soften edges over ~20 ms / ~60 Hz.
    """
    dev = target_device(wav, device)
    wav = host_f32(wav)
    if wav.ndim != 1:
        raise ValueError(f"wav must be 1-D, got {wav.shape}")
    if n_fft is None:
        n_fft = win_length
    if n_fft < win_length:
        raise ValueError(f"n_fft {n_fft} < win_length {win_length}")
    half = win_length // 2
    if len(wav) < half + 1:
        raise ValueError(
            f"signal too short for win_length={win_length}")
    bs = []
    for b in boxes:
        if isinstance(b, dict):
            b = Box(b["t0"], b["t1"], b["f0"], b["f1"],
                    b.get("gain_db", -80.0), b.get("mode", "gain"))
        if not isinstance(b, Box):
            raise TypeError(f"box must be Box or dict, got {type(b)}")
        if b.f0 >= sr / 2:
            raise ValueError(f"box band starts above Nyquist: {b.f0}")
        bs.append(b)
    if not bs:
        raise ValueError("no boxes given")

    padded, c, s, syn, wsq, n_frames, n_pad = _roundtrip(
        wav, win_length, hop_length, n_fft, window, dev)
    n_freq = n_fft // 2 + 1
    gain, patch_w, left, right, alpha, steps = _build_masks(
        bs, sr, n_frames, n_freq, hop_length, n_fft,
        feather_t=max(int(round(feather_ms / 1000.0 * sr / hop_length)),
                      1),
        feather_f=max(int(round(feather_hz * n_fft / sr)), 1),
    )
    # bucket-pad the mask rows as identity; index vectors to self
    gain = np.pad(gain, ((0, n_pad - n_frames), (0, 0)),
                  constant_values=1.0)
    patch_w = np.pad(patch_w, ((0, n_pad - n_frames), (0, 0)))
    pad_ix = np.arange(n_frames, n_pad, dtype=np.int32)
    left = np.concatenate([left, pad_ix])
    right = np.concatenate([right, pad_ix])
    alpha = np.pad(alpha, (0, n_pad - n_frames))
    steps = np.pad(steps, (0, n_pad - n_frames))

    gain, patch_w, alpha, steps = (torch.from_numpy(a).to(dev) for a in (
        gain, patch_w, alpha, steps))
    left, right = (torch.from_numpy(a.astype(np.int64)).to(dev)
                   for a in (left, right))
    geo = {"win": win_length, "hop": hop_length}
    with precision_for("parity"):
        re, im = _spectrum(padded, c, s, n_frames=n_frames, n_pad=n_pad,
                           **geo)
        re, im = _specedit_core(re, im, gain, patch_w, left, right, alpha,
                                steps, hop=hop_length, n_fft=n_fft)
        out = _masked_istft(re, im, 1.0, syn, wsq, n_fft=n_fft, **geo)
    return out[half:half + len(wav)].cpu().numpy()
