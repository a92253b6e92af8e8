"""Adaptive multi-resolution mel spectrogram, ported from
``msv_tpu/ops/multires.py`` as torch ops on an explicit ``device``.

The reference's roadmap asks for an "adaptive STFT — sth like iZotope RX
Editor" (ReadMe.md:18).  The signal is analyzed at several window scales
sharing one hop grid, projected onto a COMMON mel basis, and blended per
time-frequency cell by local sharpness: transients take their detail from
the short windows, stationary harmonics from the long ones.

Design notes (msv_tpu's):
  * all scales share hop_length, and windows are forced even, so every
    scale yields the SAME frame count (n = floor(L/hop) + 1 for centered
    framing with even win): the blend is elementwise;
  * a shared n_mel across scales (calc_mel_fb at each n_fft with the same
    band count) gives aligned frequency axes;
  * sharpness = |discrete Laplacian| of the dB image, box-smoothed; blend
    weights w_k proportional to sharpness_k^alpha (alpha=2), normalized:
    a convex combination, so every cell stays within [min_k, max_k] of
    the per-scale values.

What the port adds: each scale's three products are f32 ``torch.matmul``
with TF32 off (``precision_for("parity")``; msv_tpu computes them at
HIGHEST outside any kernel), run over fixed ``GEMM_BLOCK``-frame blocks so
that a frame meets one cuBLAS kernel whatever the call's frame count; the
K-way sums of the blend are explicit adds.  So the range form equals the
slice of the whole-track form bit for bit on the card as on the CPU.  The
numpy helpers are verbatim copies of msv_tpu's.
"""

import functools

import numpy as np
import torch

from ..config import SpecSetting, derive_stft_params, precision_for
from ..utils import next_pow2, round_up_to
from .decibel import amp_to_db
from .dft import windowed_dft_matrices
from .framing import n_frames_for, reflect_pad_center
from .mel import calc_mel_fb
from .stft import frame_device
from .windows import hann

# Frames per GEMM of _scale_spec (every product is one shape).
GEMM_BLOCK = 1024


def _scale_params(sr: int, setting: SpecSetting, scales):
    base = derive_stft_params(sr, setting)
    hop = base.hop_length
    out = []
    for s in scales:
        win = max((base.win_length // int(s)) // 2 * 2, 4)  # even, >= 4
        n_fft = next_pow2(win) * setting.f_overlap
        out.append((win, n_fft))
    return hop, out


def adaptive_auto_n_mel(sr: int, setting: SpecSetting | None = None,
                        scales=(1, 2, 4)) -> int:
    """Largest band count with no empty mel row at the SMALLEST analysis
    scale.  All scales share one mel basis, so the binding constraint is
    the smallest n_fft — a fixed n_mel (the old 128 default) leaves
    sub-bin-width triangles empty at low frequencies and renders as black
    banding.  Applies the reference's auto rule (mel.rs:87-99) to that
    n_fft."""
    from .mel import _mel_fb_default_cached

    setting = setting or SpecSetting()
    _, wins = _scale_params(sr, setting, scales)
    n_fft_min = min(nf for _, nf in wins)
    return int(_mel_fb_default_cached(int(sr), int(n_fft_min)).shape[1])


def multires_mel_spec_db(
    wav: np.ndarray,
    sr: int,
    setting: SpecSetting | None = None,
    scales=(1, 2, 4),
    n_mel: int | None = None,
    alpha: float = 2.0,
    device="cuda",
):
    """Adaptive multi-resolution mel dB spectrogram on ``device``.

    Returns (db (n_frames, n_mel) tensor, n_frames).

    Deliberately NOT implemented via :func:`multires_mel_spec_db_range`:
    this whole-track form is the straightforward oracle the slice-local
    range form is tested against, so the two stay independent.  Unlike
    msv_tpu's, it always computes two rows past the last frame from the
    zero-extended stream (msv_tpu edge-pads there when n_frames lies within
    two of a multiple of 256, where its own range form does not).
    """
    setting = setting or SpecSetting()
    if n_mel is None:
        n_mel = adaptive_auto_n_mel(sr, setting, scales)
    wav = np.ascontiguousarray(wav, dtype=np.float32)
    hop, wins = _scale_params(sr, setting, scales)

    # per-scale pipelines share the frame grid: centered framing with even
    # windows yields identical n_frames for every scale
    n_frames = n_frames_for(len(wav), wins[0][0], hop)
    n_pad = round_up_to(max(n_frames, 1) + 2, 256)

    specs = []
    for win, n_fft in wins:
        window = (hann(win, False) / np.float32(n_fft)).astype(np.float32)
        c, s = windowed_dft_matrices(window, n_fft)
        fb = calc_mel_fb(sr, n_fft, n_mel, 0.0, None, True, np.float32)
        padded = reflect_pad_center(wav, win)
        need = (n_pad - 1) * hop + win
        if len(padded) < need:
            padded = np.pad(padded, (0, need - len(padded)))
        nf = n_frames_for(len(wav), win, hop)
        if nf != n_frames:
            raise AssertionError((win, hop, nf, n_frames))
        specs.append(_scale_spec(
            torch.from_numpy(padded).to(device),
            *(torch.from_numpy(m).to(device) for m in (c, s, fb)),
            win=win, hop=hop, n_frames=n_pad,
        ))
    db = _blend(specs, alpha=float(alpha))
    return db[:n_frames], n_frames


def _scale_spec(padded, c, s, fb, *, win, hop, n_frames):
    """(n_frames, n_mel) dB of one scale: frames -> DFT GEMM pair ->
    magnitude -> mel GEMM -> amp_to_db, GEMM_BLOCK frames per product."""
    nb = -(-n_frames // GEMM_BLOCK)
    need = (nb * GEMM_BLOCK - 1) * hop + win
    if padded.shape[0] < need:
        padded = torch.nn.functional.pad(padded, (0, need - padded.shape[0]))
    mel = padded.new_empty((nb * GEMM_BLOCK, fb.shape[1]))
    with precision_for("parity"):
        frames = frame_device(padded, win, hop, nb * GEMM_BLOCK)
        for i in range(nb):
            fr = frames[i * GEMM_BLOCK:(i + 1) * GEMM_BLOCK].contiguous()
            re = fr @ c
            im = fr @ s
            mag = torch.sqrt(re * re + im * im)
            torch.matmul(mag, fb, out=mel[i * GEMM_BLOCK:(i + 1) * GEMM_BLOCK])
    return amp_to_db(mel[:n_frames])


def _edge_pad(x):
    """(K, T, F) -> (K, T + 2, F + 2), edge values repeated."""
    x = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    return torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)


def _blend(specs, *, alpha):
    """K per-scale dB planes (T, F) -> sharpness-weighted convex blend
    (T, F)."""
    x = torch.stack(specs)
    t, f = x.shape[1:]
    xp = _edge_pad(x)
    # discrete Laplacian magnitude per cell
    lap = torch.abs(4.0 * x - xp[:, :-2, 1:-1] - xp[:, 2:, 1:-1]
                    - xp[:, 1:-1, :-2] - xp[:, 1:-1, 2:])
    # 3x3 box smoothing of the sharpness field
    lp = _edge_pad(lap)
    acc = torch.zeros_like(lap)
    for dy in range(3):
        for dx in range(3):
            acc = acc + lp[:, dy:dy + t, dx:dx + f]
    sharp = (acc / 9.0) ** alpha
    total = sharp[0]
    for k in range(1, len(specs)):
        total = total + sharp[k]
    norm = torch.clamp(total, min=1e-12)
    out = (sharp[0] / norm) * x[0]
    for k in range(1, len(specs)):
        out = out + (sharp[k] / norm) * x[k]
    return out


# ----------------------------------------------------------- viewport form

# box3(lap(x)) reads 2 frames each side; +2 slack so every returned frame
# sees exactly the neighborhood the full computation would
BLEND_MARGIN = 4


def adaptive_frame_count(n_samples: int, sr: int,
                         setting: SpecSetting | None = None,
                         scales=(1, 2, 4)) -> int:
    """Frame count of multires_mel_spec_db for a track (shared hop grid)."""
    setting = setting or SpecSetting()
    hop, wins = _scale_params(sr, setting, scales)
    return n_frames_for(n_samples, wins[0][0], hop)


def _range_needs(n: int, hop: int, win: int, e0: int, e1: int,
                 tail: bool = False):
    """Exact global sample intervals frames [e0, e1) read, split into the
    (reflect-left, mid, reflect-right) source ranges of the virtual
    reflect-padded signal (frame f = padded[f*hop : f*hop+win], padded =
    reflect_pad_center(wav, win)).  ``tail`` extends the right edge to the
    END of the padded signal (n + win//2): required when the range touches
    the last real frame, so the zero-extension beyond the segment lines up
    with the full computation's zero-extension and the pad-region frames
    the blend margin reads are identical."""
    h = win // 2
    j0 = e0 * hop - h
    j1 = (e1 - 1) * hop - h + win
    if tail:
        j1 = n + h  # j1 <= n + h always ((nf-1)*hop <= n, win even)
    needs = []
    if j0 < 0:
        needs.append((1, 1 - j0))  # left reflect sources wav[1 : 1-j0]
    needs.append((max(0, j0), max(0, min(n, j1))))
    if j1 > n:
        # right reflect sources wav[2n-2-j] for j in [n, j1)
        needs.append((max(0, 2 * n - 1 - j1), n - 1))
    return needs, j0, j1


def range_sample_window(n_samples: int, sr: int,
                        setting: SpecSetting | None = None,
                        f0: int = 0, f1: int = 1,
                        scales=(1, 2, 4)) -> tuple[int, int]:
    """Global sample interval [s0, s1) a caller must supply to
    :func:`multires_mel_spec_db_range` for output frames [f0, f1) —
    includes the blend margin and every scale's window/reflect sources."""
    setting = setting or SpecSetting()
    hop, wins = _scale_params(sr, setting, scales)
    nf = n_frames_for(n_samples, wins[0][0], hop)
    e0 = max(0, f0 - BLEND_MARGIN)
    e1 = min(nf, f1 + BLEND_MARGIN)
    s0, s1 = n_samples, 0
    for win, _ in wins:
        needs, _, _ = _range_needs(n_samples, hop, win, e0, e1,
                                   tail=(e1 == nf))
        for a, b in needs:
            if b > a:
                s0 = min(s0, a)
                s1 = max(s1, b)
    return max(0, s0), min(n_samples, s1)


def _padded_segment(wav_s: np.ndarray, s_start: int, n: int, hop: int,
                    win: int, e0: int, e1: int,
                    tail: bool = False) -> np.ndarray:
    """reflect_pad_center(wav, win)[e0*hop : (e1-1)*hop + win] materialized
    from the sample slice ``wav_s`` = wav[s_start : s_start + len]."""
    needs, j0, j1 = _range_needs(n, hop, win, e0, e1, tail=tail)
    parts = []
    if j0 < 0:
        seg = wav_s[1 - s_start: 1 - j0 - s_start]
        if len(seg) != -j0:
            raise ValueError("sample slice does not cover the left reflect")
        parts.append(seg[::-1])
        lo = 0
    else:
        lo = j0
    hi = min(n, j1)
    mid = wav_s[lo - s_start: hi - s_start]
    if len(mid) != hi - lo:
        raise ValueError("sample slice does not cover the frame range")
    parts.append(mid)
    if j1 > n:
        k = j1 - n  # overhang count: sources wav[n-2] .. wav[n-1-k]
        seg = wav_s[n - 1 - k - s_start: n - 1 - s_start]
        if len(seg) != k:
            raise ValueError("sample slice does not cover the right reflect")
        parts.append(seg[::-1])
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def multires_mel_spec_db_range(
    wav_s: np.ndarray,
    sr: int,
    f0: int,
    f1: int,
    *,
    setting: SpecSetting | None = None,
    slice_start: int = 0,
    n_samples: int | None = None,
    scales=(1, 2, 4),
    n_mel: int | None = None,
    alpha: float = 2.0,
    scale: float | None = None,
    device="cuda",
):
    """Frames [f0, f1) of :func:`multires_mel_spec_db`, computed on
    ``device`` from a sample SLICE: O(f1 - f0) compute and memory, never
    the whole track.

    ``wav_s`` covers global samples [slice_start, slice_start + len); use
    :func:`range_sample_window` for the minimal interval.  The internal
    frame range is extended by BLEND_MARGIN so the sharpness blend sees
    the same neighborhood as the full computation: the result equals
    ``multires_mel_spec_db(wav, ...)[0][f0:f1]`` bit for bit.

    ``wav_s`` may be an INTEGER carrier (int16/int32) with ``scale`` the
    f32 value of one unit: the segment then crosses to the device at
    carrier width and converts there, exactly (power-of-two scale).

    Returns (db (f1-f0, n_mel) tensor, n_frames_full).
    """
    setting = setting or SpecSetting()
    if n_mel is None:
        n_mel = adaptive_auto_n_mel(sr, setting, scales)
    wav_s = np.ascontiguousarray(wav_s)
    int_carrier = wav_s.dtype in (np.int16, np.int32)
    if int_carrier:
        if scale is None:
            raise ValueError("integer wav_s requires the carrier scale")
    else:
        wav_s = wav_s.astype(np.float32, copy=False)
    n = int(n_samples) if n_samples is not None else len(wav_s)
    hop, wins = _scale_params(sr, setting, scales)
    nf = n_frames_for(n, wins[0][0], hop)
    f0 = max(0, min(f0, nf))
    f1 = max(f0, min(f1, nf))
    if f1 == f0:
        return torch.zeros((0, n_mel), dtype=torch.float32,
                           device=device), nf
    e0 = max(0, f0 - BLEND_MARGIN)
    e1 = min(nf, f1 + BLEND_MARGIN)
    n_local = e1 - e0
    # >= 2 pad rows computed from the (matching) zero-extended stream, so
    # the blend never edge-pads where the full computation has real rows
    n_pad = round_up_to(n_local + 2, 256)

    specs = []
    for win, n_fft in wins:
        cdev, sdev, fbdev = _dev_scale_constants(sr, win, n_fft, n_mel,
                                                 torch.device(device))
        seg = _padded_segment(wav_s, slice_start, n, hop, win, e0, e1,
                              tail=(e1 == nf))
        need = (n_pad - 1) * hop + win
        if len(seg) < need:
            seg = np.pad(seg, (0, need - len(seg)))
        seg_dev = torch.from_numpy(np.ascontiguousarray(seg)).to(device)
        if int_carrier:
            seg_dev = _carrier_to_f32(seg_dev, scale)
        specs.append(_scale_spec(seg_dev, cdev, sdev, fbdev, win=win,
                                 hop=hop, n_frames=n_pad))
    db = _blend(specs, alpha=float(alpha))
    a = f0 - e0
    return db[a: a + (f1 - f0)], nf


@functools.lru_cache(maxsize=64)
def _dev_scale_constants(sr: int, win: int, n_fft: int, n_mel: int,
                         device: torch.device):
    """Per-scale DFT/mel operands on ``device``, cached by derived shape
    (viewer requests do not rebuild and re-upload them every render)."""
    window = (hann(win, False) / np.float32(n_fft)).astype(np.float32)
    c, s = windowed_dft_matrices(window, n_fft)
    fb = calc_mel_fb(sr, n_fft, n_mel, 0.0, None, True, np.float32)
    return tuple(torch.from_numpy(m).to(device) for m in (c, s, fb))


def _carrier_to_f32(seg, scale):
    """An integer-carrier segment as f32 samples (exact: power-of-two
    ``scale``)."""
    return seg.to(torch.float32) * scale
