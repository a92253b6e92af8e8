"""The viewer's crops (thesia src_rust/display.rs:44-115), plainly: the
spectrogram as grey (flipped, zero rows on top for lower rates, clamped to
the session's dB window), a Lanczos3 resize to the image's height and then
to the crop's columns of the full-width image (each pass clamped to
[0, 1]), grey levels rounded half up and painted from the colormap; the
waveform as each column's min/max over +-1.5 samples-per-pixel, a solid
band at least 3 px thick."""

import numpy as np
import torch

from .colormap import WAVECOLOR, grey_lut
from .spec import grey_height

f32 = np.float32


def _trunc(x) -> int:
    return max(int(x), 0)


def _round(x):
    x = np.asarray(x)
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def crop_columns(n_samples: int, sr: int, pps: float, start: float,
                 end: float):
    """(full width, c0, c1) of a crop, in float32 as the viewer takes
    them."""
    full = _trunc(f32(pps) * f32(n_samples) / f32(sr))
    c0 = _trunc(f32(pps) * f32(start))
    c1 = min(full, _trunc(f32(pps) * f32(end)))
    return full, c0, c1


def _lanczos3(x):
    x = x.astype(np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        a = x * f32(np.pi)
        s = np.where(x == 0, f32(1.0), np.sin(a) / a).astype(np.float32)
        b = a / f32(3.0)
        s3 = np.where(x == 0, f32(1.0), np.sin(b) / b).astype(np.float32)
    return np.where(np.abs(x) < f32(3.0), s * s3, f32(0.0)).astype(np.float32)


def lanczos_rows(n_in: int, n_out: int, o0: int, o1: int):
    """(first input index, weights (o1 - o0, M)) of output samples
    [o0, o1) of a resize from n_in to n_out (image-rs ``*_sample``)."""
    ratio = f32(n_in) / f32(n_out)
    sratio = max(ratio, f32(1.0))
    support = f32(3.0) * sratio
    centre = (np.arange(o0, o1).astype(np.float32) + f32(0.5)) * ratio
    left = np.clip(np.floor(centre - support).astype(np.int64), 0, n_in - 1)
    right = np.clip(np.ceil(centre + support).astype(np.int64), left + 1,
                    n_in)
    m = int((right - left).max())
    idx = left[:, None] + np.arange(m)[None, :]
    valid = idx < right[:, None]
    w = np.where(valid, _lanczos3(
        (idx.astype(np.float32) - (centre - f32(0.5))[:, None]) / sratio),
        f32(0.0)).astype(np.float32)
    w = w / w.sum(axis=1, keepdims=True, dtype=np.float32)
    return left, np.where(valid, w, f32(0.0)).astype(np.float32)


def spec_levels(plane: torch.Tensor, sr: int, ratio: float, max_db: float,
                min_db: float, pps: float, height: int, start: float,
                end: float, n_samples: int) -> np.ndarray:
    """(height, c1 - c0) uint8 grey levels of a spectrogram crop, from a
    (n_frames, n_bins) dB plane on any device; ``ratio`` is the track's
    alignment ratio on the session's scale (``spec.up_ratio_for``)."""
    dev = plane.device
    nf, n_bins = plane.shape
    full, c0, c1 = crop_columns(n_samples, sr, pps, start, end)
    left, wh = lanczos_rows(nf, full, c0, c1)
    f0 = int(left.min())
    f1 = min(nf, int(left.max()) + wh.shape[1])
    rng = f32(max_db) - f32(min_db)
    g = torch.clamp((plane[f0:f1] - float(f32(min_db))) / float(rng), 0, 1)
    gh = grey_height(n_bins, ratio)
    grey = torch.zeros((gh, f1 - f0), dtype=torch.float32, device=dev)
    grey[gh - n_bins:] = torch.flip(g.T, dims=(0,))
    vl, vw = lanczos_rows(gh, height, 0, height)
    wv = np.zeros((height, gh), np.float32)
    for r in range(height):
        n = min(vw.shape[1], gh - vl[r])
        wv[r, vl[r]:vl[r] + n] = vw[r, :n]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = torch.clamp(torch.from_numpy(wv).to(dev) @ grey, 0, 1)
        idx = torch.from_numpy(np.clip(
            left[:, None] + np.arange(wh.shape[1])[None, :] - f0, 0,
            f1 - f0 - 1)).to(dev)
        y = (x[:, idx] * torch.from_numpy(wh).to(dev)).sum(dim=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    y = torch.clamp(y, 0, 1)
    return torch.floor(y * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


def paint_levels(levels: np.ndarray) -> np.ndarray:
    return grey_lut(8)[levels]


def wav_crop(mono: np.ndarray, sr: int, pps: float, height: int,
             amp_min: float, amp_max: float, start: float,
             end: float) -> np.ndarray:
    """(height, c1 - c0, 4) uint8 waveform crop of a float32 mono track
    (at least one sample a pixel: no upsampling)."""
    n = len(mono)
    full = _trunc(f32(pps) * f32(n) / f32(sr))
    c0 = max(0, _trunc(f32(pps) * f32(start)))
    c1 = min(full, _trunc(f32(pps) * f32(end)))
    spp = f32(n) / f32(full)
    if spp < 1:
        raise ValueError("the reference draws at least one sample a pixel")
    i = np.arange(c0, c1).astype(np.float32)
    s = np.maximum(_round((i - f32(1.5)) * spp), 0).astype(np.int64)
    e = np.minimum(_round((i + f32(1.5)) * spp).astype(np.int64), n)
    e = np.maximum(e, s + 1)
    mx = np.array([mono[a:b].max() for a, b in zip(s, e)], np.float32)
    mn = np.array([mono[a:b].min() for a, b in zip(s, e)], np.float32)
    hi, lo, h = f32(amp_max), f32(amp_min), f32(height)

    def px(v):
        return _round((hi - v) * h / (hi - lo)).astype(np.int64)

    top, bottom = px(mx), px(mn)
    d = 3 - (bottom - top)
    top = np.maximum(top - np.where(d > 0, d // 2, 0), 0)
    bottom = np.minimum(bottom + np.where(d > 0, (d + 1) // 2, 0), height - 1)
    rows = np.arange(height)[:, None]
    band = (rows >= top[None, :]) & (rows <= bottom[None, :])
    out = np.zeros((height, c1 - c0, 4), np.uint8)
    out[band] = WAVECOLOR
    return out
