"""The viewer's colours, frozen from thesia src_rust/display.rs:10-42: the
10-stop colormap (position 10 x, floor index, the top stop flat from
index 9, channels rounded half away from zero) and the waveform colour."""

import numpy as np

STOPS = np.array(
    [[0, 0, 4], [27, 12, 65], [74, 12, 107], [120, 28, 109], [165, 44, 96],
     [207, 68, 70], [237, 105, 37], [251, 155, 6], [247, 209, 61],
     [252, 255, 164]], dtype=np.float32)
WAVECOLOR = np.array([200, 21, 103, 255], dtype=np.uint8)


def grey_lut(bits: int = 8) -> np.ndarray:
    """(2^bits, 3) uint8: the colour of grey level q / (2^bits - 1)."""
    f32 = np.float32
    levels = 1 << bits
    g = (np.arange(levels, dtype=np.float32) / f32(levels - 1)).astype(
        np.float32)
    n = STOPS.shape[0]
    pos = g * f32(n)
    idx = np.floor(pos).astype(np.int64)
    i0 = np.clip(idx, 0, n - 2)
    ratio = (pos - i0.astype(np.float32))[:, None].astype(np.float32)
    lerp = ratio * STOPS[i0 + 1] + (f32(1.0) - ratio) * STOPS[i0]
    rgb = np.where((idx >= n - 1)[:, None], STOPS[n - 1], lerp)
    return np.floor(rgb + f32(0.5)).astype(np.uint8)


def level_ranges(lut: np.ndarray) -> dict:
    """colour (packed 24-bit int) -> (lowest, highest) grey level painted
    with it: the levels a decoded pixel can stand for."""
    out = {}
    packed = (lut[:, 0].astype(np.int64) << 16) | (
        lut[:, 1].astype(np.int64) << 8) | lut[:, 2]
    for q, c in enumerate(packed.tolist()):
        lo, hi = out.get(c, (q, q))
        out[c] = (min(lo, q), max(hi, q))
    return out
