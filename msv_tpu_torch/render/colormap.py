"""10-stop magma-like colormap, ported from ``msv_tpu/render/colormap.py``
(reference: display.rs:10-42), with the reference's quantization quirks:

  * position = 10 * x, index = floor(position)                (display.rs:26-27)
  * index >= 9 saturates to the LAST stop — i.e. the top 10% of the grey
    range renders as a flat color                              (display.rs:28-29)
  * channel lerp is rounded half-away-from-zero to u8          (display.rs:38)
"""

import functools

import numpy as np
import torch

COLORMAP = np.array(
    [
        [0, 0, 4],
        [27, 12, 65],
        [74, 12, 107],
        [120, 28, 109],
        [165, 44, 96],
        [207, 68, 70],
        [237, 105, 37],
        [251, 155, 6],
        [247, 209, 61],
        [252, 255, 164],
    ],
    dtype=np.uint8,
)  # display.rs:10-21

WAVECOLOR = np.array([200, 21, 103, 255], dtype=np.uint8)  # display.rs:22


@functools.lru_cache(maxsize=4)
def _host_lut(bits: int) -> np.ndarray:
    """(2^bits, 3) u8 LUT: LUT[q] == the reference colormap evaluated at
    grey q/(2^bits - 1), in the same f32 arithmetic as the device path
    (display.rs:24-42).  Used to paint quantized-grey wire images host-side
    so the device->host fetch ships 1-2 bytes/px instead of 3."""
    f32 = np.float32
    levels = 1 << bits
    g = (np.arange(levels, dtype=np.float32) / f32(levels - 1)).astype(np.float32)
    stops = COLORMAP.astype(np.float32)
    n = stops.shape[0]
    position = g * f32(n)
    index = np.floor(position).astype(np.int64)
    last = index >= n - 1
    i0 = np.clip(index, 0, n - 2)
    ratio = (position - i0.astype(np.float32))[:, None].astype(np.float32)
    lerped = ratio * stops[i0 + 1] + (f32(1.0) - ratio) * stops[i0]
    rgb = np.where(last[:, None], stops[n - 1], lerped)
    return np.floor(rgb + f32(0.5)).astype(np.uint8)


def paint_grey_wire(q: np.ndarray, bits: int) -> np.ndarray:
    """Quantized grey wire image (u8/u16, any shape) -> u8 RGB (shape+(3,))."""
    return _host_lut(bits)[q]


def grey_to_rgb_planar(grey):
    """Map grey f32 in [0, 1] (H, W) -> channel-planar (3, H, W) u8.

    Exact port of convert_grey_to_color (display.rs:24-42); assumes the
    caller already clamped grey >= 0 (the resize pass does).
    """
    stops = torch.as_tensor(COLORMAP, dtype=torch.float32, device=grey.device)
    n = stops.shape[0]
    position = grey.to(torch.float32) * n
    index = torch.floor(position).to(torch.int64)
    last = index >= n - 1
    i0 = torch.clamp(index, 0, n - 2)
    ratio = position - i0.to(torch.float32)
    planes = []
    for ch in range(3):
        col = stops[:, ch]
        lerped = ratio * col[i0 + 1] + (1.0 - ratio) * col[i0]
        v = torch.where(last, col[n - 1], lerped)
        # Rust .round() as u8: half away from zero (values are >= 0 here).
        planes.append(torch.floor(v + 0.5).to(torch.uint8))
    return torch.stack(planes, dim=0)
