"""Minimal dependency-free PNG writer.

The reference's integration test saves spec/wav PNGs via the Rust ``image``
crate (lib.rs:535-542); ours writes them with stdlib zlib.  Used by the CLI
and golden-image tests.
"""

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(img: np.ndarray, level: int = 2) -> bytes:
    """Encode (H, W), (H, W, 3) or (H, W, 4) uint8 as PNG bytes.

    ``level`` is the zlib effort.  Default 2: on real spectrogram content
    (measured on a 4403x500 session render, single host core) level 6
    costs 0.52 s for 2.50 MB while level 2 costs 0.11 s for 2.87 MB —
    4.5x less encode latency for +15% bytes, and this host core throttles
    10-200x in windows, so encode time is the risk.  Scanline filters
    (sub/up) were measured SLOWER and LARGER here: spectrogram rows are
    horizontally noisy, so prediction residuals carry more entropy than
    the raw stream.  Pass level=6+ for archival outputs.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("encode_png expects uint8")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}.get(c)
    if color_type is None:
        raise ValueError(f"unsupported channel count {c}")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # filter byte 0 per scanline
    body = np.concatenate(
        [np.zeros((h, 1), dtype=np.uint8), img.reshape(h, w * c)], axis=1
    ).tobytes()
    data = zlib.compress(body, level)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", data)
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray, level: int = 2) -> None:
    """Write uint8 image data as a PNG file (see :func:`encode_png`;
    pass ``level=6`` or higher for archival-size outputs)."""
    with open(path, "wb") as f:
        f.write(encode_png(img, level))
