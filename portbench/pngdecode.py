"""Pixels of a PNG as the viewer writes it (8-bit grey, RGB or RGBA, one
IDAT stream, filter byte 0 on every scanline), decoded with zlib alone."""

import struct
import zlib

import numpy as np


def pixels(data: bytes) -> np.ndarray:
    """(H, W, C) uint8; raises ValueError for anything else."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, head = 8, [], None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            head = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat.append(body)
    if head is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype = head
    ch = {0: 1, 2: 3, 6: 4}.get(ctype)
    if depth != 8 or ch is None:
        raise ValueError(f"PNG depth {depth}, colour type {ctype}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * ch)
    if (raw[:, 0] != 0).any():
        raise ValueError("PNG scanline filter is not 0")
    return raw[:, 1:].reshape(h, w, ch)
