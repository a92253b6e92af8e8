"""Minimal FLAC encoder — test-fixture generator for the native decoder.

No FLAC tooling exists in this image, so fixtures for the native decoder
(msv_tpu/native/flac_decoder.cc) are produced here.  This is a real,
spec-conformant encoder (RFC 9639 bitstream: STREAMINFO, frame headers
with CRC-8/CRC-16, constant / verbatim / fixed-predictor subframes with
4-bit Rice partitioned residuals, escape partitions, wasted bits, and
left/right/mid-side stereo) kept deliberately simple — it optimizes
nothing, it just emits valid streams covering every decoder code path.
Analogous to ``write_wav`` (the WAV fixture generator in audio.py).
"""

import struct

import numpy as np

_FIXED_COEF = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c ^= b
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
    return c


def _crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c ^= b << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
    return c


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, bits: int):
        if bits == 0:
            return
        value &= (1 << bits) - 1
        self.acc = (self.acc << bits) | value
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, bits: int):
        self.write(value & ((1 << bits) - 1), bits)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _utf8_num(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    bits = n.bit_length()
    # a k-byte form holds 6*(k-1) payload bits in the tail + (7-k) in the lead
    nbytes = 2
    while 6 * (nbytes - 1) + (7 - nbytes) < bits:
        nbytes += 1
    rem = n
    tail = []
    for _ in range(nbytes - 1):
        tail.append(0x80 | (rem & 0x3F))
        rem >>= 6
    lead_prefix = (0xFF << (8 - nbytes)) & 0xFF
    return bytes([lead_prefix | rem] + tail[::-1])


def _zigzag(r: np.ndarray) -> np.ndarray:
    return np.where(r >= 0, r.astype(np.int64) << 1, ((-r.astype(np.int64)) << 1) - 1)


def _best_rice_param(z: np.ndarray) -> int:
    best, best_bits = 0, None
    for p in range(15):
        bits = int(np.sum(z >> p)) + len(z) * (p + 1)
        if best_bits is None or bits < best_bits:
            best, best_bits = p, bits
    return best


def _write_residual(bw: _BitWriter, res: np.ndarray, blocksize: int,
                    order: int, partition_order: int, force_escape: bool):
    bw.write(0, 2)  # 4-bit rice method
    bw.write(partition_order, 4)
    nparts = 1 << partition_order
    assert blocksize % nparts == 0
    idx = 0
    for part in range(nparts):
        count = (blocksize >> partition_order) - (order if part == 0 else 0)
        seg = res[idx : idx + count]
        idx += count
        z = _zigzag(seg)
        if force_escape:
            raw = max(1, int(np.max(np.abs(seg))).bit_length() + 1) if len(seg) else 1
            bw.write(0xF, 4)
            bw.write(min(raw, 31), 5)
            for v in seg:
                bw.write_signed(int(v), min(raw, 31))
        else:
            p = _best_rice_param(z) if len(z) else 0
            bw.write(p, 4)
            for u in z:
                bw.write_unary(int(u) >> p)
                bw.write(int(u) & ((1 << p) - 1), p)


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bps: int, mode: str,
                     partition_order: int, force_escape: bool,
                     wasted_bits: int):
    x = x.astype(np.int64)
    if wasted_bits:
        assert np.all((x & ((1 << wasted_bits) - 1)) == 0), (
            "wasted-bits fixture requires samples divisible by 2^k")
        x = x >> wasted_bits
    ebps = bps - wasted_bits

    def header(type_code):
        bw.write(0, 1)
        bw.write(type_code, 6)
        if wasted_bits:
            bw.write(1, 1)
            bw.write_unary(wasted_bits - 1)
        else:
            bw.write(0, 1)

    if mode == "auto" and np.all(x == x[0]):
        mode = "constant"
    elif mode == "auto":
        mode = "fixed2"

    if mode == "constant":
        assert np.all(x == x[0])
        header(0)
        bw.write_signed(int(x[0]), ebps)
    elif mode == "verbatim":
        header(1)
        for v in x:
            bw.write_signed(int(v), ebps)
    elif mode.startswith("fixed"):
        order = int(mode[5:])
        header(8 + order)
        for v in x[:order]:
            bw.write_signed(int(v), ebps)
        res = x.copy()
        for _ in range(order):
            res = np.diff(res)
        _write_residual(bw, res, len(x), order, partition_order, force_escape)
    elif mode.startswith("lpc"):
        # LPC subframe whose quantized coefficients reproduce the fixed
        # predictor of the given order (shift 0) — exercises the decoder's
        # LPC path with exactly-known integer arithmetic.
        order = int(mode[3:])
        coef = _FIXED_COEF[order]
        header(0x20 | (order - 1))
        for v in x[:order]:
            bw.write_signed(int(v), ebps)
        precision = 5
        bw.write(precision - 1, 4)
        bw.write_signed(0, 5)  # shift
        for cf in coef:
            bw.write_signed(cf, precision)
        res = x.copy()
        for _ in range(order):
            res = np.diff(res)
        _write_residual(bw, res, len(x), order, partition_order, force_escape)
    else:
        raise ValueError(f"unknown subframe mode {mode!r}")


def encode_flac(
    pcm: np.ndarray,
    sr: int,
    bps: int = 16,
    blocksize: int = 256,
    mode: str = "auto",
    stereo_mode: str = "independent",
    partition_order: int = 0,
    force_escape: bool = False,
    wasted_bits: int = 0,
) -> bytes:
    """Encode integer PCM (n_ch, n_samples) -> FLAC stream bytes.

    ``mode``: 'auto' | 'constant' | 'verbatim' | 'fixedK' (K=0..4) |
    'lpcK' (K=1..4).  ``stereo_mode``: 'independent' | 'left_side' |
    'right_side' | 'mid_side' (2-channel input only).
    """
    pcm = np.atleast_2d(np.asarray(pcm)).astype(np.int64)
    n_ch, n = pcm.shape
    assert 1 <= n_ch <= 8
    lim = 1 << (bps - 1)
    if pcm.min() < -lim or pcm.max() >= lim:
        raise ValueError(
            f"samples out of range for bps={bps}: [{pcm.min()}, {pcm.max()}]"
        )
    if stereo_mode != "independent":
        assert n_ch == 2, "stereo decorrelation needs 2 channels"

    out = bytearray(b"fLaC")
    # STREAMINFO (last metadata block)
    si = _BitWriter()
    si.write(blocksize, 16)
    si.write(blocksize, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sr, 20)
    si.write(n_ch - 1, 3)
    si.write(bps - 1, 5)
    si.write(n & ((1 << 36) - 1), 36)
    body = si.bytes() + b"\x00" * 16  # md5 unset
    out += bytes([0x80]) + struct.pack(">I", len(body))[1:] + body

    frame_no = 0
    for start in range(0, n, blocksize):
        block = pcm[:, start : start + blocksize]
        bs = block.shape[1]  # tail frame may legitimately be shorter
        frame_mode = mode
        order = int(mode[5:]) if mode.startswith("fixed") else (
            int(mode[3:]) if mode.startswith("lpc") else 0)
        if order and bs <= order:
            frame_mode = "verbatim"  # too short for the predictor warmup
        frame_po = partition_order if bs % (1 << partition_order) == 0 else 0
        hdr = _BitWriter()
        hdr.write(0b11111111111110, 14)
        hdr.write(0, 1)  # reserved
        hdr.write(0, 1)  # fixed-blocksize strategy
        hdr.write(7, 4)  # blocksize: 16-bit value at end
        hdr.write(0, 4)  # sample rate: from STREAMINFO
        ch_code = {"independent": n_ch - 1, "left_side": 8,
                   "right_side": 9, "mid_side": 10}[stereo_mode]
        hdr.write(ch_code, 4)
        ss_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bps]
        hdr.write(ss_code, 3)
        hdr.write(0, 1)  # reserved
        hdr_bytes = hdr.bytes() + _utf8_num(frame_no)
        bw = _BitWriter()
        bw.buf = bytearray(hdr_bytes)
        bw.write(bs - 1, 16)
        header_so_far = bw.bytes()
        bw.write(_crc8(header_so_far), 8)

        if stereo_mode == "independent":
            subs = [(block[ch], bps) for ch in range(n_ch)]
        elif stereo_mode == "left_side":
            subs = [(block[0], bps), (block[0] - block[1], bps + 1)]
        elif stereo_mode == "right_side":
            subs = [(block[0] - block[1], bps + 1), (block[1], bps)]
        else:  # mid_side
            subs = [((block[0] + block[1]) >> 1, bps),
                    (block[0] - block[1], bps + 1)]
        for x, sub_bps in subs:
            _encode_subframe(bw, x, sub_bps, frame_mode, frame_po,
                             force_escape, wasted_bits)
        bw.align()
        frame = bw.bytes()
        out += frame + struct.pack(">H", _crc16(frame))
        frame_no += 1
    return bytes(out)


def write_flac(path: str, wav: np.ndarray, sr: int, bps: int = 16, **kw) -> None:
    """float32 (n_ch, n_samples) in [-1, 1) -> .flac file (fixture helper)."""
    wav = np.atleast_2d(np.asarray(wav, dtype=np.float32))
    lim = 1 << (bps - 1)
    pcm = np.clip(np.round(wav * lim), -lim, lim - 1).astype(np.int64)
    with open(path, "wb") as f:
        f.write(encode_flac(pcm, sr, bps=bps, **kw))
