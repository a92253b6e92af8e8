"""Streaming long-file spectrogram on one GPU, ported from
``msv_tpu/parallel/streaming.py``.

A long file (an hour at 48 kHz is 360 000 frames) is cut into segments of
``seg_chunks * chunk_frames`` frames by msv_tpu's own plan
(``_seg_plan_for``), each materialized on the host only as its slice of the
reflect-padded signal (``padded_slice``).  Every segment is one launch of
the fused mel dB kernel (``kernels/spectrogram_cuda.py``, the parity or the
fast kernel) writing its rows of one preallocated ``(n_total, n_out)``
plane, so no hour-long intermediate and no concatenation exists (under the
"xla" engine, the kernel's plain version writes those rows).  Without
the filterbank (``mel_fb=None``, the linear scale) the segments go through
a ``LinearRoute`` (``kernels/spectrogram_cuda.py``): one launch of the FFT
tier's linear form a segment where the route takes it (parity, on a card,
an n_fft with an FFT plan), else msv_tpu's per-chunk XLA step as torch ops
on the route's C and S (the DFT GEMM pair, magnitude, log10 dB),
``chunk_frames`` frames at a time.  With ``impl="fft"`` each segment runs
that step with ``torch.fft.rfft`` in place of the pair, and the mel GEMM
where there is a filterbank.  On a card the schedule overlaps the
host and the device: two pinned host buffers used in turn, a copy stream
that ships segment k+1 while the compute stream runs segment k, and a
per-segment masked min/max that stays on the device until one host sync at
the end.

``transfer="pack"`` ships each segment through the lossless wire codec
(``parallel/wirepack.py``: ``pack_best``, the v2 stream where it measures
smaller, else v1), ``"pack1"`` through the v1 stream alone, each falling
back to raw where packing does not shrink the segment.  The packed bytes
ride the same pinned buffers and copy stream, and are unpacked on the copy
stream into the segment the launch reads; an integer carrier that the
kernel does not read directly is scaled to f32 there (on the host for
raw).  The plane is bit-identical either way.  ``"auto"`` ships raw:
msv_tpu packs under "auto" because its relay moved about 25 MB/s, while
over PCIe the bytes are cheap and the host packer is not.  On an H100
80GB HBM3 at 700 W (chip_smoke.py phase 13, PERF.md §6) the hour streamed
in 0.18-0.26 s raw, against 6.06-7.17 s packed (5.16-6.57 s of it packing
1.24x fewer bytes on the host) and 2.32-2.44 s through the v1 stream
alone.
"""

import numpy as np
import torch

from ..config import get_precision_mode, precision_for
from ..kernels.spectrogram_cuda import (LinearRoute, MelRoute,
                                        linear_spectrogram_cuda,
                                        mel_spectrogram_cuda)
from ..ops.decibel import amp_to_db
from ..ops.framing import n_frames_for
from ..ops.stft import dft_magnitude, frame_device
from . import wirepack

_PCM16_SCALE = 2.0**-15


def _seg_plan_for(n_frames: int, chunk_frames: int, seg_chunks: int):
    """Segment-size ladder: full-size segments while they fit, then ONE
    tail segment of the next power-of-two chunk count — bounds transfer
    waste for short files at <2x while keeping program variety at
    log2(seg_chunks)+1 compiled executables total."""
    n_chunks_needed = -(-max(n_frames, 1) // chunk_frames)
    seg_plan = []
    remaining = n_chunks_needed
    while remaining >= seg_chunks:
        seg_plan.append(seg_chunks)
        remaining -= seg_chunks
    if remaining > 0:
        tail = 1
        while tail < remaining:
            tail *= 2
        seg_plan.append(min(tail, seg_chunks))
    return seg_plan


def padded_slice(src, a: int, b: int, half: int, n: int, dtype=np.int16):
    """Samples [a, b) of the conceptual reflect-padded + zero-tailed signal,
    materializing only this segment (src may be an np.memmap or ndarray).

    Replaces whole-file reflect_pad + pad copies: at hour scale those are
    two ~350 MB passes on the single host core before the first byte can
    move; this touches each output byte once.
    """
    out = np.zeros(b - a, dtype=dtype)
    # left reflect region: padded[p] = wav[half - p] for p < half
    lo = a
    if lo < half:
        hi = min(b, half)
        src_l = np.asarray(src[half - lo : half - hi : -1] if half - hi > 0
                           else src[half - lo :: -1][: hi - lo])
        out[: hi - lo] = src_l
        lo = hi
    # middle: padded[p] = wav[p - half] for half <= p < half + n
    if lo < b and lo < half + n:
        hi = min(b, half + n)
        out[lo - a : hi - a] = src[lo - half : hi - half]
        lo = hi
    # right reflect: padded[p] = wav[n - 2 - (p - half - n)] while valid
    if lo < b and lo < half + n + half:
        hi = min(b, half + n + half)
        idx0 = n - 2 - (lo - half - n)
        idx1 = n - 2 - (hi - 1 - half - n)
        if idx0 >= 0:
            idx1c = max(idx1, 0)
            src_r = np.asarray(src[idx0 : idx1c - 1 if idx1c > 0 else None : -1])
            out[lo - a : lo - a + len(src_r)] = src_r
    return out  # anything beyond stays zero (bucket tail)


def _segment_operands(c, s, mel_fb, device, impl, transfer, *, win, hop,
                      n_fft=None, window=None):
    """What every segment reads: a ``MelRoute`` for the mel kernel, or a
    ``LinearRoute`` without a filterbank (``c`` itself where it is one, on
    its own device; else made over the given C and S of ``win`` rows, on
    ``device`` or theirs), or ``(C, S, fb)`` in f32 on the device for the
    torch-op step (``impl="fft"``).  Raises on what no route takes."""
    route = isinstance(c, (MelRoute, LinearRoute))
    if impl not in ("dft", "pallas", "fft"):
        raise ValueError(f"unknown impl: {impl!r}")
    if impl == "fft" and (n_fft is None or window is None):
        raise ValueError("impl='fft' requires n_fft and window")
    if impl == "pallas" and mel_fb is None and not route:
        raise ValueError("impl='pallas' requires mel_fb")
    if transfer not in ("auto", "raw", "pack", "pack1"):
        raise ValueError(f"unknown transfer: {transfer!r}")
    if route:
        if impl == "fft" or (c.win, c.hop) != (win, hop):
            raise ValueError(f"a route of win={c.win}, hop={c.hop} given to "
                             f"impl={impl!r}, win={win}, hop={hop}")
        return c
    if device is None:
        if not isinstance(c, torch.Tensor):
            raise ValueError("streaming needs a device: pass device=, or "
                             "c and s as tensors on the device")
        device = c.device
    if impl == "fft":
        return tuple(None if a is None else torch.as_tensor(
            a, dtype=torch.float32, device=device) for a in (c, s, mel_fb))
    kw = dict(win=win, hop=hop, n_fft=2 * (c.shape[-1] - 1), device=device,
              dense=lambda: (c, s))
    if mel_fb is None:
        return LinearRoute(window, **kw)
    return MelRoute(window, mel_fb, **kw)


def _pack_segment(seg_np, transfer):
    """The segment packed for ``transfer``, or None to ship it raw ("auto",
    "raw", or a segment packing would not shrink).  "pack1" (and "pack"
    under ``_WIRE_V1_ONLY``) pins the v1 stream."""
    if transfer == "pack1" or (transfer == "pack" and _WIRE_V1_ONLY):
        if seg_np.dtype == np.float32:
            return wirepack.pack_f32(seg_np)
        return wirepack.pack_int(seg_np)
    if transfer == "pack":
        return wirepack.pack_best(seg_np)
    return None


# test/A-B hook: force the v1 wire codec wherever a segment is packed
_WIRE_V1_ONLY = False


def _torch_segment(seg, ops, out, *, win, hop, chunk_frames, scale, window,
                   n_fft, mode):
    """msv_tpu's per-chunk streaming step as torch ops, into the rows
    ``out`` of one segment: frames -> DFT GEMM pair (``window`` None) or
    |rfft| of the windowed frames zero-padded to ``n_fft`` -> [mel GEMM]
    -> amp_to_db, ``chunk_frames`` frames at a time, under
    ``precision_for(mode)`` (parity: true f32; fast: TF32)."""
    c, s, fb = ops
    x = seg.to(torch.float32) * scale if seg.dtype == torch.int16 else seg
    with precision_for(mode):
        for f0 in range(0, out.shape[0], chunk_frames):
            nf = min(chunk_frames, out.shape[0] - f0)
            if window is not None:
                # |X| does not depend on where the zero pad sits: a right
                # pad replaces the centered one
                frames = frame_device(x[f0 * hop:], win, hop, nf)
                wf = torch.nn.functional.pad(frames * window,
                                             (0, n_fft - win))
                mag = torch.fft.rfft(wf, dim=-1).abs()
            else:
                mag = dft_magnitude(x[f0 * hop:], c, s, win=win, hop=hop,
                                    n_frames=nf)
            out[f0 : f0 + nf] = amp_to_db(mag if fb is None else mag @ fb)
    return out


def _run_segments(make_seg, seg_plan, n_frames, win, hop, ops, chunk_frames,
                  *, mode, keep_wav=False, scale=_PCM16_SCALE, window=None,
                  n_fft=None, transfer="auto", sr=None):
    """Segment k's host slice (its carrier: int16, int32 or f32) -> device
    (raw, or packed for ``transfer`` and unpacked there) -> one call of
    the route (``ops`` a ``MelRoute`` or a ``LinearRoute``) or the torch-op
    step (``ops`` = (C, S, fb)) into rows [f0, f0 + seg_frames) of the
    output plane.  The
    device reads int16 at the PCM16 scale and f32; other carriers become
    ``carrier * scale`` in f32 (exact: power-of-two scales).

    On a card the host prepares segment k+1 while the device computes
    segment k: the kernel launches are asynchronous, the copies run on their
    own stream from one of two pinned buffers, the compute stream waits on
    each copy's event, and the host waits on the event of a buffer's last
    copy before it rewrites that buffer.  Per-segment min/max stay on the
    device; one host sync at the end reads them.
    """
    if isinstance(ops, MelRoute):
        device, n_out = ops.device, ops.fb.shape[-1]
    elif isinstance(ops, LinearRoute):
        device, n_out = ops.device, ops.n_out
    else:
        c, _, fb = ops
        device = c.device
        n_out = fb.shape[-1] if fb is not None else (
            c.shape[1] if window is None else n_fft // 2 + 1)
    on_card = device.type == "cuda"
    n_total = sum(seg_plan) * chunk_frames
    db = torch.empty((n_total, n_out), dtype=torch.float32, device=device)
    if window is not None:
        window = torch.from_numpy(np.ascontiguousarray(
            window, np.float32)).to(device)
    if on_card:
        compute = torch.cuda.current_stream(device)
        copier = torch.cuda.Stream(device)
        max_len = max(seg_plan) * chunk_frames * hop + (win - hop)
        pinned = [None, None]
        in_flight = [None, None]  # event of each buffer's last copy

    def read_form(seg_np):  # the raw segment as the device reads it
        if seg_np.dtype == np.float32 or (seg_np.dtype == np.int16
                                          and scale == _PCM16_SCALE):
            return seg_np
        return seg_np.astype(np.float32) * np.float32(scale)

    def device_form(seg):  # an unpacked segment as the device reads it
        if seg.dtype == torch.float32 or (seg.dtype == torch.int16
                                          and scale == _PCM16_SCALE):
            return seg
        return seg.to(torch.float32) * float(np.float32(scale))

    mins, maxs, segs = [], [], []
    f0 = 0
    for k, nck in enumerate(seg_plan):
        seg_frames = nck * chunk_frames
        seg_np = make_seg(f0 * hop, seg_frames * hop + (win - hop))
        packed = _pack_segment(seg_np, transfer)
        if on_card:
            slot = k % 2
            if pinned[slot] is None:
                # bytes of the longest raw segment: a pack is smaller
                pinned[slot] = torch.empty(
                    max_len * read_form(seg_np[:0]).itemsize,
                    dtype=torch.uint8, pin_memory=True)
            if in_flight[slot] is not None:
                in_flight[slot].synchronize()
            host = pinned[slot]
            staged = (None if packed is None
                      else wirepack.stage(packed, host.numpy()))
            if staged is None:
                raw = read_form(seg_np)
                host = host[: raw.nbytes]
                host.numpy()[:] = raw.view(np.uint8)
            with torch.cuda.stream(copier):
                if staged is None:
                    seg = torch.empty(
                        len(raw), dtype=torch.from_numpy(raw[:0]).dtype,
                        device=device)
                    seg.view(torch.uint8).copy_(host, non_blocking=True)
                else:
                    seg = device_form(wirepack.unpack_staged(
                        packed, *staged, host, device))
                in_flight[slot] = torch.cuda.Event()
                in_flight[slot].record(copier)
            compute.wait_event(in_flight[slot])
            # allocated on the copy stream, read on the compute stream
            seg.record_stream(compute)
        elif packed is None:
            seg = torch.from_numpy(read_form(seg_np))
        else:
            seg = device_form(wirepack.unpack_torch(packed, device))
        # rows at or after n_frames are zero-tail frames: not in the range
        n_valid = max(0, min(n_frames - f0, seg_frames))
        rows = db[f0 : f0 + seg_frames]
        if isinstance(ops, MelRoute):
            ops(seg, seg_frames, mode=mode, out=rows, sr=sr,
                launch=mel_spectrogram_cuda)
        elif isinstance(ops, LinearRoute) and ops.tier_here(mode) == "fft":
            # the launch alone: the min/max below is the segment's
            linear_spectrogram_cuda(seg, ops.record(), win=win, hop=hop,
                                    n_frames=seg_frames, out=rows, sr=sr)
        else:
            # the route's dense pair, in chunks of chunk_frames frames
            _torch_segment(seg, ops if isinstance(ops, tuple) else (
                *ops.dense(), None), rows, win=win, hop=hop,
                chunk_frames=chunk_frames, scale=scale, window=window,
                n_fft=n_fft, mode=mode)
        if n_valid:
            mins.append(rows[:n_valid].amin())
            maxs.append(rows[:n_valid].amax())
        if keep_wav:
            segs.append((seg, seg_frames))
        f0 += seg_frames
    mm = torch.stack([torch.stack(mins).amin(),
                      torch.stack(maxs).amax()]).cpu()  # one host sync
    out = (db, n_frames, float(mm[0]), float(mm[1]))
    if not keep_wav:
        return out
    # consecutive segments overlap by win - hop samples: all but the last
    # contribute their first seg_frames * hop samples
    pieces = [d[: fg * hop] for d, fg in segs[:-1]] + [segs[-1][0]]
    return (*out, pieces[0] if len(pieces) == 1 else torch.cat(pieces))


def streaming_spec_db(
    wav: np.ndarray,
    win: int,
    hop: int,
    c,
    s,
    mel_fb=None,
    chunk_frames: int = 4096,
    n_fft: int | None = None,
    window: np.ndarray | None = None,
    impl: str = "dft",
    seg_chunks: int = 8,
    transfer: str = "auto",
    keep_wav: bool = False,
    scale: float = 2.0**-15,
    *,
    device=None,
    sr: int | None = None,
):
    """Full-file dB spectrogram via segmented launches.

    Returns (db (n_frames_padded, n_out) on the device, n_frames, min_db,
    max_db), as ``msv_tpu``'s ``streaming_spec_db`` does: the same segment
    plan, so the same padded frame count.  n_out is n_mel with
    ``mel_fb``, else n_fft // 2 + 1 (the linear scale).

    With ``mel_fb``, ``impl`` "dft" and "pallas" both run the CUDA kernel on
    each segment (ln-based dB; any hop is allowed).  ``mel_fb=None`` (the
    linear scale) with ``impl="dft"`` runs a ``LinearRoute``'s FFT tier on
    each segment where it takes one (ln-based dB), else the DFT GEMM pair
    on its C and S as torch ops (log10 dB).  ``impl="fft"`` (``torch.fft.rfft`` of the frames
    times ``window``, zero-padded to ``n_fft``; both required) runs torch
    ops per segment, with msv_tpu's log10 dB.  Integer carriers: int16 with
    ``scale`` 2^-15 goes to the device as int16; int32 (a channel sum) and
    any other scale are scaled to f32 on the host, one segment at a time,
    or on the device after a packed transfer (exact: power-of-two scales).
    ``transfer``: "raw" and "auto" ship the samples, "pack" and "pack1"
    the wire codec's streams (module docstring); the plane is the same.

    The kernel follows the session's precision mode
    (``set_precision_mode``), as in ``msv_tpu``, and so does the torch-op
    route: true f32 in parity, TF32 in fast.  Under
    ``config.set_engine("xla")`` the kernel's segments run its plain
    version (``mel_spectrogram_plain``) on the same device instead.
    ``device`` defaults to the device of ``c`` (a tensor).
    ``c``, ``s``, ``mel_fb`` may be numpy f32, or tensors that are the
    mode's operands (f32, or bf16 for "fast"); the segments call one
    ``MelRoute`` (or, without ``mel_fb``, ``LinearRoute``) over them, made
    for this call.  Where its calls take the FFT tier (parity, on a card:
    ``tier_for``) the route's record is made from ``window``, the analysis
    window C and S were made with (and ``mel_fb``), and C and S are not
    shipped.  ``c`` may also be a ``MelRoute`` or a ``LinearRoute`` of this
    ``win`` and ``hop`` (``s`` and ``mel_fb`` None), as the session passes
    its own; the segments then go to its device, and it runs in the
    session's mode.

    ``keep_wav=True`` appends a 5th value: the reflect-padded, zero-tailed
    wave on the device, stitched from the shipped segments.  ``sr``, where
    given, goes on each call's ``mel.launch`` or ``linear.launch`` span.
    """
    ops = _segment_operands(c, s, mel_fb, device, impl, transfer, win=win,
                            hop=hop, n_fft=n_fft, window=window)
    # integer input is kept as the carrier: int16 raw PCM or the int32
    # multi-channel sum
    dtype = wav.dtype if wav.dtype in (np.int16, np.int32) else np.float32
    wav = np.ascontiguousarray(wav, dtype=dtype)
    n_frames = n_frames_for(len(wav), win, hop)
    seg_plan = _seg_plan_for(n_frames, chunk_frames, seg_chunks)
    half = win // 2

    def make_seg(a, seg_len):
        return padded_slice(wav, a, a + seg_len, half, len(wav), dtype=dtype)

    return _run_segments(make_seg, seg_plan, n_frames, win, hop, ops,
                         chunk_frames, mode=get_precision_mode(),
                         keep_wav=keep_wav, scale=scale,
                         window=window if impl == "fft" else None,
                         n_fft=n_fft, transfer=transfer, sr=sr)


def streaming_spec_db_mmap(path, win, hop, c, s, mel_fb=None,
                           chunk_frames: int = 4096, seg_chunks: int = 8,
                           transfer: str = "auto", *, device=None,
                           window=None):
    """Disk-streamed long-file spectrogram: segments are sliced straight
    from a memory-mapped mono WAV (PCM16 or float32), so host memory holds
    a segment or two, whatever the file's length.  Same results and
    schedule as :func:`streaming_spec_db` on the same samples (``window``
    as there: for a record of the FFT tier)."""
    from ..io.audio import open_wav_mmap

    ops = _segment_operands(c, s, mel_fb, device, "dft", transfer, win=win,
                            hop=hop, window=window)
    mm, sr = open_wav_mmap(path)
    n = len(mm)
    half = win // 2
    if n < half + 1:
        raise ValueError(f"{path}: too short for win_length={win}")
    n_frames = n_frames_for(n, win, hop)
    seg_plan = _seg_plan_for(n_frames, chunk_frames, seg_chunks)
    dtype = np.float32 if mm.dtype == np.float32 else np.int16

    def make_seg(a, seg_len):
        return padded_slice(mm, a, a + seg_len, half, n, dtype=dtype)

    return _run_segments(make_seg, seg_plan, n_frames, win, hop, ops,
                         chunk_frames, mode=get_precision_mode(),
                         transfer=transfer, sr=sr)
