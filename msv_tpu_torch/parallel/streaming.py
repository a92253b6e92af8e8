"""Streaming long-file spectrogram on one GPU, ported from
``msv_tpu/parallel/streaming.py``.

A long file (an hour at 48 kHz is 360 000 frames) is cut into segments of
``seg_chunks * chunk_frames`` frames by msv_tpu's own plan
(``_seg_plan_for``), each materialized on the host only as its slice of the
reflect-padded signal (``padded_slice``).  Every segment is one launch of
the fused mel dB kernel (``kernels/spectrogram_cuda.py``, the parity or the
fast kernel) writing its rows of one preallocated ``(n_total, n_out)``
plane, so no hour-long intermediate and no concatenation exists.  Without
the filterbank (``mel_fb=None``, the linear scale) or with ``impl="fft"``,
each segment runs msv_tpu's per-chunk XLA step as torch ops instead (the
DFT GEMM pair or ``torch.fft.rfft``, magnitude, [mel GEMM], log10 dB),
``chunk_frames`` frames at a time.  On a card the schedule overlaps the
host and the device: two pinned host buffers used in turn, a copy stream
that ships segment k+1 while the compute stream runs segment k, and a
per-segment masked min/max that stays on the device until one host sync at
the end.

Not ported: the packed transfers ``transfer="pack"``/``"pack1"`` (ROADMAP
queue 1 item 11: wire codec).  ``"auto"`` and ``"raw"`` both ship raw
samples.
"""

import numpy as np
import torch

from ..config import get_precision_mode
from ..kernels.spectrogram_cuda import mel_spectrogram_cuda, operands_bf16
from ..ops.decibel import amp_to_db
from ..ops.framing import n_frames_for
from ..ops.stft import dft_magnitude, frame_device

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


def _device_operands(c, s, mel_fb, device, mode, kernel=True):
    """(C, S, fb) on ``device``: tensors are taken as they are, numpy arrays
    are shipped as f32.  For the kernel they are ``mode``'s operands (f32
    for fast mode are rounded to bf16 here); the torch-op route takes them
    in f32.  ``mel_fb`` may be None (no filterbank)."""
    if device is None:
        if not isinstance(c, torch.Tensor):
            raise ValueError("streaming needs a device: pass device=, or "
                             "c and s as tensors on the device")
        device = c.device
    ops = tuple(
        None if a is None
        else a.to(device) if isinstance(a, torch.Tensor)
        else torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
        for a in (c, s, mel_fb)
    )
    if not kernel:
        return tuple(None if a is None else a.to(torch.float32) for a in ops)
    if mode == "fast" and ops[0].dtype != torch.bfloat16:
        ops = operands_bf16(*ops)
    return ops


def _check_route(mel_fb, impl, transfer, n_fft=None, window=None):
    """Whether the route is the fused kernel (True) or torch ops (False);
    raises on what no route takes."""
    if impl not in ("dft", "pallas", "fft"):
        raise ValueError(f"unknown impl: {impl!r}")
    if impl == "fft" and (n_fft is None or window is None):
        raise ValueError("impl='fft' requires n_fft and window")
    if impl == "pallas" and mel_fb is None:
        raise ValueError("impl='pallas' requires mel_fb")
    if transfer in ("pack", "pack1"):
        raise NotImplementedError(
            f"transfer={transfer!r} is not ported (ROADMAP queue 1 item 11: "
            f"wire codec); 'auto' and 'raw' ship raw samples")
    if transfer not in ("auto", "raw"):
        raise ValueError(f"unknown transfer: {transfer!r}")
    return impl != "fft" and mel_fb is not None


def _torch_segment(seg, ops, out, *, win, hop, chunk_frames, scale, window,
                   n_fft):
    """msv_tpu's per-chunk streaming step as torch ops, into the rows
    ``out`` of one segment: frames -> DFT GEMM pair (``window`` None) or
    |rfft| of the windowed frames zero-padded to ``n_fft`` -> [mel GEMM]
    -> amp_to_db, ``chunk_frames`` frames at a time."""
    c, s, fb = ops
    x = seg.to(torch.float32) * scale if seg.dtype == torch.int16 else seg
    for f0 in range(0, out.shape[0], chunk_frames):
        nf = min(chunk_frames, out.shape[0] - f0)
        if window is not None:
            # |X| does not depend on where the zero pad sits: a right pad
            # replaces the centered one
            frames = frame_device(x[f0 * hop:], win, hop, nf)
            wf = torch.nn.functional.pad(frames * window, (0, n_fft - win))
            mag = torch.fft.rfft(wf, dim=-1).abs()
        else:
            mag = dft_magnitude(x[f0 * hop:], c, s, win=win, hop=hop,
                                n_frames=nf)
        out[f0 : f0 + nf] = amp_to_db(mag if fb is None else mag @ fb)
    return out


def _run_segments(make_seg, seg_plan, n_frames, win, hop, ops, chunk_frames,
                  *, mode, keep_wav=False, scale=_PCM16_SCALE, window=None,
                  n_fft=None):
    """Segment k's host slice -> device -> one kernel launch (with the
    filterbank and no ``window``) or the torch-op step into rows
    [f0, f0 + seg_frames) of the output plane.

    On a card the host prepares segment k+1 while the device computes
    segment k: the kernel launches are asynchronous, the copies run on their
    own stream from one of two pinned buffers, the compute stream waits on
    each copy's event, and the host waits on the event of a buffer's last
    copy before it rewrites that buffer.  Per-segment min/max stay on the
    device; one host sync at the end reads them.
    """
    c, s, fb = ops
    device = c.device
    on_card = device.type == "cuda"
    n_total = sum(seg_plan) * chunk_frames
    kernel = fb is not None and window is None
    n_out = fb.shape[-1] if fb is not None else (
        c.shape[1] if window is None else n_fft // 2 + 1)
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
    mins, maxs, segs = [], [], []
    f0 = 0
    for k, nck in enumerate(seg_plan):
        seg_frames = nck * chunk_frames
        seg_np = make_seg(f0 * hop, seg_frames * hop + (win - hop))
        if on_card:
            slot = k % 2
            if pinned[slot] is None:
                pinned[slot] = torch.empty(
                    max_len, dtype=torch.from_numpy(seg_np[:0]).dtype,
                    pin_memory=True)
            if in_flight[slot] is not None:
                in_flight[slot].synchronize()
            host = pinned[slot][: len(seg_np)]
            host.numpy()[:] = seg_np
            with torch.cuda.stream(copier):
                seg = torch.empty(len(seg_np), dtype=host.dtype,
                                  device=device)
                seg.copy_(host, non_blocking=True)
                in_flight[slot] = torch.cuda.Event()
                in_flight[slot].record(copier)
            compute.wait_event(in_flight[slot])
            # allocated on the copy stream, read on the compute stream
            seg.record_stream(compute)
        else:
            seg = torch.from_numpy(seg_np)
        if kernel:
            rows = mel_spectrogram_cuda(seg, c, s, fb, win=win, hop=hop,
                                        n_frames=seg_frames, mode=mode,
                                        out=db[f0 : f0 + seg_frames])
        else:
            rows = _torch_segment(seg, ops, db[f0 : f0 + seg_frames],
                                  win=win, hop=hop, chunk_frames=chunk_frames,
                                  scale=scale, window=window, n_fft=n_fft)
        # rows at or after n_frames are zero-tail frames: not in the range
        n_valid = max(0, min(n_frames - f0, seg_frames))
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
):
    """Full-file dB spectrogram via segmented launches.

    Returns (db (n_frames_padded, n_out) on the device, n_frames, min_db,
    max_db), as ``msv_tpu``'s ``streaming_spec_db`` does: the same segment
    plan, so the same padded frame count.  n_out is n_mel with
    ``mel_fb``, else n_fft // 2 + 1 (the linear scale).

    With ``mel_fb``, ``impl`` "dft" and "pallas" both run the CUDA kernel on
    each segment (ln-based dB; any hop is allowed).  ``mel_fb=None`` (the
    linear scale) or ``impl="fft"`` (``torch.fft.rfft`` of the frames
    times ``window``, zero-padded to ``n_fft``; both required) run torch
    ops per segment, with msv_tpu's log10 dB.  Integer carriers: int16 with
    ``scale`` 2^-15 goes to the device as int16; int32 (a channel sum) and
    any other scale are scaled to f32 on the host, one segment at a time
    (exact: power-of-two scales).

    The kernel follows the session's precision mode
    (``set_precision_mode``), as in ``msv_tpu``; the torch-op route is f32
    in every mode.  ``device`` defaults to the device of ``c`` (a tensor).
    ``c``, ``s``, ``mel_fb`` may be numpy f32, or tensors that are the
    mode's operands (f32, or bf16 for "fast").

    ``keep_wav=True`` appends a 5th value: the reflect-padded, zero-tailed
    wave on the device, stitched from the shipped segments.
    """
    kernel = _check_route(mel_fb, impl, transfer, n_fft, window)
    mode = get_precision_mode()
    ops = _device_operands(c, s, mel_fb, device, mode, kernel)
    # integer input is kept as the carrier: int16 raw PCM or the int32
    # multi-channel sum
    dtype = wav.dtype if wav.dtype in (np.int16, np.int32) else np.float32
    wav = np.ascontiguousarray(wav, dtype=dtype)
    as_i16 = dtype == np.int16 and scale == _PCM16_SCALE
    n_frames = n_frames_for(len(wav), win, hop)
    seg_plan = _seg_plan_for(n_frames, chunk_frames, seg_chunks)
    half = win // 2

    def make_seg(a, seg_len):
        seg = padded_slice(wav, a, a + seg_len, half, len(wav), dtype=dtype)
        if not as_i16 and seg.dtype != np.float32:
            seg = seg.astype(np.float32) * np.float32(scale)
        return seg

    return _run_segments(make_seg, seg_plan, n_frames, win, hop, ops,
                         chunk_frames, mode=mode, keep_wav=keep_wav,
                         scale=scale, window=window if impl == "fft" else None,
                         n_fft=n_fft)


def streaming_spec_db_mmap(path, win, hop, c, s, mel_fb=None,
                           chunk_frames: int = 4096, seg_chunks: int = 8,
                           transfer: str = "auto", *, device=None):
    """Disk-streamed long-file spectrogram: segments are sliced straight
    from a memory-mapped mono WAV (PCM16 or float32), so host memory holds
    a segment or two, whatever the file's length.  Same results and
    schedule as :func:`streaming_spec_db` on the same samples."""
    from ..io.audio import open_wav_mmap

    kernel = _check_route(mel_fb, "dft", transfer)
    mode = get_precision_mode()
    ops = _device_operands(c, s, mel_fb, device, mode, kernel)
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
                         chunk_frames, mode=mode)
