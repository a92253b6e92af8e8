"""Sequence-sharded, batch-sharded and frequency-sharded spectrograms and
the sequence-sharded waveform envelope over a device mesh, ported from
``msv_tpu/parallel/sharded.py``.

msv_tpu runs each of these as one ``shard_map`` program; the port runs the
same per-device step from one host loop, on each shard's mesh device:

  * a batch of equal-length reflect-padded waveforms is split by rows over
    "dp" and by time over "sp"; the shard at sp position j frames its
    chunk after the ``(win - hop)``-sample halo, the head of its right
    neighbour's chunk copied to its device (``Tensor.to``; across processes
    ``torch.distributed``), and the last shard takes the replicated tail;
  * the per-shard step is msv_tpu's: the windowed-DFT GEMM pair, the
    magnitude, [the mel GEMM], ``ops/decibel.py::amp_to_db``, each GEMM
    under ``config.precision_for(mode)`` (parity: true f32, TF32 off);
  * the global dB min/max over valid frames reduces per shard, then across
    shards on the mesh's first device (and across processes with
    ``all_reduce``); the frequency-sharded mel sum is the sum of the
    partial products on that device.

Sharded outputs are ``ShardedArray`` records: the shards in mesh order,
each with its global index, and ``gather(device)``; the port's form of
msv_tpu's sharded device arrays (``addressable_shards``, ``.index``,
``.data``).
msv_tpu left every step here to XLA, so these are torch ops; the per-shard
work of the sharded log-mel route (``features.log_mel_spectrogram``) is
the mel kernel.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..config import get_precision_mode, precision_for
from ..ops.decibel import amp_to_db
from ..ops.framing import n_frames_for, reflect_pad_center
from ..ops.stft import dft_magnitude
from ..render.envelope import _chunked_window_minmax, column_windows
from ..utils import round_up_to
from .mesh import Mesh, process_index
from .streaming import _torch_segment


@dataclass(frozen=True)
class Shard:
    """One shard of a ``ShardedArray``: its global ``index`` (a tuple of
    slices) and its ``data`` on its device."""

    index: tuple
    data: torch.Tensor

    @property
    def device(self):
        return self.data.device


class ShardedArray:
    """An array of ``shape`` split over ``mesh`` by ``spec``: one entry per
    dimension, a mesh axis name ("dp" or "sp"), a tuple of them (split
    over their product, row-major) or None (whole).  ``shards`` are the
    shards this process holds, one per distinct index, in mesh order;
    replicas along an axis the spec does not name are not kept."""

    def __init__(self, shape, mesh: Mesh, spec, shards):
        self.shape = tuple(shape)
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shards = list(shards)

    @property
    def addressable_shards(self):
        return self.shards

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def dtype(self):
        return self.shards[0].data.dtype

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on ``device`` (default: the first shard's)."""
        if not all(map(self.mesh.is_local, self.mesh.positions())):
            raise ValueError("gather needs every shard: this array spans "
                             "processes (read addressable_shards)")
        device = torch.device(device) if device is not None \
            else self.shards[0].device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for sh in self.shards:
            out[sh.index] = sh.data.to(device, non_blocking=True)
        return out


def _axis_block(spec_entry, mesh, pos):
    """(block number, block count) of mesh position ``pos`` along one
    dimension's spec entry."""
    if spec_entry is None:
        return 0, 1
    axes = (spec_entry,) if isinstance(spec_entry, str) else spec_entry
    k, n = 0, 1
    for a in axes:
        i = mesh.axis_names.index(a)
        k, n = k * mesh.devices.shape[i] + pos[i], n * mesh.devices.shape[i]
    return k, n


def _shard_index(shape, mesh, spec, pos):
    """The global index of mesh position ``pos``'s shard of an array of
    ``shape`` split by ``spec`` (every split dimension divisible)."""
    index = []
    for dim, entry in zip(shape, spec):
        k, n = _axis_block(entry, mesh, pos)
        if dim % n:
            raise ValueError(f"dimension {dim} does not split {n} ways "
                             f"(spec {spec})")
        index.append(slice(k * dim // n, (k + 1) * dim // n)
                     if n > 1 else slice(None))
    return tuple(index)


def _owners(shape, mesh, spec):
    """[(pos, index)]: the first mesh position holding each distinct
    index, in mesh order."""
    seen, out = set(), []
    for pos in mesh.positions():
        index = _shard_index(shape, mesh, spec, pos)
        key = tuple((s.start, s.stop) for s in index)
        if key not in seen:
            seen.add(key)
            out.append((pos, index))
    return out


def shard_array(x, mesh: Mesh, spec) -> ShardedArray:
    """``x`` (a tensor or numpy array, the whole array in every process)
    split over ``mesh`` by ``spec``: each of this process's shards copied to
    its device.  The port's form of msv_tpu's ``device_put`` of ``x`` with
    a ``NamedSharding`` of ``spec``."""
    x = torch.as_tensor(x)
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    shards = [Shard(index, x[index].to(mesh.devices[pos], non_blocking=True))
              for pos, index in _owners(x.shape, mesh, spec)
              if mesh.is_local(pos)]
    return ShardedArray(x.shape, mesh, spec, shards)


# ---------------------------------------------------------------------------
# moving data between shards and processes
# ---------------------------------------------------------------------------

def _comm_device(mesh):
    """Where this process reduces: its first mesh device, else its card or
    the CPU."""
    local = mesh.local_devices()
    if local:
        return local[0]
    return torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")


def _exchange(mesh, pieces, wants):
    """Move slices of the shards' pieces to other shards' devices.

    ``pieces``: {pos: tensor} of this process's positions.  ``wants``: a
    list, the same in every process, of ``(dst, src, take, shape, dtype)``:
    position ``dst`` wants ``take(pieces[src])`` (of ``shape`` and
    ``dtype``).  Returns {(dst, src): tensor on dst's device} for this
    process's ``dst``: a local source is copied with ``Tensor.to``, a source
    of another process comes by ``dist.batch_isend_irecv``."""
    me = process_index()
    got, ops = {}, []
    for dst, src, take, shape, dtype in wants:
        d_rank, s_rank = int(mesh.ranks[dst]), int(mesh.ranks[src])
        if d_rank == me and s_rank == me:
            got[dst, src] = take(pieces[src]).to(mesh.devices[dst],
                                                 non_blocking=True)
        elif s_rank == me:
            ops.append(dist.P2POp(dist.isend,
                                  take(pieces[src]).contiguous(), d_rank))
        elif d_rank == me:
            buf = torch.empty(shape, dtype=dtype, device=mesh.devices[dst])
            got[dst, src] = buf
            ops.append(dist.P2POp(dist.irecv, buf, s_rank))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


def _all_reduce(t, op):
    """``t`` reduced across the process group, if one is initialized."""
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(t, op=op)
    return t


def _reduce_range(mesh, lmins, lmaxs):
    """The global (min, max) of the per-shard minima and maxima: reduced
    on the mesh's first local device, then across processes."""
    dev = _comm_device(mesh)
    gmin = torch.stack([m.to(dev) for m in lmins]).amin() if lmins \
        else torch.tensor(np.inf, dtype=torch.float32, device=dev)
    gmax = torch.stack([m.to(dev) for m in lmaxs]).amax() if lmaxs \
        else torch.tensor(-np.inf, dtype=torch.float32, device=dev)
    return (_all_reduce(gmin, dist.ReduceOp.MIN),
            _all_reduce(gmax, dist.ReduceOp.MAX))


def _replicated(mesh, arrays):
    """{device: tuple of tensors}: ``arrays`` (numpy or tensors, None kept)
    copied once to each of this process's mesh devices."""
    return {dev: tuple(None if a is None else torch.as_tensor(
        np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a
    ).to(dev, torch.float32) for a in arrays) for dev in mesh.local_devices()}


def _masked_range(db, gidx, n_valid):
    """(min, max) of ``db`` (..., n_frames, n_out) over frames whose global
    index ``gidx`` is under ``n_valid``."""
    fmask = (gidx < n_valid)[:, None]
    return (torch.where(fmask, db, torch.inf).amin(),
            torch.where(fmask, db, -torch.inf).amax())


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------

def _local_spec(x, c, s, mel_fb, win, hop, fps, mode):
    """Frame a local chunk (+halo) and run the DFT/mel GEMM chain."""
    with precision_for(mode):
        mag = dft_magnitude(x, c, s, win=win, hop=hop, n_frames=fps)
        if mel_fb is not None:
            mag = mag @ mel_fb
    return amp_to_db(mag)


def sharded_spec_pipeline(mesh, wavs, win, hop, c, s, mel_fb, n_valid_frames):
    """Batch- and sequence-sharded spectrogram step.

    ``wavs``: (B, Lp) reflect-padded signals (numpy or a tensor; the whole
    batch in every process); B must divide by mesh dp, and the function
    derives frames_per_shard from Lp.  Returns (db ``ShardedArray`` (B,
    n_frames_total, n_out) split (dp, sp, None), min_db, max_db (0-d
    tensors on the mesh's first device) over the first ``n_valid_frames``
    frames, n_frames_total)."""
    n_dp, n_sp = mesh.shape["dp"], mesh.shape["sp"]
    halo = win - hop
    x = torch.as_tensor(wavs)
    B, lp = x.shape
    if B % n_dp:
        raise ValueError(f"batch {B} does not split over dp={n_dp}")
    # choose fps so that n_sp * fps * hop + halo <= Lp (pad host-side first)
    fps = (lp - halo) // (n_sp * hop)
    if fps < 1:
        raise ValueError(f"{lp} samples make no frame on sp={n_sp}")
    chunk = fps * hop
    body_len = n_sp * chunk
    tail = torch.nn.functional.pad(x[:, body_len : body_len + halo],
                                   (0, max(0, body_len + halo - lp)))
    rows = B // n_dp
    mode = get_precision_mode()
    ops = _replicated(mesh, (c, s, mel_fb))
    local = [p for p in mesh.positions() if mesh.is_local(p)]
    bodies = {(i, j): x[i * rows:(i + 1) * rows, j * chunk:(j + 1) * chunk]
              .to(mesh.devices[i, j], non_blocking=True) for i, j in local}
    # the halo of (i, j): the head of (i, j + 1); the last sp shard's is
    # the replicated tail
    halos = _exchange(mesh, bodies, [
        ((i, j), (i, j + 1), lambda b: b[:, :halo], (rows, halo), x.dtype)
        for i in range(n_dp) for j in range(n_sp - 1)])
    shards, lmins, lmaxs = [], [], []
    for i, j in local:
        dev = mesh.devices[i, j]
        right = (halos[(i, j), (i, j + 1)] if j < n_sp - 1 else
                 tail[i * rows:(i + 1) * rows].to(dev, non_blocking=True))
        xl = torch.cat([bodies[i, j], right], dim=-1).to(torch.float32)
        db = _local_spec(xl, *ops[dev], win, hop, fps, mode)
        lo, hi = _masked_range(db, j * fps + torch.arange(fps, device=dev),
                               n_valid_frames)
        lmins.append(lo)
        lmaxs.append(hi)
        shards.append(Shard((slice(i * rows, (i + 1) * rows),
                             slice(j * fps, (j + 1) * fps), slice(None)), db))
    gmin, gmax = _reduce_range(mesh, lmins, lmaxs)
    n_out = (mel_fb if mel_fb is not None else c).shape[-1]
    db = ShardedArray((B, n_sp * fps, n_out), mesh, ("dp", "sp", None),
                      shards)
    return db, gmin, gmax, fps * n_sp


def sharded_streaming_spec_db(mesh, wav, win, hop, c, s, mel_fb=None,
                              chunk_frames: int = 4096,
                              scale: float = 2.0**-15):
    """Long-file spectrogram over the "sp" axis of the mesh's first dp row
    (pass a mesh with dp=1): each device runs its contiguous run of
    chunks, ``chunk_frames`` frames at a time, after the halo from its
    right neighbour.  Mirrors streaming_spec_db's contract: returns (db
    ``ShardedArray`` (n_frames_total, n_out) split over sp, n_frames,
    min_db, max_db).

    ``scale`` is the integer-carrier unit (io/audio.py
    open_audio_mono_ex); int16 at 2^-15 goes to the devices as int16, any
    other carrier is scaled to f32 host-side (bit-identical)."""
    n_sp = mesh.shape["sp"]
    if wav.dtype == np.int16 and scale == 2.0**-15:
        dtype = np.int16
    elif wav.dtype in (np.int16, np.int32):
        wav = wav.astype(np.float32) * np.float32(scale)
        dtype = np.float32
    else:
        dtype = np.float32
    wav = np.ascontiguousarray(wav, dtype=dtype)
    n_frames = n_frames_for(len(wav), win, hop)
    fpd = round_up_to(-(-max(n_frames, 1) // n_sp), chunk_frames)
    n_total = fpd * n_sp
    halo = win - hop
    padded = reflect_pad_center(wav, win)
    need = n_total * hop + halo
    if len(padded) < need:
        padded = np.pad(padded, (0, need - len(padded)))
    padded = torch.from_numpy(padded)
    mode = get_precision_mode()
    ops = _replicated(mesh, (c, s, mel_fb))
    span = fpd * hop
    local = [(0, j) for j in range(n_sp) if mesh.is_local((0, j))]
    bodies = {p: padded[p[1] * span:(p[1] + 1) * span]
              .to(mesh.devices[p], non_blocking=True) for p in local}
    halos = _exchange(mesh, bodies, [
        ((0, j), (0, j + 1), lambda b: b[:halo], (halo,), padded.dtype)
        for j in range(n_sp - 1)])
    n_out = (mel_fb if mel_fb is not None else c).shape[-1]
    shards, lmins, lmaxs = [], [], []
    for p in local:
        j, dev = p[1], mesh.devices[p]
        right = (halos[p, (0, j + 1)] if j < n_sp - 1 else
                 padded[n_total * hop : need].to(dev, non_blocking=True))
        xl = torch.cat([bodies[p], right])
        db = torch.empty((fpd, n_out), dtype=torch.float32, device=dev)
        _torch_segment(xl, ops[dev], db, win=win, hop=hop,
                       chunk_frames=chunk_frames, scale=scale, window=None,
                       n_fft=None, mode=mode)
        lo, hi = _masked_range(db, j * fpd + torch.arange(fpd, device=dev),
                               n_frames)
        lmins.append(lo)
        lmaxs.append(hi)
        shards.append(Shard((slice(j * fpd, (j + 1) * fpd), slice(None)), db))
    gmin, gmax = _reduce_range(mesh, lmins, lmaxs)
    db = ShardedArray((n_total, n_out), mesh, ("sp", None), shards)
    return db, n_frames, float(gmin), float(gmax)


def freq_sharded_spec(mesh, wav, win, hop, c, s, mel_fb=None):
    """Tensor-parallel spectrogram over the "sp" axis of the mesh's first
    dp row: the frequency columns of the DFT matrices (and the matching
    filterbank rows) are split over the devices, each computing a
    frequency slice of the magnitude and a partial mel product; the
    partial products are summed on the mesh's first device (valid because
    |.| is elementwise per frequency column).  The frequency dimension is
    padded to a multiple of sp with zero columns, which contribute nothing.
    Returns (db (n_frames, n_out) tensor on the mesh's first device,
    n_frames); on the linear scale the frequency slices are concatenated
    there."""
    n_sp = mesh.shape["sp"]
    wav = np.ascontiguousarray(wav, dtype=np.float32)
    n_frames = n_frames_for(len(wav), win, hop)
    padded = reflect_pad_center(wav, win)
    need = (n_frames - 1) * hop + win
    if len(padded) < need:
        padded = np.pad(padded, (0, need - len(padded)))
    padded = torch.from_numpy(padded[:need])

    c, s = np.asarray(c), np.asarray(s)
    n_freq = c.shape[1]
    f_pad = (-n_freq) % n_sp
    width = (n_freq + f_pad) // n_sp
    c_p = np.pad(c, ((0, 0), (0, f_pad)))
    s_p = np.pad(s, ((0, 0), (0, f_pad)))
    use_mel = mel_fb is not None
    fb_p = np.pad(np.asarray(mel_fb), ((0, f_pad), (0, 0))) if use_mel \
        else None
    mode = get_precision_mode()
    dev0 = _comm_device(mesh)
    x = {dev: padded.to(dev, non_blocking=True)
         for dev in mesh.local_devices()}
    parts = []
    for j in range(n_sp):
        if not mesh.is_local((0, j)):
            continue
        dev, cols = mesh.devices[0, j], slice(j * width, (j + 1) * width)
        c_l, s_l = (torch.from_numpy(np.ascontiguousarray(m[:, cols]))
                    .to(dev) for m in (c_p, s_p))
        with precision_for(mode):
            mag = dft_magnitude(x[dev], c_l, s_l, win=win, hop=hop,
                                n_frames=n_frames)
            if use_mel:
                fb_l = torch.from_numpy(np.ascontiguousarray(fb_p[cols]))
                parts.append((j, mag @ fb_l.to(dev)))
            else:
                parts.append((j, mag))
    if use_mel:
        total = torch.zeros((n_frames, fb_p.shape[1]), dtype=torch.float32,
                            device=dev0)
        for _, part in parts:
            total += part.to(dev0)
        return amp_to_db(_all_reduce(total, dist.ReduceOp.SUM)), n_frames
    mag = torch.zeros((n_frames, n_freq + f_pad), dtype=torch.float32,
                      device=dev0)
    for j, part in parts:
        mag[:, j * width:(j + 1) * width] = part.to(dev0)
    # one slice per element is non-zero: the sum across processes is exact
    mag = _all_reduce(mag, dist.ReduceOp.SUM)
    return amp_to_db(mag[:, :n_freq]), n_frames


# ---------------------------------------------------------------------------
# Sequence-sharded waveform envelope (display.rs:92-97 min/max windows).
#
# The waveform is split across every mesh device (both axes flattened: a
# pure sequence op has no batch dimension); each device holds its span plus
# a halo from each neighbour and reduces the columns whose windows live in
# its span.  Column windows come from the host (render/envelope.py
# column_windows, the single-device builds' own window math), so the device
# math is pure min/max: bit-equal to the single-device envelope.
# ---------------------------------------------------------------------------

def sharded_envelope_minmax(mesh, wav, n_cols: int):
    """Per-column (max, min) of the min/max waveform envelope, sequence-
    sharded over every device of ``mesh``.

    Window i spans [round((i-1.5)*spp), round((i+1.5)*spp)) clamped to the
    signal, spp = len(wav)/n_cols; requires spp >= 1.  Returns (mx, mn)
    numpy arrays of length n_cols, bit-identical to the unsharded
    reduction.  Devices whose span holds no column do no work: unlike
    msv_tpu, no placeholder column widens the halo, so a shape where only
    such devices would need more than their span computes; a real column
    whose window reaches past its neighbours' spans still raises."""
    f32 = np.float32
    n = len(wav)
    if n_cols < 1 or n < n_cols:
        raise ValueError(f"need 1 <= n_cols <= len(wav), got {n_cols}, {n}")
    positions = mesh.positions()
    n_dev = len(positions)
    spp = f32(n) / f32(n_cols)
    i_px = np.arange(n_cols, dtype=np.float32)
    starts, ends = column_windows(i_px, n_cols, n, n)

    cols_per_dev = -(-n_cols // n_dev)
    local_len = int(np.ceil(cols_per_dev * float(spp)))
    # the exact reach of the real columns' windows past their device's span
    col_dev = np.arange(n_cols, dtype=np.int64) // cols_per_dev
    left_reach = (col_dev * local_len - starts).max()
    right_reach = (ends - (col_dev + 1) * local_len).max()
    halo = int(max(left_reach, right_reach, 1)) + 1
    if halo > local_len:
        raise ValueError(
            f"shards too small for the halo ({local_len} < {halo}): "
            f"use fewer devices or more samples per column")
    max_w = int((ends - starts).max())

    wav_f = np.zeros(local_len * n_dev, np.float32)
    wav_f[:n] = np.asarray(wav, np.float32)
    wav_f = torch.from_numpy(wav_f)
    mine = [d for d, p in enumerate(positions) if mesh.is_local(p)]
    pieces = {positions[d]: wav_f[d * local_len:(d + 1) * local_len]
              .to(mesh.devices[positions[d]], non_blocking=True)
              for d in mine}
    # left neighbour's tail, right neighbour's head; the ends of the mesh
    # take zeros (no window reaches outside the signal)
    wants = []
    for d in range(n_dev):
        if d > 0:
            wants.append((positions[d], positions[d - 1],
                          lambda w: w[-halo:], (halo,), torch.float32))
        if d < n_dev - 1:
            wants.append((positions[d], positions[d + 1],
                          lambda w: w[:halo], (halo,), torch.float32))
    halos = _exchange(mesh, pieces, wants)
    mx = torch.full((n_cols,), -np.inf)
    mn = torch.full((n_cols,), np.inf)
    for d in mine:
        a, b = d * cols_per_dev, min((d + 1) * cols_per_dev, n_cols)
        if a >= b:
            continue  # a span past the last column
        pos, dev = positions[d], mesh.devices[positions[d]]
        zeros = torch.zeros(halo, device=dev)
        ext = torch.cat([
            halos[pos, positions[d - 1]] if d > 0 else zeros, pieces[pos],
            halos[pos, positions[d + 1]] if d < n_dev - 1 else zeros])
        base = d * local_len - halo  # global index of ext[0]
        st = torch.from_numpy(starts[a:b] - base).to(dev)
        en = torch.from_numpy(ends[a:b] - base).to(dev)
        hi, lo = _chunked_window_minmax(ext, st, en, max_w)
        mx[a:b], mn[a:b] = hi.cpu(), lo.cpu()
    # each column is reduced in one process: the others hold +-inf there
    mx = _all_reduce(mx.to(_comm_device(mesh)), dist.ReduceOp.MAX)
    mn = _all_reduce(mn.to(_comm_device(mesh)), dist.ReduceOp.MIN)
    return mx.cpu().numpy(), mn.cpu().numpy()
