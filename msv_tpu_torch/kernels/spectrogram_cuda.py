"""The fused mel dB spectrogram kernels: CUDA C++ for Hopper, bound with ctypes.

Replace ``msv_tpu/kernels/spectrogram_pallas.py::mel_spectrogram_pallas``
in its three modes:

* ``mode="parity"``: f32 operands, both schedules
  (``msv_tpu_torch/csrc/mel_spectrogram.cu``, the DFT pair in 3xTF32 on
  the tensor cores, ``mma.sync``), and, for windows whose samples no
  resident block holds, the FFT tier (``msv_tpu_torch/csrc/
  mel_spectrogram_fft.cu``: a real FFT of n_fft points in f32 shared
  memory, no C/S);
* ``mode="fast"``: bf16 operands with f32 accumulation
  (``msv_tpu_torch/csrc/mel_spectrogram_bf16.cu``, tensor-core
  ``mma.sync``);
* ``mode="split"``: split-f32, each f32 product as three bf16 tensor-core
  products over (hi, lo) pairs (``msv_tpu_torch/csrc/
  mel_spectrogram_split.cu``, ``wgmma``; operands from ``operands_split``).

Each source's header says what bounds it on an H100 and how its design
answers that; all include ``csrc/mel_common.cuh``: the staging ring of C/S
slabs, the chunked tier's sample staging, the launchers' plan, the leftover
bin and the mel pass with its dB.  One rule, ``tier_for``, says which tier
(``TIERS``) a launch takes: the resident tier where a block holds its
frames' samples; else, in parity mode where n_fft is a power of two with
an FFT plan (``FFT_PLANS``), the FFT tier; else (parity and fast) the
chunked one, and every launcher reports its choice.  ``MelRoute`` is the
one owner of a caller's route (the kernel, its plain version under the
"xla" engine, or the CPU route) and of the operands it reads: the
session, streaming and the log-mel frontend hold routes and call them.
The linear scale has its own owner, ``LinearRoute`` (the session and
streaming): the FFT tier's linear form (``linear_spectrogram_cuda``, every
bin's dB, no filterbank) where ``tier_for`` gives "fft" with no mel bands,
else the dense pair of ``pipeline.spec_pipeline_batched``.
The sources are built with ``nvcc`` at first use into one library under
``build/msv_tpu_torch/`` beside the package, keyed on the hash of the
sources and the header, and loaded as a plain C library.

A kernel takes the reflect-padded 1-D wave ``(L,)`` or ``(B, L)`` (f32, or
int16 scaled by 2^-15 as it is loaded) and masks ragged edges itself.  Each
kernel takes its operands as a ``MelOperands`` record: from
``prepare_operands``, C and S cut into slabs laid out as the kernel's
shared-memory image, the last bin's columns kept apart, ``fb`` and its band
supports; for the FFT tier from ``prepare_fft_operands``, the window, the
twiddles and the band supports, and no C or S; a route makes the one a
launch's tier reads and keeps it.  Given plain ``(C, S, fb)`` (``(win,
n_freq)``, ``(win, n_freq)``, ``(n_freq, n_mel)``; f32 for parity, bf16
from ``operands_bf16`` for fast, the ``(2, ...)`` hi/lo stacks of
``operands_split`` for split) the wrapper prepares them per call, where
the launch's tier reads C and S.

``mel_spectrogram_plain`` is the same function in torch ops, in every
mode.  The wrapper ``mel_spectrogram_cuda`` takes it only for tensors on the
CPU; for CUDA tensors it launches the mode's kernel or raises.
"""

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from ..config import get_engine, precision_for
from ..ops.dft import windowed_dft_matrices
from ..ops.stft import frame_device
from ..utils.debug import check_nan
from ..utils.profiling import span
from .pipeline import masked_minmax, spec_pipeline_batched

_AMIN = 1e-18
_DB_SCALE = 20.0 / math.log(10.0)
_DB_FLOOR = 20.0 * math.log10(_AMIN)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {
    "parity": os.path.join(_PKG_DIR, "csrc", "mel_spectrogram.cu"),
    "fast": os.path.join(_PKG_DIR, "csrc", "mel_spectrogram_bf16.cu"),
    "split": os.path.join(_PKG_DIR, "csrc", "mel_spectrogram_split.cu"),
}
# The parity mode's FFT tier.
FFT_SOURCE = os.path.join(_PKG_DIR, "csrc", "mel_spectrogram_fft.cu")
# Device code every source includes (the ring, the leftover bin, the mel pass).
HEADER = os.path.join(_PKG_DIR, "csrc", "mel_common.cuh")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "msv_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

MODES = ("parity", "fast", "split")
# mode -> the library's entry point
ENTRY_POINTS = {"parity": "msv_mel_spectrogram",
                "fast": "msv_mel_spectrogram_bf16",
                "split": "msv_mel_spectrogram_split"}
FFT_ENTRY_POINT = "msv_mel_spectrogram_fft"
# The FFT tier's linear-scale form (the same source): every bin's dB, no
# filterbank.
LINEAR_ENTRY_POINT = "msv_linear_spectrogram_fft"
# The launchers' tiers, by the number a launcher reports (0: none fits):
# "resident" stages every sample of a block's frames once; "chunked" (the
# parity and fast kernels, where no resident block fits and, in parity, no
# FFT plan does: at the session's settings fast at 384 kHz) stages them in
# chunks along the window, again for every frequency tile; "fft" (parity,
# where no resident block fits and n_fft has a plan: at the session's
# settings from 176.4 kHz on) takes each frame's real FFT in shared memory.
# tier_for says which a launch takes.
TIERS = ("resident", "chunked", "fft")
# The linear scale's tiers on a card: "fft", the FFT tier's linear form
# (parity, where n_fft has an FFT plan: at the session's settings from 96
# kHz on), else "gemm", the dense windowed-DFT GEMM pair of
# ``kernels/pipeline.py::spec_pipeline_batched`` (fast mode's TF32 GEMMs at
# every rate).  ``LinearRoute`` takes them.
LINEAR_TIERS = ("gemm", "fft")
# n_fft -> the FFT tier's radix passes over its n_fft / 2 complex points
# (csrc/mel_spectrogram_fft.cu's FftPlan; the twiddle table follows them).
FFT_PLANS = {4096: (16, 16, 8), 8192: (16, 16, 16), 16384: (16, 16, 32),
             32768: (16, 32, 32)}
# The shared memory a block may use on an H100 (opt-in, bytes), by which
# tier_for judges whether a resident block fits, as the launchers do.
SMEM_BLOCK_BYTES = 232448
# Kernel launches made by mel_spectrogram_cuda (the CPU route does not
# count): the total, by precision mode (the kernel it launched) and by tier.
LAUNCHES = 0
LAUNCHES_BY_MODE = {mode: 0 for mode in MODES}
LAUNCHES_BY_TIER = {tier: 0 for tier in TIERS}
# Calls of the linear route on a card, by tier (``LinearRoute``; the CPU
# route does not count).
LINEAR_LAUNCHES_BY_TIER = {tier: 0 for tier in LINEAR_TIERS}
# nvcc's report (registers, shared memory, spills) from the last build.
BUILD_REPORT = ""

_LIB = None
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: cannot build the CUDA kernel")
    return path


def build() -> ctypes.CDLL:
    """Compile (once per hash of the sources and their header) and load
    the kernel library."""
    global _LIB, BUILD_REPORT
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        h = hashlib.sha256()
        for path in (*(SOURCES[m] for m in MODES), FFT_SOURCE, HEADER):
            with open(path, "rb") as f:
                h.update(f.read())
        tag = h.hexdigest()[:16]
        so = os.path.join(BUILD_DIR, f"libmsv_mel_{tag}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            # one nvcc per source, all at once, then one link
            srcs = {**SOURCES, "fft": FFT_SOURCE}
            objs = [f"{tmp}.{m}.o" for m in srcs]
            cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, src]
                    for o, src in zip(objs, srcs.values())]
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for c in cmds]
            outs = [p.communicate()[0] for p in procs]
            link = [_nvcc(), "-shared", "-o", tmp, *objs]
            for cmd, p, out in zip(cmds, procs, outs):
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({p.returncode}): "
                                       f"{' '.join(cmd)}\n{out}")
            r = subprocess.run(link, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed ({r.returncode}): "
                                   f"{' '.join(link)}\n{r.stdout}{r.stderr}")
            BUILD_REPORT = "".join(outs)
            os.replace(tmp, so)
            for o in objs:
                os.remove(o)
        lib = ctypes.CDLL(so)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        wave = [p, i, ll, ll, i]  # wave, is_i16, stride, length, batch
        shape = [i] * 5  # win, hop, n_frames, n_freq, n_mel
        for name in ENTRY_POINTS.values():
            # slabs, tail, wts, bands, woff, tile_bands, out; n_tiles,
            # n_wts, ks, nb, row; the stream and the plan (6 ints out)
            getattr(lib, name).argtypes = [*wave, *[p] * 7, *shape,
                                           *[i] * 5, p, p]
            getattr(lib, name).restype = ctypes.c_int
        # window, twiddles, wts, bands, woff, out; win, hop, n_frames,
        # n_fft, n_mel, n_tw; the stream and the plan
        getattr(lib, FFT_ENTRY_POINT).argtypes = [*wave, *[p] * 6, *[i] * 6,
                                                  p, p]
        getattr(lib, FFT_ENTRY_POINT).restype = ctypes.c_int
        # window, twiddles, out; win, hop, n_frames, n_fft, n_tw; the stream
        # and the plan
        getattr(lib, LINEAR_ENTRY_POINT).argtypes = [*wave, *[p] * 3,
                                                     *[i] * 5, p, p]
        getattr(lib, LINEAR_ENTRY_POINT).restype = ctypes.c_int
        lib.msv_cuda_error_string.argtypes = [ctypes.c_int]
        lib.msv_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def _as_f32(a):
    return (a.to(torch.float32) if isinstance(a, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(a, np.float32)))


def operands_from_numpy(c, s, fb, device="cpu"):
    """(C, S, fb) as f32 tensors on ``device``, from the host builders'
    ``(win, n_freq)``, ``(win, n_freq)`` and ``(n_freq, n_mel)`` arrays
    (``ops.dft.windowed_dft_matrices``, ``ops.mel``; contiguous), or from
    tensors (bf16 ones widened); ``fb`` None (the linear scale) stays
    None."""
    return tuple(None if a is None else _as_f32(a).to(device)
                 for a in (c, s, fb))


def operands_from_pallas(c3d, s3d, fb3d, win, n_freq, n_mel, device="cpu"):
    """Un-tile msv_tpu's ``prepare_matrices`` output —
    ``(nk, win_p, 256)`` DFT tiles and the ``(nk, 256, n_mel_p)``
    filterbank — back into this kernel's ``(win, n_freq)`` and
    ``(n_freq, n_mel)`` operands."""

    def untile(m3):
        a = np.asarray(m3, dtype=np.float32)
        return a.transpose(1, 0, 2).reshape(a.shape[1], -1)[:win, :n_freq]

    fb = np.asarray(fb3d, dtype=np.float32)
    fb = fb.reshape(-1, fb.shape[-1])[:n_freq, :n_mel]
    return operands_from_numpy(untile(c3d), untile(s3d), fb, device)


def mel_bands(fb):
    """(n_mel, 2) int32 [lo, hi) support of each filterbank column: the
    bins where it is nonzero ((0, 0) for an all-zero column).  The kernel
    multiplies only these bins; the skipped products are exact zeros.  For
    a split ``(2, n_freq, n_mel)`` stack, where either plane is nonzero."""
    nz = fb != 0
    if nz.ndim == 3:
        nz = nz.any(dim=0)
    has = nz.any(dim=0)
    lo = nz.to(torch.uint8).argmax(dim=0)
    hi = nz.shape[0] - nz.flip(0).to(torch.uint8).argmax(dim=0)
    zero = torch.zeros_like(lo)
    return torch.stack([torch.where(has, lo, zero), torch.where(has, hi, zero)],
                       dim=1).to(torch.int32).contiguous()


def band_weights(fb) -> int:
    """The compact filterbank's length (``MelOperands.wts``): the bins of
    every band's support, summed.  ``fb`` is a tensor or a numpy array."""
    bands = mel_bands(torch.as_tensor(fb))
    return int((bands[:, 1] - bands[:, 0]).sum())


def _ceil(a, b):
    return -(-a // b) * b


def _resident_bytes(mode, win, hop, n_mel, n_wts):
    """The shared memory of ``mode``'s smallest resident block (one m-tile,
    three ring stages): its launcher's ``fixed_bytes(1, ...) + 3 *
    SLAB_BYTES`` (csrc/mel_spectrogram.cu, csrc/mel_spectrogram_bf16.cu).
    No resident block fits where this passes the card's limit."""
    ks, nb, row = SLAB_LAYOUT[mode]
    win_p = _ceil(win, ks)
    rows = 16 + (win_p - 1) // hop  # staged rows of 16 frames' windows
    if mode == "parity":  # f32 samples and magnitudes
        esize, stride = 4, _ceil(hop, 8) + 12
        samples = (nb + 1) * 17 + rows * stride
    else:  # bf16; odd hops stage two copies
        esize, stride = 2, _ceil(_ceil(hop + 16, 8), 16) + 8
        samples = (nb + 1) * 18 + (2 if hop & 1 else 1) * rows * stride
    slab = 2 * ks * row * esize
    return (_ceil(128 + esize * samples, 16)
            + _ceil(12 * n_mel + esize * n_wts, 16) + 3 * slab)


def _fft_block_bytes(n_fft, n_mel):
    """The FFT tier's shared memory a block (csrc/mel_spectrogram_fft.cu's
    block_bytes): the n_fft / 2 points padded by one in 16, or the
    magnitudes, the band sums and the band tables, whichever is more; the
    points alone on the linear scale (``n_mel`` None)."""
    m = n_fft // 2
    return max(8 * (m + m // 16), 0 if n_mel is None
               else 4 * (m + 4 + 4 * n_mel))


def tier_for(mode, win, hop, n_fft, n_mel, n_wts=0):
    """The tier (``TIERS``) a launch of ``mode``'s kernel takes at this
    shape: n_mel bands whose compact filterbank holds ``n_wts`` weights
    (``band_weights``).  "resident" where a resident block fits the card
    (``SMEM_BLOCK_BYTES``, as the launchers judge it); else, in parity, "fft"
    where n_fft has an FFT plan (``FFT_PLANS``: a power of two, 4096 to 32
    768, at least ``win``) and its block fits; else "chunked".  The split
    kernel has its resident tier alone (its launcher raises where that does
    not fit).  At the session's settings: parity "fft" from 176.4 kHz on
    (n_fft 8192 and 16 384), fast "chunked" at 384 kHz, every other rate
    "resident".  Callers ask it before they build operands: only the
    resident and chunked tiers read C and S.

    ``n_mel`` None is the linear scale (``LINEAR_TIERS``): "fft" in parity
    where n_fft has an FFT plan, ``win`` fits it and the block fits the
    card (at the session's settings from 96 kHz on, n_fft 4096 to 16 384),
    else "gemm"."""
    if mode not in MODES:
        raise ValueError(f"unknown precision mode: {mode!r}")
    fft = (mode == "parity" and n_fft in FFT_PLANS and win <= n_fft
           and _fft_block_bytes(n_fft, n_mel) <= SMEM_BLOCK_BYTES)
    if n_mel is None:
        return "fft" if fft else "gemm"
    if mode == "split" or (_resident_bytes(mode, win, hop, n_mel, n_wts)
                           <= SMEM_BLOCK_BYTES):
        return "resident"
    return "fft" if fft else "chunked"


@functools.lru_cache(maxsize=8)
def fft_twiddles(n_fft: int, radices: tuple | None = None) -> np.ndarray:
    """The FFT tier's twiddle table for ``n_fft`` and its radix passes
    (``radices``, by default its ``FFT_PLANS`` entry), ``(n_tw, 2)`` f32
    (re, im) rows: W_n_fft^k = exp(-2 pi i k / n_fft) for k
    in [0, n_fft / 4] (the split of the packed half-length FFT into the real
    FFT's bins), then for each radix pass after the first, with NS the
    product of the radices before it and R its own, W_{NS R}^{r k} at row
    (r - 1) * NS + k, r in [1, R), k < NS.  Each value is computed in
    float64 (cos and sin of an exact fraction of a turn) and rounded once
    to f32."""
    radices = radices or FFT_PLANS[n_fft]
    turns = [np.arange(n_fft // 4 + 1) / n_fft]
    ns = radices[0]
    for r in radices[1:]:
        rk = np.arange(1, r)[:, None] * np.arange(ns)[None, :]
        turns.append((rk % (ns * r) / (ns * r)).ravel())
        ns *= r
    phase = 2.0 * np.pi * np.concatenate(turns)
    return np.ascontiguousarray(
        np.stack([np.cos(phase), -np.sin(phase)], axis=1), dtype=np.float32)


def operands_bf16(c, s, fb):
    """The fast mode's device operands: bf16 copies of the f32 ``(C, S,
    fb)``, rounded to nearest even, on the same device and in the same
    layouts.  Made once per rate and cached by the caller."""
    return tuple(t.to(torch.bfloat16).contiguous() for t in (c, s, fb))


def round_bf16(x):
    """``x`` rounded to bf16 (nearest even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_f32(x):
    """The (hi, lo) split of f32 ``x`` as f32 values: hi = bf16_rn(x), lo =
    bf16_rn(x - hi).  hi + lo carries about 16 mantissa bits of x."""
    hi = round_bf16(x)
    return hi, round_bf16(x - hi)


def split_tf32(x):
    """The 3xTF32 pair of f32 ``x`` as f32 values, as the parity kernel
    splits on the card (``cvt.rna.tf32.f32``): hi = x rounded to 10
    explicit mantissa bits, nearest, ties away from zero; lo = the same
    rounding of x - hi (exact in f32).  A product of two such values is
    exact in f32; hi + lo carries about 21 mantissa bits of x, and a value
    of 21 significant bits or fewer (an int16 sample times 2^-15) splits
    exactly."""
    bits = x.contiguous().view(torch.int32)

    def rna(b):
        # add half a tf32 unit to the magnitude bits, then truncate;
        # infinities and NaNs pass through
        special = (b & 0x7F800000) == 0x7F800000
        return torch.where(special, b, (b + 0x1000) & -0x2000)

    hi = rna(bits).view(torch.float32)
    return hi, rna((x - hi).view(torch.int32)).view(torch.float32)


def operands_split(c, s, fb):
    """The split mode's device operands: each f32 matrix of ``(C, S, fb)``
    as a ``(2, ...)`` bf16 stack of its (hi, lo) split, on the same device.
    The counterpart of msv_tpu's ``prepare_matrices_split`` without the TPU
    tiling, bit-equal to its ``split_bf16`` planes.  Made once per rate and
    cached by the caller."""
    return tuple(torch.stack(split_f32(t.to(torch.float32)))
                 .to(torch.bfloat16).contiguous() for t in (c, s, fb))


def mel_spectrogram_plain(padded, c, s, fb, *, win, hop, n_frames,
                          mode="parity"):
    """The kernels' function in torch ops: frames -> DFT GEMM pair ->
    magnitude -> mel GEMM -> dB (natural log, as the kernels compute it).

    ``mode="fast"`` is f32 arithmetic on bf16-rounded values: the frames,
    C, S, the magnitude and fb are rounded to bf16 (nearest even) and back.
    A product of two bf16 values is exact in f32, so this is "bf16
    operands, f32 accumulation" as the fast kernel computes it, and it runs
    on any device.  The operands may be f32 or already bf16.

    ``mode="split"`` splits the frames and the magnitude into (hi, lo)
    bf16 pairs (``split_f32``) and takes each product as three f32 matmuls
    on bf16 values (hi.hi + hi.lo + lo.hi), as the split kernel does.  The
    operands are the ``(2, ...)`` stacks of ``operands_split``, or f32
    matrices that it splits here.
    """
    x = padded
    if x.dtype == torch.int16:
        x = x.to(torch.float32) * 2.0**-15
    frames = frame_device(x, win, hop, n_frames)
    with precision_for("parity"):  # every mode's products are f32 GEMMs
        mel = _plain_mel(frames, c, s, fb, mode)
    return torch.where(mel > _AMIN, torch.log(mel) * _DB_SCALE, _DB_FLOOR)


def _plain_mel(frames, c, s, fb, mode):
    if mode == "split":
        if c.ndim == 2:
            c, s, fb = operands_split(c, s, fb)
        (ch, cl), (sh, sl), (fbh, fbl) = (t.to(torch.float32)
                                          for t in (c, s, fb))
        fh, fl = split_f32(frames)
        re = fh @ ch + fh @ cl + fl @ ch
        im = fh @ sh + fh @ sl + fl @ sh
        mh, ml = split_f32(torch.sqrt(re * re + im * im))
        return mh @ fbh + mh @ fbl + ml @ fbh
    c, s, fb = (t.to(torch.float32) for t in (c, s, fb))
    if mode == "fast":
        frames, c, s, fb = (round_bf16(t) for t in (frames, c, s, fb))
    re = frames @ c
    im = frames @ s
    mag = torch.sqrt(re * re + im * im)
    if mode == "fast":
        mag = round_bf16(mag)
    return mag @ fb


# mode -> (operand dtype, operand rank, the maker named in errors)
_OPERANDS = {
    "parity": (torch.float32, 2, "operands_from_numpy"),
    "fast": (torch.bfloat16, 2, "operands_bf16"),
    "split": (torch.bfloat16, 3, "operands_split"),
}
# The slab layout each kernel stages through the ring (its source checks
# it): rows per slab, bins per frequency tile, and the padded row stride in
# elements (parity, fast) or, for split, the side of the 8 x 8 core matrices
# its planes are cut into.
SLAB_LAYOUT = {"parity": (16, 128, 136), "fast": (16, 256, 264),
               "split": (16, 128, 8)}


def _check_operand_types(c, s, fb, mode):
    """Raise unless c, s and fb are of ``mode``'s dtype and rank (a split
    stack mixed with a plain matrix raises here, as in msv_tpu)."""
    if mode not in MODES:
        raise ValueError(f"unknown precision mode: {mode!r}")
    dtype, ndim, maker = _OPERANDS[mode]
    for name, t in (("c", c), ("s", s), ("fb", fb)):
        if t.dtype != dtype or t.ndim != ndim or (ndim == 3
                                                  and t.shape[0] != 2):
            raise ValueError(
                f"c, s and fb must all be {'(2, ...) ' if ndim == 3 else ''}"
                f"{ndim}-D {dtype} tensors in mode {mode!r} (make them with "
                f"{maker}); {name} is {t.dtype} {tuple(t.shape)}")


@dataclasses.dataclass(frozen=True, eq=False)
class MelOperands:
    """One mode's kernel operands, laid out once per rate by
    ``prepare_operands`` (C/S slabs: the resident and chunked tiers) or
    ``prepare_fft_operands`` (the FFT tier: no C, S, slabs or tail);
    ``mel_spectrogram_cuda`` takes it in place of ``(c, s, fb)``."""

    mode: str
    # (win, n_freq), the mode's dtype (the plain version's); split: the
    # (2, win, n_freq) hi/lo stack; None in an FFT-tier record (dft())
    c: torch.Tensor | None
    s: torch.Tensor | None
    # (n_freq, n_mel), contiguous; split: (2, n_freq, n_mel); in an FFT-tier
    # record where it was made (its kernel reads the compact tables; dft()
    # moves it)
    fb: torch.Tensor
    bands: torch.Tensor  # (n_mel, 2) int32: mel_bands(fb)
    # the filterbank over each band's bins: band m's weights for bins
    # [lo, hi) are wts[woff[m] : woff[m] + hi - lo]; split: (n_wts, 2),
    # each weight as its (hi, lo) pair
    wts: torch.Tensor
    woff: torch.Tensor  # (n_mel,) int32
    # (n_tiles, 2) int32: the bands [ma, mb) that each frequency tile's bins
    # meet (the last tile's include bin n_freq - 1); FFT tier: its one tile,
    # all the bins
    tile_bands: torch.Tensor
    # parity, fast: (n_tiles, n_k, 2, ks, row): slab (t, j) is rows
    # [j*ks, (j+1)*ks) of bins [t*nb, (t+1)*nb) of C, then of S; zeros past
    # win, past bin n_freq - 2 and in columns [nb, row).
    # split: (n_tiles, n_k, 4, ks/8, nb/8, 8, 8): slab (t, j) as the planes
    # Ch, Cl, Sh, Sl, each cut into 8 x 8 core matrices: element [p, a, b,
    # r, q] is row j*ks + 8*a + r, bin t*nb + 8*b + q of plane p; None in
    # an FFT-tier record
    slabs: torch.Tensor | None
    # (win, 2): C[:, n_freq-1] and S[:, n_freq-1]; split: (win, 4), that
    # column of Ch, Cl, Sh, Sl; None in an FFT-tier record
    tail: torch.Tensor | None
    ks: int
    nb: int
    row: int
    # the FFT tier's: the window (win,) f32 and fft_twiddles(n_fft) (n_tw, 2)
    # f32; None in a record of slabs
    window: torch.Tensor | None = None
    twiddles: torch.Tensor | None = None

    @property
    def fft(self) -> bool:
        """Whether this is an FFT-tier record (``prepare_fft_operands``)."""
        return self.twiddles is not None

    @property
    def win(self):
        return self.window.shape[0] if self.fft else self.c.shape[-2]

    @property
    def n_freq(self):
        return self.fb.shape[-2]

    @property
    def n_fft(self):
        return 2 * (self.n_freq - 1)

    @property
    def device(self):
        """The device of the tensors the kernel reads."""
        return self.window.device if self.fft else self.fb.device

    @property
    def n_tiles(self):
        return self.tile_bands.shape[0]

    def dft(self):
        """``(c, s, fb)`` for the plain version.  An FFT-tier record holds no
        C or S: they are built here from its window
        (``ops.dft.windowed_dft_matrices``, on the host, then moved to the
        record's device), for the CPU route and plain comparisons only."""
        if not self.fft:
            return self.c, self.s, self.fb
        c, s = windowed_dft_matrices(self.window.cpu().numpy(), self.n_fft)
        return tuple(t.to(self.device) for t in (
            torch.from_numpy(c), torch.from_numpy(s), self.fb))

    def to(self, device):
        """This FFT-tier record with the tensors its kernel reads (window,
        twiddles, band tables) on ``device``; ``fb`` stays where it is."""
        if not self.fft:
            raise ValueError("to() moves FFT-tier records; prepare_operands "
                             "makes a record of slabs on its operands' device")
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(device) for name in (
                "window", "twiddles", "bands", "wts", "woff", "tile_bands")})


def prepare_operands(c, s, fb, mode="parity"):
    """One kernel's operands as a ``MelOperands`` record, from that mode's
    ``(C, S, fb)`` (f32 from ``operands_from_numpy``, bf16 from
    ``operands_bf16``, or the hi/lo stacks of ``operands_split``), on their
    device.

    C and S are cut into slabs of ``ks`` rows x ``nb`` bins
    (``SLAB_LAYOUT``), each laid out as the kernel's ring stage in shared
    memory, every slab contiguous and 16-byte aligned, so that one bulk
    copy stages it.  Parity and fast: C's rows, then S's, at a padded row
    stride.  Split: the four planes Ch, Cl, Sh, Sl, each as 8 x 8 core
    matrices of 128 contiguous bytes (bins contiguous within a row of 8),
    first along the bins, then the two groups of 8 rows: the order a
    ``wgmma`` shared-memory descriptor reads without swizzle.  Tiles
    cover bins ``[0, n_freq - 1)``; the last tile is zero-padded where
    ``nb`` does not divide ``n_freq - 1`` (it does at every default rate:
    n_freq - 1 = n_fft / 2).  Bin ``n_freq - 1``'s columns are kept apart
    (``tail``): the last tile computes that bin with SIMT FMAs instead of a
    K sweep of its own.  ``bands`` are ``mel_bands(fb)``, made here once
    instead of at every launch (for split over the union of the hi and lo
    planes' support), and ``wts`` the filterbank compacted to each band's
    bins, contiguous per band (for split each weight as its (hi, lo) pair).
    Made once per rate and cached by the caller; the record holds ``c``,
    ``s`` and ``fb`` too, for the plain version."""
    _check_operand_types(c, s, fb, mode)
    win, n_freq = c.shape[-2:]
    if s.shape != c.shape or fb.shape[-2] != n_freq or win < 1:
        raise ValueError(f"c and s must be (win, n_freq) and fb (n_freq, "
                         f"n_mel), got {tuple(c.shape)}, {tuple(s.shape)} "
                         f"and {tuple(fb.shape)}")
    if len({t.device for t in (c, s, fb)}) != 1:
        raise ValueError("c, s and fb must be on one device")
    ks, nb, row = SLAB_LAYOUT[mode]
    n_bins = n_freq - 1
    n_tiles = max(1, -(-n_bins // nb))
    n_k = -(-win // ks)
    if mode == "split":
        n_k += n_k % 2  # its slab loop runs in pairs: one more zero slab
    # the planes the ring carries: C, S, or Ch, Cl, Sh, Sl
    planes = torch.cat([t.reshape(-1, win, n_freq) for t in (c, s)])
    n_p = planes.shape[0]
    body = torch.zeros((n_p, n_k * ks, n_tiles * nb), dtype=c.dtype,
                       device=c.device)
    body[:, :win, :n_bins] = planes[:, :, :n_bins]
    if mode == "split":
        slabs = body.reshape(n_p, n_k, ks // row, row, n_tiles, nb // row,
                             row).permute(4, 1, 0, 2, 5, 3, 6).contiguous()
    else:
        slabs = torch.zeros((n_tiles, n_k, n_p, ks, row), dtype=c.dtype,
                            device=c.device)
        slabs[..., :nb] = body.reshape(n_p, n_k, ks, n_tiles, nb).permute(
            3, 1, 0, 2, 4)
    tail = planes[:, :, n_bins].T.contiguous()
    bands, wts, woff = _band_tables(fb, mode)
    k0 = torch.arange(n_tiles, device=fb.device) * nb
    k1 = torch.clamp(k0 + nb, max=n_bins)
    k1[-1] = n_freq
    lo, hi = bands[:, 0], bands[:, 1]
    meets = ((lo < hi) & (lo < k1[:, None]) & (hi > k0[:, None]))
    tile_bands = mel_bands(meets.T)
    return MelOperands(mode, c, s, fb.contiguous(), bands, wts, woff,
                       tile_bands, slabs, tail, ks, nb, row)


def _band_tables(fb, mode):
    """(bands, wts, woff) of a record: ``mel_bands(fb)`` and the filterbank
    compacted to each band's bins, contiguous per band (for split each
    weight as its (hi, lo) pair), band m's from woff[m]."""
    bands = mel_bands(fb)
    widths = (bands[:, 1] - bands[:, 0]).long()
    woff = torch.cumsum(widths, 0) - widths
    band = torch.repeat_interleave(torch.arange(len(widths),
                                                device=fb.device), widths)
    pos = torch.arange(int(widths.sum()), device=fb.device)
    wts = fb[..., bands[band, 0].long() + pos - woff[band], band]
    wts = (wts.T if mode == "split" else wts).contiguous()
    return bands, wts, woff.to(torch.int32)


def _fft_window(window, n_fft):
    """The analysis window of an FFT-tier record as an f32 tensor on the
    host; raises where n_fft has no plan or the window does not fit it."""
    if n_fft not in FFT_PLANS:
        raise ValueError(f"the FFT tier has no plan for n_fft={n_fft} "
                         f"(FFT_PLANS: {sorted(FFT_PLANS)})")
    window = torch.as_tensor(np.ascontiguousarray(
        window.cpu().numpy() if isinstance(window, torch.Tensor) else window,
        dtype=np.float32))
    if window.ndim != 1 or not 1 <= window.shape[0] <= n_fft:
        raise ValueError(f"window must be (win,) with 1 <= win <= n_fft, got "
                         f"{tuple(window.shape)}")
    return window


def prepare_fft_operands(window, fb, n_fft):
    """The FFT tier's record (parity mode) from the analysis window
    ``(win,)`` and the f32 filterbank ``(n_fft // 2 + 1, n_mel)`` (a tensor,
    on the device the record is for; ``to`` moves a record): the window in
    f32, the twiddle table ``fft_twiddles(n_fft)``, the band supports and
    the compact filterbank.  It holds no C, S, slabs or tail: the kernel
    applies the window to each frame, zero-pads it to n_fft at the left
    offset (n_fft - win) // 2 (``ops.dft.n_pad_split``), and takes its FFT,
    the function of ``windowed_dft_matrices(window, n_fft)``'s pair.  Made
    once per rate and cached by the caller."""
    window = _fft_window(window, n_fft)
    if fb.dtype != torch.float32 or fb.ndim != 2 or (
            fb.shape[0] != n_fft // 2 + 1):
        raise ValueError(f"fb must be a (n_fft // 2 + 1 = {n_fft // 2 + 1}, "
                         f"n_mel) float32 tensor, got {fb.dtype} "
                         f"{tuple(fb.shape)}")
    window = window.to(fb.device)
    fb = fb.contiguous()
    bands, wts, woff = _band_tables(fb, "parity")
    tile_bands = mel_bands(bands[:, :1] < bands[:, 1:]).reshape(1, 2)
    return MelOperands("parity", None, None, fb, bands, wts, woff,
                       tile_bands, None, None, 0, 0, 0, window,
                       torch.from_numpy(fft_twiddles(n_fft)).to(fb.device))


def _check_wave(padded, win, hop, n_frames):
    if padded.ndim not in (1, 2):
        raise ValueError("padded must be (L,) or (B, L)")
    if padded.dtype not in (torch.float32, torch.int16):
        raise ValueError(f"padded must be float32 or int16, got {padded.dtype}")
    if win < 1 or hop < 1 or n_frames < 1:
        raise ValueError("win, hop and n_frames must be >= 1")
    need = (n_frames - 1) * hop + win
    if padded.shape[-1] < need:
        raise ValueError(f"padded has {padded.shape[-1]} samples, "
                         f"{n_frames} frames need {need}")


def _check(padded, c, s, fb, win, hop, n_frames, mode):
    _check_operand_types(c, s, fb, mode)
    n_freq = c.shape[-1]
    if c.shape[-2:] != (win, n_freq) or s.shape != c.shape:
        raise ValueError(f"c and s must be (win={win}, n_freq), got "
                         f"{tuple(c.shape)} and {tuple(s.shape)}")
    if fb.shape[-2] != n_freq:
        raise ValueError(f"fb must be (n_freq={n_freq}, n_mel), got "
                         f"{tuple(fb.shape)}")
    _check_wave(padded, win, hop, n_frames)
    if len({t.device for t in (padded, c, s, fb)}) != 1:
        raise ValueError("padded, c, s and fb must be on one device")


def _check_record(padded, ops, win, hop, n_frames, mode):
    if mode not in MODES:
        raise ValueError(f"unknown precision mode: {mode!r}")
    if ops.mode != mode:
        raise ValueError(f"operands prepared for mode {ops.mode!r} given to "
                         f"mode {mode!r}")
    if ops.win != win:
        raise ValueError(f"operands prepared for win={ops.win}, got {win}")
    _check_wave(padded, win, hop, n_frames)
    if ops.device != padded.device:
        raise ValueError("padded and the operands must be on one device")


def _check_tier(ops, tier, win, hop, n_mel):
    """Raise unless the operands (a record, or None for plain ``c, s, fb``)
    are those of the launch's tier: an FFT-tier record for the FFT tier,
    C/S for the others (``MelRoute.record`` makes the right one)."""
    if (tier == "fft") != (ops is not None and ops.fft):
        given = "an FFT-tier record" if tier != "fft" else "C/S operands"
        raise ValueError(
            f"{given} given to a {tier}-tier launch (win={win}, hop={hop}, "
            f"n_mel={n_mel}): MelRoute makes the record of its tier")


def _check_out(out, shape, device):
    if (out.dtype != torch.float32 or tuple(out.shape) != shape
            or not out.is_contiguous() or out.device != device):
        raise ValueError(
            f"out must be a contiguous float32 {shape} tensor on {device}, "
            f"got {out.dtype} {tuple(out.shape)} on {out.device}")


class _Plan(ctypes.Structure):
    """A launcher's choice (``msv::Plan`` in ``csrc/mel_common.cuh``)."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("tier", "mt", "stages", "chunk", "smem", "avail")]


def _launch(lib, mode, wave, ops, out, win, hop, n_frames, n_mel, stream):
    """Launch ``mode``'s kernel, the FFT tier's for an FFT-tier record, or
    its linear form for a ``LinearOperands`` record (``n_mel`` None);
    returns what its launcher chose, as the ``mel.launch`` (or
    ``linear.launch``) span's attributes.  Raises ValueError where no tier
    of the kernel fits the card's shared memory (nothing was launched), and
    RuntimeError where the launch failed."""
    plan = _Plan()
    head = (wave.data_ptr(), int(wave.dtype == torch.int16), wave.shape[1],
            wave.shape[1], wave.shape[0])
    linear = isinstance(ops, LinearOperands)
    kernel = "linear FFT" if linear else f"{mode} mel"
    if linear:
        err = getattr(lib, LINEAR_ENTRY_POINT)(
            *head, ops.window.data_ptr(), ops.twiddles.data_ptr(),
            out.data_ptr(), win, hop, n_frames, ops.n_fft,
            ops.twiddles.shape[0], stream, ctypes.byref(plan))
    elif ops.fft:
        err = getattr(lib, FFT_ENTRY_POINT)(
            *head, ops.window.data_ptr(), ops.twiddles.data_ptr(),
            ops.wts.data_ptr(), ops.bands.data_ptr(), ops.woff.data_ptr(),
            out.data_ptr(), win, hop, n_frames, ops.n_fft, n_mel,
            ops.twiddles.shape[0], stream, ctypes.byref(plan))
    else:
        err = getattr(lib, ENTRY_POINTS[mode])(
            *head, ops.slabs.data_ptr(), ops.tail.data_ptr(),
            ops.wts.data_ptr(), ops.bands.data_ptr(), ops.woff.data_ptr(),
            ops.tile_bands.data_ptr(), out.data_ptr(), win, hop, n_frames,
            ops.n_freq, n_mel, ops.n_tiles, ops.wts.shape[0], ops.ks,
            ops.nb, ops.row, stream, ctypes.byref(plan))
    if plan.tier == 0 and plan.smem > 0:
        raise ValueError(
            f"no tier of the {kernel} kernel fits win={win}, hop={hop}, "
            f"n_mel={n_mel}: a block needs {plan.smem} bytes of shared "
            f"memory, the card offers {plan.avail}")
    if err != 0:
        msg = lib.msv_cuda_error_string(err).decode()
        raise RuntimeError(f"the {kernel} kernel's launch failed: {msg}")
    return {"tier": TIERS[plan.tier - 1], "mt": plan.mt,
            "stages": plan.stages, "chunk": plan.chunk,
            "smem_bytes": plan.smem}


def mel_spectrogram_cuda(padded, *operands, win, hop, n_frames,
                         mode="parity", out=None, sr=None):
    """Fused mel dB spectrogram: ``(n_frames, n_mel)``, or
    ``(B, n_frames, n_mel)`` for a ``(B, L)`` batch, float32.

    Frame k is ``padded[..., k*hop : k*hop + win]``.  ``mode`` picks the
    kernel.  ``operands`` are one ``MelOperands`` record of that mode
    (``MelRoute.record``), or ``c, s, fb``, which are then prepared for
    this call: f32 (``operands_from_numpy``) for "parity", their bf16
    copies (``operands_bf16``) for "fast", their (hi, lo) stacks
    (``operands_split``) for "split".  ``out``, if
    given, is a contiguous float32 tensor of the result's shape that the
    kernel writes (a row range of a larger plane, for instance) and that is
    returned.

    The launch takes the tier of ``tier_for``, and raises ValueError where
    the operands are not that tier's (``MelRoute.record`` makes them): C/S
    (a record of slabs, or plain ``c, s, fb``) at an FFT-tier shape, an
    FFT-tier record at any other.

    Each call is one ``mel.launch`` program span (``utils.profiling``) with
    ``sr`` (the caller's rate, or None), ``batch``, ``win``, ``hop``,
    ``n_fft`` (2 * (n_freq - 1)), ``n_mel``, ``mode`` and what the launcher
    chose: ``tier``, ``mt``, ``stages``, ``chunk`` and ``smem_bytes`` (the
    CPU route: tier "plain", the rest 0; the FFT tier: ``mt`` 1, a frame a
    block, ``stages`` and ``chunk`` 0).  It ends when the launch returns,
    not when the kernel does.  Raises ValueError where no tier of the
    mode's kernel fits the card (the split kernel, which has no chunked
    tier, from 176.4 kHz on at the session's settings).
    """
    global LAUNCHES
    if len(operands) == 1 and isinstance(operands[0], MelOperands):
        ops = operands[0]
        _check_record(padded, ops, win, hop, n_frames, mode)
        c, s, fb = ops.c, ops.s, ops.fb
    elif len(operands) == 3:
        ops = None
        c, s, fb = operands
        _check(padded, c, s, fb, win, hop, n_frames, mode)
    else:
        raise TypeError("mel_spectrogram_cuda takes c, s, fb or one "
                        "MelOperands record after padded")
    n_freq, n_mel = fb.shape[-2:]
    shape = (n_frames, n_mel) if padded.ndim == 1 else (
        padded.shape[0], n_frames, n_mel)
    if out is not None:
        _check_out(out, shape, padded.device)
    batch = padded.shape[0] if padded.ndim == 2 else 1
    with span("mel.launch", sr=sr, batch=batch, win=win, hop=hop,
              n_fft=2 * (n_freq - 1), n_mel=n_mel, mode=mode) as sp:
        if padded.device.type == "cpu":
            if ops is not None:
                c, s, fb = ops.dft()
            db = mel_spectrogram_plain(padded, c, s, fb, win=win, hop=hop,
                                       n_frames=n_frames, mode=mode)
            sp.set(tier="plain", mt=0, stages=0, chunk=0, smem_bytes=0)
            check_nan(db, f"the {mode} mel kernel's plain version")
            return db if out is None else out.copy_(db)
        if padded.device.type != "cuda":
            raise ValueError(f"unsupported device: {padded.device}")
        given = {"padded": padded}
        if ops is None:
            given.update(c=c, s=s, fb=fb)
        for name, t in given.items():
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        lib = build()
        wave = padded if padded.ndim == 2 else padded.unsqueeze(0)
        if out is None:
            out = torch.empty(shape, dtype=torch.float32, device=wave.device)
        _check_tier(ops, tier_for(
            mode, win, hop, 2 * (n_freq - 1), n_mel,
            band_weights(fb) if ops is None else ops.wts.shape[0]),
            win, hop, n_mel)
        if ops is None:
            ops = prepare_operands(c, s, fb, mode)
        with torch.cuda.device(wave.device):
            stream = torch.cuda.current_stream(wave.device).cuda_stream
            plan = _launch(lib, mode, wave, ops, out, win, hop, n_frames,
                           n_mel, stream)
        sp.set(**plan)
    LAUNCHES += 1
    LAUNCHES_BY_MODE[mode] += 1
    LAUNCHES_BY_TIER[plan["tier"]] += 1
    check_nan(out, f"the {mode} mel kernel")
    return out


def _kept(store, what, make):
    """``store[what]``, made by ``make()`` at the first ask."""
    if what not in store:
        store[what] = make()
    return store[what]


class MelRoute:
    """The mel dB spectrogram of one analysis ``window`` (``win``
    samples), f32 filterbank ``fb`` (numpy or a tensor), ``hop`` and
    ``n_fft`` on ``device``, in either precision mode, and the operands it
    reads: the one place that decides how a launch runs, for the session,
    streaming and the log-mel frontend.

    ``route(padded, n_frames, mode=, out=None, sr=None)`` returns the dB
    plane and decides at each call:

    * under ``config.set_engine("xla")``: ``mel_spectrogram_plain`` on the
      mode's dense ``(C, S, fb)``, with no ``mel.launch`` span;
    * on the CPU: ``mel_spectrogram_cuda``'s CPU route on them (its span's
      tier "plain");
    * on a card: ``mel_spectrogram_cuda`` on the record of ``tier_for``'s
      tier, ``prepare_fft_operands``' at the FFT tier (no C or S is built),
      else ``prepare_operands``' of the dense operands.

    ``launch``, the kernel's entry, is ``mel_spectrogram_cuda`` unless the
    caller names its own binding of it (the session and streaming do, so
    that a wrapper set on their module sees their launches).

    Each form is built at its first use and kept as long as the route: one
    f32 ``(C, S, fb)`` for both modes, its bf16 copies, a record a mode.
    C and S are ``windowed_dft_matrices(window, n_fft)``, or what
    ``dense()``, a callable a caller gives, returns (numpy or tensors;
    ``window`` may then be None where no launch takes the FFT tier).  A
    window or C of another length than ``win`` raises ValueError.  ``key``,
    a hashable name of (window, fb) for a caller that makes them by a rule
    (the session: its rate), keeps the band weights and the FFT tier's
    host tables once a process."""

    # key -> {"n_wts": band_weights(fb), "fft": the FFT tier's record on
    # the host} of a named (window, fb)
    _TABLES: dict = {}

    def __init__(self, window, fb, *, win, hop, n_fft, device, dense=None,
                 key=None):
        if window is None and dense is None:
            raise ValueError("a MelRoute needs the analysis window or C and S")
        if window is not None and len(window) != win:
            raise ValueError(f"a window of {len(window)} samples for "
                             f"win={win}")
        self.window, self.fb, self.key = window, fb, key
        self.win, self.hop, self.n_fft = win, hop, n_fft
        self.device = torch.device(device)
        self._given = dense
        # "n_wts" and "fft" (where no key names the tables), "f32", "bf16"
        # and ("record", mode)
        self._forms = {}

    def _table(self, what, make):
        return _kept(self._forms if self.key is None
                     else MelRoute._TABLES.setdefault(self.key, {}),
                     what, make)

    def tier(self, mode) -> str:
        """The tier (``TIERS``) of this route's ``mode`` launches on a
        card."""
        n_wts = self._table("n_wts", lambda: band_weights(self.fb))
        return tier_for(mode, self.win, self.hop, self.n_fft,
                        self.fb.shape[-1], n_wts)

    def prepare(self, mode):
        """Build the f32 C, S and fb on the device now, where this route's
        ``mode`` calls read them: everywhere but on a card whose launches
        take the FFT tier."""
        if (get_engine() == "xla" or self.device.type != "cuda"
                or self.tier(mode) != "fft"):
            self._f32()

    def _f32(self):
        return _kept(self._forms, "f32", self._make_f32)

    def _make_f32(self):
        c, s = (self._given() if self._given is not None
                else windowed_dft_matrices(self.window, self.n_fft))
        if c.shape[-2] != self.win:
            raise ValueError(f"C and S of {c.shape[-2]} rows for "
                             f"win={self.win}")
        return operands_from_numpy(c, s, self.fb, self.device)

    def dense(self, mode="parity"):
        """The mode's ``(C, S, fb)`` on the device: f32, or their bf16
        copies (``operands_bf16``) in fast mode."""
        if mode != "fast":
            return self._f32()
        return _kept(self._forms, "bf16", lambda: operands_bf16(*self._f32()))

    def record(self, mode) -> MelOperands:
        """The ``MelOperands`` record a card's ``mode`` launch reads: of
        the FFT tier, made from the window and the filterbank (its tables
        moved to the device), or ``prepare_operands`` of ``dense(mode)``."""
        return _kept(self._forms, ("record", mode),
                     lambda: self._make_record(mode))

    def _make_record(self, mode):
        if self.tier(mode) != "fft":
            return prepare_operands(*self.dense(mode), mode)
        if self.window is None:
            raise ValueError(
                f"win={self.win}, hop={self.hop}, n_fft={self.n_fft} take the "
                f"FFT tier, whose record needs the analysis window")
        return self._table("fft", lambda: prepare_fft_operands(
            self.window, _as_f32(self.fb), self.n_fft)).to(self.device)

    def __call__(self, padded, n_frames, *, mode, out=None, sr=None,
                 launch=None):
        kw = dict(win=self.win, hop=self.hop, n_frames=n_frames, mode=mode)
        if get_engine() == "xla":
            db = mel_spectrogram_plain(padded, *self.dense(mode), **kw)
            return db if out is None else out.copy_(db)
        ops = ((self.record(mode),) if self.device.type == "cuda"
               else self.dense(mode))
        return (launch or mel_spectrogram_cuda)(padded, *ops, out=out, sr=sr,
                                                **kw)


@dataclasses.dataclass(frozen=True, eq=False)
class LinearOperands:
    """The linear FFT tier's record (``prepare_linear_fft_operands``): what
    its kernel reads, on one device, and no C, S or filterbank."""

    window: torch.Tensor  # (win,) f32
    twiddles: torch.Tensor  # fft_twiddles(n_fft): (n_tw, 2) f32
    n_fft: int

    @property
    def win(self):
        return self.window.shape[0]

    @property
    def device(self):
        return self.window.device


def prepare_linear_fft_operands(window, n_fft, device):
    """The linear FFT tier's record on ``device``: the analysis window
    ``(win,)`` in f32 and the twiddle table ``fft_twiddles(n_fft)``.  The
    kernel windows each frame, zero-pads it to n_fft at the left offset
    (n_fft - win) // 2 and takes its FFT, the function of
    ``windowed_dft_matrices(window, n_fft)``'s pair."""
    return LinearOperands(_fft_window(window, n_fft).to(device),
                          torch.from_numpy(fft_twiddles(n_fft)).to(device),
                          n_fft)


def linear_spectrogram_cuda(padded, ops, *, win, hop, n_frames, out=None,
                            sr=None):
    """The linear-scale dB spectrogram by the FFT tier's linear form, on a
    card: ``(n_frames, n_fft // 2 + 1)``, or ``(B, n_frames, n_fft // 2 +
    1)`` for a ``(B, L)`` batch, float32.

    Frame k is ``padded[..., k*hop : k*hop + win]`` (f32, or int16 scaled by
    2^-15 as it is loaded) times the window of ``ops`` (a
    ``LinearOperands`` record), zero-padded to n_fft; each bin is its real
    FFT's magnitude in dB as every kernel of this module writes it, 20
    ln|X| / ln 10 with the -360 dB floor.  ``out``, if given, is a
    contiguous float32 tensor of the result's shape that the kernel writes.
    Each call is one ``linear.launch`` program span with ``sr``, ``batch``,
    ``win``, ``hop``, ``n_fft``, ``n_out``, ``tier`` "fft" and
    ``smem_bytes``; it ends when the launch returns.  Tensors off a card
    raise ValueError: the CPU takes ``LinearRoute``'s dense pair."""
    if not isinstance(ops, LinearOperands):
        raise TypeError("linear_spectrogram_cuda takes a LinearOperands "
                        "record (LinearRoute.record)")
    if ops.win != win:
        raise ValueError(f"operands prepared for win={ops.win}, got {win}")
    _check_wave(padded, win, hop, n_frames)
    if padded.device.type != "cuda" or ops.device != padded.device:
        raise ValueError("the linear FFT tier runs on a card, with padded "
                         "and the operands on one device")
    if not padded.is_contiguous():
        raise ValueError("padded must be contiguous")
    n_out = ops.n_fft // 2 + 1
    shape = (n_frames, n_out) if padded.ndim == 1 else (
        padded.shape[0], n_frames, n_out)
    if out is not None:
        _check_out(out, shape, padded.device)
    wave = padded if padded.ndim == 2 else padded.unsqueeze(0)
    with span("linear.launch", sr=sr, batch=wave.shape[0], win=win, hop=hop,
              n_fft=ops.n_fft, n_out=n_out, tier="fft") as sp:
        lib = build()
        if out is None:
            out = torch.empty(shape, dtype=torch.float32, device=wave.device)
        with torch.cuda.device(wave.device):
            stream = torch.cuda.current_stream(wave.device).cuda_stream
            plan = _launch(lib, "parity", wave, ops, out, win, hop, n_frames,
                           None, stream)
        sp.set(smem_bytes=plan["smem_bytes"])
    LINEAR_LAUNCHES_BY_TIER["fft"] += 1
    check_nan(out, "the linear FFT kernel")
    return out


class LinearRoute:
    """The linear-scale dB spectrogram (n_fft // 2 + 1 bins a frame) of one
    analysis ``window`` (``win`` samples), ``hop`` and ``n_fft`` on
    ``device``, in either precision mode, and the operands it reads: the one
    place that decides how the linear scale runs, for the session and
    streaming, as ``MelRoute`` is for the mel scale.

    ``route(padded, n_frames, n_valid, mode=, out=None, sr=None,
    pipeline=None)`` returns ``(db, smin, smax)``: the dB plane of a
    ``(B, L)`` batch (or an ``(L,)`` wave) and the min/max over each row's
    first ``n_valid`` frames.  It decides at each call, by ``tier_here``:

    * "fft", on a card where ``tier_for(mode, ..., n_mel=None)`` is "fft"
      (parity, an n_fft with an FFT plan) and the engine is not "xla":
      ``linear_spectrogram_cuda`` on the record (``LinearOperands``: the
      window and the twiddles; no C or S is built), then
      ``pipeline.masked_minmax``;
    * else the dense windowed-DFT pair: ``pipeline`` (by default
      ``spec_pipeline_batched``; the session names its own binding of it)
      on the route's f32 C and S, true f32 in parity and TF32 in fast, as
      one ``linear.launch`` span of tier "gemm" on a card and "plain" on
      the CPU (``smem_bytes`` 0).  On the FFT tier the dB is the kernels'
      20 ln / ln 10, on the pair ``ops.decibel.amp_to_db``'s 20 log10: the
      planes differ by rounding.

    ``LINEAR_LAUNCHES_BY_TIER`` counts the card's calls.  C and S are
    ``windowed_dft_matrices(window, n_fft)``, or what ``dense()``, a
    callable a caller gives, returns; each form is built at its first use
    and kept as long as the route."""

    def __init__(self, window, *, win, hop, n_fft, device, dense=None):
        if window is None and dense is None:
            raise ValueError("a LinearRoute needs the analysis window or C "
                             "and S")
        if window is not None and len(window) != win:
            raise ValueError(f"a window of {len(window)} samples for "
                             f"win={win}")
        self.window = window
        self.win, self.hop, self.n_fft = win, hop, n_fft
        self.device = torch.device(device)
        self._given = dense
        self._forms = {}  # "f32" (C, S) and "record"

    @property
    def n_out(self):
        return self.n_fft // 2 + 1

    def tier(self, mode) -> str:
        """The tier (``LINEAR_TIERS``) of this route's ``mode`` calls on a
        card."""
        return tier_for(mode, self.win, self.hop, self.n_fft, None)

    def tier_here(self, mode) -> str:
        """The tier of a ``mode`` call on this route's device: "plain" on
        the CPU, "gemm" under the "xla" engine, else ``tier(mode)``."""
        if self.device.type != "cuda":
            return "plain"
        return "gemm" if get_engine() == "xla" else self.tier(mode)

    def prepare(self, mode):
        """Build the f32 C and S on the device now, where this route's
        ``mode`` calls read them: everywhere but at the FFT tier."""
        if self.tier_here(mode) != "fft":
            self.dense()

    def dense(self):
        """The f32 ``(C, S)`` on the device."""
        return _kept(self._forms, "f32", self._make_f32)

    def _make_f32(self):
        c, s = (self._given() if self._given is not None
                else windowed_dft_matrices(self.window, self.n_fft))
        if c.shape[-2] != self.win:
            raise ValueError(f"C and S of {c.shape[-2]} rows for "
                             f"win={self.win}")
        return operands_from_numpy(c, s, None, self.device)[:2]

    def record(self) -> LinearOperands:
        """The FFT tier's record on the device, made from the window."""
        if self.window is None:
            raise ValueError(
                f"win={self.win}, hop={self.hop}, n_fft={self.n_fft} take the "
                f"linear FFT tier, whose record needs the analysis window")
        return _kept(self._forms, "record", lambda: prepare_linear_fft_operands(
            self.window, self.n_fft, self.device))

    def __call__(self, padded, n_frames, n_valid, *, mode, out=None, sr=None,
                 pipeline=None):
        tier = self.tier_here(mode)
        kw = dict(win=self.win, hop=self.hop, n_frames=n_frames)
        if tier == "fft":
            db = linear_spectrogram_cuda(padded, self.record(), out=out,
                                         sr=sr, **kw)
            return (db, *masked_minmax(db, n_valid))
        rows = padded if padded.ndim == 2 else padded.unsqueeze(0)
        with span("linear.launch", sr=sr, batch=rows.shape[0], win=self.win,
                  hop=self.hop, n_fft=self.n_fft, n_out=self.n_out, tier=tier,
                  smem_bytes=0):
            db, smin, smax = (pipeline or spec_pipeline_batched)(
                rows, *self.dense(), None, n_valid, use_mel=False, mode=mode,
                **kw)
        if tier == "gemm":
            LINEAR_LAUNCHES_BY_TIER["gemm"] += 1
        if padded.ndim == 1:
            db, smin, smax = db[0], smin[0], smax[0]
        return (db if out is None else out.copy_(db)), smin, smax
