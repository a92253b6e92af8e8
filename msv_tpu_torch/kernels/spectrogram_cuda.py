"""The fused mel dB spectrogram kernels: CUDA C++ for Hopper, bound with ctypes.

Replace ``msv_tpu/kernels/spectrogram_pallas.py::mel_spectrogram_pallas``
in two of its modes:

* ``mode="parity"``: f32 operands, both schedules
  (``msv_tpu_torch/csrc/mel_spectrogram.cu``, SIMT f32 FMA);
* ``mode="fast"``: bf16 operands with f32 accumulation
  (``msv_tpu_torch/csrc/mel_spectrogram_bf16.cu``, tensor-core
  ``mma.sync``).

Each source's header says what bounds it on an H100 and how its design
answers that; both include ``csrc/mel_common.cuh``, their shared mel band
accumulation and dB epilogue.  They are built with ``nvcc`` at first use
into one library under ``build/msv_tpu_torch/`` beside the package, keyed
on the hash of both sources and the header, and loaded as a plain C
library.

Unlike the TPU kernel, no layout is prepared on the host: a kernel takes the
reflect-padded 1-D wave ``(L,)`` or ``(B, L)`` (f32, or int16 scaled by
2^-15 as it is loaded), ``C``/``S`` as ``(win, n_freq)`` and ``fb`` as
``(n_freq, n_mel)`` (f32 for parity, bf16 from ``operands_bf16`` for fast),
and masks ragged edges itself.

``mel_spectrogram_plain`` is the same function in torch ops, in either
mode.  The wrapper ``mel_spectrogram_cuda`` takes it only for tensors on the
CPU; for CUDA tensors it launches the mode's kernel or raises.
"""

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from ..ops.stft import frame_device

_AMIN = 1e-18
_DB_SCALE = 20.0 / math.log(10.0)
_DB_FLOOR = 20.0 * math.log10(_AMIN)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {
    "parity": os.path.join(_PKG_DIR, "csrc", "mel_spectrogram.cu"),
    "fast": os.path.join(_PKG_DIR, "csrc", "mel_spectrogram_bf16.cu"),
}
# Device code both sources include (band accumulation, dB epilogue).
HEADER = os.path.join(_PKG_DIR, "csrc", "mel_common.cuh")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "msv_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

MODES = ("parity", "fast")
# Kernel launches made by mel_spectrogram_cuda (the CPU route does not
# count): the total, and by precision mode (the kernel it launched).
LAUNCHES = 0
LAUNCHES_BY_MODE = {"parity": 0, "fast": 0}
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
    """Compile (once per hash of both sources and their header) and load
    the kernel library."""
    global _LIB, BUILD_REPORT
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        h = hashlib.sha256()
        for path in (*(SOURCES[m] for m in MODES), HEADER):
            with open(path, "rb") as f:
                h.update(f.read())
        tag = h.hexdigest()[:16]
        so = os.path.join(BUILD_DIR, f"libmsv_mel_{tag}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   *(SOURCES[m] for m in MODES)]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                    f"{r.stdout}{r.stderr}"
                )
            BUILD_REPORT = r.stdout + r.stderr
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.msv_mel_spectrogram.argtypes = [
            p, i, ll, ll, i, p, p, p, p, p, i, i, i, i, i, p,
        ]
        lib.msv_mel_spectrogram.restype = ctypes.c_int
        lib.msv_mel_spectrogram_bf16.argtypes = lib.msv_mel_spectrogram.argtypes
        lib.msv_mel_spectrogram_bf16.restype = ctypes.c_int
        lib.msv_cuda_error_string.argtypes = [ctypes.c_int]
        lib.msv_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def operands_from_numpy(c, s, fb, device="cpu"):
    """(C, S, fb) as contiguous f32 tensors on ``device``, from the host
    builders' ``(win, n_freq)``, ``(win, n_freq)`` and ``(n_freq, n_mel)``
    arrays (``ops.dft.windowed_dft_matrices``, ``ops.mel``)."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
        for a in (c, s, fb)
    )


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
    multiplies only these bins; the skipped products are exact zeros."""
    nz = fb != 0
    has = nz.any(dim=0)
    lo = nz.to(torch.uint8).argmax(dim=0)
    hi = fb.shape[0] - nz.flip(0).to(torch.uint8).argmax(dim=0)
    zero = torch.zeros_like(lo)
    return torch.stack([torch.where(has, lo, zero), torch.where(has, hi, zero)],
                       dim=1).to(torch.int32).contiguous()


def operands_bf16(c, s, fb):
    """The fast mode's device operands: bf16 copies of the f32 ``(C, S,
    fb)``, rounded to nearest even, on the same device and in the same
    layouts.  Made once per rate and cached by the caller."""
    return tuple(t.to(torch.bfloat16).contiguous() for t in (c, s, fb))


def round_bf16(x):
    """``x`` rounded to bf16 (nearest even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def mel_spectrogram_plain(padded, c, s, fb, *, win, hop, n_frames,
                          mode="parity"):
    """The kernels' function in torch ops: frames -> DFT GEMM pair ->
    magnitude -> mel GEMM -> dB (natural log, as the kernels compute it).

    ``mode="fast"`` is f32 arithmetic on bf16-rounded values: the frames,
    C, S, the magnitude and fb are rounded to bf16 (nearest even) and back.
    A product of two bf16 values is exact in f32, so this is "bf16
    operands, f32 accumulation" as the fast kernel computes it, and it runs
    on any device.  The operands may be f32 or already bf16.
    """
    x = padded
    if x.dtype == torch.int16:
        x = x.to(torch.float32) * 2.0**-15
    frames = frame_device(x, win, hop, n_frames)
    c, s, fb = (t.to(torch.float32) for t in (c, s, fb))
    if mode == "fast":
        frames, c, s, fb = (round_bf16(t) for t in (frames, c, s, fb))
    re = frames @ c
    im = frames @ s
    mag = torch.sqrt(re * re + im * im)
    if mode == "fast":
        mag = round_bf16(mag)
    mel = mag @ fb
    return torch.where(mel > _AMIN, torch.log(mel) * _DB_SCALE, _DB_FLOOR)


_OPERAND_DTYPE = {"parity": torch.float32, "fast": torch.bfloat16}


def _check(padded, c, s, fb, win, hop, n_frames, mode):
    if mode not in MODES:
        raise ValueError(f"unknown precision mode: {mode!r}")
    if padded.ndim not in (1, 2):
        raise ValueError("padded must be (L,) or (B, L)")
    if padded.dtype not in (torch.float32, torch.int16):
        raise ValueError(f"padded must be float32 or int16, got {padded.dtype}")
    want = _OPERAND_DTYPE[mode]
    for name, t in (("c", c), ("s", s), ("fb", fb)):
        if t.dtype != want or t.ndim != 2:
            raise ValueError(
                f"{name} must be a 2-D {want} tensor in mode {mode!r}"
                + (" (make them with operands_bf16)" if mode == "fast" else ""))
    n_freq = c.shape[1]
    if c.shape != (win, n_freq) or s.shape != (win, n_freq):
        raise ValueError(f"c and s must be (win={win}, n_freq), got "
                         f"{tuple(c.shape)} and {tuple(s.shape)}")
    if fb.shape[0] != n_freq:
        raise ValueError(f"fb must be (n_freq={n_freq}, n_mel), got "
                         f"{tuple(fb.shape)}")
    if win < 1 or hop < 1 or n_frames < 1:
        raise ValueError("win, hop and n_frames must be >= 1")
    need = (n_frames - 1) * hop + win
    if padded.shape[-1] < need:
        raise ValueError(f"padded has {padded.shape[-1]} samples, "
                         f"{n_frames} frames need {need}")
    if len({t.device for t in (padded, c, s, fb)}) != 1:
        raise ValueError("padded, c, s and fb must be on one device")


def _check_out(out, shape, device):
    if (out.dtype != torch.float32 or tuple(out.shape) != shape
            or not out.is_contiguous() or out.device != device):
        raise ValueError(
            f"out must be a contiguous float32 {shape} tensor on {device}, "
            f"got {out.dtype} {tuple(out.shape)} on {out.device}")


def mel_spectrogram_cuda(padded, c, s, fb, *, win, hop, n_frames,
                         mode="parity", out=None):
    """Fused mel dB spectrogram: ``(n_frames, n_mel)``, or
    ``(B, n_frames, n_mel)`` for a ``(B, L)`` batch, float32.

    Frame k is ``padded[..., k*hop : k*hop + win]``.  ``mode`` picks the
    kernel: "parity" takes f32 ``c``/``s``/``fb`` (``operands_from_numpy``),
    "fast" their bf16 copies (``operands_bf16``).  ``out``, if given, is a
    contiguous float32 tensor of the result's shape that the kernel writes
    (a row range of a larger plane, for instance) and that is returned.
    """
    global LAUNCHES
    _check(padded, c, s, fb, win, hop, n_frames, mode)
    n_freq, n_mel = fb.shape
    shape = (n_frames, n_mel) if padded.ndim == 1 else (
        padded.shape[0], n_frames, n_mel)
    if out is not None:
        _check_out(out, shape, padded.device)
    if padded.device.type == "cpu":
        db = mel_spectrogram_plain(padded, c, s, fb, win=win, hop=hop,
                                   n_frames=n_frames, mode=mode)
        return db if out is None else out.copy_(db)
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device: {padded.device}")
    for name, t in (("padded", padded), ("c", c), ("s", s), ("fb", fb)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = build()
    wave = padded if padded.ndim == 2 else padded.unsqueeze(0)
    batch, length = wave.shape
    bands = mel_bands(fb)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=wave.device)
    fn = (lib.msv_mel_spectrogram if mode == "parity"
          else lib.msv_mel_spectrogram_bf16)
    with torch.cuda.device(wave.device):
        stream = torch.cuda.current_stream(wave.device).cuda_stream
        err = fn(
            wave.data_ptr(), int(wave.dtype == torch.int16), length, length,
            batch, c.data_ptr(), s.data_ptr(), fb.data_ptr(),
            bands.data_ptr(), out.data_ptr(),
            win, hop, n_frames, n_freq, n_mel, stream,
        )
    if err != 0:
        msg = lib.msv_cuda_error_string(err).decode()
        raise RuntimeError(f"mel_spectrogram kernel ({mode}) launch failed: "
                           f"{msg}")
    LAUNCHES += 1
    LAUNCHES_BY_MODE[mode] += 1
    return out
