"""ctypes bridge to the port's native C++ WAV and FLAC decoders.

``msv_tpu_torch/native/wav_decoder.cc`` and ``flac_decoder.cc`` are
byte-for-byte copies of msv_tpu's decoders.  They are compiled with the C++
compiler (``$CXX``, else ``g++``, with msv_tpu's Makefile flags) at first
use into ``build/msv_tpu_torch/`` beside the package, keyed on the hash of
the sources, as the CUDA kernels are.  Where no compiler is found, or the
build fails, callers fall back to the numpy parser — identical output
either way (parity-tested) — and FLAC is unavailable, as in msv_tpu
without its library.

``LIBRARY`` is the loaded library's path (None before the first decode, or
without one); ``DECODES`` counts the files each decoder read: "native"
(this library) and "numpy" (the WAV fallback after the native decoder was
unavailable or refused a file).  The numpy parser that
``io/audio.py`` picks by design for mono PCM16 is not counted.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = [os.path.join(_PKG_DIR, "native", name)
           for name in ("wav_decoder.cc", "flac_decoder.cc")]
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "msv_tpu_torch")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-ffp-contract=off",
             "-shared"]

LIBRARY = None
DECODES = {"native": 0, "numpy": 0}
# why the library is absent (no compiler, a failed build), for messages
BUILD_ERROR = ""

_LIB = None
_TRIED = False
_LOAD_LOCK = threading.Lock()


def _load():
    """Thread-safe lazy build + load (double-checked: ``_TRIED`` publishes
    only AFTER ``_LIB`` — concurrent decoder threads must never observe
    the latch without the handle)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOAD_LOCK:
        if not _TRIED:
            _LIB = _load_impl()
            _TRIED = True
    return _LIB


def _build() -> str | None:
    """The library's path, compiled once per hash of the sources; None
    without a compiler or when the build fails."""
    global BUILD_ERROR
    h = hashlib.sha256()
    for path in SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libmsv_native_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if cxx is None:
        BUILD_ERROR = "no C++ compiler (set CXX or install g++)"
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *SOURCES],
                       capture_output=True, text=True)
    if r.returncode != 0:
        BUILD_ERROR = f"{cxx} failed ({r.returncode}): {r.stderr[-2000:]}"
        return None
    os.replace(tmp, so)
    return so


def _load_impl():
    global LIBRARY, BUILD_ERROR
    try:
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
    except OSError as e:
        BUILD_ERROR = str(e)
        return None
    lib.msv_wav_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),  # n_samples (per channel)
        ctypes.POINTER(ctypes.c_int32),  # n_channels
        ctypes.POINTER(ctypes.c_int32),  # sample rate
    ]
    lib.msv_wav_decode.restype = ctypes.c_int32
    lib.msv_flac_decode.argtypes = lib.msv_wav_decode.argtypes
    lib.msv_flac_decode.restype = ctypes.c_int32
    lib.msv_flac_decode_ex.argtypes = lib.msv_wav_decode.argtypes + [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.msv_flac_decode_ex.restype = ctypes.c_int32
    # std::free of any buffer the decoders return
    lib.msv_free.argtypes = [ctypes.c_void_p]
    lib.msv_free.restype = None
    LIBRARY = so
    return lib


def _call_decoder(fn, path: str):
    buf = ctypes.POINTER(ctypes.c_float)()
    n_samples = ctypes.c_int64()
    n_ch = ctypes.c_int32()
    sr = ctypes.c_int32()
    rc = fn(
        path.encode(),
        ctypes.byref(buf),
        ctypes.byref(n_samples),
        ctypes.byref(n_ch),
        ctypes.byref(sr),
    )
    if rc != 0:
        return rc, None
    try:
        # native layout: channel-major (n_ch, n_samples), ready to use
        arr = np.ctypeslib.as_array(buf, shape=(n_ch.value, n_samples.value)).copy()
    finally:
        _LIB.msv_free(buf)
    return 0, (arr, sr.value)


def try_decode(path: str):
    """Returns (wav (n_ch, n_samples) f32, sr), or None if unavailable: the
    caller then parses the WAV with numpy (counted in ``DECODES``)."""
    lib = _load()
    rc, out = (1, None) if lib is None else _call_decoder(
        lib.msv_wav_decode, path)
    # the numpy parser produces the detailed errors
    DECODES["native" if rc == 0 else "numpy"] += 1
    return out


_FLAC_ERRORS = {
    1: "io error",
    2: "not a FLAC stream",
    3: "bad metadata",
    4: "bad frame",
    5: "frame header CRC mismatch",
    6: "bad subframe",
    7: "frame CRC mismatch",
    8: "truncated stream",
    9: "out of memory",
}


def flac_available() -> bool:
    return _load() is not None


def _flac_lib(path: str):
    from ..utils.errors import AudioReadError

    lib = _load()
    if lib is None:
        raise AudioReadError(
            f"{path}: FLAC decoding unavailable (the native decoder did not "
            f"build: {BUILD_ERROR})"
        )
    return lib


def decode_flac(path: str):
    """FLAC -> (wav (n_ch, n_samples) f32, sr).  Raises on failure."""
    from ..utils.errors import AudioReadError

    rc, out = _call_decoder(_flac_lib(path).msv_flac_decode, path)
    if rc != 0:
        raise AudioReadError(
            f"{path}: FLAC decode failed ({_FLAC_ERRORS.get(rc, rc)})"
        )
    DECODES["native"] += 1
    return out


def decode_flac_ex(path: str):
    """FLAC -> (wav f32 (n_ch, n), sr, raw_int32 (n_ch, n) | None, bps).

    ``raw_int32`` carries the decoder's exact integer samples (units of
    2^-(bps-1)) when the stream has one uniform bit depth — the session's
    integer-domain wire path consumes these instead of f32."""
    from ..utils.errors import AudioReadError

    lib = _flac_lib(path)
    buf = ctypes.POINTER(ctypes.c_float)()
    n_samples = ctypes.c_int64()
    n_ch = ctypes.c_int32()
    sr = ctypes.c_int32()
    ibuf = ctypes.POINTER(ctypes.c_int32)()
    bps = ctypes.c_int32()
    rc = lib.msv_flac_decode_ex(
        path.encode(), ctypes.byref(buf), ctypes.byref(n_samples),
        ctypes.byref(n_ch), ctypes.byref(sr), ctypes.byref(ibuf),
        ctypes.byref(bps),
    )
    if rc != 0:
        raise AudioReadError(
            f"{path}: FLAC decode failed ({_FLAC_ERRORS.get(rc, rc)})"
        )
    try:
        wav = np.ctypeslib.as_array(
            buf, shape=(n_ch.value, n_samples.value)
        ).copy()
        raw = None
        if bps.value > 0 and ibuf:
            raw = np.ctypeslib.as_array(
                ibuf, shape=(n_ch.value, n_samples.value)
            ).copy()
    finally:
        lib.msv_free(buf)
        if ibuf:
            lib.msv_free(ibuf)
    DECODES["native"] += 1
    return wav, sr.value, raw, bps.value
