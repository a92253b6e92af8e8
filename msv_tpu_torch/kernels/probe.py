"""What bounds the three mel kernels on the card: source variants of each,
built and timed beside the sources as they are.

Run from the repository root on a machine with a CUDA card and nvcc::

    python -m msv_tpu_torch.kernels.probe [--seconds 240] [--reps 5]
        [--modes parity fast split] [--variants base no_ring ...]

Each variant is a copy of ``csrc/`` with one textual change, built with
``nvcc`` (the package's flags) into ``build/msv_tpu_torch/probe/<variant>/``
and loaded on its own.  The kernels are called with the same prepared
operands on 240 s of noise at 48 and 8 kHz, B = 1, f32 input, and timed by
CUDA events (median of ``reps`` after a warm-up).  ``base``, ``no_fence``,
``int_split``, ``mma_sync``, ``no_fadd`` and ``chunked`` compute the right
numbers (their largest distance from the plain version is printed); the
others exist for their times:

* ``base``: the sources as they are;
* ``no_fence``: no ``fence.proxy.async`` before each bulk copy;
* ``no_ring``: no copy and no wait, every slab read from stage 0 as it
  lies: the products alone;
* ``no_mma``: no ``mma`` or ``wgmma`` (the compiler then drops the loads
  and splits that feed them): staging, ring, barriers and the mel pass
  alone;
* ``bare``: neither ring nor products: sample staging, the leftover bin and
  the mel pass alone;
* ``int_split`` (parity): tf32 rounding by integer add and mask instead of
  ``cvt.rna.tf32.f32`` (the same values for finite inputs);
* ``no_split`` (parity): no split at all, each value passed as its own hi
  and lo;
* ``one_pass`` (parity, split): only the hi*hi products, a third of them;
* ``mma_sync`` (split): the products by ``mma.sync.m16n8k16`` instead of
  ``wgmma`` (``MSV_SPLIT_WGMMA=0``), everything else the same;
* ``no_fadd`` (split): each tile's products accumulated in the tensor
  cores over the whole window instead of per-slab sums added by FADD;
* ``chunked`` (parity, fast): every launch in the chunked tier, where the
  launcher would take the resident one first;
* ``bare_no_bands``, ``bare_no_stage``, ``bare_no_store``,
  ``bare_no_log``: ``bare`` without the mel pass, without the sample
  staging, without the mel pass's stores, or with them but without the dB.

A variant that does not touch a mode's sources is not timed for that mode.
With ``--sass`` it also prints the opcode counts of each kernel's f32,
four-m-tile instantiation in ``base`` (``cuobjdump -sass``).

``--fft`` times variants of the parity mode's FFT tier instead
(``csrc/mel_spectrogram_fft.cu``, ``FFT_VARIANTS``) at ``--rates`` (default
the survey's 384, 250 and 192 kHz), each against the plain version:

* ``base``: the source as it is;
* ``minb2``: n_fft 16 384 (M = 8192) at two blocks an SM
  (``__launch_bounds__(256, 2)``: 128 registers a thread, none spilled)
  instead of three;
* ``r32_16_16``: n_fft 16 384's passes in the order 32, 16, 16;
* ``bands8``: the mel pass eight bands a warp at a time instead of four;
* ``no_mel``: without the mel pass and the dB (the FFT and the magnitudes
  alone; its output is not the function).

The launches do not go through ``mel_spectrogram_cuda`` and are not counted
in ``LAUNCHES``.  Prints one line per (variant, mode, rate), then a JSON
object of the times.
"""

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess

import numpy as np
import torch

from . import spectrogram_cuda as K

PROBE_DIR = os.path.join(K.BUILD_DIR, "probe")
_CSRC = os.path.dirname(K.HEADER)
# variant -> [(file, text, replacement)]
_FENCE = '  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
VARIANTS = {
    "base": [],
    "no_fence": [("mel_common.cuh", _FENCE, "")],
    "no_ring": [
        ("mel_common.cuh", "    if (lane != 0) return;\n", "    return;\n"),
        ("mel_common.cuh",
         "    __syncthreads();\n    if (tid == 0 && c.q + stages < total) "
         "issue(c.q + stages, c.s);\n", ""),
        ("mel_common.cuh",
         "    mbar_wait(full + c.s, c.phase);\n", ""),
        ("mel_common.cuh",
         "    for (int q = 0; q < min(stages, total); ++q) issue(q, q);\n", ""),
    ],
    "no_mma": [
        ("mel_spectrogram.cu", "                                         "
         "const uint32_t (&b)[2]) {\n",
         "                                         "
         "const uint32_t (&b)[2]) {\n  return;\n"),
        ("mel_common.cuh", "uint32_t b0, uint32_t b1) {\n",
         "uint32_t b0, uint32_t b1) {\n  return;\n"),
        ("mel_spectrogram_split.cu", "uint64_t desc, int keep) {\n",
         "uint64_t desc, int keep) {\n  return;\n"),
    ],
}
_CVT = ('  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));\n'
        '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(x - '
        '__uint_as_float(hi)));\n')
VARIANTS["bare"] = VARIANTS["no_ring"] + VARIANTS["no_mma"]
VARIANTS["int_split"] = [("mel_spectrogram.cu", _CVT, (
    "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
    "  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & "
    "0xffffe000u;\n"))]
VARIANTS["no_split"] = [("mel_spectrogram.cu", _CVT,
                         "  hi = lo = __float_as_uint(x);\n")]
VARIANTS["one_pass"] = [
    ("mel_spectrogram.cu",
     "        mma_tf32(part[m][mt][nt], al, bh[m][nt]);\n"
     "        mma_tf32(part[m][mt][nt], ah, bl[m][nt]);\n", ""),
    ("mel_spectrogram_split.cu",
     "  wgmma_m64n128k16(d, ah, b_desc(b_lo), keep);\n"
     "  wgmma_m64n128k16(d, al, b_desc(b_hi), 1);\n", "")]
VARIANTS["mma_sync"] = [("mel_spectrogram_split.cu",
                         "#define MSV_SPLIT_WGMMA 1", "#define MSV_SPLIT_WGMMA 0")]
VARIANTS["no_fadd"] = [("mel_spectrogram_split.cu",
                        "constexpr bool kStageFadd = true;",
                        "constexpr bool kStageFadd = false;")]
_RESIDENT = ("  MSV_LAUNCH(4, 0, fixed_bytes(4, win, hop, n_mel, ops.n_wts))\n"
             "  MSV_LAUNCH(2, 0, fixed_bytes(2, win, hop, n_mel, ops.n_wts))\n"
             "  MSV_LAUNCH(1, 0, fixed_bytes(1, win, hop, n_mel, ops.n_wts))\n")
VARIANTS["chunked"] = [(f, _RESIDENT, "") for f in ("mel_spectrogram.cu",
                                                    "mel_spectrogram_bf16.cu")]
# the variants whose output is the kernel's function
RIGHT = ("base", "no_fence", "int_split", "mma_sync", "no_fadd", "chunked")
_BANDS = "  const int k1 = k0 + kt;\n"
VARIANTS["bare_no_bands"] = VARIANTS["bare"] + [
    ("mel_common.cuh", _BANDS, _BANDS + "  return;\n")]
_STORE = ("      *dst = hi > k1 ? v : (v > kAmin ? logf(v) * kDbScale : "
          "kDbFloor);\n")
VARIANTS["bare_no_store"] = VARIANTS["bare"] + [
    ("mel_common.cuh", _STORE, "      if (v == -1.5f) " + _STORE.lstrip())]
VARIANTS["bare_no_log"] = VARIANTS["bare"] + [
    ("mel_common.cuh", _STORE, "      *dst = v;\n")]
VARIANTS["bare_no_stage"] = VARIANTS["bare"] + [
    ("mel_spectrogram.cu", "  for (int r = warp; r < rows; r += WARPS) {",
     "  for (int r = warp; r < 0; r += WARPS) {"),
    *((f, "  for (int r = warp; r < rows && warp < WARPS; r += WARPS) {",
       "  for (int r = warp; r < 0; r += WARPS) {")
      for f in ("mel_spectrogram_bf16.cu", "mel_spectrogram_split.cu"))]

_SOURCES = {m: os.path.basename(K.SOURCES[m]) for m in K.MODES}
_FFT_SOURCE = os.path.basename(K.FFT_SOURCE)
_PLAN_8192 = ("  static constexpr int T = 256, R0 = 16, R1 = 16, R2 = 32, "
              "MINB = 3;\n")
# variant -> ([(text, replacement)] in the FFT source, {n_fft: radices})
FFT_VARIANTS = {
    "base": ([], {}),
    "minb2": ([(_PLAN_8192, _PLAN_8192.replace("MINB = 3", "MINB = 2"))],
              {}),
    "r32_16_16": ([(_PLAN_8192, _PLAN_8192.replace(
        "R0 = 16, R1 = 16, R2 = 32", "R0 = 32, R1 = 16, R2 = 16"))],
        {16384: (32, 16, 16)}),
    "bands8": ([("constexpr int kBandsAtOnce = 4;",
                 "constexpr int kBandsAtOnce = 8;")], {}),
    "no_mel": ([("  msv::mel_frame<TH / 32, kBandsAtOnce>(",
                 "  if (n_mel < 0) msv::mel_frame<TH / 32, kBandsAtOnce>(")],
               {}),
}


def touches(name, mode):
    """Whether variant ``name`` changes what mode ``mode`` is built from."""
    return name == "base" or any(
        f in (_SOURCES[mode], "mel_common.cuh") for f, _, _ in VARIANTS[name])


def sass_opcodes(obj, kernel):
    """Opcode counts of the first function in ``obj`` whose name holds
    ``kernel`` (``cuobjdump -sass``)."""
    import collections
    import re

    cuobjdump = os.path.join(os.path.dirname(K._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
    counts, inside = collections.Counter(), False
    for ln in text.splitlines():
        if "Function :" in ln:
            if inside:
                break
            inside = kernel in ln
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                         ln)
            if m:
                counts[m.group(1)] += 1
    return counts


def _variant_dir(name):
    d = os.path.join(PROBE_DIR, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for f in (*_SOURCES.values(), "mel_common.cuh"):
        shutil.copy(os.path.join(_CSRC, f), d)
    for f, old, new in VARIANTS[name]:
        path = os.path.join(d, f)
        with open(path) as fh:
            text = fh.read()
        if old not in text:
            raise RuntimeError(f"variant {name}: {f} no longer holds "
                               f"{old!r}")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    return d


def build_all(names, modes, verbose=False):
    """One library per variant, of the modes it touches; all nvcc runs at
    once."""
    jobs = []
    built = {name: [m for m in modes if touches(name, m)] for name in names}
    for name in names:
        d = _variant_dir(name)
        for m in built[name]:
            src = _SOURCES[m]
            jobs.append(subprocess.Popen(
                [K._nvcc(), *K.NVCC_FLAGS, "-c", "-o",
                 os.path.join(d, src + ".o"), os.path.join(d, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in jobs:
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(p.args)}\n{out}")
        if verbose:
            print(out)
    libs = {}
    for name in names:
        if not built[name]:
            continue
        d = os.path.join(PROBE_DIR, name)
        so = os.path.join(d, "libprobe.so")
        subprocess.run([K._nvcc(), "-shared", "-o", so,
                        *(os.path.join(d, _SOURCES[m] + ".o")
                          for m in built[name])],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for m in built[name]:
            fn = getattr(lib, K.ENTRY_POINTS[m])
            fn.argtypes = [p, i, ll, ll, i, *[p] * 7, *[i] * 10, p, p]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def build_fft(names, verbose=False):
    """One library of the FFT source per variant; all nvcc runs at once."""
    jobs = []
    for name in names:
        d = os.path.join(PROBE_DIR, "fft_" + name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        shutil.copy(os.path.join(_CSRC, "mel_common.cuh"), d)
        with open(K.FFT_SOURCE) as fh:
            text = fh.read()
        for old, new in FFT_VARIANTS[name][0]:
            if old not in text:
                raise RuntimeError(f"variant {name}: {_FFT_SOURCE} no longer "
                                   f"holds {old!r}")
            text = text.replace(old, new)
        with open(os.path.join(d, _FFT_SOURCE), "w") as fh:
            fh.write(text)
        jobs.append((name, d, subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o",
             os.path.join(d, "libprobe.so"), os.path.join(d, _FFT_SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, d, proc in jobs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(proc.args)}\n{out}")
        if verbose:  # registers and spills of each instantiation
            lines = out.splitlines()
            for i, ln in enumerate(lines):
                if "Compiling entry function" in ln:
                    inst = ln.split("mel_db_fft_kernel")[-1].split("E")[0]
                    print(f"[ptxas] fft_{name} {inst}: "
                          + "; ".join(x.strip() for x in lines[i + 1:i + 4]
                                      if "stack" in x or "registers" in x))
        lib = ctypes.CDLL(os.path.join(d, "libprobe.so"))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = getattr(lib, K.FFT_ENTRY_POINT)
        fn.argtypes = [p, i, ll, ll, i, *[p] * 6, *[i] * 6, p, p]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def probe_fft(args):
    """Time each FFT_VARIANTS entry at args.rates against the plain
    version; prints one line per (variant, rate) and returns the times."""
    from ..config import SpecSetting, derive_stft_params
    from ..ops.framing import n_frames_for, reflect_pad_center
    from ..ops.mel import calc_mel_fb_default
    from ..ops.windows import default_stft_window

    names = list(dict.fromkeys(v for v in args.variants
                               if v in FFT_VARIANTS)) or ["base"]
    libs = build_fft(names, args.ptxas)
    rng = np.random.default_rng(20261018)
    results = {}
    for sr in args.rates:
        p = derive_stft_params(sr, SpecSetting())
        win, hop, n_fft = p.win_length, p.hop_length, p.n_fft
        fb = calc_mel_fb_default(sr, n_fft)
        rec = K.prepare_fft_operands(default_stft_window(win, n_fft),
                                     torch.from_numpy(fb).cuda(), n_fft)
        n = int(args.seconds * sr)
        wav = (0.1 * rng.standard_normal(n)).astype(np.float32)
        n_frames = n_frames_for(n, win, hop)
        x = torch.from_numpy(reflect_pad_center(wav, win)).cuda()
        out = torch.empty((n_frames, fb.shape[1]), device="cuda")
        want = K.mel_spectrogram_cuda(x, rec, win=win, hop=hop,
                                      n_frames=n_frames)
        for name in names:
            radices = FFT_VARIANTS[name][1].get(n_fft)
            tw = rec.twiddles if radices is None else torch.from_numpy(
                K.fft_twiddles(n_fft, radices)).cuda()
            fn = getattr(libs[name], K.FFT_ENTRY_POINT)
            stream = torch.cuda.current_stream().cuda_stream
            plan = K._Plan()

            def run():
                err = fn(x.data_ptr(), 0, x.numel(), x.numel(), 1,
                         rec.window.data_ptr(), tw.data_ptr(),
                         rec.wts.data_ptr(), rec.bands.data_ptr(),
                         rec.woff.data_ptr(), out.data_ptr(), win, hop,
                         n_frames, n_fft, fb.shape[1], tw.shape[0], stream,
                         ctypes.byref(plan))
                if err:
                    raise RuntimeError(f"fft {name}: error {err}")

            out.fill_(float("nan"))
            ms = time_ms(run, args.reps)
            note = ""
            if name != "no_mel":
                err = (out - want).abs().max().item()
                note = f" (max |dB| vs the built kernel {err:.3g})"
            results[f"fft_{name}/{sr}"] = ms
            print(f"[probe] fft_{name:9s} {sr:6d} Hz B=1 {n_frames} frames, "
                  f"n_fft {n_fft}, smem {plan.smem}: {ms:.4f} ms{note}",
                  flush=True)
    return results


def _operands(sr, mode):
    from ..config import SpecSetting, derive_stft_params
    from ..ops.dft import windowed_dft_matrices
    from ..ops.mel import calc_mel_fb_default
    from ..ops.windows import default_stft_window

    p = derive_stft_params(sr, SpecSetting())
    c, s = windowed_dft_matrices(default_stft_window(p.win_length, p.n_fft),
                                 p.n_fft)
    ops = K.operands_from_numpy(c, s, calc_mel_fb_default(sr, p.n_fft),
                                "cuda")
    if mode == "fast":
        ops = K.operands_bf16(*ops)
    elif mode == "split":
        ops = K.operands_split(*ops)
    return p.win_length, p.hop_length, K.prepare_operands(*ops, mode)


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rates", type=int, nargs="+", default=[48000, 8000])
    ap.add_argument("--variants", nargs="+",
                    default=list(VARIANTS) + list(FFT_VARIANTS))
    ap.add_argument("--modes", nargs="+", default=list(K.MODES),
                    choices=K.MODES)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's output (registers, spills)")
    ap.add_argument("--fft", action="store_true",
                    help="time FFT_VARIANTS of the FFT tier instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device")
    if args.fft:
        if args.rates == [48000, 8000]:
            args.rates = [384000, 250000, 192000]
        print(json.dumps(probe_fft(args)))
        return
    from ..ops.framing import n_frames_for, reflect_pad_center

    args.variants = [v for v in args.variants if v in VARIANTS]
    libs = build_all(args.variants, args.modes, args.ptxas)
    if args.sass:
        for mode, kernel in (("parity", "mel_db_tf32_kernelIfLi4E"),
                             ("fast", "mel_db_bf16_kernelIfLi4E"),
                             ("split", "mel_db_split_kernelIfLi4E")):
            if mode not in args.modes:
                continue
            ops = sass_opcodes(os.path.join(PROBE_DIR, "base",
                                            _SOURCES[mode] + ".o"), kernel)
            print(f"[sass] {kernel}: {sum(ops.values())} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in ops.most_common(25)))
    rng = np.random.default_rng(20261016)
    results = {}
    for sr in args.rates:
        n = int(args.seconds * sr)
        wav = (0.1 * rng.standard_normal(n)).astype(np.float32)
        for mode in args.modes:
            win, hop, ops = _operands(sr, mode)
            n_frames = n_frames_for(n, win, hop)
            n_mel = ops.fb.shape[-1]
            x = torch.from_numpy(reflect_pad_center(wav, win)).cuda()
            out = torch.empty((n_frames, n_mel), device="cuda")
            want = K.mel_spectrogram_plain(x, ops.c, ops.s, ops.fb, win=win,
                                           hop=hop, n_frames=n_frames,
                                           mode=mode)
            for name in args.variants:
                if not touches(name, mode):
                    continue
                fn = getattr(libs[name], K.ENTRY_POINTS[mode])
                stream = torch.cuda.current_stream().cuda_stream
                plan = K._Plan()

                def run():
                    err = fn(x.data_ptr(), 0, x.numel(), x.numel(), 1,
                             ops.slabs.data_ptr(), ops.tail.data_ptr(),
                             ops.wts.data_ptr(), ops.bands.data_ptr(),
                             ops.woff.data_ptr(), ops.tile_bands.data_ptr(),
                             out.data_ptr(), win, hop,
                             n_frames,
                             ops.n_freq, n_mel, ops.n_tiles,
                             ops.wts.shape[0], ops.ks, ops.nb, ops.row,
                             stream, ctypes.byref(plan))
                    if err:
                        raise RuntimeError(f"{name} {mode}: error {err}")

                out.fill_(float("nan"))
                ms = time_ms(run, args.reps)
                note = ""
                if name in RIGHT:
                    err = (out - want).abs()
                    note = (f" (finite: {bool(torch.isfinite(out).all())}, "
                            f"max |err| vs plain {err.max().item():.3g} dB, "
                            f"bins over 0.01 dB: {int((err > 0.01).sum())})")
                results[f"{name}/{mode}/{sr}"] = ms
                tier = K.TIERS[plan.tier - 1]
                print(f"[probe] {name:10s} {mode:6s} {sr:5d} Hz B=1 "
                      f"{n_frames} frames, {tier} MT {plan.mt} stages "
                      f"{plan.stages} chunk {plan.chunk}: {ms:.3f} ms{note}",
                      flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
