#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (msv_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing its lines:
  1. device   the card's name and power limit (nvidia-smi), torch, CUDA and
              nvcc versions;
  2. build    compiles the three mel dB kernels (f32 parity, bf16 fast,
              split-f32) from csrc/ into one library with nvcc;
  3. kernel   the parity kernel against its plain PyTorch version at all
              six rate buckets, f32 and int16 input, batch 1 and 2, on 240 s
              of audio per row (about 24 000 frames); atol 2e-3 dB, rtol
              1e-4, except that bins 60 dB or more under their frame's peak
              may instead be within 1e-6 of that peak in amplitude (f32
              summation order: f32_agree); int16 bit-equal to f32;
              CUDA-event times, median of 5;
  3b. fast    (run after phase 4, on its own seeded stream) the bf16
              kernel against its plain version (mode="fast") at phase 3's
              shapes: max < 0.47 dB (one 120 dB / 255 grey step), p99 <
              0.01 dB, int16 bit-equal to f32; against the parity kernel,
              under 5% of bins more than 0.47 dB apart (deep nulls swing
              further); times of both kernels and the plain version;
  3c. split   (run after phase 3b, on its own seeded stream) the split-f32
              kernel against its plain version (mode="split") at phase 3's
              shapes (f32_agree), int16 bit-equal to f32; against the parity
              kernel p99 < 0.01 dB and under 0.1% of bins more than 0.47 dB
              apart; on tests/test_pallas_kernel.py's two-tone signal at 16
              and 48 kHz, max < 0.47 dB from parity and under a twentieth of
              fast's max; times of the split, parity and fast kernels and of
              the split plain version; then tools/profile_split_tpu.py's
              A/B: 30 minutes at 48 kHz in 32 768-frame device-resident
              segments, parity, split and fast, in frames per second (the
              main path of the split kernel: its launches are counted
              there);
  4. session  the user's path: MultiTrack(device="cuda").add_tracks on seven
              240 s stereo PCM16 WAVs at 8/16/22.05/24/44.1/44.1/48 kHz (six
              kernel launch groups), a 500-row full-width image of every
              track (24 000 columns: the banded resize), one 1200-column
              crop, and a 10 s track in a second session (the dense resize)
              checked against the same session run on the CPU, and both
              against an f64 witness of the kernel's function (f32_agree);
              then the seven tracks again under precision_mode_scope("fast"):
              one fast launch per group, the 48 kHz track against the plain
              version (max < 0.47 dB, p99 < 0.01 dB); 200-row full-width
              waveform images of every track, a 1200-column waveform crop
              equal to the slice of the full image, the 10 s track's
              waveform images equal to the CPU session's; then
              set_setting(linear) on the seven tracks (no mel kernel
              launch), a full-width linear image and a crop, the 10 s track
              against the CPU session on the linear scale (f32_agree, one
              u8 step); a save_session / load_session round trip; which
              audio decoder ran;
  5. stream   long tracks: a 60-minute 48 kHz mono PCM16 WAV and an
              8-minute 44.1 kHz stereo PCM16 WAV (the int32 carrier) open
              through segmented streaming, one parity launch per segment;
              the hour's dB plane against one one-shot kernel launch on the
              whole wave (atol 2e-3 dB, rtol 1e-4), a 36 000-column image, a
              1200-column crop across a segment boundary,
              streaming_spec_db_mmap on the hour equal to the session's
              plane; then both tracks under precision_mode_scope("fast"),
              the hour's plane under 5% of bins more than 0.47 dB from
              parity; the hour's waveform image drawn from the device wave
              streaming kept (no second upload); the 8-minute track through
              linear streaming against one one-shot spec_pipeline
              (f32_agree);
  6. features log_mel_spectrogram on 4 x 4 s at 48 kHz (n_mel 128, 40/10
              ms) and on 64 x 10 s at 16 kHz (25/10 ms): one fast launch per
              call by default, one parity launch with precision="parity",
              each against its plain version (fast: max < 0.47 dB, p99 <
              0.01 dB; parity: f32_agree).
Each path of phases 3c-6 is driven with the launch counts set to 0 just
before it and read just after; comparisons run outside those windows.  The
second-to-last line is a JSON object describing each kernel (its bound is
computed from this run's shapes against the H100 SXM's published peaks);
the last line is {"ok": true, "device": {...}}.  Exits non-zero, printing
neither, without a CUDA device or when any check fails.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

RATES = [8000, 16000, 22050, 24000, 44100, 48000]
SESSION_RATES = [8000, 16000, 22050, 24000, 44100, 44100, 48000]
SECONDS = 240.0
ATOL, RTOL = 2e-3, 1e-4
GREY_STEP = 0.47  # dB: one 120 dB / 255 grey level
# Fast (bf16 operands) against parity: the bf16 rounding of the frame and of
# C/S leaves bins about 50 dB under a frame's loudest component imprecise,
# so deep nulls swing by many dB.  Bound: the share of bins more than one
# grey step apart (0.35-0.81% on these signals, on an H100 80GB HBM3 at
# 700 W).
FAST_SHARE = 0.05
# Two f32 computations of one dB plane (a kernel and its plain version, or
# either and an f64 witness) differ by summation order.  A bin far under its
# frame's loudest one carries the frame's rounding at a large relative
# size.  On one 10 s 44.1 kHz track (tests/test_torch_null_bins.py) the
# parity kernel is 0.0229 dB from an f64 witness in a bin 105 dB under its
# frame's peak (on an H100 80GB HBM3 at 700 W), and the CPU plain version
# 0.0142 dB in another, 85 dB under: both are under 1e-7 of the frame's
# peak amplitude.  So bins DEEP_DB or more under the frame's peak may
# instead be within F32_FLOOR of that peak amplitude (about 17 units of f32
# roundoff), and at most FLOOR_SHARE of the bins may need that.
DEEP_DB = 60.0
F32_FLOOR = 1e-6
FLOOR_SHARE = 1e-3
SEED = 20261016
# Split against parity: share of bins more than one grey step apart.
SPLIT_SHARE = 1e-3
# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet) and
# its HBM3 rate: the roofline of the kernels line.
PEAK_FLOPS = {"parity": 67e12, "fast": 989e12, "split": 989e12}
HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, reps=5):
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
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


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def reset_counts(K):
    K.LAUNCHES = 0
    for mode in K.LAUNCHES_BY_MODE:
        K.LAUNCHES_BY_MODE[mode] = 0


def read_counts(K):
    torch.cuda.synchronize()
    return dict(K.LAUNCHES_BY_MODE)


def counts(parity=0, fast=0, split=0):
    """The launch counts a path should leave, by kernel."""
    return {"parity": parity, "fast": fast, "split": split}


def bound(K, mode, padded, ops, n_frames):
    """(bound_ms, bound_by) of one launch on ``padded``: the larger of the
    bytes it must move (the wave, C, S and fb read once, the dB plane
    written once) over the HBM rate, and its operations (the DFT pair and
    each mel band's support; three products each in split mode) over the
    mode's peak rate."""
    win, n_freq = ops[0].shape[-2:]
    n_mel = ops[2].shape[-1]
    bands = K.mel_bands(ops[2])
    band_bins = int((bands[:, 1] - bands[:, 0]).sum())
    rows = 1 if padded.ndim == 1 else padded.shape[0]
    products = 3 if mode == "split" else 1
    flops = products * 2 * rows * n_frames * (2 * win * n_freq + band_bins)
    nbytes = (sum(t.numel() * t.element_size() for t in (padded, *ops))
              + 4 * rows * n_frames * n_mel)
    t_ops, t_bytes = flops / PEAK_FLOPS[mode], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def quantile(err, q):
    """The q-quantile of a tensor of errors (kthvalue: no size limit)."""
    flat = err.flatten()
    return flat.kthvalue(max(1, int(np.ceil(q * flat.numel())))).values.item()


def f32_agree(got, want):
    """Where two f32 computations of a dB plane (..., n_frames, n_mel)
    agree: within ATOL + RTOL * |want|, or, in a bin DEEP_DB or more under
    its frame's peak (of ``want``), within F32_FLOOR in amplitude relative
    to that peak.  Returns (agree, close): ``close`` is the atol/rtol part
    alone."""
    close = (got - want).abs() <= ATOL + RTOL * want.abs()
    peak = want.amax(dim=-1, keepdim=True)

    def amp(db):  # amplitude relative to the frame's peak
        return torch.pow(10.0, (db - peak) / 20.0)

    deep = want <= peak - DEEP_DB
    return close | (deep & ((amp(got) - amp(want)).abs() <= F32_FLOOR)), close


def check_f32(got, want, what):
    """Fail unless ``got`` agrees with ``want`` by f32_agree, with at most
    FLOOR_SHARE of the bins admitted by the floor alone.  Returns the max
    |dB error| and a note on the floor-admitted bins."""
    agree, close = f32_agree(got, want)
    err = (got - want).abs()
    n_floor = int((agree & ~close).sum())
    share = n_floor / agree.numel()
    note = "all bins within atol/rtol"
    if n_floor:
        i = int(torch.where(close, 0.0, err).flatten().argmax())
        peak = want.amax(dim=-1, keepdim=True).expand_as(want).flatten()[i]
        g, w = got.flatten()[i].item(), want.flatten()[i].item()
        note = (f"{n_floor} deep bins by the f32 floor, worst {abs(g - w):.3g}"
                f" dB at {w:.2f} dB, {peak.item() - w:.1f} dB under its "
                f"frame's peak")
    bad = int((~agree).sum())
    check(bad == 0 and share <= FLOOR_SHARE,
          f"{what}: {bad} bins disagree (max |err| {err.max().item()} dB); "
          f"{note}")
    return err.max().item(), note


def f64_witness(padded, c, s, fb, win, hop, n_frames):
    """The kernels' function in float64 numpy on the same f32 inputs: the
    reflect-padded wave (..., L) and the (C, S, fb) operand tensors."""
    x = np.asarray(padded, np.float64)
    if np.asarray(padded).dtype == np.int16:
        x = x * 2.0**-15
    fr = np.lib.stride_tricks.sliding_window_view(x, win, axis=-1)
    # contiguous: numpy's matmul leaves BLAS for the strided view (100x
    # slower)
    fr = np.ascontiguousarray(fr[..., ::hop, :][..., :n_frames, :])
    c, s, fb = (t.double().cpu().numpy() for t in (c, s, fb))
    re, im = fr @ c, fr @ s
    mel = np.sqrt(re * re + im * im) @ fb
    return torch.from_numpy(np.where(
        mel > 1e-18, 20.0 * np.log10(np.maximum(mel, 1e-300)), -360.0))


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    from msv_tpu_torch.kernels.spectrogram_cuda import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(smi)
    print(f"[device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, nvcc {nvcc.strip().splitlines()[-1]}; "
          f"python {sys.version.split()[0]}")
    # parity: true f32 GEMMs in the plain versions and the render path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[device] allow_tf32: matmul False, cudnn False")
    return smi


def phase_build(K):
    t0 = time.perf_counter()
    K.build()
    dt = time.perf_counter() - t0
    report = [ln.strip() for ln in K.BUILD_REPORT.splitlines()
              if "registers" in ln or "spill" in ln]
    srcs = " + ".join(os.path.relpath(K.SOURCES[m]) for m in K.MODES)
    print(f"[build] {srcs} in {dt:.2f} s (nvcc {' '.join(K.NVCC_FLAGS)})")
    for ln in report:
        print(f"[build]   {ln}")


def operands(sr, device):
    from msv_tpu_torch.config import SpecSetting, derive_stft_params
    from msv_tpu_torch.kernels.spectrogram_cuda import operands_from_numpy
    from msv_tpu_torch.ops.dft import windowed_dft_matrices
    from msv_tpu_torch.ops.mel import calc_mel_fb_default
    from msv_tpu_torch.ops.windows import default_stft_window

    p = derive_stft_params(sr, SpecSetting())
    c, s = windowed_dft_matrices(
        default_stft_window(p.win_length, p.n_fft), p.n_fft)
    ops = operands_from_numpy(c, s, calc_mel_fb_default(sr, p.n_fft), device)
    return p.win_length, p.hop_length, ops


def make_signal(rng, sr, seconds, rows):
    """int16 rows: a few swept tones over noise, as PCM16 audio."""
    n = int(seconds * sr)
    t = np.arange(n, dtype=np.float64) / sr
    out = []
    for r in range(rows):
        f0 = rng.uniform(80, 600)
        sig = sum(
            (0.25 / k) * np.sin(2 * np.pi * f0 * k * t
                                + 3.0 * np.sin(2 * np.pi * 0.1 * t))
            for k in (1, 2, 3, 5)
        )
        sig = sig * (0.55 + 0.45 * np.sin(2 * np.pi * 0.05 * t + r))
        sig += 0.03 * rng.standard_normal(n)
        out.append(np.clip(sig * 32767, -32768, 32767).astype(np.int16))
    return np.stack(out)


def phase_kernel(K, rng):
    from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center

    max_err, headline = 0.0, None
    for sr in RATES:
        win, hop, ops = operands(sr, "cuda")
        i16 = make_signal(rng, sr, SECONDS, 2)
        n_frames = n_frames_for(i16.shape[1], win, hop)
        padded = np.stack([reflect_pad_center(x, win) for x in i16])
        wave = {
            "i16": torch.from_numpy(padded).cuda(),
            "f32": torch.from_numpy(
                padded.astype(np.float32) * np.float32(2.0**-15)).cuda(),
        }
        for batch in (1, 2):
            x = {k: (v[0] if batch == 1 else v) for k, v in wave.items()}

            def run(dtype):
                return K.mel_spectrogram_cuda(x[dtype], *ops, win=win,
                                              hop=hop, n_frames=n_frames)

            def plain():
                return K.mel_spectrogram_plain(x["f32"], *ops, win=win,
                                               hop=hop, n_frames=n_frames)

            got_i16, got_f32, want = run("i16"), run("f32"), plain()
            torch.cuda.synchronize()
            n_mel = ops[2].shape[1]
            shape = (n_frames, n_mel) if batch == 1 else (2, n_frames, n_mel)
            check(tuple(got_f32.shape) == shape, f"{sr} Hz B={batch} shape")
            check(bool(torch.isfinite(got_f32).all()), f"{sr} Hz finite")
            check(torch.equal(got_i16, got_f32),
                  f"{sr} Hz B={batch}: int16 route != f32 route")
            err, note = check_f32(got_f32, want,
                                  f"{sr} Hz B={batch}: kernel vs plain")
            max_err = max(max_err, err)
            ms = cuda_ms(lambda: run("f32"))
            ms_i16 = cuda_ms(lambda: run("i16"))
            plain_ms = cuda_ms(plain)
            print(f"[kernel] {sr:5d} Hz win {win:4d} hop {hop:3d} "
                  f"n_mel {n_mel} B={batch} frames {n_frames}: max|err| "
                  f"{err:.3g} dB ({note}), i16==f32; kernel {ms:.3f} ms "
                  f"(i16 {ms_i16:.3f}), plain {plain_ms:.3f} ms")
            if sr == 48000 and batch == 1:
                headline = (ms, plain_ms, f"{sr} Hz, B=1, f32, "
                            f"{n_frames} frames x {n_mel} mel",
                            *bound(K, "parity", x["f32"], ops, n_frames))
        del wave, ops
        torch.cuda.empty_cache()
    return max_err, headline


def write_session_wavs(rng, d):
    from msv_tpu_torch.io.audio import write_wav

    paths = []
    for i, sr in enumerate(SESSION_RATES):
        st = make_signal(rng, sr, SECONDS, 2).astype(np.float32) / 32768.0
        p = os.path.join(d, f"track{i}_{sr}.wav")
        write_wav(p, st * 0.5, sr, bits=16)  # stereo PCM16
        paths.append(p)
    short = make_signal(rng, 44100, 10.0, 2).astype(np.float32) / 32768.0
    p10 = os.path.join(d, "short_44100.wav")
    write_wav(p10, short * 0.5, 44100, bits=16)
    return paths, p10


def phase_session(K, rng):
    from msv_tpu_torch import (FreqScale, MultiTrack, SpecSetting,
                               precision_mode_scope)
    from msv_tpu_torch.io import _native_audio as NA
    from msv_tpu_torch.io.audio import open_audio_file_ex
    from msv_tpu_torch.ops.framing import n_frames_for
    from msv_tpu_torch.session.multitrack import FRAME_BUCKET
    from msv_tpu_torch.utils import round_up_to

    with tempfile.TemporaryDirectory(prefix="msv_chip_smoke_") as d:
        t0 = time.perf_counter()
        paths, p10 = write_session_wavs(rng, d)
        print(f"[session] wrote {len(paths)} x {SECONDS:.0f} s stereo PCM16 "
              f"WAVs + one 10 s in {time.perf_counter() - t0:.2f} s")
        ids = list(range(len(paths)))

        # ---- the main path: counts from here to the end of the renders
        torch.cuda.synchronize()
        reset_counts(K)
        t0 = time.perf_counter()
        mt = MultiTrack(device="cuda")
        mt.add_tracks(ids, paths)
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t0
        groups = {
            (t.sr, round_up_to(n_frames_for(t.n_samples, t.win_length,
                                            t.hop_length), FRAME_BUCKET),
             t.wire)
            for t in mt.tracks.values()
        }
        check(len(groups) == 6, f"expected 6 launch groups, got {groups}")
        check(K.LAUNCHES_BY_MODE["parity"] == len(groups),
              f"add_tracks launched the kernel {K.LAUNCHES} times for "
              f"{len(groups)} groups")
        t0 = time.perf_counter()
        for i in ids:
            img = mt.get_spec_image(i, 100.0, 500)
            check(img.shape == (500, int(100 * SECONDS), 3)
                  and img.dtype == np.uint8,
                  f"track {i} image {img.shape} {img.dtype}")
        render_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rgb = mt.get_spec_image(ids[-1], 100.0, 500, wire="rgb")
        rgb_s = time.perf_counter() - t0
        check(rgb.shape == img.shape, f"rgb wire image {rgb.shape}")
        t0 = time.perf_counter()
        crop = mt.get_spec_image_crop(0, 100.0, 500, 30.0, 42.0)
        crop_s = time.perf_counter() - t0
        check(crop.shape == (500, 1200, 3), f"crop {crop.shape}")
        full0 = mt.get_spec_image(0, 100.0, 500)
        check(np.array_equal(crop, full0[:, 3000:4200]),
              "crop != slice of the full image")

        t0 = time.perf_counter()
        mt10 = MultiTrack(device="cuda")
        mt10.add_tracks([0], [p10])
        img10 = mt10.get_spec_image(0, 100.0, 500, wire="rgb")
        short_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        wav_imgs = [mt.get_wav_image(i, 100.0, 200, -1.0, 1.0) for i in ids]
        wav_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        wcrop = mt.get_wav_image_crop(0, 100.0, 200, -1.0, 1.0, 30.0, 42.0)
        wcrop_s = time.perf_counter() - t0
        w10 = (mt10.get_wav_image(0, 100.0, 200, -1.0, 1.0),
               mt10.get_wav_image_crop(0, 1000.0, 200, -0.5, 0.5, 2.0, 3.2))
        launches = read_counts(K)
        # ---- end of the main path
        check(launches == counts(len(groups) + 1), f"launches {launches}")
        check(img10.shape == (500, 1000, 3), f"10 s image {img10.shape}")
        for i, w in zip(ids, wav_imgs):
            check(w.shape == (200, int(100 * SECONDS), 4)
                  and w.dtype == np.uint8 and (w[..., 3] > 0).any(),
                  f"track {i} waveform image {w.shape}")
        check(np.array_equal(wcrop, wav_imgs[0][:, 3000:4200]),
              "waveform crop != slice of the full waveform image")

        for i in ids:
            db = mt.get_spec_db(i)
            tr = mt.tracks[i]
            nf = n_frames_for(tr.n_samples, tr.win_length, tr.hop_length)
            check(db.shape[0] == nf and np.isfinite(db).all(),
                  f"track {i} dB plane {db.shape}")
        check(np.isfinite(mt.get_min_db()) and mt.get_max_db() <= 0.0,
              "global dB range")
        check(mt.get_max_db() - mt.get_min_db() <= 120.0 + 1e-3,
              "dB range wider than db_range")

        # the same short session through the plain versions on the CPU, and
        # both against an f64 witness of the kernel's function
        cpu = MultiTrack(device="cpu")
        cpu.add_tracks([0], [p10])
        got10 = torch.from_numpy(mt10.get_spec_db(0))
        cpu10 = torch.from_numpy(cpu.get_spec_db(0))
        err10, note10 = check_f32(got10, cpu10, "10 s track: CUDA vs CPU")
        tr10 = cpu.tracks[0]
        padded10, nf10, _ = cpu._prep_padded(tr10)
        wit = f64_witness(padded10, *cpu._sr_operands(tr10.sr, "parity"),
                          tr10.win_length, tr10.hop_length, nf10).float()
        wit_err = {name: check_f32(x, wit, f"10 s track: {name} vs the f64 "
                                   f"witness")
                   for name, x in (("CUDA", got10), ("CPU", cpu10))}
        img_cpu = cpu.get_spec_image(0, 100.0, 500, wire="rgb")
        px = int(np.abs(img10.astype(np.int16) - img_cpu).max())
        check(px <= 1, f"10 s track: CUDA vs CPU image differs by {px}")
        w10_cpu = (cpu.get_wav_image(0, 100.0, 200, -1.0, 1.0),
                   cpu.get_wav_image_crop(0, 1000.0, 200, -0.5, 0.5, 2.0, 3.2))
        check(all(np.array_equal(a, b) for a, b in zip(w10, w10_cpu)),
              "10 s track: CUDA waveform images != the CPU session's")

        print(f"[session] add_tracks ({len(paths)} tracks, {len(groups)} "
              f"kernel launches) {add_s:.3f} s; {len(ids)} full-width "
              f"500x{int(100 * SECONDS)} images (grey8 wire) {render_s:.3f} s;"
              f" one on the rgb wire {rgb_s:.3f} s; 1200-px crop "
              f"{crop_s:.3f} s; 10 s track add+render (dense) {short_s:.3f} s;"
              f" {len(ids)} full-width 200x{int(100 * SECONDS)} waveform "
              f"images {wav_s:.3f} s; 1200-px waveform crop {wcrop_s:.3f} s; "
              f"10 s track's waveform image and crop equal the CPU session's")
        stages = {k: v["total_s"] for k, v in mt.timer.summary().items()}
        print(f"[session] stage seconds, host clock: {json.dumps(stages)}")
        print(f"[session] dB range [{mt.get_min_db():.3f}, "
              f"{mt.get_max_db():.3f}]; 10 s track vs CPU: max|dB err| "
              f"{err10:.3g} ({note10}), max image step {px}; vs the f64 "
              f"witness: " + "; ".join(
                  f"{k} max|dB err| {e:.3g} ({n})"
                  for k, (e, n) in wit_err.items()))

        # ---- the fast session: the same tracks under fast mode
        torch.cuda.synchronize()
        reset_counts(K)
        t0 = time.perf_counter()
        with precision_mode_scope("fast"):
            mf = MultiTrack(device="cuda")
            mf.add_tracks(ids, paths)
        torch.cuda.synchronize()
        fast_s = time.perf_counter() - t0
        img_f = mf.get_spec_image(ids[-1], 100.0, 500)
        fast_launches = read_counts(K)
        # ---- end of the fast session
        check(fast_launches == counts(fast=len(groups)),
              f"fast session launches {fast_launches} for {len(groups)} "
              f"groups")
        check(img_f.shape == img.shape, f"fast image {img_f.shape}")
        # the 48 kHz track against the plain version on its padded wave
        tr, st = mf.tracks[ids[-1]], mf._state[ids[-1]]
        padded, nf, _ = mf._prep_padded(tr)
        want = K.mel_spectrogram_plain(
            torch.from_numpy(padded).cuda(), *mf._sr_operands(tr.sr, "parity"),
            win=tr.win_length, hop=tr.hop_length, n_frames=nf, mode="fast")
        err = (st.spec_db[:nf] - want).abs()
        e_max, e_p99 = err.max().item(), quantile(err, 0.99)
        check(e_max < GREY_STEP and e_p99 < 0.01,
              f"fast session {tr.sr} Hz vs plain: max {e_max} dB, p99 "
              f"{e_p99} dB")
        shares = [((mf._state[i].spec_db - mt._state[i].spec_db)
                   [: mt._state[i].n_frames].abs() > GREY_STEP)
                  .float().mean().item() for i in ids]
        check(max(shares) < FAST_SHARE, f"fast session vs parity: shares "
              f"{shares} of bins more than {GREY_STEP} dB apart")
        print(f"[session] fast mode: add ({len(paths)} tracks, "
              f"{len(groups)} fast launches) {fast_s:.3f} s; {tr.sr} Hz "
              f"track vs plain max {e_max:.3g} dB p99 {e_p99:.3g} dB; vs the "
              f"parity session share>{GREY_STEP} {min(shares):.4f}-"
              f"{max(shares):.4f}")
        del mf

        # ---- the linear scale: live settings on the seven-track session
        linear = SpecSetting(freq_scale=FreqScale.LINEAR)
        torch.cuda.synchronize()
        reset_counts(K)
        mt.timer.reset()
        t0 = time.perf_counter()
        mt.set_setting(linear)
        torch.cuda.synchronize()
        lin_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        limg = mt.get_spec_image(ids[-1], 100.0, 500)
        limg_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lcrop = mt.get_spec_image_crop(ids[-1], 100.0, 500, 30.0, 42.0)
        lcrop_s = time.perf_counter() - t0
        mt10.set_setting(linear)
        lin_launches = read_counts(K)
        # ---- end of the linear path
        check(lin_launches == counts(), f"the linear session launched a mel "
              f"kernel: {lin_launches}")
        check(sorted(mt.tracks) == ids and limg.shape == img.shape
              and np.array_equal(lcrop, limg[:, 3000:4200]),
              f"linear image {limg.shape} or crop")
        tr = mt.tracks[ids[-1]]
        check(mt.get_spec_db(ids[-1]).shape[1] == tr.n_fft // 2 + 1,
              "linear plane width")
        cpu.set_setting(linear)
        lerr, lnote = check_f32(torch.from_numpy(mt10.get_spec_db(0)),
                                torch.from_numpy(cpu.get_spec_db(0)),
                                "10 s track, linear: CUDA vs CPU")
        lpx = int(np.abs(mt10.get_spec_image(0, 100.0, 500, wire="rgb")
                         .astype(np.int16)
                         - cpu.get_spec_image(0, 100.0, 500, wire="rgb"))
                  .max())
        check(lpx <= 1, f"10 s track, linear: images differ by {lpx}")
        stages = {k: v["total_s"] for k, v in mt.timer.summary().items()}
        print(f"[session] set_setting(linear) on {len(ids)} tracks (re-add, "
              f"no kernel launch) {lin_s:.3f} s; full-width 500x"
              f"{int(100 * SECONDS)} linear image {limg_s:.3f} s, 1200-px crop "
              f"{lcrop_s:.3f} s; 10 s track vs CPU max|dB err| {lerr:.3g} "
              f"({lnote}), max image step {lpx}; stage seconds, host clock: "
              f"{json.dumps(stages)}")

        path = os.path.join(d, "session.json")
        mt.save_session(path)
        back = MultiTrack.load_session(path, device="cuda")
        check(back.setting == mt.setting and sorted(back.tracks) == ids
              and abs(back.get_max_db() - mt.get_max_db()) <= ATOL,
              "save_session / load_session round trip")
        check_f32(torch.from_numpy(back.get_spec_db(ids[0])),
                  torch.from_numpy(mt.get_spec_db(ids[0])),
                  "reloaded session's plane")
        print(f"[session] save_session / load_session: {len(ids)} tracks, "
              f"{back.setting.freq_scale.value} scale, dB range and planes "
              f"as saved")
        del back

        # the decoders: PCM16 WAVs take numpy's integer route by design;
        # other WAVs (and FLAC) the port's own native library
        native0 = NA.DECODES["native"]
        open_audio_file_ex(p10)
        check(NA.DECODES["native"] == native0 + 1 and NA.LIBRARY,
              f"the native decoder did not run: {NA.BUILD_ERROR}")
        print(f"[session] audio decoders: session adds of PCM16 WAVs by the "
              f"numpy integer route; native C++ decoder "
              f"{os.path.relpath(NA.LIBRARY)} (built from msv_tpu_torch/"
              f"native/) decoded {NA.DECODES['native']} file(s), numpy "
              f"fallback {NA.DECODES['numpy']}")
        return launches, fast_launches, lin_launches


def phase_fast(K, rng):
    """3b: the bf16 kernel against its plain version and the parity
    kernel."""
    from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center

    max_err, headline, rows = 0.0, None, []
    for sr in RATES:
        win, hop, ops = operands(sr, "cuda")
        ops16 = K.operands_bf16(*ops)
        i16 = make_signal(rng, sr, SECONDS, 2)
        n_frames = n_frames_for(i16.shape[1], win, hop)
        padded = np.stack([reflect_pad_center(x, win) for x in i16])
        wave = {
            "i16": torch.from_numpy(padded).cuda(),
            "f32": torch.from_numpy(
                padded.astype(np.float32) * np.float32(2.0**-15)).cuda(),
        }
        for batch in (1, 2):
            x = {k: (v[0] if batch == 1 else v) for k, v in wave.items()}
            kw = dict(win=win, hop=hop, n_frames=n_frames)

            def fast(dtype="f32"):
                return K.mel_spectrogram_cuda(x[dtype], *ops16, mode="fast",
                                              **kw)

            def plain():
                return K.mel_spectrogram_plain(x["f32"], *ops, mode="fast",
                                               **kw)

            def parity():
                return K.mel_spectrogram_cuda(x["f32"], *ops, **kw)

            got_i16, got, want, par = fast("i16"), fast(), plain(), parity()
            torch.cuda.synchronize()
            n_mel = ops[2].shape[1]
            shape = (n_frames, n_mel) if batch == 1 else (2, n_frames, n_mel)
            what = f"{sr} Hz B={batch} fast"
            check(tuple(got.shape) == shape, f"{what}: shape")
            check(bool(torch.isfinite(got).all()), f"{what}: finite")
            check(torch.equal(got_i16, got), f"{what}: int16 != f32 route")
            err = (got - want).abs()
            e_max, e_p99 = err.max().item(), quantile(err, 0.99)
            check(e_max < GREY_STEP and e_p99 < 0.01,
                  f"{what} vs plain: max {e_max} dB, p99 {e_p99} dB")
            dp = (got - par).abs()
            p_max, p_p99 = dp.max().item(), quantile(dp, 0.99)
            share = (dp > GREY_STEP).float().mean().item()
            check(share < FAST_SHARE, f"{what} vs parity kernel: {share} "
                  f"of bins more than {GREY_STEP} dB apart")
            max_err = max(max_err, e_max)
            ms, ms_i16 = cuda_ms(fast), cuda_ms(lambda: fast("i16"))
            plain_ms, par_ms = cuda_ms(plain), cuda_ms(parity)
            print(f"[fast] {sr:5d} Hz B={batch} frames {n_frames}: vs plain "
                  f"max {e_max:.3g} dB p99 {e_p99:.3g} dB, i16==f32; vs "
                  f"parity max {p_max:.3g} dB p99 {p_p99:.3g} dB share>"
                  f"{GREY_STEP} {share:.4f}; fast kernel {ms:.3f} ms (i16 "
                  f"{ms_i16:.3f}), plain {plain_ms:.3f} ms, parity kernel "
                  f"{par_ms:.3f} ms")
            if sr == 48000 and batch == 1:
                headline = (ms, plain_ms, f"{sr} Hz, B=1, f32, "
                            f"{n_frames} frames x {n_mel} mel",
                            *bound(K, "fast", x["f32"], ops16, n_frames))
        del wave, ops, ops16
        torch.cuda.empty_cache()
    return max_err, headline


def two_tone(sr):
    """tests/test_pallas_kernel.py:241-244's signal: 220 and 1367 Hz over
    faint noise, one second."""
    t = np.arange(sr) / sr
    noise = np.random.default_rng(sr).standard_normal(len(t))
    return (0.4 * np.sin(2 * np.pi * 220 * t)
            + 0.2 * np.sin(2 * np.pi * 1367 * t)
            + 0.005 * noise).astype(np.float32)


def phase_split(K, rng):
    """3c: the split-f32 kernel against its plain version, the parity and
    fast kernels, then the 30-minute A/B (its main path)."""
    from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center

    max_err, headline = 0.0, None
    for sr in RATES:
        win, hop, ops = operands(sr, "cuda")
        ops16, ops_s = K.operands_bf16(*ops), K.operands_split(*ops)
        i16 = make_signal(rng, sr, SECONDS, 2)
        n_frames = n_frames_for(i16.shape[1], win, hop)
        padded = np.stack([reflect_pad_center(x, win) for x in i16])
        wave = {
            "i16": torch.from_numpy(padded).cuda(),
            "f32": torch.from_numpy(
                padded.astype(np.float32) * np.float32(2.0**-15)).cuda(),
        }
        for batch in (1, 2):
            x = {k: (v[0] if batch == 1 else v) for k, v in wave.items()}
            kw = dict(win=win, hop=hop, n_frames=n_frames)

            def split(dtype="f32"):
                return K.mel_spectrogram_cuda(x[dtype], *ops_s, mode="split",
                                              **kw)

            def plain():
                return K.mel_spectrogram_plain(x["f32"], *ops_s,
                                               mode="split", **kw)

            def parity():
                return K.mel_spectrogram_cuda(x["f32"], *ops, **kw)

            def fast():
                return K.mel_spectrogram_cuda(x["f32"], *ops16, mode="fast",
                                              **kw)

            got_i16, got, want, par = split("i16"), split(), plain(), parity()
            torch.cuda.synchronize()
            n_mel = ops[2].shape[1]
            shape = (n_frames, n_mel) if batch == 1 else (2, n_frames, n_mel)
            what = f"{sr} Hz B={batch} split"
            check(tuple(got.shape) == shape, f"{what}: shape")
            check(bool(torch.isfinite(got).all()), f"{what}: finite")
            check(torch.equal(got_i16, got), f"{what}: int16 != f32 route")
            err, note = check_f32(got, want, f"{what} vs plain")
            max_err = max(max_err, err)
            dp = (got - par).abs()
            p_max, p_p99 = dp.max().item(), quantile(dp, 0.99)
            share = (dp > GREY_STEP).float().mean().item()
            check(p_p99 < 0.01 and share < SPLIT_SHARE,
                  f"{what} vs parity kernel: p99 {p_p99} dB, {share} of bins "
                  f"more than {GREY_STEP} dB apart")
            ms, ms_i16 = cuda_ms(split), cuda_ms(lambda: split("i16"))
            plain_ms, par_ms, fast_ms = (cuda_ms(plain), cuda_ms(parity),
                                         cuda_ms(fast))
            print(f"[split] {sr:5d} Hz B={batch} frames {n_frames}: vs plain "
                  f"max|err| {err:.3g} dB ({note}), i16==f32; vs parity max "
                  f"{p_max:.3g} dB p99 {p_p99:.3g} dB share>{GREY_STEP} "
                  f"{share:.2e}; split kernel {ms:.3f} ms (i16 {ms_i16:.3f}), "
                  f"plain {plain_ms:.3f} ms, parity kernel {par_ms:.3f} ms, "
                  f"fast kernel {fast_ms:.3f} ms")
            if sr == 48000 and batch == 1:
                headline = (ms, plain_ms, f"{sr} Hz, B=1, f32, "
                            f"{n_frames} frames x {n_mel} mel",
                            *bound(K, "split", x["f32"], ops_s, n_frames))
        del wave, ops, ops16, ops_s
        torch.cuda.empty_cache()

    for sr in (16000, 48000):  # the JAX test's own signal and bounds
        win, hop, ops = operands(sr, "cuda")
        n_frames = 128
        padded = reflect_pad_center(two_tone(sr), win)
        padded = np.pad(padded, (0, max(0, (n_frames - 1) * hop + win
                                        - len(padded))))
        x = torch.from_numpy(padded).cuda()
        kw = dict(win=win, hop=hop, n_frames=n_frames)
        par = K.mel_spectrogram_cuda(x, *ops, **kw)
        d_split = (K.mel_spectrogram_cuda(x, *K.operands_split(*ops),
                                          mode="split", **kw) - par).abs()
        d_fast = (K.mel_spectrogram_cuda(x, *K.operands_bf16(*ops),
                                         mode="fast", **kw) - par).abs()
        s_max, f_max = d_split.max().item(), d_fast.max().item()
        s_p99 = quantile(d_split, 0.99)
        check(s_max < GREY_STEP and s_max < f_max / 20,
              f"two-tone {sr} Hz: split max {s_max} dB, fast max {f_max} dB")
        print(f"[split] two-tone {sr} Hz, 128 frames, vs the parity kernel: "
              f"split max {s_max:.3g} dB p99 {s_p99:.3g} dB, fast max "
              f"{f_max:.3g} dB (split < fast/20)")
    launches, ab = split_ab(K, rng)
    return max_err, headline, launches, ab


def split_ab(K, rng, minutes=30, seg=32768):
    """tools/profile_split_tpu.py's A/B on the card: 30 minutes at 48 kHz,
    reflect-padded and resident on the device, in 32 768-frame segments;
    each mode's kernel over every segment, CUDA events, median of 3."""
    from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center

    sr = 48000
    win, hop, ops = operands(sr, "cuda")
    base = make_signal(rng, sr, 60.0, 4)
    gains = 0.3 + 0.6 * rng.random(minutes)
    i16 = np.concatenate([np.clip(base[m % 4] * gains[m], -32768, 32767)
                          .astype(np.int16) for m in range(minutes)])
    n_frames = n_frames_for(len(i16), win, hop)
    n_segs = -(-n_frames // seg)
    padded = reflect_pad_center(i16, win)
    need = n_segs * seg * hop + (win - hop)
    wave = torch.from_numpy(np.pad(padded, (0, need - len(padded)))).cuda()
    wave = wave.to(torch.float32) * 2.0**-15
    segs = [wave[i * seg * hop : i * seg * hop + seg * hop + (win - hop)]
            for i in range(n_segs)]
    mode_ops = {"parity": ops, "split": K.operands_split(*ops),
                "fast": K.operands_bf16(*ops)}
    outs = {m: torch.empty((n_segs * seg, ops[2].shape[1]), device="cuda")
            for m in mode_ops}

    def run(mode):
        for i, x in enumerate(segs):
            K.mel_spectrogram_cuda(x, *mode_ops[mode], win=win, hop=hop,
                                   n_frames=seg, mode=mode,
                                   out=outs[mode][i * seg : (i + 1) * seg])

    # ---- the split kernel's main path: the A/B itself
    torch.cuda.synchronize()
    reset_counts(K)
    ab = {m: cuda_ms(lambda: run(m), reps=3) for m in mode_ops}
    launches = read_counts(K)
    # ---- end of the main path
    check(launches == counts(4 * n_segs, 4 * n_segs, 4 * n_segs),
          f"A/B launches {launches}")
    d = (outs["split"] - outs["parity"])[:n_frames].abs()
    share = (d > GREY_STEP).float().mean().item()
    check(bool(torch.isfinite(outs["split"]).all())
          and quantile(d, 0.99) < 0.01 and share < SPLIT_SHARE,
          f"A/B split vs parity: share>{GREY_STEP} {share}")
    fps = {m: n_frames / (t / 1e3) for m, t in ab.items()}
    print(f"[split] A/B, {minutes} min at 48 kHz ({n_frames} frames, {n_segs} "
          f"device-resident segments of {seg}): " + "; ".join(
              f"{m} {ab[m]:.3f} ms = {fps[m] / 1e6:.3f} M frames/s"
              for m in mode_ops) + f"; split vs parity share>{GREY_STEP} "
          f"{share:.2e}")
    del wave, segs, outs
    torch.cuda.empty_cache()
    return launches, ab


def write_hour_wav(rng, path, sr=48000, minutes=60):
    """A mono PCM16 WAV written a minute at a time: four seeded swept-tone
    rows, each minute one of them at its own gain, over fresh noise."""
    import struct

    base = make_signal(rng, sr, 60.0, 4).astype(np.float32) / 32768.0
    n = base.shape[1]
    data = minutes * n * 2
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + data) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, 2 * sr, 2,
                                      16))
        f.write(b"data" + struct.pack("<I", data))
        for m in range(minutes):
            x = base[m % 4] * np.float32(0.3 + 0.6 * rng.random())
            x += np.float32(0.01) * rng.standard_normal(n, dtype=np.float32)
            f.write(np.clip(x * 32768, -32768, 32767).astype("<i2")
                    .tobytes())
    return minutes * n


def one_shot(K, src, scale, win, hop, n_frames, ops):
    """The whole reflect-padded wave in one parity kernel launch."""
    from msv_tpu_torch.ops.framing import reflect_pad_center

    padded = reflect_pad_center(src, win)
    if padded.dtype != np.int16 or scale != 2.0**-15:
        padded = padded.astype(np.float32) * np.float32(scale)
    x = torch.from_numpy(np.ascontiguousarray(padded)).cuda()
    return K.mel_spectrogram_cuda(x, *ops, win=win, hop=hop,
                                  n_frames=n_frames)


def phase_streaming(K, rng, minutes=60, stereo_s=480.0):
    from msv_tpu_torch import (MultiTrack, precision_mode_scope,
                               streaming_spec_db, streaming_spec_db_mmap)
    from msv_tpu_torch.io.audio import write_wav
    from msv_tpu_torch.kernels.pipeline import spec_pipeline
    from msv_tpu_torch.ops.framing import reflect_pad_center
    from msv_tpu_torch.parallel.streaming import _seg_plan_for
    from msv_tpu_torch.render.envelope import EnvelopeState
    from msv_tpu_torch.session.multitrack import STREAMING_FRAME_THRESHOLD

    with tempfile.TemporaryDirectory(prefix="msv_chip_stream_") as d:
        t0 = time.perf_counter()
        hour = os.path.join(d, "hour_48k_mono.wav")
        write_hour_wav(rng, hour, minutes=minutes)
        eight = os.path.join(d, "eight_min_44k1_stereo.wav")
        st = make_signal(rng, 44100, stereo_s, 2).astype(np.float32) / 32768.0
        write_wav(eight, st * 0.5, 44100, bits=16)
        del st
        print(f"[stream] wrote a {minutes} min 48 kHz mono and a "
              f"{stereo_s / 60:g} min 44.1 kHz stereo PCM16 WAV in "
              f"{time.perf_counter() - t0:.2f} s")

        # ---- the main path: the two long tracks, renders, the mmap entry
        torch.cuda.synchronize()
        reset_counts(K)
        t0 = time.perf_counter()
        mt = MultiTrack(device="cuda")
        mt.add_tracks([0, 1], [hour, eight])
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        img = mt.get_spec_image(0, 10.0, 500)
        img_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        crop = mt.get_spec_image_crop(0, 100.0, 500, 321.68, 333.68)
        crop_s = time.perf_counter() - t0
        env = mt._env_states[0]  # kept by streaming during add_tracks
        t0 = time.perf_counter()
        wimg = mt.get_wav_image(0, 10.0, 200, -1.0, 1.0)
        wimg_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        wcrop = mt.get_wav_image_crop(0, 100.0, 200, -1.0, 1.0, 321.68,
                                      333.68)
        wcrop_s = time.perf_counter() - t0
        tr0 = mt.tracks[0]
        t0 = time.perf_counter()
        mm_db, mm_n, mm_min, mm_max = streaming_spec_db_mmap(
            hour, tr0.win_length, tr0.hop_length,
            *mt._sr_operands(48000, "parity"))
        torch.cuda.synchronize()
        mmap_s = time.perf_counter() - t0
        launches = read_counts(K)
        # ---- end of the main path
        plans = {}
        for i in (0, 1):
            tr, s_ = mt.tracks[i], mt._state[i]
            plans[i] = _seg_plan_for(s_.n_frames, 4096, 8)
            check(s_.n_frames > STREAMING_FRAME_THRESHOLD
                  and s_.n_frames_pad == sum(plans[i]) * 4096,
                  f"track {i} did not stream: {s_.n_frames} frames, pad "
                  f"{s_.n_frames_pad}")
        n_seg = len(plans[0]) + len(plans[1])
        check(launches == counts(n_seg + len(plans[0])),
              f"streaming launches {launches}, segments {plans}")
        check(mt.tracks[1].wire == "f32"
              and mt.tracks[1]._wav_int.dtype == np.int32,
              "the stereo track is not the int32 carrier")
        check(img.shape == (500, 600 * minutes, 3) and img.dtype == np.uint8,
              f"hour image {img.shape}")
        check(crop.shape == (500, 1200, 3), f"crop {crop.shape}")
        # the hour's waveform: the device wave streaming shipped, adopted
        # during add_tracks and drawn without a second upload
        check(env.origin == "adopted" and mt._env_states[0] is env
              and env.offset == tr0.win_length // 2
              and env.dev.dtype == torch.int16,
              f"hour envelope: {env.origin}, offset {env.offset}")
        check(wimg.shape == (200, 600 * minutes, 4)
              and (wimg[..., 3] > 0).any(axis=0).all(),
              f"hour waveform image {wimg.shape}")
        # the same crop from the wave uploaded anew, as a one-shot track's
        mt._env_states[0] = EnvelopeState(None, tr0._wav_int,
                                          n=tr0.n_samples, scale=tr0.scale,
                                          device="cuda")
        check(np.array_equal(wcrop, mt.get_wav_image_crop(
            0, 100.0, 200, -1.0, 1.0, 321.68, 333.68)),
              "hour waveform crop: adopted != uploaded wave")
        mt._env_states[0] = env

        s0 = mt._state[0]
        check(torch.equal(mm_db, s0.spec_db) and mm_n == s0.n_frames
              and (mm_min, mm_max) == (s0.smin, s0.smax),
              "streaming_spec_db_mmap != the session's plane")
        errs, equal = [], []
        for i in (0, 1):
            tr, s_ = mt.tracks[i], mt._state[i]
            ref = one_shot(K, tr._wav_int, tr.scale, tr.win_length,
                           tr.hop_length, s_.n_frames,
                           mt._sr_operands(tr.sr, "parity"))
            got = s_.spec_db[: s_.n_frames]
            errs.append((got - ref).abs().max().item())
            equal.append(torch.equal(got, ref))
            check(bool(torch.isfinite(got).all())
                  and torch.allclose(got, ref, atol=ATOL, rtol=RTOL),
                  f"track {i}: streamed vs one-shot max err {errs[-1]}")
            del ref
        stages = {k: v["total_s"] for k, v in mt.timer.summary().items()}
        audio_s = mt.tracks[0].sec + mt.tracks[1].sec
        print(f"[stream] add_tracks ({minutes} min + {stereo_s / 60:g} min, "
              f"{n_seg} segments) "
              f"{add_s:.3f} s = {audio_s / add_s:.0f} audio-s/s; stages, "
              f"host clock: {json.dumps(stages)}")
        print(f"[stream] streamed vs one-shot kernel: max|err| hour "
              f"{errs[0]:.3g} dB (bit-equal {equal[0]}), 8 min "
              f"{errs[1]:.3g} dB (bit-equal {equal[1]}); mmap == session; "
              f"500x{600 * minutes} image {img_s:.3f} s; 1200-px crop across the "
              f"327.68 s segment boundary {crop_s:.3f} s; mmap streaming of "
              f"the hour {mmap_s:.3f} s")
        print(f"[stream] the hour's waveform from the adopted streamed wave "
              f"(no second upload): 200x{600 * minutes} image {wimg_s:.3f} s,"
              f" 1200-px crop {wcrop_s:.3f} s, equal to the crop of an "
              f"uploaded wave")
        # what keeping the streamed wave costs the hour (host clock, in
        # turns: off, on, on, off)
        keep = {False: [], True: []}
        for kw in (False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = streaming_spec_db(tr0._wav_int, tr0.win_length,
                                    tr0.hop_length,
                                    *mt._sr_operands(48000, "parity"),
                                    keep_wav=kw)
            torch.cuda.synchronize()
            keep[kw].append(time.perf_counter() - t0)
            del out
        print(f"[stream] the hour's streaming_spec_db, host clock: keep_wav="
              f"False {keep[False][0]:.3f} / {keep[False][1]:.3f} s, keep_wav="
              f"True {keep[True][0]:.3f} / {keep[True][1]:.3f} s")

        # ---- the fast path: both tracks under precision_mode_scope("fast")
        torch.cuda.synchronize()
        reset_counts(K)
        t0 = time.perf_counter()
        with precision_mode_scope("fast"):
            mf = MultiTrack(device="cuda")
            mf.add_tracks([0, 1], [hour, eight])
        torch.cuda.synchronize()
        fast_s = time.perf_counter() - t0
        img_f = mf.get_spec_image(0, 10.0, 500, wire="rgb")
        fast_launches = read_counts(K)
        check(img_f.shape == img.shape, f"fast hour image {img_f.shape}")
        # ---- end of the fast path
        check(fast_launches == counts(fast=n_seg),
              f"fast streaming launches {fast_launches}")
        d = (mf._state[0].spec_db - s0.spec_db)[: s0.n_frames].abs()
        p_max, p_p99 = d.max().item(), quantile(d, 0.99)
        share = (d > GREY_STEP).float().mean().item()
        check(share < FAST_SHARE, f"fast hour vs parity: {share} of bins "
              f"more than {GREY_STEP} dB apart")
        print(f"[stream] fast mode: add (both tracks, {n_seg} fast "
              f"launches) {fast_s:.3f} s; hour vs parity max {p_max:.3g} dB, "
              f"p99 {p_p99:.3g} dB, share>{GREY_STEP} {share:.4f}; dB range "
              f"fast [{mf.get_min_db():.3f}, {mf.get_max_db():.3f}] vs parity "
              f"[{mt.get_min_db():.3f}, {mt.get_max_db():.3f}]")
        del mf, mm_db

        # ---- the 8-minute track through linear streaming (no filterbank)
        tr1 = mt.tracks[1]
        c, s, _ = mt._sr_operands(tr1.sr, "parity")
        win, hop = tr1.win_length, tr1.hop_length
        del mt
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        reset_counts(K)
        t0 = time.perf_counter()
        ldb, lnf, lmin, lmax = streaming_spec_db(tr1._wav_int, win, hop, c, s,
                                                 None, scale=tr1.scale)
        torch.cuda.synchronize()
        lin_s = time.perf_counter() - t0
        lin_launches = read_counts(K)
        check(lin_launches == counts(), f"linear streaming {lin_launches}")
        padded = torch.from_numpy(reflect_pad_center(
            tr1._wav_int, win).astype(np.float32) * np.float32(tr1.scale))
        one, omin, omax = spec_pipeline(padded.cuda(), c, s, None, lnf,
                                        win=win, hop=hop, n_frames=lnf,
                                        use_mel=False, mode="parity")
        check(ldb.shape[1] == tr1.n_fft // 2 + 1
              and bool(torch.isfinite(ldb[:lnf]).all()),
              f"linear streamed plane {tuple(ldb.shape)}")
        lerr, lnote = check_f32(ldb[:lnf], one,
                                "8 min linear: streamed vs one-shot")
        check(abs(lmax - omax.item()) <= ATOL + RTOL * abs(omax.item()),
              f"8 min linear max dB {lmax} vs {omax.item()}")
        print(f"[stream] 8 min 44.1 kHz stereo through linear streaming "
              f"({lnf} frames x {ldb.shape[1]} bins, no kernel launch) "
              f"{lin_s:.3f} s; vs one one-shot spec_pipeline max|err| "
              f"{lerr:.3g} dB ({lnote}); dB range [{lmin:.3f}, {lmax:.3f}]")
        del ldb, one, padded
        torch.cuda.empty_cache()
        return launches, fast_launches, lin_launches


def phase_features(K, rng):
    from msv_tpu_torch import features, log_mel_spectrogram
    from msv_tpu_torch.utils import next_pow2

    shapes = [  # (name, sr, batch, seconds, n_mel, win_ms, hop_ms)
        ("b4_4s_48k", 48000, 4, 4.0, 128, 40.0, 10.0),
        ("b64_10s_16k", 16000, 64, 10.0, 128, 25.0, 10.0),
    ]
    xs = {name: torch.from_numpy(
        (rng.standard_normal((b, int(sec * sr))) * 0.3).astype(np.float32)
        + make_signal(rng, sr, sec, b).astype(np.float32) / 65536.0).cuda()
        for name, sr, b, sec, *_ in shapes}

    def call(name, precision=None):
        _, sr, _, _, n_mel, win_ms, hop_ms = next(s for s in shapes
                                                  if s[0] == name)
        return log_mel_spectrogram(xs[name], sr, n_mel=n_mel, win_ms=win_ms,
                                   hop_ms=hop_ms, precision=precision)

    # ---- the main path: each shape by default (fast), then parity
    torch.cuda.synchronize()
    reset_counts(K)
    outs = {}
    for name, *_ in shapes:
        outs[name, "fast"] = call(name)
        check(K.LAUNCHES_BY_MODE == counts(fast=len(outs)),
              f"{name}: default features launched {K.LAUNCHES_BY_MODE}")
    for name, *_ in shapes:
        outs[name, "parity"] = call(name, "parity")
    launches = read_counts(K)
    # ---- end of the main path
    check(launches == counts(2, 2), f"features {launches}")
    for name, sr, b, sec, n_mel, win_ms, hop_ms in shapes:
        win, hop = round(win_ms * sr / 1000), round(hop_ms * sr / 1000)
        padded = features.pad_batch(xs[name], win)
        n_frames = outs[name, "fast"].shape[1]
        res = {}
        for mode in ("fast", "parity"):
            ops = features.feature_operands(sr, win, next_pow2(win), n_mel,
                                            0.0, None, "slaney", "parity",
                                            xs[name].device)
            want = K.mel_spectrogram_plain(padded, *ops, win=win, hop=hop,
                                           n_frames=n_frames, mode=mode)
            got = outs[name, mode]
            check(tuple(got.shape) == (b, n_frames, n_mel)
                  and bool(torch.isfinite(got).all()), f"{name} {mode} shape")
            err = (got - want).abs()
            if mode == "fast":
                e_max, e_p99 = err.max().item(), quantile(err, 0.99)
                check(e_max < GREY_STEP and e_p99 < 0.01,
                      f"{name} fast vs plain: max {e_max} dB, p99 {e_p99} dB")
            else:
                check_f32(got, want, f"{name} parity vs plain")
            res[mode] = (err.max().item(), quantile(err, 0.99),
                         cuda_ms(lambda: call(name, mode)),
                         cuda_ms(lambda: K.mel_spectrogram_plain(
                             features.pad_batch(xs[name], win), *ops,
                             win=win, hop=hop, n_frames=n_frames,
                             mode=mode)))
        frames_total = b * n_frames
        print(f"[features] {name} ({b} x {sec:.0f} s, {sr} Hz, n_mel "
              f"{n_mel}, {win}/{hop}): " + "; ".join(
                  f"{m}: max|err| {e:.3g} dB p99 {q:.3g} dB, call {ms:.3f} ms "
                  f"({frames_total / ms / 1e3:.2f} M frames/s), plain "
                  f"{pms:.3f} ms" for m, (e, q, ms, pms) in res.items()))
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    from msv_tpu_torch.kernels import spectrogram_cuda as K

    smi = phase_device()
    phase_build(K)
    rng = np.random.default_rng(SEED)
    heads = {}
    errs = {}
    errs["parity"], heads["parity"] = phase_kernel(K, rng)
    session = phase_session(K, rng)
    # the later phases draw from their own streams (no check depends on
    # the signals drawn: see f32_agree)
    errs["fast"], heads["fast"] = phase_fast(K,
                                             np.random.default_rng(SEED + 1))
    errs["split"], heads["split"], split_path, _ = phase_split(
        K, np.random.default_rng(SEED + 4))
    paths = [*session, *phase_streaming(K, np.random.default_rng(SEED + 2)),
             phase_features(K, np.random.default_rng(SEED + 3)), split_path]
    launches = {m: sum(p[m] for p in paths) for m in K.MODES}
    print(f"[launches] main-path launches by path (session, fast session, "
          f"linear session, streaming, fast streaming, linear streaming, "
          f"features, split A/B): {paths}")
    kernels = []
    for mode, name, line in (("parity", "mel_spectrogram", 411),
                             ("fast", "mel_spectrogram_bf16", 411),
                             ("split", "mel_spectrogram_split", 446)):
        ms, plain_ms, shape, bound_ms, bound_by = heads[mode]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": os.path.relpath(K.SOURCES[mode]),
            "replaces": f"msv_tpu/kernels/spectrogram_pallas.py:{line}",
            "launches": launches[mode],
            "max_abs_err": errs[mode],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call computes the fused mel dB function
            "library_ms": None,
            "shape": shape,
            "card": smi,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
