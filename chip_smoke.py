#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (msv_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing its lines:
  1. device   the card's name and power limit (nvidia-smi), torch, CUDA and
              nvcc versions;
  2. build    compiles the three mel dB kernels (f32 parity in 3xTF32,
              bf16 fast, split-f32 on wgmma) from csrc/ into one library
              with nvcc,
              and prints -Xptxas -v's registers and spills of each
              instantiation;
  3. kernel   the parity kernel (on operands laid out once by
              prepare_operands, as the session caches them; so in 3b and
              3c) against its plain PyTorch version at all
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
              kernel (on a record laid out once by prepare_operands) against
              its plain version (mode="split") at phase 3's
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
  3d. survey  (run after phase 3c, on its own seeded stream) the parity
              and bf16 kernels at 384, 250 and 192 kHz (windows of 15 360,
              10 000 and 7680 samples, n_fft 16 384, 16 384 and 8192) on
              300 s of audio per row (30 001 frames), f32 and int16 input,
              batch 1 and 2: the tier each launch takes, as tier_for says
              (parity the FFT tier at all three, on the record the session
              makes, without C or S; fast resident at 192 and 250 kHz,
              chunked at 384), int16 bit-equal to f32, batch rows
              independent; parity against its plain version by f32_agree
              or, where a bin fails it, within twice the plain version's own
              f32 error at that window (its largest distance from a float64
              witness on the card, in amplitude relative to the frame's
              peak: window_agree), which the bf16 kernel fails; fast
              against its plain version as in 3b; times of both kernels
              (f32 and int16 input, B = 1) and the plain versions at each
              rate, the FFT tier beside its bound and beside
              torch.fft.rfft + magnitude + mel + dB (library_ms, the
              yardstick: the port never calls it); the parity chunked
              tier as the FFT tier, at 176.4 kHz and f_overlap 3 (n_fft
              24 576: no FFT plan), 300 s a row, its time beside its bound
              and the plain version, and a session of one such file whose
              launch takes it; then the survey session
              (the benchmark's survey384k: four 300 s mono PCM16 WAVs at
              384, 250, 192 and 48 kHz) in MultiTrack(device="cuda")
              .add_tracks, in parity and in fast, its launches by tier
              counted (its main path: parity 3 FFT and 1 resident), no C
              or S built at the parity session's FFT-tier rates, and each
              plane equal to the kernel's on the session's padded wave;
              then the FFT tier's linear form (linear_db_fft_kernel) at
              384, 250, 192 and 96 kHz (n_fft 16 384, 16 384, 8192 and
              4096), 300 s a row, f32 and int16 input, batch 1 and 2, on a
              LinearRoute's record: each launch fft, int16 bit-equal to f32,
              rows independent, against the dense pair in true f32
              (spec_pipeline) as the mel FFT tier against its plain
              version, its time beside its bound, the pair's and
              torch.fft.rfft + magnitude + dB's; and the survey session on
              the linear scale, its linear launches by tier counted from
              zero (3 fft, 1 gemm), no C or S built at 384, 250 and 192 kHz,
              each plane its route's on the session's padded wave;
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
              u8 step); the seven tracks on the linear scale under
              precision_mode_scope("fast") (TF32 GEMMs, no launch), under
              FAST_SHARE of bins more than 0.47 dB from the parity linear
              planes; a save_session / load_session round trip; which
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
              0.01 dB; parity: f32_agree);
  7. residency with the process's TF32 flags on: an unbounded session of
              phase 4's seven WAVs renders phase 4's images exactly, and
              sizes the budget at 3.5 times one rendered 48 kHz track's
              device bytes; under that budget (the main path) add_tracks,
              a spill of a grouped track that frees its plane's device
              memory, a full-width spectrogram and waveform sweep equal to
              phase 4's images with the resident bytes within the budget
              after each render; the streamed hour of phase 5 spilled (plane
              and adopted wave freed) and re-uploaded, its crop and waveform
              crop equal before and after; adaptive crops of the 48 kHz
              track (three adjacent 1200-px crops equal to their union, a
              zoomed-out crop through the cached build equal to the
              slice-local one) and of the hour (block=False pending, the
              whole background build, cached == slice-local); the 10 s
              track's adaptive plane against the CPU port's (within 60 dB of
              the frame peak: max < 0.47 dB, p99 < 0.01 dB);
  8. frontends the command line (msv_tpu_torch.cli.main in this process)
              and the web viewer on phases 4 and 5's WAVs: render of the
              seven songs with --save-db (6 parity launches), --fast (6
              fast) and --freq-scale linear (none), each PNG and dB plane
              equal to a direct session's; encode_png of one full-width
              image timed alone; render --start/--end of the hour over 12 s
              across its third segment boundary (one launch per segment);
              render --adaptive --save-db of the 48 kHz song (plane against
              multires_mel_spec_db by f32_agree, PNG equal to the render of
              its plane); features --kind logmel of the 44.1 kHz song (the
              card's resample within 2e-5 of the CPU's, one fast launch,
              the .npy equal to log_mel_spectrogram); resample --sr 16000
              of the 8-minute stereo file (equal to resample_streamed);
              serve_viewer on the seven songs and the hour on a loopback
              port (its load, /api/setting linear and back to mel, POST
              /api/add and /api/channel of the 8-minute file each counted),
              every image response equal to a direct session's with the
              same history, the zoomed-out adaptive crop of the hour 202
              then 200, a cache hit without a render, a Range request,
              POST /api/process of an unknown op 400, request latencies
              over 20 distinct 1200-column crops (misses) and again
              (hits); then python -m
              msv_tpu_torch render and view in processes of their own, and
              a missing file (exit 1, "error:");
  9. analysis  (slice 8) filter of the hour and the 8-minute stereo file
              (a 4th-order Butterworth band-pass and a high shelf),
              forward and --zero-phase, each within 5e-5 of the input's
              peak of scipy's f64 sosfilt / sosfiltfilt, and the 10 s track
              card vs CPU within 2e-5; reconstruct of phase 8's mel export
              of the 48 kHz song (32 iterations): spectral convergence
              under the CPU's on the 10 s track + SC_MARGIN, the WAV equal
              to griffin_lim on the card, two card runs bit-equal, one
              iteration card vs CPU within 1e-4 of the peak; features
              --kind mfcc, chroma, spectral, whisper, pcen, contrast,
              tempogram, onsets, beats of the seven songs (resampled to 16
              kHz), each .npy equal to the library call and the 10 s track
              card vs CPU in parity within its port test's tolerance (mfcc: the
              f32 dot-product error bound of its DCT); info --loudness
              and gain --lufs -23 of the songs and the hour (the gained
              song re-measures -23 LUFS), LUFS and LRA card vs CPU within
              0.01 LU and the true peak within 1e-4 dB on the 10 s track;
              phase 8's viewer: /api/onsets, /api/beats and /api/loudness
              of the songs and the hour, each equal to the direct call,
              the second request a cache hit, first-request p50/p90.  No
              leg of phase 9 launches a mel kernel.
 10. analysis 2  features --kind f0, f0v, tonnetz, key, lpcenv,
              formants and segments of the seven songs (resampled to 16
              kHz), each .npy equal to the library call, the 10 s track
              card vs CPU in parity within its port test's tolerance (lpcenv
              by its LPC coefficients, and its envelope within LPCENV_DB:
              the envelope's deep nulls follow the coefficients' rounding);
              features --kind segments of the hour
              (7 200 pooled frames: the full-size similarity matrix), one
              fast launch, and one parity launch under
              precision_mode_scope("parity"), with the SSM and novelty GEMMs
              timed apart; features --kind f0v of the 8-minute file, YIN and
              the two Viterbi decodes timed apart, the pitch decode with and
              without CUDA graphs (paths equal); transcribe of a seeded
              eight-note melody (midi recovered, .json and .mid equal to the
              library call); stretch --rate 0.5 and --semitones 3 of the
              48 kHz song's channel 0 (peak frequency within
              tests/test_effects.py's bound, two card runs bit-equal, the 10
              s track card vs CPU within tests/test_torch_effects.py's
              bounds); trim of a song
              padded with silence; align of the 48 kHz song against a copy
              delayed by a seeded offset (recovered within 1e-3 s); dtw on
              the chroma of two songs, card vs CPU; phase 8's viewer:
              /api/pitch (plain and smooth=1), /api/formants, /api/segments,
              /api/notes, /api/key and /api/align over the songs and
              windows of the hour, each equal to the direct call, the second
              request a cache hit, first-request p50/p90; then /api/pitch
              smooth=1 and /api/notes from eight threads among spec, wav
              and adaptive crops, the Viterbi graph cache emptied first,
              every answer equal to the one-at-a-time answer.  Only the
              segments legs launch a mel kernel (one fast launch a file or
              window).
 11. analysis 3  hpss, separate --components 4, denoise, declick (on a
              copy with planted clicks, every one repaired) and specedit
              (a gain box and a patch box) of the 48 kHz song, each WAV
              equal to the library call, the wall beside the library
              call's own time; h + p within HPSS_SUM of the input's peak,
              the parts' sum within SEPARATE_ATOL; hpss and denoise of the
              hour with the peak device memory; analyze of the seven songs
              (one fast launch each, through segment; the 48 kHz report
              equal to the library call); features --kind mtspec and
              reassigned of the songs (.npy equal to the library call,
              reassigned bit-equal over two card runs); cqt of the 48 kHz
              song (32 768-sample frames in blocks: its wall and peak
              device memory, under a quarter of the whole frame matrix);
              the 10 s track card vs CPU at the port tests' bounds (hpss,
              separate at 3 iterations, denoise, specedit, declick with
              equal spans, cqt, multitaper power, reassigned totals,
              analyze field by field); phase 8's viewer: POST
              /api/process of each of the six ops on the 48 kHz song (one
              parity launch each: the derived track's add), the derived
              audio equal to the library call's and a crop rendered, a
              bad op 400, an unknown track 404; GET /api/analyze of the
              song and of the hour's first 600 s polled from 202 to 200
              (one fast launch each, reports equal to the direct call), 20
              crop misses of the hour timed while the hour's job runs,
              every image equal to one at a time.
 12. slice 11  the batch loader: extract_features over 96 seeded 30 s
              mono PCM16 WAVs (16 at each of the six rates) and two 20 s
              (padded) and two 40 s (truncated) clips, at Whisper's width
              (whisper_log_mel, batches of 16, four decode threads; its
              power mel is torch ops: no launch), rows and ClipMetas equal
              to the direct decode -> resample -> whisper_log_mel of each
              batch's group, then with log_mel_spectrogram (one fast launch
              a batch), three clips card vs CPU (whisper within 3e-4, log-mel
              within the fast bound); wall, clips/s, the pool's summed
              decode time and the feature calls' CUDA-event time; the
              engine: the seven songs under set_engine("xla") (no launch,
              planes by f32_agree against "auto"), render --engine xla (PNGs
              equal to the "xla" session's images), both sessions'
              add_tracks.kernel_minmax stage times; the mesh on one card
              (meshes listing cuda:0 1, 4 or 8 times: overhead, not
              scaling): sharded_spec_pipeline of 8 x 240 s at 48 kHz on
              (1, 1) and (2, 4) against the unsharded plain pipeline
              (f32_agree, range within 1e-3 dB), sharded_streaming_spec_db of
              phase 5's hour on (1, 1) and (1, 4) against streaming_spec_db
              (f32_agree), freq_sharded_spec of the 48 kHz song, mel and
              linear, on (1, 1) and (1, 4), sharded_envelope_minmax of the
              hour at 1200 and 4096 columns bit-equal to the single-device
              envelope, log_mel_spectrogram of a dp-split 8 x 30 s batch
              (one fast launch a shard, equal to the unsplit call), each wall
              beside its unsharded twin; initialize_distributed at world
              size 1 on NCCL (a free localhost port), make_global_mesh(1, 1)
              and one sharded_spec_pipeline step equal to the step without a
              process group.
 13. wire     the wire codec (slice 12): the codec library's build (g++
              command, seconds) and the host codec calls by route (PACKS,
              before and after: the numpy codec must not run); phase 5's
              hour through streaming_spec_db with transfer raw, pack, pack1
              and raw again in parity, then raw and pack in fast, each
              plane and range equal to raw's (one launch a segment), with
              its wall, wire bytes and host pack seconds; one 8-chunk
              segment of the hour (int16 by v1 and by pack_best, an f32
              source and an int32 carrier by pack_best) and of two tones
              (the LPC stream), each unpacked on the card bit-equal to
              unpack2_np and to the samples, the device unpack timed
              (CUDA events, median of 5; the LPC recurrence graphed and
              eager); get_spec_db at q16, q12, q10 and q8 of the seven
              songs (a fresh session: 6 parity launches) and of the hour
              (11): each within grid_bound of the f32 export, the card's
              words equal to pack_spec of the same plane on the CPU and
              the export equal to unpack_spec_np of them (q10 for every
              track, every width for the 48 kHz song), fetched bytes, the
              pack and fetch_unpack stages beside the f32 export, and the
              hour's peak device memory per width; render --save-db
              --db-wire q10 of the songs (6 parity launches), each .npy
              equal to get_spec_db(wire="q10").
Each path of phases 3c-13 (3d's survey sessions too) is driven with the launch counts set to 0 just
before it and read just after; comparisons run outside those windows.  The
second-to-last line is a JSON object describing each kernel (its bound is
computed from this run's shapes against the H100 SXM's published peaks);
the last line is {"ok": true, "device": {...}}.  Exits non-zero, printing
neither, without a CUDA device or when any check fails.

What bounds each kernel is measured apart by msv_tpu_torch/kernels/probe.py
(source variants without the ring, the products or the SIMT passes).
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
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
# its HBM3 rate: the roofline of the kernels line.  The parity kernel's DFT
# pair runs on the tensor cores in 3xTF32 (three TF32 products each), its
# mel product in SIMT f32; "simt" is the f32 rate outside the tensor cores.
PEAK_FLOPS = {"parity": 495e12, "fast": 989e12, "split": 989e12,
              "simt": 67e12}
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
    for tier in K.LAUNCHES_BY_TIER:
        K.LAUNCHES_BY_TIER[tier] = 0
    for tier in K.LINEAR_LAUNCHES_BY_TIER:
        K.LINEAR_LAUNCHES_BY_TIER[tier] = 0


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
    mode's peak rate.  Parity: three TF32 products per DFT product at the
    TF32 peak, and the mel product at the SIMT f32 rate."""
    win, n_freq = ops[0].shape[-2:]
    n_mel = ops[2].shape[-1]
    bands = K.mel_bands(ops[2])
    band_bins = int((bands[:, 1] - bands[:, 0]).sum())
    rows = 1 if padded.ndim == 1 else padded.shape[0]
    dft = 2 * rows * n_frames * 2 * win * n_freq
    mel = 2 * rows * n_frames * band_bins
    if mode == "parity":
        t_ops = 3 * dft / PEAK_FLOPS["parity"] + mel / PEAK_FLOPS["simt"]
    else:
        t_ops = (3 if mode == "split" else 1) * (dft + mel) / PEAK_FLOPS[mode]
    nbytes = (sum(t.numel() * t.element_size() for t in (padded, *ops))
              + 4 * rows * n_frames * n_mel)
    t_bytes = nbytes / HBM_BYTES_PER_S
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


def png_pixels(data):
    """The pixels of a PNG that io/png.py wrote ((H, W, C) uint8; 8-bit
    grey, RGB or RGBA, filter byte 0 on every scanline), from its bytes or
    its path, decoded with zlib alone (the card's machine has no PIL)."""
    import struct
    import zlib

    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            head = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat.append(body)
    w, h, depth, ctype = head
    check(depth == 8 and ctype in (0, 2, 6), f"PNG depth {depth} type {ctype}")
    ch = {0: 1, 2: 3, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * ch)
    check(bool((raw[:, 0] == 0).all()), "PNG scanline filter is not 0")
    img = raw[:, 1:].reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


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


def build_report(text):
    """ptxas's registers and spills of each kernel instantiation, from
    ``-Xptxas -v``'s output: [(kernel<sample type, m-tiles>, usage)]."""
    import re

    out, name = [], None
    for ln in text.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            spill = ""
            k = re.search(r"(mel_db_\w+?_kernel)I([a-z])Li(\d+)E", m.group(1))
            name = (f"{k.group(1)}<{ {'f': 'float', 's': 'int16'}[k.group(2)]},"
                    f" {k.group(3)}>" if k else m.group(1))
        elif name and "spill" in ln:
            spill = ln.split(":", 1)[-1].strip()
        elif name and "Used" in ln and "registers" in ln:
            out.append((name, f"{ln.split(':', 1)[-1].strip()}; {spill}"))
            name = None
    return out


def phase_build(K):
    t0 = time.perf_counter()
    K.build()
    dt = time.perf_counter() - t0
    srcs = " + ".join(os.path.relpath(K.SOURCES[m]) for m in K.MODES)
    print(f"[build] {srcs} in {dt:.2f} s (nvcc {' '.join(K.NVCC_FLAGS)})")
    for name, usage in build_report(K.BUILD_REPORT):
        print(f"[build]   {name}: {usage}")


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


def session_route(tr, device="cuda"):
    """The ``MelRoute`` a session on ``device`` makes for track ``tr``'s
    rate: the default window and filterbank at the track's window, hop and
    n_fft."""
    from msv_tpu_torch.kernels.spectrogram_cuda import MelRoute
    from msv_tpu_torch.ops.mel import calc_mel_fb_default
    from msv_tpu_torch.ops.windows import default_stft_window

    return MelRoute(default_stft_window(tr.win_length, tr.n_fft),
                    calc_mel_fb_default(tr.sr, tr.n_fft), win=tr.win_length,
                    hop=tr.hop_length, n_fft=tr.n_fft, device=device)


def host_padded(tr):
    """(padded, n_frames, n_frames_pad): a session track's kernel input
    built on the host, the reference of the batch row the session
    assembles on the device: ``reflect_pad_center``, a zero tail to
    n_frames_pad frames (or a cut), and for the "f32" wire an integer
    carrier cast to f32 and scaled."""
    from msv_tpu_torch.ops.framing import reflect_pad_center
    from msv_tpu_torch.session.multitrack import _frame_counts

    n_frames, n_frames_pad = _frame_counts(tr)
    need = (n_frames_pad - 1) * tr.hop_length + tr.win_length
    src = (tr._wav_int if tr._wav_int is not None
           else np.asarray(tr.wav, np.float32))
    padded = reflect_pad_center(src, tr.win_length)
    padded = np.pad(padded, (0, max(0, need - len(padded))))[:need]
    if tr.wire == "f32" and padded.dtype != np.float32:
        padded = padded.astype(np.float32) * np.float32(tr.scale)
    return padded, n_frames, n_frames_pad


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
        prepared = K.prepare_operands(*ops, "parity")
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
                return K.mel_spectrogram_cuda(x[dtype], prepared, win=win,
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
        del wave, ops, prepared
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


def phase_session(K, rng, work):
    from msv_tpu_torch import (FreqScale, MultiTrack, SpecSetting,
                               precision_mode_scope)
    from msv_tpu_torch.io import _native_audio as NA
    from msv_tpu_torch.io.audio import open_audio_file_ex
    from msv_tpu_torch.ops.framing import n_frames_for
    from msv_tpu_torch.session.multitrack import FRAME_BUCKET
    from msv_tpu_torch.utils import round_up_to

    # the WAVs stay in ``work`` for phase 7
    with tempfile.TemporaryDirectory(prefix="msv_chip_smoke_", dir=work,
                                     delete=False) as d:
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
        imgs = {}
        for i in ids:
            img = imgs[i] = mt.get_spec_image(i, 100.0, 500)
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
        padded10, nf10, _ = host_padded(tr10)
        wit = f64_witness(padded10, *operands(tr10.sr, "cpu")[2],
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
        padded, nf, _ = host_padded(tr)
        want = K.mel_spectrogram_plain(
            torch.from_numpy(padded).cuda(), *operands(tr.sr, "cuda")[2],
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

        # ---- the linear scale in fast mode: TF32 GEMMs, no kernel launch
        torch.cuda.synchronize()
        reset_counts(K)
        t0 = time.perf_counter()
        with precision_mode_scope("fast"):
            ml = MultiTrack(linear, device="cuda")
            ml.add_tracks(ids, paths)
        torch.cuda.synchronize()
        lfast_s = time.perf_counter() - t0
        lfast_launches = read_counts(K)
        # ---- end of the fast linear path
        check(lfast_launches == counts(), f"the fast linear session launched "
              f"a mel kernel: {lfast_launches}")
        lshares = [((ml._state[i].spec_db - mt._state[i].spec_db)
                    [: mt._state[i].n_frames].abs() > GREY_STEP)
                   .float().mean().item() for i in ids]
        check(max(lshares) < FAST_SHARE, f"fast linear session vs parity: "
              f"shares {lshares} of bins more than {GREY_STEP} dB apart")
        print(f"[session] linear scale in fast mode (TF32 GEMMs): add "
              f"({len(ids)} tracks, no kernel launch) {lfast_s:.3f} s; vs the "
              f"parity linear planes share>{GREY_STEP} {min(lshares):.4f}-"
              f"{max(lshares):.4f} (bound {FAST_SHARE})")
        del ml

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
        return ((launches, fast_launches, lin_launches, lfast_launches),
                (paths, p10, imgs, wav_imgs))


def phase_fast(K, rng):
    """3b: the bf16 kernel against its plain version and the parity
    kernel."""
    from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center

    max_err, headline, rows = 0.0, None, []
    for sr in RATES:
        win, hop, ops = operands(sr, "cuda")
        ops16 = K.operands_bf16(*ops)
        rec, rec16 = (K.prepare_operands(*ops, "parity"),
                      K.prepare_operands(*ops16, "fast"))
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
                return K.mel_spectrogram_cuda(x[dtype], rec16, mode="fast",
                                              **kw)

            def plain():
                return K.mel_spectrogram_plain(x["f32"], *ops, mode="fast",
                                               **kw)

            def parity():
                return K.mel_spectrogram_cuda(x["f32"], rec, **kw)

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
        del wave, ops, ops16, rec, rec16
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
        rec, rec16, rec_s = (K.prepare_operands(*ops, "parity"),
                             K.prepare_operands(*ops16, "fast"),
                             K.prepare_operands(*ops_s, "split"))
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
                return K.mel_spectrogram_cuda(x[dtype], rec_s, mode="split",
                                              **kw)

            def plain():
                return K.mel_spectrogram_plain(x["f32"], *ops_s,
                                               mode="split", **kw)

            def parity():
                return K.mel_spectrogram_cuda(x["f32"], rec, **kw)

            def fast():
                return K.mel_spectrogram_cuda(x["f32"], rec16, mode="fast",
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
        del wave, ops, ops16, ops_s, rec, rec16, rec_s
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
    # every kernel takes its operands prepared once
    mode_ops = {"parity": K.prepare_operands(*ops, "parity"),
                "split": K.prepare_operands(*K.operands_split(*ops), "split"),
                "fast": K.prepare_operands(*K.operands_bf16(*ops), "fast")}
    outs = {m: torch.empty((n_segs * seg, ops[2].shape[1]), device="cuda")
            for m in mode_ops}

    def run(mode):
        for i, x in enumerate(segs):
            K.mel_spectrogram_cuda(x, mode_ops[mode], win=win, hop=hop,
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


# The survey session's rates whose windows (7056 samples and more) no
# resident parity block holds, 300 s a row as the benchmark's survey384k
# files (30 001 frames), and the tier each kernel takes there.
SURVEY_RATES = [384000, 250000, 192000]
SURVEY_SECONDS = 300.0
SURVEY_TIER = {"parity": {sr: "fft" for sr in SURVEY_RATES},
               "fast": {384000: "chunked", 250000: "resident",
                        192000: "resident"}}
# frames per block of the plain version and the f64 witness in 3d
WINDOW_BLOCK = 4096


def f64_witness_cuda(x, c, s, fb, win, hop, n_frames):
    """f64_witness on the card, for windows too long for the host: the
    kernels' function in float64 torch on a (..., L) wave (int16 or f32)
    and the float64 copies of the f32 (C, S, fb); ``fb`` None is the
    linear scale, every bin's dB."""
    x = x.double() * (2.0**-15 if x.dtype == torch.int16 else 1.0)
    fr = x.unfold(-1, win, hop)[..., :n_frames, :]
    re, im = fr @ c, fr @ s
    mel = torch.sqrt(re * re + im * im)
    if fb is not None:
        mel = mel @ fb
    return torch.where(mel > 1e-18, 20.0 * torch.log10(mel), -360.0)


def window_agree(got, plain, wit):
    """Where ``got`` agrees with the plain version at windows of 7056
    samples and more: by f32_agree, or within twice the plain version's own
    f32 error there (its largest distance from the float64 witness ``wit``)
    in amplitude relative to the frame's peak.  Over a 15 360-sample
    window both f32 sums leave a few bins 40-60 dB under their frame's
    peak some hundredths of a dB apart, which f32_agree's atol/rtol does
    not admit; bf16 operands miss the loudest bins by about 1e-3 of the
    peak, which this rule does not admit either.  Returns (agree,
    f32_agree's part, the plain version's error)."""
    agree, _ = f32_agree(got, plain)
    peak = wit.amax(dim=-1, keepdim=True)

    def amp(db):  # amplitude relative to the frame's peak
        return torch.pow(10.0, (db.double() - peak) / 20.0)

    own = (amp(plain) - amp(wit)).abs().max().item()
    near = (amp(got) - amp(plain)).abs() <= 2 * own
    return agree | near, agree, own


def fft_bound(rec, padded, n_frames):
    """(bound_ms, bound_by) of one FFT-tier launch on ``padded``: the larger
    of its operations (a real FFT of n_fft points a frame, 2.5 n log2 n,
    the magnitude, 3 a bin, and the mel pass, 2 a weight) over the f32 SIMT
    peak, and its bytes (the wave, the window, the twiddles and the band
    tables read once, the dB plane written once) over the HBM rate.  A
    ``LinearOperands`` record (the linear form) has no mel pass and no band
    tables, and writes every bin."""
    from msv_tpu_torch.kernels.spectrogram_cuda import LinearOperands

    rows = 1 if padded.ndim == 1 else padded.shape[0]
    n, n_freq = rec.n_fft, rec.n_fft // 2 + 1
    if isinstance(rec, LinearOperands):
        n_out, mel, tables = n_freq, 0, (rec.window, rec.twiddles)
    else:
        n_out, mel = rec.fb.shape[-1], 2 * rec.wts.shape[0]
        tables = (rec.window, rec.twiddles, rec.wts, rec.bands, rec.woff)
    ops = rows * n_frames * (2.5 * n * math.log2(n) + 3 * n_freq + mel)
    nbytes = (sum(t.numel() * t.element_size() for t in (padded, *tables))
              + 4 * rows * n_frames * n_out)
    t_ops, t_bytes = ops / PEAK_FLOPS["simt"], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def library_db(x, rec, win, hop, n_frames):
    """The yardstick of the FFT tier, which the port never calls: the same
    dB plane by torch.fft.rfft of the windowed frames (zero-padded to n_fft
    at the kernel's left offset), the magnitude, the mel product (true f32;
    none for a ``LinearOperands`` record) and the dB, in blocks of
    WINDOW_BLOCK frames of the f32 wave ``x``."""
    from msv_tpu_torch.config import precision_for

    fb = getattr(rec, "fb", None)
    left = (rec.n_fft - win) // 2
    out = torch.empty((n_frames, rec.n_fft // 2 + 1 if fb is None
                       else fb.shape[-1]), device=x.device)
    with precision_for("parity"):
        for a in range(0, n_frames, WINDOW_BLOCK):
            b = min(n_frames, a + WINDOW_BLOCK)
            fr = x[a * hop:(b - 1) * hop + win].unfold(0, win, hop)
            fr = fr * rec.window
            fr = torch.nn.functional.pad(fr, (left, rec.n_fft - win - left))
            mel = torch.fft.rfft(fr).abs()
            if fb is not None:
                mel = mel @ fb.to(x.device)
            out[a:b] = torch.where(mel > 1e-18, 20.0 * torch.log10(mel),
                                   -360.0)
    return out


class ParityAgainstPlain:
    """3d's holding of parity planes against the plain version, block by
    block: every bin within window_agree, at most FLOOR_SHARE of them out
    of f32_agree (``done``); the largest |dB error|, the bins out of
    f32_agree and the plain version's own f32 error.  The plain version is
    ``plain(seg, n_frames)``, by default the mel kernel's on ``ops`` (C, S,
    fb); the witness is the function of ``ops`` in float64 (fb None: the
    linear scale)."""

    def __init__(self, K, ops, win, hop, plain=None):
        self.win, self.hop = win, hop
        self.plain = plain or (lambda seg, n: K.mel_spectrogram_plain(
            seg, *ops, win=win, hop=hop, n_frames=n))
        self.wide = tuple(None if t is None else t.double() for t in ops)
        self.out_of_f32, self.n_bins, self.own, self.err = 0, 0, 0.0, 0.0

    def block(self, par, seg, a, b):
        """Hold ``par`` (frames [a, b) of a plane) against the plain
        version on ``seg``, the wave of those frames; returns (plain,
        witness)."""
        win, hop = self.win, self.hop
        plain = self.plain(seg, b - a)
        wit = f64_witness_cuda(seg, *self.wide, win, hop, b - a)
        agree, f32_ok, e = window_agree(par, plain, wit)
        out = int((~agree).sum())
        check(out == 0, f"{win}-sample windows, parity, frames {a}-{b}: "
              f"{out} bins out of window_agree (plain's own f32 error {e:.3g}"
              f" of the peak)")
        self.out_of_f32 += int((~f32_ok).sum())
        self.n_bins += agree.numel()
        self.own = max(self.own, e)
        self.err = max(self.err, (par - plain).abs().max().item())
        return plain, wit

    def done(self):
        check(self.out_of_f32 <= FLOOR_SHARE * self.n_bins,
              f"{self.win}-sample windows: {self.out_of_f32} of "
              f"{self.n_bins} bins out of f32_agree")
        return (f"parity: {self.out_of_f32} of {self.n_bins} bins out of "
                f"f32_agree, within twice plain's own f32 error "
                f"{self.own:.3g} of the peak")


def survey_against_plain(K, got, x, ops, win, hop, n_frames):
    """3d's comparisons of one rate's (2, n_frames, n_mel) kernel planes
    ``got`` (by mode) on the f32 wave ``x`` against the plain versions, in
    blocks of WINDOW_BLOCK frames.  Returns each mode's largest |dB error|
    and a note."""
    parity = ParityAgainstPlain(K, ops, win, hop)
    err = {}
    fast_err, fast_told = [], False
    for a in range(0, n_frames, WINDOW_BLOCK):
        b = min(n_frames, a + WINDOW_BLOCK)
        seg = x[..., a * hop:(b - 1) * hop + win]
        kw = dict(win=win, hop=hop, n_frames=b - a)
        plain, wit = parity.block(got["parity"][..., a:b, :], seg, a, b)
        fast = got["fast"][..., a:b, :]
        if a == 0:  # the rule tells the bf16 kernel apart
            fast_told = not bool(window_agree(fast, plain, wit)[0].all())
        fast_err.append((fast - K.mel_spectrogram_plain(
            seg, *ops, mode="fast", **kw)).abs().flatten())
        del plain, wit
    note = parity.done()
    check(fast_told, f"{win}-sample windows: the bf16 kernel meets "
          f"window_agree")
    fe = torch.cat(fast_err)
    err["parity"] = parity.err
    err["fast"], p99 = fe.max().item(), quantile(fe, 0.99)
    check(err["fast"] < GREY_STEP and p99 < 0.01, f"{win}-sample windows, "
          f"fast vs plain: max {err['fast']} dB, p99 {p99} dB")
    return err, (f"{note}; fast: max {err['fast']:.3g} dB p99 {p99:.3g} dB, "
                 f"and out of window_agree")


# 3d's parity chunked tier: 176.4 kHz at f_overlap 3 (windows of 7056
# samples, which no resident parity block holds; n_fft 24 576, not a power
# of two: no FFT plan), as the viewer's and the CLI's f_overlap set it
CHUNKED_SR, CHUNKED_F_OVERLAP = 176400, 3


def survey_chunked(K, rng, d):
    """3d: the parity kernel's chunked tier at CHUNKED_SR and
    CHUNKED_F_OVERLAP, 300 s a row, f32 and int16 input, B = 1 and 2, on
    the record a MelRoute makes: each launch chunked, as tier_for says;
    int16 bit-equal to f32; rows independent; against its plain version as
    the FFT tier (ParityAgainstPlain); times of the kernel (f32 and int16,
    B = 1), its bound and the plain version; then a session of one such
    file at that setting, its launch in the chunked tier and its plane the
    kernel's.  Returns (head, max |dB error|, the session's chunked
    launches)."""
    from msv_tpu_torch import MultiTrack
    from msv_tpu_torch.config import SpecSetting, derive_stft_params
    from msv_tpu_torch.io.audio import write_wav
    from msv_tpu_torch.ops.dft import windowed_dft_matrices
    from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center
    from msv_tpu_torch.ops.mel import calc_mel_fb_default
    from msv_tpu_torch.ops.windows import default_stft_window

    sr, setting = CHUNKED_SR, SpecSetting(f_overlap=CHUNKED_F_OVERLAP)
    p = derive_stft_params(sr, setting)
    win, hop, n_fft = p.win_length, p.hop_length, p.n_fft
    window = default_stft_window(win, n_fft)
    ops = K.operands_from_numpy(*windowed_dft_matrices(window, n_fft),
                                calc_mel_fb_default(sr, n_fft), "cuda")
    n_mel = ops[2].shape[1]
    rec = K.MelRoute(window, ops[2], win=win, hop=hop, n_fft=n_fft,
                     device=ops[2].device,
                     dense=lambda: ops[:2]).record("parity")
    what = f"chunked {sr} Hz f_overlap {CHUNKED_F_OVERLAP}"
    check(not rec.fft and K.tier_for("parity", win, hop, n_fft, n_mel,
                                     rec.wts.shape[0]) == "chunked",
          f"{what}: tier_for is not chunked")
    i16 = make_signal(rng, sr, SURVEY_SECONDS, 2)
    path = os.path.join(d, f"chunked_{sr}.wav")
    write_wav(path, i16[0].astype(np.float32) / 32768.0, sr)
    n_frames = n_frames_for(i16.shape[1], win, hop)
    padded = np.stack([reflect_pad_center(x, win) for x in i16])
    wave = {"i16": torch.from_numpy(padded).cuda(),
            "f32": torch.from_numpy(padded.astype(np.float32)
                                    * np.float32(2.0**-15)).cuda()}
    del i16, padded
    kw = dict(win=win, hop=hop, n_frames=n_frames)
    before = dict(K.LAUNCHES_BY_TIER)
    two = {k: K.mel_spectrogram_cuda(v, rec, **kw) for k, v in wave.items()}
    one = {k: K.mel_spectrogram_cuda(v[1], rec, **kw)
           for k, v in wave.items()}
    check(K.LAUNCHES_BY_TIER == dict(before, chunked=before["chunked"] + 4),
          f"{what}: launches by tier {K.LAUNCHES_BY_TIER}")
    torch.cuda.synchronize()
    check(all(torch.equal(g["i16"], g["f32"]) for g in (one, two)),
          f"{what}: int16 route != f32 route")
    check(torch.equal(one["f32"], two["f32"][1]),
          f"{what}: B=1 != row 1 of B=2")
    parity = ParityAgainstPlain(K, ops, win, hop)
    for a in range(0, n_frames, WINDOW_BLOCK):
        b = min(n_frames, a + WINDOW_BLOCK)
        parity.block(two["f32"][..., a:b, :],
                     wave["f32"][..., a * hop:(b - 1) * hop + win], a, b)
    note = parity.done()
    del one, two
    x1 = wave["f32"][0]
    ms = cuda_ms(lambda: K.mel_spectrogram_cuda(x1, rec, **kw))
    ms_i16 = cuda_ms(lambda: K.mel_spectrogram_cuda(wave["i16"][0], rec,
                                                    **kw))
    plain_ms = cuda_ms(lambda: K.mel_spectrogram_plain(x1, *ops, **kw))
    bnd = bound(K, "parity", x1, ops, n_frames)
    del wave, rec, ops
    torch.cuda.empty_cache()
    # ---- the session: counts from here to the end of add_tracks
    torch.cuda.synchronize()
    reset_counts(K)
    mt = MultiTrack(setting, device="cuda")
    mt.add_tracks([0], [path])
    torch.cuda.synchronize()
    n, tiers = read_counts(K), dict(K.LAUNCHES_BY_TIER)
    # ---- end of the session
    check(n == counts(parity=1) and tiers == dict(resident=0, chunked=1,
                                                  fft=0),
          f"{what} session: launches {n}, by tier {tiers}")
    tr, st = mt.tracks[0], mt._state[0]
    padded, nf, nfp = host_padded(tr)
    direct = K.mel_spectrogram_cuda(
        torch.from_numpy(padded).cuda(), session_route(tr).record("parity"),
        win=win, hop=hop, n_frames=nfp)
    check(torch.equal(st.spec_db[:nf], direct[:nf]),
          f"{what} session: the plane != the kernel's on its padded wave")
    print(f"[survey] {what}: win {win} hop {hop} n_fft {n_fft} n_mel {n_mel}"
          f" B=1,2 frames {n_frames}: i16==f32, rows independent; {note}; "
          f"B=1: parity chunked {ms:.3f} ms (i16 {ms_i16:.3f}), bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}; {100 * bnd[0] / ms:.1f}%), plain "
          f"{plain_ms:.3f} ms; session launches by tier {tiers}, its plane "
          f"the kernel's", flush=True)
    del mt, direct
    torch.cuda.empty_cache()
    return ((ms, plain_ms, f"{sr} Hz f_overlap {CHUNKED_F_OVERLAP}, B=1, "
             f"f32, {n_frames} frames x {n_mel} mel", *bnd, None),
            parity.err, tiers["chunked"])


# 3d's linear FFT tier: the rates of the benchmark's survey384k_linear whose
# groups take it (n_fft 16 384, 16 384 and 8192) and 96 kHz (4096, the
# smallest plan), 300 s a row
LINEAR_RATES = [384000, 250000, 192000, 96000]


def survey_linear(K, rng, files):
    """3d on the linear scale: the FFT tier's linear form at LINEAR_RATES,
    f32 and int16 input, B = 1 and 2, on a LinearRoute's record: each
    launch fft, as tier_for says (fast: gemm); int16 bit-equal to f32; rows
    independent; against the dense pair in true f32 (spec_pipeline, the
    "gemm" tier) by ParityAgainstPlain; times of the kernel (f32 and int16,
    B = 1), its bound, the pair and torch.fft.rfft + magnitude + dB
    (library_db).  Then a parity session of the survey's ``files`` (384,
    250, 192 and 48 kHz) on the linear scale: its linear launches by tier,
    counted from zero (3 fft, 1 gemm), no C/S built at the FFT-tier rates,
    each plane equal to a fresh route's on the track's host-padded wave.
    Returns (the 384 kHz head, max |dB error|, the session's fft
    launches)."""
    from msv_tpu_torch import MultiTrack, precision_mode_scope
    from msv_tpu_torch.config import (FreqScale, SpecSetting,
                                      derive_stft_params)
    from msv_tpu_torch.kernels.pipeline import spec_pipeline
    from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center
    from msv_tpu_torch.ops.windows import default_stft_window

    linear = SpecSetting(freq_scale=FreqScale.LINEAR)

    def route_at(sr):
        p = derive_stft_params(sr, linear)
        return K.LinearRoute(default_stft_window(p.win_length, p.n_fft),
                             win=p.win_length, hop=p.hop_length,
                             n_fft=p.n_fft, device="cuda")

    head, err = None, 0.0
    for sr in LINEAR_RATES:
        route = route_at(sr)
        win, hop, n_fft, n_out = route.win, route.hop, route.n_fft, route.n_out
        what = f"linear {sr} Hz"
        check((route.tier("parity"), route.tier("fast")) == ("fft", "gemm"),
              f"{what}: tier_for gives {route.tier('parity')} in parity, "
              f"{route.tier('fast')} in fast")
        rec = route.record()
        i16 = make_signal(rng, sr, SURVEY_SECONDS, 2)
        n_frames = n_frames_for(i16.shape[1], win, hop)
        padded = np.stack([reflect_pad_center(x, win) for x in i16])
        wave = {"i16": torch.from_numpy(padded).cuda(),
                "f32": torch.from_numpy(padded.astype(np.float32)
                                        * np.float32(2.0**-15)).cuda()}
        del i16, padded
        kw = dict(win=win, hop=hop, n_frames=n_frames)
        before = dict(K.LINEAR_LAUNCHES_BY_TIER)
        two = {k: K.linear_spectrogram_cuda(v, rec, sr=sr, **kw)
               for k, v in wave.items()}
        one = {k: K.linear_spectrogram_cuda(v[1], rec, sr=sr, **kw)
               for k, v in wave.items()}
        check(K.LINEAR_LAUNCHES_BY_TIER == dict(before,
                                                fft=before["fft"] + 4),
              f"{what}: linear launches by tier {K.LINEAR_LAUNCHES_BY_TIER}")
        torch.cuda.synchronize()
        check(tuple(two["f32"].shape) == (2, n_frames, n_out)
              and bool(torch.isfinite(two["f32"]).all()),
              f"{what}: shape {tuple(two['f32'].shape)} or not finite")
        check(all(torch.equal(g["i16"], g["f32"]) for g in (one, two)),
              f"{what}: int16 route != f32 route")
        check(torch.equal(one["f32"], two["f32"][1]),
              f"{what}: B=1 != row 1 of B=2")
        del one
        c, s = route.dense()

        def pair(seg, n):
            return spec_pipeline(seg, c, s, None, n, win=win, hop=hop,
                                 n_frames=n, use_mel=False, mode="parity")[0]

        parity = ParityAgainstPlain(K, (c, s, None), win, hop, plain=pair)
        for a in range(0, n_frames, WINDOW_BLOCK):
            b = min(n_frames, a + WINDOW_BLOCK)
            parity.block(two["f32"][..., a:b, :],
                         wave["f32"][..., a * hop:(b - 1) * hop + win], a, b)
        note, e = parity.done(), parity.err
        err = max(err, e)
        del two, parity
        x1 = wave["f32"][0]
        ms = cuda_ms(lambda: K.linear_spectrogram_cuda(x1, rec, **kw))
        ms_i16 = cuda_ms(lambda: K.linear_spectrogram_cuda(wave["i16"][0],
                                                           rec, **kw))
        plain_ms = cuda_ms(lambda: pair(x1, n_frames))
        bnd = fft_bound(rec, x1, n_frames)
        lib_ms = cuda_ms(lambda: library_db(x1, rec, win, hop, n_frames))
        print(f"[survey] {what} win {win} hop {hop} n_fft {n_fft} B=1,2 "
              f"frames {n_frames} x {n_out} bins: i16==f32, rows "
              f"independent; {note}; max |dB error| {e:.3g}; B=1: fft "
              f"{ms:.3f} ms (i16 {ms_i16:.3f}), bound {bnd[0]:.4f} ms "
              f"({bnd[1]}; {100 * bnd[0] / ms:.1f}%), plain {plain_ms:.3f} "
              f"ms, library {lib_ms:.3f} ms", flush=True)
        if head is None:
            head = (ms, plain_ms, f"{sr} Hz, B=1, f32, {n_frames} frames x "
                    f"{n_out} bins", *bnd, lib_ms)
        del wave, c, s, route, rec
        torch.cuda.empty_cache()

    # ---- the linear survey session: counts from here to the end of
    # add_tracks
    torch.cuda.synchronize()
    reset_counts(K)
    t0 = time.perf_counter()
    built, upload = [], K.operands_from_numpy  # windows of C/S made
    K.operands_from_numpy = (lambda c, *a: built.append(c.shape[0])
                             or upload(c, *a))
    try:
        with precision_mode_scope("parity"):
            mt = MultiTrack(linear, device="cuda")
            mt.add_tracks(list(range(len(files))), files)
    finally:
        K.operands_from_numpy = upload
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    n, tiers = read_counts(K), dict(K.LINEAR_LAUNCHES_BY_TIER)
    # ---- end of the linear survey session
    rates = [tr.sr for tr in mt.tracks.values()]
    check(n == counts() and tiers == dict(fft=len(SURVEY_RATES), gemm=len(
          files) - len(SURVEY_RATES)), f"linear survey session at {rates} "
          f"Hz: mel launches {n}, linear launches by tier {tiers}")
    wins = {tr.sr: tr.win_length for tr in mt.tracks.values()}
    with_dft = [sr for sr in rates if wins[sr] in built]
    check(with_dft == [sr for sr in rates if sr not in SURVEY_RATES],
          f"linear survey session: C/S built at {with_dft} Hz")
    for i, tr in mt.tracks.items():
        padded, nf, nfp = host_padded(tr)
        direct, _, _ = route_at(tr.sr)(torch.from_numpy(padded).cuda(), nfp,
                                       nf, mode="parity")
        check(torch.equal(mt._state[i].spec_db[:nf], direct[:nf]),
              f"linear survey session: the {tr.sr} Hz plane != its route's "
              f"on its padded wave")
    print(f"[survey] linear session: add_tracks of {len(files)} x "
          f"{SURVEY_SECONDS:.0f} s mono PCM16 at {rates} Hz {add_s:.3f} s; "
          f"linear launches by tier {tiers}, each plane its route's; C/S "
          f"only at {with_dft} Hz", flush=True)
    del mt
    torch.cuda.empty_cache()
    return head, err, tiers["fft"]


def phase_survey(K, rng, work):
    """3d: the FFT tier (parity) and the bf16 kernel at the survey's rates,
    the parity chunked tier (survey_chunked), the survey session, then the
    FFT tier's linear form and the linear survey session (survey_linear).
    Returns (paths, heads, errs, tier_launches): the sessions'
    resident-tier launches for the launch line, each kernel's headline
    (parity's FFT tier and fast at 384 kHz, parity's FFT tier with its
    library_ms; "chunked": the parity chunked tier; "linear": the linear
    form with its library_ms) and largest |dB error| against its plain
    version, and the sessions' launches of each one's tier (parity "fft",
    fast "chunked", "chunked" the parity chunked tier's, "linear" the
    linear session's "fft")."""
    from msv_tpu_torch import MultiTrack, precision_mode_scope
    from msv_tpu_torch.io.audio import write_wav
    from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center
    from msv_tpu_torch.ops.windows import default_stft_window

    d = tempfile.mkdtemp(prefix="msv_chip_survey_", dir=work)
    files, heads, errs = [], {}, {"parity": 0.0, "fast": 0.0}
    for sr in SURVEY_RATES:
        win, hop, ops = operands(sr, "cuda")
        n_fft = 2 * (ops[2].shape[0] - 1)
        rec = {"parity": K.MelRoute(
                   default_stft_window(win, n_fft), ops[2], win=win,
                   hop=hop, n_fft=n_fft, device=ops[2].device,
                   dense=lambda: ops[:2]).record("parity"),
               "fast": K.prepare_operands(*K.operands_bf16(*ops), "fast")}
        check(rec["parity"].c is None and rec["parity"].slabs is None,
              f"{sr} Hz: the FFT tier's record holds C/S")
        i16 = make_signal(rng, sr, SURVEY_SECONDS, 2)
        files.append(os.path.join(d, f"survey_{sr}.wav"))
        write_wav(files[-1], i16[0].astype(np.float32) / 32768.0, sr)
        n_frames = n_frames_for(i16.shape[1], win, hop)
        check(n_frames == 30001, f"{sr} Hz: {n_frames} frames")
        padded = np.stack([reflect_pad_center(x, win) for x in i16])
        wave = {"i16": torch.from_numpy(padded).cuda(),
                "f32": torch.from_numpy(padded.astype(np.float32)
                                        * np.float32(2.0**-15)).cuda()}
        del i16, padded
        n_mel = ops[2].shape[1]
        got, line = {}, []
        for mode in ("parity", "fast"):
            kw = dict(win=win, hop=hop, n_frames=n_frames, mode=mode)
            what = f"survey {sr} Hz {mode}"
            tier = SURVEY_TIER[mode][sr]
            check(K.tier_for(mode, win, hop, n_fft, n_mel, K.band_weights(
                ops[2])) == tier, f"{what}: tier_for is not {tier}")
            before = dict(K.LAUNCHES_BY_TIER)
            two = {k: K.mel_spectrogram_cuda(v, rec[mode], **kw)
                   for k, v in wave.items()}
            one = {k: K.mel_spectrogram_cuda(v[1], rec[mode], **kw)
                   for k, v in wave.items()}
            check(K.LAUNCHES_BY_TIER == dict(before, **{tier: before[tier]
                                                         + 4}),
                  f"{what}: launches by tier {K.LAUNCHES_BY_TIER}, "
                  f"{tier} expected")
            torch.cuda.synchronize()
            check(tuple(two["f32"].shape) == (2, n_frames, n_mel)
                  and bool(torch.isfinite(two["f32"]).all()),
                  f"{what}: shape {tuple(two['f32'].shape)} or not finite")
            check(all(torch.equal(g["i16"], g["f32"]) for g in (one, two)),
                  f"{what}: int16 route != f32 route")
            check(torch.equal(one["f32"], two["f32"][1]),
                  f"{what}: B=1 != row 1 of B=2")
            got[mode] = two["f32"]
            del one, two
            x1 = wave["f32"][0]
            ms = cuda_ms(lambda: K.mel_spectrogram_cuda(x1, rec[mode], **kw))
            ms_i16 = cuda_ms(lambda: K.mel_spectrogram_cuda(
                wave["i16"][0], rec[mode], **kw))
            plain_ms = cuda_ms(lambda: K.mel_spectrogram_plain(x1, *ops,
                                                               **kw))
            if mode == "parity":
                bnd = fft_bound(rec[mode], x1, n_frames)
                lib_ms = cuda_ms(lambda: library_db(x1, rec[mode], win, hop,
                                                    n_frames))
            else:
                bnd = bound(K, mode, x1, K.operands_bf16(*ops), n_frames)
                lib_ms = None
            line.append(f"{mode} {tier} {ms:.3f} ms (i16 {ms_i16:.3f}), "
                        f"bound {bnd[0]:.4f} ms ({bnd[1]}; "
                        f"{100 * bnd[0] / ms:.1f}%), plain {plain_ms:.3f} ms"
                        + ("" if lib_ms is None
                           else f", library {lib_ms:.3f} ms"))
            if sr == 384000:
                heads[mode] = (ms, plain_ms, f"{sr} Hz, B=1, f32, {n_frames}"
                               f" frames x {n_mel} mel", *bnd, lib_ms)
        err, note = survey_against_plain(K, got, wave["f32"], ops, win, hop,
                                         n_frames)
        for mode in errs:
            errs[mode] = max(errs[mode], err[mode])
        print(f"[survey] {sr} Hz win {win} hop {hop} n_mel {n_mel} B=1,2 "
              f"frames {n_frames}: i16==f32, rows independent; {note}; B=1: "
              + "; ".join(line), flush=True)
        del wave, got, ops, rec
        torch.cuda.empty_cache()
    heads["chunked"], errs["chunked"], chunked = survey_chunked(K, rng, d)

    files.append(os.path.join(d, "survey_48000.wav"))
    write_wav(files[-1], make_signal(rng, 48000, SURVEY_SECONDS, 1)[0]
              .astype(np.float32) / 32768.0, 48000)
    ids = list(range(len(files)))
    paths, tier_launches = [], {}
    for mode in ("parity", "fast"):
        # ---- the survey session: counts from here to the end of add_tracks
        torch.cuda.synchronize()
        reset_counts(K)
        t0 = time.perf_counter()
        built, upload = [], K.operands_from_numpy  # windows of C/S made
        K.operands_from_numpy = (lambda c, *a: built.append(c.shape[0])
                                 or upload(c, *a))
        try:
            with precision_mode_scope(mode):
                mt = MultiTrack(device="cuda")
                mt.add_tracks(ids, files)
        finally:
            K.operands_from_numpy = upload
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t0
        n, tiers = read_counts(K), dict(K.LAUNCHES_BY_TIER)
        # ---- end of the survey session
        want = {tier: sum(SURVEY_TIER[mode][sr] == tier
                          for sr in SURVEY_RATES) for tier in K.TIERS}
        want["resident"] += len(ids) - len(SURVEY_RATES)
        check(n == counts(**{mode: len(ids)}) and tiers == want,
              f"{mode} survey session: launches {n}, by tier {tiers}, "
              f"{want} expected")
        wins = {tr.sr: tr.win_length for tr in mt.tracks.values()}
        no_dft = [sr for sr in SURVEY_RATES if wins[sr] not in built]
        check(no_dft == (SURVEY_RATES if mode == "parity" else []),
              f"{mode} survey session: no C/S built at {no_dft} Hz")
        for i in ids:
            tr, st = mt.tracks[i], mt._state[i]
            padded, nf, nfp = host_padded(tr)
            direct = K.mel_spectrogram_cuda(
                torch.from_numpy(padded).cuda(),
                session_route(tr).record(mode), win=tr.win_length,
                hop=tr.hop_length, n_frames=nfp, mode=mode)
            check(torch.equal(st.spec_db[:nf], direct[:nf]),
                  f"{mode} survey session: the {tr.sr} Hz plane != the "
                  f"kernel's on its padded wave")
        stages = {k: round(v["total_s"], 4)
                  for k, v in mt.timer.summary().items()}
        print(f"[survey] {mode} session: add_tracks of {len(ids)} x "
              f"{SURVEY_SECONDS:.0f} s mono PCM16 at "
              f"{[mt.tracks[i].sr for i in ids]} Hz {add_s:.3f} s; launches "
              f"by tier {tiers}, each plane equal to the kernel's; no C/S "
              f"at {no_dft} Hz; stage seconds, host clock: "
              f"{json.dumps(stages)}", flush=True)
        paths.append((f"{'' if mode == 'parity' else 'fast '}survey session"
                      " (resident tier)",
                      counts(**{mode: tiers["resident"]})))
        tier_launches[mode] = tiers["fft" if mode == "parity" else "chunked"]
        del mt
        torch.cuda.empty_cache()
    tier_launches["chunked"] = chunked
    heads["linear"], errs["linear"], tier_launches["linear"] = survey_linear(
        K, rng, files)
    return paths, heads, errs, tier_launches


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


def phase_streaming(K, rng, work, minutes=60, stereo_s=480.0):
    from msv_tpu_torch import (MultiTrack, precision_mode_scope,
                               streaming_spec_db, streaming_spec_db_mmap)
    from msv_tpu_torch.io.audio import write_wav
    from msv_tpu_torch.kernels.pipeline import spec_pipeline
    from msv_tpu_torch.ops.framing import reflect_pad_center
    from msv_tpu_torch.parallel.streaming import _seg_plan_for
    from msv_tpu_torch.render.envelope import EnvelopeState
    from msv_tpu_torch.session.multitrack import STREAMING_FRAME_THRESHOLD

    # the hour stays in ``work`` for phase 7
    with tempfile.TemporaryDirectory(prefix="msv_chip_stream_", dir=work,
                                     delete=False) as d:
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
        route = session_route(tr0)
        route.record("parity")
        t0 = time.perf_counter()
        mm_db, mm_n, mm_min, mm_max = streaming_spec_db_mmap(
            hour, tr0.win_length, tr0.hop_length, route, None)
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
                           operands(tr.sr, "cuda")[2])
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
                                    tr0.hop_length, route, None,
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
        c, s, _ = operands(tr1.sr, "cuda")[2]
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
        return (launches, fast_launches, lin_launches), (hour, eight)


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
                                            0.0, None, "slaney",
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


def synced(fn):
    """(fn(), host seconds) around a device sync on each side."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_residency(K, smi, song, hour):
    """7: the session's device-memory budget and adaptive renders, run with
    the process's TF32 flags on (the sessions' GEMMs turn them off)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        return _residency(K, smi, song, hour)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _residency(K, smi, song, hour):
    from msv_tpu_torch import MultiTrack, SpecSetting
    from msv_tpu_torch.ops import multires
    from msv_tpu_torch.parallel.streaming import _seg_plan_for
    from msv_tpu_torch.session.multitrack import AudioTrack
    from msv_tpu_torch.utils.errors import AdaptiveBuildPending

    paths, p10, imgs, wav_imgs = song
    ids = list(range(len(paths)))
    mem = torch.cuda.memory_allocated

    # the unbounded session: phase 4's images with TF32 on, its peak, and
    # one rendered 48 kHz track's bytes (tests/test_hbm_budget.py's sizing)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = mem()
    ref = MultiTrack(device="cuda")
    _, ref_add_s = synced(lambda: ref.add_tracks(ids, paths))
    add_stages = {"unbounded": ref.timer.summary()}
    for i in ids:
        check(np.array_equal(ref.get_spec_image(i, 100.0, 500), imgs[i])
              and np.array_equal(ref.get_wav_image(i, 100.0, 200, -1.0, 1.0),
                                 wav_imgs[i]),
              f"track {i}: unbounded session with TF32 on != phase 4")
    torch.cuda.synchronize()
    peak_ref = torch.cuda.max_memory_allocated() - base
    per = ref.hbm_stats()["per_track_bytes"][ids[-1]]
    budget = 3 * per + per // 2
    groups = {}
    for i, t in ref.tracks.items():
        groups.setdefault((t.sr, ref._state[i].n_frames_pad, t.wire),
                          []).append(i)
    grouped = [g for g in groups.values() if len(g) > 1]
    check(len(grouped) == 1, f"expected one two-track group: {groups}")
    del ref
    torch.cuda.empty_cache()

    # ---- the main path: the budgeted song session, then the hour
    torch.cuda.synchronize()
    reset_counts(K)
    torch.cuda.reset_peak_memory_stats()
    base = mem()
    mt = MultiTrack(device="cuda", hbm_budget_bytes=budget)
    _, add_s = synced(lambda: mt.add_tracks(ids, paths))
    add_stages["budgeted"] = mt.timer.summary()
    check(mt.hbm_stats()["resident_bytes"] <= budget, "resident after add")
    # a grouped track that was never spilled: its plane is its own
    g = [i for i in grouped[0] if isinstance(mt._state[i].spec_db,
                                             torch.Tensor)]
    check(g, f"no grouped track resident after add: {mt.hbm_stats()}")
    plane = mt._state[g[0]].spec_db.untyped_storage().nbytes()
    before = mem()
    _, spill_g_s = synced(lambda: mt._spill_track(g[0]))
    freed_g = before - mem()
    check(freed_g >= plane, f"spilling grouped track {g[0]} freed {freed_g}"
          f" of its {plane} bytes")
    reup_s = res_s = None
    for i in ids:
        spilled = not isinstance(mt._state[i].spec_db, torch.Tensor)
        im, dt = synced(lambda: mt.get_spec_image(i, 100.0, 500))
        if spilled and reup_s is None:
            reup_s = dt
        check(np.array_equal(im, imgs[i]), f"budgeted track {i} image")
        check(np.array_equal(mt.get_wav_image(i, 100.0, 200, -1.0, 1.0),
                             wav_imgs[i]), f"budgeted track {i} waveform")
        check(mt.hbm_stats()["resident_bytes"] <= budget,
              f"resident bytes over the budget after track {i}")
    _, res_s = synced(lambda: mt.get_spec_image(ids[-1], 100.0, 500))
    stats = mt.hbm_stats()
    check(stats["spills"] > 0 and stats["reuploads"] > 0 and reup_s,
          f"no spill or re-upload: {stats}")
    peak_budget = torch.cuda.max_memory_allocated() - base
    plane48 = mt._state[ids[-1]].spec_db.untyped_storage().nbytes()
    _, spill48_s = synced(lambda: mt._spill_track(ids[-1]))

    # the hour: spill and re-upload of the 0.5 GB plane and adopted wave
    mh = MultiTrack(device="cuda")
    mh.add_tracks([0], [hour])
    view = (0, 100.0, 500, 321.68, 333.68)
    crop0 = mh.get_spec_image_crop(*view)
    wcrop0 = mh.get_wav_image_crop(0, 100.0, 200, -1.0, 1.0, *view[3:])
    env = mh._env_states[0]
    check(env.origin == "adopted", f"hour envelope {env.origin}")
    hbytes = (mh._state[0].spec_db.untyped_storage().nbytes()
              + env.dev.untyped_storage().nbytes())
    del env
    before = mem()
    _, spill_h_s = synced(lambda: mh._spill_track(0))
    freed_h = before - mem()
    check(freed_h >= hbytes, f"hour spill freed {freed_h} of {hbytes}")
    crop1, reup_h_s = synced(lambda: mh.get_spec_image_crop(*view))
    wcrop1 = mh.get_wav_image_crop(0, 100.0, 200, -1.0, 1.0, *view[3:])
    check(np.array_equal(crop1, crop0) and np.array_equal(wcrop1, wcrop0)
          and mh._env_states[0].origin == "upload",
          "hour images after spill and re-upload")

    # adaptive on the 48 kHz song track: stitching, cached == slice-local
    tid = ids[-1]
    parts, local_s, a = [], [], SECONDS / 4  # 60 s into a 240 s track
    for s0 in (a, a + 3.0, a + 6.0):
        im, dt = synced(lambda: mt.get_adaptive_spec_image_crop(
            tid, 400.0, 500, s0, s0 + 3.0, wire="rgb"))
        parts.append(im)
        local_s.append(dt)
    union = mt.get_adaptive_spec_image_crop(tid, 400.0, 500, a, a + 9.0,
                                            wire="rgb")
    check(all(p.shape == (500, 1200, 3) for p in parts)
          and np.array_equal(np.concatenate(parts, axis=1), union),
          "three adjacent adaptive crops != the crop over their union")
    zoomed_out = (tid, 10.0, 500, 0.0, SECONDS + 1.0)
    local = mt.get_adaptive_spec_image_crop(*zoomed_out)
    mt.ADAPTIVE_MAX_FRAMES = 4096  # this session only: the cached path
    try:
        cached, song_build_s = synced(
            lambda: mt.get_adaptive_spec_image_crop(*zoomed_out))
        check(mt._adaptive_db[tid].full is not None, "no cached plane")
        n_seg48 = -(-mt._adaptive_db[tid].nf // mt.ADAPTIVE_CHUNK)
        check(np.array_equal(cached, local),
              "cached adaptive render != the slice-local one")
    finally:
        del mt.ADAPTIVE_MAX_FRAMES
    check(mt.hbm_stats()["resident_bytes"] <= budget,
          "resident bytes over the budget after the adaptive build")

    # adaptive on the hour: the whole background build
    t0 = time.perf_counter()
    try:
        mh.get_adaptive_spec_image_crop(0, 1.0, 300, 0.0, 3601.0,
                                        block=False)
        check(False, "block=False served an hour it had not built")
    except AdaptiveBuildPending as e:
        pending = (e.built, e.total)
    prog = mh.adaptive_build_progress()
    full_h = mh.get_adaptive_spec_image_crop(0, 1.0, 300, 0.0, 3601.0)
    torch.cuda.synchronize()
    hour_build_s = time.perf_counter() - t0
    hb = mh._adaptive_db[0]
    check(hb.full is not None and hb.full.shape[0] == hb.nf
          and bool(torch.isfinite(hb.full).all()) and full_h.shape[0] == 300,
          "hour adaptive plane")
    hlocal = mh.get_adaptive_spec_image_crop(*view)
    mh.ADAPTIVE_MAX_FRAMES = 64
    try:
        check(np.array_equal(mh.get_adaptive_spec_image_crop(*view), hlocal),
              "hour: cached adaptive crop != slice-local crop")
    finally:
        del mh.ADAPTIVE_MAX_FRAMES
    launches = read_counts(K)
    # ---- end of the main path
    n_seg = len(_seg_plan_for(mh._state[0].n_frames, 4096, 8))
    check(launches == counts(len(groups) + n_seg),
          f"residency launches {launches}")

    # a 10 s track's adaptive plane on the card against the CPU port's:
    # within DEEP_DB of the frame's peak, max <= 0.47 dB and p99 <= 0.01 dB
    # (tests/test_torch_multires.py's bound)
    wav10 = AudioTrack(p10, SpecSetting()).wav
    a10, _ = multires.multires_mel_spec_db(wav10, 44100, device="cuda")
    c10, _ = multires.multires_mel_spec_db(wav10, 44100, device="cpu")
    a10 = a10.cpu()
    near = c10 >= c10.amax(dim=-1, keepdim=True) - DEEP_DB
    err = (a10 - c10).abs()
    e_max, e_p99 = err[near].max().item(), quantile(err[near], 0.99)
    agree = bool(f32_agree(a10, c10)[0].all())
    check(e_max <= GREY_STEP and e_p99 <= 0.01,
          f"10 s adaptive plane vs CPU: max {e_max} dB, p99 {e_p99} dB")

    mib = 2.0**20
    print(f"[residency] {smi}; budget {budget / mib:.1f} MiB (3.5 x the "
          f"48 kHz "
          f"track's {per / mib:.1f} MiB); add (7 tracks, "
          f"{len(groups)} launches) {add_s:.3f} s; spill of grouped track "
          f"{g[0]} freed {freed_g / mib:.1f} MiB of its {plane / mib:.1f} MiB"
          f" plane in {spill_g_s * 1e3:.1f} ms; sweep of 7 spectrogram and "
          f"waveform images equal to phase 4's, resident <= budget after "
          f"each; spills {stats['spills']}, re-uploads {stats['reuploads']}")
    print(f"[residency] add, host clock: unbounded {ref_add_s:.3f} s, "
          f"budgeted {add_s:.3f} s; stages: " + "; ".join(
              f"{k} " + json.dumps({n[len("add_tracks."):]: round(v["total_s"],
                                                                 4)
                                    for n, v in st.items()
                                    if n.startswith("add_tracks.")})
              for k, st in add_stages.items()))
    print(f"[residency] full-width 500x{int(100 * SECONDS)} render: resident "
          f"{res_s:.3f} s, re-upload {reup_s:.3f} s; spill of the 48 kHz "
          f"plane ({plane48 / mib:.1f} MiB) {spill48_s * 1e3:.1f} ms; peak "
          f"max_memory_allocated over add + sweep: budgeted "
          f"{peak_budget / mib:.1f} MiB, unbounded {peak_ref / mib:.1f} MiB")
    print(f"[residency] hour: spill of plane + adopted wave freed "
          f"{freed_h / mib:.1f} MiB in {spill_h_s:.3f} s; re-upload crop "
          f"render {reup_h_s:.3f} s; crop and waveform crop equal before "
          f"and after (waveform from the uploaded carrier)")
    stages = {k: v["total_s"] for k, v in mt.timer.summary().items()
              if k.startswith("adaptive")}
    print(f"[adaptive] 48 kHz {SECONDS:.0f} s track: three adjacent 1200-px "
          f"crops == "
          f"their union; slice-local crops {local_s[0]:.3f} / "
          f"{local_s[1]:.3f} / {local_s[2]:.3f} s; cached build + "
          f"render ({n_seg48} segments of {mt.ADAPTIVE_CHUNK}) "
          f"{song_build_s:.3f} s,"
          f" == slice-local; stages, host clock: {json.dumps(stages)}")
    print(f"[adaptive] hour: block=False pending at {pending[0]}/"
          f"{pending[1]} frames (progress {prog}); whole background build "
          f"+ render {hour_build_s:.3f} s; cached crop == slice-local; 10 s "
          f"track vs CPU within {DEEP_DB:.0f} dB of the frame peak: max "
          f"{e_max:.3g} dB p99 {e_p99:.3g} dB (f32_agree everywhere: "
          f"{agree})")
    return launches


def free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def http(url, payload=None, headers=None, timeout=600):
    """(status, body bytes, seconds) of one GET, or of one POST of the JSON
    ``payload``; an HTTP error answers with its status and body."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method="GET" if data is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, body, time.perf_counter() - t0


def wait_loaded(base, deadline_s, proc=None):
    """Poll /api/tracks until the viewer's startup load has finished."""
    import urllib.error

    deadline = time.time() + deadline_s
    while True:
        check(proc is None or proc.poll() is None,
              f"the viewer process exited: {proc and proc.returncode}")
        try:
            code, body, _ = http(base + "/api/tracks", timeout=30)
        except (urllib.error.URLError, ConnectionError):
            code = None
        if code == 200:
            tracks = json.loads(body)
            check(tracks.get("error") is None, f"viewer load: {tracks}")
            if not tracks.get("loading") and tracks["tracks"]:
                return tracks
        check(time.time() < deadline, f"the viewer at {base} did not load")
        time.sleep(0.05)


def run_cli(args):
    """msv_tpu_torch.cli.main(args) in this process (so its launches are
    counted), its standard output kept apart: (exit code, output, wall
    seconds ending in a device sync)."""
    import contextlib
    import io

    from msv_tpu_torch import cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t0


def counted(K, fn):
    """(fn(), the launches fn made): counts set to 0 just before, read just
    after."""
    torch.cuda.synchronize()
    reset_counts(K)
    out = fn()
    return out, read_counts(K)


def phase_frontends(K, smi, song, hour, eight, work):
    """8: the command line and the web viewer, as users run them."""
    from msv_tpu_torch import (FreqScale, MultiTrack, SpecSetting,
                               log_mel_spectrogram, precision_mode_scope)
    from msv_tpu_torch.cli import adaptive_image
    from msv_tpu_torch.config import derive_stft_params
    from msv_tpu_torch.io.audio import (open_audio_file, open_audio_mono_ex,
                                        open_wav_mmap)
    from msv_tpu_torch.io.png import encode_png
    from msv_tpu_torch.ops.framing import n_frames_for
    from msv_tpu_torch.ops.multires import multires_mel_spec_db
    from msv_tpu_torch.ops.resample import resample, resample_streamed
    from msv_tpu_torch.parallel.streaming import _seg_plan_for
    from msv_tpu_torch.viewer import serve_viewer

    import re

    from msv_tpu_torch.io import png as png_mod

    paths, p10, imgs, wav_imgs = song
    ids = list(range(len(paths)))
    stem = {p: os.path.splitext(os.path.basename(p))[0]
            for p in (*paths, p10, hour, eight)}
    d = tempfile.mkdtemp(prefix="msv_chip_front_", dir=work)
    legs, wall, add_s, write_s = [], {}, {}, {}
    real_write = png_mod.write_png

    def cli_leg(name, args, want):
        """One counted CLI run; its wall time, the add time it prints and
        the seconds its write_png calls took (PNG encode and file write)."""
        out = os.path.join(d, name.replace(" ", "_").replace("-", ""))
        spent = [0.0]

        def timed_write(*a, **kw):
            t0 = time.perf_counter()
            real_write(*a, **kw)
            spent[0] += time.perf_counter() - t0

        png_mod.write_png = timed_write  # the CLI imports it per call
        try:
            (rc, log, wall[name]), n = counted(
                K, lambda: run_cli([*args, "-o", out]))
        finally:
            png_mod.write_png = real_write
        check(rc == 0, f"{name}: exit {rc}; {log}")
        check(n == want, f"{name}: launches {n}, expected {want}")
        m = re.search(r"loaded \d+ tracks in ([\d.]+)s", log)
        add_s[name], write_s[name] = m and float(m.group(1)), spent[0]
        legs.append((f"cli {name}", n))
        return out

    def split(name):
        """'wall s (add a s, write_png w s = share of the wall)'."""
        a = "" if add_s[name] is None else f"add {add_s[name]:.3f} s, "
        return (f"{wall[name]:.3f} s ({a}write_png {write_s[name]:.3f} s = "
                f"{write_s[name] / wall[name]:.1%})")

    def png(out, name):
        return png_pixels(os.path.join(out, name))

    # ---- 1. render of the seven songs: parity with --save-db, fast, linear
    out = cli_leg("render", ["render", *paths, "--save-db", "--wav-height",
                             "200"], counts(6))
    render_dir = out
    ref = MultiTrack(device="cuda")
    ref.add_tracks(ids, paths)
    for i, p in enumerate(paths):
        check(np.array_equal(png(out, f"spec_{stem[p]}.png"), imgs[i])
              and np.array_equal(png(out, f"wav_{stem[p]}.png"), wav_imgs[i]),
              f"render: track {i}'s PNGs != the session's images")
        check(np.array_equal(np.load(os.path.join(out, f"db_{stem[p]}.npy")),
                             ref.get_spec_db(i)),
              f"render --save-db: track {i} != get_spec_db")
    del ref
    t0 = time.perf_counter()
    encoded = encode_png(imgs[0])
    png_s = time.perf_counter() - t0
    out = cli_leg("render --fast", ["render", *paths, "--fast", "--no-wav"],
                  counts(fast=6))
    with precision_mode_scope("fast"):
        mf = MultiTrack(device="cuda")
        mf.add_tracks(ids, paths)
    for i, p in enumerate(paths):
        check(np.array_equal(png(out, f"spec_{stem[p]}.png"),
                             mf.get_spec_image(i, 100.0, 500)),
              f"render --fast: track {i} != the fast session's image")
    del mf
    linear = SpecSetting(freq_scale=FreqScale.LINEAR)
    out = cli_leg("render linear", ["render", *paths, "--freq-scale",
                                    "linear", "--no-wav"], counts())
    ml = MultiTrack(linear, device="cuda")
    ml.add_tracks(ids, paths)
    for i, p in enumerate(paths):
        check(np.array_equal(png(out, f"spec_{stem[p]}.png"),
                             ml.get_spec_image(i, 100.0, 500)),
              f"render --freq-scale linear: track {i} != the session's")
    del ml
    torch.cuda.empty_cache()

    # ---- 2. a crop of the hour across a segment boundary
    # 12 s from 5 s before the whole second under the third segment
    # boundary (the hour: 983.04 s, so 978-990 s)
    hp = derive_stft_params(48000, SpecSetting())
    n_hour = len(open_wav_mmap(hour)[0])
    hour_s = n_hour / 48000
    plan = _seg_plan_for(n_frames_for(n_hour, hp.win_length, hp.hop_length),
                         4096, 8)
    starts = np.cumsum(plan)[:-1] * 4096 * hp.hop_length / 48000
    c0 = float(np.floor(starts[min(2, len(starts) - 1)])) - 5.0
    c1 = c0 + 12.0
    cross = [b for b in starts if c0 < b < c1]
    check(len(cross) == 1, f"segment starts {starts} in [{c0}, {c1})")
    out = cli_leg("render hour crop", ["render", hour, "--start", f"{c0:g}",
                                       "--end", f"{c1:g}"], counts(len(plan)))
    mh = MultiTrack(device="cuda")
    mh.add_tracks([0], [hour])
    check(np.array_equal(png(out, f"spec_{stem[hour]}.png"),
                         mh.get_spec_image_crop(0, 100.0, 500, c0, c1))
          and np.array_equal(png(out, f"wav_{stem[hour]}.png"),
                             mh.get_wav_image_crop(0, 100.0, 150, -1.0, 1.0,
                                                   c0, c1)),
          f"render --start {c0:g} --end {c1:g} != the session's crops")
    del mh

    # ---- 3. the adaptive render of the 48 kHz song
    out = cli_leg("render --adaptive", ["render", paths[-1], "--adaptive",
                                        "--save-db"], counts())
    db = torch.from_numpy(np.load(os.path.join(
        out, f"db_adaptive_{stem[paths[-1]]}.npy"))).cuda()
    wav48 = open_audio_mono_ex(paths[-1])[0]
    whole, _ = multires_mel_spec_db(wav48, 48000, device="cuda")
    a_err, a_note = check_f32(db, whole, "render --adaptive: plane vs the "
                              "whole form")
    check(np.array_equal(png(out, f"spec_adaptive_{stem[paths[-1]]}.png"),
                         adaptive_image(db, len(wav48), 48000, 100.0, 500,
                                        120.0)[0]),
          "render --adaptive: PNG != the render of its plane")
    del db, whole

    # ---- 4. features --kind logmel, and resample
    out = cli_leg("features", ["features", paths[4]], counts(fast=1))
    wav441 = open_audio_mono_ex(paths[4])[0]
    x = resample(wav441, 44100, 16000)
    x_cpu = resample(wav441, 44100, 16000, device="cpu")
    r_err = (x.cpu() - x_cpu).abs().max().item()
    check(r_err <= 2e-5 * max(1.0, x_cpu.abs().max().item()),
          f"resample on the card vs the CPU: {r_err}")
    feats = np.load(os.path.join(out, f"feats_logmel_{stem[paths[4]]}.npy"))
    check(np.array_equal(feats, log_mel_spectrogram(x, 16000).cpu().numpy()),
          "features --kind logmel != log_mel_spectrogram of the resample")
    out = cli_leg("resample", ["resample", eight, "--sr", "16000", "--bits",
                               "32"], counts())
    y, sr = open_audio_file(os.path.join(out, f"{stem[eight]}_sr16000.wav"))
    want = resample_streamed(open_audio_file(eight)[0], 44100, 16000)
    check(sr == 16000 and np.array_equal(y, want),
          "resample --sr 16000 != resample_streamed on the card")
    print(f"[frontends] {smi}; CLI render of {len(paths)} songs (--save-db, "
          f"200-row waveforms), wall: {split('render')} (6 parity launches);"
          f" --fast --no-wav {split('render --fast')} (6 fast); --freq-scale "
          f"linear --no-wav {split('render linear')} (no launch); PNGs and dB"
          f" planes equal to the sessions'; encode_png of one "
          f"500x{int(100 * SECONDS)} spectrogram (level 2) {png_s:.3f} s "
          f"({len(encoded) / 2**20:.1f} MiB)")
    print(f"[frontends] render --start {c0:g} --end {c1:g} of the hour "
          f"(segment boundary at {cross[0]:.2f} s): "
          f"{split('render hour crop')} ({len(plan)} parity launches), equal "
          f"to the session's crops; render --adaptive --save-db of the 48 kHz"
          f" song {split('render --adaptive')}, plane vs the whole form "
          f"max|err| {a_err:.3g} dB ({a_note}), PNG == the render of its "
          f"plane; features --kind logmel of the 44.1 kHz song "
          f"{wall['features']:.3f} s (1 fast launch), the card's resample vs "
          f"the CPU's max|err| {r_err:.3g}, .npy == log_mel_spectrogram; "
          f"resample --sr 16000 of the 8-minute stereo file "
          f"{wall['resample']:.3f} s, == resample_streamed")

    # ---- 5. the web viewer on the seven songs and the hour
    vpaths = [*paths, hour]
    hid, eid = len(paths), len(paths) + 1
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    def start_viewer():
        threading.Thread(target=serve_viewer, args=(vpaths, port),
                         kwargs={"device": "cuda"}, daemon=True).start()
        return wait_loaded(base, 300)

    t0 = time.perf_counter()
    _, n = counted(K, start_viewer)
    load_s = time.perf_counter() - t0
    direct = MultiTrack(device="cuda")
    direct.add_tracks(list(range(len(vpaths))), vpaths)
    check(n == counts(6 + len(plan)), f"viewer load: launches {n}")
    legs.append(("viewer load", n))

    def image(path):
        code, body, dt = http(base + path)
        check(code == 200, f"{path}: HTTP {code} {body[:200]!r}")
        return png_pixels(body), dt

    full_s = []
    for i in ids:
        im, dt = image(f"/api/spec/{i}?px_per_sec=100&height=500")
        check(np.array_equal(im, direct.get_spec_image(i, 100.0, 500)),
              f"/api/spec/{i} != the session's image")
        full_s.append(dt)
    views = [(len(paths) - 1, SECONDS / 4, SECONDS / 4 + 12.0), (hid, c0, c1)]

    def crops_equal(what, tids=None):
        for tid, s0, s1 in views:
            if tids is not None and tid not in tids:
                continue
            q = f"px_per_sec=100&height=500&start={s0}&end={s1}"
            im, _ = image(f"/api/spec_crop/{tid}?{q}")
            check(np.array_equal(im, direct.get_spec_image_crop(
                tid, 100.0, 500, s0, s1)), f"{what}: spec_crop/{tid}")

    crops_equal("viewer")
    for tid, s0, s1 in views:
        q = f"px_per_sec=100&height=500&start={s0}&end={s1}"
        im, _ = image(f"/api/wav_crop/{tid}?px_per_sec=100&height=200"
                      f"&amp_min=-1&amp_max=1&start={s0}&end={s1}")
        check(np.array_equal(im, direct.get_wav_image_crop(
            tid, 100.0, 200, -1.0, 1.0, s0, s1)), f"wav_crop/{tid}")
        im, _ = image(f"/api/adaptive_crop/{tid}?{q}")
        check(np.array_equal(im, direct.get_adaptive_spec_image_crop(
            tid, 100.0, 500, s0, s1)), f"adaptive_crop/{tid}")
    zoomed = (f"/api/adaptive_crop/{hid}?px_per_sec=1&height=300&start=0"
              f"&end={hour_s + 1:g}")
    t0 = time.perf_counter()
    code, body, _ = http(base + zoomed)
    check(code == 202 and json.loads(body)["pending"],
          f"zoomed-out adaptive crop of the hour: HTTP {code} {body[:200]!r}")
    while code == 202:
        check(time.perf_counter() - t0 < 300, "the hour's adaptive build")
        time.sleep(0.05)
        code, body, _ = http(base + zoomed)
    build_s = time.perf_counter() - t0
    check(code == 200 and np.array_equal(
        png_pixels(body), direct.get_adaptive_spec_image_crop(
            hid, 1.0, 300, 0.0, hour_s + 1)), "zoomed-out adaptive crop")

    def stats():
        return json.loads(http(base + "/api/stats")[1])

    st0 = stats()
    image(f"/api/spec_crop/{views[0][0]}?px_per_sec=100&height=500"
          f"&start={views[0][1]}&end={views[0][2]}")
    st1 = stats()
    check(st1["render_cache"]["hits"] == st0["render_cache"]["hits"] + 1
          and st1["stage_timings"]["get_spec_image.render"]["calls"]
          == st0["stage_timings"]["get_spec_image.render"]["calls"]
          and "hbm" in st1 and st1["hbm"]["resident_bytes"] > 0,
          f"render cache: {st0['render_cache']} -> {st1['render_cache']}")
    a, b = 1_000_000, 1_065_535
    code, body, _ = http(base + f"/api/audio/{hid}",
                         headers={"Range": f"bytes={a}-{b}"})
    with open(hour, "rb") as f:
        f.seek(a)
        check(code == 206 and body == f.read(b - a + 1),
              f"/api/audio Range: HTTP {code}")

    set_s = {}
    for scale, want in (("linear", counts()),
                        ("mel", counts(6 + len(plan)))):
        t0 = time.perf_counter()
        (code, body, _), n = counted(K, lambda: http(
            base + "/api/setting", {"freq_scale": scale}))
        set_s[scale] = time.perf_counter() - t0
        check(code == 200 and n == want,
              f"POST /api/setting {scale}: HTTP {code}, launches {n}")
        legs.append((f"viewer setting {scale}", n))
        direct.set_setting(linear if scale == "linear" else SpecSetting())
        crops_equal(f"after /api/setting {scale}")

    views.append((eid, 30.0, 42.0))
    mut_s = {}
    for what, route, body_, chans in (
            ("add", "/api/add", {"id": eid, "path": eight}, [None]),
            ("channel", "/api/channel", {"id": eid, "channel": 1}, [1])):
        t0 = time.perf_counter()
        (code, body, _), n = counted(K, lambda: http(base + route, body_))
        mut_s[what] = time.perf_counter() - t0
        direct.add_tracks([eid], [eight], channels=chans)
        n_e = len(_seg_plan_for(direct._state[eid].n_frames, 4096, 8))
        check(code == 200 and n == counts(n_e),
              f"POST {route}: HTTP {code}, launches {n} ({n_e} segments)")
        legs.append((f"viewer {what}", n))
        crops_equal(f"after POST {route}", tids=(eid,))
    code, _, _ = http(base + "/api/remove", {"id": eid})
    direct.remove_track(eid)
    tracks = json.loads(http(base + "/api/tracks")[1])["tracks"]
    check(code == 200 and [t["id"] for t in tracks] == [*ids, hid],
          f"POST /api/remove: HTTP {code}, tracks {tracks}")
    code, body, _ = http(base + "/api/process", {"id": 0, "op": "hpss"})
    check(code == 400 and body.startswith(b"error: unknown op"),
          f"POST /api/process of an unknown op: HTTP {code}")

    lat = {}
    crop_urls = [f"/api/spec_crop/{hid}?px_per_sec=100&height=500"
                 f"&start={a:g}&end={a + 12:g}" for a in
                 (np.round(100 + np.arange(20) * (hour_s - 200) / 20))]
    for kind in ("miss", "hit"):
        st0 = stats()
        got = [image(u) for u in crop_urls]
        lat[kind] = [dt for _, dt in got]
        st1 = stats()
        check(st1["render_cache"]["hits"] - st0["render_cache"]["hits"]
              == (20 if kind == "hit" else 0), f"crop sweep ({kind}): hits")
        if kind == "miss":  # the session's render time per request
            r0, r1 = (x["stage_timings"]["get_spec_image.render"]
                      for x in (st0, st1))
            render_ms = ((r1["total_s"] - r0["total_s"])
                         / (r1["calls"] - r0["calls"]) * 1e3)
            t0 = time.perf_counter()
            crop_png = encode_png(got[-1][0])
            encode_ms = (time.perf_counter() - t0) * 1e3
    print(f"[viewer] {smi}; serve_viewer load of {len(paths)} songs + the "
          f"hour {load_s:.3f} s ({6 + len(plan)} parity launches); "
          f"{len(ids)} full-width 500x{int(100 * SECONDS)} /api/spec "
          f"requests: median {statistics.median(full_s):.3f} s, max "
          f"{max(full_s):.3f} s; spec, waveform and adaptive crops equal the "
          f"direct session's; the hour's zoomed-out adaptive crop 202, then "
          f"200 after {build_s:.3f} s; repeat crop: a cache hit, no render; "
          f"Range bytes equal the file's; /api/setting linear "
          f"{set_s['linear']:.3f} s (no launch), mel {set_s['mel']:.3f} s "
          f"({6 + len(plan)} launches); /api/add of the 8-minute stereo file "
          f"{mut_s['add']:.3f} s, /api/channel 1 {mut_s['channel']:.3f} s, "
          f"/api/remove; POST /api/process of an unknown op 400")
    print("[viewer] 20 distinct 1200-column crops of the hour, request "
          "latency: " + "; ".join(
              f"{k} p50 {np.percentile(v, 50) * 1e3:.1f} ms p90 "
              f"{np.percentile(v, 90) * 1e3:.1f} ms" for k, v in lat.items())
          + f"; per miss, the session's render {render_ms:.1f} ms (mean), "
          f"encode_png of one crop {encode_ms:.1f} ms "
          f"({len(crop_png) / 2**20:.2f} MiB)")
    del direct
    torch.cuda.empty_cache()

    # ---- 6. the entry points as users run them, in processes of their own
    root = os.path.dirname(os.path.abspath(__file__))
    sub = os.path.join(d, "sub")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "msv_tpu_torch", "render", p10,
                        "-o", sub], capture_output=True, text=True,
                       timeout=300, cwd=root)
    sub_s = time.perf_counter() - t0
    check(r.returncode == 0, f"python -m msv_tpu_torch render: {r.stderr}")
    rc, _, _ = run_cli(["render", p10, "-o", os.path.join(d, "inproc")])
    for name in (f"spec_{stem[p10]}.png", f"wav_{stem[p10]}.png"):
        check(rc == 0 and np.array_equal(png(sub, name),
                                         png(os.path.join(d, "inproc"), name)),
              f"python -m msv_tpu_torch render: {name} != in-process")
    vport = free_port()
    with open(os.path.join(d, "view.err"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "msv_tpu_torch", "view", p10, "--port",
             str(vport)], stdout=subprocess.DEVNULL, stderr=err, cwd=root)
        try:
            t0 = time.perf_counter()
            wait_loaded(f"http://127.0.0.1:{vport}", 300, proc)
            view_s = time.perf_counter() - t0
            code, body, _ = http(f"http://127.0.0.1:{vport}/api/spec_crop/0?"
                                 "px_per_sec=100&height=500&start=2&end=8")
            m10 = MultiTrack(device="cuda")
            m10.add_tracks([0], [p10])
            check(code == 200 and np.array_equal(
                png_pixels(body), m10.get_spec_image_crop(0, 100.0, 500, 2.0,
                                                          8.0)),
                  "python -m msv_tpu_torch view: crop != the session's")
        finally:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    r = subprocess.run([sys.executable, "-m", "msv_tpu_torch", "render",
                        os.path.join(d, "missing.wav"), "-o", d],
                       capture_output=True, text=True, timeout=300, cwd=root)
    check(r.returncode == 1 and r.stderr.startswith("error:"),
          f"render of a missing file: exit {r.returncode}, {r.stderr!r}")
    print(f"[frontends] python -m msv_tpu_torch render of the 10 s track "
          f"(own process) {sub_s:.3f} s, PNGs == in-process; view (own "
          f"process) loaded in {view_s:.3f} s, crop == the session's, "
          f"terminated; render of a missing file: exit 1, "
          f"{r.stderr.strip().splitlines()[0]!r}")
    return legs, {"render_dir": render_dir, "viewer": base,
                  "viewer_ids": [*ids, hid]}


# Phase 9's filter: a 4th-order Butterworth band-pass and a high shelf (five
# sections, real and complex poles), as `filter` takes them.
FILTER_ARGS = ["--bandpass", "200", "5000", "--shelf", "hi:3000:6"]
# tests/test_filter.py:99's filtfilt bound, in units of the input's peak
# (its input, unit noise, peaks near 4.5: the scaled bound is looser than
# its own by that factor, and the port measures 5e-6 of the peak on
# 20 s of these signals on the CPU)
FILTER_BOUND = 5e-5
# Griffin-Lim's spectral convergence on the card may exceed the port's CPU
# run on the 10 s track (same signal family, other rate and length) by
# this much: measured on the CPU, 10 s at 44.1 kHz against 60 s at 48 kHz
# of make_signal, the two differ by under 0.01
SC_MARGIN = 0.05
# features on the card against --device cpu on the 10 s track, per kind, in
# parity: tests/test_torch_features_more.py's (rtol, atol), onsets and
# beats equal; mfcc by the dot-product bound of its DCT (phase 9: on this
# track two f32 orders of the DCT of dB values near -60 differ by up to
# 5.4e-4, over the 2e-4 that msv_tpu's test holds on its tone)
CARD_FEATURE_BOUNDS = {"mfcc": (0, 2e-4), "chroma": (1e-4, 1e-6),
                       "spectral": (1e-3, 1e-7), "whisper": (0, 3e-4),
                       "pcen": (0, 2e-4), "contrast": (1e-3, 2e-3),
                       "tempogram": (0, 5e-5), "onsets": None, "beats": None}


def spectral_convergence(y, mag, sr, dev):
    """||STFT(y)| - mag| / |mag| over their common frames (the session's
    STFT, as Griffin-Lim's target magnitude)."""
    from msv_tpu_torch.config import (SpecSetting, derive_stft_params,
                                      precision_for)
    from msv_tpu_torch.ops.stft import stft_magnitude

    p = derive_stft_params(sr, SpecSetting())
    with precision_for("parity"):
        sy, n = stft_magnitude(np.ascontiguousarray(y, np.float32),
                               p.win_length, p.hop_length, p.n_fft,
                               device=dev)
    n = min(n, mag.shape[0])
    return (torch.linalg.vector_norm(sy[:n] - mag[:n])
            / torch.linalg.vector_norm(mag[:n])).item()


def target_magnitude(db, sr, dev):
    """The linear magnitude `reconstruct` inverts from a mel dB export."""
    from msv_tpu_torch.config import SpecSetting, derive_stft_params
    from msv_tpu_torch.ops.decibel import db_to_amp
    from msv_tpu_torch.ops.mel import calc_mel_fb_default
    from msv_tpu_torch.ops.reconstruct import mel_to_linear

    p = derive_stft_params(sr, SpecSetting())
    amp = db_to_amp(torch.from_numpy(np.ascontiguousarray(db)).to(dev))
    return mel_to_linear(amp, calc_mel_fb_default(sr, p.n_fft)), p


def phase_analysis(K, smi, song, hour, eight, front, work, dev="cuda"):
    """9: filter, reconstruct, the rest of the features, loudness and the
    viewer's onsets, beats and loudness routes, as users run them."""
    import re

    import scipy.signal as ss

    from msv_tpu_torch import AudioTrack, SpecSetting, precision_mode_scope
    from msv_tpu_torch import features as F
    from msv_tpu_torch.cli import (_build_parser, _feature,
                                   _filter_sos_from_args)
    from msv_tpu_torch.io.audio import open_audio_file, open_audio_mono_ex
    from msv_tpu_torch.ops import loudness as L
    from msv_tpu_torch.ops.filter import filtfilt, sosfilt_streamed
    from msv_tpu_torch.ops.reconstruct import griffin_lim
    from msv_tpu_torch.ops.resample import resample
    from msv_tpu_torch.ops.rhythm import beat_track
    from msv_tpu_torch.ops.stft import stft_magnitude

    paths, p10, _, _ = song
    stem = {q: os.path.splitext(os.path.basename(q))[0]
            for q in (*paths, p10, hour, eight)}
    d = tempfile.mkdtemp(prefix="msv_chip_analysis_", dir=work)
    legs, wall = [], {}
    dv = ["--device", dev]

    def leg(name, args):
        """One counted CLI run on the card: (output dir, its stdout); no
        mel kernel launch on any of these paths."""
        out = os.path.join(d, re.sub(r"\W+", "_", name))
        (rc, log, wall[name]), n = counted(
            K, lambda: run_cli([*args, *(["-o", out] if "-o" not in args
                                         and args[0] != "info" else []),
                                *dv]))
        check(rc == 0, f"{name}: exit {rc}; {log}")
        check(n == counts(), f"{name}: launches {n}, expected none")
        legs.append((f"cli {name}", n))
        return out, log

    def synced_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # ---- 1. filter: the hour and the 8-minute stereo file, forward and
    # zero-phase, against scipy's f64 filters on this machine's CPU
    f_err, f_ref_s = {}, {}
    for src in (hour, eight):
        x, sr = open_audio_file(src)
        sos = _filter_sos_from_args(_build_parser().parse_args(
            ["filter", src, *FILTER_ARGS]), sr)
        peak = float(np.abs(x).max())
        for zp in (False, True):
            name = f"filter {stem[src]}{' --zero-phase' if zp else ''}"
            out, _ = leg(name, ["filter", src, *FILTER_ARGS, "--bits", "32",
                                *(["--zero-phase"] if zp else [])])
            y, _ = open_audio_file(os.path.join(out, f"{stem[src]}_filt.wav"))
            t0 = time.perf_counter()
            ref = np.stack([
                ss.sosfiltfilt(sos, c.astype(np.float64),
                               padlen=3 * (2 * len(sos) + 1)) if zp
                else ss.sosfilt(sos, c.astype(np.float64)) for c in x])
            f_ref_s[name] = time.perf_counter() - t0
            f_err[name] = float(np.abs(y - ref).max()) / peak
            check(y.shape == x.shape and f_err[name] <= FILTER_BOUND,
                  f"{name}: max|err| {f_err[name]:.3g} of the input's peak "
                  f"against scipy f64 (bound {FILTER_BOUND})")
            del y, ref
        del x
    x10, sr10 = open_audio_file(p10)
    sos10 = _filter_sos_from_args(_build_parser().parse_args(
        ["filter", p10, *FILTER_ARGS]), sr10)
    card_cpu = 0.0
    for fn in (sosfilt_streamed, filtfilt):
        for c in x10:
            card_cpu = max(card_cpu, float(np.abs(
                fn(sos10, c, device=dev) - fn(sos10, c, device="cpu")).max()))
    check(card_cpu <= 2e-5, f"filter of the 10 s track, card vs CPU: "
          f"{card_cpu}")
    hx = open_audio_mono_ex(hour)[0]
    sos_h = _filter_sos_from_args(_build_parser().parse_args(
        ["filter", hour, *FILTER_ARGS]), 48000)
    _, ff_s = synced_s(lambda: filtfilt(sos_h, hx, device=dev))
    _, fw_s = synced_s(lambda: sosfilt_streamed(sos_h, hx, device=dev))
    del hx
    print(f"[filter] {smi}; " + "; ".join(
        f"{k} {wall[k]:.3f} s (max|err| {f_err[k]:.3g} of the peak vs scipy "
        f"f64, its {f_ref_s[k]:.1f} s on the host)" for k in f_err)
        + f"; library calls on the hour: sosfilt_streamed {fw_s:.3f} s, "
        f"filtfilt {ff_s:.3f} s (host extension and copies included); the "
        f"10 s track card vs CPU max|err| {card_cpu:.3g}; bound "
        f"{FILTER_BOUND} of the peak, no mel launch")

    # ---- 2. reconstruct: phase 8's mel export of the 48 kHz song
    db_path = os.path.join(front["render_dir"], f"db_{stem[paths[-1]]}.npy")
    db = np.load(db_path)
    out, log = leg("reconstruct", ["reconstruct", db_path, "--sr", "48000",
                                   "-o", os.path.join(d, "recon.wav")])
    y, sr = open_audio_file(os.path.join(d, "recon.wav"))
    mag, p = target_magnitude(db, 48000, dev)
    sc = spectral_convergence(y[0], mag, 48000, dev)
    y1 = griffin_lim(mag, p.win_length, p.hop_length, p.n_fft)
    y2, gl_s = synced_s(lambda: griffin_lim(mag, p.win_length, p.hop_length,
                                            p.n_fft))
    check(np.array_equal(y1, y2), "griffin_lim: two card runs differ")
    check(y.shape == (1, (db.shape[0] - 1) * p.hop_length)
          and float(np.abs(y - np.clip(y1, -1, 1)).max()) <= 2**-14,
          "reconstruct's WAV != griffin_lim on the card")
    w10 = open_audio_mono_ex(p10)[0]
    r10 = os.path.join(d, "r10")
    check(run_cli(["render", p10, "--save-db", "--no-wav", "-o", r10,
                   "--device", "cpu"])[0] == 0, "render of the 10 s track")
    db10 = np.load(os.path.join(r10, f"db_{stem[p10]}.npy"))
    mag10, p10p = target_magnitude(db10, sr10, "cpu")
    y10 = griffin_lim(mag10, p10p.win_length, p10p.hop_length, p10p.n_fft)
    sc10 = spectral_convergence(y10, mag10, sr10, "cpu")
    check(sc <= sc10 + SC_MARGIN, f"reconstruct: spectral convergence {sc:.4f}"
          f" > the CPU's {sc10:.4f} on the 10 s track + {SC_MARGIN}")
    # one iteration, card vs CPU: on the track's own |STFT|; on the mel
    # inversion's estimate (bins clamped to 0, pinv rounding) the phase of
    # near-zero bins of the re-analysis follows rounding, so that one is
    # printed, not held
    gl_err = {}
    stft10 = stft_magnitude(w10, p10p.win_length, p10p.hop_length,
                            p10p.n_fft, device="cpu")
    for what, m in (("stft", stft10[0][:stft10[1]]), ("mel", mag10)):
        one = [griffin_lim(m_, p10p.win_length, p10p.hop_length,
                           p10p.n_fft, n_iter=1) for m_ in (m.to(dev), m)]
        gl_err[what] = float(np.abs(one[0] - one[1]).max()
                             / np.abs(one[1]).max())
    check(gl_err["stft"] <= 1e-4, f"griffin_lim n_iter=1 of the 10 s "
          f"track's |STFT|, card vs CPU: {gl_err['stft']:.3g} of the peak")
    print(f"[reconstruct] {smi}; reconstruct of the 48 kHz song's --save-db"
          f" export ({db.shape[0]} frames x {db.shape[1]} mel, 32 "
          f"iterations) {wall['reconstruct']:.3f} s wall, griffin_lim alone "
          f"{gl_s:.3f} s; spectral convergence {sc:.4f} (the CPU's on the "
          f"10 s track {sc10:.4f}, margin {SC_MARGIN}); two card runs "
          f"bit-equal; n_iter=1 card vs CPU on the 10 s track's |STFT| "
          f"{gl_err['stft']:.3g} of the peak (bound 1e-4), on its mel "
          f"inversion {gl_err['mel']:.3g}; no mel launch")
    del y, y1, y2, mag, one

    # ---- 3. features --kind: the seven songs at 16 kHz on the card, the
    # 10 s track against --device cpu
    ns = _build_parser().parse_args(["features", p10])
    x16 = {dv_: resample(w10, sr10, 16000, device=dv_) for dv_ in
           (dev, "cpu")}
    with precision_mode_scope("parity"):
        planes = [F.log_mel_spectrogram(x16[k], 16000, spec="power",
                                        log="power_db") for k in (dev, "cpu")]
    db_err, db_note = check_f32(planes[0].cpu(), planes[1],
                                "the power dB plane of mfcc, pcen and onsets")
    f_note, f_bad = [], []
    for kind, bound in CARD_FEATURE_BOUNDS.items():
        out, log = leg(f"features --kind {kind}",
                       ["features", *paths, "--kind", kind])
        got = np.load(os.path.join(out, f"feats_{kind}_{stem[paths[4]]}.npy"))
        x = resample(open_audio_mono_ex(paths[4])[0], 44100, 16000,
                     device=dev)
        check(np.array_equal(got, _feature(kind, x, 16000, ns)[0].astype(
            np.float32)), f"features --kind {kind} != the library call")
        # in parity, where the port tests' tolerances hold (fast mode
        # rounds to bf16 after each f32 GEMM, so an f32 summation order
        # may move a value by one bf16 step)
        with precision_mode_scope("parity"):
            card, cpu = (_feature(kind, x16[k], 16000, ns)[0] for k in
                         (dev, "cpu"))
        check(card.shape == cpu.shape, f"{kind}: {card.shape} {cpu.shape}")
        if bound is None:
            ok, note = np.array_equal(card, cpu), "equal"
        elif kind == "mfcc":
            # an orthonormal DCT-II GEMM of the power dB plane: held to the
            # forward error bound of its dot products (the planes' own
            # difference, which f32_agree holds above, through |D|, plus
            # twice gamma_n = n u / (1 - n u) of |D|^T |dB|: both f32
            # GEMMs' rounding)
            dct = np.abs(F._dct2_matrix(ns.n_mfcc, ns.n_mel)).astype(
                np.float64)
            dbs = [t.cpu().numpy().astype(np.float64) for t in planes]
            n_u = ns.n_mel * 2.0**-24
            lim = (np.abs(dbs[0] - dbs[1]) @ dct
                   + 2 * n_u / (1 - n_u) * (np.abs(dbs[1]) @ dct))
            dif = np.abs(card - cpu)
            ok = bool((dif <= lim).all())
            note = (f"max|err| {dif.max():.3g}, at most "
                    f"{(dif / lim).max():.2f} of its dot-product bound")
        else:
            dif = np.abs(card - cpu)
            off = dif > bound[1] + bound[0] * np.abs(cpu)
            # contrast: chip_smoke's f32_agree share for deep valleys
            ok = off.mean() <= (FLOOR_SHARE if kind == "contrast" else 0.0)
            note = (f"max|err| {dif.max():.3g}, {off.sum()} of {off.size} "
                    f"over rtol {bound[0]:g} atol {bound[1]:g}")
        if not ok:
            f_bad.append(f"{kind}: {note}")
        f_note.append(f"{kind} {wall[f'features --kind {kind}']:.3f} s "
                      f"(10 s track card vs CPU: {note})")
    print(f"[features] {smi}; features --kind of the seven songs (resampled "
          f"to 16 kHz on the card), wall: " + "; ".join(f_note)
          + f"; each .npy == the library call; the power dB plane under "
          f"mfcc and onsets, card vs CPU max|err| {db_err:.3g} dB "
          f"({db_note}); no mel launch")

    # ---- 4. loudness: info --loudness and gain of the songs and the hour
    _, log = leg("info --loudness", ["info", *paths, hour, "--loudness"])
    found = re.findall(r"loudness=([-\d.]+)LUFS", log)
    check(len(found) == len(paths) + 1, f"info --loudness: {log}")
    out, log = leg("gain", ["gain", *paths, hour, "--lufs", "-23"])
    g48 = open_audio_file(os.path.join(out, f"{stem[paths[-1]]}_norm.wav"))[0]
    lufs_g = L.integrated_loudness(g48, 48000, device=dev)
    check(abs(lufs_g + 23.0) <= 0.05, f"gain --lufs -23: {lufs_g:.3f} LUFS")
    hw = open_audio_file(hour)[0]
    r_h, hour_s = synced_s(lambda: L.r128_stats(hw, 48000, device=dev))
    del hw
    l_err = {}
    for name, fn, tol in (("lufs", L.integrated_loudness, 0.01),
                          ("lra", L.loudness_range, 0.01),
                          ("dbtp", L.true_peak, 1e-4)):
        l_err[name] = abs(fn(x10, sr10, device=dev)
                          - fn(x10, sr10, device="cpu"))
        check(l_err[name] <= tol, f"{name} of the 10 s track, card vs CPU: "
              f"{l_err[name]:.3g} (bound {tol})")
    print(f"[loudness] {smi}; info --loudness of the seven songs and the "
          f"hour {wall['info --loudness']:.3f} s wall; gain --lufs -23 "
          f"{wall['gain']:.3f} s (the 48 kHz song re-measures "
          f"{lufs_g:.3f} LUFS); r128_stats of the hour {hour_s:.3f} s "
          f"({r_h}); 10 s track card vs CPU: LUFS {l_err['lufs']:.3g}, LRA "
          f"{l_err['lra']:.3g}, true peak {l_err['dbtp']:.3g} dB; no mel "
          f"launch")

    # ---- 5. the viewer's onsets, beats and loudness routes (phase 8's
    # server: the seven songs and the hour, on the card)
    base, tids = front["viewer"], front["viewer_ids"]
    hid = tids[-1]
    # the viewer's mono views, decoded as its session decodes them
    tracks = {t: AudioTrack(q, SpecSetting()) for t, q in
              zip(tids, [*paths, hour])}

    def direct(route, tid, s0, s1):
        tr = tracks[tid]
        sr_ = tr.sr
        a = min(max(0, int(s0 * sr_)), tr.n_samples)
        b = min(tr.n_samples, int(s1 * sr_), a + 120 * sr_)
        w = tr.wav_slice(a, b)
        if route == "onsets":  # the viewer's short-window rules
            return {"t": [] if len(w) < sr_ // 10 else [
                round(a / sr_ + float(v), 3)
                for v in F.onset_detect(w, sr_, device=dev)]}
        if len(w) < sr_:
            return {"bpm": 0.0, "t": []}
        bpm, beats = beat_track(w, sr_, device=dev)
        return {"bpm": round(float(bpm), 1),
                "t": [round(a / sr_ + float(v), 3) for v in beats]}

    def stats():
        return json.loads(http(base + "/api/stats")[1])["render_cache"]

    lat, v_legs = {}, []
    for route in ("onsets", "beats", "loudness"):
        urls = [(t, f"/api/{route}/{t}" + ("" if route == "loudness" else
                                           "?start=30&end=60")) for t in tids]
        if route != "loudness":  # 10 windows of the hour
            urls += [(hid, f"/api/{route}/{hid}?start={a:g}&end={a + 30:g}")
                     for a in np.round(np.linspace(200, 3300, 10))]
        lat[route] = []
        (_, n) = counted(K, lambda: [lat[route].append(http(base + u)[2])
                                     for _, u in urls])
        check(n == counts(), f"/api/{route}: launches {n}")
        v_legs.append((f"viewer {route}", n))
        h0 = stats()["hits"]
        for tid, u in urls:
            code, body, _ = http(base + u)
            got = json.loads(body)
            if route == "loudness":
                tr = tracks[tid]
                want = L.r128_stats(tr.wav_slice(0, tr.n_samples), tr.sr,
                                    device=dev)
            else:
                q = dict(kv.split("=") for kv in u.split("?")[1].split("&"))
                want = direct(route, tid, float(q["start"]), float(q["end"]))
            check(code == 200 and got == json.loads(json.dumps(want)),
                  f"{u}: {got} != the direct call's {want}")
        check(stats()["hits"] - h0 == len(urls), f"/api/{route}: the second "
              "requests were not all cache hits")
    legs += v_legs
    check(not f_bad, "features on the 10 s track, card vs CPU in parity: "
          + "; ".join(f_bad))
    print(f"[viewer] {smi}; /api/onsets, /api/beats (30 s windows of the "
          f"songs and the hour, then 10 windows of the hour) and "
          f"/api/loudness (whole tracks: the seven songs and the hour), each "
          f"response == the direct library call on the card, every second "
          f"request a cache hit, no mel launch; first-request latency: "
          + "; ".join(f"{r} p50 {np.percentile(v, 50) * 1e3:.1f} ms p90 "
                      f"{np.percentile(v, 90) * 1e3:.1f} ms" for r, v in
                      lat.items()))
    torch.cuda.empty_cache()
    return legs


def melody_wav(rng, path, sr=16000, notes=8, dur=0.5, gap=0.15):
    """A PCM16 melody of ``notes`` seeded MIDI notes (55-79, no note twice
    in a row: a repeat across a short gap may read as one note), each
    ``dur`` seconds with 10 ms ramps and ``gap`` seconds of silence after
    (tests/test_transcribe.py's melody); returns the MIDI numbers."""
    from msv_tpu_torch.io.audio import write_wav

    midi = [int(rng.integers(55, 80))]
    while len(midi) < notes:
        m = int(rng.integers(55, 80))
        if m != midi[-1]:
            midi.append(m)
    t = np.arange(int(dur * sr)) / sr
    env = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.01)
    parts = [np.zeros(int(gap * sr))]
    for m in midi:
        hz = 440.0 * 2.0 ** ((m - 69) / 12.0)
        parts += [0.4 * env * np.sin(2 * np.pi * hz * t),
                  np.zeros(int(gap * sr))]
    write_wav(path, np.concatenate(parts).astype(np.float32)[None], sr)
    return [int(m) for m in midi]


def peak_hz(y, sr):
    """The strongest frequency of a Hann-windowed clip."""
    mag = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    return np.argmax(mag) * sr / len(y)


# tests/test_torch_effects.py's sample-by-sample bounds, of the peak
STRETCH_MAX, STRETCH_P99 = 0.05, 1e-3
# dB: the 10 s track's LPC envelope, card vs CPU in parity.  Two runs of
# this script on an H100 both read 9.1e-3 dB (PERF.md, phase 10): the port
# test's 1e-3 dB holds against msv_tpu on the CPU, where both round alike;
# on the card the envelope's nulls follow the coefficients' f32 rounding.
# About 5x the reading.
LPCENV_DB = 0.05


def phase_analysis2(K, smi, song, hour, eight, front, work, dev="cuda"):
    """10: pitch, Viterbi and DTW, LPC and formants, tonal features,
    segmentation, transcription, time-stretch, trimming and alignment, as
    users run them."""
    import concurrent.futures
    import re

    from msv_tpu_torch import AudioTrack, SpecSetting, precision_mode_scope
    from msv_tpu_torch import features as F
    from msv_tpu_torch.cli import _build_parser, _feature
    from msv_tpu_torch.io.audio import (open_audio_file, open_audio_mono_ex,
                                        write_wav)
    from msv_tpu_torch.ops import sequence as S
    from msv_tpu_torch.ops import segment as G
    from msv_tpu_torch.ops.align import align_offset
    from msv_tpu_torch.ops.effects import pitch_shift, time_stretch, trim
    from msv_tpu_torch.ops.lpc import formant_track, lpc
    from msv_tpu_torch.ops.mel import hz_to_mel
    from msv_tpu_torch.ops.pitch import yin
    from msv_tpu_torch.ops.resample import resample
    from msv_tpu_torch.ops.tonal import estimate_key
    from msv_tpu_torch.ops.transcribe import transcribe_notes, write_midi
    from msv_tpu_torch.viewer import analysis_window

    rng = np.random.default_rng(SEED + 10)
    paths, p10, _, _ = song
    stem = {q: os.path.splitext(os.path.basename(q))[0]
            for q in (*paths, p10, hour, eight)}
    d = tempfile.mkdtemp(prefix="msv_chip_analysis2_", dir=work)
    legs, wall = [], {}
    dv = ["--device", dev]

    def leg(name, args, want=None):
        """One counted CLI run: (output dir, its stdout); ``want`` is the
        launch count it must leave (default none)."""
        out = os.path.join(d, re.sub(r"\W+", "_", name))
        (rc, log, wall[name]), n = counted(
            K, lambda: run_cli([*args, "-o", out, *dv]))
        check(rc == 0, f"{name}: exit {rc}; {log}")
        check(n == (want or counts()), f"{name}: launches {n}, expected "
              f"{want or counts()}")
        legs.append((f"cli {name}", n))
        return out, log

    def synced_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # ---- 1. features --kind of the seven songs; the 10 s track card vs
    # CPU in parity
    ns = _build_parser().parse_args(["features", p10])
    w10, sr10 = open_audio_mono_ex(p10)[:2]
    x16 = {k: resample(w10, sr10, 16000, device=k) for k in (dev, "cpu")}
    x4 = resample(open_audio_mono_ex(paths[4])[0], 44100, 16000, device=dev)
    step = 5500.0 / 1023  # formant_track's default grid step
    notes, bad = [], []
    for kind in ("f0", "f0v", "tonnetz", "key", "lpcenv", "formants",
                 "segments"):
        out, _ = leg(f"features --kind {kind}",
                     ["features", *paths, "--kind", kind],
                     counts(fast=len(paths)) if kind == "segments" else None)
        got = np.load(os.path.join(out, f"feats_{kind}_{stem[paths[4]]}.npy"))
        check(np.array_equal(got, _feature(kind, x4, 16000, ns)[0].astype(
            np.float32), equal_nan=True),
            f"features --kind {kind} != the library call")
        with precision_mode_scope("parity"):
            card, cpu = (_feature(kind, x16[k], 16000, ns)[0] for k in
                         (dev, "cpu"))
            if kind == "lpcenv":  # the coefficients under the envelope
                coef = [lpc(x16[k], order=int(2 + 16000 / 1000),
                            frame_length=1024) for k in (dev, "cpu")]
        check(card.shape == cpu.shape, f"{kind}: {card.shape} {cpu.shape}")
        dif = np.abs(card - cpu)
        if kind == "f0":
            ok = (bool((dif[:, 0] <= 5e-3 * np.abs(cpu[:, 0])).all())
                  and bool((dif[:, 1] <= 5e-4 + 5e-2 * cpu[:, 1]).all()))
            note = (f"f0 max rel {(dif[:, 0] / cpu[:, 0]).max():.3g}, ap "
                    f"max|err| {dif[:, 1].max():.3g}")
        elif kind in ("f0v", "segments"):
            ok, note = np.array_equal(card, cpu), "equal"
        elif kind in ("tonnetz", "key"):
            tol = 1e-5 if kind == "tonnetz" else 1e-4
            ok, note = bool(dif.max() <= tol), f"max|err| {dif.max():.3g}"
        elif kind == "lpcenv":
            (a, g), (ca, cg) = ((c[0].cpu().numpy(), c[1].cpu().numpy())
                                for c in coef)
            a_err = np.abs(a - ca).max()
            g_err = np.abs(g / cg - 1).max()
            ok = bool(a_err <= 2e-3 and g_err <= 2e-3
                      and dif.max() <= LPCENV_DB)
            note = (f"coefficients max|err| {a_err:.3g}, g2 max rel "
                    f"{g_err:.3g}; envelope max|err| {dif.max():.3g} dB "
                    f"(bound {LPCENV_DB})")
        else:  # formants
            same_nan = np.array_equal(np.isnan(card), np.isnan(cpu))
            err = np.nanmax(dif) if np.isfinite(card).any() else 0.0
            ok = same_nan and err <= step
            note = f"max|err| {err:.3g} Hz, NaN alike {same_nan}"
        if not ok:
            bad.append(f"{kind}: {note}")
        notes.append(f"{kind} {wall[f'features --kind {kind}']:.3f} s "
                     f"(10 s track card vs CPU: {note})")
    check(not bad, "features on the 10 s track, card vs CPU in parity: "
          + "; ".join(bad))
    print(f"[features2] {smi}; features --kind of the seven songs "
          f"(resampled to 16 kHz on the card), wall: " + "; ".join(notes)
          + "; each .npy == the library call; segments: one fast launch a "
          "song, the others none")

    # ---- 2. segments of the hour: one launch, fast then parity; the SSM
    # and novelty GEMMs timed apart
    seg = {}
    for mode in ("fast", "parity"):
        name = f"features --kind segments of the hour ({mode})"
        with precision_mode_scope(mode):
            out, _ = leg(name, ["features", hour, "--kind", "segments"],
                         counts(**{mode: 1}))
        seg[mode] = np.load(os.path.join(out,
                                         f"feats_segments_{stem[hour]}.npy"))
    xh = resample(open_audio_mono_ex(hour)[0], 48000, 16000, device=dev)
    mel, mel_s = synced_s(lambda: F.log_mel_spectrogram(xh, 16000, n_mel=64,
                                                        hop_ms=10.0))
    t = (mel.shape[0] // 50) * 50
    pooled = mel[:t].reshape(-1, 50, 64).mean(dim=1)
    pooled = pooled - pooled.mean(dim=0, keepdim=True)
    del mel, xh
    ssm, ssm_s = synced_s(lambda: G.self_similarity(pooled))
    nov, nov_s = synced_s(lambda: G.novelty_from_ssm(ssm, kernel_size=16))
    n_ssm = ssm.shape[0]
    check(n_ssm == t // 50 and np.isfinite(nov).all(),
          f"the hour's SSM: {tuple(ssm.shape)}")
    with precision_mode_scope("fast"):
        bounds = G.segment_boundaries(pooled, kernel_size=16)
    check(np.array_equal(seg["fast"], (bounds * 0.5).astype(np.float32)),
          "features --kind segments of the hour != its library steps")
    del ssm, pooled
    print(f"[segments] {smi}; features --kind segments of the hour "
          f"({n_ssm} pooled frames): fast "
          f"{wall['features --kind segments of the hour (fast)']:.3f} s (1 "
          f"fast launch, {len(seg['fast'])} boundaries), parity "
          f"{wall['features --kind segments of the hour (parity)']:.3f} s "
          f"(1 parity launch, {len(seg['parity'])} boundaries); library "
          f"steps, fast: log_mel_spectrogram {mel_s:.3f} s, the {n_ssm} x "
          f"{n_ssm} SSM GEMM {ssm_s:.3f} s, the band and novelty GEMM "
          f"{nov_s:.3f} s")
    torch.cuda.empty_cache()

    # ---- 3. f0v of the 8-minute file: YIN and the two Viterbi decodes
    out, _ = leg("features --kind f0v of the 8-minute file",
                 ["features", eight, "--kind", "f0v"])
    xe = resample(open_audio_mono_ex(eight)[0], 44100, 16000, device=dev)
    (f0, ap), yin_s = synced_s(lambda: yin(xe, 16000,
                                           with_aperiodicity=True))
    decode_s, real = [], S.viterbi_log

    def timed(*a, **kw):
        r, dt = synced_s(lambda: real(*a, **kw))
        decode_s.append(dt)
        return r

    S.viterbi_log = timed
    try:
        f0s, voiced = S.smooth_f0_viterbi(f0.cpu().numpy(), ap.cpu().numpy(),
                                          device=dev)
    finally:
        S.viterbi_log = real
    got = np.load(os.path.join(out, f"feats_f0v_{stem[eight]}.npy"))
    check(np.array_equal(got, np.stack([f0s, voiced.astype(np.float32)],
                                       axis=1)),
          "features --kind f0v of the 8-minute file != the library call")
    # the pitch decode without graphs: the same path, eagerly launched
    fmin, fmax, bps = 65.0, 2093.0, 4
    n_bins = int(np.ceil(12.0 * bps * np.log2(fmax / fmin))) + 1
    cents = np.arange(n_bins) * (100.0 / bps)
    v = np.clip(1.0 - 2.0 * ap.cpu().numpy().astype(np.float64), 1e-6,
                1 - 1e-6)
    z = (cents[None, :] - 1200.0 * np.log2(np.maximum(
        f0.cpu().numpy().astype(np.float64), 1e-6) / fmin)[:, None]) / 50.0
    log_obs = v[:, None] * np.log(0.95 * np.exp(-0.5 * z * z) + 0.05 / n_bins)
    dz = (cents[None, :] - cents[:, None]) / 70.0
    tv = np.exp(-0.5 * dz * dz)
    tv /= tv.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore"):
        log_tv = np.log(tv)
    (gp, _), graph_s = synced_s(lambda: S.viterbi_log(log_obs, log_tv,
                                                      device=dev))
    block = S.GRAPH_BLOCK
    S.GRAPH_BLOCK = 1 << 40
    try:
        (ep, _), eager_s = synced_s(lambda: S.viterbi_log(
            log_obs, log_tv, device=dev))
    finally:
        S.GRAPH_BLOCK = block
    check(np.array_equal(gp, ep), "Viterbi: graphed != eager path")
    steps = len(f0) - 1
    print(f"[viterbi] {smi}; features --kind f0v of the 8-minute file "
          f"{wall['features --kind f0v of the 8-minute file']:.3f} s: YIN of "
          f"{len(f0)} frames {yin_s:.3f} s, voicing decode (2 states) "
          f"{decode_s[0]:.3f} s, pitch decode ({n_bins} states) "
          f"{decode_s[1]:.3f} s = {decode_s[1] / steps * 1e6:.1f} us a step "
          f"({steps} steps, CUDA graphs of {block} steps); the pitch decode "
          f"again: graphed {graph_s:.3f} s, eager {eager_s:.3f} s "
          f"({eager_s / steps * 1e6:.1f} us a step), paths equal")
    del xe, f0, ap

    # ---- 4. transcribe of a seeded eight-note melody
    mel_path = os.path.join(d, "melody.wav")
    midi = melody_wav(rng, mel_path)
    out, _ = leg("transcribe", ["transcribe", mel_path])
    got = json.load(open(os.path.join(out, "notes_melody.json")))
    wm, srm = open_audio_mono_ex(mel_path)[:2]
    lib = transcribe_notes(wm, srm, device=dev)
    check([n["midi"] for n in got["notes"]] == midi,
          f"transcribe: midi {[n['midi'] for n in got['notes']]} != {midi}")
    check(got == {"sr": srm, "notes": json.loads(json.dumps(lib))},
          "transcribe: .json != the library call")
    write_midi(os.path.join(d, "lib.mid"), lib)
    with open(os.path.join(out, "notes_melody.mid"), "rb") as f, \
            open(os.path.join(d, "lib.mid"), "rb") as g:
        check(f.read() == g.read(), "transcribe: .mid != write_midi")

    # ---- 5. stretch of the 48 kHz song's channel 0 (one harmonic series,
    # so its strongest frequency is its fundamental; the two channels'
    # series trade places in the mono sum): --rate 0.5 and --semitones 3
    s48 = paths[-1]
    w48 = open_audio_mono_ex(s48, channel=0)[0]
    st_note = []
    for flag, tag in ((["--rate", "0.5"], "x0.5"),
                      (["--semitones", "3"], "ps+3")):
        out, _ = leg(f"stretch {tag}", ["stretch", s48, "--channel", "0",
                                        *flag])
        y = open_audio_file(os.path.join(
            out, f"{stem[s48]}_ch0_{tag}.wav"))[0][0]
        if tag == "x0.5":
            fn = lambda dev_, w=w48: time_stretch(w, 0.5, device=dev_)  # noqa: E731,E501
            a = y[len(y) // 4: len(y) // 4 + 480000]  # input's 1/4 on
            want_hz = peak_hz(w48[len(w48) // 4: len(w48) // 4 + 240000],
                              48000)
        else:
            fn = lambda dev_, w=w48: pitch_shift(w, 48000, 3.0, device=dev_)  # noqa: E731,E501
            a = y[len(y) // 4: len(y) // 4 + 240000]
            want_hz = peak_hz(w48[len(w48) // 4: len(w48) // 4 + 240000],
                              48000) * 2 ** 0.25
        got_hz = peak_hz(a, 48000)
        check(abs(got_hz - want_hz) <= 2 * 48000 / len(a) + 1.0,
              f"stretch {tag}: peak {got_hz:.2f} Hz, expected {want_hz:.2f}")
        r1, lib_s = synced_s(lambda: fn(dev))
        check(np.array_equal(r1, fn(dev)), f"stretch {tag}: two card runs "
              "differ")
        write_wav(os.path.join(d, "lib.wav"), r1[None], 48000)
        check(np.array_equal(y, open_audio_file(os.path.join(
            d, "lib.wav"))[0][0]), f"stretch {tag}: WAV != the library call")
        c10 = (time_stretch(w10, 0.5, device=dev), time_stretch(
            w10, 0.5, device="cpu")) if tag == "x0.5" else (
            pitch_shift(w10, sr10, 3.0, device=dev),
            pitch_shift(w10, sr10, 3.0, device="cpu"))
        err = np.abs(c10[0] - c10[1]) / np.abs(c10[1]).max()
        check(err.max() <= STRETCH_MAX
              and np.percentile(err, 99) <= STRETCH_P99,
              f"stretch {tag}: the 10 s track card vs CPU max "
              f"{err.max():.3g}, p99 {np.percentile(err, 99):.3g}")
        st_note.append(f"{tag} {wall[f'stretch {tag}']:.3f} s wall, library "
                       f"{lib_s:.3f} s, peak {got_hz:.2f} Hz (expected "
                       f"{want_hz:.2f}), 10 s track card vs CPU max "
                       f"{err.max():.3g} p99 {np.percentile(err, 99):.3g} "
                       f"of the peak")

    # ---- 6. trim of a song padded with silence; align of the 48 kHz song
    # against a copy delayed by a seeded offset
    st, _ = open_audio_file(s48)
    pad_path = os.path.join(d, "padded.wav")
    lead, tail, body = 3 * 48000, 2 * 48000, min(30 * 48000, st.shape[1])
    write_wav(pad_path, np.concatenate(
        [np.zeros((st.shape[0], lead), np.float32), st[:, :body],
         np.zeros((st.shape[0], tail), np.float32)], axis=1), 48000)
    out, _ = leg("trim", ["trim", pad_path])
    wp = open_audio_mono_ex(pad_path)[0]
    y = open_audio_file(os.path.join(out, "padded_trim.wav"))[0][0]
    cut, (ta, tb) = trim(wp, 48000, device=dev)
    write_wav(os.path.join(d, "lib.wav"), cut[None], 48000)
    check(np.array_equal(y, open_audio_file(os.path.join(
        d, "lib.wav"))[0][0]) and abs(ta - lead) <= 2048
          and abs(tb - (lead + body)) <= 2048,
          f"trim: [{ta}, {tb}) of a song padded by {lead} and {tail}")
    delay = float(rng.uniform(0.5, 5.0))
    late_path = os.path.join(d, "late.wav")
    write_wav(late_path, np.concatenate(
        [np.zeros((st.shape[0], int(round(delay * 48000))), np.float32),
         st], axis=1)[:, :st.shape[1]], 48000)
    del st
    _, log = leg("align", ["align", s48, late_path])
    found = re.findall(r"offset ([-+\d.]+)s", log)
    r_al, al_s = synced_s(lambda: align_offset(
        open_audio_mono_ex(s48)[0], 48000, open_audio_mono_ex(late_path)[0],
        48000, device=dev))
    check(len(found) == 1 and found[0] == f"{r_al.offset_s:+.4f}"
          and abs(r_al.offset_s - round(delay * 48000) / 48000) <= 1e-3,
          f"align: printed {found}, library {r_al}, delay {delay:.6f} s")

    # ---- 7. dtw on the chroma of two songs (30 s each), card vs CPU
    ch = [F.chroma_stft(open_audio_mono_ex(q)[0][:30 * sr_], sr_,
                        precision="parity", device=dev).cpu().numpy()
          for q, sr_ in ((paths[0], 8000), (paths[-1], 48000))]
    (acc, path, total), dtw_s = synced_s(lambda: S.dtw(ch[0], ch[1],
                                                       device=dev))
    cacc, cpath, _ = S.dtw(ch[0], ch[1], device="cpu")
    check(np.allclose(acc, cacc, rtol=1e-5, atol=1e-5)
          and np.array_equal(path, cpath), "dtw: card != CPU")
    n_diag = ch[0].shape[0] + ch[1].shape[0] - 1
    print(f"[effects] {smi}; transcribe of a seeded eight-note melody "
          f"{wall['transcribe']:.3f} s (midi {midi} recovered, .json and "
          f".mid == the library call); stretch of the 48 kHz song: "
          + "; ".join(st_note) + f"; two card runs bit-equal; trim of a song "
          f"padded with silence {wall['trim']:.3f} s ([{ta}, {tb})); align "
          f"against a copy {delay:.4f} s later {wall['align']:.3f} s wall, "
          f"library {al_s:.3f} s, offset {r_al.offset_s:.6f} s, confidence "
          f"{r_al.confidence:.3f}; dtw of two 30 s chromagrams "
          f"({ch[0].shape[0]} x {ch[1].shape[0]}) {dtw_s:.3f} s, "
          f"{4 * (n_diag - 1)} wavefront launches, card == CPU (rtol 1e-5, "
          f"paths equal); no mel launch")

    # ---- 8. the viewer's analysis routes (phase 8's server)
    base, tids = front["viewer"], front["viewer_ids"]
    hid = tids[-1]
    tracks = {t_: AudioTrack(q, SpecSetting()) for t_, q in
              zip(tids, [*paths, hour])}

    def window(tid, s0, s1, cap):
        tr = tracks[tid]
        a, b = analysis_window(tr.n_samples, tr.sr, s0, s1, cap)
        return tr, a, tr.wav_slice(a, b)

    def rel(hz, sr_):
        half = np.float32(sr_) / np.float32(2.0)
        return np.asarray(hz_to_mel(np.asarray(hz, np.float32))) / float(
            hz_to_mel(half))

    def direct(route, tid, q):
        """The route's body from the library calls, as the viewer makes
        it."""
        s0 = float(q.get("start", 0.0))
        if route == "pitch":
            tr, a, w = window(tid, s0, float(q["end"]), 120)
            fmax_ = min(2093.0, tr.sr / 2.0 * 0.99)
            f, ap_ = (v.cpu().numpy() for v in yin(
                w, tr.sr, fmax=fmax_, with_aperiodicity=True, device=dev))
            if q.get("smooth") == "1":
                f, vo = S.smooth_f0_viterbi(f, ap_, fmax=fmax_, device=dev)
                ap_ = np.where(vo, 0.0, 1.0).astype(np.float32)
            return {"t0": a / tr.sr, "hop_s": 512 / tr.sr,
                    "f0": [round(float(v_), 2) for v_ in f],
                    "ap": [round(float(v_), 3) for v_ in ap_],
                    "rel": [round(float(v_), 4) for v_ in rel(f, tr.sr)]}
        if route == "formants":
            tr, a, w = window(tid, s0, float(q["end"]), 120)
            f, hop_s, _ = formant_track(w, tr.sr, n_formants=4,
                                        fmax=min(5500.0, tr.sr / 2.0),
                                        device=dev)
            f = f.cpu().numpy()
            r, ok = rel(f, tr.sr), np.isfinite(f)
            return {"t0": a / tr.sr, "hop_s": hop_s,
                    "f": [[round(float(v_), 1) if o else None for v_, o in
                           zip(row, okr)] for row, okr in zip(f, ok)],
                    "rel": [[round(float(v_), 4) if o else None for v_, o in
                             zip(row, okr)] for row, okr in zip(r, ok)]}
        if route == "segments":
            tr, a, w = window(tid, s0, float(q["end"]), 600)
            ks = max(1.5, min(8.0, len(w) / tr.sr / 4.0))
            return {"t": [round(a / tr.sr + float(v_), 3) for v_ in
                          G.segment(w, tr.sr, hop_s=0.5, kernel_s=ks,
                                    device=dev)]}
        if route == "notes":
            tr, a, w = window(tid, s0, float(q["end"]), 120)
            ns_ = transcribe_notes(w, tr.sr, fmax=min(2093.0, tr.sr / 2.0
                                                      * 0.99), device=dev)
            for nt in ns_:
                nt["start"] = round(nt["start"] + a / tr.sr, 6)
                nt["end"] = round(nt["end"] + a / tr.sr, 6)
                nt["rel"] = round(float(rel(nt["hz"], tr.sr)), 4)
            return {"notes": ns_}
        if route == "key":
            tr = tracks[tid]
            tonic, mode, r, _ = estimate_key(
                tr.wav_slice(0, min(tr.n_samples, 600 * tr.sr)), tr.sr,
                device=dev)
            return {"tonic": tonic, "mode": mode,
                    "r": None if tonic is None else round(r, 3)}
        ta_, tb_ = tracks[int(q["ref"])], tracks[tid]
        r = align_offset(ta_.wav_slice(0, ta_.n_samples), ta_.sr,
                         tb_.wav_slice(0, tb_.n_samples), tb_.sr,
                         max_lag_s=30.0, device=dev)
        return {"ref": int(q["ref"]), "id": tid,
                "offset_s": round(r.offset_s, 6),
                "confidence": round(r.confidence, 4),
                "coarse_s": round(r.coarse_s, 4)}

    def stats():
        return json.loads(http(base + "/api/stats")[1])["render_cache"]

    hour_s = tracks[hid].n_samples / tracks[hid].sr
    hour_w = [int(a) for a in np.round(np.linspace(0.05, 0.9, 4) * hour_s)]
    w0, w1 = min(30.0, SECONDS / 4), min(30.0, SECONDS / 4) + 30.0
    routes = {
        "pitch": [f"/api/pitch/{t_}?start={w0:g}&end={w1:g}" for t_ in tids]
        + [f"/api/pitch/{hid}?start={a}&end={a + 30}" for a in hour_w],
        "pitch smooth=1": [f"/api/pitch/{t_}?start={w0:g}&end={w1:g}"
                           f"&smooth=1" for t_ in tids],
        "formants": [f"/api/formants/{t_}?start={w0:g}&end={w0 + 10:g}"
                     for t_ in tids],
        "segments": [f"/api/segments/{t_}?start=0&end=120" for t_ in tids]
        + [f"/api/segments/{hid}?start={a}&end={a + 600}"
           for a in (0, int(hour_s / 2))],
        "notes": [f"/api/notes/{t_}?start={w0:g}&end={w1:g}" for t_ in tids],
        "key": [f"/api/key/{t_}" for t_ in tids],
        "align": [f"/api/align/{t_}?ref=0" for t_ in tids[1:]],
    }
    lat, v_legs = {}, []
    for route, urls in routes.items():
        lat[route] = []
        (_, n) = counted(K, lambda: [lat[route].append(http(base + u)[2])
                                     for u in urls])
        want = counts(fast=len(urls)) if route == "segments" else counts()
        check(n == want, f"/api/{route}: launches {n}, expected {want}")
        v_legs.append((f"viewer {route}", n))
        h0 = stats()["hits"]
        for u in urls:
            code, body, _ = http(base + u)
            got = json.loads(body)
            tid = int(u.split("?")[0].rsplit("/", 1)[1])
            q = dict(kv.split("=") for kv in u.partition("?")[2].split("&")
                     if kv)
            want = direct(route.split()[0], tid, q)
            check(code == 200 and got == json.loads(json.dumps(want)),
                  f"{u}: {str(got)[:300]} != the direct call's "
                  f"{str(want)[:300]}")
        check(stats()["hits"] - h0 == len(urls), f"/api/{route}: the second "
              "requests were not all cache hits")
    legs += v_legs

    # the Viterbi routes from eight threads among image renders, the graph
    # cache emptied first so that the captures happen among them: every
    # answer equals the one-at-a-time answer ("&c=" keeps the passes'
    # answers apart in the cache)
    imgs = [f"/api/{k}/{t_}?px_per_sec=100&height=300&start={w0:g}"
            f"&end={w0 + 12:g}" + ("&amp_min=-1&amp_max=1"
                                   if k == "wav_crop" else "")
            for t_ in tids for k in ("spec_crop", "wav_crop",
                                     "adaptive_crop")]
    ana = routes["pitch smooth=1"] + routes["notes"]
    one = {u: http(base + u)[1] for u in ana}
    one.update({u: http(base + u + "&c=0")[1] for u in imgs})
    jobs = [u for i in range(max(len(imgs), len(ana)))
            for u in imgs[i:i + 1] + ana[i:i + 1]]
    S._GRAPHS.clear()

    def storm():
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            return [(u, ex.submit(http, base + u + "&c=1")) for u in jobs]

    t0 = time.perf_counter()
    got, n = counted(K, storm)
    storm_s = time.perf_counter() - t0
    check(n == counts(), f"concurrent requests: launches {n}")
    for u, f in got:
        code, body, _ = f.result()
        check(code == 200 and body == one[u], f"{u} among concurrent "
              f"requests: HTTP {code} {body[:200]!r} != one at a time")
    check(dev != "cuda" or S._GRAPHS,
          "concurrent requests: no Viterbi graph was replayed")
    legs.append(("viewer concurrent", n))
    print(f"[concurrent] {smi}; {len(jobs)} requests from 8 threads "
          f"({len(imgs)} spec, wav and adaptive crops among "
          f"{len(jobs) - len(imgs)} /api/pitch smooth=1 and /api/notes), "
          f"the Viterbi graph cache emptied first ({len(S._GRAPHS)} graphs "
          f"captured among them), {storm_s:.3f} s; every answer == one at "
          f"a time")
    print(f"[viewer2] {smi}; /api/pitch (30 s windows of the songs and four "
          f"of the hour; smooth=1 of the songs), /api/formants (10 s), "
          f"/api/segments (120 s of the songs, two 600 s windows of the "
          f"hour: one fast launch each), /api/notes (30 s), /api/key (whole "
          f"tracks) and /api/align (each song against song 0), each response "
          f"== the direct library call on the card, every second request a "
          f"cache hit; first-request latency: " + "; ".join(
              f"{r} p50 {np.percentile(v_, 50) * 1e3:.1f} ms p90 "
              f"{np.percentile(v_, 90) * 1e3:.1f} ms"
              for r, v_ in lat.items()))
    del tracks
    torch.cuda.empty_cache()
    return legs


# Phase 11's card-vs-CPU bounds on the 10 s track, the port tests' own
# (tests/test_torch_{hpss,denoise,nmf,specedit,spectral_views}.py).
ROUNDTRIP_ATOL = 2e-5   # hpss, gain boxes, declick, separate at 3
#                         iterations: tests/test_specedit.py:88
DENOISE_ATOL = 2e-4     # tests/test_denoise.py:87
SEPARATE_ATOL = 2e-4    # parts sum to the input: tests/test_nmf.py:71
PATCH_ATOL = 5e-5       # patched cells: tests/test_torch_specedit.py's
#                         measured bound
MT_RTOL, MT_ATOL = 2e-4, 2e-7  # tests/test_multitaper.py:46
CQT_ATOL = 2e-5         # tests/test_cqt.py:53
HPSS_SUM = 5e-5         # h + p against the input, of its peak
CLICKS = (0.13, 0.32, 0.53, 0.83)  # planted clicks, of the song's length


def plant_clicks(wav, sr, times, width=3, amp=0.6):
    out = np.array(wav, np.float32, copy=True)
    for k, ts in enumerate(times):
        i = int(ts * sr)
        out[..., i:i + width] += np.float32(amp if k % 2 == 0 else -amp)
    return out


def report_close(got, want):
    """Fields of two analyze reports: (ok, note).  Counts, the key's name
    and the structure boundaries equal; floats within their rounding step
    plus the ops' port-test tolerances."""
    bad = []
    for k in ("duration_s", "n_beats", "n_onsets", "n_clicks",
              "segments_s", "active_s"):
        if got[k] != want[k]:
            bad.append(f"{k} {got[k]} != {want[k]}")
    gk, wk = got["key"], want["key"]
    if (gk is None) != (wk is None) or (gk and (
            (gk["tonic"], gk["mode"]) != (wk["tonic"], wk["mode"])
            or abs(gk["r"] - wk["r"]) > 1e-2)):
        bad.append(f"key {gk} != {wk}")
    tol = {"loudness_lufs": 0.02, "loudness_range_lu": 0.02,
           "true_peak_dbtp": 0.02, "tempo_bpm": 0.1, "voiced_fraction": 2e-3,
           "f0_median_hz": 0.2}
    for k, t in tol.items():
        a, b = got[k], want[k]
        if (a is None) != (b is None) or (a is not None and abs(a - b) > t):
            bad.append(f"{k} {a} != {b}")
    for k, t in (("centroid_hz", 0.2), ("flatness", 2e-4), ("rms", 2e-5)):
        a, b = got["spectral"][k], want["spectral"][k]
        if abs(a - b) > t + 1e-3 * abs(b):
            bad.append(f"spectral {k} {a} != {b}")
    return not bad, "; ".join(bad) or "fields agree"


def phase_analysis3(K, smi, song, hour, eight, front, work, dev="cuda"):
    """11: HPSS, NMF separation, denoising, de-clicking, spectral editing,
    the analyze report, the multitaper and reassigned views, POST
    /api/process and GET /api/analyze, as users run them."""
    import glob
    import re

    from msv_tpu_torch import AudioTrack, SpecSetting
    from msv_tpu_torch.cli import _build_parser, _feature
    from msv_tpu_torch.config import derive_stft_params
    from msv_tpu_torch.features import analyze
    from msv_tpu_torch.io.audio import (open_audio_file, open_audio_mono_ex,
                                        write_wav)
    from msv_tpu_torch.ops.cqt import cqt
    from msv_tpu_torch.ops.declick import declick
    from msv_tpu_torch.ops.denoise import denoise
    from msv_tpu_torch.ops.hpss import hpss
    from msv_tpu_torch.ops.multitaper import multitaper_spectrogram
    from msv_tpu_torch.ops.nmf import separate
    from msv_tpu_torch.ops.reassign import reassigned_spec_db
    from msv_tpu_torch.ops.resample import resample
    from msv_tpu_torch.ops.specedit import Box, spectral_edit

    paths, p10, _, _ = song
    s48 = paths[-1]
    stem = {q: os.path.splitext(os.path.basename(q))[0]
            for q in (*paths, p10, hour)}
    d = tempfile.mkdtemp(prefix="msv_chip_analysis3_", dir=work)
    legs, wall, lib_s = [], {}, {}
    dv = ["--device", dev]

    def leg(name, args, want=None):
        out = os.path.join(d, re.sub(r"\W+", "_", name))
        (rc, log, wall[name]), n = counted(
            K, lambda: run_cli([*args, "-o", out, *dv]))
        check(rc == 0, f"{name}: exit {rc}; {log}")
        check(n == (want or counts()), f"{name}: launches {n}, expected "
              f"{want or counts()}")
        legs.append((f"cli {name}", n))
        return out, log

    def lib(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        lib_s[name] = time.perf_counter() - t0
        return out

    def wav_of(path):
        return open_audio_file(path)[0]

    def same_as_written(path, y, sr, bits=16):
        write_wav(os.path.join(d, "lib.wav"), np.atleast_2d(y), sr,
                  bits=bits)
        return np.array_equal(wav_of(path), wav_of(os.path.join(d,
                                                                "lib.wav")))

    # ---- 1. the subcommands on the 48 kHz song
    st48, _ = open_audio_file(s48)
    m48 = open_audio_mono_ex(s48)[0]
    p48 = derive_stft_params(48000, SpecSetting())
    stft = (p48.win_length, p48.hop_length, p48.n_fft)
    out, _ = leg("hpss", ["hpss", s48])
    h, pc = lib("hpss", lambda: hpss(m48, *stft, device=dev))
    check(same_as_written(os.path.join(out, f"{stem[s48]}_harmonic.wav"),
                          h, 48000)
          and same_as_written(os.path.join(
              out, f"{stem[s48]}_percussive.wav"), pc, 48000),
          "hpss: WAVs != the library call")
    hp_err = np.abs(h + pc - m48).max() / np.abs(m48).max()
    check(hp_err <= HPSS_SUM, f"hpss: h + p off the input by {hp_err:.3g} "
          "of its peak")
    out, _ = leg("separate --components 4", ["separate", s48,
                                             "--components", "4"])
    parts, _, hact = lib("separate --components 4", lambda: separate(
        m48, *stft, n_components=4, device=dev))
    order = np.argsort(-(parts ** 2).sum(axis=1))
    check(all(same_as_written(os.path.join(
        out, f"{stem[s48]}_part{r}.wav"), parts[k], 48000)
        for r, k in enumerate(order)), "separate: WAVs != the library call")
    sep_err = np.abs(parts.sum(axis=0) - m48).max()
    check(sep_err <= SEPARATE_ATOL, f"separate: parts sum off the input by "
          f"{sep_err:.3g}")
    out, _ = leg("denoise", ["denoise", s48])
    y = lib("denoise", lambda: np.stack([denoise(
        ch, *stft, sr=48000, device=dev) for ch in st48]))
    check(same_as_written(os.path.join(out, f"{stem[s48]}_dn.wav"), y,
                          48000), "denoise: WAV != the library call")
    clicked = os.path.join(d, "clicked.wav")
    clicks_s = [f * SECONDS for f in CLICKS]
    write_wav(clicked, plant_clicks(st48, 48000, clicks_s), 48000)
    stc, _ = open_audio_file(clicked)
    out, log = leg("declick", ["declick", clicked])
    rep = lib("declick", lambda: [declick(ch, 48000, device=dev)
                                  for ch in stc])
    check(same_as_written(os.path.join(out, "clicked_dc.wav"),
                          np.stack([r[0] for r in rep]), 48000),
          "declick: WAV != the library call")
    for ci, (_, spans, _) in enumerate(rep):
        hit = [any(a <= int(ts * 48000) < b for a, b in spans)
               for ts in clicks_s]
        check(all(hit), f"declick ch{ci}: planted clicks {clicks_s} not all "
              f"in the repaired spans {spans[:12]}")
    g0, g1, pt = SECONDS / 12, SECONDS / 6, SECONDS / 4
    spec_box = [{"t0": g0, "t1": g1, "f0": 400, "f1": 1200,
                 "gain_db": -24.0},
                {"t0": pt, "t1": pt + 0.05, "f0": 0, "f1": 24000,
                 "mode": "patch"}]
    bx = [Box(**b) for b in spec_box]
    boxes = ["--box", f"{g0:g}:{g1:g}:400:1200:-24",
             "--patch", f"{pt:g}:{pt + 0.05:g}:0:24000"]
    out, _ = leg("specedit", ["specedit", s48, *boxes])
    y = lib("specedit", lambda: np.stack([spectral_edit(
        ch, 48000, bx, win_length=p48.win_length,
        hop_length=p48.hop_length, n_fft=p48.n_fft, device=dev)
        for ch in st48]))
    check(same_as_written(os.path.join(out, f"{stem[s48]}_edit.wav"), y,
                          48000), "specedit: WAV != the library call")
    n_spans = len(rep[0][1])
    del st48, stc, rep, parts, h, pc, y
    print(f"[process] {smi}; the 240 s 48 kHz stereo song, wall (library "
          f"call's own time on the card): " + "; ".join(
              f"{k} {wall[k]:.3f} s ({lib_s[k]:.3f} s)" for k in
              ("hpss", "separate --components 4", "denoise", "declick",
               "specedit"))
          + f"; every WAV == the library call; hpss h + p off the input by "
          f"{hp_err:.3g} of its peak; separate's 4 parts sum to the input "
          f"within {sep_err:.3g}; declick found all {len(CLICKS)} planted "
          f"clicks ({n_spans} spans in channel 0); no mel launch")
    torch.cuda.empty_cache()

    # ---- 2. hpss and denoise of the hour, peak device memory
    peaks = {}
    for cmd in ("hpss", "denoise"):
        torch.cuda.reset_peak_memory_stats()
        base_b = torch.cuda.memory_allocated()
        _, log = leg(f"{cmd} of the hour", [cmd, hour])
        peaks[cmd] = (torch.cuda.max_memory_allocated() - base_b) / 2**30
        secs = re.findall(r"\(?in ([\d.]+)s\)?|\(([\d.]+)s\)", log)
        lib_s[f"{cmd} of the hour"] = float([a or b for a, b in secs][-1])
        torch.cuda.empty_cache()
    print(f"[process-hour] {smi}; the 60-minute 48 kHz file: " + "; ".join(
        f"{c} {wall[f'{c} of the hour']:.3f} s wall ({lib_s[f'{c} of the hour']:.2f} "
        f"s in the op, as the CLI prints it), peak device memory "
        f"{peaks[c]:.2f} GiB over the session's" for c in peaks))

    # ---- 3. analyze of the seven songs; the 48 kHz song's report equals
    # a direct call
    out, _ = leg("analyze", ["analyze", *paths], counts(fast=len(paths)))
    reps = {q: json.load(open(os.path.join(out, f"analysis_{stem[q]}.json")))
            for q in paths}
    direct = lib("analyze", lambda: analyze(m48, 48000, device=dev))
    got = {k: v for k, v in reps[s48].items() if k in direct}
    check(got == json.loads(json.dumps(direct)),
          f"analyze: {got} != the library call {direct}")

    # ---- 4. features --kind mtspec and reassigned of the seven songs
    ns = _build_parser().parse_args(["features", p10])
    x4 = resample(open_audio_mono_ex(paths[4])[0], 44100, 16000, device=dev)
    for kind in ("mtspec", "reassigned"):
        out, _ = leg(f"features --kind {kind}",
                     ["features", *paths, "--kind", kind])
        got = np.load(os.path.join(out, f"feats_{kind}_{stem[paths[4]]}.npy"))
        check(np.array_equal(got, _feature(kind, x4, 16000, ns)[0].astype(
            np.float32)), f"features --kind {kind} != the library call")
    r1 = lib("reassigned", lambda: reassigned_spec_db(x4, 16000))
    check(np.array_equal(r1, reassigned_spec_db(x4, 16000)),
          "reassigned: two card runs differ")

    # ---- 4b. cqt of the 48 kHz song: C1's support makes 32 768-sample
    # frames, a frame matrix of 2.9 GB were it whole; it is taken in blocks
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_b = torch.cuda.memory_allocated()
    cq, n = counted(K, lambda: lib("cqt", lambda: cqt(m48, 48000,
                                                      device=dev)))
    cqt_peak = (torch.cuda.max_memory_allocated() - base_b) / 2**30
    legs.append(("library cqt", n))
    n_cf = 1 + len(m48) // 512
    whole = n_cf * 32768 * 4 / 2**30
    check(n == counts(), f"cqt: launches {n}, expected none")
    check(tuple(cq.shape) == (n_cf, 84) and bool(torch.isfinite(cq).all()),
          f"cqt: shape {tuple(cq.shape)}, expected ({n_cf}, 84), finite")
    check(cqt_peak < whole / 4, f"cqt: peak {cqt_peak:.2f} GiB, the whole "
          f"frame matrix is {whole:.2f} GiB")
    del cq

    # ---- 5. the 10 s track, card vs CPU
    w10, sr10 = open_audio_mono_ex(p10)[:2]
    p = derive_stft_params(sr10, SpecSetting())
    st10 = (p.win_length, p.hop_length, p.n_fft)
    notes, bad = [], []

    def both(fn):
        return fn(dev), fn("cpu")

    def close(name, a, b, atol):
        e = float(np.abs(np.asarray(a) - np.asarray(b)).max())
        notes.append(f"{name} {e:.3g} (bound {atol:g})")
        if not e <= atol:
            bad.append(f"{name}: {e:.3g} > {atol:g}")

    (hc, pcc), (hh, ph) = both(lambda v: hpss(w10, *st10, device=v))
    close("hpss", np.stack([hc, pcc]), np.stack([hh, ph]), ROUNDTRIP_ATOL)
    close("separate 3 iterations", *both(lambda v: separate(
        w10, *st10, n_components=4, n_iter=3, device=v)[0]), ROUNDTRIP_ATOL)
    close("denoise", *both(lambda v: denoise(w10, *st10, sr=sr10,
                                             device=v)), DENOISE_ATOL)
    bx10 = [Box(2, 4, 400, 1200, gain_db=-24.0),
            Box(6.0, 6.05, 0, sr10 / 2, mode="patch")]
    e_card, e_cpu = both(lambda v: spectral_edit(
        w10, sr10, bx10, win_length=p.win_length, hop_length=p.hop_length,
        n_fft=p.n_fft, device=v))
    span = slice(int(5.9 * sr10), int(6.15 * sr10))
    close("specedit patch span", e_card[span], e_cpu[span], PATCH_ATOL)
    e_card[span] = e_cpu[span] = 0.0
    close("specedit elsewhere", e_card, e_cpu, ROUNDTRIP_ATOL)
    c10 = plant_clicks(w10, sr10, times=(2.3, 5.1, 8.7))
    (dc, sc, kc), (dh, sh, kh) = both(lambda v: declick(c10, sr10,
                                                        device=v))
    if sc != sh or kc != kh:
        bad.append(f"declick spans: card {sc} {kc}, CPU {sh} {kh}")
    close("declick", dc, dh, ROUNDTRIP_ATOL)
    close("cqt", *both(lambda v: cqt(w10, sr10, device=v).cpu().numpy()),
          CQT_ATOL)
    x10 = {v: resample(w10, sr10, 16000, device=v) for v in (dev, "cpu")}
    mt = [multitaper_spectrogram(x10[v], 16000, device=v).cpu().numpy()
          for v in (dev, "cpu")]
    e = np.abs(mt[0] - mt[1]) - MT_RTOL * np.abs(mt[1])
    notes.append(f"mtspec excess over rtol {e.max():.3g} (atol {MT_ATOL:g})")
    if not e.max() <= MT_ATOL:
        bad.append(f"mtspec: {e.max():.3g} over rtol {MT_RTOL}")
    ra = [reassigned_spec_db(x10[v], 16000, top_db=None, device=v)
          for v in (dev, "cpu")]
    tot = [float((10.0 ** (r.astype(np.float64) / 10.0)).sum()) for r in ra]
    rel_tot = abs(tot[0] / tot[1] - 1)
    notes.append(f"reassigned total power rel {rel_tot:.3g} (bound 1e-5)")
    if not rel_tot <= 1e-5:
        bad.append(f"reassigned totals: {rel_tot:.3g}")
    an = [analyze(w10, sr10, device=v) for v in (dev, "cpu")]
    ok, note = report_close(*an)
    notes.append(f"analyze: {note}")
    if not ok:
        bad.append(f"analyze: {note}")
    check(not bad, "the 10 s track, card vs CPU: " + "; ".join(bad))
    print(f"[analysis3] {smi}; analyze of the seven songs "
          f"{wall['analyze']:.3f} s ({len(paths)} fast launches, the 48 kHz "
          f"song's report == the library call, {lib_s['analyze']:.3f} s); "
          f"features --kind mtspec {wall['features --kind mtspec']:.3f} s, "
          f"reassigned {wall['features --kind reassigned']:.3f} s (each .npy "
          f"== the library call; reassigned {lib_s['reassigned']:.3f} s, two "
          f"card runs bit-equal); cqt of the 48 kHz song "
          f"{lib_s['cqt']:.3f} s on the card, peak device memory "
          f"{cqt_peak:.3f} GiB over the session's (the whole frame matrix "
          f"{whole:.2f} GiB); the 10 s track card vs CPU max|err|: "
          + "; ".join(notes))
    torch.cuda.empty_cache()

    # ---- 6. POST /api/process for each op on the 48 kHz song (phase 8's
    # server), the derived tracks' audio == the library call's, a crop of
    # each rendered; then GET /api/analyze of a song and of the hour
    base, tids = front["viewer"], front["viewer_ids"]
    sid, hid = tids[len(paths) - 1], tids[-1]
    track = AudioTrack(s48, SpecSetting())
    wav = track.wav_slice(0, track.n_samples)
    ops = {
        "denoise": lambda: [denoise(wav, *stft, sr=48000, device=dev)],
        "declick": lambda: [declick(wav, 48000, device=dev)[0]],
        "harmonic": lambda: [hpss(wav, *stft, device=dev)[0]],
        "percussive": lambda: [hpss(wav, *stft, device=dev)[1]],
        "separate": lambda: (lambda pa: list(pa[np.argsort(-(pa ** 2).sum(
            axis=1))]))(separate(wav, *stft, n_components=2,
                                 device=dev)[0]),
        "specedit": lambda: [spectral_edit(
            wav, 48000, bx,
            win_length=p48.win_length, hop_length=p48.hop_length,
            n_fft=p48.n_fft, device=dev)],
    }
    proc_lat = {}
    for op, fn in ops.items():
        body_ = {"id": sid, "op": op}
        if op == "specedit":
            body_["boxes"] = spec_box
        t0 = time.perf_counter()
        (code, body, _), n = counted(K, lambda: http(
            base + "/api/process", body_))
        proc_lat[op] = time.perf_counter() - t0
        check(code == 200, f"POST /api/process {op}: HTTP {code} "
              f"{body[:300]!r}")
        resp = json.loads(body)
        check(n == counts(1), f"POST /api/process {op}: launches {n}, "
              "expected one parity launch (the derived tracks' add)")
        legs.append((f"viewer process {op}", n))
        names = {t["id"]: t["filename"] for t in json.loads(http(
            base + "/api/tracks")[1])["tracks"]}
        want = fn()
        check(len(resp["ids"]) == len(want), f"{op}: ids {resp['ids']}")
        for new_id, y in zip(resp["ids"], want):
            f = glob.glob(os.path.join(tempfile.gettempdir(), "msv_proc_*",
                                       names[new_id]))
            check(len(f) == 1 and np.array_equal(wav_of(f[0])[0], y),
                  f"{op}: derived track {new_id}'s audio != the library "
                  "call's")
            code, img, _ = http(base + f"/api/spec_crop/{new_id}?"
                                f"px_per_sec=100&height=300&start={g0:g}"
                                f"&end={g0 + 12:g}")
            check(code == 200 and png_pixels(img).shape[0] == 300,
                  f"{op}: crop of the derived track: HTTP {code}")
        for new_id in resp["ids"]:
            check(http(base + "/api/remove", {"id": new_id})[0] == 200,
                  f"remove {new_id}")
    code, body, _ = http(base + "/api/process", {"id": sid, "op": "bogus"})
    check(code == 400 and body.startswith(b"error:"),
          f"POST /api/process bogus: HTTP {code}")
    code, body, _ = http(base + "/api/process", {"id": 999, "op": "denoise"})
    check(code == 404, f"POST /api/process of an unknown track: HTTP {code}")

    def poll(url, deadline_s=600):
        t0 = time.perf_counter()
        code, body, _ = http(base + url)
        while code == 202:
            check(time.perf_counter() - t0 < deadline_s, f"{url} pending")
            time.sleep(0.05)
            code, body, _ = http(base + url)
        check(code == 200, f"{url}: HTTP {code} {body[:300]!r}")
        return json.loads(body), time.perf_counter() - t0

    (rep_song, song_s), n = counted(K, lambda: poll(f"/api/analyze/{sid}"))
    check(n == counts(fast=1), f"/api/analyze/{sid}: launches {n}")
    legs.append(("viewer analyze song", n))
    want = dict(direct, window_s=round(track.n_samples / 48000, 3))
    check(rep_song == json.loads(json.dumps(want)),
          f"/api/analyze/{sid}: {rep_song} != the direct call {want}")

    # the hour's analyze (its first 600 s) with 20 crop misses during it
    hour_len = AudioTrack(hour, SpecSetting()).n_samples / 48000
    crops = [f"/api/spec_crop/{hid}?px_per_sec=100&height=500"
             f"&start={a:g}&end={a + 12:g}&c=11" for a in
             np.round(hour_len * (0.2 + np.arange(20) * 0.035))]
    url = f"/api/analyze/{hid}"

    def hour_job():
        t0 = time.perf_counter()
        code, _, _ = http(base + url)
        check(code == 202, f"{url}: first request HTTP {code}")
        lat = [http(base + u) for u in crops]
        still = http(base + url)[0]
        rep, _ = poll(url)
        return rep, lat, still, time.perf_counter() - t0

    (rep_hour, lat, still, hour_s), n = counted(K, hour_job)
    check(n == counts(fast=1), f"{url}: launches {n}")
    legs.append(("viewer analyze hour", n))
    check(still == 202, "the hour's analyze job ended before the 20 crops "
          "did")
    ht = AudioTrack(hour, SpecSetting())
    nh = min(ht.n_samples, 600 * ht.sr)
    want = dict(analyze(ht.wav_slice(0, nh), ht.sr, device=dev),
                window_s=round(nh / ht.sr, 3))
    check(rep_hour == json.loads(json.dumps(want)),
          f"{url}: {rep_hour} != the direct call {want}")
    for u, (code, body, _) in zip(crops, lat):
        alone = http(base + u.replace("&c=11", "&c=12"))[1]
        check(code == 200 and body == alone, f"{u} during analyze: HTTP "
              f"{code}, image != one at a time")
    ms = [t * 1e3 for _, _, t in lat]
    print(f"[viewer3] {smi}; POST /api/process on the 48 kHz song (one "
          f"parity launch each, the derived track's add), request wall: "
          + "; ".join(f"{k} {v:.3f} s" for k, v in proc_lat.items())
          + "; each derived track's audio == the library call's, a crop of "
          f"each rendered, bad op 400, unknown track 404; GET /api/analyze "
          f"of the song 202 -> 200 in {song_s:.3f} s, of the hour's first "
          f"600 s in {hour_s:.3f} s (one fast launch each, reports == the "
          f"direct call); 20 crop misses of the hour during that job: p50 "
          f"{np.percentile(ms, 50):.1f} ms p90 {np.percentile(ms, 90):.1f} "
          f"ms, every image == one at a time")
    torch.cuda.empty_cache()
    return legs


CLIP_SECONDS = 30.0
CLIPS_PER_RATE = 16
WHISPER_ATOL = 3e-4  # tests/test_features.py:279, in log10/4 units


def write_clip_corpus(rng, d):
    """The loader's corpus: CLIPS_PER_RATE 30 s mono PCM16 WAVs at each of
    the six rates, two 20 s clips at 16 kHz (padded) and two 40 s at 48 kHz
    (truncated): a tone over noise, each clip its own."""
    from msv_tpu_torch.io.audio import write_wav

    plan = [(sr, CLIP_SECONDS) for sr in RATES
            for _ in range(CLIPS_PER_RATE)]
    plan += [(16000, 20.0)] * 2 + [(48000, 40.0)] * 2
    paths = []
    for i, (sr, sec) in enumerate(plan):
        n = int(sec * sr)
        t = np.arange(n, dtype=np.float32) / np.float32(sr)
        x = np.float32(0.3) * np.sin(np.float32(2 * np.pi * rng.uniform(
            100, 2000)) * t)
        x += np.float32(0.05) * rng.standard_normal(n, dtype=np.float32)
        paths.append(os.path.join(d, f"clip{i:03d}_{sr}.wav"))
        write_wav(paths[-1], x[None], sr, bits=16)
    return paths


def phase_slice11(K, smi, song, hour, work, dev="cuda"):
    """12: the batch loader, the engine switch and the mesh."""
    import torch.distributed as dist

    from msv_tpu_torch import (MultiTrack, log_mel_spectrogram,
                               whisper_log_mel)
    from msv_tpu_torch.config import (SpecSetting, derive_stft_params,
                                      set_engine)
    from msv_tpu_torch.data import AudioBatcher, extract_features
    from msv_tpu_torch.io.audio import open_audio_mono_ex, open_wav_mmap
    from msv_tpu_torch.kernels.pipeline import spec_pipeline_batched
    from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center
    from msv_tpu_torch.ops.resample import resample
    from msv_tpu_torch.parallel import (make_mesh, sharded_envelope_minmax,
                                        sharded_spec_pipeline,
                                        sharded_streaming_spec_db,
                                        streaming_spec_db)
    from msv_tpu_torch.parallel.multihost import (initialize_distributed,
                                                  make_global_mesh)
    from msv_tpu_torch.parallel.sharded import freq_sharded_spec, shard_array
    from msv_tpu_torch.render.envelope import (_chunked_window_minmax,
                                               column_windows)

    legs = []
    t_phase = time.perf_counter()
    card = torch.device(dev, 0)
    dv = ["--device", dev]
    d = tempfile.mkdtemp(prefix="msv_chip_slice11_", dir=work)

    # ---- 1. the loader at Whisper's width
    rng = np.random.default_rng(SEED + 12)
    t0 = time.perf_counter()
    corpus = write_clip_corpus(rng, d)
    print(f"[loader] wrote {len(corpus)} mono PCM16 WAVs in "
          f"{time.perf_counter() - t0:.2f} s")
    decode_s, lock = [0.0], threading.Lock()
    real_decode = AudioBatcher._decode

    def timed_decode(self, path):
        t0 = time.perf_counter()
        try:
            return real_decode(self, path)
        finally:
            with lock:
                decode_s[0] += time.perf_counter() - t0

    def run(fn, name):
        """One counted extract_features run over the corpus: rows, metas,
        batch sizes, wall, the pool's decode seconds and the feature
        calls' CUDA-event milliseconds."""
        sizes, events = [], []

        def feats(b):
            sizes.append(b.shape[0])
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            out = fn(b)
            e1.record()
            events.append((e0, e1))
            return out

        decode_s[0] = 0.0
        AudioBatcher._decode = timed_decode
        try:
            torch.cuda.synchronize()
            reset_counts(K)
            t0 = time.perf_counter()
            rows, metas = extract_features(
                corpus, feats, target_sr=16000, clip_seconds=CLIP_SECONDS,
                batch_size=16, workers=4, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = read_counts(K)
        finally:
            AudioBatcher._decode = real_decode
        feat_ms = sum(a.elapsed_time(b) for a, b in events)
        legs.append((f"loader {name}", n))
        print(f"[loader] {smi}; extract_features({name}) of {len(rows)} "
              f"clips in {len(sizes)} batches {sizes}: wall {wall:.3f} s "
              f"({len(rows) / wall:.1f} clips/s), the pool's decode "
              f"{decode_s[0]:.3f} s summed over 4 threads, the feature "
              f"calls {feat_ms:.1f} ms (CUDA events)")
        return rows, metas, sizes, n

    rows, metas, sizes, n = run(whisper_log_mel, "whisper_log_mel")
    check(n == counts(), f"whisper_log_mel batches launched {n}: its power "
          "mel runs as torch ops")
    check(len(rows) == len(corpus) and sorted(m.path for m in metas)
          == sorted(corpus), "extract_features: every clip once")
    check(all(r.shape == (80, 3000) for r in rows), "whisper rows' shape")
    n_clip = {sr: int(round(CLIP_SECONDS * sr)) for sr in RATES}

    def direct(group, device):
        """decode -> pad/truncate -> resample of one group on ``device``,
        and its ClipMetas' fields."""
        wavs, fields = [], []
        for path in group:
            x, sr, _, _, n_ch = open_audio_mono_ex(path)
            want = n_clip[sr]
            fields.append((path, sr, len(x), n_ch, len(x) > want))
            wavs.append(x[:want] if len(x) > want
                        else np.pad(x, (0, want - len(x))))
        x = torch.from_numpy(np.stack(wavs).astype(np.float32)).to(device)
        return (x if fields[0][1] == 16000
                else resample(x, fields[0][1], 16000)), fields

    starts = np.cumsum([0, *sizes])
    for a, b in zip(starts[:-1], starts[1:]):
        x, fields = direct([m.path for m in metas[a:b]], card)
        want = whisper_log_mel(x).cpu().numpy()
        check(all(tuple(vars(m).values()) == f
                  for m, f in zip(metas[a:b], fields)),
              f"batch rows {a}-{b}: ClipMetas != the direct decode's")
        check(np.array_equal(np.stack(rows[a:b]), want),
              f"batch rows {a}-{b}: whisper rows != the direct decode -> "
              "resample -> whisper_log_mel of the group")
    fast_rows, fast_metas, fast_sizes, n = run(
        lambda b: log_mel_spectrogram(b, 16000, n_mel=80), "log_mel fast")
    check(n == counts(fast=len(fast_sizes)),
          f"log_mel batches: launches {n}, expected one fast launch a "
          f"batch ({len(fast_sizes)})")
    check([m.path for m in fast_metas] == [m.path for m in metas],
          "the two loader runs' order")
    # three full clips, card against CPU
    notes = []
    for i in (0, 3 * CLIPS_PER_RATE, len(RATES) * CLIPS_PER_RATE - 1):
        path = metas[i].path
        xs = [direct([path], v)[0] for v in (dev, "cpu")]
        w = [whisper_log_mel(x).cpu() for x in xs]
        e_w = float((w[0] - w[1]).abs().max())
        lm = [log_mel_spectrogram(x, 16000, n_mel=80).cpu() for x in xs]
        err = (lm[0] - lm[1]).abs()
        e_max, e_p99 = err.max().item(), quantile(err, 0.99)
        check(e_w <= WHISPER_ATOL and e_max < GREY_STEP and e_p99 < 0.01,
              f"{path}: card vs CPU whisper {e_w:.3g}, fast log-mel max "
              f"{e_max:.3g} p99 {e_p99:.3g} dB")
        notes.append(f"{metas[i].sr} Hz whisper {e_w:.2g}, log-mel max "
                     f"{e_max:.3g} p99 {e_p99:.2g} dB")
    print(f"[loader] rows and ClipMetas == the direct decode -> resample -> "
          f"whisper_log_mel of each batch's group; log-mel: one fast launch "
          f"a batch; card vs CPU (whisper bound {WHISPER_ATOL:g}, fast "
          f"bound {GREY_STEP} dB max, 0.01 dB p99): " + "; ".join(notes))
    del rows, fast_rows
    torch.cuda.empty_cache()

    # ---- 2. the engine: the seven songs under "xla" against "auto"
    paths, _, _, _ = song
    ids = list(range(len(paths)))

    def session():
        mt = MultiTrack(device=dev)
        mt.add_tracks(ids, paths)
        return mt

    auto, n = counted(K, session)
    check(n == counts(6), f"'auto' session: launches {n}")
    legs.append(("engine auto session", n))
    set_engine("xla")
    try:
        xla, n = counted(K, session)
        check(n == counts(), f"'xla' session: launches {n}, expected none")
        legs.append(("engine xla session", n))
        errs = [check_f32(torch.from_numpy(xla.get_spec_db(i)),
                          torch.from_numpy(auto.get_spec_db(i)),
                          f"'xla' track {i} against 'auto'")[0] for i in ids]
        imgs = [xla.get_spec_image(i, 100.0, 500) for i in ids]
    finally:
        set_engine("auto")
    out = os.path.join(d, "render_xla")
    (rc, log, render_s), n = counted(K, lambda: run_cli(
        ["render", *paths, "--engine", "xla", "--no-wav", "-o", out, *dv]))
    check(rc == 0, f"render --engine xla: exit {rc}; {log}")
    check(n == counts(), f"render --engine xla: launches {n}")
    legs.append(("cli render --engine xla", n))
    for i, p in enumerate(paths):
        stem = os.path.splitext(os.path.basename(p))[0]
        check(np.array_equal(png_pixels(os.path.join(out, f"spec_{stem}.png")),
                             imgs[i]),
              f"render --engine xla: track {i} != the 'xla' session's image")
    stage = {name: mt.timer.summary()["add_tracks.kernel_minmax"]
             for name, mt in (("auto", auto), ("xla", xla))}
    print(f"[engine] {smi}; seven-song add, add_tracks.kernel_minmax "
          f"(launch or plain version, masked min/max, one sync; host clock): "
          + "; ".join(f"{k} {v['total_s']:.4f} s over {v['calls']} groups"
                      for k, v in stage.items())
          + f"; 'xla' planes against 'auto' max|err| {max(errs):.3g} dB "
          f"(f32_agree), no launch; render --engine xla {render_s:.3f} s, "
          f"PNGs == the 'xla' session's images")
    del auto, xla
    torch.cuda.empty_cache()

    # ---- 3. the mesh on one card: meshes of cuda:0
    card8 = [card] * 8
    rng = np.random.default_rng(SEED + 13)
    p48 = derive_stft_params(48000, SpecSetting())
    win, hop = p48.win_length, p48.hop_length
    _, _, (c, s, fb) = operands(48000, dev)
    c_np, s_np, fb_np = (t.cpu().numpy() for t in (c, s, fb))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    n_sec = int(SECONDS * 48000)
    t = np.arange(n_sec, dtype=np.float32) / np.float32(48000)
    wavs = np.stack([np.float32(0.3) * np.sin(np.float32(
        2 * np.pi * rng.uniform(100, 3000)) * t) + np.float32(0.05)
        * rng.standard_normal(n_sec, dtype=np.float32) for _ in range(8)])
    del t
    n_frames = n_frames_for(n_sec, win, hop)
    padded = np.stack([reflect_pad_center(w, win) for w in wavs])
    need = (n_frames + 4) * hop + win
    padded = np.pad(padded, ((0, 0), (0, need - padded.shape[1])))
    (ref, rmin, rmax), plain_s = timed(lambda: spec_pipeline_batched(
        torch.from_numpy(padded).to(dev), c, s, fb,
        torch.full((8,), n_frames, device=dev), win=win, hop=hop,
        n_frames=n_frames, use_mel=True, mode="parity"))
    rmin, rmax = float(rmin.min()), float(rmax.max())
    walls = [f"8 x {SECONDS:.0f} s at 48 kHz unsharded (spec_pipeline_"
             f"batched) {plain_s:.3f} s"]
    for shape in ((1, 1), (2, 4)):
        (db, lo, hi, n_total), n = counted(K, lambda: timed(
            lambda: sharded_spec_pipeline(make_mesh(*shape, card8), padded,
                                          win, hop, c_np, s_np, fb_np,
                                          n_frames))[0])
        _, wall = timed(lambda: sharded_spec_pipeline(
            make_mesh(*shape, card8), padded, win, hop, c_np, s_np, fb_np,
            n_frames))
        check(n == counts(), f"sharded_spec_pipeline {shape}: launches {n}")
        legs.append((f"mesh sharded_spec_pipeline {shape}", n))
        check(len(db.shards) == shape[0] * shape[1] and n_total >= n_frames,
              f"sharded_spec_pipeline {shape}: {len(db.shards)} shards")
        check_f32(db.gather()[:, :n_frames], ref,
                  f"sharded_spec_pipeline {shape} against the plain pipeline")
        check(abs(float(lo) - rmin) <= 1e-3 and abs(float(hi) - rmax) <= 1e-3,
              f"sharded_spec_pipeline {shape}: range [{float(lo)}, "
              f"{float(hi)}] against [{rmin}, {rmax}]")
        walls.append(f"{shape} {wall:.3f} s")
        del db
    del ref, padded
    torch.cuda.empty_cache()
    print(f"[mesh] {smi}; one card, every shard on cuda:0 (overhead, not "
          f"scaling): sharded_spec_pipeline walls (second run, host clock "
          f"to a sync): " + "; ".join(walls) + "; planes by f32_agree, "
          "range within 1e-3 dB, no launch")

    # the streamed hour
    hour_i16 = np.asarray(open_wav_mmap(hour)[0])
    ops48 = (c, s, fb)
    (one, n_hour, lo1, hi1), one_s = timed(lambda: streaming_spec_db(
        hour_i16, win, hop, *ops48))
    walls = [f"streaming_spec_db (the parity kernel) {one_s:.3f} s"]
    for shape in ((1, 1), (1, 4)):
        ((db, n_m, lo, hi), wall), n = counted(K, lambda: timed(
            lambda: sharded_streaming_spec_db(make_mesh(*shape, card8),
                                              hour_i16, win, hop, c_np, s_np,
                                              fb_np)))
        check(n == counts(), f"sharded_streaming_spec_db {shape}: launches "
              f"{n}")
        legs.append((f"mesh sharded_streaming_spec_db {shape}", n))
        check(n_m == n_hour, f"sharded_streaming_spec_db {shape}: "
              f"{n_m} frames, streaming {n_hour}")
        check_f32(db.gather()[:n_hour], one[:n_hour],
                  f"sharded_streaming_spec_db {shape} against streaming")
        check(abs(hi - hi1) <= ATOL, f"sharded streaming {shape}: max "
              f"{hi} against {hi1}")
        walls.append(f"{shape} {wall:.3f} s")
        del db
    del one
    torch.cuda.empty_cache()

    # the frequency-sharded song, mel and linear
    song48 = open_audio_mono_ex(paths[-1])[0].astype(np.float32)
    n48 = n_frames_for(len(song48), win, hop)
    p_song = torch.from_numpy(reflect_pad_center(song48, win)).to(dev)[None]
    for use_mel in (True, False):
        m = fb if use_mel else None
        (want, _, _), plain_s = timed(lambda: spec_pipeline_batched(
            p_song, c, s, m, torch.full((1,), n48, device=dev), win=win,
            hop=hop, n_frames=n48, use_mel=use_mel, mode="parity"))
        for shape in ((1, 1), (1, 4)):
            ((db, n_f), wall), n = counted(K, lambda: timed(
                lambda: freq_sharded_spec(make_mesh(*shape, card8), song48,
                                          win, hop, c_np, s_np,
                                          fb_np if use_mel else None)))
            name = f"freq_sharded_spec {'mel' if use_mel else 'linear'} "
            check(n == counts(), f"{name}{shape}: launches {n}")
            legs.append((f"mesh {name}{shape}", n))
            check(n_f == n48, f"{name}{shape}: {n_f} frames")
            check_f32(db, want[0], f"{name}{shape} against the plain "
                      "pipeline")
            walls.append(f"{name}{shape} {wall:.3f} s (unsharded "
                         f"{plain_s:.3f} s)")
    del p_song
    # the hour's envelope
    hour_f32 = hour_i16.astype(np.float32) * np.float32(2.0**-15)
    dev_hour = torch.from_numpy(hour_f32).to(dev)
    n_h = len(hour_f32)
    for n_cols in (1200, 4096):
        st, en = column_windows(np.arange(n_cols, dtype=np.float32), n_cols,
                                n_h, n_h)
        (want, one_s) = timed(lambda: _chunked_window_minmax(
            dev_hour, torch.from_numpy(st).to(dev),
            torch.from_numpy(en).to(dev), int((en - st).max())))
        want = [w.cpu().numpy() for w in want]
        for shape in ((1, 1), (2, 4)):
            ((mx, mn), wall), n = counted(K, lambda: timed(
                lambda: sharded_envelope_minmax(make_mesh(*shape, card8),
                                                hour_f32, n_cols)))
            check(n == counts(), f"sharded envelope {shape}: launches {n}")
            legs.append((f"mesh sharded_envelope_minmax {shape} {n_cols}",
                         n))
            check(np.array_equal(mx, want[0]) and np.array_equal(mn, want[1]),
                  f"sharded envelope {shape} at {n_cols} columns != the "
                  "single-device envelope")
            walls.append(f"envelope {n_cols} cols {shape} {wall:.3f} s "
                         f"(single device {one_s:.3f} s)")
    del dev_hour, hour_f32
    torch.cuda.empty_cache()

    # the log-mel frontend on a dp-split batch
    # 8 x 30 s at 16 kHz, on the card before either call is timed
    x = torch.from_numpy(np.stack([wavs[i, : 30 * 48000][::3]
                                   for i in range(8)])).to(dev)
    log_mel_spectrogram(x, 16000)  # the frontend's operands, made once
    whole, whole_s = timed(lambda: log_mel_spectrogram(x, 16000))
    for shape in ((1, 1), (2, 4)):
        mesh = make_mesh(*shape, card8)
        batch = shard_array(x, mesh, ("dp", None))
        (got, wall), n = counted(K, lambda: timed(
            lambda: log_mel_spectrogram(batch, 16000)))
        check(n == counts(fast=shape[0]), f"log_mel dp-split {shape}: "
              f"launches {n}, expected one fast launch a shard")
        legs.append((f"mesh log_mel_spectrogram {shape}", n))
        check(torch.equal(got.gather(), whole),
              f"log_mel dp-split {shape} != the unsplit call")
        walls.append(f"log_mel 8 x 30 s dp-split {shape} {wall:.4f} s "
                     f"(unsplit {whole_s:.4f} s)")
    print(f"[mesh] {smi}; " + "; ".join(walls) + "; the hour's planes by "
          "f32_agree against streaming's, the envelopes bit-equal to the "
          "single-device envelope, the split log-mel batch == the unsplit "
          "call")

    # ---- 4. torch.distributed on one card: a group of one on NCCL
    small = np.stack([reflect_pad_center(w[:30 * 48000], win)
                      for w in wavs[:2]])
    n_small = n_frames_for(30 * 48000, win, hop)
    small = np.pad(small, ((0, 0), (0, 4 * hop)))
    solo = sharded_spec_pipeline(make_mesh(1, 1, [card]), small, win, hop,
                                 c_np, s_np, fb_np, n_small)
    initialize_distributed(f"localhost:{free_port()}")
    try:
        backend = dist.get_backend()
        check(dist.get_world_size() == 1
              and backend == ("nccl" if dev == "cuda" else "gloo"),
              f"process group: {backend}, {dist.get_world_size()}")
        mesh = make_global_mesh(1, 1, [card])
        (db, lo, hi, n_total), n = counted(K, lambda: sharded_spec_pipeline(
            mesh, small, win, hop, c_np, s_np, fb_np, n_small))
        check(n == counts(), f"distributed step: launches {n}")
        legs.append(("distributed sharded_spec_pipeline", n))
        check(torch.equal(db.gather(), solo[0].gather())
              and float(lo) == float(solo[1])
              and float(hi) == float(solo[2]) and n_total == solo[3],
              "the step in a process group != the step without one")
    finally:
        dist.destroy_process_group()
    print(f"[distributed] {smi}; initialize_distributed at world size 1 on "
          f"{backend} (localhost), make_global_mesh(1, 1) over "
          f"{[str(d_) for d_ in mesh.devices.flat]}, one "
          f"sharded_spec_pipeline step (2 x 30 s at 48 kHz, all_reduce of "
          f"the range) == the step without a process group")
    torch.cuda.empty_cache()
    print(f"[slice11] phase 12 in {time.perf_counter() - t_phase:.1f} s")
    return legs


WIRE_BITS = (16, 12, 10, 8)


def grid_bound(lo, hi, bits):
    """The packed dB wire's max error against the f32 plane: half a step of
    the b-bit grid on [lo, hi], plus eight f32 ulps of the window's largest
    magnitude (the rounding of (db - lo) * scale, of q / scale and of the
    + lo; tests/test_torch_wirepack.py)."""
    lo, hi = np.float32(lo), np.float32(hi)
    m = max(abs(lo), abs(hi), hi - lo)
    return (0.5 * float(hi - lo) / ((1 << bits) - 1)
            + 8 * float(np.spacing(np.float32(m))))


def check_export(mt, i, bits, cpu_words, what):
    """One packed dB export of track i against the f32 plane: within the
    grid bound; with ``cpu_words``, the card's words bit-equal to
    pack_spec of the same plane on the CPU and the export bit-equal to
    unpack_spec_np of them.  Returns (max |err|, bound, fetched bytes)."""
    from msv_tpu_torch.parallel import wirepack as W

    st, plane = mt._ensure_resident(i)
    lo, hi = float(st.smin), float(st.smax)
    got = mt.get_spec_db(i, wire=f"q{bits}")
    f32 = mt.get_spec_db(i, wire="f32")
    err = float(np.abs(got - f32).max())
    bound = grid_bound(lo, hi, bits)
    check(got.shape == f32.shape and err <= bound,
          f"{what} q{bits}: max |q - f32| {err} > {bound}")
    words, widths, nused = W.pack_spec(plane, lo, hi, bits=bits)
    if cpu_words:
        cw, cwd, cnu = W.pack_spec(plane.cpu(), lo, hi, bits=bits)
        check(cnu == nused and np.array_equal(cwd, widths)
              and torch.equal(words.cpu(), cw),
              f"{what} q{bits}: the card's words != the CPU's")
        want = W.unpack_spec_np(W.fetch_packed_prefix(cw, cnu), cwd,
                                st.n_frames, st.n_out, st.n_frames_pad, lo,
                                hi, bits)
        check(np.array_equal(got, want),
              f"{what} q{bits}: export != unpack_spec_np of the words")
    del words
    return err, bound, nused * 4 + widths.nbytes


def phase_wire(K, smi, song, hour, work, dev="cuda"):
    """13: the wire codec: packed uploads and the packed dB export."""
    from msv_tpu_torch import MultiTrack, precision_mode_scope
    from msv_tpu_torch.io import _native_audio as NA
    from msv_tpu_torch.io.audio import open_wav_mmap
    from msv_tpu_torch.parallel import streaming as S
    from msv_tpu_torch.parallel import wirepack as W
    from msv_tpu_torch.parallel.streaming import padded_slice

    paths = song[0]
    legs = []
    t_phase = time.perf_counter()
    card = torch.device(dev)
    d = tempfile.mkdtemp(prefix="msv_chip_wire_", dir=work)

    # ---- the codec library (built by its first use in this run)
    packs0 = dict(W.PACKS)
    check(W._native_lib() is not None,
          f"the codec library did not build: {NA.BUILD_ERROR}")
    built = (f"built in this run in {NA.BUILD_SECONDS:.2f} s by "
             f"`{NA.BUILD_COMMAND}`" if NA.BUILD_SECONDS is not None
             else "found built")
    print(f"[wire] {smi}; codec library {os.path.relpath(NA.LIBRARY)} "
          f"({len(NA.SOURCES)} sources, msv_tpu_torch/native/) {built}; "
          f"PACKS before {packs0}")

    # ---- 1. uplink: the hour through streaming_spec_db per transfer
    mm, sr = open_wav_mmap(hour)
    wav = np.array(mm)
    del mm
    win, hop, ops = operands(sr, card)
    route = K.MelRoute(None, ops[2], win=win, hop=hop,
                       n_fft=2 * (ops[2].shape[0] - 1), device=card,
                       dense=lambda: ops[:2])
    for mode in ("parity", "fast"):
        route.record(mode)  # laid out once, before the timed runs
    seg_log = []
    real_pack = S._pack_segment

    def logged_pack(seg_np, transfer):
        t0 = time.perf_counter()
        p = real_pack(seg_np, transfer)
        seg_log.append((seg_np.nbytes, None if p is None else p.nbytes,
                        time.perf_counter() - t0,
                        None if p is None else getattr(p, "pred", "v1")))
        return p

    S._pack_segment = logged_pack
    runs, planes = [], {}
    try:
        for mode, transfer in (("parity", "raw"), ("parity", "pack"),
                               ("parity", "pack1"), ("parity", "raw"),
                               ("fast", "raw"), ("fast", "pack")):
            seg_log.clear()
            with precision_mode_scope(mode):
                torch.cuda.synchronize()
                reset_counts(K)
                t0 = time.perf_counter()
                out = S.streaming_spec_db(wav, win, hop, route, None,
                                          None, transfer=transfer)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n = read_counts(K)
            n_seg = len(seg_log)
            check(n == counts(**{mode: n_seg}),
                  f"hour {mode} {transfer}: launches {n}, {n_seg} segments")
            legs.append((f"wire {mode} {transfer}", n))
            raw_b = sum(r[0] for r in seg_log)
            wire_b = sum(r[0] if r[1] is None else r[1] for r in seg_log)
            kinds = sorted({r[3] or "raw" for r in seg_log})
            runs.append((mode, transfer, wall, raw_b, wire_b,
                         sum(r[2] for r in seg_log), kinds))
            if (mode, "raw") not in planes:
                planes[mode, "raw"] = out
            else:
                ref = planes[mode, "raw"]
                check(torch.equal(out[0], ref[0]) and out[1:] == ref[1:],
                      f"hour {mode} {transfer}: plane or range != raw's")
                del out
    finally:
        S._pack_segment = real_pack
    for mode, transfer, wall, raw_b, wire_b, pack_s, kinds in runs:
        print(f"[wire] {smi}; the hour ({len(wav) / sr / 60:.0f} min "
              f"48 kHz PCM16) streaming_spec_db {mode} transfer={transfer}: "
              f"wall {wall:.3f} s, wire {wire_b} B of raw {raw_b} B (ratio "
              f"{raw_b / wire_b:.3f}), host pack {pack_s:.3f} s, streams "
              f"{kinds}; plane and range == raw's")
    del planes

    # one full segment of the hour: device unpack time (CUDA events,
    # median of 5, the fields already on the card)
    seg_len = 8 * 4096 * hop + (win - hop)
    seg = padded_slice(wav, sr * 600, sr * 600 + seg_len, win // 2,
                       len(wav))
    f32 = seg.astype(np.float32) / np.float32(32768.0)
    i32 = seg.astype(np.int32) * 3 + np.roll(seg, 1).astype(np.int32)
    # the hour's noise floor makes its v2 stream patched deltas: the LPC
    # stream's recurrence is timed on two tones over a quieter floor
    t = np.arange(seg_len) / sr
    tones = np.round(20000 * (0.5 * np.sin(2 * np.pi * 220 * t)
                              + 0.25 * np.sin(2 * np.pi * 440 * t))
                     + 50 * np.random.default_rng(SEED + 13).standard_normal(
                         seg_len)).astype(np.int16)
    cases = [("int16 v1", seg, W.pack_int(seg)),
             ("int16 v2", seg, W.pack_best(seg)),
             ("int16 v2 tones", tones, W.pack_best(tones)),
             ("f32 source", f32, W.pack_best(f32)),
             ("int32 carrier", i32, W.pack_best(i32))]
    check(getattr(cases[2][2], "pred", None) == "lpc",
          "the tones did not take the LPC stream")
    times = []
    for name, x, p in cases:
        check(p is not None, f"{name}: the segment did not pack")
        fields = {k: torch.from_numpy(v).to(card)
                  for k, v in W._wire_arrays(p).items()}
        got = W.unpack_fields(p, fields).cpu().numpy()
        want = W.unpack2_np(p)
        check(np.array_equal(got.view(np.uint8), want.view(np.uint8))
              and np.array_equal(want.view(np.uint8), x.view(np.uint8)),
              f"{name}: the card's unpack != unpack2_np / the samples")
        kind = getattr(p, "pred", "v1")
        ms = {"graphed" if kind == "lpc" else "unpack":
              cuda_ms(lambda: W.unpack_fields(p, fields))}
        if kind == "lpc":
            W.GRAPH_LPC = False
            try:
                ms["eager"] = cuda_ms(lambda: W.unpack_fields(p, fields))
            finally:
                W.GRAPH_LPC = True
        times.append(f"{name} ({kind}, {p.nbytes} B of {x.nbytes}): "
                     + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))
        del fields
    print(f"[wire] {smi}; one {seg_len}-sample segment, device unpack "
          f"(CUDA events, median of 5): " + "; ".join(times)
          + "; each bit-equal to unpack2_np and to the samples")
    del wav, seg, f32, i32, tones, cases

    # ---- 2. downlink: the packed dB export of the songs and of the hour
    torch.cuda.synchronize()
    reset_counts(K)
    ms_ = MultiTrack(device=dev)
    ms_.add_tracks(list(range(len(paths))), paths)
    n = read_counts(K)
    legs.append(("wire songs session", n))
    i48 = max(range(len(paths)), key=lambda i: ms_.tracks[i].sr)
    lines = []
    for bits in WIRE_BITS:
        ms_.timer.reset()
        errs, nbytes = [], 0
        for i in range(len(paths)):
            err, bound, nb = check_export(
                ms_, i, bits, bits == 10 or i == i48, f"song {i}")
            errs.append(err / bound)
            nbytes += nb
        stg = ms_.timer.summary()
        f32_b = sum(ms_._state[i].n_frames * ms_._state[i].n_out * 4
                    for i in range(len(paths)))
        lines.append(f"q{bits}: {nbytes} B fetched of f32 {f32_b} B (ratio "
                     f"{f32_b / nbytes:.3f}), pack "
                     f"{stg['get_spec_db.pack']['total_s']:.3f} s, "
                     f"fetch_unpack "
                     f"{stg['get_spec_db.fetch_unpack']['total_s']:.3f} s, "
                     f"max err/bound {max(errs):.3f}")
    t0 = time.perf_counter()
    for i in range(len(paths)):
        ms_.get_spec_db(i, wire="f32")
    f32_s = time.perf_counter() - t0
    print(f"[wire] {smi}; get_spec_db of the {len(paths)} songs (host "
          f"clock; words card == CPU and export == unpack_spec_np for q10 "
          f"and for the 48 kHz song at every width): "
          + "; ".join(lines) + f"; the f32 export {f32_s:.3f} s")

    torch.cuda.synchronize()
    reset_counts(K)
    mh = MultiTrack(device=dev)
    mh.add_tracks([0], [hour])
    n = read_counts(K)
    legs.append(("wire hour session", n))
    sth = mh._state[0]
    lines = []
    for bits in WIRE_BITS:
        mh.timer.reset()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        err, bound, nb = check_export(mh, 0, bits, bits == 10, "the hour")
        peak = torch.cuda.max_memory_allocated() - base
        stg = mh.timer.summary()
        lines.append(f"q{bits}: {nb} B fetched (ratio "
                     f"{sth.n_frames * sth.n_out * 4 / nb:.3f}), pack "
                     f"{stg['get_spec_db.pack']['total_s']:.3f} s, "
                     f"fetch_unpack "
                     f"{stg['get_spec_db.fetch_unpack']['total_s']:.3f} s, "
                     f"peak {peak / 2**30:.3f} GiB over the session's, err "
                     f"{err:.3g} <= {bound:.3g} dB")
    t0 = time.perf_counter()
    mh.get_spec_db(0, wire="f32")
    f32_s = time.perf_counter() - t0
    print(f"[wire] {smi}; get_spec_db of the hour ({sth.n_frames} x "
          f"{sth.n_out}, f32 {sth.n_frames * sth.n_out * 4} B; words card "
          f"== CPU for q10): " + "; ".join(lines)
          + f"; the f32 export {f32_s:.3f} s")
    del mh

    # ---- 3. the CLI: render --save-db --db-wire q10 of the songs
    out_dir = os.path.join(d, "render_q10")
    torch.cuda.synchronize()
    reset_counts(K)
    rc, text, wall = run_cli(["render", *paths, "-o", out_dir, "--save-db",
                              "--db-wire", "q10", "--no-wav", "--device",
                              dev])
    n = read_counts(K)
    check(rc == 0 and text.count("(wire q10)") == len(paths),
          f"render --db-wire q10: exit {rc}")
    legs.append(("wire render --db-wire q10", n))
    for i, p in enumerate(paths):
        stem = os.path.splitext(os.path.basename(p))[0]
        got = np.load(os.path.join(out_dir, f"db_{stem}.npy"))
        check(np.array_equal(got, ms_.get_spec_db(i, wire="q10")),
              f"render --db-wire q10: {stem}'s .npy != get_spec_db")
    del ms_
    packs = {k: W.PACKS[k] - packs0[k] for k in W.PACKS}
    check(packs["numpy"] == 0 and packs["native"] > 0,
          f"host codec calls by route {packs}: the numpy codec ran")
    print(f"[wire] {smi}; render --save-db --db-wire q10 of {len(paths)} "
          f"songs (--no-wav) {wall:.3f} s, each .npy == get_spec_db(wire="
          f"'q10'); host codec calls in phase 13 by route {packs} (PACKS "
          f"after {dict(W.PACKS)})")
    torch.cuda.empty_cache()
    print(f"[wire] phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return legs


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
    with tempfile.TemporaryDirectory(prefix="msv_chip_smoke_") as work:
        errs["parity"], heads["parity"] = phase_kernel(K, rng)
        session, song = phase_session(K, rng, work)
        # the later phases draw from their own streams (no check depends
        # on the signals drawn: see f32_agree)
        errs["fast"], heads["fast"] = phase_fast(
            K, np.random.default_rng(SEED + 1))
        errs["split"], heads["split"], split_path, _ = phase_split(
            K, np.random.default_rng(SEED + 4))
        survey = phase_survey(K, np.random.default_rng(SEED + 5), work)
        survey_paths, survey_heads, survey_errs, survey_launches = survey
        streaming, (hour, eight) = phase_streaming(
            K, np.random.default_rng(SEED + 2), work)
        paths = list(zip(
            ("session", "fast session", "linear session",
             "fast linear session", "streaming", "fast streaming",
             "linear streaming", "features", "split A/B", "residency"),
            (*session, *streaming,
             phase_features(K, np.random.default_rng(SEED + 3)),
             split_path, phase_residency(K, smi, song, hour))))
        paths += survey_paths
        legs, front = phase_frontends(K, smi, song, hour, eight, work)
        paths += legs
        paths += phase_analysis(K, smi, song, hour, eight, front, work)
        paths += phase_analysis2(K, smi, song, hour, eight, front, work)
        paths += phase_analysis3(K, smi, song, hour, eight, front, work)
        paths += phase_slice11(K, smi, song, hour, work)
        paths += phase_wire(K, smi, song, hour, work)
    launches = {m: sum(n[m] for _, n in paths) for m in K.MODES}
    print("[launches] main-path launches by path (parity, fast, split): "
          + json.dumps({name: [n[m] for m in K.MODES] for name, n in paths}))
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
    # the survey's tiers (no TPU kernel of their own: the Pallas kernel
    # holds whole windows in VMEM, and the TPU's linear scale is XLA's DFT
    # pair): parity's FFT tier, fast's chunked tier, parity's chunked tier
    # (at an n_fft with no FFT plan), the FFT tier's linear form; their
    # launches are the sessions' of 3d
    pallas = "msv_tpu/kernels/spectrogram_pallas.py:411"
    for mode, name, source, replaces in (
            ("parity", "mel_db_fft_kernel", K.FFT_SOURCE, pallas),
            ("fast", "mel_db_bf16_chunked_kernel", K.SOURCES["fast"],
             pallas),
            ("chunked", "mel_db_tf32_chunked_kernel", K.SOURCES["parity"],
             pallas),
            ("linear", "linear_db_fft_kernel", K.FFT_SOURCE,
             "msv_tpu/kernels/pipeline.py:35")):
        ms, plain_ms, shape, bound_ms, bound_by, lib_ms = survey_heads[mode]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": os.path.relpath(source),
            "replaces": replaces,
            "launches": survey_launches[mode],
            "max_abs_err": survey_errs[mode],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # torch.fft.rfft + magnitude (+ mel) + dB, never called by the
            # port
            "library_ms": lib_ms,
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
