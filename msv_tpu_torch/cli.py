"""Command-line shell of the PyTorch/CUDA port, ported from
``msv_tpu/cli.py``: the same subcommands and options, on one NVIDIA GPU.

    python -m msv_tpu_torch render a.wav b.wav -o outdir --px-per-sec 100
    python -m msv_tpu_torch view a.wav b.wav --port 8080
    python -m msv_tpu_torch info a.wav
    python -m msv_tpu_torch resample a.wav --sr 16000 -o outdir
    python -m msv_tpu_torch features a.wav --kind logmel -o outdir
    python -m msv_tpu_torch serve outdir  # static viewer for rendered PNGs

    python -m msv_tpu_torch filter a.wav --bandpass 200 5000 -o outdir
    python -m msv_tpu_torch gain a.wav --lufs -23 -o outdir
    python -m msv_tpu_torch reconstruct outdir/db_a.npy --sr 48000
    python -m msv_tpu_torch transcribe melody.wav -o outdir
    python -m msv_tpu_torch stretch a.wav --rate 0.5 -o outdir
    python -m msv_tpu_torch trim a.wav --split -o outdir
    python -m msv_tpu_torch align ref.wav take2.wav --write -o outdir
    python -m msv_tpu_torch analyze a.wav
    python -m msv_tpu_torch hpss a.wav -o outdir
    python -m msv_tpu_torch separate a.wav --components 4 -o outdir
    python -m msv_tpu_torch denoise a.wav --noise-span 0 0.5 -o outdir
    python -m msv_tpu_torch declick a.wav -o outdir
    python -m msv_tpu_torch specedit a.wav --box 1:2:400:1200:-24 -o outdir

Every subcommand that computes takes ``--device`` (default ``cuda``):
without a card it stops with an error and never falls back to the CPU on
its own; ``--device cpu`` runs the kernels' plain PyTorch versions.
"""

import argparse
import os
import sys
import time


def _add_device(p):
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where to compute: the card (default) or the CPU, which runs "
        "the kernels' plain PyTorch versions",
    )


def _build_parser():
    p = argparse.ArgumentParser(
        prog="msv_tpu_torch",
        description="multi-track spectrogram viewer on one NVIDIA GPU",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render spectrogram + waveform PNGs")
    r.add_argument("files", nargs="+")
    r.add_argument("-o", "--outdir", default=".")
    r.add_argument("--px-per-sec", type=float, default=100.0)
    r.add_argument("--height", type=int, default=500)
    r.add_argument("--wav-height", type=int, default=150)
    r.add_argument(
        "--png-level", type=int, default=2, choices=range(0, 10),
        metavar="0-9",
        help="zlib effort for output PNGs (2 default: 4.5x faster encode "
        "than 6 for ~15%% more bytes on spectrogram content; use 6+ for "
        "archival size)",
    )
    r.add_argument("--freq-scale", choices=["mel", "linear"], default="mel")
    r.add_argument("--win-ms", type=float, default=40.0)
    r.add_argument("--t-overlap", type=int, default=4)
    r.add_argument("--f-overlap", type=int, default=1)
    r.add_argument("--db-range", type=float, default=120.0)
    r.add_argument("--fast", action="store_true", help="bf16 fast mode")
    r.add_argument(
        "--engine",
        choices=["auto", "xla", "pallas"],
        default="auto",
        help="spectrogram compute engine",
    )
    r.add_argument("--no-wav", action="store_true")
    r.add_argument(
        "--save-db",
        action="store_true",
        help="also write the dB spectrogram as db_<name>.npy (float32 "
        "(n_frames, n_bands)); bit-exact f32 fetch by default — pass "
        "--db-wire q10 for a 3.5-5x smaller device->host transfer "
        "(~0.06 dB max quantization)",
    )
    r.add_argument(
        "--db-wire",
        choices=["q16", "q12", "q10", "q8", "f32"],
        default=None,
        help="device->host format for --save-db: bit-exact raw f32 "
        "(default) or opt-in packed fixed-point (q10: ~0.06 dB max "
        "error, 3.5-5x fewer wire bytes)",
    )
    r.add_argument("--start", type=float, default=None,
                   help="render only [start, end) seconds (viewport crop; "
                   "essential for hour-scale files)")
    r.add_argument("--end", type=float, default=None)
    r.add_argument(
        "--adaptive",
        action="store_true",
        help="adaptive multi-resolution spectrogram (transients from short "
        "windows, harmonics from long ones)",
    )
    r.add_argument(
        "--n-mel", type=int, default=None,
        help="bands for --adaptive (default: auto — the largest count "
        "with no empty band at the smallest analysis scale)",
    )
    r.add_argument(
        "--channel", type=int, default=None,
        help="render one source channel instead of the channel sum "
        "(stereo support — the reference's lib.rs:42 TODO; applies to "
        "every input file)",
    )
    _add_device(r)

    i = sub.add_parser("info", help="show decoded file + derived STFT params")
    i.add_argument("files", nargs="+")
    i.add_argument("--loudness", action="store_true",
                   help="also measure BS.1770-4 integrated loudness "
                   "(LUFS) over the file's own channels")
    _add_device(i)

    an = sub.add_parser(
        "analyze",
        help="full analysis report per file (JSON)",
        description="Run the whole analysis stack on each file's mono "
        "view at its native rate — loudness (BS.1770), tempo + beat "
        "count, key (Krumhansl-Schmuckler), structure boundaries, "
        "onsets, Viterbi-decoded pitch/voicing, spectral descriptors, "
        "active (non-silent) span — and print one JSON object per "
        "file (or write analysis_<stem>.json with -o).",
    )
    an.add_argument("files", nargs="+")
    an.add_argument("-o", "--outdir", default=None,
                    help="write analysis_<stem>.json instead of stdout")
    an.add_argument("--channel", type=int, default=None,
                    help="one source channel instead of the channel sum")
    _add_device(an)

    h = sub.add_parser(
        "hpss",
        help="split audio into harmonic + percussive WAVs",
        description="Median-filtering harmonic/percussive separation "
        "(ops/hpss.py): writes <stem>_harmonic.wav and "
        "<stem>_percussive.wav.  With the default margin the two parts "
        "sum back to the input.",
    )
    h.add_argument("files", nargs="+")
    h.add_argument("-o", "--outdir", default=".")
    h.add_argument("--kernel-time", type=int, default=31)
    h.add_argument("--kernel-freq", type=int, default=31)
    h.add_argument("--power", type=float, default=2.0,
                   help="softmask exponent (inf = hard binary masks)")
    h.add_argument("--margin", type=float, default=1.0,
                   help=">1 carves a residual (parts no longer sum to "
                   "the input)")
    h.add_argument("--win-ms", type=float, default=40.0)
    h.add_argument("--t-overlap", type=int, default=4)
    h.add_argument("--channel", type=int, default=None,
                   help="separate one source channel instead of the "
                   "channel sum")
    _add_device(h)

    tc = sub.add_parser(
        "transcribe",
        help="monophonic audio -> note events (JSON + MIDI)",
        description="YIN pitch + Viterbi voicing + onset-aware note "
        "segmentation (ops/transcribe.py): writes notes_<stem>.json "
        "and notes_<stem>.mid (format-0 SMF).",
    )
    tc.add_argument("files", nargs="+")
    tc.add_argument("-o", "--outdir", default=".")
    tc.add_argument("--fmin", type=float, default=65.0)
    tc.add_argument("--fmax", type=float, default=2093.0)
    tc.add_argument("--min-note-ms", type=float, default=60.0)
    tc.add_argument("--tempo", type=float, default=120.0,
                    help="MIDI tempo stamp (BPM)")
    tc.add_argument("--no-midi", action="store_true",
                    help="write only the JSON note list")
    tc.add_argument("--channel", type=int, default=None,
                    help="one source channel instead of the channel sum")
    _add_device(tc)

    sp = sub.add_parser(
        "separate",
        help="unsupervised source separation (NMF)",
        description="Factor the magnitude spectrogram into --components "
        "spectral templates x activations (KL multiplicative updates, "
        "ops/nmf.py) and write one Wiener-masked WAV per component "
        "(<stem>_part<k>.wav).  The parts sum back to the input.",
    )
    sp.add_argument("files", nargs="+")
    sp.add_argument("-o", "--outdir", default=".")
    sp.add_argument("--components", type=int, default=4)
    sp.add_argument("--iters", type=int, default=200)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--win-ms", type=float, default=40.0)
    sp.add_argument("--t-overlap", type=int, default=4)
    sp.add_argument("--channel", type=int, default=None,
                    help="separate one source channel instead of the "
                    "channel sum")
    _add_device(sp)

    st = sub.add_parser(
        "stretch",
        help="time-stretch or pitch-shift audio (phase vocoder)",
        description="Phase-vocoder effects (ops/effects.py, identity "
        "phase locking): --rate stretches duration by 1/rate at "
        "constant pitch; --semitones shifts pitch at constant "
        "duration.  Writes <stem>_x<rate>.wav / <stem>_ps<n>.wav.",
    )
    st.add_argument("files", nargs="+")
    st.add_argument("-o", "--outdir", default=".")
    st.add_argument("--rate", type=float, default=None,
                    help="speed factor (>1 faster/shorter, <1 slower)")
    st.add_argument("--semitones", type=float, default=None,
                    help="pitch shift in semitones (+/-)")
    st.add_argument("--no-phase-lock", action="store_true",
                    help="textbook per-bin phase accumulation instead "
                    "of identity phase locking")
    st.add_argument("--channel", type=int, default=None,
                    help="one source channel instead of the channel sum")
    _add_device(st)

    tr = sub.add_parser(
        "trim",
        help="strip or split audio on silence",
        description="RMS-gate silence (ops/effects.py trim/split): "
        "default strips leading/trailing silence to <stem>_trim.wav; "
        "--split writes one <stem>_part<k>.wav per non-silent "
        "interval.",
    )
    tr.add_argument("files", nargs="+")
    tr.add_argument("-o", "--outdir", default=".")
    tr.add_argument("--top-db", type=float, default=60.0,
                    help="silence threshold below the loudest frame (dB)")
    tr.add_argument("--split", action="store_true",
                    help="write each non-silent interval separately")
    tr.add_argument("--channel", type=int, default=None,
                    help="one source channel instead of the channel sum")
    _add_device(tr)

    rs = sub.add_parser(
        "resample",
        help="convert audio to another sample rate",
        description="Rational sample-rate conversion "
        "(ops/resample.py, scipy resample_poly parity): decodes any "
        "supported codec, converts ALL channels (or one with "
        "--channel) on device in bounded-memory segments, and writes "
        "<stem>_sr<rate>.wav.",
    )
    rs.add_argument("files", nargs="+")
    rs.add_argument("--sr", type=int, required=True,
                    help="target sample rate in Hz")
    rs.add_argument("-o", "--outdir", default=".")
    rs.add_argument("--bits", type=int, choices=[16, 32], default=16,
                    help="output WAV sample format (16 = PCM, "
                    "32 = float)")
    rs.add_argument("--channel", type=int, default=None,
                    help="convert one source channel (default: keep "
                    "all channels)")
    _add_device(rs)

    al = sub.add_parser(
        "align",
        help="estimate time offsets between takes of the same material",
        description="Cross-track alignment (ops/align.py): envelope NCC "
        "over every lag + GCC-PHAT refinement.  The FIRST file is the "
        "reference; each other file gets an offset (positive = its "
        "content happens later) and a confidence.  --write saves "
        "<stem>_aligned.wav copies shifted onto the reference timeline.",
    )
    al.add_argument("files", nargs="+",
                    help="reference file, then file(s) to align to it")
    al.add_argument("--max-lag", type=float, default=30.0,
                    help="search range in seconds (default 30)")
    al.add_argument("--write", action="store_true",
                    help="write time-shifted copies next to the offsets")
    al.add_argument("-o", "--outdir", default=".")
    al.add_argument("--channel", type=int, default=None,
                    help="one source channel instead of the channel sum")
    al.add_argument("--bits", type=int, choices=[16, 32], default=16)
    _add_device(al)

    dn = sub.add_parser(
        "denoise",
        help="reduce stationary noise (noise-profile spectral gating)",
        description="Stationary-noise reduction (ops/denoise.py): "
        "profile the noise — from --noise-span A B seconds the caller "
        "knows is noise-only, else blind per-bin percentile — then "
        "spectral-subtraction gain with a bounded attenuation floor "
        "and time-median gain smoothing.  Each channel denoises "
        "independently; writes <stem>_dn.wav.",
    )
    dn.add_argument("files", nargs="+")
    dn.add_argument("-o", "--outdir", default=".")
    dn.add_argument("--noise-span", type=float, nargs=2, default=None,
                    metavar=("A_S", "B_S"),
                    help="profile noise from this span (seconds)")
    dn.add_argument("--percentile", type=float, default=20.0,
                    help="blind noise-floor percentile (default 20)")
    dn.add_argument("--reduction-db", type=float, default=25.0,
                    help="maximum attenuation in dB (default 25)")
    dn.add_argument("--oversub", type=float, default=1.5,
                    help="over-subtraction factor (default 1.5)")
    dn.add_argument("--smooth", type=int, default=5,
                    help="odd time-median width for the gain "
                    "(default 5; 1 disables)")
    dn.add_argument("--channel", type=int, default=None,
                    help="one source channel instead of all channels")
    dn.add_argument("--bits", type=int, choices=[16, 32], default=16)
    _add_device(dn)

    dc = sub.add_parser(
        "declick",
        help="find and repair clicks/pops (LPC detection + patch repair)",
        description="Automatic click repair (ops/declick.py): two-pass "
        "LPC-residual detection finds transient defects, each repaired "
        "by a phase-coherent short-window STFT patch.  Spans too close "
        "to the signal edges are reported but left.  Each channel "
        "processes independently; writes <stem>_dc.wav.",
    )
    dc.add_argument("files", nargs="+")
    dc.add_argument("-o", "--outdir", default=".")
    dc.add_argument("--thresh", type=float, default=9.0,
                    help="robust outlier factor vs the frame residual "
                    "scale (default 9; lower finds more)")
    dc.add_argument("--max-click-ms", type=float, default=15.0,
                    help="spans longer than this are not clicks "
                    "(default 15)")
    dc.add_argument("--contrast", type=float, default=1.5,
                    help="local-isolation gate vs the +-10ms surround "
                    "(default 1.5; 0 disables — flags musical "
                    "transients too)")
    dc.add_argument("--detect-only", action="store_true",
                    help="print detected spans, write nothing")
    dc.add_argument("--channel", type=int, default=None,
                    help="one source channel instead of all channels")
    dc.add_argument("--bits", type=int, choices=[16, 32], default=16)
    _add_device(dc)

    se = sub.add_parser(
        "specedit",
        help="edit time-frequency boxes (duck / erase / patch repair)",
        description="Spectral editing (ops/specedit.py): apply "
        "rectangular time-frequency edits — the RX-style repair move. "
        "--box T0:T1:F0:F1[:GAIN_DB] ducks a region (seconds x Hz; "
        "gain default -80 dB = erase); --patch T0:T1:F0:F1 replaces it "
        "by interpolating each bin's magnitude across the span with "
        "phase-vocoder-coherent phase.  Repeatable; edges feathered. "
        "Each channel edits independently; writes <stem>_edit.wav.",
    )
    se.add_argument("files", nargs="+")
    se.add_argument("-o", "--outdir", default=".")
    se.add_argument("--box", action="append", default=[],
                    metavar="T0:T1:F0:F1[:GAIN_DB]",
                    help="duck/erase box (repeatable)")
    se.add_argument("--patch", action="append", default=[],
                    metavar="T0:T1:F0:F1",
                    help="patch-repair box (repeatable)")
    se.add_argument("--channel", type=int, default=None,
                    help="one source channel instead of all channels")
    se.add_argument("--bits", type=int, choices=[16, 32], default=16)
    _add_device(se)

    fl = sub.add_parser(
        "filter",
        help="EQ / filter audio (Butterworth + RBJ biquads)",
        description="General filtering (ops/filter.py): Butterworth "
        "lowpass/highpass/bandpass/bandstop designed on host, run on "
        "device as associative scans; plus repeatable RBJ EQ sections "
        "(--peak f0:gain_db[:q], --shelf lo|hi:f0:gain_db, "
        "--notch f0[:q]) applied after the Butterworth stage.  All "
        "channels filter independently; writes <stem>_filt.wav.",
    )
    fl.add_argument("files", nargs="+")
    fl.add_argument("-o", "--outdir", default=".")
    band = fl.add_mutually_exclusive_group()
    band.add_argument("--lowpass", type=float, metavar="HZ")
    band.add_argument("--highpass", type=float, metavar="HZ")
    band.add_argument("--bandpass", type=float, nargs=2,
                      metavar=("LO", "HI"))
    band.add_argument("--bandstop", type=float, nargs=2,
                      metavar=("LO", "HI"))
    fl.add_argument("--order", type=int, default=4,
                    help="Butterworth order (default 4)")
    fl.add_argument("--peak", action="append", default=[],
                    metavar="F0:GAIN_DB[:Q]",
                    help="peaking EQ section (repeatable)")
    fl.add_argument("--shelf", action="append", default=[],
                    metavar="lo|hi:F0:GAIN_DB",
                    help="shelving EQ section (repeatable)")
    fl.add_argument("--notch", action="append", default=[],
                    metavar="F0[:Q]",
                    help="notch section (repeatable)")
    fl.add_argument("--zero-phase", action="store_true",
                    help="forward-backward filtering (filtfilt): no "
                    "phase distortion, squared magnitude response")
    fl.add_argument("--channel", type=int, default=None,
                    help="one source channel instead of all channels")
    fl.add_argument("--bits", type=int, choices=[16, 32], default=16)
    _add_device(fl)

    gn = sub.add_parser(
        "gain",
        help="loudness-normalize audio (BS.1770 LUFS or peak)",
        description="Measure BS.1770-4 integrated loudness "
        "(ops/loudness.py) and apply one scalar gain to hit --lufs "
        "(default -23 LUFS, EBU R128); or peak-normalize with --peak. "
        "Writes <stem>_norm.wav; prints measured -> target and the "
        "output true sample peak.  --limit caps the gain so the "
        "output never clips.",
    )
    gn.add_argument("files", nargs="+")
    gn.add_argument("-o", "--outdir", default=".")
    gn.add_argument("--lufs", type=float, default=-23.0,
                    help="target integrated loudness (LUFS)")
    gn.add_argument("--peak", type=float, default=None,
                    help="peak-normalize to this linear amplitude "
                    "instead of loudness-matching")
    gn.add_argument("--limit", action="store_true",
                    help="reduce the gain if it would push the sample "
                    "peak past 0.999")
    gn.add_argument("--max-dbtp", type=float, default=None,
                    metavar="DB",
                    help="true-peak ceiling in dBTP (BS.1770 annex 2; "
                    "EBU R128 delivery: -1): reduce the gain so the "
                    "output's inter-sample peak stays at or under it")
    gn.add_argument("--bits", type=int, choices=[16, 32], default=16)
    _add_device(gn)

    fe = sub.add_parser(
        "features",
        help="extract ML features to .npy",
        description="Decode (any codec), resample to --target-sr on "
        "device, and write feats_<kind>_<stem>.npy per input file.  "
        "Kinds: logmel (n_frames, n_mel), mfcc (n_frames, n_mfcc), "
        "chroma (n_frames, 12), spectral (n_frames, 6 descriptors), "
        "whisper (80, 3000 transformers-parity), f0 (n_frames, 2: "
        "YIN Hz + aperiodicity), onsets (times in seconds), beats "
        "(beat times in seconds; BPM printed), tempogram "
        "(n_frames, 384 normalized local ACF at 100 fps), pcen "
        "(n_frames, n_mel per-channel-energy-normalized mel), tonnetz "
        "(n_frames, 6 tonal centroids), key (24 Krumhansl-Schmuckler "
        "correlations; winning key printed), contrast (n_frames, 7 "
        "octave-band spectral contrast dB), f0v (n_frames, 2: "
        "Viterbi-smoothed f0 Hz + voiced flag), segments (structure "
        "boundary times in seconds), mtspec (n_frames, n_freq "
        "multitaper dB — the low-variance Thomson estimate), "
        "reassigned (n_frames, n_freq sharpened dB — energy "
        "histogrammed at its reassigned time/frequency), "
        "lpcenv (n_frames, 513 LPC all-pole envelope dB), "
        "formants (n_frames, 5 Praat-style formant Hz, NaN gaps).",
    )
    fe.add_argument("files", nargs="+")
    fe.add_argument("-o", "--outdir", default=".")
    fe.add_argument("--kind", default="logmel",
                    choices=["logmel", "mfcc", "chroma", "spectral",
                             "whisper", "f0", "onsets", "beats",
                             "tempogram", "pcen", "tonnetz", "key",
                             "contrast", "f0v", "segments", "mtspec",
                             "reassigned", "lpcenv", "formants"])
    fe.add_argument("--target-sr", type=int, default=16000,
                    help="analysis rate (inputs resample on device; "
                    "whisper forces 16000)")
    fe.add_argument("--n-mel", type=int, default=128)
    fe.add_argument("--n-mfcc", type=int, default=13)
    fe.add_argument("--channel", type=int, default=None,
                    help="one source channel instead of the channel sum")
    _add_device(fe)

    g = sub.add_parser(
        "reconstruct",
        help="invert a dB spectrogram back to audio (Griffin-Lim)",
        description="Invert a `render --save-db` export (db_<name>.npy) — "
        "or any audio file, as a phase-discard roundtrip — back to a WAV "
        "via mel inversion + Griffin-Lim phase recovery, entirely on "
        "device.  Analysis parameters must match the ones the dB plane "
        "was rendered with (same defaults as `render`).",
    )
    g.add_argument("input", help="db_<name>.npy from --save-db, or an "
                   "audio file for an analysis->resynthesis roundtrip")
    g.add_argument("-o", "--out", default=None,
                   help="output WAV path (default recon_<stem>.wav)")
    g.add_argument("--sr", type=int, default=None,
                   help="sample rate of the original audio (REQUIRED for "
                   ".npy input; ignored for audio input)")
    g.add_argument("--n-iter", type=int, default=32,
                   help="Griffin-Lim iterations (default 32)")
    g.add_argument("--momentum", type=float, default=0.99,
                   help="accelerated-GL momentum (0 = classic 1983 "
                   "iteration)")
    g.add_argument("--freq-scale", choices=["mel", "linear"], default="mel")
    g.add_argument("--win-ms", type=float, default=40.0)
    g.add_argument("--t-overlap", type=int, default=4)
    g.add_argument("--f-overlap", type=int, default=1)
    g.add_argument("--normalize", action="store_true",
                   help="peak-normalize the output to 0.9 (otherwise the "
                   "dB plane's absolute scale is preserved)")
    g.add_argument("--channel", type=int, default=None,
                   help="for audio input: roundtrip one source channel "
                   "instead of the channel sum")
    _add_device(g)

    s = sub.add_parser("serve", help="serve rendered PNGs over HTTP")
    s.add_argument("dir")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--host", default="127.0.0.1",
                   help="bind address (default loopback; 0.0.0.0 to expose)")

    v = sub.add_parser("view", help="interactive web viewer (shared time axis)")
    v.add_argument("files", nargs="+")
    v.add_argument("--port", type=int, default=8080)
    v.add_argument("--host", default="127.0.0.1",
                   help="bind address (default loopback; 0.0.0.0 to expose)")
    v.add_argument("--add-root", default=None,
                   help="restrict POST /api/add to this directory tree")
    v.add_argument("--freq-scale", choices=["mel", "linear"], default="mel")
    v.add_argument(
        "--channel", type=int, default=None,
        help="open every track on one source channel (each track also "
        "gets a live mix/ch selector in the UI)",
    )
    _add_device(v)
    return p


def _check_device(args):
    """Stop with an error when the card was asked for and there is none:
    nothing falls back to the CPU unless ``--device cpu`` says so."""
    import torch

    from .utils.errors import MsvError

    if args.device == "cuda" and not torch.cuda.is_available():
        raise MsvError("no CUDA device (pass --device cpu to run the plain "
                       "PyTorch versions on the CPU)")


def _stem(f, channel):
    return os.path.splitext(os.path.basename(f))[0] + (
        "" if channel is None else f"_ch{channel}")


def adaptive_image(db, n_samples, sr, px_per_sec, height, db_range):
    """The adaptive render of a dB plane (n_frames, n_mel) tensor: the
    plane's own range (its max capped at 0 dB, at most ``db_range`` deep)
    to grey, Lanczos3 to ``height`` x px_per_sec * seconds, colormap.
    Returns (image (height, width, 3) u8 numpy, width)."""
    import torch

    from .config import precision_for
    from .render.colormap import grey_to_rgb_array
    from .render.resize import lanczos3_resize

    lo, hi = float(db.min()), min(float(db.max()), 0.0)
    lo = max(lo, hi - db_range)
    grey = torch.clamp((torch.flip(db.T, dims=(0,)) - lo) / (hi - lo),
                       0.0, 1.0)
    nwidth = int(px_per_sec * n_samples / sr)
    with precision_for("parity"):
        img = grey_to_rgb_array(lanczos3_resize(grey, height,
                                                max(nwidth, 1)))
    return img.cpu().numpy(), nwidth


def _render_adaptive(args, setting):
    """Adaptive multi-resolution render (ops/multires.py).

    Computed in exact 8192-frame segments via the slice-local form
    (bit-equal to the whole-track computation), so device memory stays
    bounded at one segment's frames even for hour-scale files."""
    import numpy as np
    import torch

    from .io.audio import open_audio_mono_ex
    from .io.png import write_png
    from .ops.multires import (
        adaptive_frame_count,
        multires_mel_spec_db_range,
        range_sample_window,
    )

    for f in args.files:
        # channel sum / single-channel select + bounds check live in the
        # canonical loader
        wav, sr, _, _, _ = open_audio_mono_ex(f, channel=args.channel)
        t0 = time.perf_counter()
        n = adaptive_frame_count(len(wav), sr, setting)
        parts = []
        for g0 in range(0, n, 8192):
            g1 = min(n, g0 + 8192)
            s0, s1 = range_sample_window(len(wav), sr, setting, g0, g1)
            part, _ = multires_mel_spec_db_range(
                wav[s0:s1], sr, g0, g1, setting=setting, slice_start=s0,
                n_samples=len(wav), n_mel=args.n_mel, device=args.device,
            )
            parts.append(part)
        db = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        img, nwidth = adaptive_image(db, len(wav), sr, args.px_per_sec,
                                     args.height, setting.db_range)
        stem = _stem(f, args.channel)
        out = os.path.join(args.outdir, f"spec_adaptive_{stem}.png")
        write_png(out, img, args.png_level)
        print(f"  {out}  {nwidth}x{args.height}  "
              f"({time.perf_counter() - t0:.2f}s)")
        if args.save_db:
            dout = os.path.join(args.outdir, f"db_adaptive_{stem}.npy")
            db_np = db.cpu().numpy()
            np.save(dout, db_np[:n])
            print(f"  {dout}  {n}x{db_np.shape[1]} f32")
    return 0


def _feature(kind, x, target, args):
    """``features --kind`` of the device tensor ``x`` at ``target`` Hz:
    (host array, extra text to print)."""
    import numpy as np

    from . import features as F
    from .ops import rhythm
    from .ops.lpc import formant_track, lpc_envelope_db
    from .ops.multitaper import multitaper_spec_db
    from .ops.pitch import yin
    from .ops.reassign import reassigned_spec_db
    from .ops.segment import segment
    from .ops.sequence import yin_smoothed
    from .ops.tonal import estimate_key, tonnetz

    if kind == "f0":
        f0, ap = yin(x, target, with_aperiodicity=True)
        return np.stack([f0.cpu().numpy(), ap.cpu().numpy()], axis=1), ""
    if kind == "f0v":
        f0, voiced = yin_smoothed(x, target)
        return np.stack([f0, voiced.astype(np.float32)], axis=1), ""
    if kind == "segments":
        return segment(x, target), ""
    if kind == "key":
        tonic, kmode, r, out = estimate_key(x, target)
        return out, ("  (atonal)" if tonic is None
                     else f"  {tonic} {kmode} (r={r:.2f})")
    if kind == "beats":
        bpm, out = rhythm.beat_track(x, target)
        return out, f"  {bpm:.1f} BPM"
    if kind == "onsets":
        return F.onset_detect(x, target), ""
    if kind == "tempogram":
        out = rhythm.tempogram_from_envelope(F.onset_strength(x, target),
                                             100.0)
    elif kind == "logmel":
        out = F.log_mel_spectrogram(x, target, n_mel=args.n_mel)
    elif kind == "mfcc":
        out = F.mfcc(x, target, n_mfcc=args.n_mfcc, n_mel=args.n_mel)
    elif kind == "chroma":
        out = F.chroma_stft(x, target)
    elif kind == "spectral":
        out = F.spectral_features(x, target)
    elif kind == "whisper":
        out = F.whisper_log_mel(x, 16000)
    elif kind == "pcen":
        out = F.pcen(x, target, n_mel=args.n_mel)
    elif kind == "tonnetz":
        out = tonnetz(x, target)
    elif kind == "lpcenv":
        out = lpc_envelope_db(x, target)[0]
    elif kind == "formants":
        out = formant_track(x, target)[0]
    elif kind == "mtspec":
        out = multitaper_spec_db(x, target)
    elif kind == "reassigned":
        return reassigned_spec_db(x, target), ""
    else:  # contrast
        out = F.spectral_contrast(x, target)
    return out.cpu().numpy(), ""


def _features_cmd(args):
    import numpy as np
    import torch

    from .io.audio import open_audio_mono_ex
    from .ops.resample import resample
    from .utils.errors import MsvError

    target = 16000 if args.kind == "whisper" else args.target_sr
    if target < 1000:
        raise MsvError(f"--target-sr too low: {target}")
    os.makedirs(args.outdir, exist_ok=True)
    for f in args.files:
        wav, sr, _, _, _ = open_audio_mono_ex(f, channel=args.channel)
        t0 = time.perf_counter()
        if sr != target:
            x = resample(wav, sr, target, device=args.device)
        else:
            x = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(
                args.device)
        out, extra = _feature(args.kind, x, target, args)
        dest = os.path.join(
            args.outdir, f"feats_{args.kind}_{_stem(f, args.channel)}.npy")
        np.save(dest, out.astype(np.float32))
        print(f"  {dest}  {out.shape}{extra}  "
              f"({time.perf_counter() - t0:.2f}s)")
    return 0


def _reconstruct_cmd(args):
    """dB export -> audio (ops/reconstruct.py): `render --save-db` output,
    or an audio file's own dB plane, back to a WAV by mel inversion and
    Griffin-Lim on the device."""
    import numpy as np
    import torch

    from .config import FreqScale, SpecSetting, derive_stft_params
    from .io.audio import write_wav
    from .ops.decibel import db_to_amp
    from .ops.mel import calc_mel_fb_default
    from .ops.reconstruct import griffin_lim, mel_to_linear
    from .utils.errors import MsvError

    setting = SpecSetting(
        win_ms=args.win_ms,
        t_overlap=args.t_overlap,
        f_overlap=args.f_overlap,
        freq_scale=FreqScale.MEL if args.freq_scale == "mel"
        else FreqScale.LINEAR,
    )
    length = None
    if args.input.endswith(".npy"):
        if args.sr is None:
            raise MsvError(
                "--sr is required for .npy input (the export does not "
                "record the sample rate; it is printed by `render` and "
                "`info`)"
            )
        sr = args.sr
        try:
            db = np.load(args.input)
        except (OSError, ValueError) as e:
            raise MsvError(f"{args.input}: {e}") from e
        if db.ndim != 2 or not np.issubdtype(db.dtype, np.floating):
            raise MsvError(
                f"{args.input}: expected a 2-D float dB array "
                f"(n_frames, n_bands), got {db.dtype} {db.shape}"
            )
        db = np.ascontiguousarray(db, np.float32)
    else:
        from . import MultiTrack

        mt = MultiTrack(setting, device=args.device)
        mt.add_tracks([0], [args.input], channels=[args.channel])
        sr = mt.tracks[0].sr
        length = mt.tracks[0].n_samples
        db = mt.get_spec_db(0, wire="f32")

    p = derive_stft_params(sr, setting)
    t0 = time.perf_counter()
    amp = db_to_amp(torch.from_numpy(db).to(args.device))
    if setting.freq_scale == FreqScale.MEL:
        fb = calc_mel_fb_default(sr, p.n_fft)
        if db.shape[1] != fb.shape[1]:
            raise MsvError(
                f"{args.input}: {db.shape[1]} bands but the mel filterbank "
                f"for sr={sr} (win {p.win_length}, n_fft {p.n_fft}) has "
                f"{fb.shape[1]} — wrong --sr, --win-ms/overlaps, or "
                "--freq-scale for this export?"
            )
        mag = mel_to_linear(amp, fb)
    else:
        if db.shape[1] != p.n_fft // 2 + 1:
            raise MsvError(
                f"{args.input}: {db.shape[1]} bands but a linear-scale "
                f"export for sr={sr} has {p.n_fft // 2 + 1} — wrong --sr, "
                "--win-ms/overlaps, or --freq-scale for this export?"
            )
        mag = amp
    try:
        y = griffin_lim(mag, p.win_length, p.hop_length, p.n_fft,
                        n_iter=args.n_iter, momentum=args.momentum,
                        length=length)
    except ValueError as e:
        raise MsvError(str(e)) from e
    dt = time.perf_counter() - t0
    if args.normalize:
        peak = float(np.abs(y).max())
        if peak > 0.0:
            y = y * np.float32(0.9 / peak)
    stem = os.path.splitext(os.path.basename(args.input))[0]
    stem = stem[3:] if stem.startswith("db_") else stem
    out = args.out or f"recon_{stem}.wav"
    write_wav(out, y[None, :], sr)
    print(
        f"  {out}  {len(y)} samples @ {sr} Hz ({len(y) / sr:.2f}s)  "
        f"peak {float(np.abs(y).max()):.3f}  "
        f"[{args.n_iter} GL iters in {dt:.2f}s]"
    )
    return 0


def _filter_sos_from_args(args, sr):
    """Assemble the SOS cascade a `filter` invocation asks for."""
    import numpy as np

    from .ops.filter import (butter_sos, high_shelf, low_shelf, notch,
                             peaking_eq)
    from .utils.errors import MsvError

    rows = []
    try:
        if args.lowpass is not None:
            rows.append(butter_sos(args.order, args.lowpass, "lowpass",
                                   sr=sr))
        if args.highpass is not None:
            rows.append(butter_sos(args.order, args.highpass, "highpass",
                                   sr=sr))
        if args.bandpass is not None:
            rows.append(butter_sos(args.order, tuple(args.bandpass),
                                   "bandpass", sr=sr))
        if args.bandstop is not None:
            rows.append(butter_sos(args.order, tuple(args.bandstop),
                                   "bandstop", sr=sr))
        for spec in args.peak:
            parts = spec.split(":")
            if len(parts) not in (2, 3):
                raise ValueError(f"--peak wants F0:GAIN_DB[:Q], got {spec!r}")
            f0, gain = float(parts[0]), float(parts[1])
            q = float(parts[2]) if len(parts) == 3 else 1.0
            rows.append(peaking_eq(sr, f0, gain, q))
        for spec in args.shelf:
            parts = spec.split(":")
            if len(parts) != 3 or parts[0] not in ("lo", "hi"):
                raise ValueError(
                    f"--shelf wants lo|hi:F0:GAIN_DB, got {spec!r}")
            fn = low_shelf if parts[0] == "lo" else high_shelf
            rows.append(fn(sr, float(parts[1]), float(parts[2])))
        for spec in args.notch:
            parts = spec.split(":")
            if len(parts) not in (1, 2):
                raise ValueError(f"--notch wants F0[:Q], got {spec!r}")
            q = float(parts[1]) if len(parts) == 2 else 30.0
            rows.append(notch(sr, float(parts[0]), q))
    except ValueError as e:
        raise MsvError(str(e)) from e
    if not rows:
        raise MsvError(
            "filter: give at least one of --lowpass/--highpass/--bandpass/"
            "--bandstop/--peak/--shelf/--notch")
    return np.concatenate(rows, axis=0)


def _filter_cmd(args):
    import numpy as np

    from .io.audio import open_audio_file, open_audio_mono_ex, write_wav
    from .ops.filter import filtfilt, sosfilt_streamed
    from .utils.errors import MsvError

    os.makedirs(args.outdir, exist_ok=True)
    for f in args.files:
        if args.channel is None:
            wav, sr = open_audio_file(f)  # (n_ch, T)
        else:
            mono, sr, _, _, _ = open_audio_mono_ex(f, channel=args.channel)
            wav = np.asarray(mono, np.float32)[None]
        sos = _filter_sos_from_args(args, sr)
        t0 = time.perf_counter()
        run = filtfilt if args.zero_phase else sosfilt_streamed
        try:
            out = np.stack([run(sos, ch, device=args.device) for ch in wav])
        except ValueError as e:
            raise MsvError(f"{f}: {e}") from e
        dt = time.perf_counter() - t0
        path = os.path.join(args.outdir, f"{_stem(f, args.channel)}_filt.wav")
        write_wav(path, out, sr, bits=args.bits)
        peak = float(np.max(np.abs(out))) if out.size else 0.0
        print(f"  {path}  {len(sos)} section(s), {out.shape[0]} ch, "
              f"out peak {peak:.4f}  ({dt:.2f}s)")
    return 0


def _gain_cmd(args):
    import numpy as np

    from .io.audio import open_audio_file, write_wav
    from .ops.loudness import integrated_loudness, true_peak
    from .utils.errors import MsvError

    os.makedirs(args.outdir, exist_ok=True)
    for f in args.files:
        wav, sr = open_audio_file(f)  # (n_ch, T)
        t0 = time.perf_counter()
        if args.peak is not None:
            if args.peak <= 0:
                raise MsvError(f"--peak must be positive, got {args.peak}")
            src = float(np.abs(wav).max())
            if src == 0.0:
                print(f"  {f}: silent, nothing written")
                continue
            g = args.peak / src
            what = f"peak {src:.4f} -> {args.peak:g}"
        else:
            try:
                lufs = integrated_loudness(wav, sr, device=args.device)
            except ValueError as e:
                raise MsvError(f"{f}: {e}") from e
            if lufs == float("-inf"):
                print(f"  {f}: below the -70 LUFS gate, nothing written")
                continue
            g = 10.0 ** ((args.lufs - lufs) / 20.0)
            what = f"{lufs:.2f} -> {args.lufs:g} LUFS"
        note_tp = ""
        if args.max_dbtp is not None:
            # scaling moves the true peak dB-for-dB, so one measurement
            # of the INPUT gives the exact ceiling gain — no re-measure
            tp_in = true_peak(wav, sr, device=args.device)
            if tp_in != float("-inf"):
                over = (tp_in + 20.0 * np.log10(g)) - args.max_dbtp
                if over > 0.0:
                    g *= 10.0 ** (-over / 20.0)
                    note_tp = (f"  (true-peak limited: -{over:.2f} dB "
                               f"to hit {args.max_dbtp:g} dBTP)")
        out = wav * np.float32(g)
        peak = float(np.abs(out).max())
        note = ""
        if peak > 0.999:
            if args.limit:
                out *= np.float32(0.999 / peak)
                note = f"  (limited: gain {20 * np.log10(g):+.2f} dB " \
                    f"-> {20 * np.log10(g * 0.999 / peak):+.2f} dB)"
                peak = 0.999
            else:
                note = "  (WARNING: will clip; use --limit)"
        dt = time.perf_counter() - t0
        stem = os.path.splitext(os.path.basename(f))[0]
        path = os.path.join(args.outdir, f"{stem}_norm.wav")
        write_wav(path, out, sr, bits=args.bits)
        print(f"  {path}  {what}, gain {20 * np.log10(g):+.2f} dB, "
              f"out peak {peak:.4f}  ({dt:.2f}s){note_tp}{note}")
    return 0


def _resample_cmd(args):
    import numpy as np

    from .io.audio import open_audio_file, open_audio_mono_ex, write_wav
    from .ops.resample import resample_streamed
    from .utils.errors import MsvError

    if args.sr < 1:
        raise MsvError(f"--sr must be positive, got {args.sr}")
    os.makedirs(args.outdir, exist_ok=True)
    for f in args.files:
        if args.channel is None:
            wav, sr = open_audio_file(f)  # (n_ch, T): keep all channels
        else:
            mono, sr, _, _, _ = open_audio_mono_ex(f, channel=args.channel)
            wav = np.asarray(mono, np.float32)[None]
        t0 = time.perf_counter()
        try:
            out = resample_streamed(wav, sr, args.sr, device=args.device)
        except ValueError as e:
            raise MsvError(f"{f}: {e}") from e
        dt = time.perf_counter() - t0
        path = os.path.join(args.outdir,
                            f"{_stem(f, args.channel)}_sr{args.sr}.wav")
        write_wav(path, out, args.sr, bits=args.bits)
        print(f"  {path}  {sr} -> {args.sr} Hz, {out.shape[0]} ch, "
              f"{out.shape[1] / args.sr:.3f}s  ({dt:.2f}s)")
    return 0


def _transcribe_cmd(args):
    import json as _json

    from .io.audio import open_audio_mono_ex
    from .ops.transcribe import transcribe_notes, write_midi
    from .utils.errors import MsvError

    os.makedirs(args.outdir, exist_ok=True)
    for f in args.files:
        wav, sr, _, _, _ = open_audio_mono_ex(f, channel=args.channel)
        t0 = time.perf_counter()
        try:
            notes = transcribe_notes(
                wav, sr, fmin=args.fmin, fmax=args.fmax,
                min_note_ms=args.min_note_ms, device=args.device,
            )
        except ValueError as e:
            raise MsvError(f"{f}: {e}") from e
        dt = time.perf_counter() - t0
        stem = _stem(f, args.channel)
        jout = os.path.join(args.outdir, f"notes_{stem}.json")
        with open(jout, "w") as fh:
            _json.dump({"sr": sr, "notes": notes}, fh, indent=1)
        line = f"  {jout}  {len(notes)} notes"
        if notes:
            lo = min(nt["midi"] for nt in notes)
            hi = max(nt["midi"] for nt in notes)
            line += f"  midi {lo}-{hi}"
        if not args.no_midi:
            mout = os.path.join(args.outdir, f"notes_{stem}.mid")
            write_midi(mout, notes, tempo_bpm=args.tempo)
            line += f"  + {os.path.basename(mout)}"
        print(line + f"  ({dt:.2f}s)")
    return 0


def _stretch_cmd(args):
    import numpy as np

    from .io.audio import open_audio_mono_ex, write_wav
    from .ops.effects import pitch_shift, time_stretch
    from .utils.errors import MsvError

    if (args.rate is None) == (args.semitones is None):
        raise MsvError("stretch: pass exactly one of --rate/--semitones")
    os.makedirs(args.outdir, exist_ok=True)
    lock = not args.no_phase_lock
    for f in args.files:
        wav, sr, _, _, _ = open_audio_mono_ex(f, channel=args.channel)
        t0 = time.perf_counter()
        try:
            if args.rate is not None:
                out = time_stretch(wav, args.rate, phase_lock=lock,
                                   device=args.device)
                tag = f"x{args.rate:g}"
            else:
                out = pitch_shift(wav, sr, args.semitones, phase_lock=lock,
                                  device=args.device)
                tag = f"ps{args.semitones:+g}"
        except ValueError as e:
            raise MsvError(f"{f}: {e}") from e
        dt = time.perf_counter() - t0
        path = os.path.join(args.outdir, f"{_stem(f, args.channel)}_{tag}.wav")
        write_wav(path, np.asarray(out)[None, :], sr)
        print(f"  {path}  {len(out) / sr:.2f}s  ({dt:.2f}s)")
    return 0


def _trim_cmd(args):
    import numpy as np

    from .io.audio import open_audio_mono_ex, write_wav
    from .ops.effects import split, trim
    from .utils.errors import MsvError

    os.makedirs(args.outdir, exist_ok=True)
    for f in args.files:
        wav, sr, _, _, _ = open_audio_mono_ex(f, channel=args.channel)
        t0 = time.perf_counter()
        try:
            if args.split:
                parts = [(a, b) for a, b in split(
                    wav, sr, top_db=args.top_db, device=args.device)]
            else:
                _, (a, b) = trim(wav, sr, top_db=args.top_db,
                                 device=args.device)
                parts = [(a, b)] if b > a else []
        except ValueError as e:
            raise MsvError(f"{f}: {e}") from e
        dt = time.perf_counter() - t0
        stem = _stem(f, args.channel)
        if not parts:
            print(f"  {f}: all silent (top_db={args.top_db:g}), "
                  f"nothing written  ({dt:.2f}s)")
            continue
        for k, (a, b) in enumerate(parts):
            name = (f"{stem}_part{k}.wav" if args.split
                    else f"{stem}_trim.wav")
            path = os.path.join(args.outdir, name)
            write_wav(path, np.asarray(wav[a:b], np.float32)[None, :], sr)
            print(f"  {path}  [{a / sr:.3f}s, {b / sr:.3f}s)  "
                  f"({dt:.2f}s)")
    return 0


def _align_cmd(args):
    import numpy as np

    from .io.audio import open_audio_file, open_audio_mono_ex, write_wav
    from .ops.align import align_offset
    from .utils.errors import MsvError

    if len(args.files) < 2:
        raise MsvError("align: need a reference file plus at least one "
                       "file to align to it")
    ref_mono, ref_sr, _, _, _ = open_audio_mono_ex(
        args.files[0], channel=args.channel)
    ref_mono = np.asarray(ref_mono, np.float32)
    print(f"reference: {args.files[0]} ({ref_sr} Hz)")
    if args.write:
        os.makedirs(args.outdir, exist_ok=True)
    for f in args.files[1:]:
        mono, sr, _, _, _ = open_audio_mono_ex(f, channel=args.channel)
        t0 = time.perf_counter()
        try:
            r = align_offset(ref_mono, ref_sr, np.asarray(mono, np.float32),
                             sr, max_lag_s=args.max_lag, device=args.device)
        except ValueError as e:
            raise MsvError(f"{f}: {e}") from e
        dt = time.perf_counter() - t0
        print(f"  {f}: offset {r.offset_s:+.4f}s  "
              f"confidence {r.confidence:.2f}  ({dt:.2f}s)")
        if args.write:
            wav, wsr = open_audio_file(f)
            shift = int(round(r.offset_s * wsr))
            if shift >= 0:   # content late: trim the head
                out = wav[:, shift:]
            else:            # content early: delay with silence
                out = np.concatenate(
                    [np.zeros((wav.shape[0], -shift), np.float32), wav],
                    axis=1)
            stem = os.path.splitext(os.path.basename(f))[0]
            path = os.path.join(args.outdir, f"{stem}_aligned.wav")
            write_wav(path, out, wsr, bits=args.bits)
            print(f"    -> {path}  ({out.shape[1] / wsr:.3f}s)")
    return 0


def _channels(f, channel):
    """(n_ch, T) float32 samples of ``f`` (one channel if asked) and sr."""
    import numpy as np

    from .io.audio import open_audio_file, open_audio_mono_ex

    if channel is None:
        return open_audio_file(f)
    mono, sr, _, _, _ = open_audio_mono_ex(f, channel=channel)
    return np.asarray(mono, np.float32)[None], sr


def _analyze_cmd(args):
    import json

    from .features import analyze
    from .io.audio import open_audio_mono_ex
    from .utils.errors import MsvError

    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
    for f in args.files:
        wav, sr, _, _, n_ch = open_audio_mono_ex(f, channel=args.channel)
        t0 = time.perf_counter()
        try:
            rep = {"path": f, "sr": sr, "channels": n_ch,
                   "channel": args.channel,
                   **analyze(wav, sr, device=args.device)}
        except ValueError as e:
            raise MsvError(f"{f}: {e}") from e
        rep["analysis_s"] = round(time.perf_counter() - t0, 2)
        if args.outdir:
            dest = os.path.join(args.outdir,
                                f"analysis_{_stem(f, args.channel)}.json")
            with open(dest, "w") as fh:
                json.dump(rep, fh, indent=2)
            print(f"  {dest}  ({rep['analysis_s']}s)")
        else:
            print(json.dumps(rep))
    return 0


def _hpss_cmd(args):
    import numpy as np

    from .config import SpecSetting, derive_stft_params
    from .io.audio import open_audio_mono_ex, write_wav
    from .ops.hpss import hpss
    from .utils.errors import MsvError

    setting = SpecSetting(win_ms=args.win_ms, t_overlap=args.t_overlap)
    os.makedirs(args.outdir, exist_ok=True)
    for f in args.files:
        wav, sr, _, _, _ = open_audio_mono_ex(f, channel=args.channel)
        p = derive_stft_params(sr, setting)
        t0 = time.perf_counter()
        try:
            h, pc = hpss(
                wav, p.win_length, p.hop_length, p.n_fft,
                kernel_time=args.kernel_time, kernel_freq=args.kernel_freq,
                power=args.power, margin=args.margin, device=args.device,
            )
        except ValueError as e:
            raise MsvError(f"{f}: {e}") from e
        dt = time.perf_counter() - t0
        stem = _stem(f, args.channel)
        for part, name in ((h, "harmonic"), (pc, "percussive")):
            out = os.path.join(args.outdir, f"{stem}_{name}.wav")
            write_wav(out, part[None, :], sr)
            rms = float(np.sqrt(np.mean(part * part)))
            print(f"  {out}  rms {rms:.4f}")
        print(f"separated {len(wav) / sr:.2f}s in {dt:.2f}s")
    return 0


def _separate_cmd(args):
    import numpy as np

    from .config import SpecSetting, derive_stft_params
    from .io.audio import open_audio_mono_ex, write_wav
    from .ops.nmf import separate
    from .utils.errors import MsvError

    setting = SpecSetting(win_ms=args.win_ms, t_overlap=args.t_overlap)
    os.makedirs(args.outdir, exist_ok=True)
    for f in args.files:
        wav, sr, _, _, _ = open_audio_mono_ex(f, channel=args.channel)
        p = derive_stft_params(sr, setting)
        t0 = time.perf_counter()
        try:
            parts, _, h = separate(
                wav, p.win_length, p.hop_length, p.n_fft,
                n_components=args.components, n_iter=args.iters,
                seed=args.seed, device=args.device,
            )
        except ValueError as e:
            raise MsvError(f"{f}: {e}") from e
        dt = time.perf_counter() - t0
        stem = _stem(f, args.channel)
        # loudest component first so part0 is the headline
        order = np.argsort(-(parts ** 2).sum(axis=1))
        for rank, kk in enumerate(order):
            out = os.path.join(args.outdir, f"{stem}_part{rank}.wav")
            write_wav(out, parts[kk][None, :], sr)
            rms = float(np.sqrt(np.mean(parts[kk] ** 2)))
            act = float(h[kk].max())
            print(f"  {out}  rms {rms:.4f}  peak-activation {act:.3g}")
        print(f"separated {len(wav) / sr:.2f}s into {len(order)} "
              f"components in {dt:.2f}s")
    return 0


def _denoise_cmd(args):
    import numpy as np

    from .config import SpecSetting, derive_stft_params
    from .io.audio import write_wav
    from .ops.denoise import denoise
    from .utils.errors import MsvError

    os.makedirs(args.outdir, exist_ok=True)
    for f in args.files:
        wav, sr = _channels(f, args.channel)
        p = derive_stft_params(sr, SpecSetting())
        t0 = time.perf_counter()
        try:
            out = np.stack([
                denoise(ch, p.win_length, p.hop_length, p.n_fft, sr=sr,
                        noise_span=(tuple(args.noise_span)
                                    if args.noise_span else None),
                        percentile=args.percentile,
                        oversub=args.oversub,
                        reduction_db=args.reduction_db,
                        smooth_time=args.smooth, device=args.device)
                for ch in wav])
        except ValueError as e:
            raise MsvError(f"{f}: {e}") from e
        dt = time.perf_counter() - t0
        path = os.path.join(args.outdir, f"{_stem(f, args.channel)}_dn.wav")
        write_wav(path, out, sr, bits=args.bits)
        drop = 20.0 * np.log10(
            max(float(np.std(wav)), 1e-12) / max(float(np.std(out)), 1e-12))
        print(f"  {path}  {out.shape[0]} ch, rms drop {drop:+.1f} dB  "
              f"({dt:.2f}s)")
    return 0


def _declick_cmd(args):
    import numpy as np

    from .io.audio import write_wav
    from .ops.declick import declick, find_clicks
    from .utils.errors import MsvError

    if not args.detect_only:
        os.makedirs(args.outdir, exist_ok=True)
    kw = {"thresh": args.thresh, "max_click_ms": args.max_click_ms,
          "contrast": args.contrast, "device": args.device}
    for f in args.files:
        wav, sr = _channels(f, args.channel)
        t0 = time.perf_counter()
        try:
            if args.detect_only:
                for ci, ch in enumerate(wav):
                    spans = find_clicks(ch, sr, **kw)
                    for (a, b) in spans:
                        print(f"  {f} ch{ci}  {a / sr:.4f}s - {b / sr:.4f}s"
                              f"  ({b - a} samples)")
                    if not spans:
                        print(f"  {f} ch{ci}  no clicks")
                continue
            chans, n_rep, n_skip = [], 0, 0
            for ch in wav:
                rep, spans, skipped = declick(ch, sr, **kw)
                chans.append(rep)
                n_rep += len(spans)
                n_skip += len(skipped)
            out = np.stack(chans)
        except ValueError as e:
            raise MsvError(f"{f}: {e}") from e
        dt = time.perf_counter() - t0
        path = os.path.join(args.outdir, f"{_stem(f, args.channel)}_dc.wav")
        write_wav(path, out, sr, bits=args.bits)
        skip_note = f", {n_skip} edge span(s) left" if n_skip else ""
        print(f"  {path}  {out.shape[0]} ch, {n_rep} click(s) "
              f"repaired{skip_note}  ({dt:.2f}s)")
    return 0


def _parse_box(spec: str, mode: str):
    from .ops.specedit import Box
    from .utils.errors import MsvError

    parts = spec.split(":")
    want = (4, 5) if mode == "gain" else (4,)
    if len(parts) not in want:
        raise MsvError(
            f"bad box '{spec}': expected T0:T1:F0:F1"
            + ("[:GAIN_DB]" if mode == "gain" else ""))
    try:
        vals = [float(v) for v in parts]
    except ValueError as e:
        raise MsvError(f"bad box '{spec}': {e}") from e
    try:
        if mode == "gain":
            gain = vals[4] if len(vals) == 5 else -80.0
            return Box(vals[0], vals[1], vals[2], vals[3], gain_db=gain)
        return Box(vals[0], vals[1], vals[2], vals[3], mode="patch")
    except ValueError as e:
        raise MsvError(f"bad box '{spec}': {e}") from e


def _specedit_cmd(args):
    import numpy as np

    from .config import SpecSetting, derive_stft_params
    from .io.audio import write_wav
    from .ops.specedit import spectral_edit
    from .utils.errors import MsvError

    boxes = ([_parse_box(b, "gain") for b in args.box]
             + [_parse_box(b, "patch") for b in args.patch])
    if not boxes:
        raise MsvError("no edits: give at least one --box or --patch")
    os.makedirs(args.outdir, exist_ok=True)
    for f in args.files:
        wav, sr = _channels(f, args.channel)
        p = derive_stft_params(sr, SpecSetting())
        t0 = time.perf_counter()
        try:
            out = np.stack([
                spectral_edit(ch, sr, boxes, win_length=p.win_length,
                              hop_length=p.hop_length, n_fft=p.n_fft,
                              device=args.device)
                for ch in wav])
        except ValueError as e:
            raise MsvError(f"{f}: {e}") from e
        dt = time.perf_counter() - t0
        path = os.path.join(args.outdir,
                            f"{_stem(f, args.channel)}_edit.wav")
        write_wav(path, out, sr, bits=args.bits)
        print(f"  {f}: {len(boxes)} edit(s) -> {path}  ({dt:.2f}s)")
    return 0


def _info_cmd(args):
    from .config import SpecSetting, derive_stft_params
    from .io.audio import open_audio_file
    from .utils.errors import MsvError

    for f in args.files:
        wav, sr = open_audio_file(f)
        p = derive_stft_params(sr, SpecSetting())
        extra = ""
        if args.loudness:
            from .ops.loudness import r128_stats

            try:
                r = r128_stats(wav, sr, device=args.device)
            except ValueError as e:
                raise MsvError(f"{f}: {e}") from e
            extra = (" loudness=-inf" if r["lufs"] is None
                     else f" loudness={r['lufs']:.2f}LUFS")
            if r["lra"] is not None:
                extra += f" lra={r['lra']:.1f}LU"
            extra += (" peak=-inf" if r["dbtp"] is None
                      else f" peak={r['dbtp']:.2f}dBTP")
        print(
            f"{f}: sr={sr} ch={wav.shape[0]} samples={wav.shape[1]} "
            f"sec={wav.shape[1]/sr:.3f} win={p.win_length} "
            f"hop={p.hop_length} n_fft={p.n_fft}" + extra
        )
    return 0


def _render_cmd(args):
    from . import FreqScale, MultiTrack, SpecSetting
    from .config import check_db_wire, get_db_wire
    from .io.png import write_png
    from .utils.errors import MsvError

    if args.db_wire is not None:
        try:
            check_db_wire(args.db_wire)
        except NotImplementedError as e:
            raise MsvError(str(e)) from e
    setting = SpecSetting(
        win_ms=args.win_ms,
        t_overlap=args.t_overlap,
        f_overlap=args.f_overlap,
        freq_scale=FreqScale.MEL if args.freq_scale == "mel"
        else FreqScale.LINEAR,
        db_range=args.db_range,
    )
    os.makedirs(args.outdir, exist_ok=True)

    if args.adaptive:
        return _render_adaptive(args, setting)

    import numpy as np

    mt = MultiTrack(setting, device=args.device)
    t0 = time.perf_counter()
    mt.add_tracks(list(range(len(args.files))), args.files,
                  channels=[args.channel] * len(args.files))
    t1 = time.perf_counter()
    print(f"loaded {len(args.files)} tracks in {t1 - t0:.3f}s "
          f"(db range [{mt.get_min_db():.1f}, {mt.get_max_db():.1f}])")
    crop = args.start is not None or args.end is not None
    for i, f in enumerate(args.files):
        stem = _stem(f, args.channel)
        if crop:
            s0 = args.start or 0.0
            s1 = args.end if args.end is not None else mt.get_sec(i)
            img = mt.get_spec_image_crop(i, args.px_per_sec, args.height,
                                         s0, s1)
            if img.shape[1] == 0:
                print(f"  {f}: window [{s0}, {s1}) s is outside the "
                      f"{mt.get_sec(i):.2f} s track — nothing to render")
                continue
        else:
            img = mt.get_spec_image(i, args.px_per_sec, args.height)
        out = os.path.join(args.outdir, f"spec_{stem}.png")
        write_png(out, img, args.png_level)
        print(f"  {out}  {img.shape[1]}x{img.shape[0]}")
        if not args.no_wav:
            if crop:
                wimg = mt.get_wav_image_crop(
                    i, args.px_per_sec, args.wav_height, -1.0, 1.0, s0, s1
                )
            else:
                wimg = mt.get_wav_image(
                    i, args.px_per_sec, args.wav_height, -1.0, 1.0
                )
            wout = os.path.join(args.outdir, f"wav_{stem}.png")
            write_png(wout, wimg, args.png_level)
            print(f"  {wout}  {wimg.shape[1]}x{wimg.shape[0]}")
        if args.save_db:
            db = mt.get_spec_db(i, wire=args.db_wire)
            dout = os.path.join(args.outdir, f"db_{stem}.npy")
            np.save(dout, db)
            wire = args.db_wire or get_db_wire()
            print(f"  {dout}  {db.shape[0]}x{db.shape[1]} f32 "
                  f"(wire {wire})")
    t2 = time.perf_counter()
    print(f"rendered in {t2 - t1:.3f}s")
    return 0


def main(argv=None):
    from .utils.errors import MsvError

    try:
        return _main(argv)
    except MsvError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _main(argv=None):
    args = _build_parser().parse_args(argv)
    if args.cmd == "serve":
        import functools
        import http.server

        handler = functools.partial(
            http.server.SimpleHTTPRequestHandler, directory=args.dir
        )
        print(f"serving {args.dir} on http://{args.host or '0.0.0.0'}:"
              f"{args.port}")
        http.server.HTTPServer((args.host, args.port),
                               handler).serve_forever()
        return 0

    _check_device(args)
    if args.cmd == "info":
        return _info_cmd(args)
    if args.cmd == "features":
        return _features_cmd(args)
    if args.cmd == "resample":
        return _resample_cmd(args)
    if args.cmd == "reconstruct":
        return _reconstruct_cmd(args)
    if args.cmd == "filter":
        return _filter_cmd(args)
    if args.cmd == "gain":
        return _gain_cmd(args)
    if args.cmd == "transcribe":
        return _transcribe_cmd(args)
    if args.cmd == "stretch":
        return _stretch_cmd(args)
    if args.cmd == "trim":
        return _trim_cmd(args)
    if args.cmd == "align":
        return _align_cmd(args)
    commands = {"analyze": _analyze_cmd, "hpss": _hpss_cmd,
                "separate": _separate_cmd, "denoise": _denoise_cmd,
                "declick": _declick_cmd, "specedit": _specedit_cmd}
    if args.cmd in commands:
        return commands[args.cmd](args)

    if args.cmd == "view":
        from . import FreqScale, SpecSetting
        from .viewer import serve_viewer

        setting = SpecSetting(
            freq_scale=FreqScale.MEL
            if args.freq_scale == "mel"
            else FreqScale.LINEAR
        )
        serve_viewer(args.files, args.port, setting, host=args.host,
                     add_root=args.add_root, channel=args.channel,
                     device=args.device)
        return 0

    # render: --fast and --engine hold for this command only
    from .config import get_engine, precision_mode_scope, set_engine

    engine = get_engine()
    if args.engine != "auto":
        set_engine(args.engine)
    try:
        if args.fast:
            with precision_mode_scope("fast"):
                return _render_cmd(args)
        return _render_cmd(args)
    finally:
        set_engine(engine)


if __name__ == "__main__":
    sys.exit(main())
