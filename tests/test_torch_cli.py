"""The port's command line (``python -m msv_tpu_torch``, ``msv_tpu_torch/
cli.py``) against msv_tpu's (``msv_tpu/cli.py``) on the same WAVs, on the
CPU (``--device cpu``).

Bounds: spectrogram PNGs (the grey8 wire) within one grey level of
msv_tpu's (the kernel's ln-based dB flips some levels, ROADMAP "Two dB
formulas"; a level flip moves a LUT colour by up to three u8 steps);
waveform PNGs within one u8 step; mel dB exports within atol 2e-3 dB /
rtol 1e-4, linear and adaptive planes by chip_smoke's ``f32_agree``; fast
mode (bf16 operands here, f32 in msv_tpu on the CPU) on white noise by the
fast-vs-parity bound of 99% of bins within one grey step (its images follow
the global dB floor, which bf16 moves); resampled WAVs within tests/test_resample.py's atol
2e-5.  The port's own outputs equal its library calls bit for bit.  The
parser keeps every msv_tpu subcommand and option; ``--device`` is the one
addition.  PNGs are decoded with zlib (``chip_smoke.png_pixels``).  The
card test runs where the card is (``-m gpu``; no JAX there).
"""

import argparse
import importlib
import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import msv_tpu_torch  # noqa: E402
from msv_tpu_torch import config as tcfg  # noqa: E402
from msv_tpu_torch.cli import _build_parser, adaptive_image, main  # noqa: E402
from msv_tpu_torch.io.audio import open_audio_file, write_wav  # noqa: E402
from msv_tpu_torch.render.colormap import _host_lut  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def jcli():
    """msv_tpu's command line (absent on the card's machine)."""
    pytest.importorskip("jax")
    return importlib.import_module("msv_tpu.cli")


@pytest.fixture(autouse=True)
def _port_mode_restored():
    yield
    tcfg.reset_precision_mode()


def _noise(path, sr, seconds=1.0, seed=3):
    """White noise: the signal of the fast-vs-parity bound (a tone's bins
    50 dB under its frame's peak swing further in bf16)."""
    x = np.random.default_rng(seed).standard_normal(int(seconds * sr)) * 0.3
    write_wav(path, x.astype(np.float32)[None], sr)
    return path


def _tone(path, sr=8000, seconds=1.0, seed=7, channels=1):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = (0.4 * np.sin(2 * np.pi * 440 * t)
         + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
    if channels == 2:
        x = np.stack([x, (0.5 * np.sin(2 * np.pi * 880 * t))
                      .astype(np.float32)])
    write_wav(path, x if x.ndim == 2 else x[None], sr)
    return path


@pytest.fixture()
def wav_path(tmp_path):
    return _tone(str(tmp_path / "tone.wav"))


def grey_levels(img):
    """Per pixel, the lowest and highest grey8 level whose LUT colour it is
    (the top stop is flat, so several levels share one colour)."""
    lut = _host_lut(8).astype(np.int64)
    key = (lut[:, 0] << 16) | (lut[:, 1] << 8) | lut[:, 2]
    px = img.astype(np.int64)
    px = (px[..., 0] << 16) | (px[..., 1] << 8) | px[..., 2]
    lo = np.full(px.shape, 1 << 30)
    hi = np.full(px.shape, -1)
    for q in range(256):
        m = px == key[q]
        lo[m] = np.minimum(lo[m], q)
        hi[m] = np.maximum(hi[m], q)
    assert (hi >= 0).all(), "pixel is not a grey8 LUT colour"
    return lo, hi


def level_gap(a, b):
    """Grey-level distance between two grey8-wire images, per pixel."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    (alo, ahi), (blo, bhi) = grey_levels(a), grey_levels(b)
    return np.maximum(np.maximum(alo - bhi, blo - ahi), 0)


def close_u8(a, b, steps=1):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= steps


def _run_both(jcli, args, tmp_path, port_extra=CPU):
    """The same command through both CLIs into out_port / out_jax."""
    outs = {}
    for name, fn, extra in (("port", main, port_extra),
                            ("jax", jcli.main, [])):
        out = str(tmp_path / f"out_{name}")
        assert fn([*args, "-o", out, *extra]) == 0, name
        outs[name] = out
    return outs


def _png(d, name):
    return cs.png_pixels(os.path.join(d, name))


# ------------------------------------------------------------- the parser


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices and
                     list(a.choices), a.help, a.nargs, a.type, a.required,
                     a.metavar) for a in parser._actions
            if a.dest not in ("help", "device")}


def _subparsers(parser):
    return next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction))


PORTED_DEVICE = ("render", "view", "info", "resample", "features", "filter",
                 "gain", "reconstruct", "transcribe", "stretch", "trim",
                 "align", "analyze", "hpss", "separate", "denoise",
                 "declick", "specedit")


@pytest.mark.parametrize("cmd", [
    "render", "info", "analyze", "hpss", "transcribe", "separate", "stretch",
    "trim", "resample", "align", "denoise", "declick", "specedit", "filter",
    "gain", "features", "reconstruct", "serve", "view"])
def test_parser_keeps_every_subcommand_and_option(cmd, jcli):
    port = _subparsers(_build_parser()).choices[cmd]
    ref = _subparsers(jcli._build_parser()).choices[cmd]
    assert _actions(port) == _actions(ref)
    assert port.description == ref.description
    has = any(a.dest == "device" for a in port._actions)
    assert has == (cmd in PORTED_DEVICE)
    if has:
        dev = next(a for a in port._actions if a.dest == "device")
        assert dev.default == "cuda" and list(dev.choices) == ["cuda", "cpu"]
    assert port.prog.startswith("msv_tpu_torch ")


# ---------------------------------------------------------------- render


def test_render_defaults_match_jax(wav_path, tmp_path, jcli, capsys):
    args = ["render", wav_path, "--px-per-sec", "50", "--height", "100"]
    outs = _run_both(jcli, args, tmp_path)
    spec = {k: _png(d, "spec_tone.png") for k, d in outs.items()}
    wav = {k: _png(d, "wav_tone.png") for k, d in outs.items()}
    assert spec["port"].shape == (100, 50, 3)
    assert level_gap(spec["port"], spec["jax"]).max() <= 1
    close_u8(wav["port"], wav["jax"])
    # the PNGs are the session's images, bit for bit
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks([0], [wav_path])
    np.testing.assert_array_equal(spec["port"],
                                  mt.get_spec_image(0, 50.0, 100))
    np.testing.assert_array_equal(
        wav["port"], mt.get_wav_image(0, 50.0, 150, -1.0, 1.0))
    assert "loaded 1 tracks" in capsys.readouterr().out


def test_render_time_crop_equals_slice_and_jax(wav_path, tmp_path, jcli):
    full = str(tmp_path / "full")
    assert main(["render", wav_path, "-o", full, "--px-per-sec", "80",
                 *CPU]) == 0
    args = ["render", wav_path, "--px-per-sec", "80", "--start", "0.25",
            "--end", "0.75"]
    outs = _run_both(jcli, args, tmp_path)
    c0, c1 = int(80 * 0.25), int(80 * 0.75)
    crop = _png(outs["port"], "spec_tone.png")
    np.testing.assert_array_equal(crop, _png(full, "spec_tone.png")[:, c0:c1])
    np.testing.assert_array_equal(_png(outs["port"], "wav_tone.png"),
                                  _png(full, "wav_tone.png")[:, c0:c1])
    assert level_gap(crop, _png(outs["jax"], "spec_tone.png")).max() <= 1
    close_u8(_png(outs["port"], "wav_tone.png"),
             _png(outs["jax"], "wav_tone.png"))


def test_render_time_crop_out_of_range(wav_path, tmp_path, capsys):
    out = str(tmp_path / "oob")
    assert main(["render", wav_path, "-o", out, "--start", "100", "--end",
                 "200", *CPU]) == 0
    assert not os.path.exists(os.path.join(out, "spec_tone.png"))
    assert "nothing to render" in capsys.readouterr().out


def test_render_save_db_matches_jax(wav_path, tmp_path, jcli, capsys):
    args = ["render", wav_path, "--px-per-sec", "50", "--height", "60",
            "--save-db", "--no-wav"]
    outs = _run_both(jcli, args, tmp_path)
    got = np.load(os.path.join(outs["port"], "db_tone.npy"))
    want = np.load(os.path.join(outs["jax"], "db_tone.npy"))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-4)
    assert not os.path.exists(os.path.join(outs["port"], "wav_tone.png"))
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks([0], [wav_path])
    np.testing.assert_array_equal(got, mt.get_spec_db(0))
    assert "(wire f32)" in capsys.readouterr().out


def test_render_adaptive_matches_jax(wav_path, tmp_path, jcli):
    args = ["render", wav_path, "--adaptive", "--n-mel", "48",
            "--px-per-sec", "40", "--height", "80", "--save-db"]
    outs = _run_both(jcli, args, tmp_path)
    got = np.load(os.path.join(outs["port"], "db_adaptive_tone.npy"))
    want = np.load(os.path.join(outs["jax"], "db_adaptive_tone.npy"))
    assert got.shape == want.shape and got.shape[1] == 48
    cs.check_f32(torch.from_numpy(got), torch.from_numpy(want),
                 "adaptive plane")
    img = _png(outs["port"], "spec_adaptive_tone.png")
    assert img.shape == _png(outs["jax"], "spec_adaptive_tone.png").shape
    # the PNG is the adaptive render of the exported plane, and the plane
    # is the whole-track form's
    want_img, _ = adaptive_image(torch.from_numpy(got), 8000, 8000, 40.0,
                                 80, 120.0)
    np.testing.assert_array_equal(img, want_img)
    whole, _ = msv_tpu_torch.ops.multires_mel_spec_db(
        open_audio_file(wav_path)[0][0], 8000, n_mel=48, device="cpu")
    np.testing.assert_array_equal(got, whole.numpy())
    close_u8(img, _png(outs["jax"], "spec_adaptive_tone.png"), steps=3)


def test_render_fast_matches_jax_and_scopes_the_mode(tmp_path, jcli):
    wav_path = _noise(str(tmp_path / "tone.wav"), 8000)
    args = ["render", wav_path, "--px-per-sec", "50", "--height", "100",
            "--fast", "--save-db", "--no-wav"]
    outs = _run_both(jcli, args, tmp_path)
    assert tcfg.get_precision_mode() == "parity"  # --fast held for the run
    assert not tcfg.precision_mode_is_explicit()
    # bf16 operands move the deepest bin, so the global dB floor, and with
    # it every grey level: the planes are compared, not the images
    img = _png(outs["port"], "spec_tone.png")
    assert img.shape == _png(outs["jax"], "spec_tone.png").shape
    got = np.load(os.path.join(outs["port"], "db_tone.npy"))
    want = np.load(os.path.join(outs["jax"], "db_tone.npy"))
    assert (np.abs(got - want) <= cs.GREY_STEP).mean() >= 0.99
    with tcfg.precision_mode_scope("fast"):
        mt = msv_tpu_torch.MultiTrack(device="cpu")
        mt.add_tracks([0], [wav_path])
    np.testing.assert_array_equal(got, mt.get_spec_db(0))
    np.testing.assert_array_equal(img, mt.get_spec_image(0, 50.0, 100))


def test_render_linear_matches_jax(wav_path, tmp_path, jcli):
    args = ["render", wav_path, "--px-per-sec", "50", "--height", "100",
            "--freq-scale", "linear", "--save-db"]
    outs = _run_both(jcli, args, tmp_path)
    got = np.load(os.path.join(outs["port"], "db_tone.npy"))
    want = np.load(os.path.join(outs["jax"], "db_tone.npy"))
    assert got.shape == want.shape == (101, 257)
    cs.check_f32(torch.from_numpy(got), torch.from_numpy(want),
                 "linear plane")
    assert level_gap(_png(outs["port"], "spec_tone.png"),
                     _png(outs["jax"], "spec_tone.png")).max() <= 1


def test_render_engine_flags(wav_path, tmp_path):
    """Every engine renders (on the CPU all three run the plain version),
    and --engine holds for the command only."""
    from msv_tpu_torch.config import get_engine

    imgs = {}
    for engine in ("auto", "pallas", "xla"):
        out = str(tmp_path / engine)
        assert main(["render", wav_path, "-o", out, "--engine", engine,
                     "--no-wav", "--px-per-sec", "40", "--height", "80",
                     *CPU]) == 0
        imgs[engine] = _png(out, "spec_tone.png")
        assert get_engine() == "auto"
    np.testing.assert_array_equal(imgs["auto"], imgs["pallas"])
    np.testing.assert_array_equal(imgs["auto"], imgs["xla"])


@pytest.mark.parametrize("wire", ["q16", "q12", "q10", "q8"])
def test_render_packed_db_wire_is_an_error(wire, wav_path, tmp_path,
                                           capsys):
    assert main(["render", wav_path, "-o", str(tmp_path), "--save-db",
                 "--db-wire", wire, *CPU]) == 1
    err = capsys.readouterr().err
    assert err.startswith("error:") and "queue 1 item 12" in err


def test_render_channel_and_png_level(tmp_path, jcli):
    p = _tone(str(tmp_path / "st.wav"), channels=2)
    args = ["render", p, "--channel", "1", "--png-level", "6",
            "--px-per-sec", "50", "--height", "60"]
    outs = _run_both(jcli, args, tmp_path)
    assert level_gap(_png(outs["port"], "spec_st_ch1.png"),
                     _png(outs["jax"], "spec_st_ch1.png")).max() <= 1
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks([0], [p], channels=[1])
    np.testing.assert_array_equal(_png(outs["port"], "wav_st_ch1.png"),
                                  mt.get_wav_image(0, 50.0, 150, -1.0, 1.0))


# ------------------------------------------------------- info and errors


def test_info_matches_jax(wav_path, jcli, capsys):
    assert main(["info", wav_path, *CPU]) == 0
    port = capsys.readouterr().out
    assert jcli.main(["info", wav_path]) == 0
    assert port == capsys.readouterr().out
    assert "sr=8000" in port and "win=320" in port


def test_info_loudness_is_not_ported(tmp_path, jcli, capsys):
    """``info --loudness`` (ported since this test was named) prints
    msv_tpu's line: LUFS and LRA within 0.01 LU, the true peak within
    1e-4 dB (tests/test_loudness.py:192), before their rounding."""
    p = _tone(str(tmp_path / "st.wav"), sr=16000, seconds=4.0, channels=2)
    assert main(["info", p, "--loudness", *CPU]) == 0
    port = capsys.readouterr().out
    assert jcli.main(["info", p, "--loudness"]) == 0
    want = capsys.readouterr().out
    num = r"([-\d.]+)"
    pat = rf"loudness={num}LUFS lra={num}LU peak={num}dBTP"
    got, ref = re.search(pat, port), re.search(pat, want)
    assert port[:port.index(" loudness=")] == want[:want.index(" loudness=")]
    for a, b, tol in zip(got.groups(), ref.groups(), (0.01, 0.1, 0.01)):
        assert abs(float(a) - float(b)) <= tol + 1e-9
    x, sr = open_audio_file(p)
    from msv_tpu.ops.loudness import r128_stats as j_r128
    from msv_tpu_torch.ops.loudness import r128_stats

    r, jr = r128_stats(x, sr, device="cpu"), j_r128(x, sr)
    assert abs(r["lufs"] - jr["lufs"]) <= 0.01 + 1e-9
    assert abs(r["dbtp"] - jr["dbtp"]) <= 0.01 + 1e-9


def test_missing_file_error(tmp_path, capsys):
    assert main(["render", str(tmp_path / "no.wav"), "-o", str(tmp_path),
                 *CPU]) == 1
    assert capsys.readouterr().err.startswith("error:")


@pytest.mark.parametrize("cmd", ["render", "info", "resample", "features",
                                 "view", "filter", "gain", "reconstruct",
                                 "transcribe", "stretch", "trim", "align",
                                 "analyze", "hpss", "separate", "denoise",
                                 "declick", "specedit"])
def test_no_card_is_an_error_without_device_cpu(cmd, wav_path, tmp_path,
                                                capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default route runs there")
    extra = {"resample": ["--sr", "16000"], "view": ["--port", "0"],
             "filter": ["--lowpass", "1000"],
             "reconstruct": ["-o", str(tmp_path / "o" / "r.wav")],
             "stretch": ["--rate", "2"], "align": [wav_path, "--write"],
             "specedit": ["--box", "0.1:0.2:100:500"]}
    args = [cmd, wav_path, *extra.get(cmd, [])]
    if cmd not in ("info", "view", "reconstruct"):
        args += ["-o", str(tmp_path / "o")]
    assert main(args) == 1
    err = capsys.readouterr().err
    assert err.startswith("error: no CUDA device") and "--device cpu" in err
    assert not os.path.exists(str(tmp_path / "o"))


def _clicked(path, sr=8000, seconds=1.0):
    """A stereo tone with three planted clicks (tests/test_declick.py's
    kind: their residual ratios are decisive)."""
    t = np.arange(int(seconds * sr)) / sr
    x = np.stack([0.4 * np.sin(2 * np.pi * 440 * t),
                  0.3 * np.sin(2 * np.pi * 440 * t + 1.0)])
    for k, ts in enumerate((0.21, 0.47, 0.73)):
        x[:, int(ts * sr):int(ts * sr) + 3] += 0.6 if k % 2 else -0.6
    write_wav(path, x.astype(np.float32), sr)
    return path


def _same_wav(path, y, sr, tmp_path, bits=16):
    """The WAV at ``path`` decodes to what writing ``y`` decodes to."""
    ref = str(tmp_path / "lib.wav")
    write_wav(ref, np.atleast_2d(y), sr, bits=bits)
    got, want = open_audio_file(path), open_audio_file(ref)
    return got[1] == want[1] and np.array_equal(got[0], want[0])


# subcommand -> (extra arguments, its outputs' names)
ANALYSIS_3 = {
    "hpss": ([], ["clk_harmonic.wav", "clk_percussive.wav"]),
    "separate": (["--components", "2", "--iters", "5"],
                 ["clk_part0.wav", "clk_part1.wav"]),
    "denoise": (["--percentile", "30"], ["clk_dn.wav"]),
    "declick": ([], ["clk_dc.wav"]),
    "specedit": (["--box", "0.1:0.3:300:900:-30", "--patch",
                  "0.5:0.52:0:4000"], ["clk_edit.wav"]),
    "analyze": ([], ["analysis_clk.json"]),
}


@pytest.mark.parametrize("cmd", sorted(ANALYSIS_3))
def test_analysis_3_subcommands_equal_the_library_calls(cmd, tmp_path,
                                                        capsys):
    """Each subcommand's files equal the library call on the same
    samples, on the CPU."""
    import json

    from msv_tpu_torch.config import SpecSetting, derive_stft_params
    from msv_tpu_torch.features import analyze
    from msv_tpu_torch.io.audio import open_audio_mono_ex
    from msv_tpu_torch.ops.declick import declick
    from msv_tpu_torch.ops.denoise import denoise
    from msv_tpu_torch.ops.hpss import hpss
    from msv_tpu_torch.ops.nmf import separate
    from msv_tpu_torch.ops.specedit import Box, spectral_edit

    path = _clicked(str(tmp_path / "clk.wav"))
    extra, names = ANALYSIS_3[cmd]
    out = str(tmp_path / "o")
    assert main([cmd, path, *extra, "-o", out, *CPU]) == 0
    st, sr = open_audio_file(path)
    mono = open_audio_mono_ex(path)[0]
    p = derive_stft_params(sr, SpecSetting())
    stft = (p.win_length, p.hop_length, p.n_fft)
    cpu = {"device": "cpu"}
    if cmd == "analyze":
        rep = json.load(open(os.path.join(out, names[0])))
        want = analyze(mono, sr, **cpu)
        assert {k: rep[k] for k in want} == json.loads(json.dumps(want))
        assert rep["n_clicks"] >= 1
        return
    if cmd == "hpss":
        outs = hpss(mono, *stft, **cpu)
    elif cmd == "separate":
        parts = separate(mono, *stft, n_components=2, n_iter=5, **cpu)[0]
        outs = parts[np.argsort(-(parts ** 2).sum(axis=1))]
    elif cmd == "denoise":
        outs = [np.stack([denoise(ch, *stft, sr=sr, percentile=30.0, **cpu)
                          for ch in st])]
    elif cmd == "declick":
        reps = [declick(ch, sr, **cpu) for ch in st]
        assert all(len(r[1]) == 3 for r in reps)
        outs = [np.stack([r[0] for r in reps])]
    else:
        bx = [Box(0.1, 0.3, 300, 900, gain_db=-30.0),
              Box(0.5, 0.52, 0, 4000, mode="patch")]
        outs = [np.stack([spectral_edit(
            ch, sr, bx, win_length=p.win_length, hop_length=p.hop_length,
            n_fft=p.n_fft, **cpu) for ch in st])]
    for name, y in zip(names, outs):
        assert _same_wav(os.path.join(out, name), y, sr, tmp_path), name


@pytest.mark.parametrize("kind", ["mtspec", "reassigned"])
def test_features_analysis_3_kinds_equal_the_library_calls(kind, wav_path,
                                                           tmp_path):
    from msv_tpu_torch.io.audio import open_audio_mono_ex
    from msv_tpu_torch.ops.multitaper import multitaper_spec_db
    from msv_tpu_torch.ops.reassign import reassigned_spec_db
    from msv_tpu_torch.ops.resample import resample

    assert main(["features", wav_path, "-o", str(tmp_path), "--kind", kind,
                 *CPU]) == 0
    got = np.load(str(tmp_path / f"feats_{kind}_tone.npy"))
    x = resample(open_audio_mono_ex(wav_path)[0], 8000, 16000, device="cpu")
    want = (multitaper_spec_db(x, 16000).numpy() if kind == "mtspec"
            else reassigned_spec_db(x, 16000))
    assert got.shape == want.shape == (63, 513)
    np.testing.assert_array_equal(got, want)


def test_analysis_3_subcommands_match_jax(tmp_path, jcli):
    """hpss and denoise through both command lines: the WAVs within the
    port tests' bounds (2e-5, 2e-4) plus one PCM16 step."""
    path = _clicked(str(tmp_path / "clk.wav"))
    for cmd, names, tol in (("hpss", ["clk_harmonic.wav"], 2e-5),
                            ("denoise", ["clk_dn.wav"], 2e-4)):
        outs = _run_both(jcli, [cmd, path], tmp_path / cmd)
        for name in names:
            got, want = (open_audio_file(os.path.join(outs[k], name))[0]
                         for k in ("port", "jax"))
            np.testing.assert_allclose(got, want, atol=tol + 2 ** -15)


# ------------------------------------------------- resample and features


def test_resample_matches_jax(tmp_path, jcli):
    p = _tone(str(tmp_path / "st.wav"), sr=44100, seconds=2.0, channels=2)
    args = ["resample", p, "--sr", "16000", "--bits", "32"]
    outs = _run_both(jcli, args, tmp_path)
    y, sr = open_audio_file(os.path.join(outs["port"], "st_sr16000.wav"))
    want, _ = open_audio_file(os.path.join(outs["jax"], "st_sr16000.wav"))
    assert sr == 16000 and y.shape == want.shape == (2, 32000)
    np.testing.assert_allclose(y, want, atol=2e-5, rtol=0)
    x, _ = open_audio_file(p)
    from msv_tpu_torch.ops.resample import resample_streamed

    np.testing.assert_array_equal(
        y, resample_streamed(x, 44100, 16000, device="cpu"))
    # --channel picks one source channel; PCM16 by default
    out = str(tmp_path / "one")
    assert main(["resample", p, "--sr", "8000", "--channel", "1", "-o", out,
                 *CPU]) == 0
    y1, sr1 = open_audio_file(os.path.join(out, "st_ch1_sr8000.wav"))
    assert sr1 == 8000 and y1.shape[0] == 1
    spec = np.abs(np.fft.rfft(y1[0] * np.hanning(y1.shape[1])))
    assert abs(spec.argmax() * 8000 / y1.shape[1] - 880.0) < 2.0
    with pytest.raises(SystemExit):
        main(["resample", p])  # --sr required


def test_features_logmel_matches_jax(tmp_path, jcli):
    p = _noise(str(tmp_path / "tone.wav"), 22050)
    outs = _run_both(jcli, ["features", p, "--kind", "logmel"], tmp_path)
    got = np.load(os.path.join(outs["port"], "feats_logmel_tone.npy"))
    want = np.load(os.path.join(outs["jax"], "feats_logmel_tone.npy"))
    assert got.dtype == np.float32 and got.shape == want.shape == (101, 128)
    # fast (bf16 operands) against msv_tpu's f32 on the CPU
    assert (np.abs(got - want) <= cs.GREY_STEP).mean() >= 0.99
    # the direct op path: the device resample, then the default frontend
    from msv_tpu_torch.ops.resample import resample

    x = resample(open_audio_file(p)[0][0], 22050, 16000, device="cpu")
    np.testing.assert_array_equal(
        got, msv_tpu_torch.log_mel_spectrogram(x, 16000).numpy())
    # already at the target rate: no resample
    p16 = _tone(str(tmp_path / "t16.wav"), sr=16000)
    out = str(tmp_path / "f16")
    assert main(["features", p16, "-o", out, "--n-mel", "64", *CPU]) == 0
    np.testing.assert_array_equal(
        np.load(os.path.join(out, "feats_logmel_t16.npy")),
        msv_tpu_torch.log_mel_spectrogram(open_audio_file(p16)[0][0], 16000,
                                          n_mel=64, device="cpu").numpy())


def _clicks(path, sr=16000, seconds=6.0):
    """A 120 BPM click train over a tone and a noise floor, stereo (onsets
    and beats).  Without the floor, mel bands far from the tone sit 150 dB
    or more under it, where f32 summation order and bf16 operands move dB
    by tens (in msv_tpu's fast mode on a TPU as well)."""
    t = np.arange(int(seconds * sr)) / sr
    x = (0.05 * np.sin(2 * np.pi * 440 * t)
         + 0.005 * np.random.default_rng(5).standard_normal(len(t)))
    for t0 in np.arange(0.25, seconds - 0.5, 0.5):
        i = int(t0 * sr)
        x[i:i + 200] += 0.7 * np.hanning(200)
    write_wav(path, np.stack([x, 0.5 * x]).astype(np.float32), sr)
    return path


# kind -> bound of the port's .npy against msv_tpu's, both in parity (the
# session-wide mode set explicitly, which every feature follows):
# tests/test_features.py's atol for whisper (:279), mfcc (:375) and pcen
# (:689), rtol/atol for chroma (:574) and contrast (:814), the loosest
# spectral column's rtol (:490-495), tests/test_rhythm.py:40's atol for the
# tempogram; onsets and beats equal (host peak picking and the beat DP)
FEATURE_BOUNDS = {"mfcc": (0, 2e-4), "chroma": (1e-4, 1e-6),
                  "spectral": (1e-3, 1e-7), "whisper": (0, 3e-4),
                  "pcen": (0, 2e-4), "contrast": (1e-3, 2e-3),
                  "tempogram": (0, 5e-5), "onsets": None, "beats": None}


@pytest.mark.parametrize("kind", sorted(FEATURE_BOUNDS))
def test_features_kinds_match_jax(kind, tmp_path, jcli, capsys):
    from msv_tpu import config as jcfg
    from msv_tpu_torch.cli import _feature
    from msv_tpu_torch.io.audio import open_audio_mono_ex

    p = _clicks(str(tmp_path / "cl.wav"))
    x = torch.from_numpy(np.ascontiguousarray(open_audio_mono_ex(p)[0]))
    args = ["features", p, "--kind", kind, "--n-mel", "64"]
    name = f"feats_{kind}_cl.npy"
    ns = argparse.Namespace(n_mel=64, n_mfcc=13)
    # the default precision (fast, bf16 operands): the library call
    out = str(tmp_path / "fast")
    assert main([*args, "-o", out, *CPU]) == 0
    np.testing.assert_array_equal(
        np.load(os.path.join(out, name)),
        _feature(kind, x, 16000, ns)[0].astype(np.float32))
    tcfg.set_precision_mode("parity")
    jcfg.set_precision_mode("parity")
    try:
        outs = _run_both(jcli, args, tmp_path)
    finally:
        jcfg.reset_precision_mode()
    got = np.load(os.path.join(outs["port"], name))
    want = np.load(os.path.join(outs["jax"], name))
    assert got.dtype == np.float32 and got.shape == want.shape
    if FEATURE_BOUNDS[kind] is None:
        np.testing.assert_array_equal(got, want)
        assert len(got) >= 8
    else:
        rtol, atol = FEATURE_BOUNDS[kind]
        off = np.abs(got - want) > atol + rtol * np.abs(want)
        # contrast's valley is one bin of a band here; where that bin is
        # 100 dB or more under the frame's tone, f32 summation order moves
        # it by a few percent (chip_smoke's f32_agree rule for deep bins:
        # at most FLOOR_SHARE of the values; measured one of 4207)
        share = cs.FLOOR_SHARE if kind == "contrast" else 0.0
        assert off.mean() <= share, np.abs(got - want)[off]
    if kind == "beats":
        bpm = re.findall(r"([\d.]+) BPM", capsys.readouterr().out)
        assert len(bpm) == 3 and set(bpm) == {"120.0"}
    np.testing.assert_array_equal(
        got, _feature(kind, x, 16000, ns)[0].astype(np.float32))


@pytest.mark.parametrize("zero_phase", [False, True])
def test_filter_matches_jax(zero_phase, tmp_path, jcli):
    p = _tone(str(tmp_path / "st.wav"), sr=16000, seconds=2.0, channels=2)
    args = ["filter", p, "--bandpass", "200", "5000", "--shelf",
            "hi:3000:6", "--peak", "1000:-3:2", "--bits", "32"]
    if zero_phase:
        args.append("--zero-phase")
    outs = _run_both(jcli, args, tmp_path)
    y, sr = open_audio_file(os.path.join(outs["port"], "st_filt.wav"))
    want, _ = open_audio_file(os.path.join(outs["jax"], "st_filt.wav"))
    assert sr == 16000 and y.shape == want.shape == (2, 32000)
    # tests/test_filter.py's bounds: 2e-5 forward (:79), 5e-5 (:99)
    assert np.abs(y - want).max() < (5e-5 if zero_phase else 2e-5)
    from msv_tpu_torch.cli import _filter_sos_from_args
    from msv_tpu_torch.ops.filter import filtfilt, sosfilt_streamed

    ns = _build_parser().parse_args(args)
    sos = _filter_sos_from_args(ns, sr)
    x = open_audio_file(p)[0]
    run = filtfilt if zero_phase else sosfilt_streamed
    np.testing.assert_array_equal(y, np.stack([run(sos, c, device="cpu")
                                               for c in x]))


def test_filter_errors(wav_path, tmp_path, capsys):
    for extra in ([], ["--lowpass", "9000"], ["--peak", "1000"],
                  ["--shelf", "mid:100:3"]):
        assert main(["filter", wav_path, "-o", str(tmp_path), *extra,
                     *CPU]) == 1
        assert capsys.readouterr().err.startswith("error:")


def test_gain_matches_jax(tmp_path, jcli, capsys):
    p = _tone(str(tmp_path / "st.wav"), sr=16000, seconds=3.0, channels=2)
    for extra in ([], ["--lufs", "-14", "--max-dbtp", "-1"],
                  ["--peak", "0.5"]):
        args = ["gain", p, "--bits", "32", *extra]
        outs = _run_both(jcli, args, tmp_path)
        y, _ = open_audio_file(os.path.join(outs["port"], "st_norm.wav"))
        want, _ = open_audio_file(os.path.join(outs["jax"], "st_norm.wav"))
        # one scalar gain: 0.01 LU of loudness is 0.12% of amplitude
        np.testing.assert_allclose(y, want, rtol=1.2e-3, atol=1e-7)
    capsys.readouterr()


def test_reconstruct_matches_jax(tmp_path, jcli):
    """One Griffin-Lim iteration of msv_tpu's --save-db export within 1e-4
    of the peak of msv_tpu's (tests/test_torch_reconstruct.py), mel and
    linear; an audio input's roundtrip keeps the length."""
    p = _tone(str(tmp_path / "n.wav"), sr=16000)
    for scale in ("mel", "linear"):
        d = str(tmp_path / f"db_{scale}")
        assert jcli.main(["render", p, "-o", d, "--save-db", "--no-wav",
                          "--freq-scale", scale]) == 0
        db = os.path.join(d, "db_n.npy")
        outs = {}
        for name, fn, extra in (("port", main, CPU), ("jax", jcli.main, [])):
            outs[name] = str(tmp_path / f"{name}_{scale}.wav")
            assert fn(["reconstruct", db, "--sr", "16000", "--n-iter", "1",
                       "--freq-scale", scale, "-o", outs[name],
                       *extra]) == 0
        y, sr = open_audio_file(outs["port"])
        want, _ = open_audio_file(outs["jax"])
        assert sr == 16000 and y.shape == want.shape
        # PCM16 output: plus one quantization step
        assert np.abs(y - want).max() <= 1e-4 * np.abs(want).max() + 2**-15
    out = str(tmp_path / "rt.wav")
    assert main(["reconstruct", p, "--n-iter", "2", "-o", out, *CPU]) == 0
    assert open_audio_file(out)[0].shape == open_audio_file(p)[0][:1].shape


def test_reconstruct_errors(tmp_path, capsys):
    np.save(str(tmp_path / "bad.npy"), np.zeros((10, 7), np.float32))
    for args in (["--sr", "8000"], []):
        assert main(["reconstruct", str(tmp_path / "bad.npy"), *args,
                     *CPU]) == 1
        assert capsys.readouterr().err.startswith("error:")


def test_module_entry_point_runs(wav_path, tmp_path):
    """``python -m msv_tpu_torch`` as a user runs it."""
    out = str(tmp_path / "o")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "msv_tpu_torch", "render",
                        wav_path, "-o", out, "--device", "cpu",
                        "--px-per-sec", "50", "--height", "100"],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks([0], [wav_path])
    np.testing.assert_array_equal(cs.png_pixels(
        os.path.join(out, "spec_tone.png")), mt.get_spec_image(0, 50.0, 100))
    r = subprocess.run([sys.executable, "-m", "msv_tpu_torch", "render",
                        str(tmp_path / "missing.wav"), "--device", "cpu"],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(tmp_path), env=env)
    assert r.returncode == 1 and r.stderr.startswith("error:")
    assert "Traceback" not in r.stderr


@pytest.mark.gpu
def test_render_on_the_card(tmp_path):
    """``render`` of a 10 s WAV on the card: one parity launch, PNGs
    within one grey level of the CPU run's, waveforms equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from msv_tpu_torch.kernels import spectrogram_cuda as K

    p = _tone(str(tmp_path / "ten.wav"), sr=44100, seconds=10.0)
    outs = {}
    before = K.LAUNCHES_BY_MODE["parity"]
    for dev in ("cuda", "cpu"):
        outs[dev] = str(tmp_path / dev)
        assert main(["render", p, "-o", outs[dev], "--device", dev]) == 0
    assert K.LAUNCHES_BY_MODE["parity"] == before + 1
    assert level_gap(_png(outs["cuda"], "spec_ten.png"),
                     _png(outs["cpu"], "spec_ten.png")).max() <= 1
    np.testing.assert_array_equal(_png(outs["cuda"], "wav_ten.png"),
                                  _png(outs["cpu"], "wav_ten.png"))


# ------------------------------------------------- the analysis subcommands


def _melody(path, sr=16000, freqs=(440.0, 523.25, 659.26), dur=0.5,
            gap=0.15, lead=0.15):
    """tests/test_transcribe.py's gapped melody (10 ms ramps), with
    ``lead`` seconds of silence before it and ``gap`` between notes."""
    t = np.arange(int(dur * sr)) / sr
    env = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.01)
    parts = [np.zeros(int(lead * sr))]
    for f in freqs:
        parts += [0.4 * env * np.sin(2 * np.pi * f * t),
                  np.zeros(int(gap * sr))]
    write_wav(path, np.concatenate(parts).astype(np.float32)[None], sr)
    return path


def _two_sections(path, sr=16000, seconds=20.0):
    """A tone, then noise: one structure boundary at ``seconds``."""
    t = np.arange(int(seconds * sr)) / sr
    x = np.concatenate([0.4 * np.sin(2 * np.pi * 440 * t),
                        0.2 * np.random.default_rng(2).standard_normal(
                            len(t))])
    write_wav(path, x.astype(np.float32)[None], sr)
    return path


def _vowel(path, sr=16000):
    """A 120 Hz pulse train through resonators at 700 and 1800 Hz
    (tests/test_lpc.py's vowel): voiced in every frame.  Formant picks of
    near-silent frames follow f32 noise in the envelope, so the formant
    kind is compared on a signal without silence."""
    import scipy.signal

    src = np.zeros(sr)
    src[:: sr // 120] = 1.0
    y = src
    for f0, bw in ((700.0, 80.0), (1800.0, 120.0)):
        r = np.exp(-np.pi * bw / sr)
        th = 2 * np.pi * f0 / sr
        y = scipy.signal.lfilter([1.0], [1.0, -2 * r * np.cos(th), r * r], y)
    write_wav(path, (0.5 * y / np.abs(y).max()).astype(np.float32)[None], sr)
    return path


def _ar_noise(path, sr=16000):
    """Noise through an AR(4) filter (tests/test_lpc.py:71): at the default
    order its normal equations are well conditioned.  On sustained tones
    they are near-singular (the reflection clamp of ops/lpc.py), and both
    implementations' envelope nulls follow f32 rounding there."""
    import scipy.signal

    x = scipy.signal.lfilter([1.0], [1.0, -1.2, 0.8, -0.3, 0.1],
                             np.random.default_rng(4).standard_normal(sr))
    write_wav(path, (0.5 * x / np.abs(x).max()).astype(np.float32)[None], sr)
    return path


def _f0_close(got, want):
    # tests/test_pitch.py:72-73: f0 rtol 5e-3; ap rtol 5e-2, atol 5e-4
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=5e-3)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=5e-2, atol=5e-4)


def _formants_close(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.nanmax(np.abs(got - want)) <= 5500.0 / 1023  # a grid step


# kind -> check of the port's .npy against msv_tpu's, both in parity:
# the port tests' tolerances (tests/test_torch_pitch.py, _sequence, _lpc,
# _tonal, _segment)
ANALYSIS_KINDS = {
    "f0": _f0_close,
    "f0v": np.testing.assert_array_equal,
    "segments": np.testing.assert_array_equal,
    "tonnetz": lambda g, w: np.testing.assert_allclose(g, w, atol=1e-5),
    "key": lambda g, w: np.testing.assert_allclose(g, w, atol=1e-4),
    "lpcenv": lambda g, w: np.testing.assert_allclose(g, w, atol=1e-3),
    "formants": _formants_close,
}


@pytest.mark.parametrize("kind", sorted(ANALYSIS_KINDS))
def test_features_analysis_kinds_match_jax(kind, tmp_path, jcli, capsys):
    from msv_tpu import config as jcfg
    from msv_tpu_torch.cli import _feature
    from msv_tpu_torch.io.audio import open_audio_mono_ex

    p = {"segments": _two_sections, "formants": _vowel,
         "lpcenv": _ar_noise}.get(kind, _melody)(str(tmp_path / "m.wav"))
    x = torch.from_numpy(np.ascontiguousarray(open_audio_mono_ex(p)[0]))
    args = ["features", p, "--kind", kind]
    name = f"feats_{kind}_m.npy"
    ns = argparse.Namespace(n_mel=128, n_mfcc=13)
    out = str(tmp_path / "default")
    assert main([*args, "-o", out, *CPU]) == 0
    got = np.load(os.path.join(out, name))
    np.testing.assert_array_equal(
        got, _feature(kind, x, 16000, ns)[0].astype(np.float32))
    tcfg.set_precision_mode("parity")
    jcfg.set_precision_mode("parity")
    try:
        outs = _run_both(jcli, args, tmp_path)
    finally:
        jcfg.reset_precision_mode()
    got = np.load(os.path.join(outs["port"], name))
    want = np.load(os.path.join(outs["jax"], name))
    assert got.dtype == np.float32 and got.shape == want.shape
    ANALYSIS_KINDS[kind](got, want)
    if kind == "segments":
        assert got.shape == (1,) and abs(got[0] - 20.0) <= 1.0
    if kind == "key":
        printed = re.findall(r"\(24,\)  (\S+ \S+) \(r=", capsys.readouterr().out)
        assert len(printed) == 3 and len(set(printed)) == 1


def test_transcribe_matches_jax(tmp_path, jcli):
    import json

    from msv_tpu_torch.ops.transcribe import transcribe_notes, write_midi

    p = _melody(str(tmp_path / "mel.wav"))
    outs = _run_both(jcli, ["transcribe", p, "--tempo", "90"], tmp_path)
    got = json.load(open(os.path.join(outs["port"], "notes_mel.json")))
    want = json.load(open(os.path.join(outs["jax"], "notes_mel.json")))
    assert got == want and [n["midi"] for n in got["notes"]] == [69, 72, 76]
    wav, sr = open_audio_file(p)
    notes = transcribe_notes(wav[0], sr, device="cpu")
    assert got == {"sr": sr, "notes": json.loads(json.dumps(notes))}
    mid = open(os.path.join(outs["port"], "notes_mel.mid"), "rb").read()
    assert mid == open(os.path.join(outs["jax"], "notes_mel.mid"),
                       "rb").read()
    write_midi(str(tmp_path / "direct.mid"), notes, tempo_bpm=90.0)
    assert mid == (tmp_path / "direct.mid").read_bytes()
    out = str(tmp_path / "nomidi")
    assert main(["transcribe", p, "--no-midi", "-o", out, *CPU]) == 0
    assert sorted(os.listdir(out)) == ["notes_mel.json"]


@pytest.mark.parametrize("flag", [["--rate", "0.5"], ["--semitones", "3"]])
def test_stretch_matches_jax(flag, tmp_path, jcli, capsys):
    from msv_tpu_torch.ops.effects import pitch_shift, time_stretch

    p = _melody(str(tmp_path / "mel.wav"))
    outs = _run_both(jcli, ["stretch", p, *flag], tmp_path)
    tag = "x0.5" if flag[0] == "--rate" else "ps+3"
    y, sr = open_audio_file(os.path.join(outs["port"], f"mel_{tag}.wav"))
    want, _ = open_audio_file(os.path.join(outs["jax"], f"mel_{tag}.wav"))
    wav = open_audio_file(p)[0][0]
    direct = (time_stretch(wav, 0.5, device="cpu") if tag == "x0.5"
              else pitch_shift(wav, sr, 3.0, device="cpu"))
    write_wav(str(tmp_path / "direct.wav"), direct[None], sr)
    np.testing.assert_array_equal(
        y, open_audio_file(str(tmp_path / "direct.wav"))[0])
    assert y.shape == want.shape
    # tests/test_torch_effects.py's bounds, plus one PCM16 step
    err = np.abs(y - want) / np.abs(want).max()
    assert err.max() <= 0.05 + 2.0**-14
    assert np.percentile(err, 99) <= 1e-3 + 2.0**-14
    capsys.readouterr()
    assert main(["stretch", p, "--rate", "2", "--semitones", "1",
                 *CPU]) == 1
    assert "exactly one of --rate/--semitones" in capsys.readouterr().err
    assert main(["stretch", p, "--rate", "0", "-o", str(tmp_path / "z"),
                 *CPU]) == 1


@pytest.mark.parametrize("split", [False, True])
def test_trim_matches_jax(split, tmp_path, jcli, capsys):
    from msv_tpu_torch.ops.effects import split as split_op, trim

    p = _melody(str(tmp_path / "mel.wav"), gap=0.6, lead=0.8)
    args = ["trim", p, *(["--split"] if split else [])]
    outs = _run_both(jcli, args, tmp_path)
    names = sorted(os.listdir(outs["port"]))
    assert names == sorted(os.listdir(outs["jax"]))
    for n in names:
        np.testing.assert_array_equal(
            open_audio_file(os.path.join(outs["port"], n))[0],
            open_audio_file(os.path.join(outs["jax"], n))[0])
    wav, sr = open_audio_file(p)
    if split:
        iv = split_op(wav[0], sr, device="cpu")
        assert names == [f"mel_part{k}.wav" for k in range(len(iv))]
        assert len(iv) == 3
    else:
        _, (a, b) = trim(wav[0], sr, device="cpu")
        iv = [(a, b)]
        assert names == ["mel_trim.wav"]
    for n, (a, b) in zip(names, iv):
        write_wav(str(tmp_path / "d.wav"), wav[:, a:b], sr)
        np.testing.assert_array_equal(
            open_audio_file(os.path.join(outs["port"], n))[0],
            open_audio_file(str(tmp_path / "d.wav"))[0])
    silent = str(tmp_path / "silent.wav")
    write_wav(silent, np.zeros((1, 8000), np.float32), 8000)
    capsys.readouterr()
    assert main(["trim", silent, "-o", str(tmp_path / "s"), *CPU]) == 0
    assert "all silent" in capsys.readouterr().out


def test_align_matches_jax(tmp_path, jcli, capsys):
    from msv_tpu_torch.ops.align import align_offset

    rng = np.random.default_rng(11)
    sr = 16000
    n = 6 * sr
    env = np.abs(np.convolve(rng.standard_normal(n), np.hanning(sr // 2),
                             "same"))
    x = (env / env.max() * rng.standard_normal(n) * 0.3).astype(np.float32)
    d = int(0.75 * sr)
    ref = str(tmp_path / "ref.wav")
    late = str(tmp_path / "late.wav")
    write_wav(ref, x[None], sr)
    write_wav(late, np.concatenate([np.zeros(d, np.float32), x])[None], sr)
    args = ["align", ref, late, "--max-lag", "2", "--write", "--bits", "32"]
    outs = {}
    for name, fn, extra in (("port", main, CPU), ("jax", jcli.main, [])):
        outs[name] = str(tmp_path / f"out_{name}")
        capsys.readouterr()
        assert fn([*args, "-o", outs[name], *extra]) == 0
        outs[name + "_log"] = capsys.readouterr().out
    pat = r"offset ([-+\d.]+)s  confidence ([\d.]+)"
    got = re.findall(pat, outs["port_log"])
    assert got == re.findall(pat, outs["jax_log"]) and len(got) == 1
    r = align_offset(open_audio_file(ref)[0][0], sr,
                     open_audio_file(late)[0][0], sr, max_lag_s=2.0,
                     device="cpu")
    assert got[0] == (f"{r.offset_s:+.4f}", f"{r.confidence:.2f}")
    assert abs(r.offset_s - 0.75) < 1e-3
    y = open_audio_file(os.path.join(outs["port"], "late_aligned.wav"))[0]
    np.testing.assert_array_equal(
        y, open_audio_file(os.path.join(outs["jax"], "late_aligned.wav"))[0])
    np.testing.assert_array_equal(y[:, :len(x) - d],
                                  open_audio_file(ref)[0][:, :len(x) - d])
    assert main(["align", ref, *CPU]) == 1
    assert "need a reference file" in capsys.readouterr().err


@pytest.mark.gpu
def test_analysis_subcommands_on_the_card(tmp_path):
    """transcribe, stretch and features --kind f0v on the card equal the
    CPU run's notes, the stretch within tests/test_torch_effects.py's
    bounds, the voicing equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json

    p = _melody(str(tmp_path / "mel.wav"))
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = str(tmp_path / dev)
        for args in (["transcribe", p], ["stretch", p, "--rate", "0.5"],
                     ["features", p, "--kind", "f0v"]):
            assert main([*args, "-o", outs[dev], "--device", dev]) == 0
    notes = [json.load(open(os.path.join(outs[d], "notes_mel.json")))
             for d in ("cuda", "cpu")]
    assert notes[0] == notes[1]
    y = [open_audio_file(os.path.join(outs[d], "mel_x0.5.wav"))[0]
         for d in ("cuda", "cpu")]
    err = np.abs(y[0] - y[1]) / np.abs(y[1]).max()
    assert err.max() <= 0.05 + 2.0**-14
    f0v = [np.load(os.path.join(outs[d], "feats_f0v_mel.npy"))
           for d in ("cuda", "cpu")]
    np.testing.assert_array_equal(f0v[0][:, 1], f0v[1][:, 1])
