"""The port's host code against the JAX package: copied modules pinned to
their originals' source, parameter derivation, and the import boundary
(``msv_tpu_torch`` never imports jax or msv_tpu)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference: absent where the card-only tests run
pytest.importorskip("jax")

from msv_tpu import config as jcfg  # noqa: E402
from msv_tpu.ops import decibel as jdb  # noqa: E402
from msv_tpu.ops.dft import n_pad_split as j_n_pad_split  # noqa: E402
from msv_tpu.ops.dft import windowed_dft_matrices as j_dft  # noqa: E402
from msv_tpu_torch import config as tcfg  # noqa: E402
from msv_tpu_torch.ops import decibel as tdb  # noqa: E402
from msv_tpu_torch.ops.dft import n_pad_split as t_n_pad_split  # noqa: E402
from msv_tpu_torch.ops.dft import windowed_dft_matrices as t_dft  # noqa: E402
from msv_tpu_torch.ops.windows import default_stft_window  # noqa: E402
from msv_tpu_torch.utils.rounding import rust_round, rust_round_np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "msv_tpu")
PORT_PKG = os.path.join(REPO, "msv_tpu_torch")

VERBATIM = [
    "utils/errors.py",
    "io/audio.py",
    "io/_vorbis.py",
    "io/_mp3.py",
    "ops/windows.py",
    "ops/mel.py",
    "ops/framing.py",
    "io/png.py",
    "io/flac_encode.py",
]

# Copies with named line edits: (original line, line in the copy).
EDITED = {
    "utils/rounding.py": [
        ("half-away-from-zero implementations for both host (numpy) and "
         "device (jnp).",
         "half-away-from-zero implementations for both host (numpy) and "
         "device (torch)."),
        ('    """Round half away from zero for jnp arrays (device)."""',
         '    """Round half away from zero for torch tensors (device)."""'),
        ("    import jax.numpy as jnp", "    import torch"),
        ("    return jnp.where(x >= 0, jnp.floor(x + 0.5), jnp.ceil(x - 0.5))",
         "    return torch.where(x >= 0, torch.floor(x + 0.5), "
         "torch.ceil(x - 0.5))"),
    ],
    "utils/profiling.py": [
        ("For deep profiles use ``jax.profiler.trace`` around a session call;"
         " these",
         "For deep profiles use ``torch.profiler.profile`` around a session "
         "call; these"),
    ],
}

# Objects copied into port modules that are not copies as a whole:
# (module under msv_tpu / msv_tpu_torch, name) -> named line edits of the
# object's source, (original line, line in the copy).
COPIED = {
    ("viewer", "_RenderCache"): [
        ("    (0.6-45 MB/s) relay, PNG encode — for bytes it produced seconds "
         "ago",
         "    PCIe, PNG encode — for bytes it produced seconds ago"),
    ],
    ("viewer", "_RWLock"): [
        ("    Render endpoints only READ session state (JAX dispatch is "
         "thread-safe;",
         "    Render endpoints only READ session state (torch launches are "
         "thread-safe;"),
    ],
    ("ops.resample", "_poly_filter"): [],
    ("ops.dft", "rdft_reference_np"): [],
    ("ops.dft", "end_padded_rdft_matrices"): [],
    ("ops.decibel", "a_weighting"): [],
    **{("ops.filter", name): [] for name in (
        "_buttap", "_lp2lp", "_lp2hp", "_lp2bp", "_lp2bs", "_bilinear",
        "_pair_conjugates", "_zpk2sos", "butter_sos", "_rbj_common",
        "peaking_eq", "_shelf", "low_shelf", "high_shelf", "notch",
        "sos_response", "_section_plan", "sosfilt_zi_step", "firwin")},
    ("ops.reconstruct", "_ola_constants"): [],
    ("ops.reconstruct", "_mel_pinv_cached"): [],
    ("ops.loudness", "k_weighting_coeffs"): [],
    ("ops.loudness", "_parabolic_peak"): [],
    ("ops.rhythm", "_bpm_prior"): [],
    ("ops.rhythm", "tempo_from_tempogram"): [],
    ("ops.rhythm", "oracle_tempogram_np"): [],
    # the tempogram of the tempo estimate runs on the caller's device
    ("ops.rhythm", "beat_track_from_envelope"): [
        ("                             start_bpm: float = 120.0):",
         "                             start_bpm: float = 120.0, "
         "device=None):"),
        ("            win_length=min(384, max(4, 2 * (n // 2))))",
         "            win_length=min(384, max(4, 2 * (n // 2))), "
         "device=device)"),
        ("        bpm = tempo_from_tempogram(np.asarray(tg), fps,",
         "        bpm = tempo_from_tempogram(tg.cpu().numpy(), fps,"),
    ],
    ("features", "_dct2_matrix"): [],
    ("features", "_contrast_bands"): [],
    ("features", "chroma_filterbank"): [],
    ("features", "_peak_pick"): [],
    # the pitch, sequence, LPC, tonal, segment, transcription, effects and
    # alignment modules' host code
    ("ops.sequence", "viterbi"): [
        ("def viterbi(prob, transition, p_init=None):",
         "def viterbi(prob, transition, p_init=None, *, device=None):"),
        ("    return viterbi_log(lo, la, li)",
         "    return viterbi_log(lo, la, li, device=device)"),
    ],
    ("ops.sequence", "_pairwise_cost"): [],
    ("ops.sequence", "smooth_f0_viterbi"): [
        ("                      voicing_slope: float = 2.0):",
         "                      voicing_slope: float = 2.0, device=None):"),
        ("    v_path, _ = viterbi_log(v_obs, v_trans)",
         "    v_path, _ = viterbi_log(v_obs, v_trans, device=device)"),
        ("    path, _ = viterbi_log(log_obs, log_tv)",
         "    path, _ = viterbi_log(log_obs, log_tv, device=device)"),
    ],
    ("ops.lpc", "_eval_grid_matrices"): [],
    ("ops.lpc", "_prep_signal"): [],
    **{("ops.tonal", name): [] for name in (
        "tonnetz_basis", "_pearson_rows", "estimate_key_from_chroma",
        "oracle_tonnetz_np")},
    ("ops.segment", "_checker_u"): [],
    ("ops.segment", "oracle_novelty_np"): [],
    # the pitch and onset analyses run on the caller's device
    ("ops.transcribe", "transcribe_notes"): [
        ("    level_drop_db: float = 40.0,",
         "    level_drop_db: float = 40.0, device=None,"),
        ("                              hop_length=hop_length)",
         "                              hop_length=hop_length, device=device)"),
        ("            onsets = np.asarray(onset_detect(wav, sr), np.float64)",
         "            onsets = np.asarray(onset_detect(wav, sr, "
         "device=device), float)"),
    ],
    ("ops.transcribe", "_frame_rms_db"): [],
    ("ops.transcribe", "_varlen"): [],
    ("ops.transcribe", "write_midi"): [],
    ("ops.effects", "_phase_tables"): [],
    ("ops.effects", "_stretch_plan"): [],
    ("ops.effects", "split"): [
        ("          frame_length: int = 2048, hop_length: int = 512):",
         "          frame_length: int = 2048, hop_length: int = 512, "
         "device=None):"),
        ("    rms = _frame_rms(wav, frame_length, hop_length)",
         "    rms = _frame_rms(wav, frame_length, hop_length, device)"),
    ],
    ("ops.effects", "trim"): [
        ("         frame_length: int = 2048, hop_length: int = 512):",
         "         frame_length: int = 2048, hop_length: int = 512, "
         "device=None):"),
        ("               hop_length=hop_length)",
         "               hop_length=hop_length, device=device)"),
    ],
    ("ops.align", "AlignResult"): [],
    ("ops.align", "_parabolic"): [],
    # the HPSS, spectral edit, NMF, de-click, CQT, multitaper and
    # reassignment modules' host code, and the analyze report
    ("ops.hpss", "_check_args"): [],
    ("ops.specedit", "Box"): [],
    ("ops.specedit", "_feather"): [],
    ("ops.specedit", "_build_masks"): [],
    ("ops.nmf", "kl_divergence"): [],
    # the LPC fit, the residual and the patch run on the caller's device
    ("ops.declick", "find_clicks"): [
        ("    contrast: float = 1.5,", "    contrast: float = 1.5, "
         "device=None,"),
        ("                      frame_length=frame_length, hop_length=hop)",
         "                      frame_length=frame_length, hop_length=hop, "
         "device=device)"),
        ("        a = np.asarray(a)",
         "        # a stays on the device, where a[fi] gathers the rows"),
        ("            jnp.asarray(padded), jnp.asarray(a_up), order=order, "
         "n=n))",
         "            padded, a_up, order=order, n=n, device=device))"),
    ],
    ("ops.declick", "_ar_coef"): [
        ("    host: ops/lpc.py::_levinson (batched JAX fori_loop for device "
         "frame",
         "    host: ops/lpc.py::_levinson (batched torch loop for device "
         "frame"),
    ],
    ("ops.declick", "_ar_fill"): [],
    ("ops.declick", "declick"): [
        ("    ar_ctx: int = 512,", "    ar_ctx: int = 512, device=None,"),
        ("                        **find_kw)",
         "                        device=device, **find_kw)"),
        ("        n_fft=repair_win, feather_ms=1000.0 * hop / sr, "
         "feather_hz=0.0)",
         "        n_fft=repair_win, feather_ms=1000.0 * hop / sr, "
         "feather_hz=0.0, device=device)"),
    ],
    ("ops.cqt", "_cqt_kernels"): [],
    ("ops.cqt", "cqt_frequencies"): [],
    ("ops.multitaper", "_dpss_bank"): [],
    ("ops.reassign", "_window_and_derivatives"): [],
    ("ops.reassign", "_reassign_bank"): [],
    ("ops.reassign", "reassigned_spec_db"): [
        ("    top_db: float | None = 80.0,",
         "    top_db: float | None = 80.0, device=None,"),
        ("        n_fft=n_fft)", "        n_fft=n_fft, device=device)"),
        ("    db = np.asarray(power_to_db(jnp.asarray(img)))",
         "    db = power_to_db(as_f32(img, target_device(wav, device)))"
         ".cpu().numpy()"),
    ],
    ("features", "analyze"): [
        ("def analyze(wav, sr: int) -> dict:",
         "def analyze(wav, sr: int, *, device=None) -> dict:"),
        ("    oracle-pinned op.  Shared by ``msv_tpu analyze`` and the "
         "viewer's",
         "    oracle-pinned op.  Shared by ``msv_tpu_torch analyze`` and the "
         "viewer's"),
        ("    r128 = r128_stats(wav, sr)",
         "    r128 = r128_stats(wav, sr, device=device)"),
        ("    bpm, beats = beat_track(wav, sr)",
         "    bpm, beats = beat_track(wav, sr, device=device)"),
        ("    tonic, mode, r, _ = estimate_key(wav, sr)",
         "    tonic, mode, r, _ = estimate_key(wav, sr, device=device)"),
        ("    bounds = segment(wav, sr) if dur >= 4.0 else np.empty(0)",
         "    bounds = segment(wav, sr, device=device) if dur >= 4.0 else "
         "np.empty(0)"),
        ("    onsets = onset_detect(wav, sr)",
         "    onsets = onset_detect(wav, sr, device=device)"),
        ("    f0, voiced = yin_smoothed(wav, sr, fmax=fmax)",
         "    f0, voiced = yin_smoothed(wav, sr, fmax=fmax, device=device)"),
        ("    spec = np.asarray(spectral_features(wav, sr))",
         "    spec = spectral_features(wav, sr, device=device).cpu().numpy()"),
        ("    _, (a, b) = trim(wav, sr)",
         "    _, (a, b) = trim(wav, sr, device=device)"),
        ("            np.asarray(wav, np.float32), sr))) if dur <= 600.0 "
         "else None),",
         "            np.asarray(wav, np.float32), sr, device=device))) if "
         "dur <= 600.0 else None),"),
    ],
}

# The native decoders: byte-for-byte copies, built by the port itself.
NATIVE = ["native/wav_decoder.cc", "native/flac_decoder.cc"]
FIXTURES = os.path.join(REPO, "tests", "fixtures")

RATES = [  # sr, win, hop, n_fft
    (8000, 320, 80, 512),
    (16000, 640, 160, 1024),
    (22050, 884, 221, 1024),
    (24000, 960, 240, 1024),
    (44100, 1764, 441, 2048),
    (48000, 1920, 480, 2048),
]


def _read(*parts):
    with open(os.path.join(*parts)) as f:
        return f.read()


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_equals_original(rel):
    assert _read(PORT_PKG, rel) == _read(JAX_PKG, rel)


@pytest.mark.parametrize("rel", sorted(EDITED))
def test_edited_copy_differs_only_by_named_lines(rel):
    orig = _read(JAX_PKG, rel).split("\n")
    copy = _read(PORT_PKG, rel).split("\n")
    assert len(orig) == len(copy)
    expect = list(orig)
    for old, new in EDITED[rel]:
        assert orig.count(old) == 1, old
        expect[orig.index(old)] = new
    assert copy == expect


@pytest.mark.parametrize("mod,name", sorted(COPIED))
def test_copied_object_differs_only_by_named_lines(mod, name):
    import importlib
    import inspect

    orig = inspect.getsource(getattr(
        importlib.import_module(f"msv_tpu.{mod}"), name)).split("\n")
    copy = inspect.getsource(getattr(
        importlib.import_module(f"msv_tpu_torch.{mod}"), name)).split("\n")
    assert len(orig) == len(copy)
    expect = list(orig)
    for old, new in COPIED[mod, name]:
        assert orig.count(old) == 1, old
        expect[orig.index(old)] = new
    assert copy == expect


@pytest.mark.parametrize("rel", NATIVE)
def test_native_decoder_source_equals_original(rel):
    with open(os.path.join(PORT_PKG, rel), "rb") as a, \
            open(os.path.join(JAX_PKG, rel), "rb") as b:
        assert a.read() == b.read()


def test_native_audio_copy_loads_the_committed_library():
    """The library is built from the port's committed sources into the
    port's build directory, never loaded from msv_tpu."""
    from msv_tpu_torch.io import _native_audio as na

    if shutil.which(os.environ.get("CXX") or "g++") is None:
        pytest.skip("no C++ compiler")
    assert na._load() is not None, na.BUILD_ERROR
    lib = os.path.realpath(na.LIBRARY)
    assert lib.startswith(os.path.realpath(na.BUILD_DIR) + os.sep)
    assert na.SOURCES == [os.path.join(PORT_PKG, r) for r in NATIVE]
    assert "msv_tpu" + os.sep + "native" not in lib


def test_no_port_file_loads_from_the_jax_package():
    """No string in a port source names a path into msv_tpu/ (its native
    library included) for the port to load."""
    hits = []
    for root, _dirs, files in os.walk(PORT_PKG):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                text = _read(root, name)
                if ("libmsv_native.so" in text
                        or '"msv_tpu", "native"' in text
                        or "msv_tpu/native/lib" in text):
                    hits.append(name)
    assert hits == []


@pytest.mark.parametrize("name", ["sine440_8k.flac", "duotone_8k_stereo.flac",
                                  "stereo_pcm16.wav", "mono_f32.wav"])
def test_native_decode_equals_jax(name, tmp_path):
    """The port's decode of a file equals msv_tpu's, through the native
    decoder (FLAC, and WAVs the numpy route does not take)."""
    from msv_tpu.io import audio as jaudio
    from msv_tpu_torch.io import _native_audio as na
    from msv_tpu_torch.io import audio as taudio

    path = os.path.join(FIXTURES, name)
    if name.endswith(".wav"):
        rng = np.random.default_rng(11)
        x = (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32)
        path = str(tmp_path / name)
        if name == "stereo_pcm16.wav":
            jaudio.write_wav(path, x, 16000, bits=16)
        else:
            jaudio.write_wav(path, x[0], 16000, bits=32)
    before = na.DECODES["native"]
    got = taudio.open_audio_file_ex(path)
    want = jaudio.open_audio_file_ex(path)
    if shutil.which(os.environ.get("CXX") or "g++") is not None:
        assert na.DECODES["native"] == before + 1
    assert got[1] == want[1] and got[2] is want[2] is None
    np.testing.assert_array_equal(got[0], want[0])
    mono = taudio.open_audio_mono_ex(path)  # FLAC: the integer route
    for g, w in zip(mono, jaudio.open_audio_mono_ex(path)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("sr,win,hop,n_fft", RATES)
def test_derive_stft_params_matches(sr, win, hop, n_fft):
    got = tcfg.derive_stft_params(sr, tcfg.SpecSetting())
    ref = jcfg.derive_stft_params(sr, jcfg.SpecSetting())
    assert (got.win_length, got.hop_length, got.n_fft) == (win, hop, n_fft)
    assert (got.win_length, got.hop_length, got.n_fft, got.n_freq) == (
        ref.win_length, ref.hop_length, ref.n_fft, ref.n_freq)


@pytest.mark.parametrize("sr,win,hop,n_fft", RATES[::2])
def test_dft_builders_equal(sr, win, hop, n_fft):
    window = default_stft_window(win, n_fft)
    assert t_n_pad_split(n_fft, win) == j_n_pad_split(n_fft, win)
    for a, b in zip(t_dft(window, n_fft), j_dft(window, n_fft)):
        np.testing.assert_array_equal(a, b)


def test_precision_mode_and_image_wire_globals():
    assert tcfg.get_precision_mode() == "parity"
    with tcfg.precision_mode_scope("fast"):
        assert tcfg.get_precision_mode() == "fast"
        assert tcfg.precision_mode_is_explicit()
    assert tcfg.get_precision_mode() == "parity"
    assert not tcfg.precision_mode_is_explicit()
    with pytest.raises(ValueError):
        tcfg.set_precision_mode("bf16")
    assert tcfg.get_image_wire() == "grey8"
    with pytest.raises(ValueError):
        tcfg.set_image_wire("png")


def test_rust_round_torch_matches_numpy():
    x = np.array([-2.5, -1.5, -0.5, 0.49999997, 0.5, 1.5, 2.5, 3.7],
                 dtype=np.float32)
    got = rust_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, rust_round_np(x))


@pytest.mark.parametrize("ref_value", [1.0, 0.5, "max"])
def test_amp_to_db_matches(ref_value, rng):
    x = np.abs(rng.standard_normal(4096)).astype(np.float32)
    x[:16] = 0.0  # the floor branch
    x[16] = np.float32(1e-18)  # strict >: exactly amin takes the floor
    got = tdb.amp_to_db(torch.from_numpy(x), ref_value).numpy()
    ref = np.asarray(jdb.amp_to_db(x, ref_value))
    assert got[16] == ref[16] == got[0]
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-6)


def test_import_pulls_in_neither_jax_nor_msv_tpu():
    code = (
        "import sys; import msv_tpu_torch, msv_tpu_torch.kernels, "
        "msv_tpu_torch.render, msv_tpu_torch.ops, msv_tpu_torch.io, "
        "msv_tpu_torch.cli, msv_tpu_torch.viewer, msv_tpu_torch.__main__, "
        "msv_tpu_torch.ops.resample, msv_tpu_torch.ops.scan, "
        "msv_tpu_torch.ops.filter, msv_tpu_torch.ops.loudness, "
        "msv_tpu_torch.ops.reconstruct, msv_tpu_torch.ops.rhythm, "
        "msv_tpu_torch.ops.pitch, msv_tpu_torch.ops.sequence, "
        "msv_tpu_torch.ops.lpc, msv_tpu_torch.ops.tonal, "
        "msv_tpu_torch.ops.segment, msv_tpu_torch.ops.transcribe, "
        "msv_tpu_torch.ops.effects, msv_tpu_torch.ops.align, "
        "msv_tpu_torch.ops.hpss, msv_tpu_torch.ops.specedit, "
        "msv_tpu_torch.ops.denoise, msv_tpu_torch.ops.nmf, "
        "msv_tpu_torch.ops.declick, msv_tpu_torch.ops.cqt, "
        "msv_tpu_torch.ops.multitaper, msv_tpu_torch.ops.reassign, "
        "msv_tpu_torch.utils.device; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'msv_tpu')]; print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_loader_and_mesh_import_neither_jax_nor_msv_tpu():
    code = (
        "import sys; import msv_tpu_torch.data, msv_tpu_torch.parallel, "
        "msv_tpu_torch.parallel.mesh, msv_tpu_torch.parallel.sharded, "
        "msv_tpu_torch.parallel.multihost, msv_tpu_torch.config; "
        "msv_tpu_torch.config.set_engine('xla'); "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'msv_tpu')]; print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_port_source_mentions_jax():
    hits = []
    for root, _dirs, files in os.walk(PORT_PKG):
        for name in files:
            if not name.endswith((".py", ".cu", ".cuh", ".h")):
                continue
            path = os.path.join(root, name)
            if "jax" in _read(path).lower():
                hits.append(os.path.relpath(path, REPO))
    assert hits == []


def test_png_and_flac_encoders_round_trip(tmp_path, rng):
    from msv_tpu.io import flac_encode as jflac
    from msv_tpu_torch.io import encode_png, flac_encode, write_png

    img = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    with open(path, "rb") as f:
        assert f.read() == encode_png(img)
    x = (rng.standard_normal((2, 3000)) * 0.2).astype(np.float32)
    a, b = str(tmp_path / "a.flac"), str(tmp_path / "b.flac")
    flac_encode.write_flac(a, x, 8000)
    jflac.write_flac(b, x, 8000)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_colormap_helpers_equal_jax(rng):
    from msv_tpu.render import colormap as jcm
    from msv_tpu_torch.render import colormap as tcm

    assert tcm.get_colormap() == jcm.get_colormap()
    import msv_tpu_torch
    assert msv_tpu_torch.get_colormap() == jcm.get_colormap()
    np.testing.assert_array_equal(tcm.colorbar(device="cpu"), jcm.colorbar())
    np.testing.assert_array_equal(tcm.colorbar(7, 33, device="cpu"),
                                  jcm.colorbar(7, 33))
    g = rng.uniform(0.0, 1.0, (4, 9, 11)).astype(np.float32)
    g[0, 0, :3] = [0.0, 0.9, 1.0]
    np.testing.assert_array_equal(
        tcm.grey_to_rgb_array(torch.from_numpy(g)).numpy(),
        np.asarray(jcm.grey_to_rgb_array(g)))


def _tf32():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def test_parity_torch_op_routes_run_with_tf32_off(monkeypatch, rng):
    """With the process's TF32 flags on, every parity torch-op route runs
    with both off and gives them back on."""
    from msv_tpu_torch import features
    from msv_tpu_torch.kernels import pipeline
    from msv_tpu_torch.kernels import spectrogram_cuda as K
    from msv_tpu_torch.ops import multires
    from msv_tpu_torch.parallel import streaming

    seen = {}

    def spy(mod, name, route):
        real = getattr(mod, name)

        def wrapped(*a, **kw):
            seen.setdefault(route, []).append(_tf32())
            return real(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    spy(pipeline, "dft_magnitude", "spec_pipeline")
    spy(pipeline, "blocked_matmul", "render")
    spy(streaming, "dft_magnitude", "streaming")
    spy(features, "frame_device", "features")
    spy(multires, "frame_device", "multires")
    spy(K, "_plain_mel", "plain kernel")
    saved = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        sr, win, hop, n_fft = 8000, 320, 80, 512
        c, s = (torch.from_numpy(m) for m in t_dft(
            default_stft_window(win, n_fft), n_fft))
        fb = torch.rand(n_fft // 2 + 1, 40)
        x = torch.from_numpy((rng.standard_normal(8000) * 0.3)
                             .astype(np.float32))
        pipeline.spec_pipeline(x, c, s, fb, 90, win=win, hop=hop,
                               n_frames=96, use_mel=True, mode="parity")
        # fast mode's linear GEMMs take TF32 (ROADMAP F2): not a parity
        # route any more
        pipeline.spec_pipeline(x, c, s, fb, 90, win=win, hop=hop,
                               n_frames=96, use_mel=True, mode="fast")
        assert seen["spec_pipeline"].pop() == (True, True)
        db = torch.rand(64, 40) * -100
        wv = torch.rand(30, 50)
        pipeline.render_rgb(db, 0.0, -100.0, wv, torch.rand(20, 64),
                            height=50, banded=False)
        pipeline.render_grey_q(db, 0.0, -100.0, wv, torch.rand(20, 64),
                               height=50, banded=False, bits=8)
        streaming.streaming_spec_db(
            (rng.standard_normal(40000) * 3000).astype(np.int16), win, hop,
            c, s, None)
        features.log_mel_spectrogram(x[None], sr, n_mel=32, log="power_db",
                                     precision="parity")
        multires.multires_mel_spec_db(x.numpy(), sr, n_mel=32, device="cpu")
        K.mel_spectrogram_cuda(x, c, s, fb, win=win, hop=hop, n_frames=90)
        assert sorted(seen) == ["features", "multires", "plain kernel",
                                "render", "spec_pipeline", "streaming"]
        for route, flags in seen.items():
            assert set(flags) == {(False, False)}, route
        assert _tf32() == (True, True)
        _new_routes_run_with_tf32_off(monkeypatch, x.numpy(), sr)
        assert _tf32() == (True, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _new_routes_run_with_tf32_off(monkeypatch, x, sr):
    """Every GEMM (``@``) and convolution of the filter, reconstruction,
    feature, rhythm, loudness, HPSS, denoise, spectral edit, NMF, CQT,
    multitaper and reassignment routes, in both precisions, runs with
    TF32 off: "fast" rounds operands to bf16, it never takes TF32."""
    from msv_tpu_torch import features as F
    from msv_tpu_torch.ops import filter as FL
    from msv_tpu_torch.ops import loudness, reconstruct, rhythm
    from msv_tpu_torch.ops.cqt import cqt
    from msv_tpu_torch.ops.denoise import denoise
    from msv_tpu_torch.ops.hpss import hpss
    from msv_tpu_torch.ops.mel import calc_mel_fb_default
    from msv_tpu_torch.ops.multitaper import multitaper_spectrogram
    from msv_tpu_torch.ops.nmf import separate
    from msv_tpu_torch.ops.reassign import reassigned_stft
    from msv_tpu_torch.ops.specedit import Box, spectral_edit

    flags = {}
    real_mm, real_conv = torch.Tensor.__matmul__, torch.nn.functional.conv1d

    def mm(a, b):
        flags.setdefault(route, set()).add(_tf32())
        return real_mm(a, b)

    def conv(*a, **kw):
        flags.setdefault(route, set()).add(_tf32())
        return real_conv(*a, **kw)

    monkeypatch.setattr(torch.Tensor, "__matmul__", mm)
    monkeypatch.setattr(torch.nn.functional, "conv1d", conv)
    cpu = {"device": "cpu"}
    mag = np.abs(np.random.default_rng(0).standard_normal((40, 257)))
    fb = calc_mel_fb_default(sr, 512)
    routes = {
        "griffin_lim": lambda: reconstruct.griffin_lim(
            mag.astype(np.float32), 320, 80, 512, n_iter=2, **cpu),
        "mel_to_linear": lambda: reconstruct.mel_to_linear(
            mag.astype(np.float32) @ fb, fb, **cpu),
        "fir_filter": lambda: FL.fir_filter(x, FL.firwin(31, 1000.0, sr=sr),
                                            **cpu),
        "true_peak": lambda: loudness.true_peak(x, sr, **cpu),
        "tempogram": lambda: rhythm.tempogram_from_envelope(
            np.abs(x[:500]), 100.0, **cpu),
        "delta": lambda: F.delta(np.ones((30, 4), np.float32), **cpu),
        "hpss": lambda: hpss(x[:4000], 320, 80, 512, **cpu),
        "denoise": lambda: denoise(x[:4000], 320, 80, 512, **cpu),
        "specedit": lambda: spectral_edit(
            x[:4000], sr, [Box(0.1, 0.2, 100, 900)], win_length=320,
            hop_length=80, n_fft=512, **cpu),
        "separate": lambda: separate(x[:4000], 320, 80, 512, n_iter=2,
                                     **cpu),
        "cqt": lambda: cqt(x, sr, fmin=220.0, n_bins=24, **cpu),
        "multitaper": lambda: multitaper_spectrogram(x, sr, **cpu),
        "reassign": lambda: reassigned_stft(x, sr, **cpu),
    }
    for prec in ("parity", "fast"):
        routes.update({
            f"whisper {prec}": lambda p=prec: F.whisper_log_mel(
                np.resize(x, 16000), precision=p, **cpu),
            f"mfcc {prec}": lambda p=prec: F.mfcc(x, sr, precision=p,
                                                  **cpu),
            f"spectral {prec}": lambda p=prec: F.spectral_features(
                x, sr, precision=p, **cpu),
            f"contrast {prec}": lambda p=prec: F.spectral_contrast(
                x, sr, n_bands=3, precision=p, **cpu),
            f"chroma {prec}": lambda p=prec: F.chroma_stft(
                x, sr, precision=p, **cpu),
            f"pcen {prec}": lambda p=prec: F.pcen(x, sr, precision=p,
                                                  **cpu),
        })
    for route, run in routes.items():
        run()
    assert sorted(flags) == sorted(routes)
    for route, seen in flags.items():
        assert seen == {(False, False)}, route


def test_precision_scope_nests_across_threads():
    """Two overlapping parity blocks in two threads: TF32 stays off until
    the last one leaves, then the caller's flags come back."""
    import threading

    saved = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        inside, go = threading.Event(), threading.Event()

        def other():
            with tcfg.precision_for("parity"):
                inside.set()
                go.wait(10)

        th = threading.Thread(target=other)
        th.start()
        assert inside.wait(10)
        with tcfg.precision_for("parity"):
            assert _tf32() == (False, False)
        assert _tf32() == (False, False)  # the other block is still in
        go.set()
        th.join(10)
        assert not th.is_alive()
        assert _tf32() == (True, saved[1])
        with tcfg.matmul_precision():  # the session mode: parity
            assert _tf32()[0] is False
        with tcfg.precision_for("fast"):
            assert _tf32()[0] is True
        with pytest.raises(ValueError):
            tcfg.precision_for("bf16")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_no_session_writes_the_process_tf32_flags():
    import msv_tpu_torch

    saved = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        msv_tpu_torch.MultiTrack(device="cpu")
        assert _tf32()[0] is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]


def test_db_wire_config(tmp_path, monkeypatch):
    import msv_tpu_torch
    from msv_tpu_torch.io.audio import write_wav

    assert tcfg.get_db_wire() == jcfg.get_db_wire() == "f32"
    tcfg.set_db_wire("f32")
    for packed in ("q16", "q12", "q10", "q8"):
        jcfg.set_db_wire(packed)  # msv_tpu takes them ...
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 1 item 12"):
            tcfg.set_db_wire(packed)  # ... the port names its item
    jcfg.set_db_wire("f32")
    for bad in ("f16", "q4", ""):
        with pytest.raises(ValueError):
            tcfg.set_db_wire(bad)
    with pytest.raises(ValueError):
        jcfg.set_db_wire("f16")
    assert tcfg.get_db_wire() == "f32"
    # get_spec_db's default wire is the config's
    path = str(tmp_path / "t.wav")
    write_wav(path, np.zeros((1, 4000), np.float32), 8000)
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks([0], [path])
    assert mt.get_spec_db(0).dtype == np.float32
    monkeypatch.setattr(tcfg, "_DB_WIRE", "q10")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mt.get_spec_db(0)
    assert mt.get_spec_db(0, wire="f32").shape[0] > 0


def test_nan_checks_and_device_trace(tmp_path, monkeypatch):
    from msv_tpu_torch.kernels import pipeline
    from msv_tpu_torch.kernels import spectrogram_cuda as K
    from msv_tpu_torch.utils import debug

    win, hop, n_fft = 320, 80, 512
    c, s = (torch.from_numpy(m) for m in t_dft(
        default_stft_window(win, n_fft), n_fft))
    fb = torch.rand(n_fft // 2 + 1, 40)
    x = torch.zeros(4000)
    # the dB epilogue maps a NaN sum to its floor, so a faulty launch is
    # what leaves a NaN in the plane: stand one in
    real = K.mel_spectrogram_plain

    def faulty(*a, **kw):
        out = real(*a, **kw)
        out[2, 3] = float("nan") if a[0].abs().sum() == 0 else out[2, 3]
        return out

    monkeypatch.setattr(K, "mel_spectrogram_plain", faulty)
    db = torch.rand(64, 40) * -100
    db[3, 4] = float("nan")
    wv, wh = torch.rand(30, 50), torch.rand(20, 64)
    K.mel_spectrogram_cuda(x, c, s, fb, win=win, hop=hop, n_frames=40)
    pipeline.render_rgb(db, 0.0, -100.0, wv, wh, height=50, banded=False)
    debug.enable_nan_checks(True)
    try:
        with pytest.raises(FloatingPointError, match="mel kernel"):
            K.mel_spectrogram_cuda(x, c, s, fb, win=win, hop=hop,
                                   n_frames=40)
        with pytest.raises(FloatingPointError, match="spectrogram render"):
            pipeline.render_rgb(db, 0.0, -100.0, wv, wh, height=50,
                                banded=False)
        K.mel_spectrogram_cuda(torch.ones(4000), c, s, fb, win=win,
                               hop=hop, n_frames=40)
    finally:
        debug.enable_nan_checks(False)
    with debug.device_trace(str(tmp_path / "trace")):
        K.mel_spectrogram_cuda(torch.zeros(4000), c, s, fb, win=win,
                               hop=hop, n_frames=40)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_analysis_constants_equal_jax():
    """The module constants copied with the analysis modules: key names,
    the Krumhansl-Kessler profiles, the SSM cap, the decoders' infinities,
    the alignment geometry, and the exported names of msv_tpu's package
    that the port now has."""
    import msv_tpu
    import msv_tpu_torch
    from msv_tpu.ops import align as ja, segment as jseg, sequence as jseq
    from msv_tpu.ops import tonal as jt
    from msv_tpu_torch.ops import align as ta, segment as tseg
    from msv_tpu_torch.ops import sequence as tseq, tonal as tt

    assert tt.KEY_NAMES == jt.KEY_NAMES
    for name in ("_KK_MAJOR", "_KK_MINOR"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
    assert tseg.MAX_SSM_FRAMES == jseg.MAX_SSM_FRAMES
    assert (tseq._NEG, tseq._BIG) == (jseq._NEG, jseq._BIG)
    for name in ("_ENV_FPS", "_BLOCK", "_REFINE_WIN", "_REFINE_NFFT",
                 "_REFINE_HOP", "_MAX_REFINE_FRAMES"):
        assert getattr(ta, name) == getattr(ja, name), name
    for name in ("align_offset", "dtw", "estimate_key", "pitch_shift",
                 "resample", "resample_poly", "resample_streamed", "segment",
                 "segment_boundaries", "self_similarity",
                 "smooth_f0_viterbi", "split", "time_stretch", "tonnetz",
                 "trim", "viterbi", "yin", "yin_smoothed"):
        assert name in msv_tpu_torch.__all__, name
        assert hasattr(msv_tpu, name), name


@pytest.mark.parametrize("pkg", ["", ".ops", ".io", ".render", ".parallel"])
def test_exports_are_msv_tpu_s(pkg):
    """The package's, ``ops``', ``io``'s, ``render``'s and ``parallel``'s
    ``__all__`` are msv_tpu's lists, and every name is bound."""
    import importlib

    port = importlib.import_module("msv_tpu_torch" + pkg)
    ref = importlib.import_module("msv_tpu" + pkg)
    assert sorted(port.__all__) == sorted(ref.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name


@pytest.mark.parametrize("n_frames,win,hop", [
    (1, 320, 80), (9, 320, 80), (10, 320, 80), (101, 640, 160),
    (333, 1920, 480), (77, 884, 221), (40, 100, 70), (1000, 1764, 441)])
def test_ola_norm_equals_the_scatter_normalizer(n_frames, win, hop):
    """``_ola_norm`` (head, one period, tail) equals ``_ola_constants``'
    ``np.add.at`` normalizer bit for bit."""
    from msv_tpu.ops.reconstruct import _ola_constants
    from msv_tpu_torch.ops.reconstruct import _ola_norm

    window = default_stft_window(win, 2048)
    want = _ola_constants(n_frames, win, hop, window)[1]
    got = _ola_norm(n_frames, win, hop, window)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
