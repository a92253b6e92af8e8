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
        "msv_tpu_torch.render, msv_tpu_torch.ops, msv_tpu_torch.io; "
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
