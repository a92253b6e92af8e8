"""The port's spectral editor (``msv_tpu_torch/ops/specedit.py``, on the
CPU) against ``msv_tpu/ops/specedit.py``.

Bounds: gain boxes within tests/test_specedit.py:88's atol 2e-5 (measured
2.4e-7 here).  Patch boxes synthesize phase as ``ph_l + steps * (nom +
dev)``, which multiplies f32 ``atan2`` differences by the span's length in
frames, so the patched cells are held by PATCH_ATOL, five times the
largest difference measured on this signal over four noise seeds
(4.4e-6 to 1.0e-5), and by the
semantic contract of tests/test_specedit.py: a patched click drops into
the surrounding tone.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

T = importlib.import_module("msv_tpu_torch.ops.specedit")
try:
    J = importlib.import_module("msv_tpu.ops.specedit")
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}
SR, WIN, HOP, NFFT = 16000, 512, 128, 512
GEO = {"win_length": WIN, "hop_length": HOP, "n_fft": NFFT}
ATOL = 2e-5
PATCH_ATOL = 5e-5


@pytest.fixture(autouse=True)
def _reference(request):
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _tone_noise(seconds=1.0, seed=4):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    return (0.3 * np.sin(2 * np.pi * 700 * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def _boxes(mod, spec):
    return [mod.Box(*b) for b in spec]


GAIN = [(0.2, 0.4, 400, 1200, -24.0, "gain"),
        (0.3, 0.9, 2000, 8000, -80.0, "gain")]
PATCH = [(0.6, 0.65, 0, 8000, -80.0, "patch")]


@pytest.mark.parametrize("seconds", [1.0, 0.61])
def test_gain_boxes_match_jax(seconds):
    x = _tone_noise(seconds)
    got = T.spectral_edit(x, SR, _boxes(T, GAIN), **GEO, **CPU)
    want = J.spectral_edit(x, SR, _boxes(J, GAIN), **GEO)
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def test_patch_boxes_match_jax():
    x = _tone_noise()
    got = np.array(T.spectral_edit(x, SR, _boxes(T, GAIN + PATCH), **GEO,
                                   **CPU))
    want = np.array(J.spectral_edit(x, SR, _boxes(J, GAIN + PATCH), **GEO))
    span = slice(int(0.6 * SR) - WIN, int(0.65 * SR) + WIN)
    np.testing.assert_allclose(got[span], want[span], atol=PATCH_ATOL,
                               rtol=0)
    got[span] = want[span] = 0.0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_patched_click_drops_into_the_tone():
    """tests/test_specedit.py's contract on its fixture: a click patched
    out of a steady tone leaves the output at least 20 dB closer to the
    clean tone over the click's span, and the plain round trip away from
    it."""
    t = np.arange(SR) / SR
    clean = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    x = clean.copy()
    x[SR // 2:SR // 2 + 32] += np.float32(0.8)
    out = T.spectral_edit(x, SR, [T.Box(0.47, 0.53, 0, 7999, mode="patch")],
                          **GEO, **CPU)
    w = slice(int(0.46 * SR), int(0.54 * SR))
    err_in = np.sqrt(np.mean((x[w] - clean[w]) ** 2))
    err_out = np.sqrt(np.mean((out[w] - clean[w]) ** 2))
    assert 20 * np.log10(err_out / err_in) < -20.0
    away = slice(int(0.1 * SR), int(0.3 * SR))
    assert np.abs(out[away] - clean[away]).max() < 1e-4


def test_masks_and_errors_match_jax():
    args = (_boxes(T, GAIN + PATCH), SR, 126, NFFT // 2 + 1, HOP, NFFT, 3, 2)
    jargs = (_boxes(J, GAIN + PATCH),) + args[1:]
    for g, w in zip(T._build_masks(*args), J._build_masks(*jargs)):
        np.testing.assert_array_equal(g, w)
    x = _tone_noise()
    for bad in ([], [{"t0": 0.0, "t1": 0.1, "f0": 9000, "f1": 9500}],
                [T.Box(0.0, 0.01, 0, 100, mode="patch")]):
        with pytest.raises(ValueError):
            T.spectral_edit(x, SR, bad, **GEO, **CPU)
    with pytest.raises(TypeError):
        T.spectral_edit(x, SR, [(0, 1, 2, 3)], **GEO, **CPU)
    with pytest.raises(ValueError):
        T.Box(0.5, 0.4, 0, 100)


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _tone_noise()
    got = T.spectral_edit(x, SR, _boxes(T, GAIN + PATCH), **GEO,
                          device="cuda")
    want = T.spectral_edit(x, SR, _boxes(T, GAIN + PATCH), **GEO, **CPU)
    np.testing.assert_allclose(got, want, atol=PATCH_ATOL, rtol=0)
