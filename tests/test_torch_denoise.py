"""The port's denoiser (``msv_tpu_torch/ops/denoise.py``, on the CPU)
against ``msv_tpu/ops/denoise.py``.

Bound: tests/test_denoise.py's atol 2e-4 (measured 4e-7 here).  The
percentile's row is msv_tpu's f32 index ``floor(f32(q) / 100 * (n - 1))``:
at q = 70 and 91 frames it is row 63 where an f64 index gives 62, and
``test_percentile_row_is_the_f32_index`` holds the port to row 63.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

T = importlib.import_module("msv_tpu_torch.ops.denoise")
stft = importlib.import_module("msv_tpu_torch.ops.stft")
try:
    J = importlib.import_module("msv_tpu.ops.denoise")
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}
SR, WIN, HOP, NFFT = 16000, 640, 160, 1024
ATOL = 2e-4


@pytest.fixture(autouse=True)
def _reference(request):
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _tone_noise(n=SR, seed=6):
    """A tone entering after 0.3 s over white noise (tests/test_denoise.py
    's shape)."""
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 440 * t) * (t > 0.3)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n,kw", [
    (SR, {}),
    (SR, {"sr": SR, "noise_span": (0.0, 0.25)}),
    (13_777, {"smooth_time": 1}),
    (13_777, {"percentile": 50.0, "smooth_time": 7, "oversub": 2.0,
              "reduction_db": 12.0}),
    (14_400, {"percentile": 70.0}),  # 91 frames: the f32 index's case
])
def test_matches_jax(n, kw):
    x = _tone_noise(n)
    got = T.denoise(x, WIN, HOP, NFFT, **kw, **CPU)
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_allclose(got, np.asarray(J.denoise(x, WIN, HOP, NFFT,
                                                         **kw)),
                               atol=ATOL, rtol=0)


def test_percentile_row_is_the_f32_index():
    power = torch.from_numpy(np.random.default_rng(1).random(
        (128, 9)).astype(np.float32))
    got = T._noise_psd(power, 91, 0, 0, "pct", 70.0).numpy()
    srt = np.sort(power[:91].numpy(), axis=0)
    scale = np.float32(1.0 / -np.log1p(-0.7))
    np.testing.assert_array_equal(got, srt[63] * scale)
    assert not np.array_equal(got, srt[62] * scale)


def test_blocks_change_no_value(monkeypatch):
    power = torch.from_numpy(np.random.default_rng(2).random(
        (300, 40)).astype(np.float32))
    whole = T._percentile_row(power, 57)
    monkeypatch.setattr(stft, "BLOCK_ELEMENTS", 1000)
    np.testing.assert_array_equal(T._percentile_row(power, 57).numpy(),
                                  whole.numpy())


def test_wiener_gain_and_errors_match_jax():
    p = np.float32([[1.0, 4.0, 0.5, 1e-40]])
    n = np.float32([1.2, 2.0, 1.0, 3.0])
    got = T.wiener_gain(torch.from_numpy(p), torch.from_numpy(n),
                        oversub=1.5, floor=0.1).numpy()
    np.testing.assert_allclose(got, np.asarray(J.wiener_gain(
        p, n, oversub=1.5, floor=0.1)), atol=1e-7)
    x = _tone_noise()
    for kw in ({"smooth_time": 4}, {"percentile": 0.0}, {"oversub": 0.0},
               {"reduction_db": -1.0}, {"noise_span": (0.0, 0.01), "sr": SR},
               {"noise_span": (0.0, 0.5)}):
        with pytest.raises(ValueError):
            T.denoise(x, WIN, HOP, NFFT, **kw, **CPU)


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _tone_noise()
    np.testing.assert_allclose(T.denoise(x, WIN, HOP, NFFT, device="cuda"),
                               T.denoise(x, WIN, HOP, NFFT, **CPU),
                               atol=ATOL, rtol=0)
