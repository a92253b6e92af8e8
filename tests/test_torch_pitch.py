"""The port's YIN (``msv_tpu_torch/ops/pitch.py``, on the CPU) against
``msv_tpu/ops/pitch.py`` and tests/test_pitch.py's oracle.

Tolerances are tests/test_pitch.py's (:72-73): f0 rtol 5e-3, aperiodicity
rtol 5e-2 and atol 5e-4, on msv_tpu's own signals (a tone-plus-noise
mixture, pure tones, vibrato, noise, silence), where every frame's trough
clears the threshold by a clear margin.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch.ops.pitch import yin  # noqa: E402

try:
    from msv_tpu.ops.pitch import yin as jyin
    from test_pitch import _yin_oracle
except ImportError:  # no jax
    jyin = None

CPU = {"device": "cpu"}
F0_RTOL, AP_RTOL, AP_ATOL = 5e-3, 5e-2, 5e-4


@pytest.fixture(autouse=True)
def _reference(request):
    """The JAX reference is absent where the card-only tests run."""
    if jyin is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _mixture(rng, sr=8000, n=2400):
    t = np.arange(n) / sr
    return (0.5 * np.sin(2 * np.pi * 220 * t)
            + 0.2 * np.sin(2 * np.pi * 660 * t + 1.0)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _both(x, sr, **kw):
    f0, ap = yin(x, sr, with_aperiodicity=True, **kw, **CPU)
    jf0, jap = (np.asarray(v) for v in jyin(x, sr, with_aperiodicity=True,
                                            **kw))
    assert f0.dtype == ap.dtype == torch.float32
    assert f0.shape == jf0.shape and ap.shape == jap.shape
    return f0.numpy(), ap.numpy(), jf0, jap


def test_matches_jax_and_the_oracle(rng):
    x = _mixture(rng)
    kw = dict(fmin=80.0, fmax=1000.0, frame_length=512, win_length=256,
              hop_length=128, trough_threshold=0.1)
    f0, ap, jf0, jap = _both(x, 8000, **kw)
    np.testing.assert_allclose(f0, jf0, rtol=F0_RTOL)
    np.testing.assert_allclose(ap, jap, rtol=AP_RTOL, atol=AP_ATOL)
    of0, oap = _yin_oracle(x.astype(np.float64), 8000, 80.0, 1000.0, 512,
                           256, 128, 0.1)
    np.testing.assert_allclose(f0, of0, rtol=F0_RTOL)
    np.testing.assert_allclose(ap, oap, rtol=AP_RTOL, atol=AP_ATOL)


@pytest.mark.parametrize("hz", [110.0, 440.0, 1760.0])
def test_pure_tones_match_jax(hz):
    sr = 16000
    t = np.arange(sr // 2) / sr
    x = (0.5 * np.sin(2 * np.pi * hz * t)).astype(np.float32)
    f0, ap, jf0, jap = _both(x, sr)
    np.testing.assert_allclose(f0, jf0, rtol=F0_RTOL)
    np.testing.assert_allclose(ap, jap, rtol=AP_RTOL, atol=AP_ATOL)
    mid = slice(4, -4)
    assert np.median(np.abs(f0[mid] - hz) / hz) < 0.01
    assert np.median(ap[mid]) < 0.02


def test_vibrato_noise_and_silence(rng):
    sr = 16000
    t = np.arange(sr) / sr
    inst = 300.0 + 30.0 * np.sin(2 * np.pi * 3.0 * t)
    vib = (0.5 * np.sin(2 * np.pi * np.cumsum(inst) / sr)).astype(np.float32)
    f0, ap, jf0, jap = _both(vib, sr, fmin=150, fmax=800, frame_length=1024)
    np.testing.assert_allclose(f0, jf0, rtol=F0_RTOL)
    np.testing.assert_allclose(ap, jap, rtol=AP_RTOL, atol=AP_ATOL)
    noise = (0.3 * rng.standard_normal(sr // 2)).astype(np.float32)
    _, apn = yin(noise, sr, with_aperiodicity=True, **CPU)
    assert float(apn.median()) > 0.5  # clearly unvoiced
    # digital silence: fully aperiodic, as msv_tpu
    quiet = np.zeros(4000, np.float32)
    quiet[2000:] = (0.5 * np.sin(2 * np.pi * 220 * np.arange(2000) / sr))
    f0, ap, jf0, jap = _both(quiet, sr)
    np.testing.assert_array_equal(ap[:2], np.ones(2, np.float32))
    np.testing.assert_array_equal(ap == 1.0, jap == 1.0)


def test_tensor_input_and_validation():
    x = np.zeros(4000, np.float32)
    f0 = yin(torch.from_numpy(x + 0.1), 16000)  # a tensor stays on its device
    assert f0.device.type == "cpu" and f0.shape == (8,)
    for kw, msg in (({"fmin": 500, "fmax": 100}, "fmin"),
                    ({"win_length": 4096}, "win_length"),
                    ({"fmin": 2000, "fmax": 2093}, "too narrow"),
                    ({"hop_length": 0}, "hop_length")):
        with pytest.raises(ValueError, match=msg):
            yin(x, 16000, **kw, **CPU)
    with pytest.raises(ValueError, match="Nyquist"):
        yin(x, 8000, fmax=5000, **CPU)
    with pytest.raises(ValueError, match="1-D"):
        yin(np.zeros((2, 100), np.float32), 16000, **CPU)
    with pytest.raises(ValueError, match="empty"):
        yin(np.zeros(0, np.float32), 16000, **CPU)


@pytest.mark.gpu
def test_yin_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    x = _mixture(rng, 16000, 32000)
    got = yin(x, 16000, with_aperiodicity=True)
    want = yin(x, 16000, with_aperiodicity=True, **CPU)
    assert got[0].is_cuda
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=F0_RTOL)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(),
                               rtol=AP_RTOL, atol=AP_ATOL)
