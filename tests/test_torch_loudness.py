"""The port's loudness metering (``msv_tpu_torch/ops/loudness.py``, on the
CPU) against ``msv_tpu/ops/loudness.py`` and scipy's float64 lfilter.

Tolerances are tests/test_loudness.py's: the scanned K-weighting against
the f64 lfilter oracle at atol 1e-3 (:44), the chunked filter against the
one-scan answer at 2e-5 (:110), the true peak at 1e-4 dB (:192).  Against
msv_tpu: integrated loudness and LRA within 0.01 LU (measured: 6e-6 LU),
the short-term series within 1e-3 LU, the true peak within 1e-4 dB; the
R128 summary (rounded to 0.01 LU) equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from scipy.signal import lfilter  # noqa: E402

from msv_tpu_torch.ops import loudness as T  # noqa: E402

try:
    from msv_tpu.ops import loudness as J
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _reference(request):
    """The JAX reference is absent where the card-only tests run: there
    only the tests marked ``gpu`` (which compare card and CPU) run."""
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


@pytest.fixture()
def program(rng):
    """8 s of stereo at 16 kHz: a tone that steps in level over noise."""
    sr = 16000
    t = np.arange(8 * sr) / sr
    env = np.where(t < 4, 0.5, 0.05)
    x = np.stack([env * np.sin(2 * np.pi * 440 * t),
                  env * np.sin(2 * np.pi * 660 * t)])
    x += 0.02 * rng.standard_normal(x.shape)
    return x.astype(np.float32), sr


@pytest.mark.parametrize("sr", [16000, 48000])
def test_k_weighting_matches_lfilter_and_jax(sr, rng):
    for a, b in zip(T.k_weighting_coeffs(sr), J.k_weighting_coeffs(sr)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    x = rng.standard_normal(8000).astype(np.float32)
    got = T._k_weight(torch.from_numpy(x), sr).numpy()
    (sb, sa), (hb, ha) = T.k_weighting_coeffs(sr)
    want = lfilter(hb, ha, lfilter(sb, sa, x.astype(np.float64)))
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(J._k_weight(x, sr=sr)),
                               atol=1e-3)


def test_chunked_equals_whole(monkeypatch, program):
    x, sr = program
    whole = T._k_weight(torch.from_numpy(x[0]), sr).numpy()
    lufs = T.integrated_loudness(x, sr, **CPU)
    monkeypatch.setattr(T, "_CHUNK", 16384)
    parts = list(T._k_weight_chunked(torch.from_numpy(x[0]), sr))
    assert len(parts) == -(-x.shape[1] // 16384)
    np.testing.assert_allclose(torch.cat(parts).numpy(), whole, atol=2e-5)
    assert abs(T.integrated_loudness(x, sr, **CPU) - lufs) < 1e-6


def test_metering_matches_jax(program):
    x, sr = program
    got = T.integrated_loudness(x, sr, **CPU)
    assert abs(got - J.integrated_loudness(x, sr)) < 0.01
    assert abs(T.loudness_range(x, sr, **CPU)
               - J.loudness_range(x, sr)) < 0.01
    st = T.short_term_loudness(x, sr, **CPU)
    want = J.short_term_loudness(x, sr)
    assert st.shape == want.shape and st.dtype == np.float64
    np.testing.assert_allclose(st, want, rtol=0, atol=1e-3)
    assert abs(T.true_peak(x, sr, **CPU) - J.true_peak(x, sr)) < 1e-4
    assert T.r128_stats(x, sr, **CPU) == J.r128_stats(x, sr)
    # mono, and a tensor stays on its device
    assert abs(T.integrated_loudness(torch.from_numpy(x[0]), sr)
               - J.integrated_loudness(x[0], sr)) < 0.01


def test_true_peak_segments_equal_one_shot(monkeypatch, rng):
    sr = 16000
    t = np.arange(3 * sr) / sr
    x = (0.4 * np.sin(2 * np.pi * 1234.5 * t)
         + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    want = T.true_peak(x, sr, **CPU)
    assert abs(want - J.true_peak(x, sr)) < 1e-4
    monkeypatch.setattr(T, "_TP_SEG", 8192)
    assert abs(T.true_peak(x, sr, **CPU) - want) < 1e-4
    # at 192 kHz no oversampling: the parabolic fit of |x| itself
    y = x[:4000]
    assert abs(T.true_peak(y, 192000, **CPU) - J.true_peak(y, 192000)) < 1e-4


def test_silence_edges_and_validation(program):
    x, sr = program
    z = np.zeros((2, 4 * sr), np.float32)
    assert T.integrated_loudness(z, sr, **CPU) == float("-inf")
    assert T.true_peak(z, sr, **CPU) == float("-inf")
    assert T.loudness_range(z, sr, **CPU) == 0.0
    assert T.r128_stats(z, sr, **CPU) == J.r128_stats(z, sr) == {
        "lufs": None, "lra": 0.0, "dbtp": None}
    # five channels take the surround weights; six are refused
    five = np.concatenate([x, x, x[:1]])
    assert abs(T.integrated_loudness(five, sr, **CPU)
               - J.integrated_loudness(five, sr)) < 0.01
    for fn in (T.integrated_loudness, J.integrated_loudness):
        with pytest.raises(ValueError, match="channels"):
            fn(np.zeros((6, sr), np.float32), sr, **(
                CPU if fn is T.integrated_loudness else {}))
        with pytest.raises(ValueError, match="400 ms"):
            fn(x[:, :100], sr, **(CPU if fn is T.integrated_loudness
                                  else {}))
    with pytest.raises(ValueError, match="32 samples"):
        T.true_peak(x[:, :10], sr, **CPU)


def test_numpy_input_defaults_to_the_card(program):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        T.integrated_loudness(program[0], program[1])


@pytest.mark.gpu
def test_metering_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(8)
    sr = 48000
    x = (0.2 * rng.standard_normal((2, 10 * sr))).astype(np.float32)
    for fn, tol in ((T.integrated_loudness, 0.01), (T.loudness_range, 0.01),
                    (T.true_peak, 1e-4)):
        assert abs(fn(x, sr) - fn(x, sr, **CPU)) < tol, fn.__name__
