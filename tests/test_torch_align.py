"""The port's cross-track alignment (``msv_tpu_torch/ops/align.py``, on the
CPU) against ``msv_tpu/ops/align.py``.

Bounds: the offset within 1e-3 s of msv_tpu's and the confidence within
1e-4, the coarse estimate equal; tests/test_align.py's delays recovered
within 1e-3 s (:37).  msv_tpu compiles a large grouped convolution on the
CPU (about 15 s a shape), so its calls are made once per module and
shared.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch.ops import align as T  # noqa: E402

try:
    from msv_tpu.ops import align as J
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}
SR = 16000
DELAY = 1.2345


@pytest.fixture(autouse=True)
def _reference(request):
    """The JAX reference is absent where the card-only tests run."""
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _clip(seconds=10):
    """tests/test_align.py's aperiodic music-like signal (a copy: the card's
    machine runs the gpu test without the JAX package's tests)."""
    rng = np.random.default_rng(7)
    n = seconds * SR
    env = np.abs(np.convolve(rng.standard_normal(n), np.hanning(SR // 2),
                             "same"))
    env /= max(env.max(), 1e-9)
    x = (env * rng.standard_normal(n) * 0.3).astype(np.float32)
    for p in rng.integers(0, n - 64, 30):
        x[p:p + 64] += np.hanning(64).astype(np.float32)
    return x


def _delayed(x, seconds, sr=SR):
    d = int(seconds * sr)
    return np.concatenate([np.zeros(d, np.float32), x])[:len(x)]


@pytest.fixture(scope="module")
def pair():
    """(a, b, msv_tpu's result) of a 10 s clip against its delayed copy."""
    if J is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")
    x = _clip()
    b = _delayed(x, DELAY)
    return x, b, J.align_offset(x, SR, b, SR, max_lag_s=5.0)


def _same(got, want):
    assert isinstance(got, T.AlignResult)
    assert abs(got.offset_s - want.offset_s) <= 1e-3
    assert abs(got.confidence - want.confidence) <= 1e-4
    assert got.coarse_s == want.coarse_s


def test_known_delay_equals_jax(pair):
    x, b, want = pair
    got = T.align_offset(x, SR, b, SR, max_lag_s=5.0, **CPU)
    _same(got, want)
    assert abs(got.offset_s - DELAY) < 1e-3 and got.confidence > 0.6


def test_coarse_only_and_swapped_operands(pair):
    x, b, want = pair
    coarse = T.align_offset(x, SR, b, SR, max_lag_s=5.0, refine=False, **CPU)
    assert coarse.offset_s == coarse.coarse_s == want.coarse_s
    assert abs(coarse.confidence - want.confidence) <= 1e-4
    rev = T.align_offset(b, SR, x, SR, max_lag_s=5.0, **CPU)
    assert abs(rev.offset_s + DELAY) < 1e-3


def test_cross_rate_equals_jax():
    """The delayed copy at 8 kHz: both sides resample to 8 kHz first."""
    from msv_tpu_torch.ops.resample import resample

    x = _clip(6)
    b8 = resample(_delayed(x, 0.8), SR, 8000, **CPU).numpy()
    got = T.align_offset(x, SR, b8, 8000, max_lag_s=2.0, **CPU)
    _same(got, J.align_offset(x, SR, b8, 8000, max_lag_s=2.0))
    assert abs(got.offset_s - 0.8) < 1e-3


def test_validation():
    x = np.ones(100, np.float32)
    with pytest.raises(ValueError, match="empty"):
        T.align_offset(np.zeros(0, np.float32), SR, x, SR, **CPU)
    with pytest.raises(ValueError, match="max_lag_s"):
        T.align_offset(x, SR, x, SR, max_lag_s=0.0, **CPU)
    with pytest.raises(ValueError, match="work_sr"):
        T.align_offset(x, SR, x, SR, work_sr=100, **CPU)
    assert T._parabolic([1.0, 1.0, 1.0]) == 0.0


@pytest.mark.gpu
def test_align_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _clip()
    b = _delayed(x, DELAY)
    got = T.align_offset(x, SR, b, SR, max_lag_s=5.0)
    want = T.align_offset(x, SR, b, SR, max_lag_s=5.0, **CPU)
    _same(got, want)
    assert abs(got.offset_s - DELAY) < 1e-3
