"""The port's HPSS (``msv_tpu_torch/ops/hpss.py``, on the CPU) against
``msv_tpu/ops/hpss.py``.

Bounds: the running medians bit-equal (a median picks an input value; the
port takes it in blocks along the other axis, which changes no value);
the masks within tests/test_hpss.py's atol 1e-6; the separated signals
within 2e-5 (tests/test_specedit.py:88's round-trip bound; measured 4e-7
here).  The 128-frame bucket is part of the result: the zeroed pad rows
enter the time median at the tail, so without it the last frames differ
(``test_the_frame_bucket_reaches_the_tail``).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the modules (their packages bind the functions of the same name)
T = importlib.import_module("msv_tpu_torch.ops.hpss")
stft = importlib.import_module("msv_tpu_torch.ops.stft")
try:
    J = importlib.import_module("msv_tpu.ops.hpss")
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}
SR, WIN, HOP, NFFT = 16000, 640, 160, 1024
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _reference(request):
    """The JAX reference is absent where the card-only tests run."""
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _tone_and_clicks(seconds=1.0, seed=5):
    """tests/test_hpss.py's fixture over light noise: a 440 Hz tone and
    a click every 250 ms."""
    n = int(SR * seconds)
    t = np.arange(n) / SR
    x = 0.4 * np.sin(2 * np.pi * 440 * t)
    for c in range(SR // 8, n, SR // 4):
        x[c:c + 8] += np.float32([0.9, -0.9] * 4)
    x += 0.01 * np.random.default_rng(seed).standard_normal(n)
    return x.astype(np.float32)


@pytest.mark.parametrize("k,axis,block", [(5, 0, None), (9, 1, None),
                                          (1, 0, None), (31, 1, None),
                                          (31, 0, 4000), (9, 1, 500)])
def test_median_axis_equals_jax(k, axis, block, monkeypatch):
    x = np.random.default_rng(k + axis).standard_normal(
        (120, 70)).astype(np.float32)
    x[::11] = 0.0  # ties
    if block is not None:  # several blocks along the unfiltered axis
        monkeypatch.setattr(stft, "BLOCK_ELEMENTS", block)
    got = T._median_axis(torch.from_numpy(x), k, axis).numpy()
    np.testing.assert_array_equal(got, np.asarray(J._median_axis(x, k,
                                                                 axis)))


@pytest.mark.parametrize("power,margin", [(2.0, 1.0), (np.inf, 1.0),
                                          (1.0, (2.0, 1.5))])
def test_masks_match_jax(power, margin):
    mag = np.abs(np.random.default_rng(2).standard_normal(
        (64, 41))).astype(np.float32)
    mag[::7] = 0.0  # the split-zeros branch
    kw = {"kernel_time": 9, "kernel_freq": 5, "power": power,
          "margin": margin}
    got = T.hpss_masks(mag, **kw, **CPU)
    for g, w in zip(got, J.hpss_masks(mag, **kw)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("seconds", [1.0, 0.73])
def test_hpss_matches_jax(seconds):
    x = _tone_and_clicks(seconds)
    h, p = T.hpss(x, WIN, HOP, NFFT, **CPU)
    jh, jp = J.hpss(x, WIN, HOP, NFFT)
    assert h.dtype == p.dtype == np.float32 and h.shape == x.shape
    np.testing.assert_allclose(h, np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(p, np.asarray(jp), atol=ATOL, rtol=0)
    np.testing.assert_allclose(h + p, x, atol=1e-5, rtol=0)


def test_the_frame_bucket_reaches_the_tail(monkeypatch):
    """Without msv_tpu's 128-frame bucket the last frames' time median
    sees mirrored frames instead of the zeroed pad rows: the tail moves by
    far more than the bound, the head not at all."""
    x = _tone_and_clicks()
    jh = np.asarray(J.hpss(x, WIN, HOP, NFFT)[0])
    monkeypatch.setattr(T, "FRAME_BUCKET", 1)
    h = T.hpss(x, WIN, HOP, NFFT, **CPU)[0]
    tail = np.abs(h - jh)[-HOP * 10:].max()
    assert tail > 100 * ATOL, tail
    np.testing.assert_allclose(h[:SR // 2], jh[:SR // 2], atol=ATOL)


def test_errors_match_jax():
    x = _tone_and_clicks()
    for kw in ({"kernel_time": 4}, {"kernel_freq": 0}, {"margin": 0.5}):
        with pytest.raises(ValueError):
            J.hpss(x, WIN, HOP, NFFT, **kw)
        with pytest.raises(ValueError):
            T.hpss(x, WIN, HOP, NFFT, **kw, **CPU)
    with pytest.raises(ValueError, match="too short"):
        T.hpss(x[:100], WIN, HOP, NFFT, **CPU)
    with pytest.raises(ValueError, match="too small"):
        T.hpss(x[:2000], WIN, HOP, NFFT, kernel_time=31, **CPU)


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _tone_and_clicks()
    for got, want in zip(T.hpss(x, WIN, HOP, NFFT, device="cuda"),
                         T.hpss(x, WIN, HOP, NFFT, **CPU)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
