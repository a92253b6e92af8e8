"""The port's rational resampler (``msv_tpu_torch/ops/resample.py``) against
msv_tpu's (``msv_tpu/ops/resample.py``) and the scipy oracle, on the CPU.

Mirrors tests/test_resample.py: one-shot within its atol 2e-5 (relative to
the signal's peak where that exceeds 1) at every rational ratio the
bundled rates need, leading dims and batches, the validation errors,
``resample_streamed`` within 3e-6 of the one-shot (and of msv_tpu's
streamed form, whose segment plan it shares).  The polyphase form never
builds the zero-stuffed signal: a 44.1 -> 16 kHz conversion (``up`` 160)
runs in a fresh process whose peak memory grows by a few times the input,
not by the 160-fold stuffed size.  Inputs are made with numpy from seeds.
The card test runs where the card is (``-m gpu``; no JAX there).
"""

import importlib
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from scipy.signal import resample_poly as scipy_resample_poly  # noqa: E402

from msv_tpu_torch.ops.resample import (resample, resample_poly,  # noqa: E402
                                        resample_streamed)

RATES = [8000, 16000, 22050, 24000, 44100, 48000]
RATIOS = [(1, 3), (1, 2), (2, 1), (3, 2), (2, 3), (160, 441), (441, 160),
          (147, 160), (80, 441)]
STREAM_PAIRS = [(48000, 16000), (44100, 16000), (22050, 48000),
                (8000, 44100), (44100, 44100)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jrs():
    """msv_tpu's resample module (absent on the card's machine)."""
    pytest.importorskip("jax")
    return importlib.import_module("msv_tpu.ops.resample")


def _sig(n, rng, sr=48000):
    t = np.arange(n) / sr
    return (
        0.5 * np.sin(2 * np.pi * 440 * t)
        + 0.2 * np.sin(2 * np.pi * 3330 * t + 0.7)
        + 0.05 * rng.standard_normal(n)
    ).astype(np.float32)


def _close(got, want, atol=2e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    scale = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(got, want, atol=atol * max(scale, 1.0),
                               rtol=0)


@pytest.mark.parametrize("up,down", RATIOS)
def test_matches_jax_and_scipy(up, down, jrs, rng):
    x = _sig(4801, rng)
    got = resample_poly(x, up, down, device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    _close(got, jrs.resample_poly(x, up, down))
    _close(got, scipy_resample_poly(x.astype(np.float64), up, down))


@pytest.mark.parametrize("sr", RATES)
def test_every_bundled_rate_to_16k(sr, jrs, rng):
    """Every sr -> 16 kHz conversion the feature frontend needs."""
    x = _sig(sr // 2, rng, sr)  # half a second
    got = resample(x, sr, 16000, device="cpu")
    assert got.shape == (8000,)
    _close(got, jrs.resample(x, sr, 16000))
    g = math.gcd(sr, 16000)
    _close(got, scipy_resample_poly(x.astype(np.float64), 16000 // g,
                                    sr // g))


@pytest.mark.parametrize("n", [2, 3, 5, 17, 160, 441])
@pytest.mark.parametrize("up,down", [(160, 441), (441, 160), (1, 3), (3, 1)])
def test_short_inputs(n, up, down, jrs, rng):
    """Inputs shorter than one phase's taps: the zero extension on both
    sides is msv_tpu's and scipy's."""
    x = rng.standard_normal(n).astype(np.float32)
    got = resample_poly(x, up, down, device="cpu")
    _close(got, jrs.resample_poly(x, up, down))
    _close(got, scipy_resample_poly(x.astype(np.float64), up, down))


def test_identity_and_tensor_input(rng):
    x = _sig(1000, rng, 16000)
    np.testing.assert_array_equal(
        resample(x, 16000, 16000, device="cpu").numpy(), x)
    t = torch.from_numpy(x)
    out = resample(t, 48000, 16000)  # a tensor stays on its device
    assert out.device == t.device and out.dtype == torch.float32
    np.testing.assert_array_equal(
        out.numpy(), resample(x, 48000, 16000, device="cpu").numpy())


def test_numpy_input_defaults_to_the_card(rng):
    """Numpy input goes to the card unless the caller asks for the CPU: it
    never computes on the CPU silently."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default route runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        resample(_sig(1000, rng), 48000, 16000)


def test_tone_survives_downsample():
    """440 Hz at 48 k stays 440 Hz (and full amplitude) at 16 k; content
    above the new Nyquist is attenuated to the stopband."""
    sr = 48000
    t = np.arange(2 * sr) / sr
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.3 * np.sin(2 * np.pi * 11000 * t)).astype(np.float32)
    y = resample(x, sr, 16000, device="cpu").numpy()
    f = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    assert abs(f.argmax() * 16000 / len(y) - 440.0) < 1.0
    alias_bin = int(round(5000 * len(y) / 16000))
    tone_bin = int(round(440 * len(y) / 16000))
    assert f[alias_bin - 2:alias_bin + 3].max() < 1e-3 * f[tone_bin]
    assert abs(float(np.abs(y).max()) - 0.5) < 0.01


def test_batched_and_leading_dims(jrs, rng):
    x = rng.standard_normal((3, 2, 1000)).astype(np.float32)
    got = resample_poly(x, 2, 3, device="cpu")
    assert got.shape == (3, 2, 667)
    _close(got, jrs.resample_poly(x, 2, 3))
    for i in range(3):
        for j in range(2):
            np.testing.assert_array_equal(
                got[i, j].numpy(),
                resample_poly(x[i, j], 2, 3, device="cpu").numpy())


def test_validation():
    with pytest.raises(ValueError, match="positive"):
        resample_poly(np.zeros(10, np.float32), 0, 1, device="cpu")
    with pytest.raises(ValueError, match="at least 2"):
        resample_poly(np.zeros(1, np.float32), 2, 1, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        resample(np.zeros(10, np.float32), 48000, 0, device="cpu")
    with pytest.raises(ValueError, match="seg_s"):
        resample_streamed(np.zeros(10, np.float32), 48000, 16000, seg_s=0.0,
                          device="cpu")
    with pytest.raises(ValueError, match="positive"):
        resample_streamed(np.zeros(10, np.float32), 48000, -1, device="cpu")
    with pytest.raises(ValueError, match="at least 2"):
        resample_streamed(np.zeros(1, np.float32), 48000, 16000,
                          device="cpu")


@pytest.mark.parametrize("si,so", STREAM_PAIRS)
def test_streamed_matches_oneshot(si, so, jrs, rng):
    """resample_streamed == resample within a few f32 ulp (3e-6), and
    msv_tpu's streamed form on the same segment plan within 2e-5."""
    for n in (481, 3001, 96017):
        x = rng.standard_normal(n).astype(np.float32)
        a = resample(x, si, so, device="cpu").numpy()
        b = resample_streamed(x, si, so, seg_s=0.25, device="cpu")
        assert a.shape == b.shape and b.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=3e-6, rtol=0)
        _close(b, jrs.resample_streamed(x, si, so, seg_s=0.25))


def test_streamed_multichannel_and_short(rng):
    x = rng.standard_normal((3, 100000)).astype(np.float32)
    a = resample(x, 44100, 16000, device="cpu").numpy()
    b = resample_streamed(x, 44100, 16000, seg_s=0.5, device="cpu")
    assert b.shape == a.shape == (3, 36282) and b.dtype == np.float32
    np.testing.assert_allclose(a, b, atol=3e-6, rtol=0)
    # shorter than one segment: the one-shot route, host f32 out
    y = rng.standard_normal(500).astype(np.float32)
    out = resample_streamed(y, 48000, 16000, device="cpu")
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(
        resample(y, 48000, 16000, device="cpu").numpy(), out)


_PEAK_SCRIPT = """
import resource, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from msv_tpu_torch.ops.resample import resample
n = int(sys.argv[2])
x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
resample(x[:50000], 44100, 16000, device="cpu")  # warm: libraries loaded
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
y = resample(x, 44100, 16000, device="cpu")
after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(y.shape[0], (after - before) * 1024)
"""


def test_polyphase_peak_memory_is_of_the_input_s_order(tmp_path):
    """44.1 -> 16 kHz (up 160): 4 M samples (16 MB) stuffed would be 2.6
    GB; the polyphase form's peak grows by the input copy, the output and
    the convolution's own buffers, under eight times the input."""
    n = 4_000_000
    r = subprocess.run([sys.executable, "-c", _PEAK_SCRIPT, REPO, str(n)],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    n_out, grew = (int(v) for v in r.stdout.split())
    assert n_out == -(-n * 160 // 441)
    assert grew < 8 * 4 * n, f"peak grew by {grew / 2**20:.1f} MiB"


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    x = _sig(10 * 44100, rng, 44100)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # the route turns it off
    try:
        for si, so in [(44100, 16000), (16000, 44100), (48000, 16000)]:
            got = resample(x, si, so)
            assert got.device.type == "cuda"
            _close(got.cpu(), resample(x, si, so, device="cpu").numpy())
        st = resample_streamed(x, 44100, 16000, seg_s=2.0)
        _close(st, resample(x, 44100, 16000, device="cpu").numpy(),
               atol=3e-6)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
