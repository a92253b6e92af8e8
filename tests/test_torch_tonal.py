"""The port's tonal analysis (``msv_tpu_torch/ops/tonal.py``, on the CPU)
against ``msv_tpu/ops/tonal.py`` and its numpy oracle.

Tolerances: tonnetz atol 1e-5 in parity (tests/test_tonal.py:31); fast
mode rounds the GEMM's operands to bf16 (msv_tpu's is f32 on its CPU), so
there the port is held to its own parity result within the bf16 bound of
a six-term dot product of unit vectors (|x| |b| 2^-8 summed, 1.5e-2).
Key estimates: the same tonic and mode, r within 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch.ops import tonal as T  # noqa: E402

try:
    from msv_tpu.ops import tonal as J
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}
SR = 16000


@pytest.fixture(autouse=True)
def _reference(request):
    """The JAX reference is absent where the card-only tests run."""
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _chord(notes_hz, sr=SR, dur=1.0, noise=0.0, seed=0):
    """Equal-amplitude sines plus optional white noise."""
    t = np.arange(int(sr * dur)) / sr
    x = sum(np.sin(2 * np.pi * f * t) for f in notes_hz) / len(notes_hz)
    if noise:
        x = x + noise * np.random.default_rng(seed).standard_normal(len(t))
    return (0.5 * x).astype(np.float32)


@pytest.mark.parametrize("shape", [(37, 12), (3, 11, 24)])
def test_tonnetz_from_chroma_matches_jax_and_the_oracle(rng, shape):
    ch = rng.random(shape).astype(np.float32)
    got = T.tonnetz_from_chroma(ch, precision="parity", **CPU).numpy()
    assert got.shape == shape[:-1] + (6,) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(J.tonnetz_from_chroma(
        ch, precision="parity")), atol=1e-5)
    np.testing.assert_allclose(got, T.oracle_tonnetz_np(ch), atol=1e-5)
    # fast: bf16 operands, within their bound of parity
    fast = T.tonnetz_from_chroma(ch, precision="fast", **CPU).numpy()
    assert np.abs(fast - got).max() <= 1.5e-2
    # the default follows the features' rule: fast unless set explicitly
    np.testing.assert_array_equal(
        T.tonnetz_from_chroma(torch.from_numpy(ch)).numpy(), fast)


def test_tonnetz_geometry_and_validation():
    t = T.tonnetz_from_chroma(np.eye(12, dtype=np.float32),
                              precision="parity", **CPU).numpy()
    np.testing.assert_allclose(np.hypot(t[:, 0], t[:, 1]), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.hypot(t[:, 4], t[:, 5]), 0.5, atol=1e-5)
    np.testing.assert_allclose(np.hypot(*(t[0, :2] - t[6, :2])), 2.0,
                               atol=1e-5)
    zero = T.tonnetz_from_chroma(np.zeros((3, 12), np.float32), **CPU)
    np.testing.assert_array_equal(zero.numpy(), 0.0)
    with pytest.raises(ValueError):
        T.tonnetz_from_chroma(np.ones(12, np.float32), **CPU)
    with pytest.raises(ValueError):
        T.tonnetz_from_chroma(np.ones((4, 12)), precision="bf16", **CPU)
    with pytest.raises(ValueError):
        T.tonnetz_basis(1)


def test_tonnetz_from_audio_matches_jax():
    x = _chord([261.63, 329.63, 392.0], noise=0.01)
    got = T.tonnetz(x, SR, precision="parity", **CPU).numpy()
    want = np.asarray(J.tonnetz(x, SR, precision="parity"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("shift", [0, 2, 7])
def test_estimate_key_matches_jax(shift):
    """tests/test_tonal.py:152's C4 E4 G4 C5 chord at 22.05 kHz, moved up
    ``shift`` semitones: its major key."""
    sr = 22050
    t = np.arange(int(1.5 * sr)) / sr
    x = sum(0.3 * np.sin(2 * np.pi * f * 2 ** (shift / 12) * t)
            for f in (261.63, 329.63, 392.0, 523.25)).astype(np.float32)
    got = T.estimate_key(x, sr, precision="parity", **CPU)
    want = J.estimate_key(x, sr, precision="parity")
    assert got[:2] == want[:2] == (T.KEY_NAMES[shift], "major")
    assert got[2] == pytest.approx(want[2], abs=1e-4)
    np.testing.assert_allclose(got[3], want[3], atol=1e-4)
    # the default (fast) precision names the same key
    assert T.estimate_key(x, sr, **CPU)[:2] == got[:2]


def test_estimate_key_from_chroma_edges():
    flat = T.estimate_key_from_chroma(np.ones((5, 12)))
    assert flat[:3] == (None, None, 0.0) and not flat[3].any()
    assert T.estimate_key_from_chroma(np.eye(12)[0])[0] == \
        J.estimate_key_from_chroma(np.eye(12)[0])[0]
    with pytest.raises(ValueError):
        T.estimate_key_from_chroma(np.ones(11))
    with pytest.raises(ValueError):
        T.estimate_key(np.ones((2, 100), np.float32), SR, **CPU)
    assert T.KEY_NAMES == J.KEY_NAMES


@pytest.mark.gpu
def test_tonal_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _chord([261.63, 329.63, 392.0], noise=0.01)
    got = T.tonnetz(x, SR, precision="parity")
    assert got.is_cuda
    np.testing.assert_allclose(
        got.cpu().numpy(),
        T.tonnetz(x, SR, precision="parity", **CPU).numpy(), atol=1e-5)
    k = T.estimate_key(x, SR, precision="parity")
    ck = T.estimate_key(x, SR, precision="parity", **CPU)
    assert k[:2] == ck[:2] and abs(k[2] - ck[2]) <= 1e-4
