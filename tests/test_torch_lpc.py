"""The port's LPC (``msv_tpu_torch/ops/lpc.py``, on the CPU) against
``msv_tpu/ops/lpc.py``, scipy's Toeplitz solver and tests/test_lpc.py's
Levinson oracle.

Tolerances are tests/test_lpc.py's: coefficients atol 2e-3 and the error
power rtol 2e-3 (:62-65), the envelope atol 1e-3 dB (:129); formants
within one grid step of msv_tpu's, with NaN in the same places.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
scipy_linalg = pytest.importorskip("scipy.linalg")
scipy_signal = pytest.importorskip("scipy.signal")

from msv_tpu_torch.ops import lpc as T  # noqa: E402

try:
    from msv_tpu.ops import lpc as J
    from test_lpc import _ar_rows, _levinson_oracle
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _reference(request):
    """The JAX reference is absent where the card-only tests run."""
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _ar(rng, coeffs, n):
    x = scipy_signal.lfilter([1.0], coeffs, rng.standard_normal(n))
    return (x / np.abs(x).max()).astype(np.float32)


def _vowel(sr=16000, f_true=(700.0, 1800.0), bw=(80.0, 120.0)):
    src = np.zeros(sr)
    src[:: sr // 120] = 1.0  # 120 Hz glottal pulse train
    y = src
    for f0, b in zip(f_true, bw):
        r = math.exp(-math.pi * b / sr)
        th = 2 * math.pi * f0 / sr
        y = scipy_signal.lfilter([1.0], [1.0, -2 * r * math.cos(th), r * r],
                                 y)
    return (y / np.abs(y).max()).astype(np.float32)


def test_levinson_matches_scipy_the_oracle_and_jax(rng):
    order = 12
    r = _ar_rows(rng, 24, order)
    a, g2 = T._levinson(torch.from_numpy(r), order)
    a, g2 = a.numpy().astype(np.float64), g2.numpy().astype(np.float64)
    ja, jg2 = (np.asarray(v, np.float64) for v in J._levinson(r, order))
    np.testing.assert_allclose(a, ja, rtol=0, atol=2e-3)
    np.testing.assert_allclose(g2, jg2, rtol=2e-3)
    for i in range(r.shape[0]):
        rn = r[i].astype(np.float64) / r[i, 0]
        rn[0] = 1.0 + 1e-6
        sol = scipy_linalg.solve_toeplitz((rn[:-1], rn[:-1]), -rn[1:])
        np.testing.assert_allclose(a[i, 1:], sol, rtol=0, atol=2e-3)
        oa, oe = _levinson_oracle(r[i], order)
        np.testing.assert_allclose(a[i], oa, rtol=0, atol=2e-3)
        np.testing.assert_allclose(g2[i], oe * r[i, 0], rtol=2e-3)
    # digital silence: a = [1, 0, ...] and g2 ~ 0 (the clamped r0), as
    # msv_tpu's
    z = np.zeros((2, order + 1), np.float32)
    a0, g0 = T._levinson(torch.from_numpy(z), order)
    ja0, jg0 = J._levinson(z, order)
    np.testing.assert_array_equal(a0.numpy(), np.asarray(ja0))
    np.testing.assert_array_equal(a0.numpy()[:, 0], 1.0)
    np.testing.assert_array_equal(g0.numpy(), np.asarray(jg0))
    assert g0.max() < 1e-29


@pytest.mark.parametrize("preemphasis", [0.0, 0.97])
def test_lpc_matches_jax(rng, preemphasis):
    x = _ar(rng, [1.0, -1.2, 0.8, -0.3, 0.1], 1 << 13)
    a, g2, hop = T.lpc(x, order=4, frame_length=1024,
                       preemphasis=preemphasis, **CPU)
    ja, jg2, jhop = J.lpc(x, order=4, frame_length=1024,
                          preemphasis=preemphasis)
    assert hop == jhop and a.shape == np.asarray(ja).shape
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=2e-3)
    np.testing.assert_allclose(g2.numpy(), np.asarray(jg2), rtol=2e-3)
    if not preemphasis:
        med = np.median(a.numpy()[4:-4], axis=0)
        np.testing.assert_allclose(med, [1.0, -1.2, 0.8, -0.3, 0.1],
                                   atol=0.05)
    # a tensor input takes the same route on its device
    ta, _, _ = T.lpc(torch.from_numpy(x), order=4, frame_length=1024,
                     preemphasis=preemphasis)
    np.testing.assert_array_equal(ta.numpy(), a.numpy())


def test_envelope_matches_jax_and_polyval(rng):
    x = _ar(rng, [1.0, -0.5, 0.6], 1 << 14)
    env, hop = T.lpc_envelope_db(x, 16000, order=2, frame_length=2048,
                                 n_grid=257, **CPU)
    jenv, jhop = J.lpc_envelope_db(x, 16000, order=2, frame_length=2048,
                                   n_grid=257)
    assert hop == jhop
    np.testing.assert_allclose(env.numpy(), np.asarray(jenv), atol=1e-3)
    a, g2, _ = T.lpc(x, order=2, frame_length=2048, **CPU)
    a, g2 = a.numpy().astype(np.float64), g2.numpy().astype(np.float64)
    w = np.linspace(0, np.pi, 257)
    aw = np.polyval(a[8][::-1], np.exp(1j * w))
    np.testing.assert_allclose(env.numpy()[8],
                               10 * np.log10(g2[8] / np.abs(aw) ** 2),
                               atol=1e-3)
    # the default order rule and grid
    env2, _ = T.lpc_envelope_db(x[:4000], 16000, **CPU)
    jenv2, _ = J.lpc_envelope_db(x[:4000], 16000)
    np.testing.assert_allclose(env2.numpy(), np.asarray(jenv2), atol=1e-3)


def test_formants_match_jax():
    sr = 16000
    y = _vowel(sr)
    f, hop_s, t0 = T.formant_track(y, sr, n_formants=3, fmax=4000.0, **CPU)
    jf, jhop_s, jt0 = J.formant_track(y, sr, n_formants=3, fmax=4000.0)
    f, jf = f.numpy(), np.asarray(jf)
    assert (hop_s, t0) == (jhop_s, jt0) and f.shape == jf.shape
    np.testing.assert_array_equal(np.isnan(f), np.isnan(jf))
    step = (8000.0 / 2.0) / (1024 - 1)  # the 2*fmax analysis grid
    assert np.nanmax(np.abs(f - jf)) <= step
    for k, ft in enumerate((700.0, 1800.0)):
        assert abs(np.nanmedian(f[5:-5, k]) - ft) < 0.05 * ft


def test_formants_without_resampling_and_validation():
    sr = 8000
    y = _vowel(sr)
    f, _, _ = T.formant_track(y, sr, n_formants=5, **CPU)  # fmax > sr / 2
    jf, _, _ = J.formant_track(y, sr, n_formants=5)
    jf = np.asarray(jf)
    np.testing.assert_array_equal(np.isnan(f.numpy()), np.isnan(jf))
    assert np.nanmax(np.abs(f.numpy() - jf)) <= 4000.0 / 1023
    with pytest.raises(ValueError):
        T.formant_track(y, sr, n_formants=0, **CPU)
    with pytest.raises(ValueError):
        T.formant_track(y, sr, fmax=100.0, **CPU)
    with pytest.raises(ValueError):
        T.lpc(y, order=0, **CPU)
    with pytest.raises(ValueError):
        T.lpc(y, order=4, hop_length=0, **CPU)
    with pytest.raises(ValueError):
        T.lpc(np.zeros((2, 100), np.float32), order=4, **CPU)
    with pytest.raises(ValueError):
        T.lpc(np.zeros(1, np.float32), order=1, frame_length=4, **CPU)


@pytest.mark.gpu
def test_lpc_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the envelope on AR noise: a periodic signal's normal equations are
    # near-singular at the default order, and there the envelope's nulls
    # follow f32 rounding (3.6 dB apart card vs CPU on the vowel)
    x = _ar(np.random.default_rng(3), [1.0, -1.2, 0.8, -0.3, 0.1], 16000)
    env = T.lpc_envelope_db(x, 16000)[0]
    assert env.is_cuda
    np.testing.assert_allclose(env.cpu().numpy(),
                               T.lpc_envelope_db(x, 16000, **CPU)[0].numpy(),
                               atol=1e-3)
    y = _vowel(16000)
    f = T.formant_track(y, 16000, n_formants=3, fmax=4000.0)[0].cpu().numpy()
    cf = T.formant_track(y, 16000, n_formants=3, fmax=4000.0,
                         **CPU)[0].numpy()
    np.testing.assert_array_equal(np.isnan(f), np.isnan(cf))
    assert np.nanmax(np.abs(f - cf)) <= 4000.0 / 1023
