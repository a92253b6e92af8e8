"""The port's NMF (``msv_tpu_torch/ops/nmf.py``, on the CPU) against
``msv_tpu/ops/nmf.py``.

Bounds: ``nmf`` at 25 iterations within tests/test_nmf.py:38-39's rtol
2e-3 / atol 1e-6; ``separate`` sample by sample at 3 iterations within
2e-5 (measured 3.6e-7), its templates and activations at rtol 2e-3;
at 200 iterations (the default, where multiplicative updates amplify f32
order noise) by KL descent and by the parts summing to the input within
tests/test_nmf.py:71's atol 2e-4.  The 128-frame bucket is part of the
result: the initial activations are drawn for the bucket's columns
(``test_the_frame_bucket_reaches_the_draws``).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

T = importlib.import_module("msv_tpu_torch.ops.nmf")
try:
    J = importlib.import_module("msv_tpu.ops.nmf")
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}
SR, WIN, HOP, NFFT = 16000, 640, 160, 1024
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _reference(request):
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _mixture(seconds=1.0, seed=8):
    """A steady tone and a gated higher tone over light noise."""
    t = np.arange(int(SR * seconds)) / SR
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.2 * (np.sin(2 * np.pi * 3 * t) > 0)
            * np.sin(2 * np.pi * 1500 * t)
            + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


def test_nmf_matches_jax():
    v = np.random.default_rng(3).random((40, 60)).astype(np.float32)
    got = T.nmf(v, 4, n_iter=25, seed=7, **CPU)
    for g, w in zip(got, J.nmf(v, 4, n_iter=25, seed=7)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-3, atol=1e-6)
    assert T.kl_divergence(v, *got) == pytest.approx(
        J.kl_divergence(v, *got), rel=1e-12)


def test_kl_descends_over_iterations():
    v = np.random.default_rng(4).random((64, 80)).astype(np.float32)
    kl = [T.kl_divergence(v, *T.nmf(v, 5, n_iter=it, seed=3, **CPU))
          for it in (1, 5, 20, 80, 200)]
    assert all(b <= a + 1e-6 for a, b in zip(kl, kl[1:])), kl


def test_separate_matches_jax_at_a_few_iterations():
    x = _mixture()
    parts, w, h = T.separate(x, WIN, HOP, NFFT, n_components=3, n_iter=3,
                             **CPU)
    jp, jw, jh = (np.asarray(a) for a in J.separate(
        x, WIN, HOP, NFFT, n_components=3, n_iter=3))
    assert parts.shape == (3, len(x)) and h.shape == jh.shape
    np.testing.assert_allclose(parts, jp, atol=ATOL, rtol=0)
    np.testing.assert_allclose(w, jw, rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(h, jh, rtol=2e-3, atol=1e-6)


def test_separate_at_200_iterations_sums_to_the_input():
    x = _mixture(0.8)
    parts, w, h = T.separate(x, WIN, HOP, NFFT, n_components=2, **CPU)
    np.testing.assert_allclose(parts.sum(axis=0), x, atol=2e-4)
    assert (w >= 0).all() and (h >= 0).all()
    jp = np.asarray(J.separate(x, WIN, HOP, NFFT, n_components=2)[0])
    np.testing.assert_allclose(jp.sum(axis=0), x, atol=2e-4)


def test_the_frame_bucket_reaches_the_draws(monkeypatch):
    """Without msv_tpu's 128-frame bucket the activations' initial draw
    has other columns, so even one iteration lands elsewhere."""
    x = _mixture()
    jp = np.asarray(J.separate(x, WIN, HOP, NFFT, n_components=3,
                               n_iter=3)[0])
    monkeypatch.setattr(importlib.import_module("msv_tpu_torch.ops.hpss"),
                        "FRAME_BUCKET", 1)
    parts = T.separate(x, WIN, HOP, NFFT, n_components=3, n_iter=3, **CPU)[0]
    assert np.abs(parts - jp).max() > 100 * ATOL


def test_errors_match_jax():
    x = _mixture(0.2)
    for kw in ({"n_components": 0}, {"n_iter": 0},
               {"n_components": 10_000}):
        with pytest.raises(ValueError):
            T.separate(x, WIN, HOP, NFFT, **kw, **CPU)
    for v in (np.zeros((0, 3)), -np.ones((3, 3)), np.ones(3)):
        with pytest.raises(ValueError):
            T.nmf(v, 1, **CPU)


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _mixture()
    got = T.separate(x, WIN, HOP, NFFT, n_components=3, n_iter=3,
                     device="cuda")[0]
    want = T.separate(x, WIN, HOP, NFFT, n_components=3, n_iter=3, **CPU)[0]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    parts = T.separate(x, WIN, HOP, NFFT, n_components=3, device="cuda")[0]
    np.testing.assert_allclose(parts.sum(axis=0), x, atol=2e-4)
