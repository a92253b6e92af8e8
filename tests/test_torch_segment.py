"""The port's structure segmentation (``msv_tpu_torch/ops/segment.py``, on
the CPU) against ``msv_tpu/ops/segment.py`` and its sliding-patch oracle.

Tolerances: the similarity matrix atol 1e-5 (tests/test_segment.py:33)
and the novelty rtol 1e-4, atol 1e-3 (:57) in parity; boundaries equal to
msv_tpu's on tests/test_segment.py's structured signals (feature blocks,
a tone-then-noise clip, a three-section clip), in both precisions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch.ops import segment as T  # noqa: E402

try:
    from msv_tpu.ops import segment as J
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _reference(request):
    """The JAX reference is absent where the card-only tests run."""
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _blocks(rng, n_blocks=3, per=50, dim=10, noise=0.03):
    blocks = [rng.standard_normal(dim).astype(np.float32)
              for _ in range(n_blocks)]
    return np.concatenate([
        np.stack([blk + noise * rng.standard_normal(dim).astype(np.float32)
                  for _ in range(per)]) for blk in blocks])


def _sections(rng, sr=8000, seconds=4):
    """tests/test_segment.py:103's tone, then noise, then a chirp."""
    t = np.arange(seconds * sr) / sr
    tone = 0.4 * np.sin(2 * np.pi * 440 * t)
    noise = 0.2 * rng.standard_normal(seconds * sr)
    chirp = 0.3 * np.sin(2 * np.pi * (200 + 300 * t) * t)
    return np.concatenate([tone, noise, chirp]).astype(np.float32)


@pytest.mark.parametrize("t,ks", [(40, 4), (130, 16), (257, 8)])
def test_ssm_and_novelty_match_jax_and_the_oracle(rng, t, ks):
    f = rng.standard_normal((t, 6)).astype(np.float32)
    f[t // 2:] += 3.0
    ssm = T.self_similarity(f, precision="parity", **CPU)
    assert ssm.shape == (t, t) and ssm.dtype == torch.float32
    np.testing.assert_allclose(ssm.numpy(), np.asarray(
        J.self_similarity(f, precision="parity")), atol=1e-5)
    nov = T.novelty_from_ssm(ssm, kernel_size=ks, precision="parity")
    np.testing.assert_allclose(nov, T.oracle_novelty_np(ssm.numpy(), ks),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(nov, J.novelty_from_ssm(
        ssm.numpy(), kernel_size=ks, precision="parity"), rtol=1e-4,
        atol=1e-3)


def test_checker_band_equals_the_host_loop():
    """The device band (one diagonal fill per offset) equals msv_tpu's
    host loop over rows, sliced to the true size."""
    for t, ks in ((40, 4), (33, 16), (9, 8)):
        u = T._checker_u(ks)
        want = np.zeros((t, t), np.float32)
        cols = np.arange(t)
        for i, ui in enumerate(u):
            rows = cols + i - ks
            ok = (rows >= 0) & (rows < t)
            want[rows[ok], cols[ok]] = ui
        np.testing.assert_array_equal(
            T.checker_band(t, ks, "cpu").numpy(), want)


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_boundaries_of_feature_blocks_equal_jax(rng, precision):
    f = _blocks(rng)
    got = T.segment_boundaries(f, kernel_size=10, precision=precision, **CPU)
    want = J.segment_boundaries(f, kernel_size=10, precision=precision)
    np.testing.assert_array_equal(got, want)
    assert len(got) == 2 and abs(got[0] - 50) <= 3 and abs(got[1] - 100) <= 3
    homog = _blocks(rng, n_blocks=1, per=120)
    assert len(T.segment_boundaries(homog, kernel_size=10, delta=0.5,
                                    precision=precision, **CPU)) == 0


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_segment_audio_equals_jax(rng, precision):
    wav = _sections(rng)
    got = T.segment(wav, 8000, hop_s=0.1, kernel_s=1.0, precision=precision,
                    **CPU)
    want = J.segment(wav, 8000, hop_s=0.1, kernel_s=1.0, precision=precision)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert len(got) == 2 and abs(got[0] - 4.0) < 0.5 \
        and abs(got[1] - 8.0) < 0.5


def test_short_inputs_and_validation():
    assert T.novelty_from_ssm(np.eye(5, dtype=np.float32), kernel_size=4,
                              **CPU).tolist() == [0.0] * 5
    assert T.segment(np.zeros(300, np.float32), 8000, hop_s=0.5,
                     **CPU).shape == (0,)
    with pytest.raises(ValueError):
        T.novelty_from_ssm(np.zeros((4, 5), np.float32), **CPU)
    with pytest.raises(ValueError):
        T.novelty_from_ssm(np.eye(40, dtype=np.float32), kernel_size=1,
                           **CPU)
    with pytest.raises(ValueError):
        T.self_similarity(np.zeros(5, np.float32), **CPU)
    with pytest.raises(ValueError, match="MAX_SSM_FRAMES"):
        T.self_similarity(np.zeros((T.MAX_SSM_FRAMES + 1, 2), np.float32),
                          **CPU)
    with pytest.raises(ValueError):
        T.segment(np.zeros((2, 100), np.float32), 8000, **CPU)
    with pytest.raises(ValueError):
        T.segment(np.zeros(100, np.float32), 8000, hop_s=1.0, kernel_s=0.5,
                  **CPU)
    assert T.MAX_SSM_FRAMES == J.MAX_SSM_FRAMES


@pytest.mark.gpu
def test_segment_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wav = _sections(np.random.default_rng(2))
    for precision in ("parity", "fast"):
        got = T.segment(wav, 8000, hop_s=0.1, kernel_s=1.0,
                        precision=precision)
        want = T.segment(wav, 8000, hop_s=0.1, kernel_s=1.0,
                         precision=precision, **CPU)
        np.testing.assert_array_equal(got, want)
