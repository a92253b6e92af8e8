"""The port's reconstruction (``msv_tpu_torch/ops/reconstruct.py``, on the
CPU) against ``msv_tpu/ops/reconstruct.py``.

Bounds: one Griffin-Lim iteration of a tone over noise within 1e-4 of the
output's peak of msv_tpu's (measured: 1.6e-6; on a 10 s song-like track
1.0e-5).  More iterations are not held sample by sample: phase retrieval
amplifies f32 summation-order differences (after 4 iterations of two pure
tones the outputs differ by 0.13 of the peak, at the same convergence), so
32 iterations are held by tests/test_reconstruct.py's own bounds (spectral
convergence < 0.12, the fundamental within 2 Hz) and to within 0.02 of
msv_tpu's spectral convergence.  mel_to_linear within 1e-6 of the largest
value (the f64 pseudo-inverse's entries reach 1e11, so absolute errors are
large) and its re-projection within test_reconstruct.py:91's 2e-4.  Two
identical calls are bit-equal (the overlap-add is ``fold``, a fixed-order
sum, on the card too: the card test).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch.config import SpecSetting, derive_stft_params  # noqa: E402
from msv_tpu_torch.ops import decibel as TD  # noqa: E402
from msv_tpu_torch.ops import reconstruct as T  # noqa: E402
from msv_tpu_torch.ops.mel import calc_mel_fb_default  # noqa: E402
from msv_tpu_torch.ops.stft import perform_stft  # noqa: E402

try:
    from msv_tpu.ops import decibel as JD
    from msv_tpu.ops import reconstruct as J
except ImportError:  # no jax
    J = JD = None

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _reference(request):
    """The JAX reference is absent where the card-only tests run: there
    only the tests marked ``gpu`` (which compare card and CPU) run."""
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _params(sr=16000):
    return derive_stft_params(sr, SpecSetting())


def _mag(x, p):
    """|STFT| by msv_tpu: the inputs its own tests invert."""
    from msv_tpu.ops.stft import perform_stft as j_stft

    return np.abs(np.asarray(j_stft(x, p.win_length, p.hop_length,
                                    p.n_fft)))


def _convergence(y, mag, p):
    sy = _mag(y, p)
    n = min(len(sy), len(mag))
    return float(np.linalg.norm(sy[:n] - mag[:n])
                 / np.linalg.norm(mag[:n]))


def _gl(mod, mag, p, **kw):
    return np.asarray(mod.griffin_lim(mag, p.win_length, p.hop_length,
                                      p.n_fft, **kw))


def test_one_iteration_matches_jax(rng):
    sr, p = 8000, _params(8000)
    t = np.arange(sr) / sr
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.05 * rng.standard_normal(sr)).astype(np.float32)
    mag = _mag(x, p)
    for kw in ({}, {"momentum": 0.0}, {"length": 7000}):
        got = _gl(T, mag, p, n_iter=1, **kw, **CPU)
        want = _gl(J, mag, p, n_iter=1, **kw)
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    # an odd window and hop, an explicit window
    w = np.hanning(301).astype(np.float32)
    kw = dict(window=w, n_iter=1)
    from msv_tpu.ops.stft import perform_stft as j_stft

    m = np.abs(np.asarray(j_stft(x, 301, 77, 512, window=w)))
    got = np.asarray(T.griffin_lim(m, 301, 77, 512, **kw, **CPU))
    want = np.asarray(J.griffin_lim(m, 301, 77, 512, **kw))
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


def test_griffin_lim_recovers_harmonic_signal():
    """tests/test_reconstruct.py:29's case, and msv_tpu's convergence."""
    sr, p = 16000, _params()
    t = np.arange(sr) / sr
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.2 * np.sin(2 * np.pi * 1850 * t)).astype(np.float32)
    mag = _mag(x, p)
    y = _gl(T, mag, p, n_iter=32, **CPU)
    assert y.shape == x.shape and y.dtype == np.float32
    sc = _convergence(y, mag, p)
    assert sc < 0.12
    assert abs(sc - _convergence(_gl(J, mag, p, n_iter=32), mag, p)) < 0.02
    f = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    assert abs(f.argmax() * sr / len(y) - 440.0) < 2.0
    # classic iteration converges too, and more iterations go further
    errs = [_convergence(_gl(T, mag, p, n_iter=k, **CPU), mag, p)
            for k in (2, 8)]
    assert sc < errs[1] < errs[0]
    assert _convergence(_gl(T, mag, p, n_iter=32, momentum=0.0, **CPU),
                        mag, p) < errs[0]


def test_two_calls_are_bit_equal_and_tensors_stay_put(rng):
    p = _params(8000)
    mag = np.abs(rng.standard_normal((60, p.n_fft // 2 + 1))).astype(
        np.float32)
    a = _gl(T, mag, p, n_iter=3, **CPU)
    np.testing.assert_array_equal(a, _gl(T, mag, p, n_iter=3, **CPU))
    np.testing.assert_array_equal(a, _gl(T, torch.from_numpy(mag), p,
                                         n_iter=3))


def test_ola_constants_are_msv_tpu_s():
    w = np.hanning(10).astype(np.float32)
    for got, want in zip(T._ola_constants(7, 10, 3, w),
                         J._ola_constants(7, 10, 3, w)):
        np.testing.assert_array_equal(got, want)


def test_mel_to_linear_matches_jax():
    sr, p = 16000, _params()
    rng = np.random.default_rng(7)
    t = np.arange(sr // 2) / sr
    x = (0.4 * np.sin(2 * np.pi * 900 * t)
         + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
    mag = _mag(x, p)
    fb = calc_mel_fb_default(sr, p.n_fft)
    mel = mag @ fb
    lin = T.mel_to_linear(mel, fb, **CPU).numpy()
    want = np.asarray(J.mel_to_linear(mel, fb))
    assert lin.shape == mag.shape and (lin >= 0).all()
    assert np.abs(lin - want).max() <= 1e-6 * np.abs(want).max()
    assert (np.linalg.norm(lin @ fb - mel) / np.linalg.norm(mel)) < 2e-4
    assert (np.linalg.norm(lin - mag) / np.linalg.norm(mag)) < 0.05
    with pytest.raises(ValueError, match="n_mel"):
        T.mel_to_linear(mel[:, :5], fb, **CPU)


def test_db_inverses_and_a_weighting_match_jax(rng):
    db = (rng.standard_normal((5, 7)) * 30).astype(np.float32)
    for t, j in ((TD.db_to_amp, JD.db_to_amp),
                 (TD.db_to_power, JD.db_to_power)):
        for ref in (1.0, 0.5):
            np.testing.assert_allclose(t(torch.from_numpy(db), ref).numpy(),
                                       np.asarray(j(db, ref)), rtol=2e-6)
    f = np.array([0.0, 10.0, 100.0, 1000.0, 10000.0, 20000.0])
    for floor in (-80.0, None):
        np.testing.assert_array_equal(TD.a_weighting(f, floor),
                                      JD.a_weighting(f, floor))


def test_mel_db_roundtrip_to_audio():
    """The inversion chain a user takes from a --save-db export: db_to_amp
    -> mel_to_linear -> griffin_lim, all on one device."""
    sr, p = 16000, _params()
    t = np.arange(sr) / sr
    x = (0.5 * np.sin(2 * np.pi * 523.25 * t)).astype(np.float32)
    fb = calc_mel_fb_default(sr, p.n_fft)
    db = TD.amp_to_db(torch.from_numpy((_mag(x, p) @ fb).astype(np.float32)))
    lin = T.mel_to_linear(TD.db_to_amp(db), fb)
    y = _gl(T, lin, p, n_iter=32)
    f = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    assert abs(f.argmax() * sr / len(y) - 523.25) < 3.0
    assert float(np.sqrt(np.mean(y * y))) > 0.05


def test_validation_is_msv_tpu_s():
    p = _params()
    ok = np.ones((10, p.n_fft // 2 + 1), np.float32)
    for match, mag, kw in (("mag must be", ok[:, :5], {}),
                           ("momentum", ok, {"momentum": 1.0}),
                           ("too few frames", ok[:2], {})):
        with pytest.raises(ValueError, match=match):
            _gl(T, mag, p, **kw, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            _gl(T, ok, p)  # numpy goes to the card


@pytest.mark.gpu
def test_griffin_lim_on_the_card():
    """Two card calls bit-equal; one iteration within 1e-4 of the peak of
    the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(8)
    sr, p = 8000, _params(8000)
    t = np.arange(2 * sr) / sr
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    mag = perform_stft(x, p.win_length, p.hop_length, p.n_fft,
                       device="cpu").abs().numpy()
    a = _gl(T, mag, p, n_iter=8, device="cuda")
    np.testing.assert_array_equal(a, _gl(T, mag, p, n_iter=8,
                                         device="cuda"))
    one = _gl(T, mag, p, n_iter=1, device="cuda")
    want = _gl(T, mag, p, n_iter=1, **CPU)
    assert np.abs(one - want).max() < 1e-4 * np.abs(want).max()
