"""The port's filtering (``msv_tpu_torch/ops/filter.py``, on the CPU)
against ``msv_tpu/ops/filter.py`` and scipy's float64 filters.

Tolerances are tests/test_filter.py's: sosfilt against scipy's f64 sosfilt
at its per-design bounds (:60, :68), the streamed form against the one-shot
one at 2e-5 (:79), filtfilt against sosfiltfilt at 5e-5 (:99), fir_filter
against numpy's f64 convolution at 2e-5 (:136).  Against msv_tpu the port
is held to the same bounds (two f32 scans of one filter, each within them
of f64; the summation orders differ).  The designs are copies, held equal
to msv_tpu's bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import scipy.signal as ss  # noqa: E402

from msv_tpu_torch.ops import filter as T  # noqa: E402

try:
    from msv_tpu.ops import filter as J
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _reference(request):
    """The JAX reference is absent where the card-only tests run: there
    only the tests marked ``gpu`` (which compare card and CPU) run."""
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")

DESIGNS = [  # order, btype, cutoff, tolerance vs scipy f64 (test_filter.py)
    (4, "lowpass", 2000.0, 2e-5),
    (8, "highpass", 300.0, 2e-4),
    (6, "bandpass", (300.0, 3000.0), 2e-4),
    (4, "bandstop", (300.0, 3000.0), 2e-4),
]
# msv_tpu compiles one program per cascade (about 1.3 s a section on the
# CPU), so its side runs two small cascades: LOW (two complex-pole
# sections) and ODD (a real-pole section and a complex one)
LOW = T.butter_sos(4, 2000.0, "lowpass", sr=16000)
ODD = T.butter_sos(3, 1000.0, "lowpass", sr=16000)


def _eq():
    """A Butterworth band-pass and RBJ shelves and peak (real and complex
    pole sections); the notch is held apart (its f32 error at radius
    0.9993 is 1e-4 in msv_tpu too)."""
    return np.concatenate([
        T.butter_sos(4, (200.0, 5000.0), "bandpass", sr=16000),
        T.high_shelf(16000, 3000.0, 6.0), T.low_shelf(16000, 150.0, -4.0),
        T.peaking_eq(16000, 1000.0, 6.0, q=2.0)])


@pytest.mark.parametrize("order,btype,cutoff,tol", DESIGNS)
def test_sosfilt_matches_jax_and_scipy(order, btype, cutoff, tol):
    x = np.random.default_rng(0).standard_normal(30000).astype(np.float32)
    sos = T.butter_sos(order, cutoff, btype, sr=16000)
    np.testing.assert_array_equal(sos, J.butter_sos(order, cutoff, btype,
                                                    sr=16000))
    got = T.sosfilt(sos, x, **CPU)
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.abs(got - ss.sosfilt(sos, x.astype(np.float64))).max() < tol
    if order == 4 and btype == "lowpass":  # LOW: msv_tpu's program
        assert np.abs(got - J.sosfilt(sos, x)).max() < tol


def test_real_pole_section_matches_jax(rng):
    assert sorted(p[0] for p in T._section_plan(ODD)) == ["cplx", "real"]
    x = rng.standard_normal(30000).astype(np.float32)
    got = T.sosfilt(ODD, x, **CPU)
    assert np.abs(got - ss.sosfilt(ODD, x.astype(np.float64))).max() < 2e-5
    assert np.abs(got - J.sosfilt(ODD, x)).max() < 2e-5


def test_rbj_sections_and_response_match_jax(rng):
    for name, args in [("peaking_eq", (16000, 1000.0, 6.0, 2.0)),
                       ("low_shelf", (16000, 150.0, -4.0)),
                       ("high_shelf", (16000, 3000.0, 6.0, 0.7)),
                       ("notch", (16000, 60.0, 20.0))]:
        np.testing.assert_array_equal(getattr(T, name)(*args),
                                      getattr(J, name)(*args))
    sos = _eq()
    f = np.linspace(0, 8000, 33)
    np.testing.assert_array_equal(T.sos_response(sos, f, 16000),
                                  J.sos_response(sos, f, 16000))
    x = (0.3 * rng.standard_normal(20000)).astype(np.float32)
    got = T.sosfilt(sos, x, **CPU)
    assert np.abs(got - ss.sosfilt(sos, x.astype(np.float64))).max() < 2e-5
    # the notch (radius 0.9993): within 5 times test_filter.py's 2e-4 on
    # unit noise here, as msv_tpu's own run
    n = T.notch(16000, 60.0)
    y = T.sosfilt(n, 3 * x, **CPU)
    assert np.abs(y - ss.sosfilt(n, 3 * x.astype(np.float64))).max() < 1e-3


def test_state_carry_matches_jax(rng):
    """zi in, zf out, in msv_tpu's (x1, x2, s1, s2) convention: a split
    call equals the whole, and zf equals msv_tpu's."""
    sos = LOW
    x = (0.3 * rng.standard_normal(9000)).astype(np.float32)
    zi = T.sosfilt_zi_step(sos, 0.25)
    np.testing.assert_array_equal(zi, J.sosfilt_zi_step(sos, 0.25))
    np.testing.assert_array_equal(T.sosfilt_zi_step(ODD, -0.5),
                                  J.sosfilt_zi_step(ODD, -0.5))
    y, zf = T.sosfilt(sos, x, zi, return_zf=True, **CPU)
    jy, jzf = J.sosfilt(sos, x, zi, return_zf=True)
    assert zf.shape == (len(sos), 4) and zf.dtype == np.float32
    assert np.abs(y - jy).max() < 2e-5 and np.abs(zf - jzf).max() < 2e-5
    a, za = T.sosfilt(sos, x[:4001], zi, return_zf=True, **CPU)
    b = T.sosfilt(sos, torch.from_numpy(x[4001:]), za)
    np.testing.assert_allclose(np.concatenate([a, b]), y, rtol=0, atol=2e-5)
    # one and two samples: the carried x[-2] comes from the state
    for n in (1, 2):
        np.testing.assert_allclose(T.sosfilt(sos, x[:n], zi, **CPU),
                                   J.sosfilt(sos, x[:n], zi), atol=1e-6)
    with pytest.raises(ValueError, match="zi shape"):
        T.sosfilt(sos, x, zi[:1], **CPU)
    with pytest.raises(ValueError, match="1-D"):
        T.sosfilt(sos, x[None], **CPU)
    with pytest.raises(ValueError, match="empty"):
        T.sosfilt(sos, x[:0], **CPU)


def test_zi_step_holds_steady_state():
    sos = T.butter_sos(4, 2000.0, "lowpass", sr=16000)
    y = T.sosfilt(sos, np.full(4096, 0.7, np.float32),
                  T.sosfilt_zi_step(sos, 0.7), **CPU)
    dc = T.sos_response(sos, [1e-9], 16000)[0]
    np.testing.assert_allclose(y, 0.7 * dc, rtol=0, atol=1e-4)


def test_sosfilt_streamed_equals_oneshot_and_jax(rng):
    x = rng.standard_normal(30000).astype(np.float32)
    sos = T.butter_sos(8, 300.0, "highpass", sr=16000)
    one = T.sosfilt(sos, x, **CPU)
    chunked = T.sosfilt_streamed(sos, x, chunk=7001, **CPU)
    np.testing.assert_allclose(chunked, one, atol=2e-5)
    chunked = T.sosfilt_streamed(LOW, x, chunk=7001, **CPU)
    np.testing.assert_allclose(
        chunked, J.sosfilt_streamed(LOW, x, chunk=7001), atol=2e-5)
    # below one chunk it is one call
    np.testing.assert_array_equal(T.sosfilt_streamed(sos, x, **CPU), one)


def test_filtfilt_matches_scipy_and_jax(rng):
    x = rng.standard_normal(20000).astype(np.float32)
    for sos, gain in ((LOW, 1.0), (_eq(), 0.3)):
        got = T.filtfilt(sos, gain * x, **CPU)
        ref = ss.sosfiltfilt(sos, gain * x.astype(np.float64),
                             padlen=3 * (2 * len(sos) + 1))
        assert got.shape == x.shape and got.dtype == np.float32
        assert np.abs(got - ref).max() < 5e-5
    assert np.abs(T.filtfilt(LOW, x, **CPU) - J.filtfilt(LOW, x)).max() < 5e-5
    np.testing.assert_allclose(T.filtfilt(LOW, x, padlen=0, **CPU),
                               J.filtfilt(LOW, x, padlen=0), atol=5e-5)
    with pytest.raises(ValueError, match="padlen"):
        T.filtfilt(LOW, np.zeros(10, np.float32), **CPU)


@pytest.mark.parametrize("numtaps,cutoff,pass_zero", [
    (63, 2000.0, True), (64, 2000.0, True), (63, (300.0, 3000.0), False),
    (63, (300.0, 3000.0), True)])
def test_firwin_and_fir_filter_match(numtaps, cutoff, pass_zero, rng):
    h = T.firwin(numtaps, cutoff, sr=16000, pass_zero=pass_zero)
    np.testing.assert_array_equal(h, J.firwin(numtaps, cutoff, sr=16000,
                                              pass_zero=pass_zero))
    np.testing.assert_allclose(h, ss.firwin(numtaps, cutoff, fs=16000,
                                            pass_zero=pass_zero), atol=1e-12)
    x = rng.standard_normal(5000).astype(np.float32)
    y = T.fir_filter(x, h, **CPU)
    assert y.shape == x.shape and y.dtype == np.float32
    # msv_tpu's 'same' window pads (numtaps - 1) // 2 zeros in front, so
    # output n is full-convolution sample n + numtaps - 1 - that lead
    # (numpy's 'same' for odd lengths)
    ref = np.convolve(x.astype(np.float64), h, mode="full")[
        numtaps - 1 - (numtaps - 1) // 2:][:len(x)]
    assert np.abs(y - ref).max() < 2e-5
    if numtaps == 64 or not pass_zero:  # one msv_tpu program per length
        assert np.abs(y - J.fir_filter(x, h)).max() < 2e-5


def test_design_errors_are_msv_tpu_s():
    for fn, args, kw in [(T.butter_sos, (0, 100.0), {"sr": 16000}),
                         (T.butter_sos, (4, 9000.0), {"sr": 16000}),
                         (T.butter_sos, (4, 100.0, "comb"), {"sr": 16000}),
                         (T.peaking_eq, (16000, 9000.0, 3.0), {}),
                         (T.firwin, (64, (300.0, 3000.0)), {"sr": 16000})]:
        with pytest.raises(ValueError):
            fn(*args, **kw)


def test_tensor_input_stays_on_its_device_and_numpy_goes_to_the_card(rng):
    sos = _eq()
    x = (0.3 * rng.standard_normal(3000)).astype(np.float32)
    want = T.sosfilt(sos, x, **CPU)
    np.testing.assert_array_equal(T.sosfilt(sos, torch.from_numpy(x)), want)
    np.testing.assert_array_equal(T.filtfilt(sos, torch.from_numpy(x)),
                                  T.filtfilt(sos, x, **CPU))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (T.sosfilt, T.filtfilt, T.sosfilt_streamed):
        with pytest.raises((RuntimeError, AssertionError)):
            fn(sos, x)


@pytest.mark.gpu
def test_filters_on_the_card_match_the_cpu():
    """Every execution path on the card within tests/test_filter.py's
    bounds of the CPU run (2e-5, filtfilt 5e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(8)
    sos = _eq()
    x = (0.3 * rng.standard_normal(50000)).astype(np.float32)
    for fn, kw, tol in ((T.sosfilt, {}, 2e-5), (T.filtfilt, {}, 5e-5),
                        (T.sosfilt_streamed, {"chunk": 7001}, 2e-5)):
        got = fn(sos, x, device="cuda", **kw)
        want = fn(sos, x, device="cpu", **kw)
        assert np.abs(got - want).max() < tol, fn.__name__
    h = T.firwin(63, 2000.0, sr=16000)
    assert np.abs(T.fir_filter(x, h) - T.fir_filter(x, h, **CPU)).max() < 2e-5
