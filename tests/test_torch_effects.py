"""The port's phase vocoder, trim and split (``msv_tpu_torch/ops/
effects.py``, on the CPU) against ``msv_tpu/ops/effects.py`` and
tests/test_effects.py's f64 vocoder oracle.

Bounds: the vocoder's spectrum within tests/test_effects.py:94's 2e-4 of
the spectrum's peak of the f64 oracle; pitch within two FFT bins and RMS
within 15% (:111-115, :151); frame RMS rtol 1e-5, atol 1e-7 (:222).
Sample by sample against msv_tpu on one-second clips: 99% of samples
within P99_BOUND and all within MAX_BOUND of the clip's peak.  Measured
on these clips (on the CPU): at most 2.1e-2 (a pitch shift of a pure
tone, in the first frames, where the reflect pad's transient makes the
nearest-peak choice of near-equal sidelobes follow f32 rounding) and a
99th percentile of at most 4.1e-4; the rest is the phase cumsum's f32
summation order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch.ops import effects as T  # noqa: E402
from msv_tpu_torch.ops.stft import _prepare  # noqa: E402

try:
    from msv_tpu.ops import effects as J
    from msv_tpu.ops.stft import perform_stft
    from test_effects import _peak_hz, _pv_oracle, _tone
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}
WIN, HOP, NFFT = 256, 64, 256
MAX_BOUND, P99_BOUND = 0.05, 1e-3


@pytest.fixture(autouse=True)
def _reference(request):
    """The JAX reference is absent where the card-only tests run."""
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _vocoded(wav, rate, phase_lock):
    padded, c, s, n_frames, _ = _prepare(wav, WIN, HOP, NFFT, None, None,
                                         "cpu")
    sel, frac, s_true = T._stretch_plan(n_frames, rate, 1)
    phi, table = T._phase_tables(HOP, NFFT)
    lin = table[np.arange(s_true) % table.shape[0]]
    re, im = T._pv_spec(
        padded, c, s, torch.from_numpy(sel.astype(np.int64)),
        torch.from_numpy(frac), torch.from_numpy(lin),
        torch.from_numpy(phi), win=WIN, hop=HOP, n_frames=n_frames,
        mode="parity", phase_lock=phase_lock)
    return re.numpy() + 1j * im.numpy(), n_frames


@pytest.mark.parametrize("phase_lock", [False, True])
@pytest.mark.parametrize("rate", [0.5, 1.37, 2.0])
def test_vocoder_matches_the_f64_oracle(rate, phase_lock):
    wav = np.random.default_rng(7).standard_normal(4000).astype(
        np.float32) * 0.3
    got, n_frames = _vocoded(wav, rate, phase_lock)
    d = np.asarray(perform_stft(wav, WIN, HOP, NFFT))[:n_frames]
    want = _pv_oracle(d, rate, HOP, NFFT, phase_lock)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max(),
                               rtol=0)


def _close_to_jax(got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    err = np.abs(got - want) / np.abs(want).max()
    assert err.max() <= MAX_BOUND and np.percentile(err, 99) <= P99_BOUND, (
        err.max(), np.percentile(err, 99))


@pytest.mark.parametrize("rate", [0.5, 2.0])
def test_time_stretch_tone_and_jax(rate):
    sr = 8000
    wav = _tone(440.0, sr, 1.0)
    out = T.time_stretch(wav, rate, **CPU)
    assert len(out) == int(round(len(wav) / rate))
    mid = out[len(out) // 4: -len(out) // 4]
    assert abs(_peak_hz(mid, sr) - 440.0) <= 2 * sr / len(mid)
    rms_in = np.sqrt(np.mean(wav ** 2))
    assert abs(np.sqrt(np.mean(mid ** 2)) - rms_in) / rms_in < 0.15
    _close_to_jax(out, J.time_stretch(wav, rate))
    noise = np.random.default_rng(1).standard_normal(8000).astype(
        np.float32) * 0.3
    for lock in (True, False):
        _close_to_jax(T.time_stretch(noise, rate, phase_lock=lock, **CPU),
                      J.time_stretch(noise, rate, phase_lock=lock))


@pytest.mark.parametrize("steps,factor", [(12, 2.0), (-12, 0.5), (3, None)])
def test_pitch_shift_and_jax(steps, factor):
    sr = 8000
    wav = _tone(440.0, sr, 1.0)
    out = T.pitch_shift(wav, sr, steps, **CPU)
    assert len(out) == len(wav)
    mid = out[len(out) // 4: -len(out) // 4]
    want_hz = 440.0 * (factor or 2 ** (steps / 12))
    assert abs(_peak_hz(mid, sr) - want_hz) <= 2 * sr / len(mid) + 1.0
    _close_to_jax(out, J.pitch_shift(wav, sr, steps))


def test_identities_fast_mode_and_errors():
    wav = _tone(200.0, 8000, 0.25)
    np.testing.assert_array_equal(T.time_stretch(wav, 1.0, **CPU), wav)
    np.testing.assert_array_equal(T.pitch_shift(wav, 8000, 0, **CPU), wav)
    np.testing.assert_array_equal(
        T.time_stretch(torch.from_numpy(wav), 1.0), wav)
    # fast mode rounds the analysis GEMM's operands to bf16: away from the
    # edges (whose frames' nearest-peak choice follows the rounding) within
    # 2% of the peak of parity on a tone (measured 0.52%)
    fast = T.time_stretch(wav, 0.8, precision="fast", **CPU)
    par = T.time_stretch(wav, 0.8, precision="parity", **CPU)
    q = len(par) // 4
    assert np.abs(fast - par)[q:-q].max() <= 0.02 * np.abs(par).max()
    # a tensor runs on its own device, the same numbers
    np.testing.assert_array_equal(
        T.time_stretch(torch.from_numpy(wav), 0.8, precision="parity"), par)
    for bad in (0.0, -2.0):
        with pytest.raises(ValueError, match="rate"):
            T.time_stretch(wav, bad, **CPU)
    with pytest.raises(ValueError, match="1-D"):
        T.time_stretch(wav.reshape(2, -1), 2.0, **CPU)
    with pytest.raises(ValueError, match="bins_per_octave"):
        T.pitch_shift(wav, 8000, 1, bins_per_octave=0, **CPU)


def test_nearest_peak_matches_the_loop_oracle(rng):
    from test_effects import _nearest_peak_np

    m = rng.random((20, 33)).astype(np.float32)
    m[3] = 1.0  # a flat row: no peak, every bin locks to itself
    got = T._nearest_peak(torch.from_numpy(m)).numpy()
    for row, g in zip(m, got):
        np.testing.assert_array_equal(g, _nearest_peak_np(row))


def _tone_gap_tone(sr=8000, amp=0.5):
    t = np.arange(sr) / sr
    tone = (amp * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    return np.concatenate([tone, np.zeros(sr, np.float32), tone])


def test_split_and_trim_equal_jax():
    sr = 8000
    x = _tone_gap_tone(sr)
    iv = T.split(x, sr, **CPU)
    np.testing.assert_array_equal(iv, J.split(x, sr))
    assert iv.shape == (2, 2) and iv.dtype == np.int64
    y = np.concatenate([np.zeros(sr // 2, np.float32), x,
                        np.zeros(sr // 2, np.float32)])
    out, (a, b) = T.trim(y, sr, **CPU)
    assert (a, b) == J.trim(y, sr)[1]
    np.testing.assert_array_equal(out, y[a:b])
    t = np.arange(sr) / sr
    two = np.concatenate([0.5 * np.sin(2 * np.pi * 440 * t),
                          0.005 * np.sin(2 * np.pi * 440 * t)]).astype(
        np.float32)
    for top_db in (60.0, 20.0):
        np.testing.assert_array_equal(T.split(two, top_db=top_db, **CPU),
                                      J.split(two, top_db=top_db))
    short = np.concatenate([np.zeros(300, np.float32),
                            0.5 * np.ones(300, np.float32)])
    np.testing.assert_array_equal(
        T.split(short, top_db=30.0, frame_length=2048, **CPU),
        J.split(short, top_db=30.0, frame_length=2048))


def test_frame_rms_matches_the_loop_and_edges(rng):
    from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center

    x = rng.standard_normal(5000).astype(np.float32) * 0.3
    got = T._frame_rms(x, 1024, 256, "cpu")
    padded = reflect_pad_center(x, 1024)
    want = np.array([np.sqrt(np.mean(padded[i * 256: i * 256 + 1024] ** 2))
                     for i in range(n_frames_for(len(x), 1024, 256))])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got, J._frame_rms(x, 1024, 256), rtol=1e-5,
                               atol=1e-7)
    out, (a, b) = T.trim(np.zeros(1000, np.float32), **CPU)
    assert len(out) == 0 and (a, b) == (0, 0)
    assert T.split(np.zeros(0, np.float32), **CPU).shape == (0, 2)
    for kw in ({"top_db": 0.0}, {"hop_length": 0}):
        with pytest.raises(ValueError):
            T.split(np.ones(10, np.float32), **kw, **CPU)
    with pytest.raises(ValueError):
        T.split(np.ones((2, 5), np.float32), **CPU)


@pytest.mark.gpu
def test_effects_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    t = np.arange(16000) / 16000
    wav = (0.4 * np.sin(2 * np.pi * 330 * t)
           + 0.05 * rng.standard_normal(16000)).astype(np.float32)
    for fn in (lambda d: T.time_stretch(wav, 0.5, device=d),
               lambda d: T.pitch_shift(wav, 16000, 3, device=d)):
        card = fn("cuda")
        np.testing.assert_array_equal(card, fn("cuda"))  # deterministic
        err = np.abs(card - fn("cpu")) / np.abs(card).max()
        assert err.max() <= MAX_BOUND and np.percentile(err, 99) <= P99_BOUND
    np.testing.assert_allclose(T._frame_rms(wav, 2048, 512, "cuda"),
                               T._frame_rms(wav, 2048, 512, "cpu"),
                               rtol=1e-5, atol=1e-7)
