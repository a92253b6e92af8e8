"""The rest of the port's feature set (``msv_tpu_torch/features.py``:
whisper, mfcc, pcen, delta, spectral, contrast, chroma, onsets) on the CPU
against ``msv_tpu/features.py``.

Parity precision, at tests/test_features.py's tolerances: whisper atol
3e-4 (:279), mfcc atol 2e-4 (:375) and its lifter/batch rule 1e-5
(:386-392), delta atol 1e-5 (:420), the spectral columns at their rtol
(:490-495: centroid 1e-4, bandwidth 1e-3, rolloff 1e-6, flatness 1e-3 with
atol 1e-7, rms 1e-4, zcr 1e-6), chroma rtol 1e-4 atol 1e-6 (:574), pcen
atol 2e-4 (:689), contrast rtol 1e-3 atol 2e-3 (:814); onset times equal.

Fast precision (the default of all but whisper) rounds each GEMM's
operands to bf16 in the port; msv_tpu's default precision is f32 on the
CPU, so the port's fast result is held to msv_tpu's f32 result, as
tests/test_torch_features.py holds the log-mel core, by the 99th
percentile of the difference on a tone over noise and white noise
(measured on this input, bound): whisper 0.0012 (0.0118, one 0.47 dB grey
step in whisper's log10/4 units), mfcc 0.36 (1.0), pcen relative 0.052
(0.15), onset envelope 0.028 dB (0.1), chroma 0.002 (0.01), contrast
1.5 dB (4.0), spectral columns relative: centroid 0.001, bandwidth 0.0018,
rolloff 0.0046, flatness 0.012 (all 0.03), rms and zcr as in parity (they
read the unrounded frames).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import msv_tpu_torch.features as T  # noqa: E402
from msv_tpu_torch import config as tcfg  # noqa: E402

try:
    import msv_tpu.features as J
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}
SPECTRAL_RTOL = (1e-4, 1e-3, 1e-6, 1e-3, 1e-4, 1e-6)


@pytest.fixture(autouse=True)
def _reference(request):
    """The JAX reference is absent where the card-only tests run: there
    only the tests marked ``gpu`` (which compare card and CPU) run."""
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


@pytest.fixture(autouse=True)
def _reset_port_precision():
    yield
    tcfg.reset_precision_mode()


@pytest.fixture()
def batch(rng):
    return _batch(rng)


def _batch(rng):
    """(2, 2 s) at 16 kHz: a tone over noise, and white noise."""
    sr = 16000
    t = np.arange(2 * sr) / sr
    tone = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(
        len(t))
    return np.stack([tone, 0.2 * rng.standard_normal(len(t))]).astype(
        np.float32), sr


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _p99(got, want, rel=False):
    d = np.abs(_np(got) - _np(want))
    if rel:
        d = d / np.maximum(np.abs(_np(want)), 1e-12)
    return float(np.percentile(d, 99))


def test_whisper_matches_jax(batch, rng):
    x, sr = batch
    for wav in (x, x[0], rng.standard_normal(400).astype(np.float32) * 0.2,
                rng.standard_normal(16000 * 31).astype(np.float32) * 0.1):
        got = T.whisper_log_mel(wav, **CPU)
        want = np.asarray(J.whisper_log_mel(wav))
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-4)
    got = T.whisper_log_mel(x[0], n_mel=128, **CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        J.whisper_log_mel(x[0], n_mel=128)), rtol=0, atol=3e-4)
    fast = T.whisper_log_mel(x, precision="fast", **CPU)
    assert _p99(fast, J.whisper_log_mel(x)) < 0.0118
    with pytest.raises(ValueError, match="16 kHz"):
        T.whisper_log_mel(x, 8000, **CPU)


def test_mfcc_matches_jax(batch):
    x, sr = batch
    got = T.mfcc(x, sr, precision="parity", **CPU)
    want = np.asarray(J.mfcc(x, sr, precision="parity"))
    assert got.shape == want.shape == (2, 201, 13)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    lift = T.mfcc(x, sr, n_mfcc=20, lifter=22.0, precision="parity", **CPU)
    np.testing.assert_allclose(lift.numpy(), np.asarray(J.mfcc(
        x, sr, n_mfcc=20, lifter=22.0, precision="parity")), rtol=1e-5,
        atol=2e-4 * 12)  # the lifter scales the 2e-4 by up to 1 + 11
    li = 1.0 + 11.0 * np.sin(np.pi * np.arange(1, 21) / 22.0)
    plain = T.mfcc(x, sr, n_mfcc=20, precision="parity", **CPU).numpy()
    np.testing.assert_allclose(lift.numpy(), plain * li.astype(np.float32),
                               rtol=1e-5, atol=1e-5)
    one = T.mfcc(x[0], sr, precision="parity", **CPU)
    np.testing.assert_allclose(one.numpy(), got[0].numpy(), atol=1e-5)
    assert _p99(T.mfcc(x, sr, **CPU), J.mfcc(x, sr)) < 1.0
    with pytest.raises(ValueError, match="lifter"):
        T.mfcc(x, sr, lifter=-1.0, **CPU)


def test_pcen_matches_jax(batch):
    x, sr = batch
    got = T.pcen(x, sr, n_mel=40, precision="parity", **CPU)
    want = np.asarray(J.pcen(x, sr, n_mel=40, precision="parity"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    kw = dict(gain=1.0, bias=0.5, power=0.25, time_constant=0.1, eps=1e-4)
    np.testing.assert_allclose(
        T.pcen(x[0], sr, precision="parity", **kw, **CPU).numpy(),
        np.asarray(J.pcen(x[0], sr, precision="parity", **kw)), atol=2e-4)
    assert _p99(T.pcen(x, sr, n_mel=40, **CPU), want, rel=True) < 0.15
    for bad in ({"gain": 1.5}, {"eps": 0.0}):
        with pytest.raises(ValueError):
            T.pcen(x, sr, **bad, **CPU)


def test_delta_matches_jax(rng):
    x = rng.standard_normal((2, 50, 13)).astype(np.float32)
    for width, order in [(9, 1), (7, 2), (5, 1), (3, 1)]:
        got = T.delta(x, width=width, order=order, **CPU)
        np.testing.assert_allclose(got.numpy(), np.asarray(
            J.delta(x, width=width, order=order)), atol=1e-5)
    np.testing.assert_allclose(T.delta(x[0], axis=0, **CPU).numpy(),
                               np.asarray(J.delta(x[0], axis=0)), atol=1e-5)
    assert T.delta(torch.from_numpy(x)).shape == x.shape
    for bad in ({"width": 4}, {"order": 9}):
        with pytest.raises(ValueError):
            T.delta(x, **bad, **CPU)


def test_spectral_features_match_jax(batch):
    x, sr = batch
    got = T.spectral_features(x, sr, precision="parity", **CPU).numpy()
    want = np.asarray(J.spectral_features(x, sr, precision="parity"))
    assert got.shape == want.shape == (2, 201, 6)
    assert T.SPECTRAL_FEATURE_NAMES == J.SPECTRAL_FEATURE_NAMES
    for k, rtol in enumerate(SPECTRAL_RTOL):
        np.testing.assert_allclose(got[..., k], want[..., k], rtol=rtol,
                                   atol=1e-7 if k == 3 else 0, err_msg=k)
    kw = dict(win_length=300, hop_length=100, n_fft=512, rolloff_pct=0.5)
    np.testing.assert_allclose(
        T.spectral_features(x[0], sr, precision="parity", **kw,
                            **CPU).numpy(),
        np.asarray(J.spectral_features(x[0], sr, precision="parity", **kw)),
        rtol=1e-3)
    fast = T.spectral_features(x, sr, **CPU).numpy()
    for k in range(4):
        assert _p99(fast[..., k], want[..., k], rel=True) < 0.03, k
    np.testing.assert_allclose(fast[..., 4:], want[..., 4:], rtol=1e-4)
    with pytest.raises(ValueError, match="rolloff"):
        T.spectral_features(x, sr, rolloff_pct=0.0, **CPU)


def test_spectral_contrast_matches_jax(batch):
    x, sr = batch
    got = T.spectral_contrast(x, sr, precision="parity", **CPU)
    want = np.asarray(J.spectral_contrast(x, sr, precision="parity"))
    assert got.shape == want.shape == (2, 201, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-3)
    for kw in ({"linear": True}, {"fmin": 100.0, "n_bands": 4,
                                  "quantile": 0.1}):
        a = T.spectral_contrast(x[0], sr, precision="parity", **kw,
                                **CPU).numpy()
        b = np.asarray(J.spectral_contrast(x[0], sr, precision="parity",
                                           **kw))
        if kw.get("linear"):  # the ratios, held in dB
            a, b = 10.0 * np.log10(a), 10.0 * np.log10(b)
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-3)
    assert (T._contrast_bands(sr, 512, 200.0, 6, 0.02)
            == J._contrast_bands(sr, 512, 200.0, 6, 0.02))
    assert _p99(T.spectral_contrast(x, sr, **CPU), want) < 4.0
    with pytest.raises(ValueError, match="Nyquist"):
        T.spectral_contrast(x, sr, fmin=2000.0, **CPU)


def test_chroma_matches_jax(batch):
    x, sr = batch
    for norm in ("inf", "l2", "none"):
        got = T.chroma_stft(x, sr, norm=norm, precision="parity", **CPU)
        want = np.asarray(J.chroma_stft(x, sr, norm=norm,
                                        precision="parity"))
        assert got.shape == want.shape == (2, 201, 12)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(
        T.chroma_filterbank(22050, 2048, n_chroma=24, tuning=0.3),
        J.chroma_filterbank(22050, 2048, n_chroma=24, tuning=0.3))
    assert _p99(T.chroma_stft(x, sr, **CPU), J.chroma_stft(x, sr)) < 0.01
    with pytest.raises(ValueError, match="norm"):
        T.chroma_stft(x, sr, norm="max", **CPU)


def test_onsets_match_jax(rng):
    """tests/test_features.py:595's clicks: the same times as msv_tpu's,
    in both precisions; a steady tone has none."""
    sr = 16000
    n = 2 * sr
    x = np.zeros(n, np.float32)
    for tt in [0.25, 0.7, 1.1, 1.62]:
        c = int(tt * sr)
        x[c:c + 40] = 0.8 * np.sin(
            2 * np.pi * 2000 * np.arange(40) / sr).astype(np.float32)
    tone = (0.4 * np.sin(2 * np.pi * 440 * np.arange(n) / sr)).astype(
        np.float32)
    for wav in (x, (0.5 * tone + x).astype(np.float32), tone):
        want = np.asarray(J.onset_detect(wav, sr))
        for prec in (None, "parity"):
            got = T.onset_detect(wav, sr, precision=prec, **CPU)
            assert got.dtype == np.float64
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        T.onset_detect(x, sr, units="frames", **CPU),
        np.asarray(J.onset_detect(x, sr, units="frames")))
    env = T.onset_strength(x, sr, precision="parity", **CPU)
    want = np.asarray(J.onset_strength(x, sr, precision="parity"))
    np.testing.assert_allclose(env.numpy(), want, rtol=1e-4, atol=1e-4)
    assert _p99(T.onset_strength(x, sr, **CPU), want) < 0.1
    assert float(env[-1]) == 0.0  # the end corner is zeroed
    with pytest.raises(ValueError, match="lag"):
        T.onset_strength(x, sr, lag=0, **CPU)
    with pytest.raises(ValueError, match="units"):
        T.onset_detect(x, sr, units="ms", **CPU)
    with pytest.raises(ValueError, match="single"):
        T.onset_detect(np.stack([x, x]), sr, **CPU)


def test_precision_follows_the_session_mode(batch):
    x, sr = batch
    parity = T.chroma_stft(x, sr, precision="parity", **CPU)
    assert not torch.equal(T.chroma_stft(x, sr, **CPU), parity)
    tcfg.set_precision_mode("parity")
    assert torch.equal(T.chroma_stft(x, sr, **CPU), parity)
    with pytest.raises(ValueError, match="precision"):
        T.spectral_features(x, sr, precision="double", **CPU)


def test_tensor_input_stays_on_its_device(batch):
    x, sr = batch
    for fn in (T.spectral_features, T.chroma_stft, T.spectral_contrast,
               T.mfcc, T.pcen, T.onset_strength):
        got = fn(torch.from_numpy(x), sr)
        assert got.device.type == "cpu"
        assert torch.equal(got, fn(x, sr, **CPU)), fn.__name__
    assert torch.equal(T.whisper_log_mel(torch.from_numpy(x)),
                       T.whisper_log_mel(x, **CPU))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            T.chroma_stft(x, sr)  # numpy goes to the card


@pytest.mark.gpu
def test_features_on_the_card_match_the_cpu():
    """Each feature on the card within its parity tolerance of the CPU
    run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, sr = _batch(np.random.default_rng(8))
    for fn, atol in ((T.whisper_log_mel, 3e-4), (T.mfcc, 2e-4),
                     (T.pcen, 2e-4), (T.chroma_stft, 1e-5),
                     (T.spectral_contrast, 2e-3)):
        args = (x,) if fn is T.whisper_log_mel else (x, sr)
        got = fn(*args, precision="parity").cpu().numpy()
        want = fn(*args, precision="parity", **CPU).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=atol,
                                   err_msg=fn.__name__)
    got = T.spectral_features(x, sr, precision="parity").cpu().numpy()
    want = T.spectral_features(x, sr, precision="parity", **CPU).numpy()
    for k, rtol in enumerate(SPECTRAL_RTOL):
        np.testing.assert_allclose(got[..., k], want[..., k], rtol=rtol,
                                   atol=1e-7 if k == 3 else 0)
    np.testing.assert_array_equal(T.onset_detect(x[0], sr),
                                  T.onset_detect(x[0], sr, **CPU))
