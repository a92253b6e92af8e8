"""The port's log-mel frontend (on the CPU, through the kernels' plain
versions and the torch-op core) against ``msv_tpu/features.py``.

Parity precision: atol 2e-3 dB, rtol 1e-4 (the kernel route takes
ln*20/ln10, JAX's XLA core log10).  Fast precision at win = 4 hop: against
JAX's Pallas route with bf16 operands (interpret mode), the same function,
max < 0.47 dB (one 120 dB / 255 grey step) and p99 < 0.01 dB.  At the
default 25/10 ms JAX has no bf16 route on the CPU (its XLA core runs f32
there), so the port's fast result is held to JAX's f32 result with the
fast-vs-parity bound of white noise: 99% of bins within one grey step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference: absent where the card-only tests run
pytest.importorskip("jax")

import msv_tpu  # noqa: E402
import msv_tpu_torch  # noqa: E402
from msv_tpu_torch import config as tcfg  # noqa: E402
from msv_tpu_torch.kernels import spectrogram_cuda as K  # noqa: E402

ATOL, RTOL = 2e-3, 1e-4
GREY_STEP = 0.47
WINDOWS = {"40/10": dict(win_ms=40.0, hop_ms=10.0), "25/10": {}}


@pytest.fixture(autouse=True)
def _reset_port_precision():
    yield
    tcfg.reset_precision_mode()


def _noise(rng, sr, batch=2, seconds=1.0):
    return (rng.standard_normal((batch, int(seconds * sr))) * 0.4).astype(
        np.float32)


def _port(wav, sr, **kw):
    return msv_tpu_torch.log_mel_spectrogram(wav, sr, device="cpu",
                                             **kw).numpy()


@pytest.mark.parametrize("extra", [
    dict(log="amp_db"), dict(log="power_db"), dict(log="ln"),
    dict(spec="power"), dict(top_db=30.0),
], ids=["amp_db", "power_db", "ln", "spec_power", "top_db"])
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("n_mel", [64, 128])
@pytest.mark.parametrize("sr", [8000, 16000])
def test_parity_matches_jax(sr, n_mel, window, extra, rng):
    wav = _noise(rng, sr)
    kw = dict(n_mel=n_mel, precision="parity", **WINDOWS[window], **extra)
    want = np.asarray(msv_tpu.log_mel_spectrogram(wav, sr, **kw))
    got = _port(wav, sr, **kw)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("n_mel", [64, 128])
@pytest.mark.parametrize("sr", [8000, 16000])
def test_fast_matches_jax(sr, n_mel, window, rng):
    from msv_tpu.config import set_engine

    wav = _noise(rng, sr)
    kw = dict(n_mel=n_mel, **WINDOWS[window])
    set_engine("pallas")  # the fused route with bf16 operands, interpreted
    try:
        want = np.asarray(msv_tpu.log_mel_spectrogram(wav, sr, **kw))
    finally:
        set_engine("auto")
    got = _port(wav, sr, **kw)  # precision=None: fast
    d = np.abs(got - want)
    print(f"fast features {sr} Hz n_mel {n_mel} {window}: max {d.max():.3g} "
          f"dB, p99 {np.percentile(d, 99):.3g} dB")
    if window == "40/10":
        assert d.max() < GREY_STEP
        assert np.percentile(d, 99) < 0.01
    else:
        assert np.percentile(d, 99) < GREY_STEP


def test_fused_route_launches_the_mode_kernel(rng, monkeypatch):
    """amp_db magnitude goes through the kernel wrapper in the chosen mode
    with its operands (on the CPU the mode's C, S and fb), one (B, L)
    call; other routes do not."""
    from msv_tpu_torch import features

    seen = []
    real = K.mel_spectrogram_cuda

    def spy(padded, *ops, **kw):
        seen.append((tuple(padded.shape), kw["mode"], ops[0].dtype,
                     ops[2].dtype))
        return real(padded, *ops, **kw)

    monkeypatch.setattr(features, "mel_spectrogram_cuda", spy)
    wav = _noise(rng, 8000, batch=3)
    _port(wav, 8000, n_mel=32)
    _port(wav, 8000, n_mel=32, precision="parity")
    _port(wav, 8000, n_mel=32, log="power_db")
    assert seen == [((3, 8200), "fast", torch.bfloat16, torch.bfloat16),
                    ((3, 8200), "parity", torch.float32, torch.float32)]


def test_default_follows_explicit_global_precision(rng):
    """precision=None defaults to 'fast', but an explicit session-wide
    set_precision_mode('parity') wins (tests/test_features.py:195-222)."""
    sr = 8000
    wav = _noise(rng, sr, batch=1)[0]
    parity = _port(wav, sr, precision="parity")
    fast = _port(wav, sr, precision="fast")
    assert not np.array_equal(parity, fast)
    assert not tcfg.precision_mode_is_explicit()
    np.testing.assert_array_equal(_port(wav, sr), fast)
    tcfg.set_precision_mode("parity")
    np.testing.assert_array_equal(_port(wav, sr), parity)
    tcfg.set_precision_mode("fast")
    np.testing.assert_array_equal(_port(wav, sr), fast)
    with pytest.raises(ValueError):
        _port(wav, sr, precision="double")


def test_ragged_matches_individual_calls(rng):
    sr = 8000
    lens = [8000, 8000, 5000, 12345, 8000]
    wavs = [(rng.standard_normal(n) * (0.1 + 0.2 * i)).astype(np.float32)
            for i, n in enumerate(lens)]
    got = msv_tpu_torch.log_mel_spectrogram_ragged(wavs, sr, n_mel=48,
                                                   device="cpu")
    assert len(got) == len(wavs)
    for w, f in zip(wavs, got):
        np.testing.assert_array_equal(f, _port(w, sr, n_mel=48))
    got_t = msv_tpu_torch.log_mel_spectrogram_ragged(
        wavs, sr, n_mel=48, top_db=30.0, device="cpu")
    for w, f in zip(wavs, got_t):
        np.testing.assert_array_equal(f, _port(w, sr, n_mel=48, top_db=30.0))
        assert f.min() >= f.max() - 30.0
    with pytest.raises(ValueError, match="mono"):
        msv_tpu_torch.log_mel_spectrogram_ragged([np.zeros((2, 100))], sr)


def test_tensor_input_is_padded_on_its_device(rng):
    sr = 8000
    wav = _noise(rng, sr)
    for kw in (dict(n_mel=48), dict(n_mel=48, log="ln")):
        host = _port(wav, sr, **kw)
        dev = msv_tpu_torch.log_mel_spectrogram(torch.from_numpy(wav), sr,
                                                **kw)
        assert dev.device.type == "cpu"
        np.testing.assert_array_equal(dev.numpy(), host)


def test_short_signal_contract(rng):
    wav = (rng.standard_normal(10) * 0.3).astype(np.float32)
    with pytest.raises(ValueError, match="too short"):
        _port(wav, 8000, win_ms=25.0)
    with pytest.raises(ValueError, match="too short"):
        msv_tpu_torch.log_mel_spectrogram(torch.from_numpy(wav)[None], 8000,
                                          win_ms=25.0)


def test_numpy_input_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        msv_tpu_torch.log_mel_spectrogram(np.zeros(8000, np.float32), 8000)
