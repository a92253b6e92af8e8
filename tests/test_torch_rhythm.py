"""The port's rhythm analysis (``msv_tpu_torch/ops/rhythm.py``, on the CPU)
against ``msv_tpu/ops/rhythm.py`` and its numpy oracle.

Tolerances are tests/test_rhythm.py's: the tempogram against the direct
O(W^2) ACF oracle and against msv_tpu at atol 5e-5 (:40), lag 0 within
1e-4 of 1 (:49).  Tempo and beat frames of test_rhythm.py's click trains
equal msv_tpu's exactly, from envelopes and from audio (the port's
onset envelope through its default fast precision, msv_tpu's in f32 on
its CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch.ops import rhythm as T  # noqa: E402

try:
    from msv_tpu.ops import rhythm as J
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _reference(request):
    """The JAX reference is absent where the card-only tests run: there
    only the tests marked ``gpu`` (which compare card and CPU) run."""
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _click_env(n, period, amp=1.0, noise=0.0, rng=None):
    env = np.zeros(n, np.float32)
    env[::period] = amp
    if noise and rng is not None:
        env += noise * np.abs(rng.standard_normal(n)).astype(np.float32)
    return env


def _click_audio(sr=8000, dur=10.0, bps=2.0):
    """tests/test_rhythm.py:146's 120 BPM click train over a quiet tone."""
    n = int(dur * sr)
    x = 0.003 * np.sin(2 * np.pi * 220 * np.arange(n) / sr)
    for t0 in np.arange(0.25, dur - 0.5, 1.0 / bps):
        i = int(t0 * sr)
        x[i:i + 64] += 0.8 * np.hanning(64)
    return x.astype(np.float32)


@pytest.mark.parametrize("win,hop", [(64, 1), (64, 3), (96, 7), (384, 1)])
def test_tempogram_matches_oracle_and_jax(win, hop, rng):
    env = np.abs(rng.standard_normal(300)).astype(np.float32)
    env[::23] += 4.0
    got = T.tempogram_from_envelope(env, 100.0, win_length=win, hop=hop,
                                    **CPU).numpy()
    want = T.oracle_tempogram_np(env, win, hop)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-5)
    np.testing.assert_allclose(got, np.asarray(J.tempogram_from_envelope(
        env, 100.0, win_length=win, hop=hop)), atol=5e-5)
    np.testing.assert_array_equal(want, J.oracle_tempogram_np(env, win, hop))


def test_tempogram_lag0_range_and_validation(rng):
    env = np.abs(rng.standard_normal(500)).astype(np.float32)
    tg = T.tempogram_from_envelope(torch.from_numpy(env), 100.0,
                                   win_length=128).numpy()
    assert tg.shape == (501, 128)
    np.testing.assert_allclose(tg[64:-64, 0], 1.0, atol=1e-4)
    assert np.all(tg <= 1.0 + 1e-4)
    for kw, x in (({"win_length": 2}, np.ones(10)), ({"hop": 0}, np.ones(10)),
                  ({}, np.ones((4, 4))), ({}, np.empty(0))):
        with pytest.raises(ValueError):
            T.tempogram_from_envelope(x.astype(np.float32), 100.0, **kw,
                                      **CPU)


@pytest.mark.parametrize("period", [50, 60, 40, 100])
def test_tempo_and_beats_of_click_trains_equal_jax(period, rng):
    env = _click_env(2000, period, noise=0.02, rng=rng)
    tg = T.tempogram_from_envelope(env, 100.0, **CPU).numpy()
    assert T.tempo_from_tempogram(tg, 100.0) == J.tempo_from_tempogram(
        np.asarray(J.tempogram_from_envelope(env, 100.0)), 100.0)
    bpm, beats = T.beat_track_from_envelope(env, 100.0, **CPU)
    jbpm, jbeats = J.beat_track_from_envelope(env, 100.0)
    assert bpm == jbpm and beats.dtype == np.int64
    np.testing.assert_array_equal(beats, jbeats)
    assert bpm == pytest.approx(6000.0 / period, rel=0.03)


def test_beat_track_edges_equal_jax(rng):
    env = _click_env(1500, 60, noise=0.01, rng=rng)
    for kw in ({"bpm": 100.0}, {"bpm": 100.0, "tightness": 10.0}):
        got = T.beat_track_from_envelope(env, 100.0, **kw, **CPU)
        want = J.beat_track_from_envelope(env, 100.0, **kw)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    for env in (np.zeros(500, np.float32), np.empty(0, np.float32)):
        bpm, beats = T.beat_track_from_envelope(env, 100.0, **CPU)
        assert beats.size == 0 and beats.dtype == np.int64
    assert T.tempo_from_tempogram(np.ones((4, 4), np.float32), 1.0,
                                  min_bpm=300.0, max_bpm=320.0) == 0.0


def test_beat_track_from_audio_equals_jax():
    x = _click_audio()
    bpm, beats = T.beat_track(x, 8000, **CPU)
    jbpm, jbeats = J.beat_track(x, 8000)
    assert bpm == jbpm == pytest.approx(120.0, rel=0.05)
    np.testing.assert_array_equal(beats, jbeats)
    # a tensor stays on its device; a batch is refused
    bpm2, beats2 = T.beat_track(torch.from_numpy(x), 8000)
    assert bpm2 == bpm
    np.testing.assert_array_equal(beats2, beats)
    with pytest.raises(ValueError):
        T.beat_track(np.stack([x, x]), 8000, **CPU)


@pytest.mark.gpu
def test_rhythm_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _click_audio()
    bpm, beats = T.beat_track(x, 8000)
    cbpm, cbeats = T.beat_track(x, 8000, **CPU)
    assert bpm == cbpm
    np.testing.assert_array_equal(beats, cbeats)
    env = np.abs(np.random.default_rng(1).standard_normal(700)).astype(
        np.float32)
    np.testing.assert_allclose(
        T.tempogram_from_envelope(env, 100.0).cpu().numpy(),
        T.tempogram_from_envelope(env, 100.0, **CPU).numpy(), atol=5e-5)
