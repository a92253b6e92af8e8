"""The port's linear frequency scale against the JAX package: the STFT ops
(``ops/stft.py``), ``spec_pipeline`` (``kernels/pipeline.py``), linear
streaming, and a linear ``MultiTrack`` with ``set_setting`` and
``save_session`` / ``load_session``.

Tolerances: the impulse golden of tests/test_stft.py:19 bit-equal to
msv_tpu's output (real parts exactly the golden's); STFT values within
tests/test_stft.py's atol 2e-5; dB planes within atol 2e-3 dB, rtol 1e-4
(f32 GEMMs summed in another order: tests/test_pallas_kernel.py:65's
bound).  A linear plane has no mel band to average a DFT bin's null away,
so whole planes are held to chip_smoke's ``f32_agree`` rule: atol/rtol, or,
in a bin 60 dB or more under its frame's peak, within 1e-6 of that peak in
amplitude, for at most 0.1% of bins (the same f32 summation-order effect,
tests/test_torch_null_bins.py).  rgb images within one u8 step per
channel.  Inputs are made with numpy from seeds; everything runs on the
CPU.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import msv_tpu  # noqa: E402
import msv_tpu_torch  # noqa: E402
from msv_tpu.io.audio import write_wav  # noqa: E402
from msv_tpu.kernels import pipeline as jpipe  # noqa: E402
from msv_tpu.ops import stft as jstft  # noqa: E402
from msv_tpu.parallel import streaming as jstream  # noqa: E402
from msv_tpu_torch.kernels import pipeline as tpipe  # noqa: E402
from msv_tpu_torch.kernels import spectrogram_cuda as K  # noqa: E402
from msv_tpu_torch.ops import stft as tstft  # noqa: E402
from msv_tpu_torch.ops.dft import windowed_dft_matrices  # noqa: E402
from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center  # noqa: E402
from msv_tpu_torch.ops.mel import calc_mel_fb_default  # noqa: E402
from msv_tpu_torch.ops.windows import default_stft_window  # noqa: E402
from msv_tpu_torch.parallel import streaming as tstream  # noqa: E402

ATOL, RTOL = 2e-3, 1e-4
LINEAR = msv_tpu_torch.SpecSetting(freq_scale=msv_tpu_torch.FreqScale.LINEAR)
J_LINEAR = msv_tpu.SpecSetting(freq_scale=msv_tpu.FreqScale.LINEAR)
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def _agree(got, want, what="plane"):
    """f32_agree on two dB planes (numpy or tensors)."""
    cs.check_f32(torch.as_tensor(np.array(got)),
                 torch.as_tensor(np.array(want)), what)


def _ops(win, n_fft, sr=None):
    c, s = windowed_dft_matrices(default_stft_window(win, n_fft), n_fft)
    return c, s, (calc_mel_fb_default(sr, n_fft) if sr else None)


# ------------------------------------------------------------------- stft


def test_stft_impulse_golden_exact():
    x = np.zeros(4, np.float32)
    x[2] = 1
    got = tstft.perform_stft(x, 4, 2, 4, device="cpu")
    want = np.array([[0.0, 0.0, 0.0], [0.25, -0.25, 0.25],
                     [0.25, -0.25, 0.25]], dtype=np.complex64)
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jstft.perform_stft(x, 4, 2, 4)))
    np.testing.assert_array_equal(got.real.numpy(), want.real)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("L,win,hop,n_fft", [(1000, 320, 80, 512),
                                             (777, 100, 25, 128),
                                             (3000, 400, 160, 512)])
def test_perform_stft_and_magnitude_match_jax(L, win, hop, n_fft, rng):
    wav = rng.standard_normal(L).astype(np.float32)
    got = tstft.perform_stft(wav, win, hop, n_fft, device="cpu").numpy()
    want = np.asarray(jstft.perform_stft(wav, win, hop, n_fft))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)
    mag, nf = tstft.stft_magnitude(wav, win, hop, n_fft, device="cpu")
    jmag, jnf = jstft.stft_magnitude(wav, win, hop, n_fft)
    assert nf == jnf and mag.shape == jmag.shape
    np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), atol=2e-5)


def test_custom_window_and_validation(rng):
    wav = rng.standard_normal(256).astype(np.float32)
    w = np.hamming(64).astype(np.float32)
    got = tstft.perform_stft(wav, 64, 16, 64, window=w, device="cpu")
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jstft.perform_stft(wav, 64, 16, 64,
                                                   window=w)), atol=2e-5)
    with pytest.raises(ValueError):
        tstft.perform_stft(wav, 64, 16, 64, window=np.ones(32, np.float32),
                           device="cpu")


@pytest.mark.parametrize("L,win,hop,n_fft,custom", [
    (1000, 320, 80, 512, False), (777, 100, 25, 128, False),
    (640, 128, 32, 128, True)])
def test_inverse_stft_matches_jax_and_roundtrips(L, win, hop, n_fft, custom,
                                                 rng):
    wav = (rng.standard_normal(L) * 0.5).astype(np.float32)
    w = np.hanning(win).astype(np.float32) + 0.01 if custom else None
    spec = tstft.perform_stft(wav, win, hop, n_fft, window=w, device="cpu")
    got = tstft.inverse_stft(spec, win, hop, n_fft, window=w, length=L)
    want = np.asarray(jstft.inverse_stft(
        jstft.perform_stft(wav, win, hop, n_fft, window=w), win, hop, n_fft,
        window=w, length=L))
    assert got.shape == (L,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    inner = slice(win, L - win)
    np.testing.assert_allclose(got.numpy()[inner], wav[inner], atol=1e-4)
    # a (re, im) pair and a numpy array take the same route
    pair = tstft.inverse_stft((spec.real, spec.imag), win, hop, n_fft,
                              window=w, length=L)
    arr = tstft.inverse_stft(spec.numpy(), win, hop, n_fft, window=w,
                             length=L, device="cpu")
    assert torch.equal(pair, got) and torch.equal(arr, got)


def test_fft_module_injection(rng):
    wav = (rng.standard_normal(1000) * 0.5).astype(np.float32)
    win, hop, n_fft = 320, 80, 512
    base = tstft.perform_stft(wav, win, hop, n_fft, device="cpu").numpy()
    calls = []

    def rfft_module(frames):
        calls.append(tuple(frames.shape))
        return np.fft.rfft(frames.numpy(), axis=1)

    via = tstft.perform_stft(wav, win, hop, n_fft, fft_module=rfft_module,
                             device="cpu")
    assert calls == [(base.shape[0], n_fft)]
    np.testing.assert_allclose(via.numpy(), base, atol=2e-6)

    class Module:  # RealFFT-shaped object
        def process(self, frames):
            return torch.fft.rfft(frames, dim=1)

    via_obj = tstft.perform_stft(wav, win, hop, n_fft, fft_module=Module(),
                                 device="cpu")
    np.testing.assert_allclose(via_obj.numpy(), base, atol=2e-6)
    np.testing.assert_allclose(
        via_obj.numpy(), np.asarray(jstft.perform_stft(
            wav, win, hop, n_fft, fft_module=lambda f: np.fft.rfft(f, axis=1))),
        atol=2e-6)
    with pytest.raises(TypeError):
        tstft.perform_stft(wav, win, hop, n_fft, fft_module=object(),
                           device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tstft.perform_stft(wav, win, hop, n_fft, device="cpu",
                           fft_module=lambda f: f[:, : n_fft // 2])


# -------------------------------------------------------------- pipeline


@pytest.mark.parametrize("use_mel", [False, True])
@pytest.mark.parametrize("sr", [8000, 22050])
def test_spec_pipeline_matches_jax(sr, use_mel, rng):
    p = msv_tpu_torch.derive_stft_params(sr, msv_tpu_torch.SpecSetting())
    win, hop = p.win_length, p.hop_length
    c, s, fb = _ops(win, p.n_fft, sr)
    wav = (rng.standard_normal(int(0.4 * sr)) * 8000).astype(np.int16)
    n_valid = n_frames_for(len(wav), win, hop)
    n_frames = 256
    padded = reflect_pad_center(wav, win)
    padded = np.pad(padded, (0, (n_frames - 1) * hop + win - len(padded)))
    kw = dict(win=win, hop=hop, n_frames=n_frames, use_mel=use_mel,
              mode="parity")
    got = tpipe.spec_pipeline(torch.from_numpy(padded),
                              *K.operands_from_numpy(c, s, fb), n_valid, **kw)
    want = jpipe.spec_pipeline(jnp.asarray(padded), jnp.asarray(c),
                               jnp.asarray(s), jnp.asarray(fb),
                               jnp.int32(n_valid), **kw)
    assert got[0].shape == (n_frames, fb.shape[1] if use_mel else c.shape[1])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL, rtol=RTOL)
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g) - float(w)) <= ATOL + RTOL * abs(float(w))
    with pytest.raises(ValueError, match="precision mode"):
        tpipe.spec_pipeline(torch.from_numpy(padded),
                            *K.operands_from_numpy(c, s, fb), n_valid,
                            **dict(kw, mode=None))


def test_spec_pipeline_batched_rows_equal_single_calls(rng):
    win, hop, n_fft = 320, 80, 512
    c, s, _ = _ops(win, n_fft)
    ops = K.operands_from_numpy(c, s, c[:, :2])
    rows = (rng.standard_normal((2, 9300)) * 0.3).astype(np.float32)
    n_valid = [111, 97]
    kw = dict(win=win, hop=hop, n_frames=112, use_mel=False, mode="fast")
    db, smin, smax = tpipe.spec_pipeline_batched(
        torch.from_numpy(rows), *ops, torch.tensor(n_valid), **kw)
    for b in range(2):
        one = tpipe.spec_pipeline(torch.from_numpy(rows[b]), *ops,
                                  n_valid[b], **kw)
        torch.testing.assert_close(db[b], one[0], atol=1e-4, rtol=1e-6)
        assert abs(smin[b] - one[1]) <= 1e-4 and abs(smax[b] - one[2]) <= 1e-4
    j = jpipe.spec_pipeline_batched(
        jnp.asarray(rows), jnp.asarray(c), jnp.asarray(s),
        jnp.zeros((1, 1), jnp.float32), jnp.asarray(n_valid), **kw)
    np.testing.assert_allclose(db.numpy(), np.asarray(j[0]), atol=ATOL,
                               rtol=RTOL)


# -------------------------------------------------------------- streaming


@pytest.mark.parametrize("impl,carrier", [("dft", "i16"), ("dft", "f32"),
                                          ("fft", "i16"), ("dft", "i32")])
def test_linear_streaming_matches_jax_and_one_shot(impl, carrier, rng):
    win, hop, n_fft = 320, 80, 512
    c, s, _ = _ops(win, n_fft)
    window = default_stft_window(win, n_fft)
    n = 80 * 700 + 123
    x = (rng.standard_normal(n) * 6000).astype(np.int16)
    scale = 2.0**-15
    if carrier == "f32":
        x = x.astype(np.float32) * np.float32(scale)
    elif carrier == "i32":  # a two-channel sum, 2^-15 units
        x = x.astype(np.int32) * 2
    kw = dict(chunk_frames=64, seg_chunks=4, n_fft=n_fft, window=window,
              impl=impl)
    got = tstream.streaming_spec_db(x, win, hop, c, s, None, keep_wav=True,
                                    device="cpu", **kw)
    want = jstream.streaming_spec_db(x, win, hop, c, s, None, **kw)
    db, nf = got[0], got[1]
    assert db.shape == tuple(np.asarray(want[0]).shape) == (db.shape[0], 257)
    assert nf == want[1] == n_frames_for(n, win, hop)
    _agree(db[:nf], np.asarray(want[0])[:nf])
    for g, w in zip(got[2:4], want[2:4]):
        assert abs(g - w) <= ATOL + RTOL * abs(w)
    # one one-shot plane of the whole wave
    f32 = x.astype(np.float32) * np.float32(scale) if carrier != "f32" else x
    padded = torch.from_numpy(reflect_pad_center(f32, win))
    one = tpipe.spec_pipeline(padded, *K.operands_from_numpy(c, s, c[:, :1]),
                              nf, win=win, hop=hop, n_frames=nf,
                              use_mel=False, mode="parity")[0]
    _agree(db[:nf], one)
    half = win // 2
    wave = got[4][half : half + n]
    assert wave.dtype == (torch.int16 if carrier == "i16" else torch.float32)
    np.testing.assert_array_equal(
        (wave.float() * scale if carrier == "i16" else wave).numpy(),
        f32.astype(np.float32))


# ---------------------------------------------------------------- session


def _tone(sr, seconds, f0):
    t = np.arange(int(seconds * sr)) / sr
    return (0.4 * np.sin(2 * np.pi * f0 * t) * (0.6 + 0.4 * np.sin(5 * t))
            + 0.1 * np.sin(2 * np.pi * 2.7 * f0 * t)).astype(np.float32)


@pytest.fixture(scope="module")
def linear_paths(tmp_path_factory):
    rng = np.random.default_rng(20261018)
    d = tmp_path_factory.mktemp("torch_linear")
    paths = []
    for i, (sr, bits) in enumerate([(8000, 16), (16000, 16), (16000, 16),
                                    (22050, 32)]):
        x = _tone(sr, 1.3, 250 + 70 * i)
        x += 0.02 * rng.standard_normal(len(x)).astype(np.float32)
        p = str(d / f"l{i}.wav")
        write_wav(p, np.stack([x, 0.3 * x]) if i == 2 else x, sr, bits=bits)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def linear_sessions(linear_paths):
    ids = list(range(len(linear_paths)))
    ref = msv_tpu.MultiTrack(J_LINEAR)
    ref.add_tracks(ids, linear_paths)
    port = msv_tpu_torch.MultiTrack(LINEAR, device="cpu")
    port.add_tracks(ids, linear_paths)
    return ref, port


def _close_u8(a, b, steps=1):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= steps


@pytest.mark.parametrize("tid", range(4))
def test_linear_session_matches_jax(linear_sessions, tid):
    ref, port = linear_sessions
    got, want = port.get_spec_db(tid), ref.get_spec_db(tid)
    n_freq = port.tracks[tid].n_fft // 2 + 1
    assert got.shape == want.shape and got.shape[1] == n_freq
    assert port._state[tid].n_out == n_freq
    _agree(got, want)
    _close_u8(port.get_spec_image(tid, 100.0, 90, wire="rgb"),
              ref.get_spec_image(tid, 100.0, 90, wire="rgb"))
    _close_u8(port.get_spec_image_crop(tid, 300.0, 70, 0.2, 0.9, wire="rgb"),
              ref.get_spec_image_crop(tid, 300.0, 70, 0.2, 0.9, wire="rgb"))
    assert port._up_ratio(port.tracks[tid].sr) == ref._up_ratio(
        ref.tracks[tid].sr)
    assert port.get_frequency_hz(tid, 0.37) == ref.get_frequency_hz(tid, 0.37)
    for g, w in ((port.get_max_db(), ref.get_max_db()),
                 (port.get_min_db(), ref.get_min_db())):
        assert abs(g - w) <= ATOL + RTOL * abs(w)


def test_linear_session_launches_no_kernel(linear_paths, monkeypatch):
    calls = []
    real = tpipe.spec_pipeline_batched
    from msv_tpu_torch.session import multitrack as tmt

    monkeypatch.setattr(tmt, "mel_spectrogram_cuda",
                        lambda *a, **k: pytest.fail("mel kernel launched"))
    monkeypatch.setattr(tmt, "spec_pipeline_batched",
                        lambda w, *a, **k: calls.append(w.shape[0])
                        or real(w, *a, **k))
    mt = msv_tpu_torch.MultiTrack(LINEAR, device="cpu")
    mt.add_tracks(list(range(4)), linear_paths)
    assert sorted(calls) == [1, 1, 1, 1] or sorted(calls) == [1, 1, 2]


def test_linear_streamed_track_matches_one_shot(linear_paths, monkeypatch):
    from msv_tpu_torch.session import multitrack as tmt

    one = msv_tpu_torch.MultiTrack(LINEAR, device="cpu")
    one.add_tracks([0], [linear_paths[2]])
    monkeypatch.setattr(tmt, "STREAMING_FRAME_THRESHOLD", 4)
    streamed = msv_tpu_torch.MultiTrack(LINEAR, device="cpu")
    streamed.add_tracks([0], [linear_paths[2]])
    assert streamed._state[0].n_frames_pad % 4096 == 0
    assert streamed._env_states[0].origin == "adopted"
    _agree(streamed.get_spec_db(0), one.get_spec_db(0))
    np.testing.assert_array_equal(
        streamed.get_wav_image(0, 200.0, 60, -1.0, 1.0),
        one.get_wav_image(0, 200.0, 60, -1.0, 1.0))


def test_set_setting_mel_linear_mel(linear_paths):
    ids = list(range(4))
    mel = msv_tpu_torch.MultiTrack(device="cpu")
    mel.add_tracks(ids, linear_paths)
    mel_db = mel.get_spec_db(1)
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks(ids, linear_paths, channels=[None, None, 1, None])
    mt.get_wav_image(0, 100.0, 40, -1.0, 1.0)
    assert mt._env_states
    mt.set_setting(LINEAR)
    assert mt._env_states == {} and sorted(mt.tracks) == ids
    assert mt.get_channel(2) == 1
    assert all(ops["parity"][2] is None for ops in mt._operands.values())
    lin = msv_tpu.MultiTrack(J_LINEAR)
    lin.add_tracks(ids, linear_paths, channels=[None, None, 1, None])
    for tid in ids:
        _agree(mt.get_spec_db(tid), lin.get_spec_db(tid))
    mt.set_setting(msv_tpu_torch.SpecSetting())
    assert mt._state[1].n_out == mel_db.shape[1]
    np.testing.assert_array_equal(mt.get_spec_db(1), mel_db)
    empty = msv_tpu_torch.MultiTrack(device="cpu")
    assert empty.set_setting(LINEAR) == msv_tpu.MultiTrack().set_setting(
        J_LINEAR)
    assert empty.tracks == {} and empty.setting == LINEAR


@pytest.mark.parametrize("version", [1, 2])
def test_save_load_round_trip(linear_paths, tmp_path, version):
    mt = msv_tpu_torch.MultiTrack(
        msv_tpu_torch.SpecSetting(win_ms=30.0, freq_scale=
                                  msv_tpu_torch.FreqScale.LINEAR,
                                  db_range=90.0), device="cpu")
    mt.add_tracks([3, 5], [linear_paths[0], linear_paths[2]],
                  channels=[None, 0 if version == 2 else None])
    path = str(tmp_path / "session.json")
    mt.save_session(path)
    with open(path) as f:
        m = json.load(f)
    assert m["version"] == 2 and m["setting"]["freq_scale"] == "linear"
    if version == 1:  # plain path strings, as msv_tpu's v1 wrote them
        m["version"] = 1
        m["tracks"] = {k: v["path"] for k, v in m["tracks"].items()}
        with open(path, "w") as f:
            json.dump(m, f)
    back = msv_tpu_torch.MultiTrack.load_session(path, device="cpu")
    assert back.setting == mt.setting and sorted(back.tracks) == [3, 5]
    assert back.get_channel(5) == mt.get_channel(5)
    for tid in (3, 5):
        assert back.get_path(tid) == mt.get_path(tid)
        np.testing.assert_array_equal(back.get_spec_db(tid),
                                      mt.get_spec_db(tid))
    assert (back.get_max_db(), back.get_min_db()) == (mt.get_max_db(),
                                                      mt.get_min_db())
    # msv_tpu reads the port's manifest, and the port reads msv_tpu's
    ref = msv_tpu.MultiTrack.load_session(path)
    assert sorted(ref.tracks) == [3, 5]
    jpath = str(tmp_path / "jax_session.json")
    ref.save_session(jpath)
    again = msv_tpu_torch.MultiTrack.load_session(jpath, device="cpu")
    assert os.path.basename(again.get_path(5)) == os.path.basename(
        linear_paths[2])
    _agree(again.get_spec_db(3), ref.get_spec_db(3))
