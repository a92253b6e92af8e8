"""The port's segmented streaming (on the CPU, through the kernels' plain
versions) against the JAX package's ``parallel/streaming.py`` and, for
long tracks, against its MultiTrack.

Parity mode is held to the kernel bound of tests/test_pallas_kernel.py
(atol 2e-3 dB, rtol 1e-4: the JAX streaming core takes log10 dB through
XLA, the port ln*20/ln10 through the kernel's function); fast mode to the
Pallas kernel with bf16 operands with max < 0.47 dB (one 120 dB / 255 grey
step) and p99 < 0.01 dB.
"""

import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference: absent where the card-only tests run
pytest.importorskip("jax")

import msv_tpu  # noqa: E402
import msv_tpu_torch  # noqa: E402
from msv_tpu.parallel import streaming as jstream  # noqa: E402
from msv_tpu_torch.config import (SpecSetting, derive_stft_params,  # noqa: E402
                                  precision_mode_scope)
from msv_tpu_torch.io.audio import write_wav  # noqa: E402
from msv_tpu_torch.kernels import spectrogram_cuda as K  # noqa: E402
from msv_tpu_torch.ops.dft import windowed_dft_matrices  # noqa: E402
from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center  # noqa: E402
from msv_tpu_torch.ops.mel import calc_mel_fb_default  # noqa: E402
from msv_tpu_torch.ops.windows import default_stft_window  # noqa: E402
from msv_tpu_torch.parallel import streaming as tstream  # noqa: E402
from msv_tpu_torch.session import multitrack as tmt  # noqa: E402

ATOL, RTOL = 2e-3, 1e-4
GREY_STEP = 0.47
SR = 8000
CHUNK, SEG = 256, 2  # segments of 512 frames
# three full segments and a one-chunk tail: plan [2, 2, 2, 1]
N_FRAMES = 3 * CHUNK * SEG + 100


def _setup(sr=SR):
    p = derive_stft_params(sr, SpecSetting())
    c, s = windowed_dft_matrices(default_stft_window(p.win_length, p.n_fft),
                                 p.n_fft)
    return p.win_length, p.hop_length, c, s, calc_mel_fb_default(sr, p.n_fft)


def _samples(rng, n_frames=N_FRAMES, hop=80):
    n = (n_frames - 1) * hop
    t = np.arange(n) / SR
    sig = 0.3 * np.sin(2 * np.pi * (300 + 40 * np.sin(0.7 * t)) * t)
    return sig + 0.05 * rng.standard_normal(n)


def _carrier(rng, kind):
    """(samples, scale): an int16 PCM carrier, an int32 carrier at 2^-16
    (a channel sum's range), or f32."""
    x = _samples(rng)
    if kind == "i16":
        return np.round(x * 2**15).astype(np.int16), 2.0**-15
    if kind == "i32":
        return np.round(x * 2**16).astype(np.int32), 2.0**-16
    return x.astype(np.float32), 2.0**-15


@pytest.mark.parametrize("name", ["_seg_plan_for", "padded_slice"])
def test_helpers_have_the_source_text_of_their_originals(name):
    assert (inspect.getsource(getattr(tstream, name))
            == inspect.getsource(getattr(jstream, name)))


def test_plan_has_a_one_chunk_tail():
    assert tstream._seg_plan_for(N_FRAMES, CHUNK, SEG) == [2, 2, 2, 1]


@pytest.mark.parametrize("kind", ["i16", "i32", "f32"])
def test_streaming_matches_jax_dft(kind, rng):
    win, hop, c, s, fb = _setup()
    wav, scale = _carrier(rng, kind)
    kw = dict(chunk_frames=CHUNK, seg_chunks=SEG, scale=scale)
    ref = jstream.streaming_spec_db(wav, win, hop, c, s, fb, transfer="raw",
                                    **kw)
    got = tstream.streaming_spec_db(wav, win, hop, c, s, fb, device="cpu",
                                    **kw)
    assert got[1] == ref[1] == n_frames_for(len(wav), win, hop)
    assert tuple(got[0].shape) == tuple(ref[0].shape)
    n = got[1]
    np.testing.assert_allclose(got[0][:n].numpy(), np.asarray(ref[0])[:n],
                               atol=ATOL, rtol=RTOL)
    for g, r in zip(got[2:], ref[2:]):
        assert abs(g - r) <= ATOL + RTOL * abs(r), (g, r)


def test_streaming_fast_matches_jax_pallas_fast(rng):
    win, hop, c, s, fb = _setup()
    wav, _ = _carrier(rng, "i16")
    kw = dict(chunk_frames=CHUNK, seg_chunks=SEG)
    from msv_tpu.config import precision_mode_scope as jax_scope

    with jax_scope("fast"):
        ref = jstream.streaming_spec_db(wav, win, hop, c, s, fb,
                                        impl="pallas", **kw)
    with precision_mode_scope("fast"):
        got = tstream.streaming_spec_db(wav, win, hop, c, s, fb,
                                        impl="pallas", device="cpu", **kw)
    n = got[1]
    assert n == ref[1]
    d = np.abs(got[0][:n].numpy() - np.asarray(ref[0])[:n])
    print(f"fast streaming vs Pallas fast streaming: max {d.max():.3g} dB, "
          f"p99 {np.percentile(d, 99):.3g} dB")
    assert d.max() < GREY_STEP
    assert np.percentile(d, 99) < 0.01


@pytest.mark.parametrize("kind", ["i16", "f32"])
def test_keep_wav_returns_the_padded_wave(kind, rng):
    win, hop, c, s, fb = _setup()
    wav, _ = _carrier(rng, kind)
    db, n, _, _, wave = tstream.streaming_spec_db(
        wav, win, hop, c, s, fb, chunk_frames=CHUNK, seg_chunks=SEG,
        keep_wav=True, device="cpu")
    want = reflect_pad_center(wav, win)
    total = db.shape[0] * hop + (win - hop)
    assert wave.shape == (total,) and total >= len(want)
    np.testing.assert_array_equal(wave[: len(want)].numpy(), want)
    assert not wave[len(want):].any()


def test_mmap_equals_in_memory(tmp_path, rng):
    win, hop, c, s, fb = _setup()
    wav, _ = _carrier(rng, "i16")
    path = str(tmp_path / "long.wav")
    write_wav(path, wav.astype(np.float32) / 2**15, SR, bits=16)
    kw = dict(chunk_frames=CHUNK, seg_chunks=SEG, device="cpu")
    got = tstream.streaming_spec_db_mmap(path, win, hop, c, s, fb, **kw)
    want = tstream.streaming_spec_db(wav, win, hop, c, s, fb, **kw)
    assert torch.equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("kw,exc", [
    (dict(transfer="pack"), None),  # the wire codec: raw's plane
    (dict(transfer="pack1"), None),
    (dict(impl="fft"), ValueError),  # without n_fft and window
    (dict(mel_fb=None, impl="pallas"), ValueError),
    (dict(transfer="zip"), ValueError),
    (dict(impl="xla"), ValueError),
])
def test_unported_routes_raise(kw, exc, rng):
    """What no route takes raises; the packed transfers, refused before
    the wire codec was ported, give the raw transfer's plane."""
    win, hop, c, s, fb = _setup()
    args = dict(mel_fb=fb, device="cpu")
    args.update(kw)
    wav = (rng.standard_normal(4000) * 3000).astype(np.int16)
    if exc is None:
        got = tstream.streaming_spec_db(wav, win, hop, c, s, **args)
        args["transfer"] = "raw"
        want = tstream.streaming_spec_db(wav, win, hop, c, s, **args)
        assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
        return
    with pytest.raises(exc, match="unknown|requires"):
        tstream.streaming_spec_db(wav, win, hop, c, s, **args)


def test_numpy_operands_need_a_device():
    win, hop, c, s, fb = _setup()
    with pytest.raises(ValueError, match="device"):
        tstream.streaming_spec_db(np.zeros(4000, np.int16), win, hop, c, s,
                                  fb)


# ---------------------------------------------------------------- session


def _close_u8(a, b, steps=1):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= steps


def _close_db(got, want):
    assert abs(got - want) <= ATOL + RTOL * abs(want), (got, want)


@pytest.fixture(scope="module")
def long_sessions(tmp_path_factory):
    """A 340 s 8 kHz mono PCM16 track: 34 001 frames, over the streaming
    threshold, so the default plan is [8, 1]."""
    rng = np.random.default_rng(20261016)
    n = 340 * SR
    t = np.arange(n) / SR
    x = (0.3 * np.sin(2 * np.pi * (300 + 50 * np.sin(0.05 * t)) * t)
         + 0.05 * rng.standard_normal(n))
    path = str(tmp_path_factory.mktemp("torch_streaming") / "long.wav")
    write_wav(path, x.astype(np.float32), SR, bits=16)
    ref = msv_tpu.MultiTrack()
    ref.add_tracks([0], [path])
    port = msv_tpu_torch.MultiTrack(device="cpu")
    port.add_tracks([0], [path])
    return ref, port


def test_long_track_streams(long_sessions):
    _, port = long_sessions
    st = port._state[0]
    assert st.n_frames == 34001 > tmt.STREAMING_FRAME_THRESHOLD
    assert tstream._seg_plan_for(st.n_frames, 4096, 8) == [8, 1]
    assert st.n_frames_pad == 9 * 4096
    assert "add_tracks.streaming" in port.timer.summary()


def test_long_track_spec_db_matches(long_sessions):
    ref, port = long_sessions
    got, want = port.get_spec_db(0), ref.get_spec_db(0)
    assert got.shape == want.shape == (34001, 257)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert port._state[0].n_frames_pad == ref._state[0].n_frames_pad


def test_long_track_db_range_matches(long_sessions):
    ref, port = long_sessions
    _close_db(port.get_max_db(), ref.get_max_db())
    _close_db(port.get_min_db(), ref.get_min_db())


def test_long_track_image_within_one_step(long_sessions):
    ref, port = long_sessions
    _close_u8(port.get_spec_image(0, 10.0, 200, wire="rgb"),
              ref.get_spec_image(0, 10.0, 200, wire="rgb"))


def test_fast_mode_session_takes_the_bf16_operands(tmp_path, monkeypatch,
                                                   rng):
    """Under set_precision_mode("fast") every session launch, one-shot or
    streamed, gets mode="fast" and the bf16 operands, from the rate's route
    called in that mode; on the CPU as (C, S, fb) alone, since the CPU
    route reads no slabs."""
    seen = []
    real = K.mel_spectrogram_cuda

    def spy(padded, c, s, fb, **kw):
        seen.append((kw["mode"], c.dtype, s.dtype, fb.dtype))
        return real(padded, c, s, fb, **kw)

    monkeypatch.setattr(tmt, "mel_spectrogram_cuda", spy)
    monkeypatch.setattr(tstream, "mel_spectrogram_cuda", spy)
    monkeypatch.setattr(tmt, "STREAMING_FRAME_THRESHOLD", 300)
    paths = []
    for i, seconds in enumerate((2.0, 5.0)):  # 201 and 501 frames
        p = str(tmp_path / f"t{i}.wav")
        x = rng.standard_normal(int(seconds * SR)) * 0.2
        write_wav(p, x.astype(np.float32), SR, bits=16)
        paths.append(p)
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    with precision_mode_scope("fast"):
        mt.add_tracks([0, 1], paths)
    bf = torch.bfloat16
    assert seen == [("fast", bf, bf, bf),  # a group
                    ("fast", bf, bf, bf)]  # a segment
    assert mt._state[1].n_frames_pad == 4096  # the streamed one
    parity = msv_tpu_torch.MultiTrack(device="cpu")
    parity.add_tracks([0, 1], paths)
    for tid in (0, 1):
        d = np.abs(mt.get_spec_db(tid) - parity.get_spec_db(tid))
        assert np.percentile(d, 99) < GREY_STEP


@pytest.mark.parametrize("case", ["window", "c_rows", "route_win",
                                  "route_mode"])
def test_streaming_holds_its_operands_to_the_call(case, monkeypatch):
    """What streaming is given is held to the call: a ``window`` or C and
    S of another length than ``win`` raise ValueError (the segments are
    framed with ``win``), as does a route of another ``win``; a route
    given as ``c`` runs in the session's precision mode, the plane that of
    the same call on C, S and fb."""
    win, hop, c, s, fb = _setup()
    window = default_stft_window(win, 2 * (c.shape[-1] - 1))
    wav = (np.random.default_rng(4).standard_normal(SR) * 3000).astype(
        np.int16)
    route = K.MelRoute(window, fb, win=win, hop=hop,
                       n_fft=2 * (c.shape[-1] - 1), device="cpu")
    if case == "window":
        with pytest.raises(ValueError, match="a window of"):
            tstream.streaming_spec_db(wav, win, hop, c, s, fb,
                                      window=window[:-2], device="cpu")
    elif case == "c_rows":
        with pytest.raises(ValueError, match="rows for win"):
            tstream.streaming_spec_db(wav, win - 2, hop, c, s, fb,
                                      device="cpu")
    elif case == "route_win":
        with pytest.raises(ValueError, match="a route of win"):
            tstream.streaming_spec_db(wav, win - 2, hop, route, None, None)
    else:
        seen = []
        real = tstream.mel_spectrogram_cuda

        def spy(padded, c, s, fb, **kw):
            seen.append((kw["mode"], c.dtype))
            return real(padded, c, s, fb, **kw)

        monkeypatch.setattr(tstream, "mel_spectrogram_cuda", spy)
        for mode in ("fast", "parity"):
            with precision_mode_scope(mode):
                got = tstream.streaming_spec_db(wav, win, hop, route, None,
                                                None)[0]
                want = tstream.streaming_spec_db(wav, win, hop, c, s, fb,
                                                 device="cpu")[0]
            assert torch.equal(got, want), mode
        assert seen == [("fast", torch.bfloat16)] * 2 + [
            ("parity", torch.float32)] * 2
