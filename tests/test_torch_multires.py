"""The port's adaptive multi-resolution spectrogram (ops/multires.py) and
the session's adaptive renders, on the CPU, against msv_tpu's on the same
inputs (seeded numpy signals and synthetic WAVs).

The port's planes are held to msv_tpu's by chip_smoke's f32_agree rule
(atol 2e-3 dB + rtol 1e-4, or, 60 dB or more under the frame's peak,
within 1e-6 of that peak in amplitude); its own range form, stitched
crops and cached renders are held to its whole-track form bit for bit.
msv_tpu's multires digest (tests/test_multires.py:262) is not reproduced:
the port is held to msv_tpu's planes, not to the digest's bits.
"""

import importlib.util
import inspect
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference: absent where the card-only tests run
pytest.importorskip("jax")

import msv_tpu  # noqa: E402
import msv_tpu_torch  # noqa: E402
from msv_tpu.config import SpecSetting as JSetting  # noqa: E402
from msv_tpu.io.audio import write_wav  # noqa: E402
from msv_tpu.ops import multires as jm  # noqa: E402
from msv_tpu_torch.config import FreqScale, SpecSetting  # noqa: E402
from msv_tpu_torch.ops import multires as tm  # noqa: E402
from msv_tpu_torch.session import multitrack as tmt  # noqa: E402
from msv_tpu_torch.utils.errors import (AdaptiveBuildPending,  # noqa: E402
                                        MsvError)
from test_torch_session import _close_grey8, _close_u8  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

PINNED = ["_scale_params", "adaptive_auto_n_mel", "adaptive_frame_count",
          "_range_needs", "range_sample_window", "_padded_segment"]
# (sr, n_samples), n_frames away from msv_tpu's whole-form corner (within
# two of a multiple of 256), where it edge-pads and the port does not
RATES = [(8000, 24000), (16000, 20800), (22050, 15437)]


def _agree(got, want):
    """chip_smoke.f32_agree over a whole plane, floor share bounded."""
    got, want = torch.as_tensor(got), torch.from_numpy(np.array(want))
    assert got.shape == want.shape
    agree, close = cs.f32_agree(got, want)
    assert bool(agree.all()), (got - want).abs().max().item()
    assert int((agree & ~close).sum()) <= cs.FLOOR_SHARE * agree.numel()


@pytest.mark.parametrize("name", PINNED)
def test_numpy_helpers_are_verbatim_copies(name):
    assert (inspect.getsource(getattr(tm, name))
            == inspect.getsource(getattr(jm, name)))
    assert tm.BLEND_MARGIN == jm.BLEND_MARGIN


def test_scale_params_share_hop():
    hop, wins = tm._scale_params(16000, SpecSetting(), (1, 2, 4))
    assert hop == 160
    assert [w for w, _ in wins] == [640, 320, 160]


@pytest.mark.parametrize("sr,n", RATES)
def test_whole_track_form_matches_jax(sr, n, rng):
    wav = (rng.standard_normal(n) * 0.3).astype(np.float32)
    got, nf = tm.multires_mel_spec_db(wav, sr, SpecSetting(), n_mel=64,
                                      device="cpu")
    want, nf_j = jm.multires_mel_spec_db(wav, sr, JSetting(), n_mel=64)
    assert nf == nf_j and got.shape == (nf, 64)
    _agree(got, want)


def test_tonal_signal_matches_jax_within_60_db_of_the_frame_peak():
    """msv_tpu's digest signal: two pure tones and clicks, auto n_mel.
    Bins 100 dB and more under a frame's peak hold f32 summation noise of
    whole dB (each scale's plane, msv_tpu against the port: 3.6 dB), and
    the blend's weights, computed from the dB image, carry it to the blend
    (15.2 dB).  So the rule is f32_agree's own split: within DEEP_DB of the
    frame's peak max <= 0.47 dB (one grey step) and p99 <= 0.01 dB
    (measured on the CPU: max 0.0295 dB, p99 0.001 dB); deeper bins are not
    bounded."""
    sr = 16000
    t = np.arange(sr) / sr
    wav = (0.4 * np.sin(2 * np.pi * 440 * t)
           + 0.2 * np.sin(2 * np.pi * 3000 * t)).astype(np.float32)
    wav[::4000] += 0.5
    got, n = tm.multires_mel_spec_db(wav, sr, device="cpu")
    want = torch.from_numpy(np.array(jm.multires_mel_spec_db(wav, sr)[0]))
    assert got.shape == (101, 95) and n == 101
    near = want >= want.amax(dim=-1, keepdim=True) - cs.DEEP_DB
    err = (got - want).abs()[near]
    assert err.max().item() <= cs.GREY_STEP
    assert cs.quantile(err, 0.99) <= 0.01


@pytest.mark.parametrize("sr,n", RATES)
def test_range_form_matches_jax(sr, n, rng):
    wav = (rng.standard_normal(n) * 0.3).astype(np.float32)
    nf = tm.adaptive_frame_count(n, sr, SpecSetting())
    for f0, f1 in [(0, 7), (nf // 3, nf // 3 + 40), (nf - 6, nf)]:
        s0, s1 = tm.range_sample_window(n, sr, SpecSetting(), f0, f1)
        got, _ = tm.multires_mel_spec_db_range(
            wav[s0:s1], sr, f0, f1, setting=SpecSetting(), slice_start=s0,
            n_samples=n, n_mel=64, device="cpu")
        want, _ = jm.multires_mel_spec_db_range(
            wav[s0:s1], sr, f0, f1, setting=JSetting(), slice_start=s0,
            n_samples=n, n_mel=64)
        _agree(got, want)


def test_single_scale_is_plain_spectrogram(rng):
    wav = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    db1, n1 = tm.multires_mel_spec_db(wav, 16000, scales=(1,), n_mel=64,
                                      device="cpu")
    db3, n3 = tm.multires_mel_spec_db(wav, 16000, scales=(1, 1, 1),
                                      n_mel=64, device="cpu")
    assert n1 == n3
    # blending identical scales is the identity (convex combination)
    np.testing.assert_allclose(db1.numpy(), db3.numpy(), atol=1e-4)


def test_blend_is_convex_combination(rng):
    wav = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    kw = dict(n_mel=64, device="cpu")
    db, n = tm.multires_mel_spec_db(wav, 16000, scales=(1, 4), **kw)
    db_long, _ = tm.multires_mel_spec_db(wav, 16000, scales=(1,), **kw)
    db_short, _ = tm.multires_mel_spec_db(wav, 16000, scales=(4,), **kw)
    lo = torch.minimum(db_long, db_short)
    hi = torch.maximum(db_long, db_short)
    assert bool((db >= lo - 1e-3).all()) and bool((db <= hi + 1e-3).all())
    # and _blend itself, on planes that differ everywhere
    a = torch.from_numpy(rng.uniform(-100, 0, (3, 40, 16)).astype(np.float32))
    out = tm._blend(list(a), alpha=2.0)
    assert bool((out >= a.amin(0) - 1e-3).all())
    assert bool((out <= a.amax(0) + 1e-3).all())


# the last: 256 frames, msv_tpu's corner, where the port still holds
@pytest.mark.parametrize("sr,n", RATES + [(8000, 20400)])
def test_range_equals_whole_track_slice_bit_for_bit(sr, n, rng):
    wav = (rng.standard_normal(n) * 0.3).astype(np.float32)
    st = SpecSetting()
    full, nf = tm.multires_mel_spec_db(wav, sr, st, n_mel=64, device="cpu")
    ranges = [(0, nf), (0, 5), (nf - 5, nf), (nf // 3, nf // 3 + 40),
              (1, 2), (nf - 1, nf), (0, 1)]
    ranges += [tuple(sorted(rng.integers(0, nf, 2))) for _ in range(4)]
    for f0, f1 in ranges:
        if f1 == f0:
            f1 = f0 + 1
        s0, s1 = tm.range_sample_window(n, sr, st, f0, f1)
        db, _ = tm.multires_mel_spec_db_range(
            wav[s0:s1], sr, f0, f1, setting=st, slice_start=s0, n_samples=n,
            n_mel=64, device="cpu")
        assert torch.equal(db, full[f0:f1]), (sr, f0, f1)


def test_range_equals_whole_track_slice_settings_fuzz(rng):
    cases = [
        (8000, SpecSetting(win_ms=25.0, t_overlap=2)),
        (16000, SpecSetting(win_ms=80.0, t_overlap=8, f_overlap=2)),
        (22050, SpecSetting(win_ms=11.0, t_overlap=1)),
        (44100, SpecSetting(win_ms=60.0, t_overlap=3)),
    ]
    for sr, st in cases:
        n = int(rng.integers(sr // 2, sr))
        wav = (rng.standard_normal(n) * 0.3).astype(np.float32)
        full, nf = tm.multires_mel_spec_db(wav, sr, st, n_mel=48,
                                           device="cpu")
        ranges = [(0, nf), (nf - 3, nf), (0, 3)]
        ranges += [tuple(sorted(rng.integers(0, nf, 2))) for _ in range(3)]
        for f0, f1 in ranges:
            if f1 == f0:
                f1 = min(nf, f0 + 1)
            s0, s1 = tm.range_sample_window(n, sr, st, f0, f1)
            db, _ = tm.multires_mel_spec_db_range(
                wav[s0:s1], sr, f0, f1, setting=st, slice_start=s0,
                n_samples=n, n_mel=48, device="cpu")
            assert torch.equal(db, full[f0:f1]), (sr, st.win_ms, f0, f1)


def test_range_integer_carrier_equals_f32(rng):
    st = SpecSetting()
    sr, n = 8000, 20000
    i16 = rng.integers(-20000, 20000, n).astype(np.int16)
    f32 = i16.astype(np.float32) * np.float32(2.0 ** -15)
    for f0, f1 in [(0, 40), (10, 60)]:
        s0, s1 = tm.range_sample_window(n, sr, st, f0, f1)
        kw = dict(setting=st, slice_start=s0, n_samples=n, n_mel=48,
                  device="cpu")
        a, _ = tm.multires_mel_spec_db_range(f32[s0:s1], sr, f0, f1, **kw)
        b, _ = tm.multires_mel_spec_db_range(i16[s0:s1], sr, f0, f1,
                                             scale=2.0 ** -15, **kw)
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="scale"):
        tm.multires_mel_spec_db_range(i16[:4000], sr, 0, 5, n_samples=n,
                                      device="cpu")


# ------------------------------------------------------------ the session

SEC = 12.0


def _track(path, sr, seconds, f0, seed, bits=16):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = (0.3 * np.sin(2 * np.pi * f0 * t * (1 + 0.1 * np.sin(t)))
         + 0.05 * rng.standard_normal(len(t)))
    x[:: sr // 3] += 0.6  # clicks: the short windows win there
    write_wav(path, np.clip(x, -1, 1).astype(np.float32)[None], sr, bits=bits)
    return path


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_adaptive")
    return [_track(str(d / "a8k.wav"), 8000, SEC, 330.0, 1),
            _track(str(d / "b44k.wav"), 44100, 3.0, 1000.0, 2),
            _track(str(d / "c8k.wav"), 8000, 5.0, 700.0, 3)]


def _session(paths_, **kw):
    mt = msv_tpu_torch.MultiTrack(device="cpu", **kw)
    mt.add_tracks(list(range(len(paths_))), paths_)
    return mt


@pytest.fixture
def small_build(monkeypatch):
    """A small slice-local budget and build chunk: the 12 s track is then
    long against the build's granularity."""
    monkeypatch.setattr(tmt.MultiTrack, "ADAPTIVE_MAX_FRAMES", 64)
    monkeypatch.setattr(tmt.MultiTrack, "ADAPTIVE_CHUNK", 256)


def test_session_adaptive_crops_stitch(paths):
    mt = _session(paths[:1])
    full = mt.get_adaptive_spec_image_crop(0, 50, 200, 0.0, SEC + 1.0)
    a = mt.get_adaptive_spec_image_crop(0, 50, 200, 0.0, 7.0)
    b = mt.get_adaptive_spec_image_crop(0, 50, 200, 7.0, SEC + 1.0)
    np.testing.assert_array_equal(np.concatenate([a, b], axis=1), full)
    # three adjacent zoomed-in crops equal the crop over their union
    parts = [mt.get_adaptive_spec_image_crop(0, 400, 160, s, s + 1.5,
                                             wire="rgb")
             for s in (3.0, 4.5, 6.0)]
    union = mt.get_adaptive_spec_image_crop(0, 400, 160, 3.0, 7.5,
                                            wire="rgb")
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), union)
    # degenerate window -> empty image, not an error
    assert mt.get_adaptive_spec_image_crop(0, 50, 200, 5.0, 5.0).shape == \
        (200, 0, 3)


@pytest.mark.parametrize("wire", ["rgb", "grey8"])
def test_session_adaptive_crop_within_one_step_of_jax(paths, wire):
    mt = _session(paths[:2])
    jt = msv_tpu.MultiTrack()
    jt.add_tracks([0, 1], paths[:2])
    for tid, (s0, s1, px) in [(0, (0.0, SEC + 1.0, 50)),
                              (0, (2.0, 4.0, 300)), (1, (0.5, 2.5, 200))]:
        got = mt.get_adaptive_spec_image_crop(tid, px, 150, s0, s1,
                                              wire=wire)
        want = jt.get_adaptive_spec_image_crop(tid, px, 150, s0, s1,
                                               wire=wire)
        (_close_u8 if wire == "rgb" else _close_grey8)(got, want)


def test_cached_path_equals_slice_local(paths, small_build):
    mt = _session(paths[:1])
    ref = _session(paths[:1])
    ref.ADAPTIVE_MAX_FRAMES = 1 << 16  # slice-local in `ref`
    local = ref.get_adaptive_spec_image_crop(0, 50, 200, 0.0, SEC + 1.0)
    local_mid = ref.get_adaptive_spec_image_crop(0, 50, 200, 2.0, 9.0,
                                                 wire="rgb")
    via_cache = mt.get_adaptive_spec_image_crop(0, 50, 200, 0.0, SEC + 1.0)
    assert 0 in mt._adaptive_db
    np.testing.assert_array_equal(via_cache, local)
    cached = mt._adaptive_db[0].full
    assert cached is not None and mt._adaptive_db[0].parts == []
    np.testing.assert_array_equal(
        mt.get_adaptive_spec_image_crop(0, 50, 200, 2.0, 9.0, wire="rgb"),
        local_mid)
    assert mt._adaptive_db[0].full is cached  # reused, not rebuilt
    # the plane is counted against the budget, and a spill drops it
    assert (mt._track_device_bytes(0)
            >= cached.untyped_storage().nbytes()
            + mt._state[0].spec_db.untyped_storage().nbytes())
    mt._spill_track(0)
    assert 0 not in mt._adaptive_db and mt._track_device_bytes(0) == 0
    # settings change invalidates the cached adaptive state
    mt.get_adaptive_spec_image_crop(0, 50, 200, 0.0, SEC + 1.0)
    mt.set_setting(mt.setting)
    assert not mt._adaptive_db


def test_progressive_non_blocking_build(paths, small_build):
    mt = _session(paths[:1])
    ref = _session(paths[:1])
    want = ref.get_adaptive_spec_image_crop(0, 50, 160, 0.0, SEC + 1.0)
    want_left = ref.get_adaptive_spec_image_crop(0, 50, 160, 0.0, 1.0)
    # slow the build down so that its pending window is observable
    real = tmt.multires_mel_spec_db_range

    def slow(*a, **kw):
        time.sleep(0.05)
        return real(*a, **kw)

    tmt.multires_mel_spec_db_range = slow
    try:
        # a far-right viewport cannot be covered by an early prefix
        with pytest.raises(AdaptiveBuildPending) as exc:
            mt.get_adaptive_spec_image_crop(0, 50, 160, SEC - 2.0, SEC,
                                            block=False)
        assert 0 <= exc.value.built < exc.value.total
        build = mt._adaptive_db[0]
        prog = mt.adaptive_build_progress()
        assert prog == {} or set(prog[0]) == {"built", "total"}
        got_left, deadline = None, time.time() + 60
        while got_left is None and time.time() < deadline:
            try:
                got_left = mt.get_adaptive_spec_image_crop(
                    0, 50, 160, 0.0, 1.0, block=False)
            except AdaptiveBuildPending:
                time.sleep(0.01)
        np.testing.assert_array_equal(got_left, want_left)
        # block=True waits for the build and matches
        np.testing.assert_array_equal(
            mt.get_adaptive_spec_image_crop(0, 50, 160, 0.0, SEC + 1.0),
            want)
    finally:
        tmt.multires_mel_spec_db_range = real
    assert build.done.is_set() and build.full is not None
    np.testing.assert_array_equal(
        mt.get_adaptive_spec_image_crop(0, 50, 160, 0.0, SEC + 1.0,
                                        block=False), want)
    assert mt.adaptive_build_progress() == {}


def test_replace_cancels_and_renders_the_new_track(paths, small_build):
    mt = _session(paths[:1])
    a = mt.get_adaptive_spec_image_crop(0, 50, 120, 0.0, 5.0)
    build = mt._adaptive_db[0]
    mt.add_tracks([0], [paths[2]])  # replace id 0
    assert 0 not in mt._adaptive_db and build.cancel.is_set()
    b = mt.get_adaptive_spec_image_crop(0, 50, 120, 0.0, 5.0)
    assert not np.array_equal(a, b)


def test_remove_cancels_and_a_cancelled_blocking_call_raises(paths,
                                                             small_build):
    mt = _session(paths[:1])
    try:
        mt.get_adaptive_spec_image_crop(0, 50, 120, 0.0, SEC, block=False)
    except AdaptiveBuildPending:
        pass
    build = mt._adaptive_db[0]
    mt._drop_adaptive(0)  # a concurrent mutation: cancel and evict
    build.thread.join(timeout=60)
    assert not build.thread.is_alive()
    # pin the cancelled, unpublished shape and show it to a blocking call
    build.full, build.error = None, None
    mt._adaptive_db[0] = build
    with pytest.raises(MsvError) as exc:
        mt.get_adaptive_spec_image_crop(0, 50, 120, 0.0, SEC)
    assert not isinstance(exc.value, AdaptiveBuildPending)
    assert "invalidated" in str(exc.value)
    # remove_track cancels an in-flight build at its next segment
    del mt._adaptive_db[0]
    try:
        mt.get_adaptive_spec_image_crop(0, 50, 120, 0.0, SEC, block=False)
    except AdaptiveBuildPending:
        pass
    build = mt._adaptive_db[0]
    mt.remove_track(0)
    assert 0 not in mt._adaptive_db and build.cancel.is_set()
    build.thread.join(timeout=60)
    assert not build.thread.is_alive()


def test_build_error_reaches_the_next_caller(paths, small_build,
                                             monkeypatch):
    mt = _session(paths[:1])
    real = tmt.multires_mel_spec_db_range
    calls = []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("segment failed")
        return real(*a, **kw)

    monkeypatch.setattr(tmt, "multires_mel_spec_db_range", failing)
    with pytest.raises(RuntimeError, match="segment failed"):
        mt.get_adaptive_spec_image_crop(0, 50, 120, 0.0, SEC + 1.0)
    assert 0 not in mt._adaptive_db  # dropped: the next call retries
    img = mt.get_adaptive_spec_image_crop(0, 50, 120, 0.0, SEC + 1.0)
    assert img.shape == (120, int(50 * SEC), 3)


def test_adaptive_uses_mel_alignment_in_linear_sessions(paths):
    mt = _session(paths[:2], setting=SpecSetting(freq_scale=FreqScale.LINEAR))
    n_mel = tm.adaptive_auto_n_mel(8000, mt.setting)
    f32 = np.float32
    from msv_tpu_torch.ops.mel import hz_to_mel
    from msv_tpu_torch.render.grey import grey_height

    mel_up = float(hz_to_mel(f32(44100) / f32(2)) / hz_to_mel(f32(8000)
                                                             / f32(2)))
    h = grey_height(n_mel, mel_up)
    # nheight == the grey height: rows above the mel headroom band are
    # colormap(0) = (0, 0, 4); the linear ratio would give 5.5x, not 1.5x
    img = mt.get_adaptive_spec_image_crop(0, 20, h, 0.0, 2.0)
    assert img.shape[0] == h
    band_rows = int((img == np.array([0, 0, 4], np.uint8))
                    .all(axis=2).all(axis=1).sum())
    assert abs(band_rows - (h - n_mel)) <= 2, (band_rows, h - n_mel)
