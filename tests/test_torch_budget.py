"""The port's session device-memory budget with LRU spill (on the CPU),
mirroring tests/test_hbm_budget.py: 20 short tracks under a budget of 3.5
tracks' bytes stay bounded through a render sweep, spilled tracks render
images equal to an unbounded session's, and those images stay within one
u8 step (rgb) or one grey level (grey8) of msv_tpu's session."""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference: absent where the card-only tests run
pytest.importorskip("jax")

import msv_tpu  # noqa: E402
import msv_tpu_torch  # noqa: E402
from msv_tpu.io.audio import write_wav  # noqa: E402
from msv_tpu_torch import config as tcfg  # noqa: E402
from msv_tpu_torch.session import multitrack as tmt  # noqa: E402
from test_torch_session import _close_grey8, _close_u8  # noqa: E402

N_TRACKS = 20


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    td = tmp_path_factory.mktemp("torch_budget")
    rng = np.random.default_rng(7)
    sr = 8000
    paths = []
    for i in range(N_TRACKS):
        t = np.arange(int(sr * 0.5)) / sr
        x = (0.3 * np.sin(2 * np.pi * (200 + 40 * i) * t)
             + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
        p = str(td / f"t{i}.wav")
        write_wav(p, x[None], sr)
        paths.append(p)
    return paths


def _session(paths, budget=None):
    mt = msv_tpu_torch.MultiTrack(device="cpu", hbm_budget_bytes=budget)
    mt.add_tracks(list(range(len(paths))), paths)
    return mt


def _per_track_bytes(wavs):
    """One fully rendered track's device bytes (the envelope buffer, a
    row of 256 frames' samples, and its sparse-table levels dominate these
    short tracks)."""
    probe = _session(wavs[:1])
    probe.get_spec_image(0, 100.0, 120)
    probe.get_wav_image(0, 100.0, 60, -1.0, 1.0)
    return max(probe.hbm_stats()["per_track_bytes"].values())


@pytest.fixture(scope="module")
def ref(wavs):
    return _session(wavs)


def test_budget_bounds_resident_and_renders_identical(wavs, ref):
    per = _per_track_bytes(wavs)
    budget = 3 * per + per // 2
    mt = _session(wavs, budget)
    stats = mt.hbm_stats()
    assert stats["budget_bytes"] == budget
    assert stats["resident_bytes"] <= budget
    assert stats["spills"] > 0  # 20 planes cannot fit in ~3
    assert set(stats["per_track_bytes"]) == set(range(N_TRACKS))
    # the global dB window derives from host scalars, not residency
    assert (mt.max_db, mt.min_db) == (ref.max_db, ref.min_db)
    for i in range(N_TRACKS):
        np.testing.assert_array_equal(mt.get_spec_image(i, 100.0, 120),
                                      ref.get_spec_image(i, 100.0, 120))
        np.testing.assert_array_equal(
            mt.get_wav_image(i, 100.0, 60, -1.0, 1.0),
            ref.get_wav_image(i, 100.0, 60, -1.0, 1.0))
        assert mt.hbm_stats()["resident_bytes"] <= budget
    stats = mt.hbm_stats()
    assert stats["reuploads"] > 0 and stats["spills"] > N_TRACKS
    # revisiting the coldest track after the sweep still matches, on every
    # render entry point
    np.testing.assert_array_equal(mt.get_spec_image(0, 80.0, 90),
                                  ref.get_spec_image(0, 80.0, 90))
    np.testing.assert_array_equal(
        mt.get_spec_image_crop(1, 100.0, 90, 0.1, 0.4, wire="rgb"),
        ref.get_spec_image_crop(1, 100.0, 90, 0.1, 0.4, wire="rgb"))
    np.testing.assert_array_equal(
        mt.get_wav_image_crop(2, 100.0, 60, -1.0, 1.0, 0.1, 0.4),
        ref.get_wav_image_crop(2, 100.0, 60, -1.0, 1.0, 0.1, 0.4))
    np.testing.assert_array_equal(mt.get_grey(3), ref.get_grey(3))
    assert mt.hbm_stats()["resident_bytes"] <= budget


@pytest.mark.parametrize("wire", ["rgb", "grey8"])
def test_budgeted_images_within_one_step_of_jax(wavs, wire):
    ids = list(range(N_TRACKS))
    jref = msv_tpu.MultiTrack()
    jref.add_tracks(ids, wavs)
    mt = _session(wavs, budget=1)  # every other track spills
    for i in (0, 7, 13, 19):
        got = mt.get_spec_image(i, 100.0, 120, wire=wire)
        want = jref.get_spec_image(i, 100.0, 120, wire=wire)
        (_close_u8 if wire == "rgb" else _close_grey8)(got, want)
        np.testing.assert_array_equal(
            mt.get_wav_image(i, 100.0, 60, -1.0, 1.0),
            jref.get_wav_image(i, 100.0, 60, -1.0, 1.0))
    assert mt.hbm_stats()["reuploads"] >= 3


def test_unbounded_session_never_spills(wavs):
    mt = _session(wavs[:2])
    mt.get_spec_image(0, 50.0, 64)
    s = mt.hbm_stats()
    assert s["budget_bytes"] is None
    assert s["spills"] == 0 and s["reuploads"] == 0
    assert s["resident_bytes"] > 0


def test_config_default_budget_and_override(tmp_path, wavs):
    tcfg.set_session_hbm_budget(123456789)
    try:
        assert msv_tpu_torch.get_session_hbm_budget() == 123456789
        mt = msv_tpu_torch.MultiTrack(device="cpu")
        assert mt.hbm_budget_bytes == 123456789
        # the per-session override wins
        mt2 = msv_tpu_torch.MultiTrack(device="cpu", hbm_budget_bytes=42)
        assert mt2.hbm_budget_bytes == 42
        with pytest.raises(ValueError):
            tcfg.set_session_hbm_budget(-1)
        # load_session passes the override through
        m = _session(wavs[:1])
        path = str(tmp_path / "s.json")
        m.save_session(path)
        back = msv_tpu_torch.MultiTrack.load_session(path, device="cpu",
                                                     hbm_budget_bytes=7)
        assert back.hbm_budget_bytes == 7
        assert msv_tpu_torch.MultiTrack.load_session(
            path, device="cpu").hbm_budget_bytes == 123456789
    finally:
        tcfg.set_session_hbm_budget(None)
    assert msv_tpu_torch.MultiTrack(device="cpu").hbm_budget_bytes is None


def test_remove_track_clears_lru(wavs):
    mt = _session(wavs[:2], budget=1)  # everything spills
    mt.get_spec_image(1, 50.0, 64)
    assert 1 in mt._lru
    mt.remove_track(1)
    assert 1 not in mt._lru
    # the remaining track still renders
    assert mt.get_spec_image(0, 50.0, 64).shape[0] == 64


def test_grouped_track_owns_its_storage(wavs, ref):
    """The 20 tracks are one launch group; each keeps a plane of its own,
    so its bytes count exactly and a spill frees them."""
    ptrs = set()
    for i in range(N_TRACKS):
        plane = ref._state[i].spec_db
        assert isinstance(plane, torch.Tensor)
        assert plane.untyped_storage().nbytes() == plane.numel() * 4
        ptrs.add(plane.untyped_storage().data_ptr())
    assert len(ptrs) == N_TRACKS
    mt = _session(wavs[:3])
    before = {i: mt._track_device_bytes(i) for i in range(3)}
    mt._spill_track(1)
    assert isinstance(mt._state[1].spec_db, np.ndarray)
    assert mt._track_device_bytes(1) == 0
    assert mt._track_device_bytes(0) == before[0] > 0
    assert mt._track_device_bytes(2) == before[2] > 0


def test_spilled_spec_db_is_served_from_the_host(wavs, ref):
    mt = _session(wavs[:3], budget=1)  # all three spill
    tcfg.set_db_wire("f32")
    mt.get_spec_image(2, 50.0, 64)  # and one comes back
    for i in range(3):
        assert isinstance(mt._state[i].spec_db, np.ndarray) == (i < 2)
        before = mt.hbm_stats()["reuploads"]
        got = mt.get_spec_db(i)
        assert mt.hbm_stats()["reuploads"] == before  # no re-upload
        np.testing.assert_array_equal(got, ref.get_spec_db(i))
        got[:] = 0.0  # the caller's copy, not the session's plane
        np.testing.assert_array_equal(mt.get_spec_db(i), ref.get_spec_db(i))
    # a packed wire packs on the device: the spilled plane is re-uploaded
    # (counted) and the export is within the q12 grid of the f32 plane
    before = mt.hbm_stats()["reuploads"]
    got = mt.get_spec_db(0, wire="q12")
    assert mt.hbm_stats()["reuploads"] == before + 1
    st = mt._state[0]
    assert isinstance(st.spec_db, torch.Tensor)
    bound = 0.5 * (st.smax - st.smin) / 4095 + 1e-4
    assert np.abs(got - ref.get_spec_db(0)).max() <= bound
    with pytest.raises(ValueError):
        mt.get_spec_db(0, wire="f16")


def test_spill_rebuilds_a_streamed_tracks_waveform(tmp_path, monkeypatch):
    """A spill drops the device wave that streaming adopted; the next
    waveform render uploads the host carrier and draws the same image."""
    sr = 8000
    t = np.arange(2 * sr) / sr
    path = str(tmp_path / "long.wav")
    write_wav(path, (0.4 * np.sin(2 * np.pi * 220 * t))[None]
              .astype(np.float32), sr, bits=16)
    monkeypatch.setattr(tmt, "STREAMING_FRAME_THRESHOLD", 4)
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks([0], [path])
    env = mt._env_states[0]
    assert env.origin == "adopted"
    bytes0 = mt._track_device_bytes(0)
    assert bytes0 >= (mt._state[0].spec_db.untyped_storage().nbytes()
                      + env.dev.untyped_storage().nbytes())
    img = mt.get_wav_image(0, 50.0, 80, -1.0, 1.0)
    crop = mt.get_spec_image_crop(0, 50.0, 80, 0.3, 1.2)
    mt._spill_track(0)
    assert 0 not in mt._env_states and mt._track_device_bytes(0) == 0
    np.testing.assert_array_equal(mt.get_wav_image(0, 50.0, 80, -1.0, 1.0),
                                  img)
    assert mt._env_states[0].origin == "upload"
    np.testing.assert_array_equal(mt.get_spec_image_crop(0, 50.0, 80, 0.3,
                                                         1.2), crop)
    assert mt.hbm_stats()["reuploads"] == 1


def test_two_threads_render_under_a_one_plane_budget(wavs):
    """Two threads render two tracks in turn while each render spills the
    other's plane: no error, every image equal to the unbounded one."""
    mt = _session(wavs[:2])
    want = {i: mt.get_spec_image(i, 100.0, 64) for i in (0, 1)}
    plane = mt._state[0].spec_db.untyped_storage().nbytes()
    mt.hbm_budget_bytes = plane
    errors, bad = [], []

    def work(i):
        try:
            for _ in range(15):
                if not np.array_equal(mt.get_spec_image(i, 100.0, 64),
                                      want[i]):
                    bad.append(i)
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == [] and bad == []
    stats = mt.hbm_stats()
    assert stats["spills"] > 0 and stats["reuploads"] > 0
    assert stats["resident_bytes"] <= plane
