"""The port's MultiTrack (on the CPU, through the kernel's plain version)
against the JAX package's MultiTrack on the same files.

The JAX session's default engine is XLA (``spec_pipeline``, log10 dB); the
port's spectrogram is the fused kernel's function (ln*20/ln10).  So dB
values are held to the kernel bound of tests/test_pallas_kernel.py (atol
2e-3 dB, rtol 1e-4: near-null bins differ by f32 summation order), rgb
images to one u8 step per channel, and grey8 images to one grey level (a
one-level flip moves a LUT colour by up to 3 u8 steps).
"""

import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference: absent where the card-only tests run
pytest.importorskip("jax")

import msv_tpu  # noqa: E402
import msv_tpu_torch  # noqa: E402
from msv_tpu.io.audio import write_wav  # noqa: E402
from msv_tpu_torch.render.colormap import _host_lut  # noqa: E402
from msv_tpu_torch.session import multitrack as tmt  # noqa: E402

FIXTURE_FLAC = os.path.join(os.path.dirname(__file__), "fixtures",
                            "sine440_8k.flac")
# tests/test_e2e_reference_samples.py: the JAX session's digest of this
# fixture at 100 px/s x 200 rows on the default (grey8) wire
GOLDEN_FLAC_SPEC = "0d88d6f8c61af68e"

TRACKS = [  # (sr, bits): 8 kHz PCM16, a same-length 44.1 kHz PCM16 pair
    (8000, 16),  # (one batched launch) and a 48 kHz float track
    (44100, 16),
    (44100, 16),
    (48000, 32),
]


def _tone(rng, sr, seconds=1.5):
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = rng.uniform(200, 900)
    sig = 0.3 * np.sin(2 * np.pi * f0 * t) * (0.6 + 0.4 * np.sin(3 * t))
    sig += 0.1 * np.sin(2 * np.pi * 3.1 * f0 * t)
    return (sig + 0.02 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    rng = np.random.default_rng(20260816)
    d = tmp_path_factory.mktemp("torch_session")
    paths = []
    for i, (sr, bits) in enumerate(TRACKS):
        p = str(d / f"track{i}_{sr}.wav")
        write_wav(p, _tone(rng, sr), sr, bits=bits)
        paths.append(p)
    ids = list(range(len(paths)))
    ref = msv_tpu.MultiTrack()
    ref.add_tracks(ids, paths)
    port = msv_tpu_torch.MultiTrack(device="cpu")
    port.add_tracks(ids, paths)
    return ref, port, paths


def _close_u8(a, b, steps=1):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= steps, diff.max()


def _grey_levels(img):
    """Per pixel, the lowest and highest grey8 level whose LUT colour it is
    (the top stop is flat, so several levels share one colour)."""
    lut = _host_lut(8).astype(np.int64)
    key = (lut[:, 0] << 16) | (lut[:, 1] << 8) | lut[:, 2]
    px = img.astype(np.int64)
    px = (px[..., 0] << 16) | (px[..., 1] << 8) | px[..., 2]
    lo = np.full(px.shape, 1 << 30)
    hi = np.full(px.shape, -1)
    for q in range(256):
        m = px == key[q]
        lo[m] = np.minimum(lo[m], q)
        hi[m] = np.maximum(hi[m], q)
    assert (hi >= 0).all(), "pixel is not a grey8 LUT colour"
    return lo, hi


def _close_grey8(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    (alo, ahi), (blo, bhi) = _grey_levels(a), _grey_levels(b)
    gap = np.maximum(np.maximum(alo - bhi, blo - ahi), 0)
    assert gap.max() <= 1, gap.max()


def _close_db(got, want):
    assert abs(got - want) <= 2e-3 + 1e-4 * abs(want), (got, want)


def test_tracks_take_the_expected_kernel_routes(sessions):
    _, port, _ = sessions
    assert [port.tracks[i].wire for i in range(4)] == ["i16", "i16", "i16",
                                                       "f32"]


@pytest.mark.parametrize("tid", range(len(TRACKS)))
def test_spec_db_matches(sessions, tid):
    ref, port, _ = sessions
    got = port.get_spec_db(tid)
    want = ref.get_spec_db(tid)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-4)


def test_global_db_range_matches(sessions):
    ref, port, _ = sessions
    _close_db(port.get_max_db(), ref.get_max_db())
    _close_db(port.get_min_db(), ref.get_min_db())
    assert port.max_sr == ref.max_sr == 48000
    assert port.get_max_sec() == ref.get_max_sec()


@pytest.mark.parametrize("wire", ["rgb", "grey8"])
@pytest.mark.parametrize("tid", range(len(TRACKS)))
def test_spec_image_within_one_step(sessions, tid, wire):
    ref, port, _ = sessions
    close = _close_u8 if wire == "rgb" else _close_grey8
    close(port.get_spec_image(tid, 100.0, 120, wire=wire),
          ref.get_spec_image(tid, 100.0, 120, wire=wire))


def test_spec_image_crop_within_one_step(sessions):
    ref, port, _ = sessions
    got = port.get_spec_image_crop(1, 2000.0, 90, 0.25, 1.1, wire="rgb")
    want = ref.get_spec_image_crop(1, 2000.0, 90, 0.25, 1.1, wire="rgb")
    assert got.shape[1] == 1700  # banded: wider than DENSE_LIMIT's dense
    _close_u8(got, want)
    full = port.get_spec_image(1, 2000.0, 90, wire="rgb")
    np.testing.assert_array_equal(got, full[:, 500:2200])


def test_grey_and_getters_match(sessions):
    ref, port, paths = sessions
    # the dB bound over the ~120 dB window: (2e-3 + 1e-4 * 122) / 120
    np.testing.assert_allclose(port.get_grey(0), ref.get_grey(0), atol=1.2e-4)
    for tid in range(len(TRACKS)):
        assert port.get_sr(tid) == ref.get_sr(tid)
        assert port.get_sec(tid) == ref.get_sec(tid)
        assert port.get_filename(tid) == ref.get_filename(tid)
        assert port.get_n_channels(tid) == ref.get_n_channels(tid)
        assert port.get_channel(tid) is None
        assert port.get_frequency_hz(tid, 0.37) == ref.get_frequency_hz(
            tid, 0.37)
    assert port.get_path(0) == paths[0]


def test_same_bucket_tracks_share_one_launch(sessions, monkeypatch):
    _, _, paths = sessions
    calls = []
    real = tmt.mel_spectrogram_cuda

    def counting(padded, *args, **kw):
        calls.append(tuple(padded.shape[:-1]))
        return real(padded, *args, **kw)

    monkeypatch.setattr(tmt, "mel_spectrogram_cuda", counting)
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks(list(range(len(paths))), paths)
    assert sorted(calls) == [(1,), (1,), (2,)]  # 8 kHz, 48 kHz, the pair


def _host_batch(carriers, win, need, dtype):
    """The group's batch built on the host: ``reflect_pad_center``, a zero
    tail to ``need`` (or a cut), an integer carrier of a float batch cast
    to f32 and scaled, then ``np.stack``."""
    from msv_tpu_torch.ops.framing import reflect_pad_center

    rows = []
    for src, scale in carriers:
        p = reflect_pad_center(src, win)
        p = np.pad(p, (0, max(0, need - len(p))))[:need]
        if dtype == torch.float32 and p.dtype != np.float32:
            p = p.astype(np.float32) * np.float32(scale)
        rows.append(p)
    return np.stack(rows)


class _Len:
    """What ``_frame_counts`` reads of a track."""

    def __init__(self, n, win, hop):
        self.n_samples, self.win_length, self.hop_length = n, win, hop


def _pcm16(rng, n):
    return rng.integers(-(1 << 15), 1 << 15, n).astype(np.int16)


# case -> (carriers of (samples, scale) at 44.1 kHz, the batch dtype); a
# track's length in hops (h), the window's half (half)
UPLOAD_CASES = {
    "i16": (lambda r, h, half: [(_pcm16(r, 100 * h + 321), 2.0**-15)],
            torch.int16),
    "i32_stereo_sum": (lambda r, h, half: [(
        _pcm16(r, 100 * h + 321) + _pcm16(r, 100 * h + 321).astype(np.int32),
        2.0**-15)], torch.float32),
    "i32_flac24": (lambda r, h, half: [(
        r.integers(-(1 << 23), 1 << 23, 100 * h + 321).astype(np.int32),
        2.0**-23)], torch.float32),
    "f32": (lambda r, h, half: [(
        r.standard_normal(100 * h + 321).astype(np.float32), 1.0)],
        torch.float32),
    "pair_unequal": (lambda r, h, half: [(_pcm16(r, 100 * h + 321), 2.0**-15),
                                         (_pcm16(r, 140 * h + 7), 2.0**-15)],
                     torch.int16),
    "i32_and_f32": (lambda r, h, half: [
        (_pcm16(r, 90 * h).astype(np.int32) * 2, 2.0**-15),
        (r.standard_normal(90 * h + 11).astype(np.float32), 1.0)],
        torch.float32),
    # 256 frames exactly and hop - 1 samples more: the row cuts the right
    # reflection
    "need_short": (lambda r, h, half: [(_pcm16(r, 256 * h - 1), 2.0**-15)],
                   torch.int16),
    "shortest": (lambda r, h, half: [(_pcm16(r, half + 1), 2.0**-15)],
                 torch.int16),
}


@pytest.mark.parametrize("case", sorted(UPLOAD_CASES))
def test_the_group_batch_built_on_the_device_is_the_host_batch(case):
    """``pad_group_on_device`` gives the bits of the host's reflect pad,
    zero tail and stack (and f32 scale), for each carrier, a group of
    tracks of unequal length, a row shorter and longer than the
    reflect-padded wave, and the shortest track the pad accepts."""
    p = msv_tpu_torch.config.derive_stft_params(
        44100, msv_tpu_torch.SpecSetting())
    win, hop, half = p.win_length, p.hop_length, p.win_length // 2
    build, dtype = UPLOAD_CASES[case]
    carriers = build(np.random.default_rng(len(case)), hop, half)
    (nfp,) = {tmt._frame_counts(_Len(len(a), win, hop))[1]
              for a, _ in carriers}
    need = (nfp - 1) * hop + win
    padded_len = max(len(a) for a, _ in carriers) + 2 * half
    assert (need < padded_len) == (case == "need_short")
    got = tmt.pad_group_on_device(carriers, win, need, dtype, "cpu")
    want = _host_batch(carriers, win, need, dtype)
    assert got.dtype == dtype and got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.uint8), want.view(np.uint8))


def test_each_launch_reads_the_host_batch_of_its_group(sessions,
                                                       monkeypatch):
    """The session's launches (8 kHz int16, the 44.1 kHz int16 pair, the
    48 kHz float track) read the host-built batch of their group; a track
    shorter than the pad accepts raises reflect_pad_center's error."""
    _, _, paths = sessions
    seen = []
    real = tmt.mel_spectrogram_cuda

    def recording(padded, *args, **kw):
        seen.append(padded.clone())
        return real(padded, *args, **kw)

    monkeypatch.setattr(tmt, "mel_spectrogram_cuda", recording)
    mt = msv_tpu_torch.MultiTrack(device="cpu")
    mt.add_tracks(list(range(len(paths))), paths)
    groups = {}  # in the session's order: by first track
    for i, tr in mt.tracks.items():
        groups.setdefault((tr.sr, tmt._frame_counts(tr)[1], tr.wire),
                          []).append(i)
    assert len(seen) == len(groups) == 3
    for got, ids in zip(seen, groups.values()):
        want = _host_batch([tmt._carrier(mt.tracks[i]) for i in ids],
                           mt.tracks[ids[0]].win_length, got.shape[1],
                           got.dtype)
        assert got.shape == want.shape
        assert np.array_equal(got.numpy().view(np.uint8),
                              want.view(np.uint8))
    with pytest.raises(ValueError, match="too short"):
        tmt.pad_group_on_device([(np.zeros(960, np.int16), 1.0)], 1920,
                                10_000, torch.int16, "cpu")


def test_remove_track_renormalizes_like_jax(sessions):
    _, _, paths = sessions
    ref = msv_tpu.MultiTrack()
    port = msv_tpu_torch.MultiTrack(device="cpu")
    for mt in (ref, port):
        mt.add_tracks([0, 1], [paths[0], paths[3]])
        mt.remove_track(1)
    assert port.max_sr == ref.max_sr == 8000
    _close_db(port.get_max_db(), ref.get_max_db())
    _close_db(port.get_min_db(), ref.get_min_db())
    assert list(port._operands) == [8000]
    with pytest.raises(msv_tpu_torch.utils.TrackNotFoundError):
        port.get_spec_db(1)


def test_flac_fixture_within_one_step_of_jax():
    ref = msv_tpu.MultiTrack()
    ref.add_tracks([0], [FIXTURE_FLAC])
    port = msv_tpu_torch.MultiTrack(device="cpu")
    port.add_tracks([0], [FIXTURE_FLAC])
    got = port.get_spec_image(0, 100.0, 200)  # default wire: grey8
    _close_grey8(got, ref.get_spec_image(0, 100.0, 200))
    digest = hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest()
    # reported, not asserted: the port's dB comes from the kernel's formula
    print(f"port digest {digest[:16]}, JAX golden {GOLDEN_FLAC_SPEC}, "
          f"equal={digest[:16] == GOLDEN_FLAC_SPEC}")


def test_unported_paths_raise_not_implemented(sessions):
    """Once the port's gaps; now every one runs: the linear scale
    (tests/test_torch_linear.py), the packed dB wire per call and by the
    config (within its grid bound of the f32 export), and the packed
    streaming transfer (raw's plane)."""
    _, port, paths = sessions
    msv_tpu_torch.MultiTrack(
        msv_tpu_torch.SpecSetting(freq_scale=msv_tpu_torch.FreqScale.LINEAR),
        device="cpu")
    st = port._state[0]
    bound = 0.5 * (st.smax - st.smin) / 1023 + 1e-4
    f32 = port.get_spec_db(0, wire="f32")
    assert np.abs(port.get_spec_db(0, wire="q10") - f32).max() <= bound
    c, s, fb = port._operands[8000].dense()
    wav = (np.random.default_rng(2).standard_normal(4000) * 3000).astype(
        np.int16)
    got, want = (msv_tpu_torch.streaming_spec_db(wav, 320, 80, c, s, fb,
                                                 transfer=t)
                 for t in ("pack", "raw"))
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
    msv_tpu_torch.config.set_db_wire("q10")
    try:
        assert msv_tpu_torch.config.get_db_wire() == "q10"
        assert np.abs(port.get_spec_db(0) - f32).max() <= bound
    finally:
        msv_tpu_torch.config.set_db_wire("f32")


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        msv_tpu_torch.MultiTrack()
