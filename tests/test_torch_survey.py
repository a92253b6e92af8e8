"""The survey session on the CPU: four short AudioMoth-style mono PCM16
files at 384, 250, 192 and 48 kHz opened together in one ``MultiTrack``
(the benchmark's ``survey384k`` configuration, cut to 0.4 s a file),
against the benchmark's plain reference (``portbench/reference``: an FFT
of n_fft points in float32, nothing of the program): each track's dB
plane, the session's max_db, the grey heights of the rates aligned at
384 kHz, and the first screen's crops as PNGs; and the same files on the
linear scale (``survey384k_linear``), whose planes the CPU session makes by
the dense pair over the same C and S.

On the CPU the session takes the kernels' plain version (a DFT GEMM pair
in float32) and the reference an FFT: the two differ by float32 rounding
over windows of up to 15 360 samples, as the judge allows on the card.
The module builds the session once: the 384, 250 and 192 kHz operands
(C and S, 1.9 GB of float32) are most of its time and memory, and are
dropped from the cache of ``ops.dft`` at its end."""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch.config import FreqScale, SpecSetting  # noqa: E402
from msv_tpu_torch.io.png import encode_png  # noqa: E402
from msv_tpu_torch.ops import dft  # noqa: E402
from msv_tpu_torch.render.grey import grey_height  # noqa: E402
from msv_tpu_torch.session import MultiTrack  # noqa: E402
from portbench import check, pngdecode, registry, signals  # noqa: E402
from portbench.reference import render, spec  # noqa: E402

RATES = (384000, 250000, 192000, 48000)
SECONDS = 0.4
CONFIG = registry.config("survey384k")
SETTING = CONFIG["setting"]
# float32 rounding of the plain route's DFT GEMM pair against the FFT,
# over bins within 60 dB of their frame's peak (check.db_gap): here at most
# 0.00091 dB, on the card's runs of the cell at most 0.0016 dB (parity
# kernels) and the bf16 control 2.6 dB or more
DB_TOL = 0.01


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    """(session, tracks): the four files written and opened in one
    ``add_tracks`` call on the CPU."""
    d = tmp_path_factory.mktemp("survey")
    g = torch.Generator().manual_seed(20)
    tracks = []
    for i, sr in enumerate(RATES):
        pcm = signals.song(g, sr, SECONDS, 1, "cpu")
        path = str(d / f"track{i}_{sr}.wav")
        signals.write_wav(path, pcm, sr)
        tracks.append({"path": path, "sr": sr, "pcm": pcm})
    setting = SpecSetting(win_ms=SETTING["win_ms"],
                          t_overlap=SETTING["t_overlap"],
                          f_overlap=SETTING["f_overlap"],
                          freq_scale=FreqScale(SETTING["freq_scale"]),
                          db_range=SETTING["db_range"])
    mt = MultiTrack(setting, device="cpu")
    mt.add_tracks(list(range(len(tracks))), [t["path"] for t in tracks])
    yield mt, tracks
    del mt
    dft._dft_matrices_cached.cache_clear()
    gc.collect()


@pytest.fixture(scope="module")
def survey_linear(survey):
    """The same four files opened on the linear scale
    (``survey384k_linear``): a CPU session, so every rate takes the dense
    pair, over the C and S the mel session built (``ops.dft``'s cache)."""
    _, tracks = survey
    mt = MultiTrack(SpecSetting(freq_scale=FreqScale.LINEAR), device="cpu")
    mt.add_tracks(list(range(len(tracks))), [t["path"] for t in tracks])
    yield mt
    del mt
    gc.collect()


@pytest.fixture(scope="module")
def refs(survey):
    """The reference's dB plane of each track."""
    _, tracks = survey
    return [spec.mel_db(spec.mono_f32(t["pcm"]), t["sr"], SETTING, "cpu")
            for t in tracks]


def test_the_configuration_is_the_session_opened_here():
    assert [t["sr"] for t in CONFIG["tracks"]] == list(RATES)
    assert all(t["channels"] == 1 and t["signal"] == "song"
               for t in CONFIG["tracks"])
    assert (CONFIG["precision"], SETTING["freq_scale"]) == ("parity", "mel")


@pytest.mark.parametrize("tid", range(len(RATES)),
                         ids=[f"{sr // 1000}k" for sr in RATES])
def test_each_plane_matches_the_plain_reference(survey, refs, tid):
    mt, tracks = survey
    got = torch.from_numpy(mt.get_spec_db(tid))
    ref = refs[tid]
    win, hop, n_fft = spec.stft_params(tracks[tid]["sr"], SETTING)
    assert got.shape == ref.shape
    assert ref.shape[0] == spec.n_frames(int(SECONDS * tracks[tid]["sr"]),
                                         win, hop)
    assert check.db_gap(got, ref) < DB_TOL


def test_the_session_db_window_matches_the_reference(survey, refs):
    mt, _ = survey
    max_db, min_db = spec.db_window([float(r.min()) for r in refs],
                                    [float(r.max()) for r in refs],
                                    SETTING["db_range"])
    assert abs(mt.get_max_db() - max_db) < 1e-3
    assert mt.get_min_db() <= mt.get_max_db()
    assert mt.max_sr == 384000


def test_grey_heights_align_at_384_khz(survey, refs):
    mt, tracks = survey
    got = [grey_height(r.shape[1], mt._up_ratio(t["sr"]))
           for r, t in zip(refs, tracks)]
    want = [spec.grey_height(r.shape[1], spec.up_ratio(t["sr"], 384000))
            for r, t in zip(refs, tracks)]
    assert got == want == [519, 797, 519, 518]


def test_the_first_screen_pngs(survey, refs):
    """Each track's spectrogram and waveform crops of the first screen
    (100 px/s over 0-12 s, 0.4 s of audio: 40 columns) as PNGs: their
    sizes, the spectrogram's grey levels within one of the reference's and
    the waveform's pixels exact."""
    mt, tracks = survey
    max_db, min_db = mt.get_max_db(), mt.get_min_db()
    for tid, t in enumerate(tracks):
        n = t["pcm"].shape[1]
        sp = pngdecode.pixels(encode_png(
            mt.get_spec_image_crop(tid, 100, 300, 0.0, 12.0)))
        wv = pngdecode.pixels(encode_png(
            mt.get_wav_image_crop(tid, 100, 80, -1.0, 1.0, 0.0, 12.0)))
        assert sp.shape == (300, 40, 3) and wv.shape[:2] == (80, 40)
        levels = render.spec_levels(
            refs[tid], t["sr"], spec.up_ratio(t["sr"], 384000), max_db,
            min_db, 100, 300, 0.0, 12.0, n)
        assert check.spec_gap(encode_png(sp), levels) <= 1
        ref_wav = render.wav_crop(spec.mono_f32(t["pcm"]), t["sr"], 100, 80,
                                  -1.0, 1.0, 0.0, 12.0)
        assert np.array_equal(wv, ref_wav)


def _f64_db(x, ops, win, hop, n_frames):
    """The kernels' function in float64 on the same int16 wave and the same
    f32 operands ``(C, S, fb)``."""
    c, s, fb = (t.double() for t in ops)
    frames = (x.double() * 2.0**-15).unfold(0, win, hop)[:n_frames]
    re, im = frames @ c, frames @ s
    mel = torch.sqrt(re * re + im * im) @ fb
    return torch.where(mel > 1e-18, 20.0 * torch.log10(mel), -360.0)


def _amp(db, peak):
    """Amplitude relative to the frame's peak (dB planes, peak (..., 1))."""
    return torch.pow(10.0, (db.double() - peak) / 20.0)


def _agree_as_plain(got, plain, wit):
    """Bins where ``got`` agrees with the plain route: within the kernels'
    atol/rtol, or within twice the plain route's own f32 error at this
    window in amplitude relative to the frame's peak (its largest distance
    from the float64 witness ``wit``).  Over a 15 360-sample window both
    f32 sums leave bins 40-60 dB under their frame's peak a few hundredths
    of a dB apart; bf16 operands miss the loudest bins by about 1e-3 of the
    peak."""
    peak = wit.amax(dim=-1, keepdim=True)
    floor = float((_amp(plain, peak) - _amp(wit, peak)).abs().max())
    close = (got - plain).abs() <= 2e-3 + 1e-4 * plain.abs()
    near = (_amp(got, peak) - _amp(plain, peak)).abs() <= 2 * floor
    return close | near, floor


@pytest.mark.gpu
def test_a_400_s_384_khz_file_streams_through_the_fft_tier_on_the_card():
    """400 s at 384 kHz is 40 001 frames, over the session's streaming
    threshold: streamed in two segments, each one FFT-tier launch of the
    parity kernel on the record a ``MelRoute`` makes, as the session's,
    against the kernel's plain version over the same padded wave in blocks,
    by a tolerance derived from the plain route's own f32 error
    (``_agree_as_plain``), which the bf16 kernel fails.  Given C, S and fb
    instead, streaming makes a route of the same record from ``window``
    (the same plane on 30 s) and raises without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from msv_tpu_torch.config import derive_stft_params
    from msv_tpu_torch.kernels import spectrogram_cuda as K
    from msv_tpu_torch.ops.framing import reflect_pad_center
    from msv_tpu_torch.ops.mel import calc_mel_fb_default
    from msv_tpu_torch.ops.windows import default_stft_window
    from msv_tpu_torch.parallel.streaming import (_seg_plan_for,
                                                  streaming_spec_db)
    from msv_tpu_torch.session.multitrack import STREAMING_FRAME_THRESHOLD

    torch.backends.cuda.matmul.allow_tf32 = False
    sr = 384000
    p = derive_stft_params(sr, SpecSetting())
    win, hop = p.win_length, p.hop_length
    window = default_stft_window(win, p.n_fft)
    c, s = dft.windowed_dft_matrices(window, p.n_fft)
    fb = calc_mel_fb_default(sr, p.n_fft)
    f32 = K.operands_from_numpy(c, s, fb, "cuda")
    ops = K.MelRoute(window, fb, win=win, hop=hop, n_fft=p.n_fft,
                     device="cuda")
    rec = ops.record("parity")
    assert ops.tier("parity") == "fft" and rec.fft and rec.c is None
    wav = (np.random.default_rng(400).standard_normal(400 * sr)
           * 3000).astype(np.int16)
    before = dict(K.LAUNCHES_BY_TIER)
    db, n_frames, smin, smax = streaming_spec_db(wav, win, hop, ops, None,
                                                 None, sr=sr)
    n_seg = len(_seg_plan_for(n_frames, 4096, 8))
    assert n_frames == 40001 > STREAMING_FRAME_THRESHOLD and n_seg == 2
    assert K.LAUNCHES_BY_TIER == dict(before, fft=before["fft"] + n_seg)
    short = wav[:30 * sr]
    with pytest.raises(ValueError, match="analysis window"):
        streaming_spec_db(short, win, hop, c, s, fb, device="cuda")
    assert torch.equal(
        streaming_spec_db(short, win, hop, c, s, fb, window=window,
                          device="cuda")[0],
        streaming_spec_db(short, win, hop, ops, None, None)[0])
    x = torch.from_numpy(reflect_pad_center(wav, win)).cuda()
    kw = dict(win=win, hop=hop)
    for a in range(0, n_frames, 8192):
        b = min(n_frames, a + 8192)
        seg = x[a * hop:(b - 1) * hop + win]
        plain = K.mel_spectrogram_plain(seg, *f32, n_frames=b - a, **kw)
        wit = _f64_db(seg, f32, n_frames=b - a, **kw)
        ok, floor = _agree_as_plain(db[a:b], plain, wit)
        print(f"frames {a}-{b}: plain's f32 floor {floor:.3g} of the peak, "
              f"{int((~ok).sum())} bins out")
        assert bool(ok.all()), (a, floor)
        if a == 0:  # the bf16 kernel on the same frames fails the rule
            fast = K.prepare_operands(*K.operands_bf16(*f32), "fast")
            got = K.mel_spectrogram_cuda(seg, fast, n_frames=b - a,
                                         mode="fast", **kw)
            assert not bool(_agree_as_plain(got, plain, wit)[0].all())
            del fast, got
    valid = db[:n_frames]
    assert (smin, smax) == (float(valid.min()), float(valid.max()))


class _Track:
    """The parameters of a track at ``sr`` under the survey's setting."""

    def __init__(self, sr):
        from msv_tpu_torch.config import derive_stft_params

        p = derive_stft_params(sr, SpecSetting())
        self.sr, self.n_fft = sr, p.n_fft
        self.win_length, self.hop_length = p.win_length, p.hop_length


def test_a_card_session_builds_no_dft_operands_at_the_fft_tier_rates(
        monkeypatch):
    """Without a card: a session on "cuda" (the device check stubbed, the
    uploads recorded instead of made) routes the parity launches at 384,
    250 and 192 kHz to the FFT tier and builds and uploads no C or S for
    them, while the 48 kHz rate keeps its resident tier and its f32 C, S
    and fb; in fast mode every rate's route reads C and S."""
    from msv_tpu_torch import precision_mode_scope
    from msv_tpu_torch.kernels import spectrogram_cuda as K

    uploads = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(K, "operands_from_numpy",
                        lambda c, s, fb, device: uploads.append(
                            (c.shape, str(device))) or (c, s, fb))
    # the FFT tier's tables stay on the host
    monkeypatch.setattr(K.MelOperands, "to", lambda self, device: self)
    mt = MultiTrack(SpecSetting(), device="cuda")
    for sr in RATES:
        mt._ensure_sr_operands(_Track(sr))
    routes = [mt._operands[sr] for sr in RATES]
    assert [r.tier("parity") for r in routes] == [
        "fft", "fft", "fft", "resident"]
    assert [r.record("parity").fft for r in routes[:3]] == [True, True, True]
    assert uploads == [((1920, 1025), "cuda")]
    with precision_mode_scope("fast"):
        assert [r.tier("fast") for r in routes] == [
            "chunked", "resident", "resident", "resident"]


@pytest.mark.gpu
def test_the_frontend_takes_the_fft_tier_at_384_khz_on_the_card():
    """log_mel_spectrogram in parity at 384 kHz (25 ms windows of 9600
    samples, n_fft 16 384: no resident parity block holds them) launches
    the FFT tier, as tier_for says, on a record made without C or S (the
    frontend's C/S cache is not touched), within chip_smoke's window_agree
    of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import importlib.util
    import os

    from msv_tpu_torch import features
    from msv_tpu_torch.kernels import spectrogram_cuda as K

    torch.backends.cuda.matmul.allow_tf32 = False
    sr = 384000
    wav = (np.random.default_rng(9).standard_normal((2, sr)) * 0.1).astype(
        np.float32)
    misses = features.feature_operands.cache_info().misses
    before = dict(K.LAUNCHES_BY_TIER)
    got = features.log_mel_spectrogram(wav, sr, precision="parity")
    assert K.LAUNCHES_BY_TIER == dict(before, fft=before["fft"] + 1)
    assert features.feature_operands.cache_info().misses == misses
    win, hop, n_fft = 9600, 3840, 16384
    setting = (sr, win, n_fft, 128, 0.0, None, "slaney")
    dense = features.feature_operands(*setting, torch.device("cuda"))
    padded = features.pad_batch(wav, win).cuda()
    kw = dict(win=win, hop=hop, n_frames=got.shape[1])
    plain = K.mel_spectrogram_plain(padded, *dense, **kw)
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec_ = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(cs)
    wit = cs.f64_witness_cuda(padded, *(t.double() for t in dense), win, hop,
                              kw["n_frames"])
    agree, _, own = cs.window_agree(got, plain, wit)
    assert bool(agree.all()), (int((~agree).sum()), own)


@pytest.fixture(scope="module")
def upload_wavs(tmp_path_factory):
    """10 s files: a 384 kHz mono PCM16 (an int16 carrier), a 44.1 kHz
    stereo PCM16 (an int32 sum) and a 44.1 kHz float WAV of noise (no
    integer carrier), the last two of one group."""
    from msv_tpu_torch.io.audio import write_wav

    d = tmp_path_factory.mktemp("upload")
    g = torch.Generator().manual_seed(23)
    noise = np.random.default_rng(23).standard_normal(441000) * 0.1
    paths = []
    for name, sr, x, bits in (
            ("mono384k", 384000, signals.song(g, 384000, 10.0, 1, "cpu"), 16),
            ("stereo44k", 44100, signals.song(g, 44100, 10.0, 2, "cpu"), 16),
            ("float44k", 44100, noise.astype(np.float32)[None], 32)):
        paths.append(str(d / f"{name}.wav"))
        if bits == 16:
            signals.write_wav(paths[-1], x, sr)
        else:
            write_wav(paths[-1], x, sr, bits=32)
    return paths


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("scale", ["mel", "linear"])
def test_a_card_session_pads_each_group_on_the_card_bit_for_bit(
        upload_wavs, scale, mode):
    """A card session of the three files gives each plane, smin and smax
    bit for bit as the rate's route (``MelRoute`` or ``LinearRoute``)
    gives them on the batch padded and stacked on the host
    (``chip_smoke.host_padded``), in parity and fast; each group's
    ``session.upload`` span has route "device_pad" and the carriers'
    bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import importlib.util
    import os

    from msv_tpu_torch import precision_mode_scope
    from msv_tpu_torch.session import multitrack as tmt
    from msv_tpu_torch.utils import profiling

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec_ = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(cs)
    setting = SpecSetting(freq_scale=FreqScale.LINEAR if scale == "linear"
                          else FreqScale.MEL)
    profiling.clear()
    with precision_mode_scope(mode):
        mt = MultiTrack(setting, device="cuda")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            mt.add_tracks([0, 1, 2], upload_wavs)
        ups = [s for s in profiling.recorded() if s.name == "session.upload"]
        profiling.clear()
        assert [mt.tracks[i].wire for i in range(3)] == ["i16", "f32", "f32"]
        assert mt.tracks[2]._wav_int is None
        groups = {}
        for i, tr in mt.tracks.items():
            groups.setdefault((tr.sr, tmt._frame_counts(tr)[1]), []).append(i)
        assert sorted(groups.values()) == [[0], [1, 2]]
        assert sorted(u.attrs["tracks"] for u in ups) == [1, 2]
        for (sr, nfp), ids in groups.items():
            trs = [mt.tracks[i] for i in ids]
            rows = [cs.host_padded(tr) for tr in trs]
            wave = torch.from_numpy(np.stack([r[0] for r in rows])).cuda()
            n_valid = [r[1] for r in rows]
            if scale == "mel":
                db = mt._operands[sr](wave, nfp, mode=mode, sr=sr)
                mm = [(float(db[b, :nf].min()), float(db[b, :nf].max()))
                      for b, nf in enumerate(n_valid)]
            else:
                db, smin, smax = mt._operands[sr](
                    wave, nfp, torch.tensor(n_valid, device="cuda"),
                    mode=mode, sr=sr)
                mm = list(zip(smin.tolist(), smax.tolist()))
            for b, i in enumerate(ids):
                st = mt._state[i]
                assert torch.equal(st.spec_db, db[b]), (scale, mode, sr, i)
                assert (st.smin, st.smax) == mm[b], (scale, mode, sr, i)
            (up,) = [u for u in ups if u.attrs["tracks"] == len(ids)]
            assert up.attrs == {
                "route": "device_pad", "tracks": len(ids),
                "carrier": {1: "i16", 2: "f32+i32"}[len(ids)],
                "bytes": sum(tmt._carrier(tr)[0].nbytes for tr in trs)}
        del mt, wave, db
        torch.cuda.empty_cache()


# The survey on the linear scale (``survey384k_linear``): on the CPU every
# rate takes the dense pair; the card's FFT tier is held to the same
# reference in tests/test_torch_card_linear.py.

LINEAR_CONFIG = registry.config("survey384k_linear")


def test_the_linear_configuration_is_the_survey_on_the_linear_scale():
    assert LINEAR_CONFIG["tracks"] == CONFIG["tracks"]
    assert LINEAR_CONFIG["setting"] == dict(SETTING, freq_scale="linear")
    assert LINEAR_CONFIG["reduced"] == []


@pytest.mark.parametrize("tid", range(len(RATES)),
                         ids=[f"{sr // 1000}k" for sr in RATES])
def test_each_linear_plane_matches_the_plain_reference(survey, survey_linear,
                                                       tid):
    """Each linear plane (n_fft // 2 + 1 bins: 8193, 8193, 4097, 1025) and
    the session's max_db against ``linear_db``, within the mel planes'
    DB_TOL over bins within 60 dB of their frame's peak."""
    _, tracks = survey
    setting = LINEAR_CONFIG["setting"]
    ref = spec.linear_db(spec.mono_f32(tracks[tid]["pcm"]),
                         tracks[tid]["sr"], setting, "cpu")
    got = torch.from_numpy(survey_linear.get_spec_db(tid))
    assert got.shape == ref.shape
    assert got.shape[1] == (8193, 8193, 4097, 1025)[tid]
    assert check.db_gap(got, ref) < DB_TOL
    assert survey_linear.max_sr == 384000


def test_linear_streaming_through_the_route_matches_the_whole_plane(
        survey, survey_linear):
    """The 192 kHz track streamed through the session's own LinearRoute in
    segments of 16 frames: the whole plane's values within atol 2e-3 dB,
    rtol 1e-4 (one GEMM against several), and its min and max."""
    from msv_tpu_torch.parallel.streaming import streaming_spec_db

    mt, tracks = survey_linear, survey[1]
    tr = mt.tracks[2]
    route = mt._operands[tr.sr]
    db, nf, smin, smax = streaming_spec_db(
        tr._wav_int, tr.win_length, tr.hop_length, route, None, None,
        chunk_frames=8, seg_chunks=2, sr=tr.sr)
    whole = torch.from_numpy(mt.get_spec_db(2))
    assert nf == whole.shape[0] == mt._state[2].n_frames
    torch.testing.assert_close(db[:nf], whole, atol=2e-3, rtol=1e-4)
    assert abs(smin - float(whole.min())) <= 2e-3 + 1e-4 * abs(smin)
    assert abs(smax - float(whole.max())) <= 2e-3 + 1e-4 * abs(smax)


def test_linear_streaming_at_the_fft_tier_launches_each_segment_alone(
        survey, survey_linear, monkeypatch):
    """Streaming the 192 kHz track where its route takes the FFT tier (the
    tier stubbed, the launch stood in for by the route's dense pair): one
    ``linear_spectrogram_cuda`` call a segment, on the route's record and
    into its rows of the plane, and no call of the route itself (its
    masked min/max is not computed beside streaming's own); the plane, its
    min and max are the route's segment by segment."""
    from msv_tpu_torch.kernels import spectrogram_cuda as K
    from msv_tpu_torch.kernels.pipeline import spec_pipeline
    from msv_tpu_torch.parallel import streaming

    mt = survey_linear
    tr = mt.tracks[2]
    route = mt._operands[tr.sr]
    launches = []

    def launch(seg, rec, *, win, hop, n_frames, out, sr):
        launches.append((rec, n_frames, sr))
        db, _, _ = spec_pipeline(
            seg, *route.dense(), None, n_frames, win=win, hop=hop,
            n_frames=n_frames, use_mel=False, mode="parity")
        return out.copy_(db)

    monkeypatch.setattr(K.LinearRoute, "tier_here", lambda self, mode: "fft")
    monkeypatch.setattr(K.LinearRoute, "record", lambda self: "record")
    monkeypatch.setattr(K.LinearRoute, "__call__", None)
    monkeypatch.setattr(streaming, "linear_spectrogram_cuda", launch)
    db, nf, smin, smax = streaming.streaming_spec_db(
        tr._wav_int, tr.win_length, tr.hop_length, route, None, None,
        chunk_frames=8, seg_chunks=2, sr=tr.sr)
    plan = streaming._seg_plan_for(nf, 8, 2)
    assert launches == [("record", 8 * k, tr.sr) for k in plan]
    whole = torch.from_numpy(mt.get_spec_db(2))
    torch.testing.assert_close(db[:nf], whole, atol=2e-3, rtol=1e-4)
    assert (smin, smax) == (float(db[:nf].min()), float(db[:nf].max()))


def test_a_card_linear_session_builds_no_dft_operands_at_the_fft_tier_rates(
        monkeypatch):
    """Without a card: a linear session on "cuda" (the device check
    stubbed, the uploads recorded instead of made) routes the parity calls
    at 384, 250 and 192 kHz to the linear FFT tier and builds and uploads no
    C or S for them; the 48 kHz route keeps the GEMM pair and its f32 C and
    S; in fast mode every rate's route takes the pair."""
    from msv_tpu_torch import precision_mode_scope
    from msv_tpu_torch.kernels import spectrogram_cuda as K

    uploads = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(K, "operands_from_numpy",
                        lambda c, s, fb, device: uploads.append(
                            (c.shape, fb, str(device))) or (c, s, fb))
    mt = MultiTrack(SpecSetting(freq_scale=FreqScale.LINEAR), device="cuda")
    for sr in RATES:
        mt._ensure_sr_operands(_Track(sr))
    routes = [mt._operands[sr] for sr in RATES]
    assert all(isinstance(r, K.LinearRoute) for r in routes)
    assert [r.tier_here("parity") for r in routes] == [
        "fft", "fft", "fft", "gemm"]
    assert [sorted(r._forms) for r in routes] == [[]] * 3 + [["f32"]]
    assert uploads == [((1920, 1025), None, "cuda")]
    with precision_mode_scope("fast"):
        assert [r.tier_here("fast") for r in routes] == ["gemm"] * 4
