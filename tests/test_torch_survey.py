"""The survey session on the CPU: four short AudioMoth-style mono PCM16
files at 384, 250, 192 and 48 kHz opened together in one ``MultiTrack``
(the benchmark's ``survey384k`` configuration, cut to 0.4 s a file),
against the benchmark's plain reference (``portbench/reference``: an FFT
of n_fft points in float32, nothing of the program): each track's dB
plane, the session's max_db, the grey heights of the rates aligned at
384 kHz, and the first screen's crops as PNGs.

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
    f32 operands."""
    frames = (x.double() * 2.0**-15).unfold(0, win, hop)[:n_frames]
    re, im = frames @ ops.c.double(), frames @ ops.s.double()
    mel = torch.sqrt(re * re + im * im) @ ops.fb.double()
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
def test_a_400_s_384_khz_file_streams_through_the_chunked_tier_on_the_card():
    """400 s at 384 kHz is 40 001 frames, over the session's streaming
    threshold: streamed in two segments, each one chunked-tier launch of the
    parity kernel, against the kernel's plain version over the same padded
    wave in blocks, by a tolerance derived from the plain route's own f32
    error (``_agree_as_plain``), which the bf16 kernel fails."""
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
    c, s = dft.windowed_dft_matrices(default_stft_window(win, p.n_fft),
                                     p.n_fft)
    f32 = K.operands_from_numpy(c, s, calc_mel_fb_default(sr, p.n_fft),
                                "cuda")
    ops = K.prepare_operands(*f32)
    wav = (np.random.default_rng(400).standard_normal(400 * sr)
           * 3000).astype(np.int16)
    before = dict(K.LAUNCHES_BY_TIER)
    db, n_frames, smin, smax = streaming_spec_db(wav, win, hop, ops, None,
                                                 None, sr=sr)
    n_seg = len(_seg_plan_for(n_frames, 4096, 8))
    assert n_frames == 40001 > STREAMING_FRAME_THRESHOLD and n_seg == 2
    assert K.LAUNCHES_BY_TIER == dict(before,
                                      chunked=before["chunked"] + n_seg)
    x = torch.from_numpy(reflect_pad_center(wav, win)).cuda()
    kw = dict(win=win, hop=hop)
    for a in range(0, n_frames, 8192):
        b = min(n_frames, a + 8192)
        seg = x[a * hop:(b - 1) * hop + win]
        plain = K.mel_spectrogram_plain(seg, *f32, n_frames=b - a, **kw)
        wit = _f64_db(seg, ops, n_frames=b - a, **kw)
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
