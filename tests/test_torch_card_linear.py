"""Card-only tests of the linear scale at the survey's rates: the FFT tier's
linear form (``csrc/mel_spectrogram_fft.cu``, ``LinearRoute``) against the
benchmark's plain reference (``portbench/reference/spec.py::linear_db``: f32,
TF32 off, ``torch.fft.rfft``), the mel FFT tier's bits beside it, linear
streaming of a long file and a linear survey session.  No JAX here, so the
file runs where the card is:
``python -m pytest --noconftest -m gpu tests/test_torch_card_linear.py``.

Agreement is chip_smoke's ``window_agree``: within atol/rtol of the
reference, or within twice the reference's own f32 error (its largest
distance from a float64 FFT of the same frames) in amplitude relative to
the frame's peak.  Two f32 FFTs of 15 360-sample windows leave bins 60 dB
and more under their frame's peak a few hundredths of a dB apart; the
dense pair in TF32 (fast mode) misses the loudest bins by about 1e-3 of the
peak, which the rule does not admit."""

import hashlib
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch.config import (FreqScale, SpecSetting,  # noqa: E402
                                  derive_stft_params)
from msv_tpu_torch.kernels import spectrogram_cuda as K  # noqa: E402
from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center  # noqa: E402
from msv_tpu_torch.ops.windows import default_stft_window  # noqa: E402
from portbench import check, signals  # noqa: E402
from portbench.reference import spec  # noqa: E402

ULTRASONIC = (384000, 250000, 192000)
# a rate of each FFT plan's n_fft at the session's settings: 768 kHz
# (32 768), the survey's (16 384, 16 384, 8192) and 96 kHz (4096)
FFT_RATES = (768000, *ULTRASONIC, 96000)
SETTING = {"win_ms": 40.0, "t_overlap": 4, "f_overlap": 1,
           "freq_scale": "linear", "db_range": 120.0}
_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(_root, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _route(sr, device="cuda"):
    p = derive_stft_params(sr, SpecSetting())
    window = default_stft_window(p.win_length, p.n_fft)
    return K.LinearRoute(window, win=p.win_length, hop=p.hop_length,
                         n_fft=p.n_fft, device=device)


def _rows(sr, seconds, n=2):
    """n int16 rows of seeded noise and a swept tone."""
    rng = np.random.default_rng(sr + n)
    t = np.arange(int(seconds * sr)) / sr
    return np.stack([
        np.clip(3000 * rng.standard_normal(len(t))
                + 9000 * np.sin(2 * np.pi * (4000 + 9000 * r) * t
                                * (1 + 0.02 * t)), -32768, 32767)
        for r in range(n)]).astype(np.int16)


def _f64_linear_db(mono, route, a, b):
    """Frames [a, b) of ``mono`` (f32 on the card) in float64: the
    reference's reflect pad, the window, the zero pad to n_fft at the left
    offset, |rfft| and 20 log10 with the -360 dB floor."""
    win, hop, n_fft = route.win, route.hop, route.n_fft
    half = win // 2
    x = torch.nn.functional.pad(mono.double()[None, None], (half, half),
                                mode="reflect")[0, 0]
    fr = x[a * hop:(b - 1) * hop + win].unfold(0, win, hop)
    w = torch.from_numpy(route.window.astype(np.float64)).to(x.device)
    left = (n_fft - win) // 2
    fr = torch.nn.functional.pad(fr * w, (left, n_fft - win - left))
    mag = torch.fft.rfft(fr, dim=-1).abs()
    return torch.where(mag > 1e-18, 20.0 * torch.log10(mag), -360.0)


def _agree_with_reference(db, mono_np, route, sr):
    """window_agree of a plane against linear_db over the same samples, in
    blocks of frames; returns (bins out, the reference's own error)."""
    ref = spec.linear_db(mono_np, sr, SETTING, "cuda")
    mono = torch.from_numpy(mono_np).cuda()
    out, worst = 0, 0.0
    for a in range(0, ref.shape[0], 2048):
        b = min(ref.shape[0], a + 2048)
        ok, _, own = cs.window_agree(db[a:b], ref[a:b],
                                     _f64_linear_db(mono, route, a, b))
        out += int((~ok).sum())
        worst = max(worst, own)
    return out, worst


def test_the_fft_rates_cover_every_fft_plan():
    assert sorted({_route(sr, "cpu").n_fft for sr in FFT_RATES}) == sorted(
        K.FFT_PLANS)


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["i16", "f32"])
@pytest.mark.parametrize("sr", FFT_RATES)
def test_the_linear_fft_tier_matches_linear_db_on_the_card(card, sr, wire):
    """A batched group of two 20 s rows at a rate of each FFT plan, on an
    int16 and on an f32 carrier, through the route's FFT tier: one launch,
    each row within window_agree of the reference, the masked min/max the
    plane's; at 384 kHz the TF32 pair (fast mode) fails the rule."""
    route = _route(sr)
    assert route.tier_here("parity") == "fft"
    i16 = _rows(sr, 20.0)
    n = i16.shape[1]
    nf = n_frames_for(n, route.win, route.hop)
    nfp = nf + 77  # a bucket's zero-padded frames, left out of the min/max
    need = (nfp - 1) * route.hop + route.win
    padded = np.stack([np.pad(reflect_pad_center(r, route.win),
                              (0, need - n - 2 * (route.win // 2)))
                       for r in i16])
    x = torch.from_numpy(padded).cuda()
    if wire == "f32":
        x = x.float() * 2.0**-15
    before = dict(K.LINEAR_LAUNCHES_BY_TIER)
    db, smin, smax = route(x, nfp, torch.tensor([nf, nf - 5], device="cuda"),
                           mode="parity", sr=sr)
    assert K.LINEAR_LAUNCHES_BY_TIER == dict(before, fft=before["fft"] + 1)
    assert db.shape == (2, nfp, route.n_fft // 2 + 1)
    assert "f32" not in route._forms
    for b, valid in enumerate((nf, nf - 5)):
        assert (float(smin[b]), float(smax[b])) == (
            float(db[b, :valid].min()), float(db[b, :valid].max()))
        mono = i16[b].astype(np.float32) * np.float32(2.0**-15)
        out, own = _agree_with_reference(db[b, :nf], mono, route, sr)
        print(f"{sr} {wire} row {b}: reference's f32 error {own:.3g} of the "
              f"peak, {out} bins out")
        assert out == 0, (sr, wire, b, own)
    if sr == 384000 and wire == "i16":
        fast, _, _ = route(x[:1], nfp, nf, mode="fast", sr=sr)
        assert _agree_with_reference(fast[0, :nf], i16[0].astype(
            np.float32) * np.float32(2.0**-15), route, sr)[0] > 0


# sha256[:16] of the mel FFT tier's planes (parity, B = 2, 30 s of seeded
# int16 noise, on the int16 and the f32 carrier), as the launches gave them
# before the tier took its linear form (NVIDIA H100 80GB HBM3)
FFT_DIGESTS = {
    "384000/i16": "58fcf16699841ddf", "384000/f32": "58fcf16699841ddf",
    "250000/i16": "65eac0e20fb32617", "250000/f32": "65eac0e20fb32617",
    "192000/i16": "59d8498411f0c0ea", "192000/f32": "59d8498411f0c0ea",
}


def mel_fft_digests():
    """{"<sr>/<wire>": digest} of the mel FFT tier's planes (FFT_DIGESTS)."""
    from msv_tpu_torch.ops.mel import calc_mel_fb_default

    got = {}
    for sr in ULTRASONIC:
        p = derive_stft_params(sr, SpecSetting())
        win, hop, n_fft = p.win_length, p.hop_length, p.n_fft
        route = K.MelRoute(default_stft_window(win, n_fft),
                           calc_mel_fb_default(sr, n_fft), win=win, hop=hop,
                           n_fft=n_fft, device="cuda")
        i16 = (np.random.default_rng(sr).standard_normal((2, 30 * sr))
               * 3000).astype(np.int16)
        x = torch.from_numpy(np.stack([reflect_pad_center(w, win)
                                       for w in i16])).cuda()
        for wire, wave in (("i16", x), ("f32", x.float() * 2.0**-15)):
            y = route(wave, n_frames_for(30 * sr, win, hop), mode="parity",
                      sr=sr)
            got[f"{sr}/{wire}"] = hashlib.sha256(
                y.cpu().numpy().tobytes()).hexdigest()[:16]
    return got


@pytest.mark.gpu
def test_the_mel_fft_tier_keeps_its_bits_on_the_card(card):
    before = K.LAUNCHES_BY_TIER["fft"]
    assert mel_fft_digests() == FFT_DIGESTS
    assert K.LAUNCHES_BY_TIER["fft"] == before + 2 * len(ULTRASONIC)


@pytest.mark.gpu
def test_a_400_s_384_khz_linear_file_streams_through_the_fft_tier(card):
    """400 s at 384 kHz is 40 001 frames, over the session's streaming
    threshold: two segments, each one launch of the FFT tier's linear form
    on the route's record, within window_agree of linear_db; given C and S
    with the window, streaming makes a route of the same plane (30 s), and
    without the window it raises."""
    from msv_tpu_torch.ops.dft import windowed_dft_matrices
    from msv_tpu_torch.parallel.streaming import (_seg_plan_for,
                                                  streaming_spec_db)
    from msv_tpu_torch.session.multitrack import STREAMING_FRAME_THRESHOLD

    sr = 384000
    route = _route(sr)
    wav = _rows(sr, 400.0, n=1)[0]
    before = dict(K.LINEAR_LAUNCHES_BY_TIER)
    db, n_frames, smin, smax = streaming_spec_db(
        wav, route.win, route.hop, route, None, None, sr=sr)
    n_seg = len(_seg_plan_for(n_frames, 4096, 8))
    assert n_frames == 40001 > STREAMING_FRAME_THRESHOLD and n_seg == 2
    assert K.LINEAR_LAUNCHES_BY_TIER == dict(before,
                                             fft=before["fft"] + n_seg)
    assert "f32" not in route._forms
    valid = db[:n_frames]
    assert (smin, smax) == (float(valid.min()), float(valid.max()))
    out, own = _agree_with_reference(
        valid, wav.astype(np.float32) * np.float32(2.0**-15), route, sr)
    assert out == 0, own
    short = wav[:30 * sr]
    c, s = windowed_dft_matrices(route.window, route.n_fft)
    with pytest.raises(ValueError, match="analysis window"):
        streaming_spec_db(short, route.win, route.hop, c, s, None,
                          device="cuda")
    assert torch.equal(
        streaming_spec_db(short, route.win, route.hop, c, s, None,
                          window=route.window, device="cuda")[0],
        streaming_spec_db(short, route.win, route.hop, route, None, None)[0])


@pytest.mark.gpu
def test_a_linear_survey_session_holds_no_dft_operands_on_the_card(
        card, tmp_path):
    """Four 20 s survey files on the linear scale in one card session: the
    384, 250 and 192 kHz groups each take one FFT-tier launch (``linear.
    launch`` spans of tier "fft"), the 48 kHz group the GEMM pair; only
    the 48 kHz route holds C and S, and the session's device bytes are its
    planes and those 15.7 MB, not the 1.9 GB of C and S the
    ultrasonic rates would take; each plane is within 0.01 dB of linear_db
    over bins within 60 dB of their frame's peak."""
    from msv_tpu_torch.session import MultiTrack
    from msv_tpu_torch.utils import profiling

    rates = (*ULTRASONIC, 48000)
    g = torch.Generator().manual_seed(24)
    tracks = []
    for sr in rates:
        pcm = signals.song(g, sr, 20.0, 1, "cpu")
        path = str(tmp_path / f"{sr}.wav")
        signals.write_wav(path, pcm, sr)
        tracks.append((path, sr, pcm))
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    before = dict(K.LINEAR_LAUNCHES_BY_TIER)
    profiling.clear()
    mt = MultiTrack(SpecSetting(freq_scale=FreqScale.LINEAR), device="cuda")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        mt.add_tracks(list(range(4)), [t[0] for t in tracks])
    launches = [(s.attrs["sr"], s.attrs["tier"], s.attrs["n_out"])
                for s in profiling.recorded() if s.name == "linear.launch"]
    profiling.clear()
    assert launches == [(384000, "fft", 8193), (250000, "fft", 8193),
                        (192000, "fft", 4097), (48000, "gemm", 1025)]
    assert K.LINEAR_LAUNCHES_BY_TIER == dict(
        before, fft=before["fft"] + 3, gemm=before["gemm"] + 1)
    assert [sorted(mt._operands[sr]._forms) for sr in rates] == [
        ["record"]] * 3 + [["f32"]]
    planes = sum(st.spec_db.numel() * 4 for st in mt._state.values())
    dense = sum(t.numel() * 4 for t in mt._operands[48000].dense())
    used = torch.cuda.memory_allocated() - base
    assert used <= planes + dense + (64 << 20), (used, planes, dense)
    for tid, (_, sr, pcm) in enumerate(tracks):
        ref = spec.linear_db(spec.mono_f32(pcm), sr, SETTING, "cuda")
        got = mt._state[tid].spec_db[:ref.shape[0]]
        assert check.db_gap(got, ref) < 0.01, sr
    del mt
    torch.cuda.empty_cache()
