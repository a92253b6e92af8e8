"""The linear-scale reference on the CPU: its dB plane against a float64
FFT of the same frames, the grey heights of songs7's rates on the linear
scale, and the judge of a small linear session."""

import numpy as np
import pytest
import torch

from portbench import check, harness, registry
from portbench.reference import render, spec

SETTING = registry.config("songs7_linear")["setting"]
SONGS7_RATES = [8000, 16000, 22050, 24000, 44100, 44100, 48000]


def f64_linear_db(x, sr):
    """The same frames in float64: reflect padding, periodic Hann / n_fft,
    an rfft of n_fft points, 20 log10 with the 1e-18 floor."""
    win, hop, n_fft = spec.stft_params(sr, SETTING)
    half = win // 2
    xp = np.pad(x.astype(np.float64), (half, half), mode="reflect")
    nf = spec.n_frames(len(x), win, hop)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / win)
    fr = np.lib.stride_tricks.sliding_window_view(xp, win)[::hop][:nf]
    left = (n_fft - win) // 2
    fr = np.pad(fr * w / n_fft, ((0, 0), (left, n_fft - win - left)))
    mag = np.abs(np.fft.rfft(fr, n=n_fft, axis=1))
    return np.where(mag > spec.AMIN, 20 * np.log10(np.maximum(mag, 1e-300)),
                    20 * np.log10(spec.AMIN))


@pytest.mark.parametrize("sr", [8000, 22050, 48000])
def test_linear_db_matches_a_float64_fft_of_the_same_frames(sr):
    n = 2 * sr + 37  # a last frame that reads the reflected tail
    t = np.arange(n) / sr
    rng = np.random.default_rng(sr)
    x = (0.3 * np.sin(2 * np.pi * 440 * t)
         + 0.01 * rng.standard_normal(n)).astype(np.float32)
    got = spec.linear_db(x, sr, SETTING, "cpu").numpy()
    ref = f64_linear_db(x, sr)
    _, _, n_fft = spec.stft_params(sr, SETTING)
    assert got.shape == ref.shape == (ref.shape[0], n_fft // 2 + 1)
    keep = ref >= ref.max(axis=1, keepdims=True) - check.DEEP_DB
    # f32 frames and an FFT of log2(n_fft) <= 11 stages, each rounding at
    # about 2^-24 of the frame's norm: relative to a bin 60 dB under its
    # frame's peak that is 11 * 6e-8 * 1000 = 6.6e-4, or 0.0057 dB
    assert np.abs(got - ref)[keep].max() < 0.0057


def test_linear_db_in_blocks_equals_one_block(monkeypatch):
    x = np.random.default_rng(1).standard_normal(8000 * 3).astype(
        np.float32)
    whole = spec.linear_db(x, 8000, SETTING, "cpu")
    monkeypatch.setattr(spec, "BLOCK_FRAMES", 64)
    assert torch.equal(spec.linear_db(x, 8000, SETTING, "cpu"), whole)


def test_linear_grey_heights_of_songs7_rates():
    heights = []
    for sr in SONGS7_RATES:
        _, _, n_fft = spec.stft_params(sr, SETTING)
        heights.append(spec.grey_height(
            n_fft // 2 + 1, spec.up_ratio_for(sr, 48000, "linear")))
    assert heights == [1542, 1539, 1117, 1026, 1116, 1116, 1025]
    # the mel scale keeps its own ratio
    for sr in SONGS7_RATES:
        assert spec.up_ratio_for(sr, 48000, "mel") == spec.up_ratio(sr, 48000)


def test_spec_levels_pads_the_grey_to_the_linear_height():
    """A plane of one bright top bin: at the 8 kHz track's ratio (6) the
    grey is 1542 rows, 257 of them the plane's, so the crop's top five
    sixths are black and only the bottom sixth holds the bright bin."""
    plane = torch.full((400, 257), -120.0)
    plane[:, -1] = 0.0
    lv = render.spec_levels(plane, 8000, spec.up_ratio_for(8000, 48000,
                                                          "linear"),
                            0.0, -120.0, 100, 300, 0.0, 12.0, 8000 * 12)
    assert lv.shape == (300, 1200)
    rows = np.flatnonzero(lv.max(axis=1) > 0)
    assert 245 <= rows.min() <= 252 and rows.max() < 256


def small_linear():
    c = registry.cell("songs7.open_linear")
    for t in c["config"]["tracks"]:
        t["seconds"] = 3
    return c


def test_the_judge_of_a_small_linear_session(monkeypatch):
    """A sound CPU session on the linear scale is held to its limits over
    its planes and all 14 crops; a mel reference of it could not be
    compared at all."""
    seen = {}
    real = check.judge

    def keep(run, out):
        seen["run"], seen["out"] = run, out
        return real(run, out)

    c = small_linear()
    monkeypatch.setattr(check, "judge", keep)
    res = harness.run_cell(c, 2**31 + 23, 1.0, False, device="cpu")
    ok, checks = check.verdict(res["numbers"],
                               check.limits("songs7.open_linear"))
    assert ok, checks
    out = seen["out"]
    assert sorted(im["kind"] for im in out["images"]) == ["spec"] * 7 + [
        "wav"] * 7
    for tid, tr in enumerate(c["config"]["tracks"]):
        _, _, n_fft = spec.stft_params(tr["sr"], SETTING)
        assert out["planes"][tid].shape[1] == n_fft // 2 + 1
    run = seen["run"]
    run.config = dict(run.config, setting=dict(SETTING, freq_scale="mel"))
    assert real(run, out)["db_err_db"] == float("inf")
