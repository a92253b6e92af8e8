"""``correct`` on the CPU at a small size: sound runs pass, and the
control (the program's "fast" path: the bf16 mel kernel on the mel scale;
on the linear scale TF32 GEMMs, stood in for here by TF32's rounding) and
runs with the timed path broken underneath come out as not correct.  The
same comparison and limits decide the card's runs."""

import numpy as np
import pytest
import torch

from portbench import check, harness, registry

SEED = 2**31 + 11
MEL = ["songs7.open", "hour48k.open", "songs7.view", "hour48k.view"]
LINEAR = ["songs7.open_linear"]
CELLS = MEL + LINEAR


def small(name):
    """3 s songs; a 6-minute hour (36 001 frames: two streamed
    segments)."""
    c = registry.cell(name)
    for t in c["config"]["tracks"]:
        t["seconds"] = 360 if t["signal"] == "hour" else 3
    return c


def verdict(name, **kw):
    res = harness.run_cell(small(name), SEED, 1.0, False, device="cpu", **kw)
    ok, checks = check.verdict(res["numbers"], check.limits(name))
    return ok, {k: c["value"] for k, c in checks.items()}


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    ok, nums = verdict(name)
    assert ok, nums


@pytest.mark.parametrize("name", MEL)
def test_the_control_is_not_correct(name):
    ok, nums = verdict(name, precision="fast")
    assert not ok and nums["db_err_db"] > check.limits(name)["db_err_db"], nums


def _wrap_kernel(monkeypatch, fault):
    """Break every mel launch of the session and of streaming."""
    from msv_tpu_torch.parallel import streaming
    from msv_tpu_torch.session import multitrack

    real = multitrack.mel_spectrogram_cuda
    calls = [0]

    def broken(padded, *a, **kw):
        calls[0] += 1
        db = fault(real(padded, *a, **kw), calls[0])
        if kw.get("out") is not None:  # the launch writes in place
            kw["out"].copy_(db)
        return db

    monkeypatch.setattr(multitrack, "mel_spectrogram_cuda", broken)
    monkeypatch.setattr(streaming, "mel_spectrogram_cuda", broken)


def _wrap_linear(monkeypatch, fault):
    """Break every call of the session's linear route: ``fault`` gets the
    route's (B, n_frames, n_freq) dB planes."""
    from msv_tpu_torch.session import multitrack

    real = multitrack.spec_pipeline_batched
    calls = [0]

    def broken(*a, **kw):
        calls[0] += 1
        db, smin, smax = real(*a, **kw)
        return fault(db, calls[0]), smin, smax

    monkeypatch.setattr(multitrack, "spec_pipeline_batched", broken)


def _wrap(monkeypatch, name, fault):
    """Break the cell's spectrogram route."""
    if name in LINEAR:
        _wrap_linear(monkeypatch, fault)
    else:
        _wrap_kernel(monkeypatch, fault)


def _tf32(x):
    """float32 rounded to TF32's 10-bit mantissa, to nearest with ties
    away from zero, as the tensor cores' conversion rounds."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("name", LINEAR)
def test_the_linear_control_is_not_correct(monkeypatch, name):
    """The card's control, ``--precision fast``, runs the linear route's
    GEMMs in TF32; the CPU has no TF32, so there it changes nothing.  In
    its place the route's frames (the padded wave) and DFT operands are
    rounded to TF32 before GEMMs that accumulate in float32, which is what
    the tensor cores do."""
    from msv_tpu_torch.session import multitrack

    real = multitrack.spec_pipeline_batched

    def tf32(padded, c, s, *a, scale=2.0**-15, **kw):
        if padded.dtype in (torch.int16, torch.int32):
            padded = padded.to(torch.float32) * scale
        return real(_tf32(padded), _tf32(c), _tf32(s), *a, **kw)

    monkeypatch.setattr(multitrack, "spec_pipeline_batched", tf32)
    ok, nums = verdict(name)
    assert not ok and nums["db_err_db"] > check.limits(name)["db_err_db"], nums


def unwritten(db, _):
    """The step leaves its output as it found it."""
    return torch.zeros_like(db)


def half_left_out(db, call):
    """Half of the batch left out: in a launch of several rows the second
    half repeats the first; of one-row launches (streamed segments) every
    second one is left unwritten."""
    if db.ndim == 3 and db.shape[0] > 1:
        h = db.shape[0] // 2
        out = db.clone()
        out[h:2 * h] = db[:h]
        return out
    return torch.zeros_like(db) if call % 2 == 0 else db


def second_row_repeats_first(db, _):
    """Half of a launch of two rows (songs7's 44.1 kHz pair) left out: the
    second row repeats the first."""
    if db.shape[0] != 2:
        return db
    out = db.clone()
    out[1] = db[0]
    return out


@pytest.mark.parametrize("name", CELLS)
def test_an_unwritten_plane_is_not_correct(monkeypatch, name):
    _wrap(monkeypatch, name, unwritten)
    ok, nums = verdict(name)
    assert not ok and nums["db_err_db"] > 1.0, nums


@pytest.mark.parametrize("name", ["songs7.open", "hour48k.open"])
def test_half_the_batch_left_out_is_not_correct(monkeypatch, name):
    _wrap_kernel(monkeypatch, half_left_out)
    ok, nums = verdict(name)
    assert not ok and nums["db_err_db"] > 1.0, nums


@pytest.mark.parametrize("name", LINEAR)
def test_the_second_of_a_pair_repeating_the_first_is_not_correct(
        monkeypatch, name):
    _wrap_linear(monkeypatch, second_row_repeats_first)
    ok, nums = verdict(name)
    assert not ok and nums["db_err_db"] > 1.0, nums


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_image_is_not_correct(monkeypatch, name):
    from msv_tpu_torch.io import png

    real = png.encode_png

    def altered(img, *a, **kw):
        img = np.array(img, copy=True)
        img[img.shape[0] // 2, img.shape[1] // 2, 0] ^= 0x40
        return real(img, *a, **kw)

    monkeypatch.setattr(png, "encode_png", altered)
    ok, nums = verdict(name)
    assert not ok, nums
    assert nums["spec_level_err"] > 1 or nums["wav_px_err"] > 0
