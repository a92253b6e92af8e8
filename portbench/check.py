"""The comparison that decides ``correct``: what the window produced
against the plain reference (``reference/``), worked out again from the
generated samples.

Numbers compared (each held to its cell's limit, ``limits/<cell>.json``):

  db_err_db       the largest |dB| gap of the program's dB planes from the
                  reference's, over bins no more than DEEP_DB under their
                  frame's loudest bin (deeper bins carry the frame's f32
                  rounding at a large relative size);
  max_db_err_db   the gap of the session's max_db (its loudest bin, capped
                  at 0 dB) from the reference's;
  min_db_err_db   the gap of its min_db: max_db - db_range, or where the
                  session spans less than db_range its deepest bin, which
                  carries f32 rounding at a large relative size and so
                  swings from seed to seed (reported by calibrate.py, not
                  held to a limit: the control's readings do not lie three
                  times above the sound runs');
  spec_level_err  the largest distance, in grey levels, of a decoded
                  spectrogram pixel from the reference's level (a pixel
                  stands for every level its colour paints);
  wav_px_err      the waveform pixels that differ from the reference's;
  failed          the opens or requests that failed.
"""

import json
import os

import numpy as np
import torch

from . import pngdecode
from .reference import colormap, render, spec

DEEP_DB = 60.0
HERE = os.path.dirname(os.path.abspath(__file__))


def limits(cell_name: str) -> dict:
    with open(os.path.join(HERE, "limits", cell_name + ".json")) as f:
        return json.load(f)["limits"]


def db_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |got - ref| over bins within DEEP_DB of their frame's
    loudest reference bin."""
    peak = ref.amax(dim=1, keepdim=True)
    keep = ref >= peak - DEEP_DB
    return float(torch.where(keep, (got - ref).abs(), 0).max())


def spec_gap(png: bytes, ref_levels: np.ndarray) -> float:
    """The largest level distance of a pixel from the reference's."""
    try:
        px = pngdecode.pixels(png)
    except ValueError:
        return 255.0
    if px.shape[:2] != ref_levels.shape or px.shape[2] != 3:
        return 255.0
    ranges = colormap.level_ranges(colormap.grey_lut(8))
    packed = ((px[..., 0].astype(np.int64) << 16)
              | (px[..., 1].astype(np.int64) << 8) | px[..., 2])
    colours, inv = np.unique(packed, return_inverse=True)
    lo = np.array([ranges.get(c, (-1000, -1000))[0] for c in colours])[inv]
    hi = np.array([ranges.get(c, (-1000, -1000))[1] for c in colours])[inv]
    lo, hi = lo.reshape(packed.shape), hi.reshape(packed.shape)
    q = ref_levels.astype(np.int64)
    dist = np.where(lo < 0, 255, np.maximum(0, np.maximum(lo - q, q - hi)))
    return float(dist.max())


def wav_gap(png: bytes, ref_rgba: np.ndarray) -> float:
    try:
        px = pngdecode.pixels(png)
    except ValueError:
        return float(ref_rgba.shape[0] * ref_rgba.shape[1] or 1)
    if px.shape != ref_rgba.shape:
        return float(max(ref_rgba.shape[0] * ref_rgba.shape[1], 1))
    return float((px != ref_rgba).any(axis=2).sum())


def judge(run, out: dict) -> dict:
    """The numbers of a run's outputs:
    out = {"planes": {id: (n_frames, n_bins) f32 array}, "range": (max_db,
    min_db), "images": [{"kind", "id", "pps", "height", "start", "end",
    "amp", "png"}], "failed": int}.  The reference follows the
    configuration's ``freq_scale``: mel bands, or the linear scale's
    n_fft // 2 + 1 bins."""
    setting = run.config["setting"]
    scale = setting["freq_scale"]
    db_plane = spec.linear_db if scale == "linear" else spec.mel_db
    dev = run.device
    refs, smin, smax = {}, [], []
    mono = [spec.mono_f32(tr["pcm"]) for tr in run.tracks]
    for tid, tr in enumerate(run.tracks):
        refs[tid] = db_plane(mono[tid], tr["sr"], setting, dev)
        smin.append(float(refs[tid].min()))
        smax.append(float(refs[tid].max()))
    max_db, min_db = spec.db_window(smin, smax, setting["db_range"])
    max_sr = max(tr["sr"] for tr in run.tracks)
    nums = {"db_err_db": 0.0,
            "max_db_err_db": abs(out["range"][0] - max_db),
            "min_db_err_db": abs(out["range"][1] - min_db)}
    for tid, got in out["planes"].items():
        ref = refs[tid]
        if tuple(got.shape) != tuple(ref.shape):
            nums["db_err_db"] = float("inf")
            continue
        nums["db_err_db"] = max(nums["db_err_db"], db_gap(
            torch.from_numpy(got).to(dev), ref))
    level_err, wav_err = 0.0, 0.0
    for im in out["images"]:
        tr = run.tracks[im["id"]]
        if im["kind"] == "spec":
            levels = render.spec_levels(
                refs[im["id"]], tr["sr"],
                spec.up_ratio_for(tr["sr"], max_sr, scale), max_db, min_db,
                im["pps"], im["height"], im["start"], im["end"],
                tr["pcm"].shape[1])
            level_err = max(level_err, spec_gap(im["png"], levels))
        else:
            ref_img = render.wav_crop(
                mono[im["id"]], tr["sr"], im["pps"], im["height"],
                -im["amp"], im["amp"], im["start"], im["end"])
            wav_err += wav_gap(im["png"], ref_img)
    nums["spec_level_err"] = level_err
    nums["wav_px_err"] = wav_err
    nums["failed"] = float(out["failed"])
    return nums


def verdict(nums: dict, lims: dict):
    """(correct, {name: {"value", "limit"}}) over the limited numbers."""
    checks = {k: {"value": nums[k], "limit": lims[k]} for k in lims}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
