"""The mel dB function's share of its roofline over the traced window, %:
the least time of every open's planes (``roofline.mel_work`` of each
track, at the card's peaks) over the device time of the mel kernels,
picked out by the ``__global__`` names of the program's
``csrc/mel_spectrogram*.cu``."""

import glob
import os
import re

from portbench import roofline

_GLOBAL = re.compile(
    r"__global__\s+void\s+"
    r"(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


def kernel_names() -> list:
    import msv_tpu_torch

    names = []
    csrc = os.path.join(os.path.dirname(msv_tpu_torch.__file__), "csrc")
    for path in sorted(glob.glob(os.path.join(csrc, "mel_spectrogram*.cu"))):
        with open(path) as f:
            names += _GLOBAL.findall(f.read())
    return names


def share(run, names) -> float | None:
    ns = sum(b - a for a, b, name in run.device_ops
             if any(k in name for k in names))
    if not ns or not run.counts["opens"]:
        return None
    least = sum(roofline.least_seconds(*roofline.mel_work(
        t["pcm"].shape[1], t["sr"], run.config["setting"]))
        for t in run.tracks)
    return 100.0 * run.counts["opens"] * least / (ns / 1e9)


def read(run):
    if not run.device_ops:
        return None
    return share(run, kernel_names())
