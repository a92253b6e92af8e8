"""Dev-mode numerical debugging, ported from ``msv_tpu/utils/debug.py``.

``enable_nan_checks`` makes every mel kernel launch (and its plain version
on the CPU) and every render's device output raise ``FloatingPointError``
on a NaN, naming the route; off (the default) it adds no work and no sync.
``device_trace`` records a ``torch.profiler`` chrome trace of a block.
"""

import os
from contextlib import contextmanager

import torch

_NAN_CHECKS = False


def enable_nan_checks(on: bool = True) -> None:
    """Turn the NaN checks of the kernel launches and renders on or off.
    Each check is a device reduction and a host sync: dev mode only."""
    global _NAN_CHECKS
    _NAN_CHECKS = bool(on)


def check_nan(t: torch.Tensor, route: str) -> None:
    """Raise FloatingPointError when the checks are on and ``t`` holds a
    NaN."""
    if _NAN_CHECKS and bool(torch.isnan(t).any()):
        raise FloatingPointError(f"NaN in the output of {route}")


@contextmanager
def device_trace(log_dir: str):
    """Record a ``torch.profiler`` trace (CPU, and CUDA where a card is
    present) of everything inside the block into ``log_dir`` as a chrome
    trace (``trace.json``; open it in Perfetto or chrome://tracing)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
