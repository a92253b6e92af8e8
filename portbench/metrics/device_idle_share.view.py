"""The device's idle share over the traced window of browsing, %: one
minus the union of kernel, copy and set intervals over the window."""

from portbench import trace


def read(run):
    if not run.counts["requests"] or not run.device_ops:
        return None
    return 100.0 * trace.idle_share(run.device_ops, run.window)
