"""One run of one cell: set-up, the measured window, the per-layer
readings and the comparison with the reference.  ``run.py`` is the
command line around :func:`run_cell`."""

import contextlib
import gc
import tempfile
import threading
import time
from collections import defaultdict

import torch

from . import check, registry, signals, trace


class Run:
    """What one run knows and records.  Traffic kinds fill ``counts``,
    ``stages`` (the sessions' own ``StageTimer`` totals) and ``spans``
    (the harness's spans around calls into the program); per-layer
    readers read them, and ``events`` in a traced run."""

    def __init__(self, cell: dict, seed: int, device, traced: bool):
        self.cell = cell
        self.name = cell["name"]
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.seed = int(seed)
        self.device = torch.device(device)
        self.traced = traced
        self.tracks = []
        self.counts = defaultdict(int)
        self.stages = defaultdict(lambda: [0, 0.0])  # name -> [calls, s]
        self.spans = defaultdict(lambda: [0, 0.0])
        self.events = None
        self.host_spans = []  # (name, start_ns, end_ns) in a traced run
        self.window = None  # (start_ns, end_ns) in the trace's clock
        self.device_ops = None
        self.samples = None  # each open's or gesture's seconds
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        """Host-clock total of ``name``, from any thread; in a traced run
        also its interval on the wall clock that the profiler's events
        use, for the idle gaps' labels."""
        t0 = time.perf_counter()
        w0 = time.time_ns()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self.spans[name]
                s[0] += 1
                s[1] += dt
                if self.traced:
                    self.host_spans.append((name, w0, time.time_ns()))

    def add_stages(self, summary: dict) -> None:
        with self._lock:
            for k, v in summary.items():
                s = self.stages[k]
                s[0] += v["calls"]
                s[1] += v["total_s"]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setting(self):
        from msv_tpu_torch.config import FreqScale, SpecSetting

        s = self.config["setting"]
        return SpecSetting(win_ms=s["win_ms"], t_overlap=s["t_overlap"],
                           f_overlap=s["f_overlap"],
                           freq_scale=FreqScale(s["freq_scale"]),
                           db_range=s["db_range"])


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run_cell(cell: dict, seed: int, seconds: float, traced: bool,
             device="cuda", t_start=None, precision=None) -> dict:
    """One run.  ``precision`` overrides the configuration's precision mode
    (the control runs the program's "fast" path).  Returns {"setup_s",
    "e2e", "memory_peak_bytes" (on a card), "samples", "attempted",
    "failed", "run", "numbers", "judge_s"} and, traced, {"window_s",
    "busy_s", "breakdown"}."""
    from msv_tpu_torch import config as pconfig

    t0 = time.perf_counter() if t_start is None else t_start
    run = Run(cell, seed, device, traced)
    kind = registry.traffic_kind(run.traffic["kind"])
    pconfig.set_precision_mode(precision or run.config["precision"])
    pconfig.set_image_wire(run.config["image_wire"])
    res = {}
    with tempfile.TemporaryDirectory(prefix="portbench_") as d:
        run.tracks = signals.make_tracks(run.config, run.seed, d, run.device)
        state = kind.setup(run)
        run.sync()
        res["setup_s"] = time.perf_counter() - t0
        prof = _profiler(run.device) if traced else contextlib.nullcontext()
        window = (torch.profiler.record_function(trace.WINDOW) if traced
                  else contextlib.nullcontext())
        with prof, window:
            res["e2e"] = kind.window(run, state, seconds)
            run.sync()
        if run.device.type == "cuda":
            res["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
                run.device)
        out = kind.outputs(run, state)
        del state
        gc.collect()
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        res["samples"] = run.samples
        res["attempted"] = run.counts["attempted"]
        res["failed"] = run.counts["failed"]
        if traced:
            run.events = trace.events_of(prof)
            run.window = trace.window_of(run.events)
            run.device_ops = trace.device_intervals(run.events, run.window)
            res["window_s"] = (run.window[1] - run.window[0]) / 1e9
            res["busy_s"] = trace.busy_ns(run.device_ops) / 1e9
            res["breakdown"] = {
                "device_ops": trace.top_device_ops(run.device_ops),
                "idle_gaps": trace.idle_gaps(run.host_spans, run.device_ops,
                                             run.window)}
        res["run"] = run
        t_judge = time.perf_counter()
        res["numbers"] = check.judge(run, out)
        res["judge_s"] = time.perf_counter() - t_judge
    return res


def per_layer(run: Run, entries) -> dict:
    """{name: {"value", "unit"}} of the per-layer entries whose readers
    find something to read."""
    out = {}
    for m in entries:
        v = registry.metric(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
