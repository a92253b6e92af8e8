"""The survey on the linear scale (``survey384k_linear``) and its cell
through the registry, the judge's choice of reference for it, the two
readers of the linear route's ultrasonic groups on synthetic spans and
device events (a kernel whose device start the trace maps before its
stage included), and the roofline's linear count at 384 kHz."""

from collections import defaultdict

import numpy as np
import pytest

from msv_tpu_torch.utils import profiling
from msv_tpu_torch.utils.profiling import Span
from portbench import check, registry, roofline
from portbench.reference import spec
from portbench.reference.spec import n_frames, stft_params

MS = 1_000_000  # ns
BENCH = registry.benchmark()
CELL = "survey384k_linear.open"
RATES = (384000, 250000, 192000, 48000)


class FakeRun:
    def __init__(self, opens, events=None, window=(0, 10_000 * MS)):
        self.counts = defaultdict(int, opens=opens)
        self.window = window
        self.events = events
        self.config = registry.config("survey384k_linear")
        self.tracks = [{"sr": sr, "pcm": np.zeros((1, 300 * sr), np.int16)}
                       for sr in RATES]


@pytest.fixture()
def spans(monkeypatch):
    got = []
    monkeypatch.setattr(profiling, "recorded", lambda: list(got))
    return got


def span(name, a_ms, b_ms, span_id, parent_id=None, **attrs):
    return Span(name, int(a_ms * MS), int(b_ms * MS), 1, span_id, parent_id,
                None, attrs)


def read(name, run):
    return registry.metric(name).read(run)


def one_open(t0, ids, tiers=("fft", "fft", "fft", "gemm")):
    """One open's groups: a linear_minmax stage a rate, 500 ms apart, each
    holding its linear.launch span; the stage of rate r lasts r / 10 000
    ms."""
    out = []
    for k, (sr, tier) in enumerate(zip(RATES, tiers)):
        a = t0 + 500 * k
        stage = next(ids)
        out += [span("add_tracks.linear_minmax", a, a + sr / 10_000, stage),
                span("linear.launch", a + 1, a + 2, next(ids), stage, sr=sr,
                     tier=tier)]
    return out


def test_the_configuration_and_its_cell_load_through_the_registry():
    c = registry.cell(CELL)
    assert (c["config_name"], c["traffic_name"]) == ("survey384k_linear",
                                                     "open")
    registry.check_cell_entry(BENCH, c)
    mel = registry.config("survey384k")
    assert c["config"]["tracks"] == mel["tracks"]
    assert c["config"]["setting"] == dict(mel["setting"],
                                          freq_scale="linear")
    assert c["config"]["reduced"] == []
    entry = next(e for e in BENCH["configs"]
                 if e["name"] == "survey384k_linear")
    assert entry["source"] == c["config"]["source"]
    assert len(entry["source"]) <= 200 and entry["reduced"] == []
    got = []
    for sr in RATES:
        win, hop, n_fft = stft_params(sr, c["config"]["setting"])
        got.append((n_frames(300 * sr, win, hop), n_fft // 2 + 1))
    assert got == [(30001, 8193), (30001, 8193), (30001, 4097),
                   (30001, 1025)]
    # 2.58 GB of f32 planes a session
    assert sum(4 * f * b for f, b in got) == 2_581_046_032
    e2e, layers = registry.metrics_for(BENCH, CELL)
    assert {m["name"] for m in e2e} == {"setup_s", "open_s"}
    names = {m["name"] for m in layers}
    assert {"ultrasonic_linear_ms.open", "ultrasonic_linear_roofline_share",
            "linear_minmax_ms.open", "linear_roofline_share",
            "decode_s.open", "session_s.open", "png_encode_ms.open",
            "device_idle_share.open"} == names
    assert check.limits(CELL)["wav_px_err"] == 0
    assert check.limits(CELL)["failed"] == 0


def test_the_judge_takes_linear_db_for_the_cell(monkeypatch):
    """check.judge works the new cell's reference planes out with
    ``spec.linear_db`` (n_fft // 2 + 1 bins), never ``spec.mel_db``."""
    import torch

    asked = []

    def linear(mono, sr, setting, device):
        asked.append(("linear", sr))
        return torch.zeros((2, 3))

    monkeypatch.setattr(spec, "linear_db", linear)
    monkeypatch.setattr(spec, "mel_db", lambda *a: pytest.fail("mel_db"))
    run = FakeRun(1)
    run.device = torch.device("cpu")
    run.tracks = [{"sr": sr, "pcm": np.zeros((1, 4), np.int16)}
                  for sr in RATES]
    nums = check.judge(run, {"planes": {}, "range": (0.0, -120.0),
                             "images": [], "failed": 0})
    assert asked == [("linear", sr) for sr in RATES]
    assert nums["failed"] == 0.0


def test_ultrasonic_linear_ms_sums_the_stages_of_192_khz_and_above(spans):
    ids = iter(range(1, 100))
    spans += one_open(10, ids) + one_open(3000, ids)
    spans += [span("add_tracks.linear_minmax", 5000, 5999, 99)]  # no call
    # two opens of 38.4 + 25 + 19.2 ms
    assert read("ultrasonic_linear_ms.open", FakeRun(2)) == pytest.approx(
        82.6)


def test_the_linear_readers_find_nothing_without_linear_launch_spans(spans):
    """The parent's program has no linear.launch span: both readers return
    None, and so they do where no group runs at 192 kHz or more."""
    spans += [span("add_tracks.linear_minmax", 10, 400, 1)]
    events = [("k", "kernel", 20 * MS, 300 * MS, 1)]
    names = ("ultrasonic_linear_ms.open", "ultrasonic_linear_roofline_share")
    for name in names:
        assert read(name, FakeRun(1, events)) is None
    spans += [span("linear.launch", 11, 12, 2, 1, sr=48000, tier="gemm")]
    for name in names:
        assert read(name, FakeRun(1, events)) is None


def test_the_linear_roofline_share_picks_kernels_by_overlap(spans):
    """Kernels whose interval overlaps an ultrasonic stage count whole,
    one whose device start the trace maps 1.7 ms before its stage
    included; copies, the 48 kHz group's kernels and kernels outside every
    stage do not count."""
    ids = iter(range(1, 100))
    spans += one_open(10, ids)
    events = [
        ("linear_db_fft_kernel", "kernel", 8.3 * MS, 12 * MS, 1),  # early
        ("amax", "kernel", 12 * MS, 13 * MS, 1),
        ("Memcpy HtoD", "gpu_memcpy", 509 * MS, 520 * MS, 1),  # a copy
        ("linear_db_fft_kernel", "kernel", 515 * MS, 519 * MS, 1),
        ("linear_db_fft_kernel", "kernel", 1010 * MS, 1012 * MS, 1),
        ("gemm", "kernel", 1512 * MS, 1514 * MS, 1),  # 48 kHz
        ("other", "kernel", 5000 * MS, 5100 * MS, 1)]
    run = FakeRun(1, events)
    least = sum(roofline.least_seconds(*roofline.linear_work(
        300 * sr, sr, run.config["setting"])) for sr in RATES[:3])
    want = 100.0 * least / ((3.7 + 1 + 4 + 2) * MS / 1e9)
    assert read("ultrasonic_linear_roofline_share", run) == pytest.approx(
        want)
    # the start rule of linear_roofline_share drops the early kernel
    start = registry.metric("linear_roofline_share").kernel_ns(
        events, [s for s in spans if s.name == "add_tracks.linear_minmax"])
    assert start == (1 + 4 + 2 + 2) * MS
    run.events = []
    assert read("ultrasonic_linear_roofline_share", run) is None


def test_linear_work_at_384_khz_is_bound_by_bytes():
    """The least time of a 300 s 384 kHz linear plane is its bytes' (PCM16
    in, 30 001 x 8193 f32 out), 0.362 ms; the three ultrasonic tracks'
    0.881 ms an open."""
    setting = registry.config("survey384k_linear")["setting"]
    ops, nbytes = roofline.linear_work(300 * 384000, 384000, setting)
    assert ops == 30001 * (2.5 * 16384 * 14 + 3 * 8193)
    assert nbytes == 2 * 115_200_000 + 4 * 30001 * 8193
    assert roofline.least_seconds(ops, nbytes) == pytest.approx(
        nbytes / roofline.PEAK_HBM_BYTES_PER_S)
    least = sum(roofline.least_seconds(*roofline.linear_work(
        300 * sr, sr, setting)) for sr in RATES[:3])
    assert least == pytest.approx(8.81e-4, rel=2e-3)


def test_a_small_run_of_the_cell_on_the_cpu_is_correct():
    """The cell at 0.5 s a file on the CPU (every rate on the dense pair):
    the harness opens, renders the 8193-12 584-row greys' crops and
    judges them, and the run is correct under the cell's limits."""
    from portbench import harness

    c = registry.cell(CELL)
    for t in c["config"]["tracks"]:
        t["seconds"] = 0.5
    res = harness.run_cell(c, 2**31 + 24, 0.5, False, device="cpu")
    ok, checks = check.verdict(res["numbers"], check.limits(CELL))
    assert ok and res["failed"] == 0, checks


@pytest.mark.parametrize("fault", ["row_shift", "unwritten"])
def test_a_render_fault_in_the_spectrogram_crops_is_not_correct(fault):
    """render_fault.py's faults at 0.5 s a file on the CPU: every
    spectrogram crop one pixel row off, or left black, reads over the
    cell's spec_level_err limit, and the planes still pass."""
    from portbench import harness, render_fault

    c = registry.cell(CELL)
    for t in c["config"]["tracks"]:
        t["seconds"] = 0.5
    unplant = render_fault.plant(fault)
    try:
        res = harness.run_cell(c, 2**31 + 24, 0.5, False, device="cpu")
    finally:
        unplant()
    lims = check.limits(CELL)
    ok, checks = check.verdict(res["numbers"], lims)
    assert not ok, checks
    assert res["numbers"]["spec_level_err"] > lims["spec_level_err"], checks
    assert res["numbers"]["db_err_db"] <= lims["db_err_db"], checks
