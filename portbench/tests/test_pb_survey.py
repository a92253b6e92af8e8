"""The survey configuration and its cell through the registry, the two
readers of the mel kernel's ultrasonic groups on synthetic spans and
device events, and the roofline's count at 384 kHz."""

import math
from collections import defaultdict

import numpy as np
import pytest

from msv_tpu_torch.utils import profiling
from msv_tpu_torch.utils.profiling import Span
from portbench import registry, roofline
from portbench.reference.melfb import mel_fb_auto
from portbench.reference.spec import n_frames, stft_params

MS = 1_000_000  # ns
BENCH = registry.benchmark()
RATES = (384000, 250000, 192000, 48000)


class FakeRun:
    def __init__(self, opens, events=None, window=(0, 10_000 * MS)):
        self.counts = defaultdict(int, opens=opens)
        self.window = window
        self.events = events
        cfg = registry.config("survey384k")
        self.config = cfg
        self.tracks = [{"sr": t["sr"], "pcm": np.zeros((1, 0), np.int16)}
                       for t in cfg["tracks"]]


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


def one_open(t0, ids):
    """One open's groups: a kernel_minmax stage a rate, each holding its
    mel.launch span, starting 500 ms apart, the stage of rate r lasting
    r / 1000 ms."""
    out = []
    for k, sr in enumerate(RATES):
        a = t0 + 500 * k
        stage = next(ids)
        out += [span("add_tracks.kernel_minmax", a, a + sr / 1000, stage),
                span("mel.launch", a + 1, a + 2, next(ids), stage, sr=sr)]
    return out


def test_the_configuration_and_its_cell_load_through_the_registry():
    c = registry.cell("survey384k.open")
    assert (c["config_name"], c["traffic_name"]) == ("survey384k", "open")
    registry.check_cell_entry(BENCH, c)
    tracks = c["config"]["tracks"]
    assert [t["sr"] for t in tracks] == list(RATES)
    assert all(t["channels"] == 1 and t["seconds"] == 300 for t in tracks)
    # 524.4 MB of PCM16, 30 001 frames a track: all resident (under the
    # session's 32 768-frame streaming threshold)
    assert sum(2 * 300 * t["sr"] for t in tracks) == 524_400_000
    setting = c["config"]["setting"]
    got = []
    for sr in RATES:
        win, hop, n_fft = stft_params(sr, setting)
        got.append((n_frames(300 * sr, win, hop), n_fft,
                    mel_fb_auto(sr, n_fft).shape[1]))
    assert got == [(30001, 16384, 519), (30001, 16384, 743),
                   (30001, 8192, 462), (30001, 2048, 347)]
    e2e, layers = registry.metrics_for(BENCH, "survey384k.open")
    assert {m["name"] for m in e2e} == {"setup_s", "open_s"}
    assert {"ultrasonic_mel_ms.open", "ultrasonic_mel_roofline_share"} <= {
        m["name"] for m in layers}
    assert registry.config("survey384k")["reduced"] == []


def test_ultrasonic_mel_ms_sums_the_stages_of_192_khz_and_above(spans):
    ids = iter(range(1, 100))
    spans += one_open(10, ids) + one_open(3000, ids)
    spans += [span("add_tracks.kernel_minmax", 5000, 5999, 99)]  # no launch
    # two opens of 384 + 250 + 192 ms
    assert read("ultrasonic_mel_ms.open", FakeRun(2)) == pytest.approx(826.0)


def test_ultrasonic_readers_find_nothing_without_mel_launch_spans(spans):
    spans += [span("add_tracks.kernel_minmax", 10, 400, 1)]
    events = [("k", "kernel", 20 * MS, 300 * MS, 1)]
    for name in ("ultrasonic_mel_ms.open", "ultrasonic_mel_roofline_share"):
        assert read(name, FakeRun(1, events)) is None
    spans += [span("mel.launch", 11, 12, 2, 1, sr=48000)]
    for name in ("ultrasonic_mel_ms.open", "ultrasonic_mel_roofline_share"):
        assert read(name, FakeRun(1, events)) is None  # no group >= 192 kHz


def test_ultrasonic_roofline_share_counts_kernels_inside_those_stages(spans):
    ids = iter(range(1, 100))
    spans += one_open(10, ids)
    events = [
        ("mel_db_tf32_chunked_kernel", "kernel", 20 * MS, 300 * MS, 1),
        ("amax", "kernel", 300 * MS, 301 * MS, 1),
        ("Memcpy HtoD", "gpu_memcpy", 515 * MS, 600 * MS, 1),  # no kernel
        ("mel_db_tf32_chunked_kernel", "kernel", 520 * MS, 600 * MS, 1),
        ("mel_db_tf32_kernel", "kernel", 1520 * MS, 1530 * MS, 1),  # 48 kHz
        ("other", "kernel", 5000 * MS, 5100 * MS, 1)]
    run = FakeRun(1, events)
    run.tracks = [{"sr": sr, "pcm": np.zeros((1, 300 * sr), np.int16)}
                  for sr in RATES]
    least = sum(roofline.least_seconds(*roofline.mel_work(
        300 * sr, sr, run.config["setting"])) for sr in RATES[:3])
    want = 100.0 * least / ((280 + 1 + 80) * MS / 1e9)
    assert read("ultrasonic_mel_roofline_share", run) == pytest.approx(want)
    run.events = []
    assert read("ultrasonic_mel_roofline_share", run) is None


def test_mel_work_at_384_khz_counts_an_fft_a_frame():
    setting = registry.config("survey384k")["setting"]
    ops, nbytes = roofline.mel_work(300 * 384000, 384000, setting)
    fb = mel_fb_auto(384000, 16384)
    w = int(np.count_nonzero(fb))
    assert (fb.shape, w) == ((8193, 519), 16284)
    assert ops == 30001 * (2.5 * 16384 * 14 + 3 * 8193 + 2 * w)
    assert nbytes == 2 * 115_200_000 + 4 * 30001 * 519 + 4 * w
    assert math.isclose(ops, 1.8918e10, rel_tol=1e-4)
    # bound by operations: 0.2824 ms at the f32 peak
    assert roofline.least_seconds(ops, nbytes) == pytest.approx(
        ops / roofline.PEAK_F32_FLOPS)
    assert ops / roofline.PEAK_F32_FLOPS == pytest.approx(2.8236e-4,
                                                          rel=1e-4)
