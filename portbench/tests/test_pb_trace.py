"""Idle share, busy union, breakdown and the roofline count, on synthetic
event lists and shapes."""

import pytest

from portbench import registry, roofline, trace

MS = 1_000_000  # ns


def ev(name, kind, a, b, thread=1):
    return (name, kind, a * MS, b * MS, thread)


EVENTS = [
    ev("pb.window", "user_annotation", 0, 100),
    ev("void mel_db_tf32_kernel<short, 4>(...)", "kernel", 10, 20),
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 15, 30),
    ev("gpu_user_annotation pb.add_tracks", "gpu_user_annotation", 0, 60),
    ev("aten::copy_", "cpu_op", 0, 90),
    ev("elementwise", "kernel", 95, 110),  # runs past the window
]


def test_busy_union_and_idle_share():
    w = trace.window_of(EVENTS)
    assert w == (0, 100 * MS)
    ops = trace.device_intervals(EVENTS, w)
    # kernel 10-20 and copy 15-30 overlap; 95-110 is clipped to 95-100
    assert trace.busy_ns(ops) == 25 * MS
    assert trace.idle_share(ops, w) == pytest.approx(0.75)


def test_breakdown_names_device_ops_and_what_the_host_did():
    w = trace.window_of(EVENTS)
    ops = trace.device_intervals(EVENTS, w)
    top = trace.top_device_ops(ops)
    assert top[0] == ["Memcpy HtoD (Pageable -> Device)", 0.015]
    spans = [("add_tracks", 0, 60 * MS), ("encode_png", 60 * MS, 100 * MS),
             ("request", 0, 100 * MS)]
    gaps = dict(trace.idle_gaps(spans, ops, w))
    # a gap goes to the span over its middle: 0-10 to add_tracks, 30-95
    # (middle 62.5) to encode_png
    assert gaps == {"add_tracks": pytest.approx(0.010),
                    "encode_png": pytest.approx(0.065)}


def test_roofline_of_a_48khz_track_by_hand():
    setting = registry.config("songs7")["setting"]
    ops, nbytes = roofline.mel_work(240 * 48000, 48000, setting)
    # win 1920, hop 480, n_fft 2048: 24 001 frames; 347 bands with 2 034
    # nonzero weights; 2.5 * 2048 * 11 + 3 * 1025 + 2 * 2034 = 63 463 a frame
    assert ops == 24001 * 63463
    assert nbytes == 2 * 11_520_000 + 4 * 24001 * 347 + 4 * 2034
    least = roofline.least_seconds(ops, nbytes)
    assert least == pytest.approx(ops / 67e12)  # bound by operations
    assert least == pytest.approx(22.734e-6, rel=1e-4)


class FakeRun:
    def __init__(self, ops, opens, config, tracks):
        self.device_ops, self.counts = ops, {"opens": opens}
        self.config, self.tracks = config, tracks


def test_roofline_share_counts_the_mel_kernels_only():
    import numpy as np

    m = registry.metric("mel_roofline_share")
    cfg = registry.config("songs7")
    tracks = [{"pcm": np.zeros((2, 240 * 48000), np.int16), "sr": 48000}]
    ops = [(0, 4_273_000, "void mel_db_tf32_kernel<short, 4>(...)"),
           (0, 9_000_000, "gemm")]
    share = m.share(FakeRun(ops, 1, cfg, tracks), ["mel_db_tf32_kernel"])
    assert share == pytest.approx(100 * 22.734e-3 / 4.273, rel=1e-3)
    assert m.share(FakeRun(ops[1:], 1, cfg, tracks),
                   ["mel_db_tf32_kernel"]) is None
    assert m.read(FakeRun([], 1, cfg, tracks)) is None
    assert "mel_db_bf16_kernel" in m.kernel_names()


def test_linear_roofline_of_a_48khz_track_by_hand():
    setting = registry.config("songs7_linear")["setting"]
    ops, nbytes = roofline.linear_work(240 * 48000, 48000, setting)
    # 24 001 frames of 2.5 * 2048 * 11 + 3 * 1025 = 59 395 operations; the
    # PCM16 samples in, 1025 f32 bins a frame out
    assert ops == 24001 * 59395
    assert nbytes == 2 * 11_520_000 + 4 * 24001 * 1025
    least = roofline.least_seconds(ops, nbytes)
    assert least == pytest.approx(nbytes / 3.35e12)  # bound by bytes
    assert least == pytest.approx(36.252e-6, rel=1e-4)


class TracedRun:
    """A traced open run: profiler events, a window and the sessions'
    stage totals."""

    def __init__(self, events, opens, tracks, window=(0, 100 * MS),
                 stages=None):
        self.events, self.window = events, window
        self.counts = {"opens": opens}
        self.config = registry.config("songs7_linear")
        self.tracks = tracks
        self.stages = stages or {}


def test_linear_roofline_share_counts_kernels_inside_the_linear_spans(
        monkeypatch):
    import numpy as np

    from msv_tpu_torch.utils import profiling
    from msv_tpu_torch.utils.profiling import Span

    def sp(name, a, b):
        return Span(name, a * MS, b * MS, 1, 0, None, None, {})

    spans = [sp("add_tracks.linear_minmax", 10, 20),
             sp("add_tracks.linear_minmax", 40, 50),
             sp("add_tracks.h2d", 30, 35),
             sp("add_tracks.linear_minmax", 95, 105)]  # past the window
    monkeypatch.setattr(profiling, "recorded", lambda: spans)
    events = [ev("pb.window", "user_annotation", 0, 100),
              ev("sm90_xmma_gemm_f32f32", "kernel", 11, 12.5),
              ev("elementwise", "kernel", 19.5, 20.5),  # starts inside
              ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 15, 18),
              ev("Memset (Device)", "gpu_memset", 41, 42),
              ev("reduce_kernel", "kernel", 45, 45.5),
              ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 30, 34),
              ev("gemm_outside", "kernel", 31, 33),
              ev("late_gemm", "kernel", 96, 99)]
    tracks = [{"pcm": np.zeros((2, 240 * 48000), np.int16), "sr": 48000}]
    m = registry.metric("linear_roofline_share")
    # kernels 1.5 + 1.0 + 0.5 ms inside the window's spans, two opens
    share = m.read(TracedRun(events, 2, tracks))
    assert share == pytest.approx(100 * 2 * 36.252e-3 / 3.0, rel=1e-4)
    # no kernel inside a span, an untraced run, no opens: nothing to read
    assert m.read(TracedRun(events[3:5] + events[6:8], 2, tracks)) is None
    assert m.read(TracedRun(events, 2, tracks, window=None)) is None
    assert m.read(TracedRun(events, 0, tracks)) is None


def test_linear_minmax_ms_is_the_stage_over_opens():
    m = registry.metric("linear_minmax_ms.open")
    stages = {"add_tracks.linear_minmax": (18, 0.054)}
    assert m.read(TracedRun([], 3, [], stages=stages)) == pytest.approx(18.0)
    assert m.read(TracedRun([], 3, [])) is None
    assert m.read(TracedRun([], 0, [], stages=stages)) is None
