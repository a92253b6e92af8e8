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
