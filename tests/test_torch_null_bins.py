"""Near-null bins: how far two f32 computations of one dB plane may differ.

chip_smoke.py once failed its phase-4 check (the CUDA session against the
same session on the CPU, atol 2e-3 dB + rtol 1e-4) in one bin of a 10 s
44.1 kHz stereo track, when an extra phase ahead of it drew other samples
from its seeded stream.  These tests rebuild those samples, find that bin
on the CPU and hold every route to the rule chip_smoke now applies
(``chip_smoke.f32_agree``): atol/rtol, or, in a bin DEEP_DB or more under
its frame's peak, F32_FLOOR of that peak in amplitude.  The witness is the
kernel's function in float64 on the same f32 inputs.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference: absent where the card-only tests run
pytest.importorskip("jax")

import msv_tpu  # noqa: E402
import msv_tpu_torch  # noqa: E402
from msv_tpu_torch.io.audio import write_wav  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

# Two deep bins of that track, each a pair of one-bin mel bands over the
# same DFT bin, with the parity kernel's values there as an H100 80GB HBM3
# (700 W power limit) computed them: (frame, bands, kernel dB).  The first
# is the bin the check failed in, 0.021 dB from the CPU session.
KERNEL_BINS = [
    (495, (96, 97), -137.2396240234375),
    (256, (34, 35), -117.21250915527344),
]


def _skip_draws(rng, sr, seconds, rows):
    """Advance ``rng`` past chip_smoke.make_signal(rng, sr, seconds, rows)
    without building the signal."""
    n = int(seconds * sr)
    for _ in range(rows):
        rng.uniform(80, 600)
        left = n
        while left:
            k = min(left, 1 << 24)
            rng.standard_normal(k)
            left -= k


def failing_samples():
    """The 10 s 44.1 kHz stereo signal phase 4 wrote when phases 3 and 3b
    (six rates, two 240 s rows each) and the seven 240 s session tracks had
    drawn from the one stream before it."""
    rng = np.random.default_rng(cs.SEED)
    for _ in range(2):
        for sr in cs.RATES:
            _skip_draws(rng, sr, cs.SECONDS, 2)
    for sr in cs.SESSION_RATES:
        _skip_draws(rng, sr, cs.SECONDS, 2)
    return cs.make_signal(rng, 44100, 10.0, 2).astype(np.float32) / 32768.0


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    """(port CPU plane, JAX session plane, f64 witness), float64 tensors."""
    path = str(tmp_path_factory.mktemp("null_bins") / "short_44100.wav")
    write_wav(path, failing_samples() * 0.5, 44100, bits=16)
    port = msv_tpu_torch.MultiTrack(device="cpu")
    port.add_tracks([0], [path])
    ref = msv_tpu.MultiTrack()
    ref.add_tracks([0], [path])
    tr = port.tracks[0]
    padded, n_frames, _ = cs.host_padded(tr)
    wit = cs.f64_witness(padded, *port._operands[tr.sr].dense(),
                         tr.win_length, tr.hop_length, n_frames)
    return (torch.from_numpy(port.get_spec_db(0)).double(),
            torch.from_numpy(ref.get_spec_db(0).copy()).double(), wit)


def _under_peak(plane, f, m):
    return (plane[f].max() - plane[f, m]).item()


@pytest.mark.parametrize("frame,bands,kernel_db", KERNEL_BINS)
def test_kernel_bins_are_deep_f32_rounding(frame, bands, kernel_db, planes):
    """The kernel's value is more than atol/rtol from the f64 witness only
    in the 105 dB deep bin, and both f32 routes are within the floor of
    it.  (At 85 dB down the witness sides with the kernel, at 105 dB with
    the CPU: neither route is the odd one out.)"""
    port, _, wit = planes
    for m in bands:
        w, cpu = wit[frame, m].item(), port[frame, m].item()
        under = _under_peak(wit, frame, m)
        print(f"bin ({frame}, {m}), {under:.1f} dB under its frame's peak: "
              f"kernel {kernel_db:.4f} dB, CPU {cpu:.4f} dB, f64 {w:.4f} dB")
        assert under > cs.DEEP_DB
        row = wit[frame:frame + 1]
        for value in (kernel_db, cpu):
            got = row.clone()
            got[0, m] = value
            agree, _ = cs.f32_agree(got, row)
            assert agree[0, m]
    frame0, (m0, _), kernel0 = KERNEL_BINS[0]
    w0 = wit[frame0, m0].item()
    assert abs(kernel0 - w0) > cs.ATOL + cs.RTOL * abs(w0)
    assert 104.0 < _under_peak(wit, frame0, m0) < 106.0


@pytest.mark.parametrize("route", ["port", "jax"])
def test_every_bin_agrees_with_the_witness(route, planes):
    got = planes[0] if route == "port" else planes[1]
    wit = planes[2]
    agree, close = cs.f32_agree(got, wit)
    assert bool(agree.all())
    assert int((agree & ~close).sum()) / agree.numel() <= cs.FLOOR_SHARE


def test_port_and_jax_sessions_agree(planes):
    port, ref, _ = planes
    agree, close = cs.f32_agree(port, ref)
    assert bool(agree.all())
    assert int((agree & ~close).sum()) / agree.numel() <= cs.FLOOR_SHARE


@pytest.mark.parametrize("frame_under,shift,ok", [
    (10.0, 0.01, False),   # a loud bin off by 0.01 dB: atol/rtol decide
    (59.0, 0.05, False),   # not deep enough for the floor
    (85.0, 0.05, True),    # deep: 0.05 dB is 3.3e-7 of the peak
    (85.0, 0.5, False),    # deep, but 3.3e-6 of the peak
    (110.0, 1.0, True),    # 3.9e-7 of the peak
])
def test_rule_on_single_bins(frame_under, shift, ok):
    want = torch.tensor([[-20.0, -20.0 - frame_under]], dtype=torch.float64)
    got = want.clone()
    got[0, 1] += shift
    agree, _ = cs.f32_agree(got, want)
    assert bool(agree.all()) == ok


def test_rule_limits_the_share_of_floor_bins():
    """check_f32 rejects a plane whose deep bins are all off within the
    floor: the floor is for a few bins, not a mode of error."""
    want = torch.full((100, 20), -120.0, dtype=torch.float64)
    want[:, 0] = -20.0
    got = want.clone()
    got[:, 1:] += 0.05
    agree, close = cs.f32_agree(got, want)
    assert bool(agree.all()) and not bool(close[:, 1:].any())
    with pytest.raises(SystemExit, match="disagree|deep bins"):
        cs.check_f32(got, want, "all deep bins shifted")
    got[:, 1:] = want[:, 1:]
    got[0, 1] += 0.05  # one bin of 2000 needs the floor: 5e-4 <= 1e-3
    assert cs.check_f32(got, want, "one deep bin")[0] == pytest.approx(0.05)
