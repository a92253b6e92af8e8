"""``msv_tpu_torch/ops/scan.py`` (the port's log-depth scans of a linear
recurrence with a constant pole) against float64 sequential loops.

Bounds, relative to the largest |y| of the f64 answer: 5e-6 for the real
and complex poles over 2^20 samples at |p| up to 0.9999 (measured: at most
2.4e-7; the f32 answer of a sequential loop with an f32 pole is off by
about eps / (1 - |p|) = 6e-4 at 0.9999, which the f64 powers avoid), and
for the 2x2 form at the K-weighting shelf's pole radius (0.86) over 2^16
samples.  The scans agree with msv_tpu's associative scans to f32 noise
(their summation order differs), held through the filter, loudness and
PCEN tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from scipy.signal import lfilter  # noqa: E402

from msv_tpu_torch.ops.scan import matrix_scan, pole_scan  # noqa: E402

N = 1 << 20
BOUND = 5e-6


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("p", [0.5, -0.9, 0.995, 0.9999, -0.9999])
def test_real_pole_matches_f64_loop(p, rng):
    u = rng.standard_normal(N).astype(np.float32)
    got = pole_scan(torch.from_numpy(u), p).numpy()
    want = lfilter([1.0], [1.0, -p], u.astype(np.float64))
    assert got.dtype == np.float32
    assert _rel_err(got, want) < BOUND


@pytest.mark.parametrize("radius,angle", [(0.9, 0.3), (0.995, 0.012),
                                          (0.9999, 2.0)])
def test_complex_pole_matches_f64_loop(radius, angle, rng):
    p = radius * complex(np.cos(angle), np.sin(angle))
    u = rng.standard_normal(N).astype(np.float32)
    got = pole_scan(torch.complex(torch.from_numpy(u),
                                  torch.zeros(N)), p).numpy()
    want = lfilter([1.0], [1.0, -p], u.astype(np.complex128))
    assert got.dtype == np.complex64
    assert _rel_err(got, want) < BOUND


def _matrix_loop(u0, u1, a):
    s0 = s1 = 0.0
    out = np.empty((len(u0), 2))
    (a00, a01), (a10, a11) = a
    for n in range(len(u0)):
        s0, s1 = a00 * s0 + a01 * s1 + u0[n], a10 * s0 + a11 * s1 + u1[n]
        out[n] = s0, s1
    return out


def test_matrix_form_at_the_shelf_radius(rng):
    from msv_tpu_torch.ops.loudness import k_weighting_coeffs

    (_, sa), _ = k_weighting_coeffs(48000)
    a = [[-sa[1], 1.0], [-sa[2], 0.0]]
    radius = float(np.sqrt(sa[2]))
    assert 0.8 < radius < 0.9  # complex poles of the shelf
    n = 1 << 16
    u = rng.standard_normal((2, n)).astype(np.float32)
    s0, s1 = matrix_scan(torch.from_numpy(u[0]), torch.from_numpy(u[1]), a)
    want = _matrix_loop(u[0].astype(np.float64), u[1].astype(np.float64), a)
    assert _rel_err(s0.numpy(), want[:, 0]) < BOUND
    assert _rel_err(s1.numpy(), want[:, 1]) < BOUND


def test_scan_along_an_inner_axis_and_short_lengths(rng):
    """``dim`` picks the axis (PCEN scans frames of (B, T, n_mel)); one
    and two samples are the input and one step."""
    u = rng.standard_normal((3, 37, 5)).astype(np.float32)
    got = pole_scan(torch.from_numpy(u), 0.7, dim=1).numpy()
    want = lfilter([1.0], [1.0, -0.7], u.astype(np.float64), axis=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    one = torch.tensor([2.0])
    assert pole_scan(one, 0.5).tolist() == [2.0]
    assert pole_scan(torch.tensor([1.0, 1.0]), 0.5).tolist() == [1.0, 1.5]
