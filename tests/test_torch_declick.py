"""The port's de-clicker (``msv_tpu_torch/ops/declick.py``, on the CPU)
against ``msv_tpu/ops/declick.py``.

Detection rides LPC, which is ill-conditioned on periodic frames, so a
residual ratio near the threshold can flip a flag between the two
packages.  The planted clicks here are decisive (their spans hold with the
threshold moved 2% either way), and there the span lists must be equal;
the repaired audio is held within the round trip's 2e-5
(tests/test_specedit.py:88).  On clean material both packages' detections
are counted and must agree.

On a pure tone the card may end a span one sample away from the CPU: an
NVIDIA H100 run ended one at 12347 where the CPU ends it at 12346.  That
card test holds each span end within one sample, the audio outside the
moved spans within 2e-5, and inside them within ``MOVED_SPAN_ATOL``.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

T = importlib.import_module("msv_tpu_torch.ops.declick")
try:
    J = importlib.import_module("msv_tpu.ops.declick")
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}
SR = 16000
ATOL = 2e-5
# Moving one end of one of ``_clicked_tone``'s spans by one sample on the
# CPU changes its AR fill by at most 2.1e-3 (of a 0.4 tone; the fill is
# 1.4e-2 off the clean tone).
MOVED_SPAN_ATOL = 5e-3


@pytest.fixture(autouse=True)
def _reference(request):
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _tone(seconds=1.0, f=440.0, amp=0.4):
    t = np.arange(int(SR * seconds)) / SR
    return (amp * np.sin(2 * np.pi * f * t)).astype(np.float32)


def _clicked(times=(0.15, 0.41, 0.77), width=3, amp=0.6, seed=0):
    """tests/test_declick.py's planted clicks, seeded signs, in a tone over
    white noise: noise keeps the LPC fit well conditioned (on a pure tone
    the residual's tail, where a span ends, follows f32 rounding: a card
    run ended a span one sample later than the CPU's)."""
    rng = np.random.default_rng(seed)
    out = _tone() + (0.05 * rng.standard_normal(SR)).astype(np.float32)
    for ts in times:
        i = int(ts * SR)
        out[i:i + width] += np.float32(rng.choice([-1.0, 1.0]) * amp)
    return out


def _clicked_tone(times=(0.15, 0.41, 0.77), width=3, amp=0.6, seed=0):
    """The planted clicks in a pure tone, where LPC is ill-conditioned."""
    rng = np.random.default_rng(seed)
    out = _tone()
    for ts in times:
        i = int(ts * SR)
        out[i:i + width] += np.float32(rng.choice([-1.0, 1.0]) * amp)
    return out


def test_the_planted_clicks_are_decisive():
    """The fixture's spans hold with the threshold 2% either way, so f32
    order cannot move them."""
    x = _clicked()
    spans = [T.find_clicks(x, SR, thresh=9.0 * f, **CPU)
             for f in (0.98, 1.0, 1.02)]
    assert spans[0] == spans[1] == spans[2] and len(spans[1]) == 3


def test_residual_equals_jax():
    rng = np.random.default_rng(1)
    order, n = 6, 3000
    sig = np.concatenate([np.zeros(order, np.float32),
                          rng.standard_normal(n).astype(np.float32)])
    a_up = rng.standard_normal((n, order + 1)).astype(np.float32)
    got = T._residual_core(sig, a_up, order=order, n=n, **CPU)
    want = np.asarray(J._residual_core(sig, a_up, order=order, n=n))
    # the same sum in the same order; XLA may fuse a product into the add
    # (measured: 2 of 3 000 values one f32 step apart)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"thresh": 10.0}, {"contrast": 0.0}])
def test_find_clicks_equals_jax(kw):
    x = _clicked()
    got = T.find_clicks(x, SR, **kw, **CPU)
    assert got == J.find_clicks(x, SR, **kw)
    for ts in (0.15, 0.41, 0.77):
        assert any(a <= int(ts * SR) < b for a, b in got)


@pytest.mark.parametrize("ar_max_ms", [4.0, 0.1])  # AR fill, spectral patch
def test_declick_matches_jax(ar_max_ms):
    x = _clicked()
    out, spans, skipped = T.declick(x, SR, ar_max_ms=ar_max_ms, **CPU)
    jout, jspans, jskipped = J.declick(x, SR, ar_max_ms=ar_max_ms)
    assert spans == jspans and skipped == jskipped and len(spans) == 3
    np.testing.assert_allclose(out, np.asarray(jout), atol=ATOL, rtol=0)


def test_edge_click_is_reported_as_in_jax():
    x = _clicked(times=(0.002, 0.5))
    got = T.declick(x, SR, **CPU)
    want = J.declick(x, SR)
    assert got[1] == want[1] and got[2] == want[2] and len(got[2]) == 1
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=ATOL)


@pytest.mark.parametrize("kind", ["tone", "noise"])
def test_clean_material_detections_agree(kind):
    x = (_tone() if kind == "tone" else (0.1 * np.random.default_rng(2)
         .standard_normal(SR)).astype(np.float32))
    got, want = T.find_clicks(x, SR, **CPU), J.find_clicks(x, SR)
    assert len(got) == len(want) and got == want


def test_validation():
    with pytest.raises(ValueError):
        T.find_clicks(_tone(), SR, thresh=1.0, **CPU)
    with pytest.raises(ValueError):
        T.find_clicks(np.zeros((2, 3000), np.float32), SR, **CPU)
    assert T.find_clicks(np.zeros(100, np.float32), SR, **CPU) == []
    x = _tone()
    out, spans, skipped = T.declick(x, SR, **CPU)
    assert spans == skipped == [] and out is not None
    np.testing.assert_array_equal(out, x)


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _clicked()
    out, spans, skipped = T.declick(x, SR, device="cuda")
    cout, cspans, cskipped = T.declick(x, SR, **CPU)
    assert spans == cspans and skipped == cskipped
    np.testing.assert_allclose(out, cout, atol=ATOL, rtol=0)


@pytest.mark.gpu
def test_card_matches_cpu_on_a_pure_tone():
    """The known difference stays bounded: the same spans, each end within
    one sample of the CPU's, and the audio within 2e-5 outside the spans
    that moved (``MOVED_SPAN_ATOL`` inside them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _clicked_tone()
    out, spans, skipped = T.declick(x, SR, device="cuda")
    cout, cspans, cskipped = T.declick(x, SR, **CPU)
    print(f"pure tone: card spans {spans}, CPU spans {cspans}")
    assert skipped == cskipped == [] and len(spans) == len(cspans) == 3
    moved = np.zeros(len(x), bool)
    for (a, b), (ca, cb) in zip(spans, cspans):
        assert abs(a - ca) <= 1 and abs(b - cb) <= 1
        if (a, b) != (ca, cb):
            moved[min(a, ca):max(b, cb)] = True
    np.testing.assert_allclose(out[~moved], cout[~moved], atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[moved], cout[moved], atol=MOVED_SPAN_ATOL,
                               rtol=0)
