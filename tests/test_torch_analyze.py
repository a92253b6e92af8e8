"""The port's ``analyze`` report (``msv_tpu_torch/features.py``, on the
CPU) against ``msv_tpu/features.py::analyze``, field by field with
``chip_smoke.report_close``: integer counts, the structure boundaries,
the active span and the key's name equal; the key's r within 1e-2 (the
fast-precision chroma, tests/test_torch_viewer.py's key bound); loudness
within 0.02 LU, the other floats within their rounding step plus their
ops' port-test tolerances.  The signal is 5 s (``segment`` runs from 4 s):
a seeded sequence of decaying notes over noise, with one click.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch import precision_mode_scope  # noqa: E402
from msv_tpu_torch.features import analyze  # noqa: E402

try:
    from msv_tpu import config as jcfg
    from msv_tpu.features import analyze as janalyze
except ImportError:  # no jax
    janalyze = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
SR = 16000


@pytest.fixture(autouse=True)
def _reference(request):
    if janalyze is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _notes(seconds=5.0, seed=3):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    x = np.zeros(n)
    for i, f in enumerate([220, 247, 262, 294, 330, 349, 392, 440] * 2):
        a = int(i * 0.3 * SR)
        b = min(n, a + int(0.25 * SR))
        x[a:b] += 0.3 * np.sin(2 * np.pi * f * t[:b - a]) * np.exp(
            -3 * t[:b - a])
    x += 0.01 * rng.standard_normal(n)
    x[int(2.2 * SR)] += 0.8
    return x.astype(np.float32)


@pytest.mark.parametrize("mode", ["parity", "default"])
def test_analyze_matches_jax(mode):
    x = _notes()
    if mode == "parity":
        jcfg.set_precision_mode("parity")
        with precision_mode_scope("parity"):
            got = analyze(x, SR, device="cpu")
    else:
        got = analyze(x, SR, device="cpu")
    want = janalyze(x, SR)
    assert set(got) == set(want)
    ok, note = cs.report_close(got, want)
    assert ok, note
    assert got["n_clicks"] == want["n_clicks"] >= 1
    assert got["segments_s"] == want["segments_s"]


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _notes()
    ok, note = cs.report_close(analyze(x, SR, device="cuda"),
                               analyze(x, SR, device="cpu"))
    assert ok, note
