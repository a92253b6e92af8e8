"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the program."""

import os
import subprocess
import sys

from portbench import importcheck

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_top_level_names_compare_whole():
    assert importcheck.forbidden(["msv_tpu_torch", "msv_tpu_torch.io",
                                  "numpy", "jaxtyping"]) == []
    assert importcheck.forbidden(["msv_tpu.ops", "jax.numpy", "jaxlib",
                                  "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                     "msv_tpu"]


def loaded_after(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = loaded_after(
        "import portbench.run, portbench.harness, portbench.check\n"
        "import portbench.traffic.open, portbench.traffic.view\n"
        "from portbench import registry\n"
        "[registry.metric(m['name']) for m in registry.benchmark()"
        "['per_layer']]\n"
        "import msv_tpu_torch, msv_tpu_torch.session, msv_tpu_torch.viewer")
    assert "msv_tpu_torch" in names
    assert importcheck.forbidden(names) == []


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after(
        "import portbench.reference.spec, portbench.reference.render\n"
        "import portbench.reference.melfb, portbench.reference.colormap\n"
        "import portbench.check, portbench.roofline")
    assert importcheck.forbidden(names) == []
    assert "msv_tpu_torch" not in names
