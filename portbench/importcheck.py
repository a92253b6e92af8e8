"""The benchmark measures the PyTorch port alone: no JAX and no JAX
package may be loaded.  Names are compared by their top-level part (before
the first dot) as a whole, so ``msv_tpu_torch`` passes and ``msv_tpu``
does not."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "msv_tpu")


def top_level(names) -> set:
    return {n.split(".", 1)[0] for n in names}


def forbidden(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: every
    module loaded in this process)."""
    if names is None:
        names = list(sys.modules)
    return sorted(top_level(names) & set(FORBIDDEN))
