"""Multi-device scaling and long files, ported from ``msv_tpu/parallel``.

msv_tpu maps the reference's three rayon granularities onto a (dp, sp)
mesh: tracks over "dp", the frames of one waveform over "sp" with a
``(win - hop)``-sample halo, mel columns inside the GEMM, and the global dB
min/max as the one all-reduce.  The port keeps that mesh as a grid of
torch devices driven from one process (``mesh``, ``sharded``; across
processes ``multihost`` on ``torch.distributed``).  ``streaming`` handles
the long-file case on one device.  ``__all__`` is msv_tpu's list;
``streaming_spec_db_mmap`` is bound here too.
"""

from .mesh import make_mesh
from .sharded import (sharded_envelope_minmax, sharded_spec_pipeline,
                      sharded_streaming_spec_db)
from .streaming import streaming_spec_db, streaming_spec_db_mmap

__all__ = [
    "make_mesh",
    "sharded_envelope_minmax",
    "sharded_spec_pipeline",
    "sharded_streaming_spec_db",
    "streaming_spec_db",
]
