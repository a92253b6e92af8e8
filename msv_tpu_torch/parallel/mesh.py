"""Mesh helpers: a (dp, sp) grid of torch devices, ported from
``msv_tpu/parallel/mesh.py``.

dp ("data parallel") shards independent tracks/files; sp ("sequence
parallel") shards the time axis of one waveform.  msv_tpu's mesh is driven
by one controller, and so is this one: one process drives every shard that
lies on its own devices (``parallel/sharded.py``), moving halos between
devices with ``Tensor.to`` and, across processes, with
``torch.distributed`` (``parallel/multihost.py``).  A mesh may list one
device several times: on one card, a (2, 4) mesh of ``cuda:0`` runs the
sharded code paths (halos, reductions) with every shard on that card.
"""

import numpy as np
import torch
import torch.distributed as dist


def process_index() -> int:
    """This process's rank in the initialized process group, else 0."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def process_count() -> int:
    """The process group's size, else 1."""
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


class Mesh:
    """A (dp, sp) grid of devices and the process that drives each.

    ``devices`` is a (dp, sp) object array of ``torch.device``; ``ranks``
    the same grid of process ranks (all this process's on a mesh of one
    process).  A device of another rank names that rank's device.  Meshes
    are hashable and compare by devices and ranks."""

    axis_names = ("dp", "sp")

    def __init__(self, devices, ranks=None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2:
            raise ValueError(f"devices must be a (dp, sp) grid, got shape "
                             f"{devices.shape}")
        self.devices = devices
        self.ranks = (np.full(devices.shape, process_index()) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(
                          devices.shape))

    @property
    def shape(self) -> dict:
        return {"dp": self.devices.shape[0], "sp": self.devices.shape[1]}

    def positions(self):
        """Every (dp, sp) position, row-major (the mesh's device order)."""
        return [(i, j) for i in range(self.devices.shape[0])
                for j in range(self.devices.shape[1])]

    def is_local(self, pos) -> bool:
        """Whether this process drives the device at ``pos``."""
        return int(self.ranks[pos]) == process_index()

    def local_devices(self):
        """This process's devices in mesh order, each once."""
        out = []
        for pos in self.positions():
            if self.is_local(pos) and self.devices[pos] not in out:
                out.append(self.devices[pos])
        return out

    def _key(self):
        return (self.devices.shape, tuple(str(d) for d in self.devices.flat),
                tuple(int(r) for r in self.ranks.flat))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def default_devices():
    """Every CUDA device of this process."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def grid_mesh(n_dp, n_sp, devices, ranks=None) -> Mesh:
    """The first ``n_dp * n_sp`` of ``devices`` (and their ``ranks``) as a
    (dp, sp) mesh; ``n_sp`` defaults to as many as the devices allow."""
    if n_sp is None:
        n_sp = len(devices) // n_dp
    if n_dp * n_sp > len(devices):
        raise ValueError(
            f"mesh {n_dp}x{n_sp} needs {n_dp * n_sp} devices, "
            f"have {len(devices)}"
        )
    devs = np.empty(n_dp * n_sp, dtype=object)
    devs[:] = [torch.device(d) for d in devices[: n_dp * n_sp]]
    return Mesh(devs.reshape(n_dp, n_sp),
                None if ranks is None else ranks[: n_dp * n_sp])


def make_mesh(n_dp: int = 1, n_sp: int | None = None, devices=None) -> Mesh:
    """A (dp, sp) mesh over ``devices`` (default: every CUDA device); a
    device may be listed more than once."""
    return grid_mesh(n_dp, n_sp,
                     list(devices) if devices is not None
                     else default_devices())
