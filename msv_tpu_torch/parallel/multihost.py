"""Multi-process deployment, ported from ``msv_tpu/parallel/multihost.py``
onto ``torch.distributed``.

The compute story is unchanged across processes: the (dp, sp) mesh spans
every process's devices (``make_global_mesh``), each process drives the
shards on its own devices, halos that cross processes go by
``dist.batch_isend_irecv`` and the dB range by ``all_reduce``
(``parallel/sharded.py``).  Each process decodes its own files
(``assign_tracks_by_host``): audio bytes never cross processes.  The
group's backend is NCCL where there is a card and gloo on the CPU.
"""

import os

import torch
import torch.distributed as dist

from . import mesh


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Join the process group of a multi-process run (a no-op for
    ``num_processes`` <= 1, as in msv_tpu).

    ``coordinator_address`` is ``host:port`` of rank 0's store; without it
    ``torch.distributed``'s environment (MASTER_ADDR, MASTER_PORT) is used.
    ``num_processes`` and ``process_id`` default to WORLD_SIZE and RANK
    from the environment, else 1 and 0.  On NCCL the process takes the
    card of its LOCAL_RANK (else of its rank), modulo the cards it sees.
    Call once per process before any sharded call."""
    if num_processes is not None and num_processes <= 1:
        return
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    nccl = torch.cuda.is_available()
    if nccl:  # NCCL's collectives run on the current card
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if nccl else "gloo",
        init_method=(f"tcp://{coordinator_address}" if coordinator_address
                     else "env://"),
        world_size=world, rank=rank)


def assign_tracks_by_host(paths, process_index=None, process_count=None):
    """Deterministic round-robin file scatter: which of ``paths`` this
    process decodes.  Every process computes the same assignment (no
    coordination needed — the list order IS the contract)."""
    pi = mesh.process_index() if process_index is None else process_index
    pc = mesh.process_count() if process_count is None else process_count
    return [p for i, p in enumerate(paths) if i % pc == pi]


def make_global_mesh(n_dp: int = 1, n_sp: int | None = None,
                     local_devices=None):
    """A (dp, sp) mesh over every process's devices, rank by rank.
    ``local_devices`` are this process's (default: every CUDA device of a
    single process; in a group of several, the process's current card);
    the lists are exchanged with ``all_gather_object``."""
    world = mesh.process_count()
    if local_devices is None:
        local_devices = mesh.default_devices() if world == 1 else [
            torch.device("cuda", torch.cuda.current_device())]
    local = [str(torch.device(d)) for d in local_devices]
    if world == 1:
        return mesh.grid_mesh(n_dp, n_sp, local)
    lists = [None] * world
    dist.all_gather_object(lists, local)
    devices = [d for names in lists for d in names]
    ranks = [r for r, names in enumerate(lists) for _ in names]
    return mesh.grid_mesh(n_dp, n_sp, devices, ranks)
