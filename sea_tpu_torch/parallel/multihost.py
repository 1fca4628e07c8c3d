"""torch.distributed initialisation: the port's copy of
``sea_tpu/parallel/multihost.py``.

``initialize_multihost`` joins the process group that ``torchrun`` (or
any launcher setting its variables) describes, or one given by explicit
arguments. With neither it does nothing: a single-process run stays on
the plain path. When a cluster is configured and joining it fails, the
error is raised, never swallowed: N processes that each think they are
alone would each train, and each claim to be rank 0.

The backend: ``nccl`` where each rank owns its own GPU, ``gloo`` on the
CPU or when ranks share a card (NCCL refuses two ranks on one device).
Under gloo the tensors stay on the card and the kernels run there; gloo
moves the collectives' buffers through host memory.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# The torchrun environment (torch.distributed.run sets all four).
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# How long a collective waits for every rank before it raises.
_TIMEOUT = datetime.timedelta(seconds=600)


def cluster_configured() -> bool:
    """True when the environment names a process group of 2 or more."""
    return (all(os.environ.get(v) for v in _ENV)
            and int(os.environ["WORLD_SIZE"]) > 1)


def local_device(device: torch.device) -> torch.device:
    """The card this rank computes on for a requested ``device``: a bare
    "cuda" means cuda:LOCAL_RANK where the host has a card for each local
    rank, else cuda:0 (the ranks share it). Any other device is kept."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", 0))
    n = torch.cuda.device_count()
    return torch.device("cuda", local if local < n else 0)


def backend_for(device: torch.device, local_world: int = 1) -> str:
    """nccl where each of the host's ``local_world`` ranks owns a card,
    else gloo."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None, *,
                         device="cpu", backend: Optional[str] = None
                         ) -> bool:
    """Join the process group; True when this process is one rank of two
    or more. Explicit arguments (``init_method`` such as
    ``tcp://localhost:PORT``, ``world_size``, ``rank``) take precedence
    over the torchrun environment; with neither, or an initialised group
    already, nothing happens. ``device``: where this rank computes (picks
    the backend unless ``backend`` is given)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = any(a is not None for a in (init_method, world_size, rank))
    if not explicit and not cluster_configured():
        return False
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # The ranks on this host: torchrun's count, or (explicit arguments)
    # all of them, one host.
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size
                                     or os.environ.get("WORLD_SIZE", 1)))
    kw = dict(backend=backend or backend_for(device, local_world),
              timeout=_TIMEOUT)
    if explicit:
        kw.update(init_method=init_method or "env://",
                  world_size=world_size, rank=rank)
    dist.init_process_group(**kw)  # raises on failure: never swallowed
    return dist.get_world_size() > 1


def is_primary() -> bool:
    """Rank 0, or a process outside any group: the one that prints
    metrics and writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device, fn, args, queue):
    try:
        dev = torch.device(device)
        initialize_multihost(f"tcp://localhost:{port}", world, rank,
                             device=dev, backend="gloo")
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException as exc:  # reported to the parent, then raised
        import traceback
        queue.put((rank, None, traceback.format_exc()))
        raise exc


def run_ranks(fn, world: int, *args, device="cpu"):
    """fn(*args) in ``world`` spawned processes joined in one process group
    (``tcp://localhost``, gloo; a "cuda:N" device puts every rank on
    that card),
    each its own rank; returns their results, by rank. ``fn`` must be
    importable by name (a module-level function) and its result
    picklable. A rank's exception is raised here with its traceback."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = mp.start_processes(
        _rank_main, args=(world, free_port(), str(device), fn, args, queue),
        nprocs=world, join=False, start_method="spawn")
    results, errors = [None] * world, []
    for _ in range(world):  # read before joining: results fill the pipe
        rank, out, err = queue.get()
        results[rank] = out
        if err:
            errors.append(f"rank {rank}:\n{err}")
    try:
        procs.join()
    except Exception:
        if not errors:
            raise
    if errors:
        raise RuntimeError("\n".join(errors))
    return results
