"""Joining a ``torch.distributed`` group, and starting the ranks of one.

Counterpart of ``transformer_clip_eeg_tpu/parallel/distributed.py``.  JAX
runs one controller per host and joins the hosts with
``jax.distributed.initialize``; the port runs one process per rank, each
holding one replica of the model and the optimizer state.

:func:`initialize_distributed` joins a group from explicit arguments or the
environment: the JAX names (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) or torch's (``MASTER_ADDR`` and
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them).  It
returns False when nothing names a group: one process, not an error.

:func:`launch` starts ``n`` ranks of a function itself, with the ``spawn``
start method, joined through a file store in a temporary directory (no TCP
port), so one command line runs a data-parallel job as the JAX CLI does.
One rank runs in the calling process.

The backend (:func:`backend_for`): NCCL when each rank of a host has a card
of its own, gloo on the CUDA tensors when ranks outnumber the cards (NCCL
refuses two ranks on one device), gloo for CPU ranks.  Rank ``r`` runs on
``cuda:(local_rank % device_count)``.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


def local_rank_and_size(rank: int, world_size: int) -> tuple:
    """This process's rank among the ranks of its host, and their number
    (``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` under ``torchrun``; else every
    rank is on this host)."""
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world_size)))


def rank_device(device, local_rank: int) -> torch.device:
    """The device of a rank: ``cuda:(local_rank % device_count)`` for a CUDA
    job, the CPU for a CPU one."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank was asked for but CUDA is not available; pass "
                           "device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def backend_for(device, local_world_size: int) -> str:
    """NCCL when each of the host's ranks has a card of its own, else gloo
    (CPU ranks, or more ranks than cards)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def _init_method(address: str) -> str:
    """A JAX-style ``host:port`` as a TCP URL; a URL (``tcp://``,
    ``file://``, ``env://``) as it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> bool:
    """Join the ``torch.distributed`` group this process belongs to.

    Arguments left out are read from the environment: the JAX names first,
    then torch's.  Returns True once the group is joined (also when it
    already was), False when nothing names a coordinator (one process).  On
    a CUDA job the rank's card becomes the current device before the group
    is made, as NCCL needs."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and env.get("MASTER_ADDR"):
        # torch's variables: env:// also joins torchrun's own store
        coordinator_address = "env://"
    if num_processes is None:
        n = env.get("JAX_NUM_PROCESSES") or env.get("WORLD_SIZE")
        num_processes = int(n) if n else None
    if process_id is None:
        r = env.get("JAX_PROCESS_ID") or env.get("RANK")
        process_id = int(r) if r else None
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator {coordinator_address!r} given without the number of "
                         "processes and this process's id")
    local_rank, local_size = local_rank_and_size(process_id, num_processes)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev, local_size),
                            init_method=_init_method(coordinator_address),
                            world_size=num_processes, rank=process_id)
    return True


def _rank_entry(rank: int, n: int, init_method: str, device, target: Callable,
                args: Sequence, n_model: int = 1) -> int:
    """One rank: join the group, run ``target(*args, mesh)``, leave it.  In
    a spawned process a nonzero result becomes its exit code."""
    from transformer_clip_eeg_tpu_torch.parallel.mesh import make_mesh

    initialize_distributed(init_method, n, rank, device)
    try:
        code = target(*args, make_mesh(n // n_model, n_model, device=device))
    finally:
        dist.destroy_process_group()
    if code and n > 1:
        sys.exit(code)
    return code or 0


def launch(n: int, target: Callable, args: Sequence = (), device="cuda",
           n_model: int = 1) -> int:
    """Run ``target(*args, mesh)`` on ``n`` ranks, a mesh of ``n // n_model``
    x ``n_model``, and return rank 0's code.

    ``n == 1`` runs in this process, in a group of one.  Otherwise the ranks
    are ``n`` processes started with ``spawn`` (``target`` must be a
    module-level function); a rank that raises stops the others and its
    error is raised here, a rank that exits nonzero returns its code."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="tce_dist_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        if n == 1:
            return _rank_entry(0, 1, init_method, device, target, args)
        try:
            mp.start_processes(_rank_entry,
                               args=(n, init_method, device, target, tuple(args), n_model),
                               nprocs=n, join=True, start_method="spawn")
        except mp.ProcessExitedException as e:
            return e.exit_code or 1
    return 0


def run_on_ranks(n: int, target: Callable, args: Sequence = (), device="cuda",
                 n_model: int = 1) -> int:
    """``target(*args, mesh)`` on the ``n`` ranks of an ``n // n_model`` x
    ``n_model`` mesh: in this process when it is a rank of a group already
    (joined by its caller, or named by ``torchrun``'s environment), else on
    ``n`` ranks that :func:`launch` starts.  Returns this process's code
    (rank 0's, when it spawned them).  The entry points' ``--n_data_shards``,
    ``--n_model_shards`` and ``--shard`` run through it."""
    from transformer_clip_eeg_tpu_torch.parallel.mesh import make_mesh

    if dist.is_initialized():
        return target(*args, make_mesh(n // n_model, n_model, device=device))
    if initialize_distributed(device=device):
        try:
            return target(*args, make_mesh(n // n_model, n_model, device=device))
        finally:
            dist.destroy_process_group()
    return launch(n, target, args, device, n_model)
