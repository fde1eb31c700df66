"""The ``(data, model)`` rank mesh over ``torch.distributed`` (port of
``parallel/mesh.py``), and the collectives the parallel forwards use.

One process is one rank and holds one device.  Rank ``r`` sits at data
index ``r // model`` and model index ``r % model``: the model
(tensor-parallel) axis is the adjacent ranks, as the JAX package's
``reshape(data, model)`` of its device list lays it out.

Backends: ``nccl`` when every rank has a card of its own, ``gloo`` on the
CPU or when ranks share one card.  Gloo takes only ``all_reduce`` and
``broadcast`` of CUDA tensors, so under gloo every collective of a CUDA
tensor here is staged through host memory, explicitly, one copy each way.
A collective that fails raises, as ``torch.distributed`` does.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import MeshConfig
from ..device import resolve_device

@dataclass
class Mesh:
    """This rank's place in a ``(data, model)`` mesh of ranks.

    ``model_group`` / ``data_group`` are the process groups of this rank's
    model-axis row and data-axis column (None in a one-rank world);
    ``model_ranks`` the global ranks of its model row, in model order."""

    data: int
    model: int
    rank: int
    world: int
    data_index: int
    model_index: int
    model_group: Any
    data_group: Any
    model_ranks: List[int]
    device: torch.device


def make_mesh(cfg: MeshConfig, device=None) -> Mesh:
    """This rank's :class:`Mesh` of ``cfg``; ``device`` is the rank's device
    (default: the current CUDA card).

    The world (``torch.distributed``'s default group, or one process
    without it) must hold exactly ``data * model`` ranks, else this raises:
    no rank runs a smaller mesh than was asked for.  Creating the groups is
    collective: every rank calls this, in the same order."""
    rank, world = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                   else (0, 1))
    need = cfg.data * cfg.model
    if world != need:
        raise ValueError(
            f"world size {world} differs from data x model = {cfg.data} x "
            f"{cfg.model} = {need}; start {need} ranks (torch.distributed."
            "init_process_group, parallel.mesh.multihost_init or "
            "parallel.mesh.spawn_ranks)")
    data_index, model_index = divmod(rank, cfg.model)
    model_group = data_group = None
    model_ranks = [data_index * cfg.model + j for j in range(cfg.model)]
    if world > 1:
        for i in range(cfg.data):
            g = dist.new_group([i * cfg.model + j for j in range(cfg.model)])
            if i == data_index:
                model_group = g
        for j in range(cfg.model):
            g = dist.new_group([i * cfg.model + j for i in range(cfg.data)])
            if j == model_index:
                data_group = g
    return Mesh(cfg.data, cfg.model, rank, world, data_index, model_index,
                model_group, data_group, model_ranks, resolve_device(device))


def choose_backend(device: torch.device, local_ranks: int) -> str:
    """``gloo`` for CPU ranks and for ranks that share a card (NCCL refuses
    two ranks on one device), ``nccl`` when each of the ``local_ranks``
    ranks on this host has a card of its own."""
    if device.type != "cuda":
        return "gloo"
    if torch.cuda.device_count() >= local_ranks:
        if not dist.is_nccl_available():
            raise RuntimeError("every rank has a card of its own, but this "
                               "torch build has no NCCL")
        return "nccl"
    return "gloo"


def rank_device(platform: Optional[str], local_rank: int, local_ranks: int,
                share_card: bool = False) -> torch.device:
    """The device of the rank ``local_rank`` of the ``local_ranks`` ranks on
    this host: the CPU for ``platform="cpu"``, else card ``local_rank``.  A
    host with fewer cards than ranks raises, unless ``share_card`` asks for
    the ranks to share the cards (card ``local_rank % cards``, under gloo)."""
    if platform == "cpu":
        return torch.device("cpu")
    resolve_device(platform)  # raises without a card
    n = torch.cuda.device_count()
    if n < local_ranks and not share_card:
        raise ValueError(
            f"{local_ranks} ranks on this host but {n} card(s): each rank needs a card "
            "of its own (set IWOQ_LOCAL_RANKS, or LOCAL_WORLD_SIZE, to the ranks "
            "this host runs)")
    return torch.device("cuda", local_rank % n)


def init_rank(rank: int, world: int, init_method: str, device: torch.device,
              local_ranks: Optional[int] = None, timeout_s: Optional[float] = None) -> str:
    """Join the ``world``-rank group as ``rank`` on ``device``; returns the
    backend, which rank 0 prints.  A CUDA device becomes the current one.
    ``timeout_s``: how long a collective may wait before it raises
    (torch's default without it)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = choose_backend(device, world if local_ranks is None else local_ranks)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            **kw)
    if rank == 0:
        print(f"torch.distributed: {world} ranks, backend {backend}, rank 0 on {device}",
              flush=True)
    return backend


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def multihost_init(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   platform: Optional[str] = None) -> Optional[str]:
    """Join a group that a launcher started (``init_process_group``).

    Arguments default to ``IWOQ_COORDINATOR`` (``host:port`` of rank 0),
    ``IWOQ_NUM_PROCESSES`` and ``IWOQ_PROCESS_ID``.  Ranks on cards also
    need this host's count of ranks, ``LOCAL_WORLD_SIZE`` (as torchrun sets
    it) or ``IWOQ_LOCAL_RANKS``, else this raises (CPU ranks, under gloo,
    do not); the rank's card is ``LOCAL_RANK`` where it is set, else the
    process id modulo that count.  A host with fewer cards than ranks
    raises (``rank_device``).  No-op, returning None, at one process, as
    in the JAX package; else the backend."""
    if num_processes is None:
        num_processes = _env_int("IWOQ_NUM_PROCESSES") or 1
    if num_processes <= 1:
        return None
    if process_id is None:
        process_id = _env_int("IWOQ_PROCESS_ID") or 0
    coordinator = coordinator or os.environ.get("IWOQ_COORDINATOR")
    if not coordinator:
        raise ValueError("IWOQ_COORDINATOR (host:port of rank 0) is not set")
    if platform == "cpu":
        return init_rank(process_id, num_processes, f"tcp://{coordinator}",
                         torch.device("cpu"), 1)
    local_ranks = _env_int("LOCAL_WORLD_SIZE", "IWOQ_LOCAL_RANKS")
    if local_ranks is None:
        raise ValueError("the ranks on this host are not known: set IWOQ_LOCAL_RANKS "
                         "(or LOCAL_WORLD_SIZE and LOCAL_RANK, as torchrun does)")
    local_rank = _env_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = process_id % local_ranks
    if not 0 <= local_rank < local_ranks:
        raise ValueError(f"local rank {local_rank} is not one of this host's "
                         f"{local_ranks} ranks")
    device = rank_device(platform, local_rank, local_ranks)
    return init_rank(process_id, num_processes, f"tcp://{coordinator}", device, local_ranks)


# a collective of ranks started on this host that waits this long has lost
# its peer: it raises, and spawn_ranks ends the others
_SPAWNED_TIMEOUT_S = 300


def _rank_entry(rank, fn, world, store, platform, threads, args):
    if threads:
        torch.set_num_threads(threads)
    # ranks started here share this host's cards when there are fewer cards
    # than ranks (gloo; the backend is printed)
    device = rank_device(platform, rank, world, share_card=True)
    init_rank(rank, world, f"file://{store}", device, timeout_s=_SPAWNED_TIMEOUT_S)
    try:
        fn(rank, world, device, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, args: Sequence = (),
                platform: Optional[str] = None, threads: int = 0) -> None:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes on
    this host, joined into one group (a file store in a temporary folder);
    ``fn`` must be picklable (a module-level function).  ``threads``: torch
    threads a rank (0: torch's default).  A rank that raises makes this
    raise; every process has ended when it returns."""
    import torch.multiprocessing as mp

    folder = tempfile.mkdtemp(prefix="iwoq_ranks_")
    try:
        mp.spawn(_rank_entry, args=(fn, world, os.path.join(folder, "store"), platform,
                                    threads, tuple(args)),
                 nprocs=world, join=True)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


# ------------------------------------------------------------ collectives

def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group`` (a new tensor; ``t`` itself at size 1)."""
    if _size(group) == 1:
        return t
    if _host_staged(t, group):
        buf = t.cpu()
        dist.all_reduce(buf, group=group)
        return buf.to(t.device)
    buf = t.contiguous().clone()
    dist.all_reduce(buf, group=group)
    return buf


def all_gather(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated along ``dim``, in rank
    order, on every rank."""
    n = _size(group)
    if n == 1:
        return t
    src = t.cpu() if _host_staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Rank ``src``'s (global rank) ``t`` on every rank of ``group``; the
    other ranks pass a tensor of the same shape and dtype to receive in."""
    if _size(group) == 1:
        return t
    buf = t.cpu() if _host_staged(t, group) else t.contiguous()
    dist.broadcast(buf, src=src, group=group)
    return buf.to(t.device)


def send(t: torch.Tensor, dst: int, group) -> None:
    """Send ``t`` to global rank ``dst`` (host-staged under gloo)."""
    buf = t.cpu() if _host_staged(t, group) else t.contiguous()
    dist.send(buf, dst=dst, group=group)


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """Receive a tensor shaped and typed as ``like`` from global rank
    ``src``, on ``like``'s device."""
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if _host_staged(like, group) else like.device)
    dist.recv(buf, src=src, group=group)
    return buf.to(like.device)


def all_gather_object(obj: Any, group) -> List[Any]:
    """Every rank's ``obj`` of ``group``, in rank order."""
    n = _size(group)
    if n == 1:
        return [obj]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out
