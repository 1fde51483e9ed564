"""Data parallelism over ``torch.distributed`` ranks (PyTorch counterpart of
faceformer_tpu/parallel/mesh.py, its data axis only).

A rank is one process on one card: what JAX calls processes and local
devices both become ranks here. ``make_mesh`` returns the rank's ``World``;
the functions below are what the harness and the training step need of it:
  - ``shard_batch``: the training stripe. The global batch is
    ``batch_size_train`` rows a host, as in JAX (one process's mesh splits
    ``batch_size_train`` over its local devices; each JAX process adds rows
    of its own), so each of a host's ranks takes an equal share of it from
    its own stripe of the epoch's permutation, and a step's global batch
    holds the same rows as JAX's;
  - ``shard_global_batch`` / ``local_rows``: evaluation, where every rank
    iterates the same batches and takes its contiguous rows of each;
  - ``global_sum`` / ``global_mean``: float64 (sum, count) all-reduces;
  - ``replicated``: rank 0's parameters on every rank;
  - ``all_reduce_``: summed tensors, flattened into one bucket a dtype.

The backend: ``nccl`` where each of a host's ranks has a card of its own;
``gloo`` on the CPU and where a host's ranks outnumber its visible cards
(two ranks on one card: NCCL refuses two ranks on one device). Either way
the compute stays on the rank's device; gloo carries CUDA tensors through
the host. Tensor parallelism (JAX's ``model`` axis) is not ported
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from faceformer_tpu_torch.data.batching import iter_batches
from faceformer_tpu_torch.device import require_device

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place among the ranks. ``backend`` is None where no
    process group was started (one rank outside ``torchrun``)."""

    rank: int
    size: int
    local_rank: int
    local_size: int
    device: torch.device
    backend: Optional[str] = None

    @property
    def hosts(self) -> int:
        return self.size // self.local_size

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes logs, checkpoints and results; the others none."""
        return self.rank == 0

    @property
    def distributed(self) -> bool:
        return self.backend is not None


def local_ranks(num_devices: int, device) -> int:
    """Ranks that ``trainer.num_devices`` asks for on this host: 0 means every
    visible card (one on the CPU), as JAX takes every local device."""
    if num_devices < 0:
        raise ValueError(f"trainer.num_devices must be >= 0, got {num_devices}")
    if num_devices:
        return num_devices
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def make_mesh(num_devices: int = 0, device="cuda", model_axis: int = 1) -> World:
    """The rank's world. Under a rank environment (``torchrun``'s, or the one
    ``faceformer_tpu_torch.main`` gives the ranks it starts: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) it joins that world's process group, even at world
    size 1, and takes card ``LOCAL_RANK`` modulo the visible cards;
    ``num_devices`` is then 0 or the world's size. Otherwise it is world 1
    on ``device``, and ``num_devices`` must ask for one rank."""
    if model_axis != 1:
        raise NotImplementedError(
            f"model_axis={model_axis}: tensor parallelism is not ported (ROADMAP.md Queue 1, "
            "the next slices); the port runs data parallelism only")
    dev = require_device(device)
    if "WORLD_SIZE" not in os.environ:
        wanted = local_ranks(num_devices, dev)
        if wanted != 1:
            raise RuntimeError(
                f"trainer.num_devices={num_devices} asks for {wanted} ranks, and this process "
                "is not one of them: start the run through `python -m faceformer_tpu_torch.main`, "
                "which starts the ranks, or under torchrun")
        return World(0, 1, 0, 1, dev)
    missing = [k for k in ENV + ("MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"rank environment incomplete: {missing} unset")
    rank, size, local_rank, local_size = (int(os.environ[k]) for k in ENV)
    if num_devices not in (0, size):
        raise ValueError(f"trainer.num_devices={num_devices} does not match the world of "
                         f"{size} ranks (set 0 or {size})")
    if size % local_size or not 0 <= local_rank < local_size or not 0 <= rank < size:
        raise ValueError(f"inconsistent rank environment {dict((k, os.environ[k]) for k in ENV)}")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_size <= cards else "gloo"
    else:
        backend = "gloo"
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, size):
            raise RuntimeError("a process group of another world is already running")
        backend = dist.get_backend()
    else:
        # nccl binds the group to the rank's card at once
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=size,
                                **({"device_id": dev} if backend == "nccl" else {}))
    world = World(rank, size, local_rank, local_size, dev, backend)
    print(f"rank {rank} of {size} ({world.hosts} host(s), {local_size} a host): backend "
          f"{backend}, device {dev}", flush=True)
    return world


# -- training ------------------------------------------------------------------


def rank_rows(world: World, batch_size: int) -> int:
    """Rows a rank takes of each step's global batch of ``batch_size`` rows a
    host."""
    total = batch_size * world.hosts
    if total % world.size:
        raise ValueError(f"the global batch of {total} rows ({batch_size} a host) does not "
                         f"divide over {world.size} ranks")
    return total // world.size


def shard_batch(dataset, batch_size: int, world: World, **kwargs) -> Iterator[Dict]:
    """The rank's training batches: its ``rank_rows`` a step, drawn from its
    stripe of the epoch's permutation (``iter_batches``' process_index and
    process_count). Rank r's k-th batch holds rows r, r + W, ... of the
    global batch k, so the W ranks' batches together are the rows one
    process takes at the same global batch size."""
    return iter_batches(dataset, rank_rows(world, batch_size), process_index=world.rank,
                        process_count=world.size, **kwargs)


def _flat_groups(tensors: Sequence[torch.Tensor]):
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def all_reduce_(world: Optional[World], tensors: Sequence[torch.Tensor]) -> None:
    """Sum ``tensors`` over the ranks, in place: one all-reduce of a
    flattened bucket a dtype. Nothing to do at one rank (``world`` None, or
    no process group)."""
    if world is None or not world.distributed:
        return
    for group in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def replicated(world: World, module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank (broadcast in place):
    every rank starts from the same seed, and this makes sure of it."""
    if not world.distributed:
        return
    with torch.no_grad():
        for group in _flat_groups(list(module.parameters()) + list(module.buffers())):
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            dist.broadcast(flat, src=0)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


# -- evaluation ------------------------------------------------------------------


def eval_batch_size(world: World, batch_size: int) -> int:
    """An eval batch rounded to a multiple of the ranks, at least one row a
    rank (JAX rounds to its data axis, trainer.py:292-294)."""
    return max(world.size, (batch_size // world.size) * world.size)


def local_rows(world: World, n: int) -> slice:
    """The rank's contiguous rows of an eval batch of ``n`` rows."""
    per = n // world.size
    return slice(world.rank * per, (world.rank + 1) * per)


def shard_global_batch(batch: Dict, world: World) -> Dict:
    """The rank's rows of an eval batch that every rank holds in full
    (mesh.py:143-163): every field, names included, cut to ``local_rows``."""
    rows = local_rows(world, len(batch["sample_valid"]))
    return {k: v[rows] for k, v in batch.items()}


def _host_reduce(world: World, values: Sequence[float]) -> np.ndarray:
    part = torch.tensor(values, dtype=torch.float64,
                        device=world.device if world.backend == "nccl" else "cpu")
    dist.all_reduce(part)
    return part.cpu().numpy()


def global_sum(world: World, value: float) -> float:
    """``value`` summed over the ranks, in float64. Collective: every rank
    calls it the same number of times in the same order."""
    if not world.distributed:
        return float(value)
    return float(_host_reduce(world, [value])[0])


def global_mean(world: World, values: Sequence[float]) -> float:
    """Mean of every rank's per-sample values: a float64 all-reduce of
    (sum, count). Collective, as ``global_sum``. One rank: ``np.mean``."""
    if not world.distributed:
        return float(np.mean(values)) if len(values) else 0.0
    total, count = _host_reduce(world, [float(np.sum(values)), float(len(values))])
    return float(total / count) if count else 0.0


# -- starting ranks ----------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(local_rank: int, size: int, port: int, fn, args) -> None:
    os.environ.update(RANK=str(local_rank), WORLD_SIZE=str(size), LOCAL_RANK=str(local_rank),
                      LOCAL_WORLD_SIZE=str(size), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(size: int, fn, *args) -> None:
    """Run ``fn(*args)`` in ``size`` new processes, the ranks of one host
    (spawned, on 127.0.0.1 and a free port), and wait for them. ``fn`` is a
    module-level function; each rank's ``make_mesh`` joins the world. A rank
    that fails ends the others and raises here."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(size, _free_port(), fn, args), nprocs=size,
                       join=True, start_method="spawn")
