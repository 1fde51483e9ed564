"""Ranks over ``torch.distributed`` (PyTorch counterpart of
faceformer_tpu/parallel/mesh.py): a data axis and a model axis.

A rank is one process on one card: what JAX calls processes and local
devices both become ranks here. The ranks form JAX's grid,
``reshape(n // model_axis, model_axis)``: rank = data_rank * model_axis +
model_rank, so the model ranks of one data rank are neighbours. Each row
of the grid (one data rank's model ranks) has a process group,
``model_group``, over which parallel/tensor.py splits the model's heads
and FFN columns; each column, ``data_group``, is what the functions below
stripe and reduce over. With model_axis 1 the data group is the whole
world (``None``). ``make_mesh`` returns the rank's ``World``; the
functions below are what the harness and the training step need of it,
every one over the data axis (the model ranks of a data rank take the
same rows and hold the same results):
  - ``shard_batch``: the training stripe. The global batch is
    ``batch_size_train`` rows a host, as in JAX (one process's mesh splits
    ``batch_size_train`` over its local devices; each JAX process adds rows
    of its own), so each of a host's ranks takes an equal share of it from
    its own stripe of the epoch's permutation, and a step's global batch
    holds the same rows as JAX's;
  - ``shard_global_batch`` / ``local_rows``: evaluation, where every rank
    iterates the same batches and takes its contiguous rows of each;
  - ``global_sum`` / ``global_mean``: float64 (sum, count) all-reduces;
  - ``replicated``: data rank 0's parameters on every data rank;
  - ``all_reduce_``: summed tensors, flattened into one bucket a dtype.

The backend: ``nccl`` where each of a host's ranks has a card of its own;
``gloo`` on the CPU and where a host's ranks outnumber its visible cards
(two ranks on one card: NCCL refuses two ranks on one device). Either way
the compute stays on the rank's device; gloo carries CUDA tensors through
the host.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from faceformer_tpu_torch.data.batching import iter_batches
from faceformer_tpu_torch.device import require_device

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place among the ranks. ``backend`` is None where no
    process group was started (one rank outside ``torchrun``). ``model_axis``
    ranks in a row share one model (``model_group``, None at model_axis 1);
    ``data_group`` holds the ranks of the rank's column (None: the whole
    world)."""

    rank: int
    size: int
    local_rank: int
    local_size: int
    device: torch.device
    backend: Optional[str] = None
    model_axis: int = 1
    model_group: Any = None
    data_group: Any = None

    @property
    def hosts(self) -> int:
        return self.size // self.local_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_axis

    @property
    def data_size(self) -> int:
        return self.size // self.model_axis

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_axis

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


def _check_axis(n: int, model_axis: int) -> None:
    if model_axis < 1 or n % model_axis != 0:
        raise ValueError(f"{n} devices not divisible by model_axis={model_axis}")


def make_mesh(num_devices: int = 0, device="cuda", model_axis: int = 1) -> World:
    """The rank's world. Under a rank environment (``torchrun``'s, or the one
    ``faceformer_tpu_torch.main`` gives the ranks it starts: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) it joins that world's process group, even at world
    size 1, and takes card ``LOCAL_RANK`` modulo the visible cards;
    ``num_devices`` is then 0 or the world's size. Otherwise it is world 1
    on ``device``, and ``num_devices`` must ask for one rank.

    ``model_axis`` carves the model axis out of the ranks (JAX's rule: a
    count that does not divide by it raises ``ValueError``); every rank
    then creates the rows' and the columns' process groups, in the same
    order."""
    dev = require_device(device)
    if "WORLD_SIZE" not in os.environ:
        wanted = local_ranks(num_devices, dev)
        _check_axis(wanted, model_axis)
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
    _check_axis(size, model_axis)
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
    model_group = data_group = None
    if model_axis > 1:
        rows = size // model_axis
        for d in range(rows):  # every rank creates every group, in one order
            group = dist.new_group([d * model_axis + m for m in range(model_axis)])
            if rank // model_axis == d:
                model_group = group
        for m in range(model_axis):
            group = dist.new_group([d * model_axis + m for d in range(rows)])
            if rank % model_axis == m:
                data_group = group
    world = World(rank, size, local_rank, local_size, dev, backend, model_axis, model_group,
                  data_group)
    axis = (f", data rank {world.data_rank} of {world.data_size}, model rank "
            f"{world.model_rank} of {model_axis}") if model_axis > 1 else ""
    print(f"rank {rank} of {size} ({world.hosts} host(s), {local_size} a host): backend "
          f"{backend}, device {dev}{axis}", flush=True)
    return world


# -- training ------------------------------------------------------------------


def rank_rows(world: World, batch_size: int) -> int:
    """Rows a data rank takes of each step's global batch of ``batch_size``
    rows a host."""
    total = batch_size * world.hosts
    if total % world.data_size:
        raise ValueError(f"the global batch of {total} rows ({batch_size} a host) does not "
                         f"divide over {world.data_size} data ranks")
    return total // world.data_size


def shard_batch(dataset, batch_size: int, world: World, **kwargs) -> Iterator[Dict]:
    """The rank's training batches: its ``rank_rows`` a step, drawn from its
    data rank's stripe of the epoch's permutation (``iter_batches``'
    process_index and process_count). Data rank r's k-th batch holds rows
    r, r + W, ... of the global batch k, so the W data ranks' batches
    together are the rows one process takes at the same global batch
    size."""
    return iter_batches(dataset, rank_rows(world, batch_size), process_index=world.data_rank,
                        process_count=world.data_size, **kwargs)


def _flat_groups(tensors: Sequence[torch.Tensor]):
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def all_reduce_(world: Optional[World], tensors: Sequence[torch.Tensor]) -> None:
    """Sum ``tensors`` over the data axis, in place: one all-reduce of a
    flattened bucket a dtype. Nothing to do without a process group
    (``world`` None, or one rank outside a rank environment); a data group
    of one rank still runs its all-reduce."""
    if world is None or not world.distributed:
        return
    for group in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=world.data_group)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def replicated(world: World, module: torch.nn.Module) -> None:
    """Data rank 0's parameters and buffers on every data rank (broadcast in
    place over the data group, from the rank of the same model rank): every
    rank starts from the same seed, and this makes sure of it."""
    if not world.distributed:
        return
    with torch.no_grad():
        for group in _flat_groups(list(module.parameters()) + list(module.buffers())):
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            dist.broadcast(flat, src=world.model_rank, group=world.data_group)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


# -- evaluation ------------------------------------------------------------------


def eval_batch_size(world: World, batch_size: int) -> int:
    """An eval batch rounded to a multiple of the data ranks, at least one
    row a data rank (JAX rounds to its data axis, trainer.py:292-294)."""
    return max(world.data_size, (batch_size // world.data_size) * world.data_size)


def local_rows(world: World, n: int) -> slice:
    """The data rank's contiguous rows of an eval batch of ``n`` rows."""
    per = n // world.data_size
    return slice(world.data_rank * per, (world.data_rank + 1) * per)


def shard_global_batch(batch: Dict, world: World) -> Dict:
    """The rank's rows of an eval batch that every rank holds in full
    (mesh.py:143-163): every field, names included, cut to ``local_rows``."""
    rows = local_rows(world, len(batch["sample_valid"]))
    return {k: v[rows] for k, v in batch.items()}


def _host_reduce(world: World, values: Sequence[float]) -> np.ndarray:
    part = torch.tensor(values, dtype=torch.float64,
                        device=world.device if world.backend == "nccl" else "cpu")
    dist.all_reduce(part, group=world.data_group)
    return part.cpu().numpy()


def global_sum(world: World, value: float) -> float:
    """``value`` summed over the data ranks, in float64. Collective: every
    rank calls it the same number of times in the same order."""
    if not world.distributed:
        return float(value)
    return float(_host_reduce(world, [value])[0])


def global_mean(world: World, values: Sequence[float]) -> float:
    """Mean of every data rank's per-sample values: a float64 all-reduce of
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
