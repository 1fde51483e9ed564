"""The multi-rank dry run (PyTorch counterpart of
__graft_entry__.py::dryrun_multichip): the training step, both cache
engines and a flagship-width forward and backward over a data x model
grid of ``torch.distributed`` ranks.

    python -m faceformer_tpu_torch.parallel.dryrun --ranks 4 [--device cpu]

``dryrun_multichip(n)`` starts ``n`` ranks through ``mesh.spawn`` (gloo
where they outnumber the cards, as on one card or the CPU) on a grid of
``model_axis = 2 if n % 2 == 0 and n >= 4 else 1`` columns, as JAX's does.
Each rank, at JAX's tiny dims (d 64, 4 heads, FFN 96, 2+2 layers, 48
lines, dropout 0.1), cuts the model to its shards, takes one Adam step of
the training step on its data rank's rows with dropout on, decodes them
with the causal_cache engine and with the fused one; then, at the `ours`
dims (d 512, 8 heads, FFN 1024, 6+6 layers, 216 lines, 37 tokens a face,
remat, dropout 0.2), runs one forward and backward on FLAGSHIP_ROWS rows
a data rank, where JAX only lowers the step: on a card at the whole 6+6
depth, on the CPU at one layer each (the widths, heads and sequence
lengths, which the sharding depends on, stay). Rank 0's figures come back
to the caller, which prints JAX's ``dryrun_multichip ok: mesh=(...)``
line.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from faceformer_tpu_torch.config import Config, ModelConfig, TrainerConfig
from faceformer_tpu_torch.data.batching import collate
from faceformer_tpu_torch.data.dataset import ABCDatasetParallel
from faceformer_tpu_torch.decode import greedy_decode_parallel
from faceformer_tpu_torch.geometry.fixtures import random_sample
from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel
from faceformer_tpu_torch.parallel import mesh
from faceformer_tpu_torch.parallel.tensor import shard_params_
from faceformer_tpu_torch.train.loss import pointer_cross_entropy
from faceformer_tpu_torch.train.step import make_optimizer, train_step
from faceformer_tpu_torch.train.trainer import rank_generator

# JAX's tiny dims (__graft_entry__.py:120-124) and flagship dims (:182-183)
TINY = ModelConfig(num_points_per_line=8, num_lines=48, label_seq_length=24, max_num_faces=16,
                   max_face_length=16, num_model=64, num_head=4, num_feedforward=96,
                   num_encoder_layers=2, num_decoder_layers=2, dropout=0.1)
FLAGSHIP = ModelConfig(num_lines=216, max_num_faces=42, max_face_length=37, remat=True)
FLAGSHIP_ROWS = 2


def model_axis_for(n: int) -> int:
    return 2 if n % 2 == 0 and n >= 4 else 1


def synthetic_batch(cfg: ModelConfig, rows: int, device, seed: int = 0):
    """``rows`` random solids packed at ``cfg``'s dims, as tensors on
    ``device`` (__graft_entry__.py::_synthetic_batch)."""
    rng = np.random.default_rng(seed)
    ds = ABCDatasetParallel.from_samples([random_sample(rng) for _ in range(rows)], cfg)
    batch = collate([ds[i] for i in range(rows)])
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()
            if not isinstance(v, (list, str))}


def _data_gather(world: mesh.World, grid: torch.Tensor) -> torch.Tensor:
    """The data ranks' rows of a grid, joined in data-rank order."""
    if not world.distributed:
        return grid
    parts = [torch.empty_like(grid) for _ in range(world.data_size)]
    dist.all_gather(parts, grid.contiguous(), group=world.data_group)
    return torch.cat(parts)


def _rank(n: int, device: str, out_path: str, flagship_layers: int) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    model_axis = model_axis_for(n)
    world = mesh.make_mesh(n, device, model_axis=model_axis)
    dev = world.device
    cfg = Config(model_class="SurfaceFormer_Parallel", dataset_class="ABCDataset_Parallel",
                 model=TINY, trainer=TrainerConfig(lr=1e-4, precision="fp32"))
    model = SurfaceFormerParallel(TINY, generator=torch.Generator().manual_seed(0), device=dev)
    shard_params_(model, world)
    optimizer = make_optimizer(model, cfg.trainer)
    batch = synthetic_batch(TINY, 2 * world.data_size, dev)
    rows = {k: v[mesh.local_rows(world, len(v))] for k, v in batch.items()}
    loss, _ = train_step(model, optimizer, rows, rank_generator(0, world.data_rank), cfg,
                         world=world)
    loss = float(loss)
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    # the multi-rank serving path: the data rank's rows on each model rank
    predict = _data_gather(world, greedy_decode_parallel(
        model, TINY, rows, precision="fp32", mode="causal_cache")["predict"])
    fused = _data_gather(world, greedy_decode_parallel(
        model, TINY, rows, precision="fp32", mode="fused")["predict"])
    want = (2 * world.data_size, TINY.num_lines, TINY.max_face_length)
    if tuple(predict.shape) != want or fused.shape != predict.shape:
        raise RuntimeError(f"decode grids {tuple(predict.shape)}, {tuple(fused.shape)}: "
                           f"{want} expected")
    agree = float((fused == predict).float().mean())
    del model, optimizer, batch, rows
    # the flagship dims: one forward and backward, remat on, dropout on
    flagship = dataclasses.replace(FLAGSHIP, num_encoder_layers=flagship_layers,
                                   num_decoder_layers=flagship_layers)
    big = SurfaceFormerParallel(flagship, generator=torch.Generator().manual_seed(0),
                                device=dev)
    shard_params_(big, world)
    big_rows = synthetic_batch(flagship, FLAGSHIP_ROWS, dev, seed=1 + world.data_rank)
    out = big.forward_train(big_rows, generator=rank_generator(0, world.data_rank),
                            precision="fp32")
    big_loss, _ = pointer_cross_entropy(out, flagship.token)
    big_loss.backward()
    grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in big.parameters()
                       if p.grad is not None)
    big_loss = float(big_loss.detach())
    if not math.isfinite(big_loss) or not grads_finite:
        raise RuntimeError(f"flagship dims: loss {big_loss}, finite gradients {grads_finite}")
    if world.rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump({"mesh": (world.data_size, model_axis), "backend": world.backend,
                         "loss": loss, "grid": tuple(predict.shape), "fused_agree": agree,
                         "flagship_loss": big_loss,
                         "q_shard": tuple(big.decoder.layers[0].self_attn.q.weight.shape)}, f)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    """Run the dry run on ``n_devices`` ranks (on the card unless ``device``
    says otherwise) and print, and return, its ok line. A rank that fails
    ends the others and raises here."""
    flagship_layers = 1 if torch.device(device).type == "cpu" else FLAGSHIP.num_encoder_layers
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as tmp:
        path = os.path.join(tmp, "rank0.pkl")
        mesh.spawn(n_devices, _rank, n_devices, device, path, flagship_layers)
        with open(path, "rb") as f:
            got = pickle.load(f)
    d, m = got["mesh"]
    line = (f"dryrun_multichip ok: mesh=({d}x{m}), loss={got['loss']:.4f}, decode grid "
            f"{got['grid']}, fused ok (agreement with causal_cache {got['fused_agree']:.4f}), "
            f"flagship-dims forward and backward ok (loss {got['flagship_loss']:.4f}, "
            f"{flagship_layers}+{flagship_layers} layers, {FLAGSHIP_ROWS} rows a data rank, "
            f"q shard {got['q_shard']}, backend {got['backend']})")
    print(line, flush=True)
    return line


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dryrun_multichip(args.ranks, args.device)


if __name__ == "__main__":
    main()
