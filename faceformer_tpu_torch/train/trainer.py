"""Training/eval harness (PyTorch counterpart of
faceformer_tpu/train/trainer.py; reference: faceformer/trainer.py:16-300).

Train/valid/test loops, pointer cross-entropy, face metrics, the prediction
JSON dump, Adam with the per-epoch StepLR, NaN-step skipping, top-k
checkpoints:
  - the step is ``train_step.train_step`` (forward, loss, backward, Adam,
    the NaN skip), one step per batch, in the model's own precision;
  - batches reach the card one ahead of the step, through pinned host
    memory and non-blocking copies;
  - nothing in a step waits for the card: the NaN skip runs on the device
    (``train_step``), and the fit logs lag-1 as the JAX harness does (a
    step's loss and accuracy are read after the next step is queued), so
    the host assembles and uploads a batch while the card runs the step
    before. Each epoch's record splits its seconds: the host's in the batch
    iterator and upload (``train_host_batch_seconds``) and in queueing the
    steps (``train_host_dispatch_seconds``), and the steps' span on the
    card's stream, by CUDA events read once at the epoch's end
    (``train_step_span_seconds``; on the CPU the host's clock). A span
    counts the card's idle gaps while the host still queues the step: it
    is the card's step time only where the host queues faster than the
    card runs, and never the card's busy time (a profile reads that);
  - eval decodes with ``cfg.decode`` (``decode_grid``) and scores on the
    host, one device->host copy of the token grid per batch. The flat
    SurfaceFormer has no fused engine: ``decode.mode: fused`` decodes it
    with causal_cache, as the JAX harness does (trainer.py:161-165); that
    is the reference's behaviour, not a fallback.

Ranks (``parallel/mesh.py``): each process is one rank on one card. With
``trainer.num_devices`` N > 1, ``python -m faceformer_tpu_torch.main``
starts N ranks (or ``torchrun`` does), each builds a Harness, and the
world comes from ``mesh.make_mesh``; a Harness built outside such a rank
with N > 1 raises, so there is no quiet single-card run of a multi-card
config. Every rank fits its stripe of each step's global batch (the step
all-reduces the gradients), decodes and scores its rows of each eval batch
and writes its rows' prediction JSONs; the means are global, and only
the writer (rank 0) logs, checkpoints and writes ``results.json``
(faceformer_tpu/train/trainer.py:213-219, 281-287, 396-460).

``trainer.rng_impl`` picks the JAX package's PRNG. The port accepts it and
it changes nothing: dropout here draws from ``torch.Generator`` seeds and
Philox masks whose bits cannot equal JAX's, whichever PRNG JAX uses.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from faceformer_tpu_torch.config import Config
from faceformer_tpu_torch.data.batching import iter_batches
from faceformer_tpu_torch.data.dataset import ABCDataset, ABCDatasetParallel
from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel
from faceformer_tpu_torch.models.surfaceformer import SurfaceFormer
from faceformer_tpu_torch.parallel import mesh
from faceformer_tpu_torch.params import params_from_jax
from faceformer_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    load_torch_checkpoint,
)
from faceformer_tpu_torch.train.logging import MetricsLogger
from faceformer_tpu_torch.train.metrics import FaceMetrics
from faceformer_tpu_torch.train.step import lr_for_epoch, make_optimizer, train_step

DATASET_REGISTRY = {
    "ABCDataset": ABCDataset,
    "ABCDataset_Parallel": ABCDatasetParallel,
    "ABCDatasetParallel": ABCDatasetParallel,
}
MODEL_REGISTRY = {"SurfaceFormer": SurfaceFormer,
                  "SurfaceFormer_Parallel": SurfaceFormerParallel}


def decode_grid(model, cfg: Config, batch: Dict[str, torch.Tensor],
                early_stop: bool = True) -> torch.Tensor:
    """The token grid ``cfg.decode`` gives for a batch on the model's device:
    (N, F, T) for the parallel model, (N, T) for the flat one, whose
    ``fused`` mode decodes with causal_cache (JAX trainer.py:161-165)."""
    mode = cfg.decode.mode
    with torch.no_grad():
        if model.is_parallel:
            return model.forward_eval(batch, precision=cfg.decode.precision, mode=mode,
                                      anchor_mode=cfg.decode.anchor_mode,
                                      early_stop=early_stop)["predict"]
        mode = "causal_cache" if mode == "fused" else mode
        return model.forward_eval(batch, precision=cfg.decode.precision, mode=mode,
                                  early_stop=early_stop)["predict"]


class NumpyJSONEncoder(json.JSONEncoder):
    """JSON encoder for numpy scalars/arrays (reference uses the
    numpyencoder package, trainer.py:135-136)."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def _prefetch_to_device(batches, put):
    """Lookahead-1 upload: the NEXT batch's copy is issued before the
    current batch is handed out, so it overlaps the current step."""
    it = iter(batches)
    try:
        nxt = put(next(it))
    except StopIteration:
        return
    for batch in it:
        cur = nxt
        nxt = put(batch)
        yield cur
    yield nxt


def _scalars_to_host(*scalars: torch.Tensor):
    """0-d tensors copied to the host behind the work queued so far,
    without waiting for it: (the host values, an event that completes when
    they are there, None on the CPU). A card's copy lands in pinned memory,
    so that it is asynchronous."""
    values = torch.stack([s.detach().float() for s in scalars])
    if values.device.type != "cuda":
        return values, None
    host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
    host.copy_(values, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(values.device))
    return host, ready


class _StepClock:
    """The summed spans of an epoch's training steps. On a card, CUDA
    events recorded on the stream before and after each step, read once,
    at the epoch's end, so that no step waits for them: each step's span
    on the stream, from its first queued work to its last, gaps while the
    host still queues it included. On the CPU, where a step runs as it is
    called, the host's clock around the call."""

    def __init__(self, device: torch.device):
        self.device = device
        self.events: list = []  # CUDA events on a card, host clock readings on the CPU

    def _record(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self.events.append(ev)
        else:
            self.events.append(time.perf_counter())

    start = stop = _record

    def seconds(self) -> float:
        starts, stops = self.events[0::2], self.events[1::2]
        if self.device.type != "cuda":
            return float(sum(b - a for a, b in zip(starts, stops)))
        if stops:
            stops[-1].synchronize()
        return sum(a.elapsed_time(b) for a, b in zip(starts, stops)) / 1e3


def rank_generator(seed: int, rank: int) -> torch.Generator:
    """The dropout and scheduled-sampling stream of a data rank: data rank 0
    keeps the one-rank run's (``seed + 1``), every other one seeded from the
    seed and its data rank, so no two data ranks' rows share a mask. The
    model ranks of a data rank share its stream: masks drawn apart would
    leave their replicated activations apart."""
    if rank == 0:
        return torch.Generator().manual_seed(seed + 1)
    state = np.random.SeedSequence([seed + 1, rank]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) >> 1)


class Harness:
    def __init__(self, cfg: Config, datasets: Optional[Dict[str, Any]] = None,
                 device="cuda"):
        self.cfg = cfg
        self.world = mesh.make_mesh(cfg.trainer.num_devices, device)
        self.device = self.world.device
        self.model_cls = MODEL_REGISTRY[cfg.model_class]
        self.dataset_cls = DATASET_REGISTRY[cfg.dataset_class]
        self.metrics_engine = FaceMetrics(cfg.post_process, cfg.model.token)
        self.log_dir = os.path.join("logs", cfg.trainer.name, cfg.trainer.version)
        self._datasets = datasets or {}
        # seconds of the last validate(): decode on the card, metrics on the host
        self.eval_seconds = {"decode": 0.0, "metrics": 0.0}

    # -- data ------------------------------------------------------------------

    def dataset(self, split: str):
        if split not in self._datasets:
            splits = getattr(self.cfg, f"datasets_{split}")
            self._datasets[split] = self.dataset_cls(
                self.cfg.root_dir, list(splits), self.cfg.model)
        return self._datasets[split]

    def _upload(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A batch's arrays as tensors on the harness's device; to a card
        through pinned memory with non-blocking copies."""
        out = {}
        for key, value in batch.items():
            if isinstance(value, (list, str)):
                continue
            t = torch.from_numpy(np.ascontiguousarray(value))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[key] = t
        return out

    # -- state -----------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> Dict[str, Any]:
        """A fresh model (the reference init drawn from ``seed``) and its Adam."""
        seed = self.cfg.trainer.seed if seed is None else seed
        model = self.model_cls(self.cfg.model, generator=torch.Generator().manual_seed(seed),
                               device=self.device)
        optimizer = make_optimizer(model, self.cfg.trainer)
        return {"model": model, "optimizer": optimizer, "epoch": 0, "step": 0}

    @staticmethod
    def checkpoint_tree(state: Dict[str, Any]) -> Dict[str, Any]:
        """What a checkpoint file holds."""
        return {"model": state["model"].state_dict(),
                "optimizer": state["optimizer"].state_dict(),
                "epoch": int(state["epoch"]), "step": int(state["step"])}

    # -- loops -------------------------------------------------------------------

    def fit(self, state: Optional[Dict[str, Any]] = None,
            max_epochs: Optional[int] = None) -> Dict[str, Any]:
        cfg, world = self.cfg, self.world
        state = state or self.init_state()
        model, optimizer = state["model"], state["optimizer"]
        mesh.replicated(world, model)
        # one writer: the ranks' states are equal, and concurrent writers
        # would race on the same files
        logger = MetricsLogger(self.log_dir) if world.is_writer else None
        ckpts = CheckpointManager(os.path.join(self.log_dir, "checkpoints"),
                                  top_k=cfg.trainer.save_top_k) if world.is_writer else None
        train_ds = self.dataset("train")
        # dropout seeds and the scheduled-sampling draw; a resumed run
        # starts the stream afresh, as the JAX harness does
        generator = rank_generator(cfg.trainer.seed, world.data_rank)
        max_epochs = max_epochs or cfg.trainer.max_epochs
        every = cfg.trainer.log_every_n_steps
        step = state["step"]
        pending = None  # (step, its scalars on the host, the event they are ready at)

        def flush_pending():
            # lag-1 logging (JAX trainer.py:225-263): the previous step's
            # scalars are read after the next step is queued, so the wait
            # for them overlaps that step's device work
            nonlocal pending
            if pending is not None:
                logged, values, ready = pending
                if ready is not None:
                    ready.synchronize()
                logger.log_scalars(logged, {"train_loss": float(values[0]),
                                            "train_cls_acc": float(values[1])})
            pending = None

        for epoch in range(state["epoch"], max_epochs):
            t_epoch = time.perf_counter()
            for group in optimizer.param_groups:
                group["lr"] = lr_for_epoch(cfg.trainer, epoch)
            batches = iter(_prefetch_to_device(
                mesh.shard_batch(train_ds, cfg.batch_size_train, world, shuffle=True,
                                 drop_last=True, seed=cfg.trainer.seed, epoch=epoch),
                self._upload))
            clock = _StepClock(self.device)
            batch_s = dispatch_s = 0.0
            samples = 0
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)  # the next batch's collate and upload
                t1 = time.perf_counter()
                batch_s += t1 - t0
                if batch is None:
                    break
                clock.start()
                loss, acc = train_step(model, optimizer, batch, generator, cfg, world=world)
                clock.stop()
                dispatch_s += time.perf_counter() - t1
                samples += int(batch["label"].shape[0]) * world.data_size
                step += 1
                flush_pending()
                if logger is not None and step % every == 0:
                    pending = (step, *_scalars_to_host(loss, acc))
            flush_pending()  # the epoch's last step, before validation
            state.update(epoch=epoch + 1, step=step)
            span_s = clock.seconds()
            train_s = time.perf_counter() - t_epoch
            timing = {"epoch_train_seconds": train_s,
                      "train_host_batch_seconds": batch_s,
                      "train_host_dispatch_seconds": dispatch_s,
                      "train_step_span_seconds": span_s,
                      "train_samples_per_s": samples / train_s if train_s else 0.0}
            # checkpoint on validation epochs plus the final epoch: the
            # reference's cadence (ModelCheckpoint every_n_val_epochs=1 with
            # check_val_every_n_epoch=checkpoint_period, main.py:31-37,75)
            metric = None
            if (epoch + 1) % cfg.trainer.checkpoint_period == 0:
                t0 = time.perf_counter()
                metric = self.validate(model, logger=logger, step=step)["valid_precision"]
                timing.update(valid_seconds=time.perf_counter() - t0,
                              valid_decode_seconds=self.eval_seconds["decode"],
                              valid_metrics_seconds=self.eval_seconds["metrics"])
            if ckpts is not None and (metric is not None or epoch + 1 == max_epochs):
                t0 = time.perf_counter()
                last = ckpts.save(self.checkpoint_tree(state), cfg, epoch + 1,
                                  metric_value=metric)
                timing.update(checkpoint_seconds=time.perf_counter() - t0,
                              checkpoint_bytes=os.path.getsize(last))
            if logger is not None:
                logger.log_scalars(step, timing)
        if logger is not None:
            logger.close()
        return state

    def _eval_batches(self, split: str):
        ds = self.dataset(split)
        batch_size = mesh.eval_batch_size(self.world,
                                          min(self.cfg.batch_size_valid, max(len(ds), 1)))
        items = ds
        if self.cfg.decode.sort_eval:
            # complexity-sorted batches: each batch decodes until its
            # deepest row retires, so grouping similar edge counts cuts
            # wasted steps. Samples keep their `id`, so raw-data lookups and
            # prediction JSONs do not depend on the order.
            order = sorted(range(len(ds)), key=lambda i: ds[i]["num_input"])
            items = [ds[i] for i in order]
        return ds, iter_batches(items, batch_size, pad_to_full=True)

    def _decode(self, model, device_batch) -> torch.Tensor:
        return decode_grid(model, self.cfg, device_batch)

    def validate(self, model, logger: Optional[MetricsLogger] = None,
                 step: int = 0) -> Dict[str, float]:
        """Validation loop (reference: trainer.py:91-102). Collective: each
        rank decodes and scores its rows of every batch; the means are
        global, and the writer logs them."""
        world = self.world
        ds, batches = self._eval_batches("valid")
        agg: Dict[str, List[float]] = {}
        text_dumps = 0
        decode_s = metrics_s = 0.0
        for batch in batches:
            batch = mesh.shard_global_batch(batch, world)
            t0 = time.perf_counter()
            # the host copy of the grid waits for the decode
            predict = self._decode(model, self._upload(batch)).cpu().numpy()
            t1 = time.perf_counter()
            raw = [ds.raw_datas[i] for i in batch["id"]]
            out = self.metrics_engine.evaluate_batch(
                predict, np.asarray(batch["label"]), raw, batch["sample_valid"])
            metrics_s += time.perf_counter() - t1
            decode_s += t1 - t0
            for key in ("precision", "recall", "type_acc", "accuracy",
                        "type_acc_coedge_seq"):
                agg.setdefault(key, []).extend(out[key])
            if logger is not None and text_dumps < 4:
                # qualitative pred-vs-label dumps (reference trainer.py:100-101)
                for pred, label, prec in zip(out["predictions"], out["labels"],
                                             out["precision"]):
                    logger.log_text(
                        "result",
                        f"pred: {pred} \n\n label: {label} \n\n precision: {prec}",
                        step + text_dumps)
                    text_dumps += 1
                    if text_dumps >= 4:
                        break
        self.eval_seconds = {"decode": decode_s, "metrics": metrics_s}
        results = {f"valid_{key}": mesh.global_mean(world, agg.get(key, []))
                   for key in ("precision", "recall", "type_acc", "accuracy",
                               "type_acc_coedge_seq")}
        if logger is not None:
            logger.log_scalars(step, results)
        if world.is_writer:
            print(" ".join(f"{k}={v:.4f}" for k, v in results.items()), flush=True)
        return results

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def test(self, model, json_dir: Optional[str] = None) -> Dict[str, float]:
        """Test loop: metrics + per-sample prediction JSONs + decode timing
        (reference: trainer.py:105-136). Collective: each rank decodes its
        rows and writes their JSONs; the means and the sample count are
        global, the decode time is the rank's over the global count, and
        the writer writes ``results.json`` and the log."""
        world = self.world
        ds, batches = self._eval_batches("test")
        json_dir = json_dir or os.path.join(self.log_dir, "json")
        os.makedirs(json_dir, exist_ok=True)

        agg: Dict[str, List[float]] = {}
        total_time, sample_count = 0.0, 0
        warmed = False
        for batch in batches:
            batch = mesh.shard_global_batch(batch, world)
            device_batch = self._upload(batch)
            if not warmed:
                # untimed warm-up on the first batch: the first call loads
                # the kernels' libraries and fills the allocator's caches
                self._decode(model, device_batch)
                warmed = True
            self._sync()
            t0 = time.perf_counter()
            out_grid = self._decode(model, device_batch)
            self._sync()
            total_time += time.perf_counter() - t0
            predict = out_grid.cpu().numpy()
            sample_valid = batch["sample_valid"]
            sample_count += int(np.sum(sample_valid))

            raw = [ds.raw_datas[i] for i in batch["id"]]
            out = self.metrics_engine.evaluate_batch(
                predict, np.asarray(batch["label"]), raw, sample_valid)
            for key in ("precision", "recall", "type_acc"):
                agg.setdefault(key, []).extend(out[key])

            valid_idx = [i for i, ok in enumerate(sample_valid) if ok]
            for res_i, batch_i in enumerate(valid_idx):
                name = os.path.splitext(os.path.basename(batch["name"][batch_i]))[0]
                record = {
                    "edges": raw[batch_i]["edges"],
                    "dominant_directions": raw[batch_i]["dominant_directions"],
                    "pred_faces": out["predictions"][res_i],
                    "label_faces": out["labels"][res_i],
                }
                with open(os.path.join(json_dir, f"{name}.json"), "w") as f:
                    json.dump(record, f, cls=NumpyJSONEncoder)

        results = {f"test_{key}": mesh.global_mean(world, agg.get(key, []))
                   for key in ("precision", "recall", "type_acc")}
        global_count = int(mesh.global_sum(world, sample_count))
        # each rank's decode ran beside the others', so its seconds cover the
        # whole split (JAX trainer.py:444-451)
        results.update(avg_time_per_sample=total_time / max(global_count, 1),
                       num_samples=global_count)
        if not world.is_writer:
            return results
        print("Avg Time", results["avg_time_per_sample"], "seconds.")
        print(" ".join(f"{k}={v:.4f}" for k, v in results.items() if k != "num_samples"),
              flush=True)
        # persist: results.json + metrics.jsonl, so quality claims are
        # auditable from files (not just stdout)
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        logger = MetricsLogger(self.log_dir)
        logger.log_scalars(0, dict(results))
        logger.close()
        return results

    # -- checkpoints ---------------------------------------------------------------

    def load(self, path: str) -> Dict[str, Any]:
        """A state from a checkpoint: the port's own file (model, Adam,
        epoch, step), or a reference PyTorch .ckpt/.pt/.pth state dict
        (weights only; a fresh Adam, epoch 0). Every rank loads it, onto its
        own device."""
        state = self.init_state()
        if path.endswith((".ckpt", ".pt", ".pth")):
            tree = load_torch_checkpoint(path, self.cfg.model.num_encoder_layers,
                                         self.cfg.model.num_decoder_layers)
            params_from_jax(state["model"], tree)
            return state
        tree, _ = load_checkpoint(path, map_location=self.device)
        state["model"].load_state_dict(tree["model"])
        # a saved group's settings replace the optimizer's; the step's skip
        # needs the fused Adam, whichever Adam wrote the file
        for group in tree["optimizer"]["param_groups"]:
            group.update(fused=True, foreach=None)
        state["optimizer"].load_state_dict(tree["optimizer"])
        state["epoch"] = int(tree.get("epoch", 0))
        state["step"] = int(tree.get("step", 0))
        return state

