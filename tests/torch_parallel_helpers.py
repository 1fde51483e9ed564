"""Rank side of the port's multi-rank CPU tests (tests/test_torch_parallel*.py,
tests/test_torch_tensor_parallel.py, tests/test_torch_tensor_parallel_flat.py).

``run_ranks`` starts two (or ``ranks``) gloo ranks on the CPU through the port's own
``parallel.mesh.spawn`` and has each run the named tasks of a job written
by the test; each task leaves its results under the job's directory, where
the test reads them. This module imports nothing of JAX, so the ranks start
without it.
"""

import json
import os
import pickle
import sys

import numpy as np
import torch

from faceformer_tpu_torch import decode
from faceformer_tpu_torch.config import config_from_dict
from faceformer_tpu_torch.data.batching import collate
from faceformer_tpu_torch.data.dataset import ABCDataset, ABCDatasetParallel
from faceformer_tpu_torch.decode import greedy_decode_parallel, greedy_decode_single
from faceformer_tpu_torch.models import layers
from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel
from faceformer_tpu_torch.models.surfaceformer import SurfaceFormer
from faceformer_tpu_torch.parallel import mesh, tensor
from faceformer_tpu_torch.params import grads_to_numpy, params_from_jax, params_to_numpy
from faceformer_tpu_torch.train.loss import pointer_cross_entropy
from faceformer_tpu_torch.train.step import make_optimizer, train_step
from faceformer_tpu_torch.train.trainer import Harness, rank_generator


def leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from leaves(value, path + (key,))
        else:
            yield "/".join(path + (key,)), value


def flat(tree):
    """Path -> a copy of each leaf (``params_to_numpy`` shares the live
    parameters' memory, which later steps overwrite)."""
    return {name: np.array(value) for name, value in leaves(tree)}


def run_ranks(job: dict, out_dir: str, ranks: int = 2) -> None:
    """Write ``job`` (config dicts, samples, parameter trees, task names)
    under ``out_dir`` and run it on ``ranks`` gloo ranks."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "job.pkl")
    with open(path, "wb") as f:
        pickle.dump({**job, "out": out_dir}, f)
    mesh.spawn(ranks, run_rank, path)


def run_rank(job_path: str) -> None:
    # TensorBoard writes its event files without TensorFlow, which would
    # otherwise take the rank seconds to import
    sys.modules.setdefault("tensorflow", None)
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    for task in job["tasks"]:
        TASKS[task](job)


def _datasets(job, cfg):
    return {split: ABCDatasetParallel.from_samples(samples, cfg.model, job["names"][split])
            for split, samples in job["splits"].items()}


def _save(job, name, world, payload) -> None:
    np.savez(os.path.join(job["out"], f"{name}_rank{world.rank}.npz"), **payload)


def task_fit(job) -> None:
    """Harness.fit from the JAX package's initial parameters."""
    cfg = config_from_dict(job["cfg"])
    harness = Harness(cfg, datasets=_datasets(job, cfg), device="cpu")
    harness.log_dir = os.path.join(job["out"], "fit")
    state = harness.init_state()
    params_from_jax(state["model"], job["tree"])
    state = harness.fit(state)
    _save(job, "fit", harness.world, {**flat(params_to_numpy(state["model"])),
                                      "__step": np.asarray(state["step"])})


def task_eval(job) -> None:
    """validate and test under each engine, each in a log directory of its
    own; the results as JSON a rank."""
    for mode in job["modes"]:
        cfg = config_from_dict({**job["cfg"], "decode": {**job["cfg"]["decode"], "mode": mode}})
        harness = Harness(cfg, datasets=_datasets(job, cfg), device="cpu")
        harness.log_dir = os.path.join(job["out"], f"eval_{mode}")
        state = harness.init_state()
        params_from_jax(state["model"], job["eval_tree"])
        results = {"valid": harness.validate(state["model"]),
                   "test": harness.test(state["model"])}
        with open(os.path.join(job["out"], f"eval_{mode}_rank{harness.world.rank}.json"),
                  "w") as f:
            json.dump(results, f)


def _rank_batch(job, cfg, rows, flat: bool = False):
    dataset = ABCDataset if flat else ABCDatasetParallel
    ds = dataset.from_samples(job["batch_samples"], cfg.model)
    batch = collate([ds[i] for i in rows])
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()
            if not isinstance(v, (list, str))}


def _model(cfg, tree):
    state = Harness(cfg, device="cpu").init_state()
    params_from_jax(state["model"], tree)
    return state["model"], make_optimizer(state["model"], cfg.trainer)


def task_uneven(job) -> None:
    """One step's gradient on the rank's rows of a global batch (rows r, r+2,
    ...), and the gradient of the rank's own token mean."""
    cfg = config_from_dict(job["cfg"])
    world = mesh.make_mesh(cfg.trainer.num_devices, "cpu")
    rows = list(range(world.rank, len(job["batch_samples"]), world.size))
    batch = _rank_batch(job, cfg, rows)
    model, opt = _model(cfg, job["tree"])
    loss, acc = train_step(model, opt, batch, None, cfg, world=world)
    payload = {f"global/{k}": v for k, v in flat(grads_to_numpy(model)).items()}
    model, _ = _model(cfg, job["tree"])
    out = model.forward_train(batch)
    own, aux = pointer_cross_entropy(out, cfg.model.token)
    own.backward()
    payload.update({f"own/{k}": v for k, v in flat(grads_to_numpy(model)).items()})
    payload.update({"__loss": loss.numpy(), "__acc": acc.numpy(),
                    "__tokens": aux["valid_tokens"].numpy()})
    _save(job, "uneven", world, payload)


def task_nan(job) -> None:
    """A step whose input is NaN on rank 1's rows only, then a clean step."""
    cfg = config_from_dict(job["cfg"])
    world = mesh.make_mesh(cfg.trainer.num_devices, "cpu")
    rows = list(range(world.rank, len(job["batch_samples"]), world.size))
    batch = _rank_batch(job, cfg, rows)
    model, opt = _model(cfg, job["tree"])
    bad = dict(batch, input=batch["input"].clone())
    if world.rank == 1:
        bad["input"][0] = float("nan")
    loss, _ = train_step(model, opt, bad, None, cfg, world=world)
    payload = {f"skipped/{k}": v for k, v in flat(params_to_numpy(model)).items()}
    payload["__skipped_loss"] = loss.numpy()
    # Adam's state after the skip: the fused Adam makes it on the skipped
    # step too, as optax's init does, and the skip must leave it at its
    # start: step 0, every moment 0, for every parameter
    payload["__adam_steps_after_skip"] = np.asarray(
        max((float(slot["step"]) for slot in opt.state.values()), default=0.0))
    payload["__adam_slots_after_skip"] = np.asarray(len(opt.state))
    payload["__parameters"] = np.asarray(len(list(model.parameters())))
    for name, p in model.named_parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            if key in opt.state.get(p, {}):
                payload[f"{key}/{name}"] = opt.state[p][key].numpy().copy()
    loss, _ = train_step(model, opt, batch, None, cfg, world=world)
    payload.update({f"stepped/{k}": v for k, v in flat(params_to_numpy(model)).items()})
    payload["__stepped_loss"] = loss.numpy()
    _save(job, "nan", world, payload)


def task_load(job) -> None:
    """Harness.load of a checkpoint a one-rank run wrote."""
    cfg = config_from_dict(job["cfg"])
    harness = Harness(cfg, device="cpu")
    state = harness.load(job["ckpt"])
    _save(job, "load", harness.world, {**flat(params_to_numpy(state["model"])),
                                       "__step": np.asarray(state["step"])})


def whole_model(cfg, tree, flat: bool = False):
    """The port's anchor-parallel model (the flat one with ``flat``) on the
    CPU, whole, loaded with a JAX tree."""
    model = (SurfaceFormer if flat else SurfaceFormerParallel)(cfg.model, device="cpu")
    params_from_jax(model, tree)
    return model


def gathered_tree(model, cfg, grads: bool = False) -> dict:
    """A cut model's parameters (or gradients), gathered over the model
    group, as the flat JAX-layout dict of a whole model."""
    whole = tensor.gather_params(model, grads=grads)
    host = type(model)(cfg.model, device="cpu")
    if grads:
        for name, p in host.named_parameters():
            p.grad = whole[name]
        return flat(grads_to_numpy(host))
    host.load_state_dict(whole)
    return flat(params_to_numpy(host))


def _tp_world(job):
    return mesh.make_mesh(job["ranks"], "cpu", model_axis=job["model_axis"])


def _tp_step(job, cfg, world, fault: bool = False, flat: bool = False):
    """One training step of the cut model (the flat one with ``flat``) on
    the data rank's rows (rows d, d + D, ...): the global loss and the
    gathered gradients. ``fault`` plants a fault: every attention call's
    head offset left at 0."""
    rows = list(range(world.data_rank, len(job["batch_samples"]), world.data_size))
    model = whole_model(cfg, job["tree"], flat)
    tensor.shard_params_(model, world)
    generator = (rank_generator(job["seed"], world.data_rank)
                 if cfg.model.dropout > 0 else None)
    real = layers.flash_attention
    if fault:
        layers.flash_attention = lambda *a, head_offset=0, **k: real(*a, **k)
    try:
        loss, _ = train_step(model, make_optimizer(model, cfg.trainer),
                             _rank_batch(job, cfg, rows, flat), generator, cfg, world=world)
    finally:
        layers.flash_attention = real
    return model, loss, gathered_tree(model, cfg, grads=True)


def task_tp(job) -> None:
    """The model axis at dropout 0: the cut model's decode grids under each
    engine on the data rank's rows; one training step's loss and gathered
    gradients; the Adam state cut and gathered back."""
    cfg = config_from_dict(job["cfg"])
    world = _tp_world(job)
    model = whole_model(cfg, job["tree"])
    tensor.shard_params_(model, world)
    rows = list(range(world.data_rank, len(job["batch_samples"]), world.data_size))
    batch = _rank_batch(job, cfg, rows)
    payload = {f"grid/{mode}": greedy_decode_parallel(model, cfg.model, batch, precision="fp32",
                                                      mode=mode)["predict"].numpy()
               for mode in ("reference", "causal_cache", "fused")}
    payload["__rows"] = np.asarray(rows)
    payload["__q_shape"] = np.asarray(model.decoder.layers[0].self_attn.q.weight.shape)
    _, loss, grads = _tp_step(job, cfg, world)
    payload.update({f"grad/{k}": v for k, v in grads.items()})
    payload["__loss"] = loss.numpy()
    # Adam's state of the whole model after one step on every row, cut to
    # the rank's shards and gathered back
    whole = whole_model(cfg, job["tree"])
    opt = make_optimizer(whole, cfg.trainer)
    out = whole.forward_train(_rank_batch(job, cfg, range(len(job["batch_samples"]))))
    pointer_cross_entropy(out, cfg.model.token)[0].backward()
    opt.step()
    state = opt.state_dict()
    cut = tensor.shard_opt_state(state, whole, world)
    back = tensor.gather_opt_state(cut, model)
    sharded = make_optimizer(model, cfg.trainer)
    sharded.load_state_dict(cut)
    for i, (name, p) in enumerate(model.named_parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            payload[f"opt/{name}/{key}/whole"] = state["state"][i][key].numpy()
            payload[f"opt/{name}/{key}/cut"] = cut["state"][i][key].numpy()
            payload[f"opt/{name}/{key}/back"] = back["state"][i][key].numpy()
        payload[f"opt/{name}/shape"] = np.asarray(p.shape)
        payload[f"opt/{name}/loaded"] = sharded.state_dict()["state"][i]["exp_avg"].numpy()
    _save(job, "tp", world, payload)


def task_tp_dropout(job) -> None:
    """The model axis with dropout and remat: one step's loss and gathered
    gradients, and the same under the planted fault."""
    cfg = config_from_dict(job["cfg_dropout"])
    world = _tp_world(job)
    payload = {}
    for label, fault in (("ok", False), ("fault", True)):
        _, loss, grads = _tp_step(job, cfg, world, fault=fault)
        payload.update({f"{label}/{k}": v for k, v in grads.items()})
        payload[f"__{label}_loss"] = loss.numpy()
    _save(job, "tp_dropout", world, payload)


def task_tp_flat(job) -> None:
    """The model axis on the flat SurfaceFormer, for each label flavor of
    ``job["flat"]`` (its config dicts, tree and samples): both engines'
    grids on the data rank's rows, with the causal_cache's self-attention
    cache shape; one step's loss and gathered gradients at dropout 0; then
    with dropout, remat and scheduled sampling, and the same under the
    planted fault (the keep masks' head offset left at 0)."""
    world = _tp_world(job)
    payload = {}
    for flavor in job["flat"]:
        sub, tag = {**job, **flavor}, flavor["flavor"]
        cfg = config_from_dict(sub["cfg"])
        model = whole_model(cfg, sub["tree"], flat=True)
        tensor.shard_params_(model, world)
        rows = list(range(world.data_rank, len(sub["batch_samples"]), world.data_size))
        batch = _rank_batch(sub, cfg, rows, flat=True)
        real, caches = decode._incremental_decoder_step, []

        def spy(model, cfg, x, qpos_t, step, self_k, *rest):
            caches.append(tuple(self_k[0].shape))
            return real(model, cfg, x, qpos_t, step, self_k, *rest)

        decode._incremental_decoder_step = spy
        try:
            for mode in ("reference", "causal_cache"):
                payload[f"{tag}/grid/{mode}"] = greedy_decode_single(
                    model, cfg.model, batch, precision="fp32", mode=mode)["predict"].numpy()
        finally:
            decode._incremental_decoder_step = real
        payload[f"{tag}/__cache_shapes"] = np.asarray(sorted(set(caches)))
        payload[f"{tag}/__rows"] = np.asarray(rows)
        payload[f"{tag}/__project_shape"] = np.asarray(model.project.weight.shape)
        _, loss, grads = _tp_step(sub, cfg, world, flat=True)
        payload.update({f"{tag}/grad/{k}": v for k, v in grads.items()})
        payload[f"{tag}/__loss"] = loss.numpy()
        cfg = config_from_dict(sub["cfg_dropout"])
        for label, fault in (("ok", False), ("fault", True)):
            _, loss, grads = _tp_step(sub, cfg, world, fault=fault, flat=True)
            payload.update({f"{tag}/{label}/{k}": v for k, v in grads.items()})
            payload[f"{tag}/__{label}_loss"] = loss.numpy()
    _save(job, "tp_flat", world, payload)


TASKS = {"fit": task_fit, "eval": task_eval, "uneven": task_uneven, "nan": task_nan,
         "load": task_load, "tp": task_tp, "tp_dropout": task_tp_dropout,
         "tp_flat": task_tp_flat}


def load_rank(out_dir: str, name: str, rank: int) -> dict:
    with np.load(os.path.join(out_dir, f"{name}_rank{rank}.npz")) as f:
        return {k: f[k] for k in f.files}
