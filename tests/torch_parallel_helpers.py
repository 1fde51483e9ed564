"""Rank side of the port's multi-rank CPU tests (tests/test_torch_parallel*.py).

``run_ranks`` starts two gloo ranks on the CPU through the port's own
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

from faceformer_tpu_torch.config import config_from_dict
from faceformer_tpu_torch.data.batching import collate
from faceformer_tpu_torch.data.dataset import ABCDatasetParallel
from faceformer_tpu_torch.parallel import mesh
from faceformer_tpu_torch.params import grads_to_numpy, params_from_jax, params_to_numpy
from faceformer_tpu_torch.train.loss import pointer_cross_entropy
from faceformer_tpu_torch.train.step import make_optimizer, train_step
from faceformer_tpu_torch.train.trainer import Harness


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


def _rank_batch(job, cfg, rows):
    ds = ABCDatasetParallel.from_samples(job["batch_samples"], cfg.model)
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
    payload["__adam_steps_after_skip"] = np.asarray(len(opt.state))
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


TASKS = {"fit": task_fit, "eval": task_eval, "uneven": task_uneven, "nan": task_nan,
         "load": task_load}


def load_rank(out_dir: str, name: str, rank: int) -> dict:
    with np.load(os.path.join(out_dir, f"{name}_rank{rank}.npz")) as f:
        return {k: f[k] for k in f.files}
