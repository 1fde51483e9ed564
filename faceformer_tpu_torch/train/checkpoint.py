"""Checkpoints: save-last + top-k management, and the reference PyTorch
checkpoint converters (PyTorch counterpart of
faceformer_tpu/train/checkpoint.py).

Replaces PyTorch-Lightning's ModelCheckpoint (reference: main.py:31-37 —
save_last, top-2 by valid_precision) with the JAX manager's semantics: the
config travels as a JSON sidecar, ``index.json`` lists the scored
checkpoints, ties go to the newer one, writes go through a temporary file
and a rename.

The port's own checkpoint is one ``torch.save`` file holding the model's
``state_dict``, the optimizer's ``state_dict``, ``epoch`` and ``step``. The
JAX package's Orbax trees are not read. Reference Lightning ``.ckpt`` /
``.pt`` / ``.pth`` state dicts are: ``load_torch_checkpoint`` converts one
to the JAX-layout parameter tree, which ``params.params_from_jax`` loads.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from faceformer_tpu_torch.config import Config, config_to_dict


class CheckpointManager:
    """save-last + keep-top-k-by-metric checkpoint directory manager."""

    def __init__(self, directory: str, top_k: int = 2, metric: str = "valid_precision",
                 tie_refresh_epochs: int = 8):
        self.directory = directory
        self.top_k = top_k
        self.metric = metric
        # on an exact metric tie, refresh the newest tied checkpoint only
        # when it is at least this many epochs stale: keeps the
        # prefer-newer-on-ties policy (bounded staleness) without a
        # duplicate top-k disk write every validation epoch once the metric
        # saturates (e.g. precision pinned at 1.0)
        self.tie_refresh_epochs = tie_refresh_epochs
        os.makedirs(directory, exist_ok=True)
        self._index_path = os.path.join(directory, "index.json")
        self._index_dir = os.path.dirname(os.path.abspath(self._index_path))
        self._index: Dict[str, Any] = {"top": [], "last": None}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)
            # an index carried across machines can list entries whose
            # weights are gone (only the small .meta.json sidecars are kept
            # in git): drop them and their orphaned sidecars
            live, stale = [], []
            for e in self._index.get("top", []):
                (live if os.path.isfile(self._resolve(e[1])) else stale).append(e)
            if stale:
                self._index["top"] = live
                for e in stale:
                    full = self._resolve(e[1])
                    if os.path.exists(full + ".meta.json"):
                        os.remove(full + ".meta.json")
                with open(self._index_path, "w") as f:
                    json.dump(self._index, f, indent=1)

    def _resolve(self, path: str) -> str:
        """An index entry as a path from any working directory: entries are
        written into this manager's directory, so a relative one resolves
        against the index file's directory, not the working directory."""
        if os.path.isabs(path):
            return path
        return os.path.join(self._index_dir, os.path.basename(path))

    # -- low-level file io ---------------------------------------------------

    @staticmethod
    def save_tree(path: str, tree: Dict[str, Any]) -> None:
        """One ``torch.save`` file at ``path``."""
        torch.save(tree, path)

    @staticmethod
    def restore_tree(path: str, map_location="cpu") -> Dict[str, Any]:
        """The dict ``save_tree`` wrote, its tensors on ``map_location``."""
        return torch.load(path, map_location=map_location, weights_only=True)

    # -- manager API -----------------------------------------------------------

    def save(self, state: Dict[str, Any], cfg: Config, epoch: int,
             metric_value: Optional[float] = None) -> str:
        """Save ``last`` and, when metric_value ranks in the top-k, a scored
        checkpoint named epoch=N-<metric>=V (reference filename convention,
        main.py:33). ``state`` is what ``save_tree`` writes."""
        meta = {"epoch": epoch, "config": config_to_dict(cfg), self.metric: metric_value}

        last_path = os.path.join(self.directory, "last")
        self._write(last_path, state, meta)
        self._index["last"] = last_path

        # Lightning save_top_k semantics: 0 disables scored saves, negative
        # keeps every scored checkpoint (reference main.py:31-37)
        if metric_value is not None and self.top_k != 0:
            name = f"epoch={epoch}-{self.metric}={metric_value:.4f}"
            path = os.path.join(self.directory, name)
            # entries are [metric, path, epoch]; legacy indexes carry
            # [metric, path] and read back with epoch 0
            entries = [tuple(e) + (0,) * (3 - len(e)) for e in self._index["top"]]
            # >= (not >): on metric ties, prefer the NEWER checkpoint; exact
            # ties refresh at most every tie_refresh_epochs (see __init__)
            newest_tied = max((e[2] for e in entries if e[0] == metric_value), default=None)
            tie_fresh = (newest_tied is not None
                         and epoch - newest_tied < self.tie_refresh_epochs)
            floor = min((e[0] for e in entries), default=None)
            if (self.top_k < 0
                    or len(entries) < self.top_k
                    or metric_value > floor
                    or (metric_value >= floor and not tie_fresh)):
                # the scored file is a copy of `last`: one serialization
                # (and one device->host pull) serves both
                self._copy(last_path, path, meta)
                entries.append((metric_value, path, epoch))
                entries.sort(key=lambda e: (-e[0], -e[2]))
                if self.top_k > 0:
                    for _, stale, _e in entries[self.top_k:]:
                        if os.path.exists(stale):
                            os.remove(stale)
                        if os.path.exists(stale + ".meta.json"):
                            os.remove(stale + ".meta.json")
                    entries = entries[: self.top_k]
                self._index["top"] = entries
        with open(self._index_path, "w") as f:
            json.dump(self._index, f, indent=1)
        return self._index["last"]

    def _write(self, path: str, state: Dict[str, Any], meta: Dict) -> None:
        # write-then-rename: a process that dies mid-save leaves the previous
        # checkpoint whole, so the run stays resumable
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            os.remove(tmp)
        self.save_tree(tmp, state)
        os.replace(tmp, path)
        self._write_meta(path, meta)

    def _copy(self, src: str, path: str, meta: Dict) -> None:
        tmp = path + ".tmp"
        shutil.copyfile(src, tmp)
        os.replace(tmp, path)
        self._write_meta(path, meta)

    @staticmethod
    def _write_meta(path: str, meta: Dict) -> None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=1)

    def best_path(self) -> Optional[str]:
        """The best scored checkpoint, else ``last`` (None before a save),
        resolved as the liveness check resolves entries."""
        best = self._index["top"][0][1] if self._index["top"] else self._index["last"]
        return None if best is None else self._resolve(best)


def load_checkpoint(path: str, map_location="cpu"):
    """Restore (state, meta) of a checkpoint the manager wrote."""
    state = CheckpointManager.restore_tree(path, map_location)
    meta_path = path.rstrip("/") + ".meta.json"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


# ---------------------------------------------------------------------------
# reference PyTorch checkpoint conversion
# ---------------------------------------------------------------------------

# the reference's module paths (faceformer/models/model.py,
# faceformer/transformer.py) <-> the JAX-layout parameter tree that
# params.params_from_jax / params_to_numpy speak


def _stack(layers: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-layer trees -> one tree with each leaf stacked on a new axis 0."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return np.stack(layers)


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _num_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def convert_torch_state_dict(state_dict: Dict[str, Any], num_layers_enc: int,
                             num_layers_dec: int) -> Dict[str, Any]:
    """Convert a reference PyTorch state_dict to the JAX-layout tree.

    Handles the Lightning 'model.' prefix, torch's (out, in) Linear layout
    (transposed here), and nn.MultiheadAttention's packed in_proj q/k/v
    stacking (reference ckpts store in_proj_weight as [Wq; Wk; Wv]).
    """

    def g(name: str) -> np.ndarray:
        for candidate in (name, "model." + name):
            if candidate in state_dict:
                return np.asarray(state_dict[candidate], dtype=np.float32)
        raise KeyError(f"missing parameter {name!r} in checkpoint")

    def lin(name: str) -> Dict[str, np.ndarray]:
        return {"w": g(name + ".weight").T, "b": g(name + ".bias")}

    def ln(name: str) -> Dict[str, np.ndarray]:
        return {"scale": g(name + ".weight"), "bias": g(name + ".bias")}

    def attn(name: str) -> Dict[str, np.ndarray]:
        in_w = g(name + ".in_proj_weight")
        in_b = g(name + ".in_proj_bias")
        e = in_w.shape[1]
        wq, wk, wv = in_w[:e], in_w[e: 2 * e], in_w[2 * e:]
        bq, bk, bv = in_b[:e], in_b[e: 2 * e], in_b[2 * e:]
        out = lin(name + ".out_proj")
        return {"wq": wq.T, "wk": wk.T, "wv": wv.T, "bq": bq, "bk": bk, "bv": bv,
                "wo": out["w"], "bo": out["b"]}

    def enc_layer(i: int) -> Dict[str, Any]:
        base = f"encoder.layers.{i}"
        return {
            "self_attn": attn(base + ".self_attn"),
            "norm1": ln(base + ".norm1"),
            "norm2": ln(base + ".norm2"),
            "ffn": {"lin1": lin(base + ".linear1"), "lin2": lin(base + ".linear2")},
        }

    def dec_layer(i: int) -> Dict[str, Any]:
        base = f"decoder.layers.{i}"
        return {
            "self_attn": attn(base + ".self_attn"),
            "cross_attn": attn(base + ".multihead_attn"),
            "norm1": ln(base + ".norm1"),
            "norm2": ln(base + ".norm2"),
            "norm3": ln(base + ".norm3"),
            "ffn": {"lin1": lin(base + ".linear1"), "lin2": lin(base + ".linear2")},
        }

    return {
        "embed": {
            "token_table": g("val_enc.embedding_token.weight"),
            "lin1": lin("val_enc.embedding_value.0"),
            "lin2": lin("val_enc.embedding_value.2"),
        },
        "pos_table": g("pos_enc.pos_embed.weight"),
        "query_pos_table": g("query_pos_enc.pos_embed.weight"),
        "encoder": {
            "layers": _stack([enc_layer(i) for i in range(num_layers_enc)]),
            "norm": ln("encoder.norm"),
        },
        "decoder": {
            "layers": _stack([dec_layer(i) for i in range(num_layers_dec)]),
            "norm": ln("decoder.norm"),
        },
        "project": lin("project"),
    }


def export_torch_state_dict(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse of convert_torch_state_dict: a JAX-layout tree (e.g.
    ``params.params_to_numpy(model)``) -> the reference's Lightning keys."""
    out: Dict[str, np.ndarray] = {}

    def a(name, arr):
        out["model." + name] = np.asarray(arr, dtype=np.float32)

    def put_lin(name, p):
        a(name + ".weight", np.asarray(p["w"]).T)
        a(name + ".bias", p["b"])

    def put_ln(name, p):
        a(name + ".weight", p["scale"])
        a(name + ".bias", p["bias"])

    def put_attn(name, p):
        a(name + ".in_proj_weight",
          np.concatenate([np.asarray(p["wq"]).T, np.asarray(p["wk"]).T,
                          np.asarray(p["wv"]).T], axis=0))
        a(name + ".in_proj_bias",
          np.concatenate([np.asarray(p["bq"]), np.asarray(p["bk"]), np.asarray(p["bv"])]))
        put_lin(name + ".out_proj", {"w": p["wo"], "b": p["bo"]})

    a("val_enc.embedding_token.weight", params["embed"]["token_table"])
    put_lin("val_enc.embedding_value.0", params["embed"]["lin1"])
    put_lin("val_enc.embedding_value.2", params["embed"]["lin2"])
    a("pos_enc.pos_embed.weight", params["pos_table"])
    a("query_pos_enc.pos_embed.weight", params["query_pos_table"])

    for side in ("encoder", "decoder"):
        stacked = params[side]["layers"]
        for i in range(_num_layers(stacked)):
            lp = _layer(stacked, i)
            base = f"{side}.layers.{i}"
            put_attn(base + ".self_attn", lp["self_attn"])
            if side == "decoder":
                put_attn(base + ".multihead_attn", lp["cross_attn"])
            put_ln(base + ".norm1", lp["norm1"])
            put_ln(base + ".norm2", lp["norm2"])
            if side == "decoder":
                put_ln(base + ".norm3", lp["norm3"])
            put_lin(base + ".linear1", lp["ffn"]["lin1"])
            put_lin(base + ".linear2", lp["ffn"]["lin2"])
        put_ln(f"{side}.norm", params[side]["norm"])
    put_lin("project", params["project"])
    return out


def load_torch_checkpoint(path: str, num_layers_enc: int, num_layers_dec: int):
    """Load a reference .ckpt (Lightning) or .pt/.pth state_dict file and
    convert it to the JAX-layout tree. A Lightning blob pickles more than
    tensors (callbacks, hyperparameters), hence ``weights_only=False``:
    load only checkpoints you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    state_dict = {k: v.detach().float().numpy() if isinstance(v, torch.Tensor) else v
                  for k, v in state_dict.items()}
    return convert_torch_state_dict(state_dict, num_layers_enc, num_layers_dec)
