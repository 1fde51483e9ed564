"""Tensor parallelism over the model axis (PyTorch counterpart of
faceformer_tpu/parallel/mesh.py:44-141, the Megatron split).

The ``model_axis`` ranks of one data rank (``World.model_group``, a row of
the grid in parallel/mesh.py) hold one model between them:
  - column-parallel, the output features cut into ``model_axis`` slices
    (torch's ``nn.Linear.weight`` is (out, in), so JAX's ``P(None,
    "model")`` is dim 0 here): the q/k/v projections and their biases of
    every self- and cross-attention (heads over the model axis), the FFN's
    ``lin1`` and the pointer ``project``;
  - row-parallel, the input features cut (JAX's ``P("model", None)``, dim
    1 here): every attention's ``o`` and the FFN's ``lin2``, whose biases
    stay whole and are added once, after the sum over the model ranks;
  - replicated: everything else (embedding, position tables, LayerNorms).
A rank holds slice ``model_rank`` of every cut leaf.

The layers (models/layers.py) reach the model group through the ``Shard``
that ``shard_params_`` sets on every sharded module, and through three
conjugate autograd functions, each a no-op without a shard:
``copy_to_model`` (identity forward, the gradient all-reduced backward) on
each column-parallel input; ``reduce_from_model`` (all-reduce forward,
identity backward) after each row-parallel product; ``gather_from_model``
(all-gather of the last dim forward, the rank's slice backward) after the
pointer projection. So every activation outside an attention block or an
FFN is replicated over the model ranks, as JAX's sharding propagation
leaves it, and the loss and every replicated parameter's gradient are the
same on each.
"""

from __future__ import annotations

import dataclasses
import re
import types
from typing import Any, Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist

from faceformer_tpu_torch.parallel.mesh import World


@dataclasses.dataclass(frozen=True)
class Shard:
    """A module's place on the model axis: slice ``rank`` of ``size``,
    reduced over ``group``."""

    rank: int
    size: int
    group: Any


# (parameter name pattern, the dim cut over the model axis)
_COLUMN = (r"\.(self_attn|cross_attn)\.[qkv]\.(weight|bias)$", r"\.ffn\.lin1\.(weight|bias)$",
           r"^project\.(weight|bias)$")
_ROW = (r"\.(self_attn|cross_attn)\.o\.weight$", r"\.ffn\.lin2\.weight$")


def partition_specs(model) -> Dict[str, Optional[int]]:
    """The split table, leaf by leaf: each parameter's name -> the dim cut
    over the model axis (0: column-parallel, 1: row-parallel), or None
    (replicated)."""
    specs = {}
    for name, _ in model.named_parameters():
        if any(re.search(p, name) for p in _COLUMN):
            specs[name] = 0
        elif any(re.search(p, name) for p in _ROW):
            specs[name] = 1
        else:
            specs[name] = None
    return specs


def _sharded_modules(model):
    """The modules that hold cut leaves or run collectives: every attention
    block and FFN, both stacks and the model itself (its ``project``)."""
    yield model
    for stack in (model.encoder, model.decoder):
        yield stack
        for layer in stack.layers:
            yield layer.self_attn
            if hasattr(layer, "cross_attn"):
                yield layer.cross_attn
            yield layer.ffn


def _cut(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    width = t.shape[dim] // size
    return t.narrow(dim, rank * width, width)


def _check_divisible(cfg, model_axis: int) -> None:
    """Refuse a model whose heads or FFN columns do not divide over the
    model axis."""
    for what, count in (("num_head", cfg.num_head), ("num_feedforward", cfg.num_feedforward)):
        if count % model_axis:
            raise ValueError(f"model.{what}={count} does not divide over model_axis="
                             f"{model_axis}")


@torch.no_grad()
def shard_params_(model, world: World) -> None:
    """Cut a whole model (either ``PointerNetwork``: both have the same
    ``encoder``, ``decoder`` and ``project``), the same on every rank, down
    to the rank's shards in place, and give its sharded modules the rank's
    ``Shard``. Nothing to do at model_axis 1. The optimizer is made after
    this (or its state cut with ``shard_opt_state``)."""
    if world.model_axis == 1:
        return
    if getattr(model, "shard", None) is not None:
        raise ValueError("the model is sharded already")
    _check_divisible(model.cfg, world.model_axis)
    shard = Shard(world.model_rank, world.model_axis, world.model_group)
    specs = partition_specs(model)
    for name, param in model.named_parameters():
        dim = specs[name]
        if dim is not None:
            param.data = _cut(param.data, dim, shard.rank, shard.size).clone()
    for module in _sharded_modules(model):
        module.shard = shard


def _gather(t: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t.contiguous(), group=shard.group)
    return torch.cat(parts, dim=dim)


@torch.no_grad()
def gather_params(model, grads: bool = False, prefix: Union[str, Sequence[str]] = ""
                  ) -> Dict[str, torch.Tensor]:
    """The whole parameters (their gradients with ``grads``) in the
    one-rank layout, name -> tensor, on every rank of the model group: the
    inverse of ``shard_params_``, over the model group of the model's
    ``shard`` (a whole model: copies). ``prefix`` keeps the names that
    start with it (or with one of them). Collective over the model
    group."""
    prefix = prefix if isinstance(prefix, str) else tuple(prefix)
    specs = partition_specs(model)
    shard = getattr(model, "shard", None)
    out = {}
    for name, param in model.named_parameters():
        if not name.startswith(prefix):
            continue
        t = param.grad if grads else param.detach()
        if t is None:
            t = torch.zeros_like(param)
        dim = specs[name]
        out[name] = t.clone() if shard is None or dim is None else _gather(t, dim, shard)
    return out


def _cut_state(state: Dict, model, cut) -> Dict:
    specs = [partition_specs(model)[name] for name, _ in model.named_parameters()]
    out = {"param_groups": state["param_groups"], "state": {}}
    for index, entry in state["state"].items():
        dim = specs[index]
        out["state"][index] = {
            key: (cut(value, dim) if dim is not None and torch.is_tensor(value)
                  and value.ndim > 0 else value)
            for key, value in entry.items()}
    return out


def shard_opt_state(state: Dict, model, world: World) -> Dict:
    """An Adam ``state_dict`` of the whole model cut for the rank's shards:
    ``exp_avg`` and ``exp_avg_sq`` as their parameters, ``step`` replicated
    (mesh.py:108-141). The state's entries follow ``model.parameters()``
    (``train.step.make_optimizer``)."""
    if world.model_axis == 1:
        return state
    return _cut_state(state, model,
                      lambda t, dim: _cut(t, dim, world.model_rank, world.model_axis).clone())


@torch.no_grad()
def gather_opt_state(state: Dict, model) -> Dict:
    """The inverse of ``shard_opt_state``: the whole model's Adam state,
    in the one-rank layout, from the rank's state of a cut ``model``.
    Collective over the model group."""
    shard = getattr(model, "shard", None)
    if shard is None:
        return state
    return _cut_state(state, model, lambda t, dim: _gather(t, dim, shard))


def gather_modules(model, prefix: Union[str, Sequence[str]] = ""):
    """``gather_params(model, prefix=prefix)`` as a tree of namespaces with
    the model's attribute paths (``.decoder.layers[i].self_attn.q.weight``),
    for code that reads a whole model's weights (the fused decode step's
    packing). Collective over the model group."""
    root: Dict[str, Any] = {}
    for name, t in gather_params(model, prefix=prefix).items():
        *path, leaf = name.split(".")
        node = root
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t

    def build(node):
        if not isinstance(node, dict):
            return node
        if all(key.isdigit() for key in node):
            return [build(node[str(i)]) for i in range(len(node))]
        return types.SimpleNamespace(**{key: build(value) for key, value in node.items()})

    return build(root)


@torch.no_grad()
def replicate_grads_(model) -> None:
    """The gradients of the replicated parameters, model rank 0's on every
    model rank (one broadcast of a flattened bucket over the model group).
    Each model rank computes them in full, equal but for the order of a
    device's atomic adds (the embedding rows' gather), which would leave
    the ranks' copies apart by an ulp a step. Nothing to do without a
    shard."""
    shard = getattr(model, "shard", None)
    if shard is None:
        return
    specs = partition_specs(model)
    grads = [p.grad for name, p in model.named_parameters()
             if specs[name] is None and p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.broadcast(flat, src=dist.get_global_rank(shard.group, 0), group=shard.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


# -- the conjugate functions --------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _gather(x, -1, shard)

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        return _cut(grad, -1, shard.rank, shard.size).contiguous(), None


def copy_to_model(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """A column-parallel input: ``x`` forward, its gradient summed over the
    model ranks backward (each rank's heads or columns give a part)."""
    return x if shard is None else _CopyToModel.apply(x, shard.group)


def reduce_from_model(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """A row-parallel product's partial sums, summed over the model ranks;
    the gradient passes unchanged."""
    return x if shard is None else _ReduceFromModel.apply(x, shard.group)


def gather_from_model(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The model ranks' slices of the last dim, joined in rank order; the
    gradient's slice of this rank backward."""
    return x if shard is None else _GatherFromModel.apply(x, shard)
