"""Parameter init and the bridge to the JAX parameter tree.

The JAX tree (faceformer_tpu/models/common.py:31-55, layers.py:55-108)
stacks per-layer leaves along a leading axis and stores weights as
(in, out); the port keeps one ``nn.Module`` per layer and ``nn.Linear``
weights as (out, in). ``params_from_jax`` and ``params_to_numpy`` map one
onto the other leaf by leaf, so a JAX-initialised or JAX-trained tree loads
1:1 and round-trips bitwise.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

Tree = Dict[str, Any]
# (key path in the JAX tree, torch parameter, layer index or None, transposed)
_Leaf = Tuple[Tuple[str, ...], torch.Tensor, Optional[int], bool]


def _linear(path, lin: nn.Linear, layer=None) -> Iterator[_Leaf]:
    yield path + ("w",), lin.weight, layer, True
    yield path + ("b",), lin.bias, layer, False


def _norm(path, norm: nn.LayerNorm, layer=None) -> Iterator[_Leaf]:
    yield path + ("scale",), norm.weight, layer, False
    yield path + ("bias",), norm.bias, layer, False


def _attention(path, attn, layer) -> Iterator[_Leaf]:
    for name in "qkvo":
        lin = getattr(attn, name)
        yield path + ("w" + name,), lin.weight, layer, True
        yield path + ("b" + name,), lin.bias, layer, False


def _leaves(model) -> Iterator[_Leaf]:
    yield ("embed", "token_table"), model.embed.token_table, None, False
    yield from _linear(("embed", "lin1"), model.embed.lin1)
    yield from _linear(("embed", "lin2"), model.embed.lin2)
    yield ("pos_table",), model.pos_table, None, False
    yield ("query_pos_table",), model.query_pos_table, None, False
    for stack_name in ("encoder", "decoder"):
        stack = getattr(model, stack_name)
        base = (stack_name, "layers")
        for i, layer in enumerate(stack.layers):
            yield from _attention(base + ("self_attn",), layer.self_attn, i)
            if stack_name == "decoder":
                yield from _attention(base + ("cross_attn",), layer.cross_attn, i)
            norms = ("norm1", "norm2", "norm3") if stack_name == "decoder" else ("norm1", "norm2")
            for name in norms:
                yield from _norm(base + (name,), getattr(layer, name), i)
            yield from _linear(base + ("ffn", "lin1"), layer.ffn.lin1, i)
            yield from _linear(base + ("ffn", "lin2"), layer.ffn.lin2, i)
        yield from _norm((stack_name, "norm"), stack.norm)
    yield from _linear(("project",), model.project)


def _count_leaves(tree) -> int:
    return sum(_count_leaves(v) for v in tree.values()) if isinstance(tree, dict) else 1


@torch.no_grad()
def params_from_jax(model, tree: Tree) -> None:
    """Load a JAX parameter tree (numpy arrays or anything np.asarray
    takes) into ``model`` in place. Raises on a missing key, a shape
    mismatch or a leaf the model has no place for."""
    n_leaves = 0
    seen = set()
    for path, param, layer, transposed in _leaves(model):
        node = tree
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise KeyError(f"JAX tree has no {'/'.join(path)}")
            node = node[key]
        arr = np.asarray(node)
        if layer is not None:
            arr = arr[layer]
        value = torch.tensor(arr)
        if transposed:
            value = value.t()
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{'/'.join(path)}: JAX {tuple(value.shape)} vs port "
                             f"{tuple(param.shape)}")
        param.copy_(value.to(param.dtype))
        if path not in seen:
            seen.add(path)
            n_leaves += 1
    if n_leaves != _count_leaves(tree):
        raise ValueError(f"JAX tree has {_count_leaves(tree)} leaves, the model {n_leaves}")


def params_to_numpy(model) -> Tree:
    """The model's parameters as a JAX-layout tree of numpy arrays."""
    return _to_numpy(model, lambda param: param)


def grads_to_numpy(model) -> Tree:
    """The parameters' gradients (``.grad``) in the same JAX layout, stacked
    over layers, so they compare leaf by leaf with a JAX gradient tree. A
    parameter the loss does not reach (the encoder's final norm in post-LN)
    has no ``.grad`` and gives zeros, as ``jax.grad`` does."""

    def grad(param):
        return torch.zeros_like(param) if param.grad is None else param.grad

    return _to_numpy(model, grad)


@torch.no_grad()
def _to_numpy(model, pick) -> Tree:
    stacked: Dict[Tuple[str, ...], list] = {}
    tree: Tree = {}
    for path, param, layer, transposed in _leaves(model):
        arr = pick(param).detach().float().cpu()
        arr = (arr.t() if transposed else arr).contiguous().numpy()
        if layer is None:
            _set(tree, path, arr)
        else:
            stacked.setdefault(path, []).append(arr)
    for path, arrs in stacked.items():
        _set(tree, path, np.stack(arrs))
    return tree


def _set(tree: Tree, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _xavier_(t: torch.Tensor, generator: torch.Generator) -> None:
    """Xavier-uniform over the (in, out) pair, whichever way t stores it."""
    bound = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    nn.init.uniform_(t, -bound, bound, generator=generator)


_AFFINE = ("b", "bq", "bk", "bv", "bo", "scale", "bias")


@torch.no_grad()
def jitter_affine_(model, generator: torch.Generator, std: float = 0.1) -> None:
    """Add N(0, std) noise to every bias and every LayerNorm scale and bias.

    The reference init leaves attention biases at 0 and LayerNorms at the
    identity; trained weights do not. Parity checks on random weights
    jitter them, so that a kernel that drops one of them, or reads the
    wrong one, shows. Draws on the CPU from ``generator``, so a seed gives
    the same values on every device."""
    for path, param, _, _ in _leaves(model):
        if path[-1] in _AFFINE:
            noise = torch.randn(param.shape, generator=generator) * std
            param.add_(noise.to(param.device))


@torch.no_grad()
def init_parameters_(model, generator: torch.Generator) -> None:
    """The reference init (model.py:49-52): xavier-uniform for every matrix
    and table; torch-default fan-in uniform biases for plain linears; zero
    biases in attention; LayerNorm scale 1, bias 0. Draws from
    ``generator`` (a CPU generator, so the model must be on the CPU)."""
    fan_in = 0
    for path, param, _, _ in _leaves(model):
        if path[-1] == "scale":
            param.fill_(1.0)
        elif path[-1] == "bias" or path[-2:-1] in (("self_attn",), ("cross_attn",)) and param.ndim == 1:
            param.zero_()
        elif param.ndim == 2:
            _xavier_(param, generator)
            fan_in = param.shape[1]  # (out, in) for a linear; its bias comes next
        else:
            bound = 1.0 / math.sqrt(fan_in)
            nn.init.uniform_(param, -bound, bound, generator=generator)
