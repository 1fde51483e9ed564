"""PyTorch port: the remat policies keep different things for the backward
(CPU, fp32, tiny dims). One training forward under each policy, and the
bytes it leaves for the backward: what autograd saves outside the
checkpointed layers, each checkpoint's input, and what a named policy
saves inside (counted by a wrapper around the policy from the shapes of the
ops it keeps). ``full`` < ``attn`` < ``attn_ffn`` < ``dots`` < remat off
shows that the policies really differ. Their gradients are held against
the JAX package's and ``full``'s in tests/test_torch_train.py."""

import dataclasses

import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from faceformer_tpu_torch.models import layers as L
from faceformer_tpu_torch.train.loss import pointer_cross_entropy

from torch_port_helpers import (  # noqa: F401
    fixture_batch,
    jax_params,
    port_model,
    torch_batch,
    torch_fp32_single_thread,
)


def saved_output_bytes(op, args) -> int:
    """Bytes of the output of an op a policy keeps, from its arguments."""
    if op == torch.ops.aten.mm.default:
        a, b = args
    elif op == torch.ops.aten.addmm.default:
        a, b = args[1], args[2]
    else:  # the ckpt_name tag: its output is a copy of its input
        return args[0].nbytes
    return a.shape[0] * b.shape[1] * a.element_size()


def kept_bytes(model, batch, monkeypatch) -> int:
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    storages, inside = {}, []

    def note(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in params:
            storages[ptr] = t.untyped_storage().nbytes()
        return t

    real_checkpoint, real_policy = L.checkpoint, L.remat_policy_fn

    def counting_checkpoint(fn, layer, x, *args, **kwargs):
        note(x)  # the checkpoint keeps its input for the recomputation
        return real_checkpoint(fn, layer, x, *args, **kwargs)

    def counting_policy(name):
        policy = real_policy(name)

        def counted(ctx, op, *args, **kwargs):
            got = policy(ctx, op, *args, **kwargs)
            if got == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                inside.append(saved_output_bytes(op, args))
            return got

        return counted

    monkeypatch.setattr(L, "checkpoint", counting_checkpoint)
    monkeypatch.setattr(L, "remat_policy_fn", counting_policy)
    with torch.autograd.graph.saved_tensors_hooks(note, lambda t: t):
        out = model.forward_train(torch_batch(batch))
        pointer_cross_entropy(out, model.cfg.token)
    return sum(storages.values()) + sum(inside)


def test_remat_policies_keep_ordered_bytes(tiny_model_cfg, monkeypatch):
    batch = fixture_batch(tiny_model_cfg)
    tree = jax_params(tiny_model_cfg, seed=6)
    kept = {}
    for policy in ("full", "attn", "attn_ffn", "dots", "off"):
        cfg = dataclasses.replace(tiny_model_cfg, remat=policy != "off",
                                  remat_policy="full" if policy == "off" else policy)
        with monkeypatch.context() as m:
            kept[policy] = kept_bytes(port_model(cfg, tree), batch, m)
    values = list(kept.values())
    assert values == sorted(values) and len(set(values)) == 5, kept


def test_remat_tags_only_under_a_named_policy():
    """The tag copies only where a policy keeps its name; the copy carries
    the gradient through unchanged."""
    x = torch.randn(3, 4, requires_grad=True)
    assert L._ckpt_name(x, "attn_out", ()) is x
    assert L._ckpt_name(x, "ffn_out", ("attn_out",)) is x
    y = L._ckpt_name(x, "attn_out", ("attn_out",))
    assert y is not x and torch.equal(y, x)
    (y * 2.0).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 2.0))
    policy = L.remat_policy_fn("attn")
    assert policy(None, torch.ops.faceformer_tpu_torch.ckpt_name.default, x, "attn_out") == (
        CheckpointPolicy.MUST_SAVE)
    assert policy(None, torch.ops.aten.mm.default, x, x.t()) == CheckpointPolicy.PREFER_RECOMPUTE
    assert L.remat_policy_fn("dots")(None, torch.ops.aten.mm.default, x, x.t()) == (
        CheckpointPolicy.MUST_SAVE)


def test_unknown_remat_policy_raises(tiny_model_cfg):
    cfg = dataclasses.replace(tiny_model_cfg, remat=True, remat_policy="everything")
    model = port_model(cfg, jax_params(tiny_model_cfg, seed=6))
    with pytest.raises(ValueError, match="remat_policy"):
        model.forward_train(torch_batch(fixture_batch(tiny_model_cfg)))
