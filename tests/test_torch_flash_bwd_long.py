"""PyTorch port: K3's plain version against the JAX package's Pallas VJP
(interpret mode, CPU) where the card's key-tiled backward kernels are
judged: bf16 at hd = 64 past 256 keys, and fp32 under the causal mask on
rows whose every key is masked.

On the card every bf16 call at hd = 64 with more than 256 keys runs the
key-tiled tensor-core pair (csrc/flash_bwd_tiled_tc.cuh and the dk/dv
kernel of csrc/flash_bwd_tc.cuh), held against ``flash_attention_bwd_plain``
in tests/test_torch_gpu.py and chip_smoke.py. This file holds that plain
version to the reference.

    python -m pytest tests/test_torch_flash_bwd_long.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceformer_tpu.ops.flash import flash_attention as jax_flash_attention
from faceformer_tpu_torch.ops.flash import (
    flash_attention_bwd_plain,
    flash_attention_plain,
    padding_mask_bias,
)

from torch_port_helpers import torch_fp32_single_thread  # noqa: F401

# largest error of dq, dk, dv relative to the reference tensor's largest
# magnitude. bf16: both sides compute in fp32 from the same bf16 inputs and
# round the gradients to bf16 once; measured 5.4e-4 (one bf16 rounding
# apart where the fp32 sums differ in their last bits). fp32: measured
# 3.0e-7.
TOL = {torch.bfloat16: 2e-3, torch.float32: 1e-5}


def inputs(n, sq, sk, h, hd, pad):
    rng = np.random.default_rng(11)
    q, do = (rng.standard_normal((n, sq, h, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((n, sk, h, hd)).astype(np.float32) for _ in range(2))
    return q, k, v, do, padding_mask_bias(torch.as_tensor(pad))


def grads_both(q, k, v, do, bias, causal, dtype):
    """(ours, theirs): dq, dk, dv of the plain backward (given the plain
    forward's lse) and of the Pallas VJP, as fp32 numpy, for one cotangent
    ``do`` rounded to ``dtype``."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(a, dtype=jd) for a in (q, k, v, do))
    jbias = jnp.asarray(bias.numpy())
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, jbias, causal=causal,
                                                         interpret=True), jq, jk, jv)
    theirs = [np.asarray(g, dtype=np.float32) for g in vjp(jdo)]
    tq, tk, tv, tdo = (torch.as_tensor(a).to(dtype) for a in (q, k, v, do))
    _, lse = flash_attention_plain(tq, tk, tv, bias, causal)
    ours = flash_attention_bwd_plain(tq, tk, tv, bias, lse, tdo, causal)
    assert all(g.dtype == dtype for g in ours)
    return [g.float().numpy() for g in ours], theirs, lse


def assert_close(ours, theirs, tol):
    for name, a, b in zip(("dq", "dk", "dv"), ours, theirs):
        assert np.isfinite(a).all(), name
        err = float(np.abs(a - b).max() / np.abs(b).max())
        assert err <= tol, (name, err)


@pytest.mark.parametrize("sq,sk,causal,valid", [(300, 300, True, (300, 300)),
                                                 (70, 333, False, (333, 201))],
                         ids=["causal-300", "ragged-333"])
def test_plain_flash_bwd_bf16_long_keys_match_pallas(sq, sk, causal, valid):
    """hd = 64, dropout 0: a causal 300 x 300 call (past the whole-row
    tensor-core kernels' 256 keys, a ragged last 64-key tile) and a
    non-causal one against 333 keys, the second sample's keys padded after
    201 (the forward's cases in tests/test_torch_flash_long_bf16.py)."""
    pad = np.arange(sk)[None, :] >= np.asarray(valid)[:, None]
    ours, theirs, _ = grads_both(*inputs(2, sq, sk, 2, 64, pad), causal, torch.bfloat16)
    assert_close(ours, theirs, TOL[torch.bfloat16])


def test_plain_flash_bwd_dead_causal_rows_match_pallas():
    """fp32, causal, hd 16: sample 0's first 7 keys are padded, so its rows
    0-6 see no live key; sample 1's keys are all padded. Such a row's lse is
    the float32 minimum and p = exp(s - lse) is 1 at every key, above the
    diagonal too (faceformer_tpu/ops/flash.py:153). The plain backward
    keeps those contributions as the Pallas VJP does, and they are large:
    a kernel that skipped the key tiles past a block's rows, or the query
    rows before a key tile, would drop them."""
    n, sq, sk = 2, 40, 40
    pad = np.zeros((n, sk), bool)
    pad[0, :7] = True
    pad[1, :] = True
    q, k, v, do, bias = inputs(n, sq, sk, 2, 16, pad)
    ours, theirs, lse = grads_both(q, k, v, do, bias, True, torch.float32)
    assert_close(ours, theirs, TOL[torch.float32])
    dead = lse <= float(np.finfo(np.float32).min)
    assert bool(dead[0, :7].all()) and not bool(dead[0, 7:].any()) and bool(dead[1].all())

    # the same backward with the dead rows' p zeroed (lse raised to 0 there)
    tq, tk, tv, tdo = (torch.as_tensor(a) for a in (q, k, v, do))
    without = flash_attention_bwd_plain(tq, tk, tv, bias, torch.where(dead, 0.0, lse), tdo, True)
    for name, full, cut in zip(("dq", "dk", "dv"), ours, without):
        gone = np.abs(full - cut.numpy())
        # sample 0's live keys 7.. get the dead rows 0-6 only above the
        # diagonal; every key of sample 1 gets rows above it
        above = gone[0, 7:] if name != "dq" else gone[0, :7]
        assert above.max() > 1.0 and gone[1].max() > 1.0, (name, above.max(), gone[1].max())
