"""PyTorch port: K2's plain version in bf16 past 256 keys against the JAX
package's Pallas kernel (interpret mode, CPU).

On the card every bf16 call at hd = 64 with more than 256 keys runs the
key-tiled tensor-core kernel (csrc/attention_tiled_tc.cuh), which is held
against ``flash_attention_plain`` (tests/test_torch_gpu.py, chip_smoke.py).
This file holds that plain version to the reference at the rounding point
the kernel is judged by: p rounded to bf16 before the product with v. The
fp32 case is tests/test_torch_flat.py::test_plain_flash_long_keys_match_pallas.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceformer_tpu.ops.flash import _flash_fwd_impl
from faceformer_tpu.ops.flash import flash_attention as jax_flash_attention
from faceformer_tpu_torch.ops.flash import flash_attention_plain, padding_mask_bias

# the card's bf16 gate on K2's out and lse (absolute): bf16 inputs and
# output (8 bits of mantissa, |out| below ~3), the sums in fp32 on both sides
TOL = 2e-2


@pytest.mark.parametrize("sq,sk,causal,valid", [(300, 300, True, (300, 300)),
                                                 (70, 333, False, (333, 201))],
                         ids=["causal-300", "ragged-333"])
def test_plain_flash_bf16_long_keys_match_pallas(sq, sk, causal, valid):
    """hd = 64, dropout 0: a causal 300 x 300 call (past the whole-row
    tensor-core kernel's 256 keys, a ragged last 64-key tile) and a
    non-causal one against 333 keys, the second sample's keys padded after
    201."""
    rng = np.random.default_rng(10)
    n, h, hd = 2, 2, 64
    q = rng.standard_normal((n, sq, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((n, sk, h, hd)).astype(np.float32) for _ in range(2))
    pad = np.arange(sk)[None, :] >= np.asarray(valid)[:, None]
    bias = padding_mask_bias(torch.as_tensor(pad))
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
    jbias = jnp.asarray(bias.numpy())
    out_j = jax_flash_attention(jq, jk, jv, jbias, causal=causal, interpret=True)
    _, lse_j = _flash_fwd_impl(jq, jk, jv, jbias, jnp.zeros((1,), jnp.float32), causal, True,
                               0.0)
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    out, lse = flash_attention_plain(tq, tk, tv, bias, causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), np.asarray(out_j, dtype=np.float32),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :sq], atol=TOL, rtol=0)
