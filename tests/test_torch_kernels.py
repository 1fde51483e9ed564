"""PyTorch port: each kernel's plain version against the JAX Pallas kernel
run in interpret mode (CPU, fp32). The CUDA kernels are held against these
plain versions on the card in tests/test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceformer_tpu.ops import decode_step as jds
from faceformer_tpu.ops.flash import _flash_fwd_impl
from faceformer_tpu.ops.pointer import pointer_argmax_batched
from faceformer_tpu_torch.decode import NEG, _cross_kv
from faceformer_tpu_torch.ops.decode_step import decode_gemm, decode_step, pack_decoder_weights
from faceformer_tpu_torch.ops.flash import flash_attention_fwd, padding_mask_bias
from faceformer_tpu_torch.ops.pointer import pointer_argmax, pointer_argmax_gather

from torch_port_helpers import (  # noqa: F401
    jax_params,
    port_model,
    torch_fp32_single_thread,
)


def pointer_inputs(rng, n=3, r=10, s=13, e=16):
    rows = rng.standard_normal((n, r, e)).astype(np.float32)
    memory = rng.standard_normal((n, s, e)).astype(np.float32)
    memory[:, 7] = memory[:, 2]  # constructed ties: rows aimed at row 2 (== row 7)
    rows[:, :3] = 2 * memory[:, 2:3]
    mask = np.zeros((n, s), bool)
    mask[0, 10:] = True
    mask[1, 4:] = True
    mask[2, 2] = True  # sample 2 masks row 2, so its twin row 7 wins alone
    return rows, memory, mask


def test_pointer_plain_matches_pallas():
    rows, memory, mask = pointer_inputs(np.random.default_rng(0))
    theirs = np.asarray(pointer_argmax_batched(
        jnp.asarray(rows), jnp.asarray(memory), jnp.asarray(mask), interpret=True))
    ours = pointer_argmax(torch.as_tensor(rows), torch.as_tensor(memory), torch.as_tensor(mask))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert (ours[0, :3] == 2).all() and (ours[2, :3] == 7).all()


@pytest.mark.parametrize("padding", ["mask", "bias"])
def test_pointer_gather_plain_matches_pallas(padding):
    """K4's last phase alone (the kernel's plain version on the CPU): the
    Pallas pointer argmax's tokens, with the padding as a mask or as the
    step's additive bias, and the winning memory rows gathered."""
    rows, memory, mask = pointer_inputs(np.random.default_rng(0))
    mem16 = torch.as_tensor(memory).to(torch.bfloat16)
    theirs = np.asarray(pointer_argmax_batched(
        jnp.asarray(rows), jnp.asarray(mem16.float().numpy()), jnp.asarray(mask),
        interpret=True))
    kw = ({"padding_mask": torch.as_tensor(mask)} if padding == "mask" else
          {"bias": torch.where(torch.as_tensor(mask), NEG, 0.0).float()})
    tokens, gathered = pointer_argmax_gather(torch.as_tensor(rows), mem16, **kw)
    np.testing.assert_array_equal(tokens.numpy(), theirs)
    assert (tokens[0, :3] == 2).all() and (tokens[2, :3] == 7).all()
    want = np.take_along_axis(mem16.float().numpy(), theirs[..., None].astype(np.int64), 1)
    np.testing.assert_array_equal(gathered.float().numpy(), want)


@pytest.mark.parametrize("epilogue", ["store", "relu", "residual"])
def test_decode_gemm_plain_matches_pallas_epilogues(epilogue):
    """One product of the step alone (the kernel's plain version on the
    CPU) against the Pallas step's own expressions for it: fp32 dot plus
    bias, then `.astype(dtype)`, ReLU before the cast, or the residual add
    `x + (dot + b).astype(dtype)` in the compute type. fp32 exactly as
    computed; bf16 within one rounding (the two fp32 dots may sum in other
    orders)."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((7, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 16)) / 6).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    x = rng.standard_normal((7, 16)).astype(np.float32)
    for dt, jdt, rtol in ((torch.float32, jnp.float32, 1e-6), (torch.bfloat16, jnp.bfloat16,
                                                               2.0 ** -7)):
        aj, wj, xj = (jnp.asarray(v).astype(jdt) for v in (a, w, x))
        dot = jnp.dot(aj, wj, preferred_element_type=jnp.float32) + jnp.asarray(b)
        want = {"store": lambda: dot.astype(jdt),
                "relu": lambda: jnp.maximum(dot, 0.0).astype(jdt),
                "residual": lambda: xj + dot.astype(jdt)}[epilogue]()
        ours = decode_gemm(torch.as_tensor(a).to(dt), torch.as_tensor(w).to(dt),
                           torch.as_tensor(b), epilogue=epilogue,
                           resid=torch.as_tensor(x).to(dt) if epilogue == "residual" else None)
        assert ours.dtype == dt
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=rtol, atol=rtol)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_pallas(causal):
    rng = np.random.default_rng(1)
    n, sq, sk, h, hd = 3, 12, 12, 2, 8
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((n, sq, h, hd), (n, sk, h, hd), (n, sk, h, hd)))
    pad = np.zeros((n, sk), bool)
    pad[1, 9:] = True
    pad[2, 5:] = True
    bias = padding_mask_bias(torch.as_tensor(pad))
    out, lse = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(bias.numpy()), jnp.zeros((1,), jnp.float32),
                               causal, True, 0.0)
    ours, ours_lse = flash_attention_fwd(*(torch.as_tensor(a) for a in (q, k, v)), bias,
                                         causal=causal)
    np.testing.assert_allclose(ours.numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours_lse.numpy(), np.asarray(lse)[:, :sq], rtol=1e-5, atol=1e-5)


def decode_case(tiny_model_cfg, n=2, s=16, t_max=12, step=5, seed=2):
    """A mid-decode state in the port's layout (f = num_lines rows per
    sample; cache positions < step seeded)."""
    rng = np.random.default_rng(seed)
    tree = jax_params(tiny_model_cfg, seed=seed)
    model = port_model(tiny_model_cfg, tree)
    cfg = model.cfg
    f, e = 6, cfg.num_model
    lyr = cfg.num_decoder_layers
    memory = torch.as_tensor(rng.standard_normal((n, s, e)).astype(np.float32))
    pos = torch.as_tensor(rng.standard_normal((1, s, e)).astype(np.float32))
    mask = torch.zeros((n, s), dtype=torch.bool)
    mask[1, 11:] = True
    with torch.no_grad():
        ck, cv = _cross_kv(model, memory, pos, cfg.num_head)
    cache = torch.zeros((lyr, 2, n * f, t_max, e))
    cache[..., :step, :] = torch.as_tensor(
        rng.standard_normal(cache[..., :step, :].shape).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, s, (n, f)))
    x = torch.gather(memory, 1, idx[..., None].expand(-1, -1, e)).reshape(n * f, e)
    inputs = dict(x=x, qpos_t=torch.as_tensor(rng.standard_normal(e).astype(np.float32)),
                  packed=pack_decoder_weights(model, torch.float32),
                  cross_k=ck.reshape(lyr, n, s, e).contiguous(),
                  cross_v=cv.reshape(lyr, n, s, e).contiguous(), memory=memory,
                  mem_bias=torch.where(mask, NEG, 0.0).float(), cache=cache)
    return tree, cfg, inputs, step


def test_decode_step_plain_matches_pallas(tiny_model_cfg):
    tree, cfg, inp, step = decode_case(tiny_model_cfg)
    n, s = inp["mem_bias"].shape
    r, e = inp["x"].shape
    f, lyr, t_max = r // n, cfg.num_decoder_layers, inp["cache"].shape[3]
    blk, t_pad = 2, jds._round_up(t_max, jds.CHUNK)
    nb = n // blk
    # the JAX kernel's layouts: sample blocks of 2, lane-packed K|V cache
    cache_j = np.zeros((lyr, nb, t_pad, blk * f, 2 * e), np.float32)
    c = inp["cache"].numpy()  # (L, 2, R, T, E)
    cache_j[:, :, :t_max] = c.reshape(lyr, 2, nb, blk * f, t_max, e).transpose(
        0, 2, 4, 3, 1, 5).reshape(lyr, nb, t_max, blk * f, 2 * e)
    packed_j = jds.pack_decoder_weights(jax.tree.map(jnp.asarray, tree), jnp.float32)
    x_j, tok_j, cache_out = jds.decode_step(
        jnp.int32(step), jnp.asarray(inp["x"].numpy().reshape(nb, blk * f, e)),
        jnp.asarray(inp["qpos_t"].numpy()[None]), packed_j,
        jnp.asarray(inp["cross_k"].numpy().reshape(lyr, nb, blk, s, e).transpose(1, 2, 0, 3, 4)),
        jnp.asarray(inp["cross_v"].numpy().reshape(lyr, nb, blk, s, e).transpose(1, 2, 0, 3, 4)),
        jnp.asarray(inp["memory"].numpy().reshape(nb, blk, s, e)),
        jnp.asarray(inp["mem_bias"].numpy().reshape(nb, blk, 1, s)), jnp.asarray(cache_j),
        num_head=cfg.num_head, num_layers=lyr, interpret=True)

    pointer = torch.full((r, e), float("nan"))
    x_next, tokens = decode_step(step, **inp, num_head=cfg.num_head, pointer_out=pointer)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(tok_j).reshape(n, f))
    # the pointer vectors are what the argmax read
    logits = torch.einsum("nfe,nse->nfs", pointer.reshape(n, f, e), inp["memory"])
    assert torch.equal((logits + inp["mem_bias"][:, None]).argmax(-1).to(torch.int32), tokens)
    with pytest.raises(ValueError):
        decode_step(step, **{**inp, "cache": inp["cache"].clone()}, num_head=cfg.num_head,
                    pointer_out=pointer[:, :-1])
    np.testing.assert_allclose(x_next.numpy(), np.asarray(x_j).reshape(r, e), rtol=1e-5,
                               atol=1e-5)
    slot = np.asarray(cache_out)[:, :, step].reshape(lyr, nb, blk * f, 2, e)
    slot = slot.transpose(0, 3, 1, 2, 4).reshape(lyr, 2, r, e)
    np.testing.assert_allclose(inp["cache"][:, :, :, step].numpy(), slot, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(inp["cache"][:, :, :, :step].numpy(), c[:, :, :, :step])


def test_wrappers_reject_bad_input():
    rows, memory, mask = (torch.as_tensor(a) for a in pointer_inputs(np.random.default_rng(0)))
    with pytest.raises(ValueError):
        pointer_argmax(rows, memory[:, :, :-1].contiguous(), mask)
    with pytest.raises(ValueError):
        pointer_argmax(rows.double(), memory.double(), mask)
    with pytest.raises(ValueError):
        pointer_argmax(rows, memory, mask, impl="fast")
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q, torch.zeros((1, 5)))


def test_test_entries_reject_bad_input():
    rows, memory, mask = (torch.as_tensor(a) for a in pointer_inputs(np.random.default_rng(0)))
    with pytest.raises(ValueError):  # memory must be bf16
        pointer_argmax_gather(rows, memory, mask)
    with pytest.raises(ValueError):
        pointer_argmax_gather(rows, memory.bfloat16(), bias=torch.zeros(3, 5))
    a, w, b = torch.zeros((4, 8)), torch.zeros((8, 6)), torch.zeros(6)
    with pytest.raises(ValueError):
        decode_gemm(a, w, b, epilogue="gelu")
    with pytest.raises(ValueError):  # residual needs resid, and only it
        decode_gemm(a, w, b, epilogue="residual")
    with pytest.raises(ValueError):
        decode_gemm(a, w, b, resid=torch.zeros((4, 6)))
    with pytest.raises(ValueError):
        decode_gemm(a, w[:, :5], b)
