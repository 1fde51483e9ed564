"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version, and the fused engine's grids against the causal_cache engine's.

This file imports nothing of JAX or of the JAX package, so it also runs on
a machine that has only PyTorch (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Without a card every test skips (decided in the ``cuda_device`` fixture).
"""

import numpy as np
import pytest
import torch

from faceformer_tpu_torch import ops
from faceformer_tpu_torch.config import ModelConfig, config_from_dict
from faceformer_tpu_torch.decode import NEG, _cross_kv, greedy_decode_parallel
from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel
from faceformer_tpu_torch.ops.decode_step import (
    decode_gemm,
    decode_gemm_plain,
    decode_step,
    pack_decoder_weights,
)
from faceformer_tpu_torch.ops.flash import (
    flash_attention_bwd,
    flash_attention_fwd,
    keep_mask_on_card,
    padding_mask_bias,
    philox_keep_mask,
)
from faceformer_tpu_torch.ops.pointer import pointer_argmax, pointer_argmax_gather
from faceformer_tpu_torch.params import jitter_affine_
from faceformer_tpu_torch.train.step import make_optimizer, train_step

pytestmark = pytest.mark.gpu

# small, but wide enough for the tensor-core GEMM tiles (K % 32, N % 8)
CFG = ModelConfig(num_points_per_line=8, num_lines=40, max_face_length=12, num_model=128,
                  num_head=2, num_feedforward=256, num_encoder_layers=2,
                  num_decoder_layers=2, dropout=0.0)


@pytest.fixture
def cuda_device():
    """The card; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def launched(name, fn, *args, **kwargs):
    before = ops.LAUNCHES[name]
    out = fn(*args, **kwargs)
    assert ops.LAUNCHES[name] == before + 1, f"{name} did not launch its kernel"
    return out


# (n, r, s, e): row counts off the kernel's 16- and 32-row blocks; memory
# lengths of one row, off the 128- and 256-row tiles, the serving length and
# past one 256-row tile; embedding widths of 64, 256, 512 and 1,024 (one to
# sixteen 64-column boxes)
POINTER_SHAPES = [(4, 70, 90, 64), (3, 45, 1, 256), (3, 45, 17, 512), (20, 216, 220, 512),
                  (2, 100, 300, 256), (2, 40, 70, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,r,s,e", POINTER_SHAPES)
def test_pointer_kernel_on_card(cuda_device, dtype, n, r, s, e):
    """K1 against its plain version (fp32 indices exact, bf16 where the
    top-two gap is clear), constructed exact ties to the first index, and
    the same kernel as K4's last phase: fp32 or bf16 rows on bf16 memory
    with the padding as an additive bias, and the fused gather."""
    rng = np.random.default_rng(3)
    rows = torch.as_tensor(rng.standard_normal((n, r, e)), dtype=torch.float32)
    memory = torch.as_tensor(rng.standard_normal((n, s, e)), dtype=torch.float32)
    ties = s > 9
    if ties:  # memory rows 5 and 9 equal, and rows aimed at them
        memory[:, 9] = memory[:, 5]
        rows[:, :6] = 2 * memory[:, 5:6]
    mask = torch.as_tensor(np.arange(s)[None] >= rng.integers(min(10, s), s + 1, (n, 1)))
    rows, memory, mask = (t.to(cuda_device) for t in (rows.to(dtype), memory.to(dtype), mask))

    def clear_gap(rows, memory, bias):
        logits = torch.einsum("nre,nse->nrs", rows.float(), memory.float()) + bias[:, None]
        if s == 1:
            return torch.ones(logits.shape[:2], dtype=torch.bool, device=cuda_device)
        top2 = logits.topk(2, dim=-1).values
        return (top2[..., 0] - top2[..., 1]) > 1e-3

    bias = torch.where(mask, NEG, 0.0).float()
    got = launched("pointer_argmax", pointer_argmax, rows, memory, mask)
    want = pointer_argmax(rows, memory, mask, impl="plain")
    if ties:
        assert (got[:, :6] == 5).all()
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        assert not ((got != want) & clear_gap(rows, memory, bias)).any()

    mem16 = memory.to(torch.bfloat16)
    tok, gathered = launched("pointer_argmax_gather", pointer_argmax_gather, rows, mem16,
                             bias=bias)
    tok_p, _ = pointer_argmax_gather(rows, mem16, bias=bias, impl="plain")
    assert torch.equal(gathered, torch.gather(mem16, 1, tok.long()[..., None].expand(-1, -1, e)))
    if ties:
        assert (tok[:, :6] == 5).all()
    assert not ((tok != tok_p) & clear_gap(rows, mem16, bias)).any()


# (n, sq, sk, causal, hd). The tensor-core kernel (bf16, hd = 64, Sk <= 256)
# walks pairs when Sq <= 64 and query tiles otherwise: few pairs on many
# tiles (splits > 1, a ragged last tile), key lengths of one key, off the
# 16-key grid and the largest; hd = 32 (d = 256 over 8 heads, as in
# configs/step-native.yml) runs the CUDA-core kernel in both dtypes.
FWD_SHAPES = [(3, 50, 50, False, 64), (3, 50, 50, True, 64), (200, 12, 12, False, 64),
              (2, 300, 90, False, 64), (1, 1000, 220, False, 64), (2, 3000, 220, False, 64),
              (3, 50, 1, False, 64), (3, 100, 17, True, 64), (2, 300, 256, False, 64),
              (3, 50, 50, False, 32), (2, 300, 90, True, 32)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,sq,sk,causal,hd", FWD_SHAPES)
def test_flash_kernel_on_card(cuda_device, dtype, tol, n, sq, sk, causal, hd):
    """K2 against its plain version, and bitwise repeatable without dropout."""
    rng = np.random.default_rng(4)
    h = 8 if hd == 32 else 4
    q = torch.as_tensor(rng.standard_normal((n, sq, h, hd)), dtype=dtype, device=cuda_device)
    k, v = (torch.as_tensor(rng.standard_normal((n, sk, h, hd)), dtype=dtype,
                            device=cuda_device) for _ in range(2))
    valid = torch.as_tensor(rng.integers(1, sk + 1, (n, 1)), device=cuda_device)
    bias = padding_mask_bias(torch.arange(sk, device=cuda_device)[None] >= valid)
    out, lse = launched("flash_fwd", flash_attention_fwd, q, k, v, bias, causal=causal)
    out_p, lse_p = flash_attention_fwd(q, k, v, bias, causal=causal, impl="plain")
    assert float((out.float() - out_p.float()).abs().max()) <= tol
    assert float((lse - lse_p).abs().max()) <= tol
    again, lse_again = flash_attention_fwd(q, k, v, bias, causal=causal)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)


def flash_case(dev, dtype, n, sq, sk, seed=7, h=4, hd=64):
    rng = np.random.default_rng(seed)
    q, do = (torch.as_tensor(rng.standard_normal((n, sq, h, hd)), dtype=dtype, device=dev)
             for _ in range(2))
    k, v = (torch.as_tensor(rng.standard_normal((n, sk, h, hd)), dtype=dtype, device=dev)
            for _ in range(2))
    valid = torch.as_tensor(rng.integers(max(1, sk // 2), sk + 1, (n, 1)), device=dev)
    bias = padding_mask_bias(torch.arange(sk, device=dev)[None] >= valid)
    return q, k, v, bias, do


def rel_err(got, want):
    """Largest error relative to the reference tensor's largest magnitude."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


# the three training regimes, small and at the full `ours` width (8 heads
# of 64; a few sequences each): short causal decoder rows, the encoder, and
# the anchor-folded cross-attention; then the backward's tiling edges: a
# query length that leaves the ring a partial last tile against a key
# length off the 16-key grid, the largest key side, and short causal rows
# off both grids
FLASH_SHAPES = [(200, 12, 12, True), (3, 50, 50, False), (2, 300, 90, False),
                (64, 40, 40, True), (2, 220, 220, False), (1, 8640, 220, False),
                (3, 1000, 37, False), (2, 4099, 256, False), (64, 37, 37, True)]


def test_keep_mask_on_card_equals_plain(cuda_device):
    for seed, shape in ((5, (3, 4, 40, 40)), (2 ** 40 + 17, (2, 8, 220, 218))):
        got = keep_mask_on_card(seed, *shape, 0.2, cuda_device)
        want = philox_keep_mask(seed, *shape, 0.2, device=cuda_device)
        assert torch.equal(got, want)
        assert torch.equal(want.cpu(), philox_keep_mask(seed, *shape, 0.2))
        assert abs(float(got.float().mean()) - 0.8) < 0.01


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,sq,sk,causal", FLASH_SHAPES)
def test_flash_dropout_kernel_on_card(cuda_device, dtype, tol, n, sq, sk, causal):
    """K2 with in-kernel dropout against its plain version (same Philox
    mask), and the mask the kernel applied read back through a one-hot v."""
    h = 8 if sq >= 40 else 4
    q, k, v, bias, _ = flash_case(cuda_device, dtype, n, sq, sk, h=h)
    out, lse = launched("flash_fwd", flash_attention_fwd, q, k, v, bias, causal=causal,
                        dropout_rate=0.2, seed=31)
    out_p, lse_p = flash_attention_fwd(q, k, v, bias, causal=causal, impl="plain",
                                       dropout_rate=0.2, seed=31)
    assert float((out.float() - out_p.float()).abs().max()) <= tol
    assert float((lse - lse_p).abs().max()) <= tol
    again, _ = flash_attention_fwd(q, k, v, bias, causal=causal, dropout_rate=0.2, seed=31)
    other, _ = flash_attention_fwd(q, k, v, bias, causal=causal, dropout_rate=0.2, seed=32)
    assert torch.equal(out, again) and not torch.equal(out, other)
    # v = one-hot of the key index inside a 64-key window: out[i, d] is then
    # p_used[i, window + d], which is 0 exactly where the kernel dropped it
    keep = philox_keep_mask(31, n, h, sq, sk, 0.2, device=cuda_device)
    live = (bias == 0)[:, None, None, :].expand(n, h, sq, sk).clone()
    if causal:
        live &= ~torch.ones((sq, sk), dtype=torch.bool, device=cuda_device).triu(1)
    for w0 in range(0, sk, 64):
        width = min(64, sk - w0)
        v1 = torch.zeros_like(v)
        idx = torch.arange(width, device=cuda_device)
        v1[:, w0 + idx, :, idx] = 1.0
        p_used = flash_attention_fwd(q, k, v1, bias, causal=causal, dropout_rate=0.2,
                                     seed=31)[0][..., :width].permute(0, 2, 1, 3)
        window = slice(w0, w0 + width)
        assert torch.equal((p_used != 0) & live[..., window], keep[..., window] & live[..., window])


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n,sq,sk,causal", FLASH_SHAPES)
def test_flash_bwd_kernel_on_card(cuda_device, dtype, tol, rate, n, sq, sk, causal):
    """K3 against its plain version: dq, dk, dv relative to each tensor's
    largest magnitude, bitwise repeatable, and sensitive to the seed."""
    h = 8 if sq >= 40 else 4
    q, k, v, bias, do = flash_case(cuda_device, dtype, n, sq, sk, h=h)
    _, lse = flash_attention_fwd(q, k, v, bias, causal=causal, impl="plain", dropout_rate=rate,
                                 seed=9)
    kw = dict(causal=causal, dropout_rate=rate, seed=9)
    got = launched("flash_bwd", flash_attention_bwd, q, k, v, bias, lse, do, **kw)
    want = flash_attention_bwd(q, k, v, bias, lse, do, impl="plain", **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a.float()).all(), name
        assert rel_err(a, b) <= tol, (name, rel_err(a, b))
    again = flash_attention_bwd(q, k, v, bias, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if rate:
        other = flash_attention_bwd(q, k, v, bias, lse, do, causal=causal, dropout_rate=rate,
                                    seed=10)
        assert not torch.equal(got[2], other[2])


def decode_state(dev, dtype, n=3, step=5, seed=2, cfg=CFG):
    """A mid-decode state from a seeded model (biases and LayerNorms
    jittered off their init values): cache positions < step set."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    model = SurfaceFormerParallel(cfg, generator=gen, device=dev)
    jitter_affine_(model, gen)
    f, e, s, lyr = cfg.num_lines, cfg.num_model, cfg.num_lines + 4, cfg.num_decoder_layers
    memory = torch.as_tensor(rng.standard_normal((n, s, e)), dtype=dtype, device=dev)
    mask = torch.as_tensor(np.arange(s)[None] >= rng.integers(10, s + 1, (n, 1)), device=dev)
    with torch.no_grad():
        ck, cv = _cross_kv(model, memory, model.pos_table[None, :s].to(dtype), cfg.num_head)
    cache = torch.zeros((lyr, 2, n * f, cfg.max_face_length, e), dtype=dtype, device=dev)
    cache[..., :step, :] = torch.as_tensor(rng.standard_normal(cache[..., :step, :].shape),
                                           dtype=dtype, device=dev)
    idx = torch.as_tensor(rng.integers(0, s, (n, f)), device=dev)
    x = torch.gather(memory, 1, idx[..., None].expand(-1, -1, e)).reshape(n * f, e)
    return model, dict(x=x.contiguous(), qpos_t=model.query_pos_table[step].to(dtype),
                       packed=pack_decoder_weights(model, dtype),
                       cross_k=ck.reshape(lyr, n, s, e).contiguous(),
                       cross_v=cv.reshape(lyr, n, s, e).contiguous(), memory=memory,
                       mem_bias=torch.where(mask, NEG, 0.0).float(), cache=cache)


# d = 256 over 8 heads (hd = 32), the dims of configs/step-native.yml, with
# 37 lines: 111 anchor rows at n = 3, off every GEMM block tile
CFG_HD32 = ModelConfig(num_points_per_line=8, num_lines=37, max_face_length=12, num_model=256,
                       num_head=8, num_feedforward=512, num_encoder_layers=2,
                       num_decoder_layers=2, dropout=0.0)
STEP_CASES = [(cfg, step) for cfg in (CFG, CFG_HD32) for step in (0, 5, CFG.max_face_length - 2)]


@pytest.mark.parametrize("cfg,step", STEP_CASES, ids=[f"d{c.num_model}-h{c.num_head}-step{t}"
                                                      for c, t in STEP_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_step_kernel_on_card(cuda_device, dtype, cfg, step):
    _, inp = decode_state(cuda_device, dtype, step=step, cfg=cfg)
    cache_p = inp["cache"].clone()
    ptr_k, ptr_p = (torch.empty(inp["x"].shape, device=cuda_device) for _ in range(2))
    x_k, tok_k = launched("decode_step", decode_step, step, **inp, num_head=cfg.num_head,
                          pointer_out=ptr_k)
    _, tok_p = decode_step(step, **{**inp, "cache": cache_p}, num_head=cfg.num_head,
                           impl="plain", pointer_out=ptr_p)
    n, e = inp["mem_bias"].shape[0], cfg.num_model
    x_own = torch.gather(inp["memory"], 1, tok_k.long()[..., None].expand(-1, -1, e))
    assert torch.equal(x_k, x_own.reshape(-1, e))  # x_next gathers the kernel's tokens
    assert torch.equal(inp["cache"][:, :, :, :step], cache_p[:, :, :, :step])
    slot = (inp["cache"][:, :, :, step].float() - cache_p[:, :, :, step].float()).abs()
    d_ptr = (ptr_k - ptr_p).abs()
    if dtype == torch.float32:
        assert torch.equal(tok_k, tok_p)
        assert float(slot.max()) <= 1e-4
        assert float(d_ptr.max()) <= 1e-4
    else:
        # bf16, with chip_smoke.py's gates: tokens agree wherever the plain
        # top-two gap is clear; the largest and mean errors of the slot and
        # of the pointer vectors are bounded
        logits = torch.einsum("nfe,nse->nfs", ptr_p.reshape(n, -1, e),
                              inp["memory"].float()) + inp["mem_bias"][:, None, :]
        top2 = logits.topk(2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1]) / top2[..., 0].abs()
        assert not bool(((tok_k != tok_p) & (gap > 2e-2)).any())
        assert float(slot.max()) <= 0.0625
        assert float(slot.mean(dim=(2, 3)).max()) <= 5e-3
        assert float(d_ptr.max()) <= 0.1
        assert float(d_ptr.mean()) <= 5e-3


# the step's products alone: (a dtype, w dtype, epilogue, out dtype) as the
# step runs them, at row counts off the 192-row block tile and k extents off
# the 64-deep k tile
GEMM_TYPES = [(torch.bfloat16, torch.bfloat16, "store", torch.bfloat16),
              (torch.bfloat16, torch.bfloat16, "relu", torch.bfloat16),
              (torch.bfloat16, torch.bfloat16, "residual", torch.bfloat16),
              (torch.bfloat16, torch.bfloat16, "store", torch.float32),
              (torch.float32, torch.bfloat16, "residual", torch.bfloat16),
              (torch.float32, torch.float32, "residual", torch.float32)]


@pytest.mark.parametrize("m,n,k", [(111, 256, 96), (200, 128, 512), (4320, 512, 1024)])
@pytest.mark.parametrize("a_dtype,w_dtype,epilogue,out_dtype", GEMM_TYPES)
def test_decode_gemm_on_card(cuda_device, a_dtype, w_dtype, epilogue, out_dtype, m, n, k):
    """K4's GEMM against its plain version, each epilogue: within a rounding
    of the output type (fp32 sums in another order flip bf16 roundings)."""
    rng = np.random.default_rng(m + n + k)
    a = torch.as_tensor(rng.standard_normal((m, k)), dtype=a_dtype, device=cuda_device)
    w = torch.as_tensor(rng.standard_normal((k, n)) / np.sqrt(k), dtype=w_dtype,
                        device=cuda_device)
    bias = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=cuda_device)
    resid = (torch.as_tensor(rng.standard_normal((m, n)), dtype=out_dtype, device=cuda_device)
             if epilogue == "residual" else None)
    got = launched("decode_gemm", decode_gemm, a, w, bias, epilogue=epilogue, resid=resid,
                   out_dtype=out_dtype)
    want = decode_gemm_plain(a, w, bias, epilogue, resid, out_dtype)
    assert got.dtype == want.dtype and got.shape == (m, n)
    # bf16: two roundings of the largest magnitude at most; fp32: 1e-5 of it
    tol = (2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5) * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol
    if epilogue == "relu":
        assert float(got.float().min()) >= 0.0


def test_fused_grids_equal_causal_cache_on_card(cuda_device):
    model, _ = decode_state(cuda_device, torch.float32)
    rng = np.random.default_rng(6)
    n, lines = 3, CFG.num_lines
    num = rng.integers(10, lines + 1, n)
    batch = {"input": torch.as_tensor(rng.uniform(-1, 1, (n, lines, CFG.num_points_per_line, 2)),
                                      dtype=torch.float32, device=cuda_device),
             "input_mask": torch.as_tensor(np.arange(lines)[None] >= num[:, None],
                                           device=cuda_device),
             "num_input": torch.as_tensor(num, device=cuda_device)}
    ops.reset_launches()
    fused = greedy_decode_parallel(model, CFG, batch, mode="fused", early_stop=False)["predict"]
    assert ops.LAUNCHES["decode_step"] == CFG.max_face_length - 1
    cached = greedy_decode_parallel(model, CFG, batch, mode="causal_cache",
                                    early_stop=False)["predict"]
    assert ops.LAUNCHES["pointer_argmax"] == CFG.max_face_length - 1
    assert torch.equal(fused, cached)


def train_case(dev, dropout, n=3, seed=11):
    """A seeded model and a batch with well-formed labels: every row starts
    with a token and ends with a face-type token, then PAD."""
    cfg = config_from_dict({"trainer": {"precision": "fp32", "lr": 1e-3}})
    import dataclasses

    cfg = dataclasses.replace(cfg, model=dataclasses.replace(CFG, dropout=dropout))
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    model = SurfaceFormerParallel(cfg.model, generator=gen, device=dev)
    jitter_affine_(model, gen)
    lines, t = CFG.num_lines, CFG.max_face_length
    num = rng.integers(10, lines + 1, n)
    label = np.zeros((n, lines, t), np.int32)
    for i in range(n):
        for f in range(lines):
            size = int(rng.integers(3, t - 1))
            label[i, f, :size] = rng.integers(4, 4 + num[i], size)
            label[i, f, size] = rng.integers(1, 4)
    batch = {"input": rng.uniform(-1, 1, (n, lines, CFG.num_points_per_line, 2)).astype(np.float32),
             "input_mask": np.arange(lines)[None] >= num[:, None],
             "label": label, "label_mask": label == 0}
    return cfg, model, {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_train_step_kernels_equal_plain_on_card(cuda_device, dropout):
    """One whole train_step through the flash kernels against the same step
    through their plain versions, fp32: the launch counts, the loss and
    every gradient (Adam's normalised update would turn rounding noise in
    near-zero gradients into parameter differences, so parameters are not
    compared)."""
    results = {}
    for impl in ("auto", "plain"):
        cfg, model, batch = train_case(cuda_device, dropout)
        optimizer = make_optimizer(model, cfg.trainer)
        gen = torch.Generator().manual_seed(3) if dropout else None
        ops.reset_launches()
        loss, acc = train_step(model, optimizer, batch, gen, cfg, impl=impl)
        calls = CFG.num_encoder_layers + 2 * CFG.num_decoder_layers
        want = (calls, calls) if impl == "auto" else (0, 0)
        assert (ops.LAUNCHES["flash_fwd"], ops.LAUNCHES["flash_bwd"]) == want
        results[impl] = (loss, {k: p.grad.clone() for k, p in model.named_parameters()})
    (loss_k, grads_k), (loss_p, grads_p) = results["auto"], results["plain"]
    assert torch.isfinite(loss_k) and abs(float(loss_k) - float(loss_p)) <= 1e-5
    for name, g in grads_p.items():
        if name.endswith("attn.k.bias"):
            # the softmax ignores a key bias: its gradient is rounding noise
            assert float(grads_k[name].abs().max()) <= 1e-5 and float(g.abs().max()) <= 1e-5
        else:
            assert rel_err(grads_k[name], g) <= 1e-3, name
