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
from faceformer_tpu_torch.config import ModelConfig, TokenConfig, config_from_dict
from faceformer_tpu_torch.decode import (
    NEG,
    _cross_kv,
    greedy_decode_parallel,
    greedy_decode_single,
)
from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel
from faceformer_tpu_torch.models.surfaceformer import SurfaceFormer
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
    key_tile,
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
# sixteen 64-column boxes); the flat model's step: one row a sample against
# 116 memory rows (configs/synthetic-dirtok-big.yml), 31 rows of each block
# empty and the memory off the TMA box
POINTER_SHAPES = [(4, 70, 90, 64), (3, 45, 1, 256), (3, 45, 17, 512), (20, 216, 220, 512),
                  (2, 100, 300, 256), (2, 40, 70, 1024), (32, 1, 116, 512)]


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


def flash_case(dev, dtype, n, sq, sk, seed=7, h=4, hd=64, dead=0):
    """(q, k, v, bias, do): inputs from a seeded rng and a ragged key-padding
    bias; the last ``dead`` samples have every key padded."""
    rng = np.random.default_rng(seed)
    q, do = (torch.as_tensor(rng.standard_normal((n, sq, h, hd)), dtype=dtype, device=dev)
             for _ in range(2))
    k, v = (torch.as_tensor(rng.standard_normal((n, sk, h, hd)), dtype=dtype, device=dev)
            for _ in range(2))
    valid = torch.as_tensor(rng.integers(max(1, sk // 2), sk + 1, (n, 1)), device=dev)
    if dead:
        valid[n - dead:] = 0
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


def test_keep_mask_on_card_at_a_head_offset(cuda_device):
    """The keep mask of heads 4..7 (a tensor-parallel rank's at model axis
    2 of 8 heads) equals philox_keep_mask's at that offset and heads 4..7
    of the whole mask, bit for bit."""
    shape = (2, 4, 220, 218)
    got = keep_mask_on_card(11, *shape, 0.2, cuda_device, head0=4)
    assert torch.equal(got, philox_keep_mask(11, *shape, 0.2, device=cuda_device, head0=4))
    whole = keep_mask_on_card(11, 2, 8, 220, 218, 0.2, cuda_device)
    assert torch.equal(got, whole[:, 4:]) and not torch.equal(got, whole[:, :4])


# (n, sq, sk, causal) of the training calls a tensor-parallel rank makes on
# its 4 of 8 heads: the causal decoder self-attention, the encoder, the
# anchor-folded cross-attention, and 512 causal keys (bf16: K2's and K3's
# tensor-core key-tiled kernels)
HEAD_OFFSET_SHAPES = [(16, 40, 40, True), (2, 220, 220, False), (1, 8640, 220, False),
                      (2, 512, 512, True)]


@pytest.mark.parametrize("dtype,tol_fwd,tol_bwd",
                         [(torch.float32, 1e-4, 1e-4), (torch.bfloat16, 2e-2, 3e-2)])
@pytest.mark.parametrize("n,sq,sk,causal", HEAD_OFFSET_SHAPES)
def test_flash_kernels_at_a_head_offset_on_card(cuda_device, dtype, tol_fwd, tol_bwd, n, sq,
                                                sk, causal):
    """K2 and K3 with dropout on heads 4..7 of 8 (head0 = 4) against their
    plain versions at that offset, and against heads 4..7 of the call on
    all 8 heads: the rank applies the whole call's keep mask."""
    q, k, v, bias, do = flash_case(cuda_device, dtype, n, sq, sk, h=8)
    half = [t[:, :, 4:].contiguous() for t in (q, k, v, do)]
    kw = dict(causal=causal, dropout_rate=0.2, seed=41)
    out, lse = launched("flash_fwd", flash_attention_fwd, *half[:3], bias, head0=4, **kw)
    out_p, lse_p = flash_attention_fwd(*half[:3], bias, impl="plain", head0=4, **kw)
    whole, _ = flash_attention_fwd(q, k, v, bias, **kw)
    assert float((out.float() - out_p.float()).abs().max()) <= tol_fwd
    assert float((lse - lse_p).abs().max()) <= tol_fwd
    assert float((out.float() - whole[:, :, 4:].float()).abs().max()) <= tol_fwd
    unshifted, _ = flash_attention_fwd(*half[:3], bias, **kw)
    assert not torch.equal(out, unshifted)
    got = launched("flash_bwd", flash_attention_bwd, *half[:3], bias, lse_p, half[3], head0=4,
                   **kw)
    want = flash_attention_bwd(*half[:3], bias, lse_p, half[3], impl="plain", head0=4, **kw)
    _, lse_w = flash_attention_fwd(q, k, v, bias, impl="plain", **kw)
    grads_w = flash_attention_bwd(q, k, v, bias, lse_w, do, **kw)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, grads_w):
        assert rel_err(a, b) <= tol_bwd, (name, rel_err(a, b))
        assert rel_err(a, c[:, :, 4:].contiguous()) <= tol_bwd, name


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
    check_flash_bwd(cuda_device, dtype, tol, rate, n, sq, sk, causal,
                    h=8 if sq >= 40 else 4, hd=64)


# K3 at hd = 32 (d = 256 over 8 heads, configs/step-native.yml: L = 160,
# T = 32), which runs the CUDA-core kernels in both dtypes: the causal
# decoder rows, the encoder, the anchor-folded cross-attention, and a
# ragged case off the 16-key grid
FLASH_SHAPES_HD32 = [(64, 32, 32, True), (2, 164, 164, False), (1, 5120, 164, False),
                     (3, 50, 37, False)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n,sq,sk,causal", FLASH_SHAPES_HD32)
def test_flash_bwd_kernel_on_card_hd32(cuda_device, dtype, tol, rate, n, sq, sk, causal):
    """K3 at hd = 32 against its plain version, as at hd = 64."""
    check_flash_bwd(cuda_device, dtype, tol, rate, n, sq, sk, causal, h=8, hd=32)


def check_flash_bwd(cuda_device, dtype, tol, rate, n, sq, sk, causal, h, hd):
    q, k, v, bias, do = flash_case(cuda_device, dtype, n, sq, sk, h=h, hd=hd)
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


# Key sides past the whole-row kernels' reach, which run the key-tiled
# kernels (n, sq, sk, causal, hd, samples whose keys are all padded): the
# flat model's causal decoder self-attention at label_seq_length 512, a
# ragged non-causal 1,000 keys off the 128-key tile, and at hd = 32 1,500
# causal keys and 1,000 non-causal ones; then one key past the whole-row
# tensor-core kernel's 256 (a ragged last 64-key tile), 320 non-causal
# keys, the reference engine's prefixes (1 and 37 queries against 512
# keys), the JAX kernel's reach (2,000 causal keys) and a sample whose keys
# are all padded. (fwd, bwd) say which tiled: every K2 call past 256 keys
# at hd = 64 (bf16 on the tensor-core tiled kernel), at hd = 32 past its
# whole-row kernels' shared memory (fp32 ~890 keys, bf16 1,411); K3 in
# bf16 at hd = 64 past 256 keys (the tensor-core key-tiled pair), else
# K3's dq past its shared memory (391 keys at hd = 64, 702 at hd = 32).
LONG_KEY_SHAPES = [((2, 512, 512, True, 64, 0), {"fp32": (1, 1), "bf16": (1, 1)}),
                   ((2, 300, 1000, False, 64, 0), {"fp32": (1, 1), "bf16": (1, 1)}),
                   ((1, 1500, 1500, True, 32, 0), {"fp32": (1, 1), "bf16": (1, 1)}),
                   ((2, 200, 1000, False, 32, 0), {"fp32": (1, 1), "bf16": (0, 1)}),
                   ((2, 257, 257, True, 64, 0), {"fp32": (1, 0), "bf16": (1, 1)}),
                   ((2, 300, 320, False, 64, 0), {"fp32": (1, 0), "bf16": (1, 1)}),
                   ((4, 1, 512, False, 64, 0), {"fp32": (1, 1), "bf16": (1, 1)}),
                   ((4, 37, 512, False, 64, 0), {"fp32": (1, 1), "bf16": (1, 1)}),
                   ((1, 2000, 2000, True, 64, 0), {"fp32": (1, 1), "bf16": (1, 1)}),
                   ((3, 100, 384, False, 64, 1), {"fp32": (1, 0), "bf16": (1, 1)})]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype,tol_fwd,tol_bwd",
                         [(torch.float32, 1e-4, 1e-4), (torch.bfloat16, 2e-2, 3e-2)])
@pytest.mark.parametrize("shape,tiled", LONG_KEY_SHAPES,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}-{'causal' if s[3] else 'full'}-hd{s[4]}"
                              + (f"-dead{s[5]}" if s[5] else "") for s, _ in LONG_KEY_SHAPES])
def test_flash_long_keys_on_card(cuda_device, dtype, tol_fwd, tol_bwd, rate, shape, tiled):
    """K2 and K3 past the whole-row kernels' reach against their plain
    versions, the keep mask the forward applied read back through a one-hot
    v (bit for bit), and both bitwise repeatable."""
    n, sq, sk, causal, hd, dead = shape
    h = 2
    key = "fp32" if dtype == torch.float32 else "bf16"
    assert (bool(key_tile("fwd", dtype, sk, hd)), bool(key_tile("bwd", dtype, sk, hd))) == \
        tuple(map(bool, tiled[key]))
    tiled_tc = key == "bf16" and hd == 64
    if tiled_tc:
        assert key_tile("fwd", dtype, sk, hd) == 64  # the tensor-core tiled kernel
        assert key_tile("bwd", dtype, sk, hd) == 64  # the tensor-core tiled pair
    q, k, v, bias, do = flash_case(cuda_device, dtype, n, sq, sk, h=h, hd=hd, dead=dead)
    kw = dict(causal=causal, dropout_rate=rate, seed=21)
    out, lse = launched("flash_fwd", flash_attention_fwd, q, k, v, bias, **kw)
    out_p, lse_p = flash_attention_fwd(q, k, v, bias, impl="plain", **kw)
    assert float((out.float() - out_p.float()).abs().max()) <= tol_fwd
    assert float((lse - lse_p).abs().max()) <= tol_fwd
    again = flash_attention_fwd(q, k, v, bias, **kw)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    if rate:
        keep = philox_keep_mask(21, n, h, sq, sk, rate, device=cuda_device)
        live = (bias == 0)[:, None, None, :].expand(n, h, sq, sk).clone()
        if causal:
            live &= ~torch.ones((sq, sk), dtype=torch.bool, device=cuda_device).triu(1)
        for w0 in range(0, sk, hd):
            width = min(hd, sk - w0)
            v1 = torch.zeros_like(v)
            idx = torch.arange(width, device=cuda_device)
            v1[:, w0 + idx, :, idx] = 1.0
            p_used = flash_attention_fwd(q, k, v1, bias, **kw)[0][..., :width].permute(0, 2, 1, 3)
            window = slice(w0, w0 + width)
            assert torch.equal((p_used != 0) & live[..., window],
                               keep[..., window] & live[..., window])
    before = ops.LAUNCHES["flash_bwd_tiled_tc"]
    got = launched("flash_bwd", flash_attention_bwd, q, k, v, bias, lse_p, do, **kw)
    assert ops.LAUNCHES["flash_bwd_tiled_tc"] == before + tiled_tc
    want = flash_attention_bwd(q, k, v, bias, lse_p, do, impl="plain", **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a.float()).all(), name
        assert rel_err(a, b) <= tol_bwd, (name, rel_err(a, b))
    again = flash_attention_bwd(q, k, v, bias, lse_p, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd,sk", [(64, 300), (32, 1500)])
def test_flash_fwd_masked_rows_causal_on_card(cuda_device, dtype, tol, rate, hd, sk):
    """K2's key-tiled kernels under the causal mask where rows have every
    key masked: a sample whose keys are all padded, and one whose first 70
    keys are, so its first 70 rows see no live key. Such a row spreads p
    over all its keys, as the plain version's does, though the tiles past
    the diagonal are skipped for the other rows."""
    q, k, v, bias, _ = flash_case(cuda_device, dtype, 3, 300, sk, h=2, hd=hd, dead=1)
    bias[0, :70] = NEG
    kw = dict(causal=True, dropout_rate=rate, seed=5)
    assert key_tile("fwd", dtype, sk, hd)
    out, lse = launched("flash_fwd", flash_attention_fwd, q, k, v, bias, **kw)
    out_p, lse_p = flash_attention_fwd(q, k, v, bias, impl="plain", **kw)
    assert float((out.float() - out_p.float()).abs().max()) <= tol
    assert float((lse - lse_p).abs().max()) <= tol


# (hd, Sk): every K3 route under the causal mask with rows that see no live
# key, and the dq tile each takes ({"fp32": ..., "bf16": ...}; 0 = whole
# row): the whole-row tensor-core dq and dk/dv (bf16, 200 keys), the
# tensor-core key-tiled pair (bf16, 300 and 600), the CUDA-core whole-row
# and key-tiled dq with the CUDA-core dk/dv (fp32 at 300 and 600; hd = 32
# at 1,500 in both dtypes)
MASKED_ROW_SHAPES = [((64, 200), {"fp32": 0, "bf16": 0}), ((64, 300), {"fp32": 0, "bf16": 64}),
                     ((64, 600), {"fp32": 128, "bf16": 64}),
                     ((32, 1500), {"fp32": 128, "bf16": 128})]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape,tile", MASKED_ROW_SHAPES,
                         ids=[f"hd{s[0]}-sk{s[1]}" for s, _ in MASKED_ROW_SHAPES])
def test_flash_bwd_masked_rows_causal_on_card(cuda_device, dtype, tol, rate, shape, tile):
    """K3 under the causal mask where rows have every key up to their own
    masked: a sample whose keys are all padded, and one whose first 70
    keys are, so its first 70 rows see no live key. Such a row's lse is the
    float32 minimum and p = exp(s - lse) is 1 at every key, above the
    diagonal too (faceformer_tpu/ops/flash.py:153): every kernel must walk
    the tiles its causal skips would drop. Against the plain version with
    K3's gates (fp32 1e-4; bf16 0.03 of the largest and of the mean
    magnitude), bitwise repeatable."""
    hd, sk = shape
    q, k, v, bias, do = flash_case(cuda_device, dtype, 3, 300, sk, h=2, hd=hd, dead=1)
    bias[0, :70] = NEG
    kw = dict(causal=True, dropout_rate=rate, seed=5)
    assert key_tile("bwd", dtype, sk, hd) == tile["fp32" if dtype == torch.float32 else "bf16"]
    lse = flash_attention_fwd(q, k, v, bias, impl="plain", **kw)[1]
    assert bool((lse[0, :70] <= NEG).all()) and bool((lse[2] <= NEG).all())
    got = launched("flash_bwd", flash_attention_bwd, q, k, v, bias, lse, do, **kw)
    want = flash_attention_bwd(q, k, v, bias, lse, do, impl="plain", **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a.float()).all(), name
        assert rel_err(a, b) <= tol, (name, rel_err(a, b))
        mean = float((a.float() - b.float()).abs().mean() / b.float().abs().mean())
        assert mean <= tol, (name, mean)
    again = flash_attention_bwd(q, k, v, bias, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


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


def test_train_step_waits_for_nothing_on_card(cuda_device):
    """train_step under torch.cuda.set_sync_debug_mode("error"), where any
    call that waits for the card raises: a step with dropout, then a NaN
    step, which the fused Adam skips on the card (parameters, moments and
    step count unchanged)."""
    cfg, model, batch = train_case(cuda_device, 0.2)
    optimizer = make_optimizer(model, cfg.trainer)
    gen = torch.Generator().manual_seed(5)
    train_step(model, optimizer, batch, gen, cfg)  # Adam's state exists now
    torch.cuda.synchronize()
    bad = dict(batch, input=batch["input"].clone())
    bad["input"][0, 0, 0, 0] = float("nan")
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, _ = train_step(model, optimizer, batch, gen, cfg)
        params = {k: v.clone() for k, v in model.state_dict().items()}
        state = {i: {k: v.clone() for k, v in slot.items()}
                 for i, slot in enumerate(optimizer.state.values())}
        skipped, _ = train_step(model, optimizer, bad, gen, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(loss) and not torch.isfinite(skipped)
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k]), k
    for i, slot in enumerate(optimizer.state.values()):
        for k, v in slot.items():
            assert torch.equal(v, state[i][k]), (i, k)
    assert {float(slot["step"]) for slot in optimizer.state.values()} == {2.0}


# the flat model with a label budget past both kernels' whole-row reach in
# fp32 (the decoder self-attention runs at Sq = Sk = 520: K2 and K3 tiled)
FLAT_CFG = ModelConfig(num_points_per_line=8, num_lines=40, label_seq_length=521,
                       num_model=128, num_head=2, num_feedforward=256, num_encoder_layers=2,
                       num_decoder_layers=2, dropout=0.0,
                       token=TokenConfig(DIR0=4, DIR1=5, length=6))


def flat_case(dev, n=2, seed=13, cfg=FLAT_CFG):
    """A seeded flat model (biases and LayerNorms jittered) and a batch of
    seeded direction-token-like labels: SOS, [edge, DIR] pairs and SEPs,
    EOS, then PAD."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    model = SurfaceFormer(cfg, generator=gen, device=dev)
    jitter_affine_(model, gen)
    tok, lines, t = cfg.token, cfg.num_lines, cfg.label_seq_length
    num = rng.integers(10, lines + 1, n)
    label = np.zeros((n, t), np.int32)
    for i in range(n):
        size = int(rng.integers(t // 2, t - 2))
        body = rng.integers(tok.length, tok.length + num[i], size)
        body[1::2] = rng.integers(tok.DIR0, tok.DIR1 + 1, len(body[1::2]))
        body[rng.random(size) < 0.05] = tok.SEP
        label[i, 0], label[i, 1:size + 1], label[i, size + 1] = tok.SOS, body, tok.EOS
    batch = {"input": rng.uniform(-1, 1, (n, lines, cfg.num_points_per_line, 2)
                                  ).astype(np.float32),
             "input_mask": np.arange(lines)[None] >= num[:, None],
             "label": label, "label_mask": label == tok.PAD}
    return model, {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def test_flat_forward_backward_kernels_equal_plain_on_card(cuda_device):
    """The flat model's forward_train and backward through the kernels (K2
    and K3 key-tiled in the decoder self-attention at 520 keys) against
    their plain versions, fp32: launches, loss and every gradient."""
    from faceformer_tpu_torch.train.loss import pointer_cross_entropy

    results = {}
    for impl in ("auto", "plain"):
        model, batch = flat_case(cuda_device)
        ops.reset_launches()
        out = model.forward_train(batch, impl=impl)
        loss, _ = pointer_cross_entropy(out, FLAT_CFG.token)
        loss.backward()
        calls = FLAT_CFG.num_encoder_layers + 2 * FLAT_CFG.num_decoder_layers
        want = (calls, calls) if impl == "auto" else (0, 0)
        assert (ops.LAUNCHES["flash_fwd"], ops.LAUNCHES["flash_bwd"]) == want
        results[impl] = (loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()})
    assert key_tile("fwd", torch.float32, 520, 64) and key_tile("bwd", torch.float32, 520, 64)
    (loss_k, grads_k), (loss_p, grads_p) = results["auto"], results["plain"]
    assert torch.isfinite(loss_k) and abs(float(loss_k) - float(loss_p)) <= 1e-5
    for name, g in grads_p.items():
        if name.endswith("attn.k.bias"):
            assert float(grads_k[name].abs().max()) <= 1e-5 and float(g.abs().max()) <= 1e-5
        else:
            assert rel_err(grads_k[name], g) <= 1e-3, name


@pytest.mark.parametrize("mode", ["reference", "causal_cache"])
def test_flat_decode_kernels_equal_plain_on_card(cuda_device, mode):
    """greedy_decode_single through K1 and K2 equals its run through the
    plain versions, fp32, the full token budget (K1 at one row a sample)."""
    model, batch = flat_case(cuda_device, n=3)
    grids = {}
    for impl in ("auto", "plain"):
        ops.reset_launches()
        grids[impl] = greedy_decode_single(model, FLAT_CFG, batch, mode=mode, early_stop=False,
                                           impl=impl)["predict"]
        if impl == "auto":
            assert ops.LAUNCHES["pointer_argmax"] == FLAT_CFG.label_seq_length - 1
            assert ops.LAUNCHES["flash_fwd"] > 0
    assert torch.equal(grids["auto"], grids["plain"])


# the flat model at synthetic-dirtok-big.yml's width (8 heads of 64, FFN
# 1024), one layer a stack: its decoder self-attention runs at 512 keys
# (label_seq_length 513), on a rank's 4 heads
FLAT_TP_CFG = ModelConfig(num_points_per_line=8, num_lines=40, label_seq_length=513,
                          num_model=512, num_head=8, num_feedforward=1024, num_encoder_layers=1,
                          num_decoder_layers=1, dropout=0.2,
                          token=TokenConfig(DIR0=4, DIR1=5, length=6))


def _flat_tp_rank(out_dir):
    """A rank of two at model_axis 2 sharing the card: the cut flat
    model's first bf16 training forward and backward with dropout, its
    first K2 and K3 call at 512 keys recorded (heads, head0, the launches it
    made) and held against the plain versions at the rank's head0 and at the
    other rank's."""
    import inspect

    from faceformer_tpu_torch.ops import flash
    from faceformer_tpu_torch.parallel import mesh, tensor
    from faceformer_tpu_torch.train.loss import pointer_cross_entropy
    from faceformer_tpu_torch.train.trainer import rank_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    world = mesh.make_mesh(2, "cuda", model_axis=2)
    model, batch = flat_case(world.device, cfg=FLAT_TP_CFG)
    tensor.shard_params_(model, world)
    real = {"fwd": flash.flash_attention_fwd, "bwd": flash.flash_attention_bwd}
    tiled = {"fwd": "flash_fwd_tiled_tc", "bwd": "flash_bwd_tiled_tc"}
    first = {}

    def record(kind):
        signature = inspect.signature(real[kind])

        def call(*args, **kwargs):
            a = signature.bind(*args, **kwargs)
            a.apply_defaults()
            a = a.arguments
            before = ops.LAUNCHES[tiled[kind]]
            result = real[kind](*args, **kwargs)
            if a["k"].shape[1] == 512 and kind not in first:
                first[kind] = ({k: v.clone() if torch.is_tensor(v) else v for k, v in a.items()},
                               tuple(r.clone() for r in result),
                               ops.LAUNCHES[tiled[kind]] - before)
            return result
        return call

    flash.flash_attention_fwd, flash.flash_attention_bwd = record("fwd"), record("bwd")
    try:
        out = model.forward_train(batch, generator=rank_generator(3, 0), precision="bf16")
        pointer_cross_entropy(out, FLAT_TP_CFG.token)[0].backward()
    finally:
        flash.flash_attention_fwd, flash.flash_attention_bwd = real["fwd"], real["bwd"]
    got = {}
    for kind, (args, result, launches) in first.items():
        heads = int(args["q"].shape[2])
        other = (1 - world.model_rank) * heads
        got[kind] = {"heads": heads, "head0": args["head0"], "launches": launches,
                     "dropout_rate": args["dropout_rate"]}
        for label, head0 in (("err", args["head0"]), ("fault", other)):
            want = real[kind](**{**args, "impl": "plain", "head0": head0})
            if kind == "fwd":
                err = max(float((result[0].float() - want[0].float()).abs().max()),
                          float((result[1] - want[1]).abs().max()))
            else:
                err = max(rel_err(a, b) for a, b in zip(result, want))
            got[kind][label] = err
    torch.save({"rank": world.model_rank, "calls": got},
               f"{out_dir}/flat_tp_rank{world.rank}.pt")


def test_flat_tensor_parallel_forward_at_a_head_offset_on_card(cuda_device, tmp_path):
    """The flat model's first bf16 training pass under a two-rank split
    (the model-path twin of test_flash_kernels_at_a_head_offset_on_card):
    its decoder self-attention at 512 keys launches K2's and K3's
    tensor-core key-tiled kernels on each rank's 4 heads at head0 0 and 4,
    within 2e-2 and 3e-2 of their plain versions on the same call, and at
    the other rank's head0 the plain versions read >= 0.1 off."""
    from faceformer_tpu_torch.parallel import mesh

    mesh.spawn(2, _flat_tp_rank, str(tmp_path))
    for rank in (0, 1):
        got = torch.load(tmp_path / f"flat_tp_rank{rank}.pt")
        fwd, bwd = got["calls"]["fwd"], got["calls"]["bwd"]
        for call in (fwd, bwd):
            assert (call["heads"], call["head0"], call["launches"]) == (4, 4 * rank, 1), call
            assert call["dropout_rate"] == FLAT_TP_CFG.dropout and call["fault"] >= 0.1, call
        assert fwd["err"] <= 2e-2 and bwd["err"] <= 3e-2, got


def test_wrappers_launch_on_their_tensors_card(cuda_device):
    """Each kernel's wrapper on tensors of every card past the first while
    card 0 is current (``chip_smoke.tensors_card_readings``, which
    ``chip_smoke.py --cards 4`` [12] (d) runs too): the launch goes to the
    card that holds the pointers (``torch.cuda.device``), its output lies
    there and equals the plain version there (fp32: K1's and K4's tokens
    equal, K2's and K3's outputs within 1e-4), and card 0 stays current.
    Needs two cards; skipped on one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: tensors on card 1 while card 0 is current")
    smoke = chip_smoke_module()
    assert smoke.TENSORS_CARD_TOL == 1e-4
    for card in range(1, torch.cuda.device_count()):
        got = smoke.tensors_card_readings(card)
        assert smoke.tensors_card_failures(card, got) == [], got
        assert got["current_after"] == 0
        for kernel in ("K1", "K2", "K3", "K4"):
            assert got[kernel]["launches"] == 1 and got[kernel]["device"] == f"cuda:{card}"
        assert got["K1"]["differ"] == got["K4"]["differ"] == 0
        assert got["K2"]["err"] <= 1e-4 and got["K3"]["err"] <= 1e-4


def chip_smoke_module():
    """chip_smoke.py as a module (it imports nothing of JAX)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke
