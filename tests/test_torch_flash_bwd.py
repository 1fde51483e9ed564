"""PyTorch port: the flash backward's plain version against the JAX Pallas
kernel's VJP (interpret mode, CPU, fp32) and against torch.autograd over the
plain forward; the autograd binding; and attention dropout with the
counter-based (Philox) keep mask. The CUDA kernels are held against these
plain versions on the card in tests/test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceformer_tpu.ops.flash import flash_attention as jax_flash_attention
from faceformer_tpu_torch.ops.flash import (
    dropout_threshold,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
    padding_mask_bias,
    philox_keep_mask,
)

from torch_port_helpers import torch_fp32_single_thread  # noqa: F401

GRAD_ATOL = 3e-5  # tests/test_flash.py's CPU tolerance for the same comparison


def case(seed=0, n=2, sq=13, sk=21, h=4, hd=16, ragged=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, sq, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((n, sk, h, hd)).astype(np.float32) for _ in range(2))
    pad = np.zeros((n, sk), bool)
    pad[:, 17:] = True
    if ragged:
        pad[1, 9:] = True
    return q, k, v, padding_mask_bias(torch.as_tensor(pad))


def t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("sq", [13, 300])  # 300: many query rows per key, as cross-attention
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_pallas_vjp(causal, ragged, sq):
    q, k, v, bias = case(sq=sq, ragged=ragged)

    def loss(q_, k_, v_):
        out = jax_flash_attention(q_, k_, v_, jnp.asarray(bias.numpy()), causal=causal,
                                  interpret=True)
        return jnp.sum(jnp.sin(out))  # nontrivial cotangents

    theirs = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = t(q, k, v)
    out, lse = flash_attention_plain(tq, tk, tv, bias, causal)
    ours = flash_attention_bwd_plain(tq, tk, tv, bias, lse, torch.cos(out), causal)
    for a, b, name in zip(ours, theirs, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   err_msg=f"grad mismatch for {name}")


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_autograd_of_plain_forward(causal, rate):
    q, k, v, bias = case(seed=1, ragged=True)
    tq, tk, tv = (x.requires_grad_() for x in t(q, k, v))
    out, lse = flash_attention_plain(tq, tk, tv, bias, causal, rate, 5)
    want = torch.autograd.grad(torch.sin(out).sum(), (tq, tk, tv))
    got = flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(), bias, lse.detach(),
                                    torch.cos(out).detach(), causal, rate, 5)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL,
                                   err_msg=f"grad mismatch for {name}")


def test_autograd_function_routes_to_the_written_backward(monkeypatch):
    """FlashAttention's gradients are flash_attention_bwd's, and the bias
    (a mask) gets none."""
    from faceformer_tpu_torch.ops import flash as F

    q, k, v, bias = case(seed=2)
    tq, tk, tv = (x.requires_grad_() for x in t(q, k, v))
    bias = bias.clone().requires_grad_()
    calls = []
    real = F.flash_attention_bwd
    monkeypatch.setattr(F, "flash_attention_bwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = flash_attention(tq, tk, tv, bias, causal=True)
    torch.sin(out).sum().backward()
    assert calls == [1] and bias.grad is None
    _, lse = flash_attention_plain(tq, tk, tv, bias, True)
    want = flash_attention_bwd_plain(tq, tk, tv, bias, lse, torch.cos(out), True)
    for a, b in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.equal(a, b.detach())


@pytest.mark.parametrize("wrt", [0, 1, 2])
def test_dropout_directional_gradient(wrt):
    """Dropout is deterministic given the seed, so the written backward must
    match the numerical directional derivative
    (TestFlashDropoutTPU::test_directional_gradient)."""
    q, k, v, bias = case(seed=3)
    xs = list(t(q, k, v))
    rng = np.random.default_rng(1)
    step = torch.as_tensor(rng.standard_normal(xs[wrt].shape).astype(np.float32) * 1e-3)

    def f(x):
        args = xs[:wrt] + [x] + xs[wrt + 1:]
        return flash_attention(*args, bias, dropout_rate=0.2, seed=11).sum()

    x = xs[wrt].clone().requires_grad_()
    (g,) = torch.autograd.grad(f(x), x)
    analytic = float((g * step).sum())
    numeric = float((f(xs[wrt] + step) - f(xs[wrt] - step)) / 2.0)
    assert abs(analytic - numeric) < 5e-3 * max(abs(numeric), 1.0)


def test_dropout_deterministic_seeded_and_mean_preserving():
    q, k, v, bias = case(seed=4, n=4, sq=64, sk=64)
    tq, tk, tv = t(q, k, v)
    a = flash_attention(tq, tk, tv, bias, dropout_rate=0.2, seed=42)
    b = flash_attention(tq, tk, tv, bias, dropout_rate=0.2, seed=42)
    c = flash_attention(tq, tk, tv, bias, dropout_rate=0.2, seed=43)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    # without a seed nothing is dropped, whatever the rate (the eval path)
    assert torch.equal(flash_attention(tq, tk, tv, bias, dropout_rate=0.2),
                       flash_attention(tq, tk, tv, bias))
    ones = torch.ones_like(tv)  # out = sum of the used probabilities
    kept = flash_attention(tq, tk, ones, bias, dropout_rate=0.2, seed=42).mean()
    full = flash_attention(tq, tk, ones, bias).mean()
    assert abs(float(kept / full) - 1.0) < 0.05
    # lse is of the scores before dropout
    assert torch.equal(flash_attention_fwd(tq, tk, tv, bias, dropout_rate=0.2, seed=42)[1],
                       flash_attention_fwd(tq, tk, tv, bias)[1])


def philox4x32_10_numpy(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11) on uint64 numpy arrays."""
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    mask = np.uint64(0xFFFFFFFF)
    c = [np.asarray(x, np.uint64) for x in counter]
    k = [np.uint64(key[0]), np.uint64(key[1])]
    for _ in range(10):
        p0, p1 = m0 * c[0], m1 * c[2]  # < 2^64: no overflow
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k[0], p1 & mask,
             (p0 >> np.uint64(32)) ^ c[3] ^ k[1], p0 & mask]
        k = [(k[0] + np.uint64(0x9E3779B9)) & mask, (k[1] + np.uint64(0xBB67AE85)) & mask]
    return c


def test_philox_known_answers():
    """Random123's known-answer vectors for philox4x32-10."""
    from faceformer_tpu_torch.ops.flash import philox4x32_10

    vectors = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
               ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
                (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
               ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
                (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for counter, key, want in vectors:
        got = philox4x32_10(tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
        assert tuple(int(w) for w in got) == want
        assert tuple(int(w[0]) for w in philox4x32_10_numpy([[c] for c in counter], key)) == want


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 12345, 2 ** 62 - 1])
def test_keep_mask_matches_independent_numpy_philox(seed):
    n, h, sq, sk, rate = 3, 2, 9, 14, 0.2
    ours = philox_keep_mask(seed, n, h, sq, sk, rate).numpy()
    nn, hh, ii, jj = np.meshgrid(np.arange(n), np.arange(h), np.arange(sq), np.arange(sk),
                                 indexing="ij")
    words = philox4x32_10_numpy((jj // 4, ii, hh, nn), (seed & 0xFFFFFFFF, seed >> 32))
    bits = np.choose(jj % 4, words)
    assert dropout_threshold(rate) == int(np.uint32(0.8 * 4294967296.0))
    np.testing.assert_array_equal(ours, bits < np.uint64(dropout_threshold(rate)))
    assert abs(philox_keep_mask(seed, 4, 4, 64, 64, rate).float().mean() - 0.8) < 0.01


def test_bwd_wrapper_rejects_bad_input():
    q, k, v, bias = case(seed=5)
    tq, tk, tv = t(q, k, v)
    out, lse = flash_attention_fwd(tq, tk, tv, bias)
    with pytest.raises(ValueError):
        flash_attention_bwd(tq, tk, tv, bias, lse, out[:, :-1])
    with pytest.raises(ValueError):
        flash_attention_bwd(tq, tk, tv, bias, lse[:, :, :-1], out)
    with pytest.raises(ValueError):
        flash_attention_bwd(tq, tk, tv, bias, lse, out, impl="fast")
    with pytest.raises(ValueError):
        flash_attention_fwd(tq, tk, tv, bias, dropout_rate=1.0, seed=1)
