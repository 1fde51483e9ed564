#!/usr/bin/env python3
"""Drive the PyTorch port (faceformer_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases (each prints one or more lines; any failure exits non-zero):
  1. device: the card, its power limit, and the nvcc build of every kernel
     with ptxas's register / shared-memory / spill lines, and the count of
     wgmma (HGMMA) instructions in the fused decode step's library;
  2. kernels against their plain PyTorch versions at the full `ours` width
     (configs/ours.yml: d=512, 8 heads, FFN 1024, 6+6 layers, L=216, T=37),
     in fp32 and bf16: the serving kernels at batch N=20, K4's bf16 gates
     also against known faults (a bias dropped or misread, a LayerNorm
     affine ignored, a GEMM's k tile lost or n tiles swapped); the flash
     forward with in-kernel dropout and the flash backward at the three
     training shapes (encoder, causal decoder self-attention,
     anchor-folded cross-attention), with the keep mask
     held bit for bit, repeatability, and the forward's and the backward's
     bf16 gates against planted faults;
  3. the main paths. Serving: ``predict_faces`` on 20 seeded random
     wireframes through a seeded random-init SurfaceFormerParallel (biases
     and LayerNorms jittered off their init values) in bf16 with early_stop
     off, via the fused and causal_cache engines (N=20) and the reference
     engine (N=4); faces/s, wall time, peak memory and launch counts per
     engine, and one more decode under torch.profiler (device time by
     kernel, idle share); then fused vs causal_cache grid agreement.
     Training: ``train_step`` on a seeded batch of N=32 wireframes with
     seeded face loops over their edges (well-formed labels, not true
     faces): every gradient through the kernels against the plain versions
     in fp32 at N=2; Adam steps in bf16 without and with dropout 0.2, the
     NaN-loss skip, scheduled sampling and remat, with the launch counts
     each configuration implies; samples/s, the step split into forward,
     backward and optimizer, peak memory, and one step under
     torch.profiler;
  4. per-kernel timing at the main paths' shapes (K2 at each of its five:
     the serving encoder, the reference engine's decoder, and the three
     training calls): kernel, plain version, one-call library yardstick, and
     the card's lower bound; and K4's GEMM phase alone (the 49 products of
     one step, each kind held against its plain version) beside addmm;
  5. one JSON summary of the kernels, the card line, and the result line.

Exits non-zero without printing a result when no CUDA card is visible.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import shutil
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, non-tensor fp32


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


SPIN_CYCLES = 35_000_000  # ~20 ms of the card's clock


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call of fn. A spin kernel holds the card
    while the host queues the calls, so the events time the card's work
    back to back and not the host's launch overhead (which exceeds a small
    call's kernel)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def hgmma_count(library: str) -> int:
    """HGMMA (wgmma) instructions in a built library's SASS."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", library], check=True, capture_output=True, text=True,
                          timeout=300).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def random_wireframes(rng: np.random.Generator, count: int, lo: int = 60, hi: int = 216):
    """Wireframe dicts with lo..hi edges: straight 2-point lines and short
    curved polylines in [-1, 1]^2."""
    samples = []
    for _ in range(count):
        edges = []
        for _ in range(int(rng.integers(lo, hi + 1))):
            if rng.random() < 0.7:
                edges.append(rng.uniform(-1, 1, (2, 2)).tolist())
            else:
                t = np.linspace(0, np.pi * rng.uniform(0.2, 1.0), int(rng.integers(5, 30)))
                c, r = rng.uniform(-0.5, 0.5, 2), rng.uniform(0.1, 0.5)
                edges.append(np.stack([c[0] + r * np.cos(t), c[1] + r * np.sin(t)], 1).tolist())
        samples.append({"edges": edges})
    return samples


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def launched(name, fn, *args, **kwargs):
    """fn(*args, **kwargs), failing unless it launched kernel ``name`` once."""
    from faceformer_tpu_torch import ops

    before = ops.LAUNCHES[name]
    out = fn(*args, **kwargs)
    if ops.LAUNCHES[name] != before + 1:
        fail(f"{name} did not launch its kernel")
    return out


def padding(rng, n: int, s: int, dev):
    """(n, s) key-padding mask with 64..s valid rows per sample."""
    import torch

    valid = rng.integers(min(64, s), s + 1, size=n)
    return torch.as_tensor(np.arange(s)[None, :] >= valid[:, None], device=dev)


def check_pointer(rng, dev, n, r, s, e):
    import torch
    from faceformer_tpu_torch.ops.pointer import pointer_argmax

    mask = padding(rng, n, s, dev)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        rows = torch.as_tensor(rng.standard_normal((n, r, e)), dtype=dtype, device=dev)
        memory = torch.as_tensor(rng.standard_normal((n, s, e)), dtype=dtype, device=dev)
        if dtype == torch.float32:
            # constructed ties: memory rows 5 and 9 equal, and rows aimed at them
            memory[:, 9] = memory[:, 5]
            rows[:, :8] = 3 * memory[:, 5:6]
        got = launched("pointer_argmax", pointer_argmax, rows, memory, mask)
        want = pointer_argmax(rows, memory, mask, impl="plain")
        torch.cuda.synchronize()
        logits = torch.einsum("nre,nse->nrs", rows.float(), memory.float()).masked_fill(
            mask[:, None, :], float(np.finfo(np.float32).min))
        err = float((logits.gather(-1, want.long()[..., None])
                     - logits.gather(-1, got.long()[..., None])).abs().max())
        if dtype == torch.float32:
            if not torch.equal(got, want):
                fail(f"K1 fp32: {(got != want).sum().item()} indices differ from plain")
            if not bool((got[:, :8] == 5).all()):
                fail("K1 fp32: constructed ties did not resolve to the first index")
            out["fp32_err"] = err
        else:
            top2 = logits.topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > 1e-3
            bad = int(((got != want) & clear).sum())
            if bad:
                fail(f"K1 bf16: {bad} indices differ where the top-two gap exceeds 1e-3")
            out["bf16_err"] = err
    print(f"[2] K1 pointer_argmax ({n},{r},{s},{e}): fp32 indices equal incl. constructed "
          f"ties; bf16 equal where gap>1e-3; logit err fp32 {out['fp32_err']:.3g} "
          f"bf16 {out['bf16_err']:.3g}", flush=True)
    return out["bf16_err"]


# K2's bf16 gate: out and lse within 2e-2 absolute of the plain version.
K2_BF16_TOL = 2e-2


def check_flash(rng, dev, n, sq, sk, h, hd, label, prefix=False, causal=False):
    import torch
    from faceformer_tpu_torch.ops.flash import flash_attention_fwd, padding_mask_bias

    if prefix:  # reference-engine decoder self-attention: live prefix of 18
        mask = torch.as_tensor(np.arange(sk)[None, :] > 17, device=dev).expand(n, sk)
    else:
        mask = padding(rng, n, sk, dev)
    bias = padding_mask_bias(mask.contiguous())
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, K2_BF16_TOL)):
        q, k, v = (torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
                   for shape in ((n, sq, h, hd), (n, sk, h, hd), (n, sk, h, hd)))
        out, lse = launched("flash_fwd", flash_attention_fwd, q, k, v, bias, causal=causal)
        out_p, lse_p = flash_attention_fwd(q, k, v, bias, causal=causal, impl="plain")
        torch.cuda.synchronize()
        e_out = float((out.float() - out_p.float()).abs().max())
        e_lse = float((lse - lse_p).abs().max())
        if not (e_out <= tol and e_lse <= tol):
            fail(f"K2 {label} {dtype}: out err {e_out:.3g}, lse err {e_lse:.3g} > {tol}")
        errs[str(dtype)] = max(e_out, e_lse)
    print(f"[2] K2 flash_fwd {label} q({n},{sq},{h},{hd}) k({n},{sk}) causal={causal}: "
          f"max err fp32 {errs['torch.float32']:.3g} (<=1e-4), bf16 "
          f"{errs['torch.bfloat16']:.3g} (<={K2_BF16_TOL})", flush=True)
    return errs["torch.bfloat16"]


# The three attention calls of a training step at the `ours` width, N = 32:
# (label, sequences, Sq, Sk, causal, sequences the plain side is run at).
# The plain versions hold (n, 8, Sq, Sk) fp32 tensors (and the Philox
# counters in int64), so the cross-attention comparison runs at a smaller n.
TRAIN_SHAPES = (("encoder", 32, 220, 220, False, 32),
                ("decoder-self", 32 * 216, 40, 40, True, 32 * 216),
                ("cross", 32, 216 * 40, 220, False, 4))
TRAIN_RATE = 0.2


def train_attention_inputs(rng, dev, dtype, label, n, sq, sk, h, hd):
    """q, k, v, do and the key-padding bias of one training call. The
    decoder's key padding is that of face rows: 4..9 live tokens, then PAD."""
    import torch
    from faceformer_tpu_torch.ops.flash import padding_mask_bias

    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, do = randn(n, sq, h, hd), randn(n, sq, h, hd)
    k, v = randn(n, sk, h, hd), randn(n, sk, h, hd)
    if label == "decoder-self":
        live = torch.randint(4, 10, (n, 1), generator=gen, device=dev)
        mask = torch.arange(sk, device=dev)[None, :] >= live
    else:
        mask = padding(rng, n, sk, dev)
    return q, k, v, do, padding_mask_bias(mask.contiguous())


def rel_errors(got, want):
    """(largest error over the reference's largest magnitude, mean error
    over the reference's mean magnitude, largest absolute error)."""
    d = (got.float() - want.float()).abs()
    ref = want.float().abs()
    return float(d.max() / ref.max()), float(d.mean() / ref.mean()), float(d.max())


def kernel_keep_mask(q, k, v, bias, causal, seed):
    """The keep mask the forward kernel applied, read through its output:
    with v the one-hot of the key index inside a 64-key window, out[i, d]
    is p_used[i, window + d], 0 exactly where the kernel dropped it.
    Returns (kept (n, h, sq, sk) bool, live entries: not padded, not above
    the diagonal)."""
    import torch
    from faceformer_tpu_torch.ops.flash import flash_attention_fwd

    n, sq, h, hd = q.shape
    sk = k.shape[1]
    kept = torch.zeros((n, h, sq, sk), dtype=torch.bool, device=q.device)
    for w0 in range(0, sk, hd):
        width = min(hd, sk - w0)
        v1 = torch.zeros_like(v)
        idx = torch.arange(width, device=q.device)
        v1[:, w0 + idx, :, idx] = 1.0
        out = flash_attention_fwd(q, k, v1, bias, causal=causal, dropout_rate=TRAIN_RATE,
                                  seed=seed)[0]
        kept[..., w0:w0 + width] = (out[..., :width] != 0).permute(0, 2, 1, 3)
    live = (bias == 0)[:, None, None, :].expand(n, h, sq, sk).clone()
    if causal:
        live &= ~torch.ones((sq, sk), dtype=torch.bool, device=q.device).triu(1)
    return kept, live


# K3's bf16 gates: the largest and the mean error of dq, dk and dv, each
# relative to the plain version's largest and mean magnitude. The bf16
# kernel rounds ds and p_used to bf16 for its last three products where the
# plain version keeps fp32. Each limit lies between this script's readings
# on an H100 (PERF.md) of the sound kernel at the three training shapes and
# of the planted faults:
#                     sound    weakest fault (lse shifted by 0.1)
K3_BF16_MAX = 0.03   # 0.00758  0.0928
K3_BF16_MEAN = 0.03  # 0.00168  0.0952


def k3_faults(causal):
    """Kernel faults the bf16 gates must reject, each made by editing what
    the kernel is given while the plain version keeps the truth. Each entry:
    (label, dropout rate, edit(args) -> (args, fix(dq, dk, dv)))."""
    import torch

    def lse_shifted(a):
        return {**a, "lse": a["lse"] + 0.1}, None

    def scale_doubled(a):
        # a kernel whose scale is twice the true one computes exactly what the
        # sound kernel computes from 2q, except a dq twice as large
        return {**a, "q": a["q"] * 2}, lambda dq, dk, dv: (dq * 2, dk, dv)

    def seed_plus_one(a):
        return {**a, "seed": a["seed"] + 1}, None

    def wrong_head(a):
        return {**a, "dout": a["dout"].roll(1, dims=2).contiguous()}, None

    def causal_off_by_one(a):
        # one dummy query row in front (q = 0, do = 0: it adds nothing to dk
        # and dv) shifts every real row down by one, so the kernel masks
        # keys j > i + 1 where it should mask j > i
        def front(x, value=0.0):
            pad = torch.full_like(x[:, :1], value)
            return torch.cat([pad, x], dim=1).contiguous()

        edited = {**a, "q": front(a["q"]), "dout": front(a["dout"]), "lse": front(a["lse"])}
        return edited, lambda dq, dk, dv: (dq[:, 1:], dk, dv)

    faults = [("lse shifted by 0.1", TRAIN_RATE, lse_shifted),
              ("scale off by 2", TRAIN_RATE, scale_doubled),
              ("backward given seed+1", TRAIN_RATE, seed_plus_one),
              ("do of the wrong head", TRAIN_RATE, wrong_head)]
    if causal:
        faults.append(("causal off by one", 0.0, causal_off_by_one))
    return faults


def k2_faults(causal):
    """Kernel faults K2's bf16 gate must reject, each made by editing what
    the kernel is given while the plain version keeps the truth. Each entry:
    (label, dropout rate, edit(args) -> (args, fix(out, lse)))."""
    import torch

    def scale_doubled(a):
        # a kernel whose scale is twice the true one computes what the sound
        # kernel computes from 2q
        return {**a, "q": a["q"] * 2}, None

    def wrong_head(a):
        return {**a, "v": a["v"].roll(1, dims=2).contiguous()}, None

    def neighbour_bias(a):
        return {**a, "bias": a["bias"].roll(1, dims=0).contiguous()}, None

    def seed_plus_one(a):
        return {**a, "seed": a["seed"] + 1}, None

    def causal_off_by_one(a):
        # one dummy query row in front shifts every real row down by one, so
        # the kernel masks keys j > i + 1 where it should mask j > i
        q = torch.cat([torch.zeros_like(a["q"][:, :1]), a["q"]], dim=1).contiguous()
        return {**a, "q": q}, lambda out, lse: (out[:, 1:], lse[:, 1:])

    faults = [("q scaled by 2", TRAIN_RATE, scale_doubled),
              ("v of the wrong head", TRAIN_RATE, wrong_head),
              ("the neighbouring sequence's bias", TRAIN_RATE, neighbour_bias),
              ("forward given seed+1", TRAIN_RATE, seed_plus_one)]
    if causal:
        faults.append(("causal off by one", 0.0, causal_off_by_one))
    return faults


def check_flash_train(rng, dev, label, n_full, sq, sk, causal, n, h, hd):
    """K2 with dropout and K3 against their plain versions at one training
    shape, fp32 and bf16, dropout 0 and TRAIN_RATE. Returns the largest
    absolute bf16 errors (forward, backward)."""
    import torch
    from faceformer_tpu_torch.ops.flash import (flash_attention_bwd, flash_attention_fwd,
                                                keep_mask_on_card, philox_keep_mask)

    seed = int(rng.integers(2 ** 62))
    shape = f"{label} q({n},{sq},{h},{hd}) k({n},{sk}) causal={causal} (the step's N gives "\
            f"{n_full} sequences)"
    card = keep_mask_on_card(seed, n, h, sq, sk, TRAIN_RATE, dev)
    plain_mask = philox_keep_mask(seed, n, h, sq, sk, TRAIN_RATE, device=dev)
    if not torch.equal(card, plain_mask):
        fail(f"K2/K3 {label}: the card's keep mask differs from the plain Philox mask in "
             f"{int((card != plain_mask).sum())} bits")
    other = keep_mask_on_card(seed + 1, n, h, sq, sk, TRAIN_RATE, dev)
    if torch.equal(card, other):
        fail(f"K2/K3 {label}: another seed gave the same keep mask")
    print(f"[2] keep mask {shape}: card == plain bit for bit, keep share "
          f"{float(card.float().mean()):.5f}, another seed differs in "
          f"{float((card != other).float().mean()):.4f} of bits", flush=True)
    del card, other

    worst_fwd = worst_bwd = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        sound = {}  # this dtype's forward error by dropout rate
        q, k, v, do, bias = train_attention_inputs(rng, dev, dtype, label, n, sq, sk, h, hd)
        for rate in (0.0, TRAIN_RATE):
            kw = dict(causal=causal, dropout_rate=rate, seed=seed)
            out, lse = launched("flash_fwd", flash_attention_fwd, q, k, v, bias, **kw)
            out_p, lse_p = flash_attention_fwd(q, k, v, bias, impl="plain", **kw)
            e_out = float((out.float() - out_p.float()).abs().max())
            e_lse = float((lse - lse_p).abs().max())
            tol = K2_BF16_TOL if bf16 else 1e-4
            print(f"[2] K2 flash_fwd {shape} {dtype} dropout {rate}: out err {e_out:.3g}, "
                  f"lse err {e_lse:.3g} (<= {tol})", flush=True)
            if not (e_out <= tol and e_lse <= tol):
                fail(f"K2 {label} {dtype} dropout {rate}: out {e_out:.3g}, lse {e_lse:.3g}")
            sound[rate] = max(e_out, e_lse)
            if rate:
                kept, live = kernel_keep_mask(q, k, v, bias, causal, seed)
                wrong = int(((kept != plain_mask) & live).sum())
                print(f"[2] K2 flash_fwd {shape} {dtype}: the mask the kernel applied, read "
                      f"through a one-hot v, differs from the plain mask in {wrong} of "
                      f"{int(live.sum())} live entries", flush=True)
                if wrong:
                    fail(f"K2 {label} {dtype}: the kernel's keep mask is not the plain one")
                del kept, live
            args = dict(q=q, k=k, v=v, bias=bias, lse=lse_p, dout=do, **kw)
            got = launched("flash_bwd", flash_attention_bwd, **args)
            want = flash_attention_bwd(**args, impl="plain")
            again = flash_attention_bwd(**args)
            torch.cuda.synchronize()
            errs = [rel_errors(a, b) for a, b in zip(got, want)]
            line = ", ".join(f"{name} max {e[0]:.3g} mean {e[1]:.3g}"
                             for name, e in zip(("dq", "dk", "dv"), errs))
            print(f"[2] K3 flash_bwd {shape} {dtype} dropout {rate}: relative err {line}; "
                  f"two launches bitwise equal: "
                  f"{all(torch.equal(a, b) for a, b in zip(got, again))}", flush=True)
            if not all(torch.isfinite(g.float()).all() for g in got):
                fail(f"K3 {label} {dtype} dropout {rate}: non-finite gradients")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"K3 {label} {dtype}: two launches with one seed differ")
            if bf16:
                if max(e[0] for e in errs) > K3_BF16_MAX or max(e[1] for e in errs) > K3_BF16_MEAN:
                    fail(f"K3 {label} bf16 dropout {rate}: beyond the gates "
                         f"(max {K3_BF16_MAX}, mean {K3_BF16_MEAN})")
                worst_fwd = max(worst_fwd, e_out)
                worst_bwd = max(worst_bwd, max(e[2] for e in errs))
            elif max(e[0] for e in errs) > 1e-4:
                fail(f"K3 {label} fp32 dropout {rate}: relative err above 1e-4")
            if rate:
                moved = flash_attention_bwd(**{**args, "seed": seed + 1})
                if torch.equal(moved[2], got[2]):
                    fail(f"K3 {label} {dtype}: another seed gave the same dv")
            del got, want, again
        if bf16:
            for name, rate, edit in k2_faults(causal):
                args = dict(q=q, k=k, v=v, bias=bias, causal=causal, dropout_rate=rate,
                            seed=seed)
                out_p, lse_p = flash_attention_fwd(**args, impl="plain")
                edited, fix = edit(args)
                out, lse = flash_attention_fwd(**edited)
                if fix is not None:
                    out, lse = fix(out, lse)
                e = max(float((out.float() - out_p.float()).abs().max()),
                        float((lse - lse_p).abs().max()))
                caught = e > K2_BF16_TOL
                print(f"[2] K2 bf16 fault '{name}' {label} dropout {rate}: err {e:.3g} (sound "
                      f"kernel {sound[rate]:.3g}, gate {K2_BF16_TOL}); "
                      f"{'rejected' if caught else 'PASSES THE GATE'}", flush=True)
                if not caught:
                    fail(f"K2 bf16 gate passes a kernel with '{name}' at {label}")
                del out, lse, out_p, lse_p
            for name, rate, edit in k3_faults(causal):
                args = dict(q=q, k=k, v=v, bias=bias, dout=do, causal=causal,
                            dropout_rate=rate, seed=seed)
                args["lse"] = flash_attention_fwd(q, k, v, bias, causal=causal, impl="plain",
                                                  dropout_rate=rate, seed=seed)[1]
                want = flash_attention_bwd(**args, impl="plain")
                edited, fix = edit(args)
                got = flash_attention_bwd(**edited)
                if fix is not None:
                    got = fix(*got)
                errs = [rel_errors(a, b) for a, b in zip(got, want)]
                e_max, e_mean = max(e[0] for e in errs), max(e[1] for e in errs)
                caught = e_max > K3_BF16_MAX or e_mean > K3_BF16_MEAN
                print(f"[2] K3 bf16 fault '{name}' {label}: relative err max {e_max:.3g} mean "
                      f"{e_mean:.3g}; {'rejected' if caught else 'PASSES THE GATES'}",
                      flush=True)
                if not caught:
                    fail(f"K3 bf16 gates pass a kernel with '{name}' at {label}")
                del got, want
    return worst_fwd, worst_bwd


def decode_inputs(model, cfg, rng, dev, dtype, n, step):
    """A mid-decode state: random memory and padding, cross K/V from the
    model, a seeded cache with positions < step filled."""
    import torch
    from faceformer_tpu_torch.decode import NEG, _cross_kv
    from faceformer_tpu_torch.ops.decode_step import pack_decoder_weights

    f, e, s = cfg.num_lines, cfg.num_model, cfg.num_lines + cfg.token.length
    with torch.no_grad():
        memory = torch.as_tensor(rng.standard_normal((n, s, e)), dtype=dtype, device=dev)
        pos = model.pos_table[None, :s].to(dtype)
        mask = padding(rng, n, s, dev)
        ck, cv = _cross_kv(model, memory, pos, cfg.num_head)
        cache = torch.zeros((cfg.num_decoder_layers, 2, n * f, cfg.max_face_length, e),
                            dtype=dtype, device=dev)
        gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))
        cache[..., :step, :] = torch.randn(cache[..., :step, :].shape, generator=gen,
                                           device=dev).to(dtype)
        idx = torch.as_tensor(rng.integers(0, s, (n, f)), device=dev)
        x = torch.gather(memory, 1, idx[..., None].expand(-1, -1, e)).reshape(n * f, e)
        return dict(x=x.contiguous(), qpos_t=model.query_pos_table[step].to(dtype).contiguous(),
                    packed=pack_decoder_weights(model, dtype),
                    cross_k=ck.reshape(-1, n, s, e).contiguous(),
                    cross_v=cv.reshape(-1, n, s, e).contiguous(), memory=memory,
                    mem_bias=torch.where(mask, NEG, 0.0).to(torch.float32), cache=cache)


# K4's bf16 gates (fp32: tokens equal, slot and pointer vectors within
# 1e-4). Summation order flips single bf16 roundings of the residual
# stream, and six layers carry them into the later layers' K/V and into
# the pointer vectors. So bf16 is gated on what those flips move little:
# tokens wherever the plain version's top-two logit gap is clear, and the
# mean error of the slot and of the pointer vectors besides their largest.
# Each limit lies between this script's readings on an H100 (PERF.md) of
# the sound kernel at steps 1, 17 and 36 and of the faults below:
#                      sound   weakest fault it catches
K4_GAP = 2e-2        # 0.0093  0.051 (LN1 scale ignored)
K4_SLOT_MAX = 0.0625  # 0.0391  0.0742 (LN2 bias ignored)
K4_SLOT_MEAN = 5e-3  # 0.0030  0.0083 (LN2 bias ignored)
K4_PTR_MAX = 0.1     # 0.045   0.146 (LN3 bias ignored)
K4_PTR_MEAN = 5e-3   # 0.0035  0.0055 (v bias dropped); 0.0071 for the cross q
#                      bias, which only this gate catches


def k4_faults():
    """Kernel faults the bf16 gates must reject, each made by editing the
    packed weights the kernel reads (the plain step keeps the true ones):
    a bias read from the wrong row of the per-layer table or dropped, a
    LayerNorm scale or bias ignored, and two GEMM tiling errors: a k tile
    lost (the last 32 input rows of a weight read as zeros) and an n tile
    written to the wrong place (two neighbouring 8-column groups of a
    weight's output swapped)."""
    import torch
    from faceformer_tpu_torch.ops import decode_step as d

    def edit(layer, row, value):
        def apply(packed):
            vec = packed["vecs"][layer]
            vec[row] = vec[value] if isinstance(value, int) else value
        return apply

    def final_scale_ignored(packed):
        packed["final_norm"][0] = 1.0

    def lost_k_tile(packed):  # FFN2 weight (FF in, E out), layer 2
        packed["ffn_w2"][2, -32:] = 0.0

    def swapped_n_tiles(packed):  # v weight (E in, E out), layer 4: columns 160-175
        w = packed["w_mats"][4, 2]
        w[:, 160:176] = torch.cat([w[:, 168:176], w[:, 160:168]], dim=1)

    return (("q bias read from the k row, layer 0", edit(0, d._BQ, d._BK)),
            ("k bias dropped, layer 2", edit(2, d._BK, 0.0)),
            ("v bias dropped, layer 5", edit(5, d._BV, 0.0)),
            ("out-proj bias dropped, layer 1", edit(1, d._BO, 0.0)),
            ("cross q bias dropped, layer 5", edit(5, d._CBQ, 0.0)),
            ("cross out-proj bias dropped, layer 5", edit(5, d._CBO, 0.0)),
            ("LN1 scale ignored, layer 0", edit(0, d._N1S, 1.0)),
            ("LN2 bias ignored, layer 3", edit(3, d._N2B, 0.0)),
            ("LN3 bias ignored, layer 5", edit(5, d._N3B, 0.0)),
            ("final LN scale ignored", final_scale_ignored),
            ("FFN2 k tile lost (last 32 input rows zeroed), layer 2", lost_k_tile),
            ("v n tiles swapped (8-column groups 160-167, 168-175), layer 4", swapped_n_tiles))


def k4_plain(inp, step, num_head):
    """The plain step on a copy of the state: its pointer vectors, logits
    (padding bias added), tokens, and the cache it wrote."""
    import torch
    from faceformer_tpu_torch.ops.decode_step import decode_step

    cache = inp["cache"].clone()
    n, s = inp["mem_bias"].shape
    pointer = torch.empty(inp["x"].shape, dtype=torch.float32, device=inp["x"].device)
    _, tokens = decode_step(step, **{**inp, "cache": cache}, num_head=num_head, impl="plain",
                            pointer_out=pointer)
    logits = torch.einsum("nfe,nse->nfs", pointer.reshape(n, -1, pointer.shape[1]),
                          inp["memory"].float()) + inp["mem_bias"][:, None, :]
    return pointer, logits, tokens, cache


def k4_readings(inp, step, num_head, plain, packed=None):
    """Launch K4 on a copy of a mid-decode state (with ``packed`` in place
    of its weights when given) and read it against the plain step."""
    import torch
    from faceformer_tpu_torch.ops.decode_step import decode_step

    pointer_p, logits, tok_p, cache_p = plain
    cache = inp["cache"].clone()
    pointer = torch.empty_like(pointer_p)
    weights = inp["packed"] if packed is None else packed
    x_k, tok_k = launched("decode_step", decode_step, step,
                          **{**inp, "cache": cache, "packed": weights}, num_head=num_head,
                          pointer_out=pointer)
    torch.cuda.synchronize()
    e = x_k.shape[1]
    top2 = logits.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]) / top2[..., 0].abs().clamp_min(1e-30)
    differ = tok_k != tok_p
    d_ptr = (pointer - pointer_p).abs()

    def rows_of(tok):
        idx = tok.long()[..., None].expand(-1, -1, e)
        return torch.gather(inp["memory"], 1, idx).reshape(-1, e)

    agree = ~differ.reshape(-1)
    slot = (cache[:, :, :, step].float() - cache_p[:, :, :, step].float()).abs()
    return {
        "agree": float(agree.float().mean()),
        "gap": float(gap[differ].max()) if bool(differ.any()) else 0.0,
        # x_next is the gather of the kernel's own tokens on every row, and
        # equals the plain version's wherever the tokens agree
        "x_next": (torch.equal(x_k, rows_of(tok_k))
                   and torch.equal(x_k[agree], rows_of(tok_p)[agree])),
        "slot_max": float(slot.max()),
        "slot_mean": float(slot.mean(dim=(2, 3)).max()),
        "ptr_max": float(d_ptr.max()),
        "ptr_mean": float(d_ptr.mean()),
        "cache_kept": torch.equal(cache[:, :, :, :step], inp["cache"][:, :, :, :step]),
    }


def k4_failed(rd, bf16: bool):
    """The gates a reading fails."""
    gates = {"x_next": rd["x_next"], "cache_kept": rd["cache_kept"]}
    if bf16:
        gates.update(tokens=rd["gap"] <= K4_GAP, slot_max=rd["slot_max"] <= K4_SLOT_MAX,
                     slot_mean=rd["slot_mean"] <= K4_SLOT_MEAN,
                     pointer_max=rd["ptr_max"] <= K4_PTR_MAX,
                     pointer_mean=rd["ptr_mean"] <= K4_PTR_MEAN)
    else:
        gates.update(tokens=rd["agree"] == 1.0, slot_max=rd["slot_max"] <= 1e-4,
                     pointer_max=rd["ptr_max"] <= 1e-4)
    return [name for name, ok in gates.items() if not ok]


def k4_line(rd) -> str:
    return (f"token agreement {rd['agree']:.5f}, largest relative gap where tokens differ "
            f"{rd['gap']:.3g}, slot abs err max {rd['slot_max']:.3g} mean "
            f"{rd['slot_mean']:.3g}, pointer abs err max {rd['ptr_max']:.3g} mean "
            f"{rd['ptr_mean']:.3g}")


def check_decode_step(model, cfg, rng, dev, n, steps=(1, 17, 36)):
    import torch

    h, rows = cfg.num_head, n * cfg.num_lines
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for step in steps:
            inp = decode_inputs(model, cfg, rng, dev, dtype, n, step)
            plain = k4_plain(inp, step, h)
            rd = k4_readings(inp, step, h, plain)
            bad = k4_failed(rd, bf16)
            print(f"[2] K4 decode_step {dtype} step {step} rows {rows}: {k4_line(rd)}; "
                  f"{'FAILS ' + ','.join(bad) if bad else 'within the gates'}", flush=True)
            if bad:
                fail(f"K4 {dtype} step {step} fails {bad}")
            if bf16:
                worst = max(worst, rd["slot_max"])
    # the bf16 gates against known faults, at the middle step
    step = steps[1]
    inp = decode_inputs(model, cfg, rng, dev, torch.bfloat16, n, step)
    plain = k4_plain(inp, step, h)
    for label, apply in k4_faults():
        packed = {k: v.clone() for k, v in inp["packed"].items()}
        apply(packed)
        rd = k4_readings(inp, step, h, plain, packed)
        bad = k4_failed(rd, True)
        print(f"[2] K4 bf16 fault '{label}' step {step}: {k4_line(rd)}; "
              f"rejected by {bad}", flush=True)
        if not bad:
            fail(f"K4 bf16 gates pass a kernel with '{label}'")
    print(f"[2] K4 gates: fp32 tokens equal, slot and pointer <= 1e-4; bf16 tokens equal "
          f"where the relative top-two gap > {K4_GAP}, slot max <= {K4_SLOT_MAX} mean <= "
          f"{K4_SLOT_MEAN}, pointer max <= {K4_PTR_MAX} mean <= {K4_PTR_MEAN}; x_next the "
          f"gather of the tokens; cached positions kept", flush=True)
    return worst


def k4_gemm_phase(inp, mc, rng, dev):
    """K4's GEMM phase alone: the 49 products of one step (q, k, v, out,
    cross q, cross out, FFN in and out in each of the 6 layers, then the
    pointer projection) through the step's GEMM (``decode_gemm``) on the
    step's own packed weights, each kind first held against its plain
    version; then the phase's device time beside its bound and beside
    ``torch.addmm`` (matmul plus bias) at the same shapes, fp32 for the
    product whose input is fp32. The port never calls addmm."""
    import torch
    from faceformer_tpu_torch.ops import decode_step as d

    pk = inp["packed"]
    r, e, ffd = inp["x"].shape[0], mc.num_model, mc.num_feedforward
    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))

    def act(cols, dtype=bf):
        return torch.randn((r, cols), generator=gen, device=dev).to(dtype)

    qk, xn, attn, h1, cross, resid = act(e), act(e), act(e), act(ffd), act(e, f32), act(e)
    # (kind, a, w, bias, epilogue, out dtype)
    products = []
    for lyr in range(mc.num_decoder_layers):
        w, vec = pk["w_mats"][lyr], pk["vecs"][lyr]
        products += [("q", qk, w[0], vec[d._BQ], "store", bf),
                     ("k", qk, w[1], vec[d._BK], "store", bf),
                     ("v", xn, w[2], vec[d._BV], "store", bf),
                     ("out", attn, w[3], vec[d._BO], "residual", bf),
                     ("cross q", qk, w[4], vec[d._CBQ], "store", f32),
                     ("cross out (fp32 input)", cross, w[5], vec[d._CBO], "residual", bf),
                     ("FFN in", xn, pk["ffn_w1"][lyr], pk["ffn_b1"][lyr], "relu", bf),
                     ("FFN out", h1, pk["ffn_w2"][lyr], vec[d._FB2], "residual", bf)]
    products.append(("pointer projection", xn, pk["proj_w"], pk["proj_b"], "store", f32))

    def run(items):
        for _, a, w, b, epi, out in items:
            d.decode_gemm(a, w, b, epilogue=epi, resid=resid if epi == "residual" else None,
                          out_dtype=out)

    lib_w = {id(w): w.float() if a.dtype == f32 else w for _, a, w, _, _, _ in products}
    lib_b = {id(b): b.to(a.dtype) for _, a, _, b, _, _ in products}

    def run_library(items):
        for _, a, w, b, _, _ in items:
            torch.addmm(lib_b[id(b)], a, lib_w[id(w)])

    kinds = {}
    for item in products:
        kinds.setdefault(item[0], []).append(item)
    rows = {}
    for kind, items in kinds.items():
        _, a, w, b, epi, out = items[0]
        res = resid if epi == "residual" else None
        got = launched("decode_gemm", d.decode_gemm, a, w, b, epilogue=epi, resid=res,
                       out_dtype=out)
        want = d.decode_gemm(a, w, b, epilogue=epi, resid=res, out_dtype=out, impl="plain")
        err = float((got.float() - want.float()).abs().max())
        tol = (2.0 ** -7 if out == bf else 1e-5) * float(want.float().abs().max())
        if not err <= tol:
            fail(f"K4 GEMM '{kind}': error {err:.3g} beyond {tol:.3g} of the plain version")
        rows[kind] = dict(count=len(items), err=err, ms=time_ms(lambda: run(items)),
                          library_ms=time_ms(lambda: run_library(items)))
        print(f"[4] K4 GEMM '{kind}' ({len(items)}x, M {r}, N {w.shape[1]}, K {w.shape[0]}, "
              f"{a.dtype} -> {out}, {epi}): max err {err:.3g} (limit {tol:.3g}); kernel "
              f"{rows[kind]['ms']:.4f} ms, addmm {rows[kind]['library_ms']:.4f} ms for all "
              f"{len(items)}", flush=True)
    # The bound: the products' operations, and their weights and biases read
    # once. Their activations are the step's own intermediates (4.4 MB each,
    # L2-sized); counted as device-memory traffic they would give `via_hbm`.
    flops = sum(2.0 * r * w.shape[0] * w.shape[1] for _, _, w, _, _, _ in products)
    weights = sum(nbytes(w, b) for _, _, w, b, _, _ in products)
    activations = sum(nbytes(a) + r * w.shape[1] * (4 if out == f32 else 2)
                      * (2 if epi == "residual" else 1) for _, a, w, _, epi, out in products)
    b_ms, b_by = bound_ms(weights, flops, bf)
    via_hbm = bound_ms(weights + activations, flops, bf)[0]
    phase = dict(products=len(products), gflop=flops / 1e9, ms=time_ms(lambda: run(products),
                                                                        iters=5),
                 library_ms=time_ms(lambda: run_library(products), iters=5), bound_ms=b_ms,
                 bound_by=b_by, bound_ms_activations_via_hbm=via_hbm, kinds=rows)
    print(f"[4] K4 GEMM phase, the {len(products)} products of one step ({flops / 1e9:.1f} "
          f"GFLOP): kernel {phase['ms']:.4f} ms, library (addmm) {phase['library_ms']:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}; {via_hbm:.5f} ms with every activation through "
          f"device memory)", flush=True)
    return phase


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def run_engine(model, cfg, samples, mode, dev):
    import torch
    from faceformer_tpu_torch import ops
    from faceformer_tpu_torch.data.batching import collate
    from faceformer_tpu_torch.data.packing import pack_input_edges
    from faceformer_tpu_torch.tools.predict import predict_faces

    cfg = dataclasses.replace(cfg, batch_size_valid=len(samples),
                              decode=dataclasses.replace(cfg.decode, mode=mode, precision="bf16"))
    batch = collate([pack_input_edges(s["edges"], cfg.model) for s in samples])
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    model.forward_eval(batch, precision="bf16", mode=mode, early_stop=False)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    faces = predict_faces(model, cfg, samples, device=dev, early_stop=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if len(faces) != len(samples):
        fail(f"{mode}: {len(faces)} results for {len(samples)} samples")
    t0 = time.perf_counter()
    grid = model.forward_eval(batch, precision="bf16", mode=mode, early_stop=False)["predict"]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    rows = len(samples) * cfg.model.num_lines
    if grid.shape != (len(samples), cfg.model.num_lines, cfg.model.max_face_length):
        fail(f"{mode}: grid shape {tuple(grid.shape)}")
    print(f"[3] engine={mode} N={len(samples)} faces/s={rows / decode_s:.1f} "
          f"(decode {decode_s:.4f} s) predict_wall_s={wall:.4f} "
          f"max_memory_allocated={peak} launches={json.dumps(launches)} "
          f"faces_kept={sum(len(f) for f in faces)}", flush=True)
    profile_call(f"engine={mode}", lambda: model.forward_eval(
        batch, precision="bf16", mode=mode, early_stop=False), top=12)
    return launches, grid, batch


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_call(label, fn, top: int = 8):
    """One more call of ``fn`` (a decode, a training step) under
    torch.profiler: the device time summed over kernels, the device's idle
    share over the wall time (1 - union of kernel intervals / wall), and
    the kernels grouped by name, largest first. The profiler slows the
    host, so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, intervals = {}, []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            intervals.append((ev.time_range.start, ev.time_range.end))
            kernels.setdefault(ev.name, []).append(ev.time_range.end - ev.time_range.start)
    if not intervals:
        fail(f"{label}: the profiler recorded no device activity")
    device_us = sum(sum(d) for d in kernels.values())
    busy = busy_us(intervals)
    print(f"[3] {label} profile: wall_ms={wall_us / 1e3:.3f} "
          f"device_ms={device_us / 1e3:.3f} busy_ms={busy / 1e3:.3f} "
          f"idle_share={1 - busy / wall_us:.4f} device_ops={len(intervals)}", flush=True)
    groups = {"the port's kernels": 0.0, "library GEMMs": 0.0, "other torch kernels": 0.0}
    for name, d in kernels.items():
        key = ("the port's kernels" if "ff::" in name else "library GEMMs"
               if any(w in name.lower() for w in ("nvjet", "gemm", "cutlass", "cublas", "gemv"))
               else "other torch kernels")
        groups[key] += sum(d)
    print(f"[3] {label} profile, device ms by family: "
          + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in groups.items()), flush=True)
    for name, d in sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:top]:
        print(f"[3]   {sum(d) / 1e3:9.3f} ms {100 * sum(d) / device_us:5.1f} % {len(d):5d}x "
              f"{name[:100]}", flush=True)


def first_divergence_gaps(model, cfg, batch, g_a, g_b, limit=64):
    """For rows where two causal-semantics grids differ: the relative
    top-two pointer-logit gap at the first differing step, recomputed by a
    teacher-forced causal decoder pass over the shared prefix in fp32."""
    import torch
    from faceformer_tpu_torch.models import layers as L
    from faceformer_tpu_torch.models.common import encode, gather_memory_rows

    diff = (g_a != g_b)
    rows = diff.any(-1).nonzero().tolist()
    gaps = []
    with torch.no_grad():
        memory, pos, mask = encode(model, cfg, batch["input"], batch["input_mask"])
        for n, f in rows[:limit]:
            t = int(diff[n, f].nonzero()[0])  # first differing column; step t-1
            prefix = g_a[n, f, :t][None, None]  # (1, 1, t)
            tgt = gather_memory_rows(memory[n:n + 1], prefix)
            out = L.decoder_forward(
                model.decoder, tgt, memory[n:n + 1, None], model.query_pos_table[None, None, :t],
                pos[:, None], num_head=cfg.num_head, activation=cfg.activation,
                normalize_before=cfg.normalize_before, causal=True,
                memory_key_padding_mask=mask[n:n + 1, None])
            ptr = L.linear(model.project, out[0, 0, -1])
            logits = (memory[n].float() @ ptr.float()).masked_fill(
                mask[n], float(np.finfo(np.float32).min))
            top2 = logits.topk(2).values
            gaps.append(float((top2[0] - top2[1]) / top2[0].abs()))
    return len(rows), gaps


# ---------------------------------------------------------------------------
# phase 3, training
# ---------------------------------------------------------------------------


def random_face_loops(rng: np.random.Generator, num_edges: int):
    """Seeded face lists over a wireframe's edges: loops of 3-8 edge indices
    with a surface type, every edge in at most one loop. Well-formed labels
    for the packer; they are not the true faces of any solid."""
    order = rng.permutation(num_edges).tolist()
    faces = []
    while len(order) >= 3:
        size = min(int(rng.integers(3, 9)), len(order))
        faces.append((int(rng.integers(0, 4)), [order[:size]]))
        order = order[size:]
    return faces


def training_batch(rng, samples, mc, dev):
    import torch
    from faceformer_tpu_torch.data.batching import collate
    from faceformer_tpu_torch.data.packing import pack_input_edges, pack_label_parallel

    packed = []
    for sample in samples:
        item = pack_input_edges(sample["edges"], mc)
        item.update(pack_label_parallel(random_face_loops(rng, len(sample["edges"])), mc))
        packed.append(item)
    return {k: torch.as_tensor(v).to(dev) for k, v in collate(packed).items()}


def expect_launches(what, fwd, bwd):
    from faceformer_tpu_torch import ops

    got = (ops.LAUNCHES["flash_fwd"], ops.LAUNCHES["flash_bwd"])
    print(f"[3] train {what}: launches flash_fwd {got[0]} (expected {fwd}), flash_bwd "
          f"{got[1]} (expected {bwd})", flush=True)
    if got != (fwd, bwd) or 0 in got:
        fail(f"train {what}: flash launches {got}, the configuration implies {(fwd, bwd)}")


def timed_step(model, optimizer, batch, generator, cfg):
    """The calls of ``train_step`` with CUDA events between them: ms of
    (forward + loss, backward, the finite check and Adam)."""
    import torch
    from faceformer_tpu_torch.train.loss import pointer_cross_entropy

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    optimizer.zero_grad(set_to_none=True)
    ev[0].record()
    out = model.forward_train(batch, generator=generator, precision=cfg.trainer.precision)
    loss, _ = pointer_cross_entropy(out, cfg.model.token)
    ev[1].record()
    loss.backward()
    ev[2].record()
    if bool(torch.isfinite(loss)):
        optimizer.step()
    ev[3].record()
    torch.cuda.synchronize()
    return tuple(ev[i].elapsed_time(ev[i + 1]) for i in range(3))


def run_training(cfg, rng, seed, samples, dev):
    """The training path at the `ours` width. Returns the flash launch
    counts of the ten dropout-free bf16 steps (the main-path run)."""
    import torch
    from faceformer_tpu_torch import ops
    from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel
    from faceformer_tpu_torch.params import jitter_affine_
    from faceformer_tpu_torch.train.loss import pointer_cross_entropy
    from faceformer_tpu_torch.train.step import make_optimizer, train_step

    mc = cfg.model
    enc, dec = mc.num_encoder_layers, mc.num_decoder_layers
    per_step = enc + 2 * dec  # flash calls of one forward: encoder, self, cross
    gen = torch.Generator().manual_seed(seed)
    model = SurfaceFormerParallel(mc, generator=gen, device=dev)
    jitter_affine_(model, gen)
    batch = training_batch(rng, samples, mc, dev)
    rows = int((~batch["label_mask"][:, :, 1:]).sum())
    print(f"[3] train batch N={len(samples)}: seeded face loops over the wireframes' edges "
          f"(well-formed labels, not true faces), {rows} non-PAD target tokens, dropout "
          f"{mc.dropout}", flush=True)

    # fp32, N=2, no dropout: every gradient, kernels against the plain versions
    small = {k: v[:2] for k, v in batch.items()}
    grads = {}
    for impl in ("auto", "plain"):
        model.zero_grad(set_to_none=True)
        ops.reset_launches()
        out = model.forward_train(small, precision="fp32", impl=impl)
        loss, _ = pointer_cross_entropy(out, mc.token)
        loss.backward()
        torch.cuda.synchronize()
        if impl == "auto":
            expect_launches("fp32 N=2 gradients through the kernels", per_step, per_step)
        elif ops.LAUNCHES["flash_fwd"] or ops.LAUNCHES["flash_bwd"]:
            fail("impl='plain' launched a flash kernel")
        grads[impl] = {name: p.grad.clone() for name, p in model.named_parameters()}
    # A key bias shifts every score of a row alike, and the softmax ignores
    # that: its gradient is 0 but for rounding, in both versions, so it is
    # held to an absolute limit; every other leaf to its own largest magnitude.
    errs, noise = {}, {}
    for name, g in grads["auto"].items():
        d = float((g - grads["plain"][name]).abs().max())
        if name.endswith("attn.k.bias"):
            noise[name] = max(d, float(g.abs().max()), float(grads["plain"][name].abs().max()))
        else:
            errs[name] = d / float(grads["plain"][name].abs().max())
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    print(f"[3] train fp32 N=2 dropout 0: loss {float(loss.detach()):.6f}; {len(errs)} gradient "
          f"leaves, kernels vs plain, largest relative error per leaf: "
          f"{', '.join(f'{k} {v:.3g}' for k, v in worst)} (gate 1e-3); {len(noise)} key-bias "
          f"leaves (zero gradient but for rounding): largest magnitude or difference "
          f"{max(noise.values()):.3g} (gate 1e-5)", flush=True)
    if (max(errs.values()) > 1e-3 or max(noise.values()) > 1e-5
            or not all(torch.isfinite(g).all() for g in grads["auto"].values())):
        fail("train fp32: a gradient through the kernels differs from the plain versions")
    model.zero_grad(set_to_none=True)
    del grads

    # bf16, N=32: Adam steps on the one batch
    tcfg = dataclasses.replace(cfg, trainer=dataclasses.replace(
        cfg.trainer, precision="bf16", lr=1e-4, scheduled_sampling=0.0))
    optimizer = make_optimizer(model, tcfg.trainer)
    ops.reset_launches()
    losses = [float(train_step(model, optimizer, batch, None, tcfg)[0]) for _ in range(10)]
    torch.cuda.synchronize()
    main_launches = dict(ops.LAUNCHES)
    expect_launches("10 bf16 steps, dropout 0", 10 * per_step, 10 * per_step)
    print(f"[3] train bf16 N={len(samples)} dropout 0 lr 1e-4, 10 steps on one batch: losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("train bf16: a loss is not finite, or the last is not below the first")

    dgen = torch.Generator().manual_seed(seed + 1)
    ops.reset_launches()
    losses = [float(train_step(model, optimizer, batch, dgen, tcfg)[0]) for _ in range(10)]
    expect_launches(f"10 bf16 steps, dropout {mc.dropout}", 10 * per_step, 10 * per_step)
    print(f"[3] train bf16 dropout {mc.dropout}, 10 more steps: losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    if not all(np.isfinite(losses)):
        fail("train bf16 with dropout: a loss is not finite")

    # a NaN planted in the input: the step is skipped
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in slot.items()}
             for i, slot in optimizer.state_dict()["state"].items()}
    bad = dict(batch)
    bad["input"] = batch["input"].clone()
    bad["input"][0, 0, 0, 0] = float("nan")
    loss, _ = train_step(model, optimizer, bad, dgen, tcfg)
    after = optimizer.state_dict()["state"]
    same = (all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
            and after.keys() == state.keys()
            and all(torch.equal(after[i][k], v) if torch.is_tensor(v) else after[i][k] == v
                    for i, slot in state.items() for k, v in slot.items()))
    print(f"[3] train NaN planted in the input: loss {float(loss)}, parameters and Adam state "
          f"(moments, step counts) bitwise unchanged: {same}", flush=True)
    if bool(torch.isfinite(loss)) or not same:
        fail("train: the NaN step did not leave parameters and Adam state unchanged")

    # scheduled sampling: a dropout-free first pass re-runs the decoder only
    ss = dataclasses.replace(tcfg, trainer=dataclasses.replace(tcfg.trainer,
                                                               scheduled_sampling=0.5))
    ops.reset_launches()
    loss, _ = train_step(model, optimizer, batch, dgen, ss)
    expect_launches("1 step, scheduled sampling 0.5", per_step + 2 * dec, per_step)
    if not bool(torch.isfinite(loss)):
        fail("train: non-finite loss with scheduled sampling")

    # timing, remat off then on: steady steps with dropout on
    def measure(label):
        for _ in range(2):
            train_step(model, optimizer, batch, dgen, tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        steps = 5
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step(model, optimizer, batch, dgen, tcfg)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / steps
        peak = torch.cuda.max_memory_allocated()
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
        reserved = torch.cuda.max_memory_reserved()
        split = np.mean([timed_step(model, optimizer, batch, dgen, tcfg) for _ in range(3)],
                        axis=0)
        print(f"[3] train {label} N={len(samples)} bf16 dropout {mc.dropout}: samples/s="
              f"{len(samples) / step_s:.2f} step_ms={step_s * 1e3:.2f} forward_ms={split[0]:.2f} "
              f"backward_ms={split[1]:.2f} optimizer_ms={split[2]:.2f} "
              f"max_memory_allocated={peak} max_memory_reserved={reserved} "
              f"allocator_retries={retries}", flush=True)

    measure("remat off")
    profile_call("train step (remat off)",
                 lambda: train_step(model, optimizer, batch, dgen, tcfg), top=12)
    model.cfg = dataclasses.replace(mc, remat=True)
    ops.reset_launches()
    loss, _ = train_step(model, optimizer, batch, dgen, tcfg)
    expect_launches("1 step, remat full", 2 * per_step, per_step)
    if not bool(torch.isfinite(loss)):
        fail("train: non-finite loss with remat")
    measure("remat full")
    model.cfg = dataclasses.replace(mc, remat=True, remat_policy="attn")
    try:
        train_step(model, optimizer, batch, dgen, tcfg)
    except NotImplementedError as e:
        print(f"[3] train remat_policy 'attn' refused: {e}", flush=True)
    else:
        fail("a named remat policy ran as if it were ported")
    return main_launches


# ---------------------------------------------------------------------------


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card visible: chip_smoke needs one", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from faceformer_tpu_torch import ops
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel
    from faceformer_tpu_torch.ops import _build
    from faceformer_tpu_torch.params import jitter_affine_

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[1] device {kind} count={torch.cuda.device_count()} nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[1] built {built} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.SOURCES:
        with open(_build.log_path(name)) as f:
            kernel = ""
            for line in f:
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1]
                elif "registers" in line or "spill" in line or "Performance Loss" in line:
                    print(f"[1] ptxas {name} {kernel}: {line.strip()}", flush=True)
    hgmma = hgmma_count(_build.lib_path("decode_step"))
    print(f"[1] cuobjdump -sass libdecode_step.so: {hgmma} HGMMA instructions (K4's GEMM on "
          f"wgmma)", flush=True)
    if not hgmma:
        fail("K4's GEMM holds no wgmma (HGMMA) instruction")

    cfg = load_config("configs/ours.yml")
    mc = cfg.model
    n, f, e, h = 20, mc.num_lines, mc.num_model, mc.num_head
    s, hd = f + mc.token.length, e // h
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    model = SurfaceFormerParallel(mc, generator=gen, device=dev)
    jitter_affine_(model, gen)  # biases and LayerNorms off their init values

    # phase 2
    err = {"pointer_argmax": check_pointer(rng, dev, n, f, s, e)}
    err["flash_fwd"] = max(
        check_flash(rng, dev, n, s, s, h, hd, "encoder"),
        check_flash(rng, dev, n * f, 37, 37, h, hd, "ref-decoder-self", prefix=True),
        check_flash(rng, dev, 4, 40, 40, h, hd, "causal", causal=True))
    err["decode_step"] = check_decode_step(model, mc, rng, dev, n)
    err["flash_bwd"] = 0.0
    for label, n_full, sq, sk, causal, n_plain in TRAIN_SHAPES:
        e_fwd, e_bwd = check_flash_train(rng, dev, label, n_full, sq, sk, causal, n_plain, h, hd)
        err["flash_fwd"] = max(err["flash_fwd"], e_fwd)
        err["flash_bwd"] = max(err["flash_bwd"], e_bwd)
    print(f"[2] K3 gates: fp32 dq, dk, dv within 1e-4 of the plain version relative to each "
          f"tensor's largest magnitude; bf16 largest error <= {K3_BF16_MAX} of the largest "
          f"magnitude and mean error <= {K3_BF16_MEAN} of the mean magnitude; keep masks "
          f"bit for bit; two launches bitwise equal", flush=True)

    # phase 3
    samples = random_wireframes(rng, n)
    total = {k: 0 for k in ops.LAUNCHES}
    grids = {}
    expect = {"fused": ("flash_fwd", "decode_step"),
              "causal_cache": ("flash_fwd", "pointer_argmax"),
              "reference": ("flash_fwd", "pointer_argmax")}
    for mode in ("fused", "causal_cache", "reference"):
        launches, grid, batch = run_engine(model, cfg, samples[:4] if mode == "reference"
                                           else samples, mode, dev)
        for k in expect[mode]:
            if launches[k] <= 0:
                fail(f"{mode}: kernel {k} was not launched on the main path")
        for k, v in launches.items():
            total[k] += v
        grids[mode] = (grid, batch)
    g_fused, batch = grids["fused"]
    g_cache, _ = grids["causal_cache"]
    print(f"[3] bf16 fused vs causal_cache grid agreement "
          f"{float((g_fused == g_cache).float().mean()):.6f}", flush=True)
    g32 = {m: model.forward_eval(batch, precision="fp32", mode=m, early_stop=False)["predict"]
           for m in ("fused", "causal_cache")}
    agree = float((g32["fused"] == g32["causal_cache"]).float().mean())
    n_rows, gaps = first_divergence_gaps(model, mc, batch, g32["fused"], g32["causal_cache"])
    print(f"[3] fp32 fused vs causal_cache grid agreement {agree:.6f} (>=0.999); "
          f"{n_rows} rows differ; max relative top-two gap at first divergence "
          f"{max(gaps) if gaps else 0.0:.3g} (<1e-4)", flush=True)
    if agree < 0.999 or any(g >= 1e-4 for g in gaps):
        fail("fused and causal_cache disagree beyond near-ties")
    del grids, g32

    train_n = TRAIN_SHAPES[0][1]
    launches = run_training(cfg, rng, args.seed, random_wireframes(rng, train_n), dev)
    for k, v in launches.items():
        total[k] += v

    # phase 4: timing at the main path's shapes, bf16
    bf = torch.bfloat16
    timings = []
    from faceformer_tpu_torch.ops.decode_step import decode_step
    from faceformer_tpu_torch.ops.flash import (flash_attention_bwd, flash_attention_fwd,
                                                padding_mask_bias)
    from faceformer_tpu_torch.ops.pointer import pointer_argmax

    rows = torch.as_tensor(rng.standard_normal((n, f, e)), dtype=bf, device=dev)
    memory = torch.as_tensor(rng.standard_normal((n, s, e)), dtype=bf, device=dev)
    mask = padding(rng, n, s, dev)
    neg = float(np.finfo(np.float32).min)

    def library_pointer():
        logits = torch.matmul(rows, memory.transpose(1, 2)).float()
        return logits.masked_fill(mask[:, None, :], neg).argmax(-1)

    b, fl = bound_ms(nbytes(rows, memory, mask) + n * f * 4, 2.0 * n * f * s * e, bf)
    timings.append(("pointer_argmax", "faceformer_tpu_torch/csrc/pointer.cu",
                    "faceformer_tpu/ops/pointer.py:48",
                    time_ms(lambda: pointer_argmax(rows, memory, mask)),
                    time_ms(lambda: pointer_argmax(rows, memory, mask, impl="plain")),
                    time_ms(library_pointer), b, fl))

    # K2 in serving, no dropout: the encoder (its row in the summary) and the
    # reference engine's decoder self-attention (it decodes N=4) over a live
    # prefix of 18
    flash_lib = _build.load("flash")
    flash_lib.flash_smem_bytes.argtypes = [ctypes.c_int] * 3
    flash_lib.flash_smem_bytes.restype = ctypes.c_size_t
    k2_rows = {}
    for label, n2, sq in (("encoder-serving", n, s), ("reference-decoder", 4 * f, 37)):
        q, k, v = (torch.as_tensor(rng.standard_normal((n2, sq, h, hd)), dtype=bf, device=dev)
                   for _ in range(3))
        key_mask = (mask if label == "encoder-serving" else
                    torch.as_tensor(np.arange(sq)[None, :] > 17, device=dev).expand(n2, sq))
        bias = padding_mask_bias(key_mask.contiguous())
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask4 = bias[:, None, None, :].to(bf)
        b, fl = bound_ms(nbytes(q, k, v, bias, q) + n2 * sq * h * 4,
                         4.0 * n2 * h * sq * sq * hd, bf)
        row = dict(ms=time_ms(lambda: flash_attention_fwd(q, k, v, bias)),
                   plain_ms=time_ms(lambda: flash_attention_fwd(q, k, v, bias, impl="plain")),
                   library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=mask4)), bound_ms=b, bound_by=fl,
                   smem_bytes=flash_lib.flash_smem_bytes(1, sq, hd))
        k2_rows[label] = row
        print(f"[4] flash_fwd {label} q({n2},{sq},{h},{hd}) k({n2},{sq}) bf16: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {b:.5f} ms ({fl}); dynamic shared memory "
              f"{row['smem_bytes']} B a block", flush=True)
        del q, k, v, bias, qt, kt, vt, mask4
    row = k2_rows["encoder-serving"]
    timings.append(("flash_fwd", "faceformer_tpu_torch/csrc/flash.cu",
                    "faceformer_tpu/ops/flash.py:252", row["ms"], row["plain_ms"],
                    row["library_ms"], row["bound_ms"], row["bound_by"]))

    step = 17
    inp = decode_inputs(model, mc, rng, dev, bf, n, step)
    r, lyr, ffd = n * f, mc.num_decoder_layers, mc.num_feedforward
    live = 2 * lyr * r * step * e * 2  # cached K/V positions < step, read once
    moved = (nbytes(*inp["packed"].values(), inp["x"], inp["qpos_t"], inp["cross_k"],
                    inp["cross_v"], inp["memory"], inp["mem_bias"]) + live
             + 2 * lyr * r * e * 2 + r * e * 2 + r * 4)
    flops = (2.0 * r * (lyr * (6 * e * e + 2 * e * ffd) + e * e)
             + lyr * 4.0 * r * e * ((step + 1) + s) + 2.0 * r * s * e)
    b, fl = bound_ms(moved, flops, bf)
    timings.append(("decode_step", "faceformer_tpu_torch/csrc/decode_step.cu",
                    "faceformer_tpu/ops/decode_step.py:414",
                    time_ms(lambda: decode_step(step, **inp, num_head=h), iters=5),
                    time_ms(lambda: decode_step(step, **inp, num_head=h, impl="plain"),
                            iters=5), None, b, fl))
    gemm_phase = k4_gemm_phase(inp, mc, rng, dev)
    del inp
    # K3 (and K2 with dropout) at the three training shapes, bf16, dropout on
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k3_lib = _build.load("flash_bwd")
    k3_lib.flash_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    k3_lib.flash_bwd_smem_bytes.restype = ctypes.c_size_t
    k3_lib.flash_bwd_workspace_bytes.argtypes = [ctypes.c_int] * 7
    k3_lib.flash_bwd_workspace_bytes.restype = ctypes.c_size_t
    k3_rows = {}
    for label, n3, sq, sk, causal, _ in TRAIN_SHAPES:
        q, k, v, do, bias = train_attention_inputs(rng, dev, bf, label, n3, sq, sk, h, hd)
        kw = dict(causal=causal, dropout_rate=TRAIN_RATE, seed=1234)
        lse = flash_attention_fwd(q, k, v, bias, **kw)[1]
        fwd_ms = time_ms(lambda: flash_attention_fwd(q, k, v, bias, **kw), iters=5)
        fwd0_ms = time_ms(lambda: flash_attention_fwd(q, k, v, bias, causal=causal), iters=5)
        ms = time_ms(lambda: flash_attention_bwd(q, k, v, bias, lse, do, **kw), iters=5)
        ms0 = time_ms(lambda: flash_attention_bwd(q, k, v, bias, lse, do, causal=causal),
                      iters=5)
        plain = time_ms(lambda: flash_attention_bwd(q, k, v, bias, lse, do, impl="plain", **kw),
                        iters=2, warmup=1)
        # the library's backward alone: one autograd.grad through its attention
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        mask4 = bias[:, None, None, :]
        if causal:
            above = torch.ones((sq, sk), dtype=torch.bool, device=dev).triu(1)
            mask4 = mask4.expand(n3, 1, sq, sk).masked_fill(above, neg)
        mask4 = mask4.to(bf)
        # the library's forward with the same mask and dropout, timed alike
        with torch.no_grad():
            fwd_lib = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask4, dropout_p=TRAIN_RATE),
                              iters=5)
        out = sdpa(qt, kt, vt, attn_mask=mask4, dropout_p=TRAIN_RATE)
        dot = do.transpose(1, 2)
        lib = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True),
                      iters=5)
        moved = nbytes(q, k, v, do, lse, bias) + nbytes(q, k, v)
        b, by = bound_ms(moved, 5 * 2.0 * n3 * h * sq * sk * hd, bf)
        fb, fby = bound_ms(nbytes(q, k, v, bias, q, lse), 2 * 2.0 * n3 * h * sq * sk * hd, bf)
        smem = k3_lib.flash_bwd_smem_bytes(1, sk, hd)
        work = k3_lib.flash_bwd_workspace_bytes(1, n3, sq, sk, h, hd, 1)
        k3_rows[label] = dict(ms=ms, ms_no_dropout=ms0, plain_ms=plain, library_ms=lib,
                              bound_ms=b, bound_by=by, smem_bytes=smem, workspace_bytes=work)
        k2_rows[label] = dict(ms=fwd_ms, ms_no_dropout=fwd0_ms, library_ms=fwd_lib,
                              bound_ms=fb, bound_by=fby,
                              smem_bytes=flash_lib.flash_smem_bytes(1, sk, hd))
        print(f"[4] flash_bwd {label} q({n3},{sq},{h},{hd}) k({n3},{sk}) bf16 dropout "
              f"{TRAIN_RATE}: kernel {ms:.4f} ms (dropout 0: {ms0:.4f}), plain {plain:.4f} ms, "
              f"library backward {lib:.4f} ms, bound {b:.5f} ms ({by}); dynamic shared memory "
              f"{smem} B a block, keep-bit workspace {work} B", flush=True)
        print(f"[4] flash_fwd {label} q({n3},{sq},{h},{hd}) k({n3},{sk}) bf16 dropout "
              f"{TRAIN_RATE}: kernel {fwd_ms:.4f} ms (dropout 0: {fwd0_ms:.4f}), library "
              f"{fwd_lib:.4f} ms (same mask and dropout), bound {fb:.5f} ms ({fby}); dynamic "
              f"shared memory {k2_rows[label]['smem_bytes']} B a block", flush=True)
        del q, k, v, do, bias, lse, qt, kt, vt, out, dot, mask4
    row = k3_rows["cross"]
    timings.insert(2, ("flash_bwd", "faceformer_tpu_torch/csrc/flash_bwd.cu",
                       "faceformer_tpu/ops/flash.py:293", row["ms"], row["plain_ms"],
                       row["library_ms"], row["bound_ms"], row["bound_by"]))
    for name, _, _, ms, plain, lib, bnd, by in timings:
        print(f"[4] {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {bnd:.5f} ms ({by})",
              flush=True)

    # phase 5
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": total[name], "max_abs_err": err[name], "ms": ms, "plain_ms": plain,
         "bound_ms": bnd, "bound_by": by, "library_ms": lib}
        for name, src, rep, ms, plain, lib, bnd, by in timings]}
    # K2's entry is the serving encoder call and K3's the cross-attention
    # call; their other shapes ride along
    summary["kernels"][1]["shapes"] = k2_rows
    summary["kernels"][2]["shapes"] = k3_rows
    summary["kernels"][3]["gemm_phase"] = gemm_phase
    print(json.dumps(summary), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
