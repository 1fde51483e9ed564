#!/usr/bin/env python3
"""Drive the PyTorch port (faceformer_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --cards 4     # [1] and [12] alone, on four cards

Phases (each prints one or more lines; any failure exits non-zero):
  1. device: the card, its power limit, and the nvcc build of every kernel
     with ptxas's register / shared-memory / spill lines, the count of
     wgmma (HGMMA) instructions in the fused decode step's library and of
     mma.sync (HMMA) instructions in each instantiation of K2's tensor-core
     key-tiled kernel and of K3's tensor-core key-tiled dq kernel;
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
     each configuration implies; the NaN step and a step with dropout
     under torch.cuda.set_sync_debug_mode("error"), where a call inside
     ``train_step`` that waits for the card fails the phase (the skip runs
     on the card); samples/s, the step split into forward, backward and
     optimizer, peak memory, and one step under torch.profiler, then three
     steps back to back at N=8 (the flagship recipe's rows a card) under
     it: the card's busy ms a step, which the fit's step span does not
     give;
  4. per-kernel timing at the main paths' shapes (K2 at each of its five:
     the serving encoder, the reference engine's decoder, and the three
     training calls): kernel, plain version, one-call library yardstick, and
     the card's lower bound, K3 there held once more to its bf16 gates;
     and K4's GEMM phase alone (the 49 products of
     one step, each kind held against its plain version) beside addmm;
     each timing's spin kernel is checked to outlast the host's queueing
     of the timed calls, and lengthened until it does;
  5. the command line at the `ours` width of configs/synthetic-big.yml
     (batch 32, bf16, remat, causal_cache validation), each run in a
     subprocess from a temporary directory: ``tools.synthetic_data`` writes
     352 rich solids (327 / 7 / 18); ``main`` fits two epochs (20 steps,
     validation and checkpoints after each), tests ``last`` with the fused
     engine and with causal_cache, validates it, resumes it for epoch 3
     alone, and tests a Lightning-style .ckpt exported from it with the
     fused engine again;
     ``tools.predict --reconstruct`` decodes the test wireframes and lifts
     its predictions to PLYs; ``reconstruction.wireframe`` and ``.mesh``
     (4 cores) lift the causal_cache test's JSONs; then every corpus
     solid's label faces, as the test loop's record would carry them,
     go through both lifts (the oracle lift). Gates: a finite loss
     every step that falls from epoch 1 to 2, the checkpoints, 18 JSONs
     of four keys a test, fused byte-identical on a repeat from the
     exported .ckpt, the resume's steps 21-30, the kernels each run
     launched; predict's PLYs byte-equal to the wireframe command line's
     wherever the two runs' faces agree; every lifted PLY read back to
     the array written, every point and OBJ vertex finite; the oracle
     lift's counts and dropped names equal to the JAX package's
     (``ORACLE_LIFTED``, ``ORACLE_DROPPED``). Prints samples/s, host
     seconds, validate and test times, checkpoint cost, peak memory and
     launches; predict's decode and lift seconds, the PLYs and OBJs
     written, the dropped solids by predicted face kind, solids/s of
     each exporter and scipy's version;
  6. the flat SurfaceFormer at the width of configs/synthetic-dirtok-big.yml
     (d=512, 8 heads, FFN 1024, 6+6 layers, S=116 memory rows,
     label_seq_length 512, direction tokens, batch 32, bf16, dropout 0.2):
     K2 and K3 past their whole-row kernels' reach (causal 512, a ragged
     1,000 keys, causal 600 with rows that see no live key, hd = 32)
     against their plain versions in both dtypes with and without dropout,
     keep masks bit for bit, another seed moving K3's dv, and planted
     tiling faults (the first or the last key tile dropped; keep bits drawn
     at the wrong key index) against the bf16 gates at each key-tiled
     kernel's tile (K3 on the dead rows' shape judged sample by sample);
     K2 and K3 at the model's three
     attention shapes (the checks of [2], then timed as in [4], and at
     2,000 causal keys, K3 there held to its bf16 gates) and at the coedge
     recipe's three (COEDGE_SHAPES, the checks of [2]); K1 at one row a
     sample against both recipes' memory rows; training (every gradient through the kernels against the
     plain versions in fp32 at N=2, then 5 timed bf16 steps at N=32 after
     2 warm-ups: samples/s, the step's split, peak memory, launches, K2's
     and K3's tensor-core key-tiled kernels in every decoder
     self-attention, a step under torch.cuda.set_sync_debug_mode("error"),
     one profiled step); serving with early stop off
     (causal_cache timed at N=32 with a profiled decode, reference at N=4;
     over the first FLAT_CHECK_STEPS steps each engine's fp32 grid through
     the kernels equal to the plain versions', bf16 grids parting only at
     near-ties); the command lines (a 350-solid direction-token corpus;
     ``tools.train_demos run dirtok-s0`` fits one epoch with validation and
     checkpoints, then tests with causal_cache the checkpoint
     ``CheckpointManager.best_path`` names, the scored epoch 1 and not
     ``last``; its ``summary`` reads the version back;
     predict on four wireframes; then, side by side on the card,
     ``tools.diagnose_dirtok`` on the tested checkpoint (its counts
     consistent, K1 and K2 launched; its counting function over the test
     split's label rows and planted decodes, whose counts are not 0) and
     ``tools.train_demos run coedge-s0`` on a 128-solid cut of the coedge
     recipe's corpus at configs/synthetic-coedge-big.yml's width (S=220,
     T=259, nested coedge labels), checked as dirtok-s0's stage);
     its profiled causal_cache decode runs the first FLAT_PROFILE_STEPS
     steps;
  7. ranks (parallel/mesh.py), the remat policies and tools.profile:
     (a) two gloo ranks on the one card, started by ``parallel.mesh.spawn``,
     against one rank at the `ours` width in fp32 (dropout 0, remat full,
     global batch 32, 2 Adam steps): losses and parameters within gates set
     from the fp32 readings, planted faults (no all-reduce; DDP's mean of
     the ranks' means) read beside them, and the gradient all-reduce's ms;
     (b) ``main ... trainer.num_devices 2`` on [5]'s corpus: one epoch with
     validation and a checkpoint, then the checkpoint tested with the fused
     engine in fp32 at two ranks and at one (18 JSONs byte-equal, the
     metrics equal to their means over the JSONs, one writer, K2, K3, K1
     and K4 launched on each rank), fit samples/s beside [5]'s; (c) the
     nccl process group and its all-reduces at world 1 against no process
     group; (d) each remat policy (off, full, dots, attn, attn_ffn) at N=32
     in bf16 with dropout: samples/s, peak memory, K2 and K3 launches, and
     in fp32 at N=2 every gradient against full's; (e) ``tools.profile``'s
     main, in this process, for the fused decode and the training step at
     batch 8: a trace that
     gives device time, by the wrapper that launched it, to K2 and K4, or
     K2 and K3, and none to K1 in the fused decode (K4's attention and
     pointer phases count as K4's);
  8. the corpus pipeline, from STEP files to the split JSON directory the
     trainer reads, each step a subprocess: (a) ``tools.gen_step_solids``
     writes 256 STEP solids and (b) ``tools.prepare_data --backend native
     --random_camera`` turns them into JSONs, SVGs and stat sidecars on the
     host's 8 cores (configs/step-native-big.yml's commands cut from 4,096
     solids); (c) ``tools.check_faces_enclosed``, ``filters.filter_length``
     and ``split_jsons`` run on it, and ``filters.filter_topology`` where
     sklearn is installed (else its topology features are counted), and
     the corpus's integer content (solids written and dropped, splits,
     counts, face types, each solid's faces as types and loop lengths, the
     face loops of every solid without a traced face, the stat sidecars) is
     held to the JAX package's (``ORACLE_CORPUS``); (d) ``main`` fits one
     epoch on it at the width of configs/step-native-big.yml (d=512, 8
     heads, 6+6 layers, 176 lines, batch 32, remat) and tests ``last``
     under its causal_cache engine. Gates: the oracle, finite losses that
     fall, 13 JSONs of four keys, K2 and K3 launched in the fit, K1 and K2
     and no K4 in the test. Prints each step's host seconds, solids/s and
     the fit's samples/s;
  9. tensor parallelism over the model axis (parallel/tensor.py), two gloo
     ranks on the one card at model_axis 2, each with 4 of the 8 heads and
     512 of the 1,024 FFN columns of every layer, against one rank, at the
     `ours` width, N = 4, in one ``parallel.mesh.spawn``: (a) fp32, dropout
     0, 2 Adam steps: the losses and every gathered parameter within gates
     set from the fp32 readings, a planted fault (a row-parallel bias added
     on both ranks) read beside them, K2 and K3 launched on 4 heads a call
     on each rank; (b) bf16 with dropout 0.2: the losses within bf16 limits
     of one rank's with the same seeds, and the card's keep mask of each
     rank's heads (head0 0 and 4) equal to philox_keep_mask's and to those
     heads of the whole mask; (c) fp32 decodes: the causal_cache and fused
     grids at N = 4 and the reference grid at N = 2 equal to one rank's, K1
     and K4 launched; then (d) ``parallel.dryrun.dryrun_multichip(4)``,
     four ranks on the card; (e) figures without gates: each rank's
     parameter bytes and peak memory, and the step's model-axis
     collectives (count, bytes, ms) against one rank's step; then the flat
     SurfaceFormer at the width of configs/synthetic-dirtok-big.yml in the
     same ranks: (f) fp32, dropout 0, 2 Adam steps: the losses, the first
     step's gathered gradients and the parameters against one rank's, a
     rounding control (one rank through the plain versions) and the planted
     fault read beside them, the step's collectives, parameter bytes and
     peak memory; (g) bf16 with dropout 0.2, one step: the loss, and the
     first K2 and K3 call at 512 keys (the decoder self-attention, on the
     tensor-core key-tiled kernels) against the plain versions at the
     rank's head offset and at the other rank's; (h) both flat engines'
     fp32 grids with early stop off over [6]'s FLAT_CHECK_STEPS steps
     (causal_cache N = 4, reference N = 2) equal to one rank's and to each
     other's, K1 after the pointer gather;
  10. the C++ host path (the threaded JSON loader and the geometry kernel
     of csrc/host/, built by g++ in [1]) on the corpora of [5]
     (synthetic-big, parallel labels), [6] (synthetic-dirtok-big, flat
     direction-token labels) and [8] (step-native-big), each while its
     phase holds it: every split built through the native loader and
     through the Python packer, timed (construction plus one pass), every
     item's arrays equal (``input`` bit for bit) and the raw JSONs eval
     reads equal; over [5]'s validation split, ``resample_edge_batch`` and
     the metrics' enclosedness filter a sample each way, outputs equal.
     The fits of [5], [6] and [8] load through the native path (the
     datasets' default);
  11. one JSON summary of the kernels, the card line, and the result line.

With ``--cards 4`` it runs [1], then [12], then the card line and the
result line, and exits 1 with fewer than four visible cards:
  12. the data and model axes over nccl, four ranks on four cards, one a
     rank (parallel/mesh.py picks nccl where each rank has a card):
     each card's name and power limit and ``nvidia-smi topo -m``; (a) [7]
     (a)'s fp32 steps on four ranks against one rank on card 0, with
     [7] (a)'s gates and planted faults, every rank on nccl and a card of
     its own, the gradient all-reduce timed, and the transports NCCL chose
     (NCCL_DEBUG=INFO, read from its files), while [5]'s corpus is
     written on the host beside it; (b) ``main ... trainer.num_devices 4``
     on that corpus at configs/synthetic-big.yml as written: one epoch,
     one writer, K2 and K3 on every rank, then its checkpoint tested in
     fp32 on four ranks and on one under causal_cache and fused: JSONs
     byte-equal, metrics equal and equal to the means over the JSONs;
     (c) ``parallel.dryrun.dryrun_multichip(4)`` (mesh (2x2), nccl, the
     flagship at 6+6 layers), then [9] (a)'s fp32 steps on data 2 x model
     2 against one rank in deterministic mode: losses, the first step's
     gathered gradients and the parameters within [9]'s gates, its
     planted fault beyond them, the model-axis collectives a step; (d)
     K1-K4 on tensors of cards 1, 2 and 3 while card 0 is current
     (tests/test_torch_gpu.py's check): launched there, equal to their
     plain versions there, card 0 current afterwards; (e) the training
     step at 8 rows a card on four ranks, remat full and off: step ms by
     CUDA events with the steps queued back to back, samples/s, the
     gradient all-reduce's share, each rank's peak memory, and a
     projection of one seed of the 2e recipe against a 3,600 s call
     (figures only), then one more step a rank under
     torch.cuda.set_sync_debug_mode("error") (a call inside it that waits
     for the card fails the phase); (f) the rehearsal of the flagship
     recipe's four-card run: ``tools.train_demos run flagship-s0
     model.remat False trainer.num_devices 4`` on [5]'s corpus for one
     epoch, then its test of the checkpoint ``best_path`` names, with the
     STAGE record's four ranks a phase, each rank's K2 and K3 in the fit
     and K1 in the test, results.json over the test split and the audit
     files copied, and the fit's epoch split as ms a step (the host's in
     the batches and in queueing the steps, the steps' span on the card's
     stream).
     The launches a rank of each part on a JSON line.

Exits non-zero without printing a result when no CUDA card is visible.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import filecmp
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, non-tensor fp32


# the command lines running now (run_command), which fail() ends with
# every process they started
RUNNING = set()


def descendants(pid: int) -> list:
    """The processes below ``pid``, read from /proc's stat files."""
    children = collections.defaultdict(list)
    for name in os.listdir("/proc"):
        try:
            with open(f"/proc/{name}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        children[ppid].append(int(name))
    out, todo = [], [pid]
    while todo:
        kids = children.get(todo.pop(), [])
        out += kids
        todo += kids
    return out


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    for proc in list(RUNNING):
        for pid in [proc.pid, *descendants(proc.pid)]:
            try:
                os.kill(pid, 9)
            except OSError:
                pass
    sys.exit(1)


def run_command(argv, cwd, timeout) -> subprocess.CompletedProcess:
    """``subprocess.run(argv, capture_output=True, text=True)`` with the
    repository on PYTHONPATH, whose process (and what it starts) fail()
    ends, from whichever thread fails first."""
    proc = subprocess.Popen(argv, cwd=cwd, env=repo_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    RUNNING.add(proc)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    finally:
        RUNNING.discard(proc)
    return subprocess.CompletedProcess(argv, proc.returncode, out, err)


def nvidia_smi(every_card: bool = False):
    """The first card's name and power limit as nvidia-smi gives them (a
    line a card, as a list, with ``every_card``)."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return lines if every_card else lines[0]


SPIN_CYCLES, SPIN_MS = 35_000_000, 20.0  # ~20 ms of the card's clock


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call of fn. A spin kernel holds the card
    while the host queues the calls, so the events time the card's work
    back to back and not the host's launch overhead (which exceeds a small
    call's kernel). The spin must outlast the queueing: where the start
    event has already fired when the last call is queued, the card waited
    for the host, and the reading is taken again with a spin twice as long
    (printed). Where the queueing grows with the spin, the calls wait for
    the card themselves (a plain version's host reads), the card never
    waits for the host, and the reading stands."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin, queued = SPIN_CYCLES, None
    for _ in range(6):
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        grew = queued is not None and queued_ms - queued > SPIN_MS * spin / SPIN_CYCLES / 4
        if covered or grew:
            break
        print(f"time_ms: the spin of {spin} cycles ended before the host had queued {iters} "
              f"calls ({queued_ms:.2f} ms of queueing, {start.elapsed_time(end) / iters:.4f} ms "
              f"a call read); again with {2 * spin}", flush=True)
        spin, queued = 2 * spin, queued_ms
    return start.elapsed_time(end) / iters


def sass_counts(library: str, opcode: str) -> dict:
    """Instructions of one opcode (HGMMA: wgmma; HMMA: mma.sync) in a built
    library's SASS, by function (every function listed, 0 where none)."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", library], check=True, capture_output=True, text=True,
                          timeout=300).stdout
    counts, fn, op = {}, "", re.compile(rf"\b{opcode}\b")
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts.setdefault(fn, 0)
        elif fn and op.search(line):
            counts[fn] += 1
    return counts


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


def flash_libraries():
    """K2's and K3's libraries with their sizing entries bound."""
    from faceformer_tpu_torch.ops import _build

    flash_lib = _build.load("flash")
    flash_lib.flash_smem_bytes.argtypes = [ctypes.c_int] * 3
    flash_lib.flash_smem_bytes.restype = ctypes.c_size_t
    k3_lib = _build.load("flash_bwd")
    k3_lib.flash_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    k3_lib.flash_bwd_smem_bytes.restype = ctypes.c_size_t
    k3_lib.flash_bwd_workspace_bytes.argtypes = [ctypes.c_int] * 7
    k3_lib.flash_bwd_workspace_bytes.restype = ctypes.c_size_t
    return flash_lib, k3_lib


def time_flash_call(label, q, k, v, do, bias, causal, flash_lib, k3_lib):
    """K3 (and K2 with dropout) at one training shape, bf16, dropout on:
    kernel, plain version, the library's one-call yardstick (its forward
    with the same mask and dropout; ``autograd.grad`` through it) and the
    card's bound; K3 held to its bf16 gates against the plain version,
    bitwise repeatable, its dv moved by another seed. Returns (K2's row,
    K3's row)."""
    import torch
    from faceformer_tpu_torch.ops.flash import flash_attention_bwd, flash_attention_fwd

    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf, dev, neg = q.dtype, q.device, float(np.finfo(np.float32).min)
    n3, sq, h, hd = q.shape
    sk = k.shape[1]
    kw = dict(causal=causal, dropout_rate=TRAIN_RATE, seed=1234)
    lse = flash_attention_fwd(q, k, v, bias, **kw)[1]
    got = flash_attention_bwd(q, k, v, bias, lse, do, **kw)
    caught, e_max, e_mean = k3_rejects(got, flash_attention_bwd(q, k, v, bias, lse, do,
                                                                impl="plain", **kw))
    repeat = all(torch.equal(a, b)
                 for a, b in zip(got, flash_attention_bwd(q, k, v, bias, lse, do, **kw)))
    moved = not torch.equal(got[2], flash_attention_bwd(q, k, v, bias, lse, do,
                                                        **{**kw, "seed": 1235})[2])
    print(f"[4] flash_bwd {label} bf16 dropout {TRAIN_RATE}: relative err max {e_max:.3g} mean "
          f"{e_mean:.3g} (<= {K3_BF16_MAX}, {K3_BF16_MEAN}); repeat bitwise equal {repeat}; "
          f"another seed moves dv {moved}", flush=True)
    if caught or not repeat or not moved:
        fail(f"K3 {label} bf16: beyond the gates, not repeatable or blind to the seed")
    del got
    fwd_ms = time_ms(lambda: flash_attention_fwd(q, k, v, bias, **kw), iters=5)
    fwd0_ms = time_ms(lambda: flash_attention_fwd(q, k, v, bias, causal=causal), iters=5)
    fwd_plain = time_ms(lambda: flash_attention_fwd(q, k, v, bias, impl="plain", **kw),
                        iters=2, warmup=1)
    ms = time_ms(lambda: flash_attention_bwd(q, k, v, bias, lse, do, **kw), iters=5)
    ms0 = time_ms(lambda: flash_attention_bwd(q, k, v, bias, lse, do, causal=causal), iters=5)
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
    # the (query, key) pairs the function needs: under the causal mask only
    # keys j <= i of query i (the kernels skip the tiles above the diagonal)
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    moved = nbytes(q, k, v, do, lse, bias) + nbytes(q, k, v)
    b, by = bound_ms(moved, 5 * 2.0 * n3 * h * pairs * hd, bf)
    fb, fby = bound_ms(nbytes(q, k, v, bias, q, lse), 2 * 2.0 * n3 * h * pairs * hd, bf)
    smem = k3_lib.flash_bwd_smem_bytes(1, sk, hd)
    work = k3_lib.flash_bwd_workspace_bytes(1, n3, sq, sk, h, hd, 1)
    k3_row = dict(ms=ms, ms_no_dropout=ms0, plain_ms=plain, library_ms=lib, bound_ms=b,
                  bound_by=by, smem_bytes=smem, workspace_bytes=work)
    k2_row = dict(ms=fwd_ms, ms_no_dropout=fwd0_ms, plain_ms=fwd_plain, library_ms=fwd_lib,
                  bound_ms=fb, bound_by=fby, smem_bytes=flash_lib.flash_smem_bytes(1, sk, hd))
    print(f"[4] flash_bwd {label} q({n3},{sq},{h},{hd}) k({n3},{sk}) bf16 dropout "
          f"{TRAIN_RATE}: kernel {ms:.4f} ms (dropout 0: {ms0:.4f}), plain {plain:.4f} ms, "
          f"library backward {lib:.4f} ms, bound {b:.5f} ms ({by}); dynamic shared memory "
          f"{smem} B a block, keep-bit workspace {work} B", flush=True)
    print(f"[4] flash_fwd {label} q({n3},{sq},{h},{hd}) k({n3},{sk}) bf16 dropout "
          f"{TRAIN_RATE}: kernel {fwd_ms:.4f} ms (dropout 0: {fwd0_ms:.4f}), plain "
          f"{fwd_plain:.4f} ms, library {fwd_lib:.4f} ms (same mask and dropout), bound "
          f"{fb:.5f} ms ({fby}); dynamic "
          f"shared memory {k2_row['smem_bytes']} B a block", flush=True)
    return k2_row, k3_row


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


def k4_pointer_phase(rng, dev, n, r, s, e):
    """K4's pointer phase alone (its last phase, on K1's kernel): fp32
    pointer rows against bf16 memory with the padding as an additive bias,
    the argmax and the gather of the winning rows, through the test entry
    ``pointer_argmax_gather``; beside the library's matmul + masked_fill +
    argmax + gather at the same shapes, and the bound."""
    import torch
    from faceformer_tpu_torch.decode import NEG
    from faceformer_tpu_torch.ops.pointer import pointer_argmax_gather

    rows = torch.as_tensor(rng.standard_normal((n, r, e)), dtype=torch.float32, device=dev)
    memory = torch.as_tensor(rng.standard_normal((n, s, e)), dtype=torch.bfloat16, device=dev)
    mask = padding(rng, n, s, dev)
    bias = torch.where(mask, NEG, 0.0).to(torch.float32)

    def library():
        logits = torch.matmul(rows, memory.transpose(1, 2).float())
        idx = logits.masked_fill(mask[:, None, :], NEG).argmax(-1)
        return torch.gather(memory, 1, idx[..., None].expand(-1, -1, e))

    b, by = bound_ms(nbytes(rows, memory, bias) + n * r * (4 + 2 * e), 2.0 * n * r * s * e,
                     torch.bfloat16)
    row = dict(ms=time_ms(lambda: pointer_argmax_gather(rows, memory, bias=bias)),
               library_ms=time_ms(library), bound_ms=b, bound_by=by)
    print(f"[4] K4 pointer phase rows ({n},{r},{e}) fp32, memory ({n},{s},{e}) bf16, bias, "
          f"gather: kernel {row['ms']:.4f} ms, library (matmul + masked_fill + argmax + "
          f"gather) {row['library_ms']:.4f} ms, bound {b:.5f} ms ({by})", flush=True)
    return row


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


def expect_launches(what, fwd, bwd, tag="[3]"):
    from faceformer_tpu_torch import ops

    got = (ops.LAUNCHES["flash_fwd"], ops.LAUNCHES["flash_bwd"])
    print(f"{tag} train {what}: launches flash_fwd {got[0]} (expected {fwd}), flash_bwd "
          f"{got[1]} (expected {bwd})", flush=True)
    if got != (fwd, bwd) or 0 in got:
        fail(f"train {what}: flash launches {got}, the configuration implies {(fwd, bwd)}")


def sync_free(fn):
    """``fn()`` under torch.cuda.set_sync_debug_mode("error"), where a call
    that waits for the card raises: (what fn returned, None), or (None, the
    error's text)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(), None
    except RuntimeError as err:
        return None, str(err).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)


def check_sync_free(tag: str, what: str, fn):
    """``sync_free(fn)`` for training steps, printed; fails the phase on a
    call inside them that waited for the card. Returns what fn returned."""
    out, err = sync_free(fn)
    print(f"{tag} {what} under torch.cuda.set_sync_debug_mode('error'): "
          f"{'no call waited for the card' if err is None else err}", flush=True)
    if err is not None:
        fail(f"{tag} {what}: a call waited for the card: {err}")
    return out


def timed_step(model, optimizer, batch, generator, cfg):
    """The calls of ``train_step`` with CUDA events between them: ms of
    (forward + loss, backward, the skip flag and Adam)."""
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
    optimizer.found_inf = (~torch.isfinite(loss.detach())).float()
    optimizer.step()
    del optimizer.found_inf
    ev[3].record()
    torch.cuda.synchronize()
    return tuple(ev[i].elapsed_time(ev[i + 1]) for i in range(3))


def run_training(cfg, rng, seed, samples, dev):
    """The training path at the `ours` width. Returns the flash launch
    counts of the ten dropout-free bf16 steps (the main-path run), and the
    samples/s with remat off and full."""
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
    # the skip happens on the card: neither this step nor one that steps
    # waits for it
    loss, _ = check_sync_free("[3]", "train_step, the NaN step",
                              lambda: train_step(model, optimizer, bad, dgen, tcfg))
    after = optimizer.state_dict()["state"]
    same = (all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
            and after.keys() == state.keys()
            and all(torch.equal(after[i][k], v) if torch.is_tensor(v) else after[i][k] == v
                    for i, slot in state.items() for k, v in slot.items()))
    print(f"[3] train NaN planted in the input: loss {float(loss)}, parameters and Adam state "
          f"(moments, step counts) bitwise unchanged: {same}", flush=True)
    if bool(torch.isfinite(loss)) or not same:
        fail("train: the NaN step did not leave parameters and Adam state unchanged")

    check_sync_free("[3]", f"train_step, bf16 dropout {mc.dropout}",
                    lambda: train_step(model, optimizer, batch, dgen, tcfg))

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
        return len(samples) / step_s

    rates = {"remat off": measure("remat off")}
    profile_call("train step (remat off)",
                 lambda: train_step(model, optimizer, batch, dgen, tcfg), top=12)
    # the flagship recipe's rows a card: the card's busy time a step (the
    # fit's span counts the card's waits for the host as well)
    rows8 = {k: v[:8] for k, v in batch.items()}
    train_step(model, optimizer, rows8, dgen, tcfg)
    profile_call("3 train steps back to back at N=8 (remat off)",
                 lambda: [train_step(model, optimizer, rows8, dgen, tcfg) for _ in range(3)])
    model.cfg = dataclasses.replace(mc, remat=True)
    ops.reset_launches()
    loss, _ = train_step(model, optimizer, batch, dgen, tcfg)
    expect_launches("1 step, remat full", 2 * per_step, per_step)
    if not bool(torch.isfinite(loss)):
        fail("train: non-finite loss with remat")
    rates["remat full"] = measure("remat full")
    model.cfg = mc
    return main_launches, rates


# ---------------------------------------------------------------------------
# phase 5: the command line at the `ours` width
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
MAIN = "faceformer_tpu_torch.main"
DEMOS = "faceformer_tpu_torch.tools.train_demos"
CLI_CONFIG = os.path.join(REPO, "configs", "synthetic-big.yml")
RANK_STATS_DIR = "rank_stats"  # counted_rank's files, under a command line's cwd
# the corpus of synthetic-big.yml cut from 8,192 solids to 352: the seeded
# 0.93 / 0.02 / 0.05 split then gives 327 / 7 / 18, 10 steps an epoch
CLI_NUM, CLI_SPLIT = 352, (327, 7, 18)
CLI_GEN = ("--num", str(CLI_NUM), "--seed", "1", "--profile", "rich", "--max_edges", "216",
           "--max_faces", "42", "--max_face_len", "36")
RECORD_KEYS = {"edges", "dominant_directions", "pred_faces", "label_faces"}
# The oracle lift of that corpus (each solid's label faces in place of its
# prediction, through both exporters), counted once on a CPU host by the
# JAX package with scipy 1.17.0: tests/torch_recon_helpers.py's docstring
# gives the two commands (with --num 352). Both exporters drop the same 10
# solids, whose label faces are plane+other.
ORACLE_LIFTED = {"ply": 342, "obj": 342}
ORACLE_DROPPED = ("00000047", "00000117", "00000131", "00000135", "00000159", "00000170",
                  "00000188", "00000254", "00000257", "00000296")
LIFT_CORES = 4  # the reconstruction command lines over the test split
# share of test JSONs whose pred_faces agree between the bf16 fused and
# causal_cache engines after the 20-step fit: different summation orders
# may flip near-tied tokens, and one flipped token changes a face. Read
# 1.0000 on an H100 (PERF.md); the faces each engine predicts are printed
# beside it
CLI_AGREE_MIN = 0.9

# Runs in each subprocess: counts set to 0, one module's command line, then
# the counts, the peak device memory and the host seconds spent in
# reconstruction.wireframe.reconstruct_file (predict --reconstruct's lift) on
# a line of their own. The ranks a multi-rank command line starts each
# write theirs to RANK_STATS_DIR under the working directory
# (``counted_rank``).
CLI_WRAPPER = """
import json, os, runpy, sys, time
import torch
import chip_smoke
from faceformer_tpu_torch import ops
from faceformer_tpu_torch.parallel import mesh
ops.reset_launches()
os.environ["CHIP_SMOKE_RANK_STATS"] = os.path.abspath(chip_smoke.RANK_STATS_DIR)
spawn = mesh.spawn
mesh.spawn = lambda size, fn, *args: spawn(size, chip_smoke.counted_rank, fn, *args)
sys.argv = sys.argv[1:]
lift = [0.0]
if "--reconstruct" in sys.argv:
    from faceformer_tpu_torch.reconstruction import wireframe
    lift_file = wireframe.reconstruct_file
    def timed_lift(*args):
        t0 = time.perf_counter()
        try:
            return lift_file(*args)
        finally:
            lift[0] += time.perf_counter() - t0
    wireframe.reconstruct_file = timed_lift
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
peak = torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else 0
print("CLI_STATS " + json.dumps({"launches": ops.LAUNCHES, "max_memory_allocated": peak,
                                 "lift_seconds": lift[0]}))
"""

#: prediction JSON face types, as tools/recon_coverage.py names them
FACE_KIND = {0: "plane", 1: "cylinder", 2: "other"}


def pred_kind_set(rec: dict) -> str:
    """A record's predicted face kinds, joined (tools/recon_coverage.py)."""
    kinds = sorted({FACE_KIND.get(t, "?") for t, _f in rec["pred_faces"]})
    return "+".join(kinds) if kinds else "empty"


def kind_histogram(records) -> dict:
    """Records counted by their predicted face kinds."""
    return dict(sorted(collections.Counter(pred_kind_set(r) for r in records).items()))


def oracle_record(sample: dict, engine, mc) -> dict:
    """One corpus sample's prediction record with its label faces as the
    prediction, as the test loop writes a record: labels packed per anchor,
    then the metric engine's post-processing."""
    from faceformer_tpu_torch.data.packing import pack_label_parallel

    packed = pack_label_parallel(sample["faces_indices"], mc)
    out = engine.evaluate_sample(packed["label"], packed["label"], sample)
    return {"edges": sample["edges"], "dominant_directions": sample["dominant_directions"],
            "pred_faces": out["predictions"], "label_faces": out["labels"]}


def write_oracle_record(syn: str, root: str, name: str) -> str:
    """oracle_record of corpus sample ``name`` (a file of ``syn``/json),
    written to ``root``/json as the test loop writes a record. Returns its
    face kinds (pred_kind_set)."""
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.train.metrics import FaceMetrics
    from faceformer_tpu_torch.train.trainer import NumpyJSONEncoder

    cfg = load_config(CLI_CONFIG)
    with open(os.path.join(syn, "json", name)) as f:
        record = oracle_record(json.load(f), FaceMetrics(cfg.post_process, cfg.model.token),
                               cfg.model)
    with open(os.path.join(root, "json", name), "w") as f:
        json.dump(record, f, cls=NumpyJSONEncoder)
    return pred_kind_set(record)


def repo_env() -> dict:
    """This process's environment with the repository on PYTHONPATH."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def run_cli(cwd, label, module, *argv, timeout=900, tag="[5]"):
    """``python -m module argv`` in a subprocess run from ``cwd`` (logs/
    lands there); fails on a non-zero exit. Returns (stdout, launch counts
    and peak memory, wall seconds)."""
    t0 = time.perf_counter()
    proc = run_command([sys.executable, "-c", CLI_WRAPPER, module, *argv], cwd, timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-6000:], proc.stderr[-6000:], sep="\n", flush=True)
        fail(f"{label}: exit code {proc.returncode}")
    stats = [line for line in proc.stdout.splitlines() if line.startswith("CLI_STATS ")]
    stats = json.loads(stats[-1][len("CLI_STATS "):])
    launched_now = {k: v for k, v in stats["launches"].items() if v}
    print(f"{tag} {label}: rc 0 in {wall:.1f} s, launches {launched_now}, max_memory_allocated "
          f"{stats['max_memory_allocated']}", flush=True)
    return proc.stdout, stats, wall


def run_demos(cwd, label, *argv, timeout=900, tag="[6]"):
    """``python -m faceformer_tpu_torch.tools.train_demos argv`` in a
    subprocess run from ``cwd``; fails on a non-zero exit. Returns (stdout,
    the ``STAGE`` records by stage: each stage's process counts its own
    launches and peak memory, phase by phase)."""
    t0 = time.perf_counter()
    proc = run_command([sys.executable, "-m", DEMOS, *argv], cwd, timeout)
    if proc.returncode != 0:
        print(proc.stdout[-6000:], proc.stderr[-6000:], sep="\n", flush=True)
        fail(f"{label}: exit code {proc.returncode}")
    records = [json.loads(line[len("STAGE "):]) for line in proc.stdout.splitlines()
               if line.startswith("STAGE ")]
    print(f"{tag} {label}: rc 0 in {time.perf_counter() - t0:.1f} s", flush=True)
    return proc.stdout, {r["stage"]: r for r in records}


def run_lift(cwd, label, exporter, root, cores=LIFT_CORES):
    """``python -m faceformer_tpu_torch.reconstruction.<exporter>`` over
    ``root``; fails on a non-zero exit. Returns (host seconds, the names
    written)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"faceformer_tpu_torch.reconstruction.{exporter}",
                           "--root", root, "--num_cores", str(cores)], cwd=cwd, env=repo_env(),
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-6000:], proc.stderr[-6000:], sep="\n", flush=True)
        fail(f"{label}: exit code {proc.returncode}")
    subdir = "ply" if exporter == "wireframe" else "obj"
    return wall, {os.path.splitext(n)[0] for n in os.listdir(os.path.join(root, subdir))}


def lift_check_one(root: str, name: str) -> list:
    """One record of a lifted directory lifted again: its PLY must read
    back to the array written (each value at the writer's 10 significant
    digits), every point and OBJ vertex be finite, every OBJ face index lie
    within its vertices. Returns the faults found."""
    from faceformer_tpu_torch.reconstruction.io3d import read_ply_points
    from faceformer_tpu_torch.reconstruction.wireframe import reconstruct_wireframe

    bad = []
    with open(os.path.join(root, "json", name + ".json")) as f:
        points = reconstruct_wireframe(json.load(f))
    ply = os.path.join(root, "ply", name + ".ply")
    if (points is not None) != os.path.exists(ply):
        bad.append("lifted but no PLY" if points is not None else "PLY of an unliftable record")
    elif points is not None:
        written = np.array([[float(f"{v:.10g}") for v in p] for p in points])
        if not np.all(np.isfinite(points)):
            bad.append("PLY point not finite")
        if not np.array_equal(read_ply_points(ply), written):
            bad.append("PLY reads back to another array")
    obj = os.path.join(root, "obj", name + ".obj")
    if os.path.exists(obj):
        with open(obj) as f:
            rows = [line.split() for line in f]
        verts = np.array([[float(x) for x in r[1:]] for r in rows if r[0] == "v"])
        faces = [[int(i) for i in r[1:]] for r in rows if r[0] == "f"]
        if not len(verts) or not np.all(np.isfinite(verts)):
            bad.append("OBJ vertex not finite")
        if not faces or any(not 1 <= i <= len(verts) for face in faces for i in face):
            bad.append("OBJ face off its vertices")
    return bad


def check_lifted(label, root, pool):
    """lift_check_one over every record of a lifted directory, in ``pool``;
    fails on any fault."""
    import functools

    names = sorted(os.path.splitext(n)[0] for n in os.listdir(os.path.join(root, "json")))
    t0 = time.perf_counter()
    found = list(pool.map(functools.partial(lift_check_one, root), names, chunksize=8))
    faults = {n: b for n, b in zip(names, found) if b}
    print(f"[5] {label}: {len(names)} records lifted again and their files checked in "
          f"{time.perf_counter() - t0:.2f} s (host)", flush=True)
    if faults:
        fail(f"{label}: {len(faults)} lifted files at fault: {dict(list(faults.items())[:10])}")


def run_oracle_lift(tmp, syn, pool, cores):
    """Every corpus solid's label faces (records written by ``pool``'s
    workers) lifted by both command lines on ``cores``; fails unless the
    counts and dropped names are ORACLE_LIFTED's and ORACLE_DROPPED, and
    every file passes lift_check_one. Returns numbers."""
    import functools

    import scipy

    root = os.path.join(tmp, "oracle")
    os.makedirs(os.path.join(root, "json"))
    names = sorted(os.listdir(os.path.join(syn, "json")))
    t0 = time.perf_counter()
    kinds = dict(zip((os.path.splitext(n)[0] for n in names), pool.map(
        functools.partial(write_oracle_record, syn, root), names, chunksize=8)))
    build_s = time.perf_counter() - t0
    ply_s, ply = run_lift(tmp, "oracle wireframe lift", "wireframe", root, cores)
    obj_s, obj = run_lift(tmp, "oracle mesh lift", "mesh", root, cores)
    dropped = {k: tuple(n for n in kinds if n not in got) for k, got in (("ply", ply), ("obj", obj))}
    n = len(kinds)
    histogram = collections.Counter(kinds[k] for k in set(dropped["ply"]) | set(dropped["obj"]))
    numbers = {"solids": n, "ply": len(ply), "obj": len(obj),
               "records_build_seconds": build_s, "ply_seconds": ply_s, "obj_seconds": obj_s,
               "ply_solids_per_s": n / ply_s, "obj_solids_per_s": n / obj_s,
               "cores": cores, "scipy": scipy.__version__}
    print(f"[5] oracle lift of the {n} corpus solids on {nvidia_smi()} (host seconds, "
          f"{cores} cores, scipy {scipy.__version__}): ply {len(ply)} in {ply_s:.2f} s "
          f"({n / ply_s:.1f} solids/s), obj {len(obj)} in {obj_s:.2f} s "
          f"({n / obj_s:.1f} solids/s), records built in {build_s:.2f} s; dropped "
          f"{list(dropped['ply'])} (ply), {list(dropped['obj'])} (obj), by label face kind "
          f"{dict(sorted(histogram.items()))}", flush=True)
    if n != CLI_NUM:
        fail(f"oracle lift: {n} records, expected {CLI_NUM}")
    if {"ply": len(ply), "obj": len(obj)} != ORACLE_LIFTED or \
            dropped["ply"] != ORACLE_DROPPED or dropped["obj"] != ORACLE_DROPPED:
        fail(f"oracle lift: counts or dropped names differ from the JAX package's "
             f"{ORACLE_LIFTED}, {list(ORACLE_DROPPED)} (scipy {scipy.__version__} here)")
    check_lifted("oracle lift", root, pool)
    return numbers


#: an epoch record's seconds split (train/trainer.py::Harness.fit)
FIT_SPLIT = ("train_host_batch_seconds", "train_host_dispatch_seconds",
             "train_step_span_seconds")


def fit_split_ms(record: dict, steps: int) -> dict:
    """An epoch record's split as ms a step: the host's in the batch
    iterator and upload, in queueing the steps, and the steps' span on the
    card's stream (CUDA events; the card's idle gaps while the host queues
    included), beside the epoch's wall a step."""
    keys = ("epoch_train_seconds",) + FIT_SPLIT
    return {k.replace("_seconds", "_ms"): record[k] * 1e3 / steps for k in keys}


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def read_records(json_dir, count):
    """The prediction JSONs of a test run as {name: bytes}; fails unless
    there are ``count`` of them, each with exactly the four keys."""
    names = sorted(os.listdir(json_dir))
    if len(names) != count:
        fail(f"{json_dir}: {len(names)} prediction JSONs, expected {count}")
    out = {}
    for name in names:
        with open(os.path.join(json_dir, name), "rb") as f:
            out[name] = f.read()
        keys = set(json.loads(out[name]))
        if keys != RECORD_KEYS:
            fail(f"{name}: keys {sorted(keys)}, expected {sorted(RECORD_KEYS)}")
    return out


def run_lift_phase(tmp, syn, ckpt, cache, cache_dir):
    """``tools.predict --reconstruct`` on the test split's wireframes, both
    reconstruction command lines over the causal_cache test's JSONs
    (``cache``: {file name: bytes}, in ``cache_dir``), then the oracle lift
    of the corpus. Fails unless predict's PLYs equal the wireframe command
    line's wherever the two runs' faces agree, and every lifted file passes
    lift_check_one (in a spawned pool of every core: this process holds a
    CUDA context). Returns numbers for the summary line."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    stem = {k: os.path.splitext(k)[0] for k in cache}
    pred_in = os.path.join(tmp, "pred_in", "json")
    os.makedirs(pred_in)
    for name in cache:
        shutil.copy(os.path.join(syn, "json", name), pred_in)
    out, st, _ = run_cli(tmp, "predict --reconstruct", "faceformer_tpu_torch.tools.predict",
                         "--config", CLI_CONFIG, "--ckpt", ckpt, "--root",
                         os.path.dirname(pred_in), "--reconstruct")
    pred_dir = os.path.join(os.path.dirname(pred_in), "pred")
    preds = read_records(os.path.join(pred_dir, "json"), CLI_SPLIT[2])
    agreed = [k for k in preds if json.loads(preds[k])["pred_faces"]
              == json.loads(cache[k])["pred_faces"]]
    print(f"[5] predict: share of JSONs whose pred_faces equal the causal_cache test's "
          f"{len(agreed) / len(preds):.4f}", flush=True)
    decoded = re.search(r"^decoded \d+ samples in ([0-9.]+)s", out, re.M)
    lifted = re.search(r"^reconstructed (\d+)/(\d+) wireframes -> ", out, re.M)
    plys = {}
    for name in os.listdir(os.path.join(pred_dir, "ply")):
        with open(os.path.join(pred_dir, "ply", name), "rb") as f:
            plys[os.path.splitext(name)[0]] = f.read()
    print(f"[5] predict --reconstruct: {len(plys)} PLYs written of {CLI_SPLIT[2]}, decode "
          f"{decoded and decoded.group(1)} s, lift {st['lift_seconds']:.3f} s (host)",
          flush=True)
    if (not decoded or not lifted or int(lifted.group(1)) != len(plys)
            or int(lifted.group(2)) != CLI_SPLIT[2]):
        fail("predict --reconstruct: no decode line, or its lift line disagrees with the "
             "PLYs on disk")

    # the reconstruction command lines over the causal_cache test's JSONs
    ply_s, ply = run_lift(tmp, "wireframe over the causal_cache test", "wireframe", cache_dir)
    obj_s, obj = run_lift(tmp, "mesh over the causal_cache test", "mesh", cache_dir)
    records = {k: json.loads(v) for k, v in cache.items()}
    print(f"[5] command lines over the causal_cache test's {len(cache)} JSONs "
          f"(--num_cores {LIFT_CORES}, host seconds): ply {len(ply)} in {ply_s:.2f} s, "
          f"obj {len(obj)} in {obj_s:.2f} s; dropped by predicted face kind "
          f"{kind_histogram(r for k, r in records.items() if stem[k] not in ply & obj)}, "
          f"all by predicted face kind {kind_histogram(records.values())}", flush=True)

    def cache_ply(k):
        if stem[k] not in ply:
            return None
        with open(os.path.join(cache_dir, "ply", stem[k] + ".ply"), "rb") as f:
            return f.read()

    differ = [stem[k] for k in agreed if plys.get(stem[k]) != cache_ply(k)]
    print(f"[5] predict --reconstruct against the wireframe command line: the PLYs of the "
          f"{len(agreed)} records whose faces agree byte-equal, except {differ}", flush=True)
    if differ:
        fail("predict --reconstruct and the wireframe command line wrote different PLYs")
    cores = len(os.sched_getaffinity(0))
    with ProcessPoolExecutor(cores, mp_context=multiprocessing.get_context("spawn")) as pool:
        check_lifted("the causal_cache test's lift", cache_dir, pool)
        oracle = run_oracle_lift(tmp, syn, pool, cores)
    return {"predict_decode_seconds": float(decoded.group(1)),
            "predict_lift_seconds": st["lift_seconds"],
            "lift_cli_seconds": {"ply": ply_s, "obj": obj_s},
            "oracle_lift": oracle}


def run_cli_phase(train_rates, syn):
    """Fit, test, validate, resume and predict through the port's command
    lines at the `ours` width (synthetic-big.yml) on the corpus ``syn``
    (``make_cli_corpus``), each in a subprocess. Returns the kernels' launch
    counts summed over the fit and the test runs, and the phase's numbers."""
    import collections

    import torch
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.params import params_to_numpy
    from faceformer_tpu_torch.train.checkpoint import export_torch_state_dict, load_checkpoint
    from faceformer_tpu_torch.train.trainer import Harness

    total = collections.Counter()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        base = ("root_dir", syn, "trainer.name", "smoke")

        def log(version):
            return os.path.join(tmp, "logs", "smoke", version)

        ckpt_dir = os.path.join(log("v0"), "checkpoints")
        last = os.path.join(ckpt_dir, "last")

        # fit: two epochs, validate and checkpoint after each
        _, st, _ = run_cli(tmp, "fit (2 epochs)", MAIN, "--config-file", CLI_CONFIG, *base,
                           "trainer.version", "v0", "trainer.max_epochs", "2",
                           "trainer.checkpoint_period", "1", timeout=600)
        fit_stats = st
        total.update(st["launches"])
        records = read_jsonl(os.path.join(log("v0"), "metrics.jsonl"))
        losses = [(r["step"], r["train_loss"]) for r in records if "train_loss" in r]
        steps_per_epoch = CLI_SPLIT[0] // 32
        if [s for s, _ in losses] != list(range(1, 2 * steps_per_epoch + 1)):
            fail(f"fit: train_loss logged at steps {[s for s, _ in losses]}")
        if not all(x is not None and np.isfinite(x) for _, x in losses):
            fail("fit: a train_loss is not finite")
        e1 = float(np.mean([x for s, x in losses if s <= steps_per_epoch]))
        e2 = float(np.mean([x for s, x in losses if s > steps_per_epoch]))
        valid = [r for r in records if "valid_precision" in r]
        timing = [r for r in records if "epoch_train_seconds" in r]
        with open(os.path.join(ckpt_dir, "index.json")) as f:
            index = json.load(f)
        print(f"[5] fit: {len(losses)} finite train_loss, epoch means {e1:.4f} -> {e2:.4f}; "
              f"valid_precision {[r['valid_precision'] for r in valid]}; checkpoints "
              f"{sorted(os.listdir(ckpt_dir))}", flush=True)
        if not e2 < e1:
            fail("fit: epoch 2's mean loss is not below epoch 1's")
        if len(valid) != 2 or len(timing) != 2:
            fail(f"fit: {len(valid)} validations and {len(timing)} epoch timings, expected 2")
        if not os.path.isfile(last) or not index["top"]:
            fail("fit: no checkpoints/last or an empty top-k index")
        per_step = 6 + 2 * 6  # encoder, decoder self and cross
        n_steps = len(losses)
        if (st["launches"]["flash_bwd"] != n_steps * per_step
                or st["launches"]["flash_fwd"] < 2 * n_steps * per_step  # remat re-runs it
                or st["launches"]["pointer_argmax"] <= 0):
            fail(f"fit: launches {st['launches']}; K3 {n_steps * per_step} and K2 at least "
                 f"{2 * n_steps * per_step} expected, K1 in validation")

        # test `last` with each engine; the fused engine runs again on the
        # exported .ckpt below, and must write the same bytes
        tests = {}
        for version, mode in (("fused", "fused"), ("causal_cache", "causal_cache")):
            _, st, _ = run_cli(tmp, f"test last, decode.mode {mode}", MAIN, "--config-file",
                               CLI_CONFIG, "--test_ckpt", last, *base, "trainer.version",
                               f"test-{version}", "decode.mode", mode)
            total.update(st["launches"])
            with open(os.path.join(log(f"test-{version}"), "results.json")) as f:
                results = json.load(f)
            tests[version] = (read_records(os.path.join(log(f"test-{version}"), "json"),
                                           CLI_SPLIT[2]), results, st)
            want = "decode_step" if mode == "fused" else "pointer_argmax"
            other = "pointer_argmax" if mode == "fused" else "decode_step"
            if st["launches"][want] <= 0 or st["launches"][other] or not st["launches"]["flash_fwd"]:
                fail(f"test {mode}: launches {st['launches']}")
            print(f"[5] test {mode}: {results}", flush=True)
        fused, cache = tests["fused"][0], tests["causal_cache"][0]
        share = float(np.mean([json.loads(fused[k])["pred_faces"]
                               == json.loads(cache[k])["pred_faces"] for k in fused]))
        faces = {m: sum(len(json.loads(r)["pred_faces"]) for r in tests[m][0].values())
                 for m in ("fused", "causal_cache")}
        print(f"[5] test: share of JSONs whose pred_faces agree between fused and causal_cache "
              f"{share:.4f} (>= {CLI_AGREE_MIN}); faces predicted over the {CLI_SPLIT[2]} "
              f"solids {faces}", flush=True)
        if share < CLI_AGREE_MIN:
            fail("test: fused and causal_cache disagree on too many samples")

        _, st, _ = run_cli(tmp, "validate last", MAIN, "--config-file", CLI_CONFIG,
                           "--valid_ckpt", last, *base, "trainer.version", "valid")
        got = [r for r in read_jsonl(os.path.join(log("valid"), "metrics.jsonl"))
               if "valid_precision" in r]
        if len(got) != 1 or got[0]["valid_precision"] != valid[-1]["valid_precision"]:
            fail(f"validate last: {got} against the fit's last validation {valid[-1]}")

        # round trips: two loads of `last` in this process, then a reference
        # Lightning blob written from it
        cfg = load_config(CLI_CONFIG, list(base) + ["trainer.version", "v0"])
        harness = Harness(cfg, device="cuda")
        a, b = harness.load(last), harness.load(last)
        tree, _ = load_checkpoint(last)
        same = (all(torch.equal(v, b["model"].state_dict()[k]) and torch.equal(v.cpu(),
                                                                               tree["model"][k])
                    for k, v in a["model"].state_dict().items())
                and (a["epoch"], a["step"]) == (b["epoch"], b["step"])
                == (2, 2 * steps_per_epoch)
                and all(torch.equal(x, y) for i, slot in a["optimizer"].state_dict()["state"].items()
                        for x, y in zip(slot.values(),
                                        b["optimizer"].state_dict()["state"][i].values())))
        print(f"[5] Harness.load(last) twice: parameters and Adam state torch.equal, and equal "
              f"to the file: {same}; epoch {a['epoch']} step {a['step']}", flush=True)
        if not same:
            fail("Harness.load(last) is not repeatable")
        xckpt = os.path.join(tmp, "epoch=2-exported.ckpt")
        sd = export_torch_state_dict(params_to_numpy(a["model"]))
        torch.save({"epoch": 2, "global_step": 2 * steps_per_epoch,
                    "pytorch-lightning_version": "1.3.5",
                    "state_dict": collections.OrderedDict((k, torch.tensor(v))
                                                          for k, v in sd.items())}, xckpt)
        # read back through the port's loader: when the second fused run
        # below differs, this tells an export that differs from an engine
        # that does not repeat
        back = harness.load(xckpt)["model"].state_dict()
        exported = all(torch.equal(v, back[k]) for k, v in a["model"].state_dict().items())
        print(f"[5] the exported .ckpt read back: parameters torch.equal to last's: {exported}",
              flush=True)
        del harness, a, b, tree, back
        torch.cuda.empty_cache()

        # resume: epoch 3 only, steps 21-30
        n_before = len(records)
        _, st, _ = run_cli(tmp, "resume last, max_epochs 3", MAIN, "--config-file", CLI_CONFIG,
                           "--resume_ckpt", last, *base, "trainer.version", "v0",
                           "trainer.max_epochs", "3", timeout=600)
        new = read_jsonl(os.path.join(log("v0"), "metrics.jsonl"))[n_before:]
        steps = [r["step"] for r in new if "train_loss" in r]
        with open(last + ".meta.json") as f:
            meta = json.load(f)
        tree, _ = load_checkpoint(last)
        print(f"[5] resume: train_loss at steps {steps[0]}..{steps[-1]} ({len(steps)}), "
              f"sidecar epoch {meta['epoch']}, checkpoint epoch {tree['epoch']} step "
              f"{tree['step']}", flush=True)
        n = steps_per_epoch
        if (steps != list(range(2 * n + 1, 3 * n + 1)) or meta["epoch"] != 3
                or (tree["epoch"], tree["step"]) != (3, 3 * n)):
            fail("resume did not run epoch 3 alone")

        # the Lightning blob through --test_ckpt: a second fused run, whose
        # JSONs must equal the first's byte for byte (the engine repeats,
        # and the blob holds the same weights)
        _, st, _ = run_cli(tmp, "test the exported .ckpt, fused", MAIN, "--config-file",
                           CLI_CONFIG, "--test_ckpt", xckpt, *base, "trainer.version",
                           "test-lightning", "decode.mode", "fused")
        same = read_records(os.path.join(log("test-lightning"), "json"), CLI_SPLIT[2]) == fused
        print(f"[5] test the exported .ckpt, a second fused run: JSONs byte-identical to the "
              f"first's: {same}", flush=True)
        if not same:
            fail("the second fused run (the exported Lightning checkpoint) wrote different "
                 "JSONs: " + ("the fused engine does not repeat" if exported else
                              "the exported weights differ from last's"))

        # predict --reconstruct, the reconstruction command lines, the oracle lift
        lift_numbers = run_lift_phase(tmp, syn, xckpt, cache, log("test-causal_cache"))

        t2 = timing[1]
        numbers = {
            "fit_samples_per_s_epoch2": t2["train_samples_per_s"],
            "fit_split_ms_a_step_epoch2": fit_split_ms(t2, steps_per_epoch),
            "train_step_samples_per_s_remat_full": train_rates["remat full"],
            "epoch_seconds": [r["epoch_train_seconds"] for r in timing],
            **{key: [r[key] for r in timing] for key in FIT_SPLIT},
            "validate_seconds": [r["valid_seconds"] for r in timing],
            "validate_decode_seconds": [r["valid_decode_seconds"] for r in timing],
            "validate_metrics_seconds": [r["valid_metrics_seconds"] for r in timing],
            "test_avg_time_per_sample": {k: v[1]["avg_time_per_sample"]
                                         for k, v in tests.items()},
            "checkpoint_seconds": [r["checkpoint_seconds"] for r in timing],
            "checkpoint_bytes": timing[-1]["checkpoint_bytes"],
            "max_memory_allocated": {"fit": fit_stats["max_memory_allocated"],
                                     **{k: v[2]["max_memory_allocated"]
                                        for k, v in tests.items()}},
            "launches": {"fit": {k: v for k, v in fit_stats["launches"].items() if v},
                         **{k: {n: c for n, c in v[2]["launches"].items() if c}
                            for k, v in tests.items()}},
            **lift_numbers,
        }
        print(f"[5] cli numbers on {nvidia_smi()}: {json.dumps(numbers)}", flush=True)
    print(f"[5] the command-line phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(total), numbers


def make_cli_corpus(root: str, tag: str = "[5]") -> str:
    """[5]'s corpus (``tools.synthetic_data`` with CLI_GEN) under ``root``,
    which [7] and [12] train on again. Returns its directory."""
    syn = os.path.join(root, "syn")
    run_cli(root, "synthetic_data", "faceformer_tpu_torch.tools.synthetic_data",
            "--root", syn, *CLI_GEN, tag=tag)
    split = []
    for name in ("train.txt", "valid.txt", "test.txt"):
        with open(os.path.join(syn, name)) as f:
            split.append(sum(1 for line in f if line.strip()))
    print(f"{tag} corpus: {CLI_NUM} rich solids, split train/valid/test {split}", flush=True)
    if tuple(split) != CLI_SPLIT:
        fail(f"corpus split {split}, expected {CLI_SPLIT}")
    return syn


# ---------------------------------------------------------------------------
# phase 6: the flat SurfaceFormer at the synthetic-dirtok-big width
# ---------------------------------------------------------------------------

FLAT_CONFIG = os.path.join(REPO, "configs", "synthetic-dirtok-big.yml")
# the corpus of synthetic-dirtok-big.yml (its header's generator flags) cut
# from 8,192 solids to 350: the seeded split gives 325 / 7 / 18, 10 steps an
# epoch at batch 32
FLAT_NUM, FLAT_SPLIT = 350, (325, 7, 18)
FLAT_GEN = ("--num", str(FLAT_NUM), "--seed", "3", "--profile", "rich", "--direction_token",
            "--max_edges", "110", "--max_faces", "42", "--max_label_len", "508")
# the corpus of synthetic-coedge-big.yml (its header's generator flags) cut
# from 8,192 solids to 128: the seeded split gives 119 / 2 / 7, 3 steps an
# epoch at batch 32. Each corpus lies at its config's root_dir under the
# command lines' working directory, so a command line that reads the
# config as written (diagnose_dirtok) finds it
COEDGE_CONFIG = os.path.join(REPO, "configs", "synthetic-coedge-big.yml")
COEDGE_NUM, COEDGE_SPLIT = 128, (119, 2, 7)
COEDGE_GEN = ("--num", str(COEDGE_NUM), "--seed", "4", "--profile", "rich", "--no_face_type",
              "--max_edges", "216", "--max_faces", "42", "--max_label_len", "258")
# K2 and K3 past their whole-row kernels' reach (label, n, sq, sk, causal,
# heads, hd, dead): the flat decoder self-attention's length, a ragged
# 1,000 keys off the 128-key tile, a causal 600 whose rows 0-69 of sample
# 1 and every row of sample 2 see no live key (long_key_inputs), and hd =
# 32 (d = 256 over 8 heads)
LONG_KEY_SHAPES = (("causal-512", 2, 512, 512, True, 8, 64, 0),
                   ("ragged-1000", 2, 300, 1000, False, 8, 64, 0),
                   ("causal-dead-600", 3, 600, 600, True, 8, 64, 70),
                   ("hd32-causal-1500", 1, 1500, 1500, True, 8, 32, 0))
# the three attention calls of the flat model's training step at N = 32
# (label, sequences, Sq, Sk, causal, sequences the plain side is run at)
FLAT_SHAPES = (("flat-encoder", 32, 116, 116, False, 32),
               ("flat-decoder-self", 32, 512, 512, True, 8),
               ("flat-cross", 32, 512, 116, False, 8))
# the same three calls of the coedge recipe's step
# (configs/synthetic-coedge-big.yml: S = 216 + 4 memory rows; T - 1 = 258
# targets padded to 264 keys, on the tensor-core key-tiled kernels with an
# 8-key last tile), checked against the config in run_flat_phase
COEDGE_SHAPES = (("coedge-encoder", 32, 220, 220, False, 32),
                 ("coedge-decoder-self", 32, 264, 264, True, 8),
                 ("coedge-cross", 32, 264, 220, False, 8))
# timed beside them: K2's and K3's key-tiled kernels near the JAX kernel's
# reach (a ragged causal key side of 2,000, 4 sequences of 8 heads)
LONG_TIMED = ("long-keys-2000", 4, 2000, 2000, True, 4)


def long_key_inputs(rng, dev, dtype, n, sq, sk, h, hd, dead=0):
    """q, k, v, do and a key-padding bias: sample 0 has every key, the
    others lose up to a quarter at the end. With ``dead`` (n >= 3) sample
    1 also loses its first ``dead`` keys, so its rows before them see no
    live key under the causal mask, and the last sample loses every key."""
    import torch
    from faceformer_tpu_torch.ops.flash import padding_mask_bias

    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    valid = rng.integers(sk - sk // 4, sk + 1, size=n)
    valid[0] = sk
    mask = torch.as_tensor(np.arange(sk)[None, :] >= valid[:, None], device=dev)
    if dead:
        mask[1, :dead] = True
        mask[-1] = True
    return (randn(n, sq, h, hd), randn(n, sk, h, hd), randn(n, sk, h, hd), randn(n, sq, h, hd),
            padding_mask_bias(mask.contiguous()))


def tiling_faults(tile, sk, causal):
    """Faults of a key-tiled kernel the gates must reject, made by editing
    what the kernel is given while the plain version keeps the truth:
    (label, dropout rate, edit(args) -> (args, fix(*outputs) or None))."""
    last = (sk - 1) // tile * tile

    def first_tile_dropped(a):
        bias = a["bias"].clone()
        bias[:, :tile] = float(np.finfo(np.float32).min)
        return {**a, "bias": bias}, None

    def last_tile_dropped(a):
        bias = a["bias"].clone()
        bias[:, last:] = float(np.finfo(np.float32).min)
        return {**a, "bias": bias}, None

    def keep_bits_shifted(a):
        # without a causal mask attention does not care where a key sits,
        # except for its keep bits: a kernel given keys rolled by one tile
        # draws each key's bits at the wrong j, as a kernel that used a
        # tile-local index would
        def roll(x):
            return x.roll(tile, dims=1).contiguous()

        def unroll(*outputs):
            if len(outputs) == 2:  # K2: out, lse do not depend on key order
                return outputs
            dq, dk, dv = outputs
            return dq, dk.roll(-tile, dims=1), dv.roll(-tile, dims=1)

        return {**a, "k": roll(a["k"]), "v": roll(a["v"]), "bias": roll(a["bias"])}, unroll

    faults = [("first key tile dropped", 0.0, first_tile_dropped),
              ("last key tile dropped", 0.0, last_tile_dropped)]
    if not causal:
        faults.append(("keep bits at the wrong key index", TRAIN_RATE, keep_bits_shifted))
    return faults


def k3_errors(got, want, per_sample=False):
    """K3's (largest, mean relative, largest absolute) error over dq, dk
    and dv: each tensor judged whole, or with ``per_sample`` each sample of
    each judged on its own, so that a sample whose rows see no live key
    (gradients in the thousands, p = 1 at every key) does not set the
    scale that judges the others (a few units)."""
    pairs = zip(got, want)
    if per_sample:
        pairs = [(a[i], b[i]) for a, b in pairs for i in range(a.shape[0])]
    errs = [rel_errors(a, b) for a, b in pairs]
    return tuple(max(e[i] for e in errs) for i in range(3))


def k3_rejects(got, want, per_sample=False):
    """(rejected by the bf16 gates, largest and mean relative error)."""
    e_max, e_mean, _ = k3_errors(got, want, per_sample)
    return not (e_max <= K3_BF16_MAX and e_mean <= K3_BF16_MEAN), e_max, e_mean


def check_long_keys(rng, dev, label, n, sq, sk, causal, h, hd, dead=0):
    """K2 and K3 past the whole-row kernels' reach against their plain
    versions, fp32 and bf16, dropout 0 and TRAIN_RATE: the gates of [2],
    the keep mask the forward applied bit for bit, bitwise repeatable,
    another seed moving K3's dv; in bf16 the tiling faults against the
    gates. With ``dead`` K3 is judged sample by sample (k3_errors).
    Returns the largest bf16 absolute errors (forward, backward; the
    backward's 0 with ``dead``, whose gradients near 4,000 would hide every
    other shape's)."""
    import torch
    from faceformer_tpu_torch.ops.flash import (flash_attention_bwd, flash_attention_fwd,
                                                key_tile, philox_keep_mask)

    seed = int(rng.integers(2 ** 62))
    worst_fwd = worst_bwd = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        tiles = (key_tile("fwd", dtype, sk, hd), key_tile("bwd", dtype, sk, hd))
        shape = (f"{label} q({n},{sq},{h},{hd}) k({n},{sk}) causal={causal} {dtype} "
                 f"(key tiles: K2 {tiles[0] or 'whole'}, K3 dq {tiles[1] or 'whole'})")
        q, k, v, do, bias = long_key_inputs(rng, dev, dtype, n, sq, sk, h, hd, dead)
        for rate in (0.0, TRAIN_RATE):
            kw = dict(causal=causal, dropout_rate=rate, seed=seed)
            out, lse = launched("flash_fwd", flash_attention_fwd, q, k, v, bias, **kw)
            out_p, lse_p = flash_attention_fwd(q, k, v, bias, impl="plain", **kw)
            again = flash_attention_fwd(q, k, v, bias, **kw)
            e_out = float((out.float() - out_p.float()).abs().max())
            e_lse = float((lse - lse_p).abs().max())
            tol = K2_BF16_TOL if bf16 else 1e-4
            wrong = 0
            if rate:
                kept, live = kernel_keep_mask(q, k, v, bias, causal, seed)
                plain_mask = philox_keep_mask(seed, n, h, sq, sk, rate, device=dev)
                wrong = int(((kept != plain_mask) & live).sum())
                del kept, live, plain_mask
            args = dict(q=q, k=k, v=v, bias=bias, lse=lse_p, dout=do, **kw)
            got = launched("flash_bwd", flash_attention_bwd, **args)
            want = flash_attention_bwd(**args, impl="plain")
            repeat = flash_attention_bwd(**args)
            torch.cuda.synchronize()
            e_max, e_mean, e_abs = k3_errors(got, want, per_sample=bool(dead))
            equal = (torch.equal(out, again[0]) and torch.equal(lse, again[1])
                     and all(torch.equal(a, b) for a, b in zip(got, repeat)))
            print(f"[6] long keys {shape} dropout {rate}: K2 out err {e_out:.3g} lse err "
                  f"{e_lse:.3g} (<= {tol}); keep-mask entries off the plain mask {wrong}; K3 "
                  f"{'per-sample ' if dead else ''}relative err max {e_max:.3g} mean "
                  f"{e_mean:.3g} (<= {K3_BF16_MAX if bf16 else 1e-4}); repeats bitwise equal "
                  f"{equal}", flush=True)
            if not (e_out <= tol and e_lse <= tol):
                fail(f"K2 long keys {label} {dtype} dropout {rate}: beyond {tol}")
            if wrong:
                fail(f"K2 long keys {label} {dtype}: the kernel's keep mask is not the plain one")
            if bf16 and not (e_max <= K3_BF16_MAX and e_mean <= K3_BF16_MEAN) or (
                    not bf16 and not e_max <= 1e-4):
                fail(f"K3 long keys {label} {dtype} dropout {rate}: beyond the gates")
            if not equal or not all(torch.isfinite(g.float()).all() for g in got):
                fail(f"K2/K3 long keys {label} {dtype}: not repeatable or not finite")
            if rate and torch.equal(flash_attention_bwd(**{**args, "seed": seed + 1})[2], got[2]):
                fail(f"K3 long keys {label} {dtype}: another seed gave the same dv")
            if bf16:
                worst_fwd = max(worst_fwd, e_out, e_lse)
                worst_bwd = worst_bwd if dead else max(worst_bwd, e_abs)
            del out, lse, out_p, lse_p, again, got, want, repeat
        for kernel, tile in (("K2", tiles[0]), ("K3", tiles[1])):
            if not (bf16 and tile):
                continue
            for name, rate, edit in tiling_faults(tile, sk, causal):
                kw = dict(causal=causal, dropout_rate=rate, seed=seed)
                out_p, lse_p = flash_attention_fwd(q, k, v, bias, impl="plain", **kw)
                if kernel == "K2":
                    edited, fix = edit(dict(q=q, k=k, v=v, bias=bias, **kw))
                    got = flash_attention_fwd(**edited)
                    got = fix(*got) if fix else got
                    e = max(float((got[0].float() - out_p.float()).abs().max()),
                            float((got[1] - lse_p).abs().max()))
                    caught, line = e > K2_BF16_TOL, f"err {e:.3g} (gate {K2_BF16_TOL})"
                else:
                    args = dict(q=q, k=k, v=v, bias=bias, lse=lse_p, dout=do, **kw)
                    want = flash_attention_bwd(**args, impl="plain")
                    edited, fix = edit(args)
                    got = flash_attention_bwd(**edited)
                    got = fix(*got) if fix else got
                    caught, e_max, e_mean = k3_rejects(got, want, per_sample=bool(dead))
                    line = f"relative err max {e_max:.3g} mean {e_mean:.3g}"
                print(f"[6] {kernel} bf16 tiling fault '{name}' {label} (tile {tile} keys) "
                      f"dropout {rate}: {line}; "
                      f"{'rejected' if caught else 'PASSES THE GATE'}", flush=True)
                if not caught:
                    fail(f"{kernel} bf16 gates pass a kernel with '{name}' at {label}")
                del got, out_p, lse_p
        del q, k, v, do, bias
    return worst_fwd, worst_bwd


def flat_samples(rng, mc, count):
    """``count`` seeded direction-token solids of the rich profile that fit
    the config: at most num_lines edges, labels within label_seq_length."""
    from faceformer_tpu_torch.data.packing import pack_label_single
    from faceformer_tpu_torch.geometry.fixtures import random_sample

    samples = []
    while len(samples) < count:
        sample = random_sample(rng, profile="rich", direction_token=True)
        if len(sample["edges"]) > mc.num_lines:
            continue
        try:
            pack_label_single(sample["faces_indices"], mc)
        except ValueError:
            continue
        samples.append(sample)
    return samples


def flat_batch(samples, mc, dev, labels=True):
    import torch
    from faceformer_tpu_torch.data.batching import collate
    from faceformer_tpu_torch.data.dataset import ABCDataset
    from faceformer_tpu_torch.data.packing import pack_input_edges

    if labels:
        ds = ABCDataset.from_samples(samples, mc)
        items = [ds[i] for i in range(len(samples))]
    else:
        items = [pack_input_edges(s["edges"], mc) for s in samples]
    return {k: torch.as_tensor(v).to(dev) for k, v in collate(items).items()
            if not isinstance(v, (list, str))}


def run_flat_training(model, cfg, batch, seed):
    """The flat model's training step at the config's width: every
    gradient through the kernels against the plain versions (fp32, N = 2),
    then bf16 steps at N = 32 with dropout: samples/s over 5 timed steps
    after 2 warm-ups, the step's split by CUDA events, peak memory, launches
    and one profiled step. Returns (launches of the timed steps, samples/s)."""
    import torch
    from faceformer_tpu_torch import ops
    from faceformer_tpu_torch.train.loss import pointer_cross_entropy
    from faceformer_tpu_torch.train.step import make_optimizer, train_step

    mc = cfg.model
    per_step = mc.num_encoder_layers + 2 * mc.num_decoder_layers
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
            expect_launches("flat fp32 N=2 gradients through the kernels", per_step, per_step)
        grads[impl] = {name: p.grad.clone() for name, p in model.named_parameters()}
    errs, noise = {}, {}
    for name, g in grads["auto"].items():
        d = float((g - grads["plain"][name]).abs().max())
        if name.endswith("attn.k.bias"):
            noise[name] = max(d, float(g.abs().max()), float(grads["plain"][name].abs().max()))
        else:
            errs[name] = d / float(grads["plain"][name].abs().max())
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    print(f"[6] flat train fp32 N=2: loss {float(loss.detach()):.6f}; {len(errs)} gradient "
          f"leaves, kernels vs plain, largest relative error per leaf: "
          f"{', '.join(f'{k} {v:.3g}' for k, v in worst)} (gate 1e-3); key-bias leaves "
          f"{max(noise.values()):.3g} (gate 1e-5)", flush=True)
    if (max(errs.values()) > 1e-3 or max(noise.values()) > 1e-5
            or not all(torch.isfinite(g).all() for g in grads["auto"].values())):
        fail("flat train fp32: a gradient through the kernels differs from the plain versions")
    model.zero_grad(set_to_none=True)
    del grads

    tcfg = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, precision="bf16"))
    optimizer = make_optimizer(model, tcfg.trainer)
    dgen = torch.Generator().manual_seed(seed + 1)
    for _ in range(2):
        train_step(model, optimizer, batch, dgen, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    steps = 5
    t0 = time.perf_counter()
    losses = [train_step(model, optimizer, batch, dgen, tcfg)[0] for _ in range(steps)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = dict(ops.LAUNCHES)
    expect_launches(f"flat, {steps} bf16 steps, dropout {mc.dropout}", steps * per_step,
                    steps * per_step)
    for name, kernel in (("flash_fwd_tiled_tc", "K2's tensor-core key-tiled kernel"),
                         ("flash_bwd_tiled_tc", "K3's tensor-core key-tiled pair")):
        if launches[name] != steps * mc.num_decoder_layers:
            fail(f"flat train bf16: {launches[name]} launches of {kernel}, the decoder "
                 f"self-attention implies {steps * mc.num_decoder_layers}")
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        fail("flat train bf16: a loss is not finite")
    check_sync_free("[6]", f"flat train_step, bf16 dropout {mc.dropout}",
                    lambda: train_step(model, optimizer, batch, dgen, tcfg))
    split = np.mean([timed_step(model, optimizer, batch, dgen, tcfg) for _ in range(3)], axis=0)
    n = batch["label"].shape[0]
    rate = n / step_s
    print(f"[6] flat train N={n} bf16 dropout {mc.dropout} lr {tcfg.trainer.lr}: losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; samples/s={rate:.2f} "
          f"step_ms={step_s * 1e3:.2f} forward_ms={split[0]:.2f} backward_ms={split[1]:.2f} "
          f"optimizer_ms={split[2]:.2f} max_memory_allocated={peak} "
          f"launches={json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    profile_call("flat train step", lambda: train_step(model, optimizer, batch, dgen, tcfg),
                 top=10)
    return launches, rate


# The bf16 grids of a flat engine through the kernels and through the plain
# versions may part where a step's two best pointer logits lie closer than
# bf16 rounding elsewhere moves them (K2's tensor cores against the plain
# einsum in the encoder, six layers deep). The replay must write both
# grids. At each parting each path's own fp32 logits must prefer its own
# token (by at least -FLAT_OWN_MIN: K1 picks the argmax of the logits it is
# given, up to fp32 summation order) and by at most FLAT_TIE_MAX; on every
# step before a parting the two paths' logits may differ by at most
# FLAT_DIFF_MAX. Fixed limits, from the readings of
# ``chip_smoke.py --tie-readings`` (PERF.md §6), not from the run being
# checked: FLAT_TIE_MAX near the largest 99th percentile of the logit
# differences there (0.3052), FLAT_DIFF_MAX about twice their largest
# (0.4642).
FLAT_OWN_MIN = 1e-3
FLAT_TIE_MAX = 0.3
FLAT_DIFF_MAX = 1.0
# steps of the flat causal_cache decode that [6] profiles (of
# label_seq_length - 1 = 511): reading back the profiler's events of a
# whole decode (~295,000 kernels and as many host ops) took ~160 s of [6]
# on the H100's host, and of 128 steps ~43 s; the depth cut to make room
# for [7], and from 32 for [9]
FLAT_PROFILE_STEPS = 16
# steps of the flat decodes that [6]'s checks and [9] (h) run (of 511): the
# bf16 grids through the kernels and through the plain versions, their
# replays, and the fp32 grids. Past 256, so the reference engine's last
# bucket (264 keys) still runs K2's key-tiled kernels; the depth cut, with
# FLAT_PROFILE_STEPS from 32, to make room for [9]'s flat model, whose
# decodes under the split cost ~85 ms a step on the H100's host (~19 gloo
# collectives). The timed decodes still run all 511 steps
FLAT_CHECK_STEPS = 263


def flat_replay(model, mc, batch, forced, mode, impl):
    """The flat engine ``mode`` of decode.py::greedy_decode_single (bf16,
    retire_rows, early stop off) step for step through ``impl``, its calls
    in its order, but fed at each step the token of ``forced`` (N, T)
    where the engine feeds the one it wrote: on a row's prefix of
    ``forced`` each step is the engine's own. Returns the tokens it writes
    (N, T) and every step's fp32 pointer logits (T - 1, N, S), padded
    rows at -inf."""
    import torch
    from faceformer_tpu_torch.decode import (
        _cross_kv,
        _incremental_decoder_step,
        _prefix_buckets,
        _single_next,
    )
    from faceformer_tpu_torch.models import layers as L
    from faceformer_tpu_torch.models.common import encode, gather_memory_rows, masked_argmax

    dtype, tok, t_max = torch.bfloat16, mc.token, mc.label_seq_length
    with torch.no_grad():
        memory, pos, mask = encode(model, mc, batch["input"], batch["input_mask"], dtype,
                                   impl=impl)
        n, dev = memory.shape[0], memory.device
        query_pos = model.query_pos_table.to(dtype)
        tokens = torch.full((n, t_max), tok.PAD, dtype=torch.int32, device=dev)
        tokens[:, 0] = tok.SOS
        written = tokens.clone()
        eos = torch.zeros(n, dtype=torch.bool, device=dev)
        logits = torch.empty((t_max - 1, n, memory.shape[1]), device=dev)
        if mode == "causal_cache":
            cross_k, cross_v = _cross_kv(model, memory, pos, mc.num_head)
            shape = (n, t_max, mc.num_head, mc.num_model // mc.num_head)
            sk, sv = ([torch.zeros(shape, dtype=dtype, device=dev)
                       for _ in range(mc.num_decoder_layers)] for _ in range(2))
        buckets = _prefix_buckets(t_max)
        for step in range(t_max - 1):
            if mode == "causal_cache":
                x = gather_memory_rows(memory, tokens[:, step:step + 1])
                out = _incremental_decoder_step(model, mc, x, query_pos[step:step + 1], step,
                                                sk, sv, cross_k, cross_v, mask)[:, 0]
            else:
                bucket = next(b for b in buckets if step <= min(b - 2, t_max - 2))
                tgt = gather_memory_rows(memory, tokens[:, :bucket])
                prefix_pad = (torch.arange(bucket, device=dev) > step)[None, :]
                out = L.decoder_forward(
                    model.decoder, tgt, memory, query_pos[None, :bucket], pos,
                    num_head=mc.num_head, activation=mc.activation,
                    normalize_before=mc.normalize_before, tgt_key_padding_mask=prefix_pad,
                    memory_key_padding_mask=mask, impl=impl)[:, step]
            pointer_t = L.linear(model.project, out)  # (N, E)
            logits[step] = torch.einsum("nse,ne->ns", memory.float(), pointer_t.float()
                                        ).masked_fill(mask, float("-inf"))
            nxt, eos = _single_next(masked_argmax(memory, pointer_t, mask, impl=impl), eos,
                                    tok, True)
            written[:, step + 1] = nxt
            tokens[:, step + 1] = forced[:, step + 1]
    return written, logits


def flat_partings(model, mc, batch, g_k, g_p, mode):
    """Replays both bf16 decodes of one engine (``flat_replay``: through the
    kernels fed g_k, through the plain versions fed g_p), fails unless each
    replay writes its engine's grid, and returns (rows that part, each
    parting's pair of preferences: the kernels' logits for the kernels'
    token over the plain token, the plain logits for the plain token over
    the kernels'; and over every step before a parting, where both paths
    read the same prefix: the largest logit difference between the two
    paths (median, 99th percentile, max) and the share of steps whose two
    best logits lie within FLAT_TIE_MAX in either path)."""
    import torch

    w_k, l_k = flat_replay(model, mc, batch, g_k, mode, "auto")
    w_p, l_p = flat_replay(model, mc, batch, g_p, mode, "plain")
    if not (torch.equal(w_k, g_k) and torch.equal(w_p, g_p)):
        fail(f"flat {mode} bf16: the replay does not write the engine's grid (kernels "
             f"{torch.equal(w_k, g_k)}, plain versions {torch.equal(w_p, g_p)})")
    steps, n = l_k.shape[:2]
    differ = g_k != g_p
    parts = torch.where(differ.any(1), differ.int().argmax(1), steps + 1)  # first column
    shared = torch.arange(steps, device=g_k.device)[:, None] < parts[None, :] - 1  # (T-1, N)
    live = torch.isfinite(l_k)
    diff = (l_k - l_p).abs().where(live, torch.zeros_like(l_k)).amax(-1)[shared]
    near = torch.zeros_like(shared)
    for l in (l_k, l_p):
        top2 = l.topk(2, dim=-1).values
        near |= (top2[..., 0] - top2[..., 1]) <= FLAT_TIE_MAX
    q = torch.quantile(diff, torch.tensor([0.5, 0.99], device=diff.device))
    stats = dict(median=float(q[0]), p99=float(q[1]), max=float(diff.max()),
                 near_share=float(near[shared].float().mean()), steps=int(shared.sum()))
    found = []
    for row in differ.any(1).nonzero()[:, 0].tolist():
        t = int(parts[row])
        a, b = int(g_k[row, t]), int(g_p[row, t])
        found.append((float(l_k[t - 1, row, a] - l_k[t - 1, row, b]),
                      float(l_p[t - 1, row, b] - l_p[t - 1, row, a])))
    return found, stats


def flat_tie_readings(seeds, dev):
    """``--tie-readings``: the readings FLAT_TIE_MAX and FLAT_DIFF_MAX are
    set from. [6]'s flat model (same init) takes as many bf16 training steps
    as [6] takes before it serves (11; the pointer logits' scale, and with
    it bf16's noise, changes as the model trains), on 32 samples of seed 0;
    then, for each seed, 32 seeded samples decoded in bf16, early stop off,
    by both engines (causal_cache at N = 32, reference at N = 8) through the
    kernels and through the plain versions. Prints ``flat_partings``'
    readings as JSON lines; checks only that each replay writes its
    engine's grid."""
    import torch
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.models.surfaceformer import SurfaceFormer
    from faceformer_tpu_torch.params import jitter_affine_
    from faceformer_tpu_torch.train.step import make_optimizer, train_step

    cfg = load_config(FLAT_CONFIG)
    mc = cfg.model
    gen = torch.Generator().manual_seed(0)
    model = SurfaceFormer(mc, generator=gen, device=dev)
    jitter_affine_(model, gen)
    tcfg = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, precision="bf16"))
    optimizer = make_optimizer(model, tcfg.trainer)
    dgen = torch.Generator().manual_seed(1)
    batch = flat_batch(flat_samples(np.random.default_rng(0), mc, 32), mc, dev)
    losses = [float(train_step(model, optimizer, batch, dgen, tcfg)[0]) for _ in range(11)]
    print(json.dumps(dict(train_losses=losses)), flush=True)
    for seed in seeds:
        batch = flat_batch(flat_samples(np.random.default_rng(seed), mc, 32), mc, dev,
                           labels=False)
        for mode, n in (("causal_cache", 32), ("reference", 8)):
            part = {k: v[:n] for k, v in batch.items()}
            g_k, g_p = (model.forward_eval(part, precision="bf16", mode=mode, early_stop=False,
                                           impl=impl)["predict"] for impl in ("auto", "plain"))
            found, stats = flat_partings(model, mc, part, g_k, g_p, mode)
            print(json.dumps(dict(seed=seed, mode=mode, n=n,
                                  agreement=float((g_k == g_p).float().mean()),
                                  partings=found, **stats)), flush=True)


def run_flat_serving(model, mc, samples, dev):
    """Both engines of the flat model, early stop off (label_seq_length - 1
    steps): causal_cache timed at N = 32 (tokens/s, launches, one profiled
    decode), reference at N = 4; each engine's grid through the kernels
    against its grid through the plain versions over the first
    FLAT_CHECK_STEPS steps, equal in fp32 at N = 4, and in bf16 parting only
    at near-ties (``flat_partings``). The profiled decode runs the first
    FLAT_PROFILE_STEPS steps. Returns the launches of the timed decodes."""
    import torch
    from faceformer_tpu_torch import ops
    from faceformer_tpu_torch.decode import greedy_decode_single

    steps = mc.label_seq_length - 1
    checked = dataclasses.replace(mc, label_seq_length=FLAT_CHECK_STEPS + 1)

    def decode(batch, precision, mode, impl):
        return greedy_decode_single(model, checked, batch, precision=precision, mode=mode,
                                    early_stop=False, impl=impl)["predict"]

    launches = {}
    for mode, n in (("causal_cache", 32), ("reference", 4)):
        batch = flat_batch(samples[:n], mc, dev, labels=False)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        grid = model.forward_eval(batch, precision="bf16", mode=mode, early_stop=False)["predict"]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[mode] = dict(ops.LAUNCHES)
        if grid.shape != (n, mc.label_seq_length) or bool((grid[:, 1:] < 0).any()):
            fail(f"flat {mode}: grid {tuple(grid.shape)}")
        if launches[mode]["pointer_argmax"] != steps or not launches[mode]["flash_fwd"]:
            fail(f"flat {mode}: launches {launches[mode]}")
        print(f"[6] flat engine={mode} N={n} bf16 early stop off: {steps} steps in {dt:.4f} s, "
              f"tokens/s={n * steps / dt:.1f}, {dt / steps * 1e3:.3f} ms a step; launches "
              f"{json.dumps({k: v for k, v in launches[mode].items() if v})}", flush=True)
        if mode == "causal_cache":
            cut = dataclasses.replace(mc, label_seq_length=FLAT_PROFILE_STEPS + 1)
            profile_call(f"flat engine={mode} N={n}, its first {FLAT_PROFILE_STEPS} steps",
                         lambda: greedy_decode_single(model, cut, batch, precision="bf16",
                                                      mode=mode, early_stop=False), top=8)
        t1 = time.perf_counter()
        kernels, plain = (decode(batch, "bf16", mode, impl) for impl in ("auto", "plain"))
        t2 = time.perf_counter()
        found, stats = flat_partings(model, checked, batch, kernels, plain, mode)
        t3 = time.perf_counter()
        print(f"[6] flat engine={mode} bf16 kernels vs plain, the first {FLAT_CHECK_STEPS} "
              f"steps: cell agreement {float((kernels == plain).float().mean()):.6f}, "
              f"{len(found)} of {n} rows part; "
              f"both replays write their engine's grids; at each parting the kernels' and "
              f"the plain logits prefer their own token by "
              f"{', '.join(f'{a:.4g} and {b:.4g}' for a, b in found) or '-'} "
              f"(>= -{FLAT_OWN_MIN}, <= {FLAT_TIE_MAX}); over the {stats['steps']} steps "
              f"before a parting the two paths' logits differ by median {stats['median']:.4g}, p99 "
              f"{stats['p99']:.4g}, max {stats['max']:.4g} (<= {FLAT_DIFF_MAX}), and "
              f"{stats['near_share']:.4%} of them have their two best logits within "
              f"{FLAT_TIE_MAX}", flush=True)
        if any(min(a, b) < -FLAT_OWN_MIN for a, b in found):
            fail(f"flat {mode} bf16: a path picked a token its own logits do not prefer")
        if any(max(a, b) > FLAT_TIE_MAX for a, b in found):
            fail(f"flat {mode} bf16: the kernels and the plain versions part at a clear token")
        if stats["max"] > FLAT_DIFF_MAX:
            fail(f"flat {mode} bf16: the kernels' and the plain pointer logits differ by "
                 f"{stats['max']:.4g} on a shared prefix")
        small = {k: v[:4] for k, v in batch.items()}
        g32 = {impl: decode(small, "fp32", mode, impl) for impl in ("auto", "plain")}
        same = torch.equal(g32["auto"], g32["plain"])
        print(f"[6] flat engine={mode} fp32 N=4, the first {FLAT_CHECK_STEPS} steps: grid "
              f"through the kernels equals the plain versions' {same}; seconds: the timed and "
              f"profiled decodes {t1 - t0:.1f}, the bf16 decodes through the kernels and the "
              f"plain versions {t2 - t1:.1f}, the two replays {t3 - t2:.1f}, the fp32 grids "
              f"{time.perf_counter() - t3:.1f}", flush=True)
        if not same:
            fail(f"flat {mode} fp32: the kernels' grid differs from the plain versions'")
    return launches


def corpus_split(root: str) -> tuple:
    """The sample counts of a corpus's train, valid and test split files."""
    split = []
    for name in ("train.txt", "valid.txt", "test.txt"):
        with open(os.path.join(root, name)) as f:
            split.append(sum(1 for line in f if line.strip()))
    return tuple(split)


def check_diagnosis(tmp: str, ckpt: str, out: str) -> dict:
    """``tools.diagnose_dirtok`` on the direction-token checkpoint ``ckpt``
    over the test split, on the card: the counts hold together, and K1 and
    K2 were launched, K4 not. Returns its launch counts."""
    from faceformer_tpu_torch.tools.diagnose_dirtok import COUNT_KEYS

    _, stats, _ = run_cli(tmp, "diagnose_dirtok (the tested checkpoint)",
                          "faceformer_tpu_torch.tools.diagnose_dirtok", "--ckpt", ckpt,
                          "--config", FLAT_CONFIG, "--out", out, tag="[6]")
    with open(out) as f:
        d = json.load(f)[-1]
    counts = {k: d[k] for k in (*COUNT_KEYS, "filter_drop_rate")}
    print(f"[6] diagnose_dirtok: {json.dumps(counts)}", flush=True)
    if not (d["samples"] == FLAT_SPLIT[2] and d["pred_kept"] <= d["pred_raw"]
            and d["kept_matches_label"] <= d["pred_kept"]
            and d["dropped_but_matches_label"] <= d["pred_raw"] - d["pred_kept"]):
        fail(f"diagnose_dirtok: counts {d}")
    launches = stats["launches"]
    if (launches.get("pointer_argmax", 0) <= 0 or launches.get("flash_fwd", 0) <= 0
            or launches.get("decode_step")):
        fail(f"diagnose_dirtok: launches {launches}")
    return launches


def planted_rows(labels: np.ndarray, tok) -> np.ndarray:
    """Label rows with the first pair's direction bit flipped and the last
    face cut off (its SEP made the EOS): a slip and a skipped face a row."""
    out = np.array(labels)
    for row in out:
        if row[2] in (tok.DIR0, tok.DIR1):
            row[2] = tok.DIR0 + tok.DIR1 - row[2]
        eos = int(np.argmax(row == tok.EOS))
        seps = np.flatnonzero(row[:eos] == tok.SEP)
        if len(seps):
            row[seps[-1]], row[seps[-1] + 1:] = tok.EOS, tok.PAD
    return out



def planted_counts(root: str, device: str = "cuda") -> dict:
    """``diagnose_dirtok.count_sample`` over the test split of the
    direction-token corpus at ``root``, its decodes planted: each label row
    passed back ("label"), then ``planted_rows`` of it ("planted"). A
    one-epoch checkpoint emits no face, so these are the diagnosis's counts
    that are not 0 in the script. Returns the two sums; fails unless the
    label rows keep every face and the planted ones lose one face a row to
    the cut and drop only faces that match a label."""
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.tools.diagnose_dirtok import COUNT_KEYS, count_sample
    from faceformer_tpu_torch.train.trainer import Harness

    cfg = dataclasses.replace(load_config(FLAT_CONFIG), root_dir=root)
    tok, tol = cfg.model.token, cfg.post_process.enclosedness_tol
    ds = Harness(cfg, device=device).dataset("test")
    sums = {kind: dict.fromkeys(COUNT_KEYS, 0) for kind in ("label", "planted")}
    cut = 0
    for i in range(len(ds)):
        item = ds[i]
        labels = np.asarray(item["label"])
        raw = ds.raw_datas[item["id"]]
        planted = planted_rows(labels[None], tok)[0]
        cut += int((labels == tok.SEP).sum() > (planted == tok.SEP).sum())
        for kind, row in (("label", labels), ("planted", planted)):
            for key, value in count_sample(row, labels, raw, tok, tol).items():
                sums[kind][key] += value
    a, b = sums["label"], sums["planted"]
    print(f"[6] diagnose_dirtok.count_sample over the {a['samples']} test solids, planted "
          f"decodes: label rows passed back {json.dumps(a)}; a direction bit flipped and the "
          f"last face cut a row ({cut} rows cut) {json.dumps(b)}", flush=True)
    if not (a["samples"] == b["samples"] == len(ds) > 0 and a["label"] > 0
            and a["pred_raw"] == a["pred_kept"] == a["kept_matches_label"] == a["label"]
            and a["dropped_but_matches_label"] == 0):
        fail(f"diagnose_dirtok.count_sample on label rows: {a}")
    if not (b["label"] == a["label"] and b["pred_raw"] == a["label"] - cut
            and 0 < b["dropped_but_matches_label"] == b["pred_raw"] - b["pred_kept"]
            and b["kept_matches_label"] == b["pred_kept"]):
        fail(f"diagnose_dirtok.count_sample on planted rows: {b}")
    return sums


def run_stage(tmp: str, stage: str, version: str, config: str, split: tuple, *overrides):
    """``tools.train_demos run <stage> <overrides>`` for one epoch at
    checkpoint_period 1, from ``tmp``: the STAGE record names ``version``;
    finite train_loss at steps 1 .. the epoch's; one validation, its
    timing and checkpoints/last; the tested checkpoint is the one
    ``best_path`` names, the scored epoch 1 and not ``last``;
    results.json is the stage's, over the test split; K3 once a layer a
    step and K2 as often or more in the fit, K1 in its validation; K1 and
    K2 and no K4 in the test. Returns (the STAGE record, the version's log
    directory, its metrics.jsonl records)."""
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.train.checkpoint import CheckpointManager

    cfg = load_config(config)
    mc = cfg.model
    log = os.path.join(tmp, "logs", cfg.trainer.name, version)
    _, stages = run_demos(tmp, f"train_demos run {stage} (fit 1 epoch, test best_path)", "run",
                          stage, *overrides, "trainer.max_epochs", "1",
                          "trainer.checkpoint_period", "1")
    record = stages.get(stage)
    if record is None or record["version"] != version:
        fail(f"train_demos: no STAGE record of {stage} as {version}")
    fit, test = record["fit"], record["test"]
    records = read_jsonl(os.path.join(log, "metrics.jsonl"))
    losses = [(r["step"], r["train_loss"]) for r in records if "train_loss" in r]
    valid = [r for r in records if "valid_precision" in r]
    timing = [r for r in records if "epoch_train_seconds" in r]
    steps = split[0] // cfg.batch_size_train
    per_step = mc.num_encoder_layers + 2 * mc.num_decoder_layers
    best = CheckpointManager(os.path.join(log, "checkpoints")).best_path()
    tested = record["tested_ckpt"]
    results_path = os.path.join(log, "results.json")
    results = None
    if os.path.isfile(results_path):
        with open(results_path) as f:
            results = json.load(f)
    print(f"[6] train_demos {stage} (S={mc.num_lines + mc.token.length}, "
          f"T={mc.label_seq_length}): fit {fit['seconds']:.1f} s, train_loss "
          f"{' '.join(f'{x:.4f}' for _, x in losses)}, validations {len(valid)}, launches "
          f"{fit['launches']}, max_memory_allocated {fit['max_memory_allocated']}; tested "
          f"{os.path.basename(tested)} (best_path {os.path.basename(best)}) in "
          f"{test['seconds']:.1f} s, launches {test['launches']}, max_memory_allocated "
          f"{test['max_memory_allocated']}; {record['results']}", flush=True)
    if ([s for s, _ in losses] != list(range(1, steps + 1))
            or not all(np.isfinite(x) for _, x in losses)):
        fail(f"{stage} fit: train_loss at steps {[s for s, _ in losses]}, {steps} expected")
    if (len(valid) != 1 or len(timing) != 1
            or not os.path.isfile(os.path.join(log, "checkpoints", "last"))):
        fail(f"{stage} fit: no validation, epoch timing or checkpoints/last")
    if tested != best or not os.path.basename(tested).startswith("epoch=1-"):
        fail(f"train_demos {stage} tested {tested}, best_path {best}")
    if results != record["results"] or record["results"]["num_samples"] != split[2]:
        fail(f"train_demos {stage}: results.json {results}, the stage's {record['results']}")
    if (fit["launches"].get("flash_bwd") != steps * per_step
            or fit["launches"].get("flash_fwd", 0) < steps * per_step
            or fit["launches"].get("pointer_argmax", 0) <= 0
            or test["launches"].get("pointer_argmax", 0) <= 0
            or not test["launches"].get("flash_fwd") or test["launches"].get("decode_step")):
        fail(f"{stage}: launches fit {fit['launches']}, test {test['launches']}")
    return record, log, records


def run_coedge_stage(tmp: str) -> dict:
    """``tools.train_demos run coedge-s0`` on the cut coedge corpus at its
    config's width (run_stage). Returns the stage's launch counts."""
    from faceformer_tpu_torch.config import load_config

    syn = os.path.join(tmp, load_config(COEDGE_CONFIG).root_dir)
    run_cli(tmp, "synthetic_data --no_face_type (coedge)",
            "faceformer_tpu_torch.tools.synthetic_data", "--root", syn, *COEDGE_GEN, tag="[6]")
    if corpus_split(syn) != COEDGE_SPLIT:
        fail(f"coedge corpus split {corpus_split(syn)}, expected {COEDGE_SPLIT}")
    record, _, _ = run_stage(tmp, "coedge-s0", "torch-coedge-big-s0", COEDGE_CONFIG,
                             COEDGE_SPLIT)
    return dict(collections.Counter(record["fit"]["launches"])
                + collections.Counter(record["test"]["launches"]))


def run_flat_cli(host: dict):
    """The flat model through the command lines, each in a subprocess:
    ``tools.synthetic_data`` writes the cut direction-token corpus ([10]
    checks the host path on it into ``host``); ``tools.train_demos run
    dirtok-s0`` fits one epoch (validation with causal_cache and
    checkpoints after it) and tests the checkpoint ``best_path`` names
    (run_stage), and its ``summary`` reads the version back;
    ``tools.predict`` decodes four test wireframes; then, side by side on
    the card, ``tools.diagnose_dirtok`` reads the tested checkpoint
    (planted_counts holds its counting to decodes that emit faces) and
    ``tools.train_demos run coedge-s0`` fits and tests the coedge recipe
    on its own cut corpus. Returns (launch counts summed over the runs,
    numbers)."""
    import collections

    from faceformer_tpu_torch.config import load_config

    cfg = load_config(FLAT_CONFIG)
    total = collections.Counter()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_flat_") as tmp:
        syn = os.path.join(tmp, cfg.root_dir)
        run_cli(tmp, "synthetic_data --direction_token",
                "faceformer_tpu_torch.tools.synthetic_data", "--root", syn, *FLAT_GEN, tag="[6]")
        if corpus_split(syn) != FLAT_SPLIT:
            fail(f"flat corpus split {corpus_split(syn)}, expected {FLAT_SPLIT}")
        host["synthetic-dirtok-big"] = check_host_loader("[6]'s synthetic-dirtok-big corpus",
                                                         syn, FLAT_CONFIG)
        version = "torch-dirtok-big-s0"
        logs = os.path.join(tmp, "logs", cfg.trainer.name)
        record, log, records = run_stage(tmp, "dirtok-s0", version, FLAT_CONFIG, FLAT_SPLIT,
                                         "root_dir", syn)
        fit, test, results = record["fit"], record["test"], record["results"]
        tested = record["tested_ckpt"]
        total.update(fit["launches"])
        total.update(test["launches"])
        steps = FLAT_SPLIT[0] // cfg.batch_size_train
        timing = [r for r in records if "epoch_train_seconds" in r]
        out, _ = run_demos(tmp, "train_demos summary", "summary", version, "--log_root", logs)
        summary = json.loads(out.strip().splitlines()[-1])
        if (summary["n_seeds"] != 1 or summary["versions"] != {version: results}
                or summary["test_precision"]["mean"] != round(results["test_precision"], 4)
                or summary["num_samples"] != FLAT_SPLIT[2]):
            fail(f"train_demos summary: {summary}")
        print(f"[6] train_demos summary: {json.dumps(summary)}", flush=True)
        tested_json = read_records(os.path.join(log, "json"), FLAT_SPLIT[2])
        print(f"[6] flat test: {results}; faces predicted over the {FLAT_SPLIT[2]} solids "
              f"{sum(len(json.loads(r)['pred_faces']) for r in tested_json.values())}", flush=True)

        pred_in = os.path.join(tmp, "pred_in", "json")
        os.makedirs(pred_in)
        for name in sorted(tested_json)[:4]:
            shutil.copy(os.path.join(syn, "json", name), pred_in)
        _, pred, _ = run_cli(tmp, "predict (4 wireframes)", "faceformer_tpu_torch.tools.predict",
                             "--config", FLAT_CONFIG, "--ckpt", tested, "--root",
                             os.path.dirname(pred_in), tag="[6]")
        total.update(pred["launches"])
        preds = read_records(os.path.join(os.path.dirname(pred_in), "pred", "json"), 4)
        agree = all(json.loads(preds[k])["pred_faces"] == json.loads(tested_json[k])["pred_faces"]
                    for k in preds)
        print(f"[6] flat predict: 4 JSONs, pred_faces equal to the test's: {agree}", flush=True)
        if not agree or pred["launches"]["pointer_argmax"] <= 0:
            fail(f"flat predict: launches {pred['launches']}, faces agree {agree}")

        # the tested scored checkpoint stays; `last`, a copy of it, goes to
        # spare the disk the coedge stage's two
        os.remove(os.path.join(log, "checkpoints", "last"))
        # the diagnosis and the coedge stage share the card (their seconds
        # are the shared card's; every run above ran alone); a fail() in
        # either thread ends the other's command line (run_command)
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            coedge_run = pool.submit(run_coedge_stage, tmp)
            diagnosis = check_diagnosis(tmp, tested, os.path.join(log, "diagnose_dirtok.json"))
            planted_counts(syn)
            coedge = coedge_run.result()
        total.update(diagnosis)
        total.update(coedge)

        t = timing[0]
        numbers = {
            "fit_samples_per_s": t["train_samples_per_s"],
            "fit_split_ms_a_step": fit_split_ms(t, steps),
            "epoch_seconds": t["epoch_train_seconds"],
            "validate_decode_seconds": t["valid_decode_seconds"],
            "validate_metrics_seconds": t["valid_metrics_seconds"],
            "test_avg_time_per_sample": results["avg_time_per_sample"],
            "checkpoint_seconds": t["checkpoint_seconds"],
            "checkpoint_bytes": t["checkpoint_bytes"],
            "max_memory_allocated": {"fit": fit["max_memory_allocated"],
                                     "test": test["max_memory_allocated"]},
            "launches": {**{name: {k: v for k, v in st["launches"].items() if v}
                            for name, st in (("fit", fit), ("test", test), ("predict", pred))},
                         "diagnose_dirtok": {k: v for k, v in diagnosis.items() if v},
                         "coedge-s0": {k: v for k, v in coedge.items() if v}},
        }
        print(f"[6] flat cli numbers on {nvidia_smi()}: {json.dumps(numbers)}", flush=True)
    print(f"[6] the flat command-line runs took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return dict(total), numbers


def time_pointer_one_row(rng, dev, n, s, e):
    """K1 as the flat engines call it: one row a sample against n x s memory
    rows, bf16: kernel, plain, the library's matmul + masked_fill + argmax,
    bound."""
    import torch
    from faceformer_tpu_torch.ops.pointer import pointer_argmax

    bf = torch.bfloat16
    rows = torch.as_tensor(rng.standard_normal((n, 1, e)), dtype=bf, device=dev)
    memory = torch.as_tensor(rng.standard_normal((n, s, e)), dtype=bf, device=dev)
    mask = padding(rng, n, s, dev)
    neg = float(np.finfo(np.float32).min)

    def library():
        logits = torch.matmul(rows, memory.transpose(1, 2)).float()
        return logits.masked_fill(mask[:, None, :], neg).argmax(-1)

    b, by = bound_ms(nbytes(rows, memory, mask) + n * 4, 2.0 * n * s * e, bf)
    row = dict(ms=time_ms(lambda: pointer_argmax(rows, memory, mask)),
               plain_ms=time_ms(lambda: pointer_argmax(rows, memory, mask, impl="plain")),
               library_ms=time_ms(library), bound_ms=b, bound_by=by)
    print(f"[6] pointer_argmax flat step rows ({n},1,{e}) memory ({n},{s},{e}) bf16: kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} "
          f"ms, bound {b:.5f} ms ({by})", flush=True)
    return row


def run_flat_phase(seed, rng, dev, host: dict):
    """Phase 6. Returns (launches of the flat main paths, max bf16 errors by
    kernel, the timed rows the summary adds to K1, K2 and K3)."""
    import collections

    import torch
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.models.surfaceformer import SurfaceFormer
    from faceformer_tpu_torch.params import jitter_affine_

    t_phase = time.perf_counter()
    cfg = load_config(FLAT_CONFIG)
    mc = cfg.model
    h, hd, s = mc.num_head, mc.num_model // mc.num_head, mc.num_lines + mc.token.length
    print(f"[6] the flat SurfaceFormer at configs/synthetic-dirtok-big.yml: d={mc.num_model}, "
          f"{h} heads, FFN {mc.num_feedforward}, {mc.num_encoder_layers}+"
          f"{mc.num_decoder_layers} layers, num_lines {mc.num_lines} (S={s}), label_seq_length "
          f"{mc.label_seq_length}, tokens {mc.token}, batch {cfg.batch_size_train}, "
          f"{cfg.trainer.precision}, dropout {mc.dropout}, lr {cfg.trainer.lr}, decode "
          f"{cfg.decode.mode}", flush=True)
    err = collections.defaultdict(float)
    for label, n, sq, sk, causal, heads, dim, dead in LONG_KEY_SHAPES:
        e_fwd, e_bwd = check_long_keys(rng, dev, label, n, sq, sk, causal, heads, dim, dead)
        err["flash_fwd"], err["flash_bwd"] = max(err["flash_fwd"], e_fwd), max(err["flash_bwd"],
                                                                              e_bwd)
        if dim == 64:  # bf16 on the tensor-core key-tiled kernels
            err["flash_fwd_tiled_tc"] = max(err["flash_fwd_tiled_tc"], e_fwd)
            err["flash_bwd_tiled_tc"] = max(err["flash_bwd_tiled_tc"], e_bwd)
    coedge = load_config(COEDGE_CONFIG).model
    s_c, t_c = coedge.num_lines + coedge.token.length, -(-(coedge.label_seq_length - 1) // 8) * 8
    if [x[2:4] for x in COEDGE_SHAPES] != [(s_c, s_c), (t_c, t_c), (t_c, s_c)] or (
            coedge.num_head, coedge.num_model) != (h, mc.num_model):
        fail(f"COEDGE_SHAPES {COEDGE_SHAPES} are not {COEDGE_CONFIG}'s S {s_c}, T {t_c}")
    for label, n_full, sq, sk, causal, n_plain in FLAT_SHAPES + COEDGE_SHAPES:
        e_fwd, e_bwd = check_flash_train(rng, dev, label, n_full, sq, sk, causal, n_plain, h, hd)
        err["flash_fwd"], err["flash_bwd"] = max(err["flash_fwd"], e_fwd), max(err["flash_bwd"],
                                                                              e_bwd)
        if sk > 256:
            err["flash_fwd_tiled_tc"] = max(err["flash_fwd_tiled_tc"], e_fwd)
            err["flash_bwd_tiled_tc"] = max(err["flash_bwd_tiled_tc"], e_bwd)
    err["pointer_argmax"] = max(check_pointer(rng, dev, cfg.batch_size_train, 1, s, mc.num_model),
                                check_pointer(rng, dev, cfg.batch_size_train, 1, s_c,
                                              coedge.num_model))
    rows = {"pointer_argmax": {"flat-step": time_pointer_one_row(rng, dev, cfg.batch_size_train,
                                                                 s, mc.num_model)},
            "flash_fwd": {}, "flash_bwd": {}}
    flash_lib, k3_lib = flash_libraries()
    for label, n, sq, sk, causal, _ in FLAT_SHAPES + (LONG_TIMED,):
        inputs = train_attention_inputs(rng, dev, torch.bfloat16, label, n, sq, sk, h, hd)
        rows["flash_fwd"][label], rows["flash_bwd"][label] = time_flash_call(
            label, *inputs, causal, flash_lib, k3_lib)
        del inputs
    print(f"[6] kernels took {time.perf_counter() - t_phase:.1f} s", flush=True)

    gen = torch.Generator().manual_seed(seed)
    model = SurfaceFormer(mc, generator=gen, device=dev)
    jitter_affine_(model, gen)  # biases and LayerNorms off their init values
    t0 = time.perf_counter()
    samples = flat_samples(rng, mc, cfg.batch_size_train)
    batch = flat_batch(samples, mc, dev)
    print(f"[6] flat batch N={len(samples)}: seeded rich direction-token solids, "
          f"{int((~batch['label_mask'][:, 1:]).sum())} non-PAD target tokens, label lengths "
          f"{int((~batch['label_mask']).sum(1).min())}..{int((~batch['label_mask']).sum(1).max())}"
          f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    total = collections.Counter()
    t0 = time.perf_counter()
    launches, _ = run_flat_training(model, cfg, batch, seed)
    total.update(launches)
    print(f"[6] training took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for st in run_flat_serving(model, mc, samples, dev).values():
        total.update(st)
    print(f"[6] serving took {time.perf_counter() - t0:.1f} s", flush=True)
    del model, batch
    torch.cuda.empty_cache()
    cli_launches, _ = run_flat_cli(host)
    total.update(cli_launches)
    print(f"[6] the flat phase took {time.perf_counter() - t_phase:.1f} s; launches "
          f"{json.dumps({k: v for k, v in total.items() if v})}", flush=True)
    return dict(total), dict(err), rows


# ---------------------------------------------------------------------------
# phase 7: ranks (parallel/mesh.py), the remat policies, tools.profile
# ---------------------------------------------------------------------------

DP_STEPS = 2  # Adam steps of (a)
DP_LR = 1e-4
# (a)'s gates, set from the fp32 readings on the H100 (PERF.md): the
# two-rank losses within DP_LOSS_MAX of the one-rank ones, relative; the
# parameter updates within DP_UPDATE_MAX of each other, as ||p2 - p1|| /
# ||p1 - p0|| over every leaf but the attention key biases (their gradient
# is 0 but for rounding, so Adam's first update there is +-lr by the sign of
# rounding noise in either run). Planted faults are read beside them.
# Readings (NVIDIA H100 80GB HBM3, 700 W): loss 2.7e-6; update distance
# 1.8e-3, and 2.2e-3 between two single-process runs ([7] (c), the
# embedding gradient's atomic adds); the faults 0.052 and 0.33.
DP_LOSS_MAX = 1e-5
DP_UPDATE_MAX = 1e-2
REMAT_POLICIES = ("off", "full", "dots", "attn", "attn_ffn")


def dp_setup(seed, dev, remat=True, config="configs/ours.yml"):
    """[7] (a)'s configuration, model and batch at the `ours` width: fp32,
    dropout 0, remat full (fp32 at N = 32 without remat would not fit
    beside a second rank), lr DP_LR; 32 seeded wireframes with seeded face
    loops. The same in every process that calls it."""
    import torch
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel
    from faceformer_tpu_torch.params import jitter_affine_

    cfg = load_config(config)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout=0.0, remat=remat, remat_policy="full"),
        trainer=dataclasses.replace(cfg.trainer, precision="fp32", lr=DP_LR,
                                    scheduled_sampling=0.0))
    gen = torch.Generator().manual_seed(seed + 7)
    model = SurfaceFormerParallel(cfg.model, generator=gen, device=dev)
    jitter_affine_(model, gen)
    rng = np.random.default_rng(seed + 7)
    lines = cfg.model.num_lines  # 60..216 edges at the `ours` width
    batch = training_batch(rng, random_wireframes(rng, 32, min(60, lines // 2), min(216, lines)),
                           cfg.model, dev)
    return cfg, model, batch


def dp_params(model) -> dict:
    return {name: p.detach().clone() for name, p in model.named_parameters()}


def dp_steps(model, cfg, batch, world=None):
    from faceformer_tpu_torch.train.step import make_optimizer, train_step

    optimizer = make_optimizer(model, cfg.trainer)
    return [float(train_step(model, optimizer, batch, None, cfg, world=world)[0])
            for _ in range(DP_STEPS)]


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def deterministic(on: bool = True):
    """Torch's deterministic kernels (where ``on``): the gathers' backward
    adds atomically otherwise, and two runs part by ~1e-4 of a gradient
    leaf's magnitude ([7] (d)). Their warnings (cuBLAS's workspace, once an
    op) are silenced."""
    import torch

    if not on:
        yield
        return
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def dp_rank(seed: int, out_dir: str, device: str = "cuda",
            config: str = "configs/ours.yml", size: int = 2) -> None:
    """A rank of [7] (a) or [12] (a), one of ``size`` started by
    ``parallel.mesh.spawn``: DP_STEPS steps on rows r, r + W, ... of the
    batch; then the gradient all-reduce alone, timed; then the same steps
    under two planted faults (each rank on its own token mean with no
    all-reduce; DDP's mean of the ranks' means)."""
    import torch
    from faceformer_tpu_torch import ops
    from faceformer_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    world = mesh.make_mesh(size, device)
    cfg, model, batch = dp_setup(seed, world.device, config=config)
    rows = {k: v[world.rank::world.size].contiguous() for k, v in batch.items()}
    mesh.replicated(world, model)
    init = dp_params(model)
    out = {"rank": world.rank, "backend": world.backend, "rows": len(rows["label"]),
           "device": (torch.cuda.current_device() if world.device.type == "cuda" else None),
           "losses": dp_steps(model, cfg, rows, world)}
    out["params"] = {k: v.cpu() for k, v in dp_params(model).items()}
    grads = [p.grad for p in model.parameters()]
    out["allreduce_bytes"] = sum(g.numel() * g.element_size() for g in grads)
    mesh.all_reduce_(world, grads)  # warm
    sync(world.device)
    t0 = time.perf_counter()
    for _ in range(5):
        mesh.all_reduce_(world, grads)
    sync(world.device)
    out["allreduce_ms"] = (time.perf_counter() - t0) / 5 * 1e3

    real = mesh.all_reduce_

    def planted(world_, tensors, average):
        # the step's first all-reduce carries the label-token count alone:
        # left out, each rank divides by its own count (its own token mean)
        if len(tensors) == 1 or not average:
            return
        real(world_, tensors)
        for t in tensors:
            t /= world_.size

    out["faults"] = {}
    for fault, average in (("no all-reduce", False), ("mean of the ranks' means", True)):
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(init[name])
        mesh.all_reduce_ = (lambda w, t, a=average: planted(w, t, a))
        try:
            dp_steps(model, cfg, rows, world)
        finally:
            mesh.all_reduce_ = real
        out["faults"][fault] = {k: v.cpu() for k, v in dp_params(model).items()}
    out["launches"] = dict(ops.LAUNCHES)  # the rank's, from its start
    torch.save(out, os.path.join(out_dir, f"rank{world.rank}.pt"))


def dp_distance(got: dict, want: dict, init: dict) -> float:
    """||got - want|| / ||want - init|| over every leaf but the attention
    key biases."""
    num = den = 0.0
    for name, w in want.items():
        if name.endswith("attn.k.bias"):
            continue
        num += float((got[name].double() - w.double()).pow(2).sum())
        den += float((w.double() - init[name].double()).pow(2).sum())
    return (num / den) ** 0.5


def dp_reference(seed: int, device: str = "cuda", config: str = "configs/ours.yml") -> dict:
    """One rank's DP_STEPS steps on the whole batch: its initial and final
    parameters (on the host) and its losses."""
    import torch

    cfg, model, batch = dp_setup(seed, torch.device(device), config=config)
    init = {k: v.cpu() for k, v in dp_params(model).items()}
    losses = dp_steps(model, cfg, batch)
    want = {k: v.cpu() for k, v in dp_params(model).items()}
    del model, batch
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"init": init, "losses": losses, "params": want}


def dp_report(out_dir: str, ranks: int, ref: dict, backend=None, tag: str = "[7] (a)") -> dict:
    """Reads the ``ranks`` files ``dp_rank`` wrote to ``out_dir``, prints
    them against one rank's (``dp_reference``) and fails unless they train
    as one rank does: DP_LOSS_MAX on the losses, DP_UPDATE_MAX on the
    update distance, every rank's parameters bitwise equal to rank 0's, both
    planted faults beyond the gate; where ``backend`` is given, every rank
    on it and, under nccl, on a card of its own. Returns the readings."""
    import torch

    got = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(ranks)]
    want, init, want_losses = ref["params"], ref["init"], ref["losses"]
    r0 = got[0]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], want_losses))
    same_ranks = all(torch.equal(r0["params"][k], g["params"][k]) for g in got[1:] for k in want)
    dist = dp_distance(r0["params"], want, init)
    faults = {name: dp_distance(p, want, init) for name, p in r0["faults"].items()}
    keys = {k: float((r0["params"][k] - want[k]).abs().max()) for k in want
            if k.endswith("attn.k.bias")}
    backends = [g["backend"] for g in got]
    devices = [g["device"] for g in got]
    where = "on one card" if len(set(devices)) == 1 else f"on cards {devices}"
    print(f"{tag} {ranks} ranks {where}, backend {sorted(set(backends))}, {r0['rows']} rows a "
          f"rank, against 1 rank at N={ranks * r0['rows']}: fp32 `ours` width, dropout 0, remat "
          f"full, {DP_STEPS} Adam steps at lr {DP_LR}: losses {r0['losses']} vs {want_losses} "
          f"(largest relative difference {loss_err:.3g}, gate {DP_LOSS_MAX}); the ranks' "
          f"parameters bitwise equal: {same_ranks}; update distance ||p2 - p1|| / ||p1 - p0|| "
          f"{dist:.3g} (gate {DP_UPDATE_MAX}); planted faults: "
          + ", ".join(f"{k} {v:.3g}" for k, v in faults.items())
          + f"; attention key biases (left out) differ by up to {max(keys.values()):.3g}; the "
          f"gradient all-reduce {r0['allreduce_bytes']} B a step through {r0['backend']}: "
          f"{r0['allreduce_ms']:.2f} ms (ranks {[round(g['allreduce_ms'], 2) for g in got]})",
          flush=True)
    if backend is not None and (backends != [backend] * ranks or (
            backend == "nccl" and len(set(devices)) != ranks)):
        fail(f"{tag}: backends {backends} on cards {devices}, {backend} on a card a rank "
             "expected")
    if loss_err > DP_LOSS_MAX or not same_ranks or dist > DP_UPDATE_MAX:
        fail(f"{tag}: {ranks} ranks do not train as one rank does")
    if min(faults.values()) <= DP_UPDATE_MAX:
        fail(f"{tag}: a planted fault reads within the gate")
    return {"loss_err": loss_err, "distance": dist, "faults": faults, "backends": backends,
            "devices": devices, "allreduce_bytes": r0["allreduce_bytes"],
            "allreduce_ms": [g["allreduce_ms"] for g in got],
            "launches": [g["launches"] for g in got]}


def run_dp_ranks(seed: int, device: str = "cuda", config: str = "configs/ours.yml",
                 ranks: int = 2, backend=None, tag: str = "[7] (a)") -> dict:
    """[7] (a) (two gloo ranks on the one card) and [12] (a) (four nccl
    ranks, a card each): ``ranks`` ranks started through
    ``parallel.mesh.spawn`` against one rank, fp32 (``dp_report``)."""
    from faceformer_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    ref = dp_reference(seed, device, config)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as out_dir:
        t1 = time.perf_counter()
        mesh.spawn(ranks, dp_rank, seed, out_dir, device, config, ranks)
        ranks_s = time.perf_counter() - t1
        readings = dp_report(out_dir, ranks, ref, backend, tag)
    print(f"{tag} ranks {ranks_s:.1f} s, in all {time.perf_counter() - t0:.1f} s", flush=True)
    return readings


def counted_rank(fn, *args) -> None:
    """A rank of a multi-rank command line as ``run_cli``'s wrapper starts
    it: the command's own rank function, then the rank's launches and peak
    memory in a file of its own under the wrapper's RANK_STATS_DIR (the
    ranks share one stdout pipe, where one rank's line can be cut by
    another's)."""
    import torch
    from faceformer_tpu_torch import ops

    ops.reset_launches()
    fn(*args)
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else 0
    rank = int(os.environ["RANK"])
    out = os.environ["CHIP_SMOKE_RANK_STATS"]
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"rank{rank}.json.tmp"), "w") as f:
        json.dump({"rank": rank, "launches": ops.LAUNCHES, "max_memory_allocated": peak}, f)
    os.replace(os.path.join(out, f"rank{rank}.json.tmp"), os.path.join(out, f"rank{rank}.json"))


def rank_stats(cwd: str, label: str, want, ranks: int = 2) -> list:
    """The stats of the ``ranks`` ranks of the command line just run from
    ``cwd`` (``counted_rank``'s files, removed once read, so that the next
    command line writes its own); fails unless each launched every kernel
    of ``want``."""
    out = os.path.join(cwd, RANK_STATS_DIR)
    names = sorted(os.listdir(out)) if os.path.isdir(out) else []
    stats = []
    for name in names:
        with open(os.path.join(out, name)) as f:
            stats.append(json.load(f))
    shutil.rmtree(out, ignore_errors=True)
    stats.sort(key=lambda s: s["rank"])
    if [s["rank"] for s in stats] != list(range(ranks)):
        fail(f"{label}: rank stats files {names}, stats {stats}")
    for s in stats:
        if any(s["launches"][k] <= 0 for k in want):
            fail(f"{label}: rank {s['rank']} launched {s['launches']}, expected {want}")
    return stats


def json_means(records: dict) -> dict:
    """test_precision, test_recall and test_type_acc recomputed from the
    prediction JSONs' canonical face sets (train/metrics.py's matching)."""
    per = []
    for blob in records.values():
        rec = json.loads(blob)
        pred = [(t, tuple(f)) for t, f in rec["pred_faces"]]
        label = [(t, tuple(f)) for t, f in rec["label_faces"]]
        tp = ttp = 0
        for pt, pf in pred:
            for lt, lf in label:
                if pf == lf:
                    tp += 1
                    ttp += int(pt == lt)
                    break
        per.append((0, 0, 0) if not pred or not label
                   else (tp / len(pred), tp / len(label), ttp / tp if tp else 0))
    return {f"test_{k}": float(np.mean([p[i] for p in per]))
            for i, k in enumerate(("precision", "recall", "type_acc"))}


def run_dp_cli(syn: str, fit_rate_1rank=None, ranks: int = 2, engines=("fused",),
               backend: str = "gloo", tag: str = "[7] (b)") -> dict:
    """[7] (b) and [12] (b): ``main ... trainer.num_devices <ranks>`` on
    [5]'s corpus (the ranks started by the command line itself: two gloo
    ranks on one card, or four nccl ranks a card each): one epoch with
    validation and a checkpoint; then the checkpoint tested in fp32 with
    each of ``engines`` at ``ranks`` ranks and at one: the JSONs byte-equal,
    the metrics equal to each other and to their means over the JSONs.
    Returns the launches, every rank's, and the fit's seconds."""
    total = collections.Counter()
    t0 = time.perf_counter()
    version = f"dp{ranks}"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_cli_") as tmp:
        base = ("root_dir", syn, "trainer.name", "smoke")

        def log(version):
            return os.path.join(tmp, "logs", "smoke", version)

        out, _, wall = run_cli(tmp, f"fit, {ranks} ranks, 1 epoch", MAIN, "--config-file",
                               CLI_CONFIG, *base, "trainer.version", version,
                               "trainer.num_devices", str(ranks), "trainer.max_epochs", "1",
                               "trainer.checkpoint_period", "1", timeout=600, tag=tag)
        backends = sorted({line.split("backend ")[1].split(",")[0] for line in out.splitlines()
                           if line.startswith("rank ") and "backend " in line})
        stats = rank_stats(tmp, f"fit, {ranks} ranks", ("flash_fwd", "flash_bwd",
                                                        "pointer_argmax"), ranks)
        for s in stats:
            total.update(s["launches"])
        by_rank = {"fit": [s["launches"] for s in stats]}
        records = read_jsonl(os.path.join(log(version), "metrics.jsonl"))
        losses = [r["train_loss"] for r in records if "train_loss" in r]
        timing = [r for r in records if "epoch_train_seconds" in r]
        steps = CLI_SPLIT[0] // 32
        per_step = 6 + 2 * 6
        files = sorted(os.listdir(log(version)))
        beside = ("" if fit_rate_1rank is None else
                  f" against [5]'s one rank {fit_rate_1rank:.2f}")
        print(f"{tag} fit {ranks} ranks: backend {backends}; {len(losses)} train_loss lines, "
              f"{sum('valid_precision' in r for r in records)} validation; files {files}; "
              f"checkpoints {sorted(os.listdir(os.path.join(log(version), 'checkpoints')))}; "
              f"launches a rank {[{k: v for k, v in s['launches'].items() if v} for s in stats]}; "
              f"peak memory a rank {[s['max_memory_allocated'] for s in stats]}; fit "
              f"samples/s {timing[0]['train_samples_per_s']:.2f}{beside}; epoch timing "
              f"{timing[0]}; wall {wall:.1f} s", flush=True)
        if (len(losses) != steps or not all(x is not None and np.isfinite(x) for x in losses)
                or sum("valid_precision" in r for r in records) != 1 or len(timing) != 1
                or sum(f.startswith("events.out.tfevents") for f in files) != 1
                or not os.path.isfile(os.path.join(log(version), "checkpoints", "last"))):
            fail(f"{tag} fit {ranks} ranks: not one writer's logs of one epoch and its "
                 "checkpoint")
        if backends != [backend]:
            fail(f"{tag}: backends {backends}, {backend} expected for {ranks} ranks")
        for s in stats:
            if s["launches"]["flash_bwd"] != steps * per_step:
                fail(f"{tag} fit: rank {s['rank']} K3 launches {s['launches']['flash_bwd']}")

        last = os.path.join(log(version), "checkpoints", "last")
        tested = {}
        for engine in engines:
            tests = {}
            for n in (ranks, 1):
                name = f"test-{engine}-{n}"
                out, st, _ = run_cli(tmp, f"test last, {engine} fp32, {n} rank(s)", MAIN,
                                     "--config-file", CLI_CONFIG, "--test_ckpt", last, *base,
                                     "trainer.version", name, "trainer.num_devices", str(n),
                                     "decode.mode", engine, "decode.precision", "fp32", tag=tag)
                kernel = "decode_step" if engine == "fused" else "pointer_argmax"
                if n > 1:
                    stats = rank_stats(tmp, f"test, {ranks} ranks", (kernel, "flash_fwd"), ranks)
                    for s in stats:
                        total.update(s["launches"])
                    by_rank[f"test {engine}"] = [s["launches"] for s in stats]
                else:
                    total.update(st["launches"])
                with open(os.path.join(log(name), "results.json")) as f:
                    tests[n] = (read_records(os.path.join(log(name), "json"), CLI_SPLIT[2]),
                                json.load(f))
            means = json_means(tests[ranks][0])
            same = tests[ranks][0] == tests[1][0]
            with open(os.path.join(log(f"test-{engine}-{ranks}"), "metrics.jsonl")) as f:
                writer_lines = len(f.readlines())
            metric_diff = max(abs(tests[ranks][1][k] - tests[1][1][k]) for k in means)
            print(f"{tag} test {engine} fp32: {ranks} ranks {tests[ranks][1]}; 1 rank "
                  f"{tests[1][1]}; the {CLI_SPLIT[2]} JSONs byte-equal: {same}; their means "
                  f"{means}; the metrics' largest difference {metric_diff:.3g}; the {ranks}-rank "
                  f"test's metrics.jsonl lines {writer_lines}", flush=True)
            if (not same or writer_lines != 1 or tests[ranks][1]["num_samples"] != CLI_SPLIT[2]
                    or metric_diff > 1e-12):
                fail(f"{tag} test {engine}: {ranks} ranks and one rank disagree, or not one "
                     "writer")
            if any(abs(tests[ranks][1][k] - v) > 1e-12 for k, v in means.items()):
                fail(f"{tag} test {engine}: the {ranks}-rank metrics are not the means over "
                     "the JSONs")
            tested[engine] = tests[ranks][1]
    print(f"{tag} took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": dict(total), "by_rank": by_rank, "timing": timing[0], "tests": tested}


def run_nccl_world_one(seed: int) -> None:
    """[7] (c): one rank under a rank environment: the nccl process group and
    its all-reduces, DP_STEPS fp32 steps at N=8, against the same steps with
    no process group, held to (a)'s gates (the embedding gradient's atomic
    adds may reorder sums between two runs). The steps must send their
    token count and gradient bucket through nccl's all-reduce."""
    import torch
    import torch.distributed as dist
    from faceformer_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    real_all_reduce, reduces = dist.all_reduce, collections.Counter()

    def counted(tensor, *args, **kwargs):
        reduces[dist.get_backend(kwargs.get("group"))] += 1
        return real_all_reduce(tensor, *args, **kwargs)

    cfg, model, batch = dp_setup(seed, torch.device("cuda"), remat=False)
    batch = {k: v[:8] for k, v in batch.items()}
    init = dp_params(model)
    runs = {}
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(mesh._free_port()))
    for label in ("no process group", "nccl, world 1"):
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(init[name])
        world = None
        if label != "no process group":
            os.environ.update(env)
            world = mesh.make_mesh(0, "cuda")
        dist.all_reduce = counted
        try:
            losses = dp_steps(model, cfg, batch, world)
        finally:
            dist.all_reduce = real_all_reduce
            if world is not None:
                dist.destroy_process_group()
                for key in env:
                    del os.environ[key]
        runs[label] = (losses, dp_params(model), None if world is None else world.backend)
    (l0, p0, _), (l1, p1, backend) = runs.values()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l1, l0))
    dist_ = dp_distance(p1, p0, init)
    print(f"[7] (c) nccl at world 1: backend {backend}; losses {l1} vs {l0} with no process "
          f"group (largest relative difference {loss_err:.3g}, gate {DP_LOSS_MAX}); update "
          f"distance {dist_:.3g} (gate {DP_UPDATE_MAX}); all-reduces by backend "
          f"{dict(reduces)}; {time.perf_counter() - t0:.1f} s", flush=True)
    if backend != "nccl" or loss_err > DP_LOSS_MAX or dist_ > DP_UPDATE_MAX:
        fail("[7] (c): the nccl path at world 1 does not train as the single-process step")
    if reduces["nccl"] < 2 * DP_STEPS:
        fail(f"[7] (c): {reduces['nccl']} nccl all-reduces in {DP_STEPS} steps (the token count "
             "and the gradient bucket each step)")


def run_remat_policies(seed: int, rng) -> dict:
    """[7] (d): each remat policy at the `ours` width, bf16, N=32, dropout
    0.2: samples/s over 3 steps after 1 warm-up, peak memory, K2 and K3
    launches; then every gradient through the kernels in fp32 at N=2
    against ``full``'s. Returns samples/s by policy."""
    import torch
    from faceformer_tpu_torch import ops
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel
    from faceformer_tpu_torch.params import jitter_affine_
    from faceformer_tpu_torch.train.loss import pointer_cross_entropy
    from faceformer_tpu_torch.train.step import make_optimizer, train_step

    t0 = time.perf_counter()
    cfg = load_config("configs/ours.yml")
    mc = cfg.model
    tcfg = dataclasses.replace(cfg, trainer=dataclasses.replace(
        cfg.trainer, precision="bf16", lr=1e-4, scheduled_sampling=0.0))
    per_step = mc.num_encoder_layers + 2 * mc.num_decoder_layers
    gen = torch.Generator().manual_seed(seed + 9)
    model = SurfaceFormerParallel(mc, generator=gen, device="cuda")
    jitter_affine_(model, gen)
    batch = training_batch(rng, random_wireframes(rng, 32), mc, torch.device("cuda"))
    optimizer = make_optimizer(model, tcfg.trainer)
    dgen = torch.Generator().manual_seed(seed + 10)
    rates, peaks = {}, {}
    for policy in REMAT_POLICIES:
        model.cfg = dataclasses.replace(mc, remat=policy != "off",
                                        remat_policy="full" if policy == "off" else policy)
        torch.cuda.empty_cache()  # the last policy's cached blocks go; the warm-up refills
        train_step(model, optimizer, batch, dgen, tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t1 = time.perf_counter()
        for _ in range(3):
            train_step(model, optimizer, batch, dgen, tcfg)
        torch.cuda.synchronize()
        rates[policy] = 3 * len(batch["label"]) / (time.perf_counter() - t1)
        peaks[policy] = torch.cuda.max_memory_allocated()
        # K2 runs again in the backward under every policy: its
        # autograd.Function is opaque to the policy
        fwd = (1 if policy == "off" else 2) * 3 * per_step
        print(f"[7] (d) remat {policy}: samples/s={rates[policy]:.2f} "
              f"max_memory_allocated={peaks[policy]}", flush=True)
        expect_launches(f"remat {policy}, 3 bf16 steps, dropout {mc.dropout}", fwd,
                        3 * per_step, tag="[7] (d)")
    # the gradients in deterministic mode: the gathers' backward adds
    # atomically otherwise, and two runs of one policy then part by ~1e-4 of
    # a leaf's magnitude (a first reading on the H100)
    small = {k: v[:2] for k, v in batch.items()}
    grads = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # cuBLAS's workspace note, once an op
            for run in ("full", "full again", "dots", "attn", "attn_ffn"):
                model.cfg = dataclasses.replace(mc, dropout=0.0, remat=True,
                                                remat_policy=run.split()[0])
                model.zero_grad(set_to_none=True)
                loss, _ = pointer_cross_entropy(model.forward_train(small, precision="fp32"),
                                                mc.token)
                loss.backward()
                grads[run] = {k: p.grad.clone() for k, p in model.named_parameters()}
    finally:
        torch.use_deterministic_algorithms(False)
    # each leaf against its own largest magnitude; the attention key biases
    # (a zero gradient but for rounding, as in [3]) by the absolute difference
    worst, keys = {}, {}
    for policy, g in grads.items():
        if policy == "full":
            continue
        full = grads["full"]
        worst[policy] = max(float((g[k] - full[k]).abs().max() / full[k].abs().max())
                            for k in g if not k.endswith("attn.k.bias"))
        keys[policy] = max(float((g[k] - full[k]).abs().max()) for k in g
                           if k.endswith("attn.k.bias"))
    model.cfg = mc
    print(f"[7] (d) fp32 N=2 dropout 0, every gradient through the kernels against full's: "
          f"largest relative difference per leaf {worst} (gate 1e-6), key biases {keys} "
          f"(gate 1e-5); bf16 N=32 samples/s {rates}, peak bytes {peaks}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if max(worst.values()) > 1e-6 or max(keys.values()) > 1e-5:
        fail("[7] (d): a remat policy's gradients differ from full's")
    return rates


def run_profile_tool() -> dict:
    """[7] (e): ``tools.profile`` at the `ours` width, batch 8, 3 iterations:
    the fused decode and the training step, each through the tool's
    ``main`` with its command-line arguments, in this process (a process
    of its own spends ~20 s starting). The trace must give device time to
    each kernel of the run, by the wrapper that launched it; in the fused
    decode K4's share must hold its attention and pointer phases, and K1,
    which that engine does not call, must get none. Returns ms/iter."""
    import contextlib
    import io

    import torch
    from faceformer_tpu_torch.tools.profile import device_us_by_kernel
    from faceformer_tpu_torch.tools.profile import main as profile_main

    ms = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as tmp:
        for what, mode, want in (("decode", "fused", ("K2 flash forward",
                                                      "K4 fused decode step")),
                                 ("train", "causal_cache", ("K2 flash forward",
                                                            "K3 flash backward"))):
            t0 = time.perf_counter()
            stdout = io.StringIO()
            with contextlib.redirect_stdout(stdout):
                profile_main(["--what", what, "--mode", mode, "--config",
                              os.path.join(REPO, "configs", "ours.yml"), "--batch", "8",
                              "--iters", "3", "--out", tmp])
            torch.cuda.empty_cache()
            out = stdout.getvalue()
            with open(os.path.join(tmp, f"{what}.json")) as f:
                events = json.load(f)["traceEvents"]
            by_kernel = device_us_by_kernel(events)
            # K4's C entry runs its attention and pointer phases on K2's and
            # K1's device code; those must count as K4's, not K1's or K2's
            k4_phase_us = sum(ev["dur"] for ev in events if ev.get("cat") == "kernel"
                              and any(m in ev.get("name", "") for m in
                                      ("ff::attention", "ff::pointer_argmax")))
            line = [ln for ln in out.splitlines() if ln.startswith(f"{what}: ")][0]
            ms[what] = float(line.split("(")[1].split(" ms/iter")[0])
            shares = {k: round(v / 1e3, 3) for k, v in sorted(by_kernel.items())}
            print(f"[7] (e) tools.profile --what {what} --mode {mode}: {line}; device ms by "
                  f"launching wrapper {json.dumps(shares)}; "
                  f"ff::attention and ff::pointer_argmax kernels {k4_phase_us / 1e3:.3f} ms; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            for ln in out.splitlines():
                if ln.startswith(("device ms", "  ")):
                    print(f"[7] (e)   {ln.strip()}", flush=True)
            if not all(by_kernel.get(k, 0.0) > 0 for k in want):
                fail(f"[7] (e) tools.profile --what {what}: the trace gives no device time to "
                     f"one of {want}: {by_kernel}")
            if what == "decode" and ("K1 pointer argmax" in by_kernel
                                     or by_kernel["K4 fused decode step"]
                                     + by_kernel["K2 flash forward"] < k4_phase_us):
                fail("[7] (e) tools.profile --what decode --mode fused: K4's attention and "
                     "pointer phases are not counted as K4's")
    return ms


def run_ranks_phase(seed: int, rng, syn: str, fit_rate_1rank: float) -> dict:
    """Phase 7. Returns the launches of (b)'s command lines, every rank's."""
    t_phase = time.perf_counter()
    run_dp_ranks(seed)
    launches = run_dp_cli(syn, fit_rate_1rank)["launches"]
    run_nccl_world_one(seed)
    run_remat_policies(seed, rng)
    run_profile_tool()
    print(f"[7] the ranks, remat and profiler phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 8: the corpus pipeline, STEP files to the split JSON directory the
# trainer reads, then one epoch at the step-native-big width on it
# ---------------------------------------------------------------------------

CORPUS_CONFIG = os.path.join(REPO, "configs", "step-native-big.yml")
# configs/step-native-big.yml:12-15's commands cut from 4,096 solids to 256:
# the seeded 0.93 / 0.02 / 0.05 split gives 238 / 5 / 13, 7 steps an epoch
CORPUS_NUM, CORPUS_CORES = 256, 8
CORPUS_GEN = ("--num", str(CORPUS_NUM), "--seed", "5")
CORPUS_PREP = ("--backend", "native", "--random_camera", "--seed", "9",
               "--num_cores", str(CORPUS_CORES))
# The integer content of that corpus (corpus_digest) as the JAX package's
# root scripts write it with the same flags on a CPU host, with its
# checker's and filters' counts: tests/torch_corpus_helpers.py's docstring
# gives the command.
ORACLE_CORPUS = {
    "unclosed": 0, "length_kept": 201, "topology_features": 70, "topology_bins": 70,
    "solids": 256, "written": {"json": 256, "svg": 256, "stat": 256}, "dropped": [],
    "split": [238, 5, 13], "split_md5": "c0b5e93a21abab6269884ce8aa315623",
    "edges": 9710, "faces": 2105, "pairings": 4855,
    "face_types": {"0": 1264, "1": 420, "2": 55, "3": 120, "4": 82, "6": 147, "7": 17},
    "traced": 51, "shapes_md5": "2991c71604cbb440b7da16027e197c4d",
    "untraced_loops_md5": "8475103d918f66374d4baefcb94edac5",
    "stat_md5": "b86d137566ff6633f4d6dfd73ac44e9d"}


def has_traced_face(solid) -> bool:
    """Whether the native backend traces a silhouette on one of the B-rep
    solid's faces: a torus or revolution band, or a B-spline patch."""
    from faceformer_tpu_torch.tools import step21

    return any(f.surface_kind in (step21.TORUS, step21.REVOLUTION)
               or (f.surface_kind == step21.BSPLINE and f.patch is not None)
               for f in solid.faces)


def corpus_digest(root: str) -> dict:
    """The integer content of a corpus prepared with the default flag set:
    the solids written and dropped, the splits, the edge, face and pairing
    counts, the face types, every solid's faces as (type, loop lengths),
    the face loops as edge indices of every solid without a traced face
    (a torus or revolution band, a B-spline patch: the JAX package's
    traces start from an end that varies from run to run, and with it the
    order of edges that sort by the traced points), and the stat sidecars'
    bytes. Digests (md5) stand for the long parts."""
    import hashlib

    from faceformer_tpu_torch.tools import step21

    def md5(value) -> str:
        return hashlib.md5(json.dumps(value).encode()).hexdigest()

    def listing(sub):
        return sorted(os.path.splitext(n)[0] for n in os.listdir(os.path.join(root, sub)))

    names, written = listing("step"), {sub: listing(sub) for sub in ("json", "svg", "stat")}
    shapes, exact, types, stats = [], [], collections.Counter(), []
    edges = faces = pairings = traced = 0
    for name in written["json"]:
        is_traced = has_traced_face(step21.read_brep(os.path.join(root, "step",
                                                                  f"{name}.step"))[0])
        with open(os.path.join(root, "json", f"{name}.json")) as f:
            data = json.load(f)
        loops = data["faces_indices"]
        edges, faces, pairings = (edges + len(data["edges"]), faces + len(loops),
                                  pairings + len(data["pairings"]))
        types.update(str(t) for t, _ in loops)
        shapes.append([name, len(data["edges"]), len(data["pairings"]),
                       sorted([t, sorted(len(lp) for lp in ls)] for t, ls in loops)])
        traced += is_traced
        if not is_traced:
            exact.append([name, loops, data["pairings"]])
    for name in written["stat"]:
        with open(os.path.join(root, "stat", f"{name}.yml")) as f:
            stats.append(f.read())
    splits = []
    for split in ("train.txt", "valid.txt", "test.txt"):
        with open(os.path.join(root, split)) as f:
            splits.append(f.read().split())
    return {"solids": len(names), "written": {k: len(v) for k, v in written.items()},
            "dropped": sorted(set(names) - set(written["json"])),
            "split": [len(s) for s in splits], "split_md5": md5(splits),
            "edges": edges, "faces": faces, "pairings": pairings,
            "face_types": dict(sorted(types.items())), "traced": traced,
            "shapes_md5": md5(shapes), "untraced_loops_md5": md5(exact),
            "stat_md5": md5(stats)}


def run_host(cwd, label, module, *argv, timeout=600):
    """``python -m module argv``, host code that imports no torch, in a
    subprocess; fails on a non-zero exit. Returns (stdout, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=cwd, env=repo_env(),
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-6000:], proc.stderr[-6000:], sep="\n", flush=True)
        fail(f"[8] {label}: exit code {proc.returncode}")
    print(f"[8] {label}: rc 0 in {wall:.2f} s", flush=True)
    return proc.stdout, wall


def build_step_corpus(tmp: str) -> tuple:
    """(a)-(c): the corpus under ``tmp`` from the port's command lines, its
    checks and filters, held to ORACLE_CORPUS. Returns (its root, the
    host seconds of each step)."""
    import importlib.util

    import yaml
    from faceformer_tpu_torch.tools.filters.filter_topology import topology_feature

    tools = "faceformer_tpu_torch.tools"
    root = os.path.join(tmp, "step4k")
    secs = {}
    _, secs["gen_step_solids"] = run_host(tmp, "(a) gen_step_solids", f"{tools}.gen_step_solids",
                                          "--root", root, *CORPUS_GEN)
    out, secs["prepare_data"] = run_host(tmp, "(b) prepare_data", f"{tools}.prepare_data",
                                         "--root", root, *CORPUS_PREP)
    with open(os.path.join(root, "train.txt"), "rb") as f:
        train_bytes = f.read()
    print(f"[8] (b) {CORPUS_NUM} solids in {secs['prepare_data']:.2f} s on {CORPUS_CORES} host "
          f"cores: {CORPUS_NUM / secs['prepare_data']:.2f} solids/s; {len(out.splitlines())} "
          f"lines of log (solids rejected or failed)", flush=True)
    got = {}
    out, secs["check_faces_enclosed"] = run_host(
        tmp, "(c) check_faces_enclosed", f"{tools}.check_faces_enclosed", "--root", root,
        "--num_cores", str(CORPUS_CORES))
    got["unclosed"] = int(out.splitlines()[-1].split()[0])
    kept = os.path.join(tmp, "filtered_id_list.json")
    _, secs["filter_length"] = run_host(tmp, "(c) filters.filter_length",
                                        f"{tools}.filters.filter_length", "--root", root,
                                        "--out", kept)
    with open(kept) as f:
        got["length_kept"] = len(json.load(f))
    _, secs["split_jsons"] = run_host(tmp, "(c) split_jsons", f"{tools}.split_jsons",
                                      "--root", root, "--seed", "9")
    with open(os.path.join(root, "train.txt"), "rb") as f:
        if f.read() != train_bytes:
            fail("[8] (c) split_jsons --seed 9 did not rewrite prepare_data's split")
    features = set()
    for name in os.listdir(os.path.join(root, "stat")):
        with open(os.path.join(root, "stat", name)) as f:
            features.add(tuple(topology_feature(yaml.safe_load(f))))
    got["topology_features"] = len(features)
    if importlib.util.find_spec("sklearn") is None:
        print(f"[8] (c) this host lacks sklearn, which filters.filter_topology bins with and "
              f"filters.filter_3view clusters with: neither runs here; the {len(features)} "
              f"distinct topology features filter_topology bins at similarity 0 are counted "
              f"from the stat sidecars", flush=True)
    else:
        bins = os.path.join(tmp, "bins.json")
        _, secs["filter_topology"] = run_host(tmp, "(c) filters.filter_topology",
                                              f"{tools}.filters.filter_topology", "--root", root,
                                              "--out", bins)
        with open(bins) as f:
            got["topology_bins"] = len(json.load(f))
    got.update(corpus_digest(root))
    want = {k: v for k, v in ORACLE_CORPUS.items() if k != "topology_bins" or k in got}
    differ = sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))
    print(f"[8] (c) corpus: {got['written']} written, {len(got['dropped'])} dropped, split "
          f"{got['split']}, {got['edges']} edges, {got['faces']} faces {got['face_types']}, "
          f"{got['traced']} solids with a traced face; {got['unclosed']} unclosed, "
          f"{got['length_kept']} kept by filter_length; the integer content against the JAX "
          f"package's ({len(want)} keys): {'equal' if not differ else differ}", flush=True)
    if differ:
        for k in differ:
            print(f"[8]   {k}: got {got.get(k)}, JAX package {want.get(k)}", flush=True)
        fail("[8] the corpus's integer content differs from the JAX package's")
    return root, secs


def run_corpus_phase(host: dict) -> dict:
    """Phase 8 ([10] checks the host path on its corpus into ``host``).
    Returns the launches of (d)'s command lines."""
    total = collections.Counter()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_step_") as tmp:
        root, secs = build_step_corpus(tmp)
        host["step-native-big"] = check_host_loader("[8]'s step-native-big corpus", root,
                                                    CORPUS_CONFIG)
        base = ("root_dir", root, "trainer.name", "smoke")
        log = os.path.join(tmp, "logs", "smoke", "step")
        last = os.path.join(log, "checkpoints", "last")
        _, st, secs["fit"] = run_cli(tmp, "(d) fit (1 epoch, step-native-big.yml)", MAIN,
                                     "--config-file", CORPUS_CONFIG, *base, "trainer.version",
                                     "step", "trainer.max_epochs", "1",
                                     "trainer.checkpoint_period", "1", timeout=600, tag="[8]")
        total.update(st["launches"])
        records = read_jsonl(os.path.join(log, "metrics.jsonl"))
        steps = [(r["step"], r["time"], r["train_loss"]) for r in records if "train_loss" in r]
        n_steps = ORACLE_CORPUS["split"][0] // 32
        losses = [x for _, _, x in steps]
        if [s for s, _, _ in steps] != list(range(1, n_steps + 1)) or not np.all(np.isfinite(losses)):
            fail(f"[8] fit: train_loss {[(s, x) for s, _, x in steps]}, expected {n_steps} "
                 "finite steps")
        rate = 32 * (n_steps - 1) / (steps[-1][1] - steps[0][1])
        timing = [r for r in records if "epoch_train_seconds" in r][0]
        print(f"[8] (d) fit: losses {[round(x, 4) for x in losses]}; {rate:.2f} samples/s over "
              f"steps 2-{n_steps}, epoch {timing['epoch_train_seconds']:.2f} s, validation "
              f"{timing['valid_seconds']:.2f} s", flush=True)
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            fail("[8] fit: the last three steps' mean loss is not below the first three's")
        if st["launches"]["flash_fwd"] <= 0 or st["launches"]["flash_bwd"] <= 0:
            fail(f"[8] fit: launches {st['launches']}; K2 and K3 expected")
        _, st, secs["test"] = run_cli(tmp, "(d) test last, decode.mode causal_cache", MAIN,
                                      "--config-file", CORPUS_CONFIG, "--test_ckpt", last, *base,
                                      "trainer.version", "step-test", tag="[8]")
        total.update(st["launches"])
        with open(os.path.join(tmp, "logs", "smoke", "step-test", "results.json")) as f:
            results = json.load(f)
        read_records(os.path.join(tmp, "logs", "smoke", "step-test", "json"),
                     ORACLE_CORPUS["split"][2])
        print(f"[8] (d) test: {results}", flush=True)
        if (st["launches"]["pointer_argmax"] <= 0 or st["launches"]["flash_fwd"] <= 0
                or st["launches"]["decode_step"]):
            fail(f"[8] test causal_cache: launches {st['launches']}; K1 and K2 expected, no K4")
    print(f"[8] seconds: {json.dumps({k: round(v, 2) for k, v in secs.items()})}; the corpus "
          f"phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 10: the C++ host path (data/native_loader.py, geometry/native.py)
# ---------------------------------------------------------------------------

HOST_SPLITS = ("train", "valid", "test")
HOST_KEYS = ("input", "input_mask", "num_input", "label", "label_mask")
HOST_REPEATS = 20  # passes over [5]'s validation split when timing the two host kernels


def check_host_loader(label: str, root: str, config_path: str) -> dict:
    """[10] on one corpus while its phase holds it: each split of the
    config built with impl="native" (the threaded C++ loader) and with
    impl="plain" (the Python packer), construction plus one pass of
    ``__getitem__`` timed each way. Gates: the native path packs every
    file, every item's arrays are equal (``input`` bit for bit as float32)
    and so are the raw JSONs at every index eval reads (valid, test).
    Returns the numbers."""
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.train.trainer import DATASET_REGISTRY

    t_call = time.perf_counter()
    cfg = load_config(config_path)
    cls = DATASET_REGISTRY[cfg.dataset_class]
    keys = HOST_KEYS + ("num_faces" if cls._parallel else "num_label",)
    secs = {"native": 0.0, "plain": 0.0}
    sizes = []
    for split in HOST_SPLITS:
        built = {}
        for impl in ("native", "plain"):
            t0 = time.perf_counter()
            ds = cls(root, list(getattr(cfg, f"datasets_{split}")), cfg.model, impl=impl)
            items = [ds[i] for i in range(len(ds))]
            secs[impl] += time.perf_counter() - t0
            built[impl] = (ds, items)
        (ds, nat), (plain_ds, plain) = built["native"], built["plain"]
        sizes.append(len(ds))
        if ds._packed is None or ds._native_failed:
            fail(f"[10] {label} {split}: the native loader did not pack every file "
                 f"(failed {sorted(ds._native_failed)})")
        if len(nat) != len(plain):
            fail(f"[10] {label} {split}: {len(nat)} native items, {len(plain)} plain")
        for i, (a, b) in enumerate(zip(nat, plain)):
            for key in keys:
                x, y = np.asarray(a[key]), np.asarray(b[key])
                if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                    fail(f"[10] {label} {split} item {i} ({a['name']}): {key} differs "
                         f"between the native and the plain path")
        if split != "train" and [ds.raw_datas[i] for i in range(len(ds))] != plain_ds.raw_datas:
            fail(f"[10] {label} {split}: raw_datas differ between the native and the plain path")
    n = sum(sizes)
    numbers = {"samples": n, "splits": sizes, "native_s": secs["native"],
               "plain_s": secs["plain"], "native_samples_per_s": n / secs["native"],
               "plain_samples_per_s": n / secs["plain"],
               "check_s": time.perf_counter() - t_call}
    print(f"[10] {label}: train/valid/test {sizes}, {', '.join(keys)} equal (input bit for "
          f"bit), raw_datas of valid and test equal; construction plus one pass: native "
          f"{secs['native']:.4f} s ({numbers['native_samples_per_s']:.1f} samples/s, "
          f"{os.cpu_count()} host cores), plain {secs['plain']:.4f} s "
          f"({numbers['plain_samples_per_s']:.1f} samples/s)", flush=True)
    return numbers


def time_host_kernels(root: str, config_path: str) -> dict:
    """[10] over [5]'s validation split: ``resample_edge_batch`` a sample
    through the host library and through the numpy loop, and the metrics'
    enclosedness filter a sample (edges flattened once, one batch call for
    the predicted faces and one for the label faces, the label faces
    standing in for both) against the Python predicate's two calls. Gates:
    equal outputs. Returns ms a sample each way."""
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.data.dataset import parse_splits_list
    from faceformer_tpu_torch.geometry.native import (
        filter_faces_by_encloseness_batch,
        flatten_edges,
    )
    from faceformer_tpu_torch.geometry.sampling import resample_edge_batch
    from faceformer_tpu_torch.post_processing import filter_faces_by_encloseness

    cfg = load_config(config_path)
    mc, tol = cfg.model, cfg.post_process.enclosedness_tol
    raws = []
    for name in parse_splits_list(root, list(cfg.datasets_valid)):
        with open(os.path.join(root, name)) as f:
            raws.append(json.load(f))
    faces = [[(t, tuple(i for lp in loops for i in lp)) for t, loops in raw["faces_indices"]]
             for raw in raws]

    def resample(impl):
        return [resample_edge_batch(raw["edges"], mc.num_lines, mc.num_points_per_line,
                                    impl=impl) for raw in raws]

    def native_filter():
        out = []
        for raw, fs in zip(raws, faces):
            flat = flatten_edges(raw["edges"])
            out.append((filter_faces_by_encloseness_batch(raw["edges"], fs, tol, flat),
                        filter_faces_by_encloseness_batch(raw["edges"], fs, tol, flat)))
        return out

    def plain_filter():
        return [(filter_faces_by_encloseness(raw["edges"], fs, tol),
                 filter_faces_by_encloseness(raw["edges"], fs, tol))
                for raw, fs in zip(raws, faces)]

    ms, outs = {}, {}
    for name, fn in (("resample_native", lambda: resample("native")),
                     ("resample_plain", lambda: resample("plain")),
                     ("enclosedness_native", native_filter),
                     ("enclosedness_plain", plain_filter)):
        outs[name] = fn()
        t0 = time.perf_counter()
        for _ in range(HOST_REPEATS):
            fn()
        ms[name] = 1e3 * (time.perf_counter() - t0) / (HOST_REPEATS * len(raws))
    if any(a.tobytes() != b.tobytes()
           for a, b in zip(outs["resample_native"], outs["resample_plain"])):
        fail("[10] resample_edge_batch: the host library and the numpy loop differ")
    if outs["enclosedness_native"] != outs["enclosedness_plain"]:
        fail("[10] the enclosedness filter: the batch call and the Python predicate differ")
    edges = sum(len(raw["edges"]) for raw in raws) / len(raws)
    n_faces = sum(len(fs) for fs in faces) / len(faces)
    print(f"[10] [5]'s validation split ({len(raws)} samples, {edges:.1f} edges and "
          f"{n_faces:.1f} faces a sample, {HOST_REPEATS} passes), ms a sample: "
          f"resample_edge_batch native {ms['resample_native']:.4f}, plain "
          f"{ms['resample_plain']:.4f}; enclosedness filter (2 calls) native "
          f"{ms['enclosedness_native']:.4f}, plain {ms['enclosedness_plain']:.4f}; outputs "
          f"equal", flush=True)
    return ms


# ---------------------------------------------------------------------------
# phase 9: tensor parallelism over the model axis (parallel/tensor.py)
# ---------------------------------------------------------------------------

TP_ROWS = 4  # configs/ours.yml's batch_size_train
TP_STEPS = 2  # gated Adam steps; TP_TIMED more are timed
TP_TIMED = 1
TP_REFERENCE_ROWS = 2  # the reference engine re-runs the decoder over its prefix
TP_MASK = (TP_ROWS, 4, 220, 220)  # the encoder's keep mask on a rank's 4 of 8 heads
# (a)'s and (b)'s gates, set from the readings on the H100 (PERF.md §6):
# the fp32 losses within TP_LOSS_MAX of one rank's, relative; the
# parameters after TP_STEPS Adam steps within TP_UPDATE_MAX of one rank's as
# ||p_tp - p_1|| / ||p_1 - p_0|| over every leaf but the attention key
# biases ([7] (a)'s dp_distance); the bf16 losses with dropout within
# TP_BF16_LOSS_MAX, relative. Readings (NVIDIA H100 80GB HBM3, 700 W): fp32
# loss 4.7e-7 and 5.8e-7, distance 1.2e-3 and 1.3e-3, the planted fault
# 0.72; bf16 loss 1.3e-3.
TP_LOSS_MAX = 1e-5
TP_UPDATE_MAX = 1e-2
TP_BF16_LOSS_MAX = 1e-2
# (f)-(h): the flat SurfaceFormer at synthetic-dirtok-big.yml's width, the
# gates of (a) and (b) but for the second loss (below); (f)'s planted fault
# must move the fp32 losses by more than TP_FLAT_FAULT_MIN, relative; (h)'s
# reference engine decodes TP_REFERENCE_ROWS rows, causal_cache TP_ROWS
TP_FLAT_FAULT_MIN = 0.1
# the first step's gathered gradients within TP_FLAT_GRAD_MAX of one rank's,
# each leaf relative to its largest magnitude (grad_errors). The first
# step's loss is held to TP_LOSS_MAX, the second's to TP_FLAT_LOSS_MAX:
# Adam's first update moves every parameter by lr (3e-4 here) by its
# gradient's sign, so gradients of rounding size, whose signs part between
# the split and one rank, move the second loss further than the first.
# Readings (NVIDIA H100 80GB HBM3, 700 W): the first loss 6.0e-7, the
# second 1.44e-5-1.48e-5, after 61 gradient elements, none above 1.5e-5
# of its leaf's largest, changed sign; gradients 6.5e-5-7.7e-5 a leaf at
# most (kernels against plain: 4.3e-5, [6]); the rounding control (one
# rank through the plain versions, whose rounding parts in the attention
# alone) 1.2e-7, then 2.9e-7-4.9e-7; the planted fault 0.156
TP_FLAT_GRAD_MAX = 1e-4
TP_FLAT_LOSS_MAX = 1e-4
TP_FLAT_KEYS = 512  # the decoder self-attention's keys: label_seq_length - 1, padded to 8


def tp_setup(seed, dev, precision: str, dropout: float):
    """[9]'s configuration, model and batch: configs/ours.yml as written (d
    512, 8 heads, FFN 1024, 6+6 layers, L 216, T 37, lr 1e-4, remat off) in
    ``precision`` at ``dropout``; TP_ROWS seeded wireframes with seeded face
    loops. The same in every process that calls it."""
    import torch
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel
    from faceformer_tpu_torch.params import jitter_affine_

    cfg = load_config("configs/ours.yml")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout=dropout),
        trainer=dataclasses.replace(cfg.trainer, precision=precision, scheduled_sampling=0.0))
    gen = torch.Generator().manual_seed(seed + 11)
    model = SurfaceFormerParallel(cfg.model, generator=gen, device=dev)
    jitter_affine_(model, gen)
    rng = np.random.default_rng(seed + 11)
    batch = training_batch(rng, random_wireframes(rng, TP_ROWS), cfg.model, dev)
    return cfg, model, batch


def tp_flat_setup(seed, dev, precision: str, dropout: float):
    """(f)-(h)'s configuration, model and batch: synthetic-dirtok-big.yml as
    written (d 512, 8 heads, FFN 1024, 6+6 layers, S 116, label_seq_length
    512, direction tokens, lr 3e-4) in ``precision`` at ``dropout``; TP_ROWS
    seeded direction-token solids ([6]'s flat_samples). The same in every
    process that calls it."""
    import torch
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.models.surfaceformer import SurfaceFormer
    from faceformer_tpu_torch.params import jitter_affine_

    cfg = load_config(FLAT_CONFIG)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout=dropout),
        trainer=dataclasses.replace(cfg.trainer, precision=precision, scheduled_sampling=0.0))
    gen = torch.Generator().manual_seed(seed + 13)
    model = SurfaceFormer(cfg.model, generator=gen, device=dev)
    jitter_affine_(model, gen)
    samples = flat_samples(np.random.default_rng(seed + 13), cfg.model, TP_ROWS)
    return cfg, model, flat_batch(samples, cfg.model, dev)


def tp_steps(model, cfg, batch, seed: int, world=None, timed=None, steps: int = TP_STEPS,
             grads=None, impl: str = "auto"):
    """``steps`` Adam steps (with dropout, the stream of data rank 0): their
    losses and the parameters after them (on the host, gathered over the
    model group; the first step's gradients into ``grads`` when given);
    then TP_TIMED more steps, each bracketed by ``timed``'s calls when given
    (their ms a step and the peak bytes go into it)."""
    import torch
    from faceformer_tpu_torch.parallel.tensor import gather_params
    from faceformer_tpu_torch.train.step import make_optimizer, train_step
    from faceformer_tpu_torch.train.trainer import rank_generator

    gen = rank_generator(seed, 0) if cfg.model.dropout > 0 else None
    optimizer = make_optimizer(model, cfg.trainer)
    losses = []
    for step in range(steps):
        losses.append(float(train_step(model, optimizer, batch, gen, cfg, impl=impl,
                                       world=world)[0]))
        if grads is not None and step == 0:
            grads.update({k: v.cpu() for k, v in gather_params(model, grads=True).items()})
    params = {k: v.cpu() for k, v in gather_params(model).items()}
    if timed is not None:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed["on"] = True
        t0 = time.perf_counter()
        for _ in range(TP_TIMED):
            train_step(model, optimizer, batch, gen, cfg, world=world)
        torch.cuda.synchronize()
        timed["on"] = False
        timed["step_ms"] = (time.perf_counter() - t0) / TP_TIMED * 1e3
        timed["peak"] = torch.cuda.max_memory_allocated()
    return losses, params


def tp_grids(model, mc, batch) -> tuple:
    """fp32 grids: causal_cache and fused on every row, reference on the
    first TP_REFERENCE_ROWS; and the causal_cache decode's peak bytes."""
    import torch

    ref = {k: v[:TP_REFERENCE_ROWS] for k, v in batch.items()}
    grids = {}
    for mode in ("causal_cache", "fused", "reference"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        grids[mode] = model.forward_eval(ref if mode == "reference" else batch,
                                         precision="fp32", mode=mode)["predict"].cpu()
        if mode == "causal_cache":
            peak = torch.cuda.max_memory_allocated()
    return grids, peak


def tp_flat_grids(model, mc, batch) -> tuple:
    """(h): the flat engines' fp32 grids with early stop off over the first
    FLAT_CHECK_STEPS steps, as [6]'s checks run them: causal_cache on every
    row, reference on the first TP_REFERENCE_ROWS; and each decode's
    seconds."""
    import torch
    from faceformer_tpu_torch.decode import greedy_decode_single

    checked = dataclasses.replace(mc, label_seq_length=FLAT_CHECK_STEPS + 1)
    grids, seconds = {}, {}
    for mode, n in (("causal_cache", TP_ROWS), ("reference", TP_REFERENCE_ROWS)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grids[mode] = greedy_decode_single(model, checked, {k: v[:n] for k, v in batch.items()},
                                           precision="fp32", mode=mode,
                                           early_stop=False)["predict"].cpu()
        seconds[mode] = time.perf_counter() - t0
    return grids, seconds


def data_split_grads(model, cfg, batch, parts: int) -> dict:
    """The first step's gradients as ``parts`` data ranks make them, on one
    rank: each part's rows (r, r + parts, ...) through its own forward and
    backward of its loss over the whole batch's label tokens, the parts'
    gradients summed in part order."""
    from faceformer_tpu_torch.parallel.tensor import gather_params
    from faceformer_tpu_torch.train.loss import summed_cross_entropy

    losses, tokens = [], 0.0
    for r in range(parts):
        out = model.forward_train({k: v[r::parts].contiguous() for k, v in batch.items()},
                                  precision=cfg.trainer.precision)
        loss_sum, aux = summed_cross_entropy(out, cfg.model.token)
        losses.append(loss_sum)
        tokens += float(aux["valid_tokens"])
    total = {}
    for loss_sum in losses:
        model.zero_grad(set_to_none=True)
        (loss_sum / tokens).backward()
        for k, g in gather_params(model, grads=True).items():
            total[k] = g if k not in total else total[k] + g
    return {k: v.cpu() for k, v in total.items()}


def tp_reference(seed: int, out_dir: str, full: bool = True) -> dict:
    """One rank: (a)'s steps (the first step's gradients kept), and where
    ``full`` ([9]; [12] (c) takes (a) alone) (b)'s steps, (c)'s grids, and
    the flat model's (f) and (g) steps and (h) grids; the parameters after
    (a)'s and (f)'s steps and (a)'s gradients go to ``out_dir`` for the
    ranks."""
    import torch

    dev = torch.device("cuda")
    ref, grads = {}, {}
    for label, precision, dropout in (("fp32", "fp32", 0.0), ("bf16", "bf16", 0.2))[:1 + full]:
        cfg, model, batch = tp_setup(seed, dev, precision, dropout)
        ref[label] = {"param_bytes": sum(nbytes(p) for p in model.parameters())}
        fp32 = label == "fp32"
        losses, after = tp_steps(model, cfg, batch, seed, timed=ref[label],
                                 grads=grads if fp32 else None)
        ref[label]["losses"] = losses
        if fp32:
            params = after
        del model, batch
        torch.cuda.empty_cache()
    if not full:
        # the rounding control of [12] (c): the same gradients from the data
        # ranks' halves of the batch, summed, on this rank alone
        cfg, model, batch = tp_setup(seed, dev, "fp32", 0.0)
        ref["split_control"] = grad_errors(data_split_grads(model, cfg, batch, CARDS // 2),
                                           grads)
        del model, batch
        torch.cuda.empty_cache()
        torch.save({"params": params, "grads": grads}, os.path.join(out_dir, "want.pt"))
        return ref
    cfg, model, batch = tp_setup(seed, dev, "fp32", 0.0)
    grids, ref["decode_peak"] = tp_grids(model, cfg.model, batch)
    del model, batch
    torch.cuda.empty_cache()
    flat, flat_grads = {}, {}
    for label, precision, dropout, steps in (("fp32", "fp32", 0.0, TP_STEPS),
                                             ("bf16", "bf16", 0.2, 1)):
        cfg, model, batch = tp_flat_setup(seed, dev, precision, dropout)
        flat[label] = {"param_bytes": sum(nbytes(p) for p in model.parameters())}
        fp32 = label == "fp32"
        losses, after = tp_steps(model, cfg, batch, seed, steps=steps,
                                 timed=flat[label] if fp32 else None,
                                 grads=flat_grads if fp32 else None)
        flat[label]["losses"] = losses
        if fp32:
            flat_params = after
        del model, batch
        torch.cuda.empty_cache()
    # the rounding control: the same fp32 steps through the kernels' plain
    # versions, whose losses part from the kernels' by fp32 rounding alone
    cfg, model, batch = tp_flat_setup(seed, dev, "fp32", 0.0)
    flat["plain_losses"], _ = tp_steps(model, cfg, batch, seed, impl="plain")
    del model, batch
    torch.cuda.empty_cache()
    cfg, model, batch = tp_flat_setup(seed, dev, "fp32", 0.0)
    flat_grids, flat["decode_s"] = tp_flat_grids(model, cfg.model, batch)
    ref["flat"] = flat
    torch.save({"params": params, "grads": grads, "grids": grids, "ref": ref,
                "flat_params": flat_params, "flat_grads": flat_grads, "flat_grids": flat_grids},
               os.path.join(out_dir, "want.pt"))
    del model, batch
    torch.cuda.empty_cache()
    return ref


def tp_rank(seed: int, out_dir: str, size: int = 2) -> None:
    """A rank of [9], started by ``parallel.mesh.spawn`` on a grid of one
    data rank and two model ranks, or of [12] (c) on a grid of ``size`` //
    2 data ranks (each on its rows of the batch) and two model ranks, which
    runs (a) alone: (a) fp32 steps (the first step's gathered gradients
    kept), the model-axis
    collectives counted and timed, K2's and K3's heads and head offset a
    call recorded, then the same steps under the planted fault (each rank
    adds the row-parallel biases before the sum); (b) bf16 steps with
    dropout, the first K2 and K3 call of them held against their plain
    versions at the rank's head offset and at the other rank's (the planted
    fault), and the card's keep mask of the rank's heads; (c) the three
    engines' fp32 grids; then the flat model: (f) and (g) as (a) and (b),
    (g)'s held call the first at TP_FLAT_KEYS keys (the decoder
    self-attention, on the tensor-core key-tiled kernels), and (h) both
    flat engines' fp32 grids. Everything it read goes to ``out_dir``."""
    import contextlib
    import inspect

    import torch
    import torch.distributed as dist
    from faceformer_tpu_torch import ops
    from faceformer_tpu_torch.models import layers
    from faceformer_tpu_torch.ops import flash
    from faceformer_tpu_torch.parallel import mesh, tensor

    torch.backends.cuda.matmul.allow_tf32 = False
    world = mesh.make_mesh(size, "cuda", model_axis=2)
    dev = world.device
    want = torch.load(os.path.join(out_dir, "want.pt"))
    out = {"rank": world.rank, "backend": world.backend, "launches": collections.Counter(),
           "device": torch.cuda.current_device()}

    def mine(batch):  # the data rank's rows (all of them at one data rank)
        return {k: v[world.data_rank::world.data_size].contiguous() for k, v in batch.items()}

    probe = torch.full((8,), 1.5, dtype=torch.bfloat16, device=dev)
    try:
        dist.all_reduce(probe, group=world.model_group)
        out["gloo_bf16"] = f"takes bf16 CUDA tensors: 1.5 + 1.5 = {float(probe[0])}"
    except Exception as exc:  # recorded, and (b) then fails on its own
        out["gloo_bf16"] = f"refuses bf16 CUDA tensors: {exc!r}"

    heads = {"flash_fwd": set(), "flash_bwd": set()}  # (heads, head0) of each call
    # kind: (arguments, results, its tensor-core key-tiled launches) of the
    # first call with dropout at min_keys keys or more
    captured, min_keys = {}, {"n": 0}
    coll = {"calls": 0, "ms": 0.0, "bytes": 0}
    timed_run = {"on": False}
    real = {"fwd": flash.flash_attention_fwd, "bwd": flash.flash_attention_bwd,
            "all_reduce": dist.all_reduce, "all_gather": dist.all_gather,
            "broadcast": dist.broadcast, "row": layers.row_linear}

    def record(kind, fn):
        signature = inspect.signature(fn)
        tiled = f"{kind}_tiled_tc"

        def call(*args, **kwargs):
            bound = signature.bind(*args, **kwargs)
            bound.apply_defaults()
            a = bound.arguments
            heads[kind].add((int(a["q"].shape[2]), int(a["head0"])))
            before = ops.LAUNCHES[tiled]
            result = fn(*args, **kwargs)
            if (a["dropout_rate"] > 0 and kind not in captured
                    and a["k"].shape[1] >= min_keys["n"]):
                captured[kind] = ({k: v.clone() if torch.is_tensor(v) else v
                                   for k, v in a.items()}, tuple(r.clone() for r in result),
                                  ops.LAUNCHES[tiled] - before)
            return result
        return call

    def timed(fn, payload):
        def call(*args, group=None, **kwargs):
            if group is not world.model_group or not timed_run["on"]:
                return fn(*args, group=group, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, group=group, **kwargs)
            torch.cuda.synchronize()
            coll["calls"] += 1
            coll["ms"] += (time.perf_counter() - t0) * 1e3
            coll["bytes"] += nbytes(payload(args))
            return result
        return call

    @contextlib.contextmanager
    def recorded():
        heads["flash_fwd"].clear()
        heads["flash_bwd"].clear()
        captured.clear()
        coll.update(calls=0, ms=0.0, bytes=0)
        flash.flash_attention_fwd = record("flash_fwd", real["fwd"])
        flash.flash_attention_bwd = record("flash_bwd", real["bwd"])
        dist.all_reduce = timed(real["all_reduce"], lambda a: a[0])
        dist.all_gather = timed(real["all_gather"], lambda a: a[1])
        dist.broadcast = timed(real["broadcast"], lambda a: a[0])
        try:
            yield
        finally:
            flash.flash_attention_fwd, flash.flash_attention_bwd = real["fwd"], real["bwd"]
            dist.all_reduce, dist.all_gather = real["all_reduce"], real["all_gather"]
            dist.broadcast = real["broadcast"]

    def planted(lin, x, shard):  # the bias added on every rank, before the sum
        if shard is None:
            return real["row"](lin, x, shard)
        return tensor.reduce_from_model(
            x @ lin.weight.to(x.dtype).t() + lin.bias.to(x.dtype), shard)

    def fault_steps(setup, params_want, init, grads=None):
        """The fp32 steps under the planted fault: (losses, parameter
        distance); the first step's gathered gradients into ``grads`` when
        given."""
        layers.row_linear = planted
        try:
            cfg, model, batch = setup(seed, dev, "fp32", 0.0)
            tensor.shard_params_(model, world)
            losses, got = tp_steps(model, cfg, mine(batch), seed, world, grads=grads)
        finally:
            layers.row_linear = real["row"]
        del model
        torch.cuda.empty_cache()
        return losses, dp_distance(got, params_want, init)

    def offset_readings():
        """The captured K2 and K3 call against the plain versions at its
        head offset ('err') and at the other rank's ('fault')."""
        args, (o, lse), launches = captured["flash_fwd"]
        other = (world.model_axis - 1 - world.model_rank) * args["q"].shape[2]
        fwd = {"shape": list(args["q"].shape), "keys": int(args["k"].shape[1]),
               "head0": args["head0"], "tiled_tc_launches": launches}
        for label, head0 in (("err", args["head0"]), ("fault", other)):
            o_p, lse_p = real["fwd"](**{**args, "impl": "plain", "head0": head0})
            fwd[label] = max(float((o.float() - o_p.float()).abs().max()),
                             float((lse - lse_p).abs().max()))
        args, grads, launches = captured["flash_bwd"]
        bwd = {"shape": list(args["q"].shape), "keys": int(args["k"].shape[1]),
               "head0": args["head0"], "tiled_tc_launches": launches}
        for label, head0 in (("err", args["head0"]), ("fault", other)):
            want_g = real["bwd"](**{**args, "impl": "plain", "head0": head0})
            errs = [rel_errors(a, b) for a, b in zip(grads, want_g)]
            bwd[label] = [max(e[0] for e in errs), max(e[1] for e in errs)]
        captured.clear()
        return fwd, bwd

    with recorded(), deterministic(size > 2):
        cfg, model, batch = tp_setup(seed, dev, "fp32", 0.0)
        init = {k: p.detach().cpu() for k, p in model.named_parameters()}
        tensor.shard_params_(model, world)
        out["shard_bytes"] = sum(nbytes(p) for p in model.parameters())
        ops.reset_launches()
        grads = {}
        out["losses"], got = tp_steps(model, cfg, mine(batch), seed, world, timed=timed_run,
                                      grads=grads)
        out["grad_err"] = grad_errors(grads, want["grads"])
        out["launches_a"] = dict(ops.LAUNCHES)
        out["step_ms"], out["peak"] = timed_run["step_ms"], timed_run["peak"]
        out["launches"].update(ops.LAUNCHES)
        out["collectives"] = dict(coll)
        out["distance"] = dp_distance(got, want["params"], init)
        out["checksum"] = [float(v.double().sum()) for v in got.values()]
        out["key_bias_diff"] = max(float((got[k] - want["params"][k]).abs().max()) for k in got
                                   if k.endswith("attn.k.bias"))
        del model, got, grads
        torch.cuda.empty_cache()
        fault_grads = {} if size > 2 else None
        out["fault_losses"], out["fault_distance"] = fault_steps(tp_setup, want["params"], init,
                                                                 fault_grads)
        if size > 2:
            out["fault_grad_err"] = grad_errors(fault_grads, want["grads"])
            out["heads"] = {k: sorted(v) for k, v in heads.items()}
            out["launches"] = dict(out["launches"])
            torch.save(out, os.path.join(out_dir, f"tp_rank{world.rank}.pt"))
            return

        # (b) bf16, dropout 0.2
        cfg, model, batch = tp_setup(seed, dev, "bf16", 0.2)
        tensor.shard_params_(model, world)
        ops.reset_launches()
        bf16 = {}
        out["bf16_losses"], _ = tp_steps(model, cfg, batch, seed, world, timed=bf16)
        out["bf16_step_ms"], out["bf16_peak"] = bf16["step_ms"], bf16["peak"]
        out["launches"].update(ops.LAUNCHES)
    out["heads"] = {k: sorted(v) for k, v in heads.items()}
    # (b)'s first K2 and K3 call with dropout, as the training step made it,
    # against the plain versions at its head offset and at the other rank's
    out["offset_fwd"], out["offset_bwd"] = offset_readings()
    from faceformer_tpu_torch.ops.flash import keep_mask_on_card, philox_keep_mask

    n, h, sq, sk = TP_MASK
    head0 = world.model_rank * h
    card = keep_mask_on_card(seed, n, h, sq, sk, 0.2, dev, head0=head0)
    whole = philox_keep_mask(seed, n, 2 * h, sq, sk, 0.2, device=dev)
    out["mask"] = {"head0": head0,
                   "equals_plain": torch.equal(card, philox_keep_mask(seed, n, h, sq, sk, 0.2,
                                                                      device=dev, head0=head0)),
                   "equals_whole_heads": torch.equal(card, whole[:, head0:head0 + h]),
                   "kept": float(card.float().mean())}
    del model, batch, card, whole
    torch.cuda.empty_cache()

    # (c) the engines' fp32 grids
    cfg, model, batch = tp_setup(seed, dev, "fp32", 0.0)
    tensor.shard_params_(model, world)
    ops.reset_launches()
    grids, out["decode_peak"] = tp_grids(model, cfg.model, batch)
    out["launches_c"] = dict(ops.LAUNCHES)
    out["launches"].update(ops.LAUNCHES)
    out["grids_equal"] = {m: bool(torch.equal(g, want["grids"][m])) for m, g in grids.items()}
    out["grids_agree"] = {m: float((g == want["grids"][m]).float().mean())
                          for m, g in grids.items()}
    del model, batch
    torch.cuda.empty_cache()

    # (f) the flat model, fp32, dropout 0
    flat = out["flat"] = {}
    with recorded():
        cfg, model, batch = tp_flat_setup(seed, dev, "fp32", 0.0)
        init = {k: p.detach().cpu() for k, p in model.named_parameters()}
        tensor.shard_params_(model, world)
        flat["shard_bytes"] = sum(nbytes(p) for p in model.parameters())
        ops.reset_launches()
        grads = {}
        flat["losses"], got = tp_steps(model, cfg, batch, seed, world, timed=timed_run,
                                       grads=grads)
        flat["launches_f"] = dict(ops.LAUNCHES)
        flat["grad_err"] = grad_errors(grads, want["flat_grads"])
        out["launches"].update(ops.LAUNCHES)
        flat["step_ms"], flat["peak"] = timed_run["step_ms"], timed_run["peak"]
        flat["collectives"] = dict(coll)
        flat["distance"] = dp_distance(got, want["flat_params"], init)
        flat["checksum"] = [float(v.double().sum()) for v in got.values()]
        del model, got
        torch.cuda.empty_cache()
        flat["fault_losses"], flat["fault_distance"] = fault_steps(
            tp_flat_setup, want["flat_params"], init)
        flat["heads_f"] = {k: sorted(v) for k, v in heads.items()}

    # (g) bf16, dropout 0.2, one step; the first K2 and K3 call at the
    # decoder self-attention's keys held
    with recorded():
        min_keys["n"] = TP_FLAT_KEYS
        cfg, model, batch = tp_flat_setup(seed, dev, "bf16", 0.2)
        tensor.shard_params_(model, world)
        ops.reset_launches()
        flat["bf16_losses"], _ = tp_steps(model, cfg, batch, seed, world, steps=1)
        flat["launches_g"] = dict(ops.LAUNCHES)
        out["launches"].update(ops.LAUNCHES)
        flat["heads_g"] = {k: sorted(v) for k, v in heads.items()}
    flat["offset_fwd"], flat["offset_bwd"] = offset_readings()
    del model, batch
    torch.cuda.empty_cache()

    # (h) both flat engines' fp32 grids, early stop off
    cfg, model, batch = tp_flat_setup(seed, dev, "fp32", 0.0)
    tensor.shard_params_(model, world)
    ops.reset_launches()
    grids, flat["decode_s"] = tp_flat_grids(model, cfg.model, batch)
    flat["launches_h"] = dict(ops.LAUNCHES)
    out["launches"].update(ops.LAUNCHES)
    flat["grids"] = grids
    flat["grids_equal"] = {m: bool(torch.equal(g, want["flat_grids"][m]))
                           for m, g in grids.items()}
    flat["grids_agree"] = {m: float((g == want["flat_grids"][m]).float().mean())
                           for m, g in grids.items()}
    out["launches"] = dict(out["launches"])
    torch.save(out, os.path.join(out_dir, f"tp_rank{world.rank}.pt"))


def grad_errors(got: dict, want: dict) -> dict:
    """Each leaf's largest gradient difference relative to the leaf's
    largest magnitude, but the attention key biases' (their gradient is 0
    but for rounding): the three largest; the elements whose sign parts
    between the two (Adam's first update moves each by lr, by that sign)
    and the largest of their magnitudes in ``want`` relative to the leaf's;
    and the key biases' largest magnitude."""
    errs, flips, flip_max = {}, 0, 0.0
    for k, w in want.items():
        if k.endswith("attn.k.bias"):
            continue
        scale = max(float(w.abs().max()), 1e-30)
        errs[k] = float((got[k] - w).abs().max()) / scale
        flipped = got[k].sign() != w.sign()
        flips += int(flipped.sum())
        if flipped.any():
            flip_max = max(flip_max, float(w[flipped].abs().max()) / scale)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    return {"worst": worst, "sign_flips": flips, "flip_max": flip_max,
            "key_bias_max": max(float(got[k].abs().max()) for k in got
                                if k.endswith("attn.k.bias"))}


def tp_flat_report(ref: dict, got: list) -> None:
    """Prints and gates (f)-(h), the flat model under the model axis."""
    import torch

    want = ref["flat"]
    fl = [g["flat"] for g in got]
    r0 = fl[0]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], want["fp32"]["losses"]))
    fault_err = min(max(abs(a - b) / abs(b) for a, b in zip(f["fault_losses"],
                                                            want["fp32"]["losses"]))
                    for f in fl)
    bf16_err = max(abs(a - b) / abs(b) for a, b in zip(r0["bf16_losses"],
                                                        want["bf16"]["losses"]))
    control = [abs(a - b) / abs(b) for a, b in zip(want["plain_losses"],
                                                   want["fp32"]["losses"])]
    tp_steps_err = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], want["fp32"]["losses"])]
    coll = [f["collectives"] for f in fl]
    share = [round(c["ms"] / f["step_ms"], 3) for c, f in zip(coll, fl)]
    ranks_equal = {m: bool(torch.equal(fl[0]["grids"][m], fl[1]["grids"][m]))
                   for m in fl[0]["grids"]}
    print(f"[9] (f) the flat SurfaceFormer at synthetic-dirtok-big.yml's width (d 512, 8 heads, "
          f"FFN 1024, 6+6 layers, S 116, label_seq_length 512, direction tokens), 2 ranks at "
          f"model_axis 2 against 1, fp32, N={TP_ROWS}, dropout 0, {TP_STEPS} Adam steps: losses "
          f"{r0['losses']} vs {want['fp32']['losses']} (largest relative difference "
          f"{loss_err:.3g}; a step {[f'{x:.3g}' for x in tp_steps_err]}, gates {TP_LOSS_MAX} "
          f"then {TP_FLAT_LOSS_MAX}); "
          f"the rounding control, 1 rank through the plain versions: losses "
          f"{want['plain_losses']}, relative difference a step {[f'{x:.3g}' for x in control]}; "
          f"the first step's gathered gradients against 1 rank's, largest relative difference "
          f"per leaf (gate {TP_FLAT_GRAD_MAX}): {[f['grad_err'] for f in fl]}; parameter "
          f"distance {[f['distance'] for f in fl]} (gate {TP_UPDATE_MAX}); planted fault "
          f"(row-parallel bias added on both ranks): losses {[f['fault_losses'] for f in fl]}, "
          f"largest "
          f"relative difference {fault_err:.3g} (> {TP_FLAT_FAULT_MIN}), distance "
          f"{[f['fault_distance'] for f in fl]}; the ranks' gathered parameters equal: "
          f"{fl[0]['checksum'] == fl[1]['checksum']}; K2/K3 (heads, head0) a call "
          f"{[f['heads_f'] for f in fl]}; launches a rank {[f['launches_f'] for f in fl]}",
          flush=True)
    print(f"[9] (f) the flat TP step's model-axis collectives a rank {coll} over {TP_TIMED} "
          f"step(s) (the card synchronized around each) against the step's ms "
          f"{[round(f['step_ms'], 1) for f in fl]} ({share} of it) and 1 rank's "
          f"{want['fp32']['step_ms']:.1f} ms; a rank's parameters "
          f"{[f['shard_bytes'] for f in fl]} B vs 1 rank {want['fp32']['param_bytes']}; peak "
          f"bytes over the timed step {[f['peak'] for f in fl]} vs 1 rank "
          f"{want['fp32']['peak']}", flush=True)
    print(f"[9] (g) flat bf16, dropout 0.2, 1 step: loss {r0['bf16_losses']} vs "
          f"{want['bf16']['losses']} (relative difference {bf16_err:.3g}, gate "
          f"{TP_BF16_LOSS_MAX}); K2/K3 (heads, head0) a call {[f['heads_g'] for f in fl]}; "
          f"launches a rank {[f['launches_g'] for f in fl]}; the first K2 and K3 call at "
          f"{TP_FLAT_KEYS} keys against the plain versions at its head0 ('err') and at the other "
          f"rank's ('fault'; K2 max abs of out and lse, gate {K2_BF16_TOL}; K3 relative [max, "
          f"mean], gates {K3_BF16_MAX}, {K3_BF16_MEAN}): K2 {[f['offset_fwd'] for f in fl]}, K3 "
          f"{[f['offset_bwd'] for f in fl]}", flush=True)
    print(f"[9] (h) flat fp32 grids, early stop off, the first {FLAT_CHECK_STEPS} steps, "
          f"against 1 rank's (causal_cache N={TP_ROWS}, reference N={TP_REFERENCE_ROWS}): equal "
          f"{[f['grids_equal'] for f in fl]}, agreement "
          f"{[f['grids_agree'] for f in fl]}; the two ranks' grids equal {ranks_equal}; seconds "
          f"{[f['decode_s'] for f in fl]} vs 1 rank {want['decode_s']}; launches a "
          f"rank {[f['launches_h'] for f in fl]}", flush=True)
    steps = FLAT_CHECK_STEPS
    for g, f in zip(got, fl):
        offset = [[4, 4 * g["rank"]]]
        for stage in ("heads_f", "heads_g"):
            if {k: [list(x) for x in v] for k, v in f[stage].items()} != {
                    "flash_fwd": offset, "flash_bwd": offset}:
                fail(f"[9] ({stage[-1]}) rank {g['rank']}: (heads, head0) a call {f[stage]}")
        fwd, bwd = f["offset_fwd"], f["offset_bwd"]
        if fwd["keys"] != TP_FLAT_KEYS or bwd["keys"] != TP_FLAT_KEYS or not (
                fwd["tiled_tc_launches"] == 1 and bwd["tiled_tc_launches"] == 1):
            fail(f"[9] (g) rank {g['rank']}: the held call did not run the tensor-core "
                 f"key-tiled kernels at {TP_FLAT_KEYS} keys ({fwd}, {bwd})")
        if not (fwd["err"] <= K2_BF16_TOL and bwd["err"][0] <= K3_BF16_MAX
                and bwd["err"][1] <= K3_BF16_MEAN):
            fail(f"[9] (g) rank {g['rank']}: K2/K3 at head0 {fwd['head0']} part from their "
                 "plain versions")
        if not (fwd["fault"] >= 0.1 and bwd["fault"][0] >= 0.1):
            fail(f"[9] (g) rank {g['rank']}: the plain versions at the other rank's head "
                 "offset read within 0.1")
        for stage, kernels in (("launches_f", ("flash_fwd", "flash_bwd")),
                               ("launches_g", ("flash_fwd", "flash_bwd", "flash_fwd_tiled_tc",
                                               "flash_bwd_tiled_tc")),
                               ("launches_h", ("flash_fwd", "pointer_argmax"))):
            for k in kernels:
                if f[stage][k] <= 0:
                    fail(f"[9] ({stage[-1]}) rank {g['rank']}: {k} not launched")
        if f["launches_h"]["pointer_argmax"] != 2 * steps:
            fail(f"[9] (h) rank {g['rank']}: {f['launches_h']['pointer_argmax']} K1 launches, "
                 f"two decodes of {steps} steps imply {2 * steps}")
        if not all(f["grids_equal"].values()):
            fail(f"[9] (h) rank {g['rank']}: a flat grid differs from one rank's")
    if not all(ranks_equal.values()):
        fail("[9] (h): the two model ranks' flat grids differ")
    if (tp_steps_err[0] > TP_LOSS_MAX or max(tp_steps_err[1:]) > TP_FLAT_LOSS_MAX
            or max(f["distance"] for f in fl) > TP_UPDATE_MAX):
        fail("[9] (f): two model ranks do not train the flat model as one rank does")
    if fl[0]["checksum"] != fl[1]["checksum"] or fl[0]["losses"] != fl[1]["losses"]:
        fail("[9] (f): the two model ranks disagree")
    if max(f["grad_err"]["worst"][0][1] for f in fl) > TP_FLAT_GRAD_MAX:
        fail("[9] (f): the flat model's gathered gradients part from one rank's")
    if fault_err <= TP_FLAT_FAULT_MIN:
        fail("[9] (f): the planted fault moves the flat losses too little")
    if bf16_err > TP_BF16_LOSS_MAX:
        fail("[9] (g): the flat bf16 loss with dropout parts from one rank's")


def run_tp_phase(seed: int) -> dict:
    """Phase 9. Returns the launches of (a)-(c) and (f)-(h) on both ranks."""
    import torch
    from faceformer_tpu_torch.parallel import mesh
    from faceformer_tpu_torch.parallel.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as out_dir:
        ref = tp_reference(seed, out_dir)
        ref_s = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        mesh.spawn(2, tp_rank, seed, out_dir)
        ranks_s = time.perf_counter() - t0
        got = [torch.load(os.path.join(out_dir, f"tp_rank{r}.pt")) for r in (0, 1)]
    r0 = got[0]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref["fp32"]["losses"]))
    bf16_err = max(abs(a - b) / abs(b) for a, b in zip(r0["bf16_losses"],
                                                        ref["bf16"]["losses"]))
    print(f"[9] gloo between the ranks: {r0['gloo_bf16']}", flush=True)
    print(f"[9] (a) 2 ranks on one card at model_axis 2 (data 1 x model 2, backend "
          f"{r0['backend']}), each 4 of the 8 heads and 512 of the 1024 FFN columns, against 1 "
          f"rank: fp32 `ours` width, N={TP_ROWS}, dropout 0, {TP_STEPS} Adam steps: losses "
          f"{r0['losses']} vs {ref['fp32']['losses']} (largest relative difference "
          f"{loss_err:.3g}, gate {TP_LOSS_MAX}); the first step's gathered gradients, each "
          f"rank's worst leaf relative to its largest magnitude (no gate here; [12] (c) holds "
          f"them) {[g['grad_err']['worst'][0] for g in got]}; parameter distance "
          f"{[g['distance'] for g in got]} (gate {TP_UPDATE_MAX}); planted fault (row-parallel "
          f"bias added on both ranks) {[g['fault_distance'] for g in got]}; the ranks' gathered "
          f"parameters equal: {got[0]['checksum'] == got[1]['checksum']}; key biases (left out) "
          f"differ by up to {max(g['key_bias_diff'] for g in got):.3g}; K2/K3 (heads, head0) a "
          f"call in (a) and (b) {[g['heads'] for g in got]}; launches a rank "
          f"{[g['launches_a'] for g in got]}", flush=True)
    print(f"[9] (b) bf16, dropout 0.2: losses {r0['bf16_losses']} vs {ref['bf16']['losses']} "
          f"(largest relative difference {bf16_err:.3g}, gate {TP_BF16_LOSS_MAX}); the card's keep "
          f"mask {TP_MASK} of each rank's heads: {[g['mask'] for g in got]}; the first K2 and K3 "
          f"call with dropout against the plain versions at its head0 ('err') and at the other "
          f"rank's ('fault'; K2 max abs of out and lse, gate {K2_BF16_TOL}; K3 relative [max, "
          f"mean], gates {K3_BF16_MAX}, {K3_BF16_MEAN}): K2 {[g['offset_fwd'] for g in got]}, K3 "
          f"{[g['offset_bwd'] for g in got]}", flush=True)
    print(f"[9] (c) fp32 grids against 1 rank's (causal_cache and fused N={TP_ROWS}, reference "
          f"N={TP_REFERENCE_ROWS}): equal {[g['grids_equal'] for g in got]}, agreement "
          f"{[g['grids_agree'] for g in got]}; launches a rank {[g['launches_c'] for g in got]}",
          flush=True)
    print(f"[9] (e) a rank's parameters {[g['shard_bytes'] for g in got]} B vs 1 rank "
          f"{ref['fp32']['param_bytes']}; peak bytes over {TP_TIMED} steps after (a)'s and "
          f"(b)'s: fp32 {[g['peak'] for g in got]} vs 1 rank {ref['fp32']['peak']}, bf16 "
          f"{[g['bf16_peak'] for g in got]} vs {ref['bf16']['peak']}; the fp32 causal_cache "
          f"decode {[g['decode_peak'] for g in got]} vs {ref['decode_peak']}; ms a step over "
          f"them: fp32 {[round(g['step_ms'], 1) for g in got]} vs 1 rank "
          f"{ref['fp32']['step_ms']:.1f}, bf16 {[round(g['bf16_step_ms'], 1) for g in got]} vs "
          f"{ref['bf16']['step_ms']:.1f}; the fp32 steps' model-axis collectives a rank "
          f"{[g['collectives'] for g in got]} over {TP_TIMED} steps (the card synchronized "
          f"around each); seconds: one rank's runs {ref_s:.1f}, the ranks' {ranks_s:.1f} (with "
          f"(f)-(h))", flush=True)
    for g in got:
        offset = {k: [[4, 4 * g["rank"]]] for k in ("flash_fwd", "flash_bwd")}
        if g["backend"] != "gloo" or {k: [list(x) for x in v] for k, v in
                                      g["heads"].items()} != offset:
            fail(f"[9] (a) rank {g['rank']}: backend {g['backend']}, (heads, head0) a call "
                 f"{g['heads']}")
        fwd, bwd = g["offset_fwd"], g["offset_bwd"]
        if not (fwd["err"] <= K2_BF16_TOL and bwd["err"][0] <= K3_BF16_MAX
                and bwd["err"][1] <= K3_BF16_MEAN):
            fail(f"[9] (b) rank {g['rank']}: K2/K3 at head0 {fwd['head0']} part from their "
                 "plain versions")
        if not (fwd["fault"] > K2_BF16_TOL and bwd["fault"][0] > K3_BF16_MAX):
            fail(f"[9] (b) rank {g['rank']}: the plain versions at the other rank's head "
                 "offset read within the gates")
        for k in ("flash_fwd", "flash_bwd"):
            if g["launches_a"][k] <= 0:
                fail(f"[9] (a) rank {g['rank']}: {k} not launched")
        for k in ("pointer_argmax", "decode_step", "flash_fwd"):
            if g["launches_c"][k] <= 0:
                fail(f"[9] (c) rank {g['rank']}: {k} not launched")
        if not (g["mask"]["equals_plain"] and g["mask"]["equals_whole_heads"]):
            fail(f"[9] (b) rank {g['rank']}: the card's keep mask at head0 {g['mask']['head0']} "
                 "is not the whole mask's")
        if not all(g["grids_equal"].values()):
            fail(f"[9] (c) rank {g['rank']}: a grid differs from one rank's")
    if loss_err > TP_LOSS_MAX or max(g["distance"] for g in got) > TP_UPDATE_MAX:
        fail("[9] (a): two model ranks do not train as one rank does")
    if got[0]["checksum"] != got[1]["checksum"] or got[0]["losses"] != got[1]["losses"]:
        fail("[9] (a): the two model ranks disagree")
    if min(g["fault_distance"] for g in got) <= TP_UPDATE_MAX:
        fail("[9] (a): the planted fault reads within the gate")
    if bf16_err > TP_BF16_LOSS_MAX:
        fail("[9] (b): the bf16 losses with dropout part from one rank's")
    tp_flat_report(ref, got)
    t0 = time.perf_counter()
    line = dryrun_multichip(4)
    print(f"[9] (d) dryrun_multichip(4), four ranks on the card: {time.perf_counter() - t0:.1f} s",
          flush=True)
    if not line.startswith("dryrun_multichip ok: mesh=(2x2)"):
        fail(f"[9] (d): {line}")
    launches = collections.Counter()
    for g in got:
        launches.update(g["launches"])
    print(f"[9] the tensor-parallel phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches)


# ---------------------------------------------------------------------------
# phase 12 (--cards 4): the data and model axes on four cards over nccl
# ---------------------------------------------------------------------------

CARDS = 4
# (d): test_wrappers_launch_on_their_tensors_card's check (tests/test_torch_gpu.py):
# fp32, K2 and K3 within TENSORS_CARD_TOL of their plain versions, K1's and
# K4's tokens equal; K4 at that file's small decoder (CFG)
TENSORS_CARD_TOL = 1e-4
# (c): the first step's gathered gradients of data 2 x model 2 within
# CARDS_GRAD_MAX of one rank's, each leaf relative to its largest magnitude
# (grad_errors). [9] holds no gradient of the parallel model; the flat
# model's TP_FLAT_GRAD_MAX (model axis alone) reads 1.79e-4 here, at the
# encoder's q weights: at init the attention is near uniform, so q's
# gradient is a small sum of cancelling terms, and any other order of
# those sums moves it by that much. The gate lies between that reading
# (deterministic kernels on both sides) and the planted fault's, with the
# data split's rounding on one rank (data_split_grads) printed beside it
# (four NVIDIA H100 80GB HBM3, 700 W; PERF.md)
CARDS_GRAD_MAX = 1e-3
TENSORS_CARD_K4 = dict(num_points_per_line=8, num_lines=40, max_face_length=12, num_model=128,
                       num_head=2, num_feedforward=256, num_encoder_layers=2,
                       num_decoder_layers=2, dropout=0.0)
# (e): rows a card (configs/synthetic-big.yml's global batch of 32 over four
# cards), steps timed after the warm-ups; the 2e recipe it projects (ROADMAP
# item 2e): its steps (logs/SurfaceFormer/big-s0/metrics.jsonl's last), one
# validation every checkpoint_period 4 of its 40 epochs, 164 valid and 410
# test solids of the 8,192, eval batches of 32; one chip call's limit
CARDS_ROWS, CARDS_WARM, CARDS_TIMED = 8, 2, 5
RECIPE_2E = {"steps": 9_520, "validations": 10, "valid": 164, "test": 410, "batch": 32}
CALL_S = 3_600
# (f): the overrides of the flagship recipe's four-card run (remat off: the
# step 133-140 ms a card against 178-205 with remat full, PERF.md)
CARDS_STAGE = ("model.remat", "False")
NCCL_MARKS = ("NVLS", "NCCL version", "nRanks", "Pattern ")


def nccl_transport(debug_dir: str) -> dict:
    """What NCCL_DEBUG=INFO's files under ``debug_dir`` say of the link:
    the transports its channels took (counted), and its version, NVLS,
    communicator and search-pattern lines (the link type its graphs
    found; each once)."""
    via, lines = collections.Counter(), []
    for name in sorted(os.listdir(debug_dir)):
        with open(os.path.join(debug_dir, name), errors="replace") as f:
            for line in f:
                text = line.split("NCCL INFO", 1)[-1].strip()
                if " via " in text:
                    via[text.split(" via ", 1)[1]] += 1
                elif any(m in text for m in NCCL_MARKS) and text not in lines:
                    lines.append(text)
    return {"via": dict(via), "lines": lines[:24]}


def tensors_card_readings(card: int, seed: int = 5) -> dict:
    """tests/test_torch_gpu.py::test_wrappers_launch_on_their_tensors_card's
    check ([12] (d) runs it on cards 1-3): each of K1, K2, K3 and K4 given
    fp32 tensors on card ``card`` while card 0 is current. By kernel: its
    launches (ops.LAUNCHES), its output's card, and its difference from
    the plain version on the same tensors (K1's and K4's tokens: the count
    that differ; K2's and K3's outputs: the largest absolute difference);
    and the current card after them."""
    import torch
    from faceformer_tpu_torch import ops
    from faceformer_tpu_torch.config import ModelConfig
    from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel
    from faceformer_tpu_torch.ops.decode_step import decode_step
    from faceformer_tpu_torch.ops.flash import (flash_attention_bwd, flash_attention_fwd,
                                                padding_mask_bias)
    from faceformer_tpu_torch.ops.pointer import pointer_argmax
    from faceformer_tpu_torch.params import jitter_affine_

    dev, f32 = torch.device("cuda", card), torch.float32
    rng = np.random.default_rng(seed)
    out = {}

    def run(kernel, name, fn, *args, **kwargs):
        before = ops.LAUNCHES[name]
        result = fn(*args, **kwargs)
        out[kernel] = {"launches": ops.LAUNCHES[name] - before}
        return result

    with torch.cuda.device(0):
        rows, memory = (torch.as_tensor(rng.standard_normal(shape), dtype=f32, device=dev)
                        for shape in ((2, 30, 64), (2, 40, 64)))
        mask = torch.as_tensor(np.arange(40)[None] >= np.array([[40], [25]]), device=dev)
        got = run("K1", "pointer_argmax", pointer_argmax, rows, memory, mask)
        out["K1"].update(device=str(got.device), differ=int(
            (got != pointer_argmax(rows, memory, mask, impl="plain")).sum()))

        q, k, v, do = (torch.as_tensor(rng.standard_normal((2, 24, 2, 32)), dtype=f32,
                                       device=dev) for _ in range(4))
        bias = padding_mask_bias(mask[:, :24].contiguous())
        o, lse = run("K2", "flash_fwd", flash_attention_fwd, q, k, v, bias, causal=True)
        o_p, lse_p = flash_attention_fwd(q, k, v, bias, causal=True, impl="plain")
        out["K2"].update(device=str(o.device), err=float((o - o_p).abs().max()))
        grads = run("K3", "flash_bwd", flash_attention_bwd, q, k, v, bias, lse, do, causal=True)
        grads_p = flash_attention_bwd(q, k, v, bias, lse_p, do, causal=True, impl="plain")
        out["K3"].update(device=str(grads[0].device),
                         err=max(float((a - b).abs().max()) for a, b in zip(grads, grads_p)))

        cfg = ModelConfig(**TENSORS_CARD_K4)
        gen = torch.Generator().manual_seed(seed)
        model = SurfaceFormerParallel(cfg, generator=gen, device=dev)
        jitter_affine_(model, gen)
        inp = decode_inputs(model, cfg, rng, dev, f32, 3, 5)
        cache_p = inp["cache"].clone()
        _, tok = run("K4", "decode_step", decode_step, 5, **inp, num_head=cfg.num_head)
        _, tok_p = decode_step(5, **{**inp, "cache": cache_p}, num_head=cfg.num_head,
                               impl="plain")
        out["K4"].update(device=str(tok.device), differ=int((tok != tok_p).sum()))
        out["current_after"] = torch.cuda.current_device()
    return out


def tensors_card_failures(card: int, got: dict) -> list:
    """What ``tensors_card_readings`` of card ``card`` shows wrong."""
    bad = [f"K{i} {got[f'K{i}']}" for i in range(1, 5)
           if got[f"K{i}"]["launches"] != 1 or got[f"K{i}"]["device"] != f"cuda:{card}"
           or got[f"K{i}"].get("differ", 0) or got[f"K{i}"].get("err", 0.0) > TENSORS_CARD_TOL]
    if got["current_after"] != 0:
        bad.append(f"card {got['current_after']} current afterwards")
    return bad


def cards_step_rank(seed: int, out_dir: str) -> None:
    """A rank of [12] (e): configs/synthetic-big.yml as written (the `ours`
    width, bf16, dropout 0.2, lr 1e-4), CARDS_ROWS seeded wireframes a
    card, over CARDS nccl ranks; with remat full (as written) and off,
    CARDS_WARM steps, then CARDS_TIMED steps each timed with CUDA events, as
    is the gradient all-reduce in each; the rank's peak memory and launches
    a setting."""
    import torch
    from faceformer_tpu_torch import ops
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel
    from faceformer_tpu_torch.parallel import mesh
    from faceformer_tpu_torch.params import jitter_affine_
    from faceformer_tpu_torch.train.step import make_optimizer, train_step
    from faceformer_tpu_torch.train.trainer import rank_generator

    world = mesh.make_mesh(CARDS, "cuda")
    cfg = load_config(CLI_CONFIG)
    mc = cfg.model
    gen = torch.Generator().manual_seed(seed + 17)
    model = SurfaceFormerParallel(mc, generator=gen, device=world.device)
    jitter_affine_(model, gen)
    mesh.replicated(world, model)
    rng = np.random.default_rng(seed + 17 + world.rank)
    batch = training_batch(rng, random_wireframes(rng, CARDS_ROWS), mc, world.device)
    optimizer = make_optimizer(model, cfg.trainer)
    dropout = rank_generator(seed, world.data_rank)
    real, reduces = mesh.all_reduce_, []

    def timed_reduce(world_, tensors):
        if len(tensors) == 1:  # the label-token count
            return real(world_, tensors)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        real(world_, tensors)
        end.record()
        reduces.append((start, end))

    def event_ms(pairs):
        return [a.elapsed_time(b) for a, b in pairs]

    out = {"rank": world.rank, "backend": world.backend, "device": torch.cuda.current_device()}
    mesh.all_reduce_ = timed_reduce
    try:
        for remat in ("full", "off"):
            model.cfg = dataclasses.replace(mc, remat=remat == "full")
            torch.cuda.empty_cache()
            for _ in range(CARDS_WARM):
                train_step(model, optimizer, batch, dropout, cfg, world=world)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            reduces.clear()
            steps, losses = [], []
            for _ in range(CARDS_TIMED):  # queued one after another, as the fit queues them
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                losses.append(train_step(model, optimizer, batch, dropout, cfg,
                                         world=world)[0])
                end.record()
                steps.append((start, end))
            torch.cuda.synchronize()
            out[remat] = {"step_ms": event_ms(steps), "allreduce_ms": event_ms(reduces),
                          "peak": torch.cuda.max_memory_allocated(),
                          "losses": [float(x) for x in losses],
                          "launches": dict(ops.LAUNCHES)}
            # one more step under the sync check, on every rank: nothing in
            # it, the all-reduces over NCCL included, waits for the card
            _, out[remat]["sync_error"] = sync_free(
                lambda: train_step(model, optimizer, batch, dropout, cfg, world=world))
            torch.cuda.synchronize()
    finally:
        mesh.all_reduce_ = real
    torch.save(out, os.path.join(out_dir, f"step_rank{world.rank}.pt"))


def run_cards_steps(seed: int, cli: dict) -> dict:
    """[12] (e): ``cards_step_rank`` on the four cards; samples/s, the
    all-reduce's share of the step and each rank's peak memory by remat
    setting, and the projection of one seed of the 2e recipe against a
    chip call of CALL_S, its validations and test from (b)'s. Figures
    only: nothing is gated but finite losses and K2/K3 launched."""
    import torch
    from faceformer_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_steps_") as out_dir:
        mesh.spawn(CARDS, cards_step_rank, seed, out_dir)
        got = [torch.load(os.path.join(out_dir, f"step_rank{r}.pt")) for r in range(CARDS)]
    # (b)'s validation: its CLI_SPLIT[1] solids in eval batches of a multiple
    # of four rows (trainer.py's rounding), a few rows a rank: a batch's
    # seconds scale to the recipe's batches of 32 (an estimate: 8 rows a
    # rank there), its seconds a solid to the recipe's solids (a bound)
    rows = max(CARDS, min(RECIPE_2E["batch"], CLI_SPLIT[1]) // CARDS * CARDS)
    batch_s = cli["timing"]["valid_seconds"] / -(-CLI_SPLIT[1] // rows)
    solid_s = cli["timing"]["valid_seconds"] / CLI_SPLIT[1]
    batches = {k: -(-RECIPE_2E[k] // RECIPE_2E["batch"]) for k in ("valid", "test")}
    solids = RECIPE_2E["validations"] * RECIPE_2E["valid"] + RECIPE_2E["test"]
    readings = {}
    for remat in ("full", "off"):
        step_ms = float(np.median([np.mean(g[remat]["step_ms"]) for g in got]))
        share = [sum(g[remat]["allreduce_ms"]) / sum(g[remat]["step_ms"]) for g in got]
        steps_s = RECIPE_2E["steps"] * step_ms / 1e3
        eval_s = (RECIPE_2E["validations"] * batches["valid"] + batches["test"]) * batch_s
        eval_bound_s = solids * solid_s
        readings[remat] = {
            "step_ms": [[round(x, 2) for x in g[remat]["step_ms"]] for g in got],
            "samples_per_s": CARDS * CARDS_ROWS / (step_ms / 1e3),
            "allreduce_ms": [[round(x, 2) for x in g[remat]["allreduce_ms"]] for g in got],
            "allreduce_share": [round(x, 4) for x in share],
            "peak": [g[remat]["peak"] for g in got],
            "launches": [g[remat]["launches"] for g in got],
            "projection_s": {"steps": steps_s, "validations_and_test": eval_s,
                             "validations_and_test_bound": eval_bound_s,
                             "total": steps_s + eval_s, "call": CALL_S}}
        print(f"[12] (e) {CARDS} ranks x {CARDS_ROWS} rows, configs/synthetic-big.yml as "
              f"written, remat {remat}, {CARDS_TIMED} steps after {CARDS_WARM}: step ms a rank "
              f"{readings[remat]['step_ms']} (median of the ranks' means {step_ms:.2f}); "
              f"samples/s {readings[remat]['samples_per_s']:.2f}; gradient all-reduce ms "
              f"{readings[remat]['allreduce_ms']}, share of the step "
              f"{readings[remat]['allreduce_share']}; peak bytes a rank {readings[remat]['peak']}; "
              f"launches a rank {[{k: v for k, v in x.items() if v} for x in readings[remat]['launches']]}",
              flush=True)
        print(f"[12] (e) projection, one seed of 2e at remat {remat}: {RECIPE_2E['steps']} steps "
              f"x {step_ms:.2f} ms = {steps_s:.0f} s; {RECIPE_2E['validations']} validations of "
              f"{batches['valid']} batches and a test of {batches['test']} at (b)'s "
              f"{batch_s:.2f} s a batch = {eval_s:.0f} s ({solids} solids at (b)'s "
              f"{solid_s:.3f} s a solid, a bound: {eval_bound_s:.0f} s); {steps_s + eval_s:.0f} "
              f"s (bound {steps_s + eval_bound_s:.0f} s) against a {CALL_S} s call, before the "
              f"corpus and the start", flush=True)
        errors = [g[remat]["sync_error"] for g in got]
        print(f"[12] (e) remat {remat}: one more step a rank under "
              f"torch.cuda.set_sync_debug_mode('error'): "
              f"{'no call waited for the card' if not any(errors) else errors}", flush=True)
        if any(errors):
            fail(f"[12] (e) remat {remat}: a call in train_step waited for the card: {errors}")
        for g in got:
            if not all(np.isfinite(g[remat]["losses"])) or not all(
                    g[remat]["launches"][k] > 0 for k in ("flash_fwd", "flash_bwd")):
                fail(f"[12] (e) rank {g['rank']} remat {remat}: losses {g[remat]['losses']}, "
                     f"launches {g[remat]['launches']}")
    print(f"[12] (e) took {time.perf_counter() - t0:.1f} s", flush=True)
    return readings


def run_cards_model_axis(seed: int) -> dict:
    """[12] (c): ``dryrun_multichip(4)`` on the four cards (its ok line:
    mesh (2x2), backend nccl, the flagship at 6+6 layers); then [9] (a)'s
    fp32 steps on a grid of data 2 x model 2 (``tp_rank``) against one
    rank, both in torch's deterministic mode: the losses, the first step's
    gathered gradients and the parameters within [9]'s gates, the planted
    fault beyond them, and the model-axis collectives a step."""
    import torch
    from faceformer_tpu_torch.parallel import mesh
    from faceformer_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    line = dryrun_multichip(CARDS)
    dry_s = time.perf_counter() - t0
    print(f"[12] (c) dryrun_multichip({CARDS}) on the {CARDS} cards: {dry_s:.1f} s", flush=True)
    if not (line.startswith("dryrun_multichip ok: mesh=(2x2)") and "backend nccl" in line
            and "6+6 layers" in line):
        fail(f"[12] (c): {line}")
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp4_") as out_dir:
        with deterministic():
            ref = tp_reference(seed, out_dir, full=False)
        mesh.spawn(CARDS, tp_rank, seed, out_dir, CARDS)
        got = [torch.load(os.path.join(out_dir, f"tp_rank{r}.pt")) for r in range(CARDS)]
    want = ref["fp32"]["losses"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got[0]["losses"], want))
    fault_err = min(max(abs(a - b) / abs(b) for a, b in zip(g["fault_losses"], want))
                    for g in got)
    grad_worst = max(g["grad_err"]["worst"][0][1] for g in got)
    fault_grad = min(g["fault_grad_err"]["worst"][0][1] for g in got)
    coll = [g["collectives"] for g in got]
    share = [round(c["ms"] / g["step_ms"], 3) for c, g in zip(coll, got)]
    print(f"[12] (c) {CARDS} ranks at model_axis 2 (data 2 x model 2), backends "
          f"{[g['backend'] for g in got]} on cards {[g['device'] for g in got]}, against 1 rank: "
          f"fp32 `ours` width, N={TP_ROWS} ({TP_ROWS // 2} rows a data rank), dropout 0, "
          f"{TP_STEPS} Adam steps, deterministic kernels: losses {got[0]['losses']} vs {want} "
          f"(largest relative difference {loss_err:.3g}, gate {TP_LOSS_MAX}); the first step's "
          f"gathered gradients, worst leaves a rank {[g['grad_err']['worst'] for g in got]} "
          f"(gate {CARDS_GRAD_MAX}), sign flips {[g['grad_err']['sign_flips'] for g in got]}; "
          f"the rounding control (one rank, the two data ranks' halves summed) "
          f"{ref['split_control']}; parameter distance {[g['distance'] for g in got]} (gate "
          f"{TP_UPDATE_MAX}); planted fault (row-parallel bias added on both model ranks): "
          f"distance {[g['fault_distance'] for g in got]}, losses' relative difference "
          f"{fault_err:.3g}, gradients' worst leaf {fault_grad:.3g}; "
          f"the ranks' gathered parameters equal: "
          f"{all(g['checksum'] == got[0]['checksum'] for g in got)}; K2/K3 (heads, head0) a call "
          f"{[g['heads'] for g in got]}; launches a rank {[g['launches_a'] for g in got]}",
          flush=True)
    print(f"[12] (c) the model-axis collectives a rank over {TP_TIMED} fp32 step(s) (the card "
          f"synchronized around each) {coll}: {share} of the step's ms "
          f"{[round(g['step_ms'], 1) for g in got]} (1 rank {ref['fp32']['step_ms']:.1f}); "
          f"peak bytes {[g['peak'] for g in got]} (1 rank {ref['fp32']['peak']}); "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    for g in got:
        offset = [[4, 4 * (g["rank"] % 2)]]
        if g["backend"] != "nccl" or {k: [list(x) for x in v] for k, v in g["heads"].items()} \
                != {"flash_fwd": offset, "flash_bwd": offset}:
            fail(f"[12] (c) rank {g['rank']}: backend {g['backend']}, (heads, head0) a call "
                 f"{g['heads']}")
        for k in ("flash_fwd", "flash_bwd"):
            if g["launches_a"][k] <= 0:
                fail(f"[12] (c) rank {g['rank']}: {k} not launched")
    if len({g["device"] for g in got}) != CARDS:
        fail(f"[12] (c): the ranks' cards {[g['device'] for g in got]}")
    if loss_err > TP_LOSS_MAX or max(g["distance"] for g in got) > TP_UPDATE_MAX:
        fail("[12] (c): data 2 x model 2 does not train as one rank does")
    if grad_worst > CARDS_GRAD_MAX:
        fail("[12] (c): the gathered gradients part from one rank's")
    if any(g["checksum"] != got[0]["checksum"] or g["losses"] != got[0]["losses"]
           for g in got):
        fail("[12] (c): the four ranks disagree")
    if min(g["fault_distance"] for g in got) <= TP_UPDATE_MAX or fault_grad <= CARDS_GRAD_MAX:
        fail("[12] (c): the planted fault reads within the gates")
    return {"dryrun": line, "loss_err": loss_err, "grad_worst": grad_worst,
            "collectives": coll, "share": share, "launches": [g["launches"] for g in got]}


def run_cards_stage(tmp: str, syn: str, ranks: int = CARDS) -> dict:
    """[12] (f): the rehearsal of the flagship recipe's run on four cards,
    ``tools.train_demos run --out <tmp>/out flagship-s0`` with
    CARDS_STAGE's overrides on [5]'s corpus ``syn`` for one epoch, from
    ``tmp``. Gates: exit 0; a STAGE record of ``ranks`` ranks a phase whose
    tested checkpoint is the one ``best_path`` names; results.json the
    stage's, over the test split; on every rank K3 once a layer a step and
    K2 in the fit, K1 in the test; the audit files copied byte for byte.
    Returns each phase's launches a rank."""
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.train.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    version = "torch-big-s0"
    cfg = load_config(CLI_CONFIG, list(CARDS_STAGE))  # the flagship stage's config
    mc = cfg.model
    log = os.path.join(tmp, "logs", cfg.trainer.name, version)
    out = os.path.join(tmp, "out")
    _, stages = run_demos(tmp, f"train_demos run flagship-s0 at {ranks} ranks (1 epoch)", "run",
                          "--out", out, "flagship-s0", *CARDS_STAGE, "trainer.num_devices",
                          str(ranks), "root_dir", syn, "trainer.max_epochs", "1",
                          "trainer.checkpoint_period", "1", tag="[12] (f)")
    record = stages.get("flagship-s0")
    if record is None or record["version"] != version:
        fail(f"[12] (f): no STAGE record of flagship-s0 as {version}")
    best = CheckpointManager(os.path.join(log, "checkpoints")).best_path()
    results = None
    if os.path.isfile(os.path.join(log, "results.json")):
        with open(os.path.join(log, "results.json")) as f:
            results = json.load(f)
    steps = CLI_SPLIT[0] // cfg.batch_size_train
    per_step = mc.num_encoder_layers + 2 * mc.num_decoder_layers
    by_rank = {phase: record[phase]["by_rank"] for phase in ("fit", "test")}
    print(f"[12] (f) flagship-s0 at {ranks} ranks, {' '.join(CARDS_STAGE)}: fit "
          f"{record['fit']['seconds']:.1f} s, test {record['test']['seconds']:.1f} s; tested "
          f"{os.path.basename(record['tested_ckpt'])} (best_path {os.path.basename(best)}); "
          f"{record['results']}; by rank {json.dumps(by_rank)}", flush=True)
    print(f"[12] (f) the fit's epoch, ms a step over its {steps} steps (the writer's): "
          f"{json.dumps(record['fit']['epochs'][0]['ms_a_step'])}", flush=True)
    if record["tested_ckpt"] != best:
        fail(f"[12] (f) tested {record['tested_ckpt']}, best_path {best}")
    if results != record["results"] or record["results"]["num_samples"] != CLI_SPLIT[2]:
        fail(f"[12] (f): results.json {results}, the stage's {record['results']}")
    for phase in ("fit", "test"):
        if record[phase]["ranks"] != ranks or [r["rank"] for r in by_rank[phase]] != list(
                range(ranks)):
            fail(f"[12] (f) {phase}: {record[phase]['ranks']} ranks recorded, {ranks} run")
    for fit, test in zip(by_rank["fit"], by_rank["test"]):
        if (fit["launches"].get("flash_bwd") != steps * per_step
                or fit["launches"].get("flash_fwd", 0) < steps * per_step
                or test["launches"].get("pointer_argmax", 0) <= 0):
            fail(f"[12] (f) rank {fit['rank']}: launches fit {fit['launches']}, test "
                 f"{test['launches']}")
    copied = sorted(os.path.relpath(os.path.join(d, f), os.path.join(out, version))
                    for d, _, files in os.walk(os.path.join(out, version)) for f in files)
    metas = sorted(os.path.join("checkpoints", f) for f in os.listdir(os.path.join(
        log, "checkpoints")) if f.endswith(".meta.json"))
    want = sorted(["metrics.jsonl", "results.json", os.path.join("checkpoints", "index.json"),
                   *metas])
    if copied != want or not all(filecmp.cmp(os.path.join(out, version, rel),
                                             os.path.join(log, rel), shallow=False)
                                 for rel in copied):
        fail(f"[12] (f): audit files copied {copied}, expected {want} byte for byte")
    print(f"[12] (f) took {time.perf_counter() - t0:.1f} s", flush=True)
    return {phase: [r["launches"] for r in by_rank[phase]] for phase in ("fit", "test")}


def run_cards_phase(seed: int) -> dict:
    """Phase 12 (``--cards 4``): (a) the data axis, four nccl ranks against
    one (``run_dp_ranks``), NCCL_DEBUG=INFO's transport lines read from its
    files; [5]'s corpus written beside it on the host; (b) ``main ...
    trainer.num_devices 4`` (``run_dp_cli``) under causal_cache and fused;
    (c) the model axis (``run_cards_model_axis``); (d) each kernel on cards
    1-3 while card 0 is current (``tensors_card_readings``); (e) the step at
    CARDS_ROWS a card (``run_cards_steps``); (f) the flagship stage at one
    epoch (``run_cards_stage``). Returns each part's launches a rank."""
    t_phase = time.perf_counter()
    for i, line in enumerate(nvidia_smi(every_card=True)):
        print(f"[12] card {i}: {line}", flush=True)
    for query in (("topo", "-m"), ("nvlink", "-s", "-i", "0")):
        proc = subprocess.run(["nvidia-smi", *query], capture_output=True, text=True,
                              timeout=60)
        for line in (proc.stdout + proc.stderr).strip().splitlines()[:12]:
            print(f"[12] nvidia-smi {' '.join(query)}: {line}", flush=True)
    launches = {}
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_cards_")  # [5]'s corpus, (a)-(f)
    tmp = tmp_dir.name
    debug = os.path.join(tmp, "nccl_debug")
    os.makedirs(debug)
    env = {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT,GRAPH",
           "NCCL_DEBUG_FILE": os.path.join(debug, "%h.%p.log")}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        corpus = pool.submit(make_cli_corpus, tmp, "[12] (b)")
        os.environ.update(env)
        try:
            t0 = time.perf_counter()
            data = run_dp_ranks(seed, ranks=CARDS, backend="nccl", tag="[12] (a)")
        finally:
            for key in env:
                os.environ.pop(key)
        syn = corpus.result()
    link = nccl_transport(debug)
    print(f"[12] (a) NCCL_DEBUG=INFO: channels by transport {link['via']}; "
          f"{json.dumps(link['lines'])}; (a) with the corpus beside it "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not link["via"]:
        fail("[12] (a): NCCL's debug files name no transport")
    launches["(a)"] = data["launches"]
    cli = run_dp_cli(syn, None, CARDS, ("causal_cache", "fused"), "nccl", "[12] (b)")
    launches.update({f"(b) {k}": v for k, v in cli["by_rank"].items()})
    model_axis = run_cards_model_axis(seed)
    launches["(c) data 2 x model 2"] = model_axis["launches"]
    t0 = time.perf_counter()
    cards = {}
    for card in range(1, CARDS):
        cards[card] = tensors_card_readings(card)
        print(f"[12] (d) K1-K4 on card {card}'s tensors while card 0 is current: "
              f"{json.dumps(cards[card])}", flush=True)
        bad = tensors_card_failures(card, cards[card])
        if bad:
            fail(f"[12] (d) card {card}: {bad}")
    print(f"[12] (d) took {time.perf_counter() - t0:.1f} s", flush=True)
    launches["(d)"] = {f"card {c}": {k: r[k]["launches"] for k in ("K1", "K2", "K3", "K4")}
                       for c, r in cards.items()}
    steps = run_cards_steps(seed, cli)
    launches.update({f"(e) remat {k}": v["launches"] for k, v in steps.items()})
    launches.update({f"(f) {k}": v for k, v in run_cards_stage(tmp, syn).items()})
    tmp_dir.cleanup()
    print(f"[12] launches a rank: {json.dumps(launches)}", flush=True)
    print(f"[12] the four-card phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def build_phase() -> None:
    """[1]: every library built from the checkout (nvcc and g++ at once), with
    ptxas's register, shared-memory and spill lines, and the wgmma and
    mma.sync instructions the SASS must hold."""
    from faceformer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all(_build.SOURCES + (_build.HOST,))  # nvcc and g++ at once
    print(f"[1] built {built} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.SOURCES:
        with open(_build.log_path(name)) as f:
            kernel = ""
            for line in f:
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1]
                elif "registers" in line or "spill" in line or "Performance Loss" in line:
                    print(f"[1] ptxas {name} {kernel}: {line.strip()}", flush=True)
    hgmma = sum(sass_counts(_build.lib_path("decode_step"), "HGMMA").values())
    print(f"[1] cuobjdump -sass libdecode_step.so: {hgmma} HGMMA instructions (K4's GEMM on "
          f"wgmma)", flush=True)
    if not hgmma:
        fail("K4's GEMM holds no wgmma (HGMMA) instruction")
    tiled_tc = {fn: c for fn, c in sass_counts(_build.lib_path("flash"), "HMMA").items()
                if "attention_tiled_tc_kernel" in fn}
    for fn, c in tiled_tc.items():
        print(f"[1] cuobjdump -sass libflash.so: {c} HMMA instructions in {fn} (K2's "
              f"tensor-core key-tiled kernel on mma.sync)", flush=True)
    if len(tiled_tc) != 2 or not all(tiled_tc.values()):
        fail("K2's tensor-core key-tiled kernel: not both instantiations hold HMMA "
             f"instructions ({tiled_tc})")
    bwd_tiled = {fn: c for fn, c in sass_counts(_build.lib_path("flash_bwd"), "HMMA").items()
                 if "flash_bwd_dq_tiled_tc_kernel" in fn}
    for fn, c in bwd_tiled.items():
        print(f"[1] cuobjdump -sass libflash_bwd.so: {c} HMMA instructions in {fn} (K3's "
              f"tensor-core key-tiled dq kernel on mma.sync)", flush=True)
    if len(bwd_tiled) != 2 or not all(bwd_tiled.values()):
        fail("K3's tensor-core key-tiled dq kernel: not both instantiations hold HMMA "
             f"instructions ({bwd_tiled})")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tie-readings", default="", metavar="SEEDS",
                        help="comma-separated seeds: print only the readings the flat bf16 "
                             "serving check's limits are set from (flat_tie_readings)")
    parser.add_argument("--cards", type=int, choices=(1, CARDS), default=1,
                        help=f"{CARDS}: only [1] and [12], the data and model axes over nccl "
                             f"with a card a rank; needs {CARDS} visible cards")
    args = parser.parse_args()
    # Every process this script starts imports torch, and a host that sets
    # PYTHONDONTWRITEBYTECODE compiles torch's sources again in each one
    # (~7 s a process on the card machine): keep their bytecode under the
    # checkout's build/ instead, for this process and every one it starts.
    pycache = os.path.join(REPO, "build", "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = pycache
    sys.dont_write_bytecode, sys.pycache_prefix = False, pycache

    import torch

    if args.cards > 1:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < args.cards:
            print(f"--cards {args.cards} needs {args.cards} visible CUDA cards: {count} visible",
                  file=sys.stderr)
            return 1
    if not torch.cuda.is_available():
        print("no CUDA card visible: chip_smoke needs one", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tie_readings:
        print(f"{torch.cuda.get_device_name(0)}: {nvidia_smi()}", flush=True)
        flat_tie_readings([int(x) for x in args.tie_readings.split(",")], torch.device("cuda"))
        return 0

    from faceformer_tpu_torch import ops
    from faceformer_tpu_torch.config import load_config
    from faceformer_tpu_torch.models.parallel import SurfaceFormerParallel
    from faceformer_tpu_torch.params import jitter_affine_

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[1] device {kind} count={torch.cuda.device_count()} nvidia-smi: {smi}", flush=True)
    build_phase()
    if args.cards > 1:
        launches = run_cards_phase(args.seed)
        print(f"[12] the script took {time.perf_counter() - t_start:.1f} s", flush=True)
        print(json.dumps({"cards": args.cards, "launches_a_rank": launches}), flush=True)
        print(nvidia_smi(), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
        return 0

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
    launches, train_rates = run_training(cfg, rng, args.seed,
                                         random_wireframes(rng, train_n), dev)
    for k, v in launches.items():
        total[k] += v

    # phase 4: timing at the main path's shapes, bf16
    bf = torch.bfloat16
    timings = []
    from faceformer_tpu_torch.ops.decode_step import decode_step
    from faceformer_tpu_torch.ops.flash import flash_attention_fwd, padding_mask_bias
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
    flash_lib, k3_lib = flash_libraries()
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
    pointer_phase = k4_pointer_phase(rng, dev, n, f, s, e)
    # K3 (and K2 with dropout) at the three training shapes, bf16, dropout on
    k3_rows = {}
    for label, n3, sq, sk, causal, _ in TRAIN_SHAPES:
        inputs = train_attention_inputs(rng, dev, bf, label, n3, sq, sk, h, hd)
        k2_rows[label], k3_rows[label] = time_flash_call(label, *inputs, causal, flash_lib,
                                                         k3_lib)
        del inputs
    row = k3_rows["cross"]
    timings.insert(2, ("flash_bwd", "faceformer_tpu_torch/csrc/flash_bwd.cu",
                       "faceformer_tpu/ops/flash.py:293", row["ms"], row["plain_ms"],
                       row["library_ms"], row["bound_ms"], row["bound_by"]))
    for name, _, _, ms, plain, lib, bnd, by in timings:
        print(f"[4] {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {bnd:.5f} ms ({by})",
              flush=True)

    # phase 5: the command line at the `ours` width, each run a subprocess of
    # its own; this process gives back the memory phases 3 and 4 cached
    del model, rows, memory, mask
    torch.cuda.empty_cache()
    corpus = tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_")  # [5] and [7]
    syn = make_cli_corpus(corpus.name)
    cli_launches, cli_numbers = run_cli_phase(train_rates, syn)
    for k, v in cli_launches.items():
        total[k] += v
    # phase 10 on [5]'s corpus; [6] and [8] run it on theirs
    t0 = time.perf_counter()
    host = {"synthetic-big": check_host_loader("[5]'s synthetic-big corpus", syn, CLI_CONFIG),
            "host_kernels_ms": time_host_kernels(syn, CLI_CONFIG)}
    host["synthetic-big"]["check_s"] = time.perf_counter() - t0

    # phase 6: the flat model at the synthetic-dirtok-big width
    flat_launches, flat_err, flat_rows = run_flat_phase(args.seed, rng, dev, host)
    for k, v in flat_launches.items():
        total[k] += v
    for k, v in flat_err.items():
        err[k] = max(err.get(k, 0.0), v)
    # K2's tensor-core key-tiled kernel, timed at the flat decoder
    # self-attention (its other shapes ride along)
    row = flat_rows["flash_fwd"]["flat-decoder-self"]
    timings.append(("flash_fwd_tiled_tc", "faceformer_tpu_torch/csrc/attention_tiled_tc.cuh",
                    "faceformer_tpu/ops/flash.py:252", row["ms"], row["plain_ms"],
                    row["library_ms"], row["bound_ms"], row["bound_by"]))
    if not total["flash_fwd_tiled_tc"]:
        fail("K2's tensor-core key-tiled kernel was not launched on the flat main paths")
    print(f"[6] flash_fwd_tiled_tc: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']}); launches {total['flash_fwd_tiled_tc']}", flush=True)
    # K3's tensor-core key-tiled pair, timed alike
    row = flat_rows["flash_bwd"]["flat-decoder-self"]
    timings.append(("flash_bwd_tiled_tc", "faceformer_tpu_torch/csrc/flash_bwd_tiled_tc.cuh",
                    "faceformer_tpu/ops/flash.py:293", row["ms"], row["plain_ms"],
                    row["library_ms"], row["bound_ms"], row["bound_by"]))
    if not total["flash_bwd_tiled_tc"]:
        fail("K3's tensor-core key-tiled pair was not launched on the flat main paths")
    print(f"[6] flash_bwd_tiled_tc: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']}); launches {total['flash_bwd_tiled_tc']}", flush=True)

    # phase 7: ranks, the remat policies, tools.profile
    torch.cuda.empty_cache()
    for k, v in run_ranks_phase(args.seed, rng, syn,
                                cli_numbers["fit_samples_per_s_epoch2"]).items():
        total[k] += v
    corpus.cleanup()

    # phase 8: the corpus pipeline, then one epoch at the step-native-big width
    torch.cuda.empty_cache()
    for k, v in run_corpus_phase(host).items():
        total[k] += v

    # phase 9: tensor parallelism over the model axis
    torch.cuda.empty_cache()
    for k, v in run_tp_phase(args.seed).items():
        total[k] += v

    print(f"[10] the host path on {nvidia_smi()}, {os.cpu_count()} host cores, "
          f"{sum(v['check_s'] for k, v in host.items() if 'check_s' in v):.1f} s in all: "
          f"{json.dumps(host)}", flush=True)

    # phase 11
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": total[name], "max_abs_err": err[name], "ms": ms, "plain_ms": plain,
         "bound_ms": bnd, "bound_by": by, "library_ms": lib}
        for name, src, rep, ms, plain, lib, bnd, by in timings]}
    # K2's entry is the serving encoder call and K3's the cross-attention
    # call; their other shapes ride along, the flat model's among them
    summary["kernels"][0]["shapes"] = flat_rows["pointer_argmax"]
    summary["kernels"][1]["shapes"] = {**k2_rows, **flat_rows["flash_fwd"]}
    summary["kernels"][2]["shapes"] = {**k3_rows, **flat_rows["flash_bwd"]}
    summary["kernels"][3]["gemm_phase"] = gemm_phase
    summary["kernels"][3]["pointer_phase"] = pointer_phase
    summary["kernels"][4]["shapes"] = {label: flat_rows["flash_fwd"][label]
                                       for label in ("flat-decoder-self", LONG_TIMED[0])}
    summary["kernels"][5]["shapes"] = {label: flat_rows["flash_bwd"][label]
                                       for label in ("flat-decoder-self", LONG_TIMED[0])}
    print(f"[11] the script took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(summary), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
