"""Time K2's and K3's kernels against each other at shapes several of
them can take, on one card.

    python -m faceformer_tpu_torch.tools.time_key_tiles

The usual build sends a K2 call past 256 keys to a key-tiled kernel (bf16
at hd = 64: ``csrc/attention_tiled_tc.cuh``, on the tensor cores; else
``csrc/flash.cu::attention_tiled_kernel``; at hd = 32 only past its
whole-row kernel's shared memory). K3 in bf16 at hd = 64 past 256 keys
runs the tensor-core key-tiled pair (``csrc/flash_bwd_tiled_tc.cuh``),
elsewhere ``csrc/flash_bwd.cu::flash_bwd_dq_tiled_kernel`` only where the
whole-row dq kernel's shared memory exceeds a block's. This script builds
more copies of the sources, each sending the calls elsewhere, and runs
each shape through every build: the outputs must agree with the usual
build's within the kernels' gates, and each is timed with CUDA events. The
builds:
  - key-tiled (``FF_KEY_TILES_ALWAYS``, K2 and K3): every call key-tiled
    (K3 in bf16 at hd = 64 on the tensor-core pair at any key length);
  - whole-row (``FF_WHOLE_ROWS``, K2): the whole-row kernels wherever they
    fit a block, the dispatch before the tensor-core tiled kernel;
  - K3 CUDA cores (``FF_CUDA_CORE_TILES``, K3): K3 past 256 keys on the
    CUDA-core whole-row or key-tiled dq and the CUDA-core dk/dv, the
    dispatch before the tensor-core key-tiled pair;
  - CUDA-core tiled (``FF_KEY_TILES_ALWAYS`` and ``FF_CUDA_CORE_TILES``,
    K2 and K3): every call on the CUDA-core tiled kernels;
  - light first (``FF_KEY_TILES_ALWAYS`` and ``FF_LIGHT_FIRST``, K2): the
    tensor-core tiled kernel launching its query tiles in order, early
    (light, under a causal mask) tiles first, where the usual order runs
    the late ones first.
8 heads, batch 32, attention dropout 0.2 as in training. Prints the card,
a line a shape and kernel, and one JSON line of every reading.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys

from faceformer_tpu_torch.ops import _build

# (label, dtype, Sq, Sk, causal, hd): at hd = 64 fp32 where the whole-row
# K2 (420 keys) and dq (391) kernels hold, bf16 past the tensor cores' 256
# keys, and bf16 at the flat decoder's 512 keys, where only K2 has a
# whole-row kernel; the same at hd = 32; and bf16 up to 256 keys, where
# the whole-row tensor-core kernel runs
SHAPES = (("fp32 causal 384", "float32", 384, 384, True, 64),
          ("fp32 512 vs 320", "float32", 512, 320, False, 64),
          ("bf16 causal 384", "bfloat16", 384, 384, True, 64),
          ("bf16 causal 512", "bfloat16", 512, 512, True, 64),
          ("fp32 hd32 causal 384", "float32", 384, 384, True, 32),
          ("fp32 hd32 512 vs 320", "float32", 512, 320, False, 32),
          ("bf16 hd32 causal 384", "bfloat16", 384, 384, True, 32),
          ("bf16 hd32 512 vs 320", "bfloat16", 512, 320, False, 32),
          ("bf16 causal 256", "bfloat16", 256, 256, True, 64),
          ("bf16 512 vs 220", "bfloat16", 512, 220, False, 64))
N, H, RATE, SEED = 32, 8, 0.2, 1234
GATES = {"float32": 1e-4, "bfloat16": 2e-2}  # max error relative to the output's largest
# build -> (sources, nvcc defines)
BUILDS = {"key-tiled": (("flash", "flash_bwd"), ("FF_KEY_TILES_ALWAYS",)),
          "whole-row": (("flash",), ("FF_WHOLE_ROWS",)),
          "K3 CUDA cores": (("flash_bwd",), ("FF_CUDA_CORE_TILES",)),
          "CUDA-core tiled": (("flash", "flash_bwd"), ("FF_KEY_TILES_ALWAYS",
                                                      "FF_CUDA_CORE_TILES")),
          "light first": (("flash",), ("FF_KEY_TILES_ALWAYS", "FF_LIGHT_FIRST"))}


def build_variants() -> dict:
    """Every build of BUILDS, one nvcc a source and build, all at once,
    loaded as the libraries ``_build`` would load: {build: {source: lib}}."""
    procs = {}
    for build, (names, defines) in BUILDS.items():
        out_dir = os.path.join(_build.BUILD_DIR, "variants", build.replace(" ", "_"))
        os.makedirs(out_dir, exist_ok=True)
        for name in names:
            path = os.path.join(out_dir, f"lib{name}.so")
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", path,
                   os.path.join(_build.CSRC, f"{name}.cu")]
            procs[build, name] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True))
    libs = {build: {} for build in BUILDS}
    for (build, name), (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}.cu for the {build} build (nvcc exit "
                               f"{proc.returncode}):\n{log}")
        lib = ctypes.CDLL(path)
        lib.ff_error_string.argtypes = [ctypes.c_int]
        lib.ff_error_string.restype = ctypes.c_char_p
        libs[build][name] = lib
    return libs


@contextlib.contextmanager
def libraries(libs: dict):
    """The flash wrappers call into ``libs`` inside the block."""
    saved = {name: _build.load(name) for name in libs}
    _build._LIBS.update(libs)
    try:
        yield
    finally:
        _build._LIBS.update(saved)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def main() -> int:
    import torch

    from faceformer_tpu_torch.ops.flash import (
        flash_attention_bwd,
        flash_attention_fwd,
        key_tile,
        padding_mask_bias,
    )

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else torch.cuda.get_device_name(0),
          flush=True)
    _build.build_all(("flash", "flash_bwd"))
    variants = {"usual": {}, **build_variants()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    readings, ok = [], True
    for label, dt, sq, sk, causal, hd in SHAPES:
        dtype = getattr(torch, dt)
        q = torch.randn((N, sq, H, hd), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((N, sk, H, hd), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        do = torch.randn((N, sq, H, hd), generator=gen, device="cuda").to(dtype)
        pad = torch.zeros((N, sk), dtype=torch.bool, device="cuda")
        pad[N // 2:, sk - sk // 8:] = True  # a ragged key side
        bias = padding_mask_bias(pad)
        kw = dict(causal=causal, dropout_rate=RATE, seed=SEED)
        lse = flash_attention_fwd(q, k, v, bias, **kw)[1]
        calls = {"flash_fwd": lambda: flash_attention_fwd(q, k, v, bias, **kw),
                 "flash_bwd": lambda: flash_attention_bwd(q, k, v, bias, lse, do, **kw)}
        for kernel, call in calls.items():
            which = "fwd" if kernel == "flash_fwd" else "bwd"
            runs = {}
            source = "flash" if kernel == "flash_fwd" else "flash_bwd"
            for build, libs in variants.items():
                if build != "usual" and source not in libs:
                    continue  # a build of the other kernel alone
                with libraries(libs):
                    runs[build] = dict(tile=key_tile(which, dtype, sk, hd), out=call(),
                                       ms=time_ms(call))
            row = dict(shape=label, kernel=kernel, dtype=dt, sq=sq, sk=sk, causal=causal,
                       hd=hd, builds={})
            parts = []
            for build, run in runs.items():
                err = max(rel_err(a, b) for a, b in zip(run["out"], runs["usual"]["out"]))
                ok &= err <= GATES[dt]
                row["builds"][build] = dict(tile=run["tile"], ms=run["ms"], rel_err=err)
                parts.append(f"{build} ({run['tile'] or 'whole'}) {run['ms']:.4f} ms "
                             f"({run['ms'] / runs['usual']['ms']:.3f} x, err {err:.3g})")
            readings.append(row)
            print(f"{kernel} {label} q({N},{sq},{H},{hd}) k({N},{sk}) dropout {RATE}: "
                  f"{'; '.join(parts)} (gate {GATES[dt]}; tile in keys)", flush=True)
            del runs
        del q, k, v, do, bias, lse
    print(json.dumps({"key_tiles": readings}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
