"""Time K2's and K3's key-tiled CUDA-core kernels against the whole-row
kernels at shapes both can take, on one card.

    python -m faceformer_tpu_torch.tools.time_key_tiles

A call takes a key-tiled kernel (``csrc/flash.cu::attention_tiled_kernel``,
``csrc/flash_bwd.cu::flash_bwd_dq_tiled_kernel``) only where the whole-row
kernel's shared memory exceeds a block's. This script builds a second copy
of both sources with ``FF_KEY_TILES_ALWAYS``, which sends every CUDA-core
call to the key-tiled kernel, and runs each shape through the usual build
and through that copy: the two outputs must agree within the kernels'
gates, and each is timed with CUDA events. bf16 and fp32, 8 heads of 64,
batch 32, attention dropout 0.2 as in training. Prints the card, a line a
shape and kernel, and one JSON line of every reading.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys

from faceformer_tpu_torch.ops import _build

# (label, dtype, Sq, Sk, causal): fp32 where the whole-row K2 (420 keys)
# and dq (391) kernels hold, bf16 past the tensor cores' 256 keys, and
# bf16 at the flat decoder's 512 keys, where only K2 has a whole-row kernel
SHAPES = (("fp32 causal 384", "float32", 384, 384, True),
          ("fp32 512 vs 320", "float32", 512, 320, False),
          ("bf16 causal 384", "bfloat16", 384, 384, True),
          ("bf16 causal 512", "bfloat16", 512, 512, True))
N, H, HD, RATE, SEED = 32, 8, 64, 0.2, 1234
GATES = {"float32": 1e-4, "bfloat16": 2e-2}  # max error relative to the output's largest


def build_tiled() -> dict:
    """csrc/flash.cu and csrc/flash_bwd.cu built with FF_KEY_TILES_ALWAYS,
    both nvcc at once, loaded as the libraries ``_build`` would load."""
    out_dir = os.path.join(_build.BUILD_DIR, "key_tiles")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ("flash", "flash_bwd"):
        path = os.path.join(out_dir, f"lib{name}.so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-DFF_KEY_TILES_ALWAYS", "-o", path,
               os.path.join(_build.CSRC, f"{name}.cu")]
        procs[name] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}.cu with FF_KEY_TILES_ALWAYS (nvcc exit "
                               f"{proc.returncode}):\n{log}")
        lib = ctypes.CDLL(path)
        lib.ff_error_string.argtypes = [ctypes.c_int]
        lib.ff_error_string.restype = ctypes.c_char_p
        libs[name] = lib
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
    tiled = build_tiled()
    gen = torch.Generator(device="cuda").manual_seed(0)
    readings, ok = [], True
    for label, dt, sq, sk, causal in SHAPES:
        dtype = getattr(torch, dt)
        q = torch.randn((N, sq, H, HD), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((N, sk, H, HD), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        do = torch.randn((N, sq, H, HD), generator=gen, device="cuda").to(dtype)
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
            for build, libs in (("usual", {}), ("key-tiled", tiled)):
                with libraries(libs):
                    runs[build] = dict(tile=key_tile(which, dtype, sk, HD), out=call(),
                                       ms=time_ms(call))
            err = max(rel_err(a, b) for a, b in zip(runs["key-tiled"]["out"],
                                                     runs["usual"]["out"]))
            row = dict(shape=label, kernel=kernel, dtype=dt, sq=sq, sk=sk, causal=causal,
                       usual_tile=runs["usual"]["tile"], usual_ms=runs["usual"]["ms"],
                       tiled_ms=runs["key-tiled"]["ms"], rel_err=err)
            readings.append(row)
            ok &= err <= GATES[dt]
            usual = (f"key-tiled, {row['usual_tile']} keys a tile" if row["usual_tile"]
                     else "whole row")
            print(f"{kernel} {label} q({N},{sq},{H},{HD}) k({N},{sk}) dropout {RATE}: usual "
                  f"build ({usual}) {row['usual_ms']:.4f} ms, key-tiled {row['tiled_ms']:.4f} ms "
                  f"({row['tiled_ms'] / row['usual_ms']:.3f} x); outputs agree to {err:.3g} "
                  f"(<= {GATES[dt]})", flush=True)
            del runs
        del q, k, v, do, bias, lse
    print(json.dumps({"key_tiles": readings}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
