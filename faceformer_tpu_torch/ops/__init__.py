"""Hand-written Hopper kernels for the port's hot ops, one module each.

Every wrapper dispatches on the device of the tensors it is given: a CUDA
tensor launches the CUDA kernel (built from ``csrc/`` at first use) inside
``launching``, or raises; a CPU tensor runs the module's plain PyTorch
version. There is no
switch and no fallback. ``impl="plain"`` runs the plain version on any
device, for comparisons.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that it
went through the kernels; ``reset_launches`` sets every count to 0.
"flash_fwd_tiled_tc" counts the flash forward's launches that ran its
key-tiled tensor-core kernel (bf16 at hd = 64 past 256 keys), each also
counted under "flash_fwd"; "flash_bwd_tiled_tc" the flash backward's
launches that ran its key-tiled tensor-core pair (the same calls), each
also counted under "flash_bwd". The last two entries count test entries that
expose a phase of K4 alone (its pointer argmax with the gather, and one of
its GEMMs); no main path calls them.
"""

from __future__ import annotations

import contextlib
from typing import Dict

LAUNCHES: Dict[str, int] = {"pointer_argmax": 0, "flash_fwd": 0, "flash_fwd_tiled_tc": 0,
                            "flash_bwd": 0, "flash_bwd_tiled_tc": 0, "decode_step": 0,
                            "pointer_argmax_gather": 0, "decode_gemm": 0}


# each launch runs inside a profiler range named RANGE + its LAUNCHES key
RANGE = "ff.launch."


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def launching(name: str, device):
    """The context of one launch by wrapper ``name`` for tensors on
    ``device``: that card current, so the C entry's launches, attribute
    settings and error checks go to the card that holds the pointers
    whichever card the calling thread had current; a profiler range
    ``RANGE + name``, by which ``tools.profile`` gives the wrapper the
    device time of every kernel its C entry launched; and, where the block
    raises nothing, one more launch counted under ``name``."""
    import torch

    with torch.profiler.record_function(RANGE + name), torch.cuda.device(device):
        yield
    LAUNCHES[name] += 1


def use_kernel(impl: str, *tensors) -> bool:
    """True to launch the CUDA kernel: the tensors lie on a card and the
    caller did not ask for the plain version."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', not {impl!r}")
    devices = {t.device.type for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(devices)}")
    return impl == "auto" and devices == {"cuda"}
