"""Hand-written Hopper kernels for the port's hot ops, one module each.

Every wrapper dispatches on the device of the tensors it is given: a CUDA
tensor launches the CUDA kernel (built from ``csrc/`` at first use) or
raises; a CPU tensor runs the module's plain PyTorch version. There is no
switch and no fallback. ``impl="plain"`` runs the plain version on any
device, for comparisons.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that it
went through the kernels; ``reset_launches`` sets every count to 0. The
last two entries count test entries that expose a phase of K4 alone (its
pointer argmax with the gather, and one of its GEMMs); no main path calls
them.
"""

from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {"pointer_argmax": 0, "flash_fwd": 0, "flash_bwd": 0,
                            "decode_step": 0, "pointer_argmax_gather": 0, "decode_gemm": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_kernel(impl: str, *tensors) -> bool:
    """True to launch the CUDA kernel: the tensors lie on a card and the
    caller did not ask for the plain version."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', not {impl!r}")
    devices = {t.device.type for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(devices)}")
    return impl == "auto" and devices == {"cuda"}
