"""Ranks over torch.distributed: the data and model axes (``mesh.py``), the
Megatron split over the model axis (``tensor.py``) and the multi-rank dry
run (``dryrun.py``)."""

from faceformer_tpu_torch.parallel.mesh import (  # noqa: F401
    World,
    make_mesh,
    replicated,
    shard_batch,
    shard_global_batch,
)
