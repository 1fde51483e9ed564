"""Data parallelism over torch.distributed ranks (``mesh.py``)."""

from faceformer_tpu_torch.parallel.mesh import (  # noqa: F401
    World,
    make_mesh,
    replicated,
    shard_batch,
    shard_global_batch,
)
