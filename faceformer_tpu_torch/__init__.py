"""faceformer_tpu_torch — the PyTorch / CUDA port of faceformer_tpu for one
NVIDIA H100 (sm_90a).

The JAX package beside it stays the reference: this package mirrors its
module names and public layouts (memory (N, S, E), grids (N, F, T), masks
with True = padded) so each part can be held against its JAX twin, and it
imports nothing of it. Plain tensor code is PyTorch; every Pallas kernel on
the ported path is a hand-written CUDA C++ kernel under ``csrc/``, built
with nvcc at first use (``ops/_build.py``). The JAX package's host-side C++
(the threaded JSON loader and the geometry kernel) is copied under
``csrc/host/`` and built with g++ at first use.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without a card they raise.

Ported so far (both models, serving and training):
  - config, post_processing, geometry/ (fixtures and solids included):
    copies of the JAX package's numpy modules; geometry/native, the bridge
    to the host library (resampling, batch enclosedness)
  - data/: packing (both label layouts), batching, ABCDataset,
    ABCDatasetParallel, native_loader (the threaded C++ loader behind
    the datasets)
  - models/: layers (with every remat policy), embedding, encoder pass,
    SurfaceFormer (flat), SurfaceFormerParallel
  - parallel/: data parallelism over torch.distributed ranks
  - params: seeded init and the JAX parameter-tree bridge
  - ops/: pointer argmax, flash attention forward and backward (key-tiled
    past a block's shared memory), fused decode step
  - decode: greedy_decode_parallel (reference, causal_cache, fused) and
    greedy_decode_single (reference, causal_cache)
  - train/: loss, metrics, step, logging, checkpoints, the Harness
  - main (``python -m faceformer_tpu_torch.main``, one rank or several),
    tools/predict (with ``--reconstruct``), tools/synthetic_data and
    tools/profile: the command lines
  - reconstruction/ (io3d, lp, runner, wireframe, mesh) and
    geometry/circles, geometry/loops' cycle assembly: the lift of predicted
    faces to PLY wireframes and OBJ meshes, host code (numpy and scipy), with
    ``python -m faceformer_tpu_torch.reconstruction.{wireframe,mesh}``
"""

__version__ = "0.1.0"
