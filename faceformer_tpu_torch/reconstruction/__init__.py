"""3D reconstruction: lift predicted 2D faces to wireframes and meshes.

A copy of faceformer_tpu/reconstruction/, kept so the port imports nothing
of the JAX package: the same prediction JSONs write the same PLY and OBJ
files, byte for byte. Host code only (numpy and scipy, no torch), so the
command lines' process pools fork no CUDA context.

Pipeline parity with the reference (reconstruction/reconstruct_to_*.py):
per-face plane parameters (a, b, c with depth z = ax + by + c) solved by an
L1-minimization LP constrained by dominant-direction perpendicularity and
shared-vertex depth agreement; cylinder faces decomposed via synthesized
intermediate planes; circle arcs re-fit through lifted points.

CAD-kernel-free: the LP runs on scipy's HiGHS (reference used cvxpy/ECOS),
circles are fit analytically, and PLY/OBJ files are written directly
(reference used open3d / OCC tessellation).
"""

from faceformer_tpu_torch.reconstruction.lp import solve_l1_plane_fit  # noqa: F401
from faceformer_tpu_torch.reconstruction.wireframe import reconstruct_wireframe  # noqa: F401
from faceformer_tpu_torch.reconstruction.mesh import reconstruct_mesh  # noqa: F401
