"""PyTorch port: the hemisphere's occlusion in ``tools/hlr_visibility.py``.

A hemisphere cut through its sphere's centre (``brep_dome_block``'s cap)
has its reference point on the rim plane; the port then takes the cap's
pole, on the face's side of the plane, so the dome occludes. The JAX
package keeps a sign of 0.0 there and its dome never occludes: the last
assertion records that divergence."""

import numpy as np
import pytest

from faceformer_tpu.tools import hlr_visibility as jax_hlr
from faceformer_tpu.tools import step21 as jax_step21
from faceformer_tpu.tools.occ_pipeline import ProjectionArgs as JaxProjectionArgs
from faceformer_tpu.tools.step_native import NativeProjector as JaxNativeProjector
from faceformer_tpu_torch.tools import hlr_visibility, step21
from faceformer_tpu_torch.tools.occ_pipeline import ProjectionArgs
from faceformer_tpu_torch.tools.step_native import NativeProjector

VIEW = (1.0, 0.0, 1.0)  # 45 degrees above the +x side
RADIUS, HEIGHT = 0.6, 1.0
# the top rim, off the two tangent points at 90 and 270 degrees
THETA = np.deg2rad(np.arange(0, 360, 30) + 15.0)
RIM = np.stack([RADIUS * np.cos(THETA), RADIUS * np.sin(THETA),
                np.full_like(THETA, HEIGHT / 2)], axis=1)
# seen from VIEW, the dome hides the far half of the rim: cos(theta) < 0
HIDDEN = np.cos(THETA) < 0


def make_tester(tmp_path, module, step, proj_args, projector, loc=VIEW):
    """An occlusion tester of one package over brep_dome_block, and its solid."""
    path = tmp_path / "dome_block.step"
    path.write_text(step.brep_dome_block(RADIUS, HEIGHT))
    solid = step.read_brep(str(path))[0]
    return module.OcclusionTester(
        solid, projector(proj_args(location=loc, direction=loc, focus=0.0))), solid


def test_hemisphere_hides_the_far_rim(tmp_path):
    t, solid = make_tester(tmp_path, hlr_visibility, step21, ProjectionArgs, NativeProjector)
    assert list(t.occluded(RIM)) == list(HIDDEN)
    # the apex and the near rim stay visible; the cylinder still hides the
    # far bottom rim
    assert list(t.occluded([[0, 0, 1.1], [0.6, 0, 0.5], [-0.6, 0, -0.5]])) == [
        False, False, True]
    # the rim's visible runs: one polyline, the near half
    runs = t.visible_runs(RIM[np.argsort(np.cos(THETA))])
    assert [len(r) for r in runs] == [int((~HIDDEN).sum())]


def test_hemisphere_pole_on_the_face_side(tmp_path):
    """The side the port reads off the cap's boundary walk is the cap's:
    above the rim plane, whichever way the plane's normal points."""
    _, solid = make_tester(tmp_path, hlr_visibility, step21, ProjectionArgs, NativeProjector)
    cap = [f for f in solid.faces if f.surface_kind == step21.SPHERE][0]
    c, up = cap.frame.origin, np.array([0.0, 0.0, 1.0])
    assert hlr_visibility._sphere_side(cap, c, up, c, 1e-4) == 1.0
    assert hlr_visibility._sphere_side(cap, c, -up, c, 1e-4) == -1.0


@pytest.mark.parametrize("cap_height", [0.5, 1.1])
def test_domes_not_cut_through_the_centre_unchanged(tmp_path, cap_height):
    """A cap off the centre keeps its sign from the boundary's mean: the
    port's tester answers as the JAX package's on a grid of points."""
    path = tmp_path / "dome.step"
    path.write_text(step21.brep_dome(0.8, cap_height))
    ours = hlr_visibility.OcclusionTester(step21.read_brep(str(path))[0], NativeProjector(
        ProjectionArgs(location=VIEW, direction=VIEW, focus=0.0)))
    theirs = jax_hlr.OcclusionTester(jax_step21.read_brep(str(path))[0], JaxNativeProjector(
        JaxProjectionArgs(location=VIEW, direction=VIEW, focus=0.0)))
    grid = np.random.default_rng(0).uniform(-0.9, 0.9, (200, 3))
    assert list(ours.occluded(grid)) == list(theirs.occluded(grid))
    assert ours.occluded(grid).any()


def test_divergence_from_the_jax_package(tmp_path):
    theirs, _ = make_tester(tmp_path, jax_hlr, jax_step21, JaxProjectionArgs, JaxNativeProjector)
    assert not theirs.occluded(RIM).any()  # its hemisphere never occludes
