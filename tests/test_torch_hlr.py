"""PyTorch port: the spherical caps' occlusion in ``tools/hlr_visibility.py``.

The port takes the side of each plane that bounds a sphere face from the
face's boundary walk in that plane. The JAX package takes it from a point
toward the boundary's mean: on a hemisphere (``brep_dome_block``'s cap,
cut through its sphere's centre) that point lies on the rim plane, its
sign is 0.0 and the dome never occludes; on a cap larger than a
hemisphere (``brep_dome`` with a cap height above the radius) it lies
below the cut, on the side the face does not hold, and the cap hides the
wrong points. The last test records both divergences."""

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


@pytest.mark.parametrize("cap_height", [0.5])
def test_domes_not_cut_through_the_centre_unchanged(tmp_path, cap_height):
    """A cap smaller than a hemisphere, off the centre: the port's tester
    answers as the JAX package's on a grid of points."""
    ours, theirs = dome_testers(tmp_path, cap_height, VIEW)
    grid = np.random.default_rng(0).uniform(-0.9, 0.9, (200, 3))
    assert list(ours.occluded(grid)) == list(theirs.occluded(grid))
    assert ours.occluded(grid).any()


# brep_dome(0.8, 1.1): a sphere of radius 0.8 cut at z = -0.3, below its
# centre; the point on the cap at z = -0.2, on the -x side, and its mirror
WIDE = (0.8, 1.1)
WIDE_POINTS = [[-0.775, 0.0, -0.2], [0.775, 0.0, -0.2]]
OTHER_VIEW = (-1.0, 0.0, 1.0)


def dome_testers(tmp_path, cap_height, view, radius=0.8):
    """Both packages' occlusion testers over brep_dome(radius, cap_height)
    seen from ``view``."""
    path = tmp_path / "dome.step"
    path.write_text(step21.brep_dome(radius, cap_height))
    ours = hlr_visibility.OcclusionTester(step21.read_brep(str(path))[0], NativeProjector(
        ProjectionArgs(location=view, direction=view, focus=0.0)))
    theirs = jax_hlr.OcclusionTester(jax_step21.read_brep(str(path))[0], JaxNativeProjector(
        JaxProjectionArgs(location=view, direction=view, focus=0.0)))
    return ours, theirs


def test_wide_cap_hides_its_far_side(tmp_path):
    """Seen from (1, 0, 1), the cap's own near side hides its point at
    (-0.775, 0, -0.2); the mirror point on the near side stays visible."""
    ours, _ = dome_testers(tmp_path, WIDE[1], VIEW, radius=WIDE[0])
    assert list(ours.occluded(WIDE_POINTS)) == [True, False]


def test_wide_cap_far_side_visible_from_the_other_side(tmp_path):
    """Seen from (-1, 0, 1) the same point faces the eye and stays visible,
    and its mirror is the hidden one."""
    ours, _ = dome_testers(tmp_path, WIDE[1], OTHER_VIEW, radius=WIDE[0])
    assert list(ours.occluded(WIDE_POINTS)) == [False, True]


@pytest.mark.parametrize("solid", ["hemisphere", "wide-cap"])
def test_divergence_from_the_jax_package(tmp_path, solid):
    if solid == "hemisphere":
        theirs, _ = make_tester(tmp_path, jax_hlr, jax_step21, JaxProjectionArgs,
                                JaxNativeProjector)
        assert not theirs.occluded(RIM).any()  # its hemisphere never occludes
    else:
        _, theirs = dome_testers(tmp_path, WIDE[1], VIEW, radius=WIDE[0])
        # its wide cap hides neither point: the far one reads visible
        assert list(theirs.occluded(WIDE_POINTS)) == [False, False]
