"""Generate a corpus of real STEP files for the native dataset pipeline.

The port's copy of the root tools/gen_step_solids.py, run as
``python -m faceformer_tpu_torch.tools.gen_step_solids``: the same flags write
the same files, byte for byte.

Emits ISO-10303-21 B-Rep solids (MANIFOLD_SOLID_BREP over plane/cylinder/
cone surfaces with line/circle edges — the subset step21.py reads and
writes) into ``<root>/step/<id>.step``, so the STEP -> JSON generation
path (tools/prepare_data.py --backend native, mirroring reference
dataset/prepare_data.py) can run end-to-end in environments without ABC
data or OpenCascade:

    python -m faceformer_tpu_torch.tools.gen_step_solids --root data_step --num 64
    python tools/prepare_data.py --root data_step --backend native \
        --random_camera --focus 0

Families: polygon extrusions (rect / n-gon / convex / L / T / notched),
plates with 1-3 circular through-holes (full cylindrical faces with seam
edges — the topology whose analytic-HLR splitting and sewn-edge removal
the native backend reproduces), full cylinders, conical frustums,
spherical domes, hemisphere-capped cylinders (SPHERICAL_SURFACE faces
whose silhouette-circle splitting shares equator vertices with the wall's
ruling cuts), ring tori and round-top fillets (TOROIDAL_SURFACE bands
with traced silhouette branches), freeform spline prisms
(B_SPLINE_SURFACE_WITH_KNOTS extrusion walls over closed Bezier-segment
chains, split along their t-free ruling silhouettes), apex cones
(one-station conical walls whose silhouette rulings share the apex
vertex), revolved vases (SURFACE_OF_REVOLUTION bands over B-spline
meridian profiles, split along traced analytic-branch silhouettes),
COMPOSITE plates (2-4 mixed hole/boss/dome-boss/pocket features on one
body — the multi-feature topology of real ABC parts), pillows (general
doubly-curved B-spline patch roofs split by numeric silhouette
marching; ~30% written as RATIONAL surfaces with weighted interiors),
and NURBS cylinders (cylinders encoded the way real exporters emit
them: rational quadratic circle curves + a rational wall surface,
exercising homogeneous de Boor and circle/cylinder recognition).
"""

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from faceformer_tpu_torch.geometry.solids import (
    _place_children,
    bezier_star_segments,
    origin_clearance,
    poly_convex,
    poly_lshape,
    poly_ngon,
    poly_notched_rect,
    poly_rect,
    poly_tshape,
)
from faceformer_tpu_torch.tools import step21


def random_footprint(rng: np.random.Generator) -> np.ndarray:
    kind = rng.choice(["rect", "ngon", "convex", "lshape", "tshape", "notched"])
    if kind == "rect":
        return poly_rect(*rng.uniform(1.0, 1.8, size=2))
    if kind == "ngon":
        return poly_ngon(int(rng.integers(3, 10)), float(rng.uniform(0.7, 1.0)),
                         rot=float(rng.uniform(0, np.pi)))
    if kind == "convex":
        return poly_convex(rng, int(rng.integers(5, 9)), float(rng.uniform(0.7, 1.0)))
    if kind == "lshape":
        return poly_lshape(float(rng.uniform(0.9, 1.5)), float(rng.uniform(0.9, 1.5)),
                           float(rng.uniform(0.3, 0.6)), float(rng.uniform(0.3, 0.6)))
    if kind == "tshape":
        return poly_tshape(float(rng.uniform(1.2, 1.8)), float(rng.uniform(1.0, 1.6)),
                           float(rng.uniform(0.3, 0.6)), float(rng.uniform(0.4, 0.8)))
    return poly_notched_rect(rng, float(rng.uniform(1.3, 1.8)),
                             float(rng.uniform(1.1, 1.6)), int(rng.integers(1, 4)))


def random_composite(rng: np.random.Generator, name: str) -> str:
    """A plate carrying 2-4 mixed features (holes/bosses/dome-bosses/
    pockets) on one body — the multi-feature composites that dominate
    real ABC parts (every single-feature family is a degenerate case)."""
    thick = float(rng.uniform(0.4, 0.8))
    for _ in range(16):
        poly = random_footprint(rng)
        clearance = origin_clearance(poly)
        if clearance <= 0.35:
            continue
        n_feat = int(rng.integers(2, 5))
        radii = [clearance * float(rng.uniform(0.12, 0.28))
                 for _ in range(n_feat)]
        centers = _place_children(rng, clearance, radii)
        if centers is None:
            continue
        feats = []
        for c, r in zip(centers, radii):
            kind = str(rng.choice(["hole", "boss", "dome_boss", "pocket"]))
            if kind == "boss":
                param = float(rng.uniform(0.2, 0.7))
            elif kind == "dome_boss":
                param = float(rng.choice([0.0, rng.uniform(0.15, 0.5)]))
            elif kind == "pocket":
                param = thick * float(rng.uniform(0.3, 0.7))
            else:
                param = 0.0
            feats.append((kind, float(c[0]), float(c[1]), r, param))
        return step21.brep_plate_features(poly, -thick / 2, thick / 2,
                                          feats, name=name)
    # placement kept failing: fall back to a plain extrusion
    return step21.brep_extrusion(random_footprint(rng), -thick / 2,
                                 thick / 2, name=name)


FAMILIES = ["extrusion", "holes", "cylinder", "frustum",
            "dome", "dome_block", "torus", "round_top", "spline",
            "cone", "vase", "composite", "pillow", "nurbs_cyl"]
FAMILY_PROBS = [0.13, 0.12, 0.07, 0.07, 0.06, 0.06,
                0.05, 0.05, 0.07, 0.04, 0.06, 0.14, 0.05, 0.03]


def random_step_solid(rng: np.random.Generator, name: str,
                      probs=None) -> str:
    kind = rng.choice(FAMILIES, p=FAMILY_PROBS if probs is None else probs)
    h = float(rng.uniform(0.4, 1.2))
    if kind == "composite":
        return random_composite(rng, name)
    if kind == "pillow":
        gz = rng.uniform(0.4, 1.2, size=(int(rng.integers(3, 6)),
                                         int(rng.integers(3, 6))))
        weight = 0.0
        if rng.uniform() < 0.3:  # rational roof (NURBS encoding)
            weight = float(rng.choice([rng.uniform(0.35, 0.7),
                                       rng.uniform(1.5, 3.0)]))
        return step21.brep_pillow(gz, float(rng.uniform(0.6, 1.0)),
                                  float(rng.uniform(0.6, 1.0)),
                                  interior_weight=weight, name=name)
    if kind == "nurbs_cyl":
        return step21.brep_nurbs_cylinder(float(rng.uniform(0.5, 0.9)), h,
                                          name=name)
    if kind == "cone":
        return step21.brep_cone(float(rng.uniform(0.5, 0.9)),
                                float(rng.uniform(0.7, 1.3)), name=name)
    if kind == "vase":
        k = int(rng.integers(4, 8))
        rho = rng.uniform(0.35, 0.95, size=k)
        z = np.cumsum(rng.uniform(0.15, 0.4, size=k))
        return step21.brep_vase(np.stack([rho, z - z[0]], axis=1), name=name)
    if kind == "spline":
        segs = bezier_star_segments(
            rng, n=int(rng.integers(3, 7)),
            r0=float(rng.uniform(0.55, 0.75)), r1=float(rng.uniform(0.8, 1.0)),
            rot=float(rng.uniform(0, np.pi)))
        return step21.brep_spline_prism(segs, -h / 2, h / 2, name=name)
    if kind == "torus":
        major = float(rng.uniform(0.5, 0.9))
        return step21.brep_torus(major, major * float(rng.uniform(0.2, 0.6)),
                                 name=name)
    if kind == "round_top":
        r = float(rng.uniform(0.5, 0.9))
        return step21.brep_round_top_cylinder(
            r, h, r * float(rng.uniform(0.15, 0.45)), name=name)
    if kind == "cylinder":
        return step21.brep_cylinder(float(rng.uniform(0.5, 0.9)), h, name=name)
    if kind == "frustum":
        r0 = float(rng.uniform(0.6, 0.9))
        return step21.brep_frustum(r0, r0 * float(rng.uniform(0.4, 0.8)), h,
                                   name=name)
    if kind == "dome":
        r = float(rng.uniform(0.5, 0.9))
        return step21.brep_dome(r, r * float(rng.uniform(0.5, 1.5)), name=name)
    if kind == "dome_block":
        return step21.brep_dome_block(float(rng.uniform(0.45, 0.8)), h,
                                      name=name)
    poly = random_footprint(rng)
    holes = []
    if kind == "holes":
        clearance = origin_clearance(poly)
        if clearance > 0.2:
            n_holes = int(rng.integers(1, 4))
            radii = [clearance * float(rng.uniform(0.15, 0.3))
                     for _ in range(n_holes)]
            centers = _place_children(rng, clearance, radii)
            if centers is not None:
                holes = [(float(c[0]), float(c[1]), r)
                         for c, r in zip(centers, radii)]
    return step21.brep_extrusion(poly, -h / 2, h / 2, holes=holes, name=name)


def parse_weights(spec: str) -> list:
    """``name=w,name=w`` multiplies those families' draw probabilities by
    w before renormalizing — e.g. ``torus=4,cone=4,vase=3`` oversamples
    the families a quality breakdown shows the model under-learns."""
    probs = list(FAMILY_PROBS)
    for part in spec.split(","):
        if not part.strip():
            continue
        name, _, w = part.partition("=")
        if name.strip() not in FAMILIES:
            raise SystemExit(f"unknown family {name!r}; one of {FAMILIES}")
        probs[FAMILIES.index(name.strip())] *= float(w)
    total = sum(probs)
    return [p / total for p in probs]


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, default="./data_step")
    parser.add_argument("--num", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--weights", type=str, default="",
                        help="family=multiplier,... reweights draw probs")
    args = parser.parse_args(argv)

    probs = parse_weights(args.weights) if args.weights else None
    out = os.path.join(args.root, "step")
    os.makedirs(out, exist_ok=True)
    for i in range(args.num):
        rng = np.random.default_rng(np.random.SeedSequence([args.seed, i]))
        name = f"{i:08d}"
        text = random_step_solid(rng, name, probs=probs)
        with open(os.path.join(out, f"{name}.step"), "w") as f:
            f.write(text)
    print(f"wrote {args.num} STEP solids under {out}")


if __name__ == "__main__":
    main()
