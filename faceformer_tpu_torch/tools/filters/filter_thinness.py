"""Thinness filter: record each shape's minimum circle/ellipse radius
(normalized by bbox diagonal) so downstream stages can drop needle-thin
cylinders (reference: dataset/filters/filter_thinness.py:22-54).

A copy of faceformer_tpu/tools/filters/filter_thinness.py with its imports renamed to
the port's modules: the same inputs write the same files.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from faceformer_tpu_torch.tools.objio import bounding_extents, load_obj


def min_curve_radius(root: str, name: str) -> Optional[float]:
    import yaml

    vertices, _ = load_obj(os.path.join(root, "obj", f"{name}.obj"))
    scale = float(np.linalg.norm(bounding_extents(vertices)))
    with open(os.path.join(root, "feat", f"{name}.yml")) as f:
        annos = yaml.full_load(f)
    radii = []
    for curve in annos["curves"]:
        if curve["type"] == "Circle":
            radii.append(curve["radius"] / scale)
        elif curve["type"] == "Ellipse":
            radii.append(min(curve["maj_radius"], curve["min_radius"]) / scale)
    return min(radii) if radii else None


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, required=True)
    parser.add_argument("--id_list", type=str, default="filtered_thickness.json")
    parser.add_argument("--out", type=str, default="filtered_thinness.json")
    args = parser.parse_args(argv)

    with open(args.id_list) as f:
        names = json.load(f)
    os.makedirs(os.path.join(args.root, "radius"), exist_ok=True)
    for name in names:
        radius = min_curve_radius(args.root, name)
        if radius is not None:
            with open(os.path.join(args.root, "radius", f"{name}.json"), "w") as f:
                json.dump(radius, f)
    with open(args.out, "w") as f:
        json.dump(names, f)
    print(f"recorded radii for {len(names)} shapes")


if __name__ == "__main__":
    main()
