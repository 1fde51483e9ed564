"""Shared setup for the port's reconstruction tests
(tests/test_torch_reconstruction*.py), and the source of the oracle
constants in chip_smoke.py [5].

A prediction record is built as the test loop writes one, with a solid's
label faces standing in for predictions (tests/test_reconstruction.py's
``prediction_record``): labels packed per anchor, then the metric engine's
post-processing.

    python tests/torch_recon_helpers.py --root <corpus> [--config FILE] [--num_cores K]

lifts every solid of a corpus written by ``tools.synthetic_data`` through
the JAX package (``reconstruct_wireframe`` and ``reconstruct_mesh``) and
prints one JSON object: the solids, the PLY and OBJ counts and the names
each exporter dropped. chip_smoke.py's ``ORACLE_LIFTED`` and
``ORACLE_DROPPED`` come from

    python -m faceformer_tpu.tools.synthetic_data --root <dir> --num 352 --seed 1 \
        --profile rich --max_edges 216 --max_faces 42 --max_face_len 36
    PYTHONPATH=. python tests/torch_recon_helpers.py --root <dir> --num_cores 4
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ProcessPoolExecutor

from tools.recon_coverage import pred_kind_set


def record_with(sample, model_cfg, post_cfg, pack_label_parallel, metrics_cls):
    """The record of one sample, label faces as predictions, through one
    package's packing and metric engine."""
    packed = pack_label_parallel(sample["faces_indices"], model_cfg)
    out = metrics_cls(post_cfg, model_cfg.token).evaluate_sample(
        packed["label"], packed["label"], sample)
    return {
        "edges": sample["edges"],
        "dominant_directions": sample["dominant_directions"],
        "pred_faces": out["predictions"],
        "label_faces": out["labels"],
    }


def port_record(sample, model_cfg=None, post_cfg=None):
    from faceformer_tpu_torch.config import ModelConfig, PostProcessConfig
    from faceformer_tpu_torch.data.packing import pack_label_parallel
    from faceformer_tpu_torch.train.metrics import FaceMetrics

    return record_with(sample, model_cfg or ModelConfig(num_lines=216, max_face_length=37),
                       post_cfg or PostProcessConfig(), pack_label_parallel, FaceMetrics)


def jax_record(sample, model_cfg=None, post_cfg=None):
    from faceformer_tpu.config import ModelConfig, PostProcessConfig
    from faceformer_tpu.data.packing import pack_label_parallel
    from faceformer_tpu.train.metrics import FaceMetrics

    return record_with(sample, model_cfg or ModelConfig(num_lines=216, max_face_length=37),
                       post_cfg or PostProcessConfig(), pack_label_parallel, FaceMetrics)


_CFG = None


def _lift_one(path):
    from faceformer_tpu.reconstruction.mesh import reconstruct_mesh
    from faceformer_tpu.reconstruction.wireframe import reconstruct_wireframe

    with open(path) as f:
        sample = json.load(f)
    rec = jax_record(sample, _CFG.model, _CFG.post_process)
    return (os.path.splitext(os.path.basename(path))[0], pred_kind_set(rec),
            reconstruct_wireframe(rec) is not None, reconstruct_mesh(rec) is not None)


def _init(config):
    global _CFG
    from faceformer_tpu.config import load_config

    _CFG = load_config(config)


def oracle_lift(root: str, config: str, num_cores: int = 1) -> dict:
    paths = sorted(os.path.join(root, "json", n) for n in os.listdir(os.path.join(root, "json")))
    with ProcessPoolExecutor(num_cores, initializer=_init, initargs=(config,)) as pool:
        rows = list(pool.map(_lift_one, paths, chunksize=8))
    return {
        "solids": len(rows),
        "ply": sum(r[2] for r in rows),
        "obj": sum(r[3] for r in rows),
        "dropped_ply": [r[0] for r in rows if not r[2]],
        "dropped_obj": [r[0] for r in rows if not r[3]],
        "dropped_kinds": {r[0]: r[1] for r in rows if not (r[2] and r[3])},
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="oracle lift of a corpus through the JAX package")
    parser.add_argument("--root", required=True, help="corpus with json/<id>.json")
    parser.add_argument("--config", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
        "synthetic-big.yml"))
    parser.add_argument("--num_cores", type=int, default=1)
    args = parser.parse_args(argv)
    print(json.dumps(oracle_lift(args.root, args.config, args.num_cores)))


if __name__ == "__main__":
    main()
