"""PyTorch port: label-free predict_faces and the serving post-processing
against the JAX package on fixture wireframes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from faceformer_tpu.config import Config, DecodeConfig, ModelConfig, config_to_dict
from faceformer_tpu.data.batching import collate as jax_collate
from faceformer_tpu.data.dataset import ABCDatasetParallel
from faceformer_tpu.data.packing import pack_input_edges as jax_pack
from faceformer_tpu.decode import greedy_decode_parallel as jax_decode
from faceformer_tpu.geometry.fixtures import random_sample
from faceformer_tpu.train.metrics import FaceMetrics as JaxFaceMetrics
from faceformer_tpu_torch.config import config_from_dict
from faceformer_tpu_torch.geometry.fixtures import random_sample as port_random_sample
from faceformer_tpu_torch.tools.predict import predict_faces
from faceformer_tpu_torch.train.metrics import FaceMetrics

from torch_port_helpers import jax_params, port_model, torch_fp32_single_thread  # noqa: F401
from torch_recon_helpers import jax_record


@pytest.fixture(scope="module")
def samples():
    rng = np.random.default_rng(5)
    return [random_sample(rng) for _ in range(3)]


@pytest.mark.parametrize("mode", ["causal_cache", "fused"])
def test_predict_faces_matches_jax(tiny_model_cfg, samples, mode):
    cfg = Config(model_class="SurfaceFormer_Parallel", batch_size_valid=2,
                 model=tiny_model_cfg, decode=DecodeConfig(mode="causal_cache", precision="fp32"))
    tree = jax_params(tiny_model_cfg, seed=7)
    engine = JaxFaceMetrics(cfg.post_process, tiny_model_cfg.token)
    theirs = []
    for start in (0, 2):  # batches of 2, the last filled by repeating its sample
        chunk = samples[start:start + 2]
        chunk = chunk + [chunk[-1]] * (2 - len(chunk))
        batch = jax_collate([jax_pack(s["edges"], tiny_model_cfg) for s in chunk])
        grids = np.asarray(jax_decode(jax.tree.map(jnp.asarray, tree), tiny_model_cfg, batch,
                                      precision="fp32", mode="causal_cache")["predict"])
        for i in range(min(2, len(samples) - start)):
            theirs.append(engine.evaluate_sample(grids[i], np.zeros_like(grids[i]),
                                                 samples[start + i])["predictions"])

    port_cfg = config_from_dict(config_to_dict(
        dataclasses.replace(cfg, decode=DecodeConfig(mode=mode, precision="fp32"))))
    ours = predict_faces(port_model(tiny_model_cfg, tree), port_cfg, samples, device="cpu")
    assert ours == theirs


def test_face_metrics_copy_matches_jax(tiny_model_cfg, samples):
    """Label grids are real faces, so the enclosedness filter, coedge
    mapping and type vote all act (the JAX side may use its C++ filter)."""
    ds = ABCDatasetParallel.from_samples(samples, tiny_model_cfg)
    cfg = Config(model=tiny_model_cfg)
    theirs_engine = JaxFaceMetrics(cfg.post_process, tiny_model_cfg.token)
    port_cfg = config_from_dict(config_to_dict(cfg))
    ours_engine = FaceMetrics(port_cfg.post_process, port_cfg.model.token)
    rng = np.random.default_rng(0)
    for i, raw in enumerate(samples):
        label = np.asarray(ds[i]["label"])
        predict = label.copy()
        predict[rng.random(label.shape[0]) < 0.3, 1] = 3 + tiny_model_cfg.token.length
        theirs = theirs_engine.evaluate_sample(predict, label, raw)
        ours = ours_engine.evaluate_sample(predict, label, raw)
        assert ours.keys() == theirs.keys()
        assert ours["predictions"] and ours == theirs


def test_chip_smoke_helpers(tiny_model_cfg):
    """chip_smoke.py's seeded wireframes pack and decode on the CPU, its
    profiler busy-time union, and [5]'s oracle records and kind histogram."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    assert smoke.busy_us([(0.0, 5.0), (3.0, 8.0), (10.0, 12.0), (11.0, 11.5)]) == 10.0
    lines = tiny_model_cfg.num_lines
    a, b = (smoke.random_wireframes(np.random.default_rng(4), 3, lo=5, hi=lines)
            for _ in range(2))
    assert a == b
    assert all(5 <= len(s["edges"]) <= lines for s in a)
    cfg = config_from_dict(config_to_dict(Config(model=tiny_model_cfg)))
    model = port_model(tiny_model_cfg, jax_params(tiny_model_cfg, seed=1))
    faces = predict_faces(model, cfg, a, device="cpu", early_stop=False)
    assert len(faces) == 3

    # [5]'s oracle records (label faces through the port's packing and
    # metric engine) equal the JAX package's; its histogram of face kinds
    big = config_from_dict(config_to_dict(Config(model=ModelConfig(num_lines=216,
                                                                   max_face_length=37))))
    engine = FaceMetrics(big.post_process, big.model.token)
    rng = np.random.default_rng(2)
    solids = [port_random_sample(rng, profile="rich") for _ in range(4)]
    records = [smoke.oracle_record(s, engine, big.model) for s in solids]
    assert records == [jax_record(s) for s in solids]
    assert all(r["pred_faces"] for r in records)
    hist = smoke.kind_histogram(records)
    assert sum(hist.values()) == 4 and "plane" in ",".join(hist)
    assert smoke.kind_histogram([{"pred_faces": []}, {"pred_faces": [(0, [1]), (2, [3])]},
                                 {"pred_faces": [(1, [2]), (1, [4])]}, {"pred_faces": []}]) == {
        "cylinder": 1, "empty": 2, "other+plane": 1}
