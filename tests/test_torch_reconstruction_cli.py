"""PyTorch port: the reconstruction command lines and ``tools.predict
--reconstruct`` against the JAX package's on the same prediction JSONs
(byte-equal files), resume-by-skip, and a run with ``jax`` unimportable
that loads nothing of the JAX package (and no torch before predict)."""

import json
import os
import shutil
import subprocess
import sys
from collections import OrderedDict

import numpy as np
import pytest
import torch

from faceformer_tpu.reconstruction import mesh as jax_mesh
from faceformer_tpu.reconstruction import wireframe as jax_wireframe
from faceformer_tpu_torch.geometry.fixtures import (
    build_sample,
    make_box,
    make_cylinder,
    make_plate_with_hole,
    random_sample,
)
from faceformer_tpu_torch.reconstruction import mesh, wireframe
from faceformer_tpu_torch.tools import predict as port_predict
from faceformer_tpu_torch.train.checkpoint import export_torch_state_dict

from test_torch_predict import samples  # noqa: F401
from torch_port_helpers import jax_params
from torch_recon_helpers import port_record

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORTERS = {"wireframe": ("ply", wireframe, jax_wireframe),
             "mesh": ("obj", mesh, jax_mesh)}


def read_dir(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))} if os.path.isdir(path) else {}


def write_records(root, records):
    os.makedirs(os.path.join(root, "json"), exist_ok=True)
    for name, record in records.items():
        with open(os.path.join(root, "json", f"{name}.json"), "w") as f:
            json.dump(record, f)


@pytest.fixture(scope="module")
def records():
    """Label faces as predictions: three fixtures, five rich solids and one
    record with nothing to lift."""
    out = {}
    for i, (make, theta, phi) in enumerate(((make_box, 30.0, 40.0),
                                            (make_cylinder, 40.0, 35.0),
                                            (make_plate_with_hole, 50.0, 42.0))):
        out[f"{i:08d}"] = port_record(build_sample(make(), theta=theta, phi=phi))
    rng = np.random.default_rng(8)
    for i in range(3, 8):
        out[f"{i:08d}"] = port_record(random_sample(rng, profile="rich"))
    out["00000008"] = {**out["00000000"], "pred_faces": []}
    return out


@pytest.fixture(scope="module")
def jax_outputs(records, tmp_path_factory):
    """Each exporter's files as the JAX module's main writes them."""
    out = {}
    for exporter, (subdir, _, jax_module) in EXPORTERS.items():
        root = str(tmp_path_factory.mktemp(f"jax-{exporter}"))
        write_records(root, records)
        jax_module.main(["--root", root, "--num_cores", "1"])
        out[exporter] = read_dir(os.path.join(root, subdir))
    return out


def port_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("exporter", sorted(EXPORTERS))
def test_command_line_matches_jax(exporter, cores, records, jax_outputs, tmp_path):
    subdir = EXPORTERS[exporter][0]
    write_records(str(tmp_path), records)
    subprocess.run([sys.executable, "-m", f"faceformer_tpu_torch.reconstruction.{exporter}",
                    "--root", str(tmp_path), "--num_cores", str(cores)],
                   check=True, env=port_env(), timeout=300)
    ours = read_dir(tmp_path / subdir)
    assert ours == jax_outputs[exporter]
    assert len(ours) >= 6 and "00000008." + subdir not in ours


@pytest.mark.parametrize("exporter", sorted(EXPORTERS))
def test_resume_by_skip(exporter, records, jax_outputs, tmp_path):
    subdir, module, _ = EXPORTERS[exporter]
    write_records(str(tmp_path), records)
    os.makedirs(tmp_path / subdir)
    kept = f"00000001.{subdir}"
    (tmp_path / subdir / kept).write_bytes(b"written before\n")
    module.main(["--root", str(tmp_path), "--name", "00000002", "--num_cores", "1"])
    assert read_dir(tmp_path / subdir) == {
        kept: b"written before\n", f"00000002.{subdir}": jax_outputs[exporter][f"00000002.{subdir}"]}
    module.main(["--root", str(tmp_path), "--num_cores", "1"])
    ours = read_dir(tmp_path / subdir)
    assert ours.pop(kept) == b"written before\n"
    assert ours == {k: v for k, v in jax_outputs[exporter].items() if k != kept}


CONFIG = """\
model_class: 'SurfaceFormer_Parallel'
dataset_class: 'ABCDataset_Parallel'
batch_size_valid: 2
model:
  num_points_per_line: {cfg.num_points_per_line}
  num_lines: {cfg.num_lines}
  label_seq_length: {cfg.label_seq_length}
  max_num_faces: {cfg.max_num_faces}
  max_face_length: {cfg.max_face_length}
  num_model: {cfg.num_model}
  num_head: {cfg.num_head}
  num_feedforward: {cfg.num_feedforward}
  num_encoder_layers: {cfg.num_encoder_layers}
  num_decoder_layers: {cfg.num_decoder_layers}
  dropout: 0.0
decode:
  mode: 'causal_cache'
  precision: 'fp32'
"""


@pytest.fixture
def predict_inputs(tmp_path, tiny_model_cfg, samples):  # noqa: F811
    """A tiny config, a reference Lightning checkpoint of seeded weights and
    a wireframe directory (the seeded samples and two fixtures)."""
    yml = tmp_path / "tiny.yml"
    yml.write_text(CONFIG.format(cfg=tiny_model_cfg))
    sd = export_torch_state_dict(jax_params(tiny_model_cfg, seed=5))
    ckpt = tmp_path / "tiny.ckpt"
    torch.save({"epoch": 1, "global_step": 1, "pytorch-lightning_version": "1.3.5",
                "state_dict": OrderedDict((k, torch.tensor(v)) for k, v in sd.items())},
               str(ckpt))
    raw = list(samples) + [build_sample(make_cylinder(), theta=40.0, phi=35.0),
                           build_sample(make_box(), theta=30.0, phi=40.0)]
    write_records(str(tmp_path / "in"), {f"{i:08d}": s for i, s in enumerate(raw)})
    return yml, ckpt, tmp_path / "in"


def jax_lift(pred_dir, tmp_path):
    """JAX's reconstruct_file over a copy of the port's prediction JSONs."""
    root = tmp_path / "jax-lift"
    shutil.copytree(pred_dir / "json", root / "json")
    os.makedirs(root / "ply")
    names = sorted(os.path.splitext(n)[0] for n in os.listdir(root / "json"))
    done = sum(jax_wireframe.reconstruct_file(n, str(root)) for n in names)
    return done, read_dir(root / "ply")


@pytest.mark.parametrize("oracle", [False, True])
def test_predict_reconstruct(predict_inputs, tmp_path, capsys, monkeypatch, tiny_model_cfg,
                             oracle):
    """The decoded faces of seeded weights, and (``oracle``) the label faces
    put in place of the decode, lifted by ``predict --reconstruct``."""
    yml, ckpt, root = predict_inputs
    if oracle:
        from faceformer_tpu_torch.config import load_config

        mc = load_config(str(yml)).model
        monkeypatch.setattr(port_predict, "predict_faces", lambda model, cfg, raw, device:
                            [port_record(s, mc)["pred_faces"] for s in raw])
    out = tmp_path / "pred"
    port_predict.main(["--config", str(yml), "--ckpt", str(ckpt), "--root", str(root),
                       "--out", str(out), "--device", "cpu", "--reconstruct"])
    done, theirs = jax_lift(out, tmp_path)
    assert f"reconstructed {done}/5 wireframes -> {out}/ply" in capsys.readouterr().out
    assert read_dir(out / "ply") == theirs
    if oracle:
        assert done == 5


NO_JAX = """
import json, sys
sys.modules["jax"] = None
from faceformer_tpu_torch.reconstruction import reconstruct_mesh, reconstruct_wireframe
from faceformer_tpu_torch.reconstruction import mesh, wireframe

lift, yml, ckpt, wires = sys.argv[1:]
with open(lift + "/json/00000001.json") as f:
    record = json.load(f)
assert reconstruct_wireframe(record) is not None and reconstruct_mesh(record) is not None
wireframe.main(["--root", lift, "--num_cores", "2"])
mesh.main(["--root", lift, "--num_cores", "1"])
print("TORCH_BEFORE_PREDICT", "torch" in sys.modules)  # the lift forks with no torch
from faceformer_tpu_torch.tools import predict
predict.main(["--config", yml, "--ckpt", ckpt, "--root", wires, "--device", "cpu",
              "--reconstruct"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] == "faceformer_tpu")
print("LOADED", json.dumps(loaded))
"""


def test_no_jax_at_run_time(predict_inputs, records, tmp_path):
    yml, ckpt, root = predict_inputs
    lift = tmp_path / "lift"
    write_records(str(lift), records)
    proc = subprocess.run([sys.executable, "-c", NO_JAX, str(lift), str(yml), str(ckpt),
                           str(root)], capture_output=True, text=True, env=port_env(),
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout.splitlines()
    assert "TORCH_BEFORE_PREDICT False" in proc.stdout.splitlines()
    assert len(os.listdir(lift / "ply")) >= 6 and len(os.listdir(lift / "obj")) >= 6
    assert os.path.isdir(root / "pred" / "ply")
