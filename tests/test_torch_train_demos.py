"""The port's demo-training queue (faceformer_tpu_torch/tools/train_demos.py)
against the root tools/train_demos.sh, tools/aggregate_results.py and the
JAX package's data path: the stage table, a two-stage run on the CPU at a
tiny width (fit, best checkpoint, test, audit files), a stage whose fit
fails, the summary, each trained recipe's corpus and training batches, and
the committed card runs of the flat, direction-token and coedge recipes;
and a stage over two gloo ranks, whose STAGE line holds each rank's counts."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from faceformer_tpu.config import load_config as jax_load_config
from faceformer_tpu.data import dataset as jax_dataset
from faceformer_tpu.data.batching import iter_batches as jax_iter_batches
from faceformer_tpu.tools import synthetic_data as jax_synthetic_data
from faceformer_tpu_torch.config import load_config
from faceformer_tpu_torch.parallel import mesh
from faceformer_tpu_torch.tools import synthetic_data, train_demos
from faceformer_tpu_torch.train.checkpoint import CheckpointManager
from faceformer_tpu_torch.train.trainer import Harness
from tools import aggregate_results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAT_CONFIG = os.path.join(REPO, "configs", "synthetic-seq2seq-big.yml")
# configs/synthetic-seq2seq-big.yml's corpus flags, at a cut --num
FLAT_GEN = ["--profile", "rich", "--combine_coedge", "--max_edges", "110", "--max_faces",
            "42", "--max_label_len", "258", "--seed", "2"]
# each trained recipe's config and its header's corpus flags, at a cut --num
RECIPES = {
    "flagship": (os.path.join(REPO, "configs", "synthetic-big.yml"),
                 ["--profile", "rich", "--max_edges", "216", "--max_faces", "42",
                  "--max_face_len", "36", "--seed", "1"]),
    "flat": (FLAT_CONFIG, FLAT_GEN),
    "dirtok": (os.path.join(REPO, "configs", "synthetic-dirtok-big.yml"),
               ["--profile", "rich", "--direction_token", "--max_edges", "110", "--max_faces",
                "42", "--max_label_len", "508", "--seed", "3"]),
    "coedge": (os.path.join(REPO, "configs", "synthetic-coedge-big.yml"),
               ["--profile", "rich", "--no_face_type", "--max_edges", "216", "--max_faces",
                "42", "--max_label_len", "258", "--seed", "4"]),
}
# the tiny corpus and width of the CPU run: labels fit 64 tokens
TINY_GEN = ["--num", "64", "--profile", "rich", "--combine_coedge", "--max_edges", "40",
            "--max_faces", "42", "--max_label_len", "63", "--seed", "2"]
TINY = ["model.num_points_per_line", "8", "model.num_lines", "40",
        "model.label_seq_length", "64", "model.num_model", "32", "model.num_head", "2",
        "model.num_feedforward", "64", "model.num_encoder_layers", "1",
        "model.num_decoder_layers", "1", "batch_size_train", "8", "batch_size_valid", "8",
        "trainer.max_epochs", "2", "trainer.checkpoint_period", "1",
        "trainer.precision", "fp32", "decode.precision", "fp32"]
# flat-s0 and flat-s1 read the tiny corpus at the flat config's root_dir;
# dirtok-s0's root_dir (data/synthetic-dirtok-big) does not exist, so its fit fails
STAGES = ("flat-s0", "dirtok-s0", "flat-s1")
GOOD = ("torch-seq2seq-big-s0", "torch-seq2seq-big-s1")
AUDIT = ("metrics.jsonl", "results.json", os.path.join("checkpoints", "index.json"))


def stage_env(tmp):
    """The environment of a ``train_demos`` subprocess: the repository on
    PYTHONPATH, one thread a process, and TensorFlow left out (TensorBoard
    writes its event files without it, which would take each writing
    process seconds to import)."""
    no_tf = tmp / "no_tf" / "tensorflow"
    no_tf.mkdir(parents=True, exist_ok=True)
    (no_tf / "__init__.py").write_text("raise ImportError\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, str(no_tf.parent), env.get("PYTHONPATH")) if p)
    return env


def read_lines(path):
    with open(path) as f:
        return [line for line in f.read().split() if line]


# -- (i) the stage table -------------------------------------------------------------


def shell_stage_table():
    """family -> (config, version with ${seed}) from the root train_demos.sh."""
    with open(os.path.join(REPO, "tools", "train_demos.sh")) as f:
        text = f.read()
    rows = re.findall(r"^\s*(\w+)\)\s+config=(\S+);\s+version=\"([^\"]+)\";;", text, re.M)
    return {family: (config, version) for family, config, version in rows}


def test_stage_table_is_the_shell_queue_with_torch_versions():
    table = shell_stage_table()
    assert set(table) == set(train_demos.STAGES) == {"flagship", "flat", "dirtok", "coedge"}
    for family, (config, version) in table.items():
        for seed in (0, 2, 11):
            got = train_demos.stage_spec(f"{family}-s{seed}")
            assert got == (os.path.join(REPO, config),
                           "torch-" + version.replace("${seed}", str(seed)), seed)
            assert os.path.isfile(got[0])


@pytest.mark.parametrize("bad", ["flat", "flat-0", "mystery-s0", "flat-s", "Flat-s1"])
def test_unknown_stage_names_raise(bad):
    with pytest.raises(ValueError, match="unknown stage"):
        train_demos.stage_spec(bad)


def test_stage_names_then_overrides():
    assert train_demos.split_stages(["flat-s0", "flat-s2", "root_dir", "d", "a.b", "1"]) == (
        ["flat-s0", "flat-s2"], ["root_dir", "d", "a.b", "1"])
    with pytest.raises(SystemExit, match="key value pairs"):
        train_demos.split_stages(["flat-s0", "root_dir"])
    # the stage's version and seed come after the overrides, so they win
    _, opts, log_dir = train_demos.stage_options("flat-s1", ["trainer.seed", "7"])
    assert load_config(FLAT_CONFIG, opts).trainer.seed == 1
    assert load_config(FLAT_CONFIG, opts).trainer.version == "torch-seq2seq-big-s1"
    assert log_dir == os.path.join("logs", "SurfaceFormer", "torch-seq2seq-big-s1")


@pytest.mark.parametrize("argv", [["run", "--jobs", "0", "flat-s0"],
                                  ["run", "--device", "cpu"],
                                  ["run", "--device", "cpu", "flat-s0", "flat-s0"],
                                  ["stage", "--device", "cpu", "flat-s0", "flat-s1"]])
def test_run_arguments_rejected_before_any_stage(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        train_demos.main(argv)
    assert not (tmp_path / "logs").exists()


# -- (ii), (iii) a run on the CPU ---------------------------------------------------------


@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    """``run --device cpu --jobs 2`` over STAGES from a fresh directory:
    (exit code, stdout, stderr, the directory)."""
    cwd = tmp_path_factory.mktemp("demos")
    synthetic_data.main(["--root", str(cwd / "data" / "synthetic-flat-big"), *TINY_GEN])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-m", "faceformer_tpu_torch.tools.train_demos", "run", "--device",
         "cpu", "--jobs", "2", "--out", "out", *STAGES, *TINY],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    return proc.returncode, proc.stdout, proc.stderr, cwd


def stage_records(stdout):
    return {r["stage"]: r for r in (json.loads(line[len("STAGE "):])
                                    for line in stdout.splitlines() if line.startswith("STAGE "))}


@pytest.mark.parametrize("stage,version", list(zip(("flat-s0", "flat-s1"), GOOD)))
def test_stage_tests_the_best_checkpoint(demo_run, stage, version):
    _, stdout, stderr, cwd = demo_run
    record = stage_records(stdout).get(stage)
    assert record is not None, stderr[-3000:]
    log_dir = cwd / "logs" / "SurfaceFormer" / version
    best = CheckpointManager(str(log_dir / "checkpoints")).best_path()
    # two scored epochs: the newer wins the tie at the untrained model's precision
    assert record["tested_ckpt"] == best
    assert os.path.basename(best) != "last" and os.path.basename(best).startswith("epoch=")
    assert f"{stage}: testing {best}" in stdout
    with open(log_dir / "results.json") as f:
        results = json.load(f)
    assert record["results"] == results
    assert results["num_samples"] == len(read_lines(cwd / "data" / "synthetic-flat-big"
                                                    / "test.txt"))
    records = [json.loads(line) for line in open(log_dir / "metrics.jsonl")]
    steps = [r["step"] for r in records if "train_loss" in r]
    per_epoch = len(read_lines(cwd / "data" / "synthetic-flat-big" / "train.txt")) // 8
    assert steps == list(range(1, 2 * per_epoch + 1))
    assert sum("valid_precision" in r for r in records) == 2
    # the STAGE line's epochs: each epoch's seconds split, as ms a step too
    epochs = record["fit"]["epochs"]
    assert [e["steps"] for e in epochs] == [per_epoch, per_epoch]
    for e in epochs:
        assert set(e["seconds"]) == set(train_demos.EPOCH_SECONDS)
        assert all(0.0 < v <= e["seconds"]["epoch_train_seconds"] for v in e["seconds"].values())
    assert record["version"] == version and record["seed"] == int(stage[-1])
    assert record["fit"]["launches"] == {} and record["test"]["launches"] == {}


@pytest.mark.parametrize("version", GOOD)
def test_out_holds_the_audit_files(demo_run, version):
    cwd = demo_run[3]
    out, log_dir = cwd / "out" / version, cwd / "logs" / "SurfaceFormer" / version
    metas = sorted(p.name for p in (log_dir / "checkpoints").glob("*.meta.json"))
    assert len(metas) == 3  # last and the two scored epochs
    copied = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
    assert copied == sorted([*AUDIT, *(os.path.join("checkpoints", m) for m in metas)])
    for rel in copied:
        assert (out / rel).read_bytes() == (log_dir / rel).read_bytes()
    # no weights, predictions or event files
    assert not any(p.name == "last" or p.name.startswith("events.") for p in out.rglob("*"))


def test_failed_fit_is_not_tested_and_fails_the_run(demo_run):
    rc, stdout, stderr, cwd = demo_run
    assert rc == 1
    assert "=== stage dirtok-s0 FAILED (exit code 1)" in stdout
    assert "failed stages: dirtok-s0" in stderr
    assert "FileNotFoundError" in stderr
    assert "dirtok-s0" not in stage_records(stdout)
    assert "dirtok-s0: testing" not in stdout
    assert not (cwd / "logs" / "SurfaceFormer" / "torch-dirtok-big-s0" / "results.json").exists()
    assert not (cwd / "out" / "torch-dirtok-big-s0" / "results.json").exists()
    # the stage started after the failure ran to its end
    assert stdout.index("=== stage dirtok-s0 FAILED") < stdout.index("=== stage flat-s1 start")
    assert set(stage_records(stdout)) == {"flat-s0", "flat-s1"}


def test_stage_over_two_ranks_records_each_ranks_counts(tmp_path):
    """A stage over two gloo ranks: each phase's record holds the rank count
    and one entry a rank, read from the file that rank wrote, never the
    stage process's own (empty) counts."""
    synthetic_data.main(["--root", str(tmp_path / "data" / "synthetic-flat-big"), *TINY_GEN])
    proc = subprocess.run(
        [sys.executable, "-m", "faceformer_tpu_torch.tools.train_demos", "run", "--device",
         "cpu", "flat-s0", *TINY, "trainer.max_epochs", "1", "trainer.num_devices", "2"],
        cwd=tmp_path, env=stage_env(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    record = stage_records(proc.stdout)["flat-s0"]
    stats = tmp_path / "logs" / "SurfaceFormer" / GOOD[0] / "rank_stats"
    for phase in ("fit", "test"):
        got = record[phase]
        assert got["ranks"] == 2 and [r["rank"] for r in got["by_rank"]] == [0, 1]
        for r in got["by_rank"]:
            assert json.loads((stats / phase / f"rank{r['rank']}.json").read_text()) == r
            # the CPU runs the plain versions: no launch, no device memory
            assert r["launches"] == {} and r["max_memory_allocated"] == 0
        assert got["launches"] == {} and got["max_memory_allocated"] == 0
    assert record["tested_ckpt"] == CheckpointManager(
        str(stats.parent / "checkpoints")).best_path()
    assert "rank 1 of 2" in proc.stdout


def test_phase_sums_the_ranks_files(tmp_path, monkeypatch):
    """``_phase`` reads one file a rank: launches summed, the largest peak;
    a rank that wrote none fails the phase."""
    from faceformer_tpu_torch import main

    written = [{"rank": 0, "launches": {"flash_fwd": 5, "flash_bwd": 2}, "max_memory_allocated": 7},
               {"rank": 1, "launches": {"flash_fwd": 3, "pointer_argmax": 1},
                "max_memory_allocated": 9}]

    def fake_main(argv, rank_stats):
        os.makedirs(rank_stats)
        for stats in written[:int(argv[0])]:
            (tmp_path / "stats" / f"rank{stats['rank']}.json").write_text(json.dumps(stats))

    monkeypatch.setattr(main, "main", fake_main)
    got = train_demos._phase(["2"], str(tmp_path / "stats"), 2)
    assert got["ranks"] == 2 and got["by_rank"] == written
    assert got["launches"] == {"flash_fwd": 8, "flash_bwd": 2, "pointer_argmax": 1}
    assert got["max_memory_allocated"] == 9
    # the directory is emptied first, so the earlier run's rank 1 does not count
    with pytest.raises(RuntimeError, match="rank 1 of 2 wrote no counts"):
        train_demos._phase(["1"], str(tmp_path / "stats"), 2)


# -- (iv) the summary ------------------------------------------------------------------


@pytest.fixture
def written_results(tmp_path):
    """Three versions' results.json with seeded metrics and two sample counts."""
    rng = np.random.default_rng(4)
    versions = [f"torch-seq2seq-big-s{i}" for i in range(3)]
    for i, v in enumerate(versions):
        (tmp_path / v).mkdir()
        row = {m: float(rng.uniform(0.9, 1.0)) for m in train_demos.METRICS}
        row.update(avg_time_per_sample=float(rng.uniform(0.001, 0.01)),
                   num_samples=410 if i < 2 else 409)
        (tmp_path / v / "results.json").write_text(json.dumps(row))
    return str(tmp_path), versions


@pytest.mark.parametrize("source", ["written", "fit"])
def test_summary_equals_root_aggregate(source, written_results, demo_run, capsys):
    if source == "written":
        log_root, versions = written_results
    else:
        log_root, versions = str(demo_run[3] / "logs" / "SurfaceFormer"), list(GOOD)
    want = aggregate_results.aggregate(versions, log_root=log_root)
    assert train_demos.aggregate(versions, log_root=log_root) == want
    assert train_demos.main(["summary", *versions, "--log_root", log_root]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == want


# -- (v) the recipe's step count, and the corpus digest -----------------------------------


@pytest.fixture(scope="module", params=sorted(RECIPES))
def recipe_corpora(request, tmp_path_factory):
    """A trained recipe's corpus at 256 solids, by the port and by JAX:
    (port root, JAX root, the recipe's config)."""
    config, gen = RECIPES[request.param]
    tmp = tmp_path_factory.mktemp(f"recipe-{request.param}")
    port, jax_root = str(tmp / "port"), str(tmp / "jax")
    synthetic_data.main(["--root", port, "--num", "256", *gen])
    jax_synthetic_data.main(["--root", jax_root, "--num", "256", *gen])
    return port, jax_root, config


def test_corpus_digests_equal(recipe_corpora, tmp_path):
    port, jax_root, _ = recipe_corpora
    digest = train_demos.corpus_digest(port)
    assert digest == train_demos.corpus_digest(jax_root)
    assert digest["json"] == 256 and sum(digest["split"]) == 256
    # the digest reads every JSON's bytes
    changed = tmp_path / "changed"
    os.makedirs(changed / "json")
    for name in ("train.txt", "valid.txt", "test.txt"):
        (changed / name).write_bytes(open(os.path.join(port, name), "rb").read())
    names = sorted(os.listdir(os.path.join(port, "json")))
    for name in names:
        data = open(os.path.join(port, "json", name), "rb").read()
        (changed / "json" / name).write_bytes(data + b" " if name == names[-1] else data)
    assert train_demos.corpus_digest(str(changed))["sha256"] != digest["sha256"]


def test_recipe_batches_equal_jax(recipe_corpora):
    port, jax_root, config = recipe_corpora
    cfg = load_config(config, ["root_dir", port])
    harness = Harness(cfg, device="cpu")
    ds = harness.dataset("train")
    jcfg = jax_load_config(config, ["root_dir", jax_root])
    # the JAX dataset of the config's dataset_class (ABCDataset_Parallel is an alias there)
    jds = getattr(jax_dataset, jcfg.dataset_class)(jcfg.root_dir, list(jcfg.datasets_train),
                                                   jcfg.model)
    assert type(ds).__name__ == type(jds).__name__
    train = len(read_lines(os.path.join(port, "train.txt")))
    assert len(ds) == len(jds) == train
    for epoch in (0, 1):
        kwargs = dict(shuffle=True, drop_last=True, seed=cfg.trainer.seed, epoch=epoch)
        got = [[os.path.basename(n) for n in b["name"]]
               for b in mesh.shard_batch(ds, cfg.batch_size_train, harness.world, **kwargs)]
        want = [[os.path.basename(n) for n in b["name"]]
                for b in jax_iter_batches(jds, jcfg.batch_size_train, shuffle=True,
                                          drop_last=True, seed=jcfg.trainer.seed, epoch=epoch)]
        assert got == want
        # the recipe's rule: train // 32 full batches an epoch (238 at 8,192 solids)
        assert [len(names) for names in got] == [32] * (train // 32)
        if cfg.model_class != "SurfaceFormer_Parallel":
            continue
        # the flagship's run: four data ranks of 8 rows, whose k-th batches
        # interleave (rank r holds rows r, r + 4, ...) into JAX's k-th batch
        stripes = [[[os.path.basename(n) for n in b["name"]]
                    for b in mesh.shard_batch(ds, cfg.batch_size_train,
                                              mesh.World(r, 4, r, 4, harness.world.device),
                                              **kwargs)]
                   for r in range(4)]
        assert [len(s) for s in stripes] == [len(want)] * 4
        assert all(len(names) == 8 for s in stripes for names in s)
        for k, names in enumerate(want):
            assert [stripes[j % 4][k][j // 4] for j in range(32)] == names


# -- the committed card runs of the trained recipes ------------------------------------------

LOGS = os.path.join(REPO, "logs", "SurfaceFormer")
TORCH_SEEDS = [f"torch-seq2seq-big-s{i}" for i in range(3)]
JAX_SEEDS = [f"seq2seq-big-s{i}" for i in range(3)]
DIRTOK_SEEDS = [f"torch-dirtok-big-s{i}" for i in range(2)]
# the direction-token recipe's published row is the 60-epoch one; the
# dirtok-big-s{0,1} runs are its 30-epoch ablation (recall 0.78)
DIRTOK_JAX_SEEDS = ["dirtok-big-e60-s0", "dirtok-big-e60-s1"]
DIRTOK_TOL = 0.01  # the port's two-seed mean against the JAX mean
COEDGE_SEEDS = [f"torch-coedge-big-s{i}" for i in range(3)]
COEDGE_JAX_SEEDS = [f"coedge-big-s{i}" for i in range(3)]
# version -> (steps: 238 an epoch, validations: one every 4th epoch)
COMMITTED = {**{v: (7140, 7) for v in TORCH_SEEDS + COEDGE_SEEDS},
             **{v: (14280, 15) for v in DIRTOK_SEEDS}}


@pytest.mark.parametrize("version", sorted(COMMITTED))
def test_committed_seed_ran_the_recipe(version):
    """Every step of the recipe (238 an epoch), a validation every 4th
    epoch, the 410-solid test, and the top-2 index whose first entry
    ``best_path`` names."""
    n_steps, n_valid = COMMITTED[version]
    records = [json.loads(line) for line in open(os.path.join(LOGS, version, "metrics.jsonl"))]
    steps = [r["step"] for r in records if "train_loss" in r]
    assert steps == list(range(1, n_steps + 1))
    assert all(r["train_loss"] is not None and np.isfinite(r["train_loss"])
               for r in records if "train_loss" in r)
    assert [r["step"] for r in records if "valid_precision" in r] == [
        952 * k for k in range(1, n_valid + 1)]
    with open(os.path.join(LOGS, version, "results.json")) as f:
        assert json.load(f)["num_samples"] == 410
    with open(os.path.join(LOGS, version, "checkpoints", "index.json")) as f:
        index = json.load(f)
    assert len(index["top"]) == 2 and index["top"][0][0] >= index["top"][1][0]
    best = index["top"][0]
    assert os.path.basename(best[1]) == f"epoch={best[2]}-valid_precision={best[0]:.4f}"
    assert os.path.isfile(os.path.join(LOGS, version, "checkpoints",
                                       os.path.basename(best[1]) + ".meta.json"))


@pytest.mark.parametrize("ours,theirs", [(TORCH_SEEDS, JAX_SEEDS),
                                         (COEDGE_SEEDS, COEDGE_JAX_SEEDS)],
                         ids=["flat", "coedge"])
def test_committed_seeds_mean_lies_in_the_jax_spread(ours, theirs):
    ours = train_demos.aggregate(ours, log_root=LOGS)
    jax_runs = aggregate_results.aggregate(theirs, log_root=LOGS)
    assert ours["num_samples"] == jax_runs["num_samples"] == 410
    for metric in ("test_precision", "test_recall"):
        assert jax_runs[metric]["min"] <= ours[metric]["mean"] <= jax_runs[metric]["max"]
    assert all(row["test_type_acc"] == 1.0 for row in ours["versions"].values())


def test_committed_dirtok_seeds_mean_near_the_jax_60_epoch_mean():
    """The two JAX seeds lie 0.0002 (precision) and 0.0005 (recall) apart,
    narrower than any seed spread in the repository, so the port's mean is
    held to their mean within DIRTOK_TOL."""
    ours = train_demos.aggregate(DIRTOK_SEEDS, log_root=LOGS)
    jax_runs = aggregate_results.aggregate(DIRTOK_JAX_SEEDS, log_root=LOGS)
    assert ours["num_samples"] == jax_runs["num_samples"] == 410
    for metric in ("test_precision", "test_recall"):
        assert abs(ours[metric]["mean"] - jax_runs[metric]["mean"]) <= DIRTOK_TOL, metric
    assert all(row["test_type_acc"] == 1.0 for row in ours["versions"].values())


@pytest.mark.parametrize("version", DIRTOK_SEEDS)
def test_committed_diagnosis_counts_hold_together(version):
    """The direction-token diagnosis of the checkpoint the seed's test read."""
    with open(os.path.join(LOGS, version, "diagnose_dirtok.json")) as f:
        runs = json.load(f)
    d = runs[-1]
    assert d["samples"] == 410
    assert 0 <= d["kept_matches_label"] <= d["pred_kept"] <= d["pred_raw"]
    assert d["dropped_but_matches_label"] <= d["pred_raw"] - d["pred_kept"]
    assert d["filter_drop_rate"] == round(1 - d["pred_kept"] / max(d["pred_raw"], 1), 4)
    with open(os.path.join(LOGS, version, "checkpoints", "index.json")) as f:
        best = json.load(f)["top"][0][1]
    assert os.path.basename(d["ckpt"]) == os.path.basename(best)
