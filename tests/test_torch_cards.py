"""PyTorch port: the four-card path on the CPU (``parallel/mesh.py`` and
``chip_smoke.py --cards 4``).

``make_mesh``'s backend and card, with the card count and the process
group's start monkeypatched: four ranks on four cards take nccl and the
card of their local rank, four on one card gloo; a rank environment that
asks for more ranks than ``trainer.num_devices`` raises. ``chip_smoke.py
--cards 4`` with fewer than four cards exits 1 and names the count. Its
[12] (a) helpers (``dp_rank`` at any world size, ``dp_report`` reading the
ranks' files) on four gloo ranks at a tiny width, and a planted fault that
must fail the report. Nothing here imports JAX, nor do the ranks."""

import os
import shutil
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from faceformer_tpu_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT")

# [7] (a)'s configuration at a tiny width: 24 lines, d 32, one layer a stack
TINY_YML = """\
model_class: 'SurfaceFormer_Parallel'
dataset_class: 'ABCDataset_Parallel'
batch_size_train: 32
batch_size_valid: 32
trainer:
  lr: 1.0e-4
model:
  num_lines: 24
  max_num_faces: 16
  max_face_length: 16
  num_model: 32
  num_head: 2
  num_feedforward: 64
  num_encoder_layers: 1
  num_decoder_layers: 1
"""


@pytest.fixture
def cards(monkeypatch):
    """A host of ``set(n)`` cards as make_mesh sees it: the card count, the
    current card, and the process group's calls, recorded."""
    calls = {"init": [], "set_device": [], "new_group": []}

    def set_cards(n):
        monkeypatch.setattr(mesh, "require_device", torch.device)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "set_device", calls["set_device"].append)
        monkeypatch.setattr(dist, "is_initialized", lambda: False)
        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: calls["init"].append((backend, kw)))

        def new_group(ranks):
            calls["new_group"].append(list(ranks))
            return tuple(ranks)

        monkeypatch.setattr(dist, "new_group", new_group)
        return calls

    return set_cards


def rank_env(monkeypatch, rank, size=4):
    for key, value in zip(RANK_ENV, (rank, size, rank, size, "127.0.0.1", 29500)):
        monkeypatch.setenv(key, str(value))


@pytest.mark.parametrize("num_devices", [0, 4])
def test_four_ranks_on_four_cards_take_nccl_and_their_card(cards, monkeypatch, num_devices):
    calls = cards(4)
    for rank in range(4):
        rank_env(monkeypatch, rank)
        world = mesh.make_mesh(num_devices, "cuda")
        assert (world.backend, world.device, world.rank, world.size) == (
            "nccl", torch.device("cuda", rank), rank, 4)
        assert calls["set_device"][-1] == torch.device("cuda", rank)
        backend, kw = calls["init"][-1]
        # nccl binds the group to the rank's card at once
        assert backend == "nccl" and kw["device_id"] == torch.device("cuda", rank)
        assert (kw["rank"], kw["world_size"]) == (rank, 4)
    assert calls["new_group"] == []


def test_four_ranks_on_one_card_take_gloo(cards, monkeypatch):
    calls = cards(1)
    for rank in range(4):
        rank_env(monkeypatch, rank)
        world = mesh.make_mesh(4, "cuda")
        assert (world.backend, world.device) == ("gloo", torch.device("cuda", 0))
        backend, kw = calls["init"][-1]
        assert backend == "gloo" and "device_id" not in kw


def test_model_axis_groups_in_one_order_on_every_rank(cards, monkeypatch):
    """Data 2 x model 2 on four cards: every rank creates the rows' groups,
    then the columns', in the same order, and keeps its own."""
    calls = cards(4)
    for rank in range(4):
        rank_env(monkeypatch, rank)
        calls["new_group"].clear()
        world = mesh.make_mesh(4, "cuda", model_axis=2)
        assert calls["new_group"] == [[0, 1], [2, 3], [0, 2], [1, 3]]
        assert world.model_group == (2 * (rank // 2), 2 * (rank // 2) + 1)
        assert world.data_group == (rank % 2, rank % 2 + 2)
        assert (world.backend, world.data_rank, world.model_rank) == ("nccl", rank // 2, rank % 2)


def test_a_rank_environment_larger_than_num_devices_raises(cards, monkeypatch):
    cards(4)
    rank_env(monkeypatch, 1)
    with pytest.raises(ValueError, match="does not match the world of 4 ranks"):
        mesh.make_mesh(2, "cuda")
    for key in RANK_ENV:
        monkeypatch.delenv(key)
    # and four ranks asked of a process that is not one of them
    with pytest.raises(RuntimeError, match="asks for 4 ranks"):
        mesh.make_mesh(4, "cuda")


@pytest.mark.parametrize("count", [0, 2])
def test_chip_smoke_cards_needs_four_cards(count):
    """No fallback: with 0 or 2 cards visible ``--cards 4`` exits 1, names
    the count and prints no result."""
    fake = ("" if count == 0 else
            f"torch.cuda.is_available = lambda: True; torch.cuda.device_count = lambda: {count}; ")
    code = ("import sys, torch; " + fake + "sys.argv = ['chip_smoke.py', '--cards', '4']; "
            "import chip_smoke; sys.exit(chip_smoke.main())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 1, proc.stderr
    assert f"needs 4 visible CUDA cards: {count} visible" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_data_axis_on_four_gloo_ranks(tmp_path, monkeypatch):
    """[12] (a)'s helpers on four gloo ranks at a tiny width: the ranks
    train as one rank does, with [7] (a)'s gates and planted faults; then
    the report on the same files with rank 2's parameters replaced by
    those it reached without the all-reduce must fail."""
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' threads
    import chip_smoke

    failures, refs = [], []
    monkeypatch.setattr(chip_smoke, "fail", failures.append)
    reference = chip_smoke.dp_reference
    monkeypatch.setattr(chip_smoke, "dp_reference",
                        lambda *a: refs.append(reference(*a)) or refs[-1])
    spawn, kept = mesh.spawn, str(tmp_path / "ranks")

    def spawn_and_keep(size, fn, *args):
        spawn(size, fn, *args)
        shutil.copytree(args[1], kept)

    monkeypatch.setattr(mesh, "spawn", spawn_and_keep)
    config = tmp_path / "tiny.yml"
    config.write_text(TINY_YML)
    got = chip_smoke.run_dp_ranks(0, "cpu", str(config), ranks=4, backend="gloo",
                                  tag="[12] (a)")
    assert failures == []
    assert got["backends"] == ["gloo"] * 4 and got["loss_err"] <= chip_smoke.DP_LOSS_MAX
    assert min(got["faults"].values()) > chip_smoke.DP_UPDATE_MAX
    assert len(got["launches"]) == 4 and got["allreduce_bytes"] > 0

    path = os.path.join(kept, "rank2.pt")
    rank2 = torch.load(path)
    rank2["params"] = rank2["faults"]["no all-reduce"]
    torch.save(rank2, path)
    chip_smoke.dp_report(kept, 4, refs[0], "gloo", "[12] (a)")
    assert failures == ["[12] (a): 4 ranks do not train as one rank does"]
