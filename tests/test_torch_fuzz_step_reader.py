"""PyTorch port: the STEP-reader fuzz command
(``faceformer_tpu_torch/tools/fuzz_step_reader.py``) against the root
``tools/fuzz_step_reader.py``: the same seed texts, mutations and payloads,
the same status for each case through each package's reader, and the
contract's exit codes on a clean run and on planted violations."""

import os
import random
import subprocess
import sys
import time

import pytest

from faceformer_tpu_torch.tools import fuzz_step_reader as fuzz
from tools import fuzz_step_reader as root_fuzz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def statuses(module, tmp_path, cases):
    out = []
    for name, text in cases:
        path = os.path.join(str(tmp_path), f"{module.__name__.split('.')[0]}_{name}.step")
        with open(path, "w") as f:
            f.write(text)
        out.append((name, module.run_one(path, watchdog=10)[0]))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_texts_equal_the_root_tools(seed):
    ours, theirs = fuzz.make_seeds(seed, 6), root_fuzz.make_seeds(seed, 6)
    assert ours == theirs
    rng, root_rng = random.Random(seed), random.Random(seed)
    for k in range(60):
        assert fuzz.mutate(rng.choice(ours), rng) == root_fuzz.mutate(
            root_rng.choice(theirs), root_rng), k
    assert list(fuzz.pathological()) == list(root_fuzz.pathological())


@pytest.fixture(scope="module")
def mutations():
    """The root test's slice: 40 mutations of make_seeds(7, 6) from Random(11)."""
    seeds, rng = fuzz.make_seeds(7, 6), random.Random(11)
    return [(f"mut{k:02d}", fuzz.mutate(rng.choice(seeds), rng)) for k in range(40)]


@pytest.mark.parametrize("which", ["pathological", "mutations"])
def test_run_one_status_equals_the_root_tools(which, mutations, tmp_path):
    cases = list(fuzz.pathological()) if which == "pathological" else mutations
    ours = statuses(fuzz, tmp_path, cases)
    assert ours == statuses(root_fuzz, tmp_path, cases)
    assert {s for _, s in ours} <= set(fuzz.CLEAN), ours
    if which == "mutations":
        assert {"ok", "clean"} <= {s for _, s in ours}  # some read, some refused


def test_clean_run_exits_0(capsys):
    assert fuzz.main(["--num", "20", "--seed", "0"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("28 inputs: "), out
    assert "peak RSS" in out and "VIOLATION" not in out


def test_escaped_exception_is_a_violation(monkeypatch, capsys, tmp_path):
    def boom(path):
        raise RuntimeError("planted")

    monkeypatch.setattr(fuzz.step_native, "load_solid", boom)
    saved = tmp_path / "failures"
    assert fuzz.main(["--num", "2", "--seed", "0", "--save-failures", str(saved)]) == 1
    out = capsys.readouterr().out
    assert "10 inputs: RuntimeError=10" in out, out
    assert "VIOLATION path_empty: RuntimeError: planted" in out
    assert len(os.listdir(saved)) == 10


def test_memory_growth_past_the_limit_exits_1(capsys):
    assert fuzz.main(["--num", "0", "--max-rss-mb", "-1"]) == 1
    assert "MEMORY VIOLATION" in capsys.readouterr().out


def test_slow_input_times_out(monkeypatch, tmp_path):
    def slow(path):
        time.sleep(3)
        return None, 0

    monkeypatch.setattr(fuzz.step_native, "load_solid", slow)
    path = tmp_path / "slow.step"
    path.write_text("")
    t0 = time.perf_counter()
    assert fuzz.run_one(str(path), watchdog=1) == ("TIMEOUT", "exceeded 1s")
    assert time.perf_counter() - t0 < 2.5


def test_command_imports_neither_torch_nor_the_jax_package():
    code = ("import sys; import faceformer_tpu_torch.tools.fuzz_step_reader; "
            "print(sorted(m for m in sys.modules if m == 'torch' "
            "or m.split('.')[0] in ('faceformer_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]", out
