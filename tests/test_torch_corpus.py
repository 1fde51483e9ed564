"""PyTorch port: the corpus command lines against the root scripts they
copy. ``python -m faceformer_tpu_torch.tools.gen_step_solids`` writes the
STEP files of ``tools/gen_step_solids.py``, and ``python -m
faceformer_tpu_torch.tools.prepare_data --backend native`` the JSON, SVG,
stat and split files of ``tools/prepare_data.py`` under the default flag
set (at one core with ``jax`` unimportable, loading neither the JAX
package nor torch, and at two cores), ``--random_camera``,
``--combine_coedge``, ``--direction_token`` and ``--order_by_position``;
the other flag sets are in test_torch_corpus_flags.py. How the files are
compared: tests/torch_corpus_helpers.py."""

import importlib.util
import os
import subprocess
import sys

import pytest

from torch_corpus_helpers import (
    CORPUS_NUM,
    PORT_PREPARE,
    REPO,
    check_prepared,
    env,
    make_corpus,
    prepared,
    root_script_corpora,
)

NO_JAX_RUN = """
import sys
sys.modules["jax"] = None
from faceformer_tpu_torch.tools import prepare_data
prepare_data.main(sys.argv[1:])
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("faceformer_tpu", "torch"))
assert not bad, bad
"""
CASES = [("default", 1), ("default", 2), ("random_camera", 1), ("combine_coedge", 1),
         ("direction_token", 1), ("order_by_position", 1)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory)


@pytest.fixture(scope="module")
def jax_corpora(corpus, tmp_path_factory):
    return root_script_corpora(corpus, tmp_path_factory)


def test_gen_step_solids_writes_the_root_scripts_files(corpus):
    assert len(corpus["port_files"]) == CORPUS_NUM
    assert corpus["port_files"] == corpus["jax_files"]
    assert corpus["traced"], "the corpus has no traced solid to hold"


@pytest.mark.parametrize("flags,cores", CASES, ids=[f"{f}-{c}core" for f, c in CASES])
def test_prepare_data_writes_the_root_scripts_files(flags, cores, corpus, jax_corpora, tmp_path):
    argv = ["-c", NO_JAX_RUN] if (flags, cores) == ("default", 1) else PORT_PREPARE
    ours = prepared(corpus, str(tmp_path / "port"), argv, flags, cores)
    check_prepared(corpus, ours, jax_corpora(flags), flags)
    if cores > 1:  # the pool changes no byte of the port's output
        again = prepared(corpus, str(tmp_path / "port-1core"), PORT_PREPARE, flags, 1)
        assert again == ours


def test_backend_occ_without_pythonocc_raises_as_jax(tmp_path):
    from faceformer_tpu.tools.occ_pipeline import require_occ as jax_require_occ
    from faceformer_tpu_torch.tools.occ_pipeline import require_occ

    if importlib.util.find_spec("OCC") is not None:
        pytest.skip("pythonocc is installed: the error path cannot be shown")
    errors = []
    for check in (require_occ, jax_require_occ):
        with pytest.raises(ImportError) as info:
            check()
        errors.append(str(info.value).replace("faceformer_tpu_torch.", "faceformer_tpu."))
    assert errors[0] == errors[1]
    for argv in ([os.path.join("tools", "prepare_data.py")], PORT_PREPARE):
        proc = subprocess.run([sys.executable, *argv, "--root", str(tmp_path), "--backend", "occ"],
                              cwd=REPO, env=env(), capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        last = proc.stderr.strip().splitlines()[-1]
        assert last.replace("faceformer_tpu_torch.", "faceformer_tpu.") == "ImportError: " + errors[1]
        assert not os.listdir(tmp_path)  # nothing written before the check
