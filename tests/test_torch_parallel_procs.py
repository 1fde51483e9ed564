"""PyTorch port: processes of a multi-rank run on the CPU. Two ranks of the
command line that fail end the command non-zero and leave none running;
two processes that build the kernels at once (``ops/_build.py``) build
each library once and load it whole."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from torch_port_helpers import torch_fp32_single_thread  # noqa: F401


def test_a_failing_rank_fails_the_command(tmp_path):
    """Two ranks of the command line on a corpus that is not there: both
    fail, the command raises, and no rank is left running."""
    import multiprocessing

    from faceformer_tpu_torch import main as port_main

    yml = tmp_path / "bad.yml"
    yml.write_text(f"root_dir: '{tmp_path / 'missing'}'\nmodel:\n  num_model: 32\n"
                   "  num_head: 4\n  num_encoder_layers: 1\n  num_decoder_layers: 1\n")
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="missing"):
        port_main.main(["--config-file", str(yml), "--device", "cpu", "trainer.num_devices", "2",
                        "trainer.version", "bad"])
    assert multiprocessing.active_children() == []


FAKE_NVCC = """\
#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
src = sys.argv[-1]
with open(os.path.join(os.path.dirname(src), "calls.log"), "a") as f:
    f.write(os.path.basename(src) + "\\n")
with open(out, "wb") as f:
    for _ in range(8):  # slowly, so an unlocked reader would see a part
        f.write(b"x" * 4096)
        f.flush()
        time.sleep(0.05)
"""

BUILDER = """\
import sys
from faceformer_tpu_torch.ops import _build
_build.CSRC, _build.BUILD_DIR = sys.argv[1], sys.argv[2]
built = _build.build_all(("alpha", "beta"))
sizes = [len(open(_build.lib_path(n), "rb").read()) for n in ("alpha", "beta")]
print("BUILT=" + ",".join(built))
print("SIZES", sizes)
"""


def test_concurrent_builds_build_each_library_once(tmp_path):
    """Two processes build the same cold libraries at once against a stand-in
    nvcc that writes slowly: both succeed, each source compiles once, and
    each process finds its libraries whole."""
    csrc, bindir = tmp_path / "csrc", tmp_path / "bin"
    csrc.mkdir()
    bindir.mkdir()
    for name in ("alpha", "beta"):
        (csrc / f"{name}.cu").write_text("// stand-in source\n")
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=os.pathsep.join([os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), os.environ.get("PYTHONPATH", "")]))
    args = [sys.executable, "-c", textwrap.dedent(BUILDER), str(csrc), str(tmp_path / "build")]
    procs = [subprocess.Popen(args, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    built = [line[len("BUILT="):] for out in outs for line in out.splitlines()
             if line.startswith("BUILT=")]
    assert sorted(built) == ["", "alpha,beta"], outs
    assert all("SIZES [32768, 32768]" in out for out in outs), outs
    assert sorted((csrc / "calls.log").read_text().split()) == ["alpha.cu", "beta.cu"]
    assert not list((tmp_path / "build").glob("*.tmp"))
