"""PyTorch port: the multi-rank dry run (parallel/dryrun.py, counterpart of
__graft_entry__.py::dryrun_multichip) on four gloo ranks on the CPU: a 2x2
grid, one Adam step with dropout, the causal_cache and fused decodes, and
the flagship-width forward and backward (one layer each on the CPU)."""

import re

from faceformer_tpu_torch.parallel.dryrun import dryrun_multichip, model_axis_for


def test_dryrun_multichip_four_ranks_on_the_cpu(capsys):
    line = dryrun_multichip(4, device="cpu")
    assert line in capsys.readouterr().out
    m = re.match(r"dryrun_multichip ok: mesh=\(2x2\), loss=([0-9.]+), decode grid "
                 r"\(4, 48, 16\), fused ok .*q shard \(256, 512\), backend gloo\)$", line)
    assert m and float(m.group(1)) > 0
    assert [model_axis_for(n) for n in (1, 2, 3, 4, 6, 8)] == [1, 1, 1, 2, 2, 2]
