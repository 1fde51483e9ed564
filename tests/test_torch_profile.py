"""PyTorch port: ``tools.profile`` on the CPU at tiny dims. Its batch equals
the JAX tool's (``__graft_entry__._synthetic_batch``) array for array, and a
``--device cpu`` run of each of ``--what decode`` and ``--what train``
writes a Chrome trace that parses as JSON."""

import json
import os

import numpy as np
import pytest

from __graft_entry__ import _synthetic_batch
from faceformer_tpu_torch import ops
from faceformer_tpu_torch.tools import profile

from torch_port_helpers import port_model_cfg, torch_fp32_single_thread  # noqa: F401


def test_profile_batch_equals_the_jax_tools(tiny_model_cfg):
    ours = profile.synthetic_batch(port_model_cfg(tiny_model_cfg), 3)
    theirs = _synthetic_batch(tiny_model_cfg, batch_size=3)
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key], np.asarray(value), err_msg=key)


@pytest.mark.parametrize("what,mode", [("decode", "fused"), ("train", "causal_cache")])
def test_profile_writes_a_trace(tiny_model_cfg, tmp_path, capsys, what, mode):
    fields = ("num_points_per_line", "num_lines", "label_seq_length", "max_num_faces",
              "max_face_length", "num_model", "num_head", "num_feedforward",
              "num_encoder_layers", "num_decoder_layers")
    yml = tmp_path / "tiny.yml"
    yml.write_text("model:\n" + "".join(f"  {k}: {getattr(tiny_model_cfg, k)}\n"
                                          for k in fields))
    out = tmp_path / "trace"
    profile.main(["--what", what, "--mode", mode, "--config", str(yml), "--batch", "2",
                  "--iters", "1", "--out", str(out), "--device", "cpu"])
    with open(os.path.join(out, f"{what}.json")) as f:
        trace = json.load(f)
    assert any(ev.get("name", "").startswith("aten::") for ev in trace["traceEvents"])
    printed = capsys.readouterr().out
    assert f"{what}: 1 iters in" in printed and "host (CPU run) ms" in printed


def test_device_time_goes_to_the_launching_wrapper():
    """A trace as torch.profiler writes it on the card: device work counts
    for the wrapper whose launch range holds, on the same thread, the call
    that launched it, whatever the kernel's name (K4's entry runs K2's
    attention and K1's pointer code); work launched outside every range,
    or on another thread while a range is open, is "other"."""
    def annotation(name, ts, dur, tid=1):
        return {"cat": "user_annotation", "name": ops.RANGE + name, "pid": 7, "tid": tid,
                "ts": ts, "dur": dur}

    def launch(ts, corr, tid=1):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 7, "tid": tid,
                "ts": ts, "dur": 1, "args": {"correlation": corr}}

    def kernel(name, corr, dur):
        return {"cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": 1000 + corr,
                "dur": dur, "args": {"correlation": corr}}

    events = [
        annotation("flash_fwd", 10, 5), launch(12, 1), kernel("void ff::attention_kernel", 1, 3.0),
        annotation("decode_step", 20, 10), launch(21, 2), launch(23, 3), launch(25, 4),
        kernel("ff::gemm_wgmma", 2, 40.0), kernel("void ff::attention_kernel", 3, 5.0),
        kernel("void ff::pointer_argmax_kernel", 4, 2.0),
        launch(27, 5, tid=2), kernel("ampere_sgemm", 5, 7.0),  # another thread
        launch(40, 6), kernel("void ff::pointer_argmax_kernel", 6, 1.5),  # no range open
        annotation("flash_bwd", 50, 4, tid=2), launch(51, 7, tid=2),
        kernel("ff::flash_bwd_kernel", 7, 11.0),
        {"cat": "gpu_memset", "name": "Memset", "ts": 1100, "dur": 0.5,
         "args": {"correlation": 8}}, launch(52, 8, tid=2),
    ]
    assert profile.device_us_by_kernel(events) == {
        "K2 flash forward": 3.0, "K4 fused decode step": 47.0, "K3 flash backward": 11.5,
        "other": 8.5}
    assert set(profile.KERNELS) == set(ops.LAUNCHES) - {"flash_fwd_tiled_tc",
                                                        "flash_bwd_tiled_tc"}
