"""The per-lane operation counts frozen in the configurations are what
kernels/opcount.py counts for serial_arm(6) (needs g++)."""

import json
import pathlib
import shutil

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("config", ["arm6_s", "arm6_as"])
def test_frozen_counts_equal_the_counter(config):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build kernels/needed_ops.cpp")
    import torch

    from trajoptmpcreference_tpu_torch.kernels import opcount
    from trajoptmpcreference_tpu_torch.models.urdf import serial_arm
    from trajoptmpcreference_tpu_torch.ops import lanes
    frozen = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    packed = lanes.pack_robot(serial_arm(6), torch.float64, "cpu")
    for lib, c in frozen["kernels"].items():
        assert opcount.count_needed(lib, packed, 6) == c["ops_per_lane"], lib


@pytest.mark.parametrize("config", ["arm6_s", "arm6_as"])
def test_frozen_bytes_are_inputs_read_once_and_outputs_written_once(config):
    """f32, n = 6: K1 reads q, qd, u and writes (n, 3n); K2 writes qdd; K3
    reads q, qd and writes 2k = 6 values."""
    frozen = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    n, f = 6, 4
    want = {"fd_grad": f * (3 * n + n * 3 * n), "fd": f * (3 * n + n),
            "task_vec": f * (2 * n + 6)}
    assert {k: c["bytes_per_lane"] for k, c in frozen["kernels"].items()} == want
