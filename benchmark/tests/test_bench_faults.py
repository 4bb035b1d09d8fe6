"""A run of the harness on the CPU at a small batch, past the look for a
card, with the timed path broken underneath: ``correct`` comes out false
for each fault a cell can have, and true for the unbroken path (no cell
spans chips).  The port runs the cell's configuration in float64 here,
where it agrees with the float64 reference to rounding, so the unbroken
run passes at this size whatever a few steps' float32 rounding would
read; the float32 readings behind the limits are taken on the card at
the cell's own size (``control.py``)."""

import contextlib
import io
import json
import pathlib
import types

import pytest
import torch

import run
from benchlib import faults
from benchlib.manifest import Cell, load_json

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def tiny_cell(tmp_path, cell_name):
    """The cell with its configuration (in float64) and limits, at a batch
    of at most 8 and four-step episodes, so that it runs on the CPU in
    seconds."""
    man = load_json(ROOT / "BENCHMARK.json")
    work = next(w for w in man["workloads"] if w["name"] == cell_name)
    entry = next(c for c in man["configs"] if c["name"] == work["config"])
    cfg = dict(load_json(ROOT / entry["file"]), dtype="float64")
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    man["configs"].append(dict(entry, name="tiny64",
                               file=str(tmp_path / "config.json")))
    name = f"{work['config']}.tiny"
    man["workloads"].append({"name": name, "config": "tiny64",
                             "traffic": "tiny", "chips": 1, "why": "test"})
    for m in man["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(name)
    for sub in ("traffic", "limits"):
        (tmp_path / sub).mkdir()
    tr = load_json(BENCH / "traffic" / f"{work['traffic']}.json")
    B = min(tr["batch"], 8)
    tr.update(name="tiny", batch=B, episode_steps=4, warmup_steps=1,
              check=dict(cold_scenarios=B, steps=6, scenarios_per_step=B))
    (tmp_path / "traffic" / "tiny.json").write_text(json.dumps(tr))
    (tmp_path / "limits" / f"{name}.json").write_text(
        (BENCH / "limits" / f"{cell_name}.json").read_text())
    return Cell(name, manifest=man, root=ROOT, bench_dir=tmp_path)


def run_once(cell):
    out = io.StringIO()
    args = types.SimpleNamespace(seed=2**31 + 99, seconds=6.0, trace=0)
    with contextlib.redirect_stdout(out):
        assert run.measure(cell, args, torch.device("cpu")) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_unbroken_path_is_correct(tmp_path, cell_name):
    result = run_once(tiny_cell(tmp_path, cell_name))
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_planted_fault_is_not_correct(tmp_path, cell_name, fault):
    cell = tiny_cell(tmp_path, cell_name)
    with faults.planted(fault):
        result = run_once(cell)
    assert result["correct"] is False, result["checks"]


def test_nonfinite_multipliers_fail_the_check_and_count_as_failed(tmp_path):
    """NaN multipliers in an eighth of the batch: too few for any
    percentile, so ``nonfinite_share`` alone fails them, and each such
    scenario-step counts in ``failed``."""
    cell = tiny_cell(tmp_path, "arm6_s.b512")
    with faults.planted("nonfinite_lam"):
        result = run_once(cell)
    checks = result["checks"]
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] // 8
    assert checks["nonfinite_share"]["value"] == pytest.approx(1 / 8)
    assert all(v["value"] <= v["limit"] for k, v in checks.items()
               if k != "nonfinite_share"), checks
