"""Everything a run uses is found by name, and the import check compares
top-level module names whole."""

import json
import pathlib
import shutil

import pytest

from benchlib import imports, traffic
from benchlib.manifest import Cell, load_json

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@pytest.mark.parametrize("name", [w["name"] for w in load_json(
    ROOT / "BENCHMARK.json")["workloads"]])
def test_every_cell_loads_by_name(name):
    cell = Cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["name"] == cell.workload["traffic"]
    assert cell.limits["numbers"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "solves_per_s",
                                                    "step_ms_p95"}
    assert len(cell.per_layer) >= 1
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))


def test_a_new_configuration_and_metric_are_files_and_entries(tmp_path):
    """A later change adds a cell and a metric by adding files and
    manifest entries: nothing that is there changes."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    man = load_json(ROOT / "BENCHMARK.json")
    cfg = load_json(BENCH / "configs" / "arm6_s.json")
    cfg.update(name="arm6_s_n32", horizon=32)
    for k in ("knobs", "cold_knobs"):
        cfg[k]["N"] = 32
    (bench / "configs" / "arm6_s_n32.json").write_text(json.dumps(cfg))
    tr = load_json(BENCH / "traffic" / "b512.json")
    tr.update(name="b64", batch=64)
    (bench / "traffic" / "b64.json").write_text(json.dumps(tr))
    (bench / "limits" / "arm6_s_n32.b64.json").write_text(
        (BENCH / "limits" / "arm6_s.b512.json").read_text())
    (bench / "metrics" / "host.steps_traced.py").write_text(
        "def read(run):\n    return run.stretch.steps\n")
    man["configs"].append({"name": "arm6_s_n32", "source": "x",
                           "file": "benchmark/configs/arm6_s_n32.json",
                           "reduced": ["horizon"], "why": "x"})
    man["workloads"].append({"name": "arm6_s_n32.b64", "config": "arm6_s_n32",
                             "traffic": "b64", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "host.steps_traced", "unit": "steps",
                             "better": "higher", "source": "device_trace",
                             "layer": "host dispatch",
                             "moves": "step_ms_p95",
                             "workloads": ["arm6_s_n32.b64"]})
    cell = Cell("arm6_s_n32.b64", manifest=man, root=tmp_path,
                bench_dir=bench)
    assert cell.config["horizon"] == 32 and cell.traffic["batch"] == 64
    assert [m["name"] for m in cell.per_layer] == ["host.steps_traced"]

    class Run:
        stretch = type("S", (), {"steps": 7})
    assert cell.reader("host.steps_traced")(Run) == 7
    # the cells already there read as before
    assert Cell("arm6_s.b512", manifest=man, root=tmp_path,
                bench_dir=bench).per_layer == Cell("arm6_s.b512").per_layer


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        Cell("arm6_s.b3")


def test_import_check_compares_top_level_names_whole():
    ok = ["torch", "trajoptmpcreference_tpu_torch",
          "trajoptmpcreference_tpu_torch.solvers.sqp", "jaxtyping", "flaxen"]
    assert imports.forbidden_loaded(ok) == []
    assert imports.forbidden_loaded(ok + ["trajoptmpcreference_tpu"]) == [
        "trajoptmpcreference_tpu"]
    assert imports.forbidden_loaded(ok + ["jax.numpy", "jaxlib.xla_client",
                                          "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def test_each_seed_and_episode_draws_its_own_scenarios():
    import numpy as np
    tr = load_json(BENCH / "traffic" / "b512.json")
    a, ga = traffic.episode(tr, 1, 0)
    b, gb = traffic.episode(tr, 2**31 + 7, 0)
    c, gc = traffic.episode(tr, 1, 0)
    d, gd = traffic.episode(tr, 1, 1)
    assert (a == c).all() and (ga == gc).all()
    assert not np.isclose(a, b).any() and not np.isclose(a, d).any()
    # bench.py's distribution, the same sizes for every seed
    for x, g in ((a, ga), (b, gb), (d, gd)):
        assert x.shape == (512, 12) and g.shape == (512, 6)
        assert abs(x.std() - 0.1) < 0.01
        assert abs(g[:, :2].mean(0) - [3.0, 2.0]).max() < 0.1
        assert (g[:, 2:] == 0).all()


def test_a_configuration_names_its_reference_module(tmp_path):
    """A configuration's ``reference`` names a file of the benchmark's
    ``reference/``, loaded by path; without the key it is ``sqp``."""
    from benchlib import correct
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "other_robot.py").write_text(
        "NAME = 'other_robot'\n")
    cfg = load_json(BENCH / "configs" / "arm6_pcg.json")
    assert "reference" not in cfg
    sqp = correct.reference_module(cfg)
    assert pathlib.Path(sqp.__file__) == BENCH / "reference" / "sqp.py"
    assert callable(sqp.mpc_step) and callable(sqp.Problem)
    assert correct.reference_module(dict(cfg, reference="sqp")) is sqp
    mod = correct.reference_module(dict(cfg, reference="other_robot"),
                                   bench_dir=tmp_path)
    assert mod.NAME == "other_robot"
    with pytest.raises(FileNotFoundError):
        correct.reference_module(dict(cfg, reference="absent"))
