"""Everything a run needs, found by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic mix, its correctness limits and the
reader of each per-layer metric.

A later change adds a cell or a metric by adding files and entries:
``configs/<config>.json`` (named by the configuration's ``file``),
``traffic/<traffic>.json``, ``limits/<cell>.json``,
``metrics/<metric>.py`` with a function ``read(run)`` that returns the
metric's value, or None where the run holds nothing to read, and, where
the configuration names one, its plain reference
``reference/<module>.py`` (``benchlib.correct`` says what it provides).
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Callable, Dict, Optional

HERE = pathlib.Path(__file__).resolve().parents[1]       # benchmark/
ROOT = HERE.parent                                        # the checkout


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest with what it names, loaded."""

    def __init__(self, name: str, manifest: Optional[dict] = None,
                 root: pathlib.Path = ROOT, bench_dir: pathlib.Path = HERE):
        self.manifest = manifest if manifest is not None else load_json(
            root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                           f"{sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(bench_dir / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.limits = load_json(bench_dir / "limits" / f"{name}.json")
        self.bench_dir = bench_dir

    def _applies(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    @property
    def end_to_end(self):
        return [m for m in self.manifest["end_to_end"] if self._applies(m)]

    @property
    def per_layer(self):
        """The per-layer metrics this cell reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end}
        return [m for m in self.manifest["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric_name: str) -> Callable:
        return load_reader(self.bench_dir / "metrics" / f"{metric_name}.py")


def load_module(path: pathlib.Path, prefix: str):
    """The Python file at ``path``, loaded by its path (its name may hold
    dots, so it is not imported by name)."""
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(path: pathlib.Path) -> Callable:
    """The ``read`` function of one metric's file."""
    return load_module(path, "metric_").read


def readers(cell: Cell) -> Dict[str, Callable]:
    return {m["name"]: cell.reader(m["name"]) for m in cell.per_layer}
