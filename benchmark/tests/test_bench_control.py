"""The check's control on the card, at a batch that a test run holds: the
reference in the program's place in float32 with TF32 on fails at least
one of the cell's numbers, while the program passes every one (the full-
size readings are control.py's, in PERF.md)."""

import pathlib

import numpy as np
import pytest
import torch

from benchlib import correct
from benchlib.loop import ClosedLoop, Window
from benchlib.manifest import Cell, load_json

BENCH = pathlib.Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in load_json(BENCH.parent / "BENCHMARK.json")
         ["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_where_the_program_passes(card, cell_name):
    cell = Cell(cell_name)
    tr = dict(cell.traffic, batch=min(cell.traffic["batch"], 128))
    tr["check"] = dict(tr["check"], scenarios_per_step=min(
        tr["check"]["scenarios_per_step"], 128))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loop = ClosedLoop(cell.config, tr, 2**31 + 5, card)
    win = Window(loop, 4.0, np.random.default_rng(5), tr["check"])
    win.run()
    samples = win.samples_for_check()
    truth = correct.reference_answers(samples, cell.config, torch.float64,
                                      card)
    judge = lambda ans: correct.judge(
        correct.gaps(samples, ans, truth, cell.config), cell.limits)
    program = judge(correct.program_answers(samples))
    control = judge(correct.control_answers(samples, cell.config, card))
    assert all(v["value"] <= v["limit"] for v in program.values()), program
    assert any(v["value"] > v["limit"] for v in control.values()), control
