"""utils.spans: the port's host-time spans, host-read counts and launch
counts.  CPU tests on the flagship arm at a small size (f64, N = 8, B = 3);
one card test (``-m card``) counts the synchronizing calls torch reports
on the card against the port's own count:

    python -m pytest --noconftest -o addopts= -m card tests/test_torch_spans.py
"""

import collections
import importlib.util
import pathlib
import traceback
import warnings

import pytest
import torch

from trajoptmpcreference_tpu_torch import (
    PendulumPlant,
    QuadraticCost,
    SQPOptions,
    make_mpc,
)
from trajoptmpcreference_tpu_torch import flagship as F
from trajoptmpcreference_tpu_torch.utils import spans

LAYERS = ("KKTSystem.form_blocks", "KKTSystem.solve_schur",
          "SQPSolver.line_search")


@pytest.fixture
def fresh():
    """Tracing off and every total and count cleared, before and after."""
    spans.enable(False)
    spans.reset()
    try:
        yield
    finally:
        spans.enable(False)
        spans.reset()


def _loop(B=3, device="cpu", dtype=torch.float64, **knobs):
    """(controller, x0s, cost params) of the flagship at N = 8."""
    knobs = dict(dict(N=8), **knobs)
    _, cost, ctrl = F.flagship_mpc(dtype=dtype, device=device, **knobs)
    x0s, goals = F.bench_scenarios(B, seed=3)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return ctrl, t(x0s), cost.default_params._replace(xg=t(goals))


def _run(steps=2, **knobs):
    ctrl, x0s, params = _loop(**knobs)
    return ctrl.run(x0s, steps, cost_params=params)


def test_off_records_nothing_and_returns_the_shared_no_op(fresh):
    assert spans.span("KKTSystem.form_blocks") is spans.OFF
    assert spans.step_span() is spans.OFF
    with spans.span("x"):
        pass
    _run(steps=1)
    snap = spans.snapshot()
    assert snap["spans"] == {}
    # the host reads are counted with tracing off too; nothing else
    assert snap["counts"] and all(k.startswith("sync/") for k in snap["counts"])


@pytest.mark.parametrize("knobs", [{}, dict(parallel_ls=False, exact_schur="thomas")],
                         ids=["flagship", "sequential_ls"])
def test_tracing_on_leaves_the_loop_bit_equal(fresh, knobs):
    off = _run(**knobs)
    spans.enable(True)
    on = _run(**knobs)
    for name, a in off._asdict().items():
        b = getattr(on, name)
        if torch.is_tensor(a):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("knobs", [{}, dict(parallel_ls=False),
                                   dict(torque_limit=6.0, torque_mode="ACTIVE_SET",
                                        max_iter=4)],
                         ids=["flagship", "sequential_ls", "active_set"])
def test_layer_calls_match_the_sqp_iterations(fresh, knobs):
    spans.enable(True)
    _run(**knobs)
    snap = spans.snapshot()
    calls = {n: s["calls"] for n, s in snap["spans"].items()}
    iterations = calls["SQPSolver.sqp_iterate"]
    assert iterations >= 2
    for name in LAYERS + ("KKTSystem.schur_blocks", "btridiag.solve",
                          "KKTSystem.recover_dxu"):
        assert calls[name] == iterations, name
    assert snap["counts"]["sync/sqp.round"] == iterations
    assert calls["MPCController.run"] == calls["MPCController.simulate"] == 2
    # each timed host read is one span call
    for key, n in snap["counts"].items():
        if key.startswith("sync/"):
            assert calls[key] == n, key
    if not knobs.get("parallel_ls", True):
        assert snap["counts"]["sync/sqp.line_search"] > iterations


def test_self_times_account_for_the_step(fresh):
    spans.enable(True)
    _run(steps=2)
    snap = spans.snapshot()["spans"]
    for name, s in snap.items():
        assert 0 <= s["self_ns"] <= s["ns"], name
    # every span of the loop lies inside MPCController.run
    total_self = sum(s["self_ns"] for s in snap.values())
    step = snap["MPCController.run"]["ns"]
    assert abs(total_self - step) <= 0.01 * step
    # the layers, the two self times and the waits outside the layers
    # account for the step as well
    parts = (sum(snap[n]["ns"] for n in LAYERS)
             + snap["SQPSolver.solve"]["self_ns"]
             + snap["SQPSolver.sqp_iterate"]["self_ns"]
             + snap["MPCController.run"]["self_ns"]
             + snap["MPCController.simulate"]["self_ns"]
             + sum(s["ns"] for n, s in snap.items() if n.startswith("sync/")))
    assert abs(parts - step) <= 0.01 * step


def test_nested_spans_and_reset(fresh):
    spans.enable(True)
    with spans.span("outer"):
        with spans.span("inner"):
            pass
        with spans.span("inner"):
            pass
    snap = spans.snapshot()["spans"]
    assert snap["outer"]["calls"] == 1 and snap["inner"]["calls"] == 2
    assert snap["outer"]["self_ns"] == snap["outer"]["ns"] - snap["inner"]["ns"]
    spans.reset()
    assert spans.snapshot() == {"spans": {}, "counts": {}}


@pytest.mark.parametrize("tracing", [False, True], ids=["off", "on"])
def test_host_bool_is_bool(fresh, tracing):
    spans.enable(tracing)
    cases = [torch.tensor(True), torch.tensor(False), torch.tensor([True]),
             torch.tensor(1.5), torch.tensor(0.0)]
    assert [spans.host_bool(t, "test") for t in cases] == [bool(t) for t in cases]
    assert spans.count("sync/test") == len(cases)
    assert ("sync/test" in spans.snapshot()["spans"]) == tracing
    with pytest.raises(RuntimeError):
        spans.host_bool(torch.tensor([True, False]), "test")


def test_profiler_nests_the_layers_inside_the_iterate(fresh):
    # a pendulum at two SQP iterations: the profiler's events stay few
    f64 = torch.float64
    eye = torch.eye(2, dtype=f64)
    cost = QuadraticCost(eye, 10 * eye, 0.1 * torch.eye(1, dtype=f64),
                         torch.tensor([3.14159, 0.0], dtype=f64))
    ctrl = make_mpc(PendulumPlant(), cost, None, 8, 0.05, method="QP-S",
                    options=SQPOptions(max_iter=2, expected_reduction_min=-100.0))
    x0s, params = torch.zeros(2, 2, dtype=f64), None
    spans.enable(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ctrl.run(x0s, 1, cost_params=params)
    events = [e for e in prof.events() if e.name in
              ("SQPSolver.sqp_iterate", "KKTSystem.form_blocks",
               "MPCController.run", "sync/sqp.round")]
    by = lambda n: [(e.time_range.start, e.time_range.end)
                    for e in events if e.name == n]
    outer, inner = by("SQPSolver.sqp_iterate"), by("KKTSystem.form_blocks")
    assert len(inner) == len(outer) == spans.snapshot()["spans"][
        "SQPSolver.sqp_iterate"]["calls"]
    for s, e in inner:
        assert any(s0 <= s and e <= e0 for s0, e0 in outer)
    assert len(by("MPCController.run")) == 1
    assert len(by("sync/sqp.round")) == len(outer)
    # without the profiler no record_function is opened, and the totals
    # are kept all the same
    spans.reset()
    ctrl.run(x0s, 1, cost_params=params)
    assert spans.snapshot()["spans"]["SQPSolver.sqp_iterate"]["calls"] == len(outer)


def _tool():
    """tools/host_spans.py, loaded by path (tools/ is not a package)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "host_spans.py"
    spec = importlib.util.spec_from_file_location("host_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_per_step_reads_a_snapshot():
    """tools/host_spans.per_step on a synthetic snapshot of two steps:
    known spans and host reads in, the per-step values out."""
    ms = 1_000_000
    span = lambda calls, incl, own: {"calls": calls, "ns": incl * ms,
                                     "self_ns": own * ms}
    snap = {"spans": {
        "MPCController.run": span(2, 100, 2),
        "MPCController.simulate": span(2, 4, 4),
        "SQPSolver.solve": span(2, 94, 6),
        "SQPSolver.sqp_iterate": span(6, 80, 8),
        "KKTSystem.form_blocks": span(6, 30, 30),
        "KKTSystem.solve_schur": span(6, 30, 2),
        "KKTSystem.schur_blocks": span(6, 6, 6),
        "btridiag.solve": span(6, 20, 20),
        "KKTSystem.recover_dxu": span(6, 2, 2),
        "SQPSolver.line_search": span(6, 12, 12),
        "sync/sqp.round": span(6, 6, 6),
        "sync/sqp.outer": span(2, 2, 2)},
        "counts": {"sync/sqp.round": 9, "launch/fd": 40}}
    out = _tool().per_step(snap)
    assert out["steps"] == 2 and out["step_ms"] == 50
    assert out["host.syncs_per_step"] == 4          # span calls, not counts
    assert out["host.sync_wait_ms_per_step"] == 4
    assert (out["kkt.host_ms_per_step"], out["linsolve.host_ms_per_step"],
            out["linesearch.host_ms_per_step"]) == (15, 15, 6)
    assert out["sqp.host_self_ms_per_step"] == 7
    assert out["mpc.host_self_ms_per_step"] == 3
    assert out["linsolve_parts_ms"] == {"KKTSystem.schur_blocks": 3,
                                        "btridiag.solve": 10,
                                        "KKTSystem.recover_dxu": 1}
    assert out["syncs_by_site"] == {"sync/sqp.round": 3, "sync/sqp.outer": 1}
    assert out["accounted_pct"] == 100
    assert _tool().per_step({"spans": {}, "counts": {"sync/x": 1}}) is None


def test_per_step_reads_replayed_solves():
    """Two steps of three exact solves each: one eager call, one capture
    (which replays) and four replays.  The replayed calls enter none of
    the three parts, whose calls say so."""
    ms = 1_000_000
    span = lambda calls, incl, own: {"calls": calls, "ns": incl * ms,
                                     "self_ns": own * ms}
    snap = {"spans": {
        "MPCController.run": span(2, 40, 10),
        "KKTSystem.solve_schur": span(6, 30, 4),
        "KKTSystem.schur_blocks": span(2, 4, 4),
        "btridiag.solve": span(2, 10, 10),
        "KKTSystem.recover_dxu": span(2, 2, 2),
        "graph/solve_schur.capture": span(1, 6, 6),
        "graph/solve_schur.replay": span(5, 4, 4)},
        "counts": {"graph/solve_schur.capture": 1,
                   "graph/solve_schur.replay": 9}}
    out = _tool().per_step(snap)
    assert out["linsolve.calls_per_step"] == 3
    assert out["graphs_by_site"] == {"graph/solve_schur.capture": 0.5,
                                     "graph/solve_schur.replay": 2.5}
    assert out["graph_ms_by_site"] == {"graph/solve_schur.capture": 3,
                                       "graph/solve_schur.replay": 2}
    assert abs(out["linsolve.graph_hit_pct"] - 100 * 5 / 6) < 1e-9
    assert out["linsolve_parts_calls_per_step"] == {
        "KKTSystem.schur_blocks": 1, "btridiag.solve": 1,
        "KKTSystem.recover_dxu": 1}
    assert out["linsolve_parts_ms"]["btridiag.solve"] == 5
    assert out["accounted_pct"] == 100
    # no exact solve, no share
    del snap["spans"]["KKTSystem.solve_schur"]
    assert _tool().per_step(snap)["linsolve.graph_hit_pct"] is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_card_syncs_are_the_ports_host_reads(fresh, card):
    """Five steady flagship steps at B = 512 (N = 64, f32, the kernels on)
    under torch's sync debug mode: every synchronizing call torch reports
    is one of the port's counted host reads or the step's one copy of the
    applied control to the host."""
    _, cost, ctrl = F.flagship_mpc(dtype=torch.float32, device=card)
    x0s, goals = F.bench_scenarios(512, seed=3)
    x = torch.as_tensor(x0s, dtype=torch.float32, device=card)
    params = cost.default_params._replace(
        xg=torch.as_tensor(goals, dtype=torch.float32, device=card))
    carry = {}

    def step():
        nonlocal x, carry
        res = ctrl.run(x, 1, cost_params=params, **carry)
        res.U_applied[..., 0].cpu()
        carry = dict(X_init=res.X_plan_last, U_init=res.U_plan_last,
                     cstate_init=res.cstate_last, lam_init=res.lam_last)
        x = res.X_applied[..., -1]

    for _ in range(3):          # warm: kernels built, caches filled
        step()
    torch.cuda.synchronize()
    spans.reset()
    steps, syncs = 5, []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            # where the port's or torch's Python code asked for the sync
            syncs.append([f"{f.filename}:{f.lineno} {f.name}"
                          for f in traceback.extract_stack()[:-1]
                          if "site-packages" not in f.filename
                          and not f.filename.endswith("warnings.py")][-3:])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):
                step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    reads = sum(n for k, n in spans.snapshot()["counts"].items()
                if k.startswith("sync/"))
    sites = collections.Counter(where[-1] for where in syncs)
    print(f"[syncs] {len(syncs)} synchronizing calls in {steps} steps; the "
          f"port's host reads {reads}, the steps' copies {steps}; by site "
          f"{dict(sites)}")
    for where in syncs:
        if not where[-1].endswith((" host_bool", " step")):
            print(f"[syncs] other: {where}")
    assert len(syncs) == reads + steps, sites
