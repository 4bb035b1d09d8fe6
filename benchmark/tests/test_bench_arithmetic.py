"""The benchmark's arithmetic on synthetic data: rates, the p95 over every
step, interval unions, innermost-span attribution in a profiler trace and
the roofline with the frozen per-lane counts."""

import json
import pathlib

import numpy as np
import pytest

from benchlib import correct, stats, trace
from benchlib.manifest import load_reader

BENCH = pathlib.Path(__file__).resolve().parents[1]


def test_solves_per_s_counts_every_scenario_of_every_step():
    assert stats.solves_per_s(512, 300, 30.0) == pytest.approx(5120.0)


def test_p95_is_over_all_steps():
    v = list(range(1, 101))          # 100 steps, ms
    assert stats.percentile(v, 95) == pytest.approx(95.05)
    assert stats.percentile([5.0] * 19 + [100.0], 95) == pytest.approx(9.75)


def test_union_merges_overlaps_and_clips():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 10.0)]
    assert stats.union_length(iv) == pytest.approx(4.0)
    assert stats.union_length(iv, 1.0, 3.5) == pytest.approx(1.5)
    assert stats.idle_pct(1.0, 4.0) == pytest.approx(75.0)


def test_roofline_sums_bounds_over_device_time():
    counts = {"fd": {"ops_per_lane": 6885, "bytes_per_lane": 96}}
    peaks = {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    L = 32256
    bound = max(L * 6885 / 67e12, L * 96 / 3.35e12)
    assert bound == pytest.approx(L * 6885 / 67e12)     # K2 is bound by its ops
    pct = stats.roofline_pct([("fd", L, 2 * bound), ("fd", L, 2 * bound)],
                             counts, peaks)
    assert pct == pytest.approx(50.0)


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic_trace():
    """Two steps; in the first, a K1 launch inside form_blocks, a copy
    inside solve_schur; in the second a kernel launched in line_search and
    one outside every layer span.  Times in us."""
    return [
        _ev("user_annotation", "mpc.step", 0, 100),
        _ev("user_annotation", "SQPSolver.solve", 1, 90),
        _ev("user_annotation", "KKTSystem.form_blocks", 2, 30),
        _ev("user_annotation", "lanes.launch/fd_grad/6/32256", 5, 4),
        _ev("cuda_runtime", "cudaLaunchKernel", 6, 1, corr=1),
        _ev("kernel", "void fd_grad_kernel<float, 6>(float const*)", 20, 10, 1),
        _ev("user_annotation", "KKTSystem.solve_schur", 40, 30),
        _ev("cuda_runtime", "cudaMemcpyAsync", 41, 1, corr=2),
        _ev("gpu_memcpy", "Memcpy DtoD", 45, 5, 2),
        _ev("user_annotation", "mpc.step", 100, 100),
        _ev("user_annotation", "SQPSolver.line_search", 110, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 111, 1, corr=3),
        _ev("kernel", "elementwise_kernel", 115, 20, 3),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 1, corr=4),
        _ev("kernel", "reduce_kernel", 160, 10, 4),
    ]


def test_device_ops_count_for_the_innermost_span():
    s = trace.parse_chrome_trace(synthetic_trace(), steps=2)
    assert (s.start, s.end) == pytest.approx((0.0, 200e-6))
    layers = {o.name.split()[0]: o.layer for o in s.ops}
    assert layers == {"void": "kkt", "Memcpy": "linsolve",
                      "elementwise_kernel": "linesearch", "reduce_kernel": None}
    assert s.kernel_link == "correlation"
    assert s.lanes_launches() == [("fd_grad", 32256, pytest.approx(10e-6))]
    assert s.busy_s == pytest.approx(45e-6)
    b = s.breakdown()
    assert b["device_ops"][0][0].startswith("elementwise_kernel")
    # the longest gap (50..115 us) has the host inside the first solve,
    # the next (170..200 us) in the second step past its line search
    assert b["idle_gaps"][:2] == [["SQPSolver.solve", pytest.approx(65e-6)],
                                  ["mpc.step", pytest.approx(30e-6)]]


def test_kernels_tie_by_name_where_correlation_is_missing():
    ev = synthetic_trace()
    for e in ev:
        if e["name"].startswith("void fd_grad_kernel"):
            e["args"] = {"correlation": 99}
    s = trace.parse_chrome_trace(ev, steps=2)
    assert s.kernel_link == "kernel name"
    assert s.lanes_launches() == [("fd_grad", 32256, pytest.approx(10e-6))]


def test_readers_on_the_synthetic_trace():
    class Run:
        stretch = trace.parse_chrome_trace(synthetic_trace(), steps=2)
        iters = 1.75
        step_s = 200e-6
        peaks = json.loads((BENCH / "peaks.json").read_text())
        cell = type("C", (), {"config": json.loads(
            (BENCH / "configs" / "arm6_s.json").read_text())})

    read = lambda name: load_reader(BENCH / "metrics" / f"{name}.py")(Run)
    assert read("host.device_ops_per_step") == pytest.approx(2.0)
    assert read("kkt.device_ms_per_step") == pytest.approx(0.005)
    assert read("linsolve.device_ms_per_step") == pytest.approx(0.0025)
    assert read("linesearch.device_ms_per_step") == pytest.approx(0.01)
    assert read("kernels.device_ms_per_step") == pytest.approx(0.005)
    # 45 us busy over two steps of 200 us each on the untraced clock
    assert read("device.idle_pct") == pytest.approx(100 * (1 - 22.5 / 200))
    assert read("sqp.iters_per_step") == 1.75
    k1 = 32256 * 24099 / 67e12
    assert read("k1_k3_roofline") == pytest.approx(100 * k1 / 10e-6)


def test_a_reader_with_nothing_to_read_returns_none():
    class Run:
        stretch = trace.parse_chrome_trace(synthetic_trace()[-6:], steps=1)
        peaks = json.loads((BENCH / "peaks.json").read_text())
        cell = type("C", (), {"config": json.loads(
            (BENCH / "configs" / "arm6_s.json").read_text())})

    for name in ("k1_k3_roofline", "kernels.device_ms_per_step",
                 "kkt.device_ms_per_step"):
        assert load_reader(BENCH / "metrics" / f"{name}.py")(Run) is None


def test_gain_deficit_is_the_reference_gain_lacking():
    g = {"gain_ref": np.array([4.0, 2.0, 0.0, 2.0]),
         "gain": np.array([4.0, 3.0, 0.5, 1.0])}
    # the program gains 8.5 where the reference gains 8
    assert correct._gain_deficit(g) == pytest.approx(1 - 8.5 / 8)
    assert correct._gain_deficit(dict(g, gain=np.zeros(4))) == 1.0
    assert correct._gain_deficit(dict(g, gain=g["gain"] / 2)) == pytest.approx(
        1 - 4.25 / 8)
    assert correct._gain_deficit(dict(g, gain=np.array([4.0, 2.0, 0.0, np.nan]))
                                 ) == np.inf
    assert np.isnan(correct._gain_deficit(dict(g, gain_ref=np.zeros(4))))



def test_lam_steady_p75_is_over_the_steady_steps():
    # relative gaps 0.1 / 1, 0.2 / 2, 0.4 / 1 of the tame steady steps (the
    # first step is cold, the last runs away); the 75th percentile (the
    # higher value) is 0.4
    g = {"cold": np.array([1.0, 0, 0, 0, 0]),
         "runaway": np.array([0.0, 0, 0, 0, 1]),
         "lam": np.array([9.0, 0.1, 0.2, 0.4, 50.0]),
         "lam_scale": np.array([1.0, 0.5, 2.0, 1.0, 1.0])}
    assert correct.NUMBERS["lam_steady_p75"](g) == pytest.approx(0.4)
    g["lam"][2] = np.nan
    assert correct.NUMBERS["lam_steady_p75"](g) == np.inf


@pytest.mark.parametrize("qd, runs_away", [(0.0, False), (104.0, False),
                                           (104.72, True), (-150.0, True),
                                           (209.44, True)])
def test_a_step_runs_away_from_half_the_joint_speed_limit(qd, runs_away):
    """The state's fastest joint against half of sim_qd_max (209.44 rad/s):
    joint angles never count, and either sign does."""
    import torch

    from benchlib import loop
    cfg = json.loads((BENCH / "configs" / "arm6_s.json").read_text())
    x = np.zeros((2, 12))
    x[0, 4] = 1000.0                      # an angle, not a speed
    x[1, 9] = qd
    got = loop.runaway(torch.as_tensor(x), cfg).tolist()
    assert got == [False, runs_away]


def test_steady_gain_deficit_tame_leaves_run_away_steps_out():
    """A steady step that runs away with a merit loss of 4e5 (as a float32
    solve can have at the joint speed limit) swamps the plain deficit; the
    tame one reads the other steps alone, as the plain one did without it."""
    g = {"cold": np.array([1.0, 0, 0, 0]),
         "runaway": np.array([0.0, 0, 0, 1]),
         "gain": np.array([50.0, 4.0, 3.0, -4e5]),
         "gain_ref": np.array([60.0, 5.0, 3.0, 0.0])}
    tame = correct.NUMBERS["steady_gain_deficit_tame"](g)
    assert tame == pytest.approx(1 - 7 / 8)
    assert correct.NUMBERS["steady_gain_deficit"](g) > 1e4
    assert tame == correct.NUMBERS["steady_gain_deficit"](
        {k: v[:3] for k, v in g.items()})
    # every steady step running away leaves nothing to judge: not a pass
    g["runaway"][:] = 1
    assert np.isnan(correct.NUMBERS["steady_gain_deficit_tame"](g))


def test_runaway_share_is_over_every_step_of_the_window():
    """The window's flags, not the kept sample's: a run-away step that the
    sample missed counts, and a check without the window's flags has no
    reading, which fails any limit."""
    g = {"cold": np.array([1.0, 0]), "runaway": np.array([0.0, 0]),
         "nonfinite": np.array([0.0, 0]),
         "runaway_window": np.array([0.0, 0, 1, 0, 0, 0, 0, 1])}
    assert correct.NUMBERS["runaway_share"](g) == pytest.approx(0.25)
    # the per-step statistics ignore the window's flags
    steady = correct._steady(g)
    assert sorted(steady) == ["cold", "nonfinite", "runaway"]
    assert steady["cold"].tolist() == [0.0]
    del g["runaway_window"]
    assert np.isnan(correct.NUMBERS["runaway_share"](g))
    checks = correct.judge(g, {"numbers": {"runaway_share": 0.005}})
    assert not checks["runaway_share"]["value"] <= 0.005


def test_gaps_marks_run_away_steps_and_keeps_the_window_flags():
    import torch
    cfg, s, truth = _sample_and_answer()
    s.x[1, 7] = 0.6 * cfg["sim_qd_max"]
    flags = [torch.tensor([False, True]), torch.tensor([False, False])]
    g = correct.gaps([s], [truth], [truth], cfg, flags)
    assert g["runaway"].tolist() == [0.0, 1.0, 0.0]
    assert g["runaway_window"].tolist() == [0.0, 1.0, 0.0, 0.0]
    assert "runaway_window" not in correct.gaps([s], [truth], [truth], cfg)


def _sample_and_answer(b=3):
    import torch

    from benchlib.loop import Sample
    cfg = json.loads((BENCH / "configs" / "arm6_s.json").read_text())
    N, nx, nu = cfg["horizon"], 12, 6
    z = lambda *s: torch.zeros(*s, dtype=torch.float64)
    ans = dict(X_plan=z(b, nx, N), U_plan=z(b, nu, N - 1), lam=z(b, N, nx),
               u0=z(b, nu), x1=z(b, nx))
    s = Sample(0, 5, False, torch.arange(b), z(b, nx), z(b, 6), z(b, nx, N),
               z(b, nu, N - 1), z(b, N, nx), None, **ans)
    return cfg, s, ans


@pytest.mark.parametrize("output", ["X_plan", "U_plan", "lam", "u0", "x1"])
def test_a_nonfinite_output_counts_for_nonfinite_share(output):
    """One scenario of three with one element of one output not finite:
    that scenario-step alone is marked, and the check fails it although
    the cell's limits file does not name the number."""
    cfg, s, truth = _sample_and_answer()
    ans = dict(truth)
    ans[output] = truth[output].clone()
    ans[output].view(3, -1)[1, -1] = float("inf" if output == "lam" else "nan")
    g = correct.gaps([s], [ans], [truth], cfg)
    assert g["nonfinite"].tolist() == [0.0, 1.0, 0.0]
    assert correct.NUMBERS["nonfinite_share"](g) == pytest.approx(1 / 3)
    checks = correct.judge(g, {"numbers": {}})
    assert checks == {"nonfinite_share": {"value": pytest.approx(1 / 3),
                                          "limit": 0.0}}
    # a limits file cannot loosen it
    loose = correct.judge(g, {"numbers": {"nonfinite_share": 1.0}})
    assert loose["nonfinite_share"]["limit"] == 0.0
    assert correct.NUMBERS["nonfinite_share"](
        correct.gaps([s], [truth], [truth], cfg)) == 0.0
