"""The PCG's start: a warm start far worse than none is dropped
(``btridiag.warm_start``) and a large initial residual is scaled by a power
of two (``btridiag.residual_scale``), on the three PCG routes (K4, its plain
version, ``btridiag.pcg``); the totals ``pcg/iters`` and ``pcg/scenarios``;
K4's operation count for the benchmark's ``k4_roofline``.

CPU tests at small sizes; the plain reference is
``benchmark/reference/sqp_pcg_guard.py`` (and its ``pcg.py``), in float64.
Card tests (``-m card``) hold K4 to the same:

    python -m pytest --noconftest -o addopts= -m card tests/test_torch_pcg_range.py
"""

import collections
import json
import pathlib
import shutil
import sys
import traceback
import warnings

import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu_torch import flagship as F
from trajoptmpcreference_tpu_torch.ops import btridiag as BT
from trajoptmpcreference_tpu_torch.ops import fused_pcg as FP
from trajoptmpcreference_tpu_torch.utils import spans

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

N, BS, B = 8, 12, 4
ITERS, TOL = 40, 1e-4


@pytest.fixture
def fresh():
    spans.enable(False)
    spans.reset()
    try:
        yield
    finally:
        spans.reset()


def _system(seed, dtype=torch.float32, device="cpu"):
    """B symmetric negative-definite block-tridiagonal systems (the Schur
    systems' sign) with N = 8, bs = 12, and the solution of each."""
    g = torch.Generator().manual_seed(seed)
    M = torch.randn(B, N, BS, BS, generator=g, dtype=torch.float64)
    diag = -(M @ M.transpose(-1, -2) + 2.0 * BS * torch.eye(BS, dtype=torch.float64))
    upper = 0.6 * torch.randn(B, N - 1, BS, BS, generator=g, dtype=torch.float64)
    x_star = torch.randn(B, N, BS, generator=g, dtype=torch.float64)
    S = BT.BlockTridiag(diag, upper)
    t = lambda a: a.to(dtype=dtype, device=device)
    return BT.BlockTridiag(t(diag), t(upper)), t(BT.btd_matvec(S, x_star)), t(x_star)


def _fused(S, gam, guess, tol=TOL, iters=ITERS, relative=True):
    return FP.make_batched_pcg(N, BS, "SS", tol=tol, max_iter=iters,
                               relative=relative)(S, gam, guess)


def _btridiag(S, gam, guess, tol=TOL, iters=ITERS, relative=True):
    res = BT.pcg(S, gam, BT.preconditioner(S, "SS"), guess=guess,
                 exit_tolerance=tol, max_iter=iters, relative=relative)
    return res.x, res.iters.to(torch.int32)


ROUTES = {"fused": _fused, "btridiag": _btridiag}


def _reference(S, gam, guess, tol, iters):
    """The benchmark's plain reference: dense S, float64, the port's rule."""
    from reference import sqp_pcg_guard
    d = lambda a: a.double().reshape(B, N * BS)
    dense = BT.btd_dense(BT.BlockTridiag(S.diag.double(), S.upper.double()))
    return sqp_pcg_guard.solve(dense, d(gam), d(guess), N, BS, iters,
                               tol).reshape(B, N, BS)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kept", [False, True])
def test_huge_warm_start_gives_a_finite_answer(route, kept):
    """float32, a warm start of size 1e20 (``kept``: the solution of size
    1e20 with a 1e-1 relative error, which the rule keeps and whose
    residual, past 1e20, puts nu past float32's range unscaled; else an
    unrelated one, which it drops), solved to a relative 1e-10 in at most
    100 iterations: a finite answer that agrees with the float64 reference
    to 1e-5 of max|x| (float32's 6e-8 times these systems' conditions,
    ~1e2)."""
    S, gam, x_star = _system(seed=7)
    g = torch.Generator().manual_seed(8)
    noise = torch.randn(x_star.shape, generator=g)
    if kept:
        x_star = 1e20 * x_star
        gam = 1e20 * gam
        guess = x_star * (1 + 1e-1 * noise)
    else:
        guess = 1e20 * noise
    x, _ = ROUTES[route](S, gam, guess, tol=1e-10, iters=100)
    assert torch.isfinite(x).all()
    ref = _reference(S, gam, guess, tol=1e-10, iters=100)
    assert float((x.double() - ref).abs().max() / ref.abs().max()) < 1e-5
    # the unscaled formulation overflows on the kept guess
    if kept:
        r0 = gam - BT.btd_matvec(S, guess)
        P = BT.preconditioner(S, "SS")
        assert not torch.isfinite(BT._dot(r0, BT.btd_matvec(P, r0))).all()


def _unscaled(monkeypatch):
    """The formulation without the scaling: c = 1 for every scenario."""
    monkeypatch.setattr(BT, "pow2_scale", torch.ones_like)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("size,relative", [(1.0, True), (2.0 ** 50, True),
                                           (2.0 ** 50, False)])
def test_scaled_iterates_are_the_unscaled_ones_bit_for_bit(route, dtype, size,
                                                          relative,
                                                          monkeypatch):
    """From ordinary guesses (c = 1) and from guesses whose residual is
    ~2**48 (c ~ 2**-49; unscaled, nu stays finite): the answers and
    iteration counts equal those of the formulation without the scaling,
    under the relative exit and under the absolute one (which runs
    unscaled: scaled, its fixed threshold would stop c^-2 too early)."""
    S, gam, x_star = _system(seed=11, dtype=dtype)
    g = torch.Generator().manual_seed(12)
    guess = size * x_star * (1 + 1e-2 * torch.randn(x_star.shape, generator=g,
                                                     dtype=dtype))
    gam = size * gam
    r0 = gam - BT.btd_matvec(S, guess)
    c = BT.residual_scale(r0)
    assert bool((c == 1).all()) == (size == 1.0)
    x, it = ROUTES[route](S, gam, guess, relative=relative)
    with monkeypatch.context() as m:
        _unscaled(m)
        x0, it0 = ROUTES[route](S, gam, guess, relative=relative)
    assert torch.isfinite(x0).all()
    assert torch.equal(x, x0) and torch.equal(it, it0)


def test_residual_scale_is_an_exact_power_of_two():
    r = torch.tensor([[[0.0, 3.0]], [[2.0 ** 32, 1.0]], [[-3.0 * 2.0 ** 40, 0.5]],
                      [[3.0e38, 0.0]], [[float("nan"), 1e40]],
                      [[float("-inf"), 1.0]]], dtype=torch.float32)
    c = BT.residual_scale(r)
    assert c[:2].tolist() == [1.0, 1.0]
    assert c[2].item() == 2.0 ** -42                      # 3 2**40 = 0.75 2**42
    assert c[3].item() == 2.0 ** -128                     # 3e38 = 0.88 2**128
    assert c[4:].tolist() == [1.0, 1.0]                   # not finite: unscaled
    big = r[2:4].abs().amax((-1, -2)) * c[2:4]
    assert ((big >= 0.5) & (big < 1)).all()
    d = BT.residual_scale(r.double() * 2.0 ** 600)
    assert d[2].item() == 2.0 ** -642


@pytest.mark.parametrize("route", ROUTES)
def test_a_warm_start_far_worse_than_none_starts_from_zero(route):
    """A guess whose |nu_0| is over 2**40 times the zero start's gives the
    zero start's answer exactly; a worse guess below that is kept."""
    S, gam, x_star = _system(seed=13)
    zero, it_zero = ROUTES[route](S, gam, torch.zeros_like(gam))
    bad = 1e8 * (x_star + 1.0)
    assert torch.equal(ROUTES[route](S, gam, bad)[0], zero)
    worse = -3.0 * x_star                       # 16x the zero start's nu
    x, _ = ROUTES[route](S, gam, worse)
    assert not torch.equal(x, zero)


def test_fused_route_counts_iterations_on_the_device(fresh, monkeypatch):
    """``pcg/iters`` is the sum of the returned iterations and
    ``pcg/scenarios`` the scenarios solved, over calls; the host reads of a
    solve are those of the formulation before the rule, the scaling and
    the totals (the plain version's per-iteration check alone)."""
    S, gam, x_star = _system(seed=17)
    total = 0
    for k in range(3):
        _, it = _fused(S, gam, 0.5 * k * x_star)
        total += int(it.sum())
    assert spans.count("pcg/iters") == total
    assert spans.count("pcg/scenarios") == 3 * B
    assert spans.snapshot()["counts"]["pcg/iters"] == total
    reads = {k: n for k, n in spans.snapshot()["counts"].items()
             if k.startswith("sync/")}
    spans.reset()
    keep = lambda b, guess, matvec, apply_P: (
        guess, b - matvec(guess), torch.ones_like(b[..., 0, 0]))
    monkeypatch.setattr(FP, "warm_start", keep)
    _unscaled(monkeypatch)
    monkeypatch.setattr(spans, "tally", lambda key, value: None)
    for k in range(3):
        _fused(S, gam, 0.5 * k * x_star)
    assert {k: n for k, n in spans.snapshot()["counts"].items()
            if k.startswith("sync/")} == reads
    spans.reset()
    assert spans.snapshot() == {"spans": {}, "counts": {}}


@pytest.fixture
def one_thread():
    """One intra-op thread: the loop's small ops and the reference's dense
    products gain nothing from more, and the suite's workers share the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_closed_loop_with_a_planted_huge_warm_start(fresh, one_thread):
    """The port's PCG-SS MPC (PCG_KNOBS through the fused route) at B = 8,
    N = 16, float32, 20 steps, one scenario's carried multipliers replaced
    by 1e20-sized ones before step 5: every output of every step finite;
    against the plain reference from each step's own inputs, on half the
    scenarios (the planted one among them; the reference's dense solve sets
    this test's time), each step's next states within ``x1_rel_max`` and
    the 20 steps within each of the cell's limits."""
    from benchlib import correct
    from benchlib.loop import ClosedLoop, Sample, runaway
    cfg = json.loads((BENCH / "configs" / "arm6_pcg_guard.json").read_text())
    limits = json.loads((BENCH / "limits" / "arm6_pcg.b512.json").read_text())
    cfg["horizon"] = 16
    for k in ("knobs", "cold_knobs"):
        cfg[k]["N"] = 16
    tr = json.loads((BENCH / "traffic" / "b512.json").read_text())
    tr["batch"] = 8
    loop = ClosedLoop(cfg, tr, 2_718_281_828, "cpu")
    rows = torch.tensor([1, 3, 5, 7])
    pick = lambda t: None if t is None else t[rows]
    samples, flags = [], []
    for k in range(20):
        if k == 5:
            g = torch.Generator().manual_seed(5)
            lam = loop.carry["lam_init"].clone()
            lam[3] = 1e20 * torch.randn(lam[3].shape, generator=g)
            loop.carry["lam_init"] = lam
        inputs = dict(x=loop.x, **loop.carry)
        res, _ = loop.step()
        out = (res.X_plan_last, res.U_plan_last, res.lam_last,
               res.U_applied[..., 0], res.X_applied[..., -1])
        assert all(torch.isfinite(t).all() for t in out), k
        samples.append(Sample(0, k, k == 0, rows, pick(inputs["x"]),
                              pick(loop.goals), pick(inputs.get("X_init")),
                              pick(inputs.get("U_init")),
                              pick(inputs.get("lam_init")), None,
                              *(pick(t) for t in out)))
        flags.append(runaway(inputs["x"], cfg))
    truth = correct.reference_answers(samples, cfg, torch.float64, "cpu")
    g = correct.gaps(samples, correct.program_answers(samples), truth, cfg,
                     flags)
    steps = np.repeat(np.arange(20), len(rows))
    for k in range(20):
        assert g["x1"][steps == k].max() <= limits["numbers"]["x1_rel_max"]
        assert g["nonfinite"][steps == k].max() == 0
    for name, v in correct.judge(g, limits).items():
        assert v["value"] <= v["limit"], (name, v)


@pytest.mark.parametrize("N_, bs, Bn", [(5, 3, 3), (8, 4, 4), (64, 12, 2)])
def test_k4_count_is_the_counters(N_, bs, Bn):
    """benchmark/benchlib/k4_count.needed_ops, summed over a call's
    scenarios at each one's iterations, equals what
    kernels/opcount.count_needed_pcg counts (needs g++), for scenarios that
    leave on their threshold and for those that run out of iterations;
    bytes_moved at the flagship's call is PERF.md's 42,469,376 B."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build kernels/needed_ops.cpp")
    from benchlib import k4_count

    from trajoptmpcreference_tpu_torch.kernels import opcount
    g = torch.Generator().manual_seed(N_)
    M = torch.randn(Bn, N_, bs, bs, generator=g, dtype=torch.float64)
    S = BT.BlockTridiag(M @ M.transpose(-1, -2) + 2 * bs * torch.eye(bs, dtype=torch.float64),
                        0.6 * torch.randn(Bn, N_ - 1, bs, bs, generator=g,
                                          dtype=torch.float64))
    r0 = torch.randn(Bn, N_, bs, generator=g, dtype=torch.float64)
    ops = FP.pack_operands(S, r0, "SS")
    # every scenario leaves on its threshold before 40 iterations; none
    # reaches a relative 1e-30 in 2
    for max_iter, tol, exited in ((40, 1e-8, True), (2, 1e-30, False)):
        kw = dict(ss=True, relative=True, max_iter=max_iter, tol=tol)
        _, it = FP.pcg_fused_plain(*ops, precond="SS", tol=tol,
                                   max_iter=max_iter, relative=True)
        assert bool((it < max_iter).all()) == exited
        want = opcount.count_needed_pcg(*(a.numpy() for a in ops), **kw)
        got = sum(k4_count.needed_ops(N_, bs, int(i), exited=exited)
                  for i in it)
        assert got == want, (max_iter, it.tolist())
        # at the mean iterations, counted as leaving on the threshold, the
        # count is at most the call's
        mean = float(it.double().mean())
        assert Bn * k4_count.needed_ops(N_, bs, mean) <= want
    assert k4_count.bytes_moved(512, 64, 12, 4) == 42_469_376


def test_k4_readers_read_the_totals_and_the_trace(fresh):
    """k4_roofline and pcg.iters_per_call on a synthetic traced stretch:
    nothing without the port's totals, else the count over the time."""
    from benchlib import k4_count, manifest

    class Op:
        def __init__(self, name, seconds):
            self.name, self.seconds = name, seconds

    peaks = manifest.load_json(BENCH / "peaks.json")
    cell = type("C", (), {"config": json.loads(
        (BENCH / "configs" / "arm6_pcg_guard.json").read_text()),
        "traffic": {"batch": 512}})
    ops = [Op("void tmr_pcg::pcg_regs<float, 12>(tmr_pcg::Args<float>)", 3e-4),
           Op("void tmr::fd::fd_kernel<float, 6>(float const*)", 1e-4)] * 3
    run = type("R", (), {"stretch": type("S", (), {"ops": ops, "steps": 2}),
                         "cell": cell, "peaks": peaks})
    read = lambda name: manifest.load_reader(BENCH / "metrics" / f"{name}.py")(run)
    assert read("pcg.iters_per_call") is None
    assert read("k4_roofline") is None
    assert read("k4.device_ms_per_step") == pytest.approx(0.45)
    spans.tally("pcg/iters", torch.tensor([38, 39], dtype=torch.int32))
    spans.tally("pcg/scenarios", 2)
    assert read("pcg.iters_per_call") == 38.5
    bound = k4_count.bound_s(512, 64, 12, 38.5, 4, peaks)
    assert read("k4_roofline") == pytest.approx(100 * bound / 3e-4)
    assert 0 < read("k4_roofline") < 100


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("size,relative", [(1.0, True), (2.0 ** 50, True),
                                           (2.0 ** 50, False)])
def test_card_k4_scaled_equals_unscaled(card, size, relative, fresh,
                                        monkeypatch):
    """K4 at B = 512, N = 64, bs = 12 in float32 on the flagship's Schur
    systems' sign: from ordinary guesses and from guesses whose residual
    is ~2**40, answers and iteration counts equal the unscaled
    formulation's, under the relative exit and under the absolute one;
    ``pcg/iters`` is the sum of the returned iterations."""
    g = torch.Generator().manual_seed(21)
    Bn, Nn, bs = 512, 64, 12
    M = torch.randn(Bn, Nn, bs, bs, generator=g, dtype=torch.float64)
    diag = -(M @ M.transpose(-1, -2) + 2.0 * bs * torch.eye(bs, dtype=torch.float64))
    upper = 0.6 * torch.randn(Bn, Nn - 1, bs, bs, generator=g, dtype=torch.float64)
    x_star = torch.randn(Bn, Nn, bs, generator=g, dtype=torch.float64)
    S64 = BT.BlockTridiag(diag, upper)
    gam = size * BT.btd_matvec(S64, x_star)
    guess = size * x_star * (1 + 1e-2 * torch.randn(x_star.shape, generator=g,
                                                     dtype=torch.float64))
    t = lambda a: a.to(dtype=torch.float32, device=card)
    S, gam, guess = BT.BlockTridiag(t(diag), t(upper)), t(gam), t(guess)
    solve = FP.make_batched_pcg(Nn, bs, "SS", tol=TOL, max_iter=ITERS,
                                relative=relative)
    x, it = solve(S, gam, guess)
    assert spans.count("pcg/iters") == int(it.sum())
    assert spans.count("pcg/scenarios") == Bn
    with monkeypatch.context() as m:
        _unscaled(m)
        x0, it0 = solve(S, gam, guess)
    assert torch.isfinite(x0).all()
    assert torch.equal(x, x0) and torch.equal(it, it0)


@pytest.mark.card
def test_card_pcg_step_syncs_are_the_ports_host_reads(card, fresh):
    """Five steady PCG-SS flagship steps through K4 at B = 512 under torch's
    sync debug mode: every synchronizing call is one of the port's counted
    host reads or the step's copy of the applied control; the rule, the
    scaling and the device totals add none."""
    _, cost, ctrl = F.flagship_mpc(dtype=torch.float32, device=card,
                                   use_kernel_pcg=True, **F.PCG_KNOBS)
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

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    spans.reset()
    syncs = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            syncs.append([f"{f.filename}:{f.lineno} {f.name}"
                          for f in traceback.extract_stack()[:-1]
                          if "site-packages" not in f.filename
                          and not f.filename.endswith("warnings.py")][-3:])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(5):
                step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counts = spans.snapshot()["counts"]
    reads = sum(n for k, n in counts.items() if k.startswith("sync/"))
    sites = collections.Counter(where[-1] for where in syncs)
    assert len(syncs) == reads + 5, sites
    assert counts["pcg/scenarios"] > 0
    assert 0 < counts["pcg/iters"] / counts["pcg/scenarios"] <= ITERS
    assert np.isfinite(counts["pcg/iters"])


def test_host_spans_reports_k4_calls_and_iterations():
    """tools/host_spans.per_step on a synthetic snapshot of two steps with
    six K4 calls: calls per step from ``fused_pcg.launch``, iterations per
    scenario per call from the totals; none without them."""
    import importlib.util
    path = ROOT / "tools" / "host_spans.py"
    spec = importlib.util.spec_from_file_location("host_spans", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    span = lambda calls: {"calls": calls, "ns": 10 ** 6, "self_ns": 10 ** 6}
    snap = {"spans": {"MPCController.run": span(2),
                      "KKTSystem.solve_schur": span(6),
                      "fused_pcg.launch": span(6)},
            "counts": {"pcg/iters": 6 * 512 * 37, "pcg/scenarios": 6 * 512}}
    out = tool.per_step(snap)
    assert out["pcg.calls_per_step"] == 3
    assert out["pcg.iters_per_call"] == 37
    del snap["spans"]["fused_pcg.launch"], snap["counts"]["pcg/scenarios"]
    out = tool.per_step(snap)
    assert out["pcg.calls_per_step"] == 0 and out["pcg.iters_per_call"] is None
