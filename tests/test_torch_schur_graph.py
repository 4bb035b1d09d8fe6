"""The exact Schur solve as one CUDA graph per shape
(``KKTSystem._solve_exact_graphed``) and its ``graph/<site>`` counts.

CPU tests on the flagship arm at a small size (f64, N = 8, B = 3): CPU
tensors and the PCG route never capture, the graph key, the counts, the
guard, and the life cycle of a key with a stand-in for the capture.  Card
tests (``-m card``) hold the graph to the eager solve bit for bit at the
flagship's shapes (N = 64, f32) and count captures and replays in a
closed loop:

    python -m pytest --noconftest -o addopts= -m card tests/test_torch_schur_graph.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu_torch import flagship as F
from trajoptmpcreference_tpu_torch.solvers import kkt as K
from trajoptmpcreference_tpu_torch.solvers.kkt import KKTSystem
from trajoptmpcreference_tpu_torch.solvers.sqp import knot_params
from trajoptmpcreference_tpu_torch.utils import spans

# the three assemblies, with the exact solver of each card case; the
# generic one takes soft joint limits besides (soft rows on x and on u are
# not separable), as FULL_SET's +-row pairs make a singular system
ROUTES = {
    "split_cr": dict(exact_schur="cr"),
    "split_thomas": dict(exact_schur="thomas"),
    "condensed_cr": dict(exact_schur="cr", torque_limit=6.0,
                         torque_mode="ACTIVE_SET", max_iter=4),
    "generic_cr": dict(exact_schur="cr", torque_limit=6.0,
                       torque_mode="ACTIVE_SET+AL"),
}
BRANCH = {"split_cr": "split", "split_thomas": "split",
          "condensed_cr": "condensed", "generic_cr": "generic"}


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


def _system(route, B=3, N=8, device="cpu", dtype=torch.float64, seed=0):
    """(KKTSystem, blocks, rho) of the flagship at a random plan."""
    _, cost, solver = F.flagship(N=N, dtype=dtype, device=device,
                                 **ROUTES[route])
    kkt = solver.kkt
    if route == "generic_cr":
        kkt = dataclasses.replace(kkt, cset=kkt.cset.with_joint_limits(
            0.15, -0.15, "AUGMENTED_LAGRANGIAN"))
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    X = t(0.3 * rng.standard_normal((B, 12, N)))
    U = t(0.3 * rng.standard_normal((B, 6, N - 1)))
    xs = X[:, :, 0] + t(0.01 * rng.standard_normal((B, 12)))
    goals = F.bench_scenarios(B, seed=seed)[1]
    params = cost.default_params._replace(xg=t(goals))
    cstate = kkt.cset.init_state(dtype, device, (B,))
    blocks = kkt.form_blocks(X, U, xs, knot_params(params), cstate)
    rho = t(10 ** rng.uniform(-3, -1, B))
    return kkt, blocks, rho


def _graph_counts():
    return {k: n for k, n in spans.snapshot()["counts"].items()
            if k.startswith("graph/")}


# ------------------------------------------------------------- CPU tests
@pytest.mark.parametrize("use_pcg", [False, True], ids=["exact", "pcg"])
@pytest.mark.parametrize("route", ["split_cr", "condensed_cr", "generic_cr"])
def test_cpu_and_pcg_never_capture(fresh, route, use_pcg):
    kkt, blocks, rho = _system(route)
    assert kkt._branch() == BRANCH[route]
    spans.enable(True)
    kw = dict(use_pcg=True, pcg_tol=1e-12, pcg_max_iter=400) if use_pcg else {}
    outs = [kkt.solve_schur(blocks, rho, **kw) for _ in range(3)]
    assert _graph_counts() == {}
    assert len(kkt._graphs) == 0
    calls = {n: s["calls"] for n, s in spans.snapshot()["spans"].items()}
    for name in ("KKTSystem.schur_blocks", "btridiag.solve",
                 "KKTSystem.recover_dxu"):
        assert calls[name] == 3, name
    if not use_pcg:
        dxu, lam = kkt._solve_exact(blocks, rho)
        assert torch.isfinite(dxu).all() and torch.isfinite(lam).all()
        for d, l, _ in outs:
            assert torch.equal(d, dxu) and torch.equal(l, lam)


def test_cpu_closed_loop_never_captures(fresh):
    _, cost, ctrl = F.flagship_mpc(N=8, dtype=torch.float64, device="cpu")
    x0s, goals = F.bench_scenarios(3, seed=3)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    ctrl.run(t(x0s), 2, cost_params=cost.default_params._replace(xg=t(goals)))
    assert _graph_counts() == {}
    assert len(ctrl.solver.kkt._graphs) == 0


def _key_cases():
    """(name, key of a base call, key of a call that must differ)."""
    kkt, blocks, rho = _system("split_cr")
    base = kkt._graph_key(blocks, rho)
    thomas, _, _ = _system("split_thomas")
    cond, cblocks, crho = _system("condensed_cr")
    gen, gblocks, grho = _system("generic_cr")
    _, b4, rho4 = _system("split_cr", B=4)
    b32 = blocks._replace(**{f: getattr(blocks, f).float()
                             for f in ("H", "g", "A", "B", "defect")})
    contig = blocks._replace(A=blocks.A.contiguous())
    return base, {
        "branch_condensed": cond._graph_key(cblocks, crho),
        "branch_generic": gen._graph_key(gblocks, grho),
        "exact_schur": thomas._graph_key(blocks, rho),
        "shape": kkt._graph_key(b4, rho4),
        "rho_shape": kkt._graph_key(blocks, rho[:1]),
        "dtype": kkt._graph_key(b32, rho.float()),
        "strides": kkt._graph_key(contig, rho),
    }


@pytest.mark.parametrize("case", ["branch_condensed", "branch_generic",
                                  "exact_schur", "shape", "rho_shape",
                                  "dtype", "strides"])
def test_graph_key_separates(case):
    base, others = _key_cases()
    assert others[case] != base
    assert len(set(others.values()) | {base}) == len(others) + 1


def test_graph_key_equal_for_the_same_layout():
    """Two calls with other values on the same shapes, dtypes and strides
    share a key, and the key ignores the fields the split path does not
    read."""
    kkt, blocks, rho = _system("split_cr", seed=0)
    _, blocks2, rho2 = _system("split_cr", seed=1)
    assert kkt._graph_key(blocks, rho) == kkt._graph_key(blocks2, rho2)
    padded = blocks._replace(hval=torch.zeros(3, 8, 5))
    assert kkt._graph_key(padded, rho) == kkt._graph_key(blocks, rho)
    # a condensed system reads the hard rows: their layout is in its key
    cond, cb, crho = _system("condensed_cr")
    wider = cb._replace(hjac=cb.hjac.transpose(-1, -2).contiguous()
                        .transpose(-1, -2))
    assert cond._graph_key(wider, crho) != cond._graph_key(cb, crho)


@pytest.mark.parametrize("tracing", [False, True], ids=["off", "on"])
def test_spans_carry_the_graph_kind(fresh, tracing):
    spans.enable(tracing)
    with spans.graphed("solve_schur.capture"):
        pass
    for _ in range(3):
        with spans.graphed("solve_schur.replay"):
            pass
    assert spans.count("graph/solve_schur.capture") == 1
    assert spans.count("graph/solve_schur.replay") == 3
    assert spans.count("graph/other") == 0
    snap = spans.snapshot()
    assert snap["counts"] == {"graph/solve_schur.capture": 1,
                              "graph/solve_schur.replay": 3}
    if tracing:
        assert snap["spans"]["graph/solve_schur.replay"]["calls"] == 3
    else:
        assert snap["spans"] == {}
        assert spans.graphed("x") is spans.OFF
    spans.reset()
    assert spans.count("graph/solve_schur.replay") == 0
    assert spans.snapshot() == {"spans": {}, "counts": {}}


def test_guard_raises_on_a_hand_kernel_launch(fresh):
    with K._no_hand_kernels("site"):
        spans.host_bool(torch.tensor(True), "x")     # reads are not launches
    with pytest.raises(RuntimeError, match="launch/fd"):
        with K._no_hand_kernels("site"):
            spans.launched("fd")


class _StandInGraph:
    """A CPU stand-in for a captured graph: ``replay`` runs the exact
    solve on the static inputs into the static outputs."""

    def __init__(self, kkt, static, rho, out):
        self.kkt, self.static, self.rho, self.out = kkt, static, rho, out

    def replay(self):
        dxu, lam = self.kkt._solve_exact(self.static, self.rho)
        self.out[0].copy_(dxu)
        self.out[1].copy_(lam)


def _stand_in_capture(self, blocks, fields, srcs):
    inputs = tuple(t.clone() for t in srcs)
    static = blocks._replace(**dict(zip(fields, inputs)))
    out = self._solve_exact(static, inputs[-1])
    return _StandInGraph(self, static, inputs[-1], out), inputs, out


@pytest.mark.parametrize("route", ["split_cr", "condensed_cr"])
def test_life_cycle_of_a_key(fresh, monkeypatch, route):
    """Eager first call, capture and replay on the second, replay after;
    the results equal the eager solve's and never alias the graph's
    buffers; the oldest keys are dropped past ``_GRAPH_KEYS``."""
    monkeypatch.setattr(KKTSystem, "_capture", _stand_in_capture)
    kkt, blocks, rho = _system(route, seed=0)
    _, blocks2, rho2 = _system(route, seed=1)
    ref1 = kkt._solve_exact(blocks, rho)
    ref2 = kkt._solve_exact(blocks2, rho2)
    out = kkt._solve_exact_graphed(blocks, rho)
    assert _graph_counts() == {}
    key = kkt._graph_key(blocks, rho)
    assert list(kkt._graphs) == [key] and kkt._graphs[key] is None
    outs = [out, kkt._solve_exact_graphed(blocks, rho)]
    assert _graph_counts() == {"graph/solve_schur.capture": 1,
                               "graph/solve_schur.replay": 1}
    outs.append(kkt._solve_exact_graphed(blocks2, rho2))
    assert spans.count("graph/solve_schur.replay") == 2
    for (d, l), (rd, rl) in zip(outs, [ref1, ref1, ref2]):
        assert torch.equal(d, rd) and torch.equal(l, rl)
    _, _, (sd, sl) = kkt._graphs[key]
    for d, l in outs:
        assert d.data_ptr() != sd.data_ptr() and l.data_ptr() != sl.data_ptr()
    # the capture's lam survives the replay of other inputs
    assert torch.equal(outs[1][1], ref1[1])
    # new batch sizes push the oldest key out
    for B in range(4, 4 + K._GRAPH_KEYS):
        _, b, r = _system(route, B=B)
        kkt._solve_exact_graphed(b, r)
    assert len(kkt._graphs) == K._GRAPH_KEYS and key not in kkt._graphs


@pytest.mark.parametrize("route,width", [("split_cr", 12),
                                         ("condensed_cr", 12),
                                         ("generic_cr", 24)])
def test_widest_lu_sets_where_the_graph_engages(route, width):
    """The flagship's split and condensed solves factor 12-wide blocks and
    are graphed on the card; its generic solve factors the 24-wide Schur
    blocks (nx + m), which a capture refuses, and stays eager."""
    kkt, _, _ = _system(route)
    assert kkt._widest_lu() == width
    assert (width <= K._GRAPH_LU_MAX) == (route != "generic_cr")


# ------------------------------------------------------------ card tests
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _max_rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.card
@pytest.mark.parametrize("B", [512, 1])
@pytest.mark.parametrize("route", list(ROUTES))
def test_card_graph_equals_eager_bit_for_bit(fresh, card, route, B):
    """The eager call, the capture and two replays on new inputs each
    equal ``_solve_exact`` on the same inputs, bit for bit (N = 64, f32);
    the generic route runs eagerly and captures nothing."""
    kkt, blocks, rho = _system(route, B=B, N=64, device=card,
                               dtype=torch.float32, seed=0)
    inputs = [(blocks, rho)] + [_system(route, B=B, N=64, device=card,
                                        dtype=torch.float32, seed=s)[1:]
                                for s in (1, 2, 3)]
    refs = [kkt._solve_exact(b, r) for b, r in inputs]
    outs = [kkt.solve_schur(b, r)[:2] for b, r in inputs]
    rel = [max(_max_rel(d, rd), _max_rel(l, rl))
           for (d, l), (rd, rl) in zip(outs, refs)]
    print(f"[graph] {route} B={B}: counts {_graph_counts()}; max rel. "
          f"difference per call {rel}")
    # the generic route's 24-wide blocks stay eager
    graphed = route != "generic_cr"
    assert spans.count("graph/solve_schur.capture") == int(graphed)
    assert spans.count("graph/solve_schur.replay") == 3 * int(graphed)
    for (d, l), (rd, rl) in zip(outs, refs):
        assert torch.equal(d, rd) and torch.equal(l, rl)


@pytest.mark.card
def test_card_returned_lam_does_not_alias(fresh, card):
    kkt, blocks, rho = _system("split_cr", B=512, N=64, device=card,
                               dtype=torch.float32, seed=0)
    _, blocks2, rho2 = _system("split_cr", B=512, N=64, device=card,
                               dtype=torch.float32, seed=1)
    kkt.solve_schur(blocks, rho)                       # eager
    _, lam1, _ = kkt.solve_schur(blocks, rho)          # capture and replay
    kept = lam1.clone()
    _, lam2, _ = kkt.solve_schur(blocks2, rho2)        # replay
    assert torch.equal(lam1, kept) and not torch.equal(lam1, lam2)
    _, lam3, _ = kkt.solve_schur(blocks2, rho2)
    assert torch.equal(lam1, kept) and torch.equal(lam2, lam3)


@pytest.mark.card
def test_card_closed_loop_counts(fresh, card):
    """Five steps as the benchmark runs them (the cold controller first,
    block-Thomas; then the steady one, cyclic reduction) at B = 512: two
    captures, and a replay for every exact solve but the two eager first
    calls."""
    kw = dict(dtype=torch.float32, device=card)
    _, cost, ctrl = F.flagship_mpc(**kw)
    _, _, cold = F.flagship_mpc(max_iter=4, exact_schur="thomas",
                                alpha_min=0.005, alpha_factor=0.5, **kw)
    x0s, goals = F.bench_scenarios(512, seed=3)
    x = torch.as_tensor(x0s, dtype=torch.float32, device=card)
    params = cost.default_params._replace(
        xg=torch.as_tensor(goals, dtype=torch.float32, device=card))
    spans.enable(True)
    carry = {}
    for k in range(5):
        res = (cold if k == 0 else ctrl).run(x, 1, cost_params=params, **carry)
        res.U_applied[..., 0].cpu()
        carry = dict(X_init=res.X_plan_last, U_init=res.U_plan_last,
                     cstate_init=res.cstate_last, lam_init=res.lam_last)
        x = res.X_applied[..., -1]
    exact = spans.snapshot()["spans"]["KKTSystem.solve_schur"]["calls"]
    print(f"[graph] 5 steps: {exact} exact solves, counts {_graph_counts()}")
    assert spans.count("graph/solve_schur.capture") == 2
    assert spans.count("graph/solve_schur.replay") == exact - 2
    assert torch.isfinite(res.X_plan_last).all()


@pytest.mark.card
def test_card_guard_raises_on_a_captured_launch(fresh, card, monkeypatch):
    kkt, blocks, rho = _system("split_cr", B=8, N=64, device=card,
                               dtype=torch.float32)
    exact = KKTSystem._solve_exact

    def launching(self, b, r):
        spans.launched("fd")
        return exact(self, b, r)

    monkeypatch.setattr(KKTSystem, "_solve_exact", launching)
    kkt.solve_schur(blocks, rho)                       # eager: counted
    with pytest.raises(RuntimeError, match="launch/fd"):
        kkt.solve_schur(blocks, rho)
