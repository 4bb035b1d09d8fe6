"""The CUDA kernels' arithmetic, compiled as plain C++ and run on the CPU.

kernels/csrc/*.cu guard their CUDA launch code with __CUDACC__; without it
each file compiles with g++ into a host loop (over lanes, or over scenarios
with one serial "thread" per block) that runs the very same device
functions.  This checks K1 / K2 / K3's recursions against the port's plain
PyTorch versions in f64 (atol 1e-9 on values up to ~1e3: the same
recursions, sums reassociated) on serial arms of 1..7 joints, a branched
tree and a prismatic joint; and K4's PCG against ``pcg_fused_plain`` in
f64 (1e-10 of the solution's scale, equal iteration counts: the same loop,
reductions in another order).  K1 and K2 run as a thread group per lane:
their host builds run each phase for the group's G threads in turn, once
in order and once in reverse (a phase in which one thread read what
another wrote would give another answer), over whole blocks of lanes with
a ragged tail.  K3 runs one thread per lane: its host build runs each
block's lanes in order and in reverse, over every robot shape (the
branched tree with the end effector on each leaf) at 1e-12 in f64.  K4
spreads the rows of S over a block's threads: its host
build runs each phase for the block's threads in turn, in order and in
reverse, for each block size it is built for, for a cluster of one block
(any other block size, or more rows than the register variant takes),
for N = 1 and ragged N.  The shared-memory sizes come from the
kernels' own formulas,
which the wrappers read from the libraries; K4's accepts every shape the
first design's did.  The functions behind chip_smoke.py's bounds
(kernels/needed_ops.cpp: K1-K4 once more, each value computed once) are
held to the plain versions too, and the operation counts
(kernels/opcount.py) to the loops' structure.  It does not check that the
kernels build with nvcc or launch: chip_smoke.py does that on the card."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_prismatic import _RPR_URDF
from trajoptmpcreference_tpu_torch.kernels import _build, opcount
from trajoptmpcreference_tpu_torch.models.urdf import parse_urdf, serial_arm
from trajoptmpcreference_tpu_torch.ops import btridiag as tbtd
from trajoptmpcreference_tpu_torch.ops import fused_pcg as FP
from trajoptmpcreference_tpu_torch.ops import lanes
from trajoptmpcreference_tpu_torch.ops.kinematics import LaneKinematics

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

_YTREE = """<?xml version="1.0"?><robot name="ytree"><link name="base"/>
{joints}</robot>"""


def _ytree(tmp_path):
    inertial = ('<inertial><origin rpy="0.3 0 0" xyz="0 0.5 0.1"/>'
                '<mass value="0.2"/><inertia ixx="0.008" ixy="0" ixz="0" '
                'iyy="0.006" iyz="0" izz="0.0001"/></inertial>')
    joints = ""
    for name, p, c, ax in (("j0", "base", "l1", "0 0 1"),
                           ("jA", "l1", "lA", "1 0 0"),
                           ("jA2", "lA", "lA2", "0 0 1"),
                           ("jB", "l1", "lB", "0 1 0")):
        joints += (f'<joint name="{name}" type="revolute"><parent link="{p}"/>'
                   f'<child link="{c}"/><origin rpy="0.1 0.2 0" xyz="0 1 0"/>'
                   f'<axis xyz="{ax}"/><dynamics damping="0.05"/></joint>'
                   f'<link name="{c}">{inertial}</link>')
    path = tmp_path / "ytree.urdf"
    path.write_text(_YTREE.format(joints=joints))
    return parse_urdf(str(path))


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("host_kernels")
    libs = {}
    procs = {}
    # each kernel a second time: K1's, K2's and K4's groups' threads, and
    # K3's lanes within a block, in reverse order; and the functions as
    # counted for the bounds
    builds = [(name, _build.CSRC / f"{name}.cu", []) for name in _build.LIBRARIES]
    for name in ("fd", "fd_grad", "task_vec", "pcg"):
        builds.append((f"{name}_reversed", _build.CSRC / f"{name}.cu",
                       ["-DTMR_GROUP_REVERSE_TIDS"]))
    builds.append(("needed", opcount.NEEDED, []))
    for key, src, flags in builds:
        so = out / f"lib{key}.so"
        procs[key] = (subprocess.Popen(
            ["g++", "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
             *flags, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(so))
        if key == "needed":
            for name in ("fd", "fd_grad", "task_vec"):
                fn = getattr(lib, f"need_{name}_f64")
                fn.argtypes = _build.ARGTYPES[name]
                fn.restype = ctypes.c_int
                libs[f"needed_{name}"] = fn
            lib.need_pcg_f64.argtypes = _build.ARGTYPES["pcg"]
            lib.need_pcg_f64.restype = ctypes.c_int
            libs["needed_pcg"] = lib.need_pcg_f64
            continue
        name = key.replace("_reversed", "")
        fn = getattr(lib, f"tmr_{name}_f64")
        fn.argtypes = _build.ARGTYPES[name]
        fn.restype = ctypes.c_int
        libs[key] = fn
        if key in ("fd", "fd_grad"):
            size = getattr(lib, f"tmr_{key}_smem_elems")
            size.argtypes = [ctypes.c_int]
            size.restype = ctypes.c_longlong
            libs[f"{key}_smem_elems"] = size
        if key == "pcg":
            _build.bind_pcg_shapes(lib)
            libs["pcg_smem_elems"] = lib.tmr_pcg_smem_elems
            libs["pcg_variant"] = lib.tmr_pcg_variant
            libs["pcg_work_elems"] = lib.tmr_pcg_work_elems
            libs["pcg_cluster_size"] = lib.tmr_pcg_cluster_size
    return libs


def _robot(spec, tmp_path):
    if spec == "rpr":
        path = tmp_path / "rpr.urdf"
        path.write_text(_RPR_URDF)
        return parse_urdf(str(path))
    if spec == "ytree":
        return _ytree(tmp_path)
    return serial_arm(int(spec[3:]))


def _run(fn, robot, q, qd, u, shape):
    packed = lanes.pack_robot(robot, torch.float64, "cpu")
    out = torch.full(shape, float("nan"), dtype=torch.float64)
    rc = fn(q.data_ptr(), qd.data_ptr(), u.data_ptr(), packed.data_ptr(),
            out.data_ptr(), robot.n, q.shape[1], None)
    assert rc == 0
    return out


SPECS = ["arm1", "arm2", "arm3", "arm6", "arm7", "rpr", "ytree"]


@pytest.mark.parametrize("spec", SPECS)
def test_host_compiled_kernels_match_plain(spec, host_libs, tmp_path):
    robot = _robot(spec, tmp_path)
    n, L = robot.n, 11      # an odd lane count: no tiling assumption
    rng = np.random.default_rng(n)
    q, qd, u = (torch.tensor(rng.standard_normal((n, L))) for _ in range(3))
    fd = _run(host_libs["fd"], robot, q, qd, u, (n, L))
    np.testing.assert_allclose(fd, lanes.fd_lanes(robot, q, qd, u),
                               atol=1e-9, rtol=0)
    fdg = _run(host_libs["fd_grad"], robot, q, qd, u, (n, 3 * n, L))
    np.testing.assert_allclose(fdg, lanes.fd_grad_lanes(robot, q, qd, u),
                               atol=1e-9, rtol=0)
    kin = LaneKinematics(robot)
    tv = _run(host_libs["task_vec"], robot, q, qd, u, (2 * kin.k, L))
    np.testing.assert_allclose(tv, kin.task_vec_L(q, qd), atol=1e-12, rtol=0)


K2_SPECS = [f"arm{n}" for n in range(1, 8)] + ["rpr", "ytree"]
# one lane, an odd count inside one block, and a ragged last block (fd.cu
# runs 16 lanes per block: 37 is two blocks and 5 lanes)
K2_LANES = [1, 11, 37]


@pytest.mark.parametrize("order", ["fd", "fd_reversed"])
@pytest.mark.parametrize("L", K2_LANES)
@pytest.mark.parametrize("spec", K2_SPECS)
def test_host_compiled_fd_groups_match_plain(spec, L, order, host_libs,
                                             tmp_path):
    """K2's phases at the card's group size G, thread by thread, against
    fd_lanes in f64."""
    robot = _robot(spec, tmp_path)
    n = robot.n
    rng = np.random.default_rng(100 * n + L)
    q, qd, u = (torch.tensor(rng.standard_normal((n, L))) for _ in range(3))
    out = _run(host_libs[order], robot, q, qd, u, (n, L))
    np.testing.assert_allclose(out, lanes.fd_lanes(robot, q, qd, u),
                               atol=1e-9, rtol=0)


# K3 over every robot shape it takes: serial arms, a prismatic joint, and
# the branched tree with the end effector on each of its two leaves (joints
# off the chain give zero Jacobian columns)
K3_SPECS = K2_SPECS[:-1] + ["ytree:0", "ytree:1"]
# one lane, an odd count inside one block, a ragged last block (task_vec.cu
# runs 128 lanes per block: 130 is one block and 2 lanes)
K3_LANES = [1, 11, 130]


@pytest.mark.parametrize("order", ["task_vec", "task_vec_reversed"])
@pytest.mark.parametrize("L", K3_LANES)
@pytest.mark.parametrize("spec", K3_SPECS)
def test_host_compiled_task_vec_lanes_match_plain(spec, L, order, host_libs,
                                                  tmp_path):
    """K3's lane body over whole blocks of lanes and a ragged tail, the
    lanes of a block in order and in reverse (each thread's lane reads
    only the block's constants), against task_vec_L in f64."""
    name, _, leaf = spec.partition(":")
    robot = _robot(name, tmp_path)
    kin = LaneKinematics(robot, leaf=int(leaf or 0))
    n = robot.n
    rng = np.random.default_rng(1000 + 10 * n + L + int(leaf or 0))
    q, qd = (torch.tensor(rng.standard_normal((n, L))) for _ in range(2))
    out = torch.full((2 * kin.k, L), float("nan"), dtype=torch.float64)
    packed = kin.packed(q)
    rc = host_libs[order](q.data_ptr(), qd.data_ptr(), None, packed.data_ptr(),
                          out.data_ptr(), n, L, None)
    assert rc == 0
    np.testing.assert_allclose(out, kin.task_vec_L(q, qd), atol=1e-12, rtol=0)


# the shared memory of one Hopper SM: two K2 blocks must fit on one
SM_SMEM = 233_472


@pytest.mark.parametrize("n", range(1, 8))
def test_host_compiled_fd_shared_memory_size(n, host_libs):
    """The wrapper's size is the kernel's own formula (fd.cu
    tmr_fd_smem_elems, read through the library), and for every supported
    n two blocks fit on an SM in f32 and in f64."""
    elems = host_libs["fd_smem_elems"](n)
    for dt in (torch.float32, torch.float64):
        size = lanes.smem_bytes("fd", n, dt, host_libs["fd_smem_elems"])
        assert size == dt.itemsize * elems
        assert 2 * size <= SM_SMEM
        lanes.check_fits("fd", n, dt, host_libs["fd_smem_elems"])


def test_fd_wrapper_refuses_a_block_over_the_shared_memory_limit(host_libs):
    n, smem = 24, host_libs["fd_smem_elems"]
    assert lanes.smem_bytes("fd", n, torch.float64, smem) > lanes.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        lanes.check_fits("fd", n, torch.float64, smem)


@pytest.mark.parametrize("order", ["fd_grad", "fd_grad_reversed"])
@pytest.mark.parametrize("L", K2_LANES)
@pytest.mark.parametrize("spec", K2_SPECS)
def test_host_compiled_fd_grad_groups_match_plain(spec, L, order, host_libs,
                                                  tmp_path):
    """K1's phases (K2's, then the RNEA at qdd, the per-link terms and the
    column-parallel dRNEA) at the card's group size G, thread by thread,
    against fd_grad_lanes in f64."""
    robot = _robot(spec, tmp_path)
    n = robot.n
    rng = np.random.default_rng(100 * n + L + 1)
    q, qd, u = (torch.tensor(rng.standard_normal((n, L))) for _ in range(3))
    out = _run(host_libs[order], robot, q, qd, u, (n, 3 * n, L))
    np.testing.assert_allclose(out, lanes.fd_grad_lanes(robot, q, qd, u),
                               atol=1e-9, rtol=0)


@pytest.mark.parametrize("n", range(1, 8))
def test_host_compiled_fd_grad_shared_memory_size(n, host_libs):
    """K1's block size is its own formula (fd_grad.cu
    tmr_fd_grad_smem_elems, read through the library), and for every
    supported n two blocks fit on an SM in f32 and in f64."""
    elems = host_libs["fd_grad_smem_elems"](n)
    for dt in (torch.float32, torch.float64):
        size = lanes.smem_bytes("fd_grad", n, dt, host_libs["fd_grad_smem_elems"])
        assert size == dt.itemsize * elems
        assert 2 * size <= SM_SMEM
        lanes.check_fits("fd_grad", n, dt, host_libs["fd_grad_smem_elems"])


def test_fd_grad_wrapper_refuses_a_block_over_the_shared_memory_limit(
        host_libs):
    """K1's wrapper refuses a block one value over the limit (a size
    function that says so) and, through its own formula, n = 16 in f64."""
    fake = lambda n: lanes.SMEM_LIMIT // 4 + 1
    with pytest.raises(ValueError, match="K1 .*shared memory"):
        lanes.check_fits("fd_grad", 6, torch.float32, fake)
    lanes.check_fits("fd_grad", 6, torch.float32, lambda n: lanes.SMEM_LIMIT // 4)
    n, smem = 16, host_libs["fd_grad_smem_elems"]
    assert lanes.smem_bytes("fd_grad", n, torch.float64, smem) > lanes.SMEM_LIMIT
    with pytest.raises(ValueError, match="K1 .*shared memory"):
        lanes.check_fits("fd_grad", n, torch.float64, smem)


@pytest.mark.parametrize("spec", K2_SPECS)
def test_needed_operations_compute_the_functions(spec, host_libs, tmp_path):
    """kernels/needed_ops.cpp, whose operations give the lanes kernels'
    bounds, computes K1-K3's functions: in f64 against the plain
    versions."""
    robot = _robot(spec, tmp_path)
    n, L = robot.n, 5
    rng = np.random.default_rng(7 * n + 1)
    q, qd, u = (torch.tensor(rng.standard_normal((n, L))) for _ in range(3))
    fd = _run(host_libs["needed_fd"], robot, q, qd, u, (n, L))
    np.testing.assert_allclose(fd, lanes.fd_lanes(robot, q, qd, u),
                               atol=1e-9, rtol=0)
    fdg = _run(host_libs["needed_fd_grad"], robot, q, qd, u, (n, 3 * n, L))
    np.testing.assert_allclose(fdg, lanes.fd_grad_lanes(robot, q, qd, u),
                               atol=1e-9, rtol=0)
    kin = LaneKinematics(robot)
    tv = _run(host_libs["needed_task_vec"], robot, q, qd, u, (2 * kin.k, L))
    np.testing.assert_allclose(tv, kin.task_vec_L(q, qd), atol=1e-12, rtol=0)


def test_operation_counts_follow_the_code():
    """kernels/opcount.py: the counts per lane are whole numbers, each
    function needs fewer operations than its kernel does (which repeats
    values across a group's threads or uses dense transforms), K1's
    function contains K2's, and a PCG iteration costs the same every
    time."""
    packed = lanes.pack_robot(serial_arm(6), torch.float64, "cpu")
    names = ("fd", "fd_grad", "task_vec")
    done = {k: opcount.count_lanes(k, packed, 6) for k in names}
    need = {k: opcount.count_needed(k, packed, 6) for k in names}
    for k in names:
        assert float(need[k]).is_integer() and 0 < need[k] < done[k], k
        assert float(done[k]).is_integer(), k
    assert need["task_vec"] < need["fd"] < need["fd_grad"]
    ops = _pcg_problem(2, 8, 12, seed=3, precond="SS")
    kw = dict(ss=True, relative=False, tol=0.0)
    c0, c10, c20 = (opcount.count_pcg(*ops, max_iter=k, **kw)
                    for k in (0, 10, 20))
    assert c0 > 0 and c20 - c10 == c10 - c0 > 0


def test_operation_counts_follow_the_cluster_code(host_libs):
    """kernels/opcount.py counts the variant the operands' dtype takes: at
    (N, bs) = (1024, 12) f32 operands take a cluster of 7 blocks, f64 ones
    a cluster of 13; at (1280, 12) f32 a cluster of 8, f64 the global
    operator (16 blocks).  All do the same arithmetic per row; a block's
    sum over w warps is 31 (w + 1) additions (a tree per warp and one over
    the slots), and a cluster's adds its C blocks' sums in order.  At
    1,024: 7 ranks of 147 knots (1,764 rows, 3 a thread: 608 threads, 19
    warps), 7 x 620 + 6 = 4,346 additions a sum; 13 of 79 (948 rows, 2 a
    thread: 480 threads, 15 warps), 13 x 496 + 12 = 6,460, 2,114 more.  At
    1,280: 8 of 160 (1,920 rows, 640 threads, 20 warps), 8 x 651 + 7 =
    5,215; 16 of 80 (960 rows, 480 threads), 16 x 496 + 15 = 7,951, 2,736
    more.  Two scenarios, one converged before its first iteration (one
    sum, r's), the other taking k fixed iterations (1 + 2 k sums: p'Ap and
    r's)."""
    var, csize = host_libs["pcg_variant"], host_libs["pcg_cluster_size"]
    kw = dict(ss=True, relative=False, tol=0.0)
    for N, sizes, more in ((1024, (7, 13), 2_114), (1280, (8, 0), 2_736)):
        ops = _pcg_problem(2, N, 12, seed=3, precond="SS")
        f32 = [t.float() for t in ops]
        assert FP.variant(N, 12, torch.float32, var) == 3
        assert FP.cluster_size(N, 12, torch.float32, csize) == sizes[0]
        assert FP.variant(N, 12, torch.float64, var) == (3 if sizes[1] else 2)
        assert FP.cluster_size(N, 12, torch.float64, csize) == sizes[1]
        for k in (0, 3, 6):
            cl = opcount.count_pcg(*f32, max_iter=k, **kw)
            wide = opcount.count_pcg(*ops, max_iter=k, **kw)
            assert wide - cl == more * (2 + 2 * k), (N, k, cl, wide)
        c = [opcount.count_pcg(*f32, max_iter=k, **kw) for k in (0, 3, 6)]
        assert c[2] - c[1] == c[1] - c[0] > 0


def _pcg_problem(B, N, bs, seed, precond, shift=4.0):
    """Packed K4 operands for B random systems (scenario 1 negative
    definite, scenario 0's r0 exactly zero: converged before the first
    iteration) with right-hand sides of scales 1e-2..1e2; the diagonal
    blocks are M M' + shift bs I (a smaller shift: more iterations)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, N, bs, bs))
    sign = np.where(np.arange(B) == 1, -1.0, 1.0)[:, None, None, None]
    diag = sign * (M @ np.swapaxes(M, -1, -2) + shift * bs * np.eye(bs))
    upper = sign * 0.3 * rng.standard_normal((B, N - 1, bs, bs))
    r0 = rng.standard_normal((B, N, bs)) * np.logspace(-2, 2, B)[:, None, None]
    r0[0] = 0.0
    A = tbtd.BlockTridiag(torch.tensor(diag), torch.tensor(upper))
    return FP.pack_operands(A, torch.tensor(r0), precond)


@pytest.mark.parametrize("N", [1, 7, 64])
@pytest.mark.parametrize("relative", [False, True])
@pytest.mark.parametrize("precond", ["J", "BJ", "SS"])
def test_host_compiled_pcg_matches_plain(precond, relative, N, host_libs):
    B, bs, max_iter = 4, 12, 60
    tol = 1e-14 if relative else 1e-10
    ops = _pcg_problem(B, N, bs, seed=N, precond=precond)
    dx, iters = _run_pcg(host_libs["pcg"], ops, precond, relative, max_iter,
                         tol, host_libs)
    ref, ref_iters = FP.pcg_fused_plain(*ops, precond=precond, tol=tol,
                                        max_iter=max_iter, relative=relative)
    assert iters.tolist() == ref_iters.tolist()
    assert iters[0] == 0 and torch.equal(dx[0], torch.zeros_like(dx[0]))
    for k in range(1, B):
        np.testing.assert_allclose(dx[k].numpy(), ref[k].numpy(), rtol=0,
                                   atol=1e-10 * float(ref[k].abs().max()))


def _run_pcg(fn, ops, precond, relative, max_iter, tol, host_libs):
    """One host entry (a g++ build of pcg.cu, or needed_ops.cpp's) through
    the wrapper's own call (ops/fused_pcg.launch: codes, workspace, the
    return code checked)."""
    return FP.launch(fn, *ops, precond=precond, tol=tol, max_iter=max_iter,
                     relative=relative,
                     work_elems=host_libs["pcg_work_elems"])


# (bs, N): each block size the register variant is built for (N = 1, odd
# and ragged N), a cluster of one block at block sizes read at run time
# and at built ones over the register variant's rows (bs = 12 past 768
# rows, bs = 2 past 1,024)
PCG_SHAPES = [(2, 1), (2, 37), (4, 5), (6, 11), (8, 3), (10, 13), (12, 1),
              (12, 63), (14, 9), (1, 6), (3, 17), (5, 1), (12, 70), (2, 515)]


def _plain_extended(diag_p, upper, pdiag_p, r0, *, precond, tol, max_iter,
                    relative):
    """pcg_fused_plain's loop in numpy's extended precision (np.longdouble:
    80-bit on x86-64): the f64 solve's own reference where rounding is
    amplified (at (2, 515) with J, pcg_fused_plain itself ends 7.9e-10 of
    the solution's scale from it)."""
    L = np.longdouble
    bs = r0.shape[-1]
    D, P = (FP._unpack_sym(t, bs).numpy().astype(L) for t in (diag_p, pdiag_p))
    U, r = upper[:, :-1].numpy().astype(L), r0.numpy().astype(L)
    bmv = lambda A, v: np.einsum("bkij,bkj->bki", A, v)
    dot = lambda a, b: (a * b).sum((-1, -2))

    def off(v):
        y = np.zeros_like(v)
        y[:, :-1] += bmv(U, v[:, 1:])
        y[:, 1:] += np.einsum("bkji,bkj->bki", U, v[:, :-1])
        return y

    def apply_P(r):
        s = bmv(P, r)
        return s - bmv(P, off(s)) if precond == "SS" else s

    x, s = np.zeros_like(r), apply_P(r)
    p, nu = s, dot(r, s)
    thr = (np.maximum(tol * np.abs(nu), L(1e-30)) if relative
           else np.full_like(nu, tol))
    done, it = np.abs(nu) <= thr, np.zeros(nu.shape, dtype=np.int64)
    for _ in range(max_iter):
        if done.all():
            break
        Ap = bmv(D, p) + off(p)
        pAp = dot(p, Ap)
        alpha = (nu / np.where(pAp != 0, pAp, L(1)))[:, None, None]
        keep = done[:, None, None]
        x = np.where(keep, x, x + alpha * p)
        r = np.where(keep, r, r - alpha * Ap)
        s = apply_P(r)
        nu_new = np.where(done, nu, dot(r, s))
        it = np.where(done, it, it + 1)
        done = done | (np.abs(nu_new) <= thr)
        beta = np.where(done, L(0), nu_new / np.where(done, L(1), nu))
        p = np.where(done[:, None, None], p, s + beta[:, None, None] * p)
        nu = nu_new
    return x, it


@pytest.mark.parametrize("order", ["pcg", "pcg_reversed"])
@pytest.mark.parametrize("precond", ["J", "BJ", "SS"])
@pytest.mark.parametrize("bs,N", PCG_SHAPES)
def test_host_compiled_pcg_variants_match_plain(bs, N, precond, order,
                                                host_libs):
    """K4's phases, thread by thread in order and in reverse, for each
    variant and block size, and pcg_fused_plain, each against the plain
    loop in extended precision (_plain_extended) in f64: equal iteration
    counts, 1e-9 of each scenario's scale (the same loop, sums in another
    order; up to 80 iterations on up to 1,030 rows, where J's conditioning
    carries f64's rounding to ~1e-9 in either, most cases agree to
    ~1e-15); the absolute exit for J and SS, the relative one for BJ."""
    B, max_iter, relative = 4, 80, precond == "BJ"
    tol = 1e-14 if relative else 1e-10
    ops = _pcg_problem(B, N, bs, seed=10 * bs + N, precond=precond, shift=0.5)
    dx, iters = _run_pcg(host_libs[order], ops, precond, relative, max_iter,
                         tol, host_libs)
    kw = dict(precond=precond, tol=tol, max_iter=max_iter, relative=relative)
    plain, plain_iters = FP.pcg_fused_plain(*ops, **kw)
    ref, ref_iters = _plain_extended(*ops, **kw)
    assert iters.tolist() == plain_iters.tolist() == ref_iters.tolist()
    assert iters[0] == 0 and torch.equal(dx[0], torch.zeros_like(dx[0]))
    for k in range(1, B):
        scale = float(np.abs(ref[k]).max())
        for got in (dx[k], plain[k]):
            err = float(np.abs(got.numpy().astype(np.longdouble)
                               - ref[k]).max())
            assert err <= 1e-9 * scale, (k, err / scale)
    regs = bs % 2 == 0 and bs <= 14 and N * bs <= (1024 if bs <= 8 else 768)
    assert FP.variant(N, bs, torch.float64, host_libs["pcg_variant"]) == (
        0 if regs else 3)
    assert FP.cluster_size(N, bs, torch.float64,
                           host_libs["pcg_cluster_size"]) == 1


@pytest.mark.parametrize("N", [1, 7, 64])
@pytest.mark.parametrize("relative", [False, True])
@pytest.mark.parametrize("precond", ["J", "BJ", "SS"])
def test_needed_pcg_computes_the_function(precond, relative, N, host_libs):
    """K4's function as needed_ops.cpp writes it (whose operations give
    K4's bound) against pcg_fused_plain in f64."""
    B, bs, max_iter = 4, 12, 60
    tol = 1e-14 if relative else 1e-10
    ops = _pcg_problem(B, N, bs, seed=N + 5, precond=precond, shift=0.5)
    dx, iters = _run_pcg(host_libs["needed_pcg"], ops, precond, relative,
                         max_iter, tol, host_libs)
    ref, ref_iters = FP.pcg_fused_plain(*ops, precond=precond, tol=tol,
                                        max_iter=max_iter, relative=relative)
    assert iters.tolist() == ref_iters.tolist()
    for k in range(B):
        np.testing.assert_allclose(dx[k].numpy(), ref[k].numpy(), rtol=0,
                                   atol=1e-10 * float(ref[k].abs().max()))


@pytest.mark.parametrize("ss", [False, True])
def test_needed_pcg_count_follows_the_loop(ss):
    """K4's needed count grows by one iteration's operations per iteration
    of the budget: each block product over full rows (2 bs - 1 operations
    a row), the first and last block rows without the block they lack, and
    the vector updates; the kernel does more (sums from zero rows at the
    ends, p = s + 0 p at the first iteration)."""
    B, N, bs = 2, 8, 12
    n, row = N * bs, 2 * bs - 1
    ops = _pcg_problem(B, N, bs, seed=3, precond="SS" if ss else "BJ")
    kw = dict(ss=ss, relative=False, tol=0.0)
    c0, c10, c20 = (opcount.count_needed_pcg(*ops, max_iter=k, **kw)
                    for k in (0, 10, 20))
    matvec = row * (n + 2 * (n - bs)) + 2 * (n - bs)
    precond = row * n
    if ss:   # t = U s_{k+1} + U' s_{k-1}, P t, s - P t
        precond += row * 2 * (n - bs) + (n - 2 * bs) + row * n + n
    per_iter = matvec + precond + 2 * (2 * n - 1) + 3 * 2 * n + 2
    # scenario 0 is converged before the first iteration: B - 1 count; the
    # first iteration's x = alpha p takes n operations, not 2 n
    assert c20 - c10 == 10 * (B - 1) * per_iter
    assert c10 - c0 == (10 * per_iter - n) * (B - 1)
    assert c0 > 0
    done = opcount.count_pcg(*ops, max_iter=20, **kw)
    assert c20 < done


def test_host_compiled_pcg_shared_memory_size(host_libs):
    """The wrapper's size is the kernel's own formula (pcg.cu
    tmr_pcg_smem_elems, read through the library), for the variant each
    shape takes in each dtype: the register variant (3 N bs + 4 bs values
    and two reduction slots per warp), the cluster variant (a run of
    knots, one upper block more, five vectors, the block's and the
    cluster's reduction slots: 64 + 4 x 16; one block where that fits,
    with four vectors and the block's slots), and the global operator (a
    rank's five vectors and the slots); the
    flagship fits in a tenth of the first design's 95,364 bytes, and a
    shape past 16 blocks' shared memory takes the global operator, whose
    blocks fit."""
    smem, var = host_libs["pcg_smem_elems"], host_libs["pcg_variant"]
    for N, bs in ((1, 1), (7, 12), (64, 12), (63, 5), (157, 12), (256, 12)):
        for dtype in (torch.float32, torch.float64):
            elems = smem(N, bs, dtype.itemsize)
            assert FP.smem_bytes(N, bs, dtype, smem) == dtype.itemsize * elems
            tri = bs * (bs + 1) // 2
            C = FP.cluster_size(N, bs, dtype, host_libs["pcg_cluster_size"])
            nk = -(-N // C)
            assert elems == {
                0: 3 * N * bs + 4 * bs + 64,
                3: 2 * nk * tri + (nk + 1) * bs * bs + (
                    4 * nk * bs + 64 if C == 1 else 5 * nk * bs + 128),
            }[FP.variant(N, bs, dtype, var)]
    assert FP.smem_bytes(64, 12, torch.float32, smem) == 9_664
    FP.check_fits(64, 12, torch.float64, smem)
    assert FP.variant(4 * 64, 12, torch.float64, var) == 3
    FP.check_fits(4 * 64, 12, torch.float64, smem)
    assert FP.variant(1280, 12, torch.float64, var) == 2
    assert smem(1280, 12, 8) == 5 * 80 * 12 + 128
    FP.check_fits(1280, 12, torch.float64, smem)


def _first_design_elems(N, bs):
    """The first design's shared memory per block, in values (the system
    and six vectors in shared memory): what it accepted."""
    tri = bs * (bs + 1) // 2
    return 2 * N * tri + N * bs * bs + 6 * N * bs + 33


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs", [1, 2, 3, 5, 8, 12, 14, 20, 48, 170])
def test_pcg_accepts_every_shape_the_first_design_took(bs, dtype, host_libs):
    """At each block size the largest N the first design fitted in one
    block's shared memory (and every smaller N, the sizes growing with N)
    fits K4's block."""
    smem, limit = host_libs["pcg_smem_elems"], FP.SMEM_LIMIT // dtype.itemsize
    n_max = 0
    while _first_design_elems(n_max + 1, bs) <= limit:
        n_max += 1
    if n_max == 0:
        return
    for N in sorted({1, n_max // 2, n_max}):
        FP.check_fits(N, bs, dtype, smem)
        assert (smem(N, bs, dtype.itemsize) <= _first_design_elems(N, bs)
                or N * bs <= 768)
