"""Count floating-point operations by compiling C++ over a counting scalar.

A scalar type that counts every +, -, * and / (and each sin or cos, as one
operation; a sign flip is not counted) stands in for float.  Two things are
counted with it:

* what a function needs (``count_needed``, ``count_needed_pcg``):
  ``needed_ops.cpp`` writes K1-K4's functions once more, each value
  computed once (K1-K3 one thread per lane; K4 one scenario's loop, a
  symmetric block's product over its full rows).  These counts give the
  kernels' bounds (operations over the card's peak rate) in chip_smoke.py;
* what a kernel does (``count_lanes``, ``count_pcg``): each ``csrc/*.cu``
  compiles as plain C++ (no ``__CUDACC__``) into a host loop over the very
  device functions the card runs, every thread of a group or a block
  included.

A multiply-add counts as two.

    count_needed("fd", packed, n)        # per lane, K1-K3's functions
    count_lanes("fd", packed, n)         # per lane, K1-K3 as written
    count_needed_pcg(diag_p, upper, pdiag_p, r0, ss=..., ...)  # per call, K4's function
    count_pcg(diag_p, upper, pdiag_p, r0, ss=..., ...)   # per call, K4 as written

The host compiler is ``g++`` (the CUDA toolkit needs one); the libraries
go to ``<repo>/build/opcount/<hash>/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict

import numpy as np

from trajoptmpcreference_tpu_torch.kernels import _build

_PRELUDE = r"""
#include <math.h>
#include <vector>
namespace tmr_count {
long long ops = 0;
struct Num {
  double v;
  Num(double x = 0) : v(x) {}
  explicit operator int() const { return (int)v; }
};
inline Num operator+(Num a, Num b) { ++ops; return Num(a.v + b.v); }
inline Num operator-(Num a, Num b) { ++ops; return Num(a.v - b.v); }
inline Num operator*(Num a, Num b) { ++ops; return Num(a.v * b.v); }
inline Num operator/(Num a, Num b) { ++ops; return Num(a.v / b.v); }
inline Num operator-(Num a) { return Num(-a.v); }
inline Num& operator+=(Num& a, Num b) { ++ops; a.v += b.v; return a; }
inline Num& operator-=(Num& a, Num b) { ++ops; a.v -= b.v; return a; }
inline Num& operator*=(Num& a, Num b) { ++ops; a.v *= b.v; return a; }
inline bool operator<(Num a, Num b) { return a.v < b.v; }
inline bool operator<=(Num a, Num b) { return a.v <= b.v; }
inline bool operator>(Num a, Num b) { return a.v > b.v; }
inline bool operator==(Num a, Num b) { return a.v == b.v; }
inline bool operator!=(Num a, Num b) { return a.v != b.v; }
inline Num tsin(Num a) { ++ops; return Num(sin(a.v)); }
inline Num tcos(Num a) { ++ops; return Num(cos(a.v)); }
std::vector<Num> nums(const double* p, size_t k) {
  return std::vector<Num>(p, p + k);
}
}  // namespace tmr_count
using tmr_count::Num;
using tmr_count::nums;
"""

# the count entries appended after each source
_LANES_ENTRY = r"""
extern "C" long long count_lanes(const double* q, const double* qd,
                                 const double* u, const double* c, int nc,
                                 int n, int L, int out_rows) {
  std::vector<Num> Q = nums(q, (size_t)n * L), QD = nums(qd, (size_t)n * L),
                   U = nums(u, (size_t)n * L), C = nums(c, nc),
                   O((size_t)out_rows * L);
  tmr_count::ops = 0;
  CALL;
  return tmr_count::ops;
}
"""

_PCG_ENTRY = r"""
extern "C" long long count_pcg(const double* d, const double* up,
                               const double* pd, const double* r0, int B,
                               int N, int bs, int ss, int relative,
                               int max_iter, double tol, int item) {
  const size_t nD = (size_t)B * N * bs * (bs + 1) / 2,
               nU = (size_t)B * N * bs * bs, nR = (size_t)B * N * bs;
  const int v = tmr_pcg::variant(N, bs, item);
  std::vector<Num> D = nums(d, nD), UP = nums(up, nU), PD = nums(pd, nD),
                   R0 = nums(r0, nR), DX(nR),
                   W((size_t)B * tmr_pcg::variant_work_elems(v, N, bs, item));
  std::vector<int> it(B);
  tmr_count::ops = 0;
  tmr_pcg::launch_pcg<Num>(D.data(), UP.data(), PD.data(), R0.data(),
                           DX.data(), it.data(), W.data(), B, N, bs, 0, 0,
                           ss, relative, max_iter, tol, nullptr, v, item);
  return tmr_count::ops;
}
"""

_CALLS = {
    "fd": "tmr::fd::launch_fd<Num>(Q.data(), QD.data(), U.data(), C.data(), "
          "O.data(), n, L, nullptr)",
    "fd_grad": "tmr::fd_grad::launch_fd_grad<Num>(Q.data(), QD.data(), U.data(), "
               "C.data(), O.data(), n, L, nullptr)",
    "task_vec": "tmr::task_vec::launch_task_vec<Num>(Q.data(), QD.data(), C.data(), "
                "O.data(), n, L, nullptr)",
}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_loaded: Dict[str, ctypes.CDLL] = {}


NEEDED = pathlib.Path(__file__).resolve().parent / "needed_ops.cpp"
_COUNTED = _build.LIBRARIES + ("needed",)
_WHICH = {"fd": 0, "fd_grad": 1, "task_vec": 2}   # needed_ops.cpp Which


def _source(name: str) -> str:
    if name == "needed":
        return _PRELUDE + f'#define TMR_NEED_COUNT\n#include "{NEEDED}"\n'
    body = _PRELUDE + f'#include "{_build.CSRC / (name + ".cu")}"\n'
    if name == "pcg":
        return body + _PCG_ENTRY
    return body + _LANES_ENTRY.replace("CALL", _CALLS[name])


def _out_dir():
    h = hashlib.sha256((_build.source_hash() + _PRELUDE).encode())
    h.update(NEEDED.read_bytes())
    return _build.BUILD_ROOT.parent / "opcount" / h.hexdigest()[:16]


def build_all() -> None:
    """Compile every missing counting library, one g++ per source, all
    started together."""
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found: the operation counts compile the "
                           "kernel sources as plain C++")
    out = _out_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in _COUNTED:
        so = out / f"lib{name}_count.so"
        if so.exists():
            continue
        src = out / f"{name}_count.{os.getpid()}.cpp"
        src.write_text(_source(name))
        tmp = out / f"lib{name}_count.{os.getpid()}.tmp.so"
        procs.append((subprocess.Popen(
            [compiler, "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
             str(tmp), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, so, name))
    for proc, tmp, so, name in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for the {name} count:\n{log}")
        os.replace(tmp, so)


def _library(name: str) -> ctypes.CDLL:
    if name not in _loaded:
        so = _out_dir() / f"lib{name}_count.so"
        if not so.exists():
            build_all()
        lib = ctypes.CDLL(str(so))
        if name == "pcg":
            lib.count_pcg.argtypes = [_P] * 4 + [_I] * 6 + [_D, _I]
            lib.count_pcg.restype = ctypes.c_longlong
        elif name == "needed":
            lib.need_count.argtypes = [_I] + [_P] * 4 + [_I] * 4
            lib.need_count.restype = ctypes.c_longlong
            lib.need_pcg_count.argtypes = [_P] * 4 + [_I] * 6 + [_D]
            lib.need_pcg_count.restype = ctypes.c_longlong
        else:
            lib.count_lanes.argtypes = [_P] * 4 + [_I] * 4
            lib.count_lanes.restype = ctypes.c_longlong
        _loaded[name] = lib
    return _loaded[name]


def _f64(a) -> np.ndarray:
    """A C-contiguous float64 copy on the host (numpy array or tensor)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().double().numpy()
    return np.ascontiguousarray(a, dtype=np.float64)


_OUT_ROWS = {"fd": lambda n: n, "fd_grad": lambda n: 3 * n * n,
             "task_vec": lambda n: 2 * min(3, n)}


def _lanes_inputs(packed, n, L=3, seed=0):
    rng = np.random.default_rng(seed)
    q, qd, u = (np.ascontiguousarray(rng.standard_normal((n, L)))
                for _ in range(3))
    return q, qd, u, _f64(packed), L


def count_lanes(name: str, packed, n: int) -> float:
    """Operations per lane of kernel ``name`` (fd, fd_grad, task_vec) for
    the robot packed in ``packed`` (ops/lanes.pack_robot).  The lanes
    kernels take no data-dependent branch, so a few random lanes give the
    count of every lane."""
    q, qd, u, c, L = _lanes_inputs(packed, n)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    ops = _library(name).count_lanes(ptr(q), ptr(qd), ptr(u), ptr(c), c.size,
                                     n, L, _OUT_ROWS[name](n))
    return ops / L


def count_needed(name: str, packed, n: int) -> float:
    """Operations per lane that the function of kernel ``name`` (fd,
    fd_grad, task_vec) needs for the robot packed in ``packed``
    (needed_ops.cpp: one thread per lane, each value once).  What it skips
    depends on the robot's structure, not on the lane, so a few random
    lanes give the count of every lane."""
    q, qd, u, c, L = _lanes_inputs(packed, n)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    ops = _library("needed").need_count(_WHICH[name], ptr(q), ptr(qd),
                                        ptr(u), ptr(c), c.size, n, L,
                                        _OUT_ROWS[name](n))
    return ops / L


def _count_pcg_call(fn, diag_p, upper, pdiag_p, r0, ss, relative, max_iter,
                    tol, *extra) -> int:
    d, up, pd, r = (_f64(a) for a in (diag_p, upper, pdiag_p, r0))
    B, N, bs = r.shape
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    return int(fn(ptr(d), ptr(up), ptr(pd), ptr(r), B, N, bs, int(ss),
                  int(relative), max_iter, float(tol), *extra))


def count_pcg(diag_p, upper, pdiag_p, r0, *, ss: bool, relative: bool,
              max_iter: int, tol: float) -> int:
    """Operations K4 does in one call on these operands (ops/fused_pcg.py
    layout), every thread of a block (of each block of a cluster), in the
    variant the operands' dtype takes at their shape; the loop ends where
    each scenario's data ends it."""
    item = (r0.element_size() if hasattr(r0, "element_size")
            else np.asarray(r0).itemsize)
    return _count_pcg_call(_library("pcg").count_pcg, diag_p, upper, pdiag_p,
                           r0, ss, relative, max_iter, tol, item)


def count_needed_pcg(diag_p, upper, pdiag_p, r0, *, ss: bool, relative: bool,
                     max_iter: int, tol: float) -> int:
    """Operations that K4's function needs for one call on these operands
    (needed_ops.cpp: each value once, a symmetric block's product over its
    full rows); the loop ends where each scenario's data ends it."""
    return _count_pcg_call(_library("needed").need_pcg_count, diag_p, upper,
                           pdiag_p, r0, ss, relative, max_iter, tol)
