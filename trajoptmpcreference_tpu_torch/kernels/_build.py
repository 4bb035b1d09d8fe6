"""Build and load the hand-written CUDA kernels (K1-K4).

Each source in ``csrc/`` with a plain C interface is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under
``<repo>/build/kernels/<hash>/`` (the hash covers every file in csrc/), at
first use and never at import.  The libraries are loaded with ctypes; the
lanes kernels K1-K3 (fd, fd_grad, task_vec) have the entries

    int tmr_<name>_<f32|f64>(const void* q, const void* qd, const void* u,
                             const void* consts, void* out, int n, int L,
                             void* stream)

and the PCG kernel K4 (pcg)

    int tmr_pcg_<f32|f64>(const void* diag_p, const void* upper,
                          const void* pdiag_p, const void* r0, void* dx,
                          void* iters, void* work, int B, int N, int bs,
                          int dcode, int pcode, int ss, int relative,
                          int max_iter, double tol, void* stream)

Each returns ``cudaGetLastError()`` after its launch on ``stream``, and
K4's -1 for a shape it cannot index (``ARGTYPES`` binds each library's
signature).  K4's ``dcode`` / ``pcode`` say how the packed blocks and
their inverses are stored (``ops/fused_pcg.STORAGE``) and ``work`` is its
global operator's workspace (``tmr_pcg_work_elems``); its
``tmr_pcg_<f32|f64>_as`` entries take one more int, the variant to run.

    python -m trajoptmpcreference_tpu_torch.kernels._build   # build, print ptxas
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = CSRC.parents[2] / "build" / "kernels"
LIBRARIES = ("fd", "fd_grad", "task_vec", "pcg")
_P, _I = ctypes.c_void_p, ctypes.c_int
_LANES_ARGS = [_P] * 5 + [_I, _I, _P]
# argument types of each library's tmr_<name>_<f32|f64> entries
ARGTYPES = {
    "fd": _LANES_ARGS,
    "fd_grad": _LANES_ARGS,
    "task_vec": _LANES_ARGS,
    "pcg": [_P] * 7 + [_I] * 8 + [ctypes.c_double, _P],
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> pathlib.Path:
    return BUILD_ROOT / source_hash()


def build_all() -> Dict[str, float]:
    """Compile every missing library in parallel (one nvcc per source).
    Returns {name: seconds} for the libraries built by this call; each
    library's ``ptxas -v`` report is kept beside it as ``<name>.ptxas.txt``."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in LIBRARIES:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    times = {}
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        (out / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, lib)
    return times


def ptxas_report(name: str) -> str:
    p = build_dir() / f"{name}.ptxas.txt"
    return p.read_text() if p.exists() else ""


def bind_pcg_shapes(lib: ctypes.CDLL) -> None:
    """Bind K4's per-shape entries, each of (N, bs, bytes per value): the
    variant, the cluster variant's blocks per scenario, the shared memory
    per block and the workspace per scenario (in values), and the
    clusters resident at once on the card; the workspace of a given
    variant (N, bs, bytes, variant); the entries that run a given variant
    (``tmr_pcg_<f32|f64>_as``); and the storage decoder (pointer, index,
    code -> f64).  A build of an older pcg.cu (a baseline in
    tools/bench_fd.py) may lack some of these entries, or take the
    variant's workspace without the value size: those it has are bound,
    and the solve entries and ``tmr_pcg_work_elems`` are the same."""
    for name, res in (("variant", ctypes.c_int),
                      ("cluster_size", ctypes.c_int),
                      ("smem_elems", ctypes.c_longlong),
                      ("work_elems", ctypes.c_longlong),
                      ("variant_work_elems", ctypes.c_longlong),
                      ("max_clusters", ctypes.c_int)):
        fn = getattr(lib, f"tmr_pcg_{name}", None)
        if fn is not None:
            fn.argtypes = [_I] * (4 if name == "variant_work_elems" else 3)
            fn.restype = res
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"tmr_pcg_{suffix}_as", None)
        if fn is not None:
            fn.argtypes, fn.restype = ARGTYPES["pcg"] + [_I], ctypes.c_int
    lib.tmr_pcg_stored.argtypes = [_P, ctypes.c_longlong, _I]
    lib.tmr_pcg_stored.restype = ctypes.c_double


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use)."""
    if name not in _loaded:
        lib_path = build_dir() / f"lib{name}.so"
        if not lib_path.exists():
            build_all()
        lib = ctypes.CDLL(str(lib_path))
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"tmr_{name}_{suffix}")
            fn.argtypes = ARGTYPES[name]
            fn.restype = ctypes.c_int
        if name in ("fd", "fd_grad"):   # shared memory per block, in values
            size = getattr(lib, f"tmr_{name}_smem_elems")
            size.argtypes = [_I]
            size.restype = ctypes.c_longlong
        if name == "pcg":
            bind_pcg_shapes(lib)
        _loaded[name] = lib
    return _loaded[name]


if __name__ == "__main__":
    for lib_name, secs in build_all().items():
        print(f"built {lib_name} in {secs:.1f} s")
    for lib_name in LIBRARIES:
        print(ptxas_report(lib_name))
