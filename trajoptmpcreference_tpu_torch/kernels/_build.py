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
                          void* iters, int B, int N, int bs, int ss,
                          int relative, int max_iter, double tol,
                          void* stream)

Each returns ``cudaGetLastError()`` after its launch on ``stream``
(``ARGTYPES`` binds each library's signature).

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
    "pcg": [_P] * 6 + [_I] * 6 + [ctypes.c_double, _P],
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
        if name == "fd":   # K2's shared memory per block, in values
            lib.tmr_fd_smem_elems.argtypes = [_I]
            lib.tmr_fd_smem_elems.restype = ctypes.c_longlong
        _loaded[name] = lib
    return _loaded[name]


if __name__ == "__main__":
    for lib_name, secs in build_all().items():
        print(f"built {lib_name} in {secs:.1f} s")
    for lib_name in LIBRARIES:
        print(ptxas_report(lib_name))
