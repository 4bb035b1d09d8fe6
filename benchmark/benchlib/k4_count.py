"""What one call of K4 (kernels/csrc/pcg.cu, the fused PCG) needs, its
operations and bytes from the shapes and the iterations it ran, and what
the K4 readers read: its kernels' names in the device trace and the port's
iteration totals.

The operations are those of ``kernels/needed_ops.cpp``'s ``pcg_run`` (each
value once, a symmetric block's product over its full rows, a multiply-add
as two), which ``kernels/opcount.count_needed_pcg`` counts: for N = 64,
bs = 12, B = 512, SS and a relative exit, 2,671,906,048 at the 33-40
iterations of PERF.md's K4 row.  The bytes are the operands read once and
the results written once: the packed diagonal blocks and their packed
inverses (B, N, bs (bs + 1) / 2), the upper blocks (B, N, bs, bs), r0 and
dx (B, N, bs) in the value type, and the iteration counts (B,) as int32.
"""

from __future__ import annotations


def _rows(N: int, bs: int):
    """(n, the operations of the off-diagonal products over all n rows,
    and 1 where a row has an off-diagonal part to add, else 0)."""
    n = N * bs
    if N == 1:
        return n, 0, 0
    # a boundary block row has one neighbour block, an inner row two
    # (joined by one add)
    off = (N - 2) * bs * (4 * bs - 1) + 2 * bs * (2 * bs - 1)
    return n, off, 1


def needed_ops(N: int, bs: int, iters: float, *, ss: bool = True,
               relative: bool = True, exited: bool = True) -> float:
    """The operations one scenario's solve needs when it ran ``iters``
    iterations (at least 1; a mean over scenarios may be passed) and, with
    ``exited``, left the loop on its threshold (its last iteration forms no
    new search direction); without it, it ran out of iterations."""
    n, off, has_off = _rows(N, bs)
    row = n * (2 * bs - 1)                          # one block-diagonal product
    matvec = row + off + has_off * n
    apply_p = row + ((off + row + n) if ss and N > 1 else 0)
    dot = 2 * n - 1
    start = apply_p + dot + (1 if relative else 0)
    # S p, p'Ap, alpha, x and r updates, P r, nu, beta, the new p
    step = matvec + dot + 1 + 2 * n + 2 * n + apply_p + dot + 1 + 2 * n
    # the first x update is alpha p alone
    return start + iters * step - n - ((2 * n + 1) if exited else 0)


def bytes_moved(B: int, N: int, bs: int, itemsize: int) -> int:
    """Operands read once and results written once, for B scenarios."""
    tri = bs * (bs + 1) // 2
    return B * (itemsize * N * (2 * tri + bs * bs + 2 * bs) + 4)


def bound_s(B: int, N: int, bs: int, iters: float, itemsize: int,
            peaks: dict) -> float:
    """The least time one call over B scenarios can take, each at ``iters``
    iterations and leaving on its threshold: its operations at the compute
    peak or its bytes at the memory peak, whichever is longer.  A scenario
    that ran out of iterations needs 2 n + 1 operations more than this
    counts, one that needed none 3 n + 1 more (n = N bs), and the count is
    affine in the iterations, so at the mean over a call's scenarios it
    never counts more than the call needs."""
    return max(B * needed_ops(N, bs, iters) / peaks["f32_flops"],
               bytes_moved(B, N, bs, itemsize) / peaks["hbm_bytes_per_s"])


# K4's kernels as the device trace names them (pcg.cu: pcg_regs,
# pcg_cluster in namespace tmr_pcg)
K4_KERNEL_PREFIX = "tmr_pcg::pcg_"


def is_k4(kernel_name: str) -> bool:
    return K4_KERNEL_PREFIX in kernel_name


def itemsize(config: dict) -> int:
    return {"float32": 4, "float64": 8}[config["dtype"]]


def iters_per_call():
    """The port's totals ``pcg/iters`` / ``pcg/scenarios`` over the
    process's K4 calls (``utils.spans.snapshot``), or None where it kept
    none: a program without those totals, or a run with no PCG call."""
    from trajoptmpcreference_tpu_torch.utils import spans
    counts = spans.snapshot()["counts"]
    scenarios = counts.get("pcg/scenarios", 0)
    return counts.get("pcg/iters", 0) / scenarios if scenarios else None
