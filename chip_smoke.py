"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # on a machine with a CUDA card

Phases (each prints its own numbers; any failure exits non-zero):

1. toolchain: torch / CUDA / nvcc versions, card name and power limit;
2. build: nvcc compiles kernels K1-K4 (csrc/*.cu) for sm_90a, in parallel,
   and g++ the operation counters (kernels/opcount.py): K1-K4's functions
   as they need to be computed (kernels/needed_ops.cpp, each value once),
   whose counts give their bounds, and the kernels' own sources;
3. each of K1-K3 against its plain PyTorch version on the card, f32, at
   the main path's lane counts and a ragged one (K2 at all four of its
   lane counts, 512 to 290,304; K1 also at 1 and 17 lanes, ragged blocks
   of its 16, and in f64 at 1,000 and 32,256; K3 at all six of its lane
   counts, 512 to 290,304, at 1, 17 and 1,000, and in f64 at 1,000 and
   32,256); K4 (the fused PCG)
   against its plain version for J, BJ and SS on SPD and negative-definite
   systems at B = 512, N = 64, bs = 12 (20 fixed iterations, and run to
   convergence against cyclic reduction), on ragged batches, in f64, at
   each block size its register variant is built for (bs = 2-14, each at
   the most rows that variant takes), at block sizes its cluster variant
   reads at run time (one block), at the first design's largest shapes (N
   = 156 in f32, 78 in f64, bs = 12: one block; these at 12 fixed
   iterations), and at N = 256 in f64 (a cluster of 4: a shape the
   shared-memory limit refused until K4 had its cluster variant);
4. each kernel's time beside its plain version's and its bound, median of
   20, with two timers (kernels/timing.py): CUDA events around one call
   (``ms``, the yardstick of earlier runs) and device time behind a spin
   (``device_ms``); K2 and K3 at each of their lane counts, K4 at B = 512
   and 1.
   The bound is the larger of bytes / 3.35 TB/s and needed operations / 67
   TFLOP/s (f32 off the tensor cores), the H100 SXM data sheet's peaks at
   700 W (K4's operations for the iterations the timed run took);
5. in-situ: one KKT assembly and one full SQP solve of the flagship with
   the kernels on vs off, in f32 (max|dU| reported) and in f64 (equal exit
   codes and iteration counts, max|dU|/max|U| under a bar set by the gap
   that one ulp makes, and a fault of 1e-8 planted in K1's output read
   above that bar); K4 and its plain version on the
   flagship's cold-start Schur systems (relative residuals, iteration
   counts);
6. the main path: the flagship closed loop (6-DoF arm, N = 64, B = 512
   scenarios of bench.py, f32): one cold block-Thomas step, then 149
   cyclic-reduction steps through run_scheduled, with the kernels' launch
   counts (split by lane count), each kernel's episode-weighted device
   time and bound (launches x time, launches x bound, at each lane count),
   the loss between them, and the bench's quality gate; every state and
   control must be finite, and the scenarios held at the simulated arm's
   joint velocity limit (flagship.SIM_QD_MAX) are counted;
7. the PCG-SS closed loop (flagship.PCG_KNOBS, K4 on): the same episode
   with 4 SQP iterations per step and the Schur systems solved by PCG-SS,
   with K1-K4's launch counts, the same finite check and count, and the
   quality gate;
8. constrained in-situ, the torque-limited flagship (flagship.AS_KNOBS:
   +-6 on every torque, hard ACTIVE_SET rows, the condensed Schur path):
   its cold solve in f64 with the kernels on and off under phase 5's bar
   (equal exit codes and iteration counts, max|dU|/max|U| under the
   one-ulp bar, the planted fault above it); then K4 on the condensed
   Schur operator of a plan whose controls reach ~2x the limit (the
   number of active rows printed, and asserted above 0), for J, BJ and
   SS at B = 512, N = 64, bs = 12: in f64 held to pcg_fused_plain element
   by element after 20 fixed iterations, under the larger of 1e-10 and 3x
   the gap a one-ulp move of the operands makes (K4 stopped one iteration
   short must read above it), and both beside the cyclic-reduction solve
   of the same operator by relative residual (cyclic reduction's median
   under 1e-4); in f32, where rounding sets this operator's BJ and SS
   iterates, the residuals of K4, its plain version and the plain version
   on moved operands are reported;
9. the ACTIVE_SET closed loop (flagship.AS_KNOBS, 4 SQP iterations a
   step) and
10. the AUGMENTED_LAGRANGIAN closed loop (flagship.AL_KNOBS, one AL outer
   round a step), each run like phase 6 (one cold block-Thomas step, 149
   cyclic-reduction steps): wall, K1-K3's launches by lane count and
   episode-weighted device time, bound and loss, the quality gate, and
   the violation profile of analysis/constrained_flagship.md (median
   per-scenario peak |u|, max(|u| - 6) over all steps and after step 20,
   the share of applied samples with |u| >= 6 (1 - 1e-3)); every state and
   control finite, the gate passed and that share above 0 (the limit
   binds) are asserted, and for ACTIVE_SET a median peak |u| below the
   unconstrained loop's (phase 6 prints its own);
11. iLQR in-situ (flagship.ILQR_KNOBS): the iLQR cold solve in f64 with
   the kernels on and off under phase 5's bar (equal exit codes and
   iteration counts, max|dU|/max|U| under the one-ulp bar, the planted K1
   fault above it);
12. the Riccati pair: the iLQR flagship's first-iterate expansions (B =
   512, f64) solved by the sequential backward pass and by the log-depth
   one; K, kff, dv1 and dv2 held under the larger of 1e-9 and 3x the gap
   that moving the expansions by one ulp makes in the log-depth pass, and
   the log-depth pass with its combine order not swapped must read above
   that bar; each pass's events time and device operations;
13. the iLQR closed loop (flagship.ILQR_KNOBS: one cold step of 4
   iterations and the 9-rung ladder, then 149 steps of 5 iterations and
   the 3-rung ladder), run like phase 6: wall beside phase 6's, K1-K3's
   launches by lane count and episode-weighted device time, bound and
   loss, the quality gate, every state finite, K1-K3 launched and K4 not;
   one more steady step profiled (device operations, device time, busy
   share), as after phase 6;
14. integrators 2-4 (midpoint, RK3, RK4): K1's and K2's launches in one
   KKT assembly of the flagship at B = 512, counted by the lane recorder
   (2 and 3, 3 and 5, 4 and 7), then each type's flagship cold solve in
   f64 with the kernels on and off under phase 5's bar (equal exit codes
   and iteration counts, the planted K1 fault above the bar);
15. the RK4 closed loop (flagship.RK4_KNOBS), run like phase 6: wall
   beside phase 6's, K1-K3's launches by lane count and episode-weighted
   device time, bound and loss, the quality gate, every state finite,
   K1-K3 launched and K4 not; one more steady step profiled;
16. the dense KKT (method "N"): the flagship's cold solve by method "N"
   against method "S" at B = 64 in f64 (equal exit codes and iteration
   counts, max|dU|/max|U| under the larger of 1e-6 and 3x the gap a
   one-ulp move of the plain outputs makes to method "S"), K1-K3 launched
   and K4 not; one dense f32 solve of the flagship's first iterate at B =
   512 (events time, peak device memory); two scenarios' matrices made
   singular by a zeroed row: exactly they take the least-squares
   fallback, and every other scenario's solution is bit for bit that of
   the clean run;
17. RTI: the flagship's second solve, warm-started from the cold step's
   plan, in f64 at B = 512 with the kernels on and off under phase 5's
   bar, for ls_fixed_alpha = 1, with rti_lean and with rti_step_clip = 5
   (a K1 fault of 1e-6 planted above the bar: RTI's one-ulp gap is ~5e-5);
   then one lean RTI solve and one
   steady method-S solve, each at max_iter = 1, at B = 512 and 1 in f32:
   events time and device operations;
18. the per-sample oracle (ops/rbd.py, ops/kinematics.Kinematics: other
   formulations than the kernels' lane recursions) on the 32,256 states of
   the flagship's first iterate (B = 512 x 63 knots): in f64, rbd.aba and
   rbd.fd against K2 under 1e-10, rbd.fd_grad against K1 and K1's
   [-Minv idsva, Minv] against rbd.fd_grad under 1e-9, CRBA times K1's
   Minv against the identity under 1e-10, Kinematics.task_vec against K3
   under 1e-12 (each relative to max|ref|), and a fault of 1e-6 planted in
   K1's and K2's outputs above its bar; in f32 the same, reported; the
   events time of rbd.fd, rbd.fd_grad and Kinematics.task_vec beside
   K1-K3 and their lanes plain versions, and the device operations of one
   rbd.fd_grad call;
19. the per-sample flagship loop (``run_episode(use_lanes=False)``:
   URDFPlant(use_lanes=False), the cost weights and SQPOptions of the
   lanes flagship's own solvers), run like phase 6: wall beside phase
   6's, the quality gate, every state finite, K1-K4 launched 0 times; one
   more steady step profiled;
20. the utilities (utils/): solve_traced on the flagship's cold solve at
   B = 512 against solver.solve (f64: U within 1e-12 of max|U|, equal exit
   codes, iters = sqp_iters + 1; f32 reported; live rows against iters),
   cost_analysis of phase 6's profiled step (flops > 0, the device
   operations of a plain profile made just before; phase 6's count and
   the operations by name that moved since are printed), and time_fn of
   one solve beside its events time;
21. the parallel layer (parallel/) on a one-rank NCCL group (file://
   store in a temporary directory) and a DeviceMesh("cuda", (1, 1),
   ("batch", "horizon")), at the flagship's full width (B = 512, N = 64,
   K1-K3 on): shard_solve of the f32 cold solve over 'batch', bit-equal
   to solver.solve; the horizon-sharded method "S" (SPIKE) and PCG-SS
   cold solves against the unsharded solver in f64 (equal exit codes and
   iteration counts, max|dU| under the larger of the multichip dry run's
   1e-6 and 3x the gap a one-ulp move of K1-K3's outputs makes, a planted
   K1 fault of FAULT_REL above it; method "S" at one SQP iteration under
   1e-6 itself); in f32 the same solves reported beside their one-ulp
   floor, and, on the flagship's first Schur system, the sharded exact
   solve's relative residual under 10x cyclic reduction's (PCG-SS's
   beside btridiag.pcg's, reported); events ms per solve sharded beside
   unsharded, K1-K3 launches and the collectives per sharded solve (a
   one-rank group makes no P2P call);
22. the native C++ dynamics (native/, built with g++ into build/native/)
   as an oracle: K2 and K1 in f64 on 256 of the flagship's first-iterate
   states against native fd / fd_grad state by state under 1e-10
   relative, a 1e-6 fault planted in K1's output above that bar; K3's
   end-effector rows against native ee_pos under 1e-12, and its J qd rows
   against native's central-difference Jacobian under 1e-7 of max|J|
   max|qd|;
23. K4's storage dtypes (make_batched_pcg's precond_dtype /
   operator_dtype): K4 on operands stored narrow (bf16 or f16 inverses,
   bf16 inverses and blocks, f32 under f64 operands; J, BJ and SS at B =
   512, N = 64, bs = 12, and a one-block cluster at bs = 5) against
   pcg_fused_plain on the same stored operands, fixed iterations under
   phase 3's bars and run to convergence on the true residual r'r with
   equal iteration counts; on the flagship's cold-start Schur systems the
   f32 residuals, gap to the exact solution and iterations with bf16
   inverses beside f32 ones (reported);
24. K4 past the register variant's shapes: the cluster variant (one
   thread-block cluster of C <= 16 blocks per scenario, the operator in
   the cluster's shared memory; non-portable past 8) on random SPD and
   negative-definite systems, BJ and SS, at (N, bs) = (128, 12) (the
   shared operator's former shape: one block in f32, two in f64), (64,
   24), (256, 12), (1,024, 12) in f32 and f64 and (2,048, 12) f32 at B = 8
   (13 blocks), and the global operator past 16 blocks (a cluster of 16,
   its operator converted into a workspace in device memory) at (4,096,
   12) f32 and (1,280, 12) f64, B = 8, and at (8,192, 12) f64 (its
   vectors in the workspace too), against pcg_fused_plain after 3 and 20
   fixed iterations under phase 3's bars with equal counts (3: before the
   solve converges, where a halo race shows); for each shape the
   clusters resident at once
   (cudaOccupancyMaxActiveClusters), the shared memory per block and the
   workspace; the two variants timed in turn at (64, 24), (256, 12) and
   (2,048, 12), and alone at (128, 12), (4,096, 12) and (1,280, 12) f64,
   beside the bound (and the re-read floor where the operators exceed
   L2); the generic (bs = 24) Schur operator of the torque-limited
   flagship's cold QP in f64 under phase 8's bar (f32 residuals
   reported); one cold PCG-SS solve of the flagship at N = 128 and at N =
   256 (1.92 s and 3.84 s) through K1-K4 in f64 against K4's plain
   version under phase 5's bar, with a K4 exiting a decade early above
   it, and the f32 solve's events time and launches (through one block
   at N = 128, a cluster of 2 at 256);
25. the examples (trajoptmpcreference_tpu_torch.examples) on the card,
   each printing its own lines: mpc_arm6 as shipped (N = 64, 100 steps,
   QP-PCG-SS) and with --torque-limit 6, in f64 (the final end-effector
   error and max |u| held to the JAX script's own f64 CPU values under the
   larger of 1e-6 relative and 3x the loop's one-ulp spread: the loop is
   chaotic) and in f32; batch_sweep --links 6 --N 64 --n-goals 512 by
   methods S and PCG-SS (solves/s, converged count, median error);
   pendulum's three blocks; K1-K3 launched in mpc_arm6 and batch_sweep,
   and K4 in none (the examples never route PCG through it).

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON.
"""

import collections
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

B, N, STEPS, COLD_STEPS = 512, 64, 150, 1
B_DENSE = 64                              # method N vs S: 1.9 GB of f64 KKT
L_MAIN = B * (N - 1)                      # 32,256 lanes per knot sweep
L_RAGGED = 1000                           # not a multiple of the block size
L_LADDER = 3 * L_MAIN                     # the 3-rung ladder's K2 call
L_SIM = B                                 # the MPC sim step's K2 call
L_COLD = 9 * L_MAIN                       # the cold step's 9-rung ladder
K2_LANES = [L_SIM, L_RAGGED, L_MAIN, L_LADDER, L_COLD]
# K3's lane counts on the main path: the sim step's and the line search's
# terminal costs (B, 3 B, 9 B) and the knot sweeps; then a lone lane, a
# ragged block and a ragged grid
K3_LANES = [B, 3 * B, 9 * B, L_MAIN, L_LADDER, L_COLD, 1, 17, L_RAGGED]
# H100 SXM peaks (data sheet, 700 W): f32 off the tensor cores, HBM3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
TOL = {"fd_grad": 1e-4, "fd": 1e-4, "task_vec": 1e-5}   # the JAX package's own
# K1 and K3 in f64 against fd_grad_lanes / task_vec_L in f64: the same
# functions, sums in another order
TOL_F64 = 1e-10
LANES_F64 = [L_RAGGED, L_MAIN]
# the f64 kernels-on/off solve: max|dU|/max|U| under SOLVE_BAR, or under
# SOLVE_FLOOR_X times the gap that a one-ulp change of the plain outputs
# makes, whichever is larger: any change of the solve's rounding moves U by
# ~1e-6 of max|U|, whatever its size (PERF.md section 6).  A fault planted
# in K1's output, each value moved by FAULT_REL relative, must read above
# the bar; one moved by TOL_F64 (what the f64 check of K1 lets through) is
# reported.
SOLVE_BAR = 1e-6
SOLVE_FLOOR_X = 3
FAULT_REL = 1e-8
# RTI's warm second solve (phase 17) takes full QP steps at rho = 1e-3: a
# one-ulp move of the plain outputs moves its U by ~5e-5 of max|U| in f64,
# a floor that K1 moved by 1e-8 does not clear (CPU, N = 64, 32 scenarios:
# 4.9e-5 against 3.2e-5), while the gap grows linearly from 1e-7 on (1e-6:
# 3.3e-3).  There the planted fault is 1e-6, still 100x under K1's f32 bar.
RTI_FAULT_REL = 1e-6
# K4 vs its plain version, f32: max|d|/max|ref| after 20 fixed iterations,
# and each scenario's max|x - x_cr|/max|x_cr| after running to convergence
PCG_TOL, PCG_BS, PCG_FIXED_ITERS = 1e-4, 12, 20
# K4 at other shapes: fewer fixed iterations.  At tol = 0 a run stops early
# only where nu is exactly zero; with SS at bs = 2-5 nu underflows to zero
# in f32 from iteration 16, in K4 and its plain version alike, at
# iterations that rounding sets, so equal counts there would test rounding
PCG_SHAPE_ITERS = 12
# the convergence run's relative exit on nu = r' Pinv r: 1e-8 would bound
# the residual only to ~1e-4 (nu ~ |r|^2), so the error could reach the bar
PCG_CONV_TOL, PCG_CONV_ITERS = 1e-12, 200
# cyclic reduction's median relative residual on the f64 condensed
# operator (phase 8): it solves that operator, so the operator is one a
# solver can meet (the worst scenarios stay far above; PERF.md section 6)
CR_F64_TOL = 1e-4
# the torque-limited flagship's bound and the violation profile's
# thresholds (analysis/constrained_flagship.md)
TORQUE_LIMIT, AT_LIMIT_REL, STEADY_FROM = 6.0, 1e-3, 20
# phase 18: K1-K3 against the per-sample formulations in f64, each bar
# relative to max|ref| (the functions computed another way, not the same
# recursions in another order), and the fault planted in K1's and K2's
# outputs; phase 20: the traced and the untraced solve run the same
# iteration body
ORACLE_TOL = {"fd": 1e-10, "fd_grad": 1e-9, "crba": 1e-10, "task_vec": 1e-12}
ORACLE_FAULT = 1e-6
TRACE_TOL = 1e-12
# phase 21: the multichip dry run's bar for the sharded f64 solves
# (__graft_entry__.py:333), raised to SOLVE_FLOOR_X x the one-ulp gap
# where rounding alone moves U more; f32 Schur systems are held by
# residual, under RESIDUAL_X x the unsharded solve's (:304)
SHARDED_BAR, RESIDUAL_X = 1e-6, 10
# phase 22: K1-K3 against the native library, relative to each state's
# max|ref|; native's Jacobian is a central difference (h = 1e-7,
# native/dynamics.hpp ee_jacobian), good to ~1e-9, so J qd takes 1e-7
# of max|J| max|qd|
NATIVE_STATES = 256
NATIVE_TOL = {"fd": 1e-10, "fd_grad": 1e-10, "ee_pos": 1e-12, "Jqd": 1e-7}
# phase 23: K4's storage dtypes (pallas_pcg.py:365-368); the convergence
# runs exit on the true residual r'r, relative: |r| under 1e-4 |r0| in f32,
# 1e-6 in f64; in f32 at most STORAGE_EDGE of the scenarios may stop one
# iteration apart (their exit met inside f32 rounding)
STORAGE_CONV_TOL = {"torch.float32": 1e-8, "torch.float64": 1e-12}
STORAGE_EDGE = 0.01
# phase 24: K4's cluster variant (the shapes past the register variant's,
# up to 16 blocks' shared memory) on random systems, (dtype, N, bs, B): one
# block at (128, 12) f32, 2-7 blocks, 13 at (2,048, 12); its global
# operator past 16 blocks, the last with its vectors in the workspace;
# the shapes timed, (dtype, N, bs, B, the variants taken in turn); the
# H100's L2, past which the operators' re-read floor is given; the
# long-horizon flagships (dt = 0.015: 1.92 s and 3.84 s), whose planted
# fault exits a decade early
CLUSTER_SHAPES = [("float32", 128, 12, 512), ("float64", 128, 12, 512),
                  ("float32", 64, 24, 512), ("float32", 256, 12, 512),
                  ("float32", 1024, 12, 64), ("float64", 64, 24, 512),
                  ("float64", 256, 12, 512), ("float32", 2048, 12, 8)]
GLOBAL_SHAPES = [("float32", 4096, 12, 8), ("float64", 1280, 12, 8),
                 ("float64", 8192, 12, 2)]
PCG_TIMED = [("float32", 64, 24, 512, (3, 2)),
             ("float32", 256, 12, 512, (3, 2)),
             ("float32", 128, 12, 512, (3,)),
             ("float32", 2048, 12, 8, (3, 2)),
             ("float32", 4096, 12, 8, (2,)),
             ("float64", 1280, 12, 8, (2,))]
L2_BYTES = 50e6   # the H100's L2
LONG_NS, EARLY_EXIT_X = (128, 256), 10.0
# phase 25: the JAX package's mpc_arm6 on the CPU in f64 (N = 64, 100
# steps, QP-PCG-SS; tests/examples_reference.py): final end-effector error
# and max |u| applied, without and with the torque limit of 6
ARM6_JAX = {0.0: (0.23412767962265177, 4.12935119825503),
            6.0: (0.23412767962265177, 4.12935119825503)}
ARM6_TOL, ARM6_MOVES = 1e-6, 7
# the examples' child process (the pendulum and the spread loops) must end
# within this many seconds of the phase's own runs
EXAMPLES_CHILD_S = 600
REPLACES = {"fd_grad": "trajoptmpcreference_tpu/ops/lanes.py:444",
            "fd": "trajoptmpcreference_tpu/ops/lanes.py:486",
            "task_vec": "trajoptmpcreference_tpu/ops/kinematics.py:283",
            "pcg": "trajoptmpcreference_tpu/ops/pallas_pcg.py:123"}


def log(msg):
    print(msg, flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from trajoptmpcreference_tpu_torch import flagship as F
    from trajoptmpcreference_tpu_torch.kernels import _build, opcount
    from trajoptmpcreference_tpu_torch.kernels.timing import device_ms, events_ms
    from trajoptmpcreference_tpu_torch.models.plants import URDFPlant
    from trajoptmpcreference_tpu_torch.models.urdf import serial_arm
    from trajoptmpcreference_tpu_torch.ops import btridiag as BT
    from trajoptmpcreference_tpu_torch.ops import fused_pcg as FP
    from trajoptmpcreference_tpu_torch.ops import kinematics as K
    from trajoptmpcreference_tpu_torch.ops import lanes
    from trajoptmpcreference_tpu_torch.solvers.sqp import knot_params

    # ---- 1. toolchain; f32 matmuls stay full f32 (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    dev = torch.device("cuda", 0)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"[toolchain] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc '{nvcc}' device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(gpu_line())

    # ---- 2. build
    t0 = time.perf_counter()
    from trajoptmpcreference_tpu_torch.native import codegen
    with ThreadPoolExecutor(2) as pool:
        counting = pool.submit(opcount.build_all)
        native_so = pool.submit(codegen.build, serial_arm(6))
        built = _build.build_all()
        counting.result()
        native_so = native_so.result()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall (nvcc, the g++ "
        f"operation counters and the native library {native_so.name} "
        "together); per library "
        + json.dumps({k: round(v, 1) for k, v in built.items()})
        + f"; dir {_build.build_dir()}")
    for name in ("fd", "fd_grad", "task_vec"):
        extra = ""
        if name in ("fd", "fd_grad"):
            extra = ("; dynamic shared memory per block at n=6: "
                     f"{lanes.smem_bytes(name, 6, torch.float32)} bytes f32, "
                     f"{lanes.smem_bytes(name, 6, torch.float64)} bytes f64")
        log(f"[ptxas] {name} (f32, n=6): "
            + ptxas_summary(_build.ptxas_report(name), "IfLi6E") + extra)
    for name in ("fd_grad", "task_vec"):
        log(f"[ptxas] {name} (f64, n=6): "
            + ptxas_summary(_build.ptxas_report(name), "IdLi6E"))
    for tag, dt in (("f32", torch.float32), ("f64", torch.float64)):
        t = "f" if tag == "f32" else "d"
        log(f"[ptxas] pcg registers variant ({tag}, bs={PCG_BS}): "
            + ptxas_summary(_build.ptxas_report("pcg"), f"pcg_regsI{t}Li12E")
            + f"; dynamic shared memory {FP.smem_bytes(N, PCG_BS, dt)} bytes "
            f"per block at N={N}, bs={PCG_BS}")
        log(f"[ptxas] pcg cluster variant ({tag}, bs={PCG_BS}): "
            + ptxas_summary(_build.ptxas_report("pcg"),
                            f"pcg_clusterI{t}Li{PCG_BS}ELb0ELb1E")
            + f"; dynamic shared memory {FP.smem_bytes(256, PCG_BS, dt)} "
            f"bytes per block at N=256, bs={PCG_BS} "
            f"({FP.cluster_size(256, PCG_BS, dt)} blocks a scenario)")
        log(f"[ptxas] pcg cluster variant, one block ({tag}, bs={PCG_BS}): "
            + ptxas_summary(_build.ptxas_report("pcg"),
                            f"pcg_clusterI{t}Li{PCG_BS}ELb0ELb0E")
            + f"; dynamic shared memory {FP.smem_bytes(78, PCG_BS, dt)} "
            f"bytes per block at N=78, bs={PCG_BS}")
        log(f"[ptxas] pcg global operator ({tag}, bs={PCG_BS}): "
            + ptxas_summary(_build.ptxas_report("pcg"),
                            f"pcg_clusterI{t}Li{PCG_BS}ELb1ELb1E")
            + f"; dynamic shared memory {FP.smem_bytes(4096, PCG_BS, dt)} "
            f"bytes per block at N=4096, bs={PCG_BS} (16 blocks a scenario)")

    # ---- 3. kernels vs plain versions (f32, on the card)
    plant = URDFPlant(robot=serial_arm(6))
    robot, dyn, kin = plant.robot, plant.dynamics, plant.kinematics
    f32 = torch.float32

    def inputs(L, seed):
        rng = np.random.default_rng(seed)
        return [torch.as_tensor(0.3 * rng.standard_normal((6, L)), dtype=f32,
                                device=dev) for _ in range(3)]

    kernels = {
        "fd_grad": (lambda q, qd, u: lanes.fd_grad_kernel(dyn.packed(q), 6, q, qd, u),
                    lambda q, qd, u: lanes.fd_grad_lanes(robot, q, qd, u, consts=dyn.consts(q)),
                    [1, 17, L_RAGGED, L_MAIN]),
        "fd": (lambda q, qd, u: lanes.fd_kernel(dyn.packed(q), 6, q, qd, u),
               lambda q, qd, u: lanes.fd_lanes(robot, q, qd, u, consts=dyn.consts(q)),
               K2_LANES),
        "task_vec": (lambda q, qd, u: K.task_vec_kernel(kin.packed(q), 6, q, qd),
                     lambda q, qd, u: kin.task_vec_L(q, qd),
                     K3_LANES),
    }
    max_abs = {}
    for name, (kern, plain, Ls) in kernels.items():
        for i, L in enumerate(Ls):
            q, qd, u = inputs(L, 74 + i)
            out, ref = kern(q, qd, u), plain(q, qd, u)
            torch.cuda.synchronize()
            assert out.shape == ref.shape, (name, out.shape, ref.shape)
            assert bool(torch.isfinite(out).all()), name
            rel = rel_err(out, ref)
            if L == L_MAIN:
                max_abs[name] = float((out - ref).abs().max())
            del out, ref
            log(f"[check] {name} L={L}: max|d|/max|ref| = {rel:.3e} "
                f"(limit {TOL[name]:.0e})")
            assert rel < TOL[name], (name, L, rel)
    for name in ("fd_grad", "task_vec"):
        kern, plain, _ = kernels[name]
        for i, L in enumerate(LANES_F64):
            q, qd, u = (t.double() for t in inputs(L, 84 + i))
            out, ref = kern(q, qd, u), plain(q, qd, u)
            torch.cuda.synchronize()
            assert out.dtype == ref.dtype == torch.float64
            assert bool(torch.isfinite(out).all())
            rel = rel_err(out, ref)
            del out, ref
            log(f"[check] {name} f64 L={L}: max|d|/max|ref| = {rel:.3e} "
                f"(limit {TOL_F64:.0e})")
            assert rel < TOL_F64, (name, L, rel)

    max_abs["pcg"] = check_pcg(torch, BT, FP, dev)

    # ---- 4. kernel times at the main path's lane count (K4: B = 512 SS
    # systems, 40 fixed iterations), each beside its bound
    packed6 = dyn.packed(torch.zeros(1, dtype=f32, device=dev))
    per_lane = {name: opcount.count_needed(name, packed6, 6)
                for name in ("fd", "fd_grad", "task_vec")}
    done = {name: opcount.count_lanes(name, packed6, 6) for name in per_lane}
    log("[bound] operations per lane at n=6, a multiply-add counted as 2: "
        f"the functions need {json.dumps(per_lane)} (kernels/needed_ops.cpp, "
        f"the bounds' count); the kernels do {json.dumps(done)} "
        "(their own sources, every thread of a group)")
    rows = {"fd": 6, "fd_grad": 3 * 36, "task_vec": 6}   # outputs per lane
    ins = {"fd": 18, "fd_grad": 18, "task_vec": 12}       # inputs per lane
    bounds = {}

    def lane_bound(name, L):
        """(bound ms, what binds) for one call over L lanes in f32."""
        by_ops = per_lane[name] * L / PEAK_FLOPS
        by_bytes = 4 * (ins[name] + rows[name]) * L / PEAK_BYTES
        return (1e3 * max(by_ops, by_bytes),
                "operations" if by_ops >= by_bytes else "bytes")

    ms, dev_ms, plain_ms = {}, {}, {}
    for name, (kern, plain, _) in kernels.items():
        q, qd, u = inputs(L_MAIN, 90)
        plain_ms[name] = events_ms(lambda: plain(q, qd, u))
        ms[name] = events_ms(lambda: kern(q, qd, u))
        dev_ms[name] = device_ms(lambda: kern(q, qd, u))
        bounds[name] = lane_bound(name, L_MAIN)
        log(f"[time] {name} L={L_MAIN}: kernel {ms[name]:.4f} ms events, "
            f"{dev_ms[name]:.4f} ms device; plain {plain_ms[name]:.4f} ms "
            f"events; bound {bounds[name][0]:.4f} ms ({bounds[name][1]}) "
            "(medians of 20)")
    for name, Ls in (("fd", K2_LANES), ("task_vec", K3_LANES[:6])):
        kern = kernels[name][0]
        for L in Ls:
            q, qd, u = inputs(L, 90)
            call = lambda: kern(q, qd, u)
            t_ev, t_dev = events_ms(call), device_ms(call)
            bnd, by = lane_bound(name, L)
            log(f"[time] {name} L={L}: kernel {t_ev:.4f} ms events, "
                f"{t_dev:.4f} ms device; bound {bnd:.4f} ms ({by}), "
                f"{100 * bnd / t_dev:.1f}% of bound in device time (medians "
                "of 20)")
    kw = dict(precond="SS", tol=0.0, max_iter=40, relative=False)
    for Bn in (B, 1):
        S, b = random_systems(torch, BT, Bn, N, PCG_BS, 91, 1.0, f32, dev)
        ops = FP.pack_operands(S, b, "SS")
        call = lambda: FP.pcg_fused_kernel(*ops, **kw)
        t_plain = events_ms(lambda: FP.pcg_fused_plain(*ops, **kw))
        t_ev, t_dev = events_ms(call), device_ms(call)
        bnd, by, need, did, hist = pcg_bound(torch, opcount, FP, ops, kw)
        log(f"[time] pcg B={Bn} N={N} bs={PCG_BS} SS 40 iterations: kernel "
            f"{t_ev:.4f} ms events, {t_dev:.4f} ms device; plain "
            f"{t_plain:.4f} ms events; bound {bnd:.4f} ms ({by}; the function "
            f"needs {need} operations (kernels/needed_ops.cpp), the kernel "
            f"does {did}; iterations {json.dumps(hist)}), "
            f"{100 * bnd / t_dev:.1f}% of bound in device time (medians of 20)")
        if Bn == B:
            plain_ms["pcg"], ms["pcg"], dev_ms["pcg"] = t_plain, t_ev, t_dev
            bounds["pcg"] = (bnd, by)

    # ---- 5. in-situ: the flagship's KKT blocks and one solve, kernels on/off
    x0s_np, goals_np = F.bench_scenarios(B)
    x0s = torch.as_tensor(x0s_np, dtype=f32, device=dev)
    goals = torch.as_tensor(goals_np, dtype=f32, device=dev)
    X0 = x0s[..., None].expand(B, 12, N).contiguous()
    U0 = torch.zeros((B, 6, N - 1), dtype=f32, device=dev)
    solvers = {on: F.flagship(N=N, dtype=f32, device=dev, use_kernels=on)
               for on in (True, False)}
    blocks = {}
    for on, (plant, cost, solver) in solvers.items():
        p = knot_params(cost.default_params._replace(xg=goals))
        blocks[on] = solver.kkt.form_blocks(X0, U0, x0s, p, ())
    for field in ("H", "g", "A", "B", "defect"):
        a, b = getattr(blocks[True], field), getattr(blocks[False], field)
        rel = rel_err(a, b)
        log(f"[in-situ] form_blocks {field}: rel {rel:.3e} (limit 1e-4)")
        assert rel < 1e-4, (field, rel)
    sols = {}
    for on, (plant, cost, solver) in solvers.items():
        sols[on] = solver.solve(X0, U0, cost.default_params._replace(xg=goals))
    dU = float((sols[True].U - sols[False].U).abs().max())
    log(f"[in-situ] solve kernels on vs off, f32: max|dU| = {dU:.3e} "
        f"(reported), exit codes on {sols[True].exit_sqp.bincount().tolist()} "
        f"off {sols[False].exit_sqp.bincount().tolist()}")
    solve_on_off_f64(torch, F, lanes, K, x0s_np, goals_np, dev)

    insitu_pcg(torch, BT, FP, F, knot_params, X0, U0, x0s, goals, dev)

    # ---- 6. the main path
    launched = (lanes.fd_grad_kernel, lanes.fd_kernel, K.task_vec_kernel,
                FP.pcg_fused_kernel)
    loop = lambda tag, knobs: flagship_episode(
        torch, F, lanes, K, FP, x0s, goals, launched, knobs, tag,
        lambda by: episode_weighted(kernels, inputs, by, lane_bound,
                                    device_ms, tag))
    counts, free_profile = loop("[main]", {})
    main_step = one_step_profile(torch, F, x0s, goals, free_profile["res"], {},
                                 "[main]")
    main_step += (device_op_names(torch, main_step[0]),)

    # ---- 7. the PCG-SS closed loop through K4
    pcg_counts = pcg_episode(torch, F, lanes, K, FP, x0s, goals, launched)
    counts["pcg"] = pcg_counts["pcg"]
    k4 = pcg_counts["pcg"]
    log(f"[pcg] K4 episode-weighted device time: {k4} launches x "
        f"{dev_ms['pcg']:.4f} ms (40 fixed iterations, an upper bound on the "
        f"episode's) = {k4 * dev_ms['pcg']:.2f} ms; bound {k4} x "
        f"{bounds['pcg'][0]:.4f} ms = {k4 * bounds['pcg'][0]:.2f} ms; loss "
        f"{k4 * (dev_ms['pcg'] - bounds['pcg'][0]):.2f} ms")

    # ---- 8. constrained in-situ: the AS flagship, f64 on/off and K4 on
    # the condensed Schur operator
    solve_on_off_f64(torch, F, lanes, K, x0s_np, goals_np, dev,
                     knobs=F.AS_KNOBS, tag="[constrained]")
    condensed_pcg(torch, BT, FP, F, knot_params, x0s_np, goals_np, dev)

    # ---- 9, 10. the torque-limited closed loops
    for tag, knobs in (("[AS]", F.AS_KNOBS), ("[AL]", F.AL_KNOBS)):
        _, profile = loop(tag, knobs)
        if tag == "[AS]":
            log(f"[AS] median per-scenario peak |u| {profile['peak']:.4f} "
                f"against the unconstrained loop's {free_profile['peak']:.4f}"
                " (must be below)")
            assert profile["peak"] < free_profile["peak"], (
                profile, free_profile)

    # ---- 11. iLQR in-situ: the cold solve in f64, kernels on/off
    solve_on_off_f64(torch, F, lanes, K, x0s_np, goals_np, dev,
                     knobs=F.ILQR_KNOBS, tag="[iLQR on/off]")

    # ---- 12. the Riccati pair on the iLQR flagship's first iterate
    riccati_pair(torch, F, knot_params, events_ms, x0s_np, goals_np, dev)

    # ---- 13. the iLQR closed loop through K1-K3
    _, ilqr_profile = loop("[iLQR loop]", F.ILQR_KNOBS)
    one_step_profile(torch, F, x0s, goals, ilqr_profile["res"], F.ILQR_KNOBS,
                     "[iLQR loop]")
    log(f"[iLQR loop] wall {ilqr_profile['wall']:.3f} s against the method-S "
        f"loop's {free_profile['wall']:.3f} s in this run "
        f"({ilqr_profile['wall'] / free_profile['wall']:.2f}x)")

    # ---- 14. integrators 2-4: launches per KKT assembly, f64 on/off
    for itype in (2, 3, 4):
        assembly_launches(torch, F, lanes, K, knot_params, x0s, goals, itype)
        solve_on_off_f64(torch, F, lanes, K, x0s_np, goals_np, dev,
                         knobs=dict(integrator_type=itype),
                         tag=f"[integrators] type {itype}")

    # ---- 15. the RK4 closed loop through K1-K3
    _, rk4_profile = loop("[RK4 loop]", F.RK4_KNOBS)
    one_step_profile(torch, F, x0s, goals, rk4_profile["res"], F.RK4_KNOBS,
                     "[RK4 loop]")
    log(f"[RK4 loop] wall {rk4_profile['wall']:.3f} s against the method-S "
        f"loop's {free_profile['wall']:.3f} s in this run "
        f"({rk4_profile['wall'] / free_profile['wall']:.2f}x)")

    # ---- 16. the dense KKT (method "N")
    dense_kkt(torch, F, lanes, K, FP, knot_params, events_ms, x0s_np, goals_np,
              dev)

    # ---- 17. RTI: f64 on/off from the cold step's plan; one step's cost
    rti(torch, F, lanes, K, events_ms, x0s_np, goals_np, dev)

    # ---- 18. K1-K3 against the per-sample oracle
    per_sample_oracle(torch, lanes, K, events_ms, x0s_np, dev)

    # ---- 19. the per-sample flagship loop, no kernel
    _, sample_profile = loop("[per-sample loop]", dict(use_lanes=False))
    one_step_profile(torch, F, x0s, goals, sample_profile["res"],
                     dict(use_lanes=False), "[per-sample loop]")
    log(f"[per-sample loop] wall {sample_profile['wall']:.3f} s against the "
        f"method-S loop's {free_profile['wall']:.3f} s in this run "
        f"({sample_profile['wall'] / free_profile['wall']:.2f}x)")

    # ---- 20. the utilities
    utilities(torch, F, events_ms, x0s_np, goals_np, dev, main_step)

    # ---- 21. the parallel layer on a one-rank NCCL group
    parallel_layer(torch, F, lanes, K, BT, knot_params, events_ms, x0s_np,
                   goals_np, dev)

    # ---- 22. K1-K3 against the native C++ dynamics
    native_oracle(torch, lanes, K, x0s_np, dev)

    # ---- 23. K4's storage dtypes
    storage_dtypes(torch, BT, FP, F, knot_params, X0, U0, x0s, goals, dev)

    # ---- 24. K4 past the register variant's shapes: the cluster, the
    # global operator, the generic path's operator and the long-horizon
    # flagships
    beyond_shared(torch, BT, FP, F, opcount, knot_params, lanes, K,
                  events_ms, device_ms, x0s_np, goals_np, dev)

    # ---- 25. the examples on the card
    examples_on_card(torch, FP, lanes, K, dev)

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"trajoptmpcreference_tpu_torch/kernels/csrc/{name}.cu",
         "replaces": REPLACES[name], "launches": counts[name],
         "max_abs_err": max_abs[name], "ms": ms[name],
         "device_ms": dev_ms[name],
         "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name in REPLACES]}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def per_sample_oracle(torch, lanes, K, events_ms, x0s_np, dev):
    """Phase 18.  K1-K3 against the per-sample formulations (ops/rbd.py,
    ops/kinematics.Kinematics) on the 32,256 states of the flagship's first
    iterate: each scenario's x0 at its 63 knots, zero controls.  In f64
    each comparison is held under its bar relative to max|ref|, and K1's
    and K2's outputs moved by ORACLE_FAULT must read above theirs; in f32
    the same numbers are reported.  Then the f32 events times of the
    per-sample functions beside the kernels and their lanes plain
    versions, and the device operations of one rbd.fd_grad call."""
    from trajoptmpcreference_tpu_torch.models.urdf import serial_arm
    from trajoptmpcreference_tpu_torch.ops.rbd import make_rbd
    robot = serial_arm(6)
    rbd, kin = make_rbd(robot), K.Kinematics(robot)
    dyn, lkin = lanes.LaneDynamics(robot), K.LaneKinematics(robot)
    gen = torch.Generator(device=dev).manual_seed(5)

    def moved(t, rel):
        s = torch.randint(0, 2, t.shape, generator=gen, device=dev)
        return t * (1 + (2 * s - 1).to(t.dtype) * rel)

    for dtype in (torch.float64, torch.float32):
        x0s = torch.as_tensor(x0s_np, dtype=dtype, device=dev)
        X = x0s[:, None, :].expand(B, N - 1, 12).reshape(L_MAIN, 12)
        q, qd = X[:, :6].contiguous(), X[:, 6:].contiguous()
        u = torch.zeros_like(q)
        lq, lqd, lu = (a.T.contiguous() for a in (q, qd, u))
        k2 = lanes.fd_kernel(dyn.packed(lq), 6, lq, lqd, lu).T
        k1 = lanes.fd_grad_kernel(dyn.packed(lq), 6, lq, lqd, lu).permute(2, 0, 1)
        k3 = K.task_vec_kernel(lkin.packed(lq), 6, lq, lqd).T
        minv = k1[..., 12:]
        dq, dqd = rbd.idsva(q, qd, k2)
        composed = torch.cat([-(minv @ torch.cat([dq, dqd], -1)), minv], -1)
        fd_grad = rbd.fd_grad(q, qd, u)
        eye = torch.eye(6, dtype=dtype, device=dev).expand(L_MAIN, 6, 6)
        checks = [
            ("rbd.aba vs K2", k2, rbd.aba(q, qd, u), ORACLE_TOL["fd"], "fd"),
            ("rbd.fd vs K2", k2, rbd.fd(q, qd, u), ORACLE_TOL["fd"], "fd"),
            ("rbd.fd_grad vs K1", k1, fd_grad, ORACLE_TOL["fd_grad"], "fd_grad"),
            ("K1's [-Minv idsva, Minv] vs rbd.fd_grad", composed, fd_grad,
             ORACLE_TOL["fd_grad"], None),
            ("rbd.crba @ K1's Minv vs I", rbd.crba(q) @ minv, eye,
             ORACLE_TOL["crba"], None),
            ("Kinematics.task_vec vs K3", k3, kin.task_vec(q, qd),
             ORACLE_TOL["task_vec"], None),
        ]
        torch.cuda.synchronize()
        tag = "f64" if dtype == torch.float64 else "f32"
        for name, out, ref, bar, faulted in checks:
            rel = rel_err(out, ref)
            line = (f"[oracle] {name}, {tag}, L={L_MAIN}: max|d|/max|ref| = "
                    f"{rel:.3e}")
            fault = None
            if faulted is not None:
                fault = rel_err(moved(out, ORACLE_FAULT), ref)
                line += (f"; the kernel's output moved by {ORACLE_FAULT:.0e}: "
                         f"{fault:.3e}")
            if dtype == torch.float64:
                log(line + f" (bar {bar:.0e})")
                assert bool(torch.isfinite(out).all()), name
                assert rel < bar, (name, rel, bar)
                assert fault is None or fault > bar, (name, fault, bar)
            else:
                log(line + " (reported)")
        del checks, composed, fd_grad, dq, dqd

    f32 = torch.float32
    x0s = torch.as_tensor(x0s_np, dtype=f32, device=dev)
    X = x0s[:, None, :].expand(B, N - 1, 12).reshape(L_MAIN, 12)
    q, qd = X[:, :6].contiguous(), X[:, 6:].contiguous()
    u = torch.zeros_like(q)
    lq, lqd, lu = (a.T.contiguous() for a in (q, qd, u))
    C = dyn.consts(lq)
    rows = [
        ("fd", lambda: rbd.fd(q, qd, u),
         lambda: lanes.fd_kernel(dyn.packed(lq), 6, lq, lqd, lu),
         lambda: lanes.fd_lanes(robot, lq, lqd, lu, consts=C)),
        ("fd_grad", lambda: rbd.fd_grad(q, qd, u),
         lambda: lanes.fd_grad_kernel(dyn.packed(lq), 6, lq, lqd, lu),
         lambda: lanes.fd_grad_lanes(robot, lq, lqd, lu, consts=C)),
        ("task_vec", lambda: kin.task_vec(q, qd),
         lambda: K.task_vec_kernel(lkin.packed(lq), 6, lq, lqd),
         lambda: lkin.task_vec_L(lq, lqd)),
    ]
    for name, sample, kern, plain in rows:
        log(f"[oracle] {name} f32 L={L_MAIN}: per-sample "
            f"{events_ms(sample):.4f} ms, kernel {events_ms(kern):.4f} ms, "
            f"lanes plain version {events_ms(plain):.4f} ms (events, medians "
            "of 20)")
    ops, dev_ms, host_ms = device_ops(torch, lambda: rbd.fd_grad(q, qd, u))
    log(f"[oracle] one rbd.fd_grad call, f32 L={L_MAIN}: {ops} device "
        f"operations, {dev_ms:.3f} ms device time, {host_ms:.3f} ms host "
        "(torch.profiler)")


def parallel_layer(torch, F, lanes, K, BT, knot_params, events_ms, x0s_np,
                   goals_np, dev):
    """Phase 21.  The parallel layer at the flagship's full width on a
    one-rank process group (NCCL on the card) with a (1, 1) mesh of dims
    ('batch', 'horizon'): the multi-rank arithmetic is the gloo tests'
    (tests/test_torch_parallel_*.py, P = 4 and 8 on the CPU); this
    phase runs the same code through NCCL and K1-K3.

    (a) shard_solve of the f32 cold solve (phase 5's) over 'batch' is
    bit-equal to solver.solve, field by field: one rank does the same
    work.  (b) The horizon-sharded solvers (the generic Schur layout,
    the SPIKE solve for method "S", sharded PCG for PCG-SS) against the
    unsharded ones: in f64, equal exit codes and iteration counts and
    max|dU| under the larger of SHARDED_BAR and SOLVE_FLOOR_X times the
    gap a one-ulp move of K1-K3's outputs makes to the unsharded solve
    (the cold solve's own rounding floor, ~1e-6 at three iterations), with
    a FAULT_REL fault planted in K1's output above that bar, and method
    "S" at one SQP iteration under SHARDED_BAR itself; in f32 the same
    numbers reported (the f32 floor is O(1) on this cold start); and on
    the flagship's first Schur system in f32 the sharded exact solve's
    relative residual (median and whole batch) under RESIDUAL_X times
    cyclic reduction's, and the sharded PCG-SS solve's beside
    btridiag.pcg's, reported (40 f32 iterations on this system are set by
    rounding, as phase 8 finds for K4).  Each sharded solve's
    K1-K3 launches and collectives are counted from 0; a one-rank group
    makes no P2P call."""
    import tempfile

    import torch.distributed as dist

    from trajoptmpcreference_tpu_torch.parallel import make_mesh, shard_solve
    from trajoptmpcreference_tpu_torch.parallel.multihost import CALLS
    from trajoptmpcreference_tpu_torch.solvers.sqp import make_sqp
    kernels = {"fd_grad": lanes.fd_grad_kernel, "fd": lanes.fd_kernel,
               "task_vec": K.task_vec_kernel}
    plain = ((lanes.LaneDynamics, "fd"), (lanes.LaneDynamics, "fd_grad"),
             (K.LaneKinematics, "task_vec"))
    f32, f64 = torch.float32, torch.float64

    def setup(dtype, knobs, mesh):
        x0s = torch.as_tensor(x0s_np, dtype=dtype, device=dev)
        goals = torch.as_tensor(goals_np, dtype=dtype, device=dev)
        X0 = x0s[..., None].expand(B, 12, N).contiguous()
        U0 = torch.zeros((B, 6, N - 1), dtype=dtype, device=dev)
        plant, cost, solver = F.flagship(N=N, dtype=dtype, device=dev, **knobs)
        sharded = make_sqp(plant, cost, None, N, solver.dt,
                           method=solver.method, options=solver.options,
                           mesh=mesh)
        params = cost.default_params._replace(xg=goals)
        return (X0, U0, params), x0s, solver, sharded

    def counted(fn):
        """fn() with K1-K3's launches and the collectives counted from 0."""
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        CALLS.clear()
        out = fn()
        torch.cuda.synchronize()
        return out, {n: k.launches for n, k in kernels.items()}, dict(CALLS)

    def fields(res):
        return {k: v for k, v in res._asdict().items() if torch.is_tensor(v)}

    gap = lambda a, b: float((a.U - b.U).abs().max())
    with tempfile.TemporaryDirectory() as td:
        dist.init_process_group("nccl", init_method=f"file://{td}/store",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh((1, 1), ("batch", "horizon"))
            log(f"[parallel] process group: backend "
                f"{dist.get_backend()}, world size {dist.get_world_size()}; "
                f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on "
                f"{mesh.device_type}")

            # (a) the scenario split over 'batch'
            args, _, solver, _ = setup(f32, {}, mesh)
            ref = solver.solve(*args)
            shard = shard_solve(solver, mesh, "batch")
            res, launches, calls = counted(lambda: shard(*args))
            same = {k: torch.equal(v, fields(ref)[k])
                    for k, v in fields(res).items()}
            t_un = events_ms(lambda: solver.solve(*args), reps=5)
            t_sh = events_ms(lambda: shard(*args), reps=5)
            log(f"[parallel] shard_solve over 'batch', flagship cold solve "
                f"B={B} N={N} f32: bit-equal to solver.solve field by field "
                f"{json.dumps(same)}; events {t_sh:.3f} ms sharded, "
                f"{t_un:.3f} ms unsharded (median of 5); K1-K3 launches "
                f"{json.dumps(launches)}; collectives {json.dumps(calls)}")
            assert all(same.values()), same
            assert all(v > 0 for v in launches.values()), launches

            # (b) the horizon-sharded solves, f64: the bar and its floor
            for method, knobs in (("S", {}), ("PCG-SS", F.PCG_KNOBS)):
                args, _, solver, sharded = setup(f64, knobs, mesh)
                ref = solver.solve(*args)
                with moved_outputs(torch, dev, plain, 2.0 ** -52):
                    ulp = solver.solve(*args)
                res, launches, calls = counted(lambda: sharded.solve(*args))
                with moved_outputs(torch, dev, plain[1:2], FAULT_REL):
                    fault = sharded.solve(*args)
                floor, d, d_fault = gap(ulp, ref), gap(res, ref), gap(fault, ref)
                bar = max(SHARDED_BAR, SOLVE_FLOOR_X * floor)
                exits = torch.equal(res.exit_sqp, ref.exit_sqp)
                iters = torch.equal(res.sqp_iters, ref.sqp_iters)
                log(f"[parallel] horizon-sharded {method} vs unsharded, "
                    f"flagship cold solve B={B} N={N} f64: max|dU| = "
                    f"{d:.3e}; unsharded with K1-K3's outputs moved one ulp "
                    f"{floor:.3e}; bar {bar:.3e} (max of {SHARDED_BAR:.0e} "
                    f"and {SOLVE_FLOOR_X} x the one-ulp gap); K1 moved by "
                    f"{FAULT_REL:.0e} in the sharded solve {d_fault:.3e} "
                    f"(must exceed the bar); exit codes equal {exits} "
                    f"({res.exit_sqp.bincount().tolist()}), sqp_iters equal "
                    f"{iters}; K1-K3 launches {json.dumps(launches)}; "
                    f"collectives {json.dumps(calls)}; max|U| "
                    f"{float(ref.U.abs().max()):.4f}")
                assert exits and iters
                assert d < bar and d_fault > bar, (method, d, d_fault, bar)
                assert all(v > 0 for v in launches.values()), launches
                assert calls.get("p2p", 0) == 0, calls
            args, _, solver, sharded = setup(f64, dict(max_iter=1), mesh)
            ref, res = solver.solve(*args), sharded.solve(*args)
            d = gap(res, ref)
            log(f"[parallel] horizon-sharded S vs unsharded at one SQP "
                f"iteration, f64: max|dU| = {d:.3e} (bar {SHARDED_BAR:.0e}), "
                f"exit codes equal {torch.equal(res.exit_sqp, ref.exit_sqp)}")
            assert d < SHARDED_BAR and torch.equal(res.exit_sqp, ref.exit_sqp)

            # f32: the solves reported; the Schur systems held by residual
            for method, knobs in (("S", {}), ("PCG-SS", F.PCG_KNOBS)):
                args, x0s, solver, sharded = setup(f32, knobs, mesh)
                ref = solver.solve(*args)
                with moved_outputs(torch, dev, plain, 2.0 ** -23):
                    ulp = solver.solve(*args)
                res, launches, calls = counted(lambda: sharded.solve(*args))
                t_un = events_ms(lambda: solver.solve(*args), reps=5)
                t_sh = events_ms(lambda: sharded.solve(*args), reps=5)
                same = int((res.exit_sqp == ref.exit_sqp).sum())
                log(f"[parallel] horizon-sharded {method} vs unsharded, "
                    f"flagship cold solve B={B} N={N} f32: max|dU| = "
                    f"{gap(res, ref):.3e}, the one-ulp floor {gap(ulp, ref):.3e} "
                    f"(reported); equal exit codes in {same}/{B} scenarios; "
                    f"events {t_sh:.3f} ms sharded, {t_un:.3f} ms unsharded "
                    f"(median of 5); per sharded solve K1-K3 launches "
                    f"{json.dumps(launches)}, collectives {json.dumps(calls)} "
                    f"(a one-rank group makes no P2P call: the halo exchange "
                    f"returns its zero boundary rows without one)")
                assert bool(torch.isfinite(res.U).all())
                assert all(v > 0 for v in launches.values()), launches
                assert calls.get("p2p", 0) == 0, calls

                kkt, o = solver.kkt, solver.options
                X0, U0, params = args
                blocks = kkt.form_blocks(X0, U0, x0s, knot_params(params), ())
                rho = torch.full((B,), o.rho_init, dtype=f32, device=dev)
                S, gam, _, _ = kkt._schur_blocks_split(blocks, rho)
                pcg = method != "S"
                kw = dict(pcg_tol=o.exit_tolerance_linSys,
                          pcg_max_iter=o.max_iter_linSys, precond="SS",
                          pcg_relative=o.pcg_relative)
                _, lam, _ = kkt.solve_schur_sharded(blocks, rho, mesh,
                                                    "horizon", exact=not pcg,
                                                    **kw)
                if pcg:
                    lam_ref = BT.pcg(S, gam, BT.preconditioner(S, "SS"),
                                     exit_tolerance=kw["pcg_tol"],
                                     max_iter=kw["pcg_max_iter"],
                                     relative=kw["pcg_relative"]).x
                    name = "btridiag.pcg"
                else:
                    lam_ref, name = BT.btd_cyclic_reduction(S, gam), \
                        "cyclic reduction"
                S64 = BT.BlockTridiag(S.diag.double(), S.upper.double())
                g64 = gam.double().flatten(1)

                def residual(x):
                    r = BT.btd_matvec(S64, x.double()).flatten(1) - g64
                    return (float((r.norm(dim=1) / g64.norm(dim=1)).median()),
                            float(r.norm() / g64.norm()))

                r_sh, r_un = residual(lam), residual(lam_ref)
                log(f"[parallel] the flagship's first Schur system, f32: "
                    f"|S lam - gam|/|gam| of the sharded {method} solve median "
                    f"{r_sh[0]:.3e}, whole batch {r_sh[1]:.3e}; of {name} "
                    f"median {r_un[0]:.3e}, whole batch {r_un[1]:.3e} "
                    + (f"(bar {RESIDUAL_X} x, floored at 1e-6)" if not pcg
                       else "(reported: 40 f32 iterations on this system "
                       "are set by rounding)"))
                assert all(math.isfinite(v) for v in r_sh), r_sh
                for i in range(2 if not pcg else 0):
                    assert r_sh[i] < RESIDUAL_X * max(r_un[i], 1e-6), (
                        method, r_sh, r_un)
        finally:
            dist.destroy_process_group()


def native_oracle(torch, lanes, K, x0s_np, dev):
    """Phase 22.  K1-K3 in f64 on the flagship's first-iterate states of
    its first NATIVE_STATES scenarios (x0, zero controls) against the
    native C++ library (native/, NativeDynamics: the GRiD-style codegen's
    host code, another implementation in another language), state by
    state, each relative to that state's max|ref|: K2 against native fd
    and K1 against native fd_grad under 1e-10, a 1e-6 fault planted in
    K1's output above that bar; K3's end-effector rows against native
    ee_pos under 1e-12 and its J qd rows against native's
    central-difference Jacobian times qd under 1e-7 of max|J| max|qd| (the
    size of the terms J qd sums)."""
    from trajoptmpcreference_tpu_torch.models.urdf import serial_arm
    from trajoptmpcreference_tpu_torch.native import NativeDynamics
    robot = serial_arm(6)
    native = NativeDynamics(robot)
    dyn, lkin = lanes.LaneDynamics(robot), K.LaneKinematics(robot)
    x = np.asarray(x0s_np[:NATIVE_STATES], dtype=np.float64)
    q, qd, u = x[:, :6], x[:, 6:], np.zeros((len(x), 6))
    lq, lqd, lu = (torch.as_tensor(a.T.copy(), dtype=torch.float64, device=dev)
                   for a in (q, qd, u))
    k2 = lanes.fd_kernel(dyn.packed(lq), 6, lq, lqd, lu).T.cpu().numpy()
    k1 = lanes.fd_grad_kernel(dyn.packed(lq), 6, lq, lqd, lu)
    k3 = K.task_vec_kernel(lkin.packed(lq), 6, lq, lqd).T.cpu().numpy()
    gen = torch.Generator(device=dev).manual_seed(6)
    s = torch.randint(0, 2, k1.shape, generator=gen, device=dev)
    k1_fault = (k1 * (1 + (2 * s - 1).double() * ORACLE_FAULT)).permute(
        2, 0, 1).cpu().numpy()
    k1 = k1.permute(2, 0, 1).cpu().numpy()
    rows = range(len(x))
    ref = {"fd": np.stack([native.fd(q[i], qd[i], u[i]) for i in rows]),
           "fd_grad": np.stack([native.fd_grad(q[i], qd[i], u[i]) for i in rows]),
           "ee_pos": np.stack([native.ee_pos(q[i]) for i in rows]),
           "Jqd": np.stack([native.ee_jacobian(q[i]) @ qd[i] for i in rows])}
    # J qd sums terms of size max|J| max|qd|, which can cancel: its scale
    J_scale = np.array([np.abs(native.ee_jacobian(q[i])).max()
                        * np.abs(qd[i]).max() for i in rows])

    def per_state(out, r, scale=None):
        d = np.abs(out - r).reshape(len(r), -1).max(1)
        if scale is None:
            scale = np.abs(r).reshape(len(r), -1).max(1)
        return float((d / scale).max())

    outs = {"fd": k2, "fd_grad": k1, "ee_pos": k3[:, :3], "Jqd": k3[:, 3:]}
    names = {"fd": "K2 vs native fd", "fd_grad": "K1 vs native fd_grad",
             "ee_pos": "K3's end-effector rows vs native ee_pos",
             "Jqd": "K3's J qd rows vs native's central-difference J, times qd"}
    for key, out in outs.items():
        rel = per_state(out, ref[key], J_scale if key == "Jqd" else None)
        scale = "max|J| max|qd|" if key == "Jqd" else "max|ref|"
        line = (f"[native] {names[key]}, f64, {len(x)} states: worst state "
                f"max|d|/{scale} = {rel:.3e} (bar {NATIVE_TOL[key]:.0e})")
        if key == "fd_grad":
            fault = per_state(k1_fault, ref[key])
            line += (f"; K1's output moved by {ORACLE_FAULT:.0e}: {fault:.3e} "
                     "(must exceed the bar)")
            assert fault > NATIVE_TOL[key], fault
        log(line)
        assert np.isfinite(out).all(), key
        assert rel < NATIVE_TOL[key], (key, rel)


def utilities(torch, F, events_ms, x0s_np, goals_np, dev, main_step):
    """Phase 20.  solve_traced against solver.solve on the flagship's cold
    solve (phase 5's: B = 512 from bench.py's x0, zero controls): in f64 U
    within TRACE_TOL of max|U|, equal exit codes and iters = sqp_iters + 1
    per scenario; in f32 the same numbers, reported; in both the trace's
    live rows are the first ``iters`` of each scenario.  Then
    cost_analysis of phase 6's profiled step (``main_step`` = (the step,
    the device operations phase 6 printed, and their names)): flops > 0
    and the device operations of a plain-warm-up profile made just before
    (the same step's count moves later in a run: the names that changed
    since phase 6 are printed); and time_fn of one f32 solve beside its
    events time."""
    from trajoptmpcreference_tpu_torch.utils import (
        cost_analysis,
        solve_traced,
        time_fn,
    )
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        x0s = torch.as_tensor(x0s_np, dtype=dtype, device=dev)
        goals = torch.as_tensor(goals_np, dtype=dtype, device=dev)
        X0 = x0s[..., None].expand(B, 12, N).contiguous()
        U0 = torch.zeros((B, 6, N - 1), dtype=dtype, device=dev)
        _, cost, solver = F.flagship(N=N, dtype=dtype, device=dev)
        params = cost.default_params._replace(xg=goals)
        res = solver.solve(X0, U0, params)
        _, U, tr = solve_traced(solver, X0, U0, params)
        gap = rel_err(U, res.U)
        exits = torch.equal(tr.exit_code, res.exit_sqp)
        iters = torch.equal(tr.iters, res.sqp_iters + 1)
        rows = torch.arange(tr.live.shape[-1], device=dev)
        live = torch.equal(tr.live, rows < tr.iters[:, None])
        log(f"[utils] solve_traced vs solver.solve, flagship cold solve "
            f"B={B} {tag}: max|dU|/max|U| = {gap:.3e}, exit codes equal "
            f"{exits}, iters = sqp_iters + 1 {iters}, live rows = the first "
            f"iters {live}; trace fields {tuple(tr.J.shape)}, iterations "
            f"{tr.iters.bincount().tolist()}")
        assert live
        if dtype == torch.float64:
            assert gap < TRACE_TOL and exits and iters, (gap, exits, iters)
    step, step_ops, names6 = main_step
    names = device_op_names(torch, step)
    stats = cost_analysis(step)
    drift = {k: names[k] - names6[k] for k in set(names) | set(names6)
             if names[k] != names6[k]}
    log(f"[utils] cost_analysis of phase 6's profiled step: flops "
        f"{stats['flops']:.4e} (matrix products), {stats['device_ops']} device "
        f"operations, {stats['device_ms']:.2f} ms device, peak "
        f"{stats['peak_bytes'] / 2**30:.3f} GiB; the profiler after a plain "
        f"warm-up, just before: {sum(names.values())} (must be equal); phase "
        f"6 printed {step_ops}; the count of each operation now minus at "
        f"phase 6, where it moved: {json.dumps(drift)}")
    assert stats["flops"] > 0, stats
    assert stats["device_ops"] == sum(names.values()), (stats, names)
    solve = lambda: solver.solve(X0, U0, params)
    wall, _ = time_fn(solve, reps=5)
    log(f"[utils] one flagship cold solve, B={B} f32: time_fn {1e3 * wall:.3f} "
        f"ms (best of 5), events {events_ms(solve, reps=5):.3f} ms (median "
        "of 5)")


def record_lane_counts(lanes, K):
    """Count the lanes kernels' launches by (library, lane count) while the
    main path runs, through the one launch function their wrappers share;
    returns (counter, restore)."""
    seen = collections.Counter()
    original = lanes.launch

    def recording(lib_name, n, packed, out, q, qd, u=None):
        seen[(lib_name, q.shape[1])] += 1
        return original(lib_name, n, packed, out, q, qd, u)

    lanes.launch = K.launch = recording

    def restore():
        lanes.launch = K.launch = original

    return seen, restore


def episode_weighted(kernels, inputs, by_lanes, lane_bound, device_ms, tag):
    """Print each lanes kernel's launches by lane count, its episode-
    weighted device time and bound (the sums over lane counts of launches x
    the kernel's device time, median of 20 on random inputs, and of
    launches x its bound at that count) and the loss between them."""
    for name, (kern, _, _) in kernels.items():
        split = sorted((L, c) for (lib, L), c in by_lanes.items() if lib == name)
        total, bound, parts = 0.0, 0.0, []
        for L, c in split:
            q, qd, u = inputs(L, 95)
            t = device_ms(lambda: kern(q, qd, u))
            total += c * t
            bound += c * lane_bound(name, L)[0]
            parts.append(f"{c} x L={L} at {t:.4f} ms")
        log(f"{tag} {name} launches by lane count: " + ", ".join(parts)
            + f"; episode-weighted device time {total:.2f} ms, bound "
            f"{bound:.2f} ms, loss {total - bound:.2f} ms")


def pcg_bound(torch, opcount, FP, ops, kw):
    """K4's bound on these operands: the larger of bytes / 3.35 TB/s and
    the operations its function needs (needed_ops.cpp) for the iterations
    each scenario took in the kernel's run, over 67 TFLOP/s.  A scenario's
    operations depend on its iteration count alone, so one scenario,
    counted at each count the run took, gives the batch's.  Returns (bound
    ms, what binds, needed operations, operations the kernel does, the
    iteration histogram)."""
    _, iters = FP.pcg_fused_kernel(*ops, **kw)
    hist = collections.Counter(iters.tolist())
    one = [t[:1] for t in ops]
    count = lambda fn, k: fn(*one, ss=kw["precond"] == "SS",
                             relative=kw["relative"], max_iter=k, tol=0.0)
    need = sum(c * count(opcount.count_needed_pcg, k) for k, c in hist.items())
    did = sum(c * count(opcount.count_pcg, k) for k, c in hist.items())
    item = ops[3].element_size()
    nbytes = (item * (sum(t.numel() for t in ops) + ops[3].numel())
              + 4 * len(iters))
    by_ops, by_bytes = need / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(by_ops, by_bytes),
            "operations" if by_ops >= by_bytes else "bytes", need, did,
            dict(sorted(hist.items())))


def random_systems(torch, BT, B, N, bs, seed, sign, dtype, dev):
    """B random block-tridiagonal systems, SPD (sign 1) or negative
    definite (sign -1), moderately conditioned (Jacobi-preconditioned CG
    needs ~30 iterations), and right-hand sides; drawn in f64 on the host.
    The off-diagonal blocks' scale is that of bs = 12 at smaller bs, whose
    random blocks would otherwise make S indefinite."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64)
    M = rn(B, N, bs, bs) / bs ** 0.5
    diag = M @ M.transpose(-1, -2) + torch.eye(bs, dtype=torch.float64)
    upper = 0.4 * rn(B, N - 1, bs, bs) / max(bs, 12) ** 0.5
    on = lambda t: t.to(dtype=dtype, device=dev)
    return BT.BlockTridiag(on(sign * diag), on(sign * upper)), on(rn(B, N, bs))


def check_pcg(torch, BT, FP, dev):
    """K4 against pcg_fused_plain on the card; returns max|d| of the
    B = 512 SS SPD fixed-iteration check."""
    f32, f64 = torch.float32, torch.float64
    fixed = dict(tol=0.0, max_iter=PCG_FIXED_ITERS, relative=False)
    conv = dict(tol=PCG_CONV_TOL, max_iter=PCG_CONV_ITERS, relative=True)
    max_abs = None
    for sign, kind in ((1.0, "spd"), (-1.0, "negdef")):
        for pre in ("J", "BJ", "SS"):
            S, b = random_systems(torch, BT, B, N, PCG_BS, 7, sign, f32, dev)
            ops = FP.pack_operands(S, b, pre)
            out, it = FP.pcg_fused_kernel(*ops, precond=pre, **fixed)
            ref, it_ref = FP.pcg_fused_plain(*ops, precond=pre, **fixed)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(out).all()), (pre, kind)
            rel = rel_err(out, ref)
            if (pre, kind) == ("SS", "spd"):
                max_abs = float((out - ref).abs().max())
            x, it_c = FP.pcg_fused_kernel(*ops, precond=pre, **conv)
            x_cr = BT.btd_cyclic_reduction(S, b)
            per = ((x - x_cr).abs().amax((-1, -2))
                   / x_cr.abs().amax((-1, -2))).max().item()
            log(f"[check] pcg {pre} {kind} B={B} N={N}: {PCG_FIXED_ITERS} "
                f"iterations max|d|/max|ref| = {rel:.3e}; converged (rel "
                f"{PCG_CONV_TOL:.0e}, {int(it_c.min())}-{int(it_c.max())} "
                f"iterations) vs cyclic reduction, worst scenario "
                f"{per:.3e} (limit {PCG_TOL:.0e})")
            assert torch.equal(it, it_ref), (pre, kind)
            assert rel < PCG_TOL and per < PCG_TOL, (pre, kind, rel, per)
    for Bn, Nn in ((1, N), (1000, N), (B, N - 1)):
        for pre in ("J", "BJ", "SS"):
            S, b = random_systems(torch, BT, Bn, Nn, PCG_BS, Bn + Nn, 1.0,
                                  f32, dev)
            ops = FP.pack_operands(S, b, pre)
            out, _ = FP.pcg_fused_kernel(*ops, precond=pre, **fixed)
            ref, _ = FP.pcg_fused_plain(*ops, precond=pre, **fixed)
            rel = rel_err(out, ref)
            log(f"[check] pcg {pre} ragged B={Bn} N={Nn}: max|d|/max|ref| = "
                f"{rel:.3e} (limit {PCG_TOL:.0e})")
            assert rel < PCG_TOL, (pre, Bn, Nn, rel)
    # each block size the register variant is built for, at the most rows
    # it takes; block sizes the cluster variant reads at run time (one
    # block); the first design's largest shapes (one block at a built block
    # size)
    regs = lambda Nn, bs, dt=f32: FP.VARIANTS[FP.variant(Nn, bs, dt)]
    largest = lambda bs: max(Nn for Nn in range(1, 1025)
                             if FP.variant(Nn, bs, f32) == 0)
    cases = ([(bs, largest(bs), f32) for bs in range(2, 15, 2)]
             + [(5, N, f32), (3, 2 * N, f32), (PCG_BS, 156, f32),
                (PCG_BS, 78, f64)])
    shape_fixed = dict(fixed, max_iter=PCG_SHAPE_ITERS)
    for bs, Nn, dt in cases:
        S, b = random_systems(torch, BT, B, Nn, bs, 10 + bs, -1.0, dt, dev)
        limit = PCG_TOL if dt == f32 else 1e-10
        for pre in ("BJ", "SS"):
            ops = FP.pack_operands(S, b, pre)
            out, it = FP.pcg_fused_kernel(*ops, precond=pre, **shape_fixed)
            ref, it_ref = FP.pcg_fused_plain(*ops, precond=pre, **shape_fixed)
            torch.cuda.synchronize()
            rel = rel_err(out, ref)
            log(f"[check] pcg {pre} negdef {str(dt)[6:]} B={B} N={Nn} bs={bs} "
                f"({regs(Nn, bs, dt)}, {FP.smem_bytes(Nn, bs, dt)} bytes of "
                f"shared memory), {PCG_SHAPE_ITERS} iterations: "
                f"max|d|/max|ref| = {rel:.3e} (limit {limit:.0e}), iteration "
                f"counts equal {torch.equal(it, it_ref)}")
            assert torch.equal(it, it_ref), (pre, bs, Nn, dt)
            assert rel < limit, (pre, bs, Nn, dt, rel)
    # f64 at the flagship's shape (the register variant) and at a shape
    # over one block's shared memory, which the first two variants refused
    # (the cluster variant)
    for Bn, Nn, seed, sign in ((B, N, 8, -1.0), (2, 4 * N, 9, 1.0)):
        S, b = random_systems(torch, BT, Bn, Nn, PCG_BS, seed, sign, f64, dev)
        ops = FP.pack_operands(S, b, "SS")
        out, it = FP.pcg_fused_kernel(*ops, precond="SS", **fixed)
        ref, it_ref = FP.pcg_fused_plain(*ops, precond="SS", **fixed)
        rel = rel_err(out, ref)
        log(f"[check] pcg SS {'negdef' if sign < 0 else 'spd'} f64 B={Bn} "
            f"N={Nn} ({regs(Nn, PCG_BS, f64)}): max|d|/max|ref| = {rel:.3e} "
            f"(limit 1e-10), iteration counts equal {torch.equal(it, it_ref)}")
        assert torch.equal(it, it_ref), Nn
        assert rel < 1e-10, (Nn, rel)
    return max_abs


def solve_on_off_f64(torch, F, lanes, K, x0s_np, goals_np, dev, knobs=None,
                     tag="[in-situ]", start=None, fault_rel=FAULT_REL):
    """The flagship's cold solve (phase 5's; with ``knobs``, e.g. the
    torque-limited or the iLQR flagship's; with ``start`` = (X0, U0,
    multipliers), f64 tensors on the card, a warm-started solve) in f64 on
    the card with the kernels on and off; off once more with the plain versions' outputs
    moved by one ulp, the gap that a change of rounding alone makes; and
    on twice more with K1's output moved by TOL_F64 and by ``fault_rel``,
    planted faults.  Asserts equal exit codes and outer iteration counts
    on vs off (iLQR: exit codes and iterations), max|dU|/max|U| under the
    bar (SOLVE_BAR or SOLVE_FLOOR_X times the one-ulp gap, whichever is
    larger), and the ``fault_rel`` fault's gap above it."""
    f64 = torch.float64
    x0s = torch.as_tensor(x0s_np, dtype=f64, device=dev)
    goals = torch.as_tensor(goals_np, dtype=f64, device=dev)
    X0 = x0s[..., None].expand(B, 12, N).contiguous()
    U0 = torch.zeros((B, 6, N - 1), dtype=f64, device=dev)
    warm = {}
    if start is not None:
        X0, U0, warm["guess"] = start
    plain = ((lanes.LaneDynamics, "fd"), (lanes.LaneDynamics, "fd_grad"),
             (K.LaneKinematics, "task_vec"))
    runs = {"on": (True, (), 0.0), "off": (False, (), 0.0),
            "ulp": (False, plain, 2.0 ** -52),
            "parity": (True, plain[1:2], TOL_F64),
            "fault": (True, plain[1:2], fault_rel)}
    sols = {}
    for key, (on, targets, rel) in runs.items():
        _, cost, solver = F.flagship(N=N, dtype=f64, device=dev, use_kernels=on,
                                     **(knobs or {}))
        with moved_outputs(torch, dev, targets, rel):
            sols[key] = solver.solve(X0, U0, cost.default_params._replace(xg=goals),
                                     **warm)
    b = sols["off"]
    scale = b.U.abs().max()

    def gap(key):
        dU = (sols[key].U - b.U).abs()
        per = dU.amax((1, 2)) / b.U.abs().amax((1, 2)).clamp_min(1e-300)
        return (float(dU.max() / scale), float(per.max()),
                float(per.median()))

    (rel, *per), (floor, *per_floor) = gap("on"), gap("ulp")
    parity, fault = gap("parity"), gap("fault")
    bar = max(SOLVE_BAR, SOLVE_FLOOR_X * floor)
    a = sols["on"]
    exit_f, iter_f = (("exit_ilqr", "iters") if hasattr(a, "exit_ilqr")
                      else ("exit_sqp", "outer_iters"))
    exits_eq = torch.equal(getattr(a, exit_f), getattr(b, exit_f))
    iters_eq = torch.equal(getattr(a, iter_f), getattr(b, iter_f))
    log(f"{tag} solve kernels on vs off, f64: max|dU|/max|U| = {rel:.3e}, "
        f"worst scenario {per[0]:.3e}, median {per[1]:.3e}; off vs off with "
        f"the plain outputs moved one ulp: {floor:.3e}, worst "
        f"{per_floor[0]:.3e}, median {per_floor[1]:.3e}; bar {bar:.3e} (max "
        f"of {SOLVE_BAR:.0e} and {SOLVE_FLOOR_X} x the one-ulp gap)")
    log(f"{tag} f64 on vs off: exit codes equal {exits_eq}, {iter_f} equal "
        f"{iters_eq} (exit codes off "
        f"{getattr(b, exit_f).bincount().tolist()}); K1's output moved by "
        f"{TOL_F64:.0e} relative vs off: {parity[0]:.3e}, worst "
        f"{parity[1]:.3e}, median {parity[2]:.3e} (reported); by "
        f"{fault_rel:.0e}: {fault[0]:.3e}, worst {fault[1]:.3e}, median "
        f"{fault[2]:.3e} (must exceed the bar)")
    assert exits_eq and iters_eq
    assert rel < bar, (rel, bar)
    assert fault[0] > bar, (fault, bar)


def assembly_launches(torch, F, lanes, K, knot_params, x0s, goals, itype):
    """K1's and K2's launches in one KKT assembly (kkt.form_blocks) of the
    flagship integrated by ``itype`` at B = 512, f32, by the lane
    recorder: a Runge-Kutta step evaluates the dynamics at every stage
    point, each xdot one K2 and each dxdot one K1 launch over B (N - 1)
    lanes.  Asserts the counts the integrator implies."""
    stages = {2: 2, 3: 3, 4: 4}[itype]
    # step_gradient's dxdot at each stage and xdot at all but the last,
    # and step's xdot at each stage
    want = {"fd_grad": stages, "fd": 2 * stages - 1}
    _, cost, solver = F.flagship(N=N, dtype=x0s.dtype, device=x0s.device,
                                 integrator_type=itype)
    X0 = x0s[..., None].expand(B, 12, N).contiguous()
    U0 = torch.zeros((B, 6, N - 1), dtype=x0s.dtype, device=x0s.device)
    p = knot_params(cost.default_params._replace(xg=goals))
    by_lanes, restore = record_lane_counts(lanes, K)
    try:
        solver.kkt.form_blocks(X0, U0, x0s, p, ())
        torch.cuda.synchronize()
    finally:
        restore()
    got = {name: sum(c for (lib, _), c in by_lanes.items() if lib == name)
           for name in want}
    lane_counts = sorted({L for (lib, L) in by_lanes if lib in want})
    log(f"[integrators] type {itype}: one KKT assembly launches K1 "
        f"{got['fd_grad']} and K2 {got['fd']} times (the integrator implies "
        f"{want['fd_grad']} and {want['fd']}), at lane counts {lane_counts}")
    assert got == want, (itype, got, want)
    assert lane_counts == [L_MAIN], lane_counts


def dense_kkt(torch, F, lanes, K, FP, knot_params, events_ms, x0s_np, goals_np,
              dev):
    """Phase 16.  Method "N" against method "S" on the flagship's cold
    solve at B_DENSE scenarios in f64 (the KKT is (T + M)^2 = 1,920^2 a
    scenario), with K1-K4's launches counted over those solves; then the
    dense KKT of the flagship's first iterate at B = 512 in f32, solved
    once (events time, peak memory), and again with two scenarios'
    matrices singular (a zeroed row)."""
    from trajoptmpcreference_tpu_torch.solvers.kkt import solve_kkt
    f64, f32 = torch.float64, torch.float32
    x0s = torch.as_tensor(x0s_np[:B_DENSE], dtype=f64, device=dev)
    goals = torch.as_tensor(goals_np[:B_DENSE], dtype=f64, device=dev)
    X0 = x0s[..., None].expand(B_DENSE, 12, N).contiguous()
    U0 = torch.zeros((B_DENSE, 6, N - 1), dtype=f64, device=dev)
    plain = ((lanes.LaneDynamics, "fd"), (lanes.LaneDynamics, "fd_grad"),
             (K.LaneKinematics, "task_vec"))
    kernels = (lanes.fd_grad_kernel, lanes.fd_kernel, K.task_vec_kernel,
               FP.pcg_fused_kernel)
    runs = {"N": ("N", True, ()), "S": ("S", True, ()),
            "S off": ("S", False, ()), "S ulp": ("S", False, plain)}
    sols, counts = {}, {}
    for key, (method, on, targets) in runs.items():
        _, cost, solver = F.flagship(N=N, dtype=f64, device=dev, method=method,
                                     use_kernels=on)
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        with moved_outputs(torch, dev, targets, 2.0 ** -52):
            sols[key] = solver.solve(X0, U0,
                                     cost.default_params._replace(xg=goals))
        torch.cuda.synchronize()
        counts[key] = [k.launches for k in kernels]
    scale = sols["S"].U.abs().max()
    gap = lambda a, b: float((sols[a].U - sols[b].U).abs().max() / scale)
    rel, floor = gap("N", "S"), gap("S ulp", "S off")
    bar = max(SOLVE_BAR, SOLVE_FLOOR_X * floor)
    exits_eq = torch.equal(sols["N"].exit_sqp, sols["S"].exit_sqp)
    iters_eq = torch.equal(sols["N"].sqp_iters, sols["S"].sqp_iters)
    log(f"[dense KKT] cold solve B={B_DENSE} N={N} f64, method N vs S (kernels "
        f"on): max|dU|/max|U| = {rel:.3e}; S off vs S off with the plain "
        f"outputs moved one ulp: {floor:.3e}; bar {bar:.3e} (max of "
        f"{SOLVE_BAR:.0e} and {SOLVE_FLOOR_X} x the one-ulp gap); exit codes "
        f"equal {exits_eq} (N {sols['N'].exit_sqp.bincount().tolist()}), "
        f"iterations equal {iters_eq}; launches K1, K2, K3, K4 by method N "
        f"{counts['N']}, by method S {counts['S']}")
    assert exits_eq and iters_eq
    assert rel < bar, (rel, bar)
    assert all(c > 0 for c in counts["N"][:3]) and counts["N"][3] == 0, counts

    # one dense f32 solve at full width, then two planted singular scenarios
    x0s = torch.as_tensor(x0s_np, dtype=f32, device=dev)
    goals = torch.as_tensor(goals_np, dtype=f32, device=dev)
    X0 = x0s[..., None].expand(B, 12, N).contiguous()
    U0 = torch.zeros((B, 6, N - 1), dtype=f32, device=dev)
    _, cost, solver = F.flagship(N=N, dtype=f32, device=dev, method="N")
    kkt = solver.kkt
    blocks = kkt.form_blocks(X0, U0, x0s, knot_params(
        cost.default_params._replace(xg=goals)), ())
    rho = torch.full((B,), solver.options.rho_init, dtype=f32, device=dev)
    A, b = kkt.dense_kkt(blocks, rho)
    del blocks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t_ms = events_ms(lambda: solve_kkt(A, b), reps=5)
    peak = torch.cuda.max_memory_allocated()
    x, bad = solve_kkt(A, b)
    log(f"[dense KKT] one f32 solve of the flagship's first-iterate KKT, B={B} "
        f"x {A.shape[-1]}^2 ({A.numel() * A.element_size() / 1e9:.3f} GB): "
        f"{t_ms:.3f} ms events (median of 5); peak device memory "
        f"{peak / 1e9:.3f} GB, of it {(peak - base) / 1e9:.3f} GB over the "
        f"matrix and its operands already held (max_memory_allocated); "
        f"scenarios the LU could not solve {int(bad.sum())}, solution finite "
        f"{bool(torch.isfinite(x).all())}")
    assert not bool(bad.any()) and bool(torch.isfinite(x).all())
    planted = torch.zeros(B, dtype=torch.bool, device=dev)
    planted[[1, B - 2]] = True
    row = kkt.N * kkt.n + 5 * kkt.bs + 2        # a defect row of knot 5
    A[planted, row] = 0
    x2, bad2 = solve_kkt(A, b)
    same = bool((x2[~planted] == x[~planted]).all())
    log(f"[dense KKT] row {row} zeroed in scenarios "
        f"{planted.nonzero().flatten().tolist()}: the fallback took "
        f"{bad2.nonzero().flatten().tolist()}; the other scenarios bit for "
        f"bit as the clean solve {same}; the fallback's solutions finite "
        f"{bool(torch.isfinite(x2[planted]).all())}")
    assert torch.equal(bad2, planted)
    assert same
    assert bool(torch.isfinite(x2[planted]).all())


def rti(torch, F, lanes, K, events_ms, x0s_np, goals_np, dev):
    """Phase 17.  The cold step (flagship.COLD_KNOBS, f64, kernels on)
    leaves a plan and multipliers; the flagship's second solve from them
    by RTI (ls_fixed_alpha = 1; with rti_lean; with rti_step_clip = 5) is
    held kernels on vs off under phase 5's bar, with the planted K1 fault
    of RTI_FAULT_REL.  Then, in f32 from the same
    kind of plan, one lean RTI solve and one steady method-S solve (the
    3-rung ladder), each at max_iter = 1, at B = 512 and B = 1: events time
    and device operations (a finding about the least a control step
    launches)."""
    def warm(dtype):
        x0s = torch.as_tensor(x0s_np, dtype=dtype, device=dev)
        goals = torch.as_tensor(goals_np, dtype=dtype, device=dev)
        _, cost, cold = F.flagship_mpc(N=N, dtype=dtype, device=dev,
                                       **F.COLD_KNOBS)
        res = cold.run(x0s, 1, cost_params=cost.default_params._replace(xg=goals))
        X = res.X_plan_last.clone()
        X[..., 0] = res.X_applied[..., -1]
        return X, res.U_plan_last, res.lam_last, goals

    X, U, lam, _ = warm(torch.float64)
    modes = {"fixed alpha 1": dict(ls_fixed_alpha=1.0),
             "lean": dict(ls_fixed_alpha=1.0, rti_lean=True),
             "clip 5": dict(ls_fixed_alpha=1.0, rti_step_clip=5.0)}
    for name, knobs in modes.items():
        solve_on_off_f64(torch, F, lanes, K, x0s_np, goals_np, dev, knobs=knobs,
                         tag=f"[RTI] {name}", start=(X, U, lam),
                         fault_rel=RTI_FAULT_REL)
    X, U, lam, goals = warm(torch.float32)
    for label, knobs in (("lean RTI", dict(ls_fixed_alpha=1.0, rti_lean=True)),
                         ("method S, 3 rungs", {})):
        _, cost, solver = F.flagship(N=N, dtype=torch.float32, device=dev,
                                     max_iter=1, **knobs)
        for Bn in (B, 1):
            params = cost.default_params._replace(xg=goals[:Bn])
            call = lambda: solver.solve(X[:Bn], U[:Bn], params, guess=lam[:Bn])
            t_ms = events_ms(call)
            ops, dev_ms, _ = device_ops(torch, call)
            log(f"[RTI] one {label} solve at max_iter=1, B={Bn} f32: "
                f"{t_ms:.3f} ms events (median of 20); {ops} device "
                f"operations, {dev_ms:.3f} ms device time (torch.profiler)")


def device_ops(torch, fn):
    """(operations, device ms, host ms) of one call of ``fn``, after a
    warm-up call: the kernels, copies and sets it puts on the device and
    their summed device time, from torch.profiler's CUDA activity, and the
    host clock around the profiled call (the profiler's overhead
    included); utils.cost_analysis, whose first call (under the flop
    counter) is the warm-up."""
    from trajoptmpcreference_tpu_torch.utils import cost_analysis
    stats = cost_analysis(fn)
    return stats["device_ops"], stats["device_ms"], stats["host_ms"]


def device_op_names(torch, fn):
    """The device operations of one call of ``fn`` after a plain warm-up
    call, counted by name (torch.profiler's CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)


def one_step_profile(torch, F, x0s, goals, res, knobs, tag):
    """Device operations, device time and busy share of one steady control
    step continuing the episode ``res`` (its last state and warm carry);
    ``knobs`` as the episode's (``use_lanes=False``: the per-sample
    controller).  Returns (the step, its device operations)."""
    knobs = dict(knobs)
    use_lanes = knobs.pop("use_lanes", True)
    _, cost, ctrl = F.flagship_mpc(N=N, dtype=x0s.dtype, device=x0s.device,
                                   **knobs)
    if not use_lanes:
        ctrl = F.per_sample(ctrl)
    params = cost.default_params._replace(xg=goals)
    step = lambda: ctrl.run(res.X_applied[..., -1], 1, X_init=res.X_plan_last,
                            U_init=res.U_plan_last, cost_params=params,
                            cstate_init=res.cstate_last,
                            lam_init=res.lam_last)
    ops, dev_ms, host_ms = device_ops(torch, step)
    log(f"{tag} one steady step profiled (torch.profiler, B={B}): {ops} device "
        f"operations, device time {dev_ms:.2f} ms, host {host_ms:.2f} ms "
        f"under the profiler, busy share {dev_ms / host_ms:.3f}")
    return step, ops


def riccati_pair(torch, F, knot_params, events_ms, x0s_np, goals_np, dev):
    """The iLQR flagship's first-iterate expansions (the zero-control
    rollout from bench.py's x0, B scenarios, f64, the solver's rho_init)
    solved by ``backward`` (63 dependent knots) and ``backward_parallel``
    (the log-depth scan, ceil(log2 N) levels).  At this state the
    elements invert Huu + rho I = 0.011 I, and the log-depth pass's
    rounding moves its gains by ~1e-5 (the JAX package's own pair differs
    as much on the same expansions, f64 on the CPU; PERF.md section 6), so
    the two are held under the larger of 1e-9 and SOLVE_FLOOR_X times the
    gap that moving the expansions by one ulp makes in the log-depth pass;
    the log-depth pass with its combine order NOT swapped (later element
    first) must read above that bar.  Prints each pass's events time and
    device operations per call (a finding about launches, not a claim)."""
    from trajoptmpcreference_tpu_torch.solvers.ilqr import ILQRSolver
    f64 = torch.float64
    x0s = torch.as_tensor(x0s_np, dtype=f64, device=dev)
    goals = torch.as_tensor(goals_np, dtype=f64, device=dev)
    _, cost, solver = F.flagship(N=N, dtype=f64, device=dev, **F.ILQR_KNOBS)
    U0 = torch.zeros((B, 6, N - 1), dtype=f64, device=dev)
    X = torch.cat([x0s[..., None], solver._open_loop(x0s, U0)], -1)
    ex = solver._expansions(X, U0, knot_params(
        cost.default_params._replace(xg=goals)), ())
    rho = torch.full((B,), solver.options.rho_init, dtype=f64, device=dev)
    seq = solver.backward(*ex, rho)
    par = solver.backward_parallel(*ex, rho)
    gen = torch.Generator(device=dev).manual_seed(3)
    moved = [t * (1 + 2.0 ** -52 * (2 * torch.randint(
        0, 2, t.shape, generator=gen, device=dev) - 1).to(f64)) for t in ex]
    par_ulp = solver.backward_parallel(*moved, rho)
    combine = ILQRSolver._combine
    ILQRSolver._combine = staticmethod(lambda e1, e2: combine(e2, e1))
    try:
        par_unswapped = solver.backward_parallel(*ex, rho)
    finally:
        ILQRSolver._combine = staticmethod(combine)
    torch.cuda.synchronize()
    for i, name in enumerate(("K", "kff", "dv1", "dv2")):
        gap, ulp = rel_err(par[i], seq[i]), rel_err(par_ulp[i], par[i])
        wrong = rel_err(par_unswapped[i], seq[i])
        bar = max(1e-9, SOLVE_FLOOR_X * ulp)
        log(f"[Riccati] {name}: log-depth vs sequential max|d|/max|seq| = "
            f"{gap:.3e}; the log-depth pass on expansions moved one ulp "
            f"{ulp:.3e}; bar {bar:.3e} (max of 1e-9 and {SOLVE_FLOOR_X} x the "
            f"one-ulp gap); combine order not swapped {wrong:.3e} (must "
            f"exceed the bar); sequential pass on the moved expansions "
            f"{rel_err(solver.backward(*moved, rho)[i], seq[i]):.3e} "
            "(reported)")
        assert gap < bar, (name, gap, bar)
        assert wrong > bar, (name, wrong, bar)
    assert not bool(seq[4].any()) and not bool(par[4].any())
    for name, fn in (("sequential", solver.backward),
                     ("log-depth", solver.backward_parallel)):
        call = lambda: fn(*ex, rho)
        ops, dev_ms, _ = device_ops(torch, call)
        log(f"[Riccati] {name} backward pass, B={B} N={N} f64: "
            f"{events_ms(call):.3f} ms events (median of 20); {ops} device "
            f"operations per call, {dev_ms:.3f} ms device time "
            "(torch.profiler)")


def storage_dtypes(torch, BT, FP, F, knot_params, X0, U0, x0s, goals, dev):
    """Phase 23.  K4 with its packed blocks stored narrower than the
    operands (make_batched_pcg's precond_dtype / operator_dtype) against
    pcg_fused_plain on the same stored operands: J, BJ and SS at B = 512,
    N = 64, bs = 12 with bf16 or f16 inverses, and bf16 inverses and
    blocks, in f32; f32 storage under f64 operands; bf16 inverses at the
    one-block cluster's bs = 5.  PCG_FIXED_ITERS fixed iterations under the
    phase-3 bars, then both run to convergence on the true residual r'r
    (STORAGE_CONV_TOL) under the same bars, with equal iteration counts:
    in f64 in every scenario; in f32 in all but at most STORAGE_EDGE of
    the scenarios, each of those one iteration apart (there the exit
    meets the threshold inside f32 rounding: the recursive residual at
    1e-4 of |r0| carries ~1e-3 relative rounding, and J's r'r falls ~2x
    an iteration), their number reported.  Reported: on the flagship's
    cold-start Schur systems (phase 5's), the f32 residuals, the gap to
    the exact solution and the iterations with bf16 inverses against f32
    ones."""
    f32, f64, bf16, f16 = (torch.float32, torch.float64, torch.bfloat16,
                           torch.float16)
    fixed = dict(tol=0.0, max_iter=PCG_FIXED_ITERS, relative=False)
    name = lambda d: "-" if d is None else str(d)[6:]
    cases = [(f32, PCG_BS, bf16, None), (f32, PCG_BS, f16, None),
             (f32, PCG_BS, bf16, bf16), (f64, PCG_BS, f32, None),
             (f64, PCG_BS, f32, f32), (f32, 5, bf16, None)]
    for dt, bs, pre_dt, op_dt in cases:
        limit = PCG_TOL if dt == f32 else 1e-10
        conv = dict(tol=STORAGE_CONV_TOL[str(dt)], max_iter=PCG_CONV_ITERS,
                    relative=True)
        S, b = random_systems(torch, BT, B, N, bs, 40 + bs, -1.0, dt, dev)
        for pre in ("J", "BJ", "SS") if bs == PCG_BS else ("SS",):
            d, u, p, r = FP.pack_operands(S, b, pre)
            ops = (d if op_dt is None else d.to(op_dt), u, p.to(pre_dt), r)
            out, it = FP.pcg_fused_kernel(*ops, precond=pre, **fixed)
            ref, it_ref = FP.pcg_fused_plain(*ops, precond=pre, **fixed)
            xc, itc = FP.pcg_fused_kernel(*ops, precond=pre, **conv)
            xr, itr = FP.pcg_fused_plain(*ops, precond=pre, **conv)
            torch.cuda.synchronize()
            rel, relc = rel_err(out, ref), rel_err(xc, xr)
            apart = (itc - itr).abs()
            edge = 0 if dt == f64 else int(STORAGE_EDGE * B)
            log(f"[storage] pcg {pre} negdef {name(dt)} operands, inverses "
                f"{name(pre_dt)}, blocks {name(op_dt) if op_dt else name(dt)}, "
                f"B={B} N={N} bs={bs} ({FP.VARIANTS[FP.variant(N, bs, dt)]}):"
                f" {PCG_FIXED_ITERS} iterations max|d|/max|ref| = {rel:.3e}; "
                f"to r'r <= {conv['tol']:.0e} r0'r0: max|d|/max|ref| = "
                f"{relc:.3e}, {int(itc.min())}-{int(itc.max())} iterations, "
                f"counts differ in {int((apart > 0).sum())} scenarios (at "
                f"most {edge}, by one iteration) (limit {limit:.0e})")
            assert torch.equal(it, it_ref), (pre, dt, pre_dt, op_dt)
            assert int((apart > 0).sum()) <= edge and int(apart.max()) <= 1, (
                pre, dt, pre_dt, op_dt)
            assert rel < limit and relc < limit, (pre, dt, pre_dt, rel, relc)
            assert bool(torch.isfinite(xc).all())
    S, gam, kw = cold_schur(torch, F, knot_params, X0, U0, x0s, goals, dev)
    S64 = BT.BlockTridiag(S.diag.double(), S.upper.double())
    exact = BT.btd_cyclic_reduction(S64, gam.double())
    for pre_dt in (None, bf16):
        d, u, p, r = FP.pack_operands(S, gam, "SS")
        x, it = FP.pcg_fused_kernel(d, u, p if pre_dt is None else
                                    p.to(pre_dt), r, **kw)
        res, _ = schur_residual(torch, BT, S, gam, x)
        gap = ((x.double() - exact).abs().amax((1, 2))
               / exact.abs().amax((1, 2)))
        log(f"[storage] flagship cold-start Schur systems, f32, SS inverses "
            f"stored {name(pre_dt) if pre_dt else 'float32'} (exit on "
            f"{'r' + chr(39) + 'r' if pre_dt else 'nu'}, the solver's "
            f"relative {kw['tol']:g}, {kw['max_iter']} iterations): |S x - "
            f"gam|/|gam| {fmt_residual(res)}; max|x - x_exact|/max|x_exact| "
            f"per scenario median {float(gap.median()):.3e} max "
            f"{float(gap.max()):.3e}; iteration counts "
            + json.dumps(dict(sorted(collections.Counter(
                it.tolist()).items()))) + " (reported)")


@contextlib.contextmanager
def k4_as(FP, fn):
    """While in the block, the fused PCG's solves on the card call ``fn``
    in K4's place (ops/fused_pcg.make_batched_pcg looks K4 up at each
    call).  K4's wrapper counts its launches on the function its name is
    bound to, so ``fn`` carries a counter, which nothing reads."""
    saved = FP.pcg_fused_kernel
    fn.launches = 0
    FP.pcg_fused_kernel = fn
    try:
        yield
    finally:
        FP.pcg_fused_kernel = saved


def beyond_shared(torch, BT, FP, F, opcount, knot_params, lanes, K,
                  events_ms, device_ms, x0s_np, goals_np, dev):
    """Phase 24.  K4 past the register variant's shapes: the cluster
    variant (variant 3: a cluster of C <= 16 blocks per scenario, one where
    it fits, the operator in their shared memory) at CLUSTER_SHAPES and the
    global operator (variant 2: a cluster of 16 whose operator is
    converted once into a workspace in device memory) past 16 blocks at
    GLOBAL_SHAPES, on random SPD and negative-definite systems, BJ and SS,
    3 (before the solve converges) and PCG_FIXED_ITERS fixed iterations
    against pcg_fused_plain under the phase-3 bars with equal counts; for
    each shape, the clusters the card
    holds at once, the shared memory per block and the workspace; the
    variants timed in turn (through pcg_fused_kernel's ``variant``) at
    PCG_TIMED, beside the bound and, where the B operators exceed L2, the
    re-read floor; the generic (bs = 24) Schur operator of the
    torque-limited flagship's cold QP in f64 under phase 8's bar; and the
    long-horizon (N = 128, 256) PCG-SS flagship's cold solves through K4
    against K4's plain version in f64 under phase 5's bar."""
    from trajoptmpcreference_tpu_torch.kernels import _build
    fixed = dict(tol=0.0, max_iter=PCG_FIXED_ITERS, relative=False)
    lib = _build.library("pcg")
    for dname, Nn, bs, Bn in CLUSTER_SHAPES + GLOBAL_SHAPES:
        dt = getattr(torch, dname)
        item, limit = dt.itemsize, PCG_TOL if dt == torch.float32 else 1e-10
        variant = FP.variant(Nn, bs, dt)
        want = 2 if (dname, Nn, bs, Bn) in GLOBAL_SHAPES else 3
        assert variant == want, (Nn, bs, dname, variant)
        C = FP.cluster_size(Nn, bs, dt) if variant == 3 else min(Nn, 16)
        # the kernel built for this block size (0: read at run time)
        mangled = (f"pcg_clusterI{'f' if dname == 'float32' else 'd'}"
                   f"Li{bs if bs in (12, 24) else 0}ELb{int(variant == 2)}"
                   f"ELb{int(C > 1)}E")
        work = item * int(lib.tmr_pcg_work_elems(Nn, bs, item))
        where = (f"{FP.VARIANTS[variant]} of {C} blocks, "
                 f"{FP.smem_bytes(Nn, bs, dt)} bytes of shared memory per "
                 f"block, {work} bytes of workspace a scenario")
        log(f"[{'cluster' if variant == 3 else 'global'}] {dname} N={Nn} "
            f"bs={bs}: {where}; "
            f"{lib.tmr_pcg_max_clusters(Nn, bs, item)} clusters resident "
            f"at once (cudaOccupancyMaxActiveClusters); ptxas "
            + ptxas_summary(_build.ptxas_report("pcg"), mangled))
        for sign, kind in ((1.0, "spd"), (-1.0, "negdef")):
            S, b = random_systems(torch, BT, Bn, Nn, bs, 50 + Nn + bs, sign,
                                  dt, dev)
            for pre in ("BJ", "SS"):
                ops = FP.pack_operands(S, b, pre)
                # 3 iterations: before the solve converges, where a halo
                # race shows; then PCG_FIXED_ITERS
                for iters in (3, PCG_FIXED_ITERS):
                    kw = dict(fixed, max_iter=iters)
                    out, it = FP.pcg_fused_kernel(*ops, precond=pre, **kw)
                    ref, it_ref = FP.pcg_fused_plain(*ops, precond=pre, **kw)
                    torch.cuda.synchronize()
                    rel = rel_err(out, ref)
                    log(f"[{'cluster' if variant == 3 else 'global'}] pcg "
                        f"{pre} {kind} {dname} B={Bn} N={Nn} bs={bs} "
                        f"({where}): {iters} iterations max|d|/max|ref| = "
                        f"{rel:.3e} (limit {limit:.0e}), iteration counts "
                        f"equal {torch.equal(it, it_ref)}")
                    assert bool(torch.isfinite(out).all())
                    assert torch.equal(it, it_ref), (pre, kind, dname, Nn,
                                                     bs, iters)
                    assert rel < limit, (pre, kind, dname, Nn, bs, iters,
                                         rel)
            del S, b, ops, out, ref
    times = {}
    kw = dict(precond="SS", tol=0.0, max_iter=40, relative=False)
    for dname, Nn, bs, Bn, variants in PCG_TIMED:
        dt = getattr(torch, dname)
        S, b = random_systems(torch, BT, Bn, Nn, bs, 91, 1.0, dt, dev)
        ops = FP.pack_operands(S, b, "SS")
        del S, b
        t_plain = events_ms(lambda: FP.pcg_fused_plain(*ops, **kw))
        bnd, by, need, did, hist = pcg_bound(torch, opcount, FP, ops, kw)
        op_bytes = Bn * Nn * (bs * (bs + 1) + bs * bs) * dt.itemsize
        floor = (f"; the operators' {op_bytes} bytes exceed L2: re-read "
                 f"floor {1e3 * op_bytes * kw['max_iter'] / PEAK_BYTES:.4f} "
                 "ms" if op_bytes > L2_BYTES else "")
        # in turn: one variant, the other, the other, the one again
        got = collections.defaultdict(list)
        for v in variants + variants[::-1]:
            call = lambda: FP.pcg_fused_kernel(*ops, variant=v, **kw)
            got[v].append((events_ms(call), device_ms(call)))
        for v, runs in got.items():
            t_ev = min(r[0] for r in runs)
            t_dev = min(r[1] for r in runs)
            times[(dname, Nn, bs, v)] = (t_ev, t_dev, t_plain, bnd, by)
            beside = ", in turn with the other" if len(got) > 1 else ""
            C = FP.cluster_size(Nn, bs, dt) if v == 3 else min(Nn, 16)
            log(f"[time] pcg {FP.VARIANTS[v]} (C = {C}) {dname} B={Bn} "
                f"N={Nn} bs={bs} SS 40 iterations: kernel {t_ev:.4f} ms "
                f"events, {t_dev:.4f} ms device (the lower of {len(runs)} "
                f"medians of 20{beside}: device "
                + ", ".join(f"{r[1]:.4f}" for r in runs)
                + f"); plain {t_plain:.4f} ms events; bound {bnd:.4f} ms "
                f"({by}; the function needs {need} operations "
                f"(kernels/needed_ops.cpp), the variant the shape takes "
                f"does {did}; iterations {json.dumps(hist)}), "
                f"{100 * bnd / t_dev:.1f}% of bound in device time{floor}")
        del ops
    generic_pcg(torch, BT, FP, F, knot_params, x0s_np, goals_np, dev)
    for n_long in LONG_NS:
        long_horizon(torch, F, FP, lanes, K, events_ms, x0s_np, goals_np,
                     dev, n_long)
    return times


def generic_pcg(torch, BT, FP, F, knot_params, x0s_np, goals_np, dev):
    """K4 on the generic (bs = nx + m = 24) Schur operator of the
    torque-limited flagship's cold QP (AS_KNOBS, zero controls, its first
    rho), assembled by kkt.schur_blocks as the sharded solve of phase 21
    assembles it: the cluster variant at N = 64.  f64 under phase 8's bar
    (hold_pcg_f64, its planted fault above it) for SS, BJ and J; f32
    residuals reported beside cyclic reduction's and the plain version's,
    at the PCG flagship's settings (relative 1e-4, 40 iterations)."""
    gen = torch.Generator(device=dev).manual_seed(2)

    def operator(dt):
        x0s = torch.as_tensor(x0s_np, dtype=dt, device=dev)
        goals = torch.as_tensor(goals_np, dtype=dt, device=dev)
        X0 = x0s[..., None].expand(B, 12, N).contiguous()
        U0 = torch.zeros((B, 6, N - 1), dtype=dt, device=dev)
        _, cost, solver = F.flagship(N=N, dtype=dt, device=dev, **F.AS_KNOBS)
        kkt, o = solver.kkt, solver.options
        p = knot_params(cost.default_params._replace(xg=goals))
        blocks = kkt.form_blocks(X0, U0, x0s, p, ())
        S, gam, *_ = kkt.schur_blocks(
            blocks, torch.full((B,), o.rho_init, dtype=dt, device=dev))
        log(f"[generic] the generic Schur operator, {str(dt)[6:]}: B={B} "
            f"N={N} bs={S.bs} ({FP.VARIANTS[FP.variant(N, S.bs, dt)]} of "
            f"{FP.cluster_size(N, S.bs, dt)} blocks); "
            f"active hard rows {int(blocks.hact.sum())} of "
            f"{blocks.hact.numel()} (zero controls)")
        assert S.bs == 24 and FP.variant(N, S.bs, dt) == 3
        return S, gam

    S, gam = operator(torch.float64)
    for pre in ("SS", "BJ", "J"):
        hold_pcg_f64(torch, FP, S, gam, pre, gen, dev, "[generic]")
    S, gam = operator(torch.float32)
    kw = dict(tol=1e-4, max_iter=40, relative=True)
    cr, _ = schur_residual(torch, BT, S, gam, BT.btd_cyclic_reduction(S, gam))
    log(f"[generic] cyclic reduction, f32: |S x - gam|/|gam| per scenario "
        f"{fmt_residual(cr)} (reported)")
    for pre in ("SS", "BJ"):
        ops = FP.pack_operands(S, gam, pre)
        for label, fn in (("kernel", FP.pcg_fused_kernel),
                          ("plain", FP.pcg_fused_plain)):
            x, it = fn(*ops, precond=pre, **kw)
            r, _ = schur_residual(torch, BT, S, gam, x)
            log(f"[generic] pcg {pre} f32 {label} (relative 1e-4, 40 "
                f"iterations): |S x - gam|/|gam| per scenario "
                f"{fmt_residual(r)}; iteration counts "
                + json.dumps(dict(sorted(collections.Counter(
                    it.tolist()).items()))) + " (reported)")
            assert all(math.isfinite(v) for v in r), (pre, label, r)


def long_horizon(torch, F, FP, lanes, K, events_ms, x0s_np, goals_np, dev,
                 long_n):
    """One cold PCG-SS solve of the long-horizon flagship (N = long_n,
    dt = 0.015, B = 512, PCG_KNOBS, use_kernel_pcg) through K1-K4: in f64
    with K4 on against K4's plain version in its place (k4_as), equal exit
    codes and SQP iterations, max|dU|/max|U| under phase 5's bar (the
    larger of SOLVE_BAR and SOLVE_FLOOR_X times the gap the plain
    version's output moved one ulp makes); K4 exiting a decade early
    (tolerance x EARLY_EXIT_X, a planted fault) must read above it.  The
    f32 solve's events time (median of 3) and K1-K4's launches are
    reported, and its time with K4's global operator in the cluster
    variant's place (k4_as), taken in turn.  K4 takes the cluster variant
    in both dtypes (at N = 128 one block in f32, two in f64)."""
    kernel, plain = FP.pcg_fused_kernel, FP.pcg_fused_plain
    gen = torch.Generator(device=dev).manual_seed(3)

    def moved(*args, **kw):
        dx, it = plain(*args, **kw)
        s = torch.randint(0, 2, dx.shape, generator=gen, device=dev)
        return dx * (1 + (2 * s - 1).to(dx.dtype)
                     * torch.finfo(dx.dtype).eps), it

    def early(*args, tol, **kw):
        return kernel(*args, tol=EARLY_EXIT_X * tol, **kw)

    def problem(dt):
        x0s = torch.as_tensor(x0s_np, dtype=dt, device=dev)
        goals = torch.as_tensor(goals_np, dtype=dt, device=dev)
        X0 = x0s[..., None].expand(B, 12, long_n).contiguous()
        U0 = torch.zeros((B, 6, long_n - 1), dtype=dt, device=dev)
        _, cost, solver = F.flagship(N=long_n, dtype=dt, device=dev,
                                     use_kernel_pcg=True, **F.PCG_KNOBS)
        return solver, X0, U0, cost.default_params._replace(xg=goals)

    solver, X0, U0, params = problem(torch.float64)
    bs = solver.kkt.bs
    for dt in (torch.float64, torch.float32):
        assert FP.variant(long_n, bs, dt) == 3, dt
    sols = {}
    for key, fn in (("on", kernel), ("off", plain), ("ulp", moved),
                    ("fault", early)):
        with k4_as(FP, fn):
            sols[key] = solver.solve(X0, U0, params)
    b = sols["off"]
    gap = lambda key: float((sols[key].U - b.U).abs().max() / b.U.abs().max())
    rel, floor, fault = gap("on"), gap("ulp"), gap("fault")
    bar = max(SOLVE_BAR, SOLVE_FLOOR_X * floor)
    a = sols["on"]
    exits_eq = torch.equal(a.exit_sqp, b.exit_sqp)
    iters_eq = torch.equal(a.sqp_iters, b.sqp_iters)
    log(f"[long] PCG-SS flagship N={long_n} (horizon {long_n * F.DT:.2f} s) "
        f"B={B} bs={bs} cold solve, f64 (K4's cluster variant of "
        f"{FP.cluster_size(long_n, bs, torch.float64)} blocks): "
        f"K4 vs its plain version max|dU|/max|U| = {rel:.3e}; plain with "
        f"its output moved one ulp {floor:.3e}; bar {bar:.3e} (max of "
        f"{SOLVE_BAR:.0e} and {SOLVE_FLOOR_X} x the one-ulp gap); K4 exiting "
        f"at {EARLY_EXIT_X:g}x its tolerance {fault:.3e} (must exceed the "
        f"bar); exit codes equal {exits_eq} ({b.exit_sqp.bincount().tolist()}"
        f"), SQP iterations equal {iters_eq}")
    assert exits_eq and iters_eq
    assert rel < bar, (rel, bar)
    assert fault > bar, (fault, bar)
    del sols, a, b
    solver, X0, U0, params = problem(torch.float32)
    kernels = (lanes.fd_grad_kernel, lanes.fd_kernel, K.task_vec_kernel,
               kernel)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    res = solver.solve(X0, U0, params)
    torch.cuda.synchronize()
    counts = [k.launches for k in kernels]
    def solve():
        return solver.solve(X0, U0, params)

    t = events_ms(solve, reps=3)
    with k4_as(FP, lambda *a, **kw: kernel(*a, variant=2, **kw)):
        t_global = events_ms(solve, reps=3)
    t_again = events_ms(solve, reps=3)
    log(f"[long] PCG-SS flagship N={long_n} B={B} cold solve, f32 (K4's "
        f"cluster variant of {FP.cluster_size(long_n, bs, torch.float32)} "
        f"blocks): {t:.3f} ms events (median of 3; {t_again:.3f} after "
        f"the global operator's turn); with K4's global operator in its "
        f"place {t_global:.3f} ms; launches K1 "
        f"{counts[0]}, K2 {counts[1]}, K3 "
        f"{counts[2]}, K4 {counts[3]}; exit codes "
        f"{res.exit_sqp.bincount().tolist()}, U finite "
        f"{bool(torch.isfinite(res.U).all())}")
    assert all(c > 0 for c in counts), counts


def examples_on_card(torch, FP, lanes, K, dev):
    """Phase 25.  The examples (trajoptmpcreference_tpu_torch.examples) on
    the card, each printing its own lines: mpc_arm6 as shipped and with
    --torque-limit 6, in f64 (its final end-effector error and max |u|
    held to the JAX script's f64 CPU values, ARM6_JAX, under the larger of
    ARM6_TOL relative and SOLVE_FLOOR_X times the loop's one-ulp spread,
    arm6_spread) and in f32; batch_sweep --links 6 --N 64 --n-goals 512 by
    methods S and PCG-SS; pendulum's three blocks.  K1-K3 must launch in
    mpc_arm6 and batch_sweep (the pendulum is an analytic plant: no
    kernel); no example routes PCG through K4.  The pendulum (host-bound
    at one scenario) and the two spread loops run in a child process
    (examples_child) beside the rest, which the phase joins at its end."""
    from trajoptmpcreference_tpu_torch.examples import batch_sweep, mpc_arm6
    child = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.examples_child()"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    kernels = {"fd_grad": lanes.fd_grad_kernel, "fd": lanes.fd_kernel,
               "task_vec": K.task_vec_kernel, "pcg": FP.pcg_fused_kernel}

    def counted(tag, fn):
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {name: k.launches for name, k in kernels.items()}
        log(f"[examples] {tag}: launches {json.dumps(counts)}")
        assert min(counts["fd_grad"], counts["fd"], counts["task_vec"]) > 0
        assert counts["pcg"] == 0
        return out

    try:
        arm6 = {}
        for dt in (torch.float64, torch.float32):
            for limit in (0.0, TORQUE_LIMIT):
                tag = (f"mpc_arm6 --torque-limit {limit:g} --dtype "
                       f"{str(dt)[6:]}")
                log(f"[examples] {tag}:")
                out = counted(tag, lambda: mpc_arm6.run(
                    torque_limit=limit, device=dev, dtype=dt, warmup=0))
                assert math.isfinite(out["ee_err"]), out["ee_err"]
                if dt == torch.float64:
                    arm6[limit] = (tag, out)
        for method in ("S", "PCG-SS"):
            tag = (f"batch_sweep --links 6 --N {N} --n-goals {B} --method "
                   f"{method}")
            log(f"[examples] {tag}:")
            out = counted(tag, lambda: batch_sweep.sweep(
                links=6, n_goals=B, N=N, method=method, device=dev,
                warmup=0))
            assert bool(torch.isfinite(out["res"].X).all())
        text, _ = child.communicate(timeout=EXAMPLES_CHILD_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    log(text.rstrip())
    assert child.returncode == 0, "the examples' child process failed"
    spreads = json.loads(text.strip().splitlines()[-1])
    for limit, (tag, out) in arm6.items():
        spread = spreads[f"{limit:g}"]
        for i, field in enumerate(("ee_err", "max_abs_u")):
            want, got = ARM6_JAX[limit][i], out[field]
            bar = max(ARM6_TOL * abs(want), SOLVE_FLOOR_X * spread[i])
            log(f"[examples] {tag}: {field} {got!r} against the JAX script's "
                f"f64 CPU value {want!r}: |d| {abs(got - want):.3e}; the "
                f"loop's one-ulp spread {spread[i]:.3e}; bar {bar:.3e} (max "
                f"of {ARM6_TOL:.0e} relative and {SOLVE_FLOOR_X} x the "
                f"spread)")
            assert abs(got - want) < bar, (tag, field, got, want, bar)


def examples_child():
    """Phase 25's child process: the pendulum example's three blocks on
    the card (no warm-up run: it launches no kernel), then mpc_arm6's
    one-ulp spread in f64 without and with the torque limit; its last
    line is the spreads as JSON."""
    import torch
    from trajoptmpcreference_tpu_torch.examples import mpc_arm6, pendulum
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print("[examples] pendulum (child process):", flush=True)
    out = pendulum.run(device=dev, warmup=0)
    assert all(bool(torch.isfinite(r.X_applied).all())
               for r, _ in out["mpc"].values())
    spreads = {f"{limit:g}": arm6_spread(torch, mpc_arm6, limit, dev)
               for limit in (0.0, TORQUE_LIMIT)}
    print(json.dumps(spreads), flush=True)


def arm6_spread(torch, mpc_arm6, limit, dev):
    """mpc_arm6's one-ulp spread in f64 on the card: one batched closed
    loop (100 steps) of its x0 and ARM6_MOVES copies of x0 each moved by
    +-1 ulp per element; the largest gap of the moved copies' final
    end-effector error and max |u| to the unmoved one's.  The loop is
    chaotic (a one-ulp move of x0 reaches O(1) in the state by step 50 on
    the CPU), so its final values are held by this spread."""
    plant, ctrl, x0 = mpc_arm6.config(torque_limit=limit, device=dev,
                                      dtype=torch.float64)
    g = torch.Generator(device=dev).manual_seed(4)
    s = 2 * torch.randint(0, 2, (ARM6_MOVES, 12), generator=g, device=dev) - 1
    xb = torch.cat([x0, x0 * (1 + s.to(x0.dtype) * torch.finfo(x0.dtype).eps)])
    res = ctrl.run(xb, steps=mpc_arm6.steps)
    goal = torch.tensor(mpc_arm6.GOAL, dtype=x0.dtype, device=dev)
    err = torch.linalg.norm(plant.kinematics.ee_pos_x(
        res.X_applied[:, :, -1]) - goal, dim=1)
    umax = res.U_applied.abs().amax((1, 2))
    return [float((t[1:] - t[0]).abs().max()) for t in (err, umax)]


def moved_one_ulp(torch, ops, gen, dev):
    """Each tensor of ``ops`` times 1 + s eps, s = +-1 per element."""
    eps = torch.finfo(ops[0].dtype).eps
    return [t * (1 + eps * (2 * torch.randint(
        0, 2, t.shape, generator=gen, device=dev) - 1).to(t.dtype))
        for t in ops]


def schur_residual(torch, BT, S, gam, x):
    """((median, max) per-scenario |S x - gam| / |gam|, the whole batch's),
    and the per-scenario values, in f64."""
    S64 = BT.BlockTridiag(S.diag.double(), S.upper.double())
    g64 = gam.double().flatten(1)
    res = BT.btd_matvec(S64, x.reshape(gam.shape).double()).flatten(1) - g64
    rel = res.norm(dim=1) / g64.norm(dim=1)
    return (float(rel.median()), float(rel.max()),
            float(res.norm() / g64.norm())), rel


def fmt_residual(r):
    return f"median {r[0]:.3e} max {r[1]:.3e} whole batch {r[2]:.3e}"


def hold_pcg_f64(torch, FP, S, gam, pre, gen, dev, tag):
    """Phase 8's bar for K4 on one f64 Schur operator: K4 and its plain
    version run PCG_FIXED_ITERS fixed iterations and are held element by
    element, max|d|/max|ref|, under the larger of 1e-10 and SOLVE_FLOOR_X
    times the gap that moving the operands by one ulp makes in the plain
    version; K4 stopped one iteration short (a planted fault) must read
    above that bar; equal iteration counts.  Returns the packed operands."""
    fixed = dict(tol=0.0, max_iter=PCG_FIXED_ITERS, relative=False)
    short = dict(fixed, max_iter=PCG_FIXED_ITERS - 1)
    ops = FP.pack_operands(S, gam, pre)
    out, it = FP.pcg_fused_kernel(*ops, precond=pre, **fixed)
    ref, it_ref = FP.pcg_fused_plain(*ops, precond=pre, **fixed)
    ulp = rel_err(FP.pcg_fused_plain(*moved_one_ulp(torch, ops, gen, dev),
                                     precond=pre, **fixed)[0], ref)
    early = rel_err(FP.pcg_fused_kernel(*ops, precond=pre, **short)[0], ref)
    rel, bar = rel_err(out, ref), max(1e-10, SOLVE_FLOOR_X * ulp)
    log(f"{tag} pcg {pre} f64, {PCG_FIXED_ITERS} iterations: "
        f"kernel vs plain max|d|/max|ref| = {rel:.3e}; plain on the "
        f"operands moved one ulp {ulp:.3e}; bar {bar:.3e} (max of 1e-10 "
        f"and {SOLVE_FLOOR_X} x the one-ulp gap); the kernel stopped at "
        f"{PCG_FIXED_ITERS - 1} iterations {early:.3e} (must exceed the "
        f"bar); iteration counts equal {torch.equal(it, it_ref)}")
    assert bool(torch.isfinite(out).all()), pre
    assert torch.equal(it, it_ref), pre
    assert rel < bar, (pre, rel, bar)
    assert early > bar, (pre, early, bar)
    return ops


def condensed_pcg(torch, BT, FP, F, knot_params, x0s_np, goals_np, dev):
    """K4 and its plain version on the condensed Schur operator of the
    torque-limited (ACTIVE_SET) flagship, from a plan whose controls reach
    about twice the limit, at its first QP's rho, for J, BJ and SS.

    The bar is in f64.  This cold-start operator is so ill-conditioned
    that in f32 the BJ and SS iterates are set by rounding (the plain
    version on operands moved by one ulp lands elsewhere), so no f32 bar,
    by element or by residual, tells a right kernel from a wrong one.  In
    f64 both run PCG_FIXED_ITERS fixed
    iterations and are held element by element, max|d|/max|ref|, under
    the larger of 1e-10 and SOLVE_FLOOR_X times the gap that moving the
    operands by one ulp makes in the plain version; K4 stopped one
    iteration short must read above that bar.  Both then run the solver's
    own PCG settings beside the cyclic-reduction solve of the same
    operator, by relative residual: cyclic reduction's median (it solves
    the operator) must be under CR_F64_TOL, PCG's are reported.  The f32
    operator's residuals are reported beside the plain version's on
    operands moved by one ulp, the spread rounding alone makes.  Asserts
    active rows > 0 and every result finite."""
    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.Generator(device="cpu").manual_seed(12)
    U0 = 2 * TORQUE_LIMIT * (2 * torch.rand((B, 6, N - 1), generator=g) - 1)

    def operator(dt):
        x0s = torch.as_tensor(x0s_np, dtype=dt, device=dev)
        goals = torch.as_tensor(goals_np, dtype=dt, device=dev)
        X0 = x0s[..., None].expand(B, 12, N).contiguous()
        _, cost, solver = F.flagship(N=N, dtype=dt, device=dev, **F.AS_KNOBS)
        kkt, o = solver.kkt, solver.options
        assert kkt._can_condense_hard()
        p = knot_params(cost.default_params._replace(xg=goals))
        blocks = kkt.form_blocks(X0, U0.to(dtype=dt, device=dev), x0s, p, ())
        active = int(blocks.hact.sum())
        S, gam, _ = kkt._schur_blocks_condensed(
            blocks, torch.full((B,), o.rho_init, dtype=dt, device=dev))
        log(f"[constrained] condensed Schur operator, {str(dt)[6:]}: B={B} "
            f"N={N} bs={S.bs} (the hard rows eliminated; the generic path's "
            f"bs would be {kkt.bs}); active hard rows {active} of "
            f"{blocks.hact.numel()} (U0 uniform in +-{2 * TORQUE_LIMIT:g}, "
            f"limit +-{TORQUE_LIMIT:g})")
        assert active > 0
        assert S.bs == 12
        return S, gam, o

    S, gam, o = operator(torch.float64)
    cr, _ = schur_residual(torch, BT, S, gam, BT.btd_cyclic_reduction(S, gam))
    log(f"[constrained] cyclic reduction, f64: |S x - gam|/|gam| per "
        f"scenario {fmt_residual(cr)} (limit on the median {CR_F64_TOL:.0e})")
    assert cr[0] < CR_F64_TOL, cr
    kw = dict(tol=o.exit_tolerance_linSys, max_iter=o.max_iter_linSys,
              relative=o.pcg_relative)
    for pre in ("SS", "BJ", "J"):
        ops = hold_pcg_f64(torch, FP, S, gam, pre, gen, dev, "[constrained]")
        for name, fn in (("kernel", FP.pcg_fused_kernel),
                         ("plain", FP.pcg_fused_plain)):
            x, it = fn(*ops, precond=pre, **kw)
            r, _ = schur_residual(torch, BT, S, gam, x)
            log(f"[constrained] pcg {pre} f64 {name}, the solver's settings "
                f"(relative {kw['tol']:g}, {kw['max_iter']} iterations): "
                f"|S x - gam|/|gam| per scenario {fmt_residual(r)} ({r[2] / cr[2]:.3e} "
                f"x cyclic reduction's); iteration counts "
                + json.dumps(dict(sorted(collections.Counter(
                    it.tolist()).items()))))
            assert all(math.isfinite(v) for v in r), (pre, name, r)

    S, gam, o = operator(torch.float32)
    cr, _ = schur_residual(torch, BT, S, gam, BT.btd_cyclic_reduction(S, gam))
    log(f"[constrained] cyclic reduction, f32: |S x - gam|/|gam| per "
        f"scenario {fmt_residual(cr)} (reported)")
    for pre in ("SS", "BJ", "J"):
        ops = FP.pack_operands(S, gam, pre)
        runs = (("kernel", FP.pcg_fused_kernel, ops),
                ("plain", FP.pcg_fused_plain, ops),
                ("plain, operands moved one ulp", FP.pcg_fused_plain,
                 moved_one_ulp(torch, ops, gen, dev)))
        rels = {}
        for name, fn, args in runs:
            x, _ = fn(*args, precond=pre, **kw)
            r, rels[name] = schur_residual(torch, BT, S, gam, x)
            log(f"[constrained] pcg {pre} f32 {name}, the solver's settings: "
                f"|S x - gam|/|gam| per scenario {fmt_residual(r)} (reported)")
            assert all(math.isfinite(v) for v in r), (pre, name, r)
        apart = []
        for name, _, _ in runs[::2]:
            ratio = rels[name] / rels["plain"]
            ratio = torch.maximum(ratio, 1 / ratio)
            apart.append(f"{name} {int((ratio > 2).sum())} (largest ratio "
                         f"{float(ratio.max()):.3e})")
        log(f"[constrained] pcg {pre} f32: scenarios whose residual lies more "
            f"than 2x from the plain version's: " + ", ".join(apart)
            + " (reported)")


def violation_profile(torch, res, tag, label):
    """The applied torques' profile against the +-6 limit
    (analysis/constrained_flagship.md): median over scenarios of the peak
    |u|, max(|u| - 6) over all steps and after STEADY_FROM, the share of
    applied samples with |u| >= 6 (1 - 1e-3).  Printed and returned."""
    u = res.U_applied.abs()
    steady = u[..., STEADY_FROM:]
    out = dict(peak=float(u.amax((1, 2)).median()),
               viol=float(u.max() - TORQUE_LIMIT),
               steady_viol=(float(steady.max() - TORQUE_LIMIT)
                            if steady.numel() else math.nan),
               share=float((u >= TORQUE_LIMIT * (1 - AT_LIMIT_REL))
                           .double().mean()))
    log(f"{tag} violation profile ({label}): median per-scenario peak |u| "
        f"{out['peak']:.4f}, max(|u| - {TORQUE_LIMIT:g}) {out['viol']:.4f} "
        f"over all steps, {out['steady_viol']:.4f} after step {STEADY_FROM}, "
        f"share of applied samples with |u| >= {TORQUE_LIMIT:g} (1 - "
        f"{AT_LIMIT_REL:g}) {out['share']:.5f}")
    return out


def flagship_episode(torch, F, lanes, K, FP, x0s, goals, launched, knobs,
                     tag, weighted):
    """The flagship closed loop (phase 6; with the torque-limited knobs,
    phases 9 and 10; with the iLQR knobs, phase 13; with the RK4 knobs,
    phase 15; with use_lanes=False, on the per-sample plant, phase 19):
    one cold step (SQP: block-Thomas), then the steady steps (SQP: cyclic
    reduction), launches counted from 0 over the loop alone, K1-K3's by
    lane count; wall, quality, episode-weighted device time and the
    violation profile.  Asserts finite states and controls, the gate,
    K1-K3 launched (the per-sample loop: none of them), no K4 launch, and,
    with a torque limit, the limit binding (a share at the limit above 0).
    Returns (launch counts, profile with the wall)."""
    by_lanes, restore = record_lane_counts(lanes, K)
    torch.cuda.synchronize()
    for k in launched:
        k.launches = 0
    t0 = time.perf_counter()
    plant, res = F.run_episode(x0s, goals, steps=STEPS, cold_steps=COLD_STEPS,
                               N=N, **knobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    restore()
    counts = {"fd_grad": lanes.fd_grad_kernel.launches,
              "fd": lanes.fd_kernel.launches,
              "task_vec": K.task_vec_kernel.launches}
    assert FP.pcg_fused_kernel.launches == 0    # methods S and iLQR run no PCG
    use_lanes = knobs.get("use_lanes", True)
    limited = knobs.get("torque_limit", 0.0) > 0
    if not use_lanes:
        label = (f"per-sample flagship (URDFPlant(use_lanes=False)), "
                 f"{COLD_STEPS} cold thomas + {STEPS - COLD_STEPS} cr")
    elif knobs.get("method") == "iLQR":
        label = (f"iLQR flagship {json.dumps(knobs)}, {COLD_STEPS} cold "
                 f"(4 iterations, 9 rungs) + {STEPS - COLD_STEPS} steady")
    else:
        label = ((f"torque-limited flagship {json.dumps(knobs)}" if limited
                  else f"unconstrained flagship {json.dumps(knobs)}" if knobs
                  else "unconstrained flagship")
                 + f", {COLD_STEPS} cold thomas + {STEPS - COLD_STEPS} cr")
    gate_ok, finite = report_loop(torch, F, plant, x0s, goals, res, wall,
                                  counts, tag, label)
    if use_lanes:
        weighted(by_lanes)
    profile = violation_profile(torch, res, tag, label)
    profile["wall"], profile["res"] = wall, res
    # the lanes loops launch K1-K3; the per-sample loop none of them
    assert all((v > 0) == use_lanes for v in counts.values()), counts
    assert finite
    assert res.X_applied.shape == (B, 12, STEPS + 1)
    assert gate_ok
    if limited:
        assert profile["share"] > 0, profile
    return counts, profile


@contextlib.contextmanager
def moved_outputs(torch, dev, targets, rel):
    """While in the block, each ``(cls, method)`` of ``targets`` returns
    its output times 1 + s rel, s = +-1 per element from a fixed seed."""
    gen = torch.Generator(device=dev).manual_seed(0)
    saved = [(cls, name, getattr(cls, name)) for cls, name in targets]

    def moved(fn):
        def call(self, *args):
            out = fn(self, *args)
            s = torch.randint(0, 2, out.shape, generator=gen, device=dev)
            return out * (1 + (2 * s - 1).to(out.dtype) * rel)
        return call

    for cls, name, fn in saved:
        setattr(cls, name, moved(fn))
    try:
        yield
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def cold_schur(torch, F, knot_params, X0, U0, x0s, goals, dev):
    """The PCG-SS flagship's cold-start Schur systems (its first QP at
    rho = 1e-3) in X0's dtype, and the solver's PCG settings (SS, relative
    exit 1e-4, 40 iterations): (S, gam, kw)."""
    dt = X0.dtype
    _, cost, solver = F.flagship(N=N, dtype=dt, device=dev,
                                 use_kernel_pcg=True, **F.PCG_KNOBS)
    kkt, o = solver.kkt, solver.options
    p = knot_params(cost.default_params._replace(xg=goals))
    blocks = kkt.form_blocks(X0, U0, x0s, p, ())
    S, gam, _, _ = kkt._schur_blocks_split(
        blocks, torch.full((B,), o.rho_init, dtype=dt, device=dev))
    return S, gam, dict(precond="SS", tol=o.exit_tolerance_linSys,
                        max_iter=o.max_iter_linSys, relative=o.pcg_relative)


def insitu_pcg(torch, BT, FP, F, knot_params, X0, U0, x0s, goals, dev):
    """K4 and its plain version on the flagship's cold-start Schur systems
    (the PCG-SS flagship's first QP at rho = 1e-3, relative exit 1e-4, 40
    iterations).  Those systems have condition ~1e7-1e9, so the check is
    on residuals, not elements."""
    S, gam, kw = cold_schur(torch, F, knot_params, X0, U0, x0s, goals, dev)
    ops = FP.pack_operands(S, gam, "SS")
    S64 = BT.BlockTridiag(S.diag.double(), S.upper.double())
    g64 = gam.double().flatten(1)
    stats = {}
    for name, fn in (("kernel", FP.pcg_fused_kernel),
                     ("plain", FP.pcg_fused_plain)):
        x, it = fn(*ops, **kw)
        res = (BT.btd_matvec(S64, x.double()).flatten(1) - g64)
        rel = res.norm(dim=1) / g64.norm(dim=1)
        stats[name] = (float(rel.median()), float(res.norm() / g64.norm()))
        hist = torch.bincount(it.long(), minlength=kw["max_iter"] + 1)
        log(f"[in-situ] pcg {name}: |S x - gam|/|gam| per scenario median "
            f"{stats[name][0]:.3e} max {float(rel.max()):.3e}, whole batch "
            f"{stats[name][1]:.3e}; iteration counts "
            + json.dumps({i: int(c) for i, c in enumerate(hist.tolist()) if c}))
    # the per-scenario max is one chaotic system of 512; the median and the
    # whole batch are what the bar holds
    for i, what in enumerate(("median", "whole batch")):
        bound = 10 * max(stats["plain"][i], 1e-6)
        assert stats["kernel"][i] <= bound, (what, stats)


def pcg_episode(torch, F, lanes, K, FP, x0s, goals, launched):
    """The PCG-SS flagship closed loop through K1-K4 (phase 7)."""
    torch.cuda.synchronize()
    for k in launched:
        k.launches = 0
    t0 = time.perf_counter()
    plant, res = F.run_episode(x0s, goals, steps=STEPS, cold_steps=COLD_STEPS,
                               N=N, use_kernel_pcg=True, **F.PCG_KNOBS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"fd_grad": lanes.fd_grad_kernel.launches,
              "fd": lanes.fd_kernel.launches,
              "task_vec": K.task_vec_kernel.launches,
              "pcg": FP.pcg_fused_kernel.launches}
    gate_ok, finite = report_loop(torch, F, plant, x0s, goals, res, wall,
                                  counts, "[pcg]",
                                  f"PCG-SS flagship through K4, {COLD_STEPS} cold")
    if not gate_ok:
        # tell the kernel apart from the algorithm: the same loop on
        # btridiag.pcg (plain PyTorch, no K4)
        t0 = time.perf_counter()
        plant, res2 = F.run_episode(x0s, goals, steps=STEPS,
                                    cold_steps=COLD_STEPS, N=N,
                                    use_kernel_pcg=False, **F.PCG_KNOBS)
        torch.cuda.synchronize()
        report_loop(torch, F, plant, x0s, goals, res2,
                    time.perf_counter() - t0, {}, "[pcg]",
                    f"PCG-SS flagship through btridiag.pcg, {COLD_STEPS} cold")
    assert all(v > 0 for v in counts.values()), counts
    assert finite
    assert res.X_applied.shape == (B, 12, STEPS + 1)
    assert gate_ok
    # the simulated joint velocity limit changes exactly the scenarios that
    # reach it: the same loop without the limit
    _, off = F.run_episode(x0s, goals, steps=STEPS, cold_steps=COLD_STEPS,
                           N=N, use_kernel_pcg=True, sim_qd_max=math.inf,
                           **F.PCG_KNOBS)
    changed = (off.X_applied != res.X_applied).any(2).any(1)
    at_limit = (res.X_applied[:, 6:].abs() >= F.SIM_QD_MAX).any(2).any(1)
    ids = lambda m: torch.nonzero(m).flatten().tolist()
    log(f"[pcg] without the joint velocity limit: scenarios changed "
        f"{ids(changed)}, at the limit {ids(at_limit)}, non-finite "
        f"{ids(~torch.isfinite(off.X_applied).all(2).all(1))}")
    assert torch.equal(changed, at_limit)
    return counts


def report_loop(torch, F, plant, x0s, goals, res, wall, counts, tag, label):
    """Print a closed loop's rate, launches and quality; returns (gate
    passed, states finite)."""
    err, dist0 = F.ee_errors(plant, x0s, goals, res)
    gate_ok, med_err, stable = F.quality_gate(err, dist0)
    finite = bool(torch.isfinite(res.X_applied).all()
                  and torch.isfinite(res.U_applied).all())
    n = plant.nq
    at_limit = int((res.X_applied[:, n:].abs() >= F.SIM_QD_MAX).any(2).any(1)
                   .sum())
    log(f"{tag} {label}: B={B} N={N} {STEPS} steps, f32: wall {wall:.3f} s, "
        f"{B * STEPS / wall:.1f} solves/s, {1e3 * wall / STEPS:.2f} ms/step; "
        f"launches {json.dumps(counts)}; iters/step mean "
        f"{res.iters.float().mean().item():.3f}")
    log(f"{tag} quality ({label}): median EE err {med_err:.4f} m from "
        f"{float(np.median(dist0)):.2f} m, {stable}/{B} stable<1m, "
        f"states finite {finite}, {at_limit} at the simulated joint "
        f"velocity limit, gate {'passed' if gate_ok else 'FAILED'}")
    return gate_ok, finite


def ptxas_summary(report: str, key: str) -> str:
    """Registers / stack / spills of the entry functions whose mangled
    name holds ``key`` (e.g. the float, n = 6 lanes kernels)."""
    out, current = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            current = key in line
        elif current and ("registers" in line or "spill" in line):
            out.append(" ".join(line.replace("ptxas info    :", "").split()))
    return "; ".join(out) or "no ptxas report"


if __name__ == "__main__":
    sys.exit(main())
