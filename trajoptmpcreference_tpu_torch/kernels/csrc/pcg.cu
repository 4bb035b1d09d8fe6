// K4 — batched block-tridiagonal PCG on the Schur system S dx = r0, from
// dx = 0, one thread block per scenario, its rows of S spread over the
// block's threads.
//
// Replaces the TPU kernel trajoptmpcreference_tpu/ops/pallas_pcg.py:123
// `_pcg_kernel` (launched by `_pallas_pcg_lanes`, :209).  Plain version:
// ops/fused_pcg.py `pcg_fused_plain`.
//
// Operands, batch-major: diag_p and pdiag_p (B, N, T) hold the symmetric
// diagonal blocks of S and of the block-Jacobi inverse as packed lower
// triangles (T = bs(bs+1)/2, row i at i(i+1)/2); upper (B, N, bs, bs) holds
// S[k, k+1] (block N-1 is never read); r0 (B, N, bs).  Out: dx (B, N, bs)
// and each scenario's own iteration count (the TPU kernel reported its
// 128-lane tile's count for every lane).
//
// Storage (pallas_pcg.py:365-368): diag_p and pdiag_p may each be stored
// narrower than the operands (a runtime code per operand, Storage below:
// f32 under f64 operands, bf16, f16); the kernel reads the narrow values
// itself and computes in the operands' type.  When pdiag_p's storage is
// not the operands' own, the loop exits on the true residual r'r (the
// threshold from r0'r0), not on nu = r'Pinv r (:162-168, :335-336); r'r
// rides the same shuffle tree as r's (two values a slot), so it adds no
// barrier.
//
// What bounds it on the H100: neither bytes nor flops.  A scenario's
// system (~94 KB in f32 at N = 64, bs = 12) is read once; an iteration
// then does ~84 multiply-adds per row of S between two block sums, each a
// chain of shuffles and a barrier, so the solve is bound by the latency
// of the block's barriers and sums and by the instructions each
// multiply-add costs (PERF.md, "Inside K4": the sums' shuffle trees and
// the other barriers take about a fifth of the time each).  Three
// variants, chosen per (N, bs, type) by `variant` (1 is retired):
//
// * 0, registers (RegRow: the block sizes the plants give, bs = 2, 4,
//   ..., 14, and up to 1,024 rows of S, 768 from bs = 10): each thread
//   owns R = 2 rows g = (k, i) and unpacks, once at load, row i of D_k, of
//   U_k, of U_{k-1}^T and of P_k into registers (converting narrow storage
//   there, once), with its entries of x, r, p, s and Ap.  The block size
//   is a template parameter, so the loops over a block row unroll and no
//   packed index is computed inside the iteration.  Shared memory holds
//   only what other threads read: p and s (a zero block on each side, so
//   the first and last block rows take no branch), r (then the SS
//   temporary t) and two reduction slots per warp: 9,664 bytes at N = 64,
//   bs = 12 in f32.  A block of 384 threads (bs >= 10; 512 below) holds
//   one SM's registers, so one block runs per SM.
// * 3, cluster (ClRows<T, BS, false>: every other shape whose system fits
//   the shared memory of C <= 16 blocks): one thread-block cluster per
//   scenario, of the smallest C that fits (C = 1 included: one block),
//   launched with a run-time cluster dimension (past 8 blocks, the
//   portable limit, as a non-portable size; the H100 schedules 16).  Rank
//   c owns a contiguous run of about N / C knots and holds, in its own
//   shared memory, their packed D and P blocks, U_{k0-1} .. U_{k1-1} (the
//   first for the transposed term of its first knot), its rows of v, p,
//   s, s0 and w and the reduction slots, all knot-fastest so that a
//   warp's loads at each step of its rows' dot products hit consecutive
//   words (ClRows).  The operator is converted to the operands' type once
//   at load (so the shared memory a shape needs, and the variant it
//   takes, do not depend on the storage) and never read from device
//   memory again; bs = 12 and 24 are built in, other block sizes read at
//   run time.  Only two phases read another rank's rows: the matvec (p at
//   k +- 1) and SS's t (s0 at k +- 1), each the neighbour's boundary block
//   of bs values, read in place through distributed shared memory after
//   the cluster barrier that ends the phase which wrote it; the other
//   phases read their own rows and end on __syncthreads().  A sum is the
//   block's sum, written by thread r into slot c of rank r (one thread a
//   rank), a cluster barrier, and slots 0 .. C-1 added in that order on
//   every thread, so every thread of the cluster holds the same bits and
//   takes the same exit.  p'Ap and r's use two sets of slots, so no rank
//   writes a slot that another has yet to read; SS keeps s0 apart from s,
//   so s = s0 - P t does not overwrite what a neighbour still reads.  The
//   load and the store end on a cluster barrier: no rank writes into a
//   rank that has not started, or exits while another may still read its
//   shared memory.  A one-block cluster (C = 1, known at launch) is the
//   same kernel template instantiated with MULTI = false and launched as
//   plain blocks: every cluster barrier is the block's, no slot is
//   written (the same sums; cluster barriers there cost 27% more time,
//   PERF.md) and s0 shares s's array, so one block holds N = 166 at bs =
//   12 in f32 (82 in f64).
// * 2, global operator (ClRows<T, BS, true>: the shapes past 16 blocks'
//   shared memory): the same ranks, rows, phases, sums and halos as the
//   cluster, over C = min(16, N) blocks, with the packed D, P and U blocks
//   written once, in the load phase, into the workspace the wrapper
//   allocates, converted there to the operands' type, in the cluster's
//   knot-fastest layout; each rank then streams its own run of knots from
//   there (L2 or device memory) at every use, a warp's loads coalesced,
//   converting nothing.  The vectors and slots stay in shared memory
//   while they fit (N up to ~15,000 at bs = 12 in f32); past that the
//   vectors join the operator in the workspace, and the halos read the
//   neighbour's rows there (the cluster barrier orders device memory
//   across the cluster as it orders shared memory).
//
// All run one phase sequence (pcg_block) with a barrier after each phase
// and a block sum as one shuffle tree per warp, one barrier, and a second
// tree over the warps' slots (every warp sums the slots in the same order,
// so every thread holds the same value and takes the same exit).  Per
// iteration: p (1), S p and p'Ap (1), x and r (1), then the
// preconditioner: s = P r and r's (1) for J / BJ; for SS s0 = P r (1),
// t = U s0_{k+1} + U^T s0_{k-1} (1), s = s0 - P t and r's (1).  4 barriers
// with J / BJ, 6 with SS, with either exit; in a cluster of C > 1 blocks
// the barriers after p and after s0, and the two sums, are cluster
// barriers (2 with J / BJ, 4 with SS).  The phase order alone keeps a reduction
// slot from being overwritten before every warp has read it, so the slots
// need no barrier of their own.
//
// The same source compiles as plain C++ (no __CUDACC__): each phase runs
// for every thread of the block in turn, and in the cluster variants for
// every rank of the cluster in turn, each rank's shared memory one piece
// of a host buffer (TMR_GROUP_REVERSE_TIDS: ranks and threads in reverse,
// to catch a phase in which one thread reads what another writes), the
// block sums follow the warps' shuffle trees and the cluster sums the
// ranks' order, 16-bit storage is decoded bit by bit, and a host loop runs
// the scenarios one by one, so g++ checks the arithmetic, the work
// partition and the halos on the CPU (tests/test_torch_kernel_sources.py,
// tests/test_torch_pcg_large.py).
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <functional>
#include <vector>
#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#define TMR_HD __host__ __device__ __forceinline__
#else
#define TMR_HD inline
#endif

namespace tmr_pcg {

constexpr int WARPS = 32;       // reduction slots: two per warp of a block
constexpr int CLUSTER_MAX = 16;   // the H100's largest (non-portable) cluster
constexpr size_t SMEM_LIMIT = 232448;   // one block's shared memory, bytes
constexpr long long INDEX_LIMIT = 2147483647;   // the int row / block index

template <typename T>
TMR_HD T tabs(T v) { return v < T(0) ? -v : v; }

// position of (i, j) of a symmetric block in its packed lower triangle
TMR_HD int sym(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

TMR_HD int round_warp(int n) { return (n + 31) / 32 * 32; }

// ---- storage of the packed blocks -----------------------------------------
// The code of diag_p's and of pdiag_p's storage (ops/fused_pcg.py
// STORAGE): the operands' own type, f32 (under f64 operands), bf16, f16.
enum Storage { ST_SAME = 0, ST_F32 = 1, ST_BF16 = 2, ST_F16 = 3 };

template <typename T>
TMR_HD T ldro(const T* p) {   // the read-only path on the card
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// bf16 is the top half of an f32: exact
TMR_HD float bf16_float(uint16_t h) {
#ifdef __CUDA_ARCH__
  return __uint_as_float((unsigned)h << 16);
#else
  const uint32_t u = (uint32_t)h << 16;
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
#endif
}

// IEEE half to f32: exact (subnormal halves are normal f32s)
TMR_HD float f16_float(uint16_t h) {
#ifdef __CUDA_ARCH__
  return __half2float(__ushort_as_half(h));
#else
  const uint32_t sign = (uint32_t)(h >> 15) << 31;
  const int e = (h >> 10) & 0x1f;
  uint32_t m = h & 0x3ffu, u;
  if (e == 0x1f) {
    u = sign | 0x7f800000u | (m << 13);   // inf, nan
  } else if (e != 0) {
    u = sign | ((uint32_t)(e - 15 + 127) << 23) | (m << 13);
  } else if (m == 0) {
    u = sign;
  } else {   // subnormal: m 2^-24, shifted until its leading bit is bit 10
    int s = 0;
    while (!(m & 0x400u)) {
      m <<= 1;
      ++s;
    }
    u = sign | ((uint32_t)(127 - 14 - s) << 23) | ((m & 0x3ffu) << 13);
  }
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
#endif
}

// element i of a packed operand stored as `code`, in the operands' type T
template <typename T>
TMR_HD T stored(const void* p, size_t i, int code) {
  switch (code) {
    case ST_F32: return T(ldro(static_cast<const float*>(p) + i));
    case ST_BF16: return T(bf16_float(ldro(static_cast<const uint16_t*>(p) + i)));
    case ST_F16: return T(f16_float(ldro(static_cast<const uint16_t*>(p) + i)));
    default: return ldro(static_cast<const T*>(p) + i);
  }
}

// a packed operand in its storage: indexed and offset like a pointer
template <typename T>
struct Stored {
  const void* p;
  size_t off;
  int code;
  TMR_HD T operator[](size_t i) const { return stored<T>(p, off + i, code); }
  TMR_HD Stored operator+(size_t k) const { return Stored{p, off + k, code}; }
};

// ---- the shapes -----------------------------------------------------------
// The register variant: the block sizes it is built for, its rows per
// thread and threads per block (each row holds 4 bs operator values in
// registers: the budget of 65,536 registers per SM sets the rows a block
// can hold), and so the rows of S one block takes.
TMR_HD bool compiled_bs(int bs) { return bs >= 2 && bs <= 14 && bs % 2 == 0; }
TMR_HD constexpr int reg_rows_per_thread(int) { return 2; }
TMR_HD constexpr int reg_threads(int bs) { return bs <= 8 ? 512 : 384; }
TMR_HD constexpr int reg_rows(int bs) {
  return reg_rows_per_thread(bs) * reg_threads(bs);
}
TMR_HD bool use_regs(int N, int bs) {
  return compiled_bs(bs) && (long long)N * bs <= reg_rows(bs);
}

// the cluster variants: rank c of `ranks` holds knots first_knot(c) ..
// first_knot(c + 1) - 1, at most knots_max of them
TMR_HD int first_knot(int N, int ranks, int c) {
  return (int)((long long)c * N / ranks);
}
TMR_HD int knots_max(int N, int ranks) { return (N + ranks - 1) / ranks; }

// one rank's operator, in values: the packed D and P blocks of its knots
// and nk + 1 upper blocks
TMR_HD size_t operator_elems(int N, int bs, int ranks) {
  const size_t nk = knots_max(N, ranks), tri = (size_t)bs * (bs + 1) / 2;
  return 2 * nk * tri + (nk + 1) * bs * bs;
}
// one rank's vectors, in values: v, p, s, w and, in a cluster of more
// than one block (multi), SS's s0 apart from s
TMR_HD size_t vector_elems(int N, int bs, int ranks, bool multi = true) {
  return (multi ? 5 : 4) * (size_t)knots_max(N, ranks) * bs;
}
// the block's reduction slots and, in a cluster of more than one block,
// two sets of the ranks' partial sums (two values each)
TMR_HD constexpr size_t slot_elems(bool multi = true) {
  return 2 * WARPS + (multi ? 4 * CLUSTER_MAX : 0);
}

// shared memory of one rank of the cluster variant, in values
TMR_HD size_t cluster_elems(int N, int bs, int ranks) {
  return operator_elems(N, bs, ranks) + vector_elems(N, bs, ranks, ranks > 1)
         + slot_elems(ranks > 1);
}

// the smallest cluster whose ranks each fit one block's shared memory for
// values of `item` bytes; 0 if none of up to CLUSTER_MAX blocks does
TMR_HD int cluster_size(int N, int bs, int item) {
  for (int c = 1; c <= CLUSTER_MAX && c <= N; ++c)
    if (cluster_elems(N, bs, c) * item <= SMEM_LIMIT) return c;
  return 0;
}

// the global operator's cluster, and whether its vectors (with the slots)
// fit each block's shared memory
TMR_HD int global_ranks(int N) { return N < CLUSTER_MAX ? N : CLUSTER_MAX; }
TMR_HD bool global_vectors_shared(int N, int bs, int item) {
  return (vector_elems(N, bs, global_ranks(N)) + slot_elems()) * item
         <= SMEM_LIMIT;
}

// 0 registers, 3 cluster, 2 global operator, for values of `item` bytes
TMR_HD int variant(int N, int bs, int item) {
  if (use_regs(N, bs)) return 0;
  return cluster_size(N, bs, item) > 0 ? 3 : 2;
}

// whether variant v takes (N, bs) in values of `item` bytes
TMR_HD bool takes(int v, int N, int bs, int item) {
  switch (v) {
    case 0: return use_regs(N, bs);
    case 2: return N > 0;
    case 3: return cluster_size(N, bs, item) > 0;
    default: return false;
  }
}

// the blocks of one scenario in variant v
TMR_HD int variant_ranks(int v, int N, int bs, int item) {
  return v == 3 ? cluster_size(N, bs, item) : v == 2 ? global_ranks(N) : 1;
}

// shared memory of one block of variant v, in values
TMR_HD size_t variant_smem_elems(int v, int N, int bs, int item) {
  switch (v) {
    case 0: return 3 * (size_t)N * bs + 4 * bs + 2 * WARPS;
    case 3: return cluster_elems(N, bs, cluster_size(N, bs, item));
    default:
      return slot_elems() + (global_vectors_shared(N, bs, item)
                                 ? vector_elems(N, bs, global_ranks(N)) : 0);
  }
}

// shared memory of one block, in values, for the variant that takes
// (N, bs) in values of `item` bytes
TMR_HD size_t smem_elems(int N, int bs, int item) {
  return variant_smem_elems(variant(N, bs, item), N, bs, item);
}

// the workspace per scenario of variant v, in values: the global
// operator's converted operator (and its vectors, past shared memory),
// rank by rank
TMR_HD size_t variant_work_elems(int v, int N, int bs, int item) {
  if (v != 2) return 0;
  const int c = global_ranks(N);
  return c * (operator_elems(N, bs, c)
              + (global_vectors_shared(N, bs, item) ? 0
                                                    : vector_elems(N, bs, c)));
}
TMR_HD size_t work_elems(int N, int bs, int item) {
  return variant_work_elems(variant(N, bs, item), N, bs, item);
}

// the launch's operands, whole batch
template <typename T>
struct Args {
  const void *D, *P;   // diag_p, pdiag_p in their storage (dcode, pcode)
  const T *U, *r0;
  T *dx, *work;
  int* iters;
  int B, N, bs, dcode, pcode, ss, relative, max_iter;
  T tol;
  int ranks;     // blocks per scenario: C for a cluster, else 1
  int vshared;   // the global operator: its vectors in shared memory
  size_t smem, wper;   // values: shared memory a block, workspace a scenario
};

// one scenario's slice of the operands
template <typename T>
struct Src {
  Stored<T> D, P;
  const T *U, *r0;
  T *dx, *work;
};

template <typename T>
TMR_HD Src<T> scenario(const Args<T>& a, size_t b) {
  const size_t n = (size_t)a.N * a.bs, nD = (size_t)a.N * (a.bs * (a.bs + 1) / 2);
  return Src<T>{Stored<T>{a.D, b * nD, a.dcode}, Stored<T>{a.P, b * nD, a.pcode},
                a.U + b * n * a.bs, a.r0 + b * n, a.dx + b * n,
                a.work ? a.work + b * a.wper : nullptr};
}

// the block's shared state (the same for every thread)
template <typename T>
struct Team {
  T *p, *s, *v, *w, *red;  // p, s; v: r (then t); w: Ap (then t), cluster
  T *D, *P, *U;            // cluster: the rank's operator
  T *s0, *cl;              // cluster: SS's s0; the ranks' partial sums
  // cluster: the neighbours' boundary blocks of p and s0 (null at the ends)
  const T *pprev, *pnext, *sprev, *snext;
  int N, bs, n, nt;        // n: the block's rows (the rank's, in a cluster)
  int rank, ranks, k0, nk; // cluster: this rank, C, its knots k0 .. k0+nk-1
  int ld;                  // cluster: the knot stride of its arrays
  ptrdiff_t stride;        // host build: values between two ranks' memories
  ptrdiff_t wrank;         // vectors in the workspace: values between two
                           // ranks' (0: in shared memory)
};

// ---- dot products over one block row ------------------------------------
// sum_j a[j] v[j], from the first term; a in registers, v a block of BS
// values in shared memory (scalar loads: 16-byte vector loads measured
// slower and spilled, PERF.md's K4 tries)
template <int BS, typename T>
TMR_HD T dot_row(const T* a, const T* v) {
  T acc = a[0] * v[0];
#pragma unroll
  for (int j = 1; j < BS; ++j) acc += a[j] * v[j];
  return acc;
}

// ---- the register variant: R rows of S per thread -------------------------
// Thread tid owns rows tid, tid + nt, ... (R of them): each warp's rows are
// consecutive, so its threads read few blocks of p, s and r at once.
template <typename T, int BS, int R = reg_rows_per_thread(BS)>
struct RegRow {
  T D[R][BS], U[R][BS], UT[R][BS], P[R][BS];  // row i of D_k, U_k, U_{k-1}^T, P_k
  T x[R], r[R], ap[R], p[R], s[R], s0[R];
  int g[R], k[R];
  bool on[R];  // a row of S (the block's last warp may run past the end)
  T part, part2;   // the thread's shares of r's (or p'Ap) and of r'r
  static constexpr bool CLUSTER = false;

  static TMR_HD int threads(int N, int, int) {
    return round_warp((N * BS + R - 1) / R);
  }
  static TMR_HD Team<T> carve(T* m, const Src<T>&, const Args<T>& a,
                              int nt, int, ptrdiff_t) {
    const int N = a.N;
    Team<T> t{};
    t.N = N;
    t.bs = BS;
    t.n = N * BS;
    t.nt = nt;
    t.p = m + BS;                    // p and s: a zero block on each side
    t.s = t.p + t.n + 2 * BS;
    t.v = t.s + t.n + BS;
    t.red = t.v + t.n;
    return t;
  }

  TMR_HD void load(const Team<T>& tm, const Src<T>& src, int tid) {
    if (tid < BS) {
      tm.p[tid - BS] = tm.p[tm.n + tid] = T(0);
      tm.s[tid - BS] = tm.s[tm.n + tid] = T(0);
    }
#pragma unroll
    for (int m = 0; m < R; ++m) {
      g[m] = tid + m * tm.nt;
      on[m] = g[m] < tm.n;
      k[m] = on[m] ? g[m] / BS : 0;
      const int i = g[m] - k[m] * BS;
      const Stored<T> Dk = src.D + k[m] * (BS * (BS + 1) / 2);
      const Stored<T> Pk = src.P + k[m] * (BS * (BS + 1) / 2);
      const bool up = on[m] && k[m] + 1 < tm.N, dn = on[m] && k[m] > 0;
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        D[m][j] = on[m] ? Dk[sym(i, j)] : T(0);
        P[m][j] = on[m] ? Pk[sym(i, j)] : T(0);
        U[m][j] = up ? src.U[(size_t)(k[m] * BS + i) * BS + j] : T(0);
        UT[m][j] = dn ? src.U[(size_t)((k[m] - 1) * BS + j) * BS + i] : T(0);
      }
      x[m] = p[m] = s[m] = s0[m] = ap[m] = T(0);
      r[m] = on[m] ? src.r0[g[m]] : T(0);
      if (on[m]) tm.v[g[m]] = r[m];
    }
    part = part2 = T(0);
  }
  // p = s + beta p (beta = 0 and p = 0 at the first iteration)
  TMR_HD void pstep(const Team<T>& tm, T beta) {
#pragma unroll
    for (int m = 0; m < R; ++m) {
      p[m] = s[m] + beta * p[m];
      if (on[m]) tm.p[g[m]] = p[m];
    }
  }
  // (S p)_g = D_k p_k + (U_k p_{k+1} + U_{k-1}^T p_{k-1}), and the thread's
  // sum of p_g (S p)_g
  TMR_HD void matvec(const Team<T>& tm) {
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const T* pk = tm.p + k[m] * BS;
      ap[m] = dot_row<BS>(D[m], pk)
              + (dot_row<BS>(U[m], pk + BS) + dot_row<BS>(UT[m], pk - BS));
      const T pa = on[m] ? p[m] * ap[m] : T(0);
      part = m == 0 ? pa : part + pa;
    }
  }
  TMR_HD void update(const Team<T>& tm, T alpha) {
#pragma unroll
    for (int m = 0; m < R; ++m) {
      x[m] += alpha * p[m];
      r[m] -= alpha * ap[m];
      if (on[m]) tm.v[g[m]] = r[m];
    }
  }
  // the thread's sums of r_g s_g and r_g r_g
  TMR_HD void sums() {
#pragma unroll
    for (int m = 0; m < R; ++m) {
      part = m == 0 ? r[m] * s[m] : part + r[m] * s[m];
      part2 = m == 0 ? r[m] * r[m] : part2 + r[m] * r[m];
    }
  }
  // J / BJ: s = P r
  TMR_HD void pre_bj(const Team<T>& tm) {
#pragma unroll
    for (int m = 0; m < R; ++m) s[m] = dot_row<BS>(P[m], tm.v + k[m] * BS);
    sums();
  }
  // SS: s0 = P r; t = U s0_{k+1} + U^T s0_{k-1}; s = s0 - P t
  TMR_HD void pre_s0(const Team<T>& tm) {
#pragma unroll
    for (int m = 0; m < R; ++m) {
      s0[m] = dot_row<BS>(P[m], tm.v + k[m] * BS);
      if (on[m]) tm.s[g[m]] = s0[m];
    }
  }
  TMR_HD void pre_t(const Team<T>& tm) {
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const T* sk = tm.s + k[m] * BS;
      const T t = dot_row<BS>(U[m], sk + BS) + dot_row<BS>(UT[m], sk - BS);
      if (on[m]) tm.v[g[m]] = t;
    }
  }
  TMR_HD void pre_ss(const Team<T>& tm) {
#pragma unroll
    for (int m = 0; m < R; ++m)
      s[m] = s0[m] - dot_row<BS>(P[m], tm.v + k[m] * BS);
    sums();
  }
  TMR_HD void store(const Team<T>&, const Src<T>& src) {
#pragma unroll
    for (int m = 0; m < R; ++m)
      if (on[m]) src.dx[g[m]] = x[m];
  }
};

// ---- the cluster variants: a rank's knots across its threads --------------
// p in rank r's vectors (its shared memory, or its piece of the
// workspace), as another rank of the cluster addresses it
template <typename T>
TMR_HD T* peer(T* p, const Team<T>& tm, int r) {
  if (tm.wrank) return p + (ptrdiff_t)(r - tm.rank) * tm.wrank;
#ifdef __CUDA_ARCH__
  return cooperative_groups::this_cluster().map_shared_rank(p, (unsigned)r);
#else
  return p + (ptrdiff_t)(r - tm.rank) * tm.stride;
#endif
}

// sum_j a[j sa] v[j sv], j < n, from the first term; BS > 0: n = BS,
// the loop unrolled, so a row's loads issue ahead of its multiply-adds
template <int BS, typename T>
TMR_HD T dot_strided(const T* a, int sa, const T* v, int sv, int n) {
  T acc = a[0] * v[0];
  if constexpr (BS > 0) {
#pragma unroll
    for (int j = 1; j < BS; ++j) acc += a[j * sa] * v[j * sv];
  } else {
    for (int j = 1; j < n; ++j) acc += a[j * sa] * v[j * sv];
  }
  return acc;
}

// (D v)_i for one packed symmetric block whose entry e sits at D[e s]
template <int BS, typename T>
TMR_HD T sym_row_strided(const T* D, int s, const T* v, int sv, int i,
                         int bs) {
  const int base = i * (i + 1) / 2;
  T acc = D[base * s] * v[0];
  if constexpr (BS > 0) {
#pragma unroll
    for (int j = 1; j < BS; ++j)
      acc += D[(j <= i ? base + j : j * (j + 1) / 2 + i) * s] * v[j * sv];
  } else {
    for (int j = 1; j <= i; ++j) acc += D[(base + j) * s] * v[j * sv];
    for (int j = i + 1; j < bs; ++j)
      acc += D[(j * (j + 1) / 2 + i) * s] * v[j * sv];
  }
  return acc;
}

// The rank keeps its blocks and vectors knot-fastest: entry e of knot kl
// at [e ld + kl] (ld = knots_max), of its upper block kl (U_{k0-1+kl}) at
// [e (ld + 1) + kl], and the warps walk rows (kl, i) with kl fastest.  At
// each step of a row's dot product a warp's threads read consecutive
// words: no bank conflict, where rows read row-major would collide (U's
// rows bs apart in the banks, the packed triangle's rows anywhere).  The
// update alone walks the rows (k, i) with i fastest, so dx is written in
// whole sectors.  BS > 0 builds the block size in (the plants' 12, and 24
// = nx + m of the 6-DoF arm's generic path), as the register variant
// does; BS = 0 reads it at run time.  GOP (the global operator) keeps the
// rank's operator in its piece of the workspace, in the same layout, and
// its vectors there too when they do not fit shared memory (a.vshared).
// MULTI = false is the one-block cluster (C = 1, known at launch): the
// same rows and phases, launched as plain blocks, its cluster barriers
// the block's, no cluster slot, and s0 in s's place (s = s0 - P t reads
// and writes each thread's own rows; only a neighbour rank reads s0
// after it is overwritten).
template <typename T, int BS = 0, bool GOP = false, bool MULTI = true>
struct ClRows {
  int tid;
  T part, part2;
  T* x;  // the rank's rows of dx: only the thread of row g touches x_g
  const T *D, *P, *U;
  static constexpr bool CLUSTER = MULTI;
  static constexpr int MAX_NT = 768;   // 85 registers a thread
  static TMR_HD int bsz(const Team<T>& tm) { return BS > 0 ? BS : tm.bs; }

  // up to MAX_NT threads, the rows shared out evenly
  static TMR_HD int threads(int N, int bs, int ranks) {
    const int rows = knots_max(N, ranks) * bs,
              per = (rows + MAX_NT - 1) / MAX_NT;
    return round_warp((rows + per - 1) / per);
  }
  // every rank lays its memory out for knots_max knots, so a neighbour's
  // block sits where it would sit in one's own
  static TMR_HD Team<T> carve(T* m, const Src<T>& src, const Args<T>& a,
                              int nt, int rank, ptrdiff_t stride) {
    Team<T> t{};
    const int N = a.N, bs = a.bs, ranks = a.ranks;
    const size_t nkm = knots_max(N, ranks), tri = (size_t)bs * (bs + 1) / 2,
                 nv = nkm * bs;
    t.N = N;
    t.bs = bs;
    t.nt = nt;
    t.ld = (int)nkm;
    t.rank = rank;
    t.ranks = ranks;
    t.stride = stride;
    t.k0 = first_knot(N, ranks, rank);
    t.nk = first_knot(N, ranks, rank + 1) - t.k0;
    t.n = t.nk * bs;
    const bool wvec = GOP && !a.vshared;   // the vectors in the workspace
    t.wrank = wvec ? (ptrdiff_t)(a.wper / ranks) : 0;
    t.D = GOP ? src.work + (size_t)rank * (a.wper / ranks) : m;
    t.P = t.D + nkm * tri;
    t.U = t.P + nkm * tri;
    t.v = GOP && !wvec ? m : t.U + (nkm + 1) * bs * bs;
    t.p = t.v + nv;
    t.s = t.p + nv;
    t.s0 = MULTI ? t.s + nv : t.s;   // one block: no neighbour reads s0
    t.w = t.s0 + nv;
    t.red = wvec ? m : t.w + nv;
    t.cl = t.red + 2 * WARPS;
    if (rank > 0) {   // the previous rank's last knot
      const int last = t.k0 - first_knot(N, ranks, rank - 1) - 1;
      t.pprev = peer(t.p + last, t, rank - 1);
      t.sprev = peer(t.s0 + last, t, rank - 1);
    }
    if (rank + 1 < ranks) {   // the next rank's first
      t.pnext = peer(t.p, t, rank + 1);
      t.snext = peer(t.s0, t, rank + 1);
    }
    return t;
  }

  // row (kl, i) of U_k v_{k+1} + U_{k-1}^T v_{k-1} (k = k0 + kl), the
  // blocks past the rank's ends read from its neighbours
  TMR_HD T off(const Team<T>& tm, const T* v, const T* prev, const T* next,
               int kl, int i) const {
    const int bs = bsz(tm), ld = tm.ld, su = ld + 1, k = tm.k0 + kl;
    T acc = T(0);
    if (k + 1 < tm.N)
      acc = dot_strided<BS>(U + (kl + 1) + i * bs * su, su,
                            kl + 1 < tm.nk ? v + kl + 1 : next, ld, bs);
    if (k > 0)
      acc += dot_strided<BS>(U + kl + i * su, bs * su,
                             kl > 0 ? v + kl - 1 : prev, ld, bs);
    return acc;
  }
  TMR_HD T prow(const Team<T>& tm, const T* v, int kl, int i) const {
    return sym_row_strided<BS>(P + kl, tm.ld, v + kl, tm.ld, i, bsz(tm));
  }

  // the rank's operator into its shared memory (GOP: its piece of the
  // workspace), knot-fastest, converted once; r0 into v, p = 0, dx = 0
  TMR_HD void load(const Team<T>& tm, const Src<T>& src, int t) {
    tid = t;
    part = part2 = T(0);
    const int bs = bsz(tm), tri = bs * (bs + 1) / 2, bb = bs * bs, ld = tm.ld;
    const size_t row0 = (size_t)tm.k0 * bs;
    x = src.dx + row0;
    const Stored<T> Ds = src.D + (size_t)tm.k0 * tri,
                    Ps = src.P + (size_t)tm.k0 * tri;
    for (int e = tid; e < tm.nk * tri; e += tm.nt) {
      const int kl = e / tri, f = e - kl * tri;
      tm.D[f * ld + kl] = Ds[e];
      tm.P[f * ld + kl] = Ps[e];
    }
    // U_{k0-1} .. U_{k0+nk-1}; rank 0 has no U_{-1}
    const size_t u0 = (size_t)tm.k0 * bb;
    for (int e = (tm.k0 > 0 ? 0 : bb) + tid; e < (tm.nk + 1) * bb;
         e += tm.nt) {
      const int kl = e / bb, f = e - kl * bb;
      tm.U[f * (ld + 1) + kl] = src.U[u0 + e - bb];
    }
    D = tm.D;
    P = tm.P;
    U = tm.U;
    for (int g = tid; g < tm.n; g += tm.nt) {
      const int k = g / bs, at = (g - k * bs) * ld + k;
      tm.v[at] = src.r0[row0 + g];
      tm.p[at] = T(0);
      x[g] = T(0);
    }
  }
  TMR_HD void pstep(const Team<T>& tm, T beta) {
    for (int g = tid; g < tm.n; g += tm.nt) {
      const int i = g / tm.nk, at = i * tm.ld + (g - i * tm.nk);
      tm.p[at] = tm.s[at] + beta * tm.p[at];
    }
  }
  TMR_HD void matvec(const Team<T>& tm) {
    part = T(0);
    for (int g = tid; g < tm.n; g += tm.nt) {
      const int i = g / tm.nk, kl = g - i * tm.nk, at = i * tm.ld + kl;
      const T a = sym_row_strided<BS>(D + kl, tm.ld, tm.p + kl, tm.ld, i,
                                      bsz(tm));
      tm.w[at] = a + off(tm, tm.p, tm.pprev, tm.pnext, kl, i);
      part += tm.p[at] * tm.w[at];
    }
  }
  TMR_HD void update(const Team<T>& tm, T alpha) {
    for (int g = tid; g < tm.n; g += tm.nt) {   // i fastest: dx in sectors
      const int k = g / bsz(tm), at = (g - k * bsz(tm)) * tm.ld + k;
      x[g] += alpha * tm.p[at];
      tm.v[at] -= alpha * tm.w[at];
    }
  }
  TMR_HD void pre_bj(const Team<T>& tm) {
    part = part2 = T(0);
    for (int g = tid; g < tm.n; g += tm.nt) {
      const int i = g / tm.nk, kl = g - i * tm.nk, at = i * tm.ld + kl;
      tm.s[at] = prow(tm, tm.v, kl, i);
      part += tm.v[at] * tm.s[at];
      part2 += tm.v[at] * tm.v[at];
    }
  }
  TMR_HD void pre_s0(const Team<T>& tm) {
    for (int g = tid; g < tm.n; g += tm.nt) {
      const int i = g / tm.nk, kl = g - i * tm.nk;
      tm.s0[i * tm.ld + kl] = prow(tm, tm.v, kl, i);
    }
  }
  TMR_HD void pre_t(const Team<T>& tm) {
    for (int g = tid; g < tm.n; g += tm.nt) {
      const int i = g / tm.nk, kl = g - i * tm.nk;
      tm.w[i * tm.ld + kl] = off(tm, tm.s0, tm.sprev, tm.snext, kl, i);
    }
  }
  TMR_HD void pre_ss(const Team<T>& tm) {
    part = part2 = T(0);
    for (int g = tid; g < tm.n; g += tm.nt) {
      const int i = g / tm.nk, kl = g - i * tm.nk, at = i * tm.ld + kl;
      tm.s[at] = tm.s0[at] - prow(tm, tm.w, kl, i);
      part += tm.v[at] * tm.s[at];
      part2 += tm.v[at] * tm.v[at];
    }
  }
  TMR_HD void store(const Team<T>&, const Src<T>&) {}  // x is dx already
};

// ---- phases and block sums ------------------------------------------------
#ifdef __CUDA_ARCH__
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {  // lane 0 holds the sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// the block's sums of a (and, with two, of b): a tree per warp, one
// barrier, a tree over the warps' slots (every warp in the same order),
// broadcast from lane 0
template <typename T>
__device__ __forceinline__ T team_sum(T v, const Team<T>& tm) {
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) tm.red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < (tm.nt >> 5) ? tm.red[lane] : T(0);
  return __shfl_sync(0xffffffffu, warp_sum(v), 0);
}

template <typename T>
__device__ __forceinline__ void team_sum2(T& a, T& b, const Team<T>& tm) {
  const int lane = threadIdx.x & 31;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    tm.red[threadIdx.x >> 5] = a;
    tm.red[WARPS + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  const bool in = lane < (tm.nt >> 5);
  a = __shfl_sync(0xffffffffu, warp_sum(in ? tm.red[lane] : T(0)), 0);
  b = __shfl_sync(0xffffffffu, warp_sum(in ? tm.red[WARPS + lane] : T(0)), 0);
}

// the cluster's sums of the blocks' sums v[0 .. nv-1] (every thread holds
// them): thread r writes them into slot `rank` of set `set` in rank r, a
// cluster barrier, then every thread adds slots 0 .. C-1 in order
template <typename T>
__device__ __forceinline__ void cluster_sums(T* v, int nv, const Team<T>& tm,
                                             int set) {
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  T* slots = tm.cl + set * 2 * CLUSTER_MAX;
  if ((int)threadIdx.x < tm.ranks) {
    T* dst = cl.map_shared_rank(slots, threadIdx.x);
    for (int j = 0; j < nv; ++j) dst[j * CLUSTER_MAX + tm.rank] = v[j];
  }
  cl.sync();
  for (int j = 0; j < nv; ++j) {
    T acc = slots[j * CLUSTER_MAX];
    for (int r = 1; r < tm.ranks; ++r) acc += slots[j * CLUSTER_MAX + r];
    v[j] = acc;
  }
}

// the barrier after a phase whose writes another rank reads
template <class Th>
__device__ __forceinline__ void halo_barrier() {
  if constexpr (Th::CLUSTER)
    cooperative_groups::this_cluster().sync();
  else
    __syncthreads();
}

// the card needs no record of the phases between two cluster barriers
struct Segment {};

#define TMR_OWN 0
#define TMR_TM tm[0]
#define TMR_TEAM_PHASE(CALL)          \
  do {                                \
    const int tid = threadIdx.x;      \
    (void)tid;                        \
    CALL;                             \
    __syncthreads();                  \
  } while (0)
#define TMR_HALO_PHASE(CALL)          \
  do {                                \
    const int tid = threadIdx.x;      \
    (void)tid;                        \
    CALL;                             \
    halo_barrier<Th>();               \
  } while (0)
#define TMR_TEAM_SUM_PHASE(CALL, OUT, SET)                      \
  do {                                                          \
    const int tid = threadIdx.x;                                \
    (void)tid;                                                  \
    CALL;                                                       \
    OUT = team_sum(th[0].part, tm[0]);                          \
    if constexpr (Th::CLUSTER) cluster_sums(&OUT, 1, tm[0], SET); \
  } while (0)
#define TMR_TEAM_SUM2_PHASE(CALL, OUT, OUT2, SET) \
  do {                                            \
    const int tid = threadIdx.x;                  \
    (void)tid;                                    \
    CALL;                                         \
    OUT = th[0].part;                             \
    OUT2 = th[0].part2;                           \
    team_sum2(OUT, OUT2, tm[0]);                  \
    if constexpr (Th::CLUSTER) {                  \
      T both[2] = {OUT, OUT2};                    \
      cluster_sums(both, 2, tm[0], SET);          \
      OUT = both[0];                              \
      OUT2 = both[1];                             \
    }                                             \
  } while (0)
#else
// the card's two trees, lane 0's sums, over the threads' partial sums
template <typename T>
T tree32(T* v) {
  for (int o = 16; o > 0; o >>= 1)
    for (int l = 0; l < o; ++l) v[l] += v[l + o];
  return v[0];
}

template <class Th, typename T>
T host_team_sum(const Th* th, int nt, T Th::*field) {
  T slot[32], v[32];
  for (int w = 0; w < 32; ++w) {
    if (w < nt / 32) {
      for (int l = 0; l < 32; ++l) v[l] = th[w * 32 + l].*field;
      slot[w] = tree32(v);
    } else {
      slot[w] = T(0);
    }
  }
  return tree32(slot);
}

// the cluster's sum: each rank's block sum, added in the ranks' order
// (one rank: the block's sum)
template <class Th, typename T>
T host_sum(const Th* th, const Team<T>* tm, int ranks, T Th::*field) {
  const int nt = tm[0].nt;
  T acc = host_team_sum(th, nt, field);
  for (int r = 1; r < ranks; ++r)
    acc += host_team_sum(th + (size_t)r * nt, nt, field);
  return acc;
}

// The phases since the last cluster barrier, each to run for every thread
// of a rank: the host runs them rank by rank when a phase ends on a
// cluster barrier (each rank as far ahead of the others as the barriers
// let it run), ranks and threads in order (TMR_GROUP_REVERSE_TIDS: in
// reverse).  With one rank, each phase runs as it comes.
struct Segment {
  std::vector<std::function<void(int, int)>> calls;
  void run(int ranks, int nt) {
#ifdef TMR_GROUP_REVERSE_TIDS
    for (int rk = ranks - 1; rk >= 0; --rk)
      for (auto& call : calls)
        for (int tid = nt - 1; tid >= 0; --tid) call(rk, tid);
#else
    for (int rk = 0; rk < ranks; ++rk)
      for (auto& call : calls)
        for (int tid = 0; tid < nt; ++tid) call(rk, tid);
#endif
    calls.clear();
  }
};

#define TMR_OWN ((size_t)rk * tm[0].nt + tid)
#define TMR_TM tm[rk]
#define TMR_TEAM_PHASE(CALL)                                \
  do {                                                      \
    seg.calls.push_back([&](int rk, int tid) { CALL; });    \
    if (ranks == 1) seg.run(ranks, tm[0].nt);               \
  } while (0)
#define TMR_HALO_PHASE(CALL)                                \
  do {                                                      \
    seg.calls.push_back([&](int rk, int tid) { CALL; });    \
    seg.run(ranks, tm[0].nt);                               \
  } while (0)
#define TMR_TEAM_SUM_PHASE(CALL, OUT, SET)             \
  do {                                                 \
    TMR_HALO_PHASE(CALL);                              \
    OUT = host_sum(th, tm, ranks, &Th::part);          \
  } while (0)
#define TMR_TEAM_SUM2_PHASE(CALL, OUT, OUT2, SET)      \
  do {                                                 \
    TMR_HALO_PHASE(CALL);                              \
    OUT = host_sum(th, tm, ranks, &Th::part);          \
    OUT2 = host_sum(th, tm, ranks, &Th::part2);        \
  } while (0)
#endif

// the sets of the cluster's slots: p'Ap's, and r's (with r'r)
enum SumSet { SET_PAP = 0, SET_NU = 1 };

// s = Pinv r, and the block's sum of r's (nu); with `rr`, r'r beside it
// in the same tree
template <typename T, class Th>
TMR_HD void apply_P(Th* th, const Team<T>* tm, int ranks, Segment& seg,
                    bool ss, bool rr, T& nu, T& rsq) {
  (void)ranks;
  (void)seg;
  if (ss) {
    TMR_HALO_PHASE(th[TMR_OWN].pre_s0(TMR_TM));
    TMR_TEAM_PHASE(th[TMR_OWN].pre_t(TMR_TM));
    if (rr)
      TMR_TEAM_SUM2_PHASE(th[TMR_OWN].pre_ss(TMR_TM), nu, rsq, SET_NU);
    else
      TMR_TEAM_SUM_PHASE(th[TMR_OWN].pre_ss(TMR_TM), nu, SET_NU);
  } else if (rr) {
    TMR_TEAM_SUM2_PHASE(th[TMR_OWN].pre_bj(TMR_TM), nu, rsq, SET_NU);
  } else {
    TMR_TEAM_SUM_PHASE(th[TMR_OWN].pre_bj(TMR_TM), nu, SET_NU);
  }
}

// The PCG of one scenario (pcg_fused_plain's loop); every thread of the
// block (of the cluster: tm holds each rank's Team on the host, the
// block's own on the card) runs it.  With `rr` (a preconditioner stored
// narrower than the operands) the exit metric is r'r, else nu.  Returns
// the iterations taken.
template <typename T, class Th>
TMR_HD int pcg_block(Th* th, const Team<T>* tm, int ranks, const Src<T>& src,
                     bool ss, bool rr, bool relative, int max_iter, T tol) {
  (void)ranks;
  Segment seg;
  TMR_HALO_PHASE(th[TMR_OWN].load(TMR_TM, src, tid));
  T nu, rsq = T(0);
  apply_P(th, tm, ranks, seg, ss, rr, nu, rsq);
  const T m0 = rr ? rsq : nu;
  T thr = tol;
  if (relative) {
    thr = tol * tabs(m0);
    if (thr < T(1e-30)) thr = T(1e-30);
  }
  int it = 0;
  if (!(tabs(m0) <= thr)) {  // converged warm start: no pAp = 0 divide
    T beta = T(0);
    while (it < max_iter) {
      TMR_HALO_PHASE(th[TMR_OWN].pstep(TMR_TM, beta));
      T pAp;
      TMR_TEAM_SUM_PHASE(th[TMR_OWN].matvec(TMR_TM), pAp, SET_PAP);
      const T alpha = nu / (pAp != T(0) ? pAp : T(1));
      TMR_TEAM_PHASE(th[TMR_OWN].update(TMR_TM, alpha));
      T nu_new;
      apply_P(th, tm, ranks, seg, ss, rr, nu_new, rsq);
      ++it;
      if (tabs(rr ? rsq : nu_new) <= thr) break;  // S is negative definite
      beta = nu_new / nu;           // on the flagship: nu and pAp keep any sign
      nu = nu_new;
    }
  }
  TMR_HALO_PHASE(th[TMR_OWN].store(TMR_TM, src));
  return it;
}

// the launch's operands for variant v at (N, bs) in values of `item`
// bytes (the cluster's size, where the vectors live, the shared memory a
// block and the workspace a scenario)
template <typename T>
Args<T> shape_args(int v, int B, int N, int bs, int item) {
  Args<T> a{};
  a.B = B;
  a.N = N;
  a.bs = bs;
  a.ranks = variant_ranks(v, N, bs, item);
  a.vshared = global_vectors_shared(N, bs, item);
  a.smem = variant_smem_elems(v, N, bs, item);
  a.wper = variant_work_elems(v, N, bs, item);
  return a;
}

#ifdef __CUDACC__
template <typename T, class Th>
__device__ __forceinline__ void run_block(const Args<T>& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int rank = 0;
  if constexpr (Th::CLUSTER)
    rank = (int)cooperative_groups::this_cluster().block_rank();
  const size_t b = blockIdx.x / a.ranks;
  const Src<T> src = scenario(a, b);
  const Team<T> tm = Th::carve(reinterpret_cast<T*>(smem_raw), src, a,
                               (int)blockDim.x, rank, 0);
  Th th[1];
  const int it = pcg_block<T>(th, &tm, 1, src, a.ss != 0, a.pcode != ST_SAME,
                              a.relative != 0, a.max_iter, a.tol);
  if (rank == 0 && threadIdx.x == 0) a.iters[b] = it;
}

template <typename T, int BS>
__global__ void __launch_bounds__(reg_threads(BS), 1)
pcg_regs(const Args<T> a) {
  run_block<T, RegRow<T, BS>>(a);
}

// one cluster of a.ranks blocks per scenario (the cluster dimension is set
// at launch; MULTI = false: one block per scenario); BS, GOP and MULTI as
// ClRows
template <typename T, int BS, bool GOP, bool MULTI>
__global__ void __launch_bounds__(ClRows<T, BS, GOP, MULTI>::MAX_NT, 1)
pcg_cluster(const Args<T> a) {
  run_block<T, ClRows<T, BS, GOP, MULTI>>(a);
}

// a cluster the card cannot hold at all (cudaOccupancyMaxActiveClusters 0)
constexpr int NO_CLUSTER = -2;

// the launch: B blocks, or B clusters of a.ranks blocks; the kernel's
// attributes set (its shared memory, and clusters past the portable 8)
template <typename T, class Th>
cudaError_t config(const void* kernel, const Args<T>& a, void* stream,
                   cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  *cfg = {};
  cfg->gridDim = dim3((unsigned)a.B * a.ranks);
  cfg->blockDim = dim3(Th::threads(a.N, a.bs, a.ranks));
  cfg->dynamicSmemBytes = a.smem * sizeof(T);
  cfg->stream = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg->dynamicSmemBytes);
  if (Th::CLUSTER) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = a.ranks;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

// clusters of a.ranks blocks the card holds at once, or minus a CUDA error
template <typename T, class Th>
int max_clusters_of(void (*kernel)(const Args<T>), const Args<T>& a) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = config<T, Th>((const void*)kernel, a, nullptr, &attr, &cfg);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T, class Th>
int launch(void (*kernel)(const Args<T>), const Args<T>& a, void* stream) {
  if (a.B == 0) return 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = config<T, Th>((const void*)kernel, a, stream, &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (Th::CLUSTER) {   // a cluster the card cannot hold raises
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n == 0) return NO_CLUSTER;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#define TMR_PCG_REGS(BS) \
  return launch<T, RegRow<T, BS>>(pcg_regs<T, BS>, a, stream)
#define TMR_PCG_CLUSTER(BS, GOP, MULTI)                        \
  return launch<T, ClRows<T, BS, GOP, MULTI>>(                 \
      pcg_cluster<T, BS, GOP, MULTI>, a, stream)

// clusters resident at once for the cluster variant (or the global
// operator) that takes (N, bs)
template <typename T>
int max_clusters(int N, int bs, int item) {
  const int v = variant(N, bs, item);
  if (v == 0) return -1;
  const Args<T> a = shape_args<T>(v, 1, N, bs, item);
#define TMR_MAX(BS)                                                          \
  return v == 3 ? max_clusters_of<T, ClRows<T, BS, false>>(                  \
                      pcg_cluster<T, BS, false, true>, a)                    \
                : max_clusters_of<T, ClRows<T, BS, true>>(                   \
                      pcg_cluster<T, BS, true, true>, a)
  switch (bs) {
    case 12: TMR_MAX(12);
    case 24: TMR_MAX(24);
    default: TMR_MAX(0);
  }
#undef TMR_MAX
}
#else
template <typename T, class Th>
int run_host(const Args<T>& a) {
  const int nt = Th::threads(a.N, a.bs, a.ranks);
  std::vector<T> mem(a.smem * a.ranks);
  std::vector<Th> th((size_t)nt * a.ranks);
  std::vector<Team<T>> tm(a.ranks);
  for (int b = 0; b < a.B; ++b) {
    const Src<T> src = scenario(a, b);
    for (int r = 0; r < a.ranks; ++r)
      tm[r] = Th::carve(mem.data() + a.smem * r, src, a, nt, r,
                        (ptrdiff_t)a.smem);
    a.iters[b] = pcg_block<T>(th.data(), tm.data(), a.ranks, src, a.ss != 0,
                              a.pcode != ST_SAME, a.relative != 0,
                              a.max_iter, a.tol);
  }
  return 0;
}

#define TMR_PCG_REGS(BS) return run_host<T, RegRow<T, BS>>(a)
#define TMR_PCG_CLUSTER(BS, GOP, MULTI) \
  return run_host<T, ClRows<T, BS, GOP, MULTI>>(a)
#endif

// K4 by variant v (for values of `item` bytes, which set the cluster's
// size and where the global operator's vectors live); -1 for a shape, a
// variant or a workspace the kernel cannot take, NO_CLUSTER for a
// cluster the card cannot hold
template <typename T>
int launch_pcg(const void* diag_p, const void* upper, const void* pdiag_p,
               const void* r0, void* dx, void* iters, void* work, int B,
               int N, int bs, int dcode, int pcode, int ss, int relative,
               int max_iter, double tol, void* stream, int v, int item) {
  (void)stream;
  if ((long long)N * bs * bs > INDEX_LIMIT || !takes(v, N, bs, item))
    return -1;
  Args<T> a = shape_args<T>(v, B, N, bs, item);
  if (a.wper > 0 && work == nullptr && B > 0) return -1;
  a.D = diag_p;
  a.P = pdiag_p;
  a.U = (const T*)upper;
  a.r0 = (const T*)r0;
  a.dx = (T*)dx;
  a.work = (T*)work;
  a.iters = (int*)iters;
  a.dcode = dcode;
  a.pcode = pcode;
  a.ss = ss;
  a.relative = relative;
  a.max_iter = max_iter;
  a.tol = (T)tol;
  switch (v) {
    case 0:
      switch (bs) {
        case 2: TMR_PCG_REGS(2);
        case 4: TMR_PCG_REGS(4);
        case 6: TMR_PCG_REGS(6);
        case 8: TMR_PCG_REGS(8);
        case 10: TMR_PCG_REGS(10);
        case 12: TMR_PCG_REGS(12);
        case 14: TMR_PCG_REGS(14);
      }
      return -1;
    case 2:
      switch (bs) {
        case 12: TMR_PCG_CLUSTER(12, true, true);
        case 24: TMR_PCG_CLUSTER(24, true, true);
        default: TMR_PCG_CLUSTER(0, true, true);
      }
    default:
      if (a.ranks == 1)
        switch (bs) {
          case 12: TMR_PCG_CLUSTER(12, false, false);
          case 24: TMR_PCG_CLUSTER(24, false, false);
          default: TMR_PCG_CLUSTER(0, false, false);
        }
      switch (bs) {
        case 12: TMR_PCG_CLUSTER(12, false, true);
        case 24: TMR_PCG_CLUSTER(24, false, true);
        default: TMR_PCG_CLUSTER(0, false, true);
      }
  }
}
#undef TMR_PCG_REGS
#undef TMR_PCG_CLUSTER

}  // namespace tmr_pcg

// tmr_pcg_<f32|f64>: K4 by the variant that takes the shape;
// tmr_pcg_<f32|f64>_as: by the variant given last (any that takes the
// shape, to time one variant beside another; the solve path never calls it)
#define TMR_PCG_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* diag_p, const void* upper,                  \
                      const void* pdiag_p, const void* r0, void* dx,          \
                      void* iters, void* work, int B, int N, int bs,          \
                      int dcode, int pcode, int ss, int relative,             \
                      int max_iter, double tol, void* stream) {               \
    return tmr_pcg::launch_pcg<T>(                                            \
        diag_p, upper, pdiag_p, r0, dx, iters, work, B, N, bs, dcode, pcode,  \
        ss, relative, max_iter, tol, stream,                                  \
        tmr_pcg::variant(N, bs, sizeof(T)), sizeof(T));                       \
  }                                                                           \
  extern "C" int NAME##_as(const void* diag_p, const void* upper,             \
                           const void* pdiag_p, const void* r0, void* dx,     \
                           void* iters, void* work, int B, int N, int bs,     \
                           int dcode, int pcode, int ss, int relative,        \
                           int max_iter, double tol, void* stream, int v) {   \
    return tmr_pcg::launch_pcg<T>(diag_p, upper, pdiag_p, r0, dx, iters,      \
                                  work, B, N, bs, dcode, pcode, ss, relative, \
                                  max_iter, tol, stream, v, sizeof(T));       \
  }
TMR_PCG_ENTRY(tmr_pcg_f32, float)
TMR_PCG_ENTRY(tmr_pcg_f64, double)
#undef TMR_PCG_ENTRY

// the variant that takes (N, bs) in values of `item` bytes: 0 registers,
// 3 cluster, 2 global operator (ops/fused_pcg.variant)
extern "C" int tmr_pcg_variant(int N, int bs, int item) {
  return tmr_pcg::variant(N, bs, item);
}

// the blocks of the cluster variant's cluster at (N, bs): the smallest
// that fits, 0 past CLUSTER_MAX blocks
extern "C" int tmr_pcg_cluster_size(int N, int bs, int item) {
  return tmr_pcg::cluster_size(N, bs, item);
}

// shared memory of one block, in values (ops/fused_pcg.smem_bytes)
extern "C" long long tmr_pcg_smem_elems(int N, int bs, int item) {
  return (long long)tmr_pcg::smem_elems(N, bs, item);
}

// the workspace of one scenario, in values (the global operator's
// converted operator, and its vectors past shared memory)
extern "C" long long tmr_pcg_work_elems(int N, int bs, int item) {
  return (long long)tmr_pcg::work_elems(N, bs, item);
}

// the workspace of one scenario of variant v, in values (tmr_pcg_*_as)
extern "C" long long tmr_pcg_variant_work_elems(int N, int bs, int item,
                                                int v) {
  return (long long)tmr_pcg::variant_work_elems(v, N, bs, item);
}

// cudaOccupancyMaxActiveClusters for the cluster (or the global operator)
// that takes (N, bs) in values of `item` bytes (minus a CUDA error; -1 for
// the register variant's shapes, and in the host build, which has no card)
extern "C" int tmr_pcg_max_clusters(int N, int bs, int item) {
#ifdef __CUDACC__
  return item == 4 ? tmr_pcg::max_clusters<float>(N, bs, item)
                   : tmr_pcg::max_clusters<double>(N, bs, item);
#else
  (void)N;
  (void)bs;
  (void)item;
  return -1;
#endif
}

// element i of a packed operand stored as `code`, widened to f64 (the
// storage decoders, held to PyTorch's casts by the tests)
extern "C" double tmr_pcg_stored(const void* p, long long i, int code) {
  return tmr_pcg::stored<double>(p, (size_t)i, code);
}
