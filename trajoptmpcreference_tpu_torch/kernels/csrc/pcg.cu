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
// What bounds it on the H100: neither bytes nor flops.  A scenario's
// system (~94 KB in f32 at N = 64, bs = 12) is read once; an iteration
// then does ~84 multiply-adds per row of S between two block sums, each a
// chain of shuffles and a barrier, so the solve is bound by the latency
// of the block's barriers and sums and by the instructions each
// multiply-add costs (PERF.md, "Inside K4": the sums' shuffle trees and
// the other barriers take about a fifth of the time each).  The design:
//
// * Registers (RegRow: the block sizes the plants give, bs = 2, 4, ...,
//   14, and up to 1,024 rows of S, 768 from bs = 10): each thread owns R
//   = 2 rows g = (k, i) and unpacks, once at load, row i of D_k, of U_k,
//   of U_{k-1}^T and of P_k into registers, with its entries of x, r, p,
//   s and Ap.  The block size is a template parameter, so the loops over
//   a block row unroll and no packed index is computed inside the
//   iteration.  Shared memory holds only what other threads read: p and s
//   (a zero block on each side, so the first and last block rows take no
//   branch), r (then the SS temporary t) and one reduction slot per warp:
//   9,536 bytes at N = 64, bs = 12 in f32.  A block of 384 threads
//   (bs >= 10; 512 below) holds one SM's registers, so one block runs per
//   SM.
// * Shared operator (ShRows: any other shape the size limit admits, bs
//   read at run time): the packed blocks stay in shared memory, each
//   thread walks rows tid, tid + nt, ...; x lives in dx.
//
// Both run one phase sequence (pcg_block) with a barrier after each phase
// and a block sum as one shuffle tree per warp, one barrier, and a second
// tree over the warps' slots (every warp sums the slots in the same order,
// so every thread holds the same value and takes the same exit).  Per
// iteration: p (1), S p and p'Ap (1), x and r (1), then the
// preconditioner: s = P r and r's (1) for J / BJ; for SS s0 = P r (1),
// t = U s0_{k+1} + U^T s0_{k-1} (1), s = s0 - P t and r's (1).  4 barriers
// with J / BJ, 6 with SS.  The phase
// order alone keeps a reduction slot from being overwritten before every
// warp has read it, so the slots need no barrier of their own.
//
// The same source compiles as plain C++ (no __CUDACC__): each phase runs
// for every thread of the block in turn (TMR_GROUP_REVERSE_TIDS: in
// reverse, to catch a phase in which one thread reads what another
// writes), the block sums follow the warps' shuffle trees, and a host
// loop runs the scenarios one by one, so g++ checks the arithmetic and
// the work partition on the CPU (tests/test_torch_kernel_sources.py).
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TMR_HD __host__ __device__ __forceinline__
#else
#include <stddef.h>
#include <vector>
#define TMR_HD inline
#endif

namespace tmr_pcg {

constexpr int WARPS = 32;       // reduction slots: one per warp of a block
constexpr int MAX_THREADS = 1024;

template <typename T>
TMR_HD T tabs(T v) { return v < T(0) ? -v : v; }

// position of (i, j) of a symmetric block in its packed lower triangle
TMR_HD int sym(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

TMR_HD int round_warp(int n) { return (n + 31) / 32 * 32; }

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

// shared memory of one block, in values, for the variant that takes (N, bs)
TMR_HD size_t smem_elems(int N, int bs) {
  const size_t n = (size_t)N * bs, tri = (size_t)bs * (bs + 1) / 2;
  if (use_regs(N, bs)) return 2 * (n + 2 * bs) + n + WARPS;
  return 2 * N * tri + (size_t)N * bs * bs + 4 * n + WARPS;
}

// the launch's operands, whole batch
template <typename T>
struct Args {
  const T *D, *U, *P, *r0;
  T* dx;
  int* iters;
  int B, N, bs, ss, relative, max_iter;
  T tol;
};

// one scenario's slice of the operands
template <typename T>
struct Src {
  const T *D, *U, *P, *r0;
  T* dx;
};

template <typename T>
TMR_HD Src<T> scenario(const Args<T>& a, size_t b) {
  const size_t n = (size_t)a.N * a.bs, nD = (size_t)a.N * (a.bs * (a.bs + 1) / 2);
  return Src<T>{a.D + b * nD, a.U + b * n * a.bs, a.P + b * nD, a.r0 + b * n,
                a.dx + b * n};
}

// the block's shared state (the same for every thread)
template <typename T>
struct Team {
  T *p, *s, *v, *w, *red;  // p, s; v: r (then t); w: Ap (then t), shared variant
  T *D, *P, *U;            // the operator, shared variant
  int N, bs, n, nt;
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
  T part;

  static TMR_HD int threads(int N, int) {
    return round_warp((N * BS + R - 1) / R);
  }
  static TMR_HD Team<T> carve(T* m, int N, int, int nt) {
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
      const T* Dk = src.D + k[m] * (BS * (BS + 1) / 2);
      const T* Pk = src.P + k[m] * (BS * (BS + 1) / 2);
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
    part = T(0);
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
  // J / BJ: s = P r, and the thread's sum of r_g s_g
  TMR_HD void pre_bj(const Team<T>& tm) {
#pragma unroll
    for (int m = 0; m < R; ++m) {
      s[m] = dot_row<BS>(P[m], tm.v + k[m] * BS);
      part = m == 0 ? r[m] * s[m] : part + r[m] * s[m];
    }
  }
  // SS: s0 = P r; t = U s0_{k+1} + U^T s0_{k-1}; s = s0 - P t, and r_g s_g
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
    for (int m = 0; m < R; ++m) {
      s[m] = s0[m] - dot_row<BS>(P[m], tm.v + k[m] * BS);
      part = m == 0 ? r[m] * s[m] : part + r[m] * s[m];
    }
  }
  TMR_HD void store(const Team<T>&, const Src<T>& src) {
#pragma unroll
    for (int m = 0; m < R; ++m)
      if (on[m]) src.dx[g[m]] = x[m];
  }
};

// ---- the shared-operator variant: rows tid, tid + nt, ... of S -----------
// (D v)_i for one packed symmetric block, from the first term
template <typename T>
TMR_HD T sym_row(const T* D, const T* v, int i, int bs) {
  const int base = i * (i + 1) / 2;
  T acc = D[base] * v[0];
  for (int j = 1; j <= i; ++j) acc += D[base + j] * v[j];
  for (int j = i + 1; j < bs; ++j) acc += D[j * (j + 1) / 2 + i] * v[j];
  return acc;
}

// (U v)_i and (U^T v)_i for one row-major bs x bs block U
template <typename T>
TMR_HD T up_row(const T* U, const T* v, int i, int bs) {
  T acc = U[i * bs] * v[0];
  for (int j = 1; j < bs; ++j) acc += U[i * bs + j] * v[j];
  return acc;
}

template <typename T>
TMR_HD T upT_row(const T* U, const T* v, int i, int bs) {
  T acc = U[i] * v[0];
  for (int j = 1; j < bs; ++j) acc += U[j * bs + i] * v[j];
  return acc;
}

template <typename T>
struct ShRows {
  int tid;
  T part;
  T* x;  // the scenario's dx: only the thread of row g reads or writes x_g

  static TMR_HD int threads(int N, int bs) {
    const int n = round_warp(N * bs);
    return n < MAX_THREADS ? n : MAX_THREADS;
  }
  static TMR_HD Team<T> carve(T* m, int N, int bs, int nt) {
    Team<T> t{};
    t.N = N;
    t.bs = bs;
    t.n = N * bs;
    t.nt = nt;
    const size_t tri = (size_t)bs * (bs + 1) / 2;
    t.D = m;
    t.P = t.D + N * tri;
    t.U = t.P + N * tri;
    t.v = t.U + (size_t)N * bs * bs;
    t.p = t.v + t.n;
    t.s = t.p + t.n;
    t.w = t.s + t.n;
    t.red = t.w + t.n;
    return t;
  }

  // row (k, i) of U_k v_{k+1} + U_{k-1}^T v_{k-1}
  static TMR_HD T off(const Team<T>& tm, const T* v, int k, int i) {
    const int bs = tm.bs, bb = bs * bs;
    T acc = T(0);
    if (k + 1 < tm.N) acc = up_row(tm.U + k * bb, v + (k + 1) * bs, i, bs);
    if (k > 0) acc += upT_row(tm.U + (k - 1) * bb, v + (k - 1) * bs, i, bs);
    return acc;
  }
  TMR_HD T prow(const Team<T>& tm, const T* v, int g) const {
    const int k = g / tm.bs;
    return sym_row(tm.P + k * (tm.bs * (tm.bs + 1) / 2), v + k * tm.bs,
                   g - k * tm.bs, tm.bs);
  }

  TMR_HD void load(const Team<T>& tm, const Src<T>& src, int t) {
    tid = t;
    part = T(0);
    x = src.dx;
    const int nD = tm.N * (tm.bs * (tm.bs + 1) / 2), nU = tm.N * tm.bs * tm.bs;
    for (int e = tid; e < nD; e += tm.nt) {
      tm.D[e] = src.D[e];
      tm.P[e] = src.P[e];
    }
    for (int e = tid; e < nU; e += tm.nt) tm.U[e] = src.U[e];
    for (int g = tid; g < tm.n; g += tm.nt) {
      tm.v[g] = src.r0[g];
      tm.p[g] = T(0);
      src.dx[g] = T(0);
    }
  }
  TMR_HD void pstep(const Team<T>& tm, T beta) {
    for (int g = tid; g < tm.n; g += tm.nt) tm.p[g] = tm.s[g] + beta * tm.p[g];
  }
  TMR_HD void matvec(const Team<T>& tm) {
    part = T(0);
    for (int g = tid; g < tm.n; g += tm.nt) {
      const int k = g / tm.bs, i = g - k * tm.bs;
      const T a = sym_row(tm.D + k * (tm.bs * (tm.bs + 1) / 2), tm.p + k * tm.bs,
                          i, tm.bs);
      tm.w[g] = a + off(tm, tm.p, k, i);
      part += tm.p[g] * tm.w[g];
    }
  }
  TMR_HD void update(const Team<T>& tm, T alpha) {
    for (int g = tid; g < tm.n; g += tm.nt) {
      x[g] += alpha * tm.p[g];
      tm.v[g] -= alpha * tm.w[g];
    }
  }
  TMR_HD void pre_bj(const Team<T>& tm) {
    part = T(0);
    for (int g = tid; g < tm.n; g += tm.nt) {
      tm.s[g] = prow(tm, tm.v, g);
      part += tm.v[g] * tm.s[g];
    }
  }
  TMR_HD void pre_s0(const Team<T>& tm) {
    for (int g = tid; g < tm.n; g += tm.nt) tm.s[g] = prow(tm, tm.v, g);
  }
  TMR_HD void pre_t(const Team<T>& tm) {
    for (int g = tid; g < tm.n; g += tm.nt) {
      const int k = g / tm.bs;
      tm.w[g] = off(tm, tm.s, k, g - k * tm.bs);
    }
  }
  TMR_HD void pre_ss(const Team<T>& tm) {
    part = T(0);
    for (int g = tid; g < tm.n; g += tm.nt) {
      tm.s[g] -= prow(tm, tm.w, g);
      part += tm.v[g] * tm.s[g];
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

// the block's sum of v: a tree per warp, one barrier, a tree over the
// warps' slots (every warp in the same order), broadcast from lane 0
template <typename T>
__device__ __forceinline__ T team_sum(T v, const Team<T>& tm) {
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) tm.red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < (tm.nt >> 5) ? tm.red[lane] : T(0);
  return __shfl_sync(0xffffffffu, warp_sum(v), 0);
}

#define TMR_OWN 0
#define TMR_TEAM_PHASE(CALL)          \
  do {                                \
    const int tid = threadIdx.x;      \
    (void)tid;                        \
    CALL;                             \
    __syncthreads();                  \
  } while (0)
#define TMR_TEAM_SUM_PHASE(CALL, OUT) \
  do {                                \
    const int tid = threadIdx.x;      \
    (void)tid;                        \
    CALL;                             \
    OUT = team_sum(th[0].part, tm);   \
  } while (0)
#else
// the card's two trees, lane 0's sums, over the threads' partial sums
template <typename T>
T tree32(T* v) {
  for (int o = 16; o > 0; o >>= 1)
    for (int l = 0; l < o; ++l) v[l] += v[l + o];
  return v[0];
}

template <class Th>
auto host_team_sum(const Th* th, int nt) -> decltype(th[0].part) {
  using T = decltype(th[0].part);
  T slot[32], v[32];
  for (int w = 0; w < 32; ++w) {
    if (w < nt / 32) {
      for (int l = 0; l < 32; ++l) v[l] = th[w * 32 + l].part;
      slot[w] = tree32(v);
    } else {
      slot[w] = T(0);
    }
  }
  return tree32(slot);
}

#define TMR_OWN tid
#ifdef TMR_GROUP_REVERSE_TIDS
#define TMR_TEAM_FOR for (int tid = tm.nt - 1; tid >= 0; --tid)
#else
#define TMR_TEAM_FOR for (int tid = 0; tid < tm.nt; ++tid)
#endif
#define TMR_TEAM_PHASE(CALL) \
  do {                       \
    TMR_TEAM_FOR CALL;       \
  } while (0)
#define TMR_TEAM_SUM_PHASE(CALL, OUT)   \
  do {                                  \
    TMR_TEAM_FOR CALL;                  \
    OUT = host_team_sum(th, tm.nt);     \
  } while (0)
#endif

// s = Pinv r, and the block's sum of r's
template <typename T, class Th>
TMR_HD T apply_P(Th* th, const Team<T>& tm, bool ss) {
  T nu;
  if (ss) {
    TMR_TEAM_PHASE(th[TMR_OWN].pre_s0(tm));
    TMR_TEAM_PHASE(th[TMR_OWN].pre_t(tm));
    TMR_TEAM_SUM_PHASE(th[TMR_OWN].pre_ss(tm), nu);
  } else {
    TMR_TEAM_SUM_PHASE(th[TMR_OWN].pre_bj(tm), nu);
  }
  return nu;
}

// The PCG of one scenario (pcg_fused_plain's loop); every thread of the
// block runs it.  Returns the number of iterations taken.
template <typename T, class Th>
TMR_HD int pcg_block(Th* th, const Team<T>& tm, const Src<T>& src, bool ss,
                     bool relative, int max_iter, T tol) {
  TMR_TEAM_PHASE(th[TMR_OWN].load(tm, src, tid));
  T nu = apply_P(th, tm, ss);
  T thr = tol;
  if (relative) {
    thr = tol * tabs(nu);
    if (thr < T(1e-30)) thr = T(1e-30);
  }
  int it = 0;
  if (!(tabs(nu) <= thr)) {  // converged warm start: no pAp = 0 divide
    T beta = T(0);
    while (it < max_iter) {
      TMR_TEAM_PHASE(th[TMR_OWN].pstep(tm, beta));
      T pAp;
      TMR_TEAM_SUM_PHASE(th[TMR_OWN].matvec(tm), pAp);
      const T alpha = nu / (pAp != T(0) ? pAp : T(1));
      TMR_TEAM_PHASE(th[TMR_OWN].update(tm, alpha));
      const T nu_new = apply_P(th, tm, ss);
      ++it;
      if (tabs(nu_new) <= thr) break;  // S is negative definite on the
      beta = nu_new / nu;              // flagship: nu and pAp keep any sign
      nu = nu_new;
    }
  }
  TMR_TEAM_PHASE(th[TMR_OWN].store(tm, src));
  return it;
}

#ifdef __CUDACC__
template <typename T, class Th>
__device__ __forceinline__ void run_block(const Args<T>& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Team<T> tm = Th::carve(reinterpret_cast<T*>(smem_raw), a.N, a.bs,
                               (int)blockDim.x);
  Th th[1];
  const int it = pcg_block<T>(th, tm, scenario(a, blockIdx.x), a.ss != 0,
                              a.relative != 0, a.max_iter, a.tol);
  if (threadIdx.x == 0) a.iters[blockIdx.x] = it;
}

template <typename T, int BS>
__global__ void __launch_bounds__(reg_threads(BS), 1)
pcg_regs(const Args<T> a) {
  run_block<T, RegRow<T, BS>>(a);
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1) pcg_shared(const Args<T> a) {
  run_block<T, ShRows<T>>(a);
}

template <typename T, class Th>
int launch(void (*kernel)(const Args<T>), const Args<T>& a, void* stream) {
  const size_t bytes = smem_elems(a.N, a.bs) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B, Th::threads(a.N, a.bs), bytes,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

#define TMR_PCG_REGS(BS) \
  return launch<T, RegRow<T, BS>>(pcg_regs<T, BS>, a, stream)
#else
template <typename T, class Th>
int run_host(const Args<T>& a) {
  const int nt = Th::threads(a.N, a.bs);
  std::vector<T> mem(smem_elems(a.N, a.bs));
  std::vector<Th> th(nt);
  const Team<T> tm = Th::carve(mem.data(), a.N, a.bs, nt);
  for (int b = 0; b < a.B; ++b)
    a.iters[b] = pcg_block<T>(th.data(), tm, scenario(a, b), a.ss != 0,
                              a.relative != 0, a.max_iter, a.tol);
  return 0;
}

#define TMR_PCG_REGS(BS) return run_host<T, RegRow<T, BS>>(a)
#endif

// the register variant where the shape takes it, else the shared operator
template <typename T>
int launch_pcg(const void* diag_p, const void* upper, const void* pdiag_p,
               const void* r0, void* dx, void* iters, int B, int N, int bs,
               int ss, int relative, int max_iter, double tol, void* stream) {
  const Args<T> a{(const T*)diag_p, (const T*)upper, (const T*)pdiag_p,
                  (const T*)r0, (T*)dx, (int*)iters, B, N, bs, ss, relative,
                  max_iter, (T)tol};
  (void)stream;
  if (use_regs(N, bs)) {
    switch (bs) {
      case 2: TMR_PCG_REGS(2);
      case 4: TMR_PCG_REGS(4);
      case 6: TMR_PCG_REGS(6);
      case 8: TMR_PCG_REGS(8);
      case 10: TMR_PCG_REGS(10);
      case 12: TMR_PCG_REGS(12);
      case 14: TMR_PCG_REGS(14);
    }
  }
#ifdef __CUDACC__
  return launch<T, ShRows<T>>(pcg_shared<T>, a, stream);
#else
  return run_host<T, ShRows<T>>(a);
#endif
}
#undef TMR_PCG_REGS

}  // namespace tmr_pcg

#define TMR_PCG_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* diag_p, const void* upper,                 \
                      const void* pdiag_p, const void* r0, void* dx,         \
                      void* iters, int B, int N, int bs, int ss,             \
                      int relative, int max_iter, double tol, void* stream) { \
    return tmr_pcg::launch_pcg<T>(diag_p, upper, pdiag_p, r0, dx, iters, B,  \
                                  N, bs, ss, relative, max_iter, tol,        \
                                  stream);                                   \
  }
TMR_PCG_ENTRY(tmr_pcg_f32, float)
TMR_PCG_ENTRY(tmr_pcg_f64, double)
#undef TMR_PCG_ENTRY

// shared memory of one block, in values (ops/fused_pcg.smem_bytes)
extern "C" long long tmr_pcg_smem_elems(int N, int bs) {
  return (long long)tmr_pcg::smem_elems(N, bs);
}

// 1 when (N, bs) runs the register variant, 0 the shared operator
extern "C" int tmr_pcg_uses_registers(int N, int bs) {
  return (int)tmr_pcg::use_regs(N, bs);
}
