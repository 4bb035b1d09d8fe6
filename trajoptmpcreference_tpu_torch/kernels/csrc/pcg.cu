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
// variants, chosen per (N, bs, type) by `variant`:
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
// * 1, shared operator (ShRows<T, false>: any other shape whose system
//   and vectors fit one block's shared memory, bs read at run time): the
//   packed blocks are copied into shared memory at load, converted there
//   once to the operands' type (so the shared memory a shape needs, and
//   the variant it takes, do not depend on the storage); each thread
//   walks rows tid, tid + nt, ...; x lives in dx.
// * 2, global operator (ShRows<T, true>: every shape the other two
//   refuse): the same rows and phases, with the packed blocks left in
//   device memory, read through the read-only path and converted at each
//   use, and the vectors v, p, s, w in a workspace the wrapper allocates
//   (4 N bs values a scenario); only the reduction slots are in shared
//   memory.  __syncthreads() orders the block's device-memory writes as it
//   orders its shared ones.  Each iteration reads the operator from L2 or
//   device memory again: a cluster of blocks sharing a scenario in
//   distributed shared memory is the Hopper design for these shapes
//   (ROADMAP.md, queue 2).
//
// All run one phase sequence (pcg_block) with a barrier after each phase
// and a block sum as one shuffle tree per warp, one barrier, and a second
// tree over the warps' slots (every warp sums the slots in the same order,
// so every thread holds the same value and takes the same exit).  Per
// iteration: p (1), S p and p'Ap (1), x and r (1), then the
// preconditioner: s = P r and r's (1) for J / BJ; for SS s0 = P r (1),
// t = U s0_{k+1} + U^T s0_{k-1} (1), s = s0 - P t and r's (1).  4 barriers
// with J / BJ, 6 with SS, with either exit.  The phase order alone keeps a
// reduction slot from being overwritten before every warp has read it, so
// the slots need no barrier of their own.
//
// The same source compiles as plain C++ (no __CUDACC__): each phase runs
// for every thread of the block in turn (TMR_GROUP_REVERSE_TIDS: in
// reverse, to catch a phase in which one thread reads what another
// writes), the block sums follow the warps' shuffle trees, 16-bit storage
// is decoded bit by bit, and a host loop runs the scenarios one by one, so
// g++ checks the arithmetic and the work partition on the CPU
// (tests/test_torch_kernel_sources.py, tests/test_torch_pcg_large.py).
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>
#ifdef __CUDACC__
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#define TMR_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define TMR_HD inline
#endif

namespace tmr_pcg {

constexpr int WARPS = 32;       // reduction slots: two per warp of a block
constexpr int MAX_THREADS = 1024;
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

// shared memory of the shared-operator variant, in values
TMR_HD size_t shared_operator_elems(int N, int bs) {
  const size_t n = (size_t)N * bs, tri = (size_t)bs * (bs + 1) / 2;
  return 2 * N * tri + (size_t)N * bs * bs + 4 * n + 2 * WARPS;
}

// 0 registers, 1 shared operator, 2 global operator, for values of
// `item` bytes
TMR_HD int variant(int N, int bs, int item) {
  if (use_regs(N, bs)) return 0;
  return shared_operator_elems(N, bs) * item <= SMEM_LIMIT ? 1 : 2;
}

// shared memory of one block, in values, for the variant that takes
// (N, bs) in values of `item` bytes
TMR_HD size_t smem_elems(int N, int bs, int item) {
  switch (variant(N, bs, item)) {
    case 0: return 3 * (size_t)N * bs + 4 * bs + 2 * WARPS;
    case 1: return shared_operator_elems(N, bs);
    default: return 2 * WARPS;
  }
}

// the global operator's workspace per scenario, in values (v, p, s, w)
TMR_HD size_t work_elems(int N, int bs, int item) {
  return variant(N, bs, item) == 2 ? 4 * (size_t)N * bs : 0;
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
                a.work ? a.work + b * 4 * n : nullptr};
}

// the block's shared state (the same for every thread)
template <typename T>
struct Team {
  T *p, *s, *v, *w, *red;  // p, s; v: r (then t); w: Ap (then t), ShRows
  T *D, *P, *U;            // the operator, shared-operator variant
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
  T part, part2;   // the thread's shares of r's (or p'Ap) and of r'r

  static TMR_HD int threads(int N, int) {
    return round_warp((N * BS + R - 1) / R);
  }
  static TMR_HD Team<T> carve(T* m, const Src<T>&, int N, int, int nt) {
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

// ---- the shared- and global-operator variants: rows tid, tid + nt, ... ----
// (D v)_i for one packed symmetric block D (a pointer into shared memory,
// or a Stored operand in device memory), from the first term
template <typename T, typename A>
TMR_HD T sym_row(const A& D, const T* v, int i, int bs) {
  const int base = i * (i + 1) / 2;
  T acc = D[base] * v[0];
  for (int j = 1; j <= i; ++j) acc += D[base + j] * v[j];
  for (int j = i + 1; j < bs; ++j) acc += D[j * (j + 1) / 2 + i] * v[j];
  return acc;
}

// (U v)_i and (U^T v)_i for one row-major bs x bs block U
template <typename T, typename A>
TMR_HD T up_row(const A& U, const T* v, int i, int bs) {
  T acc = U[i * bs] * v[0];
  for (int j = 1; j < bs; ++j) acc += U[i * bs + j] * v[j];
  return acc;
}

template <typename T, typename A>
TMR_HD T upT_row(const A& U, const T* v, int i, int bs) {
  T acc = U[i] * v[0];
  for (int j = 1; j < bs; ++j) acc += U[j * bs + i] * v[j];
  return acc;
}

// device memory in the operands' type, through the read-only path
template <typename T>
struct ReadOnly {
  const T* p;
  TMR_HD T operator[](size_t i) const { return ldro(p + i); }
  TMR_HD ReadOnly operator+(size_t k) const { return ReadOnly{p + k}; }
};

// how the variant reads its operator: plain pointers into shared memory,
// or device memory (the packed blocks in their storage)
template <typename T, bool GLOBAL>
struct OperatorOf {
  typedef const T* Packed;
  typedef const T* Upper;
};
template <typename T>
struct OperatorOf<T, true> {
  typedef Stored<T> Packed;
  typedef ReadOnly<T> Upper;
};

template <typename T, bool GLOBAL>
struct ShRows {
  int tid;
  T part, part2;
  T* x;  // the scenario's dx: only the thread of row g reads or writes x_g
  typename OperatorOf<T, GLOBAL>::Packed D, P;
  typename OperatorOf<T, GLOBAL>::Upper U;

  static TMR_HD int threads(int N, int bs) {
    const int n = round_warp(N * bs);
    return n < MAX_THREADS ? n : MAX_THREADS;
  }
  static TMR_HD Team<T> carve(T* m, const Src<T>& src, int N, int bs,
                              int nt) {
    Team<T> t{};
    t.N = N;
    t.bs = bs;
    t.n = N * bs;
    t.nt = nt;
    T* vec = src.work;
    if (!GLOBAL) {
      const size_t tri = (size_t)bs * (bs + 1) / 2;
      t.D = m;
      t.P = t.D + N * tri;
      t.U = t.P + N * tri;
      vec = t.U + (size_t)N * bs * bs;
      m = vec + 4 * t.n;
    }
    t.v = vec;
    t.p = t.v + t.n;
    t.s = t.p + t.n;
    t.w = t.s + t.n;
    t.red = m;
    return t;
  }

  // row (k, i) of U_k v_{k+1} + U_{k-1}^T v_{k-1}
  TMR_HD T off(const Team<T>& tm, const T* v, int k, int i) const {
    const int bs = tm.bs, bb = bs * bs;
    T acc = T(0);
    if (k + 1 < tm.N) acc = up_row(U + (size_t)k * bb, v + (k + 1) * bs, i, bs);
    if (k > 0) acc += upT_row(U + (size_t)(k - 1) * bb, v + (k - 1) * bs, i, bs);
    return acc;
  }
  TMR_HD T prow(const Team<T>& tm, const T* v, int g) const {
    const int k = g / tm.bs;
    return sym_row(P + (size_t)k * (tm.bs * (tm.bs + 1) / 2), v + k * tm.bs,
                   g - k * tm.bs, tm.bs);
  }

  // the operator where the variant reads it: in device memory as it is,
  // or copied into shared memory, converted once
  template <bool G = GLOBAL>
  TMR_HD typename std::enable_if<G>::type place_operator(const Team<T>&,
                                                         const Src<T>& src) {
    D = src.D;
    P = src.P;
    U = ReadOnly<T>{src.U};
  }
  template <bool G = GLOBAL>
  TMR_HD typename std::enable_if<!G>::type place_operator(const Team<T>& tm,
                                                          const Src<T>& src) {
    const int nD = tm.N * (tm.bs * (tm.bs + 1) / 2), nU = tm.N * tm.bs * tm.bs;
    for (int e = tid; e < nD; e += tm.nt) {
      tm.D[e] = src.D[e];
      tm.P[e] = src.P[e];
    }
    for (int e = tid; e < nU; e += tm.nt) tm.U[e] = src.U[e];
    D = tm.D;
    P = tm.P;
    U = tm.U;
  }

  TMR_HD void load(const Team<T>& tm, const Src<T>& src, int t) {
    tid = t;
    part = part2 = T(0);
    x = src.dx;
    place_operator(tm, src);
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
      const T a = sym_row(D + (size_t)k * (tm.bs * (tm.bs + 1) / 2),
                          tm.p + k * tm.bs, i, tm.bs);
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
    part = part2 = T(0);
    for (int g = tid; g < tm.n; g += tm.nt) {
      tm.s[g] = prow(tm, tm.v, g);
      part += tm.v[g] * tm.s[g];
      part2 += tm.v[g] * tm.v[g];
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
    part = part2 = T(0);
    for (int g = tid; g < tm.n; g += tm.nt) {
      tm.s[g] -= prow(tm, tm.w, g);
      part += tm.v[g] * tm.s[g];
      part2 += tm.v[g] * tm.v[g];
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
#define TMR_TEAM_SUM2_PHASE(CALL, OUT, OUT2) \
  do {                                       \
    const int tid = threadIdx.x;             \
    (void)tid;                               \
    CALL;                                    \
    OUT = th[0].part;                        \
    OUT2 = th[0].part2;                      \
    team_sum2(OUT, OUT2, tm);                \
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
#define TMR_TEAM_SUM_PHASE(CALL, OUT)            \
  do {                                           \
    TMR_TEAM_FOR CALL;                           \
    OUT = host_team_sum(th, tm.nt, &Th::part);   \
  } while (0)
#define TMR_TEAM_SUM2_PHASE(CALL, OUT, OUT2)     \
  do {                                           \
    TMR_TEAM_FOR CALL;                           \
    OUT = host_team_sum(th, tm.nt, &Th::part);   \
    OUT2 = host_team_sum(th, tm.nt, &Th::part2); \
  } while (0)
#endif

// s = Pinv r, and the block's sum of r's (nu); with `rr`, r'r beside it
// in the same tree
template <typename T, class Th>
TMR_HD void apply_P(Th* th, const Team<T>& tm, bool ss, bool rr, T& nu,
                    T& rsq) {
  if (ss) {
    TMR_TEAM_PHASE(th[TMR_OWN].pre_s0(tm));
    TMR_TEAM_PHASE(th[TMR_OWN].pre_t(tm));
    if (rr)
      TMR_TEAM_SUM2_PHASE(th[TMR_OWN].pre_ss(tm), nu, rsq);
    else
      TMR_TEAM_SUM_PHASE(th[TMR_OWN].pre_ss(tm), nu);
  } else if (rr) {
    TMR_TEAM_SUM2_PHASE(th[TMR_OWN].pre_bj(tm), nu, rsq);
  } else {
    TMR_TEAM_SUM_PHASE(th[TMR_OWN].pre_bj(tm), nu);
  }
}

// The PCG of one scenario (pcg_fused_plain's loop); every thread of the
// block runs it.  With `rr` (a preconditioner stored narrower than the
// operands) the exit metric is r'r, else nu.  Returns the iterations taken.
template <typename T, class Th>
TMR_HD int pcg_block(Th* th, const Team<T>& tm, const Src<T>& src, bool ss,
                     bool rr, bool relative, int max_iter, T tol) {
  TMR_TEAM_PHASE(th[TMR_OWN].load(tm, src, tid));
  T nu, rsq = T(0);
  apply_P(th, tm, ss, rr, nu, rsq);
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
      TMR_TEAM_PHASE(th[TMR_OWN].pstep(tm, beta));
      T pAp;
      TMR_TEAM_SUM_PHASE(th[TMR_OWN].matvec(tm), pAp);
      const T alpha = nu / (pAp != T(0) ? pAp : T(1));
      TMR_TEAM_PHASE(th[TMR_OWN].update(tm, alpha));
      T nu_new;
      apply_P(th, tm, ss, rr, nu_new, rsq);
      ++it;
      if (tabs(rr ? rsq : nu_new) <= thr) break;  // S is negative definite
      beta = nu_new / nu;           // on the flagship: nu and pAp keep any sign
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
  const Src<T> src = scenario(a, blockIdx.x);
  const Team<T> tm = Th::carve(reinterpret_cast<T*>(smem_raw), src, a.N,
                               a.bs, (int)blockDim.x);
  Th th[1];
  const int it = pcg_block<T>(th, tm, src, a.ss != 0, a.pcode != ST_SAME,
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
  run_block<T, ShRows<T, false>>(a);
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1) pcg_global(const Args<T> a) {
  run_block<T, ShRows<T, true>>(a);
}

template <typename T, class Th>
int launch(void (*kernel)(const Args<T>), const Args<T>& a, void* stream) {
  const size_t bytes = smem_elems(a.N, a.bs, sizeof(T)) * sizeof(T);
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
  std::vector<T> mem(smem_elems(a.N, a.bs, sizeof(T)));
  std::vector<Th> th(nt);
  for (int b = 0; b < a.B; ++b) {
    const Src<T> src = scenario(a, b);
    const Team<T> tm = Th::carve(mem.data(), src, a.N, a.bs, nt);
    a.iters[b] = pcg_block<T>(th.data(), tm, src, a.ss != 0,
                              a.pcode != ST_SAME, a.relative != 0,
                              a.max_iter, a.tol);
  }
  return 0;
}

#define TMR_PCG_REGS(BS) return run_host<T, RegRow<T, BS>>(a)
#endif

// the variant that takes (N, bs) in T; -1 for a shape or a workspace the
// kernel cannot take
template <typename T>
int launch_pcg(const void* diag_p, const void* upper, const void* pdiag_p,
               const void* r0, void* dx, void* iters, void* work, int B,
               int N, int bs, int dcode, int pcode, int ss, int relative,
               int max_iter, double tol, void* stream) {
  const Args<T> a{diag_p, pdiag_p, (const T*)upper, (const T*)r0, (T*)dx,
                  (T*)work, (int*)iters, B, N, bs, dcode, pcode, ss,
                  relative, max_iter, (T)tol};
  (void)stream;
  if ((long long)N * bs * bs > INDEX_LIMIT) return -1;
  switch (variant(N, bs, sizeof(T))) {
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
    case 1:
#ifdef __CUDACC__
      return launch<T, ShRows<T, false>>(pcg_shared<T>, a, stream);
#else
      return run_host<T, ShRows<T, false>>(a);
#endif
    default:
      if (work == nullptr && B > 0) return -1;
#ifdef __CUDACC__
      return launch<T, ShRows<T, true>>(pcg_global<T>, a, stream);
#else
      return run_host<T, ShRows<T, true>>(a);
#endif
  }
}
#undef TMR_PCG_REGS

}  // namespace tmr_pcg

#define TMR_PCG_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* diag_p, const void* upper,                  \
                      const void* pdiag_p, const void* r0, void* dx,          \
                      void* iters, void* work, int B, int N, int bs,          \
                      int dcode, int pcode, int ss, int relative,             \
                      int max_iter, double tol, void* stream) {               \
    return tmr_pcg::launch_pcg<T>(diag_p, upper, pdiag_p, r0, dx, iters,      \
                                  work, B, N, bs, dcode, pcode, ss, relative, \
                                  max_iter, tol, stream);                     \
  }
TMR_PCG_ENTRY(tmr_pcg_f32, float)
TMR_PCG_ENTRY(tmr_pcg_f64, double)
#undef TMR_PCG_ENTRY

// the variant that takes (N, bs) in values of `item` bytes: 0 registers,
// 1 shared operator, 2 global operator (ops/fused_pcg.variant)
extern "C" int tmr_pcg_variant(int N, int bs, int item) {
  return tmr_pcg::variant(N, bs, item);
}

// shared memory of one block, in values (ops/fused_pcg.smem_bytes)
extern "C" long long tmr_pcg_smem_elems(int N, int bs, int item) {
  return (long long)tmr_pcg::smem_elems(N, bs, item);
}

// the workspace of one scenario, in values (the global operator's vectors)
extern "C" long long tmr_pcg_work_elems(int N, int bs, int item) {
  return (long long)tmr_pcg::work_elems(N, bs, item);
}

// element i of a packed operand stored as `code`, widened to f64 (the
// storage decoders, held to PyTorch's casts by the tests)
extern "C" double tmr_pcg_stored(const void* p, long long i, int code) {
  return tmr_pcg::stored<double>(p, (size_t)i, code);
}
