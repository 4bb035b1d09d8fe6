// K4 — batched block-tridiagonal PCG on the Schur system S dx = r0, from
// dx = 0, one thread block per scenario.
//
// Replaces the TPU kernel trajoptmpcreference_tpu/ops/pallas_pcg.py:123
// `_pcg_kernel` (launched by `_pallas_pcg_lanes`, :209).  Plain version:
// ops/fused_pcg.py `pcg_fused_plain`.
//
// Operands, batch-major: diag_p and pdiag_p (B, N, T) hold the symmetric
// diagonal blocks of S and of the block-Jacobi inverse as packed lower
// triangles (T = bs(bs+1)/2, row i at i(i+1)/2); upper (B, N, bs, bs) holds
// S[k, k+1], zero at k = N-1; r0 (B, N, bs).  Out: dx (B, N, bs) and each
// scenario's own iteration count (the TPU kernel reported its 128-lane
// tile's count for every lane).
//
// What bounds it on the H100: not bytes and not flops.  A scenario's system
// is ~94 KB in f32 at N = 64, bs = 12 and is read from device memory once;
// each iteration then does ~80 multiply-adds per row but needs two block
// reductions and a handful of barriers, so the solve is bound by barrier
// and reduction latency inside the block.  The design keeps everything
// (packed diagonal, packed preconditioner, upper blocks, x, r, p, Ap, s and
// one temporary) in dynamic shared memory for the whole solve, so device
// memory is touched only to load and to store, and a block leaves the loop
// on its own convergence (the per-lane freeze of the TPU kernel).  Two
// blocks fit on an SM in f32 (one in f64).  The SS off-diagonal blocks are
// applied algebraically: Pinv r = s - Dinv (U s_{k+1} + U^T s_{k-1}) with
// s = Dinv r.
//
// The same source compiles as plain C++ (no __CUDACC__): the block's
// threads become one serial loop over rows, reductions are plain sums, and
// a host loop runs the scenarios one by one, so g++ can check the
// arithmetic on the CPU (tests/test_torch_kernel_sources.py).
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TMR_HD __host__ __device__ __forceinline__
#else
#include <stddef.h>
#include <vector>
#define TMR_HD inline
#endif

#ifdef __CUDA_ARCH__
#define TMR_SYNC() __syncthreads()
#else
#define TMR_SYNC() ((void)0)
#endif

namespace tmr_pcg {

constexpr int THREADS = 256;  // threads per block; each loops over rows

template <typename T>
TMR_HD T tabs(T v) { return v < T(0) ? -v : v; }

// position of (i, j) of a symmetric block in its packed lower triangle
TMR_HD int sym(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// (D v)_i for one packed symmetric block D
template <typename T>
TMR_HD T sym_row(const T* D, const T* v, int i, int bs) {
  T acc = T(0);
  for (int j = 0; j < bs; ++j) acc += D[sym(i, j)] * v[j];
  return acc;
}

// (U v)_i and (U^T v)_i for one row-major bs x bs block U
template <typename T>
TMR_HD T up_row(const T* U, const T* v, int i, int bs) {
  T acc = T(0);
  for (int j = 0; j < bs; ++j) acc += U[i * bs + j] * v[j];
  return acc;
}

template <typename T>
TMR_HD T upT_row(const T* U, const T* v, int i, int bs) {
  T acc = T(0);
  for (int j = 0; j < bs; ++j) acc += U[j * bs + i] * v[j];
  return acc;
}

// one scenario's system and Krylov vectors, carved from one buffer
template <typename T>
struct Sys {
  T *D, *P, *U, *x, *r, *p, *Ap, *s, *t, *red;
  int N, bs, tri, n;
};

TMR_HD size_t smem_elems(int N, int bs) {
  const size_t tri = (size_t)bs * (bs + 1) / 2;
  return 2 * N * tri + (size_t)N * bs * bs + 6 * (size_t)N * bs + 33;
}

template <typename T>
TMR_HD Sys<T> carve(T* m, int N, int bs) {
  Sys<T> S;
  S.N = N;
  S.bs = bs;
  S.tri = bs * (bs + 1) / 2;
  S.n = N * bs;
  S.D = m;
  S.P = S.D + (size_t)N * S.tri;
  S.U = S.P + (size_t)N * S.tri;
  S.x = S.U + (size_t)N * bs * bs;
  S.r = S.x + S.n;
  S.p = S.r + S.n;
  S.Ap = S.p + S.n;
  S.s = S.Ap + S.n;
  S.t = S.s + S.n;
  S.red = S.t + S.n;  // 33 values: one per warp and the result
  return S;
}

// row (k, i) of U_k v_{k+1} + U_{k-1}^T v_{k-1} (U_{N-1} is the zero pad)
template <typename T>
TMR_HD T off_row(const Sys<T>& S, const T* v, int k, int i) {
  const int bs = S.bs, bb = bs * bs;
  T acc = T(0);
  if (k + 1 < S.N) acc += up_row(S.U + k * bb, v + (k + 1) * bs, i, bs);
  if (k > 0) acc += upT_row(S.U + (k - 1) * bb, v + (k - 1) * bs, i, bs);
  return acc;
}

// the sum of v over the block's threads, returned to every thread
template <typename T>
TMR_HD T team_sum(T v, T* red) {
#ifdef __CUDA_ARCH__
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();  // red is free for the next reduction
#else
  (void)red;
#endif
  return v;
}

template <typename T>
TMR_HD T dot(const Sys<T>& S, const T* a, const T* b, int row0, int stride) {
  T acc = T(0);
  for (int row = row0; row < S.n; row += stride) acc += a[row] * b[row];
  return team_sum(acc, S.red);
}

// y = S v: packed diagonal block, then U_k v_{k+1}, then U_{k-1}^T v_{k-1}
template <typename T>
TMR_HD void matvec(const Sys<T>& S, const T* v, T* y, int row0, int stride) {
  const int bs = S.bs, bb = bs * bs;
  for (int row = row0; row < S.n; row += stride) {
    const int k = row / bs, i = row - k * bs;
    T acc = sym_row(S.D + k * S.tri, v + k * bs, i, bs);
    if (k + 1 < S.N) acc += up_row(S.U + k * bb, v + (k + 1) * bs, i, bs);
    if (k > 0) acc += upT_row(S.U + (k - 1) * bb, v + (k - 1) * bs, i, bs);
    y[row] = acc;
  }
}

// s = Pinv r: block-Jacobi, plus for SS the algebraic off-diagonal term
template <typename T>
TMR_HD void apply_P(const Sys<T>& S, bool ss, int row0, int stride) {
  const int bs = S.bs;
  for (int row = row0; row < S.n; row += stride) {
    const int k = row / bs;
    S.s[row] = sym_row(S.P + k * S.tri, S.r + k * bs, row - k * bs, bs);
  }
  if (!ss) return;
  TMR_SYNC();
  for (int row = row0; row < S.n; row += stride) {
    const int k = row / bs;
    S.t[row] = off_row(S, S.s, k, row - k * bs);
  }
  TMR_SYNC();
  for (int row = row0; row < S.n; row += stride) {
    const int k = row / bs;
    S.s[row] -= sym_row(S.P + k * S.tri, S.t + k * bs, row - k * bs, bs);
  }
}

// The PCG loop of one scenario on its loaded system (r = r0, x = 0);
// every thread of the block calls it with its own (row0, stride).  Returns
// the number of iterations taken.
template <typename T>
TMR_HD int pcg_solve(const Sys<T>& S, bool ss, bool relative, int max_iter,
                     T tol, int row0, int stride) {
  apply_P(S, ss, row0, stride);
  T nu = dot(S, S.r, S.s, row0, stride);
  T thr = tol;
  if (relative) {
    thr = tol * tabs(nu);
    if (thr < T(1e-30)) thr = T(1e-30);
  }
  if (tabs(nu) <= thr) return 0;  // converged warm start: no pAp = 0 divide
  for (int row = row0; row < S.n; row += stride) S.p[row] = S.s[row];
  int it = 0;
  while (it < max_iter) {
    TMR_SYNC();
    matvec(S, S.p, S.Ap, row0, stride);
    const T pAp = dot(S, S.p, S.Ap, row0, stride);
    const T alpha = nu / (pAp != T(0) ? pAp : T(1));
    for (int row = row0; row < S.n; row += stride) {
      S.x[row] += alpha * S.p[row];
      S.r[row] -= alpha * S.Ap[row];
    }
    TMR_SYNC();
    apply_P(S, ss, row0, stride);
    const T nu_new = dot(S, S.r, S.s, row0, stride);
    ++it;
    if (tabs(nu_new) <= thr) break;  // S is negative definite on the
    const T beta = nu_new / nu;      // flagship: nu and pAp keep any sign
    for (int row = row0; row < S.n; row += stride)
      S.p[row] = S.s[row] + beta * S.p[row];
    nu = nu_new;
  }
  return it;
}

#ifdef __CUDACC__
template <typename T>
__global__ void __launch_bounds__(THREADS)
pcg_kernel(const T* __restrict__ diag_p, const T* __restrict__ upper,
           const T* __restrict__ pdiag_p, const T* __restrict__ r0,
           T* __restrict__ dx, int* __restrict__ iters, int N, int bs, int ss,
           int relative, int max_iter, T tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Sys<T> S = carve(reinterpret_cast<T*>(smem_raw), N, bs);
  const size_t b = blockIdx.x, nD = (size_t)N * S.tri, nU = (size_t)N * bs * bs;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (size_t i = tid; i < nD; i += nt) {
    S.D[i] = diag_p[b * nD + i];
    S.P[i] = pdiag_p[b * nD + i];
  }
  for (size_t i = tid; i < nU; i += nt) S.U[i] = upper[b * nU + i];
  for (int i = tid; i < S.n; i += nt) {
    S.r[i] = r0[b * S.n + i];
    S.x[i] = T(0);
  }
  __syncthreads();
  const int it = pcg_solve(S, ss != 0, relative != 0, max_iter, tol, tid, nt);
  for (int i = tid; i < S.n; i += nt) dx[b * S.n + i] = S.x[i];
  if (tid == 0) iters[b] = it;
}

template <typename T>
int launch_pcg(const void* diag_p, const void* upper, const void* pdiag_p,
               const void* r0, void* dx, void* iters, int B, int N, int bs,
               int ss, int relative, int max_iter, double tol, void* stream) {
  const size_t bytes = smem_elems(N, bs) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)pcg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  pcg_kernel<T><<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      (const T*)diag_p, (const T*)upper, (const T*)pdiag_p, (const T*)r0,
      (T*)dx, (int*)iters, N, bs, ss, relative, max_iter, (T)tol);
  return (int)cudaGetLastError();
}
#else
template <typename T>
int launch_pcg(const void* diag_p, const void* upper, const void* pdiag_p,
               const void* r0, void* dx, void* iters, int B, int N, int bs,
               int ss, int relative, int max_iter, double tol, void*) {
  std::vector<T> buf(smem_elems(N, bs));
  const Sys<T> S = carve(buf.data(), N, bs);
  const size_t nD = (size_t)N * S.tri, nU = (size_t)N * bs * bs;
  for (size_t b = 0; b < (size_t)B; ++b) {
    for (size_t i = 0; i < nD; ++i) {
      S.D[i] = ((const T*)diag_p)[b * nD + i];
      S.P[i] = ((const T*)pdiag_p)[b * nD + i];
    }
    for (size_t i = 0; i < nU; ++i) S.U[i] = ((const T*)upper)[b * nU + i];
    for (int i = 0; i < S.n; ++i) {
      S.r[i] = ((const T*)r0)[b * S.n + i];
      S.x[i] = T(0);
    }
    const int it = pcg_solve(S, ss != 0, relative != 0, max_iter, (T)tol, 0, 1);
    for (int i = 0; i < S.n; ++i) ((T*)dx)[b * S.n + i] = S.x[i];
    ((int*)iters)[b] = it;
  }
  return 0;
}
#endif

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

// elements of shared memory one scenario needs (ops/fused_pcg.smem_bytes)
extern "C" long long tmr_pcg_smem_elems(int N, int bs) {
  return (long long)tmr_pcg::smem_elems(N, bs);
}
