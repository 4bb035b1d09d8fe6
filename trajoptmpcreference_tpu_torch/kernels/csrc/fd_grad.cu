// K1 — forward-dynamics gradient over lanes:
//   dqdd/d[q, qd, u] = [-Minv dtau/dq, -Minv dtau/dqd, Minv]   (n, 3n, L)
//
// Replaces the TPU kernel trajoptmpcreference_tpu/ops/lanes.py
// `_pallas_fd_grad` (body `fd_grad_lanes`).  Plain version: ops/lanes.py
// `fd_grad_lanes`.
//
// Layout: (n, L) in, (n, 3n, L) out, with the lane (scenario x knot) index
// minor.
//
// What bounds it on the H100: operations, not bytes.  A lane reads 3n
// values and writes 3n^2 (504 bytes at n = 6 in f32), but needs ~24,000
// operations (kernels/needed_ops.cpp): K2's recursion for qdd and Minv, a
// second RNEA with qdd, and the dRNEA, whose 2n derivative columns are most
// of it.  Kept in one thread per lane (the first design), the dRNEA's
// (6, n) arrays per link, Minv's F and IA and dense 6x6 transforms were
// ~2,100 live values: 168 registers and a 6,848-byte local-memory stack
// frame in f32 at n = 6, every link's step waiting on it.
//
// The design: K2's thread group (fd_group.cuh), then the gradient on the
// same group.
// * G = 8 threads per lane, LANES = 16 lanes per block; the robot buffer is
//   copied into shared memory once per block; q, qd and u are read along
//   lanes, the ragged tail masked.  fd_group runs the (E, r) transforms,
//   the bias RNEA, the Minv recursion (each F column in its thread's
//   registers) and qdd, on this kernel's own layout of the lane's state,
//   in which v and a keep their own storage;
// * the RNEA at qdd, row-parallel, reuses the bias pass: a'_i = a_i +
//   dlt_i with dlt_i = X_i dlt_p + S_i qdd_i, and f'_i (accumulated) = f_i
//   + the backward sum of I_i dlt_i; the link terms every derivative column
//   reads (I v, crm(v) S, crm(X a'_p) S, X^T crf(S) f') are computed once
//   per link, in parallel;
// * the dRNEA is column-parallel with no barrier inside: job k < 2n (by q
//   for even k, by qd for odd, column k / 2) runs on thread k mod G and
//   keeps its column's dv, da and df of every link in registers: the loops
//   over links are unrolled, so those registers are indexed by constants,
//   and a parent (data) is matched, never indexed by.  A link outside the
//   column's subtree is skipped forward, and a link that is neither in the
//   subtree nor an ancestor is skipped backward (the tree makes those
//   derivatives zero).  As the backward pass reaches link i, the job adds
//   -Minv[:, i] D_i to its output column (Minv read from its upper
//   triangle in shared memory) in the lane's output staging (IA's
//   storage, dead by then); the group copies Minv beside it;
// * the block stores the staging along lanes into (n, 3n, L).
// Occupancy decides the time: in f32 the launch asks for four blocks per
// SM, which caps a thread at 128 registers (PERF.md has the tries: df in
// shared memory instead, other caps).
// A block needs smem_elems(n) values of dynamic shared memory (42,512
// bytes in f32 at n = 6, 85,024 in f64); the launch opts in with
// cudaFuncSetAttribute, and ops/lanes.py reads the same size through
// tmr_fd_grad_smem_elems and refuses a size over the limit.
#include "fd_group.cuh"

namespace tmr {
namespace fd_grad {

using namespace group;

// values one lane keeps in shared memory, padded to 8 mod 32
TMR_HHD size_t lane_elems(int n) {
  const size_t e = 87 * (size_t)n + (size_t)n * n + 42;
  return e + (40 - e % 32) % 32;
}

// dynamic shared memory of one block, in values of the kernel's type
TMR_HHD size_t smem_elems(int n) {
  return robot_elems(n) + LANES * lane_elems(n);
}

// one lane's state: what fd_group reads and writes, then the gradient's
template <typename T>
struct GradLane {
  Lane<T> k;
  T *dlt;   // (n, 6) qdd's part of a'_i: X_i dlt_p + S_i qdd_i (U's storage)
  T *gacc;  // (n, 6) I_i dlt_i, accumulated backward
  T *Iv;    // (n, 6) I_i v_i
  T *cS;    // (n, 6) crm(v_i) S_i
  T *sa;    // (n, 6) crm(X_i a'_p) S_i, X_0 g at the root
  T *tf;    // (n, 6) X_i^T crf(S_i) f'_i, accumulated f' (W's storage)
  T *out;   // (n, 3n) the lane's output (IA's storage)
};

template <typename T>
TMR_HD GradLane<T> carve(T* m, int n) {
  GradLane<T> g;
  Lane<T>& s = g.k;
  s.q = m;
  s.qd = s.q + n;
  s.u = s.qd + n;
  s.c = s.u + n;
  s.Dinv = s.c + n;
  s.qdd = s.Dinv + n;
  s.E = s.qdd + n;
  s.r = s.E + 9 * n;
  s.f = s.r + 3 * n;
  s.U = s.f + 6 * n;
  s.IA = s.U + 6 * n;
  s.M = s.IA + 21 * n;
  s.W = s.M + n * n;
  s.Iv = s.W + 36;
  s.v = s.Iv + 6;
  s.a = s.v + 6 * n;
  g.gacc = s.a + 6 * n;
  g.Iv = g.gacc + 6 * n;
  g.cS = g.Iv + 6 * n;
  g.sa = g.cS + 6 * n;
  g.dlt = s.U;
  g.tf = s.W;    // W and Iv: 42 >= 6 n
  g.out = s.IA;  // 3 n^2 <= 21 n for every n <= 7
  return g;
}

// ---- the RNEA at qdd ------------------------------------------------------
// link i, row j: dlt_i = X_i dlt_p + S_i qdd_i; a_i += dlt_i gives a'_i
template <typename T, int N>
TMR_HD void ph_acc(const GradLane<T>& g, const SRobot<T>& R, int tid, int i) {
  if (tid < 6) {
    const Lane<T>& s = g.k;
    const int j = tid, p = R.parent(i);
    T d = R.S(i)[j] * s.qdd[i];
    if (p >= 0) d += xmot_row(s.E + i * 9, s.r + i * 3, g.dlt + p * 6, j);
    g.dlt[i * 6 + j] = d;
    s.a[i * 6 + j] += d;
  }
}

// every link at once: rows of I v and of I dlt (one row per job); crm(v) S
// and crm(X a'_p) S (one vector per job)
template <typename T, int N>
TMR_HD void ph_links(const GradLane<T>& g, const SRobot<T>& R, int tid) {
  const Lane<T>& s = g.k;
  for (int j = tid; j < 14 * N; j += G) {
    if (j < 12 * N) {
      const int i = (j % (6 * N)) / 6, m = j % 6;
      const T* x = j < 6 * N ? s.v : g.dlt;
      T* o = j < 6 * N ? g.Iv : g.gacc;
      o[i * 6 + m] = m6_row(R.I6(i), x + i * 6, m);
    } else if (j % 2 == 0) {
      const int i = (j - 12 * N) / 2;
#pragma unroll
      for (int m = 0; m < 6; ++m) g.cS[i * 6 + m] = crm_row(s.v + i * 6, R.S(i), m);
    } else {
      const int i = (j - 12 * N) / 2, p = R.parent(i);
      T ap[6], xa[6];
#pragma unroll
      for (int m = 0; m < 6; ++m)
        ap[m] = p >= 0 ? s.a[p * 6 + m] : m == 5 ? -R.c[0] : T(0);
      xmot(s.E + i * 9, s.r + i * 3, ap, xa);
#pragma unroll
      for (int m = 0; m < 6; ++m) g.sa[i * 6 + m] = crm_row(xa, R.S(i), m);
    }
  }
}

// backward, link i (it has a parent): gacc_p += X_i^T gacc_i
template <typename T, int N>
TMR_HD void ph_gacc(const GradLane<T>& g, const SRobot<T>& R, int tid, int i) {
  if (tid == 0) {
    T f[6], o[6];
#pragma unroll
    for (int m = 0; m < 6; ++m) f[m] = g.gacc[i * 6 + m];
    xfrc(g.k.E + i * 9, g.k.r + i * 3, f, o);
    const int p = R.parent(i);
#pragma unroll
    for (int m = 0; m < 6; ++m) g.gacc[p * 6 + m] += o[m];
  }
}

// tf_i = X_i^T crf(S_i) f'_i with f'_i = f_i + gacc_i (one link per job)
template <typename T, int N>
TMR_HD void ph_tf(const GradLane<T>& g, const SRobot<T>& R, int tid) {
  if (tid < N && R.parent(tid) >= 0) {
    const int i = tid;
    T fs[6], x[6], o[6];
#pragma unroll
    for (int m = 0; m < 6; ++m) fs[m] = g.k.f[i * 6 + m] + g.gacc[i * 6 + m];
#pragma unroll
    for (int m = 0; m < 6; ++m) x[m] = crf_row(R.S(i), fs, m);
    xfrc(g.k.E + i * 9, g.k.r + i * 3, x, o);
#pragma unroll
    for (int m = 0; m < 6; ++m) g.tf[i * 6 + m] = o[m];
  }
}

// ---- the dRNEA, one derivative column per job -----------------------------
// Job k: column c = k / 2, by q (w = 0) or by qd (w = 1).  Forward over the
// links of c's subtree: dv_i = X_i dv_p, da_i = X_i da_p, the column's own
// link seeded (by q: dv = crm(X v_p) S = crm(v) S, da = crm(X a'_p) S; by
// qd: dv = S, da = crm(v) S), then da -= qd_i crm(S) dv and df = I da +
// crf(dv) I v + crf(v) I dv.  Backward over the subtree and c's ancestors:
// D_i = S . df_i (damping added on the qd diagonal), the output column
// w n + c -= Minv[:, i] D_i, df_p += X_i^T df_i (+ tf_c in column c by q).
// The group copies Minv into columns 2n.. .
template <typename T, int N>
TMR_HD void ph_cols(const GradLane<T>& g, const SRobot<T>& R, int tid) {
  const Lane<T>& s = g.k;
#pragma unroll 1
  for (int k = tid; k < 2 * N; k += G) {
    const int w = k & 1, c = k >> 1;
    unsigned sub = 0;  // c's subtree (bits)
    T dv[N][6], da[N][6], df[N][6];
    T* out = g.out + w * N + c;
#pragma unroll
    for (int row = 0; row < N; ++row) out[row * 3 * N] = T(0);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int m = 0; m < 6; ++m) dv[i][m] = da[i][m] = df[i][m] = T(0);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int p = R.parent(i);
      if (i == c || (p >= 0 && ((sub >> p) & 1u))) sub |= 1u << i;
      if (!((sub >> i) & 1u)) continue;
      const T *E = s.E + i * 9, *r = s.r + i * 3, *S = R.S(i);
      if (i == c) {
        const T* sv = w ? S : g.cS + i * 6;
        const T* sa = w ? g.cS + i * 6 : g.sa + i * 6;
#pragma unroll
        for (int m = 0; m < 6; ++m) {
          dv[i][m] = sv[m];
          da[i][m] = sa[m];
        }
      } else {
        T vp[6], ap[6];  // the parent's, p < i: link 0's unless matched
#pragma unroll
        for (int m = 0; m < 6; ++m) {
          vp[m] = dv[0][m];
          ap[m] = da[0][m];
        }
#pragma unroll
        for (int kk = 1; kk < i; ++kk) {
          if (kk != p) continue;
#pragma unroll
          for (int m = 0; m < 6; ++m) {
            vp[m] = dv[kk][m];
            ap[m] = da[kk][m];
          }
        }
        xmot(E, r, vp, dv[i]);
        xmot(E, r, ap, da[i]);
      }
      const T qd = s.qd[i];
      T idv[6];
#pragma unroll
      for (int m = 0; m < 6; ++m) da[i][m] -= qd * crm_row(S, dv[i], m);
      const T *I6 = R.I6(i), *Iv = g.Iv + i * 6, *v = s.v + i * 6;
#pragma unroll
      for (int m = 0; m < 6; ++m) idv[m] = m6_row(I6, dv[i], m);
#pragma unroll
      for (int m = 0; m < 6; ++m)
        df[i][m] = m6_row(I6, da[i], m) + crf_row(dv[i], Iv, m) +
                   crf_row(v, idv, m);
    }
    unsigned rel = sub;  // and c's ancestors
    for (int j = c; j >= 0; j = R.parent(j)) rel |= 1u << j;
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      if (!((rel >> i) & 1u)) continue;
      T d = dot6(R.S(i), df[i]);
      if (w && i == c) d += R.joint(i)[O_DAMP];
#pragma unroll
      for (int row = 0; row < N; ++row)
        out[row * 3 * N] -= s.M[i >= row ? row * N + i : i * N + row] * d;
      const int p = R.parent(i);
      if (p < 0) continue;
      T o[6];
      xfrc(s.E + i * 9, s.r + i * 3, df[i], o);
      if (!w && i == c)
#pragma unroll
        for (int m = 0; m < 6; ++m) o[m] += g.tf[i * 6 + m];
#pragma unroll
      for (int kk = 0; kk < i; ++kk) {
        if (kk != p) continue;
#pragma unroll
        for (int m = 0; m < 6; ++m) df[kk][m] += o[m];
      }
    }
  }
  for (int e = tid; e < N * N; e += G) {
    const int row = e / N, j = e % N;
    g.out[row * 3 * N + 2 * N + j] = s.M[j >= row ? row * N + j : j * N + row];
  }
}

// one lane's whole function; every thread of its group calls it
template <typename T, int N>
TMR_HD void fd_grad_group(const GradLane<T>& g, const SRobot<T>& R, int tid,
                          unsigned mask) {
  (void)tid;
  (void)mask;
  fd_group<T, N>(g.k, R, tid, mask);
#pragma unroll
  for (int i = 0; i < N; ++i) TMR_GROUP_PHASE((ph_acc<T, N>(g, R, tid, i)));
  TMR_GROUP_PHASE((ph_links<T, N>(g, R, tid)));
#pragma unroll
  for (int i = N - 1; i >= 0; --i)
    if (R.parent(i) >= 0) TMR_GROUP_PHASE((ph_gacc<T, N>(g, R, tid, i)));
  TMR_GROUP_PHASE((ph_tf<T, N>(g, R, tid)));
  TMR_GROUP_PHASE((ph_cols<T, N>(g, R, tid)));
}

// the block's robot buffer and its lanes' q, qd, u (zero past L), read
// along lanes by threads t = t0, t0 + nt, ...
template <typename T, int N>
TMR_HHD void block_load(T* sm, const T* consts, const T* Q, const T* QD,
                        const T* U, int L, int lane0, int t0, int nt) {
  for (int k = t0; k < (int)robot_elems(N); k += nt) sm[k] = consts[k];
  T* lanes = sm + robot_elems(N);
  for (int k = t0; k < 3 * N * LANES; k += nt) {
    const int arr = k / (N * LANES), j = (k / LANES) % N, l = k % LANES;
    const int lane = lane0 + l;
    const T* src = arr == 0 ? Q : arr == 1 ? QD : U;
    lanes[l * lane_elems(N) + arr * N + j] =
        lane < L ? src[(size_t)j * L + lane] : T(0);
  }
}

// the lanes' (n, 3n) outputs, stored along lanes
template <typename T, int N>
TMR_HHD void block_store(T* sm, T* out, int L, int lane0, int t0, int nt) {
  T* lanes = sm + robot_elems(N);
  for (int k = t0; k < 3 * N * N * LANES; k += nt) {
    const int e = k / LANES, l = k % LANES, lane = lane0 + l;
    if (lane < L) out[(size_t)e * L + lane] = carve(lanes + l * lane_elems(N), N).out[e];
  }
}

#ifdef __CUDACC__
// the blocks per SM that the launch asks registers for: four in f32 (128
// registers a thread, with df of every link in them; PERF.md has the
// tries); f64 keeps the registers it needs, a cap there spills heavily
template <typename T>
struct MinBlocks {
  static constexpr int value = 1;
};
template <>
struct MinBlocks<float> {
  static constexpr int value = 4;
};

template <typename T, int N>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value)
fd_grad_kernel(const T* __restrict__ q, const T* __restrict__ qd,
               const T* __restrict__ u, const T* __restrict__ consts,
               T* __restrict__ out, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int lane0 = blockIdx.x * LANES;
  block_load<T, N>(sm, consts, q, qd, u, L, lane0, threadIdx.x, THREADS);
  __syncthreads();
  const int g = threadIdx.x / G, tid = threadIdx.x % G;
  if (lane0 + g < L) {
    const unsigned mask = 0xFFu << ((threadIdx.x & 31) & ~(G - 1));
    fd_grad_group<T, N>(carve(sm + robot_elems(N) + g * lane_elems(N), N),
                        SRobot<T>{sm}, tid, mask);
  }
  __syncthreads();
  block_store<T, N>(sm, out, L, lane0, threadIdx.x, THREADS);
}

template <typename T>
int launch_fd_grad(const void* q, const void* qd, const void* u,
                   const void* c, void* out, int n, int L, void* stream) {
  if (n < 1 || n > 7) return -1;
  const size_t bytes = smem_elems(n) * sizeof(T);
  const dim3 grid((L + LANES - 1) / LANES), block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define TMR_CALL(NN)                                                       \
  err = cudaFuncSetAttribute((const void*)fd_grad_kernel<T, NN>,           \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                             (int)bytes);                                  \
  if (err != cudaSuccess) return (int)err;                                 \
  fd_grad_kernel<T, NN><<<grid, block, bytes, s>>>(                        \
      (const T*)q, (const T*)qd, (const T*)u, (const T*)c, (T*)out, L)
  TMR_SWITCH_N(n, TMR_CALL)
#undef TMR_CALL
  return (int)cudaGetLastError();
}
#else
// the host loop: block after block, the block's lanes one after another,
// each lane's phases for tid = 0..G-1 in turn
template <typename T>
int launch_fd_grad(const void* q, const void* qd, const void* u,
                   const void* c, void* out, int n, int L, void*) {
  if (n < 1 || n > 7) return -1;
  std::vector<T> buf(smem_elems(n));
  T* sm = buf.data();
#define TMR_CALL(NN)                                                          \
  for (int lane0 = 0; lane0 < L; lane0 += LANES) {                            \
    block_load<T, NN>(sm, (const T*)c, (const T*)q, (const T*)qd,             \
                      (const T*)u, L, lane0, 0, 1);                           \
    for (int g = 0; g < LANES && lane0 + g < L; ++g)                          \
      fd_grad_group<T, NN>(                                                   \
          carve(sm + robot_elems(NN) + g * lane_elems(NN), NN), SRobot<T>{sm}, \
          0, 0u);                                                             \
    block_store<T, NN>(sm, (T*)out, L, lane0, 0, 1);                          \
  }
  TMR_SWITCH_N(n, TMR_CALL)
#undef TMR_CALL
  return 0;
}
#endif

}  // namespace fd_grad
}  // namespace tmr

extern "C" int tmr_fd_grad_f32(const void* q, const void* qd, const void* u,
                               const void* consts, void* out, int n, int L,
                               void* stream) {
  return tmr::fd_grad::launch_fd_grad<float>(q, qd, u, consts, out, n, L, stream);
}

extern "C" int tmr_fd_grad_f64(const void* q, const void* qd, const void* u,
                               const void* consts, void* out, int n, int L,
                               void* stream) {
  return tmr::fd_grad::launch_fd_grad<double>(q, qd, u, consts, out, n, L, stream);
}

// values of dynamic shared memory one block needs (ops/lanes.smem_bytes)
extern "C" long long tmr_fd_grad_smem_elems(int n) {
  return (long long)tmr::fd_grad::smem_elems(n);
}
