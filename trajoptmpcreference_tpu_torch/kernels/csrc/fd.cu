// K2 — forward dynamics over lanes: qdd = Minv(q) (u - c(q, qd)).
//
// Replaces the TPU kernel trajoptmpcreference_tpu/ops/lanes.py
// `_pallas_fd` (body `fd_lanes`).  Plain version: ops/lanes.py `fd_lanes`.
//
// Layout: (n, L) in and out with the lane (scenario x knot) index minor.
//
// What bounds it on the H100: operations, not bytes.  A lane reads 3n values
// and writes n, but its bias RNEA and analytic Minv take ~10^4 operations at
// n = 6 in a chain of dependent steps (one per link, forward, backward,
// forward), and the Minv recursion keeps ~600 values per lane alive.  Kept
// per thread, those values spill to a local-memory stack frame (the first
// design: 3,088 bytes at n = 6 in f32), and each link's step waits on it.
//
// The design (GRiD's layout):
// * a group of G = 8 threads per lane, LANES = 16 lanes per block (four
//   lanes per warp).  Each link's step is split over the group: the rows
//   of the 6-vectors, the columns of F / Minv, the columns and rows of the
//   articulated-inertia update.  A group synchronises only itself
//   (__syncwarp with its own 8-bit mask), never the block, inside the
//   recursion;
// * column thread c < n keeps column c of every F_i and of Minv in its
//   registers (struct Col): the Minv passes touch F in no shared memory.
//   The loops over links are unrolled, so those registers are indexed by
//   constants; a parent (data) is matched, never indexed by;
// * the rest of the lane's state lives in shared memory: a joint transform
//   as (E, r), 12 values instead of a dense 6x6; IA as a packed symmetric
//   21; U, Dinv, the Minv rows, c and the RNEA v / a / f (v and a share
//   Minv's storage, which is written only after they are dead).  That is
//   lane_elems(n) values per lane, 392 at n = 6 (1,568 bytes in f32),
//   padded to 8 mod 32 words so that the four lanes of a warp start on four
//   different quarters of the 32 banks;
// * the packed robot buffer (HEADER + n * JOINT_STRIDE values) is copied
//   into shared memory once per block and read from there;
// * q, qd and u are read, and qdd written, by the whole block, coalesced
//   along lanes; the ragged tail (lane >= L) is masked.
// A block needs smem_elems(n) values of dynamic shared memory (28,176
// bytes in f32 at n = 6, 56,352 in f64); the launch opts in with
// cudaFuncSetAttribute, and ops/lanes.py reads the same size through
// tmr_fd_smem_elems and refuses a size over the limit.
// What holds it back now is the instruction count: each warp instruction
// serves four lanes, and a phase's jobs of different kinds run one after
// another (PERF.md).
//
// The recursion is a sequence of phases separated by group barriers
// (TMR_GROUP_PHASE).  Each phase is a function of (thread index in the
// group, shared state, the thread's own column) whose threads write
// disjoint locations and read nothing another thread writes in the same
// phase.  Compiled as plain C++ (no __CUDACC__) the same phases run for
// tid = 0..G-1 in turn, each with its own Col, so g++ checks the work
// partition as well as the arithmetic (tests/test_torch_kernel_sources.py,
// which also runs the threads in reverse order, TMR_FD_REVERSE_TIDS, to
// catch a phase that would race).
#include "lanes_common.cuh"

#ifdef __CUDACC__
#define TMR_HHD __host__ __device__ inline
#else
#include <stddef.h>
#include <vector>
#define TMR_HHD inline
#endif

namespace tmr {
namespace fd {

constexpr int G = 8;        // threads per lane
constexpr int LANES = 16;   // lanes per block
constexpr int THREADS = G * LANES;

// values one lane keeps in shared memory, padded to 8 mod 32
TMR_HHD size_t lane_elems(int n) {
  const size_t e = 51 * (size_t)n + (size_t)n * n + 42;
  return e + (40 - e % 32) % 32;
}

TMR_HHD size_t robot_elems(int n) { return HEADER + (size_t)n * JOINT_STRIDE; }

// dynamic shared memory of one block, in values of the kernel's type
TMR_HHD size_t smem_elems(int n) {
  return robot_elems(n) + LANES * lane_elems(n);
}

// one lane's state, carved from its slice of shared memory
template <typename T>
struct Lane {
  T *q, *qd, *u, *c, *Dinv, *qdd;  // n each
  T *E, *r;                        // (n, 9), (n, 3): X_j = (E, r)
  T *f;                            // (n, 6) RNEA forces, accumulated
  T *U;                            // (n, 6) IA S; X^T U after the backward pass
  T *IA;                           // (n, 21) packed symmetric
  T *M;                            // (n, n) Minv, row i over columns >= i
  T *W;                            // (6, 6) X^T Ia of the link in hand
  T *v, *a;                        // (n, 6) each, in M and W's storage
  T *Iv;                           // 6
};

template <typename T>
TMR_HD Lane<T> carve(T* m, int n) {
  Lane<T> s;
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
  s.v = s.M;          // n^2 + 36 >= 12 n for every n
  s.a = s.M + 6 * n;
  return s;
}

// What one column thread c < n keeps in registers: column c of F_i for
// every link i and column c of Minv (rows i <= c).  Only thread c reads or
// writes it, so the backward and forward passes of Minv touch F in no
// shared memory at all.
template <typename T, int N>
struct Col {
  T F[N][6];
  T M[N];
};

// ---- the robot buffer, read from shared memory ---------------------------
template <typename T>
struct SRobot {
  const T* c;
  TMR_HD const T* joint(int j) const { return c + HEADER + j * JOINT_STRIDE; }
  TMR_HD const T* S(int j) const { return joint(j) + O_S; }
  TMR_HD const T* I6(int j) const { return joint(j) + O_I6; }
  TMR_HD int parent(int j) const { return (int)joint(j)[O_PARENT]; }
  TMR_HD bool revolute(int j) const { return (int)joint(j)[O_JTYPE] == REVOLUTE; }
};

// position of (i, j) of a symmetric 6x6 in its packed lower triangle
TMR_HD int sym(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// ---- spatial algebra with X = (E, r) = [[E, 0], [-E rx, E]] --------------
// The row functions take the row k as data: the threads of a group ask
// for different rows at once, so they select with arithmetic, not with
// branches a warp would run one after another.

// row m (0-2) of a x b for 3-vectors at a and b
template <typename T>
TMR_HD T cross_row(const T* a, const T* b, int m) {
  const int m1 = m == 2 ? 0 : m + 1, m2 = m == 0 ? 2 : m - 1;
  return a[m1] * b[m2] - a[m2] * b[m1];
}

// row k of X v (a motion vector): E w, or E (l - r x w)
template <typename T>
TMR_HD T xmot_row(const T* E, const T* r, const T* v, int k) {
  const bool lin = k >= 3;
  const int m = lin ? k - 3 : k;
  T x[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T rw = cross_row(r, v, j);
    x[j] = lin ? v[3 + j] - rw : v[j];
  }
  return E[m * 3] * x[0] + E[m * 3 + 1] * x[1] + E[m * 3 + 2] * x[2];
}

// X v, whole vector, into registers
template <typename T>
TMR_HD void xmot(const T* E, const T* r, const T v[6], T o[6]) {
  const T l0 = v[3] - (r[1] * v[2] - r[2] * v[1]);
  const T l1 = v[4] - (r[2] * v[0] - r[0] * v[2]);
  const T l2 = v[5] - (r[0] * v[1] - r[1] * v[0]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = E[k * 3] * v[0] + E[k * 3 + 1] * v[1] + E[k * 3 + 2] * v[2];
    o[3 + k] = E[k * 3] * l0 + E[k * 3 + 1] * l1 + E[k * 3 + 2] * l2;
  }
}

// X^T f (a force vector), whole vector: [E^T n + r x E^T f_l; E^T f_l]
template <typename T>
TMR_HD void xfrc(const T* E, const T* r, const T f[6], T o[6]) {
  T e[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    e[m] = E[m] * f[3] + E[3 + m] * f[4] + E[6 + m] * f[5];
    o[m] = E[m] * f[0] + E[3 + m] * f[1] + E[6 + m] * f[2];
  }
  o[0] += r[1] * e[2] - r[2] * e[1];
  o[1] += r[2] * e[0] - r[0] * e[2];
  o[2] += r[0] * e[1] - r[1] * e[0];
  o[3] = e[0];
  o[4] = e[1];
  o[5] = e[2];
}

// row k of crm(a) b = [a_w x b_w; a_w x b_l + a_l x b_w] and of
// crf(a) b = [a_w x b_w + a_l x b_l; a_w x b_l] (lanes_common.cuh crm_v /
// crf_v), a = (a_w, a_l), b = (b_w, b_l)
template <typename T>
TMR_HD T crm_row(const T* a, const T* b, int k) {
  const bool lin = k >= 3;
  const int m = lin ? k - 3 : k;
  const T t = cross_row(a, b + (lin ? 3 : 0), m);
  const T u = cross_row(a + 3, b, m);
  return lin ? t + u : t;
}

template <typename T>
TMR_HD T crf_row(const T* a, const T* b, int k) {
  const bool lin = k >= 3;
  const int m = lin ? k - 3 : k;
  const T t = cross_row(a, b + (lin ? 3 : 0), m);
  const T u = cross_row(a + 3, b + 3, m);
  return lin ? t : t + u;
}

// row k of a dense row-major 6x6 times v
template <typename T>
TMR_HD T m6_row(const T* M, const T* v, int k) {
  T s = 0;
#pragma unroll
  for (int m = 0; m < 6; ++m) s += M[k * 6 + m] * v[m];
  return s;
}

template <typename T>
TMR_HD T dot6(const T* a, const T* b) {
  T s = 0;
#pragma unroll
  for (int m = 0; m < 6; ++m) s += a[m] * b[m];
  return s;
}

// ---- the phases; job j of a phase runs on thread j (every phase has at
// most G jobs, but for the IA initialisation, which strides by G) --------
static_assert(G >= 8, "a phase has up to 8 jobs, one per thread");
// joint transforms (one joint per job); IA = I6 packed; the column's F = 0
template <typename T, int N>
TMR_HD void ph_init(const Lane<T>& s, const SRobot<T>& R, int tid,
                    Col<T, N>& col) {
  if (tid < N) {
    const int jt = tid;
    const T* J = R.joint(jt);
    T* E = s.E + jt * 9;
    const T th = s.q[jt];
    if (R.revolute(jt)) {
      // E = (I - sin(th) A + (1 - cos(th)) A^2) E_fixed, r = t_fixed
      const T st = tsin(th), ct = T(1) - tcos(th);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        T e[3];
#pragma unroll
        for (int m = 0; m < 3; ++m)
          e[m] = T(k == m) - st * J[O_AX + k * 3 + m] + ct * J[O_A2 + k * 3 + m];
#pragma unroll
        for (int m = 0; m < 3; ++m)
          E[k * 3 + m] = e[0] * J[O_EF + m] + e[1] * J[O_EF + 3 + m] +
                         e[2] * J[O_EF + 6 + m];
        s.r[jt * 3 + k] = J[O_TF + k];
      }
    } else {
      // E = E_fixed, r = t_fixed + th E_fixed^T axis
#pragma unroll
      for (int k = 0; k < 9; ++k) E[k] = J[O_EF + k];
#pragma unroll
      for (int k = 0; k < 3; ++k) s.r[jt * 3 + k] = J[O_TF + k] + th * J[O_EFAX + k];
    }
  }
  for (int j = tid; j < 36 * N; j += G) {
    const int jt = j / 36, a = (j % 36) / 6, b = j % 6;
    if (b <= a) s.IA[jt * 21 + a * (a + 1) / 2 + b] = R.I6(jt)[a * 6 + b];
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int m = 0; m < 6; ++m) col.F[i][m] = T(0);
}

// row j of v_i = X_i v_p + S qd_i and of a_i = X_i a_p (X_i g at the root)
template <typename T>
TMR_HD void rnea_va_row(const Lane<T>& s, const SRobot<T>& R, int i, int j) {
  const int p = R.parent(i);
  const T *E = s.E + i * 9, *r = s.r + i * 3;
  if (p >= 0) {
    s.v[i * 6 + j] = xmot_row(E, r, s.v + p * 6, j) + R.S(i)[j] * s.qd[i];
    s.a[i * 6 + j] = xmot_row(E, r, s.a + p * 6, j);
  } else {
    const T g[6] = {0, 0, 0, 0, 0, -R.c[0]};
    s.v[i * 6 + j] = R.S(i)[j] * s.qd[i];
    s.a[i * 6 + j] = xmot_row(E, r, g, j);
  }
}

// RNEA forward, the root's v and a (one row per job)
template <typename T, int N>
TMR_HD void ph_rnea_va0(const Lane<T>& s, const SRobot<T>& R, int tid) {
  if (tid < 6) rnea_va_row(s, R, 0, tid);
}

// a_i += qd_i crm(v_i) S and Iv = I6 v_i (one row of each per job)
template <typename T, int N>
TMR_HD void ph_rnea_a(const Lane<T>& s, const SRobot<T>& R, int tid, int i) {
  if (tid < 6) {
    const int j = tid;
    s.a[i * 6 + j] += s.qd[i] * crm_row(s.v + i * 6, R.S(i), j);
    s.Iv[j] = m6_row(R.I6(i), s.v + i * 6, j);
  }
}

// f_i = I6 a_i + crf(v_i) Iv, and link i + 1's v and a (one row of each
// per job: f_i reads only link i, which the next link's rows do not write)
template <typename T, int N>
TMR_HD void ph_rnea_f(const Lane<T>& s, const SRobot<T>& R, int tid, int i) {
  if (tid < 6) {
    const int j = tid;
    s.f[i * 6 + j] = m6_row(R.I6(i), s.a + i * 6, j) + crf_row(s.v + i * 6, s.Iv, j);
    if (i + 1 < N) rnea_va_row(s, R, i + 1, j);
  }
}

// Minv: U_i = IA_i S (rows 0-5); RNEA backward: c_i = S.f_i (job 6) and
// f_p += X_i^T f_i (job 7)
template <typename T, int N>
TMR_HD void ph_bwd_u(const Lane<T>& s, const SRobot<T>& R, int tid, int i) {
  const int p = R.parent(i);
  const T *S = R.S(i), *fi = s.f + i * 6;
  if (tid < 6) {
    T u = 0;
#pragma unroll
    for (int m = 0; m < 6; ++m) u += s.IA[i * 21 + sym(tid, m)] * S[m];
    s.U[i * 6 + tid] = u;
  } else if (tid == 6) {
    s.c[i] = dot6(S, fi);
  } else if (tid == 7 && p >= 0) {
    T f[6], o[6];
#pragma unroll
    for (int m = 0; m < 6; ++m) f[m] = fi[m];
    xfrc(s.E + i * 9, s.r + i * 3, f, o);
#pragma unroll
    for (int m = 0; m < 6; ++m) s.f[p * 6 + m] += o[m];
  }
}

// Minv row i over columns c >= i, then F_i[:, c] += U_i M[i][c] and
// F_p[:, c] += X_i^T F_i[:, c]: column thread c, in its registers; W =
// X_i^T Ia with Ia = IA_i - U_i Dinv_i U_i^T, one column w per thread
// (w = tid - N mod G, so the threads without a column go first)
template <typename T, int N>
TMR_HD void ph_bwd_cols(const Lane<T>& s, const SRobot<T>& R, int tid, int i,
                        Col<T, N>& col) {
  const int p = R.parent(i);
  const T *S = R.S(i), *U = s.U + i * 6, *E = s.E + i * 9, *r = s.r + i * 3;
  const T dinv = T(1) / dot6(S, U);
  if (tid == 0) s.Dinv[i] = dinv;
  if (tid >= i && tid < N) {
    T sf = 0;
#pragma unroll
    for (int m = 0; m < 6; ++m) sf += S[m] * col.F[i][m];
    T mic = -dinv * sf;
    if (tid == i) mic += dinv;
    col.M[i] = mic;
    if (p >= 0) {
#pragma unroll
      for (int m = 0; m < 6; ++m) col.F[i][m] += U[m] * mic;
      T o[6];
      xfrc(E, r, col.F[i], o);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (k != p) continue;
#pragma unroll
        for (int m = 0; m < 6; ++m) col.F[k][m] += o[m];
      }
    }
  }
  if (p < 0) return;
  const int w = (tid + G - N % G) % G;
  if (w < 6) {
    const T dw = dinv * U[w];
    T ia[6], o[6];
#pragma unroll
    for (int m = 0; m < 6; ++m) ia[m] = s.IA[i * 21 + sym(m, w)] - U[m] * dw;
    xfrc(E, r, ia, o);
#pragma unroll
    for (int m = 0; m < 6; ++m) s.W[m * 6 + w] = o[m];
  }
}

// IA_p += W X_i (row j of W X_i = (X_i^T W[j, :])^T, lower triangle; jobs
// 0-5), and U_i <- X_i^T U_i for the forward pass (job 6)
template <typename T, int N>
TMR_HD void ph_bwd_ia(const Lane<T>& s, const SRobot<T>& R, int tid, int i) {
  const int p = R.parent(i);
  const T *E = s.E + i * 9, *r = s.r + i * 3;
  if (tid < 7) {
    const int j = tid;
    T in[6], o[6];
    const T* src = j < 6 ? s.W + j * 6 : s.U + i * 6;
#pragma unroll
    for (int m = 0; m < 6; ++m) in[m] = src[m];
    xfrc(E, r, in, o);
    if (j < 6) {
#pragma unroll
      for (int m = 0; m < 6; ++m)
        if (m <= j) s.IA[p * 21 + j * (j + 1) / 2 + m] += o[m];
    } else {
#pragma unroll
      for (int m = 0; m < 6; ++m) s.U[i * 6 + m] = o[m];
    }
  }
}

// forward pass of Minv, column thread c >= i: M[i][c] -= Dinv_i
// (X_i^T U_i) . F_p[:, c]; F_i[:, c] = S M[i][c] + X_i F_p[:, c]; row i of
// Minv goes to shared memory for the qdd contraction
template <typename T, int N>
TMR_HD void ph_fwd(const Lane<T>& s, const SRobot<T>& R, int tid, int i,
                   Col<T, N>& col) {
  if (tid < i || tid >= N) return;
  const int p = R.parent(i);
  const T* S = R.S(i);
  T mic = col.M[i];
  T t[6] = {0, 0, 0, 0, 0, 0};
  if (p >= 0) {
    T fp[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k != p) continue;
#pragma unroll
      for (int m = 0; m < 6; ++m) fp[m] = col.F[k][m];
    }
    T ux = 0;
#pragma unroll
    for (int m = 0; m < 6; ++m) ux += s.U[i * 6 + m] * fp[m];
    mic -= s.Dinv[i] * ux;
    xmot(s.E + i * 9, s.r + i * 3, fp, t);
  }
  s.M[i * N + tid] = mic;
#pragma unroll
  for (int m = 0; m < 6; ++m) col.F[i][m] = S[m] * mic + t[m];
}

// qdd = Minv (u - c), Minv read from its upper triangle
template <typename T, int N>
TMR_HD void ph_qdd(const Lane<T>& s, int tid) {
  if (tid < N) {
    const int j = tid;
    T acc = 0;
    for (int k = 0; k < N; ++k)
      acc += s.M[k >= j ? j * N + k : k * N + j] * (s.u[k] - s.c[k]);
    s.qdd[j] = acc;
  }
}

// A phase, then the group's barrier; on the host, the phase for every tid.
#ifdef __CUDA_ARCH__
#define TMR_GROUP_PHASE(CALL) \
  do {                        \
    CALL;                     \
    __syncwarp(mask);         \
  } while (0)
#elif defined(TMR_FD_REVERSE_TIDS)
#define TMR_GROUP_PHASE(CALL) \
  for (int tid = G - 1; tid >= 0; --tid) CALL
#else
#define TMR_GROUP_PHASE(CALL) \
  for (int tid = 0; tid < G; ++tid) CALL
#endif

// Each thread's own column state: its registers on the card; on the host,
// where the phases run thread after thread, one Col per thread.
#ifdef __CUDA_ARCH__
#define TMR_OWN 0
constexpr int NOWN = 1;
#else
#define TMR_OWN tid
constexpr int NOWN = G;
#endif

// one lane's whole recursion; every thread of its group calls it.  The
// loops over links are unrolled, so each column's registers are indexed
// by constants (a parent, which is data, is matched, never indexed by).
template <typename T, int N>
TMR_HD void fd_group(const Lane<T>& s, const SRobot<T>& R, int tid,
                     unsigned mask) {
  (void)tid;
  (void)mask;
  Col<T, N> col[NOWN];
  TMR_GROUP_PHASE((ph_init<T, N>(s, R, tid, col[TMR_OWN])));
  TMR_GROUP_PHASE((ph_rnea_va0<T, N>(s, R, tid)));
#pragma unroll
  for (int i = 0; i < N; ++i) {
    TMR_GROUP_PHASE((ph_rnea_a<T, N>(s, R, tid, i)));
    TMR_GROUP_PHASE((ph_rnea_f<T, N>(s, R, tid, i)));
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    TMR_GROUP_PHASE((ph_bwd_u<T, N>(s, R, tid, i)));
    TMR_GROUP_PHASE((ph_bwd_cols<T, N>(s, R, tid, i, col[TMR_OWN])));
    if (R.parent(i) >= 0) TMR_GROUP_PHASE((ph_bwd_ia<T, N>(s, R, tid, i)));
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    TMR_GROUP_PHASE((ph_fwd<T, N>(s, R, tid, i, col[TMR_OWN])));
  TMR_GROUP_PHASE((ph_qdd<T, N>(s, tid)));
}

// the block's robot buffer and its lanes' q, qd, u (zero past L), read
// along lanes by threads t = t0, t0 + nt, ...
template <typename T, int N>
TMR_HD void block_load(T* sm, const T* consts, const T* Q, const T* QD,
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

template <typename T, int N>
TMR_HD void block_store(T* sm, T* out, int L, int lane0, int t0, int nt) {
  T* lanes = sm + robot_elems(N);
  for (int k = t0; k < N * LANES; k += nt) {
    const int j = k / LANES, l = k % LANES, lane = lane0 + l;
    if (lane < L) out[(size_t)j * L + lane] = carve(lanes + l * lane_elems(N), N).qdd[j];
  }
}

#ifdef __CUDACC__
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
fd_kernel(const T* __restrict__ q, const T* __restrict__ qd,
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
    fd_group<T, N>(carve(sm + robot_elems(N) + g * lane_elems(N), N),
                   SRobot<T>{sm}, tid, mask);
  }
  __syncthreads();
  block_store<T, N>(sm, out, L, lane0, threadIdx.x, THREADS);
}

template <typename T>
int launch_fd(const void* q, const void* qd, const void* u, const void* c,
              void* out, int n, int L, void* stream) {
  if (n < 1 || n > 7) return -1;
  const size_t bytes = smem_elems(n) * sizeof(T);
  const dim3 grid((L + LANES - 1) / LANES), block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define TMR_CALL(NN)                                                       \
  err = cudaFuncSetAttribute((const void*)fd_kernel<T, NN>,                \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                             (int)bytes);                                  \
  if (err != cudaSuccess) return (int)err;                                 \
  fd_kernel<T, NN><<<grid, block, bytes, s>>>(                             \
      (const T*)q, (const T*)qd, (const T*)u, (const T*)c, (T*)out, L)
  TMR_SWITCH_N(n, TMR_CALL)
#undef TMR_CALL
  return (int)cudaGetLastError();
}
#else
// the host loop: block after block, the block's lanes one after another,
// each lane's phases for tid = 0..G-1 in turn
template <typename T>
int launch_fd(const void* q, const void* qd, const void* u, const void* c,
              void* out, int n, int L, void*) {
  if (n < 1 || n > 7) return -1;
  std::vector<T> buf(smem_elems(n));
  T* sm = buf.data();
#define TMR_CALL(NN)                                                         \
  for (int lane0 = 0; lane0 < L; lane0 += LANES) {                           \
    block_load<T, NN>(sm, (const T*)c, (const T*)q, (const T*)qd,            \
                      (const T*)u, L, lane0, 0, 1);                          \
    for (int g = 0; g < LANES && lane0 + g < L; ++g)                         \
      fd_group<T, NN>(carve(sm + robot_elems(NN) + g * lane_elems(NN), NN),  \
                      SRobot<T>{sm}, 0, 0u);                                 \
    block_store<T, NN>(sm, (T*)out, L, lane0, 0, 1);                         \
  }
  TMR_SWITCH_N(n, TMR_CALL)
#undef TMR_CALL
  return 0;
}
#endif

}  // namespace fd
}  // namespace tmr

extern "C" int tmr_fd_f32(const void* q, const void* qd, const void* u,
                          const void* consts, void* out, int n, int L,
                          void* stream) {
  return tmr::fd::launch_fd<float>(q, qd, u, consts, out, n, L, stream);
}

extern "C" int tmr_fd_f64(const void* q, const void* qd, const void* u,
                          const void* consts, void* out, int n, int L,
                          void* stream) {
  return tmr::fd::launch_fd<double>(q, qd, u, consts, out, n, L, stream);
}

// values of dynamic shared memory one block needs (ops/lanes.fd_smem_bytes)
extern "C" long long tmr_fd_smem_elems(int n) {
  return (long long)tmr::fd::smem_elems(n);
}
