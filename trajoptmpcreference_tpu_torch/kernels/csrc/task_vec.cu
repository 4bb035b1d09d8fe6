// K3 — task-space residual over lanes: [ee_pos_k(q); J(q) qd], k = min(3, n)
//   (n, L), (n, L) -> (2k, L)
//
// Replaces the TPU kernel trajoptmpcreference_tpu/ops/kinematics.py
// `_pallas_task_vec` (body `task_vec_L` over `frames_L`).  Plain version:
// ops/kinematics.py `LaneKinematics.task_vec_L`.
//
// What bounds it on the H100: neither its bytes (2n values in, 2k out: 72 B
// a lane at n = 6 in f32) nor its operations (945 a lane), but latency.
// Below one wave of blocks its device time is the launch (an empty kernel's
// time) plus one round trip to memory plus one lane's chain of dependent
// arithmetic, which is the larger part (PERF.md section 6); past a few
// blocks per SM, the instructions each warp issues.  The first design (one
// thread per lane as well) put a load of a robot constant from device
// memory between dependent operations ~210 times a lane, so each SM waited
// on the constants' cache lines one after another; it kept w and o in a
// 176-byte local-memory stack and composed dense 4x4 transforms.
//
// The design (PERF.md section 6 has the tries; a group of 8 threads per
// lane, phases over joints and rows, issued ~3x the warp instructions a
// lane, was no faster below 32,256 lanes and slower above):
// * one thread per lane, 128 lanes per block;
// * the fields of the packed robot buffer K3 reads ([O_AX, O_CHAIN] of
//   each joint, 40 values, and the end-effector offset) are copied into
//   shared memory once per block, all loads issued together, while each
//   thread's q and qd are in flight; a constant is then a shared-memory
//   broadcast, and no load from device memory sits inside the chain;
// * J qd is summed down the chain as the chain goes (lane_body says how),
//   so no joint's w and o wait in registers for the end-effector point:
//   72 registers in f32, so that one wave (seven blocks an SM) holds all
//   96,768 lanes of the line search's call;
// * the loops over joints are unrolled, so every register array is
//   indexed by constants: no stack but libm's sincos slow path (its
//   argument reduction for large |q|; libm precision is kept, q is
//   unbounded in run-away scenarios);
// * every joint's sincos comes first, so no value of the chain is live
//   across those calls (spilled, when the calls sat inside the chain);
// * the chain composes (rotation, origin) pairs, 12 values, not 4x4
//   products; a joint off the leaf's chain is skipped (a branch on a
//   constant: the same for every lane of a warp).
// q and qd are read, and the 2k rows written, along lanes (coalesced); the
// ragged tail (lane >= L) is masked.
//
// Compiled as plain C++ (no __CUDACC__) the same lane body runs block
// after block, the block's lanes in turn (in reverse under
// -DTMR_GROUP_REVERSE_TIDS), for tests/test_torch_kernel_sources.py.
#include "lanes_common.cuh"

#ifndef __CUDACC__
#include <stddef.h>
#include <vector>
#endif

namespace tmr {
namespace task_vec {

constexpr int THREADS = 128;  // lanes per block, one per thread
// the window of a joint's packed block that K3 reads ([O_AX, O_CHAIN]),
// copied to shared memory at a stride of CW, the end-effector offset after
constexpr int CW = O_CHAIN + 1 - O_AX;
constexpr int C_AX = 0, C_A2 = O_A2 - O_AX, C_JTYPE = O_JTYPE - O_AX,
              C_EF = O_EF - O_AX, C_TF = O_TF - O_AX, C_AXIS = O_AXIS - O_AX,
              C_EFAX = O_EFAX - O_AX, C_CHAIN = O_CHAIN - O_AX;

#ifdef __CUDACC__
TMR_HD void tsincos(float x, float* s, float* c) { sincosf(x, s, c); }
TMR_HD void tsincos(double x, double* s, double* c) { sincos(x, s, c); }
#else
template <typename T>
inline void tsincos(T x, T* s, T* c) {
  *s = tsin(x);
  *c = tcos(x);
}
#endif

// the block's constants, read along the buffer by threads t0, t0 + NT, ...:
// every load is issued before the first store, so a thread waits on one
// round trip to device memory, not one per value it copies
template <typename T, int N, int NT>
TMR_HD void block_load(T* sm, const T* consts, int t0) {
  constexpr int M = N * CW + 3, IT = (M + NT - 1) / NT;
  T v[IT];
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int k = t0 + i * NT;
    v[i] = k >= M       ? T(0)
           : k < N * CW ? consts[HEADER + (k / CW) * JOINT_STRIDE + O_AX + k % CW]
                        : consts[1 + k - N * CW];
  }
#pragma unroll
  for (int i = 0; i < IT; ++i)
    if (t0 + i * NT < M) sm[t0 + i * NT] = v[i];
}

// one lane: q, qd (n each) -> res (2k), with the constants C in shared memory.
//
// J qd = sum_j qd_j w_j x (p - o_j) over the revolute chain joints, plus
// qd_j w_j over the prismatic ones.  p - o_j is the sum of the increments
// d_i = o_i - o_{i-1} after joint j (the last, p - o_n), so
//   J qd = sum_i W_{i-1} x d_i,  W_i = sum_{j <= i, revolute} qd_j w_j:
// one pass down the chain that keeps W and the sum, not every w_j and o_j
// until p is known, and no difference p - o_j of two long vectors.
template <typename T, int N>
TMR_HD void lane_body(const T* C, const T* q, const T* qd, T* res) {
  constexpr int K = N < 3 ? N : 3;
  // every revolute chain joint's sin and 1 - cos, before the chain
  T sn[N], c1[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T* J = C + j * CW;
    sn[j] = c1[j] = T(0);
    if (J[C_CHAIN] != T(0) && (int)J[C_JTYPE] == REVOLUTE) {
      T cs;
      tsincos(q[j], &sn[j], &cs);
      c1[j] = T(1) - cs;
    }
  }
  // the rotation R (row-major) and origin t so far, W, and J qd so far
  T R[9] = {T(1), T(0), T(0), T(0), T(1), T(0), T(0), T(0), T(1)};
  T t[3] = {T(0), T(0), T(0)}, W[3] = {T(0), T(0), T(0)};
  T v[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T* J = C + j * CW;
    if (J[C_CHAIN] == T(0)) continue;
    const bool rev = (int)J[C_JTYPE] == REVOLUTE;
    // the joint's local transform (ops/kinematics._joint_hom_lanes):
    // X[0:9] its rotation, row-major, X[9:12] its translation
    T X[12];
    if (rev) {
      T E[9];  // I - sin A + (1 - cos) A^2
#pragma unroll
      for (int k = 0; k < 9; ++k)
        E[k] = T(k % 4 == 0) - sn[j] * J[C_AX + k] + c1[j] * J[C_A2 + k];
#pragma unroll
      for (int r = 0; r < 3; ++r)  // (E E_f)^T
#pragma unroll
        for (int c = 0; c < 3; ++c)
          X[c * 3 + r] = E[r * 3] * J[C_EF + c] +
                         E[r * 3 + 1] * J[C_EF + 3 + c] +
                         E[r * 3 + 2] * J[C_EF + 6 + c];
#pragma unroll
      for (int r = 0; r < 3; ++r) X[9 + r] = J[C_TF + r];
    } else {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) X[r * 3 + c] = J[C_EF + c * 3 + r];
        X[9 + r] = J[C_AXIS + r] * q[j] + J[C_TF + r];
      }
    }
    // the world axis w_j = R E_f^T axis, the increment d_j = o_j - o_{j-1}
    T w[3], d[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      w[r] = R[r * 3] * J[C_EFAX] + R[r * 3 + 1] * J[C_EFAX + 1] +
             R[r * 3 + 2] * J[C_EFAX + 2];
      d[r] = R[r * 3] * X[9] + R[r * 3 + 1] * X[10] + R[r * 3 + 2] * X[11];
    }
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int r1 = r == 2 ? 0 : r + 1, r2 = r == 0 ? 2 : r - 1;
      v[r] += W[r1] * d[r2] - W[r2] * d[r1];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      t[r] += d[r];
      if (rev)
        W[r] += qd[j] * w[r];
      else if (r < K)
        v[r] += qd[j] * w[r];
    }
    T Rn[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        Rn[r * 3 + c] = R[r * 3] * X[c] + R[r * 3 + 1] * X[3 + c] +
                        R[r * 3 + 2] * X[6 + c];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = Rn[k];
  }
  // the last increment, p - o_n = R offset
  const T* off = C + N * CW;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const T d = R[r * 3] * off[0] + R[r * 3 + 1] * off[1] + R[r * 3 + 2] * off[2];
    if (r < K) res[r] = t[r] + d;
    t[r] = d;
  }
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int r1 = r == 2 ? 0 : r + 1, r2 = r == 0 ? 2 : r - 1;
    res[K + r] = v[r] + (W[r1] * t[r2] - W[r2] * t[r1]);
  }
}

#ifdef __CUDACC__
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
task_vec_kernel(const T* __restrict__ q, const T* __restrict__ qd,
                const T* __restrict__ consts, T* __restrict__ out, int L) {
  constexpr int K = N < 3 ? N : 3;
  __shared__ T sm[N * CW + 3];
  const int l = blockIdx.x * THREADS + threadIdx.x;
  T qv[N], qdv[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    qv[j] = l < L ? q[(size_t)j * L + l] : T(0);
    qdv[j] = l < L ? qd[(size_t)j * L + l] : T(0);
  }
  block_load<T, N, THREADS>(sm, consts, threadIdx.x);
  __syncthreads();
  if (l >= L) return;
  T res[2 * K];
  lane_body<T, N>(sm, qv, qdv, res);
#pragma unroll
  for (int r = 0; r < 2 * K; ++r) out[(size_t)r * L + l] = res[r];
}

template <typename T>
int launch_task_vec(const void* q, const void* qd, const void* c, void* out,
                    int n, int L, void* stream) {
  const dim3 grid((L + THREADS - 1) / THREADS), block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TMR_CALL(NN)                                  \
  task_vec_kernel<T, NN><<<grid, block, 0, s>>>(      \
      (const T*)q, (const T*)qd, (const T*)c, (T*)out, L)
  TMR_SWITCH_N(n, TMR_CALL)
#undef TMR_CALL
  return (int)cudaGetLastError();
}
#else
// the host loop: block after block, each block's lanes in turn
template <typename T, int N>
void host_blocks(const T* Q, const T* QD, const T* C, T* out, int L) {
  constexpr int K = N < 3 ? N : 3;
  std::vector<T> sm(N * CW + 3);
  for (int l0 = 0; l0 < L; l0 += THREADS) {
    block_load<T, N, 1>(sm.data(), C, 0);
    const int nl = L - l0 < THREADS ? L - l0 : THREADS;
    for (int i = 0; i < nl; ++i) {
#ifdef TMR_GROUP_REVERSE_TIDS
      const int l = l0 + nl - 1 - i;
#else
      const int l = l0 + i;
#endif
      T qv[N], qdv[N], res[2 * K];
      for (int j = 0; j < N; ++j) {
        qv[j] = Q[(size_t)j * L + l];
        qdv[j] = QD[(size_t)j * L + l];
      }
      lane_body<T, N>(sm.data(), qv, qdv, res);
      for (int r = 0; r < 2 * K; ++r) out[(size_t)r * L + l] = res[r];
    }
  }
}

template <typename T>
int launch_task_vec(const void* q, const void* qd, const void* c, void* out,
                    int n, int L, void*) {
#define TMR_CALL(NN) \
  host_blocks<T, NN>((const T*)q, (const T*)qd, (const T*)c, (T*)out, L)
  TMR_SWITCH_N(n, TMR_CALL)
#undef TMR_CALL
  return 0;
}
#endif

}  // namespace task_vec
}  // namespace tmr

// `u` is unused: every library entry shares one signature.
extern "C" int tmr_task_vec_f32(const void* q, const void* qd, const void*,
                                const void* consts, void* out, int n, int L,
                                void* stream) {
  return tmr::task_vec::launch_task_vec<float>(q, qd, consts, out, n, L,
                                               stream);
}

extern "C" int tmr_task_vec_f64(const void* q, const void* qd, const void*,
                                const void* consts, void* out, int n, int L,
                                void* stream) {
  return tmr::task_vec::launch_task_vec<double>(q, qd, consts, out, n, L,
                                                stream);
}
