// K3 — task-space residual over lanes: [ee_pos_k(q); J(q) qd], k = min(3, n)
//   (n, L), (n, L) -> (2k, L)
//
// Replaces the TPU kernel trajoptmpcreference_tpu/ops/kinematics.py
// `_pallas_task_vec` (body `task_vec_L` over `frames_L`).  Plain version:
// ops/kinematics.py `LaneKinematics.task_vec_L`.
//
// One thread per lane walks the homogeneous chain once (4x4 products), keeps
// each chain joint's world axis w and origin o, then forms the Jacobian
// columns (w x (p - o) revolute, w prismatic) and contracts J qd.  Bound on
// the H100 by bytes per lane: 2n values in and 2k out (~72 B at n = 6, f32)
// against a few hundred flops; the live state (H, w, o: ~16 + 6n values)
// fits in registers.
#include "lanes_common.cuh"

namespace tmr {

template <typename T, int N>
TMR_HD void task_vec_lane(const T* Q, const T* QD, const T* consts, T* out,
                          int L, int lane) {
  const Robot<T> R{consts};
  constexpr int K = N < 3 ? N : 3;
  T H[16] = {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1};
  T w[N][3], o[N][3];
  for (int j = 0; j < N; ++j) {
    for (int r = 0; r < 3; ++r) w[j][r] = o[j][r] = 0;
    if (R.at(j, O_CHAIN) == T(0)) continue;
    const T theta = Q[j * L + lane];
    // world axis: rotation up to this joint's fixed frame times E_f^T axis
    for (int r = 0; r < 3; ++r) {
      T s = 0;
      for (int c = 0; c < 3; ++c) s += H[r * 4 + c] * R.at(j, O_EFAX + c);
      w[j][r] = s;
    }
    // joint homogeneous transform Hj (ops/kinematics._joint_hom_lanes)
    T Hj[16] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1};
    if (R.revolute(j)) {
      const T st = tsin(theta), ct = T(1) - tcos(theta);
      T E[9];
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c)
          E[r * 3 + c] = T(r == c) - st * R.at(j, O_AX + r * 3 + c) +
                         ct * R.at(j, O_A2 + r * 3 + c);
      // rotation block = (E @ E_f)^T
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) {
          T s = 0;
          for (int k = 0; k < 3; ++k) s += E[r * 3 + k] * R.at(j, O_EF + k * 3 + c);
          Hj[c * 4 + r] = s;
        }
      for (int r = 0; r < 3; ++r) Hj[r * 4 + 3] = R.at(j, O_TF + r);
    } else {
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) Hj[r * 4 + c] = R.at(j, O_EF + c * 3 + r);
      for (int r = 0; r < 3; ++r)
        Hj[r * 4 + 3] = R.at(j, O_AXIS + r) * theta + R.at(j, O_TF + r);
    }
    T Hn[16];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        T s = 0;
        for (int k = 0; k < 4; ++k) s += H[r * 4 + k] * Hj[k * 4 + c];
        Hn[r * 4 + c] = s;
      }
    for (int k = 0; k < 16; ++k) H[k] = Hn[k];
    for (int r = 0; r < 3; ++r) o[j][r] = H[r * 4 + 3];
  }
  // ee point p = H [offset; 1]
  T p[3];
  for (int r = 0; r < 3; ++r) {
    T s = 0;
    for (int c = 0; c < 3; ++c) s += H[r * 4 + c] * R.hdr(1 + c);
    p[r] = s + H[r * 4 + 3];
  }
  T vel[3] = {0, 0, 0};
  for (int j = 0; j < N; ++j) {
    T J[3] = {0, 0, 0};
    if (R.at(j, O_CHAIN) != T(0)) {
      if (R.revolute(j)) {
        const T d0 = p[0] - o[j][0], d1 = p[1] - o[j][1], d2 = p[2] - o[j][2];
        J[0] = w[j][1] * d2 - w[j][2] * d1;
        J[1] = w[j][2] * d0 - w[j][0] * d2;
        J[2] = w[j][0] * d1 - w[j][1] * d0;
      } else {
        for (int r = 0; r < 3; ++r) J[r] = w[j][r];
      }
    }
    const T qdj = QD[j * L + lane];
    for (int r = 0; r < K; ++r) vel[r] += J[r] * qdj;
  }
  for (int r = 0; r < K; ++r) {
    out[r * L + lane] = p[r];
    out[(K + r) * L + lane] = vel[r];
  }
}

#ifdef __CUDACC__
template <typename T, int N>
__global__ void __launch_bounds__(BLOCK)
task_vec_kernel(const T* __restrict__ q, const T* __restrict__ qd,
                const T* __restrict__ consts, T* __restrict__ out, int L) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  task_vec_lane<T, N>(q, qd, consts, out, L, lane);
}

template <typename T>
int launch_task_vec(const void* q, const void* qd, const void* c, void* out,
                    int n, int L, void* stream) {
  const dim3 grid((L + BLOCK - 1) / BLOCK), block(BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TMR_CALL(NN)                                  \
  task_vec_kernel<T, NN><<<grid, block, 0, s>>>(      \
      (const T*)q, (const T*)qd, (const T*)c, (T*)out, L)
  TMR_SWITCH_N(n, TMR_CALL)
#undef TMR_CALL
  return (int)cudaGetLastError();
}
#else
template <typename T>
int launch_task_vec(const void* q, const void* qd, const void* c, void* out,
                    int n, int L, void*) {
#define TMR_CALL(NN)                                                      \
  for (int lane = 0; lane < L; ++lane)                                    \
    task_vec_lane<T, NN>((const T*)q, (const T*)qd, (const T*)c, (T*)out, \
                         L, lane)
  TMR_SWITCH_N(n, TMR_CALL)
#undef TMR_CALL
  return 0;
}
#endif

}  // namespace tmr

// `u` is unused: every library entry shares one signature.
extern "C" int tmr_task_vec_f32(const void* q, const void* qd, const void*,
                                const void* consts, void* out, int n, int L,
                                void* stream) {
  return tmr::launch_task_vec<float>(q, qd, consts, out, n, L, stream);
}

extern "C" int tmr_task_vec_f64(const void* q, const void* qd, const void*,
                                const void* consts, void* out, int n, int L,
                                void* stream) {
  return tmr::launch_task_vec<double>(q, qd, consts, out, n, L, stream);
}
