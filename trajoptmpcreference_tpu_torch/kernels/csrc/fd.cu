// K2 — forward dynamics over lanes: qdd = Minv(q) (u - c(q, qd)).
//
// Replaces the TPU kernel trajoptmpcreference_tpu/ops/lanes.py
// `_pallas_fd` (body `fd_lanes`).  Plain version: ops/lanes.py `fd_lanes`.
//
// One thread per lane, (n, L) in and out with the lane index minor, so a
// warp reads 32 neighbouring lanes of each row.  Bound on the H100 by local
// memory: the Minv recursion keeps ~600 values per lane at n = 6 (F, IA,
// X), more than the register file holds, so they live in a per-thread
// stack frame; device-memory traffic is only 4n values per lane.  This
// first version accepts that.
#include "lanes_common.cuh"

namespace tmr {

template <typename T, int N>
TMR_HD void fd_lane(const T* Q, const T* QD, const T* U, const T* consts,
                    T* out, int L, int lane) {
  const Robot<T> R{consts};
  T q[N], qd[N], u[N], qdd[N];
  for (int j = 0; j < N; ++j) {
    q[j] = Q[j * L + lane];
    qd[j] = QD[j * L + lane];
    u[j] = U[j * L + lane];
  }
  T X[N][36];
  T M[N][N];
  forward_dynamics<T, N>(R, q, qd, u, X, M, qdd);
  for (int r = 0; r < N; ++r) out[r * L + lane] = qdd[r];
}

#ifdef __CUDACC__
template <typename T, int N>
__global__ void __launch_bounds__(BLOCK)
fd_kernel(const T* __restrict__ q, const T* __restrict__ qd,
          const T* __restrict__ u, const T* __restrict__ consts,
          T* __restrict__ out, int L) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  fd_lane<T, N>(q, qd, u, consts, out, L, lane);
}

template <typename T>
int launch_fd(const void* q, const void* qd, const void* u, const void* c,
              void* out, int n, int L, void* stream) {
  const dim3 grid((L + BLOCK - 1) / BLOCK), block(BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TMR_CALL(NN)                                                       \
  fd_kernel<T, NN><<<grid, block, 0, s>>>(                                 \
      (const T*)q, (const T*)qd, (const T*)u, (const T*)c, (T*)out, L)
  TMR_SWITCH_N(n, TMR_CALL)
#undef TMR_CALL
  return (int)cudaGetLastError();
}
#else
template <typename T>
int launch_fd(const void* q, const void* qd, const void* u, const void* c,
              void* out, int n, int L, void*) {
#define TMR_CALL(NN)                                                   \
  for (int lane = 0; lane < L; ++lane)                                 \
    fd_lane<T, NN>((const T*)q, (const T*)qd, (const T*)u, (const T*)c, \
                   (T*)out, L, lane)
  TMR_SWITCH_N(n, TMR_CALL)
#undef TMR_CALL
  return 0;
}
#endif

}  // namespace tmr

extern "C" int tmr_fd_f32(const void* q, const void* qd, const void* u,
                          const void* consts, void* out, int n, int L,
                          void* stream) {
  return tmr::launch_fd<float>(q, qd, u, consts, out, n, L, stream);
}

extern "C" int tmr_fd_f64(const void* q, const void* qd, const void* u,
                          const void* consts, void* out, int n, int L,
                          void* stream) {
  return tmr::launch_fd<double>(q, qd, u, consts, out, n, L, stream);
}
