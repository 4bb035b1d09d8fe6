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
// The group's phases and fd_group are in fd_group.cuh, which K1 shares;
// this file holds K2's lane layout, its block load and store, and its
// launch.
#include "fd_group.cuh"

namespace tmr {
namespace fd {

using namespace group;

// values one lane keeps in shared memory, padded to 8 mod 32
TMR_HHD size_t lane_elems(int n) {
  const size_t e = 51 * (size_t)n + (size_t)n * n + 42;
  return e + (40 - e % 32) % 32;
}

// dynamic shared memory of one block, in values of the kernel's type
TMR_HHD size_t smem_elems(int n) {
  return robot_elems(n) + LANES * lane_elems(n);
}

// K2's layout of one lane's state in its slice of shared memory
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

// values of dynamic shared memory one block needs (ops/lanes.smem_bytes)
extern "C" long long tmr_fd_smem_elems(int n) {
  return (long long)tmr::fd::smem_elems(n);
}
