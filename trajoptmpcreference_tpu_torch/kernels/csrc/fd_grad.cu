// K1 — forward-dynamics gradient over lanes:
//   dqdd/d[q, qd, u] = [-Minv dtau/dq, -Minv dtau/dqd, Minv]   (n, 3n, L)
//
// Replaces the TPU kernel trajoptmpcreference_tpu/ops/lanes.py
// `_pallas_fd_grad` (body `fd_grad_lanes`).  Plain version: ops/lanes.py
// `fd_grad_lanes`.
//
// One thread per lane runs joint transforms, the bias RNEA, the analytic
// Minv, qdd = Minv (u - c), a second RNEA with qdd, and the 4-pass dRNEA
// (dv, da, df by q and by qd, each (6, n) per link).  Bound on the H100 by
// registers and local memory: ~2,100 live values per lane at n = 6, far past
// 255 registers, live in a per-thread local-memory stack frame (ptxas -v
// reports its size at build time).  This first version accepts that; a
// thread group per scenario with the intermediates in shared memory (GRiD)
// is later work.
#include "lanes_common.cuh"

namespace tmr {

// dtau/d[q, qd] -> D (N x 2N), given X, qd and the (v, a, f_acc) of the
// RNEA run with qdd (ref: RBDReference.py:561-802).
template <typename T, int N>
TMR_HD void rnea_grad(const Robot<T>& R, T (*X)[36], const T* qd,
                      T (*v)[6], T (*a)[6], T (*f)[6], T (*D)[2 * N]) {
  T dvq[N][6][N], daq[N][6][N], dfq[N][6][N];
  T dvd[N][6][N], dad[N][6][N], dfd[N][6][N];
  const T g[6] = {0, 0, 0, 0, 0, -R.hdr(0)};
  for (int i = 0; i < N; ++i) {
    T S[6], t[6], u6[6];
    R.S(i, S);
    const int p = R.parent(i);
    if (p < 0) {
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < N; ++c)
          dvq[i][r][c] = daq[i][r][c] = dvd[i][r][c] = dad[i][r][c] = 0;
      mv6(X[i], g, u6);
      crm_v(u6, S, t);
      for (int r = 0; r < 6; ++r) daq[i][r][i] += t[r];
    } else {
      for (int c = 0; c < N; ++c) {
        T col[6], o[6];
        for (int r = 0; r < 6; ++r) col[r] = dvq[p][r][c];
        mv6(X[i], col, o);
        for (int r = 0; r < 6; ++r) dvq[i][r][c] = o[r];
        for (int r = 0; r < 6; ++r) col[r] = daq[p][r][c];
        mv6(X[i], col, o);
        for (int r = 0; r < 6; ++r) daq[i][r][c] = o[r];
        for (int r = 0; r < 6; ++r) col[r] = dvd[p][r][c];
        mv6(X[i], col, o);
        for (int r = 0; r < 6; ++r) dvd[i][r][c] = o[r];
        for (int r = 0; r < 6; ++r) col[r] = dad[p][r][c];
        mv6(X[i], col, o);
        for (int r = 0; r < 6; ++r) dad[i][r][c] = o[r];
      }
      mv6(X[i], v[p], u6);
      crm_v(u6, S, t);
      for (int r = 0; r < 6; ++r) dvq[i][r][i] += t[r];
      mv6(X[i], a[p], u6);
      crm_v(u6, S, t);
      for (int r = 0; r < 6; ++r) daq[i][r][i] += t[r];
    }
    // da -= qd_i crm(S) dv
    for (int c = 0; c < N; ++c) {
      T col[6];
      for (int r = 0; r < 6; ++r) col[r] = dvq[i][r][c];
      crm_v(S, col, t);
      for (int r = 0; r < 6; ++r) daq[i][r][c] -= qd[i] * t[r];
    }
    for (int r = 0; r < 6; ++r) dvd[i][r][i] += S[r];
    for (int c = 0; c < N; ++c) {
      T col[6];
      for (int r = 0; r < 6; ++r) col[r] = dvd[i][r][c];
      crm_v(S, col, t);
      for (int r = 0; r < 6; ++r) dad[i][r][c] -= qd[i] * t[r];
    }
    crm_v(v[i], S, t);
    for (int r = 0; r < 6; ++r) dad[i][r][i] += t[r];
    // df = I da + crf(dv) (I v) + crf(v) (I dv), and the same by qd
    T Iv[6];
    inertia_v(R, i, v[i], Iv);
    for (int c = 0; c < N; ++c) {
      T dv[6], da[6], Ida[6], Idv[6], t1[6], t2[6];
      for (int r = 0; r < 6; ++r) {
        dv[r] = dvq[i][r][c];
        da[r] = daq[i][r][c];
      }
      inertia_v(R, i, da, Ida);
      inertia_v(R, i, dv, Idv);
      crf_v(dv, Iv, t1);
      crf_v(v[i], Idv, t2);
      for (int r = 0; r < 6; ++r) dfq[i][r][c] = Ida[r] + t1[r] + t2[r];
      for (int r = 0; r < 6; ++r) {
        dv[r] = dvd[i][r][c];
        da[r] = dad[i][r][c];
      }
      inertia_v(R, i, da, Ida);
      inertia_v(R, i, dv, Idv);
      crf_v(dv, Iv, t1);
      crf_v(v[i], Idv, t2);
      for (int r = 0; r < 6; ++r) dfd[i][r][c] = Ida[r] + t1[r] + t2[r];
    }
  }
  for (int i = N - 1; i >= 0; --i) {
    T S[6];
    R.S(i, S);
    for (int c = 0; c < N; ++c) {
      T sq = 0, sd = 0;
      for (int r = 0; r < 6; ++r) {
        sq += S[r] * dfq[i][r][c];
        sd += S[r] * dfd[i][r][c];
      }
      D[i][c] = sq;
      D[i][N + c] = sd;
    }
    const int p = R.parent(i);
    if (p >= 0) {
      // fxS = crf(S) f_acc (ops/spatial.fxS)
      T fxS[6], tf[6];
      crf_v(S, f[i], fxS);
      mtv6(X[i], fxS, tf);
      for (int c = 0; c < N; ++c) {
        T col[6], o[6];
        for (int r = 0; r < 6; ++r) col[r] = dfq[i][r][c];
        mtv6(X[i], col, o);
        if (c == i)
          for (int r = 0; r < 6; ++r) o[r] += tf[r];
        for (int r = 0; r < 6; ++r) dfq[p][r][c] += o[r];
        for (int r = 0; r < 6; ++r) col[r] = dfd[i][r][c];
        mtv6(X[i], col, o);
        for (int r = 0; r < 6; ++r) dfd[p][r][c] += o[r];
      }
    }
  }
  for (int i = 0; i < N; ++i) D[i][N + i] += R.at(i, O_DAMP);
}

template <typename T, int N>
TMR_HD void fd_grad_lane(const T* Q, const T* QD, const T* U,
                         const T* consts, T* out, int L, int lane) {
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
  // second RNEA with qdd for the gradient's (v, a, f_acc)
  T v[N][6], a[N][6], f[N][6], c[N];
  rnea<T, N>(R, X, qd, qdd, v, a, f, c);
  T D[N][2 * N];
  rnea_grad<T, N>(R, X, qd, v, a, f, D);
  for (int r = 0; r < N; ++r) {
    for (int col = 0; col < 2 * N; ++col) {
      T s = 0;
      for (int j = 0; j < N; ++j) s += M[r][j] * D[j][col];
      out[(r * 3 * N + col) * L + lane] = -s;
    }
    for (int col = 0; col < N; ++col)
      out[(r * 3 * N + 2 * N + col) * L + lane] = M[r][col];
  }
}

#ifdef __CUDACC__
template <typename T, int N>
__global__ void __launch_bounds__(BLOCK)
fd_grad_kernel(const T* __restrict__ q, const T* __restrict__ qd,
               const T* __restrict__ u, const T* __restrict__ consts,
               T* __restrict__ out, int L) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  fd_grad_lane<T, N>(q, qd, u, consts, out, L, lane);
}

template <typename T>
int launch_fd_grad(const void* q, const void* qd, const void* u,
                   const void* c, void* out, int n, int L, void* stream) {
  const dim3 grid((L + BLOCK - 1) / BLOCK), block(BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TMR_CALL(NN)                                                       \
  fd_grad_kernel<T, NN><<<grid, block, 0, s>>>(                            \
      (const T*)q, (const T*)qd, (const T*)u, (const T*)c, (T*)out, L)
  TMR_SWITCH_N(n, TMR_CALL)
#undef TMR_CALL
  return (int)cudaGetLastError();
}
#else
template <typename T>
int launch_fd_grad(const void* q, const void* qd, const void* u,
                   const void* c, void* out, int n, int L, void*) {
#define TMR_CALL(NN)                                                        \
  for (int lane = 0; lane < L; ++lane)                                      \
    fd_grad_lane<T, NN>((const T*)q, (const T*)qd, (const T*)u, (const T*)c, \
                        (T*)out, L, lane)
  TMR_SWITCH_N(n, TMR_CALL)
#undef TMR_CALL
  return 0;
}
#endif

}  // namespace tmr

extern "C" int tmr_fd_grad_f32(const void* q, const void* qd, const void* u,
                               const void* consts, void* out, int n, int L,
                               void* stream) {
  return tmr::launch_fd_grad<float>(q, qd, u, consts, out, n, L, stream);
}

extern "C" int tmr_fd_grad_f64(const void* q, const void* qd, const void* u,
                               const void* consts, void* out, int n, int L,
                               void* stream) {
  return tmr::launch_fd_grad<double>(q, qd, u, consts, out, n, L, stream);
}
