// Shared device code for the lanes kernels K1 (fd_grad.cu), K2 (fd.cu) and
// K3 (task_vec.cu): the packed robot buffer, small spatial-algebra helpers,
// joint transforms, RNEA and the analytic Minv.  One thread owns one lane
// (scenario x knot); every per-lane quantity is a small local array.
//
// The same sources also compile as plain C++ (no __CUDACC__): TMR_HD then
// expands to `inline` and each .cu file exposes a host loop over lanes, so
// the kernel arithmetic can be checked on a CPU with g++
// (tests/test_torch_kernel_sources.py).  The CUDA wrappers never use it.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TMR_HD __device__ __forceinline__
#else
#include <math.h>
#define TMR_HD inline
#endif

namespace tmr {

// ---- packed robot buffer (ops/lanes.py pack_robot) -----------------------
// header: [gravity, ee offset x, y, z]; then one JOINT_STRIDE block per joint
constexpr int HEADER = 4;
constexpr int JOINT_STRIDE = 128;
constexpr int O_S = 0, O_I6 = 6, O_XF = 42, O_AX = 78, O_A2 = 87,
              O_DAMP = 96, O_JTYPE = 97, O_PARENT = 98, O_EF = 99,
              O_TF = 108, O_AXIS = 111, O_EFAX = 114, O_CHAIN = 117;
constexpr int REVOLUTE = 0;
constexpr int BLOCK = 128;  // threads per block; one lane per thread

template <typename T>
TMR_HD T ld(const T* p) {
#ifdef __CUDACC__
  return __ldg(p);
#else
  return *p;
#endif
}

TMR_HD float tsin(float x) { return sinf(x); }
TMR_HD double tsin(double x) { return sin(x); }
TMR_HD float tcos(float x) { return cosf(x); }
TMR_HD double tcos(double x) { return cos(x); }

template <typename T>
struct Robot {
  const T* c;
  TMR_HD T hdr(int k) const { return ld(c + k); }
  TMR_HD T at(int j, int off) const { return ld(c + HEADER + j * JOINT_STRIDE + off); }
  TMR_HD int parent(int j) const { return (int)at(j, O_PARENT); }
  TMR_HD bool revolute(int j) const { return (int)at(j, O_JTYPE) == REVOLUTE; }
  TMR_HD void S(int j, T s[6]) const {
    for (int r = 0; r < 6; ++r) s[r] = at(j, O_S + r);
  }
};

// ---- spatial algebra on 6-vectors and row-major 6x6 matrices -------------
template <typename T>
TMR_HD void crm_v(const T a[6], const T b[6], T o[6]) {  // crm(a) @ b
  o[0] = -a[2] * b[1] + a[1] * b[2];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = -a[1] * b[0] + a[0] * b[1];
  o[3] = -a[2] * b[4] + a[1] * b[5] - a[5] * b[1] + a[4] * b[2];
  o[4] = a[2] * b[3] - a[0] * b[5] + a[5] * b[0] - a[3] * b[2];
  o[5] = -a[1] * b[3] + a[0] * b[4] - a[4] * b[0] + a[3] * b[1];
}

template <typename T>
TMR_HD void crf_v(const T a[6], const T b[6], T o[6]) {  // crf(a) @ b
  o[0] = -a[2] * b[1] + a[1] * b[2] - a[5] * b[4] + a[4] * b[5];
  o[1] = a[2] * b[0] - a[0] * b[2] + a[5] * b[3] - a[3] * b[5];
  o[2] = -a[1] * b[0] + a[0] * b[1] - a[4] * b[3] + a[3] * b[4];
  o[3] = -a[2] * b[4] + a[1] * b[5];
  o[4] = a[2] * b[3] - a[0] * b[5];
  o[5] = -a[1] * b[3] + a[0] * b[4];
}

template <typename T>
TMR_HD void mv6(const T M[36], const T v[6], T o[6]) {  // M @ v
  for (int r = 0; r < 6; ++r) {
    T s = 0;
    for (int k = 0; k < 6; ++k) s += M[r * 6 + k] * v[k];
    o[r] = s;
  }
}

template <typename T>
TMR_HD void mtv6(const T M[36], const T v[6], T o[6]) {  // M^T @ v
  for (int c = 0; c < 6; ++c) {
    T s = 0;
    for (int k = 0; k < 6; ++k) s += M[k * 6 + c] * v[k];
    o[c] = s;
  }
}

// I6 (from the packed buffer) @ v
template <typename T>
TMR_HD void inertia_v(const Robot<T>& R, int j, const T v[6], T o[6]) {
  for (int r = 0; r < 6; ++r) {
    T s = 0;
    for (int k = 0; k < 6; ++k) s += R.at(j, O_I6 + r * 6 + k) * v[k];
    o[r] = s;
  }
}

// ---- joint spatial transform X_j(theta) = Xfree(theta) @ X_fixed ----------
template <typename T>
TMR_HD void joint_X(const Robot<T>& R, int j, T theta, T X[36]) {
  if (R.revolute(j)) {
    const T st = tsin(theta), ct = T(1) - tcos(theta);
    T E[9];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        E[r * 3 + c] = T(r == c) - st * R.at(j, O_AX + r * 3 + c) +
                       ct * R.at(j, O_A2 + r * 3 + c);
    // Xfree = blkdiag(E, E)
    for (int r = 0; r < 6; ++r) {
      const int b = (r / 3) * 3;
      for (int c = 0; c < 6; ++c) {
        T s = 0;
        for (int k = 0; k < 3; ++k)
          s += E[(r % 3) * 3 + k] * R.at(j, O_XF + (b + k) * 6 + c);
        X[r * 6 + c] = s;
      }
    }
  } else {
    // Xfree = [[I, 0], [-K, I]], K = skew(axis) * theta
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 6; ++c) X[r * 6 + c] = R.at(j, O_XF + r * 6 + c);
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 6; ++c) {
        T s = R.at(j, O_XF + (3 + r) * 6 + c);
        for (int k = 0; k < 3; ++k)
          s -= R.at(j, O_AX + r * 3 + k) * theta * R.at(j, O_XF + k * 6 + c);
        X[(3 + r) * 6 + c] = s;
      }
  }
}

// ---- RNEA: bias (qdd == nullptr) or inverse dynamics ----------------------
// v, a, f per link; f holds the accumulated (post backward pass) forces.
template <typename T, int N>
TMR_HD void rnea(const Robot<T>& R, T (*X)[36], const T* qd,
                 const T* qdd, T (*v)[6], T (*a)[6], T (*f)[6], T* c) {
  T g[6] = {0, 0, 0, 0, 0, -R.hdr(0)};
  for (int i = 0; i < N; ++i) {
    T S[6], t[6], Iv[6], Ia[6];
    R.S(i, S);
    const int p = R.parent(i);
    if (p < 0) {
      for (int r = 0; r < 6; ++r) v[i][r] = S[r] * qd[i];
      mv6(X[i], g, a[i]);
    } else {
      mv6(X[i], v[p], v[i]);
      for (int r = 0; r < 6; ++r) v[i][r] += S[r] * qd[i];
      mv6(X[i], a[p], a[i]);
    }
    crm_v(v[i], S, t);
    for (int r = 0; r < 6; ++r) a[i][r] += qd[i] * t[r];
    if (qdd)
      for (int r = 0; r < 6; ++r) a[i][r] += S[r] * qdd[i];
    inertia_v(R, i, v[i], Iv);
    inertia_v(R, i, a[i], Ia);
    crf_v(v[i], Iv, t);
    for (int r = 0; r < 6; ++r) f[i][r] = Ia[r] + t[r];
  }
  for (int i = N - 1; i >= 0; --i) {
    T S[6];
    R.S(i, S);
    T s = 0;
    for (int r = 0; r < 6; ++r) s += S[r] * f[i][r];
    c[i] = s;
    const int p = R.parent(i);
    if (p >= 0) {
      T t[6];
      mtv6(X[i], f[i], t);
      for (int r = 0; r < 6; ++r) f[p][r] += t[r];
    }
  }
}

// ---- analytic Minv (ref: RBDReference.py:805-930) -------------------------
// Row i is nonzero only on columns >= i (DFS numbering), so rows are built
// over columns i.. and the upper triangle is mirrored at the end.
template <typename T, int N>
TMR_HD void minv(const Robot<T>& R, T (*X)[36], T (*M)[N]) {
  T IA[N][36];
  T F[N][6][N];
  T U[N][6];
  T Dinv[N];
  for (int i = 0; i < N; ++i) {
    for (int k = 0; k < 36; ++k) IA[i][k] = R.at(i, O_I6 + k);
    for (int r = 0; r < 6; ++r)
      for (int c = 0; c < N; ++c) F[i][r][c] = 0;
    for (int c = 0; c < N; ++c) M[i][c] = 0;
  }
  for (int i = N - 1; i >= 0; --i) {
    T S[6];
    R.S(i, S);
    for (int r = 0; r < 6; ++r) {
      T s = 0;
      for (int k = 0; k < 6; ++k) s += S[k] * IA[i][r * 6 + k];
      U[i][r] = s;
    }
    T d = 0;
    for (int r = 0; r < 6; ++r) d += S[r] * U[i][r];
    Dinv[i] = T(1) / d;
    for (int c = i; c < N; ++c) {
      T sf = 0;
      for (int r = 0; r < 6; ++r) sf += S[r] * F[i][r][c];
      M[i][c] = -Dinv[i] * sf;
    }
    M[i][i] += Dinv[i];
    const int p = R.parent(i);
    if (p >= 0) {
      for (int r = 0; r < 6; ++r)
        for (int c = i; c < N; ++c) F[i][r][c] += U[i][r] * M[i][c];
      for (int c = 0; c < N; ++c) {
        T col[6], t[6];
        for (int r = 0; r < 6; ++r) col[r] = F[i][r][c];
        mtv6(X[i], col, t);
        for (int r = 0; r < 6; ++r) F[p][r][c] += t[r];
      }
      // IA[p] += X^T (IA - U Dinv U^T) X
      T Ia[36], IaX[36];
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c)
          Ia[r * 6 + c] = IA[i][r * 6 + c] - U[i][r] * (Dinv[i] * U[i][c]);
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c) {
          T s = 0;
          for (int k = 0; k < 6; ++k) s += Ia[r * 6 + k] * X[i][k * 6 + c];
          IaX[r * 6 + c] = s;
        }
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c) {
          T s = 0;
          for (int k = 0; k < 6; ++k) s += X[i][k * 6 + r] * IaX[k * 6 + c];
          IA[p][r * 6 + c] += s;
        }
    }
  }
  for (int i = 0; i < N; ++i) {
    T S[6];
    R.S(i, S);
    const int p = R.parent(i);
    if (p >= 0) {
      T UX[6];
      for (int c = 0; c < 6; ++c) {
        T s = 0;
        for (int r = 0; r < 6; ++r) s += U[i][r] * X[i][r * 6 + c];
        UX[c] = s;
      }
      for (int c = i; c < N; ++c) {
        T s = 0;
        for (int r = 0; r < 6; ++r) s += UX[r] * F[p][r][c];
        M[i][c] -= Dinv[i] * s;
      }
    }
    for (int c = i; c < N; ++c) {
      T t[6] = {0, 0, 0, 0, 0, 0};
      if (p >= 0) {
        T col[6];
        for (int r = 0; r < 6; ++r) col[r] = F[p][r][c];
        mv6(X[i], col, t);
      }
      for (int r = 0; r < 6; ++r) F[i][r][c] = S[r] * M[i][c] + t[r];
    }
  }
  for (int i = 0; i < N; ++i)
    for (int j = i + 1; j < N; ++j) M[j][i] = M[i][j];
}

// qdd = Minv (u - c) from the bias RNEA; also returns X and Minv for K1.
template <typename T, int N>
TMR_HD void forward_dynamics(const Robot<T>& R, const T* q, const T* qd,
                             const T* u, T (*X)[36], T (*M)[N], T* qdd) {
  for (int j = 0; j < N; ++j) joint_X(R, j, q[j], X[j]);
  T c[N];
  {
    T v[N][6], a[N][6], f[N][6];
    rnea<T, N>(R, X, qd, nullptr, v, a, f, c);
  }
  minv<T, N>(R, X, M);
  for (int r = 0; r < N; ++r) {
    T s = 0;
    for (int j = 0; j < N; ++j) s += M[r][j] * (u[j] - c[j]);
    qdd[r] = s;
  }
}

}  // namespace tmr

// Launch / host-loop boilerplate shared by the three .cu files.  n is a
// template parameter instantiated for 1..7 joints.
#define TMR_SWITCH_N(n, CALL) \
  switch (n) {                \
    case 1: CALL(1); break;   \
    case 2: CALL(2); break;   \
    case 3: CALL(3); break;   \
    case 4: CALL(4); break;   \
    case 5: CALL(5); break;   \
    case 6: CALL(6); break;   \
    case 7: CALL(7); break;   \
    default: return -1;       \
  }
