// Generic rigid-body dynamics kernels over baked per-robot constants.
//
// The native analogue of the reference's GRiD layer: where GRiD's Python
// generator emits robot-specialized CUDA (_inner/_device/_kernel tiers,
// ref: GRiDCodeGenerator.py:261-353), this header holds the generic
// algorithms and codegen.py emits a tiny .cpp baking the robot constants
// (parents, joint axes, fixed transforms, spatial inertias) and the
// extern "C" API consumed through ctypes (native/lib.py).
//
// Algorithms mirror trajoptmpcreference_tpu/ops/rbd.py (RNEA fwd/bwd, the
// analytic 4-pass RNEA gradient, CRBA, ABA, forward dynamics + gradient)
// and ops/kinematics.py (homogeneous-chain EE position / Jacobian), which
// themselves follow the reference semantics (ref: RBDReference.py:399-930,
// RBDReference_generalized.py:913-1032).  Pure double, no deps.

#pragma once
#include <cmath>
#include <cstring>

// Max joint count the fixed stack buffers support (codegen.py validates).
constexpr int TMR_MAX_N = 32;

namespace tmr {

constexpr int REVOLUTE = 0;
constexpr int PRISMATIC = 1;

struct RobotConst {
  int n;                     // number of joints
  const int* parent;         // (n)
  const int* jtype;          // (n)
  const double* axis;        // (n,3)
  const double* X_fixed;     // (n,6,6) row-major
  const double* E_fixed;     // (n,3,3)
  const double* t_fixed;     // (n,3)
  const double* S;           // (n,6)
  const double* I;           // (n,6,6)
  const double* damping;     // (n)
  const double* ee_offset;   // (4) homogeneous tip offset in last-link frame
};

// ---------------------------------------------------------- small helpers
inline void mat6_vec(const double* A, const double* x, double* y) {
  for (int r = 0; r < 6; ++r) {
    double s = 0;
    for (int c = 0; c < 6; ++c) s += A[6 * r + c] * x[c];
    y[r] = s;
  }
}
inline void mat6T_vec(const double* A, const double* x, double* y) {
  for (int r = 0; r < 6; ++r) {
    double s = 0;
    for (int c = 0; c < 6; ++c) s += A[6 * c + r] * x[c];
    y[r] = s;
  }
}
inline void mat6_mat6(const double* A, const double* B, double* C) {
  for (int r = 0; r < 6; ++r)
    for (int c = 0; c < 6; ++c) {
      double s = 0;
      for (int k = 0; k < 6; ++k) s += A[6 * r + k] * B[6 * k + c];
      C[6 * r + c] = s;
    }
}
inline void mat6T_mat6(const double* A, const double* B, double* C) {
  for (int r = 0; r < 6; ++r)
    for (int c = 0; c < 6; ++c) {
      double s = 0;
      for (int k = 0; k < 6; ++k) s += A[6 * k + r] * B[6 * k + c];
      C[6 * r + c] = s;
    }
}

// crm(v): motion cross operator (ref: RBDReference.py:13-34)
inline void crm(const double* v, double* M) {
  std::memset(M, 0, 36 * sizeof(double));
  M[0 * 6 + 1] = -v[2]; M[0 * 6 + 2] = v[1];
  M[1 * 6 + 0] = v[2];  M[1 * 6 + 2] = -v[0];
  M[2 * 6 + 0] = -v[1]; M[2 * 6 + 1] = v[0];
  M[3 * 6 + 4] = -v[2]; M[3 * 6 + 5] = v[1];
  M[4 * 6 + 3] = v[2];  M[4 * 6 + 5] = -v[0];
  M[5 * 6 + 3] = -v[1]; M[5 * 6 + 4] = v[0];
  M[3 * 6 + 1] = -v[5]; M[3 * 6 + 2] = v[4];
  M[4 * 6 + 0] = v[5];  M[4 * 6 + 2] = -v[3];
  M[5 * 6 + 0] = -v[4]; M[5 * 6 + 1] = v[3];
}
// crm(a) @ b
inline void crm_vec(const double* a, const double* b, double* y) {
  y[0] = -a[2] * b[1] + a[1] * b[2];
  y[1] = a[2] * b[0] - a[0] * b[2];
  y[2] = -a[1] * b[0] + a[0] * b[1];
  y[3] = -a[2] * b[4] + a[1] * b[5] - a[5] * b[1] + a[4] * b[2];
  y[4] = a[2] * b[3] - a[0] * b[5] + a[5] * b[0] - a[3] * b[2];
  y[5] = -a[1] * b[3] + a[0] * b[4] - a[4] * b[0] + a[3] * b[1];
}
// crf(a) @ b = -crm(a)^T b
inline void crf_vec(const double* a, const double* b, double* y) {
  y[0] = -a[2] * b[1] + a[1] * b[2] - a[5] * b[4] + a[4] * b[5];
  y[1] = a[2] * b[0] - a[0] * b[2] + a[5] * b[3] - a[3] * b[5];
  y[2] = -a[1] * b[0] + a[0] * b[1] - a[4] * b[3] + a[3] * b[4];
  y[3] = -a[2] * b[4] + a[1] * b[5];
  y[4] = a[2] * b[3] - a[0] * b[5];
  y[5] = -a[1] * b[3] + a[0] * b[4];
}
// icrf(v) as matrix: icrf(b) @ a == crf(a) @ b (ref: RBDReference.py:42-54)
inline void icrf(const double* v, double* M) {
  std::memset(M, 0, 36 * sizeof(double));
  M[0 * 6 + 1] = v[2];  M[0 * 6 + 2] = -v[1];
  M[1 * 6 + 0] = -v[2]; M[1 * 6 + 2] = v[0];
  M[2 * 6 + 0] = v[1];  M[2 * 6 + 1] = -v[0];
  M[0 * 6 + 4] = v[5];  M[0 * 6 + 5] = -v[4];
  M[1 * 6 + 3] = -v[5]; M[1 * 6 + 5] = v[3];
  M[2 * 6 + 3] = v[4];  M[2 * 6 + 4] = -v[3];
  M[3 * 6 + 1] = v[5];  M[3 * 6 + 2] = -v[4];
  M[4 * 6 + 0] = -v[5]; M[4 * 6 + 2] = v[3];
  M[5 * 6 + 0] = v[4];  M[5 * 6 + 1] = -v[3];
}

inline void skew(const double* a, double* K) {
  K[0] = 0;      K[1] = -a[2]; K[2] = a[1];
  K[3] = a[2];   K[4] = 0;     K[5] = -a[0];
  K[6] = -a[1];  K[7] = a[0];  K[8] = 0;
}

// E_free = I - sin(t) [a]x + (1-cos(t)) [a]x^2 (ops/spatial.py:93-102)
inline void free_rotation(const double* axis, double t, double* E) {
  double A[9], A2[9];
  skew(axis, A);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += A[3 * r + k] * A[3 * k + c];
      A2[3 * r + c] = s;
    }
  double st = std::sin(t), ct = 1.0 - std::cos(t);
  for (int i = 0; i < 9; ++i) E[i] = -st * A[i] + ct * A2[i];
  E[0] += 1; E[4] += 1; E[8] += 1;
}

// X_j(q_j) = X_free(q_j) @ X_fixed (ops/spatial.py:105-122)
inline void joint_X(const RobotConst& R, int j, double q, double* X) {
  double Xfree[36];
  std::memset(Xfree, 0, sizeof(Xfree));
  if (R.jtype[j] == REVOLUTE) {
    double E[9];
    free_rotation(R.axis + 3 * j, q, E);
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        Xfree[6 * r + c] = E[3 * r + c];
        Xfree[6 * (r + 3) + (c + 3)] = E[3 * r + c];
      }
  } else {
    double K[9], at[3] = {R.axis[3 * j] * q, R.axis[3 * j + 1] * q,
                          R.axis[3 * j + 2] * q};
    skew(at, K);
    for (int r = 0; r < 3; ++r) {
      Xfree[6 * r + r] = 1;
      Xfree[6 * (r + 3) + (r + 3)] = 1;
      for (int c = 0; c < 3; ++c) Xfree[6 * (r + 3) + c] = -K[3 * r + c];
    }
  }
  mat6_mat6(Xfree, R.X_fixed + 36 * j, X);
}

// ------------------------------------------------------------------- RNEA
// (ref: RBDReference.py:399-559; ops/rbd.py rnea)
inline void rnea(const RobotConst& R, const double* q, const double* qd,
                 const double* qdd, double gravity, double* c,
                 double* v_out = nullptr, double* f_out = nullptr,
                 double* X_out = nullptr) {
  const int n = R.n;
  double X[TMR_MAX_N * 36], v[TMR_MAX_N * 6], a[TMR_MAX_N * 6], f[TMR_MAX_N * 6];
  double g[6] = {0, 0, 0, 0, 0, -gravity};
  for (int i = 0; i < n; ++i) {
    joint_X(R, i, q[i], X + 36 * i);
    const double* Si = R.S + 6 * i;
    double* vi = v + 6 * i;
    double* ai = a + 6 * i;
    int p = R.parent[i];
    if (p < 0) {
      for (int k = 0; k < 6; ++k) vi[k] = Si[k] * qd[i];
      mat6_vec(X + 36 * i, g, ai);
    } else {
      mat6_vec(X + 36 * i, v + 6 * p, vi);
      for (int k = 0; k < 6; ++k) vi[k] += Si[k] * qd[i];
      mat6_vec(X + 36 * i, a + 6 * p, ai);
    }
    double tmp[6];
    crm_vec(vi, Si, tmp);                 // mxS(S, v) * qd
    for (int k = 0; k < 6; ++k) ai[k] += qd[i] * tmp[k];
    if (qdd) for (int k = 0; k < 6; ++k) ai[k] += Si[k] * qdd[i];
    double Iv[6], Ia[6], fx[6];
    mat6_vec(R.I + 36 * i, vi, Iv);
    mat6_vec(R.I + 36 * i, ai, Ia);
    crf_vec(vi, Iv, fx);                  // vxIv
    for (int k = 0; k < 6; ++k) f[6 * i + k] = Ia[k] + fx[k];
  }
  for (int i = n - 1; i >= 0; --i) {
    const double* Si = R.S + 6 * i;
    double s = 0;
    for (int k = 0; k < 6; ++k) s += Si[k] * f[6 * i + k];
    c[i] = s;
    int p = R.parent[i];
    if (p >= 0) {
      double tmp[6];
      mat6T_vec(X + 36 * i, f + 6 * i, tmp);
      for (int k = 0; k < 6; ++k) f[6 * p + k] += tmp[k];
    }
  }
  if (v_out) std::memcpy(v_out, v, 6 * n * sizeof(double));
  if (f_out) std::memcpy(f_out, f, 6 * n * sizeof(double));
  if (X_out) std::memcpy(X_out, X, 36 * n * sizeof(double));
}

// ------------------------------------------------------------------- CRBA
// (ref: RBDReference_generalized.py:1000-1032)
inline void crba(const RobotConst& R, const double* q, double* H) {
  const int n = R.n;
  double X[TMR_MAX_N * 36], IC[TMR_MAX_N * 36];
  for (int i = 0; i < n; ++i) {
    joint_X(R, i, q[i], X + 36 * i);
    std::memcpy(IC + 36 * i, R.I + 36 * i, 36 * sizeof(double));
  }
  double tmp[36], tmp2[36];
  for (int i = n - 1; i >= 0; --i) {
    int p = R.parent[i];
    if (p >= 0) {
      mat6T_mat6(X + 36 * i, IC + 36 * i, tmp);    // X^T IC
      mat6_mat6(tmp, X + 36 * i, tmp2);            // X^T IC X
      for (int k = 0; k < 36; ++k) IC[36 * p + k] += tmp2[k];
    }
  }
  std::memset(H, 0, n * n * sizeof(double));
  for (int i = 0; i < n; ++i) {
    double fh[6], fh2[6];
    mat6_vec(IC + 36 * i, R.S + 6 * i, fh);
    double s = 0;
    for (int k = 0; k < 6; ++k) s += R.S[6 * i + k] * fh[k];
    H[n * i + i] = s;
    int j = i;
    while (R.parent[j] >= 0) {
      mat6T_vec(X + 36 * j, fh, fh2);
      std::memcpy(fh, fh2, 6 * sizeof(double));
      j = R.parent[j];
      double hij = 0;
      for (int k = 0; k < 6; ++k) hij += R.S[6 * j + k] * fh[k];
      H[n * i + j] = hij;
      H[n * j + i] = hij;
    }
  }
}

// Cholesky solve of H x = b (H SPD, n <= 32)
inline void chol_solve(int n, const double* Hin, const double* b, double* x) {
  double L[TMR_MAX_N * TMR_MAX_N];
  std::memcpy(L, Hin, n * n * sizeof(double));
  for (int j = 0; j < n; ++j) {
    for (int k = 0; k < j; ++k)
      for (int i = j; i < n; ++i) L[n * i + j] -= L[n * i + k] * L[n * j + k];
    double d = std::sqrt(L[n * j + j]);
    for (int i = j; i < n; ++i) L[n * i + j] /= d;
  }
  double y[TMR_MAX_N];
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L[n * i + k] * y[k];
    y[i] = s / L[n * i + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = y[i];
    for (int k = i + 1; k < n; ++k) s -= L[n * k + i] * x[k];
    x[i] = s / L[n * i + i];
  }
}

// minv via CRBA + Cholesky (the analytic-Minv oracle cross-check lives in
// the Python tests; ref: RBDReference.py:805-930)
inline void minv(const RobotConst& R, const double* q, double* Mi) {
  const int n = R.n;
  double H[TMR_MAX_N * TMR_MAX_N], e[TMR_MAX_N], col[TMR_MAX_N];
  crba(R, q, H);
  for (int j = 0; j < n; ++j) {
    std::memset(e, 0, n * sizeof(double));
    e[j] = 1.0;
    chol_solve(n, H, e, col);
    for (int i = 0; i < n; ++i) Mi[n * i + j] = col[i];
  }
}

// -------------------------------------------------------- forward dynamics
inline void fd(const RobotConst& R, const double* q, const double* qd,
               const double* u, double gravity, double* qdd) {
  const int n = R.n;
  double c[TMR_MAX_N], H[TMR_MAX_N * TMR_MAX_N], rhs[TMR_MAX_N];
  rnea(R, q, qd, nullptr, gravity, c);
  crba(R, q, H);
  for (int i = 0; i < n; ++i) rhs[i] = u[i] - c[i];
  chol_solve(n, H, rhs, qdd);
}

// ---------------------------------------------- analytic RNEA gradient
// 4-pass d tau / d[q, qd], shape (n, 2n) row-major
// (ref: RBDReference.py:561-802; ops/rbd.py rnea_grad)
inline void rnea_grad(const RobotConst& R, const double* q, const double* qd,
                      const double* qdd, double gravity, double* dtau) {
  const int n = R.n;
  double X[TMR_MAX_N * 36], v[TMR_MAX_N * 6], f[TMR_MAX_N * 6], c[TMR_MAX_N];
  rnea(R, q, qd, qdd, gravity, c, v, f, X);
  double g[6] = {0, 0, 0, 0, 0, -gravity};
  // a per-link (recompute forward pass accelerations)
  double a[TMR_MAX_N * 6];
  for (int i = 0; i < n; ++i) {
    const double* Si = R.S + 6 * i;
    double* ai = a + 6 * i;
    int p = R.parent[i];
    if (p < 0) mat6_vec(X + 36 * i, g, ai);
    else mat6_vec(X + 36 * i, a + 6 * p, ai);
    double tmp[6];
    crm_vec(v + 6 * i, Si, tmp);
    for (int k = 0; k < 6; ++k) ai[k] += qd[i] * tmp[k];
    if (qdd) for (int k = 0; k < 6; ++k) ai[k] += Si[k] * qdd[i];
  }
  // forward passes: dv/dq, da/dq, df/dq and dv/dqd, da/dqd, df/dqd
  // each (6, n) per link, stored dense
  static thread_local double dvq[TMR_MAX_N * 6 * TMR_MAX_N], daq[TMR_MAX_N * 6 * TMR_MAX_N],
      dfq[TMR_MAX_N * 6 * TMR_MAX_N], dvd[TMR_MAX_N * 6 * TMR_MAX_N], dad[TMR_MAX_N * 6 * TMR_MAX_N], dfd[TMR_MAX_N * 6 * TMR_MAX_N];
  auto col = [n](double* base, int link, int r, int cidx) -> double& {
    return base[(link * 6 + r) * n + cidx];
  };
  for (int i = 0; i < n; ++i) {
    const double* Si = R.S + 6 * i;
    const double* Xi = X + 36 * i;
    const double* Ii = R.I + 36 * i;
    int p = R.parent[i];
    double crmS[36];
    crm(Si, crmS);
    // zero this link's blocks
    for (int r = 0; r < 6; ++r)
      for (int cx = 0; cx < n; ++cx) {
        col(dvq, i, r, cx) = 0; col(daq, i, r, cx) = 0;
        col(dvd, i, r, cx) = 0; col(dad, i, r, cx) = 0;
      }
    if (p < 0) {
      double Xg[6], m[6];
      mat6_vec(Xi, g, Xg);
      crm_vec(Xg, Si, m);     // mxS(S, X g) = crm(Xg) S ... sign check below
      // mxS(S, vec) = crm(vec) @ S
      for (int r = 0; r < 6; ++r) col(daq, i, r, i) += m[r];
    } else {
      // dv = X dv_p ; da = X da_p, plus the i-th column terms
      for (int r = 0; r < 6; ++r)
        for (int cx = 0; cx < n; ++cx) {
          double sv = 0, sa = 0, svd = 0, sad = 0;
          for (int k = 0; k < 6; ++k) {
            sv += Xi[6 * r + k] * col(dvq, p, k, cx);
            sa += Xi[6 * r + k] * col(daq, p, k, cx);
            svd += Xi[6 * r + k] * col(dvd, p, k, cx);
            sad += Xi[6 * r + k] * col(dad, p, k, cx);
          }
          col(dvq, i, r, cx) = sv; col(daq, i, r, cx) = sa;
          col(dvd, i, r, cx) = svd; col(dad, i, r, cx) = sad;
        }
      double Xv[6], Xa[6], m1[6], m2[6];
      mat6_vec(Xi, v + 6 * p, Xv);
      mat6_vec(Xi, a + 6 * p, Xa);
      crm_vec(Xv, Si, m1);
      crm_vec(Xa, Si, m2);
      for (int r = 0; r < 6; ++r) {
        col(dvq, i, r, i) += m1[r];
        col(daq, i, r, i) += m2[r];
      }
    }
    // da -= qd_i * crm(S) @ dv ; dad -= qd_i * crm(S) @ dvd
    for (int r = 0; r < 6; ++r)
      for (int cx = 0; cx < n; ++cx) {
        double s1 = 0, s2 = 0;
        for (int k = 0; k < 6; ++k) {
          s1 += crmS[6 * r + k] * col(dvq, i, k, cx);
          s2 += crmS[6 * r + k] * col(dvd, i, k, cx);
        }
        col(daq, i, r, cx) -= qd[i] * s1;
        col(dad, i, r, cx) -= qd[i] * s2;
      }
    // dvd i-th column += S ; dad i-th column += mxS(S, v_i)
    double mv[6];
    crm_vec(v + 6 * i, Si, mv);
    for (int r = 0; r < 6; ++r) {
      col(dvd, i, r, i) += Si[r];
      col(dad, i, r, i) += mv[r];
    }
    // df = I da + icrf(I v) dv + crf(v) (I dv)
    double Iv[6], icrfIv[36], crmv[36];
    mat6_vec(Ii, v + 6 * i, Iv);
    icrf(Iv, icrfIv);
    crm(v + 6 * i, crmv);  // crf(v) = -crm(v)^T
    for (int r = 0; r < 6; ++r)
      for (int cx = 0; cx < n; ++cx) {
        double s1 = 0, s2 = 0;
        for (int k = 0; k < 6; ++k) {
          double dvk = col(dvq, i, k, cx);
          double dvdk = col(dvd, i, k, cx);
          s1 += Ii[6 * r + k] * col(daq, i, k, cx) + icrfIv[6 * r + k] * dvk;
          s2 += Ii[6 * r + k] * col(dad, i, k, cx) + icrfIv[6 * r + k] * dvdk;
        }
        // crf(v) @ (I dv) term
        double Idv[6], Idvd[6];
        for (int k = 0; k < 6; ++k) {
          double t1 = 0, t2 = 0;
          for (int m = 0; m < 6; ++m) {
            t1 += Ii[6 * k + m] * col(dvq, i, m, cx);
            t2 += Ii[6 * k + m] * col(dvd, i, m, cx);
          }
          Idv[k] = t1; Idvd[k] = t2;
        }
        double cf1 = 0, cf2 = 0;
        for (int k = 0; k < 6; ++k) {
          cf1 += -crmv[6 * k + r] * Idv[k];   // crf(v)=-crm(v)^T
          cf2 += -crmv[6 * k + r] * Idvd[k];
        }
        col(dfq, i, r, cx) = s1 + cf1;
        col(dfd, i, r, cx) = s2 + cf2;
      }
  }
  // backward passes
  for (int i = n - 1; i >= 0; --i) {
    const double* Si = R.S + 6 * i;
    const double* Xi = X + 36 * i;
    for (int cx = 0; cx < n; ++cx) {
      double s1 = 0, s2 = 0;
      for (int k = 0; k < 6; ++k) {
        s1 += Si[k] * col(dfq, i, k, cx);
        s2 += Si[k] * col(dfd, i, k, cx);
      }
      dtau[2 * n * i + cx] = s1;
      dtau[2 * n * i + n + cx] = s2;
    }
    int p = R.parent[i];
    if (p >= 0) {
      // df_p += X^T df_i (+ i-th column X^T fxS(S, f_acc_i))
      double fx[6], Xtfx[6];
      // fxS(S, f) = crf(S) f; the reference's -crm(f) S shortcut is
      // revolute-only (see ops/spatial.py fxS docstring)
      crf_vec(Si, f + 6 * i, fx);
      mat6T_vec(Xi, fx, Xtfx);
      for (int r = 0; r < 6; ++r)
        for (int cx = 0; cx < n; ++cx) {
          double s1 = 0, s2 = 0;
          for (int k = 0; k < 6; ++k) {
            s1 += Xi[6 * k + r] * col(dfq, i, k, cx);
            s2 += Xi[6 * k + r] * col(dfd, i, k, cx);
          }
          col(dfq, p, r, cx) += s1;
          col(dfd, p, r, cx) += s2;
        }
      for (int r = 0; r < 6; ++r) col(dfq, p, r, i) += Xtfx[r];
    }
  }
  // damping contribution on the qd block
  for (int i = 0; i < n; ++i) dtau[2 * n * i + n + i] += R.damping[i];
}

// dqdd/d[q,qd,u] = [-Minv dc_dq, -Minv dc_dqd, Minv], (n, 3n) row-major
// (ref: TrajoptPlant.py:301-323)
inline void fd_grad(const RobotConst& R, const double* q, const double* qd,
                    const double* u, double gravity, double* out) {
  const int n = R.n;
  double c[TMR_MAX_N], H[TMR_MAX_N * TMR_MAX_N], rhs[TMR_MAX_N], qdd[TMR_MAX_N], Mi[TMR_MAX_N * TMR_MAX_N], dtau[TMR_MAX_N * 64];
  rnea(R, q, qd, nullptr, gravity, c);
  crba(R, q, H);
  for (int i = 0; i < n; ++i) rhs[i] = u[i] - c[i];
  chol_solve(n, H, rhs, qdd);
  minv(R, q, Mi);
  rnea_grad(R, q, qd, qdd, gravity, dtau);
  for (int r = 0; r < n; ++r)
    for (int cx = 0; cx < 2 * n; ++cx) {
      double s = 0;
      for (int k = 0; k < n; ++k) s += Mi[n * r + k] * dtau[2 * n * k + cx];
      out[3 * n * r + cx] = -s;
    }
  for (int r = 0; r < n; ++r)
    for (int cx = 0; cx < n; ++cx) out[3 * n * r + 2 * n + cx] = Mi[n * r + cx];
}

// -------------------------------------------------------------------- ABA
// Featherstone articulated-body forward dynamics, 3 passes
// (ref: RBDReference_generalized.py:913-998; ops/rbd.py aba)
inline void aba(const RobotConst& R, const double* q, const double* qd,
                const double* tau, double gravity, double* qdd) {
  const int n = R.n;
  double X[TMR_MAX_N * 36], v[TMR_MAX_N * 6], cvel[TMR_MAX_N * 6];
  double IA[TMR_MAX_N * 36], pA[TMR_MAX_N * 6], U[TMR_MAX_N * 6];
  double dd[TMR_MAX_N], uu[TMR_MAX_N];
  double g[6] = {0, 0, 0, 0, 0, -gravity};
  for (int i = 0; i < n; ++i) {
    joint_X(R, i, q[i], X + 36 * i);
    const double* Si = R.S + 6 * i;
    int p = R.parent[i];
    double* vi = v + 6 * i;
    double* ci = cvel + 6 * i;
    if (p < 0) {
      for (int k = 0; k < 6; ++k) { vi[k] = Si[k] * qd[i]; ci[k] = 0; }
    } else {
      mat6_vec(X + 36 * i, v + 6 * p, vi);
      for (int k = 0; k < 6; ++k) vi[k] += Si[k] * qd[i];
      double tmp[6];
      crm_vec(vi, Si, tmp);               // mxS(S, v) * qd
      for (int k = 0; k < 6; ++k) ci[k] = qd[i] * tmp[k];
    }
    std::memcpy(IA + 36 * i, R.I + 36 * i, 36 * sizeof(double));
    double Iv[6];
    mat6_vec(R.I + 36 * i, vi, Iv);
    crf_vec(vi, Iv, pA + 6 * i);          // vxIv
  }
  for (int i = n - 1; i >= 0; --i) {
    const double* Si = R.S + 6 * i;
    int p = R.parent[i];
    mat6_vec(IA + 36 * i, Si, U + 6 * i);
    double d = 0, s = 0;
    for (int k = 0; k < 6; ++k) {
      d += Si[k] * U[6 * i + k];
      s += Si[k] * pA[6 * i + k];
    }
    dd[i] = d;
    uu[i] = tau[i] - s;
    if (p >= 0) {
      double Ia[36];
      for (int r = 0; r < 6; ++r)
        for (int c2 = 0; c2 < 6; ++c2)
          Ia[6 * r + c2] = IA[36 * i + 6 * r + c2]
                           - U[6 * i + r] * U[6 * i + c2] / d;
      double Iac[6], pa[6];
      mat6_vec(Ia, cvel + 6 * i, Iac);
      for (int k = 0; k < 6; ++k)
        pa[k] = pA[6 * i + k] + Iac[k] + U[6 * i + k] * (uu[i] / d);
      double tmp[36], tmp2[36];
      mat6T_mat6(X + 36 * i, Ia, tmp);
      mat6_mat6(tmp, X + 36 * i, tmp2);
      for (int k = 0; k < 36; ++k) IA[36 * p + k] += tmp2[k];
      double Xtpa[6];
      mat6T_vec(X + 36 * i, pa, Xtpa);
      for (int k = 0; k < 6; ++k) pA[6 * p + k] += Xtpa[k];
    }
  }
  double a[TMR_MAX_N * 6];
  for (int i = 0; i < n; ++i) {
    const double* Si = R.S + 6 * i;
    int p = R.parent[i];
    double* ai = a + 6 * i;
    if (p < 0) mat6_vec(X + 36 * i, g, ai);
    else mat6_vec(X + 36 * i, a + 6 * p, ai);
    for (int k = 0; k < 6; ++k) ai[k] += cvel[6 * i + k];
    double s = 0;
    for (int k = 0; k < 6; ++k) s += U[6 * i + k] * ai[k];
    qdd[i] = (uu[i] - s) / dd[i];
    for (int k = 0; k < 6; ++k) ai[k] += qdd[i] * Si[k];
  }
}

// ------------------------------------------------------------------ IDSVA
// spatial_inv: X = [[E,0],[B,E]] rotation-block transform =>
// X^-1 = [[E^T,0],[-E^T B E^T, E^T]] (ops/spatial.py:68-81)
inline void spatial_inv6(const double* X, double* Xi) {
  double Et[9], B[9], EtB[9], EtBEt[9];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      Et[3 * r + c] = X[6 * c + r];
      B[3 * r + c] = X[6 * (r + 3) + c];
    }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += Et[3 * r + k] * B[3 * k + c];
      EtB[3 * r + c] = s;
    }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += EtB[3 * r + k] * Et[3 * k + c];
      EtBEt[3 * r + c] = s;
    }
  std::memset(Xi, 0, 36 * sizeof(double));
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      Xi[6 * r + c] = Et[3 * r + c];
      Xi[6 * (r + 3) + (c + 3)] = Et[3 * r + c];
      Xi[6 * (r + 3) + c] = -EtBEt[3 * r + c];
    }
}

// true iff joint i is an ancestor of (or equals) joint k
inline bool in_subtree(const RobotConst& R, int i, int k) {
  for (int j = k; j >= 0; j = R.parent[j])
    if (j == i) return true;
  return false;
}

// Spatial-vector-algebra ID derivatives (Singh/Russel/Wensing):
// dtau_dq, dtau_dqd each (n, n) row-major
// (ref: RBDReference_generalized.py:717-826; ops/rbd.py idsva)
inline void idsva(const RobotConst& R, const double* q, const double* qd,
                  const double* qdd, double gravity,
                  double* dtau_dq, double* dtau_dqd) {
  const int n = R.n;
  double Xup0[TMR_MAX_N * 36], v[TMR_MAX_N * 6], a[TMR_MAX_N * 6];
  double f[TMR_MAX_N * 6], Sw[TMR_MAX_N * 6], Sd[TMR_MAX_N * 6];
  double Sdd[TMR_MAX_N * 6], Sj[TMR_MAX_N * 6];
  static thread_local double IC[TMR_MAX_N * 36], BC[TMR_MAX_N * 36];
  double t1[TMR_MAX_N * 6], t2[TMR_MAX_N * 6], t3[TMR_MAX_N * 6],
      t4[TMR_MAX_N * 6];
  double g[6] = {0, 0, 0, 0, 0, -gravity};
  for (int i = 0; i < n; ++i) {
    int p = R.parent[i];
    double Xi[36];
    joint_X(R, i, q[i], Xi);
    double vi[6], ai[6];
    if (p < 0) {
      std::memcpy(Xup0 + 36 * i, Xi, 36 * sizeof(double));
      std::memset(vi, 0, sizeof(vi));
      mat6_vec(Xi, g, ai);
    } else {
      mat6_mat6(Xi, Xup0 + 36 * p, Xup0 + 36 * i);
      std::memcpy(vi, v + 6 * p, sizeof(vi));
      std::memcpy(ai, a + 6 * p, sizeof(ai));
    }
    double Xdown[36];
    spatial_inv6(Xup0 + 36 * i, Xdown);
    double* Swi = Sw + 6 * i;
    mat6_vec(Xdown, R.S + 6 * i, Swi);            // world-frame S
    crm_vec(vi, Swi, Sd + 6 * i);                 // crm(v) S
    double cv_sd[6];
    crm_vec(ai, Swi, Sdd + 6 * i);                // crm(a) S
    crm_vec(vi, Sd + 6 * i, cv_sd);               // crm(v) Sd
    for (int k = 0; k < 6; ++k) Sdd[6 * i + k] += cv_sd[k];
    double Sqd[6];
    for (int k = 0; k < 6; ++k) Sqd[k] = Swi[k] * qd[i];
    double m[6];
    crm_vec(Sqd, Swi, m);                         // crm(S qd) S
    for (int k = 0; k < 6; ++k) Sj[6 * i + k] = 2.0 * Sd[6 * i + k] + m[k];
    double cv_S[6];
    crm_vec(vi, Swi, cv_S);                       // crm(v_old) S (== Sd)
    for (int k = 0; k < 6; ++k) {
      vi[k] += Swi[k] * qd[i];
      ai[k] += cv_S[k] * qd[i];
      if (qdd) ai[k] += Swi[k] * qdd[i];
    }
    std::memcpy(v + 6 * i, vi, sizeof(vi));
    std::memcpy(a + 6 * i, ai, sizeof(ai));
    // I_i in world frame: Xup0^T I Xup0
    double tmp[36];
    mat6T_mat6(Xup0 + 36 * i, R.I + 36 * i, tmp);
    mat6_mat6(tmp, Xup0 + 36 * i, IC + 36 * i);
    double Iv[6], Ia[6], fx[6];
    mat6_vec(IC + 36 * i, vi, Iv);
    mat6_vec(IC + 36 * i, ai, Ia);
    crf_vec(vi, Iv, fx);
    for (int k = 0; k < 6; ++k) f[6 * i + k] = Ia[k] + fx[k];
    // BC = crf(v) IC + icrf(IC v) - IC crm(v)
    double crmv[36], icrfIv[36];
    crm(vi, crmv);
    icrf(Iv, icrfIv);
    for (int r = 0; r < 6; ++r)
      for (int c2 = 0; c2 < 6; ++c2) {
        double s = icrfIv[6 * r + c2];
        for (int k = 0; k < 6; ++k)
          // crf(v) = -crm(v)^T
          s += -crmv[6 * k + r] * IC[36 * i + 6 * k + c2]
               - IC[36 * i + 6 * r + k] * crmv[6 * k + c2];
        BC[36 * i + 6 * r + c2] = s;
      }
  }
  std::memset(dtau_dq, 0, n * n * sizeof(double));
  std::memset(dtau_dqd, 0, n * n * sizeof(double));
  for (int i = n - 1; i >= 0; --i) {
    mat6_vec(IC + 36 * i, Sw + 6 * i, t1 + 6 * i);
    double ICSj[6], ICSdd[6], icf[36], icfS[6];
    mat6_vec(BC + 36 * i, Sw + 6 * i, t2 + 6 * i);
    mat6_vec(IC + 36 * i, Sj + 6 * i, ICSj);
    for (int k = 0; k < 6; ++k) t2[6 * i + k] += ICSj[k];
    mat6_vec(BC + 36 * i, Sd + 6 * i, t3 + 6 * i);
    mat6_vec(IC + 36 * i, Sdd + 6 * i, ICSdd);
    icrf(f + 6 * i, icf);
    mat6_vec(icf, Sw + 6 * i, icfS);
    for (int k = 0; k < 6; ++k) t3[6 * i + k] += ICSdd[k] + icfS[k];
    mat6T_vec(BC + 36 * i, Sw + 6 * i, t4 + 6 * i);
    for (int k2 = 0; k2 < n; ++k2) {
      if (!in_subtree(R, i, k2)) continue;
      double s11 = 0, s14 = 0, sj1 = 0, sw4 = 0;
      for (int k = 0; k < 6; ++k) {
        s11 += Sdd[6 * i + k] * t1[6 * k2 + k];
        s14 += Sd[6 * i + k] * t4[6 * k2 + k];
        sj1 += Sj[6 * i + k] * t1[6 * k2 + k];
        sw4 += Sw[6 * i + k] * t4[6 * k2 + k];
      }
      dtau_dq[n * k2 + i] = s11 + s14;
      dtau_dqd[n * k2 + i] = sj1 + sw4;
      if (k2 != i) {                               // strict subtree rows
        double s3 = 0, s2 = 0;
        for (int k = 0; k < 6; ++k) {
          s3 += Sw[6 * i + k] * t3[6 * k2 + k];
          s2 += Sw[6 * i + k] * t2[6 * k2 + k];
        }
        dtau_dq[n * i + k2] = s3;
        dtau_dqd[n * i + k2] = s2;
      }
    }
    int p = R.parent[i];
    if (p >= 0) {
      for (int k = 0; k < 36; ++k) {
        IC[36 * p + k] += IC[36 * i + k];
        BC[36 * p + k] += BC[36 * i + k];
      }
      for (int k = 0; k < 6; ++k) f[6 * p + k] += f[6 * i + k];
    }
  }
}

// --------------------------------------------------------- kinematics
// homogeneous transform of joint j (ops/spatial.py:139-161)
inline void joint_H(const RobotConst& R, int j, double q, double* H) {
  double E[9], RE[9];
  std::memset(H, 0, 16 * sizeof(double));
  H[15] = 1.0;
  const double* Ef = R.E_fixed + 9 * j;
  if (R.jtype[j] == REVOLUTE) {
    free_rotation(R.axis + 3 * j, q, E);
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        double s = 0;
        for (int k = 0; k < 3; ++k) s += E[3 * r + k] * Ef[3 * k + c];
        RE[3 * r + c] = s;
      }
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) H[4 * r + c] = RE[3 * c + r];  // transpose
    for (int r = 0; r < 3; ++r) H[4 * r + 3] = R.t_fixed[3 * j + r];
  } else {
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) H[4 * r + c] = Ef[3 * c + r];
    for (int r = 0; r < 3; ++r)
      H[4 * r + 3] = R.axis[3 * j + r] * q + R.t_fixed[3 * j + r];
  }
}

// EE position: chain of homogeneous transforms * offset
// (ref: RBDReference.py:123-148; assumes serial chain to last joint)
inline void ee_pos(const RobotConst& R, const double* q, double* out3) {
  const int n = R.n;
  double acc[16], Hj[16], tmp[16];
  std::memset(acc, 0, sizeof(acc));
  acc[0] = acc[5] = acc[10] = acc[15] = 1.0;
  for (int j = 0; j < n; ++j) {
    joint_H(R, j, q[j], Hj);
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        double s = 0;
        for (int k = 0; k < 4; ++k) s += acc[4 * r + k] * Hj[4 * k + c];
        tmp[4 * r + c] = s;
      }
    std::memcpy(acc, tmp, sizeof(acc));
  }
  for (int r = 0; r < 3; ++r) {
    double s = 0;
    for (int k = 0; k < 4; ++k) s += acc[4 * r + k] * R.ee_offset[k];
    out3[r] = s;
  }
}

// EE Jacobian (kdim x n) by central differences of ee_pos (oracle use only)
inline void ee_jacobian(const RobotConst& R, const double* q, int kdim,
                        double* J) {
  const int n = R.n;
  double qp[TMR_MAX_N], pp[3], pm[3];
  const double h = 1e-7;
  for (int j = 0; j < n; ++j) {
    std::memcpy(qp, q, n * sizeof(double));
    qp[j] = q[j] + h;
    ee_pos(R, qp, pp);
    qp[j] = q[j] - h;
    ee_pos(R, qp, pm);
    for (int r = 0; r < kdim; ++r) J[n * r + j] = (pp[r] - pm[r]) / (2 * h);
  }
}

}  // namespace tmr
