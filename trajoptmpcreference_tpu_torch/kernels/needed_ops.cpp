// The operations that the kernels' functions need: per lane for the lanes
// kernels, per call for the fused PCG.
//
// A kernel's bound (chip_smoke.py) is the larger of the bytes its function
// must move over the card's memory rate and the operations its function
// must do over the card's peak rate.  Those operations are counted here,
// not in the kernels' own code, which may do work twice (a group's threads
// each computing a shared value) or in a dearer form (a dense 6x6
// transform).  Each function — K1 fd_grad, K2 fd, K3 task_vec — is
// written once more as one thread per lane that computes every value once:
//
// * a joint transform as (E, r), X = [[E, 0], [-E rx, E]]; an articulated
//   inertia as a packed symmetric 21, transformed block by block
//   (rotate, then translate);
// * a value two passes share is computed once (the bias RNEA's v, I v,
//   crf(v) I v and crm(v) S serve the gradient's RNEA and dRNEA);
// * no operation on a structural zero: the columns of F, Minv and the
//   dRNEA derivatives that the tree's structure makes zero are skipped, a
//   sum starts at its first term, and identities (crm(S) S = 0, the root's
//   v_0 parallel to S, gravity along z) are used.
//
// The robot's constants (S, I6, the fixed transforms) are data, as the
// packed buffer (ops/lanes.pack_robot) holds them: a count specialised to
// one robot's sparsity would be lower.  A multiply-add counts as two;
// sin and cos one each.
//
// K4, the fused PCG, is written once more as one scenario's loop (pcg_run
// below): a product with a symmetric block takes its full rows, bs
// multiply-adds a row (its packed storage is indexing, not counted); the
// first and last block rows skip the off-diagonal block they lack; the
// iterate starts at zero.  Its iterations end where the data ends them, so
// its count is for the operands given.
//
// kernels/opcount.py compiles this file over its counting scalar (the
// counts) and over double (the values: tests/test_torch_kernel_sources.py
// holds them against the plain versions in f64, so the counted code does
// compute each function).  The entries share the kernels' signatures.
#include <vector>

#include "csrc/lanes_common.cuh"

namespace tmr_need {

using tmr::HEADER;
using tmr::JOINT_STRIDE;
using tmr::Robot;
using tmr::tcos;
using tmr::tsin;

template <typename T>
struct Xr {
  T E[9], r[3];  // X = [[E, 0], [-E rx, E]]
};

template <typename T>
const T* joint(const Robot<T>& R, int j) {
  return R.c + HEADER + j * JOINT_STRIDE;
}

template <typename T>
T dot(const T* a, const T* b, int k) {
  T s = a[0] * b[0];
  for (int m = 1; m < k; ++m) s = s + a[m] * b[m];
  return s;
}

template <typename T>
void cross(const T* a, const T* b, T* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// a = b where a is a structural zero, else a += b
template <typename T>
void acc6(T* a, const T* b, bool& nz) {
  if (nz) {
    for (int m = 0; m < 6; ++m) a[m] = a[m] + b[m];
  } else {
    for (int m = 0; m < 6; ++m) a[m] = b[m];
  }
  nz = true;
}

// X v for a motion vector: [E w; E (l - r x w)]
template <typename T>
void xmot(const Xr<T>& X, const T* v, T* o) {
  T rw[3];
  cross(X.r, v, rw);
  const T l[3] = {v[3] - rw[0], v[4] - rw[1], v[5] - rw[2]};
  for (int k = 0; k < 3; ++k) {
    o[k] = dot(X.E + 3 * k, v, 3);
    o[3 + k] = dot(X.E + 3 * k, l, 3);
  }
}

// X^T f for a force vector: [E^T n + r x E^T f_l; E^T f_l]
template <typename T>
void xfrc(const Xr<T>& X, const T* f, T* o) {
  T e[3], re[3];
  for (int m = 0; m < 3; ++m) {
    e[m] = X.E[m] * f[3] + X.E[3 + m] * f[4] + X.E[6 + m] * f[5];
    o[m] = X.E[m] * f[0] + X.E[3 + m] * f[1] + X.E[6 + m] * f[2];
  }
  cross(X.r, e, re);
  for (int m = 0; m < 3; ++m) {
    o[m] = o[m] + re[m];
    o[3 + m] = e[m];
  }
}

// crm(a) b = [a_w x b_w; a_w x b_l + a_l x b_w]
template <typename T>
void crm(const T* a, const T* b, T* o) {
  T s[3], u[3];
  cross(a, b, o);
  cross(a, b + 3, s);
  cross(a + 3, b, u);
  for (int m = 0; m < 3; ++m) o[3 + m] = s[m] + u[m];
}

// crf(a) b = [a_w x b_w + a_l x b_l; a_w x b_l]
template <typename T>
void crf(const T* a, const T* b, T* o) {
  T s[3], u[3];
  cross(a, b, s);
  cross(a + 3, b + 3, u);
  for (int m = 0; m < 3; ++m) o[m] = s[m] + u[m];
  cross(a, b + 3, o + 3);
}

// the robot's dense spatial inertia of link j times v
template <typename T>
void i6v(const Robot<T>& R, int j, const T* v, T* o) {
  for (int k = 0; k < 6; ++k) o[k] = dot(joint(R, j) + tmr::O_I6 + 6 * k, v, 6);
}

inline int sym(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// packed symmetric 6x6 times v
template <typename T>
void symv(const T* P, const T* v, T* o) {
  for (int k = 0; k < 6; ++k) {
    T s = P[sym(k, 0)] * v[0];
    for (int m = 1; m < 6; ++m) s = s + P[sym(k, m)] * v[m];
    o[k] = s;
  }
}

template <typename T>
void joint_x(const Robot<T>& R, int j, T th, Xr<T>& X) {
  const T* J = joint(R, j);
  if (R.revolute(j)) {
    // E = (I - sin A + (1 - cos) A^2) E_fixed, A = skew(axis) (zero
    // diagonal); r = t_fixed
    const T st = tsin(th), ct = T(1) - tcos(th);
    T e[9];
    for (int k = 0; k < 3; ++k)
      for (int m = 0; m < 3; ++m)
        e[k * 3 + m] = k == m ? T(1) + ct * J[tmr::O_A2 + k * 3 + m]
                              : ct * J[tmr::O_A2 + k * 3 + m] -
                                    st * J[tmr::O_AX + k * 3 + m];
    for (int k = 0; k < 3; ++k)
      for (int m = 0; m < 3; ++m)
        X.E[k * 3 + m] = e[k * 3] * J[tmr::O_EF + m] +
                         e[k * 3 + 1] * J[tmr::O_EF + 3 + m] +
                         e[k * 3 + 2] * J[tmr::O_EF + 6 + m];
    for (int k = 0; k < 3; ++k) X.r[k] = J[tmr::O_TF + k];
  } else {
    // E = E_fixed, r = t_fixed + th E_fixed^T axis
    for (int k = 0; k < 9; ++k) X.E[k] = J[tmr::O_EF + k];
    for (int k = 0; k < 3; ++k)
      X.r[k] = J[tmr::O_TF + k] + th * J[tmr::O_EFAX + k];
  }
}

// P_p += X^T P X for a packed symmetric P = [[A, L^T], [L, C]]: rotate
// each block (M -> E^T M E), then translate by r: with K = L - C rx, the
// result is [[A + rx L - K^T rx, K^T], [K, C]]
template <typename T>
void add_xtpx(const Xr<T>& X, const T* P, T* Pp) {
  T A[9], L[9], C[9];  // full 3x3 blocks; L = B^T (the packed lower-left)
  for (int k = 0; k < 3; ++k)
    for (int m = 0; m < 3; ++m) {
      A[k * 3 + m] = P[sym(k, m)];
      L[k * 3 + m] = P[sym(3 + k, m)];
      C[k * 3 + m] = P[sym(3 + k, 3 + m)];
    }
  const T* E = X.E;
  // rotate: M' = E^T M E (only the lower triangle of the symmetric ones)
  T Ar[9], Lr[9], Cr[9], t[9];
  auto rotate = [&](const T* M, T* o, bool symmetric) {
    for (int k = 0; k < 3; ++k)
      for (int m = 0; m < 3; ++m)
        t[k * 3 + m] = E[k] * M[m] + E[3 + k] * M[3 + m] + E[6 + k] * M[6 + m];
    for (int k = 0; k < 3; ++k)
      for (int m = 0; m < 3; ++m) {
        if (symmetric && m > k) continue;
        o[k * 3 + m] = t[k * 3] * E[m] + t[k * 3 + 1] * E[3 + m] +
                       t[k * 3 + 2] * E[6 + m];
      }
    if (symmetric)
      for (int k = 0; k < 3; ++k)
        for (int m = k + 1; m < 3; ++m) o[k * 3 + m] = o[m * 3 + k];
  };
  rotate(A, Ar, true);
  rotate(L, Lr, false);
  rotate(C, Cr, true);
  // rx = [[0, -r2, r1], [r2, 0, -r0], [-r1, r0, 0]]
  const T* r = X.r;
  // (M rx)[k][m] and (rx M)[k][m], two terms each
  auto m_rx = [&](const T* M, int k, int m) {
    switch (m) {
      case 0: return M[k * 3 + 1] * r[2] - M[k * 3 + 2] * r[1];
      case 1: return M[k * 3 + 2] * r[0] - M[k * 3] * r[2];
      default: return M[k * 3] * r[1] - M[k * 3 + 1] * r[0];
    }
  };
  auto rx_m = [&](const T* M, int k, int m) {
    switch (k) {
      case 0: return r[1] * M[6 + m] - r[2] * M[3 + m];
      case 1: return r[2] * M[m] - r[0] * M[6 + m];
      default: return r[0] * M[3 + m] - r[1] * M[m];
    }
  };
  // bottom-left K = L' - C' rx; top-left A' + rx L' - K^T rx
  T K[9], KT[9];
  for (int k = 0; k < 3; ++k)
    for (int m = 0; m < 3; ++m) K[k * 3 + m] = Lr[k * 3 + m] - m_rx(Cr, k, m);
  for (int k = 0; k < 3; ++k)
    for (int m = 0; m < 3; ++m) KT[k * 3 + m] = K[m * 3 + k];
  for (int k = 0; k < 3; ++k)
    for (int m = 0; m <= k; ++m) {
      Pp[sym(k, m)] = Pp[sym(k, m)] +
                      (Ar[k * 3 + m] + rx_m(Lr, k, m) - m_rx(KT, k, m));
      Pp[sym(3 + k, 3 + m)] = Pp[sym(3 + k, 3 + m)] + Cr[k * 3 + m];
    }
  for (int k = 0; k < 3; ++k)
    for (int m = 0; m < 3; ++m)
      Pp[sym(3 + k, m)] = Pp[sym(3 + k, m)] + K[k * 3 + m];
}

// one lane's joint transforms, bias RNEA, Minv and qdd (K2), with what
// the gradient reuses
template <typename T, int N>
struct Lane {
  int par[N];
  unsigned anc[N];  // ancestors and self, as bits
  bool kids[N];
  Xr<T> X[N];
  T v[N][6], xvp[N][6], Iv[N][6], fv[N][6], crmvS[N][6], xg[N][6];
  T f[N][6], c[N], M[N][N], qdd[N], Dinv[N], U[N][6];
  bool crm_nz[N], Mnz[N][N];

  bool in_subtree(int c, int i) const { return (anc[c] >> i) & 1u; }

  // m = Minv[j][k], from the upper triangle; false (m untouched) where it
  // is a structural zero
  bool minv_at(int j, int k, T& m) const {
    const int a = j <= k ? j : k, b = j <= k ? k : j;
    if (!Mnz[a][b]) return false;
    m = M[a][b];
    return true;
  }

  void fd(const Robot<T>& R, const T* q, const T* qd, const T* u) {
    for (int i = 0; i < N; ++i) {
      par[i] = R.parent(i);
      anc[i] = (par[i] >= 0 ? anc[par[i]] : 0u) | (1u << i);
      kids[i] = false;
      if (par[i] >= 0) kids[par[i]] = true;
      joint_x(R, i, q[i], X[i]);
    }
    rnea_bias(R, qd);
    minv(R);
    T tau[N];
    for (int k = 0; k < N; ++k) tau[k] = u[k] - c[k];
    for (int j = 0; j < N; ++j) {
      T s(0), m;
      bool nz = false;
      for (int k = 0; k < N; ++k) {
        if (!minv_at(j, k, m)) continue;
        s = nz ? s + m * tau[k] : m * tau[k];
        nz = true;
      }
      qdd[j] = s;
    }
  }

  void rnea_bias(const Robot<T>& R, const T* qd) {
    T a[N][6];
    for (int i = 0; i < N; ++i) {
      const T* S = joint(R, i) + tmr::O_S;
      const int p = par[i];
      if (p < 0) {
        // v_0 = S qd_0, so crm(v_0) S = 0; a_0 = X g, g = (0, 0, 0, 0, 0,
        // -gravity)
        for (int m = 0; m < 6; ++m) v[i][m] = S[m] * qd[i];
        const T gz = -R.hdr(0);
        for (int m = 0; m < 3; ++m) {
          xg[i][m] = T(0);
          xg[i][3 + m] = X[i].E[3 * m + 2] * gz;
        }
        for (int m = 0; m < 6; ++m) a[i][m] = xg[i][m];
        crm_nz[i] = false;
      } else {
        xmot(X[i], v[p], xvp[i]);
        for (int m = 0; m < 6; ++m) v[i][m] = xvp[i][m] + S[m] * qd[i];
        xmot(X[i], a[p], a[i]);
        crm(v[i], S, crmvS[i]);
        for (int m = 0; m < 6; ++m) a[i][m] = a[i][m] + qd[i] * crmvS[i][m];
        crm_nz[i] = true;
      }
      T Ia[6];
      i6v(R, i, v[i], Iv[i]);
      crf(v[i], Iv[i], fv[i]);
      i6v(R, i, a[i], Ia);
      for (int m = 0; m < 6; ++m) f[i][m] = Ia[m] + fv[i][m];
    }
    for (int i = N - 1; i >= 0; --i) {
      c[i] = dot(joint(R, i) + tmr::O_S, f[i], 6);
      if (par[i] >= 0) {
        T o[6];
        xfrc(X[i], f[i], o);
        for (int m = 0; m < 6; ++m) f[par[i]][m] = f[par[i]][m] + o[m];
      }
    }
  }

  // analytic Minv (RBDReference), upper triangle M[i][c], c >= i
  void minv(const Robot<T>& R) {
    T IA[N][21], F[N][N][6], Fw[N][N][6];
    bool Fnz[N][N];
    for (int i = 0; i < N; ++i) {
      for (int a = 0; a < 6; ++a)
        for (int b = 0; b <= a; ++b)
          IA[i][sym(a, b)] = joint(R, i)[tmr::O_I6 + a * 6 + b];
      for (int k = 0; k < N; ++k) Fnz[i][k] = Mnz[i][k] = false;
    }
    for (int i = N - 1; i >= 0; --i) {
      const T* S = joint(R, i) + tmr::O_S;
      const int p = par[i];
      symv(IA[i], S, U[i]);
      Dinv[i] = T(1) / dot(S, U[i], 6);
      // column i of F_i is zero: M[i][i] = Dinv; the other columns of the
      // subtree carry what the children sent
      M[i][i] = Dinv[i];
      Mnz[i][i] = true;
      for (int c = i + 1; c < N; ++c) {
        if (!in_subtree(c, i) || !Fnz[i][c]) continue;
        M[i][c] = -(Dinv[i] * dot(S, F[i][c], 6));
        Mnz[i][c] = true;
      }
      if (p < 0) continue;
      for (int c = i; c < N; ++c) {
        if (!in_subtree(c, i) || !Mnz[i][c]) continue;
        T t[6], o[6];
        for (int m = 0; m < 6; ++m) t[m] = U[i][m] * M[i][c];
        acc6(F[i][c], t, Fnz[i][c]);
        xfrc(X[i], F[i][c], o);
        acc6(F[p][c], o, Fnz[p][c]);
      }
      T dU[6], Ia[21];
      for (int m = 0; m < 6; ++m) dU[m] = Dinv[i] * U[i][m];
      for (int a = 0; a < 6; ++a)
        for (int b = 0; b <= a; ++b)
          Ia[sym(a, b)] = IA[i][sym(a, b)] - U[i][a] * dU[b];
      add_xtpx(X[i], Ia, IA[p]);
    }
    for (int i = 0; i < N; ++i) {
      const T* S = joint(R, i) + tmr::O_S;
      const int p = par[i];
      if (p >= 0) {
        T ux[6];
        xfrc(X[i], U[i], ux);
        for (int c = i; c < N; ++c) {
          const T d = Dinv[i] * dot(ux, Fw[p][c], 6);
          M[i][c] = Mnz[i][c] ? M[i][c] - d : -d;
          Mnz[i][c] = true;
        }
      }
      if (!kids[i]) continue;  // only a child (> i) reads F_i's columns > i
      for (int c = i + 1; c < N; ++c) {
        if (p >= 0) {
          T t[6];
          xmot(X[i], Fw[p][c], t);
          for (int m = 0; m < 6; ++m) Fw[i][c][m] = S[m] * M[i][c] + t[m];
        } else if (Mnz[i][c]) {
          for (int m = 0; m < 6; ++m) Fw[i][c][m] = S[m] * M[i][c];
        } else {
          for (int m = 0; m < 6; ++m) Fw[i][c][m] = T(0);  // another tree
        }
      }
    }
  }
};

template <typename T, int N>
void fd_lane(const Robot<T>& R, const T* q, const T* qd, const T* u, T* out,
             int L, int lane) {
  Lane<T, N> s;
  s.fd(R, q, qd, u);
  for (int j = 0; j < N; ++j) out[j * L + lane] = s.qdd[j];
}

// K1: dqdd/d[q, qd, u] = [-Minv dtau/dq, -Minv dtau/dqd, Minv]
template <typename T, int N>
void fd_grad_lane(const Robot<T>& R, const T* q, const T* qd, const T* u,
                  T* out, int L, int lane) {
  Lane<T, N> s;
  s.fd(R, q, qd, u);
  // the RNEA at qdd: a' = X a'_p + qd crm(v) S + S qdd, f' = I a' + crf(v) I v
  T a[N][6], xap[N][6], f[N][6];
  for (int i = 0; i < N; ++i) {
    const T* S = joint(R, i) + tmr::O_S;
    const int p = s.par[i];
    if (p < 0) {
      for (int m = 0; m < 6; ++m) xap[i][m] = s.xg[i][m];
      for (int m = 0; m < 6; ++m) a[i][m] = s.xg[i][m] + S[m] * s.qdd[i];
    } else {
      xmot(s.X[i], a[p], xap[i]);
      for (int m = 0; m < 6; ++m)
        a[i][m] = xap[i][m] + qd[i] * s.crmvS[i][m] + S[m] * s.qdd[i];
    }
    T Ia[6];
    i6v(R, i, a[i], Ia);
    for (int m = 0; m < 6; ++m) f[i][m] = Ia[m] + s.fv[i][m];
  }
  for (int i = N - 1; i >= 0; --i) {
    const int p = s.par[i];
    if (p < 0) continue;
    T o[6];
    xfrc(s.X[i], f[i], o);
    for (int m = 0; m < 6; ++m) f[p][m] = f[p][m] + o[m];
  }
  // dRNEA forward: columns c of the ancestors and self are the nonzero ones
  T dv[2][N][N][6], da[2][N][N][6], df[2][N][N][6];
  bool vnz[2][N][N], anz[2][N][N], fnz[2][N][N];
  for (int w = 0; w < 2; ++w)
    for (int i = 0; i < N; ++i)
      for (int c = 0; c < N; ++c) vnz[w][i][c] = anz[w][i][c] = fnz[w][i][c] = false;
  for (int i = 0; i < N; ++i) {
    const T* S = joint(R, i) + tmr::O_S;
    const int p = s.par[i];
    for (int w = 0; w < 2; ++w) {  // w = 0: by q, 1: by qd
      if (p >= 0)
        for (int c = 0; c < N; ++c) {
          if (vnz[w][p][c]) {
            xmot(s.X[i], dv[w][p][c], dv[w][i][c]);
            vnz[w][i][c] = true;
          }
          if (anz[w][p][c]) {
            xmot(s.X[i], da[w][p][c], da[w][i][c]);
            anz[w][i][c] = true;
          }
        }
    }
    // by q, column i: dv = crm(X v_p) S, da = crm(X a'_p) S
    if (p >= 0) {
      crm(s.xvp[i], S, dv[0][i][i]);
      vnz[0][i][i] = true;
    }
    crm(xap[i], S, da[0][i][i]);
    anz[0][i][i] = true;
    // by qd, column i: dv = S, da = crm(v) S (zero at the root)
    for (int m = 0; m < 6; ++m) dv[1][i][i][m] = S[m];
    vnz[1][i][i] = true;
    if (s.crm_nz[i]) {
      for (int m = 0; m < 6; ++m) da[1][i][i][m] = s.crmvS[i][m];
      anz[1][i][i] = true;
    }
    // da -= qd_i crm(S) dv (crm(S) S = 0 in column i by qd)
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < N; ++c) {
        if (!vnz[w][i][c] || (w == 1 && c == i)) continue;
        T t[6];
        crm(S, dv[w][i][c], t);
        for (int m = 0; m < 6; ++m) t[m] = qd[i] * t[m];
        if (anz[w][i][c]) {
          for (int m = 0; m < 6; ++m) da[w][i][c][m] = da[w][i][c][m] - t[m];
        } else {
          for (int m = 0; m < 6; ++m) da[w][i][c][m] = -t[m];
          anz[w][i][c] = true;
        }
      }
    // df = I da + crf(dv) I v + crf(v) I dv
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < N; ++c) {
        bool nz = false;
        T t[6], Id[6];
        if (anz[w][i][c]) {
          i6v(R, i, da[w][i][c], t);
          acc6(df[w][i][c], t, nz);
        }
        if (vnz[w][i][c]) {
          crf(dv[w][i][c], s.Iv[i], t);
          acc6(df[w][i][c], t, nz);
          i6v(R, i, dv[w][i][c], Id);
          crf(s.v[i], Id, t);
          acc6(df[w][i][c], t, nz);
        }
        fnz[w][i][c] = nz;
      }
  }
  // backward: D = S^T df, df_p += X^T df (+ X^T crf(S) f' in column i by q)
  T D[N][2 * N];
  bool Dnz[N][2 * N];
  for (int i = N - 1; i >= 0; --i) {
    const T* S = joint(R, i) + tmr::O_S;
    const int p = s.par[i];
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < N; ++c) {
        Dnz[i][w * N + c] = fnz[w][i][c];
        if (fnz[w][i][c]) D[i][w * N + c] = dot(S, df[w][i][c], 6);
      }
    if (p < 0) continue;
    T fxS[6], tf[6];
    crf(S, f[i], fxS);
    xfrc(s.X[i], fxS, tf);
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < N; ++c) {
        if (!fnz[w][i][c]) continue;
        T o[6];
        xfrc(s.X[i], df[w][i][c], o);
        if (w == 0 && c == i)
          for (int m = 0; m < 6; ++m) o[m] = o[m] + tf[m];
        acc6(df[w][p][c], o, fnz[w][p][c]);
      }
  }
  for (int i = 0; i < N; ++i)
    D[i][N + i] = D[i][N + i] + joint(R, i)[tmr::O_DAMP];
  for (int r = 0; r < N; ++r) {
    for (int col = 0; col < 2 * N; ++col) {
      T acc(0), m;
      bool nz = false;
      for (int j = 0; j < N; ++j) {
        if (!Dnz[j][col] || !s.minv_at(r, j, m)) continue;
        acc = nz ? acc + m * D[j][col] : m * D[j][col];
        nz = true;
      }
      out[(r * 3 * N + col) * L + lane] = -acc;
    }
    for (int col = 0; col < N; ++col) {
      T m(0);
      s.minv_at(r, col, m);
      out[(r * 3 * N + 2 * N + col) * L + lane] = m;
    }
  }
}

// K3: [ee_pos_k; J qd], k = min(3, n): the chain's frames as (rotation,
// origin), the world axes, the Jacobian rows the output keeps
template <typename T, int N>
void task_vec_lane(const Robot<T>& R, const T* q, const T* qd, T* out, int L,
                   int lane) {
  constexpr int K = N < 3 ? N : 3;
  T Rw[9], pw[3], w[N][3], o[N][3];
  bool first = true, chain[N];
  for (int j = 0; j < N; ++j) {
    const T* J = joint(R, j);
    chain[j] = J[tmr::O_CHAIN] != T(0);
    if (!chain[j]) continue;
    // world axis: the rotation so far times E_fixed^T axis
    for (int r = 0; r < 3; ++r)
      w[j][r] = first ? J[tmr::O_EFAX + r] : dot(Rw + 3 * r, J + tmr::O_EFAX, 3);
    T Rj[9], tj[3];
    if (R.revolute(j)) {
      const T st = tsin(q[j]), ct = T(1) - tcos(q[j]);
      T e[9];
      for (int k = 0; k < 3; ++k)
        for (int m = 0; m < 3; ++m)
          e[k * 3 + m] = k == m ? T(1) + ct * J[tmr::O_A2 + k * 3 + m]
                                : ct * J[tmr::O_A2 + k * 3 + m] -
                                      st * J[tmr::O_AX + k * 3 + m];
      // rotation (E E_fixed)^T
      for (int k = 0; k < 3; ++k)
        for (int m = 0; m < 3; ++m)
          Rj[m * 3 + k] = e[k * 3] * J[tmr::O_EF + m] +
                          e[k * 3 + 1] * J[tmr::O_EF + 3 + m] +
                          e[k * 3 + 2] * J[tmr::O_EF + 6 + m];
      for (int k = 0; k < 3; ++k) tj[k] = J[tmr::O_TF + k];
    } else {
      for (int k = 0; k < 3; ++k)
        for (int m = 0; m < 3; ++m) Rj[k * 3 + m] = J[tmr::O_EF + m * 3 + k];
      for (int k = 0; k < 3; ++k)
        tj[k] = J[tmr::O_AXIS + k] * q[j] + J[tmr::O_TF + k];
    }
    if (first) {
      for (int k = 0; k < 9; ++k) Rw[k] = Rj[k];
      for (int k = 0; k < 3; ++k) pw[k] = tj[k];
    } else {
      T Rn[9], col[3];
      for (int k = 0; k < 3; ++k) pw[k] = pw[k] + dot(Rw + 3 * k, tj, 3);
      for (int k = 0; k < 3; ++k)
        for (int m = 0; m < 3; ++m) {
          for (int l = 0; l < 3; ++l) col[l] = Rj[l * 3 + m];
          Rn[k * 3 + m] = dot(Rw + 3 * k, col, 3);
        }
      for (int k = 0; k < 9; ++k) Rw[k] = Rn[k];
    }
    for (int k = 0; k < 3; ++k) o[j][k] = pw[k];
    first = false;
  }
  T p[3], off[3] = {R.hdr(1), R.hdr(2), R.hdr(3)};
  for (int r = 0; r < 3; ++r)
    p[r] = first ? off[r] : dot(Rw + 3 * r, off, 3) + pw[r];
  T vel[K];
  bool vnz = false;
  for (int j = 0; j < N; ++j) {
    if (!chain[j]) continue;
    T Jr[3];
    if (R.revolute(j)) {
      const T d[3] = {p[0] - o[j][0], p[1] - o[j][1], p[2] - o[j][2]};
      for (int r = 0; r < K; ++r) {
        const int r1 = (r + 1) % 3, r2 = (r + 2) % 3;
        Jr[r] = w[j][r1] * d[r2] - w[j][r2] * d[r1];
      }
    } else {
      for (int r = 0; r < K; ++r) Jr[r] = w[j][r];
    }
    for (int r = 0; r < K; ++r) vel[r] = vnz ? vel[r] + Jr[r] * qd[j] : Jr[r] * qd[j];
    vnz = true;
  }
  for (int r = 0; r < K; ++r) {
    out[r * L + lane] = p[r];
    out[(K + r) * L + lane] = vnz ? vel[r] : T(0);
  }
}

// K4: one scenario's PCG on S dx = r0 from dx = 0 (ops/fused_pcg.py
// pcg_fused_plain), each value once
template <typename T>
struct PcgSys {
  const T *D, *U, *P;  // packed diagonal blocks, upper blocks, packed Pinv
  int N, bs;

  T sym_at(const T* B, int k, int i, int j) const {
    const int m = i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
    return B[k * (bs * (bs + 1) / 2) + m];
  }
  // row (k, i) of the block-diagonal B (D or Pinv) times v
  T diag_row(const T* B, const T* v, int k, int i) const {
    T acc = sym_at(B, k, i, 0) * v[k * bs];
    for (int j = 1; j < bs; ++j) acc = acc + sym_at(B, k, i, j) * v[k * bs + j];
    return acc;
  }
  // row (k, i) of U_k v_{k+1} + U_{k-1}^T v_{k-1}; false where block row k
  // has neither (N = 1)
  bool off_row(const T* v, int k, int i, T& out) const {
    const int bb = bs * bs;
    bool nz = false;
    if (k + 1 < N) {
      const T* u = U + k * bb + i * bs;
      out = u[0] * v[(k + 1) * bs];
      for (int j = 1; j < bs; ++j) out = out + u[j] * v[(k + 1) * bs + j];
      nz = true;
    }
    if (k > 0) {
      const T* u = U + (k - 1) * bb + i;
      T c = u[0] * v[(k - 1) * bs];
      for (int j = 1; j < bs; ++j) c = c + u[j * bs] * v[(k - 1) * bs + j];
      out = nz ? out + c : c;
      nz = true;
    }
    return nz;
  }
  void matvec(const T* v, T* y) const {
    for (int k = 0; k < N; ++k)
      for (int i = 0; i < bs; ++i) {
        const T a = diag_row(D, v, k, i);
        T off;
        y[k * bs + i] = off_row(v, k, i, off) ? a + off : a;
      }
  }
  // s = Pinv r: Pinv r, less for SS Pinv (U s_{k+1} + U^T s_{k-1})
  void apply_P(const T* r, T* s, T* t, bool ss) const {
    const int n = N * bs;
    for (int g = 0; g < n; ++g) s[g] = diag_row(P, r, g / bs, g % bs);
    if (!ss || N == 1) return;
    for (int g = 0; g < n; ++g) off_row(s, g / bs, g % bs, t[g]);
    for (int g = 0; g < n; ++g) t[n + g] = diag_row(P, t, g / bs, g % bs);
    for (int g = 0; g < n; ++g) s[g] = s[g] - t[n + g];
  }
};

template <typename T>
T pcg_dot(const T* a, const T* b, int n) {
  T acc = a[0] * b[0];
  for (int g = 1; g < n; ++g) acc = acc + a[g] * b[g];
  return acc;
}

template <typename T>
T pcg_abs(T v) { return v < T(0) ? -v : v; }

// one scenario; returns its iteration count and leaves its dx in x
template <typename T>
int pcg_run(const PcgSys<T>& S, const T* r0, T* x, bool ss, bool relative,
            int max_iter, T tol) {
  const int n = S.N * S.bs;
  std::vector<T> r(r0, r0 + n), s(n), p(n), ap(n), t(2 * n);
  for (int g = 0; g < n; ++g) x[g] = T(0);
  S.apply_P(r.data(), s.data(), t.data(), ss);
  T nu = pcg_dot(r.data(), s.data(), n);
  T thr = tol;
  if (relative) {
    thr = tol * pcg_abs(nu);
    if (thr < T(1e-30)) thr = T(1e-30);
  }
  if (pcg_abs(nu) <= thr) return 0;
  p = s;
  int it = 0;
  while (it < max_iter) {
    S.matvec(p.data(), ap.data());
    const T pAp = pcg_dot(p.data(), ap.data(), n);
    const T alpha = nu / (pAp != T(0) ? pAp : T(1));
    for (int g = 0; g < n; ++g) {
      x[g] = it == 0 ? alpha * p[g] : x[g] + alpha * p[g];
      r[g] = r[g] - alpha * ap[g];
    }
    S.apply_P(r.data(), s.data(), t.data(), ss);
    const T nu_new = pcg_dot(r.data(), s.data(), n);
    ++it;
    if (pcg_abs(nu_new) <= thr) break;
    const T beta = nu_new / nu;
    for (int g = 0; g < n; ++g) p[g] = s[g] + beta * p[g];
    nu = nu_new;
  }
  return it;
}

// K4 over B scenarios, with the fused PCG's operands (ops/fused_pcg.py)
template <typename T>
int pcg(const T* diag_p, const T* upper, const T* pdiag_p, const T* r0, T* dx,
        int* iters, int B, int N, int bs, int ss, int relative, int max_iter,
        double tol) {
  const size_t n = (size_t)N * bs, nD = (size_t)N * (bs * (bs + 1) / 2);
  for (size_t b = 0; b < (size_t)B; ++b) {
    const PcgSys<T> S{diag_p + b * nD, upper + b * n * bs, pdiag_p + b * nD,
                      N, bs};
    iters[b] = pcg_run(S, r0 + b * n, dx + b * n, ss != 0, relative != 0,
                       max_iter, T(tol));
  }
  return 0;
}

enum Which { FD = 0, FD_GRAD = 1, TASK_VEC = 2 };

template <typename T, int N>
void lanes(int which, const T* Q, const T* QD, const T* U, const T* C, T* out,
           int L) {
  const Robot<T> R{C};
  for (int lane = 0; lane < L; ++lane) {
    T q[N], qd[N], u[N];
    for (int j = 0; j < N; ++j) {
      q[j] = Q[j * L + lane];
      qd[j] = QD[j * L + lane];
      u[j] = U ? U[j * L + lane] : T(0);
    }
    if (which == FD) fd_lane<T, N>(R, q, qd, u, out, L, lane);
    if (which == FD_GRAD) fd_grad_lane<T, N>(R, q, qd, u, out, L, lane);
    if (which == TASK_VEC) task_vec_lane<T, N>(R, q, qd, out, L, lane);
  }
}

template <typename T>
int run(int which, const void* q, const void* qd, const void* u,
        const void* c, void* out, int n, int L) {
#define TMR_CALL(NN)                                                 \
  lanes<T, NN>(which, (const T*)q, (const T*)qd, (const T*)u,        \
               (const T*)c, (T*)out, L)
  TMR_SWITCH_N(n, TMR_CALL)
#undef TMR_CALL
  return 0;
}

}  // namespace tmr_need

// the values in f64, with the lanes kernels' signature
#define TMR_NEED_ENTRY(NAME, WHICH)                                          \
  extern "C" int NAME(const void* q, const void* qd, const void* u,          \
                      const void* c, void* out, int n, int L, void*) {       \
    return tmr_need::run<double>(WHICH, q, qd, u, c, out, n, L);             \
  }
TMR_NEED_ENTRY(need_fd_f64, tmr_need::FD)
TMR_NEED_ENTRY(need_fd_grad_f64, tmr_need::FD_GRAD)
TMR_NEED_ENTRY(need_task_vec_f64, tmr_need::TASK_VEC)
#undef TMR_NEED_ENTRY

// K4's values in f64, with the fused PCG's signature; the blocks in the
// operands' own storage only (codes 0: the exit on nu)
extern "C" int need_pcg_f64(const void* diag_p, const void* upper,
                            const void* pdiag_p, const void* r0, void* dx,
                            void* iters, void*, int B, int N, int bs,
                            int dcode, int pcode, int ss, int relative,
                            int max_iter, double tol, void*) {
  if (dcode != 0 || pcode != 0) return -1;
  return tmr_need::pcg<double>((const double*)diag_p, (const double*)upper,
                               (const double*)pdiag_p, (const double*)r0,
                               (double*)dx, (int*)iters, B, N, bs, ss,
                               relative, max_iter, tol);
}

#ifdef TMR_NEED_COUNT
// the operations over L lanes of one function (0 fd, 1 fd_grad, 2 task_vec)
extern "C" long long need_count(int which, const double* q, const double* qd,
                                const double* u, const double* c, int nc,
                                int n, int L, int out_rows) {
  std::vector<Num> Q = nums(q, (size_t)n * L), QD = nums(qd, (size_t)n * L),
                   U = nums(u, (size_t)n * L), C = nums(c, nc),
                   O((size_t)out_rows * L);
  tmr_count::ops = 0;
  tmr_need::run<Num>(which, Q.data(), QD.data(), U.data(), C.data(),
                     O.data(), n, L);
  return tmr_count::ops;
}

// the operations of K4's function over B scenarios of these operands
extern "C" long long need_pcg_count(const double* d, const double* up,
                                    const double* pd, const double* r0, int B,
                                    int N, int bs, int ss, int relative,
                                    int max_iter, double tol) {
  const size_t nD = (size_t)B * N * bs * (bs + 1) / 2,
               nU = (size_t)B * N * bs * bs, nR = (size_t)B * N * bs;
  std::vector<Num> D = nums(d, nD), UP = nums(up, nU), PD = nums(pd, nD),
                   R0 = nums(r0, nR), DX(nR);
  std::vector<int> it(B);
  tmr_count::ops = 0;
  tmr_need::pcg<Num>(D.data(), UP.data(), PD.data(), R0.data(), DX.data(),
                     it.data(), B, N, bs, ss, relative, max_iter, tol);
  return tmr_count::ops;
}
#endif
