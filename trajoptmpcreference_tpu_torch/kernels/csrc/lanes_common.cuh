// Shared code for the lanes kernels K1 (fd_grad.cu), K2 (fd.cu) and K3
// (task_vec.cu) and for kernels/needed_ops.cpp: the packed robot buffer's
// layout and reader, sin / cos for both types, and the switch over the
// joint count.  K1 and K2 run a group of threads per lane (fd_group.cuh):
// their operations bound them.  K3 runs one thread per lane with the
// robot's constants in shared memory: latency bounds it, and a group
// issued more instructions a lane than it saved (task_vec.cu says why).
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
};

}  // namespace tmr

// Launch / host-loop boilerplate shared by the lanes kernels and
// needed_ops.cpp.  n is a template parameter instantiated for 1..7 joints.
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
