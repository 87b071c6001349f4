// Kernel 1: per-node constraint values g = [tau (7); tool height] and the
// exact Jacobian dg/d[q, qdot, u] (8 x 21) for a flat batch of F evaluations.
//
// Replaces mpc_motion_planner_tpu/ops/pallas/constraints_kernel.py
// fused_node_constraints (lane_constraints :180, bake_model :56). The math is
// that of ops/rnea.py rnea + ops/kinematics.py frame_height: two Newton-Euler
// sweeps over the 7 revolute joints in link coordinates, gravity through the
// base acceleration, and the tool height from the world FK.
//
// Design (see kernels/constraints.py): the value launch runs one thread per
// evaluation in float; the Jacobian launch runs one thread per (evaluation,
// input direction j) in single-tangent dual numbers seeded on input j, and
// writes column j of the evaluation's Jacobian (direction 0 also writes g).
// The forward sweep keeps per joint only sin/cos of q and the body wrench;
// the backward sweep rebuilds the joint rotation from them, which keeps the
// dual-number version inside the register file.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int NJ = 7;
constexpr int NIN = 3 * NJ;  // [q, qdot, u]
constexpr int NG = NJ + 1;

struct Joint {
  float R0[9], t[3], axis[3], K[9], K2[9], mass, mc[3], Io[9];
};
static_assert(sizeof(Joint) == 46 * sizeof(float), "joint block layout");

struct Robot {
  Joint j[NJ];
  float gravity[3];
  float tool_t[3];
  int tool_parent;
};

struct Dual {
  float v, d;
};
__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return {a.v * b.v, a.v * b.d + a.d * b.v}; }
__device__ __forceinline__ Dual operator*(float s, Dual a) { return {s * a.v, s * a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, float s) { return {s * a.v, s * a.d}; }
__device__ __forceinline__ Dual operator+(Dual a, float s) { return {a.v + s, a.d}; }
__device__ __forceinline__ Dual operator+(float s, Dual a) { return {a.v + s, a.d}; }
__device__ __forceinline__ Dual operator-(float s, Dual a) { return {s - a.v, -a.d}; }
__device__ __forceinline__ void sincos_t(Dual x, Dual* s, Dual* c) {
  float sv, cv;
  sincosf(x.v, &sv, &cv);
  *s = {sv, cv * x.d};
  *c = {cv, -sv * x.d};
}
__device__ __forceinline__ void sincos_t(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ float value_of(float x) { return x; }
__device__ __forceinline__ float value_of(Dual x) { return x.v; }
__device__ __forceinline__ float tangent_of(Dual x) { return x.d; }

template <typename T> __device__ __forceinline__ T zero_t() { return T{}; }

// y = M v for a 3x3 matrix of T, row-major
template <typename T, typename M>
__device__ __forceinline__ void mv(const M* m, const T* v, T* y) {
#pragma unroll
  for (int a = 0; a < 3; ++a) y[a] = m[3 * a] * v[0] + m[3 * a + 1] * v[1] + m[3 * a + 2] * v[2];
}
// y = M^T v
template <typename T, typename M>
__device__ __forceinline__ void mtv(const M* m, const T* v, T* y) {
#pragma unroll
  for (int a = 0; a < 3; ++a) y[a] = m[a] * v[0] + m[3 + a] * v[1] + m[6 + a] * v[2];
}
template <typename T, typename A, typename B>
__device__ __forceinline__ void cross(const A* a, const B* b, T* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// R_pi = R0 (I + s K + (1 - c) K2): joint i's rotation in its parent frame.
template <typename T>
__device__ __forceinline__ void joint_rotation(const Joint& J, T s, T c, T* R) {
  T Ra[9];
  T one_c = 1.0f - c;
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    float eye = (e == 0 || e == 4 || e == 8) ? 1.0f : 0.0f;
    Ra[e] = s * J.K[e] + one_c * J.K2[e] + eye;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      R[3 * a + b] = J.R0[3 * a] * Ra[b] + J.R0[3 * a + 1] * Ra[3 + b] + J.R0[3 * a + 2] * Ra[6 + b];
}

// g = [tau; height] for one evaluation with inputs xu = [q, qdot, u].
template <typename T>
__device__ void eval_constraints(const Robot& C, const T* xu, T* g) {
  T vw[3], vv[3], aw[3], av[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    vw[a] = vv[a] = aw[a] = zero_t<T>();
    av[a] = zero_t<T>() + (-C.gravity[a]);
  }
  T sq[NJ], cq[NJ];
  T fbw[NJ][3], fbv[NJ][3];  // body wrench per joint
  // world FK: only the third row of the rotation and z of the origin matter
  T Rw2[3] = {zero_t<T>(), zero_t<T>(), zero_t<T>() + 1.0f};
  T pz = zero_t<T>();
  T height = zero_t<T>();

#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const Joint& J = C.j[i];
    sincos_t(xu[i], &sq[i], &cq[i]);
    T R[9];
    joint_rotation(J, sq[i], cq[i], R);  // E = R^T

    T tmp[3], rxw[3];
    // v' = E v_w, E (v_v - r x v_w)
    cross(J.t, vw, rxw);
#pragma unroll
    for (int a = 0; a < 3; ++a) tmp[a] = vv[a] - rxw[a];
    T vw_j[3], vv_j[3];
    mtv(R, vw, vw_j);
    mtv(R, tmp, vv_j);
    T qd = xu[NJ + i];
    T swqd[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      swqd[a] = J.axis[a] * qd;
      vw[a] = vw_j[a] + swqd[a];
      vv[a] = vv_j[a];
    }
    cross(J.t, aw, rxw);
#pragma unroll
    for (int a = 0; a < 3; ++a) tmp[a] = av[a] - rxw[a];
    T aw_j[3], av_j[3];
    mtv(R, aw, aw_j);
    mtv(R, tmp, av_j);
    T cw[3], cv[3];
    cross(vw, swqd, cw);
    cross(vv, swqd, cv);
    T u = xu[2 * NJ + i];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      aw[a] = aw_j[a] + J.axis[a] * u + cw[a];
      av[a] = av_j[a] + cv[a];
    }

    // body wrench: I a + v x* (I v) with I = (mass, mc, Io)
    T Iw[3], Iv[3], hw[3], hv[3], t1[3], t2[3];
    mv(J.Io, aw, Iw);
    cross(J.mc, av, t1);
    cross(J.mc, aw, t2);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      Iw[a] = Iw[a] + t1[a];
      Iv[a] = av[a] * J.mass - t2[a];
    }
    mv(J.Io, vw, hw);
    cross(J.mc, vv, t1);
    cross(J.mc, vw, t2);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      hw[a] = hw[a] + t1[a];
      hv[a] = vv[a] * J.mass - t2[a];
    }
    T b1[3], b2[3], b3[3];
    cross(vw, hw, b1);
    cross(vv, hv, b2);
    cross(vw, hv, b3);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      fbw[i][a] = Iw[a] + (b1[a] + b2[a]);
      fbv[i][a] = Iv[a] + b3[a];
    }

    // world FK (row 2): pz += Rw2 . t; Rw2 = Rw2 R_pi
    pz = pz + (Rw2[0] * J.t[0] + Rw2[1] * J.t[1] + Rw2[2] * J.t[2]);
    T nr[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) nr[b] = Rw2[0] * R[b] + Rw2[1] * R[3 + b] + Rw2[2] * R[6 + b];
#pragma unroll
    for (int b = 0; b < 3; ++b) Rw2[b] = nr[b];
    if (i == C.tool_parent)
      height = pz + (Rw2[0] * C.tool_t[0] + Rw2[1] * C.tool_t[1] + Rw2[2] * C.tool_t[2]);
  }

  T fw[3], fv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) fw[a] = fv[a] = zero_t<T>();
#pragma unroll
  for (int i = NJ - 1; i >= 0; --i) {
    const Joint& J = C.j[i];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      fw[a] = fw[a] + fbw[i][a];
      fv[a] = fv[a] + fbv[i][a];
    }
    g[i] = J.axis[0] * fw[0] + J.axis[1] * fw[1] + J.axis[2] * fw[2];
    // back to the parent: fv' = R fv, fw' = R fw + t x fv'
    T R[9];
    joint_rotation(J, sq[i], cq[i], R);
    T nfv[3], nfw[3], txf[3];
    mv(R, fv, nfv);
    mv(R, fw, nfw);
    cross(J.t, nfv, txf);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      fv[a] = nfv[a];
      fw[a] = nfw[a] + txf[a];
    }
  }
  g[NJ] = height;
}

__global__ void constraints_value_kernel(Robot C, const float* __restrict__ xu,
                                         float* __restrict__ g, int F) {
  int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  float in[NIN], out[NG];
#pragma unroll
  for (int c = 0; c < NIN; ++c) in[c] = xu[(size_t)f * NIN + c];
  eval_constraints<float>(C, in, out);
#pragma unroll
  for (int r = 0; r < NG; ++r) g[(size_t)f * NG + r] = out[r];
}

__global__ void constraints_jac_kernel(Robot C, const float* __restrict__ xu,
                                       float* __restrict__ g, float* __restrict__ Jac, int F) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)F * NIN) return;
  int f = (int)(t / NIN);
  int j = (int)(t % NIN);
  Dual in[NIN], out[NG];
#pragma unroll
  for (int c = 0; c < NIN; ++c) in[c] = {xu[(size_t)f * NIN + c], c == j ? 1.0f : 0.0f};
  eval_constraints<Dual>(C, in, out);
#pragma unroll
  for (int r = 0; r < NG; ++r) Jac[((size_t)f * NG + r) * NIN + j] = out[r].d;
  if (j == 0) {
#pragma unroll
    for (int r = 0; r < NG; ++r) g[(size_t)f * NG + r] = out[r].v;
  }
}

}  // namespace

// consts: NJ * 46 floats of joint blocks, then gravity (3) and the tool
// translation (3), as kernels/constraints.py bake_model lays them out.
extern "C" int mpc_constraints(const float* consts, int tool_parent, const float* xu,
                               float* g, float* jac, int F, int with_jac, void* stream) {
  Robot C;
  memcpy(&C, consts, sizeof(float) * (NJ * 46 + 6));
  C.tool_parent = tool_parent;
  if (F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  if (with_jac) {
    long long total = (long long)F * NIN;
    int blocks = (int)((total + threads - 1) / threads);
    constraints_jac_kernel<<<blocks, threads, 0, s>>>(C, xu, g, jac, F);
  } else {
    int blocks = (F + threads - 1) / threads;
    constraints_value_kernel<<<blocks, threads, 0, s>>>(C, xu, g, F);
  }
  return (int)cudaGetLastError();
}
