// Kernel 1: per-node constraint values g = [tau (NJ); tool height] and the
// exact Jacobian dg/d[q, qdot, u] ((NJ + 1) x 3 NJ: 8 x 21 for the 7-joint
// Panda) for a flat batch of F evaluations.
//
// Replaces mpc_motion_planner_tpu/ops/pallas/constraints_kernel.py
// fused_node_constraints (lane_constraints :180, bake_model :56). The math is
// that of ops/rnea.py rnea + ops/kinematics.py frame_height: two Newton-Euler
// sweeps over the NJ revolute joints of a serial chain in link coordinates,
// gravity through the base acceleration, and the tool height from the world
// FK. The build sets NJ (-DMPC_NQ, common.cuh; one library per joint count,
// kernels/build.py); the figures below are the Panda's (NJ = 7).
//
// What bounds it on an H100: instructions. An evaluation reads 21 floats and
// writes 8 or 176, while a value pass is ~1.5 kflop in chains of dependent
// 3-vector operations, and a tangent costs twice a value.
//
// What the design does about it:
// * Jacobian launch: one thread per (evaluation, joint j), a block of NJ warps
//   over a tile of 32 evaluations, warp j holding joint j of all 32. The
//   thread carries the value and the three tangents along q_j, qdot_j and
//   u_j (type D3), so an evaluation's value pass runs 7 times, not 21, and
//   writes columns j, 7 + j and 14 + j of the Jacobian. j is uniform in a
//   warp, so the branches on it cost nothing: joints before j run the
//   forward sweep in plain floats (their tangents are zero), joint j alone
//   has a rotation with a tangent, joints after j multiply tangents by float
//   rotations; the backward sweep does the same in reverse. Warp 0's pass is
//   the dearest (tangents from joint 0 on), but four warps that take joints p
//   and 6 - p in turn, for equal work, were 10% slower than these seven.
// * The joint loops are not unrolled: three short bodies (float, D3 x D3, D3
//   x float) stay in the instruction cache, where seven warps on seven paths
//   through 21 unrolled bodies would not. The per-joint quantities the
//   backward sweep needs (sin, cos, the body wrench and its tangents) are
//   then indexed by the loop and live in local memory, interleaved by thread
//   and touched only where a thread's j makes it write them; the robot
//   constants are read there by a joint index through the read-only path.
// * Value launch: one thread per evaluation, 128 per block, the same float
//   joint steps with the joint loops unrolled: the constants are then read
//   at fixed offsets, and the per-joint quantities stay in registers. The
//   pass is ~2.7k instructions per evaluation and bound by instruction
//   throughput, so a thread loads its own 21 inputs and stores its 8
//   outputs as two 16-byte words (where NG is not a multiple of 4, as single
//   floats): staging them through shared memory for coalescing cost 18%
//   more time than it saved.
// * Inputs are read where they lie (q, qdot in X and u in U, by base pointer
//   and batch stride, so views of z need no copy). The Jacobian launch
//   stages them with coalesced loads into shared memory, where the 7 warps
//   of an evaluation share them, and g and J leave through shared-memory
//   tiles (a tile row padded to an odd stride) in 16-byte coalesced stores:
//   a thread's 24 entries of J lie 28 bytes apart. A tile of 32 rows starts
//   16-byte aligned whatever the row length; where a row is no whole number
//   of 16-byte words (6 joints: 126 floats of J, 7 of g) the tile is stored
//   as one flat run of words.
// * The robot lies in device memory (struct Robot: 46 floats per joint and
//   6 more, 1,312 B at NJ = 7, 4,624 B at NJ = 25), baked once per model and
//   device (kernels/constraints.py BAKED), and the launches take a pointer
//   to it: a launch's parameters are 72 B whatever the joint count, where
//   the robot by value filled the 4 KB they may take past 21 joints. The
//   arithmetic is the same, so are g and J, bitwise.
// * The Jacobian launch's tiles grow with NJ^2 (25,984 B at NJ = 7, 48,128 B
//   at 10, 66,816 B at 12) and lie in dynamic shared memory, which a block
//   may take up to 232,448 B of (23 joints); the library's init lets the
//   launch take them. Two blocks an SM (__launch_bounds__(JT, 2)) while two
//   blocks' tiles fit the SM's 228 KB, up to 16 joints; one past that (JB),
//   where a thread may take 64 registers or more.
//   Past 23 joints the J tile does not fit (243,456 B at 24): each thread
//   then writes its three columns of J to device memory itself (JTILE
//   false), 32 evaluations a row apart, which L2 gathers into whole
//   sectors; the inputs and the g tile stay staged. The block is one
//   thread per (evaluation, joint), 32 NJ threads: 32 joints at most.
//   kernels/constraints.py refuses a joint count past that.
// * sincosf stays at full precision: the torques reach ~100 Nm and the
//   comparison with the plain path holds them to 2e-5.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int NJ = mpc::NQ;
constexpr int NQX = 2 * NJ;  // [q, qdot] per evaluation in X
constexpr int NIN = 3 * NJ;  // [q, qdot, u]
constexpr int NG = NJ + 1;
constexpr int JROW = NG * NIN;  // floats of Jacobian per evaluation (168 at NJ = 7)

struct Joint {
  float R0[9], t[3], axis[3], K[9], K2[9], mass, mc[3], Io[9];
};
static_assert(sizeof(Joint) == 46 * sizeof(float), "joint block layout");

// The robot in device memory, as kernels/constraints.py bake_model lays it
// out; the tool's parent joint travels beside the pointer.
struct Robot {
  Joint j[NJ];
  float gravity[3];
  float tool_t[3];
};
static_assert(sizeof(Robot) == (46 * NJ + 6) * sizeof(float), "robot block layout");

// Where the inputs lie: evaluation f = b * nodes + n reads q, qdot at
// x + b * x_stride + n * NQX and u at u + b * u_stride + n * NJ.
struct Inputs {
  const float *x, *u;
  long long x_stride, u_stride;
  int nodes;
};

// A value and its tangents along q_j, qdot_j and u_j.
struct D3 {
  float v, a, b, c;
};
__device__ __forceinline__ D3 operator+(D3 x, D3 y) { return {x.v + y.v, x.a + y.a, x.b + y.b, x.c + y.c}; }
__device__ __forceinline__ D3 operator-(D3 x, D3 y) { return {x.v - y.v, x.a - y.a, x.b - y.b, x.c - y.c}; }
__device__ __forceinline__ D3 operator-(D3 x) { return {-x.v, -x.a, -x.b, -x.c}; }
__device__ __forceinline__ D3 operator*(D3 x, D3 y) {
  return {x.v * y.v, x.v * y.a + x.a * y.v, x.v * y.b + x.b * y.v, x.v * y.c + x.c * y.v};
}
__device__ __forceinline__ D3 operator*(float s, D3 x) { return {s * x.v, s * x.a, s * x.b, s * x.c}; }
__device__ __forceinline__ D3 operator*(D3 x, float s) { return {s * x.v, s * x.a, s * x.b, s * x.c}; }
__device__ __forceinline__ D3 operator+(D3 x, float s) { return {x.v + s, x.a, x.b, x.c}; }
__device__ __forceinline__ D3 operator+(float s, D3 x) { return {x.v + s, x.a, x.b, x.c}; }
__device__ __forceinline__ D3 operator-(float s, D3 x) { return {s - x.v, -x.a, -x.b, -x.c}; }
__device__ __forceinline__ D3 lift(float x) { return {x, 0.f, 0.f, 0.f}; }

// y = M^T v for a row-major 3x3 M
template <typename T, typename M, typename V>
__device__ __forceinline__ void mtv(const M* m, const V* v, T* y) {
#pragma unroll
  for (int a = 0; a < 3; ++a) y[a] = m[a] * v[0] + m[3 + a] * v[1] + m[6 + a] * v[2];
}
// y = M v
template <typename T, typename M, typename V>
__device__ __forceinline__ void mv(const M* m, const V* v, T* y) {
#pragma unroll
  for (int a = 0; a < 3; ++a) y[a] = m[3 * a] * v[0] + m[3 * a + 1] * v[1] + m[3 * a + 2] * v[2];
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

// The link state the forward sweep carries from joint to joint: the spatial
// velocity and acceleration in link coordinates, and row 2 of the world
// rotation with z of the origin (all the tool height needs).
template <typename T>
struct Link {
  T vw[3], vv[3], aw[3], av[3], Rw2[3], pz;
};

__device__ __forceinline__ void base_link(const Robot& C, Link<float>& L) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    L.vw[a] = L.vv[a] = L.aw[a] = 0.f;
    L.av[a] = -C.gravity[a];
    L.Rw2[a] = a == 2 ? 1.f : 0.f;
  }
  L.pz = 0.f;
}

__device__ __forceinline__ void lift_link(const Link<float>& F, Link<D3>& L) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    L.vw[a] = lift(F.vw[a]);
    L.vv[a] = lift(F.vv[a]);
    L.aw[a] = lift(F.aw[a]);
    L.av[a] = lift(F.av[a]);
    L.Rw2[a] = lift(F.Rw2[a]);
  }
  L.pz = lift(F.pz);
}

// One joint of the forward sweep: the link state moves from the parent to
// this joint's link (rotation R of type TR, joint rate and acceleration of
// type TQ), the body wrench fb = I a + v x* (I v) comes out, and the world
// FK advances. Returns the tool height if the tool hangs on this link.
template <typename TS, typename TR, typename TQ>
__device__ __forceinline__ void forward_joint(const Joint& J, const TR* R, TQ qd, TQ u,
                                              Link<TS>& L, TS* fbw, TS* fbv) {
  TS tmp[3], rxw[3], vw_j[3], vv_j[3];
  // v' = E v_w, E (v_v - r x v_w) with E = R^T
  cross(J.t, L.vw, rxw);
#pragma unroll
  for (int a = 0; a < 3; ++a) tmp[a] = L.vv[a] - rxw[a];
  mtv(R, L.vw, vw_j);
  mtv(R, tmp, vv_j);
  TQ swqd[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    swqd[a] = J.axis[a] * qd;
    L.vw[a] = vw_j[a] + swqd[a];
    L.vv[a] = vv_j[a];
  }
  TS aw_j[3], av_j[3], cw[3], cv[3];
  cross(J.t, L.aw, rxw);
#pragma unroll
  for (int a = 0; a < 3; ++a) tmp[a] = L.av[a] - rxw[a];
  mtv(R, L.aw, aw_j);
  mtv(R, tmp, av_j);
  cross(L.vw, swqd, cw);
  cross(L.vv, swqd, cv);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    L.aw[a] = aw_j[a] + J.axis[a] * u + cw[a];
    L.av[a] = av_j[a] + cv[a];
  }

  // body wrench: I a + v x* (I v) with I = (mass, mc, Io)
  TS Iw[3], Iv[3], hw[3], hv[3], t1[3], t2[3];
  mv(J.Io, L.aw, Iw);
  cross(J.mc, L.av, t1);
  cross(J.mc, L.aw, t2);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    Iw[a] = Iw[a] + t1[a];
    Iv[a] = L.av[a] * J.mass - t2[a];
  }
  mv(J.Io, L.vw, hw);
  cross(J.mc, L.vv, t1);
  cross(J.mc, L.vw, t2);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    hw[a] = hw[a] + t1[a];
    hv[a] = L.vv[a] * J.mass - t2[a];
  }
  TS b1[3], b2[3], b3[3];
  cross(L.vw, hw, b1);
  cross(L.vv, hv, b2);
  cross(L.vw, hv, b3);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    fbw[a] = Iw[a] + (b1[a] + b2[a]);
    fbv[a] = Iv[a] + b3[a];
  }

  // world FK (row 2): pz += Rw2 . t; Rw2 = Rw2 R_pi
  L.pz = L.pz + (L.Rw2[0] * J.t[0] + L.Rw2[1] * J.t[1] + L.Rw2[2] * J.t[2]);
  TS nr[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) nr[b] = L.Rw2[0] * R[b] + L.Rw2[1] * R[3 + b] + L.Rw2[2] * R[6 + b];
#pragma unroll
  for (int b = 0; b < 3; ++b) L.Rw2[b] = nr[b];
}

template <typename T>
__device__ __forceinline__ T tool_height(const Robot& C, const Link<T>& L) {
  return L.pz + (L.Rw2[0] * C.tool_t[0] + L.Rw2[1] * C.tool_t[1] + L.Rw2[2] * C.tool_t[2]);
}

// One joint of the backward sweep, after the joint's torque is taken: the
// accumulated wrench goes back to the parent, fv' = R fv, fw' = R fw + t x fv'.
template <typename T, typename TR>
__device__ __forceinline__ void backward_joint(const Joint& J, const TR* R, T* fw, T* fv) {
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

template <typename T>
__device__ __forceinline__ T axis_dot(const Joint& J, const T* fw) {
  return J.axis[0] * fw[0] + J.axis[1] * fw[1] + J.axis[2] * fw[2];
}

// ---- the Jacobian launch's tiles ----

// The inputs of evaluations f0 .. f0 + TILE - 1 into xs[e * NIN + c], zeros
// past F: each evaluation's places in X and U are found once (off: 2 * TILE
// entries of scratch), then two runs of coalesced loads, one over X and one
// over U. A thread sends off all its loads before it stores the first value:
// a store to shared memory between two loads would make the second wait for
// the first (the compiler cannot tell that the two never overlap).
template <int NT, int TILE>
__device__ __forceinline__ void load_inputs(float* xs, long long* off, const Inputs& in, int f0,
                                            int F) {
  static_assert(NT >= TILE, "one thread per evaluation finds its places");
  static_assert(TILE * NJ % NT == 0, "whole rounds of loads");
  constexpr int UR = TILE * NJ / NT, XR = 2 * UR;  // rounds over U and over X
  if (threadIdx.x < TILE) {
    const int f = min(f0 + (int)threadIdx.x, F - 1), b = f / in.nodes, n = f - b * in.nodes;
    off[threadIdx.x] = b * in.x_stride + n * NQX;
    off[TILE + threadIdx.x] = b * in.u_stride + n * NJ;
  }
  __syncthreads();
  float vx[XR], vu[UR];
#pragma unroll
  for (int k = 0; k < XR; ++k) {
    const int idx = threadIdx.x + k * NT, e = idx / NQX, c = idx % NQX;
    vx[k] = f0 + e < F ? __ldg(in.x + off[e] + c) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < UR; ++k) {
    const int idx = threadIdx.x + k * NT, e = idx / NJ, c = idx % NJ;
    vu[k] = f0 + e < F ? __ldg(in.u + off[TILE + e] + c) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < XR; ++k) {
    const int idx = threadIdx.x + k * NT;
    xs[idx / NQX * NIN + idx % NQX] = vx[k];
  }
#pragma unroll
  for (int k = 0; k < UR; ++k) {
    const int idx = threadIdx.x + k * NT;
    xs[idx / NJ * NIN + NQX + idx % NJ] = vu[k];
  }
}

// A tile of n evaluations with ROW floats each, kept at a row stride of
// STRIDE floats, to out[0 .. n * ROW) (16-byte aligned) in 16-byte stores:
// row by row where ROW is a multiple of 4, else as one flat run of words
// (each float found by its row and column) and the last few floats alone.
template <int NT, int ROW, int STRIDE>
__device__ __forceinline__ void store_tile(const float* tile, float* out, int n) {
  float4* out4 = reinterpret_cast<float4*>(out);
  if constexpr (ROW % 4 == 0) {
    for (int q = threadIdx.x; q < n * (ROW / 4); q += NT) {
      const float* src = tile + (q / (ROW / 4)) * STRIDE + (q % (ROW / 4)) * 4;
      out4[q] = make_float4(src[0], src[1], src[2], src[3]);
    }
  } else {
    auto at = [&](int i) { return tile[(i / ROW) * STRIDE + i % ROW]; };
    const int total = n * ROW;
    for (int q = threadIdx.x; q < total / 4; q += NT)
      out4[q] = make_float4(at(4 * q), at(4 * q + 1), at(4 * q + 2), at(4 * q + 3));
    for (int i = total / 4 * 4 + threadIdx.x; i < total; i += NT) out[i] = at(i);
  }
}

// ---- the value launch: one thread per evaluation ----

constexpr int VT = 128;  // threads and evaluations per block

// The joint loops are unrolled here: the body is short in plain floats, the
// robot constants are then read at fixed offsets from the robot's pointer,
// and sin, cos and the body wrench of every joint stay in registers for the
// backward sweep.
__global__ void __launch_bounds__(VT)
constraints_value_kernel(const Robot* __restrict__ robot, int tool_parent, Inputs in,
                         float* __restrict__ g, int F) {
  const Robot& C = *robot;
  const int f = blockIdx.x * VT + threadIdx.x;
  if (f >= F) return;
  const int b = f / in.nodes, n = f - b * in.nodes;
  const float* __restrict__ px = in.x + b * in.x_stride + n * NQX;
  const float* __restrict__ pu = in.u + b * in.u_stride + n * NJ;
  float xu[NIN];
#pragma unroll
  for (int c = 0; c < NQX; ++c) xu[c] = __ldg(px + c);
#pragma unroll
  for (int c = 0; c < NJ; ++c) xu[NQX + c] = __ldg(pu + c);
  Link<float> L;
  base_link(C, L);
  float height = 0.f;
  float sq[NJ], cq[NJ], fbw[NJ][3], fbv[NJ][3];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const Joint& J = C.j[i];
    float R[9];
    sincosf(xu[i], &sq[i], &cq[i]);
    joint_rotation(J, sq[i], cq[i], R);
    forward_joint(J, R, xu[NJ + i], xu[2 * NJ + i], L, fbw[i], fbv[i]);
    if (i == tool_parent) height = tool_height(C, L);
  }
  float fw[3] = {0.f, 0.f, 0.f}, fv[3] = {0.f, 0.f, 0.f};
  float out[NG];
#pragma unroll
  for (int i = NJ - 1; i >= 0; --i) {
    const Joint& J = C.j[i];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      fw[a] += fbw[i][a];
      fv[a] += fbv[i][a];
    }
    out[i] = axis_dot(J, fw);
    float R[9];
    joint_rotation(J, sq[i], cq[i], R);
    backward_joint(J, R, fw, fv);
  }
  out[NJ] = height;
  if constexpr (NG % 4 == 0) {
    float4* g4 = reinterpret_cast<float4*>(g + (size_t)f * NG);
#pragma unroll
    for (int q = 0; q < NG / 4; ++q)
      g4[q] = make_float4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
  } else {
#pragma unroll
    for (int r = 0; r < NG; ++r) g[(size_t)f * NG + r] = out[r];
  }
}

// ---- the Jacobian launch: one thread per (evaluation, joint) ----

constexpr int JE = 32;              // evaluations per block: one per lane
constexpr int JT = JE * NJ;         // 224 threads at NJ = 7: warp j holds joint j
constexpr int JSTRIDE = JROW + 1;   // tile row of J, padded to an odd stride (JROW is even)
constexpr int GSTRIDE = NG | 1;     // and of g
static_assert(JT <= 1024, "a block has at most 1024 threads");
// the tiles in dynamic shared memory: the evaluations' places in X and U
// (off, 2 JE), their inputs (xs), then the J tile where it fits a block
// (up to 23 joints) and the g tile
constexpr int JSMEM_INPUTS = 8 * 2 * JE + 4 * JE * NIN;
constexpr bool JTILE = JSMEM_INPUTS + 4 * JE * JSTRIDE + 4 * JE * GSTRIDE <= 232448;
constexpr int JSMEM = JSMEM_INPUTS + (JTILE ? 4 * JE * JSTRIDE : 0) + 4 * JE * GSTRIDE;
// blocks an SM holds by their tiles (228 KB an SM, 1 KB of it reserved per
// block): the registers are capped for two where two fit and leave a thread
// 64 or more (up to 16 joints; past 23 the tiles are small, the blocks not)
constexpr int JB = 2 * (JSMEM + 1024) <= 233472 && 2 * JT <= 1024 ? 2 : 1;

__global__ void __launch_bounds__(JT, JB)
constraints_jac_kernel(const Robot* __restrict__ robot, int tool_parent, Inputs in,
                       float* __restrict__ g, float* __restrict__ Jac, int F) {
  extern __shared__ float4 jac_smem[];
  const Robot& C = *robot;
  long long* off = reinterpret_cast<long long*>(jac_smem);
  float* xs = reinterpret_cast<float*>(off + 2 * JE);
  float* tj = xs + JE * NIN;
  float* tg = tj + (JTILE ? JE * JSTRIDE : 0);
  const int tid = threadIdx.x, e = tid & 31, j = tid >> 5;
  const int f0 = blockIdx.x * JE;
  load_inputs<JT, JE>(xs, off, in, f0, F);
  __syncthreads();

  const float* xu = xs + e * NIN;
  // what the backward sweep needs of every joint: sin and cos of q, the body
  // wrench, and from joint j on its tangents
  float sq[NJ], cq[NJ], fbf[NJ][6];
  D3 fbd[NJ][6];
  D3 height = lift(0.f);

  // joints before j: no tangent yet
  Link<float> Lf;
  base_link(C, Lf);
#pragma unroll 1
  for (int i = 0; i < j; ++i) {
    const Joint& J = C.j[i];
    float s, c, R[9], fbw[3], fbv[3];
    sincosf(xu[i], &s, &c);
    joint_rotation(J, s, c, R);
    forward_joint(J, R, xu[NJ + i], xu[2 * NJ + i], Lf, fbw, fbv);
    if (i == tool_parent) height = lift(tool_height(C, Lf));
    sq[i] = s;
    cq[i] = c;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      fbf[i][a] = fbw[a];
      fbf[i][3 + a] = fbv[a];
    }
  }
  // joint j: the tangents enter through its rotation, rate and acceleration
  Link<D3> L;
  lift_link(Lf, L);
  {
    const Joint& J = C.j[j];
    float s, c;
    sincosf(xu[j], &s, &c);
    sq[j] = s;
    cq[j] = c;
    const D3 sd = {s, c, 0.f, 0.f}, cd = {c, -s, 0.f, 0.f};
    const D3 qd = {xu[NJ + j], 0.f, 1.f, 0.f}, u = {xu[2 * NJ + j], 0.f, 0.f, 1.f};
    D3 R[9];
    joint_rotation(J, sd, cd, R);
    forward_joint(J, R, qd, u, L, &fbd[j][0], &fbd[j][3]);
    if (j == tool_parent) height = tool_height(C, L);
  }
  // joints after j: tangents through float rotations
#pragma unroll 1
  for (int i = j + 1; i < NJ; ++i) {
    const Joint& J = C.j[i];
    float s, c, R[9];
    sincosf(xu[i], &s, &c);
    joint_rotation(J, s, c, R);
    forward_joint(J, R, xu[NJ + i], xu[2 * NJ + i], L, &fbd[i][0], &fbd[i][3]);
    if (i == tool_parent) height = tool_height(C, L);
    sq[i] = s;
    cq[i] = c;
  }

  // row r of this thread's three Jacobian columns (in the tile, or past 23
  // joints in device memory, none past F), and of g from joint 0's warp
  float* trow = JTILE ? tj + e * JSTRIDE + j : Jac + (size_t)(f0 + e) * JROW + j;
  const bool jlive = JTILE || f0 + e < F;
  float* grow = tg + e * GSTRIDE;
  auto put = [&](int r, D3 val) {
    if (jlive) {
      trow[r * NIN] = val.a;
      trow[r * NIN + NJ] = val.b;
      trow[r * NIN + 2 * NJ] = val.c;
    }
    if (j == 0) grow[r] = val.v;
  };

  D3 fw[3] = {lift(0.f), lift(0.f), lift(0.f)}, fv[3] = {lift(0.f), lift(0.f), lift(0.f)};
#pragma unroll 1
  for (int i = NJ - 1; i > j; --i) {
    const Joint& J = C.j[i];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      fw[a] = fw[a] + fbd[i][a];
      fv[a] = fv[a] + fbd[i][3 + a];
    }
    put(i, axis_dot(J, fw));
    float R[9];
    joint_rotation(J, sq[i], cq[i], R);
    backward_joint(J, R, fw, fv);
  }
  {
    const Joint& J = C.j[j];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      fw[a] = fw[a] + fbd[j][a];
      fv[a] = fv[a] + fbd[j][3 + a];
    }
    put(j, axis_dot(J, fw));
    const D3 sd = {sq[j], cq[j], 0.f, 0.f}, cd = {cq[j], -sq[j], 0.f, 0.f};
    D3 R[9];
    joint_rotation(J, sd, cd, R);
    backward_joint(J, R, fw, fv);
  }
#pragma unroll 1
  for (int i = j - 1; i >= 0; --i) {
    const Joint& J = C.j[i];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      fw[a] = fw[a] + fbf[i][a];
      fv[a] = fv[a] + fbf[i][3 + a];
    }
    put(i, axis_dot(J, fw));
    float R[9];
    joint_rotation(J, sq[i], cq[i], R);
    backward_joint(J, R, fw, fv);
  }
  put(NJ, height);
  __syncthreads();
  const int n = min(JE, F - f0);
  if constexpr (JTILE) store_tile<JT, JROW, JSTRIDE>(tj, Jac + (size_t)f0 * JROW, n);
  store_tile<JT, NG, GSTRIDE>(tg, g + (size_t)f0 * NG, n);
}

}  // namespace

// robot: in device memory, NJ * 46 floats of joint blocks, then gravity (3)
// and the tool translation (3), as kernels/constraints.py bake_model lays
// them out (struct Robot). x, u: the inputs where they lie (struct Inputs);
// g (F, NG) and jac (F, NG, NIN) are contiguous and 16-byte aligned.
extern "C" int mpc_constraints(const float* robot, int tool_parent, const float* x,
                               const float* u, long long x_stride, long long u_stride, int nodes,
                               float* g, float* jac, int F, int with_jac, void* stream) {
  if (F <= 0) return 0;
  const Robot* C = reinterpret_cast<const Robot*>(robot);
  Inputs in = {x, u, x_stride, u_stride, nodes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_jac) {
    constraints_jac_kernel<<<(F + JE - 1) / JE, JT, JSMEM, s>>>(C, tool_parent, in, g, jac, F);
  } else {
    constraints_value_kernel<<<(F + VT - 1) / VT, VT, 0, s>>>(C, tool_parent, in, g, F);
  }
  return (int)cudaGetLastError();
}

// Called once when the library is loaded: the Jacobian launch may take its
// tiles' dynamic shared memory (a launch sets nothing, so it can be captured
// into a CUDA graph as it is).
extern "C" int mpc_constraints_init() {
  return (int)cudaFuncSetAttribute(constraints_jac_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, JSMEM);
}

// The bytes of dynamic shared memory a block of the Jacobian launch takes,
// the blocks an SM holds its registers are capped for, its threads, whether
// it stages J in a tile, and the bytes of its parameters (the robot's
// pointer and tool parent, struct Inputs, g, J and F) and of the robot.
extern "C" int mpc_constraints_smem_bytes() { return JSMEM; }
extern "C" int mpc_constraints_blocks_bound() { return JB; }
extern "C" int mpc_constraints_threads() { return JT; }
extern "C" int mpc_constraints_j_tiled() { return JTILE ? 1 : 0; }
extern "C" int mpc_constraints_param_bytes() {
  return (int)(sizeof(const Robot*) + sizeof(int) + sizeof(Inputs) + 2 * sizeof(float*) +
               sizeof(int));
}
extern "C" int mpc_constraints_robot_bytes() { return (int)sizeof(Robot); }
