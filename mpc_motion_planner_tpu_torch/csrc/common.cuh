// Shared device helpers of the port's kernels: NaN-preserving clamps and
// block-wide reductions.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

namespace mpc {

// Problem geometry of the transcription a library is built for. The build
// sets it (kernels/build.py Geometry.flags: -DMPC_SEGMENTS=... and so on);
// the defaults are the Panda's 19-node transcription: 6 segments of order
// 3 (4 local nodes each) and 7 joints. Per node: 2 NQ states (q, qdot), NQ
// controls (qddot), NQ + 1 constraint rows (the torques and the tool
// height); band width = order.
#ifndef MPC_SEGMENTS
#define MPC_SEGMENTS 6
#endif
#ifndef MPC_ORDER
#define MPC_ORDER 3
#endif
#ifndef MPC_NQ
#define MPC_NQ 7
#endif
// Kernel 3's shared-memory layout, which the build picks from the geometry
// (kernels/structured_admm.py choose_layout): 0 full, 1 compact, 2 split,
// 3 stream, 4 lean, 5 far, 6 deep, 7 pair (a cluster of two blocks).
#ifndef MPC_SMEM_LAYOUT
#define MPC_SMEM_LAYOUT 0
#endif
// Kernel 3's z elements and constraint rows per thread, which the build sets
// to ceil(max(NV, NM) / 1024) (kernels/structured_admm.py ept_of): 1 up to
// 1024 threads, 2 past them.
#ifndef MPC_EPT
#define MPC_EPT 1
#endif
constexpr int SEG = MPC_SEGMENTS;
constexpr int KL = MPC_ORDER + 1;  // local nodes per segment
constexpr int N = SEG * MPC_ORDER + 1;
constexpr int NQ = MPC_NQ;         // joints
constexpr int NX = 2 * NQ;
constexpr int NU = NQ;
constexpr int NG = NQ + 1;
constexpr int BLK = NX + NU;       // 3 NQ: 21 for the Panda
constexpr int BLK2 = BLK * BLK;    // 441
constexpr int BW = MPC_ORDER;
constexpr int NV = N * BLK + 1;    // variables (400 at 19 nodes, 7 joints)
constexpr int NEQ = SEG * KL * NX; // defect rows (336)
constexpr int NM = NEQ + N * NG;   // constraint rows (488)
constexpr int UOFF = N * NX;       // start of the controls in z (266)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// clip(v, lo, hi) that keeps NaN (as jnp.clip / torch.clamp do)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// z-layout index of component c (0..BLK-1: q, qdot, u) of node n
__device__ __forceinline__ int zidx(int n, int c) {
  return c < NX ? n * NX + c : UOFF + n * NU + (c - NX);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum of v over a block of NW warps, returned to every thread. red: >= NW
// floats.
template <int NW = WARPS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) t += red[w];
  __syncthreads();
  return t;
}

// Element-wise max over a block of NW warps of NVAL values, returned to
// every thread. red: >= NW * NVAL floats.
template <int NVAL, int NW = WARPS>
__device__ __forceinline__ void block_max(float (&v)[NVAL], float* red) {
#pragma unroll
  for (int i = 0; i < NVAL; ++i) {
    float m = warp_max(v[i]);
    if ((threadIdx.x & 31) == 0) red[(threadIdx.x >> 5) * NVAL + i] = m;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NVAL; ++i) {
    float m = red[i];
#pragma unroll
    for (int w = 1; w < NW; ++w) m = fmaxf(m, red[w * NVAL + i]);
    v[i] = m;
  }
  __syncthreads();
}

// True on every thread if flag is true on any thread.
__device__ __forceinline__ bool block_any(bool flag) {
  return __syncthreads_or(flag ? 1 : 0) != 0;
}

}  // namespace mpc
