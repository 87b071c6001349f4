// Shared device helpers of the port's kernels: NaN-preserving clamps and
// block-wide reductions.
#pragma once

#include <cuda_runtime.h>

#include <cstring>

namespace mpc {

// Problem geometry of the Panda transcription: 19 collocation nodes, 6
// segments of 4 local nodes, 14 states + 7 controls per node, 8 constraint
// rows per node, band width 3 (kernels/*.py check these before a launch).
constexpr int N = 19;
constexpr int SEG = 6;
constexpr int KL = 4;
constexpr int NX = 14;
constexpr int NU = 7;
constexpr int NQ = 7;
constexpr int NG = 8;
constexpr int BLK = NX + NU;       // 21
constexpr int BLK2 = BLK * BLK;    // 441
constexpr int BW = 3;
constexpr int NV = N * BLK + 1;    // 400 variables
constexpr int NEQ = SEG * KL * NX; // 336 defect rows
constexpr int NM = NEQ + N * NG;   // 488 constraint rows
constexpr int UOFF = N * NX;       // 266: start of the controls in z
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// clip(v, lo, hi) that keeps NaN (as jnp.clip / torch.clamp do)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// z-layout index of component c (0..20: q, qdot, u) of node n
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
