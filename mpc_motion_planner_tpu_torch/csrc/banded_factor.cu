// Kernel 2: block-banded Cholesky + arrow factorization of the node-major
// ADMM KKT matrix M = A'WA + diag(sigma), one problem per thread block.
//
// Replaces mpc_motion_planner_tpu/ops/pallas/banded_factor.py
// factor_banded_pallas (_factor_kernel :117, _chol_lane :83,
// _tri_inv_lane :100). Same recursion and numerical guards: per node k the
// band Schur update S = M[k,k] - sum L[k,j] L[k,j]', a column-by-column
// Cholesky with the 1e-20 pivot floor, the forward-substitution inverse of
// L[k,k], the sub-diagonal blocks L[k+d,k] = (M[k+d,k] - sum ...) L[k,k]^-T,
// then the banded solve for the arrow column u and the Schur scalar s.
// Every computed entry is clamped to +-1e8, and ok is cleared by a pivot or
// s at or below 1e-20 or by any factor entry at or above 0.99e8.
//
// Layout (see kernels/banded_factor.py): Mband (B,19,4,21,21) with
// Mband[b,k,d] = M[k+d,k]; outputs Ldi (B,19,21,21) = L[k,k]^-1,
// Lsub (B,19,3,21,21) with Lsub[b,k,d-1] = L[k+d,k], u (B,19,21), s (B,),
// ok (B,) int. The whole factor of a problem (134 KB) stays in shared
// memory during the recursion and is written out once at the end.

#include "common.cuh"

using namespace mpc;

namespace {

constexpr float MAG = 1e8f;
constexpr float SAT = 0.99f * MAG;
constexpr float PIV_FLOOR = 1e-20f;

__device__ __forceinline__ float fz(float v) { return clampf(v, -MAG, MAG); }

struct Smem {
  float Ldi[N * BLK2];
  float Lsub[N * BW * BLK2];
  float S[BLK2];     // Schur complement / Cholesky work block
  float Lk[BLK2];    // L[k,k]
  float C[BLK2];     // sub-diagonal work block
  float col[BLK];
  float ys[N * BLK];
  float us[N * BLK];
  float tmp[32];
  float red[WARPS];
  int ok;
};

// out[a,b] -= sum_c X[a,c] Y[b,c] for every entry owned by this thread,
// clamped after each product (the TPU kernel's _fz(S - _matmul_nt(...)))
__device__ __forceinline__ float sub_nt(float v, const float* X, const float* Y, int a, int b) {
  float acc = 0.f;
#pragma unroll 7
  for (int c = 0; c < BLK; ++c) acc += X[a * BLK + c] * Y[b * BLK + c];
  return fz(v - acc);
}

__global__ void __launch_bounds__(THREADS)
banded_factor_kernel(const float* __restrict__ Mband, const float* __restrict__ p_col,
                     const float* __restrict__ m_pp, float* __restrict__ Ldi_out,
                     float* __restrict__ Lsub_out, float* __restrict__ u_out,
                     float* __restrict__ s_out, int* __restrict__ ok_out) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* Mb = Mband + (size_t)b * N * (BW + 1) * BLK2;
  const float* pc = p_col + (size_t)b * N * BLK;
  if (tid == 0) sm.ok = 1;

  for (int k = 0; k < N; ++k) {
    // ---- S = M[k,k] - sum_j L[k,j] L[k,j]' ----
    for (int e = tid; e < BLK2; e += THREADS) {
      int a = e / BLK, c = e % BLK;
      float v = Mb[(k * (BW + 1)) * BLK2 + e];
      for (int j = max(0, k - BW); j < k; ++j) {
        const float* Ljk = sm.Lsub + (j * BW + (k - j - 1)) * BLK2;
        v = sub_nt(v, Ljk, Ljk, a, c);
      }
      sm.S[e] = v;
    }
    __syncthreads();

    // ---- Cholesky of S, column by column ----
    for (int j = 0; j < BLK; ++j) {
      float d2 = sm.S[j * BLK + j];
      if (tid < BLK) {
        float d = sqrtf(d2 > PIV_FLOOR ? d2 : PIV_FLOOR);
        float v = tid >= j ? fz(sm.S[tid * BLK + j] / d) : 0.f;
        sm.col[tid] = v;
        sm.Lk[tid * BLK + j] = v;
      }
      if (tid == 0 && !(d2 > PIV_FLOOR)) sm.ok = 0;
      __syncthreads();
      for (int e = tid; e < BLK2; e += THREADS) {
        int a = e / BLK, c = e % BLK;
        sm.S[e] = fz(sm.S[e] - sm.col[a] * sm.col[c]);
      }
      __syncthreads();
    }

    // ---- Ldi[k] = L[k,k]^-1 by forward substitution, one column per thread ----
    float* Linv = sm.Ldi + k * BLK2;
    if (tid < BLK) {
      const int c = tid;
      for (int i = 0; i < BLK; ++i) {
        float s = 0.f;
        for (int q = 0; q < i; ++q) s += sm.Lk[i * BLK + q] * Linv[q * BLK + c];
        float acc = (i == c ? 1.f : 0.f) - s;
        Linv[i * BLK + c] = fz(acc / sm.Lk[i * BLK + i]);
      }
    }
    __syncthreads();

    // ---- L[k+d,k] = (M[k+d,k] - sum_j L[k+d,j] L[k,j]') L[k,k]^-T ----
    for (int d = 1; d <= BW; ++d) {
      float* out = sm.Lsub + (k * BW + d - 1) * BLK2;
      if (k + d >= N) {
        for (int e = tid; e < BLK2; e += THREADS) out[e] = 0.f;
        continue;
      }
      for (int e = tid; e < BLK2; e += THREADS) {
        int a = e / BLK, c = e % BLK;
        float v = Mb[(k * (BW + 1) + d) * BLK2 + e];
        for (int j = max(0, k + d - BW); j < k; ++j)
          v = sub_nt(v, sm.Lsub + (j * BW + (k + d - j - 1)) * BLK2,
                     sm.Lsub + (j * BW + (k - j - 1)) * BLK2, a, c);
        sm.C[e] = v;
      }
      __syncthreads();
      for (int e = tid; e < BLK2; e += THREADS) {
        int a = e / BLK, c = e % BLK;
        float acc = 0.f;
#pragma unroll 7
        for (int q = 0; q < BLK; ++q) acc += sm.C[a * BLK + q] * Linv[c * BLK + q];
        out[e] = fz(acc);
      }
      __syncthreads();
    }
  }

  // ---- banded solve (L L') u = p_col in warp 0, lane r owns row r ----
  if (tid < 32) {
    const int r = tid;
    for (int k = 0; k < N; ++k) {
      float acc = r < BLK ? pc[k * BLK + r] : 0.f;
      for (int d = 1; d <= min(BW, k); ++d) {
        const float* L = sm.Lsub + ((k - d) * BW + d - 1) * BLK2;
        const float* y = sm.ys + (k - d) * BLK;
        float s = 0.f;
        if (r < BLK)
          for (int c = 0; c < BLK; ++c) s += L[r * BLK + c] * y[c];
        acc -= s;
      }
      sm.tmp[r] = acc;
      __syncwarp();
      if (r < BLK) {
        float s = 0.f;
        for (int c = 0; c < BLK; ++c) s += sm.Ldi[k * BLK2 + r * BLK + c] * sm.tmp[c];
        sm.ys[k * BLK + r] = fz(s);
      }
      __syncwarp();
    }
    for (int k = N - 1; k >= 0; --k) {
      float acc = r < BLK ? sm.ys[k * BLK + r] : 0.f;
      for (int d = 1; d <= min(BW, N - 1 - k); ++d) {
        const float* L = sm.Lsub + (k * BW + d - 1) * BLK2;
        const float* x = sm.us + (k + d) * BLK;
        float s = 0.f;
        if (r < BLK)
          for (int c = 0; c < BLK; ++c) s += L[c * BLK + r] * x[c];
        acc -= s;
      }
      sm.tmp[r] = acc;
      __syncwarp();
      if (r < BLK) {
        float s = 0.f;
        for (int c = 0; c < BLK; ++c) s += sm.Ldi[k * BLK2 + c * BLK + r] * sm.tmp[c];
        sm.us[k * BLK + r] = fz(s);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- s = m_pp - u . p_col, the flags, and the writes ----
  float part = 0.f;
  for (int e = tid; e < N * BLK; e += THREADS) part += sm.us[e] * pc[e];
  float s = fz(m_pp[b] - block_sum(part, sm.red));

  bool sat = !(fabsf(s) < SAT);
  float* Ldi_b = Ldi_out + (size_t)b * N * BLK2;
  for (int e = tid; e < N * BLK2; e += THREADS) {
    float v = sm.Ldi[e];
    sat |= !(fabsf(v) < SAT);
    Ldi_b[e] = v;
  }
  float* Lsub_b = Lsub_out + (size_t)b * N * BW * BLK2;
  for (int e = tid; e < N * BW * BLK2; e += THREADS) {
    float v = sm.Lsub[e];
    sat |= !(fabsf(v) < SAT);
    Lsub_b[e] = v;
  }
  float* u_b = u_out + (size_t)b * N * BLK;
  for (int e = tid; e < N * BLK; e += THREADS) {
    float v = sm.us[e];
    sat |= !(fabsf(v) < SAT);
    u_b[e] = v;
  }
  bool any_sat = block_any(sat);
  if (tid == 0) {
    s_out[b] = s;
    ok_out[b] = (sm.ok && s > PIV_FLOOR && !any_sat) ? 1 : 0;
  }
}

}  // namespace

extern "C" int mpc_banded_factor(const float* Mband, const float* p_col, const float* m_pp,
                                 float* Ldi, float* Lsub, float* u, float* s, int* ok, int B,
                                 void* stream) {
  if (B <= 0) return 0;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(banded_factor_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  banded_factor_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      Mband, p_col, m_pp, Ldi, Lsub, u, s, ok);
  return (int)cudaGetLastError();
}
