// Kernel 4: one chunk of dense boxADMM iterations of one QP per thread
// block, over the explicit KKT inverse M^-1 (n x n) and the scaled
// constraint matrix A (m x n), both streamed from device memory.
//
// Replaces mpc_motion_planner_tpu/ops/pallas/admm_kernel.py
// admm_pallas_chunk (_admm_kernel :94). Each iteration:
//   r   = (sigma x - q + (rx zx - yx)) + A'(rc zc - yc)
//   xt  = M^-1 r;  ax = A xt
//   kkt_refine times: xt += M^-1 (r - (P + sigma + rx) xt - A'(rc ax)); ax = A xt
//   x   = ftz(a xt + (1-a) x)
//   zc, yc, zx, yx: soft-l1 prox z-updates and dual updates, each ftz'd
// and at chunk-local k % check_every == 0 or k == chunk_iters: the freeze
// of a problem whose max_i(|x_i| + |yc_i| + |yx_i|) over the shared index
// axis is not <= 1e12 (done = 2; NaN freezes too), else the OSQP residual
// test (done = 1). A block stops at its own done, so used = iterations run.
//
// Bound by bytes: with kkt_refine = 1 an iteration reads A four times and
// M^-1 twice (4.4 MB per problem at n = 400, m = 488), which no cache
// holds across the grid. A v and M^-1 r take a warp per row (16-byte loads
// when n % 4 == 0), A'u a thread per column walking the rows, so every
// pass over a matrix is coalesced. The iterates and operand vectors live in
// shared memory (13 n + 9 m floats).
//
// Layouts (see kernels/admm_dense.py): M_inv (B,n,n), A (B,m,n), vectors
// (B,n) or (B,m) float32, done/used (B,) int32. The state is updated in
// place.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int T = 512;  // threads per block
constexpr int W = T / 32;
constexpr float HARD = 1e20f;  // hard-row stand-in of the soft thresholds
constexpr float BIG = 1e12f;   // divergence freeze level

struct Params {
  int n, m, chunk_iters, check_every, kkt_refine, vec4;
  float eps_abs, eps_rel, sigma, alpha;
};

struct Ptrs {
  const float *Minv, *A;
  const float *P, *q, *lx, *ux, *rx, *D, *sx;  // (B, n)
  const float *lc, *uc, *rc, *E, *sc;          // (B, m)
  float *x, *zc, *zx, *yc, *yx;                // state, in place
  int *done, *used;
};
constexpr int NPTRS = 21;
static_assert(sizeof(Ptrs) == NPTRS * sizeof(void*), "pointer block layout");

constexpr int NVEC_N = 13, NVEC_M = 9;  // shared vectors of length n / m

__device__ __forceinline__ float ftz(float v) {
  return mpc::clampf(fabsf(v) < 1e-30f ? 0.f : v, -1e15f, 1e15f);
}

// prox of the thr-scaled l1 distance to [lo, hi] (thr huge: plain clip)
__device__ __forceinline__ float soft_prox(float v, float lo, float hi, float thr) {
  return v - mpc::clampf(v - mpc::clampf(v, lo, hi), -thr, thr);
}

// max that propagates NaN from either side (as jnp.max does)
__device__ __forceinline__ float nmax(float a, float b) { return (a > b || a != a) ? a : b; }

template <int K>
__device__ __forceinline__ void block_nmax(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] = nmax(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
    if (lane == 0) red[warp * K + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float t = red[i];
    for (int w = 1; w < W; ++w) t = nmax(t, red[w * K + i]);
    v[i] = t;
  }
  __syncthreads();
}

// out[r] = M[r, :] . v (or out[r] += ... with ACC) for r < rows: a warp per
// row, lanes across the columns. Ends with a __syncthreads.
template <bool ACC>
__device__ void rows_dot(const float* __restrict__ M, int rows, int cols, bool vec4,
                         const float* v, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += W) {
    const float* row = M + (size_t)r * cols;
    float acc = 0.f;
    if (vec4) {
      const float4* r4 = reinterpret_cast<const float4*>(row);
      const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll 4
      for (int c = lane; c < cols / 4; c += 32) {
        const float4 a = __ldg(r4 + c), b = v4[c];
        acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      }
    } else {
#pragma unroll 4
      for (int c = lane; c < cols; c += 32) acc += __ldg(row + c) * v[c];
    }
    acc = mpc::warp_sum(acc);
    if (lane == 0) out[r] = ACC ? out[r] + acc : acc;
  }
  __syncthreads();
}

// out[c] = sum_r M[r, c] u[r] for c < cols: a thread per column walking the
// rows (a warp reads 32 neighbouring floats of a row). Ends with a
// __syncthreads.
__device__ void cols_dot(const float* __restrict__ M, int rows, int cols, const float* u,
                         float* out) {
  for (int c = threadIdx.x; c < cols; c += T) {
    const float* col = M + c;
    float acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) acc += __ldg(col + (size_t)r * cols) * u[r];
    out[c] = acc;
  }
  __syncthreads();
}

// Two blocks per SM (64 registers a thread, no spills): twice the loads in
// flight of one 116-register block, which is what a streaming loop needs.
__global__ void __launch_bounds__(T, 2) admm_dense_kernel(Ptrs g, Params p) {
  extern __shared__ float4 smem4[];
  __shared__ float red[W * 4];
  __shared__ int s_done;
  const int n = p.n, m = p.m, n4 = (n + 3) & ~3, m4 = (m + 3) & ~3;
  float* s = reinterpret_cast<float*>(smem4);
  // every vector starts on a 16-byte boundary (float4 reads of v in rows_dot)
  float *x = s, *zx = x + n4, *yx = zx + n4, *P = yx + n4, *q = P + n4, *lx = q + n4,
        *ux = lx + n4, *rx = ux + n4, *D = rx + n4, *thx = D + n4, *r = thx + n4,
        *xt = r + n4, *t = xt + n4;
  float *zc = t + n4, *yc = zc + m4, *lc = yc + m4, *uc = lc + m4, *rc = uc + m4,
        *E = rc + m4, *thr = E + m4, *ax = thr + m4, *u = ax + m4;

  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t on = (size_t)b * n, om = (size_t)b * m;
  const float* Mi = g.Minv + (size_t)b * n * n;
  const float* A = g.A + (size_t)b * m * n;
  const bool vec4 = p.vec4 != 0;
  const float sigma = p.sigma, alpha = p.alpha;

  for (int j = tid; j < n; j += T) {
    x[j] = g.x[on + j];
    zx[j] = g.zx[on + j];
    yx[j] = g.yx[on + j];
    P[j] = g.P[on + j];
    q[j] = g.q[on + j];
    lx[j] = g.lx[on + j];
    ux[j] = g.ux[on + j];
    rx[j] = g.rx[on + j];
    D[j] = g.D[on + j];
    // numerator capped before the divide: hard rows give exactly HARD
    thx[j] = fminf(g.sx[on + j], HARD * rx[j]) / rx[j];
  }
  for (int i = tid; i < m; i += T) {
    zc[i] = g.zc[om + i];
    yc[i] = g.yc[om + i];
    lc[i] = g.lc[om + i];
    uc[i] = g.uc[om + i];
    rc[i] = g.rc[om + i];
    E[i] = g.E[om + i];
    thr[i] = fminf(g.sc[om + i], HARD * rc[i]) / rc[i];
  }
  if (tid == 0) s_done = g.done[b];
  __syncthreads();

  int k = 0;
  while (k < p.chunk_iters && s_done == 0) {
    // ---- x-update: r, xt = M^-1 r, ax = A xt, refinement ----
    for (int i = tid; i < m; i += T) u[i] = rc[i] * zc[i] - yc[i];
    __syncthreads();
    cols_dot(A, m, n, u, t);
    for (int j = tid; j < n; j += T)
      r[j] = (sigma * x[j] - q[j] + (rx[j] * zx[j] - yx[j])) + t[j];
    __syncthreads();
    rows_dot<false>(Mi, n, n, vec4, r, xt);
    rows_dot<false>(A, m, n, vec4, xt, ax);
    for (int it = 0; it < p.kkt_refine; ++it) {
      for (int i = tid; i < m; i += T) u[i] = rc[i] * ax[i];
      __syncthreads();
      cols_dot(A, m, n, u, t);
      for (int j = tid; j < n; j += T) t[j] = r[j] - (P[j] + sigma + rx[j]) * xt[j] - t[j];
      __syncthreads();
      rows_dot<true>(Mi, n, n, vec4, t, xt);
      rows_dot<false>(A, m, n, vec4, xt, ax);
    }

    // ---- relaxed updates, soft-row prox, duals ----
    for (int j = tid; j < n; j += T) {
      const float xtj = xt[j];
      x[j] = ftz(alpha * xtj + (1.f - alpha) * x[j]);
      const float za = alpha * xtj + (1.f - alpha) * zx[j];
      const float zn = ftz(soft_prox(za + yx[j] / rx[j], lx[j], ux[j], thx[j]));
      yx[j] = ftz(yx[j] + rx[j] * (za - zn));
      zx[j] = zn;
    }
    for (int i = tid; i < m; i += T) {
      const float za = alpha * ax[i] + (1.f - alpha) * zc[i];
      const float zn = ftz(soft_prox(za + yc[i] / rc[i], lc[i], uc[i], thr[i]));
      yc[i] = ftz(yc[i] + rc[i] * (za - zn));
      zc[i] = zn;
    }
    __syncthreads();
    ++k;

    if (k % p.check_every == 0 || k >= p.chunk_iters) {
      // ---- freeze on divergence over the shared variable/row index axis ----
      bool big = false;
      const int L = n > m ? n : m;
      for (int i = tid; i < L; i += T) {
        float a = (i < n ? fabsf(x[i]) : 0.f) + (i < m ? fabsf(yc[i]) : 0.f);
        a += i < n ? fabsf(yx[i]) : 0.f;
        big |= !(a <= BIG);
      }
      if (__syncthreads_or(big ? 1 : 0)) {
        if (tid == 0) s_done = 2;
      } else {
        // ---- OSQP residuals in unscaled units ----
        rows_dot<false>(A, m, n, vec4, x, ax);  // A x
        cols_dot(A, m, n, yc, t);               // A' yc
        // v[0] r_prim, v[1] r_dual, v[2] scale_p, v[3] scale_d
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        for (int i = tid; i < m; i += T) {
          const float e = E[i];
          v[0] = nmax(v[0], fabsf((ax[i] - zc[i]) / e));
          v[2] = nmax(v[2], nmax(fabsf(ax[i] / e), fabsf(zc[i] / e)));
        }
        for (int j = tid; j < n; j += T) {
          const float d = D[j], xj = x[j], px = P[j] * xj;
          v[0] = nmax(v[0], fabsf(d * (xj - zx[j])));
          v[1] = nmax(v[1], fabsf((px + q[j] + t[j] + yx[j]) / d));
          v[2] = nmax(v[2], nmax(fabsf(d * xj), fabsf(d * zx[j])));
          v[3] = nmax(v[3], nmax(nmax(fabsf(px / d), fabsf(q[j] / d)),
                                 nmax(fabsf(t[j] / d), fabsf(yx[j] / d))));
        }
        block_nmax<4>(v, red);
        const bool conv = v[0] <= p.eps_abs + p.eps_rel * v[2] &&
                          v[1] <= p.eps_abs + p.eps_rel * v[3];
        if (tid == 0) s_done = conv ? 1 : 0;
      }
      __syncthreads();
    }
  }

  for (int j = tid; j < n; j += T) {
    g.x[on + j] = x[j];
    g.zx[on + j] = zx[j];
    g.yx[on + j] = yx[j];
  }
  for (int i = tid; i < m; i += T) {
    g.zc[om + i] = zc[i];
    g.yc[om + i] = yc[i];
  }
  if (tid == 0) {
    g.done[b] = s_done;
    g.used[b] = k;
  }
}

}  // namespace

// ptrs: the NPTRS pointers of struct Ptrs, in its order.
extern "C" int mpc_admm_dense(void* const* ptrs, int B, int n, int m, int chunk_iters,
                              int check_every, int kkt_refine, float eps_abs, float eps_rel,
                              float sigma, float alpha, void* stream) {
  if (B <= 0) return 0;
  Ptrs g;
  memcpy(&g, ptrs, sizeof(Ptrs));
  const bool aligned = (reinterpret_cast<uintptr_t>(g.Minv) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(g.A) % 16 == 0);
  Params p{n, m, chunk_iters, check_every, kkt_refine, (n % 4 == 0 && aligned) ? 1 : 0,
           eps_abs, eps_rel, sigma, alpha};
  const int n4 = (n + 3) & ~3, m4 = (m + 3) & ~3;
  const int smem = (NVEC_N * n4 + NVEC_M * m4) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(admm_dense_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  admm_dense_kernel<<<B, T, smem, static_cast<cudaStream_t>(stream)>>>(g, p);
  return (int)cudaGetLastError();
}
