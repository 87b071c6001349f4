// Kernel 3: the whole fixed-rho boxADMM loop of one structured QP per
// thread block, with every per-problem operand resident in shared memory.
//
// Replaces mpc_motion_planner_tpu/ops/pallas/structured_admm.py
// solve_box_qp_structured_pallas (_structured_kernel :142). Each iteration:
//   rhs = sigma x - qs + rx zx - yx + D A'(E (rc zc - yc))
//   xt  = M^-1 rhs            (banded forward/backward sweeps + arrow)
//   zt  = E A (D xt)
//   x   = ftz(a xt + (1-a) x)
//   zc, yc, zx, yx: soft-l1 prox z-updates and dual updates, with ftz
// and every check_every iterations (and at the cap) the OSQP residual test
// and the NaN-safe divergence freeze at 1e12 (done = 2). A block stops at
// its own done, so a problem's iteration count is its active iterations.
// A and A' are applied matrix-free from the differentiation matrix Dm, the
// time parameter p, the dynamics values f_rows and the node Jacobians J.
//
// Layouts (see kernels/structured_admm.py): z-layout (B,400), m-layout
// (B,488), Ldi (B,19,21,21), Lsub (B,19,3,21,21), u (B,19,21), J
// (B,19,8,21), f_rows (B,336).

#include "common.cuh"

using namespace mpc;

namespace {

struct Params {
  float Dm[KL * KL];  // Dm[k*4 + j]
  float sigma, alpha, eps_abs, eps_rel;
  int cap, check_every;
};

struct Ptrs {
  // factors and operator data
  const float *Ldi, *Lsub, *u, *s, *J, *f_rows, *p;
  // z-layout data
  const float *qs, *Ps, *rx, *lxs, *uxs, *thx, *D, *x0, *zx0, *yx0;
  // m-layout data
  const float *rc, *lcs, *ucs, *E, *thr, *zc0, *yc0;
  // outputs
  float *x, *zc, *zx, *yc, *yx, *rp, *rd;
  int *done, *iters;
};
constexpr int NPTRS = 33;
static_assert(sizeof(Ptrs) == NPTRS * sizeof(void*), "pointer block layout");

struct Smem {
  float Ldi[N * BLK2];
  float Lsub[N * BW * BLK2];
  float u[N * BLK];
  float J[N * NG * BLK];
  float fseg[NEQ];
  float qs[NV], Ps[NV], rx[NV], lxs[NV], uxs[NV], thx[NV], D[NV];
  float rc[NM], lcs[NM], ucs[NM], E[NM], thr[NM];
  float x[NV], zx[NV], yx[NV];
  float zc[NM], yc[NM];
  float va[NV], vb[NV];  // z-layout scratch
  float wa[NM], wb[NM];  // m-layout scratch
  float nm1[N * BLK], nm2[N * BLK];  // node-major scratch for the sweeps
  float tmp[32];
  float red[WARPS * 8];
  float p, s;
  int done;
};

__device__ __forceinline__ float ftz(float v) {
  return clampf(fabsf(v) < 1e-30f ? 0.f : v, -1e15f, 1e15f);
}

__device__ __forceinline__ float soft_update(float za, float y, float r, float lo, float hi,
                                             float t) {
  float v = za + y / r;
  float box = clampf(v, lo, hi);
  return ftz(v - clampf(v - box, -t, t));
}

// out = A_raw v (m-layout) for z-layout v
__device__ void apply_A(const Smem& sm, const Params& P, const float* v, float* out) {
  for (int i = threadIdx.x; i < NM; i += THREADS) {
    float val;
    if (i < NEQ) {
      int row = i / NX, ci = i % NX;
      int s = row / KL, k = row % KL;
      float dx = 0.f;
#pragma unroll
      for (int j = 0; j < KL; ++j) dx += P.Dm[k * KL + j] * v[((KL - 1) * s + j) * NX + ci];
      int n = (KL - 1) * s + k;
      float flin = ci < NQ ? v[n * NX + ci + NQ] : v[UOFF + n * NU + (ci - NQ)];
      val = dx - sm.p * flin - sm.fseg[i] * v[NV - 1];
    } else {
      int g = i - NEQ, n = g / NG, r = g % NG;
      const float* Jr = sm.J + (n * NG + r) * BLK;
      float acc = 0.f;
#pragma unroll 7
      for (int c = 0; c < BLK; ++c) acc += Jr[c] * v[zidx(n, c)];
      val = acc;
    }
    out[i] = val;
  }
}

// out = A_raw' w (z-layout) for m-layout w. Ends with a __syncthreads.
__device__ void apply_AT(Smem& sm, const Params& P, const float* w, float* out) {
  for (int j = threadIdx.x; j < NV - 1; j += THREADS) {
    int n, c;
    if (j < UOFF) { n = j / NX; c = j % NX; }
    else { n = (j - UOFF) / NU; c = NX + (j - UOFF) % NU; }
    // covering (segment, local node) pairs of node n
    int ns = 1, s0, l0, s1 = 0, l1 = 0;
    if (n == 0) { s0 = 0; l0 = 0; }
    else if (n == N - 1) { s0 = SEG - 1; l0 = KL - 1; }
    else if (n % 3 == 0) { s0 = n / 3 - 1; l0 = KL - 1; s1 = n / 3; l1 = 0; ns = 2; }
    else { s0 = n / 3; l0 = n % 3; }
    float val = 0.f;
    for (int q = 0; q < ns; ++q) {
      int s = q ? s1 : s0, l = q ? l1 : l0;
      const float* we = w + s * KL * NX;
      if (c < NX) {
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < KL; ++k) t += P.Dm[k * KL + l] * we[k * NX + c];
        val += t;
        if (c >= NQ) val -= sm.p * we[l * NX + (c - NQ)];
      } else {
        val -= sm.p * we[l * NX + NQ + (c - NX)];
      }
    }
    const float* wg = w + NEQ + n * NG;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < NG; ++r) acc += sm.J[(n * NG + r) * BLK + c] * wg[r];
    out[j] = val + acc;
  }
  float part = 0.f;
  for (int e = threadIdx.x; e < NEQ; e += THREADS) part += sm.fseg[e] * w[e];
  float tot = block_sum(part, sm.red);
  if (threadIdx.x == 0) out[NV - 1] = -tot;
  __syncthreads();
}

// out = M^-1 rhs (z-layout, out != rhs). Ends with a __syncthreads.
__device__ void solve_arrow(Smem& sm, const float* rhs, float* out) {
  float part = 0.f;
  for (int e = threadIdx.x; e < N * BLK; e += THREADS) {
    float r = rhs[zidx(e / BLK, e % BLK)];
    sm.nm1[e] = r;
    part += sm.u[e] * r;
  }
  float ur = block_sum(part, sm.red);  // syncs: nm1 is complete
  if (threadIdx.x < 32) {
    const int r = threadIdx.x;
    // forward: y_k = Ldi_k (rb_k - sum_d L[k,k-d] y_{k-d}) into nm2
    for (int k = 0; k < N; ++k) {
      float acc = r < BLK ? sm.nm1[k * BLK + r] : 0.f;
      for (int d = 1; d <= min(BW, k); ++d) {
        const float* L = sm.Lsub + ((k - d) * BW + d - 1) * BLK2 + r * BLK;
        const float* y = sm.nm2 + (k - d) * BLK;
        float s = 0.f;
        if (r < BLK)
#pragma unroll 7
          for (int c = 0; c < BLK; ++c) s += L[c] * y[c];
        acc -= s;
      }
      sm.tmp[r] = acc;
      __syncwarp();
      if (r < BLK) {
        const float* Ld = sm.Ldi + k * BLK2 + r * BLK;
        float s = 0.f;
#pragma unroll 7
        for (int c = 0; c < BLK; ++c) s += Ld[c] * sm.tmp[c];
        sm.nm2[k * BLK + r] = s;
      }
      __syncwarp();
    }
    // backward: x_k = Ldi_k' (y_k - sum_d L[k+d,k]' x_{k+d}) into nm1
    for (int k = N - 1; k >= 0; --k) {
      float acc = r < BLK ? sm.nm2[k * BLK + r] : 0.f;
      for (int d = 1; d <= min(BW, N - 1 - k); ++d) {
        const float* L = sm.Lsub + (k * BW + d - 1) * BLK2 + r;
        const float* x = sm.nm1 + (k + d) * BLK;
        float s = 0.f;
        if (r < BLK)
#pragma unroll 7
          for (int c = 0; c < BLK; ++c) s += L[c * BLK] * x[c];
        acc -= s;
      }
      sm.tmp[r] = acc;
      __syncwarp();
      if (r < BLK) {
        const float* Ld = sm.Ldi + k * BLK2 + r;
        float s = 0.f;
#pragma unroll 7
        for (int c = 0; c < BLK; ++c) s += Ld[c * BLK] * sm.tmp[c];
        sm.nm1[k * BLK + r] = s;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  float zp = (rhs[NV - 1] - ur) / sm.s;
  for (int e = threadIdx.x; e < N * BLK; e += THREADS)
    out[zidx(e / BLK, e % BLK)] = sm.nm1[e] - sm.u[e] * zp;
  if (threadIdx.x == 0) out[NV - 1] = zp;
  __syncthreads();
}

template <int LEN>
__device__ __forceinline__ void load(float* dst, const float* src) {
  for (int e = threadIdx.x; e < LEN; e += THREADS) dst[e] = src[e];
}

template <int LEN>
__device__ __forceinline__ void store(float* dst, const float* src) {
  for (int e = threadIdx.x; e < LEN; e += THREADS) dst[e] = src[e];
}

__global__ void __launch_bounds__(THREADS)
structured_admm_kernel(Params P, Ptrs g) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t zo = (size_t)b * NV, mo = (size_t)b * NM;

  load<N * BLK2>(sm.Ldi, g.Ldi + (size_t)b * N * BLK2);
  load<N * BW * BLK2>(sm.Lsub, g.Lsub + (size_t)b * N * BW * BLK2);
  load<N * BLK>(sm.u, g.u + (size_t)b * N * BLK);
  load<N * NG * BLK>(sm.J, g.J + (size_t)b * N * NG * BLK);
  load<NEQ>(sm.fseg, g.f_rows + (size_t)b * NEQ);
  load<NV>(sm.qs, g.qs + zo);
  load<NV>(sm.Ps, g.Ps + zo);
  load<NV>(sm.rx, g.rx + zo);
  load<NV>(sm.lxs, g.lxs + zo);
  load<NV>(sm.uxs, g.uxs + zo);
  load<NV>(sm.thx, g.thx + zo);
  load<NV>(sm.D, g.D + zo);
  load<NV>(sm.x, g.x0 + zo);
  load<NV>(sm.zx, g.zx0 + zo);
  load<NV>(sm.yx, g.yx0 + zo);
  load<NM>(sm.rc, g.rc + mo);
  load<NM>(sm.lcs, g.lcs + mo);
  load<NM>(sm.ucs, g.ucs + mo);
  load<NM>(sm.E, g.E + mo);
  load<NM>(sm.thr, g.thr + mo);
  load<NM>(sm.zc, g.zc0 + mo);
  load<NM>(sm.yc, g.yc0 + mo);
  if (tid == 0) {
    sm.p = g.p[b];
    sm.s = g.s[b];
    sm.done = 0;
  }
  __syncthreads();

  const float alpha = P.alpha, sigma = P.sigma;
  float rp = 0.f, rd = 0.f;
  int k = 0;
  while (k < P.cap && sm.done == 0) {
    // ---- rhs = sigma x - qs + rx zx - yx + D A'(E (rc zc - yc)) ----
    for (int i = tid; i < NM; i += THREADS) sm.wa[i] = sm.E[i] * (sm.rc[i] * sm.zc[i] - sm.yc[i]);
    __syncthreads();
    apply_AT(sm, P, sm.wa, sm.va);
    for (int j = tid; j < NV; j += THREADS)
      sm.va[j] = sigma * sm.x[j] - sm.qs[j] + sm.rx[j] * sm.zx[j] - sm.yx[j] + sm.D[j] * sm.va[j];
    __syncthreads();

    // ---- xt = M^-1 rhs (vb); zt = E A (D xt) (wb) ----
    solve_arrow(sm, sm.va, sm.vb);
    for (int j = tid; j < NV; j += THREADS) sm.va[j] = sm.D[j] * sm.vb[j];
    __syncthreads();
    apply_A(sm, P, sm.va, sm.wb);
    __syncthreads();

    // ---- relaxed prox and dual updates ----
    for (int j = tid; j < NV; j += THREADS) {
      float xt = sm.vb[j];
      sm.x[j] = ftz(alpha * xt + (1.f - alpha) * sm.x[j]);
      float za = alpha * xt + (1.f - alpha) * sm.zx[j];
      float zn = soft_update(za, sm.yx[j], sm.rx[j], sm.lxs[j], sm.uxs[j], sm.thx[j]);
      sm.yx[j] = ftz(sm.yx[j] + sm.rx[j] * (za - zn));
      sm.zx[j] = zn;
    }
    for (int i = tid; i < NM; i += THREADS) {
      float za = alpha * sm.E[i] * sm.wb[i] + (1.f - alpha) * sm.zc[i];
      float zn = soft_update(za, sm.yc[i], sm.rc[i], sm.lcs[i], sm.ucs[i], sm.thr[i]);
      sm.yc[i] = ftz(sm.yc[i] + sm.rc[i] * (za - zn));
      sm.zc[i] = zn;
    }
    __syncthreads();
    ++k;

    if (k % P.check_every == 0 || k >= P.cap) {
      // ---- divergence freeze (NaN-safe) and OSQP residuals ----
      bool big = false;
      for (int j = tid; j < NV; j += THREADS) {
        big |= !(fabsf(sm.x[j]) <= 1e12f) || !(fabsf(sm.yx[j]) <= 1e12f);
        sm.va[j] = sm.D[j] * sm.x[j];
      }
      for (int i = tid; i < NM; i += THREADS) {
        big |= !(fabsf(sm.yc[i]) <= 1e12f);
        sm.wa[i] = sm.E[i] * sm.yc[i];
      }
      __syncthreads();
      apply_A(sm, P, sm.va, sm.wb);       // A D x
      apply_AT(sm, P, sm.wa, sm.vb);      // A' E yc (ends with a sync)
      // m[0] r_prim, m[1] r_dual, m[2] scale_p, m[3] scale_d
      float m[4] = {0.f, 0.f, 0.f, 0.f};
      bool nan = false;
      for (int i = tid; i < NM; i += THREADS) {
        float e = sm.E[i], ax = e * sm.wb[i];
        float t0 = fabsf((ax - sm.zc[i]) / e), t1 = fabsf(ax / e), t2 = fabsf(sm.zc[i] / e);
        nan |= isnan(t0) || isnan(t1) || isnan(t2);
        m[0] = fmaxf(m[0], t0);
        m[2] = fmaxf(m[2], fmaxf(t1, t2));
      }
      for (int j = tid; j < NV; j += THREADS) {
        float d = sm.D[j], x = sm.x[j], aty = d * sm.vb[j];
        float t0 = fabsf(d * (x - sm.zx[j]));
        float t1 = fabsf((sm.Ps[j] * x + sm.qs[j] + aty + sm.yx[j]) / d);
        float t2 = fmaxf(fabsf(d * x), fabsf(d * sm.zx[j]));
        float t3 = fmaxf(fmaxf(fabsf(sm.Ps[j] * x / d), fabsf(sm.qs[j] / d)),
                         fmaxf(fabsf(aty / d), fabsf(sm.yx[j] / d)));
        nan |= isnan(t0) || isnan(t1) || isnan(t2) || isnan(t3);
        m[0] = fmaxf(m[0], t0);
        m[1] = fmaxf(m[1], t1);
        m[2] = fmaxf(m[2], t2);
        m[3] = fmaxf(m[3], t3);
      }
      block_max<4>(m, sm.red);
      bool any_big = block_any(big);
      bool any_nan = block_any(nan);
      rp = m[0];
      rd = m[1];
      bool conv = !any_nan && m[0] <= P.eps_abs + P.eps_rel * m[2] &&
                  m[1] <= P.eps_abs + P.eps_rel * m[3];
      if (tid == 0) sm.done = any_big ? 2 : (conv ? 1 : 0);
      __syncthreads();
    }
  }

  store<NV>(g.x + zo, sm.x);
  store<NV>(g.zx + zo, sm.zx);
  store<NV>(g.yx + zo, sm.yx);
  store<NM>(g.zc + mo, sm.zc);
  store<NM>(g.yc + mo, sm.yc);
  if (tid == 0) {
    g.done[b] = sm.done;
    g.iters[b] = k;
    g.rp[b] = rp;
    g.rd[b] = rd;
  }
}

}  // namespace

// ptrs: the NPTRS pointers of struct Ptrs, in its order; Dm: 16 floats.
extern "C" int mpc_structured_admm(void* const* ptrs, const float* Dm, float sigma, float alpha,
                                   float eps_abs, float eps_rel, int cap, int check_every,
                                   int B, void* stream) {
  if (B <= 0) return 0;
  Params P;
  for (int i = 0; i < KL * KL; ++i) P.Dm[i] = Dm[i];
  P.sigma = sigma;
  P.alpha = alpha;
  P.eps_abs = eps_abs;
  P.eps_rel = eps_rel;
  P.cap = cap;
  P.check_every = check_every;
  Ptrs g;
  memcpy(&g, ptrs, sizeof(Ptrs));
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(structured_admm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  structured_admm_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(P, g);
  return (int)cudaGetLastError();
}
