// Kernel 4: one chunk of dense boxADMM iterations of one QP per thread-block
// cluster of 8, over the explicit KKT inverse M^-1 (n x n) and the scaled
// constraint matrix A (m x n), both resident in the cluster's shared memory
// for the whole chunk.
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
// test (done = 1). A cluster stops at its own done, so used = iterations run.
//
// What bounds it: the passes over the two matrices, 4.4 MB per problem and
// iteration at n = 400, m = 488 with kkt_refine = 1. Streamed from device
// memory (the first design of this kernel) that is the whole cost; here
// each matrix is read from device memory once per launch. Block c of the
// cluster holds rows [c ra, (c+1) ra) of A and rows [c rn, (c+1) rn) of M^-1
// (ra = ceil(m/8), rn = ceil(n/8); the last slices may be short or empty),
// 177.6 KB at n = 400, m = 488. The m-length vectors live with the block
// that owns their rows and never leave it; the n-length vectors are
// replicated and every block updates them with the same instructions on the
// same values, so they stay bitwise equal across the cluster. What is left
// is the latency of an iteration's chain of products and exchanges, so:
//  * A v and the A'u that follows it are one pass over A: a warp takes two
//    rows at a time with the rows in its lanes' registers, forms ax, turns
//    it into u on the spot (a refinement step: rc ax; the last step: the
//    row's prox and dual update, then rc zc - yc for the next iteration)
//    and adds u times the row to its sums of A'u. An iteration passes twice
//    over A and twice over M^-1 instead of four and two times;
//  * exchanges through distributed shared memory are writes, not reads:
//    thread j writes entry j of its block's partial sums of A'u into row
//    `rank` of every block's `recv`, and the lanes that hold a finished
//    entry of M^-1 r write it into every block's copy of xt. After the
//    cluster barrier every block adds the 8 received rows in block order
//    from its own shared memory;
//  * xt alternates between two buffers so that a block may write the
//    refined xt while a slower block still reads the first;
//  * an iteration with kkt_refine = 1 has four cluster barriers (release on
//    arrive, acquire on wait: a relaxed arrive loses the remote writes). The
//    update of the replicated variables runs between the arrive and the
//    wait of the barrier that ends the iteration;
//  * at the path's size the shapes are compile-time constants, so every
//    shared vector sits at a constant offset.
// A check adds a barrier for the freeze flags and A'yc (read where they
// lie) and one for the residual maxima. Every block of a cluster takes the
// same done decision from the same exchanged values, and no block returns
// before all have passed the last barrier.
//
// Layouts (see kernels/admm_dense.py): M_inv (B,n,n), A (B,m,n), vectors
// (B,n) or (B,m) float32, done/used (B,) int32. The state is updated in
// place. Shared-memory rows are padded to n4 = n rounded up to 4 floats.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int T = 512;  // threads per block
constexpr int W = T / 32;
constexpr int CL = 8;         // blocks per cluster (the portable maximum)
constexpr int GMAX = 8;       // most row groups of cols_dot
constexpr int VREG = 4;       // float4 of a row that a lane keeps in registers
constexpr int NMAX = 128 * VREG;  // so a row has at most this many entries
constexpr float HARD = 1e20f;  // hard-row stand-in of the soft thresholds
constexpr float BIG = 1e12f;   // divergence freeze level
// what a block may use (232,448 B) less the kernel's static shared memory
constexpr int SMEM_LIMIT = 232448 - 512;

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

constexpr int NVEC_N = 15, NVEC_M = 9;  // shared vectors of length n4 / ra4

// slice heights, padded widths and the row groups of cols_dot
struct Geometry {
  int n4, nq, ra, rn, ra4, groups, smem;
};

__host__ __device__ inline Geometry geometry(int n, int m) {
  Geometry g;
  g.n4 = (n + 3) & ~3;
  g.nq = g.n4 / 4;
  g.ra = (m + CL - 1) / CL;
  g.rn = (n + CL - 1) / CL;
  g.ra4 = (g.ra + 3) & ~3;
  const int fit = T / g.nq;
  g.groups = fit > GMAX ? GMAX : fit;
  // the slices, the vectors, a row of partial sums per pair of warps and a
  // row of received partial sums per block of the cluster
  g.smem = ((g.ra + g.rn + NVEC_N + W / 2 + CL) * g.n4 + NVEC_M * g.ra4) * (int)sizeof(float);
  return g;
}

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

// The lane's quads of a vector of nq <= 32 VREG quads, zero past the end.
__device__ __forceinline__ void load_lane_quads(const float* v, int nq, float4 (&vr)[VREG]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < VREG; ++i) {
    const int c = lane + 32 * i;
    vr[i] = c < nq ? reinterpret_cast<const float4*>(v)[c] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Two butterfly sums over the warp for the price of one: lanes 0..15 end
// with the sum of d0 over all lanes, lanes 16..31 with that of d1, each the
// value the plain butterfly (offsets 16, 8, .., 1) gives.
__device__ __forceinline__ float warp_sum_pair(float d0, float d1) {
  const bool upper = (threadIdx.x & 16) != 0;
  float keep = upper ? d1 : d0;
  keep += __shfl_xor_sync(0xffffffffu, upper ? d0 : d1, 16);
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) keep += __shfl_xor_sync(0xffffffffu, keep, o);
  return keep;
}

// done(r, M[r, :] . v, lane % 16) for r < rows of a slice in shared memory:
// a warp takes two rows at a time, lanes across the column quads, the lane's
// part of v in registers; `done` runs on the 16 lanes that hold row r's sum.
// No barrier at the end.
template <typename Done>
__device__ __forceinline__ void rows_dot(const float* M, int rows, int nq, const float* v,
                                         Done done) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4* M4 = reinterpret_cast<const float4*>(M);
  float4 vr[VREG];
  load_lane_quads(v, nq, vr);
  for (int r0 = 2 * warp; r0 < rows; r0 += 2 * W) {
    const bool two = r0 + 1 < rows;
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int i = 0; i < VREG; ++i) {
      const int c = lane + 32 * i;
      if (c < nq) {
        d0 += dot4(M4[(size_t)r0 * nq + c], vr[i]);
        if (two) d1 += dot4(M4[(size_t)(r0 + 1) * nq + c], vr[i]);
      }
    }
    const float sum = warp_sum_pair(d0, d1);
    const int r = r0 + (lane >> 4);
    if (r < rows) done(r, sum, lane & 15);
  }
}

// The two passes over a slice that follow each other, in one: for each row r
// the product ax = M[r, :] . v, then u_r = row(r, ax) (on one lane), then
// part[c] = sum_r M[r, c] u_r with the row still in the
// lane's registers. A warp takes two rows at a time and keeps the sums of
// its rows' terms; warp w + W/2 hands its sums to warp w through `scr`, and
// out(c, part[c]) gets the W/2 pair sums added in warp order. No barrier at
// the end.
template <typename Row, typename Out>
__device__ __forceinline__ void rows_dot_then_cols(const float* M, int rows, int nq,
                                                   const float* v, float* scr, Row row,
                                                   Out out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4* M4 = reinterpret_cast<const float4*>(M);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 vr[VREG], sums[VREG];
  load_lane_quads(v, nq, vr);
#pragma unroll
  for (int i = 0; i < VREG; ++i) sums[i] = zero;
  for (int r0 = 2 * warp; r0 < rows; r0 += 2 * W) {
    const bool two = r0 + 1 < rows;
    float4 a0[VREG], a1[VREG];
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int i = 0; i < VREG; ++i) {
      const int c = lane + 32 * i;
      a0[i] = c < nq ? M4[(size_t)r0 * nq + c] : zero;
      a1[i] = (c < nq && two) ? M4[(size_t)(r0 + 1) * nq + c] : zero;
      if (c < nq) {
        d0 += dot4(a0[i], vr[i]);
        if (two) d1 += dot4(a1[i], vr[i]);
      }
    }
    // lane 0 holds the first row's product, lane 16 the second's
    const float sum = warp_sum_pair(d0, d1);
    const int r = r0 + (lane >> 4);
    float u = 0.f;
    if ((lane & 15) == 0 && r < rows) u = row(r, sum);
    const float u0 = __shfl_sync(0xffffffffu, u, 0), u1 = __shfl_sync(0xffffffffu, u, 16);
#pragma unroll
    for (int i = 0; i < VREG; ++i) {
      sums[i].x += a0[i].x * u0;
      sums[i].y += a0[i].y * u0;
      sums[i].z += a0[i].z * u0;
      sums[i].w += a0[i].w * u0;
      sums[i].x += a1[i].x * u1;
      sums[i].y += a1[i].y * u1;
      sums[i].z += a1[i].z * u1;
      sums[i].w += a1[i].w * u1;
    }
  }
  float4* mine = reinterpret_cast<float4*>(scr) + (warp % (W / 2)) * nq;
  if (warp >= W / 2) {
#pragma unroll
    for (int i = 0; i < VREG; ++i) {
      const int c = lane + 32 * i;
      if (c < nq) mine[c] = sums[i];
    }
  }
  __syncthreads();
  if (warp < W / 2) {
#pragma unroll
    for (int i = 0; i < VREG; ++i) {
      const int c = lane + 32 * i;
      if (c < nq) {
        const float4 o = mine[c];
        mine[c] = make_float4(sums[i].x + o.x, sums[i].y + o.y, sums[i].z + o.z, sums[i].w + o.w);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 4 * nq; j += T) {
    float s = scr[j];
#pragma unroll
    for (int w = 1; w < W / 2; ++w) s += scr[w * 4 * nq + j];
    out(j, s);
  }
}

// out(c, sum_r M[r, c] u[r]) over the rows of a slice in shared memory (where
// no product with the rows comes first: the first iteration's A'u and the
// check's A'yc): the rows in `groups` runs, a thread per (run, column quad),
// then the runs added in order. No barrier at the end.
template <typename Out>
__device__ __forceinline__ void cols_dot(const float* M, int rows, int nq, int groups,
                                         const float* u, float* scr, Out out) {
  const float4* M4 = reinterpret_cast<const float4*>(M);
  float4* scr4 = reinterpret_cast<float4*>(scr);
  const int per = (rows + groups - 1) / groups;
  for (int item = threadIdx.x; item < nq * groups; item += T) {
    const int q = item % nq, grp = item / nq;
    const int r0 = grp * per, r1 = min(rows, r0 + per);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const float4 a = M4[(size_t)r * nq + q];
      const float ur = u[r];
      acc.x += a.x * ur;
      acc.y += a.y * ur;
      acc.z += a.z * ur;
      acc.w += a.w * ur;
    }
    scr4[grp * nq + q] = acc;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 4 * nq; j += T) {
    float s = scr[j];
    for (int grp = 1; grp < groups; ++grp) s += scr[grp * 4 * nq + j];
    out(j, s);
  }
}

// Barrier of all threads of the cluster; what they wrote before it, into
// their own or another block's shared memory, is visible after it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// sum over the cluster's blocks, in block order, of entry j of their `part`,
// read from where it lies
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster, float* part, int j) {
  float s = cluster.map_shared_rank(part, 0)[j];
#pragma unroll
  for (int c = 1; c < CL; ++c) s += cluster.map_shared_rank(part, c)[j];
  return s;
}

// the same sum of what the blocks have written into this block's `recv`
__device__ __forceinline__ float received_sum(const float* recv, int n4, int j) {
  float s = recv[j];
#pragma unroll
  for (int c = 1; c < CL; ++c) s += recv[c * n4 + j];
  return s;
}

// rows of a slice of a row-major (.., n) matrix into shared memory rows of
// n4 floats (16-byte copies when every row starts on a 16-byte boundary)
__device__ __forceinline__ void load_slice(float* dst, const float* src, int rows, int n, int n4,
                                           bool vec4) {
  if (vec4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int e = threadIdx.x; e < rows * (n4 / 4); e += T)
      __pipeline_memcpy_async(d4 + e, s4 + e, sizeof(float4));
    __pipeline_commit();
  } else {
    for (int e = threadIdx.x; e < rows * n4; e += T) {
      const int r = e / n4, c = e % n4;
      dst[e] = c < n ? src[(size_t)r * n + c] : 0.f;
    }
  }
}

// SN, SM: the problem size when it is known at compile time (the shared
// vectors then sit at constant offsets and the loops over them unroll), or 0
// for the size in p.
template <int SN, int SM>
__global__ void __launch_bounds__(T, 1) admm_dense_kernel(Ptrs g, Params p) {
  extern __shared__ float4 smem4[];
  __shared__ float red[W * 4];
  __shared__ float c_res[4];  // this block's residual maxima, read by the cluster
  __shared__ float s_res[4];  // the cluster's
  __shared__ int c_big;       // this block's freeze flag, read by the cluster
  __shared__ int s_big;       // the cluster's
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CL, tid = threadIdx.x, lane = tid & 31;
  const int n = SN > 0 ? SN : p.n, m = SM > 0 ? SM : p.m;
  const Geometry geo = geometry(n, m);
  const int n4 = geo.n4, nq = geo.nq, ra4 = geo.ra4;
  // this block's rows of A and of M^-1
  const int a0 = rank * geo.ra, na = max(0, min(geo.ra, m - a0));
  const int j0 = rank * geo.rn, nj = max(0, min(geo.rn, n - j0));

  float* s = reinterpret_cast<float*>(smem4);
  float *As = s, *Ms = As + geo.ra * n4, *vecs = Ms + geo.rn * n4;
  float *x = vecs, *zx = x + n4, *yx = zx + n4, *P = yx + n4, *q = P + n4, *lx = q + n4,
        *ux = lx + n4, *rx = ux + n4, *D = rx + n4, *thx = D + n4, *r = thx + n4, *t = r + n4,
        *xt0 = t + n4, *xt1 = xt0 + n4, *chk = xt1 + n4, *scr = chk + n4,
        *recv = scr + (W / 2) * n4;
  float *zc = recv + CL * n4, *yc = zc + ra4, *lc = yc + ra4, *uc = lc + ra4,
        *rc = uc + ra4, *E = rc + ra4, *thr = E + ra4, *ax = thr + ra4, *u = ax + ra4;

  const size_t on = (size_t)b * n, om = (size_t)b * m + a0;
  const bool vec4 = p.vec4 != 0;
  const float sigma = p.sigma, alpha = p.alpha;
  int done = g.done[b];  // the same value in every thread of the cluster

  // pad entries stay zero: they meet the matrices' pad columns in the products
  for (int e = tid; e < (NVEC_N + W / 2 + CL) * n4 + NVEC_M * ra4; e += T) vecs[e] = 0.f;
  __syncthreads();
  if (done == 0) {
    load_slice(As, g.A + ((size_t)b * m + a0) * n, na, n, n4, vec4);
    load_slice(Ms, g.Minv + ((size_t)b * n + j0) * n, nj, n, n4, vec4);
  }
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
  for (int i = tid; i < na; i += T) {
    zc[i] = g.zc[om + i];
    yc[i] = g.yc[om + i];
    lc[i] = g.lc[om + i];
    uc[i] = g.uc[om + i];
    rc[i] = g.rc[om + i];
    E[i] = g.E[om + i];
    thr[i] = fminf(g.sc[om + i], HARD * rc[i]) / rc[i];
  }
  __pipeline_wait_prior(0);
  // from here on other blocks write into this one's `recv` and xt buffers
  cluster_sync();

  // of the 16 lanes that hold a finished entry of xt, lane l < CL writes it
  // into block l's buffers
  float* xt0_to = cluster.map_shared_rank(xt0, lane % CL);
  float* xt1_to = cluster.map_shared_rank(xt1, lane % CL);

  // thread j adds entry j of this block's partial sums of A'u to the other
  // blocks' through their `recv`
  auto push_part = [&](int j, float sum) {
#pragma unroll
    for (int c = 0; c < CL; ++c) cluster.map_shared_rank(recv, c)[rank * n4 + j] = sum;
  };
  // ---- relaxed update and box prox of the variables ----
  auto update_variables = [&](const float* xt) {
    for (int j = tid; j < n; j += T) {
      const float xtj = xt[j];
      x[j] = ftz(alpha * xtj + (1.f - alpha) * x[j]);
      const float za = alpha * xtj + (1.f - alpha) * zx[j];
      const float zn = ftz(soft_prox(za + yx[j] / rx[j], lx[j], ux[j], thx[j]));
      yx[j] = ftz(yx[j] + rx[j] * (za - zn));
      zx[j] = zn;
    }
  };
  // With an odd kkt_refine the last xt lies in the buffer that the next
  // iteration fills last, so the variables can be updated while the barrier
  // that follows the pass over A completes; with an even one they must be
  // done before this block arrives at it.
  const bool overlap = (p.kkt_refine & 1) != 0;

  // the first iteration's A'(rc zc - yc); later ones come out of the pass
  // over A that ends the iteration before
  if (done == 0) {
    for (int i = tid; i < na; i += T) u[i] = rc[i] * zc[i] - yc[i];
    __syncthreads();
    cols_dot(As, na, nq, geo.groups, u, scr, push_part);
  }
  cluster_arrive();

  int k = 0;
  while (k < p.chunk_iters && done == 0) {
    // ---- x-update: r, xt = M^-1 r, then the refinement steps; each ends
    // with the pass over A that gives ax and the next A'u ----
    float* xt = xt0;  // the buffer that holds the newest xt
    for (int st = 0; st <= p.kkt_refine; ++st) {
      const bool last = st == p.kkt_refine;
      float* prev = xt;
      xt = (st & 1) ? xt1 : xt0;
      float* xt_to = (st & 1) ? xt1_to : xt0_to;
      cluster_wait();  // every block's partial sums of A'u have arrived
      float* v = st == 0 ? r : t;
      for (int j = tid; j < n; j += T) {
        const float atu = received_sum(recv, n4, j);
        v[j] = st == 0 ? (sigma * x[j] - q[j] + (rx[j] * zx[j] - yx[j])) + atu
                       : r[j] - (P[j] + sigma + rx[j]) * prev[j] - atu;
      }
      __syncthreads();
      rows_dot(Ms, nj, nq, v, [&](int row, float acc, int l16) {
        const float val = st == 0 ? acc : prev[j0 + row] + acc;
        if (l16 < CL) xt_to[j0 + row] = val;
      });
      cluster_sync();  // xt is whole in every block
      // ax = A xt row by row; a refinement step goes on with A'(rc ax), the
      // last step with the soft-row prox and dual update of the row and the
      // next iteration's A'(rc zc - yc)
      rows_dot_then_cols(As, na, nq, xt, scr, [&](int i, float axi) {
        if (!last) return rc[i] * axi;
        const float za = alpha * axi + (1.f - alpha) * zc[i];
        const float zn = ftz(soft_prox(za + yc[i] / rc[i], lc[i], uc[i], thr[i]));
        const float yn = ftz(yc[i] + rc[i] * (za - zn));
        zc[i] = zn;
        yc[i] = yn;
        return rc[i] * zn - yn;
      }, push_part);
      if (last && !overlap) update_variables(xt);
      cluster_arrive();
      if (last && overlap) update_variables(xt);
    }
    ++k;

    if (k % p.check_every == 0 || k >= p.chunk_iters) {
      cluster_wait();
      __syncthreads();  // the updated iterates; `scr` is free
      // ---- freeze on divergence over the shared variable/row index axis:
      // this block's rows, and in block 0 the variables past the last row ----
      bool big = false;
      for (int ii = tid; ii < na; ii += T) {
        const int i = a0 + ii;
        float a = (i < n ? fabsf(x[i]) : 0.f) + fabsf(yc[ii]);
        a += i < n ? fabsf(yx[i]) : 0.f;
        big |= !(a <= BIG);
      }
      if (rank == 0)
        for (int i = m + tid; i < n; i += T) big |= !(fabsf(x[i]) + fabsf(yx[i]) <= BIG);
      const int any_big = __syncthreads_or(big ? 1 : 0);
      if (tid == 0) c_big = any_big;
      cols_dot(As, na, nq, geo.groups, yc, scr,  // this block's part of A' yc
               [&](int j, float sum) { chk[j] = sum; });
      rows_dot(As, na, nq, x, [&](int row, float acc, int l16) {  // its rows of A x
        if (l16 == 0) ax[row] = acc;
      });
      cluster_sync();
      if (tid == 0) {
        int any = 0;
        for (int c = 0; c < CL; ++c) any |= *cluster.map_shared_rank(&c_big, c);
        s_big = any;
      }
      __syncthreads();
      if (s_big) {
        done = 2;
      } else {
        // ---- OSQP residuals in unscaled units ----
        for (int j = tid; j < n; j += T) t[j] = cluster_sum(cluster, chk, j);
        __syncthreads();
        // v[0] r_prim, v[1] r_dual, v[2] scale_p, v[3] scale_d
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        for (int i = tid; i < na; i += T) {
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
        if (tid < 4) c_res[tid] = v[tid];
        cluster_sync();
        if (tid < 4) {
          float w = cluster.map_shared_rank(c_res, 0)[tid];
          for (int c = 1; c < CL; ++c) w = nmax(w, cluster.map_shared_rank(c_res, c)[tid]);
          s_res[tid] = w;
        }
        __syncthreads();
        const bool conv = s_res[0] <= p.eps_abs + p.eps_rel * s_res[2] &&
                          s_res[1] <= p.eps_abs + p.eps_rel * s_res[3];
        done = conv ? 1 : 0;
      }
      cluster_arrive();
    }
  }
  // the barrier the loop left open; after it no block reads another's memory
  cluster_wait();

  if (rank == 0) {
    for (int j = tid; j < n; j += T) {
      g.x[on + j] = x[j];
      g.zx[on + j] = zx[j];
      g.yx[on + j] = yx[j];
    }
    if (tid == 0) {
      g.done[b] = done;
      g.used[b] = k;
    }
  }
  for (int i = tid; i < na; i += T) {
    g.zc[om + i] = zc[i];
    g.yc[om + i] = yc[i];
  }
}

using Kernel = void (*)(Ptrs, Params);

// the instantiation for the planner's QP size, or the one for any size
Kernel kernel_for(int n, int m) {
  return (n == mpc::NV && m == mpc::NM) ? admm_dense_kernel<mpc::NV, mpc::NM>
                                        : admm_dense_kernel<0, 0>;
}

cudaError_t configure(int n, int m, int B, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  const Geometry geo = geometry(n, m);
  if (n <= 0 || n > NMAX || m <= 0 || geo.smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)B * CL);
  cfg->blockDim = dim3(T);
  cfg->dynamicSmemBytes = geo.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Called once when the library is loaded: both instantiations may use up to
// SMEM_LIMIT bytes of dynamic shared memory, the most configure() lets a
// launch ask for (a launch sets nothing, so it can be captured into a CUDA
// graph as it is).
extern "C" int mpc_admm_dense_init() {
  cudaError_t err = cudaFuncSetAttribute(admm_dense_kernel<mpc::NV, mpc::NM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(admm_dense_kernel<0, 0>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  return (int)err;
}

// ptrs: the NPTRS pointers of struct Ptrs, in its order. Returns
// cudaErrorInvalidValue (1) for an (n, m) whose slices and vectors do not
// fit a block's shared memory.
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
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(n, m, B, static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel_for(n, m), g, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The cluster size, the dynamic shared memory of one block at (n, m), and
// how many clusters the card runs at a time (cudaOccupancyMaxActiveClusters).
// Returns 0 or a CUDA error.
extern "C" int mpc_admm_dense_occupancy(int n, int m, int* cluster_size, int* smem_bytes,
                                        int* active_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = (cudaError_t)mpc_admm_dense_init();
  if (err == cudaSuccess) err = configure(n, m, 1, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  *cluster_size = CL;
  *smem_bytes = (int)cfg.dynamicSmemBytes;
  return (int)cudaOccupancyMaxActiveClusters(active_clusters, kernel_for(n, m), &cfg);
}
