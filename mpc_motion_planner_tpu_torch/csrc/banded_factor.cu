// Kernel 2: block-banded Cholesky + arrow factorization of the node-major
// ADMM KKT matrix M = A'WA + diag(sigma), one problem per 128-thread block,
// several blocks per SM.
//
// Replaces mpc_motion_planner_tpu/ops/pallas/banded_factor.py
// factor_banded_pallas (_factor_kernel :117, _chol_lane :83,
// _tri_inv_lane :100). Same recursion and numerical guards: per node k the
// band Schur update S = M[k,k] - sum L[k,j] L[k,j]', a column-by-column
// Cholesky with the 1e-20 pivot floor, the forward-substitution inverse of
// L[k,k], the sub-diagonal blocks L[k+d,k] = (M[k+d,k] - sum ...) L[k,k]^-T,
// then the banded solve for the arrow column u and the Schur scalar s.
// Every computed entry is clamped to +-1e8 (after each block product, not
// once at the end), and ok is cleared by a pivot or s at or below 1e-20 or
// by any factor entry at or above 0.99e8.
//
// What bounds it: the latency of an N-step dependent recursion (N = 19
// nodes: ~2 MFLOP and 268 KB per problem, little for the card; the build
// sets N, see common.cuh). So the design keeps a
// problem small enough for several to share an SM and hide each other's
// waits, and takes the sequential parts out of block-wide barrier loops:
//  * node k reads only L[., j] for j >= k - BW (BW = the band width, the
//    spline order), so shared memory holds a ring of the last BW nodes'
//    sub-diagonal blocks (~34 KB a block in all at BW = 3 instead of the
//    whole 134 KB factor). Ldi[k] and Lsub[k] go to device memory as soon
//    as they are final, and the saturation scan happens as they are written;
//  * the BLK x BLK Cholesky (21 x 21 for the Panda) and the triangular
//    inverse run in one warp with row r (then column c) of the block in
//    lane r's registers, the pivot column passed through shared memory: no
//    block-wide barrier inside. A warp has 32 lanes, so past BLK = 32 (11
//    joints and more) a lane owns ROWS = ceil(BLK / 32) rows (columns), r,
//    r + 32, ...: each entry is formed by the same operations in the same
//    order whoever owns it, and at ROWS = 1 the code is that of one row a
//    lane.
//    Meanwhile the other three warps form what node k + 1 needs from older
//    nodes (the j < k products of its S and of its first sub-diagonal
//    block) and the arrow column's forward-substitution sum for node k;
//  * a node is three phases and three barriers: (A) that; (B) the BW
//    products with Ldi[k]' and ys[k]; (C) the j = k products of node k + 1,
//    and its sub-diagonal blocks M[k+1+d,k+1], d >= 2, less all their
//    band products;
//  * only the backward sweep for u reads factors again, newest first, four
//    nodes at a time out of L2 where the block has just written them.
// Each entry is formed by the TPU kernel's operations in their order (every
// block product subtracted and clamped on its own, in the order of j, the
// Cholesky column by column), whatever phase forms it, so the guards flag
// the same problems.
//
// Layout (see kernels/banded_factor.py), BLK = 21 for the Panda: Mband
// (B,N,BW+1,BLK,BLK) with Mband[b,k,d] = M[k+d,k]; outputs Ldi (B,N,BLK,BLK)
// = L[k,k]^-1, Lsub (B,N,BW,BLK,BLK) with Lsub[b,k,d-1] = L[k+d,k], u
// (B,N,BLK), s (B,), ok (B,) int.
//
// The node count enters only loop bounds, strides and the two N x BLK
// vectors ys and us: the working set is per node (the ring and CH staged
// nodes), so a build per transcription keeps six problems per SM up to 44
// nodes of the Panda at BW = 3 (ys and us are 168 B per node beside the
// ~30 KB of the rest). The joint count sets BLK and the band width the
// ring: the working set grows with BLK^2 (25,060 B at 6 joints, 42,964 B at
// 8, 19 nodes) and with BW^2 (24,508 B at BW = 2, 19 nodes; 47,356 B at
// BW = 4, 17 nodes; 64,828 B at BW = 5, 16 nodes), and PER_SM, the
// problems per SM the registers are capped for, follows from it below.
//
// Where that block does not fit a block's shared memory (20 and 21 joints
// at 19 nodes: 254,196 and 279,996 B), the build reads the ring from device
// memory instead (-DMPC_FACTOR_RING=1, kernels/banded_factor.py
// choose_ring): node k's products read L[k, j], j = k - BW .. k - 1, where
// phase B of node j wrote it to Lsub, by ordinary loads after the
// block-wide barriers between (never through the read-only path: the block
// writes these blocks itself); the forward loop keeps no ring, and the
// backward sweep stages CH nodes, as many as the forward loop's blocks leave
// room for (two at 20 and 21 joints: 124,596 and 137,112 B). Each entry is
// formed by the same operations in the same order from the same values, so
// both builds give the same factors, bitwise, where both fit.
//
// Past 28 joints the device ring's block does not fit either (238,964 B at
// 28 joints and 19 nodes, 309,908 B at 32): its forward loop keeps LkT and
// seven blocks (S[2], C[BW + 1], Linv), 36,864 B each at 32 joints. The
// scratch build (-DMPC_FACTOR_RING=2) keeps LkT, S[2] and the two C[d = 1]
// alone: warp 0 writes the inverse of L[k,k] straight to its place in Ldi,
// and C[d] of node k for d >= 2 (M[k+d,k] less its band products, formed in
// phase C of node k - 1 and read in phase B of node k) lies in Ldi's block
// of node k + d, which node k + d's inverse overwrites only in its own phase
// A, after every C that lies there has been read: at most one C lives in a
// block at a time (those of node k and k' > k in the same block are apart
// by phase B of node k). Both are read back by ordinary loads after the
// block-wide barriers, as the device ring's blocks are; the backward sweep
// stages one node (199,316 B at 32 joints). Same operations, order and
// values: the device ring's factors, bitwise, where both fit.

#include <type_traits>

#include "common.cuh"

using namespace mpc;

namespace {

#ifndef MPC_FACTOR_RING
#define MPC_FACTOR_RING 0
#endif
constexpr int NT = 128;  // threads per block
constexpr int NWARP = NT / 32;
constexpr int LKS = (BLK + 3) / 4 * 4;  // stride of a column of L[k,k] (16-byte loads)
constexpr int ROWS = (BLK + 31) / 32;   // rows (columns) of a block a lane owns
// the ring of the last BW nodes' blocks: in shared memory, or (1) read back
// from device memory where the block wrote them; (2) so too, with the
// inverse of L[k,k] and C[d] for d >= 2 in Ldi (the scratch build)
constexpr bool DEVICE_RING = MPC_FACTOR_RING >= 1;
constexpr bool SCRATCH = MPC_FACTOR_RING == 2;
constexpr float MAG = 1e8f;
constexpr float SAT = 0.99f * MAG;
constexpr float PIV_FLOOR = 1e-20f;
static_assert(BW >= 1, "a band has at least one sub-diagonal block");
static_assert(LKS <= 32 * ROWS, "one warp holds ROWS rows of L[k,k] per lane");

__device__ __forceinline__ float fz(float v) { return clampf(v, -MAG, MAG); }

struct SharedRing {
  float LkT[BLK * LKS];      // L[k,k], column j at LkT[j * LKS]
  float ring[BW][BW][BLK2];  // ring[j % BW][d - 1] = L[j+d, j] of the last BW nodes
  float S[2][BLK2];          // Schur complement of node k and, in the making, of k + 1
  // M[k+d,k] less its band products: C[0], C[1] for d = 1 (node k's and, in
  // the making, node k + 1's), C[d] for d = 2..BW
  float C[BW + 1][BLK2];
  float Linv[BLK2];          // Ldi[k]
};
// the same without the ring, which lies in Lsub in device memory
struct DeviceRing {
  float LkT[BLK * LKS];
  float S[2][BLK2];
  float C[BW + 1][BLK2];
  float Linv[BLK2];
};
// the scratch build's: LkT, S and C for d = 1 (C[d] for d >= 2 and the
// inverse lie in Ldi in device memory)
struct ScratchRing {
  float LkT[BLK * LKS];
  float S[2][BLK2];
  float C[2][BLK2];
};
using Forward = std::conditional_t<SCRATCH, ScratchRing,
                                   std::conditional_t<DEVICE_RING, DeviceRing, SharedRing>>;

// nodes staged per step of the backward sweep: 4, or (device ring) as many
// as the forward loop's blocks leave room for, 1 to 4
constexpr int STAGED = (int)(sizeof(Forward) / 4) / ((BW + 1) * BLK2);
constexpr int CH = !DEVICE_RING ? 4 : STAGED < 1 ? 1 : STAGED > 4 ? 4 : STAGED;

struct Backward {
  float blk[CH][BW + 1][BLK2];  // per staged node: Ldi, then its BW Lsub blocks
};

struct Smem {
  union {
    Forward f;
    Backward b;
  };
  float ys[N * BLK];
  float us[N * BLK];
  float tmp[32 * ROWS];
  float red[NWARP];
  int ok;
};

// Problems per SM the registers are capped for (__launch_bounds__): as many
// as the SM's shared memory holds (228 KB, 1 KB of it reserved per block)
// and its 2048 threads hold (16 blocks, at one joint), and no more than
// leave a thread the registers of the warp-wide Cholesky
// and inverse: its rows of the block (ROWS BLK), a staged column and the
// inverse's accumulator row (LKS each) and ~11 for addresses and loop state,
// in units of 8 (80 for the Panda: 6 problems per SM; 7 at 6 joints, 5 at
// 8; 160 at 12 joints, where the shared memory allows 2).
constexpr int SM_SMEM = 233472;
constexpr int REGS = (2 * LKS + ROWS * BLK + 11 + 7) / 8 * 8;
constexpr int BY_SMEM = SM_SMEM / ((int)sizeof(Smem) + 1024);
constexpr int BY_REGS = 65536 / (NT * REGS);
constexpr int BY_THREADS = 2048 / NT;
constexpr int PER_SM_SR = BY_SMEM < BY_REGS ? BY_SMEM : BY_REGS;
constexpr int PER_SM = PER_SM_SR < BY_THREADS ? PER_SM_SR : BY_THREADS;
static_assert(PER_SM >= 1, "one block of kernel 2 fits an SM");

// v - sum_c X[a,c] Y[b,c], clamped after the product (the TPU kernel's
// _fz(S - _matmul_nt(...)))
__device__ __forceinline__ float sub_nt(float v, const float* X, const float* Y, int a, int b) {
  float acc = 0.f;
#pragma unroll (NQ)
  for (int c = 0; c < BLK; ++c) acc += X[a * BLK + c] * Y[b * BLK + c];
  return fz(v - acc);
}

// Entries c0.. of an LKS-float column in shared memory, as 16-byte loads of
// the quads that hold them.
template <int C0>
__device__ __forceinline__ void load_column(const float* col, float (&out)[LKS]) {
#pragma unroll
  for (int q = C0 / 4; q < LKS / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(col)[q];
    out[4 * q] = v.x;
    out[4 * q + 1] = v.y;
    out[4 * q + 2] = v.z;
    out[4 * q + 3] = v.w;
  }
}

// Column J of the Cholesky factor and the rank-1 update of the columns to
// its right, lane r on rows r + 32 j (Sr[j]); then column J + 1.
template <int J>
__device__ __forceinline__ void chol_column(float (&Sr)[ROWS][BLK], float* LkT, int lane,
                                            bool& ok) {
  const float d2 = __shfl_sync(0xffffffffu, Sr[J / 32][J], J % 32);
  const float d = sqrtf(d2 > PIV_FLOOR ? d2 : PIV_FLOOR);
  float v[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int r = lane + 32 * j;
    v[j] = (r < BLK && r >= J) ? fz(Sr[j][J] / d) : 0.f;
    if (r < LKS) LkT[J * LKS + r] = v[j];
  }
  ok = ok && d2 > PIV_FLOOR;
  __syncwarp();
  if constexpr (J + 1 < BLK) {
    float col[LKS];
    load_column<J + 1>(LkT + J * LKS, col);
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
#pragma unroll
      for (int c = J + 1; c < BLK; ++c) Sr[j][c] = fz(Sr[j][c] - v[j] * col[c]);
    chol_column<J + 1>(Sr, LkT, lane, ok);
  }
}

// Row Q of the inverse by forward substitution, lane c on columns c + 32 j
// (acc[j]), and its term of the sums of the rows below; then row Q + 1.
template <int Q>
__device__ __forceinline__ void inverse_column(float (&acc)[ROWS][BLK], const float* LkT,
                                               float* Linv, int lane) {
  float col[LKS];
  load_column<Q>(LkT + Q * LKS, col);
  float x[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int c = lane + 32 * j;
    x[j] = fz(((Q == c ? 1.f : 0.f) - acc[j][Q]) / col[Q]);
    if (c < BLK) Linv[Q * BLK + c] = x[j];
  }
  if constexpr (Q + 1 < BLK) {
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
#pragma unroll
      for (int i = Q + 1; i < BLK; ++i) acc[j][i] += col[i] * x[j];
    inverse_column<Q + 1>(acc, LkT, Linv, lane);
  }
}

// One warp: the Cholesky factor of S into LkT, then its inverse into Linv.
// Returns false on every lane if a pivot was at or below the floor.
__device__ __forceinline__ bool chol_inverse(const float* S, float* LkT, float* Linv, int lane) {
  float Sr[ROWS][BLK];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int r = lane + 32 * j;
#pragma unroll
    for (int c = 0; c < BLK; ++c) Sr[j][c] = r < BLK ? S[r * BLK + c] : 0.f;
  }
  bool ok = true;
  chol_column<0>(Sr, LkT, lane, ok);
  float acc[ROWS][BLK];
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
#pragma unroll
    for (int i = 0; i < BLK; ++i) acc[j][i] = 0.f;
  inverse_column<0>(acc, LkT, Linv, lane);
  return ok;
}

// L[i, j] of the last BW nodes j: in the ring, or (device ring) where phase
// B of node j wrote it to the problem's Lsub.
template <class F>
__device__ __forceinline__ float* ring_block(F& f, float* Lsub_b, int i, int j) {
  if constexpr (DEVICE_RING) return Lsub_b + (j * BW + i - j - 1) * BLK2;
  else return f.ring[j % BW][i - j - 1];
}

// C[d] of node k for d >= 2: in shared memory, or (scratch) in Ldi's block
// of node k + d.
template <class F>
__device__ __forceinline__ float* c_far(F& f, float* Ldi_b, int d, int k) {
  if constexpr (SCRATCH) return Ldi_b + (k + d) * BLK2;
  else return f.C[d];
}

// The inverse of L[k,k]: in shared memory, or (scratch) in its place in Ldi.
template <class F>
__device__ __forceinline__ float* linv_of(F& f, float* Ldi_b, int k) {
  if constexpr (SCRATCH) return Ldi_b + k * BLK2;
  else return f.Linv;
}

// Ldi, Lsub and the pointers that the block writes and later reads back are
// not __restrict__: the backward sweep must see the forward loop's stores.
__global__ void __launch_bounds__(NT, PER_SM)
banded_factor_kernel(const float* __restrict__ Mband, const float* __restrict__ p_col,
                     const float* __restrict__ m_pp, float* Ldi_out, float* Lsub_out,
                     float* __restrict__ u_out, float* __restrict__ s_out,
                     int* __restrict__ ok_out) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  Forward& f = sm.f;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* Mb = Mband + (size_t)b * N * (BW + 1) * BLK2;
  const float* pc = p_col + (size_t)b * N * BLK;
  float* Ldi_b = Ldi_out + (size_t)b * N * BLK2;
  float* Lsub_b = Lsub_out + (size_t)b * N * BW * BLK2;
  // M[i, j] for i - j <= BW, and L[i, j] for the last BW nodes j (device
  // ring: where phase B of node j wrote it)
  auto Mblk = [&](int i, int j) { return Mb + (j * (BW + 1) + (i - j)) * BLK2; };
  auto L = [&](int i, int j) { return ring_block(f, Lsub_b, i, j); };
  auto Cfar = [&](int d, int k) { return c_far(f, Ldi_b, d, k); };
  auto Linv = [&](int k) { return linv_of(f, Ldi_b, k); };
  bool sat = false;

  if (tid == 0) sm.ok = 1;
  for (int e = tid; e < BLK2; e += NT) {
    f.S[0][e] = Mblk(0, 0)[e];
    f.C[0][e] = Mblk(1, 0)[e];
    for (int d = 2; d <= BW; ++d) Cfar(d, 0)[e] = Mblk(d, 0)[e];
  }
  __syncthreads();

  for (int k = 0; k < N; ++k) {
    const int cur = k & 1, nxt = cur ^ 1;
    // ---- phase A: warp 0 factors S and inverts L[k,k]; the others form
    // what needs no L[., k]: the arrow column's sum and node k + 1's older
    // products ----
    if (warp == 0) {
      if (!chol_inverse(f.S[cur], f.LkT, Linv(k), lane) && lane == 0) sm.ok = 0;
    } else {
      if (warp == 1) {
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          const int r = lane + 32 * j;
          float acc = r < BLK ? pc[k * BLK + r] : 0.f;
          for (int d = 1; d <= min(BW, k); ++d) {
            const float* Lkd = L(k, k - d);
            const float* y = sm.ys + (k - d) * BLK;
            float s = 0.f;
            if (r < BLK)
              for (int c = 0; c < BLK; ++c) s += Lkd[r * BLK + c] * y[c];
            acc -= s;
          }
          sm.tmp[r] = acc;
        }
      }
      if (k + 1 < N) {
        for (int e = tid - 32; e < BLK2; e += NT - 32) {
          const int a = e / BLK, c = e % BLK;
          float v = Mblk(k + 1, k + 1)[e];
          for (int j = max(0, k + 1 - BW); j < k; ++j)
            v = sub_nt(v, L(k + 1, j), L(k + 1, j), a, c);
          f.S[nxt][e] = v;
          if (k + 2 < N) {
            v = Mblk(k + 2, k + 1)[e];
            for (int j = max(0, k + 2 - BW); j < k; ++j)
              v = sub_nt(v, L(k + 2, j), L(k + 1, j), a, c);
            f.C[nxt][e] = v;
          }
        }
      }
    }
    __syncthreads();

    // ---- phase B: L[k+d,k] = C_d Ldi[k]' into the ring and out, Ldi[k]
    // out, ys[k] = Ldi[k] (p[k] - sum) ----
    const float* Li = Linv(k);
    if (warp == NWARP - 1) {
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int r = lane + 32 * j;
        if (r < BLK) {
          float s = 0.f;
          for (int c = 0; c < BLK; ++c) s += Li[r * BLK + c] * sm.tmp[c];
          sm.ys[k * BLK + r] = fz(s);
        }
      }
    }
    for (int d = 1; d <= BW; ++d) {
      float* gout = Lsub_b + (k * BW + d - 1) * BLK2;
      float* out = L(k + d, k);  // the ring's place of the block (device ring: gout)
      const float* C = d == 1 ? f.C[cur] : Cfar(d, k);
      for (int e = tid; e < BLK2; e += NT) {
        float v = 0.f;
        if (k + d < N) {
          const int a = e / BLK, c = e % BLK;
          float acc = 0.f;
#pragma unroll (NQ)
          for (int q = 0; q < BLK; ++q) acc += C[a * BLK + q] * Li[c * BLK + q];
          v = fz(acc);
        }
        if constexpr (!DEVICE_RING) out[e] = v;
        gout[e] = v;
        sat |= !(fabsf(v) < SAT);
      }
    }
    for (int e = tid; e < BLK2; e += NT) {
      const float v = Li[e];
      if constexpr (!SCRATCH) Ldi_b[k * BLK2 + e] = v;
      sat |= !(fabsf(v) < SAT);
    }
    __syncthreads();

    // ---- phase C: node k + 1's products with L[., k]; its blocks M[k+1+d,
    // k+1] for d >= 2 (every band product, j in order) ----
    if (k + 1 < N) {
      for (int e = tid; e < BLK2; e += NT) {
        const int a = e / BLK, c = e % BLK;
        f.S[nxt][e] = sub_nt(f.S[nxt][e], L(k + 1, k), L(k + 1, k), a, c);
        if (BW >= 2 && k + 2 < N)
          f.C[nxt][e] = sub_nt(f.C[nxt][e], L(k + 2, k), L(k + 1, k), a, c);
        for (int d = 2; d <= BW; ++d) {
          if (k + 1 + d >= N) break;
          float v = Mblk(k + 1 + d, k + 1)[e];
          for (int j = max(0, k + 1 + d - BW); j <= k; ++j)
            v = sub_nt(v, L(k + 1 + d, j), L(k + 1, j), a, c);
          Cfar(d, k + 1)[e] = v;
        }
      }
    }
    __syncthreads();
  }

  // ---- backward sweep L' u = ys, newest node first: the block stages CH
  // nodes' factors from where it wrote them, warp 0 takes their steps with
  // lane r owning row r (and r + 32 past 32 rows) ----
  __threadfence_block();
  for (int top = N - 1; top >= 0; top -= CH) {
    const int cnt = min(CH, top + 1);
    for (int i = 0; i < cnt; ++i) {
      const int k = top - i;
      for (int e = tid; e < BLK2; e += NT) sm.b.blk[i][0][e] = Ldi_b[k * BLK2 + e];
      for (int e = tid; e < BW * BLK2; e += NT) sm.b.blk[i][1][e] = Lsub_b[k * BW * BLK2 + e];
    }
    __syncthreads();
    if (warp == 0) {
      for (int i = 0; i < cnt; ++i) {
        const int k = top - i;
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          const int r = lane + 32 * j;
          float acc = r < BLK ? sm.ys[k * BLK + r] : 0.f;
          for (int d = 1; d <= min(BW, N - 1 - k); ++d) {
            const float* Ld = sm.b.blk[i][d];
            const float* x = sm.us + (k + d) * BLK;
            float s = 0.f;
            if (r < BLK)
              for (int c = 0; c < BLK; ++c) s += Ld[c * BLK + r] * x[c];
            acc -= s;
          }
          sm.tmp[r] = acc;
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          const int r = lane + 32 * j;
          if (r < BLK) {
            float s = 0.f;
            for (int c = 0; c < BLK; ++c) s += sm.b.blk[i][0][c * BLK + r] * sm.tmp[c];
            sm.us[k * BLK + r] = fz(s);
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }

  // ---- s = m_pp - u . p_col, the flags, and the last writes ----
  float part = 0.f;
  for (int e = tid; e < N * BLK; e += NT) part += sm.us[e] * pc[e];
  float s = fz(m_pp[b] - block_sum<NWARP>(part, sm.red));

  sat |= !(fabsf(s) < SAT);
  float* u_b = u_out + (size_t)b * N * BLK;
  for (int e = tid; e < N * BLK; e += NT) {
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

cudaError_t allow_shared_memory() {
  return cudaFuncSetAttribute(banded_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(Smem));
}

}  // namespace

extern "C" int mpc_banded_factor(const float* Mband, const float* p_col, const float* m_pp,
                                 float* Ldi, float* Lsub, float* u, float* s, int* ok, int B,
                                 void* stream) {
  if (B <= 0) return 0;
  banded_factor_kernel<<<B, NT, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      Mband, p_col, m_pp, Ldi, Lsub, u, s, ok);
  return (int)cudaGetLastError();
}

// Called once when the library is loaded (a launch sets nothing, so it can
// be captured into a CUDA graph as it is).
extern "C" int mpc_banded_factor_init() { return (int)allow_shared_memory(); }

// How many blocks (problems) of the kernel one SM holds at a time, from the
// CUDA occupancy calculator; a CUDA error as a negative number.
extern "C" int mpc_banded_factor_blocks_per_sm() {
  cudaError_t err = allow_shared_memory();
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, banded_factor_kernel, NT,
                                                      sizeof(Smem));
  return err != cudaSuccess ? -(int)err : blocks;
}

// The problems per SM this build's registers are capped for (PER_SM), the
// bytes of shared memory a block takes, and the nodes its backward sweep
// stages at a time (CH).
extern "C" int mpc_banded_factor_per_sm() { return PER_SM; }
extern "C" int mpc_banded_factor_smem_bytes() { return (int)sizeof(Smem); }
extern "C" int mpc_banded_factor_staged() { return CH; }
