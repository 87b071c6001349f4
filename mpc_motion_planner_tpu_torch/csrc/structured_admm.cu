// Kernel 3: one dispatch of the fixed-rho boxADMM loop of one structured QP
// per thread block, with every per-problem operand resident in shared
// memory. The ADMM state (iterates, done, iteration count, residuals) comes
// in and goes out, so the host can run the budget in dispatches with a rho
// update and a refactorization between them; a block whose problem is done
// on entry passes its state through and leaves.
//
// Replaces mpc_motion_planner_tpu/ops/pallas/structured_admm.py
// solve_box_qp_structured_pallas (_structured_kernel :142). Each iteration:
//   rhs = sigma x - qs + rx zx - yx + D A'(E (rc zc - yc))
//   xt  = M^-1 rhs            (banded forward/backward sweeps + arrow)
//   kkt_refine times: xt += M^-1 (rhs - M xt), with
//     M xt = (Ps + sigma + rx) xt + D A'(E rc E A (D xt))
//   zt  = E A (D xt)
//   x   = ftz(a xt + (1-a) x)
//   zc, yc, zx, yx: soft-l1 prox z-updates and dual updates, with ftz
// and every check_every iterations (and at the dispatch's last) the OSQP residual test
// and the NaN-safe divergence freeze at 1e12 (done = 2). A block stops at
// its own done, so a problem's iteration count is its active iterations.
// A and A' are applied matrix-free from the differentiation matrix Dm, the
// time parameter p, the dynamics values f_rows and the node Jacobians J.
//
// What bounds it on an H100: latency, not operations or bytes. The factors
// of one problem (134 KB) fill most of an SM's shared memory, so one block
// runs per SM, and the time of a launch is (problems / SMs) x iterations x
// the latency of one iteration. An iteration is a chain of dependent steps:
// the 38 block steps of the two banded sweeps, each two 21x21
// matrix-vector products deep, between two element-wise phases. A warp runs
// its instructions in order, a shared-memory access takes ~30 cycles to
// return and ~4 to send off, and two warps meet in tens of cycles, so the
// chain is made of such round trips; its arithmetic (~157 kflop per
// iteration) and the launch's device memory traffic (one load, one store)
// are far from the card's limits.
//
// What the design does about it:
// * Lane r of a chain warp owns row r of a block step. Only the distance-1
//   term L[k,k-1] y_{k-1} and the Ldi_k product are on the chain. The terms
//   of distances 2..BW (BW = the band width, the spline order: 3 by
//   default) are formed ahead by BW - 1 helper warps, one per distance,
//   from the y (or x) the chain has just published, and the chain
//   subtracts them as ready vectors, in the order of their distance.
// * Two chain warps take the steps in turn. While one computes, the other
//   loads the two blocks of its next step into registers, so no block load
//   is on the chain: a step reads two 21-vectors (the published result of
//   the step before, and its own intermediate vector passed through shared
//   memory) with six 16-byte loads each, fenced so that they are sent off
//   back to back and their latency is paid once.
// * All sweep warps meet once per block step at a named barrier; the other
//   warps of the block do not take part.
// * A finishing warp reduces u.rhs and the p row of rhs during the forward
//   sweep, so the arrow correction z_p is known before the backward sweep
//   delivers its first node; it then turns each delivered node x_k into
//   xt_k and D xt_k while the chain goes on.
// * All z-layout vectors live in shared memory in node-major order
//   (element n*21 + c, then p), permuted on load and store only, so the
//   sweeps, A and A' address them without per-element index arithmetic
//   (the lean layout keeps those only their owner reads elsewhere).
//   Each thread owns EPT z elements and EPT constraint rows, t, t + NT, ...
//   (one of each for the 512 threads at 19 nodes), for the whole launch and
//   computes their places in A and A' once; an element-wise phase takes a
//   thread's elements in turn.
// * rhs's element-wise part and E (rc zc - yc) are formed in the update
//   phase of the iteration before, by the thread that owns the element. An
//   iteration without a check has three block-wide barriers.
// * A refinement step is a second pass through phases the iteration already
//   has: the rows of A on D xt, the elements of A' on the weighted rows, and
//   the sweeps on the residual, whose finishing warp adds the correction to
//   xt. The saved rhs and the weighted rows lie in the check's scratch
//   vectors, which are free between checks. The kernel is compiled twice, and
//   without refinement the loop has none of this in its instruction stream.
//
// Global layouts (see kernels/structured_admm.py), at 19 nodes: z-layout
// (B,400), m-layout (B,488), Ldi (B,19,21,21), Lsub (B,19,3,21,21), u
// (B,19,21), J (B,19,8,21), f_rows (B,336).
//
// The transcription is set by the build (common.cuh): one library per node
// count, band width and joint count. The figures here are the 7-joint Panda's
// at order 3; a robot of NQ joints has blocks of BLK = 3 NQ rows, node
// vectors padded to VPAD (BLK rounded up to 4: 20 floats, five loads, at 6
// joints; 24 at 7 and 8; 28 at 9; 32 at 10) and a row per lane, so BLK <=
// 32. A thread owns EPT z elements and EPT constraint rows (MPC_EPT, which
// the build sets to ceil(max(NV, NM) / 1024), kernels/structured_admm.py
// ept_of), so the block has NT = max(NV, NM) / EPT threads rounded up to
// whole warps. EPT = 1 up to 1024: 512 at 19 nodes, 672 at 25, 352 at 13,
// 992 at 37; 448 at 19 nodes and 6 joints, 576 at 8, 640 at 9, 704 at 10;
// 832 at 25 nodes and 9 joints, 928 at 10; 544 at order 2 x 9 segments, 416
// at order 4 x 4, 640 at order 4 x 6, 928 at order 4 x 9, 384 at order 5 x
// 3. EPT = 2 past it: 544 at 40 nodes (1,048 rows), 608 at 46, 544 at order
// 4 x 10 and at 31 nodes and 9 joints, 832 at 61 nodes, 992 at 73. A build
// may name another EPT (for holding and timing one against another), and the
// only operation it changes is the order of the sum of the p row's defect
// part in the check (block_sum of part), which follows the threads' rows.
// Then the block's shared memory bounds the geometry (76 nodes of order 3
// take 238,736 B in the lean layout);
// everything else follows the geometry: a band width of BW takes BW - 1
// helper warps and BW - 1 look-ahead vectors (the sweeps need 2 + BW warps).
//
// Shared memory: the build picks one of five layouts from the geometry
// (MPC_SMEM_LAYOUT, kernels/structured_admm.py choose_layout), the first
// that fits a block (232,448 B). The bytes below are sizeof(Smem), which the Python
// reckoning (smem_bytes) equals and the library reports
// (mpc_structured_admm_smem_bytes) on an NVIDIA H100 80GB HBM3 at 700 W.
// * Full: every operand as described above (Ldi stored full: a chain warp
//   runs one multiply-add per column for all rows at once, so the zero half
//   costs no time). 19 and 13 nodes of the Panda, 6 and 7 joints, orders 2,
//   4 and 5 up to 4 segments.
// * Compact drops what is never read (25 nodes of the Panda: 262,000 B
//   full, 29.6 KB too many; 232,176 B compact; 19 nodes and 8 joints,
//   order 4 x 5):
//   - Ldi packed lower triangular (231 of 441 floats per node, 21,000 B
//     less): an inverse Cholesky factor is exactly zero above its diagonal
//     (kernel 2's forward substitution and the plain triangular solve both
//     leave it so), and a chain warp's load puts those zeros back in
//     registers, so every product is the full layout's, bitwise. The row
//     (or column) a lane loads lies at rr (rr+1)/2 + i (or i (i+1)/2 + rr),
//     on 21 distinct banks. The loads are the fetch of a step ahead, off
//     the chain.
//   - Lsub without its tail (5 blocks at BW = 3, 8,820 B less): L[k+d,k]
//     past the matrix end is zero and no sweep reads it (the highest block
//     read is L[N-1,N-2], number (N-2) BW).
// * Split keeps in shared memory only what the chain reads, and reads the
//   rest from device memory (through L2) off the chain. Order 4 x 6 (25
//   nodes: 273,632 B compact, 173,200 B split), 9 and 10 joints at 19 nodes
//   (267,216 and 321,344 B compact; 185,680 and 220,640 B split), 28 to 34
//   nodes of order 3 (180,128 B split at 28). Ldi is packed as in compact;
//   of Lsub only the N - 1 distance-1 blocks L[k,k-1] stay, which the chain
//   fetches. The blocks of distances 2..BW (69 of the 93 compact blocks at
//   order 4 x 6, 121.7 KB) are read only by the helper warps, a full step
//   ahead of the chain. A
//   node's blocks L[m+2,m] .. L[m+BW,m] lie side by side in the Lsub kernel
//   2 wrote (a run): the forward sweep reads node m's run at step m, all
//   helpers at once, and the backward sweep reads it again over BW - 1
//   steps. A ring of BW runs holds node m's in slot m % BW, filled by one
//   bulk copy of the tensor memory accelerator (TMA) two steps before the
//   run's first use; the backward sweep finds the forward's last runs still
//   there, and the next forward the backward's, so an iteration copies 2 (N
//   - 2 - BW) runs (40 at 3 x 8 against 90 blocks copied one by one). The
//   copies complete on one mbarrier per slot, which a helper waits on before
//   reading its block as compact reads Lsub, so split and compact give the
//   same results, bitwise, where both fit. A run is no multiple of 16 B and
//   starts on any 4-byte boundary: the copy runs from the 16-byte boundary
//   at or before it into a slot aligned the same way (no copy of Lsub).
//   The copies are issued by a copier (lane 0 of the first warp after the
//   sweep warps), which takes no part in the sweeps' barriers: it follows
//   the step count that the helper of distance 2 publishes after each
//   barrier, since a copy instruction holds the warp that issues it for
//   hundreds of cycles, and any sweep warp held so holds the chain at the
//   next barrier. Measured (kernel_ab.py and chip_smoke.py, order 3 x 8,
//   where compact also fits, NVIDIA H100 80GB HBM3 at 700 W), per
//   iteration against compact: +62% with 4-byte cp.async pieces by every
//   helper lane, +47% with 16-byte pieces, +33 to +36% with one bulk copy a
//   block issued by its helper, the same with one copy a run (a quarter of
//   the copies) or a producer warp inside the barriers, +20 to +22% with
//   the copier. The copies' latency and bytes are hidden (rings of 2 to 6
//   slots, and 16-byte copies in place of whole blocks, time the same);
//   what is left is the helpers' waits (PERF.md, PR 12).
// * Stream keeps no block of Lsub in shared memory: the chain's distance-1
//   blocks go through the same ring, a node's run one block longer
//   (L[m+1,m] .. L[m+BW,m], from the block before the split's run). 12
//   segments of order 3 (37 nodes: 235,344 B split, 182,432 B stream),
//   order 4 x 9 (247,200 and 197,808 B), 9 and 10 joints at 25 nodes
//   (239,920 and 284,880 B split; 187,440 and 220,112 B stream), order 5 x
//   7 (213,040 B). The chain fetches node m's block in the forward sweep at
//   step m, with the helpers, and in the backward one at step N-2-m, one
//   step after the helper of distance 2, so the ring holds BW + 1 runs;
//   the copier's schedule and copy count are the split's. The chain issues
//   no copy and keeps none of the ring's state: the slot, where the run
//   starts after its boundary and the parity of its copy's barrier phase
//   follow from the node and the pairs of sweeps done (ring_copy_count),
//   and it waits in its fetch, between its turns. Measured (kernel_ab.py
//   and chip_smoke.py phase 23, B=2048, NVIDIA H100 80GB HBM3 at 700 W),
//   all nine outputs bitwise those of compact (3 x 8) and split (4 x 6),
//   per iteration: +41% against compact, +10% against split. A first
//   design, whose chain warps stepped the ring's state as the helpers do,
//   took +126% and +63%: the state's registers spilled the chain's blocks
//   (PERF.md §6).
// * Lean is the stream layout without the 16 vectors that only the thread
//   owning an element or row reads (OWN_V, OWN_M): the launch's constants
//   qs, Ps, rx, lxs, uxs, thx (z) and rc, lcs, ucs, E, thr (m) are read from
//   device memory through the read-only path where they are used, an
//   element's all at once (z_const, m_const; 8.3 MB for 132 blocks at 61
//   nodes, inside L2), and the iterates x, zx, yx (z) and zc, yc (m) live in
//   their owner's registers for the launch (own_iter). That is 4 (9 NV + 7
//   NM) bytes less: 16 to 24 segments of order 3 (49 to 73 nodes: 234,560 B
//   stream, 161,488 B lean at 49; 195,824 B at 61; 230,160 B at 73), order 4
//   x 11 to x 16 (225,648 B at 65 nodes), 9 joints at 34 to 46 nodes, 10
//   joints at 28 to 37. Nothing the sweeps read moves, so the chain is the
//   stream's. The only reads across threads of those vectors are the
//   finishing warp's of the arrow element's Ps and rx, which keep a slot
//   each (P_AT). The arithmetic is the stream's (the relaxation's FMAs
//   spelled out as nvcc contracts them there, fma_first), so where both fit
//   the two give the same results, bitwise.
// Two other ways were weighed for what does not fit: J in device memory
// read through L1 (16.8 KB) would put an L1 round trip into A and A' every
// iteration, and a cluster of two blocks holding the factors in distributed
// shared memory would put one into every block step of the chain (or, with
// only the helpers' blocks in the partner, take two SMs per problem: 66
// problems in flight instead of 132). Registers: 672 threads are 21 warps,
// six of them on one of the SM's four schedulers, whose quarter of the
// register file (16K) then allows 80 registers per thread; ptxas -v reports
// 72 B of spill stores for the 25-node build, none at 19 nodes (99
// registers). At 928 to 992 threads (29 to 31 warps, eight on a scheduler)
// a thread has 64 registers and a chain warp's two block rows and vector
// (66 floats for 7 joints, 92 for 10) no longer fit. ptxas -v, registers
// and spill stores of the stream builds (with refinement, without): 37
// nodes 64, 632 and 380 B; order 4 x 9 64, 720 and 408 B; 25 nodes at 9
// joints 72 and 32 registers, 1,024 and 2,128 B, at 10 joints 32 and 32,
// 4,764 and 2,448 B (ptxas allots 32 where 64 are allowed); forced at 3 x 8
// 80, 116 and 108 B; at 4 x 6 96, 48 and 68 B. The stream at 3 x 8 built
// for 64 registers (692 B) takes +38% an iteration (kernel_ab.py, PERF.md
// §6). At EPT = 2 a thread has more registers and holds two places in A and
// A': 37 nodes at 512 threads (16 warps, four on a scheduler) 128
// registers and no spills; at 544 and 608 threads (five warps on a
// scheduler) 96: 40 and 46 nodes 196 and 160 B of spill stores, order 4 x
// 10 200 and 164 B, 31 nodes and 9 joints 300 and 288 B. The lean layout
// keeps the 5 iterates of each element in registers: 61 nodes (832 threads)
// 72 registers, 576 and 436 B; order 4 x 16 (832) 72, 608 and 452 B; 46
// nodes (608, built only to hold it) 96, 284 and 244 B; 73 nodes (992) 64
// and 32 registers, 900 and 1,896 B; 9 joints at 46 nodes (800) 72 and 32,
// 1,236 and 2,384 B; 10 joints at 37 nodes (704) 40 and 40, 4,240 and 2,344
// B (chip_smoke.py phase 25).

#include "common.cuh"

using namespace mpc;

namespace {

// threads: EPT z elements and EPT rows each (thread t owns elements t, t +
// NT, ...), in whole warps
constexpr int EPT = MPC_EPT;
constexpr int NT = (((NM > NV ? NM : NV) + EPT - 1) / EPT + 31) / 32 * 32;
constexpr int NWARP = NT / 32;
constexpr int NB = N * BLK;              // 399 banded variables; element NB is p
constexpr int VPAD = (BLK + 3) / 4 * 4;  // a node's BLK values in a 16-byte aligned row
static_assert(EPT >= 1 && NT * EPT >= NM && NT * EPT >= NV, "EPT z elements and rows a thread");
static_assert(NT <= 1024, "a block has at most 1024 threads");
static_assert(NT >= KL * KL, "a thread per entry of Dm");
static_assert(BW >= 1, "a band has at least one sub-diagonal block");
static_assert(BLK % 3 == 0 && VPAD <= 32, "a row per lane, summed in three partial sums");
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory of one block
constexpr int TRI = BLK * (BLK + 1) / 2; // a packed lower-triangular block
constexpr int LSUB_USED = (N - 2) * BW + 1;  // Lsub blocks up to L[N-1,N-2]
constexpr int NAHEAD = BW - 1;             // look-ahead distances 2..BW
constexpr int NAHEAD_BUF = NAHEAD > 0 ? NAHEAD : 1;

// the shared-memory layouts (the header says which geometry takes which)
enum Layout { FULL = 0, COMPACT = 1, SPLIT = 2, STREAM = 3, LEAN = 4 };
constexpr int LAYOUT = MPC_SMEM_LAYOUT;
static_assert(LAYOUT >= FULL && LAYOUT <= LEAN, "a layout of common.cuh");
constexpr bool PACKED_LDI = LAYOUT != FULL;
// stream and lean: the chain's distance-1 blocks go through the ring too
constexpr bool STREAMED = LAYOUT == STREAM || LAYOUT == LEAN;
// split, stream and lean: Lsub goes through a ring of node runs. Node m's
// blocks L[m+1,m] .. L[m+BW,m] lie side by side in Lsub; its run is the last
// BW - 1 of them (split: the helpers' blocks) or all BW (stream and lean: the
// chain's block L[m+1,m] too). A ring of RING runs holds node m's in slot m % RING, copied
// from the 16-byte boundary at or before the run, so up to 3 floats more.
// The ring is filled LEAD steps ahead of a run's first use, and RING is the
// fewest runs for which no copy overwrites a run still to be read: BW + LEAD
// - 2 in the split, one more in the stream, whose chain reads a run one step
// after the helper of distance 2 in the backward sweep (ring_step).
constexpr bool RINGED = LAYOUT == SPLIT || STREAMED;
static_assert(!RINGED || BW >= 2, "the helper of distance 2 paces the ring's copier");
constexpr int RUN0 = STREAMED ? 0 : 1;  // a run starts at L[m+1+RUN0,m]
constexpr int LEAD = 2;
constexpr int RING = BW + LEAD - 1 - RUN0;
constexpr int RUN = (BW - RUN0) * BLK2;
constexpr int SLOT = (RUN + 6) / 4 * 4;
constexpr int LAST_RUN = N - 2 - RUN0;  // the last node whose run a sweep reads
constexpr int RING0 = RING < LAST_RUN + 1 ? RING : LAST_RUN + 1;  // runs copied at the start
// runs copied in each forward sweep (nodes RING .. LAST_RUN) and in each backward one
constexpr int NCOPY = LAST_RUN + 1 - RING > 0 ? LAST_RUN + 1 - RING : 0;
// the distance-1 blocks L[k,k-1] that stay in shared memory (the split's)
constexpr int D1_FLOATS = LAYOUT == SPLIT ? (N - 1) * BLK2 : 0;
// floats of Lsub in shared memory: all blocks; those up to L[N-1,N-2]; or
// (split, stream, lean) the resident distance-1 blocks, up to 3 floats to a
// 16-byte boundary, the ring, its barriers (8 bytes each) and the copier's
// progress count
constexpr int LSUB_FLOATS = LAYOUT == FULL      ? N * BW * BLK2
                            : LAYOUT == COMPACT ? LSUB_USED * BLK2
                                                : D1_FLOATS + 3 + RING * (SLOT + 2) + 1;
// The owner-only vectors: 16 z and m vectors are read and written only by
// the thread that owns the element or row, the launch's constants qs, Ps,
// rx, lxs, uxs, thx (z) and rc, lcs, ucs, E, thr (m) and the iterates x, zx,
// yx (z) and zc, yc (m); only the finishing warp reads two of them across
// threads, the arrow element's Ps and rx. The lean layout keeps one float of
// each in shared memory, so that every member stays: the arrow element's Ps
// and rx (at P_AT), the others unused (z_const, m_const, own_iter).
constexpr int OWN_V = LAYOUT == LEAN ? 1 : NV, OWN_M = LAYOUT == LEAN ? 1 : NM;
constexpr int P_AT = LAYOUT == LEAN ? 0 : NB;  // the arrow element's Ps and rx

struct Params {
  float Dm[KL * KL];  // Dm[k*KL + j]
  float sigma, alpha, eps_abs, eps_rel;
  int cap, check_every, kkt_refine;
};

struct Ptrs {
  // factors and operator data
  const float *Ldi, *Lsub, *u, *s, *J, *f_rows, *p;
  // z-layout data
  const float *qs, *Ps, *rx, *lxs, *uxs, *thx, *D, *x0, *zx0, *yx0;
  // m-layout data
  const float *rc, *lcs, *ucs, *E, *thr, *zc0, *yc0;
  // the rest of the state on entry
  const float *rp0, *rd0;
  const int *done0, *iters0;
  // outputs
  float *x, *zc, *zx, *yc, *yx, *rp, *rd;
  int *done, *iters;
};
constexpr int NPTRS = 37;
static_assert(sizeof(Ptrs) == NPTRS * sizeof(void*), "pointer block layout");

// z vectors are node-major here: element e = n*21 + c for e < NB, then p.
struct Smem {
  float Ldi[N * (PACKED_LDI ? TRI : BLK2)];
  float Lsub[LSUB_FLOATS];
  float u[NB];
  float J[N * NG * BLK];
  float fseg[NEQ];
  float qs[OWN_V], Ps[OWN_V], rx[OWN_V], lxs[OWN_V], uxs[OWN_V], thx[OWN_V], D[NV];
  float rc[OWN_M], lcs[OWN_M], ucs[OWN_M], E[OWN_M], thr[OWN_M];
  float x[OWN_V], zx[OWN_V], yx[OWN_V];
  float zc[OWN_M], yc[OWN_M];
  float t0[NV];                      // sigma x - qs + rx zx - yx
  float wa[NM];                      // E (rc zc - yc)
  float rhs[NV];
  // results of the forward and the backward sweep, node n at n*VPAD
  alignas(16) float ys[N * VPAD];
  alignas(16) float xs[N * VPAD];
  alignas(16) float tb[VPAD];        // the chain's intermediate vector
  float ahead[NAHEAD_BUF][NB];       // ahead[d-2]: the distance-d terms of the steps ahead
  float xt[NV], dx[NV];              // M^-1 rhs and D xt
  // scratch of the check; between checks a refinement step keeps its
  // weighted rows in wb and the iteration's rhs in wc
  float wb[NM], wc[NM];
  float red[NWARP * 4];
  float Dm[KL * KL];
  float p, s;
  int done;
};
static_assert(sizeof(Smem) <= SMEM_LIMIT, "shared memory of one block: the build's layout");
// split, stream and lean: where the ring starts in Lsub, the first 16-byte
// boundary of the block's shared memory after the resident distance-1 blocks
constexpr int LSUB_AT = (int)offsetof(Smem, Lsub) / 4;
constexpr int RING_AT = (LSUB_AT + D1_FLOATS + 3) / 4 * 4 - LSUB_AT;

__device__ __forceinline__ float ftz(float v) {
  return clampf(fabsf(v) < 1e-30f ? 0.f : v, -1e15f, 1e15f);
}

__device__ __forceinline__ float soft_update(float za, float y, float r, float lo, float hi,
                                             float t) {
  float v = za + y / r;
  float box = clampf(v, lo, hi);
  return ftz(v - clampf(v - box, -t, t));
}

// ---- the owner-only vectors ----

// The launch's constants of a z element (with its soft box lo, hi, th) and
// of a constraint row. The lean layout reads them from device memory through
// the read-only path (L2), the others from shared memory. An element-wise
// phase takes those of all its elements at its start, so that the loads go
// off together and their latency is paid once; a field it does not use is
// not loaded.
struct ZConst {
  float qs, Ps, rx, lo, hi, th;
};
struct MConst {
  float E, rc, lo, hi, th;
};

// the thread's z element e, at j = zo + its index in the z-layout
__device__ __forceinline__ ZConst z_const(const Smem& sm, const Ptrs& g, int e, size_t j) {
  if constexpr (LAYOUT == LEAN)
    return {__ldg(g.qs + j), __ldg(g.Ps + j), __ldg(g.rx + j),
            __ldg(g.lxs + j), __ldg(g.uxs + j), __ldg(g.thx + j)};
  else
    return {sm.qs[e], sm.Ps[e], sm.rx[e], sm.lxs[e], sm.uxs[e], sm.thx[e]};
}

// the thread's row i, at j = mo + i
__device__ __forceinline__ MConst m_const(const Smem& sm, const Ptrs& g, int i, size_t j) {
  if constexpr (LAYOUT == LEAN)
    return {__ldg(g.E + j), __ldg(g.rc + j), __ldg(g.lcs + j), __ldg(g.ucs + j), __ldg(g.thr + j)};
  else
    return {sm.E[i], sm.rc[i], sm.lcs[i], sm.ucs[i], sm.thr[i]};
}

// An iterate of the thread's q-th element or row e: in shared memory, or
// (lean) in the owner's registers, r[q] (q unrolled).
__device__ __forceinline__ float& own_iter(float* s, float (&r)[EPT], int q, int e) {
  if constexpr (LAYOUT == LEAN) return r[q];
  else return s[e];
}

// a u + b v as the other layouts' builds contract it, fma(a, u, b v). Where v
// is a register (the lean layout's iterates) nvcc contracts the other
// product, fma(b, v, a u), so the lean build spells the FMA out and gives
// the stream build's results bitwise.
__device__ __forceinline__ float fma_first(float a, float u, float b, float v) {
  return __fmaf_rn(a, u, __fmul_rn(b, v));
}

// ---- BLK-vectors in registers ----

// A padded row (VPAD floats, 16-byte aligned) into registers, the same for
// every lane: VPAD / 4 16-byte loads (six for the Panda), one asm statement
// each at a constant offset from one address. A warp runs its instructions
// in order, so a product placed between two loads stalls the second load
// for the latency of the first; the fence after the group keeps the
// compiler from sinking the loads to their first uses, so they are sent off
// back to back and their latency is paid once.
template <int Q>
__device__ __forceinline__ void load_quads(float (&v)[VPAD], unsigned a) {
  if constexpr (Q < VPAD / 4) {
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4+%5];"
                 : "=f"(v[4 * Q]), "=f"(v[4 * Q + 1]), "=f"(v[4 * Q + 2]), "=f"(v[4 * Q + 3])
                 : "r"(a), "n"(16 * Q)
                 : "memory");
    load_quads<Q + 1>(v, a);
  }
}

__device__ __forceinline__ void load_vec(float (&v)[VPAD], const float* p) {
  load_quads<0>(v, (unsigned)__cvta_generic_to_shared(p));
  asm volatile("membar.cta;" ::: "memory");
}

// sum_i M[i] v[i] in three partial sums
__device__ __forceinline__ float dot_row(const float (&M)[BLK], const float (&v)[VPAD]) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < BLK; i += 3) {
    s0 += M[i] * v[i];
    s1 += M[i + 1] * v[i + 1];
    s2 += M[i + 2] * v[i + 2];
  }
  return (s0 + s1) + s2;
}

// ---- A and A' on node-major vectors, places computed once per thread ----

// One z element's place in A': its component c, its index z in the
// z-layout, the covering (segment, local node) pairs as (56 s, l), and its
// node's J and g offsets.
struct ZElem {
  int c, z, ncov, sb0, l0, sb1, l1, jb, gb;
};

__device__ __forceinline__ ZElem make_zelem(int e) {
  ZElem z;
  z.c = z.ncov = z.sb0 = z.l0 = z.sb1 = z.l1 = z.jb = z.gb = 0;
  z.z = e;
  if (e >= NB) return z;
  const int n = e / BLK;
  z.c = e % BLK;
  z.z = zidx(n, z.c);
  z.ncov = 1;
  if (n == 0) { z.sb0 = 0; z.l0 = 0; }
  else if (n == N - 1) { z.sb0 = (SEG - 1) * KL * NX; z.l0 = KL - 1; }
  else if (n % BW == 0) {
    z.sb0 = (n / BW - 1) * KL * NX; z.l0 = KL - 1;
    z.sb1 = (n / BW) * KL * NX; z.l1 = 0;
    z.ncov = 2;
  } else { z.sb0 = (n / BW) * KL * NX; z.l0 = n % BW; }
  z.jb = n * NG * BLK + z.c;
  z.gb = NEQ + n * NG;
  return z;
}

// (A' w)[e] for e < NB
__device__ __forceinline__ float at_elem(const Smem& sm, const float* w, const ZElem& z) {
  float val = 0.f;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (q < z.ncov) {
      const int sb = q ? z.sb1 : z.sb0, l = q ? z.l1 : z.l0;
      if (z.c < NX) {
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < KL; ++k) t += sm.Dm[k * KL + l] * w[sb + k * NX + z.c];
        val += t;
      }
      if (z.c >= NQ) val -= sm.p * w[sb + l * NX + z.c - NQ];
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < NG; ++r) acc += sm.J[z.jb + r * BLK] * w[z.gb + r];
  return val + acc;
}

// One constraint row's place in A: a defect row (base = the element of its
// segment's first node and component, k its local node) or a
// node-constraint row (base = its J row, k = its node's first element).
struct MRow {
  int base, k;
};

__device__ __forceinline__ MRow make_mrow(int i) {
  MRow r;
  r.base = r.k = 0;
  if (i < NEQ) {
    r.base = (KL - 1) * (i / (KL * NX)) * BLK + i % NX;
    r.k = (i % (KL * NX)) / NX;
  } else if (i < NM) {
    r.base = (i - NEQ) * BLK;
    r.k = ((i - NEQ) / NG) * BLK;
  }
  return r;
}

// (A v)[i] for a node-major v, i < NM
__device__ __forceinline__ float a_row(const Smem& sm, const float* v, int i, const MRow& r) {
  if (i < NEQ) {
    float dxv = 0.f;
#pragma unroll
    for (int j = 0; j < KL; ++j) dxv += sm.Dm[r.k * KL + j] * v[r.base + j * BLK];
    return dxv - sm.p * v[r.base + r.k * BLK + NQ] - sm.fseg[i] * v[NB];
  }
  const float* Jr = sm.J + r.base;
  const float* vn = v + r.k;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < BLK; c += 3) {
    s0 += Jr[c] * vn[c];
    s1 += Jr[c + 1] * vn[c + 1];
    s2 += Jr[c + 2] * vn[c + 2];
  }
  return (s0 + s1) + s2;
}

// ---- the sweeps: two chain warps, BW - 1 helper warps, finishing warp ----

constexpr int CHAIN_WARPS = 2;  // chain warps that take the block steps in turn
constexpr int SWEEP_WARPS = CHAIN_WARPS + NAHEAD + 1;  // chain, helpers, finisher
static_assert(NWARP >= SWEEP_WARPS, "too few warps for the sweeps");
constexpr int BAR_FWD = 1, BAR_BWD = 2;
// the finishing warp joins the barriers of the backward sweep only
constexpr int FWD_THREADS = 32 * (SWEEP_WARPS - 1), BWD_THREADS = 32 * SWEEP_WARPS;

template <bool FWD>
__device__ __forceinline__ void sweep_barrier() {
  if (FWD) asm volatile("bar.sync %0, %1;" ::"n"(BAR_FWD), "n"(FWD_THREADS) : "memory");
  else asm volatile("bar.sync %0, %1;" ::"n"(BAR_BWD), "n"(BWD_THREADS) : "memory");
}

__device__ __forceinline__ void warp_barrier() {
  asm volatile("bar.warp.sync 0xffffffff;" ::: "memory");
}

// Row rr of a block (forward) or column rr (backward, the transposed product)
template <bool FWD>
__device__ __forceinline__ void load_block(float (&M)[BLK], const float* blk, int rr) {
#pragma unroll
  for (int i = 0; i < BLK; ++i) M[i] = FWD ? blk[rr * BLK + i] : blk[i * BLK + rr];
}

// Row rr (forward) or column rr (backward) of Ldi_k. The compact and split
// layouts store the lower triangle row by row and the zeros above it are put
// back here, so the products are those of the full layout.
template <bool FWD>
__device__ __forceinline__ void load_ldi(float (&M)[BLK], const Smem& sm, int k, int rr) {
  if constexpr (PACKED_LDI) {
    const float* blk = sm.Ldi + k * TRI;
#pragma unroll
    for (int i = 0; i < BLK; ++i) {
      if (FWD) M[i] = i <= rr ? blk[rr * (rr + 1) / 2 + i] : 0.f;
      else M[i] = i >= rr ? blk[i * (i + 1) / 2 + rr] : 0.f;
    }
  } else {
    load_block<FWD>(M, sm.Ldi + k * BLK2, rr);
  }
}

// ---- the split and stream layouts: Lsub streamed through a ring of node runs ----

// The ring's state, the same in every thread that keeps it (the helper
// warps and the copier), which all update it at the same point of each
// step: the nodes whose
// runs the ring holds (lo..hi), and per slot the parity of its last copy's
// barrier phase and where its run starts after its 16-byte boundary. Kept
// incrementally, since what a warp does in a step lies between two barriers
// of the sweep.
struct Ring {
  const float* lsub;  // the problem's Lsub in device memory (B, N, BW, BLK, BLK)
  float* slots;       // slot 0
  unsigned bar;       // the shared address of slot 0's barrier
  unsigned progress;  // the shared address of the steps the helper of distance 2 finished
  int lo, hi;         // the nodes whose runs the ring holds
  unsigned parity;    // bit s: the phase parity of slot s's last copy
  unsigned phases;    // bits 2s, 2s+1: where slot s's run starts after its boundary
  int steps;          // the sweep steps done in the launch
  int pairs;          // the stream layout's chain: the pairs of sweeps done in the launch
};

// The copier: lane 0 of warp SWEEP_WARPS, which takes no part in the sweeps'
// barriers, issues the ring's copies; a copy instruction holds the warp
// that issues it for hundreds of cycles, which no sweep warp can spare.
constexpr int COPIER = SWEEP_WARPS;
static_assert(!RINGED || NWARP > COPIER, "a warp for the copier");

// Copy node m's run into slot m % RING: the copier issues one bulk copy of
// the tensor memory accelerator, from the 16-byte boundary at or before the
// run to the one at or after its end (the up to 3 floats past it belong to
// the next node's first block), which completes on the slot's barrier;
// every thread that keeps the state updates it.
__device__ __forceinline__ void ring_copy(Ring& r, int warp, int lane, int m) {
  const int s = m % RING;
  const float* src = r.lsub + (m * BW + RUN0) * BLK2;
  const unsigned phase = (unsigned)(__cvta_generic_to_global(src) >> 2) & 3u;
  if (warp == COPIER && lane == 0) {
    const unsigned bytes = 16 * ((RUN + phase + 3) / 4), bar = r.bar + 8 * s;
    // the slot's earlier contents were read by ordinary loads before a barrier
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"((unsigned)__cvta_generic_to_shared(r.slots + s * SLOT)),
        "l"(__cvta_generic_to_global(src - phase)), "r"(bytes), "r"(bar)
        : "memory");
  }
  r.parity ^= 1u << s;
  r.phases = (r.phases & ~(3u << 2 * s)) | (phase << 2 * s);
}

// Wait until the phase of the barrier at shared address bar whose parity is
// given has completed.
__device__ __forceinline__ void barrier_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Wait until slot s's last copy has landed.
__device__ __forceinline__ void ring_wait(const Ring& r, int s) {
  barrier_wait(r.bar + 8 * s, ((r.parity >> s) & 1u) ^ 1u);
}

// Block b of node m's run (L[m+1+RUN0+b, m]) once it has landed.
__device__ __forceinline__ const float* ring_block(const Ring& r, int m, int b) {
  const int s = m % RING;
  ring_wait(r, s);
  return r.slots + s * SLOT + ((r.phases >> 2 * s) & 3u) + b * BLK2;
}

// Once at the start of a launch, by the warps that keep the ring's state
// (the helpers and the copier): the state, the barriers, and the runs of
// nodes 0..RING-1 (those a sweep reads).
__device__ __forceinline__ void ring_start(Smem& sm, Ring& r, int warp, int lane) {
  if ((warp < CHAIN_WARPS || warp >= CHAIN_WARPS + NAHEAD) && warp != COPIER) return;
  r.slots = sm.Lsub + RING_AT;
  r.bar = (unsigned)__cvta_generic_to_shared(sm.Lsub + RING_AT + RING * SLOT);
  r.progress = r.bar + 8 * RING;
  r.lo = 0;
  r.hi = RING0 - 1;
  r.parity = r.phases = 0;
  r.steps = 0;
  if (warp == COPIER && lane == 0) {
    asm volatile("st.shared.u32 [%0], 0;" ::"r"(r.progress) : "memory");
    for (int s = 0; s < RING; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(r.bar + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  for (int m = 0; m <= r.hi; ++m) ring_copy(r, warp, lane, m);
}

// Once at the end of a launch, by the copier: each slot's last copy lands
// before the block's shared memory is gone.
__device__ __forceinline__ void ring_end(const Ring& r, int warp) {
  if (warp == COPIER)
    for (int s = 0; s < RING; ++s) ring_wait(r, s);
}

// After step t: the run first needed LEAD steps on, if the ring does not
// hold it. The reads (windows: step t's reads come after the sweep's barrier
// of step t - 1 and before that of step t): the helper of distance d reads
// block L[m+d,m] of node m = t (forward) or N-1-t-d (backward) at step t
// (ring_take); the stream layout's chain reads L[m+1,m] for its step m + 1
// (forward) or N-1-m (backward) in the step before, as it fetches ahead
// (chain_fetch): forward at step m, with the helpers, backward at step
// N-2-m, one after the helper of distance 2. Forward, node t + LEAD's copy
// evicts node t + LEAD - RING's, read at step t + LEAD - RING <= t.
// Backward, node N-1-t-LEAD-BW's (helper BW reads it first) evicts node
// N-1-t-LEAD-BW+RING's, last read (split: by helper 2) at step t + LEAD + BW
// - 2 - RING = t, or (stream: by the chain) at step t + LEAD + BW - 1 - RING
// = t. The copier issues the copy once the helper of distance 2 has
// published that it finished step t, after the sweep's barrier of step t,
// before which every read of the evicted run came. An iteration copies 2 (N
// - 2 - BW) runs in either layout (40 at 25 nodes of order 3), as RING - 1 -
// RUN0 = BW - 1 holds. kernels/structured_admm.py ring_schedule models this
// schedule step by step and tests/test_torch_geometry.py holds it.
template <bool FWD>
__device__ __forceinline__ void ring_step(Ring& r, int warp, int lane, int t) {
  const int m = FWD ? t + LEAD : N - 1 - t - LEAD - BW;
  const bool copy = FWD ? m <= LAST_RUN && m > r.hi : m >= 0 && m < r.lo;
  ++r.steps;
  if (warp == CHAIN_WARPS && lane == 0)
    asm volatile("st.release.cta.shared.u32 [%0], %1;" ::"r"(r.progress), "r"(r.steps)
                 : "memory");
  if (!copy) return;
  if (warp == COPIER && lane == 0) {
    unsigned done;
    for (;;) {
      asm volatile("ld.acquire.cta.shared.u32 %0, [%1];"
                   : "=r"(done)
                   : "r"(r.progress)
                   : "memory");
      if ((int)done >= r.steps) break;
      __nanosleep(64);
    }
  }
  ring_copy(r, warp, lane, m);
  if (FWD) {
    r.hi = m;
    r.lo = max(r.lo, m - RING + 1);
  } else {
    r.lo = m;
    r.hi = min(r.hi, m + RING - 1);
  }
}

// The copier's part of a sweep: the ring's state, step by step, with the
// copies.
template <bool FWD>
__device__ __forceinline__ void copier_sweep(Ring& r, int warp, int lane) {
  for (int t = 0; t < N; ++t) ring_step<FWD>(r, warp, lane, t);
}

// The helper of distance DIST's block at step t: row or column rr of
// L[m+DIST,m] of node m = t (forward) or N-1-t-DIST (backward).
template <bool FWD, int DIST>
__device__ __forceinline__ void ring_take(float (&M)[BLK], const Ring& r, int t, int rr) {
  load_block<FWD>(M, ring_block(r, FWD ? t : N - 1 - t - DIST, DIST - 1 - RUN0), rr);
}

// Step t of a sweep works on node k: forward k = t, backward k = N-1-t.
template <bool FWD>
__device__ __forceinline__ int node_of(int t) { return FWD ? t : N - 1 - t; }

// Every pair of sweeps copies the same runs: forward the nodes RING ..
// LAST_RUN, backward the NCOPY nodes below those the forward leaves in the
// ring, after ring_start's nodes 0 .. RING0-1. So the copies into slot s up
// to the one that holds node m (s = m % RING) at a read follow from m, the
// sweep and the pairs of sweeps done before it: the slot's first copy, one
// pair's copies into it (forward nodes s + RING, s + 2 RING, ... <=
// LAST_RUN; backward nodes s, s + RING, ... < NCOPY) per pair done, and this
// pair's up to node m's. kernels/structured_admm.py ring_copy_count is the
// same count, held against ring_schedule.
template <bool FWD>
__device__ __forceinline__ int ring_copy_count(int m, int pairs) {
  const int s = m % RING;
  const int fwd = LAST_RUN >= s ? (LAST_RUN - s) / RING : 0;
  const int bwd = s < NCOPY ? (NCOPY - 1 - s) / RING + 1 : 0;
  const int now = FWD || m >= NCOPY ? m / RING : fwd + (NCOPY - 1 - m) / RING + 1;
  return (s < RING0) + pairs * (fwd + bwd) + now;
}

// The distance-1 block L[j+1,j]: in shared memory (the split layout keeps
// those alone), or (stream) the first block of node j's run, once its copy
// has landed. The stream layout's chain keeps none of the ring's state (a
// warp on the chain holds its blocks in registers, which the state would
// spill): the slot, where the run starts after its boundary, and the parity
// of the barrier phase of its copy (ring_copy_count) follow from j and the
// pairs of sweeps done.
template <bool FWD>
__device__ __forceinline__ const float* lsub_d1(const Smem& sm, const Ring& r, int j) {
  if constexpr (STREAMED) {
    const int s = j % RING;
    const unsigned bar = (unsigned)__cvta_generic_to_shared(sm.Lsub + RING_AT + RING * SLOT);
    barrier_wait(bar + 8 * s, (unsigned)(ring_copy_count<FWD>(j, r.pairs) - 1) & 1u);
    const float* src = r.lsub + j * BW * BLK2;
    return sm.Lsub + RING_AT + s * SLOT + ((unsigned)(__cvta_generic_to_global(src) >> 2) & 3u);
  }
  return sm.Lsub + (LAYOUT == SPLIT ? j : j * BW) * BLK2;
}

// The chain's blocks and right-hand side of step t, into registers (its
// block of Lsub last: in the stream layout it may wait for it).
template <bool FWD>
__device__ __forceinline__ void chain_fetch(const Smem& sm, const Ring& r, int t, int rr,
                                            float (&L)[BLK], float (&Dg)[BLK], float& v) {
  const int k = node_of<FWD>(t);
  load_ldi<FWD>(Dg, sm, k, rr);
  v = FWD ? sm.rhs[k * BLK + rr] : sm.ys[k * VPAD + rr];
  if (t >= 1) load_block<FWD>(L, lsub_d1<FWD>(sm, r, FWD ? k - 1 : k), rr);
}

// y_k = Ldi_k (r_k - L[k,k-1] y_{k-1} - a_{2,k} - ... - a_{BW,k}) for k =
// 0..N-1 (forward), with a_{d,k} = L[k,k-d] y_{k-d}, and the same with
// transposed blocks and x_{k+1}, x_{k+d} for k = N-1..0 (backward). Lane r
// owns row r. The chain warps take the steps in turn: the warp whose turn it
// is reads the vector of the step before as it was published, passes its own
// intermediate vector through tb and publishes the step's result; the others
// fetch the blocks of their next step meanwhile.
template <bool FWD>
__device__ __forceinline__ void chain_sweep(Smem& sm, Ring& r, int lane, int turn) {
  const int rr = min(lane, BLK - 1);
  float* pub = FWD ? sm.ys : sm.xs;
  float L[BLK], Dg[BLK], vec[VPAD], v;
  chain_fetch<FWD>(sm, r, turn, rr, L, Dg, v);
  for (int t = 0; t < N; ++t) {
    if (t % CHAIN_WARPS != turn) {
      sweep_barrier<FWD>();
      continue;
    }
    const int k = node_of<FWD>(t);
    float acc = v;
    if (t >= 1) {
      // the ready terms are loaded ahead of the vector's fence
      float ah[NAHEAD_BUF];
#pragma unroll
      for (int d = 2; d <= BW; ++d) ah[d - 2] = t >= d ? sm.ahead[d - 2][k * BLK + rr] : 0.f;
      load_vec(vec, pub + node_of<FWD>(t - 1) * VPAD);
      // distances 1, 2, ..., BW in turn, the order of the plain solve
      acc = v - dot_row(L, vec);
#pragma unroll
      for (int d = 2; d <= BW; ++d) acc -= ah[d - 2];
    }
    if (lane < BLK) sm.tb[lane] = acc;
    warp_barrier();
    load_vec(vec, sm.tb);
    const float out = dot_row(Dg, vec);
    if (lane < BLK) pub[k * VPAD + lane] = out;
    sweep_barrier<FWD>();
    if (t + CHAIN_WARPS < N) chain_fetch<FWD>(sm, r, t + CHAIN_WARPS, rr, L, Dg, v);
  }
  if (!FWD) ++r.pairs;
}

// After the chain publishes node k at step t, the helper of distance DIST
// forms that node's term of the step DIST ahead: L[k+DIST,k] y_k (forward),
// L[k,k-DIST]' x_k (backward).
template <bool FWD, int DIST>
__device__ __forceinline__ void helper_sweep(Smem& sm, Ring& r, int warp, int lane) {
  const int rr = min(lane, BLK - 1);
  float* out = sm.ahead[DIST - 2];
  const float* pub = FWD ? sm.ys : sm.xs;
  float M[BLK], vec[VPAD];
  for (int t = 0; t < N; ++t) {
    const int k = node_of<FWD>(t);
    const bool live = t + DIST < N;
    if (live) {
      if constexpr (RINGED)
        ring_take<FWD, DIST>(M, r, t, rr);
      else
        load_block<FWD>(M, sm.Lsub + ((FWD ? k : k - DIST) * BW + DIST - 1) * BLK2, rr);
    }
    sweep_barrier<FWD>();
    if (live) {
      load_vec(vec, pub + k * VPAD);
      float s = dot_row(M, vec);
      if (lane < BLK) out[node_of<FWD>(t + DIST) * BLK + lane] = s;
    }
    if constexpr (RINGED) ring_step<FWD>(r, warp, lane, t);
  }
}

// The arrow: z_p = (rhs_p - u.rhs) / s with rhs_p = t0_p - D_p (f.wa), found
// while the forward sweep runs; then xt_k = x_k - u_k z_p and D xt_k for
// each node the backward sweep delivers. With REFINE the p row of rhs is
// saved beside the others. CORRECTION is the pass of a refinement step: the
// sweeps run on the residual rhs - M xt, whose p row is
// rhs_p - ((Ps + sigma + rx)_p xt_p - D_p (f.wb)), and what they deliver is
// added to xt.
template <bool REFINE, bool CORRECTION>
__device__ __forceinline__ void finish_sweep(Smem& sm, int lane, float sigma) {
  const float* w = CORRECTION ? sm.wb : sm.wa;
  float pu = 0.f, pf = 0.f;
  for (int e = lane; e < NB; e += 32) pu += sm.u[e] * sm.rhs[e];
  for (int i = lane; i < NEQ; i += 32) pf += sm.fseg[i] * w[i];
  pu = warp_sum(pu);
  pf = warp_sum(pf);
  const float rhs_p =
      CORRECTION ? sm.wc[NB] - ((sm.Ps[P_AT] + sigma + sm.rx[P_AT]) * sm.xt[NB] - sm.D[NB] * pf)
                 : sm.t0[NB] - sm.D[NB] * pf;
  const float zp = (rhs_p - pu) / sm.s;
  if (CORRECTION) warp_barrier();  // every lane has read xt_p
  if (lane == 0) {
    const float v = CORRECTION ? sm.xt[NB] + zp : zp;
    sm.xt[NB] = v;
    sm.dx[NB] = sm.D[NB] * v;
    if (REFINE && !CORRECTION) sm.wc[NB] = rhs_p;
  }
  for (int t = 0; t < N; ++t) {
    sweep_barrier<false>();
    if (lane < BLK) {
      const int k = node_of<false>(t), e = k * BLK + lane;
      float v = sm.xs[k * VPAD + lane] - sm.u[e] * zp;
      if (CORRECTION) v += sm.xt[e];
      sm.xt[e] = v;
      sm.dx[e] = sm.D[e] * v;
    }
  }
}

// Warp CHAIN_WARPS + DIST - 2 is the helper of distance DIST (2..BW), the
// warp after them the finishing warp.
template <bool REFINE, bool CORRECTION, int DIST>
__device__ __forceinline__ void helper_or_finish(Smem& sm, Ring& r, int warp, int lane,
                                                 float sigma) {
  if constexpr (DIST <= BW) {
    if (warp == CHAIN_WARPS + DIST - 2) {
      helper_sweep<true, DIST>(sm, r, warp, lane);
      helper_sweep<false, DIST>(sm, r, warp, lane);
    } else {
      helper_or_finish<REFINE, CORRECTION, DIST + 1>(sm, r, warp, lane, sigma);
    }
  } else if (warp == CHAIN_WARPS + NAHEAD) {
    finish_sweep<REFINE, CORRECTION>(sm, lane, sigma);
  }
}

// xt = M^-1 rhs and dx = D xt (CORRECTION: xt += M^-1 rhs), by the sweep warps
template <bool REFINE, bool CORRECTION>
__device__ __forceinline__ void solve_sweeps(Smem& sm, Ring& r, int warp, int lane,
                                             float sigma) {
  if (warp < CHAIN_WARPS) {
    chain_sweep<true>(sm, r, lane, warp);
    chain_sweep<false>(sm, r, lane, warp);
  } else if (RINGED && warp == COPIER) {
    copier_sweep<true>(r, warp, lane);
    copier_sweep<false>(r, warp, lane);
  } else {
    helper_or_finish<REFINE, CORRECTION, 2>(sm, r, warp, lane, sigma);
  }
}

template <int LEN>
__device__ __forceinline__ void copy(float* dst, const float* src) {
  for (int e = threadIdx.x; e < LEN; e += NT) dst[e] = src[e];
}

template <bool REFINE>
__global__ void __launch_bounds__(NT)
structured_admm_kernel(Params P, Ptrs g) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t zo = (size_t)b * NV, mo = (size_t)b * NM;
  // this thread's z elements and constraint rows, tid + q NT for q < EPT,
  // for the whole launch (an element past NV, or a row past NM, is none)
  if (g.done0[b] != 0) {
    // done on entry: the state passes through
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const int e = tid + q * NT;
      if (e < NV) {
        g.x[zo + e] = g.x0[zo + e];
        g.zx[zo + e] = g.zx0[zo + e];
        g.yx[zo + e] = g.yx0[zo + e];
      }
      if (e < NM) {
        g.zc[mo + e] = g.zc0[mo + e];
        g.yc[mo + e] = g.yc0[mo + e];
      }
    }
    if (tid == 0) {
      g.done[b] = g.done0[b];
      g.iters[b] = g.iters0[b];
      g.rp[b] = g.rp0[b];
      g.rd[b] = g.rd0[b];
    }
    return;
  }
  ZElem ze[EPT];
  MRow mr[EPT];
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    ze[q] = make_zelem(tid + q * NT);
    mr[q] = make_mrow(tid + q * NT);
  }

  Ring ring{g.Lsub + (size_t)b * N * BW * BLK2};
  if constexpr (RINGED) ring_start(sm, ring, warp, lane);
  if constexpr (PACKED_LDI) {
    const float* src = g.Ldi + (size_t)b * N * BLK2;
    for (int e = tid; e < N * BLK2; e += NT) {
      const int k = e / BLK2, i = (e % BLK2) / BLK, j = e % BLK;
      if (j <= i) sm.Ldi[k * TRI + i * (i + 1) / 2 + j] = src[e];
    }
  } else {
    copy<N * BLK2>(sm.Ldi, g.Ldi + (size_t)b * N * BLK2);
  }
  if constexpr (LAYOUT == SPLIT) {
    // the distance-1 blocks L[j+1,j], j < N - 1
    for (int e = tid; e < D1_FLOATS; e += NT)
      sm.Lsub[e] = ring.lsub[(e / BLK2) * BW * BLK2 + e % BLK2];
  } else if constexpr (!RINGED) {
    copy<LSUB_FLOATS>(sm.Lsub, ring.lsub);
  }
  copy<NB>(sm.u, g.u + (size_t)b * NB);
  copy<N * NG * BLK>(sm.J, g.J + (size_t)b * N * NG * BLK);
  copy<NEQ>(sm.fseg, g.f_rows + (size_t)b * NEQ);
  // the lean layout's iterates, in their owner's registers (own_iter)
  float X[EPT], ZX[EPT], YX[EPT], ZC[EPT], YC[EPT];
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int e = tid + q * NT;
    if (e < NV) {
      const size_t j = zo + ze[q].z;
      if constexpr (LAYOUT != LEAN) {
        sm.qs[e] = g.qs[j];
        sm.Ps[e] = g.Ps[j];
        sm.rx[e] = g.rx[j];
        sm.lxs[e] = g.lxs[j];
        sm.uxs[e] = g.uxs[j];
        sm.thx[e] = g.thx[j];
      } else if (e == NB) {
        sm.Ps[P_AT] = g.Ps[j];
        sm.rx[P_AT] = g.rx[j];
      }
      sm.D[e] = g.D[j];
      own_iter(sm.x, X, q, e) = g.x0[j];
      own_iter(sm.zx, ZX, q, e) = g.zx0[j];
      own_iter(sm.yx, YX, q, e) = g.yx0[j];
    }
  }
  if constexpr (LAYOUT != LEAN) {
    copy<NM>(sm.rc, g.rc + mo);
    copy<NM>(sm.lcs, g.lcs + mo);
    copy<NM>(sm.ucs, g.ucs + mo);
    copy<NM>(sm.E, g.E + mo);
    copy<NM>(sm.thr, g.thr + mo);
    copy<NM>(sm.zc, g.zc0 + mo);
    copy<NM>(sm.yc, g.yc0 + mo);
  } else {
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const int i = tid + q * NT;
      if (i < NM) {
        ZC[q] = g.zc0[mo + i];
        YC[q] = g.yc0[mo + i];
      }
    }
  }
  if (tid < KL * KL) sm.Dm[tid] = P.Dm[tid];
  if (tid == 0) {
    sm.p = g.p[b];
    sm.s = g.s[b];
    sm.done = 0;
  }
  __syncthreads();

  const float alpha = P.alpha, sigma = P.sigma;
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int e = tid + q * NT;
    if (e < NV) {
      const ZConst c = z_const(sm, g, e, zo + ze[q].z);
      sm.t0[e] = sigma * own_iter(sm.x, X, q, e) - c.qs + c.rx * own_iter(sm.zx, ZX, q, e) -
                 own_iter(sm.yx, YX, q, e);
    }
    if (e < NM) {
      const MConst c = m_const(sm, g, e, mo + e);
      sm.wa[e] = c.E * (c.rc * own_iter(sm.zc, ZC, q, e) - own_iter(sm.yc, YC, q, e));
    }
  }
  __syncthreads();

  float rp = g.rp0[b], rd = g.rd0[b];
  int k = 0;
  while (k < P.cap && sm.done == 0) {
    // ---- rhs = t0 + D A' wa (the p row is the finishing warp's) ----
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const int e = tid + q * NT;
      if (e < NB) sm.rhs[e] = sm.t0[e] + sm.D[e] * at_elem(sm, sm.wa, ze[q]);
    }
    __syncthreads();

    // ---- xt = M^-1 rhs and dx = D xt ----
    solve_sweeps<REFINE, false>(sm, ring, warp, lane, sigma);
    __syncthreads();

    if (REFINE) {
      for (int r = 0; r < P.kkt_refine; ++r) {
        // ---- xt += M^-1 (rhs - M xt) ----
#pragma unroll
        for (int q = 0; q < EPT; ++q) {
          const int e = tid + q * NT;
          if (e < NM) {
            const MConst c = m_const(sm, g, e, mo + e);
            sm.wb[e] = c.E * (c.rc * (c.E * a_row(sm, sm.dx, e, mr[q])));
          }
          if (r == 0 && e < NB) sm.wc[e] = sm.rhs[e];
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < EPT; ++q) {
          const int e = tid + q * NT;
          if (e < NB) {
            const ZConst c = z_const(sm, g, e, zo + ze[q].z);
            sm.rhs[e] = sm.wc[e] - ((c.Ps + sigma + c.rx) * sm.xt[e] +
                                    sm.D[e] * at_elem(sm, sm.wb, ze[q]));
          }
        }
        __syncthreads();
        solve_sweeps<REFINE, true>(sm, ring, warp, lane, sigma);
        __syncthreads();
      }
    }

    // ---- zt = E A dx; relaxed prox and dual updates; next t0 and wa ----
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const int i = tid + q * NT;
      if (i < NM) {
        const MConst c = m_const(sm, g, i, mo + i);
        float& zc = own_iter(sm.zc, ZC, q, i);
        float& yc = own_iter(sm.yc, YC, q, i);
        float za;
        if constexpr (LAYOUT == LEAN)
          za = fma_first(alpha * c.E, a_row(sm, sm.dx, i, mr[q]), 1.f - alpha, zc);
        else
          za = alpha * c.E * a_row(sm, sm.dx, i, mr[q]) + (1.f - alpha) * zc;
        float zn = soft_update(za, yc, c.rc, c.lo, c.hi, c.th);
        float yn = ftz(yc + c.rc * (za - zn));
        yc = yn;
        zc = zn;
        sm.wa[i] = c.E * (c.rc * zn - yn);
      }
    }
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const int e = tid + q * NT;
      if (e < NV) {
        const ZConst c = z_const(sm, g, e, zo + ze[q].z);
        float& x = own_iter(sm.x, X, q, e);
        float& zx = own_iter(sm.zx, ZX, q, e);
        float& yx = own_iter(sm.yx, YX, q, e);
        float xt = sm.xt[e];
        float xn, za;
        if constexpr (LAYOUT == LEAN) {
          xn = ftz(fma_first(alpha, xt, 1.f - alpha, x));
          za = fma_first(alpha, xt, 1.f - alpha, zx);
        } else {
          xn = ftz(alpha * xt + (1.f - alpha) * x);
          za = alpha * xt + (1.f - alpha) * zx;
        }
        float zn = soft_update(za, yx, c.rx, c.lo, c.hi, c.th);
        float yn = ftz(yx + c.rx * (za - zn));
        x = xn;
        zx = zn;
        yx = yn;
        sm.t0[e] = sigma * xn - c.qs + c.rx * zn - yn;
      }
    }
    ++k;
    __syncthreads();

    if (k % P.check_every == 0 || k >= P.cap) {
      // ---- divergence freeze (NaN-safe) and OSQP residuals ----
      bool big = false;
      float part = 0.f;  // this thread's defect rows' part of f.(E yc), in the order of q
#pragma unroll
      for (int q = 0; q < EPT; ++q) {
        const int e = tid + q * NT;
        if (e < NV) {
          const float x = own_iter(sm.x, X, q, e);
          big |= !(fabsf(x) <= 1e12f) || !(fabsf(own_iter(sm.yx, YX, q, e)) <= 1e12f);
          sm.dx[e] = sm.D[e] * x;
        }
        if (e < NM) {
          const float yc = own_iter(sm.yc, YC, q, e);
          big |= !(fabsf(yc) <= 1e12f);
          float w = m_const(sm, g, e, mo + e).E * yc;
          sm.wb[e] = w;
          if (e < NEQ) part = q == 0 ? sm.fseg[e] * w : part + sm.fseg[e] * w;
        }
      }
      float tot = block_sum<NWARP>(part, sm.red);  // syncs: dx and wb are complete
#pragma unroll
      for (int q = 0; q < EPT; ++q) {
        const int e = tid + q * NT;
        if (e < NM) sm.wc[e] = a_row(sm, sm.dx, e, mr[q]);  // A D x
        if (e < NB) sm.xt[e] = at_elem(sm, sm.wb, ze[q]);   // A' E yc
        else if (e == NB) sm.xt[e] = -tot;
      }
      __syncthreads();
      // m[0] r_prim, m[1] r_dual, m[2] scale_p, m[3] scale_d
      float m[4] = {0.f, 0.f, 0.f, 0.f};
      bool nan = false;
#pragma unroll
      for (int q = 0; q < EPT; ++q) {
        const int i = tid + q * NT;
        if (i < NM) {
          const float zc = own_iter(sm.zc, ZC, q, i);
          float e = m_const(sm, g, i, mo + i).E, ax = e * sm.wc[i];
          float t0 = fabsf((ax - zc) / e), t1 = fabsf(ax / e), t2 = fabsf(zc / e);
          nan |= isnan(t0) || isnan(t1) || isnan(t2);
          m[0] = fmaxf(m[0], t0);
          m[2] = fmaxf(m[2], fmaxf(t1, t2));
        }
      }
#pragma unroll
      for (int q = 0; q < EPT; ++q) {
        const int j = tid + q * NT;
        if (j < NV) {
          const ZConst c = z_const(sm, g, j, zo + ze[q].z);
          const float zx = own_iter(sm.zx, ZX, q, j), yx = own_iter(sm.yx, YX, q, j);
          float d = sm.D[j], x = own_iter(sm.x, X, q, j), aty = d * sm.xt[j];
          float t0 = fabsf(d * (x - zx));
          float t1 = fabsf((c.Ps * x + c.qs + aty + yx) / d);
          float t2 = fmaxf(fabsf(d * x), fabsf(d * zx));
          float t3 = fmaxf(fmaxf(fabsf(c.Ps * x / d), fabsf(c.qs / d)),
                           fmaxf(fabsf(aty / d), fabsf(yx / d)));
          nan |= isnan(t0) || isnan(t1) || isnan(t2) || isnan(t3);
          m[0] = fmaxf(m[0], t0);
          m[1] = fmaxf(m[1], t1);
          m[2] = fmaxf(m[2], t2);
          m[3] = fmaxf(m[3], t3);
        }
      }
      block_max<4, NWARP>(m, sm.red);
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

  if constexpr (RINGED) ring_end(ring, warp);
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int e = tid + q * NT;
    if (e < NV) {
      const size_t j = zo + ze[q].z;
      g.x[j] = own_iter(sm.x, X, q, e);
      g.zx[j] = own_iter(sm.zx, ZX, q, e);
      g.yx[j] = own_iter(sm.yx, YX, q, e);
    }
    if (e < NM) {
      g.zc[mo + e] = own_iter(sm.zc, ZC, q, e);
      g.yc[mo + e] = own_iter(sm.yc, YC, q, e);
    }
  }
  if (tid == 0) {
    g.done[b] = sm.done;
    g.iters[b] = g.iters0[b] + k;
    g.rp[b] = rp;
    g.rd[b] = rd;
  }
}

}  // namespace

// Bytes of shared memory a block takes (in the layout of the build).
extern "C" int mpc_structured_admm_smem_bytes() { return (int)sizeof(Smem); }

// Threads per block.
extern "C" int mpc_structured_admm_threads() { return NT; }

// Blocks of the kernel that one SM holds at a time (negative: a CUDA error).
extern "C" int mpc_structured_admm_blocks_per_sm() {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(structured_admm_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, structured_admm_kernel<false>, NT,
                                                        smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// ptrs: the NPTRS pointers of struct Ptrs, in its order; Dm: KL x KL floats; cap:
// the iterations of this dispatch.
extern "C" int mpc_structured_admm(void* const* ptrs, const float* Dm, float sigma, float alpha,
                                   float eps_abs, float eps_rel, int cap, int check_every,
                                   int kkt_refine, int B, void* stream) {
  if (B <= 0) return 0;
  Params P;
  for (int i = 0; i < KL * KL; ++i) P.Dm[i] = Dm[i];
  P.sigma = sigma;
  P.alpha = alpha;
  P.eps_abs = eps_abs;
  P.eps_rel = eps_rel;
  P.cap = cap;
  P.check_every = check_every;
  P.kkt_refine = kkt_refine;
  Ptrs g;
  memcpy(&g, ptrs, sizeof(Ptrs));
  auto kernel = kkt_refine > 0 ? structured_admm_kernel<true> : structured_admm_kernel<false>;
  kernel<<<B, NT, (int)sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(P, g);
  return (int)cudaGetLastError();
}

// Called once when the library is loaded: both instantiations may use the
// block's shared memory (a launch sets nothing, so it can be captured into a
// CUDA graph as it is).
extern "C" int mpc_structured_admm_init() {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(structured_admm_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(structured_admm_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return (int)err;
}
