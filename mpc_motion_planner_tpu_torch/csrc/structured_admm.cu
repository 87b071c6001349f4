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
//   (the lean and far layouts keep those only their owner reads elsewhere).
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
// joints; 24 at 7 and 8; 28 at 9; 32 at 10; 36 at 11 and 12) and ROWS =
// ceil(BLK / 32) rows a lane of a sweep warp: one up to 10 joints, two up to
// 21 (lane r owns rows r and r + 32; past one row the sweeps read their
// blocks where they lie, chain_sweep_late). A thread owns
// EPT z elements and EPT constraint rows (MPC_EPT, which the build sets to
// ceil(max(NV, NM) / 1024), kernels/structured_admm.py
// ept_of), so the block has NT = max(NV, NM) / EPT threads rounded up to
// whole warps. EPT = 1 up to 1024: 512 at 19 nodes, 672 at 25, 352 at 13,
// 992 at 37; 448 at 19 nodes and 6 joints, 576 at 8, 640 at 9, 704 at 10;
// 832 at 25 nodes and 9 joints, 928 at 10; 544 at order 2 x 9 segments, 416
// at order 4 x 4, 640 at order 4 x 6, 928 at order 4 x 9, 384 at order 5 x
// 3. EPT = 2 past it: 544 at 40 nodes (1,048 rows), 608 at 46, 544 at order
// 4 x 10 and at 31 nodes and 9 joints, 832 at 61 nodes, 992 at 73, 1024 at
// 76; EPT = 3 past 2048 (768 threads at 85 nodes, 864 at 97), EPT = 4 past
// 3072 (832 at 121 nodes, 1024 at 154), EPT = 5 past 4096 (864 at 157,
// the pair layout). A build
// may name another EPT (for holding and timing one against another), and the
// only operation it changes is the order of the sum of the p row's defect
// part in the check (block_sum of part), which follows the threads' rows.
// Then the block's shared memory bounds the geometry (157 nodes of order 3
// take 233,520 B in the deep layout, and 178 nodes 235,232 B in rank 0 of
// the pair layout);
// everything else follows the geometry: a band width of BW takes BW - 1
// helper warps and BW - 1 look-ahead vectors (the sweeps need 2 + BW warps).
//
// Shared memory: the build picks one of eight layouts from the geometry
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
// * Far is the lean layout without J, the node constraint Jacobians (N NG
//   BLK floats, 51,072 B at 76 nodes), the largest member that no sweep
//   reads: only the element-wise products of A (a_row, a row's BLK terms)
//   and A' (at_elem, an element's NG terms) read it, and they read it from
//   the problem's J in device memory through the read-only path where they
//   use it (jac; 6.7 MB for 132 blocks at 76 nodes, inside L2). 25 to 31
//   segments of order 3 (76 to 94 nodes: 238,736 B lean, 187,664 B far at
//   76; 226,864 B at 94), order 4 x 17 to x 21 (191,008 B at 69 nodes), 9
//   joints at 49 to 61 nodes, 10 joints at 40 to 49. The products are the
//   lean build's, term by term and in its order, so where both fit the two
//   give the same results, bitwise.
// * Deep is the far layout without Ldi (packed, N TRI floats: 89,628 B at 97
//   nodes, the largest member left): node k's Ldi block travels through the
//   copier's ring with node k's run, a second bulk copy from its own 16-byte
//   boundary onto the slot's barrier (a block of BLK2 floats is no multiple
//   of 4), whose expected bytes count both; node N - 1, whose run no sweep
//   reads, is copied for its Ldi alone. The chain fetches Ldi_k a step
//   before step k (chain_fetch), so a forward sweep copies a node one step
//   earlier (AHEAD) and the ring holds BW + 2 slots (ring_step); the chain
//   finds the slot and the parity as for its distance-1 block (ldi_take).
//   It reads the block's full rows (columns) and puts the zeros above the
//   diagonal back, as the packed layouts do, so the products keep their
//   terms and order and where both fit deep gives far's results, bitwise.
//   32 to 51 segments of order 3 (97 to 154 nodes: 233,424 B far, 158,000 B
//   deep at 97; 229,824 B at 154), order 4 x 22 to x 33, 9 joints at 64 to
//   109 nodes, 10 joints at 52 to 88.
// * Pair is the deep layout in a cluster of two blocks, one problem a
//   cluster: rank 0 holds everything deep holds but the copier's ring and
//   runs every warp deep runs but the copier; rank 1 holds the ring (its
//   slots and the barriers its bulk copies complete on, struct Peer) and
//   runs the copier. Rank 0's chain and helpers read each ring block they
//   need from rank 1's shared memory (distributed shared memory, through the
//   mapped generic address, pair_slots) where and when deep reads it: the
//   warp copies it with 16-byte loads into a staging buffer of its own
//   (stage_block; a row a lane read from the peer would touch 21 places of
//   it) and reads it there as deep reads its ring, so the products keep
//   their terms and order and where both fit pair gives deep's results,
//   bitwise. A block waits only on barriers in its own shared memory, so a
//   relay (lane 0 of the warp after rank 1's copier) waits on each copy's
//   barrier in copy order and then arrives, with release at cluster scope,
//   on a barrier of the same slot in rank 0 (pair_bars), on which rank 0's
//   readers wait with acquire at cluster scope; the parity they wait for is
//   deep's (ring_copy_count). The helper of distance 2 publishes its steps
//   in rank 0 as in deep, and rank 0's otherwise idle copier warp forwards
//   them into rank 1's progress count (forward_progress), which the copier
//   and the relay follow as deep's copier does; the copies go LEAD = 4 steps
//   ahead, two more than deep's, for the two hops. Where rank 0's loop ends
//   (its problem done, frozen, or the dispatch's iterations run) it sets
//   rank 1's stop flag, and the copier and the relay leave at the first copy
//   whose step never comes. Both ranks leave a launch through one cluster
//   barrier, and rank 0 reads rank 1 only after a first one that follows
//   both ranks' barrier initialisation; a problem done on entry leaves both
//   blocks at once, neither touching the other. Every block of a launch has
//   the larger rank's shared memory (SMEM_BYTES). 52 to 58 segments of order
//   3 (157 to 175 nodes, five elements a thread: 233,520 B deep, rank 0
//   208,752 B, rank 1 49,680 B at 157), order 4 x 34 to x 41, 9 joints at
//   112 to 133 nodes, 10 at 91 to 118, 11 at 76 to 103, 12 at 61 to 94 and
//   14 at 37 to 76 (rank 1 197,856 B, the larger). Order 4 at 14 joints
//   takes it nowhere: its ring of eight slots of four blocks fits no block.
//   The launch names the cluster (cudaLaunchKernelEx): a cluster the card
//   cannot place is refused and runs nothing. Measured (chip_smoke.py phase
//   30, B=2048, NVIDIA H100 80GB HBM3 at 700 W), where deep also fits: all
//   nine outputs bitwise deep's, 66 clusters at a time against 132 blocks.
// Registers: 672 threads are 21 warps,
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
// B (chip_smoke.py phase 25). The far layout spills more at the same
// registers: 76 nodes (1024 threads) 64 and 32, 1,404 and 2,512 B; 61 nodes
// (832, built only to hold it) 72, 1,032 and 892 B; order 4 x 17 (896) 72,
// 1,064 and 908 B; 9 joints at 49 nodes (832) 72 and 32, 1,860 and 3,056 B;
// 10 joints at 40 nodes (768) 80 and 40, 1,868 and 2,988 B (phase 26).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace mpc;

namespace {

// threads: EPT z elements and EPT rows each (thread t owns elements t, t +
// NT, ...), in whole warps
constexpr int EPT = MPC_EPT;
constexpr int NT = (((NM > NV ? NM : NV) + EPT - 1) / EPT + 31) / 32 * 32;
constexpr int NWARP = NT / 32;
constexpr int NB = N * BLK;              // 399 banded variables; element NB is p
constexpr int VPAD = (BLK + 3) / 4 * 4;  // a node's BLK values in a 16-byte aligned row
// rows of a block a lane of a sweep warp owns: lane r owns rows r, r + 32, ...
constexpr int ROWS = (BLK + 31) / 32;
// steps by which the sweeps' reads of their blocks, and so the ring's
// copies, come later than one row a lane has them (chain_sweep_late)
constexpr int LATE = ROWS > 1 ? 1 : 0;
static_assert(EPT >= 1 && NT * EPT >= NM && NT * EPT >= NV, "EPT z elements and rows a thread");
static_assert(NT <= 1024, "a block has at most 1024 threads");
static_assert(NT >= KL * KL, "a thread per entry of Dm");
static_assert(BW >= 1, "a band has at least one sub-diagonal block");
static_assert(BLK % 3 == 0 && VPAD <= 32 * ROWS, "ROWS rows a lane, summed in three partial sums");
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory of one block
constexpr int TRI = BLK * (BLK + 1) / 2; // a packed lower-triangular block
constexpr int LSUB_USED = (N - 2) * BW + 1;  // Lsub blocks up to L[N-1,N-2]
constexpr int NAHEAD = BW - 1;             // look-ahead distances 2..BW
constexpr int NAHEAD_BUF = NAHEAD > 0 ? NAHEAD : 1;

// the shared-memory layouts (the header says which geometry takes which)
enum Layout { FULL = 0, COMPACT = 1, SPLIT = 2, STREAM = 3, LEAN = 4, FAR = 5, DEEP = 6, PAIR = 7 };
constexpr int LAYOUT = MPC_SMEM_LAYOUT;
static_assert(LAYOUT >= FULL && LAYOUT <= PAIR, "a layout of common.cuh");
constexpr bool PACKED_LDI = LAYOUT != FULL;
// pair: the deep layout in a cluster of two blocks, the ring in rank 1
constexpr bool PAIRED = LAYOUT == PAIR;
// deep and pair: Ldi goes through the ring with Lsub, a node's block with its run
constexpr bool LDI_RINGED = LAYOUT == DEEP || PAIRED;
// far and deep: J out of shared memory
constexpr bool J_OUT = LAYOUT == FAR || LDI_RINGED;
// lean, far and deep: the owner-only vectors out of shared memory
constexpr bool OWNERS_OUT = LAYOUT == LEAN || J_OUT;
// stream, lean, far and deep: the chain's distance-1 blocks go through the ring too
constexpr bool STREAMED = LAYOUT == STREAM || OWNERS_OUT;
// split, stream, lean, far and deep: Lsub goes through a ring of node runs.
// Node m's blocks L[m+1,m] .. L[m+BW,m] lie side by side in Lsub; its run is
// the last BW - 1 of them (split: the helpers' blocks) or all BW (the others:
// the chain's block L[m+1,m] too). A ring of RING runs holds node m's in slot
// m % RING, copied from the 16-byte boundary at or before the run, so up to 3
// floats more; in the deep layout the slot holds Ldi_m after the run, copied
// the same way. A forward sweep copies node m's run after step m - AHEAD,
// LEAD steps before its first read: AHEAD = LEAD, or LEAD + 1 in the deep
// layout, whose chain fetches Ldi_m a step before step m. RING is the fewest
// runs for which no copy overwrites a run still to be read: BW + AHEAD - 2
// in the split, one more in the others, whose chain reads a run one step
// after the helper of distance 2 in the backward sweep (ring_step). The pair
// layout copies LEAD = 4 steps ahead (two slots more, in rank 1): a copy
// there reaches rank 0's readers through the progress forwarder and the
// relay, two hops more than in the deep layout, and at a lead of 2 its
// readers waited for it (kernel 3 at 32 x 3 and 25 iterations, B=2048,
// NVIDIA H100 80GB HBM3 at 700 W: 398 ms at a lead of 2, 322 ms at 4, 305
// ms with no wait at all).
constexpr bool RINGED = LAYOUT == SPLIT || STREAMED;
static_assert(!RINGED || BW >= 2, "the helper of distance 2 paces the ring's copier");
constexpr int RUN0 = STREAMED ? 0 : 1;  // a run starts at L[m+1+RUN0,m]
constexpr int LEAD = PAIRED ? 4 : 2;
constexpr int AHEAD = LEAD + LDI_RINGED;
constexpr int RING = BW + AHEAD - 1 - RUN0;
constexpr int RUN = (BW - RUN0) * BLK2;
constexpr int SLOT = (RUN + 6) / 4 * 4;
// a slot's floats: the run, and (deep) Ldi from its 16-byte boundary
constexpr int LDI_SLOT = LDI_RINGED ? (BLK2 + 6) / 4 * 4 : 0;
constexpr int STRIDE = SLOT + LDI_SLOT;
constexpr int LAST_RUN = N - 2 - RUN0;  // the last node whose run a sweep reads
// the last node copied: the last whose run a sweep reads, or (deep) N - 1,
// whose Ldi the chain reads (its copy brings no run)
constexpr int LAST_COPY = LDI_RINGED ? N - 1 : LAST_RUN;
constexpr int RING0 = RING < LAST_COPY + 1 ? RING : LAST_COPY + 1;  // runs copied at the start
// runs copied in each forward sweep (nodes RING .. LAST_COPY) and in each backward one
constexpr int NCOPY = LAST_COPY + 1 - RING > 0 ? LAST_COPY + 1 - RING : 0;
// the distance-1 blocks L[k,k-1] that stay in shared memory (the split's)
constexpr int D1_FLOATS = LAYOUT == SPLIT ? (N - 1) * BLK2 : 0;
// The pair layout's rank 0 reads each ring block it needs from rank 1 into a
// staging buffer of its own warp (stage_block: 16-byte loads that a warp
// issues together, where the sweeps' own loads, a row of a block a lane,
// would each touch 21 places of the peer's memory), and the sweeps read it
// there as the other layouts read their ring: a buffer of STAGE floats (a
// block from its 16-byte boundary) for each chain warp's Ldi and L blocks and
// for each helper's block. PAIR_HEAD: the barriers of the ring's slots (2
// floats each) and the progress count, to a 16-byte boundary.
constexpr int STAGE = (BLK2 + 6) / 4 * 4;
constexpr int STAGE_BUFS = 4 + NAHEAD;
constexpr int PAIR_HEAD = (RING * 2 + 1 + 3) / 4 * 4;
// floats of Lsub in shared memory: all blocks; those up to L[N-1,N-2]; or
// (split, stream, lean, far, deep) the resident distance-1 blocks, up to 3
// floats to a 16-byte boundary, the ring, its barriers (8 bytes each) and the
// copier's progress count; or (pair, rank 0) up to 3 floats to a 16-byte
// boundary, a barrier per slot, which rank 1's relay arrives on, the progress
// count and the staging buffers
constexpr int LSUB_FLOATS = LAYOUT == FULL      ? N * BW * BLK2
                            : LAYOUT == COMPACT ? LSUB_USED * BLK2
                            : PAIRED            ? 3 + PAIR_HEAD + STAGE_BUFS * STAGE
                                                : D1_FLOATS + 3 + RING * (STRIDE + 2) + 1;
// The owner-only vectors: 16 z and m vectors are read and written only by
// the thread that owns the element or row, the launch's constants qs, Ps,
// rx, lxs, uxs, thx (z) and rc, lcs, ucs, E, thr (m) and the iterates x, zx,
// yx (z) and zc, yc (m); only the finishing warp reads two of them across
// threads, the arrow element's Ps and rx. The lean, far and deep layouts keep
// one float of each in shared memory, so that every member stays: the arrow
// element's Ps and rx (at P_AT), the others unused (z_const, m_const,
// own_iter).
constexpr int OWN_V = OWNERS_OUT ? 1 : NV, OWN_M = OWNERS_OUT ? 1 : NM;
constexpr int P_AT = OWNERS_OUT ? 0 : NB;  // the arrow element's Ps and rx
// The node constraint Jacobians J, read only by the products of A and A'
// (a_row, at_elem): the far and deep layouts keep one float of them in
// shared memory and read them from device memory where they are used (jac).
constexpr int J_FLOATS = J_OUT ? 1 : N * NG * BLK;
// Ldi: full, packed lower triangular, or (deep: in the ring) one float
constexpr int LDI_FLOATS = LDI_RINGED ? 1 : N * (PACKED_LDI ? TRI : BLK2);

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
  float Ldi[LDI_FLOATS];
  float Lsub[LSUB_FLOATS];
  float u[NB];
  float J[J_FLOATS];
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
// The pair layout's rank 1: the ring's slots (each 16-byte aligned), the
// barriers its copies complete on, the steps the helper of distance 2 in rank
// 0 has finished and rank 0's stop flag.
struct Peer {
  float slots[RING * STRIDE];
  unsigned long long bar[RING];
  unsigned progress, stop;
};
static_assert(offsetof(Peer, stop) == offsetof(Peer, progress) + 4, "the stop flag follows");
// dynamic shared memory of every block of a launch: the larger rank's (pair)
constexpr int SMEM_BYTES =
    PAIRED && sizeof(Peer) > sizeof(Smem) ? (int)sizeof(Peer) : (int)sizeof(Smem);
static_assert(SMEM_BYTES <= SMEM_LIMIT, "shared memory of one block: the build's layout");
// split, stream, lean, far, deep and pair: where the ring (pair: rank 0's
// barriers) starts in Lsub, the first 16-byte boundary of the block's shared
// memory after the resident distance-1 blocks
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
// of a constraint row. The lean and far layouts read them from device memory
// through the read-only path (L2), the others from shared memory. An element-wise
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
  if constexpr (OWNERS_OUT)
    return {__ldg(g.qs + j), __ldg(g.Ps + j), __ldg(g.rx + j),
            __ldg(g.lxs + j), __ldg(g.uxs + j), __ldg(g.thx + j)};
  else
    return {sm.qs[e], sm.Ps[e], sm.rx[e], sm.lxs[e], sm.uxs[e], sm.thx[e]};
}

// the thread's row i, at j = mo + i
__device__ __forceinline__ MConst m_const(const Smem& sm, const Ptrs& g, int i, size_t j) {
  if constexpr (OWNERS_OUT)
    return {__ldg(g.E + j), __ldg(g.rc + j), __ldg(g.lcs + j), __ldg(g.ucs + j), __ldg(g.thr + j)};
  else
    return {sm.E[i], sm.rc[i], sm.lcs[i], sm.ucs[i], sm.thr[i]};
}

// An iterate of the thread's q-th element or row e: in shared memory, or
// (lean and far) in the owner's registers, r[q] (q unrolled).
__device__ __forceinline__ float& own_iter(float* s, float (&r)[EPT], int q, int e) {
  if constexpr (OWNERS_OUT) return r[q];
  else return s[e];
}

// a u + b v as the other layouts' builds contract it, fma(a, u, b v). Where v
// is a register (the lean and far layouts' iterates) nvcc contracts the other
// product, fma(b, v, a u), so those builds spell the FMA out and give the
// stream build's results bitwise.
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

// Entry idx of the problem's node constraint Jacobians J (N, NG, BLK): from
// shared memory, or (far, deep) from the problem's J in device memory, Jg, through
// the read-only path (L2; 51 KB a problem at 76 nodes). A product takes the
// entries it needs one load each, all independent, so their latency overlaps.
__device__ __forceinline__ float jac(const Smem& sm, const float* Jg, int idx) {
  if constexpr (J_OUT) return __ldg(Jg + idx);
  else return sm.J[idx];
}

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
__device__ __forceinline__ float at_elem(const Smem& sm, const float* Jg, const float* w,
                                         const ZElem& z) {
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
  for (int r = 0; r < NG; ++r) acc += jac(sm, Jg, z.jb + r * BLK) * w[z.gb + r];
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
__device__ __forceinline__ float a_row(const Smem& sm, const float* Jg, const float* v, int i,
                                       const MRow& r) {
  if (i < NEQ) {
    float dxv = 0.f;
#pragma unroll
    for (int j = 0; j < KL; ++j) dxv += sm.Dm[r.k * KL + j] * v[r.base + j * BLK];
    return dxv - sm.p * v[r.base + r.k * BLK + NQ] - sm.fseg[i] * v[NB];
  }
  const float* vn = v + r.k;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < BLK; c += 3) {
    s0 += jac(sm, Jg, r.base + c) * vn[c];
    s1 += jac(sm, Jg, r.base + c + 1) * vn[c + 1];
    s2 += jac(sm, Jg, r.base + c + 2) * vn[c + 2];
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
  const float* ldi;   // the problem's Ldi in device memory (B, N, BLK, BLK): deep
  float* slots;       // slot 0 (pair, rank 0: in rank 1, a generic address)
  unsigned bar;       // the shared address of slot 0's barrier (pair: in this block)
  unsigned progress;  // the shared address of the steps the helper of distance 2 finished
                      // (pair, rank 0: in rank 1, a shared::cluster address)
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
// The pair layout's relay: lane 0 of the warp after the copier, in rank 1.
constexpr int RELAY = COPIER + 1;
static_assert(!PAIRED || NWARP > RELAY, "a warp for the relay");

// ---- the pair layout: a cluster of two blocks ----

// This block's rank in its cluster.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of both blocks arrives, and waits for all the others: what
// each wrote before it is seen after it (threads need not be converged).
__device__ __forceinline__ void pair_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address in block `rank` of the byte at offset `at` of
// the dynamic shared memory (the same offset in both blocks of a pair).
__device__ __forceinline__ unsigned peer_address(const void* base, unsigned at, unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"((unsigned)__cvta_generic_to_shared(base) + at), "r"(rank));
  return a;
}

// A 32-bit word of the peer's shared memory, written with release at cluster
// scope, and one of this block's, read with acquire at cluster scope.
__device__ __forceinline__ void store_release_cluster(unsigned a, unsigned v) {
  asm volatile("st.release.cluster.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned load_acquire_cluster(unsigned a) {
  unsigned v;
  asm volatile("ld.acquire.cluster.shared::cta.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}

// One bulk copy of the tensor memory accelerator into shared address dst,
// completing on the barrier at shared address bar.
__device__ __forceinline__ void bulk_copy(unsigned dst, const float* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(dst),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Copy node m's run into slot m % RING: the copier issues one bulk copy of
// the tensor memory accelerator, from the 16-byte boundary at or before the
// run to the one at or after its end (the up to 3 floats past it belong to
// the next node's first block), which completes on the slot's barrier;
// every thread that keeps the state updates it. The deep layout's copy of a
// node brings its Ldi block too, a second bulk copy from its own 16-byte
// boundary onto the same barrier (a block is 441 floats at 7 joints, no
// multiple of 4), and node N - 1's brings its Ldi alone.
__device__ __forceinline__ void ring_copy(Ring& r, int warp, int lane, int m) {
  const int s = m % RING;
  const float* src = r.lsub + (m * BW + RUN0) * BLK2;
  const unsigned phase = (unsigned)(__cvta_generic_to_global(src) >> 2) & 3u;
  if (warp == COPIER && lane == 0) {
    const unsigned bytes = 16 * ((RUN + phase + 3) / 4), bar = r.bar + 8 * s;
    // the slot's earlier contents were read by ordinary loads before a barrier
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if constexpr (LDI_RINGED) {
      const float* ldi = r.ldi + m * BLK2;
      const unsigned lphase = (unsigned)(__cvta_generic_to_global(ldi) >> 2) & 3u;
      const unsigned lbytes = 16 * ((BLK2 + lphase + 3) / 4);
      const bool run = m <= LAST_RUN;
      const unsigned slot = (unsigned)__cvta_generic_to_shared(r.slots + s * STRIDE);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"((run ? bytes : 0u) + lbytes)
                   : "memory");
      if (run) bulk_copy(slot, src - phase, bytes, bar);
      bulk_copy(slot + 4 * SLOT, ldi - lphase, lbytes, bar);
    } else {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"(bytes)
                   : "memory");
      bulk_copy((unsigned)__cvta_generic_to_shared(r.slots + s * STRIDE), src - phase, bytes,
                bar);
    }
  }
  r.parity ^= 1u << s;
  r.phases = (r.phases & ~(3u << 2 * s)) | (phase << 2 * s);
}

// Wait until the phase of the barrier at shared address bar whose parity is
// given has completed (pair: with acquire at cluster scope, since rank 0's
// barriers complete on the arrivals of rank 1's relay).
__device__ __forceinline__ void barrier_wait(unsigned bar, unsigned parity) {
  if constexpr (PAIRED)
    asm volatile(
        "{\n.reg .pred p;\nWAIT:\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n}" ::"r"(bar),
        "r"(parity)
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\nWAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n}" ::"r"(bar),
        "r"(parity)
        : "memory");
}

// The pair layout's rank 0: the ring's slots in rank 1's shared memory (the
// generic address of the same offset there), and the barriers in this block's
// that rank 1's relay arrives on.
__device__ __forceinline__ const float* pair_slots(const Smem& sm) {
  return cg::this_cluster().map_shared_rank(reinterpret_cast<const Peer*>(&sm)->slots, 1);
}

__device__ __forceinline__ unsigned pair_bars(const Smem& sm) {
  return (unsigned)__cvta_generic_to_shared(sm.Lsub + RING_AT);
}

// Pair, rank 0: the block at blk (in rank 1) into staging buffer j of this
// block: the calling warp copies it from its 16-byte boundary in 16-byte
// loads, four a lane at a time so that their round trips overlap, and
// returns where it lies in the buffer. Buffer 2w is chain warp w's block of
// Lsub, 2w + 1 its Ldi block, 4 + d - 2 the helper of distance d's block.
constexpr int STAGE_PER_LANE = (STAGE / 4 + 31) / 32;
__device__ __forceinline__ const float* stage_block(unsigned bars, int j, const float* blk) {
  // the buffers follow the barriers and the progress count (PAIR_HEAD floats)
  float4* buf = reinterpret_cast<float4*>(
      __cvta_shared_to_generic(bars + 4 * (PAIR_HEAD + j * STAGE)));
  const int lane = threadIdx.x & 31;
  const uintptr_t a = reinterpret_cast<uintptr_t>(blk);
  const float4* src = reinterpret_cast<const float4*>(a & ~uintptr_t(15));
  const int off = (int)(a & 15) / 4, n = (off + BLK2 + 3) / 4;
  __syncwarp();  // every lane has read the buffer's last block
#pragma unroll
  for (int c = 0; c < STAGE_PER_LANE; c += 4) {
    float4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = lane + 32 * (c + i);
      if (c + i < STAGE_PER_LANE && q < n) v[i] = src[q];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = lane + 32 * (c + i);
      if (c + i < STAGE_PER_LANE && q < n) buf[q] = v[i];
    }
  }
  __syncwarp();
  return reinterpret_cast<const float*>(buf) + off;
}

// Wait until slot s's last copy has landed.
__device__ __forceinline__ void ring_wait(const Ring& r, int s) {
  barrier_wait(r.bar + 8 * s, ((r.parity >> s) & 1u) ^ 1u);
}

// Block b of node m's run (L[m+1+RUN0+b, m]) once it has landed.
__device__ __forceinline__ const float* ring_block(const Ring& r, int m, int b) {
  const int s = m % RING;
  ring_wait(r, s);
  const float* blk = r.slots + s * STRIDE + ((r.phases >> 2 * s) & 3u) + b * BLK2;
  if constexpr (PAIRED) return stage_block(r.bar, 4 + (int)(threadIdx.x >> 5) - CHAIN_WARPS, blk);
  return blk;
}

// Pair, rank 1's relay: once slot s's last copy has landed on this block's
// barrier, arrive on rank 0's barrier of the slot (at the offset of rank 0's
// pair_bars; rank 1's slots start its shared memory), with release at
// cluster scope, so that rank 0's readers may read the slot.
__device__ __forceinline__ void relay_signal(const Ring& r, int s) {
  ring_wait(r, s);
  const unsigned full = peer_address(r.slots, offsetof(Smem, Lsub) + 4 * RING_AT, 0);
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(full + 8 * s)
               : "memory");
}

// Once at the start of a launch, by the warps that keep the ring's state
// (the helpers and the copier): the state, the barriers, and the runs of
// nodes 0..RING-1 (those a sweep reads).
// In the pair layout this is rank 0's: its helpers keep the state, with the
// slots in rank 1; its copier warp initialises the barriers rank 1's relay
// arrives on and the progress count, which it forwards to rank 1
// (forward_progress), and copies nothing (peer_block).
__device__ __forceinline__ void ring_start(Smem& sm, Ring& r, int warp, int lane) {
  if ((warp < CHAIN_WARPS || warp >= CHAIN_WARPS + NAHEAD) && warp != COPIER) return;
  if constexpr (PAIRED) {
    r.slots = const_cast<float*>(pair_slots(sm));
    r.bar = pair_bars(sm);
  } else {
    r.slots = sm.Lsub + RING_AT;
    r.bar = (unsigned)__cvta_generic_to_shared(sm.Lsub + RING_AT + RING * STRIDE);
  }
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
  if (PAIRED && warp == COPIER) return;
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
// N-2-m, one after the helper of distance 2. Forward, node t + AHEAD's copy
// evicts node t + AHEAD - RING's, read at step t + AHEAD - RING <= t.
// Backward, node N-1-t-LEAD-BW's (helper BW reads it first) evicts node
// N-1-t-LEAD-BW+RING's, last read (split: by helper 2) at step t + LEAD + BW
// - 2 - RING = t, or (stream: by the chain) at step t + LEAD + BW - 1 - RING
// = t (deep: at step t - 1). The deep layout's chain reads Ldi_m for its
// step m (forward) or N-1-m (backward) in the step before: forward at step
// m - 1, a step before the run, so node m is copied after step m - AHEAD =
// m - 3, and backward at step N-2-m, with the run's last read. The copier
// issues the copy once the helper of distance 2 has published that it
// finished step t, after the sweep's barrier of step t, before which every
// read of the evicted run came; past one row a lane, where every read comes
// a step later (chain_sweep_late), once it finished step t + 1 (LATE). An iteration copies 2 (N - 2 - BW) runs in
// every layout but the pair (40 at 25 nodes of order 3), as RING - 1 - RUN0 = BW - 1
// holds (deep: RING = BW + 2 with LAST_COPY = N - 1); the pair layout, 2 (N -
// LEAD - BW) with RING = BW + LEAD. kernels/
// structured_admm.py ring_schedule models this schedule step by step and
// tests/test_torch_geometry.py holds it.
//
// The pair layout keeps this schedule: the helper of distance 2 publishes
// its steps in rank 0 as here, rank 0's copier warp forwards them into rank
// 1 (forward_progress), where the copier waits for them, and so does the
// relay, which then waits for the copy to land and arrives on rank 0's
// barrier of its slot; each waits until the step comes or rank 0 has stopped
// (ring_step returns false: the copy is never needed).
template <bool FWD>
__device__ __forceinline__ bool ring_step(Ring& r, int warp, int lane, int t) {
  const int m = FWD ? t + AHEAD : N - 1 - t - LEAD - BW;
  const bool copy = FWD ? m <= LAST_COPY && m > r.hi : m >= 0 && m < r.lo;
  ++r.steps;
  if (warp == CHAIN_WARPS && lane == 0)
    asm volatile("st.release.cta.shared.u32 [%0], %1;" ::"r"(r.progress), "r"(r.steps)
                 : "memory");
  if (!copy) return true;
  if constexpr (PAIRED) {
    if ((warp == COPIER || warp == RELAY) && lane == 0) {
      for (;;) {
        // the stop flag (the word after the progress count, struct Peer)
        // first: once it is set, the progress count is final
        const unsigned stop = load_acquire_cluster(r.progress + 4);
        if ((int)load_acquire_cluster(r.progress) >= r.steps + LATE) break;
        if (stop) return false;
        __nanosleep(64);
      }
    }
  } else if (warp == COPIER && lane == 0) {
    unsigned done;
    for (;;) {
      asm volatile("ld.acquire.cta.shared.u32 %0, [%1];"
                   : "=r"(done)
                   : "r"(r.progress)
                   : "memory");
      if ((int)done >= r.steps + LATE) break;
      __nanosleep(64);
    }
  }
  ring_copy(r, warp, lane, m);
  if (PAIRED && warp == RELAY && lane == 0) relay_signal(r, m % RING);
  if (FWD) {
    r.hi = m;
    r.lo = max(r.lo, m - RING + 1);
  } else {
    r.lo = m;
    r.hi = min(r.hi, m + RING - 1);
  }
  return true;
}

// The copier's part of a sweep: the ring's state, step by step, with the
// copies (pair, rank 1: the copier's or the relay's; false once rank 0 has
// stopped).
template <bool FWD>
__device__ __forceinline__ bool copier_sweep(Ring& r, int warp, int lane) {
  for (int t = 0; t < N; ++t)
    if (!ring_step<FWD>(r, warp, lane, t)) return false;
  return true;
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
// LAST_COPY, backward the NCOPY nodes below those the forward leaves in the
// ring, after ring_start's nodes 0 .. RING0-1. So the copies into slot s up
// to the one that holds node m (s = m % RING) at a read follow from m, the
// sweep and the pairs of sweeps done before it: the slot's first copy, one
// pair's copies into it (forward nodes s + RING, s + 2 RING, ... <=
// LAST_COPY; backward nodes s, s + RING, ... < NCOPY) per pair done, and this
// pair's up to node m's. kernels/structured_admm.py ring_copy_count is the
// same count, held against ring_schedule.
template <bool FWD>
__device__ __forceinline__ int ring_copy_count(int m, int pairs) {
  const int s = m % RING;
  const int fwd = LAST_COPY >= s ? (LAST_COPY - s) / RING : 0;
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
  if constexpr (PAIRED) {
    const int s = j % RING;
    barrier_wait(pair_bars(sm) + 8 * s, (unsigned)(ring_copy_count<FWD>(j, r.pairs) - 1) & 1u);
    const float* src = r.lsub + j * BW * BLK2;
    return stage_block(pair_bars(sm), 2 * (int)(threadIdx.x >> 5),
                       pair_slots(sm) + s * STRIDE +
                           ((unsigned)(__cvta_generic_to_global(src) >> 2) & 3u));
  } else if constexpr (STREAMED) {
    const int s = j % RING;
    const unsigned bar = (unsigned)__cvta_generic_to_shared(sm.Lsub + RING_AT + RING * STRIDE);
    barrier_wait(bar + 8 * s, (unsigned)(ring_copy_count<FWD>(j, r.pairs) - 1) & 1u);
    const float* src = r.lsub + j * BW * BLK2;
    return sm.Lsub + RING_AT + s * STRIDE + ((unsigned)(__cvta_generic_to_global(src) >> 2) & 3u);
  }
  return sm.Lsub + (LAYOUT == SPLIT ? j : j * BW) * BLK2;
}

// Row rr (forward) or column rr (backward) of Ldi_k in the deep layout: the
// block after node k's run in its slot, once its copy has landed (the slot
// and the parity of its barrier phase found as lsub_d1 finds them), stored
// whole; the zeros above the diagonal are put back as load_ldi puts them
// back, so the products are those of the other layouts.
template <bool FWD>
__device__ __forceinline__ void ldi_take(float (&M)[BLK], const Smem& sm, const Ring& r, int k,
                                         int rr) {
  const int s = k % RING;
  const float* blk;
  if constexpr (PAIRED) {
    barrier_wait(pair_bars(sm) + 8 * s, (unsigned)(ring_copy_count<FWD>(k, r.pairs) - 1) & 1u);
    const float* src = r.ldi + k * BLK2;
    blk = stage_block(pair_bars(sm), 2 * (int)(threadIdx.x >> 5) + 1,
                      pair_slots(sm) + s * STRIDE + SLOT +
                          ((unsigned)(__cvta_generic_to_global(src) >> 2) & 3u));
  } else {
    const unsigned bar = (unsigned)__cvta_generic_to_shared(sm.Lsub + RING_AT + RING * STRIDE);
    barrier_wait(bar + 8 * s, (unsigned)(ring_copy_count<FWD>(k, r.pairs) - 1) & 1u);
    const float* src = r.ldi + k * BLK2;
    blk = sm.Lsub + RING_AT + s * STRIDE + SLOT +
          ((unsigned)(__cvta_generic_to_global(src) >> 2) & 3u);
  }
#pragma unroll
  for (int i = 0; i < BLK; ++i) {
    if (FWD) M[i] = i <= rr ? blk[rr * BLK + i] : 0.f;
    else M[i] = i >= rr ? blk[i * BLK + rr] : 0.f;
  }
}

// The chain's blocks and right-hand side of step t, into registers (its
// block of Lsub last: in the stream layout it may wait for it; the deep
// layout's Ldi_k comes from the ring too).
template <bool FWD>
__device__ __forceinline__ void chain_fetch(const Smem& sm, const Ring& r, int t, int rr,
                                            float (&L)[BLK], float (&Dg)[BLK], float& v) {
  const int k = node_of<FWD>(t);
  if constexpr (LDI_RINGED) ldi_take<FWD>(Dg, sm, r, k, rr);
  else load_ldi<FWD>(Dg, sm, k, rr);
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


// ---- past one row a lane: the sweeps read their blocks where they lie ----
//
// Past 10 joints (BLK > 32) a lane owns ROWS = 2 rows of a block. A chain
// lane's rows of its two blocks (2 ROWS BLK floats, 144 at 12 joints) and a
// helper lane's (72) do not fit its registers beside the vector, and their
// spills leave the SM's L1, which the block's shared memory leaves small: a
// first design that fetched them ahead as one row a lane does spilled 10.9
// KB and took 179 us an iteration per block at 12 joints and 19 nodes,
// slower than the plain loop (PERF.md §6). So each sweep warp reads a
// block's entries from shared memory as its product uses them, the terms of
// a row in dot_row's three partial sums and order: the chain at its turn,
// the helpers after the barrier of the step they serve. Each such read
// comes one step window later than its fetch ahead would, and the copier
// issues each of the ring's copies one step later too (LATE, ring_step), so
// the ring's schedule is the one-row schedule shifted by a step: no copy
// overwrites a run before its last read, and every copy still lands LEAD
// steps before its first (kernels/structured_admm.py ring_schedule models
// the shift).

// How a block's entries lie: whole (BLOCK_WHOLE), lower triangular stored
// whole with the zeros above the diagonal read as zeros (LOWER_WHOLE: the
// deep layout's Ldi), or packed lower triangular (LOWER_PACKED: the
// compact to far layouts' Ldi).
enum BlockKind { BLOCK_WHOLE, LOWER_WHOLE, LOWER_PACKED };
constexpr BlockKind LDI_KIND = LDI_RINGED ? LOWER_WHOLE : PACKED_LDI ? LOWER_PACKED : BLOCK_WHOLE;

// Entry i of row rr (forward) or column rr (backward) of a block at blk,
// as load_block, load_ldi and ldi_take put it into registers.
template <bool FWD, BlockKind KIND>
__device__ __forceinline__ float block_entry(const float* blk, int rr, int i) {
  if constexpr (KIND == BLOCK_WHOLE) return FWD ? blk[rr * BLK + i] : blk[i * BLK + rr];
  else if constexpr (KIND == LOWER_WHOLE)
    return FWD ? (i <= rr ? blk[rr * BLK + i] : 0.f) : (i >= rr ? blk[i * BLK + rr] : 0.f);
  else
    return FWD ? (i <= rr ? blk[rr * (rr + 1) / 2 + i] : 0.f)
               : (i >= rr ? blk[i * (i + 1) / 2 + rr] : 0.f);
}

// dot_row of row (column) rr of the block at blk, read where it lies. (A
// copy of the row gathered first and summed by dot_row takes 9% less time a
// window at 12 joints, but its last bits move the 12-joint chain's final
// times off the JAX fixture's on one state more: PERF.md §6.)
template <bool FWD, BlockKind KIND>
__device__ __forceinline__ float dot_block(const float* blk, int rr, const float (&v)[VPAD]) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < BLK; i += 3) {
    s0 += block_entry<FWD, KIND>(blk, rr, i) * v[i];
    s1 += block_entry<FWD, KIND>(blk, rr, i + 1) * v[i + 1];
    s2 += block_entry<FWD, KIND>(blk, rr, i + 2) * v[i + 2];
  }
  return (s0 + s1) + s2;
}

// Ldi_k where it lies: in shared memory, or (deep) in node k's slot of the
// ring once its copy has landed (found as ldi_take finds it).
template <bool FWD>
__device__ __forceinline__ const float* ldi_block(const Smem& sm, const Ring& r, int k) {
  if constexpr (PAIRED) {
    const int s = k % RING;
    barrier_wait(pair_bars(sm) + 8 * s, (unsigned)(ring_copy_count<FWD>(k, r.pairs) - 1) & 1u);
    const float* src = r.ldi + k * BLK2;
    return stage_block(pair_bars(sm), 2 * (int)(threadIdx.x >> 5) + 1,
                       pair_slots(sm) + s * STRIDE + SLOT +
                           ((unsigned)(__cvta_generic_to_global(src) >> 2) & 3u));
  } else if constexpr (LDI_RINGED) {
    const int s = k % RING;
    const unsigned bar = (unsigned)__cvta_generic_to_shared(sm.Lsub + RING_AT + RING * STRIDE);
    barrier_wait(bar + 8 * s, (unsigned)(ring_copy_count<FWD>(k, r.pairs) - 1) & 1u);
    const float* src = r.ldi + k * BLK2;
    return sm.Lsub + RING_AT + s * STRIDE + SLOT +
           ((unsigned)(__cvta_generic_to_global(src) >> 2) & 3u);
  }
  return sm.Ldi + k * (PACKED_LDI ? TRI : BLK2);
}

// The rows rr[j] = min(lane + 32 j, BLK - 1) of a lane: one past the
// block's last row takes that row again and stores nothing.
__device__ __forceinline__ void lane_rows(int lane, int (&rr)[ROWS]) {
#pragma unroll
  for (int j = 0; j < ROWS; ++j) rr[j] = min(lane + 32 * j, BLK - 1);
}

// chain_sweep past one row a lane: the same steps, turns and order of
// terms, each block read at the turn that uses it.
template <bool FWD>
__device__ __forceinline__ void chain_sweep_late(Smem& sm, Ring& r, int lane, int turn) {
  int rr[ROWS];
  lane_rows(lane, rr);
  float* pub = FWD ? sm.ys : sm.xs;
  float vec[VPAD], v[ROWS];
  const auto rhs = [&](int t) {
    const int k = node_of<FWD>(t);
#pragma unroll
    for (int j = 0; j < ROWS; ++j) v[j] = FWD ? sm.rhs[k * BLK + rr[j]] : sm.ys[k * VPAD + rr[j]];
  };
  rhs(turn);
  for (int t = 0; t < N; ++t) {
    if (t % CHAIN_WARPS != turn) {
      sweep_barrier<FWD>();
      continue;
    }
    const int k = node_of<FWD>(t);
    float acc[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) acc[j] = v[j];
    if (t >= 1) {
      float ah[ROWS][NAHEAD_BUF];
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
#pragma unroll
        for (int d = 2; d <= BW; ++d)
          ah[j][d - 2] = t >= d ? sm.ahead[d - 2][k * BLK + rr[j]] : 0.f;
      load_vec(vec, pub + node_of<FWD>(t - 1) * VPAD);
      const float* blk = lsub_d1<FWD>(sm, r, FWD ? k - 1 : k);
      // distances 1, 2, ..., BW in turn, the order of the plain solve
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        acc[j] = v[j] - dot_block<FWD, BLOCK_WHOLE>(blk, rr[j], vec);
#pragma unroll
        for (int d = 2; d <= BW; ++d) acc[j] -= ah[j][d - 2];
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      if (lane + 32 * j < BLK) sm.tb[lane + 32 * j] = acc[j];
    warp_barrier();
    load_vec(vec, sm.tb);
    const float* dg = ldi_block<FWD>(sm, r, k);
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const float out = dot_block<FWD, LDI_KIND>(dg, rr[j], vec);
      if (lane + 32 * j < BLK) pub[k * VPAD + lane + 32 * j] = out;
    }
    sweep_barrier<FWD>();
    if (t + CHAIN_WARPS < N) rhs(t + CHAIN_WARPS);
  }
  if (!FWD) ++r.pairs;
}

// helper_sweep past one row a lane: the block of step t read after the
// barrier of step t, as the product uses it.
template <bool FWD, int DIST>
__device__ __forceinline__ void helper_sweep_late(Smem& sm, Ring& r, int warp, int lane) {
  int rr[ROWS];
  lane_rows(lane, rr);
  float* out = sm.ahead[DIST - 2];
  const float* pub = FWD ? sm.ys : sm.xs;
  float vec[VPAD];
  for (int t = 0; t < N; ++t) {
    const int k = node_of<FWD>(t);
    sweep_barrier<FWD>();
    if (t + DIST < N) {
      load_vec(vec, pub + k * VPAD);
      const float* blk;
      if constexpr (RINGED)
        blk = ring_block(r, FWD ? t : N - 1 - t - DIST, DIST - 1 - RUN0);
      else
        blk = sm.Lsub + ((FWD ? k : k - DIST) * BW + DIST - 1) * BLK2;
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const float s = dot_block<FWD, BLOCK_WHOLE>(blk, rr[j], vec);
        if (lane + 32 * j < BLK) out[node_of<FWD>(t + DIST) * BLK + lane + 32 * j] = s;
      }
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
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int c = lane + 32 * j;
      if (c < BLK) {
        const int k = node_of<false>(t), e = k * BLK + c;
        float v = sm.xs[k * VPAD + c] - sm.u[e] * zp;
        if (CORRECTION) v += sm.xt[e];
        sm.xt[e] = v;
        sm.dx[e] = sm.D[e] * v;
      }
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
      if constexpr (ROWS > 1) {
        helper_sweep_late<true, DIST>(sm, r, warp, lane);
        helper_sweep_late<false, DIST>(sm, r, warp, lane);
      } else {
        helper_sweep<true, DIST>(sm, r, warp, lane);
        helper_sweep<false, DIST>(sm, r, warp, lane);
      }
    } else {
      helper_or_finish<REFINE, CORRECTION, DIST + 1>(sm, r, warp, lane, sigma);
    }
  } else if (warp == CHAIN_WARPS + NAHEAD) {
    finish_sweep<REFINE, CORRECTION>(sm, lane, sigma);
  }
}

// Pair, rank 0's copier warp (lane 0) through a pair of sweeps: the steps the
// helper of distance 2 publishes in this block (ring_step), forwarded into
// rank 1's progress count with release at cluster scope, until both sweeps'
// steps are there. So no sweep warp pays for a release at cluster scope.
__device__ __forceinline__ void forward_progress(const Smem& sm, Ring& r, int lane) {
  r.steps += 2 * N;
  if (lane != 0) return;
  const unsigned to = peer_address(&sm, offsetof(Peer, progress), 1);
  unsigned sent = ~0u;
  for (;;) {
    unsigned done;
    asm volatile("ld.acquire.cta.shared.u32 %0, [%1];" : "=r"(done) : "r"(r.progress) : "memory");
    if (done != sent) store_release_cluster(to, sent = done);
    if ((int)done >= r.steps) return;
    __nanosleep(32);
  }
}

// xt = M^-1 rhs and dx = D xt (CORRECTION: xt += M^-1 rhs), by the sweep warps
template <bool REFINE, bool CORRECTION>
__device__ __forceinline__ void solve_sweeps(Smem& sm, Ring& r, int warp, int lane,
                                             float sigma) {
  if (warp < CHAIN_WARPS) {
    if constexpr (ROWS > 1) {
      chain_sweep_late<true>(sm, r, lane, warp);
      chain_sweep_late<false>(sm, r, lane, warp);
    } else {
      chain_sweep<true>(sm, r, lane, warp);
      chain_sweep<false>(sm, r, lane, warp);
    }
  } else if (RINGED && warp == COPIER) {
    if constexpr (PAIRED) {
      forward_progress(sm, r, lane);  // rank 1 copies (peer_block)
    } else {
      copier_sweep<true>(r, warp, lane);
      copier_sweep<false>(r, warp, lane);
    }
  } else {
    helper_or_finish<REFINE, CORRECTION, 2>(sm, r, warp, lane, sigma);
  }
}

template <int LEN>
__device__ __forceinline__ void copy(float* dst, const float* src) {
  for (int e = threadIdx.x; e < LEN; e += NT) dst[e] = src[e];
}

// The pair layout's rank 1 (struct Peer): the copier (lane 0 of warp
// COPIER) and the relay (lane 0 of warp RELAY), each with its own copy of the
// ring's state, run rank 0's sweeps until rank 0 stops; every other thread
// waits at the closing cluster barrier.
__device__ __forceinline__ void peer_block(Peer& pr, const Ptrs& g, int b, int warp, int lane) {
  Ring r{g.Lsub + (size_t)b * N * BW * BLK2, g.Ldi + (size_t)b * N * BLK2};
  r.slots = pr.slots;
  r.bar = (unsigned)__cvta_generic_to_shared(pr.bar);
  r.progress = (unsigned)__cvta_generic_to_shared(&pr.progress);
  r.lo = 0;
  r.hi = RING0 - 1;
  r.parity = r.phases = 0;
  r.steps = 0;
  const bool copier = warp == COPIER && lane == 0, relay = warp == RELAY && lane == 0;
  if (copier) {
    asm volatile("st.shared.u32 [%0], 0;" ::"r"(r.progress) : "memory");
    asm volatile("st.shared.u32 [%0], 0;" ::"r"(r.progress + 4) : "memory");
    for (int s = 0; s < RING; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(r.bar + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  pair_sync();  // both blocks' barriers and counts are initialised
  if (copier || relay) {
    // ring_start's copies, then rank 0's pairs of sweeps
    for (int m = 0; m <= r.hi; ++m) {
      ring_copy(r, warp, lane, m);
      if (relay) relay_signal(r, m % RING);
    }
    while (copier_sweep<true>(r, warp, lane) && copier_sweep<false>(r, warp, lane)) {
    }
    if (copier) ring_end(r, warp);
  }
  pair_sync();  // rank 0 reads nothing here any more, and nothing here signals it
}

template <bool REFINE>
__global__ void __launch_bounds__(NT)
structured_admm_kernel(Params P, Ptrs g) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  // the problem: the block's, or (pair) its cluster's
  const int b = PAIRED ? blockIdx.x / 2 : blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t zo = (size_t)b * NV, mo = (size_t)b * NM;
  // this thread's z elements and constraint rows, tid + q NT for q < EPT,
  // for the whole launch (an element past NV, or a row past NM, is none)
  if (g.done0[b] != 0) {
    // done on entry: the state passes through (pair: rank 0's work; neither
    // block touches the other's shared memory)
    if (PAIRED && cluster_rank() != 0) return;
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
  if constexpr (PAIRED) {
    if (cluster_rank() != 0) {
      peer_block(*reinterpret_cast<Peer*>(smem_raw), g, b, warp, lane);
      return;
    }
  }
  ZElem ze[EPT];
  MRow mr[EPT];
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    ze[q] = make_zelem(tid + q * NT);
    mr[q] = make_mrow(tid + q * NT);
  }

  Ring ring{g.Lsub + (size_t)b * N * BW * BLK2, g.Ldi + (size_t)b * N * BLK2};
  if constexpr (RINGED) ring_start(sm, ring, warp, lane);
  if constexpr (PAIRED) pair_sync();  // both blocks' barriers and counts are initialised
  if constexpr (LDI_RINGED) {
    // the deep and pair layouts' Ldi comes through the ring (ring_copy)
  } else if constexpr (PACKED_LDI) {
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
  const float* Jg = g.J + (size_t)b * N * NG * BLK;  // the problem's J in device memory
  if constexpr (!J_OUT) copy<N * NG * BLK>(sm.J, Jg);
  copy<NEQ>(sm.fseg, g.f_rows + (size_t)b * NEQ);
  // the lean and far layouts' iterates, in their owner's registers (own_iter)
  float X[EPT], ZX[EPT], YX[EPT], ZC[EPT], YC[EPT];
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int e = tid + q * NT;
    if (e < NV) {
      const size_t j = zo + ze[q].z;
      if constexpr (!OWNERS_OUT) {
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
  if constexpr (!OWNERS_OUT) {
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
      if (e < NB) sm.rhs[e] = sm.t0[e] + sm.D[e] * at_elem(sm, Jg, sm.wa, ze[q]);
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
            sm.wb[e] = c.E * (c.rc * (c.E * a_row(sm, Jg, sm.dx, e, mr[q])));
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
                                    sm.D[e] * at_elem(sm, Jg, sm.wb, ze[q]));
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
        if constexpr (OWNERS_OUT)
          za = fma_first(alpha * c.E, a_row(sm, Jg, sm.dx, i, mr[q]), 1.f - alpha, zc);
        else
          za = alpha * c.E * a_row(sm, Jg, sm.dx, i, mr[q]) + (1.f - alpha) * zc;
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
        if constexpr (OWNERS_OUT) {
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
        if (e < NM) sm.wc[e] = a_row(sm, Jg, sm.dx, e, mr[q]);  // A D x
        if (e < NB) sm.xt[e] = at_elem(sm, Jg, sm.wb, ze[q]);   // A' E yc
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

  if constexpr (PAIRED) {
    // rank 1's copier and relay leave at the first copy whose step never comes
    if (tid == 0) store_release_cluster(peer_address(&sm, offsetof(Peer, stop), 1), 1u);
  } else if constexpr (RINGED) {
    ring_end(ring, warp);
  }
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
  if constexpr (PAIRED) pair_sync();  // rank 1 reads and signals nothing here any more
}

}  // namespace

// Bytes of shared memory a block takes (in the layout of the build; pair:
// every block of the launch, the larger rank's).
extern "C" int mpc_structured_admm_smem_bytes() { return SMEM_BYTES; }

// Bytes of shared memory of the pair layout's rank 0 (struct Smem) and rank 1
// (struct Peer); 0 and 0 in the other layouts.
extern "C" int mpc_structured_admm_rank_bytes(int rank) {
  return !PAIRED ? 0 : rank == 0 ? (int)sizeof(Smem) : (int)sizeof(Peer);
}

// Threads per block.
extern "C" int mpc_structured_admm_threads() { return NT; }

// Blocks of the kernel that one SM holds at a time (negative: a CUDA error).
extern "C" int mpc_structured_admm_blocks_per_sm() {
  const int smem = SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(structured_admm_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, structured_admm_kernel<false>, NT,
                                                        smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

namespace {

// The pair layout's launch: 2 B blocks, clusters of two (cudaLaunchKernelEx,
// cudaLaunchAttributeClusterDimension), each block with SMEM_BYTES.
void pair_config(int B, cudaStream_t stream, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(2u * (unsigned)B);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = SMEM_BYTES;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 2;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

// Clusters of the pair layout the card runs at a time
// (cudaOccupancyMaxActiveClusters; 0 in the other layouts, negative: a CUDA
// error).
extern "C" int mpc_structured_admm_active_clusters() {
  if (!PAIRED) return 0;
  cudaError_t err = cudaFuncSetAttribute(structured_admm_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  pair_config(1, nullptr, &cfg, &attr);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, structured_admm_kernel<false>, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

// ptrs: the NPTRS pointers of struct Ptrs, in its order; Dm: KL x KL floats; cap:
// the iterations of this dispatch. A launch the card refuses (pair: a cluster
// it cannot place) runs nothing and returns its CUDA error.
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
  if constexpr (PAIRED) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    pair_config(B, static_cast<cudaStream_t>(stream), &cfg, &attr);
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, P, g);
    if (err != cudaSuccess) return (int)err;
  } else {
    kernel<<<B, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(P, g);
  }
  return (int)cudaGetLastError();
}

// Called once when the library is loaded: both instantiations may use the
// block's shared memory (a launch sets nothing, so it can be captured into a
// CUDA graph as it is).
extern "C" int mpc_structured_admm_init() {
  const int smem = SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(structured_admm_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(structured_admm_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return (int)err;
}
