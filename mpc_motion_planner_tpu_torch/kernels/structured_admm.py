"""Kernel 3: the structured boxADMM loop, one QP per thread block, plus the
host part of the solve around it.

Replaces ``mpc_motion_planner_tpu/ops/pallas/structured_admm.py``
``solve_box_qp_structured_pallas`` (``pl.pallas_call`` at :830, body
``_structured_kernel`` :142, with its ``kkt_refine`` steps) and the host
part of its ``_solve_impl`` (:584-1062): the float32 cast, Ruiz scaling,
the ±1e20 bound stand-ins, the soft-row thresholds, the factorization
(kernel 2) with its ok-flag repair, the dispatches of ``rho_update_every``
iterations with the rho update and the refactorization between them
(``ops.qp_structured.admm_chunked``, here with kernels 2 and 3), and the
un-scaling.

The library is built per transcription (``build.Geometry`` of the OCP:
nodes, spline order and the robot's joint count): :func:`ept_of` z
elements and as many constraint rows per thread (:func:`threads`: one of
each up to 1024 threads, two past them, three past 2048 elements), node
vectors padded to :func:`vpad` floats, one helper warp and one look-ahead
vector per distance 2..bw of the band (bw = the spline order), and the first
of nine shared-memory layouts (:func:`choose_layout`, :func:`smem_bytes`)
that fits a block: full; compact where the full one does not fit (Ldi
packed lower triangular, Lsub without its unread tail: 232,176 B at 25 nodes
of the Panda, where full takes 262,000 B; 19 nodes of an 8-joint robot;
order 4 at 21 nodes); split where neither fits (compact's Ldi, only the
chain's distance-1 blocks of Lsub, and a ring of the helper warps' blocks, a
node's at a time, that a copier warp fills by TMA bulk copies from the Lsub
in device memory: order 4 at 25 nodes, 9 and 10 joints at 19 nodes, 28 nodes
of order 3); stream where the split does not fit (no block of Lsub in
shared memory: the chain's distance-1 blocks go through the same ring, a
node's run one block longer: 37 nodes of order 3 or 4, 9 and 10 joints at
25 nodes, order 5 at 7 segments); lean where the stream does not fit (the
stream layout without the 16 vectors that only the thread owning an element
or row reads: the launch's constants are read from device memory where they
are used, the iterates live in the owner's registers; 49 to 73 nodes of
order 3, 195,824 B at 61; order 4 x 11 to x 16, 9 joints at 34 to 46
nodes, 10 joints at 28 to 37); far where the lean does not fit (the lean
layout without the node constraint Jacobians J, which only the products of
A and A' read, from device memory where they use them: 76 to 94 nodes of
order 3, 187,664 B at 76, where lean takes 238,736 B; order 4 x 17 to x 21,
9 joints at 49 to 61 nodes, 10 joints at 40 to 49); deep where the far does
not fit (the far layout without Ldi, each node's block of which travels
through the copier's ring with the node's run: 97 to 154 nodes of order 3,
158,000 B at 97, where far takes 233,424 B; order 4 x 22 to x 33, 9 joints
at 64 to 109 nodes, 10 joints at 52 to 88); pair where the deep does not
fit (the deep layout in a cluster of two blocks, one problem a cluster:
rank 0 holds all the deep layout holds but the copier's ring, rank 1 the
ring, whose blocks rank 0's warps read into staging buffers of their own,
:func:`rank_bytes`; the copies go :func:`lead` = 4 steps ahead: 157 to 175
nodes of order 3, rank 0 208,752 B at 157, where deep takes 233,520 B;
order 4 x 34 to x 41, 9 joints at 112 to 133 nodes, 10 joints at 91 to
118, 11 at 76 to 103, 12 at 61 to 94, 14 at 37 to 76); where rank 1 cannot
hold the pair's whole ring, the ring is spread over :func:`ring_ranks`
blocks, whole slots a rank, a cluster of 1 + that many (16 to 20 joints at
19 nodes in clusters of three, 208,104 B in each ring rank at 19 joints; 21
joints in clusters of four, 190,640 B, where one rank 1 would take 444,816
B; rank 0 165,392 B); slim where the pair's rank 0 does not fit (the pair
layout with rank 0's staging buffers cut to those in use at one time,
:func:`stage_buffers`: 26 to 32 joints at 19 nodes, rank 0 159,792 to
216,704 B where pair's takes 232,848 to 327,344 B, the ring over 7 ranks
from 29 joints; 178 nodes of order 3, 231,680 B; 14 joints at 79 nodes).
:func:`ring_schedule` models the ring's copies and
reads step by step. Two elements a thread take 40 to 76 nodes of order 3
(608 threads at 46, 832 at 61, 1024 at 76), order 4 x 10 to x 17 and 9
joints from 31 nodes; three take 79 to 115 nodes of order 3 (864 threads
at 97), four 118 to 154, five 157 to 178. A
geometry that fits no layout (181 nodes of order 3: 235,472 B in rank 0 of
the slim layout; order 4 x 42; 9 joints at 139 nodes; 14 joints at 88; 32
joints at 22) raises a ValueError that names the bytes; nothing solves it
another way.
Past 10 joints (blk 33 and more) a lane of a sweep warp owns :func:`rows`
rows of a block, two up to 21 joints, and the sweeps read each block where
it lies as its product uses it, a step later than they would fetch it
ahead, the ring's copies a step later too (:func:`ring_schedule`): 12
joints take the lean layout at 19 nodes (188,768 B, 832 threads); 11
joints at 112 nodes, 12 at 103 and 14 at 88 fit no layout. The figures
below are the 19-node Panda transcription's.

What bounds it on this card: latency. Each iteration is ~157k flops per
problem, 85% of them in the two banded triangular sweeps, and the factors
are 134 KB per problem: reading them from device memory would move 275 MB
per iteration at B=2048, so one problem per 512-thread block runs the whole
iteration budget in one launch with its factors, operator data and iterates
resident in shared memory (~198 KB, one block per SM) and touches device
memory only to load and to store. With one block per SM, a launch takes
(problems / SMs) x iterations x the latency of one iteration, and an
iteration is a chain of 38 dependent block steps, each two 21x21
matrix-vector products deep. Design (``csrc/structured_admm.cu`` has the
details): only the distance-1 term and the ``Ldi`` product of a block step
are on the chain; the terms of distances 2..bw are formed ahead by bw - 1
helper warps; two chain warps take the steps in turn so that the blocks
of a step are in registers before its turn comes; a finishing warp finds the
arrow correction during the forward sweep and finishes each node the
backward sweep delivers; the z-layout vectors are node-major in shared
memory, each thread owns one z element and one constraint row (two of each
past 1024) and computes their places in A and A' once; an iteration without
a check has three block-wide barriers. A block step subtracts its terms in
the plain solve's order (distances 1, 2, ..., bw) and takes every 21-long
row sum in three partial sums; ``ops.qp_structured.banded_solve_lookahead`` states the schedule and
the order in plain PyTorch. Each block stops at its own ``done``, and one that
is done on entry leaves at once: the TPU kernel's lane-group exit,
early-exit chunk schedules and compaction existed because 128 problems
shared a program, and are not needed here; the iteration budgets, the
check rule, the done codes and the iteration counts are kept.

The plain version is ``ops.qp_structured.solve_box_qp_structured`` (the
same semantics in batched PyTorch); :func:`solve_box_qp_structured` takes
it for CPU tensors only and launches the kernels or raises for CUDA ones.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..ops import qp_structured
from ..ops.qp import QPSettings, QPSolution
from ..ops.structure import StructuredA
from . import banded_factor
from .build import (
    LAYOUTS, SMEM_LIMIT, CudaKernel, DeviceCount, Geometry, HostConstants, check_cuda_tensor,
    ptr,
)

KERNEL = CudaKernel(
    "structured_admm", "structured_admm.cu", "mpc_structured_admm",
    [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_float] * 4
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    init="mpc_structured_admm_init", per_geometry="transcription",
    resolve=lambda g: built_geometry(g),
)

# the layouts whose Lsub goes through the copier's ring, those of them whose
# chain reads its blocks from the ring too, those that keep the vectors only
# their owner reads out of shared memory, those that read J from device
# memory, those whose Ldi goes through the ring with Lsub, and those that take
# a cluster of blocks a problem (the ring in ranks 1 .. :func:`ring_ranks`)
RINGED = ("split", "stream", "lean", "far", "deep", "pair", "slim")
STREAMED = ("stream", "lean", "far", "deep", "pair", "slim")
OWNERS_OUT = ("lean", "far", "deep", "pair", "slim")
J_OUT = ("far", "deep", "pair", "slim")
LDI_RINGED = ("deep", "pair", "slim")
PAIRED = ("pair", "slim")

LEAD = 2  # steps between a copy and the step what it brings is first read in
MAX_CLUSTER = 8  # blocks of a cluster the card places (the portable limit)


def lead(layout: str) -> int:
    """LEAD of ``layout``'s ring: 4 in the pair layout, whose copies reach
    rank 0's readers through two hops more (the progress forwarder and the
    relay, in every ring rank alike), else :data:`LEAD`."""
    return 4 if layout in PAIRED else LEAD


def ring_runs(g: Geometry, layout: str = "split") -> int:
    """Slots of the ring (RING) of the split, stream, lean, far, deep or
    pair layout: a slot holds a node's run, copied :func:`lead` steps ahead
    of its first use; bw runs (split), bw + 1 (stream, lean and far, whose
    chain reads a run one step after the helpers in the backward sweep), bw
    + 2 (deep, whose forward sweep copies a step earlier) or bw + 4 (pair,
    two steps earlier still) are the fewest for which no copy overwrites a
    run still to be read (:func:`ring_schedule`)."""
    return g.order + lead(layout) - LEAD + (layout in STREAMED) + (layout in LDI_RINGED)


def ring_slot(g: Geometry, layout: str = "split") -> int:
    """Floats of a ring slot (STRIDE): a node's run of bw - 1 helper blocks
    (split) or of all its bw blocks (stream, lean, far and deep), copied from
    the 16-byte boundary at or before its start to the one at or after its
    end; in the deep layout then the node's Ldi block, copied the same
    way."""
    run = ((g.order - (layout not in STREAMED)) * g.blk ** 2 + 6) // 4 * 4
    return run + ((g.blk ** 2 + 6) // 4 * 4 if layout in LDI_RINGED else 0)


def ring_last(g: Geometry, layout: str = "split") -> int:
    """LAST_COPY: the last node whose run a sweep reads (N - 3 split, N - 2
    the others), or (deep) N - 1, whose Ldi the chain reads."""
    return g.nodes - 1 if layout in LDI_RINGED else g.nodes - 2 - (layout not in STREAMED)


def ring_schedule(g: Geometry, layout: str = "split", iterations: int = 2):
    """A model of the ring of the split, stream, lean, far, deep or pair
    layout (csrc/structured_admm.cu ``ring_start`` and ``ring_step``; the
    pair layout's is the deep layout's at its own :func:`lead`: rank 1's
    copier issues each copy when the progress count the helper of distance
    2 publishes, forwarded into rank 1, says the step has come, as the deep
    layout's copier does, and its relay signals the copy in rank 0 once it
    has landed, one phase of rank 0's barrier of the slot a copy) through
    ``iterations`` pairs of sweeps, forward then backward, step by step.
    Time is counted in steps of the whole run, n = N x sweep + step: the
    reads of step n come after the sweeps' barrier of step n - 1 and before
    that of step n, and the copies issued after step n come after its
    barrier. Returns ``(copies, reads)``: ``copies`` a list of (n, node,
    slot), n = None for those of ``ring_start``; ``reads`` a list of (n,
    node, slot, block, who) with ``who`` "chain" (``chain_fetch``, all but
    the split: block 0 of the run, or in the deep layout also "ldi", the
    node's Ldi) or the helper's distance (``ring_take``). Past one row a
    lane (:func:`rows` > 1) every read comes a step later, where the block's
    product uses it (``chain_sweep_late``, ``helper_sweep_late``: the
    chain's at its turn, a helper's after the barrier of its step), and so
    does every copy after ``ring_start`` (``LATE``)."""
    N, bw = g.nodes, g.order
    run0 = 0 if layout in STREAMED else 1
    ring, last = ring_runs(g, layout), ring_last(g, layout)
    # AHEAD: a forward sweep copies node m after step m - LEAD, or a step
    # earlier where the run carries Ldi_m, which the chain fetches a step
    # before step m
    ahead = lead(layout) + (layout in LDI_RINGED)
    late = int(rows(g) > 1)
    lo, hi = 0, min(ring, last + 1) - 1
    copies = [(None, m, m % ring) for m in range(hi + 1)]
    reads = []
    for sweep in range(2 * iterations):
        fwd, base = sweep % 2 == 0, N * sweep
        for t in range(N):
            for d in range(2, bw + 1):  # ring_take: L[m+d,m] at step t
                if t + d < N:
                    m = t if fwd else N - 1 - t - d
                    reads.append((base + t + late, m, m % ring, d - 1 - run0, d))
            if layout in STREAMED and t + 1 < N:
                # chain_fetch of step t + 1 (after the barrier of step t - 1):
                # L[t+1,t] of node t (forward), L[k+1,k] of node k = N-2-t
                m = t if fwd else N - 2 - t
                reads.append((base + t + late, m, m % ring, 0, "chain"))
            if layout in LDI_RINGED:
                # and Ldi_k of node k = s (forward) or N-1-s (backward) of step
                # s = t + 1, steps 0 and 1 before the sweep's first barrier
                for s in ((0, 1) if t == 0 else (t + 1,)):
                    if s < N:
                        m = s if fwd else N - 1 - s
                        reads.append((base + (s if late else t), m, m % ring, "ldi",
                                      "chain"))
            m = t + ahead if fwd else N - 1 - t - lead(layout) - bw  # ring_step
            if (m <= last and m > hi) if fwd else (0 <= m < lo):
                copies.append((base + t + late, m, m % ring))
                if fwd:
                    hi, lo = m, max(lo, m - ring + 1)
                else:
                    lo, hi = m, min(hi, m + ring - 1)
    return copies, reads


def ring_copy_count(g: Geometry, layout: str, m: int, pairs: int, fwd: bool) -> int:
    """The copies into node m's slot up to the one that holds node m's run
    when a sweep (forward if ``fwd``) reads it after ``pairs`` pairs of
    sweeps (csrc/structured_admm.cu ``ring_copy_count``, from which the
    chain of the stream, lean, far and deep layouts takes the parity of the
    barrier phase it waits for): every pair copies the same runs, forward the
    nodes ring .. last, backward the ``ncopy`` nodes below those the forward
    leaves."""
    ring, last = ring_runs(g, layout), ring_last(g, layout)
    ring0, ncopy, s = min(ring, last + 1), max(last + 1 - ring, 0), m % ring
    fwd_copies = (last - s) // ring if last >= s else 0
    bwd_copies = (ncopy - 1 - s) // ring + 1 if s < ncopy else 0
    now = m // ring if fwd or m >= ncopy else fwd_copies + (ncopy - 1 - m) // ring + 1
    return (s < ring0) + pairs * (fwd_copies + bwd_copies) + now


# dispatch boundaries at which some problem's rho moved (the KKT system is
# rebuilt and refactored at every boundary; where no rho moved it comes out
# bitwise as it was)
REFACTORS = DeviceCount()

# the float32 differentiation matrix on the host, per (collocation, device)
DIFF_MATRIX = HostConstants()


def vpad(g: Geometry) -> int:
    """VPAD: a node's blk values in a 16-byte aligned row, blk rounded up
    to 4 (24 for the Panda)."""
    return -(-g.blk // 4) * 4


def rows(g: Geometry) -> int:
    """ROWS: rows of a block a lane of a sweep warp owns, lane r rows r, r +
    32, ... (one up to 10 joints, two up to 21)."""
    return -(-g.blk // 32)


MAX_THREADS = 1024  # threads of one block


def ept_of(g: Geometry) -> int:
    """EPT, the z elements and constraint rows each thread of ``g``'s block
    owns unless ``g`` names another count: the fewest for which the block
    has at most 1024 threads (1 up to 1024 elements, 2 past them)."""
    return -(-max(g.num_var, g.num_rows) // MAX_THREADS)


def threads(g: Geometry, layout: str = None) -> int:
    """Threads of one block: ept z elements and ept constraint rows each
    (``g.ept`` or else :func:`ept_of`), in whole warps, and no fewer than
    the warps the sweeps take (:func:`sweep_warps`) with the copier of
    ``layout``'s ring and the pair layout's relay (default: the layout ``g``
    names, else the one it takes); only a robot of one joint has fewer
    elements."""
    ept = g.ept or ept_of(g)
    elems = -(-max(g.num_var, g.num_rows) // ept // 32) * 32
    layout = layout or g.layout or choose_layout(g)
    return max(elems, 32 * (sweep_warps(g) + (layout in RINGED) + (layout in PAIRED)))


def smem_bytes(g: Geometry, layout: str = None) -> int:
    """Shared memory of one block of kernel 3 built for ``g``: the size of
    struct Smem of csrc/structured_admm.cu, member by member with its
    alignment, in ``layout`` (default: the one ``g`` names, else the one it
    takes, :func:`choose_layout`); in the pair layout the largest of its
    blocks' (:func:`rank_bytes`), which every block of the launch takes."""
    layout = layout or g.layout or choose_layout(g)
    if layout in PAIRED:
        return max(rank_bytes(g, layout))
    return _struct_bytes(g, layout)


def _peer_bytes(g: Geometry, slots: int) -> int:
    """struct Peer of a ring rank holding ``slots`` of the ring's slots: the
    slots, the barriers its copies complete on, the progress count and rank
    0's stop flag."""
    return 4 * slots * ring_slot(g, "pair") + 8 * slots + 8


def ring_ranks(g: Geometry) -> int:
    """RANKS of the pair layout: the blocks of its cluster that hold the
    ring, ranks 1 .. RANKS, whole slots a rank (:func:`slots_per_rank`):
    ``g.ranks`` where it names them, else the fewest whose share fits a
    block, and at most 7 (a cluster of 8, the portable limit). One wherever
    the pair layout took a geometry before the ring was spread; at 19 nodes
    2 at 16 to 20 joints, 3 at 21."""
    if g.ranks is not None:
        return g.ranks
    ring = ring_runs(g, "pair")
    return next((r for r in range(1, MAX_CLUSTER)
                 if _peer_bytes(g, -(-ring // r)) <= SMEM_LIMIT), MAX_CLUSTER - 1)


def slots_per_rank(g: Geometry) -> int:
    """SLOTS_PER_RANK: the ring's slots a ring rank of the pair layout holds
    at most; slot s lies in rank 1 + s % RANKS at index s / RANKS there
    (csrc/structured_admm.cu ``spread_owns``, ``cluster_slot``)."""
    return -(-ring_runs(g, "pair") // ring_ranks(g))


def stage_buffers(g: Geometry, layout: str = "pair") -> int:
    """STAGE_BUFS of the pair or slim layout's rank 0: a staging buffer of a
    block for each helper's block, and for the chain (CHAIN_BUFS) one for
    each chain warp's two blocks (pair: 4), or those in use at one time
    (slim: one a chain warp, whose two blocks take it in turn, and past one
    row a lane one for both chain warps, whose turns the sweeps' barrier
    keeps apart)."""
    chain = 4 if layout == "pair" else 1 if rows(g) > 1 else 2
    return chain + g.order - 1


def rank_bytes(g: Geometry, layout: str = None) -> tuple:
    """Shared memory of each block of the pair or slim layout's cluster
    (``layout``, default: the one ``g`` names where that is one of them,
    else pair), (rank 0, rank 1, ..): rank 0's struct Smem (the deep
    layout's but the ring's slots: up to 3 floats to a 16-byte boundary, a
    barrier per slot, which the relays arrive on, the progress count, and
    :func:`stage_buffers` staging buffers of a block) and each ring rank's
    struct Peer (its slots, :func:`slots_per_rank`, the barriers its copies
    complete on, the progress count and rank 0's stop flag). Every block of
    the launch takes the largest (:func:`smem_bytes`)."""
    layout = layout or g.layout
    layout = layout if layout in PAIRED else "pair"
    return (_struct_bytes(g, layout), *[_peer_bytes(g, slots_per_rank(g))] * ring_ranks(g))


def _struct_bytes(g: Geometry, layout: str) -> int:
    """The size of struct Smem of csrc/structured_admm.cu in ``layout`` (the
    pair layout: rank 0's)."""
    N, blk, nv, neq, nm, pad = g.nodes, g.blk, g.num_var, g.num_eq, g.num_rows, vpad(g)
    nb, blk2, bw, kl = N * blk, blk * blk, g.order, g.order + 1
    # Ldi: full, packed, or (deep, in the ring) one float
    ldi = 1 if layout in LDI_RINGED else N * (blk2 if layout == "full" else blk * (blk + 1) // 2)
    if layout in PAIRED:  # rank 0: 3 floats to a 16-byte boundary, the
        # barriers (8 bytes each) of the ring in rank 1 and the progress count
        # to a 16-byte boundary, and the staging buffers (STAGE floats: a block
        # from its 16-byte boundary, stage_buffers)
        head = -(-(2 * ring_runs(g, layout) + 1) // 4) * 4
        lsub = 3 + head + stage_buffers(g, layout) * ((blk2 + 6) // 4 * 4)
    elif layout in RINGED:  # the resident distance-1 blocks (split), 3 floats
        # to a 16-byte boundary, the ring, its barriers (8 bytes each) and the
        # copier's progress count
        d1 = (N - 1) * blk2 if layout == "split" else 0
        lsub = d1 + 3 + ring_runs(g, layout) * (ring_slot(g, layout) + 2) + 1
    else:  # compact: the blocks up to L[N-1,N-2]
        lsub = (N * bw if layout == "full" else (N - 2) * bw + 1) * blk2
    # the owner-only vectors (OWN_V, OWN_M): lean, far and deep keep one
    # float of each; J (J_FLOATS): far and deep keep one float
    ov, om = (1, 1) if layout in OWNERS_OUT else (nv, nm)
    jf = 1 if layout in J_OUT else N * g.ng * blk
    fields = ([(ldi, 4), (lsub, 4), (nb, 4), (jf, 4), (neq, 4)]
              + [(ov, 4)] * 6 + [(nv, 4)]  # qs, Ps, rx, lxs, uxs, thx; D
              + [(om, 4)] * 5 + [(ov, 4)] * 3 + [(om, 4)] * 2
              + [(nv, 4), (nm, 4), (nv, 4)]  # t0, wa, rhs
              + [(N * pad, 16), (N * pad, 16), (pad, 16)]  # ys, xs, tb
              + [(max(bw - 1, 1) * nb, 4)]  # ahead: distances 2..bw
              + [(nv, 4)] * 2 + [(nm, 4)] * 2  # xt, dx, wb, wc
              + [(threads(g, layout) // 32 * 4, 4), (kl * kl, 4), (1, 4), (1, 4), (1, 4)])
    off = 0
    for floats, align in fields:
        off = -(-off // align) * align + 4 * floats
    return -(-off // 16) * 16


def built_geometry(g: Geometry) -> Geometry:
    """The geometry kernel 3's library is built for: ``g`` with the ept,
    the layout and the ring ranks it names, or else its own
    (:func:`ept_of`, :func:`choose_layout`, :func:`ring_ranks`; one ring
    rank, the pair layout as it was, stands as None), and not kernel 2's
    ring."""
    g = dataclasses.replace(g, ring=None)
    g = g if g.ept is not None else dataclasses.replace(g, ept=ept_of(g))
    g = g if g.layout is not None else dataclasses.replace(g, layout=choose_layout(g))
    ranks = ring_ranks(g) if g.layout in PAIRED else None
    return dataclasses.replace(g, ranks=ranks if ranks != 1 else None)


def choose_layout(g: Geometry) -> str:
    """The shared-memory layout kernel 3 is built in for ``g``: the first of
    full, compact, split, stream, lean, far, deep, pair and slim
    (``LAYOUTS``) whose block fits (pair and slim: each block of its
    cluster), else slim, which :func:`check_fits` then refuses."""
    return next((name for name in LAYOUTS if smem_bytes(g, name) <= SMEM_LIMIT), LAYOUTS[-1])


def sweep_warps(g: Geometry) -> int:
    """Warps the sweeps take: two chain warps, a helper per distance 2..bw
    and the finishing warp."""
    return 2 + max(g.order - 1, 0) + 1


def check_fits(g: Geometry) -> None:
    """Raise ValueError unless kernel 3 is written for ``g`` (a band of at
    least one sub-diagonal block) and its block
    fits the card in the layout ``g`` names, or else in one of the nine:
    232,448 B of shared memory (the pair and slim layouts: each block of its cluster,
    the ring spread over the ranks ``g`` names or else the fewest whose share
    fits), at most 1024 threads (which only an ept that ``g`` names can
    pass), and a band of two sub-diagonal blocks at least where a copier
    fills the ring (the split, stream, lean, far, deep and pair layouts),
    paced by the helper of distance 2; the error of a block too large names
    the bytes of every layout and of each rank of the pair's and the slim's
    clusters. A
    block always has the warps its sweeps, copier and relay take
    (:func:`threads`)."""
    if g.order < 1:
        raise ValueError(f"kernel 3 solves with a band of at least one sub-diagonal block; "
                         f"got band width {g.order}")
    what = (f"kernel 3 at {g.nodes} nodes, order {g.order} and {g.nq} joints ({g.num_var} "
            f"variables, {g.num_rows} rows)")
    if threads(g) > MAX_THREADS:
        raise ValueError(f"{what} needs {threads(g)} threads per block at {g.ept} z elements "
                         f"and rows a thread; a block may have {MAX_THREADS}")
    name = g.layout or choose_layout(g)
    if smem_bytes(g, name) > SMEM_LIMIT:
        bytes_of = lambda lay: (f"{smem_bytes(g, lay)} B" if lay not in PAIRED else ", ".join(
            f"rank {i} {b} B" for i, b in enumerate(rank_bytes(g, lay))))
        others = ", ".join(f"{other}: {bytes_of(other)}" for other in LAYOUTS if other != name)
        raise ValueError(
            f"{what} needs {smem_bytes(g, name)} B of shared memory per block in its {name} "
            f"layout ({'' if name not in PAIRED else bytes_of(name) + '; '}{others}); a block "
            f"may have {SMEM_LIMIT} B")
    if name in RINGED and g.order < 2:
        raise ValueError(f"kernel 3's {name} layout takes a band of at least two sub-diagonal "
                         f"blocks (the helper of distance 2 paces its copier); got {g.order}")


def admm_kernel(ocp, sa: StructuredA, qp: qp_structured.ScaledQP, fac, settings: QPSettings,
                state=None, chunk_iters=None, layout=None, ept=None, ranks=None):
    """Launch kernel 3 on scaled float32 CUDA data (the pair layout: a
    cluster of blocks a problem, a launch the card cannot place raising
    RuntimeError): one dispatch of
    ``chunk_iters`` iterations (default: the whole budget) from ``state``
    (default: the initial state of ``qp``), with the library of the OCP's
    transcription in its own shared-memory layout and elements per thread,
    or in ``layout`` (one of ``LAYOUTS``), at ``ept`` and (pair) with its
    ring over ``ranks`` ranks, for holding and timing one build against
    another where both fit. Takes and returns the
    scaled (x, zc, zx, yc, yx, done, iters, rp, rd) like ``admm_plain``."""
    B = qp.x.shape[0]
    f32 = torch.float32
    g = dataclasses.replace(Geometry.of_ocp(ocp), layout=layout, ept=ept, ranks=ranks)
    check_fits(g)
    N, NG, BLK, BW, NV, NEQ, NM = g.nodes, g.ng, g.blk, g.order, g.num_var, g.num_eq, g.num_rows
    x0, zc0, zx0, yc0, yx0, done0, iters0, rp0, rd0 = (
        qp_structured.initial_state(qp) if state is None else state)
    shapes = {
        "Ldi": (B, N, BLK, BLK), "Lsub": (B, N, BW, BLK, BLK), "u": (B, N, BLK),
        "s": (B,), "J": (B, N, NG, BLK), "f_rows": (B, NEQ), "p": (B,),
    }
    data = {"Ldi": fac["Ldi"], "Lsub": fac["Lsub"], "u": fac["u"], "s": fac["s"],
            "J": sa.J, "f_rows": sa.f_rows, "p": sa.p}
    zdata = {"qs": qp.qs, "Ps": qp.Ps, "rx": qp.rx, "lxs": qp.lxs, "uxs": qp.uxs,
             "thx": qp.thx, "D": qp.D, "x0": x0, "zx0": zx0, "yx0": yx0}
    mdata = {"rc": qp.rc, "lcs": qp.lcs, "ucs": qp.ucs, "E": qp.E, "thr": qp.thr,
             "zc0": zc0, "yc0": yc0}
    sdata = {"rp0": rp0, "rd0": rd0, "done0": done0, "iters0": iters0}
    shapes.update({k: (B, NV) for k in zdata})
    shapes.update({k: (B, NM) for k in mdata})
    shapes.update({k: (B,) for k in sdata})
    inputs = {k: v.contiguous() for d in (data, zdata, mdata, sdata) for k, v in d.items()}
    for k, v in inputs.items():
        check_cuda_tensor(k, v, shapes[k], torch.int32 if k in ("done0", "iters0") else f32)
    layout = KERNEL.geometry(g).layout
    if layout in RINGED and inputs["Lsub"].data_ptr() % 16:
        # the ring's bulk copies start at the 16-byte boundary at or before
        # a block, which must lie inside the tensor
        inputs["Lsub"] = inputs["Lsub"].clone()
    if layout in LDI_RINGED:
        # so do those of Ldi, and they end at the 16-byte boundary at or after
        # a block, which for the last block must lie inside the storage too
        ldi = inputs["Ldi"]
        end = -(-(ldi.data_ptr() + 4 * ldi.numel()) // 16) * 16
        storage = ldi.untyped_storage()
        if ldi.data_ptr() % 16 or end > storage.data_ptr() + storage.nbytes():
            padded = torch.empty(ldi.numel() + 3, dtype=f32, device=ldi.device)
            inputs["Ldi"] = padded[:ldi.numel()].view(ldi.shape).copy_(ldi)

    new = lambda n, dtype=f32: torch.empty(B, n, dtype=dtype, device=qp.x.device)
    x, zx, yx = new(NV), new(NV), new(NV)
    zc, yc = new(NM), new(NM)
    rp, rd = new(1)[:, 0], new(1)[:, 0]
    done, iters = new(1, torch.int32)[:, 0], new(1, torch.int32)[:, 0]
    outs = [x, zc, zx, yc, yx, rp, rd, done, iters]
    # pointer block in the order of struct Ptrs (csrc/structured_admm.cu)
    ptrs = (ctypes.c_void_p * 37)(
        *(t.data_ptr() for t in list(inputs.values()) + outs)
    )
    Dm = DIFF_MATRIX.get(
        (ocp.coll,), qp.x.device,
        lambda: ocp.coll.diff_matrix.detach().to("cpu", torch.float32).contiguous(),
    )
    cap = settings.max_iter + settings.rescue_iters if chunk_iters is None else chunk_iters
    KERNEL.launch(
        ptrs, ptr(Dm), settings.sigma, settings.alpha, settings.eps_abs,
        settings.eps_rel, cap, settings.check_every, settings.kkt_refine, B, geometry=g,
    )
    return x, zc, zx, yc, yx, done, iters, rp, rd


def block_layout(geometry: Geometry = None) -> dict:
    """What the library built for ``geometry`` (default: 19 nodes; in the
    layout and at the ept it names, else its own) says of its block: threads,
    shared-memory bytes, how many blocks one SM holds at a time from the
    CUDA occupancy calculator (1: the block's shared memory takes the SM),
    and in the pair layout each rank's bytes (``rank_bytes``: rank 0's, then
    each ring rank's; else (0, 0)) and how many clusters the card runs at a
    time (``active_clusters``, cudaOccupancyMaxActiveClusters; else 0)."""
    lib = KERNEL.library(geometry)
    out = {}
    for key, name in (("threads", "mpc_structured_admm_threads"),
                      ("smem_bytes", "mpc_structured_admm_smem_bytes"),
                      ("blocks_per_sm", "mpc_structured_admm_blocks_per_sm")):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        out[key] = fn()
    if out["blocks_per_sm"] <= 0:
        raise RuntimeError(f"kernel 3 occupancy query failed: CUDA error {-out['blocks_per_sm']}")
    # the pair layout's (a build of a source from before it has neither)
    clusters = getattr(lib, "mpc_structured_admm_active_clusters", None)
    out["active_clusters"], out["rank_bytes"] = 0, (0, 0)
    if clusters is not None:
        rank = lib.mpc_structured_admm_rank_bytes
        clusters.restype, rank.argtypes, rank.restype = ctypes.c_int, [ctypes.c_int], ctypes.c_int
        # the blocks of a cluster (a source from before the ring was spread: two)
        size = getattr(lib, "mpc_structured_admm_cluster_size", None)
        if size is not None:
            size.restype = ctypes.c_int
        ranks = size() if size is not None else 2
        out["active_clusters"] = clusters()
        out["rank_bytes"] = tuple(rank(i) for i in range(max(ranks, 2)))
        if out["active_clusters"] < 0:
            raise RuntimeError(f"kernel 3 cluster occupancy query failed: CUDA error "
                               f"{-out['active_clusters']}")
    return out


def blocks_per_sm(geometry: Geometry = None) -> int:
    """How many blocks of kernel 3 one SM holds at a time."""
    return block_layout(geometry)["blocks_per_sm"]


def problems_at_once(geometry: Geometry, sms: int) -> int:
    """How many problems kernel 3 built for ``geometry`` runs at a time on a
    card of ``sms`` SMs: its blocks per SM on each, or in the pair layout one
    per cluster the card places at a time."""
    lay = block_layout(geometry)
    return lay["active_clusters"] if KERNEL.geometry(geometry).layout in PAIRED \
        else sms * lay["blocks_per_sm"]


def solve_box_qp_structured_cuda(
    ocp, sa: StructuredA, P_diag, q, lc, uc, lx, ux, settings: QPSettings,
    x0=None, yc0=None, yx0=None, soft_c=None, soft_x=None,
) -> QPSolution:
    """The structured QP on the card: float32 data, kernel 2 for every
    factorization (flagged problems refactored by the plain version) and
    kernel 3 for every dispatch of the ADMM loop; the rho update between
    dispatches is PyTorch on the card, with no host synchronisation, and the
    boundaries at which some rho moved are counted in ``REFACTORS``. Returns
    float32 results."""
    settings.check_structured()
    check_fits(Geometry.of_ocp(ocp))
    f32 = torch.float32
    cast = lambda a: None if a is None else a.to(f32)
    sa = sa.to(dtype=f32)
    qp = qp_structured.scale_qp(
        ocp, sa, *(cast(a) for a in (P_diag, q, lc, uc, lx, ux)), settings,
        *(cast(a) for a in (x0, yc0, yx0, soft_c, soft_x)),
    )
    state, qp, refactors = qp_structured.admm_chunked(
        ocp, sa, qp, settings, banded_factor.factor, admm_kernel)
    REFACTORS.add(refactors)
    return qp_structured.unscale_solution(qp, *state)


def solve_box_qp_structured(ocp, sa: StructuredA, P_diag, q, lc, uc, lx, ux,
                            settings: QPSettings = QPSettings(), **kw) -> QPSolution:
    """Route: the plain structured solve for CPU tensors (caller's dtype),
    kernels 2 and 3 for CUDA tensors (float32, cast back to the caller's
    dtype)."""
    if q.device.type == "cpu":
        return qp_structured.solve_box_qp_structured(
            ocp, sa, P_diag, q, lc, uc, lx, ux, settings, **kw
        )
    if q.device.type != "cuda":
        raise ValueError(f"no QP path for device {q.device}")
    sol = solve_box_qp_structured_cuda(ocp, sa, P_diag, q, lc, uc, lx, ux, settings, **kw)
    if q.dtype == torch.float32:
        return sol
    return QPSolution(**{
        k: (v.to(q.dtype) if v.is_floating_point() else v)
        for k, v in vars(sol).items()
    })
