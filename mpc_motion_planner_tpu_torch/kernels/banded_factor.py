"""Kernel 2: block-banded Cholesky + arrow factorization of the ADMM KKT
matrix, one problem per 128-thread block, several blocks per SM.

Replaces ``mpc_motion_planner_tpu/ops/pallas/banded_factor.py``
``factor_banded_pallas`` (``pl.pallas_call`` at :262, body
``_factor_kernel`` :117).

The library is built per transcription (``build.Geometry``, read from
``Mband``'s shape: nodes, band width and blk = 3 nq): the node count enters
only loop bounds and strides, and the working set per problem
(:func:`smem_bytes`: 33,580 B at 19 nodes, 34,588 B at 25) leaves six
problems on an SM up to 44 nodes. The joint count sets the block size blk,
the column stride (blk rounded up to 4) and the working set (25,060 B at 6
joints, 42,964 B at 8, 19 nodes), and with them :func:`per_sm`, the
problems per SM the registers are capped for; one warp holds :func:`rows`
rows of a block per lane (one up to 10 joints, two past them: 93,876 B and
two problems per SM at 12 joints). The band width (the spline order)
sets the ring and the pending blocks: bw + 4 blocks of the forward loop
beside the ring's bw^2 (24,508 B at bw = 2 and 19 nodes, 47,356 B at bw = 4
and 17 nodes, 4 problems per SM; 64,828 B at bw = 5 and 16 nodes, 3).
Where that block does not fit (20 and 21 joints at 19 nodes: 254,196 and
279,996 B), the ring's blocks are read back from device memory, where the
block has already written them, and the backward sweep stages as many nodes
as the forward loop's blocks leave room for (:func:`choose_ring`,
:func:`staged_nodes`: two at 20 and 21 joints, 124,596 and 137,112 B, one
problem per SM); the arithmetic and its order are the shared ring's, so the
factors are too, bitwise. Where the device ring's block does not fit
either (28 joints at 19 nodes: 238,964 B; 32 joints: 309,908 B), the scratch
build keeps only LkT, S and C for d = 1 of the forward loop in shared memory:
the inverse of L[k,k] goes straight to its place in Ldi and C[d] for d >= 2
lies in Ldi's block of node k + d until node k + d's own inverse takes it
(one staged node, 154,292 B at 28 joints, 199,316 B at 32), and its factors
are the device ring's, bitwise.

What bounds it on this card: the latency of the sequential node recursion.
Per problem the 19-node recursion does ~2 MFLOP (Schur updates, a 21-column
Cholesky, a triangular inverse and up to bw sub-diagonal products per
node) and moves ~268 KB (the band in, the factors out), little for the
card, while each step depends on the one before (PERF.md has the measured
times). The design therefore makes a problem small enough for several to
share an SM and hide each other's waits: node k reads only the factors of
nodes k-bw..k-1, so shared memory holds a ring of the last bw nodes'
sub-diagonal blocks (~34 KB per problem at bw = 3 instead of the whole 134
KB factor) and every block of the factor goes to device memory as soon as
it is final, the saturation scan with it. The blk x blk Cholesky (21 x 21
for the Panda) and the triangular inverse
run in one warp with a row (then a column) per lane in registers and no
block-wide barrier, while the other warps form the products of node k+1
that do not need node k and the arrow column's forward-substitution sum,
which is folded into the node loop. Only the backward sweep for ``u`` reads
factors again, newest first, out of L2.
:func:`ops.qp_structured.factor_banded_ring` states this schedule in plain
PyTorch. The TPU kernel's numerical guards are kept as semantics: the 1e-20
pivot floor, the ±1e8 clamp on every computed entry, and the ``ok`` flag
(pivot or Schur scalar at or below 1e-20, or any entry at or above 0.99e8).

The plain version is ``ops.qp_structured.factor_banded``; problems whose
``ok`` is false are refactored by it (with its jitter retry), as the JAX
package does, and counted in ``REPAIRS``. The repair has a fixed shape, so
that a CUDA graph can capture it: the first ``repair_capacity(B)`` flagged
problems are gathered into a batch of that size (padded with unflagged
ones), refactored, and scattered back under the mask, whether or not any
problem was flagged. Flagged problems beyond the capacity are counted in
``OVERFLOW``; an eager solve repairs them in a second, data-dependent pass,
a captured graph leaves them and adds their number to the count of each
capture in progress (``CAPTURE_SINKS``), which the captured solve reads
after each replay and then re-solves the batch eagerly
(``utils/capture.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.qp_structured import factor_banded
import dataclasses

from .build import (
    RINGS, SM_SMEM, SMEM_LIMIT, CudaKernel, DeviceCount, Geometry, capturing, check_cuda_tensor,
    ptr,
)

KERNEL = CudaKernel(
    "banded_factor", "banded_factor.cu", "mpc_banded_factor",
    [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p],
    init="mpc_banded_factor_init", per_geometry="transcription",
    resolve=lambda g: built_geometry(g),
)
NT, CH = 128, 4  # threads, staged nodes of the shared ring (csrc/banded_factor.cu)


# problems that kernel 2 flagged, each refactored by the plain version
REPAIRS = DeviceCount()
# flagged problems beyond the repair capacity
OVERFLOW = DeviceCount()
# the DeviceCounts of the graph captures in progress: a captured graph adds
# the flagged problems it leaves unrepaired to each (utils/capture.py)
CAPTURE_SINKS = []


def repair_capacity(batch: int) -> int:
    """How many flagged problems one factorization repairs in its batch of
    fixed shape: one in 64, at least one."""
    return -(-batch // 64)


def column_stride(g: Geometry) -> int:
    """LKS: a column of L[k,k] in shared memory, blk rounded up to 4
    floats for 16-byte loads."""
    return -(-g.blk // 4) * 4


def rows(g: Geometry) -> int:
    """ROWS: rows (columns) of a blk x blk block a lane of the Cholesky
    warp owns, lane r rows r, r + 32, ... (one up to 10 joints, two up to
    21)."""
    return -(-g.blk // 32)


def forward_floats(g: Geometry, ring: str) -> int:
    """Floats of the forward loop's blocks (struct Forward): LkT, the ring
    of the last bw nodes' bw blocks (the shared ring only), then bw + 4
    blocks: S[2], C[bw + 1] (C[0], C[1] for d = 1, C[d] for d = 2..bw),
    Linv; the scratch build's S[2] and C[0], C[1] alone."""
    blk2, bw = g.blk * g.blk, g.order
    if ring == "scratch":
        return g.blk * column_stride(g) + 4 * blk2
    return g.blk * column_stride(g) + (bw * bw * blk2 if ring == "shared" else 0) + (bw + 4) * blk2


def staged_nodes(g: Geometry, ring: str = None) -> int:
    """CH: the nodes the backward sweep stages at a time, each its Ldi and
    its bw Lsub blocks: 4 with the shared ring; with the device ring or the
    scratch build as many as the forward loop's blocks leave room for, from
    1 to 4 (2 at 20 and 21 joints at 19 nodes with the device ring, 1 with
    the scratch build)."""
    ring = ring or g.ring or choose_ring(g)
    if ring == "shared":
        return CH
    return min(CH, max(1, forward_floats(g, ring) // ((g.order + 1) * g.blk * g.blk)))


def smem_bytes(g: Geometry, ring: str = None) -> int:
    """Shared memory of one block of kernel 2 built for ``g`` with ``ring``
    (default: the one ``g`` names, else the one it takes, :func:`choose_ring`):
    the larger of the forward loop's blocks and the backward sweep's staged
    nodes, then ys, us, scratch and the flag (struct Smem of
    csrc/banded_factor.cu)."""
    ring = ring or g.ring or choose_ring(g)
    backward = staged_nodes(g, ring) * (g.order + 1) * g.blk * g.blk
    return 4 * (max(forward_floats(g, ring), backward) + 2 * g.nodes * g.blk + 32 * rows(g)
                + NT // 32) + 4


def choose_ring(g: Geometry) -> str:
    """The ring kernel 2 is built with for ``g``: the first of ``RINGS``
    (shared, device, scratch) whose block fits, else the scratch build (which
    :func:`check_fits` then refuses)."""
    return next((r for r in RINGS if smem_bytes(g, r) <= SMEM_LIMIT), RINGS[-1])


def built_geometry(g: Geometry) -> Geometry:
    """The geometry kernel 2's library is built for: ``g`` with the ring it
    names, or else its own (None: the shared ring, as before the device
    ring existed), and none of kernel 3's layout, ept and ranks."""
    ring = g.ring or choose_ring(g)
    return dataclasses.replace(g, layout=None, ept=None, ranks=None,
                               ring=None if ring == "shared" else ring)


def per_sm(g: Geometry) -> int:
    """PER_SM of csrc/banded_factor.cu: the problems per SM its registers
    are capped for, as many as the SM's shared memory and its 2048 threads
    hold and no more than leave a thread 2 LKS + rows x blk + 11 registers
    (in units of 8)."""
    regs = -(-(2 * column_stride(g) + rows(g) * g.blk + 11) // 8) * 8
    return min(SM_SMEM // (smem_bytes(g) + 1024), 65536 // (NT * regs), 2048 // NT)


def check_fits(g: Geometry) -> None:
    """Raise ValueError unless kernel 2 is written for ``g`` (a band of at
    least one sub-diagonal block) and a block of it fits the card's shared
    memory, which leaves at least one problem per SM, with the ring ``g``
    names or else any; the error names the bytes of every ring."""
    if g.order < 1:
        raise ValueError(f"kernel 2 factors a band of at least one sub-diagonal block; got "
                         f"band width {g.order}")
    ring = g.ring or choose_ring(g)
    if smem_bytes(g, ring) > SMEM_LIMIT:
        others = ", ".join(f"{r} ring: {smem_bytes(g, r)} B" for r in RINGS if r != ring)
        raise ValueError(f"kernel 2 at {g.nodes} nodes, band width {g.order} and {g.nq} joints "
                         f"needs {smem_bytes(g, ring)} B of shared memory per block with its "
                         f"{ring} ring ({others}); a block may have {SMEM_LIMIT} B")


def factor_banded_kernel(Mband, p_col, m_pp, ring=None):
    """Launch kernel 2 on CUDA float32 tensors Mband (B, nodes, bw + 1, blk, blk),
    p_col (B, nodes, blk), m_pp (B,), with the library of the transcription
    the band's shape gives, with its own ring or ``ring`` (one of ``RINGS``,
    for holding one build against the other where both fit). Returns {"Ldi",
    "Lsub", "u", "s", "ok"} in the layouts of :func:`factor_banded`."""
    B = Mband.shape[0]
    g = dataclasses.replace(Geometry.of_band(Mband), ring=ring)
    check_fits(g)
    N, BW, BLK = g.nodes, g.order, g.blk
    check_cuda_tensor("Mband", Mband, (B, N, BW + 1, BLK, BLK))
    check_cuda_tensor("p_col", p_col, (B, N, BLK))
    check_cuda_tensor("m_pp", m_pp, (B,))
    new = lambda *shape, dtype=torch.float32: torch.empty(*shape, dtype=dtype, device=Mband.device)
    Ldi, Lsub = new(B, N, BLK, BLK), new(B, N, BW, BLK, BLK)
    u, s, ok = new(B, N, BLK), new(B), new(B, dtype=torch.int32)
    KERNEL.launch(
        ptr(Mband), ptr(p_col), ptr(m_pp), ptr(Ldi), ptr(Lsub), ptr(u), ptr(s),
        ptr(ok), B, geometry=g,
    )
    return {"Ldi": Ldi, "Lsub": Lsub, "u": u, "s": s, "ok": ok != 0}


def block_layout(geometry: Geometry = None) -> dict:
    """What the library built for ``geometry`` (default: 19 nodes, 7
    joints; its own ring or the one it names) says of its block:
    shared-memory bytes, the problems per SM its registers are capped for
    (``per_sm``), how many one SM holds at a time from the CUDA occupancy
    calculator (``blocks_per_sm``) and the nodes its backward sweep stages
    (``staged``; a source from before the device ring has no such query,
    and 4)."""
    lib = KERNEL.library(geometry)
    out = {}
    for key in ("smem_bytes", "per_sm", "blocks_per_sm"):
        fn = getattr(lib, f"mpc_banded_factor_{key}")
        fn.restype = ctypes.c_int
        out[key] = fn()
    staged = getattr(lib, "mpc_banded_factor_staged", None)
    if staged is not None:
        staged.restype = ctypes.c_int
    out["staged"] = staged() if staged is not None else CH
    if out["blocks_per_sm"] <= 0:
        raise RuntimeError(f"kernel 2 occupancy query failed: CUDA error {-out['blocks_per_sm']}")
    return out


def blocks_per_sm(geometry: Geometry = None) -> int:
    """How many blocks (problems) of kernel 2 built for ``geometry`` one SM
    holds at a time, from the CUDA occupancy calculator."""
    return block_layout(geometry)["blocks_per_sm"]


def repair(fac, Mband, p_col, m_pp, bw: int):
    """Replace kernel 2's factors of the problems it flagged by the plain
    version's, in place (``fac`` keeps kernel 2's ``ok``). The first
    ``repair_capacity(B)`` flagged problems go through one batch of that
    size, chosen by a stable sort of the flags; the rest, if any, through a
    second batch in an eager solve, and a capture leaves them (module
    docstring)."""
    B = Mband.shape[0]
    cap = min(B, repair_capacity(B))
    bad = ~fac["ok"]
    n_bad = bad.sum()
    REPAIRS.add(n_bad)
    idx = torch.argsort((~bad).to(torch.int8), stable=True)[:cap]
    fix = factor_banded(Mband[idx], p_col[idx], m_pp[idx], bw)
    flagged = bad[idx]
    for k in ("Ldi", "Lsub", "u", "s"):
        a = fac[k]
        a[idx] = torch.where(flagged.reshape(-1, *[1] * (a.ndim - 1)), fix[k], a[idx])
    over = torch.clamp(n_bad - cap, min=0)
    OVERFLOW.add(over)
    if capturing(Mband.device):
        for sink in CAPTURE_SINKS:
            sink.add(over)
    elif int(over):
        rest = bad.clone()
        rest[idx] = False
        ri = rest.nonzero()[:, 0]
        fix = factor_banded(Mband[ri], p_col[ri], m_pp[ri], bw)
        for k in ("Ldi", "Lsub", "u", "s"):
            fac[k][ri] = fix[k]
    return fac


def factor(Mband, p_col, m_pp, bw: int):
    """Route: the plain factorization for CPU tensors; for CUDA tensors
    kernel 2 built for the band's transcription, with the problems it flags
    refactored by the plain version (:func:`repair`)."""
    if Mband.device.type == "cpu":
        return factor_banded(Mband, p_col, m_pp, bw)
    if Mband.device.type != "cuda":
        raise ValueError(f"no factor path for device {Mband.device}")
    if Mband.shape[2] != bw + 1:
        raise ValueError(f"band of width {Mband.shape[2] - 1} factored with bw={bw}")
    return repair(factor_banded_kernel(Mband, p_col, m_pp), Mband, p_col, m_pp, bw)
