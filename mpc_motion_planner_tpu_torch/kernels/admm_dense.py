"""Kernel 4: one chunk of dense boxADMM iterations per problem, over the
explicit KKT inverse M^-1 (n x n) and the scaled constraint matrix A
(m x n).

Replaces ``mpc_motion_planner_tpu/ops/pallas/admm_kernel.py``
``admm_pallas_chunk`` (``pl.pallas_call`` at :416, body ``_admm_kernel``
:94). The host part around it (scaling, factorization, the rho update
between chunks) is ``ops.qp.solve_pallas``.

Semantics kept from the Pallas kernel, which the plain version
:func:`admm_dense_plain` and the CUDA kernel share: the x-update through
M^-1 with ``kkt_refine`` refinement steps in factored form (diagonal P);
the soft-row prox with thr = min(sc, 1e20 rc) / rc; the flush-to-zero below
1e-30 and the clamp at ±1e15 on x, zc, yc, zx, yx in that order; the check
at chunk-local k % check_every == 0 or k >= chunk_iters; at a check, a
problem whose max_i(|x_i| + |yc_i| + |yx_i|) is not <= 1e12 is frozen with
done=2 before the residual test. That sum runs over the TPU's shared
512-wide padded axis, where variable i and constraint row i line up (x and
yx are 0 past n, yc past m); the port does not pad, so it forms the same
sum over max(n, m) entries. Frozen problems keep their state and ``used``
counts only the iterations a problem ran while not done.

What bounds it on this card: once the matrices are resident, the latency
of an iteration's chain of products, exchanges and cluster barriers
(PERF.md has the times). With ``kkt_refine=1`` an iteration needs four
products with A and two with M^-1, 4 x 780,800 + 2 x 640,000 B = 4.4 MB per
problem at n=400, m=488. Streamed from device memory (the first design of
this kernel) that is ~9 GB per iteration across B=2048, and the 50 MB L2
holds the matrices of ~35 problems, far fewer than a grid keeps in flight.
The TPU kernel keeps both matrices in fast memory for the whole chunk; on
Hopper no block's shared memory holds their 1.42 MB, but a thread-block
cluster's does. Design: one
problem per cluster of 8 blocks of 512 threads. Block c holds rows
[c ra, (c+1) ra) of A and [c rn, (c+1) rn) of M^-1 (ra = ceil(m/8),
rn = ceil(n/8), the last slices short or empty), read from device memory
once per launch; the m-length vectors live with the block that owns their
rows, the n-length vectors are replicated. ``A v`` needs no exchange and
is one pass with the ``A'u`` that follows it (the row stays in registers
while ``ax`` becomes ``u``); ``A'u`` is the sum, in block order, of the
blocks' partial sums over their rows, which every block writes into every
other's shared memory; each finished entry of ``M^-1 r`` is written into
all 8 blocks' copy of ``xt``. An iteration with ``kkt_refine=1`` has four
cluster barriers and passes twice over each matrix. Each cluster runs the
whole chunk in one launch and stops at its own ``done``; the freeze and the
residual maxima are exchanged so that all 8 blocks take the same decision.
:func:`admm_dense_partitioned` states the partition and its order of sums in
plain PyTorch. An (n, m) whose slices and vectors exceed a block's shared
memory is refused (:func:`check_fits`); there is no streamed path behind it.
The plain version runs every problem until the slowest is done; the kernel
does not.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.qp import _HARD, _bmtv, _bmv, _residuals
from .build import CudaKernel, check_cuda_tensor

_BIG = 1e12  # divergence freeze level

KERNEL = CudaKernel(
    "admm_dense", "admm_dense.cu", "mpc_admm_dense",
    [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_float] * 4 + [ctypes.c_void_p],
    init="mpc_admm_dense_init",
)

CLUSTER = 8  # blocks per cluster: each holds 1/8 of the rows of A and of M^-1
_WARPS, _NVEC_N, _NVEC_M = 16, 15, 9
N_MAX = 512  # a lane keeps its 16 entries of a row in registers
# what a block may use on the H100 (232,448 B) less the kernel's static part
SMEM_LIMIT = 232448 - 512

STATE = ("x", "zc", "zx", "yc", "yx")
# operand order of the kernel's pointer block (csrc/admm_dense.cu struct Ptrs)
N_VECS = ("P", "q", "lx", "ux", "rx", "D", "sx")
M_VECS = ("lc", "uc", "rc", "E", "sc")


def cluster_shared_bytes(n: int, m: int) -> int:
    """Dynamic shared memory of one block of the cluster at (n, m), as
    ``geometry`` in csrc/admm_dense.cu lays it out: its slices of A and M^-1
    in rows of n rounded up to 4 floats, 15 n-length vectors, a row of
    partial sums of ``A'u`` per pair of warps, a row of received partial sums
    per block of the cluster, and 9 vectors over its rows of A."""
    n4, ra, rn = -(-n // 4) * 4, -(-m // CLUSTER), -(-n // CLUSTER)
    return 4 * ((ra + rn + _NVEC_N + _WARPS // 2 + CLUSTER) * n4 + _NVEC_M * (-(-ra // 4) * 4))


def check_fits(n: int, m: int) -> None:
    """Raise unless the cluster's shared memory holds an (n, m) problem."""
    need = cluster_shared_bytes(n, m)
    if n <= 0 or m <= 0 or n > N_MAX or need > SMEM_LIMIT:
        raise ValueError(
            f"kernel 4 keeps A ({m} x {n}) and M^-1 ({n} x {n}) in the shared memory of "
            f"{CLUSTER} blocks: a block would need {need} B of the {SMEM_LIMIT} B of shared memory "
            f"it may use, and n may be at most {N_MAX}"
        )


def cluster_occupancy(n: int, m: int) -> dict:
    """The cluster size, one block's dynamic shared memory at (n, m), and
    how many clusters the card runs at a time
    (``cudaOccupancyMaxActiveClusters``)."""
    check_fits(n, m)
    fn = ctypes.CDLL(str(KERNEL.build())).mpc_admm_dense_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    size, smem, active = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = fn(n, m, ctypes.byref(size), ctypes.byref(smem), ctypes.byref(active))
    if err != 0:
        raise RuntimeError(f"kernel 4 occupancy query failed: CUDA error {err}")
    return {"cluster_size": size.value, "smem_bytes": smem.value,
            "max_active_clusters": active.value}


def _ftz(v):
    v = torch.where(v.abs() < 1e-30, torch.zeros_like(v), v)
    return torch.clamp(v, -1e15, 1e15)


def shared_axis_magnitude(x, yc, yx):
    """max_i (|x_i| + |yc_i| + |yx_i|) over the shared index axis of the
    variables and the constraint rows (x, yx zero past n, yc past m); NaN
    propagates."""
    n, m = x.shape[-1], yc.shape[-1]
    pad = lambda v: torch.nn.functional.pad(v.abs(), (0, max(n, m) - v.shape[-1]))
    return (pad(x) + pad(yc) + pad(yx)).amax(dim=-1)


def _converged(ops, eps_abs, eps_rel, x, zc, zx, yc, yx):
    """The OSQP residual test in unscaled units, per problem."""
    r_prim, r_dual, scale_p, scale_d = _residuals(
        ops["A"], ops["P"], ops["q"], ops["D"], ops["E"], x, zc, zx, yc, yx)
    return (r_prim <= eps_abs + eps_rel * scale_p) & (r_dual <= eps_abs + eps_rel * scale_d)


def _chunk_loop(operands, state, products, *, chunk_iters, check_every, eps_abs, eps_rel,
                sigma, alpha, kkt_refine):
    """The chunk's loop over ``products`` = (r -> M^-1 r, v -> A v,
    u -> A'u). Returns (new state, used (B,) int32)."""
    ops = operands
    minv_v, a_v, at_u = products
    rc, rx = ops["rc"], ops["rx"]
    thr = torch.minimum(ops["sc"], _HARD * rc) / rc
    thr_x = torch.minimum(ops["sx"], _HARD * rx) / rx
    x, zc, zx, yc, yx = (state[k] for k in STATE)
    done = state["done"].clone()
    used = torch.zeros_like(done)

    k = 0
    while k < chunk_iters and not bool((done != 0).all()):
        r = (sigma * x - ops["q"] + (rx * zx - yx)) + at_u(rc * zc - yc)
        xt = minv_v(r)
        Ax = a_v(xt)
        for _ in range(kkt_refine):
            r2 = r - (ops["P"] + sigma + rx) * xt - at_u(rc * Ax)
            xt = xt + minv_v(r2)
            Ax = a_v(xt)

        x_new = _ftz(alpha * xt + (1.0 - alpha) * x)
        zc_arg = alpha * Ax + (1.0 - alpha) * zc
        vc = zc_arg + yc / rc
        zc_new = _ftz(vc - torch.clamp(vc - torch.clamp(vc, ops["lc"], ops["uc"]), -thr, thr))
        yc_new = _ftz(yc + rc * (zc_arg - zc_new))
        zx_arg = alpha * xt + (1.0 - alpha) * zx
        vx = zx_arg + yx / rx
        zx_new = _ftz(vx - torch.clamp(vx - torch.clamp(vx, ops["lx"], ops["ux"]), -thr_x, thr_x))
        yx_new = _ftz(yx + rx * (zx_arg - zx_new))

        keep = (done > 0)[:, None]
        x = torch.where(keep, x, x_new)
        zc = torch.where(keep, zc, zc_new)
        zx = torch.where(keep, zx, zx_new)
        yc = torch.where(keep, yc, yc_new)
        yx = torch.where(keep, yx, yx_new)
        used = torch.where(done > 0, used, used + 1)

        k += 1
        if k % check_every == 0 or k >= chunk_iters:
            # NaN-safe: a NaN magnitude is not <= the level, so it freezes too
            big = ~(shared_axis_magnitude(x, yc, yx) <= _BIG)
            conv = _converged(ops, eps_abs, eps_rel, x, zc, zx, yc, yx)
            code = torch.where(big, torch.full_like(done, 2), conv.to(done.dtype))
            done = torch.where(done > 0, done, code)
    return dict(x=x, zc=zc, zx=zx, yc=yc, yx=yx, done=done), used


def admm_dense_plain(operands, state, *, chunk_iters, check_every, eps_abs, eps_rel,
                     sigma, alpha, kkt_refine):
    """The chunk in batched PyTorch, in the dtype of the inputs. Returns
    (new state, used (B,) int32)."""
    A, Mi = operands["A"], operands["M_inv"]
    products = (lambda r: _bmv(Mi, r), lambda v: _bmv(A, v), lambda u: _bmtv(A, u))
    return _chunk_loop(operands, state, products, chunk_iters=chunk_iters,
                       check_every=check_every, eps_abs=eps_abs, eps_rel=eps_rel, sigma=sigma,
                       alpha=alpha, kkt_refine=kkt_refine)


def row_slices(rows: int, parts: int = CLUSTER):
    """The kernel's split of ``rows`` rows over ``parts`` blocks: slices of
    ceil(rows / parts), the last ones short or empty."""
    per = -(-rows // parts)
    return [slice(min(rows, c * per), min(rows, (c + 1) * per)) for c in range(parts)]


def admm_dense_partitioned(operands, state, **kw):
    """The chunk as kernel 4 partitions it, in plain PyTorch: A and M^-1 in 8
    row slices, each product formed slice by slice. ``A v`` and ``M^-1 r``
    are the slices' results side by side (the gathered ``xt``); ``A'u`` is
    the sum, in block order, of the slices' partial sums over their rows."""
    A, Mi = operands["A"], operands["M_inv"]
    a_rows, m_rows = row_slices(A.shape[1]), row_slices(Mi.shape[1])

    def at_u(u):
        total = _bmtv(A[:, a_rows[0]], u[:, a_rows[0]])
        for sl in a_rows[1:]:
            total = total + _bmtv(A[:, sl], u[:, sl])
        return total

    products = (lambda r: torch.cat([_bmv(Mi[:, sl], r) for sl in m_rows], dim=1),
                lambda v: torch.cat([_bmv(A[:, sl], v) for sl in a_rows], dim=1), at_u)
    return _chunk_loop(operands, state, products, **kw)


def admm_dense_kernel(operands, state, *, chunk_iters, check_every, eps_abs, eps_rel,
                      sigma, alpha, kkt_refine):
    """Launch kernel 4 on contiguous float32 CUDA tensors: M_inv (B, n, n),
    A (B, m, n), the (B, n) / (B, m) operand vectors, the state vectors and
    done (B,) int32. Returns (new state, used (B,) int32)."""
    B, m, n = operands["A"].shape
    check_fits(n, m)
    shapes = {"M_inv": (B, n, n), "A": (B, m, n)}
    shapes.update({k: (B, n) for k in N_VECS + ("x", "zx", "yx")})
    shapes.update({k: (B, m) for k in M_VECS + ("zc", "yc")})
    for k in ("M_inv", "A") + N_VECS + M_VECS:
        check_cuda_tensor(k, operands[k], shapes[k])
    for k in STATE:
        check_cuda_tensor(k, state[k], shapes[k])
    check_cuda_tensor("done", state["done"], (B,), torch.int32)

    # the kernel updates the state in place: work on copies
    new = {k: state[k].clone() for k in STATE + ("done",)}
    used = torch.empty(B, dtype=torch.int32, device=new["x"].device)
    tensors = ([operands[k] for k in ("M_inv", "A") + N_VECS + M_VECS]
               + [new[k] for k in STATE + ("done",)] + [used])
    # pointer block in the order of struct Ptrs (csrc/admm_dense.cu)
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    KERNEL.launch(
        ptrs, B, n, m, chunk_iters, check_every, kkt_refine,
        eps_abs, eps_rel, sigma, alpha,
    )
    return new, used


def admm_dense_chunk(operands, state, *, chunk_iters, check_every, eps_abs, eps_rel,
                     sigma, alpha, kkt_refine):
    """Route: the plain version for CPU tensors, kernel 4 for CUDA ones."""
    kw = dict(chunk_iters=chunk_iters, check_every=check_every, eps_abs=eps_abs,
              eps_rel=eps_rel, sigma=sigma, alpha=alpha, kkt_refine=kkt_refine)
    device = operands["A"].device
    if device.type == "cpu":
        return admm_dense_plain(operands, state, **kw)
    if device.type == "cuda":
        return admm_dense_kernel(operands, state, **kw)
    raise ValueError(f"no dense ADMM path for device {device}")
