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

What bounds it on this card: bytes. With ``kkt_refine=1`` an iteration
reads A four times and M^-1 twice, 4 x 780,800 + 2 x 640,000 B = 4.4 MB per
problem at n=400, m=488, so ~9 GB per iteration across B=2048, ~2.7 ms at
3.35 TB/s. The 50 MB L2 holds the matrices of ~35 problems, far fewer than
a grid keeps in flight, so every pass goes to device memory. Design (right
and simple first): one problem per 512-thread block, two blocks per SM,
runs the whole chunk in one launch and stops at its own ``done``; its iterates and operand
vectors live in shared memory (~38 KB at n=400, m=488); A and M^-1 stream
from device memory on each pass, A v and M^-1 r with a warp per row, A'u
with a thread per column over the rows. The plain version runs every
problem until the slowest is done; the kernel does not.
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
)

STATE = ("x", "zc", "zx", "yc", "yx")
# operand order of the kernel's pointer block (csrc/admm_dense.cu struct Ptrs)
N_VECS = ("P", "q", "lx", "ux", "rx", "D", "sx")
M_VECS = ("lc", "uc", "rc", "E", "sc")


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


def admm_dense_plain(operands, state, *, chunk_iters, check_every, eps_abs, eps_rel,
                     sigma, alpha, kkt_refine):
    """The chunk in batched PyTorch, in the dtype of the inputs. Returns
    (new state, used (B,) int32)."""
    ops = operands
    A, Mi = ops["A"], ops["M_inv"]
    rc, rx = ops["rc"], ops["rx"]
    thr = torch.minimum(ops["sc"], _HARD * rc) / rc
    thr_x = torch.minimum(ops["sx"], _HARD * rx) / rx
    x, zc, zx, yc, yx = (state[k] for k in STATE)
    done = state["done"].clone()
    used = torch.zeros_like(done)

    k = 0
    while k < chunk_iters and not bool((done != 0).all()):
        r = (sigma * x - ops["q"] + (rx * zx - yx)) + _bmtv(A, rc * zc - yc)
        xt = _bmv(Mi, r)
        Ax = _bmv(A, xt)
        for _ in range(kkt_refine):
            r2 = r - (ops["P"] + sigma + rx) * xt - _bmtv(A, rc * Ax)
            xt = xt + _bmv(Mi, r2)
            Ax = _bmv(A, xt)

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


def admm_dense_kernel(operands, state, *, chunk_iters, check_every, eps_abs, eps_rel,
                      sigma, alpha, kkt_refine):
    """Launch kernel 4 on contiguous float32 CUDA tensors: M_inv (B, n, n),
    A (B, m, n), the (B, n) / (B, m) operand vectors, the state vectors and
    done (B,) int32. Returns (new state, used (B,) int32)."""
    B, m, n = operands["A"].shape
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
