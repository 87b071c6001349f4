"""Structured (matrix-free) application of the NLP constraint Jacobian.

Counterpart of ``mpc_motion_planner_tpu/ops/structure.py``. The QP
constraint matrix

    A = [ A_eq  ]      A_eq   = E_D + p * C_dyn + (-f_rows) e_p^T
        [ A_ineq]      A_ineq = per-node (ng x (nx+nu)) Jacobian blocks

is applied without materializing it: E_D is the shared differentiation
pattern, C_dyn the linear dynamics coupling, and the per-problem data are
p, the dynamics values f_rows and the per-node Jacobians J.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch


@dataclass(frozen=True)
class StructuredA:
    """Per-problem constraint-Jacobian data (B = batch):
    p (B,), f_rows (B, num_eq), J (B, nodes, ng, nx+nu)."""

    p: torch.Tensor
    f_rows: torch.Tensor
    J: torch.Tensor

    def to(self, device=None, dtype=None) -> "StructuredA":
        return StructuredA(*(t.to(device=device, dtype=dtype)
                             for t in (self.p, self.f_rows, self.J)))


@lru_cache(maxsize=None)
def _static_indices(order: int, num_segments: int):
    """Maps between global nodes and the (segment, local-node) grid: every
    node appears in at most two segments (boundary nodes are shared)."""
    K = order + 1
    seg_idx = np.arange(num_segments)[:, None] * order + np.arange(K)[None, :]
    nodes = order * num_segments + 1
    flat = seg_idx.reshape(-1)
    first = np.zeros(nodes, np.int64)
    second = np.zeros(nodes, np.int64)
    valid2 = np.zeros(nodes, np.float64)
    for n in range(nodes):
        hits = np.nonzero(flat == n)[0]
        first[n] = hits[0]
        second[n] = hits[-1]
        valid2[n] = 1.0 if len(hits) > 1 else 0.0
    return seg_idx, first, second, valid2


@lru_cache(maxsize=None)
def static_index_tensors(order: int, num_segments: int, device: torch.device):
    """:func:`_static_indices` as tensors on ``device`` (valid2 in float64),
    made once per device: a solve reads them at every call, and a copy from
    host memory at every call would also stall a CUDA graph capture."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in _static_indices(order, num_segments))


def build_structured_A(ocp, z, J=None) -> StructuredA:
    """Exact linearization data at the batched iterate z. J: optionally
    the precomputed (B, nodes, ng, nx+nu) per-node Jacobians."""
    X, U, p = ocp.unpack(z)
    f = ocp.dynamics(X, U)  # (B, nodes, nx)
    idx = ocp.segment_index(z.device).reshape(-1)
    f_rows = f[:, idx].reshape(z.shape[0], -1)
    if J is None:
        J = ocp.node_constraint_jacobians(z)
    return StructuredA(p=p, f_rows=f_rows, J=J)


def apply_A(ocp, sa: StructuredA, v):
    """A @ v for a batch: v (B, num_var) -> (B, num_eq + num_ineq)."""
    order, S = ocp.coll.order, ocp.coll.num_segments
    B = v.shape[0]
    vX, vU, vp = ocp.unpack(v)
    idx = ocp.segment_index(v.device)

    vX_seg = vX[:, idx]  # (B, S, K, nx)
    dX = torch.einsum("kj,bsji->bski", ocp.coll.diff_matrix.to(v.dtype), vX_seg)
    f_lin = ocp.dynamics(vX, vU)
    eq = (dX - sa.p[:, None, None, None] * f_lin[:, idx]).reshape(B, ocp.num_eq)
    eq = eq - sa.f_rows * vp[:, None]

    v_nodes = torch.cat([vX, vU], dim=-1)
    g = torch.einsum("bngc,bnc->bng", sa.J, v_nodes)
    return torch.cat([eq, g.reshape(B, -1)], dim=-1)


def apply_AT(ocp, sa: StructuredA, w):
    """A^T @ w for a batch: w (B, num_eq + num_ineq) -> (B, num_var)."""
    order, S = ocp.coll.order, ocp.coll.num_segments
    nodes, nx, ng, nq = ocp.num_nodes, ocp.nx, ocp.ng, ocp.nq
    num_eq = ocp.num_eq
    B = w.shape[0]
    K = order + 1
    _, i1, i2, valid2 = static_index_tensors(order, S, w.device)
    v2 = valid2.to(w.dtype)

    w_eq = w[:, :num_eq].reshape(B, S, K, nx)
    w_g = w[:, num_eq:].reshape(B, nodes, ng)

    def seg_to_nodes(c):  # (B, S, K, d) -> (B, nodes, d)
        cf = c.reshape(B, S * K, -1)
        return cf[:, i1] + v2[None, :, None] * cf[:, i2]

    X_out = seg_to_nodes(
        torch.einsum("kj,bski->bsji", ocp.coll.diff_matrix.to(w.dtype), w_eq)
    )
    w_nodes = seg_to_nodes(w_eq)
    p = sa.p[:, None, None]
    X_out = torch.cat([X_out[..., :nq], X_out[..., nq:] - p * w_nodes[..., :nq]], dim=-1)
    U_out = -p * w_nodes[..., nq:]

    vn = torch.einsum("bngc,bng->bnc", sa.J, w_g)
    X_out = X_out + vn[..., :nx]
    U_out = U_out + vn[..., nx:]
    p_out = -(sa.f_rows * w[:, :num_eq]).sum(-1)
    return torch.cat([X_out.reshape(B, -1), U_out.reshape(B, -1), p_out[:, None]], dim=-1)


def materialize(ocp, sa: StructuredA):
    """Dense (B, m, n) matrix equal to the structured operator (tests)."""
    B = sa.p.shape[0]
    n = ocp.num_var
    eye = torch.eye(n, dtype=sa.f_rows.dtype, device=sa.f_rows.device)
    cols = [apply_A(ocp, sa, eye[i].expand(B, n)) for i in range(n)]
    return torch.stack(cols, dim=-1)


def operator_norm(ocp, sa: StructuredA, D, E, iters: int = 40, generator=None):
    """Per-problem 2-norm estimate of the scaled operator E A D, by power
    iteration on (E A D)' (E A D), matrix-free. The start vector is normal
    noise from ``generator`` (seed 0 if none is given, drawn on the CPU)."""
    B, n = sa.p.shape[0], ocp.num_var
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    v = torch.randn(B, n, generator=generator, dtype=sa.f_rows.dtype,
                    device=generator.device).to(sa.f_rows.device)
    for _ in range(iters):
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)
        Av = E * apply_A(ocp, sa, D * v)
        v = D * apply_AT(ocp, sa, E * Av)
    return torch.sqrt(torch.clamp(torch.linalg.vector_norm(v, dim=-1), min=1e-30))
