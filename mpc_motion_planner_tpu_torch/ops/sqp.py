"""Batched SQP solver for the transcribed minimum-time NLP (PyTorch).

Counterpart of ``mpc_motion_planner_tpu/ops/sqp.py``: full
relinearization every SQP iteration, the Gershgorin regularization of the
Lagrangian Hessian (the constant diagonal of the planner's zero Hessian, or
a dense ``hessian_fn`` callback), l1-elastic nonlinear rows and interior
variable box, the vectorized l1-merit backtracking line search, and
per-step ADMM budgets. ``QPSettings.backend`` picks the QP algorithm (see
``config.py``): the structured solver, or the dense solver over
``TranscribedOCP.constraint_matrix``. The per-node constraint evaluations
go through kernel 1 when the tensors are on CUDA.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache
from typing import List

import torch

from ..kernels.structured_admm import solve_box_qp_structured
from ..ocp import NLPBounds, TranscribedOCP
from .qp import DENSE_BACKENDS, STRUCTURED_BACKENDS, QPSettings, solve_box_qp
from .structure import build_structured_A


@dataclass(frozen=True)
class SQPSettings:
    max_iter: int = 2
    line_search_max_iter: int = 10
    tau: float = 0.5
    eta: float = 0.25
    # Gershgorin shift of the (zero) Lagrangian Hessian diagonal
    reg_eps: float = 0.01
    # l1 elastic weight of the nonlinear inequality rows (0 = hard)
    slack_penalty: float = 10.0
    # l1 elastic weight of the control and interior-state box (0 = hard)
    box_slack_penalty: float = 3.0
    # per-SQP-step ADMM budgets: ";"-separated entries of ","-separated
    # chunk lengths whose sum is that step's max_iter (the last entry
    # repeats); "" keeps QPSettings.max_iter for every step
    qp_step_schedules: str = ""


@dataclass(frozen=True)
class SQPResult:
    z: torch.Tensor  # (B, num_var) final iterate
    lam_c: torch.Tensor  # (B, num_eq + num_ineq) constraint duals
    lam_x: torch.Tensor  # (B, num_var) variable-box duals
    cost: torch.Tensor  # (B,)
    violation: torch.Tensor  # (B,) l1 constraint violation at the solution
    qp_iterations: torch.Tensor  # (B, sqp_iters)
    qp_converged: torch.Tensor  # (B, sqp_iters) bool
    step_sizes: torch.Tensor  # (B, sqp_iters)


def step_qp_settings(settings: SQPSettings, qp_settings: QPSettings) -> List[QPSettings]:
    """The QP settings of every SQP step (per-step budgets applied)."""
    if not settings.qp_step_schedules:
        return [qp_settings] * settings.max_iter
    entries = [e.strip() for e in settings.qp_step_schedules.split(";") if e.strip()]
    if not entries:
        raise ValueError(
            f"qp_step_schedules {settings.qp_step_schedules!r} names no budget"
        )
    budgets = [sum(int(c) for c in e.split(",")) for e in entries]
    return [
        dataclasses.replace(qp_settings, max_iter=budgets[min(i, len(budgets) - 1)])
        for i in range(settings.max_iter)
    ]


def hessian_regularization_diag(ocp: TranscribedOCP, B: int, dtype, device, eps):
    """Gershgorin shift specialized to the planner's H == 0: the constant
    eps diagonal."""
    return torch.full((B, ocp.num_var), eps, dtype=dtype, device=device)


def gershgorin_regularize(H, eps=0.01):
    """Gershgorin-disc regularization of a batched symmetric Lagrangian
    Hessian (B, n, n): every row i with a_ii - r_i <= 0 (r_i = sum_j |H_ij|
    - |a_ii|) has its diagonal shifted by (r_i - a_ii) + eps, so all discs
    lie in the positive half-plane."""
    aii = torch.diagonal(H, dim1=-2, dim2=-1)
    ri = H.abs().sum(-1) - aii.abs()
    shift = torch.where(aii - ri <= 0, (ri - aii) + eps, torch.zeros_like(aii))
    return H + torch.diag_embed(shift)


def _box_violation(v, lb, ub):
    return (torch.clamp(v - ub, min=0.0) + torch.clamp(lb - v, min=0.0)).sum(-1)


def constraint_violation(ocp: TranscribedOCP, bounds: NLPBounds, z):
    """l1 norm of all constraint violations at z (defects, inequality box,
    variable box)."""
    v_eq = ocp.eq_residual(z).abs().sum(-1)
    g = ocp.ineq_residual_batch(z)
    return v_eq + _box_violation(g, bounds.lb_ineq, bounds.ub_ineq) + _box_violation(
        z, bounds.lb_var, bounds.ub_var
    )


@lru_cache(maxsize=None)
def _step_lengths(tau: float, n: int, dtype, device) -> torch.Tensor:
    """The line search's trial steps tau^0 .. tau^(n-1) on ``device``, made
    once (a copy from host memory at every solve would stall a CUDA graph
    capture)."""
    return torch.tensor([tau**j for j in range(n)], dtype=dtype, device=device)


def _line_search(ocp, bounds, z, d, h, mu, settings: SQPSettings, c_eq, g):
    """Vectorized l1-merit backtracking; returns per-problem alpha (B,).

    Every candidate's defects come from the exact quadratic expansion; the
    nonlinear rows of all L*B candidates go through one batched evaluation
    (one kernel-1 launch on CUDA)."""
    L = settings.line_search_max_iter
    B, n = z.shape
    alphas = _step_lengths(settings.tau, L, z.dtype, z.device)

    viol0 = (
        c_eq.abs().sum(-1)
        + _box_violation(g, bounds.lb_ineq, bounds.ub_ineq)
        + _box_violation(z, bounds.lb_var, bounds.ub_var)
    )
    phi0 = ocp.cost(z) + mu * viol0
    dphi = (h * d).sum(-1) - mu * viol0

    c0, c1, c2 = ocp.eq_residual_quadratic(z, d)
    a1 = alphas[:, None, None]
    v_eq = (c0[None] + a1 * c1[None] + (a1 * a1) * c2[None]).abs().sum(-1)  # (L, B)

    z_try = (z[None] + a1 * d[None]).reshape(L * B, n)
    g_try = ocp.ineq_residual_batch(z_try).reshape(L, B, -1)
    v_g = _box_violation(g_try, bounds.lb_ineq[None], bounds.ub_ineq[None])
    v_x = _box_violation(z_try.reshape(L, B, n), bounds.lb_var[None], bounds.ub_var[None])
    phis = ocp.cost(z_try).reshape(L, B) + mu[None, :] * (v_eq + v_g + v_x)
    accept = phis <= phi0[None, :] + alphas[:, None] * settings.eta * dphi[None, :]
    # trials tau^0 .. tau^(L-2); tau^(L-1) is the untested fallback
    accept[L - 1, :] = True
    first = torch.argmax(accept.to(torch.int8), dim=0)
    return alphas[first]


def soft_weights(ocp: TranscribedOCP, settings: SQPSettings, B: int, dtype, device):
    """l1 weights (soft_c (B, m), soft_x (B, n)) of the QP rows: every
    nonlinear inequality row, and the controls plus the interior states of
    the variable box; the defects, the pinned node-0 state, the terminal box
    and p stay hard. None where the penalty is 0."""
    n, m = ocp.num_var, ocp.num_eq + ocp.num_ineq
    soft_c = soft_x = None
    if settings.slack_penalty > 0:
        soft_c = torch.zeros(B, m, dtype=dtype, device=device)
        soft_c[:, ocp.num_eq :] = settings.slack_penalty
    if settings.box_slack_penalty > 0:
        nodes, nx, nu = ocp.num_nodes, ocp.nx, ocp.nu
        wx = torch.zeros(n, dtype=dtype, device=device)
        wx[nx : (nodes - 1) * nx] = settings.box_slack_penalty
        wx[nodes * nx : nodes * (nx + nu)] = settings.box_slack_penalty
        soft_x = wx.expand(B, n)
    return soft_c, soft_x


def qp_subproblem(ocp: TranscribedOCP, bounds: NLPBounds, z, dense: bool = False):
    """Full relinearization at z: the defects c_eq, the constraint values g,
    the linearization (the structured operator, or with ``dense`` the dense
    (B, m, n) matrix) and the QP data (h, lc, uc, lx, ux) of the step."""
    c_eq = ocp.eq_residual(z)
    g, J = ocp.linearize_constraints_batch(z)
    lin = ocp.constraint_matrix(z, J=J) if dense else build_structured_A(ocp, z, J=J)
    lc = torch.cat([-c_eq, bounds.lb_ineq - g], dim=-1)
    uc = torch.cat([-c_eq, bounds.ub_ineq - g], dim=-1)
    return c_eq, g, lin, (ocp.cost_gradient(z), lc, uc, bounds.lb_var - z, bounds.ub_var - z)


def sqp_solve(
    ocp: TranscribedOCP,
    bounds: NLPBounds,
    z0,
    settings: SQPSettings = SQPSettings(),
    qp_settings: QPSettings = QPSettings(),
    lam_c0=None,
    lam_x0=None,
    hessian_fn=None,
) -> SQPResult:
    """Run ``settings.max_iter`` SQP iterations from the warm start z0
    (B, num_var); bounds are batched (B, ...).

    hessian_fn: optional Lagrangian-Hessian callback ``(z (B, n), lam_c
    (B, m)) -> (B, n, n)``; its Gershgorin-regularized dense Hessian goes to
    the QP, which needs the "xla" backend. None (the planner's zero
    Hessian) gives the constant ``reg_eps`` diagonal."""
    backend = qp_settings.backend
    if backend not in DENSE_BACKENDS + STRUCTURED_BACKENDS:
        raise ValueError(f"unknown QP backend {backend!r}")
    dense = backend in DENSE_BACKENDS
    if hessian_fn is not None and backend != "xla":
        raise ValueError("a dense hessian_fn needs the 'xla' QP backend")
    B = z0.shape[0]
    dt, dev = z0.dtype, z0.device
    n = ocp.num_var
    m = ocp.num_eq + ocp.num_ineq

    z = z0
    lam_c = torch.zeros(B, m, dtype=dt, device=dev) if lam_c0 is None else lam_c0
    lam_x = torch.zeros(B, n, dtype=dt, device=dev) if lam_x0 is None else lam_x0
    soft_c, soft_x = soft_weights(ocp, settings, B, dt, dev)
    P_diag = hessian_regularization_diag(ocp, B, dt, dev, settings.reg_eps)

    qp_iters, qp_conv, alphas_log = [], [], []
    for qs in step_qp_settings(settings, qp_settings):
        c_eq, g, lin, (h, lc, uc, lx, ux) = qp_subproblem(ocp, bounds, z, dense)
        if hessian_fn is not None:
            P_diag = gershgorin_regularize(hessian_fn(z, lam_c), settings.reg_eps)
        kw = dict(yc0=lam_c, yx0=lam_x, soft_c=soft_c, soft_x=soft_x)
        if dense:
            qp = solve_box_qp(P_diag, h, lin, lc, uc, lx, ux, qs, **kw)
        else:
            qp = solve_box_qp_structured(ocp, lin, P_diag, h, lc, uc, lx, ux, qs, **kw)
        d = qp.x
        mu = torch.maximum(
            qp.y_constraints.abs().amax(-1), qp.y_box.abs().amax(-1)
        )
        alpha = _line_search(ocp, bounds, z, d, h, mu, settings, c_eq=c_eq, g=g)

        z = z + alpha[:, None] * d
        lam_c = lam_c + alpha[:, None] * (qp.y_constraints - lam_c)
        lam_x = lam_x + alpha[:, None] * (qp.y_box - lam_x)
        qp_iters.append(qp.iterations)
        qp_conv.append(qp.converged)
        alphas_log.append(alpha)

    # project the final iterate onto the variable box (the pinned node-0
    # state then holds exactly)
    z = torch.clamp(z, bounds.lb_var, bounds.ub_var)
    return SQPResult(
        z=z,
        lam_c=lam_c,
        lam_x=lam_x,
        cost=ocp.cost(z),
        violation=constraint_violation(ocp, bounds, z),
        qp_iterations=torch.stack(qp_iters, dim=-1),
        qp_converged=torch.stack(qp_conv, dim=-1),
        step_sizes=torch.stack(alphas_log, dim=-1),
    )
