"""Shared boxADMM QP types: settings, solution and the row helpers.

Counterpart of the parts of ``mpc_motion_planner_tpu/ops/qp.py`` that the
structured solver uses. The QP is

    min 1/2 x'Px + q'x   s.t.  lc <= A x <= uc,  lx <= x <= ux

with optional l1-elastic (soft) rows. The dense solver is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class QPSettings:
    max_iter: int = 700
    check_every: int = 25
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    rho: float = 0.1
    # equality-row rho multiplier (OSQP convention)
    rho_eq_scale: float = 1e3
    sigma: float = 1e-6
    alpha: float = 1.6
    # Ruiz equilibration sweeps (0 disables)
    ruiz_iters: int = 2
    # OSQP-style adaptive rho; only 0 (fixed rho) is ported so far, as the
    # headline configuration runs it
    rho_update_every: int = 0
    # extra ADMM iterations past max_iter for unconverged problems
    rescue_iters: int = 0
    # iterative-refinement steps on the KKT solve; only 0 is ported so far
    kkt_refine: int = 0

    def check_ported(self) -> None:
        if self.rho_update_every > 0:
            raise NotImplementedError("adaptive rho (rho_update_every > 0) is not ported yet")
        if self.kkt_refine > 0:
            raise NotImplementedError("KKT refinement (kkt_refine > 0) is not ported yet")


@dataclass(frozen=True)
class QPSolution:
    x: torch.Tensor  # (B, n) primal
    y_constraints: torch.Tensor  # (B, m) duals of the A-rows
    y_box: torch.Tensor  # (B, n) duals of the variable box
    converged: torch.Tensor  # (B,) bool
    # active ADMM iterations: the convergence iteration, the divergence
    # freeze iteration, or the cap
    iterations: torch.Tensor  # (B,) int32
    prim_residual: torch.Tensor  # (B,)
    dual_residual: torch.Tensor  # (B,)


def _rho_pattern(lb, ub, settings: QPSettings):
    """Per-row rho multiplier: equality rows get rho_eq_scale."""
    eq = (ub - lb).abs() < 1e-12
    return torch.where(
        eq, torch.full_like(lb, settings.rho_eq_scale), torch.ones_like(lb)
    )


# Finite stand-in for "hard row" in the soft-threshold arrays.
_HARD = 1e20


def _soft_prox(v, lb, ub, thr):
    """Prox of the thr-scaled l1 box distance: inside the box -> v; outside
    -> shrink toward the box by thr, saturating at the box edge. thr =
    _HARD/rho reduces to the hard projection clip(v, lb, ub)."""
    box = torch.clamp(v, lb, ub)
    return v - torch.clamp(v - box, -thr, thr)
