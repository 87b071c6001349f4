"""Batched boxADMM QP solver: settings, solution, the row helpers and the
dense backends.

Counterpart of ``mpc_motion_planner_tpu/ops/qp.py``. The QP is

    min 1/2 x'Px + q'x   s.t.  lc <= A x <= uc,  lx <= x <= ux

with optional l1-elastic (soft) rows. :func:`solve_box_qp` solves it over
an explicit dense A (B, m, n) and the explicit inverse of the ADMM KKT
matrix M = P + sigma I + rho_x I + A' diag(rho_c) A, factored once per
solve (and again after each rho update):

* ``backend="xla"``: the JAX package's portable dense loop, in plain
  PyTorch on any device and in the caller's dtype. Adaptive rho refactors
  inside the loop; P may be diagonal (B, n) or dense (B, n, n).
* ``backend="pallas"``: float32 chunks of the loop through kernel 4
  (:mod:`..kernels.admm_dense`: the hand-written CUDA kernel for CUDA
  tensors, its plain version for CPU tensors), with the rho update and
  refactorization between chunks. Diagonal P only.

The structured backends live in :mod:`.qp_structured` and
:mod:`..kernels.structured_admm`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

DENSE_BACKENDS = ("xla", "pallas")
STRUCTURED_BACKENDS = ("structured", "structured_pallas")


@dataclass(frozen=True)
class QPSettings:
    """The JAX package's ``QPSettings`` without its TPU knobs
    (``pallas_group``, ``pallas_precision``, ``exit_every``, ``exit_warmup``,
    ``exit_schedule``); every field keeps the JAX default."""

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
    # OSQP-style adaptive rho: per-problem rescale every rho_update_every
    # iterations by sqrt(prim/dual residual ratio) (0 disables)
    rho_update_every: int = 100
    rho_min: float = 1e-6
    rho_max: float = 1e6
    # "xla", "pallas" (dense) or "structured", "structured_pallas"
    backend: str = "xla"
    # extra ADMM iterations past max_iter (structured backends)
    rescue_iters: int = 0
    # explicit KKT inverse of the dense backends: "lu" or "cholesky"
    kkt_factor: str = "lu"
    # iterative-refinement steps on each x-update's KKT solve
    kkt_refine: int = 0

    def check_structured(self) -> None:
        """Raise for what the structured solver does not run: it updates rho
        between dispatches of ``rho_update_every`` iterations, so a residual
        check must fall on every rho update."""
        if self.rho_update_every > 0 and self.rho_update_every % self.check_every != 0:
            raise ValueError(
                f"check_every ({self.check_every}) must divide rho_update_every "
                f"({self.rho_update_every}) on the structured backends"
            )


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


def _bmv(M, v):
    """Batched M @ v: (B, r, c), (B, c) -> (B, r)."""
    return torch.einsum("bij,bj->bi", M, v)


def _bmtv(M, v):
    """Batched M' @ v: (B, r, c), (B, r) -> (B, c)."""
    return torch.einsum("bij,bi->bj", M, v)


def _pmul(Ps, x):
    """P @ x for diagonal (B, n) or dense (B, n, n) P."""
    if Ps.ndim == 3:
        return _bmv(Ps, x)
    return Ps * x


def _residuals(As, Ps, qs, D, E, x, zc, zx, yc, yx, x_scales=True):
    """The OSQP primal and dual residuals of a scaled iterate and their
    scales, in unscaled units: (r_prim, r_dual, scale_p, scale_d), each (B,).
    ``x_scales=False`` leaves |D x|, |D zx| and |P x / D| out of the scales,
    as the "pallas" backend's rho update between chunks does."""
    amax = lambda a: a.abs().amax(dim=-1)
    Ax = _bmv(As, x)
    r_prim = torch.maximum(amax((Ax - zc) / E), amax(D * (x - zx)))
    Aty = _bmtv(As, yc)
    Px = _pmul(Ps, x)
    r_dual = amax((Px + qs + Aty + yx) / D)
    scale_p = torch.maximum(amax(Ax / E), amax(zc / E))
    scale_d = torch.maximum(torch.maximum(amax(qs / D), amax(Aty / D)), amax(yx / D))
    if x_scales:
        scale_p = torch.maximum(scale_p, torch.maximum(amax(D * x), amax(D * zx)))
        scale_d = torch.maximum(scale_d, amax(Px / D))
    return r_prim, r_dual, scale_p, scale_d


def _rho_ratio(r_prim, r_dual, scale_p, scale_d):
    """sqrt of the scaled primal/dual residual ratio that drives the
    OSQP-style rho update."""
    return torch.sqrt(
        (r_prim / torch.clamp(scale_p, min=1e-12))
        / torch.clamp(r_dual / torch.clamp(scale_d, min=1e-12), min=1e-12)
    )


@contextlib.contextmanager
def _capturable_linalg(device):
    """For a CUDA ``device``, batched LU and Cholesky through cuSOLVER and
    cuBLAS instead of PyTorch's default choice for large batches, MAGMA,
    whose batched LU a CUDA graph cannot capture. Eager and captured solves
    both take this route, so they compute the same M^-1."""
    if torch.device(device).type != "cuda":
        yield
        return
    saved = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(saved)


def _inverse(M):
    """Batched M^-1 by LU, without the singularity check that would
    synchronise with the host (M is symmetric positive definite here)."""
    with _capturable_linalg(M.device):
        return torch.linalg.inv_ex(M)[0]


def _ruiz_equilibrate(A, iters: int):
    """Ruiz equilibration: diagonal D (cols) and E (rows) so the scaled
    E A D has rows/cols with ~unit inf-norms. Returns (D, E)."""
    B, m, n = A.shape
    D = A.new_ones(B, n)
    E = A.new_ones(B, m)

    def scale(norm):
        # leave all-zero rows/cols untouched instead of blowing up
        return torch.where(
            norm > 1e-10, 1.0 / torch.sqrt(torch.clamp(norm, min=1e-10)),
            torch.ones_like(norm),
        )

    for _ in range(iters):
        As = (E[:, :, None] * A * D[:, None, :]).abs()
        cnorm = As.amax(dim=1)  # (B, n)
        rnorm = As.amax(dim=2)  # (B, m)
        D = D * scale(cnorm)
        E = E * scale(rnorm)
    return D, E


@dataclass(frozen=True)
class DenseQP:
    """A Ruiz-scaled dense QP batch in the caller's dtype: the scaled data,
    the rho patterns, the scaled soft-row weights (``_HARD`` on hard rows)
    and the scaled warm starts."""

    As: torch.Tensor  # (B, m, n)
    Ps: torch.Tensor  # (B, n) or (B, n, n)
    qs: torch.Tensor
    lcs: torch.Tensor
    ucs: torch.Tensor
    lxs: torch.Tensor
    uxs: torch.Tensor
    D: torch.Tensor  # (B, n) column scaling
    E: torch.Tensor  # (B, m) row scaling
    pat_c: torch.Tensor
    pat_x: torch.Tensor
    soft_s: torch.Tensor
    soft_xs: torch.Tensor
    x: torch.Tensor
    yc: torch.Tensor
    yx: torch.Tensor

    def factor(self, rho_s, settings: QPSettings):
        """The explicit M^-1 of M = P + sigma I + diag(rho_x) + A' diag(rho_c) A
        for per-problem rho (B,)."""
        As, Ps = self.As, self.Ps
        B, _, n = As.shape
        rc = rho_s[:, None] * self.pat_c
        rx = rho_s[:, None] * self.pat_x
        M = torch.bmm(As.transpose(1, 2), rc[:, :, None] * As)
        if Ps.ndim == 3:
            M = M + Ps + torch.diag_embed(settings.sigma + rx)
        else:
            M = M + torch.diag_embed(Ps + settings.sigma + rx)
        if settings.kkt_factor == "lu":
            return _inverse(M)
        with _capturable_linalg(M.device):
            L, info = torch.linalg.cholesky_ex(M)
            eye = torch.eye(n, dtype=M.dtype, device=M.device).expand(B, n, n)
            Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        M_chol = Linv.transpose(1, 2) @ Linv
        # Cholesky breakdown at float32 (cond(M) grows with rho_eq_scale):
        # those problems take the LU inverse, computed for the whole batch and
        # taken under the mask (no host synchronisation)
        bad = (info != 0) | ~torch.isfinite(M_chol).all(dim=(1, 2))
        return torch.where(bad[:, None, None], _inverse(M), M_chol)


def scale_dense_qp(P_diag, q, A, lc, uc, lx, ux, settings: QPSettings,
                   x0=None, yc0=None, yx0=None, soft_c=None, soft_x=None) -> DenseQP:
    """Ruiz scaling, rho patterns, scaled soft-row weights and warm starts,
    in the dtype of ``q``."""
    B, m, n = A.shape
    dt, dev = q.dtype, q.device
    if settings.ruiz_iters > 0:
        D, E = _ruiz_equilibrate(A, settings.ruiz_iters)
    else:
        D = torch.ones(B, n, dtype=dt, device=dev)
        E = torch.ones(B, m, dtype=dt, device=dev)
    hard_m = torch.full((B, m), _HARD, dtype=dt, device=dev)
    hard_n = torch.full((B, n), _HARD, dtype=dt, device=dev)
    return DenseQP(
        As=E[:, :, None] * A * D[:, None, :],
        Ps=D[:, :, None] * P_diag * D[:, None, :] if P_diag.ndim == 3 else D * P_diag * D,
        qs=D * q,
        lcs=E * lc, ucs=E * uc, lxs=lx / D, uxs=ux / D, D=D, E=E,
        pat_c=_rho_pattern(lc, uc, settings),
        pat_x=_rho_pattern(lx, ux, settings),
        soft_s=hard_m if soft_c is None else torch.where(soft_c > 0, soft_c.to(dt) / E, hard_m),
        # variable-box weights scale by D (unscaled box distance = D * scaled)
        soft_xs=hard_n if soft_x is None else torch.where(soft_x > 0, soft_x.to(dt) * D, hard_n),
        x=torch.zeros(B, n, dtype=dt, device=dev) if x0 is None else x0 / D,
        yc=torch.zeros(B, m, dtype=dt, device=dev) if yc0 is None else yc0 / E,
        yx=torch.zeros(B, n, dtype=dt, device=dev) if yx0 is None else yx0 * D,
    )


def solve_box_qp(
    P_diag, q, A, lc, uc, lx, ux, settings: QPSettings = QPSettings(),
    x0=None, yc0=None, yx0=None, soft_c=None, soft_x=None,
) -> QPSolution:
    """Solve a batch of box QPs  min 1/2 x'Px + q'x  s.t.  lc <= A x <= uc,
    lx <= x <= ux  with a dense backend (``settings.backend`` "xla" or
    "pallas").

    Shapes: q, lx, ux (B, n); A (B, m, n); lc, uc (B, m); P_diag diagonal
    (B, n) or, on the "xla" backend, dense symmetric PSD (B, n, n). Warm
    starts, solutions and the termination residuals are in unscaled units.
    soft_c (B, m) / soft_x (B, n): optional l1 penalty weights of soft
    constraint rows / variable-box rows (0 = hard; see :func:`_soft_prox`).
    """
    if settings.backend not in DENSE_BACKENDS:
        raise ValueError(
            f"solve_box_qp runs the dense backends {DENSE_BACKENDS}, got {settings.backend!r}"
        )
    if settings.kkt_factor not in ("lu", "cholesky"):
        raise ValueError(f"kkt_factor must be 'lu' or 'cholesky', got {settings.kkt_factor!r}")
    if P_diag.ndim == 3 and settings.backend != "xla":
        raise ValueError(
            "dense P is only supported on the 'xla' backend; the pallas and "
            "structured backends exploit diagonal P (the planner's regularized "
            "zero Hessian)."
        )
    qp = scale_dense_qp(P_diag, q, A, lc, uc, lx, ux, settings, x0, yc0, yx0, soft_c, soft_x)
    if settings.backend == "pallas":
        return solve_pallas(qp, settings)
    return solve_xla(qp, settings)


# ---------------------------------------------------------------------------
# The "pallas" backend: chunks of kernel 4
# ---------------------------------------------------------------------------


def pallas_operands(qp: DenseQP, rho_s, M_inv):
    """Kernel 4's float32 operands (``admm_dense_chunk``) for per-problem
    rho (B,), with ±1e20 stand-ins for infinite bounds (the box projection
    behaves the same; the kernel's semantics are defined on finite data)."""
    f32 = lambda a: a.to(torch.float32).contiguous()
    finite = lambda v: f32(torch.clamp(v, -_HARD, _HARD))
    return {
        "M_inv": f32(M_inv), "A": f32(qp.As), "P": f32(qp.Ps), "q": f32(qp.qs),
        "lc": finite(qp.lcs), "uc": finite(qp.ucs), "lx": finite(qp.lxs), "ux": finite(qp.uxs),
        "rc": f32(rho_s[:, None] * qp.pat_c), "rx": f32(rho_s[:, None] * qp.pat_x),
        "D": f32(qp.D), "E": f32(qp.E), "sc": f32(qp.soft_s), "sx": f32(qp.soft_xs),
    }


def pallas_state(qp: DenseQP):
    """Kernel 4's initial float32 state: zc = clip(As x, lcs, ucs) and
    zx = clip(x, lxs, uxs) in the caller's dtype, done = 0."""
    f32 = lambda a: a.to(torch.float32).contiguous()
    return {
        "x": f32(qp.x),
        "zc": f32(torch.clamp(_bmv(qp.As, qp.x), qp.lcs, qp.ucs)),
        "zx": f32(torch.clamp(qp.x, qp.lxs, qp.uxs)),
        "yc": f32(qp.yc),
        "yx": f32(qp.yx),
        "done": torch.zeros(qp.x.shape[0], dtype=torch.int32, device=qp.x.device),
    }


def solve_pallas(qp: DenseQP, settings: QPSettings, chunk_fn=None) -> QPSolution:
    """Float32 chunks of kernel 4 (``rho_update_every`` iterations each, or
    one chunk of ``max_iter``) with the OSQP-style rho update and the
    batched refactorization between chunks, at every boundary and under the
    per-problem mask (no host synchronisation; where no rho moved, M^-1
    comes out as it was); results in the caller's dtype.
    ``chunk_fn`` replaces :func:`..kernels.admm_dense.admm_dense_chunk`
    (the GPU check runs the plain version on the card through it)."""
    if chunk_fn is None:
        from ..kernels.admm_dense import admm_dense_chunk as chunk_fn

    dt = qp.qs.dtype
    B = qp.x.shape[0]
    chunk = settings.rho_update_every if settings.rho_update_every > 0 else settings.max_iter
    n_chunks = -(-settings.max_iter // chunk)

    rho_s = torch.full((B,), settings.rho, dtype=dt, device=qp.x.device)
    M_inv = qp.factor(rho_s, settings)
    state = pallas_state(qp)
    total_used = torch.zeros(B, dtype=torch.int32, device=qp.x.device)
    for c in range(n_chunks):
        state, used = chunk_fn(
            pallas_operands(qp, rho_s, M_inv), state,
            chunk_iters=min(chunk, settings.max_iter - c * chunk),
            check_every=settings.check_every, eps_abs=settings.eps_abs,
            eps_rel=settings.eps_rel, sigma=settings.sigma, alpha=settings.alpha,
            kkt_refine=settings.kkt_refine,
        )
        total_used = total_used + used
        if c < n_chunks - 1 and settings.rho_update_every > 0:
            ratio = _rho_ratio(*_residuals(
                qp.As, qp.Ps, qp.qs, qp.D, qp.E,
                *(state[k].to(dt) for k in ("x", "zc", "zx", "yc", "yx")), x_scales=False))
            want = (state["done"] == 0) & ((ratio > 5.0) | (ratio < 0.2))
            rho_new = torch.where(
                want, torch.clamp(rho_s * ratio, settings.rho_min, settings.rho_max), rho_s
            )
            M_inv = qp.factor(rho_new, settings)
            rho_s = rho_new

    zb = torch.zeros(B, dtype=dt, device=qp.x.device)
    return QPSolution(
        x=qp.D * state["x"].to(dt),
        y_constraints=qp.E * state["yc"].to(dt),
        y_box=state["yx"].to(dt) / qp.D,
        # done codes: 1 converged, 2 diverged and frozen (unconverged)
        converged=state["done"] == 1,
        iterations=total_used,
        prim_residual=zb,
        dual_residual=zb,
    )


# ---------------------------------------------------------------------------
# The "xla" backend: the portable loop in plain PyTorch
# ---------------------------------------------------------------------------


def solve_xla(qp: DenseQP, settings: QPSettings) -> QPSolution:
    """The portable dense loop: no flush-to-zero and no divergence freeze;
    adaptive rho refactors inside the loop (at every update, under the
    per-problem mask); the residuals of the last check. An eager loop stops
    when every problem is done; a loop captured into a CUDA graph cannot ask
    and runs its whole budget, with done problems frozen: the same results,
    with more work."""
    from ..kernels.build import capturing

    As, Ps, qs, D, E = qp.As, qp.Ps, qp.qs, qp.D, qp.E
    lcs, ucs, lxs, uxs = qp.lcs, qp.ucs, qp.lxs, qp.uxs
    x, yc, yx = qp.x, qp.yc, qp.yx
    B = x.shape[0]
    sigma, alpha = settings.sigma, settings.alpha
    zc = torch.clamp(_bmv(As, x), lcs, ucs)
    zx = torch.clamp(x, lxs, uxs)

    def residuals(x, zc, zx, yc, yx):
        """Unscaled OSQP residuals, the convergence test and the rho ratio."""
        r_prim, r_dual, scale_p, scale_d = _residuals(As, Ps, qs, D, E, x, zc, zx, yc, yx)
        conv = (r_prim <= settings.eps_abs + settings.eps_rel * scale_p) & (
            r_dual <= settings.eps_abs + settings.eps_rel * scale_d
        )
        return r_prim, r_dual, conv, _rho_ratio(r_prim, r_dual, scale_p, scale_d)

    done = torch.zeros(B, dtype=torch.bool, device=x.device)
    iters = torch.full((B,), settings.max_iter, dtype=torch.int32, device=x.device)
    rp = torch.zeros(B, dtype=x.dtype, device=x.device)
    rd = torch.zeros_like(rp)
    rho_s = torch.full((B,), settings.rho, dtype=x.dtype, device=x.device)
    M_inv = qp.factor(rho_s, settings)
    for k in range(1, settings.max_iter + 1):
        rc = rho_s[:, None] * qp.pat_c
        rx = rho_s[:, None] * qp.pat_x
        rhs = sigma * x - qs + _bmtv(As, rc * zc - yc) + (rx * zx - yx)
        xt = _bmv(M_inv, rhs)
        for _ in range(settings.kkt_refine):
            Mxt = _pmul(Ps, xt) + (sigma + rx) * xt + _bmtv(As, rc * _bmv(As, xt))
            xt = xt + _bmv(M_inv, rhs - Mxt)
        zt_c = _bmv(As, xt)

        x_new = alpha * xt + (1.0 - alpha) * x
        zc_arg = alpha * zt_c + (1.0 - alpha) * zc
        # numerator capped before the divide so the hard-row quotient stays finite
        thr = torch.minimum(qp.soft_s, _HARD * rc) / rc
        zc_new = _soft_prox(zc_arg + yc / rc, lcs, ucs, thr)
        yc_new = yc + rc * (zc_arg - zc_new)
        zx_arg = alpha * xt + (1.0 - alpha) * zx
        thr_x = torch.minimum(qp.soft_xs, _HARD * rx) / rx
        zx_new = _soft_prox(zx_arg + yx / rx, lxs, uxs, thr_x)
        yx_new = yx + rx * (zx_arg - zx_new)

        # converged problems stay frozen at their termination point
        keep = done[:, None]
        x = torch.where(keep, x, x_new)
        zc = torch.where(keep, zc, zc_new)
        zx = torch.where(keep, zx, zx_new)
        yc = torch.where(keep, yc, yc_new)
        yx = torch.where(keep, yx, yx_new)

        if k % settings.check_every == 0 or k >= settings.max_iter:
            rp_new, rd_new, conv, ratio = residuals(x, zc, zx, yc, yx)
            rp = torch.where(done, rp, rp_new)
            rd = torch.where(done, rd, rd_new)
            iters = torch.where(conv & ~done, torch.full_like(iters, k), iters)
            done = done | conv
            if settings.rho_update_every > 0 and k % settings.rho_update_every == 0:
                want = ~done & ((ratio > 5.0) | (ratio < 0.2))
                rho_new = torch.where(
                    want, torch.clamp(rho_s * ratio, settings.rho_min, settings.rho_max),
                    rho_s,
                )
                M_inv = qp.factor(rho_new, settings)
                rho_s = rho_new
            if not capturing(x.device) and bool(done.all()):
                break

    return QPSolution(
        x=D * x,
        y_constraints=E * yc,
        y_box=yx / D,
        converged=done,
        iterations=iters,
        prim_residual=rp,
        dual_residual=rd,
    )
