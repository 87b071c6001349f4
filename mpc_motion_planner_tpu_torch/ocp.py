"""Minimum-time OCP transcription to a fixed-shape NLP (PyTorch).

Counterpart of ``mpc_motion_planner_tpu/ocp.py``: NX=14 (q, qdot), NU=7
(qddot), one parameter (final time p), NG=8 (7 RNEA torques + tool height)
on the 19-node Chebyshev–Gauss–Lobatto spline. Decision vector layout
(VAR = 400):

    z = [X_0, ..., X_18, U_0, ..., U_18, p],   X_k = [q_k, qdot_k]

The figures above are the Panda's; the robot is an argument of
:func:`make_ocp` (nx, nu, ng = 2 nq, nq, nq + 1). Every function takes a
leading batch dimension. The per-node constraint values and Jacobians of a
batch go where ``fused_constraints`` says (read once, at construction, from
``MPC_TPU_FUSED_CONSTRAINTS`` unless given, as in the JAX package):
"auto" through kernel 1 (:mod:`.kernels.constraints`) for CUDA tensors and
the plain version here for CPU tensors, "on" through kernel 1 (CPU tensors
raise), "off" through the plain version on every device, which is how a
model that kernel 1 refuses (prismatic joints, a branched tree) is planned
on the card. Under "auto" such a model raises, as on the TPU.

The dense linearization (:meth:`TranscribedOCP.constraint_matrix`, for the
dense QP backends) is A_eq = E_D + p C_dyn - f_rows e_p' with the constant
patterns E_D (differentiation matrix) and C_dyn (dynamics coupling), and
A_ineq scattered from the per-node Jacobians.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import os

import numpy as np
import torch

from .kernels import constraints as constraints_kernel
from .models.robot import Frame, RobotModel
from .ops import kinematics, rnea
from .ops.collocation import Collocation, derivative_at_nodes, make_collocation


@dataclass(frozen=True)
class TranscribedOCP:
    """Static transcription of the minimum-time OCP for one robot."""

    model: RobotModel
    coll: Collocation
    tool_frame: Frame
    # constant Jacobian patterns (num_eq, num_var) of the defects
    eq_diff_pattern: torch.Tensor  # E_D: differentiation-matrix block
    eq_dyn_pattern: torch.Tensor  # C_dyn: -(df/dx, df/du) coupling, scaled by p
    # the reference's d tau/d p linearization column (torque rows: dtau/dv
    # qdot + dtau/da qddot) instead of the exact zero; dense backends only,
    # as in the JAX package (the structured operator keeps the zero)
    tau_p_column: bool = False
    # where the batched constraint rows go: "auto", "on" or "off" (module
    # docstring)
    fused_constraints: str = "auto"

    @property
    def nq(self) -> int:
        return self.model.nq

    @property
    def nx(self) -> int:
        return 2 * self.model.nq

    @property
    def nu(self) -> int:
        return self.model.nq

    @property
    def ng(self) -> int:
        return self.model.nq + 1

    @property
    def num_nodes(self) -> int:
        return self.coll.num_nodes

    @property
    def num_var(self) -> int:
        return self.num_nodes * (self.nx + self.nu) + 1

    @property
    def num_eq(self) -> int:
        return self.coll.num_segments * (self.coll.order + 1) * self.nx

    @property
    def num_ineq(self) -> int:
        return self.num_nodes * self.ng

    def segment_index(self, device) -> torch.Tensor:
        return self.coll.segment_index(device)

    # ---------------- packing ----------------

    def pack(self, X, U, p):
        """(B, nodes, nx), (B, nodes, nu), (B,) -> (B, num_var)."""
        B = X.shape[0]
        return torch.cat([X.reshape(B, -1), U.reshape(B, -1), p.reshape(B, 1)], dim=-1)

    def unpack(self, z):
        n, nx, nu = self.num_nodes, self.nx, self.nu
        X = z[..., : n * nx].reshape(*z.shape[:-1], n, nx)
        U = z[..., n * nx : n * (nx + nu)].reshape(*z.shape[:-1], n, nu)
        return X, U, z[..., -1]

    # ---------------- NLP callbacks ----------------

    def cost(self, z):
        """Mayer term = p (pure minimum time)."""
        return z[..., -1]

    def cost_gradient(self, z):
        g = torch.zeros_like(z)
        g[..., -1] = 1.0
        return g

    def dynamics(self, x, u):
        """Unscaled f(x, u) = [qdot; u]; dx/dtau = p * f."""
        return torch.cat([x[..., self.nq :], u], dim=-1)

    def eq_residual(self, z):
        """Collocation defects at every segment-local node, (B, num_eq)."""
        X, U, p = self.unpack(z)
        dX = derivative_at_nodes(self.coll, X)  # (B, S, K, nx)
        f = self.dynamics(X, U)[:, self.segment_index(z.device)]
        return (dX - p[:, None, None, None] * f).reshape(z.shape[0], -1)

    def eq_residual_quadratic(self, z, d):
        """Exact expansion c(z + a d) = c0 + a c1 + a^2 c2 of the bilinear
        defects along a step direction. Returns (c0, c1, c2), (B, num_eq)."""
        B = z.shape[0]
        X, U, p = self.unpack(z)
        dX_d, dU_d, dp = self.unpack(d)
        idx = self.segment_index(z.device)
        f_z = self.dynamics(X, U)[:, idx]
        f_d = self.dynamics(dX_d, dU_d)[:, idx]
        p, dp = p[:, None, None, None], dp[:, None, None, None]
        c0 = derivative_at_nodes(self.coll, X) - p * f_z
        c1 = derivative_at_nodes(self.coll, dX_d) - p * f_d - dp * f_z
        c2 = -dp * f_d
        return c0.reshape(B, -1), c1.reshape(B, -1), c2.reshape(B, -1)

    def node_constraints(self, x, u):
        """Per-node inequality g = [tau (nq), tool height], (..., ng)."""
        nq = self.nq
        tau = rnea.rnea(self.model, x[..., :nq], x[..., nq:], u)
        height = kinematics.frame_height(self.model, x[..., :nq], self.tool_frame)
        return torch.cat([tau, height[..., None]], dim=-1)

    def ineq_residual(self, z):
        """(B, num_ineq) node-major stacked g values (plain path)."""
        X, U, _ = self.unpack(z)
        return self.node_constraints(X, U).reshape(z.shape[0], -1)

    def node_jacobians(self, X, U):
        """Exact Jacobians dg/d[x, u] of per-node inputs X (..., nx), U
        (..., nu): (..., ng, nx+nu), by forward-mode differentiation of the
        plain constraint function."""
        nx = self.nx
        xu = torch.cat([X, U], dim=-1)

        def g_of(v):
            return self.node_constraints(v[:nx], v[nx:])

        J = torch.func.vmap(torch.func.jacfwd(g_of))(xu.reshape(-1, xu.shape[-1]))
        return J.reshape(*xu.shape[:-1], self.ng, xu.shape[-1])

    def node_constraint_jacobians(self, z):
        """Exact per-node Jacobians at z, (B, nodes, ng, nx+nu)."""
        X, U, _ = self.unpack(z)
        return self.node_jacobians(X, U)

    # ---- batched constraint evaluation: kernel 1 or the plain path ----

    def uses_kernel(self, device) -> bool:
        """Whether the batched constraint rows of tensors on ``device`` go
        through kernel 1 (``fused_constraints``: "on", or "auto" on CUDA)."""
        if self.fused_constraints == "auto":
            return torch.device(device).type == "cuda"
        return self.fused_constraints == "on"

    def _node_constraints_batch(self, X, U, with_jac: bool):
        if self.fused_constraints == "off":
            return constraints_kernel.node_constraints_plain(self, X, U, with_jac)
        if self.fused_constraints == "on":
            return constraints_kernel.node_constraints_kernel(self, X, U, with_jac)
        return constraints_kernel.node_constraints(self, X, U, with_jac)

    def ineq_residual_batch(self, z):
        """(B, num_var) -> (B, num_ineq)."""
        X, U, _ = self.unpack(z)
        g = self._node_constraints_batch(X, U, with_jac=False)
        return g.reshape(z.shape[0], -1)

    def linearize_constraints_batch(self, z):
        """(B, num_var) -> (g (B, num_ineq), J (B, nodes, ng, nx+nu))."""
        X, U, _ = self.unpack(z)
        g, J = self._node_constraints_batch(X, U, with_jac=True)
        return g.reshape(z.shape[0], -1), J

    # ---- dense linearization (dense QP backends) ----

    def _eq_jacobian_into(self, A, z):
        X, U, p = self.unpack(z)
        A.copy_(self.eq_diff_pattern.expand_as(A))
        A.addcmul_(p[:, None, None], self.eq_dyn_pattern)
        idx = self.segment_index(z.device).reshape(-1)
        A[:, :, -1] -= self.dynamics(X, U)[:, idx].reshape(z.shape[0], -1)

    def _ineq_jacobian_into(self, A, z, J):
        rows, cols = _ineq_scatter_index_tensors(self.num_nodes, self.ng, self.nx, self.nu,
                                                 z.device)
        A[:, rows, cols] = J.reshape(z.shape[0], -1)
        if self.tau_p_column:
            X, U, _ = self.unpack(z)
            nq = self.nq
            q = X[..., :nq]
            _, dtau = torch.func.jvp(
                lambda v, a: rnea.rnea(self.model, q, v, a), (X[..., nq:], U), (X[..., nq:], U)
            )  # (B, nodes, nq)
            trows = (torch.arange(self.num_nodes, device=z.device)[:, None] * self.ng
                     + torch.arange(nq, device=z.device)[None, :]).reshape(-1)
            A[:, trows, -1] = dtau.reshape(z.shape[0], -1)

    def eq_jacobian(self, z):
        """Dense (B, num_eq, num_var) defect Jacobian (exact)."""
        A = z.new_empty(z.shape[0], self.num_eq, self.num_var)
        self._eq_jacobian_into(A, z)
        return A

    def ineq_jacobian(self, z, J=None):
        """Dense (B, num_ineq, num_var) constraint Jacobian (exact; dg/dp = 0
        unless ``tau_p_column``). J: optionally the precomputed per-node
        Jacobians (B, nodes, ng, nx+nu)."""
        A = z.new_zeros(z.shape[0], self.num_ineq, self.num_var)
        self._ineq_jacobian_into(A, z, self.node_constraint_jacobians(z) if J is None else J)
        return A

    def constraint_matrix(self, z, J=None):
        """Stacked (B, num_eq + num_ineq, num_var) linearization, built in
        one buffer by scatter. J: as for :meth:`ineq_jacobian`."""
        A = z.new_zeros(z.shape[0], self.num_eq + self.num_ineq, self.num_var)
        self._eq_jacobian_into(A[:, : self.num_eq], z)
        self._ineq_jacobian_into(
            A[:, self.num_eq :], z, self.node_constraint_jacobians(z) if J is None else J
        )
        return A


def _build_constant_patterns(coll: Collocation, nx: int, nu: int):
    """Host-side E_D and C_dyn (float64 numpy), as the JAX package builds
    them."""
    S, order = coll.num_segments, coll.order
    nodes = order * S + 1
    num_eq = S * (order + 1) * nx
    num_var = nodes * (nx + nu) + 1
    D = coll.diff_matrix.detach().cpu().double().numpy()
    seg_idx = coll.segment_indices()

    E = np.zeros((num_eq, num_var))
    C = np.zeros((num_eq, num_var))
    nq = nx // 2
    u_base = nodes * nx
    for s in range(S):
        for k in range(order + 1):
            node_k = int(seg_idx[s, k])
            for i in range(nx):
                r = (s * (order + 1) + k) * nx + i
                for j in range(order + 1):
                    E[r, int(seg_idx[s, j]) * nx + i] += D[k, j]
                # -p * df/d(x,u): f_i = x_{i+nq} for i < nq else u_{i-nq}
                if i < nq:
                    C[r, node_k * nx + i + nq] += -1.0
                else:
                    C[r, u_base + node_k * nu + (i - nq)] += -1.0
    return E, C


@lru_cache(maxsize=None)
def _ineq_scatter_indices(nodes: int, ng: int, nx: int, nu: int):
    """Flat (rows, cols) mapping (nodes, ng, nx+nu) -> dense A_ineq."""
    node = np.arange(nodes)[:, None, None]
    c = np.arange(ng)[None, :, None]
    d = np.arange(nx + nu)[None, None, :]
    rows = np.broadcast_to(node * ng + c, (nodes, ng, nx + nu))
    cols = np.broadcast_to(
        np.where(d < nx, node * nx + d, nodes * nx + node * nu + (d - nx)),
        (nodes, ng, nx + nu),
    )
    return rows.reshape(-1), cols.reshape(-1)


@lru_cache(maxsize=None)
def _ineq_scatter_index_tensors(nodes: int, ng: int, nx: int, nu: int, device: torch.device):
    """:func:`_ineq_scatter_indices` on ``device``, made once per device."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in _ineq_scatter_indices(nodes, ng, nx, nu))


def make_ocp(
    model: RobotModel,
    tool_frame_name: str = "panda_tool",
    order: int = 3,
    num_segments: int = 6,
    tau_p_column: bool = False,
    fused_constraints: str = None,
) -> TranscribedOCP:
    """The OCP in the model's dtype and on its device. ``fused_constraints``
    ("auto", "on" or "off"; module docstring) defaults to the environment's
    ``MPC_TPU_FUSED_CONSTRAINTS``, read here once, else "auto"."""
    if fused_constraints is None:
        fused_constraints = os.environ.get("MPC_TPU_FUSED_CONSTRAINTS", "auto")
    if fused_constraints not in ("auto", "on", "off"):
        raise ValueError(f"fused_constraints must be auto/on/off, got {fused_constraints!r}")
    dt, dev = model.mass.dtype, model.mass.device
    coll = make_collocation(order, num_segments, dtype=dt, device=dev)
    E, C = _build_constant_patterns(coll, 2 * model.nq, model.nq)
    return TranscribedOCP(
        model=model, coll=coll, tool_frame=model.frame(tool_frame_name),
        eq_diff_pattern=torch.as_tensor(E, dtype=dt, device=dev),
        eq_dyn_pattern=torch.as_tensor(C, dtype=dt, device=dev),
        tau_p_column=tau_p_column, fused_constraints=fused_constraints,
    )


# ---------------- bounds assembly ----------------


@dataclass(frozen=True)
class NLPBounds:
    """Variable and constraint boxes for one batched solve."""

    lb_var: torch.Tensor  # (B, num_var)
    ub_var: torch.Tensor
    lb_ineq: torch.Tensor  # (B, num_ineq)
    ub_ineq: torch.Tensor


def assemble_bounds(
    ocp: TranscribedOCP,
    current_state,
    target_state,
    state_lb,
    state_ub,
    control_lb,
    control_ub,
    param_lb,
    param_ub,
    ineq_lb,
    ineq_ub,
    target_eps: float = 1e-2,
) -> NLPBounds:
    """Interior nodes get the state box, node 0 is pinned to the current
    state, node N-1 gets target +- eps; all nodes share the control box and
    the nonlinear-constraint box. current/target_state (B, nx)."""
    n = ocp.num_nodes
    B = current_state.shape[0]
    dt, dev = current_state.dtype, current_state.device

    lbX = state_lb.expand(B, n, -1).clone()
    ubX = state_ub.expand(B, n, -1).clone()
    lbX[:, 0] = current_state
    ubX[:, 0] = current_state
    lbX[:, n - 1] = target_state - target_eps
    ubX[:, n - 1] = target_state + target_eps

    lbU = control_lb.expand(B, n, -1)
    ubU = control_ub.expand(B, n, -1)
    pl = torch.full((B, 1), float(param_lb), dtype=dt, device=dev)
    pu = torch.full((B, 1), float(param_ub), dtype=dt, device=dev)

    lb = torch.cat([lbX.reshape(B, -1), lbU.reshape(B, -1), pl], dim=-1)
    ub = torch.cat([ubX.reshape(B, -1), ubU.reshape(B, -1), pu], dim=-1)
    return NLPBounds(
        lb_var=lb,
        ub_var=ub,
        lb_ineq=ineq_lb.repeat(n).expand(B, -1),
        ub_ineq=ineq_ub.repeat(n).expand(B, -1),
    )
