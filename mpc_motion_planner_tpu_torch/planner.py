"""Planner facade: the PyTorch ``MotionPlanner``.

Counterpart of ``mpc_motion_planner_tpu/planner.py`` (solve path): margins,
margin-scaled bounds, the jerk-limited warm start, the batched SQP solve and
trajectory sampling. Every solve is batched: states carry a leading batch
axis and one ``solve`` plans B trajectories on the planner's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .models.panda import TOOL_FRAME, PandaLimits, make_panda_limits, make_panda_model
from .models.robot import RobotModel
from .ocp import NLPBounds, TranscribedOCP, assemble_bounds, make_ocp
from .ops import kinematics, rnea
from .ops.collocation import interpolate
from .ops.otg import JerkLimitedTrajectory, plan_trajectory
from .ops.qp import QPSettings
from .ops.sqp import SQPResult, SQPSettings, sqp_solve


@dataclass(frozen=True)
class Margins:
    """Fractional margins on the robot limits."""

    position: float = 1.0
    velocity: float = 1.0
    acceleration: float = 1.0
    torque: float = 1.0
    jerk: float = 1.0


@dataclass(frozen=True)
class Solution:
    """Result of a batched solve: solver state + trajectory accessors."""

    ocp: TranscribedOCP
    z: torch.Tensor  # (B, num_var)
    lam_c: torch.Tensor
    lam_x: torch.Tensor
    violation: torch.Tensor  # (B,)
    qp_iterations: torch.Tensor  # (B, sqp_iters)
    qp_converged: torch.Tensor
    step_sizes: torch.Tensor
    warm_start: Optional[JerkLimitedTrajectory]

    @property
    def final_time(self):
        """t_f = p (seconds), shape (B,)."""
        return self.z[..., -1]

    def states(self):
        return self.ocp.unpack(self.z)

    def x_at(self, t_norm):
        """State at normalized time(s) t in [0,1]: (B, [T,] nx)."""
        X, _, _ = self.states()
        return interpolate(self.ocp.coll, X, t_norm)

    def u_at(self, t_norm):
        _, U, _ = self.states()
        return interpolate(self.ocp.coll, U, t_norm)

    def sample(self, n_points: int):
        """(time (B, N+1), q, qdot, qddot, tau each (B, N+1, nq)) at n_points+1
        uniform times, de-normalized by t_f."""
        t_norm = torch.linspace(0.0, 1.0, n_points + 1, dtype=self.z.dtype, device=self.z.device)
        x = self.x_at(t_norm)
        u = self.u_at(t_norm)
        nq = self.ocp.nq
        q, qd = x[..., :nq], x[..., nq:]
        tau = rnea.rnea(self.ocp.model, q, qd, u)
        return t_norm[None, :] * self.final_time[:, None], q, qd, u, tau


class MotionPlanner:
    """User-facing planner; tensors live on ``device`` in ``dtype``. The
    device defaults to the GPU: without one, torch raises unless the caller
    passes ``device="cpu"``. The settings default to the JAX package's (the
    dense "xla" QP); the shipping ones are in ``config.py``."""

    def __init__(
        self,
        model: Optional[RobotModel] = None,
        limits: Optional[PandaLimits] = None,
        tool_frame: str = TOOL_FRAME,
        margins: Margins = Margins(),
        sqp_settings: SQPSettings = SQPSettings(),
        qp_settings: QPSettings = QPSettings(),
        target_eps: float = 1e-2,
        time_bounds: Tuple[float, float] = (0.0, 10.0),
        dtype=torch.float64,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.dtype = dtype
        self.model = (model or make_panda_model()).to(self.device, dtype)
        self.limits = (limits or make_panda_limits()).to(self.device, dtype)
        self.ocp = make_ocp(self.model, tool_frame)
        self.margins = margins
        self.sqp_settings = sqp_settings
        self.qp_settings = qp_settings
        self.target_eps = target_eps
        self.time_bounds = time_bounds
        self._tool = self.model.frame(tool_frame)

    # ---------------- margin-scaled limits ----------------

    def position_bounds(self):
        lim, m = self.limits, self.margins
        safety = (1.0 - m.position) * (lim.max_position - lim.min_position) / 2.0
        return lim.min_position + safety, lim.max_position - safety

    def state_bounds(self):
        lo_q, hi_q = self.position_bounds()
        v = self.margins.velocity * self.limits.max_velocity
        return torch.cat([lo_q, -v]), torch.cat([hi_q, v])

    def control_bounds(self):
        a = self.margins.acceleration * self.limits.max_acceleration
        return -a, a

    def ineq_bounds(self):
        """Torque box + tool height floor."""
        t = self.margins.torque * self.limits.max_torque
        h = t.new_tensor([self.limits.min_height])
        return torch.cat([-t, h]), torch.cat([t, h.new_tensor([float("inf")])])

    def nlp_bounds(self, current_state, target_state) -> NLPBounds:
        s_lo, s_hi = self.state_bounds()
        c_lo, c_hi = self.control_bounds()
        g_lo, g_hi = self.ineq_bounds()
        return assemble_bounds(
            self.ocp, current_state, target_state, s_lo, s_hi, c_lo, c_hi,
            self.time_bounds[0], self.time_bounds[1], g_lo, g_hi, self.target_eps,
        )

    # ---------------- warm start ----------------

    def plan_warm_start(self, current_state, target_state) -> JerkLimitedTrajectory:
        """Jerk-limited time-optimal trajectory between the boundary states."""
        nq = self.ocp.nq
        m = self.margins
        return plan_trajectory(
            current_state[..., :nq],
            current_state[..., nq:],
            target_state[..., :nq],
            target_state[..., nq:],
            m.velocity * self.limits.max_velocity,
            m.acceleration * self.limits.max_acceleration,
            m.jerk * self.limits.max_jerk,
        )

    def warm_start_vector(self, traj: JerkLimitedTrajectory):
        """Sample the OTG trajectory at the collocation nodes and pack the
        initial NLP iterate with p0 = OTG duration. (B, num_var)."""
        ts = self.ocp.coll.time_nodes[None, :] * traj.duration[:, None]  # (B, nodes)
        # at_time broadcasts over the batch: put the nodes on a leading axis
        tr = JerkLimitedTrajectory(*(a[None] for a in (
            traj.duration, traj.start_position, traj.start_velocity,
            traj.start_acceleration, traj.phase_dt, traj.phase_jerk,
        )))
        p, v, a = tr.at_time(ts.T)  # (nodes, B, nj)
        X = torch.cat([p, v], dim=-1).transpose(0, 1)
        return self.ocp.pack(X, a.transpose(0, 1), traj.duration)

    # ---------------- solve ----------------

    def solve(self, current_state, target_state, z0=None, lam_c0=None,
              lam_x0=None) -> Solution:
        """Batched minimum-time solve; current/target_state (B, 2*nq). With
        z0 None an OTG warm start is planned and used."""
        if z0 is None:
            traj = self.plan_warm_start(current_state, target_state)
            z0 = self.warm_start_vector(traj)
        else:
            traj = None
        bounds = self.nlp_bounds(current_state, target_state)
        res: SQPResult = sqp_solve(
            self.ocp, bounds, z0, self.sqp_settings, self.qp_settings,
            lam_c0=lam_c0, lam_x0=lam_x0,
        )
        return Solution(
            ocp=self.ocp, z=res.z, lam_c=res.lam_c, lam_x=res.lam_x,
            violation=res.violation, qp_iterations=res.qp_iterations,
            qp_converged=res.qp_converged, step_sizes=res.step_sizes,
            warm_start=traj,
        )

    # ---------------- sampling ----------------

    def sample_random_state(self, generator: torch.Generator, batch: int,
                            max_rounds: int = 64):
        """Random (position (B, nq), velocity (B, nq)), positions rejection-
        sampled until joint 7's origin is above the height floor. Raises if
        some draw is still below it after ``max_rounds`` rounds."""
        lo_q, hi_q = self.position_bounds()
        vmax = self.margins.velocity * self.limits.max_velocity
        nq = self.ocp.nq

        def uniform(lo, hi):
            r = torch.rand(batch, nq, generator=generator, dtype=self.dtype,
                           device=generator.device)
            return (lo + (hi - lo) * r.to(self.device))

        def joint7_height(q):
            _, p = kinematics.fk(self.model, q)
            return p[..., nq - 1, 2]

        q = uniform(lo_q, hi_q)
        for _ in range(max_rounds):
            bad = joint7_height(q) < self.limits.min_height
            if not bool(bad.any()):
                break
            q = torch.where(bad[:, None], uniform(lo_q, hi_q), q)
        else:
            if bool((joint7_height(q) < self.limits.min_height).any()):
                raise RuntimeError(
                    f"height rejection did not converge in {max_rounds} rounds"
                )
        return q, uniform(-vmax, vmax)

    # ---------------- task-space helpers ----------------

    def forward_velocities(self, q, qdot):
        return kinematics.forward_velocities(self.model, q, qdot, self._tool)

    def inverse_velocities(self, q, linear_velocity, angular_velocity):
        return kinematics.inverse_velocities(
            self.model, q, linear_velocity, angular_velocity, self._tool
        )
