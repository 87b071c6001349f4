"""Planner facade: the PyTorch ``MotionPlanner``.

Counterpart of ``mpc_motion_planner_tpu/planner.py``: margins, margin-scaled
bounds, the jerk-limited warm start, the batched SQP solve, hot restarts
from a previous solution, trajectory sampling and point queries, the
feasibility flag and the tool-pose inverse kinematics. Every solve is
batched: states carry a leading batch axis and one ``solve`` plans B
trajectories on the planner's device. Where the JAX method takes a PRNG key,
this one takes a ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .models.panda import TOOL_FRAME, PandaLimits, make_panda_limits, make_panda_model
from .models.robot import RobotModel
from .ocp import NLPBounds, TranscribedOCP, assemble_bounds, make_ocp
from .ops import kinematics, rnea
from .ops.collocation import interpolate, interpolate_each
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

    def reseed_guess(self, current_state, target_state):
        """Warm-start vector for a hot restart: the solution with its first
        and last node pinned to the (new) boundary states."""
        nx = self.ocp.nx
        n0 = (self.ocp.num_nodes - 1) * nx
        z = self.z.clone()
        z[..., :nx] = current_state
        z[..., n0 : n0 + nx] = target_state
        return z


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
        self.tool_frame = tool_frame
        self.margins = margins
        self.sqp_settings = sqp_settings
        self.qp_settings = qp_settings
        self.target_eps = target_eps
        self.time_bounds = time_bounds
        self._tool = self.model.frame(tool_frame)
        self._min_height: Optional[float] = None  # None -> limits.min_height

    # ---------------- margin-scaled limits ----------------

    def set_constraint_margins(self, position, velocity, acceleration, torque, jerk):
        self.margins = Margins(position, velocity, acceleration, torque, jerk)

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

    def ineq_bounds(self, min_height: Optional[float] = None):
        """Torque box + tool height floor: ``min_height``, else the floor set
        by :meth:`set_min_height`, else the limits' own."""
        if min_height is None:
            min_height = self._min_height
        t = self.margins.torque * self.limits.max_torque
        fill = lambda v: torch.full((1,), float(v), dtype=t.dtype, device=t.device)
        h = fill(self.limits.min_height if min_height is None else min_height)
        return torch.cat([-t, h]), torch.cat([t, fill(float("inf"))])

    def set_min_height(self, min_height: float):
        """Persistently override the end-effector height floor."""
        self._min_height = min_height

    def nlp_bounds(self, current_state, target_state, min_height=None) -> NLPBounds:
        s_lo, s_hi = self.state_bounds()
        c_lo, c_hi = self.control_bounds()
        g_lo, g_hi = self.ineq_bounds(min_height)
        return assemble_bounds(
            self.ocp, current_state, target_state, s_lo, s_hi, c_lo, c_hi,
            self.time_bounds[0], self.time_bounds[1], g_lo, g_hi, self.target_eps,
        )

    # ---------------- warm start ----------------

    def plan_warm_start(self, current_state, target_state, current_acceleration=None,
                        target_acceleration=None) -> JerkLimitedTrajectory:
        """Jerk-limited time-optimal trajectory between the boundary states.
        Boundary accelerations (..., nq) default to zero and are met
        exactly when given."""
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
            start_acceleration=current_acceleration,
            target_acceleration=target_acceleration,
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

    def warm_start_from_trajectory(self, final_time, position, velocity, acceleration):
        """Warm-start vector from any regularly-time-spaced trajectory: the
        sample nearest to each collocation node, packed with p0 = final_time.
        position/velocity/acceleration (B, n_points, nq), final_time (B,)."""
        n_points = position.shape[-2]
        idx = torch.round(self.ocp.coll.time_nodes * (n_points - 1)).long()
        X = torch.cat([position[:, idx], velocity[:, idx]], dim=-1)
        final_time = torch.as_tensor(final_time, dtype=position.dtype, device=position.device)
        return self.ocp.pack(X, acceleration[:, idx], final_time.expand(position.shape[0]))

    def warm_start_point(self, traj: JerkLimitedTrajectory, t):
        """Warm-start trajectory state at time t (seconds), with torque:
        (q, qdot, qddot, tau)."""
        q, v, a = traj.at_time(t)
        return q, v, a, rnea.rnea(self.model, q, v, a)

    def sample_warm_start(self, traj: JerkLimitedTrajectory, n_points: int):
        """The OTG trajectory at n_points+1 uniform times with torques:
        (time (B, N+1), q, qdot, qddot, tau each (B, N+1, nq))."""
        frac = torch.linspace(0.0, 1.0, n_points + 1, dtype=traj.duration.dtype,
                              device=traj.duration.device)
        ts = frac[None, :] * traj.duration[:, None]
        tr = JerkLimitedTrajectory(*(a[None] for a in (
            traj.duration, traj.start_position, traj.start_velocity,
            traj.start_acceleration, traj.phase_dt, traj.phase_jerk,
        )))
        q, v, a = (x.transpose(0, 1) for x in tr.at_time(ts.T))
        return ts, q, v, a, rnea.rnea(self.model, q, v, a)

    def solution_point(self, solution: Solution, t):
        """MPC trajectory state at time t (seconds, a scalar or (B,)), with
        torque: (q, qdot, qddot, tau). t is de-normalized by the solved
        final time and clamped."""
        tf = solution.final_time
        t_norm = torch.clamp(
            torch.as_tensor(t, dtype=tf.dtype, device=tf.device) / torch.clamp(tf, min=1e-9),
            0.0, 1.0,
        )
        nq = self.ocp.nq
        X, U, _ = solution.states()
        x = interpolate_each(self.ocp.coll, X, t_norm)
        u = interpolate_each(self.ocp.coll, U, t_norm)
        q, v = x[..., :nq], x[..., nq:]
        return q, v, u, rnea.rnea(self.model, q, v, u)

    # ---------------- solve ----------------

    def solve(self, current_state, target_state, z0=None, min_height=None, lam_c0=None,
              lam_x0=None) -> Solution:
        """Batched minimum-time solve; current/target_state (B, 2*nq). With
        z0 None an OTG warm start is planned and used. With z0 given (a hot
        restart, typically ``Solution.reseed_guess`` of the previous solve)
        no OTG trajectory is planned and ``Solution.warm_start`` is None;
        lam_c0/lam_x0 seed the SQP's dual estimates, which a chain of hot
        restarts carries over from the previous solution."""
        if z0 is None:
            traj = self.plan_warm_start(current_state, target_state)
            z0 = self.warm_start_vector(traj)
        else:
            traj = None
        bounds = self.nlp_bounds(current_state, target_state, min_height)
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

    # ---------------- sampling and checks ----------------

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

    def check_state_in_bounds(self, position, velocity, acceleration=None):
        """Feasibility flag (int32, batch shape), the reference's encoding:
        0 ok, 1 position, 2 velocity, 3 both, +10 acceleration."""
        lo_q, hi_q = self.position_bounds()
        vmax = self.margins.velocity * self.limits.max_velocity
        amax = self.margins.acceleration * self.limits.max_acceleration
        pos_bad = ((position > hi_q) | (position < lo_q)).any(dim=-1)
        vel_bad = (velocity.abs() > vmax).any(dim=-1)
        flag = pos_bad.to(torch.int32) + 2 * vel_bad.to(torch.int32)
        if acceleration is not None:
            flag = flag + 10 * (acceleration.abs() > amax).any(dim=-1).to(torch.int32)
        return flag

    # ---------------- task-space helpers ----------------

    def forward_velocities(self, q, qdot):
        return kinematics.forward_velocities(self.model, q, qdot, self._tool)

    def inverse_velocities(self, q, linear_velocity, angular_velocity):
        return kinematics.inverse_velocities(
            self.model, q, linear_velocity, angular_velocity, self._tool
        )

    def inverse_kinematics(self, rotation, translation, q0=None,
                           generator: Optional[torch.Generator] = None, **kw):
        """Damped least-squares IK to a tool pose, rotation (..., 3, 3) and
        translation (..., 3); returns ``(q, converged)``. The start
        configuration defaults to a random one within the position limits,
        drawn from ``generator`` (seed 0 if none is given)."""
        if q0 is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            lo, hi = self.limits.min_position, self.limits.max_position
            r = torch.rand(*translation.shape[:-1], self.ocp.nq, generator=generator,
                           dtype=self.dtype, device=generator.device)
            q0 = lo + (hi - lo) * r.to(self.device)
        return kinematics.inverse_kinematics(
            self.model, q0, rotation, translation, self._tool, **kw
        )
