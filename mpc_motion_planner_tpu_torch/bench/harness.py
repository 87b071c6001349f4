"""Benchmark harness (PyTorch): scenario generation, validation and the
record layout.

Counterpart of ``mpc_motion_planner_tpu/bench/harness.py``:

* a receding chain of targets (start_i = target_{i-1}), each a
  rejection-sampled configuration with a task-space-derived joint velocity
  clamped to the task and joint limits. The random draws
  (``torch.Generator``) are kept apart from the deterministic velocity
  mapping, so the mapping can be checked against the JAX package on shared
  draws;
* checks of a sampled trajectory independent of the solver: finite-
  difference jerk against 10x the jerk limit, the tool's linear and angular
  speed limits, and the table (tool height below 0);
* the 162-column benchmark record: min and max of the 28 trajectory rows
  for both planners, final-state errors, pass flags, target state.

Everything is batched over (B, N+1) samples.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.panda import TOOL_FRAME
from ..ops import kinematics
from ..planner import MotionPlanner, Solution

N_CHECK_POINTS = 200  # samples per trajectory past the first


def benchmark_target_velocities(planner: MotionPlanner, q, v_cart):
    """Joint velocities for target configurations q (B, nq) from random
    Cartesian linear velocities v_cart (B, 3): damped pseudo-inverse with
    zero angular velocity, then task-speed clamps (0.9 back-off) and a
    joint-speed clamp (1.1 back-off)."""
    lim = planner.limits
    qd = planner.inverse_velocities(q, v_cart, torch.zeros_like(v_cart))

    task = planner.forward_velocities(q, qd)
    lin = task[:, :3].norm(dim=-1)
    one = torch.ones_like(lin)
    qd = qd * torch.where(
        lin > lim.max_linear_velocity, 0.9 * lim.max_linear_velocity / lin, one
    )[:, None]
    task = planner.forward_velocities(q, qd)
    ang = task[:, 3:].norm(dim=-1)
    qd = qd * torch.where(
        ang > lim.max_angular_velocity, 0.9 * lim.max_angular_velocity / ang, one
    )[:, None]

    vmax = planner.margins.velocity * lim.max_velocity
    ratio = (qd.abs() / vmax).amax(dim=-1)
    return torch.where(ratio[:, None] > 1.0, qd / (1.1 * ratio[:, None]), qd)


def sample_benchmark_targets(planner: MotionPlanner, generator: torch.Generator, num: int):
    """Batched target (position, velocity) sampling."""
    q, _ = planner.sample_random_state(generator, num)
    vlin = planner.limits.max_linear_velocity
    r = torch.rand(num, 3, generator=generator, dtype=planner.dtype, device=generator.device)
    v_cart = (-vlin + 2.0 * vlin * r).to(planner.device)
    return q, benchmark_target_velocities(planner, q, v_cart)


def chain_states(planner: MotionPlanner, generator: torch.Generator, num: int):
    """The benchmark's receding chain: start_i = target_{i-1}; start_0 is
    the mid-range default configuration at rest. Returns (current, target),
    each (num, 2*nq)."""
    q_t, qd_t = sample_benchmark_targets(planner, generator, num)
    lim = planner.limits
    default_q = (lim.max_position + lim.min_position) / 2.0
    q_s = torch.cat([default_q[None, :], q_t[:-1]], dim=0)
    qd_s = torch.cat([torch.zeros_like(qd_t[:1]), qd_t[:-1]], dim=0)
    return torch.cat([q_s, qd_s], dim=-1), torch.cat([q_t, qd_t], dim=-1)


@dataclass(frozen=True)
class TrajectoryChecks:
    """Per-trajectory pass flags (1 = pass), int32 of shape (B,)."""

    jerk: torch.Tensor
    linear_velocity: torch.Tensor
    angular_velocity: torch.Tensor
    collision: torch.Tensor


def validate_trajectory(planner: MotionPlanner, time, q, qd, qdd) -> TrajectoryChecks:
    """Re-simulation checks of (B, N+1, nq) sampled trajectories at (B, N+1)
    times."""
    lim = planner.limits
    dT = (time[:, -1] - time[:, 0]) / (time.shape[1] - 1)
    jerk = (qdd[:, 1:] - qdd[:, :-1]) / torch.clamp(dT, min=1e-9)[:, None, None]
    jerk_ok = (jerk.abs() <= 10.0 * lim.max_jerk).flatten(1).all(-1)

    task = planner.forward_velocities(q, qd)
    lin_ok = (task[..., :3].norm(dim=-1) <= lim.max_linear_velocity).all(-1)
    ang_ok = (task[..., 3:].norm(dim=-1) <= lim.max_angular_velocity).all(-1)

    height = kinematics.frame_height(planner.model, q, planner.model.frame(TOOL_FRAME))
    col_ok = (height >= 0.0).all(-1)  # a tool below z = 0 hits the table

    to_i = lambda b: b.to(torch.int32)
    return TrajectoryChecks(to_i(jerk_ok), to_i(lin_ok), to_i(ang_ok), to_i(col_ok))


def _traj_extrema(time, q, qd, qdd, tau):
    """(min, max) over the samples of the 28 non-time rows (q, qd, qdd,
    tau) of each trajectory: two (B, 28) tensors."""
    rows = torch.cat([q, qd, qdd, tau], dim=-1)
    return rows.amin(dim=1), rows.amax(dim=1)


def benchmark_records(planner: MotionPlanner, solution: Solution, target,
                      n_points: int = N_CHECK_POINTS, warm_start=None):
    """The 162-column benchmark rows and checks of a solved batch:
    ``(records (B, 162), checks_rk, checks_mpc)``. The OTG ("rk") columns
    come from the trajectory that seeded the solve; a hot-restart solution
    carries none, so its caller passes ``warm_start`` explicitly."""
    nq = planner.ocp.nq
    traj = solution.warm_start if warm_start is None else warm_start
    if traj is None:
        raise ValueError(
            "solution has no OTG warm start (hot-restart solve); pass "
            "benchmark_records(..., warm_start=<JerkLimitedTrajectory>) to "
            "choose the baseline trajectory for the RK columns"
        )
    rk = planner.sample_warm_start(traj, n_points)
    mpc = solution.sample(n_points)
    checks_rk = validate_trajectory(planner, *rk[:4])
    checks_mpc = validate_trajectory(planner, *mpc[:4])
    min_rk, max_rk = _traj_extrema(*rk)
    min_mpc, max_mpc = _traj_extrema(*mpc)
    err = lambda s: torch.cat([s[1][:, -1] - target[:, :nq], s[2][:, -1] - target[:, nq:]], -1)
    flags = torch.stack(
        [checks_rk.jerk, checks_rk.linear_velocity, checks_rk.angular_velocity,
         checks_rk.collision, checks_mpc.jerk, checks_mpc.linear_velocity,
         checks_mpc.angular_velocity, checks_mpc.collision],
        dim=-1,
    ).to(min_rk.dtype)
    records = torch.cat(
        [min_rk, max_rk, min_mpc, max_mpc, err(rk), err(mpc), flags, target], dim=-1
    )
    return records, checks_rk, checks_mpc
