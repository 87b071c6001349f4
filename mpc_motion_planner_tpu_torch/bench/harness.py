"""Benchmark scenario generation (PyTorch).

Counterpart of ``sample_benchmark_targets`` and ``chain_states`` in
``mpc_motion_planner_tpu/bench/harness.py``: a receding chain of targets
(start_i = target_{i-1}), each a rejection-sampled configuration with a
task-space-derived joint velocity clamped to the task and joint limits.
The random draws (``torch.Generator``) are kept apart from the
deterministic velocity mapping, so the mapping can be checked against the
JAX package on shared draws.
"""

from __future__ import annotations

import torch

from ..planner import MotionPlanner


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
