"""Batched jerk-limited time-optimal trajectory generation (PyTorch).

Counterpart of ``mpc_motion_planner_tpu/ops/otg.py`` (the warm start):
per-joint time-optimal third-order profiles under velocity, acceleration
and jerk limits with nonzero boundary velocities and accelerations,
synchronized across joints, evaluable at any time. Closed forms plus fixed-iteration bisection,
so every batch runs the same static sequence of tensor operations.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .collocation import as_tensor_like


@dataclass(frozen=True)
class JerkLimitedTrajectory:
    """Synchronized multi-joint jerk-limited trajectory; leaves share
    leading batch dims (phase tables are (..., nj, n_phases))."""

    duration: torch.Tensor  # (...,)
    start_position: torch.Tensor  # (..., nj)
    start_velocity: torch.Tensor  # (..., nj)
    start_acceleration: torch.Tensor  # (..., nj)
    phase_dt: torch.Tensor  # (..., nj, n_phases) phase durations (>= 0)
    phase_jerk: torch.Tensor  # (..., nj, n_phases) constant jerk per phase

    def at_time(self, t):
        """(position, velocity, acceleration) at time(s) ``t`` (broadcast
        against the batch shape; clamped to the duration)."""
        t = torch.minimum(
            as_tensor_like(t, self.duration.dtype, self.duration.device), self.duration)
        p, v, a = self.start_position, self.start_velocity, self.start_acceleration
        remaining = t[..., None]
        for k in range(self.phase_dt.shape[-1]):
            dt = torch.minimum(torch.clamp(remaining, min=0.0), self.phase_dt[..., k])
            j = self.phase_jerk[..., k]
            p = p + v * dt + 0.5 * a * dt**2 + j * dt**3 / 6.0
            v = v + a * dt + 0.5 * j * dt**2
            a = a + j * dt
            remaining = remaining - self.phase_dt[..., k]
        return p, v, a


def _ramp(va, vb, amax, jmax):
    """S-ramp va -> vb: (t_jerk, t_const_accel, total_time, distance)."""
    dv = (vb - va).abs()
    trapezoid = dv >= amax**2 / jmax
    tj = torch.where(trapezoid, amax / jmax, torch.sqrt(dv / jmax))
    ta = torch.where(trapezoid, dv / amax - amax / jmax, torch.zeros_like(dv))
    total = 2.0 * tj + ta
    return tj, ta, total, 0.5 * (va + vb) * total


def _ramps_time_dist(v0, vp, vf, amax, jmax):
    *_, t1, d1 = _ramp(v0, vp, amax, jmax)
    *_, t3, d3 = _ramp(vp, vf, amax, jmax)
    return t1 + t3, d1 + d3


def _min_time_cruise_velocity(dp, v0, vf, vmax, amax, jmax, iters):
    """Time-optimal cruise velocity and cruise duration for one joint."""
    t_hi, d_hi = _ramps_time_dist(v0, vmax, vf, amax, jmax)
    t_lo, d_lo = _ramps_time_dist(v0, -vmax, vf, amax, jmax)
    tb_hi = (dp - d_hi) / vmax
    tb_lo = (dp - d_lo) / (-vmax)
    use_hi = tb_hi >= 0.0
    use_lo = (~use_hi) & (tb_lo >= 0.0)

    lo, hi = -vmax * torch.ones_like(dp), vmax * torch.ones_like(dp)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        _, d_mid = _ramps_time_dist(v0, mid, vf, amax, jmax)
        go_up = d_mid < dp
        lo, hi = torch.where(go_up, mid, lo), torch.where(go_up, hi, mid)
    vp_bisect = 0.5 * (lo + hi)

    zero = torch.zeros_like(dp)
    vp = torch.where(use_hi, vmax, torch.where(use_lo, -vmax, vp_bisect))
    tb = torch.where(use_hi, tb_hi, torch.where(use_lo, tb_lo, zero))
    t_ramps, _ = _ramps_time_dist(v0, vp, vf, amax, jmax)
    return vp, tb, t_ramps + tb


def _cruise_velocity_for_duration(dp, v0, vf, vmax, duration, amax, jmax, iters):
    """Re-solve vp so the profile lasts exactly ``duration`` by bisecting
    the clamped fixed-time displacement over [-vmax, vmax]."""

    def d_fixed_time(vp):
        t_ramps, d = _ramps_time_dist(v0, vp, vf, amax, jmax)
        return d + vp * torch.clamp(duration - t_ramps, min=0.0)

    lo, hi = -vmax, vmax
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        go_up = d_fixed_time(mid) < dp
        lo, hi = torch.where(go_up, mid, lo), torch.where(go_up, hi, mid)
    vp = 0.5 * (lo + hi)
    t_ramps, _ = _ramps_time_dist(v0, vp, vf, amax, jmax)
    return vp, torch.clamp(duration - t_ramps, min=0.0)


def _build_phases(v0, vp, vf, tb, amax, jmax):
    """Phase tables (dt, jerk) each (..., 7) for ramp/cruise/ramp."""
    s1 = torch.sign(vp - v0)
    s3 = torch.sign(vf - vp)
    tj1, ta1, _, _ = _ramp(v0, vp, amax, jmax)
    tj3, ta3, _, _ = _ramp(vp, vf, amax, jmax)
    zeros = torch.zeros_like(tb)
    phase_dt = torch.stack([tj1, ta1, tj1, tb, tj3, ta3, tj3], dim=-1)
    phase_jerk = torch.stack(
        [s1 * jmax, zeros, -s1 * jmax, zeros, s3 * jmax, zeros, -s3 * jmax], dim=-1
    )
    return phase_dt, phase_jerk


def plan_trajectory(
    start_position,
    start_velocity,
    target_position,
    target_velocity,
    max_velocity,
    max_acceleration,
    max_jerk,
    bisect_iters: int = 64,
    start_acceleration=None,
    target_acceleration=None,
) -> JerkLimitedTrajectory:
    """Time-optimal synchronized trajectory. State arrays are (..., nj);
    limits broadcast. Boundary accelerations default to zero; given ones
    are met exactly by a prologue jerk phase that takes (v0, a0) to zero
    acceleration and an epilogue, built in reverse time, that takes zero
    acceleration to (vf, af), around the zero-acceleration core. The phase
    tables then hold 9 phases instead of 7."""
    dp = target_position - start_position
    v0, vf = start_velocity, target_velocity
    like_dp = lambda a: torch.broadcast_to(as_tensor_like(a, dp.dtype, dp.device), dp.shape)
    vmax, amax, jmax = like_dp(max_velocity), like_dp(max_acceleration), like_dp(max_jerk)

    with_acc = start_acceleration is not None or target_acceleration is not None
    a0 = torch.zeros_like(dp) if start_acceleration is None else like_dp(start_acceleration)
    af = torch.zeros_like(dp) if target_acceleration is None else like_dp(target_acceleration)

    # prologue: jerk a0 -> 0; epilogue (reverse time): jerk 0 -> af
    t_pre = a0.abs() / jmax
    j_pre = -torch.sign(a0) * jmax
    dv_pre = a0 * t_pre + 0.5 * j_pre * t_pre**2
    dp_pre = v0 * t_pre + 0.5 * a0 * t_pre**2 + j_pre * t_pre**3 / 6.0
    v0i = v0 + dv_pre

    t_post = af.abs() / jmax
    j_post = torch.sign(af) * jmax
    vfi = vf - 0.5 * j_post * t_post**2
    dp_post = vfi * t_post + j_post * t_post**3 / 6.0

    dpi = dp - dp_pre - dp_post

    _, _, t_min = _min_time_cruise_velocity(dpi, v0i, vfi, vmax, amax, jmax, bisect_iters)
    duration = (t_min + t_pre + t_post).amax(dim=-1)
    inner_T = duration[..., None] - t_pre - t_post
    vp, tb = _cruise_velocity_for_duration(
        dpi, v0i, vfi, vmax, inner_T, amax, jmax, bisect_iters
    )
    phase_dt, phase_jerk = _build_phases(v0i, vp, vfi, tb, amax, jmax)
    if with_acc:
        phase_dt = torch.cat([t_pre[..., None], phase_dt, t_post[..., None]], dim=-1)
        phase_jerk = torch.cat([j_pre[..., None], phase_jerk, j_post[..., None]], dim=-1)
    return JerkLimitedTrajectory(
        duration=duration,
        start_position=start_position,
        start_velocity=start_velocity,
        start_acceleration=a0,
        phase_dt=phase_dt,
        phase_jerk=phase_jerk,
    )
