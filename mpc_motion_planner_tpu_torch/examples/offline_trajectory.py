#!/usr/bin/env python
"""One random trajectory, written in the 29-column trajectory format.

Counterpart of the root ``examples/offline_trajectory.py``: a random
feasible start and goal at margins 0.9/0.9/0.5/0.9/0.1 (the goal's joint
velocity scaled down until the tool's linear and angular speeds are within
their limits), one minimum-time solve with the jerk-limited warm start,
and the file: one target line, 201 rows of the warm-start trajectory and
201 rows of the MPC trajectory (time, q x7, qd x7, qdd x7, tau x7). The
solve runs the shipping structured configuration, whose hot loops are the
port's kernels on a GPU.

    python -m mpc_motion_planner_tpu_torch.examples.offline_trajectory
        [--seed 0] [--device cpu] [--x64] [--out analysis/optimal_solution.txt]

Runs on the GPU unless ``--device cpu`` is given; float32 unless ``--x64``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import config
from ..ops.sqp import SQPSettings
from ..planner import Margins, MotionPlanner
from ..utils.io import write_optimal_solution

MARGINS = (0.9, 0.9, 0.5, 0.9, 0.1)
N_POINTS = 200


def make_planner(device, dtype) -> MotionPlanner:
    qp = config.SHIPPING_QP_SETTINGS
    return MotionPlanner(
        margins=Margins(*MARGINS), dtype=dtype, device=device, qp_settings=qp,
        sqp_settings=SQPSettings(qp_step_schedules=config.shipping_sqp_schedules(qp.backend)),
    )


def clamp_task_velocity(planner: MotionPlanner, q, v):
    """Scale v (1, nq) by 0.9 x limit / speed where the tool's linear, then
    angular speed exceeds its limit."""
    lim = planner.limits
    for rows, vmax, what in ((slice(0, 3), lim.max_linear_velocity, "Linear"),
                             (slice(3, 6), lim.max_angular_velocity, "Angular")):
        speed = float(planner.forward_velocities(q, v)[0, rows].norm())
        if speed > vmax:
            v = v * 0.9 * vmax / speed
            print(f"{what} Vel: {speed} corrected")
    return v


def check_solution_file(path):
    """(velocity consistency, final position error) of a trajectory file's
    MPC rows: the largest gap between the velocities and the trapezoidal
    integral of the accelerations, and the largest gap between the last
    position and the target."""
    d = np.loadtxt(path)
    tgt, mpc = d[0], d[2 + N_POINTS:]
    t, q, v, a = mpc[:, 0], mpc[:, 1:8], mpc[:, 8:15], mpc[:, 15:22]
    dt = np.diff(t)[:, None]
    v_int = v[0] + np.cumsum(0.5 * (a[1:] + a[:-1]) * dt, axis=0)
    return float(np.abs(v_int - v[1:]).max()), float(np.abs(q[-1] - tgt[1:8]).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--x64", action="store_true", help="solve in float64")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="analysis/optimal_solution.txt")
    a = ap.parse_args(argv)

    config.full_precision()
    planner = make_planner(torch.device(a.device), torch.float64 if a.x64 else torch.float32)
    gen = torch.Generator().manual_seed(a.seed)
    q0, v0 = planner.sample_random_state(gen, 1)
    q1, v1 = planner.sample_random_state(gen, 1)
    v1 = clamp_task_velocity(planner, q1, v1)
    if bool(planner.check_state_in_bounds(q0, v0).any()) or bool(
            planner.check_state_in_bounds(q1, v1).any()):
        raise RuntimeError("Initial or final state outside bounds")

    current, target = torch.cat([q0, v0], -1), torch.cat([q1, v1], -1)
    print("Target:")
    print(q1[0].cpu().numpy())
    print(v1[0].cpu().numpy())

    sol = planner.solve(current, target)
    print("final time:", float(sol.final_time[0]), "s  (warm start:",
          float(sol.warm_start.duration[0]), "s)")
    print("constraint violation:", float(sol.violation[0]))

    unbatch = lambda tup: tuple(x[0] for x in tup)
    write_optimal_solution(a.out, target[0],
                           unbatch(planner.sample_warm_start(sol.warm_start, N_POINTS)),
                           unbatch(sol.sample(N_POINTS)))
    print("wrote", a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
