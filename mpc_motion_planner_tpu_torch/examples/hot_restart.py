#!/usr/bin/env python
"""Receding-horizon hot restarts with the PyTorch port.

After a first OTG-seeded solve, each re-plan is seeded from the previous
solution with its end nodes pinned to the new boundary states
(``Solution.reseed_guess``) and with the previous duals, and plans no OTG
trajectory. The target stays where it is (or moves by ``--target-shift``
radians towards the middle of the joint range at every step) while the
start advances along the trajectory, so the previous solution is a
near-exact guess: hot solves converge in fewer QP iterations, with a
shrinking time-to-go.

    python -m mpc_motion_planner_tpu_torch.examples.hot_restart [--steps 6]
        [--batch 64] [--advance 0.1] [--target-shift 0.0] [--device cpu]
        [--float64] [--seed 0]

Prints a per-step table (wall time, QP iterations per SQP step, convergence,
violation, t_f) for the hot-restart chain and, for comparison, for the same
receding chain with a fresh OTG warm start at every step. Runs on the GPU
unless ``--device cpu`` is given.

Re-seeding helps when the target is (nearly) unchanged, as here; across a
new target the old trajectory has the wrong shape and an OTG re-plan is the
better seed, which is why the batch benchmark plans an OTG warm start for
every solve.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .. import config
from ..bench.harness import sample_benchmark_targets
from ..ops.sqp import SQPSettings
from ..planner import Margins, MotionPlanner, Solution

MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)


def make_planner(device, dtype=torch.float32) -> MotionPlanner:
    """The shipping structured configuration on ``device``."""
    qp = config.SHIPPING_QP_SETTINGS
    return MotionPlanner(
        margins=Margins(*MARGINS), dtype=dtype, device=device, qp_settings=qp,
        sqp_settings=SQPSettings(qp_step_schedules=config.shipping_sqp_schedules(qp.backend)),
    )


def hot_solve(planner: MotionPlanner, previous: Solution, current, target) -> Solution:
    """A solve seeded with the previous solution's iterate (end nodes pinned
    to the new boundary states) and duals."""
    return planner.solve(current, target, z0=previous.reseed_guess(current, target),
                         lam_c0=previous.lam_c, lam_x0=previous.lam_x)


def shift_targets(planner: MotionPlanner, target, shift: float):
    """Targets with every joint position moved by ``shift`` radians towards
    the middle of its range (so they stay inside the position bounds)."""
    nq = planner.ocp.nq
    lo, hi = planner.position_bounds()
    q = target[:, :nq]
    moved = q + shift * torch.sign((lo + hi) / 2.0 - q)
    return torch.cat([moved, target[:, nq:]], dim=-1)


def receding_chain(planner: MotionPlanner, current, target, steps: int, fraction: float,
                   hot: bool, target_shift: float = 0.0):
    """Solve, advance the start along the solution, re-plan, ``steps`` times:
    from the previous solution (``hot``) or from a fresh OTG warm start.
    Returns one dict per step: the solution, its wall time in ms and the
    boundary states it was solved for."""
    rows, sol = [], None
    for j in range(steps):
        if j:
            current = sol.x_at(fraction)  # the state that far along each trajectory
            target = shift_targets(planner, target, target_shift) if target_shift else target
        if current.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = hot_solve(planner, sol, current, target) if hot and j else \
            planner.solve(current, target)
        if current.is_cuda:
            torch.cuda.synchronize()
        rows.append({"solution": sol, "wall_ms": 1e3 * (time.perf_counter() - t0),
                     "current": current, "target": target})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--advance", type=float, default=0.1,
                    help="fraction of the remaining horizon to advance per step")
    ap.add_argument("--target-shift", type=float, default=0.0,
                    help="radians every target joint moves per step")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)

    config.full_precision()
    planner = make_planner(a.device, torch.float64 if a.float64 else torch.float32)
    gen = torch.Generator().manual_seed(a.seed)
    q_t, qd_t = sample_benchmark_targets(planner, gen, 2 * a.batch)
    cur = torch.cat([q_t[: a.batch], torch.zeros_like(qd_t[: a.batch])], dim=-1)
    tgt = torch.cat([q_t[a.batch:], qd_t[a.batch:]], dim=-1)

    for hot in (True, False):
        planner.solve(cur, tgt)  # warm-up outside the timed chain
        print(f"\n=== receding chain, {'hot' if hot else 'fresh'} re-seeding ===")
        print(f"{'step':>4} {'wall_ms':>8} {'qp_iters':>12} {'conv':>6} {'viol_p50':>9} "
              f"{'tf_p50':>7}")
        for j, row in enumerate(receding_chain(planner, cur, tgt, a.steps, a.advance, hot,
                                               a.target_shift)):
            sol = row["solution"]
            iters = sol.qp_iterations.double().mean(0)
            print(f"{j:>4} {row['wall_ms']:>8.1f} "
                  f"{'/'.join(str(int(i)) for i in iters):>12} "
                  f"{float(sol.qp_converged.double().mean()):>6.3f} "
                  f"{float(sol.violation.median()):>9.3f} "
                  f"{float(sol.final_time.median()):>7.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
