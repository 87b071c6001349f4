"""1000-trajectory acceptance benchmark of the PyTorch port.

Counterpart of ``mpc_motion_planner_tpu/bench/acceptance.py``: a receding
chain of benchmark states solved in batches, the 162-column records
written (appended) to ``--out``, and the analysis tables printed: per-batch
throughput and convergence, the soft-box dual check, violation counts in
the strict and in the notebook's convention, violation magnitudes and
accuracy.

    python -m mpc_motion_planner_tpu_torch.bench.acceptance [--n 1000]
        [--batch 250] [--device cpu] [--x64] [--seed 0]
        [--states-from analysis/benchmark_data_r05.txt.gz]
        [--out analysis/benchmark_data.txt]

The states are drawn with the port's ``chain_states`` from a
``torch.Generator`` seeded with ``--seed``, or, with ``--states-from``,
taken from an existing record file: its targets (columns 148:162) and the
chain they imply (the mid-range configuration at rest, then each previous
target). Runs on the GPU unless ``--device cpu`` is given; float32 unless
``--x64``. On the card every batch is a replay of the captured solve
(``utils/capture.py``), as the JAX acceptance jits its batch once: one
capture per batch shape, made before the first batch and not timed (a last
batch of another size is captured when it comes, and timed).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import config
from ..ops.qp import QPSettings
from ..ops.sqp import SQPSettings
from ..planner import Margins, MotionPlanner
from ..utils.capture import capture_solve
from ..utils.io import read_benchmark_records, write_benchmark_records
from .analysis import (TARGET, accuracy_stats, violation_counts, violation_counts_reference,
                       violation_magnitudes)
from .harness import benchmark_records, chain_states


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=250)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--x64", action="store_true", help="solve in float64")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="analysis/benchmark_data.txt")
    ap.add_argument("--states-from", default=None,
                    help="record file whose targets (and their chain) are solved")
    ap.add_argument("--margins", type=float, nargs=5, default=[0.8, 0.8, 0.6, 0.9, 0.1],
                    help="position velocity acceleration torque jerk")
    ap.add_argument("--qp-backend", default="auto",
                    choices=["auto", "structured", "structured_pallas", "xla", "pallas"],
                    help="auto: the shipping structured backend")
    ap.add_argument("--kkt-refine", type=int, default=None,
                    help="default: 0 for the structured backends, 1 for the dense ones")
    ap.add_argument("--qp-max-iter", type=int, default=None, help="default 700")
    ap.add_argument("--exit-every", type=int, default=None,
                    help="the JAX package's dispatch split; recorded, no effect on results")
    ap.add_argument("--exit-warmup", type=int, default=None, help="as --exit-every")
    ap.add_argument("--exit-schedule", default=None, help="as --exit-every")
    ap.add_argument("--sqp-schedules", default=None,
                    help="per-SQP-step ADMM budgets, e.g. '200,500;150,350'; auto = the "
                         "shipping schedule of the backend, '' = --qp-max-iter for every "
                         "step. Default: auto, or '' when a budget is given explicitly")
    ap.add_argument("--rescue-iters", type=int, default=None,
                    help="extra ADMM budget for unconverged problems")
    return ap.parse_args(argv)


def make_planner(a, device, dtype) -> MotionPlanner:
    backend = (config.shipping_backend(device.type) if a.qp_backend == "auto"
               else a.qp_backend)
    refine = a.kkt_refine
    if refine is None:
        refine = 0 if backend in ("structured", "structured_pallas") else 1
    qp_kw = dict(backend=backend, kkt_refine=refine, rho_update_every=0,
                 max_iter=700 if a.qp_max_iter is None else a.qp_max_iter)
    if a.rescue_iters is not None:
        qp_kw["rescue_iters"] = a.rescue_iters
    schedules = a.sqp_schedules
    if schedules is None:
        explicit = a.qp_max_iter is not None or any(
            v is not None for v in (a.exit_every, a.exit_warmup, a.exit_schedule))
        schedules = "" if explicit else "auto"
    if schedules == "auto":
        schedules = config.shipping_sqp_schedules(backend)
    return MotionPlanner(margins=Margins(*a.margins), qp_settings=QPSettings(**qp_kw),
                         sqp_settings=SQPSettings(qp_step_schedules=schedules),
                         dtype=dtype, device=device)


def states_from_records(planner: MotionPlanner, path: str, n: int):
    """(current, target) of the first ``n`` rows of a record file: the
    targets it holds and the chain they imply."""
    target = torch.as_tensor(read_benchmark_records(path)[:n, TARGET],
                             dtype=planner.dtype, device=planner.device)
    lim = planner.limits
    start = torch.cat([(lim.max_position + lim.min_position) / 2.0,
                       torch.zeros_like(lim.max_position)])
    return torch.cat([start[None], target[:-1]], dim=0), target


def soft_box_mask(planner: MotionPlanner) -> torch.Tensor:
    """Variables under the l1-elastic box: interior state nodes and every
    control."""
    ocp = planner.ocp
    nodes, nx, nu = ocp.num_nodes, ocp.nx, ocp.nu
    mask = torch.zeros(ocp.num_var, dtype=torch.bool, device=planner.device)
    mask[nx:(nodes - 1) * nx] = True
    mask[nodes * nx:nodes * (nx + nu)] = True
    return mask


def main(argv=None) -> int:
    a = parse_args(argv)
    config.full_precision()
    device = torch.device(a.device)
    planner = make_planner(a, device, torch.float64 if a.x64 else torch.float32)
    if a.states_from:
        current, target = states_from_records(planner, a.states_from, a.n)
    else:
        current, target = chain_states(planner, torch.Generator().manual_seed(a.seed), a.n)
    n = current.shape[0]
    soft = soft_box_mask(planner)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    solve = capture_solve(planner, current[:a.batch], target[:a.batch])
    if solve.captured:
        print(f"capture: {time.perf_counter() - t0:.3f}s for batches of "
              f"{min(a.batch, n)}", flush=True)
    all_records, soft_duals, convs = [], [], []
    t_total = 0.0
    for i in range(0, n, a.batch):
        cur_b, tgt_b = current[i:i + a.batch], target[i:i + a.batch]
        sync()
        t0 = time.perf_counter()
        sol = solve(cur_b, tgt_b)
        rec, _, _ = benchmark_records(planner, sol, tgt_b)
        sdual = (sol.lam_x.abs() * soft).amax(-1)
        sync()
        dt = time.perf_counter() - t0
        t_total += dt
        all_records.append(rec.double().cpu().numpy())
        soft_duals.append(sdual.double().cpu().numpy())
        conv = sol.qp_converged.double().cpu().numpy()
        convs.append(conv)
        print(f"batch {i // a.batch}: {cur_b.shape[0]} solves in {dt:.3f}s "
              f"({cur_b.shape[0] / dt:.1f} solves/s), median violation "
              f"{float(sol.violation.median()):.2e}, qp conv {conv.mean():.3f}", flush=True)

    records = np.concatenate(all_records, axis=0)
    write_benchmark_records(a.out, records)

    print(f"\ntotal: {n} solves in {t_total:.2f}s = {n / t_total:.1f} solves/s")
    sdual = np.concatenate(soft_duals)
    conv = np.concatenate(convs)
    w = planner.sqp_settings.box_slack_penalty
    print(json.dumps({
        "qp_conv_rate": float(conv.mean()),
        # the elastic box leaves feasible solves unchanged while the box
        # duals stay below its weight; saturation near 1 means it binds
        "soft_box_dual_p50": float(np.percentile(sdual, 50)),
        "soft_box_dual_max": float(sdual.max()),
        "box_slack_penalty": w,
        "soft_box_dual_saturation": float(sdual.max() / w) if w else None,
    }, indent=2))
    print(f"\nviolation counts, STRICT convention (margin-scaled boxes), of {n} trajectories:")
    print(json.dumps(violation_counts(records, planner.limits, planner.margins), indent=2))
    print("\nviolation counts, REFERENCE convention (full limits, the benchmark notebook's "
          "cell 3):")
    print(json.dumps(violation_counts_reference(records, planner.limits), indent=2))
    print("\nviolation magnitudes (worst overshoot per trajectory):")
    print(json.dumps(violation_magnitudes(records, planner.limits, planner.margins), indent=2))
    print("\naccuracy:")
    print(json.dumps(accuracy_stats(records), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
