#!/usr/bin/env python
"""Serial single-problem CPU baseline proxy for ``vs_baseline``.

Counterpart of the root ``examples/baseline_proxy.py``. The C++ reference
publishes no performance numbers and cannot be built here (BASELINE.md). As
the closest measurable stand-in, this runs the headline's workload (chained
benchmark states, jerk-limited warm start, 2 SQP steps of at most 700
boxADMM iterations at eps 1e-3, the dense "xla" QP) as serial batch-1
solves in one CPU process at float64, like the reference's double, and
reports solves/s and the latency per solve. It measures the same
algorithmic budget per solve, not the reference itself: a proxy.

    python -m mpc_motion_planner_tpu_torch.examples.baseline_proxy [--n 32]
        [--device cpu]

The CPU is what the proxy measures, so ``--device`` defaults to it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..bench.harness import chain_states
from ..ops.qp import QPSettings
from ..planner import Margins, MotionPlanner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32, help="number of serial solves")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    a = ap.parse_args(argv)
    device = torch.device(a.device)
    planner = MotionPlanner(margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
                            qp_settings=QPSettings(backend="xla"), dtype=torch.float64,
                            device=device)
    current, target = chain_states(planner, torch.Generator().manual_seed(0), a.n)

    def solve(i):
        sol = planner.solve(current[i:i + 1], target[i:i + 1])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return sol

    solve(0)  # the first solve pays for one-time set-up
    times = []
    for i in range(a.n):
        t0 = time.perf_counter()
        solve(i)
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    print(json.dumps({
        "metric": "serial_cpu_solves_per_s",
        "value": round(float(a.n / times.sum()), 3),
        "unit": "solves/s",
        "n": a.n,
        "p50_latency_ms": round(float(np.median(times) * 1e3), 3),
        "p95_latency_ms": round(float(np.percentile(times, 95) * 1e3), 3),
        "dtype": "float64",
        "device": str(device) if device.type == "cpu" else torch.cuda.get_device_name(device),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
