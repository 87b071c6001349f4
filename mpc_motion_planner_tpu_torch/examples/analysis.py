#!/usr/bin/env python
"""Analysis report of a trajectory file or a benchmark record file.

Counterpart of the root ``examples/analysis.py`` (the reference's plotly
notebooks data_analysis.ipynb and benchmark_analysis.ipynb), on the text
formats that the port's entry points write:

    # one trajectory (after examples.offline_trajectory):
    python -m mpc_motion_planner_tpu_torch.examples.analysis trajectory
        [--in analysis/optimal_solution.txt] [--outdir analysis]

    # a benchmark (after bench.acceptance), plain or gzipped:
    python -m mpc_motion_planner_tpu_torch.examples.analysis benchmark
        [--in analysis/benchmark_data.txt] [--outdir analysis]

Saves the PNG figures (matplotlib) and prints the violation and accuracy
tables. Numpy on the records; it runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..bench import plots
from ..bench.analysis import accuracy_stats, violation_counts, violation_counts_reference
from ..models.panda import make_panda_limits, make_panda_model
from ..planner import Margins
from ..utils.io import read_benchmark_records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["trajectory", "benchmark"])
    ap.add_argument("--in", dest="path", default=None)
    ap.add_argument("--outdir", default="analysis")
    ap.add_argument("--margins", type=float, nargs=5, default=[0.8, 0.8, 0.6, 0.9, 0.1])
    a = ap.parse_args(argv)
    limits = make_panda_limits()
    margins = Margins(*a.margins)
    os.makedirs(a.outdir, exist_ok=True)

    if a.mode == "trajectory":
        target, rk, mpc = plots.load_optimal_solution(a.path or "analysis/optimal_solution.txt")
        plots.plot_trajectory_grid(target, rk, mpc, limits, margins,
                                   save_path=os.path.join(a.outdir, "trajectory_grid.png"))
        model = make_panda_model()
        plots.plot_ee_path(model, model.frame("panda_tool"), rk, mpc,
                           save_path=os.path.join(a.outdir, "ee_path.png"))
        print(f"saved trajectory_grid.png + ee_path.png to {a.outdir}/")
        return 0

    records = read_benchmark_records(a.path or "analysis/benchmark_data.txt")
    plots.plot_extrema_scatter(records, limits, margins,
                               save_path=os.path.join(a.outdir, "extrema_scatter.png"))
    plots.plot_error_cdf(records, save_path=os.path.join(a.outdir, "error_cdf.png"))
    print(f"saved extrema_scatter.png + error_cdf.png to {a.outdir}/")
    print("\nviolation counts (strict, margin-scaled boxes):")
    print(json.dumps(violation_counts(records, limits, margins), indent=2))
    print("\nviolation counts (reference notebook cell-3 convention, full limits):")
    print(json.dumps(violation_counts_reference(records, limits), indent=2))
    print("\naccuracy:")
    print(json.dumps(accuracy_stats(records), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
