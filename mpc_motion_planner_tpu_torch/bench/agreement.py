"""Iteration counts at the full budget against the plain float64 loop's: the
readings behind the float64 fallback of ``chip_smoke.py``
``iteration_agreement``, with a fault beside them.

On the step-0 QPs of the first ``--batch`` headline states at a
transcription (``--segments`` of ``--order``, as ``kernel_ab.py`` sets it,
with the shipping QP settings of its node count and ``--kkt-refine``
refinement steps where given), one dispatch at the full budget each of the
plain loop at float64 and at float32, kernel 3, and kernel 3 with one
refinement step fewer than the others (the fault: a kernel that drops its
refinement step; needs ``--kkt-refine`` 1 or more). For each float32 run it
prints one JSON line: the problems it and the float64 loop both converged,
how many of those are more than 25 iterations off float64's, the median gap,
and that count over the plain float32 loop's. The fallback holds a kernel to
no more than twice the plain float32 loop's count, so a sound kernel must
read at most 2 and the fault should read more.

    python -m mpc_motion_planner_tpu_torch.bench.agreement [--segments 12] \\
        [--order 3] [--batch 2048] [--kkt-refine 1]

Needs one CUDA GPU and ``nvcc``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

from .. import config
from ..kernels import structured_admm as k3
from ..ocp import make_ocp
from ..ops import qp_structured
from ..ops.sqp import SQPSettings
from ..planner import Margins, MotionPlanner
from .kernel_ab import MARGINS, STATES, structured_qp


def off_float64(got, ref64):
    """(problems both converged, of them more than 25 iterations off, the
    median gap)."""
    both = got.converged & ref64.converged
    gaps = (got.iterations - ref64.iterations).abs()[both]
    if not both.any():
        return 0, 0, 0
    return int(both.sum()), int((gaps > 25).sum()), int(gaps.median())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--segments", type=int, default=12)
    ap.add_argument("--order", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--kkt-refine", type=int,
                    help="refinement steps of the plain loops and kernel 3 (default: the "
                         "shipping settings' at this node count)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("agreement: needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    config.full_precision()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    planner = MotionPlanner(
        margins=Margins(*MARGINS), dtype=torch.float32, device=dev,
        sqp_settings=SQPSettings(qp_step_schedules=config.SHIPPING_SQP_SCHEDULES))
    planner.ocp = make_ocp(planner.model, planner.tool_frame, order=a.order,
                           num_segments=a.segments)
    ocp = planner.ocp
    settings = config.shipping_qp_settings(ocp.num_nodes)
    if a.kkt_refine is not None:
        settings = dataclasses.replace(settings, kkt_refine=a.kkt_refine)
    states = np.load(STATES)
    cur = torch.as_tensor(states["current"][: a.batch], device=dev)
    tgt = torch.as_tensor(states["target"][: a.batch], device=dev)
    sa, qp, fac = structured_qp(planner, cur, tgt, settings)

    ocp64 = make_ocp(planner.model.to(dtype=torch.float64), planner.tool_frame,
                     order=a.order, num_segments=a.segments)
    qp64 = qp_structured.ScaledQP(*(getattr(qp, f.name).double() for f in dataclasses.fields(qp)))
    fac64 = {k: v.double() for k, v in fac.items() if k != "ok"}
    unscale = lambda q, out: qp_structured.unscale_solution(q, *out)
    ref64 = unscale(qp64, qp_structured.admm_plain(ocp64, sa.to(dtype=torch.float64), qp64,
                                                   fac64, settings))
    runs = {"plain_float32": unscale(qp, qp_structured.admm_plain(ocp, sa, qp, fac, settings)),
            "kernel": unscale(qp, k3.admm_kernel(ocp, sa, qp, fac, settings))}
    if settings.kkt_refine > 0:
        dropped = dataclasses.replace(settings, kkt_refine=settings.kkt_refine - 1)
        runs["kernel_refinement_dropped"] = unscale(qp, k3.admm_kernel(ocp, sa, qp, fac, dropped))
    torch.cuda.synchronize()
    _, p_off, _ = off_float64(runs["plain_float32"], ref64)
    for name, got in runs.items():
        both, off, med = off_float64(got, ref64)
        print(json.dumps({
            "run": name, "nodes": ocp.num_nodes, "order": ocp.coll.order, "batch": a.batch,
            "kkt_refine": settings.kkt_refine, "budget": settings.max_iter,
            "converged": int(got.converged.sum()), "float64_converged": int(ref64.converged.sum()),
            "both_converged": both, "off_by_more_than_25": off, "median_gap": med,
            "off_over_plain_float32": off / p_off if p_off else None}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
