"""Time kernel 3 against other builds of it on one GPU, in turns.

Builds the package's ``csrc/structured_admm.cu`` and any number of variants
(another source with the same C entry point, for example the file of an
earlier commit), runs each on the step-0 QPs of the headline states, and
prints per variant

* the drift of one check window from a float64 run of the plain loop, next
  to the plain float32 loop's (the bar of ``chip_smoke.py`` phase 4);
* its time at the full iteration budget and at exactly one check window,
  CUDA events, the variants in turns (first to last, last to first);
* the largest difference of its iterates from the package kernel's after
  one check window, and how many iteration counts at the full budget
  differ from the package kernel's.

    python -m mpc_motion_planner_tpu_torch.bench.kernel3_ab \\
        [--batch 2048] [--reps 3] [name=path.cu ...]

A variant's headers are looked up beside its source. Needs one CUDA GPU and
``nvcc``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .. import config
from ..kernels import banded_factor as k2
from ..kernels import build
from ..kernels import structured_admm as k3
from ..ocp import make_ocp
from ..ops import qp_structured
from ..ops.sqp import SQPSettings, hessian_regularization_diag, qp_subproblem, soft_weights
from ..planner import Margins, MotionPlanner

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STATES = os.path.join(ROOT, "tests", "fixtures", "headline_states_b2048.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)


CHECK_BATCH = 64  # problems of the one-window comparison with float64


def variant_kernel(name, source) -> build.CudaKernel:
    """Kernel 3 built from another source file."""
    return build.CudaKernel(f"structured_admm_{name}", os.path.abspath(source),
                            k3.KERNEL.entry, k3.KERNEL.argtypes)


def step0_qp(planner, cur, tgt, settings):
    """The first SQP step's scaled structured QP and its factors."""
    ocp, B, dev = planner.ocp, cur.shape[0], cur.device
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    _, _, sa, (h, lc, uc, lx, ux) = qp_subproblem(ocp, planner.nlp_bounds(cur, tgt), z0, False)
    P = hessian_regularization_diag(ocp, B, torch.float32, dev, planner.sqp_settings.reg_eps)
    soft_c, soft_x = soft_weights(ocp, planner.sqp_settings, B, torch.float32, dev)
    qp = qp_structured.scale_qp(ocp, sa, P, h, lc, uc, lx, ux, settings,
                                soft_c=soft_c, soft_x=soft_x)
    return sa, qp, k2.factor(qp.Mband, qp.p_col, qp.m_pp, 3)


def run_with(kernel, *args):
    """``k3.admm_kernel`` through another build of the kernel."""
    saved = k3.KERNEL
    k3.KERNEL = kernel
    try:
        return k3.admm_kernel(*args)
    finally:
        k3.KERNEL = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("variants", nargs="*", help="name=path.cu")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel3_ab: needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    config.full_precision()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    kernels = {"package": k3.KERNEL}
    for spec in a.variants:
        name, _, path = spec.partition("=")
        kernels[name] = variant_kernel(name, path)
    for name, k in kernels.items():
        k.function()
        info = [ln.strip() for ln in k.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"built {name}: " + " | ".join(info), flush=True)

    shipping = config.SHIPPING_QP_SETTINGS
    planner = MotionPlanner(
        margins=Margins(*MARGINS), dtype=torch.float32, device=dev, qp_settings=shipping,
        sqp_settings=SQPSettings(qp_step_schedules=config.shipping_sqp_schedules(shipping.backend)),
    )
    ocp = planner.ocp
    states = np.load(STATES)
    cur = torch.as_tensor(states["current"][: a.batch], device=dev)
    tgt = torch.as_tensor(states["target"][: a.batch], device=dev)
    window = dataclasses.replace(shipping, max_iter=shipping.check_every)
    results = {name: {} for name in kernels}

    # one check window against float64, on a small batch
    nb = min(CHECK_BATCH, a.batch)
    sa, qp, fac = step0_qp(planner, cur[:nb], tgt[:nb], shipping)
    qp64 = qp_structured.ScaledQP(*(getattr(qp, f.name).double() for f in dataclasses.fields(qp)))
    fac64 = {k: v.double() for k, v in fac.items() if k != "ok"}
    ocp64 = make_ocp(planner.model.to(dtype=torch.float64))
    x64 = qp_structured.admm_plain(ocp64, sa.to(dtype=torch.float64), qp64, fac64, window)[0]
    x_plain = qp_structured.admm_plain(ocp, sa, qp, fac, window)[0]
    e_plain = float((x_plain.double() - x64).abs().max())
    for name, k in kernels.items():
        x = run_with(k, ocp, sa, qp, fac, window)[0]
        torch.cuda.synchronize()
        results[name]["window_drift_from_float64"] = float((x.double() - x64).abs().max())
        results[name]["plain_float32_drift"] = e_plain

    # timing and agreement at the full batch
    sa, qp, fac = step0_qp(planner, cur, tgt, shipping)
    order = list(kernels) + list(kernels)[::-1]
    for label, settings in (("budget", shipping), ("window", window)):
        out = {}
        for name, k in kernels.items():  # warm-up, and the outputs to compare
            out[name] = run_with(k, ocp, sa, qp, fac, settings)
        torch.cuda.synchronize()
        times = {name: [] for name in kernels}
        for name in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(a.reps):
                run_with(kernels[name], ocp, sa, qp, fac, settings)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / a.reps)
        ref = out["package"]
        for name in kernels:
            r = results[name]
            r[f"{label}_ms"] = float(np.mean(times[name]))
            r[f"{label}_ms_runs"] = times[name]
            if label == "window":
                r["window_max_abs_diff_from_package"] = float((out[name][0] - ref[0]).abs().max())
            else:
                r["budget_iters_sum"] = int(out[name][6].sum())
                r["budget_converged"] = int((out[name][5] == 1).sum())
                r["budget_iters_differ_from_package"] = int((out[name][6] != ref[6]).sum())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, r in results.items():
        r["window_us_per_iteration_per_block"] = (
            1e3 * r["window_ms"] / window.max_iter / -(-a.batch // sms))
        print(json.dumps({"variant": name, "batch": a.batch, "budget": shipping.max_iter,
                          "window": window.max_iter, **r}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
