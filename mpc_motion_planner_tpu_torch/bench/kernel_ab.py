"""Time one hand-written kernel against other builds of it on one GPU, in
turns.

Builds the package's source of kernel 2, 3 or 4 and any number of variants
(another source with the same C entry point, for example the file of an
earlier commit), runs each on the step-0 QPs of the headline states, and
prints one JSON line per variant:

* kernel 2 (``csrc/banded_factor.cu``): its time; whether its ``ok`` flags
  are those of the plain ``factor_banded``; the max-norm relative error of
  ``Ldi``, ``Lsub``, ``u``, ``s`` against it.
* kernel 3 (``csrc/structured_admm.cu``) and kernel 4
  (``csrc/admm_dense.cu``): its time at the full iteration budget and at
  exactly one check window; the drift of one check window from a float64
  run of the plain loop next to the plain float32 loop's (the bar of
  ``chip_smoke.py`` phases 4 and 7); the largest difference of its iterates
  from the package kernel's after one window, and how many iteration counts
  at the full budget differ from the package kernel's.

Times are CUDA events around ``--reps`` calls, the variants in turns (first
to last, then last to first).

    python -m mpc_motion_planner_tpu_torch.bench.kernel_ab --kernel 4 \\
        [--batch 2048] [--reps 3] [name=path.cu ...]

A variant's headers are looked up beside its source. To compare with an
earlier commit:

    git show <commit>:mpc_motion_planner_tpu_torch/csrc/admm_dense.cu > build/variants/old.cu
    git show <commit>:mpc_motion_planner_tpu_torch/csrc/common.cuh > build/variants/common.cuh

Needs one CUDA GPU and ``nvcc``.
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
from ..kernels import admm_dense as k4
from ..kernels import banded_factor as k2
from ..kernels import build
from ..kernels import structured_admm as k3
from ..ocp import make_ocp
from ..ops import qp as dense_qp
from ..ops import qp_structured
from ..ops.sqp import SQPSettings, hessian_regularization_diag, qp_subproblem, soft_weights
from ..planner import Margins, MotionPlanner

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STATES = os.path.join(ROOT, "tests", "fixtures", "headline_states_b2048.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)
MODULES = {2: k2, 3: k3, 4: k4}
# the dense path's configuration on the headline (chip_smoke.py phase 7)
DENSE = dense_qp.QPSettings(
    backend="pallas", kkt_refine=1, rho_update_every=0, kkt_factor="lu", ruiz_iters=2,
    rho=0.1, alpha=1.6, max_iter=700, check_every=25,
)

CHECK_BATCH = 64  # problems of the one-window comparison with float64


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def step0(planner, cur, tgt, dense):
    """The first SQP step's QP data: (P, q, constraint matrix, lc, uc, lx,
    ux) and the soft weights."""
    ocp, B, dev = planner.ocp, cur.shape[0], cur.device
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    _, _, lin, (h, lc, uc, lx, ux) = qp_subproblem(ocp, planner.nlp_bounds(cur, tgt), z0, dense)
    P = hessian_regularization_diag(ocp, B, torch.float32, dev, planner.sqp_settings.reg_eps)
    soft_c, soft_x = soft_weights(ocp, planner.sqp_settings, B, torch.float32, dev)
    return (P, h, lin, lc, uc, lx, ux), dict(soft_c=soft_c, soft_x=soft_x)


def structured_qp(planner, cur, tgt, settings):
    """The scaled structured QP of step 0 and its factors."""
    (P, h, sa, lc, uc, lx, ux), soft = step0(planner, cur, tgt, False)
    qp = qp_structured.scale_qp(planner.ocp, sa, P, h, lc, uc, lx, ux, settings, **soft)
    return sa, qp, k2.factor(qp.Mband, qp.p_col, qp.m_pp, 3)


def dense_chunk_inputs(planner, cur, tgt):
    """Kernel 4's operands and initial state for the dense QP of step 0."""
    args, soft = step0(planner, cur, tgt, True)
    dq = dense_qp.scale_dense_qp(*args, DENSE, **soft)
    rho = torch.full((cur.shape[0],), DENSE.rho, dtype=torch.float32, device=cur.device)
    return dense_qp.pallas_operands(dq, rho, dq.factor(rho, DENSE)), dense_qp.pallas_state(dq)


def run_with(module, kernel, fn, *args, **kw):
    """Call a wrapper of ``module`` through another build of its kernel."""
    saved = module.KERNEL
    module.KERNEL = kernel
    try:
        return fn(*args, **kw)
    finally:
        module.KERNEL = saved


def time_in_turns(kernels, call, reps):
    """ms per call of ``call(kernel)`` for each build, first to last and
    last to first, after one warm-up call each. Returns (times, the warm-up
    calls' outputs)."""
    out = {name: call(k) for name, k in kernels.items()}
    torch.cuda.synchronize()
    times = {name: [] for name in kernels}
    for name in list(kernels) + list(kernels)[::-1]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call(kernels[name])
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) / reps)
    return times, out


def ab_factor(kernels, planner, cur, tgt, reps):
    """Kernel 2 on the step-0 KKT matrices."""
    (P, h, sa, lc, uc, lx, ux), soft = step0(planner, cur, tgt, False)
    qp = qp_structured.scale_qp(planner.ocp, sa, P, h, lc, uc, lx, ux,
                                config.SHIPPING_QP_SETTINGS, **soft)
    data = (qp.Mband, qp.p_col, qp.m_pp)
    plain = qp_structured.factor_banded(*data, 3)
    times, out = time_in_turns(
        kernels, lambda k: run_with(k2, k, k2.factor_banded_kernel, *data), reps)
    results = {}
    for name, fac in out.items():
        results[name] = {
            "ms": float(np.mean(times[name])), "ms_runs": times[name],
            "ok_flags_equal_plain": bool(torch.equal(fac["ok"], plain["ok"])),
            "ok_count": int(fac["ok"].sum()),
            **{f"rel_err_{key}": max_abs(fac[key], plain[key])
               / max(float(plain[key].abs().max()), 1e-30) for key in ("Ldi", "Lsub", "u", "s")},
        }
    return results


def ab_loop(kernels, run, run_plain, run_float64, inputs, budget, window, reps, batch):
    """Kernel 3 or 4: ``run(kernel, inputs, max_iter)`` returns (x, done,
    iterations) of one launch."""
    results = {name: {} for name in kernels}
    small = inputs(min(CHECK_BATCH, batch))
    x64 = run_float64(small, window)
    e_plain = max_abs(run_plain(small, window)[0], x64)
    for name, k in kernels.items():
        x = run(k, small, window)[0]
        torch.cuda.synchronize()
        results[name].update(window_drift_from_float64=max_abs(x, x64),
                             plain_float32_drift=e_plain)
    full = inputs(batch)
    for label, iters in (("budget", budget), ("window", window)):
        times, out = time_in_turns(kernels, lambda k: run(k, full, iters), reps)
        ref = out["package"]
        for name in kernels:
            r = results[name]
            r[f"{label}_ms"] = float(np.mean(times[name]))
            r[f"{label}_ms_runs"] = times[name]
            if label == "window":
                r["window_max_abs_diff_from_package"] = max_abs(out[name][0], ref[0])
            else:
                r["budget_iters_sum"] = int(out[name][2].sum())
                r["budget_converged"] = int((out[name][1] == 1).sum())
                r["budget_iters_differ_from_package"] = int((out[name][2] != ref[2]).sum())
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", type=int, choices=sorted(MODULES), required=True)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("variants", nargs="*", help="name=path.cu")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    config.full_precision()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    module = MODULES[a.kernel]
    kernels = {"package": module.KERNEL}
    for spec in a.variants:
        name, _, path = spec.partition("=")
        kernels[name] = build.CudaKernel(f"{module.KERNEL.name}_{name}", os.path.abspath(path),
                                         module.KERNEL.entry, module.KERNEL.argtypes)
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
    to64 = lambda d: {k: (v.double() if v.is_floating_point() else v) for k, v in d.items()}

    if a.kernel == 2:
        results = ab_factor(kernels, planner, cur, tgt, a.reps)
        shape = {}
    elif a.kernel == 3:
        at = lambda n: dataclasses.replace(shipping, max_iter=n)
        pick = lambda out: (out[0], out[5], out[6])
        ocp64 = make_ocp(planner.model.to(dtype=torch.float64))

        def float64(data, n):
            sa, qp, fac = data
            qp64 = qp_structured.ScaledQP(
                *(getattr(qp, f.name).double() for f in dataclasses.fields(qp)))
            fac64 = {k: v.double() for k, v in fac.items() if k != "ok"}
            return qp_structured.admm_plain(ocp64, sa.to(dtype=torch.float64), qp64, fac64,
                                            at(n))[0]

        results = ab_loop(
            kernels,
            run=lambda k, data, n: pick(run_with(k3, k, k3.admm_kernel, ocp, *data, at(n))),
            run_plain=lambda data, n: pick(qp_structured.admm_plain(ocp, *data, at(n))),
            run_float64=float64,
            inputs=lambda nb: structured_qp(planner, cur[:nb], tgt[:nb], shipping),
            budget=shipping.max_iter, window=shipping.check_every, reps=a.reps, batch=a.batch)
        shape = {"budget": shipping.max_iter, "window": shipping.check_every}
    else:
        ckw = dict(check_every=DENSE.check_every, eps_abs=DENSE.eps_abs, eps_rel=DENSE.eps_rel,
                   sigma=DENSE.sigma, alpha=DENSE.alpha, kkt_refine=DENSE.kkt_refine)

        def pick(out):
            state, used = out
            return state["x"], state["done"], used

        results = ab_loop(
            kernels,
            run=lambda k, data, n: pick(run_with(k4, k, k4.admm_dense_kernel, *data,
                                                 chunk_iters=n, **ckw)),
            run_plain=lambda data, n: pick(k4.admm_dense_plain(*data, chunk_iters=n, **ckw)),
            run_float64=lambda data, n: k4.admm_dense_plain(
                to64(data[0]), to64(data[1]), chunk_iters=n, **ckw)[0]["x"],
            inputs=lambda nb: dense_chunk_inputs(planner, cur[:nb], tgt[:nb]),
            budget=DENSE.max_iter, window=DENSE.check_every, reps=a.reps, batch=a.batch)
        shape = {"budget": DENSE.max_iter, "window": DENSE.check_every}

    for name, r in results.items():
        print(json.dumps({"kernel": a.kernel, "variant": name, "batch": a.batch, **shape, **r}),
              flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
