#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``mpc_motion_planner_tpu_torch``).

Builds the three hand-written CUDA kernels from ``csrc/``, holds each against
its plain PyTorch version on the card, drives ``MotionPlanner.solve`` on the
headline workload (B=2048 chained benchmark states, 7-DoF Panda, 19 nodes,
400 variables, 488 constraint rows) through the kernels, checks the result
against the JAX reference fixture, and times each kernel against its plain
version. Needs one CUDA GPU and ``nvcc``; imports no JAX.

    python3 chip_smoke.py

Prints one line per phase, then a JSON line of per-kernel results, the
card's name and power limit, and finally
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises, and the script exits non-zero without that line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_slice_b64.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)
B_MAIN = 2048  # the headline batch
B_FACTOR = 256  # kernel-2 comparison batch
B_ADMM = 64  # kernel-3 comparison batch
REPLACES = {
    "constraints": "mpc_motion_planner_tpu/ops/pallas/constraints_kernel.py:345",
    "banded_factor": "mpc_motion_planner_tpu/ops/pallas/banded_factor.py:262",
    "structured_admm": "mpc_motion_planner_tpu/ops/pallas/structured_admm.py:830",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def rel_err(a, b) -> float:
    """max |a - b| / max |b| (factor entries span many magnitudes)."""
    return max_abs(a, b) / max(float(b.double().abs().max()), 1e-30)


def time_pair(plain, kernel, reps=3):
    """Mean ms per call of plain and kernel, timed with CUDA events in the
    order plain, kernel, kernel, plain after one warm-up call each."""
    plain()
    kernel()
    torch.cuda.synchronize()
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = plain if name == "plain" else kernel
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) / reps)
    return float(np.mean(times["plain"])), float(np.mean(times["kernel"])), times


def run(dev: torch.device) -> None:
    """All phases on ``dev``; raises on the first failed check."""
    from mpc_motion_planner_tpu_torch import config, kernels
    from mpc_motion_planner_tpu_torch.bench.harness import chain_states
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels import constraints as k1
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.ocp import make_ocp
    from mpc_motion_planner_tpu_torch.ops import qp_structured
    from mpc_motion_planner_tpu_torch.ops.sqp import (
        hessian_regularization_diag, qp_subproblem, soft_weights,
    )
    from mpc_motion_planner_tpu_torch.ops.structure import apply_A
    from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner

    f32 = torch.float32
    results = {name: {"name": name, "route": "cuda",
                      "source": f"mpc_motion_planner_tpu_torch/csrc/{k.source}",
                      "replaces": REPLACES[name]}
               for name, k in kernels.KERNELS.items()}

    # ---- phase 0: device and precision ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    flags = config.full_precision()
    log(f"phase 0 device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | precision {flags}")

    # ---- phase 1: build ----
    for name, k in kernels.KERNELS.items():
        t0 = time.perf_counter()
        path = k.build()
        dt = time.perf_counter() - t0
        info = [ln.strip() for ln in k.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"phase 1 build: {name} in {dt:.1f} s -> {os.path.relpath(path, ROOT)} | "
            + " | ".join(info))

    planner = MotionPlanner(margins=Margins(*MARGINS), dtype=f32, device=dev)
    ocp = planner.ocp
    ocp64 = make_ocp(planner.model.to(dtype=torch.float64))

    # ---- phase 2: kernel 1 against its plain version ----
    gen = torch.Generator().manual_seed(1)

    def rand_xu(B, nodes):
        lo = torch.tensor([-2.5] * 7 + [-2.0] * 7 + [-10.0] * 7)
        r = torch.rand(B, nodes, 21, generator=gen)
        xu = (lo + 2 * (-lo) * r).to(dev, f32)
        return xu[..., :14].contiguous(), xu[..., 14:].contiguous()

    err1 = 0.0
    for B, nodes in ((B_MAIN, 19), (61, 19), (1237, 1)):
        X, U = rand_xu(B, nodes)
        g_k, J_k = k1.node_constraints_kernel(ocp, X, U, with_jac=True)
        gv_k = k1.node_constraints_kernel(ocp, X, U, with_jac=False)
        g_p, J_p = k1.node_constraints_plain(ocp, X, U, with_jac=True)
        torch.cuda.synchronize()
        for got in (g_k, gv_k):
            check(torch.allclose(got, g_p, rtol=2e-5, atol=2e-5),
                  f"kernel 1 values differ at F={B * nodes}: {max_abs(got, g_p)}")
        check(torch.allclose(J_k, J_p, rtol=2e-4, atol=5e-5),
              f"kernel 1 Jacobian differs at F={B * nodes}: {max_abs(J_k, J_p)}")
        e = max(max_abs(g_k, g_p), max_abs(gv_k, g_p), max_abs(J_k, J_p))
        err1 = max(err1, e)
        log(f"phase 2 kernel 1 F={B * nodes}: values/Jacobian match the plain path "
            f"(max abs err {e:.3e}; tol values 2e-5/2e-5, Jacobian rtol 2e-4 atol 5e-5)")
    results["constraints"]["max_abs_err"] = err1

    # ---- shared: the step-0 QPs of chained benchmark states ----
    def first_qp(cur, tgt):
        z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
        bounds = planner.nlp_bounds(cur, tgt)
        _, _, sa, (h, lc, uc, lx, ux) = qp_subproblem(ocp, bounds, z0)
        B = cur.shape[0]
        P = hessian_regularization_diag(ocp, B, f32, dev, planner.sqp_settings.reg_eps)
        soft_c, soft_x = soft_weights(ocp, planner.sqp_settings, B, f32, dev)
        return z0, sa, (P, h, lc, uc, lx, ux), soft_c, soft_x

    cur_f, tgt_f = chain_states(planner, torch.Generator().manual_seed(0), B_FACTOR)
    _, sa_f, args_f, sc_f, sx_f = first_qp(cur_f, tgt_f)
    settings = planner.qp_settings
    qp_f = qp_structured.scale_qp(ocp, sa_f, *args_f, settings,
                                   soft_c=sc_f, soft_x=sx_f)

    # ---- phase 3: kernel 2 against factor_banded ----
    fk = k2.factor_banded_kernel(qp_f.Mband, qp_f.p_col, qp_f.m_pp)
    fp = qp_structured.factor_banded(qp_f.Mband, qp_f.p_col, qp_f.m_pp, 3)
    torch.cuda.synchronize()
    check(torch.equal(fk["ok"], fp["ok"]), "kernel 2 ok flags differ from the plain version")
    errs = {k: rel_err(fk[k], fp[k]) for k in ("Ldi", "Lsub", "u", "s")}
    for k, e in errs.items():
        check(e <= 1e-3, f"kernel 2 {k} differs: max-norm relative error {e:.3e}")
    results["banded_factor"]["max_abs_err"] = max(max_abs(fk[k], fp[k]) for k in errs)
    bad = qp_f.Mband.clone()
    bad[0, 0, 0, 0, 0] = -1.0
    fb = k2.factor_banded_kernel(bad, qp_f.p_col, qp_f.m_pp)
    torch.cuda.synchronize()
    check(not bool(fb["ok"][0]), "kernel 2 did not flag the indefinite problem")
    check(torch.equal(fb["ok"][1:], fk["ok"][1:]), "kernel 2 flags leaked across problems")
    check(bool(torch.isfinite(fb["Ldi"]).all()), "kernel 2 emitted non-finite factors")
    log(f"phase 3 kernel 2 B={B_FACTOR}: ok flags identical ({int(fk['ok'].sum())}/{B_FACTOR} ok), "
        f"max-norm relative error " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + " (tol 1e-3); indefinite problem flagged")

    # ---- phase 4: kernel 3 against the plain loop on real QPs ----
    B4 = B_ADMM
    sa4 = qp_structured.StructuredA(sa_f.p[:B4], sa_f.f_rows[:B4], sa_f.J[:B4])
    args4 = tuple(a[:B4] for a in args_f)
    kw = dict(soft_c=sc_f[:B4], soft_x=sx_f[:B4])
    # (a) the loop alone, one check window on identical data and factors:
    # each float32 loop against a float64 run of the plain loop; the kernel
    # may not stray further from it than the plain float32 loop does
    qp4 = qp_structured.scale_qp(ocp, sa4, *args4, settings, **kw)
    fac4 = k2.factor_banded_kernel(qp4.Mband, qp4.p_col, qp4.m_pp)
    s_win = dataclasses.replace(settings, max_iter=settings.check_every)
    x_k = k3.admm_kernel(ocp, sa4, qp4, fac4, s_win)[0]
    x_p = qp_structured.admm_plain(ocp, sa4, qp4, fac4, s_win)[0]
    qp4_64 = qp_structured.ScaledQP(
        *(getattr(qp4, f.name).double() for f in dataclasses.fields(qp4)))
    fac4_64 = {k: v.double() for k, v in fac4.items() if k != "ok"}
    x_64 = qp_structured.admm_plain(ocp64, sa4.to(dtype=torch.float64), qp4_64, fac4_64,
                                    s_win)[0]
    e_k, e_p = max_abs(x_k, x_64), max_abs(x_p, x_64)
    check(e_k <= 2 * e_p + 1e-6,
          f"kernel 3 strays from float64 by {e_k:.3e}, the plain float32 loop by {e_p:.3e}")
    # (b) the whole QP solve, kernels 2 + 3 against the plain path
    ref = qp_structured.solve_box_qp_structured(ocp, sa4, *args4, settings, **kw)
    got = k3.solve_box_qp_structured_cuda(ocp, sa4, *args4, settings, **kw)
    torch.cuda.synchronize()
    agree = int((got.converged == ref.converged).sum())
    both = got.converged & ref.converged
    gaps = (got.iterations - ref.iterations).abs()[both]
    n_within = int((gaps <= 25).sum())
    med_gap = int(gaps.median()) if both.any() else 0
    check(agree >= B4 - 2, f"kernel 3 convergence agrees on only {agree}/{B4}")
    check(n_within >= int(both.sum()) - B4 // 8 and med_gap == 0,
          f"kernel 3 iteration counts: {n_within}/{int(both.sum())} within 25, median gap {med_gap}")
    # hard rows of converged problems: the hard box rows within the JAX
    # package's bar (5e-3, tests/test_qp_structured.py), and every hard row
    # within the primal tolerance that convergence implies, eps_abs +
    # eps_rel * max(|Ax|, |x|), with 1% for float32 rounding
    _, lc, uc, lx, ux = args4[1:]
    Ax = apply_A(ocp, sa4, got.x)
    viol_c = torch.clamp(Ax - uc, min=0) + torch.clamp(lc - Ax, min=0)
    viol_x = torch.clamp(got.x - ux, min=0) + torch.clamp(lx - got.x, min=0)
    viol_box = (viol_x * (kw["soft_x"] == 0)).amax(-1)
    viol_hard = torch.maximum((viol_c * (kw["soft_c"] == 0)).amax(-1), viol_box)
    eps_p = settings.eps_abs + settings.eps_rel * torch.maximum(
        Ax.abs().amax(-1), got.x.abs().amax(-1))
    conv = got.converged
    box_viol = float(viol_box[conv].max()) if conv.any() else 0.0
    hard_ratio = float((viol_hard / eps_p)[conv].max()) if conv.any() else 0.0
    check(box_viol < 5e-3, f"kernel 3 converged problems violate hard box rows by {box_viol}")
    check(hard_ratio <= 1.01,
          f"kernel 3 converged problems violate hard rows by {hard_ratio:.3f}x the tolerance")
    results["structured_admm"]["max_abs_err"] = max_abs(x_k, x_p)
    log(f"phase 4 kernel 3 B={B4}: after {s_win.max_iter} iterations max |x - x_float64| "
        f"kernel {e_k:.3e}, plain {e_p:.3e} (bar: kernel <= 2x plain), max |x_kernel - x_plain| "
        f"{max_abs(x_k, x_p):.3e}; full solve: converged agree {agree}/{B4} (kernel "
        f"{int(got.converged.sum())}, plain {int(ref.converged.sum())}), iteration counts "
        f"within 25 on {n_within}/{int(both.sum())} (bar: all but {B4 // 8}), median gap "
        f"{med_gap}, max gap {int(gaps.max()) if both.any() else 0}, hard box-row violation "
        f"{box_viol:.2e} (tol 5e-3), hard-row violation {hard_ratio:.3f}x the primal "
        f"tolerance (bar 1.01)")

    # ---- phase 5: the main path at B=2048 ----
    cur, tgt = chain_states(planner, torch.Generator().manual_seed(0), B_MAIN)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = planner.solve(cur, tgt)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    counts = kernels.launch_counts()
    repairs = k2.REPAIRS.count
    check(counts == {"constraints": 5, "banded_factor": 2, "structured_admm": 2},
          f"main path launch counts {counts}")
    for name, n in counts.items():
        results[name]["launches"] = n
    finite = all(bool(torch.isfinite(t).all()) for t in (sol.z, sol.violation, sol.lam_c, sol.lam_x))
    check(finite, "main path produced non-finite outputs")
    tol = planner.target_eps + settings.eps_abs
    err_sim = (sol.x_at(1.0) - tgt).abs().amax(-1)
    viol = sol.violation.double().cpu().numpy()
    tol_hit = float((err_sim <= tol).double().mean())
    qp_conv = float(sol.qp_converged.double().mean())
    check(tol_hit >= 0.99, f"tol_hit_rate {tol_hit}")
    check(qp_conv >= 0.98, f"qp_conv_rate {qp_conv}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    planner.solve(cur, tgt)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    log(f"phase 5 main path B={B_MAIN}: launches {counts}, ok-flag repairs {repairs}, "
        f"tol_hit_rate {tol_hit:.4f}, qp_conv_rate {qp_conv:.4f} "
        f"(step 0 {float(sol.qp_converged[:, 0].double().mean()):.4f}, "
        f"step 1 {float(sol.qp_converged[:, 1].double().mean()):.4f}), "
        f"median violation {float(np.median(viol)):.4f}, p90 violation "
        f"{float(np.percentile(viol, 90)):.4f}, terminal error max {float(err_sim.max()):.5f} "
        f"(tol {tol}), qp iterations median {sol.qp_iterations.float().median(0).values.tolist()}")
    log(f"phase 5 timing: cold solve {t_cold:.3f} s, warm solve {t_warm:.3f} s = "
        f"{B_MAIN / t_warm:.1f} solves/s on {smi}")

    # ---- phase 6: the JAX fixture ----
    fx = np.load(FIXTURE)
    fcur = torch.as_tensor(fx["current"], device=dev)
    ftgt = torch.as_tensor(fx["target"], device=dev)
    fsol = planner.solve(fcur, ftgt)
    tf_ref = torch.as_tensor(fx["final_time"], device=dev)
    tf_rel = (fsol.final_time - tf_ref).abs() / tf_ref.abs()
    conv_same = (fsol.qp_converged == torch.as_tensor(fx["qp_converged"], device=dev)).all(-1)
    ferr = (fsol.x_at(1.0) - ftgt).abs().amax(-1)
    good = (tf_rel <= 1e-3) & conv_same & (ferr <= tol)
    n_good = int(good.sum())
    check(n_good >= 60, f"only {n_good}/64 fixture problems agree with the JAX reference")
    zgap = (fsol.z - torch.as_tensor(fx["z"], device=dev)).abs().amax(-1)
    vgap = (fsol.violation - torch.as_tensor(fx["violation"], device=dev)).abs()
    log(f"phase 6 JAX fixture: {n_good}/64 agree (final_time within 1e-3 relative, same "
        f"qp_converged, terminal error <= {tol}); largest gaps: final_time rel "
        f"{float(tf_rel.max()):.2e}, z max-abs {float(zgap.max()):.3e}, violation "
        f"{float(vgap.max()):.3e}, qp_converged mismatches {int((~conv_same).sum())}, "
        f"terminal error {float(ferr.max()):.5f}")

    # ---- phase 7: each kernel against its plain version at main-path shapes ----
    z0, sa, args, sc, sx = first_qp(cur, tgt)
    X, U, _ = ocp.unpack(z0)
    p_ms, k_ms, raw = time_pair(
        lambda: k1.node_constraints_plain(ocp, X, U, True),
        lambda: k1.node_constraints_kernel(ocp, X, U, True),
    )
    results["constraints"].update(ms=k_ms, plain_ms=p_ms)
    log(f"phase 7 kernel 1 with Jacobian F={X.shape[0] * X.shape[1]}: kernel {k_ms:.3f} ms, "
        f"plain {p_ms:.3f} ms (runs {raw})")
    Xl = X.repeat(10, 1, 1)
    Ul = U.repeat(10, 1, 1)
    p_ms, k_ms, raw = time_pair(
        lambda: k1.node_constraints_plain(ocp, Xl, Ul, False),
        lambda: k1.node_constraints_kernel(ocp, Xl, Ul, False),
    )
    log(f"phase 7 kernel 1 values only F={Xl.shape[0] * Xl.shape[1]}: kernel {k_ms:.3f} ms, "
        f"plain {p_ms:.3f} ms (runs {raw})")
    qp = qp_structured.scale_qp(ocp, sa, *args, settings, soft_c=sc, soft_x=sx)
    p_ms, k_ms, raw = time_pair(
        lambda: qp_structured.factor_banded(qp.Mband, qp.p_col, qp.m_pp, 3),
        lambda: k2.factor_banded_kernel(qp.Mband, qp.p_col, qp.m_pp),
    )
    results["banded_factor"].update(ms=k_ms, plain_ms=p_ms)
    log(f"phase 7 kernel 2 B={B_MAIN}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms (runs {raw})")
    fac = k2.factor(qp.Mband, qp.p_col, qp.m_pp, 3)
    p_ms, k_ms, raw = time_pair(
        lambda: qp_structured.admm_plain(ocp, sa, qp, fac, settings),
        lambda: k3.admm_kernel(ocp, sa, qp, fac, settings),
        reps=1,
    )
    results["structured_admm"].update(ms=k_ms, plain_ms=p_ms)
    log(f"phase 7 kernel 3 B={B_MAIN}, step-0 QP, budget {settings.max_iter}: kernel "
        f"{k_ms:.3f} ms, plain {p_ms:.3f} ms (runs {raw})")
    # at a cap of one check window every problem runs exactly that many
    # iterations, which gives the loop's cost per iteration
    s_win = dataclasses.replace(settings, max_iter=settings.check_every)
    p_ms, k_ms, raw = time_pair(
        lambda: qp_structured.admm_plain(ocp, sa, qp, fac, s_win),
        lambda: k3.admm_kernel(ocp, sa, qp, fac, s_win),
        reps=1,
    )
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    waves = -(-B_MAIN // sms)  # one block per SM: its shared memory takes the SM
    log(f"phase 7 kernel 3 B={B_MAIN}, exactly {s_win.max_iter} iterations: kernel "
        f"{k_ms:.3f} ms = {1e3 * k_ms / s_win.max_iter / waves:.2f} us per iteration per "
        f"block ({waves} waves of {sms} blocks), plain {p_ms:.3f} ms (runs {raw})")

    print(json.dumps({"kernels": list(results.values())}))
    print(smi)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    run(torch.device("cuda"))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
