#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``mpc_motion_planner_tpu_torch``).

Builds the four hand-written CUDA kernels from ``csrc/`` (one nvcc each, all
started together), holds each against its plain PyTorch version on the
card, and drives ``MotionPlanner.solve`` through them on the headline
workload (the JAX headline's own B=2048 chained benchmark states, 7-DoF
Panda, 19 nodes, 400 variables, 488 constraint rows) on both QP paths:

* the structured path (the shipping configuration, kernels 1-3), checked
  against the JAX structured fixture ``torch_port_slice_b64.npz``;
* the dense path (the headline's ``BENCH_QP_BACKEND=pallas``
  configuration, kernels 1 and 4), checked against the JAX dense fixture
  ``torch_port_dense_b64.npz`` (the JAX ``pallas`` backend at float32, its
  kernel in Pallas interpret mode; see
  ``tests/fixtures/make_torch_headline_fixtures.py``).

Kernel 3 is also held against the plain loop with KKT refinement, under
adaptive rho (dispatches of 100 iterations with kernel 2 refactoring between
them), with the rescue budget and on a batch that is no round number (phase
4), and drives a solve at the structured backend's default settings and a
hot restart (phases 5b, 5c). Then the script times each kernel against its
plain version. Kernel 2 runs several problems per SM and kernel 4 one
problem per thread-block cluster; phases 3 and 7 print the occupancy each
reaches. Last, it runs the port's three user entry points in this process:
the headline (``bench/headline.py``) on the structured and the dense path
(phase 11), the acceptance (``bench/acceptance.py``) on the 1000 states of
the JAX acceptance artifact ``analysis/benchmark_data_r05.txt.gz``, held
against the JAX analysis of that artifact (phase 12), and the
offline-trajectory example with its re-integration check (phase 13).
Needs one CUDA GPU and ``nvcc``; imports no JAX.

    python3 chip_smoke.py

Prints one line per phase, then a JSON line of per-kernel results, the
card's name and power limit, and finally
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises, and the script exits non-zero without that line.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
STATES = os.path.join(FIXTURES, "headline_states_b2048.npz")
FIXTURE = os.path.join(FIXTURES, "torch_port_slice_b64.npz")
DENSE_FIXTURE = os.path.join(FIXTURES, "torch_port_dense_b64.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)
B_MAIN = 2048  # the headline batch
B_FACTOR = 256  # kernel-2 comparison batch
B_ADMM = 64  # kernel-3 and kernel-4 comparison batch
B_ODD = 61  # a batch that is no round number
# the JAX package's record on these states (BENCH_r05.json, structured_pallas)
JAX_RECORD = {"qp_conv_rate": 0.9978, "tol_hit_rate": 1.0, "median_violation": 0.487,
              "p90_violation": 5.37, "terminal_err_inf_max": 0.010}
# every key of the JAX headline's line (mpc_motion_planner_tpu/bench/headline.py)
JAX_HEADLINE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "batch", "batch_wall_s", "amortized_ms_per_solve",
    "tol_hit_rate", "tol_threshold", "terminal_err_inf_max", "node_terminal_err_max",
    "median_violation", "p90_violation", "qp_conv_rate", "qp_max_iter", "kkt_refine",
    "exit_every", "exit_warmup", "exit_schedule", "sqp_schedules", "rescue_iters", "ruiz_iters",
    "rho", "alpha", "fused_constraints", "qp_backend", "device",
)
# the JAX acceptance artifact (1000 chained states, structured_pallas on a
# TPU) and the JAX package's analysis of it: violation_counts_reference
ARTIFACT = os.path.join(ROOT, "analysis", "benchmark_data_r05.txt.gz")
JAX_ACCEPTANCE = {
    "ruckig": {"position_fails": 0, "velocity_fails": 0, "torqueAccel_fails": 4, "Jerk_fails": 0,
               "taskVelocity_fails": 222, "collision_fails": 64, "total": 290},
    "mpc": {"position_fails": 0, "velocity_fails": 0, "torqueAccel_fails": 0, "Jerk_fails": 0,
            "taskVelocity_fails": 234, "collision_fails": 33, "total": 267},
}
REPLACES = {
    "constraints": "mpc_motion_planner_tpu/ops/pallas/constraints_kernel.py:345",
    "banded_factor": "mpc_motion_planner_tpu/ops/pallas/banded_factor.py:262",
    "structured_admm": "mpc_motion_planner_tpu/ops/pallas/structured_admm.py:830",
    "admm_dense": "mpc_motion_planner_tpu/ops/pallas/admm_kernel.py:416",
}
HBM_TBPS = 3.35  # H100 SXM device-memory bandwidth (NVIDIA data sheet)
FP32_TFLOPS = 67.0  # H100 SXM float32 rate outside the tensor cores (same sheet)
# Operations of each kernel's function, from its source:
# kernel 1: two Newton-Euler sweeps and the tool FK are ~1.5 kflop per value
# pass (kernels/constraints.py); each of the 21 tangents costs two more
K1_VALUE_FLOPS = 1.5e3
K1_JAC_FLOPS = K1_VALUE_FLOPS * (1 + 2 * 21)
# kernel 3, per problem-iteration: the sweeps 2 x (19 x 231 + 51 x 441)
# multiply-adds (triangular Ldi, 51 sub-diagonal blocks) = 107.5 kflop, A and
# A' 2 x (336 x 6 + 152 x 21) = 20.8 kflop, the arrow 3.2 kflop, ~29 flop for
# each of the 888 element-wise updates
K3_ITER_FLOPS = 157e3
# a refinement step runs the sweeps, A, A' and the arrow once more (131.5
# kflop) and ~3 flop for each of the 888 rows and elements
K3_REFINE_FLOPS = 134e3


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


def bound(flops: float, nbytes: float):
    """The least time in ms the card could take: the larger of the
    operations over its float32 rate and the bytes (each input read once,
    each output written once) over its memory rate; and which of the two."""
    t_ops, t_bytes = flops / (FP32_TFLOPS * 1e9), nbytes / (HBM_TBPS * 1e9)
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def banded_factor_flops(nodes=19, bw=3, blk=21) -> float:
    """Operations of one block-banded Cholesky with inverse diagonal blocks
    and the arrow solve (csrc/banded_factor.cu): per node the Schur update
    (one blk^3 product per band neighbour), a Cholesky and a triangular
    inverse (blk^3 / 3 each), and per live sub-diagonal block its band
    products and the product with the triangular inverse (blk^3 / 2)."""
    macs = 0.0
    for k in range(nodes):
        macs += min(bw, k) * blk**3 + 2 * blk**3 / 6
        for d in range(1, bw + 1):
            if k + d < nodes:
                macs += min(k, bw - d) * blk**3 + blk**3 / 2
    macs += 2 * (nodes * blk * (blk + 1) / 2 + (3 * nodes - 6) * blk**2)  # the arrow's sweeps
    return 2 * macs


def report_bound(entry, flops, nbytes, what):
    """Store a kernel's bound beside its measured time; return the text."""
    ms, by = bound(flops, nbytes)
    entry.update(bound_ms=ms, bound_by=by, library_ms=None)
    return (f"bound {ms:.4f} ms by {by} ({flops / 1e9:.3f} GFLOP at {FP32_TFLOPS} TFLOP/s, "
            f"{nbytes / 1e6:.1f} MB at {HBM_TBPS} TB/s; {what}), share reached "
            f"{100 * ms / entry['ms']:.1f}%; no single PyTorch call computes this function")


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


def time_kernel(fn, reps=3, behind=None):
    """Mean ms per call of ``fn`` with CUDA events, after one warm-up call.
    ``behind`` keeps the card busy for longer than the host needs to enqueue
    the calls, so that they queue up and the events time the device alone:
    for a kernel that is shorter than its wrapper's host time."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if behind is not None:
        torch.cuda.synchronize()
        behind()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def iteration_agreement(got, ref, B, what):
    """The float32 parity bars of two ADMM solves of the same QPs (phase 4's
    rule, reasons in PERF.md): converged agrees on all but B/32 (2 at B=64),
    and the iteration counts of problems both converged are within 25 for
    all but B/8 with a median gap of 0. Returns a summary string."""
    agree = int((got.converged == ref.converged).sum())
    both = got.converged & ref.converged
    gaps = (got.iterations - ref.iterations).abs()[both]
    n_within = int((gaps <= 25).sum())
    med_gap = int(gaps.median()) if both.any() else 0
    check(agree >= B - max(2, B // 32), f"{what}: convergence agrees on only {agree}/{B}")
    check(n_within >= int(both.sum()) - B // 8 and med_gap == 0,
          f"{what}: iteration counts {n_within}/{int(both.sum())} within 25, median gap {med_gap}")
    return (f"converged agree {agree}/{B} (kernel {int(got.converged.sum())}, plain "
            f"{int(ref.converged.sum())}), iteration counts within 25 on "
            f"{n_within}/{int(both.sum())} (bar: all but {B // 8}), median gap {med_gap}, "
            f"max gap {int(gaps.max()) if both.any() else 0}")


def hard_row_ratio(x, Ax, lc, uc, lx, ux, soft_c, soft_x, settings, converged):
    """For converged problems: the largest hard box-row violation, and the
    largest hard-row violation over the primal tolerance that convergence
    implies, eps_abs + eps_rel * max(|Ax|, |x|)."""
    viol_c = torch.clamp(Ax - uc, min=0) + torch.clamp(lc - Ax, min=0)
    viol_x = torch.clamp(x - ux, min=0) + torch.clamp(lx - x, min=0)
    viol_box = (viol_x * (soft_x == 0)).amax(-1)
    viol_hard = torch.maximum((viol_c * (soft_c == 0)).amax(-1), viol_box)
    eps_p = settings.eps_abs + settings.eps_rel * torch.maximum(
        Ax.abs().amax(-1), x.abs().amax(-1))
    if not converged.any():
        return 0.0, 0.0
    return float(viol_box[converged].max()), float((viol_hard / eps_p)[converged].max())


def random_dense_chunk(B, n, m, seed, dev):
    """Operands and state of kernel 4 for B random QPs of any (n, m): a
    diagonal P, a dense A, M^-1 = (P + sigma + rx + A' rc A)^-1, soft
    thresholds on every third row."""
    gen = torch.Generator().manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=gen)
    rand = lambda *shape: torch.rand(*shape, generator=gen)
    A = randn(B, m, n) / n ** 0.5
    rc, rx, P = torch.full((B, m), 0.1), torch.full((B, n), 0.1), rand(B, n) + 0.1
    M = torch.diag_embed(P + 1e-6 + rx) + torch.einsum("bmi,bm,bmj->bij", A, rc, A)
    ops = {"M_inv": torch.linalg.inv(M.double()).float(), "A": A, "P": P, "q": randn(B, n),
           "lx": torch.full((B, n), -3.0), "ux": torch.full((B, n), 3.0), "rx": rx,
           "D": rand(B, n) + 0.5, "sx": torch.full((B, n), 1e20), "lc": -rand(B, m),
           "uc": rand(B, m), "rc": rc, "E": rand(B, m) + 0.5, "sc": torch.full((B, m), 1e20)}
    ops["sc"][:, ::3] = 0.3
    st = {"x": 0.1 * randn(B, n), "zc": 0.1 * randn(B, m), "zx": 0.1 * randn(B, n),
          "yc": 0.1 * randn(B, m), "yx": 0.1 * randn(B, n),
          "done": torch.zeros(B, dtype=torch.int32)}
    on_dev = lambda d: {k: v.to(dev).contiguous() for k, v in d.items()}
    return on_dev(ops), on_dev(st)


def quality(planner, sol, tgt):
    """The headline line's quality fields of a batched solve (tol_hit_rate,
    qp_conv_rate, median / p90 violation, terminal errors), with the
    converged share and the median QP iterations per SQP step."""
    from mpc_motion_planner_tpu_torch.bench.headline import quality_fields

    return {
        **quality_fields(planner, sol, tgt),
        "qp_conv_steps": [round(float(c), 4) for c in sol.qp_converged.double().mean(0)],
        "qp_iterations_median": sol.qp_iterations.float().median(0).values.tolist(),
    }


@contextlib.contextmanager
def bench_env(**values):
    """The process environment with every BENCH_* variable removed but
    ``values``; restored on exit."""
    saved = dict(os.environ)
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        del os.environ[k]
    os.environ.update(values)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def run_main(main, argv):
    """Run an entry point's ``main`` in this process; return its stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    check(rc == 0, f"{main.__module__}.main returned {rc}")
    return out.getvalue()


def json_after(text: str, marker: str):
    """The JSON object that starts at the first "{" after ``marker``."""
    return json.JSONDecoder().raw_decode(text, text.index("{", text.index(marker)))[0]


def fixture_agreement(planner, path, dev):
    """Solve a JAX fixture's states; count the problems whose final time is
    within 1e-3 relative, whose qp_converged is the same and whose terminal
    error is within the target box. Returns (count, batch, summary)."""
    fx = np.load(path)
    cur = torch.as_tensor(fx["current"], device=dev)
    tgt = torch.as_tensor(fx["target"], device=dev)
    sol = planner.solve(cur, tgt)
    tol = planner.target_eps + planner.qp_settings.eps_abs
    tf_ref = torch.as_tensor(fx["final_time"], device=dev)
    tf_rel = (sol.final_time - tf_ref).abs() / tf_ref.abs()
    conv_same = (sol.qp_converged == torch.as_tensor(fx["qp_converged"], device=dev)).all(-1)
    err = (sol.x_at(1.0) - tgt).abs().amax(-1)
    n_good = int(((tf_rel <= 1e-3) & conv_same & (err <= tol)).sum())
    zgap = (sol.z - torch.as_tensor(fx["z"], device=dev)).abs().amax(-1)
    vgap = (sol.violation - torch.as_tensor(fx["violation"], device=dev)).abs()
    return n_good, cur.shape[0], (
        f"{n_good}/{cur.shape[0]} agree (final_time within 1e-3 relative, same qp_converged, "
        f"terminal error <= {tol}); largest gaps: final_time rel {float(tf_rel.max()):.2e}, "
        f"z max-abs {float(zgap.max()):.3e}, violation {float(vgap.max()):.3e}, "
        f"qp_converged mismatches {int((~conv_same).sum())}, terminal error "
        f"{float(err.max()):.5f}"
    )


def entry_points(planner) -> None:
    """Phases 11-13: the port's three user entry points in this process, on
    the card, each with the launch counts set to 0 just before it and read
    just after. ``planner`` is the shipping one of phase 5 (its limits and
    margins are the acceptance's)."""
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.bench import acceptance, analysis, headline
    from mpc_motion_planner_tpu_torch.examples import offline_trajectory
    from mpc_motion_planner_tpu_torch.utils.io import read_benchmark_records

    # ---- phase 11: the port's headline entry point on both QP paths: a
    # cold solve and three warm ones of the headline states ----
    repeats = 3
    for backend, per_solve in (
            ("structured_pallas", {"constraints": 5, "banded_factor": 2, "structured_admm": 2,
                                   "admm_dense": 0}),
            ("pallas", {"constraints": 5, "banded_factor": 0, "structured_admm": 0,
                        "admm_dense": 2})):
        with bench_env(BENCH_QP_BACKEND=backend, BENCH_BATCH=str(B_MAIN),
                       BENCH_REPEATS=str(repeats)):
            kernels.reset_launch_counts()
            text = run_main(headline.main, [])
            counts = kernels.launch_counts()
        lines = text.strip().splitlines()
        check(len(lines) == 1, f"headline {backend} printed {len(lines)} lines")
        line = json.loads(lines[0])
        log(f"phase 11 headline line, {backend}: {lines[0]}")
        check(counts == {k: n * (1 + repeats) for k, n in per_solve.items()},
              f"headline {backend}: launch counts {counts} for {1 + repeats} solves")
        missing = set(JAX_HEADLINE_KEYS) - line.keys()
        check(not missing and line["package"] == "torch", f"headline line lacks {missing}")
        check(line["qp_backend"] == backend and line["fused_constraints"] == "on"
              and line["batch"] == B_MAIN, f"headline {backend}: {line}")
        check(line["tol_hit_rate"] >= 0.99 and line["terminal_err_inf_max"] <= 0.011,
              f"headline {backend}: tol_hit_rate {line['tol_hit_rate']}, terminal error "
              f"{line['terminal_err_inf_max']}")
        if backend == "structured_pallas":
            check(line["qp_conv_rate"] >= 0.98, f"headline qp_conv_rate {line['qp_conv_rate']}")
        log(f"phase 11 headline {backend}: launches per solve "
            f"{ {k: n // (1 + repeats) for k, n in counts.items()} }, {line['value']:.1f} "
            f"solves/s (eager solve) on {line['device']}; JAX record on these states "
            f"{json.dumps(JAX_RECORD)}")

    # ---- phase 12: the port's acceptance entry point on the 1000 states of
    # the JAX acceptance artifact, against the JAX analysis of it ----
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "records.txt")
        kernels.reset_launch_counts()
        text = run_main(acceptance.main, ["--states-from", ARTIFACT, "--n", "1000",
                                          "--batch", "250", "--out", out])
        counts = kernels.launch_counts()
        rec = read_benchmark_records(out)
    check(rec.shape == (1000, 162) and bool(np.isfinite(rec).all()),
          f"acceptance records {rec.shape}")
    check(counts == {"constraints": 20, "banded_factor": 8, "structured_admm": 8,
                     "admm_dense": 0}, f"acceptance launch counts {counts} for 4 batches")
    for ln in text.splitlines():
        if ln.startswith("batch ") or ln.startswith("total:"):
            log(f"phase 12 acceptance {ln}")
    conv = json_after(text, "\ntotal:")["qp_conv_rate"]
    limits = planner.limits
    check(analysis.violation_counts_reference(read_benchmark_records(ARTIFACT), limits)
          == JAX_ACCEPTANCE, "the port's analysis of the artifact differs from the JAX tables")
    port = analysis.violation_counts_reference(rec, limits)
    acc = analysis.accuracy_stats(rec)
    for cat, n_jax in JAX_ACCEPTANCE["ruckig"].items():
        if cat != "total":
            check(abs(port["ruckig"][cat] - n_jax) <= 2,
                  f"acceptance ruckig {cat}: {port['ruckig'][cat]} against the JAX {n_jax}")
    for cat in ("position_fails", "velocity_fails", "torqueAccel_fails", "Jerk_fails"):
        check(port["mpc"][cat] == 0, f"acceptance mpc {cat}: {port['mpc'][cat]}")
    for cat in ("taskVelocity_fails", "collision_fails"):
        n_jax = JAX_ACCEPTANCE["mpc"][cat]
        check(abs(port["mpc"][cat] - n_jax) <= 0.15 * n_jax,
              f"acceptance mpc {cat}: {port['mpc'][cat]} against the JAX {n_jax} (bar 15%)")
    check(acc["mpc"]["within_box_plus_tol"] >= 0.999 and conv >= 0.98,
          f"acceptance: mpc within_box_plus_tol {acc['mpc']['within_box_plus_tol']}, "
          f"qp_conv_rate {conv}")
    for planner_name in ("ruckig", "mpc"):
        log(f"phase 12 acceptance {planner_name}, reference convention: port "
            f"{json.dumps(port[planner_name])} | JAX artifact "
            f"{json.dumps(JAX_ACCEPTANCE[planner_name])}")
    log(f"phase 12 acceptance: launches {counts}, qp_conv_rate {conv} (JAX artifact 0.997), "
        f"mpc within_box_plus_tol {acc['mpc']['within_box_plus_tol']} (JAX 1.0), err_inf_max "
        f"{acc['mpc']['err_inf_max']} (JAX 0.01), ruckig within_target_box "
        f"{acc['ruckig']['within_target_box']} (JAX 1.0); strict convention "
        f"{json.dumps(analysis.violation_counts(rec, limits, planner.margins))}")

    # ---- phase 13: the port's offline-trajectory example ----
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "optimal_solution.txt")
        kernels.reset_launch_counts()
        run_main(offline_trajectory.main, ["--seed", "3", "--out", out])
        counts = kernels.launch_counts()
        data = np.loadtxt(out)
        v_gap, q_err = offline_trajectory.check_solution_file(out)
    check(data.shape == (1 + 201 + 201, 29) and bool(np.isfinite(data).all()),
          f"offline trajectory file {data.shape}")
    check(counts == {"constraints": 5, "banded_factor": 2, "structured_admm": 2,
                     "admm_dense": 0}, f"offline trajectory launch counts {counts}")
    check(v_gap < 5e-3 and q_err <= 0.011,
          f"offline trajectory: velocity consistency {v_gap}, final position error {q_err}")
    log(f"phase 13 offline trajectory --seed 3: {data.shape[0]} x {data.shape[1]} file, "
        f"launches {counts}, velocity consistency {v_gap:.2e} (bar 5e-3), final position "
        f"error {q_err:.5f} (bar 0.011), final time {data[-1, 0]:.4f} s, warm start "
        f"{data[201, 0]:.4f} s")


def run(dev: torch.device) -> None:
    """All phases on ``dev``; raises on the first failed check."""
    from mpc_motion_planner_tpu_torch import config, kernels
    from mpc_motion_planner_tpu_torch.kernels import admm_dense as k4
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels import constraints as k1
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.ocp import make_ocp
    from mpc_motion_planner_tpu_torch.ops import qp as dense_qp
    from mpc_motion_planner_tpu_torch.ops import qp_structured
    from mpc_motion_planner_tpu_torch.ops.sqp import (
        SQPSettings, hessian_regularization_diag, qp_subproblem, soft_weights,
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

    # ---- phase 1: build, one nvcc per source, all started together ----
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels.KERNELS)) as pool:
        paths = dict(zip(kernels.KERNELS, pool.map(lambda k: k.build(), kernels.KERNELS.values())))
    for name, k in kernels.KERNELS.items():
        info = [ln.strip() for ln in k.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"phase 1 build: {name} -> {os.path.relpath(paths[name], ROOT)} | " + " | ".join(info))
    log(f"phase 1 build: {len(paths)} kernels in {time.perf_counter() - t0:.1f} s")

    shipping = config.SHIPPING_QP_SETTINGS
    planner = MotionPlanner(
        margins=Margins(*MARGINS), dtype=f32, device=dev, qp_settings=shipping,
        sqp_settings=SQPSettings(
            qp_step_schedules=config.shipping_sqp_schedules(shipping.backend)),
    )
    ocp = planner.ocp
    ocp64 = make_ocp(planner.model.to(dtype=torch.float64))
    states = np.load(STATES)
    cur_all = torch.as_tensor(states["current"], device=dev)
    tgt_all = torch.as_tensor(states["target"], device=dev)
    check(cur_all.shape == (B_MAIN, 14), f"headline states {tuple(cur_all.shape)}")

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

    # ---- shared: step-0 QPs, of torch.Generator chained states (phases 3,
    # 4, as since they were written) or of the headline states ----
    from mpc_motion_planner_tpu_torch.bench.harness import chain_states

    cur_gen, tgt_gen = chain_states(planner, torch.Generator().manual_seed(0), B_FACTOR)

    def first_qp(B, dense=False, settings=shipping, headline=True):
        cur, tgt = (cur_all[:B], tgt_all[:B]) if headline else (cur_gen[:B], tgt_gen[:B])
        z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
        bounds = planner.nlp_bounds(cur, tgt)
        _, _, lin, (h, lc, uc, lx, ux) = qp_subproblem(ocp, bounds, z0, dense)
        P = hessian_regularization_diag(ocp, B, f32, dev, planner.sqp_settings.reg_eps)
        soft_c, soft_x = soft_weights(ocp, planner.sqp_settings, B, f32, dev)
        if dense:
            args = (P, h, lin, lc, uc, lx, ux)
            return args, dense_qp.scale_dense_qp(*args, settings, soft_c=soft_c, soft_x=soft_x), \
                soft_c, soft_x
        return z0, lin, (P, h, lc, uc, lx, ux), soft_c, soft_x

    _, sa_f, args_f, sc_f, sx_f = first_qp(B_FACTOR, headline=False)
    qp_f = qp_structured.scale_qp(ocp, sa_f, *args_f, shipping, soft_c=sc_f, soft_x=sx_f)

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
    # more problems than the card holds at once, several per SM: copies of
    # the B_FACTOR problems in turn, one of them made indefinite. Every copy
    # must come out bitwise as its original did in the small batch, and as it
    # does alone in a launch of its own
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm2 = k2.blocks_per_sm()
    check(per_sm2 > 1, f"kernel 2 holds {per_sm2} problem per SM")
    B_wave = sms * per_sm2 + B_ODD
    src = torch.arange(B_wave, device=dev) % B_FACTOR
    Mb_w = qp_f.Mband[src].contiguous()
    i_bad = sms * per_sm2 // 2 + 1
    Mb_w[i_bad, 0, 0, 0, 0] = -1.0
    fw = k2.factor_banded_kernel(Mb_w, qp_f.p_col[src].contiguous(), qp_f.m_pp[src].contiguous())
    torch.cuda.synchronize()
    others = torch.arange(B_wave, device=dev) != i_bad
    check(not bool(fw["ok"][i_bad]), "kernel 2 did not flag the indefinite problem of the large batch")
    for k in ("Ldi", "Lsub", "u", "s", "ok"):
        check(torch.equal(fw[k][others], fk[k][src][others]),
              f"kernel 2 {k}: a problem inside a batch of {B_wave} differs from itself in a "
              f"batch of {B_FACTOR}")
    for i in (0, i_bad - 1, i_bad + 1, B_wave - 1):
        j = int(src[i])
        alone = k2.factor_banded_kernel(qp_f.Mband[j:j + 1], qp_f.p_col[j:j + 1], qp_f.m_pp[j:j + 1])
        check(all(torch.equal(alone[k][0], fw[k][i]) for k in ("Ldi", "Lsub", "u", "s", "ok")),
              f"kernel 2: problem {i} of the large batch differs from the same problem alone")
    log(f"phase 3 kernel 2 occupancy: {per_sm2} problems per SM ({sms} SMs, {sms * per_sm2} at a "
        f"time); B={B_wave} (more than one wave, one problem indefinite): the indefinite "
        f"problem is flagged, every other problem is bitwise what it is in the batch of "
        f"{B_FACTOR}, and four of them bitwise what they are alone")
    del qp_f, fk, fp, bad, fb, fw, Mb_w

    # ---- phase 4: kernel 3 against the plain loop on real QPs ----
    B4 = B_ADMM
    sa4 = qp_structured.StructuredA(sa_f.p[:B4], sa_f.f_rows[:B4], sa_f.J[:B4])
    args4 = tuple(a[:B4] for a in args_f)
    kw = dict(soft_c=sc_f[:B4], soft_x=sx_f[:B4])
    # (a) the loop alone, one check window on identical data and factors:
    # each float32 loop against a float64 run of the plain loop; the kernel
    # may not stray further from it than the plain float32 loop does
    qp4 = qp_structured.scale_qp(ocp, sa4, *args4, shipping, **kw)
    fac4 = k2.factor_banded_kernel(qp4.Mband, qp4.p_col, qp4.m_pp)
    s_win = dataclasses.replace(shipping, max_iter=shipping.check_every)
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
    # the sweeps' order of sums (look-ahead terms first) as plain PyTorch,
    # against the plain banded solve on these factors at float32: 1e-4 of
    # the largest entry, the rounding of 38 block steps amplified by the
    # factors of real QPs
    rhs4 = torch.randn(B4, ocp.num_var, generator=torch.Generator().manual_seed(4)).to(dev)
    m_plain = qp_structured.solve_arrow_banded(ocp, fac4, rhs4)
    m_ahead = qp_structured.solve_arrow_banded(ocp, fac4, rhs4,
                                               qp_structured.banded_solve_lookahead)
    e_order = max_abs(m_ahead, m_plain) / float(m_plain.abs().max())
    check(e_order <= 1e-4, f"look-ahead order of the sweeps differs by {e_order:.3e} relative")
    # (b) the whole QP solve, kernels 2 + 3 against the plain path
    ref = qp_structured.solve_box_qp_structured(ocp, sa4, *args4, shipping, **kw)
    got = k3.solve_box_qp_structured_cuda(ocp, sa4, *args4, shipping, **kw)
    torch.cuda.synchronize()
    agreement = iteration_agreement(got, ref, B4, "kernel 3")
    # hard rows of converged problems: the hard box rows within the JAX
    # package's bar (5e-3, tests/test_qp_structured.py), and every hard row
    # within the primal tolerance that convergence implies, with 1% for
    # float32 rounding
    _, lc, uc, lx, ux = args4[1:]
    box_viol, hard_ratio = hard_row_ratio(
        got.x, apply_A(ocp, sa4, got.x), lc, uc, lx, ux, kw["soft_c"], kw["soft_x"],
        shipping, got.converged)
    box_viol_p, hard_ratio_p = hard_row_ratio(
        ref.x, apply_A(ocp, sa4, ref.x), lc, uc, lx, ux, kw["soft_c"], kw["soft_x"],
        shipping, ref.converged)
    check(box_viol < 5e-3, f"kernel 3 converged problems violate hard box rows by {box_viol}")
    check(hard_ratio <= 1.01,
          f"kernel 3 converged problems violate hard rows by {hard_ratio:.3f}x the tolerance")
    results["structured_admm"]["max_abs_err"] = max_abs(x_k, x_p)
    log(f"phase 4 kernel 3 B={B4}: after {s_win.max_iter} iterations max |x - x_float64| "
        f"kernel {e_k:.3e}, plain {e_p:.3e} (bar: kernel <= 2x plain), max |x_kernel - x_plain| "
        f"{max_abs(x_k, x_p):.3e}; M^-1 rhs in the sweeps' order against the plain order "
        f"{e_order:.2e} relative (tol 1e-4); full solve: {agreement}, hard box-row violation "
        f"{box_viol:.2e} (tol 5e-3; plain {box_viol_p:.2e}), hard-row violation "
        f"{hard_ratio:.3f}x the primal tolerance (bar 1.01; plain {hard_ratio_p:.3f}x)")
    # (c) one refinement step on every KKT solve, fixed rho, one launch: a
    # check window against float64 as in (a), then the whole solve as in (b)
    s_ref = dataclasses.replace(shipping, kkt_refine=1)
    s_win = dataclasses.replace(s_ref, max_iter=shipping.check_every)
    x_k = k3.admm_kernel(ocp, sa4, qp4, fac4, s_win)[0]
    x_p = qp_structured.admm_plain(ocp, sa4, qp4, fac4, s_win)[0]
    x_64 = qp_structured.admm_plain(ocp64, sa4.to(dtype=torch.float64), qp4_64, fac4_64,
                                    s_win)[0]
    e_k, e_p = max_abs(x_k, x_64), max_abs(x_p, x_64)
    check(e_k <= 2 * e_p + 1e-6, f"kernel 3 with kkt_refine=1 strays from float64 by {e_k:.3e}, "
          f"the plain float32 loop by {e_p:.3e}")
    n3 = k3.KERNEL.launches
    got = k3.solve_box_qp_structured_cuda(ocp, sa4, *args4, s_ref, **kw)
    check(k3.KERNEL.launches == n3 + 1, "kernel 3 with kkt_refine=1 took more than one launch")
    ref = qp_structured.solve_box_qp_structured(ocp, sa4, *args4, s_ref, **kw)
    torch.cuda.synchronize()
    agreement = iteration_agreement(got, ref, B4, "kernel 3 kkt_refine=1")
    box_viol, hard_ratio = hard_row_ratio(
        got.x, apply_A(ocp, sa4, got.x), lc, uc, lx, ux, kw["soft_c"], kw["soft_x"],
        s_ref, got.converged)
    check(box_viol < 5e-3, f"kernel 3 kkt_refine=1: hard box rows violated by {box_viol}")
    check(hard_ratio <= 1.01, f"kernel 3 kkt_refine=1: hard rows at {hard_ratio:.3f}x the tolerance")
    log(f"phase 4c kernel 3 B={B4}, kkt_refine=1, fixed rho, one launch: after "
        f"{s_win.max_iter} iterations max |x - x_float64| kernel {e_k:.3e}, plain {e_p:.3e} (bar: "
        f"kernel <= 2x plain); full solve: {agreement}, hard box-row violation {box_viol:.2e} "
        f"(tol 5e-3), hard-row violation {hard_ratio:.3f}x the primal tolerance (bar 1.01)")
    # (d) adaptive rho: dispatches of 100 iterations, kernel 3 and kernel 2
    # against the plain loop and the plain factor in the same host loop
    s_ada = dataclasses.replace(shipping, rho_update_every=100)
    n3, n2 = k3.KERNEL.launches, k2.KERNEL.launches
    st_k, qp_k, nref_k = qp_structured.admm_chunked(ocp, sa4, qp4, s_ada, k2.factor, k3.admm_kernel)
    n3, n2 = k3.KERNEL.launches - n3, k2.KERNEL.launches - n2
    st_p, qp_p, nref_p = qp_structured.admm_chunked(
        ocp, sa4, qp4, s_ada, qp_structured.factor_banded, qp_structured.admm_plain)
    torch.cuda.synchronize()
    got, ref = (qp_structured.unscale_solution(q_, *s_) for q_, s_ in ((qp_k, st_k), (qp_p, st_p)))
    agreement = iteration_agreement(got, ref, B4, "kernel 3 adaptive rho")
    check(n3 == len(qp_structured.chunk_sizes(s_ada)) and n2 == 1 + nref_k,
          f"adaptive rho: {n3} launches of kernel 3, {n2} of kernel 2, {nref_k} refactorizations")
    check(nref_k == nref_p and nref_k > 0,
          f"adaptive rho: {nref_k} refactorizations with the kernels, {nref_p} plain")
    # a problem's rho follows its residual ratio at each boundary, so it is
    # compared on the problems whose checks fired in the same windows: rho
    # moved on the same ones, and to the same value as far as two float32
    # loops' residuals near convergence agree (a ratio acts only beyond 5x)
    same = got.iterations == ref.iterations
    moved_k, moved_p = qp_k.rho != qp4.rho, qp_p.rho != qp4.rho
    n_moved = int((moved_k == moved_p)[same].sum())
    rho_gap = ((qp_k.rho - qp_p.rho).abs() / qp_p.rho)[same & moved_k & moved_p]
    n_rho = int((rho_gap <= 0.25).sum())
    check(n_moved >= int(same.sum()) - B4 // 8,
          f"adaptive rho: rho moved on the same problems for only {n_moved}/{int(same.sum())}")
    check(n_rho >= rho_gap.numel() - B4 // 8,
          f"adaptive rho: final rho within 25% on only {n_rho}/{rho_gap.numel()} problems")
    box_viol, hard_ratio = hard_row_ratio(
        got.x, apply_A(ocp, sa4, got.x), lc, uc, lx, ux, kw["soft_c"], kw["soft_x"],
        s_ada, got.converged)
    check(hard_ratio <= 1.01, f"kernel 3 adaptive rho: hard rows at {hard_ratio:.3f}x the tolerance")
    log(f"phase 4d kernels 2 + 3 B={B4}, rho_update_every=100, budget {s_ada.max_iter}: {n3} "
        f"launches of kernel 3, {n2} of kernel 2, refactorizations kernel {nref_k}, plain "
        f"{nref_p}; {agreement}; of the {int(same.sum())} problems whose iteration counts are "
        f"equal rho moved or stayed alike on {n_moved}, and where it moved the final rho is "
        f"within 25% on {n_rho}/{rho_gap.numel()} (bars: all but {B4 // 8}; median gap "
        f"{float(rho_gap.median()) if rho_gap.numel() else 0.0:.2e}, largest "
        f"{float(rho_gap.max()) if rho_gap.numel() else 0.0:.2e}), range kernel "
        f"{float(qp_k.rho.min()):.3g}..{float(qp_k.rho.max()):.3g}, plain "
        f"{float(qp_p.rho.min()):.3g}..{float(qp_p.rho.max()):.3g}; hard box-row violation "
        f"{box_viol:.2e}, hard-row violation {hard_ratio:.3f}x the primal tolerance (bar 1.01)")
    # (e) the rescue budget on a batch that is no round number: a budget cut
    # to 100 leaves stragglers, which alone use the 200 rescue iterations
    Bo = B_ODD
    sa_o = qp_structured.StructuredA(sa4.p[:Bo], sa4.f_rows[:Bo], sa4.J[:Bo])
    args_o = tuple(a[:Bo] for a in args4)
    kw_o = {k: v[:Bo] for k, v in kw.items()}
    s_cut = dataclasses.replace(shipping, max_iter=100)
    s_res = dataclasses.replace(s_cut, rescue_iters=200)
    cut = k3.solve_box_qp_structured_cuda(ocp, sa_o, *args_o, s_cut, **kw_o)
    got = k3.solve_box_qp_structured_cuda(ocp, sa_o, *args_o, s_res, **kw_o)
    ref = qp_structured.solve_box_qp_structured(ocp, sa_o, *args_o, s_res, **kw_o)
    torch.cuda.synchronize()
    agreement = iteration_agreement(got, ref, Bo, "kernel 3 rescue")
    n_strag = int((~cut.converged).sum())
    n_rescued = int((got.converged & ~cut.converged).sum())
    check(0 < n_strag < Bo, f"rescue: {n_strag}/{Bo} stragglers at budget 100")
    check(int(got.iterations.max()) <= 300 and int(got.iterations[~cut.converged].min()) > 100,
          "rescue: stragglers did not run past the budget, or ran past the rescue budget")
    check(torch.equal(got.x[cut.converged], cut.x[cut.converged])
          and torch.equal(got.iterations[cut.converged], cut.iterations[cut.converged]),
          "rescue: a problem converged inside the budget changed")
    check(n_rescued > 0, "rescue: no straggler converged in 200 more iterations")
    log(f"phase 4e kernel 3 B={Bo}, budget 100 + rescue 200: {n_strag} stragglers at budget "
        f"100, {n_rescued} of them converge in the rescue iterations (most iterations "
        f"{int(got.iterations.max())}), the other {Bo - n_strag} problems bitwise as without "
        f"rescue; {agreement}")
    del sa_f, args_f, sc_f, sx_f

    # ---- phase 5: the structured main path at B=2048 ----
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = planner.solve(cur_all, tgt_all)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    counts = kernels.launch_counts()
    repairs = k2.REPAIRS.count
    check(counts == {"constraints": 5, "banded_factor": 2, "structured_admm": 2, "admm_dense": 0},
          f"structured path launch counts {counts}")
    for name in ("constraints", "banded_factor", "structured_admm"):
        results[name]["launches"] = counts[name]
    finite = all(bool(torch.isfinite(t).all()) for t in (sol.z, sol.violation, sol.lam_c, sol.lam_x))
    check(finite, "structured path produced non-finite outputs")
    q5 = quality(planner, sol, tgt_all)
    check(q5["tol_hit_rate"] >= 0.99, f"tol_hit_rate {q5['tol_hit_rate']}")
    check(q5["qp_conv_rate"] >= 0.98, f"qp_conv_rate {q5['qp_conv_rate']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    planner.solve(cur_all, tgt_all)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    log(f"phase 5 structured path B={B_MAIN} (headline states): launches {counts}, ok-flag "
        f"repairs {repairs}, quality {json.dumps(q5)}; JAX record on these states "
        f"{json.dumps(JAX_RECORD)}")
    log(f"phase 5 timing: cold solve {t_cold:.3f} s, warm solve {t_warm:.3f} s = "
        f"{B_MAIN / t_warm:.1f} solves/s on {smi}")
    del sol

    # ---- phase 5b: the structured path at its default settings (adaptive
    # rho every 100 iterations, budgets 700/700) on the same states ----
    default_qp = dense_qp.QPSettings(backend="structured")
    default_planner = MotionPlanner(margins=Margins(*MARGINS), dtype=f32, device=dev,
                                    qp_settings=default_qp, sqp_settings=SQPSettings())
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = default_planner.solve(cur_all, tgt_all)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    counts_b, refactors = kernels.launch_counts(), k3.REFACTORS.count
    n_chunks = len(qp_structured.chunk_sizes(default_qp))
    check(counts_b == {"constraints": 5, "banded_factor": 2 + refactors,
                       "structured_admm": 2 * n_chunks, "admm_dense": 0},
          f"default structured path launch counts {counts_b}, {refactors} refactorizations")
    check(refactors > 0, "default structured path never refactored")
    finite = all(bool(torch.isfinite(t).all()) for t in (sol.z, sol.violation, sol.lam_c, sol.lam_x))
    check(finite, "default structured path produced non-finite outputs")
    q5b = quality(default_planner, sol, tgt_all)
    check(q5b["tol_hit_rate"] >= 0.99,
          f"default structured path tol_hit_rate {q5b['tol_hit_rate']}")
    del sol
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    default_planner.solve(cur_all, tgt_all)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    log(f"phase 5b structured path at QPSettings(backend='structured') defaults B={B_MAIN}: "
        f"launches {counts_b}, refactorizations {refactors}, ok-flag repairs {k2.REPAIRS.count}, "
        f"quality {json.dumps(q5b)}; qp_conv_rate {q5b['qp_conv_rate']:.5f} beside the "
        f"shipping configuration's {q5['qp_conv_rate']:.5f}")
    log(f"phase 5b timing: cold solve {t_cold:.3f} s, warm solve {t_warm:.3f} s = "
        f"{B_MAIN / t_warm:.1f} solves/s on {smi}")

    # ---- phase 5c: a hot restart on the shipping path: a cold solve, then a
    # solve seeded with its iterate and duals towards targets whose joint
    # positions moved by 0.01 rad, through the port's example ----
    from mpc_motion_planner_tpu_torch.examples import hot_restart

    cold_row, hot_row = hot_restart.receding_chain(
        planner, cur_all, tgt_all, steps=2, fraction=0.0, hot=True, target_shift=0.01)
    cold, hot = cold_row["solution"], hot_row["solution"]
    check(cold.warm_start is not None and hot.warm_start is None,
          "the hot restart planned an OTG trajectory")
    it_cold, it_hot = (float(s_.qp_iterations.sum(-1).float().median()) for s_ in (cold, hot))
    check(it_hot < it_cold, f"hot restart: median QP iterations {it_hot} against the cold solve's "
          f"{it_cold}")
    q5c = quality(planner, hot, hot_row["target"])
    check(q5c["tol_hit_rate"] >= 0.99, f"hot restart tol_hit_rate {q5c['tol_hit_rate']}")
    log(f"phase 5c hot restart B={B_MAIN} (structured shipping path, targets moved by 0.01 rad): "
        f"QP iterations per solve, median over the batch: cold {it_cold:.0f}, restart "
        f"{it_hot:.0f}; per SQP step cold {cold.qp_iterations.float().median(0).values.tolist()}, "
        f"restart {hot.qp_iterations.float().median(0).values.tolist()}; wall cold "
        f"{cold_row['wall_ms']:.1f} ms, restart {hot_row['wall_ms']:.1f} ms; restart quality "
        f"{json.dumps(q5c)}")
    del cold, hot, cold_row, hot_row

    # ---- phase 6: the JAX structured fixture ----
    n_good, n_fx, summary = fixture_agreement(planner, FIXTURE, dev)
    check(n_good >= n_fx - 4, f"only {n_good}/{n_fx} fixture problems agree with the JAX reference")
    log(f"phase 6 JAX structured fixture: {summary}")

    # ---- phase 7: kernel 4 against its plain version ----
    dense_cfg = dense_qp.QPSettings(
        backend="pallas", kkt_refine=1, rho_update_every=0, kkt_factor="lu", ruiz_iters=2,
        rho=0.1, alpha=1.6, max_iter=700, check_every=25,
    )
    args7, dq7, sc7, sx7 = first_qp(B_ADMM, dense=True, settings=dense_cfg)
    rho7 = torch.full((B_ADMM,), dense_cfg.rho, dtype=f32, device=dev)
    ops7 = dense_qp.pallas_operands(dq7, rho7, dq7.factor(rho7, dense_cfg))
    st7 = dense_qp.pallas_state(dq7)
    ckw = dict(check_every=dense_cfg.check_every, eps_abs=dense_cfg.eps_abs,
               eps_rel=dense_cfg.eps_rel, sigma=dense_cfg.sigma, alpha=dense_cfg.alpha,
               kkt_refine=dense_cfg.kkt_refine)
    to64 = lambda d: {k: (v.double() if v.is_floating_point() else v) for k, v in d.items()}

    def window(ops, st, what):
        """One check window: the kernel may stray from a float64 run of the
        plain chunk no further than 2x the plain float32 chunk does; done
        and used agree."""
        n_it = dense_cfg.check_every
        sk, uk = k4.admm_dense_kernel(ops, st, chunk_iters=n_it, **ckw)
        sp, up = k4.admm_dense_plain(ops, st, chunk_iters=n_it, **ckw)
        s64, _ = k4.admm_dense_plain(to64(ops), to64(st), chunk_iters=n_it, **ckw)
        torch.cuda.synchronize()
        e_k, e_p = max_abs(sk["x"], s64["x"]), max_abs(sp["x"], s64["x"])
        check(e_k <= 2 * e_p + 1e-6,
              f"kernel 4 {what}: strays from float64 by {e_k:.3e}, the plain float32 chunk "
              f"by {e_p:.3e}")
        check(torch.equal(sk["done"], sp["done"]) and torch.equal(uk, up),
              f"kernel 4 {what}: done/used differ from the plain chunk")
        return e_k, e_p, max_abs(sk["x"], sp["x"])

    # (a) one check window on identical scaled data and M^-1
    e_k, e_p, e_kp = window(ops7, st7, f"B={B_ADMM}")
    results["admm_dense"]["max_abs_err"] = e_kp
    log(f"phase 7a kernel 4 B={B_ADMM}: after {dense_cfg.check_every} iterations max "
        f"|x - x_float64| kernel {e_k:.3e}, plain {e_p:.3e} (bar: kernel <= 2x plain), max "
        f"|x_kernel - x_plain| {e_kp:.3e}, done/used identical")
    # (b) the full 700-iteration chunk, through the host part of the backend
    _, _, _, lc7, uc7, lx7, ux7 = args7
    A7 = args7[2]

    def dense_pair(settings):
        got = dense_qp.solve_pallas(dq7, settings, chunk_fn=k4.admm_dense_kernel)
        ref = dense_qp.solve_pallas(dq7, settings, chunk_fn=k4.admm_dense_plain)
        torch.cuda.synchronize()
        return got, ref

    got, ref = dense_pair(dense_cfg)
    agreement = iteration_agreement(got, ref, B_ADMM, "kernel 4 full chunk")
    box_viol, hard_ratio = hard_row_ratio(
        got.x, torch.einsum("bmn,bn->bm", A7, got.x), lc7, uc7, lx7, ux7, sc7, sx7,
        dense_cfg, got.converged)
    check(hard_ratio <= 1.01,
          f"kernel 4 converged problems violate hard rows by {hard_ratio:.3f}x the tolerance")
    log(f"phase 7b kernel 4 B={B_ADMM}, one {dense_cfg.max_iter}-iteration chunk: {agreement}, "
        f"hard box-row violation {box_viol:.2e}, hard-row violation {hard_ratio:.3f}x the "
        f"primal tolerance (bar 1.01)")
    # (c) adaptive rho: 100-iteration chunks with refactoring between them
    adaptive = dataclasses.replace(dense_cfg, rho_update_every=100)
    got, ref = dense_pair(adaptive)
    agree = int((got.converged == ref.converged).sum())
    check(agree >= B_ADMM - 2, f"kernel 4 adaptive rho: converged agrees on only {agree}/{B_ADMM}")
    log(f"phase 7c kernel 4 B={B_ADMM}, adaptive rho every 100: converged agree {agree}/{B_ADMM} "
        f"(kernel {int(got.converged.sum())}, plain {int(ref.converged.sum())}), iterations "
        f"median kernel {float(got.iterations.float().median())}, plain "
        f"{float(ref.iterations.float().median())}")
    # (d) a problem built to diverge: A = 0 and M^-1 = 20 I make zx grow by
    # 2.6x per iteration under the huge hard box, until the freeze
    ops_d = {k: v.clone() for k, v in ops7.items()}
    ops_d["A"][0] = 0.0
    ops_d["M_inv"][0] = 20.0 * torch.eye(ops_d["M_inv"].shape[-1], device=dev)
    ops_d["q"][0] = -1.0
    ops_d["lx"][0], ops_d["ux"][0], ops_d["sx"][0] = -1e20, 1e20, 1e20
    sk, uk = k4.admm_dense_kernel(ops_d, st7, chunk_iters=100, **ckw)
    sp, up = k4.admm_dense_plain(ops_d, st7, chunk_iters=100, **ckw)
    # the same chunk without the diverging problem: the other problems'
    # results may not change (each problem is independent)
    sk0, uk0 = k4.admm_dense_kernel(ops7, st7, chunk_iters=100, **ckw)
    torch.cuda.synchronize()
    check(int(sk["done"][0]) == 2 and int(sp["done"][0]) == 2,
          f"kernel 4 diverging problem: done kernel {int(sk['done'][0])}, plain {int(sp['done'][0])}")
    check(int(uk[0]) == int(up[0]), f"kernel 4 froze at {int(uk[0])}, plain at {int(up[0])}")
    check(not bool((sk["done"][1:] == 2).any()), "kernel 4 froze a problem that does not diverge")
    check(torch.equal(sk["done"][1:], sk0["done"][1:]) and torch.equal(uk[1:], uk0[1:])
          and torch.equal(sk["x"][1:], sk0["x"][1:]), "kernel 4 freeze leaked across problems")
    # the freeze's shared index axis at the path's n, m: after one iteration
    # with A = 0, M^-1 = I, alpha = 1, sigma = 0 and q = -X, x = X, yx = 0 and
    # yc keeps its value (hard equality rows at 0). Problem 0: x_0 = yc_0 =
    # 0.6e12, only their sum crosses 1e12; 1: the same values at different
    # indices; 2: yc at a row index past n; 3: NaN in yx
    m7, n7 = ops7["A"].shape[1:]
    vec = lambda k, v: torch.full((4, k), v, dtype=f32, device=dev)
    X_t, yc_t, yx_t = vec(n7, 0.0), vec(m7, 0.0), vec(n7, 0.0)
    X_t[0, 0], yc_t[0, 0] = 0.6e12, 0.6e12
    X_t[1, 0], yc_t[1, 1] = 0.6e12, 0.6e12
    yc_t[2, m7 - 1] = 2e12
    yx_t[3, 1] = float("nan")
    ops_s = {
        "M_inv": torch.eye(n7, device=dev).expand(4, n7, n7).contiguous(),
        "A": torch.zeros(4, m7, n7, device=dev), "P": vec(n7, 0.0), "q": -X_t,
        "lx": vec(n7, -1e20), "ux": vec(n7, 1e20), "rx": vec(n7, 0.1), "D": vec(n7, 1.0),
        "sx": vec(n7, 1e20), "lc": vec(m7, 0.0), "uc": vec(m7, 0.0), "rc": vec(m7, 100.0),
        "E": vec(m7, 1.0), "sc": vec(m7, 1e20),
    }
    st_s = {"x": vec(n7, 0.0), "zc": vec(m7, 0.0), "zx": vec(n7, 0.0), "yc": yc_t, "yx": yx_t,
            "done": torch.zeros(4, dtype=torch.int32, device=dev)}
    skw = dict(chunk_iters=1, check_every=1, eps_abs=1e-3, eps_rel=1e-3, sigma=0.0, alpha=1.0,
               kkt_refine=0)
    done_k = k4.admm_dense_kernel(ops_s, st_s, **skw)[0]["done"].tolist()
    done_p = k4.admm_dense_plain(ops_s, st_s, **skw)[0]["done"].tolist()
    check(done_k == done_p == [2, 0, 2, 2],
          f"kernel 4 shared-axis freeze: done kernel {done_k}, plain {done_p}, want [2, 0, 2, 2]")
    log(f"phase 7d kernel 4: the diverging problem froze with done=2 after {int(uk[0])} "
        f"iterations in the kernel and {int(up[0])} in the plain chunk; no other problem "
        f"froze, and their done codes, counts and x are bitwise those of the chunk without "
        f"the diverging problem; shared-axis freeze at n={n7}, m={m7} (sum of x_0 and yc_0, "
        f"same values apart, yc past n, NaN): done kernel {done_k}, plain {done_p}")
    # (e) a batch that is no round number
    _, dq_odd, _, _ = first_qp(B_ODD, dense=True, settings=dense_cfg)
    rho_odd = torch.full((B_ODD,), dense_cfg.rho, dtype=f32, device=dev)
    e_k, e_p, e_kp = window(dense_qp.pallas_operands(dq_odd, rho_odd, dq_odd.factor(rho_odd, dense_cfg)),
                            dense_qp.pallas_state(dq_odd), f"B={B_ODD}")
    log(f"phase 7e kernel 4 B={B_ODD}: after {dense_cfg.check_every} iterations max "
        f"|x - x_float64| kernel {e_k:.3e}, plain {e_p:.3e}, max |x_kernel - x_plain| "
        f"{e_kp:.3e}, done/used identical")
    # (f) an (n, m) that the cluster's 8 blocks do not divide: the slices of
    # M^-1 have 4, ..., 4, 3, 0 rows, those of A 3, ..., 3, 0, and a row is
    # no multiple of 16 bytes
    n_f, m_f = 27, 21
    ops_f, st_f = random_dense_chunk(B_ODD, n_f, m_f, 7, dev)
    fkw = dict(ckw, chunk_iters=50, check_every=10)
    sk, uk = k4.admm_dense_kernel(ops_f, st_f, **fkw)
    sp, up = k4.admm_dense_plain(ops_f, st_f, **fkw)
    s64, _ = k4.admm_dense_plain(to64(ops_f), to64(st_f), **fkw)
    torch.cuda.synchronize()
    e_k, e_p = max_abs(sk["x"], s64["x"]), max_abs(sp["x"], s64["x"])
    check(e_k <= 2 * e_p + 1e-6, f"kernel 4 n={n_f}, m={m_f}: strays from float64 by {e_k:.3e}, "
          f"the plain float32 chunk by {e_p:.3e}")
    check(torch.equal(sk["done"], sp["done"]) and torch.equal(uk, up),
          f"kernel 4 n={n_f}, m={m_f}: done/used differ from the plain chunk")
    log(f"phase 7f kernel 4 B={B_ODD}, n={n_f}, m={m_f} (ragged slices): after up to 50 "
        f"iterations max |x - x_float64| kernel {e_k:.3e}, plain {e_p:.3e}, done/used identical "
        f"({int((sk['done'] == 1).sum())} converged)")
    occ4 = k4.cluster_occupancy(n7, m7)
    check(occ4["max_active_clusters"] >= 1, f"kernel 4 cluster occupancy {occ4}")
    log(f"phase 7 kernel 4 occupancy at n={n7}, m={m7}: clusters of {occ4['cluster_size']} blocks, "
        f"{occ4['smem_bytes']} B of dynamic shared memory per block, "
        f"cudaOccupancyMaxActiveClusters = {occ4['max_active_clusters']}")
    del dq7, ops7, st7, ops_d, dq_odd, ops_f, st_f

    # ---- phase 8: the dense path at B=2048 ----
    dense_planner = MotionPlanner(
        margins=Margins(*MARGINS), dtype=f32, device=dev, qp_settings=dense_cfg,
        sqp_settings=SQPSettings(),
    )
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = dense_planner.solve(cur_all, tgt_all)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(counts == {"constraints": 5, "banded_factor": 0, "structured_admm": 0, "admm_dense": 2},
          f"dense path launch counts {counts}")
    results["admm_dense"]["launches"] = counts["admm_dense"]
    finite = all(bool(torch.isfinite(t).all()) for t in (sol.z, sol.violation, sol.lam_c, sol.lam_x))
    check(finite, "dense path produced non-finite outputs")
    q8 = quality(dense_planner, sol, tgt_all)
    check(q8["tol_hit_rate"] >= 0.99, f"dense path tol_hit_rate {q8['tol_hit_rate']}")
    del sol
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense_planner.solve(cur_all, tgt_all)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    log(f"phase 8 dense path B={B_MAIN} (headline states, backend pallas, kkt_refine 1): launches "
        f"{counts}, quality {json.dumps(q8)}")
    log(f"phase 8 timing: cold solve {t_cold:.3f} s, warm solve {t_warm:.3f} s = "
        f"{B_MAIN / t_warm:.1f} solves/s on {smi}")

    # ---- phase 9: the JAX dense fixture ----
    n_good, n_fx, summary = fixture_agreement(dense_planner, DENSE_FIXTURE, dev)
    check(n_good >= n_fx - 4,
          f"only {n_good}/{n_fx} dense fixture problems agree with the JAX reference")
    log(f"phase 9 JAX dense fixture: {summary}")

    # ---- phase 10: each kernel against its plain version at main-path
    # shapes, timed, and the outputs of the last timed calls compared ----
    out = {}

    def keep(key, fn):
        def call():
            out[key] = fn()
        return call

    z0, sa, args, sc, sx = first_qp(B_MAIN)
    X, U, _ = ocp.unpack(z0)
    p_ms, k_ms, raw = time_pair(
        keep("plain", lambda: k1.node_constraints_plain(ocp, X, U, True)),
        keep("kernel", lambda: k1.node_constraints_kernel(ocp, X, U, True)),
    )
    (g_k, J_k), (g_p, J_p) = out["kernel"], out["plain"]
    check(torch.allclose(g_k, g_p, rtol=2e-5, atol=2e-5)
          and torch.allclose(J_k, J_p, rtol=2e-4, atol=5e-5),
          f"kernel 1 differs on the step-0 iterates: values {max_abs(g_k, g_p)}, "
          f"Jacobian {max_abs(J_k, J_p)}")
    # the launch is shorter than the wrapper's host time, so the kernel's
    # own time is taken with the launches queued behind a long product
    big = torch.ones(8192, 8192, device=dev)
    busy = lambda: big @ big
    d_ms = time_kernel(lambda: k1.node_constraints_kernel(ocp, X, U, True), reps=20, behind=busy)
    results["constraints"].update(ms=d_ms, plain_ms=p_ms)
    F = X.shape[0] * X.shape[1]
    text = report_bound(results["constraints"], F * K1_JAC_FLOPS,
                        tensor_bytes(X, U, g_k, J_k), "value pass and 21 tangents")
    log(f"phase 10 kernel 1 with Jacobian F={F}: kernel {d_ms:.4f} ms on the device's clock "
        f"({k_ms:.3f} ms per wrapper call on an idle card, host time included), "
        f"plain {p_ms:.3f} ms (runs {raw}); {text}; on the step-0 iterates max abs err values "
        f"{max_abs(g_k, g_p):.3e}, Jacobian {max_abs(J_k, J_p):.3e} (phase 2's tolerances)")
    del g_k, J_k, g_p, J_p
    out.clear()
    Xl, Ul, _ = ocp.unpack(z0.repeat(10, 1))  # views of the iterates, as the line search's
    p_ms, k_ms, raw = time_pair(
        lambda: k1.node_constraints_plain(ocp, Xl, Ul, False),
        lambda: k1.node_constraints_kernel(ocp, Xl, Ul, False),
    )
    d_ms = time_kernel(lambda: k1.node_constraints_kernel(ocp, Xl, Ul, False), reps=20,
                       behind=busy)
    F = Xl.shape[0] * Xl.shape[1]
    b_ms, b_by = bound(F * K1_VALUE_FLOPS, tensor_bytes(Xl, Ul) + F * 8 * 4)
    log(f"phase 10 kernel 1 values only F={F}: kernel {d_ms:.4f} ms on the device's clock "
        f"({k_ms:.3f} ms per wrapper call on an idle card), plain {p_ms:.3f} ms (runs {raw}); "
        f"bound {b_ms:.4f} ms by {b_by}, share reached {100 * b_ms / d_ms:.1f}%")
    del Xl, Ul, big
    qp = qp_structured.scale_qp(ocp, sa, *args, shipping, soft_c=sc, soft_x=sx)
    p_ms, k_ms, raw = time_pair(
        keep("plain", lambda: qp_structured.factor_banded(qp.Mband, qp.p_col, qp.m_pp, 3)),
        keep("kernel", lambda: k2.factor_banded_kernel(qp.Mband, qp.p_col, qp.m_pp)),
    )
    fk, fp = out["kernel"], out["plain"]
    check(torch.equal(fk["ok"], fp["ok"]), f"kernel 2 ok flags differ at B={B_MAIN}")
    errs = {k: rel_err(fk[k], fp[k]) for k in ("Ldi", "Lsub", "u", "s")}
    check(max(errs.values()) <= 1e-3, f"kernel 2 differs at B={B_MAIN}: {errs}")
    results["banded_factor"].update(ms=k_ms, plain_ms=p_ms)
    text = report_bound(
        results["banded_factor"], B_MAIN * banded_factor_flops(),
        tensor_bytes(qp.Mband, qp.p_col, qp.m_pp, *fk.values()), "band in, factors out")
    log(f"phase 10 kernel 2 B={B_MAIN}: kernel {k_ms:.3f} ms ({per_sm2} problems per SM), "
        f"plain {p_ms:.3f} ms (runs {raw}); {text}; "
        f"ok flags identical ({int(fk['ok'].sum())}/{B_MAIN} ok), max-norm relative error "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()) + " (tol 1e-3)")
    del fk, fp
    out.clear()
    fac = k2.factor(qp.Mband, qp.p_col, qp.m_pp, 3)
    p_ms, k_ms, raw = time_pair(
        keep("plain", lambda: qp_structured.admm_plain(ocp, sa, qp, fac, shipping)),
        keep("kernel", lambda: k3.admm_kernel(ocp, sa, qp, fac, shipping)),
        reps=1,
    )
    got, ref = (qp_structured.unscale_solution(qp, *out[k]) for k in ("kernel", "plain"))
    k3_bytes = tensor_bytes(
        fac["Ldi"], fac["Lsub"], fac["u"], fac["s"], sa.J, sa.f_rows, sa.p,
        qp.qs, qp.Ps, qp.rx, qp.lxs, qp.uxs, qp.thx, qp.D, qp.x, qp.zx, qp.yx,
        qp.rc, qp.lcs, qp.ucs, qp.E, qp.thr, qp.zc, qp.yc, *out["kernel"])
    k3_iters = int(out["kernel"][6].sum())
    out.clear()
    agreement = iteration_agreement(got, ref, B_MAIN, f"kernel 3 B={B_MAIN}")
    _, lc, uc, lx, ux = args[1:]
    ratios = [hard_row_ratio(s.x, apply_A(ocp, sa, s.x), lc, uc, lx, ux, sc, sx, shipping,
                             s.converged) for s in (got, ref)]
    check(ratios[0][1] <= 1.01,
          f"kernel 3 B={B_MAIN}: converged problems violate hard rows by "
          f"{ratios[0][1]:.3f}x the tolerance")
    results["structured_admm"].update(ms=k_ms, plain_ms=p_ms)
    text = report_bound(results["structured_admm"], k3_iters * K3_ITER_FLOPS, k3_bytes,
                        f"{k3_iters} problem-iterations as the kernel counted them")
    log(f"phase 10 kernel 3 B={B_MAIN}, step-0 QP, budget {shipping.max_iter}: kernel "
        f"{k_ms:.3f} ms, plain {p_ms:.3f} ms (runs {raw}); {text}; {agreement}; hard box-row "
        f"violation kernel {ratios[0][0]:.2e}, plain {ratios[1][0]:.2e}; hard-row violation "
        f"{ratios[0][1]:.3f}x the primal tolerance (bar 1.01; plain {ratios[1][1]:.3f}x)")
    del got, ref
    # at a cap of one check window every problem runs exactly that many
    # iterations, which gives the loop's cost per iteration
    s_win = dataclasses.replace(shipping, max_iter=shipping.check_every)
    p_ms, k_ms, raw = time_pair(
        lambda: qp_structured.admm_plain(ocp, sa, qp, fac, s_win),
        lambda: k3.admm_kernel(ocp, sa, qp, fac, s_win),
        reps=1,
    )
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = k3.blocks_per_sm()  # from the launch's occupancy
    waves = -(-B_MAIN // (sms * per_sm))
    b_ms, b_by = bound(B_MAIN * s_win.max_iter * K3_ITER_FLOPS, k3_bytes)
    log(f"phase 10 kernel 3 B={B_MAIN}, exactly {s_win.max_iter} iterations: kernel "
        f"{k_ms:.3f} ms = {1e3 * k_ms / s_win.max_iter / waves:.2f} us per iteration per "
        f"block ({waves} waves of {sms} x {per_sm} blocks), plain {p_ms:.3f} ms (runs {raw}); "
        f"bound {b_ms:.4f} ms by {b_by}, share reached {100 * b_ms / k_ms:.1f}%")
    # the same two launches with one refinement step on every KKT solve
    s_ref = dataclasses.replace(shipping, kkt_refine=1)
    for what, s_ in ((f"budget {s_ref.max_iter}", s_ref),
                     (f"exactly {s_win.max_iter} iterations",
                      dataclasses.replace(s_ref, max_iter=s_win.max_iter))):
        k_ms = time_kernel(keep("kernel", lambda: k3.admm_kernel(ocp, sa, qp, fac, s_)))
        n_it = int(out["kernel"][6].sum())
        conv = float((out["kernel"][5] == 1).double().mean())
        out.clear()
        b_ms, b_by = bound(n_it * (K3_ITER_FLOPS + K3_REFINE_FLOPS), k3_bytes)
        log(f"phase 10 kernel 3 B={B_MAIN}, kkt_refine=1, {what}: kernel {k_ms:.3f} ms, "
            f"{n_it} problem-iterations of {(K3_ITER_FLOPS + K3_REFINE_FLOPS) / 1e3:.0f} kflop "
            f"({1e3 * k_ms * sms * per_sm / n_it:.2f} us per iteration per block at full "
            f"occupancy), converged {conv:.4f}; bound {b_ms:.4f} ms by {b_by}, share reached "
            f"{100 * b_ms / k_ms:.1f}%")
    del z0, sa, args, qp, fac

    args10, dq, sc10, sx10 = first_qp(B_MAIN, dense=True, settings=dense_cfg)
    rho = torch.full((B_MAIN,), dense_cfg.rho, dtype=f32, device=dev)
    ops = dense_qp.pallas_operands(dq, rho, dq.factor(rho, dense_cfg))
    st = dense_qp.pallas_state(dq)
    D10 = dq.D
    del dq
    p_ms, k_ms, raw = time_pair(
        keep("plain", lambda: k4.admm_dense_plain(
            ops, st, chunk_iters=dense_cfg.max_iter, **ckw)),
        keep("kernel", lambda: k4.admm_dense_kernel(
            ops, st, chunk_iters=dense_cfg.max_iter, **ckw)),
        reps=1,
    )
    # the chunk's done codes and counts as a solution: 1 converged, 2 frozen
    got, ref = (dense_qp.QPSolution(
        x=D10 * s["x"], y_constraints=s["yc"], y_box=s["yx"], converged=s["done"] == 1,
        iterations=u, prim_residual=None, dual_residual=None)
        for s, u in (out["kernel"], out["plain"]))
    done_k, done_p = out["kernel"][0]["done"], out["plain"][0]["done"]
    k4_iters = int(out["kernel"][1].sum())
    k4_bytes = tensor_bytes(*ops.values(), *st.values(), *out["kernel"][0].values(),
                            out["kernel"][1])
    out.clear()
    agreement = iteration_agreement(got, ref, B_MAIN, f"kernel 4 B={B_MAIN}")
    check(torch.equal(done_k == 2, done_p == 2),
          f"kernel 4 B={B_MAIN}: frozen problems kernel {int((done_k == 2).sum())}, plain "
          f"{int((done_p == 2).sum())}, not the same ones")
    _, _, A10, lc, uc, lx, ux = args10
    ratios = [hard_row_ratio(s.x, torch.einsum("bmn,bn->bm", A10, s.x), lc, uc, lx, ux,
                             sc10, sx10, dense_cfg, s.converged) for s in (got, ref)]
    check(ratios[0][1] <= 1.01,
          f"kernel 4 B={B_MAIN}: converged problems violate hard rows by "
          f"{ratios[0][1]:.3f}x the tolerance")
    results["admm_dense"].update(ms=k_ms, plain_ms=p_ms)
    m, n = ops["A"].shape[1:]
    # per problem-iteration: (2 + 2 kkt_refine) products with A and
    # (1 + kkt_refine) with M^-1, 2 flops per entry
    k4_iter_flops = 2 * ((2 + 2 * dense_cfg.kkt_refine) * m * n + (1 + dense_cfg.kkt_refine) * n * n)
    text = report_bound(results["admm_dense"], k4_iters * k4_iter_flops, k4_bytes,
                        f"{k4_iters} problem-iterations as the kernel counted them, A and "
                        f"M^-1 read once, as the cluster-resident kernel reads them")
    log(f"phase 10 kernel 4 B={B_MAIN}, step-0 dense QP, one {dense_cfg.max_iter}-iteration "
        f"chunk: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms (runs {raw}); {text}; {agreement}; done "
        f"codes identical on {int((done_k == done_p).sum())}/{B_MAIN}, frozen kernel "
        f"{int((done_k == 2).sum())}, plain {int((done_p == 2).sum())} (the same problems); "
        f"hard box-row violation kernel {ratios[0][0]:.2e}, plain {ratios[1][0]:.2e}; "
        f"hard-row violation {ratios[0][1]:.3f}x the primal tolerance (bar 1.01; plain "
        f"{ratios[1][1]:.3f}x)")
    del got, ref, args10, A10
    n_it = dense_cfg.check_every
    p_ms, k_ms, raw = time_pair(
        lambda: k4.admm_dense_plain(ops, st, chunk_iters=n_it, **ckw),
        lambda: k4.admm_dense_kernel(ops, st, chunk_iters=n_it, **ckw),
        reps=1,
    )
    # per problem-iteration the passes over A and M^-1 touch (2 + 2 kkt_refine)
    # m n + (1 + kkt_refine) n n entries: from shared memory in the kernel,
    # from device memory in the plain chunk
    it_bytes = 4 * ((2 + 2 * dense_cfg.kkt_refine) * m * n + (1 + dense_cfg.kkt_refine) * n * n)
    total = B_MAIN * (n_it * it_bytes + 4 * 2 * m * n)
    waves = -(-B_MAIN // occ4["max_active_clusters"])
    b_ms, b_by = bound(B_MAIN * n_it * k4_iter_flops, k4_bytes)
    log(f"phase 10 kernel 4 B={B_MAIN}, exactly {n_it} iterations: kernel {k_ms:.3f} ms = "
        f"{1e3 * k_ms / n_it / waves:.2f} us per iteration per cluster ({waves} waves of "
        f"{occ4['max_active_clusters']} clusters; {it_bytes / 1e6:.2f} MB of matrix passes per "
        f"problem-iteration, out of shared memory), plain {p_ms:.3f} ms = "
        f"{total / (p_ms * 1e-3) / 1e9:.0f} GB/s from device memory (runs {raw}); bound "
        f"{b_ms:.4f} ms by {b_by}, share reached {100 * b_ms / k_ms:.1f}%")

    del ops, st, D10
    entry_points(planner)

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
