"""Headline benchmark of the PyTorch port: batched minimum-time solves per
second on one device.

Counterpart of ``mpc_motion_planner_tpu/bench/headline.py``: the Panda
benchmark workload (margins 0.8/0.8/0.6/0.9/0.1, chained start states,
jerk-limited warm start, 2 SQP steps of at most 700 ADMM iterations at eps
1e-3) as one batched ``MotionPlanner.solve`` at float32, TF32 off. It reads
the JAX headline's environment variables and prints one JSON line with
every key of the JAX line, plus ``package`` and ``states``:

    python -m mpc_motion_planner_tpu_torch.bench.headline [--device cpu]

* States: the JAX headline's own B=2048 chain
  (``tests/fixtures/headline_states_b2048.npz``), its first ``BENCH_BATCH``;
  a larger batch is drawn with the port's ``chain_states`` from
  ``torch.Generator`` seed 0.
* ``BENCH_QP_BACKEND``: "structured_pallas" (default), "structured",
  "pallas" or "xla"; the device decides kernel or plain (``config.py``).
  A failure raises: there is no fallback to another backend.
* ``MPC_TPU_FUSED_CONSTRAINTS`` ("auto", "on", "off"), read by the
  planner's ``make_ocp``: where the constraint rows go ("auto": kernel 1
  on the card). The line's ``fused_constraints`` says what ran: "on"
  (kernel 1) or "off" (the plain path).
* An explicit ``BENCH_QP_MAX_ITER`` or ``BENCH_EXIT_*`` budget wins: unless
  ``BENCH_SQP_SCHEDULES`` is also set, no per-step schedule replaces it.
* ``BENCH_EXIT_EVERY``/``_WARMUP``/``_SCHEDULE`` and ``BENCH_CHUNK`` say
  how the JAX package splits a solve into dispatches; they do not change
  results, and the port solves the batch in one call. The first three are
  recorded in the line.
* Timing, on the card: the solve is captured into a CUDA graph
  (``utils/capture.py``, the counterpart of the JAX headline's
  ``jax.jit``); the capture is the cold run and is not timed, as the JAX
  compile is not. ``value`` = batch / the fastest of ``BENCH_REPEATS``
  replays, each between two device synchronisations (``solve``:
  "cuda_graph"). Beside it, ``eager_batch_wall_s`` and ``eager_solves_per_s``
  from as many eager solves in the same process, the problems that kernel 2
  flagged in the timed solves (``repairs``) and the timed solves done again
  eagerly after a repair overflow (``eager_resolves``).
  On the CPU the solve is eager (``solve``: "eager") and the eager keys are
  the same solves.

Runs on the GPU unless ``--device cpu`` (or ``BENCH_DEVICE=cpu``) is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .. import config
from ..kernels import banded_factor
from ..ops.qp import DENSE_BACKENDS, STRUCTURED_BACKENDS, QPSettings
from ..ops.sqp import SQPSettings
from ..planner import Margins, MotionPlanner
from ..utils.capture import capture_solve
from .harness import chain_states

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STATES = os.path.join(ROOT, "tests", "fixtures", "headline_states_b2048.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)
# solves/s of the estimated single-core C++ figure (BASELINE.md)
BASELINE_SOLVES_PER_S = 50.0
BUDGET_VARIABLES = ("BENCH_QP_MAX_ITER", "BENCH_EXIT_EVERY", "BENCH_EXIT_WARMUP",
                    "BENCH_EXIT_SCHEDULE")


def settings_from_env(env=os.environ) -> dict:
    """The run's settings from the JAX headline's environment variables."""
    backend = env.get("BENCH_QP_BACKEND", "structured_pallas")
    if backend not in STRUCTURED_BACKENDS + DENSE_BACKENDS:
        raise ValueError(f"BENCH_QP_BACKEND {backend!r} is none of "
                         f"{STRUCTURED_BACKENDS + DENSE_BACKENDS}")
    s = {
        "batch": int(env.get("BENCH_BATCH", "2048")),
        "repeats": int(env.get("BENCH_REPEATS", "3")),
        "backend": backend,
        "kkt_refine": int(env.get("BENCH_KKT_REFINE",
                                  "0" if backend in STRUCTURED_BACKENDS else "1")),
        "rho_update_every": int(env.get("BENCH_RHO_EVERY", "0")),
        "max_iter": int(env.get("BENCH_QP_MAX_ITER", "700")),
        "check_every": int(env.get("BENCH_CHECK_EVERY", "25")),
        "kkt_factor": env.get("BENCH_KKT_FACTOR", "lu"),
        "ruiz_iters": int(env.get("BENCH_RUIZ_ITERS", "2")),
        "exit_every": int(env.get("BENCH_EXIT_EVERY", "400")),
        "exit_warmup": int(env.get("BENCH_EXIT_WARMUP", "300")),
        "exit_schedule": env.get("BENCH_EXIT_SCHEDULE", ""),
        "rescue_iters": int(env.get("BENCH_RESCUE_ITERS", "0")),
        "rho": float(env.get("BENCH_RHO", "0.1")),
        "alpha": float(env.get("BENCH_ALPHA", "1.6")),
        "baseline": float(env.get("BENCH_BASELINE", "0")) or BASELINE_SOLVES_PER_S,
    }
    schedules = env.get("BENCH_SQP_SCHEDULES")
    if schedules is None:
        explicit = any(v in env for v in BUDGET_VARIABLES)
        schedules = "" if explicit else "auto"
    s["sqp_schedules"] = (config.shipping_sqp_schedules(backend) if schedules == "auto"
                          else schedules)
    return s


def make_planner(s: dict, device) -> MotionPlanner:
    qp = QPSettings(
        backend=s["backend"], kkt_refine=s["kkt_refine"], rho_update_every=s["rho_update_every"],
        max_iter=s["max_iter"], check_every=s["check_every"], kkt_factor=s["kkt_factor"],
        rescue_iters=s["rescue_iters"], ruiz_iters=s["ruiz_iters"], rho=s["rho"],
        alpha=s["alpha"],
    )
    return MotionPlanner(margins=Margins(*MARGINS), qp_settings=qp,
                         sqp_settings=SQPSettings(qp_step_schedules=s["sqp_schedules"]),
                         dtype=torch.float32, device=device)


def headline_states(planner: MotionPlanner, batch: int):
    """(current, target, where they came from) for ``batch`` problems."""
    if batch <= 2048 and os.path.exists(STATES):
        states = np.load(STATES)
        as_t = lambda k: torch.as_tensor(states[k][:batch], dtype=planner.dtype,
                                         device=planner.device)
        return as_t("current"), as_t("target"), f"{os.path.relpath(STATES, ROOT)}[:{batch}]"
    current, target = chain_states(planner, torch.Generator().manual_seed(0), batch)
    return current, target, f"chain_states(torch.Generator seed 0, {batch})"


def quality_fields(planner: MotionPlanner, sol, target) -> dict:
    """The quality fields of the headline line, unrounded: the terminal
    error of the trajectory interpolated at t=1 (``tol_hit_rate`` against
    target_eps + eps_abs) and of the last collocation node, the l1
    violation's median and p90, the share of converged QPs."""
    X, _, _ = sol.states()
    err_sim = (sol.x_at(1.0) - target).abs().amax(-1)
    err_node = (X[:, -1] - target).abs().amax(-1)
    tol = planner.target_eps + planner.qp_settings.eps_abs
    viol = sol.violation.double().cpu().numpy()
    return {
        "tol_hit_rate": float((err_sim <= tol).double().mean()),
        "tol_threshold": tol,
        "terminal_err_inf_max": float(err_sim.max()),
        "node_terminal_err_max": float(err_node.max()),
        "median_violation": float(np.median(viol)),
        "p90_violation": float(np.percentile(viol, 90)),
        "qp_conv_rate": float(sol.qp_converged.double().mean()),
    }


def device_name(device: torch.device) -> str:
    """The card's name and power limit, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        power = smi.split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError):
        power = "power limit not read"
    return f"{torch.cuda.get_device_name(device)}, {power}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=os.environ.get("BENCH_DEVICE", "cuda"),
                    choices=["cuda", "cpu"])
    a = ap.parse_args(argv)
    s = settings_from_env()
    config.full_precision()
    device = torch.device(a.device)
    planner = make_planner(s, device)
    current, target, source = headline_states(planner, s["batch"])

    def timed(fn):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        sol = fn(current, target)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0, sol

    # cold: the capture (kernels built at first use, then the graph)
    captured = capture_solve(planner, current, target)
    repairs0 = banded_factor.REPAIRS.count
    times, sol = [], None
    for _ in range(s["repeats"]):
        t, sol = timed(captured)
        times.append(t)
    repairs = banded_factor.REPAIRS.count - repairs0
    eager = [timed(planner.solve)[0] for _ in range(s["repeats"])] if captured.captured else times
    best, best_eager = min(times), min(eager)
    solves_per_s = s["batch"] / best
    result = {
        "metric": "solves_per_s",
        "value": solves_per_s,
        "unit": "solves/s",
        "vs_baseline": solves_per_s / s["baseline"],
        "batch": s["batch"],
        "batch_wall_s": best,
        # batch wall time / batch: no latency percentile
        "amortized_ms_per_solve": 1e3 * best / s["batch"],
        **quality_fields(planner, sol, target),
        "qp_max_iter": s["max_iter"],
        "kkt_refine": s["kkt_refine"],
        "exit_every": s["exit_every"],
        "exit_warmup": s["exit_warmup"],
        "exit_schedule": s["exit_schedule"],
        "sqp_schedules": s["sqp_schedules"],
        "rescue_iters": s["rescue_iters"],
        "ruiz_iters": s["ruiz_iters"],
        "rho": s["rho"],
        "alpha": s["alpha"],
        # what computed the constraint rows: kernel 1 ("on") or the plain path
        "fused_constraints": "on" if planner.ocp.uses_kernel(device) else "off",
        "qp_backend": s["backend"],
        "device": device_name(device),
        "package": "torch",
        "states": source,
        "solve": "cuda_graph" if captured.captured else "eager",
        "eager_batch_wall_s": best_eager,
        "eager_solves_per_s": s["batch"] / best_eager,
        "repairs": repairs,
        "eager_resolves": captured.eager_resolves,
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
