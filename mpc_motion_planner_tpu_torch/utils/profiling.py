"""Profiling and tracing of the PyTorch port.

Counterpart of ``mpc_motion_planner_tpu/utils/profiling.py``:

* :func:`trace`: ``torch.profiler`` over a block (host, and the card when
  there is one), written as a Chrome trace into a directory.
* :func:`time_fn`: wall time of a call, with the device synchronised before
  and after each call (a CUDA launch returns before the card is done).
* :func:`stage_timings` and :func:`stage_timings_structured`: one batched
  solve decomposed into its stages, each timed on the same inputs. The
  stages run eagerly, for attribution, not accounting: inside the real
  solve they run back to back without the host in between, so their sum
  over-counts. ``total`` is the solve that users time: the captured solve
  on the card (``utils/capture.py``), the eager one on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch

from ..ops import sqp as sqp_mod


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` and write a Chrome trace
    (``trace_<pid>_<ns>.json``) into ``log_dir``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def time_fn(fn: Callable, *args, repeats: int = 3, warmup: int = 1) -> Dict[str, float]:
    """Median, fastest and slowest wall time in seconds of ``fn(*args)``,
    after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(repeats):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return {"median_s": times[len(times) // 2], "min_s": times[0], "max_s": times[-1]}


def _total_fn(planner, current_state, target_state):
    """The whole solve as users time it: captured on the card."""
    from .capture import capture_solve

    return capture_solve(planner, current_state, target_state)


def _warm_start(planner):
    return lambda cur, tgt: planner.warm_start_vector(planner.plan_warm_start(cur, tgt))


def stage_timings(planner, current_state, target_state, repeats: int = 3):
    """Per-stage wall times of one batched solve on the dense path: the
    keys ``warm_start``, ``linearize``, ``qp``, ``line_search`` and
    ``total`` (each a :func:`time_fn` dict), ``batch`` and ``solves_per_s``
    from ``total``. The QP stage solves the dense QP of the warm start with
    ``planner.qp_settings`` (a dense backend) and hard rows."""
    from ..ops.qp import solve_box_qp

    ocp = planner.ocp
    B = current_state.shape[0]
    warm = _warm_start(planner)
    z0 = warm(current_state, target_state)
    bounds = planner.nlp_bounds(current_state, target_state)

    def linearize(z):
        return sqp_mod.qp_subproblem(ocp, bounds, z, dense=True)

    c_eq, g, A, (h, lc, uc, lx, ux) = linearize(z0)
    P_diag = sqp_mod.hessian_regularization_diag(ocp, B, z0.dtype, z0.device,
                                                 planner.sqp_settings.reg_eps)

    def qp(P_diag, h, A, lc, uc, lx, ux):
        return solve_box_qp(P_diag, h, A, lc, uc, lx, ux, planner.qp_settings)

    d = qp(P_diag, h, A, lc, uc, lx, ux).x
    mu = torch.full((B,), 10.0, dtype=z0.dtype, device=z0.device)

    def line_search(z, d, h):
        return sqp_mod._line_search(ocp, bounds, z, d, h, mu, planner.sqp_settings, c_eq=c_eq, g=g)

    out = {
        "warm_start": time_fn(warm, current_state, target_state, repeats=repeats),
        "linearize": time_fn(linearize, z0, repeats=repeats),
        "qp": time_fn(qp, P_diag, h, A, lc, uc, lx, ux, repeats=repeats),
        "line_search": time_fn(line_search, z0, d, h, repeats=repeats),
        "total": time_fn(_total_fn(planner, current_state, target_state), current_state,
                         target_state, repeats=repeats),
    }
    out["batch"] = B
    out["solves_per_s"] = B / out["total"]["median_s"]
    return out


def stage_timings_structured(planner, current_state, target_state, repeats: int = 3,
                             time_factor_kernel: bool | None = None):
    """Per-stage wall times of one batched solve on the structured path:
    warm start, linearization (kernel 1 on the card), Ruiz scaling, banded
    KKT assembly, the plain factorization (``factor_xla``, the JAX key) and,
    with ``time_factor_kernel`` (default: when the planner is on CUDA),
    kernel 2 (``factor_kernel``), the whole QP stage at float32 with the
    SQP's soft rows, the line search and the total; ``batch``,
    ``solves_per_s`` and ``admm_loop_derived_s`` (the QP stage less its
    set-up and factorization)."""
    from ..kernels import banded_factor, structured_admm
    from ..ops.qp import _rho_pattern
    from ..ops.qp_structured import assemble_banded_M, factor_banded, ruiz_structured

    ocp = planner.ocp
    B = current_state.shape[0]
    settings = planner.qp_settings
    dev = planner.device
    warm = _warm_start(planner)
    z0 = warm(current_state, target_state)
    bounds = planner.nlp_bounds(current_state, target_state)

    def linearize(z):
        return sqp_mod.qp_subproblem(ocp, bounds, z)

    c_eq, g, sa, (h, lc, uc, lx, ux) = linearize(z0)
    dt = torch.float32  # the kernel path casts to float32 at the QP boundary
    sa32 = sa.to(dtype=dt)
    h32, lc, uc, lx, ux = (a.to(dt) for a in (h, lc, uc, lx, ux))
    P_diag = sqp_mod.hessian_regularization_diag(ocp, B, dt, dev, planner.sqp_settings.reg_eps)

    def ruiz():
        return ruiz_structured(ocp, sa32, settings.ruiz_iters)

    D, E = ruiz()
    K, nx = ocp.coll.order + 1, ocp.nx
    rc = settings.rho * _rho_pattern(lc, uc, settings)
    rx = settings.rho * _rho_pattern(lx, ux, settings)
    sig = D * P_diag * D + settings.sigma + rx

    def assemble():
        w = E * E * rc
        return assemble_banded_M(ocp, sa32, w[:, : ocp.num_eq].reshape(B, -1, K, nx),
                                 w[:, ocp.num_eq:].reshape(B, ocp.num_nodes, -1), D, sig)

    Mband, p_col, m_pp = assemble()

    def factor_xla(Mband, p_col, m_pp):
        return factor_banded(Mband, p_col, m_pp, ocp.coll.order)

    if time_factor_kernel is None:
        time_factor_kernel = dev.type == "cuda"
    soft_c, soft_x = sqp_mod.soft_weights(ocp, planner.sqp_settings, B, dt, dev)

    def qp_stage(h32, lc, uc, lx, ux):
        return structured_admm.solve_box_qp_structured(
            ocp, sa32, P_diag, h32, lc, uc, lx, ux, settings, soft_c=soft_c, soft_x=soft_x)

    d = qp_stage(h32, lc, uc, lx, ux).x.to(z0.dtype)
    mu = torch.full((B,), 10.0, dtype=z0.dtype, device=dev)

    def line_search(z, d, h):
        return sqp_mod._line_search(ocp, bounds, z, d, h, mu, planner.sqp_settings, c_eq=c_eq, g=g)

    out = {
        "warm_start": time_fn(warm, current_state, target_state, repeats=repeats),
        "linearize": time_fn(linearize, z0, repeats=repeats),
        "ruiz": time_fn(ruiz, repeats=repeats),
        "assemble_banded": time_fn(assemble, repeats=repeats),
        "factor_xla": time_fn(factor_xla, Mband, p_col, m_pp, repeats=repeats),
        "qp": time_fn(qp_stage, h32, lc, uc, lx, ux, repeats=repeats),
        "line_search": time_fn(line_search, z0, d, h, repeats=repeats),
        "total": time_fn(_total_fn(planner, current_state, target_state), current_state,
                         target_state, repeats=repeats),
    }
    if time_factor_kernel:
        out["factor_kernel"] = time_fn(banded_factor.factor_banded_kernel, Mband, p_col, m_pp,
                                       repeats=repeats)
    out["batch"] = B
    out["solves_per_s"] = B / out["total"]["median_s"]
    fkey = "factor_kernel" if time_factor_kernel else "factor_xla"
    out["admm_loop_derived_s"] = max(
        out["qp"]["median_s"] - out["ruiz"]["median_s"] - out["assemble_banded"]["median_s"]
        - out[fkey]["median_s"], 0.0)
    return out
