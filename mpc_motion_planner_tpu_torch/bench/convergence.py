"""Share of the shipping structured QPs that converge in their budgets, by
transcription and refinement steps.

Solves the first ``--n`` headline states
(``tests/fixtures/headline_states_b2048.npz``) with the shipping settings
(``config.SHIPPING_QP_SETTINGS``, budgets 700 / 500 of
``config.SHIPPING_SQP_SCHEDULES``), the Panda's OCP swapped for each of
``--segments`` spline segments of ``--order`` (3 by default) and the QPs'
``kkt_refine`` set to each of ``--kkt-refine``, in float32 (``--x64``:
float64), with
``--rescue-iters`` more ADMM iterations for every QP (default none), and
prints one JSON line per run: nodes, kkt_refine, ``qp_conv_rate`` and, for
each SQP step, the converged share and the median and largest QP
iterations.
On the GPU the QPs go through kernels 2 and 3 ("structured_pallas"); with
``--device cpu`` through their plain versions ("structured").

``--chain NQ`` plans a seeded serial revolute chain of NQ joints in place
of the Panda, as ``chip_smoke.py`` plans its chains: the URDF of
``tests/fixtures/make_panda6_fixture.py`` ``chain_urdf(NQ, seed=NQ)``, the
Panda's limits with its last joint's repeated past 7, no floor for its
tool, and the first ``--n`` of 2048 states at rest drawn from the seed NQ.

    python -m mpc_motion_planner_tpu_torch.bench.convergence [--device cpu]
        [--n 64] [--segments 13 14 15 16 20] [--order 3] [--chain 9]
        [--kkt-refine 0 1] [--rescue-iters 0] [--x64] [--threads 4]
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import time

import numpy as np
import torch

from .. import config
from ..models.panda import _LIMIT_TENSORS, make_panda_limits
from ..models.urdf import parse_urdf
from ..ocp import make_ocp
from ..ops.sqp import SQPSettings
from ..planner import Margins, MotionPlanner

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STATES = os.path.join(ROOT, "tests", "fixtures", "headline_states_b2048.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)
CHAIN_STATES = 2048  # states drawn for a chain, of which the first --n are solved


def robots():
    """``tests/fixtures/make_panda6_fixture.py``, the URDF writers of the
    robots other than the Panda (numpy only; its JAX part runs in its
    ``main`` alone)."""
    spec = importlib.util.spec_from_file_location(
        "make_panda6_fixture", os.path.join(ROOT, "tests", "fixtures", "make_panda6_fixture.py"))
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    return fx


def chain(nq: int, n: int, dtype, dev):
    """The seeded serial chain of ``nq`` joints (its model, limits and tool
    frame: the Panda's limits, cut to the first ``nq`` or with its last
    joint's repeated past 7) and the first ``n`` of its (current, target)
    states."""
    fx = robots()
    panda = make_panda_limits()
    limits = dataclasses.replace(panda, **{
        k: torch.cat([getattr(panda, k), getattr(panda, k)[-1:].repeat(max(nq - 7, 0))])[:nq]
        for k in _LIMIT_TENSORS})
    model = parse_urdf(fx.chain_urdf(nq, seed=nq), dtype=dtype, device=dev)
    pl = MotionPlanner(model=model, limits=limits, tool_frame="tool", margins=Margins(*MARGINS),
                       dtype=dtype, device=dev)
    lo, hi = (b.cpu().numpy() for b in pl.position_bounds())
    rng = np.random.default_rng(nq)

    def states():
        q = lo + (hi - lo) * rng.uniform(0.25, 0.75, (CHAIN_STATES, nq))
        x = np.concatenate([q, np.zeros((CHAIN_STATES, nq))], 1)
        return torch.as_tensor(x[:n], dtype=dtype, device=dev)

    cur = states()
    return model, limits, "tool", cur, states()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n", type=int, default=64, help="headline states, from the first")
    ap.add_argument("--segments", type=int, nargs="+", default=[13, 14, 15, 16, 20])
    ap.add_argument("--order", type=int, default=3, help="spline order")
    ap.add_argument("--chain", type=int, help="plan a seeded serial chain of this many joints")
    ap.add_argument("--kkt-refine", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--rescue-iters", type=int, default=0,
                    help="ADMM iterations past each QP's budget")
    ap.add_argument("--x64", action="store_true", help="solve in float64")
    ap.add_argument("--threads", type=int, default=4, help="CPU threads")
    a = ap.parse_args(argv)
    torch.set_num_threads(a.threads)
    config.full_precision()
    dev, dtype = torch.device(a.device), torch.float64 if a.x64 else torch.float32
    model = limits = None
    if a.chain:
        model, limits, tool, cur, tgt = chain(a.chain, a.n, dtype, dev)
    else:
        states = np.load(STATES)
        cur = torch.as_tensor(states["current"][:a.n], dtype=dtype, device=dev)
        tgt = torch.as_tensor(states["target"][:a.n], dtype=dtype, device=dev)
    base = dataclasses.replace(config.SHIPPING_QP_SETTINGS, rescue_iters=a.rescue_iters,
                               backend=config.shipping_backend(dev.type))
    for segments in a.segments:
        for refine in a.kkt_refine:
            pl = MotionPlanner(model=model, limits=limits, margins=Margins(*MARGINS),
                               dtype=dtype, device=dev,
                               qp_settings=dataclasses.replace(base, kkt_refine=refine),
                               sqp_settings=SQPSettings(
                                   qp_step_schedules=config.SHIPPING_SQP_SCHEDULES),
                               **({"tool_frame": tool} if a.chain else {}))
            pl.ocp = make_ocp(pl.model, pl.tool_frame, order=a.order, num_segments=segments)
            if a.chain:
                pl.set_min_height(-10.0)  # a random chain: no floor for its tool
            t0 = time.perf_counter()
            sol = pl.solve(cur, tgt)
            conv = sol.qp_converged.cpu().numpy()
            iters = sol.qp_iterations.cpu().numpy()
            print(json.dumps({
                "segments": segments, "order": a.order, "joints": pl.ocp.nq,
                "nodes": pl.ocp.num_nodes, "kkt_refine": refine,
                "rescue_iters": a.rescue_iters,
                "device": a.device, "dtype": str(dtype).split(".")[-1], "states": a.n,
                "qp_conv_rate": float(conv.mean()),
                "converged_per_step": [float(c) for c in conv.mean(0)],
                "iterations_median_per_step": [float(i) for i in np.median(iters, 0)],
                "iterations_max_per_step": [int(i) for i in iters.max(0)],
                "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
