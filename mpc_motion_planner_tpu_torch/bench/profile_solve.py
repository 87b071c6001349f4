"""Where a warm B=2048 solve spends its time on one GPU, captured and eager.

Solves the headline states (``tests/fixtures/headline_states_b2048.npz``)
with the shipping structured configuration (or ``--dense``: the headline's
dense ``pallas`` configuration; ``--default``: the structured backend at
its default settings, adaptive rho every 100 iterations and budgets
700/700; ``--xla``: ``MotionPlanner()``'s dense "xla" default). The solve
is captured into a CUDA graph (``utils/capture.py``; the capture is the
cold run), then ``--warm`` replays and ``--warm`` eager solves run in turns
on the host clock, then one replay and one eager solve each under
``torch.profiler``. From each trace's device events (kernels, copies,
memsets) it takes the device-busy time as the union of their intervals, the
idle share against that mode's median wall time, and the device time of
each hand-written kernel by name. Wall times are taken before the profiler
starts, which slows later solves.

    python -m mpc_motion_planner_tpu_torch.bench.profile_solve [--dense | --default | --xla]
        [--warm 5] [--segments 6] [--order 3] [--batch 2048]
        [--urdf tests/fixtures/panda_joint7_fixed.urdf | --hand | --chain 12 | --chain 21]

``--segments`` and ``--order`` set the transcription as a user sets it
(``planner.ocp = make_ocp(model, tool_frame, order=3, num_segments=8)``: 25
nodes; ``order=4, num_segments=4``: 17 nodes; ``order=4, num_segments=6``:
25 nodes, kernel 3 in its split layout; ``num_segments=12``: 37 nodes,
kernel 3 in its stream layout; ``num_segments=15``: 46 nodes, the stream
layout with two elements a thread; ``num_segments=20``: 61 nodes, the lean
layout; ``num_segments=25``: 76 nodes, the far layout; ``num_segments=32``:
97 nodes, the deep layout; ``num_segments=52``: 157 nodes, the pair layout,
a cluster of two blocks a problem; default 6 segments of order 3, 19
nodes), the shipping path with the QP settings of its node count
(``config.shipping_qp_settings``: one KKT refinement step from 43 nodes,
rescue iterations from 85),
and kernels 2 and 3 are built for it. ``--urdf`` plans another
robot: a Panda with its last joints locked (for example
``tests/fixtures/panda_joint7_fixed.urdf``, 6 joints), with the Panda's
limits of its first nq joints and the headline states' entries of those
joints; kernels 1-3 are built for its joint count. ``--hand`` plans the
Panda with its hand (``tests/fixtures/make_panda6_fixture.py``
``panda_urdf(lock_joint7=False, hand=True)``: 9 joints, a branched tree
with two prismatic fingers) with the Panda's limits and the fingers'
(``FINGER_LIMITS``) under ``make_ocp(model, "panda_tool",
fused_constraints="off")`` (kernel 1 takes no branched tree: the plain
constraint path runs in its place), on the headline states with the
fingers at 0.01 m and 0.03 m (``hand_states``); kernels 2 and 3 are built
for 9 joints. ``--chain NQ`` plans the seeded serial chain of NQ joints on
its 2048 seeded states (``bench/convergence.py`` ``chain``, no floor for
its tool, as ``chip_smoke.py`` plans it), any count kernels 1-3 take (1 to
25 at 19 nodes): ``--chain 12`` at 19 nodes takes kernel 3's lean layout
with blocks of 36 x 36, two rows a lane; ``--chain 21`` its pair layout
with the ring spread over three ranks, a cluster of four blocks a problem,
and kernel 2 with its ring read back from device memory; ``--chain 25``
blocks of 75 x 75, three rows a lane, the ring over four ranks, a cluster
of five. ``--batch`` solves the first B states (default all 2048).

Prints one JSON object, then the card's name and power limit. Needs one
CUDA GPU and ``nvcc``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .. import config, kernels
from ..kernels.build import Geometry
from ..models.panda import _LIMIT_TENSORS, make_panda_limits
from ..models.urdf import parse_urdf
from ..ocp import make_ocp
from ..ops.qp import QPSettings
from ..ops.sqp import SQPSettings
from ..planner import Margins, MotionPlanner
from ..utils.capture import capture_solve
from .convergence import chain, robots

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STATES = os.path.join(ROOT, "tests", "fixtures", "headline_states_b2048.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# substrings of the hand-written kernels' names in the trace
KERNEL_NAMES = {
    "constraints": "constraints",
    "banded_factor": "banded_factor_kernel",
    "structured_admm": "structured_admm_kernel",
    "admm_dense": "admm_dense",
}


def union_ms(intervals) -> float:
    """Total length in ms of the union of (start, end) intervals in us."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def device_events(trace_path):
    """(name, start_us, end_us) of every device event of a chrome trace."""
    with open(trace_path) as fh:
        trace = json.load(fh)
    return [(e.get("name", ""), e["ts"], e["ts"] + e.get("dur", 0))
            for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def locked_panda(urdf: str, dtype, device):
    """The robot of ``urdf``, a Panda with its last joints locked (nq <= 7
    joints): (model, the Panda's limits of its first nq joints, the columns
    of a 7-joint state that hold q1..q_nq and qdot1..qdot_nq)."""
    model = parse_urdf(urdf, dtype=dtype, device=device)
    nq = model.nq
    if nq > 7:
        raise ValueError(f"{urdf}: {nq} joints; a Panda with locked joints has at most 7")
    lim = make_panda_limits(dtype, device)
    limits = dataclasses.replace(lim, **{k: getattr(lim, k)[:nq] for k in _LIMIT_TENSORS})
    return model, limits, list(range(nq)) + [7 + i for i in range(nq)]


def hand_panda(dtype, device):
    """The Panda with its hand, 9 joints (:func:`robots` ``panda_urdf``),
    and the Panda's limits with the fingers'."""
    fx = robots()
    model = parse_urdf(fx.panda_urdf(lock_joint7=False, hand=True), dtype=dtype, device=device)
    lim = make_panda_limits(dtype, device)
    limits = dataclasses.replace(lim, **{
        k: torch.cat([getattr(lim, k), torch.tensor(fx.FINGER_LIMITS[k], dtype=dtype,
                                                     device=device)])
        for k in _LIMIT_TENSORS})
    return model, limits


def make_planner(which: str, dev, segments: int = 6, urdf: str = None,
                 order: int = 3, hand: bool = False, chain_nq: int = None) -> MotionPlanner:
    """The planner of a path: "structured" (shipping), "dense",
    "structured_default" or "xla" (``MotionPlanner()``'s settings), on
    ``segments`` spline segments of ``order``, for the Panda, the robot of
    ``urdf`` (:func:`locked_panda`), with ``hand``, the Panda with its
    hand under fused_constraints "off" (:func:`hand_panda`), or with
    ``chain_nq``, the seeded chain of that many joints (``chain``)."""
    if which == "xla":
        qp, sqp = QPSettings(), SQPSettings()
    elif which == "dense":
        qp = QPSettings(backend="pallas", kkt_refine=1, rho_update_every=0, kkt_factor="lu",
                        ruiz_iters=2, rho=0.1, alpha=1.6, max_iter=700, check_every=25)
        sqp = SQPSettings()
    elif which == "structured_default":
        qp, sqp = QPSettings(backend="structured"), SQPSettings()
    else:
        qp = config.SHIPPING_QP_SETTINGS
        sqp = SQPSettings(qp_step_schedules=config.shipping_sqp_schedules(qp.backend))
    model, limits = (hand_panda(torch.float32, dev) if hand
                     else locked_panda(urdf, torch.float32, dev)[:2] if urdf else (None, None))
    tool = "panda_tool"
    if chain_nq:
        model, limits, tool, _, _ = chain(chain_nq, 1, torch.float32, dev)
    planner = MotionPlanner(model=model, limits=limits, tool_frame=tool,
                            margins=Margins(*MARGINS), dtype=torch.float32, device=dev,
                            qp_settings=qp, sqp_settings=sqp)
    if chain_nq:
        planner.set_min_height(-10.0)  # a random chain: no floor for its tool
    fused = "off" if hand else planner.ocp.fused_constraints
    if (segments, order) != (6, 3) or hand:
        planner.ocp = make_ocp(planner.model, planner.tool_frame, order=order,
                               num_segments=segments, fused_constraints=fused)
        if which == "structured":
            planner.qp_settings = config.shipping_qp_settings(planner.ocp.num_nodes)
    return planner


def profiled(fn, cur, tgt):
    """One call of ``fn`` under ``torch.profiler``: (wall ms, solution,
    device events)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = fn(cur, tgt)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        prof.export_chrome_trace(path)
        return ms, sol, device_events(path)


def breakdown(warm, traced_ms, events, launches, refactors, sol, batch) -> dict:
    """The JSON fields of one mode (captured or eager)."""
    busy = union_ms((s, e) for _, s, e in events)
    median = float(np.median(warm))
    return {
        "warm_solve_ms": warm, "warm_solve_ms_median": median,
        "solves_per_s": 1e3 * batch / median, "traced_solve_ms": traced_ms,
        "device_busy_ms": busy, "device_events": len(events),
        "idle_share": 1.0 - busy / median, "launches": launches,
        "refactorizations": refactors,
        "kernel_device_ms": {
            key: {"ms": sum(e - s for n, s, e in events if sub in n) / 1e3,
                  "events": sum(1 for n, _, _ in events if sub in n)}
            for key, sub in KERNEL_NAMES.items()},
        "qp_conv_rate": float(sol.qp_converged.double().mean()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--dense", action="store_true", help="the dense pallas configuration")
    group.add_argument("--default", action="store_true",
                       help="the structured backend at its default settings (adaptive rho)")
    group.add_argument("--xla", action="store_true", help="MotionPlanner()'s dense xla default")
    ap.add_argument("--warm", type=int, default=5, help="warm solves of each mode on the host clock")
    ap.add_argument("--segments", type=int, default=6,
                    help="spline segments (6 of order 3: 19 nodes; 8: 25 nodes; 20: 61 nodes)")
    ap.add_argument("--order", type=int, default=3,
                    help="spline order (4 x 4 segments: 17 nodes; 4 x 6: 25 nodes)")
    robot = ap.add_mutually_exclusive_group()
    robot.add_argument("--urdf", help="a Panda with its last joints locked (default: the Panda)")
    robot.add_argument("--hand", action="store_true",
                       help="the Panda with its hand (9 joints), fused_constraints 'off'")
    robot.add_argument("--chain", type=int, help="the seeded serial chain of this many joints")
    ap.add_argument("--batch", type=int, default=2048, help="solve the first B states")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_solve: needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    config.full_precision()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    which = ("dense" if a.dense else "structured_default" if a.default
             else "xla" if a.xla else "structured")
    planner = make_planner(which, dev, a.segments, a.urdf, a.order, a.hand, a.chain)
    states = np.load(STATES)
    if a.chain:
        _, _, _, cur, tgt = chain(a.chain, len(states["current"]), torch.float32, dev)
    elif a.hand:
        fx = robots()
        cur, tgt = (torch.as_tensor(fx.hand_states(states[k], w), dtype=torch.float32, device=dev)
                    for k, w in (("current", fx.FINGERS_CURRENT), ("target", fx.FINGERS_TARGET)))
    else:
        cols = list(range(planner.ocp.nq)) + [7 + i for i in range(planner.ocp.nq)]
        cur = torch.as_tensor(states["current"][:, cols], device=dev)
        tgt = torch.as_tensor(states["target"][:, cols], device=dev)
    cur, tgt = cur[:a.batch], tgt[:a.batch]
    B = int(cur.shape[0])

    t0 = time.perf_counter()
    captured = capture_solve(planner, cur, tgt)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0

    def solve(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(cur, tgt)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    modes = {"cuda_graph": captured, "eager": planner.solve}
    warm = {m: [] for m in modes}
    for _ in range(a.warm):
        for m, fn in modes.items():
            warm[m].append(solve(fn))
    out = {"path": which, "batch": B, "nodes": planner.ocp.num_nodes,
           "order": planner.ocp.coll.order, "joints": planner.ocp.nq,
           "fused_constraints": planner.ocp.fused_constraints, "capture_s": capture_s,
           "eager_resolves": captured.eager_resolves,
           "k3_layout": kernels.structured_admm.choose_layout(Geometry.of_ocp(planner.ocp))}
    for m, fn in modes.items():
        kernels.reset_launch_counts()
        ms, sol, events = profiled(fn, cur, tgt)
        if not events:
            print(f"profile_solve: the trace of the {m} solve holds no device event",
                  file=sys.stderr)
            return 1
        out[m] = breakdown(warm[m], ms, events, kernels.launch_counts(),
                           kernels.structured_admm.REFACTORS.count, sol, B)
    print(json.dumps(out), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
