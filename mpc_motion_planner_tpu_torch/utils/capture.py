"""The compiled solve: ``MotionPlanner.solve`` captured into a CUDA graph.

The port's counterpart of ``jax.jit(planner.solve)``, which every solve
that the JAX package times or serves goes through: one program with no host
round trips. PyTorch runs a solve eagerly, ~8k small launches of which the
host is the bottleneck; a CUDA graph records them once and replays them as
one launch.

    solve = capture_solve(planner, current, target)   # the cold run: capture
    sol = solve(current, target)                      # a replay

* The solve path is capturable: it synchronises with the host nowhere and
  copies nothing from host memory (kernel 2's ok-flag repair has a fixed
  shape, the rho updates rebuild under a mask, the index constants are made
  once per device), and the hand-written kernels take every parameter by
  value, so a graph bakes in the planner's settings as a ``jax.jit`` cache
  entry does.
* A capture is keyed by the batch size, the inputs' dtype, which of the
  optional arguments (``z0``, ``lam_c0``, ``lam_x0``) are given, the value
  of ``min_height``, the planner's settings and the transcription of its
  OCP (``planner.ocp = make_ocp(..., num_segments=8)`` after a capture
  captures anew, with the kernels built for it); a call with another key
  captures anew (a hot restart is another capture), as ``jax.jit`` traces
  anew.
* A call copies the inputs into the graph's own buffers, replays it, and
  returns a ``Solution`` of clones of the graph's outputs, which survives
  the next call as a JAX result does. It then reads, with one host
  synchronisation, how many problems flagged by kernel 2 the graph could not
  repair (more than ``kernels.banded_factor.repair_capacity``): if any, it
  solves that batch again eagerly, which repairs them all, and counts it in
  ``eager_resolves``.
* The launch counts of ``kernels.launch_counts()`` stay what the card ran: a
  capture runs nothing and adds nothing, each replay adds the launches the
  capture recorded.
* A planner on the CPU is solved eagerly (``captured`` is False): the CPU
  was asked for. For a CUDA planner a capture that fails raises; nothing
  runs eagerly in its place without being counted.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import kernels
from ..kernels import banded_factor
from ..kernels.build import DeviceCount, Geometry
from ..ops.otg import JerkLimitedTrajectory
from ..planner import MotionPlanner, Solution

OPTIONAL = ("z0", "lam_c0", "lam_x0")


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    inputs: dict  # the graph's input buffers by argument name
    min_height: Optional[float]
    out: Solution  # the graph's output buffers
    launches: dict  # kernel launches per replay
    overflow: DeviceCount  # flagged problems the last replay left unrepaired


def _clone(sol: Solution) -> Solution:
    ws = sol.warm_start
    if ws is not None:
        ws = JerkLimitedTrajectory(*(getattr(ws, f.name).clone()
                                     for f in dataclasses.fields(ws)))
    return dataclasses.replace(
        sol, warm_start=ws,
        **{f: getattr(sol, f).clone() for f in ("z", "lam_c", "lam_x", "violation",
                                                "qp_iterations", "qp_converged", "step_sizes")})


class CapturedSolve:
    """``planner.solve`` as replays of CUDA graphs, one per key (module
    docstring). Call it as ``MotionPlanner.solve``; :meth:`start` and
    :meth:`finish` split a call, so that several devices replay at once."""

    def __init__(self, planner: MotionPlanner):
        self.planner = planner
        self.captured = planner.device.type == "cuda"
        self.graphs = {}
        self.eager_resolves = 0  # replays whose batch was solved again eagerly

    def _key(self, args: dict, min_height):
        p = self.planner
        return (args["current_state"].shape[0], args["current_state"].dtype,
                tuple(k for k in OPTIONAL if k in args), min_height,
                (p.margins, p.sqp_settings, p.qp_settings, p.target_eps, p.time_bounds,
                 p._min_height), p.ocp.fused_constraints, Geometry.of_ocp(p.ocp))

    def _solve(self, args: dict, min_height):
        return self.planner.solve(min_height=min_height, **args)

    def capture(self, args: dict, min_height=None) -> _Graph:
        """Warm up on a side stream (builds the kernels, makes the cached
        constants and the counters' accumulators), then capture one solve of
        ``args`` into a graph of its own."""
        dev = self.planner.device
        with torch.cuda.device(dev):
            inputs = {k: v.detach().to(dev).clone() for k, v in args.items()}
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._solve(inputs, min_height)
            torch.cuda.current_stream().wait_stream(side)
            overflow = DeviceCount()
            overflow.add(torch.zeros((), dtype=torch.int64, device=dev))
            torch.cuda.synchronize()
            before = kernels.launch_counts()
            graph = torch.cuda.CUDAGraph()
            banded_factor.CAPTURE_SINKS.append(overflow)
            try:
                with torch.cuda.graph(graph):
                    out = self._solve(inputs, min_height)
            finally:
                banded_factor.CAPTURE_SINKS.remove(overflow)
                recorded = {k: n - before[k] for k, n in kernels.launch_counts().items()}
                kernels.add_launch_counts({k: -n for k, n in recorded.items()})
        return _Graph(graph, inputs, min_height, out, recorded, overflow)

    def start(self, current_state, target_state, z0=None, min_height=None, lam_c0=None,
              lam_x0=None):
        """Copy the inputs in and replay (capturing first for a new key);
        returns what :meth:`finish` takes. On the CPU: the eager solve."""
        args = {"current_state": current_state, "target_state": target_state}
        args.update({k: v for k, v in zip(OPTIONAL, (z0, lam_c0, lam_x0)) if v is not None})
        if not self.captured:
            return self._solve(args, min_height)
        key = self._key(args, min_height)
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self.capture(args, min_height)
        with torch.cuda.device(self.planner.device):
            for k, v in args.items():
                g.inputs[k].copy_(v)
            g.overflow.reset()
            g.graph.replay()
        kernels.add_launch_counts(g.launches)
        return g, args

    def finish(self, started) -> Solution:
        """The Solution of a :meth:`start`: clones of the graph's outputs,
        or, if the replay left flagged problems unrepaired, an eager solve
        of the batch."""
        if not self.captured:
            return started
        g, args = started
        if g.overflow.count:  # the one host synchronisation of a call
            self.eager_resolves += 1
            return self._solve(args, g.min_height)
        return _clone(g.out)

    def __call__(self, current_state, target_state, z0=None, min_height=None, lam_c0=None,
                 lam_x0=None) -> Solution:
        return self.finish(self.start(current_state, target_state, z0=z0,
                                      min_height=min_height, lam_c0=lam_c0, lam_x0=lam_x0))


def capture_solve(planner: MotionPlanner, current_state, target_state,
                  **solve_kwargs) -> CapturedSolve:
    """The counterpart of ``jax.jit(planner.solve)``, captured for these
    example inputs (the cold run; module docstring)."""
    unknown = set(solve_kwargs) - set(OPTIONAL) - {"min_height"}
    if unknown:
        raise TypeError(f"capture_solve got unexpected arguments {sorted(unknown)}")
    solve = CapturedSolve(planner)
    if solve.captured:
        args = {"current_state": current_state, "target_state": target_state}
        args.update({k: v for k, v in solve_kwargs.items() if k in OPTIONAL and v is not None})
        min_height = solve_kwargs.get("min_height")
        solve.graphs[solve._key(args, min_height)] = solve.capture(args, min_height)
    return solve
