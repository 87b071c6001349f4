"""Batch data parallelism over devices.

Counterpart of ``mpc_motion_planner_tpu/parallel/mesh.py``. The workload's
one parallel axis is the batch of independent solves, so scaling out is
pure data parallelism: a mesh is a list of ``torch.device``s, the batch is
split evenly over them, every device runs its shard through a captured solve
(``utils/capture.py``) of a planner of its own, and the results are gathered
onto the first device with the batch-global stats. Nothing is exchanged
inside a solve. Across processes (``initialize_multihost``) each process
solves its own slice of the batch and the stats are all-reduced with
``torch.distributed`` (NCCL between cards, gloo on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.distributed as dist

from ..ops.otg import JerkLimitedTrajectory
from ..planner import MotionPlanner, Solution
from ..utils.capture import CapturedSolve

BATCH_AXIS = "batch"
BATCHED = ("z", "lam_c", "lam_x", "violation", "qp_iterations", "qp_converged", "step_sizes")


def _canonical(device) -> torch.device:
    """A device with its index: "cuda" is the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def initialize_multihost(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """Join an N-process data-parallel job: ``torch.distributed`` with the
    rendezvous at ``coordinator_address`` (``tcp://host:port``, or
    ``file:///path`` on one host), NCCL when there is a card, gloo on the
    CPU. Afterwards each process builds its mesh of its own devices and
    passes its slice of the batch to :func:`shard_batch_multihost`; the
    solve functions all-reduce the stats."""
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)


def make_mesh(devices=None) -> List[torch.device]:
    """The devices of the batch axis: ``devices``, or every CUDA device of
    this process."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [_canonical(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def shard_batch(mesh: List[torch.device], tree):
    """Split a (B, ...) tensor, or a tuple or list of them, into len(mesh)
    equal shards along the batch, shard i on ``mesh[i]``; each tensor becomes
    a list of shards. Raises when the batch does not divide evenly."""

    def split(a):
        B = a.shape[0]
        if B % len(mesh):
            raise ValueError(f"a batch of {B} does not divide over a mesh of {len(mesh)} devices")
        n = B // len(mesh)
        return [a[i * n:(i + 1) * n].to(d) for i, d in enumerate(mesh)]

    return split(tree) if torch.is_tensor(tree) else type(tree)(split(a) for a in tree)


def shard_batch_multihost(mesh: List[torch.device], tree):
    """This process's slice of the batch, split over its own devices
    (``mesh``) as :func:`shard_batch` splits it. The job's batch is the
    processes' slices in rank order; only the stats cross processes."""
    if not dist.is_initialized():
        raise RuntimeError("shard_batch_multihost needs initialize_multihost first")
    return shard_batch(mesh, tree)


def batch_stats(sol: Solution) -> dict:
    """The batch-global stats of the JAX solve functions: mean and largest
    violation, mean QP iterations (float32), problems whose every QP
    converged; summed or maximised over the process group when there is
    one."""
    v = sol.violation
    iters = sol.qp_iterations.to(torch.float32)
    conv = sol.qp_converged.all(dim=-1)
    if not (dist.is_available() and dist.is_initialized()):
        return {"mean_violation": v.mean(), "max_violation": v.max(),
                "mean_qp_iterations": iters.mean(), "num_converged": conv.sum()}
    sums = torch.stack([v.sum().double(), torch.tensor(float(v.numel()), device=v.device),
                        iters.sum().double(), torch.tensor(float(iters.numel()), device=v.device),
                        conv.sum().double()])
    vmax = v.max().clone()
    dist.all_reduce(sums, op=dist.ReduceOp.SUM)
    dist.all_reduce(vmax, op=dist.ReduceOp.MAX)
    return {"mean_violation": (sums[0] / sums[1]).to(v.dtype), "max_violation": vmax,
            "mean_qp_iterations": (sums[2] / sums[3]).to(torch.float32),
            "num_converged": sums[4].to(torch.int64)}


def _planner_on(planner: MotionPlanner, device: torch.device) -> MotionPlanner:
    """``planner`` itself on its own device, else a planner of the same
    model, limits and settings on ``device``."""
    if _canonical(planner.device) == device:
        return planner
    other = MotionPlanner(
        model=planner.model, limits=planner.limits, tool_frame=planner.tool_frame,
        margins=planner.margins, sqp_settings=planner.sqp_settings,
        qp_settings=planner.qp_settings, target_eps=planner.target_eps,
        time_bounds=planner.time_bounds, dtype=planner.dtype, device=device)
    if planner._min_height is not None:
        other.set_min_height(planner._min_height)
    return other


def _gather(sols: List[Solution], device: torch.device) -> Solution:
    """The shards' solutions as one, on ``device``."""
    cat = lambda ts: torch.cat([t.to(device) for t in ts], dim=0)
    ws = [s.warm_start for s in sols]
    warm = None if any(w is None for w in ws) else JerkLimitedTrajectory(
        *(cat([getattr(w, f.name) for w in ws]) for f in dataclasses.fields(JerkLimitedTrajectory)))
    return Solution(ocp=sols[0].ocp, warm_start=warm,
                    **{f: cat([getattr(s, f) for s in sols]) for f in BATCHED})


class MeshSolve:
    """fn(current, target) -> (Solution, stats): one captured solve per
    device of the mesh on its shard (whole tensors are sharded first), the
    shards replayed before any is read, the results gathered onto the first
    device."""

    def __init__(self, planner: MotionPlanner, mesh: List[torch.device]):
        self.mesh = [_canonical(d) for d in mesh]
        planners = {}
        for d in self.mesh:
            if d not in planners:
                planners[d] = _planner_on(planner, d)
        self.solves = [CapturedSolve(planners[d]) for d in self.mesh]

    def __call__(self, current, target):
        if torch.is_tensor(current):
            current, target = shard_batch(self.mesh, (current, target))
        if len(current) != len(self.mesh) or len(target) != len(self.mesh):
            raise ValueError(f"{len(current)} shards for a mesh of {len(self.mesh)} devices")
        started = [s.start(c, t) for s, c, t in zip(self.solves, current, target)]
        sol = _gather([s.finish(x) for s, x in zip(self.solves, started)], self.mesh[0])
        return sol, batch_stats(sol)


def sharded_solve_fn(planner: MotionPlanner, mesh: List[torch.device]) -> MeshSolve:
    """The solve over the mesh with the batch-global stats. In the JAX
    package GSPMD partitions one jitted solve; on CUDA devices the one way is
    a solve per device (:class:`MeshSolve`)."""
    return MeshSolve(planner, mesh)


def shard_map_solve_fn(planner: MotionPlanner, mesh: List[torch.device]) -> MeshSolve:
    """The whole solve per shard (the JAX package's ``shard_map`` form for
    its Pallas backends), with the batch-global stats: on CUDA devices the
    same as :func:`sharded_solve_fn`."""
    return MeshSolve(planner, mesh)
