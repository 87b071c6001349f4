#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``mpc_motion_planner_tpu_torch``).

Builds the four hand-written CUDA kernels from ``csrc/`` (one nvcc per source
and transcription, all started together), holds each against its plain PyTorch version on the
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
against the JAX analysis of that artifact and against the eager solves of
the same batches (phase 12), and the offline-trajectory example with its
re-integration check (phase 13). The headline and the acceptance solve
through the compiled solve (``utils/capture.py``: the solve captured into a
CUDA graph, the port's ``jax.jit``). Phases 14-18 hold it: each QP path
captured at B=2048 against its eager solve, bitwise, with the launch counts
of a replay, the replay's time beside the eager solve's in turns and, on
the shipping path, one replay's device idle share (14); kernel 2's ok-flag
repair inside a graph against the eager repair, within the repair capacity
and beyond it (15);
the one-card mesh's ``sharded_solve_fn`` against the captured solve (16);
``stage_timings_structured`` on the card (17); and kernel 2 against its
library call, ``torch.linalg.cholesky_ex`` of the dense KKT matrix (18).
Kernels 2 and 3 are built per transcription, and phase 1 builds them for
19, 25 and 13 nodes. Phase 19 sets the planner's OCP to 8 spline segments
(25 nodes, 526 variables, 648 rows) as a user does, holds kernels 2 and 3
built for it against their plain versions, times them at B=2048, drives the
captured shipping solve of the headline states through them and holds it
against the JAX fixture at 8 segments ``torch_port_seg8_b64.npz``; then
kernels 2 and 3 at 13 nodes against their plain versions. Kernels 1-3 are
also built per joint count: phase 20 builds them for 6 and 8 joints (six
nvcc at once, the seconds printed) and plans the Panda with ``panda_joint7``
fixed (6 joints, ``tests/fixtures/panda_joint7_fixed.urdf``, the Panda's
first six limits, the headline states without joint 7): the libraries'
blocks against the Python reckoning, kernels 1-3 at 6 joints and on a
seeded 8-joint chain against their plain versions and timed (kernel 1 at
B=2048, kernels 2 and 3 at B=1024), the
6-joint captured shipping solve (5/2/2/0 launches, bitwise its eager solve,
quality, times in turns) and the 8-joint chain's eager solve, the JAX
fixture ``torch_port_panda6_b64.npz`` (64/64), the dense ``pallas`` path at
6 joints, the 9-joint chain planned (kernel 3's split layout), the
10-joint chain at 25 nodes planned (its stream layout), and
``fused_constraints``: a branched model with prismatic fingers raises under
"auto" and plans under "off", and the 6-joint planner under "off" launches
no kernel 1. Kernels 2
and 3 are built for the band width too, the spline order: phase 21 builds
them for orders 2, 4 and 5 (at 9, 4 and 3 segments: 19, 17 and 16 nodes;
six nvcc at once), checks their blocks against the Python reckoning, holds
them against their plain versions and times them at B=2048 at each order,
drives the captured shipping solve of the headline states at 4 segments of
order 4 (17 nodes, 358 variables, 416 rows; 5/2/2/0 launches, bitwise its
eager solve, quality, times in turns), holds it against the JAX fixture
``torch_port_order4_b64.npz`` (64/64), runs the dense ``pallas`` path at
order 4 and plans order 4 at 6 and 9 segments (25 and 37 nodes). Kernel 3
keeps in shared memory only what its chain reads where nothing else fits
(the split layout: the helper warps' blocks stream from device memory by
TMA bulk copies), and phase 22 holds it: built in the split layout at 8 segments of
order 3, where the compact one also fits, it gives every output of the
compact one bitwise at B=2048 (both timed in turns); then the Panda at 6
segments of order 4 (25 nodes, 526 variables, 620 rows) is planned as a
user sets it, with kernels 2 and 3 against their plain versions and timed,
the captured shipping solve of the headline states (5/2/2/0, bitwise its
eager solve, quality, times in turns), the JAX fixture
``torch_port_order4s6_b64.npz`` (64/64), and kernel 4's refusal of n =
526; last, seeded serial chains of 9 and 10 joints at 19 nodes, kernels 1-3
against their plain versions and timed, and an eager shipping solve each
(5/2/2/0). Kernel 3 keeps no block of Lsub in shared memory where the split
does not fit (the stream layout: the chain's blocks go through the copier's
ring too), and phase 23 holds it: built in the stream layout at 8 segments
of order 3 and at 6 of order 4, it gives every output of the compact and
the split layout bitwise at B=2048 (times in turns); then the Panda at 12
segments of order 3 (37 nodes, 778 variables, 968 rows, 992 threads) is
planned as a user sets it, with kernels 2 and 3 against their plain
versions and timed, the captured shipping solve of the headline states
(5/2/2/0, bitwise its eager solve, quality, times in turns) and the JAX
fixture ``torch_port_seg12_b64.npz`` (64/64); order 4 at 9 segments and
seeded chains of 9 and 10 joints at 25 nodes, kernels 2 and 3 held and
timed and an eager shipping solve each; and every stream library's block
against the Python reckoning. Past 1024 elements a thread of kernel 3 owns
two z elements and two rows, and phase 24 holds it: built so at 12 segments
of order 3, where one element a thread fits, it meets ``iteration_agreement``
and the hard-row bar against its own build at B=2048 (times in turns, with
ptxas's registers and spills); then the Panda at 15 segments of order 3 (46
nodes, 967 variables, 1208 rows, 608 threads) is planned as a user sets it,
with kernels 2 and 3 against their plain versions and timed, the captured
shipping solve of the headline states (5/2/2/0, bitwise its eager solve,
quality, times in turns) and the JAX fixture ``torch_port_seg15_b64.npz``;
13 segments of order 3, order 4 at 10 segments and a seeded 9-joint chain
at 10 segments (40, 41, 31 nodes), kernels 2 and 3 held and timed and an
eager shipping solve each. Where the stream block does not fit one SM,
kernel 3 keeps out of shared memory the vectors only their owner reads (the
lean layout), and phase 25 holds it: built so at 15 and 12 segments of
order 3, where the stream layout fits, it gives every output of the stream
layout bitwise at B=2048 (times in turns, with ptxas's registers and
spills); then the Panda at 20 segments of order 3 (61 nodes, 1282
variables, 1608 rows, 832 threads) is planned as a user sets it, with
kernels 2 and 3 against their plain versions and timed, the captured
shipping solve of the headline states (5/2/2/0, bitwise its eager solve,
quality, times in turns) and the JAX fixture ``torch_port_seg20_b64.npz``;
24 segments of order 3, order 4 at 16 segments and seeded chains of 10
joints at 12 segments and 9 joints at 15 (73, 65, 37, 46 nodes), kernels 2
and 3 held and an eager shipping solve each. Where the lean block does not
fit, kernel 3 reads the node constraint Jacobians from device memory where
its products of A and A' use them (the far layout), and phase 26 holds it:
built so at 20 and 24 segments of order 3, where the lean layout fits, it
gives every output of the lean layout bitwise at B=2048 (times in turns,
with ptxas's registers and spills); then the Panda at 25 segments of order
3 (76 nodes, 1597 variables, 2008 rows, 1024 threads) is planned as a user
sets it, with kernels 2 and 3 against their plain versions and timed, the
captured shipping solve of the headline states (5/2/2/0, bitwise its eager
solve, quality, times in turns) and the JAX fixture
``torch_port_seg25_b64.npz``; seeded chains of 9 joints at 16 segments and
10 joints at 13 and order 4 at 17 segments (49, 40, 69 nodes), kernels 2
and 3 held and an eager shipping solve each. Phase 27 plans the Panda with
its hand (9 joints, a branched tree with two prismatic fingers) at 19
nodes under ``fused_constraints="off"``, its constraint rows on the plain
path on the card: kernels 2 and 3 held and timed on its QPs, the captured
shipping solve of the headline states with the fingers added (0/2/2/0,
bitwise its eager solve, quality, times in turns) and the JAX fixture
``torch_port_hand9_b64.npz``. Where the far block does not fit, kernel 3's
inverted diagonal blocks travel through the copier's ring with each node's
run (the deep layout), and phase 28 holds it: built so at 25 and 31
segments of order 3, where the far layout fits, it gives every output of
the far layout bitwise at B=2048 (times in turns, with ptxas's registers
and spills); then the Panda at 32 segments of order 3 (97 nodes, 2038
variables, 2568 rows, 864 threads) is planned as a user sets it, with
kernels 2 and 3 against their plain versions and timed, the captured
shipping solve of the headline states (5/2/2/0, bitwise its eager solve,
quality, times in turns) and the JAX fixture ``torch_port_seg32_b64.npz``;
order 4 at 22 segments, a seeded 10-joint chain at 17 segments, the hand
at 21 segments and the Panda at 40 segments (89, 52, 64, 121 nodes),
kernels 2 and 3 held and an eager shipping solve each. Past 10 joints
(blocks of 33 x 33 and more) a lane of kernels 2 and 3 owns two rows of a
block, kernel 3's sweeps read their blocks where
they lie, and kernel 1's Jacobian tiles lie in dynamic shared memory; phase
29 holds it: (a) up to 10 joints the builds are bitwise those of the
sources as they were with one row a lane (``csrc/one_row/``), kernel 3 at
its eight layouts' geometries at B=512 and the full budget with ptxas's
registers and spill stores, kernel 2 at 7 and 10 joints, kernel 1 at 7 and
10; (b) kernels 1 and 2 at 11, 12 and 14 joints and kernel 3 at 12 joints
in each of its seven layouts and at 11 joints in the stream layout against
their plain versions, their blocks against the Python reckoning; (c) the
seeded 12-joint chain at 19 nodes (685 variables, 823 rows, kernel 3 in its
lean layout): kernels 2 and 3 timed against their plain versions, the
captured shipping solve of its 2048 seeded states (5/2/2/0, bitwise its
eager solve, times in turns; its quality read, not held) and the JAX
fixture ``torch_port_chain12_b64.npz``; 11 and 14 joints solved eagerly.
Where the deep block does not fit one SM, kernel 3 runs a problem on a
cluster of two blocks (the pair layout: rank 1 holds the copier's ring, and
rank 0 reads its blocks from rank 1's shared memory), and phase 30 holds it:
(a) built so at 32 and 51 segments of order 3 and at 12 joints x 12, where
the deep layout fits, it gives every output of the deep layout bitwise at
B=2048 (times in turns, ptxas's registers and spills of both); (b) the
seven geometries the deep layout refused (52 x 3, order 4 x 34, seeded
chains of 9 joints x 37, 10 x 30, 11 x 25, 12 x 20 and 14 x 12): their
blocks against the reckoning, kernels 2 and 3 against their plain
versions, kernel 3 timed and an eager shipping solve each; (c) the Panda at
52 segments of order 3 (157 nodes, 3298 variables, 4168 rows, five
elements a thread) as a user sets it: kernels 2 and 3 timed, the captured
shipping solve of the headline states (5/2/2/0, bitwise its eager solve,
quality) and the JAX fixture ``torch_port_seg52_b64.npz``; (d) the first
geometries past the pair layout and the slim one (phase 33) refused naming
the bytes of both their clusters' blocks, before any build. Every joint
count kernel 1 takes (1 to 21) plans at 19 nodes: where one rank 1 cannot
hold the pair layout's ring (16 to 21 joints) the ring is spread over two
or three ring ranks, a cluster of three or four blocks; where kernel 2's
ring of the last bw nodes does not fit its block (20 and 21 joints) it is
read back from device memory; at one joint kernel 3's block takes the
warps its sweeps need. Phase 31 holds them: (a)
the ring spread over two ranks at 14 joints x 12 bitwise its one-rank
build, kernel 2's device ring bitwise its shared ring at 14 and 19 joints;
(b) kernels 1-3 at 1, 16, 19, 20 and 21 joints against their plain
versions, their blocks against the reckoning; (c) the seeded 21-joint chain
(1198 variables, 1426 rows): kernel 3 timed, the eager shipping solve of
its first B_SPREAD states (5/2/2/0) and the JAX fixture
``torch_port_chain21_b64.npz``; 1, 16, 19 and 20 joints solved eagerly; (d)
the first grids past the spread ring (and the slim layout) at 16 and 21
joints refused. Past 21
joints kernel 1 reads its robot from device memory (past 23 joints each
thread writes its columns of J to device memory itself), a lane of kernels
2 and 3 holds three rows of a block, and kernel 3's ring spreads over three
ranks (22, 23 joints) or four (24, 25 joints: a cluster of five); phase 32
holds them: (a) kernel 1 at 22, 24, 25, 28 and 32 joints against its plain
version, its block against the reckoning; (b) kernels 2 and 3 at 22, 24 and
25 joints at 19 nodes and 28 joints at 7 nodes against their plain
versions, their blocks against the reckoning, timed; (c) the main path: the
seeded 25-joint chain (1426 variables, 1694 rows), the captured shipping
solve of its first B_WIDE states (5/2/2/0, bitwise its eager solve) and the
JAX fixture ``torch_port_chain25_b64.npz``; 22 and 24 joints at 19 nodes
and 28 at 7 solved eagerly; (d) the first grids past the slim layout at 22
and 25 joints refused naming their bytes. Past 25 joints at 19 nodes the
pair layout's rank 0 does not fit for its staging buffers, and kernel 3
takes the slim layout (the pair's with rank 0's staging buffers cut to
those in use at one time; the ring over seven ranks, a cluster of eight,
from 29 joints), and past 27 kernel 2 takes its scratch build (the inverse
and the far sums of its forward loop in Ldi); phase 33 holds them: (a) slim
bitwise pair at 25 joints; (b) the scratch build bitwise the device ring
at 25 joints; (c) kernels 2 and 3 at 26, 28, 30 and 32 joints against
their plain versions, their blocks against the reckoning, timed, solved
eagerly but at 32; (d) 14 joints x 26 (79 nodes), slim with one ring rank;
(e) the main path: the seeded 32-joint chain (1825 variables, 2163 rows),
its captured shipping solve (5/2/2/0, bitwise its eager solve) and the JAX
fixture ``torch_port_chain32_b64.npz``; (f) kernel 1 at 33 joints, 32
joints at 22 nodes and the Panda at 181 nodes refused naming their bytes.
The plain kernel-3 loop of phases 19-33 replays each check window from a
CUDA graph (``PlainWindows``), which phase 10 holds bitwise against the
eager loop.
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
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
STATES = os.path.join(FIXTURES, "headline_states_b2048.npz")
FIXTURE = os.path.join(FIXTURES, "torch_port_slice_b64.npz")
DENSE_FIXTURE = os.path.join(FIXTURES, "torch_port_dense_b64.npz")
# the JAX structured solve of the first 64 headline states at 8 segments
SEG8_FIXTURE = os.path.join(FIXTURES, "torch_port_seg8_b64.npz")
# the transcriptions kernels 2 and 3 are built for: 6, 8 and 4 segments of
# order 3 (19, 25 and 13 nodes)
SEGMENTS = (6, 8, 4)
# and in phase 21, (order, segments): band widths 2, 4 and 5 at 19, 17 and
# 16 nodes; order 4 x 4 is the phase's main path
ORDERS = ((2, 9), (4, 4), (5, 3))
# the JAX structured solve of the first 64 headline states at order 4 x 4
# and at order 4 x 6 (make_order4_fixture.py)
ORDER4_FIXTURE = os.path.join(FIXTURES, "torch_port_order4_b64.npz")
ORDER4S6_FIXTURE = os.path.join(FIXTURES, "torch_port_order4s6_b64.npz")
# the JAX structured solve of the first 64 headline states at 12 segments
SEG12_FIXTURE = os.path.join(FIXTURES, "torch_port_seg12_b64.npz")
# and at 15 segments (46 nodes, kernel 3 at two elements a thread)
SEG15_FIXTURE = os.path.join(FIXTURES, "torch_port_seg15_b64.npz")
# and at 20 segments (61 nodes, kernel 3 in its lean layout)
SEG20_FIXTURE = os.path.join(FIXTURES, "torch_port_seg20_b64.npz")
# and at 25 segments (76 nodes, kernel 3 in its far layout)
SEG25_FIXTURE = os.path.join(FIXTURES, "torch_port_seg25_b64.npz")
# and at 32 segments (97 nodes, kernel 3 in its deep layout)
SEG32_FIXTURE = os.path.join(FIXTURES, "torch_port_seg32_b64.npz")
# and at 52 segments (157 nodes), with the JAX float32 solve's final times
SEG52_FIXTURE = os.path.join(FIXTURES, "torch_port_seg52_b64.npz")
# the JAX structured solve of the Panda with its hand (9 joints) on the
# first 64 headline states with the fingers added (make_panda6_fixture.py --hand)
HAND9_FIXTURE = os.path.join(FIXTURES, "torch_port_hand9_b64.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)
B_MAIN = 2048  # the headline batch
B_FACTOR = 256  # kernel-2 comparison batch
B_ADMM = 64  # kernel-3 and kernel-4 comparison batch
B_ODD = 61  # a batch that is no round number
B_XLA = 128  # phase 14's batch of the dense "xla" path
# phases 19-29's batch of kernels 2 and 3 timed against their plain versions
# (time_structured_kernels), a quarter of the headline's: the plain kernel-3
# loop takes seconds there
B_TIME = 512
N_ACCEPT, B_ACCEPT = 1000, 250  # the acceptance's states and batch (phase 12)
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


def band_blocks(nodes: int, bw: int) -> int:
    """Sub-diagonal blocks L[k,k-d] (1 <= d <= bw) of a band of ``nodes``
    nodes: those a banded sweep reads (3N - 6 at bw = 3)."""
    return sum(min(bw, k) for k in range(nodes))


def k3_iter_flops(segments: int, nq: int = 7, order: int = 3, kkt_refine: int = 0) -> float:
    """K3_ITER_FLOPS at another transcription (``segments`` spline segments
    of ``order``, nodes N = order x segments + 1, band width = order) and
    joint count (blk = 3 nq): the sweeps 2 x (N x blk (blk + 1) / 2 +
    band_blocks x blk^2) multiply-adds, A and A' 2 x (neq x (order + 3) +
    (nq + 1) N x blk), the arrow 4 x blk N, ~29 flop per element-wise update
    (157.3 kflop at 19 nodes, 210.6 at 25, for the Panda at order 3); each
    of ``kkt_refine`` refinement steps runs the sweeps, A, A' and the arrow
    once more, with ~3 flop per element (K3_REFINE_FLOPS at 19 nodes)."""
    N, blk = order * segments + 1, 3 * nq
    neq = segments * (order + 1) * 2 * nq
    nv, nm = blk * N + 1, neq + (nq + 1) * N
    macs = (2 * (N * blk * (blk + 1) // 2 + band_blocks(N, order) * blk * blk)
            + 2 * (neq * (order + 3) + (nq + 1) * N * blk) + 4 * blk * N)
    return 2 * macs * (1 + kkt_refine) + (29 + 3 * kkt_refine) * (nv + nm)


def k1_flops(nq: int, with_jac: bool) -> float:
    """K1_VALUE_FLOPS for a chain of nq joints (the sweeps' work grows with
    the joints), times 1 + 2 x 3 nq with the Jacobian's tangents."""
    value = K1_VALUE_FLOPS * nq / 7
    return value * (1 + 2 * 3 * nq) if with_jac else value


def geometries():
    """The ``build.Geometry`` of each of SEGMENTS."""
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    return tuple(Geometry(segments=s) for s in SEGMENTS)


T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's report, with the seconds since the script started."""
    print(f"{msg} [{time.perf_counter() - T0:.0f} s]", flush=True)


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
    macs += 2 * (nodes * blk * (blk + 1) / 2 + band_blocks(nodes, bw) * blk**2)  # the arrow's sweeps
    return 2 * macs


def report_bound(entry, flops, nbytes, what, library=None):
    """Store a kernel's bound beside its measured time; return the text.
    ``library``: the PyTorch call that computes the same function, timed in
    a later phase (``library_ms`` stays null where there is none)."""
    ms, by = bound(flops, nbytes)
    entry.update(bound_ms=ms, bound_by=by, library_ms=None)
    return (f"bound {ms:.4f} ms by {by} ({flops / 1e9:.3f} GFLOP at {FP32_TFLOPS} TFLOP/s, "
            f"{nbytes / 1e6:.1f} MB at {HBM_TBPS} TB/s; {what}), share reached "
            f"{100 * ms / entry['ms']:.1f}%; "
            + (f"library call: {library}" if library else
               "no single PyTorch call computes this function"))


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


def time_kernel(fn, reps=3, behind=None, warm=True):
    """Mean ms per call of ``fn`` with CUDA events, after one warm-up call
    (none if not ``warm``). ``behind`` keeps the card busy for longer than
    the host needs to enqueue the calls, so that they queue up and the
    events time the device alone: for a kernel that is shorter than its
    wrapper's host time."""
    if warm:
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


def iteration_gaps(a, b):
    """Of the problems both solves converged: how many iteration counts are
    within 25, how many there are, the median and the largest gap."""
    both = a.converged & b.converged
    gaps = (a.iterations - b.iterations).abs()[both]
    if not both.any():
        return 0, 0, 0, 0
    return int((gaps <= 25).sum()), int(both.sum()), int(gaps.median()), int(gaps.max())


def iteration_agreement(got, ref, B, what, ref64=None):
    """The float32 parity bars of two ADMM solves of the same QPs (phase 4's
    rule, reasons in PERF.md): converged agrees on all but B/32 (2 at B=64),
    and the iteration counts of problems both converged are within 25 for
    all but B/8 with a median gap of 0. Where the counts miss that bar and
    ``ref64`` is given (a function that returns the plain loop's solve of
    the same QPs at float64), the bar's premise is tested: if the plain
    float32 solve ``ref`` itself misses it against float64 (two float32
    orders of the loop part on more problems at 37 nodes, PERF.md §6),
    the kernel is held to float64 instead, as phase 4 (a) holds one window:
    no more of its counts more than 25 from float64's than twice the plain
    float32 solve's, median gap 0. Returns a summary string."""
    agree = int((got.converged == ref.converged).sum())
    check(agree >= B - max(2, B // 32), f"{what}: convergence agrees on only {agree}/{B}")
    n_within, n_both, med_gap, max_gap = iteration_gaps(got, ref)
    text = (f"converged agree {agree}/{B} (kernel {int(got.converged.sum())}, plain "
            f"{int(ref.converged.sum())}), iteration counts within 25 on "
            f"{n_within}/{n_both} (bar: all but {B // 8}), median gap {med_gap}, "
            f"max gap {max_gap}")
    if (n_within >= n_both - B // 8 and med_gap == 0) or ref64 is None:
        check(n_within >= n_both - B // 8 and med_gap == 0,
              f"{what}: iteration counts {n_within}/{n_both} within 25, median gap {med_gap}")
        return text
    sol64 = ref64()
    p_within, p_both, p_med, p_max = iteration_gaps(ref, sol64)
    check(p_within < p_both - B // 8 or p_med != 0,
          f"{what}: iteration counts {n_within}/{n_both} within 25 of the plain float32 "
          f"solve's, which is within 25 of float64's on {p_within}/{p_both}")
    k_within, k_both, k_med, k_max = iteration_gaps(got, sol64)
    check(k_both - k_within <= 2 * (p_both - p_within) and k_med == 0,
          f"{what}: iteration counts {k_within}/{k_both} within 25 of float64's, the plain "
          f"float32 solve's {p_within}/{p_both}, median gap {k_med}")
    return (text + f"; the plain float32 solve itself within 25 of the plain float64 solve's "
            f"on {p_within}/{p_both} (median gap {p_med}, max {p_max}), so the kernel is held "
            f"to float64: within 25 on {k_within}/{k_both} (bar: no more than twice the plain "
            f"float32 solve's {p_both - p_within} off), median gap {k_med}, max gap {k_max}")


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


def fixture_agreement(planner, path, dev, counts=None):
    """Solve a JAX fixture's states; count the problems whose final time is
    within 1e-3 relative, whose qp_converged is the same and whose terminal
    error is within the target box. Returns (count, count of final times
    within 1e-3 relative alone, batch, summary); ``counts``, a dict where
    given, receives the count of the same qp_converged alone as
    ``"qp_converged"``, of the states with a QP the JAX solve converged and
    this one did not as ``"converged_lost"``, and of the states whose
    terminal error is within the target box as ``"in_box"``."""
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
    n_tf = int((tf_rel <= 1e-3).sum())
    if counts is not None:
        conv_ref = torch.as_tensor(fx["qp_converged"], device=dev)
        counts["qp_converged"] = int(conv_same.sum())
        counts["converged_lost"] = int((conv_ref & ~sol.qp_converged).any(-1).sum())
        counts["in_box"] = int((err <= tol).sum())
    zgap = (sol.z - torch.as_tensor(fx["z"], device=dev)).abs().amax(-1)
    vgap = (sol.violation - torch.as_tensor(fx["violation"], device=dev)).abs()
    return n_good, n_tf, cur.shape[0], (
        f"{n_good}/{cur.shape[0]} agree (final_time within 1e-3 relative, same qp_converged, "
        f"terminal error <= {tol}); largest gaps: final_time rel {float(tf_rel.max()):.2e}, "
        f"z max-abs {float(zgap.max()):.3e}, violation {float(vgap.max()):.3e}, "
        f"qp_converged mismatches {int((~conv_same).sum())}, terminal error "
        f"{float(err.max()):.5f}"
    )


def jax_float32_final_times(path) -> int:
    """Of a JAX fixture's states, how many final times of the JAX package's
    own float32 solve (its ``final_time_float32``, ``make_torch_seg8_fixture.py
    --float32``) lie within 1e-3 relative of its float64 ones: the figure a
    float32 solve of these states reaches in the reference package (all of
    them where the fixture has no float32 solve)."""
    fx = np.load(path)
    if "final_time_float32" not in fx:
        return fx["final_time"].shape[0]
    tf, tf32 = fx["final_time"].astype(np.float64), fx["final_time_float32"].astype(np.float64)
    return int((np.abs(tf32 - tf) / np.abs(tf) <= 1e-3).sum())


def entry_points(planner) -> None:
    """Phases 11-13: the port's three user entry points in this process, on
    the card, each with the launch counts set to 0 just before it and read
    just after. ``planner`` is the shipping one of phase 5 (its limits and
    margins are the acceptance's)."""
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.bench import acceptance, analysis, headline
    from mpc_motion_planner_tpu_torch.bench.harness import benchmark_records
    from mpc_motion_planner_tpu_torch.examples import offline_trajectory
    from mpc_motion_planner_tpu_torch.utils.io import read_benchmark_records, write_benchmark_records

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
        # the capture's warm-up solve, the timed replays, as many eager solves
        n_solves = 1 + 2 * repeats
        check(counts == {k: n * n_solves for k, n in per_solve.items()},
              f"headline {backend}: launch counts {counts} for {n_solves} solves")
        check(line["solve"] == "cuda_graph" and line["eager_resolves"] == 0,
              f"headline {backend}: solve {line['solve']}, {line['eager_resolves']} eager re-solves")
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
            f"{ {k: n // n_solves for k, n in counts.items()} }, captured {line['value']:.1f} "
            f"solves/s ({1e3 * line['batch_wall_s']:.2f} ms), eager "
            f"{line['eager_solves_per_s']:.1f} solves/s ({1e3 * line['eager_batch_wall_s']:.2f} "
            f"ms), kernel-2 flags {line['repairs']} on {line['device']}; JAX record on these "
            f"states {json.dumps(JAX_RECORD)}")

    # ---- phase 12: the port's acceptance entry point on the 1000 states of
    # the JAX acceptance artifact, against the JAX analysis of it ----
    argv = ["--states-from", ARTIFACT, "--n", str(N_ACCEPT), "--batch", str(B_ACCEPT)]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "records.txt")
        kernels.reset_launch_counts()
        text = run_main(acceptance.main, argv + ["--out", out])
        counts = kernels.launch_counts()
        rec = read_benchmark_records(out)
        # the same batches solved eagerly, through the same records writer
        a = acceptance.parse_args(argv)
        eager_planner = acceptance.make_planner(a, planner.device, planner.dtype)
        cur_e, tgt_e = acceptance.states_from_records(eager_planner, ARTIFACT, N_ACCEPT)
        eager = [benchmark_records(eager_planner, eager_planner.solve(c, t), t)[0]
                 for c, t in zip(cur_e.split(B_ACCEPT), tgt_e.split(B_ACCEPT))]
        out_e = os.path.join(tmp, "records_eager.txt")
        write_benchmark_records(out_e, torch.cat(eager).double().cpu().numpy())
        rec_e = read_benchmark_records(out_e)
    check(rec.shape == (N_ACCEPT, 162) and bool(np.isfinite(rec).all()),
          f"acceptance records {rec.shape}")
    # one capture (its warm-up is one eager solve) and a replay per batch
    n_solves = 1 + N_ACCEPT // B_ACCEPT
    check(counts == {"constraints": 5 * n_solves, "banded_factor": 2 * n_solves,
                     "structured_admm": 2 * n_solves, "admm_dense": 0},
          f"acceptance launch counts {counts} for {n_solves} solves")
    check("capture:" in text, "the acceptance did not capture its solve")
    n_diff = int((rec != rec_e).any(axis=1).sum())
    same_tables = all(
        f(rec) == f(rec_e) for f in (
            lambda r: analysis.violation_counts_reference(r, planner.limits),
            lambda r: analysis.violation_counts(r, planner.limits, planner.margins),
            analysis.accuracy_stats))
    check(n_diff == 0 and same_tables,
          f"captured acceptance: {n_diff} of {N_ACCEPT} records differ from the eager solves', "
          f"tables equal: {same_tables}")
    for ln in text.splitlines():
        if ln.startswith(("batch ", "total:", "capture:")):
            log(f"phase 12 acceptance {ln}")
    log(f"phase 12 acceptance through the captured solve: all {N_ACCEPT} records and the "
        f"tables bitwise those of the eager solves of the same batches")
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


SOLUTION_FIELDS = ("z", "violation", "lam_c", "lam_x", "qp_iterations", "qp_converged",
                   "step_sizes")


def hold_captured(got, ref, ref2, what):
    """A captured solve against the eager one: each field bitwise, or, where
    two eager solves in a row already differ, within their gap. ``ref2``:
    the second eager solve, or a function that makes it, called only where
    a field is not bitwise (a solve takes 24 s at 157 nodes). Returns a
    summary."""
    held = []
    for f in SOLUTION_FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        if torch.equal(a, b):
            continue
        if callable(ref2):
            ref2 = ref2()
        c = getattr(ref2, f)
        if torch.equal(b, c):
            check(torch.equal(a, b), f"{what}: captured {f} differs from the eager solve's by "
                  f"{max_abs(a, b):.3e}")
        else:
            gap = max_abs(b, c)
            check(max_abs(a, b) <= gap, f"{what}: captured {f} differs from the eager solve's by "
                  f"{max_abs(a, b):.3e}, two eager solves by {gap:.3e}")
            held.append(f"{f} within the eager-eager gap {gap:.3e}")
    return "bitwise" if not held else "bitwise but " + ", ".join(held)


def replay_idle_share(fn, cur, tgt):
    """One call of ``fn`` under torch.profiler: (wall ms, device-busy ms,
    idle share, device events)."""
    from mpc_motion_planner_tpu_torch.bench.profile_solve import profiled, union_ms

    ms, _, events = profiled(fn, cur, tgt)
    busy = union_ms((a, b) for _, a, b in events)
    return ms, busy, 1.0 - busy / ms, len(events)


def captured_phases(paths, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phases 14-18: the compiled solve (``utils/capture.py``). Each path's
    captured solve against its eager solve at B=2048 (the dense "xla" path at
    B_XLA, timed in one turn) with the launch counts
    of one replay; kernel 2's ok-flag repair inside a graph against the eager
    repair; the one-card mesh; the stage timings; kernel 2's library call."""
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels.build import DeviceCount
    from mpc_motion_planner_tpu_torch.ops import qp_structured
    from mpc_motion_planner_tpu_torch.parallel import mesh
    from mpc_motion_planner_tpu_torch.utils.capture import capture_solve
    from mpc_motion_planner_tpu_torch.utils.profiling import stage_timings_structured

    dev = cur_all.device
    shipping_replay = None
    # ---- phase 14: each path captured, against its eager solve ----
    for name, planner in paths.items():
        # the dense "xla" path (a PyTorch loop, 4 s a solve at B=2048) at
        # B_XLA, and every path but the shipping one in one timing turn, to
        # keep the script inside its time
        B = B_XLA if name == "xla" else B_MAIN
        turns = 3 if name == "structured_pallas" else 1
        cur, tgt = cur_all[:B], tgt_all[:B]
        t0 = time.perf_counter()
        solve = capture_solve(planner, cur, tgt)
        torch.cuda.synchronize()
        t_capture = time.perf_counter() - t0
        check(solve.captured, f"{name}: the solve was not captured")
        kernels.reset_launch_counts()
        got = solve(cur, tgt)
        torch.cuda.synchronize()
        counts_r = kernels.launch_counts()
        kernels.reset_launch_counts()
        ref = planner.solve(cur, tgt)
        torch.cuda.synchronize()
        counts_e = kernels.launch_counts()
        check(counts_r == counts_e and counts_r["constraints"] == 5,
              f"{name}: launches per replay {counts_r}, per eager solve {counts_e}")
        held = hold_captured(got, ref, lambda: planner.solve(cur, tgt), name)
        check(solve.eager_resolves == 0, f"{name}: {solve.eager_resolves} eager re-solves")
        times = {"replay": [], "eager": []}
        for mode in ("replay", "eager", "eager", "replay", "replay", "eager")[:2 * turns]:
            fn = solve if mode == "replay" else planner.solve
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(cur, tgt)
            torch.cuda.synchronize()
            times[mode].append(1e3 * (time.perf_counter() - t0))
        med = {k: float(np.median(v)) for k, v in times.items()}
        # (only the shipping path is traced: the xla path's 86k device
        # operations took ~20 s of the script under the profiler)
        traced = "not traced"
        if name == "structured_pallas":
            r_ms, r_busy, r_idle, r_events = replay_idle_share(solve, cur, tgt)
            e_ms, e_busy, e_idle, _ = replay_idle_share(planner.solve, cur, tgt)
            traced = (f"one traced replay {r_ms:.2f} ms, device busy {r_busy:.2f} ms ({r_events} "
                      f"device events), idle share {r_idle:.3f}; one traced eager solve "
                      f"{e_ms:.2f} ms, busy {e_busy:.2f} ms, idle share {e_idle:.3f}")
        q = quality(planner, got, tgt)
        log(f"phase 14 captured {name} B={B}: capture {t_capture:.2f} s; {held} against "
            f"the eager solve (7 fields); launches per replay {counts_r} (eager {counts_e}); "
            f"median of {turns} in turns: replay {med['replay']:.2f} ms = "
            f"{B / med['replay'] * 1e3:.1f} "
            f"solves/s, eager {med['eager']:.2f} ms = {B / med['eager'] * 1e3:.1f} solves/s "
            f"(replays {[round(t, 2) for t in times['replay']]}, eager "
            f"{[round(t, 2) for t in times['eager']]}); {traced}; "
            f"{solve.eager_resolves} eager re-solves after a repair overflow; qp_conv_rate "
            f"{q['qp_conv_rate']}, tol_hit_rate {q['tol_hit_rate']}, median violation "
            f"{q['median_violation']} on {smi}")
        if name == "structured_pallas":
            shipping_replay = (planner, got)
        del solve, got, ref
        torch.cuda.empty_cache()

    # ---- phase 15: kernel 2's ok-flag repair inside a graph ----
    _, sa, args, sc, sx = first_qp(B_MAIN)
    shipping = paths["structured_pallas"].qp_settings
    qp = qp_structured.scale_qp(paths["structured_pallas"].ocp, sa, *args, shipping,
                                soft_c=sc, soft_x=sx)
    cap = k2.repair_capacity(B_MAIN)

    def captured_factor(pc):
        """k2.factor with the arrow column ``pc`` captured into a graph and
        replayed once: (outputs, flagged problems the replay left
        unrepaired, flagged problems)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            k2.factor(qp.Mband, pc, qp.m_pp, 3)
        torch.cuda.current_stream().wait_stream(side)
        sink = DeviceCount()
        sink.add(torch.zeros((), dtype=torch.int64, device=dev))
        graph = torch.cuda.CUDAGraph()
        k2.CAPTURE_SINKS.append(sink)
        try:
            with torch.cuda.graph(graph):
                out = k2.factor(qp.Mband, pc, qp.m_pp, 3)
        finally:
            k2.CAPTURE_SINKS.remove(sink)
        k2.REPAIRS.reset()
        graph.replay()
        torch.cuda.synchronize()
        return {k: v.clone() for k, v in out.items()}, sink.count, k2.REPAIRS.count

    keys = ("Ldi", "Lsub", "u", "s", "ok")
    for n_bad in (3, cap + 2):
        bad = torch.arange(n_bad, device=dev) * (B_MAIN // n_bad) + 1
        # an arrow column 1e10 times longer: u = M^-1 p_col passes kernel 2's
        # saturation level, so kernel 2 flags the problem (and clamps its
        # factors), while the plain factorization stays finite
        pc = qp.p_col.clone()
        pc[bad] *= 1e10
        got, left, flagged = captured_factor(pc)
        eager = k2.factor(qp.Mband, pc, qp.m_pp, 3)
        raw = k2.factor_banded_kernel(qp.Mband, pc, qp.m_pp)
        torch.cuda.synchronize()
        check(flagged == n_bad and left == max(0, n_bad - cap),
              f"repair in a graph: {flagged} flagged, {left} left unrepaired, of {n_bad} with a "
              f"saturating arrow column and {cap} repair slots")
        unrepaired = bad[cap:]  # the flags past the capacity, in batch order
        rest = torch.ones(B_MAIN, dtype=torch.bool, device=dev)
        rest[unrepaired] = False
        for k in keys:
            check(torch.equal(got[k][rest], eager[k][rest]),
                  f"repair in a graph: {k} differs from the eager repair")
            check(torch.equal(got[k][unrepaired], raw[k][unrepaired]),
                  f"repair in a graph: {k} of an unrepaired problem is not kernel 2's")
        repaired = bad[:cap]
        check(bool(torch.isfinite(eager["u"][bad]).all())
              and float(eager["u"][bad].abs().amax()) > 1e8 >= float(raw["u"][bad].abs().amax()),
              "repair in a graph: the eager repair did not replace kernel 2's clamped factors")
        check(float(got["u"][repaired].abs().amax()) > 1e8,
              "repair in a graph: the replay did not replace kernel 2's clamped factors")
        log(f"phase 15 kernel 2 repair in a graph, B={B_MAIN}, {n_bad} problems with a "
            f"saturating arrow column, {cap} repair slots: {flagged} flagged; the replay's factors are bitwise "
            f"the eager repair's on every problem it repaired and every unflagged one; it left "
            f"{left} unrepaired (kernel 2's own factors, counted for the captured solve, which "
            f"then solves its batch again eagerly), the eager repair none")
    del got, eager, raw, pc

    # ---- phase 16: the one-card mesh ----
    planner, replay_sol = shipping_replay
    devices = mesh.make_mesh()
    check(len(devices) == torch.cuda.device_count() == 1, f"mesh {devices}")
    kernels.reset_launch_counts()
    sol_m, stats = mesh.sharded_solve_fn(planner, devices)(cur_all, tgt_all)
    torch.cuda.synchronize()
    held = hold_captured(sol_m, replay_sol, replay_sol, "one-card mesh")
    formulas = {"mean_violation": replay_sol.violation.mean(),
                "max_violation": replay_sol.violation.max(),
                "mean_qp_iterations": replay_sol.qp_iterations.float().mean(),
                "num_converged": replay_sol.qp_converged.all(-1).sum()}
    check(all(torch.equal(stats[k], v) for k, v in formulas.items()),
          f"one-card mesh stats {stats} against {formulas}")
    log(f"phase 16 sharded_solve_fn on the mesh {devices}: {held} against the captured solve; "
        f"stats {json.dumps({k: v.item() for k, v in stats.items()})}; launches "
        f"{kernels.launch_counts()} (its capture's warm-up and one replay)")
    del sol_m, replay_sol

    # ---- phase 17: the stage timings on the card ----
    st = stage_timings_structured(planner, cur_all, tgt_all, repeats=3)
    check("factor_kernel" in st and st["total"]["median_s"] > 0, f"stage timings {st.keys()}")
    log(f"phase 17 stage_timings_structured B={B_MAIN} (median ms of 3): " + ", ".join(
        f"{k} {1e3 * v['median_s']:.3f}" for k, v in st.items() if isinstance(v, dict))
        + f"; admm_loop_derived {1e3 * st['admm_loop_derived_s']:.3f} ms; "
        f"{st['solves_per_s']:.1f} solves/s (total: the captured solve)")

    # ---- phase 18: kernel 2's library call, the dense Cholesky of M ----
    library_factor(qp, results["banded_factor"], "phase 18")


def library_factor(qp, entry, phase, batch=None) -> None:
    """Kernel 2's library call, ``torch.linalg.cholesky_ex`` of the dense
    KKT matrix that the band of ``qp`` stands for (of its first ``batch``
    problems where given, written as the entry's ``library_batch``): timed
    into ``entry``'s ``library_ms``, and its factor held against kernel 2's
    (relative error <= 1e-3 where both factored). The dense matrices and
    their factors take 42 GB at B=2048 and 76 nodes (68 GB at 97 nodes,
    which do not fit beside the rest: 34 GB at B=1024), which the cache
    gives back afterwards."""
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2

    timed_at = qp.Mband.shape[0]  # the batch of kernel 2's time in the entry
    if batch is not None:
        qp = types.SimpleNamespace(Mband=qp.Mband[:batch], p_col=qp.p_col[:batch],
                                   m_pp=qp.m_pp[:batch])
        entry["library_batch"] = batch
    B, N, bw, W = qp.Mband.shape[0], qp.Mband.shape[1], qp.Mband.shape[2] - 1, qp.Mband.shape[3]
    n = N * W + 1
    Md = torch.zeros(B, n, n, device=qp.Mband.device)
    for k in range(N):
        for d in range(bw + 1):
            if k + d < N:
                blk = qp.Mband[:, k, d]
                Md[:, (k + d) * W:(k + d + 1) * W, k * W:(k + 1) * W] = blk
                if d:
                    Md[:, k * W:(k + 1) * W, (k + d) * W:(k + d + 1) * W] = blk.transpose(1, 2)
    Md[:, -1, :-1] = qp.p_col.reshape(B, -1)
    Md[:, :-1, -1] = qp.p_col.reshape(B, -1)
    Md[:, -1, -1] = qp.m_pp
    lib_ms = time_kernel(lambda: torch.linalg.cholesky_ex(Md), reps=3)
    L, info = torch.linalg.cholesky_ex(Md)
    fk = k2.factor_banded_kernel(qp.Mband, qp.p_col, qp.m_pp)
    torch.cuda.synchronize()
    use = fk["ok"] & (info == 0)
    diag = torch.stack([L[:, k * W:(k + 1) * W, k * W:(k + 1) * W] for k in range(N)], 1)
    eye = torch.eye(W, device=Md.device).expand_as(diag)
    Ldi = torch.linalg.solve_triangular(diag, eye, upper=False)
    Lsub = torch.zeros_like(fk["Lsub"])
    for k in range(N):
        for d in range(1, bw + 1):
            if k + d < N:
                Lsub[:, k, d - 1] = L[:, (k + d) * W:(k + d + 1) * W, k * W:(k + 1) * W]
    errs = {"Ldi": rel_err(fk["Ldi"][use], Ldi[use]), "Lsub": rel_err(fk["Lsub"][use], Lsub[use]),
            "s": rel_err(fk["s"][use], L[use, -1, -1] ** 2)}
    check(max(errs.values()) <= 1e-3, f"kernel 2 against torch.linalg.cholesky_ex: {errs}")
    entry["library_ms"] = lib_ms
    log(f"{phase} kernel 2's library call, torch.linalg.cholesky_ex of the dense {n} x {n} M "
        f"at B={B}, {N} nodes, float32: {lib_ms:.3f} ms against kernel 2's {entry['ms']:.3f} ms "
        f"at B={timed_at} ({'slower' if lib_ms > entry['ms'] else 'faster'} than the kernel); "
        f"its factor "
        f"against kernel 2's on {int(use.sum())}/{B} problems (both factored): max-norm "
        f"relative error " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()) + " (tol 1e-3)")
    del Md, L, diag, Ldi, Lsub
    torch.cuda.empty_cache()


def factor_check(planner, first_qp, tag, states=None):
    """Kernel 2 built for ``planner``'s transcription against its plain
    version on the step-0 QPs of B_FACTOR states (``states``: another
    robot's; default the headline's), with phase 3's bars: identical ok
    flags, max-norm relative error <= 1e-3. Returns the step-0 QPs' parts
    (sa, args, soft_c, soft_x) and a summary."""
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.ops import qp_structured

    ocp, shipping = planner.ocp, planner.qp_settings
    _, sa, args, sc, sx = first_qp(B_FACTOR, pl=planner, states=states)
    qp = qp_structured.scale_qp(ocp, sa, *args, shipping, soft_c=sc, soft_x=sx)
    fk = k2.factor_banded_kernel(qp.Mband, qp.p_col, qp.m_pp)
    fp = qp_structured.factor_banded(qp.Mband, qp.p_col, qp.m_pp, ocp.coll.order)
    torch.cuda.synchronize()
    check(torch.equal(fk["ok"], fp["ok"]), f"{tag}: kernel 2 ok flags differ from the plain version")
    errs = {k: rel_err(fk[k], fp[k]) for k in ("Ldi", "Lsub", "u", "s")}
    check(max(errs.values()) <= 1e-3, f"{tag}: kernel 2 differs from the plain version: {errs}")
    return (sa, args, sc, sx), (
        f"kernel 2 B={B_FACTOR}: ok flags identical ({int(fk['ok'].sum())}/{B_FACTOR} ok), "
        f"max-norm relative error " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + " (tol 1e-3)")


def kernel_checks(planner, first_qp, tag, states=None, hold_counts=True,
                  read_float64=True) -> str:
    """Kernels 2 and 3 built for ``planner``'s transcription against their
    plain versions on its step-0 QPs of the headline states, with phase 3's
    bars (B_FACTOR problems: identical ok flags, max-norm relative error <=
    1e-3) and phase 4's (B_ADMM problems: one check window no further from
    float64 than 2x the plain float32 loop, the sweeps' order of sums within
    1e-4, the whole QP solve by ``iteration_agreement`` against the plain
    solve, its check windows replayed from CUDA graphs
    (:func:`plain_structured_solve`), hard box rows of
    converged problems within 5e-3 and every hard row within 1.01x the primal
    tolerance). Returns a summary and max |x_kernel - x_plain| after the
    check window (phase 4's ``max_abs_err`` of kernel 3). ``states``: the
    (current, target) states of another robot (default: the headline's).
    ``hold_counts`` False: the full solve's iteration counts are read against
    the plain float32 and (``read_float64``) float64 solves and reported,
    not held (where no float32 loop meets ``iteration_agreement``'s bars,
    PERF.md §7 question 10); its converged flags and hard rows are held as
    everywhere."""
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.ocp import make_ocp
    from mpc_motion_planner_tpu_torch.ops import qp_structured
    from mpc_motion_planner_tpu_torch.ops.structure import apply_A

    ocp, shipping = planner.ocp, planner.qp_settings
    (sa, args, sc, sx), factor_summary = factor_check(planner, first_qp, tag, states)
    B4 = B_ADMM
    sa4 = qp_structured.StructuredA(sa.p[:B4], sa.f_rows[:B4], sa.J[:B4])
    args4 = tuple(a[:B4] for a in args)
    kw = dict(soft_c=sc[:B4], soft_x=sx[:B4])
    qp4 = qp_structured.scale_qp(ocp, sa4, *args4, shipping, **kw)
    fac4 = k2.factor_banded_kernel(qp4.Mband, qp4.p_col, qp4.m_pp)
    s_win = dataclasses.replace(shipping, max_iter=shipping.check_every, rescue_iters=0)
    x_k = k3.admm_kernel(ocp, sa4, qp4, fac4, s_win)[0]
    x_p = qp_structured.admm_plain(ocp, sa4, qp4, fac4, s_win)[0]
    ocp64 = make_ocp(planner.model.to(dtype=torch.float64), planner.tool_frame,
                     order=ocp.coll.order, num_segments=ocp.coll.num_segments)
    qp4_64 = qp_structured.ScaledQP(
        *(getattr(qp4, f.name).double() for f in dataclasses.fields(qp4)))
    fac4_64 = {k: v.double() for k, v in fac4.items() if k != "ok"}
    x_64 = qp_structured.admm_plain(ocp64, sa4.to(dtype=torch.float64), qp4_64, fac4_64,
                                    s_win)[0]
    e_k, e_p = max_abs(x_k, x_64), max_abs(x_p, x_64)
    check(e_k <= 2 * e_p + 1e-6,
          f"{tag}: kernel 3 strays from float64 by {e_k:.3e}, the plain float32 loop by {e_p:.3e}")
    rhs4 = torch.randn(B4, ocp.num_var, generator=torch.Generator().manual_seed(4)).to(x_k.device)
    m_plain = qp_structured.solve_arrow_banded(ocp, fac4, rhs4)
    m_ahead = qp_structured.solve_arrow_banded(ocp, fac4, rhs4,
                                               qp_structured.banded_solve_lookahead)
    e_order = max_abs(m_ahead, m_plain) / float(m_plain.abs().max())
    check(e_order <= 1e-4, f"{tag}: look-ahead order of the sweeps differs by {e_order:.3e}")
    ref = plain_structured_solve(ocp, sa4, args4, shipping, **kw)
    got = k3.solve_box_qp_structured_cuda(ocp, sa4, *args4, shipping, **kw)
    torch.cuda.synchronize()
    solved64 = {}

    def ref64():
        if "sol" not in solved64:
            solved64["sol"] = plain_structured_solve(
                ocp64, sa4.to(dtype=torch.float64), [a.double() for a in args4], shipping,
                **{k: v.double() for k, v in kw.items()})
        return solved64["sol"]

    if hold_counts:
        agreement = iteration_agreement(got, ref, B4, f"{tag}: kernel 3", ref64)
    else:
        agree = int((got.converged == ref.converged).sum())
        check(agree >= B4 - max(2, B4 // 32), f"{tag}: convergence agrees on only {agree}/{B4}")
        pairs = [("kernel against plain", (got, ref))]
        if read_float64:
            sol64 = ref64()
            pairs += [("kernel against float64", (got, sol64)),
                      ("plain against float64", (ref, sol64))]
        gaps = {name: iteration_gaps(a, b) for name, (a, b) in pairs}
        agreement = (f"converged agree {agree}/{B4} (kernel {int(got.converged.sum())}, plain "
                     f"{int(ref.converged.sum())}); iteration counts read, not held: " + "; ".join(
                         f"{name} within 25 on {w}/{n}, median gap {m}, max {x}"
                         for name, (w, n, m, x) in gaps.items()))
    _, lc, uc, lx, ux = args4[1:]
    (box_viol, hard_ratio), (box_p, hard_p) = (
        hard_row_ratio(s_.x, apply_A(ocp, sa4, s_.x), lc, uc, lx, ux, kw["soft_c"],
                       kw["soft_x"], shipping, s_.converged) for s_ in (got, ref))
    # phase 4's box-row bar is the JAX package's 5e-3. On the 13-node
    # transcription's QPs the plain float32 loop itself converges past it
    # (5.22e-3 on the same problem, well inside the primal tolerance that
    # convergence implies): where it does, the kernel is held to the plain
    # loop's figure within 1%. Where iteration_agreement held the kernel's
    # counts to the float64 solve's (the plain float32 loop stopping a check
    # window away from float64 on these problems, so that its figure is
    # another iterate's), the kernel is held to the float64 solve's figure
    # within 1% instead (16 joints: the kernel and float64 stop at 375
    # iterations, 7.18e-3 and 7.17e-3, the plain float32 loop at 400, 6.94e-3)
    box_64 = None
    if hold_counts and "sol" in solved64:
        sol64 = solved64["sol"]
        x64 = sol64.x.float()
        box_64 = hard_row_ratio(x64, apply_A(ocp, sa4, x64), lc, uc, lx, ux, kw["soft_c"],
                                kw["soft_x"], shipping, sol64.converged)[0]
    box_bar = box_p if box_64 is None else box_64
    check(box_viol < 5e-3 or box_viol <= 1.01 * box_bar,
          f"{tag}: kernel 3 converged problems violate hard box rows by {box_viol}, the "
          f"plain loop by {box_p}" + ("" if box_64 is None else f", the float64 solve by "
                                      f"{box_64}"))
    check(hard_ratio <= 1.01, f"{tag}: kernel 3 converged problems violate hard rows by "
          f"{hard_ratio:.3f}x the tolerance")
    summary = (
        f"{factor_summary}; kernel 3 B={B4}: after {s_win.max_iter} iterations max |x - "
        f"x_float64| kernel {e_k:.3e}, plain {e_p:.3e} (bar: kernel <= 2x plain), max "
        f"|x_kernel - x_plain| {max_abs(x_k, x_p):.3e}; sweeps' order {e_order:.2e} "
        f"relative (tol 1e-4); full solve: {agreement}, hard box-row violation "
        f"{box_viol:.2e} (tol 5e-3, or the plain loop's within 1% where it misses 5e-3, "
        f"float64's where the counts are held to float64; plain {box_p:.2e}"
        + ("" if box_64 is None else f", float64 {box_64:.2e}") + f"), hard-row violation "
        f"{hard_ratio:.3f}x the primal tolerance (bar 1.01; plain {hard_p:.3f}x)")
    return summary, max_abs(x_k, x_p)


def plain_float64(pl, sa, qp, fac, settings):
    """The plain ADMM loop at float64 on the scaled QPs ``qp`` of ``pl``'s
    transcription and their float32 factors ``fac``, unscaled, its check
    windows replayed from a CUDA graph (:class:`PlainWindows`)."""
    from mpc_motion_planner_tpu_torch.ocp import make_ocp
    from mpc_motion_planner_tpu_torch.ops import qp_structured

    coll = pl.ocp.coll
    ocp64 = make_ocp(pl.model.to(dtype=torch.float64), pl.tool_frame, order=coll.order,
                     num_segments=coll.num_segments)
    qp64 = qp_structured.ScaledQP(*(getattr(qp, f.name).double() for f in dataclasses.fields(qp)))
    fac64 = {k: v.double() for k, v in fac.items() if k != "ok"}
    return qp_structured.unscale_solution(
        qp64, *PlainWindows(ocp64, sa.to(dtype=torch.float64), qp64, fac64, settings)())


class PlainWindows:
    """Kernel 3's plain version, one dispatch of ``qp_structured.admm_plain``
    (``chunk_iters`` iterations from ``state``, default the full budget from
    the initial state) on the scaled QPs ``qp`` and their factors ``fac``,
    with each check window (``qp_structured.admm_window``) replayed from one
    CUDA graph, captured here after one warm-up window: the eager loop's
    operations on the card without the host's launches, which are the eager
    loop's time (PERF.md §5), and the host's exit test between windows, as
    the eager loop has it. A window shorter than ``check_every`` (a dispatch
    that is no multiple of it) runs eagerly. Calling it returns the scaled
    (x, zc, zx, yc, yx, done, iters, rp, rd) as ``admm_plain`` does; phase
    10 holds that bitwise against the eager loop."""

    def __init__(self, ocp, sa, qp, fac, settings, state=None, chunk_iters=None):
        from mpc_motion_planner_tpu_torch.ops import qp_structured

        cap = settings.max_iter + settings.rescue_iters if chunk_iters is None else chunk_iters
        self.windows = qp_structured.check_windows(settings, cap)
        self.width = settings.check_every
        self.run = lambda state, first, last: qp_structured.admm_window(
            ocp, sa, qp, fac, settings, state, first, last, cap)
        self.initial = qp_structured.initial_state(qp) if state is None else state
        self.state = [t.clone() for t in self.initial]
        self.graph, t0 = None, time.perf_counter()
        first, last = self.windows[0]
        if last - first + 1 == self.width:
            self.run(self.state, first, last)  # the warm-up, whose outputs are dropped
            torch.cuda.synchronize()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                for t, new in zip(self.state, self.run(self.state, first, last)):
                    t.copy_(new)
            torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0

    def __call__(self):
        for t, t0 in zip(self.state, self.initial):
            t.copy_(t0)
        for first, last in self.windows:
            if bool((self.state[5] != 0).all()):
                break
            if self.graph is not None and last - first + 1 == self.width:
                self.graph.replay()
            else:
                for t, new in zip(self.state, self.run(self.state, first, last)):
                    t.copy_(new)
        return tuple(t.clone() for t in self.state)


def plain_structured_solve(ocp, sa, args, settings, soft_c, soft_x):
    """``qp_structured.solve_box_qp_structured`` of the QPs ``args`` (P, q,
    lc, uc, lx, ux) in their dtype, each ADMM dispatch run by
    :class:`PlainWindows`: the same operations, bitwise, in a fraction of the
    eager loop's time."""
    from mpc_motion_planner_tpu_torch.ops import qp_structured

    settings.check_structured()
    qp = qp_structured.scale_qp(ocp, sa, *args, settings, soft_c=soft_c, soft_x=soft_x)
    state, qp, _ = qp_structured.admm_chunked(
        ocp, sa, qp, settings, qp_structured.factor_banded,
        lambda *dispatch: PlainWindows(*dispatch)())
    return qp_structured.unscale_solution(qp, *state)


def time_factor(qp, g, e2, tag, phase, library_batch=None) -> None:
    """Kernel 2 built for ``g`` on the bands of the scaled QPs ``qp`` against
    its plain version, timed in turns with phase 3's bars, its bound, then
    its library call (``library_factor``, on the first ``library_batch``
    problems where given); into the entry ``e2``."""
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.ops import qp_structured

    B = qp.Mband.shape[0]
    out = {}

    def keep(key, fn):
        def call():
            out[key] = fn()
        return call

    p_ms, k_ms, raw = time_pair(
        keep("plain", lambda: qp_structured.factor_banded(qp.Mband, qp.p_col, qp.m_pp, g.order)),
        keep("kernel", lambda: k2.factor_banded_kernel(qp.Mband, qp.p_col, qp.m_pp)),
    )
    fk, fp = out.pop("kernel"), out.pop("plain")
    check(torch.equal(fk["ok"], fp["ok"]), f"{tag}: kernel 2 ok flags differ at B={B}")
    errs = {k: rel_err(fk[k], fp[k]) for k in ("Ldi", "Lsub", "u", "s")}
    check(max(errs.values()) <= 1e-3, f"{tag}: kernel 2 differs at B={B}: {errs}")
    e2.update(ms=k_ms, plain_ms=p_ms, max_abs_err=max(max_abs(fk[k], fp[k]) for k in errs))
    text = report_bound(
        e2, B * banded_factor_flops(nodes=g.nodes, bw=g.order, blk=g.blk),
        tensor_bytes(qp.Mband, qp.p_col, qp.m_pp, *fk.values()), "band in, factors out",
        library="torch.linalg.cholesky_ex of the dense M, below")
    log(f"{phase} kernel 2 B={B}, {tag}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
        f"(runs {raw}); {text}; ok flags identical ({int(fk['ok'].sum())}/{B} ok), max-norm "
        f"relative error " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()) + " (tol 1e-3)")
    del fk, fp
    library_factor(qp, e2, f"{phase} at {tag}:", library_batch)


def kernel3_timing(pl, first_qp, states, tag, phase, batch=B_MAIN, plain=True,
                   entry=None, budget=True) -> None:
    """Kernel 3 built for ``pl``'s geometry on the step-0 QPs of the first
    ``batch`` of ``states`` (default the headline's): one launch at the full
    budget against its bound (``k3_iter_flops`` of the problem-iterations it
    ran, and the bytes of its inputs and outputs) and, with ``plain``, its
    plain loop's time (check windows replayed from a CUDA graph,
    :class:`PlainWindows`; ``kernel_checks`` holds the kernel to that loop);
    then three launches of exactly one check window, µs per iteration per
    block, or per cluster, over the waves the card runs. ``entry``: a
    ``results`` entry that takes the times and the bound. ``budget`` False:
    one check window alone, the kernel's against its plain loop's, where a
    launch at the full budget takes seconds."""
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry
    from mpc_motion_planner_tpu_torch.ops import qp_structured

    ocp, shipping = pl.ocp, pl.qp_settings
    g = Geometry.of_ocp(ocp)
    _, sa, args, sc, sx = first_qp(batch, pl=pl, states=states)
    qp = qp_structured.scale_qp(ocp, sa, *args, shipping, soft_c=sc, soft_x=sx)
    fac = k2.factor(qp.Mband, qp.p_col, qp.m_pp, g.order)
    s_win = dataclasses.replace(shipping, max_iter=shipping.check_every, rescue_iters=0)
    run = shipping if budget else s_win
    out = {}
    k_ms = time_kernel(lambda: out.__setitem__(
        "k", k3.admm_kernel(ocp, sa, qp, fac, run)), reps=1, warm=False)
    iters = int(out["k"][6].sum())
    flops = k3_iter_flops(g.segments, g.nq, g.order, shipping.kkt_refine)
    nbytes = tensor_bytes(
        fac["Ldi"], fac["Lsub"], fac["u"], fac["s"], sa.J, sa.f_rows, sa.p,
        qp.qs, qp.Ps, qp.rx, qp.lxs, qp.uxs, qp.thx, qp.D, qp.x, qp.zx, qp.yx,
        qp.rc, qp.lcs, qp.ucs, qp.E, qp.thr, qp.zc, qp.yc, *out["k"])
    b_ms, b_by = bound(iters * flops, nbytes)
    del out
    p_text = ""
    if plain:
        p_ms = time_kernel(PlainWindows(ocp, sa, qp, fac, run), reps=1, warm=False)
        p_text = f", plain {p_ms:.3f} ms"
    w_ms = time_kernel(lambda: k3.admm_kernel(ocp, sa, qp, fac, s_win), reps=3)
    if not budget:  # the window's time, warm, three launches
        k_ms = w_ms
    if entry is not None:  # max_abs_err as phase 4's: one check window against the plain loop
        entry.update(ms=k_ms, plain_ms=p_ms if plain else None, batch=batch, max_abs_err=max_abs(
            k3.admm_kernel(ocp, sa, qp, fac, s_win)[0],
            qp_structured.admm_plain(ocp, sa, qp, fac, s_win)[0]))
        report_bound(entry, iters * flops, nbytes, "")
        p_text += f", one window's max |x_kernel - x_plain| {entry['max_abs_err']:.3e}"
    at_once, unit = problems_at_once(g)
    waves = -(-batch // at_once)
    log(f"{phase} kernel 3 B={batch}, {tag}, step-0 QP, "
        + (f"budget {shipping.max_iter} + {shipping.rescue_iters}" if budget else
           f"one check window ({s_win.max_iter} iterations)")
        + f": kernel {k_ms:.3f} ms{p_text}; bound {b_ms:.4f} ms by {b_by} "
        f"({iters} problem-iterations of {flops / 1e3:.1f} kflop, {nbytes / 1e6:.1f} MB), share "
        f"reached {100 * b_ms / k_ms:.1f}%; exactly {s_win.max_iter} iterations {w_ms:.3f} ms = "
        f"{1e3 * w_ms / s_win.max_iter / waves:.2f} us per iteration per {unit} ({waves} waves "
        f"of {at_once} {unit}s)")


def time_structured_kernels(pl, first_qp, results, suffix, phase, window_err, states=None,
                            library_batch=None, batch=B_TIME, hold_counts=True, factor=True):
    """Kernels 2 and 3 built for ``pl``'s geometry, timed at B=``batch``
    (B_TIME but where a phase names another) on its step-0 QPs (of ``states``,
    default the headline's) against their plain versions (kernel 2 in turns
    with phase 3's bars, then its library call; kernel 3's plain loop, its
    check windows replayed from a CUDA graph (:class:`PlainWindows`), runs
    once after the kernel's run, held by
    ``iteration_agreement`` and the hard-row bar; ``hold_counts`` False:
    converged flags held, iteration counts read against the plain float32
    loop, as ``kernel_checks`` reads them), with their bounds, and kernel 3
    at exactly one check window; into the ``results`` entries
    ``banded_factor_<suffix>`` and ``structured_admm_<suffix>``
    (``window_err``: kernel 3's ``max_abs_err`` from ``kernel_checks``;
    ``library_batch``: the batch of kernel 2's library call where B=2048 does
    not fit; ``factor`` False: kernel 2 is not timed here, its entry is
    another call's)."""
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry
    from mpc_motion_planner_tpu_torch.ops import qp_structured
    from mpc_motion_planner_tpu_torch.ops.structure import apply_A

    ocp, shipping = pl.ocp, pl.qp_settings
    g = Geometry.of_ocp(ocp)
    tag = suffix.replace("_", " ")
    for name in ("banded_factor", "structured_admm")[not factor:]:
        k = kernels.KERNELS[name]
        results[f"{name}_{suffix}"] = {
            "name": f"{name}_{suffix}", "route": "cuda",
            "source": f"mpc_motion_planner_tpu_torch/csrc/{k.source}", "replaces": REPLACES[name]}
    out = {}

    def keep(key, fn):
        def call():
            out[key] = fn()
        return call

    _, sa, args, sc, sx = first_qp(batch, pl=pl, states=states)
    qp = qp_structured.scale_qp(ocp, sa, *args, shipping, soft_c=sc, soft_x=sx)
    if factor:
        time_factor(qp, g, results[f"banded_factor_{suffix}"], tag, phase, library_batch)
    fac = k2.factor(qp.Mband, qp.p_col, qp.m_pp, g.order)
    # the plain loop takes seconds, so it runs once: the kernel and the plain
    # loop, timed, and the outputs of those calls held
    plain = PlainWindows(ocp, sa, qp, fac, shipping)
    raw = {"kernel": [], "plain": []}
    for name in ("kernel", "plain"):
        fn = keep(name, (lambda: k3.admm_kernel(ocp, sa, qp, fac, shipping)) if name == "kernel"
                  else plain)
        raw[name].append(time_kernel(fn, reps=1, warm=False))
    capture_s = plain.capture_s
    del plain
    k_ms, p_ms = float(np.mean(raw["kernel"])), float(np.mean(raw["plain"]))
    got, ref = (qp_structured.unscale_solution(qp, *out[k]) for k in ("kernel", "plain"))
    k3_bytes = tensor_bytes(
        fac["Ldi"], fac["Lsub"], fac["u"], fac["s"], sa.J, sa.f_rows, sa.p,
        qp.qs, qp.Ps, qp.rx, qp.lxs, qp.uxs, qp.thx, qp.D, qp.x, qp.zx, qp.yx,
        qp.rc, qp.lcs, qp.ucs, qp.E, qp.thr, qp.zc, qp.yc, *out["kernel"])
    k3_iters = int(out["kernel"][6].sum())
    out.clear()

    if hold_counts:
        agreement = iteration_agreement(got, ref, batch, f"{tag}: kernel 3 B={batch}",
                                        lambda: plain_float64(pl, sa, qp, fac, shipping))
    else:
        agree = int((got.converged == ref.converged).sum())
        check(agree >= batch - max(2, batch // 32),
              f"{tag}: kernel 3 B={batch}: convergence agrees on only {agree}/{batch}")
        w, n, m, x = iteration_gaps(got, ref)
        agreement = (f"converged agree {agree}/{batch} (kernel {int(got.converged.sum())}, plain "
                     f"{int(ref.converged.sum())}); iteration counts read, not held: within 25 "
                     f"of the plain float32 loop's on {w}/{n}, median gap {m}, max {x}")
    _, lc, uc, lx, ux = args[1:]
    ratios = [hard_row_ratio(s_.x, apply_A(ocp, sa, s_.x), lc, uc, lx, ux, sc, sx, shipping,
                             s_.converged) for s_ in (got, ref)]
    check(ratios[0][1] <= 1.01, f"{tag}: kernel 3 B={batch}: hard rows at "
          f"{ratios[0][1]:.3f}x the tolerance")
    e3 = results[f"structured_admm_{suffix}"]
    e3.update(ms=k_ms, plain_ms=p_ms, max_abs_err=window_err)
    flops = k3_iter_flops(g.segments, g.nq, g.order, shipping.kkt_refine)
    text = report_bound(e3, k3_iters * flops, k3_bytes,
                        f"{k3_iters} problem-iterations of {flops / 1e3:.1f} kflop as the kernel "
                        f"counted them")
    log(f"{phase} kernel 3 B={batch}, {tag}, step-0 QP, budget {shipping.max_iter}: kernel "
        f"{k_ms:.3f} ms, plain {p_ms:.3f} ms (check windows replayed from a CUDA graph, "
        f"captured in {capture_s:.2f} s; runs {raw}); {text}; {agreement}; hard-row "
        f"violation {ratios[0][1]:.3f}x the primal tolerance (bar 1.01; plain "
        f"{ratios[1][1]:.3f}x)")
    del got, ref
    s_win = dataclasses.replace(shipping, max_iter=shipping.check_every, rescue_iters=0)
    w_ms = time_kernel(lambda: k3.admm_kernel(ocp, sa, qp, fac, s_win), reps=3)
    at_once, unit = problems_at_once(g)
    waves = -(-batch // at_once)
    b_ms, b_by = bound(batch * s_win.max_iter * flops, k3_bytes)
    log(f"{phase} kernel 3 B={batch}, {tag}, exactly {s_win.max_iter} iterations: kernel "
        f"{w_ms:.3f} ms = {1e3 * w_ms / s_win.max_iter / waves:.2f} us per iteration per {unit} "
        f"({waves} waves of {at_once} {unit}s); bound {b_ms:.4f} ms by {b_by}, share "
        f"reached {100 * b_ms / w_ms:.1f}%")


def problems_at_once(g):
    """How many problems kernel 3 built for ``g`` runs at a time on this card
    and what runs one: the SMs times its blocks per SM, a block each, or (the
    pair layout) the clusters the card places at a time."""
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    paired = k3.KERNEL.geometry(g).layout in k3.PAIRED
    return k3.problems_at_once(g, sms), "cluster" if paired else "block"


SHIPPING_LAUNCHES = (5, 2, 2, 0)  # kernels 1-4 per shipping solve
UNFUSED_LAUNCHES = (0, 2, 2, 0)  # the same under fused_constraints="off"


def launches_of(counts) -> dict:
    """Launches per solve of kernels 1-4, by name."""
    return dict(zip(("constraints", "banded_factor", "structured_admm", "admm_dense"), counts))


def captured_shipping(pl, cur, tgt, tag, suffix, phase, note, results, names, smi,
                      launches=SHIPPING_LAUNCHES, hold_quality=True, turns=3) -> None:
    """A phase's main path: ``pl``'s shipping solve of (cur, tgt) captured
    at their batch (2048 but in phase 31), with the launches of one replay
    (``launches``: 5/2/2/0, or 0/2/2/0 under fused_constraints="off"; set as the
    ``launches`` of the ``results`` entries ``<name>_<suffix>`` of ``names``),
    finite outputs of the OCP's shape, bitwise its eager solve on the seven
    fields, no eager re-solve, the quality bars (``qp_conv_rate`` >= 0.98,
    ``tol_hit_rate`` >= 0.99, terminal error <= 0.011; read and reported,
    not held, where ``hold_quality`` is False: the seeded chains' QPs do not
    converge within the budgets, at float64 either), and replay and eager
    times, median of ``turns`` in turns (0: the times of the checked replay
    and of the first eager solve, where a solve takes tens of seconds)."""
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.utils.capture import capture_solve

    t0 = time.perf_counter()
    solve = capture_solve(pl, cur, tgt)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    check(solve.captured, f"{tag}: the solve was not captured")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = solve(cur, tgt)
    torch.cuda.synchronize()
    times = {"replay": [1e3 * (time.perf_counter() - t0)], "eager": []}
    counts = kernels.launch_counts()
    repairs = k2.REPAIRS.count
    check(counts == launches_of(launches), f"{tag}: launches per replay {counts}")
    for name in names:
        results[f"{name}_{suffix}"]["launches"] = counts[name]
    finite = all(bool(torch.isfinite(t).all()) for t in (got.z, got.violation, got.lam_c, got.lam_x))
    B = cur.shape[0]
    check(finite and got.z.shape == (B, pl.ocp.num_var),
          f"{tag}: non-finite or misshapen outputs")
    t0 = time.perf_counter()
    ref = pl.solve(cur, tgt)
    torch.cuda.synchronize()
    times["eager"].append(1e3 * (time.perf_counter() - t0))
    held = hold_captured(got, ref, lambda: pl.solve(cur, tgt), tag)
    check(solve.eager_resolves == 0, f"{tag}: {solve.eager_resolves} eager re-solves")
    q = quality(pl, got, tgt)
    check(not hold_quality or (q["qp_conv_rate"] >= 0.98 and q["tol_hit_rate"] >= 0.99
                               and q["terminal_err_inf_max"] <= 0.011), f"{tag}: quality {q}")
    if turns:
        times = {"replay": [], "eager": []}
    for mode in ("replay", "eager", "eager", "replay", "replay", "eager")[:2 * turns]:
        fn = solve if mode == "replay" else pl.solve
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(cur, tgt)
        torch.cuda.synchronize()
        times[mode].append(1e3 * (time.perf_counter() - t0))
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"{phase} captured shipping solve at {tag}, B={B} ({note}): capture "
        f"{t_capture:.2f} s; launches per replay {counts}, kernel-2 flags {repairs}; {held} "
        f"against the eager solve (7 fields); quality {json.dumps(q)}"
        + ("" if hold_quality else " (read, not held)"))
    log(f"{phase} timing at {tag}, median of {max(turns, 1)} in turns: replay "
        f"{med['replay']:.2f} ms = "
        f"{B / med['replay'] * 1e3:.1f} solves/s, eager {med['eager']:.2f} ms = "
        f"{B / med['eager'] * 1e3:.1f} solves/s (replays "
        f"{[round(t, 2) for t in times['replay']]}, eager {[round(t, 2) for t in times['eager']]}) "
        f"on {smi}")
    del solve, got, ref
    torch.cuda.empty_cache()


# the libraries ``prebuild`` started: (kernel name, built geometry) -> the
# Future of the library's path
PREBUILT = {}


def prebuild(jobs, workers=4):
    """Start building each (name, kernel, geometry) of ``jobs``, one nvcc
    each, ``workers`` at a time in the background, in their order, while
    earlier phases run on the card; ``build_libraries`` waits for them."""
    pool = concurrent.futures.ThreadPoolExecutor(workers)
    for _, k, g in jobs:
        key = (k.name, k.geometry(g))
        if key not in PREBUILT:
            PREBUILT[key] = pool.submit(k.build, g)
    pool.shutdown(wait=False)


def build_libraries(jobs, phase):
    """Build each (name, kernel, geometry) of ``jobs``, one nvcc each, all
    started together (or wait for its build where ``prebuild`` started it);
    log each library's registers and spills and the seconds it took."""
    t0 = time.perf_counter()

    def build(job):
        _, k, g = job
        future = PREBUILT.get((k.name, k.geometry(g)))
        return future.result() if future is not None else k.build(g)

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(build, jobs))
    for (name, k, g), path in zip(jobs, paths):
        built = k.geometry(g)
        info = [ln.strip() for ln in k.build_log.get(built, "").splitlines()
                if "registers" in ln or "spill" in ln]
        what = "" if built is None else (
            f" at {built.nodes} nodes, order {built.order}, {built.nq} joints"
            + (f", {built.layout} layout" if built.layout else ""))
        log(f"{phase} build: {name}{what} -> {os.path.relpath(path, ROOT)} | " + " | ".join(info))
    log(f"{phase} build: {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")


def block_summary(g, kernel2=True) -> str:
    """The blocks of kernel 3 (and kernel 2) built for ``g`` against the
    Python reckoning: kernel 3's threads and shared memory in its layout,
    kernel 2's shared memory and problems per SM. Returns a summary."""
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import LAYOUTS

    lay3 = k3.block_layout(g)
    built = k3.KERNEL.geometry(g)
    paired = built.layout in k3.PAIRED
    want3 = {"threads": k3.threads(g), "smem_bytes": k3.smem_bytes(built),
             "rank_bytes": k3.rank_bytes(built) if paired else (0, 0)}
    check({k: lay3[k] for k in want3} == want3 and (lay3["active_clusters"] > 0) == paired,
          f"kernel 3 at {built}: the library's block {lay3}, the reckoning {want3}")
    ranks = lay3["rank_bytes"]
    text = (f"kernel 3 {lay3['threads']} threads ({k3.sweep_warps(g)} sweep warps), "
            f"{lay3['smem_bytes']} B in the {built.layout} layout ("
            + ", ".join(f"{name} {k3.smem_bytes(g, name)}" for name in LAYOUTS)
            + f" B), {lay3['blocks_per_sm']} block per SM"
            + (f"; a cluster of {len(ranks)} blocks a problem, "
               + ", ".join(f"rank {i} {b} B" for i, b in enumerate(ranks))
               + f", {lay3['active_clusters']} clusters at a time "
               f"(cudaOccupancyMaxActiveClusters)" if paired else ""))
    if not kernel2:
        return text + "; the reckoning agrees"
    lay2 = k2.block_layout(g)
    want2 = {"smem_bytes": k2.smem_bytes(g), "per_sm": k2.per_sm(g),
             "staged": k2.staged_nodes(g)}
    check({k: lay2[k] for k in want2} == want2 and lay2["blocks_per_sm"] >= lay2["per_sm"],
          f"kernel 2 at {g}: the library's block {lay2}, the reckoning {want2}")
    return (text + f"; kernel 2 {lay2['smem_bytes']} B with its {k2.choose_ring(g)} ring, "
            f"{lay2['staged']} nodes staged, registers capped for "
            f"{lay2['per_sm']} problems per SM, {lay2['blocks_per_sm']} per SM by the occupancy "
            f"calculator; the reckoning agrees")


def transcription_phases(planner, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phase 19: the Panda at 8 spline segments of order 3 (25 nodes, 526
    variables, 648 rows), set as a user sets it (``planner.ocp =
    make_ocp(planner.model, planner.tool_frame, order=3, num_segments=8)``),
    with kernels 2 and 3 built for it: the libraries' blocks against the
    Python reckoning; kernels 2 and 3 against their plain versions
    (``kernel_checks``) and timed at B_TIME with their bounds and kernel 2's
    library call; the captured shipping solve of the headline states (the
    phase's main path: launches per solve, quality, replay and eager times in
    turns, bitwise the eager solve); the JAX fixture at 8 segments. Then
    kernels 2 and 3 built for 4 segments (13 nodes) against their plain
    versions."""
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.ocp import make_ocp
    from mpc_motion_planner_tpu_torch.planner import MotionPlanner

    dev = cur_all.device

    def with_segments(segments):
        pl = MotionPlanner(margins=planner.margins, dtype=planner.dtype, device=dev,
                           qp_settings=planner.qp_settings, sqp_settings=planner.sqp_settings)
        pl.ocp = make_ocp(pl.model, pl.tool_frame, order=3, num_segments=segments)
        return pl

    # ---- the blocks each library was built with ----
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for g in geometries():
        lay = k3.block_layout(g)
        want = {"threads": k3.threads(g), "smem_bytes": k3.smem_bytes(g)}
        check({k: lay[k] for k in want} == want,
              f"kernel 3 at {g.nodes} nodes: the library's block {lay}, the reckoning {want}")
        per_sm2 = k2.blocks_per_sm(g)
        check(per_sm2 >= 6, f"kernel 2 at {g.nodes} nodes holds {per_sm2} problems per SM")
        log(f"phase 19 libraries at {g.nodes} nodes ({g.num_var} variables, {g.num_rows} rows): "
            f"kernel 3 {lay['threads']} threads, {lay['smem_bytes']} B of shared memory "
            f"({k3.choose_layout(g)} layout; full {k3.smem_bytes(g, 'full')} B, limit 232448 B; "
            f"the reckoning agrees), "
            f"{lay['blocks_per_sm']} block per SM; kernel 2 {k2.smem_bytes(g)} B, {per_sm2} "
            f"problems per SM ({sms} SMs)")

    pl25 = with_segments(8)
    ocp = pl25.ocp
    check((ocp.num_nodes, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (25, 526, 648),
          f"8 segments: {ocp.num_nodes} nodes, {ocp.num_var} variables")
    summary, window_err = kernel_checks(pl25, first_qp, "25 nodes")
    log(f"phase 19 at 25 nodes, {summary}")

    # ---- kernels 2 and 3 at B_TIME, timed, with their bounds ----
    time_structured_kernels(pl25, first_qp, results, "25_nodes", "phase 19", window_err)

    # ---- the main path at 25 nodes: the captured shipping solve ----
    captured_shipping(pl25, cur_all, tgt_all, "25 nodes", "25_nodes", "phase 19",
                      "headline states", results, ("banded_factor", "structured_admm"), smi,
                      turns=0)

    # ---- the JAX fixture at 8 segments, through the kernels ----
    n_good, n_tf, n_fx, summary = fixture_agreement(pl25, SEG8_FIXTURE, dev)
    check(n_good >= n_fx - 4 and n_tf >= n_fx - 1,
          f"25 nodes: {n_good}/{n_fx} fixture problems agree, {n_tf} final times within 1e-3")
    log(f"phase 19 JAX fixture at 8 segments: {summary}; final times within 1e-3 relative "
        f"{n_tf}/{n_fx} (bar {n_fx - 1})")

    # ---- 13 nodes: kernels 2 and 3 against their plain versions ----
    log(f"phase 19 at 13 nodes, {kernel_checks(with_segments(4), first_qp, '13 nodes')[0]}")


def fixture_models():
    """``tests/fixtures/make_panda6_fixture.py``: the URDF writers of the
    robots other than the Panda (numpy only; its JAX part runs in ``main``
    alone)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_panda6_fixture", os.path.join(FIXTURES, "make_panda6_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def limits_of(limits, nq: int, extra=None):
    """``limits`` cut to the first ``nq`` joints, or with ``extra`` (a dict
    of per-joint values by field) appended."""
    from mpc_motion_planner_tpu_torch.models.panda import _LIMIT_TENSORS

    def field(k):
        v = getattr(limits, k)[:nq]
        if extra is not None:
            v = torch.cat([v, torch.as_tensor(extra[k], dtype=v.dtype, device=v.device)])
        return v

    return dataclasses.replace(limits, **{k: field(k) for k in _LIMIT_TENSORS})


def robot_planner(planner, model, limits, tool, qp=None, sqp=None, fused=None):
    """A planner of another robot on ``planner``'s device, margins and
    settings (or ``qp``, ``sqp``), its OCP made with ``fused``
    constraints where given."""
    from mpc_motion_planner_tpu_torch.ocp import make_ocp
    from mpc_motion_planner_tpu_torch.planner import MotionPlanner

    pl = MotionPlanner(model=model, limits=limits, tool_frame=tool, margins=planner.margins,
                       qp_settings=qp or planner.qp_settings,
                       sqp_settings=sqp or planner.sqp_settings, dtype=planner.dtype,
                       device=planner.device)
    if fused is not None:
        pl.ocp = make_ocp(pl.model, tool, fused_constraints=fused)
    return pl


def chain_planner(planner, nq: int, fused=None, segments=None):
    """A serial revolute chain of ``nq`` joints drawn from the seed nq, with
    the Panda's limits and its last joint's repeated past 7, and B_MAIN
    (current, target) states at rest drawn from the seed nq
    (``bench/convergence.py`` ``chain``), on ``planner``'s device, margins
    and settings, no floor for its tool, at ``segments`` spline segments of
    order 3 where given."""
    from mpc_motion_planner_tpu_torch.bench.convergence import chain
    from mpc_motion_planner_tpu_torch.ocp import make_ocp

    model, limits, tool, cur, tgt = chain(nq, B_MAIN, torch.float32, planner.device)
    pl = robot_planner(planner, model, limits, tool, fused=fused)
    if segments is not None:
        pl.ocp = make_ocp(pl.model, tool, num_segments=segments,
                          fused_constraints=pl.ocp.fused_constraints)
    pl.set_min_height(-10.0)  # a random chain: no floor for its tool
    return pl, cur, tgt


def kernel1_check(pl, results, phase, busy, reps=3, key=None, batch=B_MAIN) -> None:
    """Kernel 1 built for ``pl``'s joint count against its plain version on
    seeded iterates of ``batch`` (default B_MAIN) x 19 nodes, timed in turns and on the device's
    clock (queued behind ``busy``), into the ``results`` entry
    ``constraints_<nq>_joints``. The bar is phase 2's tolerances against the
    plain float32 values; where the plain float32 values themselves are not
    within those tolerances of a float64 run (10 joints: torques up to 162
    on these iterates), the kernel is held to float64 instead, no further
    from it than twice the plain float32 values (kernel 3's one-window
    rule). ``reps``: calls of each in a turn of the timing (0: the kernel in
    one turn of three calls, the plain version once, unwarmed). ``key``: the
    entry's name in ``results``, where not ``constraints_<nq>_joints``."""
    from mpc_motion_planner_tpu_torch.kernels import constraints as k1
    from mpc_motion_planner_tpu_torch.ocp import make_ocp

    nq, dev = pl.ocp.nq, pl.device
    gen = torch.Generator().manual_seed(20)
    lo_xu = torch.tensor([-2.5] * nq + [-2.0] * nq + [-10.0] * nq)
    xu = (lo_xu + 2 * (-lo_xu) * torch.rand(batch, 19, 3 * nq, generator=gen)).to(dev)
    X, U = xu[..., :2 * nq].contiguous(), xu[..., 2 * nq:].contiguous()
    out = {}
    plain = lambda: out.__setitem__("plain", k1.node_constraints_plain(pl.ocp, X, U, True))
    kernel = lambda: out.__setitem__("kernel", k1.node_constraints_kernel(pl.ocp, X, U, True))
    if reps:
        p_ms, k_ms, raw = time_pair(plain, kernel, reps)
    else:
        k_ms, p_ms = time_kernel(kernel), time_kernel(plain, reps=1, warm=False)
        raw = {"plain": [p_ms], "kernel": [k_ms]}
    (g_k, J_k), (g_p, J_p) = out["kernel"], out["plain"]
    gv_k = k1.node_constraints_kernel(pl.ocp, X, U, False)
    ocp64 = make_ocp(pl.model.to(dtype=torch.float64), pl.tool_frame)
    g_64, J_64 = k1.node_constraints_plain(ocp64, X.double(), U.double(), True)
    torch.cuda.synchronize()
    tol = {"values": (2e-5, 2e-5), "Jacobian": (2e-4, 5e-5)}  # phase 2's (rtol, atol)
    rules = []
    for what, got_all, plain, ref in (("values", (g_k, gv_k), g_p, g_64),
                                      ("Jacobian", (J_k,), J_p, J_64)):
        rtol, atol = tol[what]
        if torch.allclose(plain.double(), ref, rtol=rtol, atol=atol):
            for got in got_all:
                check(torch.allclose(got, plain, rtol=rtol, atol=atol),
                      f"kernel 1 at {nq} joints: {what} differ by {max_abs(got, plain)}")
            rules.append(f"{what}: phase 2's tolerances against the plain version")
        else:
            e_p = max_abs(plain, ref)
            for got in got_all:
                check(max_abs(got, ref) <= 2 * e_p,
                      f"kernel 1 at {nq} joints: {what} {max_abs(got, ref):.3e} from float64, "
                      f"the plain float32 version {e_p:.3e}")
            rules.append(f"{what}: {max(max_abs(got, ref) for got in got_all):.3e} from float64 "
                         f"(bar 2x the plain float32 version's {e_p:.3e}, which misses phase "
                         f"2's tolerances of float64)")
    d_ms = time_kernel(lambda: k1.node_constraints_kernel(pl.ocp, X, U, True), reps=20,
                       behind=busy)
    key = key or f"constraints_{nq}_joints"
    e = results[key] = {
        "name": key, "route": "cuda",
        "source": "mpc_motion_planner_tpu_torch/csrc/constraints.cu",
        "replaces": REPLACES["constraints"], "ms": d_ms, "plain_ms": p_ms,
        "max_abs_err": max(max_abs(g_k, g_p), max_abs(gv_k, g_p), max_abs(J_k, J_p))}
    F = batch * 19
    text = report_bound(e, F * k1_flops(nq, True), tensor_bytes(X, U, g_k, J_k),
                        f"value pass and {3 * nq} tangents, {k1_flops(nq, False):.0f} flop "
                        f"a value pass")
    log(f"{phase} kernel 1 at {nq} joints, F={F}: kernel {d_ms:.4f} ms on the device's "
        f"clock ({k_ms:.3f} ms per wrapper call on an idle card), plain {p_ms:.3f} ms (runs "
        f"{raw}); {text}; max abs err values {max(max_abs(g_k, g_p), max_abs(gv_k, g_p)):.3e}, "
        f"Jacobian {max_abs(J_k, J_p):.3e}; " + "; ".join(rules))


def eager_shipping(pl, cur, tgt, tag, suffix, phase, results,
                   launches=SHIPPING_LAUNCHES) -> None:
    """A phase's main path run eagerly: ``pl``'s shipping solve of (cur,
    tgt) with the launch counts set to 0 just before it and read just after
    (``launches``: 5/2/2/0, or 0/2/2/0 under fused_constraints="off"; set as
    the ``launches`` of the ``results`` entries ``<kernel>_<suffix>`` that
    exist), finite outputs of the OCP's shape."""
    from mpc_motion_planner_tpu_torch import kernels

    kernels.reset_launch_counts()
    sol = pl.solve(cur, tgt)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(counts == launches_of(launches), f"{tag}: launches per solve {counts}")
    for name, n in counts.items():
        if f"{name}_{suffix}" in results:
            results[f"{name}_{suffix}"]["launches"] = n
    finite = all(bool(torch.isfinite(t).all()) for t in (sol.z, sol.violation, sol.lam_c))
    check(finite and sol.z.shape == (cur.shape[0], pl.ocp.num_var),
          f"{tag}: non-finite or misshapen outputs")
    log(f"{phase} eager shipping solve at {tag}, B={cur.shape[0]}: launches {counts}, "
        f"qp_conv_rate {float(sol.qp_converged.double().mean()):.4f}, median violation "
        f"{float(sol.violation.median()):.4f}")


def refusal(pl, cur, tgt, tag, phase, module=None) -> None:
    """``pl``'s geometry is past the limits of kernel 3 (a block that fits
    no layout, at the elements a thread it takes), or of ``module``'s kernel
    where given (``kernels.banded_factor``: a block too large with either
    ring): its fit check and the planner's solve on the card raise a
    ValueError naming the bytes, and neither kernel 2's nor kernel 3's
    library is built for it."""
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    module = module or k3
    g = Geometry.of_ocp(pl.ocp)
    names = f"{module.smem_bytes(g)} B"
    which = "kernel 2" if module is k2 else "kernel 3"
    try:
        module.check_fits(g)
        refused = None
    except ValueError as err:
        refused = str(err)
    check(refused is not None and names in refused,
          f"{tag}: {which}'s fit check says {refused}")
    try:
        pl.solve(cur, tgt)
        solved = "solved"
    except ValueError as err:
        solved = str(err)
    check(names in solved, f"{tag} on the card: {solved}")
    check(not k3.KERNEL.library_path(g).exists(), f"{tag}: a kernel-3 library was built")
    check(module is k3 or not k2.KERNEL.library_path(g).exists(),
          f"{tag}: a kernel-2 library was built")
    log(f"{phase} refusal at {tag}: {refused}; the planner's solve on the card raises the "
        f"same, and no {which} library was built for it")


def robot_builds():
    """Phase 20's libraries: kernels 1-3 at 6, 8, 9 and 10 joints, and
    kernels 2 and 3 at 9 and 10 joints at 25 nodes."""
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    return ([(name, kernels.KERNELS[name], Geometry(nq=nq)) for nq in (6, 8, 9, 10)
             for name in ("constraints", "banded_factor", "structured_admm")]
            + [(name, kernels.KERNELS[name], Geometry(segments=8, nq=nq)) for nq in (9, 10)
               for name in ("banded_factor", "structured_admm")])


def robot_phases(planner, dense_cfg, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phase 20: robots other than the 7-joint Panda, with kernels 1-3 built
    for their joint count. (a) Kernels 1-3 at 6 joints (the Panda with
    ``panda_joint7`` fixed, ``tests/fixtures/panda_joint7_fixed.urdf``) and at
    8 (a serial revolute chain drawn from a seed) against their plain
    versions, with phase 2's, 3's and 4's bars, timed at B_TIME with their
    bounds. (b) The 6-joint planner's captured shipping solve of the headline
    states with joint 7's entries dropped (the phase's main path: launches,
    bitwise its eager solve, quality, replay and eager times in turns), and
    the 8-joint chain's eager solve. (c) The JAX fixture of the 6-joint
    model. (d) The dense ``pallas`` path at 6 joints (kernels 1 and 4). (e)
    Plans and ``fused_constraints``: the 9-joint chain (kernel 3's split
    layout) and the 10-joint chain at 25 nodes (its stream layout) plan
    under "off"; a branched model with prismatic fingers raises under
    "auto" and plans under "off"; the 6-joint planner under "off" launches
    no kernel 1. The libraries of 9 and 10 joints are built here with the
    others, for phase 22; 10 joints at 28 nodes, which fit no layout, are
    refused in phase 24."""
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.kernels import constraints as k1
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry
    from mpc_motion_planner_tpu_torch.models.urdf import parse_urdf
    from mpc_motion_planner_tpu_torch.ops.sqp import SQPSettings

    dev, f32 = cur_all.device, torch.float32
    fx = fixture_models()
    g6, g8 = Geometry(nq=6), Geometry(nq=8)

    build_libraries(robot_builds(), "phase 20")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for g in (g6, g8):
        log(f"phase 20 libraries at {g.nq} joints, 19 nodes ({g.num_var} variables, "
            f"{g.num_rows} rows): {block_summary(g)} ({sms} SMs); kernel 1 "
            f"{k1.smem_bytes(g.nq)} B of shared memory for its Jacobian tiles")

    # ---- the robots ----
    model6 = parse_urdf(os.path.join(FIXTURES, "panda_joint7_fixed.urdf"), dtype=f32, device=dev)
    limits6 = limits_of(planner.limits, 6)
    pl6 = robot_planner(planner, model6, limits6, "panda_tool")
    keep6 = list(fx.KEEP6)
    cur6, tgt6 = cur_all[:, keep6].contiguous(), tgt_all[:, keep6].contiguous()
    check(pl6.ocp.nq == 6 and pl6.ocp.num_var == 343 and pl6.ocp.num_eq + pl6.ocp.num_ineq == 421,
          f"6-joint OCP: {pl6.ocp.num_var} variables")
    pl8, cur8, tgt8 = chain_planner(planner, 8)

    # ---- (a) kernel 1 against its plain version, timed ----
    big = torch.ones(8192, 8192, device=dev)
    for pl in (pl6, pl8):
        kernel1_check(pl, results, "phase 20", lambda: big @ big)
    del big

    # ---- (a) kernels 2 and 3 against their plain versions, timed ----
    for nq, pl, states in ((6, pl6, (cur6, tgt6)), (8, pl8, (cur8, tgt8))):
        summary, window_err = kernel_checks(pl, first_qp, f"{nq} joints", states)
        log(f"phase 20 at {nq} joints, {summary}")
        time_structured_kernels(pl, first_qp, results, f"{nq}_joints", "phase 20", window_err,
                                states)

    # ---- (b) the 6-joint planner: the captured shipping solve ----
    captured_shipping(pl6, cur6, tgt6, "6 joints", "6_joints", "phase 20",
                      "headline states, joint 7 dropped", results,
                      ("constraints", "banded_factor", "structured_admm"), smi, turns=0)
    eager_shipping(pl8, cur8, tgt8, "the 8-joint chain (seeded states)", "8_joints", "phase 20",
                   results)

    # ---- (c) the JAX fixture of the 6-joint model ----
    n_good, n_tf, n_fx, summary = fixture_agreement(
        pl6, os.path.join(FIXTURES, "torch_port_panda6_b64.npz"), dev)
    check(n_good == n_fx, f"6 joints: {n_good}/{n_fx} fixture problems agree")
    log(f"phase 20 JAX fixture at 6 joints: {summary}")

    # ---- (d) the dense pallas path at 6 joints (kernel 4 at n=343, m=421) ----
    dense6 = robot_planner(planner, model6, limits6, "panda_tool", qp=dense_cfg,
                           sqp=SQPSettings())
    kernels.reset_launch_counts()
    wall = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = dense6.solve(cur6, tgt6)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        if not wall[1:]:
            counts = kernels.launch_counts()
    check(counts == {"constraints": 5, "banded_factor": 0, "structured_admm": 0, "admm_dense": 2},
          f"6 joints, dense path: launches {counts}")
    finite = all(bool(torch.isfinite(t).all()) for t in (sol.z, sol.violation, sol.lam_c, sol.lam_x))
    qd = quality(dense6, sol, tgt6)
    check(finite and qd["tol_hit_rate"] >= 0.99, f"6 joints, dense path: quality {qd}")
    log(f"phase 20 dense path at 6 joints, B={B_MAIN} (backend pallas, kkt_refine 1, n=343, "
        f"m=421): launches {counts}, cold solve {wall[0]:.1f} ms, warm solve {wall[1]:.1f} ms = "
        f"{B_MAIN / wall[1] * 1e3:.1f} solves/s; quality {json.dumps(qd)}")
    del sol, dense6

    # ---- (e) plans, refusals and fused_constraints ----
    pl9, cur9, tgt9 = chain_planner(planner, 9, fused="off")
    kernels.reset_launch_counts()
    sol9 = pl9.solve(cur9[:4], tgt9[:4])
    torch.cuda.synchronize()
    counts9 = kernels.launch_counts()
    check(counts9 == {"constraints": 0, "banded_factor": 2, "structured_admm": 2,
                      "admm_dense": 0} and bool(torch.isfinite(sol9.z).all())
          and sol9.z.shape == (4, 514), f"9 joints under 'off': launches {counts9}")
    log(f"phase 20 the 9-joint chain under 'off' (kernel 3 in its split layout) plans B=4: "
        f"launches {counts9}, qp_conv_rate {float(sol9.qp_converged.double().mean()):.4f}")
    pl10, cur10, tgt10 = chain_planner(planner, 10, fused="off", segments=8)
    kernels.reset_launch_counts()
    sol10 = pl10.solve(cur10[:4], tgt10[:4])
    torch.cuda.synchronize()
    counts10 = kernels.launch_counts()
    check(counts10 == {"constraints": 0, "banded_factor": 2, "structured_admm": 2,
                       "admm_dense": 0} and bool(torch.isfinite(sol10.z).all())
          and sol10.z.shape == (4, 751), f"10 joints at 25 nodes under 'off': launches {counts10}")
    log(f"phase 20 the 10-joint chain at 25 nodes under 'off' (kernel 3 in its "
        f"{k3.choose_layout(Geometry.of_ocp(pl10.ocp))} layout) plans B=4: launches {counts10}, "
        f"qp_conv_rate {float(sol10.qp_converged.double().mean()):.4f}")
    del pl10, sol10
    n_h = B_ADMM
    hand = parse_urdf(fx.panda_urdf(True, hand=True), dtype=f32, device=dev)
    fingers = {"min_position": [0.0, 0.0], "max_position": [0.04, 0.04],
               "max_velocity": [0.2, 0.2], "max_acceleration": [1.0, 1.0],
               "max_jerk": [50.0, 50.0], "max_torque": [20.0, 20.0]}
    limits_h = limits_of(planner.limits, 6, fingers)

    def hand_states(base, width):
        q, v = base[:n_h, :6], base[:n_h, 6:]
        w = torch.full((n_h, 2), width, dtype=f32, device=dev)
        return torch.cat([q, w, v, torch.zeros_like(w)], 1)

    cur_h, tgt_h = hand_states(cur6, 0.01), hand_states(tgt6, 0.03)
    try:
        robot_planner(planner, hand, limits_h, "panda_tool").solve(cur_h, tgt_h)
        auto = "planned"
    except NotImplementedError as err:
        auto = str(err)
    check(auto != "planned", "the branched model planned under fused_constraints='auto'")
    pl_h = robot_planner(planner, hand, limits_h, "panda_tool", fused="off")
    kernels.reset_launch_counts()
    sol_h = pl_h.solve(cur_h, tgt_h)
    torch.cuda.synchronize()
    counts_h = kernels.launch_counts()
    check(counts_h["constraints"] == 0 and counts_h["structured_admm"] == 2
          and bool(torch.isfinite(sol_h.z).all()) and sol_h.z.shape == (n_h, 457),
          f"the branched model under 'off': launches {counts_h}")
    pl6_off = robot_planner(planner, model6, limits6, "panda_tool", fused="off")
    kernels.reset_launch_counts()
    sol_off = pl6_off.solve(cur6, tgt6)
    torch.cuda.synchronize()
    counts_off = kernels.launch_counts()
    q_off = quality(pl6_off, sol_off, tgt6)
    check(counts_off == {"constraints": 0, "banded_factor": 2, "structured_admm": 2,
                         "admm_dense": 0} and q_off["tol_hit_rate"] >= 0.99,
          f"6 joints under 'off': launches {counts_off}, quality {q_off}")
    log(f"phase 20 fused_constraints: the branched model (the 6-joint Panda with a hand and two "
        f"prismatic fingers, 8 joints) under 'auto' raises ({auto}); under 'off' it plans "
        f"B={n_h} with launches {counts_h}, qp_conv_rate "
        f"{float(sol_h.qp_converged.double().mean()):.4f}; the 6-joint planner under 'off' "
        f"launches {counts_off}, qp_conv_rate {q_off['qp_conv_rate']}, tol_hit_rate "
        f"{q_off['tol_hit_rate']}")


def order_builds():
    """Phase 21's libraries: kernels 2 and 3 at each order of ORDERS and at
    order 4 x 6 and x 9."""
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    return [(name, kernels.KERNELS[name], g)
            for g in [Geometry(segments=segments, order=order) for order, segments in ORDERS]
            + [Geometry(6, 4), Geometry(9, 4)]
            for name in ("banded_factor", "structured_admm")]


def order_phases(planner, dense_cfg, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phase 21: splines of other orders, with kernels 2 and 3 built for
    their band width. (a) The libraries of ORDERS (band widths 2, 4, 5; six
    nvcc at once) against the Python reckoning of their blocks. (b) At each
    order, kernels 2 and 3 against their plain versions on the step-0 QPs
    of the headline states (``kernel_checks``: phase 3's and 4's bars) and
    timed at B_TIME with their bounds and kernel 2's library call; at orders
    2 and 5 an eager shipping solve of the headline states gives their
    launches. (c) The main path: the Panda at 4 segments of order 4 (17
    nodes, 358 variables, 416 rows), set as a user sets it (``planner.ocp =
    make_ocp(planner.model, planner.tool_frame, order=4, num_segments=4)``),
    its captured shipping solve of the headline states. (d) The JAX fixture
    at order 4 (64/64). (e) The dense ``pallas`` path at order 4 (kernels 1
    and 4 at n = 358). (f) Order 4 at 6 segments (25 nodes), which kernel 3
    takes in its split layout, and order 4 at 9 segments (37 nodes), its
    stream layout, plan (eagerly, B=4; their libraries are built here with
    the others, for phases 22 and 23); order 4 at 11 segments, which fits
    no layout, is refused in phase 24."""
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry
    from mpc_motion_planner_tpu_torch.ocp import make_ocp
    from mpc_motion_planner_tpu_torch.ops.sqp import SQPSettings
    from mpc_motion_planner_tpu_torch.planner import MotionPlanner

    dev = cur_all.device

    def with_order(order, segments, qp=None, sqp=None):
        pl = MotionPlanner(margins=planner.margins, dtype=planner.dtype, device=dev,
                           qp_settings=qp or planner.qp_settings,
                           sqp_settings=sqp or planner.sqp_settings)
        pl.ocp = make_ocp(pl.model, pl.tool_frame, order=order, num_segments=segments)
        return pl

    # ---- (a) build ----
    geoms = [Geometry(segments=segments, order=order) for order, segments in ORDERS]
    build_libraries(order_builds(), "phase 21")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for g in geoms:
        log(f"phase 21 libraries at order {g.order} x {g.segments} segments ({g.nodes} nodes, "
            f"{g.num_var} variables, {g.num_rows} rows): {block_summary(g)} ({sms} SMs)")

    # ---- (b) kernels 2 and 3 against their plain versions, timed ----
    for (order, segments), g in zip(ORDERS, geoms):
        pl = with_order(order, segments)
        ocp = pl.ocp
        check((ocp.num_nodes, ocp.num_var, ocp.num_eq + ocp.num_ineq)
              == (g.nodes, g.num_var, g.num_rows), f"order {order}: {ocp.num_var} variables")
        summary, window_err = kernel_checks(pl, first_qp, f"order {order}")
        log(f"phase 21 at order {order} x {segments} segments ({g.nodes} nodes), {summary}")
        time_structured_kernels(pl, first_qp, results, f"order{order}", "phase 21", window_err)
        if order == 4:
            continue  # its launches are those of the main path, (c)
        kernels.reset_launch_counts()
        sol = pl.solve(cur_all, tgt_all)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check(counts == {"constraints": 5, "banded_factor": 2, "structured_admm": 2,
                         "admm_dense": 0}, f"order {order}: launches per solve {counts}")
        for name in ("banded_factor", "structured_admm"):
            results[f"{name}_order{order}"]["launches"] = counts[name]
        finite = all(bool(torch.isfinite(t).all()) for t in (sol.z, sol.violation, sol.lam_c))
        check(finite and sol.z.shape == (B_MAIN, g.num_var),
              f"order {order}: non-finite or misshapen outputs")
        log(f"phase 21 eager shipping solve at order {order} x {segments} segments, B={B_MAIN} "
            f"(headline states): launches {counts}, quality {json.dumps(quality(pl, sol, tgt_all))}")
        del pl, sol

    # ---- (c) the main path: the captured shipping solve at order 4 ----
    pl4 = with_order(4, 4)
    captured_shipping(pl4, cur_all, tgt_all, "order 4", "order4", "phase 21",
                      "headline states, 4 segments of order 4, 17 nodes", results,
                      ("banded_factor", "structured_admm"), smi, turns=0)

    # ---- (d) the JAX fixture at order 4, through the kernels ----
    n_good, n_tf, n_fx, summary = fixture_agreement(pl4, ORDER4_FIXTURE, dev)
    check(n_good == n_fx, f"order 4: {n_good}/{n_fx} fixture problems agree")
    log(f"phase 21 JAX fixture at order 4 x 4: {summary}")

    # ---- (e) the dense pallas path at order 4 (kernel 4 at n=358, m=416) ----
    dense4 = with_order(4, 4, qp=dense_cfg, sqp=SQPSettings())
    kernels.reset_launch_counts()
    wall = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = dense4.solve(cur_all, tgt_all)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        if not wall[1:]:
            counts = kernels.launch_counts()
    check(counts == {"constraints": 5, "banded_factor": 0, "structured_admm": 0, "admm_dense": 2},
          f"order 4, dense path: launches {counts}")
    finite = all(bool(torch.isfinite(t).all()) for t in (sol.z, sol.violation, sol.lam_c, sol.lam_x))
    qd = quality(dense4, sol, tgt_all)
    check(finite and qd["tol_hit_rate"] >= 0.99, f"order 4, dense path: quality {qd}")
    log(f"phase 21 dense path at order 4, B={B_MAIN} (backend pallas, kkt_refine 1, "
        f"n={dense4.ocp.num_var}, m={dense4.ocp.num_eq + dense4.ocp.num_ineq}): launches {counts}, "
        f"cold solve {wall[0]:.1f} ms, warm solve {wall[1]:.1f} ms = "
        f"{B_MAIN / wall[1] * 1e3:.1f} solves/s; quality {json.dumps(qd)}")
    del sol, dense4

    # ---- (f) order 4 at 6 and 9 segments plan ----
    for segments in (6, 9):
        pl = with_order(4, segments)
        kernels.reset_launch_counts()
        sol = pl.solve(cur_all[:4], tgt_all[:4])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check(counts == {"constraints": 5, "banded_factor": 2, "structured_admm": 2,
                         "admm_dense": 0} and bool(torch.isfinite(sol.z).all())
              and sol.z.shape == (4, pl.ocp.num_var), f"order 4 x {segments}: launches {counts}")
        log(f"phase 21 order 4 x {segments} segments ({pl.ocp.num_nodes} nodes, kernel 3 in its "
            f"{k3.choose_layout(Geometry.of_ocp(pl.ocp))} layout) plans B=4: launches {counts}")
        del pl, sol


def transcription_planner(planner, order, segments):
    """A planner of the Panda on the shipping ``planner``'s device, margins
    and budgets, its OCP set to ``segments`` spline segments of ``order`` as
    a user sets it, with the shipping QP settings of its node count
    (``config.shipping_qp_settings``)."""
    from mpc_motion_planner_tpu_torch import config
    from mpc_motion_planner_tpu_torch.ocp import make_ocp
    from mpc_motion_planner_tpu_torch.planner import MotionPlanner

    pl = MotionPlanner(margins=planner.margins, dtype=planner.dtype, device=planner.device,
                       qp_settings=planner.qp_settings, sqp_settings=planner.sqp_settings)
    pl.ocp = make_ocp(pl.model, pl.tool_frame, order=order, num_segments=segments)
    pl.qp_settings = config.shipping_qp_settings(pl.ocp.num_nodes)
    return pl


def hold_layouts(pl, first_qp, base, other, entry, phase, smi, states=None,
                 turns=2, batch=B_MAIN, ranks=None) -> None:
    """Kernel 3 at ``pl``'s geometry built in the layout ``other`` (named in
    the geometry; planners never do) against the build in ``base``, on the
    step-0 QPs of the headline states (``states``: another robot's) at
    B=``batch`` (2048 but where a phase names less), at the full budget and
    at one check window: all nine outputs
    bitwise equal, times in turns (base, other, other, base, or with
    ``turns`` 1 base, other; one call each at the full budget, with no
    warm-up call before it where ``turns`` is 1, three at one window, one
    where ``turns`` is 1), into ``entry`` as
    ``<other>_<label>_ms``, ``<base>_<label>_ms`` and
    ``<other>_<label>_bitwise_<base>``. ``ranks``: ``other`` (the pair
    layout) with its ring spread over that many ranks, named
    ``<other>_<ranks>_ranks``."""
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry
    from mpc_motion_planner_tpu_torch.ops import qp_structured

    shipping, ocp = pl.qp_settings, pl.ocp
    tag = f"{ocp.num_nodes} nodes of order {ocp.coll.order}" + (
        f" and {ocp.nq} joints" if ocp.nq != 7 else "")
    _, sa, args, sc, sx = first_qp(batch, pl=pl, states=states)
    qp = qp_structured.scale_qp(ocp, sa, *args, shipping, soft_c=sc, soft_x=sx)
    fac = k2.factor(qp.Mband, qp.p_col, qp.m_pp, ocp.coll.order)
    s_win = dataclasses.replace(shipping, max_iter=shipping.check_every, rescue_iters=0)
    names = ("x", "zc", "zx", "yc", "yx", "done", "iters", "rp", "rd")
    builds = {base: {"layout": base}}
    if ranks is None:
        builds[other] = {"layout": other}
    else:
        builds[f"{other}_{ranks}_ranks"] = {"layout": other, "ranks": ranks}
        other = f"{other}_{ranks}_ranks"
    for label, settings in (("budget", shipping), ("window", s_win)):
        out, times = {}, {base: [], other: []}
        for lay in (base, other, other, base)[:2 * turns]:
            def call(lay=lay):
                out[lay] = k3.admm_kernel(ocp, sa, qp, fac, settings, **builds[lay])
            times[lay].append(time_kernel(call, reps=1 if label == "budget" or turns == 1 else 3,
                                          warm=label != "budget" or turns > 1))
        differ = [n for n, a, b in zip(names, out[base], out[other]) if not torch.equal(a, b)]
        check(not differ, f"{tag}, {label}: the {other} layout differs from the {base} one "
              f"in {differ}")
        ms = {k: float(np.mean(v)) for k, v in times.items()}
        at_once = {lay: problems_at_once(dataclasses.replace(Geometry.of_ocp(ocp), **builds[lay]))
                   for lay in (base, other)}
        us = {k: 1e3 * v / settings.max_iter / -(-batch // at_once[k][0]) for k, v in ms.items()}
        entry.update({f"{other}_{label}_ms": ms[other], f"{base}_{label}_ms": ms[base],
                      f"{other}_{label}_bitwise_{base}": True})
        log(f"{phase} {other} against {base} at {tag}, B={batch}, {settings.max_iter} "
            f"iterations: all {len(names)} outputs bitwise equal "
            f"({int(out[other][6].sum())} problem-iterations); {base} {ms[base]:.3f} ms, "
            f"{other} {ms[other]:.3f} ms ({100 * (ms[other] / ms[base] - 1):+.2f}%; "
            f"{us[base]:.2f} us per iteration per {at_once[base][1]} against {us[other]:.2f} per "
            f"{at_once[other][1]}; runs {times}) on {smi}")
    del sa, args, sc, sx, qp, fac, out


def split_builds():
    """Phase 22's library: kernel 3 at 8 segments of order 3 in the split
    layout."""
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    return [("structured_admm", k3.KERNEL, Geometry(segments=8, layout="split"))]


def split_phases(planner, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phase 22: kernel 3's split layout, which keeps in shared memory only
    the operands its chain reads and streams the helper warps' blocks from
    device memory. (a) Kernel 3 built in the split layout at 8 segments of
    order 3 (25 nodes), where the compact layout also fits (a layout
    named in the geometry; planners never do), and the blocks of every split
    library against the Python reckoning. (b) At 25 nodes the split layout
    against the compact one on the step-0 QPs of the headline states at
    B=2048, at the full budget and at one check window: every output
    bitwise equal, times in turns. (c) The main path: the Panda at 6
    segments of order 4 (25 nodes, 526 variables, 620 rows), set as a user
    sets it (``planner.ocp = make_ocp(planner.model, planner.tool_frame,
    order=4, num_segments=6)``): kernels 2 and 3 against their plain
    versions (phase 3's and 4's bars), timed at B_TIME with their bounds and
    kernel 2's library call, the captured shipping solve of the headline
    states (5/2/2/0, bitwise its eager solve, quality, times in turns), the
    JAX fixture ``torch_port_order4s6_b64.npz`` (64/64); the dense
    ``pallas`` path has no kernel at n = 526 (kernel 4's fit check refuses
    it, as the JAX kernel pads to 512). (d) Seeded serial chains of 9 and 10
    joints at 19 nodes: kernels 1-3 against their plain versions, timed,
    and an eager shipping solve at B=2048 (5/2/2/0). The geometries beyond
    the split take the stream layout (phase 23)."""
    from mpc_motion_planner_tpu_torch.kernels import admm_dense as k4
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    dev = cur_all.device
    with_transcription = lambda order, segments: transcription_planner(planner, order, segments)

    # ---- (a) the split layout at 25 nodes of order 3, and every split block ----
    g25 = Geometry(segments=8)
    g25s = dataclasses.replace(g25, layout="split")
    build_libraries(split_builds(), "phase 22")
    check(k3.choose_layout(g25) == "compact", "25 nodes of order 3 take the compact layout")
    for g in (g25s, Geometry(segments=6, order=4), Geometry(nq=9), Geometry(nq=10)):
        log(f"phase 22 libraries at {g.nodes} nodes, order {g.order}, {g.nq} joints "
            f"({g.num_var} variables, {g.num_rows} rows): "
            f"{block_summary(g, kernel2=g.layout is None)}")

    # ---- (b) split against compact at 25 nodes of order 3, bitwise ----
    pl25 = with_transcription(3, 8)
    hold_layouts(pl25, first_qp, "compact", "split", results["structured_admm_25_nodes"],
                 "phase 22", smi, turns=1)
    del pl25

    # ---- (c) the main path: order 4 x 6 segments ----
    pl46 = with_transcription(4, 6)
    ocp = pl46.ocp
    g46 = Geometry.of_ocp(ocp)
    check((ocp.num_nodes, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (25, 526, 620)
          and k3.choose_layout(g46) == "split", f"order 4 x 6: {ocp.num_var} variables")
    summary, window_err = kernel_checks(pl46, first_qp, "order 4 x 6")
    log(f"phase 22 at order 4 x 6 segments (25 nodes, split layout), {summary}")
    time_structured_kernels(pl46, first_qp, results, "order4x6", "phase 22", window_err)
    captured_shipping(pl46, cur_all, tgt_all, "order 4 x 6", "order4x6", "phase 22",
                      "headline states, 6 segments of order 4, 25 nodes", results,
                      ("banded_factor", "structured_admm"), smi, turns=0)
    n_good, n_tf, n_fx, summary = fixture_agreement(pl46, ORDER4S6_FIXTURE, dev)
    check(n_good == n_fx, f"order 4 x 6: {n_good}/{n_fx} fixture problems agree")
    log(f"phase 22 JAX fixture at order 4 x 6: {summary}")
    try:
        k4.check_fits(ocp.num_var, ocp.num_eq + ocp.num_ineq)
        dense = "fits"
    except ValueError as err:
        dense = str(err)
    check(dense != "fits", "order 4 x 6: kernel 4 took n = 526")
    log(f"phase 22 dense pallas path at order 4 x 6 (n = {ocp.num_var}): not built; kernel 4's "
        f"fit check refuses it ({dense}), as the JAX kernel pads to n = 512")
    del pl46

    # ---- (d) the 9- and 10-joint chains at 19 nodes ----
    big = torch.ones(8192, 8192, device=dev)
    for nq in (9, 10):
        pl, cur, tgt = chain_planner(planner, nq)
        kernel1_check(pl, results, "phase 22", lambda: big @ big)
        summary, window_err = kernel_checks(pl, first_qp, f"{nq} joints", (cur, tgt))
        log(f"phase 22 at {nq} joints (split layout), {summary}")
        time_structured_kernels(pl, first_qp, results, f"{nq}_joints", "phase 22", window_err,
                                (cur, tgt))
        eager_shipping(pl, cur, tgt, f"the {nq}-joint chain (seeded states)", f"{nq}_joints",
                       "phase 22", results)
        del pl, cur, tgt
    del big
    torch.cuda.empty_cache()


def stream_builds():
    """Phase 23's libraries: kernel 3 in the stream layout where compact (3 x
    8) and split (4 x 6) fit, and kernels 2 and 3 at 12 x 3 and 4 x 9, which
    take it."""
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    k3 = kernels.KERNELS["structured_admm"]
    return ([("structured_admm", k3, g) for g in (Geometry(8, 3, layout="stream"),
                                                  Geometry(6, 4, layout="stream"))]
            + [(name, kernels.KERNELS[name], g) for g in (Geometry(12, 3), Geometry(9, 4))
               for name in ("banded_factor", "structured_admm")])


def stream_phases(planner, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phase 23: kernel 3's stream layout, which keeps no block of Lsub in
    shared memory: the chain's distance-1 blocks go through the copier's
    ring with the helpers' ones, and every geometry up to 1024 threads
    fits (and past them at two elements a thread, phase 24). (a) Built in
    the stream layout at 8 segments of order 3 (where the compact layout
    fits) and at 6 of order 4 (where the split does), it
    gives all nine outputs of those layouts bitwise at B=2048 (times in
    turns). (b) The main path: the Panda at 12 segments of order 3 (37
    nodes, 778 variables, 968 rows, 992 threads), set as a user sets it
    (``planner.ocp = make_ocp(planner.model, planner.tool_frame, order=3,
    num_segments=12)``): kernels 2 and 3 against their plain versions
    (phase 3's and 4's bars), timed at B_TIME with their bounds and kernel
    2's library call, the captured shipping solve of the headline states
    (5/2/2/0, bitwise its eager solve, quality, times in turns), the JAX
    fixture ``torch_port_seg12_b64.npz`` (64/64); the dense ``pallas`` path
    has no kernel at n = 778. (c) The Panda at 9 segments of order 4 and
    seeded serial chains of 9 and 10 joints at 8 segments of order 3 (37,
    25, 25 nodes): kernels 2 and 3 against their plain versions, timed, an
    eager shipping solve each (5/2/2/0). (d) Every stream library's block
    against the Python reckoning (its registers and spills in the build's
    lines)."""
    from mpc_motion_planner_tpu_torch.kernels import admm_dense as k4
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    dev = cur_all.device
    g38s, g46s = Geometry(8, 3, layout="stream"), Geometry(6, 4, layout="stream")
    g12, g49 = Geometry(12, 3), Geometry(9, 4)
    chains = {nq: Geometry(8, 3, nq) for nq in (9, 10)}
    build_libraries(stream_builds(), "phase 23")

    # ---- (a) the stream layout against compact (3 x 8) and split (4 x 6), bitwise ----
    for (order, segments), base, entry in (((3, 8), "compact", "structured_admm_25_nodes"),
                                           ((4, 6), "split", "structured_admm_order4x6")):
        pl = transcription_planner(planner, order, segments)
        check(k3.choose_layout(Geometry.of_ocp(pl.ocp)) == base,
              f"order {order} x {segments} takes the {base} layout")
        hold_layouts(pl, first_qp, base, "stream", results[entry], "phase 23", smi, turns=1)
        del pl

    # ---- (b) the main path: 12 segments of order 3 ----
    pl12 = transcription_planner(planner, 3, 12)
    ocp = pl12.ocp
    check((ocp.num_nodes, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (37, 778, 968)
          and k3.choose_layout(g12) == "stream" and Geometry.of_ocp(ocp) == g12,
          f"12 segments: {ocp.num_nodes} nodes, {ocp.num_var} variables")
    log(f"phase 23 libraries at 12 segments of order 3 (37 nodes, 778 variables, 968 rows): "
        f"{block_summary(g12)}")
    summary, window_err = kernel_checks(pl12, first_qp, "12 segments")
    log(f"phase 23 at 12 segments of order 3 (37 nodes, stream layout), {summary}")
    time_structured_kernels(pl12, first_qp, results, "seg12", "phase 23", window_err)
    captured_shipping(pl12, cur_all, tgt_all, "12 segments", "seg12", "phase 23",
                      "headline states, 12 segments of order 3, 37 nodes", results,
                      ("banded_factor", "structured_admm"), smi, turns=0)
    # every final time within 1e-3; the whole agreement (qp_converged too) by
    # phase 19's bar for float32 against a float64 fixture: at 37 nodes the
    # port's plain float32 path also leaves one QP unconverged that the JAX
    # float64 solve converges (PERF.md §4)
    n_good, n_tf, n_fx, summary = fixture_agreement(pl12, SEG12_FIXTURE, dev)
    check(n_tf == n_fx and n_good >= n_fx - 4,
          f"12 segments: {n_good}/{n_fx} fixture problems agree, {n_tf} final times within 1e-3")
    log(f"phase 23 JAX fixture at 12 segments: {summary}; final times within 1e-3 relative "
        f"{n_tf}/{n_fx} (bar {n_fx}), all three {n_good}/{n_fx} (bar {n_fx - 4})")
    try:
        k4.check_fits(ocp.num_var, ocp.num_eq + ocp.num_ineq)
        dense = "fits"
    except ValueError as err:
        dense = str(err)
    check(dense != "fits", "12 segments: kernel 4 took n = 778")
    log(f"phase 23 dense pallas path at 12 segments (n = {ocp.num_var}): not built; kernel 4's "
        f"fit check refuses it ({dense}), as the JAX kernel pads to n = 512")
    del pl12, ocp

    # ---- (c) order 4 x 9, and the 9- and 10-joint chains at 25 nodes ----
    pl49 = transcription_planner(planner, 4, 9)
    check(Geometry.of_ocp(pl49.ocp) == g49 and k3.choose_layout(g49) == "stream",
          "order 4 x 9 takes the stream layout")
    log(f"phase 23 libraries at order 4 x 9 segments (37 nodes, {g49.num_var} variables, "
        f"{g49.num_rows} rows): {block_summary(g49)}")
    summary, window_err = kernel_checks(pl49, first_qp, "order 4 x 9")
    log(f"phase 23 at order 4 x 9 segments (37 nodes, stream layout), {summary}")
    time_structured_kernels(pl49, first_qp, results, "order4x9", "phase 23", window_err)
    eager_shipping(pl49, cur_all, tgt_all, "order 4 x 9 (headline states)", "order4x9",
                   "phase 23", results)
    del pl49
    for nq, g in chains.items():
        pl, cur, tgt = chain_planner(planner, nq, segments=8)
        check(Geometry.of_ocp(pl.ocp) == g and k3.choose_layout(g) == "stream",
              f"{nq} joints at 25 nodes take the stream layout")
        log(f"phase 23 libraries at {nq} joints, 25 nodes ({g.num_var} variables, "
            f"{g.num_rows} rows): {block_summary(g)}")
        summary, window_err = kernel_checks(pl, first_qp, f"{nq} joints, 25 nodes", (cur, tgt))
        log(f"phase 23 at {nq} joints, 25 nodes (stream layout), {summary}")
        time_structured_kernels(pl, first_qp, results, f"{nq}_joints_25_nodes", "phase 23",
                                window_err, (cur, tgt))
        eager_shipping(pl, cur, tgt, f"the {nq}-joint chain at 25 nodes (seeded states)",
                       f"{nq}_joints_25_nodes", "phase 23", results)
        del pl, cur, tgt

    # ---- (d) the forced stream blocks ----
    for g in (g38s, g46s):
        log(f"phase 23 libraries at {g.nodes} nodes, order {g.order} in the stream layout: "
            f"{block_summary(g, kernel2=False)}")
    torch.cuda.empty_cache()


def ptxas_report(kernel, g) -> str:
    """Registers and spill stores of each function of ``kernel``'s library
    for ``g``, from nvcc's ``-Xptxas -v`` report of its build in this run."""
    import re

    text = kernel.build_log.get(kernel.geometry(g), "")
    regs = re.findall(r"Used (\d+) registers", text)
    spills = re.findall(r"(\d+) bytes spill stores", text)
    return ", ".join(f"{r} registers, {b} B of spill stores" for r, b in zip(regs, spills))


def hold_ept(pl, first_qp, entry, phase, smi) -> None:
    """Kernel 3 at ``pl``'s geometry built at two z elements and rows a
    thread (named in the geometry; planners never do) against its own build
    at one, on the step-0 QPs of the headline states at B=2048: at the full
    budget held by ``iteration_agreement`` (the sum of the p row's defect
    part takes another order, so there is no bitwise parent) and the
    hard-row bar, at exactly one check window by its largest difference;
    times in turns (1, 2, 2, 1), with the registers and spill stores of
    both builds; into ``entry`` as ``ept<n>_<label>_ms``."""
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry
    from mpc_motion_planner_tpu_torch.ops import qp_structured
    from mpc_motion_planner_tpu_torch.ops.structure import apply_A

    shipping, ocp = pl.qp_settings, pl.ocp
    g = Geometry.of_ocp(ocp)
    tag = f"{ocp.num_nodes} nodes of order {ocp.coll.order}"
    _, sa, args, sc, sx = first_qp(B_MAIN, pl=pl)
    qp = qp_structured.scale_qp(ocp, sa, *args, shipping, soft_c=sc, soft_x=sx)
    fac = k2.factor(qp.Mband, qp.p_col, qp.m_pp, ocp.coll.order)
    s_win = dataclasses.replace(shipping, max_iter=shipping.check_every, rescue_iters=0)
    waves = -(-B_MAIN // torch.cuda.get_device_properties(0).multi_processor_count)
    builds = {e: dataclasses.replace(g, ept=e) for e in (1, 2)}
    for e, ge in builds.items():
        log(f"{phase} kernel 3 at {tag}, {e} element(s) a thread: "
            f"{block_summary(ge, kernel2=False)}; {ptxas_report(k3.KERNEL, ge)}")
    for label, settings in (("budget", shipping), ("window", s_win)):
        out, times = {}, {1: [], 2: []}
        for e in (1, 2, 2, 1):
            def call(e=e):
                out[e] = k3.admm_kernel(ocp, sa, qp, fac, settings, ept=e)
            times[e].append(time_kernel(call, reps=3))
        ms = {e: float(np.mean(v)) for e, v in times.items()}
        us = {e: 1e3 * v / settings.max_iter / waves for e, v in ms.items()}
        if label == "budget":
            got, ref = (qp_structured.unscale_solution(qp, *out[e]) for e in (2, 1))
            held = iteration_agreement(
                got, ref, B_MAIN, f"{tag}: two elements a thread against one",
                lambda: plain_float64(pl, sa, qp, fac, shipping))
            _, lc, uc, lx, ux = args[1:]
            ratio = hard_row_ratio(got.x, apply_A(ocp, sa, got.x), lc, uc, lx, ux, sc, sx,
                                   shipping, got.converged)[1]
            check(ratio <= 1.01, f"{tag}, two elements a thread: hard rows at {ratio:.3f}x the "
                  f"tolerance")
            held += f"; hard-row violation {ratio:.3f}x the primal tolerance (bar 1.01)"
        else:
            held = f"max |x_2 - x_1| {max_abs(out[2][0], out[1][0]):.3e}"
        same = [n for n, a, b in zip(("x", "zc", "zx", "yc", "yx", "done", "iters", "rp", "rd"),
                                     out[1], out[2]) if torch.equal(a, b)]
        entry.update({f"ept{e}_{label}_ms": ms[e] for e in ms})
        log(f"{phase} two elements a thread against one at {tag}, B={B_MAIN}, "
            f"{settings.max_iter} iterations ({int(out[2][6].sum())} and {int(out[1][6].sum())} "
            f"problem-iterations): {held}; bitwise equal: {same}; one {ms[1]:.3f} ms, two "
            f"{ms[2]:.3f} ms ({100 * (ms[2] / ms[1] - 1):+.2f}%; {us[1]:.2f} against "
            f"{us[2]:.2f} us per iteration per block; runs {times}) on {smi}")
    del sa, args, sc, sx, qp, fac, out


def ept_builds():
    """Phase 24's libraries: kernel 3 at 12 x 3 at two elements a thread,
    and kernels 2 and 3 at the geometries that take two (15 and 13 x 3,
    order 4 x 10, 9 joints at 10 segments)."""
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    return ([("structured_admm", kernels.KERNELS["structured_admm"], Geometry(12, 3, ept=2))]
            + [(name, kernels.KERNELS[name], g)
               for g in (Geometry(15, 3), Geometry(13, 3), Geometry(10, 4), Geometry(10, 3, 9))
               for name in ("banded_factor", "structured_admm")])


def ept_phases(planner, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phase 24: kernel 3 past 1024 threads, a thread owning two z elements
    and two constraint rows (``kernels/structured_admm.py`` ``ept_of``). (a)
    At 12 segments of order 3, where one element a thread fits, kernel 3
    built at two (512 threads) against its own build (992): held by
    ``iteration_agreement`` and the hard-row bar at B=2048, timed in turns
    at the full budget and at one check window, with ptxas's registers and
    spill stores; the planners keep one. (b) The main path: the Panda at 15
    segments of order 3 (46 nodes, 967 variables, 1208 rows, 608 threads,
    the stream layout), set as a user sets it (``planner.ocp =
    make_ocp(planner.model, planner.tool_frame, order=3,
    num_segments=15)``, its QP settings ``config.shipping_qp_settings(46)``:
    one refinement step on every KKT solve): kernels 2 and 3 against their
    plain versions (phase 3's and 4's bars), timed at B_TIME with their
    bounds and kernel 2's library call, the captured shipping solve of the
    headline states (5/2/2/0, bitwise its eager solve, quality, times in
    turns) and the JAX fixture ``torch_port_seg15_b64.npz`` by phase 23's
    rule. (c) 13
    segments of order 3 (40 nodes), order 4 x 10 (41) and a seeded 9-joint
    chain at 10 segments (31): kernels 2 and 3 held and timed, an eager
    shipping solve each (5/2/2/0). The geometries past the stream layout
    (16 segments of order 3, order 4 x 11, 10 joints at 9 segments) take
    the lean layout (phase 25)."""
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    dev = cur_all.device
    g15, g13, g4a = Geometry(15, 3), Geometry(13, 3), Geometry(10, 4)
    g9 = Geometry(10, 3, 9)
    build_libraries(ept_builds(), "phase 24")

    # ---- (a) two elements a thread against one at 12 x 3 ----
    pl12 = transcription_planner(planner, 3, 12)
    hold_ept(pl12, first_qp, results["structured_admm_seg12"], "phase 24", smi)
    del pl12

    # ---- (b) the main path: 15 segments of order 3 ----
    pl15 = transcription_planner(planner, 3, 15)
    ocp = pl15.ocp
    check((ocp.num_nodes, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (46, 967, 1208)
          and Geometry.of_ocp(ocp) == g15 and k3.KERNEL.geometry(g15).layout == "stream"
          and k3.KERNEL.geometry(g15).ept == 2 and k3.threads(g15) == 608
          and pl15.qp_settings.kkt_refine == 1,
          f"15 segments: {ocp.num_nodes} nodes, {ocp.num_var} variables, "
          f"{k3.KERNEL.geometry(g15)}, kkt_refine {pl15.qp_settings.kkt_refine}")
    log(f"phase 24 libraries at 15 segments of order 3 (46 nodes, 967 variables, 1208 rows, "
        f"two elements a thread, kkt_refine 1): {block_summary(g15)}; "
        f"{ptxas_report(k3.KERNEL, g15)}")
    summary, window_err = kernel_checks(pl15, first_qp, "15 segments")
    log(f"phase 24 at 15 segments of order 3 (46 nodes, stream layout, two elements a thread), "
        f"{summary}")
    time_structured_kernels(pl15, first_qp, results, "seg15", "phase 24", window_err)
    captured_shipping(pl15, cur_all, tgt_all, "15 segments", "seg15", "phase 24",
                      "headline states, 15 segments of order 3, 46 nodes", results,
                      ("banded_factor", "structured_admm"), smi, turns=0)
    # phase 23's rule
    n_good, n_tf, n_fx, summary = fixture_agreement(pl15, SEG15_FIXTURE, dev)
    check(n_good >= n_fx - 4 and n_tf == n_fx,
          f"15 segments: {n_good}/{n_fx} fixture problems agree, {n_tf} final times within 1e-3")
    log(f"phase 24 JAX fixture at 15 segments: {summary}; final times within 1e-3 relative "
        f"{n_tf}/{n_fx} (bar {n_fx}), all three {n_good}/{n_fx} (bar {n_fx - 4})")
    del pl15, ocp

    # ---- (c) 13 x 3, order 4 x 10 and the 9-joint chain at 31 nodes ----
    for (order, segments), g, suffix in (((3, 13), g13, "seg13"), ((4, 10), g4a, "order4x10")):
        pl = transcription_planner(planner, order, segments)
        check(Geometry.of_ocp(pl.ocp) == g and k3.KERNEL.geometry(g).ept == 2,
              f"order {order} x {segments} takes two elements a thread")
        tag = f"order {order} x {segments} segments ({g.nodes} nodes)"
        log(f"phase 24 libraries at {tag}: {block_summary(g)}; {ptxas_report(k3.KERNEL, g)}")
        summary, window_err = kernel_checks(pl, first_qp, tag)
        log(f"phase 24 at {tag}, {summary}")
        time_structured_kernels(pl, first_qp, results, suffix, "phase 24", window_err)
        eager_shipping(pl, cur_all, tgt_all, f"{tag} (headline states)", suffix, "phase 24",
                       results)
        del pl
    pl, cur, tgt = chain_planner(planner, 9, segments=10)
    check(Geometry.of_ocp(pl.ocp) == g9 and k3.KERNEL.geometry(g9).ept == 2,
          "9 joints at 31 nodes take two elements a thread")
    log(f"phase 24 libraries at 9 joints, 31 nodes ({g9.num_var} variables, {g9.num_rows} rows): "
        f"{block_summary(g9)}; {ptxas_report(k3.KERNEL, g9)}")
    summary, window_err = kernel_checks(pl, first_qp, "9 joints, 31 nodes", (cur, tgt))
    log(f"phase 24 at 9 joints, 31 nodes, {summary}")
    time_structured_kernels(pl, first_qp, results, "9_joints_31_nodes", "phase 24", window_err,
                            (cur, tgt))
    eager_shipping(pl, cur, tgt, "the 9-joint chain at 31 nodes (seeded states)",
                   "9_joints_31_nodes", "phase 24", results)
    del pl, cur, tgt
    torch.cuda.empty_cache()


def layout_builds(geometries):
    """A layout phase's libraries from its ``geometries()`` (main path, held,
    others): kernel 3 in the phase's layout where the one before it fits (the
    held builds), and kernels 2 and 3 at the geometries that take it."""
    from mpc_motion_planner_tpu_torch import kernels

    main, held, others = geometries()
    return ([("structured_admm", kernels.KERNELS["structured_admm"], g) for g in held.values()]
            + [(name, kernels.KERNELS[name], g) for g in (main, *others.values())
               for name in ("banded_factor", "structured_admm")])


def lean_geometries():
    """Phase 25's geometries: the main path (20 x 3), the lean builds held
    against the stream ones (15 and 12 x 3), and the others that take it."""
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    held = {"seg15": Geometry(15, 3, layout="lean"), "seg12": Geometry(12, 3, layout="lean")}
    others = {"seg24": Geometry(24, 3), "order4x16": Geometry(16, 4),
              "10_joints_37_nodes": Geometry(12, 3, 10), "9_joints_46_nodes": Geometry(15, 3, 9)}
    return Geometry(20, 3), held, others


def lean_phases(planner, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phase 25: kernel 3's lean layout, the stream layout without the 16
    vectors that only the thread owning an element or row reads (the
    launch's constants read from device memory where they are used, the
    iterates in their owner's registers), taken where the stream block does
    not fit one SM. (a) Built in the lean layout at 15 and 12 segments of
    order 3 (where the stream layout fits), against the stream build at
    B=2048, at two elements a thread and at one: all nine outputs bitwise
    (times in turns, with ptxas's registers and spill stores). (b) The main path: the
    Panda at 20 segments of order 3 (61 nodes, 1282 variables, 1608 rows,
    832 threads at two elements a thread), set as a user sets it
    (``planner.ocp = make_ocp(planner.model, planner.tool_frame, order=3,
    num_segments=20)``, its QP settings ``config.shipping_qp_settings(61)``:
    one refinement step on every KKT solve): kernels 2 and 3 against their
    plain versions (phase 3's and 4's bars), timed at B_TIME with their
    bounds and kernel 2's library call, the captured shipping solve of the
    headline states (5/2/2/0, bitwise its eager solve, quality, times in
    turns) and the JAX fixture ``torch_port_seg20_b64.npz`` by phase 23's
    rule. (c) The other
    geometries the lean layout takes: 24 segments of order 3 (73 nodes, 992
    threads), order 4 x 16 (65 nodes) and seeded chains of 10 joints at 12
    segments (37 nodes) and 9 joints at 15 (46 nodes), with the shipping QP
    settings of their node counts: kernels 2 and 3 against their plain
    versions and an eager shipping solve each (5/2/2/0), with ptxas's
    registers and spill stores. The geometries past the lean layout take
    the far layout (phase 26)."""
    from mpc_motion_planner_tpu_torch import config
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    dev = cur_all.device
    g20, held, others = lean_geometries()
    build_libraries(layout_builds(lean_geometries), "phase 25")

    # ---- (a) the lean layout against the stream one, bitwise ----
    for suffix, g in held.items():
        pl = transcription_planner(planner, 3, g.segments)
        check(k3.KERNEL.geometry(Geometry.of_ocp(pl.ocp)).layout == "stream",
              f"{g.segments} segments take the stream layout")
        log(f"phase 25 libraries at {g.nodes} nodes in the lean layout: "
            f"{block_summary(g, kernel2=False)}; {ptxas_report(k3.KERNEL, g)}")
        hold_layouts(pl, first_qp, "stream", "lean", results[f"structured_admm_{suffix}"],
                     "phase 25", smi, turns=1)
        del pl

    # ---- (b) the main path: 20 segments of order 3 ----
    pl20 = transcription_planner(planner, 3, 20)
    ocp = pl20.ocp
    built = k3.KERNEL.geometry(g20)
    check((ocp.num_nodes, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (61, 1282, 1608)
          and Geometry.of_ocp(ocp) == g20 and (built.layout, built.ept) == ("lean", 2)
          and k3.threads(g20) == 832 and pl20.qp_settings.kkt_refine == 1,
          f"20 segments: {ocp.num_nodes} nodes, {ocp.num_var} variables, {built}, "
          f"kkt_refine {pl20.qp_settings.kkt_refine}")
    log(f"phase 25 libraries at 20 segments of order 3 (61 nodes, 1282 variables, 1608 rows, "
        f"two elements a thread, kkt_refine 1): {block_summary(g20)}; "
        f"{ptxas_report(k3.KERNEL, g20)}")
    summary, window_err = kernel_checks(pl20, first_qp, "20 segments")
    log(f"phase 25 at 20 segments of order 3 (61 nodes, lean layout, two elements a thread), "
        f"{summary}")
    time_structured_kernels(pl20, first_qp, results, "seg20", "phase 25", window_err)
    captured_shipping(pl20, cur_all, tgt_all, "20 segments", "seg20", "phase 25",
                      "headline states, 20 segments of order 3, 61 nodes", results,
                      ("banded_factor", "structured_admm"), smi, turns=0)
    # phase 23's rule
    n_good, n_tf, n_fx, summary = fixture_agreement(pl20, SEG20_FIXTURE, dev)
    check(n_good >= n_fx - 4 and n_tf == n_fx,
          f"20 segments: {n_good}/{n_fx} fixture problems agree, {n_tf} final times within 1e-3")
    log(f"phase 25 JAX fixture at 20 segments: {summary}; final times within 1e-3 relative "
        f"{n_tf}/{n_fx} (bar {n_fx}), all three {n_good}/{n_fx} (bar {n_fx - 4})")
    del pl20, ocp

    # ---- (c) 24 x 3, order 4 x 16, 10 joints at 37 nodes, 9 joints at 46 ----
    for suffix, g in others.items():
        if g.nq == 7:
            pl, cur, tgt, states = transcription_planner(planner, g.order, g.segments), \
                cur_all, tgt_all, None
            tag = f"order {g.order} x {g.segments} segments ({g.nodes} nodes)"
        else:
            pl, cur, tgt = chain_planner(planner, g.nq, segments=g.segments)
            pl.qp_settings = config.shipping_qp_settings(pl.ocp.num_nodes)
            states, tag = (cur, tgt), f"{g.nq} joints, {g.nodes} nodes"
        built = k3.KERNEL.geometry(g)
        check(Geometry.of_ocp(pl.ocp) == g and (built.layout, built.ept) == ("lean", 2),
              f"{tag}: kernel 3 built as {built}")
        log(f"phase 25 libraries at {tag}, kkt_refine {pl.qp_settings.kkt_refine}: "
            f"{block_summary(g)}; {ptxas_report(k3.KERNEL, g)}")
        summary, _ = kernel_checks(pl, first_qp, tag, states)
        log(f"phase 25 at {tag} (lean layout), {summary}")
        eager_shipping(pl, cur, tgt, f"{tag} ({'headline' if states is None else 'seeded'} "
                       f"states)", suffix, "phase 25", results)
        del pl, cur, tgt, states
    torch.cuda.empty_cache()


def far_geometries():
    """Phase 26's geometries: the main path (25 x 3), the far builds held
    against the lean ones (20 and 24 x 3), and the others that take it."""
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    held = {"seg20": Geometry(20, 3, layout="far"), "seg24": Geometry(24, 3, layout="far")}
    others = {"9_joints_49_nodes": Geometry(16, 3, 9), "10_joints_40_nodes": Geometry(13, 3, 10),
              "order4x17": Geometry(17, 4)}
    return Geometry(25, 3), held, others


def far_phases(planner, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phase 26: kernel 3's far layout, the lean layout without the node
    constraint Jacobians J (read from device memory where the products of A
    and A' use them), taken where the lean block does not fit one SM. (a)
    Built in the far layout at 20 and 24 segments of order 3 (where the lean
    layout fits), against the lean build at B=2048: all nine outputs bitwise
    (times in turns, with ptxas's registers and spill stores). (b) The main
    path: the Panda at 25 segments of order 3 (76 nodes, 1597 variables, 2008
    rows, 1024 threads at two elements a thread), set as a user sets it
    (``planner.ocp = make_ocp(planner.model, planner.tool_frame, order=3,
    num_segments=25)``, its QP settings ``config.shipping_qp_settings(76)``:
    one refinement step on every KKT solve): kernels 2 and 3 against their
    plain versions (phase 3's and 4's bars), timed at B_TIME with their
    bounds and kernel 2's library call, the captured shipping solve of the
    headline states (5/2/2/0, bitwise its eager solve, quality, times in
    turns) and the JAX fixture ``torch_port_seg25_b64.npz`` by phase 23's
    rule. (c) The other geometries the far layout takes: seeded chains of 9
    joints at 16 segments (49 nodes) and 10 joints at 13 (40 nodes), and
    order 4 x 17 (69 nodes), with the shipping QP settings of their node
    counts: kernels 2 and 3 against their plain versions and an eager
    shipping solve each (5/2/2/0), with ptxas's registers and spill stores.
    The first geometries past the far layout, 32 segments of order 3 (97
    nodes), order 4 x 22 (89) and 10 joints at 17 segments (52), take the
    deep layout (phase 28)."""
    from mpc_motion_planner_tpu_torch import config
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    dev = cur_all.device
    g25, held, others = far_geometries()
    build_libraries(layout_builds(far_geometries), "phase 26")

    # ---- (a) the far layout against the lean one, bitwise ----
    for suffix, g in held.items():
        pl = transcription_planner(planner, 3, g.segments)
        check(k3.KERNEL.geometry(Geometry.of_ocp(pl.ocp)).layout == "lean",
              f"{g.segments} segments take the lean layout")
        log(f"phase 26 libraries at {g.nodes} nodes in the far layout: "
            f"{block_summary(g, kernel2=False)}; {ptxas_report(k3.KERNEL, g)}; the lean build: "
            f"{ptxas_report(k3.KERNEL, dataclasses.replace(g, layout=None))}")
        # 24 x 3 has no entry of its own in the kernels line (phase 25 (c)
        # holds it without timing it): its times are in the log
        hold_layouts(pl, first_qp, "lean", "far", results.get(f"structured_admm_{suffix}", {}),
                     "phase 26", smi, turns=1)
        del pl

    # ---- (b) the main path: 25 segments of order 3 ----
    pl25 = transcription_planner(planner, 3, 25)
    ocp = pl25.ocp
    built = k3.KERNEL.geometry(g25)
    check((ocp.num_nodes, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (76, 1597, 2008)
          and Geometry.of_ocp(ocp) == g25 and (built.layout, built.ept) == ("far", 2)
          and k3.threads(g25) == 1024 and pl25.qp_settings.kkt_refine == 1,
          f"25 segments: {ocp.num_nodes} nodes, {ocp.num_var} variables, {built}, "
          f"kkt_refine {pl25.qp_settings.kkt_refine}")
    log(f"phase 26 libraries at 25 segments of order 3 (76 nodes, 1597 variables, 2008 rows, "
        f"two elements a thread, kkt_refine 1): {block_summary(g25)}; "
        f"{ptxas_report(k3.KERNEL, g25)}")
    summary, window_err = kernel_checks(pl25, first_qp, "25 segments")
    log(f"phase 26 at 25 segments of order 3 (76 nodes, far layout, two elements a thread), "
        f"{summary}")
    time_structured_kernels(pl25, first_qp, results, "seg25", "phase 26", window_err)
    captured_shipping(pl25, cur_all, tgt_all, "25 segments", "seg25", "phase 26",
                      "headline states, 25 segments of order 3, 76 nodes", results,
                      ("banded_factor", "structured_admm"), smi, turns=0)
    # phase 23's rule
    n_good, n_tf, n_fx, summary = fixture_agreement(pl25, SEG25_FIXTURE, dev)
    check(n_good >= n_fx - 4 and n_tf == n_fx,
          f"25 segments: {n_good}/{n_fx} fixture problems agree, {n_tf} final times within 1e-3")
    log(f"phase 26 JAX fixture at 25 segments: {summary}; final times within 1e-3 relative "
        f"{n_tf}/{n_fx} (bar {n_fx}), all three {n_good}/{n_fx} (bar {n_fx - 4})")
    del pl25, ocp

    # ---- (c) 9 joints at 49 nodes, 10 joints at 40, order 4 x 17 ----
    for suffix, g in others.items():
        if g.nq == 7:
            pl, cur, tgt, states = transcription_planner(planner, g.order, g.segments), \
                cur_all, tgt_all, None
            tag = f"order {g.order} x {g.segments} segments ({g.nodes} nodes)"
        else:
            pl, cur, tgt = chain_planner(planner, g.nq, segments=g.segments)
            pl.qp_settings = config.shipping_qp_settings(pl.ocp.num_nodes)
            states, tag = (cur, tgt), f"{g.nq} joints, {g.nodes} nodes"
        built = k3.KERNEL.geometry(g)
        check(Geometry.of_ocp(pl.ocp) == g and (built.layout, built.ept) == ("far", 2),
              f"{tag}: kernel 3 built as {built}")
        log(f"phase 26 libraries at {tag}, kkt_refine {pl.qp_settings.kkt_refine}: "
            f"{block_summary(g)}; {ptxas_report(k3.KERNEL, g)}")
        summary, _ = kernel_checks(pl, first_qp, tag, states)
        log(f"phase 26 at {tag} (far layout), {summary}")
        eager_shipping(pl, cur, tgt, f"{tag} ({'headline' if states is None else 'seeded'} "
                       f"states)", suffix, "phase 26", results)
        del pl, cur, tgt, states

    # the first geometries past the far layout (32 x 3, order 4 x 22, 10
    # joints x 17) plan in the deep layout: phase 28 (b) and (c)
    torch.cuda.empty_cache()


def hand_planner(planner, segments=None):
    """The Panda with its hand (``make_panda6_fixture.py``
    ``panda_urdf(lock_joint7=False, hand=True)``: the arm's 7 joints and two
    prismatic fingers, a branched tree), with the Panda's limits and the
    fingers' (``FINGER_LIMITS``), on ``planner``'s device, margins and
    shipping settings, planned with ``make_ocp(model, "panda_tool",
    fused_constraints="off")`` as a user sets it (kernel 1 takes no branched
    tree), at ``segments`` spline segments of order 3 where given (with the
    shipping QP settings of its node count); and the B_MAIN headline states
    with the fingers at 0.01 m (current) and 0.03 m (target), at rest."""
    from mpc_motion_planner_tpu_torch import config
    from mpc_motion_planner_tpu_torch.models.urdf import parse_urdf
    from mpc_motion_planner_tpu_torch.ocp import make_ocp

    fx, dev = fixture_models(), planner.device
    model = parse_urdf(fx.panda_urdf(lock_joint7=False, hand=True), dtype=planner.dtype,
                       device=dev)
    pl = robot_planner(planner, model, limits_of(planner.limits, 7, fx.FINGER_LIMITS),
                       "panda_tool", fused="off")
    if segments is not None:
        pl.ocp = make_ocp(pl.model, "panda_tool", num_segments=segments, fused_constraints="off")
        pl.qp_settings = config.shipping_qp_settings(pl.ocp.num_nodes)
    states = np.load(STATES)
    cur, tgt = (torch.as_tensor(fx.hand_states(states[k], width), dtype=planner.dtype, device=dev)
                for k, width in (("current", fx.FINGERS_CURRENT), ("target", fx.FINGERS_TARGET)))
    return pl, cur, tgt


def hand_phases(planner, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phase 27: the Panda with its hand (9 joints: the arm's 7 and two
    prismatic fingers, a branched tree), planned at full width, 19 nodes,
    514 variables, 622 rows, with the shipping QP and SQP settings and
    ``make_ocp(model, "panda_tool", fused_constraints="off")`` as a user sets
    it: kernel 1 takes no branched tree, so the constraint rows and their
    Jacobians take the plain path on the card (kinematics and ``rnea`` of
    the tree, forward-mode derivatives, the line search over 10 B
    candidates), and kernels 2 and 3 (9 joints, kernel 3 in its split
    layout, libraries built in phase 20) the QPs. (a) Kernels 2 and 3
    against their plain versions on the hand's step-0 QPs (phase 3's and
    4's bars), timed at B_TIME with their bounds and kernel 2's library
    call. (b) The main path: the captured shipping solve of the 2048
    headline states with the fingers at 0.01 m (current) and 0.03 m
    (target): 0/2/2/0 launches, bitwise its eager solve, phase 11's quality
    bars, replay and eager times in turns. (c) The JAX fixture
    ``torch_port_hand9_b64.npz`` by phase 23's rule."""
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    dev = cur_all.device
    pl, cur, tgt = hand_planner(planner)
    ocp, g = pl.ocp, Geometry(nq=9)
    check((ocp.nq, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (9, 514, 622)
          and Geometry.of_ocp(ocp) == g and k3.KERNEL.geometry(g).layout == "split"
          and not pl.model.is_serial and ocp.fused_constraints == "off"
          and not ocp.uses_kernel(dev),
          f"the hand: {ocp.nq} joints, {ocp.num_var} variables, {k3.KERNEL.geometry(g)}, "
          f"fused_constraints {ocp.fused_constraints}")
    log(f"phase 27 the Panda with its hand (9 joints, a branched tree with two prismatic "
        f"fingers; 19 nodes, 514 variables, 622 rows; fused_constraints 'off'): "
        f"{block_summary(g)}; {ptxas_report(k3.KERNEL, g)}")

    # ---- (a) kernels 2 and 3 against their plain versions, timed ----
    summary, window_err = kernel_checks(pl, first_qp, "the hand", (cur, tgt))
    log(f"phase 27 at the hand, {summary}")
    time_structured_kernels(pl, first_qp, results, "hand", "phase 27", window_err, (cur, tgt))

    # ---- (b) the main path: the captured shipping solve ----
    captured_shipping(pl, cur, tgt, "the hand", "hand", "phase 27",
                      "headline states, fingers 0.01 -> 0.03 m", results,
                      ("banded_factor", "structured_admm"), smi, launches=UNFUSED_LAUNCHES,
                      turns=0)

    # ---- (c) the JAX fixture, phase 23's rule ----
    n_good, n_tf, n_fx, summary = fixture_agreement(pl, HAND9_FIXTURE, dev)
    check(n_good >= n_fx - 4 and n_tf == n_fx,
          f"the hand: {n_good}/{n_fx} fixture problems agree, {n_tf} final times within 1e-3")
    log(f"phase 27 JAX fixture of the hand: {summary}; final times within 1e-3 relative "
        f"{n_tf}/{n_fx} (bar {n_fx}), all three {n_good}/{n_fx} (bar {n_fx - 4})")
    del pl, cur, tgt
    torch.cuda.empty_cache()


def deep_geometries():
    """Phase 28's geometries: the main path (32 x 3), the deep builds held
    against the far ones (25 and 31 x 3), and the others that take it."""
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    held = {"seg25": Geometry(25, 3, layout="deep"), "seg31": Geometry(31, 3, layout="deep")}
    others = {"order4x22": Geometry(22, 4), "10_joints_52_nodes": Geometry(17, 3, 10),
              "hand_64_nodes": Geometry(21, 3, 9), "seg40": Geometry(40, 3)}
    return Geometry(32, 3), held, others


def deep_builds():
    """Phase 28's libraries: ``layout_builds`` of its geometries, and the
    far build at 31 x 3 that its deep build is held against."""
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    return layout_builds(deep_geometries) + [("structured_admm", k3.KERNEL, Geometry(31, 3))]


def deep_phases(planner, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phase 28: kernel 3's deep layout, the far layout without Ldi, which
    travels through the copier's ring with each node's run (a second bulk
    copy onto the slot's barrier), taken where the far block does not fit
    one SM. (a) Built in the deep layout at 25 and 31 segments of order 3
    (where the far layout fits), against the far build at B=2048: all nine
    outputs bitwise (times in turns, with ptxas's registers and spill
    stores). (b) The main path: the Panda at 32 segments of order 3 (97
    nodes, 2038 variables, 2568 rows, 864 threads at three elements a
    thread), set as a user sets it (``planner.ocp = make_ocp(planner.model,
    planner.tool_frame, order=3, num_segments=32)``, its QP settings
    ``config.shipping_qp_settings(97)``: one refinement step on every KKT
    solve and 300 more iterations for a QP unconverged within its budget):
    kernels 2 and 3 against their plain versions (phase 3's and 4's
    bars), timed at B_TIME with their bounds and kernel 2's library call (at
    B=1024: the dense M and its factor take 68 GB at B=2048), the captured
    shipping solve of the headline states (5/2/2/0, bitwise its eager solve,
    quality, times in turns) and the JAX fixture ``torch_port_seg32_b64.npz``
    by phase 23's rule, its final times held to the JAX package's own
    float32 solve of the same states where that misses 1e-3 (63/64, the
    fixture's ``final_time_float32``). (c) The other geometries the deep
    layout opens: order 4 x 22 (89 nodes), a seeded 10-joint chain at 17
    segments (52 nodes), the hand at 21 segments (64 nodes,
    fused_constraints "off") and the Panda at 40 segments (121 nodes, four
    elements a thread), with the shipping QP settings of their node counts:
    kernels 2 and 3 against their plain versions (at 121 nodes the full
    solve's iteration counts read, not held: no float32 loop meets the bar
    there) and an eager shipping solve each (5/2/2/0; the hand 0/2/2/0),
    with ptxas's registers and spill stores. The first geometries past the
    deep layout, 52 segments of order 3 (157 nodes), order 4 x 34 (137), 9
    joints at 37 segments (112) and 10 joints at 30 (91), take the pair
    layout: phase 30."""
    from mpc_motion_planner_tpu_torch import config
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    dev = cur_all.device
    g32, held, others = deep_geometries()
    build_libraries(deep_builds(), "phase 28")

    # ---- (a) the deep layout against the far one, bitwise ----
    for suffix, g in held.items():
        pl = transcription_planner(planner, 3, g.segments)
        check(k3.KERNEL.geometry(Geometry.of_ocp(pl.ocp)).layout == "far",
              f"{g.segments} segments take the far layout")
        log(f"phase 28 libraries at {g.nodes} nodes in the deep layout: "
            f"{block_summary(g, kernel2=False)}; {ptxas_report(k3.KERNEL, g)}; the far build: "
            f"{ptxas_report(k3.KERNEL, dataclasses.replace(g, layout=None))}")
        # 31 x 3 has no entry of its own in the kernels line: its times are
        # in the log; both at B_ONE_ROW, to keep the script inside its time
        hold_layouts(pl, first_qp, "far", "deep", results.get(f"structured_admm_{suffix}", {}),
                     "phase 28", smi, turns=1, batch=B_ONE_ROW)
        del pl

    # ---- (b) the main path: 32 segments of order 3 ----
    pl32 = transcription_planner(planner, 3, 32)
    ocp = pl32.ocp
    built = k3.KERNEL.geometry(g32)
    check((ocp.num_nodes, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (97, 2038, 2568)
          and Geometry.of_ocp(ocp) == g32 and (built.layout, built.ept) == ("deep", 3)
          and k3.threads(g32) == 864 and pl32.qp_settings.kkt_refine == 1,
          f"32 segments: {ocp.num_nodes} nodes, {ocp.num_var} variables, {built}, "
          f"kkt_refine {pl32.qp_settings.kkt_refine}")
    log(f"phase 28 libraries at 32 segments of order 3 (97 nodes, 2038 variables, 2568 rows, "
        f"three elements a thread, kkt_refine 1): {block_summary(g32)}; "
        f"{ptxas_report(k3.KERNEL, g32)}")
    summary, window_err = kernel_checks(pl32, first_qp, "32 segments")
    log(f"phase 28 at 32 segments of order 3 (97 nodes, deep layout, three elements a thread), "
        f"{summary}")
    time_structured_kernels(pl32, first_qp, results, "seg32", "phase 28", window_err,
                            library_batch=B_MAIN // 2)
    captured_shipping(pl32, cur_all, tgt_all, "32 segments", "seg32", "phase 28",
                      "headline states, 32 segments of order 3, 97 nodes", results,
                      ("banded_factor", "structured_admm"), smi, turns=0)
    # phase 23's rule; where the JAX package's own float32 solve of the
    # fixture's states misses 1e-3 on final times, the port is held to its
    # figure, never below it
    n_good, n_tf, n_fx, summary = fixture_agreement(pl32, SEG32_FIXTURE, dev)
    n_tf32 = jax_float32_final_times(SEG32_FIXTURE)
    check(n_good >= n_fx - 4 and n_tf >= n_tf32,
          f"32 segments: {n_good}/{n_fx} fixture problems agree, {n_tf} final times within 1e-3 "
          f"(the JAX float32 solve {n_tf32})")
    log(f"phase 28 JAX fixture at 32 segments: {summary}; final times within 1e-3 relative "
        f"{n_tf}/{n_fx} (bar: the JAX package's own float32 solve of these states, "
        f"{n_tf32}/{n_fx}), all three {n_good}/{n_fx} (bar {n_fx - 4})")
    del pl32, ocp

    # ---- (c) order 4 x 22, 10 joints at 52 nodes, the hand at 64, 40 x 3 ----
    for suffix, g in others.items():
        launches = SHIPPING_LAUNCHES
        if suffix.startswith("hand"):
            pl, cur, tgt = hand_planner(planner, segments=g.segments)
            states, tag, launches = (cur, tgt), f"the hand, {g.nodes} nodes", UNFUSED_LAUNCHES
        elif g.nq == 7:
            pl, cur, tgt, states = transcription_planner(planner, g.order, g.segments), \
                cur_all, tgt_all, None
            tag = f"order {g.order} x {g.segments} segments ({g.nodes} nodes)"
        else:
            pl, cur, tgt = chain_planner(planner, g.nq, segments=g.segments)
            pl.qp_settings = config.shipping_qp_settings(pl.ocp.num_nodes)
            states, tag = (cur, tgt), f"{g.nq} joints, {g.nodes} nodes"
        built = k3.KERNEL.geometry(g)
        check(Geometry.of_ocp(pl.ocp) == g and built.layout == "deep"
              and built.ept == k3.ept_of(g), f"{tag}: kernel 3 built as {built}")
        log(f"phase 28 libraries at {tag}, {built.ept} elements a thread, kkt_refine "
            f"{pl.qp_settings.kkt_refine}, rescue {pl.qp_settings.rescue_iters}: "
            f"{block_summary(g)}; {ptxas_report(k3.KERNEL, g)}")
        # at 121 nodes no float32 ADMM loop meets iteration_agreement's bars:
        # the plain float32 loop is within 25 iterations of float64 on about
        # half the QPs, median gap 25 (PERF.md §7 question 10), so the counts are
        # read and reported there
        # (the float64 solve's counts, ~20 s at 121 nodes, are not read)
        summary, _ = kernel_checks(pl, first_qp, tag, states, hold_counts=g.nodes < 121,
                                   read_float64=False)
        log(f"phase 28 at {tag} (deep layout), {summary}")
        eager_shipping(pl, cur, tgt, f"{tag} ({'headline' if states is None else 'seeded'} "
                       f"states)", suffix, "phase 28", results, launches)
        del pl, cur, tgt, states

    torch.cuda.empty_cache()


# the sources of kernels 1-3 as they were while a lane owned one row of a
# block (csrc/one_row/), which phase 29 holds the package's builds against
ONE_ROW = os.path.join(ROOT, "mpc_motion_planner_tpu_torch", "csrc", "one_row")
# the JAX structured solve of the seeded 12-joint chain's first 64 states at
# 19 nodes, with the JAX float32 solve's final times (make_chain12_fixture.py)
CHAIN12_FIXTURE = os.path.join(FIXTURES, "torch_port_chain12_b64.npz")
# kernel 3's bitwise hold against the one-row source: four waves of the card,
# a quarter of the headline batch, to keep the script inside its time
B_ONE_ROW = 512
_ONE_ROW_KERNELS = {}


def one_row_kernels():
    """Kernels 1, 2 and 3 built from ``ONE_ROW`` (``bench/kernel_ab.py``
    ``variant_kernel``: the package's interfaces, flags and geometries), by
    kernel number."""
    from mpc_motion_planner_tpu_torch.bench.kernel_ab import variant_kernel

    if not _ONE_ROW_KERNELS:
        for n, src in ((1, "constraints.cu"), (2, "banded_factor.cu"), (3, "structured_admm.cu")):
            _ONE_ROW_KERNELS[n] = variant_kernel(n, "one_row", os.path.join(ONE_ROW, src))
    return _ONE_ROW_KERNELS


def joints_geometries():
    """Phase 29's geometries. (a) Kernel 3 in each of its layouts up to 10
    joints, where ``ONE_ROW``'s build takes it too: 19 nodes (full), 25
    (compact), order 4 x 6 (split), 12 x 3 (stream), 15 x 3 (two elements a
    thread), 20 x 3 (lean), 25 x 3 (far), 32 x 3 (deep). (b) Kernel 3 at 12
    joints in each layout, at the first grid that takes it: 2 segments
    (full), 3 (compact), 4 (split), 5 (stream), 6 (lean: 19 nodes, the main
    path), 9 (far), 12 (deep); and 11 joints at 6 segments (stream, blk 33)
    and 14 at 6 (far). The first grids past the deep layout of 11, 12 and
    14 joints take the pair layout: phase 30."""
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    held = {"19 nodes (full)": Geometry(), "25 nodes (compact)": Geometry(8),
            "order 4 x 6 (split)": Geometry(6, 4), "12 x 3 (stream)": Geometry(12),
            "15 x 3 (two elements a thread)": Geometry(15), "20 x 3 (lean)": Geometry(20),
            "25 x 3 (far)": Geometry(25), "32 x 3 (deep)": Geometry(32)}
    twelve = {"full": Geometry(2, 3, 12), "compact": Geometry(3, 3, 12),
              "split": Geometry(4, 3, 12), "stream": Geometry(5, 3, 12),
              "lean": Geometry(6, 3, 12), "far": Geometry(9, 3, 12), "deep": Geometry(12, 3, 12)}
    others = {"11_joints": Geometry(6, 3, 11), "14_joints": Geometry(6, 3, 14)}
    return held, twelve, others


def joints_builds():
    """Phase 29's libraries: ``ONE_ROW``'s kernel 3 at each held geometry,
    its kernel 2 at 7 and 10 joints and its kernel 1 at 7 and 10; kernels 2
    and 3 at 12 joints in each layout and at 11 and 14 joints; kernel 1 at 11,
    12 and 14 joints."""
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    one = one_row_kernels()
    held, twelve, others = joints_geometries()
    return ([("structured_admm", kernels.KERNELS["structured_admm"], g)
             for g in (twelve["lean"], others["11_joints"])]
            + [("constraints", kernels.KERNELS["constraints"], Geometry(nq=nq))
               for nq in (11, 12, 14)]
            + [("banded_factor", kernels.KERNELS["banded_factor"], g)
               for g in (twelve["lean"], *others.values())]
            + [(name, kernels.KERNELS[name], g) for g in (*twelve.values(), others["14_joints"])
               if g != twelve["lean"] for name in ("banded_factor", "structured_admm")]
            + [("structured_admm one row", one[3], g) for g in held.values()]
            + [("banded_factor one row", one[2], Geometry(nq=nq)) for nq in (7, 10)]
            + [("constraints one row", one[1], Geometry(nq=nq)) for nq in (7, 10)])


def one_row_holds(planner, first_qp, smi) -> None:
    """Phase 29 (a): up to 10 joints the package's builds of kernels 1-3
    are ``ONE_ROW``'s, bitwise. Kernel 3 at each layout's geometry
    (``joints_geometries``), on the step-0 QPs of the first B_ONE_ROW headline
    states at the full budget: all nine outputs equal, and ptxas's registers
    and spill stores of both instantiations equal; kernel 2 at 19 nodes of
    the Panda and of the 10-joint chain: all five outputs equal; kernel 1 at
    7 and 10 joints on seeded iterates (the one-row source with the robot
    by value in its launch's parameters, the package's reading it from
    device memory): values and Jacobians equal."""
    from mpc_motion_planner_tpu_torch.bench.kernel_ab import run_with
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels import constraints as k1
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.ops import qp_structured

    one = one_row_kernels()
    held, _, _ = joints_geometries()
    names = ("x", "zc", "zx", "yc", "yx", "done", "iters", "rp", "rd")
    for tag, g in held.items():
        pl = transcription_planner(planner, g.order, g.segments)
        ocp, shipping = pl.ocp, pl.qp_settings
        _, sa, args, sc, sx = first_qp(B_ONE_ROW, pl=pl)
        qp = qp_structured.scale_qp(ocp, sa, *args, shipping, soft_c=sc, soft_x=sx)
        fac = k2.factor(qp.Mband, qp.p_col, qp.m_pp, ocp.coll.order)
        out, ms = {}, {}
        for name, k in (("package", k3.KERNEL), ("one_row", one[3]), ("package", k3.KERNEL)):
            ms[name] = time_kernel(lambda k=k, name=name: out.__setitem__(
                name, run_with(k3, k, k3.admm_kernel, ocp, sa, qp, fac, shipping)), reps=1)
        differ = [n for n, a, b in zip(names, out["package"], out["one_row"])
                  if not torch.equal(a, b)]
        regs = {name: ptxas_report(k, g) for name, k in (("package", k3.KERNEL),
                                                          ("one_row", one[3]))}
        check(not differ, f"{tag}: kernel 3 differs from the one-row build in {differ}")
        check(regs["package"] == regs["one_row"] and regs["package"],
              f"{tag}: kernel 3's registers and spills {regs}")
        log(f"phase 29 (a) kernel 3 at {tag}, B={B_ONE_ROW}, budget {shipping.max_iter} + "
            f"{shipping.rescue_iters}: all nine outputs bitwise the one-row source's "
            f"({int(out['package'][6].sum())} problem-iterations; {ms['package']:.3f} against "
            f"{ms['one_row']:.3f} ms); ptxas {regs['package']} in both")
        del pl, sa, args, qp, fac, out
    # kernel 2 at 19 nodes of the Panda and of the 10-joint chain
    pl10, cur10, tgt10 = chain_planner(planner, 10)
    for tag, pl, states in (("7 joints", planner, None), ("10 joints", pl10, (cur10, tgt10))):
        _, sa, args, sc, sx = first_qp(B_MAIN, pl=pl, states=states)
        qp = qp_structured.scale_qp(pl.ocp, sa, *args, pl.qp_settings, soft_c=sc, soft_x=sx)
        got = k2.factor_banded_kernel(qp.Mband, qp.p_col, qp.m_pp)
        ref = run_with(k2, one[2], k2.factor_banded_kernel, qp.Mband, qp.p_col, qp.m_pp)
        differ = [n for n in got if not torch.equal(got[n], ref[n])]
        check(not differ, f"kernel 2 at {tag}: differs from the one-row build in {differ}")
        log(f"phase 29 (a) kernel 2 at {tag}, 19 nodes, B={B_MAIN}: Ldi, Lsub, u, s and ok "
            f"bitwise the one-row source's ({int(got['ok'].sum())}/{B_MAIN} ok)")
    # kernel 1 at 7 and 10 joints
    gen = torch.Generator().manual_seed(29)
    for pl in (planner, pl10):
        nq = pl.ocp.nq
        lo = torch.tensor([-2.5] * nq + [-2.0] * nq + [-10.0] * nq)
        xu = (lo - 2 * lo * torch.rand(B_MAIN, 19, 3 * nq, generator=gen)).to(pl.device)
        X, U = xu[..., :2 * nq].contiguous(), xu[..., 2 * nq:].contiguous()
        # the one-row source takes the robot by value: its host constants
        one[1].consts = k1.bake_model(pl.ocp.model, pl.ocp.tool_frame)[0]
        got = (*k1.node_constraints_kernel(pl.ocp, X, U, True),
               k1.node_constraints_kernel(pl.ocp, X, U, False))
        ref = (*run_with(k1, one[1], k1.node_constraints_kernel, pl.ocp, X, U, True),
               run_with(k1, one[1], k1.node_constraints_kernel, pl.ocp, X, U, False))
        same = [torch.equal(a, b) for a, b in zip(got, ref)]
        check(all(same), f"kernel 1 at {nq} joints: g, J, values bitwise the one-row "
              f"source's: {same}")
        log(f"phase 29 (a) kernel 1 at {nq} joints, F={B_MAIN * 19}: values and Jacobian of "
            f"the Jacobian launch and the value launch bitwise the one-row source's")
    del pl10, cur10, tgt10


def joints_phases(planner, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phase 29: kernels 1-3 past 10 joints, a lane of a warp owning two rows
    of a block (blk 33 to 63). (a) Up to 10 joints the builds are those of
    the one-row sources (``one_row_holds``). (b) Each kernel past 10 joints
    against its plain version, with its block against the Python
    reckoning: kernel 1 at 11, 12 and 14 joints (phase 2's bars or, where
    the plain float32 values miss them, twice its distance from float64,
    timed), kernel 2 at 11, 12 and 14 joints (phase 3's bars) and kernel 3
    at 12 joints in each of its seven layouts and at 11 joints in the
    stream layout (phase 4's bars, ``iteration_agreement`` with its float64
    rule), with ptxas's registers and spill stores. (c) The main path: the
    seeded 12-joint chain (``bench/convergence.py`` ``chain(12, ...)``) at
    19 nodes, 685 variables, 823 rows, kernel 3 in its lean layout: kernels
    2 and 3 timed at B_TIME against their plain versions with their bounds
    and kernel 2's library call, the captured shipping solve of the chain's
    2048 states (5/2/2/0, bitwise its eager solve, times in turns; its
    quality read, not held: the seeded chains' QPs do not converge within
    the budgets, at float64 either) and the JAX fixture
    ``torch_port_chain12_b64.npz``: final times within 1e-3 relative on no
    fewer states than the JAX package's own float32 solve, ``qp_converged``
    the same on all but 64/32; eager solves of 11 joints and 14 joints at 6
    segments. (The first grids past the deep layout take the pair layout:
    phase 30.)"""
    from mpc_motion_planner_tpu_torch import config
    from mpc_motion_planner_tpu_torch.kernels import constraints as k1
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry
    from mpc_motion_planner_tpu_torch.ops import qp_structured

    dev = cur_all.device
    held, twelve, others = joints_geometries()
    build_libraries(joints_builds(), "phase 29")
    one_row_holds(planner, first_qp, smi)

    # ---- (b) kernel 1 at 11, 12 and 14 joints ----
    big = torch.ones(8192, 8192, device=dev)
    chains = {}
    for nq in (11, 12, 14):
        pl, cur, tgt = chain_planner(planner, nq)
        chains[nq] = (pl, cur, tgt)
        lay = k1.block_layout(nq)
        want = k1.reckoning(nq)
        check(lay == want, f"kernel 1 at {nq} joints: the library's block {lay}, the reckoning "
              f"{want}")
        log(f"phase 29 (b) kernel 1 at {nq} joints: the Jacobian launch's tiles "
            f"{lay['smem_bytes']} B of dynamic shared memory, registers capped for "
            f"{lay['blocks_bound']} blocks an SM, {k1.param_bytes(nq)} B of parameters; the "
            f"reckoning agrees; {ptxas_report(k1.KERNEL, Geometry(nq=nq))}")
        kernel1_check(pl, results, "phase 29 (b)", lambda: big @ big)
    del big

    # ---- (b) kernel 2 at 11 and 14 joints, kernels 2 and 3 at 11 joints in
    # the stream layout and at 12 joints in each layout ----
    for nq in (11, 14):
        pl, cur, tgt = chains[nq]
        g = Geometry(nq=nq)
        log(f"phase 29 (b) at {nq} joints, 19 nodes: {block_summary(g, kernel2=False)}; "
            f"{ptxas_report(k3.KERNEL, g)}; kernel 2: "
            f"{factor_check(pl, first_qp, f'{nq} joints', (cur, tgt))[1]}")
        # kernel 2 timed with its bound and its library call at B=2048, and
        # kernel 3's bound at 14 joints (11 joints' with the 12-joint layouts)
        _, sa, args, sc, sx = first_qp(B_MAIN, pl=pl, states=(cur, tgt))
        qp = qp_structured.scale_qp(pl.ocp, sa, *args, pl.qp_settings, soft_c=sc, soft_x=sx)
        time_factor(qp, g, {}, f"{nq} joints, 19 nodes", "phase 29 (b)")
        if nq == 14:
            kernel3_timing(pl, first_qp, (cur, tgt), "14 joints, 19 nodes (far)", "phase 29 (b)",
                           plain=False)
        del sa, args, sc, sx, qp
    for tag, g in [(f"12 joints, {g.nodes} nodes ({name})", g) for name, g in twelve.items()] \
            + [("11 joints, 19 nodes (stream)", others["11_joints"])]:
        pl, cur, tgt = chain_planner(planner, g.nq, segments=g.segments)
        pl.qp_settings = config.shipping_qp_settings(pl.ocp.num_nodes)
        built = k3.KERNEL.geometry(g)
        want = tag.split("(")[1].rstrip(")")
        check(Geometry.of_ocp(pl.ocp) == g and built.layout == want,
              f"{tag}: kernel 3 built as {built}")
        log(f"phase 29 (b) libraries at {tag}, {built.ept} element(s) a thread, "
            f"{k3.rows(g)} rows a lane: {block_summary(g)}; {ptxas_report(k3.KERNEL, g)}")
        summary, window_err = kernel_checks(pl, first_qp, tag, (cur, tgt))
        log(f"phase 29 (b) at {tag}, {summary}")
        if g == twelve["lean"]:
            lean_err = window_err
        else:  # the main path's bound is time_structured_kernels', (c)
            kernel3_timing(pl, first_qp, (cur, tgt), tag, "phase 29 (b)", plain=False)
        del pl, cur, tgt

    # ---- (c) the main path: the 12-joint chain at 19 nodes ----
    pl12, cur12, tgt12 = chains[12]
    ocp = pl12.ocp
    g12 = twelve["lean"]
    check((ocp.nq, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (12, 685, 823)
          and Geometry.of_ocp(ocp) == g12 and k3.KERNEL.geometry(g12).layout == "lean"
          and ocp.uses_kernel(dev), f"the 12-joint chain: {ocp.nq} joints, {ocp.num_var} "
          f"variables, {k3.KERNEL.geometry(g12)}")
    time_structured_kernels(pl12, first_qp, results, "12_joints", "phase 29 (c)", lean_err,
                            (cur12, tgt12))
    captured_shipping(pl12, cur12, tgt12, "the 12-joint chain", "12_joints", "phase 29 (c)",
                      "the chain's seeded states, 19 nodes", results,
                      ("constraints", "banded_factor", "structured_admm"), smi,
                      hold_quality=False, turns=0)
    counts = {}
    n_good, n_tf, n_fx, summary = fixture_agreement(pl12, CHAIN12_FIXTURE, dev, counts)
    n_tf32 = jax_float32_final_times(CHAIN12_FIXTURE)
    check(n_tf >= n_tf32 and counts["qp_converged"] >= n_fx - n_fx // 32,
          f"the 12-joint chain: {n_tf} final times within 1e-3 (the JAX float32 solve "
          f"{n_tf32}), qp_converged the same on {counts['qp_converged']}/{n_fx}")
    log(f"phase 29 (c) JAX fixture of the 12-joint chain: {summary}; final times within 1e-3 "
        f"relative {n_tf}/{n_fx} (bar: the JAX package's own float32 solve of these states, "
        f"{n_tf32}/{n_fx}), qp_converged the same {counts['qp_converged']}/{n_fx} (bar "
        f"{n_fx - n_fx // 32}), all three {n_good}/{n_fx} (read)")
    del pl12, cur12, tgt12, ocp
    for nq in (11, 14):
        pl, cur, tgt = chains.pop(nq)
        eager_shipping(pl, cur, tgt, f"the {nq}-joint chain, 19 nodes (seeded states)",
                       f"{nq}_joints", "phase 29 (c)", results)
        del pl, cur, tgt
    chains.clear()
    torch.cuda.empty_cache()


# the eager solves of phase 30's geometries other than its main path: two
# waves of the card's 66 clusters of two blocks
B_PAIR = 132


def pair_geometries():
    """Phase 30's geometries: (a) the pair builds held against the deep ones
    (32 x 3, 51 x 3 at four elements a thread, 12 joints x 12, two rows a
    lane), by the suffix of their ``kernels`` entries; (b) the seven that
    take the pair layout, the main path (52 x 3) first; (d) the first of the
    Panda's at order 4 and of 9, 10, 11, 12 and 14 joints past it and past
    the slim layout (the Panda's at order 3 is phase 33's)."""
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    held = {"seg32": Geometry(32, 3, layout="pair"), "seg51": Geometry(51, 3, layout="pair"),
            "12_joints_37_nodes": Geometry(12, 3, 12, layout="pair")}
    takes = {"seg52": Geometry(52, 3), "order4x34": Geometry(34, 4),
             "9_joints_112_nodes": Geometry(37, 3, 9), "10_joints_91_nodes": Geometry(30, 3, 10),
             "11_joints_76_nodes": Geometry(25, 3, 11), "12_joints_61_nodes": Geometry(20, 3, 12),
             "14_joints_37_nodes": Geometry(12, 3, 14)}
    refused = (Geometry(42, 4), Geometry(46, 3, 9), Geometry(41, 3, 10), Geometry(37, 3, 11),
               Geometry(34, 3, 12), Geometry(29, 3, 14))
    return held, takes, refused


def pair_builds():
    """Phase 30's libraries: kernel 3 in the pair layout where the deep one
    fits, with the deep builds and kernel 2 at 51 x 3 and 12 joints x 12
    (32 x 3's are phase 28's), and kernels 2 and 3 at the seven geometries
    that take it."""
    from mpc_motion_planner_tpu_torch import kernels

    held, takes, _ = pair_geometries()
    k2, k3 = kernels.KERNELS["banded_factor"], kernels.KERNELS["structured_admm"]
    deep = [dataclasses.replace(held[s], layout=None) for s in ("seg51", "12_joints_37_nodes")]
    return ([("structured_admm", k3, g) for g in held.values()]
            + [(name, k, g) for g in deep for name, k in (("structured_admm", k3),
                                                        ("banded_factor", k2))]
            + [(name, kernels.KERNELS[name], g) for g in takes.values()
               for name in ("banded_factor", "structured_admm")])


def pair_planner(planner, g):
    """A planner of ``g`` (Geometry of order 3 or 4) as a user sets it, with
    the shipping QP settings of its node count: the Panda, or the seeded
    chain of ``g.nq`` joints; and its states (None: the headline's)."""
    from mpc_motion_planner_tpu_torch import config

    if g.nq == 7:
        return transcription_planner(planner, g.order, g.segments), None
    pl, cur, tgt = chain_planner(planner, g.nq, segments=g.segments)
    pl.qp_settings = config.shipping_qp_settings(pl.ocp.num_nodes)
    return pl, (cur, tgt)


def pair_phases(planner, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phase 30: kernel 3's pair layout, the deep layout in a cluster of two
    blocks a problem (rank 0 all the deep layout holds but the copier's ring,
    rank 1 the ring and its copier; rank 0 reads the ring's blocks from rank
    1's shared memory), taken where the deep block does not fit one SM.
    (a) Built in the pair layout at 32 and 51 segments of order 3 and at 12
    joints x 12 (where the deep layout fits) against the deep build at
    B=2048 (51 x 3 at B_ONE_ROW): all nine outputs bitwise at the full
    budget and at one window,
    times in turns, with ptxas's registers and spill stores of both. (b) The
    seven geometries the deep layout refused: 52 x 3 (157 nodes, five
    elements a thread), order 4 x 34 (137), seeded chains of 9 joints x 37
    (112), 10 x 30 (91), 11 x 25 (76), 12 x 20 (61) and 14 x 12 (37), with
    the shipping QP settings of their node counts: their blocks against the
    Python reckoning (each rank's bytes, the clusters at a time), kernels 2
    and 3 against their plain versions (``kernel_checks``; at 121 nodes and
    more the full solve's iteration counts read against the plain float32
    loop, not held, as phase 28 does), and, but the main path, an eager
    shipping solve of the first B_PAIR states (5/2/2/0). (c) The main path:
    the Panda at 52 segments of order 3 (157 nodes, 3298 variables, 4168
    rows) set as a user sets it: kernels 2 and
    3 timed at B=128 with their bounds and kernel 2's library call (the full
    solve's iteration counts read against the plain float32 loop, not
    held), the captured shipping solve of the headline
    states (5/2/2/0, bitwise its eager solve, quality: from 122 nodes the
    shipping settings give 900 rescue iterations), and the JAX fixture
    ``torch_port_seg52_b64.npz`` in the configuration of the JAX float32
    solve (one refinement step, no rescue iterations): final times within
    1e-3 relative on no fewer states than that solve, every state in the
    target box (qp_converged read beside them). (d) The first geometries past the
    pair layout and the slim one refused naming each rank's bytes, before any build."""
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    dev = cur_all.device
    held, takes, refused = pair_geometries()
    build_libraries(pair_builds(), "phase 30")

    # ---- (a) the pair layout against the deep one, bitwise ----
    for suffix, g in held.items():
        pl, states = pair_planner(planner, g)
        tag = f"{g.nodes} nodes" + (f", {g.nq} joints" if g.nq != 7 else "")
        check(k3.KERNEL.geometry(Geometry.of_ocp(pl.ocp)).layout == "deep",
              f"{tag} takes the deep layout")
        log(f"phase 30 (a) libraries at {tag} in the pair layout: "
            f"{block_summary(g, kernel2=False)}; {ptxas_report(k3.KERNEL, g)}; the deep build: "
            f"{ptxas_report(k3.KERNEL, dataclasses.replace(g, layout=None))}")
        # only 32 x 3 has an entry of its own in the kernels line (phase 28's);
        # each at B_ONE_ROW (four waves of the card), to keep the script
        # inside its time
        hold_layouts(pl, first_qp, "deep", "pair", results.get(f"structured_admm_{suffix}", {}),
                     "phase 30 (a)", smi, states, turns=1, batch=B_ONE_ROW)
        del pl, states

    # ---- (b) the seven geometries that take the pair layout ----
    window_err = {}
    for suffix, g in takes.items():
        pl, states = pair_planner(planner, g)
        tag = (f"order {g.order} x {g.segments} segments ({g.nodes} nodes)" if g.nq == 7
               else f"{g.nq} joints, {g.nodes} nodes")
        built = k3.KERNEL.geometry(g)
        check(Geometry.of_ocp(pl.ocp) == g and built.layout == "pair"
              and built.ept == k3.ept_of(g), f"{tag}: kernel 3 built as {built}")
        log(f"phase 30 (b) libraries at {tag}, {built.ept} elements a thread, {k3.rows(g)} "
            f"row(s) a lane, kkt_refine {pl.qp_settings.kkt_refine}, rescue "
            f"{pl.qp_settings.rescue_iters}: {block_summary(g)}; {ptxas_report(k3.KERNEL, g)}")
        summary, window_err[suffix] = kernel_checks(pl, first_qp, tag, states,
                                                     hold_counts=g.nodes < 121,
                                                     read_float64=False)
        log(f"phase 30 (b) at {tag} (pair layout), {summary}")
        if suffix != "seg52":
            cur, tgt = states if states is not None else (cur_all, tgt_all)
            eager_shipping(pl, cur[:B_PAIR], tgt[:B_PAIR],
                           f"{tag} ({'headline' if states is None else 'seeded'} states)",
                           suffix, "phase 30 (b)", results)
            del cur, tgt
        del pl, states

    # ---- (c) the main path: 52 segments of order 3 ----
    g52 = takes["seg52"]
    pl52, _ = pair_planner(planner, g52)
    ocp = pl52.ocp
    built = k3.KERNEL.geometry(g52)
    check((ocp.num_nodes, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (157, 3298, 4168)
          and (built.layout, built.ept) == ("pair", 5) and k3.threads(g52) == 864
          and pl52.qp_settings.kkt_refine == 1,
          f"52 segments: {ocp.num_nodes} nodes, {ocp.num_var} variables, {built}, "
          f"kkt_refine {pl52.qp_settings.kkt_refine}")
    # at B=64, one wave of the card's 66 clusters (the plain loop takes 43 s
    # at B=2048 on an H100, 21 s at 256, 18.6 s at 128); its iteration counts
    # read, not held, as at 121 nodes in phase 28
    time_structured_kernels(pl52, first_qp, results, "seg52", "phase 30 (c)",
                            window_err["seg52"], batch=B_MAIN // 32, hold_counts=False)
    captured_shipping(pl52, cur_all, tgt_all, "52 segments", "seg52", "phase 30 (c)",
                      "headline states, 52 segments of order 3, 157 nodes", results,
                      ("banded_factor", "structured_admm"), smi, turns=0)
    # the fixture in the configuration of the JAX float32 solve it holds the
    # card to: one refinement step and no rescue iterations (as the JAX
    # float64 solve has none), where the shipping settings give 900
    pl52.qp_settings = dataclasses.replace(pl52.qp_settings, rescue_iters=0)
    counts = {}
    n_good, n_tf, n_fx, summary = fixture_agreement(pl52, SEG52_FIXTURE, dev, counts)
    n_tf32 = jax_float32_final_times(SEG52_FIXTURE)
    check(n_tf >= n_tf32 and counts["in_box"] == n_fx,
          f"52 segments: {n_tf} final times within 1e-3 (the JAX float32 solve {n_tf32}), "
          f"{counts['in_box']}/{n_fx} in the target box")
    log(f"phase 30 (c) JAX fixture at 52 segments (kkt_refine 1, no rescue iterations, as the "
        f"JAX float32 solve): {summary}; final times within 1e-3 relative {n_tf}/{n_fx} (bar: "
        f"the JAX package's own float32 solve of these states, {n_tf32}/{n_fx}), in the target "
        f"box {counts['in_box']}/{n_fx} (bar {n_fx}); qp_converged the same "
        f"{counts['qp_converged']}/{n_fx}, states with a QP the JAX float64 solve converged "
        f"unconverged here {counts['converged_lost']}, all three {n_good}/{n_fx} (read: float32 "
        f"against float64 within the 700 / 500 budgets, where a quarter of these QPs stop "
        f"unconverged)")
    del pl52, ocp

    # ---- (d) past the pair and slim layouts: refused naming the bytes ----
    for g in refused:
        if g.nq == 7:
            pl, cur, tgt = transcription_planner(planner, g.order, g.segments), cur_all, tgt_all
            tag = f"order {g.order} x {g.segments} segments ({g.nodes} nodes)"
        else:
            pl, cur, tgt = chain_planner(planner, g.nq, fused="off", segments=g.segments)
            tag = f"{g.nq} joints, {g.nodes} nodes"
        refusal(pl, cur[:4], tgt[:4], tag, "phase 30 (d)")
        del pl, cur, tgt
    torch.cuda.empty_cache()


# phase 31's batch of the 21-joint chain's eager solve and fixture-free
# timing, and of the eager solves at 1, 16, 19 and 20 joints: 4.4 waves of
# the 30 clusters of four blocks the card places at 21 joints
B_SPREAD = 132
# phases 31 and 32's batch of kernel 1's checks (x 19 nodes: 9,728
# evaluations, about the line-search launch of phase 32's main path, 10
# B_WIDE x 19)
B_K1 = 512
# the JAX structured solve of the seeded 21-joint chain's first 64 states at
# 19 nodes, with the JAX float32 solve's final times
# (make_chain12_fixture.py --joints 21)
CHAIN21_FIXTURE = os.path.join(FIXTURES, "torch_port_chain21_b64.npz")


def spread_geometries():
    """Phase 31's geometries: (a) kernel 3's pair layout forced to spread
    its ring over two ranks where one holds it (14 joints x 12, 37 nodes)
    and kernel 2 forced to read its ring back from device memory where the
    shared ring fits (14 and 19 joints at 19 nodes); (b) the seeded chains
    that take the new builds at 19 nodes, by joint count: one joint (kernel
    3's block takes more warps than its elements fill), kernel 3's pair
    layout with its ring spread from 16 joints, kernel 2's device ring from
    20; (d) the first grids past the pair and slim layouts at 16 and 21
    joints."""
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    held = Geometry(12, 3, 14, layout="pair", ranks=2)
    rings = (Geometry(nq=14, ring="device"), Geometry(nq=19, ring="device"))
    chains = (1, 16, 19, 20, 21)
    refused = (Geometry(24, 3, 16), Geometry(17, 3, 21))
    return held, rings, chains, refused


def spread_builds():
    """Phase 31's libraries: kernel 3's ring spread over two ranks at 14
    joints x 12 (the one-rank build there is phase 30's), kernel 2 with the
    device ring at 14
    and 19 joints (the shared ones are phase 29's and the chains'), and
    kernels 1-3 at 19 nodes of the chains of 1, 16, 19, 20 and 21 joints."""
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    held, rings, chains, _ = spread_geometries()
    k2, k3 = kernels.KERNELS["banded_factor"], kernels.KERNELS["structured_admm"]
    return ([("structured_admm", k3, held)] + [("banded_factor", k2, g) for g in rings]
            + [(name, kernels.KERNELS[name], Geometry(nq=nq)) for nq in chains
               for name in ("constraints", "banded_factor", "structured_admm")])


def hold_rings(pl, first_qp, states, entry, phase, smi, batch=4 * B_SPREAD, base="shared",
               other="device") -> None:
    """Kernel 2 at ``pl``'s geometry built with the ``other`` ring (device,
    or the scratch build) against its build with the ``base`` one (shared,
    or device), on the step-0 QPs of the first ``batch`` of ``states`` (four
    waves of the card at one problem an SM): all five outputs bitwise equal,
    times in turns (base, other, other, base), into ``entry`` as
    ``<base>_ms``, ``<other>_ms`` and ``<other>_bitwise_<base>``."""
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry
    from mpc_motion_planner_tpu_torch.ops import qp_structured

    ocp = pl.ocp
    _, sa, args, sc, sx = first_qp(batch, pl=pl, states=states)
    qp = qp_structured.scale_qp(ocp, sa, *args, pl.qp_settings, soft_c=sc, soft_x=sx)
    out, times = {}, {base: [], other: []}
    for ring in (base, other, other, base):
        def call(ring=ring):
            out[ring] = k2.factor_banded_kernel(qp.Mband, qp.p_col, qp.m_pp, ring=ring)
        times[ring].append(time_kernel(call, reps=3))
    differ = [k for k in out[base] if not torch.equal(out[base][k], out[other][k])]
    check(not differ, f"{ocp.nq} joints: kernel 2's {other} ring differs from the {base} one "
          f"in {differ}")
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    entry.update({f"{base}_ms": ms[base], f"{other}_ms": ms[other],
                  f"{other}_bitwise_{base}": True})
    g = Geometry.of_ocp(ocp)
    log(f"{phase} kernel 2 at {ocp.nq} joints, 19 nodes, B={batch}: the {other} ring "
        f"({k2.smem_bytes(g, other)} B, {k2.staged_nodes(g, other)} nodes staged) against "
        f"the {base} one ({k2.smem_bytes(g, base)} B): Ldi, Lsub, u, s and ok bitwise equal "
        f"({int(out[base]['ok'].sum())}/{batch} ok); {base} {ms[base]:.3f} ms, {other} "
        f"{ms[other]:.3f} ms ({100 * (ms[other] / ms[base] - 1):+.2f}%; runs "
        f"{times}); {ptxas_report(k2.KERNEL, dataclasses.replace(g, ring=other))} against "
        f"{ptxas_report(k2.KERNEL, dataclasses.replace(g, ring=base))} on {smi}")
    del sa, args, sc, sx, qp, out


def spread_phases(planner, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phase 31: every joint count kernel 1 takes (up to 21) at the
    headline's 19 nodes. Kernel 3's pair layout with its ring spread over
    ranks 1..R of a cluster of 1 + R blocks, whole slots a rank (R = 2 at 16
    to 20 joints, 3 at 21), where one rank 1 cannot hold the ring; kernel
    2's device ring: the sub-diagonal blocks of the last bw nodes read back
    from device memory where the block wrote them, taken where the shared
    ring does not fit (20 and 21 joints). (a) Kernel 3's ring spread over
    two ranks at 14 joints x 12 against its one-rank build at B=264, all
    nine outputs bitwise at the full budget and at one window (ptxas of
    both); kernel 2 with the device ring against the shared one at 14 and
    19 joints, B=528, all five outputs bitwise. (b)
    Each new build against its plain version, with its block against the
    Python reckoning (each rank's bytes, the clusters at a time) and ptxas's
    registers and spills, at 1, 16, 19, 20 and 21 joints: kernel 1 (phase
    2's bars or the float64 rule, on B_K1 x 19 evaluations), kernel 2
    (phase 3's bars, timed with its bound and its library call at
    B_SPREAD), kernel 3 at 1, 16 and 21 joints
    (``kernel_checks``: phase 4's bars, ``iteration_agreement`` with its
    float64 rule) and its check window timed at 1, 16, 19 and 20 joints at
    B_SPREAD against its plain loop's.
    (c) The seeded 21-joint chain (``bench/convergence.py`` ``chain(21,
    ...)``, 1198 variables, 1426 rows) at B_SPREAD: kernel 3 timed against
    its plain loop with its bound, the eager shipping solve (5/2/2/0; its
    captured solve is phase 32's at 25 joints; quality read, not held: the
    seeded chains' QPs do not converge within the budgets, at float64
    either), and the JAX fixture ``torch_port_chain21_b64.npz``: final
    times within 1e-3 relative on no fewer states than the JAX float32
    solve, ``qp_converged`` the same on all but 64/32; eager solves of the
    1-joint chain, the 16-joint chain (a cluster of three), the 19- and the
    20-joint chain (kernel 2's device ring). (d) The first grids past the pair and slim
    layouts at 16 and 21 joints refused naming each rank's bytes, before any build."""
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels import constraints as k1
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry
    from mpc_motion_planner_tpu_torch.ops import qp_structured

    dev = cur_all.device
    held, rings, chains, refused = spread_geometries()
    build_libraries(spread_builds(), "phase 31")
    for name, k in (("constraints", k1.KERNEL), ("banded_factor", k2.KERNEL),
                    ("structured_admm", k3.KERNEL)):
        for nq in chains:
            results[f"{name}_{nq}_joints"] = {
                "name": f"{name}_{nq}_joints", "route": "cuda",
                "source": f"mpc_motion_planner_tpu_torch/csrc/{k.source}",
                "replaces": REPLACES[name]}

    # ---- (a) the ring spread against one ring rank, the device ring
    # against the shared one, bitwise ----
    pl14, states14 = pair_planner(planner, held)
    own = k3.KERNEL.geometry(Geometry.of_ocp(pl14.ocp))
    check(own.layout == "pair" and own.ranks is None,
          f"14 joints x 12 takes the pair layout, its ring in rank 1: {own}")
    log(f"phase 31 (a) libraries at 37 nodes, 14 joints in the pair layout with its ring "
        f"spread over {held.ranks} ranks: {block_summary(held, kernel2=False)}; "
        f"{ptxas_report(k3.KERNEL, held)}; the pair build with one ring rank: "
        f"{ptxas_report(k3.KERNEL, own)}")
    hold_layouts(pl14, first_qp, "pair", "pair",
                 results["structured_admm_16_joints"].setdefault("held_14_joints_37_nodes", {}),
                 "phase 31 (a)", smi, states14, turns=1, batch=2 * B_SPREAD, ranks=held.ranks)
    del pl14, states14
    pls = {}
    for g in rings:
        pl, cur, tgt = chain_planner(planner, g.nq)
        pls[g.nq] = (pl, cur, tgt)
        check(k2.choose_ring(Geometry(nq=g.nq)) == "shared", f"{g.nq} joints: the shared ring")
        hold_rings(pl, first_qp, (cur, tgt),
                   results["banded_factor_20_joints"].setdefault(f"held_{g.nq}_joints", {}),
                   "phase 31 (a)", smi)
    pls.pop(14)

    # ---- (b) kernel 1 at 1, 16, 19, 20 and 21 joints ----
    big = torch.ones(8192, 8192, device=dev)
    for nq in chains:
        if nq not in pls:
            pls[nq] = chain_planner(planner, nq)
        pl = pls[nq][0]
        lay = k1.block_layout(nq)
        want = k1.reckoning(nq)
        check(lay == want, f"kernel 1 at {nq} joints: the library's block {lay}, the reckoning "
              f"{want}")
        log(f"phase 31 (b) kernel 1 at {nq} joints: the Jacobian launch's tiles "
            f"{lay['smem_bytes']} B of dynamic shared memory, registers capped for "
            f"{lay['blocks_bound']} block(s) an SM, {k1.param_bytes(nq)} B of parameters; the "
            f"reckoning agrees; {ptxas_report(k1.KERNEL, Geometry(nq=nq))}")
        kernel1_check(pl, results, "phase 31 (b)", lambda: big @ big, reps=0, batch=B_K1)
    del big

    # ---- (b) kernels 2 and 3 at 1, 16, 19, 20 and 21 joints ----
    window_err = {}
    for nq in chains:
        pl, cur, tgt = pls[nq]
        g = Geometry(nq=nq)
        built = k3.KERNEL.geometry(g)
        check(Geometry.of_ocp(pl.ocp) == g
              and (built.layout, built.ranks) == (("full", None) if nq == 1 else
                                                  ("pair", 3 if nq == 21 else 2))
              and k2.choose_ring(g) == ("device" if nq >= 20 else "shared"),
              f"{nq} joints: kernel 3 built as {built}, kernel 2's ring {k2.choose_ring(g)}")
        ranks = (f", {k3.ring_ranks(g)} ring ranks of {k3.slots_per_rank(g)} slots"
                 if built.layout == "pair" else "")
        tag = f"{nq} joint(s), 19 nodes ({built.layout} layout{ranks})"
        log(f"phase 31 (b) libraries at {tag}, {built.ept} element(s) a thread, {k3.rows(g)} "
            f"row(s) a lane: {block_summary(g)}; kernel 3 {ptxas_report(k3.KERNEL, g)}; kernel 2 "
            f"{ptxas_report(k2.KERNEL, g)}")
        # kernel 2 timed with its bound and library call at B_SPREAD
        _, sa, args, sc, sx = first_qp(B_SPREAD, pl=pl, states=(cur, tgt))
        qp = qp_structured.scale_qp(pl.ocp, sa, *args, pl.qp_settings, soft_c=sc, soft_x=sx)
        time_factor(qp, g, results[f"banded_factor_{nq}_joints"],
                    f"{nq} joints, 19 nodes ({k2.choose_ring(g)} ring)", "phase 31 (b)")
        del sa, args, sc, sx, qp
        if nq in (1, 16, 21):
            summary, window_err[nq] = kernel_checks(pl, first_qp, tag, (cur, tgt))
            log(f"phase 31 (b) at {tag}, {summary}")
        if nq != 21:
            kernel3_timing(pl, first_qp, (cur, tgt), tag, "phase 31 (b)", B_SPREAD,
                           entry=results[f"structured_admm_{nq}_joints"], budget=False)

    # ---- (c) the main path: the 21-joint chain at 19 nodes ----
    pl21, cur21, tgt21 = pls.pop(21)
    ocp = pl21.ocp
    g21 = Geometry(nq=21)
    check((ocp.nq, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (21, 1198, 1426)
          and Geometry.of_ocp(ocp) == g21 and k3.KERNEL.geometry(g21).layout == "pair"
          and k3.ring_ranks(g21) == 3 and ocp.uses_kernel(dev),
          f"the 21-joint chain: {ocp.nq} joints, {ocp.num_var} variables, "
          f"{k3.KERNEL.geometry(g21)}")
    time_structured_kernels(pl21, first_qp, results, "21_joints", "phase 31 (c)",
                            window_err[21], (cur21, tgt21), batch=B_SPREAD, factor=False)
    # the captured solve of the widest chain is phase 32's (25 joints): here
    # the eager solve
    eager_shipping(pl21, cur21[:B_SPREAD], tgt21[:B_SPREAD],
                   "the 21-joint chain, 19 nodes (seeded states)", "21_joints", "phase 31 (c)",
                   results)
    counts = {}
    n_good, n_tf, n_fx, summary = fixture_agreement(pl21, CHAIN21_FIXTURE, dev, counts)
    n_tf32 = jax_float32_final_times(CHAIN21_FIXTURE)
    check(n_tf >= n_tf32 and counts["qp_converged"] >= n_fx - n_fx // 32,
          f"the 21-joint chain: {n_tf} final times within 1e-3 (the JAX float32 solve "
          f"{n_tf32}), qp_converged the same on {counts['qp_converged']}/{n_fx}")
    log(f"phase 31 (c) JAX fixture of the 21-joint chain: {summary}; final times within 1e-3 "
        f"relative {n_tf}/{n_fx} (bar: the JAX package's own float32 solve of these states, "
        f"{n_tf32}/{n_fx}), qp_converged the same {counts['qp_converged']}/{n_fx} (bar "
        f"{n_fx - n_fx // 32}), in the target box {counts['in_box']}/{n_fx}, all three "
        f"{n_good}/{n_fx} (read)")
    del pl21, cur21, tgt21, ocp
    for nq in (1, 16, 19, 20):
        pl, cur, tgt = pls.pop(nq)
        eager_shipping(pl, cur[:B_SPREAD], tgt[:B_SPREAD],
                       f"the {nq}-joint chain, 19 nodes (seeded states)", f"{nq}_joints",
                       "phase 31 (c)", results)
        del pl, cur, tgt

    # ---- (d) past the pair and slim layouts: refused naming the bytes ----
    for g in refused:
        pl, cur, tgt = chain_planner(planner, g.nq, fused="off", segments=g.segments)
        refusal(pl, cur[:4], tgt[:4], f"{g.nq} joints, {g.nodes} nodes", "phase 31 (d)")
        del pl, cur, tgt
    torch.cuda.empty_cache()


# phase 32's batch of the 25-joint chain's captured solve and of its kernel
# timings, and of the eager solves at 22, 24 and 28 joints: two waves of the
# 22 clusters of five blocks the card places at 24 and 25 joints
B_WIDE = 44
# the JAX structured solve of the seeded 25-joint chain's first 64 states at
# 19 nodes, with the JAX float32 solve's final times
# (make_chain12_fixture.py --joints 25)
CHAIN25_FIXTURE = os.path.join(FIXTURES, "torch_port_chain25_b64.npz")


def wide_geometries():
    """Phase 32's geometries: (a) the joint counts kernel 1 takes past 21
    (the J tile in shared memory up to 23 joints, each thread's columns of
    J to device memory past it, 32 joints at most); (b) the seeded chains
    past 21 joints that kernels 2 and 3 take, three rows of a block a lane:
    22, 24 and 25 joints at 19 nodes (kernel 3's ring over three ranks at
    22, four at 24 and 25, a cluster of five) and 28 joints at 7 nodes; (d)
    the first grids past the slim layout at 22 and 25 joints (26 joints at
    19 nodes and 29 at 7, which phase 32 refused before the slim layout and
    kernel 2's scratch build, plan: phase 33)."""
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    kernel1 = (22, 24, 25, 28, 32)
    chains = (Geometry(nq=22), Geometry(nq=24), Geometry(nq=25), Geometry(2, 3, 28))
    refused = (Geometry(16, 3, 22), Geometry(13, 3, 25))
    return kernel1, chains, refused


def wide_builds():
    """Phase 32's libraries: kernel 1 at 22, 24, 25, 28 and 32 joints,
    kernels 2 and 3 at the chains' geometries."""
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    kernel1, chains, _ = wide_geometries()
    k1, k2, k3 = (kernels.KERNELS[n] for n in ("constraints", "banded_factor", "structured_admm"))
    return ([("structured_admm", k3, g) for g in chains]
            + [("banded_factor", k2, g) for g in chains]
            + [("constraints", k1, Geometry(nq=nq)) for nq in kernel1])


def wide_planner(planner, g):
    """The seeded chain of ``g.nq`` joints at ``g``'s grid, with the
    shipping QP settings of its node count, and its states."""
    from mpc_motion_planner_tpu_torch import config

    pl, cur, tgt = chain_planner(planner, g.nq, segments=g.segments if g.segments != 6 else None)
    pl.qp_settings = config.shipping_qp_settings(pl.ocp.num_nodes)
    return pl, cur, tgt


def wide_phases(planner, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phase 32: kernels 1-3 past 21 joints. Kernel 1 reads its robot from
    device memory (a pointer in its launch's parameters, 72 B at any joint
    count) and past 23 joints writes each thread's columns of J to device
    memory, its J tile no longer fitting; kernels 2 and 3 hold three rows
    of a block a lane (blocks of 66 to 84 rows), kernel 3's ring over three
    ranks at 22 and 23 joints and four (a cluster of five) from 24.
    (a) Kernel 1 at 22, 24, 25, 28 and 32 joints against its plain version
    on B_K1 x 19 evaluations (``kernel1_check``: phase 2's bars or the
    float64 rule), its block against the reckoning (``k1.reckoning``) and
    ptxas's registers and spills. (b) Kernels 2 and 3 at 22, 24 and 25 joints at 19 nodes and
    28 joints at 7 nodes against their plain versions (``kernel_checks``:
    phase 3's and 4's bars, ``iteration_agreement`` with its float64 rule),
    each rank's bytes and the clusters at a time against the reckoning
    (``block_summary``), ptxas; kernel 2 timed with its bound and
    ``cholesky_ex`` of the dense M, kernel 3's check window timed at B_WIDE
    against its plain loop's. (c) The main
    path: the seeded 25-joint chain (``bench/convergence.py`` ``chain(25,
    ...)``, 1426 variables, 1694 rows): the captured shipping solve of its
    first B_WIDE states (5/2/2/0, bitwise its eager solve; quality read, not
    held), the JAX fixture ``torch_port_chain25_b64.npz`` (final times
    within 1e-3 relative on no fewer states than the JAX float32 solve,
    ``qp_converged`` the same on all but 64/32); eager solves of the 22- and
    24-joint chains at 19 nodes and the 28-joint chain at 7. (d) 22 joints
    at 49 nodes and 25 at 40, the first grids past the slim layout there,
    refused naming their bytes, before any build."""
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels import constraints as k1
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry
    from mpc_motion_planner_tpu_torch.ops import qp_structured

    dev = cur_all.device
    kernel1, chains, refused = wide_geometries()
    build_libraries(wide_builds(), "phase 32")
    suffix = lambda g: f"{g.nq}_joints" + ("" if g.segments == 6 else f"_{g.nodes}_nodes")
    for name, k in (("constraints", k1.KERNEL), ("banded_factor", k2.KERNEL),
                    ("structured_admm", k3.KERNEL)):
        for g in chains:
            results[f"{name}_{suffix(g)}"] = {
                "name": f"{name}_{suffix(g)}", "route": "cuda",
                "source": f"mpc_motion_planner_tpu_torch/csrc/{k.source}",
                "replaces": REPLACES[name]}

    # ---- (a) kernel 1 at 22, 24, 25, 28 and 32 joints ----
    big = torch.ones(8192, 8192, device=dev)
    for nq in kernel1:
        pl = chain_planner(planner, nq)[0]
        lay = k1.block_layout(nq)
        check(lay == k1.reckoning(nq), f"kernel 1 at {nq} joints: the library's block {lay}, "
              f"the reckoning {k1.reckoning(nq)}")
        log(f"phase 32 (a) kernel 1 at {nq} joints: the Jacobian launch {lay['threads']} "
            f"threads, {lay['smem_bytes']} B of dynamic shared memory (J "
            f"{'in a tile' if lay['j_tiled'] else 'from each thread to device memory'}), "
            f"registers capped for {lay['blocks_bound']} block(s) an SM, {lay['param_bytes']} B "
            f"of parameters, the robot {lay['robot_bytes']} B in device memory; the reckoning "
            f"agrees; {ptxas_report(k1.KERNEL, Geometry(nq=nq))}")
        # the 28-joint chain plans at 7 nodes; 32 joints' entry takes the
        # launches of phase 33's main path
        kernel1_check(pl, results, "phase 32 (a)", lambda: big @ big, reps=0,
                      key="constraints_28_joints_7_nodes" if nq == 28 else None, batch=B_K1)
        del pl
    del big

    # ---- (b) kernels 2 and 3 at 22, 24, 25 joints x 6 and 28 x 2 ----
    pls, window_err = {}, {}
    for g in chains:
        pl, cur, tgt = pls[g.nq] = wide_planner(planner, g)
        built = k3.KERNEL.geometry(g)
        ranks = 3 if g.nq < 24 else 4
        check(Geometry.of_ocp(pl.ocp) == g and (built.layout, built.ranks) == ("pair", ranks)
              and k3.rows(g) == 3 and k2.rows(g) == 3 and k2.choose_ring(g) == "device",
              f"{g.nq} joints x {g.segments}: kernel 3 built as {built}, kernel 2's ring "
              f"{k2.choose_ring(g)}")
        tag = (f"{g.nq} joints, {g.nodes} nodes (pair layout, {ranks} ring ranks of "
               f"{k3.slots_per_rank(g)} slots, 3 rows a lane)")
        log(f"phase 32 (b) libraries at {tag}, {built.ept} element(s) a thread: "
            f"{block_summary(g)}; kernel 3 {ptxas_report(k3.KERNEL, g)}; kernel 2 "
            f"{ptxas_report(k2.KERNEL, g)}")
        _, sa, args, sc, sx = first_qp(B_WIDE, pl=pl, states=(cur, tgt))
        qp = qp_structured.scale_qp(pl.ocp, sa, *args, pl.qp_settings, soft_c=sc, soft_x=sx)
        time_factor(qp, g, results[f"banded_factor_{suffix(g)}"], tag, "phase 32 (b)")
        del sa, args, sc, sx, qp
        summary, window_err[g.nq] = kernel_checks(pl, first_qp, tag, (cur, tgt))
        log(f"phase 32 (b) at {tag}, {summary}")
        if g.nq != 25:  # one check window: at the full budget a launch takes seconds
            kernel3_timing(pl, first_qp, (cur, tgt), tag, "phase 32 (b)", B_WIDE,
                           entry=results[f"structured_admm_{suffix(g)}"], budget=False)

    # ---- (c) the main path: the 25-joint chain at 19 nodes ----
    pl25, cur25, tgt25 = pls.pop(25)
    ocp = pl25.ocp
    check((ocp.nq, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (25, 1426, 1694)
          and ocp.uses_kernel(dev), f"the 25-joint chain: {ocp.nq} joints, {ocp.num_var} "
          f"variables, {k3.KERNEL.geometry(Geometry.of_ocp(ocp))}")
    time_structured_kernels(pl25, first_qp, results, "25_joints", "phase 32 (c)",
                            window_err[25], (cur25, tgt25), batch=B_WIDE, factor=False)
    captured_shipping(pl25, cur25[:B_WIDE], tgt25[:B_WIDE], "the 25-joint chain",
                      "25_joints", "phase 32 (c)", "the chain's seeded states, 19 nodes", results,
                      ("constraints", "banded_factor", "structured_admm"), smi,
                      hold_quality=False, turns=0)
    counts = {}
    n_good, n_tf, n_fx, summary = fixture_agreement(pl25, CHAIN25_FIXTURE, dev, counts)
    n_tf32 = jax_float32_final_times(CHAIN25_FIXTURE)
    check(n_tf >= n_tf32 and counts["qp_converged"] >= n_fx - n_fx // 32,
          f"the 25-joint chain: {n_tf} final times within 1e-3 (the JAX float32 solve "
          f"{n_tf32}), qp_converged the same on {counts['qp_converged']}/{n_fx}")
    log(f"phase 32 (c) JAX fixture of the 25-joint chain: {summary}; final times within 1e-3 "
        f"relative {n_tf}/{n_fx} (bar: the JAX package's own float32 solve of these states, "
        f"{n_tf32}/{n_fx}), qp_converged the same {counts['qp_converged']}/{n_fx} (bar "
        f"{n_fx - n_fx // 32}), in the target box {counts['in_box']}/{n_fx}, all three "
        f"{n_good}/{n_fx} (read)")
    del pl25, cur25, tgt25, ocp
    for g in chains:
        if g.nq in pls:
            pl, cur, tgt = pls.pop(g.nq)
            eager_shipping(pl, cur[:B_WIDE], tgt[:B_WIDE],
                           f"the {g.nq}-joint chain, {g.nodes} nodes (seeded states)", suffix(g),
                           "phase 32 (c)", results)
            del pl, cur, tgt

    # ---- (d) past the slim layout: refused naming the bytes, before any build ----
    for g in refused:
        pl, cur, tgt = chain_planner(planner, g.nq, fused="off", segments=g.segments)
        refusal(pl, cur[:4], tgt[:4], f"{g.nq} joints, {g.nodes} nodes", "phase 32 (d)")
        del pl, cur, tgt
    torch.cuda.empty_cache()



# the JAX structured solve of the seeded 32-joint chain's first 64 states at
# 19 nodes, with the JAX float32 solve's final times
# (make_chain12_fixture.py --joints 32)
CHAIN32_FIXTURE = os.path.join(FIXTURES, "torch_port_chain32_b64.npz")


def slim_geometries():
    """Phase 33's geometries: (a) kernel 3 built in the slim layout where
    the pair layout fits, at 25 joints x 6 (one chain buffer for both chain
    warps: three rows a lane) and at 32 x 3 of the Panda (97 nodes: a chain
    buffer each, one row a lane); (b) kernel 2 at 25 joints
    built in its scratch build, where its device ring fits; (c) the seeded
    chains of 26, 28, 30 and 32 joints at 19 nodes (kernel 3's slim layout,
    the ring over four ranks at 26 and 28 and over seven, a cluster of
    eight, at 30 and 32; kernel 2's device ring at 26, its scratch build
    from 28); (d) 14 joints x 26 (79 nodes), a geometry the slim layout opens
    with one ring rank; (f) past them: 32 joints x 7 (22 nodes) and the
    Panda at 60 segments (181 nodes), kernel 1 at 33 joints."""
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    held3 = (Geometry(nq=25, layout="slim"), Geometry(32, 3, layout="slim"))
    held2 = Geometry(nq=25, ring="scratch")
    chains = tuple(Geometry(nq=nq) for nq in (26, 28, 30, 32))
    return held3, held2, chains, Geometry(26, 3, 14), (Geometry(7, 3, 32), Geometry(60, 3))


def slim_builds():
    """Phase 33's libraries: kernel 3 in the slim layout at 25 joints and at
    32 x 3 and kernel 2's scratch build at 25 joints (the pair and device
    builds there are phases 28, 30 and 32's), kernels 1-3 at the chains'
    geometries and kernels 2 and 3 at 14 joints x 26."""
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.kernels.build import Geometry

    held3, held2, chains, opened, _ = slim_geometries()
    k1, k2, k3 = (kernels.KERNELS[n] for n in ("constraints", "banded_factor", "structured_admm"))
    return ([("structured_admm", k3, g) for g in (*held3, *chains, opened)]
            + [("banded_factor", k2, g) for g in (held2, *chains, opened)]
            + [("constraints", k1, Geometry(nq=g.nq)) for g in chains])


def slim_phases(planner, cur_all, tgt_all, first_qp, results, smi) -> None:
    """Phase 33: every joint count kernel 1 takes (1 to 32) at the
    headline's 19 nodes. Past 25 joints the pair layout's rank 0 does not
    fit, most of it its six staging buffers of a block: kernel 3 takes the
    slim layout, the pair's with those buffers cut to the ones in use at one
    time (a chain warp's two blocks in one buffer, past one row a lane one
    for both chain warps); past 27 joints kernel 2's device ring does not fit
    and it takes its scratch build (the inverse and C[d >= 2] of its forward
    loop in Ldi in device memory, one staged node). (a) Slim beside pair at
    25 joints x 6 on phase 32's states, B_WIDE, and at 32 x 3 on the
    headline states (one row a lane: a chain buffer each), two waves of its
    clusters, the full budget and one check window: all nine outputs
    bitwise, µs per iteration per cluster of both (``hold_layouts``). (b) The scratch build beside the device ring at
    25 joints: all five outputs bitwise, timed (``hold_rings``). (c) Kernels
    2 and 3 at 26, 28, 30 and 32 joints x 6, at two waves of the clusters
    the card places at a time (``cudaOccupancyMaxActiveClusters``): each
    rank's bytes and kernel 2's block against the reckoning
    (``block_summary``), kernel 2 against its plain version and
    ``cholesky_ex`` of the dense M (``time_factor``), both against their
    plain versions (``kernel_checks``), kernel 3's check window timed against
    its plain loop's. (d) 14 joints x 26: its blocks, ``kernel_checks`` (B=64
    for kernel 3). (e) The main path: the seeded 32-joint chain
    (``bench/convergence.py`` ``chain(32, ...)``, 1825 variables, 2163 rows)
    at 19 nodes, the captured shipping solve of its first two waves of
    clusters (5/2/2/0, bitwise its eager solve; quality read, not held), the
    JAX fixture ``torch_port_chain32_b64.npz`` (final times within 1e-3 on
    no fewer states than the JAX float32 solve, ``qp_converged`` the same on
    all but 64/32); eager solves at 26, 28 and 30 joints. (f) Kernel 1 at 33
    joints, 32 joints x 7 and the Panda at 60 x 3 refused naming their
    bytes (kernel 1: its threads), before any build."""
    from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
    from mpc_motion_planner_tpu_torch.kernels import constraints as k1
    from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
    from mpc_motion_planner_tpu_torch.kernels.build import SMEM_LIMIT, Geometry
    from mpc_motion_planner_tpu_torch.ops import qp_structured

    dev = cur_all.device
    held3, held2, chains, opened, refused = slim_geometries()
    build_libraries(slim_builds(), "phase 33")
    suffix = lambda g: f"{g.nq}_joints"
    for name, k in (("banded_factor", k2.KERNEL), ("structured_admm", k3.KERNEL)):
        for g in chains:
            results[f"{name}_{suffix(g)}"] = {
                "name": f"{name}_{suffix(g)}", "route": "cuda",
                "source": f"mpc_motion_planner_tpu_torch/csrc/{k.source}",
                "replaces": REPLACES[name]}

    # ---- (a), (b) the new builds beside the old ones where both fit ----
    g25, g32 = (dataclasses.replace(g, layout=None) for g in held3)
    pl25, cur25, tgt25 = wide_planner(planner, g25)
    pl32 = transcription_planner(planner, 3, 32)
    check(k3.choose_layout(g25) == "pair" and k3.choose_layout(g32) == "deep"
          and k2.choose_ring(g25) == "device"
          and all(k3.KERNEL.geometry(g).layout == "slim" for g in held3)
          and k2.KERNEL.geometry(held2).ring == "scratch",
          f"kernel 3 {[k3.KERNEL.geometry(g) for g in held3]}, kernel 2 "
          f"{k2.KERNEL.geometry(held2)}")
    for g, pl, states, batch, entry in (
            (held3[0], pl25, (cur25, tgt25), B_WIDE, results["structured_admm_25_joints"]),
            (held3[1], pl32, None,
             2 * problems_at_once(dataclasses.replace(g32, layout="pair"))[0],
             results["structured_admm_seg32"].setdefault("slim_beside_pair", {}))):
        pair = dataclasses.replace(g, layout="pair")
        log(f"phase 33 (a) kernel 3 at {g.nodes} nodes and {g.nq} joints in the slim layout: "
            f"{block_summary(g, kernel2=False)} (the pair build: {k3.rank_bytes(pair)} B); "
            f"{ptxas_report(k3.KERNEL, g)} against the pair's {ptxas_report(k3.KERNEL, pair)}")
        hold_layouts(pl, first_qp, "pair", "slim", entry, "phase 33 (a)", smi, states, turns=1,
                     batch=batch)
    del pl32
    lay2 = k2.block_layout(held2)
    want2 = {"smem_bytes": k2.smem_bytes(held2), "per_sm": k2.per_sm(held2),
             "staged": k2.staged_nodes(held2)}
    check({k: lay2[k] for k in want2} == want2,
          f"kernel 2's scratch build at 25 joints: the library's block {lay2}, the reckoning "
          f"{want2}")
    hold_rings(pl25, first_qp, (cur25, tgt25), results["banded_factor_25_joints"],
               "phase 33 (b)", smi, batch=4 * B_WIDE, base="device", other="scratch")
    del pl25, cur25, tgt25

    # ---- (c) kernels 2 and 3 at 26, 28, 30 and 32 joints x 6 ----
    pls = {}
    for g in chains:
        pl, cur, tgt = wide_planner(planner, g)
        built = k3.KERNEL.geometry(g)
        ranks, ring = (4 if g.nq <= 28 else 7), ("device" if g.nq < 28 else "scratch")
        check(Geometry.of_ocp(pl.ocp) == g and (built.layout, built.ranks) == ("slim", ranks)
              and k3.rows(g) == 3 and k2.rows(g) == 3 and k2.choose_ring(g) == ring,
              f"{g.nq} joints x {g.segments}: kernel 3 built as {built}, kernel 2's ring "
              f"{k2.choose_ring(g)}")
        batch = 2 * problems_at_once(g)[0]
        tag = (f"{g.nq} joints, {g.nodes} nodes (slim layout, {ranks} ring ranks of "
               f"{k3.slots_per_rank(g)} slots, 3 rows a lane; kernel 2's {ring} ring)")
        log(f"phase 33 (c) libraries at {tag}, {built.ept} element(s) a thread: "
            f"{block_summary(g)}; kernel 3 {ptxas_report(k3.KERNEL, g)}; kernel 2 "
            f"{ptxas_report(k2.KERNEL, g)}; two waves: B={batch}")
        _, sa, args, sc, sx = first_qp(batch, pl=pl, states=(cur, tgt))
        qp = qp_structured.scale_qp(pl.ocp, sa, *args, pl.qp_settings, soft_c=sc, soft_x=sx)
        time_factor(qp, g, results[f"banded_factor_{suffix(g)}"], tag, "phase 33 (c)")
        del sa, args, sc, sx, qp
        summary, _ = kernel_checks(pl, first_qp, tag, (cur, tgt))
        log(f"phase 33 (c) at {tag}, {summary}")
        kernel3_timing(pl, first_qp, (cur, tgt), tag, "phase 33 (c)", batch,
                       entry=results[f"structured_admm_{suffix(g)}"], budget=False)
        pls[g.nq] = (pl, cur, tgt, batch)

    # ---- (d) 14 joints x 26: the slim layout with one ring rank ----
    pl14, cur14, tgt14 = wide_planner(planner, opened)
    built = k3.KERNEL.geometry(opened)
    check(Geometry.of_ocp(pl14.ocp) == opened and (built.layout, built.ranks) == ("slim", None)
          and k3.smem_bytes(opened, "pair") > SMEM_LIMIT,
          f"14 joints x 26: kernel 3 built as {built}")
    tag = f"14 joints, {opened.nodes} nodes (slim layout, one ring rank, 2 rows a lane)"
    log(f"phase 33 (d) libraries at {tag}, {built.ept} element(s) a thread: "
        f"{block_summary(opened)} (the pair's rank 0 {k3.rank_bytes(opened)[0]} B); kernel 3 "
        f"{ptxas_report(k3.KERNEL, opened)}")
    summary, _ = kernel_checks(pl14, first_qp, tag, (cur14, tgt14))
    log(f"phase 33 (d) at {tag}, {summary}")
    del pl14, cur14, tgt14

    # ---- (e) the main path: the 32-joint chain at 19 nodes ----
    pl32, cur32, tgt32, b32 = pls.pop(32)
    ocp = pl32.ocp
    check((ocp.nq, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (32, 1825, 2163)
          and ocp.uses_kernel(dev), f"the 32-joint chain: {ocp.nq} joints, {ocp.num_var} "
          f"variables, {k3.KERNEL.geometry(Geometry.of_ocp(ocp))}")
    captured_shipping(pl32, cur32[:b32], tgt32[:b32], "the 32-joint chain",
                      "32_joints", "phase 33 (e)", "the chain's seeded states, 19 nodes", results,
                      ("constraints", "banded_factor", "structured_admm"), smi,
                      hold_quality=False, turns=0)
    counts = {}
    n_good, n_tf, n_fx, summary = fixture_agreement(pl32, CHAIN32_FIXTURE, dev, counts)
    n_tf32 = jax_float32_final_times(CHAIN32_FIXTURE)
    check(n_tf >= n_tf32 and counts["qp_converged"] >= n_fx - n_fx // 32,
          f"the 32-joint chain: {n_tf} final times within 1e-3 (the JAX float32 solve "
          f"{n_tf32}), qp_converged the same on {counts['qp_converged']}/{n_fx}")
    log(f"phase 33 (e) JAX fixture of the 32-joint chain: {summary}; final times within 1e-3 "
        f"relative {n_tf}/{n_fx} (bar: the JAX package's own float32 solve of these states, "
        f"{n_tf32}/{n_fx}), qp_converged the same {counts['qp_converged']}/{n_fx} (bar "
        f"{n_fx - n_fx // 32}), in the target box {counts['in_box']}/{n_fx}, all three "
        f"{n_good}/{n_fx} (read)")
    del pl32, cur32, tgt32, ocp
    for nq in sorted(pls):
        pl, cur, tgt, batch = pls.pop(nq)
        eager_shipping(pl, cur[:batch], tgt[:batch], f"the {nq}-joint chain, 19 nodes (seeded "
                       f"states)", f"{nq}_joints", "phase 33 (e)", results)
        del pl, cur, tgt

    # ---- (f) past them: refused naming the bytes, before any build ----
    pl, cur, tgt = chain_planner(planner, 33)
    try:
        k1.check_fits(33)
        refused1 = None
    except ValueError as err:
        refused1 = str(err)
    names = f"{k1.threads(33)} threads"
    check(refused1 is not None and names in refused1,
          f"33 joints: kernel 1's fit check says {refused1}")
    try:
        pl.solve(cur[:4], tgt[:4])
        solved = "solved"
    except ValueError as err:
        solved = str(err)
    check(names in solved, f"33 joints on the card: {solved}")
    check(not k1.KERNEL.library_path(Geometry(nq=33)).exists(),
          "33 joints: a kernel-1 library was built")
    log(f"phase 33 (f) refusal at 33 joints: {refused1}; the planner's solve on the card raises "
        f"the same, and no kernel 1 library was built for it")
    del pl, cur, tgt
    for g in refused:
        if g.nq == 7:
            pl, cur, tgt = transcription_planner(planner, g.order, g.segments), cur_all, tgt_all
            tag = f"order {g.order} x {g.segments} segments ({g.nodes} nodes)"
        else:
            pl, cur, tgt = chain_planner(planner, g.nq, fused="off", segments=g.segments)
            tag = f"{g.nq} joints, {g.nodes} nodes"
        refusal(pl, cur[:4], tgt[:4], tag, "phase 33 (f)")
        del pl, cur, tgt
    torch.cuda.empty_cache()

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

    # ---- phase 1: build, one nvcc per source and transcription (kernels 2
    # and 3 at 19, 25 and 13 nodes), all started together ----
    build_libraries([(name, k, g) for name, k in kernels.KERNELS.items()
                     for g in (geometries() if k.per_geometry == "transcription" else (None,))],
                    "phase 1")

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

    def first_qp(B, dense=False, settings=shipping, headline=True, pl=None, states=None):
        """The step-0 QPs of ``pl`` (default: the shipping planner, 19
        nodes) on the first B states (``states``: another robot's (current,
        target))."""
        pl = pl or planner
        cur, tgt = (cur_all[:B], tgt_all[:B]) if headline else (cur_gen[:B], tgt_gen[:B])
        if states is not None:
            cur, tgt = states[0][:B], states[1][:B]
        z0 = pl.warm_start_vector(pl.plan_warm_start(cur, tgt))
        bounds = pl.nlp_bounds(cur, tgt)
        _, _, lin, (h, lc, uc, lx, ux) = qp_subproblem(pl.ocp, bounds, z0, dense)
        P = hessian_regularization_diag(pl.ocp, B, f32, dev, pl.sqp_settings.reg_eps)
        soft_c, soft_x = soft_weights(pl.ocp, pl.sqp_settings, B, f32, dev)
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
    s_win = dataclasses.replace(shipping, max_iter=shipping.check_every, rescue_iters=0)
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
    s_win = dataclasses.replace(s_ref, max_iter=shipping.check_every, rescue_iters=0)
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
    nref_k, nref_p = int(nref_k), int(nref_p)
    # one factorization per dispatch: the system is rebuilt at every boundary
    check(n3 == len(qp_structured.chunk_sizes(s_ada)) and n2 == n3,
          f"adaptive rho: {n3} launches of kernel 3, {n2} of kernel 2")
    # whether any of the 64 problems wants another rho at a boundary is one
    # more float32 lottery of the two loops (PERF.md, ROADMAP Queue 3): the
    # per-problem bar below is the check, the boundary counts may differ by one
    check(nref_k > 0 and nref_p > 0 and abs(nref_k - nref_p) <= 1,
          f"adaptive rho: rho moved at {nref_k} boundaries with the kernels, {nref_p} plain")
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
        f"launches of kernel 3, {n2} of kernel 2, boundaries where rho moved kernel {nref_k}, "
        f"plain {nref_p}; {agreement}; of the {int(same.sum())} problems whose iteration counts are "
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
    check(counts_b == {"constraints": 5, "banded_factor": 2 * n_chunks,
                       "structured_admm": 2 * n_chunks, "admm_dense": 0},
          f"default structured path launch counts {counts_b}")
    check(refactors > 0, "default structured path: rho moved at no boundary")
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
        f"launches {counts_b}, boundaries where rho moved {refactors}, ok-flag repairs "
        f"{k2.REPAIRS.count}, "
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
    n_good, _, n_fx, summary = fixture_agreement(planner, FIXTURE, dev)
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
    n_good, _, n_fx, summary = fixture_agreement(dense_planner, DENSE_FIXTURE, dev)
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
        tensor_bytes(qp.Mband, qp.p_col, qp.m_pp, *fk.values()), "band in, factors out",
        library="torch.linalg.cholesky_ex of the dense M, phase 18")
    log(f"phase 10 kernel 2 B={B_MAIN}: kernel {k_ms:.3f} ms ({per_sm2} problems per SM), "
        f"plain {p_ms:.3f} ms (runs {raw}); {text}; "
        f"ok flags identical ({int(fk['ok'].sum())}/{B_MAIN} ok), max-norm relative error "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()) + " (tol 1e-3)")
    del fk, fp
    out.clear()
    fac = k2.factor(qp.Mband, qp.p_col, qp.m_pp, 3)
    # the eager plain loop (5-6 s) runs once, timed without a warm-up call
    k_ms = time_kernel(keep("kernel", lambda: k3.admm_kernel(ocp, sa, qp, fac, shipping)), reps=1)
    p_ms = time_kernel(keep("plain", lambda: qp_structured.admm_plain(ocp, sa, qp, fac, shipping)),
                       reps=1, warm=False)
    raw = {"plain": [p_ms], "kernel": [k_ms]}
    got, ref = (qp_structured.unscale_solution(qp, *out[k]) for k in ("kernel", "plain"))
    k3_bytes = tensor_bytes(
        fac["Ldi"], fac["Lsub"], fac["u"], fac["s"], sa.J, sa.f_rows, sa.p,
        qp.qs, qp.Ps, qp.rx, qp.lxs, qp.uxs, qp.thx, qp.D, qp.x, qp.zx, qp.yx,
        qp.rc, qp.lcs, qp.ucs, qp.E, qp.thr, qp.zc, qp.yc, *out["kernel"])
    k3_iters = int(out["kernel"][6].sum())
    # the plain loop with its check windows replayed from a CUDA graph, as
    # phases 19-26 time it: bitwise the eager loop
    windows = PlainWindows(ocp, sa, qp, fac, shipping)
    g_ms = time_kernel(keep("graphed", windows), reps=1, warm=False)
    names = ("x", "zc", "zx", "yc", "yx", "done", "iters", "rp", "rd")
    differ = [n for n, a, b in zip(names, out["graphed"], out["plain"]) if not torch.equal(a, b)]
    check(not differ, f"kernel 3's plain loop replayed by check windows differs from the eager "
          f"loop in {differ}")
    log(f"phase 10 kernel 3's plain loop B={B_MAIN}, budget {shipping.max_iter}, its "
        f"{len(windows.windows)} check windows replayed from one CUDA graph (captured in "
        f"{windows.capture_s:.2f} s, warm-up window included): all nine outputs bitwise the "
        f"eager loop's; {g_ms:.3f} ms against the eager loop's {p_ms:.3f} ms")
    del windows
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
    s_win = dataclasses.replace(shipping, max_iter=shipping.check_every, rescue_iters=0)
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
    # the plain chunk (1.7 s) runs once, timed without a warm-up call
    k_ms = time_kernel(keep("kernel", lambda: k4.admm_dense_kernel(
        ops, st, chunk_iters=dense_cfg.max_iter, **ckw)), reps=1)
    p_ms = time_kernel(keep("plain", lambda: k4.admm_dense_plain(
        ops, st, chunk_iters=dense_cfg.max_iter, **ckw)), reps=1, warm=False)
    raw = {"plain": [p_ms], "kernel": [k_ms]}
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
    # phases 20-33's libraries build in the background from here on, each
    # phase waiting for its own
    prebuild([job for builds in (robot_builds, order_builds, split_builds, stream_builds,
                                 ept_builds, lambda: layout_builds(lean_geometries),
                                 lambda: layout_builds(far_geometries), deep_builds,
                                 joints_builds, pair_builds, spread_builds, wide_builds,
                                 slim_builds)
              for job in builds()])
    xla_planner = MotionPlanner(margins=Margins(*MARGINS), dtype=f32, device=dev)
    captured_phases({"structured_pallas": planner, "pallas": dense_planner,
                     "structured": default_planner, "xla": xla_planner},
                    cur_all, tgt_all, first_qp, results, smi)
    transcription_phases(planner, cur_all, tgt_all, first_qp, results, smi)
    robot_phases(planner, dense_cfg, cur_all, tgt_all, first_qp, results, smi)
    order_phases(planner, dense_cfg, cur_all, tgt_all, first_qp, results, smi)
    split_phases(planner, cur_all, tgt_all, first_qp, results, smi)
    stream_phases(planner, cur_all, tgt_all, first_qp, results, smi)
    ept_phases(planner, cur_all, tgt_all, first_qp, results, smi)
    lean_phases(planner, cur_all, tgt_all, first_qp, results, smi)
    far_phases(planner, cur_all, tgt_all, first_qp, results, smi)
    hand_phases(planner, cur_all, tgt_all, first_qp, results, smi)
    deep_phases(planner, cur_all, tgt_all, first_qp, results, smi)
    joints_phases(planner, cur_all, tgt_all, first_qp, results, smi)
    pair_phases(planner, cur_all, tgt_all, first_qp, results, smi)
    spread_phases(planner, cur_all, tgt_all, first_qp, results, smi)
    wide_phases(planner, cur_all, tgt_all, first_qp, results, smi)
    slim_phases(planner, cur_all, tgt_all, first_qp, results, smi)

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
