"""PyTorch port past 21 joints: kernel 1 at every joint count its block
takes (1 to 32, the robot in device memory, past 23 joints the J tile left
out), kernels 2 and 3 holding three rows of a block a lane (blocks of 66 to
84 rows), kernel 3's pair ring spread over three ranks at 22 and 23 joints
and four (a cluster of five) at 24 and 25. Each ring rank's bytes member by
member, the ring's schedule at three rows a lane with its one-step shift,
the refusals past the new builds, the plain banded factor at blk 75 against
the JAX node-level factor, and the seeded 25-joint chain's plain float64
solve against the JAX fixture ``torch_port_chain25_b64.npz``
(``make_chain12_fixture.py --joints 25``), which ``chip_smoke.py`` phase 32
holds the card against."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu_torch.bench.convergence import chain
from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
from mpc_motion_planner_tpu_torch.kernels import constraints as k1
from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
from mpc_motion_planner_tpu_torch.kernels.build import SMEM_LIMIT, Geometry
from mpc_motion_planner_tpu_torch.ops.qp import QPSettings
from mpc_motion_planner_tpu_torch.ops.sqp import SQPSettings
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner
from test_torch_joints21 import _ring_faults, _struct, factor_matches_jax

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CHAIN25_FIXTURE = os.path.join(FIXTURES, "torch_port_chain25_b64.npz")

# the chains past 21 joints at 19 nodes: joints -> ring ranks, (rank 0, each
# ring rank) bytes, the bytes one rank 1 would need
WIDE = {22: (3, (178160, 209216), 488160), 23: (3, (191312, 228656), 533520),
        24: (4, (204320, 165976), 580896), 25: (4, (218352, 180088), 630288)}


@pytest.mark.parametrize("nq", range(1, 34))
def test_kernel1_reckoning_up_to_32_joints(nq):
    """Kernel 1's Jacobian launch at every joint count: a thread per
    (evaluation, joint) of 32 evaluations, so 32 nq threads and 32 joints
    at most (33 raise before any build, naming the 1,056 threads); the
    inputs, the J tile up to 23 joints and the g tile in dynamic shared
    memory; two blocks an SM up to 16 joints; 72 B of launch parameters
    at any joint count, the robot in device memory."""
    nin, ng = 3 * nq, nq + 1
    if nq > 32:
        with pytest.raises(ValueError, match=rf"kernel 1 at {nq} joints needs {32 * nq} threads "
                                             rf"a block .*; a block may have 1024"):
            k1.check_fits(nq)
        return
    k1.check_fits(nq)
    tiled = nq <= 23
    smem = 8 * 64 + 4 * 32 * nin + (4 * 32 * (ng * nin + 1) if tiled else 0) + 4 * 32 * (ng | 1)
    assert k1.reckoning(nq) == {
        "smem_bytes": smem, "blocks_bound": 2 if nq <= 16 else 1, "threads": 32 * nq,
        "j_tiled": int(tiled), "param_bytes": 72, "robot_bytes": 4 * (46 * nq + 6)}
    assert smem <= SMEM_LIMIT and k1.j_tiled(nq) == tiled
    if nq == 24:  # the J tile would take 243,456 B
        assert 8 * 64 + 4 * 32 * nin + 4 * 32 * (ng * nin + 1) + 4 * 32 * (ng | 1) == 243456
    assert f"-DMPC_NQ={nq}" in k1.KERNEL.flags(Geometry(nq=nq))


@pytest.mark.parametrize("nq", list(WIDE))
def test_wide_ring_ranks_member_by_member(nq):
    """The pair layout's cluster at 22 to 25 joints and 19 nodes, member by
    member: rank 0 the pair's (the deep block without its ring, its six
    staging buffers of a block), each ring rank whole slots of the ring of
    7, slot s in rank 1 + s % R (three slots a rank at R = 3, two at R =
    4); R the fewest whose share fits; a lane holds three rows of a block
    (blk 66 to 75, VPAD 68 to 76)."""
    ranks, (rank0, peer), one = WIDE[nq]
    g = Geometry(nq=nq)
    N, blk, nv, neq, nm = g.nodes, g.blk, g.num_var, g.num_eq, g.num_rows
    pad, threads = -(-blk // 4) * 4, k3.threads(g)
    assert (k3.rows(g), k3.vpad(g)) == (3, pad) and 64 < blk <= 96 and pad <= 96
    stage = -(-(blk * blk + 3) // 4) * 4
    members = [
        (1, 4), (3 + 16 + 6 * stage, 4),  # Ldi, Lsub: 7 barriers, progress, 6 buffers
        (N * blk, 4), (1, 4), (neq, 4),  # u, J, fseg
        *[(1, 4)] * 6, (nv, 4), *[(1, 4)] * 5,  # qs .. thx, D, rc .. thr
        *[(1, 4)] * 5,  # x, zx, yx, zc, yc
        (nv, 4), (nm, 4), (nv, 4),  # t0, wa, rhs
        (N * pad, 16), (N * pad, 16), (pad, 16),  # ys, xs, tb
        (2 * N * blk, 4),  # ahead
        (nv, 4), (nv, 4), (nm, 4), (nm, 4),  # xt, dx, wb, wc
        (threads // 32 * 4, 4), (16, 4), (1, 4), (1, 4), (1, 4),  # red, Dm, p, s, done
    ]
    slot = -(-(3 * blk * blk + 3) // 4) * 4 + stage
    per_rank = -(-7 // ranks)
    assert (k3.ring_runs(g, "pair"), k3.ring_slot(g, "pair")) == (7, slot)
    assert (k3.ring_ranks(g), k3.slots_per_rank(g)) == (ranks, per_rank)
    assert -(-_struct(members) // 16) * 16 == rank0
    assert 4 * per_rank * slot + 8 * per_rank + 8 == peer
    assert k3.rank_bytes(g) == (rank0, *[peer] * ranks)
    fewer = dataclasses.replace(g, ranks=ranks - 1)
    assert max(rank0, peer) <= SMEM_LIMIT < k3.rank_bytes(fewer)[1]
    assert k3.rank_bytes(dataclasses.replace(g, ranks=1)) == (rank0, one)
    assert k3.KERNEL.geometry(g).flags()[-3:] == ("-DMPC_SMEM_LAYOUT=7", "-DMPC_EPT=2",
                                                  f"-DMPC_RING_RANKS={ranks}")
    assert threads == 32 * -(-max(nv, nm) // 2 // 32)


@pytest.mark.parametrize("nq", list(WIDE))
def test_ring_schedule_three_rows_a_lane(nq, monkeypatch):
    """At three rows a lane the ring's schedule is the one-row schedule a
    step late, as at two (``LATE``): every block read and every copy after
    ``ring_start`` comes one step later; over three ranks (22, 23 joints)
    and four (24, 25) no read finds its copy unlanded or under 4 steps old
    and no copy overwrites an unread slot through three pairs of sweeps;
    each rank issues copies into its own slots alone, in every pair of
    sweeps."""
    g = Geometry(nq=nq)
    ranks = k3.ring_ranks(g)
    assert k3.rows(g) == 3 and ranks == WIDE[nq][0]
    bad, copies = _ring_faults(g, k3.ring_runs(g, "pair"))
    assert not bad, bad[:5]
    late_copies, late_reads = k3.ring_schedule(g, "pair", iterations=3)
    with monkeypatch.context() as m:
        m.setattr(k3, "rows", lambda g: 1)
        one_copies, one_reads = k3.ring_schedule(g, "pair", iterations=3)
    shift = lambda events: [(None if e[0] is None else e[0] + 1, *e[1:]) for e in events]
    assert late_copies == shift(one_copies)
    blocks = lambda reads: [r for r in reads if r[3] != "ldi"]
    assert blocks(late_reads) == shift(blocks(one_reads))
    N = g.nodes
    for r in range(1, ranks + 1):
        mine = [(n, s) for n, _, s in copies if 1 + s % ranks == r]
        assert all(s // ranks < k3.slots_per_rank(g) for _, s in mine)
        assert any(n is not None and 2 * N <= n < 4 * N for n, _ in mine)


def test_pair_ring_at_seven_nodes_copies_only_at_its_start():
    """At 7 nodes (28 joints x 2) the pair layout's ring of 7 slots holds
    every node from the start: the sweeps copy nothing (so a ring rank's
    copier does not wait for their steps, which would never come), every
    read finds its node in its slot and none is refused; at 10 nodes the
    sweeps copy again."""
    g = Geometry(2, 3, 28)
    assert (g.nodes, k3.ring_runs(g, "pair"), k3.ring_last(g, "pair")) == (7, 7, 6)
    copies, reads = k3.ring_schedule(g, "pair", iterations=3)
    assert [c for c in copies if c[0] is not None] == []
    assert sorted(m for _, m, _ in copies) == list(range(7)) and reads
    bad, _ = _ring_faults(g, 7)
    assert not bad, bad[:5]
    copies10, _ = k3.ring_schedule(Geometry(3, 3, 27), "pair", iterations=1)
    assert any(n is not None for n, _, _ in copies10)


# the first grids of order 3 past the slim layout at 22 to 25 joints:
# (segments, joints) -> nodes, rank 0's bytes (the largest block), ring ranks
PAST_WIDE = {(16, 22): (49, 242064, 3), (15, 23): (46, 243680, 3),
             (14, 24): (43, 243024, 4), (13, 25): (40, 242960, 4)}


@pytest.mark.parametrize("segments, nq", list(PAST_WIDE),
                         ids=[f"{q}_joints_{s}x3" for s, q in PAST_WIDE])
def test_first_grids_past_the_wide_builds_raise(segments, nq):
    """At 22 to 25 joints the first grid of order 3 that fits no layout
    raises before any build, naming rank 0 of the slim layout and each ring
    rank; one segment fewer plans in the slim layout with the ring spread,
    kernel 2's device ring fitting at both."""
    g = Geometry(segments=segments, nq=nq)
    nodes, rank0, ranks = PAST_WIDE[segments, nq]
    assert g.nodes == nodes and k3.choose_layout(g) == "slim" and k3.ring_ranks(g) == ranks
    assert k3.rank_bytes(g, "slim")[0] == rank0 == k3.smem_bytes(g) > SMEM_LIMIT
    ring = ", ".join(f"rank {i} {b} B" for i, b in enumerate(k3.rank_bytes(g, "slim")))
    with pytest.raises(ValueError) as err:
        k3.check_fits(g)
    assert (f"{nq} joints ({g.num_var} variables, {g.num_rows} rows) needs {rank0} B of shared "
            f"memory per block in its slim layout ({ring}; full: " in str(err.value))
    assert k3.KERNEL.geometry(dataclasses.replace(g, segments=segments - 1)).layout == "slim"
    fewer = dataclasses.replace(g, segments=segments - 1)
    k3.check_fits(fewer)
    k2.check_fits(fewer)
    k2.check_fits(g)
    assert k3.KERNEL.geometry(fewer).ranks == ranks and k2.choose_ring(g) == "device"


def test_widest_robots_and_their_refusals():
    """28 joints plan at 7 nodes (2 segments: kernel 3's pair layout, four
    ring ranks, rank 0 203,488 B; kernel 2's device ring 230,900 B), and so
    do 29 (kernel 2's scratch build, 157,004 B, where the device ring needs
    247,832 B); 26 joints at 19 nodes take kernel 3's slim layout (rank 0
    159,792 B, where the pair's needs 232,848 B, which a build that names the
    pair layout raises with, naming each ring rank's 194,776 B) and 28 there
    kernel 2's scratch build (154,292 B; the device ring's 238,964 B raise
    where named); 32 joints plan at 19 nodes (slim rank 0 216,704 B, seven
    ring ranks of 147,504 B, kernel 2 199,316 B) and raise at 22 nodes
    naming slim's rank 0, 233,584 B; kernel 2 takes up to 35 joints at one
    segment (225,652 B) and nothing past it on any grid; 26 joints plan at
    16 nodes and 27 at 13 in the pair layout, as before."""
    g28 = Geometry(2, 3, 28)
    k1.check_fits(28)
    k2.check_fits(g28)
    k3.check_fits(g28)
    assert (k2.smem_bytes(g28), k2.choose_ring(g28), k2.rows(g28)) == (230900, "device", 3)
    assert k3.rank_bytes(g28) == (203488, *[225880] * 4) and k3.choose_layout(g28) == "pair"
    g29 = Geometry(2, 3, 29)
    k3.check_fits(g29)
    assert (k2.smem_bytes(g29), k2.smem_bytes(g29, "device"), k2.choose_ring(g29)) == (
        157004, 247832, "scratch")
    with pytest.raises(ValueError, match=r"7 nodes, band width 3 and 29 joints needs 247832 B "
                                         r"of shared memory per block with its device ring"):
        k2.check_fits(dataclasses.replace(g29, ring="device"))
    for g in (Geometry(5, 3, 26), Geometry(4, 3, 27)):
        k2.check_fits(g)
        k3.check_fits(g)
        assert k3.choose_layout(g) == "pair"
    g26 = Geometry(6, 3, 26)
    k2.check_fits(g26)
    k3.check_fits(g26)
    assert (k3.choose_layout(g26), k3.rank_bytes(g26, "slim")[0]) == ("slim", 159792)
    with pytest.raises(ValueError, match=r"26 joints \(1483 variables, 1761 rows\) needs 232848 "
                                         r"B of shared memory per block in its pair layout \(rank "
                                         r"0 232848 B, rank 1 194776 B, rank 2 194776 B, rank 3 "
                                         r"194776 B, rank 4 194776 B"):
        k3.check_fits(dataclasses.replace(g26, layout="pair"))
    g28x6 = Geometry(6, 3, 28)
    k2.check_fits(g28x6)
    assert (k2.smem_bytes(g28x6), k2.choose_ring(g28x6)) == (154292, "scratch")
    with pytest.raises(ValueError, match=r"28 joints needs 238964 B of shared memory per block "
                                         r"with its device ring"):
        k2.check_fits(dataclasses.replace(g28x6, ring="device"))
    with pytest.raises(ValueError, match=r"28 joints .* needs 262464 B"):
        k3.check_fits(dataclasses.replace(g28x6, layout="pair"))
    g32 = Geometry(6, 3, 32)
    k1.check_fits(32)
    k2.check_fits(g32)
    k3.check_fits(g32)
    assert (k2.smem_bytes(g32), k3.rank_bytes(g32, "slim")) == (199316, (216704, *[147504] * 7))
    with pytest.raises(ValueError, match=r"22 nodes, order 3 and 32 joints .* needs 233584 B of "
                                         r"shared memory per block in its slim layout"):
        k3.check_fits(Geometry(7, 3, 32))
    k2.check_fits(Geometry(1, 3, 35))
    assert k2.smem_bytes(Geometry(1, 3, 35)) == 225652
    for nq in (36, 37, 40):
        with pytest.raises(ValueError, match=rf"{nq} joints needs \d+ B"):
            k2.check_fits(Geometry(1, 3, nq))


def test_kernel2_three_rows_reckoning():
    """Kernel 2 past 21 joints: three rows of a block a lane (ROWS = 3, the
    tmp row 96 floats), the device ring with two staged nodes, one problem
    an SM; ``per_sm`` follows the registers a thread would need (2 LKS + 3
    blk + 11, in units of 8: 352 at 22 joints, 392 at 25, past a thread's
    255) and stays 1; the bytes member by member."""
    for nq, smem in ((22, 150356), (23, 164072), (24, 177236), (25, 192104)):
        g = Geometry(nq=nq)
        blk = 3 * nq
        lks = -(-blk // 4) * 4
        floats = blk * lks + 7 * blk * blk
        assert k2.rows(g) == 3 and k2.forward_floats(g, "device") == floats
        assert k2.staged_nodes(g) == 2 and k2.choose_ring(g) == "device"
        assert 4 * (floats + 2 * 19 * blk + 96 + 4) + 4 == k2.smem_bytes(g) == smem
        regs = -(-(2 * lks + 3 * blk + 11) // 8) * 8
        assert regs == {22: 352, 23: 368, 24: 376, 25: 392}[nq] and k2.per_sm(g) == 1
        assert k2.KERNEL.flags(g)[-1] == "-DMPC_FACTOR_RING=1"


def test_factor_banded_blk75_matches_jax():
    """The plain kernel 2 at blk 75 (25 joints, three rows a lane on the
    card), band width 3, on a seeded 7-node band at float64, in its three
    statements (``factor_banded``, the shared ring's schedule, the device
    ring's with two staged nodes): the JAX node-level factor's Ldi, Lsub, u
    and s to 1e-9, the schedules bitwise alike, an indefinite problem
    flagged alone; the case of blk 75 beside
    ``test_torch_joints21.py``'s at blk 63."""
    factor_matches_jax(75, seed=75)


def _chain25_planner():
    """The seeded 25-joint chain as ``bench/convergence.py`` ``chain`` builds
    it, planned on the CPU at float64 in the fixture's configuration
    (structured QP, fixed rho, no KKT refinement, budgets 700/500), no floor
    for its tool."""
    model, limits, tool, _, _ = chain(25, 1, torch.float64, torch.device("cpu"))
    planner = MotionPlanner(
        model=model, limits=limits, tool_frame=tool, margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
        qp_settings=QPSettings(backend="structured", kkt_refine=0, rho_update_every=0,
                               ruiz_iters=2, rho=0.1, alpha=1.6, check_every=25, max_iter=700),
        sqp_settings=SQPSettings(qp_step_schedules="200,500;150,350"), device="cpu")
    planner.set_min_height(-10.0)
    return planner


def test_chain25_plain_solve_matches_the_jax_fixture():
    """The fixture holds the first 64 states of the seeded 25-joint chain
    (``chain(25, ...)`` at float32) and the JAX ``structured`` solve of them
    at 19 nodes (1426 variables, 1694 rows), with the JAX float32 solve's
    final times; the port's plain float64 solve of the first state matches
    its final time and iterates to rtol 1e-6, with the same qp_converged and
    qp_iterations, and lands in the target box."""
    fx = np.load(CHAIN25_FIXTURE)
    _, _, _, cur, tgt = chain(25, 64, torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(fx["current"], cur.numpy())
    np.testing.assert_array_equal(fx["target"], tgt.numpy())
    assert fx["z"].shape == (64, 1426) and fx["final_time_float32"].shape == (64,)
    planner = _chain25_planner()
    ocp = planner.ocp
    assert (ocp.nq, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (25, 1426, 1694)
    n = 1
    cur, tgt = (torch.as_tensor(fx[k][:n].astype(np.float64)) for k in ("current", "target"))
    sol = planner.solve(cur, tgt)
    np.testing.assert_allclose(sol.final_time.numpy(), fx["final_time"][:n], rtol=1e-6)
    np.testing.assert_allclose(sol.z.numpy(), fx["z"][:n], rtol=1e-6, atol=1e-6)
    assert sol.qp_converged.tolist() == fx["qp_converged"][:n].tolist()
    np.testing.assert_array_equal(sol.qp_iterations.numpy(), fx["qp_iterations"][:n])
    err = (sol.x_at(1.0) - tgt).abs().amax(-1)
    assert bool((err <= planner.target_eps + planner.qp_settings.eps_abs).all())
