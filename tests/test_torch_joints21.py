"""PyTorch port, every joint count up to 21 at the headline's 19 nodes
(the sweep of joint counts runs on to 32, test_torch_joints25.py and
test_torch_joints32.py the rest): kernel 3's pair layout with its ring spread over ranks
1..R of a cluster of 1 + R blocks, whole slots a rank, where one rank 1
cannot hold the ring (16 to 21 joints); kernel 2's ring of the last bw
nodes' blocks read back from device memory where its shared ring does not
fit (20 and 21 joints); kernel 3's block taking the warps its sweeps need
where its elements fill fewer (one joint). Each rank's bytes member by
member, the layouts, ranks and flags every geometry takes (those that
planned before keep theirs), the ring's schedule over several ranks, the
refusals past it, kernel 2's reckoning and its plain schedule at blk 63
against the JAX node-level factor, and the seeded 21-joint chain's plain
float64 solve against the JAX fixture ``torch_port_chain21_b64.npz``
(``make_chain12_fixture.py --joints 21``), which ``chip_smoke.py`` phase 31
holds the card against."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu.ops import qp_structured as jqs
from mpc_motion_planner_tpu_torch.bench.convergence import chain
from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
from mpc_motion_planner_tpu_torch.kernels import constraints as k1
from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
from mpc_motion_planner_tpu_torch.kernels.build import LAYOUTS, SMEM_LIMIT, Geometry
from mpc_motion_planner_tpu_torch.ops import qp_structured as tqs
from mpc_motion_planner_tpu_torch.ops.qp import QPSettings
from mpc_motion_planner_tpu_torch.ops.sqp import SQPSettings
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CHAIN21_FIXTURE = os.path.join(FIXTURES, "torch_port_chain21_b64.npz")

# the chains whose pair ring is spread, at 19 nodes: joints -> ring ranks,
# (rank 0, each ring rank) bytes, the bytes one rank 1 would need
SPREAD = {16: (2, (108768, 147624), 258336), 19: (2, (141808, 208104), 364176),
          20: (2, (153088, 230568), 403488), 21: (3, (165392, 190640), 444816)}


def _struct(members):
    off = 0
    for floats, align in members:
        off = -(-off // align) * align + 4 * floats
    return off


@pytest.mark.parametrize("nq", range(1, 33))
def test_every_joint_count_plans_at_19_nodes(nq):
    """Kernels 1, 2 and 3 take every joint count from 1 to 32 at the
    headline's 19 nodes: kernel 3 in the first layout whose block fits, its
    pair ring spread over two ranks from 16 joints, three at 21 to 23 and
    four (a cluster of five) at 24 to 28, the slim layout from 26 and seven
    ring ranks (a cluster of eight) from 29; kernel 2 with its ring in shared
    memory up to 19 joints, read back from device memory from 20 and in its
    scratch build from 28; at one joint kernel 3's elements fill three warps
    and its block takes the five its sweeps need; past 21 joints a lane of
    kernels 2 and 3 holds three rows of a block."""
    g = Geometry(nq=nq)
    k1.check_fits(nq)
    k2.check_fits(g)
    k3.check_fits(g)
    built = k3.KERNEL.geometry(g)
    layout = ("full" if nq <= 7 else "compact" if nq == 8 else "split" if nq <= 10
              else "stream" if nq == 11 else "lean" if nq <= 13 else "far" if nq <= 15
              else "pair" if nq <= 25 else "slim")
    ranks = 1 if nq < 16 else 2 if nq <= 20 else 3 if nq <= 23 else 4 if nq <= 28 else 7
    assert built.layout == layout == k3.choose_layout(g)
    assert built.ranks == (None if nq < 16 else ranks)
    assert k3.ring_ranks(g) == ranks
    assert k3.rows(g) == k2.rows(g) == (1 if nq <= 10 else 2 if nq <= 21 else 3)
    assert k2.choose_ring(g) == ("scratch" if nq >= 28 else "device" if nq >= 20 else "shared")
    assert max(k3.rank_bytes(g, layout) if layout in k3.PAIRED else (k3.smem_bytes(g),)) <= \
        SMEM_LIMIT
    assert k3.threads(g) == (160 if nq == 1 else -(-max(g.num_var, g.num_rows)
                                                   // k3.ept_of(g) // 32) * 32)


@pytest.mark.parametrize("nq", list(SPREAD))
def test_spread_ring_ranks_member_by_member(nq):
    """The pair layout's cluster past 15 joints at 19 nodes, member by
    member: rank 0 is the pair's (the deep block without its ring: up to 3
    floats to a 16-byte boundary, a barrier per slot of the ring of bw + 4 =
    7 and the progress count to a 16-byte boundary, six staging buffers of
    a block), and each ring rank holds whole slots of the ring, slot s in
    rank 1 + s % R at index s / R (4 slots a rank at R = 2, 3 at R = 3), each
    slot a node's run of three blocks and its Ldi block from their 16-byte
    boundaries, a barrier per slot, the progress count and the stop flag.
    R is the fewest whose share fits: a rank fewer does not fit, and one
    rank 1 would need the bytes the pair layout names where it refuses."""
    ranks, (rank0, peer), one = SPREAD[nq]
    g = Geometry(nq=nq)
    N, blk, nv, neq, nm = g.nodes, g.blk, g.num_var, g.num_eq, g.num_rows
    pad, threads = -(-blk // 4) * 4, k3.threads(g)
    stage = -(-(blk * blk + 3) // 4) * 4  # a block from its 16-byte boundary
    members = [
        (1, 4),  # Ldi: in the ring
        (3 + 16 + 6 * stage, 4),  # Lsub: 7 barriers and the progress count, 6 buffers
        (N * blk, 4), (1, 4), (neq, 4),  # u, J, fseg
        *[(1, 4)] * 6, (nv, 4), *[(1, 4)] * 5,  # qs .. thx, D, rc .. thr
        *[(1, 4)] * 5,  # x, zx, yx, zc, yc
        (nv, 4), (nm, 4), (nv, 4),  # t0, wa, rhs
        (N * pad, 16), (N * pad, 16), (pad, 16),  # ys, xs, tb
        (2 * N * blk, 4),  # ahead
        (nv, 4), (nv, 4), (nm, 4), (nm, 4),  # xt, dx, wb, wc
        (threads // 32 * 4, 4), (16, 4), (1, 4), (1, 4), (1, 4),  # red, Dm, p, s, done
    ]
    slot = -(-(3 * blk * blk + 3) // 4) * 4 + stage  # a run and an Ldi block
    per_rank = -(-7 // ranks)
    assert (k3.ring_runs(g, "pair"), k3.ring_slot(g, "pair")) == (7, slot)
    assert (k3.ring_ranks(g), k3.slots_per_rank(g)) == (ranks, per_rank)
    assert -(-_struct(members) // 16) * 16 == rank0
    assert 4 * per_rank * slot + 8 * per_rank + 8 == peer
    assert k3.rank_bytes(g) == (rank0, *[peer] * ranks)
    assert k3.smem_bytes(g) == k3.smem_bytes(g, "pair") == max(rank0, peer) <= SMEM_LIMIT
    fewer = dataclasses.replace(g, ranks=ranks - 1)
    assert k3.rank_bytes(fewer)[1] > SMEM_LIMIT
    assert k3.rank_bytes(dataclasses.replace(g, ranks=1)) == (rank0, one)
    built = k3.KERNEL.geometry(g)
    assert built.flags()[-3:] == ("-DMPC_SMEM_LAYOUT=7", "-DMPC_EPT=2",
                                  f"-DMPC_RING_RANKS={ranks}")
    assert f"_pair_e2_r{ranks}_" in k3.KERNEL.library_path(g).name
    # the slots, whole slots a rank: each in exactly one ring rank
    owners = [1 + s % ranks for s in range(7)]
    assert all(owners.count(r) <= per_rank for r in range(1, ranks + 1))
    assert set(owners) == set(range(1, ranks + 1))


def _all_geometries():
    """Every geometry of orders 2-5 and 1-21 joints up to the first that fits
    no layout."""
    for order in (2, 3, 4, 5):
        for nq in range(1, 22):
            for segments in range(1, 140):
                g = Geometry(segments=segments, order=order, nq=nq)
                yield g
                if not any(k3.smem_bytes(g, name) <= SMEM_LIMIT for name in LAYOUTS):
                    break


def test_builds_that_planned_before_keep_their_flags():
    """At every geometry of orders 2-5 and 1-21 joints up to the first that
    fits no layout: kernel 3 takes the first layout whose block fits with
    one ring rank where one does (as before the ring was spread: the same
    layout, ept and flags, no -DMPC_RING_RANKS), and the pair layout with the
    fewest ring ranks that fit where none does; kernel 2 builds with no new
    flag wherever its shared ring fits. The spread ring adds geometries at
    order 2 from 19 joints, order 3 from 16, order 4 from 13 and order 5
    from 11."""
    spread = set()
    for g in _all_geometries():
        one = [k3.smem_bytes(dataclasses.replace(g, ranks=1), name) <= SMEM_LIMIT
               for name in LAYOUTS]
        built = k3.KERNEL.geometry(g)
        if any(one):
            assert built.layout == LAYOUTS[one.index(True)] and built.ranks is None, g
            assert not any(f.startswith("-DMPC_RING_RANKS") for f in k3.KERNEL.flags(g))
        elif k3.smem_bytes(g, "pair") <= SMEM_LIMIT:
            assert (built.layout, built.ranks) == ("pair", k3.ring_ranks(g)) and built.ranks > 1
            assert all(b > SMEM_LIMIT for b in (
                k3.rank_bytes(dataclasses.replace(g, ranks=built.ranks - 1))[1],))
            spread.add((g.order, g.nq))
        if k2.smem_bytes(g, "shared") <= SMEM_LIMIT:
            assert k2.choose_ring(g) == "shared" and "-DMPC_FACTOR_RING=1" not in k2.KERNEL.flags(g)
            assert k2.KERNEL.geometry(g).ring is None
    assert {(3, nq) for nq in range(16, 22)} <= spread and (4, 14) in spread
    assert {o: min(q for oo, q in spread if oo == o) for o in (2, 3, 4, 5)} == {
        2: 19, 3: 16, 4: 13, 5: 11}


def _ring_faults(g, ring):
    """Every fault of the pair layout's ring at ``g`` with ``ring`` slots,
    modelled through three pairs of sweeps (``ring_schedule``) as
    tests/test_torch_geometry.py models it: a read that does not find its
    node's run in its slot, copied at least LEAD steps before after as many
    copies into that slot as ``ring_copy_count`` says; a copy that
    overwrites a run before it is read."""
    copies, reads = k3.ring_schedule(g, "pair", iterations=3)
    events = sorted([(-1 if n is None else n, 1, m, s, None) for n, m, s in copies]
                    + [(n, 0, m, s, who) for n, m, s, _, who in reads],
                    key=lambda e: e[:2])  # a step's reads come before its copies
    slots, copied, bad, N = {}, {}, [], g.nodes
    for n, is_copy, m, s, who in events:
        assert s == m % ring
        held = slots.get(s)
        if is_copy:
            if held is not None and held[2] == 0:
                bad.append(f"step {n}: node {m}'s copy overwrites node {held[0]}, unread")
            slots[s] = [m, n, 0]
            copied[s] = copied.get(s, 0) + 1
        elif held is None or held[0] != m:
            bad.append(f"step {n}: {who} reads node {m}, slot {s} holds {held}")
        elif held[1] >= 0 and n - held[1] < k3.lead("pair"):
            bad.append(f"step {n}: {who} reads node {m}, copied at step {held[1]}")
        elif copied[s] != k3.ring_copy_count(g, "pair", m, n // N // 2, n // N % 2 == 0):
            bad.append(f"step {n}: {who} reads node {m} after {copied[s]} copies")
        else:
            held[2] += 1
    return bad, copies


@pytest.mark.parametrize("nq", list(SPREAD))
def test_ring_schedule_spread_over_ranks(nq):
    """The ring spread over R ranks is the pair's ring, step by step (each
    ring rank's copier and relay follow the same progress count as one rank
    1 does, two hops from rank 0's readers: the lead stays 4): at R = 2 (16,
    19, 20 joints) and R = 3 (21) no read finds its copy unlanded or under
    LEAD steps old, and no copy overwrites an unread slot, through three
    pairs of sweeps; the copies each rank issues are those into its own
    slots, and every rank issues copies in each pair of sweeps."""
    g = Geometry(nq=nq)
    ranks = k3.ring_ranks(g)
    assert ranks == SPREAD[nq][0] and k3.lead("pair") == 4
    bad, copies = _ring_faults(g, k3.ring_runs(g, "pair"))
    assert not bad, bad[:5]
    N = g.nodes
    for r in range(1, ranks + 1):
        mine = [(n, m, s) for n, m, s in copies if 1 + s % ranks == r]
        assert all(s // ranks < k3.slots_per_rank(g) for _, _, s in mine)
        assert any(n is not None and 2 * N <= n < 4 * N for n, _, _ in mine)


# the first grids past the slim layout, its ring spread: (segments, joints)
# -> nodes, rank 0's bytes (the largest block), the ring ranks
PAST_SPREAD = {(24, 16): (73, 232784, 2), (23, 17): (70, 240688, 2),
               (21, 18): (64, 238192, 2), (19, 19): (58, 233792, 2),
               (18, 20): (55, 236192, 2), (17, 21): (52, 239568, 3)}


@pytest.mark.parametrize("segments, nq", list(PAST_SPREAD),
                         ids=[f"{q}_joints_{s}x3" for s, q in PAST_SPREAD])
def test_first_grids_past_the_spread_ring_raise(segments, nq):
    """Past 15 joints the first grid of order 3 that fits no layout raises
    before any build, naming the slim layout's rank 0 (the largest block)
    and each ring rank; one segment fewer plans in the slim layout with the
    ring spread."""
    g = Geometry(segments=segments, nq=nq)
    nodes, rank0, ranks = PAST_SPREAD[segments, nq]
    assert g.nodes == nodes and k3.choose_layout(g) == "slim" and k3.ring_ranks(g) == ranks
    assert k3.rank_bytes(g, "slim")[0] == rank0 == k3.smem_bytes(g) > SMEM_LIMIT
    ring = ", ".join(f"rank {i} {b} B" for i, b in enumerate(k3.rank_bytes(g, "slim")))
    with pytest.raises(ValueError) as err:
        k3.check_fits(g)
    assert (f"{nq} joints ({g.num_var} variables, {g.num_rows} rows) needs {rank0} B of shared "
            f"memory per block in its slim layout ({ring}; full: " in str(err.value))
    fewer = dataclasses.replace(g, segments=segments - 1)
    k3.check_fits(fewer)
    assert (k3.KERNEL.geometry(fewer).layout, k3.KERNEL.geometry(fewer).ranks) == ("slim", ranks)


def test_kernel2_device_ring_reckoning():
    """Kernel 2 with the device ring: the forward loop's blocks without the
    ring (LkT, S[2], C[bw + 1], Linv: 31,815 floats at 21 joints) and as
    many staged nodes of the backward sweep as they leave room for, two at
    14 to 21 joints (the shared ring stages four): 137,112 B at 21 joints,
    124,596 B at 20, one problem per SM; taken only where the shared ring
    does not fit; its flag and library name; a forced device ring where the
    shared one fits (14 and 19 joints, held bitwise on the card) and a
    forced shared ring that does not fit raising with the other rings'
    bytes."""
    for nq, (floats, smem, shared) in {20: (28800, 124596, 254196),
                                      21: (31815, 137112, 279996)}.items():
        g = Geometry(nq=nq)
        blk = 3 * nq
        lks = -(-blk // 4) * 4
        assert k2.forward_floats(g, "device") == blk * lks + 7 * blk * blk == floats
        assert k2.staged_nodes(g) == 2 and k2.staged_nodes(g, "shared") == k2.CH == 4
        assert 4 * (floats + 2 * 19 * blk + 64 + 4) + 4 == k2.smem_bytes(g) == smem
        assert k2.smem_bytes(g, "shared") == shared and k2.per_sm(g) == 1
        built = k2.KERNEL.geometry(g)
        assert (built.ring, built.layout, built.ept, built.ranks) == ("device", None, None, None)
        assert k2.KERNEL.flags(g)[-1] == "-DMPC_FACTOR_RING=1"
        assert "_dring_" in k2.KERNEL.library_path(g).name
        with pytest.raises(ValueError, match=rf"{nq} joints needs {shared} B of shared memory "
                                             rf"per block with its shared ring \(device ring: "
                                             rf"{smem} B, scratch ring: \d+ B\)"):
            k2.check_fits(dataclasses.replace(g, ring="shared"))
    for nq, smem in ((14, 63444), (19, 113592)):
        g = Geometry(nq=nq, ring="device")
        k2.check_fits(g)
        assert k2.smem_bytes(g) == smem and k2.staged_nodes(g) == 2
        assert k2.KERNEL.geometry(g).ring == "device"
        assert k2.KERNEL.library_path(g) != k2.KERNEL.library_path(Geometry(nq=nq))
    # kernel 3 ignores kernel 2's ring
    assert k3.KERNEL.library_path(Geometry(nq=21, ring="device")) == \
        k3.KERNEL.library_path(Geometry(nq=21))


def _band(N, bw, blk, n, seed):
    """A seeded block-banded SPD matrix L L' (unit-dominant diagonal blocks)
    in band storage (n, N, bw + 1, blk, blk), an arrow column and corner."""
    rng = np.random.default_rng(seed)
    L = np.zeros((n, N * blk, N * blk))
    for k in range(N):
        for d in range(min(bw, N - 1 - k) + 1):
            b = rng.uniform(-0.2, 0.2, (n, blk, blk))
            if d == 0:
                b = np.tril(b, -1) + 1.5 * np.eye(blk)
            L[:, (k + d) * blk:(k + d + 1) * blk, k * blk:(k + 1) * blk] = b
    M = L @ L.transpose(0, 2, 1)
    Mband = np.zeros((n, N, bw + 1, blk, blk))
    for k in range(N):
        for d in range(min(bw, N - 1 - k) + 1):
            Mband[:, k, d] = M[:, (k + d) * blk:(k + d + 1) * blk, k * blk:(k + 1) * blk]
    return Mband, rng.standard_normal((n, N, blk)), np.full(n, 1e4)


def test_factor_banded_blk63_matches_jax():
    """The plain kernel 2 at blk 63 (21 joints), band width 3, on a seeded
    7-node band at float64, in its three statements: ``factor_banded``, the
    shared ring's schedule and the device ring's with two staged nodes
    (``factor_banded_ring``): the JAX node-level factor's Ldi, Lsub, u and s
    to 1e-9; the two schedules give the same factors, bitwise (float32 too);
    a problem with an indefinite first block is flagged alone."""
    factor_matches_jax(63, seed=63)


def factor_matches_jax(blk, seed):
    """The check of ``test_factor_banded_blk63_matches_jax`` at block size
    ``blk`` on a band drawn from ``seed``."""
    Mband, pc, mpp = _band(7, 3, blk, 3, seed=seed)
    Mband[1, 0, 0, 0, 0] = -1.0
    ref = {k: np.asarray(v) for k, v in
           jqs.factor_banded(*(jnp.asarray(a) for a in (Mband, pc, mpp)), 3).items()}
    good = [0, 2]
    args = [torch.as_tensor(a) for a in (Mband, pc, mpp)]
    outs = [tqs.factor_banded(*args, 3), tqs.factor_banded_ring(*args, 3),
            tqs.factor_banded_ring(*args, 3, ring="device", staged=2)]
    for got in outs:
        assert got["ok"].tolist() == [True, False, True]
        for k in ("Ldi", "Lsub", "u", "s"):
            np.testing.assert_allclose(got[k][good].numpy(), ref[k][good], rtol=1e-9, atol=1e-9)
    for k in ("Ldi", "Lsub", "u", "s", "ok"):
        assert torch.equal(outs[1][k], outs[2][k])
    f32 = [a.float() for a in args]
    a, b = tqs.factor_banded_ring(*f32, 3), tqs.factor_banded_ring(*f32, 3, "device", 1)
    assert all(torch.equal(a[k], b[k]) for k in a)


def _chain21_planner():
    """The seeded 21-joint chain as ``bench/convergence.py`` ``chain`` builds
    it, planned on the CPU at float64 in the fixture's configuration
    (structured QP, fixed rho, no KKT refinement, budgets 700/500), no floor
    for its tool."""
    model, limits, tool, _, _ = chain(21, 1, torch.float64, torch.device("cpu"))
    planner = MotionPlanner(
        model=model, limits=limits, tool_frame=tool, margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
        qp_settings=QPSettings(backend="structured", kkt_refine=0, rho_update_every=0,
                               ruiz_iters=2, rho=0.1, alpha=1.6, check_every=25, max_iter=700),
        sqp_settings=SQPSettings(qp_step_schedules="200,500;150,350"), device="cpu")
    planner.set_min_height(-10.0)
    return planner


def test_chain21_plain_solve_matches_the_jax_fixture():
    """The fixture holds the first 64 states of the seeded 21-joint chain
    (``chain(21, ...)`` at float32) and the JAX ``structured`` solve of them
    at 19 nodes (1198 variables, 1426 rows; none of its QPs converges within
    the budgets), with the JAX float32 solve's final times (64/64 within
    1e-3 of the float64 solve's); the port's plain float64 solve of the
    first state matches its final time and iterates to rtol 1e-6, with the
    same qp_converged and qp_iterations, and lands in the target box."""
    fx = np.load(CHAIN21_FIXTURE)
    _, _, _, cur, tgt = chain(21, 64, torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(fx["current"], cur.numpy())
    np.testing.assert_array_equal(fx["target"], tgt.numpy())
    assert fx["z"].shape == (64, 1198) and fx["final_time_float32"].shape == (64,)
    tf32, tf = fx["final_time_float32"].astype(np.float64), fx["final_time"]
    assert int((np.abs(tf32 - tf) <= 1e-3 * np.abs(tf)).sum()) == 64
    planner = _chain21_planner()
    ocp = planner.ocp
    assert (ocp.nq, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (21, 1198, 1426)
    n = 1
    cur, tgt = (torch.as_tensor(fx[k][:n].astype(np.float64)) for k in ("current", "target"))
    sol = planner.solve(cur, tgt)
    np.testing.assert_allclose(sol.final_time.numpy(), fx["final_time"][:n], rtol=1e-6)
    np.testing.assert_allclose(sol.z.numpy(), fx["z"][:n], rtol=1e-6, atol=1e-6)
    assert sol.qp_converged.tolist() == fx["qp_converged"][:n].tolist()
    np.testing.assert_array_equal(sol.qp_iterations.numpy(), fx["qp_iterations"][:n])
    err = (sol.x_at(1.0) - tgt).abs().amax(-1)
    assert bool((err <= planner.target_eps + planner.qp_settings.eps_abs).all())


def test_chains_below_seven_joints_take_the_pandas_first_limits():
    """``bench/convergence.py`` ``chain`` of fewer than 7 joints takes the
    Panda's limits of its first joints (past 7 it repeats the last joint's),
    so the 1-joint chain of chip_smoke.py phase 31 plans."""
    _, limits, tool, cur, tgt = chain(1, 4, torch.float32, torch.device("cpu"))
    _, l7, _, _, _ = chain(7, 1, torch.float32, torch.device("cpu"))
    assert tool == "tool" and cur.shape == tgt.shape == (4, 2)
    assert torch.equal(limits.max_torque, l7.max_torque[:1])
    assert torch.equal(limits.max_position, l7.max_position[:1])
