"""PyTorch port, 26 to 32 joints at the headline's 19 nodes: kernel 3's slim
layout (the pair layout with rank 0's staging buffers cut to those in use at
one time) where the pair layout's rank 0 does not fit, and kernel 2's
scratch build (the inverse of L[k,k] and C[d >= 2] of its forward loop in
Ldi in device memory) where its device ring does not fit. Each rank's bytes
member by member, the layouts and rings every geometry takes (those that
planned before keep theirs), the staging buffers' and the ring's schedules,
the refusals past the new builds, the plain banded factor at blk 96 against
the JAX node-level factor, and the seeded 32-joint chain's plain float64
solve against the JAX fixture ``torch_port_chain32_b64.npz``
(``make_chain12_fixture.py --joints 32``), which ``chip_smoke.py`` phase 33
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
from mpc_motion_planner_tpu_torch.kernels.build import LAYOUTS, RINGS, SMEM_LIMIT, Geometry
from mpc_motion_planner_tpu_torch.ops.qp import QPSettings
from mpc_motion_planner_tpu_torch.ops.sqp import SQPSettings
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner
from test_torch_joints21 import _ring_faults, _struct, factor_matches_jax
from test_torch_joints25 import WIDE
from test_torch_pair import PAIR_GEOMETRIES

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CHAIN32_FIXTURE = os.path.join(FIXTURES, "torch_port_chain32_b64.npz")

# the chains past 25 joints at 19 nodes: joints -> ring ranks, (rank 0, each
# ring rank) bytes of the slim layout, the pair layout's rank 0
SLIM = {26: (4, (159792, 194776), 232848), 27: (4, (168960, 210040), 247728),
        28: (4, (177744, 225880), 262464), 29: (7, (187360, 121152), 278224),
        30: (7, (197200, 129648), 294448), 31: (7, (207056, 138432), 310880),
        32: (7, (216704, 147504), 327344)}

# the first grids that the pair layout refused before the slim layout
# (ROADMAP Queue 2): (segments, order, joints) -> the slim layout's (rank 0,
# each ring rank), its ring ranks, the pair's rank 0
OLD_REFUSALS = {(59, 3, 7): ((231680, 49680), 1, 235232),
                (42, 4, 7): ((233184, 70856), 1, 236736),
                (26, 3, 14): ((216864, 197856), 1, 238080),
                (8, 3, 25): ((177088, 180088), 4, 244624)}


def _rank0_members(g, buffers):
    """Rank 0 of the pair or slim layout (struct Smem), member by member:
    the deep block without its ring, with up to 3 floats to a 16-byte
    boundary, a barrier per slot of the ring of bw + 4 and the progress
    count to a 16-byte boundary, then ``buffers`` staging buffers of a block
    from its 16-byte boundary."""
    N, blk, nv, neq, nm, bw = g.nodes, g.blk, g.num_var, g.num_eq, g.num_rows, g.order
    pad, stage = -(-blk // 4) * 4, -(-(blk * blk + 3) // 4) * 4
    head = -(-(2 * (bw + 4) + 1) // 4) * 4
    return [
        (1, 4), (3 + head + buffers * stage, 4),  # Ldi: in the ring; Lsub
        (N * blk, 4), (1, 4), (neq, 4),  # u, J, fseg
        *[(1, 4)] * 6, (nv, 4), *[(1, 4)] * 5,  # qs .. thx, D, rc .. thr
        *[(1, 4)] * 5,  # x, zx, yx, zc, yc
        (nv, 4), (nm, 4), (nv, 4),  # t0, wa, rhs
        (N * pad, 16), (N * pad, 16), (pad, 16),  # ys, xs, tb
        ((bw - 1) * N * blk, 4),  # ahead
        (nv, 4), (nv, 4), (nm, 4), (nm, 4),  # xt, dx, wb, wc
        (k3.threads(g, "slim") // 32 * 4, 4), ((bw + 1) ** 2, 4), (1, 4), (1, 4), (1, 4),
    ]


def _peer(g, ranks):
    """A ring rank (struct Peer): whole slots of the ring of bw + 4, each a
    node's run of bw blocks and its Ldi block from their 16-byte boundaries,
    a barrier per slot, the progress count and the stop flag."""
    blk2, bw = g.blk ** 2, g.order
    slot = -(-(bw * blk2 + 3) // 4) * 4 + -(-(blk2 + 3) // 4) * 4
    per_rank = -(-(bw + 4) // ranks)
    return 4 * per_rank * slot + 8 * per_rank + 8


def _stage_schedule(g, layout="pair"):
    """A model of rank 0's staging buffers in the pair or slim layout
    through one sweep (csrc/structured_admm.cu ``stage_block``,
    ``chain_buf``, ``helper_buf``): (window, warp, buffer) of each block a
    warp stages, window n the span between the sweeps' barriers of steps n -
    1 and n. Chain warp t % 2 takes step t: past one row a lane it stages
    the step's L block (from step 1) and Ldi block at its turn, in window t;
    at one row a lane it fetches them a turn ahead, in window t - 1 (steps 0
    and 1 both in window 0). The helper of distance d (warp d) stages its
    block of step t in window t, or past one row a lane in window t + 1."""
    late = k3.rows(g) > 1
    chain = 4 if layout == "pair" else 1 if late else 2
    events = []
    for t in range(g.nodes):
        w = t % 2
        for ldi in ((False, True) if t >= 1 else (True,)):
            buf = 2 * w + ldi if layout == "pair" else 0 if late else w
            events.append((t if late else max(t - 1, 0), w, buf))
        for d in range(2, g.order + 1):
            if t + d < g.nodes:
                events.append((t + late, d, chain + d - 2))
    return events


@pytest.mark.parametrize("nq", list(SLIM))
def test_slim_ranks_member_by_member(nq):
    """The slim layout's cluster at 26 to 32 joints and 19 nodes, member by
    member: rank 0 the pair's with three staging buffers of a block (a lane
    holds three rows of a block: one buffer for both chain warps, whose
    turns the sweeps' barrier keeps apart, and one for each helper) in place
    of six; each ring rank the pair's, whole slots of the ring of 7, the
    fewest ranks whose share fits (four, a cluster of five, up to 28 joints,
    seven, a cluster of eight, from 29). The pair layout's rank 0 does not
    fit, and the slim layout is what the geometry takes, with its flags and
    library."""
    ranks, (rank0, peer), pair0 = SLIM[nq]
    g = Geometry(nq=nq)
    assert (k3.rows(g), k3.stage_buffers(g, "slim"), k3.stage_buffers(g)) == (3, 3, 6)
    assert -(-_struct(_rank0_members(g, 3)) // 16) * 16 == rank0
    assert -(-_struct(_rank0_members(g, 6)) // 16) * 16 == pair0 == k3.rank_bytes(g)[0]
    assert _peer(g, ranks) == peer and (k3.ring_ranks(g), k3.slots_per_rank(g)) == (
        ranks, -(-7 // ranks))
    assert k3.rank_bytes(g, "slim") == (rank0, *[peer] * ranks)
    assert k3.smem_bytes(g) == k3.smem_bytes(g, "slim") == max(rank0, peer) <= SMEM_LIMIT
    assert pair0 > SMEM_LIMIT and k3.choose_layout(g) == "slim"
    assert _peer(g, ranks - 1) > SMEM_LIMIT
    built = k3.KERNEL.geometry(g)
    assert (built.layout, built.ranks, built.ept) == ("slim", ranks, k3.ept_of(g))
    assert built.flags()[-3:] == ("-DMPC_SMEM_LAYOUT=8", f"-DMPC_EPT={built.ept}",
                                  f"-DMPC_RING_RANKS={ranks}")
    assert f"_slim_e{built.ept}_r{ranks}_" in k3.KERNEL.library_path(g).name
    assert k3.threads(g) == k3.threads(g, "pair") <= 1024
    k3.check_fits(g)


@pytest.mark.parametrize("segments, order, nq", list(OLD_REFUSALS),
                         ids=[f"{q}_joints_{s}x{o}" for s, o, q in OLD_REFUSALS])
def test_slim_at_the_pairs_first_refusals(segments, order, nq):
    """At the first grids the pair layout refused (the Panda at 59 x 3 and
    order 4 x 42, 14 joints x 26, 25 joints x 8), rank 0 of the slim layout
    member by member: four staging buffers at one row a lane (a chain warp's
    two blocks in one, each helper's), three past it; 59 x 3, 14 x 26 and 25
    x 8 plan in it, order 4 x 42 does not (its five buffers at bw = 4)."""
    (rank0, peer), ranks, pair0 = OLD_REFUSALS[segments, order, nq]
    g = Geometry(segments=segments, order=order, nq=nq)
    buffers = (2 if k3.rows(g) == 1 else 1) + order - 1
    assert k3.stage_buffers(g, "slim") == buffers and k3.stage_buffers(g) == 4 + order - 1
    assert -(-_struct(_rank0_members(g, buffers)) // 16) * 16 == rank0
    assert k3.rank_bytes(g, "slim") == (rank0, *[peer] * ranks) and _peer(g, ranks) == peer
    assert k3.rank_bytes(g, "pair")[0] == pair0 > SMEM_LIMIT
    assert k3.choose_layout(g) == "slim"
    if rank0 <= SMEM_LIMIT:
        k3.check_fits(g)
        assert k3.KERNEL.geometry(g).ranks == (ranks if ranks > 1 else None)
    else:
        with pytest.raises(ValueError, match=rf"needs {rank0} B of shared memory per block in "
                                             rf"its slim layout"):
            k3.check_fits(g)


@pytest.mark.parametrize("g", [Geometry(nq=nq) for nq in WIDE]
                         + [Geometry(*key) for key in PAIR_GEOMETRIES],
                         ids=[f"{nq}_joints" for nq in WIDE]
                         + [f"{q}_joints_{s}x{o}" for s, o, q in PAIR_GEOMETRIES])
def test_pair_geometries_keep_their_build(g):
    """Every geometry that took the pair layout before the slim one existed
    (22 to 25 joints at 19 nodes, and the seven the deep layout refused)
    keeps it, with its ring ranks, flags and library name; its slim build,
    which a geometry may name to hold the two against each other, is another
    library, whose rank 0 is smaller and whose ring ranks are the pair's."""
    built = k3.KERNEL.geometry(g)
    ranks = k3.ring_ranks(g)
    assert k3.choose_layout(g) == built.layout == "pair"
    assert built.ranks == (ranks if ranks > 1 else None)
    assert "-DMPC_SMEM_LAYOUT=7" in built.flags()
    assert "_pair_" in k3.KERNEL.library_path(g).name
    slim = k3.KERNEL.geometry(dataclasses.replace(g, layout="slim"))
    assert (slim.layout, slim.ranks, slim.ept) == ("slim", built.ranks, built.ept)
    assert k3.KERNEL.library_path(slim) != k3.KERNEL.library_path(g)
    assert k3.rank_bytes(g, "slim")[0] < k3.rank_bytes(g)[0] <= SMEM_LIMIT
    assert k3.rank_bytes(g, "slim")[1:] == k3.rank_bytes(g)[1:]


def test_slim_is_taken_only_where_pair_does_not_fit():
    """At every geometry of orders 3 and 4 and 1 to 32 joints up to the
    first that fits no layout: a geometry that fits one of the first eight
    layouts takes the first of them, as before the slim layout existed, and
    the slim layout is taken exactly where none of them fits and its blocks
    do; it adds grids at 7 to 32 joints of order 3 (at order 4 none for the
    Panda), and every joint count from 26 to 32 plans at 19 nodes."""
    slim = {}
    for order in (3, 4):
        for nq in range(1, 33):
            for segments in range(1, 80):
                g = Geometry(segments=segments, order=order, nq=nq)
                fits = [k3.smem_bytes(g, name) <= SMEM_LIMIT for name in LAYOUTS]
                if any(fits[:8]):
                    assert k3.choose_layout(g) == LAYOUTS[fits.index(True)] != "slim", g
                elif fits[8]:
                    assert k3.choose_layout(g) == k3.KERNEL.geometry(g).layout == "slim", g
                    slim[order, nq] = slim.get((order, nq), 0) + 1
                else:
                    break
    assert {(3, nq) for nq in range(7, 33)} <= set(slim) and (4, 7) not in slim
    assert all(slim.get((3, nq), 0) >= 1 for nq in range(26, 33))


@pytest.mark.parametrize("g", [Geometry(nq=25), Geometry(nq=26), Geometry(nq=32),
                               Geometry(26, 3, 14), Geometry(59, 3), Geometry(41, 4)],
                         ids=["25_joints", "26_joints", "32_joints", "14_joints_26x3",
                              "7_joints_59x3", "7_joints_41x4"])
def test_stage_schedule_never_shares_a_buffer_between_warps(g):
    """Rank 0's staging buffers through a sweep (``_stage_schedule``): a
    warp stages its blocks one after the other and reads each before it
    stages the next, so one buffer may take two blocks of one warp in a
    window; in no window between two of the sweeps' barriers do two warps
    stage into one buffer, in the pair layout (six buffers at order 3) or the slim one
    (three past one row a lane, four at one row a lane, as
    ``stage_buffers`` reckons them); at one row a lane both chain warps
    fetch their first step's blocks before the first barrier, so they cannot
    share one buffer there, and past one row a lane each chain warp stages
    only at its turn."""
    for layout in ("pair", "slim"):
        events = _stage_schedule(g, layout)
        owners = {}
        for window, warp, buf in events:
            owners.setdefault((window, buf), set()).add(warp)
        assert all(len(w) == 1 for w in owners.values()), layout
        assert len({buf for _, _, buf in events}) == k3.stage_buffers(g, layout)
    chain0 = {warp for window, warp, _ in _stage_schedule(g, "slim")
              if window == 0 and warp < 2}
    assert chain0 == ({0, 1} if k3.rows(g) == 1 else {0})


@pytest.mark.parametrize("g", [Geometry(nq=26), Geometry(nq=29), Geometry(nq=32),
                               Geometry(26, 3, 14)],
                         ids=["26_joints", "29_joints", "32_joints", "14_joints_26x3"])
def test_ring_schedule_of_the_slim_layout(g):
    """The slim layout's ring is the pair layout's (its slots, lead, last
    copy and every copy and read, a step late past one row a lane): at 26
    joints over four ranks, at 29 and 32 over seven, at 14 joints x 26 in one
    ring rank, no read finds its copy unlanded or under 4 steps old and no
    copy overwrites an unread slot through three pairs of sweeps."""
    for fn in (k3.ring_runs, k3.ring_slot, k3.ring_last):
        assert fn(g, "slim") == fn(g, "pair")
    assert k3.lead("slim") == k3.lead("pair") == 4
    assert k3.ring_schedule(g, "slim", 3) == k3.ring_schedule(g, "pair", 3)
    bad, copies = _ring_faults(g, k3.ring_runs(g, "slim"))
    assert not bad, bad[:5]
    ranks = k3.ring_ranks(g)
    for r in range(1, ranks + 1):
        assert any(n is not None for n, _, s in copies if 1 + s % ranks == r)


def test_kernel2_scratch_build_reckoning():
    """Kernel 2's scratch build: the forward loop keeps LkT, S[2] and the two
    C of distance 1 (the inverse and C[d >= 2] lie in Ldi), one staged node
    of the backward sweep (four blocks), one problem an SM; taken from 28 to
    34 joints at 19 nodes, where the device ring does not fit (238,964 B at
    28 joints, 309,908 B at 32) and only there; its flag and library name; a
    forced scratch build where the device ring fits (25 joints, held bitwise
    on the card) is another library."""
    for nq in range(1, 36):
        g = Geometry(nq=nq)
        fits = [k2.smem_bytes(g, ring) <= SMEM_LIMIT for ring in RINGS]
        assert k2.choose_ring(g) == (RINGS[fits.index(True)] if any(fits) else "scratch")
        assert (k2.choose_ring(g) == "scratch") == (28 <= nq), nq
    for nq, (device, scratch) in {28: (238964, 154292), 30: (274004, 176804),
                                  32: (309908, 199316)}.items():
        g = Geometry(nq=nq)
        blk = 3 * nq
        lks = -(-blk // 4) * 4
        floats = blk * lks + 4 * blk * blk
        assert k2.forward_floats(g, "scratch") == floats and k2.staged_nodes(g) == 1
        assert k2.forward_floats(g, "device") - floats == 3 * blk * blk  # C[2], C[3], Linv
        assert 4 * (max(floats, 4 * blk * blk) + 2 * 19 * blk + 96 + 4) + 4 == scratch
        assert (k2.smem_bytes(g), k2.smem_bytes(g, "device")) == (scratch, device)
        assert k2.per_sm(g) == 1 and k2.rows(g) == 3
        built = k2.KERNEL.geometry(g)
        assert (built.ring, built.layout, built.ept, built.ranks) == ("scratch", None, None, None)
        assert k2.KERNEL.flags(g)[-1] == "-DMPC_FACTOR_RING=2"
        assert "_sring_" in k2.KERNEL.library_path(g).name
        k2.check_fits(g)
    g25 = Geometry(nq=25, ring="scratch")
    k2.check_fits(g25)
    assert (k2.smem_bytes(g25), k2.staged_nodes(g25)) == (124604, 1)
    assert k2.KERNEL.library_path(g25) != k2.KERNEL.library_path(Geometry(nq=25))
    assert k2.choose_ring(Geometry(nq=25)) == "device"
    # kernel 3 ignores kernel 2's build
    assert k3.KERNEL.library_path(Geometry(nq=32, ring="scratch")) == \
        k3.KERNEL.library_path(Geometry(nq=32))


def test_factor_banded_blk96_matches_jax():
    """The plain kernel 2 at blk 96 (32 joints, three rows a lane on the
    card), band width 3, on a seeded 7-node band at float64, in its three
    statements (``factor_banded``, the shared ring's schedule, the device
    ring's with two staged nodes; the scratch build's schedule is the device
    ring's with one, as the float32 case holds): the JAX node-level factor's
    Ldi, Lsub, u and s to 1e-9, the schedules bitwise alike, an indefinite
    problem flagged alone."""
    factor_matches_jax(96, seed=96)


def test_first_refusals_past_the_new_builds():
    """Past the new builds every refusal names its bytes before any build:
    kernel 1 at 33 joints (1,056 threads a block); kernel 3 at 32 joints and
    22 nodes (slim rank 0 233,584 B, each of seven ring ranks 147,504 B) and
    the Panda at 60 segments (181 nodes, slim rank 0 235,472 B), one segment
    fewer planning in the slim layout; kernel 2 at 35 joints and 19 nodes
    (238,252 B in its scratch build, naming the other builds' bytes)."""
    k1.check_fits(32)
    with pytest.raises(ValueError, match=r"kernel 1 at 33 joints needs 1056 threads a block"):
        k1.check_fits(33)
    g = Geometry(7, 3, 32)
    ring = ", ".join(["rank 0 233584 B"] + [f"rank {i} 147504 B" for i in range(1, 8)])
    with pytest.raises(ValueError) as err:
        k3.check_fits(g)
    assert (f"22 nodes, order 3 and 32 joints (2113 variables, 2518 rows) needs 233584 B of "
            f"shared memory per block in its slim layout ({ring}; full: " in str(err.value))
    k3.check_fits(Geometry(6, 3, 32))
    with pytest.raises(ValueError, match=r"181 nodes, order 3 and 7 joints .* needs 235472 B "
                                         r"of shared memory per block in its slim layout"):
        k3.check_fits(Geometry(60, 3))
    assert k3.KERNEL.geometry(Geometry(59, 3)).layout == "slim"
    k2.check_fits(Geometry(nq=34))
    with pytest.raises(ValueError, match=r"35 joints needs 238252 B of shared memory per block "
                                         r"with its scratch ring \(shared ring: 767452 B, device "
                                         r"ring: 370552 B\)"):
        k2.check_fits(Geometry(nq=35))


def _chain32_planner():
    """The seeded 32-joint chain as ``bench/convergence.py`` ``chain`` builds
    it, planned on the CPU at float64 in the fixture's configuration
    (structured QP, fixed rho, no KKT refinement, budgets 700/500), no floor
    for its tool."""
    model, limits, tool, _, _ = chain(32, 1, torch.float64, torch.device("cpu"))
    planner = MotionPlanner(
        model=model, limits=limits, tool_frame=tool, margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
        qp_settings=QPSettings(backend="structured", kkt_refine=0, rho_update_every=0,
                               ruiz_iters=2, rho=0.1, alpha=1.6, check_every=25, max_iter=700),
        sqp_settings=SQPSettings(qp_step_schedules="200,500;150,350"), device="cpu")
    planner.set_min_height(-10.0)
    return planner


def test_chain32_plain_solve_matches_the_jax_fixture():
    """The fixture holds the first 64 states of the seeded 32-joint chain
    (``chain(32, ...)`` at float32) and the JAX ``structured`` solve of them
    at 19 nodes (1825 variables, 2163 rows; none of its QPs converges within
    the budgets), with the JAX float32 solve's final times (64/64 within
    1e-3 of the float64 solve's); the port's plain float64 solve of the
    first state matches its final time and iterates to rtol 1e-6, with the
    same qp_converged and qp_iterations, and lands in the target box."""
    fx = np.load(CHAIN32_FIXTURE)
    _, _, _, cur, tgt = chain(32, 64, torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(fx["current"], cur.numpy())
    np.testing.assert_array_equal(fx["target"], tgt.numpy())
    assert fx["z"].shape == (64, 1825) and fx["final_time_float32"].shape == (64,)
    tf32, tf = fx["final_time_float32"].astype(np.float64), fx["final_time"]
    assert int((np.abs(tf32 - tf) <= 1e-3 * np.abs(tf)).sum()) == 64
    planner = _chain32_planner()
    ocp = planner.ocp
    assert (ocp.nq, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (32, 1825, 2163)
    n = 1
    cur, tgt = (torch.as_tensor(fx[k][:n].astype(np.float64)) for k in ("current", "target"))
    sol = planner.solve(cur, tgt)
    np.testing.assert_allclose(sol.final_time.numpy(), fx["final_time"][:n], rtol=1e-6)
    np.testing.assert_allclose(sol.z.numpy(), fx["z"][:n], rtol=1e-6, atol=1e-6)
    assert sol.qp_converged.tolist() == fx["qp_converged"][:n].tolist()
    np.testing.assert_array_equal(sol.qp_iterations.numpy(), fx["qp_iterations"][:n])
    err = (sol.x_at(1.0) - tgt).abs().amax(-1)
    assert bool((err <= planner.target_eps + planner.qp_settings.eps_abs).all())
