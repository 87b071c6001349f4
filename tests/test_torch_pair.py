"""PyTorch port, kernel 3's pair layout: the deep layout in a cluster of two
blocks, one problem a cluster, rank 0 holding everything the deep layout
holds but the copier's ring and rank 1 the ring. Its blocks member by
member, the geometries that take it (exactly those whose deep block does
not fit), the warps it needs, the refusals past it, and the plain float64
structured QP at 157 nodes (52 spline segments of order 3, the first Panda
geometry that needs it) against the JAX fixture ``torch_port_seg52_b64.npz``
that ``chip_smoke.py`` phase 30 holds the card against."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu_torch import config
from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
from mpc_motion_planner_tpu_torch.kernels.build import LAYOUTS, SMEM_LIMIT, Geometry
from mpc_motion_planner_tpu_torch.ocp import make_ocp
from mpc_motion_planner_tpu_torch.ops import qp_structured as tqs
from mpc_motion_planner_tpu_torch.ops.sqp import (
    SQPSettings, hessian_regularization_diag, qp_subproblem, soft_weights,
)
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG52_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_seg52_b64.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)

# the seven geometries the deep layout refuses that the pair layout takes:
# (segments, order, joints) -> nodes, ept, threads, the deep block, (rank 0, rank 1)
PAIR_GEOMETRIES = {
    (52, 3, 7): (157, 5, 864, 233520, (208752, 49680)),
    (34, 4, 7): (137, 4, 896, 235024, (194384, 70856)),
    (37, 3, 9): (112, 4, 960, 237232, (196336, 81936)),
    (30, 3, 10): (91, 4, 864, 234016, (183584, 101088)),
    (25, 3, 11): (76, 4, 800, 236352, (175296, 122256)),
    (20, 3, 12): (61, 3, 928, 232752, (160144, 145440)),
    (12, 3, 14): (37, 2, 960, 233088, (134256, 197856)),
}

# the first geometry of each that the pair layout refuses: (segments, order,
# joints) -> nodes, rank 0's bytes (rank 0 is the larger block everywhere)
PAST_PAIR = {
    (59, 3, 7): (178, 235232), (42, 4, 7): (169, 236736), (45, 3, 9): (136, 234528),
    (40, 3, 10): (121, 236848), (35, 3, 11): (106, 234064), (32, 3, 12): (97, 236016),
    (26, 3, 14): (79, 238080),
}


def _struct(members):
    off = 0
    for floats, align in members:
        off = -(-off // align) * align + 4 * floats
    return off


@pytest.mark.parametrize("segments, order, nq", [(52, 3, 7), (12, 3, 14)],
                         ids=["157_nodes", "14_joints_37_nodes"])
def test_pair_layout_reckoning(segments, order, nq):
    """The pair layout's two blocks, member by member: rank 0 is the deep
    block with, in place of the ring, up to 3 floats to a 16-byte boundary,
    a barrier (8 bytes) per slot, which rank 1's relay arrives on, and the
    progress count, to a 16-byte boundary, then six staging buffers of a
    block from its 16-byte boundary (each chain warp's Ldi and L blocks, each
    helper's block), into which its warps read the ring's blocks; rank 1
    holds the ring's seven slots (bw + 4), each a node's run of three blocks
    and its Ldi block from their 16-byte boundaries, the barriers its bulk
    copies complete on, the progress count and the stop flag. Every block of
    the launch takes the larger: rank 0's at the Panda's 157 nodes (five
    elements a thread, 864 threads), rank 1's at 14 joints and 37 nodes (blk
    42, node vectors padded to 44, two elements a thread, 960 threads)."""
    g = Geometry(segments=segments, order=order, nq=nq)
    N, blk, nv, neq, nm, ng = g.nodes, g.blk, g.num_var, g.num_eq, g.num_rows, g.ng
    pad = -(-blk // 4) * 4
    nodes, ept, threads, deep, ranks = PAIR_GEOMETRIES[segments, order, nq]
    assert (N, k3.ept_of(g), k3.threads(g), pad) == (nodes, ept, threads, {7: 24, 14: 44}[nq])
    stage = -(-(blk * blk + 3) // 4) * 4  # a block from its 16-byte boundary
    rank0 = _struct([
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
    ])
    run = -(-(3 * blk * blk + 3) // 4) * 4  # a run of three blocks from its boundary
    ldi = -(-(blk * blk + 3) // 4) * 4  # an Ldi block from its boundary
    rank1 = 4 * 7 * (run + ldi) + 8 * 7 + 4 + 4  # slots, barriers, progress, stop
    assert (-(-rank0 // 16) * 16, rank1) == k3.rank_bytes(g) == ranks
    assert k3.smem_bytes(g) == k3.smem_bytes(g, "pair") == max(ranks) <= SMEM_LIMIT
    assert k3.smem_bytes(g, "deep") == deep > SMEM_LIMIT and k3.choose_layout(g) == "pair"
    # rank 0 is the deep block less the deep ring of five slots, with the
    # staging buffers
    assert abs(deep - ranks[0] - 4 * (5 * (run + ldi + 2) + 1 - 16 - 6 * stage)) < 16
    k3.check_fits(g)
    k2.check_fits(g)


def _geometries():
    """Every geometry of orders 2-5 and 6-10 joints, and of orders 3 and 4
    and 11, 12 and 14 joints, up to the first that fits no layout."""
    for order, joints in [(o, q) for o in (2, 3, 4, 5) for q in range(6, 11)] + [
            (o, q) for o in (3, 4) for q in (11, 12, 14)]:
        for segments in range(1, 140):
            g = Geometry(segments=segments, order=order, nq=joints)
            yield g
            if not any(k3.smem_bytes(g, name) <= SMEM_LIMIT for name in LAYOUTS):
                break


def test_pair_layout_is_taken_only_where_deep_does_not_fit():
    """At every geometry of orders 2-5 and 6-10 joints and of orders 3 and 4
    past 10 joints, up to the first that fits no layout: a geometry that fits
    one of the first seven layouts takes the first of them that fits, as it
    did before the pair layout existed (so its library is the one it had),
    and the pair layout is taken exactly where none of them fits and both
    its blocks do; the first geometry past it raises naming each rank's
    bytes. The pair layout adds geometries at every order and joint count
    but order 4 at 14 joints, where rank 1's ring of eight slots of four
    blocks of 42 x 42 (282,568 B) fits no block."""
    paired, refused = {}, []
    for g in _geometries():
        fits = [k3.smem_bytes(g, name) <= SMEM_LIMIT for name in LAYOUTS]
        layout = k3.choose_layout(g)
        if any(fits[:7]):
            assert layout == LAYOUTS[fits.index(True)] != "pair", g
        elif fits[7]:
            assert layout == "pair" and max(k3.rank_bytes(g)) <= SMEM_LIMIT, g
            assert k3.KERNEL.geometry(g).layout == "pair"
            paired[g.order, g.nq] = paired.get((g.order, g.nq), 0) + 1
        else:
            refused.append(g)
    assert len(paired) == 25 and (4, 14) not in paired and sum(paired.values()) > 200
    assert k3.rank_bytes(Geometry(segments=1, order=4, nq=14))[1] == 282568
    past = {(g.segments, g.order, g.nq) for g in refused if g.order in (3, 4)}
    assert set(PAST_PAIR) <= past


@pytest.mark.parametrize("segments, order, nq", list(PAST_PAIR),
                         ids=[f"{q}_joints_{s}x{o}" for s, o, q in PAST_PAIR])
def test_first_geometries_past_the_pair_layout_raise(segments, order, nq):
    """Past the pair layout nothing fits: the first geometry of the Panda
    at orders 3 and 4 and of 9, 10, 11, 12 and 14 joints raises before any
    build, naming each rank's bytes and every other layout's; one segment
    fewer takes the pair layout and passes the fit check."""
    g = Geometry(segments=segments, order=order, nq=nq)
    nodes, rank0 = PAST_PAIR[segments, order, nq]
    assert g.nodes == nodes and k3.rank_bytes(g)[0] == rank0 == k3.smem_bytes(g)
    assert k3.choose_layout(g) == "pair" and k3.threads(g) <= 1024
    with pytest.raises(ValueError) as err:
        k3.check_fits(g)
    others = ", ".join(f"{name}: {k3.smem_bytes(g, name)} B" for name in LAYOUTS[:-1])
    assert (f"needs {rank0} B of shared memory per block in its pair layout (rank 0 {rank0} B, "
            f"rank 1 {k3.rank_bytes(g)[1]} B; {others}); a block may have {SMEM_LIMIT} B"
            in str(err.value))
    fewer = dataclasses.replace(g, segments=segments - 1)
    assert k3.choose_layout(fewer) == "pair"
    k3.check_fits(fewer)


def test_pair_layout_needs_a_relay_warp():
    """Rank 1 runs the copier and, in the warp after it, the relay: the pair
    layout needs one warp more than the deep one, and a block without it
    raises naming it. The pair's ring is the deep's (slots, last copy) with
    a lead of 4 steps and two slots more; at a lead of 2 it is the deep's
    schedule, copy by copy and read by read."""
    g = Geometry(segments=52)
    for fn in (k3.ring_slot, k3.ring_last):
        assert fn(g, "pair") == fn(g, "deep")
    assert (k3.lead("pair"), k3.lead("deep"), k3.LEAD) == (4, 2, 2)
    assert k3.ring_runs(g, "pair") == k3.ring_runs(g, "deep") + 2 == 7
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k3, "lead", lambda layout: k3.LEAD)
        assert k3.ring_schedule(g, "pair") == k3.ring_schedule(g, "deep")
    small = Geometry(segments=2, layout="pair")  # 7 nodes, 192 threads: six warps
    assert (k3.threads(small) // 32, k3.sweep_warps(small)) == (6, 5)
    k3.check_fits(dataclasses.replace(small, layout="deep"))  # the sweeps and the copier
    with pytest.raises(ValueError, match=r"has 6 warps; its sweeps take 5 .* pair layout's "
                                         r"copier one more and its relay one more"):
        k3.check_fits(small)
    k3.check_fits(dataclasses.replace(small, segments=3))  # 10 nodes, 256 threads


def _planner(segments=52):
    planner = MotionPlanner(
        margins=Margins(*MARGINS), qp_settings=config.SHIPPING_QP_SETTINGS,
        sqp_settings=SQPSettings(qp_step_schedules=config.SHIPPING_SQP_SCHEDULES),
        device="cpu")
    planner.ocp = make_ocp(planner.model, planner.tool_frame, order=3, num_segments=segments)
    return planner


def _fixture_states(fx, n=1):
    return (torch.as_tensor(fx["current"][:n].astype(np.float64)),
            torch.as_tensor(fx["target"][:n].astype(np.float64)))


def test_seg52_fixture_step0_qp():
    """The fixture holds the first 64 headline states and the JAX solve of
    them at 52 segments of order 3 (157 nodes, 3298 variables, 4168 rows;
    ``make_torch_seg8_fixture.py --segments 52 --float32``), with the JAX
    float32 solve's final times; the port's plain structured QP of the first
    SQP step of its first state at float64, in the fixture's settings (700
    iterations), converges as the JAX solve's first QP did and in as many
    iterations."""
    fx = np.load(SEG52_FIXTURE)
    planner = _planner()
    ocp = planner.ocp
    assert (ocp.num_nodes, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (157, 3298, 4168)
    assert fx["z"].shape == (64, 3298) and fx["final_time_float32"].shape == (64,)
    cur, tgt = _fixture_states(fx)
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    _, _, sa, (h, lc, uc, lx, ux) = qp_subproblem(ocp, planner.nlp_bounds(cur, tgt), z0)
    P = hessian_regularization_diag(ocp, 1, torch.float64, "cpu", planner.sqp_settings.reg_eps)
    sc, sx = soft_weights(ocp, planner.sqp_settings, 1, torch.float64, "cpu")
    settings = dataclasses.replace(planner.qp_settings, max_iter=700)
    sol = tqs.solve_box_qp_structured(
        ocp, sa, P, h, lc, uc, lx, ux, settings, yc0=torch.zeros_like(lc),
        yx0=torch.zeros_like(lx), soft_c=sc, soft_x=sx)
    assert bool(sol.converged[0]) == bool(fx["qp_converged"][0, 0])
    assert int(sol.iterations[0]) == int(fx["qp_iterations"][0, 0])
    assert bool(torch.isfinite(sol.x).all())


@pytest.mark.slow
def test_seg52_fixture_is_the_jax_solve_of_its_first_state():
    """The port's plain solve of the fixture's first state at float64 (~60
    s on the CPU) matches its final time and iterates to the fixture's
    float32 rounding, with the same QP iterations, and lands in the target
    box."""
    fx = np.load(SEG52_FIXTURE)
    planner = _planner()
    cur, tgt = _fixture_states(fx)
    sol = planner.solve(cur, tgt)
    np.testing.assert_allclose(sol.final_time.numpy(), fx["final_time"][:1], rtol=1e-6)
    np.testing.assert_allclose(sol.z.numpy(), fx["z"][:1], rtol=1e-6, atol=1e-6)
    assert sol.qp_converged.tolist() == fx["qp_converged"][:1].tolist()
    np.testing.assert_array_equal(sol.qp_iterations.numpy(), fx["qp_iterations"][:1])
    err = (sol.x_at(1.0) - tgt).abs().amax(-1)
    assert bool((err <= planner.target_eps + planner.qp_settings.eps_abs).all())
