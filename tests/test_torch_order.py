"""PyTorch port, splines of orders other than 3 (band widths other than 3
in kernels 2 and 3): the geometry of their libraries (kernel 3's block
reckoned member by member, kernel 2's working set, order 4 at 6 segments in
kernel 3's split layout, at 9 and 10 in its stream layout, at 11 to 16 in
its lean layout, at 17 to 21 in its far layout, at 22 to 33 in its deep
layout and at 34 to 41 in its pair layout, the refusal of a block past the
limit), the
plain versions of kernels 2 and 3 at band widths 2, 4 and 5 against the JAX
package's factor (node-level, and its Pallas kernel in interpret mode) and
against the plain banded solve, the plain structured QP at 4 and 6
segments of order 4, 9 of order 2 and 3 of order 5 against the JAX
``structured`` backend, and the order-4
JAX fixtures that ``chip_smoke.py`` phases 21 and 22 hold the card against.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu.models.panda import make_panda_model as jmake_panda_model
from mpc_motion_planner_tpu.ocp import make_ocp as jmake_ocp
from mpc_motion_planner_tpu.ops import qp_structured as jqs
from mpc_motion_planner_tpu.ops import structure as jstructure
from mpc_motion_planner_tpu.ops.pallas.banded_factor import factor_banded_pallas
from mpc_motion_planner_tpu.ops.qp import QPSettings as JQPSettings
from mpc_motion_planner_tpu_torch import config
from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
from mpc_motion_planner_tpu_torch.kernels.build import SMEM_LIMIT, Geometry
from mpc_motion_planner_tpu_torch.ocp import make_ocp
from mpc_motion_planner_tpu_torch.ops import qp_structured as tqs
from mpc_motion_planner_tpu_torch.ops.qp import QPSettings
from mpc_motion_planner_tpu_torch.ops.sqp import (
    SQPSettings, hessian_regularization_diag, qp_subproblem, soft_weights,
)
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADLINE_STATES = os.path.join(ROOT, "tests", "fixtures", "headline_states_b2048.npz")
# the JAX solves of the first 64 headline states at order 4 x 4 and x 6
ORDER4_FIXTURES = {4: os.path.join(ROOT, "tests", "fixtures", "torch_port_order4_b64.npz"),
                   6: os.path.join(ROOT, "tests", "fixtures", "torch_port_order4s6_b64.npz")}
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)
B = 2


def _planner(order=4, segments=4):
    planner = MotionPlanner(
        margins=Margins(*MARGINS), qp_settings=config.SHIPPING_QP_SETTINGS,
        sqp_settings=SQPSettings(qp_step_schedules=config.SHIPPING_SQP_SCHEDULES),
        device="cpu")
    planner.ocp = make_ocp(planner.model, planner.tool_frame, order=order,
                           num_segments=segments)
    return planner


def _states(n=B):
    hs = np.load(HEADLINE_STATES)
    return (torch.as_tensor(hs["current"][:n].astype(np.float64)),
            torch.as_tensor(hs["target"][:n].astype(np.float64)))


def _step0(planner, n=B):
    """The first SQP step's QP of the first ``n`` headline states (float64)."""
    ocp = planner.ocp
    cur, tgt = _states(n)
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    _, _, sa, args = qp_subproblem(ocp, planner.nlp_bounds(cur, tgt), z0)
    P = hessian_regularization_diag(ocp, n, torch.float64, "cpu", planner.sqp_settings.reg_eps)
    sc, sx = soft_weights(ocp, planner.sqp_settings, n, torch.float64, "cpu")
    return sa, (P, *args), sc, sx


# (order, segments): nodes, variables, rows; kernel 3's threads, sweep warps
# and shared memory in the full and the compact layout; kernel 2's bytes and
# problems per SM. Kernel 3 keeps one look-ahead vector per distance 2..bw,
# so at order 2 it has one where order 3 has two.
GEOMETRIES = {
    (2, 9): (19, 400, 530, 544, 4, 165696, 144448, 24508, 6),
    (4, 4): (17, 358, 416, 416, 6, 208576, 181952, 47356, 4),
    (5, 3): (16, 337, 380, 384, 7, 225424, 196112, 64828, 3),
}


@pytest.mark.parametrize("order, segments", list(GEOMETRIES), ids=["order2", "order4", "order5"])
def test_geometry_of_other_orders(order, segments):
    """Nodes, variables and rows of the OCP at ``order`` x ``segments``, and
    the blocks of kernels 2 and 3 built for it: each fits one SM in the full
    layout, and both fit checks pass."""
    nodes, nv, nm, threads, warps, full, compact, smem2, per_sm2 = GEOMETRIES[order, segments]
    ocp = make_ocp(_planner().model, order=order, num_segments=segments)
    g = Geometry.of_ocp(ocp)
    assert g == Geometry(segments=segments, order=order)
    assert (g.nodes, g.num_var, g.num_rows) == (ocp.num_nodes, ocp.num_var,
                                                 ocp.num_eq + ocp.num_ineq) == (nodes, nv, nm)
    band = torch.empty(1, nodes, order + 1, 21, 21, device="meta")
    assert Geometry.of_band(band) == g
    assert (k3.threads(g), k3.sweep_warps(g)) == (threads, warps)
    assert (k3.smem_bytes(g, "full"), k3.smem_bytes(g, "compact")) == (full, compact)
    assert k3.smem_bytes(g) == full <= SMEM_LIMIT
    assert (k2.smem_bytes(g), k2.per_sm(g)) == (smem2, per_sm2)
    k2.check_fits(g)
    k3.check_fits(g)
    assert f"-DMPC_ORDER={order}" in k3.KERNEL.flags(g)
    assert k3.KERNEL.library_path(g).name.startswith(f"structured_admm_n{nodes}_o{order}_q7_")


def test_order4_beyond_one_block_raises_naming_the_bytes():
    """Order 4 at 6 segments (25 nodes, 640 threads) needs 273,632 B even in
    kernel 3's compact layout and takes the split one, 173,200 B; order 4 at
    5 segments (21 nodes) still fits compact; order 4 at 9 segments (37
    nodes, 928 threads; 247,200 B split) takes the stream layout, 197,808 B.
    Order 4 at 10 segments (41 nodes, 1028 rows) takes it at two z elements
    and rows a thread, 544 threads, 215,184 B. Order 4 at 11 segments (45
    nodes, 232,752 B stream) takes the lean layout, 167,120 B, and so does
    order 4 at 16 (65 nodes, 832 threads, 225,648 B). Order 4 at 17
    segments (69 nodes, 237,360 B lean) takes the far layout, 191,008 B, and
    so does order 4 at 21 (85 nodes, three z elements and rows a thread, 736
    threads, 226,896 B). Order 4 at 22 segments (89 nodes, 235,904 B far)
    takes the deep layout, 171,408 B, and so does order 4 at 33 (133 nodes,
    four z elements and rows a thread, 864 threads, 229,712 B). Order 4 at
    34 segments (137 nodes, 235,024 B deep) takes the pair layout, rank 0
    194,384 B and rank 1 70,856 B, and so does order 4 at 41 (165 nodes,
    five z elements and rows a thread, rank 0 231,440 B). Order 4 at 42
    segments (169 nodes) needs 236,736 B in rank 0 of the pair layout and
    233,184 B even in that of the slim layout: its fit check and the card's
    QP solve raise and name the bytes before any build or launch. Kernel 2
    takes all thirteen."""
    g46, g45, g49, g4a, g4b = (Geometry(segments=s, order=4) for s in (6, 5, 9, 10, 11))
    g65, g69 = Geometry(segments=16, order=4), Geometry(segments=17, order=4)
    g85, g89 = Geometry(segments=21, order=4), Geometry(segments=22, order=4)
    g133, g137 = Geometry(segments=33, order=4), Geometry(segments=34, order=4)
    g165, g169 = Geometry(segments=41, order=4), Geometry(segments=42, order=4)
    assert (k3.smem_bytes(g45), k3.smem_bytes(g45, "full")) == (227792, 257776)
    assert k3.choose_layout(g45) == "compact"
    assert (k3.threads(g46), k3.smem_bytes(g46, "compact")) == (640, 273632)
    assert k3.choose_layout(g46) == "split" and k3.smem_bytes(g46) == 173200
    assert (k3.threads(g49), k3.smem_bytes(g49, "split")) == (928, 247200)
    assert k3.choose_layout(g49) == "stream" and k3.smem_bytes(g49) == 197808
    assert (k3.ept_of(g4a), k3.threads(g4a), k3.smem_bytes(g4a)) == (2, 544, 215184)
    assert k3.choose_layout(g4a) == "stream"
    for g in (g45, g46, g49, g4a):
        k3.check_fits(g)
    assert (k3.threads(g4b), k3.smem_bytes(g4b, "stream"), k3.smem_bytes(g4b)) == (
        576, 232752, 167120)
    assert (k3.threads(g65), k3.smem_bytes(g65)) == (832, 225648)
    for g in (g4b, g65):
        assert k3.choose_layout(g) == "lean"
        k3.check_fits(g)
    with pytest.raises(ValueError, match=r"45 nodes, order 4 .* needs 232752 B of shared memory "
                                         r"per block in its stream layout"):
        k3.check_fits(dataclasses.replace(g4b, layout="stream"))
    assert (k3.threads(g69), k3.smem_bytes(g69, "lean"), k3.smem_bytes(g69)) == (
        896, 237360, 191008)
    assert (k3.ept_of(g85), k3.threads(g85), k3.smem_bytes(g85)) == (3, 736, 226896)
    for g in (g69, g85):
        assert k3.choose_layout(g) == "far"
        k3.check_fits(g)
    with pytest.raises(ValueError, match=r"69 nodes, order 4 .* needs 237360 B of shared memory "
                                         r"per block in its lean layout"):
        k3.check_fits(dataclasses.replace(g69, layout="lean"))
    assert (k3.threads(g89), k3.smem_bytes(g89, "far"), k3.smem_bytes(g89)) == (
        768, 235904, 171408)
    assert (k3.ept_of(g133), k3.threads(g133), k3.smem_bytes(g133)) == (4, 864, 229712)
    for g in (g89, g133):
        assert k3.choose_layout(g) == "deep"
        k3.check_fits(g)
    with pytest.raises(ValueError, match=r"89 nodes, order 4 .* needs 235904 B of shared memory "
                                         r"per block in its far layout"):
        k3.check_fits(dataclasses.replace(g89, layout="far"))
    assert (k3.threads(g137), k3.smem_bytes(g137, "deep"), k3.rank_bytes(g137)) == (
        896, 235024, (194384, 70856))
    assert (k3.ept_of(g165), k3.threads(g165), k3.rank_bytes(g165)) == (5, 864, (231440, 70856))
    for g in (g137, g165):
        assert k3.choose_layout(g) == "pair" and k3.smem_bytes(g) == k3.rank_bytes(g)[0]
        k3.check_fits(g)
    with pytest.raises(ValueError, match=r"137 nodes, order 4 .* needs 235024 B of shared memory "
                                         r"per block in its deep layout"):
        k3.check_fits(dataclasses.replace(g137, layout="deep"))
    assert (k3.threads(g169), k3.smem_bytes(g169, "pair"), k3.smem_bytes(g169)) == (
        864, 236736, 233184)
    with pytest.raises(ValueError, match=r"169 nodes, order 4 .* needs 233184 B of shared memory "
                                         r"per block in its slim layout \(rank 0 233184 B, rank 1 "
                                         r"70856 B;.* pair: rank 0 236736 B, rank 1 70856 B\)"):
        k3.check_fits(g169)
    planner = _planner(4, 42)
    sa, args, _, _ = _step0(planner, 1)
    with pytest.raises(ValueError, match="233184 B"):
        k3.solve_box_qp_structured_cuda(planner.ocp, sa, *args, config.SHIPPING_QP_SETTINGS)
    for g in (g45, g46, g49, g4a, g4b, g65, g69, g85, g89, g133, g137, g165, g169):
        k2.check_fits(g)


@pytest.fixture(scope="module")
def order4_kkt():
    """The banded KKT matrices of the step-0 QPs of four headline states at
    order 4 x 4 (float64; seeded weights, as the 19-node tests build them),
    in both packages' form."""
    n = 4
    planner = _planner()
    ocp = planner.ocp
    sa, _, _, _ = _step0(planner, n)
    rng = np.random.default_rng(31)
    D = rng.uniform(0.5, 2.0, (n, ocp.num_var))
    w = rng.uniform(0.1, 3.0, (n, ocp.num_eq + ocp.num_ineq))
    sig = rng.uniform(0.5, 1.5, (n, ocp.num_var))
    w_eq = w[:, :ocp.num_eq].reshape(n, -1, 5, ocp.nx)
    w_g = w[:, ocp.num_eq:].reshape(n, ocp.num_nodes, -1)
    got = tqs.assemble_banded_M(ocp, sa, *(torch.as_tensor(a) for a in (w_eq, w_g, D, sig)))
    jo = jmake_ocp(jmake_panda_model(), "panda_tool", order=4, num_segments=4)
    j = lambda t: jnp.asarray(t.numpy())
    ref = jqs.assemble_banded_M(jo, jstructure.StructuredA(j(sa.p), j(sa.f_rows), j(sa.J)),
                                *(jnp.asarray(a) for a in (w_eq, w_g, D, sig)))
    return got, ref


def test_factor_banded_bw4_matches_jax(order4_kkt):
    """At band width 4 the plain version of kernel 2 and kernel 2's schedule
    (a ring of four nodes) against the JAX node-level factor, to 1e-9; on a
    batch with an indefinite first block both flag that problem alone and
    keep the others' factors."""
    (Mb, pc, mpp), (Mb_j, pc_j, mpp_j) = order4_kkt
    assert Mb.shape[1:3] == (17, 5)
    for g, r in zip((Mb, pc, mpp), (Mb_j, pc_j, mpp_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12)
    ref = {k: np.asarray(v) for k, v in jqs.factor_banded(Mb_j, pc_j, mpp_j, 4).items()}
    bad = Mb.clone()
    bad[1, 0, 0, 0, 0] = -1.0
    for factor in (tqs.factor_banded, tqs.factor_banded_ring):
        got = factor(Mb, pc, mpp, 4)
        assert got["ok"].tolist() == [True] * 4
        for k in ("Ldi", "Lsub", "u", "s"):
            np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-9, atol=1e-9)
        got_bad = factor(bad, pc, mpp, 4)
        assert got_bad["ok"].tolist() == [True, False, True, True]
        for k in ("Ldi", "Lsub", "u", "s"):
            np.testing.assert_allclose(got_bad[k][[0, 2, 3]].numpy(), ref[k][[0, 2, 3]],
                                       rtol=1e-9, atol=1e-9)


def _band(N, bw, blk, n, seed):
    """A seeded block-banded SPD matrix L L' (unit-dominant diagonal blocks)
    in band storage (n, N, bw + 1, blk, blk), an arrow column and corner."""
    rng = np.random.default_rng(seed)
    L = np.zeros((n, N * blk, N * blk))
    for k in range(N):
        for d in range(min(bw, N - 1 - k) + 1):
            b = rng.uniform(-0.3, 0.3, (n, blk, blk))
            if d == 0:
                b = np.tril(b, -1) + 1.5 * np.eye(blk)
            L[:, (k + d) * blk:(k + d + 1) * blk, k * blk:(k + 1) * blk] = b
    M = L @ L.transpose(0, 2, 1)
    Mband = np.zeros((n, N, bw + 1, blk, blk))
    for k in range(N):
        for d in range(min(bw, N - 1 - k) + 1):
            Mband[:, k, d] = M[:, (k + d) * blk:(k + d + 1) * blk, k * blk:(k + 1) * blk]
    return Mband, rng.standard_normal((n, N, blk)), np.full(n, 100.0)


def test_factor_banded_bw4_matches_pallas_interpret():
    """Kernel 2's schedule at band width 4 (float32) against the JAX
    package's Pallas factor kernel in interpret mode at bw=4, lanes=4, as
    the JAX package's own CPU test holds that kernel at bw=3 (there on the
    planner's KKT matrices, whose 17 x 21 x 21 band takes minutes to compile
    in interpret mode; here on a seeded 9-node band of 6 x 6 blocks, whose
    problem 1 has an indefinite first block): the same ok flags, and the
    factors of the ok problems to float32 rounding."""
    Mband, pc, mpp = _band(9, 4, 6, 4, seed=41)
    Mband[1, 0, 0, 0, 0] = -1.0
    fac, ok = factor_banded_pallas(jnp.asarray(Mband), jnp.asarray(pc), jnp.asarray(mpp), 4,
                                   lanes=4)
    got = tqs.factor_banded_ring(*(torch.as_tensor(a, dtype=torch.float32)
                                   for a in (Mband, pc, mpp)), 4)
    assert np.asarray(ok).tolist() == got["ok"].tolist() == [True, False, True, True]
    good = [0, 2, 3]
    ref = {"Ldi": np.asarray(fac["Ldi"]), "Lsub": np.moveaxis(np.asarray(fac["Lsub_t"]), 1, 2),
           "u": np.asarray(fac["u"]), "s": np.asarray(fac["s"])}
    for k in ("Ldi", "Lsub", "u", "s"):
        r = ref[k][good]
        np.testing.assert_allclose(got[k][good].numpy(), r, rtol=0, atol=2e-5 * np.abs(r).max())
    assert bool(np.isfinite(ref["Ldi"]).all())


@pytest.mark.parametrize("bw", [2, 4, 5])
def test_lookahead_solve_at_other_band_widths(bw):
    """Kernel 3's schedule of the sweeps (a helper per distance 2..bw, each
    term subtracted in the order of its distance) against the plain banded
    solve at band width ``bw``: bitwise without the partial row sums (float32
    and float64), and with them within float rounding (1e-12 relative at
    float64, 1e-5 at float32)."""
    rng = np.random.default_rng(50 + bw)
    N, blk = 3 * bw + 1, 6
    Lkk = np.tril(rng.uniform(-0.3, 0.3, (4, N, blk, blk)), -1) + np.eye(blk)
    Ldi = torch.as_tensor(np.linalg.inv(Lkk))
    Lsub = torch.as_tensor(rng.uniform(-0.3, 0.3, (4, N, bw, blk, blk)))
    r = torch.as_tensor(rng.standard_normal((4, N, blk)))
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        args = (Ldi.to(dt), Lsub.to(dt), r.to(dt))
        plain = tqs.banded_solve(*args)
        assert torch.equal(tqs.banded_solve_lookahead(*args, thirds=False), plain)
        ahead = tqs.banded_solve_lookahead(*args)
        assert float((ahead - plain).abs().max()) <= tol * float(plain.abs().max())


def _plain_qp_against_jax(monkeypatch, order, segments):
    """The step-0 QPs of the first two headline states at ``segments``
    segments of ``order``, through the port's plain structured solve and the
    JAX ``structured`` backend with its ``_GROUP`` raised to the band width
    where it is below it, fixed rho, float64: the same x to 1e-8 and
    identical iteration counts and convergence flags."""
    monkeypatch.setattr(jqs, "_GROUP", max(jqs._GROUP, order))
    planner = _planner(order, segments)
    ocp = planner.ocp
    sa, (P, h, lc, uc, lx, ux), sc, sx = _step0(planner)
    kw = dict(max_iter=700, rho_update_every=0, kkt_refine=0)
    got = tqs.solve_box_qp_structured(ocp, sa, P, h, lc, uc, lx, ux,
                                      QPSettings(backend="structured", **kw),
                                      soft_c=sc, soft_x=sx)
    jo = jmake_ocp(jmake_panda_model(), "panda_tool", order=order, num_segments=segments)
    j = lambda t: jnp.asarray(t.numpy())
    ref = jqs.solve_box_qp_structured(
        jo, jstructure.StructuredA(j(sa.p), j(sa.f_rows), j(sa.J)),
        *(j(a) for a in (P, h, lc, uc, lx, ux)), JQPSettings(**kw), soft_c=j(sc), soft_x=j(sx))
    assert got.x.shape == (B, 21 * (order * segments + 1) + 1)
    assert bool(np.isfinite(np.asarray(ref.x)).all())
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    assert got.converged.tolist() == np.asarray(ref.converged).tolist()
    return got


@pytest.mark.parametrize("segments", [4, 6], ids=["17_nodes", "25_nodes"])
def test_plain_structured_qp_order4_matches_jax(monkeypatch, segments):
    """The step-0 QPs of the first headline states at ``segments`` segments
    of order 4, through the port's plain structured solve and the JAX
    ``structured`` backend, fixed rho: the same x to 1e-8 and identical
    iteration counts.

    The JAX backend factors the band in groups of ``_GROUP = 3`` nodes
    (``mpc_motion_planner_tpu/ops/qp_structured.py:308``), which must be at
    least the band width: at order 4 its factor misses blocks and the solve
    returns NaN. The JAX TPU path factors node by node, as the port does; the
    group is raised to the band width here, the JAX file unedited."""
    _plain_qp_against_jax(monkeypatch, 4, segments)


@pytest.mark.parametrize("order, segments", [(2, 9), (5, 3)], ids=["order2", "order5"])
def test_plain_structured_qp_orders_2_and_5_match_jax(monkeypatch, order, segments):
    """The same at order 2 (9 segments, 19 nodes: the group of 3 covers a
    band of 2) and order 5 (3 segments, 16 nodes: the group raised to 5).
    At order 2 no QP converges in either package within the budget (the
    transcription's own weakness, ``ROADMAP.md`` Queue 3), and the two
    iterate alike to the last iteration."""
    got = _plain_qp_against_jax(monkeypatch, order, segments)
    assert got.converged.all() if order == 5 else not got.converged.any()


@pytest.mark.parametrize("segments", [4, 6], ids=["17_nodes", "25_nodes"])
def test_order4_fixture_is_the_jax_solve_of_the_headline_states(segments):
    """The fixture holds the first 64 headline states and the JAX solve of
    them at ``segments`` segments of order 4 (``make_order4_fixture.py``,
    float64); the port's plain solve of its first states matches its final
    times, iterates and iteration counts to the fixture's float32 rounding,
    and lands in the target box."""
    fx = np.load(ORDER4_FIXTURES[segments])
    hs = np.load(HEADLINE_STATES)
    for k in ("current", "target"):
        np.testing.assert_array_equal(fx[k], hs[k][:64])
    nv = 21 * (4 * segments + 1) + 1
    assert fx["z"].shape == (64, nv) and fx["qp_converged"].shape == (64, 2)
    assert bool(fx["qp_converged"].all())
    planner = _planner(4, segments)
    cur, tgt = (torch.as_tensor(fx[k][:B].astype(np.float64)) for k in ("current", "target"))
    sol = planner.solve(cur, tgt)
    np.testing.assert_allclose(sol.final_time.numpy(), fx["final_time"][:B], rtol=1e-6)
    np.testing.assert_allclose(sol.z.numpy(), fx["z"][:B], rtol=1e-6, atol=1e-6)
    assert sol.qp_converged.tolist() == fx["qp_converged"][:B].tolist()
    np.testing.assert_array_equal(sol.qp_iterations.numpy(), fx["qp_iterations"][:B])
    err = (sol.x_at(1.0) - tgt).abs().amax(-1)
    assert bool((err <= planner.target_eps + planner.qp_settings.eps_abs).all())
