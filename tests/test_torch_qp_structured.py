"""PyTorch port: the structured QP (Ruiz scaling, banded KKT assembly, the
plain version of kernel 2 and the plain version of kernel 3) against the
JAX package on real planner QPs (float64)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu.ops import qp_structured as jqs
from mpc_motion_planner_tpu.ops import structure as jstructure
from mpc_motion_planner_tpu.ops.qp import QPSettings as JQPSettings
from mpc_motion_planner_tpu.planner import Margins as JMargins
from mpc_motion_planner_tpu.planner import MotionPlanner as JPlanner
from mpc_motion_planner_tpu_torch.ocp import make_ocp
from mpc_motion_planner_tpu_torch.models.panda import make_panda_model
from mpc_motion_planner_tpu_torch.ops import qp_structured as tqs
from mpc_motion_planner_tpu_torch.ops.qp import QPSettings
from mpc_motion_planner_tpu_torch.ops.structure import StructuredA

torch.set_num_threads(1)

B = 4


def _soft_x(ocp, w=10.0):
    nodes, nx, nu = ocp.num_nodes, ocp.nx, ocp.nu
    wx = np.zeros(ocp.num_var)
    wx[nx : (nodes - 1) * nx] = w
    wx[nodes * nx : nodes * (nx + nu)] = w
    return np.broadcast_to(wx, (B, ocp.num_var)).copy()


@pytest.fixture(scope="module")
def qp_data():
    """Real SQP-subproblem QPs from warm-started planner states, built as
    the JAX package's own structured-QP tests build them; numpy leaves."""
    planner = JPlanner(margins=JMargins(0.8, 0.8, 0.6, 0.9, 0.1))
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    cur = jnp.concatenate(planner.sample_random_state(k1, batch_shape=(B,)), -1)
    tgt = jnp.concatenate(planner.sample_random_state(k2, batch_shape=(B,)), -1)
    ocp = planner.ocp
    bounds = planner.nlp_bounds(cur, tgt)
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    c_eq = jax.vmap(ocp.eq_residual)(z0)
    g = jax.jit(jax.vmap(ocp.ineq_residual))(z0)
    lb_g = jnp.broadcast_to(bounds.lb_ineq, (B, ocp.num_ineq))
    ub_g = jnp.broadcast_to(bounds.ub_ineq, (B, ocp.num_ineq))
    J = jax.jit(jax.vmap(ocp.node_constraint_jacobians))(z0)
    sa = jstructure.build_structured_A(ocp, z0, J=J)
    m = ocp.num_eq + ocp.num_ineq
    soft_c = np.zeros((B, m))
    soft_c[:, ocp.num_eq :] = 10.0
    data = dict(
        p=sa.p, f_rows=sa.f_rows, J=sa.J,
        P=np.full((B, ocp.num_var), 0.01),
        q=jax.vmap(ocp.cost_gradient)(z0),
        lc=jnp.concatenate([-c_eq, lb_g - g], axis=-1),
        uc=jnp.concatenate([-c_eq, ub_g - g], axis=-1),
        lx=jnp.broadcast_to(bounds.lb_var, z0.shape) - z0,
        ux=jnp.broadcast_to(bounds.ub_var, z0.shape) - z0,
        soft_c=soft_c,
        soft_x=_soft_x(ocp),
    )
    return ocp, {k: np.array(v) for k, v in data.items()}


@pytest.fixture(scope="module")
def port_ocp():
    return make_ocp(make_panda_model())


def _sa(d):
    return (
        jstructure.StructuredA(*(jnp.asarray(d[k]) for k in ("p", "f_rows", "J"))),
        StructuredA(*(torch.as_tensor(d[k]) for k in ("p", "f_rows", "J"))),
    )


def _close(got, ref, tol=1e-9):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("iters", [2, 6])
def test_ruiz_structured_matches_jax(qp_data, port_ocp, iters):
    jo, d = qp_data
    sa_j, sa_t = _sa(d)
    D_ref, E_ref = jqs.ruiz_structured(jo, sa_j, iters)
    D, E = tqs.ruiz_structured(port_ocp, sa_t, iters)
    _close(D, D_ref)
    _close(E, E_ref)


def _kkt(qp_data, port_ocp, seed):
    jo, d = qp_data
    sa_j, sa_t = _sa(d)
    rng = np.random.default_rng(seed)
    n, m = jo.num_var, jo.num_eq + jo.num_ineq
    D = rng.uniform(0.5, 2.0, (B, n))
    w = rng.uniform(0.1, 3.0, (B, m))
    sig = rng.uniform(0.5, 1.5, (B, n))
    K, nx = jo.coll.order + 1, jo.nx
    w_eq, w_g = w[:, : jo.num_eq].reshape(B, -1, K, nx), w[:, jo.num_eq :].reshape(B, jo.num_nodes, -1)
    ref = jqs.assemble_banded_M(jo, sa_j, *(jnp.asarray(a) for a in (w_eq, w_g, D, sig)))
    got = tqs.assemble_banded_M(port_ocp, sa_t, *(torch.as_tensor(a) for a in (w_eq, w_g, D, sig)))
    return ref, got


def test_assemble_banded_M_matches_jax(qp_data, port_ocp):
    ref, got = _kkt(qp_data, port_ocp, 5)
    for g, r in zip(got, ref):
        _close(g, r)


def test_factor_banded_matches_jax(qp_data, port_ocp):
    """The plain version of kernel 2 against the JAX node-level factor, and
    its ok flag on a deliberately indefinite block."""
    (Mb_j, pc_j, mpp_j), (Mb, pc, mpp) = _kkt(qp_data, port_ocp, 21)
    bw = port_ocp.coll.order
    ref = jqs.factor_banded(Mb_j, pc_j, mpp_j, bw)
    got = tqs.factor_banded(Mb, pc, mpp, bw)
    for k in ("Ldi", "Lsub", "u", "s"):
        _close(got[k], ref[k])
    assert bool(got["ok"].all())

    bad = Mb.clone()
    bad[1, 0, 0, 0, 0] = -1.0
    got_bad = tqs.factor_banded(bad, pc, mpp, bw)
    assert got_bad["ok"].tolist() == [True, False, True, True]
    for k in ("Ldi", "Lsub", "u", "s"):  # good problems keep their factors
        _close(got_bad[k][[0, 2, 3]], np.asarray(ref[k])[[0, 2, 3]])


def _bad(Mb):
    bad = Mb.clone()
    bad[1, 0, 0, 0, 0] = -1.0  # an indefinite first block: the guards flag problem 1
    return bad


# Relative to the largest entry of each factor. float64: kernel 2's schedule
# keeps banded_cholesky's order of products and differs in nothing but where
# a block waits, 1e-10. float32: 1e-5, as for the sweeps below.
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-10), (torch.float32, 1e-5)],
                         ids=["float64", "float32"])
def test_ring_schedule_factor_matches_factor_banded(qp_data, port_ocp, dtype, tol):
    """Kernel 2's schedule in plain PyTorch (a ring of three nodes, the arrow
    column's forward substitution inside the node loop, the backward sweep
    from the written factors) against factor_banded, on a batch with a
    problem the guards flag: identical ok, and the factors of the ok
    problems."""
    _, (Mb, pc, mpp) = _kkt(qp_data, port_ocp, 21)
    Mb, pc, mpp = _bad(Mb).to(dtype), pc.to(dtype), mpp.to(dtype)
    bw = port_ocp.coll.order
    ref = tqs.factor_banded(Mb, pc, mpp, bw)
    got = tqs.factor_banded_ring(Mb, pc, mpp, bw)
    assert got["ok"].tolist() == ref["ok"].tolist() == [True, False, True, True]
    for k in ("Ldi", "Lsub", "u", "s"):
        g, r = got[k][ref["ok"]], ref[k][ref["ok"]]
        assert float((g - r).abs().max()) <= tol * float(r.abs().max()), k


def test_ring_schedule_factor_matches_jax(qp_data, port_ocp):
    """The same schedule against the JAX node-level factor, the reference of
    the JAX package's Pallas factor kernel in its own CPU tests (the kernel
    in interpret mode takes minutes to compile), as
    test_factor_banded_matches_jax holds the plain version."""
    (Mb_j, pc_j, mpp_j), (Mb, pc, mpp) = _kkt(qp_data, port_ocp, 21)
    bw = port_ocp.coll.order
    ref = jqs.factor_banded(Mb_j, pc_j, mpp_j, bw)
    got = tqs.factor_banded_ring(Mb, pc, mpp, bw)
    for k in ("Ldi", "Lsub", "u", "s"):
        _close(got[k], ref[k])
    assert bool(got["ok"].all())


# Tolerances relative to the largest entry of the solution. float64: the two
# orders differ by rounding only, 1e-10. float32: 1e-5, twenty times the
# 5e-7 these factors give either order against the float64 solve (38 block
# steps of 21-term sums, each rounded at 6e-8).
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-10), (torch.float32, 1e-5)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("seed", [21, 22])
def test_lookahead_solve_matches_plain_solve(qp_data, port_ocp, dtype, tol, seed):
    """M^-1 rhs in kernel 3's schedule and order of sums (distance-2 and -3
    terms formed a step ahead, row sums in three partial sums) against the
    plain banded solve, on seeded right-hand sides and the KKT factors of
    real QPs; and against the JAX package's own solve at float64."""
    (Mb_j, pc_j, mpp_j), (Mb, pc, mpp) = _kkt(qp_data, port_ocp, seed)
    bw = port_ocp.coll.order
    fac64 = tqs.factor_banded(Mb, pc, mpp, bw)
    fac = {k: v.to(dtype) for k, v in fac64.items() if k != "ok"}
    rhs = torch.as_tensor(np.random.default_rng(seed).standard_normal((B, port_ocp.num_var)))
    plain = tqs.solve_arrow_banded(port_ocp, fac, rhs.to(dtype))
    ahead = tqs.solve_arrow_banded(port_ocp, fac, rhs.to(dtype), tqs.banded_solve_lookahead)
    assert ahead.dtype == dtype and ahead.shape == plain.shape
    scale = float(plain.abs().max())
    assert float((ahead - plain).abs().max()) <= tol * scale
    exact = tqs.solve_arrow_banded(port_ocp, fac64, rhs)
    # neither order is further from the float64 solve than the tolerance
    for got in (plain, ahead):
        assert float((got.double() - exact).abs().max()) <= tol * scale
    if dtype == torch.float64:
        ref = jqs.solve_arrow_banded(qp_data[0], jqs.factor_banded(Mb_j, pc_j, mpp_j, bw),
                                     jnp.asarray(rhs.numpy()))
        np.testing.assert_allclose(ahead.numpy(), np.asarray(ref), rtol=0, atol=1e-9 * scale)


def test_lookahead_schedule_alone_changes_no_bit(qp_data, port_ocp):
    """Forming the distance-2 and -3 terms a step ahead keeps the order in
    which a step subtracts them, so without the partial row sums the
    look-ahead solve equals the plain solve bitwise (float32 and float64)."""
    _, (Mb, pc, mpp) = _kkt(qp_data, port_ocp, 23)
    fac = tqs.factor_banded(Mb, pc, mpp, port_ocp.coll.order)
    r = torch.as_tensor(np.random.default_rng(23).standard_normal((B, port_ocp.num_nodes, 21)))
    for dt in (torch.float64, torch.float32):
        Ldi, Lsub = fac["Ldi"].to(dt), fac["Lsub"].to(dt)
        assert torch.equal(tqs.banded_solve_lookahead(Ldi, Lsub, r.to(dt), thirds=False),
                           tqs.banded_solve(Ldi, Lsub, r.to(dt)))


@pytest.mark.parametrize("bw", [1, 2, 3])
def test_lookahead_solve_matches_dense_solve(bw):
    """Against an independent reference: the banded factor written out as a
    dense lower-triangular L, and (L L') x = r solved by torch.linalg, for
    every band width up to the kernel's (float64, 1e-9 relative: seeded
    well-conditioned factors, unit-dominant diagonal blocks)."""
    rng = np.random.default_rng(7 + bw)
    N, blk = 6, 5
    Lkk = np.tril(rng.uniform(-0.3, 0.3, (B, N, blk, blk)), -1) + np.eye(blk)
    Lsub = rng.uniform(-0.3, 0.3, (B, N, bw, blk, blk))
    L = np.zeros((B, N * blk, N * blk))
    for k in range(N):
        L[:, k * blk:(k + 1) * blk, k * blk:(k + 1) * blk] = Lkk[:, k]
        for d in range(1, bw + 1):
            if k + d < N:
                L[:, (k + d) * blk:(k + d + 1) * blk, k * blk:(k + 1) * blk] = Lsub[:, k, d - 1]
    r = rng.standard_normal((B, N, blk))
    ref = np.linalg.solve(L @ L.transpose(0, 2, 1), r.reshape(B, -1, 1)).reshape(B, N, blk)
    Ldi = torch.as_tensor(np.linalg.inv(Lkk))
    for solve in (tqs.banded_solve, tqs.banded_solve_lookahead):
        got = solve(Ldi, torch.as_tensor(Lsub), torch.as_tensor(r))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-9 * np.abs(ref).max())


@pytest.mark.parametrize("soft", ["hard", "rows", "rows+box"])
def test_plain_admm_matches_jax(qp_data, port_ocp, soft):
    """The plain structured ADMM (kernel 3's plain version) against the JAX
    structured solver: the repo's bars for a different factorization of the
    same algorithm."""
    jo, d = qp_data
    sa_j, sa_t = _sa(d)
    soft_c = d["soft_c"] if soft != "hard" else None
    soft_x = d["soft_x"] if soft == "rows+box" else None
    args = [d[k] for k in ("P", "q", "lc", "uc", "lx", "ux")]
    as_j = lambda a: None if a is None else jnp.asarray(a)
    as_t = lambda a: None if a is None else torch.as_tensor(a)
    ref = jqs.solve_box_qp_structured(
        jo, sa_j, *map(as_j, args),
        JQPSettings(max_iter=700, kkt_refine=0, rho_update_every=0),
        soft_c=as_j(soft_c), soft_x=as_j(soft_x),
    )
    got = tqs.solve_box_qp_structured(
        port_ocp, sa_t, *map(as_t, args),
        QPSettings(backend="structured", max_iter=700, rho_update_every=0),
        soft_c=as_t(soft_c), soft_x=as_t(soft_x),
    )
    assert got.converged.tolist() == np.asarray(ref.converged).tolist()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got.iterations.numpy(), np.asarray(ref.iterations), rtol=0, atol=26
    )


def test_unported_settings_raise(qp_data, port_ocp):
    """The one refusal left is the fused kernel's own: a rho update falls on
    a dispatch boundary, so check_every must divide rho_update_every."""
    _, d = qp_data
    _, sa_t = _sa(d)
    args = [torch.as_tensor(d[k]) for k in ("P", "q", "lc", "uc", "lx", "ux")]
    with pytest.raises(ValueError, match="must divide rho_update_every"):
        tqs.solve_box_qp_structured(
            port_ocp, sa_t, *args, QPSettings(check_every=30, rho_update_every=100))
    for ok in (QPSettings(), QPSettings(rho_update_every=0, kkt_refine=1),
               QPSettings(check_every=30, rho_update_every=0)):
        ok.check_structured()


def _solve_pair(qp_data, port_ocp, settings_kw, dtype=np.float64):
    """The same soft-row QPs through the JAX ``structured`` backend and the
    port's plain structured solve, at ``dtype``."""
    jo, d = qp_data
    cast = lambda a: np.asarray(a, dtype)
    sa_j = jstructure.StructuredA(*(jnp.asarray(cast(d[k])) for k in ("p", "f_rows", "J")))
    sa_t = StructuredA(*(torch.as_tensor(cast(d[k])) for k in ("p", "f_rows", "J")))
    args = [cast(d[k]) for k in ("P", "q", "lc", "uc", "lx", "ux")]
    soft_c = cast(d["soft_c"])
    ref = jqs.solve_box_qp_structured(
        jo, sa_j, *map(jnp.asarray, args), JQPSettings(**settings_kw),
        soft_c=jnp.asarray(soft_c))
    got = tqs.solve_box_qp_structured(
        port_ocp, sa_t, *map(torch.as_tensor, args),
        QPSettings(backend="structured", **settings_kw), soft_c=torch.as_tensor(soft_c))
    return ref, got, sa_j, args, soft_c


# float64: both run the same iteration with another factorization of the same
# matrix (group-tridiagonal against node-level), so the iterates differ by the
# factorizations' rounding; rtol 1e-6 with atol 1e-8 for the entries at 0.
@pytest.mark.parametrize("settings_kw", [
    dict(max_iter=700, rho_update_every=0, kkt_refine=1),
    dict(max_iter=700, rho_update_every=100, kkt_refine=0),
    dict(max_iter=300, rho_update_every=100, kkt_refine=1),
], ids=["refine", "adaptive_rho", "adaptive_rho+refine"])
def test_plain_admm_refine_and_adaptive_rho_match_jax(qp_data, port_ocp, settings_kw):
    """KKT refinement and the chunked rho update of the plain loop against
    the JAX ``structured`` backend, which refines in its step and updates rho
    inside its check: same x, identical converged, and the iteration counts
    the two loops define alike (the convergence iteration)."""
    ref, got, *_ = _solve_pair(qp_data, port_ocp, settings_kw)
    conv = np.asarray(ref.converged)
    assert got.converged.tolist() == conv.tolist()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(got.iterations.numpy()[conv], np.asarray(ref.iterations)[conv])
    if settings_kw["rho_update_every"]:
        # the comparison is of solves whose rho did change
        settings = QPSettings(backend="structured", **settings_kw)
        sa_t, qp = _scaled(qp_data, port_ocp, settings)
        _, qp_end, n_ref = tqs.admm_chunked(port_ocp, sa_t, qp, settings, tqs.factor_banded,
                                            tqs.admm_plain)
        assert n_ref > 0 and not torch.equal(qp_end.rho, qp.rho)


def test_plain_admm_matches_structured_pallas_interpret(qp_data, port_ocp):
    """float32, adaptive rho and one refinement step: the plain loop against
    the JAX fused kernel in interpret mode, held as the JAX package's own
    test holds that kernel against its portable backend
    (test_structured_pallas_adaptive_rho_matches_xla_backend): identical
    converged, hard rows of converged problems within 5e-3, iteration counts
    within one check window."""
    from mpc_motion_planner_tpu.ops.pallas.structured_admm import (
        solve_box_qp_structured_pallas,
    )

    jo, d = qp_data
    f32 = np.float32
    settings_kw = dict(max_iter=300, check_every=25, rho_update_every=100, kkt_refine=1)
    sa_j = jstructure.StructuredA(*(jnp.asarray(d[k], f32) for k in ("p", "f_rows", "J")))
    sa_t = StructuredA(*(torch.as_tensor(d[k].astype(f32)) for k in ("p", "f_rows", "J")))
    args = [d[k].astype(f32) for k in ("P", "q", "lc", "uc", "lx", "ux")]
    soft_c = d["soft_c"].astype(f32)
    ref = solve_box_qp_structured_pallas(
        jo, sa_j, *map(jnp.asarray, args), JQPSettings(**settings_kw),
        soft_c=jnp.asarray(soft_c), lanes=4)
    got = tqs.solve_box_qp_structured(
        port_ocp, sa_t, *map(torch.as_tensor, args),
        QPSettings(backend="structured_pallas", **settings_kw), soft_c=torch.as_tensor(soft_c))
    assert got.x.dtype == torch.float32
    conv = np.asarray(ref.converged)
    assert got.converged.tolist() == conv.tolist()
    if conv.any():
        from mpc_motion_planner_tpu_torch.ops.structure import apply_A
        Ax = apply_A(port_ocp, sa_t, got.x).numpy()
        viol = np.maximum(Ax - args[3], 0.0) + np.maximum(args[2] - Ax, 0.0)
        assert (viol * (soft_c == 0))[conv].max() < 5e-3
    np.testing.assert_allclose(got.iterations.numpy(), np.asarray(ref.iterations), atol=26)


def _scaled(qp_data, port_ocp, settings):
    _, d = qp_data
    _, sa_t = _sa(d)
    args = [torch.as_tensor(d[k]) for k in ("P", "q", "lc", "uc", "lx", "ux")]
    qp = tqs.scale_qp(port_ocp, sa_t, *args, settings, soft_c=torch.as_tensor(d["soft_c"]))
    return sa_t, qp


@pytest.mark.parametrize("kkt_refine", [0, 1])
def test_chunked_dispatch_equals_one_dispatch(qp_data, port_ocp, kkt_refine):
    """Dispatches of 100 iterations that hand the state on equal one dispatch
    of the whole budget bitwise, rescue iterations included: a dispatch's
    last iteration falls on a check of the single one, done problems are
    left alone, iterations add up, residuals refresh only for problems
    active in the dispatch."""
    settings = QPSettings(backend="structured", max_iter=300, rescue_iters=50,
                          rho_update_every=0, kkt_refine=kkt_refine)
    sa_t, qp = _scaled(qp_data, port_ocp, settings)
    fac = tqs.factor_banded(qp.Mband, qp.p_col, qp.m_pp, port_ocp.coll.order)
    one = tqs.admm_plain(port_ocp, sa_t, qp, fac, settings)
    state = None
    for chunk in (100, 100, 100, 50):
        state = tqs.admm_plain(port_ocp, sa_t, qp, fac, settings, state, chunk)
    for a, b in zip(state, one):
        assert torch.equal(a, b)
    assert 0 < int(one[6].min()) and int(one[6].max()) <= 350
    # all done on entry: nothing moves, not even the counts
    done = torch.ones_like(one[5])
    again = tqs.admm_plain(port_ocp, sa_t, qp, fac, settings, one[:5] + (done,) + one[6:], 100)
    for a, b in zip(again[:5] + again[6:], one[:5] + one[6:]):
        assert torch.equal(a, b)


def test_plain_admm_is_its_check_windows_in_turn(qp_data, port_ocp):
    """A dispatch runs in check windows, each ending at a check (every
    ``check_every`` iterations and the dispatch's last): the windows of 95
    iterations at 25 are 1-25, 26-50, 51-75, 76-95, and running them by
    ``admm_window`` one after another, from the same state, gives the
    dispatch's outputs bitwise (the exit test between windows only skips
    windows of problems all done)."""
    settings = QPSettings(backend="structured", max_iter=95, rho_update_every=0)
    assert tqs.check_windows(settings, 95) == [(1, 25), (26, 50), (51, 75), (76, 95)]
    assert len(tqs.check_windows(dataclasses.replace(settings, max_iter=700), 700)) == 28
    sa_t, qp = _scaled(qp_data, port_ocp, settings)
    fac = tqs.factor_banded(qp.Mband, qp.p_col, qp.m_pp, port_ocp.coll.order)
    one = tqs.admm_plain(port_ocp, sa_t, qp, fac, settings)
    state = tqs.initial_state(qp)
    for first, last in tqs.check_windows(settings, 95):
        state = tqs.admm_window(port_ocp, sa_t, qp, fac, settings, state, first, last, 95)
    for a, b in zip(state, one):
        assert torch.equal(a, b)


def test_chunked_loop_without_rho_change_equals_fixed_rho(qp_data, port_ocp):
    """admm_chunked's chunk sizes, and its whole loop when no rho can change:
    with rho_min = rho_max = rho every update rebuilds the same system, and
    with the update thresholds never met nothing is rebuilt; both give the
    fixed-rho solve bitwise."""
    assert tqs.chunk_sizes(QPSettings(max_iter=700, rho_update_every=0, rescue_iters=200)) == [900]
    assert tqs.chunk_sizes(QPSettings(max_iter=250, rho_update_every=100)) == [100, 100, 50]
    assert tqs.chunk_sizes(QPSettings(max_iter=200, rho_update_every=100, rescue_iters=100)) \
        == [100, 100, 100]
    fixed = QPSettings(backend="structured", max_iter=300, rho_update_every=0)
    sa_t, qp = _scaled(qp_data, port_ocp, fixed)
    ref, _, n0 = tqs.admm_chunked(port_ocp, sa_t, qp, fixed, tqs.factor_banded, tqs.admm_plain)
    assert n0 == 0
    pinned = dataclasses.replace(fixed, rho_update_every=100, rho_min=fixed.rho, rho_max=fixed.rho)
    got, qp_end, n_ref = tqs.admm_chunked(port_ocp, sa_t, qp, pinned, tqs.factor_banded,
                                          tqs.admm_plain)
    assert n_ref > 0 and torch.equal(qp_end.rho, qp.rho)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_rho_update_rebuilds_everything_that_depends_on_rho(qp_data, port_ocp):
    """with_rho against scale_qp at that rho: weights, soft thresholds and
    the KKT system; the scaling and the iterates stay."""
    s1 = QPSettings(backend="structured", rho=0.1)
    s2 = dataclasses.replace(s1, rho=0.7)
    sa_t, qp1 = _scaled(qp_data, port_ocp, s1)
    _, qp2 = _scaled(qp_data, port_ocp, s2)
    moved = tqs.with_rho(port_ocp, sa_t, qp1, qp2.rho, s1)
    for f in dataclasses.fields(moved):
        assert torch.equal(getattr(moved, f.name), getattr(qp2, f.name)), f.name
    assert not torch.equal(qp1.thr, qp2.thr) and not torch.equal(qp1.Mband, qp2.Mband)


def _conditional_chunked(ocp, sa, qp, settings):
    """admm_chunked as it was before the rebuild under a mask: the system
    rebuilt and refactored only at a boundary where some problem wants
    another rho (a host synchronisation each). Returns (state, final qp, the
    boundaries at which it rebuilt, every boundary's want.any())."""
    bw = ocp.coll.order
    fac = tqs.factor_banded(qp.Mband, qp.p_col, qp.m_pp, bw)
    sizes = tqs.chunk_sizes(settings)
    state = tqs.initial_state(qp)
    rebuilt, wants = 0, []
    for c, chunk_iters in enumerate(sizes):
        state = tqs.admm_plain(ocp, sa, qp, fac, settings, state, chunk_iters)
        if c == len(sizes) - 1:
            break
        ratio = tqs.residual_ratio(ocp, sa, qp, *state[:5])
        want = (state[5] == 0) & ((ratio > 5.0) | (ratio < 0.2))
        wants.append(bool(want.any()))
        if wants[-1]:
            rho = torch.where(
                want, torch.clamp(qp.rho * ratio, settings.rho_min, settings.rho_max), qp.rho)
            qp = tqs.with_rho(ocp, sa, qp, rho, settings)
            fac = tqs.factor_banded(qp.Mband, qp.p_col, qp.m_pp, bw)
            rebuilt += 1
    return state, qp, rebuilt, wants


def test_masked_rho_rebuild_equals_conditional_rebuild(qp_data, port_ocp):
    """The rebuild at every dispatch boundary under the per-problem mask
    gives the conditional rebuild's state and final ScaledQP bitwise, on a
    solve in which rho moves at some boundaries and at others no problem
    wants another rho (there the rebuilt band and factor are the old ones);
    the count it returns is that of the boundaries where rho moved."""
    settings = QPSettings(backend="structured", max_iter=700, rho_update_every=100)
    sa_t, qp = _scaled(qp_data, port_ocp, settings)
    ref_state, ref_qp, rebuilt, wants = _conditional_chunked(port_ocp, sa_t, qp, settings)
    assert any(wants) and not all(wants), wants
    state, qp_end, moved = tqs.admm_chunked(port_ocp, sa_t, qp, settings, tqs.factor_banded,
                                            tqs.admm_plain)
    assert int(moved) == rebuilt == sum(wants)
    for a, b in zip(state, ref_state):
        assert torch.equal(a, b)
    for f in dataclasses.fields(qp_end):
        assert torch.equal(getattr(qp_end, f.name), getattr(ref_qp, f.name)), f.name


def test_group_tridiagonal_arrow_form_matches_jax(qp_data, port_ocp):
    """factor_arrow / solve_arrow (the JAX package's group block-tridiagonal
    reference form, which no solve of the port uses) against the JAX
    functions at float64, and against the node-level factor's solve of the
    same system; a band with a singular first block takes the jittered
    factors as in JAX."""
    (Mb_j, pc_j, mpp_j), (Mb, pc, mpp) = _kkt(qp_data, port_ocp, 21)
    jo, _ = qp_data
    bw = port_ocp.coll.order
    rhs = np.random.default_rng(4).normal(size=(B, jo.num_var))
    ref_fac = jqs.factor_arrow(Mb_j, pc_j, mpp_j, bw)
    fac = tqs.factor_arrow(Mb, pc, mpp, bw)
    assert fac.keys() == ref_fac.keys()
    for k in fac:
        _close(fac[k], ref_fac[k])
    x = tqs.solve_arrow(port_ocp, fac, bw, torch.as_tensor(rhs))
    _close(x, jqs.solve_arrow(jo, ref_fac, bw, jnp.asarray(rhs)))
    node = tqs.solve_arrow_banded(port_ocp, tqs.factor_banded(Mb, pc, mpp, bw), torch.as_tensor(rhs))
    _close(x, node.numpy(), tol=1e-8)
    Mb_bad, Mb_bad_j = Mb.clone(), np.array(Mb_j)
    Mb_bad[1, 0, 0] = 1.0
    Mb_bad_j[1, 0, 0] = 1.0
    fac = tqs.factor_arrow(Mb_bad, pc, mpp, bw)
    ref_fac = jqs.factor_arrow(jnp.asarray(Mb_bad_j), pc_j, mpp_j, bw)
    assert not bool(torch.isfinite(fac["Ld_inv"][1]).all())  # beyond the jitter's reach
    assert bool(torch.isfinite(fac["Ld_inv"][[0, 2, 3]]).all())
    for k in fac:  # NaN where JAX has NaN
        _close(fac[k], ref_fac[k])


def test_operator_norm_matches_svd(qp_data, port_ocp):
    """The power-iteration estimate of ||E A D||_2 within 1e-6 relative of
    the exact norm from a dense float64 SVD (the start vector is the port's
    own draw, not the JAX random stream)."""
    from mpc_motion_planner_tpu_torch.ops import structure

    _, d = qp_data
    _, sa_t = _sa(d)
    rng = np.random.default_rng(5)
    D = torch.as_tensor(rng.uniform(0.5, 2.0, (B, port_ocp.num_var)))
    E = torch.as_tensor(rng.uniform(0.5, 2.0, (B, port_ocp.num_eq + port_ocp.num_ineq)))
    A = structure.materialize(port_ocp, sa_t)
    exact = torch.linalg.matrix_norm(E[:, :, None] * A * D[:, None, :], ord=2)
    # the estimate's error falls by (sigma_2 / sigma_1)^2 per iteration; that
    # ratio is up to 0.973 here (more with other draws of D and E)
    est = structure.operator_norm(port_ocp, sa_t, D, E, iters=1000)
    np.testing.assert_allclose(est.numpy(), exact.numpy(), rtol=1e-6)
