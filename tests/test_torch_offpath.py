"""PyTorch port: the planner's off-main-path API against the JAX package at
float64 on inputs from a numpy seed: SE(3) logarithms, the LOCAL frame
Jacobian, integration and the damped inverse kinematics; RNEA derivatives,
the mass matrix and the energies (with the Lagrangian oracle the JAX
package's own tests use); the planner's trajectory queries, margin and
height setters, feasibility flag and IK; hot restarts; and kernel 1's work
split stated in plain PyTorch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu.models.panda import make_panda_model as j_model
from mpc_motion_planner_tpu.ops import kinematics as jkin
from mpc_motion_planner_tpu.ops import rnea as jrnea
from mpc_motion_planner_tpu.ops import spatial as jspatial
from mpc_motion_planner_tpu.planner import Margins as JMargins
from mpc_motion_planner_tpu.planner import MotionPlanner as JPlanner
from mpc_motion_planner_tpu.planner import Solution as JSolution
from mpc_motion_planner_tpu_torch.examples import hot_restart
from mpc_motion_planner_tpu_torch.kernels import constraints as k1
from mpc_motion_planner_tpu_torch.models.panda import TOOL_FRAME, make_panda_model
from mpc_motion_planner_tpu_torch.ops import kinematics as tkin
from mpc_motion_planner_tpu_torch.ops import rnea as trnea
from mpc_motion_planner_tpu_torch.ops import spatial as tspatial
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner, Solution

torch.set_num_threads(1)

B = 5
_RNG = np.random.default_rng(23)
Q = _RNG.uniform(-2.5, 2.5, (B, 7))
QD = _RNG.uniform(-2.0, 2.0, (B, 7))
QDD = _RNG.uniform(-8.0, 8.0, (B, 7))
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)


def T(a):
    return torch.as_tensor(np.array(a))


def _close(got, ref, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def models():
    jm = j_model(dtype=jnp.float64)
    tm = make_panda_model()
    return jm, tm, jm.frame(TOOL_FRAME), tm.frame(TOOL_FRAME)


@pytest.fixture(scope="module")
def planners():
    jp = JPlanner(margins=JMargins(*MARGINS), dtype=jnp.float64)
    tp = MotionPlanner(margins=Margins(*MARGINS), dtype=torch.float64, device="cpu")
    return jp, tp


def _rotations(angles):
    """Rotation matrices (n, 3, 3) about seeded random axes."""
    axes = np.random.default_rng(5).standard_normal((len(angles), 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    return np.asarray(jax.vmap(jspatial.axis_angle_to_matrix)(jnp.asarray(axes),
                                                              jnp.asarray(angles)))


# ---------------- spatial and kinematics ----------------


@pytest.mark.parametrize("angles", [[0.3, -1.2, 2.5, 3.0], [0.0, 1e-9, 1e-7, 1e-5]],
                         ids=["finite", "small"])
def test_log3_log6_match_jax(angles):
    R = _rotations(np.asarray(angles))
    p = np.random.default_rng(6).standard_normal((len(angles), 3))
    _close(tspatial.log3(T(R)), jax.vmap(jspatial.log3)(jnp.asarray(R)), atol=1e-14)
    _close(tspatial.log6(T(R), T(p)), jax.vmap(jspatial.log6)(jnp.asarray(R), jnp.asarray(p)),
           atol=1e-14)
    # one pose without a batch axis
    _close(tspatial.log6(T(R[0]), T(p[0])), jspatial.log6(jnp.asarray(R[0]), jnp.asarray(p[0])),
           atol=1e-14)


def test_frame_jacobian_local_and_integrate_match_jax(models):
    jm, tm, jf, tf = models
    ref = jax.vmap(lambda q: jkin.frame_jacobian_local(jm, q, jf))(Q)
    _close(tkin.frame_jacobian_local(tm, T(Q), tf), ref)
    _close(tkin.integrate(tm, T(Q), T(QD)), jax.vmap(lambda q, v: jkin.integrate(jm, q, v))(Q, QD))


def test_inverse_kinematics_matches_jax(models):
    """The masked batch loop against the JAX scan, one problem at a time
    there: same iterates while a problem moves, same stop. Two targets are
    reachable poses near the start, the third start is already at its
    target."""
    jm, tm, jf, tf = models
    q_goal = Q[:3] * 0.4
    q0 = q_goal + np.random.default_rng(8).uniform(-0.2, 0.2, (3, 7))
    q0[2] = q_goal[2]
    Rt, pt = tkin.frame_placement(tm, T(q_goal), tf)
    kw = dict(max_iters=600)
    q, ok = tkin.inverse_kinematics(tm, T(q0), Rt, pt, tf, **kw)
    assert ok.tolist() == [True, True, True]
    for b in range(3):
        q_ref, ok_ref = jkin.inverse_kinematics(
            jm, jnp.asarray(q0[b]), jnp.asarray(Rt[b].numpy()), jnp.asarray(pt[b].numpy()), jf,
            **kw)
        assert bool(ok_ref)
        _close(q[b], q_ref, rtol=1e-8, atol=1e-10)
    assert torch.equal(q[2], T(q0[2]))
    # the pose is reached to the loop's tolerance (eps = 1e-4 on the log6 norm)
    Rg, pg = tkin.frame_placement(tm, q, tf)
    assert float((Rg - Rt).abs().max()) < 2e-4 and float((pg - pt).abs().max()) < 2e-4
    # an unreachable target does not converge and reports it
    far = pt[:1] + torch.tensor([[5.0, 0.0, 0.0]], dtype=pt.dtype)
    _, ok_far = tkin.inverse_kinematics(tm, T(q0[:1]), Rt[:1], far, tf, max_iters=20)
    assert ok_far.tolist() == [False]


# ---------------- dynamics ----------------


def test_rnea_derivatives_and_crba_match_jax(models):
    jm, tm, _, _ = models
    for b in range(2):
        ref = jrnea.rnea_derivatives(jm, *(jnp.asarray(a[b]) for a in (Q, QD, QDD)))
        got = trnea.rnea_derivatives(tm, *(T(a[b]) for a in (Q, QD, QDD)))
        for g, r in zip(got, ref):
            assert g.shape == (7, 7)
            _close(g, r)
        M = trnea.crba(tm, T(Q[b]))
        _close(M, jrnea.crba(jm, jnp.asarray(Q[b])))
        _close(M, got[2], rtol=1e-9, atol=1e-11)  # dtau/dqddot is the mass matrix
    # batched under vmap, as the JAX functions are
    Mb = torch.func.vmap(lambda q: trnea.crba(tm, q))(T(Q))
    _close(Mb, jax.vmap(lambda q: jrnea.crba(jm, q))(Q))


def test_energies_and_nonlinear_effects_match_jax(models):
    jm, tm, _, _ = models
    _close(trnea.kinetic_energy(tm, T(Q), T(QD)),
           jax.vmap(lambda q, v: jrnea.kinetic_energy(jm, q, v))(Q, QD))
    _close(trnea.potential_energy(tm, T(Q)), jax.vmap(lambda q: jrnea.potential_energy(jm, q))(Q))
    _close(trnea.nonlinear_effects(tm, T(Q), T(QD)),
           jax.vmap(lambda q, v: jrnea.nonlinear_effects(jm, q, v))(Q, QD))


def test_rnea_vs_lagrangian_and_energy_hessian(models):
    """The JAX package's energy oracle (tests/test_rnea.py) on the port's own
    functions: tau = d/dt(dKE/dv) - dKE/dq + dPE/dq from forward-velocity
    energies that share no backward sweep with RNEA, and the mass matrix as
    the velocity Hessian of the kinetic energy."""
    _, tm, _, _ = models
    q, v, a = T(Q[0]), T(QD[0]), T(QDD[0])
    ke = lambda q_, v_: trnea.kinetic_energy(tm, q_, v_)
    ke_v = torch.func.grad(ke, argnums=1)
    H_vv = torch.func.jacfwd(ke_v, argnums=1)(q, v)
    H_vq = torch.func.jacfwd(ke_v, argnums=0)(q, v)
    dke_dq = torch.func.grad(ke, argnums=0)(q, v)
    dpe_dq = torch.func.grad(lambda q_: trnea.potential_energy(tm, q_))(q)
    tau_lagrange = H_vv @ a + H_vq @ v - dke_dq + dpe_dq
    _close(trnea.rnea(tm, q, v, a), tau_lagrange.numpy(), rtol=1e-9, atol=1e-9)
    M = trnea.crba(tm, q)
    _close(M, H_vv.numpy(), rtol=1e-9, atol=1e-10)
    assert torch.equal(M, M.T) and bool((torch.linalg.eigvalsh(M) > 0).all())


# ---------------- kernel 1's work split ----------------


def test_jacobian_by_joint_passes_matches_jacfwd():
    """The Jacobian assembled from one three-tangent pass per joint (columns
    j, 7 + j, 14 + j: the split of the CUDA kernel's threads) equals
    torch.func.jacfwd's to 1e-12 at float64."""
    from mpc_motion_planner_tpu_torch.ocp import make_ocp

    ocp = make_ocp(make_panda_model())
    X = T(np.concatenate([Q, QD], -1)).reshape(B, 1, 14).repeat(1, 2, 1)
    U = T(QDD).reshape(B, 1, 7).repeat(1, 2, 1)
    ref = ocp.node_jacobians(X, U)
    got = k1.node_jacobians_by_joint(ocp, X, U)
    assert got.shape == ref.shape == (B, 2, 8, 21)
    assert float((got - ref).abs().max()) <= 1e-12
    assert float(ref.abs().max()) > 1.0


# ---------------- planner ----------------


def _solutions(jp, tp, seed=3):
    """The same made-up solution (a seeded z with final times in (1, 2))
    wrapped by both packages."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1.0, 1.0, (B, jp.ocp.num_var))
    z[:, -1] = rng.uniform(1.0, 2.0, B)
    m = jp.ocp.num_eq + jp.ocp.num_ineq
    zeros = np.zeros((B, 2))
    js = JSolution(ocp=jp.ocp, z=jnp.asarray(z), lam_c=jnp.zeros((B, m)), lam_x=jnp.zeros_like(z),
                   violation=jnp.zeros(B), qp_iterations=jnp.asarray(zeros),
                   qp_converged=jnp.asarray(zeros), step_sizes=jnp.asarray(zeros),
                   warm_start=None)
    ts = Solution(ocp=tp.ocp, z=T(z), lam_c=torch.zeros(B, m, dtype=torch.float64),
                  lam_x=torch.zeros(B, z.shape[1], dtype=torch.float64),
                  violation=torch.zeros(B, dtype=torch.float64), qp_iterations=T(zeros),
                  qp_converged=T(zeros), step_sizes=T(zeros), warm_start=None)
    return js, ts


def test_reseed_guess_and_solution_point_match_jax(planners):
    jp, tp = planners
    js, ts = _solutions(jp, tp)
    cur, tgt = np.concatenate([Q, QD], -1), np.concatenate([Q[::-1], QD[::-1]], -1)
    z_before = ts.z.clone()
    _close(ts.reseed_guess(T(cur), T(tgt)), js.reseed_guess(jnp.asarray(cur), jnp.asarray(tgt)))
    assert torch.equal(ts.z, z_before)  # the solution itself is left alone
    for t in (0.0, 0.37, 5.0):  # inside, and past the final time (clamped)
        ref = jp.solution_point(js, t)
        got = tp.solution_point(ts, t)
        for g, r in zip(got, ref):
            _close(g, r, rtol=1e-9, atol=1e-10)
    t_each = np.linspace(0.1, 1.5, B)
    for g, r in zip(tp.solution_point(ts, T(t_each)), jp.solution_point(js, jnp.asarray(t_each))):
        _close(g, r, rtol=1e-9, atol=1e-10)


def test_warm_start_queries_match_jax(planners):
    jp, tp = planners
    cur = np.concatenate([Q * 0.5, QD * 0.1], -1)
    tgt = np.concatenate([Q[::-1] * 0.5, QD[::-1] * 0.1], -1)
    jt = jp.plan_warm_start(jnp.asarray(cur), jnp.asarray(tgt))
    tt = tp.plan_warm_start(T(cur), T(tgt))
    for t in (0.0, 0.4, 50.0):
        for g, r in zip(tp.warm_start_point(tt, t), jp.warm_start_point(jt, t)):
            _close(g, r, rtol=1e-9, atol=1e-10)
    ref = jax.vmap(lambda tr: jp.sample_warm_start(tr, 7))(jt)
    got = tp.sample_warm_start(tt, 7)
    assert got[0].shape == (B, 8) and got[4].shape == (B, 8, 7)
    for g, r in zip(got, ref):
        _close(g, r, rtol=1e-9, atol=1e-10)
    # a regularly spaced trajectory back into a warm-start vector
    tf_ = np.asarray(ref[0])[:, -1]
    z_ref = jp.warm_start_from_trajectory(jnp.asarray(tf_), *ref[1:4])
    z_got = tp.warm_start_from_trajectory(T(tf_), *got[1:4])
    assert z_got.shape == (B, tp.ocp.num_var)
    _close(z_got, z_ref, rtol=1e-9, atol=1e-10)


def test_margin_and_height_setters_match_jax():
    jp = JPlanner(dtype=jnp.float64)
    tp = MotionPlanner(dtype=torch.float64, device="cpu")
    for p in (jp, tp):
        p.set_constraint_margins(0.7, 0.6, 0.5, 0.4, 0.3)
    assert dataclasses.astuple(tp.margins) == (0.7, 0.6, 0.5, 0.4, 0.3)
    for g, r in zip(tp.state_bounds() + tp.control_bounds(), jp.state_bounds() + jp.control_bounds()):
        _close(g, r)
    for g, r in zip(tp.ineq_bounds(), jp.ineq_bounds()):
        _close(g, r)
    for p in (jp, tp):
        p.set_min_height(0.25)
    for g, r in zip(tp.ineq_bounds(), jp.ineq_bounds()):
        _close(g, r)
    assert float(tp.ineq_bounds()[0][-1]) == 0.25
    assert float(tp.ineq_bounds(0.4)[0][-1]) == 0.4  # a call's own floor wins
    cur, tgt = np.concatenate([Q, QD], -1) * 0.3, np.concatenate([QD, Q], -1) * 0.3
    ref = jp.nlp_bounds(jnp.asarray(cur), jnp.asarray(tgt), 0.4)
    got = tp.nlp_bounds(T(cur), T(tgt), 0.4)
    _close(got.lb_ineq, ref.lb_ineq)
    _close(got.ub_ineq, ref.ub_ineq)


def test_check_state_in_bounds_matches_jax(planners):
    jp, tp = planners
    lo, hi = (np.asarray(a) for a in jp.position_bounds())
    vmax = MARGINS[1] * np.asarray(jp.limits.max_velocity)
    amax = MARGINS[2] * np.asarray(jp.limits.max_acceleration)
    mid = (lo + hi) / 2
    pos = np.stack([mid, hi + 0.1, mid, lo - 0.1, mid])
    vel = np.stack([0 * vmax, 0 * vmax, 1.5 * vmax, -1.5 * vmax, 0.5 * vmax])
    acc = np.stack([0 * amax, 0 * amax, 0 * amax, 0.5 * amax, -2.0 * amax])
    got = tp.check_state_in_bounds(T(pos), T(vel))
    assert got.tolist() == [0, 1, 2, 3, 0] and got.dtype == torch.int32
    assert got.tolist() == np.asarray(jp.check_state_in_bounds(jnp.asarray(pos), jnp.asarray(vel))).tolist()
    got = tp.check_state_in_bounds(T(pos), T(vel), T(acc))
    assert got.tolist() == [0, 1, 2, 3, 10]
    assert got.tolist() == np.asarray(
        jp.check_state_in_bounds(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(acc))).tolist()


def test_planner_inverse_kinematics_matches_jax(planners):
    jp, tp = planners
    q_goal, q0 = Q[0] * 0.4, Q[0] * 0.4 + 0.15
    R, p = tkin.frame_placement(tp.model, T(q_goal), tp._tool)
    q, ok = tp.inverse_kinematics(R, p, q0=T(q0), max_iters=600)
    q_ref, ok_ref = jp.inverse_kinematics(jnp.asarray(R.numpy()), jnp.asarray(p.numpy()),
                                          q0=jnp.asarray(q0), max_iters=600)
    assert bool(ok) and bool(ok_ref)
    _close(q, q_ref, rtol=1e-8, atol=1e-10)
    # without a start: a seeded draw inside the position limits, per pose
    Rb, pb = R.expand(3, 3, 3), p.expand(3, 3)
    q_a, _ = tp.inverse_kinematics(Rb, pb, generator=torch.Generator().manual_seed(1), max_iters=0)
    q_b, _ = tp.inverse_kinematics(Rb, pb, generator=torch.Generator().manual_seed(1), max_iters=0)
    assert q_a.shape == (3, 7) and torch.equal(q_a, q_b)
    assert bool(((q_a >= tp.limits.min_position) & (q_a <= tp.limits.max_position)).all())
    assert not torch.equal(q_a[0], q_a[1])


def test_sample_random_state_raises_instead_of_returning_infeasible_states(planners):
    """Known defect of the reference side, not copied: when the height
    rejection runs out of rounds the port raises."""
    _, tp = planners
    high = MotionPlanner(margins=Margins(*MARGINS), dtype=torch.float64, device="cpu",
                         limits=dataclasses.replace(tp.limits, min_height=10.0))
    with pytest.raises(RuntimeError, match="height rejection"):
        high.sample_random_state(torch.Generator().manual_seed(0), 4, max_rounds=2)


# ---------------- hot restarts ----------------


def test_hot_restart_uses_fewer_qp_iterations_than_the_cold_solve():
    """The port's receding chain on the first four fixture states (float64,
    the shipping structured configuration): a solve restarted from the
    previous solution and duals needs fewer QP iterations than the cold
    solve did, a tenth of the way along the trajectory, and fewer than half
    when nothing has moved; it plans no OTG trajectory and still lands in
    the target box."""
    import os

    fx = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "torch_port_slice_b64.npz"))
    cur, tgt = (T(fx[k][:4].astype(np.float64)) for k in ("current", "target"))
    planner = hot_restart.make_planner("cpu", torch.float64)
    cold, hot = (r["solution"] for r in hot_restart.receding_chain(planner, cur, tgt, 2, 0.1, True))
    assert cold.warm_start is not None and hot.warm_start is None
    assert bool(hot.qp_converged.all())
    assert int(hot.qp_iterations.sum()) < int(cold.qp_iterations.sum())
    tol = planner.target_eps + planner.qp_settings.eps_abs
    assert float((hot.x_at(1.0) - tgt).abs().max()) <= tol
    assert float(hot.final_time.median()) < float(cold.final_time.median())
    same = hot_restart.hot_solve(planner, cold, cur, tgt)
    assert 2 * int(same.qp_iterations.sum()) < int(cold.qp_iterations.sum())
    # moved targets stay inside the position bounds
    moved = hot_restart.shift_targets(planner, tgt, 0.01)
    assert float((moved[:, :7] - tgt[:, :7]).abs().max()) == pytest.approx(0.01)
    assert planner.check_state_in_bounds(moved[:, :7], moved[:, 7:]).tolist() == [0, 0, 0, 0]
