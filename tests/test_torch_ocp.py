"""PyTorch port: OCP transcription, bounds, the structured constraint
operator, the dense linearization, the OTG warm start and the benchmark
velocity mapping against the JAX package (float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu import ocp as jocp
from mpc_motion_planner_tpu.bench import harness as jharness
from mpc_motion_planner_tpu.ops import otg as jotg
from mpc_motion_planner_tpu.ops import structure as jstructure
from mpc_motion_planner_tpu.planner import Margins as JMargins
from mpc_motion_planner_tpu.planner import MotionPlanner as JPlanner
from mpc_motion_planner_tpu_torch import ocp as tocp
from mpc_motion_planner_tpu_torch.bench import harness as tharness
from mpc_motion_planner_tpu_torch.ops import otg as totg
from mpc_motion_planner_tpu_torch.ops import structure as tstructure
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner

torch.set_num_threads(1)

MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)
B = 3


@pytest.fixture(scope="module")
def planners():
    return JPlanner(margins=JMargins(*MARGINS)), MotionPlanner(margins=Margins(*MARGINS), device="cpu")


def _z(ocp, seed):
    rng = np.random.default_rng(seed)
    z = rng.uniform(-2.0, 2.0, (B, ocp.num_var))
    z[:, -1] = rng.uniform(0.5, 3.0, B)
    return z


def _close(got, ref, tol=1e-10):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol, atol=tol)


def test_pack_unpack_and_eq_residuals_match_jax(planners):
    jp, tp = planners
    jo, to = jp.ocp, tp.ocp
    z, d = _z(jo, 1), _z(jo, 2)
    zt, dt = torch.as_tensor(z), torch.as_tensor(d)
    X, U, p = to.unpack(zt)
    assert torch.equal(to.pack(X, U, p), zt)
    _close(to.eq_residual(zt), jax.vmap(jo.eq_residual)(z))
    ref = jax.vmap(jo.eq_residual_quadratic)(z, d)
    for got, r in zip(to.eq_residual_quadratic(zt, dt), ref):
        _close(got, r)
    _close(to.cost_gradient(zt), jax.vmap(jo.cost_gradient)(z))


def test_assemble_bounds_matches_jax(planners):
    jp, tp = planners
    rng = np.random.default_rng(4)
    cur, tgt = rng.uniform(-1.0, 1.0, (2, B, 14))
    ref = jp.nlp_bounds(jnp.asarray(cur), jnp.asarray(tgt))
    got = tp.nlp_bounds(torch.as_tensor(cur), torch.as_tensor(tgt))
    for f in ("lb_var", "ub_var", "lb_ineq", "ub_ineq"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)


def test_structured_operator_matches_jax(planners):
    jp, tp = planners
    jo, to = jp.ocp, tp.ocp
    z = _z(jo, 5)
    rng = np.random.default_rng(6)
    v = rng.standard_normal((B, jo.num_var))
    w = rng.standard_normal((B, jo.num_eq + jo.num_ineq))
    J_j = jax.jit(jax.vmap(jo.node_constraint_jacobians))(jnp.asarray(z))
    sa_j = jstructure.build_structured_A(jo, jnp.asarray(z), J=J_j)
    sa_t = tstructure.build_structured_A(to, torch.as_tensor(z))
    for f in ("p", "f_rows", "J"):
        _close(getattr(sa_t, f), getattr(sa_j, f))
    Av = tstructure.apply_A(to, sa_t, torch.as_tensor(v))
    _close(Av, jstructure.apply_A(jo, sa_j, jnp.asarray(v)))
    _close(tstructure.apply_AT(to, sa_t, torch.as_tensor(w)),
           jstructure.apply_AT(jo, sa_j, jnp.asarray(w)))
    A = tstructure.materialize(to, sa_t)
    _close(torch.einsum("bmn,bn->bm", A, torch.as_tensor(v)), Av.numpy())


@pytest.mark.parametrize("tau_p_column", [False, True], ids=["exact", "tau_p_column"])
def test_constraint_matrix_matches_jax(planners, tau_p_column):
    """The dense (B, 488, 400) linearization of the dense QP backends, and
    its defect and inequality blocks, with the reference's d tau/d p column
    off and on."""
    jp, tp = planners
    jo = jocp.make_ocp(jp.model, tau_p_column=tau_p_column)
    to = tocp.make_ocp(tp.model, tau_p_column=tau_p_column)
    z = _z(jo, 11)
    zt = torch.as_tensor(z)
    A = to.constraint_matrix(zt)
    assert A.shape == (B, to.num_eq + to.num_ineq, to.num_var)
    _close(A, jax.vmap(jo.constraint_matrix)(jnp.asarray(z)))
    _close(to.eq_jacobian(zt), jax.vmap(jo.eq_jacobian)(jnp.asarray(z)))
    _close(to.ineq_jacobian(zt), jax.vmap(jo.ineq_jacobian)(jnp.asarray(z)))
    # the same matrix from precomputed node Jacobians (the SQP's route)
    _, J = to.linearize_constraints_batch(zt)
    assert torch.equal(to.constraint_matrix(zt, J=J), A)
    assert bool((A[:, to.num_eq:, -1] != 0).any()) == tau_p_column


def test_otg_matches_jax(planners):
    _, tp = planners
    rng = np.random.default_rng(8)
    lim = tp.limits
    vmax = 0.8 * lim.max_velocity.numpy()
    p0, p1 = rng.uniform(-2.0, 2.0, (2, 4, 7))
    v0, v1 = rng.uniform(-0.9, 0.9, (2, 4, 7)) * vmax
    amax, jmax = 0.6 * lim.max_acceleration.numpy(), 0.1 * lim.max_jerk.numpy()
    ref = jotg.plan_trajectory(*(jnp.asarray(a) for a in (p0, v0, p1, v1, vmax, amax, jmax)))
    got = totg.plan_trajectory(*(torch.as_tensor(a) for a in (p0, v0, p1, v1, vmax, amax, jmax)))
    for f in ("duration", "phase_dt", "phase_jerk"):
        _close(getattr(got, f), getattr(ref, f), tol=1e-9)
    ts = rng.uniform(0.0, 1.1, (5, 1)) * np.asarray(ref.duration)[None]
    for g, r in zip(got.at_time(torch.as_tensor(ts)), jax.vmap(ref.at_time)(jnp.asarray(ts))):
        _close(g, r, tol=1e-9)


def test_warm_start_vector_matches_jax(planners):
    jp, tp = planners
    rng = np.random.default_rng(9)
    cur, tgt = rng.uniform(-1.0, 1.0, (2, B, 14)) * 0.5
    ref = jp.warm_start_vector(jp.plan_warm_start(jnp.asarray(cur), jnp.asarray(tgt)))
    got = tp.warm_start_vector(tp.plan_warm_start(torch.as_tensor(cur), torch.as_tensor(tgt)))
    _close(got, ref, tol=1e-9)


def test_benchmark_velocity_mapping_matches_jax(planners):
    """sample_benchmark_targets on the same draws: the JAX function's own
    draws are reproduced from its keys and fed to the port's mapping."""
    jp, tp = planners
    key, num = jax.random.PRNGKey(5), 8
    q_ref, qd_ref = jharness.sample_benchmark_targets(jp, key, num)
    k_q, k_v = jax.random.split(key)
    q, _ = jp.sample_random_state(k_q, (num,))
    vlin = jp.limits.max_linear_velocity
    v_cart = jax.random.uniform(k_v, (num, 3), q.dtype, -vlin, vlin)
    np.testing.assert_array_equal(np.asarray(q), np.asarray(q_ref))
    qd = tharness.benchmark_target_velocities(
        tp, torch.as_tensor(np.array(q)), torch.as_tensor(np.array(v_cart))
    )
    _close(qd, qd_ref, tol=1e-9)


def test_chain_states_shapes_and_chaining(planners):
    _, tp = planners
    cur, tgt = tharness.chain_states(tp, torch.Generator().manual_seed(0), 5)
    assert cur.shape == tgt.shape == (5, 14)
    assert torch.equal(cur[1:], tgt[:-1])
    assert torch.all(cur[0, 7:] == 0)
    lo, hi = tp.position_bounds()
    assert torch.all((tgt[:, :7] >= lo) & (tgt[:, :7] <= hi))
