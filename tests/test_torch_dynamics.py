"""PyTorch port: kinematics, RNEA and the plain version of kernel 1 (the
per-node constraint values and Jacobians) against the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu.models.panda import make_panda_model as j_model
from mpc_motion_planner_tpu.ocp import make_ocp as j_make_ocp
from mpc_motion_planner_tpu.ops import kinematics as jkin
from mpc_motion_planner_tpu.ops import rnea as jrnea
from mpc_motion_planner_tpu_torch.kernels.constraints import bake_model
from mpc_motion_planner_tpu_torch.models.panda import TOOL_FRAME, make_panda_model
from mpc_motion_planner_tpu_torch.ocp import make_ocp
from mpc_motion_planner_tpu_torch.ops import kinematics as tkin
from mpc_motion_planner_tpu_torch.ops import rnea as trnea

torch.set_num_threads(1)

B = 6
_RNG = np.random.default_rng(11)
Q = _RNG.uniform(-2.5, 2.5, (B, 7))
QD = _RNG.uniform(-2.0, 2.0, (B, 7))
QDD = _RNG.uniform(-8.0, 8.0, (B, 7))
VLIN = _RNG.uniform(-1.0, 1.0, (B, 3))
VANG = _RNG.uniform(-1.0, 1.0, (B, 3))


@pytest.fixture(scope="module")
def models():
    jm = j_model(dtype=jnp.float64)
    tm = make_panda_model()
    return jm, tm, jm.frame(TOOL_FRAME), tm.frame(TOOL_FRAME)


def _close(got, ref, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def test_rnea_matches_jax(models):
    jm, tm, _, _ = models
    ref = jax.vmap(lambda a, b, c: jrnea.rnea(jm, a, b, c))(Q, QD, QDD)
    _close(trnea.rnea(tm, *(torch.as_tensor(a) for a in (Q, QD, QDD))), ref)


def test_fk_and_frame_height_match_jax(models):
    jm, tm, jf, tf = models
    R_ref, p_ref = jax.vmap(lambda q: jkin.fk(jm, q))(Q)
    R, p = tkin.fk(tm, torch.as_tensor(Q))
    _close(R, R_ref)
    _close(p, p_ref)
    h_ref = jax.vmap(lambda q: jkin.frame_height(jm, q, jf))(Q)
    _close(tkin.frame_height(tm, torch.as_tensor(Q), tf), h_ref)


def test_frame_jacobian_and_velocity_maps_match_jax(models):
    jm, tm, jf, tf = models
    q = torch.as_tensor(Q)
    J_ref = jax.vmap(lambda a: jkin.frame_jacobian(jm, a, jf))(Q)
    _close(tkin.frame_jacobian(tm, q, tf), J_ref)
    fv_ref = jax.vmap(lambda a, b: jkin.forward_velocities(jm, a, b, jf))(Q, QD)
    _close(tkin.forward_velocities(tm, q, torch.as_tensor(QD), tf), fv_ref)
    iv_ref = jax.vmap(lambda a, b, c: jkin.inverse_velocities(jm, a, b, c, jf))(Q, VLIN, VANG)
    _close(
        tkin.inverse_velocities(tm, q, torch.as_tensor(VLIN), torch.as_tensor(VANG), tf),
        iv_ref, rtol=1e-10, atol=1e-10,
    )


def _ocps(dtype_j, dtype_t):
    jo = j_make_ocp(j_model(dtype=dtype_j), dtype=dtype_j, fused_constraints="off")
    to = make_ocp(make_panda_model(dtype=dtype_t))
    return jo, to


# (dtype, value rtol/atol, Jacobian rtol/atol): f64 at 1e-9/1e-10; f32 at the
# tolerances of the JAX package's own kernel-1 parity test
@pytest.mark.parametrize(
    "dtypes,tol_g,tol_J",
    [
        ((jnp.float64, torch.float64), (1e-9, 1e-10), (1e-9, 1e-10)),
        ((jnp.float32, torch.float32), (2e-5, 2e-5), (2e-4, 5e-5)),
    ],
    ids=["f64", "f32"],
)
def test_kernel1_plain_path_matches_jax(dtypes, tol_g, tol_J):
    jo, to = _ocps(*dtypes)
    rng = np.random.default_rng(3)
    z = (rng.standard_normal((3, to.num_var)) * 0.6).astype(
        np.float64 if dtypes[1] == torch.float64 else np.float32
    )
    g_ref = jax.jit(jax.vmap(jo.ineq_residual))(jnp.asarray(z))
    J_ref = jax.jit(jax.vmap(jo.node_constraint_jacobians))(jnp.asarray(z))
    zt = torch.as_tensor(z)

    g_only = to.ineq_residual_batch(zt)
    g, J = to.linearize_constraints_batch(zt)
    assert g.dtype == J.dtype == dtypes[1]
    assert J.shape == (3, to.num_nodes, to.ng, to.nx + to.nu)
    for got in (g_only, g):
        np.testing.assert_allclose(got.numpy(), np.asarray(g_ref), rtol=tol_g[0], atol=tol_g[1])
    np.testing.assert_allclose(J.numpy(), np.asarray(J_ref), rtol=tol_J[0], atol=tol_J[1])


def test_bake_model_layout_and_refusals():
    model = make_panda_model()
    frame = model.frame(TOOL_FRAME)
    consts, tool_parent = bake_model(model, frame)
    assert consts.dtype == np.float32 and consts.shape == (7 * 46 + 6,)
    assert tool_parent == 6
    j0 = consts[:46]
    np.testing.assert_allclose(j0[:9], model.tree_rotation[0].numpy().ravel(), rtol=1e-7)
    np.testing.assert_allclose(consts[-6:-3], model.gravity.numpy(), rtol=1e-7)
    np.testing.assert_allclose(consts[-3:], frame.translation.numpy(), rtol=1e-7)

    prismatic = dataclasses.replace(model, joint_types=(1,) + model.joint_types[1:])
    with pytest.raises(NotImplementedError):
        bake_model(prismatic, frame)
    branched = dataclasses.replace(model, parent=(-1, 0, 1, 2, 3, 4, 4))
    with pytest.raises(NotImplementedError):
        bake_model(branched, frame)
