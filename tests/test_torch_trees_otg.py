"""PyTorch port: the OTG with boundary accelerations (against the JAX OTG at
float64 and against the repo's C++ OTG), the planner's warm start with
boundary accelerations, and branched robot models: the URDF parser, the
ancestor mask and the kinematics and dynamics of a tree, each against the
JAX package on the same inline URDFs and seeded inputs."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu.models.urdf import parse_urdf as j_parse_urdf
from mpc_motion_planner_tpu.ops import kinematics as jkin
from mpc_motion_planner_tpu.ops import rnea as jrnea
from mpc_motion_planner_tpu.ops.otg import plan_trajectory as j_plan
from mpc_motion_planner_tpu.planner import Margins as JMargins
from mpc_motion_planner_tpu.planner import MotionPlanner as JPlanner
from mpc_motion_planner_tpu_torch.models.panda import make_panda_limits
from mpc_motion_planner_tpu_torch.models.urdf import parse_urdf
from mpc_motion_planner_tpu_torch.ops import kinematics as tkin
from mpc_motion_planner_tpu_torch.ops import rnea as trnea
from mpc_motion_planner_tpu_torch.ops.otg import plan_trajectory
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port_slice_b64.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)
FRACTIONS = (0.0, 0.2, 0.5, 0.8, 1.0)
_j_plan = jax.jit(j_plan)


def T(a):
    return torch.as_tensor(np.array(a))


def _close(got, ref, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def _compare_trajectories(got, ref):
    """Duration, phase tables and samples at FRACTIONS of the duration."""
    _close(got.duration, ref.duration)
    _close(got.start_acceleration, ref.start_acceleration)
    _close(got.phase_dt, ref.phase_dt, atol=1e-12)
    _close(got.phase_jerk, ref.phase_jerk)
    for f in FRACTIONS:
        for g, r in zip(got.at_time(f * got.duration), ref.at_time(f * ref.duration)):
            _close(g, r, atol=1e-10)


# ---------------------------------------------------------------------------
# OTG with boundary accelerations
# ---------------------------------------------------------------------------

_P0, _V0 = [0.0, -0.5, 1.0], [0.3, -0.2, 0.0]
_PF, _VF = [1.0, 0.4, -0.8], [-0.1, 0.2, 0.3]


@pytest.mark.parametrize("a0, af", [
    ([1.5, -2.0, 0.7], [-0.8, 1.2, 0.0]),
    ([3.0, -3.5, 2.0], [1.0, -1.0, 2.5]),
])
def test_boundary_acceleration_cases_match_jax(a0, af):
    """The JAX package's boundary-acceleration cases (scalar limits 2, 4,
    50): the same 9-phase tables, and the boundary states met."""
    ref = _j_plan(*(jnp.asarray(x) for x in (_P0, _V0, _PF, _VF)), 2.0, 4.0, 50.0,
                  start_acceleration=jnp.asarray(a0), target_acceleration=jnp.asarray(af))
    got = plan_trajectory(*(T(x) for x in (_P0, _V0, _PF, _VF)), 2.0, 4.0, 50.0,
                          start_acceleration=T(a0), target_acceleration=T(af))
    assert got.phase_dt.shape == (3, 9)
    _compare_trajectories(got, ref)
    p, v, a = got.at_time(got.duration)
    _close(p, _PF, atol=1e-8)
    _close(v, _VF, atol=1e-8)
    _close(a, af, atol=1e-8)
    _close(got.at_time(0.0)[2], a0, atol=1e-12)


def _random_problems(seed, B=64):
    rng = np.random.default_rng(seed)
    lim = make_panda_limits()
    vmax = 0.8 * lim.max_velocity.numpy()
    amax = 0.6 * lim.max_acceleration.numpy()
    jmax = 0.1 * lim.max_jerk.numpy()
    return dict(
        p0=rng.uniform(-2, 2, (B, 7)), v0=rng.uniform(-1, 1, (B, 7)) * vmax,
        pf=rng.uniform(-2, 2, (B, 7)), vf=rng.uniform(-1, 1, (B, 7)) * vmax,
        a0=rng.uniform(-0.5, 0.5, (B, 7)) * amax, af=rng.uniform(-0.5, 0.5, (B, 7)) * amax,
        vmax=vmax, amax=amax, jmax=jmax,
    )


def test_random_boundary_accelerations_match_jax():
    """64 seeded seven-joint problems with nonzero a0 and af at float64."""
    pr = _random_problems(11)
    args = ("p0", "v0", "pf", "vf", "vmax", "amax", "jmax")
    ref = _j_plan(*(jnp.asarray(pr[k]) for k in args),
                  start_acceleration=jnp.asarray(pr["a0"]),
                  target_acceleration=jnp.asarray(pr["af"]))
    got = plan_trajectory(*(T(pr[k]) for k in args), start_acceleration=T(pr["a0"]),
                          target_acceleration=T(pr["af"]))
    assert got.phase_dt.shape == (64, 7, 9)
    _compare_trajectories(got, ref)


def test_explicit_zero_accelerations_keep_the_duration():
    pr = _random_problems(12, B=16)
    args = [T(pr[k]) for k in ("p0", "v0", "pf", "vf", "vmax", "amax", "jmax")]
    none = plan_trajectory(*args)
    zero = plan_trajectory(*args, start_acceleration=torch.zeros(16, 7, dtype=torch.float64),
                           target_acceleration=0.0)
    assert none.phase_dt.shape[-1] == 7 and zero.phase_dt.shape[-1] == 9
    _close(zero.duration, none.duration.numpy(), rtol=1e-12)


def test_plan_warm_start_with_accelerations_matches_jax():
    fx = np.load(FIXTURE)
    cur, tgt = fx["current"][:8].astype(np.float64), fx["target"][:8].astype(np.float64)
    rng = np.random.default_rng(13)
    a0, af = rng.uniform(-3, 3, (2, 8, 7))
    jp = JPlanner(margins=JMargins(*MARGINS), dtype=jnp.float64)
    tp = MotionPlanner(margins=Margins(*MARGINS), dtype=torch.float64, device="cpu")
    ref = jp.plan_warm_start(jnp.asarray(cur), jnp.asarray(tgt), current_acceleration=jnp.asarray(a0),
                             target_acceleration=jnp.asarray(af))
    got = tp.plan_warm_start(T(cur), T(tgt), current_acceleration=T(a0), target_acceleration=T(af))
    _compare_trajectories(got, ref)
    _close(got.at_time(0.0)[2], a0, atol=1e-12)


# ---------------------------------------------------------------------------
# The C++ OTG oracle (native/otg.cpp, loaded by the port's utils.native)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None and shutil.which("cmake") is None:
        pytest.skip("no native toolchain")
    from mpc_motion_planner_tpu_torch.utils import native as n

    n.load()
    return n


def test_otg_matches_cpp_oracle(native):
    """The random Panda problems of the JAX package's oracle test: the same
    duration, and the same samples at 101 times."""
    lim = make_panda_limits()
    vmax = 0.8 * lim.max_velocity.numpy()
    amax = 0.6 * lim.max_acceleration.numpy()
    jmax = 0.1 * lim.max_jerk.numpy()
    for seed in range(20):
        rng = np.random.default_rng(seed)
        p0, pf = rng.uniform(-2, 2, 7), rng.uniform(-2, 2, 7)
        v0, vf = rng.uniform(-1, 1, 7) * vmax, rng.uniform(-1, 1, 7) * vmax
        dur, dt_n, jk_n = native.plan_trajectory_native(p0, v0, pf, vf, vmax, amax, jmax)
        traj = plan_trajectory(*(T(a) for a in (p0, v0, pf, vf, vmax, amax, jmax)))
        assert dur == pytest.approx(float(traj.duration), abs=1e-8)
        ts = np.linspace(0, dur, 101)
        p_n, v_n, a_n = native.sample_native(ts, dur, p0, v0, dt_n, jk_n)
        batched = type(traj)(*(x[None] for x in (
            traj.duration, traj.start_position, traj.start_velocity,
            traj.start_acceleration, traj.phase_dt, traj.phase_jerk)))
        p_t, v_t, a_t = batched.at_time(T(ts)[:, None])
        np.testing.assert_allclose(p_n, p_t[:, 0].numpy(), atol=1e-6)
        np.testing.assert_allclose(v_n, v_t[:, 0].numpy(), atol=1e-6)
        np.testing.assert_allclose(a_n, a_t[:, 0].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# URDF parsing and branched models
# ---------------------------------------------------------------------------

SERIAL_URDF = """
<robot name="toy">
  <link name="base"/>
  <link name="l1">
    <inertial>
      <origin rpy="0 0 1.5707963267948966" xyz="0.1 0 0"/>
      <mass value="2.0"/>
      <inertia ixx="1.0" ixy="0" ixz="0" iyy="2.0" iyz="0" izz="3.0"/>
    </inertial>
  </link>
  <link name="l2">
    <inertial><mass value="1.0"/>
      <inertia ixx="0.1" ixy="0" ixz="0" iyy="0.1" iyz="0" izz="0.1"/>
    </inertial>
  </link>
  <joint name="j1" type="revolute">
    <origin xyz="0 0 0.5"/><parent link="base"/><child link="l1"/>
    <axis xyz="0 0 1"/>
  </joint>
  <joint name="j2" type="prismatic">
    <origin xyz="0.2 0 0"/><parent link="l1"/><child link="l2"/>
    <axis xyz="1 0 0"/>
  </joint>
</robot>
"""

# An arm of three revolute joints, a fixed hand with a payload and a fixed
# grasp frame, and two prismatic fingers from the hand (the shape of the
# Panda's panda_mass.urdf variant)
BRANCHED_URDF = """
<robot name="arm_with_hand">
  <link name="base"/>
  <link name="link1">
    <inertial><origin xyz="0 -0.03 0.12" rpy="0.1 0 0"/><mass value="3.0"/>
      <inertia ixx="0.3" ixy="0.01" ixz="0" iyy="0.25" iyz="0.02" izz="0.05"/></inertial>
  </link>
  <link name="link2">
    <inertial><origin xyz="0.01 0.05 -0.02"/><mass value="2.0"/>
      <inertia ixx="0.1" ixy="0" ixz="0.005" iyy="0.12" iyz="0" izz="0.04"/></inertial>
  </link>
  <link name="link3">
    <inertial><origin xyz="0.0 0.0 0.08"/><mass value="1.5"/>
      <inertia ixx="0.05" ixy="0" ixz="0" iyy="0.05" iyz="0" izz="0.02"/></inertial>
  </link>
  <link name="hand">
    <inertial><origin xyz="0 0 0.03" rpy="0 0 -0.785398163397"/><mass value="0.73"/>
      <inertia ixx="0.0025" ixy="0" ixz="0" iyy="0.0012" iyz="0" izz="0.0017"/></inertial>
  </link>
  <link name="grasptarget"/>
  <link name="finger_left">
    <inertial><origin xyz="0 0.01 0.02"/><mass value="0.015"/>
      <inertia ixx="2.4e-6" ixy="0" ixz="0" iyy="2.4e-6" iyz="0" izz="7.5e-7"/></inertial>
  </link>
  <link name="finger_right">
    <inertial><origin xyz="0 -0.01 0.02"/><mass value="0.015"/>
      <inertia ixx="2.4e-6" ixy="0" ixz="0" iyy="2.4e-6" iyz="0" izz="7.5e-7"/></inertial>
  </link>
  <joint name="joint1" type="revolute">
    <origin xyz="0 0 0.333"/><parent link="base"/><child link="link1"/><axis xyz="0 0 1"/>
  </joint>
  <joint name="joint2" type="revolute">
    <origin xyz="0 0 0" rpy="-1.5707963268 0 0"/><parent link="link1"/><child link="link2"/>
    <axis xyz="0 0 1"/>
  </joint>
  <joint name="joint3" type="revolute">
    <origin xyz="0 -0.316 0" rpy="1.5707963268 0 0"/><parent link="link2"/>
    <child link="link3"/><axis xyz="0 0 1"/>
  </joint>
  <joint name="hand_joint" type="fixed">
    <origin xyz="0 0 0.107" rpy="0 0 -0.785398163397"/><parent link="link3"/>
    <child link="hand"/>
  </joint>
  <joint name="grasp_joint" type="fixed">
    <origin xyz="0 0 0.105"/><parent link="hand"/><child link="grasptarget"/>
  </joint>
  <joint name="finger_joint1" type="prismatic">
    <origin xyz="0 0 0.0584"/><parent link="hand"/><child link="finger_left"/>
    <axis xyz="0 1 0"/>
  </joint>
  <joint name="finger_joint2" type="prismatic">
    <origin xyz="0 0 0.0584"/><parent link="hand"/><child link="finger_right"/>
    <axis xyz="0 -1 0"/>
  </joint>
</robot>
"""

_TENSORS = ("tree_rotation", "tree_translation", "axis", "mass", "com", "inertia", "gravity")


def _models(urdf):
    return j_parse_urdf(urdf).astype(jnp.float64), parse_urdf(urdf, device="cpu")


@pytest.mark.parametrize("urdf", [SERIAL_URDF, BRANCHED_URDF], ids=["serial", "branched"])
def test_parse_urdf_matches_jax(urdf):
    jm, tm = _models(urdf)
    assert tm.joint_types == jm.joint_types and tm.joint_names == jm.joint_names
    assert tm.parent == jm.parent and tm.is_serial == jm.is_serial
    for f in _TENSORS:
        assert getattr(tm, f).dtype == torch.float64
        _close(getattr(tm, f), getattr(jm, f), rtol=0, atol=1e-12)
    assert tm.frames.keys() == jm.frames.keys()
    for k, fj in jm.frames.items():
        ft = tm.frames[k]
        assert ft.parent_joint == fj.parent_joint
        _close(ft.rotation, fj.rotation, rtol=0, atol=1e-12)
        _close(ft.translation, fj.translation, rtol=0, atol=1e-12)
    for j in range(tm.nq):
        assert tm.ancestor_mask(j) == jm.ancestor_mask(j)


def test_branched_tree_structure():
    _, tm = _models(BRANCHED_URDF)
    assert tm.parent == (-1, 0, 1, 2, 2) and not tm.is_serial
    assert tm.joint_types[3:] == (1, 1)
    assert tm.frames["hand"].parent_joint == tm.frames["grasptarget"].parent_joint == 2
    assert tm.ancestor_mask(3) == (True, True, True, True, False)
    assert tm.ancestor_mask(4) == (True, True, True, False, True)
    # the hand's payload is folded into link 3
    assert float(tm.mass[2]) == pytest.approx(1.5 + 0.73)
    m32 = parse_urdf(BRANCHED_URDF, dtype=torch.float32, device="cpu")
    assert m32.mass.dtype == torch.float32 and m32.frames["hand"].rotation.dtype == torch.float32


@pytest.mark.parametrize("urdf, frames", [
    (SERIAL_URDF, ("l1", "l2")),
    (BRANCHED_URDF, ("link2", "grasptarget", "finger_left", "finger_right")),
], ids=["serial", "branched"])
def test_tree_kinematics_and_dynamics_match_jax(urdf, frames):
    """fk, both frame Jacobians and rnea at 4 seeded configurations."""
    jm, tm = _models(urdf)
    rng = np.random.default_rng(7)
    nq = tm.nq
    for _ in range(4):
        q, qd, qdd = rng.uniform(-1.5, 1.5, (3, nq))
        R_j, p_j = jkin.fk(jm, jnp.asarray(q))
        R_t, p_t = tkin.fk(tm, T(q))
        _close(R_t, R_j, atol=1e-10)
        _close(p_t, p_j, atol=1e-10)
        for name in frames:
            fj, ft = jm.frame(name), tm.frame(name)
            _close(tkin.frame_jacobian(tm, T(q), ft), jkin.frame_jacobian(jm, jnp.asarray(q), fj),
                   atol=1e-10)
            _close(tkin.frame_jacobian_local(tm, T(q), ft),
                   jkin.frame_jacobian_local(jm, jnp.asarray(q), fj), atol=1e-10)
        _close(trnea.rnea(tm, T(q), T(qd), T(qdd)),
               jrnea.rnea(jm, jnp.asarray(q), jnp.asarray(qd), jnp.asarray(qdd)), atol=1e-10)


def test_branched_jacobian_zeroes_the_other_finger():
    _, tm = _models(BRANCHED_URDF)
    q = T(np.random.default_rng(8).uniform(-1.0, 1.0, (6, tm.nq)))
    J_left = tkin.frame_jacobian(tm, q, tm.frame("finger_left"))
    J_right = tkin.frame_jacobian(tm, q, tm.frame("finger_right"))
    assert J_left.shape == (6, 6, 5)
    assert torch.all(J_left[..., 4] == 0) and torch.all(J_right[..., 3] == 0)
    assert torch.all(J_left[..., :3, 3].norm(dim=-1) > 0.99)  # the finger's own axis
    # the task-space maps run on the tree
    qd = T(np.random.default_rng(9).uniform(-1.0, 1.0, (6, tm.nq)))
    v = tkin.forward_velocities(tm, q, qd, tm.frame("finger_left"))
    assert v.shape == (6, 6) and bool(torch.isfinite(v).all())
    qd_back = tkin.inverse_velocities(tm, q, v[..., :3], v[..., 3:], tm.frame("finger_left"))
    assert torch.all(qd_back[..., 4] == 0)
