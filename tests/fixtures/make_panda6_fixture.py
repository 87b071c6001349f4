"""Robot models other than the 7-joint Panda, and the JAX fixture of one.

``panda_urdf(lock_joint7)`` writes the Panda as a URDF from the port's
``models/panda.py`` constants (joint origins, link inertials, the massless
link 8 and the 1 kg tool). With joint 7 revolute, both packages' ``parse_urdf``
read it back as ``make_panda_model()``; with ``panda_joint7`` fixed they read
a 6-joint serial revolute chain whose link 6 carries links 7, 8 and the
tool. The tool lies on joint 7's axis, so the 6-joint tool height equals the
Panda's for the same q1..q6.

``chain_urdf(nq, seed)`` draws a serial revolute chain of ``nq`` joints from
a numpy seed, with Panda-sized links and masses and a tool link ``tool``: a
robot for kernel checks only. ``panda_urdf(hand=True)`` hangs a hand with two
prismatic fingers off link 8 (the shape of the reference's
``panda_mass.urdf``, with made-up hand and finger inertials): a branched
tree with prismatic joints, which kernel 1 refuses.

Run as a script, it writes ``panda_joint7_fixed.urdf`` and
``torch_port_panda6_b64.npz`` beside this file: the first 64 headline states
(``headline_states_b2048.npz``) with joint 7's position and velocity
dropped, and the JAX ``structured`` solve of them for the 6-joint model with
the Panda's first six limits, in the configuration of
``make_torch_seg8_fixture.py`` (fixed rho, no KKT refinement, per-step ADMM
budgets 700/500), on the CPU at float64, kept at float64. ``chip_smoke.py``
phase 20 holds the port's 6-joint kernel path against it on the GPU, which
has no JAX, and ``tests/test_torch_robots.py`` the port's plain solve.

With ``--hand`` it writes ``torch_port_hand9_b64.npz`` instead (and no
URDF): the Panda with its hand, ``panda_urdf(lock_joint7=False,
hand=True)`` (9 joints: the arm's 7 and two prismatic fingers, a branched
tree), with the Panda's limits and the fingers' (``FINGER_LIMITS``), planned
with ``make_ocp(model, "panda_tool", fused_constraints="off")`` (kernel 1
takes no branched tree, so the constraint rows take the XLA path), on the
first 64 headline states with the fingers at 0.01 m (current) and 0.03 m
(target) and at rest (``hand_states``), in the same configuration.
``chip_smoke.py`` phase 27 holds the port's kernel path against it.

    JAX_PLATFORMS=cpu python tests/fixtures/make_panda6_fixture.py [--hand]
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
STATES = os.path.join(HERE, "headline_states_b2048.npz")
URDF = os.path.join(HERE, "panda_joint7_fixed.urdf")
OUT = os.path.join(HERE, "torch_port_panda6_b64.npz")
BATCH = 64
# the state entries (q1..q6, qdot1..qdot6) of the 6-joint model in a
# 7-joint state (q1..q7, qdot1..qdot7)
KEEP6 = (0, 1, 2, 3, 4, 5, 7, 8, 9, 10, 11, 12)
LIMIT_ARRAYS = ("min_position", "max_position", "max_velocity", "max_acceleration",
                "max_jerk", "max_torque")
HAND_OUT = os.path.join(HERE, "torch_port_hand9_b64.npz")
# the two fingers' limits, per field of LIMIT_ARRAYS: 0-0.04 m, 0.2 m/s, 1 m/s^2,
# 50 m/s^3, 20 N
FINGER_LIMITS = {"min_position": [0.0, 0.0], "max_position": [0.04, 0.04],
                 "max_velocity": [0.2, 0.2], "max_acceleration": [1.0, 1.0],
                 "max_jerk": [50.0, 50.0], "max_torque": [20.0, 20.0]}
# the fingers' positions in the current and the target states
FINGERS_CURRENT, FINGERS_TARGET = 0.01, 0.03


def hand_states(states, width, arm: int = 7):
    """States (q, qdot) of an arm of ``arm`` joints as states of the arm with
    its two fingers: both at ``width`` and at rest."""
    states = np.asarray(states)
    w = np.full((states.shape[0], 2), width, dtype=states.dtype)
    return np.concatenate([states[:, :arm], w, states[:, arm:2 * arm], 0 * w], 1)


def _num(v) -> str:
    return " ".join(repr(float(x)) for x in np.atleast_1d(v))


def _link(name, mass=None, com=(0.0, 0.0, 0.0), inertia=None) -> str:
    if mass is None:
        return f'  <link name="{name}"/>\n'
    ixx, ixy, ixz, iyy, iyz, izz = inertia
    return (f'  <link name="{name}">\n    <inertial>\n'
            f'      <origin xyz="{_num(com)}" rpy="0 0 0"/>\n'
            f'      <mass value="{_num(mass)}"/>\n'
            f'      <inertia ixx="{_num(ixx)}" ixy="{_num(ixy)}" ixz="{_num(ixz)}" '
            f'iyy="{_num(iyy)}" iyz="{_num(iyz)}" izz="{_num(izz)}"/>\n'
            f'    </inertial>\n  </link>\n')


def _joint(name, kind, parent, child, xyz, rpy, axis=(0.0, 0.0, 1.0)) -> str:
    ax = f'    <axis xyz="{_num(axis)}"/>\n' if kind in ("revolute", "prismatic") else ""
    return (f'  <joint name="{name}" type="{kind}">\n'
            f'    <parent link="{parent}"/>\n    <child link="{child}"/>\n'
            f'    <origin xyz="{_num(xyz)}" rpy="{_num(rpy)}"/>\n{ax}  </joint>\n')


def panda_urdf(lock_joint7: bool = True, hand: bool = False) -> str:
    """The Panda from the port's constants, with ``panda_joint7`` fixed
    (6 joints) or revolute (7); with ``hand``, a 0.73 kg hand on link 8 and
    two prismatic fingers of 0.015 kg (2 joints more, a branched tree)."""
    from mpc_motion_planner_tpu_torch.models import panda

    parts = ['<?xml version="1.0"?>\n<robot name="panda">\n', _link("panda_link0")]
    for i, ((xyz, rpy), (m, com, inertia)) in enumerate(
            zip(panda._JOINT_ORIGINS, panda._LINK_INERTIALS)):
        kind = "fixed" if lock_joint7 and i == 6 else "revolute"
        parts.append(_link(f"panda_link{i + 1}", m, com, inertia))
        parts.append(_joint(f"panda_joint{i + 1}", kind, f"panda_link{i}", f"panda_link{i + 1}",
                            xyz, rpy))
    i8, it = panda._LINK8_INERTIA, panda._TOOL_INERTIA
    parts.append(_link("panda_link8", 0.0, inertia=(i8, 0.0, 0.0, i8, 0.0, i8)))
    parts.append(_joint("panda_joint8", "fixed", "panda_link7", "panda_link8",
                        (0.0, 0.0, panda._LINK8_OFFSET), (0.0, 0.0, 0.0)))
    parts.append(_link(panda.TOOL_FRAME, panda._TOOL_MASS, inertia=(it, 0.0, 0.0, it, 0.0, it)))
    parts.append(_joint("panda_tool_joint", "fixed", "panda_link8", panda.TOOL_FRAME,
                        (0.0, 0.0, panda._TOOL_OFFSET - panda._LINK8_OFFSET), (0.0, 0.0, 0.0)))
    if hand:
        parts.append(_link("panda_hand", 0.73, (0.0, 0.0, 0.04),
                           (1e-3, 0.0, 0.0, 2.5e-3, 0.0, 1.7e-3)))
        parts.append(_joint("panda_hand_joint", "fixed", "panda_link8", "panda_hand",
                            (0.0, 0.0, 0.0), (0.0, 0.0, -0.785398163397)))
        for k, side in ((1, 1.0), (2, -1.0)):
            parts.append(_link(f"panda_leftfinger{k}", 0.015, (0.0, side * 0.01, 0.02),
                               (2.4e-6, 0.0, 0.0, 2.4e-6, 0.0, 1.2e-6)))
            parts.append(_joint(f"panda_finger_joint{k}", "prismatic", "panda_hand",
                                f"panda_leftfinger{k}", (0.0, 0.0, 0.0584), (0.0, 0.0, 0.0),
                                axis=(0.0, side, 0.0)))
    parts.append("</robot>\n")
    return "".join(parts)


def chain_urdf(nq: int, seed: int) -> str:
    """A serial revolute chain of ``nq`` joints drawn from ``seed``: joint
    offsets up to 0.35 m, twists of a multiple of pi/2 about x, links of
    0.5-5 kg with their centres within 0.1 m of the joint and rotational
    inertias of 0.005-0.05 kg m^2; a 1 kg tool link ``tool`` 0.2 m along the
    last joint's axis."""
    rng = np.random.default_rng(seed)
    parts = [f'<?xml version="1.0"?>\n<robot name="chain{nq}">\n', _link("link0")]
    for i in range(nq):
        xyz = np.concatenate([rng.uniform(-0.1, 0.1, 2), rng.uniform(0.0, 0.35, 1)])
        rpy = (float(rng.choice([-1, 0, 1])) * np.pi / 2, 0.0, 0.0)
        d = rng.uniform(0.005, 0.05, 3)
        off = rng.uniform(-0.001, 0.001, 3)
        inertia = (d[0], off[0], off[1], d[1], off[2], d[2])
        parts.append(_link(f"link{i + 1}", rng.uniform(0.5, 5.0), rng.uniform(-0.1, 0.1, 3),
                           inertia))
        parts.append(_joint(f"joint{i + 1}", "revolute", f"link{i}", f"link{i + 1}", xyz, rpy))
    parts.append(_link("tool", 1.0, inertia=(1e-3, 0.0, 0.0, 1e-3, 0.0, 1e-3)))
    parts.append(_joint("tool_joint", "fixed", f"link{nq}", "tool", (0.0, 0.0, 0.2),
                        (0.0, 0.0, 0.0)))
    parts.append("</robot>\n")
    return "".join(parts)


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hand", action="store_true",
                    help="write the 9-joint hand's fixture, torch_port_hand9_b64.npz")
    hand = ap.parse_args().hand
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    if not hand:
        with open(URDF, "w") as f:
            f.write(panda_urdf(lock_joint7=True))

    import dataclasses

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from mpc_motion_planner_tpu.models.panda import make_panda_limits
    from mpc_motion_planner_tpu.models.urdf import parse_urdf
    from mpc_motion_planner_tpu.ocp import make_ocp
    from mpc_motion_planner_tpu.ops.qp import QPSettings
    from mpc_motion_planner_tpu.ops.sqp import SQPSettings
    from mpc_motion_planner_tpu.planner import Margins, MotionPlanner

    lim = make_panda_limits()
    if hand:
        model = parse_urdf(panda_urdf(lock_joint7=False, hand=True))
        limits = dataclasses.replace(lim, **{
            k: np.concatenate([np.asarray(getattr(lim, k)), FINGER_LIMITS[k]])
            for k in LIMIT_ARRAYS})
    else:
        model = parse_urdf(URDF)
        limits = dataclasses.replace(lim, **{k: np.asarray(getattr(lim, k))[:6]
                                             for k in LIMIT_ARRAYS})
    planner = MotionPlanner(
        model=model, limits=limits,
        margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
        qp_settings=QPSettings(
            backend="structured", kkt_refine=0, rho_update_every=0,
            ruiz_iters=2, rho=0.1, alpha=1.6, check_every=25, max_iter=700,
        ),
        sqp_settings=SQPSettings(qp_step_schedules="200,500;150,350"),
        dtype=jnp.float64,
    )
    states = np.load(STATES)
    if hand:
        planner.ocp = make_ocp(planner.model, "panda_tool", fused_constraints="off",
                               dtype=jnp.float64)
        assert planner.ocp.nq == 9 and planner.ocp.num_var == 514
        current = hand_states(states["current"][:BATCH], FINGERS_CURRENT)
        target = hand_states(states["target"][:BATCH], FINGERS_TARGET)
    else:
        assert planner.ocp.nq == 6 and planner.ocp.num_var == 343
        current = states["current"][:BATCH][:, KEEP6]
        target = states["target"][:BATCH][:, KEEP6]
    out = HAND_OUT if hand else OUT

    @jax.jit
    def run(cur, tgt):
        sol = planner.solve(cur, tgt)
        xT = sol.x_at(jnp.ones((), sol.z.dtype))
        err = jnp.max(jnp.abs(xT - tgt), axis=-1)
        return (sol.z, sol.violation, sol.qp_iterations, sol.qp_converged,
                sol.final_time, err)

    z, viol, iters, conv, tf, err = jax.block_until_ready(
        run(jnp.asarray(current, jnp.float64), jnp.asarray(target, jnp.float64)))
    np.savez_compressed(
        out,
        current=current,
        target=target,
        z=np.asarray(z, np.float64),
        violation=np.asarray(viol, np.float64),
        qp_iterations=np.asarray(iters, np.int32),
        qp_converged=np.asarray(conv, bool),
        final_time=np.asarray(tf, np.float64),
        terminal_err=np.asarray(err, np.float64),
    )
    print(f"wrote {out if hand else URDF + ' and ' + out}: z {np.asarray(z).shape}, qp_conv "
          f"{np.asarray(conv).mean():.4f}, median violation {np.median(np.asarray(viol)):.4f}, "
          f"terminal err max {np.asarray(err).max():.5f}")


if __name__ == "__main__":
    main()
