"""PyTorch port, robots other than the 7-joint Panda: the Panda with
``panda_joint7`` fixed (``tests/fixtures/panda_joint7_fixed.urdf``, 6
joints) read by both packages' ``parse_urdf``; kernel 1's constants and its
per-joint Jacobian split at 6 and 8 joints against the JAX package; the
port's plain 6-joint solve against the JAX fixture
``torch_port_panda6_b64.npz``; the kernels' geometry at 6 to 10 joints (9
and 10 take kernel 3's split layout at 19 nodes and its stream layout at
25, 9 joints at 31 nodes at two elements a thread, 10 joints at 28 and 37
nodes its lean layout, 10 joints at 40 and 49 nodes its far layout, 10
joints at 52 and 88 nodes its deep layout, 10 joints at 91 and 118 nodes
its pair layout; 10 joints at 121 nodes fit no layout and raise, naming
the bytes); the ``fused_constraints`` routing of
the constraint rows on the CPU; and the Panda with its hand (9 joints, a
branched tree with two prismatic fingers): the port's plain solve against
the JAX fixture ``torch_port_hand9_b64.npz`` and its compiled solve on the
CPU."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu.models.panda import make_panda_model as jmake_panda_model
from mpc_motion_planner_tpu.models.urdf import parse_urdf as jparse_urdf
from mpc_motion_planner_tpu.ocp import make_ocp as jmake_ocp
from mpc_motion_planner_tpu.ops.pallas.constraints_kernel import bake_model as jbake_model
from mpc_motion_planner_tpu_torch import config, kernels
from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
from mpc_motion_planner_tpu_torch.kernels import constraints as k1
from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
from mpc_motion_planner_tpu_torch.kernels.build import SMEM_LIMIT, CudaKernel, Geometry
from mpc_motion_planner_tpu_torch.models.panda import (
    _LIMIT_TENSORS, make_panda_limits, make_panda_model,
)
from mpc_motion_planner_tpu_torch.models.urdf import parse_urdf
from mpc_motion_planner_tpu_torch.ocp import make_ocp
from mpc_motion_planner_tpu_torch.ops import kinematics
from mpc_motion_planner_tpu_torch.ops.qp import QPSettings
from mpc_motion_planner_tpu_torch.ops.sqp import SQPSettings
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner
from mpc_motion_planner_tpu_torch.utils.capture import capture_solve

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
URDF6 = os.path.join(FIXTURES, "panda_joint7_fixed.urdf")
PANDA6_FIXTURE = os.path.join(FIXTURES, "torch_port_panda6_b64.npz")
HAND9_FIXTURE = os.path.join(FIXTURES, "torch_port_hand9_b64.npz")
sys.path.insert(0, FIXTURES)
import make_panda6_fixture as robots  # noqa: E402

MODEL_TENSORS = ("tree_rotation", "tree_translation", "axis", "mass", "com", "inertia",
                 "gravity")


def _close_models(a, b, atol):
    for f in MODEL_TENSORS:
        np.testing.assert_allclose(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                   rtol=0, atol=atol, err_msg=f)
    for name in ("panda_tool", "panda_link8"):
        fa, fb = a.frame(name), b.frame(name)
        assert int(fa.parent_joint) == int(fb.parent_joint)
        np.testing.assert_allclose(np.asarray(fa.translation), np.asarray(fb.translation),
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(np.asarray(fa.rotation), np.asarray(fb.rotation),
                                   rtol=0, atol=atol)


def test_urdf_reads_as_the_locked_panda_in_both_packages():
    """The committed file is what the fixture script writes; both packages
    read it as the same 6-joint serial revolute chain (343 variables, 421
    rows at 19 nodes), the tool on link 6, its height the Panda's for the
    same q1..q6 (the tool lies on joint 7's axis); with joint 7 revolute the
    file reads back as ``make_panda_model()`` in both packages (inertia to
    1.7e-18)."""
    with open(URDF6) as fh:
        assert fh.read() == robots.panda_urdf(lock_joint7=True)
    t6, j6 = parse_urdf(URDF6), jparse_urdf(URDF6)
    assert t6.nq == j6.nq == 6 and t6.is_serial and j6.is_serial
    assert t6.joint_names == tuple(f"panda_joint{i}" for i in range(1, 7))
    _close_models(t6, j6, 0.0)
    assert t6.frame("panda_tool").parent_joint == 5
    ocp = make_ocp(t6)
    assert (ocp.num_var, ocp.num_eq + ocp.num_ineq) == (343, 421)
    q7 = torch.as_tensor(np.random.default_rng(0).uniform(-2, 2, (16, 7)))
    h7 = kinematics.frame_height(make_panda_model(), q7, make_panda_model().frame("panda_tool"))
    h6 = kinematics.frame_height(t6, q7[:, :6], t6.frame("panda_tool"))
    np.testing.assert_allclose(h6.numpy(), h7.numpy(), rtol=0, atol=1e-12)
    urdf7 = robots.panda_urdf(lock_joint7=False)
    _close_models(parse_urdf(urdf7), make_panda_model(), 1e-17)
    _close_models(jparse_urdf(urdf7).astype(jnp.float64), jmake_panda_model(), 1e-17)


@pytest.mark.parametrize("nq", [6, 8])
def test_bake_model_matches_jax_at_other_joint_counts(nq):
    """Kernel 1's constant block of the 6-joint Panda and of a seeded
    8-joint chain: the JAX ``bake_model``'s constants, joint by joint, at
    float32; the refusals are the JAX ones (prismatic joints, branched
    trees), not the joint count."""
    urdf = URDF6 if nq == 6 else robots.chain_urdf(8, seed=8)
    tool = "panda_tool" if nq == 6 else "tool"
    tm, jm = parse_urdf(urdf), jparse_urdf(urdf)
    consts, parent = k1.bake_model(tm, tm.frame(tool))
    ref = jbake_model(jm, jm.frame(tool))
    assert ref["nj"] == nq and parent == ref["tool_parent"]
    flat = [np.ravel(j[k]) for j in ref["joints"]
            for k in ("R0", "t", "axis", "K", "K2", "mass", "mc", "Io")]
    flat += [np.ravel(ref["gravity"]), np.ravel(ref["tool_t"])]
    np.testing.assert_allclose(consts, np.concatenate(flat).astype(np.float32), rtol=0, atol=0)
    assert consts.size == nq * k1.JOINT_FLOATS + 6
    hand = parse_urdf(robots.panda_urdf(True, hand=True))
    assert hand.nq == 8 and not hand.is_serial
    with pytest.raises(NotImplementedError, match="revolute chains only"):
        k1.bake_model(hand, hand.frame("panda_tool"))
    serial = dataclasses.replace(hand, joint_types=(0,) * 8)
    with pytest.raises(NotImplementedError, match="serial chains only"):
        k1.bake_model(serial, serial.frame("panda_tool"))


def test_jacobian_split_by_joint_matches_jax_jacfwd_at_6_joints():
    """Kernel 1's work split (one pass per joint carrying the tangents along
    q_j, qdot_j, u_j) of the 6-joint Panda against the JAX package's
    ``jacfwd`` of its node constraints, float64, to 1e-10."""
    ocp = make_ocp(parse_urdf(URDF6))
    jo = jmake_ocp(jparse_urdf(URDF6).astype(jnp.float64), dtype=jnp.float64)
    rng = np.random.default_rng(6)
    xu = np.concatenate([rng.uniform(-2.5, 2.5, (3, 4, 6)), rng.uniform(-2, 2, (3, 4, 6)),
                         rng.uniform(-10, 10, (3, 4, 6))], -1)
    X, U = torch.as_tensor(xu[..., :12]), torch.as_tensor(xu[..., 12:])
    got = k1.node_jacobians_by_joint(ocp, X, U)
    jac = jax.vmap(jax.jacfwd(lambda v: jo.node_constraints(v[:12], v[12:])))
    ref = np.asarray(jac(jnp.asarray(xu.reshape(-1, 18)))).reshape(3, 4, 7, 18)
    assert got.shape == (3, 4, 7, 18)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ocp.node_jacobians(X, U).numpy(), ref, rtol=0, atol=1e-10)


def _limits6(dtype=torch.float64):
    lim = make_panda_limits(dtype)
    return dataclasses.replace(lim, **{k: getattr(lim, k)[:6] for k in _LIMIT_TENSORS})


def test_plain_6_joint_solve_matches_the_jax_fixture():
    """The port's plain solve of the first 8 fixture states, the 6-joint
    Panda with the Panda's first six limits, in the fixture's configuration
    (structured QP, fixed rho, budgets 700/500), float64 on the CPU: the
    JAX solve's z to 1e-8 (2.46e-11 measured) and the same qp_converged."""
    fx = np.load(PANDA6_FIXTURE)
    hs = np.load(os.path.join(FIXTURES, "headline_states_b2048.npz"))
    for k in ("current", "target"):
        np.testing.assert_array_equal(fx[k], hs[k][:64][:, list(robots.KEEP6)])
    planner = MotionPlanner(
        model=parse_urdf(URDF6), limits=_limits6(), margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
        qp_settings=QPSettings(backend="structured", kkt_refine=0, rho_update_every=0,
                               ruiz_iters=2, rho=0.1, alpha=1.6, check_every=25, max_iter=700),
        sqp_settings=SQPSettings(qp_step_schedules="200,500;150,350"), device="cpu")
    n = 8
    as64 = lambda k: torch.as_tensor(fx[k][:n].astype(np.float64))
    sol = planner.solve(as64("current"), as64("target"))
    assert sol.z.shape == (n, 343)
    np.testing.assert_allclose(sol.z.numpy(), fx["z"][:n], rtol=0, atol=1e-8)
    assert sol.qp_converged.tolist() == fx["qp_converged"][:n].tolist()
    np.testing.assert_allclose(sol.final_time.numpy(), fx["final_time"][:n], rtol=1e-10)


@pytest.mark.parametrize("nq", [6, 7, 8, 9, 10])
def test_geometry_at_other_joint_counts(nq):
    """A geometry's flags carry the joint count, from which common.cuh
    derives the rest (2 nq states, nq controls, nq + 1 rows, blocks of 3
    nq); kernel 1, 2 and 3 libraries are named by it. Kernel 3's block at 19
    nodes: full layout at 6 and 7 joints, compact at 8, and at 9 and 10
    joints (267,216 and 321,344 B even compact) the split layout, 185,680
    and 220,640 B. Kernel 2's problems per SM (shared memory and
    registers): 7, 6, 5, 4, 3."""
    g = Geometry(nq=nq)
    assert g.flags() == ("-DMPC_SEGMENTS=6", "-DMPC_ORDER=3", f"-DMPC_NQ={nq}")
    assert (g.nx, g.nu, g.ng, g.blk) == (2 * nq, nq, nq + 1, 3 * nq)
    assert (g.num_var, g.num_rows) == (57 * nq + 1, 48 * nq + 19 * (nq + 1))
    band = torch.empty(1, 19, 4, 3 * nq, 3 * nq, device="meta")
    assert Geometry.of_band(band) == g
    for k in (k1.KERNEL, k2.KERNEL, k3.KERNEL):
        assert f"-DMPC_NQ={nq}" in k.flags(g) and f"_q{nq}_" in k.library_path(g).name
    assert k2.per_sm(g) == {6: 7, 7: 6, 8: 5, 9: 4, 10: 3}[nq]
    full, threads = {6: (152800, 448), 7: (198976, 512), 8: (250432, 576),
                     9: (308464, 640), 10: (372400, 704)}[nq]
    assert k3.smem_bytes(g, "full") == full and k3.threads(g) == threads
    assert k3.vpad(g) == -(-3 * nq // 4) * 4
    k1.check_fits(nq)
    k2.check_fits(g)
    k3.check_fits(g)
    assert k3.smem_bytes(g) <= SMEM_LIMIT
    layout = {6: "full", 7: "full", 8: "compact", 9: "split", 10: "split"}[nq]
    assert k3.choose_layout(g) == layout and (k3.smem_bytes(g) < full) == (nq >= 8)
    if nq >= 9:
        assert (k3.smem_bytes(g, "compact"), k3.smem_bytes(g)) == {
            9: (267216, 185680), 10: (321344, 220640)}[nq]
        with pytest.raises(ValueError, match=rf"{nq} joints .* needs {k3.smem_bytes(g, 'compact')} "
                                             rf"B of shared memory per block in its compact"):
            k3.check_fits(dataclasses.replace(g, layout="compact"))


def test_kernel_fit_checks_beyond_the_joint_counts_they_take():
    """Kernel 1 takes up to 21 joints (its robot in a launch's 4 KB of
    parameters; 22 joints need 4,136 B), kernel 2 at 19 nodes up to 19
    (two rows of a block a lane past 10; 20 joints need 254,196 B of shared
    memory); kernels 2 and 3 take splines of orders 2, 4 and 5 at 6 joints and order
    4 at 5 segments and 8 joints (kernel 3 in its split layout, 183,232 B);
    9 and 10 joints at 25 nodes (284,880 B split for 10) take kernel 3's
    stream layout, 187,440 and 220,112 B; 9 joints at 31 nodes (1030 rows)
    take it at two z elements and rows a thread, 544 threads, 223,952 B; 10
    joints at 28 nodes (241,184 B stream) take the lean layout, 182,192 B,
    and so do 10 joints at 37 nodes (704 threads, 226,864 B); 10 joints at
    40 nodes (241,760 B lean) take the far layout, 188,960 B, and so do 10
    joints at 49 nodes (928 threads, 221,744 B); 10 joints at 52 nodes
    (232,688 B far) take the deep layout, 164,880 B, and so do 10 joints at
    88 nodes (four z elements and rows a thread, 832 threads, 228,688 B); 10
    joints at 91 nodes (234,016 B deep) take the pair layout, rank 0 183,584
    B and rank 1 101,088 B, and so do 10 joints at 118 nodes (five z elements
    and rows a thread, 896 threads, rank 0 231,520 B); 10 joints at 121
    nodes need 236,848 B even in rank 0 of the pair layout and raise naming
    them before any build; a library kind that is none of the three
    raises."""
    k1.check_fits(21)
    with pytest.raises(ValueError, match=r"22 joints needs 4136 B of launch parameters"):
        k1.check_fits(22)
    k2.check_fits(Geometry(nq=19))
    with pytest.raises(ValueError, match=r"19 nodes, band width 3 and 20 joints needs 254196 B "
                                         r"of shared memory per block"):
        k2.check_fits(Geometry(nq=20))
    for order, segments in ((2, 9), (4, 4), (5, 3)):
        for check in (k2.check_fits, k3.check_fits):
            check(Geometry(order=order, segments=segments, nq=6))
    g = Geometry(order=4, segments=5, nq=8)
    assert (k3.choose_layout(g), k3.smem_bytes(g)) == ("split", 183232)
    k3.check_fits(g)
    for nq, (threads, split, stream) in {9: (832, 239920, 187440),
                                         10: (928, 284880, 220112)}.items():
        g = Geometry(segments=8, nq=nq)
        assert (k3.threads(g), k3.smem_bytes(g, "split"), k3.smem_bytes(g)) == (
            threads, split, stream)
        assert k3.choose_layout(g) == "stream"
        k3.check_fits(g)
        k2.check_fits(g)
    g = Geometry(segments=10, nq=9)
    assert (k3.ept_of(g), k3.threads(g), k3.smem_bytes(g)) == (2, 544, 223952)
    assert k3.choose_layout(g) == "stream"
    k3.check_fits(g)
    k2.check_fits(g)
    g = Geometry(segments=9, nq=10)
    assert (k3.threads(g), k3.smem_bytes(g, "stream"), k3.smem_bytes(g)) == (544, 241184, 182192)
    with pytest.raises(ValueError, match=r"28 nodes, order 3 and 10 joints .* needs 241184 B "
                                         r"of shared memory per block in its stream layout"):
        k3.check_fits(dataclasses.replace(g, layout="stream"))
    g37 = Geometry(segments=12, nq=10)
    assert (k3.threads(g37), k3.smem_bytes(g37)) == (704, 226864)
    for g in (g, g37):
        assert k3.choose_layout(g) == "lean"
        k3.check_fits(g)
        k2.check_fits(g)
    g, g49 = Geometry(segments=13, nq=10), Geometry(segments=16, nq=10)
    assert (k3.threads(g), k3.smem_bytes(g, "lean"), k3.smem_bytes(g)) == (768, 241760, 188960)
    assert (k3.threads(g49), k3.smem_bytes(g49)) == (928, 221744)
    with pytest.raises(ValueError, match=r"40 nodes, order 3 and 10 joints .* needs 241760 B "
                                         r"of shared memory per block in its lean layout"):
        k3.check_fits(dataclasses.replace(g, layout="lean"))
    for g in (g, g49):
        assert k3.choose_layout(g) == "far"
        k3.check_fits(g)
        k2.check_fits(g)
    g, g88 = Geometry(segments=17, nq=10), Geometry(segments=29, nq=10)
    assert (k3.threads(g), k3.smem_bytes(g, "far"), k3.smem_bytes(g)) == (992, 232688, 164880)
    assert (k3.ept_of(g88), k3.threads(g88), k3.smem_bytes(g88)) == (4, 832, 228688)
    with pytest.raises(ValueError, match=r"52 nodes, order 3 and 10 joints .* needs 232688 B "
                                         r"of shared memory per block in its far layout"):
        k3.check_fits(dataclasses.replace(g, layout="far"))
    for g in (g, g88):
        assert k3.choose_layout(g) == "deep"
        k3.check_fits(g)
        k2.check_fits(g)
    g, g118 = Geometry(segments=30, nq=10), Geometry(segments=39, nq=10)
    assert (k3.threads(g), k3.smem_bytes(g, "deep"), k3.rank_bytes(g)) == (
        864, 234016, (183584, 101088))
    assert (k3.ept_of(g118), k3.threads(g118), k3.rank_bytes(g118)) == (5, 896, (231520, 101088))
    with pytest.raises(ValueError, match=r"91 nodes, order 3 and 10 joints .* needs 234016 B "
                                         r"of shared memory per block in its deep layout"):
        k3.check_fits(dataclasses.replace(g, layout="deep"))
    for g in (g, g118):
        assert k3.choose_layout(g) == "pair" and k3.smem_bytes(g) == k3.rank_bytes(g)[0]
        k3.check_fits(g)
        k2.check_fits(g)
    g = Geometry(segments=40, nq=10)
    assert (k3.threads(g), k3.smem_bytes(g)) == (928, 236848)
    with pytest.raises(ValueError, match=r"121 nodes, order 3 and 10 joints .* needs 236848 B "
                                         r"of shared memory per block in its pair layout \(rank "
                                         r"0 236848 B, rank 1 101088 B;"):
        k3.check_fits(g)
    k2.check_fits(g)
    with pytest.raises(ValueError, match="per_geometry"):
        CudaKernel("x", "x.cu", "x", [], per_geometry="nodes")


def _six_joint_ocp(**kw):
    return make_ocp(parse_urdf(URDF6), **kw)


def test_fused_constraints_is_validated_and_read_once(monkeypatch):
    """``make_ocp`` reads ``MPC_TPU_FUSED_CONSTRAINTS`` once, at
    construction, as the JAX package does; an explicit argument wins; a
    value other than auto/on/off raises. The planner's OCP takes it up."""
    monkeypatch.delenv("MPC_TPU_FUSED_CONSTRAINTS", raising=False)
    assert _six_joint_ocp().fused_constraints == "auto"
    monkeypatch.setenv("MPC_TPU_FUSED_CONSTRAINTS", "off")
    ocp = _six_joint_ocp()
    planner = MotionPlanner(model=parse_urdf(URDF6), limits=_limits6(), device="cpu")
    assert ocp.fused_constraints == planner.ocp.fused_constraints == "off"
    assert _six_joint_ocp(fused_constraints="on").fused_constraints == "on"
    monkeypatch.setenv("MPC_TPU_FUSED_CONSTRAINTS", "auto")
    assert ocp.fused_constraints == "off"  # read at construction only
    for bad in ("yes", "ON", ""):
        with pytest.raises(ValueError, match="auto/on/off"):
            _six_joint_ocp(fused_constraints=bad)
    monkeypatch.setenv("MPC_TPU_FUSED_CONSTRAINTS", "fused")
    with pytest.raises(ValueError, match="auto/on/off"):
        _six_joint_ocp()


def test_fused_constraints_routes_the_constraint_rows(monkeypatch):
    """"auto": kernel 1 on CUDA, the plain path on the CPU; "on": kernel 1,
    which refuses CPU tensors; "off": the plain path everywhere, so kernel
    1 is never called and a model it refuses (a hand with two prismatic
    fingers, a branched tree) is planned. The headline reports what ran."""
    z = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (2, 343)))
    auto, on, off = (_six_joint_ocp(fused_constraints=m) for m in ("auto", "on", "off"))
    assert [o.uses_kernel("cuda") for o in (auto, on, off)] == [True, True, False]
    assert [o.uses_kernel("cpu") for o in (auto, on, off)] == [False, True, False]
    ref_g = auto.ineq_residual_batch(z)
    ref = auto.linearize_constraints_batch(z)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        on.ineq_residual_batch(z)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        on.linearize_constraints_batch(z)

    def refuse(*a, **kw):
        raise AssertionError("kernel 1 called")

    monkeypatch.setattr(k1, "node_constraints_kernel", refuse)
    assert torch.equal(off.ineq_residual_batch(z), ref_g)
    g, J = off.linearize_constraints_batch(z)
    assert torch.equal(g, ref[0]) and torch.equal(J, ref[1])
    hand = parse_urdf(robots.panda_urdf(True, hand=True))
    lim = _limits6()
    fingers = {"min_position": [0.0, 0.0], "max_position": [0.04, 0.04],
               "max_velocity": [0.2, 0.2], "max_acceleration": [1.0, 1.0],
               "max_jerk": [50.0, 50.0], "max_torque": [20.0, 20.0]}
    limits_h = dataclasses.replace(lim, **{
        k: torch.cat([getattr(lim, k), torch.tensor(fingers[k], dtype=torch.float64)])
        for k in _LIMIT_TENSORS})
    planner = MotionPlanner(model=hand, limits=limits_h, margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
                            qp_settings=config.SHIPPING_QP_SETTINGS,
                            sqp_settings=SQPSettings(qp_step_schedules="40,60;40,60"),
                            device="cpu")
    planner.ocp = make_ocp(hand, "panda_tool", fused_constraints="off")
    fx = np.load(PANDA6_FIXTURE)
    fingers0 = np.array([[0.01, 0.01]])
    cur = np.concatenate([fx["current"][:1, :6], fingers0, fx["current"][:1, 6:], 0 * fingers0], 1)
    tgt = np.concatenate([fx["target"][:1, :6], fingers0 + 0.02, fx["target"][:1, 6:],
                          0 * fingers0], 1)
    sol = planner.solve(torch.as_tensor(cur, dtype=torch.float64),
                        torch.as_tensor(tgt, dtype=torch.float64))
    assert sol.z.shape == (1, 457) and bool(torch.isfinite(sol.z).all())
    assert planner.ocp.uses_kernel("cuda") is False


def _hand_planner(qp_settings, sqp_settings):
    """The Panda with its hand (9 joints) with the Panda's limits and the
    fingers', planned under fused_constraints "off" as a user plans it, on
    the CPU at float64."""
    hand = parse_urdf(robots.panda_urdf(lock_joint7=False, hand=True))
    lim = make_panda_limits()
    limits = dataclasses.replace(lim, **{
        k: torch.cat([getattr(lim, k), torch.tensor(robots.FINGER_LIMITS[k], dtype=torch.float64)])
        for k in _LIMIT_TENSORS})
    planner = MotionPlanner(model=hand, limits=limits, margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
                            qp_settings=qp_settings, sqp_settings=sqp_settings, device="cpu")
    planner.ocp = make_ocp(hand, "panda_tool", fused_constraints="off")
    return planner


@pytest.fixture(scope="module")
def hand_solve():
    """The hand's JAX fixture, and the port's planner in the fixture's
    configuration (structured QP, fixed rho, no KKT refinement, budgets
    700/500) with its compiled solve (on the CPU, the eager one) and eager
    solve of the first two fixture states."""
    fx = np.load(HAND9_FIXTURE)
    planner = _hand_planner(
        QPSettings(backend="structured", kkt_refine=0, rho_update_every=0, ruiz_iters=2,
                   rho=0.1, alpha=1.6, check_every=25, max_iter=700),
        SQPSettings(qp_step_schedules="200,500;150,350"))
    n = 2
    cur, tgt = (torch.as_tensor(fx[k][:n].astype(np.float64)) for k in ("current", "target"))
    solve = capture_solve(planner, cur, tgt)
    return fx, planner, solve, solve(cur, tgt), planner.solve(cur, tgt), tgt


def test_hand_fixture_is_the_jax_solve(hand_solve):
    """The fixture holds the first 64 headline states with the fingers at
    0.01 m and 0.03 m and at rest, and the JAX ``structured`` solve of them
    for the 9-joint hand under fused_constraints "off"
    (``make_panda6_fixture.py --hand``); the port's plain solve of the first
    two at float64 matches its final times and iterates to rtol 1e-6, with
    the same qp_converged and qp_iterations, and lands in the target box."""
    fx, planner, _, _, sol, tgt = hand_solve
    hs = np.load(os.path.join(FIXTURES, "headline_states_b2048.npz"))
    for k, width in (("current", robots.FINGERS_CURRENT), ("target", robots.FINGERS_TARGET)):
        np.testing.assert_array_equal(fx[k], robots.hand_states(hs[k][:64], width))
    ocp = planner.ocp
    assert (ocp.nq, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (9, 514, 622)
    assert not planner.model.is_serial and not ocp.uses_kernel("cuda")
    assert fx["z"].shape == (64, 514) and fx["qp_converged"].shape == (64, 2)
    n = sol.z.shape[0]
    np.testing.assert_allclose(sol.final_time.numpy(), fx["final_time"][:n], rtol=1e-6)
    np.testing.assert_allclose(sol.z.numpy(), fx["z"][:n], rtol=1e-6, atol=1e-6)
    assert sol.qp_converged.tolist() == fx["qp_converged"][:n].tolist()
    np.testing.assert_array_equal(sol.qp_iterations.numpy(), fx["qp_iterations"][:n])
    err = (sol.x_at(1.0) - tgt).abs().amax(-1)
    assert bool((err <= planner.target_eps + planner.qp_settings.eps_abs).all())


def test_hand_capture_solve_on_cpu_is_the_eager_solve(hand_solve):
    """``capture_solve`` of a CPU hand planner is its eager solve: nothing
    captured, the Solution bitwise the eager one, no kernel launched."""
    _, _, solve, got, ref, _ = hand_solve
    assert solve.captured is False and not solve.graphs and solve.eager_resolves == 0
    for f in ("z", "lam_c", "lam_x", "violation", "qp_iterations", "qp_converged", "step_sizes"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert set(kernels.launch_counts().values()) == {0}
