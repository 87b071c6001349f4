"""PyTorch port, robots of more than 10 joints (blocks above 30 x 30, a lane
of a warp owning two rows of a block): kernel 1's tiles, launch parameters
and blocks per SM at 7 to 14 joints and its first refused joint count;
kernel 2's bytes and problems per SM at 11, 12 and 14 joints and its plain
version at blk 36 against the JAX package's node-level factor, its group
form and its Pallas kernel in interpret mode; kernel 3's block in each
layout at 11, 12 and 14 joints at every grid up to the first refused one,
the lean block of 12 joints at 19 nodes member by member; the seeded
12-joint chain's plain float64 solve against the JAX fixture
``torch_port_chain12_b64.npz`` (``make_chain12_fixture.py``), which
``chip_smoke.py`` phase 29 holds the card against; and kernel 1's
constants and plain version at 12 joints against the JAX package's."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu.models.urdf import parse_urdf as jparse_urdf
from mpc_motion_planner_tpu.ocp import make_ocp as jmake_ocp
from mpc_motion_planner_tpu.ops import qp_structured as jqs
from mpc_motion_planner_tpu.ops.pallas.banded_factor import factor_banded_pallas
from mpc_motion_planner_tpu.ops.pallas.constraints_kernel import bake_model as jbake_model
from mpc_motion_planner_tpu_torch.bench.convergence import chain
from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
from mpc_motion_planner_tpu_torch.kernels import constraints as k1
from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
from mpc_motion_planner_tpu_torch.kernels.build import LAYOUTS, SMEM_LIMIT, Geometry
from mpc_motion_planner_tpu_torch.models.urdf import parse_urdf
from mpc_motion_planner_tpu_torch.ocp import make_ocp
from mpc_motion_planner_tpu_torch.ops import qp_structured as tqs
from mpc_motion_planner_tpu_torch.ops.qp import QPSettings
from mpc_motion_planner_tpu_torch.ops.sqp import SQPSettings
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CHAIN12_FIXTURE = os.path.join(FIXTURES, "torch_port_chain12_b64.npz")
sys.path.insert(0, FIXTURES)
import make_panda6_fixture as robots  # noqa: E402

# kernel 1's Jacobian tiles (bytes of dynamic shared memory) by joint count
K1_TILES = {7: 25984, 8: 32512, 9: 40064, 10: 48128, 11: 57216, 12: 66816, 13: 77440,
            14: 88576}


@pytest.mark.parametrize("nq", list(K1_TILES))
def test_kernel1_fits_past_ten_joints(nq):
    """Kernel 1's Jacobian launch keeps its tiles in dynamic shared memory,
    which the library's init lets it take: 48,128 B at 10 joints (all a
    block's static shared memory could hold), 57,216 B at 11 and 66,816 B at
    12; two blocks share an SM at each of 7 to 14 joints, and the robot's
    parameters stay inside a launch's 4 KB; every count plans."""
    assert k1.smem_bytes(nq) == K1_TILES[nq]
    assert k1.blocks_bound(nq) == 2
    assert k1.param_bytes(nq) == 184 * nq + 88 <= k1.PARAM_LIMIT
    k1.check_fits(nq)
    assert k1.KERNEL.init == "mpc_constraints_init"
    assert f"-DMPC_NQ={nq}" in k1.KERNEL.flags(Geometry(nq=nq))


def test_kernel1_first_refused_joint_count_names_its_bytes():
    """Two blocks of the Jacobian launch share an SM up to 16 joints
    (113,408 B of tiles), one from 17; 21 joints fit (3,952 B of
    parameters, 189,056 B of tiles) and 22 joints raise before any build,
    naming the 4,136 B of parameters a launch would need (the robot travels
    by value, 46 floats a joint)."""
    assert (k1.blocks_bound(16), k1.blocks_bound(17)) == (2, 1)
    assert (k1.smem_bytes(16), k1.smem_bytes(21), k1.param_bytes(21)) == (113408, 189056, 3952)
    k1.check_fits(21)
    with pytest.raises(ValueError, match=r"22 joints needs 4136 B of launch parameters"):
        k1.check_fits(22)


@pytest.mark.parametrize("nq, smem, per_sm", [(11, 79740, 2), (12, 93876, 2), (14, 126948, 1)])
def test_kernel2_past_ten_joints(nq, smem, per_sm):
    """Kernel 2 at 19 nodes past 10 joints: a lane of the Cholesky warp owns
    two rows of a block (blk 33 to 63), its scratch row 64 floats; the
    working set and the problems per SM its registers are capped for (by
    shared memory: two up to 13 joints, one from 14)."""
    g = Geometry(nq=nq)
    assert k2.rows(g) == 2 and k2.column_stride(g) == -(-3 * nq // 4) * 4
    assert (k2.smem_bytes(g), k2.per_sm(g)) == (smem, per_sm)
    k2.check_fits(g)
    assert k2.rows(Geometry(nq=10)) == 1 and k2.rows(Geometry(nq=21)) == 2


def test_kernel2_first_refused_joint_count_names_its_bytes():
    """At 19 nodes kernel 2 takes up to 19 joints (230,556 B) and refuses 20
    before any build, naming the 254,196 B a block would need."""
    k2.check_fits(Geometry(nq=19))
    assert k2.smem_bytes(Geometry(nq=19)) == 230556
    with pytest.raises(ValueError, match=r"20 joints needs 254196 B of shared memory"):
        k2.check_fits(Geometry(nq=20))


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
    return Mband, rng.standard_normal((n, N, blk)), np.full(n, 1e4)


def test_factor_banded_blk36_matches_jax():
    """The plain kernel 2 and its schedule (``factor_banded_ring``) at blk
    36 (12 joints), band width 3, on a seeded 7-node band at float64: the
    JAX node-level factor's Ldi, Lsub, u and s to 1e-9, and the Schur
    scalar of its group form (``factor_arrow``); a problem with an
    indefinite first block is flagged alone."""
    Mband, pc, mpp = _band(7, 3, 36, 3, seed=36)
    Mband[1, 0, 0, 0, 0] = -1.0
    ref = {k: np.asarray(v) for k, v in
           jqs.factor_banded(*(jnp.asarray(a) for a in (Mband, pc, mpp)), 3).items()}
    arrow = jqs.factor_arrow(*(jnp.asarray(a) for a in (Mband, pc, mpp)), 3)
    good = [0, 2]
    for factor in (tqs.factor_banded, tqs.factor_banded_ring):
        got = factor(*(torch.as_tensor(a) for a in (Mband, pc, mpp)), 3)
        assert got["ok"].tolist() == [True, False, True]
        for k in ("Ldi", "Lsub", "u", "s"):
            np.testing.assert_allclose(got[k][good].numpy(), ref[k][good], rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(got["s"][good].numpy(), np.asarray(arrow["s"])[good],
                                   rtol=1e-9)


def test_factor_banded_blk36_matches_pallas_interpret():
    """Kernel 2's schedule at blk 36 (float32) against the JAX package's
    Pallas factor kernel in interpret mode (lanes=4) on a seeded 2-node band
    of band width 1 whose problem 1 has an indefinite first block (the
    interpreter unrolls each node's 36-column Cholesky and inverse, ~12 s a
    node; the band at width 3 is held against the JAX node-level factor
    above): the same ok flags, and the factors of the ok problems to float32
    rounding."""
    Mband, pc, mpp = _band(2, 1, 36, 4, seed=12)
    Mband[1, 0, 0, 0, 0] = -1.0
    fac, ok = factor_banded_pallas(jnp.asarray(Mband), jnp.asarray(pc), jnp.asarray(mpp), 1,
                                   lanes=4)
    got = tqs.factor_banded_ring(*(torch.as_tensor(a, dtype=torch.float32)
                                   for a in (Mband, pc, mpp)), 1)
    assert np.asarray(ok).tolist() == got["ok"].tolist() == [True, False, True, True]
    good = [0, 2, 3]
    ref = {"Ldi": np.asarray(fac["Ldi"]), "Lsub": np.moveaxis(np.asarray(fac["Lsub_t"]), 1, 2),
           "u": np.asarray(fac["u"]), "s": np.asarray(fac["s"])}
    for k in ("Ldi", "Lsub", "u", "s"):
        r = ref[k][good]
        np.testing.assert_allclose(got[k][good].numpy(), r, rtol=0, atol=2e-5 * np.abs(r).max())


# kernel 3 by joint count: per segment count of order 3, (layout, bytes in
# it, threads, z elements and rows a thread), up to the first grid that fits
# no layout (its bytes in rank 0 of the pair layout, the larger block,
# threads, ept)
K3_GRIDS = {
    11: ({2: ("full", 162320, 288, 1), 3: ("full", 232304, 384, 1),
          4: ("split", 183472, 512, 1), 5: ("split", 221008, 640, 1),
          6: ("stream", 206272, 768, 1), 7: ("stream", 230720, 896, 1),
          8: ("lean", 197392, 1024, 1), 9: ("lean", 214528, 576, 2),
          10: ("lean", 231920, 640, 2), 11: ("far", 195456, 704, 2),
          13: ("far", 220720, 832, 2), 14: ("deep", 171808, 896, 2),
          17: ("deep", 189344, 736, 3), 24: ("deep", 230592, 1024, 3),
          25: ("pair", 175296, 800, 4), 34: ("pair", 228176, 864, 5)},
         (35, 234064, 896, 5)),
    12: ({2: ("full", 189920, 288, 1), 3: ("compact", 220704, 448, 1),
          4: ("split", 212160, 576, 1), 5: ("stream", 208752, 704, 1),
          6: ("lean", 188768, 832, 1), 7: ("lean", 208784, 960, 1),
          8: ("lean", 228512, 576, 2), 9: ("far", 196064, 640, 2),
          11: ("far", 224768, 768, 2), 12: ("deep", 182112, 832, 2),
          16: ("deep", 207360, 736, 3), 19: ("deep", 226416, 864, 3),
          20: ("pair", 160144, 928, 3), 31: ("pair", 229680, 864, 5)},
         (32, 236016, 896, 5)),
    14: ({2: ("compact", 192832, 352, 1), 3: ("split", 220688, 512, 1),
          4: ("lean", 196736, 672, 1), 5: ("lean", 222624, 800, 1),
          6: ("far", 200640, 960, 1), 7: ("far", 218704, 576, 2),
          8: ("deep", 203248, 640, 2), 11: ("deep", 225648, 896, 2),
          12: ("pair", 197856, 960, 2), 25: ("pair", 230736, 992, 4)},
         (26, 238080, 832, 5)),
}


@pytest.mark.parametrize("nq", list(K3_GRIDS))
def test_kernel3_layouts_past_ten_joints(nq):
    """Kernel 3 at 11, 12 and 14 joints over every grid of order 3 from 2
    segments: each takes the first layout whose block fits (so past 10
    joints every one of the eight is taken somewhere), two rows a lane, the
    bytes, threads and z elements a thread of the reckoning at the grids
    listed (the pair layout's: its larger block, rank 0's but at 14 joints x
    12), and the first grid that fits no layout raises before any build,
    naming each rank's bytes and every other layout's."""
    grids, (first, rank0, threads, ept) = K3_GRIDS[nq]
    seen = set()
    for segments in range(2, first):
        g = Geometry(segments=segments, nq=nq)
        layout = k3.choose_layout(g)
        fits = [k3.smem_bytes(g, name) <= SMEM_LIMIT for name in LAYOUTS]
        assert fits.index(True) == LAYOUTS.index(layout), (segments, layout)
        assert k3.rows(g) == 2 and k3.vpad(g) == -(-3 * nq // 4) * 4
        k3.check_fits(g)
        seen.add(layout)
        if segments in grids:
            assert (layout, k3.smem_bytes(g), k3.threads(g), k3.ept_of(g)) == grids[segments]
    assert seen == set(LAYOUTS) - ({"compact"} if nq == 11 else {"full", "stream"}
                                   if nq == 14 else set())
    g = Geometry(segments=first, nq=nq)
    assert (k3.smem_bytes(g), k3.threads(g), k3.ept_of(g)) == (rank0, threads, ept)
    assert k3.rank_bytes(g)[0] == rank0
    others = ", ".join(f"{name}: {k3.smem_bytes(g, name)} B" for name in LAYOUTS[:-1])
    with pytest.raises(ValueError) as err:
        k3.check_fits(g)
    assert (f"needs {rank0} B of shared memory per block in its pair layout (rank 0 {rank0} B, "
            f"rank 1 {k3.rank_bytes(g)[1]} B; {others})" in str(err.value))


def test_kernel3_lean_block_at_12_joints_member_by_member():
    """Kernel 3's block of 12 joints at 19 nodes (its main path past 10
    joints), member by member: the lean layout's, blocks of 36 x 36 (a node
    vector of 36 floats, nine 16-byte loads), a ring of four runs of three
    blocks, 832 threads at one element a thread."""
    g = Geometry(nq=12)
    N, blk, nv, neq, nm = g.nodes, 36, g.num_var, g.num_eq, g.num_rows
    assert (N, nv, nm, k3.threads(g), k3.vpad(g)) == (19, 685, 823, 832, 36)
    slot = -(-(3 * blk * blk + 3) // 4) * 4
    members = [
        (N * blk * (blk + 1) // 2, 4),  # Ldi, packed
        (3 + 4 * (slot + 2) + 1, 4),  # Lsub: the ring of 4 runs, barriers, progress
        (N * blk, 4), (N * 13 * blk, 4), (neq, 4),  # u, J, fseg
        *[(1, 4)] * 6, (nv, 4), *[(1, 4)] * 5,  # qs .. thx, D, rc .. thr
        *[(1, 4)] * 5,  # x, zx, yx, zc, yc
        (nv, 4), (nm, 4), (nv, 4),  # t0, wa, rhs
        (N * 36, 16), (N * 36, 16), (36, 16),  # ys, xs, tb
        (2 * N * blk, 4),  # ahead
        (nv, 4), (nv, 4), (nm, 4), (nm, 4),  # xt, dx, wb, wc
        (832 // 32 * 4, 4), (16, 4), (1, 4), (1, 4), (1, 4),  # red, Dm, p, s, done
    ]
    off = 0
    for floats, align in members:
        off = -(-off // align) * align + 4 * floats
    assert -(-off // 16) * 16 == k3.smem_bytes(g) == k3.smem_bytes(g, "lean") == 188768
    assert k3.smem_bytes(g, "stream") > SMEM_LIMIT and k3.choose_layout(g) == "lean"
    assert k3.KERNEL.geometry(g).flags()[-2:] == ("-DMPC_SMEM_LAYOUT=4", "-DMPC_EPT=1")


def _chain12_planner():
    """The seeded 12-joint chain as ``bench/convergence.py`` ``chain`` builds
    it, planned on the CPU at float64 in the fixture's configuration
    (structured QP, fixed rho, no KKT refinement, budgets 700/500), no floor
    for its tool."""
    model, limits, tool, _, _ = chain(12, 1, torch.float64, torch.device("cpu"))
    planner = MotionPlanner(
        model=model, limits=limits, tool_frame=tool, margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
        qp_settings=QPSettings(backend="structured", kkt_refine=0, rho_update_every=0,
                               ruiz_iters=2, rho=0.1, alpha=1.6, check_every=25, max_iter=700),
        sqp_settings=SQPSettings(qp_step_schedules="200,500;150,350"), device="cpu")
    planner.set_min_height(-10.0)
    return planner


def test_chain12_plain_solve_matches_the_jax_fixture():
    """The fixture holds the first 64 states of the seeded 12-joint chain
    (``chain(12, ...)`` at float32) and the JAX ``structured`` solve of them
    at 19 nodes (685 variables, 823 rows; none of its QPs converges within
    the budgets, at float64 either), with the JAX float32 solve's final
    times; the port's plain float64 solve of the first two matches its final
    times and iterates to rtol 1e-6, with the same qp_converged and
    qp_iterations, and lands in the target box."""
    fx = np.load(CHAIN12_FIXTURE)
    _, _, _, cur, tgt = chain(12, 64, torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(fx["current"], cur.numpy())
    np.testing.assert_array_equal(fx["target"], tgt.numpy())
    assert fx["z"].shape == (64, 685) and fx["final_time_float32"].shape == (64,)
    planner = _chain12_planner()
    ocp = planner.ocp
    assert (ocp.nq, ocp.num_var, ocp.num_eq + ocp.num_ineq) == (12, 685, 823)
    n = 2
    cur, tgt = (torch.as_tensor(fx[k][:n].astype(np.float64)) for k in ("current", "target"))
    sol = planner.solve(cur, tgt)
    np.testing.assert_allclose(sol.final_time.numpy(), fx["final_time"][:n], rtol=1e-6)
    np.testing.assert_allclose(sol.z.numpy(), fx["z"][:n], rtol=1e-6, atol=1e-6)
    assert sol.qp_converged.tolist() == fx["qp_converged"][:n].tolist()
    np.testing.assert_array_equal(sol.qp_iterations.numpy(), fx["qp_iterations"][:n])
    err = (sol.x_at(1.0) - tgt).abs().amax(-1)
    assert bool((err <= planner.target_eps + planner.qp_settings.eps_abs).all())


def test_plain_kernel1_at_12_joints_matches_jax():
    """Kernel 1 at 12 joints on the CPU: its constant block of the seeded
    12-joint chain is the JAX ``bake_model``'s, joint by joint, at float32
    (the CUDA kernel reads nothing else of the robot), and its plain version
    (values, 13 x 36 Jacobians, and the work split by joint that the kernel
    runs) the JAX package's node constraints and their ``jacfwd`` at
    float64, to 1e-10, on seeded iterates of 3 x 4 nodes. The JAX fused
    kernel is held to that same ``jacfwd`` path by the JAX package's own
    test at 7 joints (184 s in interpret mode there); at 12 joints its
    interpreter takes longer than 200 s even without the Jacobian."""
    urdf = robots.chain_urdf(12, seed=12)
    tm, jm = parse_urdf(urdf), jparse_urdf(urdf)
    consts, parent = k1.bake_model(tm, tm.frame("tool"))
    ref = jbake_model(jm, jm.frame("tool"))
    assert ref["nj"] == 12 and parent == ref["tool_parent"] == 11
    flat = [np.ravel(j[k]) for j in ref["joints"]
            for k in ("R0", "t", "axis", "K", "K2", "mass", "mc", "Io")]
    flat += [np.ravel(ref["gravity"]), np.ravel(ref["tool_t"])]
    np.testing.assert_allclose(consts, np.concatenate(flat).astype(np.float32), rtol=0, atol=0)
    ocp = make_ocp(tm, "tool")
    jo = jmake_ocp(jm.astype(jnp.float64), "tool", dtype=jnp.float64)
    rng = np.random.default_rng(12)
    xu = np.concatenate([rng.uniform(-2.5, 2.5, (3, 4, 12)), rng.uniform(-2, 2, (3, 4, 12)),
                         rng.uniform(-10, 10, (3, 4, 12))], -1)
    X, U = torch.as_tensor(xu[..., :24]), torch.as_tensor(xu[..., 24:])
    g, J = k1.node_constraints_plain(ocp, X, U, True)
    flat_xu = jnp.asarray(xu.reshape(-1, 36))
    value = lambda v: jo.node_constraints(v[:24], v[24:])
    J_ref, g_ref = jax.vmap(jax.jacfwd(lambda v: (value(v), value(v)), has_aux=True))(flat_xu)
    assert g.shape == (3, 4, 13) and J.shape == (3, 4, 13, 36)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref).reshape(3, 4, 13), rtol=0,
                               atol=1e-10)
    for got in (J, k1.node_jacobians_by_joint(ocp, X, U)):
        np.testing.assert_allclose(got.numpy(), np.asarray(J_ref).reshape(3, 4, 13, 36), rtol=0,
                                   atol=1e-10)
