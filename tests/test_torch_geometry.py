"""PyTorch port, transcriptions other than the 19-node one: the plain
structured QP at 8 and 4 spline segments against the JAX ``structured``
backend (float64); the geometry of a kernel library (its ``-D`` flags, one
library per geometry, kernel 3's shared memory reckoned member by member,
a geometry that does not fit raising); the compiled solve's key after the
planner's OCP is swapped; and the 8-segment JAX fixture that ``chip_smoke.py``
phase 19 holds the card against."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu.models.panda import make_panda_model as jmake_panda_model
from mpc_motion_planner_tpu.ocp import make_ocp as jmake_ocp
from mpc_motion_planner_tpu.ops import qp_structured as jqs
from mpc_motion_planner_tpu.ops import structure as jstructure
from mpc_motion_planner_tpu.ops.qp import QPSettings as JQPSettings
from mpc_motion_planner_tpu_torch import config, kernels
from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
from mpc_motion_planner_tpu_torch.kernels.build import BUILD_DIR, CSRC, SMEM_LIMIT, Geometry
from mpc_motion_planner_tpu_torch.ocp import make_ocp
from mpc_motion_planner_tpu_torch.ops import qp_structured as tqs
from mpc_motion_planner_tpu_torch.ops.qp import QPSettings
from mpc_motion_planner_tpu_torch.ops.sqp import (
    SQPSettings, hessian_regularization_diag, qp_subproblem, soft_weights,
)
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner
from mpc_motion_planner_tpu_torch.utils.capture import capture_solve

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADLINE_STATES = os.path.join(ROOT, "tests", "fixtures", "headline_states_b2048.npz")
SEG8_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_seg8_b64.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)
B = 2


def _planner(segments=6):
    planner = MotionPlanner(
        margins=Margins(*MARGINS), qp_settings=config.SHIPPING_QP_SETTINGS,
        sqp_settings=SQPSettings(qp_step_schedules=config.SHIPPING_SQP_SCHEDULES),
        device="cpu")
    if segments != 6:
        planner.ocp = make_ocp(planner.model, planner.tool_frame, order=3,
                               num_segments=segments)
    return planner


def _states(n=B):
    hs = np.load(HEADLINE_STATES)
    return (torch.as_tensor(hs["current"][:n].astype(np.float64)),
            torch.as_tensor(hs["target"][:n].astype(np.float64)))


@pytest.mark.parametrize("segments", [8, 4], ids=["25_nodes", "13_nodes"])
def test_plain_structured_qp_matches_jax_at_other_transcriptions(segments):
    """The step-0 QPs of the first headline states at ``segments`` spline
    segments of order 3, through the port's plain structured solve and the
    JAX ``structured`` backend with the same transcription, fixed rho:
    the same x to 1e-8 (measured ~1e-11) and identical iteration counts."""
    planner = _planner(segments)
    ocp = planner.ocp
    assert ocp.num_nodes == 3 * segments + 1
    cur, tgt = _states()
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    _, _, sa, (h, lc, uc, lx, ux) = qp_subproblem(ocp, planner.nlp_bounds(cur, tgt), z0)
    P = hessian_regularization_diag(ocp, B, torch.float64, "cpu", planner.sqp_settings.reg_eps)
    sc, sx = soft_weights(ocp, planner.sqp_settings, B, torch.float64, "cpu")
    kw = dict(max_iter=700, rho_update_every=0, kkt_refine=0)
    got = tqs.solve_box_qp_structured(ocp, sa, P, h, lc, uc, lx, ux,
                                      QPSettings(backend="structured", **kw),
                                      soft_c=sc, soft_x=sx)
    jo = jmake_ocp(jmake_panda_model(), "panda_tool", order=3, num_segments=segments)
    j = lambda t: jnp.asarray(t.numpy())
    ref = jqs.solve_box_qp_structured(
        jo, jstructure.StructuredA(j(sa.p), j(sa.f_rows), j(sa.J)),
        *(j(a) for a in (P, h, lc, uc, lx, ux)), JQPSettings(**kw), soft_c=j(sc), soft_x=j(sx))
    assert got.x.shape == (B, ocp.num_var)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    assert got.converged.tolist() == np.asarray(ref.converged).tolist()


def test_geometry_flags_reproduce_common_cuh_defaults():
    """The 19-node geometry's -D flags are the defaults common.cuh falls
    back to, so a build without flags compiles the same code; the geometry
    of an OCP and of its banded KKT matrix agree."""
    text = (CSRC / "common.cuh").read_text()
    defaults = dict(re.findall(r"#define (MPC_\w+) (\d+)", text))
    flags = dict(f[2:].split("=") for f in Geometry().flags())
    assert flags == defaults and len(flags) == 3
    for segments in (4, 6, 8):
        g = Geometry.of_ocp(make_ocp(_planner().model, num_segments=segments))
        assert g == Geometry(segments=segments)
        assert (g.nodes, g.num_var, g.num_rows) == (
            3 * segments + 1, 21 * (3 * segments + 1) + 1, 56 * segments + 8 * (3 * segments + 1))
        band = torch.empty(1, g.nodes, 4, 21, 21, device="meta")
        assert Geometry.of_band(band) == g
    with pytest.raises(ValueError, match="no transcription"):
        Geometry.of_band(torch.empty(1, 20, 4, 21, 21, device="meta"))


def test_one_library_per_geometry():
    """Kernels 2 and 3 have a library per geometry, named by the hash of
    sources and flags (the 19-node one is the default's); kernel 1 has one
    per joint count and kernel 4 one whatever the geometry. No nvcc is
    needed to name them."""
    g19, g25, g13 = Geometry(), Geometry(segments=8), Geometry(segments=4)
    for k in (k2.KERNEL, k3.KERNEL):
        paths = {g: k.library_path(g) for g in (g19, g25, g13)}
        assert len(set(paths.values())) == 3
        assert k.library_path() == paths[g19]
        assert paths[g25].parent == BUILD_DIR and paths[g25].name.startswith(k.name + "_n25_")
        assert k.flags(g25)[-3:] == g25.flags() and "-DMPC_SEGMENTS=8" in k.flags(g25)
    k1 = kernels.KERNELS["constraints"]
    assert k1.library_path(g25) == k1.library_path() and k1.flags(g25)[-1] == "-DMPC_NQ=7"
    assert not any(f.startswith("-DMPC_SEGMENTS") for f in k1.flags(g25))
    k4 = kernels.KERNELS["admm_dense"]
    assert k4.library_path(g25) == k4.library_path() and not any(
        f.startswith("-DMPC") for f in k4.flags(g25))


def test_kernel_shared_memory_reckoning():
    """Kernel 3's block, member by member with the alignment of struct
    SmemLayout: the full layout at 19 (198,976 B; the members alone sum to
    198,960 B) and 13 nodes, the compact one at 25 nodes, where the full one
    would take 262,000 B. Kernel 2 keeps six problems per SM at 25 nodes."""
    g19, g25, g13 = Geometry(), Geometry(segments=8), Geometry(segments=4)
    assert (k3.threads(g19), k3.threads(g25), k3.threads(g13)) == (512, 672, 352)
    assert k3.smem_bytes(g19) == k3.smem_bytes(g19, False) == 198976
    assert k3.smem_bytes(g13) == k3.smem_bytes(g13, False) == 135968
    assert k3.smem_bytes(g25, False) == 262000 > SMEM_LIMIT
    assert k3.smem_bytes(g25) == k3.smem_bytes(g25, True) == 232176 <= SMEM_LIMIT
    # the packed Ldi and the 5 Lsub blocks never read, give or take the padding
    # before the 16-byte aligned members
    saved = k3.smem_bytes(g25, False) - k3.smem_bytes(g25, True)
    assert 0 <= saved - 4 * (25 * 210 + 5 * 441) < 16
    assert (k2.smem_bytes(g19), k2.smem_bytes(g25)) == (33580, 34588)
    assert 6 * (k2.smem_bytes(g25) + 1024) <= 233472  # an SM's 228 KB, 1 KB per block reserved


def test_unfit_geometry_raises_naming_the_bytes():
    """28 nodes do not fit kernel 3's block even in the compact layout: the
    fit check and the card's QP solve raise and name the bytes, before any
    build or launch and whatever the data, so nothing falls back to the
    plain loop."""
    g28 = Geometry(segments=9)
    with pytest.raises(ValueError, match=r"261152 B of shared memory.*232448 B"):
        k3.check_fits(g28)
    planner = _planner(9)
    cur, tgt = _states(1)
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    _, _, sa, args = qp_subproblem(planner.ocp, planner.nlp_bounds(cur, tgt), z0)
    P = hessian_regularization_diag(planner.ocp, 1, torch.float64, "cpu", 0.01)
    with pytest.raises(ValueError, match="261152 B"):
        k3.solve_box_qp_structured_cuda(planner.ocp, sa, P, *args, config.SHIPPING_QP_SETTINGS)
    k2.check_fits(g28)  # kernel 2's working set is per node


@pytest.fixture(scope="module")
def seg8_solve():
    """The port's planner with its OCP swapped for 8 segments, solved on the
    CPU at float64 on the first two states of the 8-segment JAX fixture, and
    the capture key before and after the swap."""
    fx = np.load(SEG8_FIXTURE)
    cur = torch.as_tensor(fx["current"][:B].astype(np.float64))
    tgt = torch.as_tensor(fx["target"][:B].astype(np.float64))
    planner = _planner()
    solve = capture_solve(planner, cur, tgt)
    args = {"current_state": cur, "target_state": tgt}
    key19 = solve._key(args, None)
    planner.ocp = make_ocp(planner.model, planner.tool_frame, order=3, num_segments=8)
    key25 = solve._key(args, None)
    kernels.reset_launch_counts()
    sol = solve(cur, tgt)
    counts = kernels.launch_counts()
    return fx, planner, sol, key19, key25, counts


def test_capture_key_follows_the_ocp(seg8_solve):
    """A planner whose OCP is swapped after a capture is another key, so
    the 19-node graph is never replayed for it; on the CPU the solve is the
    eager one, on the new transcription."""
    _, planner, sol, key19, key25, counts = seg8_solve
    assert key19 != key25 and key19[:-1] == key25[:-1]
    assert key25[-1] == Geometry(segments=8) and key19[-1] == Geometry()
    assert sol.z.shape == (B, 526) and sol.lam_c.shape == (B, 648)
    assert set(counts.values()) == {0}


def test_seg8_fixture_is_the_jax_solve_of_the_headline_states(seg8_solve):
    """The fixture holds the first 64 headline states and the JAX solve of
    them at 8 segments (``make_torch_seg8_fixture.py``); the port's plain
    solve of its first states matches its final times and iterates to the
    fixture's float32 rounding, and lands in the target box."""
    fx, planner, sol, *_ = seg8_solve
    hs = np.load(HEADLINE_STATES)
    for k in ("current", "target"):
        np.testing.assert_array_equal(fx[k], hs[k][:64])
    assert fx["z"].shape == (64, 526) and fx["qp_converged"].shape == (64, 2)
    np.testing.assert_allclose(sol.final_time.numpy(), fx["final_time"][:B], rtol=1e-6)
    np.testing.assert_allclose(sol.z.numpy(), fx["z"][:B], rtol=1e-6, atol=1e-6)
    assert sol.qp_converged.tolist() == fx["qp_converged"][:B].tolist()
    np.testing.assert_array_equal(sol.qp_iterations.numpy(), fx["qp_iterations"][:B])
    tgt = torch.as_tensor(fx["target"][:B].astype(np.float64))
    err = (sol.x_at(1.0) - tgt).abs().amax(-1)
    assert bool((err <= planner.target_eps + planner.qp_settings.eps_abs).all())
