"""PyTorch port, transcriptions other than the 19-node one: the plain
structured QP at 8, 4, 12, 15 and 20 spline segments against the JAX
``structured`` backend (float64); the geometry of a kernel library (its
``-D`` flags, one library per geometry, per kernel-3 layout and per count
of elements a thread, kernel 3's shared memory reckoned member by member in
its full, compact, split, stream, lean, far, deep and pair layouts and at
two, three and four elements a thread, the layout each geometry takes, the
ring of the split, stream, lean, far, deep and pair layouts modelled step
by step, a geometry past the limits raising); the shipping QP settings of each node
count, ``bench/convergence.py`` and ``bench/agreement.py``'s count;
the compiled solve's key after the planner's OCP is swapped; and the 8-,
12-, 15-, 20-, 25- and 32-segment JAX fixtures that ``chip_smoke.py``
phases 19, 23, 24, 25, 26 and 28 hold the card against."""

import dataclasses
import json
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
from mpc_motion_planner_tpu_torch.kernels.build import (
    BUILD_DIR, CSRC, LAYOUTS, NVCC_FLAGS, SMEM_LIMIT, Geometry,
)
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
SEG_FIXTURES = {s: os.path.join(ROOT, "tests", "fixtures", f"torch_port_seg{s}_b64.npz")
                for s in (8, 12, 15, 20, 25, 32)}
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


@pytest.mark.parametrize("segments", [
    pytest.param(8, id="25_nodes"), pytest.param(4, id="13_nodes"),
    pytest.param(12, id="37_nodes"), pytest.param(15, id="46_nodes"),
    # ~28 s on the CPU, most of it the JAX compile of the transcription; the
    # fixture test holds the plain solve at 61 nodes against JAX in the tier
    pytest.param(20, id="61_nodes", marks=pytest.mark.slow),
])
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


@pytest.mark.parametrize("order,segments,refine", [(3, 6, 0), (3, 12, 0), (3, 13, 0), (4, 10, 0),
                                                   (3, 14, 1), (3, 15, 1), (3, 20, 1)])
def test_shipping_settings_refine_from_43_nodes(order, segments, refine):
    """The shipping QP settings of a transcription are the headline's, with
    one KKT refinement step from 43 nodes up (46 at 15 segments, 61 at 20);
    nothing else changes."""
    nodes = make_ocp(_planner().model, order=order, num_segments=segments).num_nodes
    assert nodes == order * segments + 1
    s = config.shipping_qp_settings(nodes)
    assert s.kkt_refine == refine and (nodes >= config.KKT_REFINE_FROM_NODES) == bool(refine)
    assert dataclasses.replace(s, kkt_refine=0) == config.SHIPPING_QP_SETTINGS


@pytest.mark.parametrize("order,segments,rescue", [(3, 25, 0), (3, 27, 0), (3, 28, 300),
                                                  (3, 32, 300), (3, 40, 300), (4, 21, 300),
                                                  (3, 41, 900), (3, 52, 900), (4, 34, 900)])
def test_shipping_settings_rescue_from_85_nodes(order, segments, rescue):
    """From 85 nodes the shipping QP settings give a QP that has not
    converged within its budget 300 more iterations (the JAX package's
    rescue budget), and from 122 nodes 900 (124 nodes at 41 segments, 157
    at 52, order 4 x 34 at 137), beside the refinement step; below they give
    none."""
    nodes = make_ocp(_planner().model, order=order, num_segments=segments).num_nodes
    s = config.shipping_qp_settings(nodes)
    assert s.rescue_iters == rescue and (nodes >= config.RESCUE_FROM_NODES) == bool(rescue)
    assert (nodes >= config.LONG_RESCUE_FROM_NODES) == (rescue == config.LONG_RESCUE_ITERS)
    assert s.kkt_refine == 1
    assert dataclasses.replace(s, kkt_refine=0, rescue_iters=0) == config.SHIPPING_QP_SETTINGS


def test_convergence_sweep_prints_one_line_per_run(capsys):
    """``bench/convergence.py`` on the CPU: one JSON line per transcription
    and refinement count, the plain path's convergence of the shipping
    budgets on the first headline states."""
    from mpc_motion_planner_tpu_torch.bench import convergence

    assert convergence.main(["--device", "cpu", "--n", "2", "--segments", "4",
                             "--kkt-refine", "0", "1", "--threads", "1"]) == 0
    torch.set_num_threads(1)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(ln["nodes"], ln["kkt_refine"]) for ln in lines] == [(13, 0), (13, 1)]
    for ln in lines:
        assert ln["states"] == 2 and ln["dtype"] == "float32" and ln["qp_conv_rate"] == 1.0
        assert len(ln["converged_per_step"]) == 2
        assert all(0 < i <= 700 for i in ln["iterations_max_per_step"])


def test_convergence_sweep_plans_a_seeded_chain_at_another_order(capsys):
    """``bench/convergence.py --chain 9 --order 4``: the seeded 9-joint chain
    of ``chip_smoke.py`` (its states the first of those the chain's seed
    draws there) at a spline order of 4, one JSON line naming the order and
    the joints."""
    from mpc_motion_planner_tpu_torch.bench import convergence

    assert convergence.main(["--device", "cpu", "--n", "2", "--segments", "2", "--order", "4",
                             "--chain", "9", "--kkt-refine", "0", "--threads", "1"]) == 0
    torch.set_num_threads(1)
    (line,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert (line["order"], line["joints"], line["nodes"], line["states"]) == (4, 9, 9, 2)
    assert len(line["converged_per_step"]) == 2 and 0 <= line["qp_conv_rate"] <= 1
    model, limits, tool, cur, tgt = convergence.chain(9, 3, torch.float32, torch.device("cpu"))
    assert model.nq == 9 and limits.max_torque.shape == (9,) and tool == "tool"
    assert cur.shape == tgt.shape == (3, 18) and not bool((cur[:, 9:] != 0).any())


def test_agreement_counts_iterations_off_float64():
    """``bench/agreement.py``'s reading: of the problems a solve and the
    float64 loop both converged, how many are more than 25 iterations off
    the float64 loop's and the median gap; without a GPU it refuses."""
    from mpc_motion_planner_tpu_torch.bench import agreement
    from mpc_motion_planner_tpu_torch.ops.qp import QPSolution

    def sol(converged, iterations):
        return QPSolution(x=None, y_constraints=None, y_box=None,
                          converged=torch.tensor(converged), iterations=torch.tensor(iterations),
                          prim_residual=None, dual_residual=None)

    ref64 = sol([True, True, True, False, True], [100, 200, 300, 700, 50])
    got = sol([True, True, False, True, True], [125, 250, 300, 100, 50])
    assert agreement.off_float64(got, ref64) == (3, 1, 25)
    assert agreement.off_float64(sol([False] * 5, [700] * 5), ref64) == (0, 0, 0)
    assert not torch.cuda.is_available() and agreement.main([]) == 1


def test_geometry_flags_reproduce_common_cuh_defaults():
    """The 19-node geometry's -D flags, with the full layout and the one
    element a thread kernel 3 takes there, are the defaults common.cuh falls
    back to, so a build without flags compiles the same code; the geometry
    of an OCP and of its banded KKT matrix agree."""
    text = (CSRC / "common.cuh").read_text()
    defaults = dict(re.findall(r"#define (MPC_\w+) (\d+)", text))
    flags = dict(f[2:].split("=") for f in k3.KERNEL.geometry(Geometry()).flags())
    assert flags == defaults and len(flags) == 5 and flags["MPC_SMEM_LAYOUT"] == "0"
    assert flags["MPC_EPT"] == "1"
    assert k3.KERNEL.geometry(Geometry()).flags()[:3] == Geometry().flags()
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
        built = k.geometry(g25)
        assert k.flags(g25)[len(NVCC_FLAGS):] == built.flags() and built.flags()[:3] == g25.flags()
        assert "-DMPC_SEGMENTS=8" in k.flags(g25)
    k1 = kernels.KERNELS["constraints"]
    assert k1.library_path(g25) == k1.library_path() and k1.flags(g25)[-1] == "-DMPC_NQ=7"
    assert not any(f.startswith("-DMPC_SEGMENTS") for f in k1.flags(g25))
    k4 = kernels.KERNELS["admm_dense"]
    assert k4.library_path(g25) == k4.library_path() and not any(
        f.startswith("-DMPC") for f in k4.flags(g25))


def test_kernel_shared_memory_reckoning():
    """Kernel 3's block, member by member with the alignment of struct
    Smem: the full layout at 19 (198,976 B; the members alone sum to
    198,960 B) and 13 nodes, the compact one at 25 nodes, where the full one
    would take 262,000 B. Kernel 2 keeps six problems per SM at 25 nodes."""
    g19, g25, g13 = Geometry(), Geometry(segments=8), Geometry(segments=4)
    assert (k3.threads(g19), k3.threads(g25), k3.threads(g13)) == (512, 672, 352)
    assert k3.smem_bytes(g19) == k3.smem_bytes(g19, "full") == 198976
    assert k3.smem_bytes(g13) == k3.smem_bytes(g13, "full") == 135968
    assert k3.smem_bytes(g25, "full") == 262000 > SMEM_LIMIT
    assert k3.smem_bytes(g25) == k3.smem_bytes(g25, "compact") == 232176 <= SMEM_LIMIT
    # the packed Ldi and the 5 Lsub blocks never read, give or take the padding
    # before the 16-byte aligned members
    saved = k3.smem_bytes(g25, "full") - k3.smem_bytes(g25, "compact")
    assert 0 <= saved - 4 * (25 * 210 + 5 * 441) < 16
    assert (k2.smem_bytes(g19), k2.smem_bytes(g25)) == (33580, 34588)
    assert 6 * (k2.smem_bytes(g25) + 1024) <= 233472  # an SM's 228 KB, 1 KB per block reserved


def test_unfit_geometry_raises_naming_the_bytes():
    """28 nodes (261,152 B even compact) fit kernel 3's block in the split
    layout, 180,128 B; 12 segments (37 nodes, 235,344 B split) in the stream
    layout, 182,432 B. 13 segments (40 nodes, 1048 rows) fit at two z
    elements and rows a thread, 544 threads, in the stream layout (195,280
    B), and 15 (46 nodes) at 608 threads (221,456 B). 16 segments (49
    nodes, 234,560 B stream) fit in the lean layout (161,488 B), and so do
    up to 24 (73 nodes, 992 threads, 230,160 B). 25 segments (76 nodes,
    1024 threads, 238,736 B lean) fit in the far layout (187,664 B), and so
    do up to 31 (94 nodes, three elements a thread, 226,864 B). 32 segments
    (97 nodes, 233,424 B far) fit in the deep layout (158,000 B), and so do
    up to 51 (154 nodes, four elements a thread, 1024 threads, 229,824 B).
    52 segments (157 nodes, five elements a thread, 233,520 B deep) fit in
    the pair layout (rank 0 208,752 B, rank 1 49,680 B), and so do up to 58
    (175 nodes, 960 threads, 231,456 B). 59 segments (178 nodes) need
    235,232 B even in rank 0 of the pair layout: the fit check and the
    card's QP solve raise and name the bytes of every layout and of both
    ranks, before any build or launch and whatever the data, so nothing
    falls back to the plain loop."""
    g28, g37, g40 = Geometry(segments=9), Geometry(segments=12), Geometry(segments=13)
    g46, g49 = Geometry(segments=15), Geometry(segments=16)
    g73, g76 = Geometry(segments=24), Geometry(segments=25)
    g94, g97 = Geometry(segments=31), Geometry(segments=32)
    g154, g157 = Geometry(segments=51), Geometry(segments=52)
    g175, g178 = Geometry(segments=58), Geometry(segments=59)
    assert k3.smem_bytes(g28, "compact") == 261152 > SMEM_LIMIT
    assert k3.choose_layout(g28) == "split" and k3.smem_bytes(g28) == 180128
    k3.check_fits(g28)
    assert (k3.threads(g37), k3.smem_bytes(g37, "split")) == (992, 235344)
    assert k3.choose_layout(g37) == "stream" and k3.smem_bytes(g37) == 182432
    k3.check_fits(g37)
    assert (k3.ept_of(g40), k3.threads(g40), k3.smem_bytes(g40)) == (2, 544, 195280)
    assert (k3.ept_of(g46), k3.threads(g46), k3.smem_bytes(g46)) == (2, 608, 221456)
    for g in (g40, g46):
        assert k3.choose_layout(g) == "stream"
        k3.check_fits(g)
    assert (k3.threads(g49), k3.smem_bytes(g49, "stream")) == (672, 234560)
    assert (k3.threads(g73), k3.smem_bytes(g73)) == (992, 230160)
    for g in (g49, g73):
        assert k3.choose_layout(g) == "lean"
        k3.check_fits(g)
    with pytest.raises(ValueError, match=r"49 nodes, order 3 and 7 joints .* needs 234560 B of "
                                         r"shared memory per block in its stream layout"):
        k3.check_fits(dataclasses.replace(g49, layout="stream"))
    assert (k3.threads(g76), k3.smem_bytes(g76, "lean"), k3.smem_bytes(g76)) == (
        1024, 238736, 187664)
    assert (k3.ept_of(g94), k3.threads(g94), k3.smem_bytes(g94)) == (3, 832, 226864)
    for g in (g76, g94):
        assert k3.choose_layout(g) == "far"
        k3.check_fits(g)
    with pytest.raises(ValueError, match=r"76 nodes, order 3 and 7 joints .* needs 238736 B of "
                                         r"shared memory per block in its lean layout"):
        k3.check_fits(dataclasses.replace(g76, layout="lean"))
    assert (k3.threads(g97), k3.smem_bytes(g97, "far"), k3.smem_bytes(g97)) == (
        864, 233424, 158000)
    assert (k3.ept_of(g154), k3.threads(g154), k3.smem_bytes(g154)) == (4, 1024, 229824)
    for g in (g97, g154):
        assert k3.choose_layout(g) == "deep"
        k3.check_fits(g)
    with pytest.raises(ValueError, match=r"97 nodes, order 3 and 7 joints .* needs 233424 B of "
                                         r"shared memory per block in its far layout"):
        k3.check_fits(dataclasses.replace(g97, layout="far"))
    assert (k3.ept_of(g157), k3.threads(g157), k3.smem_bytes(g157, "deep")) == (5, 864, 233520)
    assert (k3.smem_bytes(g157), k3.rank_bytes(g157)) == (208752, (208752, 49680))
    assert (k3.ept_of(g175), k3.threads(g175), k3.smem_bytes(g175)) == (5, 960, 231456)
    for g in (g157, g175):
        assert k3.choose_layout(g) == "pair"
        k3.check_fits(g)
    with pytest.raises(ValueError, match=r"157 nodes, order 3 and 7 joints .* needs 233520 B of "
                                         r"shared memory per block in its deep layout"):
        k3.check_fits(dataclasses.replace(g157, layout="deep"))
    assert (k3.ept_of(g178), k3.threads(g178), k3.smem_bytes(g178)) == (5, 960, 235232)
    with pytest.raises(ValueError, match=r"178 nodes, order 3 and 7 joints .* needs 235232 B of "
                                         r"shared memory per block in its pair layout \(rank 0 "
                                         r"235232 B, rank 1 49680 B; full: \d+ B, compact: \d+ "
                                         r"B, split: \d+ B, stream: \d+ B, lean: 529888 B, far: "
                                         r"410272 B, deep: 260000 B\)"):
        k3.check_fits(g178)
    planner = _planner(59)
    cur, tgt = _states(1)
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    _, _, sa, args = qp_subproblem(planner.ocp, planner.nlp_bounds(cur, tgt), z0)
    P = hessian_regularization_diag(planner.ocp, 1, torch.float64, "cpu", 0.01)
    with pytest.raises(ValueError, match="235232 B"):
        k3.solve_box_qp_structured_cuda(planner.ocp, sa, P, *args, config.SHIPPING_QP_SETTINGS)
    for g in (g40, g46, g49, g73, g76, g94, g97, g154, g157, g175, g178):
        k2.check_fits(g)  # kernel 2's working set is per node


def test_two_elements_a_thread_reckoning():
    """Past 1024 z elements or rows a thread owns two of each (ept_of), so
    the block has half the threads; a geometry may name another count (for
    holding one build against another), which changes the threads and, by
    the warps' reduction slots (four floats a warp), the shared memory and
    nothing else. The stream block at 46 nodes, member by member: 221,456 B.
    A named count that leaves more than 1024 threads or too few warps for
    the sweeps raises naming them."""
    g37, g46 = Geometry(segments=12), Geometry(segments=15)
    assert (k3.ept_of(g37), k3.ept_of(g46)) == (1, 2)
    g37e2 = dataclasses.replace(g37, ept=2)
    assert (k3.threads(g37), k3.threads(g37e2), k3.threads(g46)) == (992, 512, 608)
    for name in LAYOUTS:  # 31 against 16 warps' four floats
        assert k3.smem_bytes(g37, name) - k3.smem_bytes(g37e2, name) == 240
    assert k3.choose_layout(g37e2) == "stream"
    k3.check_fits(g37e2)
    # struct Smem of the stream layout at 46 nodes, 7 joints, order 3, 608
    # threads: (floats, alignment) in the order of its members
    N, blk, nv, neq, nm = 46, 21, 967, 840, 1208
    assert (g46.nodes, g46.num_var, g46.num_eq, g46.num_rows) == (N, nv, neq, nm)
    slot = -(-(3 * blk * blk + 3) // 4) * 4
    members = [
        (N * blk * (blk + 1) // 2, 4),  # Ldi, packed
        (3 + 4 * (slot + 2) + 1, 4),  # Lsub: the ring of 4 runs, barriers, progress
        (N * blk, 4), (N * 8 * blk, 4), (neq, 4),  # u, J, fseg
        *[(nv, 4)] * 7, *[(nm, 4)] * 5,  # qs .. D, rc .. thr
        *[(nv, 4)] * 3, *[(nm, 4)] * 2,  # x, zx, yx, zc, yc
        (nv, 4), (nm, 4), (nv, 4),  # t0, wa, rhs
        (N * 24, 16), (N * 24, 16), (24, 16),  # ys, xs, tb
        (2 * N * blk, 4),  # ahead
        (nv, 4), (nv, 4), (nm, 4), (nm, 4),  # xt, dx, wb, wc
        (608 // 32 * 4, 4), (16, 4), (1, 4), (1, 4), (1, 4),  # red, Dm, p, s, done
    ]
    off = 0
    for floats, align in members:
        off = -(-off // align) * align + 4 * floats
    assert -(-off // 16) * 16 == k3.smem_bytes(g46) == 221456
    with pytest.raises(ValueError, match=r"needs 1056 threads per block at 1 z elements"):
        k3.check_fits(Geometry(segments=13, ept=1))
    with pytest.raises(ValueError, match=r"has 4 warps; its sweeps take 5"):
        k3.check_fits(Geometry(ept=4))
    with pytest.raises(ValueError, match="ept 0"):
        Geometry(ept=0)


# (segments, order, joints): kernel 3's threads and its bytes in the full,
# compact, split, stream, lean, far, deep and pair layouts. The split's bytes are
# the compact's less the Lsub blocks of distances 2..bw and plus a ring of
# bw nodes' helper blocks; the stream's keep no Lsub block and a ring of bw
# + 1 nodes' runs of bw blocks; the lean's are the stream's less the 16
# owner-only vectors but a float of each; the far's are the lean's less J
# but a float; the deep's are the far's less the packed Ldi but a float and
# with a ring of bw + 2 slots, each a run and an Ldi block; the pair's are
# the larger of its two blocks': the deep's less the ring's slots, with a
# staging buffer of a block for each chain warp's two blocks and for each
# helper's (rank 0), and the slots, two more than the deep's (a lead of 4),
# their barriers, the progress count and the stop flag (rank 1). The first four take the split layout, the rest the
# stream.
RING_GEOMETRIES = {
    (6, 4, 7): (640, 306976, 273632, 173200, 144992, 108752, 91968, 86608, 70856),
    (6, 3, 9): (640, 308464, 267216, 185680, 150704, 114848, 94320, 89024, 81936),
    (6, 3, 10): (704, 372400, 321344, 220640, 177456, 137680, 112592, 106160, 101088),
    (9, 3, 7): (736, 293488, 261152, 180128, 143088, 101568, 82752, 71088, 49680),
    (12, 3, 7): (992, 388032, 348128, 235344, 182432, 127392, 102528, 82544, 57776),
    (9, 4, 7): (928, 454544, 411120, 247200, 197808, 143936, 119088, 102640, 70856),
    (8, 3, 9): (832, 406128, 356448, 239920, 187440, 140048, 113040, 98672, 81936),
    (8, 3, 10): (928, 490288, 428800, 284880, 220112, 167520, 134512, 116928, 101088),
    # two z elements and rows a thread
    (13, 3, 7): (544, 419264, 376848, 253488, 195280, 135728, 108848, 86096, 61328),
    (10, 4, 7): (544, 503504, 456720, 271616, 215184, 155424, 127888, 107744, 70856),
    (15, 3, 7): (608, 482240, 434784, 290240, 221456, 152896, 121984, 93680, 68912),
    (10, 3, 9): (544, 503536, 445440, 293920, 223952, 165008, 131520, 108080, 81936),
}


@pytest.mark.parametrize("segments, order, nq", list(RING_GEOMETRIES),
                         ids=["order4x6", "9_joints", "10_joints", "28_nodes", "37_nodes",
                              "order4x9", "9_joints_25_nodes", "10_joints_25_nodes", "40_nodes",
                              "order4x10", "46_nodes", "9_joints_31_nodes"])
def test_split_layout_reckoning(segments, order, nq):
    """The split and stream layouts' blocks, member by member: Ldi packed as
    in the compact layout; of Lsub in the split only the N - 1 distance-1
    blocks the chain reads and a ring of bw slots, each a node's bw - 1
    helper blocks and up to 3 floats before them (from a 16-byte boundary),
    in the stream no block but a ring of bw + 1 slots, each a node's bw
    blocks; with their barriers and the copier's progress count. Where the
    compact layout does not fit, the split is the layout the geometry takes,
    and where the split does not, the stream; the fit check passes."""
    g = Geometry(segments=segments, order=order, nq=nq)
    threads, full, compact, split, stream, lean, far, deep, pair = RING_GEOMETRIES[
        segments, order, nq]
    layout = "split" if split <= SMEM_LIMIT else "stream"
    assert k3.threads(g) == threads <= 1024
    assert tuple(k3.smem_bytes(g, name) for name in LAYOUTS) == (
        full, compact, split, stream, lean, far, deep, pair)
    assert compact > SMEM_LIMIT >= k3.smem_bytes(g, layout) == k3.smem_bytes(g)
    assert k3.choose_layout(g) == layout and stream < split
    blk2, N, bw = g.blk ** 2, g.nodes, g.order
    # a slot: a node's run of blocks from a 16-byte boundary
    assert k3.ring_slot(g) == -(-((bw - 1) * blk2 + 3) // 4) * 4 and k3.ring_runs(g) == bw
    assert k3.ring_slot(g, "stream") == -(-(bw * blk2 + 3) // 4) * 4
    assert k3.ring_runs(g, "stream") == bw + 1
    lsub = ((N - 2) * bw + 1) * blk2  # the compact layout's blocks
    kept = {name: d1 + 3 + k3.ring_runs(g, name) * (k3.ring_slot(g, name) + 2) + 1
            for name, d1 in (("split", (N - 1) * blk2), ("stream", 0))}
    # give or take the padding before the 16-byte aligned members
    assert abs((compact - split) - 4 * (lsub - kept["split"])) < 16
    assert abs((compact - stream) - 4 * (lsub - kept["stream"])) < 16
    # the lean layout: the stream's less 16 owner-only vectors but a float of each
    assert abs((stream - lean) - 4 * (9 * (g.num_var - 1) + 7 * (g.num_rows - 1))) < 16
    # the far layout: the lean's less J, N ng blk floats, but one
    assert abs((lean - far) - 4 * (N * g.ng * g.blk - 1)) < 16
    # the deep layout: the far's less the packed Ldi but a float, and a ring
    # of bw + 2 slots of a run and an Ldi block (from their 16-byte boundaries)
    assert k3.ring_runs(g, "deep") == bw + 2
    assert k3.ring_slot(g, "deep") == k3.ring_slot(g, "stream") + -(-(blk2 + 3) // 4) * 4
    ring = {name: k3.ring_runs(g, name) * (k3.ring_slot(g, name) + 2) for name in ("far", "deep")}
    assert abs((far - deep) - 4 * (N * g.blk * (g.blk + 1) // 2 - 1 - ring["deep"] + ring["far"])
               ) < 16
    # the pair layout: rank 0 the deep's less the ring's slots, with bw + 3
    # staging buffers of a block from its 16-byte boundary (the chain warps'
    # two blocks each, a helper's one), the barriers of bw + 4 slots and the
    # progress count to a 16-byte boundary; rank 1 the bw + 4 slots, their
    # barriers, the progress count and the stop flag
    rank0, rank1 = k3.rank_bytes(g)
    slots = k3.ring_runs(g, "pair") * k3.ring_slot(g, "pair")
    assert k3.ring_runs(g, "pair") == bw + 4 and k3.ring_slot(g, "pair") == k3.ring_slot(g, "deep")
    stage = (bw + 3) * ((blk2 + 6) // 4 * 4)
    head = -(-(2 * (bw + 4) + 1) // 4) * 4
    deep_ring = k3.ring_runs(g, "deep") * (k3.ring_slot(g, "deep") + 2) + 1
    assert abs((deep - rank0) - 4 * (deep_ring - head - stage)) < 16
    assert rank1 == 4 * slots + 8 * (bw + 4) + 8 and pair == max(rank0, rank1)
    k3.check_fits(g)
    k3.check_fits(dataclasses.replace(g, layout="stream"))
    for name in LAYOUTS[:LAYOUTS.index(layout)]:
        with pytest.raises(ValueError, match=rf"needs {k3.smem_bytes(g, name)} B of shared "
                                             rf"memory per block in its {name} layout"):
            k3.check_fits(dataclasses.replace(g, layout=name))


def _ring_faults(g, layout, ring):
    """Every fault of the ring of ``layout`` at ``g`` with ``ring`` slots,
    modelled through three pairs of sweeps (``ring_schedule``): a read that
    does not find its node's run in its slot, copied at least LEAD steps
    before after as many copies into that slot as ``ring_copy_count`` says;
    a copy that overwrites a run before it is read; an iteration that does
    not copy 2 (N - 2 - bw) runs."""
    copies, reads = k3.ring_schedule(g, layout, iterations=3)
    events = sorted([(-1 if n is None else n, 1, m, s, None) for n, m, s in copies]
                    + [(n, 0, m, s, who) for n, m, s, _, who in reads],
                    key=lambda e: e[:2])  # a step's reads come before its copies
    slots, copied, bad, N = {}, {}, [], g.nodes
    for n, is_copy, m, s, who in events:
        assert s == m % ring
        held = slots.get(s)
        if is_copy:
            if held is not None and held[2] == 0:
                bad.append(f"step {n}: node {m}'s copy overwrites node {held[0]}, unread")
            slots[s] = [m, n, 0]
            copied[s] = copied.get(s, 0) + 1
        elif held is None or held[0] != m:
            bad.append(f"step {n}: {who} reads node {m}, slot {s} holds {held}")
        elif held[1] >= 0 and n - held[1] < k3.lead(layout):
            bad.append(f"step {n}: {who} reads node {m}, copied at step {held[1]}")
        elif copied[s] != k3.ring_copy_count(g, layout, m, n // N // 2, n // N % 2 == 0):
            bad.append(f"step {n}: {who} reads node {m} after {copied[s]} copies into "
                       f"its slot")
        else:
            held[2] += 1
    per_iteration = sum(1 for n, _, _ in copies if n is not None and 2 * N <= n < 4 * N)
    if per_iteration != 2 * max(N - k3.lead(layout) - g.order, 0):
        bad.append(f"{per_iteration} copies an iteration")
    return bad


@pytest.mark.parametrize("layout", ["split", "stream", "lean", "far", "deep", "pair"])
def test_ring_schedule_serves_every_read(layout):
    """The ring of the split, stream, lean, far, deep and pair layouts,
    modelled step by step as csrc/structured_admm.cu ring_step runs it
    (``ring_schedule``; the pair layout's is the deep's, its copier and relay
    in rank 1 following the progress count as the deep's copier does), at
    every geometry of orders 2-5 and 6-10 joints whose stream block (lean,
    far, deep and pair: whose block in that layout) fits, through three
    pairs of sweeps (an iteration with its refinement step takes two):
    every read, by the chain's fetch (all but the split; in the deep and
    pair layouts its Ldi too, a step before the node's run) or by a
    helper, finds its node's run in its slot, copied at least LEAD steps
    before, and the copies into that slot so far are ``ring_copy_count``'s
    (the closed form from which the chain of those layouts takes the parity
    it waits for); no copy overwrites a run before it is read (so each
    slot's barrier phase is waited on before the next copy into it); an
    iteration copies 2 (N - 2 - bw) runs, as the source's header says; and
    a ring of one run fewer fails at 37 nodes."""
    text = " ".join(ln.strip().lstrip("/ ") for ln in
                    (CSRC / "structured_admm.cu").read_text().splitlines())
    assert "An iteration copies 2 (N - 2 - BW) runs" in text and "ring_schedule" in text
    checked = 0
    for order in (2, 3, 4, 5):
        for nq in range(6, 11):
            for segments in range(1, 70):
                g = Geometry(segments=segments, order=order, nq=nq)
                if k3.smem_bytes(g, layout if layout in k3.OWNERS_OUT else "stream") > SMEM_LIMIT:
                    break
                assert _ring_faults(g, layout, k3.ring_runs(g, layout)) == [], (g, layout)
                checked += 1
    assert checked > 150
    g37 = Geometry(segments=12)
    shorter = k3.ring_runs(g37, layout) - 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k3, "ring_runs", lambda g, lay="split": shorter)
        assert _ring_faults(g37, layout, shorter)


@pytest.mark.parametrize("layout", ["split", "stream", "lean", "far", "deep", "pair"])
def test_ring_schedule_past_ten_joints(layout):
    """Past 10 joints (two rows a lane) the sweeps read each block a step
    later, where its product uses it, and the copier issues each copy a step
    later too (csrc/structured_admm.cu ``LATE``): modelled so
    (``ring_schedule``), the ring of each layout at 11, 12 and 14 joints, at
    every geometry of orders 3 and 4 whose block in that layout (split: the
    stream's) fits, through three pairs of sweeps, serves every read with
    the same slots and copy count as one row a lane; reads a step later with
    the copies where one row a lane issues them would find runs overwritten
    at 12 joints and 19 nodes (but in the deep and pair layouts, whose ring
    has a step to spare)."""
    text = " ".join(ln.strip().lstrip("/ ") for ln in
                    (CSRC / "structured_admm.cu").read_text().splitlines())
    assert "done >= r.steps + LATE" in text and "LATE = ROWS > 1 ? 1 : 0" in text
    checked = 0
    for order in (3, 4):
        for nq in (11, 12, 14):
            for segments in range(1, 70):
                g = Geometry(segments=segments, order=order, nq=nq)
                if k3.smem_bytes(g, layout if layout in k3.OWNERS_OUT else "stream") > SMEM_LIMIT:
                    break
                assert k3.rows(g) == 2
                assert _ring_faults(g, layout, k3.ring_runs(g, layout)) == [], (g, layout)
                checked += 1
    assert checked >= {"split": 10, "stream": 10}.get(layout, 20)
    g = Geometry(nq=12)
    schedule = k3.ring_schedule

    def early_copies(g, lay, iterations=2):
        copies, reads = schedule(g, lay, iterations)
        return [(None if n is None else n - 1, m, s) for n, m, s in copies], reads

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k3, "ring_schedule", early_copies)
        assert bool(_ring_faults(g, layout, k3.ring_runs(g, layout))) == (
            layout not in k3.LDI_RINGED)


@pytest.mark.parametrize("segments, order, nq, layout", [
    (6, 3, 7, "full"), (4, 3, 7, "full"), (6, 3, 6, "full"), (9, 2, 7, "full"),
    (4, 4, 7, "full"), (3, 5, 7, "full"), (8, 3, 7, "compact"), (6, 3, 8, "compact"),
    (5, 4, 7, "compact"), (6, 4, 7, "split"), (6, 3, 9, "split"), (6, 3, 10, "split"),
    (9, 3, 7, "split"), (5, 4, 8, "split"), (11, 3, 7, "split"), (12, 3, 7, "stream"),
    (9, 4, 7, "stream"), (8, 3, 9, "stream"), (8, 3, 10, "stream"), (7, 5, 7, "stream"),
    # the geometries that take the lean layout in chip_smoke.py phase 25
    (16, 3, 7, "lean"), (20, 3, 7, "lean"), (24, 3, 7, "lean"), (11, 4, 7, "lean"),
    (16, 4, 7, "lean"), (9, 3, 10, "lean"), (12, 3, 10, "lean"), (15, 3, 9, "lean"),
    # and the far layout in phase 26, with the last of each that fits
    (25, 3, 7, "far"), (28, 3, 7, "far"), (31, 3, 7, "far"), (17, 4, 7, "far"),
    (21, 4, 7, "far"), (16, 3, 9, "far"), (20, 3, 9, "far"), (13, 3, 10, "far"),
    (16, 3, 10, "far"),
    # and the deep layout in phase 28, with the last of each that fits
    (32, 3, 7, "deep"), (40, 3, 7, "deep"), (51, 3, 7, "deep"), (22, 4, 7, "deep"),
    (33, 4, 7, "deep"), (21, 3, 9, "deep"), (36, 3, 9, "deep"), (17, 3, 10, "deep"),
    (29, 3, 10, "deep"),
    # and the pair layout in phase 30: the seven geometries refused past the
    # deep one, with the last of the Panda's that fits
    (52, 3, 7, "pair"), (58, 3, 7, "pair"), (34, 4, 7, "pair"), (37, 3, 9, "pair"),
    (30, 3, 10, "pair"), (25, 3, 11, "pair"), (20, 3, 12, "pair"), (12, 3, 14, "pair"),
])
def test_layout_of_each_geometry(segments, order, nq, layout):
    """Each geometry takes the first of full, compact, split, stream, lean,
    far, deep and pair whose block fits, so the geometries that fit before
    the stream layout keep the layouts they had (full at 19 and 13 nodes,
    compact at 25, split at order 4 x 6 and 34 nodes), and only a geometry
    that fits none of the first three takes the stream, only one that fits
    none of the first four the lean, only one that fits none of the first
    five the far, only one that fits none of the first six the deep, and
    only one that fits none of the first seven the pair."""
    g = Geometry(segments=segments, order=order, nq=nq)
    assert k3.choose_layout(g) == layout
    fits = [k3.smem_bytes(g, name) <= SMEM_LIMIT for name in LAYOUTS]
    assert fits.index(True) == LAYOUTS.index(layout)
    assert k3.KERNEL.geometry(g) == dataclasses.replace(g, layout=layout, ept=k3.ept_of(g))


def _layouts_taken():
    """The layout of every geometry of orders 2-5 and 6-10 joints up to the
    first that fits no layout, with the layouts whose block fits there."""
    for order in (2, 3, 4, 5):
        for nq in range(6, 11):
            for segments in range(1, 70):
                g = Geometry(segments=segments, order=order, nq=nq)
                fits = [k3.smem_bytes(g, name) <= SMEM_LIMIT for name in LAYOUTS]
                if not any(fits):
                    break
                yield g, k3.choose_layout(g), fits


def test_lean_layout_is_taken_last_everywhere():
    """At every geometry of orders 2-5 and 6-10 joints up to the first that
    fits no layout, the layout taken is the first that fits, so the lean
    layout only where the stream does not fit and the lean does, and a
    geometry whose stream block fits keeps the layout it had before the lean
    layout existed."""
    taken = {name: 0 for name in LAYOUTS}
    for g, layout, fits in _layouts_taken():
        assert layout == LAYOUTS[fits.index(True)]
        assert (layout == "lean") == (k3.smem_bytes(g, "stream") > SMEM_LIMIT
                                      and k3.smem_bytes(g, "lean") <= SMEM_LIMIT)
        taken[layout] += 1
    assert all(taken.values()) and taken["lean"] > 80


def test_far_layout_is_taken_only_where_lean_does_not_fit():
    """At every geometry of orders 2-5 and 6-10 joints up to the first that
    fits no layout, the far layout is taken exactly where the lean block
    does not fit and the far one does, so every geometry that fitted before
    the far layout keeps the layout and the library it had; the first
    geometries past the far layout (32 x 3, order 4 x 22, 10 joints x 17,
    9 joints x 21) take the deep one, and the far layout named there raises
    naming its bytes."""
    far = 0
    for g, layout, fits in _layouts_taken():
        assert (layout == "far") == (not any(fits[:5]) and fits[5])
        assert k3.KERNEL.geometry(g).layout == layout
        far += layout == "far"
    assert far > 120
    for g in (Geometry(segments=32), Geometry(segments=22, order=4),
              Geometry(segments=17, nq=10), Geometry(segments=21, nq=9)):
        assert k3.smem_bytes(g, "far") > SMEM_LIMIT and k3.choose_layout(g) == "deep"
        k3.check_fits(g)
        with pytest.raises(ValueError, match=rf"needs {k3.smem_bytes(g, 'far')} B of shared "
                                             rf"memory per block in its far layout"):
            k3.check_fits(dataclasses.replace(g, layout="far"))


def test_deep_layout_is_taken_only_where_far_does_not_fit():
    """At every geometry of orders 2-5 and 6-10 joints up to the first that
    fits no layout, the deep layout is taken exactly where no block of the
    first six layouts fits and the deep one does, so every geometry that
    fitted before the deep layout keeps the layout and the library it had;
    the first geometries past the deep layout, 52 segments of order 3 (157
    nodes), order 4 x 34 (137), 9 joints x 37 (112) and 10 joints x 30
    (91), take the pair layout, and the deep layout named there raises
    naming its bytes."""
    deep = 0
    last = {}
    for g, layout, fits in _layouts_taken():
        assert (layout == "deep") == (not any(fits[:6]) and fits[6])
        assert k3.KERNEL.geometry(g).layout == layout
        deep += layout == "deep"
        if layout == "deep":
            last[g.order, g.nq] = g.segments
    assert deep > 250
    assert (last[3, 7], last[4, 7], last[3, 9], last[3, 10]) == (51, 33, 36, 29)
    for g in (Geometry(segments=52), Geometry(segments=34, order=4),
              Geometry(segments=37, nq=9), Geometry(segments=30, nq=10)):
        assert k3.smem_bytes(g, "deep") > SMEM_LIMIT and k3.choose_layout(g) == "pair"
        assert k3.threads(g) <= 1024
        k3.check_fits(g)
        with pytest.raises(ValueError, match=rf"needs {k3.smem_bytes(g, 'deep')} B of shared "
                                             rf"memory per block in its deep layout"):
            k3.check_fits(dataclasses.replace(g, layout="deep"))


@pytest.mark.parametrize("segments", [16, 20, 24], ids=["49_nodes", "61_nodes", "73_nodes"])
def test_lean_layout_reckoning(segments):
    """Kernel 3's lean block of the Panda at 16, 20 and 24 segments of
    order 3, member by member: the stream layout's, with one float of each
    of the 16 owner-only vectors (the arrow element's Ps and rx, and a slot
    of each of the others), at two z elements and rows a thread."""
    g = Geometry(segments=segments)
    N, blk, nv, neq, nm = g.nodes, 21, g.num_var, g.num_eq, g.num_rows
    threads = {16: 672, 20: 832, 24: 992}[segments]
    assert (N, nv, nm) == {16: (49, 1030, 1288), 20: (61, 1282, 1608),
                           24: (73, 1534, 1928)}[segments]
    assert (k3.ept_of(g), k3.threads(g)) == (2, threads)
    slot = -(-(3 * blk * blk + 3) // 4) * 4
    members = [
        (N * blk * (blk + 1) // 2, 4),  # Ldi, packed
        (3 + 4 * (slot + 2) + 1, 4),  # Lsub: the ring of 4 runs, barriers, progress
        (N * blk, 4), (N * 8 * blk, 4), (neq, 4),  # u, J, fseg
        *[(1, 4)] * 6, (nv, 4), *[(1, 4)] * 5,  # qs .. thx, D, rc .. thr
        *[(1, 4)] * 5,  # x, zx, yx, zc, yc
        (nv, 4), (nm, 4), (nv, 4),  # t0, wa, rhs
        (N * 24, 16), (N * 24, 16), (24, 16),  # ys, xs, tb
        (2 * N * blk, 4),  # ahead
        (nv, 4), (nv, 4), (nm, 4), (nm, 4),  # xt, dx, wb, wc
        (threads // 32 * 4, 4), (16, 4), (1, 4), (1, 4), (1, 4),  # red, Dm, p, s, done
    ]
    off = 0
    for floats, align in members:
        off = -(-off // align) * align + 4 * floats
    lean = {16: 161488, 20: 195824, 24: 230160}[segments]
    assert -(-off // 16) * 16 == k3.smem_bytes(g) == k3.smem_bytes(g, "lean") == lean
    assert k3.choose_layout(g) == "lean" and lean <= SMEM_LIMIT


@pytest.mark.parametrize("segments", [25, 28, 31], ids=["76_nodes", "85_nodes", "94_nodes"])
def test_far_layout_reckoning(segments):
    """Kernel 3's far block of the Panda at 25, 28 and 31 segments of order
    3, member by member: the lean layout's, with one float of J (the node
    constraint Jacobians), at two z elements and rows a thread at 76 nodes
    (1024 threads) and three at 85 and 94."""
    g = Geometry(segments=segments)
    N, blk, nv, neq, nm = g.nodes, 21, g.num_var, g.num_eq, g.num_rows
    ept, threads = {25: (2, 1024), 28: (3, 768), 31: (3, 832)}[segments]
    assert (N, nv, nm) == {25: (76, 1597, 2008), 28: (85, 1786, 2248),
                           31: (94, 1975, 2488)}[segments]
    assert (k3.ept_of(g), k3.threads(g)) == (ept, threads)
    slot = -(-(3 * blk * blk + 3) // 4) * 4
    members = [
        (N * blk * (blk + 1) // 2, 4),  # Ldi, packed
        (3 + 4 * (slot + 2) + 1, 4),  # Lsub: the ring of 4 runs, barriers, progress
        (N * blk, 4), (1, 4), (neq, 4),  # u, J, fseg
        *[(1, 4)] * 6, (nv, 4), *[(1, 4)] * 5,  # qs .. thx, D, rc .. thr
        *[(1, 4)] * 5,  # x, zx, yx, zc, yc
        (nv, 4), (nm, 4), (nv, 4),  # t0, wa, rhs
        (N * 24, 16), (N * 24, 16), (24, 16),  # ys, xs, tb
        (2 * N * blk, 4),  # ahead
        (nv, 4), (nv, 4), (nm, 4), (nm, 4),  # xt, dx, wb, wc
        (threads // 32 * 4, 4), (16, 4), (1, 4), (1, 4), (1, 4),  # red, Dm, p, s, done
    ]
    off = 0
    for floats, align in members:
        off = -(-off // align) * align + 4 * floats
    far = {25: 187664, 28: 207184, 31: 226864}[segments]
    assert -(-off // 16) * 16 == k3.smem_bytes(g) == k3.smem_bytes(g, "far") == far
    assert k3.smem_bytes(g, "lean") > SMEM_LIMIT >= far and k3.choose_layout(g) == "far"
    # J alone, N ng blk floats, but one: 51,072 B at 76 nodes
    assert abs(k3.smem_bytes(g, "lean") - far - 4 * (N * 8 * blk - 1)) < 16


@pytest.mark.parametrize("segments", [32, 40, 51], ids=["97_nodes", "121_nodes", "154_nodes"])
def test_deep_layout_reckoning(segments):
    """Kernel 3's deep block of the Panda at 32, 40 and 51 segments of order
    3, member by member: the far layout's, with one float of Ldi and a ring
    of five slots (bw + 2), each a node's run of three blocks and its Ldi
    block, each from a 16-byte boundary, at three elements a thread at 97
    nodes (864 threads) and four at 121 and 154 (832 and 1024)."""
    g = Geometry(segments=segments)
    N, blk, nv, neq, nm = g.nodes, 21, g.num_var, g.num_eq, g.num_rows
    ept, threads = {32: (3, 864), 40: (4, 832), 51: (4, 1024)}[segments]
    assert (N, nv, nm) == {32: (97, 2038, 2568), 40: (121, 2542, 3208),
                           51: (154, 3235, 4088)}[segments]
    assert (k3.ept_of(g), k3.threads(g)) == (ept, threads)
    slot = -(-(3 * blk * blk + 3) // 4) * 4 + -(-(blk * blk + 3) // 4) * 4
    members = [
        (1, 4),  # Ldi: in the ring
        (3 + 5 * (slot + 2) + 1, 4),  # Lsub: the ring of 5 runs and Ldi blocks, barriers, progress
        (N * blk, 4), (1, 4), (neq, 4),  # u, J, fseg
        *[(1, 4)] * 6, (nv, 4), *[(1, 4)] * 5,  # qs .. thx, D, rc .. thr
        *[(1, 4)] * 5,  # x, zx, yx, zc, yc
        (nv, 4), (nm, 4), (nv, 4),  # t0, wa, rhs
        (N * 24, 16), (N * 24, 16), (24, 16),  # ys, xs, tb
        (2 * N * blk, 4),  # ahead
        (nv, 4), (nv, 4), (nm, 4), (nm, 4),  # xt, dx, wb, wc
        (threads // 32 * 4, 4), (16, 4), (1, 4), (1, 4), (1, 4),  # red, Dm, p, s, done
    ]
    off = 0
    for floats, align in members:
        off = -(-off // align) * align + 4 * floats
    deep = {32: 158000, 40: 188192, 51: 229824}[segments]
    assert -(-off // 16) * 16 == k3.smem_bytes(g) == k3.smem_bytes(g, "deep") == deep
    assert k3.smem_bytes(g, "far") > SMEM_LIMIT >= deep and k3.choose_layout(g) == "deep"
    # the packed Ldi, 89,628 B at 97 nodes, leaves shared memory
    assert (N * blk * (blk + 1) // 2) * 4 == {32: 89628, 40: 111804, 51: 142296}[segments]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_flags_and_library_per_layout(layout):
    """A layout is one -D flag into common.cuh (its index in LAYOUTS) and a
    library of its own, named by it; a geometry that names its layout is
    built in it whatever the geometry would take (the split and the stream
    at 25 nodes of order 3, where compact also fits, is how they are held
    against each other); kernel 2 ignores the layout; an unknown layout
    raises."""
    g25 = Geometry(segments=8)
    g = dataclasses.replace(g25, layout=layout)
    assert g.flags() == g25.flags() + (f"-DMPC_SMEM_LAYOUT={LAYOUTS.index(layout)}",)
    assert k3.KERNEL.geometry(g) == dataclasses.replace(g, ept=1)
    assert k3.KERNEL.flags(g)[len(NVCC_FLAGS):] == g.flags() + ("-DMPC_EPT=1",)
    name = k3.KERNEL.library_path(g).name
    assert name.startswith(f"structured_admm_n25_o3_q7_{layout}_e1_")
    others = {k3.KERNEL.library_path(dataclasses.replace(g25, layout=o)) for o in LAYOUTS}
    assert len(others) == len(LAYOUTS) == 8
    assert (k3.KERNEL.library_path(g25) == k3.KERNEL.library_path(g)) == (layout == "compact")
    assert k2.KERNEL.geometry(g) == g25 and k2.KERNEL.library_path(g) == k2.KERNEL.library_path(g25)
    assert k3.smem_bytes(g) == k3.smem_bytes(g25, layout)
    with pytest.raises(ValueError, match="layout 'packed'"):
        Geometry(layout="packed")


@pytest.mark.parametrize("ept", [1, 2])
def test_flags_and_library_per_ept(ept):
    """The z elements and rows a thread owns are one -D flag into common.cuh
    and a library of their own, named by them; a geometry that names its
    count is built at it whatever the geometry would take (two at 12
    segments, where one fits, is how the two are held against each other),
    in the layout the geometry takes at that count; kernel 2 ignores it;
    a count below 1 raises."""
    g37 = Geometry(segments=12)
    g = dataclasses.replace(g37, ept=ept)
    assert g.flags() == g37.flags() + (f"-DMPC_EPT={ept}",)
    built = k3.KERNEL.geometry(g)
    assert built == dataclasses.replace(g, layout="stream")
    assert k3.KERNEL.flags(g)[len(NVCC_FLAGS):] == g37.flags() + ("-DMPC_SMEM_LAYOUT=3",
                                                                  f"-DMPC_EPT={ept}")
    assert k3.KERNEL.library_path(g).name.startswith(f"structured_admm_n37_o3_q7_stream_e{ept}_")
    assert (k3.KERNEL.library_path(g37) == k3.KERNEL.library_path(g)) == (ept == 1)
    assert k3.KERNEL.geometry(Geometry(segments=15)).ept == 2
    assert k2.KERNEL.geometry(g) == g37 and k2.KERNEL.library_path(g) == k2.KERNEL.library_path(g37)
    assert k3.threads(g) == {1: 992, 2: 512}[ept]
    with pytest.raises(ValueError, match="ept -1"):
        Geometry(ept=-1)


@pytest.fixture(scope="module", params=[8, 12, 15, 20, 25, 32],
                ids=["25_nodes", "37_nodes", "46_nodes", "61_nodes", "76_nodes", "97_nodes"])
def seg8_solve(request):
    """The port's planner with its OCP swapped for 8 (or 12, 15, 20, 25, 32) segments,
    solved on the CPU at float64 on the first two states of that segment
    count's JAX fixture (the first one at 32 segments, whose solve of two
    takes ~30 s), and the capture key before and after the swap."""
    segments = request.param
    fx = np.load(SEG_FIXTURES[segments])
    n = 1 if segments == 32 else B
    cur = torch.as_tensor(fx["current"][:n].astype(np.float64))
    tgt = torch.as_tensor(fx["target"][:n].astype(np.float64))
    planner = _planner()
    solve = capture_solve(planner, cur, tgt)
    args = {"current_state": cur, "target_state": tgt}
    key19 = solve._key(args, None)
    planner.ocp = make_ocp(planner.model, planner.tool_frame, order=3, num_segments=segments)
    key_new = solve._key(args, None)
    kernels.reset_launch_counts()
    sol = solve(cur, tgt)
    counts = kernels.launch_counts()
    return fx, planner, sol, key19, key_new, counts


def test_capture_key_follows_the_ocp(seg8_solve):
    """A planner whose OCP is swapped after a capture is another key, so
    the 19-node graph is never replayed for it; on the CPU the solve is the
    eager one, on the new transcription."""
    _, planner, sol, key19, key_new, counts = seg8_solve
    g = Geometry.of_ocp(planner.ocp)
    assert key19 != key_new and key19[:-1] == key_new[:-1]
    assert key_new[-1] == g != Geometry() and key19[-1] == Geometry()
    n = sol.z.shape[0]
    assert sol.z.shape == (n, g.num_var) and sol.lam_c.shape == (n, g.num_rows)
    assert (g.num_var, g.num_rows) in ((526, 648), (778, 968), (967, 1208), (1282, 1608),
                                       (1597, 2008), (2038, 2568))
    assert set(counts.values()) == {0}


def test_seg8_fixture_is_the_jax_solve_of_the_headline_states(seg8_solve):
    """The fixture holds the first 64 headline states and the JAX solve of
    them at 8 (or 12, 15, 20, 25, 32) segments (``make_torch_seg8_fixture.py``); the port's
    plain solve of its first states matches its final times and iterates to
    the fixture's float32 rounding, and lands in the target box."""
    fx, planner, sol, *_ = seg8_solve
    hs = np.load(HEADLINE_STATES)
    for k in ("current", "target"):
        np.testing.assert_array_equal(fx[k], hs[k][:64])
    assert fx["z"].shape == (64, planner.ocp.num_var) and fx["qp_converged"].shape == (64, 2)
    n = sol.z.shape[0]
    np.testing.assert_allclose(sol.final_time.numpy(), fx["final_time"][:n], rtol=1e-6)
    np.testing.assert_allclose(sol.z.numpy(), fx["z"][:n], rtol=1e-6, atol=1e-6)
    assert sol.qp_converged.tolist() == fx["qp_converged"][:n].tolist()
    np.testing.assert_array_equal(sol.qp_iterations.numpy(), fx["qp_iterations"][:n])
    tgt = torch.as_tensor(fx["target"][:n].astype(np.float64))
    err = (sol.x_at(1.0) - tgt).abs().amax(-1)
    assert bool((err <= planner.target_eps + planner.qp_settings.eps_abs).all())
