"""PyTorch port, transcriptions other than the 19-node one: the plain
structured QP at 8, 4 and 12 spline segments against the JAX ``structured``
backend (float64); the geometry of a kernel library (its ``-D`` flags, one
library per geometry and per kernel-3 layout, kernel 3's shared memory
reckoned member by member in its full, compact, split and stream layouts,
the layout each geometry takes, the ring of the split and stream layouts
modelled step by step, a geometry past the limits raising); the compiled
solve's key after the planner's OCP is swapped; and the 8- and 12-segment
JAX fixtures that ``chip_smoke.py`` phases 19 and 23 hold the card
against."""

import dataclasses
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
                for s in (8, 12)}
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


@pytest.mark.parametrize("segments", [8, 4, 12], ids=["25_nodes", "13_nodes", "37_nodes"])
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
    """The 19-node geometry's -D flags, with the full layout kernel 3 takes
    there, are the defaults common.cuh falls back to, so a build without
    flags compiles the same code; the geometry of an OCP and of its banded
    KKT matrix agree."""
    text = (CSRC / "common.cuh").read_text()
    defaults = dict(re.findall(r"#define (MPC_\w+) (\d+)", text))
    flags = dict(f[2:].split("=") for f in k3.KERNEL.geometry(Geometry()).flags())
    assert flags == defaults and len(flags) == 4 and flags["MPC_SMEM_LAYOUT"] == "0"
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
    layout, 182,432 B. 13 segments (40 nodes) need 1056 threads, past a
    block's 1024, though their stream block would fit: the fit check and
    the card's QP solve raise and name the threads, before any build or
    launch and whatever the data, so nothing falls back to the plain
    loop."""
    g28, g37, g40 = Geometry(segments=9), Geometry(segments=12), Geometry(segments=13)
    assert k3.smem_bytes(g28, "compact") == 261152 > SMEM_LIMIT
    assert k3.choose_layout(g28) == "split" and k3.smem_bytes(g28) == 180128
    k3.check_fits(g28)
    assert (k3.threads(g37), k3.smem_bytes(g37, "split")) == (992, 235344)
    assert k3.choose_layout(g37) == "stream" and k3.smem_bytes(g37) == 182432
    k3.check_fits(g37)
    assert (k3.threads(g40), k3.smem_bytes(g40)) == (1056, 195536)
    with pytest.raises(ValueError, match=r"40 nodes, order 3 and 7 joints .* needs 1056 threads "
                                         r"per block.*1024"):
        k3.check_fits(g40)
    planner = _planner(13)
    cur, tgt = _states(1)
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    _, _, sa, args = qp_subproblem(planner.ocp, planner.nlp_bounds(cur, tgt), z0)
    P = hessian_regularization_diag(planner.ocp, 1, torch.float64, "cpu", 0.01)
    with pytest.raises(ValueError, match="1056 threads"):
        k3.solve_box_qp_structured_cuda(planner.ocp, sa, P, *args, config.SHIPPING_QP_SETTINGS)
    k2.check_fits(g40)  # kernel 2's working set is per node


# (segments, order, joints): kernel 3's threads and its bytes in the full,
# compact, split and stream layouts. The split's bytes are the compact's less
# the Lsub blocks of distances 2..bw and plus a ring of bw nodes' helper
# blocks; the stream's keep no Lsub block and a ring of bw + 1 nodes' runs of
# bw blocks. The first four take the split layout, the rest the stream.
RING_GEOMETRIES = {
    (6, 4, 7): (640, 306976, 273632, 173200, 144992),
    (6, 3, 9): (640, 308464, 267216, 185680, 150704),
    (6, 3, 10): (704, 372400, 321344, 220640, 177456),
    (9, 3, 7): (736, 293488, 261152, 180128, 143088),
    (12, 3, 7): (992, 388032, 348128, 235344, 182432),
    (9, 4, 7): (928, 454544, 411120, 247200, 197808),
    (8, 3, 9): (832, 406128, 356448, 239920, 187440),
    (8, 3, 10): (928, 490288, 428800, 284880, 220112),
}


@pytest.mark.parametrize("segments, order, nq", list(RING_GEOMETRIES),
                         ids=["order4x6", "9_joints", "10_joints", "28_nodes", "37_nodes",
                              "order4x9", "9_joints_25_nodes", "10_joints_25_nodes"])
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
    threads, full, compact, split, stream = RING_GEOMETRIES[segments, order, nq]
    layout = "split" if split <= SMEM_LIMIT else "stream"
    assert k3.threads(g) == threads <= 1024
    assert tuple(k3.smem_bytes(g, name) for name in LAYOUTS) == (full, compact, split, stream)
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
    k3.check_fits(g)
    k3.check_fits(dataclasses.replace(g, layout="stream"))
    for name in LAYOUTS[:LAYOUTS.index(layout)]:
        with pytest.raises(ValueError, match=rf"needs {k3.smem_bytes(g, name)} B of shared "
                                             rf"memory per block in its {name} layout"):
            k3.check_fits(dataclasses.replace(g, layout=name))


@pytest.mark.parametrize("layout", ["split", "stream"])
def test_ring_schedule_serves_every_read(layout):
    """The ring of the split and stream layouts, modelled step by step as
    csrc/structured_admm.cu ring_step runs it (``ring_schedule``), at every
    geometry of orders 2-5 and 6-10 joints up to 1024 threads, through two
    iterations: every read, by the chain's fetch (stream) or by a helper,
    finds its node's run in its slot, copied at least LEAD steps before,
    and the copies into that slot so far are ``ring_copy_count``'s (the
    closed form from which the stream layout's chain takes the parity it
    waits for); no copy overwrites a run before it is read (so each slot's
    barrier phase is waited on before the next copy into it); an iteration
    copies 2 (N - 2 - bw) runs, as the source's header says; and a ring of
    one run fewer fails at 37 nodes."""
    text = " ".join(ln.strip().lstrip("/ ") for ln in
                    (CSRC / "structured_admm.cu").read_text().splitlines())
    assert "An iteration copies 2 (N - 2 - BW) runs" in text and "ring_schedule" in text

    def faults(g, ring):
        copies, reads = k3.ring_schedule(g, layout)
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
            elif held[1] >= 0 and n - held[1] < k3.LEAD:
                bad.append(f"step {n}: {who} reads node {m}, copied at step {held[1]}")
            elif copied[s] != k3.ring_copy_count(g, layout, m, n // N // 2, n // N % 2 == 0):
                bad.append(f"step {n}: {who} reads node {m} after {copied[s]} copies into "
                           f"its slot")
            else:
                held[2] += 1
        per_iteration = sum(1 for n, _, _ in copies if n is not None and 2 * N <= n < 4 * N)
        if per_iteration != 2 * max(N - 2 - g.order, 0):
            bad.append(f"{per_iteration} copies an iteration")
        return bad

    checked = 0
    for order in (2, 3, 4, 5):
        for nq in range(6, 11):
            for segments in range(1, 60):
                g = Geometry(segments=segments, order=order, nq=nq)
                if k3.threads(g) > 1024:
                    break
                assert faults(g, k3.ring_runs(g, layout)) == [], (g, layout)
                checked += 1
    assert checked > 150
    g37 = Geometry(segments=12)
    shorter = k3.ring_runs(g37, layout) - 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k3, "ring_runs", lambda g, lay="split": shorter)
        assert faults(g37, shorter)


@pytest.mark.parametrize("segments, order, nq, layout", [
    (6, 3, 7, "full"), (4, 3, 7, "full"), (6, 3, 6, "full"), (9, 2, 7, "full"),
    (4, 4, 7, "full"), (3, 5, 7, "full"), (8, 3, 7, "compact"), (6, 3, 8, "compact"),
    (5, 4, 7, "compact"), (6, 4, 7, "split"), (6, 3, 9, "split"), (6, 3, 10, "split"),
    (9, 3, 7, "split"), (5, 4, 8, "split"), (11, 3, 7, "split"), (12, 3, 7, "stream"),
    (9, 4, 7, "stream"), (8, 3, 9, "stream"), (8, 3, 10, "stream"), (7, 5, 7, "stream"),
])
def test_layout_of_each_geometry(segments, order, nq, layout):
    """Each geometry takes the first of full, compact, split and stream whose
    block fits, so the geometries that fit before the stream layout keep the
    layouts they had (full at 19 and 13 nodes, compact at 25, split at order
    4 x 6 and 34 nodes), and only a geometry that fits none of the first
    three takes the stream."""
    g = Geometry(segments=segments, order=order, nq=nq)
    assert k3.choose_layout(g) == layout
    fits = [k3.smem_bytes(g, name) <= SMEM_LIMIT for name in LAYOUTS]
    assert fits.index(True) == LAYOUTS.index(layout)
    assert k3.KERNEL.geometry(g) == dataclasses.replace(g, layout=layout)


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
    assert k3.KERNEL.geometry(g) == g
    assert k3.KERNEL.flags(g)[len(NVCC_FLAGS):] == g.flags()
    name = k3.KERNEL.library_path(g).name
    assert name.startswith(f"structured_admm_n25_o3_q7_{layout}_")
    others = {k3.KERNEL.library_path(dataclasses.replace(g25, layout=o)) for o in LAYOUTS}
    assert len(others) == len(LAYOUTS) == 4
    assert (k3.KERNEL.library_path(g25) == k3.KERNEL.library_path(g)) == (layout == "compact")
    assert k2.KERNEL.geometry(g) == g25 and k2.KERNEL.library_path(g) == k2.KERNEL.library_path(g25)
    assert k3.smem_bytes(g) == k3.smem_bytes(g25, layout)
    with pytest.raises(ValueError, match="layout 'packed'"):
        Geometry(layout="packed")


@pytest.fixture(scope="module", params=[8, 12], ids=["25_nodes", "37_nodes"])
def seg8_solve(request):
    """The port's planner with its OCP swapped for 8 (or 12) segments,
    solved on the CPU at float64 on the first two states of that segment
    count's JAX fixture, and the capture key before and after the swap."""
    segments = request.param
    fx = np.load(SEG_FIXTURES[segments])
    cur = torch.as_tensor(fx["current"][:B].astype(np.float64))
    tgt = torch.as_tensor(fx["target"][:B].astype(np.float64))
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
    assert sol.z.shape == (B, g.num_var) and sol.lam_c.shape == (B, g.num_rows)
    assert (g.num_var, g.num_rows) in ((526, 648), (778, 968))
    assert set(counts.values()) == {0}


def test_seg8_fixture_is_the_jax_solve_of_the_headline_states(seg8_solve):
    """The fixture holds the first 64 headline states and the JAX solve of
    them at 8 (or 12) segments (``make_torch_seg8_fixture.py``); the port's
    plain solve of its first states matches its final times and iterates to
    the fixture's float32 rounding, and lands in the target box."""
    fx, planner, sol, *_ = seg8_solve
    hs = np.load(HEADLINE_STATES)
    for k in ("current", "target"):
        np.testing.assert_array_equal(fx[k], hs[k][:64])
    assert fx["z"].shape == (64, planner.ocp.num_var) and fx["qp_converged"].shape == (64, 2)
    np.testing.assert_allclose(sol.final_time.numpy(), fx["final_time"][:B], rtol=1e-6)
    np.testing.assert_allclose(sol.z.numpy(), fx["z"][:B], rtol=1e-6, atol=1e-6)
    assert sol.qp_converged.tolist() == fx["qp_converged"][:B].tolist()
    np.testing.assert_array_equal(sol.qp_iterations.numpy(), fx["qp_iterations"][:B])
    tgt = torch.as_tensor(fx["target"][:B].astype(np.float64))
    err = (sol.x_at(1.0) - tgt).abs().amax(-1)
    assert bool((err <= planner.target_eps + planner.qp_settings.eps_abs).all())
