"""PyTorch port: how the kernel wrappers route. CPU tensors take the plain
versions and count no launch; the kernel entry points refuse anything but
contiguous float32 CUDA tensors; other devices, other problem shapes and
unknown QP backends raise instead of falling back; the host-side constants
of a launch are cached per model."""

import dataclasses

import pytest
import torch

from mpc_motion_planner_tpu_torch import kernels
from mpc_motion_planner_tpu_torch.config import SHIPPING_QP_SETTINGS
from mpc_motion_planner_tpu_torch.kernels import admm_dense as k4
from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
from mpc_motion_planner_tpu_torch.kernels import constraints as k1
from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
from mpc_motion_planner_tpu_torch.kernels.build import (
    BUILD_DIR, Geometry, HostConstants, check_cuda_tensor,
)
from mpc_motion_planner_tpu_torch.models.panda import make_panda_model
from mpc_motion_planner_tpu_torch.ocp import make_ocp
from mpc_motion_planner_tpu_torch.ops import qp_structured
from mpc_motion_planner_tpu_torch.ops.qp import (
    QPSettings, pallas_operands, pallas_state, scale_dense_qp, solve_box_qp,
)
from mpc_motion_planner_tpu_torch.ops.sqp import (
    SQPSettings, hessian_regularization_diag, qp_subproblem, sqp_solve,
)
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ocp():
    return make_ocp(make_panda_model())


@pytest.fixture(autouse=True)
def no_launch():
    """Every test here must leave the launch counters at 0."""
    kernels.reset_launch_counts()
    yield
    assert set(kernels.launch_counts().values()) == {0}
    assert k2.REPAIRS.count == 0 and k3.REFACTORS.count == 0


def _xu(B=2, nodes=19, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(B, nodes, 14, generator=g, dtype=torch.float64) * 2 - 1
    U = torch.rand(B, nodes, 7, generator=g, dtype=torch.float64) * 4 - 2
    return X, U


def _spd_band(B=2, seed=1):
    """A diagonally dominant (B, 19, 4, 21, 21) band and its arrow data."""
    g = torch.Generator().manual_seed(seed)
    Mband = 0.05 * torch.rand(B, 19, 4, 21, 21, generator=g, dtype=torch.float64)
    diag = Mband[:, :, 0]
    Mband[:, :, 0] = diag + diag.transpose(-1, -2) + 4.0 * torch.eye(21, dtype=torch.float64)
    p_col = torch.rand(B, 19, 21, generator=g, dtype=torch.float64)
    m_pp = torch.full((B,), 50.0, dtype=torch.float64)
    return Mband, p_col, m_pp


@pytest.mark.parametrize("with_jac", [False, True], ids=["values", "jacobian"])
def test_constraints_route_cpu_to_plain(ocp, with_jac):
    X, U = _xu()
    got = k1.node_constraints(ocp, X, U, with_jac)
    ref = k1.node_constraints_plain(ocp, X, U, with_jac)
    for a, b in zip(got if with_jac else (got,), ref if with_jac else (ref,)):
        assert a.dtype == torch.float64
        assert torch.equal(a, b)


def test_factor_routes_cpu_to_plain():
    Mband, p_col, m_pp = _spd_band()
    got = k2.factor(Mband, p_col, m_pp, 3)
    ref = qp_structured.factor_banded(Mband, p_col, m_pp, 3)
    assert bool(got["ok"].all())
    for k in ("Ldi", "Lsub", "u", "s", "ok"):
        assert torch.equal(got[k], ref[k]), k


def _dense_chunk_inputs(B=2, n=6, m=4, seed=2):
    """Kernel 4's operands and state for small random float32 QPs."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.rand(*shape, generator=g)
    P, q, A = rnd(B, n) + 0.5, rnd(B, n) - 0.5, rnd(B, m, n) - 0.5
    lc, uc = -rnd(B, m) - 0.5, rnd(B, m) + 0.5
    lx, ux = torch.full((B, n), -2.0), torch.full((B, n), 2.0)
    settings = QPSettings(backend="pallas")
    qp = scale_dense_qp(P, q, A, lc, uc, lx, ux, settings)
    rho = torch.full((B,), settings.rho)
    return pallas_operands(qp, rho, qp.factor(rho, settings)), pallas_state(qp)


DENSE_KW = dict(chunk_iters=30, check_every=10, eps_abs=1e-3, eps_rel=1e-3, sigma=1e-6,
                alpha=1.6, kkt_refine=1)


def test_dense_chunk_routes_cpu_to_plain():
    ops, state = _dense_chunk_inputs()
    got, used = k4.admm_dense_chunk(ops, state, **DENSE_KW)
    ref, ref_used = k4.admm_dense_plain(ops, state, **DENSE_KW)
    assert torch.equal(used, ref_used) and bool((used > 0).all())
    for k in k4.STATE + ("done",):
        assert torch.equal(got[k], ref[k]), k
    # the caller's state is left as it was
    assert torch.equal(state["done"], torch.zeros_like(state["done"]))


def test_dense_chunk_kernel_refuses_cpu_tensors():
    ops, state = _dense_chunk_inputs()
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        k4.admm_dense_kernel(ops, state, **DENSE_KW)


def test_unknown_qp_backends_raise(ocp):
    B, n, m = 1, ocp.num_var, ocp.num_eq + ocp.num_ineq
    z = torch.zeros(B, n)
    with pytest.raises(ValueError, match="unknown QP backend"):
        sqp_solve(ocp, None, z, SQPSettings(), QPSettings(backend="osqp"))
    zeros = lambda *s: torch.zeros(*s, dtype=torch.float64)
    args = (zeros(B, n), zeros(B, n), zeros(B, m, n), zeros(B, m), zeros(B, m), zeros(B, n),
            zeros(B, n))
    for backend in ("osqp", "structured"):
        with pytest.raises(ValueError, match="dense backends"):
            solve_box_qp(*args, QPSettings(backend=backend))
    with pytest.raises(ValueError, match="kkt_factor"):
        solve_box_qp(*args, QPSettings(kkt_factor="qr"))


def test_structured_backends_refuse_what_is_not_ported():
    """Adaptive rho and KKT refinement run; what is refused is a check_every
    that does not divide rho_update_every."""
    for settings in (QPSettings(backend="structured"),  # adaptive rho by default
                     QPSettings(backend="structured", rho_update_every=0, kkt_refine=1),
                     QPSettings(backend="structured_pallas", rho_update_every=50)):
        settings.check_structured()
    with pytest.raises(ValueError, match="must divide rho_update_every"):
        QPSettings(backend="structured", rho_update_every=90).check_structured()


def test_cuda_solve_chunks_through_kernels_2_and_3(ocp, monkeypatch):
    """The card's structured solve under adaptive rho: every dispatch goes to
    kernel 3's wrapper with the state of the one before and every
    factorization to kernel 2's route, never to admm_plain; refactorizations
    are counted. The wrappers are stood in for by the plain versions (this
    machine has no card), admm_plain itself is made to raise."""
    B = 2
    planner = MotionPlanner(margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1), dtype=torch.float32,
                            device="cpu")
    cur = torch.zeros(B, 14)
    cur[:, :7] = (planner.limits.max_position + planner.limits.min_position) / 2
    tgt = cur.clone()
    tgt[:, :7] += torch.tensor([[0.3], [-0.2]])
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    _, _, sa, args = qp_subproblem(planner.ocp, planner.nlp_bounds(cur, tgt), z0)
    P = hessian_regularization_diag(planner.ocp, B, torch.float32, "cpu", 0.01)
    settings = QPSettings(backend="structured_pallas", max_iter=300, kkt_refine=1)
    ref = qp_structured.solve_box_qp_structured(planner.ocp, sa, P, *args, settings)

    plain, calls = qp_structured.admm_plain, {"admm": [], "factor": 0}

    def fake_kernel(ocp_, sa_, qp, fac, s, state=None, chunk_iters=None):
        calls["admm"].append((chunk_iters, None if state is None else int(state[6].max())))
        return plain(ocp_, sa_, qp, fac, s, state, chunk_iters)

    def fake_factor(*a):
        calls["factor"] += 1
        return qp_structured.factor_banded(*a)

    def refuse(*a, **k):
        raise AssertionError("admm_plain reached from the CUDA path")

    monkeypatch.setattr(k3, "admm_kernel", fake_kernel)
    monkeypatch.setattr(k3.banded_factor, "factor", fake_factor)
    monkeypatch.setattr(qp_structured, "admm_plain", refuse)
    got = k3.solve_box_qp_structured_cuda(planner.ocp, sa, P, *args, settings)
    assert [c for c, _ in calls["admm"]] == [100, 100, 100]
    assert calls["admm"][0][1] in (None, 0) and calls["admm"][1][1] == 100
    # the KKT system is refactored at every boundary; REFACTORS counts those
    # at which some rho moved
    assert calls["factor"] == 3 and 0 <= k3.REFACTORS.count <= 2
    assert torch.equal(got.x, ref.x) and torch.equal(got.iterations, ref.iterations)
    k3.REFACTORS.reset()


def test_host_constants_are_cached_per_model():
    """bake_model runs once per (model, frame, device); a second model with
    other inertial data gets its own constants."""
    m1 = make_panda_model()
    m2 = dataclasses.replace(m1, mass=2.0 * m1.mass)
    frame = m1.frame("panda_tool")
    cache = HostConstants()
    calls = []

    def bake(m):
        calls.append(m)
        return k1.bake_model(m, frame)

    c1, _ = cache.get((m1, frame), "cuda:0", lambda: bake(m1))
    assert cache.get((m1, frame), "cuda:0", lambda: bake(m1))[0] is c1
    c2, _ = cache.get((m2, frame), "cuda:0", lambda: bake(m2))
    assert len(calls) == 2 and not (c1 == c2).all()
    assert (c2 == k1.bake_model(m2, frame)[0]).all()
    # another device is another entry
    cache.get((m1, frame), "cuda:1", lambda: bake(m1))
    assert len(calls) == 3


def test_other_devices_raise(ocp):
    device = "meta"
    X, U = (t.to(device) for t in _xu(B=1))
    with pytest.raises(ValueError, match="no constraints path"):
        k1.node_constraints(ocp, X, U, False)
    Mband, p_col, m_pp = (t.to(device) for t in _spd_band(B=1))
    with pytest.raises(ValueError, match="no factor path"):
        k2.factor(Mband, p_col, m_pp, 3)
    q = torch.zeros(1, ocp.num_var, device=device)
    with pytest.raises(ValueError, match="no QP path"):
        k3.solve_box_qp_structured(ocp, None, None, q, None, None, None, None)
    ops, state = _dense_chunk_inputs()
    with pytest.raises(ValueError, match="no dense ADMM path"):
        k4.admm_dense_chunk({k: v.to(device) for k, v in ops.items()}, state, **DENSE_KW)


def test_kernel_entry_points_refuse_cpu_tensors(ocp):
    X, U = (t.float() for t in _xu())
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        k1.node_constraints_kernel(ocp, X, U, True)
    Mband, p_col, m_pp = (t.float() for t in _spd_band())
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        k2.factor_banded_kernel(Mband, p_col, m_pp)


def test_kernel1_reads_views_of_the_iterate_in_place(ocp):
    """X and U as ocp.unpack gives them (views of z: a batch stride of
    num_var, node-major rows) reach the launch uncopied; anything else is
    copied once into that layout."""
    z = torch.rand(3, ocp.num_var, dtype=torch.float32)
    X, U, _ = ocp.unpack(z)
    assert X.stride() == (ocp.num_var, 14, 1) and U.stride() == (ocp.num_var, 7, 1)
    x, u = k1._rows_in_place(X, 14), k1._rows_in_place(U, 7)
    assert x.data_ptr() == X.data_ptr() and u.data_ptr() == U.data_ptr()
    assert u.data_ptr() - x.data_ptr() == 4 * ocp.num_nodes * 14
    # float64 is cast once; rows that are not node-major are laid out anew
    x64 = k1._rows_in_place(X.double(), 14)
    assert x64.dtype == torch.float32 and x64.stride()[1:] == (14, 1)
    assert torch.equal(x64, X)
    Xt = X.transpose(1, 2).contiguous().transpose(1, 2)
    xt = k1._rows_in_place(Xt, 14)
    assert xt.data_ptr() != Xt.data_ptr() and xt.stride() == (19 * 14, 14, 1)
    assert torch.equal(xt, X)
    with pytest.raises(ValueError, match="kernel 1 takes X"):
        k1.node_constraints_kernel(ocp, X, U[:, :5], False)


def test_kernel3_refuses_cpu_tensors():
    """The host part of the card's QP solve runs on CPU data up to the
    launch (scaling, the routed factorization), then kernel 3 refuses it."""
    planner = MotionPlanner(margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1), dtype=torch.float32,
                            device="cpu")
    cur = torch.zeros(1, 14)
    cur[0, :7] = (planner.limits.max_position + planner.limits.min_position) / 2
    tgt = cur.clone()
    tgt[0, :7] += 0.3
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    _, _, sa, args = qp_subproblem(planner.ocp, planner.nlp_bounds(cur, tgt), z0)
    P = hessian_regularization_diag(planner.ocp, 1, torch.float32, "cpu", 0.01)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        k3.solve_box_qp_structured_cuda(planner.ocp, sa, P, *args, SHIPPING_QP_SETTINGS)


def test_check_cuda_tensor_reports_what_is_wrong():
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        check_cuda_tensor("t", torch.zeros(2, 3), (2, 3))
    meta = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        check_cuda_tensor("t", meta, (2, 3))


def test_kernels_refuse_other_transcriptions():
    """Kernels 2 and 3 are built per transcription, of any spline order (band
    width); order 3 at 9 segments (28 nodes) and order 4 at 6 (25 nodes) fit
    kernel 3's split layout, order 3 at 12 segments and order 4 at 9 (37
    nodes) its stream layout, order 3 at 13 and 15 segments (40 and 46
    nodes) and order 4 at 10 (41 nodes) its stream layout at two elements a
    thread, order 3 at 16 to 24 segments (49 to 73 nodes) and order 4 at 11
    to 16 (45 to 65 nodes) its lean layout, order 3 at 25 to 31 segments (76
    to 94 nodes) and order 4 at 17 to 21 (69 to 85 nodes) its far layout,
    order 3 at 32 to 51 segments (97 to 154 nodes) and order 4 at 22 to 33
    (89 to 133 nodes) its deep layout, order 3 at 52 to 58 segments (157 to
    175 nodes) and order 4 at 34 to 41 (137 to 165 nodes) its pair layout (a
    cluster of two blocks); a transcription whose block fits no layout raises
    naming its bytes: order 3 at 59 segments (178 nodes) and order 4 at 42
    (169 nodes)."""
    model = make_panda_model()
    fits = ([(3, s) for s in (4, 5, 6, 8, 9, 12, 13, 15, 16, 20, 24, 25, 31, 32, 51, 52, 58)]
            + [(2, 9), (4, 4), (4, 6), (4, 9), (4, 10), (4, 11), (4, 16), (4, 17), (4, 21),
               (4, 22), (4, 33), (4, 34), (4, 41), (5, 3)])
    for order, segments in fits:
        g = Geometry.of_ocp(make_ocp(model, order=order, num_segments=segments))
        k2.check_fits(g)
        k3.check_fits(g)
    for order, segments in ((3, 59), (4, 42)):
        g = Geometry.of_ocp(make_ocp(model, order=order, num_segments=segments))
        with pytest.raises(ValueError, match=f"needs {k3.smem_bytes(g)} B of shared memory per "
                                             f"block in its pair layout"):
            k3.check_fits(g)
        k2.check_fits(g)


def test_kernel_libraries_are_named_by_source_hash():
    paths = {name: k.library_path() for name, k in kernels.KERNELS.items()}
    for name, path in paths.items():
        assert path.parent == BUILD_DIR
        assert path.name.startswith(name + "_") and path.suffix == ".so"
        assert path == kernels.KERNELS[name].library_path()  # stable
    assert len(set(paths.values())) == len(kernels.KERNELS) == 4
