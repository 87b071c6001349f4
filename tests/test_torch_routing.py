"""PyTorch port: how the kernel wrappers route. CPU tensors take the plain
versions and count no launch; the kernel entry points refuse anything but
contiguous float32 CUDA tensors; other devices and other problem shapes
raise instead of falling back."""

import pytest
import torch

from mpc_motion_planner_tpu_torch import kernels
from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
from mpc_motion_planner_tpu_torch.kernels import constraints as k1
from mpc_motion_planner_tpu_torch.kernels import structured_admm as k3
from mpc_motion_planner_tpu_torch.kernels.build import BUILD_DIR, check_cuda_tensor
from mpc_motion_planner_tpu_torch.models.panda import make_panda_model
from mpc_motion_planner_tpu_torch.ocp import make_ocp
from mpc_motion_planner_tpu_torch.ops import qp_structured
from mpc_motion_planner_tpu_torch.ops.sqp import hessian_regularization_diag, qp_subproblem
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
    assert k2.REPAIRS.count == 0


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


def test_kernel_entry_points_refuse_cpu_tensors(ocp):
    X, U = (t.float() for t in _xu())
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        k1.node_constraints_kernel(ocp, X, U, True)
    Mband, p_col, m_pp = (t.float() for t in _spd_band())
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        k2.factor_banded_kernel(Mband, p_col, m_pp)


def test_kernel3_refuses_cpu_tensors():
    """The host part of the card's QP solve runs on CPU data up to the
    launch (scaling, the routed factorization), then kernel 3 refuses it."""
    planner = MotionPlanner(margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1), dtype=torch.float32)
    cur = torch.zeros(1, 14)
    cur[0, :7] = (planner.limits.max_position + planner.limits.min_position) / 2
    tgt = cur.clone()
    tgt[0, :7] += 0.3
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    _, _, sa, args = qp_subproblem(planner.ocp, planner.nlp_bounds(cur, tgt), z0)
    P = hessian_regularization_diag(planner.ocp, 1, torch.float32, "cpu", 0.01)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        k3.solve_box_qp_structured_cuda(planner.ocp, sa, P, *args, planner.qp_settings)


def test_check_cuda_tensor_reports_what_is_wrong():
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        check_cuda_tensor("t", torch.zeros(2, 3), (2, 3))
    meta = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        check_cuda_tensor("t", meta, (2, 3))


def test_kernels_refuse_other_transcriptions():
    other = make_ocp(make_panda_model(), num_segments=5)
    with pytest.raises(NotImplementedError, match="19-node"):
        k3._check_geometry(other)
    k3._check_geometry(make_ocp(make_panda_model()))


def test_kernel_libraries_are_named_by_source_hash():
    paths = {name: k.library_path() for name, k in kernels.KERNELS.items()}
    for name, path in paths.items():
        assert path.parent == BUILD_DIR
        assert path.name.startswith(name + "_") and path.suffix == ".so"
        assert path == kernels.KERNELS[name].library_path()  # stable
    assert len(set(paths.values())) == 3
