"""PyTorch port: what makes the solve capturable into a CUDA graph, on the
CPU. Kernel 2's ok-flag repair in a batch of fixed shape and the jitter
retry under a mask give what the data-dependent forms gave; the device-side
counts; ``capture_solve`` of a CPU planner is the eager solve. The graph
itself needs the card: ``chip_smoke.py`` holds every captured path against
the eager one there."""

import dataclasses

import pytest
import torch

from mpc_motion_planner_tpu_torch import config, kernels
from mpc_motion_planner_tpu_torch.kernels import banded_factor as k2
from mpc_motion_planner_tpu_torch.kernels.build import DeviceCount
from mpc_motion_planner_tpu_torch.ops import qp_structured
from mpc_motion_planner_tpu_torch.ops.sqp import SQPSettings
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner
from mpc_motion_planner_tpu_torch.utils.capture import CapturedSolve, capture_solve

torch.set_num_threads(1)

KEYS = ("Ldi", "Lsub", "u", "s")


def _spd_band(B, seed=1):
    """A diagonally dominant (B, 19, 4, 21, 21) float64 band and its arrow."""
    g = torch.Generator().manual_seed(seed)
    Mband = 0.05 * torch.rand(B, 19, 4, 21, 21, generator=g, dtype=torch.float64)
    diag = Mband[:, :, 0]
    Mband[:, :, 0] = diag + diag.transpose(-1, -2) + 4.0 * torch.eye(21, dtype=torch.float64)
    p_col = torch.rand(B, 19, 21, generator=g, dtype=torch.float64)
    m_pp = torch.full((B,), 50.0, dtype=torch.float64)
    return Mband, p_col, m_pp


def _flagged_kernel_output(Mband, p_col, m_pp, flagged):
    """A stand-in for kernel 2's output: factors that differ from the plain
    ones everywhere, ``ok`` false on ``flagged``."""
    fac = qp_structured.factor_banded(Mband, p_col, m_pp, 3)
    out = {k: fac[k] + 1.0 for k in KEYS}
    ok = torch.ones(Mband.shape[0], dtype=torch.bool)
    ok[flagged] = False
    out["ok"] = ok
    return out


def _data_dependent_repair(fac, Mband, p_col, m_pp):
    """The repair before it had a fixed shape: the flagged problems, found by
    ``nonzero``, refactored in one batch of their own."""
    bad = (~fac["ok"]).nonzero()[:, 0]
    if bad.numel():
        fix = qp_structured.factor_banded(Mband[bad], p_col[bad], m_pp[bad], 3)
        for k in KEYS:
            fac[k][bad] = fix[k]
    return fac


@pytest.fixture(autouse=True)
def zero_counts():
    kernels.reset_launch_counts()
    yield
    kernels.reset_launch_counts()


# A batch of one takes another matrix-vector routine on the CPU (torch's
# batched product of a single matrix), whose last bits differ from the
# batched one's: every batch compared bitwise here holds two problems or more.
@pytest.mark.parametrize("flagged", [[], [5, 40], [2, 5, 40, 66]],
                         ids=["none", "at_capacity", "overflow"])
def test_fixed_shape_repair_equals_data_dependent_repair(flagged):
    """B=72 holds two repair slots (repair_capacity): no flag, two flags, and
    four flags (two beyond the capacity, repaired by the eager second pass
    and counted in OVERFLOW) give the data-dependent repair's factors
    bitwise, and REPAIRS counts every flagged problem."""
    B = 72
    assert k2.repair_capacity(B) == 2 and k2.repair_capacity(64) == 1
    assert k2.repair_capacity(1) == 1 and k2.repair_capacity(2048) == 32
    Mband, p_col, m_pp = _spd_band(B)
    got = k2.repair(_flagged_kernel_output(Mband, p_col, m_pp, flagged), Mband, p_col, m_pp, 3)
    ref = _data_dependent_repair(_flagged_kernel_output(Mband, p_col, m_pp, flagged),
                                 Mband, p_col, m_pp)
    for k in KEYS + ("ok",):
        assert torch.equal(got[k], ref[k]), k
    plain = qp_structured.factor_banded(Mband, p_col, m_pp, 3)
    others = [i for i in range(B) if i not in flagged]
    for k in KEYS:  # repaired problems carry the plain factors, the others kernel 2's
        assert torch.equal(got[k][flagged], plain[k][flagged])
        assert torch.equal(got[k][others], plain[k][others] + 1.0)
    assert k2.REPAIRS.count == len(flagged)
    assert k2.OVERFLOW.count == max(0, len(flagged) - 2)


def test_masked_jitter_retry_equals_the_retry_on_demand():
    """Problems whose first node block is the singular all-ones matrix break
    down; they take the factors of their band with the diagonal scaled by
    1 + 1e-4, the others their own, bitwise as in batches of their own; ok
    stays kernel 2's flag on the un-jittered band."""
    B, bad, good = 4, [1, 2], [0, 3]
    Mband, p_col, m_pp = _spd_band(B, seed=3)
    Mband[bad, 0, 0] = torch.ones(21, 21, dtype=torch.float64)
    got = qp_structured.factor_banded(Mband, p_col, m_pp, 3)
    assert got["ok"].tolist() == [True, False, False, True]
    assert all(bool(torch.isfinite(got[k]).all()) for k in KEYS)
    def once(Mb, i):  # one factorization, no retry
        Ldi, Lsub, _ = qp_structured.banded_cholesky(Mb[i], 3)
        u = qp_structured.banded_solve(Ldi, Lsub, p_col[i])
        return {"Ldi": Ldi, "Lsub": Lsub, "u": u, "s": m_pp[i] - (u * p_col[i]).sum(dim=(1, 2))}

    jittered = Mband.clone()
    jittered[:, :, 0].diagonal(dim1=-2, dim2=-1).mul_(1.0 + 1e-4)
    retried, rest = once(jittered, bad), once(Mband, good)
    for k in KEYS:
        assert torch.equal(got[k][bad], retried[k]), k
        assert torch.equal(got[k][good], rest[k]), k


def test_device_count_adds_without_reading():
    c = DeviceCount()
    assert c.count == 0
    c.add(torch.tensor(3))
    c.add(torch.tensor(True).sum())
    assert c.count == 4
    c.reset()
    assert c.count == 0


def _planner():
    return MotionPlanner(margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1), dtype=torch.float64,
                         device="cpu", qp_settings=dataclasses.replace(
                             config.SHIPPING_QP_SETTINGS, max_iter=60),
                         sqp_settings=SQPSettings(max_iter=1))


def _states(planner, B=3):
    lim = planner.limits
    cur = torch.zeros(B, 14, dtype=torch.float64)
    cur[:, :7] = (lim.max_position + lim.min_position) / 2
    tgt = cur.clone()
    tgt[:, :7] += torch.linspace(-0.3, 0.3, B, dtype=torch.float64)[:, None]
    return cur, tgt


def test_capture_solve_on_cpu_is_the_eager_solve():
    """A CPU planner is solved eagerly: ``captured`` is False, nothing is
    captured, the Solution is the eager one bitwise, a hot restart too."""
    planner = _planner()
    cur, tgt = _states(planner)
    solve = capture_solve(planner, cur, tgt)
    assert isinstance(solve, CapturedSolve) and solve.captured is False and not solve.graphs
    got, ref = solve(cur, tgt), planner.solve(cur, tgt)
    for f in ("z", "lam_c", "lam_x", "violation", "qp_iterations", "qp_converged", "step_sizes"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert torch.equal(got.warm_start.phase_dt, ref.warm_start.phase_dt)
    z0 = ref.reseed_guess(cur, tgt)
    hot = solve(cur, tgt, z0=z0, lam_c0=ref.lam_c, lam_x0=ref.lam_x)
    hot_ref = planner.solve(cur, tgt, z0=z0, lam_c0=ref.lam_c, lam_x0=ref.lam_x)
    assert hot.warm_start is None and torch.equal(hot.z, hot_ref.z)
    assert solve.eager_resolves == 0
    assert set(kernels.launch_counts().values()) == {0}
    with pytest.raises(TypeError, match="unexpected"):
        capture_solve(planner, cur, tgt, warm=True)
