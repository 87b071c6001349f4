"""PyTorch port, the whole slice: ``MotionPlanner.solve`` against the JAX
planner on the first chained benchmark states of the committed fixture
(float64), plus the import guard (the port imports no JAX) and the launch
counters of the CPU path."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu.ops.qp import QPSettings as JQPSettings
from mpc_motion_planner_tpu.ops.sqp import SQPSettings as JSQPSettings
from mpc_motion_planner_tpu.planner import Margins as JMargins
from mpc_motion_planner_tpu.planner import MotionPlanner as JPlanner
from mpc_motion_planner_tpu_torch import kernels
from mpc_motion_planner_tpu_torch.config import SHIPPING_SQP_SCHEDULES
from mpc_motion_planner_tpu_torch.ops.qp import QPSettings
from mpc_motion_planner_tpu_torch.ops.sqp import SQPSettings
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_slice_b64.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)


@pytest.fixture(scope="module")
def slice_solves():
    """The JAX planner and the port's planner on the first 4 fixture states
    (float64, the same slice configuration)."""
    fx = np.load(FIXTURE)
    cur = fx["current"][:4].astype(np.float64)
    tgt = fx["target"][:4].astype(np.float64)

    jp = JPlanner(
        margins=JMargins(*MARGINS),
        qp_settings=JQPSettings(backend="structured", rho_update_every=0, kkt_refine=0),
        sqp_settings=JSQPSettings(qp_step_schedules=SHIPPING_SQP_SCHEDULES),
    )
    ref = jp.solve(jnp.asarray(cur), jnp.asarray(tgt))

    tp = MotionPlanner(
        margins=Margins(*MARGINS),
        qp_settings=QPSettings(rho_update_every=0, kkt_refine=0),
        sqp_settings=SQPSettings(qp_step_schedules=SHIPPING_SQP_SCHEDULES),
    )
    kernels.reset_launch_counts()
    got = tp.solve(torch.as_tensor(cur), torch.as_tensor(tgt))
    counts = kernels.launch_counts()
    return ref, got, tp, tgt, counts


def test_slice_matches_jax_planner(slice_solves):
    ref, got, tp, tgt, counts = slice_solves
    assert set(counts.values()) == {0}

    np.testing.assert_allclose(got.z.numpy(), np.asarray(ref.z), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got.violation.numpy(), np.asarray(ref.violation), rtol=1e-3, atol=1e-5
    )
    assert got.qp_converged.tolist() == np.asarray(ref.qp_converged).tolist()
    np.testing.assert_allclose(
        got.qp_iterations.numpy(), np.asarray(ref.qp_iterations), rtol=0, atol=25
    )
    # the terminal state interpolated at t = 1 lands in the target box
    err = (got.x_at(1.0) - torch.as_tensor(tgt)).abs().amax(-1)
    assert bool((err <= tp.target_eps + tp.qp_settings.eps_abs).all())


def test_solution_sample_matches_jax(slice_solves):
    """Trajectory sampling (time, q, qdot, qddot, tau) on the reference's own
    iterate, so only the sampling is compared."""
    ref, got, _, _, _ = slice_solves
    same = dataclasses.replace(got, z=torch.as_tensor(np.asarray(ref.z)))
    for a, b in zip(same.sample(8), ref.sample(8)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-10)


_GUARD = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    import torch
    torch.set_num_threads(1)
    import mpc_motion_planner_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.ops.qp import QPSettings
    from mpc_motion_planner_tpu_torch.ops.sqp import SQPSettings
    from mpc_motion_planner_tpu_torch.planner import MotionPlanner
    kernels.reset_launch_counts()
    planner = MotionPlanner(qp_settings=QPSettings(max_iter=50),
                            sqp_settings=SQPSettings(qp_step_schedules="25;25"))
    cur = torch.zeros(1, 14, dtype=torch.float64)
    cur[0, :7] = (planner.limits.max_position + planner.limits.min_position) / 2
    tgt = cur.clone()
    tgt[0, :7] += 0.2
    sol = planner.solve(cur, tgt)
    assert sol.z.shape == (1, 400) and bool(torch.isfinite(sol.z).all())
    assert bool((sol.qp_iterations <= 25).all())
    counts = kernels.launch_counts()
    assert set(counts.values()) == {0}, counts
    bad = [m for m, mod in sys.modules.items() if mod is not None and (
        m == "jax" or m.startswith("jax.") or m.startswith("mpc_motion_planner_tpu."))]
    assert not bad, bad
    print("modules", len(names))
    """
)


def test_port_imports_no_jax_and_cpu_path_launches_no_kernel():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.split()[-1]) >= 20


def test_step_budgets():
    from mpc_motion_planner_tpu_torch.ops.sqp import step_qp_settings

    qs = QPSettings()
    budgets = [s.max_iter for s in step_qp_settings(SQPSettings(qp_step_schedules=SHIPPING_SQP_SCHEDULES), qs)]
    assert budgets == [700, 500]
    budgets = [s.max_iter for s in step_qp_settings(SQPSettings(max_iter=3, qp_step_schedules="100"), qs)]
    assert budgets == [100, 100, 100]
    with pytest.raises(ValueError):
        step_qp_settings(SQPSettings(qp_step_schedules=";"), qs)
