"""PyTorch port, the whole slice: ``MotionPlanner.solve`` against the JAX
planner on the first chained benchmark states of the committed fixture,
with the structured QP (float64), the default dense "xla" QP (float64) and
the dense "pallas" QP (float32); ``sqp_solve`` with a Hessian callback; the
settings defaults against the JAX package's; the import guard (the port
imports no JAX) and the launch counters of the CPU path."""

import dataclasses
import inspect
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu import config as jconfig
from mpc_motion_planner_tpu.ops import sqp as jsqp
from mpc_motion_planner_tpu.ops.qp import QPSettings as JQPSettings
from mpc_motion_planner_tpu.ops.sqp import SQPSettings as JSQPSettings
from mpc_motion_planner_tpu.planner import Margins as JMargins
from mpc_motion_planner_tpu.planner import MotionPlanner as JPlanner
from mpc_motion_planner_tpu_torch import config, kernels
from mpc_motion_planner_tpu_torch.config import SHIPPING_SQP_SCHEDULES
from mpc_motion_planner_tpu_torch.ops import sqp as tsqp
from mpc_motion_planner_tpu_torch.ops.qp import QPSettings
from mpc_motion_planner_tpu_torch.ops.sqp import SQPSettings
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_slice_b64.npz")
DENSE_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_dense_b64.npz")
HEADLINE_STATES = os.path.join(ROOT, "tests", "fixtures", "headline_states_b2048.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)


def test_headline_states_extend_the_fixture_states():
    """The headline's own B=2048 chained states, which chip_smoke.py solves,
    begin with the 64 states of both JAX fixtures: one draw of
    chain_states(PRNGKey(0)) at float32."""
    hs = np.load(HEADLINE_STATES)
    assert hs["current"].shape == hs["target"].shape == (2048, 14)
    assert hs["current"].dtype == hs["target"].dtype == np.float32
    np.testing.assert_array_equal(hs["current"][1:], hs["target"][:-1])
    for path in (FIXTURE, DENSE_FIXTURE):
        fx = np.load(path)
        for k in ("current", "target"):
            np.testing.assert_array_equal(hs[k][:64], fx[k], err_msg=f"{path} {k}")


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
        qp_settings=QPSettings(backend="structured", rho_update_every=0, kkt_refine=0),
        sqp_settings=SQPSettings(qp_step_schedules=SHIPPING_SQP_SCHEDULES),
        device="cpu",
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


# the headline's dense configuration (bench/headline.py, BENCH_QP_BACKEND=pallas)
DENSE_PALLAS = dict(backend="pallas", kkt_refine=1, rho_update_every=0, kkt_factor="lu",
                    ruiz_iters=2, rho=0.1, alpha=1.6, max_iter=700, check_every=25)


@pytest.fixture(scope="module")
def dense_solves():
    """The default planners of both packages (dense "xla" QP, adaptive rho)
    at float64, and the dense "pallas" configuration at float32 (the JAX
    kernel in interpret mode, the port's plain version), on the first 2
    fixture states."""
    fx = np.load(FIXTURE)
    cur, tgt = fx["current"][:2], fx["target"][:2]
    out = {}
    for name, dt, (jdt, tdt) in (
        ("default", {}, (jnp.float64, torch.float64)),
        ("pallas", DENSE_PALLAS, (jnp.float32, torch.float32)),
    ):
        jp = JPlanner(margins=JMargins(*MARGINS), qp_settings=JQPSettings(**dt), dtype=jdt)
        ref = jp.solve(jnp.asarray(cur, jdt), jnp.asarray(tgt, jdt))
        tp = MotionPlanner(margins=Margins(*MARGINS), qp_settings=QPSettings(**dt), dtype=tdt,
                           device="cpu")
        kernels.reset_launch_counts()
        got = tp.solve(torch.as_tensor(cur, dtype=tdt), torch.as_tensor(tgt, dtype=tdt))
        out[name] = (ref, got, kernels.launch_counts())
    return out


def test_default_planner_matches_jax(dense_solves):
    """MotionPlanner() in both packages: the dense "xla" QP with adaptive rho
    and 700/700 iterations, float64."""
    ref, got, counts = dense_solves["default"]
    assert set(counts.values()) == {0}
    assert got.qp_iterations.tolist() == np.asarray(ref.qp_iterations).tolist()
    assert got.qp_converged.tolist() == np.asarray(ref.qp_converged).tolist()
    np.testing.assert_allclose(got.final_time.numpy(), np.asarray(ref.final_time), rtol=1e-6)


def test_dense_pallas_planner_matches_jax(dense_solves):
    """The headline's dense "pallas" configuration at float32."""
    ref, got, counts = dense_solves["pallas"]
    assert set(counts.values()) == {0}
    assert got.qp_converged.tolist() == np.asarray(ref.qp_converged).tolist()
    np.testing.assert_allclose(got.final_time.numpy(), np.asarray(ref.final_time), rtol=1e-3)


def test_sqp_with_hessian_fn_matches_jax():
    """One SQP step with a dense Lagrangian Hessian callback (Gershgorin-
    regularized, dense P on the "xla" QP backend) from the warm starts of
    the first 2 fixture states, float64."""
    fx = np.load(FIXTURE)
    cur, tgt = fx["current"][:2].astype(np.float64), fx["target"][:2].astype(np.float64)
    n = 400
    H = np.random.default_rng(5).standard_normal((n, n)) * 1e-3
    H = H + H.T
    qp = dict(max_iter=300)

    jp = JPlanner(margins=JMargins(*MARGINS))
    jcur, jtgt = jnp.asarray(cur), jnp.asarray(tgt)
    ref = jsqp.sqp_solve(
        jp.ocp, jp.nlp_bounds(jcur, jtgt), jp.warm_start_vector(jp.plan_warm_start(jcur, jtgt)),
        JSQPSettings(max_iter=1), JQPSettings(**qp),
        hessian_fn=lambda z, lam: jnp.broadcast_to(jnp.asarray(H), (z.shape[0], n, n)),
    )
    tp = MotionPlanner(margins=Margins(*MARGINS), device="cpu")
    tcur, ttgt = torch.as_tensor(cur), torch.as_tensor(tgt)
    got = tsqp.sqp_solve(
        tp.ocp, tp.nlp_bounds(tcur, ttgt), tp.warm_start_vector(tp.plan_warm_start(tcur, ttgt)),
        SQPSettings(max_iter=1), QPSettings(**qp),
        hessian_fn=lambda z, lam: torch.as_tensor(H).expand(z.shape[0], n, n),
    )
    assert got.qp_iterations.tolist() == np.asarray(ref.qp_iterations).tolist()
    np.testing.assert_allclose(got.z.numpy(), np.asarray(ref.z), rtol=0, atol=1e-8)
    with pytest.raises(ValueError, match="xla"):
        tsqp.sqp_solve(
            tp.ocp, tp.nlp_bounds(tcur, ttgt), got.z, SQPSettings(max_iter=1),
            QPSettings(backend="pallas"), hessian_fn=lambda z, lam: None,
        )


@pytest.mark.parametrize("port_cls, jax_cls", [(QPSettings, JQPSettings),
                                               (SQPSettings, JSQPSettings)],
                         ids=["QPSettings", "SQPSettings"])
def test_settings_defaults_match_jax(port_cls, jax_cls):
    """Every field the port has keeps the JAX package's default."""
    port, ref = port_cls(), jax_cls()
    for f in dataclasses.fields(port_cls):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


def test_shipping_helpers_match_jax():
    """The shipping configuration: the structured solver, with the per-step
    budgets only for "structured_pallas", as in the JAX package."""
    assert config.shipping_backend("cuda") == "structured_pallas"
    assert config.shipping_backend("cpu") == "structured"
    assert config.SHIPPING_QP_SETTINGS.backend == "structured_pallas"
    config.SHIPPING_QP_SETTINGS.check_structured()
    for backend in ("xla", "pallas", "structured", "structured_pallas"):
        assert config.shipping_sqp_schedules(backend) == jconfig.shipping_sqp_schedules(backend)


def test_planner_defaults_match_jax():
    """MotionPlanner() takes the JAX package's default settings, margins,
    target box and time bounds."""
    port = inspect.signature(MotionPlanner.__init__).parameters
    ref = inspect.signature(JPlanner.__init__).parameters
    for name in ("sqp_settings", "qp_settings", "margins"):
        p, r = port[name].default, ref[name].default
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(r, f.name), (name, f.name)
    for name in ("target_eps", "time_bounds", "tool_frame"):
        assert port[name].default == ref[name].default, name


def test_planner_default_device_is_cuda():
    """The planner runs on the card unless the caller asks for the CPU: the
    signature's default is "cuda", and without a card the constructor raises
    torch's own error instead of building a CPU planner."""
    assert inspect.signature(MotionPlanner.__init__).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert MotionPlanner().device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            MotionPlanner()
    assert MotionPlanner(device="cpu").limits.max_position.device.type == "cpu"


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
    for name in ("bench.headline", "bench.acceptance", "bench.analysis", "utils.io",
                 "models.urdf", "examples.offline_trajectory"):
        assert pkg.__name__ + "." + name in names, name
    from mpc_motion_planner_tpu_torch import kernels
    from mpc_motion_planner_tpu_torch.ops.qp import QPSettings
    from mpc_motion_planner_tpu_torch.ops.sqp import SQPSettings
    from mpc_motion_planner_tpu_torch.planner import MotionPlanner
    kernels.reset_launch_counts()
    planner = MotionPlanner(qp_settings=QPSettings(max_iter=50),
                            sqp_settings=SQPSettings(qp_step_schedules="25;25"), device="cpu")
    cur = torch.zeros(1, 14, dtype=torch.float64)
    cur[0, :7] = (planner.limits.max_position + planner.limits.min_position) / 2
    tgt = cur.clone()
    tgt[0, :7] += 0.2
    sol = planner.solve(cur, tgt)
    assert sol.z.shape == (1, 400) and bool(torch.isfinite(sol.z).all())
    assert bool((sol.qp_iterations <= 25).all())
    for backend in ("pallas", "structured_pallas"):
        planner = MotionPlanner(
            qp_settings=QPSettings(backend=backend, max_iter=25, rho_update_every=0),
            device="cpu")
        assert bool(torch.isfinite(planner.solve(cur, tgt).z).all())
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
