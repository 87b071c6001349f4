"""PyTorch port: the user entry points and the modules under them, against
the JAX package: the record writers and reader (byte for byte the same
text), the analysis of the committed acceptance artifact, the benchmark
records and trajectory checks on a shared ``z``, and the headline, the
acceptance and the offline-trajectory example run on the CPU at a small
size."""

import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu.bench import analysis as janalysis
from mpc_motion_planner_tpu.bench import harness as jharness
from mpc_motion_planner_tpu.planner import Margins as JMargins
from mpc_motion_planner_tpu.planner import MotionPlanner as JPlanner
from mpc_motion_planner_tpu.planner import Solution as JSolution
from mpc_motion_planner_tpu.utils import io as jio
from mpc_motion_planner_tpu_torch.bench import acceptance, analysis, harness, headline
from mpc_motion_planner_tpu_torch.examples import offline_trajectory
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner, Solution
from mpc_motion_planner_tpu_torch.utils import io as tio

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "analysis", "benchmark_data_r05.txt.gz")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_slice_b64.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)
# every key of the JAX headline's line (bench/headline.py)
JAX_HEADLINE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "batch", "batch_wall_s", "amortized_ms_per_solve",
    "tol_hit_rate", "tol_threshold", "terminal_err_inf_max", "node_terminal_err_max",
    "median_violation", "p90_violation", "qp_conv_rate", "qp_max_iter", "kkt_refine",
    "exit_every", "exit_warmup", "exit_schedule", "sqp_schedules", "rescue_iters", "ruiz_iters",
    "rho", "alpha", "fused_constraints", "qp_backend", "device",
)


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def planners():
    jp = JPlanner(margins=JMargins(*MARGINS), dtype=jnp.float64)
    tp = MotionPlanner(margins=Margins(*MARGINS), dtype=torch.float64, device="cpu")
    return jp, tp


def _assert_tables_equal(got, ref):
    """Dicts of counts equal, of floats within 1e-12."""
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        if isinstance(r, dict):
            _assert_tables_equal(got[k], r)
        elif isinstance(r, int):
            assert got[k] == r, k
        else:
            assert got[k] == pytest.approx(r, rel=1e-12, abs=1e-12), k


# ---------------------------------------------------------------------------
# records, writers and the analysis tables
# ---------------------------------------------------------------------------

def test_analysis_of_the_acceptance_artifact_matches_jax(planners):
    jp, tp = planners
    rec = tio.read_benchmark_records(ARTIFACT)
    np.testing.assert_array_equal(rec, jio.read_benchmark_records(ARTIFACT))
    assert rec.shape == (1000, 162)
    d_t, d_j = analysis.decode(rec), janalysis.decode(rec)
    assert d_t.keys() == d_j.keys()
    for k in d_j:
        np.testing.assert_array_equal(d_t[k], d_j[k])
    _assert_tables_equal(analysis.violation_counts(rec, tp.limits, tp.margins),
                         janalysis.violation_counts(rec, jp.limits, jp.margins))
    _assert_tables_equal(analysis.violation_counts_reference(rec, tp.limits),
                         janalysis.violation_counts_reference(rec, jp.limits))
    _assert_tables_equal(analysis.violation_magnitudes(rec, tp.limits, tp.margins),
                         janalysis.violation_magnitudes(rec, jp.limits, jp.margins))
    _assert_tables_equal(analysis.accuracy_stats(rec), janalysis.accuracy_stats(rec))
    # the numbers RESULTS.md reports for this artifact
    ref = analysis.violation_counts_reference(rec, tp.limits)
    for cat in ("position_fails", "velocity_fails", "torqueAccel_fails", "Jerk_fails"):
        assert ref["mpc"][cat] == 0
    assert ref["mpc"]["total"] == 267 and ref["ruckig"]["total"] == 290
    acc = analysis.accuracy_stats(rec)
    assert acc["mpc"]["within_box_plus_tol"] == 1.0
    assert acc["mpc"]["err_inf_max"] <= 1e-2 + 1e-6
    assert acc["ruckig"]["within_target_box"] == 1.0


def test_writers_give_the_jax_text_and_read_back(tmp_path):
    rng = np.random.default_rng(3)
    records = rng.normal(size=(5, 162)).astype(np.float32)
    for name, write, data in (("torch.txt", tio.write_benchmark_records, T(records)),
                              ("jax.txt", jio.write_benchmark_records, records)):
        write(tmp_path / name, data)
        write(tmp_path / name, data[:2])  # appends
    assert (tmp_path / "torch.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    back = tio.read_benchmark_records(tmp_path / "torch.txt")
    assert back.shape == (7, 162)
    np.testing.assert_array_equal(back[:5], records)
    tio.write_benchmark_records(tmp_path / "torch.txt", T(records[:1]), append=False)
    assert tio.read_benchmark_records(tmp_path / "torch.txt").shape == (1, 162)

    traj = lambda: tuple(rng.normal(size=s) for s in ((11,), (11, 7), (11, 7), (11, 7), (11, 7)))
    target, rk, mpc = rng.normal(size=14), traj(), traj()
    tio.write_optimal_solution(str(tmp_path / "sub" / "sol_t.txt"), T(target),
                               tuple(map(T, rk)), tuple(map(T, mpc)))
    jio.write_optimal_solution(str(tmp_path / "sub" / "sol_j.txt"), target, rk, mpc)
    assert (tmp_path / "sub" / "sol_t.txt").read_bytes() == \
        (tmp_path / "sub" / "sol_j.txt").read_bytes()
    data = np.loadtxt(tmp_path / "sub" / "sol_t.txt")
    assert data.shape == (1 + 11 + 11, 29)
    np.testing.assert_array_equal(data[0, 1:15], target)


# ---------------------------------------------------------------------------
# benchmark records and trajectory checks on a shared z
# ---------------------------------------------------------------------------

def _solutions(planners, B=8):
    """A JAX and a port Solution on the fixture's first B iterates (float64),
    with each package's own OTG warm start and zeros elsewhere."""
    jp, tp = planners
    fx = np.load(FIXTURE)
    cur, tgt, z = (fx[k][:B].astype(np.float64) for k in ("current", "target", "z"))
    zeros_j = lambda *s: jnp.zeros(s, jnp.float64)
    zeros_t = lambda *s: torch.zeros(s, dtype=torch.float64)
    n_c = jp.ocp.num_eq + jp.ocp.num_ineq
    sol_j = JSolution(
        ocp=jp.ocp, z=jnp.asarray(z), lam_c=zeros_j(B, n_c), lam_x=zeros_j(B, z.shape[1]),
        violation=zeros_j(B), qp_iterations=jnp.zeros((B, 2), jnp.int32),
        qp_converged=jnp.zeros((B, 2), bool), step_sizes=zeros_j(B, 2),
        warm_start=jp.plan_warm_start(jnp.asarray(cur), jnp.asarray(tgt)))
    sol_t = Solution(
        ocp=tp.ocp, z=T(z), lam_c=zeros_t(B, n_c), lam_x=zeros_t(B, z.shape[1]),
        violation=zeros_t(B), qp_iterations=torch.zeros(B, 2, dtype=torch.int32),
        qp_converged=torch.zeros(B, 2, dtype=torch.bool), step_sizes=zeros_t(B, 2),
        warm_start=tp.plan_warm_start(T(cur), T(tgt)))
    return sol_j, sol_t, tgt


def test_benchmark_records_match_jax(planners):
    jp, tp = planners
    sol_j, sol_t, tgt = _solutions(planners)
    rec_j, rk_j, mpc_j = jax.jit(lambda s, t: jharness.benchmark_records(jp, s, t))(
        sol_j, jnp.asarray(tgt))
    rec_t, rk_t, mpc_t = harness.benchmark_records(tp, sol_t, T(tgt))
    assert rec_t.shape == (8, 162) and rec_t.dtype == torch.float64
    np.testing.assert_allclose(rec_t.numpy(), np.asarray(rec_j), rtol=0, atol=1e-9)
    for got, ref in ((rk_t, rk_j), (mpc_t, mpc_j)):
        for f in ("jerk", "linear_velocity", "angular_velocity", "collision"):
            assert getattr(got, f).dtype == torch.int32
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    np.testing.assert_array_equal(rec_t[:, analysis.FLAGS].numpy(),
                                  np.asarray(rec_j)[:, analysis.FLAGS])
    # the checks and extrema alone, on the MPC samples, against the JAX ones
    samples = sol_t.sample(harness.N_CHECK_POINTS)
    checks = harness.validate_trajectory(tp, *samples[:4])
    for f in ("jerk", "linear_velocity", "angular_velocity", "collision"):
        np.testing.assert_array_equal(getattr(checks, f).numpy(), np.asarray(getattr(mpc_j, f)))
    mn, mx = harness._traj_extrema(*samples)
    np.testing.assert_allclose(mn.numpy(), np.asarray(rec_j)[:, 56:84], rtol=0, atol=1e-9)
    np.testing.assert_allclose(mx.numpy(), np.asarray(rec_j)[:, 84:112], rtol=0, atol=1e-9)


def test_benchmark_records_of_a_hot_restart_need_a_warm_start(planners):
    _, tp = planners
    _, sol_t, tgt = _solutions(planners, B=2)
    hot = dataclasses.replace(sol_t, warm_start=None)
    with pytest.raises(ValueError, match="hot-restart"):
        harness.benchmark_records(tp, hot, T(tgt))
    rec, _, _ = harness.benchmark_records(tp, hot, T(tgt), warm_start=sol_t.warm_start)
    assert rec.shape == (2, 162)


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------

def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def test_headline_line_on_cpu(monkeypatch):
    env = {"BENCH_BATCH": "8", "BENCH_QP_BACKEND": "structured", "BENCH_REPEATS": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for k in headline.BUDGET_VARIABLES + ("BENCH_SQP_SCHEDULES",):
        monkeypatch.delenv(k, raising=False)
    lines = _run(headline.main, ["--device", "cpu"]).strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(JAX_HEADLINE_KEYS) <= line.keys()
    assert line["package"] == "torch" and line["device"] == "cpu"
    assert line["fused_constraints"] == "off" and line["qp_backend"] == "structured"
    assert line["batch"] == 8 and line["qp_max_iter"] == 700 and line["sqp_schedules"] == ""
    assert line["states"].endswith("headline_states_b2048.npz[:8]")
    assert line["value"] == pytest.approx(8 / line["batch_wall_s"])
    # on the CPU the solve is eager, and the eager keys are the same solves
    assert line["solve"] == "eager" and line["eager_batch_wall_s"] == line["batch_wall_s"]
    assert line["eager_solves_per_s"] == line["value"]
    assert line["repairs"] == 0 and line["eager_resolves"] == 0
    # the quality fields of a solve of the same 8 states with the same settings
    s = headline.settings_from_env(env)
    planner = headline.make_planner(s, "cpu")
    cur, tgt, _ = headline.headline_states(planner, 8)
    assert cur.dtype == torch.float32
    sol = planner.solve(cur, tgt)
    err = (sol.x_at(1.0) - tgt).abs().amax(-1)
    viol = sol.violation.double().numpy()
    assert line["tol_threshold"] == pytest.approx(0.011)
    assert line["tol_hit_rate"] == float((err <= 0.011).double().mean())
    assert line["terminal_err_inf_max"] == float(err.max())
    assert line["node_terminal_err_max"] == float((sol.states()[0][:, -1] - tgt).abs().max())
    assert line["median_violation"] == float(np.median(viol))
    assert line["p90_violation"] == float(np.percentile(viol, 90))
    assert line["qp_conv_rate"] == float(sol.qp_converged.double().mean())


def test_headline_settings():
    auto = headline.settings_from_env({})
    assert auto["backend"] == "structured_pallas" and auto["sqp_schedules"] == "200,500;150,350"
    assert auto["kkt_refine"] == 0 and auto["batch"] == 2048 and auto["repeats"] == 3
    explicit = headline.settings_from_env({"BENCH_QP_MAX_ITER": "300"})
    assert explicit["max_iter"] == 300 and explicit["sqp_schedules"] == ""
    assert headline.settings_from_env({"BENCH_EXIT_WARMUP": "200"})["sqp_schedules"] == ""
    both = headline.settings_from_env({"BENCH_QP_MAX_ITER": "300",
                                       "BENCH_SQP_SCHEDULES": "auto"})
    assert both["sqp_schedules"] == "200,500;150,350"
    dense = headline.settings_from_env({"BENCH_QP_BACKEND": "pallas"})
    assert dense["kkt_refine"] == 1 and dense["sqp_schedules"] == ""
    with pytest.raises(ValueError, match="nonsense"):
        headline.settings_from_env({"BENCH_QP_BACKEND": "nonsense"})


def test_headline_refuses_an_unknown_backend(monkeypatch):
    monkeypatch.setenv("BENCH_QP_BACKEND", "nonsense")
    with pytest.raises(ValueError):
        headline.main(["--device", "cpu"])


def test_acceptance_on_cpu(tmp_path, planners):
    out = tmp_path / "records.txt"
    text = _run(acceptance.main, ["--device", "cpu", "--x64", "--n", "8", "--batch", "4",
                                  "--out", str(out)])
    rec = tio.read_benchmark_records(out)
    assert rec.shape == (8, 162) and np.isfinite(rec).all()
    assert sum(ln.startswith("batch ") for ln in text.splitlines()) == 2
    for title in ("STRICT convention", "REFERENCE convention", "violation magnitudes",
                  "accuracy:", "soft_box_dual_max"):
        assert title in text
    # the printed reference-convention table is the one of the written records
    block = text[text.index("REFERENCE convention"):text.index("violation magnitudes")]
    printed = json.loads(block[block.index("{"):])
    assert printed == analysis.violation_counts_reference(rec, planners[1].limits)


def test_acceptance_states_from_records(planners):
    _, tp = planners
    rec = tio.read_benchmark_records(ARTIFACT)[:8]
    cur, tgt = acceptance.states_from_records(tp, ARTIFACT, 8)
    np.testing.assert_array_equal(tgt.numpy(), rec[:, analysis.TARGET])
    np.testing.assert_array_equal(cur[1:].numpy(), rec[:-1, analysis.TARGET])
    mid = (tp.limits.max_position + tp.limits.min_position) / 2
    assert torch.equal(cur[0, :7], mid) and torch.equal(cur[0, 7:], torch.zeros(7, dtype=torch.float64))
    # the artifact's targets are float32 values: the float32 chain is exact
    p32 = MotionPlanner(margins=Margins(*MARGINS), dtype=torch.float32, device="cpu")
    _, tgt32 = acceptance.states_from_records(p32, ARTIFACT, 8)
    np.testing.assert_array_equal(tgt32.double().numpy(), rec[:, analysis.TARGET])


def test_offline_trajectory_on_cpu(tmp_path):
    out = tmp_path / "optimal_solution.txt"
    _run(offline_trajectory.main, ["--device", "cpu", "--seed", "3", "--out", str(out)])
    data = np.loadtxt(out)
    assert data.shape == (1 + 201 + 201, 29) and np.isfinite(data).all()
    v_gap, q_err = offline_trajectory.check_solution_file(out)
    assert v_gap < 5e-3 and q_err <= 0.011
