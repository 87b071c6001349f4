"""PyTorch port: the JAX package's last modules, on the CPU. Profiling
(``utils/profiling.py``), the batch mesh (``parallel/mesh.py``), the plots
(``bench/plots.py``), the two examples (``examples/analysis.py``,
``examples/baseline_proxy.py``) and the C++ OTG's loader
(``utils/native.py``), each against its JAX counterpart or exact values."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu.bench import analysis as janalysis
from mpc_motion_planner_tpu.models.panda import make_panda_limits as j_limits
from mpc_motion_planner_tpu_torch.bench import analysis
from mpc_motion_planner_tpu_torch.ops.qp import QPSettings
from mpc_motion_planner_tpu_torch.ops.sqp import SQPSettings
from mpc_motion_planner_tpu_torch.parallel import mesh
from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner
from mpc_motion_planner_tpu_torch.utils import profiling
from mpc_motion_planner_tpu_torch.utils.io import read_benchmark_records

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "analysis", "benchmark_data_r05.txt.gz")
MARGINS = Margins(0.8, 0.8, 0.6, 0.9, 0.1)
FAST = dict(sqp_settings=SQPSettings(max_iter=1),
            qp_settings=QPSettings(max_iter=30, check_every=10, rho_update_every=0))
SOLUTION_FIELDS = ("z", "lam_c", "lam_x", "violation", "qp_iterations", "qp_converged",
                   "step_sizes")


def _planner(dtype=torch.float64, **kw):
    return MotionPlanner(margins=MARGINS, dtype=dtype, device="cpu", **{**FAST, **kw})


def _states(planner, B):
    """B start/target pairs around the mid-range configuration."""
    lim = planner.limits
    cur = torch.zeros(B, 14, dtype=planner.dtype)
    cur[:, :7] = (lim.max_position + lim.min_position) / 2
    tgt = cur.clone()
    tgt[:, :7] += torch.linspace(-0.2, 0.2, B, dtype=planner.dtype)[:, None]
    tgt[:, 7:] = 0.05
    return cur, tgt


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


# ---------------------------------------------------------------------------
# utils/profiling.py
# ---------------------------------------------------------------------------

TIMING_KEYS = {"median_s", "min_s", "max_s"}  # profiling.py:50-52 of the JAX package
# the JAX functions' keys (profiling.py:305-313 and 216-241)
STAGE_KEYS = {"warm_start", "linearize", "qp", "line_search", "total", "batch", "solves_per_s"}
STRUCTURED_KEYS = {"warm_start", "linearize", "ruiz", "assemble_banded", "factor_xla", "qp",
                   "line_search", "total", "batch", "solves_per_s", "admm_loop_derived_s"}


def test_time_fn_and_trace(tmp_path):
    calls = []
    stats = profiling.time_fn(lambda x: calls.append(x) or x * 2.0, torch.ones(8), repeats=3,
                              warmup=2)
    assert set(stats) == TIMING_KEYS and len(calls) == 5
    assert 0.0 <= stats["min_s"] <= stats["median_s"] <= stats["max_s"]
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    assert "traceEvents" in json.loads((tmp_path / "trace" / files[0]).read_text())


def test_stage_timings_have_the_jax_keys():
    planner = _planner(torch.float32)
    cur, tgt = _states(planner, 4)
    out = profiling.stage_timings(planner, cur, tgt, repeats=1)
    assert set(out) == STAGE_KEYS and out["batch"] == 4
    for stage in STAGE_KEYS - {"batch", "solves_per_s"}:
        assert set(out[stage]) == TIMING_KEYS and out[stage]["median_s"] > 0.0
    assert out["solves_per_s"] == pytest.approx(4 / out["total"]["median_s"])


def test_stage_timings_structured_have_the_jax_keys():
    """On the CPU there is no kernel 2 to time: the JAX function's off-TPU
    key set."""
    planner = _planner(torch.float32, qp_settings=QPSettings(
        max_iter=30, check_every=10, rho_update_every=0, backend="structured"))
    cur, tgt = _states(planner, 4)
    out = profiling.stage_timings_structured(planner, cur, tgt, repeats=1)
    assert set(out) == STRUCTURED_KEYS and out["batch"] == 4
    for stage in STRUCTURED_KEYS - {"batch", "solves_per_s", "admm_loop_derived_s"}:
        assert out[stage]["median_s"] > 0.0
    assert out["admm_loop_derived_s"] >= 0.0


# ---------------------------------------------------------------------------
# parallel/mesh.py
# ---------------------------------------------------------------------------

def _jax_stats(sol):
    """mesh.py:102-107 of the JAX package, on a torch Solution."""
    return {"mean_violation": sol.violation.mean(), "max_violation": sol.violation.max(),
            "mean_qp_iterations": sol.qp_iterations.to(torch.float32).mean(),
            "num_converged": sol.qp_converged.all(-1).sum()}


@pytest.fixture(scope="module")
def mesh_case():
    planner = _planner(qp_settings=QPSettings(max_iter=50, check_every=10, rho_update_every=0,
                                              backend="structured"))
    cur, tgt = _states(planner, 4)
    return planner, cur, tgt, planner.solve(cur, tgt)


@pytest.mark.parametrize("make", [mesh.sharded_solve_fn, mesh.shard_map_solve_fn],
                         ids=["sharded", "shard_map"])
def test_mesh_of_two_cpu_devices_matches_the_plain_solve(mesh_case, make):
    """A mesh of two CPU devices: each half solved by its own (eager on the
    CPU) solve, gathered, equals the plain solve of the batch at float64
    within 1e-12 (the halves are batches of their own, whose matrix products
    may round apart in the last bits); the stats are the JAX formulas on the
    gathered solution, and on the plain one within 1e-12."""
    planner, cur, tgt, ref = mesh_case
    devices = mesh.make_mesh([torch.device("cpu")] * 2)
    assert devices == [torch.device("cpu")] * 2
    cur_s, tgt_s = mesh.shard_batch(devices, (cur, tgt))
    assert [c.shape[0] for c in cur_s] == [2, 2]
    sol, stats = make(planner, devices)(cur_s, tgt_s)
    for f in SOLUTION_FIELDS:
        a, b = getattr(sol, f), getattr(ref, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert sol.warm_start.duration.shape == (4,)
    assert set(stats) == {"mean_violation", "max_violation", "mean_qp_iterations",
                          "num_converged"}
    for k, v in _jax_stats(sol).items():
        assert torch.equal(stats[k], v), k
    for k, v in _jax_stats(ref).items():
        torch.testing.assert_close(stats[k], v, rtol=1e-12, atol=1e-12)
    # whole tensors are sharded by the solve function itself
    again, _ = make(planner, devices)(cur, tgt)
    assert torch.equal(again.z, sol.z)


def test_shard_batch_refuses_an_uneven_batch():
    devices = mesh.make_mesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_batch(devices, torch.zeros(3, 14))
    with pytest.raises(ValueError, match="at least one device"):
        mesh.make_mesh([])


def test_initialize_multihost_one_gloo_process(tmp_path, mesh_case):
    """One gloo process through a file:// rendezvous: the stats are
    all-reduced over the group and equal the single-process formulas."""
    import torch.distributed as dist

    planner, cur, tgt, ref = mesh_case
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        mesh.shard_batch_multihost(["cpu"], (cur, tgt))
    mesh.initialize_multihost(f"file://{tmp_path / 'rendezvous'}", 1, 0)
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        devices = mesh.make_mesh(["cpu"])
        cur_s, tgt_s = mesh.shard_batch_multihost(devices, (cur, tgt))
        sol, stats = mesh.sharded_solve_fn(planner, devices)(cur_s, tgt_s)
        assert torch.equal(sol.z, ref.z)
        for k, v in _jax_stats(ref).items():
            torch.testing.assert_close(stats[k], v, rtol=1e-12, atol=1e-12, check_dtype=False)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# bench/plots.py (skips without matplotlib, as the JAX package's test does)
# ---------------------------------------------------------------------------

def _fake_traj(n=11, seed=0):
    rng = np.random.default_rng(seed)
    return (np.linspace(0.0, 1.5, n), rng.normal(size=(n, 7)) * 0.3,
            rng.normal(size=(n, 7)) * 0.5, rng.normal(size=(n, 7)), rng.normal(size=(n, 7)) * 5.0)


def test_trajectory_plots(tmp_path):
    pytest.importorskip("matplotlib")
    from mpc_motion_planner_tpu_torch.bench import plots
    from mpc_motion_planner_tpu_torch.models.panda import make_panda_limits, make_panda_model
    from mpc_motion_planner_tpu_torch.ops import kinematics
    from mpc_motion_planner_tpu_torch.utils import io as tio

    target = np.linspace(-0.5, 0.5, 14)
    rk, mpc = _fake_traj(seed=1), _fake_traj(seed=2)
    path = tmp_path / "optimal_solution.txt"
    tio.write_optimal_solution(str(path), target, rk, mpc)
    tgt, rk_l, mpc_l = plots.load_optimal_solution(path, n_points=11)
    np.testing.assert_allclose(tgt, target, atol=1e-12)
    np.testing.assert_allclose(rk_l["q"], rk[1], atol=1e-12)
    np.testing.assert_allclose(mpc_l["tau"], mpc[4], atol=1e-12)
    fig = plots.plot_trajectory_grid(tgt, rk_l, mpc_l, make_panda_limits(), MARGINS,
                                     save_path=tmp_path / "grid.png")
    assert (tmp_path / "grid.png").exists() and len(fig.axes) == 28
    model = make_panda_model()
    frame = model.frame("panda_tool")
    fig = plots.plot_ee_path(model, frame, rk_l, mpc_l, save_path=tmp_path / "ee.png")
    assert (tmp_path / "ee.png").exists()
    # the plotted path is the port's forward kinematics of q
    line = fig.axes[0].lines[1]
    p = kinematics.frame_placement(model, torch.as_tensor(mpc_l["q"]), frame)[1].numpy()
    np.testing.assert_allclose(np.asarray(line.get_data_3d()).T, p, atol=1e-12)


def test_benchmark_plots(tmp_path):
    pytest.importorskip("matplotlib")
    from mpc_motion_planner_tpu_torch.bench import plots
    from mpc_motion_planner_tpu_torch.models.panda import make_panda_limits

    rng = np.random.default_rng(3)
    records = rng.normal(size=(16, 162))
    records[:, 140:148] = (rng.uniform(size=(16, 8)) > 0.2).astype(float)
    plots.plot_extrema_scatter(records, make_panda_limits(), MARGINS,
                               save_path=tmp_path / "scatter.png")
    plots.plot_error_cdf(records, save_path=tmp_path / "cdf.png")
    assert (tmp_path / "scatter.png").exists() and (tmp_path / "cdf.png").exists()


# ---------------------------------------------------------------------------
# examples/analysis.py and examples/baseline_proxy.py
# ---------------------------------------------------------------------------

def test_analysis_example_on_the_acceptance_artifact(tmp_path):
    """The report of the JAX acceptance artifact: the figures, and the
    tables of the JAX analysis of it (267 MPC and 290 warm-start failures in
    the reference convention, none of the MPC's in joint space)."""
    pytest.importorskip("matplotlib")
    from mpc_motion_planner_tpu_torch.examples import analysis as example

    text = _run(example.main, ["benchmark", "--in", ARTIFACT, "--outdir", str(tmp_path)])
    assert {"extrema_scatter.png", "error_cdf.png"} <= set(os.listdir(tmp_path))
    dec = json.JSONDecoder()
    tables = [dec.raw_decode(text, text.index("{", text.index(marker)))[0]
              for marker in ("(strict", "(reference", "accuracy:")]
    rec = read_benchmark_records(ARTIFACT)
    jlim, jmargins = j_limits(), MARGINS
    assert tables[0] == json.loads(json.dumps(janalysis.violation_counts(rec, jlim, jmargins)))
    assert tables[1] == json.loads(json.dumps(janalysis.violation_counts_reference(rec, jlim)))
    assert tables[2] == json.loads(json.dumps(janalysis.accuracy_stats(rec)))
    assert tables[1]["mpc"]["total"] == 267 and tables[1]["ruckig"]["total"] == 290
    for cat in ("position_fails", "velocity_fails", "torqueAccel_fails", "Jerk_fails"):
        assert tables[1]["mpc"][cat] == 0
    assert tables[1] == analysis.violation_counts_reference(rec, jlim)


def test_analysis_example_trajectory_mode(tmp_path):
    pytest.importorskip("matplotlib")
    from mpc_motion_planner_tpu_torch.examples import analysis as example
    from mpc_motion_planner_tpu_torch.utils import io as tio

    path = tmp_path / "sol.txt"
    tio.write_optimal_solution(str(path), np.zeros(14), _fake_traj(201, 1), _fake_traj(201, 2))
    _run(example.main, ["trajectory", "--in", str(path), "--outdir", str(tmp_path)])
    assert {"trajectory_grid.png", "ee_path.png"} <= set(os.listdir(tmp_path))


def test_baseline_proxy_prints_the_jax_keys():
    from mpc_motion_planner_tpu_torch.examples import baseline_proxy

    line = json.loads(_run(baseline_proxy.main, ["--n", "2"]).strip().splitlines()[-1])
    # the keys of the root examples/baseline_proxy.py's line
    assert set(line) == {"metric", "value", "unit", "n", "p50_latency_ms", "p95_latency_ms",
                         "dtype", "device"}
    assert line["metric"] == "serial_cpu_solves_per_s" and line["n"] == 2
    assert line["dtype"] == "float64" and line["device"] == "cpu" and line["value"] > 0


# ---------------------------------------------------------------------------
# utils/native.py
# ---------------------------------------------------------------------------

def test_native_loader_gives_the_jax_loaders_outputs():
    if shutil.which("g++") is None and shutil.which("cmake") is None:
        pytest.skip("no native toolchain")
    from mpc_motion_planner_tpu.utils import native as jnative
    from mpc_motion_planner_tpu_torch.utils import native

    lim = j_limits()
    vmax, amax, jmax = (0.8 * np.asarray(lim.max_velocity), 0.6 * np.asarray(lim.max_acceleration),
                        0.1 * np.asarray(lim.max_jerk))
    for seed in range(5):
        rng = np.random.default_rng(seed)
        args = (rng.uniform(-2, 2, 7), rng.uniform(-1, 1, 7) * vmax, rng.uniform(-2, 2, 7),
                rng.uniform(-1, 1, 7) * vmax, vmax, amax, jmax)
        dur, dt, jk = native.plan_trajectory_native(*args)
        jdur, jdt, jjk = jnative.plan_trajectory_native(*args)
        assert dur == jdur
        np.testing.assert_array_equal(dt, jdt)
        np.testing.assert_array_equal(jk, jjk)
        ts = np.linspace(0.0, dur, 51)
        for a, b in zip(native.sample_native(ts, dur, args[0], args[1], dt, jk),
                        jnative.sample_native(ts, jdur, args[0], args[1], jdt, jjk)):
            np.testing.assert_array_equal(a, b)
