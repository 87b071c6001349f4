"""Plots of the reference's analysis notebooks, on the port's records.

Counterpart of ``mpc_motion_planner_tpu/bench/plots.py``, numpy and
matplotlib (imported inside each function: the machine with the card has
no matplotlib):

* ``load_optimal_solution`` + ``plot_trajectory_grid``: the
  data_analysis.ipynb view, a 7x4 grid (one row per joint; columns q, qd,
  qdd, tau) of the warm-start and MPC trajectories against the
  margin-scaled limits; ``plot_ee_path``: the tool's Cartesian path
  recomputed from q with the port's forward kinematics (the notebook
  recomputes it with Pinocchio: a check independent of the logged
  torques).
* ``plot_extrema_scatter``: benchmark_analysis.ipynb cell 2, the extrema of
  the 162-column records against the limit boxes.
* ``plot_error_cdf``: benchmark_analysis.ipynb cell 5, the final-state
  error CDFs over the batch.

Figures are returned so that callers can save or show them; the limits may
hold tensors or arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.io import to_numpy
from .analysis import decode


def load_optimal_solution(path, n_points: int = 201):
    """Parse the 29-column trajectory file that
    :func:`..utils.io.write_optimal_solution` writes (the reference's
    layout). Returns (target_state, rk, mpc), each trajectory a dict of
    time/q/qd/qdd/tau arrays."""
    data = np.loadtxt(path)
    target = data[0, 1:15]

    def block(rows):
        return dict(
            time=rows[:, 0],
            q=rows[:, 1:8],
            qd=rows[:, 8:15],
            qdd=rows[:, 15:22],
            tau=rows[:, 22:29],
        )

    body = data[1:]
    n = body.shape[0] // 2 if n_points is None else n_points
    return target, block(body[:n]), block(body[n : 2 * n])


def plot_trajectory_grid(target, rk, mpc, limits, margins, save_path=None):
    """7x4 grid of q/qd/qdd/tau against the margin-scaled limits
    (data_analysis.ipynb)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cols = [
        ("q", "position [rad]", limits.min_position, limits.max_position,
         margins.position),
        ("qd", "velocity [rad/s]", -limits.max_velocity, limits.max_velocity,
         margins.velocity),
        ("qdd", "acceleration [rad/s2]", -limits.max_acceleration,
         limits.max_acceleration, margins.acceleration),
        ("tau", "torque [Nm]", -limits.max_torque, limits.max_torque,
         margins.torque),
    ]
    fig, axes = plt.subplots(7, 4, figsize=(18, 16), sharex=True)
    for j in range(7):
        for c, (key, label, lo, hi, margin) in enumerate(cols):
            ax = axes[j, c]
            ax.plot(rk["time"], rk[key][:, j], label="warm start", lw=1.0)
            ax.plot(mpc["time"], mpc[key][:, j], label="MPC", lw=1.2)
            lo_j = float(to_numpy(lo)[j]) * margin
            hi_j = float(to_numpy(hi)[j]) * margin
            ax.axhline(lo_j, color="r", ls="--", lw=0.6)
            ax.axhline(hi_j, color="r", ls="--", lw=0.6)
            if key == "q":
                ax.plot(mpc["time"][-1], target[j], "k*", ms=8)
            if j == 0:
                ax.set_title(label)
            if j == 6:
                ax.set_xlabel("time [s]")
        axes[j, 0].set_ylabel(f"joint {j + 1}")
    axes[0, 0].legend(loc="best", fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
    return fig


def plot_ee_path(model, frame, rk, mpc, save_path=None):
    """The tool's Cartesian path, recomputed from q by the port's forward
    kinematics (data_analysis.ipynb's Pinocchio cross-check)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..ops import kinematics

    def path(q):
        q = torch.as_tensor(np.asarray(q), dtype=model.mass.dtype, device=model.mass.device)
        return to_numpy(kinematics.frame_placement(model, q, frame)[1])

    p_rk, p_mpc = path(rk["q"]), path(mpc["q"])
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ax.plot(*p_rk.T, label="warm start")
    ax.plot(*p_mpc.T, label="MPC")
    ax.scatter(*p_mpc[-1], color="k", marker="*", s=60)
    ax.set_xlabel("x [m]"), ax.set_ylabel("y [m]"), ax.set_zlabel("z [m]")
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=110)
    return fig


def plot_extrema_scatter(records: np.ndarray, limits, margins, save_path=None):
    """Extrema of the records against the limit boxes (benchmark_analysis
    cell 2)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = decode(records)
    fig, axes = plt.subplots(2, 2, figsize=(12, 10))
    specs = [
        ("q", 0, limits.min_position, limits.max_position, margins.position,
         "position extrema [rad]"),
        ("qd", 7, -limits.max_velocity, limits.max_velocity, margins.velocity,
         "velocity extrema [rad/s]"),
        ("qdd", 14, -limits.max_acceleration, limits.max_acceleration,
         margins.acceleration, "acceleration extrema [rad/s2]"),
        ("tau", 21, -limits.max_torque, limits.max_torque, margins.torque,
         "torque extrema [Nm]"),
    ]
    for ax, (name, off, lo, hi, margin, title) in zip(axes.ravel(), specs):
        lo = to_numpy(lo) * margin
        hi = to_numpy(hi) * margin
        for j in range(7):
            ax.scatter(
                np.full(records.shape[0], j) - 0.12,
                d["min_mpc"][:, off + j], s=4, c="tab:blue",
                label="MPC min" if j == 0 else None,
            )
            ax.scatter(
                np.full(records.shape[0], j) + 0.12,
                d["max_mpc"][:, off + j], s=4, c="tab:orange",
                label="MPC max" if j == 0 else None,
            )
            ax.hlines([lo[j], hi[j]], j - 0.3, j + 0.3, color="r", lw=1.0)
        ax.set_title(title)
        ax.set_xlabel("joint")
        ax.legend(fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
    return fig


def plot_error_cdf(records: np.ndarray, save_path=None):
    """Final-state error CDFs (benchmark_analysis cell 5)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = decode(records)
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    for ax, field, title in (
        (axes[0], "err_mpc", "MPC final-state error"),
        (axes[1], "err_rk", "warm-start final-state error"),
    ):
        err = d[field]
        for sl, label in ((slice(0, 7), "|dq| [rad]"), (slice(7, 14), "|dqd| [rad/s]")):
            norm = np.sort(np.linalg.norm(err[:, sl], axis=-1))
            cdf = np.arange(1, norm.size + 1) / norm.size
            ax.semilogx(np.maximum(norm, 1e-12), cdf, label=label)
        ax.set_title(title)
        ax.set_xlabel("final-state error")
        ax.set_ylabel("CDF")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
    return fig
