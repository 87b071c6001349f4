"""Benchmark analysis: violation counting and accuracy statistics.

The port's own copy of ``mpc_motion_planner_tpu/bench/analysis.py`` (numpy
on the records): decodes the 162-column benchmark rows, counts
per-category limit violations for both planners (in a strict convention
and in the benchmark notebook's), measures the worst overshoots and
summarizes the final-state errors, as plain dicts. The limits may hold
tensors on any device or numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..utils.io import to_numpy

# 162-column record layout
_N = 28  # non-time rows per trajectory matrix: q(7) qd(7) qdd(7) tau(7)
MIN_RK = slice(0, _N)
MAX_RK = slice(_N, 2 * _N)
MIN_MPC = slice(2 * _N, 3 * _N)
MAX_MPC = slice(3 * _N, 4 * _N)
ERR_RK = slice(112, 126)
ERR_MPC = slice(126, 140)
FLAGS = slice(140, 148)  # jerk/lin/ang/collision x (rk, mpc)
TARGET = slice(148, 162)


def decode(records: np.ndarray) -> Dict[str, np.ndarray]:
    records = np.asarray(records)
    assert records.shape[-1] == 162, records.shape
    return {
        "min_rk": records[:, MIN_RK],
        "max_rk": records[:, MAX_RK],
        "min_mpc": records[:, MIN_MPC],
        "max_mpc": records[:, MAX_MPC],
        "err_rk": records[:, ERR_RK],
        "err_mpc": records[:, ERR_MPC],
        "flags": records[:, FLAGS],
        "target": records[:, TARGET],
    }


def _margin_boxes(limits, margins):
    """(lo, hi, record columns) of each extremum category, margin-scaled:
    the boxes the solver was asked to respect."""
    lo_q, hi_q = to_numpy(limits.min_position), to_numpy(limits.max_position)
    safety = (1.0 - margins.position) * (hi_q - lo_q) / 2.0
    sym = lambda m, lim: (-m * to_numpy(lim), m * to_numpy(lim))
    return {
        "position": (lo_q + safety, hi_q - safety, slice(0, 7)),
        "velocity": (*sym(margins.velocity, limits.max_velocity), slice(7, 14)),
        "acceleration": (*sym(margins.acceleration, limits.max_acceleration), slice(14, 21)),
        "torque": (*sym(margins.torque, limits.max_torque), slice(21, 28)),
    }


def _extrema(d):
    return (("ruckig", d["min_rk"], d["max_rk"]), ("mpc", d["min_mpc"], d["max_mpc"]))


def violation_counts(records: np.ndarray, limits, margins) -> Dict[str, Dict[str, int]]:
    """Per-category violation counts for both planners, strict convention:
    the recorded row min/max against the margin-scaled limits with a 1e-6
    tolerance; jerk, task velocity and collision from the re-simulation
    flags. Stricter than the notebook's reporting, which
    :func:`violation_counts_reference` reproduces."""
    d = decode(records)
    box = _margin_boxes(limits, margins)
    out: Dict[str, Dict[str, int]] = {}
    tol = 1e-6
    for planner_name, mn, mx in _extrema(d):
        counts = {}
        for cat, (lo, hi, cols) in box.items():
            bad = np.any((mn[:, cols] < lo - tol) | (mx[:, cols] > hi + tol), axis=-1)
            counts[cat] = int(bad.sum())
        base = 0 if planner_name == "ruckig" else 4
        f = d["flags"]
        counts["jerk"] = int((f[:, base + 0] == 0).sum())
        counts["task_velocity"] = int(((f[:, base + 1] == 0) | (f[:, base + 2] == 0)).sum())
        counts["collision"] = int((f[:, base + 3] == 0).sum())
        out[planner_name] = counts
    return out


def violation_counts_reference(records: np.ndarray, limits) -> Dict[str, Dict[str, int]]:
    """Failure counts exactly as the benchmark notebook's cell 3 computes
    them, which differ from :func:`violation_counts` on purpose:

    * extrema against the full limits, no margin scaling, no tolerance;
    * acceleration and torque merged into one ``torqueAccel`` category;
    * the MPC counts sum the per-direction counts (a trajectory over both
      the min and the max bound counts twice), the Ruckig counts OR them;
    * ``taskVelocity`` tests the linear-velocity flag only.

    Keys are the notebook's columns, plus ``total``."""
    d = decode(records)
    lo_q, hi_q = to_numpy(limits.min_position), to_numpy(limits.max_position)
    v_lim = to_numpy(limits.max_velocity)
    a_lim = to_numpy(limits.max_acceleration)
    t_lim = to_numpy(limits.max_torque)

    def count(rows):  # rows: (n,) bool -> int
        return int(np.count_nonzero(rows))

    out: Dict[str, Dict[str, int]] = {}
    f = d["flags"]
    for planner_name, mn, mx in _extrema(d):
        base = 0 if planner_name == "ruckig" else 4
        q_hi = np.any(mx[:, 0:7] > hi_q, axis=-1)
        q_lo = np.any(mn[:, 0:7] < lo_q, axis=-1)
        v_hi = np.any(mx[:, 7:14] > v_lim, axis=-1)
        v_lo = np.any(mn[:, 7:14] < -v_lim, axis=-1)
        a_hi = np.any(mx[:, 14:21] > a_lim, axis=-1)
        a_lo = np.any(mn[:, 14:21] < -a_lim, axis=-1)
        t_hi = np.any(mx[:, 21:28] > t_lim, axis=-1)
        t_lo = np.any(mn[:, 21:28] < -t_lim, axis=-1)
        if planner_name == "mpc":  # the notebook sums the direction counts
            pos = count(q_hi) + count(q_lo)
            vel = count(v_hi) + count(v_lo)
            ta = count(a_hi) + count(a_lo) + count(t_hi) + count(t_lo)
        else:  # and ORs them for Ruckig
            pos = count(q_hi | q_lo)
            vel = count(v_hi | v_lo)
            ta = count(a_hi | a_lo | t_hi | t_lo)
        c = {
            "position_fails": pos,
            "velocity_fails": vel,
            "torqueAccel_fails": ta,
            "Jerk_fails": count(f[:, base + 0] == 0),
            "taskVelocity_fails": count(f[:, base + 1] == 0),  # linear flag only
            "collision_fails": count(f[:, base + 3] == 0),
        }
        c["total"] = sum(c.values())
        out[planner_name] = c
    return out


def violation_magnitudes(records, limits, margins) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Worst overshoot of the margin-scaled box per extremum category: per
    trajectory the largest over its joints, reported as p50/p99/max over
    the batch, plus the largest relative to the per-joint bound."""
    d = decode(records)
    box = _margin_boxes(limits, margins)
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for planner_name, mn, mx in _extrema(d):
        stats = {}
        for cat, (lo, hi, cols) in box.items():
            over = np.maximum(mx[:, cols] - hi, 0.0) + np.maximum(lo - mn[:, cols], 0.0)
            worst = over.max(axis=1)
            span = np.maximum(np.abs(hi), np.abs(lo))
            # a zero bound (margin or limit 0) must not give inf or nan
            rel = np.where(span > 0, over / np.where(span > 0, span, 1.0), 0.0)
            stats[cat] = {
                "p50": float(np.percentile(worst, 50)),
                "p99": float(np.percentile(worst, 99)),
                "max": float(worst.max()),
                "rel_max": float(rel.max()),
            }
        out[planner_name] = stats
    return out


def accuracy_stats(
    records: np.ndarray, target_eps: float = 1e-2, eps_abs: float = 1e-3
) -> Dict[str, Dict[str, float]]:
    """Final-state error statistics: percentiles of the l2 position and
    velocity errors and of the per-joint max error (``err_inf_*``), and the
    share within the terminal box (``within_target_box``, target_eps) and
    within the box the QP's primal tolerance guarantees
    (``within_box_plus_tol``, target_eps + eps_abs)."""
    d = decode(records)
    out = {}
    for name, err in (("ruckig", d["err_rk"]), ("mpc", d["err_mpc"])):
        eq = np.linalg.norm(err[:, :7], axis=-1)
        ev = np.linalg.norm(err[:, 7:], axis=-1)
        einf = np.abs(err).max(-1)
        out[name] = {
            "pos_err_p50": float(np.percentile(eq, 50)),
            "pos_err_p95": float(np.percentile(eq, 95)),
            "pos_err_max": float(eq.max()),
            "vel_err_p50": float(np.percentile(ev, 50)),
            "vel_err_p95": float(np.percentile(ev, 95)),
            "vel_err_max": float(ev.max()),
            "err_inf_p50": float(np.percentile(einf, 50)),
            "err_inf_p95": float(np.percentile(einf, 95)),
            "err_inf_max": float(einf.max()),
            "within_target_box": float(np.mean(einf <= target_eps)),
            "within_box_plus_tol": float(np.mean(einf <= target_eps + eps_abs)),
        }
    return out
