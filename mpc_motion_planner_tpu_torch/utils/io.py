"""Text writers of the planner's output formats (the port's own copy of
``mpc_motion_planner_tpu/utils/io.py``, byte for byte the same text), so
that record files and notebooks read either package's output unchanged.

* ``write_optimal_solution``: the 29-column trajectory file: one target
  line, then N+1 rows of the warm-start trajectory and N+1 rows of the MPC
  trajectory (columns: time, q x7, qd x7, qdd x7, tau x7).
* ``write_benchmark_records``: 162-column benchmark rows, appended.

Tensors may be passed on any device; they are copied to the host as
float64 numpy arrays.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """A host numpy array of a tensor on any device, or of an array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _traj_matrix(time, q, qd, qdd, tau) -> np.ndarray:
    """(N+1, 29) block: [time, q, qd, qdd, tau]."""
    return np.concatenate([time[:, None], q, qd, qdd, tau], axis=-1)


def write_optimal_solution(path, target_state, rk_traj, mpc_traj):
    """rk_traj / mpc_traj: tuples (time, q, qd, qdd, tau), unbatched."""
    header = np.concatenate([[0.0], to_numpy(target_state), np.zeros(14)])[None, :]
    rk = _traj_matrix(*map(to_numpy, rk_traj))
    mpc = _traj_matrix(*map(to_numpy, mpc_traj))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        np.savetxt(f, header)
        np.savetxt(f, rk)
        np.savetxt(f, mpc)


def write_benchmark_records(path, records, append: bool = True):
    """records: (B, 162), appended to ``path`` unless ``append`` is false."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a" if append else "w") as f:
        np.savetxt(f, to_numpy(records))


def read_benchmark_records(path) -> np.ndarray:
    """(n, 162) float64 rows of a record file (gzip if it ends in .gz)."""
    return np.loadtxt(path).reshape(-1, 162)
