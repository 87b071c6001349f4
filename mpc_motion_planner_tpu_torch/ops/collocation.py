"""Chebyshev–Gauss–Lobatto collocation on a segmented spline (PyTorch).

Counterpart of ``mpc_motion_planner_tpu/ops/collocation.py``: order-3
polynomials on 6 segments over normalized time in [0, 1], 19 nodes. The
constants are built in float64 numpy exactly as the JAX package builds
them; the runtime functions take a leading batch dimension.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache
from typing import Mapping

import numpy as np
import torch

_TENSORS = ("time_nodes", "local_nodes", "diff_matrix", "quad_weights", "bary_weights")


def cgl_points(order: int) -> np.ndarray:
    """Chebyshev–Gauss–Lobatto points mapped to [0, 1], ascending."""
    x = np.cos(np.pi * np.arange(order + 1) / order)
    return (1.0 - x) / 2.0


def cheb_diff_matrix(order: int) -> np.ndarray:
    """Differentiation matrix on the [0, 1] CGL grid (ascending nodes)."""
    N = order
    x = np.cos(np.pi * np.arange(N + 1) / N)
    c = np.ones(N + 1)
    c[0] = c[N] = 2.0
    c = c * (-1.0) ** np.arange(N + 1)
    X = np.tile(x, (N + 1, 1)).T
    dX = X - X.T
    D = np.outer(c, 1.0 / c) / (dX + np.eye(N + 1))
    D = D - np.diag(D.sum(axis=1))
    return -2.0 * D


def clenshaw_curtis_weights(order: int) -> np.ndarray:
    """Quadrature weights on the [0, 1] CGL grid (exact for degree<=order)."""
    s = cgl_points(order)
    V = np.vander(s, order + 1, increasing=True)
    moments = 1.0 / np.arange(1, order + 2)
    return np.linalg.solve(V.T, moments)


def barycentric_weights(order: int) -> np.ndarray:
    """Barycentric weights for the CGL grid (up to common scaling)."""
    w = (-1.0) ** np.arange(order + 1)
    w[0] *= 0.5
    w[-1] *= 0.5
    return w


@dataclass(frozen=True)
class Collocation:
    """Static transcription data for an order/segment configuration."""

    order: int
    num_segments: int
    time_nodes: torch.Tensor  # (num_nodes,) global tau grid, ascending
    local_nodes: torch.Tensor  # (order+1,) local CGL grid on [0,1]
    diff_matrix: torch.Tensor  # (order+1, order+1) d/d tau_global per segment
    quad_weights: torch.Tensor  # (order+1,)
    bary_weights: torch.Tensor  # (order+1,)

    @property
    def num_nodes(self) -> int:
        return self.order * self.num_segments + 1

    def segment_indices(self) -> np.ndarray:
        """(num_segments, order+1) global node index per segment-local node."""
        o, s = self.order, self.num_segments
        return np.arange(s)[:, None] * o + np.arange(o + 1)[None, :]

    def segment_index(self, device) -> torch.Tensor:
        """:meth:`segment_indices` as a tensor on ``device``, made once per
        device (a copy from host memory at every solve would also stall a
        CUDA graph capture)."""
        return _segment_index(self.order, self.num_segments, torch.device(device))

    def to(self, device=None, dtype=None) -> "Collocation":
        return dataclasses.replace(
            self,
            **{f: getattr(self, f).to(device=device, dtype=dtype) for f in _TENSORS},
        )


@lru_cache(maxsize=None)
def _segment_index(order: int, num_segments: int, device: torch.device) -> torch.Tensor:
    seg = np.arange(num_segments)[:, None] * order + np.arange(order + 1)[None, :]
    return torch.as_tensor(seg, device=device)


def as_tensor_like(a, dtype, device) -> torch.Tensor:
    """``a`` (a tensor, a Python number or an array) as a tensor of
    ``dtype`` on ``device``; a number is filled in on the device, not copied
    from host memory, so that a CUDA graph can capture it."""
    if torch.is_tensor(a):
        return a.to(dtype=dtype, device=device)
    if np.ndim(a) == 0:
        return torch.full((), float(a), dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def make_collocation(order: int = 3, num_segments: int = 6, dtype=torch.float64,
                     device=None) -> Collocation:
    local = cgl_points(order)
    nodes = []
    for seg in range(num_segments):
        start = seg / num_segments
        pts = start + local / num_segments
        nodes.extend(pts if seg == 0 else pts[1:])
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    coll = Collocation(
        order=order,
        num_segments=num_segments,
        time_nodes=t(nodes),
        local_nodes=t(local),
        diff_matrix=t(cheb_diff_matrix(order) * num_segments),
        quad_weights=t(clenshaw_curtis_weights(order)),
        bary_weights=t(barycentric_weights(order)),
    )
    return coll.to(device, dtype)


def collocation_from_numpy(leaves: Mapping) -> Collocation:
    """Build the constants from another implementation's values."""
    return Collocation(
        order=int(leaves["order"]),
        num_segments=int(leaves["num_segments"]),
        **{f: torch.as_tensor(np.array(leaves[f])) for f in _TENSORS},
    )


def segment_values(coll: Collocation, node_values):
    """Gather per-segment node values: (B, num_nodes, d) -> (B, S, order+1, d)."""
    return node_values[:, coll.segment_index(node_values.device)]


def derivative_at_nodes(coll: Collocation, node_values):
    """d/d tau_global of the spline at every segment-local node:
    (B, num_nodes, d) -> (B, S, order+1, d)."""
    seg = segment_values(coll, node_values)
    return torch.einsum("kj,bsjd->bskd", coll.diff_matrix, seg)


def _barycentric(coll: Collocation, t):
    """Segment index (T,) and normalized barycentric weights (T, order+1)
    of global times t (T,) in [0, 1]."""
    S = coll.num_segments
    seg = torch.clamp(torch.floor(t * S).long(), 0, S - 1)
    s_local = t * S - seg.to(t.dtype)
    diff = s_local[:, None] - coll.local_nodes  # (T, o+1)
    exact = diff.abs() < 1e-12
    any_exact = exact.any(dim=-1, keepdim=True)
    safe_diff = torch.where(exact, torch.ones_like(diff), diff)
    w = coll.bary_weights / safe_diff
    w = torch.where(any_exact, exact.to(w.dtype), w)
    return seg, w / w.sum(-1, keepdim=True)


def interpolate(coll: Collocation, node_values, t):
    """Barycentric evaluation at global time(s) ``t`` in [0, 1].

    node_values (B, num_nodes, d); t a scalar or (T,) tensor. Returns
    (B, d) or (B, T, d). Queries outside [0, 1] are clamped."""
    t = as_tensor_like(t, node_values.dtype, node_values.device)
    scalar = t.ndim == 0
    seg, w = _barycentric(coll, t.reshape(-1).clamp(0.0, 1.0))
    vals = segment_values(coll, node_values)[:, seg]  # (B, T, o+1, d)
    out = torch.einsum("tj,btjd->btd", w, vals)
    return out[:, 0] if scalar else out


def interpolate_each(coll: Collocation, node_values, t):
    """:func:`interpolate` with one time per batch entry: node_values
    (B, num_nodes, d), t (B,) -> (B, d)."""
    seg, w = _barycentric(coll, t.clamp(0.0, 1.0))
    vals = segment_values(coll, node_values)[torch.arange(t.shape[0], device=t.device), seg]
    return torch.einsum("bj,bjd->bd", w, vals)
