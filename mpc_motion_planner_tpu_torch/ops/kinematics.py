"""Forward kinematics, frame Jacobians and task-space velocity maps.

Counterpart of ``mpc_motion_planner_tpu/ops/kinematics.py`` for arbitrary
leading batch dimensions on ``q``. Jacobian rows are pinocchio's: 0-2
linear, 3-5 angular, LOCAL_WORLD_ALIGNED.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.robot import Frame, PRISMATIC, RobotModel
from . import spatial


def fk(model: RobotModel, q) -> Tuple[torch.Tensor, torch.Tensor]:
    """World placements of every joint frame: ``(R (..., nj, 3, 3),
    p (..., nj, 3))``; entry ``i`` is pinocchio's ``data.oMi[i+1]``."""
    Rs, ps = [], []
    batch = q.shape[:-1]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(*batch, 3, 3)
    zero = torch.zeros(*batch, 3, dtype=q.dtype, device=q.device)
    par = model.parent_indices()
    for i, jtype in enumerate(model.joint_types):
        Rp, pp = (Rs[par[i]], ps[par[i]]) if par[i] >= 0 else (eye, zero)
        R, p = spatial.compose(Rp, pp, model.tree_rotation[i], model.tree_translation[i])
        if jtype == PRISMATIC:
            p = p + torch.einsum("...ij,...j->...i", R, model.axis[i] * q[..., i, None])
        else:
            R = R @ spatial.axis_angle_to_matrix(model.axis[i], q[..., i])
        Rs.append(R)
        ps.append(p)
    return torch.stack(Rs, dim=-3), torch.stack(ps, dim=-2)


def frame_placement(model: RobotModel, q, frame: Frame):
    """World placement of a named operational frame (``data.oMf``)."""
    R, p = fk(model, q)
    return spatial.compose(
        R[..., frame.parent_joint, :, :], p[..., frame.parent_joint, :],
        frame.rotation, frame.translation,
    )


def frame_height(model: RobotModel, q, frame: Frame):
    """z-coordinate of the frame origin (the OCP's table constraint)."""
    _, p = frame_placement(model, q, frame)
    return p[..., 2]


def frame_jacobian(model: RobotModel, q, frame: Frame) -> torch.Tensor:
    """LOCAL_WORLD_ALIGNED frame Jacobian, shape (..., 6, nq)."""
    if not model.is_serial:
        raise NotImplementedError("branched models are not ported yet")
    R, p = fk(model, q)
    _, pf = spatial.compose(
        R[..., frame.parent_joint, :, :], p[..., frame.parent_joint, :],
        frame.rotation, frame.translation,
    )
    axes = torch.einsum("...nij,nj->...ni", R, model.axis)
    lin_rev = spatial._cross(axes, pf[..., None, :] - p)
    is_prismatic = torch.tensor(
        [jt == PRISMATIC for jt in model.joint_types], device=q.device
    )[:, None]
    lin = torch.where(is_prismatic, axes, lin_rev)
    ang = torch.where(is_prismatic, torch.zeros_like(axes), axes)
    return torch.cat([lin.transpose(-1, -2), ang.transpose(-1, -2)], dim=-2)


def forward_velocities(model: RobotModel, q, qdot, frame: Frame) -> torch.Tensor:
    """Task-space velocity [linear; angular] of the frame, (..., 6)."""
    return torch.einsum("...ij,...j->...i", frame_jacobian(model, q, frame), qdot)


def inverse_velocities(
    model: RobotModel, q, linear_velocity, angular_velocity, frame: Frame, damp=1e-5
) -> torch.Tensor:
    """Damped least-squares joint velocities realizing a task velocity:
    qdot = J^T (J J^T + damp I)^-1 v."""
    J = frame_jacobian(model, q, frame)
    v = torch.cat([linear_velocity, angular_velocity], dim=-1)
    JJt = J @ J.transpose(-1, -2) + damp * torch.eye(6, dtype=J.dtype, device=J.device)
    sol = torch.linalg.solve(JJt, v[..., None])
    return (J.transpose(-1, -2) @ sol)[..., 0]
