"""Forward kinematics, frame Jacobians, task-space velocity maps and the
damped least-squares inverse kinematics.

Counterpart of ``mpc_motion_planner_tpu/ops/kinematics.py`` for arbitrary
leading batch dimensions on ``q``. Jacobian rows are pinocchio's: 0-2
linear, 3-5 angular; LOCAL_WORLD_ALIGNED unless the name says LOCAL.
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


def frame_jacobian_local(model: RobotModel, q, frame: Frame) -> torch.Tensor:
    """LOCAL frame Jacobian (pinocchio's computeFrameJacobian default), as
    the IK loop uses it: both row blocks rotated into the frame."""
    Rf, _ = frame_placement(model, q, frame)
    J = frame_jacobian(model, q, frame)
    Rt = Rf.transpose(-1, -2)
    return torch.cat([Rt @ J[..., :3, :], Rt @ J[..., 3:, :]], dim=-2)


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


def integrate(model: RobotModel, q, v):
    """Configuration integration; for revolute/prismatic chains this is
    plain addition (pinocchio::integrate on R^n)."""
    return q + v


def inverse_kinematics(
    model: RobotModel,
    q0,
    target_rotation,
    target_translation,
    frame: Frame,
    eps: float = 1e-4,
    max_iters: int = 1000,
    dt: float = 1e-1,
    damp: float = 1e-2,
):
    """Damped least-squares IK: q <- q + dt v with
    v = -J^T (J J^T + damp I)^-1 log6(dMf), dMf = oMdes^-1 o oMf and J the
    LOCAL frame Jacobian. ``q0`` (..., nq) and the targets (..., 3, 3),
    (..., 3) share their leading dimensions; a problem whose error norm is
    below ``eps`` stops moving, and the loop ends (one test per iteration)
    when all have stopped or after ``max_iters``. Returns ``(q, converged)``."""
    Rd_inv, pd_inv = spatial.inverse(target_rotation, target_translation)
    eye = torch.eye(6, dtype=q0.dtype, device=q0.device)

    def error(q):
        Rf, pf = frame_placement(model, q, frame)
        return spatial.log6(*spatial.compose(Rd_inv, pd_inv, Rf, pf))

    q = q0
    done = torch.zeros(q0.shape[:-1], dtype=torch.bool, device=q0.device)
    for _ in range(max_iters):
        err = error(q)
        done = done | (torch.linalg.norm(err, dim=-1) < eps)
        if bool(done.all()):
            break
        J = frame_jacobian_local(model, q, frame)
        Jt = J.transpose(-1, -2)
        v = -(Jt @ torch.linalg.solve(J @ Jt + damp * eye, err[..., None]))[..., 0]
        q = torch.where(done[..., None], q, integrate(model, q, v * dt))
    done = done | (torch.linalg.norm(error(q), dim=-1) < eps)
    return q, done
