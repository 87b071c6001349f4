"""SO(3)/SE(3) and spatial (6D) vector algebra used by kinematics and RNEA.

Counterpart of ``mpc_motion_planner_tpu/ops/spatial.py``. Every function
takes arbitrary leading batch dimensions. Placements are ``(R, p)`` pairs
mapping local to world coordinates; spatial motion and force vectors are
Featherstone ``[angular; linear]`` pairs of 3-vectors.
"""

from __future__ import annotations

import torch


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def skew(v):
    """3-vector -> skew-symmetric matrix such that skew(v) @ w = v x w."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def rpy_to_matrix(rpy):
    """URDF fixed-axis roll/pitch/yaw -> rotation matrix (R = Rz @ Ry @ Rx)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def axis_angle_to_matrix(axis, angle):
    """Rodrigues formula for a unit axis and an angle (both batched-ok)."""
    K = skew(axis)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def compose(R1, p1, R2, p2):
    """Compose two placements: (R1,p1) o (R2,p2)."""
    return R1 @ R2, _mv(R1, p2) + p1


def inverse(R, p):
    """Inverse placement."""
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, p)


def log3(R):
    """SO(3) logarithm -> rotation vector (theta * unit_axis), (..., 3).

    Stable near theta = 0 (Taylor) and usable up to theta close to pi (the
    IK loop's error magnitudes stay well below pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.acos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
    # vee of the antisymmetric part, w = 2 sin(theta) * axis
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    small = theta < 1e-6
    safe_sin = torch.where(small, torch.ones_like(theta), torch.sin(theta))
    scale = torch.where(small, 0.5 + theta**2 / 12.0, theta / (2.0 * safe_sin))
    return w * scale[..., None]


def _v_inv(w):
    """Inverse of the SO(3) left-Jacobian V(w) of the SE(3) log:
    V^-1 = I - 0.5 [w] + (1/t^2)(1 - t sin t / (2 (1 - cos t))) [w]^2."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    W = skew(w)
    small = theta < 1e-6
    safe_t = torch.where(small, torch.ones_like(theta), theta)
    coeff = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - safe_t * torch.sin(safe_t) / (2.0 * (1.0 - torch.cos(safe_t)))) / safe_t**2,
    )
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - 0.5 * W + coeff[..., None, None] * (W @ W)


def log6(R, p):
    """SE(3) logarithm -> (linear, angular) 6-vector, pinocchio ordering."""
    w = log3(R)
    return torch.cat([_mv(_v_inv(w), p), w], dim=-1)


def cross_motion(w1, v1, w2, v2):
    """Spatial cross product of motion vectors: (w1,v1) x (w2,v2)."""
    return _cross(w1, w2), _cross(w1, v2) + _cross(v1, w2)


def cross_force(w, v, fw, fv):
    """Spatial cross product motion x* force: dual of cross_motion."""
    return _cross(w, fw) + _cross(v, fv), _cross(w, fv)


def inertia_apply(mass, com, inertia_com, w, v):
    """Apply a spatial rigid-body inertia (mass, com offset, rotational
    inertia about the com) to a motion vector:
        f_ang = I_o w + m c x v,   f_lin = m v - m c x w
    with I_o the rotational inertia about the frame origin."""
    mc = mass[..., None] * com
    c2 = torch.sum(com * com, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=inertia_com.dtype, device=inertia_com.device)
    i_o = inertia_com + mass[..., None, None] * (
        c2 * eye - com[..., :, None] * com[..., None, :]
    )
    f_ang = _mv(i_o, w) + _cross(mc, v)
    f_lin = mass[..., None] * v - _cross(mc, w)
    return f_ang, f_lin


def transform_motion(E, r, w, v):
    """Motion vector from frame A to frame B, B placed in A at translation
    ``r`` with ``E`` mapping A- to B-coordinates:
        w_B = E w_A,  v_B = E (v_A - r x w_A)"""
    return _mv(E, w), _mv(E, v - _cross(r, w))


def transform_force_back(E, r, fw, fv):
    """Force vector from frame B back to frame A (inverse-dual of
    :func:`transform_motion`)."""
    Et = E.transpose(-1, -2)
    fv_a = _mv(Et, fv)
    fw_a = _mv(Et, fw) + _cross(r, fv_a)
    return fw_a, fv_a
