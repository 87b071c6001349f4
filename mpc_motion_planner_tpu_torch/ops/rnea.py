"""Recursive Newton-Euler inverse dynamics (PyTorch).

Counterpart of ``mpc_motion_planner_tpu/ops/rnea.py`` ``rnea``: two sweeps
over the chain in link coordinates, gravity through the base acceleration,
URDF damping/friction not applied (pinocchio semantics). Takes arbitrary
leading batch dimensions on ``q``, ``qdot`` and ``qddot``.
"""

from __future__ import annotations

import torch

from ..models.robot import PRISMATIC, RobotModel
from . import spatial


def _joint_transform(model: RobotModel, i: int, qi):
    """(E, r): rotation parent->joint-i coords and joint-i origin in parent."""
    if model.joint_types[i] == PRISMATIC:
        R_pi = model.tree_rotation[i].expand(*qi.shape, 3, 3)
        r = model.tree_translation[i] + torch.einsum(
            "ij,...j->...i", model.tree_rotation[i], model.axis[i] * qi[..., None]
        )
    else:
        R_pi = model.tree_rotation[i] @ spatial.axis_angle_to_matrix(model.axis[i], qi)
        r = model.tree_translation[i].expand(*qi.shape, 3)
    return R_pi.transpose(-1, -2), r


def _joint_motion(model: RobotModel, i: int):
    """Joint motion subspace S_i as an (angular, linear) pair in frame i."""
    ax = model.axis[i]
    zero = torch.zeros_like(ax)
    if model.joint_types[i] == PRISMATIC:
        return zero, ax
    return ax, zero


def rnea(model: RobotModel, q, qdot, qddot) -> torch.Tensor:
    """Joint torques tau(q, qdot, qddot) with gravity, shape (..., nj)."""
    nj = model.nq
    par = model.parent_indices()
    batch = q.shape[:-1]
    zero3 = torch.zeros(*batch, 3, dtype=q.dtype, device=q.device)
    base_a = (zero3, (-model.gravity).expand(*batch, 3))

    Es, rs, vs, accs = [], [], [], []
    for i in range(nj):
        E, r = _joint_transform(model, i, q[..., i])
        s_w, s_v = _joint_motion(model, i)
        vp = vs[par[i]] if par[i] >= 0 else (zero3, zero3)
        ap = accs[par[i]] if par[i] >= 0 else base_a
        qd_i, qdd_i = qdot[..., i, None], qddot[..., i, None]

        v_w, v_v = spatial.transform_motion(E, r, *vp)
        v_w = v_w + s_w * qd_i
        v_v = v_v + s_v * qd_i

        a_w, a_v = spatial.transform_motion(E, r, *ap)
        c_w, c_v = spatial.cross_motion(v_w, v_v, s_w * qd_i, s_v * qd_i)
        a_w = a_w + s_w * qdd_i + c_w
        a_v = a_v + s_v * qdd_i + c_v

        Es.append(E)
        rs.append(r)
        vs.append((v_w, v_v))
        accs.append((a_w, a_v))

    taus = [None] * nj
    fs = [(zero3, zero3)] * nj
    for i in range(nj - 1, -1, -1):
        vw, vv = vs[i]
        aw, av = accs[i]
        Iw, Iv = spatial.inertia_apply(model.mass[i], model.com[i], model.inertia[i], aw, av)
        hw, hv = spatial.inertia_apply(model.mass[i], model.com[i], model.inertia[i], vw, vv)
        bw, bv = spatial.cross_force(vw, vv, hw, hv)
        f_w = fs[i][0] + Iw + bw
        f_v = fs[i][1] + Iv + bv

        s_w, s_v = _joint_motion(model, i)
        taus[i] = (f_w * s_w).sum(-1) + (f_v * s_v).sum(-1)

        if par[i] >= 0:
            pw, pv = spatial.transform_force_back(Es[i], rs[i], f_w, f_v)
            fs[par[i]] = (fs[par[i]][0] + pw, fs[par[i]][1] + pv)

    return torch.stack(taus, dim=-1)
