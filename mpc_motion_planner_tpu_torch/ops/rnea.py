"""Recursive Newton-Euler inverse dynamics, its derivatives, the mass
matrix and the energies (PyTorch).

Counterpart of ``mpc_motion_planner_tpu/ops/rnea.py``: two sweeps over the
chain in link coordinates, gravity through the base acceleration, URDF
damping/friction not applied (pinocchio semantics). ``rnea``,
``nonlinear_effects`` and the energies take arbitrary leading batch
dimensions on ``q``, ``qdot`` and ``qddot``; ``rnea_derivatives`` and
``crba`` take one configuration (nq,), as their JAX counterparts do, and
batch under ``torch.func.vmap``.
"""

from __future__ import annotations

import dataclasses

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


def rnea_derivatives(model: RobotModel, q, qdot, qddot):
    """Exact partials (dtau/dq, dtau/dqdot, dtau/dqddot), each (nq, nq), by
    forward-mode differentiation; dtau/dqddot is the mass matrix."""
    return torch.func.jacfwd(lambda *a: rnea(model, *a), argnums=(0, 1, 2))(q, qdot, qddot)


def crba(model: RobotModel, q) -> torch.Tensor:
    """Joint-space mass matrix M(q), (nq, nq), symmetrized: dtau/dqddot at
    zero velocity and zero gravity, which is the composite-rigid-body mass
    matrix since tau is linear in qddot."""
    zero_g = dataclasses.replace(model, gravity=torch.zeros_like(model.gravity))
    z = torch.zeros_like(q)
    M = torch.func.jacfwd(lambda a: rnea(zero_g, q, z, a))(z)
    return 0.5 * (M + M.transpose(-1, -2))


def nonlinear_effects(model: RobotModel, q, qdot) -> torch.Tensor:
    """Coriolis + centrifugal + gravity torques: tau(q, qdot, 0)."""
    return rnea(model, q, qdot, torch.zeros_like(q))


def kinetic_energy(model: RobotModel, q, qdot):
    """Total kinetic energy (...,), from the forward velocity sweep only: an
    oracle for RNEA that shares none of its backward sweep."""
    batch = q.shape[:-1]
    zero3 = torch.zeros(*batch, 3, dtype=q.dtype, device=q.device)
    par = model.parent_indices()
    vs = []
    ke = torch.zeros(batch, dtype=q.dtype, device=q.device)
    for i in range(model.nq):
        E, r = _joint_transform(model, i, q[..., i])
        s_w, s_v = _joint_motion(model, i)
        vp = vs[par[i]] if par[i] >= 0 else (zero3, zero3)
        v_w, v_v = spatial.transform_motion(E, r, *vp)
        v_w = v_w + s_w * qdot[..., i, None]
        v_v = v_v + s_v * qdot[..., i, None]
        vs.append((v_w, v_v))
        hw, hv = spatial.inertia_apply(model.mass[i], model.com[i], model.inertia[i], v_w, v_v)
        ke = ke + 0.5 * ((v_w * hw).sum(-1) + (v_v * hv).sum(-1))
    return ke


def potential_energy(model: RobotModel, q):
    """Total gravitational potential energy (...,), from the world heights
    of the centres of mass."""
    from . import kinematics

    R, p = kinematics.fk(model, q)
    com_world = p + torch.einsum("...nij,nj->...ni", R, model.com)
    return -(model.mass * torch.einsum("...ni,i->...n", com_world, model.gravity)).sum(-1)
