"""Kernel 1: per-node constraint values g = [tau; tool height] and their
exact 8x21 Jacobians dg/d[q, qdot, u].

Replaces ``mpc_motion_planner_tpu/ops/pallas/constraints_kernel.py``
``fused_node_constraints`` (``pl.pallas_call`` at :345, math in
``lane_constraints`` :180, constants from ``bake_model`` :56).

What bounds it on this card: arithmetic and registers. Each evaluation
reads 21 floats and writes 8 (value pass) or 176 (with the Jacobian), so
even the 389,120-evaluation line-search launch moves ~45 MB; the two
Newton-Euler sweeps plus the tool FK are ~1.5k flops per value pass. The
TPU kernel ran 21 tangents side by side in vector registers; a 21-wide dual
number per CUDA thread would spill. So the Jacobian launch uses one thread
per (evaluation, input direction): each thread runs the value pass once in
single-tangent dual numbers seeded on its direction and writes one column
of the Jacobian (recomputing the value 21 times is cheaper than spilling).
The value-only launch runs one thread per evaluation in plain floats. The
robot constants travel by value in the kernel's parameter struct (1.3 KB),
so a new model needs no rebuild.

The plain version is ``TranscribedOCP.node_constraints`` with
``torch.func.jacfwd`` (:func:`node_constraints_plain`); the wrapper takes it
for CPU tensors only and launches the kernel or raises for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.robot import PRISMATIC, Frame, RobotModel
from .build import CudaKernel, HostConstants, check_cuda_tensor, ptr

NJ = 7  # the kernel's chain length (csrc/constraints.cu)
JOINT_FLOATS = 46  # R0 9, t 3, axis 3, K 9, K2 9, mass 1, mc 3, Io 9

KERNEL = CudaKernel(
    "constraints", "constraints.cu", "mpc_constraints",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)

# bake_model results per (model, frame, device)
BAKED = HostConstants()


def bake_model(model: RobotModel, frame: Frame):
    """Flatten a revolute serial chain into the kernel's constant block.

    Returns ``(consts, tool_parent)``: ``consts`` is float32 with, per joint,
    R0, t, axis, K = [axis]x, K2 = K @ K, mass, m*com and the rotational
    inertia about the joint origin, then gravity and the tool translation.
    Mirrors the JAX ``bake_model``, including its refusals."""
    if any(jt == PRISMATIC for jt in model.joint_types):
        raise NotImplementedError(
            "constraints kernel supports revolute chains only (the Panda)"
        )
    if not model.is_serial:
        raise NotImplementedError("constraints kernel supports serial chains only")
    if model.nq != NJ:
        raise NotImplementedError(f"constraints kernel is built for {NJ} joints")
    a = lambda t: t.detach().cpu().double().numpy()
    tree_rot, tree_trans, axes = a(model.tree_rotation), a(model.tree_translation), a(model.axis)
    masses, coms, inertias = a(model.mass), a(model.com), a(model.inertia)
    rows = []
    for i in range(NJ):
        ax = axes[i]
        K = np.array([[0.0, -ax[2], ax[1]], [ax[2], 0.0, -ax[0]], [-ax[1], ax[0], 0.0]])
        m, com = float(masses[i]), coms[i]
        Io = inertias[i] + m * (float(com @ com) * np.eye(3) - np.outer(com, com))
        rows.append(np.concatenate([
            tree_rot[i].ravel(), tree_trans[i], ax, K.ravel(), (K @ K).ravel(),
            [m], m * com, Io.ravel(),
        ]))
    consts = np.concatenate(
        rows + [a(model.gravity), a(frame.translation)]
    ).astype(np.float32)
    assert consts.size == NJ * JOINT_FLOATS + 6
    return consts, int(frame.parent_joint)


def node_constraints_plain(ocp, X, U, with_jac: bool):
    """g (B, nodes, ng) [and J (B, nodes, ng, nx+nu)] by the plain path."""
    g = ocp.node_constraints(X, U)
    if not with_jac:
        return g
    return g, ocp.node_jacobians(X, U)


def node_constraints_kernel(ocp, X, U, with_jac: bool):
    """Launch kernel 1 on CUDA tensors X (B, nodes, nx), U (B, nodes, nu)."""
    B, nodes = X.shape[0], X.shape[1]
    n_in, ng = ocp.nx + ocp.nu, ocp.ng
    consts, tool_parent = BAKED.get(
        (ocp.model, ocp.tool_frame), X.device, lambda: bake_model(ocp.model, ocp.tool_frame)
    )
    xu = torch.cat([X, U], dim=-1).reshape(B * nodes, n_in).to(torch.float32).contiguous()
    F = xu.shape[0]
    check_cuda_tensor("xu", xu, (F, 3 * NJ))
    g = torch.empty(F, ng, dtype=torch.float32, device=xu.device)
    J = (torch.empty(F, ng, n_in, dtype=torch.float32, device=xu.device)
         if with_jac else None)
    KERNEL.launch(
        consts.ctypes.data_as(ctypes.c_void_p), tool_parent, ptr(xu), ptr(g),
        ptr(J) if with_jac else None, F, int(with_jac),
    )
    g = g.reshape(B, nodes, ng).to(X.dtype)
    if not with_jac:
        return g
    return g, J.reshape(B, nodes, ng, n_in).to(X.dtype)


def node_constraints(ocp, X, U, with_jac: bool):
    """Route: the plain version for CPU tensors, kernel 1 for CUDA ones."""
    if X.device.type == "cpu":
        return node_constraints_plain(ocp, X, U, with_jac)
    if X.device.type == "cuda":
        return node_constraints_kernel(ocp, X, U, with_jac)
    raise ValueError(f"no constraints path for device {X.device}")
