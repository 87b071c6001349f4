"""Kernel 1: per-node constraint values g = [tau; tool height] and their
exact (nq + 1) x 3 nq Jacobians dg/d[q, qdot, u] (8 x 21 for the Panda).

Replaces ``mpc_motion_planner_tpu/ops/pallas/constraints_kernel.py``
``fused_node_constraints`` (``pl.pallas_call`` at :345, math in
``lane_constraints`` :180, constants from ``bake_model`` :56).

What bounds it on this card: instructions. Each evaluation reads 21 floats
and writes 8 (value pass) or 176 (with the Jacobian), so even the
389,120-evaluation line-search launch moves ~45 MB; the two Newton-Euler
sweeps plus the tool FK are ~1.5k flops per value pass in chains of
dependent 3-vector operations, and a tangent costs twice a value. The TPU
kernel ran 21 tangents side by side in vector registers; here the Jacobian
launch runs one thread per (evaluation, joint j) that carries the value and
the three tangents along ``q_j``, ``qdot_j`` and ``u_j``: 7 value passes per
evaluation instead of one per input direction, a warp holds one j, joints
before j run in plain floats (their tangents are zero), only joint j's
rotation has a tangent, and every later rotation multiplies tangents as a
float matrix. :func:`node_jacobians_by_joint` states this split in plain
PyTorch. The figures here are the 7-joint Panda's: the library is built for
the model's joint count (``-DMPC_NQ``, one library per joint count, a block
of nq warps), for any serial chain of revolute joints whose block fits
(:func:`check_fits`: up to 32 joints, 1,024 threads; the tiles take
66,816 B at 12 joints, where two blocks still share an SM, and past 23
joints the J tile is left out: each thread writes its columns of J to
device memory itself). The value launch runs one thread per evaluation.
Both read ``q, qdot`` and ``u`` where they lie (``X`` and ``U`` may be views of the NLP
iterate ``z``: a batch stride and node-major rows, no ``cat`` copy). The
Jacobian launch stages them with coalesced loads into shared memory and
writes ``g`` and ``J`` through shared-memory tiles in 16-byte stores; the
value launch, bound by its instructions, loads and stores per thread. The
robot constants (1.3 KB at 7 joints, 46 floats per joint) lie in device
memory, baked once per model and device (:data:`BAKED`), and the launches
take a pointer to them: their parameters are 72 B at any joint count, and
another model of the same joint count needs no rebuild.

The plain version is ``TranscribedOCP.node_constraints`` with
``torch.func.jacfwd`` (:func:`node_constraints_plain`); the wrapper takes it
for CPU tensors only and launches the kernel or raises for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.robot import PRISMATIC, Frame, RobotModel
from .build import SM_SMEM, SMEM_LIMIT, CudaKernel, Geometry, HostConstants, ptr

JOINT_FLOATS = 46  # R0 9, t 3, axis 3, K 9, K2 9, mass 1, mc 3, Io 9
PARAM_LIMIT = 4096  # bytes of a launch's parameters
JE = 32  # evaluations a block of the Jacobian launch: one a lane
THREAD_LIMIT = 1024  # threads a block may have

KERNEL = CudaKernel(
    "constraints", "constraints.cu", "mpc_constraints",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p],
    init="mpc_constraints_init", per_geometry="joints",
)

# the baked robot in device memory and its tool's parent joint, per (model,
# frame, device)
BAKED = HostConstants()


def threads(nq: int) -> int:
    """JT of csrc/constraints.cu: the Jacobian launch's threads a block,
    one per (evaluation, joint) of its 32 evaluations."""
    return JE * nq


def j_tiled(nq: int) -> bool:
    """JTILE: whether the Jacobian launch stages J in a shared-memory tile
    (up to 23 joints); past that each thread writes its columns of J to
    device memory itself."""
    nin, ng = 3 * nq, nq + 1
    return 8 * 2 * JE + 4 * JE * (nin + ng * nin + 1 + (ng | 1)) <= SMEM_LIMIT


def smem_bytes(nq: int) -> int:
    """Dynamic shared memory of one block of the Jacobian launch built for
    ``nq`` joints (csrc/constraints.cu JSMEM): the offsets and inputs of 32
    evaluations, the J tile where it fits (:func:`j_tiled`) and the g tile,
    at their padded strides."""
    nin, ng = 3 * nq, nq + 1
    tile = 4 * JE * (ng * nin + 1) if j_tiled(nq) else 0
    return 8 * 2 * JE + 4 * JE * nin + tile + 4 * JE * (ng | 1)


def robot_bytes(nq: int) -> int:
    """The baked robot in device memory (struct Robot): 46 floats per
    joint, gravity and the tool translation."""
    return 4 * (nq * JOINT_FLOATS + 6)


def param_bytes(nq: int) -> int:
    """Bytes of the Jacobian launch's parameters (the larger of the two
    launches'), at any joint count: the robot's pointer and its tool's
    parent, where the inputs lie (struct Inputs), the two output pointers
    and F."""
    return 8 + 4 + 40 + 16 + 4


def blocks_bound(nq: int) -> int:
    """JB of csrc/constraints.cu: the blocks of the Jacobian launch an SM
    holds by their tiles, for which its registers are capped: two while two
    fit the SM and leave a thread 64 registers or more (up to 16 joints),
    else one."""
    return 2 if 2 * (smem_bytes(nq) + 1024) <= SM_SMEM and 2 * threads(nq) <= 1024 else 1


def reckoning(nq: int) -> dict:
    """The Jacobian launch's block at ``nq`` joints as this module reckons
    it, in the keys of :func:`block_layout`."""
    return {"smem_bytes": smem_bytes(nq), "blocks_bound": blocks_bound(nq),
            "threads": threads(nq), "j_tiled": int(j_tiled(nq)),
            "param_bytes": param_bytes(nq), "robot_bytes": robot_bytes(nq)}


def check_fits(nq: int) -> None:
    """Raise ValueError unless kernel 1 built for ``nq`` joints fits a
    launch: a thread per (evaluation, joint) of 32 evaluations in one block,
    32 joints at most (its shared memory, the J tile left out past 23
    joints, and its 72 B of parameters fit at every count that does)."""
    if threads(nq) > THREAD_LIMIT:
        raise ValueError(f"kernel 1 at {nq} joints needs {threads(nq)} threads a block (one "
                         f"per evaluation and joint, {JE} evaluations); a block may have "
                         f"{THREAD_LIMIT}")


def block_layout(nq: int) -> dict:
    """What the library built for ``nq`` joints says of the Jacobian
    launch's block: its dynamic shared memory, the blocks an SM holds its
    registers are capped for, its threads, whether it stages J in a tile,
    and the bytes of its parameters and of the robot."""
    lib = KERNEL.library(Geometry(nq=nq))
    out = {}
    for key in ("smem_bytes", "blocks_bound", "threads", "j_tiled", "param_bytes",
                "robot_bytes"):
        fn = getattr(lib, f"mpc_constraints_{key}")
        fn.restype = ctypes.c_int
        out[key] = fn()
    return out


def bake_model(model: RobotModel, frame: Frame):
    """Flatten a revolute serial chain of any length into the kernel's
    constant block.

    Returns ``(consts, tool_parent)``: ``consts`` is float32 with, per joint,
    R0, t, axis, K = [axis]x, K2 = K @ K, mass, m*com and the rotational
    inertia about the joint origin, then gravity and the tool translation.
    Mirrors the JAX ``bake_model``, including its refusals (prismatic joints,
    branched trees: such a model is planned with ``fused_constraints="off"``,
    the plain path)."""
    if any(jt == PRISMATIC for jt in model.joint_types):
        raise NotImplementedError(
            "constraints kernel supports revolute chains only; prismatic joints use the "
            "plain path (fused_constraints='off')"
        )
    if not model.is_serial:
        raise NotImplementedError(
            "constraints kernel supports serial chains only; branched trees use the plain "
            "path (fused_constraints='off')")
    nj = model.nq
    a = lambda t: t.detach().cpu().double().numpy()
    tree_rot, tree_trans, axes = a(model.tree_rotation), a(model.tree_translation), a(model.axis)
    masses, coms, inertias = a(model.mass), a(model.com), a(model.inertia)
    rows = []
    for i in range(nj):
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
    assert consts.size == nj * JOINT_FLOATS + 6
    return consts, int(frame.parent_joint)


def baked_robot(model: RobotModel, frame: Frame, device):
    """:func:`bake_model` on ``device``: ``(robot, tool_parent)`` with the
    constants as a float32 tensor there, which the launches point to."""
    consts, tool_parent = bake_model(model, frame)
    return torch.from_numpy(consts).to(device), tool_parent


def node_constraints_plain(ocp, X, U, with_jac: bool):
    """g (B, nodes, ng) [and J (B, nodes, ng, nx+nu)] by the plain path."""
    g = ocp.node_constraints(X, U)
    if not with_jac:
        return g
    return g, ocp.node_jacobians(X, U)


def node_jacobians_by_joint(ocp, X, U):
    """Kernel 1's work split in plain PyTorch, for tests: the Jacobian
    (..., ng, nx+nu) assembled from one pass per joint j that carries the
    three tangents along ``q_j``, ``qdot_j`` and ``u_j`` (columns j, nq + j
    and 2 nq + j) beside the value; in pass j only joint j's own angle, rate
    and acceleration carry a tangent."""
    nq, nx = ocp.nq, ocp.nx
    xu = torch.cat([X, U], dim=-1)
    flat = xu.reshape(-1, xu.shape[-1])
    seeds = torch.eye(xu.shape[-1], dtype=xu.dtype, device=xu.device)

    def g_of(v):
        return ocp.node_constraints(v[:nx], v[nx:])

    def three_tangents(v, j):
        cols = [torch.func.jvp(g_of, (v,), (seeds[c],))[1] for c in (j, nq + j, 2 * nq + j)]
        return torch.stack(cols, dim=-1)  # (ng, 3)

    J = flat.new_zeros(flat.shape[0], ocp.ng, xu.shape[-1])
    for j in range(nq):
        cols = torch.func.vmap(lambda v: three_tangents(v, j))(flat)
        for slot in range(3):
            J[:, :, slot * nq + j] = cols[:, :, slot]
    return J.reshape(*xu.shape[:-1], ocp.ng, xu.shape[-1])


def _rows_in_place(t, width: int):
    """``t`` (B, nodes, width) as float32 with node-major rows (strides
    (batch stride, width, 1)), copied only if it is not that already."""
    t = t.to(torch.float32)
    if t.stride(2) != 1 or t.stride(1) != width:
        t = t.contiguous()
    return t


def node_constraints_kernel(ocp, X, U, with_jac: bool):
    """Launch kernel 1 on CUDA tensors X (B, nodes, nx), U (B, nodes, nu),
    read where they lie when they are float32 with node-major rows (views of
    ``z`` are); float64 input is cast once."""
    B, nodes = X.shape[0], X.shape[1]
    nq = ocp.nq
    n_in, ng = ocp.nx + ocp.nu, ocp.ng
    if (tuple(X.shape[2:]), tuple(U.shape)) != ((2 * nq,), (B, nodes, nq)):
        raise ValueError(f"kernel 1 takes X (B, nodes, {2 * nq}) and U (B, nodes, {nq}), got "
                         f"{tuple(X.shape)} and {tuple(U.shape)}")
    check_fits(nq)
    for name, t in (("X", X), ("U", U)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    robot, tool_parent = BAKED.get(
        (ocp.model, ocp.tool_frame), X.device, lambda: baked_robot(ocp.model, ocp.tool_frame,
                                                                   X.device))
    x, u = _rows_in_place(X, 2 * nq), _rows_in_place(U, nq)
    F = B * nodes
    g = torch.empty(F, ng, dtype=torch.float32, device=x.device)
    J = (torch.empty(F, ng, n_in, dtype=torch.float32, device=x.device)
         if with_jac else None)
    KERNEL.launch(
        ptr(robot), tool_parent, ptr(x), ptr(u),
        x.stride(0) if B > 1 else 0, u.stride(0) if B > 1 else 0, nodes, ptr(g),
        ptr(J) if with_jac else None, F, int(with_jac), geometry=Geometry(nq=nq),
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
