"""Franka Panda 7-DoF arm: kinematic/inertial parameters and limits (PyTorch).

Counterpart of ``mpc_motion_planner_tpu/models/panda.py``: the same public
Franka Emika Panda constants, built in float64 numpy exactly as the JAX
package builds them and then turned into tensors, so the two packages hold
bit-identical parameters at float64.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from .robot import Frame, REVOLUTE, RobotModel

NDOF = 7

_PI_2 = 1.57079632679

# Per-joint placement in the parent joint frame: (xyz, rpy), axis is local z.
_JOINT_ORIGINS = [
    ((0.0, 0.0, 0.333), (0.0, 0.0, 0.0)),
    ((0.0, 0.0, 0.0), (-_PI_2, 0.0, 0.0)),
    ((0.0, -0.316, 0.0), (_PI_2, 0.0, 0.0)),
    ((0.0825, 0.0, 0.0), (_PI_2, 0.0, 0.0)),
    ((-0.0825, 0.384, 0.0), (-_PI_2, 0.0, 0.0)),
    ((0.0, 0.0, 0.0), (_PI_2, 0.0, 0.0)),
    ((0.088, 0.0, 0.0), (_PI_2, 0.0, 0.0)),
]

# Per-link inertial parameters in the link (= joint) frame:
# (mass, com xyz, [ixx, ixy, ixz, iyy, iyz, izz] about the com).
_LINK_INERTIALS = [
    (4.970684, (3.875e-03, 2.081e-03, -0.1750),
     (7.0337e-01, -1.3900e-04, 6.7720e-03, 7.0661e-01, 1.9169e-02, 9.1170e-03)),
    (0.646926, (-3.141e-03, -2.872e-02, 3.495e-03),
     (7.9620e-03, -3.9250e-03, 1.0254e-02, 2.8110e-02, 7.0400e-04, 2.5995e-02)),
    (3.228604, (2.7518e-02, 3.9252e-02, -6.6502e-02),
     (3.7242e-02, -4.7610e-03, -1.1396e-02, 3.6155e-02, -1.2805e-02, 1.0830e-02)),
    (3.587895, (-5.317e-02, 1.04419e-01, 2.7454e-02),
     (2.5853e-02, 7.7960e-03, -1.3320e-03, 1.9552e-02, 8.6410e-03, 2.8323e-02)),
    (1.225946, (-1.1953e-02, 4.1065e-02, -3.8437e-02),
     (3.5549e-02, -2.1170e-03, -4.0370e-03, 2.9474e-02, 2.2900e-04, 8.6270e-03)),
    (1.666555, (6.0149e-02, -1.4117e-02, -1.0517e-02),
     (1.9640e-03, 1.0900e-04, -1.1580e-03, 4.3540e-03, 3.4100e-04, 5.4330e-03)),
    (7.35522e-01, (1.0517e-02, -4.252e-03, 6.1597e-02),
     (1.2516e-02, -4.2800e-04, -1.1960e-03, 1.0027e-02, -7.4100e-04, 4.8150e-03)),
]

# Fixed tool chain hanging off link 7: panda_link8 (massless, 1e-3
# isotropic rotational inertia, +0.107 m z), then panda_tool (1 kg payload,
# +0.15 m further along z).
_LINK8_OFFSET = 0.107
_LINK8_INERTIA = 1.0e-3
_TOOL_OFFSET = 0.107 + 0.15
_TOOL_MASS = 1.0
_TOOL_INERTIA = 1.0e-3

TOOL_FRAME = "panda_tool"


def _sym_inertia(ixx, ixy, ixz, iyy, iyz, izz):
    return np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])


def _rpy(rpy):
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def make_panda_model(gravity=(0.0, 0.0, -9.81), dtype=torch.float64,
                     device=None) -> RobotModel:
    """Build the Panda arm model with the tool payload fused into link 7."""
    tree_R = np.stack([_rpy(rpy) for _, rpy in _JOINT_ORIGINS])
    tree_p = np.stack([np.asarray(xyz, dtype=np.float64) for xyz, _ in _JOINT_ORIGINS])
    axes = np.tile(np.array([0.0, 0.0, 1.0]), (NDOF, 1))

    masses = np.array([m for m, _, _ in _LINK_INERTIALS])
    coms = np.stack([np.asarray(c, dtype=np.float64) for _, c, _ in _LINK_INERTIALS])
    inertias = np.stack([_sym_inertia(*i) for _, _, i in _LINK_INERTIALS])

    # Fuse the 1 kg tool into link 7 (parallel-axis shift to the fused com).
    m7, c7, i7 = masses[6], coms[6], inertias[6]
    ct = np.array([0.0, 0.0, _TOOL_OFFSET])
    m = m7 + _TOOL_MASS
    c = (m7 * c7 + _TOOL_MASS * ct) / m
    shift = lambda mi, d: mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    i = (
        i7
        + shift(m7, c7 - c)
        + _LINK8_INERTIA * np.eye(3)
        + _TOOL_INERTIA * np.eye(3)
        + shift(_TOOL_MASS, ct - c)
    )
    masses[6], coms[6], inertias[6] = m, c, i

    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    frames = {
        "panda_link8": Frame(6, t(np.eye(3)), t([0.0, 0.0, _LINK8_OFFSET])),
        TOOL_FRAME: Frame(6, t(np.eye(3)), t([0.0, 0.0, _TOOL_OFFSET])),
    }
    model = RobotModel(
        joint_types=(REVOLUTE,) * NDOF,
        joint_names=tuple(f"panda_joint{i + 1}" for i in range(NDOF)),
        tree_rotation=t(tree_R),
        tree_translation=t(tree_p),
        axis=t(axes),
        mass=t(masses),
        com=t(coms),
        inertia=t(inertias),
        gravity=t(gravity),
        frames=frames,
    )
    return model.to(device, dtype)


_LIMIT_TENSORS = (
    "min_position", "max_position", "max_velocity", "max_acceleration",
    "max_jerk", "max_torque",
)


@dataclass(frozen=True)
class PandaLimits:
    """Franka limits (the JAX package's ``PandaLimits``)."""

    min_position: torch.Tensor
    max_position: torch.Tensor
    max_velocity: torch.Tensor
    max_acceleration: torch.Tensor
    max_jerk: torch.Tensor
    max_torque: torch.Tensor
    max_torque_dot: float
    max_linear_velocity: float
    max_angular_velocity: float
    min_height: float

    def to(self, device=None, dtype=None) -> "PandaLimits":
        return dataclasses.replace(
            self,
            **{f: getattr(self, f).to(device=device, dtype=dtype)
               for f in _LIMIT_TENSORS},
        )


def make_panda_limits(dtype=torch.float64, device=None) -> PandaLimits:
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    limits = PandaLimits(
        min_position=t([-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973]),
        max_position=t([2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973]),
        max_velocity=t([2.1750, 2.1750, 2.1750, 2.1750, 2.6100, 2.6100, 2.6100]),
        max_acceleration=t([15.0, 7.5, 10.0, 12.5, 15.0, 20.0, 20.0]),
        max_jerk=t([7500.0, 3750.0, 5000.0, 6250.0, 7500.0, 10000.0, 10000.0]),
        max_torque=t([87.0, 87.0, 87.0, 87.0, 12.0, 12.0, 12.0]),
        max_torque_dot=1000.0,
        max_linear_velocity=1.7,
        max_angular_velocity=2.5,
        min_height=0.05,
    )
    return limits.to(device, dtype)


def limits_from_numpy(leaves: Mapping) -> PandaLimits:
    """Build limits from another implementation's values (arrays and floats)."""
    return PandaLimits(**{
        k: torch.as_tensor(np.array(v)) if k in _LIMIT_TENSORS else float(v)
        for k, v in leaves.items()
    })
