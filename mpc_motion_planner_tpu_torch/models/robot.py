"""Structure-of-arrays robot model for serial kinematic chains (PyTorch).

Counterpart of ``mpc_motion_planner_tpu/models/robot.py``: a serial chain of
revolute or prismatic joints with per-link spatial inertias, plus named
operational frames rigidly attached to a joint. A frozen dataclass of
tensors; ``.to(device, dtype)`` returns a copy on another device or dtype.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

REVOLUTE = 0
PRISMATIC = 1


@dataclass(frozen=True)
class Frame:
    """A fixed frame attached to moving joint ``parent_joint``."""

    parent_joint: int
    rotation: torch.Tensor  # (3, 3) frame rotation in the parent joint frame
    translation: torch.Tensor  # (3,) frame origin in the parent joint frame

    def to(self, device=None, dtype=None) -> "Frame":
        return Frame(
            self.parent_joint,
            self.rotation.to(device=device, dtype=dtype),
            self.translation.to(device=device, dtype=dtype),
        )


_TENSOR_FIELDS = (
    "tree_rotation", "tree_translation", "axis", "mass", "com", "inertia",
    "gravity",
)


@dataclass(frozen=True)
class RobotModel:
    """Rigid body model (structure of arrays over joints, topological order).

    ``parent`` holds each joint's parent index (-1 = world); the empty
    default means a serial chain (parent = i - 1)."""

    joint_types: Tuple[int, ...]
    joint_names: Tuple[str, ...]
    tree_rotation: torch.Tensor  # (nj, 3, 3) joint placement in the parent
    tree_translation: torch.Tensor  # (nj, 3)
    axis: torch.Tensor  # (nj, 3) joint axis in the local joint frame
    mass: torch.Tensor  # (nj,)
    com: torch.Tensor  # (nj, 3)
    inertia: torch.Tensor  # (nj, 3, 3) rotational inertia about the com
    gravity: torch.Tensor  # (3,) world-frame gravity acceleration
    frames: Dict[str, Frame] = dataclasses.field(default_factory=dict)
    parent: Tuple[int, ...] = ()

    @property
    def nq(self) -> int:
        return len(self.joint_types)

    @property
    def is_serial(self) -> bool:
        return self.parent == () or all(
            p == i - 1 for i, p in enumerate(self.parent)
        )

    def parent_indices(self) -> Tuple[int, ...]:
        return self.parent or tuple(range(-1, self.nq - 1))

    def to(self, device=None, dtype=None) -> "RobotModel":
        moved = {
            f: getattr(self, f).to(device=device, dtype=dtype)
            for f in _TENSOR_FIELDS
        }
        return dataclasses.replace(
            self,
            frames={k: f.to(device, dtype) for k, f in self.frames.items()},
            **moved,
        )

    def frame(self, name: str) -> Frame:
        return self.frames[name]


def model_from_numpy(leaves: Mapping) -> RobotModel:
    """Build a model from another implementation's parameters as numpy.

    ``leaves`` maps every field of :class:`RobotModel` to its value; the
    tensor fields are arrays (kept in their own dtype) and ``frames`` maps
    each name to ``(parent_joint, rotation, translation)``."""
    as_t = lambda a: torch.as_tensor(np.array(a))
    return RobotModel(
        joint_types=tuple(int(j) for j in leaves["joint_types"]),
        joint_names=tuple(str(n) for n in leaves["joint_names"]),
        frames={
            name: Frame(int(pj), as_t(R), as_t(t))
            for name, (pj, R, t) in leaves["frames"].items()
        },
        parent=tuple(int(p) for p in leaves.get("parent", ())),
        **{f: as_t(leaves[f]) for f in _TENSOR_FIELDS},
    )
