"""Minimal URDF parser producing the port's :class:`RobotModel`.

Counterpart of ``mpc_motion_planner_tpu/models/urdf.py`` (numpy and
``xml.etree``; the port keeps its own copy). It covers chains and trees of
revolute and prismatic joints, fixed joints with inertial payloads and
inertial origins with rpy. Fixed joints are folded: their subtree inertias
are fused into the nearest moving ancestor link and each fixed child link
becomes a named operational frame. Parsing runs in float64 numpy; the model
is then put on the requested device and dtype.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np
import torch

from .robot import Frame, PRISMATIC, REVOLUTE, RobotModel

_JOINT_TYPES = {"revolute": REVOLUTE, "continuous": REVOLUTE, "prismatic": PRISMATIC}


def _rpy_matrix(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def _parse_origin(elem: Optional[ET.Element]):
    if elem is None:
        return np.eye(3), np.zeros(3)
    xyz = np.fromstring(elem.get("xyz", "0 0 0"), sep=" ")
    rpy = np.fromstring(elem.get("rpy", "0 0 0"), sep=" ")
    return _rpy_matrix(rpy), xyz


def _parse_inertial(link: ET.Element):
    """Return (mass, com, inertia_about_com) in the link frame."""
    inertial = link.find("inertial")
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    mass_el = inertial.find("mass")
    mass = float(mass_el.get("value")) if mass_el is not None else 0.0
    R, com = _parse_origin(inertial.find("origin"))
    inertia_el = inertial.find("inertia")
    if inertia_el is None:
        I = np.zeros((3, 3))
    else:
        g = lambda k: float(inertia_el.get(k, "0"))
        I = np.array(
            [
                [g("ixx"), g("ixy"), g("ixz")],
                [g("ixy"), g("iyy"), g("iyz")],
                [g("ixz"), g("iyz"), g("izz")],
            ]
        )
    # Rotate the inertia from the inertial frame into the link frame.
    return mass, com, R @ I @ R.T


def _fuse_inertia(m1, c1, i1, m2, c2, i2):
    """Fuse two (mass, com, inertia_about_com) triples in a common frame."""
    m = m1 + m2
    if m == 0.0:
        return 0.0, np.zeros(3), i1 + i2
    c = (m1 * c1 + m2 * c2) / m
    # parallel axis both to the new com
    d1, d2 = c1 - c, c2 - c
    shift = lambda mi, d: mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return m, c, i1 + shift(m1, d1) + i2 + shift(m2, d2)


def parse_urdf(source: str, gravity=(0.0, 0.0, -9.81), dtype=torch.float64,
               device=None) -> RobotModel:
    """Parse a URDF string or file path into a :class:`RobotModel` on
    ``device`` in ``dtype``. A link may carry several child joints (a hand
    with two prismatic fingers): joints are emitted in topological
    pre-order and each records its parent moving joint in ``parent``."""
    root = ET.fromstring(source) if "<robot" in source else ET.parse(source).getroot()

    links: Dict[str, ET.Element] = {l.get("name"): l for l in root.findall("link")}
    joints: List[ET.Element] = root.findall("joint")
    child_of: Dict[str, List[ET.Element]] = {}
    has_parent = set()
    for j in joints:
        child_of.setdefault(j.find("parent").get("link"), []).append(j)
        has_parent.add(j.find("child").get("link"))

    roots = [name for name in links if name not in has_parent]
    if len(roots) != 1:
        raise ValueError(f"expected a single root link, found {roots}")

    joint_types: List[int] = []
    joint_names: List[str] = []
    parents: List[int] = []
    tree_R: List[np.ndarray] = []
    tree_p: List[np.ndarray] = []
    axes: List[np.ndarray] = []
    masses: List[float] = []
    coms: List[np.ndarray] = []
    inertias: List[np.ndarray] = []
    frames: Dict[str, tuple] = {}

    def walk(link_name: str, fixed_R: np.ndarray, fixed_p: np.ndarray, moving_idx: int):
        """Traverse from ``link_name``, which sits at (fixed_R, fixed_p) in
        the frame of moving joint ``moving_idx`` (-1 = world)."""
        for j in child_of.get(link_name, []):
            jR, jp = _parse_origin(j.find("origin"))
            R = fixed_R @ jR
            p = fixed_R @ jp + fixed_p
            child = j.find("child").get("link")
            jtype = j.get("type")
            if jtype == "fixed":
                # fuse the child inertia into the current moving link and
                # register the child link as an operational frame
                m, c, I = _parse_inertial(links[child])
                if moving_idx < 0:
                    if m != 0.0:
                        raise ValueError("inertial mass attached before any moving joint")
                else:
                    masses[moving_idx], coms[moving_idx], inertias[moving_idx] = _fuse_inertia(
                        masses[moving_idx], coms[moving_idx], inertias[moving_idx],
                        m, R @ c + p, R @ I @ R.T,
                    )
                frames[child] = (moving_idx, R, p)
                walk(child, R, p, moving_idx)
            elif jtype in _JOINT_TYPES:
                idx = len(joint_names)
                parents.append(moving_idx)
                joint_names.append(j.get("name"))
                joint_types.append(_JOINT_TYPES[jtype])
                tree_R.append(R)
                tree_p.append(p)
                ax_el = j.find("axis")
                ax = (np.fromstring(ax_el.get("xyz"), sep=" ") if ax_el is not None
                      else np.array([1.0, 0.0, 0.0]))
                norm = np.linalg.norm(ax)
                axes.append(ax / norm if norm > 0 else ax)
                m, c, I = _parse_inertial(links[child])
                masses.append(m)
                coms.append(c)
                inertias.append(I)
                frames[child] = (idx, np.eye(3), np.zeros(3))
                walk(child, np.eye(3), np.zeros(3), idx)
            else:
                raise ValueError(f"unsupported joint type '{jtype}'")

    walk(roots[0], np.eye(3), np.zeros(3), -1)

    as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
    return RobotModel(
        joint_types=tuple(joint_types),
        joint_names=tuple(joint_names),
        tree_rotation=as_t(np.stack(tree_R)),
        tree_translation=as_t(np.stack(tree_p)),
        axis=as_t(np.stack(axes)),
        mass=as_t(masses),
        com=as_t(np.stack(coms)),
        inertia=as_t(np.stack(inertias)),
        gravity=as_t(gravity),
        frames={k: Frame(pj, as_t(R), as_t(t)) for k, (pj, R, t) in frames.items()},
        parent=tuple(parents),
    )
