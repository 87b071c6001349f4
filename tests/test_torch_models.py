"""PyTorch port: robot model, limits, collocation and spatial algebra against
the JAX package (float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu.models import panda as jpanda
from mpc_motion_planner_tpu.ops import collocation as jcoll
from mpc_motion_planner_tpu.ops import spatial as jspatial
from mpc_motion_planner_tpu_torch.models import panda as tpanda
from mpc_motion_planner_tpu_torch.models.robot import model_from_numpy
from mpc_motion_planner_tpu_torch.ops import collocation as tcoll
from mpc_motion_planner_tpu_torch.ops import spatial as tspatial

torch.set_num_threads(1)

_MODEL_TENSORS = (
    "tree_rotation", "tree_translation", "axis", "mass", "com", "inertia", "gravity",
)
_LIMIT_FIELDS = (
    "min_position", "max_position", "max_velocity", "max_acceleration", "max_jerk",
    "max_torque", "max_torque_dot", "max_linear_velocity", "max_angular_velocity",
    "min_height",
)
_COLL_FIELDS = (
    "order", "num_segments", "time_nodes", "local_nodes", "diff_matrix",
    "quad_weights", "bary_weights",
)


def jax_model_leaves(model):
    leaves = {f: np.asarray(getattr(model, f)) for f in _MODEL_TENSORS}
    leaves.update(
        joint_types=model.joint_types,
        joint_names=model.joint_names,
        parent=model.parent,
        frames={k: (f.parent_joint, np.asarray(f.rotation), np.asarray(f.translation))
                for k, f in model.frames.items()},
    )
    return leaves


def test_model_carried_across_equals_rebuilt():
    carried = model_from_numpy(jax_model_leaves(jpanda.make_panda_model()))
    rebuilt = tpanda.make_panda_model()
    assert carried.joint_types == rebuilt.joint_types
    assert carried.joint_names == rebuilt.joint_names
    assert carried.parent_indices() == rebuilt.parent_indices()
    for f in _MODEL_TENSORS:
        a, b = getattr(carried, f), getattr(rebuilt, f)
        assert a.dtype == b.dtype == torch.float64, f
        assert torch.equal(a, b), f
    assert carried.frames.keys() == rebuilt.frames.keys()
    for k in carried.frames:
        fa, fb = carried.frames[k], rebuilt.frames[k]
        assert fa.parent_joint == fb.parent_joint
        assert torch.equal(fa.rotation, fb.rotation)
        assert torch.equal(fa.translation, fb.translation)


def test_limits_carried_across_equals_rebuilt():
    lim = jpanda.make_panda_limits()
    carried = tpanda.limits_from_numpy({f: getattr(lim, f) for f in _LIMIT_FIELDS})
    rebuilt = tpanda.make_panda_limits()
    for f in _LIMIT_FIELDS:
        a, b = getattr(carried, f), getattr(rebuilt, f)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f
        else:
            assert a == b, f


def test_collocation_carried_across_equals_rebuilt():
    c = jcoll.make_collocation()
    carried = tcoll.collocation_from_numpy({f: getattr(c, f) for f in _COLL_FIELDS})
    rebuilt = tcoll.make_collocation()
    assert carried.segment_indices().tolist() == rebuilt.segment_indices().tolist()
    for f in _COLL_FIELDS[2:]:
        assert torch.equal(getattr(carried, f), getattr(rebuilt, f)), f


def test_model_to_device_dtype():
    m = tpanda.make_panda_model().to("cpu", torch.float32)
    assert m.mass.dtype == torch.float32
    assert m.frame(tpanda.TOOL_FRAME).translation.dtype == torch.float32


_RNG = np.random.default_rng(7)
_V1, _V2 = _RNG.standard_normal((2, 5, 3))
_M1, _M2 = _RNG.standard_normal((2, 5, 3, 3))
_ANG = _RNG.uniform(-3, 3, 5)
_MASS = _RNG.uniform(0.5, 2.0, 5)


@pytest.mark.parametrize(
    "name,args",
    [
        ("skew", (_V1,)),
        ("rpy_to_matrix", (_V1,)),
        ("axis_angle_to_matrix", (_V1 / np.linalg.norm(_V1, axis=-1, keepdims=True), _ANG)),
        ("compose", (_M1, _V1, _M2, _V2)),
        ("inverse", (_M1, _V1)),
        ("cross_motion", (_V1, _V2, _V2, _V1)),
        ("cross_force", (_V1, _V2, _V2, _V1)),
        ("inertia_apply", (_MASS, _V1, _M1, _V2, _V1)),
        ("transform_motion", (_M1, _V1, _V2, _V1)),
        ("transform_force_back", (_M1, _V1, _V2, _V1)),
    ],
)
def test_spatial_matches_jax(name, args):
    # the JAX helpers take one problem at a time: vmap over the leading axis
    ref = jax.vmap(getattr(jspatial, name))(*(jnp.asarray(a) for a in args))
    got = getattr(tspatial, name)(*(torch.as_tensor(a) for a in args))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12)
