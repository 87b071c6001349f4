"""PyTorch port: the dense QP backends against the JAX package.

The "xla" backend (the portable dense loop) against JAX "xla" at float64;
the "pallas" backend (its host part, with kernel 4's plain version on the
CPU) against JAX "pallas" at float32 with the Pallas kernel in interpret
mode; kernel 4's plain version against the Pallas kernel, and its
divergence freeze over the shared variable/row axis; kernel 4's partition
over a cluster of 8 blocks stated in plain PyTorch against both, and the
wrapper's refusal of sizes that do not fit; ``gershgorin_regularize``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_motion_planner_tpu.ops import sqp as jsqp
from mpc_motion_planner_tpu.ops.pallas import admm_kernel as jpk
from mpc_motion_planner_tpu.ops.qp import QPSettings as JQPSettings
from mpc_motion_planner_tpu.ops.qp import solve_box_qp as jsolve
from mpc_motion_planner_tpu_torch.kernels import admm_dense as k4
from mpc_motion_planner_tpu_torch.ops import sqp as tsqp
from mpc_motion_planner_tpu_torch.ops.qp import (
    QPSettings, pallas_operands, pallas_state, scale_dense_qp, solve_box_qp,
)

torch.set_num_threads(1)


def _qps(seed=0, dense_P=False, n=24, m=18):
    """B=5 random box QPs (n=24, m=18, 4 equality rows) as the JAX
    package's dense-QP tests build them, with soft weights on some rows."""
    rng = np.random.default_rng(seed)
    B = 5
    P = rng.uniform(0.1, 1.0, (B, n))
    if dense_P:
        G = rng.standard_normal((B, n, n))
        P = np.einsum("bki,bkj->bij", G, G) / n + 0.1 * np.eye(n)
    q = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    lc = rng.uniform(-2, -0.5, (B, m))
    uc = rng.uniform(0.5, 2, (B, m))
    lc[:, :4] = uc[:, :4] = 0.3  # equality rows
    lx, ux = np.full((B, n), -3.0), np.full((B, n), 3.0)
    soft_c = np.zeros((B, m))
    soft_c[:, 4:12] = 0.3
    soft_x = np.zeros((B, n))
    soft_x[:, ::3] = 0.2
    return (P, q, A, lc, uc, lx, ux), {"soft_c": soft_c, "soft_x": soft_x}


def _solve_both(settings, dtype, soft=False, dense_P=False):
    args, soft_kw = _qps(dense_P=dense_P)
    kw = soft_kw if soft else {}
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ref = jsolve(*(jnp.asarray(a, jdt) for a in args), JQPSettings(**settings),
                 **{k: jnp.asarray(v, jdt) for k, v in kw.items()})
    got = solve_box_qp(*(torch.as_tensor(a, dtype=dtype) for a in args), QPSettings(**settings),
                       **{k: torch.as_tensor(v, dtype=dtype) for k, v in kw.items()})
    return ref, got


XLA_CASES = {
    # eps 1e-6 runs past the first rho update at iteration 100
    "adaptive_rho": (dict(max_iter=2000, eps_abs=1e-6, eps_rel=1e-6), {}),
    "fixed_rho": (dict(max_iter=2000, rho_update_every=0), {}),
    "kkt_refine": (dict(max_iter=2000, kkt_refine=1, eps_abs=1e-6, eps_rel=1e-6), {}),
    "cholesky": (dict(max_iter=2000, kkt_factor="cholesky", eps_abs=1e-6, eps_rel=1e-6), {}),
    "soft_rows": (dict(max_iter=2000, eps_abs=1e-6, eps_rel=1e-6), {"soft": True}),
    "dense_P": (dict(max_iter=2000, eps_abs=1e-6, eps_rel=1e-6), {"dense_P": True}),
}


@pytest.mark.parametrize("case", list(XLA_CASES))
def test_xla_backend_matches_jax(case):
    settings, kw = XLA_CASES[case]
    ref, got = _solve_both(dict(settings, backend="xla"), torch.float64, **kw)
    assert got.converged.tolist() == np.asarray(ref.converged).tolist()
    assert got.iterations.tolist() == np.asarray(ref.iterations).tolist()
    for f in ("x", "y_constraints", "y_box", "prim_residual", "dual_residual"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-8, err_msg=f)


# All with kkt_refine=1, the headline's dense configuration: without
# refinement the float32 iteration counts hinge on the last bits of the
# explicit M^-1 (cond(M) grows with rho_eq_scale), which two LU
# implementations do not share; test_dense_chunk_matches_jax_chunk covers
# kkt_refine=0 on a shared M^-1. rho=0.01 is far enough from these
# problems' best rho that they run past the first rho update at 100.
PALLAS_CASES = {
    "adaptive_rho": (dict(max_iter=2000, kkt_refine=1, rho=0.01), {}),
    "fixed_rho": (dict(max_iter=2000, kkt_refine=1, rho_update_every=0), {}),
    "cholesky": (dict(max_iter=2000, kkt_refine=1, kkt_factor="cholesky"), {}),
    "soft_rows": (dict(max_iter=2000, kkt_refine=1, rho=0.01), {"soft": True}),
}


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_pallas_backend_matches_jax(case):
    """Float32 on both sides: identical convergence and iteration counts,
    x within 1e-4."""
    settings, kw = PALLAS_CASES[case]
    ref, got = _solve_both(dict(settings, backend="pallas"), torch.float32, **kw)
    assert got.converged.tolist() == np.asarray(ref.converged).tolist()
    assert got.iterations.tolist() == np.asarray(ref.iterations).tolist()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-4)


def _jax_chunk(ops, state, **kw):
    """JAX's admm_pallas_chunk (interpret mode) on the 512-padded operands."""
    pad = {2: jpk.pad_vec, 3: jpk.pad_mat}
    ones = {"rx", "D", "sx", "rc", "E", "sc"}
    j_ops = {k: (jpk.pad_vec_ones if k in ones else pad[v.ndim])(jnp.asarray(v.numpy()))
             for k, v in ops.items()}
    j_state = {k: jpk.pad_vec(jnp.asarray(state[k].numpy())) for k in k4.STATE}
    j_state["done"] = jnp.asarray(state["done"].numpy())[:, None]
    new, used = jpk.admm_pallas_chunk(j_ops, j_state, group=1, mxu_precision="highest", **kw)
    n, m = ops["A"].shape[2], ops["A"].shape[1]
    out = {k: np.asarray(new[k])[:, : (m if k in ("zc", "yc") else n)] for k in k4.STATE}
    out["done"] = np.asarray(new["done"])[:, 0]
    return out, np.asarray(used)


@pytest.mark.parametrize("kkt_refine", [0, 1])
def test_dense_chunk_matches_jax_chunk(kkt_refine):
    """Kernel 4's plain version against the Pallas kernel on identical
    float32 operands (one shared M^-1), three iterations with a check after
    each: the same done codes and counts, and the same state to float32
    rounding. A float32 matvec through M^-1 carries ~1e-5 of rounding
    (cond(M) grows with rho_eq_scale) that two summation orders do not
    share, so x, zc, zx agree to 1e-4 of their scale, and the duals, which
    take those errors times rho (yc += rc (zc_arg - zc)), to 1e-4 of the
    primal scale times the largest rho."""
    args, soft_kw = _qps()
    settings = QPSettings(backend="pallas", kkt_refine=kkt_refine)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    qp = scale_dense_qp(*map(t, args), settings, **{k: t(v) for k, v in soft_kw.items()})
    rho = torch.full((5,), settings.rho)
    ops = pallas_operands(qp, rho, qp.factor(rho, settings))
    state = pallas_state(qp)
    kw = dict(chunk_iters=3, check_every=1, eps_abs=1e-3, eps_rel=1e-3, sigma=1e-6,
              alpha=1.6, kkt_refine=kkt_refine)
    ref, ref_used = _jax_chunk(ops, state, **kw)
    got, used = k4.admm_dense_chunk(ops, state, **kw)
    assert got["done"].tolist() == ref["done"].tolist()
    assert used.tolist() == ref_used.tolist() == [3] * 5
    scale = {k: 1e-4 * max(1.0, float(np.abs(ref[k]).max())) for k in ("x", "zc", "zx")}
    scale["yc"] = scale["zc"] * float(ops["rc"].max())
    scale["yx"] = scale["zx"] * float(ops["rx"].max())
    for k in k4.STATE:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0, atol=scale[k], err_msg=k)


def _chunk_inputs(dtype, kkt_refine, n, m):
    args, soft_kw = _qps(n=n, m=m)
    settings = QPSettings(backend="pallas", kkt_refine=kkt_refine)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    qp = scale_dense_qp(*map(t, args), settings, **{k: t(v) for k, v in soft_kw.items()})
    rho = torch.full((5,), settings.rho)
    kw = dict(chunk_iters=3, check_every=1, eps_abs=1e-3, eps_rel=1e-3, sigma=1e-6,
              alpha=1.6, kkt_refine=kkt_refine)
    # the backend's operands are float32; the loop runs in the dtype it is given
    cast = lambda d: {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in d.items()}
    return cast(pallas_operands(qp, rho, qp.factor(rho, settings))), cast(pallas_state(qp)), kw


@pytest.mark.parametrize("rows, sizes", [
    (488, [61] * 8), (400, [50] * 8), (27, [4] * 6 + [3, 0]), (21, [3] * 7 + [0]), (3, [1] * 3 + [0] * 5),
])
def test_row_slices_cover_the_rows_with_a_ragged_end(rows, sizes):
    slices = k4.row_slices(rows)
    assert [sl.stop - sl.start for sl in slices] == sizes
    assert np.concatenate([np.arange(rows)[sl] for sl in slices]).tolist() == list(range(rows))


# n = 27 and m = 21 are no multiples of the 8 blocks: the slices of M^-1 are
# 4, ..., 4, 3, 0 rows, those of A 3, ..., 3, 0. float64: the partition only
# reorders sums, 1e-12. float32: the tolerance of the chunk against the
# Pallas kernel below, for the same reason (two orders of float32 sums
# through M^-1).
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12), (torch.float32, 1e-4)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("kkt_refine", [0, 1])
def test_partitioned_chunk_matches_plain_chunk(dtype, tol, kkt_refine):
    """Kernel 4's partition (A and M^-1 in 8 row slices, A'u as the sum of
    the slices' partial sums, xt gathered from the slices) through the plain
    chunk's loop: the same done codes, counts and state."""
    ops, state, kw = _chunk_inputs(dtype, kkt_refine, n=27, m=21)
    ref, ref_used = k4.admm_dense_plain(ops, state, **kw)
    got, used = k4.admm_dense_partitioned(ops, state, **kw)
    assert got["done"].tolist() == ref["done"].tolist()
    assert used.tolist() == ref_used.tolist()
    scale = {k: tol * max(1.0, float(ref[k].abs().max())) for k in ("x", "zc", "zx")}
    scale["yc"] = scale["zc"] * float(ops["rc"].max())
    scale["yx"] = scale["zx"] * float(ops["rx"].max())
    for k in k4.STATE:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=scale[k],
                                   err_msg=k)


def test_partitioned_chunk_matches_jax_chunk():
    """The partition against the Pallas kernel (interpret mode) at float32,
    with the tolerances of test_dense_chunk_matches_jax_chunk."""
    ops, state, kw = _chunk_inputs(torch.float32, 1, n=27, m=21)
    ref, ref_used = _jax_chunk(ops, state, **kw)
    got, used = k4.admm_dense_partitioned(ops, state, **kw)
    assert got["done"].tolist() == ref["done"].tolist()
    assert used.tolist() == ref_used.tolist()
    scale = {k: 1e-4 * max(1.0, float(np.abs(ref[k]).max())) for k in ("x", "zc", "zx")}
    scale["yc"] = scale["zc"] * float(ops["rc"].max())
    scale["yx"] = scale["zx"] * float(ops["rx"].max())
    for k in k4.STATE:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0, atol=scale[k], err_msg=k)


def test_kernel4_refuses_sizes_that_do_not_fit():
    """The cluster's shared memory holds the path's (400, 488) with room to
    spare and not (512, 488); the wrapper raises on the size check before it
    looks at the tensors."""
    assert k4.cluster_shared_bytes(400, 488) == 4 * ((61 + 50 + 15 + 8 + 8) * 400 + 9 * 64)
    k4.check_fits(400, 488)
    k4.check_fits(27, 21)
    with pytest.raises(ValueError, match="shared memory"):
        k4.check_fits(512, 488)
    with pytest.raises(ValueError, match="at most 512"):
        k4.check_fits(516, 8)
    ops = {"A": torch.zeros(1, 488, 512)}
    with pytest.raises(ValueError, match="shared memory"):
        k4.admm_dense_kernel(ops, {}, chunk_iters=1, check_every=1, eps_abs=1e-3,
                             eps_rel=1e-3, sigma=1e-6, alpha=1.6, kkt_refine=1)


def test_pallas_backend_refuses_dense_P():
    args, _ = _qps(dense_P=True)
    with pytest.raises(ValueError, match="dense P"):
        solve_box_qp(*(torch.as_tensor(a) for a in args), QPSettings(backend="pallas"))


def test_divergence_freeze_sums_over_the_shared_axis():
    """One chunk iteration of kernel 4 (JAX Pallas kernel in interpret mode
    against the port's plain version) on states built so that after the
    iteration x = X (A = 0, M^-1 = I, alpha = 1, q = -X) and yc keeps its
    value (hard equality rows at 0). n=3 < m=5. Problem 0: x_0 = yc_0 =
    0.6e12, only their sum crosses 1e12 -> frozen (done=2). Problem 1: the
    same values at different indices -> not frozen. Problem 2: yc at a row
    index past n -> frozen. Problem 3: NaN in yx -> frozen."""
    B, n, m = 4, 3, 5
    X = 0.6e12
    x_target = np.zeros((B, n))
    yc = np.zeros((B, m))
    yx = np.zeros((B, n))
    x_target[0, 0], yc[0, 0] = X, X
    x_target[1, 0], yc[1, 1] = X, X
    yc[2, 4] = 2e12
    yx[3, 1] = np.nan
    vec_n = lambda v: np.full((B, n), v)
    vec_m = lambda v: np.full((B, m), v)
    ops = {
        "M_inv": np.broadcast_to(np.eye(n), (B, n, n)).copy(), "A": np.zeros((B, m, n)),
        "P": vec_n(0.0), "q": -x_target, "lx": vec_n(-1e20), "ux": vec_n(1e20),
        "rx": vec_n(0.1), "D": vec_n(1.0), "sx": vec_n(1e20),
        "lc": vec_m(0.0), "uc": vec_m(0.0), "rc": vec_m(100.0), "E": vec_m(1.0),
        "sc": vec_m(1e20),
    }
    state = {"x": vec_n(0.0), "zc": vec_m(0.0), "zx": vec_n(0.0), "yc": yc, "yx": yx}
    kw = dict(chunk_iters=1, check_every=1, eps_abs=1e-3, eps_rel=1e-3, sigma=0.0,
              alpha=1.0, kkt_refine=0)

    f32 = lambda a: np.asarray(a, np.float32)
    pad = {2: jpk.pad_vec, 3: jpk.pad_mat}
    ones = {"rx", "D", "sx", "rc", "E", "sc"}
    j_ops = {k: (jpk.pad_vec_ones if k in ones else pad[v.ndim])(jnp.asarray(f32(v)))
             for k, v in ops.items()}
    j_state = {k: jpk.pad_vec(jnp.asarray(f32(v))) for k, v in state.items()}
    j_state["done"] = jnp.zeros((B, 1), jnp.int32)
    j_new, j_used = jpk.admm_pallas_chunk(j_ops, j_state, group=1,
                                          mxu_precision="highest", **kw)

    t_ops = {k: torch.as_tensor(f32(v)) for k, v in ops.items()}
    t_state = {k: torch.as_tensor(f32(v)) for k, v in state.items()}
    t_state["done"] = torch.zeros(B, dtype=torch.int32)
    t_new, t_used = k4.admm_dense_chunk(t_ops, t_state, **kw)

    assert np.asarray(j_new["done"])[:, 0].tolist() == [2, 0, 2, 2]
    assert t_new["done"].tolist() == [2, 0, 2, 2]
    assert t_used.tolist() == np.asarray(j_used).tolist() == [1] * B
    np.testing.assert_array_equal(t_new["x"][:3].numpy(), np.asarray(j_new["x"])[:3, :n])


def test_gershgorin_regularize_matches_jax():
    rng = np.random.default_rng(3)
    H = rng.standard_normal((3, 9, 9))
    H = H + H.transpose(0, 2, 1)
    H[0] += 20.0 * np.eye(9)  # a dominant diagonal: no shift
    got = tsqp.gershgorin_regularize(torch.as_tensor(H), 0.01)
    ref = jsqp.gershgorin_regularize(jnp.asarray(H), 0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[0].numpy(), H[0])
