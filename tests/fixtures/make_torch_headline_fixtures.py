"""Write the headline states and the dense-QP JAX fixture of the PyTorch port.

Two files beside this script:

``headline_states_b2048.npz``
    ``current``/``target`` (2048, 14) float32: the JAX package's
    ``chain_states(planner, PRNGKey(0), 2048)`` drawn at float32 with x64
    off, as ``bench/headline.py`` draws them, so they are the headline
    benchmark's own states bit for bit. ``chip_smoke.py`` solves them.

``torch_port_dense_b64.npz``
    The first 64 of those states and what the JAX planner made of them with
    the headline's dense configuration (``BENCH_QP_BACKEND=pallas``:
    ``backend="pallas"``, ``kkt_refine=1``, fixed rho, LU inverse, Ruiz 2,
    budgets 700/700), solved on the CPU at float32 with the dense ADMM
    kernel (``admm_pallas_chunk``) in Pallas interpret mode, as the JAX
    package's own tests run it.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_headline_fixtures.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
STATES = os.path.join(HERE, "headline_states_b2048.npz")
DENSE = os.path.join(HERE, "torch_port_dense_b64.npz")
HEADLINE_BATCH = 2048
DENSE_BATCH = 64
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax
    import jax.numpy as jnp

    assert not jax.config.jax_enable_x64, "the headline draws its states with x64 off"

    from mpc_motion_planner_tpu.bench.harness import chain_states
    from mpc_motion_planner_tpu.ops.qp import QPSettings
    from mpc_motion_planner_tpu.ops.sqp import SQPSettings
    from mpc_motion_planner_tpu.planner import Margins, MotionPlanner

    planner = MotionPlanner(
        margins=Margins(*MARGINS),
        qp_settings=QPSettings(
            backend="pallas", kkt_refine=1, rho_update_every=0, kkt_factor="lu",
            ruiz_iters=2, rho=0.1, alpha=1.6, max_iter=700, check_every=25,
        ),
        sqp_settings=SQPSettings(),
        dtype=jnp.float32,
    )
    t0 = time.perf_counter()
    current, target = chain_states(planner, jax.random.PRNGKey(0), HEADLINE_BATCH)
    current = np.asarray(current, np.float32)
    target = np.asarray(target, np.float32)
    np.savez_compressed(STATES, current=current, target=target)
    print(f"wrote {STATES} in {time.perf_counter() - t0:.1f} s")

    cur = jnp.asarray(current[:DENSE_BATCH])
    tgt = jnp.asarray(target[:DENSE_BATCH])
    t0 = time.perf_counter()
    sol = planner.solve(cur, tgt)
    xT = sol.x_at(jnp.ones((), sol.z.dtype))
    err = jnp.max(jnp.abs(xT - tgt), axis=-1)
    jax.block_until_ready(sol.z)
    np.savez_compressed(
        DENSE,
        current=current[:DENSE_BATCH],
        target=target[:DENSE_BATCH],
        z=np.asarray(sol.z, np.float32),
        violation=np.asarray(sol.violation, np.float32),
        qp_iterations=np.asarray(sol.qp_iterations, np.int32),
        qp_converged=np.asarray(sol.qp_converged, bool),
        final_time=np.asarray(sol.final_time, np.float32),
        terminal_err=np.asarray(err, np.float32),
    )
    conv = np.asarray(sol.qp_converged)
    print(f"wrote {DENSE} in {time.perf_counter() - t0:.1f} s: qp_conv "
          f"{conv.mean():.4f} (per step {conv.mean(0).tolist()}), median violation "
          f"{np.median(np.asarray(sol.violation)):.4f}, terminal err max "
          f"{np.asarray(err).max():.5f}")


if __name__ == "__main__":
    main()
