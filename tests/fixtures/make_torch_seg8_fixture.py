"""Write the JAX reference fixture of a transcription of order 3 at another
segment count.

``torch_port_seg<segments>_b64.npz`` beside this script: the first 64
headline states (``headline_states_b2048.npz``) and what the JAX planner
made of them with its OCP swapped for ``--segments`` spline segments of
order 3 (8 by default: 25 nodes, 526 variables, 648 constraint rows; 12: 37
nodes, 778 variables, 968 rows; 15: 46 nodes; 20: 61 nodes, 1282 variables,
1608 rows; 25: 76 nodes, 1597 variables, 2008 rows; 32: 97 nodes, 2038
variables, 2568 rows),

    planner.ocp = make_ocp(planner.model, "panda_tool", order=3, num_segments=8)

in the headline slice configuration (structured QP, fixed rho, no KKT
refinement, per-step ADMM budgets 700/500), solved on the CPU at float64 as
``make_torch_port_fixture.py`` solves the 19-node fixture. ``chip_smoke.py``
phases 19 (8 segments), 23 (12), 24 (15), 25 (20), 26 (25) and 28 (32
segments) hold the port's kernel path against it on the GPU, which has no
JAX.

With ``--float32`` the fixture also holds ``final_time_float32``: the final
times of the JAX package's own float32 solve of the same states in the same
configuration with one KKT refinement step (float32 ADMM needs it from 43
nodes), the JAX figure that ``chip_smoke.py`` phase 28 holds the port's
float32 final times to where a float32 solve misses 1e-3 relative.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_seg8_fixture.py [--segments 25] [--float32]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
STATES = os.path.join(HERE, "headline_states_b2048.npz")
BATCH = 64


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--segments", type=int, default=8, help="spline segments of order 3")
    ap.add_argument("--float32", action="store_true",
                    help="also store the final times of the JAX float32 solve")
    args = ap.parse_args()
    segments = args.segments
    out = os.path.join(HERE, f"torch_port_seg{segments}_b64.npz")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from mpc_motion_planner_tpu.ocp import make_ocp
    from mpc_motion_planner_tpu.ops.qp import QPSettings
    from mpc_motion_planner_tpu.ops.sqp import SQPSettings
    from mpc_motion_planner_tpu.planner import Margins, MotionPlanner

    planner = MotionPlanner(
        margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
        qp_settings=QPSettings(
            backend="structured", kkt_refine=0, rho_update_every=0,
            ruiz_iters=2, rho=0.1, alpha=1.6, check_every=25, max_iter=700,
        ),
        sqp_settings=SQPSettings(qp_step_schedules="200,500;150,350"),
        dtype=jnp.float64,
    )
    planner.ocp = make_ocp(planner.model, "panda_tool", order=3, num_segments=segments,
                           dtype=jnp.float64)
    states = np.load(STATES)
    current = states["current"][:BATCH]
    target = states["target"][:BATCH]

    @jax.jit
    def run(cur, tgt):
        sol = planner.solve(cur, tgt)
        xT = sol.x_at(jnp.ones((), sol.z.dtype))
        err = jnp.max(jnp.abs(xT - tgt), axis=-1)
        return (sol.z, sol.violation, sol.qp_iterations, sol.qp_converged,
                sol.final_time, err)

    z, viol, iters, conv, tf, err = jax.block_until_ready(
        run(jnp.asarray(current, jnp.float64), jnp.asarray(target, jnp.float64)))
    extra = {}
    if args.float32:
        import dataclasses

        planner32 = MotionPlanner(
            margins=planner.margins, sqp_settings=planner.sqp_settings,
            qp_settings=dataclasses.replace(planner.qp_settings, kkt_refine=1),
            dtype=jnp.float32)
        planner32.ocp = make_ocp(planner32.model, "panda_tool", order=3, num_segments=segments,
                                 dtype=jnp.float32)
        sol32 = jax.jit(planner32.solve)(jnp.asarray(current, jnp.float32),
                                         jnp.asarray(target, jnp.float32))
        extra["final_time_float32"] = np.asarray(sol32.final_time, np.float32)
    np.savez_compressed(
        out,
        **extra,
        current=current,
        target=target,
        z=np.asarray(z, np.float32),
        violation=np.asarray(viol, np.float32),
        qp_iterations=np.asarray(iters, np.int32),
        qp_converged=np.asarray(conv, bool),
        final_time=np.asarray(tf, np.float32),
        terminal_err=np.asarray(err, np.float32),
    )
    print(f"wrote {out}: z {np.asarray(z).shape}, qp_conv {np.asarray(conv).mean():.4f}, "
          f"median violation {np.median(np.asarray(viol)):.4f}, "
          f"terminal err max {np.asarray(err).max():.5f}")


if __name__ == "__main__":
    main()
