"""Write the JAX reference fixture that the PyTorch port is held against.

Draws the first 64 chained benchmark states of ``PRNGKey(0)`` at float32
(the headline's dtype), solves them with the JAX package on the CPU with the
headline slice configuration (structured QP, fixed rho, no KKT refinement,
per-step ADMM budgets 700/500), and stores the inputs and what the
reference solve made of them in ``torch_port_slice_b64.npz`` beside this
script.

The reference solve runs at float64. At float32 the JAX package's portable
structured path factors the KKT system in its group-tridiagonal form with
dense inverses of the 63x63 group blocks, and on these states it stops short
of the convergence test on 4 of the 64 step-0 QPs (qp_conv 0.969) that the
float64 solve, and the node-level factor form that the TPU kernel and the
port use, converge (qp_conv 1.0, with final times within 1e-5 relative).

The machine with the GPU has no JAX, so ``chip_smoke.py`` reads this file to
compare the port with the reference there; the CPU slice test takes its
first four states from it.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_port_fixture.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_port_slice_b64.npz")
BATCH = 64


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from mpc_motion_planner_tpu.bench.harness import chain_states
    from mpc_motion_planner_tpu.ops.qp import QPSettings
    from mpc_motion_planner_tpu.ops.sqp import SQPSettings
    from mpc_motion_planner_tpu.planner import Margins, MotionPlanner

    def make(dtype):
        return MotionPlanner(
            margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
            qp_settings=QPSettings(
                backend="structured", kkt_refine=0, rho_update_every=0,
                ruiz_iters=2, rho=0.1, alpha=1.6, check_every=25, max_iter=700,
            ),
            sqp_settings=SQPSettings(qp_step_schedules="200,500;150,350"),
            dtype=dtype,
        )

    current, target = chain_states(make(jnp.float32), jax.random.PRNGKey(0), BATCH)
    planner = make(jnp.float64)
    current, target = current.astype(jnp.float64), target.astype(jnp.float64)

    @jax.jit
    def run(cur, tgt):
        sol = planner.solve(cur, tgt)
        xT = sol.x_at(jnp.ones((), sol.z.dtype))
        err = jnp.max(jnp.abs(xT - tgt), axis=-1)
        return (sol.z, sol.violation, sol.qp_iterations, sol.qp_converged,
                sol.final_time, err)

    z, viol, iters, conv, tf, err = jax.block_until_ready(run(current, target))
    np.savez_compressed(
        OUT,
        current=np.asarray(current, np.float32),
        target=np.asarray(target, np.float32),
        z=np.asarray(z, np.float32),
        violation=np.asarray(viol, np.float32),
        qp_iterations=np.asarray(iters, np.int32),
        qp_converged=np.asarray(conv, bool),
        final_time=np.asarray(tf, np.float32),
        terminal_err=np.asarray(err, np.float32),
    )
    print(f"wrote {OUT}: qp_conv {np.asarray(conv).mean():.4f}, "
          f"median violation {np.median(np.asarray(viol)):.4f}, "
          f"terminal err max {np.asarray(err).max():.5f}")


if __name__ == "__main__":
    main()
