"""Write the JAX reference fixture of a seeded serial chain (12 joints
unless ``--joints`` names another count).

``torch_port_chain<NQ>_b64.npz`` beside this script: the first 64 (current,
target) states of the seeded serial revolute chain of NQ joints, as
``mpc_motion_planner_tpu_torch.bench.convergence`` ``chain(NQ, ...)``
draws them at float32 (the URDF of ``make_panda6_fixture.py``
``chain_urdf(NQ, seed=NQ)``, the Panda's limits with its last joint's
repeated past 7, states at rest drawn from the seed NQ), and what the JAX
planner made of them at 19 nodes (6 spline segments of order 3: 685
variables and 823 constraint rows at 12 joints, 1,198 and 1,426 at 21),
with no floor for the chain's tool
(``set_min_height(-10.0)``), in the headline slice configuration
(structured QP, fixed rho, no KKT refinement, per-step ADMM budgets
700/500), solved on the CPU at float64 as ``make_torch_port_fixture.py``
solves the 19-node fixture.

It also holds ``final_time_float32``: the final times of the JAX package's
own float32 solve of the same states in the same configuration, the figure
that ``chip_smoke.py`` phases 29 (12 joints), 31 (21 joints) and 32 (25
joints) hold the port's float32 final times to
(the seeded chains' QPs do not converge within these budgets, at float64
either, so a float32 solve parts from float64 on more states than the
Panda's).

    JAX_PLATFORMS=cpu python tests/fixtures/make_chain12_fixture.py
    JAX_PLATFORMS=cpu python tests/fixtures/make_chain12_fixture.py --joints 21
    JAX_PLATFORMS=cpu python tests/fixtures/make_chain12_fixture.py --joints 25
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
BATCH = 64
LIMIT_ARRAYS = ("min_position", "max_position", "max_velocity", "max_acceleration",
                "max_jerk", "max_torque")


def fixture_path(nq: int) -> str:
    """The fixture of the seeded chain of ``nq`` joints."""
    return os.path.join(HERE, f"torch_port_chain{nq}_b64.npz")


def chain_states(nq: int = 12, n: int = BATCH):
    """The first ``n`` (current, target) states of the port's seeded chain
    of ``nq`` joints at float32, as numpy arrays."""
    import torch

    sys.path.insert(0, ROOT)
    from mpc_motion_planner_tpu_torch.bench.convergence import chain

    _, _, _, cur, tgt = chain(nq, n, torch.float32, torch.device("cpu"))
    return cur.numpy(), tgt.numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--joints", type=int, default=12, help="joints of the seeded chain")
    NQ = ap.parse_args(argv).joints
    OUT = fixture_path(NQ)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)
    current, target = chain_states(NQ)

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import make_panda6_fixture as robots

    from mpc_motion_planner_tpu.models.panda import make_panda_limits
    from mpc_motion_planner_tpu.models.urdf import parse_urdf
    from mpc_motion_planner_tpu.ops.qp import QPSettings
    from mpc_motion_planner_tpu.ops.sqp import SQPSettings
    from mpc_motion_planner_tpu.planner import Margins, MotionPlanner

    lim = make_panda_limits()
    limits = dataclasses.replace(lim, **{
        k: np.concatenate([np.asarray(getattr(lim, k)),
                           np.repeat(np.asarray(getattr(lim, k))[-1:], NQ - 7)])
        for k in LIMIT_ARRAYS})
    model = parse_urdf(robots.chain_urdf(NQ, seed=NQ))

    def planner_of(dtype):
        pl = MotionPlanner(
            model=model, limits=limits, tool_frame="tool",
            margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
            qp_settings=QPSettings(
                backend="structured", kkt_refine=0, rho_update_every=0,
                ruiz_iters=2, rho=0.1, alpha=1.6, check_every=25, max_iter=700,
            ),
            sqp_settings=SQPSettings(qp_step_schedules="200,500;150,350"),
            dtype=dtype,
        )
        pl.set_min_height(-10.0)
        return pl

    planner = planner_of(jnp.float64)
    assert planner.ocp.nq == NQ and planner.ocp.num_var == 19 * 3 * NQ + 1

    @jax.jit
    def run(cur, tgt):
        sol = planner.solve(cur, tgt)
        xT = sol.x_at(jnp.ones((), sol.z.dtype))
        err = jnp.max(jnp.abs(xT - tgt), axis=-1)
        return (sol.z, sol.violation, sol.qp_iterations, sol.qp_converged,
                sol.final_time, err)

    z, viol, iters, conv, tf, err = jax.block_until_ready(
        run(jnp.asarray(current, jnp.float64), jnp.asarray(target, jnp.float64)))
    planner32 = planner_of(jnp.float32)
    sol32 = jax.jit(planner32.solve)(jnp.asarray(current, jnp.float32),
                                     jnp.asarray(target, jnp.float32))
    np.savez_compressed(
        OUT,
        current=current,
        target=target,
        z=np.asarray(z, np.float64),
        violation=np.asarray(viol, np.float64),
        qp_iterations=np.asarray(iters, np.int32),
        qp_converged=np.asarray(conv, bool),
        final_time=np.asarray(tf, np.float64),
        terminal_err=np.asarray(err, np.float64),
        final_time_float32=np.asarray(sol32.final_time, np.float32),
    )
    tf32 = np.asarray(sol32.final_time, np.float64)
    within = int((np.abs(tf32 - np.asarray(tf)) <= 1e-3 * np.abs(np.asarray(tf))).sum())
    print(f"wrote {OUT}: z {np.asarray(z).shape}, qp_conv {np.asarray(conv).mean():.4f}, "
          f"median violation {np.median(np.asarray(viol)):.4f}, terminal err max "
          f"{np.asarray(err).max():.5f}; float32 final times within 1e-3: {within}/{BATCH}")


if __name__ == "__main__":
    main()
