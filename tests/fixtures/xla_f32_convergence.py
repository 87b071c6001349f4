"""Measure the dense "xla" default's QP convergence at float32: the JAX
package's ``MotionPlanner()`` and the port's, on the CPU, on the first
headline states.

Both planners take every default (dense ``xla`` QP with adaptive rho,
``SQPSettings()``) with the headline's margins and float32, as
``chip_smoke.py`` phase 14 builds the port's ``xla`` planner, and solve the
first ``--n`` states of ``headline_states_b2048.npz``. Prints one JSON line
per package (``qp_conv_rate``, the converged share of each SQP step's QPs,
median QP iterations, ``tol_hit_rate``) and the share of problems whose
``qp_converged`` agrees.

    JAX_PLATFORMS=cpu python tests/fixtures/xla_f32_convergence.py [--n 256]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
STATES = os.path.join(HERE, "headline_states_b2048.npz")
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)


def summary(package, conv, iters, err, tol, seconds):
    conv, iters = np.asarray(conv), np.asarray(iters)
    return {"package": package, "states": int(conv.shape[0]),
            "qp_conv_rate": float(conv.mean()),
            "qp_conv_per_step": [float(c) for c in conv.mean(0)],
            "qp_iterations_median_per_step": [float(i) for i in np.median(iters, 0)],
            "tol_hit_rate": float((np.asarray(err) <= tol).mean()), "seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    a = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax
    import jax.numpy as jnp
    import torch

    from mpc_motion_planner_tpu.planner import Margins as JMargins
    from mpc_motion_planner_tpu.planner import MotionPlanner as JPlanner
    from mpc_motion_planner_tpu_torch.planner import Margins, MotionPlanner

    torch.set_num_threads(1)
    states = np.load(STATES)
    cur, tgt = states["current"][: a.n], states["target"][: a.n]

    t0 = time.perf_counter()
    jp = JPlanner(margins=JMargins(*MARGINS), dtype=jnp.float32)

    @jax.jit
    def run(c, t):
        sol = jp.solve(c, t)
        err = jnp.max(jnp.abs(sol.x_at(jnp.ones((), sol.z.dtype)) - t), axis=-1)
        return sol.qp_converged, sol.qp_iterations, err

    jconv, jiters, jerr = jax.block_until_ready(run(jnp.asarray(cur), jnp.asarray(tgt)))
    tol = jp.target_eps + jp.qp_settings.eps_abs
    print(json.dumps(summary("jax", jconv, jiters, jerr, tol, time.perf_counter() - t0)),
          flush=True)

    t0 = time.perf_counter()
    tp = MotionPlanner(margins=Margins(*MARGINS), dtype=torch.float32, device="cpu")
    tt = torch.as_tensor(tgt)
    sol = tp.solve(torch.as_tensor(cur), tt)
    err = (sol.x_at(1.0) - tt).abs().amax(-1)
    print(json.dumps(summary("torch", sol.qp_converged.numpy(), sol.qp_iterations.numpy(),
                             err.numpy(), tol, time.perf_counter() - t0)), flush=True)
    same = (np.asarray(jconv) == sol.qp_converged.numpy()).all(-1)
    print(json.dumps({"qp_converged_agree": float(same.mean())}))


if __name__ == "__main__":
    main()
