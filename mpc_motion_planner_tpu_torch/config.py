"""Shipping solver configuration of the PyTorch port.

Counterpart of ``mpc_motion_planner_tpu/config.py``. Two things choose how
a QP is solved, independently:

* ``QPSettings.backend`` chooses the algorithm: "structured" and
  "structured_pallas" the structured solver (matrix-free operator, banded
  KKT factor), "pallas" the dense solver in float32 chunks, "xla" the
  dense solver's portable loop (the JAX package's default).
* The device of the tensors chooses kernel or plain: for CUDA tensors each
  wrapper launches its hand-written kernel (kernels 2 and 3 for the
  structured backends, kernel 4 for "pallas", kernel 1 for the constraint
  rows of every backend); for CPU tensors it runs the kernel's plain
  PyTorch version. The "xla" loop is plain PyTorch on every device, as the
  JAX package's "xla" backend has no Pallas kernel.

``MotionPlanner()`` takes the JAX package's defaults (dense "xla" QP with
adaptive rho, 700/700 iterations); the shipping configuration below is
what the headline runs and is passed explicitly. A planner whose OCP is
swapped for a finer transcription takes ``shipping_qp_settings`` of its
node count.
"""

from __future__ import annotations

import dataclasses

import torch

from .ops.qp import QPSettings

# Per-SQP-step ADMM budgets (SQPSettings.qp_step_schedules): 700 iterations
# in SQP step 0 and 500 in step 1, as the JAX package ships them for its
# structured_pallas backend.
SHIPPING_SQP_SCHEDULES = "200,500;150,350"

# The headline QP settings (the JAX headline benchmark's configuration).
SHIPPING_QP_SETTINGS = QPSettings(
    backend="structured_pallas", max_iter=700, check_every=25, rho=0.1, alpha=1.6,
    ruiz_iters=2, rho_update_every=0, kkt_refine=0,
)

# Nodes from which the shipping configuration refines every KKT solve once:
# from there the float32 banded factor's error stalls ADMM short of its
# tolerance on a growing share of the step-0 QPs (the Panda on the first 64
# headline states: 40 nodes all converge, 43 nodes 95%, 46 nodes 88%; one
# refinement step, all at 46 and 49 nodes).
KKT_REFINE_FROM_NODES = 43

# Nodes from which the shipping configuration gives a QP that has not
# converged within its step's budget RESCUE_ITERS more iterations
# (QPSettings.rescue_iters, the JAX package's opt-in straggler budget):
# from there the shipping budgets leave a growing share of the QPs
# unconverged, at float64 too (the Panda on the 2048 headline states, one
# refinement step: 76 nodes 0.995 converge, 85 nodes 0.987, 97 nodes 0.970,
# 121 nodes 0.882; with 300 more, 0.996 at 97 and 0.982 at 121). A block of
# kernel 3 stops at its own convergence, so only the stragglers run longer.
RESCUE_FROM_NODES = 85
RESCUE_ITERS = 300


def shipping_qp_settings(num_nodes: int) -> QPSettings:
    """The shipping QP settings for a transcription of ``num_nodes`` nodes:
    ``SHIPPING_QP_SETTINGS`` with one refinement step on every KKT solve
    from ``KKT_REFINE_FROM_NODES`` up, and ``RESCUE_ITERS`` more iterations
    for the QPs that have not converged within their budget from
    ``RESCUE_FROM_NODES`` up."""
    if num_nodes < KKT_REFINE_FROM_NODES:
        return SHIPPING_QP_SETTINGS
    rescue = RESCUE_ITERS if num_nodes >= RESCUE_FROM_NODES else 0
    return dataclasses.replace(SHIPPING_QP_SETTINGS, kkt_refine=1, rescue_iters=rescue)


def shipping_backend(device_type: str) -> str:
    """QP backend for a device type ("cuda", "cpu"): the structured solver
    on both; "structured_pallas" names the one whose hot loop is a kernel."""
    return "structured_pallas" if device_type == "cuda" else "structured"


def shipping_sqp_schedules(backend: str) -> str:
    """Per-step budgets: the shipping ones for "structured_pallas", the
    uniform 2 x max_iter budget for every other backend."""
    return SHIPPING_SQP_SCHEDULES if backend == "structured_pallas" else ""


def full_precision() -> dict:
    """Turn TF32 off and ask for full float32 matmuls, and return the
    resulting flags. Reduced matmul precision collapses ADMM quality, so an
    entry point that runs the solver on a GPU calls this first."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return {
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }
