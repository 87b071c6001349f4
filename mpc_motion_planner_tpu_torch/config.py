"""Shipping solver configuration of the PyTorch port.

The QP is always the structured solver; whether its hot parts run as the
hand-written CUDA kernels or as their plain PyTorch versions follows the
device of the tensors (CUDA: kernels; CPU: plain), so there is no backend
switch. The per-step ADMM budgets are the JAX package's shipping ones.
"""

from __future__ import annotations

import torch

from .ops.qp import QPSettings

# Per-SQP-step ADMM budgets (SQPSettings.qp_step_schedules): 700 iterations
# in SQP step 0 and 500 in step 1, as the JAX package ships them.
SHIPPING_SQP_SCHEDULES = "200,500;150,350"

# The headline QP settings (the JAX headline benchmark's configuration).
SHIPPING_QP_SETTINGS = QPSettings(
    max_iter=700, check_every=25, rho=0.1, alpha=1.6, ruiz_iters=2,
    rho_update_every=0, kkt_refine=0,
)


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
