"""Hand-written CUDA kernels of the port and their launch counts.

Kernel sources live in ``../csrc``; each wrapper module builds its kernel
lazily (:mod:`.build`), so importing this package needs neither ``nvcc`` nor
a GPU.
"""

from __future__ import annotations

from . import admm_dense, banded_factor, constraints, structured_admm

KERNELS = {
    "constraints": constraints.KERNEL,
    "banded_factor": banded_factor.KERNEL,
    "structured_admm": structured_admm.KERNEL,
    "admm_dense": admm_dense.KERNEL,
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
    banded_factor.REPAIRS.reset()
    banded_factor.OVERFLOW.reset()
    structured_admm.REFACTORS.reset()


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def add_launch_counts(counts: dict) -> None:
    """Add per-kernel launches that ran outside the wrappers' own count: a
    captured CUDA graph's launches, at every replay."""
    for name, n in counts.items():
        KERNELS[name].launches += n
