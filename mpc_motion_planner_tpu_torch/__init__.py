"""PyTorch/CUDA port of the minimum-time MPC motion planner.

A second package beside ``mpc_motion_planner_tpu`` (the JAX reference):
the same batched solve, with the hot kernels hand-written in CUDA C++ for
Hopper (``csrc/``, bound in ``kernels/``). It imports no JAX.
"""
