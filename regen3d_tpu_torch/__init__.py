"""PyTorch + CUDA port of regen3d_tpu for NVIDIA Hopper (H100).

The JAX package ``regen3d_tpu`` stays the reference; this package imports
``torch`` and never ``jax`` or ``regen3d_tpu``. Its hand-written CUDA kernels
live in ``csrc/`` and are built at first use by :mod:`regen3d_tpu_torch.kernels`.
"""
