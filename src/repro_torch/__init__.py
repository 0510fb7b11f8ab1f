"""PyTorch / CUDA port of the SPOGA reproduction, beside the JAX package.

Layout mirrors ``src/repro/`` module for module (``repro_torch/models/
attention.py`` <-> ``repro/models/attention.py``).  The port imports torch
and numpy, never jax and nothing of ``repro``.  Its TPU kernels are
hand-written CUDA C++ for Hopper (``csrc/``), built by ``nvcc`` on first
use (``kernels/_build.py``); each sits beside a plain PyTorch version that
serves CPU tensors.
"""
