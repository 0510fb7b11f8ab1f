"""Numerics core of the port: bit-plane slicing, the sliced integer GEMM
dataflows, and the paper's photonic hardware models.

``slicing`` and ``spoga`` are the algebraic reference of the GEMM kernels
(the paper's Fig. 2: the fused SPOGA dataflow, the DEAS prior-work baseline
and the plain int8 product).  ``photonic_model`` (Table I's link budget),
``energy_model``, ``workloads`` (the CNN GEMM traces) and
``accelerator_sim`` (Fig. 5) are pure Python: import them by module.
"""

from repro_torch.core.slicing import (
    reconstruct,
    reconstruct_planes,
    slice_nibbles,
    slice_planes,
    slice_sm,
    slice_tc,
)
from repro_torch.core.spoga import (
    deas_matmul,
    direct_matmul,
    quantized_matmul,
    sliced_dot_planes,
    sliced_matmul,
    spoga_matmul,
)

__all__ = [
    "deas_matmul",
    "direct_matmul",
    "quantized_matmul",
    "reconstruct",
    "reconstruct_planes",
    "slice_nibbles",
    "slice_planes",
    "slice_sm",
    "slice_tc",
    "sliced_dot_planes",
    "sliced_matmul",
    "spoga_matmul",
]
