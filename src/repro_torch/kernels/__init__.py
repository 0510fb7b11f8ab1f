"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc/``),
each beside its plain PyTorch version.  Importing this package builds
nothing: ``_build.library()`` compiles on first launch.

Submodules, each named after its kernel: ``spoga_gemm`` /
``spoga_gemm_dequant`` (the paper's fused bit-sliced GEMM, int32 out or
with the dequantizing epilogue), ``deas_gemm`` (the prior-work baseline:
four stored nibble products, then the shift-add), ``paged_attention``
(decode attention over block tables); ``ops`` dispatches through the
backend registry and ``ref`` holds exact integer oracles.  Unlike the
reference's package, this one does not re-export the four kernel
functions: ``kernels.spoga_gemm`` etc. stay the modules, whose launch
counters the callers read."""

from repro_torch.kernels.ops import int8_gemm, int8_gemm_dequant
from repro_torch.kernels.paged_attention import paged_attention_ref

__all__ = ["int8_gemm", "int8_gemm_dequant", "paged_attention_ref"]
