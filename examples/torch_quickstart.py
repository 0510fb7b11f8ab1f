"""Quickstart on the PyTorch port: SPOGA's bit-sliced INT8 GEMM in a minute.

    PYTHONPATH=src python examples/torch_quickstart.py                # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

1. Slice INT8 operands into nibbles (two's complement and the paper's
   sign-magnitude) and verify exact reconstruction.
2. Run the three GEMM dataflows (prior-work DEAS, the paper's SPOGA,
   native direct) in both encodings and verify they agree EXACTLY in int32.
3. Run the ``spoga_gemm`` kernel (on the card the CUDA kernel, on the CPU
   its plain version) against the exact oracles of ``kernels/ref.py``.
4. Run one quantized W8A8 linear layer end to end.
5. Pick GEMM backends from the registry and run the parametric quant
   modes (w4a8: 4-bit weights in ONE slice plane — half the partials).
6. Serve staggered requests through the continuous-batching engine and
   check scheduling is output-invisible (== solo greedy decode).
"""

import argparse

import numpy as np
import torch

from repro_torch.backends import list_backends, quant_mode_summary, quantized_linear
from repro_torch.core.slicing import reconstruct, slice_nibbles, slice_planes
from repro_torch.core.spoga import (
    deas_matmul,
    direct_matmul,
    quantized_matmul,
    spoga_matmul,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import spoga_gemm as spoga_gemm_mod
from repro_torch.kernels.ref import ref_int8_gemm, ref_spoga_gemm
from repro_torch.models.layers import linear
from repro_torch.quant.qtensor import quantize


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    def ints(shape):
        return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).to(dev)

    def normal(shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(dev)

    # 1 — nibble slicing is exact for the full int8 range, in both encodings
    x = ints((4, 8))
    for enc in ("tc", "sm"):
        msn, lsn = slice_nibbles(x, enc)
        assert torch.equal(reconstruct(msn, lsn), x), enc
    everything = torch.arange(-128, 128, dtype=torch.int8, device=dev)
    assert torch.equal(reconstruct(*slice_nibbles(everything, "sm")), everything)
    print("1. slicing: x == 16*MSN + LSN exactly; tc: MSN in [-8,7], LSN in [0,15]; "
          "sm: the sign on both nibbles")

    # 2 — the three dataflows are the same integer arithmetic
    a, b = ints((64, 128)), ints((128, 32))
    o_direct = direct_matmul(a, b)
    for enc in ("tc", "sm"):
        o_deas, o_spoga = deas_matmul(a, b, encoding=enc), spoga_matmul(a, b, encoding=enc)
        assert torch.equal(o_deas, o_spoga) and torch.equal(o_spoga, o_direct), enc
    print("2. dataflows: deas == spoga == direct (int32-exact, both encodings), out",
          tuple(o_direct.shape))

    # 3 — the fused kernel against the exact oracles
    launches = spoga_gemm_mod.LAUNCHES
    o_kernel = spoga_gemm_mod.spoga_gemm(a, b)
    assert torch.equal(o_kernel, ref_spoga_gemm(a, b))
    assert torch.equal(o_kernel, ref_int8_gemm(a, b))
    ran = ("the CUDA kernel" if spoga_gemm_mod.LAUNCHES > launches
           else "the kernel's plain version")
    print(f"3. spoga_gemm ({ran} on {dev.type}): fused radix accumulation == the oracles")

    # 4 — a W8A8 quantized linear layer
    h, w = normal((16, 128)), normal((128, 32), 0.1)
    hq, wq = quantize(h, dim=-1), quantize(w, dim=0)
    y = quantized_matmul(hq.data, wq.data, hq.scale, wq.scale.reshape(1, -1),
                         mode="int8_spoga")
    err = float((y - h @ w).abs().max() / (h @ w).abs().max())
    print(f"4. W8A8 linear: relative error vs fp32 = {err:.4f} (quantization only)")

    # 5 — the backend registry + parametric quant modes end to end
    print(f"5. GEMM backend registry: {', '.join(list_backends())}")
    hx, wx = normal((2, 16, 96)), normal((96, 40), 0.1)
    exact = torch.einsum("...k,kn->...n", hx, wx)
    for mode in ("int8_spoga", "w4a8", "w4a4"):
        # the auto-selected backend (the fused dequantizing kernel on the
        # card) and the int32 kernel with the epilogue after it must agree
        # on the same quantized integers
        y_auto = quantized_linear(hx, wx, mode, out_dtype=torch.float32)
        y_int = quantized_linear(hx, wx, mode, backend="cuda_spoga", out_dtype=torch.float32)
        assert torch.equal(y_auto, y_int), mode
        rel = float(torch.linalg.norm(y_auto - exact) / torch.linalg.norm(exact))
        print(f"   {quant_mode_summary(mode):52s} rel err {rel:.4f}")
    # w4a8 weights really do ride a single 4-bit plane:
    w4 = quantize(wx, dim=0, bits=4)
    (plane,) = slice_planes(w4.data, 1, 4)
    assert torch.equal(plane, w4.data)
    # ... and the model-layer entry point takes the same modes:
    y_layer = linear(hx.to(torch.bfloat16), wx.to(torch.bfloat16), "w4a8")
    assert y_layer.shape == exact.shape
    print("   w4a8 through models.layers.linear (STE backward-ready):",
          tuple(y_layer.shape), y_layer.dtype)

    # 6 — continuous batching: mixed-length requests, staggered arrivals, fewer
    # slots than requests (queueing + slot reuse). Each request's greedy tokens
    # must equal a solo run — the scheduler is invisible in the outputs.
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingEngine

    cfg = reduced(get_config("llama3.2-1b"))
    params = init_params(cfg, seed=0, device=dev)
    engine = ServingEngine(cfg, params, EngineConfig(
        n_slots=2, cache_len=32, prefill_buckets=(8, 16)), device=dev)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 9, 3)]
    metrics = engine.run([(0, prompts[0], 6), (0, prompts[1], 4), (2, prompts[2], 5)])
    for req in sorted(metrics.finished, key=lambda r: r.req_id):
        solo, _ = serve_batch(cfg, params,
                              {"tokens": torch.tensor([req.prompt], dtype=torch.int32,
                                                      device=dev)},
                              cache_len=32, gen_tokens=req.max_new_tokens)
        assert req.output_tokens == solo[0].tolist()
    print(f"6. continuous batching: 3 staggered requests on 2 slots == solo decode; "
          f"{metrics.report()['tokens_per_s']:.0f} tok/s")
    print("quickstart OK")


if __name__ == "__main__":
    main()
