"""PTQ flow on the port: calibrate a trained model's activations, compare quant modes.

    PYTHONPATH=src python examples/torch_quantize_model.py              # on the card
    PYTHONPATH=src python examples/torch_quantize_model.py --device cpu

Trains a tiny LM in bf16, then evaluates the SAME weights under the three
INT8 execution dataflows (paper Fig. 2) plus bf16, showing

* spoga / deas / direct produce IDENTICAL logits (same integer math),
* the quantization error vs bf16 is small,
* per-tensor absmax vs 99.9th-percentile calibration scales.
"""

import argparse

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.launch.train import train_loop
from repro_torch.models import forward
from repro_torch.quant.calibrate import absmax_calibrate, percentile_calibrate

ARCH = "llama3.2-1b"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg_bf16 = reduced(get_config(ARCH)).with_(n_layers=2, remat=False)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=3, total_steps=30)
    params, losses = train_loop(cfg_bf16, tcfg, steps=30, batch=4, seq=64, log_every=10,
                                device=args.device)
    print(f"[quantize] trained bf16: loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    pipe = SyntheticTokenPipeline(cfg_bf16.vocab_size, 64, 4, seed=99, device=args.device)
    batch = {"tokens": pipe.global_batch_at(0)}

    with torch.no_grad():
        ref = forward(params, cfg_bf16, batch).float()
        outs = {mode: forward(params, cfg_bf16.with_(quant_mode=mode), batch).float()
                for mode in ("int8_spoga", "int8_deas", "int8_direct")}

    assert torch.equal(outs["int8_spoga"], outs["int8_deas"])
    assert torch.equal(outs["int8_spoga"], outs["int8_direct"])
    print("[quantize] spoga == deas == direct: identical logits (exact int math)")

    err = float((outs["int8_spoga"] - ref).abs().max() / (ref.abs().max() + 1e-9))
    agree = float((outs["int8_spoga"].argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"[quantize] int8 vs bf16: max rel err {err:.4f}, "
          f"argmax agreement {100 * agree:.1f}%")

    # calibration: collect an activation sample and compare scale estimators
    acts = [torch.randn(1024, generator=torch.Generator().manual_seed(i))
            * (1.0 + 5.0 * (i == 2)) for i in range(4)]     # one outlier batch
    print(f"[quantize] absmax scale      = {float(absmax_calibrate(acts)):.5f}")
    print(f"[quantize] p99.9 scale       = {float(percentile_calibrate(acts)):.5f} "
          f"(robust to the outlier batch)")


if __name__ == "__main__":
    main()
