"""End-to-end driver on the port: train an LM with the SPOGA INT8 dataflow.

Default invocation trains the xLSTM-125m config for 300 steps on the
synthetic pipeline with checkpointing every 50 steps, on the card:

    PYTHONPATH=src python examples/torch_train_lm.py                  # 300 steps
    PYTHONPATH=src python examples/torch_train_lm.py --smoke --device cpu   # tiny, 30 steps
    PYTHONPATH=src python examples/torch_train_lm.py --arch llama3.2-1b \\
        --quant-mode int8_spoga --steps 500 --ckpt-dir /tmp/spoga_ckpt

At an integer ``--quant-mode`` every projection's forward is the quantized
GEMM (on the card, the hand-written kernel) and its backward the
straight-through estimator.
"""

import argparse
import math

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.train import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--quant-mode", default="int8_spoga",
                    choices=["bf16", "int8_spoga", "int8_deas", "int8_direct"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + 30 steps (CI-sized)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
        args.steps, args.batch, args.seq = 30, 4, 64
    cfg = cfg.with_(quant_mode=args.quant_mode, remat=False)

    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=max(args.steps // 20, 3),
                       total_steps=args.steps)
    _, losses = train_loop(cfg, tcfg, steps=args.steps, batch=args.batch,
                           seq=args.seq, ckpt_dir=args.ckpt_dir,
                           checkpoint_every=50, log_every=10, device=args.device)
    assert all(math.isfinite(x) for x in losses)
    print(f"[train_lm] {args.arch} ({args.quant_mode}): "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} steps")


if __name__ == "__main__":
    main()
