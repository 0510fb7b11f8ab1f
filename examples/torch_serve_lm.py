"""Serve a model with batched requests on the port: prefill + decode w/ KV cache.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch llama3.2-1b   # on the card
    PYTHONPATH=src python examples/torch_serve_lm.py --arch llama3.2-1b --smoke --device cpu
    PYTHONPATH=src python examples/torch_serve_lm.py --arch recurrentgemma-9b --smoke \\
        --batch 8 --gen 32 --device cpu     # bounded-state decode (RG-LRU + local attn)

Every architecture family serves through the same two entry points
(``prefill`` then repeated ``decode_step``, driven by ``serve_batch``);
dense GQA, MLA, MoE, xLSTM state, RG-LRU and enc-dec cross-attention
caches all work.
"""

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve_batch
from repro_torch.models import init_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--quant-mode", default="bf16")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    cfg = cfg.with_(quant_mode=args.quant_mode, remat=False)
    dev = resolve_device(args.device)

    params = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if cfg.is_encoder_decoder:
        batch = {
            "src_embeds": (torch.randn((args.batch, args.prompt_len, cfg.d_model),
                                       generator=gen, device=dev) * 0.02),
            "tgt_tokens": torch.randint(0, cfg.vocab_size, (args.batch, 4), generator=gen,
                                        device=dev, dtype=torch.int32),
        }
    elif cfg.frontend is not None:
        batch = {"embeds": (torch.randn((args.batch, args.prompt_len, cfg.d_model),
                                        generator=gen, device=dev) * 0.02)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                                         generator=gen, device=dev, dtype=torch.int32)}

    t0 = time.time()
    out, _ = serve_batch(cfg, params, batch, cache_len=args.prompt_len + args.gen,
                         gen_tokens=args.gen)
    dt = time.time() - t0
    toks = args.batch * args.gen
    assert tuple(out.shape) == (args.batch, args.gen)
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all())
    print(f"[serve_lm] {args.arch} on {dev}: generated {tuple(out.shape)} "
          f"({toks} tokens in {dt:.2f}s = {toks / dt:.1f} tok/s)")
    print("[serve_lm] sample:", out[0, :12].tolist())


if __name__ == "__main__":
    main()
