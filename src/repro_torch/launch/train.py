"""End-to-end training driver (the port of ``repro/launch/train.py``).

Runs real steps on one device -- the card unless ``--device cpu`` --
with asynchronous checkpointing, resume from the latest checkpoint and
straggler monitoring:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --reduced --steps 20 --batch 8 --seq 128 --device cpu --ckpt-dir DIR

At an integer ``--quant-mode`` every projection runs the quantized GEMM
forward (on the card, the hand-written kernel) and the straight-through
backward.  ``train_loop(..., mesh=)`` trains data-parallel over the
mesh's "data" axis (``launch.steps``; ``TrainConfig.grad_compression``
selects the int8-compressed gradient all-reduce); every rank draws the
same global batch and takes its slice, and only data rank 0 writes
checkpoints.  On the command line, ``--dp N`` under ``torchrun
--nproc-per-node N`` (``--grad-compression`` for the int8 all-reduce).
"""

from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced as reduce_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.optim.optimizers import adamw_init
from repro_torch.runtime.fault_tolerance import StragglerMonitor


def train_loop(cfg, tcfg: TrainConfig, *, steps: int, batch: int, seq: int,
               ckpt_dir: str | None = None, checkpoint_every: int = 10,
               log_every: int = 1, seed: int = 0, device=None, mesh=None):
    """Train ``steps`` steps from ``init_params(cfg, seed)`` on ``device``
    (default: the card), resuming from ``ckpt_dir``'s latest checkpoint
    when it has one.  ``mesh``: data-parallel over its "data" axis
    (``batch`` is the global batch).  Returns (final params, losses of the
    steps run)."""
    dev = resolve_device(device)
    params = init_params(cfg, seed=seed, device=dev)
    opt_state = adamw_init(params, device=dev)
    pipeline = SyntheticTokenPipeline(cfg.vocab_size, seq, batch, seed=seed, device=str(dev))
    step_fn = make_train_step(cfg, tcfg, mesh=mesh)
    writer = mesh is None or mesh.axis_rank("data") == 0
    manager = CheckpointManager(ckpt_dir, keep_n=2, async_save=True) if ckpt_dir else None
    monitor = StragglerMonitor(n_hosts=1)

    start = 0
    if manager is not None:
        try:
            start, (params, opt_state), _ = manager.restore_latest((params, opt_state))
            print(f"[train] resumed from step {start}")
        except FileNotFoundError:
            pass

    losses = []
    for step in range(start, steps):
        tokens = pipeline.global_batch_at(step)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, {"tokens": tokens})
        loss = float(metrics["loss"])
        monitor.record(0, time.time() - t0)
        losses.append(loss)
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({time.time() - t0:.2f}s)", flush=True)
        if manager is not None and writer and (step + 1) % checkpoint_every == 0:
            manager.save(step + 1, (params, opt_state))
    if manager is not None and writer:
        manager.save(steps, (params, opt_state))
        manager.wait()
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-sized config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--quant-mode", default="bf16")
    ap.add_argument("--gemm-backend", default=None,
                    help="GEMM backend registry name (e.g. cuda_spoga_dequant, "
                         "cuda_spoga, cuda_deas); default: by the tensors' device")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the run (default: the card)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks (run under torchrun --nproc-per-node DP)")
    ap.add_argument("--grad-compression", action="store_true",
                    help="int8-compressed gradient all-reduce (with --dp > 1)")
    ap.add_argument("--backend", default=None, help="process-group backend (nccl, gloo)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    cfg = cfg.with_(quant_mode=args.quant_mode, gemm_backend=args.gemm_backend)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=5, total_steps=args.steps,
                       grad_compression=args.grad_compression,
                       fsdp=args.dp == 1, zero1=args.dp == 1)
    mesh = None
    if args.dp > 1:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_host_mesh

        backend = args.backend or ("nccl" if args.device in (None, "cuda") else "gloo")
        dist.init_process_group(backend)     # torchrun's environment
        if args.device in (None, "cuda"):
            args.device = f"cuda:{dist.get_rank()}"
        mesh = make_host_mesh(data=args.dp, backend=backend, device=args.device)
    _, losses = train_loop(cfg, tcfg, steps=args.steps, batch=args.batch,
                           seq=args.seq, ckpt_dir=args.ckpt_dir, device=args.device,
                           mesh=mesh)
    print(f"[train] first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
