"""End-to-end training driver (the port of ``repro/launch/train.py``).

Runs real steps on one device -- the card unless ``--device cpu`` --
with asynchronous checkpointing, resume from the latest checkpoint and
straggler monitoring:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --reduced --steps 20 --batch 8 --seq 128 --device cpu --ckpt-dir DIR

At an integer ``--quant-mode`` every projection runs the quantized GEMM
forward (on the card, the hand-written kernel) and the straight-through
backward.  ``train_loop(..., mesh=)`` trains on any ("data", "model")
mesh (``launch.steps``): the params sharded by ``TrainConfig.fsdp``
(``shard.shard_params``), the AdamW state by ``TrainConfig.zero1``
(``shard.shard_opt_state``), tensor-parallel over "model"; every rank
draws the same global batch and takes its slice.  Checkpoints are the
unsharded format, gathered by every rank and written by rank 0, and a
run resumes onto whatever mesh it is given (elastic restore).  On the
command line, ``--dp D --tp T`` under ``torchrun --nproc-per-node D*T``:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --dp 2 --tp 2

(``--grad-compression`` selects the replicated data-parallel step, the
one that compresses, with the int8 all-reduce).  Every arch trains at
``--tp`` > 1; on the CPU, gloo ranks:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch \
        deepseek-moe-16b --reduced --tp 2 --steps 2 --device cpu --backend gloo
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
from repro_torch.models.model import param_shapes
from repro_torch.optim.optimizers import adamw_init
from repro_torch.runtime import collectives
from repro_torch.runtime.fault_tolerance import StragglerMonitor
from repro_torch.runtime.sharding import opt_state_specs, param_specs
from repro_torch.shard.core import shard_opt_state, shard_params


def train_loop(cfg, tcfg: TrainConfig, *, steps: int, batch: int, seq: int,
               ckpt_dir: str | None = None, checkpoint_every: int = 10,
               log_every: int = 1, seed: int = 0, device=None, mesh=None):
    """Train ``steps`` steps from ``init_params(cfg, seed)`` on ``device``
    (default: the card), resuming from ``ckpt_dir``'s latest checkpoint
    when it has one.  ``mesh``: the sharded step on it (``batch`` is the
    global batch); the params and optimizer state are this rank's blocks,
    saved and resumed through the sharded checkpoint (see the module).
    Returns (final params, this rank's blocks on a mesh; losses of the
    steps run)."""
    dev = resolve_device(device)
    params = init_params(cfg, seed=seed, device=dev)
    opt_state = adamw_init(params, device=dev)
    pipeline = SyntheticTokenPipeline(cfg.vocab_size, seq, batch, seed=seed, device=str(dev))
    step_fn = make_train_step(cfg, tcfg, mesh=mesh)
    specs = None
    if mesh is not None and mesh.size > 1:
        p_specs = param_specs(params, mesh, cfg, fsdp=tcfg.fsdp)
        specs = (p_specs, opt_state_specs(opt_state, p_specs, mesh, tcfg.zero1))
        opt_state = shard_opt_state(opt_state, p_specs, mesh, tcfg.zero1, cfg=cfg)
        params = shard_params(params, mesh, cfg, fsdp=tcfg.fsdp)
    manager = None
    if ckpt_dir:
        manager = CheckpointManager(ckpt_dir, keep_n=2, async_save=True,
                                    mesh=mesh if specs is not None else None, cfg=cfg)
    monitor = StragglerMonitor(n_hosts=1)
    # one log for the run: rank 0 of the world
    log = mesh is None or collectives.world(mesh).rank == 0

    start = 0
    if manager is not None:
        try:
            like = (param_shapes(cfg), adamw_init(param_shapes(cfg), device="meta")) \
                if specs is not None else (params, opt_state)
            start, (params, opt_state), _ = manager.restore_latest(like, device=dev,
                                                                   specs=specs)
            if log:
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
        if log and step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({time.time() - t0:.2f}s)", flush=True)
        if manager is not None and (step + 1) % checkpoint_every == 0:
            manager.save(step + 1, (params, opt_state), specs=specs)
    if manager is not None:
        manager.save(steps, (params, opt_state), specs=specs)
        manager.wait()
    return params, losses


def main(argv=None):
    """The command line; returns the losses of the steps run."""
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
                    help="data-parallel ranks (run under torchrun --nproc-per-node DP*TP)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (run under torchrun --nproc-per-node DP*TP)")
    ap.add_argument("--grad-compression", action="store_true",
                    help="int8-compressed gradient all-reduce: the replicated data-parallel "
                         "step (no FSDP, no ZeRO-1; with --tp 1)")
    ap.add_argument("--backend", default=None, help="process-group backend (nccl, gloo)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    cfg = cfg.with_(quant_mode=args.quant_mode, gemm_backend=args.gemm_backend)
    # only the replicated data-parallel step compresses (launch.steps)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=5, total_steps=args.steps,
                       grad_compression=args.grad_compression,
                       fsdp=not args.grad_compression, zero1=not args.grad_compression)
    mesh = None
    if args.dp * args.tp > 1:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_host_mesh

        backend = args.backend or ("nccl" if args.device in (None, "cuda") else "gloo")
        # torchrun's environment, unless the caller's ranks already joined
        # one (launch.mesh.spawn)
        owned = not dist.is_initialized()
        if owned:
            dist.init_process_group(backend)
        if args.device in (None, "cuda"):
            args.device = f"cuda:{dist.get_rank()}"
        mesh = make_host_mesh(data=args.dp, model=args.tp, backend=backend,
                              device=args.device)
    _, losses = train_loop(cfg, tcfg, steps=args.steps, batch=args.batch,
                           seq=args.seq, ckpt_dir=args.ckpt_dir, device=args.device,
                           mesh=mesh)
    if mesh is None or collectives.world(mesh).rank == 0:
        print(f"[train] first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")
    if mesh is not None and owned:
        dist.destroy_process_group()
    return losses


if __name__ == "__main__":
    main()
