"""Multi-pod dry run (the port of ``repro/launch/dryrun.py``): one rank's
program of every (arch x shape) cell on the production meshes, and its
memory, work and collectives, for the roofline analysis.

The reference lowers and compiles each cell with XLA on 256 or 512
placeholder host devices and reads ``memory_analysis()``,
``cost_analysis()`` and the collectives of the HLO.  The port has no XLA
and no partitioner: it runs SPMD, each rank its own program.  Its
counterpart runs rank 0's program (``launch.steps.lower_cell`` on a
``launch.mesh.DryMesh``) once on ``"meta"`` tensors: no card, no process
group, nothing allocated, so a full-size cell is cheap.  The collectives
return placeholders and record their result buffers; the counters of
``runtime.counters`` take the operations (``torch.utils.flop_counter``'s
formulas plus each kernel's 2*M*N*K), the bytes (each aten op's inputs
plus outputs, unfused -- XLA counts a fused region's operands once) and
the peak of live storage (``temp_bytes``).  A cell whose tensor
parallelism ``shard.local_config`` refuses (tp=16 on an arch whose heads
it cannot split) is recorded as failing, with that ``ValueError``, as the
reference's ``main`` records a failing cell.

``--device cuda`` runs the same rank's program for real on the card, on
inputs made at the rank's local shapes from a seeded generator (never the
whole tree), with the same placeholder collectives: its kernel launches,
its collectives, its argument bytes, its peak memory above its start and
its step time go into the record's ``card``.  A kernel launched on the
card passes no counter (the extension call is no aten op), so the card
run's own operations and bytes leave every GEMM out: the record's
``memory``, ``cost``, ``collectives`` and ``kernels`` are those of a meta
run of the same cell, and ``counted_on`` says so.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-moe-16b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import deas_gemm, spoga_gemm, spoga_gemm_dequant
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import lower_cell

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# the kernel wrappers a cell can reach: name -> (module, its launch counter)
KERNELS = {"spoga_gemm_dequant": (spoga_gemm_dequant, "LAUNCHES"),
           "spoga_gemm": (spoga_gemm, "LAUNCHES"),
           "deas_gemm": (deas_gemm, "CALLS")}


def collective_stats(calls) -> dict:
    """Sum result-buffer bytes per collective kind over recorded
    ``(kind, dtype, shape)`` calls (``CompiledCell.collectives``), into the
    reference's dict: each kind's ``count`` and ``bytes``, and
    ``total_bytes``."""
    stats = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
    for kind, dtype, shape in calls:
        n = 1
        for d in shape:
            n *= d
        stats[kind]["count"] += 1
        stats[kind]["bytes"] += n * dtype.itemsize
    stats["total_bytes"] = sum(v["bytes"] for k, v in stats.items() if k in _COLLECTIVES)
    return stats


def calibrated_costs(cfg, shape, mesh, tcfg) -> dict | None:
    """Operations, bytes and collectives extrapolated from 1- and 2-period
    runs of the cell, as the reference extrapolates its unrolled lowers.

    XLA counts a while-loop body once, so the reference's scanned stack
    under-reports by about ``n_layers`` and the extrapolation corrects it.
    The port runs eagerly and counts every layer at full depth, so here
    the extrapolation is a check of linearity, not a correction.  It
    equals the full-depth counts where the depth is whole periods and a
    period's cost does not change with depth: every prefill and decode
    count, and a train step's operations and collectives.  A train step's
    bytes grow faster (each period's slice of a stacked leaf takes its
    gradient through ``select_backward``, which writes the whole stack),
    so there it falls short; a stack with tail layers (recurrentgemma-9b's
    38 = 12 periods of 3 + 2) is scaled by the tail's share of a period,
    as the reference scales it, and an encoder-decoder's encoder with the
    periods, linear only where its depth divides evenly."""
    from repro_torch.models.transformer import layer_layout

    lead, n_periods, tail = layer_layout(cfg)
    period = cfg.pattern_period
    if n_periods < 2:
        return None

    def costs_at(k: int):
        kw = dict(n_layers=lead + k * period, scan_unroll=True)
        if cfg.is_encoder_decoder:
            kw["n_encoder_layers"] = max(1, k * cfg.n_encoder_layers // n_periods)
        compiled = lower_cell(cfg.with_(**kw), shape, mesh, tcfg).compile()
        cost = compiled.cost_analysis()
        return (cost["flops"], cost["bytes accessed"], collective_stats(compiled.collectives))

    f1, b1, c1 = costs_at(1)
    f2, b2, c2 = costs_at(2)
    scale = (n_periods - 1) + len(tail) / period

    def extrap(v1, v2):
        # clamp, as the reference does: the extrapolation never falls below
        # the single-period run
        return max(v1 + (v2 - v1) * scale, v1, 0.0)

    coll = {}
    for kind in _COLLECTIVES:
        coll[kind] = {
            "count": int(round(extrap(c1[kind]["count"], c2[kind]["count"]))),
            "bytes": int(round(extrap(c1[kind]["bytes"], c2[kind]["bytes"]))),
        }
    coll["total_bytes"] = sum(v["bytes"] for k, v in coll.items() if k in _COLLECTIVES)
    return {
        "flops_per_device": extrap(f1, f2),
        "bytes_accessed_per_device": extrap(b1, b2),
        "collectives": coll,
        "periods": n_periods,
    }


# Gradient-accumulation defaults for train_4k (the reference's, chosen for
# its devices' memory)
TRAIN_MICROBATCHES = {
    "mistral-large-123b": 8,
    "granite-moe-3b-a800m": 4,
    "deepseek-moe-16b": 4,
    "recurrentgemma-9b": 2,
}


def kernel_counts() -> dict:
    """name -> (launches, plain calls, meta calls) of each kernel wrapper."""
    return {name: (getattr(mod, launched), mod.PLAIN_CALLS, mod.META_CALLS)
            for name, (mod, launched) in KERNELS.items()}


def _card_run(lowered, start: int) -> dict:
    """Run a rank's program on the card (its inputs already there): once
    under the counters, for its launches, collectives and the peak memory
    above ``start`` (the inputs are part of it), then once more, timed.
    Returns the record's ``card`` entry."""
    dev = lowered.mesh.device
    torch.cuda.synchronize(dev)
    before = kernel_counts()
    compiled = lowered.compile()
    torch.cuda.synchronize(dev)
    after = kernel_counts()
    card = {
        "name": torch.cuda.get_device_name(dev),
        "launches": {k: after[k][0] - before[k][0] for k in KERNELS},
        "plain_calls": {k: after[k][1] - before[k][1] for k in KERNELS},
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev) - start,
        "argument_bytes": int(compiled.memory_analysis().argument_size_in_bytes),
        "collectives": collective_stats(compiled.collectives),
    }
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    lowered.fn(**lowered.inputs)
    t1.record()
    t1.synchronize()
    card["step_ms"] = t0.elapsed_time(t1)
    return card


def run_cell(arch: str, shape_name: str, multi_pod: bool, quant_mode: str,
             zero1: bool = True, fsdp: bool = True, microbatches: int = 1,
             calibrate: bool = True, remat_policy: str = "nothing",
             kv_cache_dtype: str = "bf16", grad_reduce_dtype: str = "f32",
             gemm_backend: str | None = None,
             extra_tags: dict | None = None, device: str = "meta") -> dict:
    """One cell's record, with the reference's keys: its tags, ``lower_s``
    (building the rank's program and inputs), ``compile_s`` (running it
    once), ``memory``, ``hbm_per_device_gib``, ``cost``, ``collectives``
    (and ``cost_cal`` / ``collectives_cal`` with ``calibrate``), ``ok``;
    plus ``kernels`` (each kernel's calls in the run) and ``counted_on``
    (the device of the run they were counted in).  A cell that
    ``shard.local_config`` refuses comes back ``{"ok": False, "error":
    ...}``.  ``device="cuda"``: the program runs on the card, the record
    gains ``card``, and the counts are a meta run's (see the module
    docstring)."""
    cfg = get_config(arch).with_(quant_mode=quant_mode,
                                 remat_policy=remat_policy,
                                 kv_cache_dtype=kv_cache_dtype,
                                 gemm_backend=gemm_backend)
    shape = SHAPES[shape_name]
    if device != "meta" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} needs a CUDA card; none is available")
    mesh = make_production_mesh(multi_pod=multi_pod, dry=True, device=device)
    tcfg = TrainConfig(zero1=zero1, fsdp=fsdp, microbatches=microbatches,
                       grad_reduce_dtype=grad_reduce_dtype)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": 512 if multi_pod else 256,
        "quant_mode": quant_mode,
        "gemm_backend": gemm_backend,
        "zero1": zero1,
        "fsdp": fsdp,
        "microbatches": microbatches,
        "remat_policy": remat_policy,
        "kv_cache_dtype": kv_cache_dtype,
        "grad_reduce_dtype": grad_reduce_dtype,
        "device": device,
        **(extra_tags or {}),
    }
    if device != "meta":
        torch.cuda.reset_peak_memory_stats(mesh.device)
        start = torch.cuda.memory_allocated(mesh.device)
    t0 = time.time()
    try:
        lowered = lower_cell(cfg, shape, mesh, tcfg)
    except ValueError as e:
        return {**rec, "ok": False, "error": f"{type(e).__name__}: {e}"}
    rec["lower_s"] = round(time.time() - t0, 2)
    t0 = time.time()
    if device == "meta":
        compiled = lowered.compile()
    else:
        rec["card"] = _card_run(lowered, start)
        del lowered
    rec["compile_s"] = round(time.time() - t0, 2)
    if device != "meta":
        compiled = lower_cell(cfg, shape, make_production_mesh(multi_pod=multi_pod, dry=True),
                              tcfg).compile()
    rec["counted_on"] = "meta"

    mem = compiled.memory_analysis()
    rec["memory"] = {
        "argument_bytes": int(mem.argument_size_in_bytes),
        "output_bytes": int(mem.output_size_in_bytes),
        "temp_bytes": int(mem.temp_size_in_bytes),
        "alias_bytes": int(mem.alias_size_in_bytes),
        "code_bytes": int(mem.generated_code_size_in_bytes),
    }
    rec["hbm_per_device_gib"] = round(
        (mem.argument_size_in_bytes + mem.output_size_in_bytes
         + mem.temp_size_in_bytes - mem.alias_size_in_bytes) / 2**30, 3
    )
    cost = compiled.cost_analysis()
    rec["cost"] = {
        "flops_per_device": float(cost.get("flops", -1)),
        "bytes_accessed_per_device": float(cost.get("bytes accessed", -1)),
    }
    rec["collectives"] = collective_stats(compiled.collectives)
    rec["kernels"] = dict(compiled.counts.kernels)
    if calibrate:
        try:
            cal = calibrated_costs(cfg, shape, mesh, tcfg)
            if cal is not None:
                rec["cost_cal"] = {
                    "flops_per_device": cal["flops_per_device"],
                    "bytes_accessed_per_device": cal["bytes_accessed_per_device"],
                }
                rec["collectives_cal"] = cal["collectives"]
        except Exception as e:  # noqa: BLE001 -- calibration is best-effort
            rec["cal_error"] = f"{type(e).__name__}: {e}"
    rec["ok"] = True
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--quant-mode", default="bf16")
    ap.add_argument("--gemm-backend", default=None,
                    help="GEMM backend registry name; default auto-selection")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-calibrate", action="store_true",
                    help="skip the 1- and 2-period calibration runs")
    ap.add_argument("--all", action="store_true", help="run every assigned cell")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"],
                    help="meta: count without allocating (default); cuda: run rank 0's "
                         "program on the card")
    args = ap.parse_args(argv)

    if args.all:
        todo = [(a, s) for a, s, skipped in cells() if not skipped]
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all)"
        todo = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    done = set()
    if args.out and args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("ok"):
                        done.add((r["arch"], r["shape"], r["mesh"], r["quant_mode"]))
                except json.JSONDecodeError:
                    pass

    n_fail = 0
    for arch, shape_name in todo:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            key = (arch, shape_name, mesh_name, args.quant_mode)
            if key in done:
                print(f"[skip] {key}")
                continue
            print(f"[dryrun] {arch} x {shape_name} on {mesh_name} ({args.quant_mode})",
                  flush=True)
            try:
                mb = args.microbatches
                if mb == 1 and shape_name == "train_4k":
                    mb = TRAIN_MICROBATCHES.get(arch, 1)
                rec = run_cell(arch, shape_name, mp, args.quant_mode,
                               zero1=not args.no_zero1, fsdp=not args.no_fsdp,
                               microbatches=mb,
                               calibrate=not args.no_calibrate,
                               gemm_backend=args.gemm_backend, device=args.device)
                if rec["ok"]:
                    print(f"  ok: hbm/dev={rec.get('hbm_per_device_gib')}GiB "
                          f"flops/dev={rec['cost']['flops_per_device']:.3e} "
                          f"coll={rec['collectives']['total_bytes']:.3e}B "
                          f"(lower {rec['lower_s']}s compile {rec['compile_s']}s)",
                          flush=True)
                else:
                    n_fail += 1
                    print(f"  FAIL: {rec['error']}", flush=True)
            except Exception as e:  # noqa: BLE001 -- a failing cell is a bug to record
                rec = {
                    "arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "quant_mode": args.quant_mode, "ok": False,
                    "error": f"{type(e).__name__}: {e}",
                }
                n_fail += 1
                print(f"  FAIL: {rec['error']}", flush=True)
                traceback.print_exc()
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    print(f"dry-run complete, failures: {n_fail}", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
