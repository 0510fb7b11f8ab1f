"""Serving CLI — a thin consumer of the ``repro_torch.api`` facade (the
port of ``repro/launch/serve.py``).

Every flag maps onto one field of the layered ``RuntimeConfig``; the CLI
builds it, hands it to ``LLM``, and drives the engine with a synthetic
staggered-arrival workload.  It runs on the card unless ``--device cpu``:

    python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --quant-mode int8_spoga --cache-mode paged --kv-cache-dtype int8 \\
        --requests 8 --slots 4 --prompt-len 128 --gen 32 --stagger 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --reduced --requests 8 --slots 4 --prompt-len 32 --gen 16 --device cpu

``--cache-mode paged`` serves from the global page pool (block tables,
optional ``--prefill-chunk`` chunked long-prompt admission, int8
byte-size pages via ``--kv-cache-dtype int8``, ``--paged-attn gather`` to
force the gather twin instead of the ``paged_attention`` kernel).
``--prefix-cache`` turns on the shared-prefix KV cache (pair it with
``--shared-prefix N`` to give the synthetic workload an N-token common
system prompt).  ``--batched-admission`` stacks same-bucket prompts into
one prefill dispatch; ``--admission`` picks the admission order;
``--defrag-threshold`` tunes (or ``-1`` disables) pool compaction;
``--spec K`` turns on speculative decoding (``--draft ngram|model``);
``--stream`` prints every token the moment it reaches the host.
``--gemm-backend NAME`` pins the GEMM backend (``cuda_spoga`` runs the
int32 kernel with the epilogue after it; default: by the tensors' device).

``--runtime SPEC`` sidesteps the per-knob flags: SPEC is a JSON file
(``RuntimeConfig.from_dict``) or a preset name (``list_presets()``), and
the quant/KV/scheduler flags are ignored in its favour; only the workload
flags, ``--reduced``, the observability flags and ``--tp`` still apply.

``--static`` (and the encoder-decoder and frontend archs, which the engine
does not admit) runs the lockstep baseline ``api.serve_batch`` instead.

Observability (``repro_torch/obs/``): ``--trace out.json`` (Chrome
trace-event JSON), ``--events out.jsonl`` (the scheduler decision log),
``--fence-spans``, ``--profile DIR`` (a ``torch.profiler`` trace of the
first ``--profile-steps`` engine steps, the ``StepProfiler``),
``--debug-invariants``, ``--metrics-port P`` (live ``/metrics``,
``/healthz``, ``/snapshot``), ``--watchdog`` (the numerics watchdog),
``--record DIR`` (the flight recorder; replay with ``python -m
repro_torch.launch.replay DIR``) and ``--deadline SEC``.  All off by
default.

``--tp N`` serves tensor-parallel over N ranks: run it under ``torchrun
--nproc-per-node N`` (rank r on ``cuda:r``, NCCL; gloo with ``--device
cpu``), or call :func:`main` inside ranks that ``launch.mesh.spawn``
started.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.api import (
    LLM,
    KVConfig,
    MeshConfig,
    ObsConfig,
    QuantRuntime,
    RuntimeConfig,
    SamplingDefaults,
    SchedulerConfig,
    SpecConfig,
    list_presets,
    load_runtime,
    serve_batch,
)
from repro_torch.configs import default_cache_len
from repro_torch.models.frontends import fake_audio_frames, fake_vision_embeds


def synthetic_workload(cfg, n_requests: int, prompt_len: int, gen: int,
                       stagger: int, seed: int = 0, shared_prefix: int = 0):
    """Mixed-length prompts/budgets around the nominal sizes, arriving every
    ``stagger`` engine steps — a deterministic stand-in for live traffic.
    ``shared_prefix`` prepends a common system prompt of that many tokens
    to every request (the workload the prefix cache accelerates)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, shared_prefix).tolist()
    arrivals = []
    for i in range(n_requests):
        plen = int(rng.integers(max(1, prompt_len // 2), prompt_len + 1))
        budget = int(rng.integers(max(1, gen // 2), gen + 1))
        prompt = prefix + rng.integers(0, cfg.vocab_size, plen).tolist()
        arrivals.append((i * stagger, prompt, budget))
    return arrivals


def _static_main(llm: LLM, args) -> None:
    """The lockstep baseline on a batch drawn from a ``torch.Generator``
    seeded with 0 (the frontends' stand-in embeddings from seed 0)."""
    cfg, params, dev = llm.config, llm.params, llm.device
    gen = torch.Generator(device=dev).manual_seed(0)
    if cfg.is_encoder_decoder:
        batch = {
            "src_embeds": fake_audio_frames(0, cfg, args.batch, args.prompt_len, dev),
            "tgt_tokens": torch.randint(0, cfg.vocab_size, (args.batch, 8), generator=gen,
                                        device=dev, dtype=torch.int32),
        }
    elif cfg.frontend is not None:
        batch = {"embeds": fake_vision_embeds(0, cfg, args.batch, args.prompt_len, dev)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                                         generator=gen, device=dev, dtype=torch.int32)}
    cache_len = default_cache_len(args.prompt_len, args.gen)
    tokens, stats = serve_batch(cfg, params, batch, cache_len=cache_len,
                                gen_tokens=args.gen)
    tps = args.batch * args.gen / stats["decode_s"]
    print(f"[serve] generated {tuple(tokens.shape)} tokens; prefill "
          f"{stats['prefill_s']:.2f}s, decode {stats['decode_s']:.2f}s ({tps:.1f} tok/s)")
    print("[serve] sample:", tokens[0][:12].tolist())


def _engine_main(llm: LLM, args) -> None:
    """Drive the engine over :func:`synthetic_workload` and print its
    report lines (``llm.metrics`` keeps the run's metrics)."""
    # workload hints anchor the 'auto' bucket ladder to the nominal prompt
    # length (auto_buckets(prompt_len))
    engine = llm.build_engine(args.prompt_len + args.shared_prefix, args.gen)
    if llm.metrics_server is not None:
        print(f"[obs] metrics server at {llm.metrics_server.url}/metrics "
              f"(also /healthz, /snapshot)")
    sampling = llm.runtime.sampling.to_params()
    if args.deadline is not None:
        sampling = dataclasses.replace(sampling, deadline_s=args.deadline)
    arrivals = [(s, p, g, sampling)
                for s, p, g in synthetic_workload(llm.config, args.requests,
                                                  args.prompt_len, args.gen,
                                                  args.stagger, args.seed,
                                                  args.shared_prefix)]
    on_token = (lambda req, tok: print(f"[stream] req {req.req_id}: {tok}",
                                       flush=True)) if args.stream else None
    m = engine.run(arrivals, on_token=on_token)
    print(m.format_report())
    if engine.paged:
        print(f"[engine] paged: peak {m.peak_running} concurrent lanes, "
              f"{m.peak_pages_used}/{m.pages_total} pages "
              f"(page_size {m.page_size}), {m.chunk_steps} prefill chunks, "
              f"{m.defrag_count} defrags")
    if engine.prefix is not None:
        print(f"[engine] prefix cache: {m.prefix_hits} hits / "
              f"{m.prefix_misses} misses, {m.prefix_hit_tokens} prompt "
              f"tokens reused, {m.prefix_cow_forks} CoW forks, "
              f"{m.prefix_evicted_pages} pages evicted, "
              f"{m.prefix_tree_pages} pages cached")
    if m.verify_dispatches:
        r = m.report()
        print(f"[engine] spec decode: {m.spec_accepted}/{m.spec_proposed} drafts "
              f"accepted (rate {r['acceptance_rate']:.2f}) across "
              f"{m.verify_dispatches} verify dispatches")
    if m.stacked_prefills:
        print(f"[engine] batched admission: {m.prefills} prefills in "
              f"{m.prefill_dispatches} dispatches ({m.stacked_prefills} stacked)")
    if m.deadline_hits or m.deadline_misses:
        r = m.report()
        print(f"[engine] SLO: {m.deadline_hits} hit / {m.deadline_misses} missed "
              f"deadlines (hit rate {r['deadline_hit_rate']:.2f}, "
              f"{m.deadline_late_admissions} already late at admission) | goodput "
              f"{r['goodput_tokens_per_s']:.1f} tok/s of {r['tokens_per_s']:.1f} total")
    if m.finished:
        first = min(m.finished, key=lambda r: r.req_id)
        print(f"[engine] sample (req {first.req_id}):", first.output_tokens[:12])
    if llm.obs.enabled:
        r = m.report()
        print(f"[obs] TTFT p50/p95/p99 {r['ttft_p50_s']*1e3:.1f}/"
              f"{r['ttft_p95_s']*1e3:.1f}/{r['ttft_p99_s']*1e3:.1f} ms | "
              f"per-token p50/p99 {r['per_token_p50_s']*1e3:.2f}/"
              f"{r['per_token_p99_s']*1e3:.2f} ms | "
              f"queue wait p99 {r['queue_wait_p99_s']*1e3:.1f} ms | "
              f"{len(llm.obs.events)} scheduler events, "
              f"{len(llm.obs.tracer.events)} spans")
    if llm.runtime.obs.watchdog:
        from repro_torch.obs import watchdog

        sat = watchdog.saturation_report()
        if sat:
            worst = sorted(sat.items(), key=lambda kv: -kv[1])[:3]
            rendered = ", ".join(f"{k} {v:.4f}" for k, v in worst)
            print(f"[obs] watchdog: worst at-rail occupancy {rendered}")
    for path in llm.obs.save():
        print(f"[obs] wrote {path}")
    llm.close()
    if llm.obs.recorder is not None:
        print(f"[obs] flight recorder: bundle at {llm.obs.recorder.path} "
              f"(replay with `python -m repro_torch.launch.replay "
              f"{llm.obs.recorder.path}`)")


def _obs_from_args(args) -> ObsConfig:
    return ObsConfig(
        trace=args.trace,
        events=args.events,
        fence_spans=args.fence_spans,
        profile_dir=args.profile,
        profile_steps=args.profile_steps,
        debug_invariants=args.debug_invariants,
        metrics_port=args.metrics_port,
        events_max_mb=args.events_max_mb,
        watchdog=args.watchdog,
        record_path=args.record,
    )


def _runtime_from_args(args) -> RuntimeConfig:
    """Flags -> the layered RuntimeConfig (the CLI's only job)."""
    return RuntimeConfig(
        quant=QuantRuntime(mode=args.quant_mode, gemm_backend=args.gemm_backend),
        kv=KVConfig(
            mode=args.cache_mode,
            dtype=args.kv_cache_dtype,
            cache_len=default_cache_len(args.prompt_len + args.shared_prefix,
                                        args.gen),
            page_size=args.page_size,
            n_pages=args.pages,
            paged_attn_impl=args.paged_attn,
            prefix_cache=args.prefix_cache,
        ),
        scheduler=SchedulerConfig(
            n_slots=args.slots,
            max_prefills_per_step=args.max_prefills,
            prefill_buckets=None if args.no_buckets else "auto",
            prefill_chunk=args.prefill_chunk,
            batched_admission=args.batched_admission,
            admission=args.admission,
            eviction=args.eviction,
            defrag_threshold=(None if args.defrag_threshold < 0
                              else args.defrag_threshold),
        ),
        sampling=SamplingDefaults(
            greedy=args.temperature == 0.0,
            temperature=args.temperature or 1.0,
            top_k=args.top_k,
            seed=args.seed,
        ),
        spec=SpecConfig(
            enabled=args.spec > 0,
            k=args.spec or 4,
            drafter=args.draft,
            draft_arch=args.draft_arch,
        ),
        obs=_obs_from_args(args),
        mesh=MeshConfig(tp=args.tp),
        max_new_tokens=args.gen,
        reduced=args.reduced,
    )


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the run (default: the card)")
    ap.add_argument("--static", action="store_true",
                    help="lockstep static-batch baseline instead of the engine")
    ap.add_argument("--batch", type=int, default=4, help="static path: batch size")
    ap.add_argument("--requests", type=int, default=8, help="engine: request count")
    ap.add_argument("--slots", type=int, default=4, help="engine: KV-cache lanes")
    ap.add_argument("--stagger", type=int, default=2,
                    help="engine: steps between request arrivals")
    ap.add_argument("--max-prefills", type=int, default=1,
                    help="engine: admission dispatches interleaved per step")
    ap.add_argument("--no-buckets", action="store_true",
                    help="engine: exact-length prefill")
    ap.add_argument("--batched-admission", action="store_true",
                    help="engine: stack same-bucket prompts into one prefill "
                         "dispatch (slot and paged modes)")
    ap.add_argument("--admission", default="fifo",
                    choices=["fifo", "priority", "prefix-aware", "deadline"],
                    help="engine: admission ordering (priority = "
                         "Request.priority with starvation-free aging; "
                         "prefix-aware = requests sharing a hot cached "
                         "prefix admit back-to-back; deadline = FIFO that "
                         "also sheds already-late requests at ingress)")
    ap.add_argument("--eviction", default="budget",
                    choices=["budget", "deadline-preempt"],
                    help="engine: eviction policy (deadline-preempt = "
                         "budget/EOS plus SLO preemption of lanes whose "
                         "request already missed its deadline while queued "
                         "work can still hit)")
    ap.add_argument("--spec", type=int, default=0, metavar="K",
                    help="engine: speculative decoding with K drafted tokens "
                         "per verify dispatch (0 = off; greedy lanes only)")
    ap.add_argument("--draft", default="ngram", choices=["ngram", "model"],
                    help="spec drafter: model-free prompt-lookup n-grams or "
                         "a small draft model (repro_torch/spec/)")
    ap.add_argument("--draft-arch", default=None,
                    help="spec: draft model architecture (default: a "
                         "truncated copy of the target)")
    ap.add_argument("--runtime", default=None,
                    help="RuntimeConfig source: a JSON file (from_dict) or a "
                         f"preset name {list_presets()}; overrides the "
                         "quant/KV/scheduler flags")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples")
    ap.add_argument("--top-k", type=int, default=0, help="0 = no truncation")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant-mode", default="bf16")
    ap.add_argument("--gemm-backend", default=None,
                    help="GEMM backend registry name (e.g. cuda_spoga_dequant, "
                         "cuda_spoga, cuda_deas); default: by the tensors' device")
    ap.add_argument("--kv-cache-dtype", default="bf16", choices=["bf16", "int8"],
                    help="int8: SPOGA-style byte-size KV cache (+scales)")
    ap.add_argument("--cache-mode", default="slot", choices=["slot", "paged"],
                    help="paged: global page pool + block tables (repro_torch/paging)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged: tokens per KV page")
    ap.add_argument("--pages", type=int, default=None,
                    help="paged: pool size in pages (default: slot-equivalent budget)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="paged: admit long prompts in chunks of this many "
                         "tokens (multiple of page-size), interleaved with decode")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged: shared-prefix KV cache (radix tree + "
                         "copy-on-write pages; repro_torch/prefix/)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="workload: prepend a common system prompt of this "
                         "many tokens to every request")
    ap.add_argument("--defrag-threshold", type=float, default=0.5,
                    help="paged: compact the pool when fragmentation crosses "
                         "this ratio (-1 disables)")
    ap.add_argument("--paged-attn", default=None, choices=["gather"],
                    help="paged attention impl (default: the kernel on the "
                         "card, the gather twin on the CPU)")
    ap.add_argument("--stream", action="store_true",
                    help="engine: print every token as it reaches the host")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="obs: write the engine span timeline as Chrome "
                         "trace-event JSON (load in Perfetto)")
    ap.add_argument("--events", default=None, metavar="OUT.jsonl",
                    help="obs: write the scheduler decision log as JSONL")
    ap.add_argument("--fence-spans", action="store_true",
                    help="obs: block spans on the device so they measure "
                         "device work (serializes the decode pipeline)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="obs: torch.profiler trace of the first "
                         "--profile-steps engine steps, written under DIR")
    ap.add_argument("--profile-steps", type=int, default=20,
                    help="obs: engine steps the --profile window covers")
    ap.add_argument("--debug-invariants", action="store_true",
                    help="obs: check page-pool invariants after every step")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="obs: serve live /metrics (Prometheus text "
                         "exposition) + /healthz + /snapshot on this port "
                         "(0 = ephemeral; URL printed at startup)")
    ap.add_argument("--events-max-mb", type=float, default=64.0,
                    help="obs: rotate the --events JSONL stream past this size")
    ap.add_argument("--record", default=None, metavar="DIR",
                    help="obs: arm the flight recorder and capture the run "
                         "into DIR; replay with "
                         "`python -m repro_torch.launch.replay DIR`")
    ap.add_argument("--watchdog", action="store_true",
                    help="obs: numerics watchdog: per-layer saturation/clip "
                         "counters and amax/quant-error histograms from "
                         "inside the quantized GEMM pipeline (output-invisible)")
    ap.add_argument("--deadline", type=float, default=None, metavar="SEC",
                    help="SLO: per-request deadline in seconds from submit; "
                         "finished-late requests count as misses and drop "
                         "out of goodput")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: shard params, attention "
                         "heads, experts and the paged KV pool over N ranks "
                         "(run under torchrun --nproc-per-node N)")
    return ap


def main(argv=None) -> LLM:
    """Parse ``argv`` (default ``sys.argv[1:]``), serve, and return the
    ``LLM`` that served (``llm.metrics`` holds an engine run's metrics)."""
    args = _parser().parse_args(argv)

    runtime = (load_runtime(args.runtime) if args.runtime
               else _runtime_from_args(args))
    if args.runtime:
        # obs + reduced are session flags, not deployment profile state:
        # they apply on top of whatever --runtime loaded
        if args.reduced:
            runtime = dataclasses.replace(runtime, reduced=True)
        obs = _obs_from_args(args)
        if obs != ObsConfig():
            runtime = dataclasses.replace(runtime, obs=obs)
        if args.tp != 1:
            runtime = dataclasses.replace(runtime, mesh=MeshConfig(tp=args.tp))
    launched = False
    if runtime.mesh.enabled and runtime.mesh.tp * runtime.mesh.dp > 1:
        import torch.distributed as dist

        if not dist.is_initialized():
            # torchrun's environment; ranks from launch.mesh.spawn arrive
            # with their process group already up
            on_card = args.device in (None, "cuda")
            dist.init_process_group("nccl" if on_card else "gloo")
            launched = True
            if on_card:
                args.device = f"cuda:{dist.get_rank()}"
                torch.cuda.set_device(args.device)
    llm = LLM(arch=args.arch, runtime=runtime, device=args.device)
    cfg = llm.config
    engine_capable = not cfg.is_encoder_decoder and cfg.frontend is None
    if args.static or not engine_capable:
        if not engine_capable and not args.static:
            print(f"[serve] {cfg.name}: enc-dec/frontend arch — static path")
        _static_main(llm, args)
    else:
        _engine_main(llm, args)
    if launched:
        dist.destroy_process_group()
    return llm


if __name__ == "__main__":
    main()
