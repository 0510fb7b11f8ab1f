"""Drive the PyTorch port on one NVIDIA GPU and hold every kernel to its plain version.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. card: name and power limit from nvidia-smi; build the CUDA kernels from
   ``src/repro_torch/csrc/`` (one nvcc per source, all started together);
2. GEMM kernels: ``spoga_gemm_dequant`` and the int32 ``spoga_gemm``
   against their plain versions, bitwise, at the main path's shapes for
   W8A8, w4a8 and w16a16 (``spoga_gemm_dequant`` also at M=512, a
   chunked-prefill step's projections, timed at W8A8); the DEAS kernels (``nibble_gemm`` x4 +
   ``deas_combine``) at W8A8 against their plain versions and
   ``spoga_gemm``, 5 launches per call, and ``deas_combine`` alone over
   the int32 range, aligned and misaligned; each time the profiler's device
   time (the event time of back-to-back calls beside it), against the bound
   and ``torch._int_mm``; ``deas_combine`` warm and cold, each in one
   profiler session with a no-op kernel on its grid; both GEMM kernels at
   a tp=2 rank's projection shapes of minicpm3-4b, recurrentgemma-9b and
   llava-next-mistral-7b (``TPA_KN``, M=4), bitwise and timed;
3. paged-attention kernel: bf16 and int8 pools against the plain version at
   rtol/atol 2e-5, stale rows poisoned, two calls bitwise equal, at (a) the
   main path's decode shape and (b) an 8K-token table (B=16, 8 KV heads,
   lengths 1,024-8,192 from a seed, pools read cold), and at the decode
   layouts of phase 9's MoE archs (deepseek 16 KV heads G=1 D=128, granite
   8 KV heads G=3 D=64, the main path's lengths); device and event
   times beside the bound and ``scaled_dot_product_attention`` on the
   gathered view;
4. main path: full-width llama3.2-1b, ``int8_spoga``, int8 paged KV, random
   weights from seed 0, served by ``ServingEngine`` (8 staggered requests);
   launch counts of both kernels are read around the run, the plain
   versions must not run; every request again on a 1-slot engine; then a
   4-request pass over a bf16 pool; profiles of a few decode steps (device
   time by kernel, one ``paged_attention`` kernel per layer and step) at
   64- and 2,048-token prompts;
   4b. slot mode: phase 4's traffic through slot-mode ``ServingEngine``s
   (int8, then bf16 KV), every projection on ``spoga_gemm_dequant`` (112
   launches a decode step), no ``paged_attention`` and no plain version;
   tok/s, TTFT and decode step beside the paged run's; a profiled slot
   decode step; then slot against paged inside the port: the same prompts
   prefilled once, 8 teacher-forced decode steps over a slot and a paged
   int8 cache, on phase 6's 2-layer bf16-GEMM model the logits within
   tolerance at every step; at ``int8_spoga`` (2 layers, full depth) the
   difference printed;
5. the paper's dataflows through the ``LLM`` facade: the same weights (the
   first ``DATAFLOW_LAYERS`` (2) of phase 4's 16 layers) and
   prompts served by ``int8_spoga`` fused, ``int8_spoga`` with
   ``gemm_backend="cuda_spoga"``, ``int8_deas`` and ``int8_direct``, in
   two rounds of opposite order, each run's kernel counts read around it;
   the greedy streams must be identical; tok/s, decode step and TTFT per
   dataflow; decode-step profiles of the DEAS and direct paths;
   5b. a 16,384-token full-width prefill at ``int8_spoga`` into an int8
   cache (finite logits, time, peak memory), and ``multihead_attention``
   at that length: rows on and beside its chunk edges against the same
   rows computed alone; then ``LLM("llama3.2-1b").generate`` with the
   default runtime (bf16 GEMMs, slot bf16 KV), no kernel launched;
6. card against CPU: a 2-layer full-width model, the same weights on both,
   one prefill: the first greedy token equal, the logits within tolerance;
   then a 1,000-token paged decode over int8 KV, 4 steps fed the CPU's
   tokens, the logits within tolerance at every step;
7. engine features, full-width ``int8_spoga`` over int8 paged KV, the
   first ``FEATURE_LAYERS`` (2) of llama's 16 layers (runs
   between phases 5b and 6): (a) phase 4's weights (those layers) saved with
   ``save_checkpoint`` and loaded by ``LLM(checkpoint_dir=)``, every tensor
   equal; (b) 2 prompts of 2,048-4,096 tokens then 8 short ones, chunked
   at 512 tokens and again unchunked (every request finished, the chunk
   steps counted, the short requests' TTFT printed); (c) 8 same-bucket
   prompts stacked into shared prefills, against unstacked; (d) defrag at
   threshold 0.05 against off, greedy streams bitwise equal; each run's
   kernel counts read around it; then chunked against one-shot prefill
   and stacked against batch=1 on phase 6's 2-layer bf16 model (logits
   within tolerance; greedy equal except on near-tie rows, whose top-2
   margin is at most ``NEAR_TIE_ULPS`` bf16 ulps) and at full width
   (printed);
8. presets, the prefix cache, speculative decoding and stochastic sampling,
   full-width ``int8_spoga`` over int8 paged KV, phase 7's model and
   weights (``FEATURE_LAYERS`` layers), 4 lanes, pages of 16 (runs after
   phase 7): (a) ``int8-byte-serving``
   written with ``to_dict`` to JSON and loaded back with ``load_runtime``,
   then ``LLM(runtime=load_runtime(...), checkpoint_dir=)`` on phase 7
   (a)'s checkpoint serves phase 4's prompts; (b) 9 requests over a
   1,024-token shared prefix (the last a full-prompt hit) with the prefix
   cache on and off at 128-token chunks, greedy streams bitwise equal, at
   least 7 hits and a CoW fork; (c) phase 4's traffic with ``k=4``
   speculation, n-gram, draft-model, oracle and adversarial drafters,
   against speculation off (streams equal, the oracle accepts every draft,
   the adversary none), then (b)'s traffic with the prefix cache and the
   n-gram drafter, and slot-mode speculation (printed); (d) a stochastic
   request alone and beside neighbours (the same stream), ``top_k=1`` the
   greedy stream up to the first row with an exact top-2 tie (where it
   may draw either; the margin printed), a mixed batch never
   speculating; (e) a verify step's
   device time by kernel group beside a decode step's, ``spoga_gemm_dequant``
   at the window's M=20 and ``paged_attention`` at 20 lanes of 4 repeated
   tables (rows bitwise equal to the decode calls); (b') chunked prefill
   while 4 short requests decode, at 512-token chunks and unchunked (the
   longest gap between two tokens of a short request printed); every run's
   kernel launches counted exactly, a verify dispatch as one decode step;
9. the attention-family archs at full width (runs last), random weights
   from ``init_params(seed=0)``, phase 4's traffic, 4 lanes, pages of 16:
   (a) minicpm3-4b (MLA), 2 of its 62 layers at full width,
   at ``int8_spoga`` paged (16 ``spoga_gemm_dequant``
   launches a decode or verify step, 20 a prefill dispatch or chunk step,
   no ``paged_attention``: paged MLA attends the gathered latent pages in
   torch), ``LLM("minicpm3-4b")`` with the default runtime (no kernel),
   512-token chunks against one-shot on phase 7 (b)'s two long prompts,
   the prefix cache on against off on phase 8 (b)'s traffic (bitwise),
   n-gram speculation against off; (b) deepseek-moe-16b, 4 of its 28
   layers at full width (1 dense + 3 MoE; 8 in PRs 20-22), over int8 paged
   KV (28 GEMM launches and 4 ``paged_attention`` a decode step), the
   engine's ``ValueError`` for chunking, the prefix cache and speculation,
   peak memory and a decode-step profile split into kernels, the grouped
   expert product, routing and attention; (c) granite-moe-3b-a800m, 4 of
   its 32 layers, over bf16 paged KV on 4 requests (16 and 4
   a step); (d) 2 layers of each
   on the card against the CPU, bf16 GEMMs and ``int8_spoga``, and the
   grouped expert product's int32 accumulators bitwise; (e)
   ``spoga_gemm_dequant`` bitwise against its plain version at every
   (M, K, N) that (a)-(c) gave it and at M=4, 20, 128 and 512 of every
   projection shape, timed at M=4 and M=128;
10. the recurrent archs at full width (after phase 9), random weights from
   ``init_params(seed=0)``, ``int8_spoga``, 4 lanes, pages of 16, exact-length
   prefill: (a) recurrentgemma-9b (RG-LRU cells and local attention over
   2,048-row rings), 8 of its 38 layers (2 periods and the 2-layer tail,
   since PR 23), on phase 4's traffic, paged over int8 KV and again slot
   (streams equal), then two prompts of 2,100 and 3,000 tokens with 32 new
   tokens each (the rings wrap in the prefill's roll and in decode); every
   run's launches exact (62 ``spoga_gemm_dequant`` a decode step at 8 layers, no
   ``paged_attention``: the rings are per lane and attended in torch), peak
   memory and tok/s, a decode-step profile split into GEMM kernels, weight
   quantization, ring attention and scan/elementwise work, the engine's
   ``ValueError``s; (b) xlstm-125m (mLSTM and sLSTM cells; ``XLSTM_LAYERS``,
   4 of its 12 layers) paged and slot (23 a step), a
   decode-step profile, 256-token chunks against one-shot on
   512- and 768-token prompts (agreement printed, completion and launches
   gated),
   ``LLM(config=)`` with the default runtime, its ``ValueError``s;
   (c) xlstm-125m through the four dataflows via ``LLM``, greedy streams
   identical, each run's launches exact; (d) 3 layers of recurrentgemma and
   4 of xlstm on the card against the CPU, bf16 and ``int8_spoga``; (e)
   ``spoga_gemm_dequant`` bitwise against its plain version at every
   (M, K, N) that (a)-(c) gave it (N=4 included) and at M=4, 20, 128, 512,
   timed at M=4 and M=128;
11. the encoder-decoder and frontend archs at full width, depth cut since
   PR 23 (after phase 10), random weights from ``init_params(seed=0)``, through
   ``api.serve_batch`` at ``int8_spoga`` (the engine refuses them, as the
   reference's does), 4 rows, 32 new tokens: (a) seamless-m4t-large-v2
   (4 + 4 of its 24 + 24 layers) from 128 ``fake_audio_frames``
   and 8 target tokens, 72 ``spoga_gemm_dequant`` launches a prefill (the
   encoder's 7 a layer, each decoder layer's cross K/V once, its 7 and the
   cross q and o) and 36 a decode step; (b) llava-next-mistral-7b (4 of its
   32 layers) from 576 ``fake_vision_embeds`` (one 336-px
   anyres tile), 28 a prefill and a decode step; every count exact, read around a prefill alone and the
   whole ``serve_batch``, no plain version; wall time, peak memory and a
   decode-step split per model; (c) 2 layers of llava and 2 + 2 of
   seamless on the card against the CPU, the same weights and embeddings,
   one prefill and 4 decode steps fed the CPU's tokens, bf16 GEMMs and
   ``int8_spoga``; (d) ``spoga_gemm_dequant`` bitwise against its plain
   version at every (M, K, N) that (a)-(b) gave it and at M=4, 20, 128,
   512, timed at M=4 and M=128; (e) ``ServingEngine.stream`` of one
   request to full-width llama3.2-1b through ``LLM``'s engine, the tokens
   ``LLM.generate`` gave, launches exact; (f) ``layers.mlp`` and
   ``layers.layernorm`` at d 2048 on the card against the CPU, the int32
   accumulators of the MLP's ``int8_spoga`` projections bitwise;
12. observability on the main path (after phase 11): phase 4's weights
   (their first ``OBS_LAYERS`` (4) layers in (a)-(d), all 16 in (e)) and
   traffic, ``int8_spoga``, int8 paged KV, every run's launches exact
   through ``_counted``: (a) spans and events off against on (fenced
   spans, trace and event sinks), greedy streams bitwise equal, the event
   kinds; the mean fenced ``decode`` span of 4 busy lanes against the
   profiler's device time a step (not shorter); (b) the numerics watchdog
   on against off: streams bitwise, the ``spoga_gemm_dequant`` launches a
   step unchanged, the saturation report's labels all ``prefill.``/``decode.``,
   the extra device and wall time a step; (c) ``/metrics`` (port 0)
   scraped mid-run and at the end, ``validate_exposition`` clean both times,
   the server gone after ``LLM.close()``; (d) a ``StepProfiler`` over 5
   decode steps (after its warm-up step), its Chrome trace holding 5 x a
   step's ``spoga_gemm_dequant`` kernels (no other profiler runs while it is
   armed); (e) the traffic served
   with no recorder, then recorded to a flight-recorder bundle (streams
   equal), replayed on the card by
   ``LLM.replay`` (bitwise, the replay's launches the recording's) and by
   ``python -m repro_torch.launch.replay`` in a subprocess (exit 0); the
   phase's time printed (budget 120 s);
13. training (after phase 12), every run under the launch counters:
   (a) full-width llama3.2-1b (16 layers, ``init_params(seed=0)``),
   ``int8_spoga``, remat on, ``launch.train.train_loop`` for 8 steps of
   4 x 1,024 tokens: every loss and grad norm finite, the first 3 batches'
   mean loss under the trained params below their training losses (fresh
   batches' losses stay flat at full width, printed), exactly 224 ``spoga_gemm_dequant``
   launches a step (7 x 16 in the forward, as many in the remat
   recompute; the straight-through backward is f32 products) and no plain
   version; step time, peak memory, and one profiled step's device time
   and busy share, split into the forward and recompute GEMM kernels,
   weight quantization, the straight-through backward products, the loss
   chunks and AdamW; (b) 2 layers at full width: 4 steps straight against
   2 + an async ``CheckpointManager`` save + restore + 2, losses and every
   param bitwise equal; (c) 2 layers, 4 steps each in ``int8_spoga``,
   ``int8_spoga`` + ``cuda_spoga``, ``int8_deas`` and ``int8_direct``:
   loss curves bitwise equal, each kernel's launches exact ((b) and (c)
   under ``torch.use_deterministic_algorithms(True)``); (d) 2 layers, bf16
   and ``int8_spoga``, a 2 x 64 batch: the loss, every gradient leaf and
   the params after one AdamW step, card against CPU within the CPU
   tests' tolerances; (e) ``spoga_gemm_dequant`` at M = 4,096 for llama's
   four (K, N), bitwise against its plain version, timed against its
   bound and ``torch._int_mm``;
14. distribution (after phase 13), ``int8_spoga`` over int8 paged KV,
   phase 4's traffic, every serving run through ``LLM(runtime=
   RuntimeConfig(mesh=...))`` with weights from ``init_params(seed=0)``
   and its launches gated exactly per rank (at tp=2 each layer's 5
   column-parallel projections on ``spoga_gemm_dequant``, its 2
   row-parallel ones on ``spoga_gemm``; ``paged_attention`` once a layer a
   decode step; no plain version): nvidia-smi's compute mode printed (an
   exclusive mode fails here: (b)-(e) share the card); (a) full-width
   llama3.2-1b (``TP_LLAMA_LAYERS``, 4 of its 16 layers)
   unsharded and with ``MeshConfig(enable=True)`` on one NCCL rank,
   streams bitwise equal; mistral-large-123b at full width
   (``TP_MISTRAL_LAYERS`` of its 88 layers) and deepseek-moe-16b
   (``TP_DEEPSEEK_LAYERS`` of 28) unsharded on the first ``TP_REQUESTS``
   (4) of phase 4's requests; then two gloo ranks spawned
   on ``cuda:0``: (b) llama at tp=2, the streams (a)'s, and the sharded
   projections at llama's and mistral's shapes bitwise their unsharded
   products; (c) mistral-large at tp=2, the streams tp=1's, each rank's
   param bytes equal to ``tree_device_bytes``; (d) deepseek expert-parallel
   at tp=2, the streams tp=1's; (e) dp=2 training of 2-layer full-width
   llama, compression off and on, the params bitwise equal across ranks
   (sha256), 14 ``spoga_gemm_dequant`` launches a step a rank, and
   ``compressed_psum_mean`` of the layers' CUDA gradients bitwise the
   host's; each
   rank's ``max_memory_allocated``; then both GEMM kernels at a tp=2 rank's
   projection shapes (M=4) bitwise against their plain versions, timed
   against the bound and ``torch._int_mm``;
15. the serving CLI (after phase 14): (a) ``launch.serve.main`` in this
   process on full-width llama3.2-1b (``CLI_ARGV``: ``int8_spoga``, int8
   paged KV, 8 requests of 64-128 tokens from ``synthetic_workload``, 16-32
   new, 2 steps apart, 4 lanes), ``spoga_gemm_dequant`` (112 a decode step
   or prefill) and ``paged_attention`` (16 a decode step) gated exactly,
   every greedy stream equal to ``ServingEngine``'s on the same weights and
   arrivals; (b) the same with ``set_default_backend("cuda_spoga")`` and
   no flag: ``spoga_gemm`` instead, (a)'s streams, and each CPU twin as
   the default raising ``ValueError`` on CUDA tensors; (c) ``python -m
   repro_torch.launch.serve`` with (a)'s flags in a subprocess, exit 0 and
   (a)'s sample line; (d) on CUDA tensors at M=4 K=2048 N=8192,
   ``spoga_matmul`` / ``deas_matmul`` with ``encoding="tc"`` and ``"sm"``
   bitwise ``direct_matmul``, ``kernels/ref.py``'s oracles against the
   ``spoga_gemm`` kernel (bitwise) and the ``spoga_gemm_dequant`` kernel
   (``DEQUANT_RTOL``); (e) ``examples/torch_quickstart.py`` and
   ``examples/torch_photonic_sim.py`` as subprocesses, exit 0;
16. sharded training (after phase 15): four gloo ranks spawned on
   ``cuda:0``, full-width llama3.2-1b (``SHARDED_LAYERS`` of its 16
   layers), ``int8_spoga``, ``init_params(seed=0)``, a global batch of
   4 x 256 tokens, ``TrainConfig``'s FSDP and ZeRO-1 defaults: (a) two
   steps on a 2x2 ("data", "model") mesh against the unsharded step on the
   same card (each rank holds the unsharded run's blocks): the losses
   within ``SHARDED_LOSS_TOL``, every gradient leaf of the first step
   within ``SHARDED_GRAD_TOL`` of its largest magnitude, the AdamW update
   of the first step held apart (``_update_errors``: each rank's m and v
   blocks against the unsharded step's, its master moved by AdamW's rule
   from its own m and v within ``SHARDED_UPDATE_TOL`` of the lr, its param
   block the master cast), the params after the steps within the param
   bounds; per-rank launches gated exactly (10
   ``spoga_gemm_dequant`` and 4 ``spoga_gemm`` a step, none in the
   backward, no plain version); ranks that hold the same block hold the
   same bits (sha256); each rank's param and optimizer bytes equal to
   ``tree_device_bytes``, its ``max_memory_allocated`` a step above the
   step's start printed; (b) an
   async ``CheckpointManager`` save on 2x2, restored onto 4x1 and onto 1x4:
   every block bitwise the slice of the saved tree, one step on each held
   to the unsharded resumed step (the loss, the AdamW update and the
   params, bounds as in (a)), its launches gated; (c) both GEMM kernels at
   every (M, K, N) that the counted runs of (a) and (b) launched them at
   (recorded around those runs: a 2x2 rank's M=512 at tp=2 widths, a 4x1
   rank's M=256 at full width, a 1x4 rank's M=1,024 at tp=4 widths) and at
   a tp=4 rank's decode step (``TP4_KN`` at M=4), bitwise against their
   plain versions, timed against the bound and ``torch._int_mm``;
17. tensor-parallel serving of the other archs (after phase 16), at full
   width and ``int8_spoga``, depth cut (``TPA_LAYERS``), weights from
   ``init_params(seed=0)``, first unsharded here, then in two gloo ranks
   spawned once on ``cuda:0``: (a) minicpm3-4b (2 of 62 layers),
   xlstm-125m (4 of 12: one mLSTM/sLSTM period) and recurrentgemma-9b (3
   of 38: two RG-LRU layers and the local-attention ring, one KV head)
   through ``LLM(runtime=RuntimeConfig(mesh=MeshConfig(tp=2)))`` over int8
   paged KV, 4 requests of 17-64 tokens, 8 new, 4 lanes, pages of 16; (b)
   seamless-m4t-large-v2 (2 + 2 layers) and llava-next-mistral-7b (2 of
   32) through ``serve_batch(mesh=)``, 4 rows of 32 frames or patches, 8
   new tokens; (c) ``launch.serve.main`` of seamless-m4t-large-v2 at full
   depth with ``--tp 2`` (its static path); (d) 2 layers of llama3.2-1b
   with ``numerics_watchdog`` on, a prefill and 4 decode steps.  Gates:
   every rank's tokens (the CLI's sample line) equal to the unsharded
   run's; its param bytes ``tree_device_bytes`` and its cache bytes those
   of ``pool_shardings`` of the full cache tree; its launches exact per
   rank (``_tpa_launches``: at tp=2 the row-parallel projections on
   ``spoga_gemm``, the rest on ``spoga_gemm_dequant``; no plain version);
   the watchdog report the unsharded one's (the quant error within
   ``TPA_ERR_RTOL``); every ``TPA_KN`` shape launched at M=4;
18. tensor-parallel training of the other archs (after phase 17): two
   gloo ranks on ``cuda:0``, a (data, model) = (1, 2) mesh,
   ``TrainConfig(**TRAIN_LR)`` (FSDP and ZeRO-1 on, as by default), one
   step of ``TPT_BATCH`` x ``TPT_SEQ`` tokens at full width and
   ``int8_spoga``, remat off, depth cut (``TPT_LAYERS``): deepseek-moe-16b
   (1 dense + 1 MoE layer, 32 experts a rank), minicpm3-4b, xlstm-125m,
   recurrentgemma-9b, seamless-m4t-large-v2 (64 source frames) and
   llava-next-mistral-7b (128 patch embeddings, each row's first labels
   masked).  The unsharded step runs first on the card in each rank (one
   rank at a time for ``TPT_ONE_AT_A_TIME``), from the same weights and
   batch: its forward and backward over
   the whole model, its clip by the global norm, and its AdamW update --
   elementwise -- evaluated on the rank's blocks (the whole AdamW state of
   recurrentgemma-9b does not fit beside the other rank).  Gates, per rank: the loss
   within ``TPT_LOSS_TOL``; every gradient leaf (``gather_tree``) within
   ``SHARDED_GRAD_TOL`` of its largest magnitude; the AdamW blocks after
   the step by ``_update_errors``; param and optimizer bytes
   ``tree_device_bytes``; every leaf the specs replicate over "model"
   bitwise equal on both ranks (sha256); both steps' GEMM launches exact
   (``_tpa_launches``' prefill column: a training step's forward, none in
   the backward), no plain version; then (b) both GEMM kernels at every
   (kernel, M, K, N) the tp=2 steps launched, bitwise against their plain
   versions and timed;
19. the dry run (after phase 18): (a) ``launch.dryrun.run_cell`` on meta
   tensors, 16x16, ``int8_spoga``, no calibration, for deepseek-moe-16b x
   ``decode_32k``, recurrentgemma-9b x ``long_500k`` and
   seamless-m4t-large-v2 x ``prefill_32k``: each ``ok``, its argument
   bytes ``shard.tree_device_bytes`` of the cell's trees and specs, its
   record printed; (b) the card check: rank 0 of deepseek-moe-16b x
   ``decode_32k`` x 16x16 run for real on the card (``device="cuda"``,
   placeholder collectives): each kernel's launches exactly the meta
   run's ``META_CALLS``, no plain version, the collectives and argument
   bytes equal to the meta run's, the record's counts a meta run's
   (``counted_on``), finite logits of the rank's lanes, and the peak
   allocated above the start within ``DRY_PEAK_TOL`` (2%) of the meta
   run's ``hbm_per_device_gib``; the step's device time printed;
20. the ``kernels`` JSON line, then the ``ok`` line last.

Needs a CUDA card; exits non-zero without one, or without the repo's ``src/``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor rate
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor rate
L2_BYTES = 50 * 2**20

GEMM_KN = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
GEMM_SPECS = {"w8a8": "int8_spoga", "w4a8": "w4a8", "w16a16": "w16a16"}
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
# card vs CPU logits: bf16 rounding of sums taken in another order
LOGIT_TOL = 2e-2
# a greedy token may flip between two summation orders only on a row whose
# top-2 margin is at most this many bf16 ulps of its top logit
NEAR_TIE_ULPS = 2
ENGINE_SEED = 0
# phase 7's prefill chunk: the M of every projection of a chunk step
CHUNK_M = 512


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, n_bufs: int, iters: int, warmup: int = 3) -> float:
    """Mean time of ``fn(i)`` over ``iters`` back-to-back calls between two
    CUDA events, cycling ``i`` over ``n_bufs`` input copies so that L2 stays
    cold.  A call shorter than its host cost reads as the launch rate."""
    for i in range(warmup):
        fn(i % n_bufs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_bufs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, n_bufs: int, iters: int, warmup: int = 3, kernel: str | None = None,
              floor_ms: float = 0.0) -> float:
    """Mean device time of ``fn(i)``: the profiler's kernel time summed over
    ``iters`` calls (every kernel the call launches, gaps between them not
    counted), cycling ``i`` over ``n_bufs`` input copies.  The profiler
    now and then records no kernel in a session, or loses some of its
    records; with ``kernel`` (a kernel name that ``fn`` launches once a
    call) a session counts only if it holds exactly ``iters`` of them, and
    with ``floor_ms`` (the work's bound) only if its mean is not below it.
    After three sessions that miss, the calls are timed as one CUDA-graph
    replay."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(i % n_bufs)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i % n_bufs)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        total = sum(e.self_device_time_total for e in events)
        whole = kernel is None or sum(e.count for e in events if kernel in e.key) == iters
        if total > 0 and whole and total / 1e3 / iters >= floor_ms:
            return total / 1e3 / iters
    print("[timing] the profiler recorded no kernel, or lost some, in three sessions: "
          "timed by a CUDA-graph replay instead", flush=True)
    return graph_ms(fn, n_bufs, iters)


def graph_ms(fn, n_bufs: int, iters: int, replays: int = 5) -> float:
    """Mean time of ``fn(i)`` captured ``iters`` times into one CUDA graph
    and replayed between two CUDA events: no host launch cost, but the
    graph's own gap between kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_bufs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_bufs)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def device_ms_by_kernel(fns: dict, n_bufs: int, iters: int, warmup: int = 3) -> dict:
    """Mean device time per call of ``fns`` {kernel name: function launching
    that one kernel}, all in one profiler session: ``iters`` calls of the
    first function, then of the next, ... (back-to-back calls of one kernel,
    as ``device_ms`` times them): {kernel name: ms}.  After three sessions
    that miss a kernel each function is timed alone by a CUDA-graph replay."""
    from torch.profiler import ProfilerActivity, profile
    for fn in fns.values():
        for i in range(warmup):
            fn(i % n_bufs)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for fn in fns.values():
                for i in range(iters):
                    fn(i % n_bufs)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        times = {}
        for name in fns:
            hits = [e.self_device_time_total for e in kernels if name in e.key]
            require(len(hits) <= 1, f"{name}: {len(hits)} kernels of that name")
            if hits and hits[0] > 0:
                times[name] = hits[0] / 1e3 / iters
        if len(times) == len(fns):
            return times
    print("[timing] the profiler missed a kernel in three sessions: timed by CUDA-graph "
          "replays instead", flush=True)
    return {name: graph_ms(fn, n_bufs, iters) for name, fn in fns.items()}


def kernel_times(fn, n_bufs: int, iters: int, kernel: str | None = None,
                 floor_ms: float = 0.0) -> tuple[float, float]:
    """(device time by the profiler, event time of back-to-back calls)."""
    return (device_ms(fn, n_bufs, iters, kernel=kernel, floor_ms=floor_ms),
            time_ms(fn, n_bufs, iters))


def require_bound(t_ms: float, bound_ms: float, label: str) -> None:
    """A device time below the least time the card could take is a lost
    profiler record, not a fast kernel."""
    require(t_ms >= bound_ms, f"{label}: device time {t_ms:.4f} ms is below its bound "
                              f"{bound_ms:.4f} ms")


def copies_for(nbytes: int, cap: int = 16) -> int:
    """Copies of an input that together exceed twice the L2 cache (at most
    ``cap``: past it the copies are only cooler)."""
    return max(1, min(cap, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound(nbytes: int, ops: float, rate: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# 1. card
# ---------------------------------------------------------------------------

def phase_card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"[card] kernels built in {time.perf_counter() - t0:.1f} s -> "
          f"{path.relative_to(Path(__file__).resolve().parent)}", flush=True)
    return card


# ---------------------------------------------------------------------------
# 2. GEMM kernels
# ---------------------------------------------------------------------------

def _lib_int_mm(x, w_copies, m, k, n):
    """``torch._int_mm``'s device time on int8 operands, else None.  Where it does
    not take the shape as it is (M <= 16, K or N not a multiple of 8) the
    operands are zero-padded as the ``cuda_direct`` backend pads them
    (``impls.int_mm_padded``, M up to 24), the padding timed with it."""
    from repro_torch.backends.impls import int_mm_padded
    if not (x.dtype == w_copies[0].dtype == torch.int8):
        return None
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        return device_ms(lambda i: torch._int_mm(x, w_copies[i]), len(w_copies), iters=40)
    return device_ms(lambda i: int_mm_padded(x, w_copies[i]), len(w_copies), iters=40)


def _lib_label(m, k, n):
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        return "torch._int_mm (int32 product)"
    return "torch._int_mm on operands zero-padded to M=24 (int32 product, padding included)"


def _int_product_ops(m, k, n):
    """Operations of the function, one integer (M, K) @ (K, N) product,
    counted at the int8 rate whatever the operand width: however many
    plane pairs a kernel multiplies, the function needs 2*M*K*N.  For int16
    operands (w16a16) the card has no faster integer rate than int8, so
    this still bounds the time from below."""
    return 2.0 * m * k * n


def _gemm_case_shapes():
    shapes = [(m, k, n) for m in (1, 4, 128) for k, n in GEMM_KN]
    return shapes + [(130, 257, 100), (1, 249, 16)]


def _gemm_operands(m, k, n, mode, gen):
    from repro_torch.backends import effective_bits, parse_quant_mode
    spec, _ = parse_quant_mode(mode)
    a_bits, w_bits = effective_bits(spec, k)
    qa, qw = 2 ** (a_bits - 1) - 1, 2 ** (w_bits - 1) - 1
    x = torch.randint(-qa, qa + 1, (m, k), generator=gen, device="cuda").to(spec.a_dtype)
    w = torch.randint(-qw, qw + 1, (k, n), generator=gen, device="cuda").to(spec.w_dtype)
    xs = torch.rand((m, 1), generator=gen, device="cuda") * 0.1 + 1e-3
    ws = torch.rand((1, n), generator=gen, device="cuda") * 0.1 + 1e-3
    return spec, x, w, xs, ws


def _gemm_timing(name, mode, m, k, n, gen, tag="gemm"):
    """``spoga_gemm_dequant`` at (M, K, N): the profiler's device time (event
    time beside it), the plain version's time, ``torch._int_mm``'s and the
    bound, with weight copies enough to keep L2 cold."""
    from repro_torch.kernels.spoga_gemm_dequant import (
        spoga_gemm_dequant,
        spoga_gemm_dequant_plain,
    )
    spec, x, w, xs, ws = _gemm_operands(m, k, n, mode, gen)
    nb = copies_for(w.numel() * w.element_size())
    ws_copies = [w.clone() for _ in range(nb)]
    kw = dict(n_x_slices=spec.n_a_slices, n_w_slices=spec.n_w_slices,
              slice_bits=spec.slice_bits)
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + 4 * (m + n) + 4 * m * n)
    b_ms, b_by = bound(nbytes, _int_product_ops(m, k, n), INT8_OPS_PER_S)
    t_kernel, t_event = kernel_times(
        lambda i: spoga_gemm_dequant(x, ws_copies[i], xs, ws, **kw), nb, iters=40,
        kernel="spoga_gemm_dequant_kernel", floor_ms=b_ms)
    require_bound(t_kernel, b_ms, f"{tag} {name} M={m} K={k} N={n}")
    t_plain = time_ms(lambda i: spoga_gemm_dequant_plain(x, ws_copies[i], xs, ws),
                      nb, iters=5, warmup=1)
    t_lib = _lib_int_mm(x, ws_copies, m, k, n)
    lib = f"{t_lib:.4f} ms" if t_lib is not None else "n/a"
    lib += " (padded)" if m <= 16 and t_lib is not None else ""
    print(f"[{tag}] {name} M={m} K={k} N={n}: kernel {t_kernel:.4f} ms device "
          f"({t_event:.4f} ms by events), plain {t_plain:.4f} ms, _int_mm {lib}, "
          f"bound {b_ms:.4f} ms ({b_by}, {b_ms / t_kernel:.1%} of it)", flush=True)
    return dict(ms=t_kernel, event_ms=t_event, plain_ms=t_plain, library_ms=t_lib,
                bound_ms=b_ms, bound_by=b_by)


def phase_gemm():
    from repro_torch.kernels.spoga_gemm_dequant import (
        spoga_gemm_dequant,
        spoga_gemm_dequant_plain,
    )
    gen = torch.Generator(device="cuda").manual_seed(1)
    checked, max_err = 0, 0.0
    for name, mode in GEMM_SPECS.items():
        for m, k, n in _gemm_case_shapes() + [(CHUNK_M, k, n) for k, n in GEMM_KN]:
            spec, x, w, xs, ws = _gemm_operands(m, k, n, mode, gen)
            got = spoga_gemm_dequant(x, w, xs, ws, n_x_slices=spec.n_a_slices,
                                     n_w_slices=spec.n_w_slices, slice_bits=spec.slice_bits)
            want = spoga_gemm_dequant_plain(x, w, xs, ws)
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            require(torch.equal(got, want), f"GEMM {name} ({m},{k},{n}): max |diff| {err}")
            checked += 1
    print(f"[gemm] {checked} cases bitwise equal to the plain version (max |diff| "
          f"{max_err})", flush=True)

    timings = {}
    for name, mode in GEMM_SPECS.items():
        # M=CHUNK_M: every projection of a chunked-prefill step (phase 7), at W8A8
        for m in (4, 128) + ((CHUNK_M,) if name == "w8a8" else ()):
            for k, n in GEMM_KN:
                timings[(name, m, k, n)] = _gemm_timing(name, mode, m, k, n, gen)
    # one decode step's projections (q, k, v, o, gate, up, down) per layer
    layer = [(2048, 2048), (2048, 512), (2048, 512), (2048, 2048),
             (2048, 8192), (2048, 8192), (8192, 2048)]
    per_layer = sum(timings[("w8a8", 4, k, n)]["ms"] for k, n in layer)
    print(f"[gemm] W8A8 decode step at M=4, 16 layers x 7 projections: "
          f"{16 * per_layer:.3f} ms of kernel device time", flush=True)
    return timings, max_err


def phase_int_gemm():
    """The int32 SPOGA kernel: bitwise against its plain version on phase
    2's grid; times at the decode and prefill widths."""
    from repro_torch.kernels.spoga_gemm import spoga_gemm, spoga_gemm_plain
    gen = torch.Generator(device="cuda").manual_seed(4)
    checked, max_err = 0, 0
    for name, mode in GEMM_SPECS.items():
        for m, k, n in _gemm_case_shapes():
            spec, x, w, _, _ = _gemm_operands(m, k, n, mode, gen)
            got = spoga_gemm(x, w, n_x_slices=spec.n_a_slices, n_w_slices=spec.n_w_slices,
                             slice_bits=spec.slice_bits)
            want = spoga_gemm_plain(x, w)
            err = (got.long() - want.long()).abs().max().item()
            max_err = max(max_err, err)
            require(got.dtype == torch.int32 and torch.equal(got, want),
                    f"spoga_gemm {name} ({m},{k},{n}): max |diff| {err}")
            checked += 1
    print(f"[spoga_gemm] {checked} cases bitwise equal to the plain version (max |diff| "
          f"{max_err})", flush=True)

    timings = {}
    for name, mode in GEMM_SPECS.items():
        for m in (4, 128):
            for k, n in GEMM_KN:
                timings[(name, m, k, n)] = _int_gemm_timing(name, mode, m, k, n, gen)
    return timings, max_err


def _int_gemm_timing(name, mode, m, k, n, gen, tag="spoga_gemm"):
    """``spoga_gemm`` at (M, K, N): device time (event time beside it), the
    plain version's, ``torch._int_mm``'s and the bound, with weight copies
    enough to keep L2 cold."""
    from repro_torch.kernels.spoga_gemm import spoga_gemm, spoga_gemm_plain
    spec, x, w, _, _ = _gemm_operands(m, k, n, mode, gen)
    nb = copies_for(w.numel() * w.element_size())
    w_copies = [w.clone() for _ in range(nb)]
    kw = dict(n_x_slices=spec.n_a_slices, n_w_slices=spec.n_w_slices,
              slice_bits=spec.slice_bits)
    nbytes = x.numel() * x.element_size() + w.numel() * w.element_size() + 4 * m * n
    b_ms, b_by = bound(nbytes, _int_product_ops(m, k, n), INT8_OPS_PER_S)
    t_kernel, t_event = kernel_times(lambda i: spoga_gemm(x, w_copies[i], **kw), nb, iters=40,
                                     kernel="spoga_gemm_kernel", floor_ms=b_ms)
    require_bound(t_kernel, b_ms, f"{tag} {name} M={m} K={k} N={n}")
    t_plain = time_ms(lambda i: spoga_gemm_plain(x, w_copies[i]), nb, iters=5, warmup=1)
    t_lib = _lib_int_mm(x, w_copies, m, k, n)
    lib = f"{t_lib:.4f} ms" if t_lib is not None else "n/a"
    lib += " (padded)" if m <= 16 and t_lib is not None else ""
    print(f"[{tag}] {name} M={m} K={k} N={n}: kernel {t_kernel:.4f} ms device "
          f"({t_event:.4f} ms by events), plain {t_plain:.4f} ms, _int_mm {lib}, "
          f"bound {b_ms:.4f} ms ({b_by}, {b_ms / t_kernel:.1%} of it)", flush=True)
    return dict(ms=t_kernel, event_ms=t_event, plain_ms=t_plain, library_ms=t_lib,
                bound_ms=b_ms, bound_by=b_by)


def combine_times(m, n, parts):
    """``deas_combine``'s device time at (M, N), warm (its partials rewritten
    by a copy kernel just before each call, as the main path finds them just
    written by ``nibble_gemm``) and cold (copies rotated past twice the L2,
    each read once a round), each in one profiler session with as many
    launches of the no-op kernel on the same grid; the event time and the
    plain version's time.  Re-reading the same partials call after call is
    no warm time: the streaming loads mark them evict-first, and L1 may
    keep part of them, so such a loop reads neither as the main path does."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import deas_gemm as deas_mod
    lib = _build.library()

    def noop(_i):
        _build.check(lib.noop_launch(m, n, torch.cuda.current_stream().cuda_stream), "noop")

    sources = [t.clone() for t in parts]

    def fresh(_i):
        for dst, src in zip(parts, sources):
            dst.copy_(src)
        deas_mod.deas_combine(*parts)

    warm = device_ms_by_kernel({"deas_combine_kernel": fresh, "noop_kernel": noop}, 1, iters=40)
    nc = copies_for(4 * parts[0].numel() * 4, cap=256)
    cold_parts = [[t.clone() for t in parts] for _ in range(nc)]
    cold = device_ms_by_kernel({"deas_combine_kernel":
                                lambda i: deas_mod.deas_combine(*cold_parts[i]),
                                "noop_kernel": noop}, nc, iters=max(40, nc))
    del cold_parts, sources
    return dict(warm_ms=warm["deas_combine_kernel"], noop_warm_ms=warm["noop_kernel"],
                cold_ms=cold["deas_combine_kernel"], noop_cold_ms=cold["noop_kernel"],
                copies=nc, event_ms=time_ms(lambda i: deas_mod.deas_combine(*parts), 1, iters=40),
                plain_ms=time_ms(lambda i: deas_mod.deas_combine_plain(*parts), 1, iters=5,
                                 warmup=1))


# deas_combine alone: decode and prefill widths and a count % 4 != 0 shape
COMBINE_CHECKS = [(4, 8192), (128, 8192), (3, 8191)]


def check_combine(gen):
    """``deas_combine`` bitwise against its plain version over the full int32
    range (every shift and add wraps), on aligned partials (16-byte vectors
    and the scalar tail) and on views one element past a 16-byte boundary
    (the scalar path).  Returns the largest |difference| (0)."""
    from repro_torch.kernels import deas_gemm as deas_mod
    max_err = 0
    for m, n in COMBINE_CHECKS:
        parts = [torch.randint(-2 ** 31, 2 ** 31, (m, n), generator=gen, device="cuda",
                               dtype=torch.int64).to(torch.int32) for _ in range(4)]
        bufs = [torch.empty(m * n + 4, dtype=torch.int32, device="cuda") for _ in range(4)]
        shifted = [b[1:1 + m * n].view(m, n) for b in bufs]
        for dst, src in zip(shifted, parts):
            dst.copy_(src)
        require(all(t.data_ptr() % 16 == 4 for t in shifted), "misaligned views are aligned")
        for label, inputs in (("aligned", parts), ("misaligned", shifted)):
            got = deas_mod.deas_combine(*inputs)
            want = deas_mod.deas_combine_plain(*inputs)
            torch.cuda.synchronize()
            err = (got.long() - want.long()).abs().max().item()
            max_err = max(max_err, err)
            require(torch.equal(got, want), f"deas_combine {label} ({m},{n}): max |diff| {err}")
    print(f"[deas] deas_combine bitwise equal to its plain version over the int32 range at "
          f"(M, N) {COMBINE_CHECKS}, aligned and one element off a 16-byte boundary",
          flush=True)
    return max_err


def combine_sustained(gen, m=2048, n=8192):
    """``deas_combine`` on 335 MB of partials (M=2048, N=8192, one copy,
    past the L2 several times over): the rate a long streaming call
    sustains on this card, against the 3.35 TB/s of the bound."""
    from repro_torch.kernels import deas_gemm as deas_mod
    parts = [torch.randint(-2 ** 31, 2 ** 31, (m, n), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.int32) for _ in range(4)]
    ms = device_ms(lambda i: deas_mod.deas_combine(*parts), 1, iters=20)
    b_ms, _ = bound(20 * m * n, 0.0, INT8_OPS_PER_S)
    print(f"[deas] deas_combine M={m} N={n} (335 MB a call): {ms:.4f} ms device, "
          f"{20 * m * n / ms / 1e9:.3f} TB/s, {b_ms / ms:.1%} of the bytes bound", flush=True)
    return {"shape": f"M={m} N={n}", "ms": ms, "bound_ms": b_ms, "fraction_of_bound": b_ms / ms}


def phase_deas(int_timings):
    """The DEAS kernels at W8A8: each call 4 nibble_gemm launches + 1
    deas_combine launch; bitwise against the plain versions and against
    spoga_gemm; times beside spoga_gemm's at the same shapes."""
    from repro_torch.core.slicing import slice_tc
    from repro_torch.kernels import deas_gemm as deas_mod
    from repro_torch.kernels.spoga_gemm import spoga_gemm
    gen = torch.Generator(device="cuda").manual_seed(5)
    checked, max_err = 0, 0
    for m, k, n in _gemm_case_shapes():
        x = torch.randint(-128, 128, (m, k), generator=gen, device="cuda").to(torch.int8)
        w = torch.randint(-128, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
        before = (deas_mod.CALLS, deas_mod.NIBBLE_LAUNCHES, deas_mod.COMBINE_LAUNCHES)
        got = deas_mod.deas_gemm(x, w)
        after = (deas_mod.CALLS, deas_mod.NIBBLE_LAUNCHES, deas_mod.COMBINE_LAUNCHES)
        require(tuple(a - b for a, b in zip(after, before)) == (1, 4, 1),
                f"deas_gemm ({m},{k},{n}): launches {before} -> {after}, want +(1, 4, 1)")
        want = deas_mod.deas_gemm_plain(x, w)
        fused = spoga_gemm(x, w)
        xm, xl = slice_tc(x)
        wm, wl = slice_tc(w)
        parts = [deas_mod.nibble_gemm(a, b) for a, b in ((xm, wm), (xm, wl), (xl, wm), (xl, wl))]
        require(len({p.data_ptr() for p in parts}) == 4, "partials share a buffer")
        for p, (a, b) in zip(parts, ((xm, wm), (xm, wl), (xl, wm), (xl, wl))):
            require(torch.equal(p, deas_mod.nibble_gemm_plain(a, b)),
                    f"nibble_gemm ({m},{k},{n}) differs from its plain version")
        require(torch.equal(deas_mod.deas_combine(*parts), deas_mod.deas_combine_plain(*parts)),
                f"deas_combine ({m},{k},{n}) differs from its plain version")
        err = (got.long() - want.long()).abs().max().item()
        max_err = max(max_err, err)
        require(torch.equal(got, want), f"deas_gemm ({m},{k},{n}): max |diff| {err}")
        require(torch.equal(got, fused), f"deas_gemm ({m},{k},{n}) differs from spoga_gemm")
        checked += 1
    print(f"[deas] {checked} W8A8 cases bitwise equal to the plain versions and to "
          f"spoga_gemm, 4 + 1 launches per call (max |diff| {max_err})", flush=True)
    combine_err = check_combine(gen)
    sustained = combine_sustained(gen)

    timings, nibble = {}, {}
    for m in (4, 128):
        for k, n in GEMM_KN:
            x = torch.randint(-128, 128, (m, k), generator=gen, device="cuda").to(torch.int8)
            w = torch.randint(-128, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
            nb = copies_for(w.numel())
            w_copies = [w.clone() for _ in range(nb)]
            t_kernel, t_event = kernel_times(lambda i: deas_mod.deas_gemm(x, w_copies[i]), nb,
                                             iters=40)
            t_plain = time_ms(lambda i: deas_mod.deas_gemm_plain(x, w_copies[i]), nb, iters=5,
                              warmup=1)
            t_lib = _lib_int_mm(x, w_copies, m, k, n)
            xm, xl = slice_tc(x)
            wm = [slice_tc(c)[0] for c in w_copies]
            t_nibble, t_nibble_event = kernel_times(lambda i: deas_mod.nibble_gemm(xm, wm[i]), nb,
                                                    iters=40)
            t_nibble_plain = time_ms(lambda i: deas_mod.nibble_gemm_plain(xm, wm[i]), nb, iters=5,
                                     warmup=1)
            t_nibble_lib = _lib_int_mm(xm, wm, m, k, n)
            parts = [deas_mod.nibble_gemm(xm, wm[0]) for _ in range(4)]
            comb = combine_times(m, n, parts)
            c_ms, _ = bound(20 * m * n, 0.0, INT8_OPS_PER_S)
            spoga = int_timings[("w8a8", m, k, n)]
            inter = 8 * m * n * 4
            # one plane product: its plane operands read once, its int32 output written once
            n_bytes = m * k + k * n + 4 * m * n
            nb_ms, nb_by = bound(n_bytes, _int_product_ops(m, k, n), INT8_OPS_PER_S)
            timings[(m, k, n)] = dict(ms=t_kernel, event_ms=t_event, plain_ms=t_plain,
                                      library_ms=t_lib, bound_ms=spoga["bound_ms"],
                                      bound_by=spoga["bound_by"], deas_combine=comb,
                                      deas_combine_bound_ms=c_ms,
                                      intermediate_bytes=inter, spoga_gemm_ms=spoga["ms"])
            nibble[(m, k, n)] = dict(ms=t_nibble, event_ms=t_nibble_event,
                                     plain_ms=t_nibble_plain, library_ms=t_nibble_lib,
                                     bound_ms=nb_ms, bound_by=nb_by)
            lib = f"{t_lib:.4f} ms" + (" (padded)" if m <= 16 else "")
            print(f"[deas] W8A8 M={m} K={k} N={n}: deas_gemm {t_kernel:.4f} ms device "
                  f"({t_event:.4f} ms by events; one nibble_gemm {t_nibble:.4f} ms device, "
                  f"{t_nibble_event:.4f} by events, plain {t_nibble_plain:.4f} ms, _int_mm on "
                  f"the planes {t_nibble_lib:.4f} ms, bound {nb_ms:.4f} ms; deas_combine "
                  f"{comb['warm_ms']:.4f} ms device warm, just written (no-op kernel "
                  f"{comb['noop_warm_ms']:.4f}),"
                  f" {comb['cold_ms']:.4f} cold (no-op {comb['noop_cold_ms']:.4f}; "
                  f"{comb['copies']} copies; bound {c_ms:.5f} ms, {c_ms / comb['cold_ms']:.1%} of "
                  f"it), {comb['event_ms']:.4f} by events, plain {comb['plain_ms']:.4f}; "
                  f"intermediates "
                  f"{inter} B) vs spoga_gemm {spoga['ms']:.4f} ms; plain {t_plain:.4f} ms, "
                  f"_int_mm {lib}, bound {spoga['bound_ms']:.4f} ms ({spoga['bound_by']}, "
                  f"{spoga['bound_ms'] / t_kernel:.1%} of it)", flush=True)
            del w_copies, wm, parts
    return timings, nibble, max_err, combine_err, sustained


# ---------------------------------------------------------------------------
# 3. paged-attention kernel
# ---------------------------------------------------------------------------

# (a) the main path's decode shape; (b) llama3.2-1b's heads at an 8K-token table;
# (c) the same table with every lane at length 1: the launch and clusters alone
ATTN_SHAPES = {
    "main": dict(b=4, hkv=8, g=4, d=64, ps=16, n_tbl=11),
    "long": dict(b=16, hkv=8, g=4, d=64, ps=16, n_tbl=512),
    "short": dict(b=16, hkv=8, g=4, d=64, ps=16, n_tbl=512),
    # phase 9's MoE decode layouts at the main path's lengths
    "deepseek": dict(b=4, hkv=16, g=1, d=128, ps=16, n_tbl=11),
    "granite": dict(b=4, hkv=8, g=3, d=64, ps=16, n_tbl=11),
    # phase 14's layouts: mistral-large at tp=1 and a tp=2 rank's (G=12, on
    # the CUDA-core kernel), llama's and deepseek's tp=2 ranks; a rank splits
    # as B x tp lanes would (``split_lanes``)
    "mistral": dict(b=4, hkv=8, g=12, d=128, ps=16, n_tbl=11),
    "mistral_tp2": dict(b=4, hkv=4, g=12, d=128, ps=16, n_tbl=11, split_lanes=8),
    "llama_tp2": dict(b=4, hkv=4, g=4, d=64, ps=16, n_tbl=11, split_lanes=8),
    "deepseek_tp2": dict(b=4, hkv=8, g=1, d=128, ps=16, n_tbl=11, split_lanes=8),
}
ATTN_ARCH_SHAPES = ("deepseek", "granite", "mistral", "mistral_tp2", "llama_tp2",
                    "deepseek_tp2")
ATTN_MAIN_LENGTHS = [1, 17, 100, 165]
ATTN_LONG_SEED = 7


def attn_lengths(name, shape):
    if name == "long":
        return long_lengths(shape)
    return [1] * shape["b"] if name == "short" else ATTN_MAIN_LENGTHS


def long_lengths(shape):
    """Lengths between 1,024 and the table's 8,192 rows, from the seed: one
    lane at 8,192, one on a page boundary, one on a split boundary (a
    multiple of MAX_SPLITS pages: as many pages in every split at the
    shape's S = MAX_SPLITS; split r takes pages r, r + S, ...)."""
    from repro_torch.kernels.paged_attention import MAX_SPLITS
    rows = shape["n_tbl"] * shape["ps"]
    lens = np.random.default_rng(ATTN_LONG_SEED).integers(1024, rows + 1, shape["b"])
    edge = MAX_SPLITS * shape["ps"]
    lens[:3] = [rows, 313 * shape["ps"], edge * (rows // edge * 5 // 8)]
    return lens.tolist()


def _attn_pools(kind, gen, n_pages, shape):
    shp = (n_pages, shape["ps"], shape["hkv"], shape["d"])
    if kind == "int8":
        kp = torch.randint(-127, 128, shp, generator=gen, device="cuda").to(torch.int8)
        vp = torch.randint(-127, 128, shp, generator=gen, device="cuda").to(torch.int8)
        scales = {"k_scale": torch.rand(shp[:3], generator=gen, device="cuda") * 0.02 + 1e-3,
                  "v_scale": torch.rand(shp[:3], generator=gen, device="cuda") * 0.02 + 1e-3}
        return kp, vp, scales
    kp = torch.randn(shp, generator=gen, device="cuda").bfloat16()
    vp = torch.randn(shp, generator=gen, device="cuda").bfloat16()
    return kp, vp, {}


def _attn_case(kind, gen, shape, lengths):
    """The pool holds each lane's pages below its length (distinct, in
    shuffled order) and the trash page 0, which every table entry past a
    lane's length names.  Returns the poisoned inputs and the clean pools:
    stale rows of each lane's last page and the whole trash page poisoned."""
    b, ps, n_tbl = shape["b"], shape["ps"], shape["n_tbl"]
    used = [-(-n // ps) for n in lengths]
    n_pages = 1 + sum(used)
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1).to(torch.int32)
    tables = torch.zeros((b, n_tbl), dtype=torch.int32, device="cuda")
    start = 0
    for lane, n in enumerate(used):
        tables[lane, :n] = perm[start:start + n]
        start += n
    q = torch.randn((b, shape["hkv"], shape["g"], shape["d"]), generator=gen,
                    device="cuda").bfloat16()
    kp, vp, scales = _attn_pools(kind, gen, n_pages, shape)
    clean = (kp.clone(), vp.clone())
    big = 127 if kind == "int8" else 3.0e4
    for lane, n in enumerate(lengths):
        last, off = tables[lane, (n - 1) // ps], (n - 1) % ps + 1
        for pool in (kp, vp):
            pool[last, off:] = big
    for pool in (kp, vp):
        pool[0] = -big
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, lengths, scales, clean


def _attn_bound(q, kp, tables, lengths, scales, group=1):
    """Bytes the function needs: q, the K and V rows below each length (and
    their scales), the table entries naming them, lengths and the output;
    operations: QK and PV, 4 per row, head and element, at the bf16 rate.
    ``group`` > 1 is the verify layout, where each run of ``group`` lanes
    repeats one table row: its K/V rows, scales and table entries are read
    once, at the group's longest length; operations still count every
    lane's own length."""
    b, hkv, g, d = q.shape
    ps = kp.shape[1]
    rows = int(lengths.sum())
    read = lengths.view(-1, group).amax(dim=1)
    kv_rows = int(read.sum())
    pages = int(((read + ps - 1) // ps).sum())
    kv_bytes = (2 * kv_rows * hkv * d * kp.element_size()
                + (2 * kv_rows * hkv * 4 if scales else 0))
    nbytes = q.numel() * q.element_size() + kv_bytes + 4 * pages + 4 * b + 4 * b * hkv * g * d
    return bound(nbytes, 4.0 * rows * hkv * g * d, BF16_OPS_PER_S)


def _sdpa_ms(q, kp, vp, tables, lengths):
    """``scaled_dot_product_attention`` on the gathered bf16 view (the G query
    heads of a KV head as its queries, the table's rows as keys, masked
    past each length)."""
    import torch.nn.functional as F
    b, hkv, g, d = q.shape
    n_tbl, ps = tables.shape[1], kp.shape[1]
    k_all = kp[tables.long()].reshape(b, n_tbl * ps, hkv, d).permute(0, 2, 1, 3)
    v_all = vp[tables.long()].reshape(b, n_tbl * ps, hkv, d).permute(0, 2, 1, 3)
    mask = (torch.arange(n_tbl * ps, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    return device_ms(lambda i: F.scaled_dot_product_attention(q, k_all, v_all, attn_mask=mask),
                     1, iters=50)


def phase_attention(card):
    """Both pools at shapes (a), (b) and (c): the kernel against the plain version
    on clean and on poisoned pools, two calls bitwise equal; device and
    event time (shape (b) cold: pool copies rotated past the L2), plain
    time, bound and ``scaled_dot_product_attention`` (bf16 pools)."""
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for name, shape in ATTN_SHAPES.items():
        lengths = attn_lengths(name, shape)
        split = shape.get("split_lanes")
        for kind in ("bf16", "int8"):
            q, kp, vp, tables, lengths_t, scales, (kc, vc) = _attn_case(kind, gen, shape, lengths)
            got = paged_attention(q, kp, vp, tables, lengths_t, split_lanes=split, **scales)
            again = paged_attention(q, kp, vp, tables, lengths_t, split_lanes=split, **scales)
            want = paged_attention_plain(q, kc, vc, tables, lengths_t, **scales)
            want_p = paged_attention_plain(q, kp, vp, tables, lengths_t, **scales)
            torch.cuda.synchronize()
            err = max((got - want).abs().max().item(), (got - want_p).abs().max().item())
            label = f"paged attention {kind} {name}"
            require(torch.allclose(got, want, **ATTN_TOL)
                    and torch.allclose(got, want_p, **ATTN_TOL), f"{label}: max |diff| {err}")
            require(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
            require(torch.equal(got, again), f"{label}: two calls differ")
            del kc, vc, want, want_p, again

            nb = copies_for(kp.numel() * kp.element_size() * 2) if name == "long" else 1
            pools = [(kp, vp, scales)] + [(kp.clone(), vp.clone(),
                                           {k: v.clone() for k, v in scales.items()})
                                          for _ in range(nb - 1)]
            iters = 50 if name == "long" else 200
            b_ms, b_by = _attn_bound(q, kp, tables, lengths_t, scales)
            t_kernel, t_event = kernel_times(
                lambda i: paged_attention(q, pools[i][0], pools[i][1], tables, lengths_t,
                                          split_lanes=split, **pools[i][2]), nb, iters=iters,
                kernel="paged_attention_kernel", floor_ms=b_ms)
            require_bound(t_kernel, b_ms, label)
            t_plain = time_ms(lambda i: paged_attention_plain(q, pools[i][0], pools[i][1], tables,
                                                              lengths_t, **pools[i][2]),
                              nb, iters=20 if name == "main" else 5, warmup=1)
            t_lib = _sdpa_ms(q, kp, vp, tables, lengths_t) if kind == "bf16" else None
            b, hkv, g, d = q.shape
            out[(kind, name)] = dict(
                ms=t_kernel, event_ms=t_event, plain_ms=t_plain, library_ms=t_lib,
                bound_ms=b_ms, bound_by=b_by, fraction_of_bound=b_ms / t_kernel,
                max_abs_err=err, copies=nb,
                shape=(f"{kind} pool B={b} Hkv={hkv} G={g} D={d} ps={kp.shape[1]} "
                       f"P={tables.shape[1]}, {int(lengths_t.sum())} rows"))
            lib = f"{t_lib:.4f} ms" if t_lib is not None else "n/a"
            lens = (lengths if name == "main"
                    else f"{min(lengths)}..{max(lengths)} (mean {np.mean(lengths):.0f})")
            print(f"[attn] {kind} {name} B={b} Hkv={hkv} G={g} D={d} ps={kp.shape[1]} "
                  f"P={tables.shape[1]} lengths {lens}: max |diff| {err:.3g} (stale rows "
                  f"poisoned), two calls bitwise equal; kernel {t_kernel:.4f} ms device "
                  f"({t_event:.4f} ms by events; {nb} pool cop{'y' if nb == 1 else 'ies'}), "
                  f"plain {t_plain:.4f} ms, sdpa {lib}, bound {b_ms:.5f} ms ({b_by}, "
                  f"{b_ms / t_kernel:.1%} of it) [{card}]", flush=True)
            del pools, q, kp, vp, tables, scales
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 4. main path
# ---------------------------------------------------------------------------

def _traffic(n, vocab, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(17, 129, n)
    gens = rng.integers(16, 33, n)
    return [(2 * i, rng.integers(0, vocab, int(p)).tolist(), int(g))
            for i, (p, g) in enumerate(zip(lens, gens))]


def _serve(cfg, params, arrivals, n_slots, cache_mode="paged"):
    from repro_torch.configs import default_cache_len
    from repro_torch.serving import EngineConfig, ServingEngine
    ecfg = EngineConfig(n_slots=n_slots, page_size=16, prefill_buckets=(32, 64, 128),
                        cache_len=default_cache_len(128, 32), cache_mode=cache_mode)
    engine = ServingEngine(cfg, params, ecfg, device="cuda")
    metrics = engine.run(arrivals)
    torch.cuda.synchronize()
    return engine, metrics


def _gemm_launches(cfg):
    """(``spoga_gemm_dequant`` launches per decode or verify step, per
    prefill dispatch or chunk step, layers with a ``paged_attention`` launch
    per paged decode step) of the stack at ``int8_spoga``: a GQA block runs
    q, k, v, o and the GLU's 3 projections; an MLA block w_dq, w_uq, w_dkv,
    w_kr, wo and the GLU's 3, plus w_uk and w_uv where K/V are rebuilt
    (prefill and chunk steps), and attends in torch; a MoE block runs the
    attention's 4 and its shared experts' GLU (the routed experts are plain
    torch); an RG-LRU block its two branches, two gates, w_out and the
    GLU's 3 (8), an mLSTM block q, k, v, the two gates, the output gate and
    w_out (7), an sLSTM block w_zifo and w_out (2); a local-attention block
    the GQA block's 7, attending its per-lane ring in torch."""
    from repro_torch.models.transformer import effective_kind, layer_layout
    lead, n_periods, tail = layer_layout(cfg)
    kinds = ["dense_ffn_layer"] * lead + list(cfg.block_pattern) * n_periods + list(tail)
    step = prefill = attn = 0
    cells = {"rglru": 8, "mlstm": 7, "slstm": 2}
    for kind in (effective_kind(k, cfg) for k in kinds):
        if kind == "mla":
            step, prefill = step + 8, prefill + 10
            continue
        if kind in cells:
            step, prefill = step + cells[kind], prefill + cells[kind]
            continue
        n = 4 + 3 * (kind != "moe" or bool(cfg.moe.num_shared_experts))
        ring = kind == "local_attn" and cfg.sliding_window is not None
        step, prefill, attn = step + n, prefill + n, attn + (not ring)
    return step, prefill, attn


def _kernel_modules():
    from repro_torch.backends import impls
    from repro_torch.kernels import deas_gemm, paged_attention, spoga_gemm, spoga_gemm_dequant
    return impls, deas_gemm, paged_attention, spoga_gemm, spoga_gemm_dequant


def reset_counts() -> None:
    impls, *kernels = _kernel_modules()
    for mod in kernels:
        mod.reset_counts()
    impls.INT_MM_CALLS = 0


def read_counts() -> tuple[dict, dict]:
    """(launches by kernel, plain-version calls by module) since the reset;
    ``torch._int_mm`` counts the ``cuda_direct`` backend's library calls."""
    impls, deas, attn, int_gemm, gemm = _kernel_modules()
    launches = {"spoga_gemm_dequant": gemm.LAUNCHES, "spoga_gemm": int_gemm.LAUNCHES,
                "nibble_gemm": deas.NIBBLE_LAUNCHES, "deas_combine": deas.COMBINE_LAUNCHES,
                "paged_attention": attn.LAUNCHES, "torch._int_mm": impls.INT_MM_CALLS}
    plain = {"spoga_gemm_dequant": gemm.PLAIN_CALLS, "spoga_gemm": int_gemm.PLAIN_CALLS,
             "deas_gemm": deas.PLAIN_CALLS, "paged_attention": attn.PLAIN_CALLS}
    return launches, plain


def check_counts(launches, plain, expect, label) -> None:
    """The kernels in ``expect`` launched, every other GEMM route did not,
    and no plain version ran."""
    print(f"[counts] {label}: launches {launches}, plain-version calls {plain}", flush=True)
    for name, n in launches.items():
        if name in expect:
            require(n > 0, f"{label}: {name} never launched")
        else:
            require(n == 0, f"{label}: {name} launched {n} times off its path")
    require(all(v == 0 for v in plain.values()), f"{label}: a plain version ran on the card")


def _counted_run(cfg, params, arrivals, n_slots, label):
    """Serve ``arrivals`` with every kernel count at 0 just before; return
    (metrics, engine, launches) read just after."""
    reset_counts()
    engine, metrics = _serve(cfg, params, arrivals, n_slots)
    launches, plain = read_counts()
    check_counts(launches, plain, ("spoga_gemm_dequant", "paged_attention"), label)
    return metrics, engine, launches


def _check_finished(metrics, arrivals, vocab, label):
    require(len(metrics.finished) == len(arrivals),
            f"{label}: {len(metrics.finished)} of {len(arrivals)} requests finished")
    streams = {r.req_id: r.output_tokens for r in metrics.finished}
    for rid, (_, _, gen) in enumerate(arrivals):
        toks = streams[rid]
        require(len(toks) == gen, f"{label}: request {rid} gave {len(toks)} of {gen} tokens")
        require(all(0 <= t < vocab for t in toks), f"{label}: token out of range")
    return streams


def full_width_params():
    """Full-width llama3.2-1b weights from ``init_params(seed=0)`` on the card
    (the weights do not depend on the quant mode)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=ENGINE_SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"[weights] llama3.2-1b full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    return params


def phase_main(card, params):
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-1b").with_(quant_mode="int8_spoga", kv_cache_dtype="int8")
    print("[main] int8_spoga, int8 paged KV, ServingEngine", flush=True)

    arrivals = _traffic(8, cfg.vocab_size, ENGINE_SEED)
    torch.cuda.reset_peak_memory_stats()
    metrics, engine, launches = _counted_run(cfg, params, arrivals, 4, "int8 KV, 8 requests")
    streams = _check_finished(metrics, arrivals, cfg.vocab_size, "int8 KV")
    rep = metrics.report()
    require(not engine.store.manager.invariant_violations(), "page bookkeeping broken")
    require(engine.store.manager.pages_in_use == 0, "pages leaked after the run")
    print(f"[main] {rep['requests']} finished, {rep['generated_tokens']} tokens in "
          f"{rep['wall_s']:.3f} s: {rep['tokens_per_s']:.1f} tok/s, TTFT mean "
          f"{1e3 * rep['ttft_mean_s']:.1f} ms, decode step mean "
          f"{1e3 * rep['decode_step_mean_s']:.2f} ms ({rep['decode_steps']} steps, "
          f"{rep['prefills']} prefills, peak lanes {rep['peak_running']}, defrag "
          f"{rep['defrag_count']} times, {rep['defrag_pages_moved']} pages), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
    expect_gemm = 7 * cfg.n_layers * (rep["decode_steps"] + rep["prefills"])
    expect_attn = cfg.n_layers * rep["decode_steps"]
    require(launches["spoga_gemm_dequant"] == expect_gemm,
            f"GEMM launches {launches['spoga_gemm_dequant']} != {expect_gemm}")
    require(launches["paged_attention"] == expect_attn,
            f"attention launches {launches['paged_attention']} != {expect_attn}")

    agree = total = 0
    for rid, (_, prompt, gen) in enumerate(arrivals):
        _, solo = _serve(cfg, params, [(0, prompt, gen)], 1)
        toks = solo.finished[0].output_tokens
        require(toks[0] == streams[rid][0],
                f"request {rid}: solo first token {toks[0]} != batched {streams[rid][0]}")
        agree += sum(a == b for a, b in zip(toks, streams[rid]))
        total += len(toks)
    print(f"[main] solo runs: first tokens equal, greedy agreement {agree}/{total}", flush=True)

    cfg16 = cfg.with_(kv_cache_dtype="bf16")
    arrivals16 = _traffic(4, cfg.vocab_size, ENGINE_SEED + 1)
    m16, _, launches16 = _counted_run(cfg16, params, arrivals16, 4, "bf16 KV, 4 requests")
    _check_finished(m16, arrivals16, cfg.vocab_size, "bf16 KV")
    r16 = m16.report()
    print(f"[main] bf16 KV: {r16['tokens_per_s']:.1f} tok/s, decode step mean "
          f"{1e3 * r16['decode_step_mean_s']:.2f} ms [{card}]", flush=True)
    profile = {"cache_len_168": phase_profile(cfg, params, card, "int8_spoga"),
               "context_2048": phase_profile(cfg, params, card, "int8_spoga", steps=4,
                                             prompt_len=2048)}
    return launches, launches16, profile, rep


def _kernel_group(name: str) -> str:
    for kernel in ("spoga_gemm_dequant_kernel", "spoga_gemm_kernel", "nibble_gemm_kernel",
                   "deas_combine_kernel"):
        if kernel in name:
            return kernel.replace("_kernel", " kernel")
    if "paged_attention_kernel" in name:
        return "paged_attention kernel"
    if "f64" in name.lower() and "gemm" in name.lower():
        return "library matmul (float64 plane products of the routed experts)"
    if any(t in name.lower() for t in ("gemm", "xmma", "cutlass", "cublas", "matmul", "nvjet")):
        return "library matmul (bf16 unembed, MLA latent einsums)"
    return ("elementwise and reductions (weight + activation quantization, nibble slicing, "
            "norms, rope)")


def _busy_engine(cfg, params, prompt_len=64, cache_mode="paged"):
    """A 4-lane engine with 4 requests of ``prompt_len`` tokens admitted and
    decoding (same every call)."""
    from repro_torch.configs import default_cache_len
    from repro_torch.serving import EngineConfig, ServingEngine
    buckets = (32, 64, 128) if prompt_len <= 128 else (prompt_len,)
    cache_len = default_cache_len(max(128, prompt_len), 32)
    if set(cfg.block_pattern) & {"rglru", "mlstm", "slstm", "local_attn"}:
        # recurrent state takes exact-length prefill; a ring, a page-aligned cache
        buckets, cache_len = None, _roundup(cache_len, 16)
    engine = ServingEngine(cfg, params, EngineConfig(
        n_slots=4, page_size=16, prefill_buckets=buckets,
        cache_len=cache_len, cache_mode=cache_mode),
        device="cuda")
    rng = np.random.default_rng(ENGINE_SEED + 2)
    for _ in range(4):
        engine.add_request(rng.integers(0, cfg.vocab_size, prompt_len).tolist(), 32)
    for _ in range(6):                       # 4 admissions, then decode only
        engine.step()
    torch.cuda.synchronize()
    return engine


def _timed_steps(engine, steps):
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _profiled(fn):
    """``fn()`` in a CPU + CUDA profiler window whose ends the card spends
    idle for ``StepProfiler``'s margin (``obs.profile.WINDOW_MARGIN_S``), so
    that no kernel lies near an end: for the windows whose kernel counts are
    gated exactly.  (``fn()``'s result, the profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.profile import WINDOW_MARGIN_S
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_MARGIN_S)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(WINDOW_MARGIN_S)
    return out, prof


def phase_profile(cfg, params, card, label, steps=5, prompt_len=64, cache_mode="paged"):
    """Device time by kernel over ``steps`` decode steps with 4 busy lanes of
    ``prompt_len``-token prompts; returns {"attn_ms": ``paged_attention``'s
    device time per step, "device_ms", "wall_ms", "busy", "groups"} per
    step, or None where the profiler recorded no device time.  A paged
    engine launches one ``paged_attention`` kernel per GQA layer and step
    (none for MLA), a slot engine none.

    Two engines fed the same requests do the same steps: the first is
    timed without the profiler (wall), the second under it (device time
    per kernel), so the busy share divides like by like."""
    wall_plain = _timed_steps(_busy_engine(cfg, params, prompt_len, cache_mode), steps)
    engine = _busy_engine(cfg, params, prompt_len, cache_mode)
    wall, prof = _profiled(lambda: _timed_steps(engine, steps))
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / steps   # ms per step
    label = f"{label}, {cache_mode} KV, {prompt_len}-token prompts"
    if not kernels or total <= 0:
        print(f"[profile] {label}: the profiler recorded no device time: breakdown not "
              f"measured", flush=True)
        return None
    step_ms, plain_ms = 1e3 * wall / steps, 1e3 * wall_plain / steps
    print(f"[profile] {label}, {steps} decode steps, 4 lanes: {total:.3f} ms/step device time; "
          f"wall {plain_ms:.3f} ms/step without the profiler (device busy "
          f"{100 * total / plain_ms:.1f}%), {step_ms:.3f} ms/step with it (busy "
          f"{100 * total / step_ms:.1f}%) [{card}]", flush=True)
    groups: dict[str, float] = {}
    for e in kernels:
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / steps
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {ms:.3f} ms/step ({100 * ms / total:.1f}% of device time) {g}",
              flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   top: {e.self_device_time_total / 1e3 / steps:.3f} ms/step, "
              f"{e.count // steps} launches/step  {e.key[:90]}", flush=True)
    attn = [e for e in kernels if "paged_attention_kernel" in e.key]
    n_attn = sum(e.count for e in attn)
    want_attn = _gemm_launches(cfg)[2] * steps if cache_mode == "paged" else 0
    require(n_attn == want_attn,
            f"{label}: {n_attn} paged_attention kernels in {steps} steps, want {want_attn}")
    attn_ms = groups.get("paged_attention kernel", 0.0)
    print(f"[profile]   paged_attention: {attn_ms:.4f} ms/step, {100 * attn_ms / total:.2f}% of "
          f"device time, {n_attn // steps} launches/step", flush=True)
    return {"attn_ms": attn_ms, "device_ms": total, "wall_ms": plain_ms,
            "busy": total / plain_ms, "groups": groups}


# ---------------------------------------------------------------------------
# 4b. slot-mode serving
# ---------------------------------------------------------------------------

def phase_slot(card, params, paged_rep):
    """Phase 4's traffic through slot-mode ``ServingEngine``s (int8, then
    bf16 slot KV): every request finishes; every projection launches
    ``spoga_gemm_dequant`` (112 a step: 7 per layer), ``paged_attention``
    never launches and no plain version runs; the decode profile of 4 busy
    lanes.  Returns the int8 run's GEMM launches and the profile."""
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-1b").with_(quant_mode="int8_spoga")
    arrivals = _traffic(8, cfg.vocab_size, ENGINE_SEED)
    out = {}
    for kv in ("int8", "bf16"):
        c = cfg.with_(kv_cache_dtype=kv)
        label = f"slot {kv} KV, 8 requests"
        reset_counts()
        engine, metrics = _serve(c, params, arrivals, 4, cache_mode="slot")
        launches, plain = read_counts()
        check_counts(launches, plain, ("spoga_gemm_dequant",), label)
        _check_finished(metrics, arrivals, cfg.vocab_size, label)
        rep = metrics.report()
        per_pass = 7 * cfg.n_layers
        require(launches["spoga_gemm_dequant"] == per_pass * (rep["decode_steps"] + rep["prefills"]),
                f"{label}: {launches['spoga_gemm_dequant']} GEMM launches, want {per_pass} per "
                f"decode step and per prefill")
        require(engine.store.pos.tolist() == [0] * 4, f"{label}: a free lane's pos drifted")
        print(f"[slot] {kv} KV: {rep['requests']} finished, {rep['generated_tokens']} tokens, "
              f"{rep['tokens_per_s']:.1f} tok/s, TTFT mean {1e3 * rep['ttft_mean_s']:.1f} ms, "
              f"decode step mean {1e3 * rep['decode_step_mean_s']:.2f} ms ({rep['decode_steps']} "
              f"steps, {launches['spoga_gemm_dequant']} spoga_gemm_dequant launches = "
              f"{per_pass} a step); paged int8 (phase 4): {paged_rep['tokens_per_s']:.1f} tok/s, "
              f"TTFT mean {1e3 * paged_rep['ttft_mean_s']:.1f} ms, decode step mean "
              f"{1e3 * paged_rep['decode_step_mean_s']:.2f} ms [{card}]", flush=True)
        out[kv] = launches["spoga_gemm_dequant"]
    prof = phase_profile(cfg.with_(kv_cache_dtype="int8"), params, card, "int8_spoga",
                         cache_mode="slot")
    return out, prof


SLOT_VS_PAGED_STEPS = 8


def _slot_vs_paged(cfg, params):
    """4 prompts of phase 4's traffic prefilled once each, their caches
    inserted into a slot cache and into a paged one (int8 KV), then
    SLOT_VS_PAGED_STEPS decode steps over each, both fed the paged run's
    greedy tokens.  Returns (max |logit diff| / max |logit| over the steps,
    greedy agreement, the steps' paged_attention launches)."""
    from repro_torch.configs import pages_for
    from repro_torch.models import decode_step, prefill
    from repro_torch.paging.cache import PagedCache
    from repro_torch.serving import SlotCache
    ps, cache_len, steps = 16, 176, SLOT_VS_PAGED_STEPS
    prompts = [p for _, p, _ in _traffic(8, cfg.vocab_size, ENGINE_SEED)][:4]
    slot = SlotCache(cfg, 4, cache_len, device="cuda")
    paged = PagedCache(cfg, 4, cache_len, ps, device="cuda")
    mgr = paged.manager
    first = []
    for lane, prompt in enumerate(prompts):
        single_len = pages_for(len(prompt), ps) * ps
        tokens = torch.zeros((1, single_len), dtype=torch.int32)
        tokens[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
        logits, single = prefill(params, cfg, {"tokens": tokens.cuda()}, single_len,
                                 lengths=torch.tensor([len(prompt)], dtype=torch.int32,
                                                      device="cuda"))
        slot.insert(single, lane)
        mgr.admit(lane, len(prompt) + steps + 1)
        ids = mgr.alloc(lane, single_len // ps)
        mgr.set_length(lane, len(prompt))
        paged.insert(single, lane, ids, len(prompt))
        first.append(int(logits.argmax(-1)[0]))
    tok = torch.tensor(first, dtype=torch.int32, device="cuda")
    active = torch.ones((4,), dtype=torch.bool, device="cuda")
    reset_counts()
    worst, agree = 0.0, 0
    for step in range(steps):
        for lane in range(4):
            mgr.ensure(lane, int(mgr.lengths[lane]) + 1)
        paged.sync_tables()
        lp, _ = decode_step(params, cfg, tok, paged.cache, active=active)
        ls, _ = decode_step(params, cfg, tok, slot.cache, active=active)
        mgr.advance(range(4))
        lp, ls = lp.float(), ls.float()
        require(bool(torch.isfinite(ls).all()), f"slot vs paged step {step}: slot logits "
                                                f"not finite")
        worst = max(worst, (lp - ls).abs().max().item() / lp.abs().max().item())
        agree += int((lp.argmax(-1) == ls.argmax(-1)).sum())
        tok = lp.argmax(-1).to(torch.int32)                # teacher: the paged stream
    torch.cuda.synchronize()
    launches, plain = read_counts()
    gemm = ("spoga_gemm_dequant",) if cfg.quant_mode == "int8_spoga" else ()
    check_counts(launches, plain, gemm + ("paged_attention",),
                 f"slot vs paged decode, {cfg.n_layers} layers, {cfg.quant_mode}")
    require(launches["paged_attention"] == cfg.n_layers * steps,
            f"slot vs paged: {launches['paged_attention']} paged_attention launches, want "
            f"{cfg.n_layers * steps} (the paged cache's steps only)")
    return worst, agree


def phase_slot_vs_paged(card, params):
    """Slot against paged decode inside the port, on the card, int8 KV.
    Paged attention is the kernel here, slot attention plain torch
    (bitwise equality is a CPU contract only).

    Held: phase 6's decode model (2 layers at full width, bf16 GEMMs,
    weights from seed 3), the logits within phase 6's LOGIT_TOL x max at
    every step.  Printed: the same model at ``int8_spoga`` and the full
    16-layer model at ``int8_spoga``, where every projection re-quantizes
    its input to int8 per row, so that a difference of one f32 ulp can move
    a value by a whole quantization step; card and CPU differ there by as
    much as slot and paged do."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("llama3.2-1b").with_(quant_mode="int8_spoga", kv_cache_dtype="int8")
    small = cfg.with_(quant_mode="bf16", n_layers=2)
    small_params = init_params(small, seed=3, device="cuda")
    n = 4 * SLOT_VS_PAGED_STEPS
    for c, p, what in ((small, small_params, "2 layers at full width, bf16 GEMMs"),
                       (small.with_(quant_mode="int8_spoga"), small_params,
                        "2 layers at full width, int8_spoga"),
                       (cfg, params, f"{cfg.n_layers} layers, int8_spoga, phase 4's weights")):
        worst, agree = _slot_vs_paged(c, p)
        print(f"[slot] slot vs paged, {what}, int8 KV, 4 lanes, {SLOT_VS_PAGED_STEPS} decode "
              f"steps fed the paged tokens: max |logit diff| {worst:.4g} x max |logit|, greedy "
              f"agreement {agree}/{n} [{card}]", flush=True)
        if c is small:
            require(worst <= LOGIT_TOL, f"slot vs paged: logits differ by {worst:.4g} x max > "
                                        f"{LOGIT_TOL}")


def phase_default_llm(card):
    """``LLM("llama3.2-1b").generate(...)`` with no runtime: bf16 GEMMs (no
    kernel of the port runs), slot bf16 KV, its own random weights."""
    from repro_torch.api import LLM
    prompts = [p for _, p, _ in _traffic(4, 128_256, ENGINE_SEED + 3)]
    t0 = time.perf_counter()
    llm = LLM("llama3.2-1b")
    require(llm.runtime.kv.mode == "slot" and llm.config.quant_mode == "bf16",
            "the default runtime is not slot KV with bf16 GEMMs")
    reset_counts()
    outs = llm.generate(prompts, max_new_tokens=12)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    check_counts(launches, plain, (), "default LLM")
    require(all(len(o.token_ids) == 12 and o.finish_reason == "length" for o in outs),
            "default LLM: a request did not finish")
    require(all(0 <= t < llm.config.vocab_size for o in outs for t in o.token_ids),
            "default LLM: token out of range")
    rep = llm.metrics.report()
    print(f"[default] LLM('llama3.2-1b').generate: {rep['requests']} prompts x 12 tokens on "
          f"{llm.device}, slot bf16 KV, bf16 GEMMs; {rep['tokens_per_s']:.1f} tok/s, decode "
          f"step mean {1e3 * rep['decode_step_mean_s']:.2f} ms; "
          f"{time.perf_counter() - t0:.1f} s with its init [{card}]", flush=True)
    del llm


LONG_PREFILL = 16_384


def phase_long_prefill(card, params):
    """Full-width llama3.2-1b prefills LONG_PREFILL tokens at ``int8_spoga``
    into an int8 cache: finite logits, time and peak memory.  Then
    ``multihead_attention`` alone at that length (B=1, 32/8 heads, D=64):
    64 query rows on and beside chunk edges equal those rows computed on
    their own (a one-row chunk at the row's offset) within one bf16 ulp of
    the output's largest magnitude (cuBLAS may sum a one-row product in
    another order)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import prefill
    cfg = get_config("llama3.2-1b").with_(quant_mode="int8_spoga", kv_cache_dtype="int8")
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, LONG_PREFILL))
                              .astype(np.int32)).cuda()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, {"tokens": tokens}, LONG_PREFILL)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches, plain = read_counts()
    check_counts(launches, plain, ("spoga_gemm_dequant",), f"{LONG_PREFILL}-token prefill")
    require(launches["spoga_gemm_dequant"] == 7 * cfg.n_layers,
            f"long prefill: {launches['spoga_gemm_dequant']} GEMM launches, want "
            f"{7 * cfg.n_layers}")
    require(tuple(logits.shape) == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
            "long prefill: logits not finite")
    require(int(cache["pos"][0]) == LONG_PREFILL, "long prefill: cache pos wrong")
    print(f"[long] llama3.2-1b full width, int8_spoga, int8 KV, {LONG_PREFILL}-token prefill: "
          f"{elapsed:.3f} s, logits finite, peak memory {peak / 2**30:.2f} GiB "
          f"({(peak - base) / 2**30:.2f} GiB above the weights and inputs) [{card}]", flush=True)
    del logits, cache

    g = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn((1, LONG_PREFILL, 32, 64), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((1, LONG_PREFILL, 8, 64), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = attn.multihead_attention(q, k, v)
    torch.cuda.synchronize()
    attn_s = time.perf_counter() - t0
    attn_peak = torch.cuda.max_memory_allocated() - base
    chunk = attn._pick_chunk(LONG_PREFILL)
    edges = range(chunk, LONG_PREFILL, chunk)
    rows = sorted({0, LONG_PREFILL - 1} | {e + d for e in edges for d in (-1, 0)})[:64]
    qg = q.reshape(1, LONG_PREFILL, 4, 8, 64)
    kf, vf = k.float(), v.float()
    want = torch.cat([attn._attend_chunk(qg[:, r:r + 1], kf, vf, r, v.dtype).reshape(1, 1, 32, 64)
                      for r in rows], dim=1).float()
    got = out[:, rows].float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    same = int((got == want).all(dim=-1).all(dim=-1).sum())
    require(bool(torch.isfinite(out.float()).all()), "16K attention: output not finite")
    require(err <= 2.0 ** -7 * scale, f"16K attention: chunked rows off their own by {err} > "
                                      f"{2.0 ** -7 * scale}")
    print(f"[long] multihead_attention B=1 S={LONG_PREFILL} 32/8 heads D=64: {chunk}-row chunks, "
          f"{attn_s:.3f} s, peak memory {attn_peak / 2**30:.2f} GiB above its inputs; {len(rows)} "
          f"rows on and beside chunk edges against their own one-row chunks: max |diff| "
          f"{err:.3g} (scale {scale:.3g}), {same} of {len(rows)} rows bitwise [{card}]",
          flush=True)
    return {"prefill_s": elapsed, "prefill_peak_gib": peak / 2**30, "attention_s": attn_s,
            "attention_peak_gib": attn_peak / 2**30, "attention_max_abs_err": err}


# ---------------------------------------------------------------------------
# 5. the paper's dataflows through the LLM facade
# ---------------------------------------------------------------------------

# (label, QuantRuntime arguments, the GEMM route its run must launch)
DATAFLOWS = [
    ("spoga fused", ("int8_spoga", None), ("spoga_gemm_dequant",)),
    ("spoga unfused", ("int8_spoga", "cuda_spoga"), ("spoga_gemm",)),
    ("deas", ("int8_deas", None), ("nibble_gemm", "deas_combine")),
    ("direct", ("int8_direct", None), ("torch._int_mm",)),
]
FACADE_NEW_TOKENS = 24
DATAFLOW_LAYERS = 2        # of llama3.2-1b's 16 in phase 5's dataflow runs


def phase_dataflows(card, params):
    """The same weights and prompts through one ``LLM`` per dataflow, in two
    rounds in opposite orders (so that drift on the card or its host shows
    as a difference between rounds); every kernel count is set to 0 just
    before each ``generate`` and read just after.  Returns {label: launches}
    of the first round."""
    from repro_torch.api import LLM, KVConfig, QuantRuntime, RuntimeConfig, SchedulerConfig
    from repro_torch.configs import default_cache_len, get_config
    prompts = [p for _, p, _ in _traffic(8, 128_256, ENGINE_SEED)]
    config = get_config("llama3.2-1b").with_(n_layers=DATAFLOW_LAYERS)
    cut = _first_layers(params, DATAFLOW_LAYERS)
    kv = KVConfig(mode="paged", dtype="int8", page_size=16,
                  cache_len=default_cache_len(128, 32))
    sched = SchedulerConfig(n_slots=4, prefill_buckets=(32, 64, 128))
    per_call = {"spoga_gemm_dequant": 1, "spoga_gemm": 1, "nibble_gemm": 4,
                "deas_combine": 1, "torch._int_mm": 1}
    first, counts = None, {}
    reports: dict[str, list] = {label: [] for label, _, _ in DATAFLOWS}
    for rnd, order in enumerate((DATAFLOWS, DATAFLOWS[::-1])):
        for label, (mode, backend), route in order:
            llm = LLM(config=config, params=cut, runtime=RuntimeConfig(
                quant=QuantRuntime(mode=mode, gemm_backend=backend), kv=kv, scheduler=sched))
            reset_counts()
            outs = llm.generate(prompts, max_new_tokens=FACADE_NEW_TOKENS)
            torch.cuda.synchronize()
            launches, plain = read_counts()
            check_counts(launches, plain, route + ("paged_attention",),
                         f"facade {label}, round {rnd + 1}")
            streams = [o.token_ids for o in outs]
            require(all(len(t) == FACADE_NEW_TOKENS and o.finish_reason == "length"
                        for t, o in zip(streams, outs)),
                    f"facade {label}: a request did not finish")
            require(all(0 <= t < llm.config.vocab_size for s in streams for t in s),
                    f"facade {label}: token out of range")
            if first is None:
                first = streams
                require(len({t for s in streams for t in s}) > 2, "facade streams collapsed")
            require(streams == first, f"facade {label}: greedy streams differ from the "
                                      f"first run's")
            rep = llm.metrics.report()
            gemms = 7 * llm.config.n_layers * (rep["decode_steps"] + rep["prefills"])
            for name in route:
                require(launches[name] == per_call[name] * gemms,
                        f"facade {label}: {name} launched {launches[name]}, want "
                        f"{per_call[name] * gemms}")
            counts.setdefault(label, launches)
            reports[label].append(rep)
            print(f"[facade] round {rnd + 1} {label} ({mode}, gemm_backend={backend}): "
                  f"{rep['requests']} finished, {rep['generated_tokens']} tokens, "
                  f"{rep['tokens_per_s']:.1f} tok/s, decode step mean "
                  f"{1e3 * rep['decode_step_mean_s']:.2f} ms ({rep['decode_steps']} steps), "
                  f"TTFT mean {1e3 * rep['ttft_mean_s']:.1f} ms, prefill total "
                  f"{rep['prefill_s']:.3f} s, defrag {rep['defrag_count']} times "
                  f"[{card}]", flush=True)
            del llm
    base = reports[DATAFLOWS[0][0]]
    for label, reps in reports.items():
        ratios = [(r["decode_step_mean_s"] / b["decode_step_mean_s"],
                   r["tokens_per_s"] / b["tokens_per_s"]) for r, b in zip(reps, base)]
        print(f"[facade] {label} against spoga fused, rounds 1 and 2: decode step "
              f"{', '.join(f'{d:.2f}x' for d, _ in ratios)}; tok/s "
              f"{', '.join(f'{t:.2f}x' for _, t in ratios)}", flush=True)
    print(f"[facade] 4 dataflows x 2 rounds, 8 prompts x {FACADE_NEW_TOKENS} tokens, "
          f"{DATAFLOW_LAYERS} of 16 layers: greedy streams identical", flush=True)
    for mode in ("int8_deas", "int8_direct"):
        phase_profile(get_config("llama3.2-1b").with_(quant_mode=mode, kv_cache_dtype="int8"),
                      params, card, mode)
    return counts


# ---------------------------------------------------------------------------
# 6. card against CPU
# ---------------------------------------------------------------------------

def _to_cpu(t):
    if isinstance(t, dict):
        return {k: _to_cpu(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_to_cpu(v) for v in t)
    return t.cpu()


def phase_cpu_parity():
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    cfg = get_config("llama3.2-1b").with_(quant_mode="int8_spoga", kv_cache_dtype="int8",
                                          n_layers=2)
    params = init_params(cfg, seed=3, device="cuda")
    cpu_params = _to_cpu(params)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32))
    t0 = time.perf_counter()
    got, _ = prefill(params, cfg, {"tokens": tokens.cuda()}, 16)
    got = got.cpu()
    want, _ = prefill(cpu_params, cfg, {"tokens": tokens}, 16)
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    top2 = torch.topk(want[0], 2).values
    print(f"[cpu] 2-layer full width, 16-token prefill: max |logit diff| {err:.4g} of "
          f"max |logit| {scale:.4g} (tolerance {LOGIT_TOL} x max), greedy token card "
          f"{int(got.argmax())} cpu {int(want.argmax())} (cpu top-2 margin "
          f"{(top2[0] - top2[1]).item():.4g}); {time.perf_counter() - t0:.1f} s", flush=True)
    require(bool(torch.isfinite(got).all()), "card logits not finite")
    require(int(got.argmax()) == int(want.argmax()), "first greedy token differs from the CPU's")
    require(err <= LOGIT_TOL * scale, f"card logits off the CPU's by {err} > {LOGIT_TOL * scale}")


LONG_PROMPT = 1000
LONG_STEPS = 4


def phase_cpu_long_decode(card):
    """Paged decode over a long context, card against CPU: the same 2-layer
    full-width model and int8 paged KV on both, a 1,000-token prompt, then
    LONG_STEPS decode steps fed the CPU's greedy tokens; the card's logits
    within LOGIT_TOL x max of the CPU's at every step.

    ``quant_mode="bf16"`` keeps the CPU's prefill of 1,000 tokens within
    seconds: the plain sliced GEMMs on the CPU would take minutes there.
    The card's decode attention is the ``paged_attention`` kernel over 8
    KV heads of one lane: the prompt gives every one of its splits (at most
    MAX_SPLITS; split r takes pages r, r + S, ...) at least 4 pages."""
    from repro_torch.configs import default_cache_len, get_config, pages_for
    from repro_torch.kernels import paged_attention as attn_mod
    from repro_torch.kernels.paged_attention import MAX_SPLITS
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.paging.cache import PagedCache
    cfg = get_config("llama3.2-1b").with_(quant_mode="bf16", kv_cache_dtype="int8", n_layers=2)
    ps = 16
    cache_len = default_cache_len(LONG_PROMPT, LONG_STEPS)
    require(LONG_PROMPT >= 4 * MAX_SPLITS * ps,
            f"the {LONG_PROMPT}-token prompt gives fewer than 4 pages to each of "
            f"{MAX_SPLITS} splits")
    params = init_params(cfg, seed=3, device="cuda")
    rng = np.random.default_rng(4)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, LONG_PROMPT)).astype(np.int32))
    single_len = pages_for(LONG_PROMPT, ps) * ps
    tokens = torch.zeros((1, single_len), dtype=torch.int32)
    tokens[0, :LONG_PROMPT] = prompt[0]
    lengths = torch.tensor([LONG_PROMPT], dtype=torch.int32)

    def start(device, p):
        store = PagedCache(cfg, n_lanes=1, cache_len=cache_len, page_size=ps, device=device)
        mgr = store.manager
        mgr.admit(0, LONG_PROMPT + LONG_STEPS)
        page_ids = mgr.alloc(0, single_len // ps)
        mgr.set_length(0, LONG_PROMPT)
        logits, single = prefill(p, cfg, {"tokens": tokens.to(device)}, single_len,
                                 lengths=lengths.to(device))
        store.insert(single, 0, page_ids, LONG_PROMPT)
        return store, logits

    def step(store, p, tok):
        mgr = store.manager
        mgr.ensure(0, int(mgr.lengths[0]) + 1)
        store.sync_tables()
        device = store.device
        logits, _ = decode_step(p, cfg, tok.to(device), store.cache,
                                active=torch.ones((1,), dtype=torch.bool, device=device))
        mgr.advance([0])
        return logits

    t0 = time.perf_counter()
    card_store, card_logits = start("cuda", params)
    cpu_params = _to_cpu(params)
    cpu_store, cpu_logits = start("cpu", cpu_params)
    agree, worst = 0, 0.0
    launches = attn_mod.LAUNCHES
    for i in range(LONG_STEPS + 1):
        got, want = card_logits.float().cpu(), cpu_logits.float()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        worst = max(worst, err / scale)
        require(bool(torch.isfinite(got).all()), f"long decode step {i}: card logits not finite")
        require(err <= LOGIT_TOL * scale, f"long decode step {i}: card logits off the CPU's by "
                                          f"{err} > {LOGIT_TOL * scale}")
        agree += int(got.argmax()) == int(want.argmax())
        if i == LONG_STEPS:
            break
        tok = want.argmax(dim=-1).to(torch.int32)          # the CPU's greedy token
        card_logits = step(card_store, params, tok)
        cpu_logits = step(cpu_store, cpu_params, tok)
    torch.cuda.synchronize()
    n_launch = attn_mod.LAUNCHES - launches
    require(n_launch == cfg.n_layers * LONG_STEPS,
            f"long decode: {n_launch} paged_attention launches, want {cfg.n_layers * LONG_STEPS}")
    print(f"[cpu] 2-layer full width, bf16 GEMMs, int8 paged KV, {LONG_PROMPT}-token prompt "
          f"({pages_for(LONG_PROMPT, ps)} pages) + {LONG_STEPS} decode steps fed the CPU's tokens: max "
          f"|logit diff| {worst:.4g} x max |logit| (tolerance {LOGIT_TOL}), greedy agreement "
          f"{agree}/{LONG_STEPS + 1}, {n_launch} kernel launches; "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)


# ---------------------------------------------------------------------------
# 7. engine features: checkpoint, chunked prefill, stacked admission, defrag
# ---------------------------------------------------------------------------

def _roundup(n: int, m: int) -> int:
    return -(-n // m) * m


def _leaves(tree):
    """(path, tensor) pairs of a parameter tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [(f"{k}.{p}", t) for k in sorted(tree) for p, t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}.{p}", t) for i, v in enumerate(tree) for p, t in _leaves(v)]
    return [("", tree)]


FEATURE_LAYERS = 2         # of llama3.2-1b's 16 in phases 7-8


def _feature_config():
    """Phases 7-8's model: llama3.2-1b at full width, ``FEATURE_LAYERS``
    layers (phase 4's weights cut to that depth, ``_first_layers``)."""
    from repro_torch.configs import get_config
    return get_config("llama3.2-1b").with_(n_layers=FEATURE_LAYERS)


def _first_layers(params, n):
    """The first ``n`` layers of a llama-layout tree (one block slot stacked
    over the periods, no lead or tail layers)."""
    from repro_torch.tree import tree_map
    return {**params, "blocks": tree_map(lambda t: t[:n], params["blocks"])}


def _feature_runtime(cache_len, page_size=16, prefix_cache=False, spec=None, kv_dtype="int8",
                     **sched):
    """``int8_spoga`` over paged KV (int8 unless ``kv_dtype`` says
    otherwise), 4 lanes unless ``sched`` says otherwise; the prefix cache
    and a ``SpecConfig`` on request."""
    from repro_torch.api import KVConfig, QuantRuntime, RuntimeConfig, SchedulerConfig, SpecConfig
    sched = {"n_slots": 4, "prefill_buckets": (32, 64, 128), **sched}
    return RuntimeConfig(quant=QuantRuntime(mode="int8_spoga"),
                         kv=KVConfig(mode="paged", dtype=kv_dtype, page_size=page_size,
                                     cache_len=cache_len, prefix_cache=prefix_cache),
                         scheduler=SchedulerConfig(**sched),
                         spec=spec if spec is not None else SpecConfig())


def phase_checkpoint(card, params, d):
    """(a) Phase 4's seed-0 full-width weights saved with the port's
    ``save_checkpoint`` into the temporary directory ``d`` (phase 8 (a)
    loads it again) and loaded by ``LLM(checkpoint_dir=)``: every tensor
    ``torch.equal`` to the one in memory.  Returns the loaded params and
    the numbers."""
    from repro_torch.api import LLM
    from repro_torch.checkpoint import save_checkpoint
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_checkpoint(d, 1, params, metadata={"arch": "llama3.2-1b", "seed": ENGINE_SEED})
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    t0 = time.perf_counter()
    llm = LLM(config=_feature_config(), runtime=_feature_runtime(512), checkpoint_dir=d)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got, want = _leaves(llm.params), _leaves(params)
    require([n for n, _ in got] == [n for n, _ in want], "checkpoint: leaf names differ")
    for (name, a), (_, b) in zip(got, want):
        require(a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b),
                f"checkpoint: {name} differs from the tensor in memory")
    print(f"[features] (a) checkpoint of llama3.2-1b full width: {len(got)} tensors, "
          f"{nbytes / 2**30:.3f} GiB written in {save_s:.2f} s, LLM(checkpoint_dir=) loaded "
          f"it onto the card in {load_s:.2f} s; every tensor equal [{card}]", flush=True)
    return llm.params, {"bytes": nbytes, "save_s": save_s, "load_s": load_s}


def _features_run(params, runtime, arrivals, label):
    """Serve ``arrivals`` through an ``LLM``'s engine with every kernel count
    at 0 just before; every request must finish, no plain version run, the
    pool end clean, and the kernels launch exactly as the path implies:
    ``spoga_gemm_dequant`` 7 times a layer for every decode step and every
    prefill dispatch (a chunk step or a stacked prefill is one dispatch),
    ``paged_attention`` once a layer for every decode step (chunk steps
    attend the gathered pages in plain torch).  Returns (engine, metrics,
    streams, launches)."""
    from repro_torch.api import LLM
    engine = LLM(config=_feature_config(), params=params, runtime=runtime).engine
    reset_counts()
    metrics = engine.run(arrivals)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    check_counts(launches, plain, ("spoga_gemm_dequant", "paged_attention"), label)
    rep, n_layers = metrics.report(), engine.cfg.n_layers
    expect_gemm = 7 * n_layers * (rep["decode_steps"] + rep["prefill_dispatches"])
    expect_attn = n_layers * rep["decode_steps"]
    require(launches["spoga_gemm_dequant"] == expect_gemm,
            f"{label}: GEMM launches {launches['spoga_gemm_dequant']} != {expect_gemm}")
    require(launches["paged_attention"] == expect_attn,
            f"{label}: attention launches {launches['paged_attention']} != {expect_attn}")
    streams = _check_finished(metrics, arrivals, engine.cfg.vocab_size, label)
    mgr = engine.store.manager
    mgr.check_invariants()
    require(mgr.pages_in_use == 0, f"{label}: pages leaked after the run")
    return engine, metrics, streams, launches


def _agreement(a: dict, b: dict) -> tuple[int, int]:
    same = sum(x == y for rid in a for x, y in zip(a[rid], b[rid]))
    return same, sum(len(s) for s in a.values())


def _long_traffic(vocab):
    """Seed 0: 2 prompts of 2,048-4,096 tokens at step 0, then 8 of 17-128
    tokens one a step from step 1; 16-32 new tokens each."""
    rng = np.random.default_rng(ENGINE_SEED)
    lens = [int(n) for n in rng.integers(2048, 4097, 2)] + [int(n) for n in
                                                            rng.integers(17, 129, 8)]
    gens = [int(g) for g in rng.integers(16, 33, 10)]
    return [(0 if i < 2 else i - 1, rng.integers(0, vocab, n).tolist(), g)
            for i, (n, g) in enumerate(zip(lens, gens))]


def phase_chunked(card, params):
    """(b) Chunked prefill: phase 7's long and short traffic on 4 lanes,
    ``prefill_chunk=CHUNK_M``, and again unchunked.  Gated: every request
    finishes in both, the chunk steps are sum(ceil(len / CHUNK_M)) over the
    long prompts, the kernels launch and no plain version runs.  Printed:
    the short requests' TTFT p50/p99, decode step mean, tok/s and the
    greedy agreement of the two runs."""
    arrivals = _long_traffic(128_256)
    longest = max(len(p) for _, p, _ in arrivals)
    # long enough for the longest prompt's budget and for its last padded chunk
    cache_len = max(longest + 32, _roundup(longest, CHUNK_M))
    want_chunks = sum(-(-len(p) // CHUNK_M) for _, p, _ in arrivals[:2])
    out = {}
    for label, chunk in (("chunked", CHUNK_M), ("unchunked", None)):
        engine, metrics, streams, launches = _features_run(
            params, _feature_runtime(cache_len, prefill_chunk=chunk), arrivals,
            f"features {label}")
        rep = metrics.report()
        require(rep["chunk_steps"] == (want_chunks if chunk else 0),
                f"{label}: {rep['chunk_steps']} chunk steps, want {want_chunks if chunk else 0}")
        short = [r.ttft_s for r in metrics.finished if r.req_id >= 2]
        p50, p99 = (float(np.percentile(short, q)) for q in (50, 99))
        out[label] = dict(streams=streams, launches=launches, ttft_short_p50_s=p50,
                          ttft_short_p99_s=p99, report=rep)
        print(f"[features] (b) {label} (prefill_chunk={chunk}), 2 prompts of "
              f"{[len(p) for _, p, _ in arrivals[:2]]} tokens + 8 short, 4 lanes, cache_len "
              f"{cache_len}: {rep['requests']} finished, {rep['chunk_steps']} chunk steps, "
              f"{rep['prefill_dispatches']} prefill dispatches; short requests' TTFT p50 "
              f"{1e3 * p50:.1f} ms, p99 {1e3 * p99:.1f} ms; decode step mean "
              f"{1e3 * rep['decode_step_mean_s']:.2f} ms ({rep['decode_steps']} steps), "
              f"per-token latency p99 {1e3 * rep['per_token_p99_s']:.1f} ms; "
              f"{rep['tokens_per_s']:.1f} tok/s; defrag {rep['defrag_count']} times; launches "
              f"spoga_gemm_dequant {launches['spoga_gemm_dequant']}, paged_attention "
              f"{launches['paged_attention']} [{card}]", flush=True)
        del engine
    same, total = _agreement(out["chunked"]["streams"], out["unchunked"]["streams"])
    print(f"[features] (b) chunked against unchunked, greedy agreement {same}/{total} "
          f"(int8_spoga; chunks attend the dequantized int8 pages, the one-shot prefill "
          f"its bf16 K/V)", flush=True)
    return out


def phase_stacked(card, params):
    """(c) Stacked admission: 8 prompts of 33-64 tokens (bucket 64) at step
    0, 4 lanes, ``batched_admission=True``, 2 dispatches a step.  Gated:
    fewer dispatches than prefills, at least 2 stacked prefills, every
    request finished, the kernels launched and no plain version.  Printed:
    the greedy agreement with the same run unstacked."""
    rng = np.random.default_rng(ENGINE_SEED + 7)
    arrivals = [(0, rng.integers(0, 128_256, int(n)).tolist(), int(g))
                for n, g in zip(rng.integers(33, 65, 8), rng.integers(16, 33, 8))]
    from repro_torch.configs import default_cache_len
    out = {}
    for label, stacked in (("stacked", True), ("unstacked", False)):
        _, metrics, streams, launches = _features_run(
            params, _feature_runtime(default_cache_len(128, 32), batched_admission=stacked,
                                     max_prefills_per_step=2), arrivals, f"features {label}")
        rep = metrics.report()
        if stacked:
            require(rep["prefill_dispatches"] < rep["prefills"] and rep["stacked_prefills"] >= 2,
                    f"stacked: {rep['prefill_dispatches']} dispatches for {rep['prefills']} "
                    f"prefills, {rep['stacked_prefills']} stacked")
        out[label] = dict(streams=streams, launches=launches, report=rep)
        print(f"[features] (c) {label}: {rep['requests']} finished, {rep['prefills']} prefills in "
              f"{rep['prefill_dispatches']} dispatches ({rep['stacked_prefills']} stacked), TTFT "
              f"mean {1e3 * rep['ttft_mean_s']:.1f} ms, {rep['tokens_per_s']:.1f} tok/s; launches "
              f"spoga_gemm_dequant {launches['spoga_gemm_dequant']} [{card}]", flush=True)
    same, total = _agreement(out["stacked"]["streams"], out["unstacked"]["streams"])
    print(f"[features] (c) stacked against unstacked, greedy agreement {same}/{total}",
          flush=True)
    return out


def phase_defrag(card, params):
    """(d) Defrag: the traffic of ``tests/test_api.py::
    test_defrag_policy_triggers_and_is_output_invisible`` (3 lanes, pages of
    8 rows, cache_len 32; a short request ends early while later lanes
    hold higher pages) at full width, threshold 0.05 against None.  Gated:
    at least one compaction moving at least one page, the page bookkeeping
    consistent, and the greedy streams bitwise equal on and off: defrag
    only renames pages, and ``paged_attention`` splits a lane's pages by
    their index in its table, so it reads the same rows in the same order."""
    rng = np.random.default_rng(0)
    arrivals = [(0, rng.integers(0, 128_256, 14).tolist(), 2),
                (0, rng.integers(0, 128_256, 12).tolist(), 10),
                (1, rng.integers(0, 128_256, 9).tolist(), 8)]
    out = {}
    for label, threshold in (("on", 0.05), ("off", None)):
        _, metrics, streams, launches = _features_run(
            params, _feature_runtime(32, page_size=8, n_slots=3, prefill_buckets=None,
                                     defrag_threshold=threshold), arrivals, f"defrag {label}")
        out[label] = dict(streams=streams, launches=launches, report=metrics.report())
    on, off = out["on"]["report"], out["off"]["report"]
    require(on["defrag_count"] >= 1 and on["defrag_pages_moved"] >= 1,
            f"defrag: {on['defrag_count']} compactions, {on['defrag_pages_moved']} pages moved")
    require(off["defrag_count"] == 0, "defrag off compacted")
    require(out["on"]["streams"] == out["off"]["streams"],
            "defrag changed a greedy stream")
    print(f"[features] (d) defrag at threshold 0.05: {on['defrag_count']} compactions, "
          f"{on['defrag_pages_moved']} pages moved; greedy streams bitwise equal to defrag off "
          f"({sum(len(s) for s in out['on']['streams'].values())} tokens) [{card}]", flush=True)
    return out


def _bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at ``|x|`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def _chunked_and_one_shot(cfg, params, prompt, chunk):
    """Last-token logits of ``prompt`` through ``make_chunk_step`` (chunks
    of ``chunk`` into a paged cache) and through one ``model.prefill``."""
    from repro_torch.models import prefill
    from repro_torch.paging import PagedCache, make_chunk_step
    n, ps = len(prompt), 16
    store = PagedCache(cfg, 1, _roundup(n, chunk), ps, device="cuda")
    mgr = store.manager
    mgr.admit(0, _roundup(n, chunk))
    step = make_chunk_step(cfg, chunk)
    for start in range(0, n, chunk):
        k = min(chunk, n - start)
        mgr.ensure(0, start + chunk)
        store.sync_tables()
        tokens = torch.zeros((1, chunk), dtype=torch.int32)
        tokens[0, :k] = torch.tensor(prompt[start:start + k], dtype=torch.int32)
        chunked = step(params, store.cache, tokens.cuda(), 0, start, k)
    tokens = torch.zeros((1, _roundup(n, ps)), dtype=torch.int32)
    tokens[0, :n] = torch.tensor(prompt, dtype=torch.int32)
    one_shot, _ = prefill(params, cfg, {"tokens": tokens.cuda()}, tokens.shape[1],
                          lengths=torch.tensor([n], dtype=torch.int32, device="cuda"))
    return chunked.float(), one_shot.float()


def _stacked_and_solo(cfg, params, prompts, padded):
    """Last-token logits of ``prompts`` prefilled as one batch and each alone
    (right-padded to ``padded``)."""
    from repro_torch.models import prefill
    tokens = torch.zeros((len(prompts), padded), dtype=torch.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    stacked, _ = prefill(params, cfg, {"tokens": tokens.cuda()}, padded,
                         lengths=lengths.cuda())
    solo = torch.cat([prefill(params, cfg, {"tokens": tokens[i:i + 1].cuda()}, padded,
                              lengths=lengths[i:i + 1].cuda())[0] for i in range(len(prompts))])
    return stacked.float(), solo.float()


def phase_feature_parity(card, params):
    """Chunked against one-shot prefill and stacked against batch=1, on the
    card, where another M or key length may sum in another order (the CPU
    tests hold both bitwise): on phase 6's model (2 layers at full width,
    bf16 GEMMs, bf16 pool, seed 3) the last-token logits within LOGIT_TOL
    of their largest magnitude; at full width and ``int8_spoga`` (phase 4's
    weights, bf16 pool) printed, not gated (per-row int8 re-quantization
    amplifies one-ulp differences, ROADMAP queue 3).  On the 2-layer model
    the greedy tokens are gated too: a row may flip only where its
    reference top-2 margin is at most ``NEAR_TIE_ULPS`` bf16 ulps of its top
    logit (a near-tie that one rounding in another order decides, ROADMAP
    queue 3); every flip is printed with its margin."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    full = _feature_config().with_(quant_mode="int8_spoga")
    small = full.with_(quant_mode="bf16", n_layers=2)
    small_params = init_params(small, seed=3, device="cuda")
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, full.vocab_size, 1000).tolist()
    prompts = [rng.integers(0, full.vocab_size, n).tolist() for n in (40, 50, 61, 64)]
    out = {}
    for c, p, what in ((small, small_params, "2 layers, bf16 GEMMs"),
                       (full, params, f"{full.n_layers} layers, int8_spoga")):
        for kind, (got, want) in (("chunked 256 vs one-shot, 1,000 tokens",
                                   _chunked_and_one_shot(c, p, prompt, 256)),
                                  ("4 stacked vs batch=1, 40-64 tokens",
                                   _stacked_and_solo(c, p, prompts, 64))):
            err = (got - want).abs().max().item() / want.abs().max().item()
            flips = (got.argmax(-1) != want.argmax(-1)).nonzero().flatten().tolist()
            top2 = torch.topk(want, 2, dim=-1).values
            margins = [(top2[r, 0] - top2[r, 1]).item() for r in flips]
            ulps = [m / _bf16_ulp(top2[r, 0].item()) for r, m in zip(flips, margins)]
            require(bool(torch.isfinite(got).all()), f"{what}, {kind}: logits not finite")
            print(f"[features] {what}, bf16 pool, {kind}: max |logit diff| {err:.4g} x max "
                  f"|logit| ({want.abs().max().item():.4g}), greedy "
                  f"{got.shape[0] - len(flips)}/{got.shape[0]}"
                  + (f"; rows {flips} flip on top-2 margins {[f'{m:.4g}' for m in margins]} "
                     f"({[f'{u:.3g}' for u in ulps]} bf16 ulps)" if flips else "")
                  + f" [{card}]", flush=True)
            if c is small:
                require(err <= LOGIT_TOL, f"{what}, {kind}: logits differ by {err:.4g} x max "
                                          f"(tolerance {LOGIT_TOL})")
                wide = [(r, u) for r, u in zip(flips, ulps) if u > NEAR_TIE_ULPS]
                require(not wide, f"{what}, {kind}: greedy token flips on rows whose top-2 "
                                  f"margin is more than {NEAR_TIE_ULPS} bf16 ulps: {wide}")
            out[f"{what}: {kind}"] = {"max_rel_diff": err, "flipped_rows": flips,
                                      "flip_margins": margins, "flip_margin_ulps": ulps}
    del small_params
    return out


def phase_features(card, params, ckpt_dir):
    """Phase 7: (a) checkpoint (into ``ckpt_dir``), (b) chunked prefill, (c)
    stacked admission, (d) defrag, each on the weights loaded in (a); then
    the card-side parity of chunking and stacking."""
    loaded, ckpt = phase_checkpoint(card, params, ckpt_dir)
    out = {"checkpoint": ckpt, "chunked": phase_chunked(card, loaded),
           "stacked": phase_stacked(card, loaded), "defrag": phase_defrag(card, loaded),
           "parity": phase_feature_parity(card, params)}
    del loaded
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 8. presets, the prefix cache, speculative decoding, stochastic sampling
# ---------------------------------------------------------------------------

SPEC_K = 4
PREFIX_LEN = 1024
PREFIX_CHUNK = 128
STOCHASTIC = dict(greedy=False, temperature=0.8, top_k=20, seed=5)


class ScriptedDrafter:
    """A drafter whose proposals are a function of the lane's history (the
    oracle and the adversary of phase 8 (c))."""

    def __init__(self, fn, k):
        self.fn, self.k = fn, k

    def admit(self, slot, history):
        pass

    def release(self, slot):
        pass

    def propose(self, slots, histories):
        return [list(self.fn(h))[:self.k] for h in histories]


def _oracle(arrivals, streams):
    """Proposes each request's spec-off stream from where its history is."""
    refs = {tuple(p): streams[rid] for rid, (_, p, _) in enumerate(arrivals)}

    def fn(hist):
        for p, ref in refs.items():
            if tuple(hist[:len(p)]) == p:
                return ref[len(hist) - len(p):]
        raise AssertionError("history matches no request")
    return fn


def _counted(engine, label, drive):
    """Run ``drive(engine)`` (it returns the metrics) with every kernel
    count at 0 just before and read just after.  Gated exactly over the
    steps the drive takes: a verify dispatch is one decode step, and
    ``spoga_gemm_dequant`` launches for every decode step and every prefill
    dispatch of the target as often as ``_gemm_launches`` counts for its
    stack (7 a layer for llama), plus a decode step's count of the draft
    model for every dispatch the draft model makes; ``paged_attention``
    once a GQA layer for every decode step of a paged engine, never in
    slot mode (chunk steps, slot caches and the draft
    model's slot cache attend in plain torch); no plain version runs.  An
    engine left without work holds no page but the prefix tree's.
    Returns (metrics, launches)."""
    drafter = engine._drafter
    d0 = getattr(drafter, "dispatches", 0)
    m0 = engine.metrics
    steps0, prefills0 = m0.decode_steps, m0.prefill_dispatches
    reset_counts()
    metrics = drive(engine)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    per_step, per_prefill, attn_layers = _gemm_launches(engine.cfg)
    expect = (("spoga_gemm_dequant", "paged_attention") if engine.paged and attn_layers
              else ("spoga_gemm_dequant",))
    check_counts(launches, plain, expect, label)
    steps = metrics.decode_steps - steps0
    draft = getattr(drafter, "dispatches", 0) - d0
    # a draft-model dispatch (admission or step) runs every draft layer's
    # projections once; the draft models here are GQA stacks
    draft_gemms = _gemm_launches(drafter.cfg)[0] if draft else 0
    expect_gemm = (per_step * steps + per_prefill * (metrics.prefill_dispatches - prefills0)
                   + draft_gemms * draft)
    expect_attn = attn_layers * steps if engine.paged else 0
    require(launches["spoga_gemm_dequant"] == expect_gemm,
            f"{label}: GEMM launches {launches['spoga_gemm_dequant']} != {expect_gemm}")
    require(launches["paged_attention"] == expect_attn,
            f"{label}: attention launches {launches['paged_attention']} != {expect_attn}")
    if engine.paged:
        mgr = engine.store.manager
        mgr.check_invariants()
        tree = engine.prefix.cached_pages if engine.prefix is not None else 0
        require(engine.has_work or mgr.pages_in_use == tree,
                f"{label}: {mgr.pages_in_use} pages held after the run, the prefix tree "
                f"holds {tree}")
    return metrics, launches


def _spec_engine(params, cache_len, spec=None, config=None, **kw):
    """An ``int8_spoga`` paged engine through ``LLM`` of ``config`` (default:
    phases 7-8's llama, ``_feature_config``)."""
    from repro_torch.api import LLM
    named = dict(config=config if config is not None else _feature_config())
    return LLM(**named, params=params, device="cuda",
               runtime=_feature_runtime(cache_len, spec=spec, **kw)).engine


def _top2(logits) -> tuple[int, float]:
    """(argmax, top-2 margin in bf16 ulps of the top logit) of a logits row."""
    top2 = torch.topk(logits.float(), 2)
    v = top2.values
    return int(top2.indices[0]), (v[0] - v[1]).item() / _bf16_ulp(v[0].item())


def _margins(engine, params, prompt, stream, idx, bucket=None, chunk=None):
    """Token ``idx`` of ``stream`` recomputed teacher-forced on both paths,
    on the engine's geometry (its lane count, table width and page size,
    so ``paged_attention`` splits as in the run) with lane 0 active and the
    others idle.  The prompt prefills in one shot to ``bucket`` rows, or in
    chunks of ``chunk`` tokens.  "decode": the stream fed one token a step
    (for idx 0, the prefill's logits); "verify" (idx > 0): a window
    ``[stream[idx-1], stream[idx:idx+k]]`` at the token's position.
    Returns {path: (argmax, top-2 margin in bf16 ulps)}."""
    from repro_torch.models import decode_step, prefill, verify_step
    from repro_torch.paging import make_chunk_step
    from repro_torch.paging.cache import PagedCache
    cfg, ecfg = engine.cfg, engine.engine_cfg
    ps, n = ecfg.page_size, ecfg.n_slots
    width = engine._spec.width if engine._spec is not None else SPEC_K + 1
    store = PagedCache(cfg, n, ecfg.cache_len, ps, device="cuda")
    mgr = store.manager
    mgr.admit(0, ecfg.cache_len)
    if chunk is None:
        single = _roundup(bucket, ps)
        tokens = torch.zeros((1, single), dtype=torch.int32)
        tokens[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
        logits, cache = prefill(params, cfg, {"tokens": tokens.cuda()}, single,
                                lengths=torch.tensor([len(prompt)], dtype=torch.int32,
                                                     device="cuda"))
        ids = mgr.alloc(0, single // ps)
        store.insert(cache, 0, ids, len(prompt))
    else:
        step = make_chunk_step(cfg, chunk)
        for start in range(0, len(prompt), chunk):
            k = min(chunk, len(prompt) - start)
            mgr.ensure(0, start + chunk)
            store.sync_tables()
            tokens = torch.zeros((1, chunk), dtype=torch.int32)
            tokens[0, :k] = torch.tensor(prompt[start:start + k], dtype=torch.int32)
            logits = step(params, store.cache, tokens.cuda(), 0, start, k)
    mgr.set_length(0, len(prompt))
    logits = logits[0]
    active = torch.zeros(n, dtype=torch.bool, device="cuda")
    active[0] = True

    def feed(t):
        mgr.ensure(0, int(mgr.lengths[0]) + 1)
        store.sync_tables()
        tok = torch.zeros(n, dtype=torch.int32, device="cuda")
        tok[0] = t
        out, _ = decode_step(params, cfg, tok, store.cache, active=active)
        mgr.advance([0])
        return out[0]

    rows = {}
    for t in stream[:max(idx - 1, 0)]:
        logits = feed(t)
    if idx > 0:
        mgr.ensure(0, int(mgr.lengths[0]) + width)
        store.sync_tables()
        window = torch.zeros((n, width), dtype=torch.int32)
        tail = stream[idx - 1:idx - 1 + width]
        window[0, :len(tail)] = torch.tensor(tail, dtype=torch.int32)
        out, _ = verify_step(params, cfg, window.cuda(), store.cache, active=active)
        rows["verify"] = out[0, 0]
        logits = feed(stream[idx - 1])
    rows["decode"] = logits
    return {path: _top2(row) for path, row in rows.items()}


def _bucket(prompt):
    return next(bk for bk in (32, 64, 128, len(prompt)) if bk >= len(prompt))


def _margin_text(margins):
    return ", ".join(f"{path} path argmax {tok}, margin {ulps:.3g} bf16 ulps"
                     for path, (tok, ulps) in margins.items())


def _hold_streams(got, want, label, arrivals, engine, params, chunk=None):
    """Greedy streams must be equal.  Where a request's stream diverges on
    the card, the divergence is accepted only on a near-tie row: the top-2
    margin there at most NEAR_TIE_ULPS bf16 ulps on both the decode and the
    verify path (``_margins``; phase 7's rule: the logits head is a library
    bf16 product whose summation order may change with M).  Prompts
    prefill in one shot to the phase's buckets, or in chunks of ``chunk``.
    Returns the accepted divergences."""
    near = []
    for rid in want:
        a, b = got[rid], want[rid]
        if a == b:
            continue
        idx = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        require(idx < min(len(a), len(b)),
                f"{label}: request {rid} differs at token {idx} ({len(a)} vs {len(b)} tokens)")
        prompt = arrivals[rid][1]
        margins = _margins(engine, params, prompt, b, idx, bucket=_bucket(prompt), chunk=chunk)
        ulps = max(u for _, u in margins.values())
        print(f"[spec] {label}: request {rid} diverges at token {idx} ({a[idx]} vs {b[idx]}); "
              f"recomputed: {_margin_text(margins)}", flush=True)
        require(ulps <= NEAR_TIE_ULPS, f"{label}: request {rid} diverges at token {idx} on a "
                                       f"row whose top-2 margin is {ulps:.3g} bf16 ulps")
        near.append((rid, idx, ulps))
    return near


def phase_presets(card, ckpt_dir):
    """(a) ``int8-byte-serving`` written with ``to_dict`` to a JSON file and
    loaded back with ``load_runtime``; ``LLM(runtime=load_runtime(name),
    checkpoint_dir=)`` on phase 7 (a)'s checkpoint serves phase 4's 8
    prompts (the preset's own 16-token chunks and prefix cache)."""
    import tempfile
    from repro_torch.api import LLM, get_preset, load_runtime
    preset = get_preset("int8-byte-serving")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rt_") as d:
        path = Path(d) / "int8-byte-serving.json"
        path.write_text(json.dumps(preset.to_dict()))
        require(load_runtime(str(path)) == preset, "preset: the JSON round trip differs")
    llm = LLM(config=_feature_config(), runtime=load_runtime("int8-byte-serving"),
              checkpoint_dir=ckpt_dir)
    engine = llm.build_engine(128, 32)
    arrivals = _traffic(8, engine.cfg.vocab_size, ENGINE_SEED)
    metrics, launches = _counted(engine, "preset int8-byte-serving",
                                 lambda e: e.run(arrivals))
    _check_finished(metrics, arrivals, engine.cfg.vocab_size, "preset")
    rep = metrics.report()
    print(f"[spec] (a) preset int8-byte-serving: JSON round trip equal; LLM(runtime="
          f"load_runtime(...), checkpoint_dir=) served {rep['requests']} requests "
          f"({rep['generated_tokens']} tokens, cache_len {engine.engine_cfg.cache_len}, chunk "
          f"{engine._chunk_len}): {rep['chunk_steps']} chunk steps, {rep['decode_steps']} decode "
          f"steps, prefix hits {rep['prefix_hits']}, {rep['tokens_per_s']:.1f} tok/s; launches "
          f"spoga_gemm_dequant {launches['spoga_gemm_dequant']}, paged_attention "
          f"{launches['paged_attention']} [{card}]", flush=True)
    del llm
    return {"launches": launches, "report": rep}


def _prefix_traffic(vocab):
    """8 prompts of a shared PREFIX_LEN-token prefix (seed 1) + a distinct
    16-64-token suffix (request 3's: 48 tokens, a whole number of pages),
    one a step; then request 3's prompt again (a full-prompt hit).  16 new
    tokens each."""
    rng = np.random.default_rng(ENGINE_SEED + 1)
    shared = rng.integers(0, vocab, PREFIX_LEN).tolist()
    tails = [int(n) for n in rng.integers(16, 65, 8)]
    tails[3] = 48
    prompts = [shared + rng.integers(0, vocab, n).tolist() for n in tails]
    return [(i, p, 16) for i, p in enumerate(prompts)] + [(8, prompts[3], 16)]


def phase_prefix(card, params):
    """(b) The shared-prefix traffic with the prefix cache on and off, both
    at ``prefill_chunk=PREFIX_CHUNK`` (every prompt is longer than a chunk,
    so every cold admission is chunked either way).  Gated: the greedy
    streams equal, at least 7 hits and a CoW fork with the cache on."""
    arrivals = _prefix_traffic(128_256)
    # a full-prompt hit resumes at the last prompt token and runs a whole
    # chunk from there: the table must reach one chunk past the longest prompt
    cache_len = PREFIX_LEN + 64 + PREFIX_CHUNK
    out = {}
    for label, on in (("on", True), ("off", False)):
        engine = _spec_engine(params, cache_len, prefill_chunk=PREFIX_CHUNK,
                              prefill_buckets=None, prefix_cache=on)
        metrics, launches = _counted(engine, f"prefix cache {label}", lambda e: e.run(arrivals))
        streams = _check_finished(metrics, arrivals, 128_256, f"prefix {label}")
        rep = metrics.report()
        out[label] = dict(streams=streams, launches=launches, report=rep)
        print(f"[spec] (b) prefix cache {label}: 9 requests over a {PREFIX_LEN}-token shared "
              f"prefix, chunk {PREFIX_CHUNK}: hits {rep['prefix_hits']}, hit tokens "
              f"{rep['prefix_hit_tokens']}, CoW forks {rep['prefix_cow_forks']}, tree pages "
              f"{rep['prefix_tree_pages']}, {rep['chunk_steps']} chunk steps, TTFT p50 "
              f"{1e3 * rep['ttft_p50_s']:.1f} ms, p99 {1e3 * rep['ttft_p99_s']:.1f} ms, "
              f"{rep['tokens_per_s']:.1f} tok/s; spoga_gemm_dequant launches "
              f"{launches['spoga_gemm_dequant']} [{card}]", flush=True)
        del engine
    on = out["on"]["report"]
    require(on["prefix_hits"] >= 7 and on["prefix_cow_forks"] >= 1,
            f"prefix cache: {on['prefix_hits']} hits, {on['prefix_cow_forks']} CoW forks")
    require(out["on"]["streams"] == out["off"]["streams"],
            "prefix cache: greedy streams differ with the cache on and off")
    print(f"[spec] (b) prefix cache on against off: greedy streams bitwise equal "
          f"({sum(len(s) for s in out['on']['streams'].values())} tokens)", flush=True)
    out["arrivals"] = arrivals
    out["cache_len"] = cache_len
    return out


def phase_spec(card, params, prefix):
    """(c) Phase 4's traffic with ``SpecConfig(enabled=True, k=SPEC_K)``: the
    n-gram drafter, the draft-model drafter (2 layers), an oracle that
    proposes the spec-off stream and an adversary that proposes (true +
    1) mod vocab, against the same traffic with speculation off.  Gated:
    the greedy streams equal the spec-off ones (near-tie rows excepted, see
    ``_hold_streams``), the oracle accepts every draft it proposes and the
    adversary none, the launch counts (``_counted``).  Then (b)'s traffic
    with the prefix cache and the n-gram drafter against (b)'s cache-off
    spec-off streams, and slot-mode speculation (printed, not gated)."""
    from repro_torch.configs import default_cache_len, get_config
    from repro_torch.spec import SpecConfig
    cfg = _feature_config().with_(quant_mode="int8_spoga", kv_cache_dtype="int8")
    arrivals = _traffic(8, cfg.vocab_size, ENGINE_SEED)
    cache_len = default_cache_len(128, 32)
    off_engine = _spec_engine(params, cache_len)
    off, off_launches = _counted(off_engine, "spec off", lambda e: e.run(arrivals))
    base = _check_finished(off, arrivals, cfg.vocab_size, "spec off")
    # the near-tie recomputation on a row that did not diverge: both paths
    # give the run's token unless the row is a near tie
    prompt0 = arrivals[0][1]
    probe = _margins(off_engine, params, prompt0, base[0], 5, bucket=_bucket(prompt0))
    for path, (tok, ulps) in probe.items():
        require(tok == base[0][5] or ulps <= NEAR_TIE_ULPS,
                f"near-tie recomputation, {path} path: token {tok}, the run's {base[0][5]}")
    print(f"[spec] (c) near-tie recomputation of request 0, token 5 ({base[0][5]}), teacher-forced "
          f"on spec off's geometry: {_margin_text(probe)}", flush=True)
    del off_engine
    spec = SpecConfig(enabled=True, k=SPEC_K)
    runs = {"off": dict(report=off.report(), launches=off_launches)}
    oracle = _oracle(arrivals, base)
    for label, sc, drafter in (
            ("ngram", spec, None),
            ("draft model", SpecConfig(enabled=True, k=SPEC_K, drafter="model",
                                       draft_layers=2), None),
            ("oracle", spec, ScriptedDrafter(oracle, SPEC_K)),
            ("adversarial", spec, ScriptedDrafter(
                lambda h: [(t + 1) % cfg.vocab_size for t in oracle(h)], SPEC_K))):
        engine = _spec_engine(params, cache_len, spec=sc)
        if drafter is not None:
            engine._drafter = drafter
        metrics, launches = _counted(engine, f"spec {label}", lambda e: e.run(arrivals))
        streams = _check_finished(metrics, arrivals, cfg.vocab_size, f"spec {label}")
        near = _hold_streams(streams, base, f"spec {label}", arrivals, engine, params)
        rep = metrics.report()
        require(rep["verify_dispatches"] > 0, f"spec {label}: never verified")
        if label == "oracle":
            require(rep["spec_accepted"] == rep["spec_proposed"] > 0,
                    f"oracle: {rep['spec_accepted']} of {rep['spec_proposed']} drafts accepted")
        if label == "adversarial":
            require(rep["spec_accepted"] == 0 < rep["spec_proposed"],
                    f"adversary: {rep['spec_accepted']} drafts accepted")
        accept_mean = metrics.registry.histogram("accept_len").mean
        runs[label] = dict(report=rep, launches=launches, near_ties=near,
                           accept_len_mean=accept_mean,
                           draft_dispatches=getattr(engine._drafter, "dispatches", 0))
        print(f"[spec] (c) {label}, k={SPEC_K}: {rep['tokens_per_s']:.1f} tok/s (spec off "
              f"{runs['off']['report']['tokens_per_s']:.1f}), decode step mean "
              f"{1e3 * rep['decode_step_mean_s']:.2f} ms (off "
              f"{1e3 * runs['off']['report']['decode_step_mean_s']:.2f}), {rep['decode_steps']} "
              f"steps (off {runs['off']['report']['decode_steps']}), verify dispatches "
              f"{rep['verify_dispatches']}, proposed {rep['spec_proposed']}, accepted "
              f"{rep['spec_accepted']}, mean accept length {accept_mean:.3f}; launches "
              f"spoga_gemm_dequant {launches['spoga_gemm_dequant']}, paged_attention "
              f"{launches['paged_attention']}; streams equal to spec off"
              + (f" except {len(near)} near-tie divergences" if near else "")
              + f" [{card}]", flush=True)
        del engine

    pre = prefix["arrivals"]
    engine = _spec_engine(params, prefix["cache_len"], spec=spec,
                          prefill_chunk=PREFIX_CHUNK, prefill_buckets=None, prefix_cache=True)
    metrics, launches = _counted(engine, "prefix cache + ngram spec", lambda e: e.run(pre))
    streams = _check_finished(metrics, pre, cfg.vocab_size, "prefix + spec")
    near = _hold_streams(streams, prefix["off"]["streams"], "prefix cache + speculation", pre,
                         engine, params, chunk=PREFIX_CHUNK)
    rep = metrics.report()
    runs["prefix + ngram"] = dict(report=rep, launches=launches, near_ties=near)
    print(f"[spec] (c) (b)'s traffic, prefix cache + n-gram speculation: streams equal to (b)'s "
          f"cache-off spec-off run" + (f" except {len(near)} near-tie divergences" if near else "")
          + f"; hits {rep['prefix_hits']}, CoW forks "
          f"{rep['prefix_cow_forks']}, verify dispatches {rep['verify_dispatches']}, proposed "
          f"{rep['spec_proposed']}, accepted {rep['spec_accepted']}, {rep['tokens_per_s']:.1f} "
          f"tok/s [{card}]", flush=True)
    del engine

    from repro_torch.serving import EngineConfig, ServingEngine
    streams = {}
    for label, sc in (("off", None), ("oracle", spec)):
        engine = ServingEngine(cfg, params, EngineConfig(
            n_slots=4, page_size=16, prefill_buckets=(32, 64, 128), cache_len=cache_len,
            cache_mode="slot", spec=sc), device="cuda")
        if sc is not None:
            engine._drafter = ScriptedDrafter(oracle, SPEC_K)
        metrics, _ = _counted(engine, f"slot spec {label}", lambda e: e.run(arrivals))
        streams[label] = _check_finished(metrics, arrivals, cfg.vocab_size, f"slot spec {label}")
        del engine
    same, total = _agreement(streams["oracle"], streams["off"])
    print(f"[spec] (c) slot-mode speculation (torch attention both ways), oracle drafter: "
          f"greedy agreement with slot spec off {same}/{total} (printed, not gated) [{card}]",
          flush=True)
    runs["slot agreement"] = (same, total)
    return runs


def phase_sampling(card, params):
    """(d) On phase 7's model a stochastic request (temperature 0.8, top_k
    20, seed 5) served alone and again, submitted first, beside three
    neighbours (two greedy, one stochastic with seed 9) that share its
    prefills and decode steps.  Gated: the two streams identical, the same
    seed twice the same stream, ``top_k=1`` the greedy stream up to the
    first row whose top two logits are equal (``top_k`` keeps every value
    at or above the k-th largest, as the reference does, so there it may
    draw either: the rows the sampler saw are kept, and the margin of the
    row where the streams part is printed); under speculation the mixed
    batch decodes plainly (no verify dispatch) and its streams equal spec
    off."""
    import dataclasses
    from repro_torch.configs import default_cache_len
    from repro_torch.serving import SamplingParams
    from repro_torch.serving import engine as engine_mod
    from repro_torch.spec import SpecConfig
    sto = SamplingParams(**STOCHASTIC)
    rng = np.random.default_rng(ENGINE_SEED + 5)
    prompts = [rng.integers(0, 128_256, int(n)).tolist() for n in (70, 33, 101, 48)]
    cache_len = default_cache_len(128, 32)

    def serve(reqs, spec=None):
        engine = _spec_engine(params, cache_len, spec=spec)
        out = []

        def drive(e):
            out.extend(e.add_request(p, g, sampling=sp) for p, g, sp in reqs)
            while e.has_work:
                e.step()
            return e.metrics

        metrics, _ = _counted(engine, f"sampling, {len(reqs)} requests"
                              + (", spec on" if spec is not None else ""), drive)
        return [r.output_tokens for r in out], metrics

    def solo(sampling):
        return serve([(prompts[0], 24, sampling)])[0][0]

    alone = solo(sto)
    mixed_reqs = [(prompts[0], 24, sto), (prompts[1], 12, None),
                  (prompts[2], 12, dataclasses.replace(sto, seed=9)), (prompts[3], 12, None)]
    mixed, _ = serve(mixed_reqs)
    greedy = solo(None)
    require(mixed[0] == alone, "sampling: the stream changed beside neighbours")
    require(solo(sto) == alone, "sampling: the same seed gave another stream")
    rows = []     # the logits row the sampler saw for each token of the top_k=1 stream
    draw = engine_mod.sample_tokens

    def spy(logits, temperature, top_k, greedy_, keys):
        lane = next(i for i, (k, g) in enumerate(zip(top_k, greedy_)) if k == 1 and not g)
        rows.append(logits[lane].float().cpu())
        return draw(logits, temperature, top_k, greedy_, keys)

    engine_mod.sample_tokens = spy
    try:
        top1 = solo(dataclasses.replace(sto, top_k=1))
    finally:
        engine_mod.sample_tokens = draw
    require(len(rows) == len(top1), f"sampling: {len(rows)} rows seen for {len(top1)} tokens")
    tie = "no tie"
    if top1 != greedy:
        idx = next(i for i, (a, b) in enumerate(zip(top1, greedy)) if a != b)
        row = rows[idx]
        _, ulps = _top2(row)
        both = bool(row[top1[idx]] == row.max() and row[greedy[idx]] == row.max())
        tie = (f"parts from greedy at token {idx} ({top1[idx]} vs {greedy[idx]}), on a row "
               f"whose top-2 margin is {ulps:.3g} bf16 ulps, both tokens "
               f"{'at' if both else 'not both at'} its maximum")
        print(f"[spec] (d) top_k=1 {tie}", flush=True)
        require(ulps == 0 and both, f"sampling: top_k=1 is not the greedy stream: it {tie}")
    require(alone != greedy, "sampling: the stochastic stream is the greedy one")
    spec_mixed, m = serve(mixed_reqs, spec=SpecConfig(enabled=True, k=SPEC_K))
    require(m.verify_dispatches == 0, f"sampling: {m.verify_dispatches} verify dispatches "
                                      f"in a batch with stochastic lanes")
    require(spec_mixed == mixed, "sampling: spec on changed a mixed batch's streams")
    print(f"[spec] (d) stochastic sampling (T 0.8, top_k 20, seed 5, 24 tokens): alone == beside "
          f"3 neighbours == again; top_k=1 == greedy ({tie}); {len(set(alone))} distinct tokens; "
          f"under "
          f"spec the mixed batch ran {m.decode_steps} plain decode steps, 0 verify dispatches, "
          f"streams equal [{card}]", flush=True)
    return {"distinct_tokens": len(set(alone))}


def _verify_busy_engine(cfg, params):
    """4 lanes of 64-token prompts decoding, speculation on with an oracle
    that always proposes SPEC_K tokens (any tokens: the timing is the
    window's, whatever is accepted)."""
    from repro_torch.configs import default_cache_len
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.spec import SpecConfig
    engine = ServingEngine(cfg, params, EngineConfig(
        n_slots=4, page_size=16, prefill_buckets=(64,), cache_len=default_cache_len(128, 96),
        spec=SpecConfig(enabled=True, k=SPEC_K), cache_mode="paged"), device="cuda")
    engine._drafter = ScriptedDrafter(lambda h: [int(t) for t in h[-SPEC_K:]], SPEC_K)
    rng = np.random.default_rng(ENGINE_SEED + 2)

    def drive(e):
        for _ in range(4):
            e.add_request(rng.integers(0, cfg.vocab_size, 64).tolist(), 90)
        for _ in range(6):
            e.step()
        return e.metrics

    _counted(engine, "verify profile set-up", drive)
    return engine


def _counted_steps(engine, steps, label):
    """``_timed_steps`` under ``_counted``; returns the wall time."""
    wall = []

    def drive(e):
        wall.append(_timed_steps(e, steps))
        return e.metrics

    _counted(engine, label, drive)
    return wall[0]


def phase_verify_profile(card, params):
    """(e) Device time by kernel group and wall time of verify steps (4
    lanes, k=SPEC_K) beside the decode profile of the same lanes; then
    ``spoga_gemm_dequant`` at the window's M = 4 * (SPEC_K + 1) = 20 (K=2048,
    N=8192) and ``paged_attention`` at 20 lanes whose tables repeat in
    groups of 5 (split count chosen for 4 lanes), each against the plain
    version, its bound and the library call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain
    from repro_torch.kernels.spoga_gemm_dequant import (
        spoga_gemm_dequant,
        spoga_gemm_dequant_plain,
    )
    cfg = _feature_config().with_(quant_mode="int8_spoga", kv_cache_dtype="int8")
    steps = 4
    wall_plain = _counted_steps(_verify_busy_engine(cfg, params), steps, "verify steps")
    engine = _verify_busy_engine(cfg, params)
    v0 = engine.metrics.verify_dispatches
    wall, prof = _profiled(lambda: _counted_steps(engine, steps, "verify steps, profiled"))
    require(engine.metrics.verify_dispatches - v0 == steps, "verify profile: not all verify steps")
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    out = {"verify_wall_ms": 1e3 * wall_plain / steps, "verify_wall_profiled_ms": 1e3 * wall / steps}
    if kernels and total > 0:
        groups: dict[str, float] = {}
        for e in kernels:
            g = _kernel_group(e.key)
            groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / steps
        n_attn = sum(e.count for e in kernels if "paged_attention_kernel" in e.key)
        require(n_attn == cfg.n_layers * steps, f"verify profile: {n_attn} paged_attention "
                                                f"kernels in {steps} verify steps")
        out.update(verify_device_ms=total, groups=groups)
        print(f"[spec] (e) verify step, 4 lanes, k={SPEC_K}: {total:.3f} ms/step device time, "
              f"wall {out['verify_wall_ms']:.3f} ms/step (device busy "
              f"{100 * total / out['verify_wall_ms']:.1f}%) [{card}]", flush=True)
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"[spec]   {ms:.3f} ms/step ({100 * ms / total:.1f}%) {g}", flush=True)
    else:
        print("[spec] (e) verify profile: the profiler recorded no device time: not measured",
              flush=True)
    del engine
    out["decode_profile"] = phase_profile(cfg, params, card, "int8_spoga (beside the verify)",
                                          steps=steps)

    gen = torch.Generator(device="cuda").manual_seed(9)
    m, k, n = 4 * (SPEC_K + 1), 2048, 8192
    spec, x, w, xs, ws = _gemm_operands(m, k, n, "int8_spoga", gen)
    kw = dict(n_x_slices=spec.n_a_slices, n_w_slices=spec.n_w_slices, slice_bits=spec.slice_bits)
    got = spoga_gemm_dequant(x, w, xs, ws, **kw)
    require(torch.equal(got, spoga_gemm_dequant_plain(x, w, xs, ws)), "GEMM at M=20 differs")
    nb = copies_for(w.numel())
    w_copies = [w.clone() for _ in range(nb)]
    t_kernel, t_event = kernel_times(lambda i: spoga_gemm_dequant(x, w_copies[i], xs, ws, **kw),
                                     nb, iters=40, kernel="spoga_gemm_dequant_kernel")
    t_plain = time_ms(lambda i: spoga_gemm_dequant_plain(x, w_copies[i], xs, ws), nb, iters=5,
                      warmup=1)
    t_lib = _lib_int_mm(x, w_copies, m, k, n)
    b_ms, b_by = bound(x.numel() + w.numel() + 4 * (m + n) + 4 * m * n,
                       _int_product_ops(m, k, n), INT8_OPS_PER_S)
    out["gemm"] = dict(shape=f"W8A8 M={m} K={k} N={n}", ms=t_kernel, event_ms=t_event,
                       plain_ms=t_plain, library_ms=t_lib, library=_lib_label(m, k, n),
                       bound_ms=b_ms, bound_by=b_by, fraction_of_bound=b_ms / t_kernel)
    print(f"[spec] (e) spoga_gemm_dequant at the verify window's M={m} K={k} N={n}: bitwise equal "
          f"to the plain version; kernel {t_kernel:.4f} ms device ({t_event:.4f} ms by events), "
          f"plain {t_plain:.4f} ms, _int_mm {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
          f"{b_ms / t_kernel:.1%} of it) [{card}]", flush=True)
    del w_copies

    shape = ATTN_SHAPES["main"]
    b, w_ = shape["b"], SPEC_K + 1
    pos = [p - 1 for p in ATTN_MAIN_LENGTHS]
    verify_lengths = [p + 1 + c for p in pos for c in range(w_)]
    attn = {}
    for kind in ("bf16", "int8"):
        q, kp, vp, tables, _, scales, _ = _attn_case(
            kind, gen, shape, [p + w_ for p in pos])
        qv = torch.randn((b * w_,) + tuple(q.shape[1:]), generator=gen, device="cuda").bfloat16()
        vt = tables.repeat_interleave(w_, dim=0).contiguous()
        vl = torch.tensor(verify_lengths, dtype=torch.int32, device="cuda")
        got = paged_attention(qv, kp, vp, vt, vl, split_lanes=b, **scales)
        want = paged_attention_plain(qv, kp, vp, vt, vl, **scales)
        qb = qv.reshape(b, w_, *qv.shape[1:])
        for c_ in range(w_):
            step = paged_attention(qb[:, c_].contiguous(), kp, vp, tables,
                                   torch.tensor([p + 1 + c_ for p in pos], dtype=torch.int32,
                                                device="cuda"), **scales)
            require(torch.equal(got.reshape(b, w_, *got.shape[1:])[:, c_], step),
                    f"verify attention {kind}: row {c_} differs from the decode call")
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        require(torch.allclose(got, want, **ATTN_TOL), f"verify attention {kind}: |diff| {err}")
        t_kernel, t_event = kernel_times(
            lambda i: paged_attention(qv, kp, vp, vt, vl, split_lanes=b, **scales), 1, iters=200)
        t_plain = time_ms(lambda i: paged_attention_plain(qv, kp, vp, vt, vl, **scales), 1,
                          iters=20, warmup=1)
        t_lib = _sdpa_ms(qv, kp, vp, vt, vl) if kind == "bf16" else None
        b_ms, b_by = _attn_bound(qv, kp, vt, vl, scales, group=w_)
        attn[kind] = dict(shape=f"{kind} pool, {b * w_} lanes (4 tables x {w_}), "
                                f"lengths {verify_lengths}", ms=t_kernel, event_ms=t_event,
                          plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                          fraction_of_bound=b_ms / t_kernel, max_abs_err=err)
        lib = f"{t_lib:.4f} ms" if t_lib is not None else "n/a"
        print(f"[spec] (e) paged_attention {kind} verify layout ({b * w_} lanes, split count of "
              f"{b}): rows bitwise equal to the {w_} decode calls, max |diff| to plain {err:.3g}; "
              f"kernel {t_kernel:.4f} ms device ({t_event:.4f} ms by events), plain "
              f"{t_plain:.4f} ms, sdpa {lib}, bound {b_ms:.5f} ms ({b_by}, each table read "
              f"once; {b_ms / t_kernel:.1%} of it) [{card}]", flush=True)
    out["attn"] = attn

    # what the window's column-by-column norms cost a verify step: the
    # host's launch rate of back-to-back calls at the window's shape
    from repro_torch.models.layers import rmsnorm, rmsnorm_columns
    xw = torch.randn((b, w_, cfg.d_model), generator=gen, device="cuda").bfloat16()
    gamma = torch.rand(cfg.d_model, generator=gen, device="cuda") + 0.5
    t_cols = time_ms(lambda i: rmsnorm_columns(xw, gamma, cfg.norm_eps), 1, iters=200)
    t_rows = time_ms(lambda i: rmsnorm(xw, gamma, cfg.norm_eps), 1, iters=200)
    n_norms = 2 * cfg.n_layers + 1
    extra = n_norms * (t_cols - t_rows)
    out["norms"] = dict(columns_ms=t_cols, rmsnorm_ms=t_rows, norms_per_step=n_norms,
                        extra_ms_per_step=extra)
    print(f"[spec] (e) verify-window norm ({b}x{w_}x{cfg.d_model}): rmsnorm_columns "
          f"{t_cols:.4f} ms a call, rmsnorm {t_rows:.4f} ms (events, back-to-back); "
          f"{n_norms} norms a verify step: {extra:.3f} ms more a step, "
          f"{extra / out['verify_wall_ms']:.1%} of the verify step's wall "
          f"{out['verify_wall_ms']:.3f} ms [{card}]", flush=True)
    return out


def phase_busy_chunking(card, params):
    """(b') 4 short requests (17-128 tokens, 128 new tokens each) decode
    when a 3,790-token prompt arrives at step 8; 5 lanes, chunked at
    CHUNK_M and again unchunked.  Gated: every request finishes and the
    launch counts hold (``_counted``).  Printed: decode step mean,
    per-token p99, and the longest gap between two tokens of a short
    request."""
    rng = np.random.default_rng(ENGINE_SEED + 11)
    shorts = [rng.integers(0, 128_256, int(n)).tolist() for n in rng.integers(17, 129, 4)]
    long_prompt = rng.integers(0, 128_256, 3790).tolist()
    cache_len = max(3790 + 16, _roundup(3790, CHUNK_M))
    out = {}
    for label, chunk in (("chunked", CHUNK_M), ("unchunked", None)):
        engine = _spec_engine(params, cache_len, n_slots=5, prefill_chunk=chunk,
                              prefill_buckets=None)

        stamps = {i: [] for i in range(4)}

        def drive(e):
            for i, p in enumerate(shorts):
                e.add_request(p, 128, on_token=lambda t, i=i: stamps[i].append(
                    time.perf_counter()))
            for _ in range(8):
                e.step()
            e.add_request(long_prompt, 16)
            while e.has_work:
                e.step()
            return e.metrics

        metrics, launches = _counted(engine, f"busy {label}", drive)
        require(len(metrics.finished) == 5
                and all(len(r.output_tokens) == r.max_new_tokens for r in metrics.finished),
                f"busy {label}: not every request finished")
        rep = metrics.report()
        gap = max(max(b - a for a, b in zip(st, st[1:])) for st in stamps.values())
        out[label] = dict(report=rep, launches=launches, max_gap_s=gap)
        print(f"[spec] (b') {label} (prefill_chunk={chunk}): 4 short requests decoding, a "
              f"3,790-token prompt at step 8: decode step mean "
              f"{1e3 * rep['decode_step_mean_s']:.2f} ms ({rep['decode_steps']} steps), "
              f"per-token p99 {1e3 * rep['per_token_p99_s']:.1f} ms, longest gap between two "
              f"tokens of a short request {1e3 * gap:.1f} ms, {rep['chunk_steps']} chunk steps; "
              f"launches spoga_gemm_dequant {launches['spoga_gemm_dequant']}, paged_attention "
              f"{launches['paged_attention']} [{card}]", flush=True)
        del engine
    return out


def phase_spec_serving(card, params, ckpt_dir):
    """Phase 8 on phase 7's model (``params``): (a) presets, (b) the prefix
    cache, (c) speculation, (d) stochastic sampling, (e) the verify step's
    time profile; then (b') chunked prefill under busy decode."""
    out = {"presets": phase_presets(card, ckpt_dir),
           "prefix": phase_prefix(card, params)}
    out["spec"] = phase_spec(card, params, out["prefix"])
    out["sampling"] = phase_sampling(card, params)
    out["profile"] = phase_verify_profile(card, params)
    out["busy_chunking"] = phase_busy_chunking(card, params)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 9. the attention-family archs: MLA and the routed-expert FFN
# ---------------------------------------------------------------------------

# (K, N) of every projection the three archs run at int8_spoga, by arch
ARCH_KN = {
    "minicpm3-4b": [(2560, 768), (768, 3840), (2560, 256), (2560, 32), (2560, 2560),
                    (2560, 6400), (6400, 2560), (256, 2560)],
    "deepseek-moe-16b": [(2048, 2048), (2048, 10944), (10944, 2048), (2048, 2816),
                         (2816, 2048)],
    "granite-moe-3b-a800m": [(1536, 1536), (1536, 512)],
}


# Depth cuts (never width) that make room for phase 13 within the script's
# time budget: each arch keeps its full width, block pattern and layer
# kinds (recurrentgemma keeps its two-layer tail after whole periods);
# every launch gate is computed from the cut config
MLA_LAYERS = 2            # of minicpm3-4b's 62
DEEPSEEK_LAYERS = 4       # of deepseek-moe-16b's 28: 1 dense + 3 MoE (8 in PRs 20-22)
GRANITE_LAYERS = 4        # of granite-moe-3b-a800m's 32
RECURRENTGEMMA_LAYERS = 8  # of recurrentgemma-9b's 38: 2 periods + the 2-layer tail
LLAVA_LAYERS = 4          # of llava-next-mistral-7b's 32
SEAMLESS_LAYERS = 4       # of seamless-m4t-large-v2's 24 encoder and 24 decoder layers
XLSTM_LAYERS = 4          # of xlstm-125m's 12: one period, 3 mLSTM + 1 sLSTM


def _arch_params(arch, n_layers=None, config=None):
    """Full-width ``arch`` weights from ``init_params(seed=0)`` on the card,
    at ``n_layers`` (default: the config's depth), or of ``config``."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = config if config is not None else get_config(arch)
    cfg = cfg if n_layers is None else cfg.with_(n_layers=n_layers)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=ENGINE_SEED, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    print(f"[archs] {arch} full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n / 1e9:.3f} B parameters, {nbytes / 2**30:.2f} GiB, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return params


def _arch_run(card, engine, arrivals, label):
    """``_counted`` over ``engine.run(arrivals)``: every request finished,
    the exact launch counts; one line of its numbers.  Returns (streams,
    report, launches)."""
    torch.cuda.reset_peak_memory_stats()
    metrics, launches = _counted(engine, label, lambda e: e.run(arrivals))
    streams = _check_finished(metrics, arrivals, engine.cfg.vocab_size, label)
    rep = metrics.report()
    print(f"[archs] {label}: {rep['requests']} requests, {rep['generated_tokens']} tokens, "
          f"{rep['tokens_per_s']:.2f} tok/s, TTFT mean {1e3 * rep['ttft_mean_s']:.1f} ms, "
          f"decode step mean {1e3 * rep['decode_step_mean_s']:.2f} ms ({rep['decode_steps']} "
          f"steps, {rep['prefill_dispatches']} prefill dispatches, {rep['chunk_steps']} chunk "
          f"steps); launches spoga_gemm_dequant {launches['spoga_gemm_dequant']}, "
          f"paged_attention {launches['paged_attention']}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
    return streams, rep, launches


def phase_mla(card):
    """(a) minicpm3-4b at full width, MLA_LAYERS of its 62 layers,
    ``int8_spoga`` paged (the latent pages are bf16): phase 4's traffic; ``LLM("minicpm3-4b")`` with the default
    runtime; 512-token chunks against one-shot on phase 7 (b)'s long
    prompts; the prefix cache on and off on phase 8 (b)'s traffic; n-gram
    speculation (k=4) against off.  Greedy streams equal (a flip only on a
    near-tie row, ``_hold_streams``); prefix on/off bitwise."""
    from repro_torch.api import LLM
    from repro_torch.configs import default_cache_len
    from repro_torch.spec import SpecConfig
    from repro_torch.configs import get_config
    arch = "minicpm3-4b"
    config = get_config(arch).with_(n_layers=MLA_LAYERS)
    params = _arch_params(arch, MLA_LAYERS)
    vocab = config.vocab_size
    arrivals = _traffic(8, vocab, ENGINE_SEED)
    kw = dict(config=config, kv_dtype="bf16")
    out = {}
    engine = _spec_engine(params, default_cache_len(128, 32), **kw)
    engine_cfg = engine.cfg
    base, out["paged"], launches = _arch_run(card, engine, arrivals, f"{arch} paged")
    out["launches"] = launches
    del engine

    prompts = [p for _, p, _ in arrivals]
    llm = LLM(config=config, params=params, device="cuda")
    require(llm.runtime.kv.mode == "slot" and llm.config.quant_mode == "bf16",
            "the default runtime is not slot KV with bf16 GEMMs")
    reset_counts()
    outs = llm.generate(prompts, max_new_tokens=16)
    torch.cuda.synchronize()
    check_counts(*read_counts(), (), f"LLM('{arch}') default")
    require(all(len(o.token_ids) == 16 for o in outs), "default LLM: a request did not finish")
    rep = llm.metrics.report()
    print(f"[archs] LLM('{arch}').generate, default runtime (slot bf16 KV, bf16 GEMMs): "
          f"{rep['requests']} prompts x 16 tokens, {rep['tokens_per_s']:.2f} tok/s, decode "
          f"step mean {1e3 * rep['decode_step_mean_s']:.2f} ms, no kernel launched [{card}]",
          flush=True)
    out["slot default"] = rep
    del llm

    long = _long_traffic(vocab)[:2]
    longest = max(len(p) for _, p, _ in long)
    cache_len = max(longest + 32, _roundup(longest, CHUNK_M))
    runs = {}
    for label, chunk in (("one-shot", None), ("chunked", CHUNK_M)):
        engine = _spec_engine(params, cache_len, prefill_chunk=chunk, **kw)
        runs[label] = _arch_run(card, engine, long, f"{arch} {label}, prompts of "
                                f"{[len(p) for _, p, _ in long]} tokens")
        if label == "chunked":
            near = _hold_streams(runs["chunked"][0], runs["one-shot"][0],
                                 f"{arch} chunked against one-shot", long, engine, params)
            out["chunked near ties"] = near
        del engine
    out["chunked"] = runs["chunked"][1]

    pre = _prefix_traffic(vocab)
    cache_len = PREFIX_LEN + 64 + PREFIX_CHUNK
    runs = {}
    for label, on in (("off", False), ("on", True)):
        engine = _spec_engine(params, cache_len, prefill_chunk=PREFIX_CHUNK,
                              prefill_buckets=None, prefix_cache=on, **kw)
        runs[label] = _arch_run(card, engine, pre, f"{arch} prefix cache {label}")
        del engine
    on = runs["on"][1]
    require(on["prefix_hits"] >= 7 and on["prefix_cow_forks"] >= 1,
            f"{arch} prefix cache: {on['prefix_hits']} hits, {on['prefix_cow_forks']} forks")
    require(runs["on"][0] == runs["off"][0],
            f"{arch}: greedy streams differ with the prefix cache on and off")
    print(f"[archs] {arch} prefix cache on against off: streams bitwise equal, "
          f"{on['prefix_hits']} hits, {on['prefix_cow_forks']} CoW forks, TTFT p50 "
          f"{1e3 * on['ttft_p50_s']:.1f} / {1e3 * runs['off'][1]['ttft_p50_s']:.1f} ms", flush=True)
    out["prefix"] = {k: v[1] for k, v in runs.items()}

    # the n-gram drafter, and an oracle that proposes the spec-off stream so
    # that every verify window holds k + 1 rows (random weights give the
    # n-gram lookup little to match)
    out["spec"] = {}
    for label, drafter in (("n-gram", None),
                           ("oracle", ScriptedDrafter(_oracle(arrivals, base), SPEC_K))):
        engine = _spec_engine(params, default_cache_len(128, 32),
                              spec=SpecConfig(enabled=True, k=SPEC_K), **kw)
        if drafter is not None:
            engine._drafter = drafter
        streams, rep, _ = _arch_run(card, engine, arrivals,
                                    f"{arch} {label} speculation k={SPEC_K}")
        require(rep["verify_dispatches"] > 0, f"{arch} {label}: never verified")
        if drafter is not None:
            require(rep["spec_accepted"] == rep["spec_proposed"] > 0,
                    f"{arch} oracle: {rep['spec_accepted']} of {rep['spec_proposed']} accepted")
        near = _hold_streams(streams, base, f"{arch} {label} speculation", arrivals, engine,
                             params)
        print(f"[archs] {arch} {label} speculation against off: streams equal"
              + (f" except {len(near)} near-tie divergences" if near else "")
              + f"; {rep['verify_dispatches']} verifies, {rep['spec_proposed']} proposed, "
              f"{rep['spec_accepted']} accepted, {rep['tokens_per_s']:.2f} tok/s (off "
              f"{out['paged']['tokens_per_s']:.2f})", flush=True)
        out["spec"][label] = dict(report=rep, near_ties=near)
        del engine
    out["profile"] = phase_profile(engine_cfg, params, card, f"{arch} int8_spoga", steps=3)
    del params
    torch.cuda.empty_cache()
    return out


def _moe_profile(cfg, params, card):
    """A deepseek decode step's device time split: the profile of 4 busy
    lanes by kernel group (``phase_profile``), and per MoE layer at the
    step's shape (4 rows) the grouped expert product with its per-call
    weight quantization, the routing (router, top-k, sort-based dispatch,
    combine) and the attention block, each by ``device_ms``, times the
    layers that run it."""
    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models.transformer import period_params
    prof = phase_profile(cfg, params, card, f"{cfg.name} int8_spoga", steps=3)
    p = period_params(params["blocks"][0], 0)
    x = torch.randn((4, 1, cfg.d_model), device="cuda").to(torch.bfloat16)
    m = cfg.moe
    cap = moe.capacity(cfg, 1)
    buf = torch.randn((4, m.num_experts, cap, cfg.d_model), device="cuda").to(torch.bfloat16)
    glu_ms = device_ms(lambda i: moe._grouped_glu(buf, p["moe"], cfg.act, cfg.quant_mode), 1,
                       iters=5, warmup=1)
    # routing alone: moe_ffn without shared experts, the grouped product
    # replaced by the identity on the dispatch buffer for this measurement
    routed_only = cfg.with_(moe=dataclasses.replace(m, num_shared_experts=0))
    grouped = moe._grouped_glu
    moe._grouped_glu = lambda buf_, *_: buf_
    try:
        route_ms = device_ms(lambda i: moe.moe_ffn(x, p["moe"], routed_only), 1, iters=10)
    finally:
        moe._grouped_glu = grouped
    from repro_torch.models.layers import glu_mlp
    shared_ms = device_ms(lambda i: glu_mlp(x, p["moe"]["shared"], cfg.act, cfg.quant_mode),
                          1, iters=5, warmup=1)
    from repro_torch.paging.cache import PagedCache
    store = PagedCache(cfg.with_(n_layers=2), 4, 168, 16, device="cuda")
    for lane in range(4):
        store.manager.admit(lane, 168)
        store.manager.ensure(lane, 101)
    store.sync_tables()
    layer = period_params(store.cache["blocks"][0], 0)
    pos = torch.full((4,), 100, dtype=torch.int32, device="cuda")
    attn_ms = device_ms(lambda i: attn.paged_attention_decode(
        x, p["attn"], cfg, layer, pos, store.cache["block_tables"]), 1, iters=10)
    n_moe = cfg.n_layers - m.first_k_dense
    split = {"grouped expert product (per-call weight quantization included)": n_moe * glu_ms,
             "routing, dispatch and combine": n_moe * route_ms,
             "shared experts (3 spoga_gemm_dequant each)": n_moe * shared_ms,
             "attention block (4 spoga_gemm_dequant + paged_attention + RoPE)":
                 cfg.n_layers * attn_ms}
    for what, ms in split.items():
        print(f"[archs] deepseek decode step, 4 rows: {ms:.3f} ms {what} [{card}]", flush=True)
    return {"profile": prof, "split_ms": split}


def phase_moe(card, arch, n_requests, kv_dtype, n_layers=None):
    """(b)/(c) A MoE arch at full width, ``int8_spoga`` over paged KV:
    phase 4's traffic (its first ``n_requests``); the engine refuses
    chunked prefill, the prefix cache and speculation; deepseek adds its
    peak memory and a decode-step profile."""
    from repro_torch.configs import default_cache_len
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.spec import SpecConfig
    from repro_torch.configs import get_config
    params = _arch_params(arch, n_layers)
    config = get_config(arch) if n_layers is None else get_config(arch).with_(n_layers=n_layers)
    engine = _spec_engine(params, default_cache_len(128, 32), config=config, kv_dtype=kv_dtype)
    cfg = engine.cfg
    arrivals = _traffic(8, cfg.vocab_size, ENGINE_SEED)[:n_requests]
    _, rep, launches = _arch_run(card, engine, arrivals, f"{arch} paged {kv_dtype} KV")
    out = {"report": rep, "launches": launches,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del engine
    for kw, match in (({"cache_mode": "paged", "prefill_chunk": 512}, "chunk"),
                      ({"cache_mode": "paged", "prefix_cache": True}, "row-independent"),
                      ({"spec": SpecConfig(enabled=True, k=SPEC_K)}, "row-independent")):
        try:
            ServingEngine(cfg, params, EngineConfig(cache_len=168, **kw), device="cuda")
        except ValueError as e:
            require(match in str(e), f"{arch}: refused with {e}")
        else:
            fail(f"{arch}: the engine served {kw}")
    print(f"[archs] {arch}: chunked prefill, the prefix cache and speculation refused with "
          f"ValueError", flush=True)
    if arch == "deepseek-moe-16b":
        out.update(_moe_profile(cfg, params, card))
    del params
    torch.cuda.empty_cache()
    return out


def _card_vs_cpu(arch, quant_mode, n_layers=2, tag="archs"):
    """``n_layers`` of ``arch`` at full width, the same weights on the card
    and the CPU, one 16-token prefill: last-token logits within LOGIT_TOL
    of their scale, the greedy token equal unless the CPU row is a near
    tie."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    cfg = get_config(arch).with_(n_layers=n_layers, quant_mode=quant_mode)
    params = init_params(cfg, seed=3, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 16))
                              .astype(np.int32))
    got = prefill(params, cfg, {"tokens": tokens.cuda()}, 16)[0].cpu()
    want = prefill(_to_cpu(params), cfg, {"tokens": tokens}, 16)[0]
    scale, err = want.abs().max().item(), (got - want).abs().max().item()
    tok, ulps = _top2(want[0])
    print(f"[{tag}] (d) {arch}, {n_layers} layers, {quant_mode}: max |logit diff| {err:.4g} of max "
          f"|logit| {scale:.4g}, greedy card {int(got.argmax())} cpu {tok} (cpu top-2 margin "
          f"{ulps:.3g} bf16 ulps)", flush=True)
    require(bool(torch.isfinite(got).all()), f"{arch}: card logits not finite")
    require(err <= LOGIT_TOL * scale, f"{arch} {quant_mode}: logits off the CPU's by {err}")
    require(int(got.argmax()) == tok or ulps <= NEAR_TIE_ULPS,
            f"{arch} {quant_mode}: greedy token differs on a {ulps:.3g}-ulp margin")
    if cfg.moe is not None and quant_mode == "int8_spoga":
        from repro_torch.backends.spec import parse_quant_mode
        from repro_torch.models import moe
        spec, family = parse_quant_mode(quant_mode)
        w = params["blocks"][0]["moe"]["experts_gate"][0]
        x = torch.randn((4, w.shape[0], 2, w.shape[1]), device="cuda").to(torch.bfloat16)
        accs = []
        for dev in ("cuda", "cpu"):
            xq, _ = moe.dynamic_quant(x.to(dev).float(), dim=-1, bits=8)
            wq, _ = moe.dynamic_quant(w.to(dev).float(), dim=1, bits=8)
            accs.append(moe._grouped_int(xq, wq, spec, family).cpu())
        require(torch.equal(*accs), f"{arch}: grouped int32 accumulators differ from the CPU's")
        print(f"[archs] (d) {arch}: grouped expert product's int32 accumulators "
              f"{tuple(accs[0].shape)} bitwise equal to the CPU's", flush=True)
    return {"max_abs_err": err, "scale": scale}


class GemmShapes:
    """Records (M, K, N) of every ``spoga_gemm_dequant`` call the serving
    path makes while it is entered: the backend's reference to the wrapper
    is swapped for one that notes the shape and calls it (the kernel and
    its launch count are unchanged)."""

    def __init__(self):
        self.seen = set()

    def __enter__(self):
        from repro_torch.backends import impls
        self._wrapper = kernel = impls.spoga_gemm_dequant
        spec = dict(n_x_slices=2, n_w_slices=2, slice_bits=4)

        def record(x, w, x_scale, w_scale, **kw):
            require(kw == spec and x.dtype == w.dtype == torch.int8,
                    f"phase 9 GEMM outside int8_spoga: {kw}, {x.dtype} x {w.dtype}")
            self.seen.add((x.shape[0], x.shape[1], w.shape[1]))
            return kernel(x, w, x_scale, w_scale, **kw)

        impls.spoga_gemm_dequant = record
        return self

    def __exit__(self, *exc):
        from repro_torch.backends import impls
        impls.spoga_gemm_dequant = self._wrapper
        return False


def phase_arch_gemms(card, seen, table=None, tag="archs", phase="9", part="(e)",
                     runs="(a)-(c)"):
    """(e) ``spoga_gemm_dequant`` alone at the three archs' projection
    shapes: bitwise against the plain version at every (M, K, N) that
    (a)-(c) gave it (``seen``: decode and verify rows, stacked prefill
    dispatches, chunk steps, and w_uk / w_uv over the gathered latent
    prefix), and at M = 4, 20, 128 and CHUNK_M for every shape of
    ``ARCH_KN``; then device time, plain time, ``torch._int_mm`` and the
    bound at M=4 and M=128."""
    from repro_torch.kernels.spoga_gemm_dequant import (
        spoga_gemm_dequant,
        spoga_gemm_dequant_plain,
    )
    gen = torch.Generator(device="cuda").manual_seed(9)
    shapes = sorted({kn for kns in (table or ARCH_KN).values() for kn in kns})
    seen_kn = {(k, n) for _, k, n in seen}
    require(seen_kn == set(shapes),
            f"phase {phase} ran the GEMM at (K, N) {sorted(seen_kn - set(shapes))} outside its "
            f"table and never at {sorted(set(shapes) - seen_kn)}")
    cases = sorted(seen | {(m, k, n) for k, n in shapes for m in (4, 20, 128, CHUNK_M)})
    for m, k, n in cases:
        spec, x, w, xs, ws = _gemm_operands(m, k, n, "int8_spoga", gen)
        got = spoga_gemm_dequant(x, w, xs, ws, n_x_slices=spec.n_a_slices,
                                 n_w_slices=spec.n_w_slices, slice_bits=spec.slice_bits)
        require(torch.equal(got, spoga_gemm_dequant_plain(x, w, xs, ws)),
                f"GEMM ({m},{k},{n}) differs from the plain version")
    for k, n in shapes:
        print(f"[{tag}] {part} GEMM K={k} N={n} bitwise equal to the plain version at M = "
              f"{sorted(m for m, kk, nn in cases if (kk, nn) == (k, n))}; {runs} ran M = "
              f"{sorted(m for m, kk, nn in seen if (kk, nn) == (k, n))}", flush=True)
    print(f"[{tag}] {part} {len(cases)} GEMM cases bitwise equal, {len(seen)} of them the "
          f"shapes {runs} ran", flush=True)
    out = {}
    for k, n in shapes:
        for m in (4, 128):
            out[(m, k, n)] = _gemm_timing("w8a8", "int8_spoga", m, k, n, gen, tag=f"{tag} gemm")
    return out


def phase_archs(card):
    """9. minicpm3-4b, deepseek-moe-16b and granite-moe-3b-a800m at full
    width (depth cut to MLA_LAYERS, DEEPSEEK_LAYERS, GRANITE_LAYERS), then
    2-layer card-against-CPU parity and the GEMM at their shapes."""
    with GemmShapes() as shapes:
        out = {"mla": phase_mla(card),
               "deepseek": phase_moe(card, "deepseek-moe-16b", 8, "int8",
                                     n_layers=DEEPSEEK_LAYERS),
               "granite": phase_moe(card, "granite-moe-3b-a800m", 4, "bf16",
                                    n_layers=GRANITE_LAYERS)}
    out["cpu"] = {f"{arch} {qm}": _card_vs_cpu(arch, qm)
                  for arch in ARCH_KN for qm in ("bf16", "int8_spoga")}
    out["gemm"] = phase_arch_gemms(card, shapes.seen)
    return out


# ---------------------------------------------------------------------------
# 10. the recurrent archs at full width
# ---------------------------------------------------------------------------

# (K, N) of every projection the two archs run at int8_spoga
RECURRENT_KN = {
    "recurrentgemma-9b": [(4096, 4096), (4096, 256), (4096, 12288), (12288, 4096)],
    "xlstm-125m": [(768, 768), (768, 4), (768, 3072)],
}
RECURRENT_LONG = (2100, 3000)      # recurrentgemma's long prompts: past its 2,048-row ring
XLSTM_CHUNK = 256


def _recurrent_engine(arch, params, cache_len, cache_mode="paged", kv_dtype="int8",
                      chunk=None, config=None):
    """A 4-lane ``int8_spoga`` engine of ``arch`` (of ``config``, a cut
    depth, when given) through ``LLM``: pages of 16, exact-length prefill
    (a recurrent state integrates padding)."""
    from repro_torch.api import LLM, KVConfig, QuantRuntime, RuntimeConfig, SchedulerConfig
    rt = RuntimeConfig(quant=QuantRuntime(mode="int8_spoga"),
                       kv=KVConfig(mode=cache_mode, dtype=kv_dtype, page_size=16,
                                   cache_len=cache_len),
                       scheduler=SchedulerConfig(n_slots=4, prefill_buckets=None,
                                                 prefill_chunk=chunk))
    named = dict(config=config) if config is not None else dict(arch=arch)
    return LLM(**named, params=params, device="cuda", runtime=rt).engine


def _recurrent_run(card, engine, arrivals, label):
    """``_arch_run`` with the decode step's exact GEMM count printed."""
    per_step = _gemm_launches(engine.cfg)[0]
    streams, rep, launches = _arch_run(card, engine, arrivals, label)
    print(f"[recurrent] {label}: {per_step} spoga_gemm_dequant launches a decode step, "
          f"{_gemm_launches(engine.cfg)[2]} paged_attention, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
    return streams, rep, launches


def _refusals(cfg, params, cases):
    """Each engine config of ``cases`` is refused with ``ValueError`` naming
    its match."""
    from repro_torch.serving import EngineConfig, ServingEngine
    for kw, match in cases:
        try:
            ServingEngine(cfg, params, EngineConfig(**kw), device="cuda")
        except ValueError as e:
            require(match in str(e), f"{cfg.name}: {kw} refused with {e}")
        else:
            fail(f"{cfg.name}: the engine served {kw}")
    print(f"[recurrent] {cfg.name}: {len(cases)} configurations refused with the "
          f"reference's ValueError", flush=True)


def _recurrentgemma_split(cfg, params, card, prof):
    """A recurrentgemma decode step's device time (4 lanes) split: the
    ``spoga_gemm_dequant`` kernels and the library unembed from the step's
    profile; per layer at the step's shape, each projection's per-call
    weight quantization (``dynamic_quant`` of its weights) and the ring
    attention (``_decode_attend`` over a wrapped 2,048-row int8 ring), by
    ``device_ms``, times the layers; the scan and elementwise work (the
    activation quantization, the RG-LRU recurrence, the conv, norms, RoPE
    and the ring write) the rest of the step."""
    from repro_torch.backends.pipeline import dynamic_quant
    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import period_params
    groups = prof["groups"] if prof is not None else {}
    p = period_params(params["blocks"][0], 0)
    pa = period_params(params["blocks"][2], 0)
    rg_w = [p["cell"][k] for k in ("w_gate_branch", "w_x_branch", "w_rec_gate", "w_in_gate",
                                   "w_out")] + list(p["mlp"].values())
    at_w = list(pa["attn"].values()) + list(pa["mlp"].values())
    wq_rg = device_ms(lambda i: [dynamic_quant(w, dim=0, bits=8) for w in rg_w], 1, iters=3,
                      warmup=1)
    wq_at = device_ms(lambda i: [dynamic_quant(w, dim=0, bits=8) for w in at_w], 1, iters=3,
                      warmup=1)
    rows, hd = min(cfg.sliding_window, 3040), cfg.resolved_head_dim
    g = torch.Generator(device="cuda").manual_seed(5)
    k = torch.randint(-127, 128, (4, rows, cfg.n_kv_heads, hd), generator=g, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    v = torch.randint_like(k, -127, 128)
    ks = torch.rand((4, rows, cfg.n_kv_heads), generator=g, device="cuda") * 0.05
    vs = torch.rand((4, rows, cfg.n_kv_heads), generator=g, device="cuda") * 0.05
    qg = torch.randn((4, 1, cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads, hd),
                     generator=g, device="cuda").to(torch.bfloat16)
    valid = torch.ones((4, rows), dtype=torch.bool, device="cuda")
    ring_ms = device_ms(lambda i: attn._decode_attend(qg, k, v, ks, vs, valid), 1, iters=10)
    n_rg = sum(kind == "rglru" for kind in
               list(cfg.block_pattern) * (cfg.n_layers // 3) + ["rglru"] * (cfg.n_layers % 3))
    n_at = cfg.n_layers - n_rg
    total = prof["device_ms"] if prof is not None else float("nan")
    gemm = groups.get("spoga_gemm_dequant kernel", float("nan"))
    lib = sum(ms for name, ms in groups.items() if name.startswith("library"))
    split = {f"spoga_gemm_dequant kernels ({_gemm_launches(cfg)[0]} a step)": gemm,
             "weight quantization (dynamic_quant of every projection, every call)":
                 n_rg * wq_rg + n_at * wq_at,
             f"ring attention ({n_at} layers, {rows}-row int8 rings)": n_at * ring_ms,
             "library matmul (the bf16 unembed over 256,000 tokens)": lib}
    split["scan and elementwise (activation quantization, RG-LRU recurrence, conv, norms, "
          "RoPE, ring writes)"] = total - sum(split.values())
    for what, ms in split.items():
        print(f"[recurrent] recurrentgemma decode step, 4 lanes: {ms:.3f} ms {what} [{card}]",
              flush=True)
    return split


def phase_recurrentgemma(card):
    """(a) recurrentgemma-9b at full width, RECURRENTGEMMA_LAYERS of its 38
    layers, ``int8_spoga``: phase 4's traffic
    paged over int8 KV, then slot; two prompts of 2,100-3,000 tokens with 32
    new tokens each, paged (the 2,048-row rings wrap in the prefill's roll
    and again while decoding); every run's launches exact (62 GEMMs a
    decode step, no ``paged_attention``: the rings are per lane and attended
    in torch); peak memory and tok/s; a decode-step profile split into
    GEMM kernels, weight quantization, scan and elementwise work and ring
    attention; the engine's ``ValueError``s."""
    from repro_torch.configs import default_cache_len, get_config
    from repro_torch.spec import SpecConfig
    arch = "recurrentgemma-9b"
    cfg = get_config(arch).with_(n_layers=RECURRENTGEMMA_LAYERS)
    params = _arch_params(arch, RECURRENTGEMMA_LAYERS)
    arrivals = _traffic(8, cfg.vocab_size, ENGINE_SEED)
    cache_len = _roundup(default_cache_len(128, 32), 16)
    out = {"params_gib": sum(t.numel() * t.element_size() for _, t in _leaves(params)) / 2**30}
    runs = {}
    for mode in ("paged", "slot"):
        engine = _recurrent_engine(arch, params, cache_len, mode, config=cfg)
        ecfg = engine.cfg
        runs[mode] = _recurrent_run(card, engine, arrivals, f"{arch} {mode} int8 KV")
        out[mode] = {"report": runs[mode][1], "launches": runs[mode][2],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del engine
    # the rings and the cell states are per lane in both modes: one computation
    require(runs["slot"][0] == runs["paged"][0], f"{arch}: slot and paged streams differ")
    print(f"[recurrent] {arch} slot against paged: greedy streams equal", flush=True)
    rng = np.random.default_rng(ENGINE_SEED + 10)
    long = [(0, rng.integers(0, cfg.vocab_size, n).tolist(), 32) for n in RECURRENT_LONG]
    long_len = _roundup(max(RECURRENT_LONG) + 32 + 8, 16)
    engine = _recurrent_engine(arch, params, long_len, config=cfg)
    require(engine.store.cache["blocks"][2]["k"].shape[2] == cfg.sliding_window,
            "the ring is not the window")
    _, rep, launches = _recurrent_run(card, engine, long, f"{arch} long prompts "
                                      f"{list(RECURRENT_LONG)} (rings wrapped)")
    out["long"] = {"report": rep, "launches": launches,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del engine
    prof = phase_profile(ecfg, params, card, f"{arch} int8_spoga", steps=3)
    out["profile"] = prof
    out["split_ms"] = _recurrentgemma_split(ecfg, params, card, prof)
    paged = dict(cache_mode="paged", page_size=16, cache_len=cache_len)
    _refusals(ecfg, params, [
        (dict(prefill_buckets=(32, 64, 128), cache_len=cache_len), "prefill buckets pad"),
        ({**paged, "prefill_chunk": 256}, "chunked prefill needs"),
        ({**paged, "cache_len": cache_len + 8}, "multiple of page_size"),
        ({**paged, "prefix_cache": True}, "needs attention-family KV pages"),
        (dict(cache_len=cache_len, spec=SpecConfig(enabled=True, k=SPEC_K)),
         "row-independent")])
    del params
    torch.cuda.empty_cache()
    return out


def _xlstm_long_traffic(vocab):
    """Two prompts of 512 and 768 tokens (multiples of the mLSTM's 256-row
    chunk, which a one-shot prefill needs past 256 tokens) and two short
    ones, 24 new tokens each."""
    rng = np.random.default_rng(ENGINE_SEED + 11)
    return [(0, rng.integers(0, vocab, n).tolist(), 24) for n in (512, 768, 40, 100)]


def phase_xlstm(card):
    """(b) xlstm-125m at full width (``XLSTM_LAYERS`` of its 12 layers),
    ``int8_spoga``: phase 4's traffic paged and slot (23 GEMMs a decode
    step at 4 layers, 69 at 12), a decode-step profile by
    kernel group; 256-token chunks against
    one-shot prefill on 512- and 768-token prompts (greedy agreement
    printed; completion and launch counts gated: ROADMAP queue 3);
    ``LLM("xlstm-125m")`` with the default runtime; the engine's
    ``ValueError``s.  (c) the four dataflows through ``LLM``: the greedy
    streams identical, each run's launches exact."""
    from repro_torch.api import LLM, KVConfig, QuantRuntime, RuntimeConfig, SchedulerConfig
    from repro_torch.configs import default_cache_len, get_config
    from repro_torch.spec import SpecConfig
    arch = "xlstm-125m"
    cfg = get_config(arch).with_(n_layers=XLSTM_LAYERS)
    params = _arch_params(arch, config=cfg)
    arrivals = _traffic(8, cfg.vocab_size, ENGINE_SEED)
    cache_len = _roundup(default_cache_len(128, 32), 16)
    out = {}
    streams = {}
    for mode in ("paged", "slot"):
        engine = _recurrent_engine(arch, params, cache_len, mode, config=cfg)
        streams[mode], rep, launches = _recurrent_run(card, engine, arrivals,
                                                      f"{arch} {mode} int8 KV")
        out[mode] = {"report": rep, "launches": launches}
        del engine
    require(streams["slot"] == streams["paged"], f"{arch}: slot and paged streams differ")
    print(f"[recurrent] {arch} slot against paged: greedy streams equal", flush=True)
    out["profile"] = phase_profile(cfg.with_(quant_mode="int8_spoga", kv_cache_dtype="int8"),
                                   params, card, f"{arch} int8_spoga", steps=3)
    long = _xlstm_long_traffic(cfg.vocab_size)
    long_len = _roundup(768 + 24 + 8, XLSTM_CHUNK)
    runs = {}
    for label, chunk in (("one-shot", None), ("chunked", XLSTM_CHUNK)):
        engine = _recurrent_engine(arch, params, long_len, chunk=chunk, config=cfg)
        runs[label] = _recurrent_run(card, engine, long, f"{arch} {label}, prompts of "
                                     f"{[len(p) for _, p, _ in long]} tokens")
        del engine
    require(runs["chunked"][1]["chunk_steps"] == (512 + 768) // XLSTM_CHUNK,
            f"{arch}: {runs['chunked'][1]['chunk_steps']} chunk steps")
    same, total = _agreement(runs["chunked"][0], runs["one-shot"][0])
    print(f"[recurrent] {arch} chunked at {XLSTM_CHUNK} against one-shot: {same} of {total} "
          f"greedy tokens agree (not gated: ROADMAP queue 3)", flush=True)
    out["chunked"] = {"report": runs["chunked"][1], "agree": [same, total]}
    llm = LLM(config=cfg, params=params, device="cuda")
    require(llm.runtime.kv.mode == "slot" and llm.config.quant_mode == "bf16",
            "the default runtime is not slot KV with bf16 GEMMs")
    reset_counts()
    outs = llm.generate([p for _, p, _ in arrivals], max_new_tokens=16)
    torch.cuda.synchronize()
    check_counts(*read_counts(), (), f"LLM('{arch}') default")
    require(all(len(o.token_ids) == 16 for o in outs), "default LLM: a request did not finish")
    rep = llm.metrics.report()
    print(f"[recurrent] LLM('{arch}').generate, default runtime (slot bf16 KV, bf16 GEMMs): "
          f"{rep['requests']} prompts x 16 tokens, {rep['tokens_per_s']:.2f} tok/s, no kernel "
          f"launched [{card}]", flush=True)
    out["slot default"] = rep
    del llm
    paged = dict(cache_mode="paged", page_size=16, cache_len=cache_len)
    _refusals(cfg.with_(quant_mode="int8_spoga", kv_cache_dtype="int8"), params, [
        (dict(prefill_buckets=(32, 64, 128), cache_len=cache_len), "prefill buckets pad"),
        ({**paged, "prefix_cache": True}, "needs attention-family KV pages"),
        (dict(cache_len=cache_len, spec=SpecConfig(enabled=True, k=SPEC_K)),
         "row-independent")])

    # (c) the four dataflows
    prompts = [p for _, p, _ in arrivals]
    kv = KVConfig(mode="paged", dtype="int8", page_size=16, cache_len=cache_len)
    sched = SchedulerConfig(n_slots=4, prefill_buckets=None)
    per_call = {"spoga_gemm_dequant": 1, "spoga_gemm": 1, "nibble_gemm": 4,
                "deas_combine": 1, "torch._int_mm": 1}
    first, counts = None, {}
    for label, (mode, backend), route in DATAFLOWS:
        llm = LLM(config=cfg, params=params, device="cuda", runtime=RuntimeConfig(
            quant=QuantRuntime(mode=mode, gemm_backend=backend), kv=kv, scheduler=sched))
        reset_counts()
        outs = llm.generate(prompts, max_new_tokens=FACADE_NEW_TOKENS)
        torch.cuda.synchronize()
        launches, plain = read_counts()
        check_counts(launches, plain, route, f"{arch} {label}")
        got = [o.token_ids for o in outs]
        require(all(len(t) == FACADE_NEW_TOKENS for t in got), f"{arch} {label}: unfinished")
        if first is None:
            first = got
            require(len({t for g in got for t in g}) > 2, f"{arch}: streams collapsed")
        require(got == first, f"{arch} {label}: greedy streams differ from spoga fused's")
        rep = llm.metrics.report()
        gemms = _gemm_launches(llm.config)[0] * (rep["decode_steps"] + rep["prefill_dispatches"])
        for name in route:
            require(launches[name] == per_call[name] * gemms,
                    f"{arch} {label}: {name} launched {launches[name]}, want "
                    f"{per_call[name] * gemms}")
        counts[label] = launches
        print(f"[recurrent] (c) {arch} {label} ({mode}, gemm_backend={backend}): "
              f"{rep['tokens_per_s']:.1f} tok/s, decode step mean "
              f"{1e3 * rep['decode_step_mean_s']:.2f} ms, launches "
              f"{ {k: launches[k] for k in route} } [{card}]", flush=True)
        del llm
    print(f"[recurrent] (c) {arch}: 4 dataflows, 8 prompts x {FACADE_NEW_TOKENS} tokens, greedy "
          f"streams identical", flush=True)
    out["dataflows"] = counts
    del params
    torch.cuda.empty_cache()
    return out


def phase_recurrent(card):
    """10. recurrentgemma-9b (depth cut to RECURRENTGEMMA_LAYERS) and
    xlstm-125m at full width, then 3- and
    4-layer card-against-CPU parity and the GEMM at their shapes."""
    with GemmShapes() as shapes:
        out = {"recurrentgemma": phase_recurrentgemma(card), "xlstm": phase_xlstm(card)}
    out["cpu"] = {f"{arch} {qm}": _card_vs_cpu(arch, qm, n_layers=n, tag="recurrent")
                  for arch, n in (("recurrentgemma-9b", 3), ("xlstm-125m", 4))
                  for qm in ("bf16", "int8_spoga")}
    out["gemm"] = phase_arch_gemms(card, shapes.seen, RECURRENT_KN, "recurrent", "10")
    return out


# ---------------------------------------------------------------------------
# 11. the encoder-decoder and frontend archs at full width
# ---------------------------------------------------------------------------

# (K, N) of every projection the two archs run at int8_spoga
ENCDEC_KN = {
    "seamless-m4t-large-v2": [(1024, 1024), (1024, 8192), (8192, 1024)],
    "llava-next-mistral-7b": [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)],
}
ENCDEC_BATCH = 4
SEAMLESS_SRC, SEAMLESS_TGT = 128, 8     # source frames; target tokens (launch/serve.py)
LLAVA_PATCHES = 576                     # one 336-px tile of LLaVA-NeXT's anyres grid
ENCDEC_NEW_TOKENS = 32
ENCDEC_PARITY_STEPS = 4


def _encdec_launches(cfg):
    """(``spoga_gemm_dequant`` launches of a prefill, of a decode step) at
    ``int8_spoga``: an encoder-decoder prefill runs each encoder layer's 7
    (q, k, v, o, the GLU's 3), each decoder layer's cross K/V once (2) and
    each decoder layer's 7 plus its cross-attention q and o (2); a decode
    step the decoder's 9 a layer (the cross K/V come from the cache).  A
    frontend-fed decoder runs a GQA stack's 7 a layer in both."""
    if cfg.is_encoder_decoder:
        step = cfg.n_layers * (7 + 2)
        return cfg.n_encoder_layers * 7 + cfg.n_layers * 2 + step, step
    step, prefill, _ = _gemm_launches(cfg)
    return prefill, step


def _encdec_batch(cfg, device, batch=ENCDEC_BATCH, src=SEAMLESS_SRC, patches=LLAVA_PATCHES,
                  seed=ENGINE_SEED):
    """The batch of the reference's static serving path (``launch/serve.py``
    ``_static_main``): source frames and 8 target tokens for an
    encoder-decoder, patch embeddings for a frontend arch; from the port's
    stubs."""
    from repro_torch.models.frontends import fake_audio_frames, fake_vision_embeds
    if cfg.is_encoder_decoder:
        tgt = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (batch, SEAMLESS_TGT)).astype(np.int32)).to(device)
        return {"src_embeds": fake_audio_frames(seed, cfg, batch, src, device=device),
                "tgt_tokens": tgt}
    return {"embeds": fake_vision_embeds(seed, cfg, batch, patches, device=device)}


def _counted_serve(card, cfg, params, batch, cache_len, label):
    """A prefill alone, then ``serve_batch`` of ``ENCDEC_NEW_TOKENS`` tokens,
    each with every kernel count at 0 just before and read just after: the
    exact ``spoga_gemm_dequant`` launches (``_encdec_launches``), nothing
    else launched, no plain version.  Returns the run's numbers."""
    from repro_torch.api import serve_batch
    from repro_torch.models import prefill
    per_prefill, per_step = _encdec_launches(cfg)
    reset_counts()
    prefill(params, cfg, batch, cache_len)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    check_counts(launches, plain, ("spoga_gemm_dequant",), f"{label} prefill")
    require(launches["spoga_gemm_dequant"] == per_prefill,
            f"{label}: prefill GEMM launches {launches['spoga_gemm_dequant']} != {per_prefill}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    toks, times = serve_batch(cfg, params, batch, cache_len=cache_len,
                              gen_tokens=ENCDEC_NEW_TOKENS)
    launches, plain = read_counts()
    check_counts(launches, plain, ("spoga_gemm_dequant",), label)
    want = per_prefill + (ENCDEC_NEW_TOKENS - 1) * per_step
    require(launches["spoga_gemm_dequant"] == want,
            f"{label}: GEMM launches {launches['spoga_gemm_dequant']} != {want}")
    b = toks.shape[0]
    require(tuple(toks.shape) == (b, ENCDEC_NEW_TOKENS), f"{label}: tokens {tuple(toks.shape)}")
    require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{label}: token out of range")
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = 1e3 * times["decode_s"] / (ENCDEC_NEW_TOKENS - 1)
    tps = b * (ENCDEC_NEW_TOKENS - 1) / times["decode_s"]
    print(f"[encdec] {label}: prefill {1e3 * times['prefill_s']:.1f} ms, decode step "
          f"{step_ms:.2f} ms ({tps:.2f} tok/s over {b} rows), launches spoga_gemm_dequant "
          f"{launches['spoga_gemm_dequant']} ({per_prefill} the prefill, {per_step} a decode "
          f"step), peak memory {peak:.2f} GiB; row 0: {toks[0, :12].tolist()} [{card}]",
          flush=True)
    return {"launches": launches, "prefill_ms": 1e3 * times["prefill_s"],
            "decode_step_ms": step_ms, "tokens_per_s": tps, "peak_gib": peak,
            "tokens": toks.cpu()}


def _decode_split(cfg, params, batch, cache_len, card, label, steps=3):
    """A decode step's device time (``ENCDEC_BATCH`` rows) by kernel group
    from the profiler, with the per-call weight quantization of every
    projection (``dynamic_quant`` of one decoder layer's weights, by
    ``device_ms``, times the layers) split out of the elementwise group."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.backends.pipeline import dynamic_quant
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.transformer import period_params
    logits, cache = prefill(params, cfg, batch, cache_len)
    tok = logits.argmax(-1).to(torch.int32)
    decode_step(params, cfg, tok, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = decode_step(params, cfg, tok, cache)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / steps
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if not kernels or total <= 0:
        print(f"[encdec] {label}: the profiler recorded no device time: split not measured",
              flush=True)
        return None
    groups: dict[str, float] = {}
    for e in kernels:
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / steps
    layer = period_params(params["blocks"][0], 0)
    weights = list(layer["attn"].values()) + list(layer["mlp"].values())
    if cfg.is_encoder_decoder:
        xattn = period_params(params["cross_blocks"]["xattn"], 0)
        weights += [xattn["wq"], xattn["wo"]]
    wq_ms = cfg.n_layers * device_ms(
        lambda i: [dynamic_quant(w, dim=0, bits=8) for w in weights], 1, iters=3, warmup=1)
    gemm = groups.get("spoga_gemm_dequant kernel", 0.0)
    lib = sum(ms for name, ms in groups.items() if name.startswith("library"))
    split = {f"spoga_gemm_dequant kernels ({_encdec_launches(cfg)[1]} a step)": gemm,
             "weight quantization (dynamic_quant of every projection, every call)": wq_ms,
             f"library matmul (the bf16 unembed over {cfg.vocab_size:,} tokens, attention "
             f"einsums)": lib}
    split["elementwise (activation quantization, attention softmax, norms, RoPE, cache "
          "writes)"] = total - sum(split.values())
    print(f"[encdec] {label} decode step, {ENCDEC_BATCH} rows: {total:.3f} ms device time, "
          f"{wall:.3f} ms wall under the profiler (device busy {100 * total / wall:.1f}%) "
          f"[{card}]", flush=True)
    for what, ms in split.items():
        print(f"[encdec]   {ms:.3f} ms ({100 * ms / total:.1f}%) {what}", flush=True)
    return {"device_ms": total, "wall_ms": wall, "split_ms": split}


def _encdec_arch(card, arch, label):
    """(a) / (b): ``arch`` at full width, depth cut (LLAVA_LAYERS;
    SEAMLESS_LAYERS encoder and decoder layers), through ``serve_batch`` at
    ``int8_spoga``; the phase's wall time and peak memory; a decode-step
    split."""
    from repro_torch.configs import default_cache_len, get_config
    t0 = time.perf_counter()
    cfg = get_config(arch).with_(quant_mode="int8_spoga")
    if cfg.is_encoder_decoder:
        cfg = cfg.with_(n_layers=SEAMLESS_LAYERS, n_encoder_layers=SEAMLESS_LAYERS)
    else:
        cfg = cfg.with_(n_layers=LLAVA_LAYERS)
    params = _arch_params(arch, config=cfg)
    batch = _encdec_batch(cfg, "cuda")
    prompt = SEAMLESS_SRC if cfg.is_encoder_decoder else LLAVA_PATCHES
    cache_len = default_cache_len(prompt, ENCDEC_NEW_TOKENS)
    out = _counted_serve(card, cfg, params, batch, cache_len, label)
    out["profile"] = _decode_split(cfg, params, batch, cache_len, card, label)
    out["params_gib"] = sum(t.numel() * t.element_size() for _, t in _leaves(params)) / 2**30
    out["wall_s"] = time.perf_counter() - t0
    out["phase_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"[encdec] {label}: {out['wall_s']:.1f} s wall, peak memory "
          f"{out['phase_peak_gib']:.2f} GiB ({out['params_gib']:.2f} GiB of weights)", flush=True)
    del params
    torch.cuda.empty_cache()
    return out


def _encdec_card_vs_cpu(arch, quant_mode, n_layers):
    """(c) ``n_layers`` of ``arch`` at full width (encoder and decoder each
    for seamless), the same weights and embeddings on the card and the CPU:
    one prefill, then ``ENCDEC_PARITY_STEPS`` decode steps fed the CPU's
    greedy tokens; every step's logits within LOGIT_TOL of their scale and
    its greedy token equal unless the CPU row is a near tie."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    cfg = get_config(arch).with_(n_layers=n_layers, quant_mode=quant_mode)
    if cfg.is_encoder_decoder:
        cfg = cfg.with_(n_encoder_layers=n_layers)
    params = init_params(cfg, seed=3, device="cuda")
    cpu_params = _to_cpu(params)
    batch = _encdec_batch(cfg, "cpu", batch=1, src=16, patches=16, seed=3)
    got, card_cache = prefill(params, cfg, {k: v.cuda() for k, v in batch.items()}, 32)
    want, cpu_cache = prefill(cpu_params, cfg, batch, 32)
    worst = 0.0
    for step in range(ENCDEC_PARITY_STEPS + 1):
        got = got.float().cpu()
        scale, err = want.abs().max().item(), (got - want).abs().max().item()
        tok, ulps = _top2(want[0])
        require(bool(torch.isfinite(got).all()), f"{arch}: card logits not finite")
        require(err <= LOGIT_TOL * scale,
                f"{arch} {quant_mode} step {step}: logits off the CPU's by {err}")
        require(int(got.argmax()) == tok or ulps <= NEAR_TIE_ULPS,
                f"{arch} {quant_mode} step {step}: greedy token differs on a {ulps:.3g}-ulp "
                f"margin")
        worst = max(worst, err / scale)
        if step == ENCDEC_PARITY_STEPS:
            break
        nxt = torch.tensor([tok], dtype=torch.int32)
        got, card_cache = decode_step(params, cfg, nxt.cuda(), card_cache)
        want, cpu_cache = decode_step(cpu_params, cfg, nxt, cpu_cache)
    print(f"[encdec] (c) {arch}, {n_layers} layers{' + encoder' if cfg.is_encoder_decoder else ''}"
          f", {quant_mode}: prefill and {ENCDEC_PARITY_STEPS} decode steps, largest |logit diff| "
          f"{worst:.3g} of the scale (tolerance {LOGIT_TOL}), first greedy token equal",
          flush=True)
    return {"max_rel_err": worst}


def _stream_on_main_path(card):
    """(e) ``ServingEngine.stream`` on the main path: full-width llama3.2-1b
    (phase 4's weights) through ``LLM`` at ``int8_spoga`` over int8 paged
    KV; one request streamed from the ``LLM``'s engine yields the tokens
    ``LLM.generate`` gave for it, the stream's launches exact."""
    from repro_torch.api import LLM, KVConfig, QuantRuntime, RuntimeConfig
    params = full_width_params()
    rt = RuntimeConfig(quant=QuantRuntime(mode="int8_spoga"),
                       kv=KVConfig(mode="paged", dtype="int8", page_size=16))
    llm = LLM("llama3.2-1b", runtime=rt, params=params, device="cuda")
    prompt = np.random.default_rng(11).integers(0, llm.config.vocab_size, 64).tolist()
    generated = list(llm.generate(prompt, max_new_tokens=16)[0].token_ids)
    engine = llm.engine
    m0 = (engine.metrics.decode_steps, engine.metrics.prefill_dispatches)
    reset_counts()
    streamed = list(engine.stream(prompt, 16))
    torch.cuda.synchronize()
    launches, plain = read_counts()
    check_counts(launches, plain, ("spoga_gemm_dequant", "paged_attention"), "stream")
    per_step, per_prefill, attn_layers = _gemm_launches(engine.cfg)
    steps = engine.metrics.decode_steps - m0[0]
    prefills = engine.metrics.prefill_dispatches - m0[1]
    require(launches["spoga_gemm_dequant"] == per_step * steps + per_prefill * prefills,
            f"stream: GEMM launches {launches['spoga_gemm_dequant']} over {steps} steps and "
            f"{prefills} prefills")
    require(launches["paged_attention"] == attn_layers * steps,
            f"stream: attention launches {launches['paged_attention']} over {steps} steps")
    require(streamed == generated, f"stream {streamed} != generate {generated}")
    print(f"[encdec] (e) ServingEngine.stream, llama3.2-1b full width, int8_spoga, int8 paged "
          f"KV: 16 tokens equal to LLM.generate's; launches {launches['spoga_gemm_dequant']} "
          f"spoga_gemm_dequant, {launches['paged_attention']} paged_attention ({steps} decode "
          f"steps, {prefills} prefill) [{card}]", flush=True)
    del params, llm, engine
    torch.cuda.empty_cache()
    return {"launches": launches}


def _layers_card_vs_cpu(card):
    """(f) ``layers.mlp`` (GELU) at d 2048 (d_ff 8192), bf16 GEMMs and
    ``int8_spoga``, and ``layers.layernorm`` on the card against the CPU,
    the same weights and inputs: outputs within LOGIT_TOL of their scale;
    at ``int8_spoga`` the int32 accumulators of both projections, on the
    CPU run's quantized operands, bitwise (``spoga_gemm`` on the card
    against its plain version on the CPU)."""
    from repro_torch.backends import impls
    from repro_torch.models import layers
    gen = torch.Generator(device="cuda").manual_seed(21)
    d, d_ff = 2048, 8192
    p = layers.init_mlp(gen, "cuda", d, d_ff)
    x = torch.randn((4, 8, d), generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    for qm in ("bf16", "int8_spoga"):
        got = layers.mlp(x, p, quant_mode=qm).float().cpu()
        want = layers.mlp(x.cpu(), _to_cpu(p), quant_mode=qm).float()
        scale, err = want.abs().max().item(), (got - want).abs().max().item()
        require(err <= LOGIT_TOL * scale, f"mlp {qm}: card off the CPU's by {err} of {scale}")
        out[f"mlp {qm}"] = err / scale
    seen = []
    plain_gemm = impls.spoga_gemm

    def record(x_q, w_q, **kw):
        seen.append((x_q, w_q, kw))
        return plain_gemm(x_q, w_q, **kw)

    impls.spoga_gemm = record
    try:
        layers.mlp(x.cpu(), _to_cpu(p), quant_mode="int8_spoga", backend="cuda_spoga")
    finally:
        impls.spoga_gemm = plain_gemm
    require(len(seen) == 2, f"mlp ran {len(seen)} int32 GEMMs, want 2")
    for x_q, w_q, kw in seen:
        acc = plain_gemm(x_q.cuda(), w_q.cuda(), **kw).cpu()
        require(torch.equal(acc, plain_gemm(x_q, w_q, **kw)),
                f"mlp int32 accumulators ({tuple(x_q.shape)} x {tuple(w_q.shape)}) differ")
    ln = {"gamma": torch.randn(d, generator=gen, device="cuda"),
          "beta": torch.randn(d, generator=gen, device="cuda")}
    got = layers.layernorm(x, ln).float().cpu()
    want = layers.layernorm(x.cpu(), _to_cpu(ln)).float()
    scale, err = want.abs().max().item(), (got - want).abs().max().item()
    require(err <= LOGIT_TOL * scale, f"layernorm: card off the CPU's by {err} of {scale}")
    out["layernorm"] = err / scale
    print(f"[encdec] (f) mlp (GELU, d {d}, d_ff {d_ff}) and layernorm, card against CPU: "
          + ", ".join(f"{k} {v:.3g} of the scale" for k, v in out.items())
          + f"; int32 accumulators of both int8_spoga projections bitwise [{card}]", flush=True)
    return out


def phase_encdec(card):
    """11. seamless-m4t-large-v2 and llava-next-mistral-7b at full width
    through ``serve_batch``, card-against-CPU parity, the GEMM at their
    shapes, ``ServingEngine.stream`` on the main path, and the non-GLU MLP
    and LayerNorm on the card."""
    t0 = time.perf_counter()
    with GemmShapes() as shapes:
        out = {"seamless": _encdec_arch(card, "seamless-m4t-large-v2", "seamless-m4t-large-v2"),
               "llava": _encdec_arch(card, "llava-next-mistral-7b", "llava-next-mistral-7b")}
    out["cpu"] = {f"{arch} {qm}": _encdec_card_vs_cpu(arch, qm, 2)
                  for arch in ENCDEC_KN for qm in ("bf16", "int8_spoga")}
    out["gemm"] = phase_arch_gemms(card, shapes.seen, ENCDEC_KN, "encdec", "11", "(d)",
                                   "(a)-(b)")
    out["stream"] = _stream_on_main_path(card)
    out["layers"] = _layers_card_vs_cpu(card)
    out["wall_s"] = time.perf_counter() - t0
    print(f"[encdec] phase 11 in {out['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# 12. observability on the main path
# ---------------------------------------------------------------------------

OBS_LAYERS = 4             # of llama3.2-1b's 16 in phase 12 (a)-(d)


def _obs_engine(cfg, params, obs=None):
    """Phase 4's engine geometry (4 lanes, pages of 16, buckets (32, 64,
    128), ``cache_len`` 168) with the observability bundle ``obs``."""
    from repro_torch.configs import default_cache_len
    from repro_torch.serving import EngineConfig, ServingEngine
    return ServingEngine(cfg, params, EngineConfig(
        n_slots=4, page_size=16, prefill_buckets=(32, 64, 128),
        cache_len=default_cache_len(128, 32), cache_mode="paged"), device="cuda", obs=obs)


def _obs_serve(cfg, params, arrivals, label, obs=None):
    """Phase 4's traffic through ``_counted``; (streams by request, wall s,
    engine)."""
    engine = _obs_engine(cfg, params, obs)
    t0 = time.perf_counter()
    metrics, _ = _counted(engine, label, lambda e: e.run(arrivals))
    wall = time.perf_counter() - t0
    return _check_finished(metrics, arrivals, cfg.vocab_size, label), wall, engine


def _obs_busy(cfg, params, label, obs=None):
    """``_busy_engine``'s 4 lanes of 64-token prompts (4 admissions, then 2
    decode steps), set up under ``_counted``."""
    engine = _obs_engine(cfg, params, obs)
    rng = np.random.default_rng(ENGINE_SEED + 2)

    def drive(e):
        for _ in range(4):
            e.add_request(rng.integers(0, cfg.vocab_size, 64).tolist(), 32)
        for _ in range(6):
            e.step()
        return e.metrics

    _counted(engine, f"{label} set-up", drive)
    return engine


def _obs_step_costs(cfg, params, label, obs=None, steps=5):
    """(device ms a decode step, wall ms a step, device kernels a step, the
    engine) of 4 busy lanes: ``steps`` decode steps timed without the
    profiler, then ``steps`` more profiled (CUDA activity only: the device
    time of every kernel); ``obs`` is the engine's bundle."""
    from torch.profiler import ProfilerActivity, profile
    engine = _obs_busy(cfg, params, label, obs)
    wall = _counted_steps(engine, steps, f"{label} timed")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _counted_steps(engine, steps, f"{label} profiled")
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    device = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    require(device > 0, f"{label}: the profiler recorded no device time")
    return device, 1e3 * wall / steps, sum(e.count for e in kernels) // steps, engine


def phase_obs(card):
    """12. Observability on the main path: phase 4's full-width llama3.2-1b
    weights (the first ``OBS_LAYERS`` layers in (a)-(d)) and traffic,
    ``int8_spoga``, int8 paged KV, every run under ``_counted``: (a) spans
    and events off against on (fenced, trace and event sinks), streams
    bitwise equal, the fenced ``decode`` span against the profiler's device
    time a step; (b) the numerics watchdog on against off: streams bitwise,
    the GEMM launches a step unchanged, the saturation report, its device
    and wall cost a step; (c) ``/metrics`` scraped mid-run and at the end,
    valid both times, stopped by ``close()``; (d) a ``StepProfiler`` over 5
    decode steps after its warm-up step, its trace holding 5 x the step's
    ``spoga_gemm_dequant`` kernels; (e) at full depth (a replay rebuilds
    the model by its arch name), the traffic served with no recorder, then
    recorded to a bundle and replayed on the card by ``LLM.replay`` and by
    ``python -m repro_torch.launch.replay``, bitwise, the replay's launches
    the recording's."""
    import os
    import tempfile
    import urllib.error
    import urllib.request
    from repro_torch.api import LLM, KVConfig, ObsConfig, QuantRuntime, RuntimeConfig
    from repro_torch.api import SchedulerConfig
    from repro_torch.configs import get_config
    from repro_torch.obs import split_labels, validate_exposition, watchdog
    t0 = time.perf_counter()
    full = full_width_params()
    params = _first_layers(full, OBS_LAYERS)
    base = get_config("llama3.2-1b").with_(n_layers=OBS_LAYERS)
    cfg = base.with_(quant_mode="int8_spoga", kv_cache_dtype="int8")
    arrivals = _traffic(8, cfg.vocab_size, ENGINE_SEED)
    per_step = _gemm_launches(cfg)[0]
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as d:
        # (a) spans and events
        off, off_s, _ = _obs_serve(cfg, params, arrivals, "(a) obs off")
        obs = ObsConfig(fence_spans=True, trace=f"{d}/trace.json",
                        events=f"{d}/events.jsonl").build()
        on, on_s, engine = _obs_serve(cfg, params, arrivals, "(a) obs on, fenced", obs)
        require(on == off, "(a) streams with observability on differ from off")
        kinds = obs.events.kinds()
        require({"queued", "admitted", "first_token", "finished"} <= set(kinds),
                f"(a) event kinds {kinds}")
        written = obs.save()
        obs.close()
        require(len(written) == 2 and all(Path(p).stat().st_size > 0 for p in written),
                f"(a) sinks written: {written}")
        spans = {}
        for e in obs.tracer.events:
            if e["tid"] == 1:
                spans.setdefault(e["name"], []).append(e["dur"] / 1e3)
        device, wall, _, busy = _obs_step_costs(cfg, params, "(a) fenced spans",
                                                ObsConfig(fence_spans=True).build())
        # the timed steps' decode spans (the profiled ones follow them)
        fenced = [e["dur"] / 1e3 for e in busy.obs.tracer.events
                  if e["name"] == "decode" and e["tid"] == 1][-10:-5]
        span_ms = sum(fenced) / len(fenced)
        require(span_ms >= device, f"(a) fenced decode span {span_ms:.3f} ms is shorter than "
                                   f"the device time a step {device:.3f} ms")
        print(f"[obs] (a) obs off {off_s:.2f} s, on (fenced, trace + events) {on_s:.2f} s for "
              f"8 requests, streams bitwise equal; {len(obs.events)} events {kinds}; spans "
              + ", ".join(f"{k} {len(v)} x {sum(v) / len(v):.3f} ms" for k, v in spans.items())
              + f"; 4 busy lanes: fenced decode span {span_ms:.3f} ms a step against "
              f"{device:.3f} ms of device time (profiler) and {wall:.3f} ms wall [{card}]",
              flush=True)
        out["spans"] = {"decode_span_ms": span_ms, "device_ms": device, "wall_ms": wall,
                        "off_s": off_s, "on_s": on_s, "events": len(obs.events)}

        parts = {"a": time.perf_counter() - t0}

        # (b) the numerics watchdog
        watchdog.reset()
        wcfg = cfg.with_(numerics_watchdog=True)
        watched, wd_s, _ = _obs_serve(wcfg, params, arrivals, "(b) watchdog on")
        require(watched == off, "(b) streams with the watchdog on differ from off")
        report = watchdog.saturation_report()
        require(report, "(b) the watchdog recorded nothing")
        bad = [k for k in report if not k.startswith(('layer="prefill.', 'layer="decode.'))]
        require(not bad, f"(b) labels outside prefill/decode: {bad[:3]}")
        layers = {split_labels("x{" + k + "}")[1]["layer"] for k in report}
        dev_off, wall_off, n_off, _ = _obs_step_costs(cfg, params, "(b) watchdog off")
        dev_on, wall_on, n_on, _ = _obs_step_costs(wcfg, params, "(b) watchdog on")
        sat = max(report.values())
        print(f"[obs] (b) watchdog: 8 requests {wd_s:.2f} s (off {off_s:.2f} s), streams "
              f"bitwise equal, {per_step} GEMM launches a step; {len(layers)} labels, largest "
              f"activation rail share {sat:.4f}; a decode step of 4 busy lanes: device "
              f"{dev_off:.3f} -> {dev_on:.3f} ms (+{dev_on - dev_off:.3f}), wall "
              f"{wall_off:.3f} -> {wall_on:.3f} ms (+{wall_on - wall_off:.3f}), device "
              f"kernels {n_off} -> {n_on} a step [{card}]", flush=True)
        out["watchdog"] = {"device_ms": [dev_off, dev_on], "wall_ms": [wall_off, wall_on],
                           "kernels": [n_off, n_on],
                           "labels": len(layers), "max_rail_share": sat}
        watchdog.reset()
        parts["b"] = time.perf_counter() - t0

        # (c) /metrics, scraped mid-run and at the end
        rt = RuntimeConfig(quant=QuantRuntime(mode="int8_spoga"),
                           kv=KVConfig(mode="paged", dtype="int8", page_size=16),
                           scheduler=SchedulerConfig(n_slots=4, prefill_buckets=(32, 64, 128)),
                           obs=ObsConfig(metrics_port=0))
        llm = LLM(config=base, runtime=rt, params=params, device="cuda")
        engine = llm.build_engine(128, 32)
        url = llm.metrics_server.url
        scrapes = []

        def drive(e):
            for _, prompt, gen in arrivals:
                e.add_request(prompt, gen)
            while e.has_work:
                e.step()
                if not scrapes:
                    scrapes.append(urllib.request.urlopen(url + "/metrics", timeout=10).read())
            return e.metrics

        _counted(engine, "(c) /metrics", drive)
        scrapes.append(urllib.request.urlopen(url + "/metrics", timeout=10).read())
        for i, body in enumerate(scrapes):
            errors = validate_exposition(body.decode())
            require(errors == [], f"(c) scrape {i}: {errors[:3]}")
        require(b"repro_steps_total" in scrapes[0] and b"repro_ttft_s_bucket" in scrapes[1],
                "(c) series missing")
        llm.close()
        try:
            urllib.request.urlopen(url + "/healthz", timeout=2)
            fail("(c) the metrics server still answers after close()")
        except urllib.error.URLError:
            pass
        print(f"[obs] (c) /metrics: 2 scrapes valid ({len(scrapes[0])} and {len(scrapes[1])} "
              f"bytes), the server stopped by close() [{card}]", flush=True)
        del llm, engine
        parts["c"] = time.perf_counter() - t0

        # (d) the step profiler: its warm-up step, then 5 decode steps recorded
        engine = _obs_busy(cfg, params, "(d) step profiler")
        engine.obs = ObsConfig(profile_dir=f"{d}/profile", profile_steps=5).build()
        _counted_steps(engine, 6, "(d) step profiler")
        prof = engine.obs.profiler
        require(prof.done and prof.trace_path, "(d) the step profiler wrote no trace")
        with open(prof.trace_path) as f:
            trace = json.load(f)["traceEvents"]
        n_gemm = sum(1 for e in trace if e.get("cat") == "kernel"
                     and "spoga_gemm_dequant_kernel" in e.get("name", ""))
        recorded = {e["args"].get("correlation") for e in trace if e.get("cat") == "kernel"}
        calls = [e for e in trace if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "aunchKernel" in e.get("name", "")]
        unmatched = [i for i, e in enumerate(calls) if e["args"].get("correlation") not in recorded]
        require(n_gemm == 5 * per_step, f"(d) {n_gemm} spoga_gemm_dequant kernels in the "
                                        f"trace ({len(recorded)} kernels in all), want "
                                        f"{5 * per_step}; {len(unmatched)} of {len(calls)} "
                                        f"launch calls have no kernel record (first at "
                                        f"{unmatched[:3]}, last at {unmatched[-3:]})")
        print(f"[obs] (d) StepProfiler: a warm-up step, then 5 decode steps: {n_gemm} "
              f"spoga_gemm_dequant kernels of {len(recorded)}, "
              f"{len(calls) - len(unmatched)} of {len(calls)} launch calls with a kernel "
              f"record, "
              f"in {Path(prof.trace_path).stat().st_size / 2**20:.1f} MiB of trace [{card}]",
              flush=True)
        del engine
        parts["d"] = time.perf_counter() - t0

        # (e) at full depth: served with no recorder, then recorded, then
        # replayed twice on the card
        del params
        full_cfg = get_config("llama3.2-1b").with_(quant_mode="int8_spoga",
                                                  kv_cache_dtype="int8")
        plain, plain_s, _ = _obs_serve(full_cfg, full, arrivals, "(e) no recorder")
        bundle = f"{d}/bundle"
        llm = LLM("llama3.2-1b", runtime=dataclasses.replace(
            rt, obs=ObsConfig(record_path=bundle)), params=full, device="cuda")
        engine = llm.build_engine(128, 32)
        t1 = time.perf_counter()
        metrics, rec_launches = _counted(engine, "(e) record", lambda e: e.run(arrivals))
        rec_s = time.perf_counter() - t1
        recorded = _check_finished(metrics, arrivals, cfg.vocab_size, "(e) record")
        require(recorded == plain, "(e) the recorded streams differ from the unrecorded run's")
        llm.close()
        del llm, engine
        torch.cuda.empty_cache()
        reset_counts()
        t1 = time.perf_counter()
        res = LLM.replay(bundle, device="cuda")
        replay_s = time.perf_counter() - t1
        launches, plain = read_counts()
        check_counts(launches, plain, ("spoga_gemm_dequant", "paged_attention"), "(e) replay")
        require(res.ok and res.divergence is None and not res.token_mismatches,
                "(e) LLM.replay:\n" + res.summary())
        require(launches == rec_launches, f"(e) replay launches {launches} != the "
                                          f"recording's {rec_launches}")
        t1 = time.perf_counter()
        cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.replay", bundle],
                             cwd=Path(__file__).resolve().parent, capture_output=True,
                             text=True, timeout=600,
                             env={**os.environ, "PYTHONPATH": str(
                                 Path(__file__).resolve().parent / "src")})
        cli_s = time.perf_counter() - t1
        require(cli.returncode == 0, f"(e) launch.replay exited {cli.returncode}:\n"
                                     f"{cli.stdout[-2000:]}\n{cli.stderr[-2000:]}")
        size = sum(p.stat().st_size for p in Path(bundle).iterdir())
        print(f"[obs] (e) recorded 8 requests in {rec_s:.2f} s (no recorder {plain_s:.2f} s: "
              f"{1e3 * (rec_s - plain_s) / 8:.1f} ms a request), bundle {size} bytes; "
              f"LLM.replay bitwise ({res.n_replayed_events} events, {replay_s:.1f} s, "
              f"launches equal the recording's), launch.replay exit 0 ({cli_s:.1f} s) "
              f"[{card}]", flush=True)
        out["record"] = {"record_s": rec_s, "off_s": plain_s, "bundle_bytes": size,
                         "replay_s": replay_s, "cli_s": cli_s}
        out["launches"] = rec_launches
    del full
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    ends = [0.0] + list(parts.values()) + [out["wall_s"]]
    print(f"[obs] phase 12 in {out['wall_s']:.1f} s (budget 120 s): " + ", ".join(
        f"({k}) {b - a:.1f} s" for k, a, b in zip("abcde", ends, ends[1:])), flush=True)
    return out


# ---------------------------------------------------------------------------
# 13. training
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 8
TRAIN_LR = dict(learning_rate=1e-3, warmup_steps=2, total_steps=8)
TRAIN_SMALL_LAYERS = 2
# card against CPU, as tests/test_torch_train.py holds the port to the
# reference: the loss within 1e-4, every gradient leaf within 2% of its
# largest magnitude (bf16 leaves behind bf16 activations: a one-ulp f32
# difference in a sum flips a bf16 rounding), params after one AdamW step
# within 2 lr (a sign-like first step)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 2e-2
# train_loop's log line (the reference's format)
_TRAIN_LOG = re.compile(r"\[train\] step\s+(\d+) loss (\S+) gnorm (\S+) lr (\S+) \((\S+)s\)")


def _train_log_rows(text):
    """(step, loss, grad norm, lr, seconds) of each ``[train] step`` line."""
    return [(int(s), float(l), float(g), float(r), float(t))
            for s, l, g, r, t in _TRAIN_LOG.findall(text)]


def _train_counted(label, expect, drive):
    """``drive()`` (a ``train_loop`` call) with every kernel count at 0 just
    before and read just after; its log is captured (and printed) and
    parsed.  Returns (params, losses, log rows, launches)."""
    import contextlib
    import io
    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        params, losses = drive()
    torch.cuda.synchronize()
    launches, plain = read_counts()
    print(buf.getvalue(), end="", flush=True)
    check_counts(launches, plain, tuple(expect), label)
    for name, n in expect.items():
        require(launches[name] == n, f"{label}: {name} launched {launches[name]} times, "
                                     f"want {n}")
    rows = _train_log_rows(buf.getvalue())
    require(len(rows) == len(losses), f"{label}: {len(rows)} log lines for {len(losses)} steps")
    return params, losses, rows, launches


def _train_cfg(quant_mode="int8_spoga", n_layers=None, **kw):
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-1b").with_(quant_mode=quant_mode, **kw)
    return cfg if n_layers is None else cfg.with_(n_layers=n_layers)


def _train_step_split(cfg, tcfg, card, launches_per_step):
    """One full-width training step's device time (the profiler, after a
    warm-up step) beside its wall time without the profiler, and its split:
    the ``spoga_gemm_dequant`` kernels (half in the forward, half in the
    recompute: the same calls), per-call weight quantization (every
    projection's ``dynamic_quant``, forward and recompute), the
    straight-through backward's f32 products (``dx`` and ``dw`` of every
    projection at M = B * S), the loss chunks (``_chunked_ce`` forward and
    backward over the tied table) and the AdamW update, each timed alone by
    ``device_ms``; the rest (attention, norms, RoPE, activation
    quantization, the embedding's backward) is what remains."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.backends.pipeline import dynamic_quant
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.models import model as model_lib
    from repro_torch.models.transformer import period_params
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.tree import tree_map
    params = init_params(cfg, seed=ENGINE_SEED, device="cuda")
    state = adamw_init(params)
    step = make_train_step(cfg, tcfg)
    gen = torch.Generator(device="cuda").manual_seed(11)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                                     generator=gen, device="cuda", dtype=torch.int32)}
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels or total <= 0:
        print("[train] (a) the profiler recorded no device time: the step's split is not "
              "measured", flush=True)
        return None
    # the launch counters gate the count; the profiler now and then drops
    # a few of a step's ~10^4 kernel records, so its count is printed only
    n_gemm = sum(e.count for e in kernels if "spoga_gemm_dequant_kernel" in e.key)
    gemm_ms = sum(e.self_device_time_total for e in kernels
                  if "spoga_gemm_dequant_kernel" in e.key) / 1e3
    layer = period_params(params["blocks"][0], 0)
    ws = [layer["attn"][k] for k in ("wq", "wk", "wv", "wo")] + \
        [layer["mlp"][k] for k in ("w_gate", "w_up", "w_down")]
    wq_ms = device_ms(lambda i: [dynamic_quant(w, dim=0, bits=8) for w in ws], 1, iters=3,
                      warmup=1)
    mrows = TRAIN_BATCH * TRAIN_SEQ
    xs = [torch.randn((mrows, w.shape[0]), generator=gen, device="cuda").bfloat16()
          for w in ws]
    gs = [torch.randn((mrows, w.shape[1]), generator=gen, device="cuda").bfloat16()
          for w in ws]

    def ste_bwd(i):
        for x, g, w in zip(xs, gs, ws):
            gf = g.float()
            torch.matmul(gf, w.float().t()).bfloat16()
            torch.matmul(x.float().t(), gf).bfloat16()

    bwd_ms = device_ms(ste_bwd, 1, iters=3, warmup=1)
    hidden = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen,
                         device="cuda").bfloat16().requires_grad_(True)
    table = params["embed"].detach().clone().requires_grad_(True)
    labels = batch["tokens"].long()
    mask = torch.ones(labels.shape, device="cuda")

    def loss_chunks(i):
        loss = model_lib._chunked_ce(hidden, labels, mask, table, cfg)
        torch.autograd.grad(loss, (hidden, table))

    loss_ms = device_ms(loss_chunks, 1, iters=2, warmup=1)
    zeros = tree_map(torch.zeros_like, params)
    adam_ms = device_ms(lambda i: adamw_update(params, zeros, state, tcfg), 1, iters=2,
                        warmup=1)
    n = cfg.n_layers
    split = {"spoga_gemm_dequant kernels, forward": gemm_ms / 2,
             "spoga_gemm_dequant kernels, remat recompute": gemm_ms / 2,
             "weight quantization (every projection's dynamic_quant, forward and recompute)":
                 2 * n * wq_ms,
             "straight-through backward (f32 dx and dw products of every projection)":
                 n * bwd_ms,
             "loss chunks (_chunked_ce forward, recompute and backward)": loss_ms,
             "AdamW update (f32 master, moments, bf16 cast)": adam_ms}
    split["rest (attention, norms, RoPE, activation quantization, embedding backward)"] = \
        total - sum(split.values())
    print(f"[train] (a) one step, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: {total:.1f} ms device "
          f"time, {wall:.1f} ms wall without the profiler (device busy {100 * total / wall:.1f}%)"
          f"; the profiler recorded {n_gemm} of the step's {launches_per_step} "
          f"spoga_gemm_dequant kernels [{card}]", flush=True)
    for what, ms in split.items():
        print(f"[train] (a)   {ms:.2f} ms ({100 * ms / total:.1f}%) {what}", flush=True)
    del params, state, zeros, table
    torch.cuda.empty_cache()
    return {"device_ms": total, "wall_ms": wall, "busy": total / wall, "split_ms": split,
            "loss": float(m["loss"])}


def _train_full_width(card):
    """(a) full-width llama3.2-1b (16 layers), ``int8_spoga``, remat on,
    ``train_loop`` for TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import train_loop
    cfg = _train_cfg()
    require(cfg.remat, "full-width training runs with remat on")
    tcfg = TrainConfig(**TRAIN_LR)
    per_step = 2 * 7 * cfg.n_layers       # every projection, forward and recompute
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, losses, rows, launches = _train_counted(
        "(a) full-width train_loop", {"spoga_gemm_dequant": per_step * TRAIN_STEPS},
        lambda: train_loop(cfg, tcfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(all(math.isfinite(v) for v in losses), f"(a) a loss is not finite: {losses}")
    require(all(math.isfinite(r[2]) for r in rows), "(a) a grad norm is not finite")
    # the loss falling: the first 3 batches again under the trained params,
    # against their losses when they were first trained on.  Each step's
    # batch is fresh random token ids, and at full width a model cannot
    # learn to predict unseen ids in a few steps: the training losses of
    # fresh batches stay flat in this port and in the reference (PERF.md
    # section 6, PR 23), so their first-3 / last-3 means are printed only
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.models import lm_loss
    pipe = SyntheticTokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    with torch.no_grad():
        again = [float(lm_loss(params, cfg, {"tokens": pipe.global_batch_at(i)}))
                 for i in range(3)]
    first, seen = float(np.mean(losses[:3])), float(np.mean(again))
    require(seen < first, f"(a) the first 3 batches' loss did not fall: {first:.4f} -> {seen:.4f}")
    last = float(np.mean(losses[-3:]))
    step_s = [r[4] for r in rows[1:]]
    print(f"[train] (a) llama3.2-1b full width, int8_spoga, remat on, {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: the first 3 batches' loss {first:.4f} -> "
          f"{seen:.4f} after training (fresh batches: first 3 {first:.4f}, last 3 {last:.4f}), "
          f"step {1e3 * float(np.mean(step_s)):.1f} ms mean after step 1 "
          f"({1e3 * min(step_s):.1f}-{1e3 * max(step_s):.1f}), {per_step} spoga_gemm_dequant "
          f"launches a step, peak memory {peak:.2f} GiB, train_loop {wall:.1f} s [{card}]",
          flush=True)
    del params
    torch.cuda.empty_cache()
    prof = _train_step_split(cfg, tcfg, card, per_step)
    return {"losses": losses, "grad_norms": [r[2] for r in rows], "seen_again": again,
            "step_ms": 1e3 * float(np.mean(step_s)), "peak_gib": peak,
            "launches": launches, "per_step": per_step, "profile": prof}


def _train_small(card, d):
    """(b) resume and (c) the dataflows, TRAIN_SMALL_LAYERS layers at full
    width, TRAIN_BATCH x TRAIN_SEQ tokens, both under
    ``torch.use_deterministic_algorithms(True)``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import train_loop
    tcfg = TrainConfig(**TRAIN_LR)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    cfg = _train_cfg(n_layers=TRAIN_SMALL_LAYERS)
    per_step = 2 * 7 * cfg.n_layers
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        straight, losses4, _, l4 = _train_counted(
            "(b) 4 steps straight", {"spoga_gemm_dequant": 4 * per_step},
            lambda: train_loop(cfg, tcfg, steps=4, **kw))
        _, first2, _, _ = _train_counted(
            "(b) 2 steps, async checkpoint", {"spoga_gemm_dequant": 2 * per_step},
            lambda: train_loop(cfg, tcfg, steps=2, ckpt_dir=d, checkpoint_every=100, **kw))
        t0 = time.perf_counter()
        resumed, last2, _, _ = _train_counted(
            "(b) restore + 2 steps", {"spoga_gemm_dequant": 2 * per_step},
            lambda: train_loop(cfg, tcfg, steps=4, ckpt_dir=d, checkpoint_every=100, **kw))
        resume_s = time.perf_counter() - t0
        require(first2 + last2 == losses4, f"(b) losses {first2 + last2} != {losses4}")
        for (name, a), (_, b) in zip(_leaves(straight), _leaves(resumed)):
            require(a.dtype == b.dtype and torch.equal(a, b),
                    f"(b) param {name} differs after resume")
        print(f"[train] (b) {TRAIN_SMALL_LAYERS} layers at full width: 4 steps straight against "
              f"2 + async CheckpointManager save + restore + 2 (restore and 2 steps "
              f"{resume_s:.1f} s): losses and every param bitwise equal, under "
              f"torch.use_deterministic_algorithms(True) [{card}]", flush=True)
        out["resume"] = {"losses": losses4, "launches": l4}
        del straight, resumed
        curves = {}
        flows = [("int8_spoga", None, {"spoga_gemm_dequant": 4 * per_step}),
                 ("int8_spoga", "cuda_spoga", {"spoga_gemm": 4 * per_step}),
                 ("int8_deas", None, {"nibble_gemm": 16 * per_step,
                                      "deas_combine": 4 * per_step}),
                 ("int8_direct", None, {"torch._int_mm": 4 * per_step})]
        for mode, backend, expect in flows:
            label = mode + (f" + {backend}" if backend else "")
            c = _train_cfg(mode, n_layers=TRAIN_SMALL_LAYERS, gemm_backend=backend)
            _, curves[label], _, launches = _train_counted(
                f"(c) {label}", expect, lambda: train_loop(c, tcfg, steps=4, **kw))
            out.setdefault("dataflows", {})[label] = {"losses": curves[label],
                                                      "launches": launches}
        ref = curves["int8_spoga"]
        for label, curve in curves.items():
            require(curve == ref, f"(c) {label} loss curve {curve} != int8_spoga {ref}")
        print(f"[train] (c) {TRAIN_SMALL_LAYERS} layers, 4 steps in {', '.join(curves)}: loss "
              f"curves bitwise equal {ref}, every kernel's launches exact [{card}]", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def _train_card_vs_cpu(card):
    """(d) TRAIN_SMALL_LAYERS layers at full width, bf16 and ``int8_spoga``,
    a 2 x 64 batch: the loss, every gradient leaf and the params after one
    AdamW step, card against CPU within the tests' tolerances."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import init_params, lm_loss
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.tree import leaves, rebuild
    tcfg = TrainConfig(**TRAIN_LR)
    out = {}
    for mode in ("bf16", "int8_spoga"):
        cfg = _train_cfg(mode, n_layers=TRAIN_SMALL_LAYERS)
        gen = torch.Generator().manual_seed(5)
        tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, dtype=torch.int32)
        res = {}
        for dev in ("cuda", "cpu"):
            params = init_params(cfg, seed=3, device="cuda")
            params = params if dev == "cuda" else _to_cpu(params)
            flat = leaves(params)
            for t in flat:
                t.requires_grad_(True)
            loss = lm_loss(params, cfg, {"tokens": tokens.to(dev)})
            grads = torch.autograd.grad(loss, flat)
            for t in flat:
                t.requires_grad_(False)
            # the train step's update, from these gradients
            new, _, _ = adamw_update(params, rebuild(params, iter(grads)),
                                     adamw_init(params, device=dev), tcfg)
            res[dev] = (float(loss.detach()), [g.cpu() for g in grads],
                        [t.cpu() for t in leaves(new)])
            del params, new, grads, flat
        (lc, gc, pc), (lh, gh, ph) = res["cuda"], res["cpu"]
        require(abs(lc - lh) <= TRAIN_LOSS_RTOL * abs(lh), f"(d) {mode}: loss {lc} vs {lh}")
        worst = 0.0
        for (name, _), a, b in zip(_leaves(init_params(cfg, device="meta")), gc, gh):
            scale = b.float().abs().max().item()
            err = (a.float() - b.float()).abs().max().item()
            worst = max(worst, err / max(scale, 1e-30))
            require(a.dtype == b.dtype and err <= TRAIN_GRAD_TOL * scale,
                    f"(d) {mode}: gradient {name} off the CPU's by {err} of {scale}")
        step_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(pc, ph))
        require(step_err <= 2 * TRAIN_LR["learning_rate"],
                f"(d) {mode}: params after one AdamW step off the CPU's by {step_err}")
        print(f"[train] (d) {TRAIN_SMALL_LAYERS} layers at full width, {mode}, 2 x 64 tokens: "
              f"loss card {lc:.6f} cpu {lh:.6f}, worst gradient leaf {100 * worst:.3f}% of its "
              f"largest magnitude, params after one AdamW step within {step_err:.3g} (bound "
              f"{2 * TRAIN_LR['learning_rate']:g}) [{card}]", flush=True)
        out[mode] = {"loss_card": lc, "loss_cpu": lh, "worst_grad": worst, "step_err": step_err}
    return out


def phase_train(card):
    """13. Training, with every run under the launch counters: (a)-(d) above,
    then (e) ``spoga_gemm_dequant`` at a training step's M = 4,096 for
    llama's four (K, N), held to its plain version and timed."""
    import tempfile
    t0 = time.perf_counter()
    out = {"full": _train_full_width(card)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        out.update(_train_small(card, d))
    out["cpu"] = _train_card_vs_cpu(card)
    from repro_torch.kernels.spoga_gemm_dequant import (
        spoga_gemm_dequant,
        spoga_gemm_dequant_plain,
    )
    gen = torch.Generator(device="cuda").manual_seed(13)
    m = TRAIN_BATCH * TRAIN_SEQ
    out["gemm"] = {}
    for k, n in GEMM_KN:
        spec, x, w, xs, ws = _gemm_operands(m, k, n, "int8_spoga", gen)
        got = spoga_gemm_dequant(x, w, xs, ws, n_x_slices=spec.n_a_slices,
                                 n_w_slices=spec.n_w_slices, slice_bits=spec.slice_bits)
        require(torch.equal(got, spoga_gemm_dequant_plain(x, w, xs, ws)),
                f"(e) spoga_gemm_dequant M={m} K={k} N={n} differs from its plain version")
        out["gemm"][(m, k, n)] = _gemm_timing("w8a8", "int8_spoga", m, k, n, gen, tag="train")
    print(f"[train] phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# 14. distribution
# ---------------------------------------------------------------------------

TP_LLAMA_LAYERS = 4        # of llama3.2-1b's 16 in (a) and (b)
TP_MISTRAL_LAYERS = 4      # of mistral-large-123b's 88
TP_DEEPSEEK_LAYERS = 4     # of deepseek-moe-16b's 28: 1 dense + 3 MoE
TP_REQUESTS = 4            # of phase 4's 8 requests in (c) and (d)
TP_TRAIN_LAYERS = 2
TP_TRAIN = dict(batch=4, seq=256, steps=2)
# the projections of a tp=2 rank at M=4: (kernel, K, N) -- q, k/v, gate/up
# column-parallel on spoga_gemm_dequant, o and down row-parallel on spoga_gemm
TP_KN = {
    "llama3.2-1b": [("spoga_gemm_dequant", 2048, 1024), ("spoga_gemm_dequant", 2048, 256),
                    ("spoga_gemm_dequant", 2048, 4096), ("spoga_gemm", 1024, 2048),
                    ("spoga_gemm", 4096, 2048)],
    "mistral-large-123b": [("spoga_gemm_dequant", 12288, 6144),
                           ("spoga_gemm_dequant", 12288, 512),
                           ("spoga_gemm_dequant", 12288, 14336),
                           ("spoga_gemm", 6144, 12288), ("spoga_gemm", 14336, 12288)],
}


def _tp_config(arch, n_layers=None):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if n_layers is None else cfg.with_(n_layers=n_layers)


def _tp_runtime(mesh):
    """Phase 4's serving setup: ``int8_spoga``, int8 paged KV, pages of 16,
    4 lanes, buckets of 32/64/128."""
    from repro_torch.api import KVConfig, QuantRuntime, RuntimeConfig, SchedulerConfig
    return RuntimeConfig(quant=QuantRuntime(mode="int8_spoga"),
                         kv=KVConfig(mode="paged", dtype="int8", page_size=16),
                         scheduler=SchedulerConfig(n_slots=4, prefill_buckets=(32, 64, 128)),
                         mesh=mesh)


def _tp_serve(cfg, arrivals, mesh, label, device="cuda"):
    """``LLM(config=cfg, runtime=_tp_runtime(mesh))`` with weights from
    ``init_params(seed=0)`` (sliced to the rank's part on a mesh) serving
    ``arrivals``, every kernel count at 0 just before and read just after,
    gated exactly per rank: at tp>1 each layer runs its 5 column-parallel
    projections on ``spoga_gemm_dequant`` and its 2 row-parallel ones (o,
    down) on ``spoga_gemm``, at tp=1 all 7 on ``spoga_gemm_dequant``, for
    every decode step and prefill dispatch; ``paged_attention`` once a
    layer a decode step; no plain version.  Returns a dict of the streams,
    the report, the launches, the rank's param bytes and its peak memory."""
    from repro_torch.api import LLM
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM(config=cfg, runtime=_tp_runtime(mesh), seed=ENGINE_SEED, device=device)
    engine = llm.build_engine(128, 32)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    reset_counts()
    metrics = engine.run(arrivals)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    tp = mesh.tp if mesh.enabled else 1
    expect = ("spoga_gemm_dequant", "spoga_gemm", "paged_attention") if tp > 1 else \
        ("spoga_gemm_dequant", "paged_attention")
    check_counts(launches, plain, expect, label)
    rep = metrics.report()
    calls = rep["decode_steps"] + rep["prefill_dispatches"]
    layers = cfg.n_layers
    want = {"spoga_gemm_dequant": (5 if tp > 1 else 7) * layers * calls,
            "spoga_gemm": (2 * layers * calls if tp > 1 else 0),
            "paged_attention": layers * rep["decode_steps"]}
    for name, n in want.items():
        require(launches[name] == n, f"{label}: {name} launched {launches[name]} times, want {n}")
    streams = _check_finished(metrics, arrivals, cfg.vocab_size, label)
    mgr = engine.store.manager
    mgr.check_invariants()
    require(mgr.pages_in_use == 0, f"{label}: pages leaked after the run")
    param_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(llm.params))
    out = dict(streams=streams, report={k: rep[k] for k in (
        "tokens_per_s", "decode_step_mean_s", "ttft_mean_s", "decode_steps",
        "prefill_dispatches", "generated_tokens", "wall_s")},
        launches={k: launches[k] for k in want}, per_step={k: v // max(calls, 1) for k, v in
                                                           want.items()},
        param_bytes=param_bytes, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        init_s=t_init, kv_heads=tuple(engine.store.cache["blocks"][0]["kp"].shape)[-2])
    del llm, engine
    torch.cuda.empty_cache()
    return out


def _tp_line(label, res, card):
    r = res["report"]
    print(f"[tp] {label}: {r['generated_tokens']} tokens, {r['tokens_per_s']:.2f} tok/s, decode "
          f"step mean {1e3 * r['decode_step_mean_s']:.2f} ms ({r['decode_steps']} steps, "
          f"{r['prefill_dispatches']} prefill dispatches), TTFT mean "
          f"{1e3 * r['ttft_mean_s']:.1f} ms; launches {res['launches']}; params "
          f"{res['param_bytes'] / 2**30:.3f} GiB, KV heads {res['kv_heads']}, peak memory "
          f"{res['peak_gib']:.2f} GiB [{card}]", flush=True)


def _digest(tree) -> str:
    import hashlib
    h = hashlib.sha256()
    for _, t in _leaves(tree):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _tp_gemm_check(rank, tp):
    """The row- and column-parallel ``linear`` at llama's and mistral's
    projection shapes (M=4, bf16 activations) against the unsharded call on
    the same card: bitwise.  Launches here are outside any counted run."""
    from repro_torch.models.layers import linear
    from repro_torch.runtime import collectives as col
    ax = col.model_axis()
    gen = torch.Generator(device="cuda").manual_seed(11)
    checked = 0
    for arch, shapes in TP_KN.items():
        for kernel, k, n in shapes:
            # the unsharded projection: (K*tp, N) for a row-parallel one,
            # (K, N*tp) for a column-parallel one
            kk, nn = (k * tp, n) if kernel == "spoga_gemm" else (k, n * tp)
            x = torch.randn((4, kk), generator=gen, device="cuda").to(torch.bfloat16)
            w = (torch.randn((kk, nn), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
            with col.model_parallel(None):
                full = linear(x, w, "int8_spoga")
            if kernel == "spoga_gemm":
                got = linear(x[:, rank * k:(rank + 1) * k], w[rank * k:(rank + 1) * k],
                             "int8_spoga", row=True)
                want = full
            else:
                got = linear(x, w[:, rank * n:(rank + 1) * n], "int8_spoga")
                want = full[:, rank * n:(rank + 1) * n]
            require(torch.equal(got, want), f"{arch} {kernel} K={k} N={n}: the sharded "
                    f"projection differs from the unsharded one by "
                    f"{(got.float() - want.float()).abs().max().item()}")
            checked += 1
    require(ax is not None and ax.size == tp, "the model axis is not active")
    return checked


def _tp_rank(rank, dev):
    """Phase 14 (b)-(e) in one of two gloo ranks that share ``cuda:0``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.api import MeshConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import _loss_and_grads, make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.runtime import collectives as col
    from repro_torch.runtime.sharding import param_specs
    from repro_torch.shard import tree_device_bytes
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    out = {}
    tp2 = MeshConfig(tp=2)
    t0 = time.perf_counter()
    # (b) full-width llama3.2-1b (TP_LLAMA_LAYERS layers), phase 4's traffic
    cfg = _tp_config("llama3.2-1b", TP_LLAMA_LAYERS)
    out["llama"] = _tp_serve(cfg, _traffic(8, cfg.vocab_size, ENGINE_SEED), tp2,
                             f"(b) rank {rank} llama3.2-1b tp=2")
    mesh = make_host_mesh(1, 2, backend="gloo", device=dev)
    with col.model_parallel(mesh):
        out["gemm_checked"] = _tp_gemm_check(rank, 2)
    out["t_b"] = time.perf_counter() - t0
    # (c) mistral-large-123b at full width, TP_MISTRAL_LAYERS layers
    cfg = _tp_config("mistral-large-123b", TP_MISTRAL_LAYERS)
    res = _tp_serve(cfg, _traffic(TP_REQUESTS, cfg.vocab_size, ENGINE_SEED), tp2,
                    f"(c) rank {rank} mistral-large-123b tp=2")
    meta = init_params(cfg, device="meta")
    res["tree_device_bytes"] = tree_device_bytes(meta, param_specs(meta, mesh, cfg, fsdp=False),
                                                 mesh)
    out["mistral"] = res
    out["t_c"] = time.perf_counter() - t0
    # (d) deepseek-moe-16b, TP_DEEPSEEK_LAYERS layers, expert-parallel
    cfg = _tp_config("deepseek-moe-16b", TP_DEEPSEEK_LAYERS)
    out["deepseek"] = _tp_serve(cfg, _traffic(TP_REQUESTS, cfg.vocab_size, ENGINE_SEED), tp2,
                                f"(d) rank {rank} deepseek-moe-16b tp=2")
    out["t_d"] = time.perf_counter() - t0
    # (e) dp=2 training, compression off and on
    dmesh = make_host_mesh(2, 1, backend="gloo", device=dev)
    data = col.axis(dmesh, "data")
    cfg = _train_cfg(n_layers=TP_TRAIN_LAYERS, remat=False)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, TP_TRAIN["seq"], TP_TRAIN["batch"],
                                  seed=ENGINE_SEED, device=str(dev))
    out["train"] = {}
    for compress in (False, True):
        tcfg = TrainConfig(**TRAIN_LR, fsdp=False, zero1=False, grad_compression=compress)
        params = init_params(cfg, seed=ENGINE_SEED, device=dev)
        opt = adamw_init(params, device=dev)
        step = make_train_step(cfg, tcfg, mesh=dmesh)
        reset_counts()
        losses = []
        for i in range(TP_TRAIN["steps"]):
            params, opt, m = step(params, opt, {"tokens": pipe.global_batch_at(i)})
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        launches, plain = read_counts()
        check_counts(launches, plain, ("spoga_gemm_dequant",),
                     f"(e) rank {rank} dp=2 compression {compress}")
        want = 7 * cfg.n_layers * TP_TRAIN["steps"]
        require(launches["spoga_gemm_dequant"] == want,
                f"(e) rank {rank}: {launches['spoga_gemm_dequant']} GEMM launches, want {want}")
        out["train"][compress] = dict(losses=losses, digest=_digest(params),
                                      launches=launches["spoga_gemm_dequant"])
        del params, opt
    # the compressed all-reduce of CUDA gradients against the same on the
    # host, over the layers' gradient leaves (the 263 M-entry embedding's
    # would take the host longer than the rest of (e))
    params = init_params(cfg, seed=ENGINE_SEED, device=dev)
    batch = pipe.global_batch_at(0).chunk(2)[rank]
    _, grads = _loss_and_grads(params, cfg, TrainConfig(), {"tokens": batch})
    grads = grads["blocks"]
    on_card = col.compressed_psum_mean(grads, data)
    on_host = col.compressed_psum_mean(_to_cpu(grads), data)
    diff = [name for (name, a), (_, b) in zip(_leaves(on_card), _leaves(on_host))
            if not torch.equal(a.cpu(), b)]
    out["compressed_card_vs_cpu"] = dict(leaves=len(_leaves(on_card)), differ=diff)
    out["t_e"] = time.perf_counter() - t0
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def phase_distribution(card):
    """14. (a) ``MeshConfig(enable=True)`` on one NCCL rank against the
    unsharded engine; (b)-(e) in two gloo ranks sharing the card."""
    import torch.distributed as dist
    from repro_torch.api import MeshConfig
    from repro_torch.launch.mesh import spawn
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    compute_mode = mode.stdout.strip() if mode.returncode == 0 else "unknown"
    print(f"[tp] compute mode {compute_mode!r}; (a) one NCCL rank, (b)-(e) two gloo ranks on "
          f"cuda:0 (gloo stages every collective on a CUDA tensor through host memory)",
          flush=True)
    require("exclusive" not in compute_mode.lower(),
            f"the card's compute mode is {compute_mode!r}: two ranks cannot share it")
    t0 = time.perf_counter()
    out = {"compute_mode": compute_mode}
    # (a) and the tp=1 references
    cfg = _tp_config("llama3.2-1b", TP_LLAMA_LAYERS)
    arrivals = _traffic(8, cfg.vocab_size, ENGINE_SEED)
    ref = _tp_serve(cfg, arrivals, MeshConfig(), "(a) llama3.2-1b unsharded")
    _tp_line("(a) llama3.2-1b unsharded", ref, card)
    one = _tp_serve(cfg, arrivals, MeshConfig(enable=True), "(a) llama3.2-1b one NCCL rank")
    _tp_line("(a) llama3.2-1b MeshConfig(enable=True), one NCCL rank", one, card)
    require(dist.is_initialized() and dist.get_backend() == "nccl",
            "(a) did not run on an NCCL process group")
    require(one["streams"] == ref["streams"], "(a) the one-rank mesh changed the streams")
    dist.destroy_process_group()
    out["a"] = dict(unsharded=ref, one_rank=one)
    mcfg = _tp_config("mistral-large-123b", TP_MISTRAL_LAYERS)
    mref = _tp_serve(mcfg, _traffic(TP_REQUESTS, mcfg.vocab_size, ENGINE_SEED), MeshConfig(),
                     "(c) mistral-large-123b tp=1")
    _tp_line(f"(c) mistral-large-123b ({TP_MISTRAL_LAYERS} layers) tp=1", mref, card)
    dcfg = _tp_config("deepseek-moe-16b", TP_DEEPSEEK_LAYERS)
    dref = _tp_serve(dcfg, _traffic(TP_REQUESTS, dcfg.vocab_size, ENGINE_SEED),
                     MeshConfig(), "(d) deepseek-moe-16b tp=1")
    _tp_line(f"(d) deepseek-moe-16b ({TP_DEEPSEEK_LAYERS} layers) tp=1", dref, card)
    print(f"[tp] (a) and the tp=1 references in {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    ranks = spawn(_tp_rank, 2, "gloo", device="shared")
    print(f"[tp] (b)-(e): two ranks in {time.perf_counter() - t1:.1f} s", flush=True)
    for rank, res in enumerate(ranks):
        for key, want, label in (("llama", ref, "(b) llama3.2-1b"),
                                 ("mistral", mref, "(c) mistral-large-123b"),
                                 ("deepseek", dref, "(d) deepseek-moe-16b")):
            _tp_line(f"{label} tp=2 rank {rank}", res[key], card)
            require(res[key]["streams"] == want["streams"],
                    f"{label}: rank {rank}'s tp=2 streams differ from tp=1")
        m = res["mistral"]
        print(f"[tp] (c) rank {rank}: params {m['param_bytes']} bytes, tree_device_bytes "
              f"{m['tree_device_bytes']} ({m['param_bytes'] / 1e9:.3f} GB of "
              f"{mref['param_bytes'] / 1e9:.3f} GB unsharded)", flush=True)
        require(m["param_bytes"] == m["tree_device_bytes"],
                f"(c) rank {rank}: param bytes differ from tree_device_bytes")
        print(f"[tp] rank {rank}: {res['gemm_checked']} sharded projections bitwise their "
              f"unsharded products; max_memory_allocated {res['peak_gib']:.2f} GiB; (b) done "
              f"at {res['t_b']:.1f} s, (c) {res['t_c']:.1f} s, (d) {res['t_d']:.1f} s, (e) "
              f"{res['t_e']:.1f} s", flush=True)
        cc = res["compressed_card_vs_cpu"]
        require(not cc["differ"], f"(e) rank {rank}: compressed_psum_mean on the card differs "
                f"from the host in {cc['differ'][:4]}")
        print(f"[tp] (e) rank {rank}: compressed_psum_mean over {cc['leaves']} gradient "
              f"leaves bitwise equal on the card and the host", flush=True)
    for compress in (False, True):
        a, b = (r["train"][compress] for r in ranks)
        require(a["digest"] == b["digest"], f"(e) compression {compress}: the ranks' params "
                "differ after training")
        require(a["losses"] == b["losses"], f"(e) compression {compress}: the ranks' losses "
                "differ")
        require(all(math.isfinite(x) for x in a["losses"]), "(e) a loss is not finite")
        print(f"[tp] (e) dp=2, compression {compress}: losses {a['losses']}, params bitwise "
              f"equal across ranks (sha256 {a['digest'][:16]}), {a['launches']} "
              f"spoga_gemm_dequant launches a rank", flush=True)
    out["ranks"] = ranks
    out["references"] = dict(mistral=mref, deepseek=dref)
    out["gemm"] = phase_tp_gemms(card)
    print(f"[tp] phase 14 in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def phase_tp_gemms(card):
    """The two GEMM kernels at a tp=2 rank's projection shapes (M=4):
    bitwise against their plain versions, timed against the bound and
    ``torch._int_mm``."""
    from repro_torch.kernels.spoga_gemm import spoga_gemm, spoga_gemm_plain
    from repro_torch.kernels.spoga_gemm_dequant import (
        spoga_gemm_dequant,
        spoga_gemm_dequant_plain,
    )
    gen = torch.Generator(device="cuda").manual_seed(12)
    table = {}
    for arch, shapes in TP_KN.items():
        for kernel, k, n in shapes:
            spec, x, w, xs, ws = _gemm_operands(4, k, n, "int8_spoga", gen)
            if kernel == "spoga_gemm_dequant":
                require(torch.equal(spoga_gemm_dequant(x, w, xs, ws),
                                    spoga_gemm_dequant_plain(x, w, xs, ws)),
                        f"{kernel} K={k} N={n} differs from its plain version")
                t = _gemm_timing(f"tp=2 {arch}", "int8_spoga", 4, k, n, gen, tag="tp")
            else:
                require(torch.equal(spoga_gemm(x, w), spoga_gemm_plain(x, w)),
                        f"{kernel} K={k} N={n} differs from its plain version")
                t = _int_gemm_timing(f"tp=2 {arch}", "int8_spoga", 4, k, n, gen, tag="tp")
            table[(kernel, arch, k, n)] = t
    return table


# ---------------------------------------------------------------------------
# 15. the serving CLI, the default backend, sign-magnitude slicing, the
#     oracles and the examples
# ---------------------------------------------------------------------------

CLI_ARGV = ["--arch", "llama3.2-1b", "--quant-mode", "int8_spoga", "--cache-mode", "paged",
            "--kv-cache-dtype", "int8", "--requests", "8", "--slots", "4", "--prompt-len",
            "128", "--gen", "32", "--stagger", "2"]
ORACLE_MKN = (4, 2048, 8192)       # the decode step's gate/up projection
DEQUANT_RTOL = 1e-6                # test_kernels.py's rtol against ref_spoga_gemm_dequant


def _sample_line(text: str) -> str:
    lines = [ln for ln in text.splitlines() if ln.startswith("[engine] sample (req ")]
    require(len(lines) == 1, f"expected one sample line, got {lines}")
    return lines[0]


def _cli_run(argv, label, kernel, card):
    """``launch.serve.main(argv)`` in this process, every count at 0 just
    before and read just after; ``kernel`` (the GEMM kernel of the run) and
    ``paged_attention`` gated exactly as phase 4 gates them."""
    import contextlib
    import io
    from repro_torch.launch import serve
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        llm = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    text = out.getvalue()
    print(text, end="", flush=True)
    check_counts(launches, plain, (kernel, "paged_attention"), label)
    rep = llm.metrics.report()
    layers = llm.config.n_layers
    require(rep["prefills"] == rep["prefill_dispatches"], f"{label}: stacked prefills")
    expect_gemm = 7 * layers * (rep["decode_steps"] + rep["prefills"])
    expect_attn = layers * rep["decode_steps"]
    require(launches[kernel] == expect_gemm,
            f"{label}: {kernel} launches {launches[kernel]} != {expect_gemm}")
    require(launches["paged_attention"] == expect_attn,
            f"{label}: paged_attention launches {launches['paged_attention']} != {expect_attn}")
    streams = {r.req_id: r.output_tokens for r in llm.metrics.finished}
    require(len(streams) == 8, f"{label}: {len(streams)} of 8 requests finished")
    print(f"[cli] {label}: {rep['requests']} requests, {rep['generated_tokens']} tokens, "
          f"{rep['tokens_per_s']:.1f} tok/s, decode step mean "
          f"{1e3 * rep['decode_step_mean_s']:.2f} ms ({rep['decode_steps']} steps, "
          f"{rep['prefills']} prefills); {kernel} {launches[kernel]} launches "
          f"({7 * layers} a step or prefill), paged_attention {launches['paged_attention']} "
          f"({layers} a decode step), no plain version; main() {wall:.1f} s [{card}]",
          flush=True)
    return llm, streams, launches, _sample_line(text), rep


def _engine_streams(llm, arrivals):
    """The same weights and arrivals straight through ``ServingEngine``, the
    engine configuration the CLI resolves written out."""
    from repro_torch.api import auto_buckets
    from repro_torch.configs import default_cache_len
    from repro_torch.serving import EngineConfig, ServingEngine
    ecfg = EngineConfig(n_slots=4, cache_len=default_cache_len(128, 32),
                        prefill_buckets=auto_buckets(128), cache_mode="paged", page_size=16)
    engine = ServingEngine(llm.config, llm.params, ecfg, device="cuda")
    metrics = engine.run(arrivals)
    torch.cuda.synchronize()
    return {r.req_id: r.output_tokens for r in metrics.finished}


def _encodings_and_oracles(card):
    """(d): the ``encoding=`` dataflows and the ``kernels/ref.py`` oracles
    on CUDA tensors at ``ORACLE_MKN``."""
    from repro_torch.core.spoga import deas_matmul, direct_matmul, spoga_matmul
    from repro_torch.kernels.ref import ref_int8_gemm, ref_spoga_gemm, ref_spoga_gemm_dequant
    from repro_torch.kernels.spoga_gemm import spoga_gemm
    from repro_torch.kernels.spoga_gemm_dequant import spoga_gemm_dequant
    m, k, n = ORACLE_MKN
    gen = torch.Generator(device="cuda").manual_seed(15)
    _, x, w, xs, ws = _gemm_operands(m, k, n, "int8_spoga", gen)
    # the whole int8 range, -128 included, in the first rows of x
    x[0, :256] = torch.arange(-128, 128, dtype=torch.int8, device="cuda")
    direct = direct_matmul(x, w)
    for enc in ("tc", "sm"):
        for fn in (spoga_matmul, deas_matmul):
            require(torch.equal(fn(x, w, encoding=enc), direct),
                    f"(d) {fn.__name__}(encoding={enc!r}) != direct_matmul on the card")
    oracle = ref_int8_gemm(x, w)
    require(torch.equal(oracle, direct), "(d) ref_int8_gemm != direct_matmul")
    require(torch.equal(ref_spoga_gemm(x, w), oracle), "(d) ref_spoga_gemm != ref_int8_gemm")
    require(torch.equal(spoga_gemm(x, w), oracle), "(d) spoga_gemm kernel != ref_spoga_gemm")
    got = spoga_gemm_dequant(x, w, xs, ws)
    want = ref_spoga_gemm_dequant(x, w, xs, ws)
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    require(rel <= DEQUANT_RTOL, f"(d) spoga_gemm_dequant kernel vs ref_spoga_gemm_dequant: "
                                 f"relative error {rel:.3g} > {DEQUANT_RTOL}")
    torch.cuda.synchronize()
    print(f"[cli] (d) M={m} K={k} N={n} on the card: spoga_matmul and deas_matmul with "
          f"encoding 'tc' and 'sm' bitwise direct_matmul; ref_int8_gemm == ref_spoga_gemm == "
          f"the spoga_gemm kernel (int32, bitwise); spoga_gemm_dequant kernel against "
          f"ref_spoga_gemm_dequant max |diff| {err:.3g}, max relative {rel:.3g} "
          f"({'bitwise' if torch.equal(got, want) else 'not bitwise'}) [{card}]", flush=True)
    return {"dequant_max_abs_err": err, "dequant_bitwise": bool(torch.equal(got, want))}


def _subprocess(args, label, timeout=600):
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, *args], cwd=root, capture_output=True, text=True,
                         timeout=timeout, env={**os.environ, "PYTHONPATH": str(root / "src")})
    secs = time.perf_counter() - t0
    require(res.returncode == 0, f"{label} exited {res.returncode}:\n{res.stdout[-2000:]}\n"
                                 f"{res.stderr[-2000:]}")
    return res.stdout, secs


def phase_serve_cli(card):
    """(a) ``launch.serve.main`` on full-width llama3.2-1b at ``int8_spoga``
    over int8 paged KV, launches gated, streams equal ``ServingEngine``'s on
    the same weights and arrivals; (b) with ``set_default_backend
    ("cuda_spoga")`` and no flag: ``spoga_gemm`` and no ``spoga_gemm_dequant``,
    (a)'s streams, and a CPU twin as the default raising on the card; (c)
    ``python -m repro_torch.launch.serve`` in a subprocess, (a)'s sample
    line; (d) the ``encoding=`` dataflows and the oracles on CUDA tensors;
    (e) two examples as subprocesses."""
    from repro_torch.backends import quantized_linear, set_default_backend
    from repro_torch.launch.serve import synthetic_workload
    t0 = time.perf_counter()
    out = {}
    llm, streams, launches, sample, rep = _cli_run(CLI_ARGV, "(a) launch.serve.main",
                                                   "spoga_gemm_dequant", card)
    arrivals = synthetic_workload(llm.config, 8, 128, 32, 2, 0)
    want = _engine_streams(llm, arrivals)
    require(streams == want, "(a) the CLI's streams differ from ServingEngine's on the same "
                             "weights and arrivals")
    print(f"[cli] (a) every request's greedy stream == ServingEngine's ({len(want)} requests, "
          f"prompts {min(len(p) for _, p, _ in arrivals)}-"
          f"{max(len(p) for _, p, _ in arrivals)} tokens)", flush=True)
    out["a"] = {"launches": launches, "report": rep}
    del llm
    torch.cuda.empty_cache()

    set_default_backend("cuda_spoga")
    try:
        llm_b, streams_b, launches_b, _, rep_b = _cli_run(
            CLI_ARGV, "(b) set_default_backend('cuda_spoga'), no flag", "spoga_gemm", card)
    finally:
        set_default_backend(None)
    require(streams_b == streams, "(b) the cuda_spoga default's streams differ from (a)'s")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((4, 2048), generator=g, device="cuda")
    w = torch.randn((2048, 256), generator=g, device="cuda")
    for twin in ("torch_spoga", "torch_deas", "direct"):
        set_default_backend(twin)
        try:
            quantized_linear(x, w, "int8_spoga")
            fail(f"(b) the CPU twin {twin!r} as the default served CUDA tensors")
        except ValueError as e:
            require("not cuda" in str(e), f"(b) {twin}: unexpected error {e}")
        finally:
            set_default_backend(None)
    print("[cli] (b) streams == (a)'s; torch_spoga, torch_deas and direct as the default "
          "raise ValueError on CUDA tensors", flush=True)
    out["b"] = {"launches": launches_b, "report": rep_b}
    del llm_b
    torch.cuda.empty_cache()

    text, secs = _subprocess(["-m", "repro_torch.launch.serve", *CLI_ARGV],
                             "(c) python -m repro_torch.launch.serve")
    require(_sample_line(text) == sample, f"(c) sample line {_sample_line(text)!r} != (a)'s "
                                          f"{sample!r}")
    print(f"[cli] (c) python -m repro_torch.launch.serve: exit 0 in {secs:.1f} s, sample "
          f"line == (a)'s: {sample}", flush=True)
    out["c_s"] = secs

    out["d"] = _encodings_and_oracles(card)

    for example in ("torch_quickstart.py", "torch_photonic_sim.py"):
        text, secs = _subprocess([f"examples/{example}"], f"(e) {example}")
        last = text.strip().splitlines()[-1]
        print(f"[cli] (e) examples/{example}: exit 0 in {secs:.1f} s; last line: {last}",
              flush=True)
        if example == "torch_quickstart.py":
            require("3. spoga_gemm (the CUDA kernel on cuda)" in text,
                    "(e) the quickstart did not launch the CUDA kernel")
        else:
            require("Table I reproduction: 15/15 cells exact" in text, "(e) Table I")
    out["seconds"] = time.perf_counter() - t0
    print(f"[cli] phase 15 in {out['seconds']:.1f} s [{card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# 16. sharded training: FSDP, ZeRO-1, tensor parallelism, elastic restore
# ---------------------------------------------------------------------------

SHARDED_LAYERS = 2          # of llama3.2-1b's 16
SHARDED_TRAIN = dict(batch=4, seq=256, steps=2)
SHARDED_MESH = (2, 2)       # (data, model) of (a)
RESTORE_MESHES = ((4, 1), (1, 4))
# the check bounds of tests/test_torch_sharded_train.py (the reference
# test's): loss, params after the steps, gradient leaves (share of each
# leaf's largest magnitude)
SHARDED_LOSS_TOL = 2e-4
SHARDED_PARAM_RTOL = 3e-2
SHARDED_PARAM_ATOL = 3e-3
SHARDED_GRAD_TOL = 2e-2
# the AdamW update itself, which the param bounds cannot see (two steps at lr
# 1e-3 move an element less than the param atol): m, a scaled gradient,
# within SHARDED_GRAD_TOL of each leaf's largest magnitude; v, a scaled
# square, within 2 tol + tol**2; the master moved by AdamW's rule from the
# rank's own m and v within SHARDED_UPDATE_TOL of the lr
SHARDED_V_TOL = 2 * SHARDED_GRAD_TOL + SHARDED_GRAD_TOL ** 2
SHARDED_UPDATE_TOL = 1e-3
# a tp=4 rank's projections of llama3.2-1b: (kernel, K, N) -- q, k/v, gate/up
# column-parallel on spoga_gemm_dequant, o and down row-parallel on
# spoga_gemm -- a 1x4 training rank's at M=1,024 (4 x 256), which (b)
# must launch, and a decode step's at TP4_DECODE_M
TP4_KN = [("spoga_gemm_dequant", 2048, 512), ("spoga_gemm_dequant", 2048, 128),
          ("spoga_gemm_dequant", 2048, 2048), ("spoga_gemm", 512, 2048),
          ("spoga_gemm", 2048, 2048)]
TP4_TRAIN_M = 1024
TP4_DECODE_M = 4


def _sharded_launches(shape, layers, steps):
    """Per-rank GEMM launches of ``steps`` training steps on a (data, model)
    mesh without remat: the forward's 7 projections a layer, at tp>1 the 5
    column-parallel ones on ``spoga_gemm_dequant`` and the row-parallel o
    and down on ``spoga_gemm``; the straight-through backward launches
    none."""
    tp = shape[1] > 1
    return {"spoga_gemm_dequant": (5 if tp else 7) * layers * steps,
            "spoga_gemm": (2 * layers * steps if tp else 0)}


def _sharded_counted(label, shape, layers, steps, drive, seen):
    """``drive()`` with every kernel count at 0 just before and read just
    after, gated exactly (no plain version).  Every (kernel, M, K, N) that
    the GEMM backends hand the two wrappers in the run is added to
    ``seen`` (for (c))."""
    from repro_torch.backends import impls
    wrapped = {}
    for name in ("spoga_gemm", "spoga_gemm_dequant"):
        fn = wrapped[name] = getattr(impls, name)

        def recording(x, w, *args, _name=name, _fn=fn, **kw):
            seen.add((_name, x.shape[0], x.shape[1], w.shape[1]))
            return _fn(x, w, *args, **kw)

        setattr(impls, name, recording)
    reset_counts()
    try:
        out = drive()
    finally:
        for name, fn in wrapped.items():
            setattr(impls, name, fn)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    want = _sharded_launches(shape, layers, steps)
    check_counts(launches, plain, tuple(k for k, v in want.items() if v), label)
    for name, n in want.items():
        require(launches[name] == n, f"{label}: {name} launched {launches[name]} times, "
                                     f"want {n}")
    return out, {k: launches[k] for k in want}


def _leaf_digests(tree) -> list:
    import hashlib
    return [hashlib.sha256(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu()
                           .numpy().tobytes()).hexdigest() for _, t in _leaves(tree)]


def _block_errors(local, full, specs, mesh, cfg, label, grads=False):
    """The worst error of this rank's blocks ``local`` against the same
    blocks of the unsharded ``full``: gradients as a share of each leaf's
    largest magnitude (``SHARDED_GRAD_TOL``), params within the param
    bounds.  Returns the worst share (gradients) or absolute error."""
    from repro_torch.runtime.sharding import spec_leaves
    from repro_torch.shard.core import shard_leaf
    from repro_torch.tree import leaf_paths
    paths = list(leaf_paths(full))
    worst = 0.0
    for (name, a), (_, f), spec, path in zip(_leaves(local), _leaves(full),
                                            spec_leaves(specs, full), paths):
        b = shard_leaf(f, spec, mesh, cfg, path)
        err = (a.float() - b.float()).abs()
        if grads:
            scale = max(f.float().abs().max().item(), 1e-30)
            share = err.max().item() / scale
            worst = max(worst, share)
            require(share <= SHARDED_GRAD_TOL, f"{label}: gradient {name} off the unsharded "
                    f"step's by {share:.4%} of its largest magnitude")
        else:
            over = err - (SHARDED_PARAM_ATOL + SHARDED_PARAM_RTOL * b.float().abs())
            require(over.max().item() <= 0, f"{label}: param {name} off the unsharded "
                    f"step's by {err.max().item():.4g}")
            worst = max(worst, err.max().item())
    return worst


def _sharded_lr(tcfg, step: int) -> float:
    """The schedule's learning rate at ``step`` in float64 (the reference's
    warmup and decay formulas)."""
    warm = min(step / max(tcfg.warmup_steps, 1), 1.0)
    if tcfg.schedule == "constant":
        return tcfg.learning_rate * warm
    frac = min(max((step - tcfg.warmup_steps) / max(tcfg.total_steps - tcfg.warmup_steps, 1),
                   0.0), 1.0)
    decay = 1.0 - frac if tcfg.schedule == "linear" else 0.5 * (1.0 + math.cos(math.pi * frac))
    return tcfg.learning_rate * warm * decay


def _update_errors(opt, params, master0, ref, specs, mesh, cfg, tcfg, label, scales=None):
    """This rank's AdamW blocks ``opt`` and param blocks ``params`` after a
    step, from the master blocks ``master0`` before it (on any device), against the
    unsharded step's full moments ``ref`` (``{"m", "v"}``; with ``scales``,
    ``{"m", "v"}`` -> each full leaf's largest magnitude, ``ref`` holds the
    rank's blocks already, on any device): m within
    ``SHARDED_GRAD_TOL`` and v within ``SHARDED_V_TOL`` of each leaf's
    largest magnitude; the master ``master0`` moved by AdamW's rule from the
    rank's own m and v within ``SHARDED_UPDATE_TOL`` of the lr (a step that
    did not update, or updated a block from another block's moments, fails);
    each param block the master cast, bit for bit (where ZeRO-1 splits a dim
    the param holds whole, the master's part of it).  Returns the worst m
    and v shares and the worst master error over the lr."""
    from repro_torch.runtime.sharding import spec_leaves
    from repro_torch.shard.core import shard_leaf
    from repro_torch.tree import leaf_paths
    p_specs, o_specs = specs
    step = int(opt["step"])
    lr = _sharded_lr(tcfg, step)
    bc1, bc2 = 1.0 - tcfg.beta1 ** step, 1.0 - tcfg.beta2 ** step
    worst = {}
    paths = list(leaf_paths(ref["m"]))
    for key, tol in (("m", SHARDED_GRAD_TOL), ("v", SHARDED_V_TOL)):
        worst[key] = 0.0
        for i, ((name, a), (_, f), spec, path) in enumerate(zip(
                _leaves(opt[key]), _leaves(ref[key]), spec_leaves(o_specs[key], ref[key]),
                paths)):
            b = f if scales else shard_leaf(f, spec, mesh, cfg, path)
            top = scales[key][i] if scales else f.abs().max().item()
            share = _chunked_max(lambda sl: (a.reshape(-1)[sl] - b.reshape(-1)[sl].to(a.device))
                                 .abs(), a.numel()) / max(top, 1e-30)
            worst[key] = max(worst[key], share)
            require(share <= tol, f"{label}: {key} {name} off the unsharded step's by "
                                  f"{share:.4%} of its largest magnitude")
    worst["master"] = 0.0
    data = mesh.axis_rank("data")
    for (name, w1), (_, w0), (_, m), (_, v), (_, p), p_spec, o_spec in zip(
            _leaves(opt["master"]), _leaves(master0), _leaves(opt["m"]), _leaves(opt["v"]),
            _leaves(params), spec_leaves(p_specs, ref["m"]), spec_leaves(o_specs["master"],
                                                                         ref["m"])):

        def off(sl, w1=w1, w0=w0, m=m, v=v):
            w0c = w0.reshape(-1)[sl].to(w1.device).double()
            mc, vc = m.reshape(-1)[sl].double(), v.reshape(-1)[sl].double()
            rule = w0c - lr * ((mc / bc1) / ((vc / bc2).sqrt() + 1e-8)
                               + tcfg.weight_decay * w0c)
            return (w1.reshape(-1)[sl].double() - rule).abs()

        err = _chunked_max(off, w1.numel()) / lr
        worst["master"] = max(worst["master"], err)
        require(err <= SHARDED_UPDATE_TOL, f"{label}: master {name} off AdamW's rule from its "
                                           f"own m and v by {err:.3g} of the lr")
        for dim, (a, b) in enumerate(zip(p_spec, o_spec)):
            names_a = a if isinstance(a, tuple) else (a,)
            names_b = b if isinstance(b, tuple) else (b,)
            if "data" in names_b and "data" not in names_a:
                part = p.shape[dim] // mesh.shape["data"]
                p = p.narrow(dim, data * part, part)
        require(torch.equal(p, w1.to(p.dtype)), f"{label}: param {name} is not its master cast")
    return worst


def _chunked_max(fn, n: int, chunk: int = 1 << 26) -> float:
    """The largest element of ``fn(slice)`` over the slices of ``range(n)``
    in chunks of ``chunk``: the f64 copies of a whole vocab leaf's block do
    not fit beside another rank's state on one card."""
    return max(fn(slice(i, i + chunk)).max().item() for i in range(0, n, chunk))


def _unsharded_steps(cfg, tcfg, params, opt, batches):
    """The port's unsharded step on ``batches`` from ``params`` / ``opt`` (in
    place): (the first step's gradients, the losses, the moments after the
    first step)."""
    from repro_torch.launch.steps import _loss_and_grads, make_train_step
    from repro_torch.tree import tree_map
    _, grads = _loss_and_grads(params, cfg, tcfg, {"tokens": batches[0]})
    step = make_train_step(cfg, tcfg)
    losses, first = [], None
    for b in batches:
        params, opt, m = step(params, opt, {"tokens": b})
        losses.append(float(m["loss"]))
        if first is None:
            first = tree_map(torch.clone, {"m": opt["m"], "v": opt["v"]})
    return grads, losses, first


def _sharded_rank(rank, dev, root):
    """Phase 16 (a)-(b) in one of four gloo ranks that share ``cuda:0``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (
        _sharded_loss_and_grads,
        make_train_step,
        sharded_layout,
    )
    from repro_torch.models import init_params, param_shapes
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.runtime.sharding import opt_state_specs, param_specs
    from repro_torch.shard import tree_device_bytes
    from repro_torch.shard.core import shard_opt_state, shard_params, shard_tree
    from repro_torch.tree import tree_map

    out = {}
    t0 = time.perf_counter()
    cfg = _train_cfg(n_layers=SHARDED_LAYERS, remat=False)
    tcfg = TrainConfig(**TRAIN_LR)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, SHARDED_TRAIN["seq"], SHARDED_TRAIN["batch"],
                                  seed=ENGINE_SEED, device=str(dev))
    steps = SHARDED_TRAIN["steps"]
    batches = [pipe.global_batch_at(i) for i in range(steps + 1)]
    meta = param_shapes(cfg)
    opt_meta = adamw_init(meta, device="meta")
    meshes = {SHARDED_MESH: make_host_mesh(*SHARDED_MESH, backend="gloo", device=dev)}
    for shape in RESTORE_MESHES:
        meshes[shape] = make_host_mesh(*shape, backend="gloo", device=dev)

    def specs_on(mesh):
        p = param_specs(meta, mesh, cfg, fsdp=tcfg.fsdp)
        return p, opt_state_specs(opt_meta, p, mesh, tcfg.zero1)

    # (a) the unsharded reference on the card, then 2x2
    mesh = meshes[SHARDED_MESH]
    p_specs, o_specs = specs_on(mesh)
    full = init_params(cfg, seed=ENGINE_SEED, device=dev)
    opt = shard_opt_state(adamw_init(full, device=dev), p_specs, mesh, tcfg.zero1, cfg=cfg)
    # the blocks apart from ``full`` (a leaf held whole is ``full``'s own)
    params = tree_map(torch.clone, shard_params(full, mesh, cfg, fsdp=tcfg.fsdp))
    ref_grads, ref_losses, ref_first = _unsharded_steps(cfg, tcfg, full,
                                                        adamw_init(full, device=dev),
                                                        batches[:steps])
    ref_params = full
    torch.cuda.empty_cache()
    layout = sharded_layout(cfg, tcfg, mesh)
    local = batches[0].chunk(layout.dp)[layout.data.rank]
    _, grads = _sharded_loss_and_grads(params, layout, tcfg, {"tokens": local})
    out["grad_share"] = _block_errors(grads, ref_grads, layout.g_specs, mesh, cfg,
                                      f"(a) rank {rank}", grads=True)
    del grads, ref_grads
    torch.cuda.synchronize()
    step = make_train_step(cfg, tcfg, mesh=mesh)
    master0 = tree_map(torch.clone, opt["master"])
    first = {}
    peaks = []

    def run():
        losses, times = [], []
        nonlocal params, opt
        for b in batches[:steps]:
            # a step's peak above what it starts with (the rank's blocks, and
            # this phase's references and copies, none of them the step's)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            params, opt, m = step(params, opt, {"tokens": b})
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t)
            peaks.append((torch.cuda.max_memory_allocated() - base) / 2**30)
            if not first:
                # the next step updates these blocks in place (no kernel)
                first.update(tree_map(torch.clone, {"opt": opt, "params": params}))
        return losses, times

    seen = {SHARDED_MESH: set()}
    (losses, times), out["launches"] = _sharded_counted(
        f"(a) rank {rank} {SHARDED_MESH[0]}x{SHARDED_MESH[1]}", SHARDED_MESH, cfg.n_layers,
        steps, run, seen[SHARDED_MESH])
    out["update"] = _update_errors(first["opt"], first["params"], master0, ref_first,
                                   (p_specs, o_specs), mesh, cfg, tcfg, f"(a) rank {rank}")
    del first, master0, ref_first
    out["peak_gib"] = peaks
    for a, b in zip(losses, ref_losses):
        require(abs(a - b) <= SHARDED_LOSS_TOL * (1 + abs(b)),
                f"(a) rank {rank}: loss {a} against the unsharded step's {b}")
    out["param_err"] = _block_errors(params, ref_params, p_specs, mesh, cfg, f"(a) rank {rank}")
    del ref_params
    out.update(losses=losses, ref_losses=ref_losses, step_s=times,
               coords={a: mesh.axis_rank(a) for a in mesh.axis_names},
               digests={"params": _leaf_digests(params), "opt": _leaf_digests(opt)},
               param_bytes=sum(t.numel() * t.element_size() for _, t in _leaves(params)),
               opt_bytes=sum(t.numel() * t.element_size() for _, t in _leaves(opt)),
               tree_device_bytes=(tree_device_bytes(meta, p_specs, mesh),
                                  tree_device_bytes(opt_meta, o_specs, mesh)))
    out["t_a"] = time.perf_counter() - t0
    # (b) an async save on 2x2, restored onto 4x1 and 1x4
    manager = CheckpointManager(root, keep_n=1, async_save=True, mesh=mesh, cfg=cfg)
    t = time.perf_counter()
    manager.save(steps, (params, opt), specs=(p_specs, o_specs))
    out["save_call_s"] = time.perf_counter() - t
    manager.wait()
    out["save_s"] = time.perf_counter() - t
    del params, opt
    torch.cuda.empty_cache()
    # the saved tree whole, each target's blocks of it, then the unsharded
    # resumed step from it
    t = time.perf_counter()
    _, saved, _ = restore_checkpoint(root, None, (meta, opt_meta), device=dev)
    out["restore_whole_s"] = time.perf_counter() - t
    want_blocks = {shape: tree_map(torch.clone, shard_tree(saved, specs_on(meshes[shape]),
                                                           meshes[shape], cfg))
                   for shape in RESTORE_MESHES}
    step = make_train_step(cfg, tcfg)
    ref_loss = float(step(saved[0], saved[1], {"tokens": batches[steps]})[2]["loss"])
    ref_params = saved[0]
    ref_moments = {"m": saved[1]["m"], "v": saved[1]["v"]}
    del saved
    torch.cuda.empty_cache()
    out["restored"] = {}
    for shape in RESTORE_MESHES:
        mesh = meshes[shape]
        specs = specs_on(mesh)
        label = f"(b) rank {rank} {shape[0]}x{shape[1]}"
        t = time.perf_counter()
        _, (params, opt), _ = restore_checkpoint(root, None, (meta, opt_meta), mesh=mesh,
                                                 specs=specs, cfg=cfg)
        res = {"restore_s": time.perf_counter() - t}
        for (name, a), (_, b) in zip(_leaves((params, opt)), _leaves(want_blocks.pop(shape))):
            require(a.dtype == b.dtype and torch.equal(a, b),
                    f"{label}: restored block {name} is not the slice of the saved tree")
        step = make_train_step(cfg, tcfg, mesh=mesh)
        master0 = tree_map(torch.clone, opt["master"])
        seen[shape] = set()

        def one_step():
            nonlocal params, opt
            params, opt, m = step(params, opt, {"tokens": batches[steps]})
            return float(m["loss"])

        loss, res["launches"] = _sharded_counted(label, shape, cfg.n_layers, 1, one_step,
                                                 seen[shape])
        res["update"] = _update_errors(opt, params, master0, ref_moments, specs, mesh, cfg, tcfg,
                                       label)
        del master0
        require(abs(loss - ref_loss) <= SHARDED_LOSS_TOL * (1 + abs(ref_loss)),
                f"{label}: loss {loss} against the unsharded resumed step's {ref_loss}")
        res["param_err"] = _block_errors(params, ref_params, specs[0], mesh, cfg, label)
        res.update(loss=loss, ref_loss=ref_loss)
        out["restored"][shape] = res
        del params, opt
        torch.cuda.empty_cache()
    out["t_b"] = time.perf_counter() - t0
    out["gemm_shapes"] = {shape: sorted(s) for shape, s in seen.items()}
    return out


def phase_sharded_gemms(card, launched):
    """(c) Both GEMM kernels at every (kernel, M, K, N) in ``launched`` (the
    shapes the counted runs of (a) and (b) gave them, by the meshes that
    launched each) and at a tp=4 rank's decode step (``TP4_KN`` at
    ``TP4_DECODE_M``): bitwise against their plain versions, timed against
    the bound and ``torch._int_mm``."""
    from repro_torch.kernels.spoga_gemm import spoga_gemm, spoga_gemm_plain
    from repro_torch.kernels.spoga_gemm_dequant import (
        spoga_gemm_dequant,
        spoga_gemm_dequant_plain,
    )
    cases = {key: sorted(meshes) for key, meshes in launched.items()}
    for kernel, k, n in TP4_KN:
        require((kernel, TP4_TRAIN_M, k, n) in cases, f"(c) the 1x4 step never launched "
                                                      f"{kernel} at M={TP4_TRAIN_M} K={k} N={n}")
        cases.setdefault((kernel, TP4_DECODE_M, k, n), []).append("tp=4 decode")
    gen = torch.Generator(device="cuda").manual_seed(16)
    table = {}
    for (kernel, m, k, n), runs in sorted(cases.items()):
        spec, x, w, xs, ws = _gemm_operands(m, k, n, "int8_spoga", gen)
        if kernel == "spoga_gemm_dequant":
            got, want = spoga_gemm_dequant(x, w, xs, ws), spoga_gemm_dequant_plain(x, w, xs, ws)
            timing = _gemm_timing
        else:
            got, want = spoga_gemm(x, w), spoga_gemm_plain(x, w)
            timing = _int_gemm_timing
        require(torch.equal(got, want), f"(c) {kernel} M={m} K={k} N={n} differs from its "
                                        "plain version")
        table[(kernel, m, k, n)] = dict(
            timing(f"{kernel} ({', '.join(runs)}) llama3.2-1b", "int8_spoga", m, k, n, gen,
                   tag="sharded"), launched_by=runs)
    return table


def phase_sharded_train(card):
    """16. (a)-(b) in four gloo ranks sharing the card, then (c)."""
    import tempfile
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    print(f"[sharded] four gloo ranks on cuda:0 (gloo stages every collective on a CUDA "
          f"tensor through host memory): llama3.2-1b full width, {SHARDED_LAYERS} layers, "
          f"int8_spoga, {SHARDED_TRAIN['batch']} x {SHARDED_TRAIN['seq']} tokens, "
          f"TrainConfig(fsdp=True, zero1=True) [{card}]", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as root:
        ranks = spawn(_sharded_rank, 4, "gloo", device="shared", args=(root,))
    t_ranks = time.perf_counter() - t0
    shape = f"{SHARDED_MESH[0]}x{SHARDED_MESH[1]}"
    for rank, res in enumerate(ranks):
        require(res["param_bytes"] == res["tree_device_bytes"][0] and
                res["opt_bytes"] == res["tree_device_bytes"][1],
                f"(a) rank {rank}: param / optimizer bytes {res['param_bytes']} / "
                f"{res['opt_bytes']} differ from tree_device_bytes {res['tree_device_bytes']}")
        print(f"[sharded] (a) rank {rank} {shape} {res['coords']}: losses {res['losses']} "
              f"(unsharded {res['ref_losses']}), steps {[round(s, 3) for s in res['step_s']]} "
              f"s, launches {res['launches']}, worst gradient leaf "
              f"{100 * res['grad_share']:.3f}% of its largest magnitude, first update: m "
              f"{100 * res['update']['m']:.3f}%, v {100 * res['update']['v']:.3f}%, master "
              f"{res['update']['master']:.3g} lr off AdamW's rule, params within "
              f"{res['param_err']:.3g}; params {res['param_bytes']} + optimizer "
              f"{res['opt_bytes']} bytes = tree_device_bytes, max_memory_allocated a step "
              f"above its start {', '.join(f'{g:.2f}' for g in res['peak_gib'])} GiB [{card}]",
              flush=True)
        for target, r in res["restored"].items():
            print(f"[sharded] (b) rank {rank} {target[0]}x{target[1]}: restored in "
                  f"{r['restore_s']:.2f} s (whole: {res['restore_whole_s']:.2f} s; blocks "
                  f"bitwise the saved tree's), loss {r['loss']:.6f} (unsharded resumed "
                  f"{r['ref_loss']:.6f}), launches {r['launches']}, update: m "
                  f"{100 * r['update']['m']:.3f}%, v {100 * r['update']['v']:.3f}%, master "
                  f"{r['update']['master']:.3g} lr off AdamW's rule, params within "
                  f"{r['param_err']:.3g}", flush=True)
    # ranks that hold the same block hold the same bits
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import param_shapes
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.runtime.sharding import opt_state_specs, param_specs, spec_leaves
    import types
    cfg = _train_cfg(n_layers=SHARDED_LAYERS, remat=False)
    tcfg = TrainConfig(**TRAIN_LR)
    stub = types.SimpleNamespace(shape=dict(zip(("data", "model"), SHARDED_MESH)),
                                 axis_names=("data", "model"))
    meta = param_shapes(cfg)
    p_specs = param_specs(meta, stub, cfg, fsdp=tcfg.fsdp)
    o_specs = opt_state_specs(adamw_init(meta, device="meta"), p_specs, stub, tcfg.zero1)
    pairs = 0
    for key, specs, like in (("params", p_specs, meta),
                             ("opt", o_specs, adamw_init(meta, device="meta"))):
        for i, spec in enumerate(spec_leaves(specs, like)):
            used = sorted({a for e in spec if e is not None
                           for a in (e if isinstance(e, tuple) else (e,))})
            groups = {}
            for res in ranks:
                groups.setdefault(tuple(res["coords"][a] for a in used), []).append(
                    res["digests"][key][i])
            for digests in groups.values():
                require(len(set(digests)) == 1, f"(a) {key} leaf {i}: replicas differ")
                pairs += len(digests) - 1
    losses = ranks[0]["losses"]
    require(all(r["losses"] == losses for r in ranks), "(a) the ranks' losses differ")
    save = max(r["save_s"] for r in ranks)
    print(f"[sharded] (a) {shape}: losses {losses} on every rank, {pairs} replica pairs "
          f"bitwise equal (sha256); (b) async save {save:.2f} s (call "
          f"{max(r['save_call_s'] for r in ranks):.2f} s), restores onto "
          f"{', '.join(f'{a}x{b}' for a, b in RESTORE_MESHES)}; four ranks in {t_ranks:.1f} s "
          f"[{card}]", flush=True)
    launched = {}
    for res in ranks:
        for (dp, tp), shapes in res["gemm_shapes"].items():
            for key in shapes:
                launched.setdefault(tuple(key), set()).add(f"{dp}x{tp}")
    out = {"ranks": ranks, "gemm": phase_sharded_gemms(card, launched)}
    print(f"[sharded] phase 16 in {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# 17. tensor-parallel serving of MLA, the recurrent archs, the
#     encoder-decoder and frontend archs and the numerics watchdog
# ---------------------------------------------------------------------------

TPA_LAYERS = {"minicpm3-4b": 2,              # of 62
              "xlstm-125m": 4,               # of 12: one period, 3 mLSTM + 1 sLSTM
              "recurrentgemma-9b": 3,        # of 38: one period, 2 RG-LRU + local attention
              "seamless-m4t-large-v2": 2,    # of 24 encoder and 24 decoder layers (2 + 2)
              "llava-next-mistral-7b": 2,    # of 32
              "llama3.2-1b": 2}              # of 16: the watchdog's decode
TPA_ENGINE_ARCHS = ("minicpm3-4b", "xlstm-125m", "recurrentgemma-9b")
TPA_BATCH_ARCHS = ("seamless-m4t-large-v2", "llava-next-mistral-7b")
TPA_REQUESTS, TPA_NEW, TPA_PROMPT = 4, 8, (17, 64)
TPA_ROWS, TPA_TOKENS = 4, 32       # serve_batch: rows of source frames / patches
TPA_WATCH_STEPS = 4
# the CLI at full depth (24 + 24 layers), a short static batch
TPA_CLI_ARGV = ["--arch", "seamless-m4t-large-v2", "--quant-mode", "int8_spoga",
                "--batch", "2", "--prompt-len", "16", "--gen", "2"]
# the watchdog's mean relative error: a row-parallel site sums |err| and
# |x| in f64 over the ranks' K slices, the unsharded one takes f32 means
TPA_ERR_RTOL = 1e-5
# a tp=2 rank's projections at M=4 (decode) of minicpm3-4b, recurrentgemma-9b
# and llava-next-mistral-7b: (kernel, K, N), column-parallel and replicated
# ones on spoga_gemm_dequant, row-parallel ones on spoga_gemm
TPA_KN = {
    "minicpm3-4b": [("spoga_gemm_dequant", 2560, 768), ("spoga_gemm_dequant", 768, 1920),
                    ("spoga_gemm_dequant", 2560, 256), ("spoga_gemm_dequant", 2560, 32),
                    ("spoga_gemm_dequant", 2560, 3200), ("spoga_gemm", 1280, 2560),
                    ("spoga_gemm", 3200, 2560)],
    "recurrentgemma-9b": [("spoga_gemm_dequant", 4096, 2048), ("spoga_gemm_dequant", 4096, 128),
                          ("spoga_gemm_dequant", 4096, 6144), ("spoga_gemm", 2048, 4096),
                          ("spoga_gemm", 6144, 4096)],
    "llava-next-mistral-7b": [("spoga_gemm_dequant", 4096, 2048),
                              ("spoga_gemm_dequant", 4096, 512),
                              ("spoga_gemm_dequant", 4096, 7168), ("spoga_gemm", 2048, 4096),
                              ("spoga_gemm", 7168, 4096)],
}


def _row_parallel(cfg):
    """(row-parallel projections a decode step, a prefill) of the stack:
    an attention, MLA or local-attention block's o and down, an RG-LRU
    block's w_out and down, an mLSTM or sLSTM block's w_out; an
    encoder-decoder's encoder layers 2 each in the prefill and each decoder
    layer 2 plus its cross-attention o."""
    from repro_torch.models.transformer import effective_kind, layer_layout
    if cfg.is_encoder_decoder:
        step = 3 * cfg.n_layers
        return step, 2 * cfg.n_encoder_layers + step
    lead, n_periods, tail = layer_layout(cfg)
    kinds = ["dense_ffn_layer"] * lead + list(cfg.block_pattern) * n_periods + list(tail)
    n = sum(1 if effective_kind(k, cfg) in ("mlstm", "slstm") else 2 for k in kinds)
    return n, n


def _tpa_launches(cfg, tp):
    """{kernel: (launches a decode step, a prefill)} at ``int8_spoga``: at
    tp=1 every projection on ``spoga_gemm_dequant`` (``_gemm_launches``,
    ``_encdec_launches``); at tp>1 the row-parallel ones (``_row_parallel``)
    on ``spoga_gemm`` and the rest on ``spoga_gemm_dequant``."""
    if cfg.is_encoder_decoder or cfg.frontend is not None:
        prefill, step = _encdec_launches(cfg)
    else:
        step, prefill, _ = _gemm_launches(cfg)
    if tp == 1:
        return {"spoga_gemm_dequant": (step, prefill), "spoga_gemm": (0, 0)}
    row_step, row_prefill = _row_parallel(cfg)
    return {"spoga_gemm_dequant": (step - row_step, prefill - row_prefill),
            "spoga_gemm": (row_step, row_prefill)}


class _RecordGemms:
    """Notes (kernel, M, K, N) of every call the GEMM backends make to the
    two wrappers while entered (the kernels and their counts unchanged)."""

    def __init__(self, seen):
        self.seen = seen

    def __enter__(self):
        from repro_torch.backends import impls
        self._saved = {}
        for name in ("spoga_gemm", "spoga_gemm_dequant"):
            fn = self._saved[name] = getattr(impls, name)

            def recording(x, w, *args, _name=name, _fn=fn, **kw):
                self.seen.add((_name, x.shape[0], x.shape[1], w.shape[1]))
                return _fn(x, w, *args, **kw)

            setattr(impls, name, recording)
        return self

    def __exit__(self, *exc):
        from repro_torch.backends import impls
        for name, fn in self._saved.items():
            setattr(impls, name, fn)
        return False


def _tpa_gate(label, cfg, tp, calls, seen=None):
    """Read the counts since the last reset and gate them exactly:
    ``calls`` = (decode steps, prefills) of the run."""
    torch.cuda.synchronize()
    launches, plain = read_counts()
    want = {k: s * calls[0] + p * calls[1] for k, (s, p) in _tpa_launches(cfg, tp).items()}
    check_counts(launches, plain, tuple(k for k, v in want.items() if v), label)
    for name, n in want.items():
        require(launches[name] == n, f"{label}: {name} launched {launches[name]} times, "
                                     f"want {n}")
    return {k: launches[k] for k in want}


def _tpa_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in _leaves(tree))


def _tpa_specs(cfg, mesh):
    """(the rank's param bytes by the serving specs, a function from a
    full (shape, dtype) cache tree to the rank's bytes of it)."""
    from repro_torch.models import param_shapes
    from repro_torch.runtime.sharding import param_specs
    from repro_torch.shard import pool_shardings, tree_device_bytes
    from repro_torch.shard.core import as_shapes
    meta = param_shapes(cfg)
    if mesh is None:
        return _tpa_bytes(meta), lambda shapes: _tpa_bytes(as_shapes(shapes))
    return (tree_device_bytes(meta, param_specs(meta, mesh, cfg, fsdp=False), mesh),
            lambda shapes: _tpa_bytes(as_shapes(pool_shardings(shapes, mesh))))


def _tpa_traffic(vocab):
    rng = np.random.default_rng(ENGINE_SEED + 17)
    lens = rng.integers(TPA_PROMPT[0], TPA_PROMPT[1] + 1, TPA_REQUESTS)
    return [(0, rng.integers(0, vocab, int(n)).tolist(), TPA_NEW) for n in lens]


def _tpa_engine(arch, mesh, device, label, seen):
    """``LLM(config=, runtime=)`` of ``arch`` at full width and
    ``TPA_LAYERS`` depth on ``mesh`` (None: unsharded), ``init_params(seed)``
    weights, int8 paged KV in pages of 16, 4 lanes: ``_tpa_traffic`` with
    every count at 0 just before and read just after, gated exactly.  The
    rank's param and cache bytes against the specs'."""
    from repro_torch.api import KVConfig, LLM, MeshConfig, QuantRuntime, RuntimeConfig
    from repro_torch.api import SchedulerConfig
    from repro_torch.models.model import paged_cache_shapes
    cfg = _tp_config(arch, TPA_LAYERS[arch])
    tp = mesh.shape["model"] if mesh is not None else 1
    runtime = RuntimeConfig(quant=QuantRuntime(mode="int8_spoga"),
                            kv=KVConfig(mode="paged", dtype="int8", page_size=16),
                            scheduler=SchedulerConfig(n_slots=TPA_REQUESTS),
                            mesh=MeshConfig(tp=tp) if tp > 1 else MeshConfig())
    llm = LLM(config=cfg, runtime=runtime, seed=ENGINE_SEED, device=device)
    cfg = llm.config
    engine = llm.build_engine(TPA_PROMPT[1], TPA_NEW)
    arrivals = _tpa_traffic(cfg.vocab_size)
    reset_counts()
    t0 = time.perf_counter()
    with _RecordGemms(seen):
        metrics = engine.run(arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rep = metrics.report()
    launches = _tpa_gate(label, cfg, tp, (rep["decode_steps"], rep["prefill_dispatches"]))
    streams = _check_finished(metrics, arrivals, cfg.vocab_size, label)
    store = engine.store
    want_params, cache_bytes = _tpa_specs(cfg, mesh)
    want_cache = cache_bytes(paged_cache_shapes(cfg, store.n_lanes, store.cache_len,
                                                store.page_size, store.n_pages))
    out = dict(streams=streams, launches=launches, wall_s=wall,
               steps=(rep["decode_steps"], rep["prefill_dispatches"]),
               param_bytes=(_tpa_bytes(llm.params), want_params),
               cache_bytes=(_tpa_bytes(store.cache), want_cache))
    del llm, engine, store
    torch.cuda.empty_cache()
    return out


def _tpa_batch(arch, mesh, device, label, seen):
    """``serve_batch(mesh=)`` of ``arch`` (full width, ``TPA_LAYERS``
    depth): ``TPA_ROWS`` rows of ``TPA_TOKENS`` source frames or patch
    embeddings, ``TPA_NEW`` new tokens, every count at 0 just before and
    read just after, gated exactly; a prefill alone before it gives the
    rank's cache bytes."""
    from repro_torch.api import serve_batch
    from repro_torch.configs import default_cache_len
    from repro_torch.models import init_params, prefill
    from repro_torch.models.model import cache_shapes
    from repro_torch.shard import shard_params
    cfg = _tp_config(arch, TPA_LAYERS[arch])
    if cfg.is_encoder_decoder:
        cfg = cfg.with_(n_encoder_layers=TPA_LAYERS[arch])
    cfg = cfg.with_(quant_mode="int8_spoga")
    tp = mesh.shape["model"] if mesh is not None else 1
    params = init_params(cfg, seed=ENGINE_SEED, device=device)
    if mesh is not None:
        params = shard_params(params, mesh, cfg)
    batch = _encdec_batch(cfg, device, batch=TPA_ROWS, src=TPA_TOKENS, patches=TPA_TOKENS)
    cache_len = default_cache_len(TPA_TOKENS, TPA_NEW)
    _, cache = prefill(params, cfg, batch, cache_len, mesh=mesh)
    want_params, cache_bytes = _tpa_specs(cfg, mesh)
    want_cache = cache_bytes(cache_shapes(cfg, TPA_ROWS, cache_len,
                                          TPA_TOKENS if cfg.is_encoder_decoder else 0))
    got_cache = _tpa_bytes(cache)
    del cache
    reset_counts()
    t0 = time.perf_counter()
    with _RecordGemms(seen):
        toks, times = serve_batch(cfg, params, batch, cache_len=cache_len, gen_tokens=TPA_NEW,
                                  mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _tpa_gate(label, cfg, tp, (TPA_NEW - 1, 1))
    require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{label}: token out of range")
    out = dict(tokens=toks.cpu(), launches=launches, wall_s=wall,
               param_bytes=(_tpa_bytes(params), want_params), cache_bytes=(got_cache, want_cache))
    del params
    torch.cuda.empty_cache()
    return out


def _tpa_watchdog(mesh, device):
    """llama3.2-1b (full width, ``TPA_LAYERS`` depth) with
    ``numerics_watchdog`` on: a prefill of 4 x 32 tokens and
    ``TPA_WATCH_STEPS`` decode steps from a fresh registry; the report."""
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.obs import watchdog
    from repro_torch.shard import shard_params
    cfg = _tp_config("llama3.2-1b", TPA_LAYERS["llama3.2-1b"]).with_(
        quant_mode="int8_spoga", numerics_watchdog=True)
    params = init_params(cfg, seed=ENGINE_SEED, device=device)
    if mesh is not None:
        params = shard_params(params, mesh, cfg)
    tokens = torch.from_numpy(np.random.default_rng(ENGINE_SEED + 18).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)).to(device)
    watchdog.reset()
    logits, cache = prefill(params, cfg, {"tokens": tokens}, 48, mesh=mesh)
    for _ in range(TPA_WATCH_STEPS):
        logits, cache = decode_step(params, cfg, logits.argmax(-1).to(torch.int32), cache,
                                    mesh=mesh)
    reg = watchdog.peek_registry()
    out = dict(counters={k: c.value for k, c in reg.counters.items()},
               gauges={k: g.value for k, g in reg.gauges.items()},
               samples={k: list(h.samples) for k, h in reg.histograms.items()},
               saturation=watchdog.saturation_report())
    watchdog.reset()
    del params, cache
    torch.cuda.empty_cache()
    return out


def _tpa_cli(argv, label, tp):
    """``launch.serve.main(argv)`` in this process (the static path of an
    encoder-decoder), every count at 0 just before and read just after,
    gated exactly for a prefill and ``--gen`` - 1 decode steps of the full
    24 + 24 layers; returns (the sample line, launches, wall seconds)."""
    import contextlib
    import io
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = out.getvalue()
    gen = int(argv[argv.index("--gen") + 1])
    launches = _tpa_gate(label, get_config("seamless-m4t-large-v2"), tp, (gen - 1, 1))
    lines = [ln for ln in text.splitlines() if ln.startswith("[serve] sample:")]
    require(len(lines) == 1, f"{label}: expected one sample line, got {text!r}")
    return lines[0], launches, wall


def _tpa_run_all(mesh, device, tag):
    """Every part of phase 17 on ``mesh`` (None: the unsharded run)."""
    out, seen = {"times": {}}, set()
    t0 = time.perf_counter()
    for arch in TPA_ENGINE_ARCHS:
        out[arch] = _tpa_engine(arch, mesh, device, f"(a) {tag} {arch}", seen)
        out["times"][arch] = time.perf_counter() - t0
    for arch in TPA_BATCH_ARCHS:
        out[arch] = _tpa_batch(arch, mesh, device, f"(b) {tag} {arch}", seen)
        out["times"][arch] = time.perf_counter() - t0
    tp = mesh.shape["model"] if mesh is not None else 1
    argv = TPA_CLI_ARGV + (["--tp", str(tp)] if tp > 1 else [])
    out["cli"] = _tpa_cli(argv, f"(c) {tag} launch.serve.main", tp)
    out["times"]["cli"] = time.perf_counter() - t0
    out["watchdog"] = _tpa_watchdog(mesh, device)
    out["times"]["watchdog"] = time.perf_counter() - t0
    out["seen"] = seen
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _tpa_rank(rank, dev):
    """Phase 17 in one of two gloo ranks that share ``cuda:0``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 2, backend="gloo", device=dev)
    return _tpa_run_all(mesh, dev, f"rank {rank} tp=2")


def _tpa_report_diff(got, want):
    """What differs between two watchdog reports (empty: equal, the mean
    relative errors within ``TPA_ERR_RTOL``)."""
    bad = []
    for key in ("counters", "gauges", "saturation"):
        if got[key] != want[key]:
            bad.append(key)
    if set(got["samples"]) != set(want["samples"]):
        return bad + ["labels"]
    for key, ref in want["samples"].items():
        mine = got["samples"][key]
        if "watchdog_quant_err" in key:
            a, b = np.sort(np.array(mine)), np.sort(np.array(ref))
            if a.shape != b.shape or not np.allclose(a, b, rtol=TPA_ERR_RTOL, atol=0):
                bad.append(key)
        elif sorted(mine) != sorted(ref):
            bad.append(key)
    return bad


def phase_tp_archs(card):
    """17. minicpm3-4b, xlstm-125m and recurrentgemma-9b through the engine,
    seamless-m4t-large-v2 and llava-next-mistral-7b through
    ``serve_batch``, the CLI and the watchdog: unsharded here, then in two
    gloo ranks sharing the card (one spawn); streams, bytes, launches and
    the watchdog report gated."""
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    ref = _tpa_run_all(None, "cuda", "tp=1")
    t_ref = time.perf_counter() - t0
    t1 = time.perf_counter()
    ranks = spawn(_tpa_rank, 2, "gloo", device="shared")
    t_ranks = time.perf_counter() - t1
    for rank, res in enumerate(ranks):
        for arch in TPA_ENGINE_ARCHS + TPA_BATCH_ARCHS:
            got, want = res[arch], ref[arch]
            key = "streams" if arch in TPA_ENGINE_ARCHS else "tokens"
            same = (got[key] == want[key]) if key == "streams" else \
                torch.equal(got[key], want[key])
            require(same, f"(a)-(b) {arch}: rank {rank}'s tp=2 tokens differ from tp=1")
            for what in ("param_bytes", "cache_bytes"):
                require(got[what][0] == got[what][1],
                        f"{arch}: rank {rank} holds {got[what][0]} {what}, the specs "
                        f"{got[what][1]}")
            print(f"[tp-archs] {arch} ({TPA_LAYERS[arch]} layers) rank {rank}: tokens equal "
                  f"to tp=1; launches {got['launches']} (tp=1 {want['launches']}); params "
                  f"{got['param_bytes'][0]} bytes (tp=1 {want['param_bytes'][0]}), cache "
                  f"{got['cache_bytes'][0]} bytes (tp=1 {want['cache_bytes'][0]}), both the "
                  f"specs'; run {got['wall_s']:.2f} s (tp=1 {want['wall_s']:.2f} s) [{card}]",
                  flush=True)
        require(res["cli"][0] == ref["cli"][0], f"(c) rank {rank}: the CLI's sample "
                f"{res['cli'][0]!r} differs from tp=1's {ref['cli'][0]!r}")
        print(f"[tp-archs] (c) rank {rank} launch.serve.main --tp 2: {res['cli'][0]} (tp=1 "
              f"the same); launches {res['cli'][1]} (tp=1 {ref['cli'][1]}); main() "
              f"{res['cli'][2]:.1f} s (tp=1 {ref['cli'][2]:.1f} s) [{card}]", flush=True)
        bad = _tpa_report_diff(res["watchdog"], ref["watchdog"])
        require(not bad, f"(d) rank {rank}: the watchdog report differs from tp=1 in {bad}")
        n_labels = len({k for k in ref["watchdog"]["samples"]})
        print(f"[tp-archs] (d) rank {rank} llama3.2-1b watchdog: {n_labels} series, counters, "
              f"gauges, amax and bound samples equal to tp=1, quant error within "
              f"{TPA_ERR_RTOL}; saturation {res['watchdog']['saturation']}", flush=True)
        print(f"[tp-archs] rank {rank}: done at {res['times']}, peak "
              f"{res['peak_gib']:.2f} GiB", flush=True)
    seen = {(kernel, k, n) for kernel, m, k, n in ranks[0]["seen"] if m == TPA_REQUESTS}
    for arch, shapes in TPA_KN.items():
        missing = sorted(set(shapes) - seen)
        require(not missing, f"(e) no tp=2 rank ran {arch}'s {missing} at M={TPA_REQUESTS}")
    print(f"[tp-archs] phase 17: tp=1 in {t_ref:.1f} s, two ranks in {t_ranks:.1f} s "
          f"[{card}]", flush=True)
    return {"ref": ref, "ranks": ranks}


def phase_tp_arch_gemms(card):
    """Phases 2-3 at a tp=2 rank's projection shapes of minicpm3-4b,
    recurrentgemma-9b and llava-next-mistral-7b (``TPA_KN``, M=4): both
    GEMM kernels bitwise against their plain versions, timed against the
    bound and ``torch._int_mm``."""
    from repro_torch.kernels.spoga_gemm import spoga_gemm, spoga_gemm_plain
    from repro_torch.kernels.spoga_gemm_dequant import (
        spoga_gemm_dequant,
        spoga_gemm_dequant_plain,
    )
    gen = torch.Generator(device="cuda").manual_seed(17)
    table = {}
    for arch, shapes in TPA_KN.items():
        for kernel, k, n in shapes:
            if any(key[0] == kernel and key[2:] == (k, n) for key in table):
                continue
            spec, x, w, xs, ws = _gemm_operands(4, k, n, "int8_spoga", gen)
            if kernel == "spoga_gemm_dequant":
                require(torch.equal(spoga_gemm_dequant(x, w, xs, ws),
                                    spoga_gemm_dequant_plain(x, w, xs, ws)),
                        f"{kernel} K={k} N={n} differs from its plain version")
                t = _gemm_timing(f"tp=2 {arch}", "int8_spoga", 4, k, n, gen, tag="tp-archs")
            else:
                require(torch.equal(spoga_gemm(x, w), spoga_gemm_plain(x, w)),
                        f"{kernel} K={k} N={n} differs from its plain version")
                t = _int_gemm_timing(f"tp=2 {arch}", "int8_spoga", 4, k, n, gen,
                                     tag="tp-archs")
            table[(kernel, arch, k, n)] = t
    return table


# ---------------------------------------------------------------------------
# 18. tensor-parallel training of the MoE, MLA, recurrent, encoder-decoder
#     and frontend stacks
# ---------------------------------------------------------------------------

TPT_LAYERS = {"deepseek-moe-16b": 2,         # of 28: 1 dense + 1 MoE (32 experts a rank)
              "minicpm3-4b": 2,              # of 62
              "xlstm-125m": 4,               # of 12: one period, 3 mLSTM + 1 sLSTM
              "recurrentgemma-9b": 3,        # of 38: one period, 2 RG-LRU + local attention
              "seamless-m4t-large-v2": 2,    # of 24 encoder and 24 decoder layers (2 + 2)
              "llava-next-mistral-7b": 2}    # of 32
TPT_BATCH, TPT_SEQ = 2, 128
TPT_SRC = 64                   # seamless-m4t-large-v2's source frames
TPT_MASKED = (32, 48)          # llava: each row's first label positions masked (its image)
TPT_LOSS_TOL = SHARDED_LOSS_TOL
# the archs whose unsharded step runs one rank at a time, its reference kept
# on the host: recurrentgemma-9b's (2.75 B parameters, 44 GB with its AdamW
# state) does not fit beside the other rank's; the others run on both ranks
# at once and keep their references on the card
TPT_ONE_AT_A_TIME = ("recurrentgemma-9b",)


def _tpt_config(arch):
    cfg = _tp_config(arch, TPT_LAYERS[arch]).with_(quant_mode="int8_spoga", remat=False)
    return cfg.with_(n_encoder_layers=TPT_LAYERS[arch]) if cfg.is_encoder_decoder else cfg


def _tpt_batch(cfg, device):
    """One global batch of ``TPT_BATCH`` x ``TPT_SEQ`` from ``ENGINE_SEED``:
    tokens; source frames and target tokens; or patch embeddings and
    labels with each row's first ``TPT_MASKED`` positions masked (-1)."""
    from repro_torch.models.frontends import fake_audio_frames, fake_vision_embeds
    gen = torch.Generator(device=device).manual_seed(ENGINE_SEED + 18)
    tokens = torch.randint(0, cfg.vocab_size, (TPT_BATCH, TPT_SEQ), generator=gen,
                           device=device, dtype=torch.int32)
    if cfg.is_encoder_decoder:
        return {"src_embeds": fake_audio_frames(ENGINE_SEED, cfg, TPT_BATCH, TPT_SRC,
                                                device=device), "tgt_tokens": tokens}
    if cfg.frontend is not None:
        labels = tokens.clone()
        for r, n in enumerate(TPT_MASKED):
            labels[r, :n] = -1
        return {"embeds": fake_vision_embeds(ENGINE_SEED, cfg, TPT_BATCH, TPT_SEQ,
                                             device=device), "labels": labels}
    return {"tokens": tokens}


def _tpt_gate(label, cfg, tp):
    """Read the counts since the last reset: one training step's exact GEMM
    launches at ``tp`` (a prefill's projections, ``_tpa_launches``: the
    straight-through backward launches none), no plain version."""
    torch.cuda.synchronize()
    launches, plain = read_counts()
    want = {k: p for k, (_, p) in _tpa_launches(cfg, tp).items()}
    check_counts(launches, plain, tuple(k for k, v in want.items() if v), label)
    for name, n in want.items():
        require(launches[name] == n, f"{label}: {name} launched {launches[name]} times, "
                                     f"want {n}")
    return {k: launches[k] for k in want}


def _tpt_reference(grads, params, cfg, tcfg, layout, mesh, dev, keep):
    """The rest of the unsharded step after its forward and backward
    (``grads``, the whole model's): its clip by the global norm over every
    leaf, then its AdamW update -- elementwise, so evaluated on copies of
    this rank's param blocks ``params`` with the clipped gradients' blocks,
    bit for bit the whole update's elements (``grad_clip`` then infinite:
    a scale of 1).  The whole AdamW state of recurrentgemma-9b (33 GB) and
    its temporaries do not fit beside the other rank on one card.  Returns
    the gradients and the moments' blocks on ``keep`` (the card or the
    host) and each block's largest magnitude."""
    from repro_torch.optim.optimizers import adamw_init, adamw_update, clip_by_global_norm
    from repro_torch.runtime.sharding import spec_leaves
    from repro_torch.shard.core import shard_leaf
    from repro_torch.tree import leaf_paths, rebuild, tree_map
    kept_grads = [g.to(keep) for _, g in _leaves(grads)]
    clipped, _ = clip_by_global_norm(grads, tcfg.grad_clip)
    blocks = [shard_leaf(g, spec, mesh, cfg, path) for (_, g), spec, path in zip(
        _leaves(clipped), spec_leaves(layout.g_specs, clipped), leaf_paths(clipped))]
    del clipped
    own = tree_map(torch.clone, params)
    opt = adamw_init(own, device=dev)
    adamw_update(own, rebuild(params, iter(blocks)), opt,
                 dataclasses.replace(tcfg, grad_clip=float("inf")))
    tops = [t.abs().max().item() for key in ("m", "v") for _, t in _leaves(opt[key])]
    moments = {key: tree_map(lambda t: t.to(keep), opt[key]) for key in ("m", "v")}
    del own, opt, blocks
    return dict(grads=kept_grads, moments=moments, tops=tops)


def _tpt_arch(arch, mesh, dev, rank, seen):
    """One arch in a rank: the unsharded step (one rank at a time for
    ``TPT_ONE_AT_A_TIME``, the other waiting), then the tp=2 gradients
    (gathered) and the counted tp=2 step, gated against it."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.steps import (
        _loss_and_grads,
        _sharded_loss_and_grads,
        make_train_step,
        sharded_layout,
    )
    from repro_torch.models import init_params, param_shapes
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.runtime.collectives import all_reduce, barrier, world
    from repro_torch.shard import tree_device_bytes
    from repro_torch.shard.core import gather_tree, shard_params
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    label = f"(a) {arch} rank {rank}"
    cfg = _tpt_config(arch)
    tcfg = TrainConfig(**TRAIN_LR)
    batch = _tpt_batch(cfg, dev)
    layout = sharded_layout(cfg, tcfg, mesh)
    alone = arch in TPT_ONE_AT_A_TIME
    times = {}

    def reference():
        t = time.perf_counter()
        full = init_params(cfg, seed=ENGINE_SEED, device=dev)
        params = tree_map(torch.clone, shard_params(full, mesh, cfg, fsdp=tcfg.fsdp))
        torch.cuda.synchronize()
        times["init"] = time.perf_counter() - t
        reset_counts()
        t = time.perf_counter()
        ref_loss, grads = _loss_and_grads(full, cfg, tcfg, batch)
        ref_launches = _tpt_gate(f"{label} unsharded forward and backward", cfg, 1)
        times["forward and backward"] = time.perf_counter() - t
        del full
        t = time.perf_counter()
        ref = _tpt_reference(grads, params, cfg, tcfg, layout, mesh, dev,
                             "cpu" if alone else dev)
        torch.cuda.synchronize()
        times["clip, AdamW, keep"] = time.perf_counter() - t
        ref.update(loss=float(ref_loss), launches=ref_launches)
        del grads
        torch.cuda.empty_cache()
        return params, ref

    if alone:
        for r in range(mesh.size):
            if r == rank:
                params, ref = reference()
            barrier(world(mesh))
    else:
        params, ref = reference()
    t_ref = time.perf_counter() - t0
    # each full moment leaf's largest magnitude: the MAX of the ranks' blocks'
    tops = all_reduce(torch.tensor(ref["tops"], device=dev), world(mesh), "max").tolist()
    n = len(_leaves(ref["moments"]["m"]))
    scales = {"m": tops[:n], "v": tops[n:]}
    _, grads = _sharded_loss_and_grads(params, layout, tcfg, batch)
    grads = gather_tree(grads, layout.g_specs, mesh, cfg)
    grad_share = 0.0
    for (name, g), want in zip(_leaves(grads), ref["grads"]):
        share = _chunked_share(g, want)
        grad_share = max(grad_share, share)
        require(share <= SHARDED_GRAD_TOL, f"{label}: gradient {name} off the unsharded "
                f"step's by {share:.4%} of its largest magnitude")
    del grads, ref["grads"]
    torch.cuda.empty_cache()
    # the rank's AdamW blocks: at data=1 ZeRO-1 splits nothing, so they are
    # adamw_init of the rank's param blocks; the master before the step is
    # the params' values (kept on the host)
    opt = adamw_init(params, device=dev)
    master0 = tree_map(lambda t: t.to("cpu", copy=True), params)
    step = make_train_step(cfg, tcfg, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t = time.perf_counter()
    with _RecordGemms(seen):
        params, opt, m = step(params, opt, batch)
    loss = float(m["loss"])
    step_s = time.perf_counter() - t
    launches = _tpt_gate(f"{label} tp=2 step", cfg, 2)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    require(abs(loss - ref["loss"]) <= TPT_LOSS_TOL * (1 + abs(ref["loss"])),
            f"{label}: loss {loss} against the unsharded step's {ref['loss']}")
    # one rank at a time, each holding its state alone (no cached blocks)
    torch.cuda.empty_cache()
    for r in range(mesh.size):
        if r == rank:
            update = _update_errors(opt, params, master0, ref["moments"],
                                    (layout.p_specs, layout.o_specs), mesh, cfg, tcfg, label,
                                    scales=scales)
            torch.cuda.empty_cache()
        barrier(world(mesh))
    meta = param_shapes(cfg)
    want_bytes = (tree_device_bytes(meta, layout.p_specs, mesh),
                  tree_device_bytes(adamw_init(meta, device="meta"), layout.o_specs, mesh))
    got_bytes = (_tpa_bytes(params), _tpa_bytes(opt))
    require(got_bytes == want_bytes, f"{label}: param / optimizer bytes {got_bytes} differ "
                                     f"from tree_device_bytes {want_bytes}")
    # the leaves the specs replicate over "model", for the replicas check
    from repro_torch.runtime.sharding import spec_leaves
    replicated = {}
    for key, tree, specs in (("params", params, layout.p_specs), ("opt", opt, layout.o_specs)):
        for (name, leaf), spec in zip(_leaves(tree), spec_leaves(specs, tree)):
            if not any(e is not None and "model" in (e if isinstance(e, tuple) else (e,))
                       for e in spec):
                replicated[f"{key}.{name}"] = _leaf_digests(leaf)[0]
    out = dict(loss=loss, ref_loss=ref["loss"], ref_launches=ref["launches"], launches=launches,
               grad_share=grad_share, update=update, bytes=got_bytes, step_s=step_s,
               peak_gib=peak, replicated=replicated, ref_s=t_ref, ref_split=times,
               wall_s=time.perf_counter() - t0)
    del params, opt, master0, ref
    torch.cuda.empty_cache()
    print(f"[tp-train] {label}: loss {loss:.6f} (unsharded {out['ref_loss']:.6f}), launches "
          f"{launches} (unsharded forward {out['ref_launches']}), worst gradient leaf "
          f"{100 * grad_share:.3f}%, m {100 * update['m']:.3f}%, v {100 * update['v']:.3f}%, "
          f"master {update['master']:.3g} lr; params {got_bytes[0]} + optimizer "
          f"{got_bytes[1]} bytes = tree_device_bytes; step {step_s:.2f} s, peak above its "
          f"start {peak:.2f} GiB; unsharded {t_ref:.1f} s ("
          f"{', '.join(f'{k} {v:.1f} s' for k, v in times.items())}"
          f"{', one rank at a time' if alone else ''}), {out['wall_s']:.1f} s in all",
          flush=True)
    return out


def _chunked_share(got, want, chunk=1 << 26):
    """``max |got - want| / max |want|`` of one leaf (``want`` on any
    device), in chunks of ``chunk`` elements: the f32 copies of a whole
    vocab leaf beside the other rank's do not fit on the card."""
    g, w = got.reshape(-1), want.reshape(-1)
    err = top = 0.0
    for i in range(0, g.numel(), chunk):
        a, b = g[i:i + chunk].float(), w[i:i + chunk].to(got.device).float()
        err = max(err, (a - b).abs().max().item())
        top = max(top, b.abs().max().item())
    return err / max(top, 1e-30)


def _tpt_rank(rank, dev):
    """Phase 18 (a) in one of two gloo ranks that share ``cuda:0``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 2, backend="gloo", device=dev)
    seen = set()
    out = {arch: _tpt_arch(arch, mesh, dev, rank, seen) for arch in TPT_LAYERS}
    out["seen"] = sorted(seen)
    return out


def phase_tp_train(card):
    """18. One training step of each of ``TPT_LAYERS``'s archs at full width
    on a (data, model) = (1, 2) mesh of two gloo ranks sharing the card,
    each held to the unsharded step on the card (loss, gathered gradients,
    AdamW blocks, bytes, replicas, exact launches); then (b) both GEMM
    kernels at every shape the tp=2 steps launched, bitwise against their
    plain versions and timed."""
    from repro_torch.kernels.spoga_gemm import spoga_gemm, spoga_gemm_plain
    from repro_torch.kernels.spoga_gemm_dequant import (
        spoga_gemm_dequant,
        spoga_gemm_dequant_plain,
    )
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"[tp-train] two gloo ranks on cuda:0, (data, model) = (1, 2), int8_spoga, "
          f"{TPT_BATCH} x {TPT_SEQ} tokens, TrainConfig(fsdp=True, zero1=True), depths "
          f"{TPT_LAYERS}; this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
          f"[{card}]", flush=True)
    # the ranks' allocators grow segments in place: recurrentgemma-9b's two
    # ranks share the card with about 10 GB to spare
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = spawn(_tpt_rank, 2, "gloo", device="shared")
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    t_ranks = time.perf_counter() - t0
    for arch in TPT_LAYERS:
        a, b = (r[arch] for r in ranks)
        require(a["loss"] == b["loss"], f"(a) {arch}: the ranks' losses differ")
        require(a["replicated"].keys() == b["replicated"].keys(), f"(a) {arch}: replicated "
                "leaves differ between the ranks")
        bad = sorted(k for k in a["replicated"] if a["replicated"][k] != b["replicated"][k])
        require(not bad, f"(a) {arch}: replicas differ between the ranks: {bad[:4]}")
        print(f"[tp-train] (a) {arch}: {len(a['replicated'])} replicated leaves bitwise equal "
              f"on both ranks (sha256)", flush=True)
    # (b) every (kernel, M, K, N) the counted tp=2 steps launched
    cases = sorted({tuple(key) for r in ranks for key in r["seen"]})
    gen = torch.Generator(device="cuda").manual_seed(18)
    table = {}
    for kernel, m, k, n in cases:
        spec, x, w, xs, ws = _gemm_operands(m, k, n, "int8_spoga", gen)
        if kernel == "spoga_gemm_dequant":
            same = torch.equal(spoga_gemm_dequant(x, w, xs, ws),
                               spoga_gemm_dequant_plain(x, w, xs, ws))
            timing = _gemm_timing
        else:
            same = torch.equal(spoga_gemm(x, w), spoga_gemm_plain(x, w))
            timing = _int_gemm_timing
        require(same, f"(b) {kernel} M={m} K={k} N={n} differs from its plain version")
        table[(kernel, m, k, n)] = timing("a tp=2 training rank", "int8_spoga", m, k, n, gen,
                                          tag="tp-train")
    print(f"[tp-train] (b) {len(cases)} GEMM cases bitwise their plain versions; phase 18 in "
          f"{time.perf_counter() - t0:.1f} s (two ranks {t_ranks:.1f} s) [{card}]", flush=True)
    return {"ranks": ranks, "gemm": table}


# ---------------------------------------------------------------------------
# 19. the dry run: one rank's program of a cell on meta, then on the card
# ---------------------------------------------------------------------------

DRY_CELLS = (("deepseek-moe-16b", "decode_32k"), ("recurrentgemma-9b", "long_500k"),
             ("seamless-m4t-large-v2", "prefill_32k"))
DRY_CARD_CELL = ("deepseek-moe-16b", "decode_32k")
# card peak against the meta run's hbm_per_device_gib: tight enough that
# a tracker missing its temp term (~7% of this cell's total) fails
DRY_PEAK_TOL = 0.02


def _dry_argument_bytes(arch, shape_name):
    """``tree_device_bytes`` of the cell's global trees under its specs on
    the dry 16x16 mesh."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import cell_program
    from repro_torch.shard.memory import tree_device_bytes

    mesh = make_production_mesh(dry=True)
    _, kwargs, in_specs, _, _ = cell_program(get_config(arch), SHAPES[shape_name], mesh)
    return sum(tree_device_bytes(kwargs[n], in_specs[n], mesh) for n in kwargs)


def phase_dryrun(card):
    from repro_torch.launch.dryrun import KERNELS, kernel_counts, run_cell

    out = {"meta": {}}
    for arch, shape_name in DRY_CELLS:
        before = kernel_counts()
        t0 = time.perf_counter()
        rec = run_cell(arch, shape_name, False, "int8_spoga", calibrate=False)
        after = kernel_counts()
        label = f"phase 19 (a) {arch} x {shape_name} 16x16"
        require(rec["ok"], f"{label}: {rec.get('error')}")
        want = _dry_argument_bytes(arch, shape_name)
        require(rec["memory"]["argument_bytes"] == want,
                f"{label}: argument bytes {rec['memory']['argument_bytes']} != "
                f"tree_device_bytes {want}")
        meta = {k: after[k][2] - before[k][2] for k in KERNELS}
        require(all(after[k][0] == before[k][0] and after[k][1] == before[k][1]
                    for k in KERNELS), f"{label}: a meta run launched or ran a plain version")
        require(meta == {k: rec["kernels"].get(k, 0) for k in KERNELS},
                f"{label}: META_CALLS {meta} != the run's kernel calls {rec['kernels']}")
        print(f"[dryrun] {label}: {time.perf_counter() - t0:.1f} s, "
              f"{json.dumps(rec)}", flush=True)
        out["meta"][(arch, shape_name)] = (rec, meta)

    arch, shape_name = DRY_CARD_CELL
    label = f"phase 19 (b) {arch} x {shape_name} 16x16 rank 0 on the card"
    meta_rec, meta_calls = out["meta"][DRY_CARD_CELL]
    torch.cuda.empty_cache()
    reset_counts()
    before = kernel_counts()
    rec = run_cell(arch, shape_name, False, "int8_spoga", calibrate=False, device="cuda")
    after = kernel_counts()
    launches, plain = read_counts()
    require(rec["ok"], f"{label}: {rec.get('error')}")
    got = rec["card"]
    print(f"[dryrun] {label}: launches {got['launches']} (meta run's META_CALLS "
          f"{meta_calls}), plain calls {got['plain_calls']}", flush=True)
    # the card check's first run counts; its second, timed run launches as many again
    require(got["launches"] == meta_calls,
            f"{label}: launches {got['launches']} != META_CALLS {meta_calls}")
    require(all(n == 0 for n in got["plain_calls"].values()) and
            all(v == 0 for v in plain.values()), f"{label}: a plain version ran on the card")
    # the record's counts come from a meta run of the cell after the card's
    require(rec["counted_on"] == "meta" and rec["kernels"] == meta_rec["kernels"] and
            all(after[k][2] - before[k][2] == meta_calls[k] for k in KERNELS),
            f"{label}: a meta branch ran on the card, or the record's meta run differs")
    require(launches["spoga_gemm_dequant"] == 2 * meta_calls["spoga_gemm_dequant"] and
            launches["spoga_gemm"] == 2 * meta_calls["spoga_gemm"],
            f"{label}: counted launches {launches} != two runs of {meta_calls}")
    require(got["collectives"] == meta_rec["collectives"],
            f"{label}: collectives {got['collectives']} != the meta run's "
            f"{meta_rec['collectives']}")
    require(got["argument_bytes"] == meta_rec["memory"]["argument_bytes"],
            f"{label}: argument bytes {got['argument_bytes']} differ from the meta run's")
    peak_gib = got["peak_allocated_bytes"] / 2**30
    hbm = meta_rec["hbm_per_device_gib"]
    mem = meta_rec["memory"]
    temp = mem["output_bytes"] + mem["temp_bytes"] - mem["alias_bytes"]
    print(f"[dryrun] {label}: peak allocated above the start {peak_gib:.3f} GiB, meta "
          f"run's hbm_per_device_gib {hbm:.3f} GiB; above the arguments "
          f"{got['peak_allocated_bytes'] - got['argument_bytes']} B on the card, {temp} B "
          f"(output + temp - alias) on meta; step {got['step_ms']:.3f} ms (CUDA "
          f"events, one step), {card}", flush=True)
    require(abs(peak_gib - hbm) <= DRY_PEAK_TOL * hbm,
            f"{label}: peak {peak_gib:.3f} GiB not within {DRY_PEAK_TOL:.0%} of {hbm:.3f} GiB")
    return {"meta": out["meta"], "card": rec, "meta_calls": meta_calls,
            "launches": {k: launches[k] for k in ("spoga_gemm_dequant", "spoga_gemm")},
            "profile": _dry_profile(arch, shape_name, card)}


def _dry_profile(arch, shape_name, card):
    """Device time by kernel of one more step of the card check's rank
    program (a warm step first), beside its wall time; the logits of the
    rank's lanes finite."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import lower_cell

    cfg = get_config(arch).with_(quant_mode="int8_spoga")
    lowered = lower_cell(cfg, SHAPES[shape_name], make_production_mesh(dry=True, device="cuda"))
    logits, _ = lowered.fn(**lowered.inputs)
    require(tuple(logits.shape) == (SHAPES[shape_name].global_batch // 16, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), "phase 19 (b): the rank's logits")
    t0 = time.perf_counter()
    _, prof = _profiled(lambda: lowered.fn(**lowered.inputs))
    wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if total <= 0:
        print("[dryrun] phase 19 (b) profile: no device time recorded: not measured", flush=True)
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"[dryrun] phase 19 (b) profile, one step: device {total:.3f} ms, "
          f"{sum(e.count for e in kernels)} kernels [{card}]", flush=True)
    for e in top:
        print(f"[dryrun]   {e.self_device_time_total / 1e3:.3f} ms, {e.count} launches  "
              f"{e.key[:90]}", flush=True)
    del lowered
    torch.cuda.empty_cache()
    return {"device_ms": total, "profiled_window_ms": wall_ms,
            "top": [(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    # cuBLAS's deterministic workspace, read when its first handle is made:
    # phase 13 (b)-(c) run under torch.use_deterministic_algorithms(True)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing ({src / 'repro_torch'})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    card = phase_card()
    print(f"[time] phase 1 done at {time.perf_counter() - t0:.1f} s", flush=True)
    gemm, gemm_err = phase_gemm()
    int_gemm, int_err = phase_int_gemm()
    deas, nibble, deas_err, combine_err, combine_long = phase_deas(int_gemm)
    attn = phase_attention(card)
    tp_arch_gemm = phase_tp_arch_gemms(card)
    print(f"[time] phases 2-3 done at {time.perf_counter() - t0:.1f} s", flush=True)
    params = full_width_params()
    launches, launches16, attn_profile, paged_rep = phase_main(card, params)
    slot_launches, slot_profile = phase_slot(card, params, paged_rep)
    phase_slot_vs_paged(card, params)
    facade = phase_dataflows(card, params)
    long_prefill = phase_long_prefill(card, params)
    print(f"[time] phases 4-5b done at {time.perf_counter() - t0:.1f} s", flush=True)
    import tempfile
    feature_params = _first_layers(params, FEATURE_LAYERS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        features = phase_features(card, feature_params, ckpt_dir)
        serving = phase_spec_serving(card, feature_params, ckpt_dir)
    del feature_params
    del params
    torch.cuda.empty_cache()
    phase_default_llm(card)
    phase_cpu_parity()
    phase_cpu_long_decode(card)
    print(f"[time] phases 7, 8, 6 done at {time.perf_counter() - t0:.1f} s", flush=True)
    archs = phase_archs(card)
    print(f"[time] phase 9 done at {time.perf_counter() - t0:.1f} s", flush=True)
    recurrent = phase_recurrent(card)
    print(f"[time] phase 10 done at {time.perf_counter() - t0:.1f} s", flush=True)
    encdec = phase_encdec(card)
    print(f"[time] phase 11 done at {time.perf_counter() - t0:.1f} s", flush=True)
    observed = phase_obs(card)
    print(f"[time] phase 12 done at {time.perf_counter() - t0:.1f} s", flush=True)
    train = phase_train(card)
    print(f"[time] phase 13 done at {time.perf_counter() - t0:.1f} s", flush=True)
    dist = phase_distribution(card)
    print(f"[time] phase 14 done at {time.perf_counter() - t0:.1f} s", flush=True)
    serve_cli = phase_serve_cli(card)
    print(f"[time] phase 15 done at {time.perf_counter() - t0:.1f} s", flush=True)
    sharded = phase_sharded_train(card)
    print(f"[time] phase 16 done at {time.perf_counter() - t0:.1f} s", flush=True)
    tp_archs = phase_tp_archs(card)
    print(f"[time] phase 17 done at {time.perf_counter() - t0:.1f} s", flush=True)
    tp_train = phase_tp_train(card)
    print(f"[time] phase 18 done at {time.perf_counter() - t0:.1f} s", flush=True)
    dry = phase_dryrun(card)
    print(f"[time] phase 19 done at {time.perf_counter() - t0:.1f} s", flush=True)

    from repro_torch.configs import get_config
    calls_per_step = 7 * get_config("llama3.2-1b").n_layers   # GEMM calls per decode step

    def gemm_row(name, source, replaces, launches, per_call, err, times, **extra):
        """A GEMM kernel's line: W8A8 K=2048 N=8192, decode M=4 at the top
        level (device time), prefill M=128 under "prefill"."""
        dec, pre = times[4], times[128]
        frac = {"fraction_of_bound": dec["bound_ms"] / dec["ms"]}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_per_decode_step": per_call * calls_per_step,
                "max_abs_err": err, "shape": "W8A8 M=4 K=2048 N=8192",
                "library": _lib_label(4, 2048, 8192), **dec, **frac, **extra,
                "prefill": {"shape": "W8A8 M=128 K=2048 N=8192",
                            "library": _lib_label(128, 2048, 8192), **pre,
                            "fraction_of_bound": pre["bound_ms"] / pre["ms"]},
                "card": card}

    def at(table, key):
        return {m: table[key(m)] for m in (4, 128)}

    def feature_launches(name):
        """A kernel's launches in each of phase 7's runs."""
        return {f"{part} {label}": run["launches"][name]
                for part in ("chunked", "stacked", "defrag")
                for label, run in features[part].items()}

    def serving_launches(name):
        """A kernel's launches in each of phase 8's counted runs."""
        runs = {"presets": serving["presets"],
                **{f"prefix {k}": serving["prefix"][k] for k in ("on", "off")},
                **{f"spec {k}": v for k, v in serving["spec"].items() if isinstance(v, dict)},
                **{f"busy {k}": v for k, v in serving["busy_chunking"].items()}}
        return {label: run["launches"][name] for label, run in runs.items()}

    def arch_launches(name):
        """A kernel's launches in phase 9's main runs of the three archs."""
        return {"minicpm3-4b paged": archs["mla"]["launches"][name],
                "deepseek-moe-16b (8 layers) paged int8 KV":
                    archs["deepseek"]["launches"][name],
                "granite-moe-3b-a800m paged bf16 KV": archs["granite"]["launches"][name]}

    def recurrent_launches(name):
        """A kernel's launches in phase 10's runs of the two recurrent archs."""
        rg, xl = recurrent["recurrentgemma"], recurrent["xlstm"]
        return {"recurrentgemma-9b paged int8 KV": rg["paged"]["launches"][name],
                "recurrentgemma-9b slot int8 KV": rg["slot"]["launches"][name],
                "recurrentgemma-9b long prompts": rg["long"]["launches"][name],
                "xlstm-125m paged int8 KV": xl["paged"]["launches"][name],
                "xlstm-125m slot int8 KV": xl["slot"]["launches"][name],
                **{f"xlstm-125m LLM {label}": c[name] for label, c in xl["dataflows"].items()}}

    def encdec_launches(name):
        """A kernel's launches in phase 11's counted runs."""
        return {"seamless-m4t-large-v2 serve_batch": encdec["seamless"]["launches"][name],
                "llava-next-mistral-7b serve_batch": encdec["llava"]["launches"][name],
                "llama3.2-1b ServingEngine.stream": encdec["stream"]["launches"][name]}

    def train_launches(name):
        """A kernel's launches in each of phase 13's counted training runs."""
        runs = {"(a) llama3.2-1b full width, 8 steps": train["full"]["launches"],
                "(b) 2 layers, 4 steps": train["resume"]["launches"],
                **{f"(c) 2 layers, 4 steps, {label}": run["launches"]
                   for label, run in train["dataflows"].items()}}
        return {label: launches[name] for label, launches in runs.items()}

    def dist_launches(name):
        """A kernel's launches in each of phase 14's counted serving runs (per
        rank for the tp=2 ranks)."""
        runs = {"(a) llama3.2-1b tp=1": dist["a"]["unsharded"],
                "(a) llama3.2-1b one NCCL rank": dist["a"]["one_rank"],
                "(c) mistral-large-123b tp=1": dist["references"]["mistral"],
                "(d) deepseek-moe-16b tp=1": dist["references"]["deepseek"],
                **{f"{part} {arch} tp=2 rank {r}": res[arch]
                   for r, res in enumerate(dist["ranks"])
                   for part, arch in (("(b)", "llama"), ("(c)", "mistral"),
                                      ("(d)", "deepseek"))}}
        return {label: run["launches"][name] for label, run in runs.items()}

    def dist_shapes(kernel):
        return {f"{arch} tp=2 W8A8 M=4 K={k} N={n}": {
            **t, "fraction_of_bound": t["bound_ms"] / t["ms"]}
            for (kname, arch, k, n), t in dist["gemm"].items() if kname == kernel}

    def sharded_launches(name):
        """A kernel's launches a rank in phase 16's counted training runs."""
        runs = {**{f"(a) {SHARDED_MESH[0]}x{SHARDED_MESH[1]} rank {r}, "
                   f"{SHARDED_TRAIN['steps']} steps": res["launches"]
                   for r, res in enumerate(sharded["ranks"])},
                **{f"(b) {a}x{b} rank {r}, 1 step after restore": res["restored"][(a, b)][
                    "launches"] for r, res in enumerate(sharded["ranks"])
                   for a, b in RESTORE_MESHES}}
        return {label: launches[name] for label, launches in runs.items()}

    def sharded_shapes(kernel):
        return {f"{', '.join(t['launched_by'])} llama3.2-1b W8A8 M={m} K={k} N={n}": {
            **t, "fraction_of_bound": t["bound_ms"] / t["ms"]}
            for (kname, m, k, n), t in sharded["gemm"].items() if kname == kernel}

    def tp_arch_launches(name):
        """A kernel's launches in each of phase 17's counted runs, per rank
        for the tp=2 ranks."""
        runs = {f"{arch} {who}": res[arch]["launches"]
                for who, res in (("tp=1", tp_archs["ref"]),
                                 *((f"tp=2 rank {r}", res)
                                   for r, res in enumerate(tp_archs["ranks"])))
                for arch in TPA_ENGINE_ARCHS + TPA_BATCH_ARCHS}
        runs.update({f"launch.serve.main seamless-m4t-large-v2 {who}": res["cli"][1]
                     for who, res in (("tp=1", tp_archs["ref"]),
                                      *((f"--tp 2 rank {r}", res)
                                        for r, res in enumerate(tp_archs["ranks"])))})
        return {label: launches[name] for label, launches in runs.items()}

    def tp_arch_shapes(kernel):
        return {f"{arch} tp=2 W8A8 M=4 K={k} N={n}": {
            **t, "fraction_of_bound": t["bound_ms"] / t["ms"]}
            for (kname, arch, k, n), t in tp_arch_gemm.items() if kname == kernel}

    def tp_train_launches(name):
        """A kernel's launches in each of phase 18's counted training steps:
        the unsharded step and each tp=2 rank's."""
        runs = {}
        for arch in TPT_LAYERS:
            runs[f"{arch} unsharded step"] = tp_train["ranks"][0][arch]["ref_launches"]
            for r, res in enumerate(tp_train["ranks"]):
                runs[f"{arch} tp=2 rank {r} step"] = res[arch]["launches"]
        return {label: launches[name] for label, launches in runs.items()}

    def tp_train_shapes(kernel):
        return {f"a tp=2 training rank W8A8 M={m} K={k} N={n}": {
            **t, "fraction_of_bound": t["bound_ms"] / t["ms"]}
            for (kname, m, k, n), t in tp_train["gemm"].items() if kname == kernel}

    def dry_launches(name):
        """A kernel's launches in phase 19 (b)'s card check (its two runs of
        the rank's decode step)."""
        return {"deepseek-moe-16b decode_32k 16x16 rank 0, 2 steps": dry["launches"][name]}

    def train_shapes():
        return {f"W8A8 M={m} K={k} N={n}": {**t, "fraction_of_bound": t["bound_ms"] / t["ms"]}
                for (m, k, n), t in train["gemm"].items()}

    chunk = gemm[("w8a8", CHUNK_M, 2048, 8192)]
    kernels = [gemm_row("spoga_gemm_dequant", "src/repro_torch/csrc/spoga_gemm_dequant.cu",
                        "src/repro/kernels/spoga_gemm_dequant.py:62",
                        launches["spoga_gemm_dequant"], 1, gemm_err,
                        at(gemm, lambda m: ("w8a8", m, 2048, 8192)),
                        launches_slot={f"{kv} KV": n for kv, n in slot_launches.items()},
                        launches_engine_features=feature_launches("spoga_gemm_dequant"),
                        chunk_prefill={"shape": f"W8A8 M={CHUNK_M} K=2048 N=8192",
                                       "library": _lib_label(CHUNK_M, 2048, 8192), **chunk,
                                       "fraction_of_bound": chunk["bound_ms"] / chunk["ms"]},
                        slot_decode_profile=slot_profile, long_prefill=long_prefill,
                        verify=serving["profile"]["gemm"],
                        launches_spec_serving=serving_launches("spoga_gemm_dequant"),
                        launches_archs=arch_launches("spoga_gemm_dequant"),
                        arch_shapes={f"W8A8 M={m} K={k} N={n}": {
                            **t, "fraction_of_bound": t["bound_ms"] / t["ms"]}
                            for (m, k, n), t in archs["gemm"].items()},
                        launches_recurrent=recurrent_launches("spoga_gemm_dequant"),
                        recurrent_shapes={f"W8A8 M={m} K={k} N={n}": {
                            **t, "fraction_of_bound": t["bound_ms"] / t["ms"]}
                            for (m, k, n), t in recurrent["gemm"].items()},
                        recurrentgemma_decode_split_ms=recurrent["recurrentgemma"]["split_ms"],
                        launches_encdec_frontends=encdec_launches("spoga_gemm_dequant"),
                        launches_observability_record=observed["launches"][
                            "spoga_gemm_dequant"],
                        encdec_frontend_shapes={f"W8A8 M={m} K={k} N={n}": {
                            **t, "fraction_of_bound": t["bound_ms"] / t["ms"]}
                            for (m, k, n), t in encdec["gemm"].items()},
                        launches_training=train_launches("spoga_gemm_dequant"),
                        launches_per_training_step=train["full"]["per_step"],
                        training_shapes=train_shapes(),
                        training_step=train["full"]["profile"],
                        launches_distribution=dist_launches("spoga_gemm_dequant"),
                        distribution_shapes=dist_shapes("spoga_gemm_dequant"),
                        launches_serve_cli={"(a) launch.serve.main": serve_cli["a"][
                            "launches"]["spoga_gemm_dequant"]},
                        launches_sharded_training=sharded_launches("spoga_gemm_dequant"),
                        sharded_training_shapes=sharded_shapes("spoga_gemm_dequant"),
                        launches_tp_archs=tp_arch_launches("spoga_gemm_dequant"),
                        tp_arch_shapes=tp_arch_shapes("spoga_gemm_dequant"),
                        launches_tp_training=tp_train_launches("spoga_gemm_dequant"),
                        launches_dryrun=dry_launches("spoga_gemm_dequant"),
                        tp_training_shapes=tp_train_shapes("spoga_gemm_dequant"),
                        oracle_max_abs_err=serve_cli["d"]["dequant_max_abs_err"])]
    for kind, count in (("int8", launches["paged_attention"]),
                        ("bf16", launches16["paged_attention"])):
        a, long, short = (dict(attn[(kind, name)]) for name in ("main", "long", "short"))
        kernels.append({"name": f"paged_attention/{kind}", "route": "cuda",
                        "source": "src/repro_torch/csrc/paged_attention.cu",
                        "replaces": "src/repro/kernels/paged_attention.py:91",
                        "launches": count,
                        "max_abs_err": max(attn[(kind, name)]["max_abs_err"]
                                           for name in ATTN_SHAPES),
                        **{k: v for k, v in a.items() if k != "max_abs_err"},
                        "long_context": long, "long_table_short_lanes": short,
                        "decode_profile_ms_per_step": {
                            k: v and v["attn_ms"] for k, v in attn_profile.items()},
                        **({"launches_engine_features": feature_launches("paged_attention"),
                            "launches_spec_serving": serving_launches("paged_attention")}
                           if kind == "int8" else {}),
                        "verify": serving["profile"]["attn"][kind],
                        "launches_archs": arch_launches("paged_attention"),
                        "launches_recurrent": recurrent_launches("paged_attention"),
                        "launches_encdec_frontends": encdec_launches("paged_attention"),
                        "launches_training": train_launches("paged_attention"),
                        **({"launches_distribution": dist_launches("paged_attention"),
                            "launches_serve_cli": {
                                f"({part}) launch.serve.main": serve_cli[part]["launches"][
                                    "paged_attention"] for part in ("a", "b")}}
                           if kind == "int8" else {}),
                        **({"launches_observability_record":
                            observed["launches"]["paged_attention"]} if kind == "int8" else {}),
                        "arch_shapes": {name: attn[(kind, name)]
                                        for name in ATTN_ARCH_SHAPES},
                        "card": card})
    unfused, deas_run = facade["spoga unfused"], facade["deas"]
    kernels.append(gemm_row("spoga_gemm", "src/repro_torch/csrc/spoga_gemm.cu",
                            "src/repro/kernels/spoga_gemm.py:116", unfused["spoga_gemm"], 1,
                            int_err, at(int_gemm, lambda m: ("w8a8", m, 2048, 8192)),
                            launches_recurrent=recurrent_launches("spoga_gemm"),
                            launches_training=train_launches("spoga_gemm"),
                            launches_distribution=dist_launches("spoga_gemm"),
                            distribution_shapes=dist_shapes("spoga_gemm"),
                            launches_serve_cli={
                                "(b) launch.serve.main, set_default_backend('cuda_spoga')":
                                    serve_cli["b"]["launches"]["spoga_gemm"]},
                            launches_sharded_training=sharded_launches("spoga_gemm"),
                            sharded_training_shapes=sharded_shapes("spoga_gemm"),
                            launches_tp_archs=tp_arch_launches("spoga_gemm"),
                            tp_arch_shapes=tp_arch_shapes("spoga_gemm"),
                            launches_tp_training=tp_train_launches("spoga_gemm"),
                            launches_dryrun=dry_launches("spoga_gemm"),
                            tp_training_shapes=tp_train_shapes("spoga_gemm")))
    kernels.append(gemm_row("nibble_gemm", "src/repro_torch/csrc/deas_gemm.cu",
                            "src/repro/kernels/deas_gemm.py:50", deas_run["nibble_gemm"], 4,
                            deas_err, at(nibble, lambda m: (m, 2048, 8192)),
                            library_operands="the int8 nibble planes of this call",
                            launches_recurrent=recurrent_launches("nibble_gemm"),
                            launches_training=train_launches("nibble_gemm")))
    kernels.append(gemm_row("deas_gemm", "src/repro_torch/csrc/deas_gemm.cu",
                            "src/repro/kernels/deas_gemm.py:95",
                            deas_run["nibble_gemm"] + deas_run["deas_combine"], 5, deas_err,
                            at(deas, lambda m: (m, 2048, 8192)),
                            replaces_parts={"nibble_gemm": "src/repro/kernels/deas_gemm.py:50",
                                            "deas_combine": "src/repro/kernels/deas_gemm.py:79"},
                            nibble_gemm_launches=deas_run["nibble_gemm"],
                            deas_combine_launches=deas_run["deas_combine"],
                            launches_recurrent=recurrent_launches("deas_combine"),
                            launches_training={"nibble_gemm": train_launches("nibble_gemm"),
                                               "deas_combine": train_launches("deas_combine")}))

    def combine_at(m):
        t = deas[(m, 2048, 8192)]
        c = t["deas_combine"]
        return {"shape": f"M={m} N=8192, partials cold", "ms": c["cold_ms"],
                "warm_ms": c["warm_ms"], "noop_ms": c["noop_cold_ms"],
                "noop_warm_ms": c["noop_warm_ms"], "event_ms": c["event_ms"],
                "plain_ms": c["plain_ms"], "bound_ms": t["deas_combine_bound_ms"],
                "bound_by": "bytes", "fraction_of_bound": t["deas_combine_bound_ms"] / c["cold_ms"],
                "library_ms": None}

    kernels.append({"name": "deas_combine", "route": "cuda",
                    "source": "src/repro_torch/csrc/deas_gemm.cu",
                    "replaces": "src/repro/kernels/deas_gemm.py:79",
                    "launches": deas_run["deas_combine"], "launches_per_decode_step": calls_per_step,
                    "max_abs_err": combine_err, **combine_at(4), "prefill": combine_at(128),
                    "sustained": combine_long,
                    "launches_recurrent": recurrent_launches("deas_combine"),
                    "launches_training": train_launches("deas_combine"),
                    "library": "none: no one PyTorch call computes the shift-add", "card": card})
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
