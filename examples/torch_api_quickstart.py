"""repro_torch.api quickstart: the one-import serving surface of the port.

    PYTHONPATH=src python examples/torch_api_quickstart.py              # on the card
    PYTHONPATH=src python examples/torch_api_quickstart.py --device cpu

1. Build an ``LLM`` from an arch name + a layered ``RuntimeConfig``.
2. ``generate`` a batch of prompts; check scheduling is output-invisible
   (every request's greedy tokens == its solo ``serve_batch`` decode).
3. ``stream`` tokens, then detokenized text fragments.
4. Serialize the RuntimeConfig to a dict and round-trip it.
5. The same facade on the paged KV cache with byte-size int8 pages.
6. Stacked (batched) prefill admission — fewer dispatches, same tokens.
"""

import argparse
import json

import numpy as np
import torch

from repro_torch.api import (
    LLM,
    KVConfig,
    RuntimeConfig,
    SamplingParams,
    SchedulerConfig,
    serve_batch,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)

    # 1 — one entrypoint: arch registry name + runtime config
    runtime = RuntimeConfig(reduced=True, max_new_tokens=8)
    llm = LLM(arch="llama3.2-1b", runtime=runtime, device=args.device)
    print(f"1. LLM({llm.config.name}) on {llm.device}: quant={llm.config.quant_mode}, "
          f"kv={runtime.kv.mode}/{runtime.kv.dtype}")

    # 2 — batch generate; greedy streams are bitwise a solo decode per prompt
    prompts = [rng.integers(0, llm.config.vocab_size, n).tolist() for n in (5, 9, 3)]
    outs = llm.generate(prompts, sampling=SamplingParams(greedy=True))
    for out, prompt in zip(outs, prompts):
        solo, _ = serve_batch(llm.config, llm.params,
                              {"tokens": torch.tensor([prompt], dtype=torch.int32,
                                                      device=llm.device)},
                              cache_len=llm.engine.engine_cfg.cache_len,
                              gen_tokens=len(out.token_ids))
        assert out.token_ids == solo[0].tolist()
    print(f"2. generate: {len(outs)} requests, first tokens "
          f"{[o.token_ids[0] for o in outs]}, all == solo serve_batch exactly")

    # 3 — streaming: token ids, then text fragments through the detokenizer
    toks = list(llm.stream(prompts[0], max_new_tokens=4))
    text = "".join(llm.stream(prompts[0], max_new_tokens=4, detokenize=True))
    print(f"3. stream: tokens {toks} -> text {text!r}")

    # 4 — the runtime config round-trips through plain JSON
    blob = json.dumps(runtime.to_dict())
    assert RuntimeConfig.from_dict(json.loads(blob)) == runtime
    print(f"4. RuntimeConfig round-trip through {len(blob)}-byte JSON")

    # 5 — paged pool with int8 byte-size pages; same facade, same outputs
    paged = LLM(arch="llama3.2-1b", device=args.device, runtime=RuntimeConfig(
        reduced=True,
        max_new_tokens=6,
        kv=KVConfig(mode="paged", dtype="int8", page_size=8),
    ))
    outs = paged.generate(prompts)
    m = paged.metrics
    print(f"5. paged int8: {sum(len(o.token_ids) for o in outs)} tokens, "
          f"peak {m.peak_pages_used}/{m.pages_total} pages, "
          f"{m.defrag_count} defrags")

    # 6 — stacked (batched) prefill admission: same-bucket prompts share ONE
    # prefill dispatch (slot mode; outputs stay bitwise-identical)
    stacked = LLM(arch="llama3.2-1b", device=args.device, runtime=RuntimeConfig(
        reduced=True,
        max_new_tokens=6,
        scheduler=SchedulerConfig(n_slots=4, batched_admission=True,
                                  prefill_buckets=(8, 16)),
    ))
    outs2 = stacked.generate(prompts)
    assert [o.token_ids[0] for o in outs2] == [o.token_ids[0] for o in outs]
    m = stacked.metrics
    assert m.prefill_dispatches < m.prefills
    print(f"6. batched admission: {m.prefills} prefills in "
          f"{m.prefill_dispatches} dispatches ({m.stacked_prefills} stacked), "
          f"outputs unchanged")


if __name__ == "__main__":
    main()
