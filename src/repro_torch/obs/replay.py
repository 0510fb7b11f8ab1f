"""Deterministic replay of a flight-recorder bundle (port of
``repro/obs/replay.py``).

``replay_bundle(path)`` (surfaced as ``LLM.replay`` and
``python -m repro_torch.launch.replay``) rebuilds the engine from the bundle's
config fingerprint, re-feeds the recorded arrivals on the recorded step
schedule, scripts the recorded decision-clock readings back through the
scheduler, and checks two things bitwise:

- every recorded request's greedy token stream, and
- the decision journal, event by event.

When they differ, ``diff_journals`` walks recorded-vs-replayed journals
to the *first* divergent decision and reports both contexts::

    replay diverged at event 412 (recorded seq 412):
      recorded admitted(req=7, mode=prefix, pages=[3, 9], ...)
      replayed rejected(req=7, reason=pages, ...)

Fields that legitimately differ between runs — timestamps and the
latency-derived metrics (``t``, ``wall``, ``queue_wait_s``, ...) — are
stripped before comparison; everything else (slots, lanes, page
assignments, chunk offsets, spec acceptance counts, reasons) must match
exactly.  ``replay_bundle(runtime_transform=...)`` deliberately perturbs
the rebuilt config (e.g. a smaller page pool) to ask "which decision goes
first?" — the debugging workflow the recorder exists for.

Bundles are the reference's format, so a bundle the JAX package recorded
replays here too: provenance mismatches (git SHA, versions, python) are
warnings, never errors.  The replay runs on the card unless ``device=
"cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

from repro_torch.obs.recorder import (
    ARRIVALS,
    CLOCK,
    JOURNAL,
    MANIFEST,
    OUTPUTS,
)

# event fields that depend on when the run happened rather than on what
# the engine decided: excluded from the journal diff (the decision clock
# is replayed, but metric timestamps intentionally stay on real time)
VOLATILE_FIELDS = frozenset({
    "t", "wall", "queue_wait_s", "ttft_s", "latency_s", "waited_s",
    "deadline_hit",
})


# ---------------------------------------------------------------------------
# bundle loading
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Bundle:
    path: str
    manifest: dict
    arrivals: list[dict]
    journal: list[dict]
    outputs: list[dict]
    clock: list[float]


def _read_jsonl(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def load_bundle(path: str) -> Bundle:
    mpath = os.path.join(path, MANIFEST)
    if not os.path.exists(mpath):
        raise FileNotFoundError(f"not a flight-recorder bundle: {mpath}")
    with open(mpath) as f:
        manifest = json.load(f)
    # the journal stream may have rotated once: <path>.1 holds the older half
    journal = (_read_jsonl(os.path.join(path, JOURNAL + ".1"))
               + _read_jsonl(os.path.join(path, JOURNAL)))
    clock: list[float] = []
    cpath = os.path.join(path, CLOCK)
    if os.path.exists(cpath):
        with open(cpath) as f:
            clock = [float(line) for line in f if line.strip()]
    return Bundle(
        path=path,
        manifest=manifest,
        arrivals=_read_jsonl(os.path.join(path, ARRIVALS)),
        journal=journal,
        outputs=_read_jsonl(os.path.join(path, OUTPUTS)),
        clock=clock,
    )


# ---------------------------------------------------------------------------
# the scripted decision clock
# ---------------------------------------------------------------------------

class ReplayClock:
    """Replays the recorded decision-clock tape reading by reading.

    Every decision-relevant wall-time read the recorded engine made was
    taped in order; a bitwise replay makes exactly the same reads, so
    popping the tape reproduces every time-dependent decision (deadline
    sheds, preemptions, lateness stamps).  If the replay diverges into
    *extra* reads the tape holds at its final instant — deadline math
    stays finite and the journal differ reports the real divergence.
    """

    def __init__(self, tape):
        self._tape = list(tape)
        self._i = 0
        self.exhausted_reads = 0

    def __call__(self) -> float:
        if self._i < len(self._tape):
            t = self._tape[self._i]
            self._i += 1
            return t
        self.exhausted_reads += 1
        return self._tape[-1] if self._tape else 0.0


# ---------------------------------------------------------------------------
# journal diffing
# ---------------------------------------------------------------------------

def canonical_event(ev: dict) -> dict:
    """An event with volatile fields stripped, JSON-normalized (tuples
    become lists, exactly as the recorded journal was serialized)."""
    ev = {k: v for k, v in ev.items() if k not in VOLATILE_FIELDS
          and k != "seq"}
    return json.loads(json.dumps(ev))


def _describe(ev: Optional[dict]) -> str:
    if ev is None:
        return "<journal ended>"
    kind = ev.get("kind", "?")
    rid = ev.get("req_id")
    skip = VOLATILE_FIELDS | {"kind", "req_id", "seq"}
    rest = {k: v for k, v in sorted(ev.items()) if k not in skip}
    parts = ([f"req={rid}"] if rid is not None else [])
    parts += [f"{k}={v}" for k, v in rest.items()]
    return f"{kind}({', '.join(parts)})"


@dataclasses.dataclass
class Divergence:
    """The first recorded-vs-replayed journal mismatch."""

    index: int                      # position in the (merged) journal
    recorded: Optional[dict]        # raw recorded event (or None: replay ran long)
    replayed: Optional[dict]        # raw replayed event (or None: replay ended early)

    def format(self) -> str:
        seq = (self.recorded or {}).get("seq", self.index)
        return (f"replay diverged at event {self.index} (recorded seq {seq}):\n"
                f"  recorded {_describe(self.recorded)}\n"
                f"  replayed {_describe(self.replayed)}")


def diff_journals(recorded: list[dict], replayed: list[dict],
                  ) -> Optional[Divergence]:
    """First divergent decision between two journals, or None if equal."""
    n = max(len(recorded), len(replayed))
    for i in range(n):
        a = recorded[i] if i < len(recorded) else None
        b = replayed[i] if i < len(replayed) else None
        if a is None or b is None:
            return Divergence(index=i, recorded=a, replayed=b)
        if canonical_event(a) != canonical_event(b):
            return Divergence(index=i, recorded=a, replayed=b)
    return None


# ---------------------------------------------------------------------------
# the replayer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReplayResult:
    bundle: str
    ok: bool
    n_requests: int
    n_recorded_events: int
    n_replayed_events: int
    token_mismatches: list[dict]
    divergence: Optional[Divergence]
    warnings: list[str]
    error: Optional[str] = None

    def summary(self) -> str:
        lines = [f"[replay] bundle {self.bundle}: {self.n_requests} "
                 f"request(s), {self.n_recorded_events} recorded / "
                 f"{self.n_replayed_events} replayed journal events"]
        for w in self.warnings:
            lines.append(f"[replay] warning: {w}")
        if self.error:
            lines.append(f"[replay] replay errored: {self.error}")
        for m in self.token_mismatches:
            lines.append(
                f"[replay] token mismatch req={m['req_id']}: recorded "
                f"{m['recorded']} vs replayed {m['replayed']}")
        if self.divergence is not None:
            lines.append(self.divergence.format())
        if self.ok:
            lines.append("[replay] bitwise identical: tokens and decision "
                         "journal reproduce the recorded run")
        return "\n".join(lines)


def _fingerprint_warnings(manifest: dict) -> list[str]:
    from repro_torch.obs.recorder import environment_fingerprint

    recorded = manifest.get("fingerprint") or {}
    here = environment_fingerprint()
    warns = []
    for key in ("git_sha", "torch", "cuda", "device", "python"):
        a, b = recorded.get(key), here.get(key)
        if a is not None and b is not None and a != b:
            warns.append(f"{key} differs: recorded {a!r}, replaying on {b!r}")
    return warns


def replay_bundle(path: str,
                  runtime_transform: Optional[Callable] = None,
                  max_steps: int = 100_000, device=None) -> ReplayResult:
    """Rebuild the recorded engine, re-run the schedule, compare bitwise.

    ``runtime_transform(runtime) -> runtime`` perturbs the rebuilt config
    on purpose (the differ then names the first decision that changed);
    leave it None for a fidelity check.  ``device``: where the replay
    runs (default the card).
    """
    from repro_torch.api import LLM, RuntimeConfig
    from repro_torch.obs.config import ObsConfig
    from repro_torch.serving.sampling import SamplingParams

    bundle = load_bundle(path)
    man = bundle.manifest
    if man.get("arch") is None or man.get("runtime") is None:
        raise ValueError(
            f"bundle {path} has no arch/runtime in its manifest (the "
            "recording LLM was built from a raw config=; replay needs a "
            "registry arch name)")

    rt = RuntimeConfig.from_dict(man["runtime"])
    eng = man.get("engine") or {}
    # pin the resolved geometry: the recorded run sized cache_len/buckets
    # from its workload hints, which the bundle no longer carries
    if eng.get("cache_len") is not None:
        rt = dataclasses.replace(
            rt, kv=dataclasses.replace(rt.kv, cache_len=eng["cache_len"]))
    buckets = eng.get("prefill_buckets")
    if buckets is not None:
        rt = dataclasses.replace(
            rt, scheduler=dataclasses.replace(
                rt.scheduler, prefill_buckets=tuple(buckets)))
    # replay observes in memory only: no recorder, no sinks, no server
    rt = dataclasses.replace(rt, obs=ObsConfig(enabled=True))
    if runtime_transform is not None:
        rt = runtime_transform(rt)

    warns = _fingerprint_warnings(man)
    if man.get("engine_rebuilds"):
        warns.append(f"recorded engine was rebuilt "
                     f"{man['engine_rebuilds']} time(s) mid-record; only "
                     f"the final geometry replays")

    llm = LLM(arch=man["arch"], runtime=rt, seed=man.get("seed", 0),
              checkpoint_dir=man.get("checkpoint_dir"), device=device)
    error = None
    reqs: dict[int, object] = {}
    try:
        engine = llm.engine
        clock = ReplayClock(bundle.clock)
        engine.set_clock(clock)
        pending = sorted(bundle.arrivals,
                         key=lambda a: (a["step"], a["req_id"]))
        if pending:
            # req_ids must line up with the recorded journal
            engine._next_id = pending[0]["req_id"]
        i = 0
        steps = 0
        # mirror engine.run's arrival loop: feed each request at its
        # recorded step, jump idle gaps, cap steps so a divergent replay
        # (e.g. a perturbed pool that can never admit) still terminates
        while (i < len(pending) or engine.has_work) and steps < max_steps:
            while i < len(pending) and pending[i]["step"] <= engine._step_idx:
                a = pending[i]
                req = engine.add_request(
                    a["prompt"], a["max_new_tokens"],
                    sampling=SamplingParams(**a["sampling"]),
                    eos_token=a["eos_token"],
                    priority=a.get("priority", 0))
                reqs[req.req_id] = req
                i += 1
            if not engine.has_work:
                engine._step_idx = pending[i]["step"]
                continue
            engine.step()
            steps += 1
        if steps >= max_steps:
            warns.append(f"replay stopped at max_steps={max_steps} with "
                         f"work still queued")
        if clock.exhausted_reads:
            warns.append(f"decision-clock tape exhausted "
                         f"({clock.exhausted_reads} extra reads) — the "
                         f"replay made more time-dependent decisions than "
                         f"the recording")
    except Exception as e:  # noqa: BLE001 - a perturbed replay may crash;
        error = f"{type(e).__name__}: {e}"  # report it with the journal diff

    token_mismatches = []
    for out in bundle.outputs:
        rep = reqs.get(out["req_id"])
        got = [int(t) for t in rep.output_tokens] if rep is not None else None
        if got != out["tokens"]:
            token_mismatches.append({"req_id": out["req_id"],
                                     "recorded": out["tokens"],
                                     "replayed": got})

    replayed_events = [dict(ev) for ev in llm.obs.events.events]
    if bundle.journal and bundle.journal[0].get("seq", 0) > 0:
        # the recorded stream rotated more than once: the head is gone.
        # seq is contiguous per run, so align the replayed journal to the
        # surviving suffix and diff from there.
        start = bundle.journal[0]["seq"]
        warns.append(f"recorded journal starts at seq {start} (older "
                     f"rotations discarded); diffing the suffix")
        replayed_events = replayed_events[start:]
    divergence = diff_journals(bundle.journal, replayed_events)
    llm.close()
    return ReplayResult(
        bundle=path,
        ok=(error is None and not token_mismatches and divergence is None),
        n_requests=len(bundle.arrivals),
        n_recorded_events=len(bundle.journal),
        n_replayed_events=len(replayed_events),
        token_mismatches=token_mismatches,
        divergence=divergence,
        warnings=warns,
        error=error,
    )
