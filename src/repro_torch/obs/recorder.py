"""Flight recorder: capture a serving run into a replayable bundle (port of
``repro/obs/recorder.py``: the same bundle layout and version, so either
package replays the other's bundles).

Arm it with ``ObsConfig(record_path=DIR)``.  The bundle is a plain
directory, self-contained enough for ``repro_torch.obs.replay`` to
rebuild the engine offline and reproduce the run bitwise:

``manifest.json``
    Config fingerprint: ``RuntimeConfig.to_dict()``, the arch name, the
    ``LLM`` seed, the resolved engine geometry (``EngineConfig`` as a
    dict — cache length, prefill buckets, page budget...), plus
    environment provenance (git SHA, torch and CUDA versions, the card's
    name or ``cpu``, python).  Provenance mismatches at replay are *warnings*,
    config mismatches are what the differ exists to find.
``arrivals.jsonl``
    One line per ``add_request``: prompt tokens, ``max_new_tokens``,
    ``SamplingParams`` (the per-request PRNG seed lives here), priority,
    resolved EOS token, and the engine step at which the request was
    submitted — the replay schedule.
``journal.jsonl``
    The ``EventLog`` stream (the per-step decision journal).  The
    recorder hands its path to ``ObsConfig.build`` so the engine's
    normal event emission IS the recording — no second code path.
``outputs.jsonl``
    Per finished request: the token stream and finish reason — the
    bitwise ground truth replay is checked against.
``clock.jsonl``
    The decision-clock tape: every wall-time reading that can influence
    a scheduling decision (submit stamps, deadline shedding/preemption,
    admission lateness), one float per line in read order.  Replay
    scripts these readings back, so time-dependent decisions reproduce
    exactly even though the replay runs at a different wall time.

Everything here is host-side bookkeeping on paths the engine already
executes per request (not per token), so an armed recorder adds no device
syncs and launches nothing; disarmed, the engine holds ``recorder=None``
and pays nothing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings
from typing import Callable, Optional

BUNDLE_VERSION = 1

MANIFEST = "manifest.json"
ARRIVALS = "arrivals.jsonl"
JOURNAL = "journal.jsonl"
OUTPUTS = "outputs.jsonl"
CLOCK = "clock.jsonl"


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def environment_fingerprint() -> dict:
    """Provenance for the manifest: versions, the card, git SHA."""
    import torch

    return {
        "python": sys.version.split()[0],
        "git_sha": _git_sha(),
        "recorded_at": time.time(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                   else "cpu"),
    }


class FlightRecorder:
    """Writes one run's bundle; owned by ``Observability``.

    The engine calls ``record_arrival`` / ``record_finish`` on its
    per-request paths and routes its decision clock through
    ``wrap_clock``; the ``LLM`` facade stamps run identity via
    ``set_run_info``; ``record_engine`` pins the resolved geometry.
    Files are flushed eagerly (arrivals are rare relative to steps), so
    a crashed run still leaves a loadable bundle.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._manifest: dict = {
            "version": BUNDLE_VERSION,
            "fingerprint": environment_fingerprint(),
        }
        self._arrivals = open(os.path.join(path, ARRIVALS), "w")
        self._outputs = open(os.path.join(path, OUTPUTS), "w")
        self._clock = open(os.path.join(path, CLOCK), "w")
        self._closed = False
        self._write_manifest()

    # -- paths -------------------------------------------------------------
    @property
    def journal_path(self) -> str:
        return os.path.join(self.path, JOURNAL)

    # -- manifest ----------------------------------------------------------
    def _write_manifest(self) -> None:
        tmp = os.path.join(self.path, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self._manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(self.path, MANIFEST))

    def set_run_info(self, *, arch: Optional[str], runtime,
                     seed: int, checkpoint_dir: Optional[str]) -> None:
        """Stamp the LLM-level identity needed to rebuild the model."""
        self._manifest.update(
            arch=arch,
            seed=int(seed),
            checkpoint_dir=checkpoint_dir,
            runtime=runtime.to_dict(),
        )
        self._write_manifest()

    def record_engine(self, engine_cfg) -> None:
        """Pin the resolved engine geometry (cache_len, buckets, ...).

        ``LLM`` may rebuild the engine when request shapes outgrow the
        current geometry; a bundle replays against ONE geometry, so a
        mid-record rebuild is recorded (latest wins) but warned about.
        """
        d = dataclasses.asdict(engine_cfg)
        if d.get("prefill_buckets") is not None:
            d["prefill_buckets"] = list(d["prefill_buckets"])
        prev = self._manifest.get("engine")
        if prev is not None and prev != d:
            self._manifest["engine_rebuilds"] = (
                self._manifest.get("engine_rebuilds", 0) + 1)
            warnings.warn(
                "flight recorder: engine rebuilt mid-record; the bundle "
                "keeps the newest geometry and earlier decisions may not "
                "replay", stacklevel=2)
        self._manifest["engine"] = d
        self._write_manifest()

    # -- decision clock ----------------------------------------------------
    def wrap_clock(self, base: Callable[[], float] = time.perf_counter,
                   ) -> Callable[[], float]:
        """A clock whose every reading is appended to the tape."""
        fh = self._clock

        def clock() -> float:
            t = base()
            fh.write(repr(t) + "\n")
            return t

        return clock

    # -- per-request streams -----------------------------------------------
    def record_arrival(self, req, step: int) -> None:
        rec = {
            "req_id": int(req.req_id),
            "step": int(step),
            "submit_t": req.submit_time,
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "sampling": dataclasses.asdict(req.sampling),
            "priority": int(req.priority),
            "eos_token": None if req.eos_token is None else int(req.eos_token),
        }
        self._arrivals.write(json.dumps(rec) + "\n")
        self._arrivals.flush()

    def record_finish(self, req) -> None:
        rec = {
            "req_id": int(req.req_id),
            "tokens": [int(t) for t in req.output_tokens],
            "reason": req.finish_reason,
        }
        self._outputs.write(json.dumps(rec) + "\n")
        self._outputs.flush()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for fh in (self._arrivals, self._outputs, self._clock):
            fh.flush()
            fh.close()
        self._write_manifest()
