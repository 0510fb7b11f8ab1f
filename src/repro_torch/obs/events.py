"""Structured scheduler event log (the port's own copy of
``repro/obs/events.py``).

Every scheduling *decision* the engine takes — queued / admitted /
rejected (with the reason) / chunk fed / promoted / first token / CoW fork
/ prefix hit / defrag / spec fallback / finished — lands here as one
dict: a monotonic ``seq`` (the replay total order — it keeps counting
across JSONL rotation, so a rotated stream stays contiguous), a
monotonic-clock ``t`` (``time.perf_counter``, the same clock every
``Request`` timestamp uses), a wall-clock ``wall`` (``time.time``, for
correlating with external logs), the ``kind``, an optional ``req_id``,
and free-form fields.  ``to_jsonl`` writes one JSON object
per line; ``timeline(req_id)`` reassembles one request's
queued → admitted → chunks → first-token → finished history, which the
API surfaces on ``RequestOutput.timeline``.

This is the layer that answers "why wasn't this request admitted" — the
question a means-only metrics dataclass structurally cannot: rejections
carry the vetoing reason (pool capacity, with the page deficit), evictions
carry theirs (budget vs EOS), and spec fallbacks say what disqualified
the batch.

``NullEventLog`` is the zero-overhead disabled twin: ``emit`` discards
everything without building state.

**Streaming mode.**  A long-lived server can't buffer its event history
unbounded in memory.  ``EventLog(stream_path=...)`` appends each event
to a JSONL file as it is emitted and keeps only a bounded in-memory
window (a deque) for ``timeline``/``kinds`` queries; when the file
exceeds ``max_bytes`` it is rotated once (renamed to ``<path>.1``) and
writing restarts, so disk usage is bounded at ~2x ``max_bytes``.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from typing import Optional


class EventLog:
    def __init__(self, stream_path: Optional[str] = None,
                 max_bytes: int = 64 * 2 ** 20, keep: int = 4096):
        if stream_path is not None and max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        self.stream_path = stream_path
        self.max_bytes = max_bytes
        # streaming: bounded window; buffered: the full history
        self.events = deque(maxlen=keep) if stream_path else []
        self._by_req: dict[int, list[dict]] = defaultdict(list)
        self._seq = 0
        self._fh = open(stream_path, "w") if stream_path else None
        self._bytes = 0
        self.rotations = 0

    def emit(self, kind: str, req_id: Optional[int] = None, **fields) -> dict:
        ev = {"seq": self._seq, "t": time.perf_counter(),
              "wall": time.time(), "kind": kind}
        self._seq += 1
        if req_id is not None:
            ev["req_id"] = int(req_id)
            self._by_req[int(req_id)].append(ev)
        ev.update(fields)
        self.events.append(ev)
        if self._fh is not None:
            line = json.dumps(ev) + "\n"
            self._fh.write(line)
            self._bytes += len(line)
            if self._bytes >= self.max_bytes:
                self._rotate()
        return ev

    def _rotate(self) -> None:
        self._fh.close()
        os.replace(self.stream_path, self.stream_path + ".1")
        self._fh = open(self.stream_path, "w")
        self._bytes = 0
        self.rotations += 1

    def __len__(self) -> int:
        return len(self.events)

    # -- queries -----------------------------------------------------------
    def timeline(self, req_id: int) -> list[dict]:
        """One request's events in emission order."""
        return list(self._by_req.get(int(req_id), ()))

    def kinds(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for ev in self.events:
            counts[ev["kind"]] = counts.get(ev["kind"], 0) + 1
        return counts

    def tail(self, n: int) -> list[dict]:
        """The newest ``n`` events from the in-memory window."""
        if n <= 0:
            return []
        evs = list(self.events)
        return evs[-n:]

    # -- export ------------------------------------------------------------
    def to_jsonl(self, path: str) -> str:
        if self._fh is not None and path == self.stream_path:
            # streaming already wrote everything; just make it durable
            self._fh.flush()
            return path
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")
        return path

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None


class NullEventLog:
    """Disabled event log: emits vanish, queries are empty."""

    events: tuple = ()

    def emit(self, kind: str, req_id: Optional[int] = None, **fields) -> None:
        return None

    def __len__(self) -> int:
        return 0

    def timeline(self, req_id: int) -> list:
        return []

    def kinds(self) -> dict:
        return {}

    def tail(self, n: int) -> list:
        return []

    def to_jsonl(self, path: str) -> Optional[str]:
        return None

    def close(self) -> None:
        pass


NULL_EVENTS = NullEventLog()
