"""Replay a flight-recorder bundle and verify it reproduces bitwise (port
of ``repro/launch/replay.py``).

    PYTHONPATH=src python -m repro_torch.launch.replay BUNDLE_DIR [--json] \
        [--max-steps N] [--device cpu]

Rebuilds the recorded engine from the bundle's manifest, re-feeds the
recorded arrivals on their recorded step schedule with the recorded
decision clock scripted back, and compares greedy token streams and the
scheduler decision journal event by event.  Exit 0 iff the replay is
bitwise identical; otherwise the first divergent decision is printed with
both contexts (see ``repro_torch.obs.replay.diff_journals``).  The replay
runs on the card unless ``--device cpu`` is given.

Record a bundle with ``ObsConfig(record_path=DIR)``; bundles the JAX
package recorded replay too.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.replay import replay_bundle


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="replay a flight-recorder bundle and check it "
                    "reproduces the recorded run bitwise")
    ap.add_argument("bundle", help="bundle directory (ObsConfig(record_path=DIR))")
    ap.add_argument("--max-steps", type=int, default=100_000,
                    help="engine-step cap so a divergent replay that can "
                         "never drain still terminates")
    ap.add_argument("--json", action="store_true",
                    help="emit a machine-readable verdict instead of text")
    ap.add_argument("--device", default=None,
                    help="torch device of the replay (default: the card)")
    args = ap.parse_args(argv)

    res = replay_bundle(args.bundle, max_steps=args.max_steps, device=args.device)
    if args.json:
        doc = {
            "bundle": res.bundle,
            "ok": res.ok,
            "n_requests": res.n_requests,
            "n_recorded_events": res.n_recorded_events,
            "n_replayed_events": res.n_replayed_events,
            "token_mismatches": res.token_mismatches,
            "divergence": (res.divergence.format()
                           if res.divergence is not None else None),
            "warnings": res.warnings,
            "error": res.error,
        }
        print(json.dumps(doc, indent=1))
    else:
        print(res.summary())
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
