"""Fault tolerance & straggler mitigation for 1000+ node jobs (the port's
copy of the jax-free ``repro/runtime/fault_tolerance.py``).

Three cooperating mechanisms (all exercised by the tests):

* **Checkpoint/restart** — ``run_with_restart`` wraps the training loop;
  on any worker exception it restores the latest atomic checkpoint and
  resumes.  The data pipeline is stateless (step-indexed PRNG), so a
  restarted run replays the *exact* token stream: resume is bit-exact.

* **Elastic scaling** — checkpoints are unsharded host arrays; on restart
  with a different healthy-device count the restore path simply
  moves them onto the new devices (see checkpoint.py).  ``ElasticPlan``
  picks the largest (dp x model) mesh that fits the surviving devices.

* **Straggler detection** — ``StragglerMonitor`` tracks per-host step
  durations with an EWMA and flags hosts slower than ``threshold`` x the
  fleet median; the launcher's response at scale is to evict + restart
  elastically (here: recorded + surfaced in metrics).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class StragglerMonitor:
    n_hosts: int
    threshold: float = 2.0
    alpha: float = 0.3  # EWMA weight

    def __post_init__(self):
        self._ewma = np.zeros(self.n_hosts)
        self._seen = np.zeros(self.n_hosts, bool)

    def record(self, host: int, duration_s: float):
        if not self._seen[host]:
            self._ewma[host] = duration_s
            self._seen[host] = True
        else:
            self._ewma[host] = self.alpha * duration_s + (1 - self.alpha) * self._ewma[host]

    def stragglers(self) -> list[int]:
        if not self._seen.any():
            return []
        med = float(np.median(self._ewma[self._seen]))
        return [
            h for h in range(self.n_hosts)
            if self._seen[h] and self._ewma[h] > self.threshold * max(med, 1e-9)
        ]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Largest viable (dp, model) mesh for the surviving device count."""
    dp: int
    model: int

    @staticmethod
    def plan(healthy_devices: int, model_parallel: int) -> "ElasticPlan":
        if healthy_devices < model_parallel:
            # degrade TP too (restore handles resharding either way)
            model_parallel = max(
                m for m in range(1, healthy_devices + 1) if healthy_devices % m == 0
            )
        dp = healthy_devices // model_parallel
        return ElasticPlan(dp=dp, model=model_parallel)


class WorkerFailure(RuntimeError):
    """Raised by fault-injection hooks in tests."""


def run_with_restart(
    make_state,
    train_one_step,
    ckpt_manager,
    n_steps: int,
    checkpoint_every: int = 10,
    max_failures: int = 3,
    on_restart=None,
):
    """Generic restartable loop.

    ``make_state()`` -> initial (step, state); ``train_one_step(step, state)``
    -> state (may raise).  Returns ((final_step, final_state), n_restarts).
    """
    failures = 0
    step, state = make_state()
    try:
        latest = ckpt_manager.restore_latest(state)
        step, state = latest[0], latest[1]
    except FileNotFoundError:
        pass

    while step < n_steps:
        try:
            state = train_one_step(step, state)
            step += 1
            if step % checkpoint_every == 0 or step == n_steps:
                ckpt_manager.save(step, state, metadata={"wallclock": time.time()})
        except WorkerFailure:
            failures += 1
            if failures > max_failures:
                raise
            if on_restart is not None:
                on_restart(failures)
            # restore-from-latest: may come back on a different mesh.  A
            # failure before the first checkpoint restarts from scratch.
            try:
                step, state, _ = ckpt_manager.restore_latest(state)
            except FileNotFoundError:
                step, state = make_state()
    return (step, state), failures
