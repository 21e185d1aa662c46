"""Fault-tolerant training supervision for one device (the twin of the JAX
package's ``distributed/supervisor.py``).

- **checkpoint/restart**: periodic async checkpoints; on a step failure the
  loop restores the latest checkpoint and replays from there. The synthetic
  batches are a pure function of the step, so the replay is exact.
- **straggler watchdog**: an EWMA of the step wall time and its deviation;
  steps slower than ``ewma + z·dev`` are flagged (and passed to a callback).
- **failure injection**: ``fail_at={step: exc}`` for tests.

The JAX package's elastic restore onto another mesh has no counterpart on
one device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import CheckpointManager


@dataclass
class StragglerWatchdog:
    z: float = 4.0
    alpha: float = 0.1
    warmup: int = 5
    ewma: float = 0.0
    dev: float = 0.0
    seen: int = 0
    flagged: list = field(default_factory=list)
    on_straggler: Optional[Callable[[int, float], None]] = None

    def observe(self, step: int, dt: float) -> bool:
        self.seen += 1
        if self.seen <= self.warmup:
            self.ewma = dt if self.seen == 1 else (
                self.alpha * dt + (1 - self.alpha) * self.ewma)
            self.dev = max(self.dev, abs(dt - self.ewma))
            return False
        slow = dt > self.ewma + self.z * max(self.dev, 1e-9)
        if slow:
            self.flagged.append((step, dt))
            if self.on_straggler:
                self.on_straggler(step, dt)
        else:
            self.ewma = self.alpha * dt + (1 - self.alpha) * self.ewma
            self.dev = self.alpha * abs(dt - self.ewma) \
                + (1 - self.alpha) * self.dev
        return slow


class Supervisor:
    def __init__(self, *, ckpt_dir: Optional[str],
                 checkpoint_every: int = 100, keep: int = 3,
                 max_restarts: int = 3,
                 watchdog: Optional[StragglerWatchdog] = None):
        # no directory: no checkpoints, and a failure restarts from the
        # initial state
        self.mgr = (CheckpointManager(ckpt_dir, keep=keep)
                    if ckpt_dir is not None else None)
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts
        self.watchdog = watchdog or StragglerWatchdog()
        self.restarts = 0
        self.history: list = []

    # ------------------------------------------------------------------
    def run(self, state: Dict[str, Any], step_fn: Callable,
            batch_at: Callable[[int], Any], *, start_step: int, steps: int,
            fail_at: Optional[Dict[int, Exception]] = None,
            on_metrics=None, meta: Optional[Dict] = None) -> Dict[str, Any]:
        """Run the steps [start_step, steps) with recovery.

        ``state``: ``{"params", "opt"}``; ``step_fn(params, opt, batch,
        step) -> (params, opt, metrics)``; ``batch_at(step)`` must be
        deterministic in ``step``. ``meta`` (the run's identity) rides on
        every checkpoint this loop writes. ``history`` gets ``(step, loss,
        seconds)`` per step, the seconds on the host clock from the batch
        to the loss read back.
        """
        fail_at = dict(fail_at or {})
        step, initial = start_step, state
        while step < steps:
            try:
                t0 = time.perf_counter()
                if step in fail_at:
                    raise fail_at.pop(step)
                batch = batch_at(step)
                params, opt, metrics = step_fn(state["params"], state["opt"],
                                               batch, step)
                loss = float(metrics["total"])          # host sync point
                state = {"params": params, "opt": opt}
                dt = time.perf_counter() - t0
                self.watchdog.observe(step, dt)
                self.history.append((step, loss, dt))
                if on_metrics:
                    on_metrics(step, metrics)
                step += 1
                if self.mgr is not None and step % self.checkpoint_every == 0:
                    self.mgr.save(step, state, meta)
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — recover from any step fault
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e
                restored = None
                if self.mgr is not None:
                    self.mgr.wait()
                    restored = self.mgr.restore_latest(state)
                if restored is None:
                    # no checkpoint yet: restart from the initial state
                    state, step = initial, start_step
                    continue
                # the restored meta keeps its own name: stamping it on later
                # saves would carry its stale "step"
                state, restored_meta = restored
                step = restored_meta["step"]
        if self.mgr is not None:
            self.mgr.save(steps, state, meta, block=True)
        return state

    # ------------------------------------------------------------------
    def resume(self, template: Dict[str, Any], device=None):
        """Restore the latest checkpoint into ``template``'s structure, on
        ``device`` or the template's devices."""
        return self.mgr.restore_latest(template, device)
