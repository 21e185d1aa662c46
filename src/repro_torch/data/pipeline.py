"""Batches on the device (the one-device twin of the JAX package's
``data/pipeline.py::GlobalBatchLoader``).

The batch of a step is a pure function of (seed, step)
(:func:`repro_torch.data.batch_for_step`), so a resumed job sees the same
tokens at the same step. :class:`Prefetcher` runs any batch iterator on a
bounded background thread, as the JAX package's does. The JAX package's
mesh sharding is not ported.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator

import torch

from repro_torch.data.synthetic import batch_for_step


class GlobalBatchLoader:
    """Yields the batches of consecutive steps, each on ``device``."""

    def __init__(self, cfg, batch: int, seq: int, *, seed: int = 0,
                 start_step: int = 0, device="cuda"):
        self.cfg = cfg
        self.batch, self.seq, self.seed = batch, seq, seed
        self.step = start_step
        self.device = device

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        host = batch_for_step(self.cfg, step, self.batch, self.seq,
                              seed=self.seed)
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in host.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.batch_at(self.step)
            self.step += 1


class Prefetcher:
    """Runs a loader iterator on a background thread with a bounded queue."""

    def __init__(self, it: Iterator, prefetch: int = 2):
        self.q: "queue.Queue[Any]" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
