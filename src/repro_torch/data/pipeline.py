"""Batches on the device (the one-device twin of the JAX package's
``data/pipeline.py::GlobalBatchLoader``).

The batch of a step is a pure function of (seed, step)
(:func:`repro_torch.data.batch_for_step`), so a resumed job sees the same
tokens at the same step. The JAX package's mesh sharding and host
prefetch thread are not ported.
"""
from __future__ import annotations

from typing import Dict, Iterator

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
