"""Admission control for the serving engine: a bounded request queue (a
copy of the JAX package's ``serving/admission.py``, plus the first- and
last-token logits each request keeps).

Backpressure is a rejection at the door, never a drop after admission — an
admitted request either finishes or survives every hop (the engine's
rollback guarantee only has to cover requests past this gate).
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

_UIDS = itertools.count()


@dataclass
class Request:
    """One generation session: prompt in, tokens accumulated per decode step.

    The full token history (``prompt + tokens``) is retained while the
    session is live — it is the universal fallback for cache migration
    (re-prefill under grown weights) and the payload returned to the user.
    """
    prompt: List[int]
    max_new: int
    uid: int = field(default_factory=lambda: next(_UIDS))
    tokens: List[int] = field(default_factory=list)
    status: str = "queued"          # queued|running|done|rejected
    slot: int = -1
    true_len: int = 0               # prompt length at prefill time
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    n_draws: int = 0                # sampling PRNG chain position
    sample_key: int = 0             # engine-local PRNG identity (not uid:
    #   uid is process-global, so it breaks same-seed reproducibility when
    #   several engines run in one process)
    acc_ema: Optional[float] = None  # speculative acceptance EMA (this slot)
    # the float32 logits row the first and the last token were picked from
    # (the card's smoke run compares them across routes and layouts)
    first_logits: Optional[np.ndarray] = None
    last_logits: Optional[np.ndarray] = None

    @property
    def text_tokens(self) -> List[int]:
        return list(self.prompt) + list(self.tokens)


class AdmissionQueue:
    """Bounded FIFO with thread-safe submit (a caller may submit while a
    background grow is in flight)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._q: deque = deque()
        self._lock = threading.Lock()
        self.rejected = 0

    def submit(self, req: Request) -> bool:
        with self._lock:
            if len(self._q) >= self.capacity:
                self.rejected += 1
                req.status = "rejected"
                return False
            self._q.append(req)
            return True

    def pop(self) -> Optional[Request]:
        with self._lock:
            return self._q.popleft() if self._q else None

    def peek(self) -> Optional[Request]:
        """Head of the queue without removing it — the paged engine defers
        admission (rather than drop) when the pool can't back the request's
        worst case yet."""
        with self._lock:
            return self._q[0] if self._q else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)
