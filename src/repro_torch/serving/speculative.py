"""Host-side sampling primitives of speculative decoding (the part of the
JAX package's ``serving/speculative.py`` the serving engine's sampler
needs).

The engine samples on the host from the logits it reads back each step:
:func:`adjust_probs` applies temperature and top-p, and :func:`philox` gives
each request a counter-based random stream keyed ``(seed, request, draw)``,
so runs are reproducible and slots independent. The draft and verify
programs, sampled acceptance and the drafter are the ROADMAP item
"speculative decoding".
"""
from __future__ import annotations

import numpy as np


def philox(seed: int, uid: int, counter: int) -> np.random.Generator:
    """Counter-based per-request RNG: a fresh generator per draw keyed by
    the draw index, so reproducibility never depends on call order."""
    bits = np.asarray([seed, uid, counter, 0], np.uint64)
    return np.random.Generator(np.random.Philox(counter=bits,
                                                key=[seed, uid]))


def adjust_probs(logits: np.ndarray, temperature: float,
                 top_p: float) -> np.ndarray:
    """Temperature + top-p adjusted distribution (float64, host-side).

    top-p keeps the smallest prefix of the descending-sorted distribution
    whose *preceding* cumulative mass is < top_p (top-1 always survives),
    then renormalises.
    """
    l = np.asarray(logits, np.float64)
    if temperature > 0:
        l = l / temperature
    l = l - l.max()
    p = np.exp(l)
    p /= p.sum()
    if top_p < 1.0:
        order = np.argsort(-p)
        ps = p[order]
        keep_sorted = np.concatenate([[True], np.cumsum(ps)[:-1] < top_p])
        keep = np.zeros_like(p, bool)
        keep[order] = keep_sorted
        p = np.where(keep, p, 0.0)
        p /= p.sum()
    return p
