"""The traffic generator: batches of a zipfian-markov token corpus.

A copy of the process of ``repro_torch/data/synthetic.py``, frozen here
so that the yardstick does not move with the program: token ``t+1`` is one
of ``branch`` successors of token ``t`` (an affine map of the token), the
successor drawn with probability proportional to ``1 / (i + 1) ** zipf``,
and with probability ``noise`` a uniform token instead. The program's copy
loops over rows and positions in Python; this one steps the positions
over all rows at once, from a numpy ``Generator`` keyed by the run's seed,
so that a pool of thousands of rows takes milliseconds. The rows differ in
every batch of the pool.

A traffic file (``perfbench/traffic/<name>.json``) gives ``rows``,
``seq``, ``pool`` (distinct batches, cycled through the window) and the
corpus parameters.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def _successor(tok: np.ndarray, branch: np.ndarray, vocab: int) -> np.ndarray:
    return (tok * (2 * branch + 1) + branch * 7919 + 13) % vocab


def tokens(seed: int, n_rows: int, length: int, vocab: int, *,
           branch: int = 4, noise: float = 0.05,
           zipf: float = 1.5) -> np.ndarray:
    """``n_rows`` independent streams of ``length`` tokens, int64."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, branch + 1) ** zipf
    probs /= probs.sum()
    branches = rng.choice(branch, size=(length, n_rows), p=probs)
    noisy = rng.random((length, n_rows)) < noise
    uniform = rng.integers(0, vocab, size=(length, n_rows))
    out = np.empty((length, n_rows), np.int64)
    tok = rng.integers(0, vocab, size=n_rows)
    for t in range(length):
        out[t] = tok
        tok = np.where(noisy[t], uniform[t],
                       _successor(tok, branches[t], vocab))
    return np.ascontiguousarray(out.T)


def batches(traffic: Dict, vocab: int, seed: int, device) -> List[Dict]:
    """The traffic's pool of causal-LM batches on ``device``: each a dict
    of ``tokens`` and ``targets`` (rows, seq) int32, targets shifted by
    one position."""
    import torch
    rows, seq, pool = traffic["rows"], traffic["seq"], traffic["pool"]
    corpus = traffic.get("corpus", {})
    toks = tokens(seed, pool * rows, seq + 1, vocab, **corpus)
    toks = torch.from_numpy(toks.astype(np.int32)).to(device)
    toks = toks.reshape(pool, rows, seq + 1)
    return [{"tokens": toks[i, :, :-1].contiguous(),
             "targets": toks[i, :, 1:].contiguous()} for i in range(pool)]
