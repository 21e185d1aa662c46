"""Deterministic synthetic LM corpus: a zipfian-markov token process.

A numpy copy of the JAX package's generator, bit-equal to it: token ``t+1``
is one of ``BRANCH`` successors of token ``t`` (an affine map of the current
token), drawn from a zipf-ish distribution, with occasional uniform noise.
Everything is a pure function of (seed, step, position), so a restarted job
regenerates exactly the same global batch for a given step.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

BRANCH = 4
NOISE = 0.05


def _branch_probs() -> np.ndarray:
    p = 1.0 / (np.arange(1, BRANCH + 1) ** 1.5)
    return p / p.sum()


def _successor(tok: np.ndarray, branch: np.ndarray, vocab: int) -> np.ndarray:
    # affine successor map: distinct multipliers per branch, coprime-ish
    mult = 2 * branch + 1
    return (tok * mult + branch * 7919 + 13) % vocab


def gen_tokens(seed: int, step: int, batch: int, seq: int, vocab: int,
               *, row_offset: int = 0, total_rows: Optional[int] = None,
               ) -> np.ndarray:
    """Generate tokens[batch, seq+1] for a given global step.

    ``row_offset`` lets a process generate only its slice of the global
    batch (rows are independent streams keyed by their *global* row index).
    """
    rows = np.arange(row_offset, row_offset + batch)
    rng_seed = (np.uint64(seed) * np.uint64(1000003)
                + np.uint64(step) * np.uint64(8191)) % np.uint64(2**31)
    out = np.empty((batch, seq + 1), np.int64)
    probs = _branch_probs()
    for i, r in enumerate(rows):
        rng = np.random.RandomState(int((rng_seed + np.uint64(r)) % (2**31)))
        tok = rng.randint(0, vocab)
        seqv = np.empty(seq + 1, np.int64)
        branches = rng.choice(BRANCH, size=seq + 1, p=probs)
        noise = rng.rand(seq + 1) < NOISE
        rand_toks = rng.randint(0, vocab, size=seq + 1)
        for t in range(seq + 1):
            seqv[t] = tok
            nxt = _successor(np.int64(tok), np.int64(branches[t]), vocab)
            tok = rand_toks[t] if noise[t] else int(nxt)
        out[i] = seqv
    return out


def optimal_loss(vocab: int) -> float:
    """Cross-entropy of the true process (lower bound for convergence runs)."""
    p = _branch_probs()
    p_eff = (1 - NOISE) * p
    ent_branch = -np.sum(p_eff * np.log(p_eff + 1e-12))
    ent_noise = -NOISE * np.log(NOISE / vocab + 1e-12)
    return float(ent_branch + ent_noise)


def require_token_stream(cfg, who: str) -> None:
    """Refuse, up front, a model whose batches this corpus cannot make.

    The corpus is tokens only, as the JAX package's is
    (``data/synthetic.py``): an audio model needs ``frames`` and a VLM its
    M-RoPE ``positions``, which neither package's :func:`batch_for_step`
    yields (the JAX package's ``train``, trajectory and autogrow die on
    the missing key). ``who`` names the caller in the message."""
    need = {"audio": "frames", "vlm": "positions"}.get(cfg.modality)
    if need is not None:
        raise ValueError(
            f"{who}: {cfg.name} ({cfg.modality}) needs '{need}' in every "
            f"batch, and the synthetic stream (batch_for_step) makes tokens "
            f"only, as the JAX package's does: that package has no "
            f"{cfg.modality} path here either")


def batch_for_step(cfg, step: int, batch: int, seq: int, *, seed: int = 0,
                   row_offset: int = 0) -> Dict[str, np.ndarray]:
    """Objective-appropriate batch dict (numpy) for a global step."""
    toks = gen_tokens(seed, step, batch, seq, cfg.vocab_size,
                      row_offset=row_offset)
    if cfg.objective == "clm":
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}
    if cfg.objective == "mlm":
        rng = np.random.RandomState(seed * 97 + step)
        mask = rng.rand(batch, seq) < 0.15
        tokens = toks[:, :-1].astype(np.int32)
        labels = tokens.copy()
        tokens = np.where(mask, cfg.vocab_size - 1, tokens)  # [MASK] id
        return {"tokens": tokens, "mask": mask, "labels": labels}
    raise ValueError(cfg.objective)


def data_iterator(cfg, batch: int, seq: int, *, seed: int = 0,
                  start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Host batches of consecutive steps from ``start_step`` on."""
    step = start_step
    while True:
        yield batch_for_step(cfg, step, batch, seq, seed=seed)
        step += 1
