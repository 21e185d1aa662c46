"""Speculative decoding: draft with the pre-hop model, verify with the grown
(the port of the JAX package's ``serving/speculative.py``).

During a live hop the engine holds both parameter sets, so the small model
is a *free* drafter. Each scheduling round drafts K tokens per slot with
K+1 decode steps of the small model, each feeding its argmax (or its
sample) forward on the device with no host sync between steps, then
verifies all K with the grown model's decode step run over the K+1 inputs
``[last, s_1..s_K]``, one column at a time: the same ``decode_step`` the
vanilla path runs, giving the K+1 next-token distributions.

Acceptance is decided on the host (the logits come back anyway: the vanilla
path reads them per token, the speculative path once per K+1 tokens):

- **greedy**: accept the longest prefix where the draft matches the
  verifier argmax, then emit the verifier's own next token. Every emitted
  token is an argmax of the grown model's logits at the correct prefix,
  computed by the vanilla path's own decode step, so the output is
  *bit-equal* to vanilla greedy decode; the drafts only decide how many
  positions one round advances.
- **sampled**: the standard reject-and-resample rule: accept draft ``s``
  with probability ``min(1, p_big(s)/p_small(s))``, else resample from
  ``normalize(max(p_big - p_small, 0))``. The drafter *returns* the exact
  adjusted distributions it sampled from, so the host-side rule uses the
  true ``p_small``.

Rollback is positional, not copy-based: the draft and verify steps write
cache entries at ``pos..pos+K`` for every slot (in place), and the engine
then resets each slot's position to its host-side truth. Entries beyond a
slot's position are masked by ``cur_len`` and overwritten exactly when they
next become valid.

Randomness: the host side is a counter-based Philox chain keyed ``(seed,
request, draw)``, as in the JAX package. The device drafter samples by the
Gumbel-max rule, as ``jax.random.categorical`` does, adding one round's
noise tensor from :func:`draft_noise` (the counterpart of the JAX package's
``draft_keys``), which the engine reads through this module's attribute.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import decode_step
from repro_torch.obs import counter_group

# Function builds per kind: cache hits don't count, so a hop cycle that
# rebuilds its draft or verify function shows up here.
BUILD_COUNTS = counter_group("serve.spec.builds")

_TINY = 1e-20


# ---------------------------------------------------------------------------
# Sampling primitives (host + device twins)
# ---------------------------------------------------------------------------
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


def device_adjust_probs(logits: torch.Tensor, temperature: float,
                        top_p: float) -> torch.Tensor:
    """The tensor twin of :func:`adjust_probs` over (B, V) logits, in
    float32."""
    l = logits.float()
    if temperature > 0:
        l = l / temperature
    p = torch.softmax(l, dim=-1)
    if top_p < 1.0:
        ps, order = torch.sort(p, dim=-1, descending=True)
        prev = torch.cumsum(ps, dim=-1) - ps          # mass before each rank
        keep_sorted = prev < top_p                    # rank 0 always kept
        # back to vocabulary order: ``order`` is a permutation of each row,
        # so every index is written once
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        p = torch.where(keep, p, torch.zeros_like(p))
        p = p / p.sum(dim=-1, keepdim=True)
    return p


def draft_noise(seed: int, round_idx: int, K1: int, slots: int, V: int,
                device) -> torch.Tensor:
    """One round's noise for the sampled drafter: (K1, slots, V) float32
    standard Gumbel draws, made on ``device`` from one generator seeded
    from ``(seed, round)``, so every round's draws have a stable identity
    across runs. Step j of the draft samples slot b's token as
    ``argmax(log p + noise[j, b])``."""
    key = np.random.SeedSequence([int(seed), int(round_idx)]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(key) & ((1 << 63) - 1))
    u = torch.rand((K1, slots, V), generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_min(_TINY)))


# ---------------------------------------------------------------------------
# Draft / verify functions (memoised per (cfg, K, ...))
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=32)
def make_draft_fn(cfg: ModelConfig, K: int):
    """Greedy drafter: K+1 decode steps of the small model, each feeding its
    argmax forward on the device. Returns ``draft(params, state, last)`` ->
    (tokens (B, K), logits (B, K, V), state).

    K+1 steps for K drafts, deliberately: step j caches its *input* token
    at pos+j, so stopping after K steps would leave position pos+K (the
    K-th draft's cache entry) unwritten, a hole the drafter would decode
    across on the next round whenever the verifier accepted everything.
    The extra step's output token is discarded; its cache write is the
    point."""
    BUILD_COUNTS.inc("draft")

    @torch.no_grad()
    def draft(params, state, last):
        toks: List[torch.Tensor] = []
        logits: List[torch.Tensor] = []
        tok = last
        for _ in range(K + 1):
            lg, state = decode_step(params, cfg, state, {"tokens": tok})
            nxt = torch.argmax(lg, dim=-1)
            toks.append(nxt)
            logits.append(lg)
            tok = nxt[:, None]
        return (torch.stack(toks[:K], dim=1), torch.stack(logits[:K], dim=1),
                state)

    return draft


@functools.lru_cache(maxsize=32)
def make_sampled_draft_fn(cfg: ModelConfig, K: int, temperature: float,
                          top_p: float):
    """Sampled drafter: the same K+1 steps, but step j draws slot b's token
    from the adjusted distribution ``p`` as ``argmax(log(max(p, 1e-20)) +
    noise[j, b])``, with ``noise`` (K+1, B, V) from :func:`draft_noise`.
    Returns ``draft(params, state, last, noise)`` -> (tokens (B, K), probs
    (B, K, V): the exact distributions sampled from, state). The last
    step's draw is discarded with its token, for the cache-completeness
    reason of :func:`make_draft_fn`."""
    BUILD_COUNTS.inc("sampled_draft")

    @torch.no_grad()
    def draft(params, state, last, noise):
        toks: List[torch.Tensor] = []
        probs: List[torch.Tensor] = []
        tok = last
        for j in range(K + 1):
            lg, state = decode_step(params, cfg, state, {"tokens": tok})
            p = device_adjust_probs(lg, temperature, top_p)
            nxt = torch.argmax(torch.log(p.clamp_min(_TINY)) + noise[j],
                               dim=-1)
            toks.append(nxt)
            probs.append(p)
            tok = nxt[:, None]
        return (torch.stack(toks[:K], dim=1), torch.stack(probs[:K], dim=1),
                state)

    return draft


@functools.lru_cache(maxsize=32)
def make_verify_fn(cfg: ModelConfig, K1: int, want_hidden: bool):
    """Verifier: the grown model's decode step over the K1 = K+1 given
    inputs, one column at a time (no feedback: the tokens are fixed),
    yielding all K1 next-token logits, stacked on the device. The step is
    the same ``decode_step`` the vanilla path runs, at the same (slots, 1)
    shape, which is what makes greedy acceptance bit-equal to vanilla
    greedy; one (slots, K1) forward would sum in another order.

    Returns ``verify(params, state, inputs)`` -> (logits (B, K1, V)[,
    prenorm hidden (B, K1, D)], state).
    """
    BUILD_COUNTS.inc("verify")

    @torch.no_grad()
    def verify(params, state, inputs):                 # inputs: (B, K1)
        logits: List[torch.Tensor] = []
        hidden: List[torch.Tensor] = []
        for j in range(K1):
            out = decode_step(params, cfg, state,
                              {"tokens": inputs[:, j:j + 1]},
                              return_prenorm=want_hidden)
            logits.append(out[0])
            state = out[1]
            if want_hidden:
                hidden.append(out[2][:, 0])
        if want_hidden:
            return (torch.stack(logits, dim=1), torch.stack(hidden, dim=1),
                    state)
        return torch.stack(logits, dim=1), state

    return verify


# ---------------------------------------------------------------------------
# Host-side acceptance
# ---------------------------------------------------------------------------
def accept_greedy(draft_toks: np.ndarray,
                  verify_logits: np.ndarray) -> Tuple[List[int], int]:
    """Longest-prefix-match acceptance for one slot.

    draft_toks: (K,); verify_logits: (K+1, V). Returns (emit, accepted):
    the tokens to emit (accepted drafts + the verifier's own next token)
    and the accepted-draft count.
    """
    g = np.argmax(verify_logits, axis=-1)
    K = draft_toks.shape[0]
    a = 0
    while a < K and int(draft_toks[a]) == int(g[a]):
        a += 1
    return [int(t) for t in draft_toks[:a]] + [int(g[a])], a


def accept_sampled(draft_toks: np.ndarray, draft_probs: np.ndarray,
                   verify_logits: np.ndarray, *, temperature: float,
                   top_p: float, seed: int, uid: int, counter: int):
    """Reject-and-resample acceptance for one slot.

    draft_toks: (K,); draft_probs: (K, V), the device drafter's exact
    distributions; verify_logits: (K+1, V). Returns (emit, accepted,
    draws_used).
    """
    K = draft_toks.shape[0]
    emit, a, draws = [], 0, 0
    for j in range(K):
        s = int(draft_toks[j])
        pb = adjust_probs(verify_logits[j], temperature, top_p)
        ps = np.asarray(draft_probs[j], np.float64)
        u = philox(seed, uid, counter + draws).random()
        draws += 1
        if u < min(1.0, pb[s] / max(ps[s], _TINY)):
            emit.append(s)
            a += 1
            continue
        resid = np.maximum(pb - ps, 0.0)
        tot = resid.sum()
        resid = resid / tot if tot > 0 else pb
        emit.append(int(philox(seed, uid, counter + draws).choice(
            len(resid), p=resid)))
        draws += 1
        return emit, a, draws
    pb = adjust_probs(verify_logits[K], temperature, top_p)
    emit.append(int(philox(seed, uid, counter + draws).choice(
        len(pb), p=pb)))
    draws += 1
    return emit, a, draws
