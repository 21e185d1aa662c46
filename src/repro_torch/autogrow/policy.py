"""Pluggable growth policies: *when* (and with *which operator*) to grow (the
twin of the JAX package's ``autogrow/policy.py``).

A policy looks at the stage's
:class:`~repro_torch.autogrow.telemetry.Telemetry` stream once per train
step and answers "should this stage end now?". Four kinds ship, selected by :class:`PolicySpec.kind`:

- ``step_budget`` — fire at a fixed step count; exactly today's static
  schedule, expressed as a policy (the identity element of the controller).
- ``loss_plateau`` — fire when the relative EMA-loss improvement over the
  telemetry window falls below ``tol`` ("Stacking Your Transformers": grow
  when the small model stops paying for its steps).
- ``rpf_decay`` — fire when return-per-FLOP (−dloss/dFLOPs, FLOPs from the
  roofline model) decays below ``decay`` × its running peak; the same trigger
  phrased in compute rather than steps, so it transfers across batch/seq
  geometry.
- ``probe`` — Landscape-Aware-Growing style (Karp et al., 2024): the trigger
  is the plateau rule, and at the hop the runner calls
  :func:`probe_methods`, which short-trains every candidate growth operator
  for ``probe_steps`` and commits the one with the best probed loss.

Every policy is a pure function of (stage_step, telemetry); all mutable
signal state lives in the telemetry stream, which the runner checkpoints —
so a killed-and-resumed stage replays the identical decision sequence.
The specs, their validation messages and every ``why()`` string are the
JAX package's, so a schedule hashes alike in both packages and a decision
logged by either reads the same.

:func:`probe_methods` grows each candidate through
:func:`repro_torch.core.grow.grow` — on the card the LiGO candidate's
operator steps run kernel K1 forward and K2 backward, and every grow of
the parameters and the AdamW moments runs K1 — and trains it with the
port's train step. Each candidate's tree is dropped before the next is
built, so at most one grown model, its moments and its probe state are
alive at a time.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.autogrow.telemetry import Telemetry

POLICY_KINDS = ("step_budget", "loss_plateau", "rpf_decay", "probe")


@dataclass(frozen=True)
class PolicySpec:
    """Pure-data description of a growth policy (JSON-round-trippable,
    hashed into the trajectory identity)."""
    kind: str = "step_budget"
    max_steps: int = 0            # hard stage cap; required for "auto" stages
    min_steps: int = 0            # never fire before this many stage steps
    window: int = 16              # telemetry ring size the signals average over
    tol: float = 2e-3             # loss_plateau: min relative EMA gain / window
    decay: float = 0.25           # rpf_decay: fire below decay * peak rpf
    ema_halflife: float = 8.0
    probe_candidates: Tuple[str, ...] = ()   # growth methods probed at the hop
    probe_steps: int = 8          # short-training budget per candidate
    probe_ligo_steps: int = 4     # LiGO budget inside a probe (ligo candidate)

    def __post_init__(self):
        if self.kind not in POLICY_KINDS:
            raise ValueError(f"unknown policy kind {self.kind!r} "
                             f"(one of {POLICY_KINDS})")
        if self.kind == "probe":
            if not self.probe_candidates:
                raise ValueError("probe policy needs probe_candidates")
            if self.probe_steps < 1:
                raise ValueError("probe policy needs probe_steps >= 1 "
                                 "(candidates are scored by probed loss)")

    @staticmethod
    def from_json(obj: Dict) -> "PolicySpec":
        known = {f.name for f in dataclasses.fields(PolicySpec)}
        extra = set(obj) - known
        if extra:
            raise ValueError(f"unknown policy keys {sorted(extra)} "
                             f"(known: {sorted(known)})")
        kw = dict(obj)
        if "probe_candidates" in kw:
            kw["probe_candidates"] = tuple(kw["probe_candidates"])
        return PolicySpec(**kw)


# ---------------------------------------------------------------------------
class Policy:
    def __init__(self, spec: PolicySpec):
        self.spec = spec

    def telemetry(self, *, flops_per_step: float = 0.0,
                  tokens_per_step: float = 0.0) -> Telemetry:
        """A telemetry stream sized for this policy's signals."""
        return Telemetry(window=self.spec.window,
                         flops_per_step=flops_per_step,
                         tokens_per_step=tokens_per_step,
                         ema_halflife=self.spec.ema_halflife)

    def should_grow(self, stage_step: int, tele: Telemetry) -> bool:
        raise NotImplementedError

    def why(self, stage_step: int, tele: Telemetry) -> str:
        """One-line description of the firing condition (for logs)."""
        return self.spec.kind


class StepBudgetPolicy(Policy):
    """Grow at a fixed step count — the static schedule as a policy."""

    def should_grow(self, stage_step: int, tele: Telemetry) -> bool:
        return stage_step >= self.spec.max_steps

    def why(self, stage_step: int, tele: Telemetry) -> str:
        return f"step budget {self.spec.max_steps} reached"


class LossPlateauPolicy(Policy):
    """Grow when the windowed EMA-loss improvement drops below ``tol``."""

    def should_grow(self, stage_step: int, tele: Telemetry) -> bool:
        if stage_step < self.spec.min_steps:
            return False
        imp = tele.improvement()
        return imp is not None and imp < self.spec.tol

    def why(self, stage_step: int, tele: Telemetry) -> str:
        imp = tele.improvement()
        return (f"loss plateau: EMA improvement {imp:.2e} < tol "
                f"{self.spec.tol:.2e} over window {self.spec.window}"
                if imp is not None else "loss plateau")


class RpfDecayPolicy(Policy):
    """Grow when return-per-FLOP decays below ``decay`` × its peak."""

    def should_grow(self, stage_step: int, tele: Telemetry) -> bool:
        if stage_step < self.spec.min_steps or not tele.full:
            return False
        frac = tele.rpf_decay()
        return frac is not None and frac < self.spec.decay

    def why(self, stage_step: int, tele: Telemetry) -> str:
        frac = tele.rpf_decay()
        return (f"return-per-FLOP decayed to {frac:.3f} of peak "
                f"(threshold {self.spec.decay})"
                if frac is not None else "rpf decay")


class ProbePolicy(LossPlateauPolicy):
    """Plateau-triggered; the *operator choice* happens at the hop via
    :func:`probe_methods` (the runner consumes ``spec.probe_candidates``)."""


_POLICIES = {"step_budget": StepBudgetPolicy,
             "loss_plateau": LossPlateauPolicy,
             "rpf_decay": RpfDecayPolicy,
             "probe": ProbePolicy}


def make_policy(spec: PolicySpec) -> Policy:
    return _POLICIES[spec.kind](spec)


# ---------------------------------------------------------------------------
# LAG-style candidate probing
# ---------------------------------------------------------------------------
def probe_methods(params, opt_state, cfg1, cfg2, spec: PolicySpec, *,
                  lr: float, batch: int, seq: int, seed: int = 0,
                  verbose: bool = False) -> Tuple[str, Dict[str, float]]:
    """Short-train every candidate growth operator; pick by probed loss.

    For each method in ``spec.probe_candidates``: grow ``params`` (a cheap
    ``probe_ligo_steps`` LiGO budget for the learned candidate, AdamW moments
    carried), run ``probe_steps`` train steps on the grown model, and score
    it by the mean loss of the probe's second half (the first half is warmup
    + loss-spike transient). Returns ``(best_method, {method: score})``; the
    probe's trained parameters are discarded — the caller commits the real
    hop with the winning method and its full budget.

    Everything runs on the device of ``params``; candidate ``i`` draws from
    a generator seeded ``seed + 17 * (i + 1)`` (the JAX package's
    ``PRNGKey``). ``params`` and ``opt_state`` come back untouched: growth
    and the train step build new tensors. Each candidate runs inside an
    ``autogrow.probe`` span (``method``), whose ``dur_ms`` is its wall.
    """
    import torch

    from repro_torch import obs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.grow import grow
    from repro_torch.data import batch_for_step
    from repro_torch.data.synthetic import require_token_stream
    from repro_torch.training import make_train_step, to_device
    from repro_torch.tree import tree_leaves

    for c in (cfg1, cfg2):
        require_token_stream(c, "autogrow probe")

    dev = tree_leaves(params)[0].device

    def ligo_batches():
        t = 0
        while True:
            yield to_device(batch_for_step(cfg1, t, batch, seq,
                                           seed=seed + 373), dev)
            t += 1

    tcfg = TrainConfig(steps=spec.probe_steps, warmup_steps=1,
                       lr=lr, seq_len=seq, global_batch=batch)
    step = make_train_step(cfg2, tcfg)
    scores: Dict[str, float] = {}
    for i, method in enumerate(spec.probe_candidates):
        with obs.span("autogrow.probe", method=method):
            big, info = grow(params, cfg1, cfg2, method=method,
                             gen=torch.Generator(device=dev).manual_seed(
                                 seed + 17 * (i + 1)),
                             data_it=ligo_batches(),
                             ligo_steps=spec.probe_ligo_steps,
                             opt_state=opt_state)
            popt = info["opt_state"]
            del info
            losses = []
            for t in range(spec.probe_steps):
                b = to_device(batch_for_step(cfg2, t, batch, seq,
                                             seed=seed + 991), dev)
                big, popt, m = step(big, popt, b, t)
                losses.append(float(m["total"]))
            # the candidate's tree and moments go before the next is built
            del big, popt, m
        tail = losses[len(losses) // 2:]
        scores[method] = sum(tail) / len(tail)
        if verbose:
            print(f"[probe] {method}: {scores[method]:.4f}", flush=True)
    best = min(scores, key=scores.get)
    return best, scores
