"""Trajectory configuration: an ordered schedule of train→grow→train stages
(the twin of the JAX package's ``trajectory/config.py``, for the dense and
MoE families).

A :class:`TrajectoryConfig` is pure data: which architecture each stage
trains, for how many steps, and how each stage is entered (the growth
method and its LiGO budget). Its :meth:`TrajectoryConfig.hash` is stamped
into every checkpoint, so a resume refuses state of another schedule. It
is built from the fields of the JAX package's and hashes to the same
value for the same schedule, so a checkpoint directory written by either
package is recognised by the other.

JSON format (``launch/train.py --trajectory cfg.json`` /
``--autogrow cfg.json``)::

    {
      "arch": "gpt2-base",        # base registry arch
      "smoke": false,             # reduce via smoke_config
      "batch": 8, "seq": 128, "lr": 1e-3, "checkpoint_every": 2, "seed": 0,
      "stages": [
        {"steps": 4},                                    # stage 0: source
        {"steps": 4, "arch": "gpt2-medium",              # grow INTO stage 1
         "method": "ligo", "ligo_steps": 4, "ligo_scan_chunk": 2}
      ]
    }

Stage 0 defaults to the base arch; ``"half"`` takes ``half_config`` of
it; any other name hits the registry (smoke-reduced when ``smoke``). Later
stages default to ``"grow": "2x"`` (``grow_target`` of the previous stage),
take ``"grow": "moe"`` (``moe_target`` of the previous stage: the
dense→MoE upcycling hop, entered with ``"method": "upcycle"`` or
``"ligo"``) or name a registry arch. Every consecutive pair must pass
``check_growable``.

``"steps": "auto"`` hands the stage's end to the adaptive growth
controller (:mod:`repro_torch.autogrow`): the stage trains until its
``policy`` block fires (or the policy's mandatory ``max_steps`` cap),
instead of a fixed count::

        {"steps": "auto", "arch": "gpt2-medium", "method": "ligo",
         "policy": {"kind": "loss_plateau", "max_steps": 80,
                    "min_steps": 10, "window": 8, "tol": 2e-3}}

``Stage.budget`` is the hard upper bound either way; the controller lives
in the runner, this file stays pure data. The policy block is part of the
schedule's hash, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from repro_torch.autogrow.policy import PolicySpec
from repro_torch.configs.base import ModelConfig
from repro_torch.core import spec as S

# Growth methods that understand a family-changing hop (dense→MoE
# upcycling): the classical dense operators (stackbert, net2net, ...)
# assume the target tree mirrors the source and would mis-build the expert
# stack.
CROSS_FAMILY_METHODS = ("upcycle", "ligo", "random")


@dataclass(frozen=True)
class GrowthSpec:
    """How a stage is entered from the previous one."""
    method: str = "ligo"        # ligo | stackbert | interpolation |
    #                             net2net | bert2bert | lemon | upcycle |
    #                             gqa_merge | random
    ligo_steps: int = 100       # SGD steps on the operator (ligo only)
    ligo_lr: float = 1e-3
    ligo_momentum: float = 0.9
    grow_optimizer: bool = True  # carry AdamW moments through the operator
    ligo_scan_chunk: int = 0     # LiGO-phase chunk length (0 = auto): the
    #                              phase checkpoints at chunk boundaries, so
    #                              this is also the resume granularity


@dataclass(frozen=True)
class Stage:
    """One trajectory stage: an architecture trained for ``steps`` steps.

    ``steps=None`` is the JSON ``"auto"`` form: the stage ends when its
    ``policy`` fires (:mod:`repro_torch.autogrow.policy`), bounded by the
    policy's ``max_steps``. ``growth`` describes the hop into this stage;
    it is None exactly for stage 0.
    """
    cfg: ModelConfig
    steps: Optional[int]
    growth: Optional[GrowthSpec] = None
    policy: Optional[PolicySpec] = None

    @property
    def auto(self) -> bool:
        return self.steps is None

    @property
    def budget(self) -> int:
        """Hard cap on the stage's train leg (== ``steps`` when static)."""
        return self.steps if self.steps is not None else self.policy.max_steps


@dataclass(frozen=True)
class TrajectoryConfig:
    stages: Tuple[Stage, ...]
    batch: int = 8
    seq: int = 64
    lr: float = 1e-3
    checkpoint_every: int = 50
    seed: int = 0

    def __post_init__(self):
        if not self.stages:
            raise ValueError("a trajectory needs at least one stage")
        if self.stages[0].growth is not None:
            raise ValueError("stage 0 is the source model; it has no "
                             "growth hop")
        for i, st in enumerate(self.stages):
            if st.auto:
                if st.policy is None:
                    raise ValueError(f"stage {i} has steps='auto' but no "
                                     "policy block")
                if st.policy.max_steps <= 0:
                    raise ValueError(f"stage {i}: an auto stage's policy "
                                     "needs max_steps > 0 (the hard cap)")
            elif st.policy is not None:
                raise ValueError(f"stage {i} has both a fixed step count "
                                 "and a policy — use steps='auto' for "
                                 "policy-scheduled stages")
        for i in range(1, len(self.stages)):
            growth = self.stages[i].growth
            if growth is None:
                raise ValueError(f"stage {i} must carry a GrowthSpec")
            prev_cfg, cfg = self.stages[i - 1].cfg, self.stages[i].cfg
            S.check_growable(prev_cfg, cfg)
            if (prev_cfg.family != cfg.family
                    and growth.method not in CROSS_FAMILY_METHODS):
                raise ValueError(
                    f"stage {i}: growth method {growth.method!r} cannot "
                    f"cross the {prev_cfg.family!r} -> {cfg.family!r} "
                    f"family hop ({prev_cfg.name!r} -> {cfg.name!r}); use "
                    f"one of {list(CROSS_FAMILY_METHODS)}")

    # ------------------------------------------------------------------
    @property
    def has_auto_stages(self) -> bool:
        return any(st.auto for st in self.stages)

    @property
    def total_steps(self) -> int:
        """Total train steps — exact for static schedules, the ``budget``
        upper bound for auto stages."""
        return sum(st.budget for st in self.stages)

    def stage_bounds(self) -> Tuple[Tuple[int, int], ...]:
        """[start, end) global-step interval of each stage (budget-based,
        i.e. upper bounds when the schedule has auto stages)."""
        out, start = [], 0
        for st in self.stages:
            out.append((start, start + st.budget))
            start += st.budget
        return tuple(out)

    def hash(self) -> str:
        """Schedule identity, stamped into checkpoint meta by the runner
        (the JAX package's blob, so both packages hash a schedule alike)."""
        blob = json.dumps({
            "stages": [{
                "cfg": st.cfg.config_hash(), "steps": st.steps,
                "growth": (None if st.growth is None
                           else dataclasses.asdict(st.growth)),
                "policy": (None if st.policy is None
                           else dataclasses.asdict(st.policy)),
            } for st in self.stages],
            **{k: getattr(self, k) for k in ("batch", "seq", "lr",
                                             "checkpoint_every", "seed")},
        }, sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]

    # ------------------------------------------------------------------
    @staticmethod
    def from_json(src: Any) -> "TrajectoryConfig":
        """Build from a JSON file path or an already-parsed dict."""
        from repro_torch.configs import (get_config, grow_target,
                                         half_config, moe_target,
                                         smoke_config)
        if isinstance(src, str):
            with open(src) as f:
                obj = json.load(f)
        else:
            obj = dict(src)
        base = get_config(obj["arch"])
        smoke = bool(obj.get("smoke", False))
        if smoke:
            base = smoke_config(base)

        def resolve(entry: Dict, prev: Optional[ModelConfig]) -> ModelConfig:
            if prev is None:                         # stage 0
                name = entry.get("arch")
                if name in (None, "base"):
                    return base
                if name == "half":
                    return half_config(base)
                cfg = get_config(name)
                return smoke_config(cfg) if smoke else cfg
            if "arch" in entry:
                cfg = get_config(entry["arch"])
                return smoke_config(cfg) if smoke else cfg
            tok = entry.get("grow", "2x")
            if tok == "2x":
                return grow_target(prev)
            if tok == "moe":
                return moe_target(prev)
            raise ValueError(f"unknown grow token {tok!r} "
                             "(use '2x', 'moe', or an explicit 'arch')")

        stages, prev = [], None
        for i, entry in enumerate(obj["stages"]):
            cfg = resolve(entry, prev)
            growth = None
            if i > 0:
                growth = GrowthSpec(
                    method=entry.get("method", "ligo"),
                    ligo_steps=int(entry.get("ligo_steps", 100)),
                    ligo_lr=float(entry.get("ligo_lr", 1e-3)),
                    ligo_momentum=float(entry.get("ligo_momentum", 0.9)),
                    grow_optimizer=bool(entry.get("grow_optimizer", True)),
                    ligo_scan_chunk=int(entry.get("ligo_scan_chunk", 0)))
            raw_steps = entry["steps"]
            if raw_steps == "auto":
                steps: Optional[int] = None
                policy = PolicySpec.from_json(entry.get("policy", {}))
            else:
                steps = int(raw_steps)
                policy = (PolicySpec.from_json(entry["policy"])
                          if "policy" in entry else None)
            stages.append(Stage(cfg=cfg, steps=steps, growth=growth,
                                policy=policy))
            prev = cfg
        return TrajectoryConfig(
            stages=tuple(stages),
            batch=int(obj.get("batch", 8)), seq=int(obj.get("seq", 64)),
            lr=float(obj.get("lr", 1e-3)),
            checkpoint_every=int(obj.get("checkpoint_every", 50)),
            seed=int(obj.get("seed", 0)))
