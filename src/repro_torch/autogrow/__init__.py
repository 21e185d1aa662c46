"""repro_torch.autogrow — the adaptive growth controller (the twin of the
JAX package's ``autogrow``, with its export list).

Turns the static ``TrajectoryRunner`` schedule into a closed loop: a
per-stage telemetry stream (:mod:`repro_torch.autogrow.telemetry` —
ring-buffered loss EMA / tokens / roofline FLOPs, exposing
return-per-FLOP) drives a pluggable growth policy
(:mod:`repro_torch.autogrow.policy` — ``step_budget`` reproducing the
static behavior, ``loss_plateau`` / ``rpf_decay`` per "Stacking Your
Transformers", and a LAG-style ``probe`` that short-trains
candidate operators and commits the best). Trajectory stages opt in with
``steps: "auto"`` plus a ``policy`` block
(:class:`repro_torch.trajectory.TrajectoryConfig`); the CLI entry is
``python -m repro_torch.launch.train --autogrow cfg.json``.

The third leg of the subsystem lives in
:func:`repro_torch.core.grow.train_ligo`: the LiGO phase itself is
elastic — it runs in chunked legs whose ``(ligo, momentum, step)`` carry
is checkpointed between chunks, so a job
killed *inside* a long operator-learning hop resumes mid-phase instead of
redoing the hop from the stage boundary.
"""
from repro_torch.autogrow.policy import (POLICY_KINDS, LossPlateauPolicy,
                                         Policy, PolicySpec, ProbePolicy,
                                         RpfDecayPolicy, StepBudgetPolicy,
                                         make_policy, probe_methods)
from repro_torch.autogrow.telemetry import Telemetry

__all__ = ["Telemetry", "PolicySpec", "Policy", "StepBudgetPolicy",
           "LossPlateauPolicy", "RpfDecayPolicy", "ProbePolicy",
           "make_policy", "probe_methods", "POLICY_KINDS"]
