"""Ring-buffer metrics stream feeding the adaptive growth controller (the
twin of the JAX package's ``autogrow/telemetry.py``).

A :class:`Telemetry` instance is the controller's whole view of a training
stage: a bounded ring of ``(step, loss, loss_ema, cumulative_FLOPs)`` rows
recorded once per optimizer step by the trainer. From it the growth policies
(:mod:`repro_torch.autogrow.policy`) read the two signals the literature keys
growth on:

- **EMA-loss improvement over the window** — "Stacking Your Transformers"
  (Du et al., 2024) grows when the small model's progress flattens;
  :meth:`improvement` is the relative EMA drop across the ring.
- **return-per-FLOP slope** — the same work frames the trigger as the decay
  of loss improvement *per unit compute*; :meth:`rpf` is ``-d(loss)/d(FLOPs)``
  via a least-squares fit of the EMA over the ring's cumulative-FLOP axis
  (FLOPs/step from :func:`repro_torch.roofline.train_flops_per_step`), and
  ``peak_rpf`` tracks its running maximum so policies can fire on relative
  decay.

The stream must survive a kill: :meth:`snapshot` emits a small JSON-safe dict
(the ring rows plus the EMA/peak accumulators) that the trajectory runner
stamps into every checkpoint's meta, and :meth:`restore` rebuilds an
identical stream — so a resumed stage makes the *same* growth decision at the
same step as the uninterrupted run.

The stream also *publishes* to the obs registry (write-only gauges:
``autogrow.loss``, ``autogrow.loss_ema``, ``autogrow.rpf``,
``autogrow.peak_rpf``, ``autogrow.cum_flops``). Policies never read the
registry — decisions are a function of the ring alone, so the
replay-determinism contract above is untouched.

The stream is pure host Python, and its float arithmetic is the JAX
package's operation for operation, in the same order: the same loss stream
gives bit-equal signals in both packages, and a snapshot written by either
restores in the other (the keys and the ring's layout are the same).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from repro_torch import obs


class Telemetry:
    def __init__(self, *, window: int = 32, flops_per_step: float = 0.0,
                 tokens_per_step: float = 0.0, ema_halflife: float = 8.0):
        if window < 2:
            raise ValueError(f"telemetry window must be >= 2, got {window}")
        self.window = int(window)
        self.flops_per_step = float(flops_per_step)
        self.tokens_per_step = float(tokens_per_step)
        self.ema_halflife = float(ema_halflife)
        # per-record EMA weight: halflife h means a record's influence
        # halves every h steps
        self._alpha = 1.0 - 0.5 ** (1.0 / max(self.ema_halflife, 1e-9))
        self._ring: deque = deque(maxlen=self.window)   # (step, loss, ema, cum_flops)
        self._ema: Optional[float] = None
        self.total_steps = 0
        self.cum_flops = 0.0
        self.cum_tokens = 0.0
        self.peak_rpf = 0.0
        # write-only registry mirror; never read back for decisions
        self._g_loss = obs.gauge("autogrow.loss")
        self._g_ema = obs.gauge("autogrow.loss_ema")
        self._g_rpf = obs.gauge("autogrow.rpf")
        self._g_peak = obs.gauge("autogrow.peak_rpf")
        self._g_flops = obs.gauge("autogrow.cum_flops")

    # ------------------------------------------------------------------
    def set_flops_per_step(self, flops_per_step: float) -> None:
        """Switch the per-step FLOPs increment — e.g. to the measured
        number the cost pass (:mod:`repro_torch.obs.costs`) counted in one
        train step.

        Replay determinism survives the switch: ``cum_flops`` already
        accumulated is untouched, :meth:`snapshot`/:meth:`restore` carry
        it verbatim, and a resumed run re-measures the same step (same
        number) before recording its first step — so the resumed stream
        is identical to the uninterrupted one.
        """
        self.flops_per_step = float(flops_per_step)

    def record(self, step: int, loss: float) -> None:
        loss = float(loss)
        self._ema = (loss if self._ema is None
                     else (1.0 - self._alpha) * self._ema
                     + self._alpha * loss)
        self.cum_flops += self.flops_per_step
        self.cum_tokens += self.tokens_per_step
        self.total_steps += 1
        self._ring.append((int(step), loss, self._ema, self.cum_flops))
        r = self.rpf()
        if r is not None and r > self.peak_rpf:
            self.peak_rpf = r
        self._g_loss.set(loss)
        self._g_ema.set(self._ema)
        self._g_flops.set(self.cum_flops)
        if r is not None:
            self._g_rpf.set(r)
            self._g_peak.set(self.peak_rpf)

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def full(self) -> bool:
        return len(self._ring) == self.window

    @property
    def loss_ema(self) -> Optional[float]:
        return self._ema

    @property
    def last_loss(self) -> Optional[float]:
        return self._ring[-1][1] if self._ring else None

    # ------------------------------------------------------------------
    def improvement(self) -> Optional[float]:
        """Relative EMA-loss drop across the ring window (None until full).

        ``(ema_oldest - ema_newest) / max(|ema_oldest|, eps)`` — positive
        while the stage is still learning, ~0 at a plateau, negative when
        diverging.
        """
        if not self.full:
            return None
        e0, e1 = self._ring[0][2], self._ring[-1][2]
        return (e0 - e1) / max(abs(e0), 1e-12)

    def rpf(self) -> Optional[float]:
        """Return-per-FLOP: ``-d(EMA loss)/d(FLOPs)`` over the ring.

        Least-squares slope of the EMA against cumulative FLOPs (falls back
        to the step axis when no FLOP model was given). None until the ring
        holds at least 4 points.
        """
        n = len(self._ring)
        if n < 4:
            return None
        if self.flops_per_step > 0:
            xs = [row[3] for row in self._ring]
        else:
            xs = [float(row[0]) for row in self._ring]
        ys = [row[2] for row in self._ring]
        mx = sum(xs) / n
        my = sum(ys) / n
        sxx = sum((x - mx) ** 2 for x in xs)
        if sxx <= 0.0:
            return None
        sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
        return -(sxy / sxx)

    def rpf_decay(self) -> Optional[float]:
        """Current rpf as a fraction of the running peak (None before any
        peak exists); the Stacking-style trigger fires when this decays."""
        r = self.rpf()
        if r is None or self.peak_rpf <= 0.0:
            return None
        return r / self.peak_rpf

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict:
        """JSON-safe state for checkpoint meta (see module docstring)."""
        return {
            "window": self.window,
            "ema_halflife": self.ema_halflife,
            "ema": self._ema,
            "total_steps": self.total_steps,
            "cum_flops": self.cum_flops,
            "cum_tokens": self.cum_tokens,
            "peak_rpf": self.peak_rpf,
            "ring": [[s, l, e, f] for (s, l, e, f) in self._ring],
        }

    @classmethod
    def restore(cls, state: Dict, *, flops_per_step: float = 0.0,
                tokens_per_step: float = 0.0) -> "Telemetry":
        t = cls(window=int(state["window"]),
                flops_per_step=flops_per_step,
                tokens_per_step=tokens_per_step,
                ema_halflife=float(state.get("ema_halflife", 8.0)))
        t._ema = state.get("ema")
        t.total_steps = int(state.get("total_steps", 0))
        t.cum_flops = float(state.get("cum_flops", 0.0))
        t.cum_tokens = float(state.get("cum_tokens", 0.0))
        t.peak_rpf = float(state.get("peak_rpf", 0.0))
        for row in state.get("ring", []):
            t._ring.append((int(row[0]), float(row[1]), float(row[2]),
                            float(row[3])))
        return t
