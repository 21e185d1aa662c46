"""The LiGO phase: ``repro_torch.core.grow.train_ligo``, SGD with momentum
on the growth operator through the target model, as ``grow()`` drives it.

Set-up hands the program the seeded source tree, operator and batches,
builds the growth plan, and drives the phase's first calls
(``first_calls`` steps each) through the same ``train_ligo`` call and
feed the window uses; what they return is what the judge compares. The
window is one further ``train_ligo`` call of as many steps as fill the
run's seconds at the warm step's time, momentum carried through it.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List, Tuple

from perfbench import corpus, flops, weights
from perfbench.harness import sync
from perfbench.reference import steps as reference_steps


class Entry:
    def __init__(self, cell, seed: int, device, clock):
        from repro_torch.core.plan import plan_for
        from repro_torch.kernels import ops
        self.cell, self.device = cell, device
        w = cell.workload
        self.lr, self.momentum = w["lr"], w["momentum"]
        g1, g2 = cell.source_geom, cell.geom
        self.cfg1, self.cfg2 = cell.port_config(g1), cell.port_config(g2)
        self.small = weights.params(g1, seed, device)
        op0 = weights.operator(g1, g2, seed, device)
        pool = corpus.batches(cell.traffic, g2["vocab"],
                              weights.sub_seed(seed, "data"), device)
        self.feed = itertools.cycle(pool)
        self.tokens_per_step = cell.traffic["rows"] * cell.traffic["seq"]
        self.step_ops = (flops.model_step_ops(g2, cell.traffic["rows"],
                                              cell.traffic["seq"])
                         + flops.grow_step_ops(g1, g2))
        clock.mark("weights")
        plan_for(self.cfg1, self.cfg2, self.small)
        clock.mark("plan")
        self._ops = ops
        launches0 = ops.launch_counts()
        op, losses, step_ms, first = op0, [], [], None
        for j, n in enumerate(w["first_calls"]):
            op, ls, ms = self._call(op, n)
            losses += ls
            step_ms += ms
            if first is None:
                first = op
            clock.mark(f"first_call_{j + 1}")
        self.first_launches = self._per_step(launches0, sum(w["first_calls"]))
        self.op = op
        self.warm_step_s = step_ms[-1] / 1e3
        flat0, flat1 = weights.flatten(op0), weights.flatten(first)
        flat3 = weights.flatten(op)
        self.readings = {
            "losses": losses,
            "grad1": {k: float(((flat0[k].double() - flat1[k].double())
                                / self.lr).norm()) for k in flat0},
            "change": {k: float((flat3[k].double() - flat0[k].double())
                                .norm()) for k in flat0}}
        del op0, first, flat0, flat1, flat3
        clock.mark("readings")

    def _call(self, op, n: int) -> Tuple[Dict, List[float], List[float]]:
        from repro_torch.core.grow import train_ligo
        ms: List[float] = []
        op, losses = train_ligo(op, self.small, self.cfg1, self.cfg2,
                                self.feed, steps=n, lr=self.lr,
                                momentum=self.momentum, step_ms=ms)
        return op, losses, ms

    def _per_step(self, before: Dict[str, int], n: int) -> Dict[str, float]:
        after = self._ops.launch_counts()
        return {"k1": (after["ligo_blend_expand_grouped"]
                       - before["ligo_blend_expand_grouped"]) / n,
                "k2": (after["ligo_blend_expand_bwd_fused"]
                       - before["ligo_blend_expand_bwd_fused"]) / n}

    def window(self, n: int) -> Tuple[float, List[float]]:
        """``n`` steps in one call; (host seconds, losses)."""
        before = self._ops.launch_counts()
        sync(self.device)
        t0 = time.perf_counter()
        op, self.op = self.op, None
        self.op, losses, _ = self._call(op, n)
        sync(self.device)
        wall = time.perf_counter() - t0
        self.window_launches = self._per_step(before, n)
        return wall, losses

    def checks(self) -> Dict[str, Dict]:
        """K1 and K2 launched on every step of the first calls and of the
        window (the kernel route), read from the program's counters."""
        if self.device.type != "cuda":
            return {}
        least = min(self.first_launches["k1"], self.first_launches["k2"],
                    self.window_launches["k1"], self.window_launches["k2"])
        return {"k1_k2_launches_per_step": {"value": least, "limit": 1,
                                            "rule": ">="}}

    def release(self) -> None:
        self.small = self.op = self.feed = None


def reference(cell, seed: int, device, *, precision: str = "float32",
              rows=None) -> Dict:
    return reference_steps.ligo_readings(
        cell.config["reference"], cell.source_geom, cell.geom, cell.traffic,
        cell.workload, seed, device, precision=precision, rows=rows)
