"""Training of the grown model: ``repro_torch.training.trainer.
make_train_step``, AdamW with the launcher's ``TrainConfig`` (per-layer
activation checkpointing, global-norm clipping), on the target model.

Set-up hands the program the seeded parameters, builds the step, and
drives its first ``first_steps`` steps through the same step function and
feed the window uses: the state they leave is the one the window goes on
from. The window runs as many further steps as fill the run's seconds at
the warm step's time, each step's loss kept on the device until the
window closes.
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
        from repro_torch.configs.base import TrainConfig
        from repro_torch.optim import adamw_init
        from repro_torch.training.trainer import make_train_step
        self.cell, self.device, self.seed = cell, device, seed
        geom = cell.geom
        w = cell.workload
        opt = w["optimizer"]
        self.b1 = opt["b1"]
        self.cfg = cell.port_config(geom)
        tcfg = TrainConfig(seq_len=cell.traffic["seq"],
                           global_batch=cell.traffic["rows"],
                           steps=opt["total_steps"],
                           warmup_steps=opt["warmup_steps"], lr=opt["lr"],
                           end_lr_frac=opt["end_lr_frac"],
                           weight_decay=opt["weight_decay"], b1=opt["b1"],
                           b2=opt["b2"], grad_clip=opt["grad_clip"],
                           remat=w["remat"])
        if opt["eps"] != 1e-8:
            raise ValueError("the program's AdamW takes eps 1e-8")
        params = weights.params(geom, seed, device)
        state = adamw_init(params)
        pool = corpus.batches(cell.traffic, geom["vocab"],
                              weights.sub_seed(seed, "data"), device)
        self.feed = itertools.cycle(pool)
        self.tokens_per_step = cell.traffic["rows"] * cell.traffic["seq"]
        self.step_ops = flops.model_step_ops(geom, cell.traffic["rows"],
                                             cell.traffic["seq"])
        clock.mark("weights")
        self.step_fn = make_train_step(self.cfg, tcfg)
        self.index = opt["start_step"]
        clock.mark("plan")
        losses, grad1 = [], None
        for j in range(w["first_steps"]):
            sync(device)
            t0 = time.perf_counter()
            params, state, m = self.step_fn(params, state, next(self.feed),
                                            self.index)
            self.index += 1
            losses.append(float(m["loss"]))
            self.warm_step_s = time.perf_counter() - t0
            clock.mark(f"first_step_{j + 1}")
            if grad1 is None:
                grad1 = {k: float((v.double() / (1 - self.b1)).norm())
                         for k, v in weights.flatten(state.m).items()}
        self.params, self.state = params, state
        p0 = weights.flatten(weights.params(geom, seed, device))
        change = {k: float((v.double() - p0[k].double()).norm())
                  for k, v in weights.flatten(params).items()}
        del p0
        self.readings = {"losses": losses, "grad1": grad1, "change": change}
        clock.mark("readings")

    def window(self, n: int) -> Tuple[float, List[float]]:
        """``n`` steps; (host seconds, losses)."""
        sync(self.device)
        t0 = time.perf_counter()
        losses = []
        p, s = self.params, self.state
        self.params = self.state = None      # no second copy of the state
        for _ in range(n):
            p, s, m = self.step_fn(p, s, next(self.feed), self.index)
            self.index += 1
            losses.append(m["loss"])
        sync(self.device)
        wall = time.perf_counter() - t0
        self.params, self.state = p, s
        return wall, [float(x) for x in losses]

    def checks(self) -> Dict[str, Dict]:
        return {}

    def release(self) -> None:
        self.params = self.state = self.feed = None


def reference(cell, seed: int, device, *, precision: str = "float32",
              rows=None) -> Dict:
    return reference_steps.train_readings(
        cell.config["reference"], cell.geom, cell.traffic, cell.workload,
        seed, device, precision=precision, rows=rows)
