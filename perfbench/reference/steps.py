"""The reference's first steps of a cell, and the readings the judge
compares: each step's loss, the norm of every leaf of the first gradient
as the optimizer takes it, and the norm of every leaf's change after the
first steps.

The inputs are made again here from the run's seed, by the benchmark's
own generators (``perfbench.weights``, ``perfbench.corpus``): the same
source weights, operator, parameters and batches the program was handed.
``precision="fp8"`` computes the control; ``rows`` keeps only the first
``rows`` rows of every batch (a fault: half the batch left out).
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import torch

from perfbench import corpus, weights
from perfbench.reference import common

F32 = torch.float32


def family(name: str):
    return importlib.import_module(f"perfbench.reference.{name}")


def _batches(traffic: Dict, vocab: int, seed: int, device, n: int,
             rows: Optional[int]) -> List[Dict]:
    pool = corpus.batches(traffic, vocab, weights.sub_seed(seed, "data"),
                          device)
    out = [pool[i % len(pool)] for i in range(n)]
    if rows is not None:
        out = [{k: v[:rows] for k, v in b.items()} for b in out]
    return out


def ligo_readings(fam_name: str, g1: Dict, g2: Dict, traffic: Dict,
                  work: Dict, seed: int, device, *,
                  precision: str = "float32",
                  rows: Optional[int] = None) -> Dict:
    """The LiGO phase's first calls (``work["first_calls"]`` steps each,
    momentum starting at zero in each call, as every call of the phase
    does): SGD with momentum on the operator alone, the source tree
    frozen."""
    common.strict_float32()
    fam = family(fam_name)
    num = common.Numerics(precision)
    norm = fam.norm(g2)
    small_tree = weights.params(g1, seed, device)
    op0 = weights.flatten(weights.operator(g1, g2, seed, device))
    calls = work["first_calls"]
    batches = _batches(traffic, g2["vocab"], seed, device, sum(calls), rows)
    block = work["reference_block_rows"]
    lr, momentum = work["lr"], work["momentum"]

    def loss_of(leaves, sl, batch):
        big = common.grow(leaves, small_tree, g1, g2, num)
        return common.forward_loss(weights.unflatten(big), g2, batch, num,
                                   norm, fam.mlp, rows=sl)

    op = {k: v.clone() for k, v in op0.items()}
    losses, grad1 = [], None
    i = 0
    for n in calls:
        mom = {k: torch.zeros_like(v) for k, v in op.items()}
        for _ in range(n):
            b = batches[i]
            i += 1
            tokens = b["tokens"].numel()
            loss, g = common.mean_loss_and_grads(
                lambda lv, sl, b=b: loss_of(lv, sl, b), op, b, tokens, block)
            if grad1 is None:
                grad1 = common.leaf_norms(g)
            for k in op:
                mom[k] = momentum * mom[k] + g[k]
                op[k] = op[k] - lr * mom[k]
            losses.append(loss)
            del g
    change = common.leaf_norms({k: op[k].to(torch.float64) - op0[k].to(
        torch.float64) for k in op})
    return {"losses": losses, "grad1": grad1, "change": change}


def train_readings(fam_name: str, geom: Dict, traffic: Dict, work: Dict,
                   seed: int, device, *, precision: str = "float32",
                   rows: Optional[int] = None) -> Dict:
    """The first ``work["first_steps"]`` AdamW steps of the model from
    its seeded parameters, clipped to the global norm, at the schedule's
    rate for each step index."""
    common.strict_float32()
    fam = family(fam_name)
    num = common.Numerics(precision)
    norm = fam.norm(geom)
    opt = work["optimizer"]
    store = weights.dtype_of(geom)
    p = weights.flatten(weights.params(geom, seed, device))
    p0 = {k: v.clone() for k, v in p.items()}
    m = {k: torch.zeros(v.shape, dtype=F32, device=device)
         for k, v in p.items()}
    v2 = {k: torch.zeros(v.shape, dtype=F32, device=device)
          for k, v in p.items()}
    n = work["first_steps"]
    batches = _batches(traffic, geom["vocab"], seed, device, n, rows)
    block = work["reference_block_rows"]
    losses, grad1 = [], None
    for j, b in enumerate(batches):
        leaves = {k: x.to(F32) for k, x in p.items()}
        loss, g = common.mean_loss_and_grads(
            lambda lv, sl, b=b: common.forward_loss(
                weights.unflatten(lv), geom, b, num, norm, fam.mlp, rows=sl),
            leaves, b, b["tokens"].numel(), block)
        del leaves
        lr = common.warmup_cosine(opt["start_step"] + j, opt["lr"],
                                  opt["warmup_steps"], opt["total_steps"],
                                  opt["end_lr_frac"])
        norms = common.adamw(p, g, m, v2, j + 1, lr=lr, b1=opt["b1"],
                             b2=opt["b2"], eps=opt["eps"],
                             wd=opt["weight_decay"], clip=opt["grad_clip"],
                             store_dtype=store)
        if grad1 is None:
            grad1 = norms
        losses.append(loss)
    change = common.leaf_norms({k: p[k].to(torch.float64)
                                - p0[k].to(torch.float64) for k in p})
    return {"losses": losses, "grad1": grad1, "change": change}
