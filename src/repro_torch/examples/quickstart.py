"""Quickstart: the LiGO pipeline in one file (the twin of the JAX
package's ``examples/quickstart.py``, step for step).

Pretrains a small transformer on the synthetic corpus, *learns* the growth
operator with 50 SGD steps (paper §3.2), grows to a 2× deeper and wider
model, and compares the grown initialisation against from-scratch and
StackBERT (bert2BERT) before a short finetune.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

``--small-steps``, ``--ligo-steps`` and ``--finetune-steps`` cut the step
counts (300, 50 and 100 by default). ``main`` returns the losses it
prints.
"""
from __future__ import annotations

import argparse
import itertools
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import grow
from repro_torch.data import batch_for_step, optimal_loss
from repro_torch.device import resolve_device
from repro_torch.models.losses import loss_fn
from repro_torch.models.model import init_params
from repro_torch.optim import adamw_init
from repro_torch.training import make_train_step, to_device

SMALL = ModelConfig(name="qs-small", family="dense", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=4, d_head=16, d_ff=256,
                    vocab_size=256, rope="rope", act="gelu", norm="layer",
                    dtype="float32", objective="clm", max_seq=128)
BIG = SMALL.scaled(name="qs-big", n_layers=4, d_model=128, n_heads=8,
                   d_head=16, d_ff=512)

BATCH, SEQ = 32, 64


def batches(cfg, start=0, seed=0, device="cuda"):
    for s in itertools.count(start):
        yield to_device(batch_for_step(cfg, s, BATCH, SEQ, seed=seed), device)


def train(cfg, params, steps, lr=3e-3, device="cuda"):
    """``steps`` AdamW steps; returns (params, last loss or None)."""
    tcfg = TrainConfig(steps=steps, warmup_steps=max(steps // 10, 1), lr=lr)
    opt = adamw_init(params)
    step = make_train_step(cfg, tcfg)
    it = batches(cfg, seed=1, device=device)
    loss = None
    for i in range(steps):
        params, opt, m = step(params, opt, next(it), i)
        loss = float(m["total"])
    return params, loss


@torch.no_grad()
def eval_loss(cfg, params, device="cuda"):
    b = next(batches(cfg, start=10_000_000, seed=99, device=device))
    return float(loss_fn(params, cfg, b)[0])


def grown_inits(small, device="cuda", ligo_steps=50) -> Dict:
    """The three big-model initialisations, and the LiGO phase's losses."""
    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)
    inits = {}
    with torch.no_grad():
        inits["scratch"] = init_params(BIG, gen(1), device=device)
    inits["stackbert"], _ = grow(small, SMALL, BIG, method="bert2bert",
                                 gen=gen(2))
    inits["ligo"], info = grow(small, SMALL, BIG, method="ligo", gen=gen(3),
                               data_it=batches(SMALL, 500_000,
                                               device=device),
                               ligo_steps=ligo_steps, ligo_lr=3e-3)
    return inits, info.get("ligo_losses", [])


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small-steps", type=int, default=300)
    ap.add_argument("--ligo-steps", type=int, default=50)
    ap.add_argument("--finetune-steps", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for explicitly")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out: Dict = {}

    print(f"corpus entropy floor ≈ {optimal_loss(256):.3f} nats")
    print(f"1) pretraining the small model (2L×64d) on {dev}...")
    with torch.no_grad():
        small = init_params(SMALL, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    small, loss = train(SMALL, small, args.small_steps, device=dev)
    out["small_loss"] = loss
    print(f"   small model loss: {loss:.3f}")

    print("2) growing to 4L×128d ...")
    inits, ligo_losses = grown_inits(small, dev, args.ligo_steps)
    out["ligo_losses"] = ligo_losses
    if ligo_losses:
        print(f"   LiGO operator loss: {ligo_losses[0]:.3f} -> "
              f"{ligo_losses[-1]:.3f} ({len(ligo_losses)} steps)")

    print("3) initial big-model loss (before any big-model training):")
    out["initial"] = {}
    for name, p in inits.items():
        out["initial"][name] = eval_loss(BIG, p, dev)
        print(f"   {name:10s} {out['initial'][name]:.3f}")

    print(f"4) finetuning each for {args.finetune_steps} steps:")
    out["finetuned"] = {}
    for name, p in inits.items():
        _, l = train(BIG, p, args.finetune_steps, device=dev)
        out["finetuned"][name] = l
        if l is not None:
            print(f"   {name:10s} {l:.3f}")
    print("LiGO should start (and stay) ahead.")
    return out


if __name__ == "__main__":
    main()
