"""Training driver: pretrain a small source model, grow it (LiGO by
default), then train the grown model with AdamW.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-medium \\
        --grow-from gpt2-base --method ligo --pretrain-steps 2 \\
        --ligo-steps 4 --steps 4 --batch 8 --seq 128

    # on the CPU, at smoke size:
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-base \\
        --smoke --grow-from half --device cpu

The twin of the JAX driver's single-arch branch. With ``--grow-from``
(``half`` or an arch name), the source model is initialised from
``--seed``, pretrained for ``--pretrain-steps`` AdamW steps, and grown by
``--method``; for LiGO the operator is first trained for ``--ligo-steps``
SGD-momentum steps through the GrowthPlan, so on the card every eligible leaf
group runs kernel K1 forward and kernel K2 backward on every step. Without
``--grow-from`` the model starts from a random init. Then ``--steps`` AdamW
steps train it. Batches are the synthetic corpus of ``data.batch_for_step``
(seed ``--seed`` for pretraining, ``+1`` for the LiGO phase, ``+10`` for the
main loop), made on the host and copied to the device.

The run prints the source loss, the LiGO losses (first → last), ms per LiGO
step, ms per train step, tokens/s and the K1/K2 launches, and ``main``
returns them. Runs on CUDA unless ``--device cpu`` is given, and raises when
there is no CUDA device and no ``--device cpu``. The trajectory and autogrow
runners, meshes, the supervisor, checkpoints and observability flags come
with later slices.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import (TrainConfig, get_config, half_config,
                                 smoke_config)
from repro_torch.core.grow import grow
from repro_torch.data import batch_for_step
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, ops
from repro_torch.models.model import init_params
from repro_torch.optim import adamw_init
from repro_torch.training import make_train_step, to_device

METHODS = ("ligo", "stackbert", "interpolation", "net2net", "bert2bert",
           "random")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _batches(cfg, batch: int, seq: int, seed: int, dev, start: int = 0):
    step = start
    while True:
        yield to_device(batch_for_step(cfg, step, batch, seq, seed=seed), dev)
        step += 1


def _run_steps(step_fn, params, opt, cfg, args, seed: int, n: int, dev,
               label: str):
    """``n`` timed train steps; returns (params, opt, losses, step ms)."""
    losses: List[float] = []
    times: List[float] = []
    data = _batches(cfg, args.batch, args.seq, seed, dev)
    for i in range(n):
        batch = next(data)
        _sync(dev)
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch, i)
        losses.append(float(m["total"]))
        times.append((time.perf_counter() - t0) * 1e3)
        if i % 20 == 0 or i == n - 1:
            print(f"[train] {label} step {i:5d} loss {losses[-1]:.4f} "
                  f"lr {m['lr']:.2e} gnorm {float(m['grad_norm']):.2f}",
                  flush=True)
    return params, opt, losses, times


def _steady_ms(times: List[float]) -> float:
    """Median step time, leaving out the first step (warm-up) when there
    are others."""
    return statistics.median(times[1:] if len(times) > 1 else times)


def _train(args) -> Dict[str, Any]:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if cfg.objective != "clm":
        raise SystemExit("the train driver runs CLM archs")
    tcfg = TrainConfig(steps=args.steps, warmup_steps=max(args.steps // 20, 5),
                       lr=args.lr, seq_len=args.seq, global_batch=args.batch)
    if dev.type == "cuda":
        _build.build()
    print(f"[train] arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"device={dev}", flush=True)
    res: Dict[str, Any] = {"device": str(dev), "cfg": cfg}
    launches0 = ops.launch_counts()

    if args.grow_from:
        small_cfg = (half_config(cfg) if args.grow_from == "half"
                     else smoke_config(get_config(args.grow_from))
                     if args.smoke else get_config(args.grow_from))
        print(f"[train] pretraining source {small_cfg.name} "
              f"({small_cfg.param_count() / 1e6:.1f}M) for "
              f"{args.pretrain_steps} steps", flush=True)
        with torch.no_grad():
            sp = init_params(small_cfg,
                             torch.Generator(device=dev).manual_seed(args.seed),
                             device=dev)
        sp, _, s_losses, _ = _run_steps(
            make_train_step(small_cfg, tcfg), sp, adamw_init(sp), small_cfg,
            args, args.seed, args.pretrain_steps, dev, "source")
        if s_losses:
            print(f"[train] source loss {s_losses[-1]:.4f}")
        ligo_ms: List[float] = []
        params, info = grow(
            sp, small_cfg, cfg, method=args.method,
            gen=torch.Generator(device=dev).manual_seed(args.seed + 2),
            data_it=_batches(small_cfg, args.batch, args.seq, args.seed + 1,
                             dev),
            ligo_steps=args.ligo_steps, ligo_step_ms=ligo_ms)
        res.update(small_cfg=small_cfg, small=sp, source_losses=s_losses,
                   grow_info=info, ligo_losses=info.get("ligo_losses", []),
                   ligo_step_ms=ligo_ms)
        if ligo_ms:
            ll = info["ligo_losses"]
            print(f"[train] LiGO phase: {ll[0]:.4f} -> {ll[-1]:.4f} "
                  f"({len(ll)} steps) | {_steady_ms(ligo_ms):.1f} ms per "
                  f"LiGO step (median, first step left out)", flush=True)
    else:
        with torch.no_grad():
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(args.seed),
                device=dev)

    params, _, losses, times = _run_steps(
        make_train_step(cfg, tcfg), params, adamw_init(params), cfg, args,
        args.seed + 10, args.steps, dev, "main")
    counts = ops.launch_counts()
    launches = {k: counts[k] - launches0[k] for k in counts}
    res.update(params=params, train_losses=losses, train_step_ms=times,
               launches=launches)
    if times:
        ms = _steady_ms(times)
        res.update(train_ms=ms, tok_s=args.batch * args.seq / (ms / 1e3))
        print(f"[train] {args.steps} steps of {cfg.name}: final loss "
              f"{losses[-1]:.4f} | {ms:.1f} ms per train step (median, first "
              f"step left out) | {res['tok_s']:.0f} tokens/s", flush=True)
    print(f"[train] kernel launches: K1 "
          f"{launches['ligo_blend_expand_grouped']}, K2 "
          f"{launches['ligo_blend_expand_bwd_fused']}, K3 "
          f"{launches['flash_attention']}", flush=True)
    return res


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="train the smoke-reduced config of --arch")
    ap.add_argument("--grow-from", default=None,
                    help="'half' or an arch name: grow instead of cold start")
    ap.add_argument("--method", default="ligo", choices=METHODS)
    ap.add_argument("--ligo-steps", type=int, default=100)
    ap.add_argument("--pretrain-steps", type=int, default=100,
                    help="AdamW steps that pretrain the small source")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for explicitly")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train once; returns the results (trees, losses, times, launches)."""
    return _train(parse_args(argv))


if __name__ == "__main__":
    main()
