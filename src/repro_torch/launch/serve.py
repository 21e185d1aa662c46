"""Batched serving: build a model, optionally hot-grow it, prefill a
batch of prompts and decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-base \\
        --grow-to gpt2-medium --batch 8 --prompt-len 128 --gen 32

The model is initialised from ``--seed`` with a ``torch.Generator`` on the
device. ``--grow-to <arch>`` (or ``2x`` for ``grow_target``, or a
comma-separated chain such as ``2x,4x``) grows it once at startup through
the port's GrowthPlan: the LiGO operator comes from ``init_ligo_params``
(seeded ``--seed + 1 + hop``), a chain of hops is composed into one operator
by ``compose_chain``, and every kernel-eligible leaf group runs on kernel K1.
Prefill runs under ``torch.no_grad()``, so on the card each layer's attention
is kernel K3. Without ``--grow-to`` the model is served as initialised, e.g.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --batch 4 --prompt-len 2048 --gen 32

``--ckpt DIR`` serves the newest checkpoint in DIR (the ``params`` of a
trainer or trajectory checkpoint, or a bare parameter tree) in place of
the random init, e.g. the end of a trajectory::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-medium \\
        --ckpt ckpt --batch 8 --prompt-len 128 --gen 32

The run reports hot-grow ms, prefill ms, decode tok/s and the K1 and K3
launches.

Runs on CUDA unless ``--device cpu`` is given, and raises when there is no
CUDA device and no ``--device cpu``. The live engine, meshes,
observability and speculative decoding come with later slices.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import get_config, grow_target, smoke_config
from repro_torch.core import compose_chain, init_ligo_params, plan_for
from repro_torch.data import gen_tokens
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, ops
from repro_torch.models.model import decode_step, init_params, prefill


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _target_chain(cfg, target: str, *, smoke: bool):
    """Resolve a (possibly multi-hop) ``--grow-to`` spec into a config chain.

    Each comma-separated hop is a registry arch name (smoke-reduced when
    serving in smoke mode) or ``"Nx"`` with N a power of two — the
    *cumulative* grow_target multiple relative to the most recent named arch.
    """
    chain, cur, cum = [], cfg, 1
    for tok in target.split(","):
        tok = tok.strip()
        if tok.endswith("x") and tok[:-1].isdigit():
            n = int(tok[:-1])
            if n <= cum or n % cum or ((n // cum) & (n // cum - 1)):
                raise SystemExit(
                    f"--grow-to: '{tok}' after {cum}x — cumulative 'Nx' "
                    f"hops must be increasing powers of two (e.g. 2x,4x)")
            for _ in range((n // cum).bit_length() - 1):
                cur = grow_target(cur)
            cum = n
        else:
            cur = get_config(tok)
            if smoke:
                cur = smoke_config(cur)
            cum = 1
        chain.append(cur)
    return chain


def hot_grow(params, cfg, target: str, *, smoke: bool = False, seed: int = 1,
             device="cuda"):
    """Grow ``params`` (cfg) to the ``target`` architecture(s) at startup.

    Multi-hop targets compose their per-hop operators into ONE
    ``cfg → final`` operator applied by a single plan: no intermediate model
    exists. Returns ``(grown_params, final_cfg, info)`` with ``info`` holding
    the operator (``"ligo"``), the apply's wall time (``"ms"``, synchronised,
    kernel build excluded) and the K1 launches it made (``"k1_launches"``).
    """
    dev = resolve_device(device)
    chain = [cfg] + _target_chain(cfg, target, smoke=smoke)
    ops_ = [init_ligo_params(torch.Generator(device=dev).manual_seed(seed + i),
                             a, b, device=dev)
            for i, (a, b) in enumerate(zip(chain[:-1], chain[1:]))]
    ligo = compose_chain(ops_, chain)
    cfg2 = chain[-1]
    if dev.type == "cuda":
        _build.build()
    launches0 = ops.launch_counts()["ligo_blend_expand_grouped"]
    _sync(dev)
    t0 = time.perf_counter()
    grown = plan_for(cfg, cfg2, params).apply(ligo, params)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    k1 = ops.launch_counts()["ligo_blend_expand_grouped"] - launches0
    hops = ("" if len(ops_) == 1
            else f" via {len(ops_)} composed hops (one plan apply)")
    print(f"[serve] hot-grew {cfg.name} -> {cfg2.name} "
          f"({cfg.n_layers}L/{cfg.d_model}d -> {cfg2.n_layers}L/"
          f"{cfg2.d_model}d) on {dev} in {ms:.1f} ms{hops} | "
          f"K1 launches {k1}")
    return grown, cfg2, {"ligo": ligo, "ms": ms, "k1_launches": k1}


def _restore_ckpt(ckpt_dir: str, cfg, dev):
    """The parameters of the newest checkpoint in ``ckpt_dir``, on ``dev``:
    ``params`` of a ``{"params", "opt"}`` checkpoint (the optimizer state
    is not read into the tree), or a bare parameter tree."""
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step()
    if step is None:
        raise SystemExit(f"--ckpt {ckpt_dir}: no checkpoint found")
    tmpl = init_params(cfg, torch.Generator().manual_seed(0), device="meta")
    try:
        tree, _ = mgr.restore(step, {"params": tmpl}, dev)
        params = tree["params"]
    except KeyError:
        params, _ = mgr.restore(step, tmpl, dev)
    print(f"[serve] restored step-{step} checkpoint from {ckpt_dir} for "
          f"{cfg.name}", flush=True)
    return params


def _serve(args) -> Dict[str, Any]:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    res: Dict[str, Any] = {"device": str(dev)}
    if dev.type == "cuda":
        _build.build()
    launches0 = ops.launch_counts()
    with torch.no_grad():
        if args.ckpt:
            params = _restore_ckpt(args.ckpt, cfg, dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            params = init_params(cfg, gen, device=dev)
        res["small_cfg"], res["small"] = cfg, params
        if args.grow_to:
            params, cfg, info = hot_grow(params, cfg, args.grow_to,
                                         smoke=args.smoke, seed=args.seed + 1,
                                         device=dev)
            res.update(ligo=info["ligo"], hot_grow_ms=info["ms"],
                       k1_launches=info["k1_launches"])
        res["cfg"], res["params"] = cfg, params
        prompts = torch.as_tensor(
            gen_tokens(0, 0, args.batch, args.prompt_len, cfg.vocab_size)
            [:, :args.prompt_len], dtype=torch.long, device=dev)
        max_len = args.prompt_len + args.gen

        _sync(dev)
        t0 = time.perf_counter()
        logits, state = prefill(params, cfg, {"tokens": prompts},
                                max_len=max_len)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        tokens = torch.argmax(logits, dim=-1)[:, None]
        out: List[torch.Tensor] = [tokens]
        step_logits: List[torch.Tensor] = []
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            step, state = decode_step(params, cfg, state, {"tokens": tokens})
            tokens = torch.argmax(step, dim=-1)[:, None]
            out.append(tokens)
            step_logits.append(step)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    tps = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    generated = torch.cat(out, dim=1)
    counts = ops.launch_counts()
    launches = {k: counts[k] - launches0[k] for k in counts}
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} device={dev}")
    print(f"[serve] prefill {t_prefill * 1e3:.1f} ms | decode "
          f"{t_decode * 1e3:.1f} ms | {tps:.1f} tok/s | kernel launches: K1 "
          f"{launches['ligo_blend_expand_grouped']}, K3 "
          f"{launches['flash_attention']}")
    print(f"[serve] sample continuation ids: "
          f"{generated[0, :16].cpu().tolist()}")
    res.update(prompts=prompts, prefill_logits=logits,
               decode_logits=(torch.stack(step_logits) if step_logits
                              else None),
               tokens=generated, prefill_ms=t_prefill * 1e3,
               decode_ms=t_decode * 1e3, decode_tok_s=tps, launches=launches)
    return res


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the smoke-reduced config of --arch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--ckpt", default=None, metavar="DIR",
                    help="serve the newest checkpoint in DIR (its params) "
                         "in place of the random init")
    ap.add_argument("--grow-to", default=None, metavar="ARCH[,ARCH...]",
                    help="hot-grow to this arch (or '2x') at startup; a "
                         "comma-separated chain composes into one operator")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the model init (the LiGO operator of hop i "
                         "uses seed + 1 + i)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for explicitly")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Serve once; returns the results (params, logits, tokens, times)."""
    return _serve(parse_args(argv))


if __name__ == "__main__":
    main()
