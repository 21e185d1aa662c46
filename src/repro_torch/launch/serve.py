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

The sequence-mixer families (xlstm-125m, zamba2-2.7b) serve on this
lock-step path, at the prompt's own length, hot-grown or not::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --grow-to 2x --batch 2 --prompt-len 1024 --gen 4

So does the VLM (qwen2-vl-72b), with the JAX launcher's inputs
(:func:`lockstep_batch`: zero patch embeddings in place of the first
tokens, M-RoPE positions counting on all three streams)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-72b \
        --smoke --grow-to 2x --device cpu

An encoder-only model (hubert-xlarge) has no decode step and is refused,
as the JAX launcher refuses it.

and through the live engine below with ``--live-grow-at``.

``--ckpt DIR`` serves the newest checkpoint in DIR (the ``params`` of a
trainer or trajectory checkpoint, or a bare parameter tree) in place of
the random init, e.g. the end of a trajectory::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-medium \\
        --ckpt ckpt --batch 8 --prompt-len 128 --gen 32

The run reports hot-grow ms, prefill ms, decode tok/s and the K1 and K3
launches.

**Zero-downtime live growth**: ``--live-grow-at N`` serves through the
continuous-batching engine (``repro_torch.serving``) and hops to the
``--grow-to`` target after N decode steps *while serving*: the grown params
materialise double-buffered (through K1, on a side stream of a background
thread unless ``--hop-sync``), live sessions' KV caches migrate (in place
when the operator is lossless, ``--hop-operator lemon`` or ``upcycle``;
re-prefilled through K3 otherwise) and the buffers swap between decode
steps. ``--hop-operator upcycle`` hops a dense model to its MoE twin
(``moe_target``: 4 experts, top 2). A failed
hop (inject one with ``--fail-at-hop grow|cache-grow|swap|hang``) rolls
back and retries with backoff; admitted requests never drop either way::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-base \\
        --grow-to gpt2-medium --live-grow-at 8 --batch 8 --requests 16 \\
        --prompt-len 128 --gen 32

The live path serves the recurrent families too (xlstm-125m, zamba2-2.7b):
each request prefills at its true length into its slot's row of the
dense recurrent state, the hop re-prefills every live history, and the
report prints the state's bytes a slot, recurrent and attention, in place
of the paged-KV line::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
        --grow-to 2x --live-grow-at 8 --batch 8 --requests 16 \
        --prompt-len 64 --gen 16

There ``--speculative``, ``--cache-mode grow`` and ``--cache-mode replay``
are refused: a recurrent state cannot be rolled back by position, grown in
place, or replayed layer by layer.

``--speculative K`` keeps the pre-hop model resident after the live hop as
a drafter: each round it drafts K tokens a slot and the grown model
verifies them (greedy output bit-equal to vanilla greedy); the run prints
the ``[spec]`` acceptance line::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-base \
        --grow-to gpt2-medium --live-grow-at 8 --speculative 4 --batch 8 \
        --requests 16 --prompt-len 128 --gen 32

Observability, as in the JAX launcher: ``--obs-log FILE`` streams every
span and event as JSONL (the final metric snapshot closes it; a hop
rollback's flight-recorder dump lands beside it), ``--obs-report`` prints
the summary at exit (decode step p50/p99 through the hop, request
latencies, pool pressure, per-hop-stage walls), ``--obs-profile DIR``
runs the serve under ``torch.profiler`` (CUDA activity on the card) and
writes its Chrome trace into DIR, ``--timeline FILE`` exports the span
tree (and the ledger's track with ``--ledger``) as Chrome trace-event
JSON, and ``--metrics-port N`` serves the registry at ``GET /metrics`` on
127.0.0.1 (0 binds an ephemeral port; ``main`` returns the server as
``metrics_server``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-base \
        --grow-to gpt2-medium --live-grow-at 8 --batch 8 --requests 16 \
        --prompt-len 128 --gen 32 --obs-log obs/run.jsonl --obs-report \
        --timeline obs/trace.json --metrics-port 0

Runs on CUDA unless ``--device cpu`` is given, and raises when there is no
CUDA device and no ``--device cpu``. Meshes come with a later slice.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import (get_config, grow_target, moe_target,
                                 smoke_config)
from repro_torch.core import compose_chain, init_ligo_params, plan_for
from repro_torch.data import gen_tokens
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, ops
from repro_torch.launch import _obs
from repro_torch.models.model import decode_step, init_params, prefill


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lockstep_batch(cfg, tokens: torch.Tensor, start: int = 0
                   ) -> Dict[str, torch.Tensor]:
    """The lock-step path's batch for ``tokens`` (B, T) at positions
    ``start`` .. ``start + T - 1``, as the JAX launcher's ``_serve`` makes
    it: the tokens alone, and for a VLM their M-RoPE ``positions`` (B, T,
    3), the same on all three streams, and on the prefill (``start`` 0)
    ``patch_embeds`` of float32 zeros (B, min(num_patches, T), d_model) in
    place of the first token embeddings. A decode step ``i`` is at
    ``start = prompt_len + i``."""
    batch = {"tokens": tokens}
    if cfg.modality == "vlm":
        B, T = tokens.shape
        pos = torch.arange(start, start + T, dtype=torch.int32,
                           device=tokens.device)
        batch["positions"] = pos[None, :, None].expand(B, T, 3).contiguous()
        if start == 0:
            batch["patch_embeds"] = torch.zeros(
                (B, min(cfg.num_patches, T), cfg.d_model),
                dtype=torch.float32, device=tokens.device)
    return batch


def _target_chain(cfg, target: str, *, smoke: bool):
    """Resolve a (possibly multi-hop) ``--grow-to`` spec into a config chain.

    Each comma-separated hop is a registry arch name (smoke-reduced when
    serving in smoke mode), ``"moe"`` (``moe_target`` of the previous hop,
    the dense→MoE upcycling target) or ``"Nx"`` with N a power of two — the
    *cumulative* grow_target multiple relative to the most recent named arch.
    """
    chain, cur, cum = [], cfg, 1
    for tok in target.split(","):
        tok = tok.strip()
        if tok == "moe":                 # dense -> MoE upcycling target
            cur = moe_target(cur)
            cum = 1
        elif tok.endswith("x") and tok[:-1].isdigit():
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
             device="cuda", use_kernel: Optional[bool] = None):
    """Grow ``params`` (cfg) to the ``target`` architecture(s) at startup.

    Multi-hop targets compose their per-hop operators into ONE
    ``cfg → final`` operator applied by a single plan: no intermediate model
    exists. Returns ``(grown_params, final_cfg, info)`` with ``info`` holding
    the operator (``"ligo"``), the apply's wall time (``"ms"``, synchronised,
    kernel build excluded) and the K1 launches it made (``"k1_launches"``).
    ``use_kernel=False`` grows on the plan's plain route (K1 off).
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
    grown = plan_for(cfg, cfg2, params).apply(ligo, params,
                                              use_kernel=use_kernel)
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


def live_prompts(n_req: int, prompt_len: int, vocab: int) -> List[List[int]]:
    """The live path's requests: rows of ``gen_tokens(0, 0, ...)`` cut to
    lengths drawn in ``[max(2, prompt_len // 2), prompt_len]`` from
    ``RandomState(0)``, as the JAX package's live serve makes them."""
    rng = np.random.RandomState(0)
    rows = gen_tokens(0, 0, n_req, prompt_len, vocab)
    out = []
    for r in range(n_req):
        plen = int(rng.randint(max(2, prompt_len // 2), prompt_len + 1))
        out.append([int(t) for t in rows[r, :plen]])
    return out


def _live_operator(args, cfg, dev):
    """(cfg2, operator) of the live hop that ``--hop-operator`` names."""
    from repro_torch.core import compose_chain, init_ligo_params
    if args.hop_operator == "lemon":
        # lossless: double d_ff at fixed d_model, d_head and heads; the grown
        # model is the same function, so the cache grows in place
        # (--grow-to is ignored on this path)
        from repro_torch.core.operators import lemon_operator
        cfg2 = cfg.scaled(name=f"{cfg.name}-ff2", d_ff=cfg.d_ff * 2)
        return cfg2, lemon_operator(cfg, cfg2, device=dev)
    if args.hop_operator == "upcycle":
        # dense -> MoE upcycling: every expert a copy of the dense FFN, the
        # router zero; lossless, so the cache grows in place (attention is
        # untouched by the hop). --grow-to names the MoE target (default:
        # moe_target of the served arch)
        from repro_torch.core.upcycle import upcycle_operator
        if args.grow_to:
            tail = _target_chain(cfg, args.grow_to, smoke=args.smoke)
            if len(tail) != 1:
                raise SystemExit("--hop-operator upcycle takes a single-hop "
                                 "--grow-to target")
            cfg2 = tail[0]
        else:
            cfg2 = moe_target(cfg)
        return cfg2, upcycle_operator(cfg, cfg2, device=dev)
    chain = [cfg] + _target_chain(cfg, args.grow_to or "2x",
                                  smoke=args.smoke)
    ops_ = [init_ligo_params(
        torch.Generator(device=dev).manual_seed(args.seed + 1 + i), a, b,
        device=dev) for i, (a, b) in enumerate(zip(chain[:-1], chain[1:]))]
    return chain[-1], compose_chain(ops_, chain)


def _slot_line(cfg, sizes) -> str:
    return (f"{cfg.name} recurrent {sizes['recurrent'] / 1e6:.3f} MB + "
            f"attention {sizes['attention'] / 1e6:.3f} MB")


def _serve_live(args, cfg, params, dev, *,
                use_kernel: Optional[bool] = None,
                spec_autodisable: bool = True) -> Dict[str, Any]:
    """Engine-backed serving with a mid-serve hop (``--live-grow-at``).
    ``use_kernel=False`` serves on the plain route (K1 and K3 off);
    ``spec_autodisable`` as in :class:`ServingEngine`."""
    from repro_torch.models.model import slot_bytes
    from repro_torch.serving import HopController, ServingEngine
    if cfg.modality != "text":
        raise SystemExit(f"--live-grow-at: {cfg.name} is not a token model")
    cfg2, ligo = _live_operator(args, cfg, dev)
    engine = ServingEngine(params, cfg, slots=args.batch,
                           prompt_budget=args.prompt_len,
                           gen_budget=args.gen,
                           queue_capacity=args.queue_cap,
                           kv_layout=args.kv_layout,
                           block_size=args.block_size,
                           pool_blocks=args.kv_pool_blocks,
                           temperature=args.temperature, top_p=args.top_p,
                           seed=args.seed, spec_k=args.speculative,
                           spec_autodisable=spec_autodisable,
                           use_kernel=use_kernel, device=dev)
    hop = HopController(engine, cfg2, ligo, cache_mode=args.cache_mode,
                        fail_at=args.fail_at_hop, retries=args.hop_retries,
                        timeout=args.hop_timeout,
                        background=not args.hop_sync)
    hop.warm()                     # build the kernels, seed the watchdog
    n_req = args.requests or args.batch * 2
    for prompt in live_prompts(n_req, args.prompt_len, cfg.vocab_size):
        engine.submit(prompt, max_new=args.gen)
    sizes0 = slot_bytes(engine.state["caches"])

    launches0 = ops.launch_counts()
    t0 = time.perf_counter()

    def on_step(eng):
        if eng.decode_steps >= args.live_grow_at and hop.attempts == 0:
            hop.begin()
        if hop.attempts:
            hop.poll()

    engine.run(on_step=on_step)
    if hop.attempts == 0:        # queue drained before the trigger step
        hop.begin()
    while not hop.poll():
        time.sleep(0.002)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    launches = {k: counts[k] - launches0[k] for k in counts}

    c = engine.counts()
    total = sum(len(r.tokens) for r in engine.requests
                if r.status == "done")
    p50, p99 = engine.decode_step_percentiles(50, 99)
    if np.isnan(p50):
        p50 = p99 = 0.0
    print(f"[serve] live-hop serve: arch={cfg.name} -> "
          f"{cfg2.name if hop.completed else cfg.name} slots={args.batch} "
          f"requests={n_req} device={dev}")
    # the layout actually served: the engine falls back from a requested
    # paged layout for windowed configs
    fb = (f" (FALLBACK from requested "
          f"'{engine.kv_layout_requested}': paged KV unsupported for "
          f"family={cfg.family!r}, window={cfg.window})"
          if engine.kv_fallback else "")
    print(f"[serve] kv layout: {engine.kv_layout}{fb}")
    print(f"[serve] {c['done']} done, {c['rejected']} rejected, "
          f"{c['dropped']} dropped | hop "
          f"{'complete' if hop.completed else 'FAILED (gave up)'} "
          f"(cache: {hop.cache_path}, attempts {hop.attempts})")
    print(f"[serve] {total} tokens in {wall:.2f} s | "
          f"{total / max(wall, 1e-9):.1f} tok/s | decode p50 "
          f"{p50:.1f} ms p99 {p99:.1f} ms (through the hop)")
    print(f"[serve] hop stages ms: "
          + ", ".join(f"{k} {v:.1f}" for k, v in hop.timings.items()
                      if v is not None)
          + f" | kernel launches: K1 {launches['ligo_blend_expand_grouped']}"
          f", K3 {launches['flash_attention']} (warm grow excluded)")
    if args.speculative > 0:
        st = engine.spec_stats
        if st.get("rounds"):
            print(f"[spec] acceptance {st['accepted']}/{st['drafted']} "
                  f"drafted ({st['accepted'] / max(1, st['drafted']):.0%}, "
                  f"first round {st.get('first_round_acc', 0.0):.0%}) | "
                  f"K={engine.spec_k} drafter={st.get('drafter')} | est "
                  f"speedup {st.get('est_speedup', 0.0):.2f}x"
                  + (f" | disabled: {st['disabled']}" if st.get("disabled")
                     else ""))
        else:
            print("[spec] acceptance n/a (no speculative rounds ran: "
                  "drafter never adopted or queue drained pre-hop)")
    res: Dict[str, Any] = {"engine": engine, "hop": hop, "cfg2": cfg2,
                           "ligo": ligo, "wall_s": wall,
                           "tok_s": total / max(wall, 1e-9), "p50": p50,
                           "p99": p99, "launches": launches}
    if engine.alloc is None:
        # a dense state: what one slot's row holds, before and after the hop
        res["slot_bytes"] = {"before": sizes0,
                             "after": slot_bytes(engine.state["caches"])}
        print(f"[state] per slot: {_slot_line(cfg, sizes0)}"
              + (f" -> {_slot_line(cfg2, res['slot_bytes']['after'])}"
                 if hop.completed else "")
              + f" (dense, {engine.cap} cache rows)")
    else:
        a = engine.alloc
        pool = engine.state["caches"]["k"]   # (L, n_blocks + 1, bs, KV, dh)
        block_bytes = (2 * pool.shape[0] * int(np.prod(pool.shape[2:]))
                       * pool.element_size())
        dense_bytes = block_bytes // a.block_size * engine.cap
        res.update(peak_blocks=a.peak_blocks,
                   kib_per_slot=a.bytes_per_slot(block_bytes) / 1024,
                   dense_kib_per_slot=dense_bytes / 1024)
        print(f"[paged] peak {a.peak_blocks} blocks | "
              f"{res['kib_per_slot']:.1f} KiB/slot vs "
              f"{res['dense_kib_per_slot']:.1f} KiB/slot dense")
    return res


def _serve(args, use_kernel: Optional[bool] = None,
           spec_autodisable: bool = True) -> Dict[str, Any]:
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
        if args.live_grow_at is not None:
            res.update(_serve_live(args, cfg, params, dev,
                                   use_kernel=use_kernel,
                                   spec_autodisable=spec_autodisable))
            return res
        if args.grow_to:
            params, cfg, info = hot_grow(params, cfg, args.grow_to,
                                         smoke=args.smoke, seed=args.seed + 1,
                                         device=dev, use_kernel=use_kernel)
            res.update(ligo=info["ligo"], hot_grow_ms=info["ms"],
                       k1_launches=info["k1_launches"])
        res["cfg"], res["params"] = cfg, params
        prompts = torch.as_tensor(
            gen_tokens(0, 0, args.batch, args.prompt_len, cfg.vocab_size)
            [:, :args.prompt_len], dtype=torch.long, device=dev)
        max_len = args.prompt_len + args.gen

        _sync(dev)
        t0 = time.perf_counter()
        logits, state = prefill(params, cfg, lockstep_batch(cfg, prompts),
                                max_len=max_len, use_kernel=use_kernel)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        tokens = torch.argmax(logits, dim=-1)[:, None]
        out: List[torch.Tensor] = [tokens]
        step_logits: List[torch.Tensor] = []
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            step, state = decode_step(
                params, cfg, state,
                lockstep_batch(cfg, tokens, args.prompt_len + i))
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
    live = ap.add_argument_group("live path (--live-grow-at)")
    live.add_argument("--live-grow-at", type=int, default=None, metavar="N",
                      help="serve through the continuous-batching engine and "
                           "hop to the --grow-to target after N decode steps "
                           "without stopping: params grow double-buffered in "
                           "the background, live KV caches migrate, buffers "
                           "swap between decode steps")
    live.add_argument("--hop-operator", default="ligo",
                      choices=["ligo", "lemon", "upcycle"],
                      help="ligo: a seeded LiGO operator to the --grow-to "
                           "target (default 2x); lemon: the lossless zero-pad "
                           "d_ff doubling of the served arch (--grow-to "
                           "ignored; the cache grows in place); upcycle: "
                           "dense -> MoE upcycling to the --grow-to MoE "
                           "target (default: the served arch's moe_target), "
                           "function-preserving at a capacity that drops no "
                           "token; the cache grows in place")
    live.add_argument("--hop-sync", action="store_true",
                      help="grow synchronously in the engine thread instead "
                           "of overlapped with decoding")
    live.add_argument("--hop-retries", type=int, default=2)
    live.add_argument("--hop-timeout", type=float, default=120.0,
                      help="hop watchdog hard budget (seconds) for the grow")
    live.add_argument("--fail-at-hop", default=None,
                      choices=["grow", "cache-grow", "swap", "hang"],
                      help="chaos hook: a one-shot failure at this hop stage "
                           "(the hop rolls back, then retries clean; hang "
                           "needs the background grow)")
    live.add_argument("--cache-mode", default="auto",
                      choices=["auto", "grow", "replay", "reprefill"],
                      help="KV-cache migration: auto = in place iff the "
                           "operator is provably lossless, else new-layer "
                           "replay for a depth-append hop, else re-prefill")
    live.add_argument("--temperature", type=float, default=0.0,
                      help="sampling temperature (0 = greedy; a per-request "
                           "Philox chain keyed by --seed)")
    live.add_argument("--top-p", type=float, default=1.0,
                      help="nucleus sampling mass (with --temperature > 0)")
    live.add_argument("--speculative", type=int, default=0, metavar="K",
                      help="after the live hop, keep the pre-hop model "
                           "resident as a drafter: draft K tokens a slot per "
                           "round with the small model, verify them with the "
                           "grown one (greedy output is bit-equal to vanilla "
                           "greedy; drafting stops when the measured speedup "
                           "estimate drops below 1)")
    live.add_argument("--kv-layout", default="paged",
                      choices=["paged", "dense"],
                      help="paged = fixed-size blocks + per-slot page tables "
                           "over a shared pool; dense = one max_len row per "
                           "slot")
    live.add_argument("--kv-pool-blocks", type=int, default=None,
                      help="paged pool size in blocks (default: every slot "
                           "can reach max_len); smaller pools defer "
                           "admissions, never drop them")
    live.add_argument("--block-size", type=int, default=16,
                      help="paged KV block size (tokens per block)")
    live.add_argument("--queue-cap", type=int, default=64)
    live.add_argument("--requests", type=int, default=None,
                      help="requests to serve (default 2x --batch)")
    ap.add_argument("--ledger", default=None, metavar="FILE",
                    help="append the compute ledger to FILE: the hop's "
                         "lifecycle events and the decode step's measured "
                         "FLOPs against 2N a token")
    _obs.add_args(ap, "stream span/event records as JSONL to FILE, closed "
                      "by the final metric snapshot; hop flight-recorder "
                      "dumps land in its directory")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, *,
         use_kernel: Optional[bool] = None,
         spec_autodisable: bool = True) -> Dict[str, Any]:
    """Serve once; returns the results (params, logits, tokens, times; on
    the live path the engine and the hop controller). ``use_kernel=False``
    serves on the plain route, K1 and K3 off, on either path
    (``chip_smoke.py`` holds the kernel route against it);
    ``spec_autodisable=False`` keeps drafting whatever the wall-clock
    speedup estimate says, so that
    speculative rounds are deterministic (``chip_smoke.py`` compares them
    token for token with greedy decoding). With ``--metrics-port`` the
    result's ``metrics_server`` is the running ``/metrics`` server, which
    the caller stops with ``shutdown()``."""
    args = parse_args(argv)
    srv = _obs.start_metrics(args)
    if args.ledger:
        # the serve launcher owns no checkpoint cursor: start the file clean
        obs.attach_ledger(args.ledger).restore(None)
    if args.obs_log:
        obs.attach_jsonl(args.obs_log)
    try:
        with obs.profile(args.obs_profile, device=args.device):
            res = _serve(args, use_kernel, spec_autodisable)
    finally:
        _obs.close(args)
    res["metrics_server"] = srv
    return res


if __name__ == "__main__":
    main()
