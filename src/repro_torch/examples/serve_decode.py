"""Batched serving with decode caches across architecture families (the
twin of the JAX package's ``examples/serve_decode.py``, step for step).

Prefill + greedy decode for a dense GQA model (a linear KV cache), a
sliding-window MoE (a ring-buffer KV cache), an SSM hybrid (SSM states plus
the shared attention block's KV cache) and xLSTM (recurrent matrix and
scalar memories): the cache disciplines of the framework.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu

Each model runs at its ``smoke_config`` with random weights from seed 0.
The prefill's attention takes kernel K3 on the card (its plain version on
the CPU, or with ``use_kernel=False``). ``serve`` and ``main`` return what
they print: the tokens, the logits and the decode state.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ASSIGNED, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import gen_tokens
from repro_torch.device import resolve_device
from repro_torch.models.model import decode_step, init_params, prefill

#: the JAX script's four models, in its order, with the cache each keeps
ARCHS = ("llama3-8b",       # dense GQA: linear KV cache
         "mixtral-8x7b",    # SWA MoE:   ring-buffer KV cache
         "zamba2-2.7b",     # hybrid:    SSM states + shared-attn cache
         "xlstm-125m")      # ssm:       recurrent matrix/scalar memories


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def serve(arch: str, batch: int = 2, prompt_len: int = 48, gen: int = 12, *,
          device="cuda", cfg: Optional[ModelConfig] = None,
          use_kernel: Optional[bool] = None) -> Dict[str, Any]:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens and decode
    ``gen`` tokens greedily; print one line (cache type, decode tok/s, the
    first row's first 8 tokens).

    ``cfg`` replaces ``smoke_config(ASSIGNED[arch])`` (a full-width run);
    ``use_kernel`` as :func:`repro_torch.models.model.prefill`. Returns
    ``tokens`` (batch, gen), ``prefill_logits`` (batch, V),
    ``decode_logits`` (gen - 1, batch, V), the decode ``state``, ``cache``
    (its type name), ``tok_s``, ``prefill_ms`` and the ``cfg``, ``params``
    and ``batch`` it served.
    """
    dev = resolve_device(device)
    cfg = cfg or smoke_config(ASSIGNED[arch])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = torch.as_tensor(
        gen_tokens(0, 0, batch, prompt_len, cfg.vocab_size)[:, :prompt_len],
        dtype=torch.long, device=dev)
    b = {"tokens": prompts}
    if cfg.modality == "vlm":
        b["patch_embeds"] = torch.zeros(
            (batch, min(cfg.num_patches, prompt_len), cfg.d_model),
            dtype=torch.float32, device=dev)
        b["positions"] = torch.as_tensor(
            np.broadcast_to(np.arange(prompt_len)[None, :, None],
                            (batch, prompt_len, 3)).copy(), device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, state = prefill(params, cfg, b, max_len=prompt_len + gen,
                            use_kernel=use_kernel)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    toks = torch.argmax(logits, -1)[:, None]
    t0 = time.perf_counter()
    out, steps = [toks], []
    for i in range(gen - 1):
        db = {"tokens": toks}
        if cfg.modality == "vlm":
            db["positions"] = torch.full((batch, 1, 3), prompt_len + i,
                                         dtype=torch.long, device=dev)
        step, state = decode_step(params, cfg, state, db)
        toks = torch.argmax(step, -1)[:, None]
        out.append(toks)
        steps.append(step)
    _sync(dev)
    dt = time.perf_counter() - t0
    tokens = torch.cat(out, 1)
    cache = type(state["caches"]).__name__
    tok_s = batch * (gen - 1) / max(dt, 1e-9)
    print(f"{arch:20s} cache={cache:5s} {tok_s:7.1f} tok/s  "
          f"sample={tokens[0, :8].cpu().numpy()}", flush=True)
    return {"tokens": tokens, "prefill_logits": logits,
            "decode_logits": (torch.stack(steps) if steps else None),
            "state": state, "cache": cache, "tok_s": tok_s,
            "prefill_ms": prefill_ms, "cfg": cfg, "params": params,
            "batch": b}


def main(argv: Optional[List[str]] = None, *,
         use_kernel: Optional[bool] = None) -> Dict[str, Dict[str, Any]]:
    """Serve the four models as the JAX script does; returns each
    ``serve`` result by arch. ``use_kernel=False`` serves on the plain
    attention route on the card (``chip_smoke.py`` holds the kernel route
    against it)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for explicitly")
    args = ap.parse_args(argv)
    print("arch                 cache        tok/s  sample")
    return {arch: serve(arch, device=args.device, use_kernel=use_kernel)
            for arch in ARCHS}


if __name__ == "__main__":
    main()
