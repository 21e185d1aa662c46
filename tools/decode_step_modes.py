#!/usr/bin/env python3
"""Where the serving engine's decode step spends its host time, on the card.

    PYTHONPATH=src python3 tools/decode_step_modes.py [--arch gpt2-medium]
        [--profile-first]

Times one decode step (host clock around the step, which ends in its
logits' copy to the host; median of 12 steps after one warm step) of:

- the lock-step decode of ``models.model.decode_step`` (int position, the
  dense cache written by slicing), the path ``serve`` without
  ``--live-grow-at`` takes;
- the engine's decode over the paged cache, and over the dense one
  (per-slot positions, writes through ``index_put``);
- the paged engine without the residual stream it keeps for depth-replay
  hops;

with ``torch.use_deterministic_algorithms`` off and on, in turns (off, on,
on, off). ``--profile-first`` runs one ``torch.profiler`` session (CPU and
CUDA activities) before any timing: ``chip_smoke.py`` profiles in its
earlier phases, so its phase 9 times steps in a process that has profiled.
Random weights from seed 0; gpt2 at 8 slots and 128-token prompts,
llama3-8b at 4 slots and 1024-token prompts. Needs one CUDA card.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gpt2-medium")
    ap.add_argument("--profile-first", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode_step_modes: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import live_prompts
    from repro_torch.models.model import decode_step, init_params, prefill
    from repro_torch.serving import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    cfg = get_config(args.arch)
    slots, plen, gen = ((8, 128, 32) if cfg.name.startswith("gpt2")
                        else (4, 1024, 32))
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    if args.profile_first:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(4, device="cuda").sum()
            torch.cuda.synchronize()

    def engine(layout, keep=None, n=12):
        eng = ServingEngine(params, cfg, slots=slots, prompt_budget=plen,
                            gen_budget=gen, kv_layout=layout,
                            keep_residual=keep, device="cuda")
        for p in live_prompts(slots, plen, cfg.vocab_size):
            eng.submit(p, max_new=gen)
        for _ in range(n + 1):          # admissions ride the first step
            eng.step()
        return float(np.median(eng.decode_step_ms()[1:]))

    def lockstep(n=12):
        toks = torch.randint(0, cfg.vocab_size, (slots, plen), device="cuda",
                             generator=torch.Generator("cuda").manual_seed(1))
        out = []
        with torch.no_grad():
            lg, st = prefill(params, cfg, {"tokens": toks},
                             max_len=plen + n + 2)
            t = lg.argmax(-1)[:, None]
            for _ in range(n + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, st = decode_step(params, cfg, st, {"tokens": t})
                t = lg.argmax(-1)[:, None]
                lg.float().cpu()
                out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out[1:]))

    print(f"[modes] {cfg.name}, {slots} slots, prompts of "
          f"{plen // 2}-{plen} tokens (engine) / {plen} (lock-step), "
          f"profiled first: {args.profile_first}", flush=True)
    for det in (False, True, True, False):
        torch.use_deterministic_algorithms(det)
        print(f"[modes] deterministic={det}: decode step ms, lock-step "
              f"{lockstep():.2f} | engine paged {engine('paged'):.2f} | "
              f"engine dense {engine('dense'):.2f} | engine paged without "
              f"the residual stream {engine('paged', keep=False):.2f}",
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
