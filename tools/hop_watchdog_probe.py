#!/usr/bin/env python3
"""What a live hop's grow costs against the watchdog's budget, on the card.

    PYTHONPATH=src python3 tools/hop_watchdog_probe.py [--reps 5]

Runs the scenario of ``tests/test_torch_gpu.py::
test_kernel_route_hop_spans_and_profile_name_k1_and_k3`` ``--reps`` times
under the profiler (``obs.profile``) and as many times without it: a
2-layer gpt2 engine (3 slots, 9 requests, paged) hops to a 4-layer,
384-wide model with a background grow begun at decode step 3, after
``HopController.warm`` (its grow in the engine thread) and, for a
comparison, after a warm grow in a thread of its own that the engine
thread waits for, as the live grow runs in a thread of its own. Each run
prints warm's wall, the budget it seeded,
the grow span's wall in the grow thread (``hop.grow``), the wall from the
launch to the poll that found the grow done (what the watchdog judges),
the attempts, any ``hop.watchdog_fire`` event, and the engine's step walls
while the grow ran, and the first live grow's wall in parts: the grow
thread's start after the launch, its Python (this thread's CPU time, and
the rest of that wall, which it spent waiting, on the interpreter lock
above all), its wait for the device, the device's span of the grow's work
(CUDA events), and the wait from the thread's end to the poll that found
the grow done; medians and maxima of each part over the runs follow.

Then ``--reps`` grows each way, with the profiler on and off: in the
calling thread; in a fresh thread while the calling thread waits in
``join`` (idle, the interpreter lock free); and in a fresh thread while the
calling thread runs Python without pause (the busiest the engine's
decode loop can keep the interpreter lock); with the K1 launches a grow
makes. Needs one CUDA card.
"""
import argparse
import os
import statistics
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

ENGINE_CFG = {"n_layers": 2, "d_model": 256, "n_heads": 4, "n_kv_heads": 4,
              "d_head": 64, "d_ff": 512, "vocab_size": 512, "max_seq": 256}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="'cpu' for a rehearsal (no kernels, no card)")
    args = ap.parse_args()
    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("hop_watchdog_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core import init_ligo_params
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.serve import live_prompts
    from repro_torch.models.model import init_params
    from repro_torch.core.plan import plan_for
    from repro_torch.serving import HopController, ServingEngine
    from repro_torch.tree import tree_leaves
    if dev.type == "cuda":
        _build.build()
    cfg = get_config("gpt2-base").scaled(name="gpt2-engine", **ENGINE_CFG)
    cfg2 = cfg.scaled(name="gpt2-engine-grown", n_layers=4, d_model=384,
                      n_heads=6, n_kv_heads=6, d_ff=768)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    op = init_ligo_params(torch.Generator(dev).manual_seed(1), cfg, cfg2,
                          device=dev)
    print(f"[probe] sys.getswitchinterval() {sys.getswitchinterval()} s")

    def warm_in_own_thread(hop):
        """``HopController.warm`` with its grow in a fresh thread that the
        engine thread joins, where a background hop's live grow runs."""
        hop._build_kernels()
        t0 = time.perf_counter()
        th = threading.Thread(target=hop._grow_once, name="hop-warm")
        th.start()
        th.join()
        dt = time.perf_counter() - t0
        hop.watchdog.seed(dt)
        return dt

    def timed_grow(hop, parts):
        """``HopController._grow_once`` with its wall cut into parts, in
        the thread that runs it: the Python that plans and launches the
        grow (wall and this thread's CPU time: the rest of that wall is
        time the thread waited, on the interpreter lock above all), the
        wait for the device, and the device's span of the grow's work
        (CUDA events on the side stream, from its first launch to its
        last)."""
        eng = hop.engine
        t0, c0 = time.perf_counter(), time.thread_time()
        with torch.no_grad(), hop._side():
            if hop._cuda:
                hop._side_stream.wait_stream(hop._main_stream)
                start = torch.cuda.Event(enable_timing=True)
                start.record(hop._side_stream)
            plan = plan_for(eng.cfg, hop.cfg2, eng.params)
            grown = plan.apply(hop.ligo, eng.params,
                               use_kernel=eng.use_kernel,
                               cache=hop._grow_cache)
            t1, c1 = time.perf_counter(), time.thread_time()
            if hop._cuda:
                done = torch.cuda.Event(enable_timing=True)
                done.record(hop._side_stream)
                done.synchronize()
        t2 = time.perf_counter()
        if hop._cuda:
            for leaf in tree_leaves(grown):
                leaf.record_stream(hop._main_stream)
        parts.append({"start": t0, "end": time.perf_counter(),
                      "py_ms": (t1 - t0) * 1e3, "py_cpu_ms": (c1 - c0) * 1e3,
                      "sync_ms": (t2 - t1) * 1e3,
                      "device_ms": (start.elapsed_time(done)
                                    if hop._cuda else float("nan"))})
        return grown

    def scenario(profiled: bool, in_engine: bool, *, tmp: str):
        obs.set_enabled(True)
        obs.FLIGHT.clear()
        eng = ServingEngine(params, cfg, slots=3, prompt_budget=32,
                            gen_budget=16, kv_layout="paged", device=dev)
        for p in live_prompts(9, 32, cfg.vocab_size):
            eng.submit(p, max_new=16)
        walls, found = [], {}
        with obs.profile(tmp if profiled else None, device=dev):
            hop = HopController(eng, cfg2, op, background=True)
            warm_s = hop.warm() if in_engine else warm_in_own_thread(hop)
            parts = []
            hop._grow_once = lambda: timed_grow(hop, parts)
            budget = hop.watchdog.budget()
            last = [time.perf_counter()]
            observe = hop.watchdog.observe

            def observed(dt):            # the elapsed the watchdog judged
                found.setdefault("elapsed", dt)
                found.setdefault("at", time.perf_counter())
                observe(dt)
            hop.watchdog.observe = observed

            def on_step(e):
                now = time.perf_counter()
                if hop.attempts and not hop.completed:
                    walls.append((now - last[0]) * 1e3)
                if e.decode_steps >= 3 and hop.attempts == 0:
                    hop.begin()
                if hop.attempts:
                    hop.poll()
                last[0] = time.perf_counter()
            eng.run(on_step=on_step)
            while not hop.poll():
                time.sleep(0.002)
        grows = [(s["attrs"].get("attempt"), s["thread"], s["dur_ms"])
                 for s in obs.FLIGHT.events(type="span")
                 if s["name"] == "hop.grow"]
        fires = [e["attrs"] for e in obs.FLIGHT.events(type="event")
                 if e["name"] == "hop.watchdog_fire"]
        # the first live grow's wall, launch to found, in parts: the
        # thread's start, its Python (CPU / waiting), the device wait, and
        # the poll that found it after the thread ended
        br = {}
        if parts and "at" in found:
            g = parts[0]
            launch = found["at"] - found["elapsed"]
            br = {"start_ms": (g["start"] - launch) * 1e3,
                  "py_cpu_ms": g["py_cpu_ms"],
                  "py_wait_ms": g["py_ms"] - g["py_cpu_ms"],
                  "sync_ms": g["sync_ms"], "device_ms": g["device_ms"],
                  "found_ms": (found["at"] - g["end"]) * 1e3}
            breakdowns.append(br)
        print(f"[probe] {'profiled' if profiled else 'plain   '}, warm in "
              f"{'the engine thread' if in_engine else 'its own thread'}: warm "
              f"{warm_s * 1e3:.2f} ms, budget {budget:.3f} s | attempts "
              f"{hop.attempts}, completed {hop.completed} | hop.grow spans "
              f"(attempt, thread, ms) {grows} | launch-to-found "
              f"{found.get('elapsed', float('nan')) * 1e3:.2f} ms | "
              f"watchdog fires {fires} | first live grow's parts, ms "
              f"{ {k: round(v, 2) for k, v in br.items()} } | "
              f"engine step walls while the grow ran, ms "
              f"{[round(w, 2) for w in walls]}", flush=True)
        return warm_s, grows, fires

    modes = [(p, o) for o in (True, False) for p in (True, False)]
    results = {m: [] for m in modes}
    breakdowns = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.reps):
            for m in modes:
                results[m].append(scenario(*m, tmp=tmp))
        for (profiled, in_engine), rs in results.items():
            first = [g[0][2] for _, g, _ in rs if g]
            print(f"[probe] {'profiled' if profiled else 'plain'}, warm in "
                  f"{'the engine thread' if in_engine else 'its own thread'}"
                  f": warm ms "
                  f"median {statistics.median(r[0] for r in rs) * 1e3:.2f}; "
                  f"first grow span ms {[round(x, 2) for x in first]}; runs "
                  f"with a watchdog fire {sum(1 for r in rs if r[2])} of "
                  f"{len(rs)}", flush=True)

        for key in ("start_ms", "py_cpu_ms", "py_wait_ms", "sync_ms",
                    "device_ms", "found_ms"):
            vals = sorted(b[key] for b in breakdowns)
            if vals:
                print(f"[probe] first live grows' {key}: median "
                      f"{statistics.median(vals):.2f}, max {vals[-1]:.2f} "
                      f"(of {len(vals)})", flush=True)

        # one grow at a time: in the calling thread; in a fresh thread the
        # calling thread waits for idle (join); in a fresh thread beside a
        # calling thread that keeps running Python, as the decode loop does
        eng = ServingEngine(params, cfg, slots=3, prompt_budget=32,
                            gen_budget=16, kv_layout="paged", device=dev)
        hop = HopController(eng, cfg2, op, background=True)
        modes = ("calling thread", "fresh thread, caller idle",
                 "fresh thread, caller busy")
        walls = {(m, p): [] for m in modes for p in (True, False)}
        hop.warm()
        for profiled in (True, False):
            with obs.profile(tmp if profiled else None, device=dev):
                for _ in range(args.reps):
                    for where in modes:
                        k1 = ops.launch_counts()["ligo_blend_expand_grouped"]
                        t0 = time.perf_counter()
                        if where == "calling thread":
                            hop._grow_once()
                        else:
                            th = threading.Thread(target=hop._grow_once)
                            th.start()
                            if where.endswith("busy"):
                                while th.is_alive():
                                    pass
                            th.join(timeout=60)
                        walls[(where, profiled)].append(
                            (time.perf_counter() - t0) * 1e3)
                        n = (ops.launch_counts()["ligo_blend_expand_grouped"]
                             - k1)
        for (where, profiled), ws in walls.items():
            print(f"[probe] one grow, {where}, "
                  f"{'profiled' if profiled else 'plain'}: ms "
                  f"{[round(w, 2) for w in ws]} (median "
                  f"{statistics.median(ws):.2f}; {n} K1 launches a grow)",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
