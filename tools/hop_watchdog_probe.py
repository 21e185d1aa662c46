#!/usr/bin/env python3
"""What a live hop's grow costs against the watchdog's budget, on the card.

    PYTHONPATH=src python3 tools/hop_watchdog_probe.py [--reps 5]

Runs the scenario of ``tests/test_torch_gpu.py::
test_kernel_route_hop_spans_and_profile_name_k1_and_k3`` ``--reps`` times
under the profiler (``obs.profile``) and as many times without it: a
2-layer gpt2 engine (3 slots, 9 requests, paged) hops to a 4-layer,
384-wide model with a background grow begun at decode step 3, after
``HopController.warm``, which captures the grow into a CUDA graph and
seeds the watchdog with one timed replay; the live grow is one replay.
Each run prints warm's parts (the untimed eager fill, the capture, the
timed replay that seeds), the budget it seeded, the grow span's wall in
the grow thread (``hop.grow``), the wall from the launch to the poll that
found the grow done (what the watchdog judges), the attempts, any
``hop.watchdog_fire`` event, the engine's step walls while the grow ran,
and the first live grow's wall in parts: the grow thread's start after
the launch, its wait for the replay lock, its Python up to the replay's
return (this thread's CPU time, and the rest of that wall, which it spent
waiting, on the interpreter lock above all), its wait for the device, the
device's span of the replay (CUDA events), and the wait from the thread's
end to the poll that found the grow done; medians and maxima of each part
over the runs follow. Last, per call: the runs with a fire, the largest
seeded budget, the largest first live grow (its ``hop.grow`` span), and
the budget against F2's closing rule, budget <= max(0.05 s, 10 x the
largest first live grow).

Then ``--reps`` grows each way, replayed and eager, with the profiler on
and off: in the calling thread; in a fresh thread while the calling
thread waits in ``join`` (idle, the interpreter lock free); and in a
fresh thread while the calling thread runs Python without pause (the
busiest the engine's decode loop can keep the interpreter lock); with the
K1 launches each makes. Needs one CUDA card.
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
PARTS = ("start_ms", "lock_ms", "py_cpu_ms", "py_wait_ms", "sync_ms",
         "device_ms", "found_ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hop_watchdog_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core import init_ligo_params
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.serve import live_prompts
    from repro_torch.models.model import init_params
    from repro_torch.serving import HopController, HopError, ServingEngine
    from repro_torch.tree import tree_leaves
    _build.build()
    cfg = get_config("gpt2-base").scaled(name="gpt2-engine", **ENGINE_CFG)
    cfg2 = cfg.scaled(name="gpt2-engine-grown", n_layers=4, d_model=384,
                      n_heads=6, n_kv_heads=6, d_ff=768)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    op = init_ligo_params(torch.Generator(dev).manual_seed(1), cfg, cfg2,
                          device=dev)
    print(f"[probe] {torch.cuda.get_device_name(0)}; "
          f"sys.getswitchinterval() {sys.getswitchinterval()} s")

    def timed_replay(hop, abort, parts):
        """``HopController._replay`` with its wall cut into parts, in the
        thread that runs it: the wait for the replay lock, the Python up
        to the replay's return (wall and this thread's CPU time: the rest
        of that wall is time the thread waited, on the interpreter lock
        above all), the wait for the device, and the device's span of the
        replay (CUDA events on the side stream around it)."""
        t0 = time.perf_counter()
        with hop._replay_lock:
            t1, c1 = time.perf_counter(), time.thread_time()
            g = hop._graph
            if g is None or abort.is_set():
                raise HopError("grow aborted before its replay")
            with hop._side():
                hop._side_stream.wait_stream(hop._main_stream)
                start = torch.cuda.Event(enable_timing=True)
                start.record(hop._side_stream)
                g.graph.replay()
                ops.count_replay(g.launches)
                t2, c2 = time.perf_counter(), time.thread_time()
                done = torch.cuda.Event(enable_timing=True)
                done.record(hop._side_stream)
                done.synchronize()
        t3 = time.perf_counter()
        for leaf in tree_leaves(g.out):
            leaf.record_stream(hop._main_stream)
        parts.append({"start": t0, "end": time.perf_counter(),
                      "lock_ms": (t1 - t0) * 1e3,
                      "py_ms": (t2 - t1) * 1e3, "py_cpu_ms": (c2 - c1) * 1e3,
                      "sync_ms": (t3 - t2) * 1e3,
                      "device_ms": start.elapsed_time(done)})
        return g.out

    def scenario(profiled: bool, *, tmp: str):
        obs.set_enabled(True)
        obs.FLIGHT.clear()
        eng = ServingEngine(params, cfg, slots=3, prompt_budget=32,
                            gen_budget=16, kv_layout="paged", device=dev)
        for p in live_prompts(9, 32, cfg.vocab_size):
            eng.submit(p, max_new=16)
        walls, found = [], {}
        with obs.profile(tmp if profiled else None, device=dev):
            hop = HopController(eng, cfg2, op, background=True)
            hop.warm()
            parts = []
            hop._replay = lambda abort: timed_replay(hop, abort, parts)
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
        # thread's start, the lock, its Python (CPU / waiting), the device
        # wait and span, and the poll that found it after the thread ended
        br = {}
        if parts and "at" in found:
            g = parts[0]
            launch = found["at"] - found["elapsed"]
            br = {"start_ms": (g["start"] - launch) * 1e3,
                  "lock_ms": g["lock_ms"], "py_cpu_ms": g["py_cpu_ms"],
                  "py_wait_ms": g["py_ms"] - g["py_cpu_ms"],
                  "sync_ms": g["sync_ms"], "device_ms": g["device_ms"],
                  "found_ms": (found["at"] - g["end"]) * 1e3}
            breakdowns.append(br)
        print(f"[probe] {'profiled' if profiled else 'plain   '}: warm ms "
              f"{ {k: round(v, 3) for k, v in hop.warm_ms.items()} }, budget "
              f"{budget:.3f} s | attempts {hop.attempts}, completed "
              f"{hop.completed} | hop.grow spans (attempt, thread, ms) "
              f"{grows} | launch-to-found "
              f"{found.get('elapsed', float('nan')) * 1e3:.2f} ms | "
              f"watchdog fires {fires} | first live grow's parts, ms "
              f"{ {k: round(v, 3) for k, v in br.items()} } | "
              f"engine step walls while the grow ran, ms "
              f"{[round(w, 2) for w in walls]}", flush=True)
        return {"warm": dict(hop.warm_ms), "budget": budget,
                "first": grows[0][2] if grows else float("nan"),
                "found": found.get("elapsed", float("nan")) * 1e3,
                "fired": bool(fires)}

    modes = (True, False)
    results = {m: [] for m in modes}
    breakdowns = []
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(args.reps):
            for m in modes:
                results[m].append(scenario(m, tmp=tmp))
        for profiled, rs in results.items():
            label = "profiled" if profiled else "plain"
            for part in ("fill", "capture", "seed"):
                vals = [r["warm"][part] for r in rs]
                print(f"[probe] {label}: warm {part} ms median "
                      f"{statistics.median(vals):.3f}, max {max(vals):.3f}",
                      flush=True)
            print(f"[probe] {label}: first grow span ms "
                  f"{[round(r['first'], 3) for r in rs]}; launch-to-found "
                  f"ms {[round(r['found'], 3) for r in rs]}; runs with a "
                  f"watchdog fire {sum(r['fired'] for r in rs)} of "
                  f"{len(rs)}", flush=True)
        for key in PARTS:
            vals = sorted(b[key] for b in breakdowns)
            if vals:
                print(f"[probe] first live grows' {key}: median "
                      f"{statistics.median(vals):.3f}, max {vals[-1]:.3f} "
                      f"(of {len(vals)})", flush=True)
        every = [r for rs in results.values() for r in rs]
        top_budget = max(r["budget"] for r in every)
        top_first = max(r["first"] for r in every) / 1e3
        rule = max(0.05, 10 * top_first)
        print(f"[probe] F2 over this call's {len(every)} runs: watchdog "
              f"fires {sum(r['fired'] for r in every)}; largest budget "
              f"{top_budget:.4f} s; largest first live grow "
              f"{top_first * 1e3:.3f} ms; budget / largest first live grow "
              f"{top_budget / top_first:.1f}x; closing rule budget <= "
              f"max(0.05 s, 10 x largest first live grow) = {rule:.4f} s: "
              f"{'met' if top_budget <= rule else 'NOT met'}", flush=True)

        # one grow at a time, replayed and eager: in the calling thread; in
        # a fresh thread the calling thread waits for idle (join); in a
        # fresh thread beside a calling thread that keeps running Python,
        # as the decode loop does
        eng = ServingEngine(params, cfg, slots=3, prompt_budget=32,
                            gen_budget=16, kv_layout="paged", device=dev)
        hop = HopController(eng, cfg2, op, background=True)
        hop.warm()
        grows = {"replay": lambda: hop._replay(threading.Event()),
                 "eager": hop._grow_once}
        wheres = ("calling thread", "fresh thread, caller idle",
                  "fresh thread, caller busy")
        walls = {(k, w, p): [] for k in grows for w in wheres
                 for p in (True, False)}
        k1 = {}
        for profiled in (True, False):
            with obs.profile(tmp if profiled else None, device=dev):
                for _ in range(args.reps):
                    for kind, grow in grows.items():
                        for where in wheres:
                            n0 = ops.launch_counts()[
                                "ligo_blend_expand_grouped"]
                            t0 = time.perf_counter()
                            if where == "calling thread":
                                grow()
                            else:
                                th = threading.Thread(target=grow)
                                th.start()
                                if where.endswith("busy"):
                                    while th.is_alive():
                                        pass
                                th.join(timeout=60)
                            walls[(kind, where, profiled)].append(
                                (time.perf_counter() - t0) * 1e3)
                            k1[kind] = (ops.launch_counts()[
                                "ligo_blend_expand_grouped"] - n0)
        for (kind, where, profiled), ws in walls.items():
            print(f"[probe] one {kind} grow, {where}, "
                  f"{'profiled' if profiled else 'plain'}: ms "
                  f"{[round(w, 3) for w in ws]} (median "
                  f"{statistics.median(ws):.3f}; K1 launches counted "
                  f"{k1[kind]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
