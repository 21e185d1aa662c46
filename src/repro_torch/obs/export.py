"""Export paths: JSONL streaming, the human report, the profiler gate (the
JAX package's ``obs/export.py``).

``attach_jsonl(path)`` opens a line-buffered file and installs it as the
flight recorder's sink, so every span and event streams out as it happens
(a crash still leaves everything up to its last record on disk). It also
points automatic flight-recorder dumps at the log's directory.
``close_jsonl()`` appends one ``{"type": "metric", ...}`` line per registry
metric (counter groups flattened to ``group.key``) and closes the file.

``report()`` renders the registry and the ring as the summary ``--obs-report``
prints at exit. ``profile(dir)`` is the counterpart of the JAX package's
``jax.profiler`` gate: a ``torch.profiler`` run over the block (CPU
activity always, CUDA activity when the run is on the card) whose Chrome
trace lands in ``dir``; a no-op when ``dir`` is None.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import List, Optional

from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import FLIGHT, set_dump_dir

__all__ = ["attach_jsonl", "close_jsonl", "report", "profile"]

_LOCK = threading.Lock()
_FH = None
_PATH: Optional[str] = None


def attach_jsonl(path: str) -> None:
    """Stream every flight-recorder record to ``path`` (JSONL)."""
    global _FH, _PATH
    with _LOCK:
        if _FH is not None:
            raise RuntimeError(f"obs log already attached: {_PATH}")
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        fh = open(path, "w", buffering=1)
        _FH, _PATH = fh, path
    fh.write(json.dumps({
        "type": "meta", "event": "obs-log-open", "pid": os.getpid(),
        "unix_time": time.time(),
    }) + "\n")

    def _sink(ev: dict) -> None:
        with _LOCK:
            if _FH is not None:
                _FH.write(json.dumps(ev) + "\n")

    FLIGHT.set_sink(_sink)
    # hop rollback dumps land next to the log
    set_dump_dir(os.path.dirname(os.path.abspath(path)) or ".")


def _metric_lines() -> List[str]:
    lines = []
    for name, snap in REGISTRY.snapshot().items():
        if snap.get("kind") == "counters":
            for key, v in sorted(snap["values"].items()):
                lines.append(json.dumps({
                    "type": "metric", "name": f"{name}.{key}",
                    "kind": "counter", "value": v,
                }))
        else:
            lines.append(json.dumps({"type": "metric", "name": name, **snap}))
    return lines


def close_jsonl() -> Optional[str]:
    """Flush the final metric snapshot and close the log. Returns its path."""
    global _FH, _PATH
    FLIGHT.set_sink(None)
    with _LOCK:
        fh, path = _FH, _PATH
        if fh is None:
            return None
        _FH, _PATH = None, None
        for line in _metric_lines():
            fh.write(line + "\n")
        fh.write(json.dumps({"type": "meta", "event": "obs-log-close"}) + "\n")
        fh.close()
    return path


def _fmt(v, nd=2) -> str:
    if v is None:
        return "-"
    return f"{v:.{nd}f}"


def report() -> str:
    """Human summary of the registry and the hop spans in the ring."""
    snap = REGISTRY.snapshot()
    lines: List[str] = ["[obs] ---- observability report ----"]

    h = snap.get("serve.decode.step_ms")
    if h and h["count"]:
        lines.append(
            f"[obs] decode step (through-hop): n={h['count']} "
            f"p50={_fmt(h['p50'])} ms p99={_fmt(h['p99'])} ms "
            f"max={_fmt(h['max'])} ms")
    for name, label in (("serve.request.queue_wait_ms", "queue wait"),
                        ("serve.request.ttft_ms", "ttft"),
                        ("serve.request.tokens_per_s", "tokens/s")):
        h = snap.get(name)
        if h and h["count"]:
            unit = "" if name.endswith("_s") else " ms"
            lines.append(f"[obs] request {label}: n={h['count']} "
                         f"p50={_fmt(h['p50'])}{unit} p99={_fmt(h['p99'])}{unit}")
    c = snap.get("serve.requests")
    if c and c["values"]:
        kv = " ".join(f"{k}={v}" for k, v in sorted(c["values"].items()))
        lines.append(f"[obs] requests: {kv}")

    acc = snap.get("serve.spec.acc_ema")
    if acc and acc["value"] is not None:
        est = snap.get("serve.spec.est_speedup", {}).get("value")
        lines.append(f"[obs] speculative: acc_ema={_fmt(acc['value'], 3)} "
                     f"est_speedup={_fmt(est)}x")
    pool = snap.get("serve.kv.pool_in_use_blocks")
    if pool and pool["value"] is not None:
        peak = snap.get("serve.kv.pool_peak_blocks", {}).get("value")
        total = snap.get("serve.kv.pool_total_blocks", {}).get("value")
        deferred = snap.get("serve.requests", {}).get("values", {}).get("deferred", 0)
        lines.append(f"[obs] kv pool: in_use={_fmt(pool['value'], 0)} "
                     f"peak={_fmt(peak, 0)} total={_fmt(total, 0)} blocks "
                     f"(deferred admits: {deferred})")

    # per-hop-stage walls from the span ring
    hop_spans = [e for e in FLIGHT.events(type="span")
                 if e["name"] in ("hop.grow", "hop.cache-grow", "hop.swap")]
    if hop_spans:
        lines.append("[obs] hop stages:")
        for e in sorted(hop_spans, key=lambda e: e["t_ms"]):
            extra = " ERROR " + e["error"] if "error" in e else ""
            attrs = " ".join(f"{k}={v}" for k, v in e.get("attrs", {}).items())
            lines.append(f"[obs]   {e['name']:<14} {e['dur_ms']:9.2f} ms  "
                         f"{attrs}{extra}")
    for ev in FLIGHT.events(type="event", prefix="hop.rollback"):
        a = ev.get("attrs", {})
        lines.append(f"[obs]   rollback at stage={a.get('stage')} "
                     f"attempt={a.get('attempt')}: {a.get('cause')}")
    wd = snap.get("hop.watchdog.budget_s")
    if wd and wd["value"] is not None:
        ewma = snap.get("hop.watchdog.ewma_s", {}).get("value")
        floor = snap.get("hop.watchdog.floor_s", {}).get("value")
        lines.append(f"[obs] hop watchdog: ewma={_fmt(ewma)}s "
                     f"budget={_fmt(wd['value'])}s floor={_fmt(floor)}s")

    for name, label in (("ligo.chunk_ms", "ligo chunk"),
                        ("ligo.checkpoint_ms", "ligo checkpoint"),
                        ("traj.stage.train_ms", "trajectory train leg"),
                        ("traj.stage.grow_ms", "trajectory grow")):
        h = snap.get(name)
        if h and h["count"]:
            lines.append(f"[obs] {label}: n={h['count']} "
                         f"p50={_fmt(h['p50'])} ms p99={_fmt(h['p99'])} ms")

    if len(lines) == 1:
        lines.append("[obs] (no metrics recorded)")
    lines.append("[obs] -------------------------------")
    return "\n".join(lines)


@contextlib.contextmanager
def profile(trace_dir: Optional[str], *, device="cuda"):
    """Run the block under ``torch.profiler`` and write its Chrome trace
    into ``trace_dir`` (a no-op when ``trace_dir`` is None).

    CPU activity is always recorded, CUDA activity when ``device`` is a
    CUDA device. A profiler that cannot start raises, and on the card a
    run that recorded no kernel raises once the block has finished:
    the run never carries on unprofiled. Yields the trace's path.
    """
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity
    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"torch_trace.{os.getpid()}."
                                   f"{time.time_ns()}.json")
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        print(f"[obs] torch profiler trace written to {path}")
    if on_card:
        with open(path) as fh:
            evs = json.load(fh).get("traceEvents", [])
        if not any(e.get("cat") == "kernel" for e in evs):
            raise RuntimeError(f"--obs-profile: the profiler recorded no CUDA "
                               f"kernel ({path}); CUDA activity tracing is "
                               f"unavailable on this device")
