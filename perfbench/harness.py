"""The benchmark's driver: one run of one cell of ``BENCHMARK.json``.

A run resolves the cell by name (``BENCHMARK.json`` names its
configuration and traffic; ``perfbench/workloads/<cell>.json`` its entry,
optimizer settings and the limits of its comparison), sets up the program
through the entry (``perfbench/entries/<entry>.py``), measures, and then,
with the program's state freed, has the reference (``perfbench/reference``)
redo the first steps from the same seed for the judge
(``perfbench/judge.py``).

``--trace 0`` times a window of ``--seconds`` and reports the cell's
end-to-end metrics; ``--trace 1`` runs three windows of ``trace_steps``
steps (one untraced, two profiled; see ``perfbench/readers.py``) and
reports its per-layer metrics, each read by ``perfbench/metrics/<name>.py``.
Either prints, last on standard output, one JSON line: ``correct``,
``attempted`` (steps in the windows), ``failed`` (steps with a loss that is
not finite), ``metrics``, ``device``, with ``--trace 1`` the
``breakdown``, and last the ``compared`` numbers beside their limits.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Set-up seconds by part, from the process's start, and what the
    process used of the host in each part (CPU seconds, page faults that
    read the disk, switches forced by other work), to tell a part that
    waits on the host from one that works."""

    def __init__(self, t0: float):
        self.t0 = self.last = t0
        self.parts: Dict[str, float] = {}
        self.host: Dict[str, Dict[str, float]] = {}
        self._usage = self._rusage()

    @staticmethod
    def _rusage() -> Dict[str, float]:
        import resource
        r = resource.getrusage(resource.RUSAGE_SELF)
        return {"cpu_s": r.ru_utime + r.ru_stime, "major_faults": r.ru_majflt,
                "forced_switches": r.ru_nivcsw}

    def mark(self, part: str) -> None:
        now = time.perf_counter()
        usage = self._rusage()
        self.parts[part] = now - self.last
        self.host[part] = {k: usage[k] - self._usage[k] for k in usage}
        self.last, self._usage = now, usage

    def total(self) -> float:
        return self.last - self.t0


class Cell:
    """A workload with its configuration, traffic and workload files read
    (:func:`load_cell` finds them by the names in ``BENCHMARK.json``)."""

    def __init__(self, name: str, config: Dict, traffic: Dict,
                 workload: Dict, *, chips: int = 1,
                 end_to_end: List[Dict] = (), per_layer: List[Dict] = ()):
        self.name, self.config = name, config
        self.traffic, self.workload, self.chips = traffic, workload, chips
        self.metrics_e2e = [m for m in end_to_end
                            if name in m.get("workloads", [name])]
        self.metrics_layer = [m for m in per_layer
                              if name in m.get("workloads", [name])]
        fam = importlib.import_module(
            f"perfbench.reference.{config['reference']}")
        self.geom = fam.geometry(config)
        src = config.get("source_model")
        self.source_geom = fam.geometry(src) if src else None

    def port_config(self, geom: Dict):
        """The program's configuration of a model of these sizes."""
        from repro_torch.configs.base import ModelConfig
        if geom["eps"] != 1e-6:
            raise ValueError("the program's norms take eps 1e-6")
        return ModelConfig(
            name=f"{self.config['name']}-{geom['n_layers']}x{geom['d_model']}",
            family="dense", n_layers=geom["n_layers"],
            d_model=geom["d_model"], n_heads=geom["n_heads"],
            n_kv_heads=geom["n_kv_heads"], d_ff=geom["d_ff"],
            vocab_size=geom["vocab"], d_head=geom["d_head"],
            block_pattern=("attn",), rope=geom["positions"],
            rope_theta=geom["rope_theta"] or 500000.0,
            act="gelu" if geom["act"] == "gelu_tanh" else "swiglu",
            norm=geom["norm"], tie_embeddings=geom["tied"],
            dtype=geom["dtype"], max_seq=geom["max_pos"], objective="clm")

    def entry(self):
        return importlib.import_module(
            f"perfbench.entries.{self.workload['entry']}")


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(bench: Dict, name: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"known: {sorted(cells)}")
    spec = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[spec["config"]]
    here = root / "perfbench"
    return Cell(name, _json(root / config["file"]),
                _json(here / "traffic" / f"{spec['traffic']}.json"),
                _json(here / "workloads" / f"{name}.json"),
                chips=int(spec["chips"]), end_to_end=bench["end_to_end"],
                per_layer=bench["per_layer"])


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (the loaded modules
    by default), compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in (names or list(sys.modules))}
                  & set(FORBIDDEN))


def parse(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(*lines: str) -> None:
    for line in lines:
        print(line, file=sys.stderr, flush=True)


def _timed(entry, cell: Cell, seconds: float, setup_s: float):
    """The end-to-end window: as many steps as fill ``seconds`` at the
    warm step's time; (steps, losses, metrics)."""
    n = max(1, round(seconds / entry.warm_step_s))
    wall, losses = entry.window(n)
    say(f"perfbench: window {n} steps in {wall:.4f} s "
        f"(warm step {entry.warm_step_s:.4f} s)")
    metrics = {}
    for m in cell.metrics_e2e:
        value = (setup_s if m["name"] == "setup_s"
                 else n * entry.tokens_per_step / wall)
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return n, losses, metrics


def _traced(entry, cell: Cell, dev):
    """The traced run's three windows of ``trace_steps`` steps each (see
    :mod:`perfbench.readers`): untraced, traced on the device alone, and
    traced with the host's ops and shapes; (steps, losses, the per-layer
    metrics its readers find, the device's busy and window seconds of the
    device-only trace, the breakdown)."""
    from perfbench import readers
    from perfbench.trace import capture
    n = int(cell.workload["trace_steps"])
    timed_wall, losses = entry.window(n)
    views = {}
    for shapes in (False, True):
        def window():
            views[shapes, "wall"], views[shapes, "losses"] = entry.window(n)
        views[shapes] = capture(window, lambda: sync(dev), shapes=shapes)
        losses = losses + views[shapes, "losses"]
    device, shaped = views[False], views[True]
    traced = readers.TracedRun(device, shaped, n, entry.step_ops,
                               timed_steps=n, timed_wall_s=timed_wall)
    metrics = {}
    for m in cell.metrics_layer:
        value = load_reader(m["name"])(traced)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    busy = device.busy_s()
    breakdown = {"device_ops": shaped.device_ops(),
                 "idle_gaps": device.idle_gaps()}
    say("perfbench: traced " + json.dumps(
        {"steps": n, "step_s_untraced": timed_wall / n,
         "step_s_device_trace": device.wall_s / n,
         "step_s_shapes_trace": shaped.wall_s / n,
         "wall_s": device.wall_s, "busy_s": busy,
         "kernels": len(device.kernels), "step_ops": entry.step_ops,
         **breakdown}))
    return (3 * n, losses, metrics,
            {"busy_s": busy, "window_s": device.wall_s}, breakdown)


def run(args, t0: float, *, device: str = "cuda",
        bench: Optional[Dict] = None,
        cell: Optional[Cell] = None) -> Optional[Dict]:
    """One run; returns the result line's object, or None (and the caller
    exits non-zero) where the run cannot report. :func:`main` prints it,
    unless the process has loaded JAX or the JAX package by then."""
    clock = Clock(t0)
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            say("perfbench: no CUDA device: nothing is measured")
            return None
    if cell is None:
        cell = load_cell(bench or _json(ROOT / "BENCHMARK.json"),
                         args.workload)
    if device == "cuda" and torch.cuda.device_count() < cell.chips:
        say(f"perfbench: {cell.name} needs {cell.chips} devices, "
            f"{torch.cuda.device_count()} present")
        return None
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
    clock.mark("import_and_device")
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        built = _build.build()
        for name in _build.SOURCES:
            _build.load(name)
        if built:
            say(f"perfbench: kernels built: {built}")
    clock.mark("kernels")
    mod = cell.entry()
    entry = mod.Entry(cell, args.seed, dev, clock)
    setup_s = clock.total()
    say("perfbench: setup_s " + json.dumps(
        {"total": setup_s, **clock.parts}))
    say("perfbench: setup_host " + json.dumps(clock.host))

    if args.trace:
        n, losses, metrics, extra, breakdown = _traced(entry, cell, dev)
    else:
        n, losses, metrics = _timed(entry, cell, args.seconds, setup_s)
        extra = breakdown = None
    failed = sum(1 for x in losses if not math.isfinite(x))

    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    checks = entry.checks()
    readings = entry.readings
    entry.release()
    del entry
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = mod.reference(cell, args.seed, dev)
    say(f"perfbench: reference {time.perf_counter() - t_ref:.3f} s")
    from perfbench import judge
    correct, compared = judge.verdict(readings, ref,
                                      cell.workload["limits"], checks)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak),
                   **(extra or {})}
    result = {"correct": bool(correct and failed == 0), "attempted": n,
              "failed": failed, "metrics": metrics, "device": device_info}
    if args.trace:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": c["value"], "limit": c["limit"],
                              "rule": c["rule"]} for k, c in compared.items()}
    say("perfbench: readings " + json.dumps(
        {"program": readings, "reference": ref}))
    for k, c in compared.items():
        say(f"compared {k}: {c['value']!r} {c['rule']} {c['limit']!r}"
            + (f" (at {c['at']})" if c.get("at") else ""))
    return result


def main(argv: Optional[List[str]] = None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    result = run(args, t0)
    if result is None:
        return 2
    found = forbidden_modules()
    if found:
        say(f"perfbench: the run loaded {found}: no result")
        return 2
    print(json.dumps(result), flush=True)
    return 0
