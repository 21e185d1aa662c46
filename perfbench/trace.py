"""Reading a profiled window: the device's busy time, its kernels by the
program op that launched them, and the breakdown the ledger keeps.

:func:`capture` runs a callable under ``torch.profiler``, exports the
trace to a temporary file and reads it back into a :class:`TraceView`.
With ``shapes=False`` it traces the device alone (its kernels, copies and
fills, and the runtime calls that launched them), which costs the host
little; with ``shapes=True`` also the host's ops with their operand
shapes, which costs the host some microseconds an op and so stretches a
step of many small ops. Each kernel
is tied to the host op that launched it by the trace's ``External id``
(or, where a kernel lacks one, through its launch call's correlation id to
the innermost host op around that call), and each host op to the ops
around it on its thread.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class TraceView:
    def __init__(self, events: List[Dict], wall_s: float):
        self.wall_s = wall_s
        self.ops: List[Dict] = []
        self.device: List[Dict] = []
        launches: Dict[int, Dict] = {}
        self._calls: Dict[object, List[Dict]] = defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat == "cpu_op":
                self.ops.append(e)
            elif cat in DEVICE_CATS:
                self.device.append(e)
            elif cat in LAUNCH_CATS:
                self._calls[e["tid"]].append(e)
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = e
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self._nest()
        by_ext = {}
        for i, op in enumerate(self.ops):
            ext = op.get("args", {}).get("External id")
            if ext is not None:
                by_ext.setdefault(ext, i)
        self.launcher: List[Optional[int]] = []
        self._launch_tid: Dict[int, object] = {}
        for k in self.kernels:
            args = k.get("args", {})
            call = launches.get(args.get("correlation"))
            if call is not None:
                self._launch_tid[id(k)] = call["tid"]
            i = by_ext.get(args.get("External id"))
            if i is None and call is not None:
                i = self._innermost(call["tid"], call["ts"])
            self.launcher.append(i)
            if i is not None:
                self._launch_tid[id(k)] = self.ops[i]["tid"]
        for calls in self._calls.values():
            calls.sort(key=lambda e: e["ts"])

    # -- host ops --------------------------------------------------------
    def _nest(self) -> None:
        """Each op's parent: the innermost op around it on its thread."""
        self.parent: List[Optional[int]] = [None] * len(self.ops)
        self._by_tid: Dict[object, List[int]] = defaultdict(list)
        order = sorted(range(len(self.ops)),
                       key=lambda i: (self.ops[i]["ts"], -self.ops[i]["dur"]))
        stacks: Dict[object, List[int]] = defaultdict(list)
        for i in order:
            op = self.ops[i]
            st = stacks[op["tid"]]
            while st and (self.ops[st[-1]]["ts"] + self.ops[st[-1]]["dur"]
                          < op["ts"] + op["dur"]):
                st.pop()
            self.parent[i] = st[-1] if st else None
            st.append(i)
            self._by_tid[op["tid"]].append(i)
        self._starts = {t: [self.ops[i]["ts"] for i in ix]
                        for t, ix in self._by_tid.items()}

    def _innermost(self, tid, ts) -> Optional[int]:
        ix = self._by_tid.get(tid)
        if not ix:
            return None
        j = bisect.bisect_right(self._starts[tid], ts) - 1
        best = None
        while j >= 0:
            op = self.ops[ix[j]]
            if op["ts"] + op["dur"] >= ts:
                best = ix[j]
                break
            j -= 1
        # the latest-starting op that still covers ts is the innermost
        return best

    def ancestors(self, i: Optional[int]):
        while i is not None:
            yield i
            i = self.parent[i]

    def owner(self, kernel_index: int, names) -> Optional[int]:
        """The nearest op named in ``names`` around a kernel's launch."""
        for i in self.ancestors(self.launcher[kernel_index]):
            if self.ops[i]["name"] in names:
                return i
        return None

    # -- the device --------------------------------------------------------
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the kernels', copies' and fills' intervals)."""
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        busy, end = 0.0, None
        for a, b in spans:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy / 1e6

    def kernel_time_under(self, names) -> Tuple[float, Dict[int, float]]:
        """Device seconds of the kernels launched under ops named in
        ``names``, in all and by owning op."""
        by_op: Dict[int, float] = defaultdict(float)
        for j, k in enumerate(self.kernels):
            i = self.owner(j, names)
            if i is not None:
                by_op[i] += k["dur"] / 1e6
        return sum(by_op.values()), by_op

    # -- the breakdown -----------------------------------------------------
    def label(self, kernel_index: int) -> str:
        """What a kernel's time is booked under: the program's custom op
        around it, else an einsum around it, else the op that launched
        it; ``(bwd)`` when autograd's engine ran it."""
        chain = list(self.ancestors(self.launcher[kernel_index]))
        names = [self.ops[i]["name"] for i in chain]
        bwd = any(n.startswith("autograd::engine") for n in names)
        for n in names:
            if n.startswith("repro_torch::"):
                return n
        base = next((n for n in names if n == "aten::einsum"), None)
        if base is None:
            base = names[0] if names else self.kernels[kernel_index]["name"]
        return base + (" (bwd)" if bwd else "")

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for j, k in enumerate(self.kernels):
            by[self.label(j)] += k["dur"] / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])
                ][:top]

    def _call_at(self, tid, ts) -> Optional[str]:
        """The runtime call in flight on thread ``tid`` at ``ts``."""
        calls = self._calls.get(tid, [])
        j = bisect.bisect_right([c["ts"] for c in calls], ts) - 1
        if j >= 0 and calls[j]["ts"] + calls[j]["dur"] >= ts:
            return calls[j]["name"]
        return None

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The longest stretches with nothing on the device, each named by
        what the host was doing at its middle, on the thread that launched
        the work ending the stretch: the innermost op there, else the
        runtime call in flight (a trace of the device alone has no ops),
        else nothing the trace records; and by the device operation that
        ends it."""
        gaps = []
        end = None
        for e in sorted(self.device, key=lambda e: (e["ts"], e["dur"])):
            a, b = e["ts"], e["ts"] + e["dur"]
            if end is not None and a > end:
                gaps.append((a - end, end, a, e))
            end = b if end is None else max(end, b)
        gaps.sort(key=lambda g: -g[0])
        out = []
        for length, a, b, e in gaps[:top]:
            tid = self._launch_tid.get(id(e))
            name = None
            if tid is not None:
                i = self._innermost(tid, (a + b) / 2)
                name = (self.ops[i]["name"] if i is not None
                        else self._call_at(tid, (a + b) / 2))
            name = name or "(host outside any traced op or call)"
            out.append([f"{name} before {short(e['name'])}", length / 1e6])
        return out


def short(kernel: str) -> str:
    """A device operation's name without its template and arguments."""
    return kernel.split("(")[0].split("<")[0].strip()[:60] or kernel[:60]


def capture(fn: Callable[[], None], sync: Callable[[], None], *,
            shapes: bool) -> TraceView:
    """``fn()`` under the profiler, with the host's ops and their shapes
    or without them; the view of its trace, whose ``wall_s`` is the host
    clock from the call to the device's end."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    activities = ([ProfilerActivity.CPU] if shapes else []) + [
        ProfilerActivity.CUDA]
    with profile(activities=activities, record_shapes=shapes) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return TraceView(events, wall)
