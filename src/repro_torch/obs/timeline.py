"""Chrome-trace / Perfetto export of the span tree and the ledger (the JAX
package's ``obs/timeline.py``).

Converts span and event records (the flight recorder's ring or an
``--obs-log`` file) to the Chrome trace-event format that Perfetto and
``chrome://tracing`` open: duration events (``ph`` ``B``/``E``) per
thread, instants (``ph: "i"``) for point events, thread and process name
metadata (``ph: "M"``), and, because a hop runs across threads (the engine
and the ``hop-grow-N`` worker), every ``hop.*`` span also as an async
pair (``ph`` ``b``/``e``, id = the hop generation).

Spans carry start and duration and are recorded at exit, so the exporter
rebuilds the nesting per thread: spans sorted by start, an open-span stack
closes every span that ended before the next one starts, and a child whose
recorded end drifts past its parent's (ms rounding) is clamped inside it.
Every ``B`` has a matching ``E`` on its tid.

Ledger records (:mod:`repro_torch.obs.ledger`) carry no timestamps, so
they get a track of their own on a synthetic clock, the running sum of the
per-step ``wall_ms``: counter events (``ph: "C"``) for the loss and the
cumulative FLOPs, instants for hop events.

Entry points: :func:`export_chrome_trace` (``--timeline`` on both
launchers) and, offline::

    PYTHONPATH=src python -m repro_torch.obs.timeline run.jsonl -o trace.json
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["to_trace_events", "export_chrome_trace"]

_LEDGER_TID = 0                      # ledger track: synthetic clock, tid 0


def _us(t_ms: float) -> float:
    return round(float(t_ms) * 1000.0, 3)


def to_trace_events(records: Iterable[Dict[str, Any]], *,
                    pid: Optional[int] = None,
                    ledger_records: Optional[Iterable[Dict[str, Any]]] = None,
                    ) -> List[Dict[str, Any]]:
    """Convert span/event records (and optional ledger records) to a
    Chrome trace-event list."""
    pid = os.getpid() if pid is None else int(pid)
    tids: Dict[str, int] = {}

    def tid_of(thread: Any) -> int:
        name = str(thread or "main")
        if name not in tids:
            tids[name] = len(tids) + 1
        return tids[name]

    spans_by_tid: Dict[int, List] = {}
    tail: List[Dict[str, Any]] = []   # instants + async pairs
    for r in records:
        kind = r.get("type")
        if kind == "span":
            name = str(r.get("name", "?"))
            start = float(r.get("t_ms", 0.0))
            end = start + float(r.get("dur_ms") or 0.0)
            tid = tid_of(r.get("thread"))
            args = dict(r.get("attrs") or {})
            if r.get("error"):
                args["error"] = r["error"]
            spans_by_tid.setdefault(tid, []).append((start, end, name, args))
            if name.startswith("hop."):
                aid = str(args.get("gen", r.get("span_id", 0)))
                common = {"cat": "hop", "name": name, "id": aid, "pid": pid,
                          "tid": tid, "args": args}
                tail.append({"ph": "b", "ts": _us(start), **common})
                tail.append({"ph": "e", "ts": _us(end), **common})
        elif kind == "event":
            tail.append({
                "ph": "i", "s": "t", "name": str(r.get("name", "?")),
                "cat": "event", "pid": pid, "tid": tid_of(r.get("thread")),
                "ts": _us(float(r.get("t_ms", 0.0))),
                "args": dict(r.get("attrs") or {}),
            })
        # "dump" headers, "metric" snapshots, log open/close markers: skip

    events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": "repro"}},
    ]
    for name, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": name}})

    for tid, spans in spans_by_tid.items():
        # sort by start; ties open the longer span first so it parents
        spans.sort(key=lambda s: (s[0], -(s[1] - s[0])))
        stack: List = []              # (end, name) of currently-open spans
        for start, end, name, args in spans:
            while stack and stack[-1][0] <= start + 1e-9:
                e_end, e_name = stack.pop()
                events.append({"ph": "E", "name": e_name, "pid": pid,
                               "tid": tid, "ts": _us(e_end)})
            if stack and end > stack[-1][0]:
                end = stack[-1][0]    # clamp child inside its parent
            if end < start:
                end = start
            events.append({"ph": "B", "name": name,
                           "cat": name.split(".", 1)[0], "pid": pid,
                           "tid": tid, "ts": _us(start), "args": args})
            stack.append((end, name))
        while stack:
            e_end, e_name = stack.pop()
            events.append({"ph": "E", "name": e_name, "pid": pid,
                           "tid": tid, "ts": _us(e_end)})

    events.extend(tail)               # instants + the hop async pairs

    if ledger_records is not None:
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": _LEDGER_TID,
                       "args": {"name": "ledger (cum step wall clock)"}})
        t_ms = 0.0
        for r in ledger_records:
            if r.get("type") == "step":
                t_ms += float(r.get("wall_ms", 0.0))
                events.append({
                    "ph": "C", "name": "ledger.loss", "pid": pid,
                    "tid": _LEDGER_TID, "ts": _us(t_ms),
                    "args": {"loss": float(r["loss"])}})
                events.append({
                    "ph": "C", "name": "ledger.cum_flops", "pid": pid,
                    "tid": _LEDGER_TID, "ts": _us(t_ms),
                    "args": {"modelled": float(r["cum_flops_modelled"]),
                             "measured": float(r["cum_flops_measured"])}})
            elif r.get("type") == "event":
                events.append({
                    "ph": "i", "s": "t", "name": str(r.get("name", "?")),
                    "cat": "ledger", "pid": pid, "tid": _LEDGER_TID,
                    "ts": _us(t_ms), "args": dict(r.get("attrs") or {})})
    return events


def export_chrome_trace(path: Optional[str] = None, *,
                        records: Optional[Iterable[Dict[str, Any]]] = None,
                        ledger: Optional[Any] = None,
                        pid: Optional[int] = None) -> Dict[str, Any]:
    """Export a Chrome/Perfetto trace; returns the trace dict.

    ``records`` defaults to the live flight-recorder ring. ``ledger`` may be
    a ledger file path, a :class:`repro_torch.obs.ledger.RunLedger`, or an
    iterable of parsed ledger records.
    """
    if records is None:
        from repro_torch.obs.trace import FLIGHT
        records = FLIGHT.events()
    led_recs = None
    if ledger is not None:
        from repro_torch.obs.ledger import _records
        led_recs = _records(ledger)
    trace = {
        "traceEvents": to_trace_events(records, pid=pid,
                                       ledger_records=led_recs),
        "displayTimeUnit": "ms",
    }
    if path is not None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(trace, fh)
    return trace


def _main(argv: Optional[List[str]] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="Convert an --obs-log stream or flight-recorder dump "
                    "to Chrome trace-event JSON (open in Perfetto).")
    ap.add_argument("input", help="obs JSONL (span/event records)")
    ap.add_argument("-o", "--out", required=True, help="trace JSON path")
    ap.add_argument("--ledger", default=None,
                    help="optional run-ledger JSONL for the loss/FLOPs track")
    args = ap.parse_args(argv)
    records = []
    with open(args.input, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    trace = export_chrome_trace(args.out, records=records,
                                ledger=args.ledger)
    print(f"[timeline] wrote {args.out} "
          f"({len(trace['traceEvents'])} trace events)")


if __name__ == "__main__":
    _main()
