"""Structured tracing: spans, events and the flight recorder (the JAX
package's ``obs/trace.py``, with its record layout and key order).

``span(name, **attrs)`` is a context manager on a monotonic clock
(``time.perf_counter``), thread-safe with per-thread parent stacks: a span
opened inside another span on the *same* thread records that span as its
parent, so a dump rebuilds the tree, and a span on another thread (the
hop's ``hop-grow-N``) has no parent from the engine thread.
``event(name, **attrs)`` records a point-in-time marker.

Both land in the :class:`FlightRecorder`, a bounded in-memory ring that
dumps as JSONL on demand (:func:`flight_dump`) and is dumped by the hop
controller on every rollback. An optional *sink* (attached by
``--obs-log``) streams every record as it happens. Records are plain dicts
with a fixed key order::

    {"type": "span", "name": "hop.grow", "span_id": 7, "parent_id": null,
     "thread": "hop-grow-1", "t_ms": 123.4, "dur_ms": 56.7,
     "attrs": {"gen": 1, "attempt": 1}}

``t_ms`` is milliseconds since the first import of this module; ``dur_ms``
is the span's wall. Spans are recorded at exit, so the ring is ordered by
end time. A span that exits through an exception carries an ``error``
field with the exception's repr.

**Spans are host walls; no span synchronises the card.** Where a span
should cover device work, the code it wraps already ends in a host read
or a synchronisation of its own: ``ligo.chunk`` closes after every loss of
the chunk was read with ``float()``, ``hop.grow`` after the grow's CUDA
event synchronised, ``hop.cache-grow`` after ``torch.cuda.synchronize``.
Where the JAX package's span covers the dispatch only, so does the
port's: ``serve.prefill`` closes before the first logits are read (the
synchronised number is the TTFT histogram), and ``ligo.checkpoint`` covers
the enqueue of the async save. Adding a synchronisation for a span would
change the host-bound decode and prefill walls it is meant to record.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from repro_torch.obs import _state

__all__ = [
    "FlightRecorder", "FLIGHT", "span", "event", "flight_dump",
    "set_dump_dir", "dump_dir", "set_enabled", "enabled",
]

set_enabled = _state.set_enabled
enabled = _state.enabled

_EPOCH = time.perf_counter()
_SPAN_IDS = itertools.count(1)
_TLS = threading.local()


def _now_ms() -> float:
    return (time.perf_counter() - _EPOCH) * 1e3


class FlightRecorder:
    """Bounded ring of trace records, dumpable as JSONL."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._sink: Optional[Callable[[dict], None]] = None
        self._dropped = 0  # records evicted from the ring (bounded memory)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def record(self, ev: dict) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(ev)
            sink = self._sink
        if sink is not None:
            try:
                sink(ev)
            except Exception:  # a broken sink must never kill the workload
                pass

    def events(self, *, type: Optional[str] = None,
               prefix: Optional[str] = None) -> List[dict]:
        """Snapshot of the ring, oldest first, optionally filtered."""
        with self._lock:
            evs = list(self._ring)
        if type is not None:
            evs = [e for e in evs if e.get("type") == type]
        if prefix is not None:
            evs = [e for e in evs if str(e.get("name", "")).startswith(prefix)]
        return evs

    def set_sink(self, sink: Optional[Callable[[dict], None]]) -> None:
        with self._lock:
            self._sink = sink

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0

    def dump(self, path: str, *, reason: str = "on-demand") -> str:
        """Write the ring (oldest first) to ``path`` as JSONL."""
        with self._lock:
            evs = list(self._ring)
            dropped = self._dropped
        with open(path, "w") as fh:
            fh.write(json.dumps({
                "type": "dump", "reason": reason, "t_ms": _now_ms(),
                "n_records": len(evs), "ring_evicted": dropped,
            }) + "\n")
            for ev in evs:
                fh.write(json.dumps(ev) + "\n")
        return path


FLIGHT = FlightRecorder()

_DUMP_DIR: Optional[str] = None
_DUMP_SEQ = itertools.count(1)
_DUMP_LOCK = threading.Lock()


def set_dump_dir(d: Optional[str]) -> None:
    """Directory for automatic flight-recorder dumps (None disables them)."""
    global _DUMP_DIR
    _DUMP_DIR = d


def dump_dir() -> Optional[str]:
    return _DUMP_DIR


def flight_dump(reason: str) -> Optional[str]:
    """Dump the ring to ``<dump_dir>/flightrec-NNN-<reason>.jsonl``.

    No-op (returns None) when no dump dir is configured; the ring still
    holds everything for an on-demand :meth:`FlightRecorder.dump`.
    """
    d = _DUMP_DIR
    if d is None:
        return None
    event("obs.dump", reason=reason)
    safe = "".join(c if (c.isalnum() or c in "-_.") else "-" for c in reason)
    with _DUMP_LOCK:
        n = next(_DUMP_SEQ)
        path = os.path.join(d, f"flightrec-{n:03d}-{safe}.jsonl")
        FLIGHT.dump(path, reason=reason)
    return path


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class _Span:
    """Context manager recording one span on exit. Mutate ``attrs`` inside
    the block to attach facts found mid-span (the cache-migration mode);
    read ``dur_ms`` after the block for the measured wall."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "_t0", "dur_ms")

    def __init__(self, name: str, attrs: Dict[str, object]):
        self.name = name
        self.attrs = attrs
        self.span_id = next(_SPAN_IDS)
        self.parent_id: Optional[int] = None
        self._t0 = 0.0
        self.dur_ms: Optional[float] = None

    def __enter__(self) -> "_Span":
        st = _stack()
        self.parent_id = st[-1] if st else None
        st.append(self.span_id)
        self._t0 = _now_ms()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = _now_ms()
        st = _stack()
        if st and st[-1] == self.span_id:
            st.pop()
        self.dur_ms = round(t1 - self._t0, 3)
        rec = {
            "type": "span", "name": self.name, "span_id": self.span_id,
            "parent_id": self.parent_id,
            "thread": threading.current_thread().name,
            "t_ms": round(self._t0, 3), "dur_ms": self.dur_ms,
        }
        if exc is not None:
            rec["error"] = repr(exc)
        rec["attrs"] = self.attrs
        FLIGHT.record(rec)
        return False  # never swallow


class _NoopSpan:
    __slots__ = ("attrs", "dur_ms")

    def __init__(self):
        self.attrs: Dict[str, object] = {}
        self.dur_ms: Optional[float] = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *a) -> bool:
        return False


def span(name: str, **attrs):
    """Open a span: ``with span("hop.grow", gen=3) as sp: ...``."""
    if not _state.enabled():
        return _NoopSpan()  # fresh: callers may write attrs
    return _Span(name, attrs)


def event(name: str, **attrs) -> None:
    """Record a point-in-time marker (e.g. ``hop.rollback``)."""
    if not _state.enabled():
        return
    st = _stack()
    FLIGHT.record({
        "type": "event", "name": name,
        "parent_id": st[-1] if st else None,
        "thread": threading.current_thread().name,
        "t_ms": round(_now_ms(), 3),
        "attrs": attrs,
    })
