"""Observability: spans, events, the flight recorder, metrics, their
exports, the compute ledger and the measured-cost pass (the port of the
JAX package's ``obs``, with its export list).

- **Spans and events** (:mod:`repro_torch.obs.trace`): ``span("hop.grow",
  gen=3)`` (thread-safe, monotonic clock, parent/child nesting per thread)
  and point events, recorded into a bounded in-memory flight recorder that
  dumps as JSONL on demand and on every hop rollback.
- **Metrics** (:mod:`repro_torch.obs.metrics`): counters, gauges,
  fixed-bucket histograms and counter groups in a process-global registry.
- **Export** (:mod:`repro_torch.obs.export`, :mod:`repro_torch.obs.prom`):
  JSONL streaming (``--obs-log``), the report (``--obs-report``), the
  Prometheus text and a ``/metrics`` endpoint (``--metrics-port``), and the
  ``torch.profiler`` gate (``--obs-profile``).
- **Compute ledger** (:mod:`repro_torch.obs.ledger`) and **measured costs**
  (:mod:`repro_torch.obs.costs`).
- **Timeline** (:mod:`repro_torch.obs.timeline`): Chrome-trace export of
  the span tree and the ledger (``--timeline``, or ``python -m
  repro_torch.obs.timeline`` on an ``--obs-log`` file).

Names follow ``<layer>.<unit>[_<ms|s>]``: ``serve.decode.step_ms``,
``hop.watchdog.budget_s``, ``ligo.chunk_ms``, ``traj.stage.train_ms``.
Spans: ``serve.prefill``, ``hop.warm`` / ``hop.grow`` / ``hop.cache-grow``
/ ``hop.swap``, ``ligo.chunk`` / ``ligo.checkpoint``, ``traj.train`` /
``traj.grow``. ``set_enabled(False)`` switches spans and metric writes
off (counter groups keep counting).
"""
from repro_torch.obs.metrics import (
    Counter, CounterGroup, Gauge, Histogram, LOG10_BUCKETS, MetricsRegistry,
    MS_BUCKETS, RATE_BUCKETS, REGISTRY, S_BUCKETS, counter, counter_group,
    gauge, histogram,
)
from repro_torch.obs.trace import (
    FLIGHT, FlightRecorder, dump_dir, enabled, event, flight_dump,
    set_dump_dir, set_enabled, span,
)
from repro_torch.obs.export import attach_jsonl, close_jsonl, profile, report
from repro_torch.obs.prom import serve_metrics
from repro_torch.obs.ledger import (
    RunLedger, active_ledger, attach_ledger, detach_ledger, normalize_records,
    read_ledger, savings_report,
)
from repro_torch.obs.timeline import export_chrome_trace
from repro_torch.obs import costs, prom

__all__ = [
    # metrics
    "Counter", "CounterGroup", "Gauge", "Histogram", "MetricsRegistry",
    "REGISTRY", "counter", "counter_group", "gauge", "histogram",
    "MS_BUCKETS", "S_BUCKETS", "RATE_BUCKETS", "LOG10_BUCKETS",
    # tracing
    "FLIGHT", "FlightRecorder", "span", "event", "flight_dump",
    "set_dump_dir", "dump_dir", "set_enabled", "enabled",
    # export
    "attach_jsonl", "close_jsonl", "report", "profile", "prom",
    "serve_metrics",
    # compute ledger + measured costs + timeline
    "RunLedger", "attach_ledger", "active_ledger", "detach_ledger",
    "read_ledger", "normalize_records", "savings_report", "costs",
    "export_chrome_trace",
]
