"""Prometheus text format for the obs registry (the JAX package's
``obs/prom.py``).

``render()`` emits the exposition format, version 0.0.4:

- counters        -> ``name_total <v>``
- counter groups  -> ``name_total{key="k"} <v>``
- gauges          -> ``name <v>`` (unset gauges are skipped)
- histograms      -> cumulative ``name_bucket{le="..."}`` series plus
                     ``name_sum`` and ``name_count``

Metric names are sanitised (dots become underscores).

``serve_metrics(port)`` serves it: a stdlib ``ThreadingHTTPServer`` on a
daemon thread answering ``GET /metrics`` with a fresh ``render()`` per
scrape (``--metrics-port`` on both launchers; port 0 binds an ephemeral
port, read back from ``server.server_address``).
"""
from __future__ import annotations

import math
import re
import threading
from typing import Optional

from repro_torch.obs.metrics import REGISTRY, MetricsRegistry

__all__ = ["render", "sanitize", "serve_metrics"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize(name: str) -> str:
    s = _NAME_RE.sub("_", name)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


def render(registry: Optional[MetricsRegistry] = None) -> str:
    reg = registry if registry is not None else REGISTRY
    out = []
    for name, snap in reg.snapshot().items():
        pname = sanitize(name)
        kind = snap["kind"]
        if kind == "counter":
            out.append(f"# TYPE {pname}_total counter")
            out.append(f"{pname}_total {snap['value']}")
        elif kind == "counters":
            if not snap["values"]:
                continue
            out.append(f"# TYPE {pname}_total counter")
            for key, v in sorted(snap["values"].items()):
                out.append(f'{pname}_total{{key="{key}"}} {v}')
        elif kind == "gauge":
            if snap["value"] is None:
                continue
            out.append(f"# TYPE {pname} gauge")
            out.append(f"{pname} {_num(snap['value'])}")
        elif kind == "histogram":
            out.append(f"# TYPE {pname} histogram")
            cum = 0
            for edge, c in zip(snap["buckets"], snap["counts"]):
                cum += c
                out.append(f'{pname}_bucket{{le="{_num(float(edge))}"}} {cum}')
            cum += snap["counts"][-1]
            out.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
            out.append(f"{pname}_sum {_num(float(snap['sum']))}")
            out.append(f"{pname}_count {snap['count']}")
    return "\n".join(out) + ("\n" if out else "")


def serve_metrics(port: int = 0, *, host: str = "127.0.0.1",
                  registry: Optional[MetricsRegistry] = None):
    """Expose ``render()`` at ``GET /metrics`` on a daemon thread.

    Returns the started ``http.server.ThreadingHTTPServer``: the bound
    port (ephemeral when ``port=0``) is ``server.server_address[1]`` and
    ``server.shutdown()`` stops it. Any other path is a 404.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):              # noqa: N802 (stdlib handler API)
            if self.path.split("?", 1)[0] != "/metrics":
                self.send_error(404)
                return
            body = render(registry).encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # scrapes are not stdout events
            pass

    server = ThreadingHTTPServer((host, port), _Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="obs-metrics")
    thread.start()
    return server
