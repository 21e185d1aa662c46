"""The observability flags both launchers share, opened and closed in the
JAX launchers' order: the ``/metrics`` server first, then (in the
launcher) the compute ledger and the JSONL log, the run under the profiler
gate, and at exit the report, the ledger, the timeline (with the ledger's
track) and the log's final metric snapshot."""
from __future__ import annotations

import os

from repro_torch import obs


def add_args(ap, log_help: str) -> None:
    g = ap.add_argument_group("observability")
    g.add_argument("--obs-log", default=None, metavar="FILE", help=log_help)
    g.add_argument("--obs-report", action="store_true",
                   help="print the observability summary at exit")
    g.add_argument("--obs-profile", default=None, metavar="DIR",
                   help="run under torch.profiler (CUDA activity on the "
                        "card; no kernel recorded there fails the run) and "
                        "write its Chrome trace into DIR")
    g.add_argument("--timeline", default=None, metavar="FILE",
                   help="at exit, export the flight recorder's span tree "
                        "(hop stages also as async spans; the ledger's "
                        "loss/FLOPs track with --ledger) as Chrome "
                        "trace-event JSON, for Perfetto")
    g.add_argument("--metrics-port", type=int, default=None, metavar="N",
                   help="serve the obs registry in Prometheus text format "
                        "at GET /metrics on 127.0.0.1:N (0 binds an "
                        "ephemeral port; the bound port is printed)")


def start_metrics(args):
    """The running ``/metrics`` server with ``--metrics-port``, else None."""
    if args.metrics_port is None:
        return None
    srv = obs.serve_metrics(args.metrics_port)
    print(f"[obs] serving /metrics on http://{srv.server_address[0]}:"
          f"{srv.server_address[1]}/metrics", flush=True)
    return srv


def close(args) -> None:
    if args.obs_report:
        print(obs.report())
    led_path = None
    if args.ledger:
        led = obs.detach_ledger()
        if led is not None:
            led_path = led.path
            print(f"[ledger] compute ledger written to {led_path} "
                  f"({led.n_records} records)", flush=True)
    if args.timeline:
        led_src = led_path if led_path and os.path.exists(led_path) else None
        trace = obs.export_chrome_trace(args.timeline, ledger=led_src)
        print(f"[obs] timeline written to {args.timeline} "
              f"({len(trace['traceEvents'])} trace events)")
    if args.obs_log:
        path = obs.close_jsonl()
        print(f"[obs] structured log written to {path}", flush=True)
