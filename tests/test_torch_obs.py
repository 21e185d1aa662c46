"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``) on the CPU.

Exact equality wherever no wall clock is involved:

- the same operations on both registries give the same Prometheus text,
  the same ``report()`` text and the same ``--obs-log`` lines (``pid`` and
  ``unix_time`` of the open line dropped);
- the same records through both ``to_trace_events(pid=1)`` give equal
  event lists;
- span nesting, error records, per-thread parent stacks, the ring bound,
  ``flight_dump`` naming and the disabled mode, as ``tests/test_obs.py``
  holds the JAX package to them, run in both packages to equal records
  (span ids by order, clocks dropped);
- the serving engine and a hop at ``TINY`` in both packages, with chaos at
  each of the four stages: equal sequences of (type, name, thread, parent
  span, error, attr keys, deterministic attrs), compared as multisets for
  ``hang`` (its grow thread and the engine thread interleave), one flight
  dump of the same file name each;
- a smoke trajectory: the same ``traj.*`` / ``ligo.*`` spans in the same
  order and the same histogram counts in both runners.

The wall-clock attributes left out of the comparison are ``t_ms``,
``dur_ms``, ``wall_s``, ``hop_ms``, ``delay_ms``, the watchdog's
``elapsed_s``, and ``cause`` (checked to name the injected stage or the
watchdog); request ``uid``s, process-wide counters, are compared as the
request's position in its engine. Histogram percentiles stay within one
bucket of numpy; both launchers run with the five obs flags on
``--device cpu``, with a loopback scrape of ``/metrics``.
"""
import collections
import itertools
import json
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs                                # noqa: E402
from repro.core import init_ligo_params as jax_init_ligo     # noqa: E402
from repro.core.plan import plan_for as jax_plan_for         # noqa: E402
from repro.models import init_params as jax_init_params      # noqa: E402
from repro.obs import export as jexport                      # noqa: E402
from repro.obs import timeline as jtimeline                  # noqa: E402
from repro.obs import trace as jtrace                        # noqa: E402
from repro.serving import HopController as JaxHop            # noqa: E402
from repro.serving import ServingEngine as JaxEngine         # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch import obs as tobs                          # noqa: E402
from repro_torch.configs.paper_models import BERT_SMALL      # noqa: E402
from repro_torch.launch import serve, train                  # noqa: E402
from repro_torch.obs import export as texport                # noqa: E402
from repro_torch.obs import timeline as ttimeline            # noqa: E402
from repro_torch.obs import trace as ttrace                  # noqa: E402
from repro_torch.serving import HopController, ServingEngine  # noqa: E402
from torch_parity import jax_cfg, to_numpy                   # noqa: E402

TINY = BERT_SMALL.scaled(
    name="srv-tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
    d_head=8, d_ff=64, vocab_size=64, max_seq=64, dtype="float32",
    objective="clm", encoder_only=False, causal=True)
BIG = TINY.scaled(name="srv-big", n_layers=4, d_model=48, d_head=12,
                  d_ff=96)

PKGS = {"jax": (jobs, jtrace, jexport, jtimeline),
        "torch": (tobs, ttrace, texport, ttimeline)}

# attributes that carry a wall clock, or the text of an exception
VOLATILE = {"t_ms", "dur_ms", "wall_s", "hop_ms", "delay_ms", "elapsed_s",
            "cause"}


def _reset():
    for ob, *_ in PKGS.values():
        ob.close_jsonl()
        ob.set_enabled(True)
        ob.set_dump_dir(None)
        ob.FLIGHT.clear()
        ob.REGISTRY.reset()


@pytest.fixture(autouse=True)
def _clean_obs():
    _reset()
    yield
    _reset()


@pytest.fixture
def fresh(monkeypatch):
    """Each package's exports read a fresh registry and a fresh ring (the
    process-wide ones hold whatever other tests registered), and the dump
    sequence starts at 1 in both."""
    out = {}
    for name, (ob, tr, ex, _) in PKGS.items():
        reg, ring = ob.MetricsRegistry(), ob.FlightRecorder()
        for mod in (tr, ex):
            monkeypatch.setattr(mod, "FLIGHT", ring)
        monkeypatch.setattr(ex, "REGISTRY", reg)
        monkeypatch.setattr(tr, "_DUMP_SEQ", itertools.count(1))
        out[name] = (reg, ring)
    return out


def _normalize(records):
    """Records without their clocks; span ids renumbered by first use."""
    ids = {}

    def rid(i):
        if i is None:
            return None
        return ids.setdefault(i, len(ids))

    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in ("t_ms", "dur_ms")}
        if "span_id" in r:
            r["span_id"] = rid(r["span_id"])
        if "parent_id" in r:
            r["parent_id"] = rid(r["parent_id"])
        out.append(r)
    return out


def _both(fn):
    """``fn(obs module)`` run in both packages; the two results."""
    return fn(jobs), fn(tobs)


# ---------------------------------------------------------------------------
# Exports: Prometheus text, the report, the JSONL log, the timeline
# ---------------------------------------------------------------------------
def _metric_ops(ob, reg):
    reg.counter("t.hits").inc(3)
    reg.counter("t.zero")
    reg.gauge("t.depth").set(1.5)
    reg.gauge("t.unset")
    reg.gauge("t.big").set(2.0e12)
    g = reg.counter_group("t.launches")
    g.inc("fwd", 2)
    g.inc("bwd")
    reg.counter_group("t.empty")
    h = reg.histogram("t.lat_ms", buckets=(1.0, 5.0))
    for v in (0.5, 3.0, 100.0, 5.0):
        h.observe(v)
    rng = np.random.RandomState(0)
    for name, buckets, data in (
            ("serve.decode.step_ms", ob.MS_BUCKETS,
             rng.lognormal(1.0, 1.0, 300)),
            ("t.rate", ob.RATE_BUCKETS, rng.uniform(1, 5000, 50)),
            ("t.flops", ob.LOG10_BUCKETS, rng.lognormal(20, 3, 50)),
            ("t.wall_s", ob.S_BUCKETS, rng.uniform(0, 700, 20))):
        hh = reg.histogram(name, buckets)
        for v in data:
            hh.observe(float(v))
    reg.histogram("t.never")


def test_prometheus_text_equals_jax(fresh):
    jreg, treg = fresh["jax"][0], fresh["torch"][0]
    _metric_ops(jobs, jreg)
    _metric_ops(tobs, treg)
    want = jobs.prom.render(jreg)
    got = tobs.prom.render(treg)
    assert got == want
    assert 't_launches_total{key="fwd"} 2' in got
    assert 't_lat_ms_bucket{le="+Inf"} 4' in got and "t_unset" not in got
    assert tobs.prom.sanitize("9a.b-c") == jobs.prom.sanitize("9a.b-c")
    assert treg.snapshot() == jreg.snapshot()
    assert treg.names() == jreg.names()


def _report_ops(ob, reg, ring):
    h = reg.histogram("serve.decode.step_ms")
    for v in (1.0, 2.5, 40.0, 3.0):
        h.observe(v)
    for name in ("serve.request.queue_wait_ms", "serve.request.ttft_ms"):
        reg.histogram(name).observe(12.5)
    reg.histogram("serve.request.tokens_per_s",
                  ob.RATE_BUCKETS).observe(333.0)
    c = reg.counter_group("serve.requests")
    for k, n in (("submitted", 4), ("done", 4), ("dropped", 0),
                 ("deferred", 1)):
        c.inc(k, n)
    reg.gauge("serve.spec.acc_ema").set(0.75)
    reg.gauge("serve.spec.est_speedup").set(1.8)
    reg.gauge("serve.kv.pool_in_use_blocks").set(3)
    reg.gauge("serve.kv.pool_peak_blocks").set(9)
    reg.gauge("serve.kv.pool_total_blocks").set(24)
    for name, t, dur, attrs, err in (
            ("hop.grow", 5.0, 10.25, {"gen": 1, "attempt": 1}, None),
            ("hop.cache-grow", 16.0, 0.01, {"attempt": 1, "live": 2},
             "HopError('boom')"),
            ("hop.grow", 30.0, 9.5, {"gen": 3, "attempt": 2}, None),
            ("hop.cache-grow", 40.0, 2.0,
             {"attempt": 2, "live": 2, "mode": "reprefill"}, None),
            ("hop.swap", 43.0, 0.5, {"attempt": 2, "src": "a", "dst": "b"},
             None),
            ("serve.prefill", 1.0, 0.3, {"slot": 0}, None)):
        rec = {"type": "span", "name": name, "span_id": 1,
               "parent_id": None, "thread": "MainThread", "t_ms": t,
               "dur_ms": dur}
        if err:
            rec["error"] = err
        rec["attrs"] = attrs
        ring.record(rec)
    ring.record({"type": "event", "name": "hop.rollback", "parent_id": None,
                 "thread": "MainThread", "t_ms": 17.0,
                 "attrs": {"stage": "cache-grow", "attempt": 1,
                           "cause": "boom"}})
    for name, v in (("hop.watchdog.budget_s", 2.5),
                    ("hop.watchdog.ewma_s", 0.5),
                    ("hop.watchdog.floor_s", 0.25)):
        reg.gauge(name).set(v)
    for name in ("ligo.chunk_ms", "ligo.checkpoint_ms",
                 "traj.stage.train_ms", "traj.stage.grow_ms"):
        reg.histogram(name).observe(250.0)


def test_report_text_equals_jax(fresh):
    assert tobs.report() == jobs.report()             # both empty
    assert "(no metrics recorded)" in tobs.report()
    for name in PKGS:
        _report_ops(PKGS[name][0], *fresh[name])
    got, want = tobs.report(), jobs.report()
    assert got == want
    for line in ("decode step (through-hop): n=4", "requests: deferred=1",
                 "speculative: acc_ema=0.750", "kv pool: in_use=3",
                 "hop stages:", "ERROR HopError('boom')",
                 "rollback at stage=cache-grow attempt=1: boom",
                 "hop watchdog: ewma=0.50s", "ligo chunk: n=1",
                 "trajectory grow: n=1"):
        assert line in got, line


def test_jsonl_log_equals_jax(fresh, tmp_path):
    """The same records and metrics through both packages' ``--obs-log``
    give the same file, but the open line's pid and clock; a second
    attach is refused, a re-attach after close works."""
    logs = {}
    for name, (ob, *_) in PKGS.items():
        reg, ring = fresh[name]
        path = str(tmp_path / name / "obs.jsonl")
        ob.attach_jsonl(path)
        assert ob.dump_dir() == str(tmp_path / name)
        _report_ops(ob, reg, ring)
        _metric_ops(ob, reg)
        assert ob.close_jsonl() == path
        assert ob.close_jsonl() is None
        lines = [json.loads(line) for line in open(path)]
        assert lines[0]["event"] == "obs-log-open"
        assert lines[-1] == {"type": "meta", "event": "obs-log-close"}
        del lines[0]["pid"], lines[0]["unix_time"]
        logs[name] = lines
        ob.attach_jsonl(str(tmp_path / name / "second.jsonl"))
        with pytest.raises(RuntimeError, match="already attached"):
            ob.attach_jsonl(str(tmp_path / name / "third.jsonl"))
        ob.close_jsonl()
    assert logs["torch"] == logs["jax"]
    metrics = {r["name"]: r for r in logs["torch"]
               if r.get("type") == "metric"}
    assert metrics["t.launches.fwd"] == {"type": "metric",
                                         "name": "t.launches.fwd",
                                         "kind": "counter", "value": 2}
    assert metrics["serve.decode.step_ms"]["count"] == 304


def _span_records():
    """Records of spans and events across threads, nested, with errors,
    hop spans with and without ``gen``, a dump header and a metric line:
    everything ``to_trace_events`` reads or skips."""
    recs = []
    t = 0.0
    for thread in ("MainThread", "hop-grow-1", "MainThread", "hop-grow-3"):
        recs.append({"type": "span", "name": "hop.grow", "span_id": len(recs),
                     "parent_id": None, "thread": thread, "t_ms": t + 1.0,
                     "dur_ms": 5.0, "attrs": {"gen": len(recs), "attempt": 1}})
        recs.append({"type": "span", "name": "serve.prefill",
                     "span_id": len(recs), "parent_id": None,
                     "thread": thread, "t_ms": t, "dur_ms": 20.0,
                     "error": "ValueError('x')", "attrs": {"slot": 1}})
        recs.append({"type": "span", "name": "inner", "span_id": len(recs),
                     "parent_id": 1, "thread": thread, "t_ms": t + 2.0,
                     "dur_ms": 30.0, "attrs": {}})    # drifts past its parent
        recs.append({"type": "span", "name": "hop.swap", "span_id": len(recs),
                     "parent_id": None, "thread": thread, "t_ms": t + 25.0,
                     "dur_ms": 0.004, "attrs": {"attempt": 2}})
        recs.append({"type": "event", "name": "hop.rollback",
                     "parent_id": None, "thread": thread, "t_ms": t + 3.0,
                     "attrs": {"stage": "grow"}})
        t += 7.5
    recs.append({"type": "event", "name": "x", "t_ms": 1.0, "attrs": None})
    recs.append({"type": "dump", "reason": "r", "t_ms": 0.0})
    recs.append({"type": "metric", "name": "m", "kind": "counter",
                 "value": 1})
    return recs


LEDGER = [
    {"type": "step", "wall_ms": 12.5, "loss": 3.0, "cum_flops_modelled": 1e9,
     "cum_flops_measured": 1.1e9},
    {"type": "event", "name": "hop.begin", "attrs": {"stage": 1}},
    {"type": "step", "wall_ms": 7.0, "loss": 2.5, "cum_flops_modelled": 2e9,
     "cum_flops_measured": 2.2e9},
    {"type": "event", "name": "probe"},
]


@pytest.mark.parametrize("ledger", [None, LEDGER], ids=["spans", "ledger"])
def test_trace_events_equal_jax(ledger):
    recs = _span_records()
    want = jtimeline.to_trace_events(recs, pid=1, ledger_records=ledger)
    got = ttimeline.to_trace_events(recs, pid=1, ledger_records=ledger)
    assert got == want
    _assert_balanced(got)


def _assert_balanced(events):
    """Every ``B`` matched by an ``E`` of the same name on its tid, and one
    async ``b``/``e`` pair per hop span."""
    stacks = collections.defaultdict(list)
    for e in events:
        if e["ph"] == "B":
            stacks[e["tid"]].append(e["name"])
        elif e["ph"] == "E":
            assert stacks[e["tid"]].pop() == e["name"]
    assert not any(stacks.values())
    b = [e["name"] for e in events if e["ph"] == "b"]
    assert sorted(b) == sorted(e["name"] for e in events if e["ph"] == "e")
    assert sorted(b) == sorted(e["name"] for e in events
                               if e["ph"] == "B" and e["cat"] == "hop")


def test_export_chrome_trace_and_timeline_cli_equal_jax(tmp_path, capsys):
    """The file ``--timeline`` writes and the offline converter's output,
    from the same obs log and ledger file, equal the JAX package's."""
    log, led = tmp_path / "run.jsonl", tmp_path / "led.jsonl"
    with open(log, "w") as fh:
        fh.write(json.dumps({"type": "meta", "event": "obs-log-open"}) + "\n")
        for r in _span_records():
            fh.write(json.dumps(r) + "\n")
        fh.write("{torn\n")
    with open(led, "w") as fh:
        for r in LEDGER:
            fh.write(json.dumps(r) + "\n")
    out = {}
    for name, (_, _, _, tl) in PKGS.items():
        path = str(tmp_path / name / "trace.json")
        tl._main([str(log), "-o", path, "--ledger", str(led)])
        trace = json.load(open(path))
        for e in trace["traceEvents"]:
            e["pid"] = 1
        out[name] = trace
    assert out["torch"] == out["jax"]
    assert "[timeline] wrote" in capsys.readouterr().out
    recs = _span_records()
    got = ttimeline.export_chrome_trace(records=recs, pid=7,
                                        ledger=tobs.RunLedger(str(led)))
    assert got["displayTimeUnit"] == "ms"
    assert got["traceEvents"] == jtimeline.to_trace_events(
        recs, pid=7, ledger_records=LEDGER)


# ---------------------------------------------------------------------------
# The tracer and the flight recorder, as tests/test_obs.py holds the JAX one
# ---------------------------------------------------------------------------
def _nesting(ob):
    with ob.span("outer", kind="a") as so:
        with ob.span("inner") as si:
            si.attrs["found"] = 42
        ob.event("mid", k=1)
    assert so.dur_ms >= si.dur_ms >= 0
    return _normalize(ob.FLIGHT.events())


def test_span_nesting_parent_child():
    want, got = _both(_nesting)
    assert got == want
    inner, mid, outer = got
    assert inner["parent_id"] == outer["span_id"] == mid["parent_id"]
    assert outer["parent_id"] is None and inner["attrs"] == {"found": 42}


def _failing(ob):
    with pytest.raises(ValueError, match="boom"):
        with ob.span("failing", n=1):
            raise ValueError("boom")
    return _normalize(ob.FLIGHT.events())


def test_span_records_error_and_reraises():
    want, got = _both(_failing)
    assert got == want
    assert list(got[0]) == ["type", "name", "span_id", "parent_id", "thread",
                            "error", "attrs"]
    assert got[0]["error"] == "ValueError('boom')"


def _per_thread(ob):
    done = threading.Barrier(2)

    def work(tag):
        with ob.span(f"root-{tag}"):
            done.wait(timeout=10)      # both roots open at once
            with ob.span(f"leaf-{tag}"):
                pass

    ts = [threading.Thread(target=work, args=(i,), name=f"w{i}")
          for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    spans = {e["name"]: e for e in ob.FLIGHT.events(type="span")}
    return {name: (spans[name]["thread"],
                   None if spans[name]["parent_id"] is None else next(
                       n for n, e in spans.items()
                       if e["span_id"] == spans[name]["parent_id"]))
            for name in spans}


def test_span_stacks_are_per_thread():
    want, got = _both(_per_thread)
    assert got == want
    assert got["leaf-0"] == ("w0", "root-0") and got["root-1"] == ("w1", None)


def _ring(ob):
    rec = ob.FlightRecorder(capacity=8)
    for i in range(20):
        rec.record({"type": "event", "name": f"e{i}"})
    rec.set_sink(lambda ev: 1 / 0)         # a broken sink is ignored
    rec.record({"type": "event", "name": "last"})
    return rec.capacity, rec.events(), rec.events(prefix="e1")


def test_flight_recorder_ring_is_bounded():
    want, got = _both(_ring)
    assert got == want
    assert got[0] == 8 and len(got[1]) == 8
    assert got[1][0]["name"] == "e13" and got[1][-1]["name"] == "last"


@pytest.fixture
def tmp(tmp_path):
    for name in PKGS:
        (tmp_path / name).mkdir()
    return tmp_path


def _dumps(ob, tmp):
    with ob.span("hop.grow", gen=1):
        pass
    path = ob.FLIGHT.dump(str(tmp / "ring.jsonl"), reason="manual")
    ring = [json.loads(line) for line in open(path)]
    assert ob.flight_dump("why") is None       # no dump dir: a no-op
    ob.set_dump_dir(str(tmp))
    p1 = ob.flight_dump("hop-grow")
    p2 = ob.flight_dump("hop cache/grow")
    dumped = [json.loads(line) for line in open(p2)]
    names = [p.rsplit("/", 1)[1] for p in (p1, p2)]
    heads = [{k: v for k, v in d[0].items() if k != "t_ms"}
             for d in (ring, dumped)]
    return names, heads, _normalize(ring[1:]), _normalize(dumped[1:])


def test_dump_and_flight_dump_naming(tmp, monkeypatch):
    for _, tr, _, _ in PKGS.values():
        monkeypatch.setattr(tr, "_DUMP_SEQ", itertools.count(1))
    want = _dumps(jobs, tmp / "jax")
    got = _dumps(tobs, tmp / "torch")
    assert got == want
    names, heads, _, dumped = got
    assert names == ["flightrec-001-hop-grow.jsonl",
                     "flightrec-002-hop-cache-grow.jsonl"]
    assert heads[1] == {"type": "dump", "reason": "hop cache/grow",
                        "n_records": 3, "ring_evicted": 0}
    assert dumped[-1]["name"] == "obs.dump"
    assert dumped[-1]["attrs"] == {"reason": "hop cache/grow"}


def _disabled(ob):
    h = ob.histogram("t.dis_ms")
    g = ob.gauge("t.dis_g")
    c = ob.counter("t.dis_c")
    grp = ob.counter_group("t.dis_group")
    grp.clear()
    ob.set_enabled(False)
    with ob.span("invisible") as sp:
        sp.attrs["x"] = 1              # a writable no-op span
    ob.event("invisible.event")
    h.observe(5.0)
    g.set(3.0)
    c.inc()
    grp.inc("k")                       # counter groups are not gated
    out = (ob.FLIGHT.events(), h.count, g.value, c.value, grp["k"],
           sp.dur_ms, ob.enabled())
    ob.set_enabled(True)
    h.observe(5.0)
    return out + (h.count,)


def test_disabled_mode_records_nothing():
    want, got = _both(_disabled)
    assert got == want == ([], 0, None, 0, 1, None, False, 1)


# ---------------------------------------------------------------------------
# Metrics, as tests/test_obs.py holds the JAX registry
# ---------------------------------------------------------------------------
def test_registry_api_matches_jax():
    def run(ob):
        reg = ob.MetricsRegistry()
        c = reg.counter("t.c")
        c.inc()
        c.inc(4)
        assert reg.counter("t.c") is c
        with pytest.raises(TypeError):
            reg.histogram("t.c")
        reg.gauge("t.g").set(2.5)
        h = reg.histogram("t.h", buckets=(1.0, 2.0, 4.0))
        assert h.buckets == (1.0, 2.0, 4.0) and h.percentile(50) is None
        h.observe(3.0)
        h.observe(100.0)
        snap = reg.snapshot()
        reg.reset()
        c.inc()
        return (snap, reg.names(), reg.get("t.c").value, reg.get("nope"),
                reg.snapshot(), repr(c), repr(h))
    want, got = _both(run)
    assert got == want
    assert got[0]["t.c"] == {"kind": "counter", "value": 5}
    assert got[0]["t.h"]["max"] == 100.0 and got[2] == 1


def test_counter_group_keeps_counter_api():
    def run(ob):
        g = ob.counter_group("t.group")
        g.clear()
        out = [g["missing"]]
        g.inc("fwd")
        g.inc("fwd")
        g.inc("bwd", 3)
        out += [dict(g), sorted(g.keys()), "fwd" in g, "x" in g, len(g),
                g.get("bwd"), g.get("x", 9), sorted(g.items())]
        g["fwd"] = 7
        out += [g["fwd"], g.snapshot(), repr(g)]
        g.reset()
        return out + [dict(g), g["fwd"]]
    want, got = _both(run)
    assert got == want
    assert got[1] == {"fwd": 2, "bwd": 3} and got[9] == 7


def test_histogram_edge_cases():
    def run(ob):
        h = ob.histogram("t.h_edge", buckets=(1.0, 2.0, 4.0))
        h.observe(3.0)
        out = [h.percentile(0), h.percentile(100)]
        h.observe(100.0)
        out += [h.percentile(99), h.snapshot(), h.sum, h.count]
        for bad in ((2.0, 1.0), (1.0, 1.0), (1.0, float("inf"))):
            with pytest.raises(ValueError):
                ob.Histogram("bad", buckets=bad)
        return out
    want, got = _both(run)
    assert got == want
    assert got[0] == got[1] == 3.0 and got[2] <= 100.0


@pytest.mark.parametrize("dist", ["uniform", "lognormal", "bimodal",
                                  "log10_flops"])
def test_histogram_percentiles_match_numpy_within_bucket(dist):
    """Percentiles from buckets within one bucket of numpy's order
    statistics, and equal to the JAX package's histogram."""
    rng = np.random.RandomState(0)
    if dist == "log10_flops":
        data = rng.lognormal(np.log(1e9), 2.0, 4000)
        buckets = tobs.LOG10_BUCKETS
    else:
        if dist == "uniform":
            data = rng.uniform(0.0, 50.0, 4000)
        elif dist == "lognormal":
            data = np.minimum(rng.lognormal(1.5, 0.7, 4000), 49.9)
        else:
            data = np.clip(np.concatenate([rng.normal(5, 1, 2000),
                                           rng.normal(40, 2, 2000)]),
                           0.0, 49.9)
        buckets = tuple(float(i) for i in range(1, 51))
    th = tobs.Histogram("t", buckets)
    jh = jobs.Histogram("t", buckets)
    for v in data:
        th.observe(v)
        jh.observe(v)
    assert th.snapshot() == jh.snapshot()
    for q in (1, 10, 50, 90, 99, 99.9):
        est = th.percentile(q)
        lo = float(np.percentile(data, q, method="lower"))
        hi = float(np.percentile(data, q, method="higher"))
        if dist == "log10_flops":       # one bucket = one 10^0.5 edge ratio
            edge = 10.0 ** 0.5
            assert lo / edge * 0.999 <= est <= hi * edge * 1.001, (q, est)
        else:
            assert lo - 1.0 - 1e-9 <= est <= hi + 1.0 + 1e-9, (q, est)


def test_metric_writes_are_thread_safe():
    """Eight threads with the interpreter switching as often as it can: no
    counter increment or histogram observation is lost."""
    import sys
    c = tobs.counter("t.race_c")
    h = tobs.histogram("t.race_h", buckets=(10.0,))
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def spin():
            for _ in range(1000):
                c.inc()
                h.observe(1.0)
        ts = [threading.Thread(target=spin) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(prev)
    assert c.value == 8000 and h.count == 8000 and h.sum == 8000.0


def test_serve_metrics_endpoint(fresh):
    reg = fresh["torch"][0]
    _metric_ops(tobs, reg)
    srv = tobs.serve_metrics(0, registry=reg)
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            body = r.read().decode()
            ctype = r.headers["Content-Type"]
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/other",
                                   timeout=10)
    finally:
        srv.shutdown()
        srv.server_close()
    assert body == jobs.prom.render(_fill(jobs))
    assert ctype.startswith("text/plain; version=0.0.4")


def _fill(ob):
    reg = ob.MetricsRegistry()
    _metric_ops(ob, reg)
    return reg


def test_profile_gate_on_the_cpu(tmp_path, capsys):
    """No directory: a no-op. A directory, on the CPU: a Chrome trace of
    the block's CPU ops, its path printed; an error in the block still
    writes the trace and propagates."""
    with tobs.profile(None) as path:
        assert path is None
    with tobs.profile(str(tmp_path / "p"), device="cpu") as path:
        torch.ones(8).sum()
    evs = json.load(open(path))["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in evs)
    assert path in capsys.readouterr().out
    with pytest.raises(ValueError):
        with tobs.profile(str(tmp_path / "q"), device="cpu"):
            raise ValueError
    assert len(list((tmp_path / "q").iterdir())) == 1


# ---------------------------------------------------------------------------
# The engine and the hop at TINY, both packages, chaos at every stage
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    jp = jax_init_params(jax_cfg(TINY), jax.random.PRNGKey(0))
    jop = jax_init_ligo(jax.random.PRNGKey(7), jax_cfg(TINY), jax_cfg(BIG))
    # compile the JAX grow once, as tests/test_obs.py does
    jax_plan_for(jax_cfg(TINY), jax_cfg(BIG), jp).executor(mesh=None)(jop, jp)
    return (jp, jop), (bridge.to_torch(to_numpy(jp)),
                       bridge.to_torch(to_numpy(jop)))


def _prompts(n=4):
    rng = np.random.RandomState(0)
    return [list(rng.randint(0, TINY.vocab_size, 4 + i % 4))
            for i in range(n)]


def _keys(records, reqs):
    """(type, name, thread, parent span's name, error, attr keys,
    deterministic attrs) of each span and event record."""
    names = {r["span_id"]: r["name"] for r in records if "span_id" in r}
    uids = {r.uid: i for i, r in enumerate(reqs)}
    out = []
    for r in records:
        attrs = r.get("attrs") or {}
        det = {k: v for k, v in attrs.items() if k not in VOLATILE}
        if "uid" in det:
            det["uid"] = uids[det["uid"]]
        out.append((r["type"], r["name"], r["thread"],
                    names.get(r["parent_id"]), r.get("error"),
                    tuple(sorted(attrs)), tuple(sorted(det.items()))))
    return out


def _hop(make_engine, make_hop, stage, dump_dir):
    eng = make_engine()
    reqs = [eng.submit(p, max_new=16) for p in _prompts()]
    hop = make_hop(eng)
    if stage != "hang":     # a seeded watchdog would judge the hang sooner
        hop.warm()

    def on_step(e):
        if e.decode_steps >= 2 and hop.attempts == 0:
            hop.begin()
        if hop.attempts:
            hop.poll()

    eng.run(on_step=on_step)
    while not hop.poll():
        time.sleep(0.002)
    assert hop.completed and hop.attempts == 2, stage
    assert eng.counts()["dropped"] == 0
    dumps = sorted(p.name for p in dump_dir.iterdir())
    return eng, reqs, dumps


@pytest.mark.parametrize("stage", ["grow", "cache-grow", "swap", "hang"])
def test_engine_and_hop_records_equal_jax(tmp, models, monkeypatch, stage):
    """The hop's retries follow at the next decode step (no backoff), so
    the synchronous grows (after ``warm()``) give the same record order in
    both packages; for ``hang`` the watchdog (2 s, past the engine's last
    step) fires, and the records are compared as multisets."""
    (jp, jop), (tp, top) = models
    bg = stage == "hang"
    hop_kw = dict(fail_at=stage, retries=2, backoff=0.0, background=bg,
                  timeout=2.0 if bg else 120.0)
    runs = {}
    for name, (ob, tr, *_) in PKGS.items():
        monkeypatch.setattr(tr, "_DUMP_SEQ", itertools.count(1))
        ob.set_dump_dir(str(tmp / name))
        ob.FLIGHT.clear()
        if name == "jax":
            eng, reqs, dumps = _hop(
                lambda: JaxEngine(jp, jax_cfg(TINY), slots=2, prompt_budget=8,
                                  gen_budget=16, mesh=None),
                lambda e: JaxHop(e, jax_cfg(BIG), jop, **hop_kw), stage,
                tmp / name)
        else:
            eng, reqs, dumps = _hop(
                lambda: ServingEngine(tp, TINY, slots=2, prompt_budget=8,
                                      gen_budget=16, device="cpu"),
                lambda e: HopController(e, BIG, top, **hop_kw), stage,
                tmp / name)
        ring = ob.FLIGHT.events()
        dump = [json.loads(line) for line in open(tmp / name / dumps[0])]
        runs[name] = (_keys(ring, reqs), dumps, _keys(dump[1:], reqs), ring,
                      dump[0])
    got, want = runs["torch"], runs["jax"]
    assert got[1] == want[1] == [f"flightrec-001-hop-{'grow' if bg else stage}"
                                 f".jsonl"]
    assert got[4]["type"] == "dump" and got[4]["reason"] == want[4]["reason"]
    if bg:
        assert collections.Counter(got[0]) == collections.Counter(want[0])
    else:
        assert got[0] == want[0]
        assert got[2] == want[2]
    ring = got[3]
    (rb,) = [r for r in ring if r["name"] == "hop.rollback"]
    assert rb["attrs"]["stage"] == ("grow" if bg else stage)
    assert ("watchdog" if bg else f"stage {stage!r}") in rb["attrs"]["cause"]
    spans = [r for r in ring if r["type"] == "span"
             and r["name"].startswith("hop.")]
    if bg:
        assert all(r["thread"].startswith("hop-grow-") for r in spans
                   if r["name"] == "hop.grow")
    done = {r["name"]: r for r in spans if r["attrs"].get("attempt") == 2}
    assert done["hop.cache-grow"]["attrs"]["mode"] == "reprefill"
    assert {"hop.grow", "hop.cache-grow", "hop.swap"} <= set(done)
    assert len([r for r in spans if r["name"] == "hop.warm"]) == (not bg)
    n_prefill = len([r for r in ring if r["name"] == "serve.prefill"])
    assert n_prefill == 4


def test_hop_timings_come_from_the_spans(models):
    """``HopController.timings`` reads each stage span's wall; with the
    layer off there is no span, and the walls are None."""
    _, (tp, top) = models
    for on in (True, False):
        tobs.set_enabled(on)
        tobs.FLIGHT.clear()
        eng = ServingEngine(tp, TINY, slots=2, prompt_budget=8, gen_budget=8,
                            device="cpu")
        reqs = [eng.submit(p, max_new=8) for p in _prompts()]
        hop = HopController(eng, BIG, top, background=False)
        hop.warm()
        _hop_run_plain(eng, hop)
        assert all(r.status == "done" for r in reqs)
        spans = {r["name"]: r["dur_ms"] for r in tobs.FLIGHT.events(
            type="span") if r["name"].startswith("hop.")}
        want = {k: spans.get(f"hop.{k}") for k in
                ("warm", "grow", "cache-grow", "swap")}
        assert hop.timings == want
        assert all((v is not None) == on for v in want.values())


def _hop_run_plain(eng, hop):
    def on_step(e):
        if e.decode_steps >= 2 and hop.attempts == 0:
            hop.begin()
        if hop.attempts:
            hop.poll()
    eng.run(on_step=on_step)
    while not hop.poll():
        time.sleep(0.002)
    assert hop.completed


# ---------------------------------------------------------------------------
# A smoke trajectory through both runners
# ---------------------------------------------------------------------------
def test_trajectory_spans_and_histograms_equal_jax(tmp_path):
    from repro import trajectory as jt
    from repro_torch.trajectory import (GrowthSpec, Stage, TrajectoryConfig,
                                        TrajectoryRunner)
    t1 = TINY.scaled(name="tr-wide", n_layers=3, d_model=48, n_heads=6,
                     n_kv_heads=6, d_ff=96)
    traj = TrajectoryConfig(stages=(
        Stage(TINY, 2),
        Stage(t1, 2, GrowthSpec(method="ligo", ligo_steps=2,
                                ligo_scan_chunk=1))),
        batch=2, seq=8, lr=1e-3, checkpoint_every=2)
    jtraj = jt.TrajectoryConfig(
        stages=tuple(jt.Stage(jax_cfg(st.cfg), st.steps,
                              None if st.growth is None else
                              jt.GrowthSpec(**vars(st.growth)))
                     for st in traj.stages),
        batch=traj.batch, seq=traj.seq, lr=traj.lr,
        checkpoint_every=traj.checkpoint_every, seed=traj.seed)
    hists = ("ligo.chunk_ms", "ligo.checkpoint_ms", "traj.stage.train_ms",
             "traj.stage.grow_ms")
    jt.TrajectoryRunner(jtraj, ckpt_dir=str(tmp_path / "j"),
                        verbose=False).run()
    TrajectoryRunner(traj, ckpt_dir=str(tmp_path / "t"), verbose=False,
                     device="cpu").run()
    seqs, counts = {}, {}
    for name, (ob, *_) in PKGS.items():
        seqs[name] = _keys(ob.FLIGHT.events(), [])
        counts[name] = [ob.histogram(h).count for h in hists]
    assert seqs["torch"] == seqs["jax"]
    assert counts["torch"] == counts["jax"] == [2, 1, 2, 1]
    assert [k[1] for k in seqs["torch"]] == [
        "traj.train", "ligo.chunk", "ligo.checkpoint", "ligo.chunk",
        "traj.grow", "traj.train"]


# ---------------------------------------------------------------------------
# Both launchers with the five flags, on the CPU
# ---------------------------------------------------------------------------
def _scrape(res):
    srv = res["metrics_server"]
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.read().decode()
    finally:
        srv.shutdown()
        srv.server_close()


def _read_log(path):
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["event"] == "obs-log-open"
    assert lines[-1]["event"] == "obs-log-close"
    return lines


def test_serve_launcher_obs_flags_on_cpu(tmp_path, capsys):
    d = tmp_path / "obs"
    res = serve.main([
        "--arch", "gpt2-base", "--smoke", "--live-grow-at", "2", "--batch",
        "2", "--prompt-len", "8", "--gen", "6", "--device", "cpu",
        "--fail-at-hop", "cache-grow", "--hop-sync",
        "--obs-log", str(d / "run.jsonl"), "--obs-report",
        "--obs-profile", str(d / "prof"), "--timeline", str(d / "tl.json"),
        "--metrics-port", "0", "--ledger", str(d / "led.jsonl")])
    eng, hop = res["engine"], res["hop"]
    text = _scrape(res)
    assert f"serve_decode_step_ms_count {eng.decode_steps}\n" in text
    out = capsys.readouterr().out
    for line in ("[obs] serving /metrics on http://127.0.0.1:",
                 "[obs] torch profiler trace written to", "[obs] hop stages:",
                 "rollback at stage=cache-grow attempt=1",
                 "[obs] timeline written to", "[obs] structured log written"):
        assert line in out, line
    recs = _read_log(d / "run.jsonl")
    names = [r.get("name") for r in recs if r["type"] in ("span", "event")]
    for name, n in (("hop.warm", 1), ("hop.begin", 1), ("hop.grow", 2),
                    ("hop.cache-grow", 2), ("hop.rollback", 1),
                    ("hop.retry", 1), ("obs.dump", 1), ("hop.swap", 1),
                    ("serve.install", 1), ("hop.complete", 1)):
        assert names.count(name) == n, (name, names)
    pc = eng.prefill_counts
    assert names.count("serve.prefill") == sum(
        n for (_, kind), n in pc.items() if kind == "admit")
    (dump,) = [p for p in d.iterdir() if p.name.startswith("flightrec-")]
    assert dump.name.endswith("-hop-cache-grow.jsonl")
    assert json.loads(open(dump).readline())["type"] == "dump"
    tl = json.load(open(d / "tl.json"))["traceEvents"]
    _assert_balanced(tl)
    assert any(e["ph"] == "i" and e["cat"] == "ledger" for e in tl)
    assert len(list((d / "prof").iterdir())) == 1
    assert hop.timings["grow"] is not None


def test_train_launcher_obs_flags_on_cpu(tmp_path, capsys):
    sched = tmp_path / "traj.json"
    sched.write_text(json.dumps({
        "arch": "gpt2-base", "smoke": True, "batch": 2, "seq": 16,
        "checkpoint_every": 2, "stages": [
            {"steps": 2, "arch": "half"},
            {"steps": 2, "method": "ligo", "ligo_steps": 2,
             "ligo_scan_chunk": 1}]}))
    d = tmp_path / "obs"
    res = train.main([
        "--trajectory", str(sched), "--ckpt-dir", str(tmp_path / "ck"),
        "--device", "cpu", "--ledger", str(d / "led.jsonl"),
        "--obs-log", str(d / "run.jsonl"), "--obs-report",
        "--obs-profile", str(d / "prof"), "--timeline", str(d / "tl.json"),
        "--metrics-port", "0"])
    assert res["status"] == "done"
    text = _scrape(res)
    assert "ligo_chunk_ms_count 2\n" in text
    assert "traj_stage_train_ms_count 2\n" in text
    out = capsys.readouterr().out
    assert "[obs] ligo chunk: n=2" in out and "trajectory grow: n=1" in out
    recs = _read_log(d / "run.jsonl")
    names = [r["name"] for r in recs if r["type"] == "span"]
    assert names == ["traj.train", "ligo.chunk", "ligo.checkpoint",
                     "ligo.chunk", "traj.grow", "traj.train"]
    metrics = {r["name"]: r for r in recs if r["type"] == "metric"}
    assert metrics["ligo.checkpoint_ms"]["count"] == 1
    tl = json.load(open(d / "tl.json"))["traceEvents"]
    _assert_balanced(tl)
    assert sum(e["ph"] == "C" and e["name"] == "ledger.loss"
               for e in tl) == 6            # 4 train + 2 LiGO steps
