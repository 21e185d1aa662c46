"""The live hop: grow the serving model without dropping a session (the
port of the JAX package's ``serving/hotswap.py``).

Stage machine (driven by :meth:`HopController.poll` between decode steps):

1. **grow**: materialise the grown params double-buffered through the
   port's ``GrowthPlan`` (kernel K1 on the card). Runs in a background
   thread by default, so the old weights keep decoding; a ``HopWatchdog``
   aborts a stuck grow.
2. **cache-grow**: migrate live sessions' decode state: in place via
   ``core.grow_cache`` when the operator is LEMON-lossless (bit-exact),
   by replaying only the new layers for a depth-append hop, otherwise by
   re-prefilling each session's token history under the grown weights
   (exact by construction; kernel K3 on the card). A recurrent family's
   state (xLSTM, the Mamba2 hybrid) always re-prefills, each history at
   its true length.
3. **swap**: ``engine.install`` flips the serving buffers between two
   decode steps; then the pre-hop model, with its live decode state, is
   handed to the engine as a speculative-decoding drafter
   (``engine.adopt_drafter``, a no-op unless the engine has ``spec_k > 0``).

Nothing touches the engine before stage 3, so any failure rolls back by
discarding buffers: the engine keeps decoding the old weights and zero
admitted requests are dropped. Failures retry (bounded, exponential
backoff); ``fail_at`` injects a one-shot chaos failure at a named stage
("grow" / "cache-grow" / "swap", or "hang" to wedge the grow thread and
exercise the watchdog). Every rollback's stage and cause is kept in
:attr:`HopController.rollbacks`, so a caller can tell an injected failure
from a real one.

**The background grow on the card.** Grad mode and the current CUDA stream
are per thread in PyTorch. The grow thread enters ``torch.no_grad()``
itself and launches on a side stream of its own (K1 launches on the
current stream), so it does not serialise with decode on the engine's
stream. It first waits for the engine stream's queued work, then waits
for its own work to finish before it publishes the grown tree, and marks
every grown tensor as used on the engine's stream (``record_stream``), so
that the caching allocator cannot hand the memory back to the side stream
while decode still reads it.

**The grow as one CUDA graph.** The reference's ``warm()`` compiles the
grow, so its live hop pays one dispatch of a compiled executable. The
port's counterpart: on the card :meth:`HopController.warm` captures the
grow into a ``torch.cuda.CUDAGraph`` on the side stream, in the engine
thread, and the live hop's grow is one replay of it (one launch, then the
device time), which is also what ``warm()`` times to seed the watchdog.
The graph reads the engine's parameters and the operator in place and
writes the grown tree into its private memory pool: :meth:`begin`
recaptures if the engine's leaves are no longer the captured ones, a lock
serialises replays (a replay never starts for an aborted attempt, so a
watchdog-orphaned grow thread cannot write over a tree in use), and the
graph is dropped once the hop completes or gives up, the grown tree
staying valid as the engine's weights. A capture or a replay that fails
raises: nothing falls back to the eager grow. On the CPU, and in a
controller that was never warmed, the grow runs eagerly.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.grow_cache import (CacheGrowthError, can_grow_cache,
                                         depth_replay_plan, grow_decode_state,
                                         is_lossless_operator,
                                         replay_grow_state)
from repro_torch.core.plan import plan_for
from repro_torch.kernels import ops
from repro_torch.serving.engine import RECURRENT
from repro_torch.serving.kv_pages import paged_supported
from repro_torch.tree import tree_leaves

STAGES = ("grow", "cache-grow", "swap")


def _ledger_event(name: str, **attrs) -> None:
    """Mirror a hop lifecycle event into the attached compute ledger (if
    any), so the durable loss-vs-FLOPs record shows *where* the hops and
    rollbacks landed between the step records. No-op without a ledger."""
    led = obs.active_ledger()
    if led is not None:
        led.record_event(name, **attrs)


def refuse_recurrent_cache_mode(cfg1: ModelConfig, cfg2: ModelConfig,
                                cache_mode: str) -> None:
    """A recurrent state (xLSTM, the Mamba2 hybrid) migrates by re-prefill
    only: no rule grows it in place (``can_grow_cache``), and a hop's
    depth blend is no depth-append whose old layers' state could be kept
    (``depth_replay_plan``)."""
    if cache_mode not in ("grow", "replay"):
        return
    fams = {cfg1.family, cfg2.family} & set(RECURRENT)
    if not fams:
        return
    why = ("core.grow_cache.can_grow_cache: no in-place growth rule for a "
           "recurrent state" if cache_mode == "grow" else
           "core.grow_cache.depth_replay_plan: no new-layer replay over a "
           "recurrent state")
    raise ValueError(
        f"cache_mode={cache_mode!r}: {cfg1.name} -> {cfg2.name} carries the "
        f"recurrent family {sorted(fams)[0]!r} ({why}); its state migrates "
        f"by re-prefill, cache_mode 'auto' or 'reprefill' (ROADMAP.md, 'the "
        f"other families, e: the engine for recurrent families')")


class HopError(RuntimeError):
    """A hop stage failed (injected or real); the hop rolls back."""


class _GrowGraph(NamedTuple):
    """A grow captured by :meth:`HopController._capture`: the graph, the
    grown tree each replay writes, the kernel launches it holds, and the
    engine leaves it reads (:meth:`HopController._leaf_keys`)."""
    graph: Any                  # torch.cuda.CUDAGraph
    out: Any
    launches: ops.GraphLaunches
    inputs: Tuple


@dataclass
class HopWatchdog:
    """Deadline for the grow stage, tightened by what hops actually cost: an
    EWMA of observed durations sets the abort threshold, bounded by a hard
    ``timeout``.

    ``seed`` primes the EWMA *before the first hop* with the grow wall time
    measured at engine start (``HopController.warm``) and raises ``floor``
    to that measurement, so a cold watchdog does not judge the first live
    hop against a bare ``timeout``.
    """
    timeout: float = 120.0
    mult: float = 5.0
    alpha: float = 0.5
    ewma: Optional[float] = None
    floor: float = 0.0

    def budget(self) -> float:
        if self.ewma is None:
            return max(self.floor, self.timeout)
        return max(self.floor,
                   min(self.timeout, max(0.05, self.mult * self.ewma)))

    def observe(self, dt: float) -> None:
        self.ewma = dt if self.ewma is None else (
            self.alpha * dt + (1 - self.alpha) * self.ewma)
        self.publish()

    def seed(self, dt: float) -> None:
        """Prime a cold watchdog with a measured (or configured) first-hop
        cost. No-op once real observations exist."""
        self.floor = max(self.floor, dt)
        if self.ewma is None:
            self.ewma = dt
        self.publish()

    def publish(self) -> None:
        """Expose EWMA, deadline and floor as gauges."""
        if self.ewma is not None:
            obs.gauge("hop.watchdog.ewma_s").set(self.ewma)
        obs.gauge("hop.watchdog.budget_s").set(self.budget())
        obs.gauge("hop.watchdog.floor_s").set(self.floor)


class HopController:
    """Drives one live hop ``engine.cfg -> cfg2`` with operator ``ligo``.

    ``begin()`` launches the grow; the engine's step loop calls ``poll()``
    between decode steps, which advances the stage machine and performs
    cache migration + swap synchronously once the grown buffer is ready.
    ``cache_mode``: "auto" grows the cache in place iff the operator is
    provably lossless, replays only the new layers for a depth-only hop
    (when the engine kept the residual stream), else re-prefills;
    "grow"/"replay"/"reprefill" force a path. A hop from or to a
    recurrent family takes "reprefill" under "auto" and refuses "grow" and
    "replay" (:func:`refuse_recurrent_cache_mode`). The grow and the
    migration take the engine's ``use_kernel`` route.

    ``timings`` holds the last attempt's stage walls in ms, read from the
    stage spans' ``dur_ms`` (``grow``: the ``hop.grow`` span in the grow
    thread; ``cache-grow``; ``swap``) and ``warm``'s; a wall is None while
    the observability layer is switched off. ``warm_ms`` holds the parts
    of ``warm()``'s wall (host clock): ``fill`` (the untimed first grow),
    ``capture`` (on the card only) and ``seed`` (the timed replay, or the
    timed grow on the CPU), and ``seeded_budget_s`` the budget it seeded.
    ``captures`` counts the grow's captures.
    ``rollbacks`` keeps each rollback's stage and cause.

    Spans and events (the JAX package's names and attributes): ``hop.warm``,
    ``hop.begin``, ``hop.grow`` (opened in the thread that runs the grow, so
    a background grow is recorded under ``hop-grow-N``), ``hop.cache-grow``
    (its ``mode`` written into its attrs), ``hop.swap``, ``hop.complete``;
    ``hop.rollback``, ``hop.retry``, ``hop.giveup`` and
    ``hop.watchdog_fire`` on failure, and a flight-recorder dump
    (``obs.flight_dump("hop-<stage>")``) on every rollback.
    """

    def __init__(self, engine, cfg2: ModelConfig, ligo, *,
                 cache_mode: str = "auto", fail_at: Optional[str] = None,
                 retries: int = 2, backoff: float = 0.05,
                 timeout: float = 120.0, background: bool = True,
                 watchdog_floor: float = 0.0):
        if cache_mode not in ("auto", "grow", "replay", "reprefill"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        if fail_at not in (None, "hang") + STAGES:
            raise ValueError(f"unknown chaos stage {fail_at!r}")
        refuse_recurrent_cache_mode(engine.cfg, cfg2, cache_mode)
        if fail_at == "hang" and not background:
            raise ValueError("fail_at='hang' wedges the grow thread until "
                             "the watchdog aborts it: it needs a background "
                             "grow")
        self.engine = engine
        self.cfg2 = cfg2
        self.ligo = ligo
        self.cache_mode = cache_mode
        self.fail_at = fail_at
        self.retries = retries
        self.backoff = backoff
        self.background = background
        self.watchdog = HopWatchdog(timeout=timeout, floor=watchdog_floor)
        self.attempts = 0
        self.completed = False
        self.failed = False
        self.cache_path: Optional[str] = None
        self.begin_at_step: Optional[int] = None
        self.swap_at_step: Optional[int] = None
        self.hop_ms: Optional[float] = None
        self.timings = {}
        self.rollbacks: List[Tuple[str, BaseException]] = []
        self._gen = 0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._buf = None
        self._err: Optional[BaseException] = None
        self._abort = threading.Event()
        self._retry_at: Optional[float] = None
        self._t_begin: Optional[float] = None
        self._t_launch: Optional[float] = None
        dev = engine.device
        self._cuda = dev.type == "cuda"
        # the engine's stream (the current one of the thread that made the
        # controller) and the grow's own
        self._main_stream = (torch.cuda.current_stream(dev) if self._cuda
                             else None)
        self._side_stream = torch.cuda.Stream(dev) if self._cuda else None
        # what a grow derives from the operator alone, kept by warm() for
        # the live grows (GrowthPlan.apply's ``cache``)
        self._grow_cache = {}
        # the grow captured by warm() on the card; once one was captured,
        # every grow is a replay, under the replay lock
        self._graph: Optional[_GrowGraph] = None
        self._replay_lock = threading.Lock()
        self.captures = 0
        self.warm_ms = {}
        self.seeded_budget_s: Optional[float] = None

    # -- chaos ---------------------------------------------------------------
    def _chaos(self, stage: str) -> None:
        if self.fail_at == stage:
            self.fail_at = None        # one-shot: the retry gets through
            raise HopError(f"injected failure at hop stage {stage!r}")

    # -- stage 1: grow (double-buffered, optionally backgrounded) -----------
    def _side(self):
        if not self._cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._side_stream)

    def _build_kernels(self) -> None:
        """Compile the kernels in the engine thread, before any grow thread
        runs: a first build inside the grow would stall it for as long as
        nvcc runs, and the watchdog would judge that stall."""
        if self._cuda and self.engine.use_kernel is not False:
            from repro_torch.kernels import _build
            _build.build()

    def _grow_once(self):
        """One grow on the side stream, finished on the device before it
        returns; safe to call from any thread."""
        eng = self.engine
        with torch.no_grad(), self._side():
            if self._cuda:
                self._side_stream.wait_stream(self._main_stream)
            plan = plan_for(eng.cfg, self.cfg2, eng.params)
            grown = plan.apply(self.ligo, eng.params,
                               use_kernel=eng.use_kernel,
                               cache=self._grow_cache)
            if self._cuda:
                done = torch.cuda.Event()
                done.record(self._side_stream)
                done.synchronize()
        if self._cuda:
            for leaf in tree_leaves(grown):
                leaf.record_stream(self._main_stream)
        return grown

    def _leaf_keys(self) -> Tuple:
        """Where and how the engine's leaves lie: a graph that read them
        reads the same values while this is unchanged."""
        return tuple((t.data_ptr(), t.dtype, tuple(t.shape), t.stride())
                     for t in tree_leaves(self.engine.params))

    def _capture(self) -> None:
        """Capture the grow into a CUDA graph on the side stream, in the
        calling (engine) thread (``warm()`` first warms the path with an
        eager grow). Mode ``thread_local``: a CUDA call unsafe during a capture fails in
        this thread only, so the metrics server's and the profiler's
        threads go on. The launches the grow makes are tallied, not
        counted (``ops.capture_launches``)."""
        eng = self.engine
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), ops.capture_launches() as launches:
            with torch.cuda.graph(graph, stream=self._side_stream,
                                  capture_error_mode="thread_local"):
                out = plan_for(eng.cfg, self.cfg2, eng.params).apply(
                    self.ligo, eng.params, use_kernel=eng.use_kernel,
                    cache=self._grow_cache)
        self._graph = _GrowGraph(graph, out, launches, self._leaf_keys())
        self.captures += 1

    def _drop_graph(self) -> None:
        """Release the graph (its pool frees once the tree it wrote is no
        longer referenced); a grow after this raises."""
        with self._replay_lock:
            self._graph = None

    def _replay(self, abort: threading.Event):
        """One replay of the captured grow on the side stream, finished on
        the device, as :meth:`_grow_once` finishes a grow; returns the tree
        the graph writes. Replays are serialised, and none starts for an
        aborted attempt or after the graph was dropped."""
        with self._replay_lock:
            g = self._graph
            if g is None or abort.is_set():
                raise HopError("grow aborted before its replay")
            with self._side():
                self._side_stream.wait_stream(self._main_stream)
                g.graph.replay()
                ops.count_replay(g.launches)
                done = torch.cuda.Event()
                done.record(self._side_stream)
                done.synchronize()
        for leaf in tree_leaves(g.out):
            leaf.record_stream(self._main_stream)
        return g.out

    def _stage_grow(self, abort: threading.Event):
        self._chaos("grow")
        if self.fail_at == "hang":     # wedge until the watchdog aborts us
            self.fail_at = None
            abort.wait()
            raise HopError("grow thread aborted by watchdog")
        if self.captures:
            return self._replay(abort)
        return self._grow_once()

    def warm(self) -> float:
        """Warm the grow path at engine start (off the hop path,
        chaos-free) and seed the watchdog with the wall of a grow as the
        live hop will run it, so the first *live* hop is judged against a
        measured budget. First an untimed eager grow: it builds and loads
        the kernels, sets their shared-memory attributes, fills the grow
        cache and makes cuBLAS's and the allocator's first-use
        initialisations, the warm-up PyTorch asks for before a capture. On
        the card the grow is then captured into a CUDA graph (the
        reference's compiled grow executor), and one replay, timed, seeds
        the watchdog; on the CPU a second grow, timed, seeds it. All three
        lie in one ``hop.warm`` span. A controller never warmed grows
        eagerly at the hop, paying the first grow's one-time work there,
        as the reference pays its first trace."""
        self._build_kernels()
        steps = [("fill", self._grow_once)]
        if self._cuda:
            steps += [("capture", self._capture),
                      ("seed", lambda: self._replay(threading.Event()))]
        else:
            steps.append(("seed", self._grow_once))
        self.warm_ms = {}
        with obs.span("hop.warm", src=self.engine.cfg.name,
                      dst=self.cfg2.name) as sp:
            for name, step in steps:
                t0 = time.perf_counter()
                step()
                self.warm_ms[name] = (time.perf_counter() - t0) * 1e3
        dt = self.warm_ms["seed"] / 1e3
        self.timings["warm"] = sp.dur_ms
        self.watchdog.seed(dt)
        self.seeded_budget_s = self.watchdog.budget()
        print(f"[hop] warmed grow path: "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in self.warm_ms.items())
              + f" (seed: a timed {'replay' if self._cuda else 'grow'}; "
              f"watchdog budget {self.watchdog.budget():.3f}s)")
        return dt

    def _launch(self) -> None:
        self.attempts += 1
        self._gen += 1
        gen = self._gen
        self._buf, self._err = None, None
        self._retry_at = None
        self._abort = threading.Event()
        abort = self._abort
        attempt = self.attempts
        self._t_launch = time.perf_counter()

        def grow_traced():
            # the span opens in whichever thread runs the grow, so the
            # record names the background thread beside the stage wall
            with obs.span("hop.grow", gen=gen, attempt=attempt) as sp:
                grown = self._stage_grow(abort)
            return grown, sp.dur_ms

        if not self.background:
            try:
                buf = grow_traced()
                with self._lock:
                    self._buf = buf
            except Exception as e:                     # noqa: BLE001
                # any grow failure rolls the hop back; poll() records it
                with self._lock:
                    self._err = e
            return

        def run():
            try:
                buf = grow_traced()
                with self._lock:
                    if gen == self._gen:
                        self._buf = buf
            except Exception as e:                     # noqa: BLE001
                with self._lock:
                    if gen == self._gen:
                        self._err = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"hop-grow-{gen}")
        self._thread.start()

    def begin(self) -> None:
        eng = self.engine
        print(f"[hop] beginning live hop {eng.cfg.name} -> {self.cfg2.name} "
              f"({'background' if self.background else 'synchronous'} grow, "
              f"{len(eng.live)} live sessions)")
        obs.event("hop.begin", src=eng.cfg.name, dst=self.cfg2.name,
                  live=len(eng.live), background=self.background)
        _ledger_event("hop.begin", src=eng.cfg.name, dst=self.cfg2.name,
                      live=len(eng.live))
        self._build_kernels()
        if self._graph is not None and \
                self._graph.inputs != self._leaf_keys():
            self._drop_graph()
            t0 = time.perf_counter()
            self._capture()
            print(f"[hop] the engine's params changed since the grow was "
                  f"captured: recaptured in "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        self._t_begin = time.perf_counter()
        self.begin_at_step = eng.decode_steps
        self._launch()

    # -- stages 2+3, failure handling (engine thread) ------------------------
    def _fail(self, stage: str, err: BaseException) -> None:
        eng = self.engine
        with self._lock:
            self._gen += 1             # orphan any in-flight grow thread
            self._buf, self._err = None, None
        self._abort.set()
        self.rollbacks.append((stage, err))
        print(f"[hop] hop FAILED at stage={stage}: {err!r}; rolled back — "
              f"engine keeps serving {eng.cfg.name} "
              f"({len(eng.live)} in-flight sessions intact, 0 dropped)")
        obs.event("hop.rollback", stage=stage, cause=str(err),
                  attempt=self.attempts, gen=self._gen,
                  wall_s=round(time.perf_counter() - (self._t_begin or 0), 3),
                  live=len(eng.live), dropped=0)
        _ledger_event("hop.rollback", stage=stage, cause=str(err),
                      attempt=self.attempts, dropped=0)
        if self.attempts <= self.retries:
            delay = self.backoff * (2 ** (self.attempts - 1))
            self._retry_at = time.perf_counter() + delay
            print(f"[hop] retrying hop in {delay * 1e3:.0f} ms "
                  f"(attempt {self.attempts + 1}/{self.retries + 1})")
            obs.event("hop.retry", attempt=self.attempts + 1,
                      of=self.retries + 1, delay_ms=round(delay * 1e3, 1))
        else:
            self.failed = True
            self._drop_graph()
            print(f"[hop] giving up after {self.attempts} attempts; "
                  f"engine continues on {eng.cfg.name}")
            obs.event("hop.giveup", attempts=self.attempts)
        # every rollback leaves a dump (a no-op without a dump directory)
        obs.flight_dump(f"hop-{stage}")

    def _migrate_state(self, grown):
        self._chaos("cache-grow")
        eng = self.engine
        if eng.kv_layout == "paged" and not paged_supported(self.cfg2):
            raise CacheGrowthError(
                f"{self.cfg2.name}: paged KV unsupported by the target "
                "architecture; serve with kv_layout='dense' to hop there")
        mode = self.cache_mode
        if mode == "auto":
            if (can_grow_cache(eng.cfg, self.cfg2)
                    and is_lossless_operator(self.ligo, eng.cfg, self.cfg2)):
                mode = "grow"
            elif (depth_replay_plan(self.ligo, eng.cfg, self.cfg2)
                    is not None and eng.replay_ready()):
                mode = "replay"
            else:
                mode = "reprefill"
        with torch.no_grad():
            if mode == "grow":
                state = grow_decode_state(eng.state, self.ligo, eng.cfg,
                                          self.cfg2)
            elif mode == "replay":
                if depth_replay_plan(self.ligo, eng.cfg, self.cfg2) is None:
                    raise CacheGrowthError(
                        "cache_mode='replay': the operator is not a "
                        "depth-append (identity width + identity-prefix "
                        "depth)")
                if not eng.replay_ready():
                    raise CacheGrowthError(
                        "cache_mode='replay': the engine has no complete "
                        "residual stream for the live slots")
                state = replay_grow_state(eng.state, grown, eng.cfg,
                                          self.cfg2, eng.resid,
                                          use_kernel=eng.use_kernel)
            else:
                state = eng.reprefill_state(grown, self.cfg2)
        if self._cuda:
            torch.cuda.synchronize(eng.device)
        return state, mode

    def poll(self) -> bool:
        """Advance the hop between decode steps; True once settled
        (completed or given up)."""
        if self.completed or self.failed:
            return True
        if self._t_launch is None:     # begin() not called yet
            return False
        if self._retry_at is not None:
            if time.perf_counter() < self._retry_at:
                return False
            self._launch()
        with self._lock:
            buf, err = self._buf, self._err
        if err is not None:
            self._fail("grow", err)
            return self.failed
        if buf is None:
            elapsed = time.perf_counter() - self._t_launch
            if elapsed > self.watchdog.budget():
                obs.event("hop.watchdog_fire",
                          budget_s=round(self.watchdog.budget(), 3),
                          elapsed_s=round(elapsed, 3),
                          attempt=self.attempts)
                self._fail("grow", HopError(
                    f"watchdog: grow stage exceeded "
                    f"{self.watchdog.budget():.2f}s budget"))
            return self.failed
        grown, grow_ms = buf
        self.timings["grow"] = grow_ms
        self.watchdog.observe(time.perf_counter() - self._t_launch)
        eng = self.engine
        old_name = eng.cfg.name
        live = len(eng.live)
        try:
            with obs.span("hop.cache-grow", attempt=self.attempts,
                          live=live) as sp_cache:
                state, mode = self._migrate_state(grown)
                sp_cache.attrs["mode"] = mode
        except (HopError, CacheGrowthError) as e:
            self._fail("cache-grow", e)
            return self.failed
        self.timings["cache-grow"] = sp_cache.dur_ms
        old = (eng.cfg, eng.params, eng.state)
        try:
            with obs.span("hop.swap", attempt=self.attempts,
                          src=old_name, dst=self.cfg2.name) as sp_swap:
                self._chaos("swap")
                eng.install(self.cfg2, grown, state)
        except HopError as e:
            self._fail("swap", e)
            return self.failed
        self.timings["swap"] = sp_swap.dur_ms
        drafting = eng.adopt_drafter(*old)
        self.completed = True
        self._drop_graph()
        self.cache_path = mode
        self.swap_at_step = eng.decode_steps
        self.hop_ms = (time.perf_counter() - self._t_begin) * 1e3
        obs.histogram("hop.total_ms").observe(self.hop_ms)
        obs.event("hop.complete", src=old_name, dst=self.cfg2.name,
                  hop_ms=round(self.hop_ms, 1), cache=mode, live=live,
                  attempt=self.attempts, of=self.retries + 1)
        _ledger_event("hop.complete", src=old_name, dst=self.cfg2.name,
                      cache=mode, attempt=self.attempts)
        wd = self.watchdog
        print(f"[hop] hop complete: {old_name} -> {self.cfg2.name} in "
              f"{self.hop_ms:.1f} ms (cache: {mode}, {live} live sessions "
              f"migrated, attempt {self.attempts}/{self.retries + 1}) | "
              f"watchdog ewma {wd.ewma:.2f}s budget {wd.budget():.2f}s "
              f"floor {wd.floor:.2f}s")
        if drafting:
            print(f"[spec] drafter resident: {old_name} drafts "
                  f"K={eng.spec_k} tokens/round for {self.cfg2.name} "
                  f"to verify")
        return True
