"""The port's live serving engine against the JAX package's (``mesh=None``)
on the CPU, with bridged params and operators at the reference tests'
sizes (``tests/test_serving.py``'s TINY, WIDE, BIG; float32).

- The engine's tokens equal the JAX engine's, request for request, greedy
  for both KV layouts (also on a RoPE + GQA config), and sampled with
  ``temperature=0.8, top_p=0.9`` at a fixed seed; paged equals dense
  inside the port.
- Hops: a LEMON hop takes the in-place cache path and its migrated cache
  equals JAX's (<= 1e-6); a LiGO hop re-prefills and its tokens equal the
  JAX hop's, which swaps at the same decode step; a depth-only hop replays
  the new layers as JAX's does.
- Chaos at every stage rolls back and the retry lands with 0 dropped; the
  give-up case ends on the old architecture; the watchdog's budget follows
  the reference's; ``warm()``'s seed leaves out its first grow's one-time
  work, and a controller never warmed grows eagerly; ``serve
  --live-grow-at`` prints its report on the CPU and raises without
  ``--device cpu``.
"""
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import init_ligo_params as jax_init_ligo     # noqa: E402
from repro.core.grow_cache import (grow_decode_state as jax_grow_state,  # noqa: E402
                                   is_lossless_operator as jax_lossless)
from repro.core.operators import lemon_operator as jax_lemon  # noqa: E402
from repro.core.operators import stackbert_operator as jax_stack  # noqa: E402
from repro.models import init_params as jax_init_params      # noqa: E402
from repro.serving import HopController as JaxHop            # noqa: E402
from repro.serving import HopWatchdog as JaxWatchdog         # noqa: E402
from repro.serving import ServingEngine as JaxEngine         # noqa: E402
from repro.serving import speculative as jspec               # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.configs import get_config, smoke_config     # noqa: E402
from repro_torch.configs.paper_models import BERT_SMALL      # noqa: E402
from repro_torch.core.grow_cache import (CacheGrowthError,   # noqa: E402
                                         can_grow_cache, grow_decode_state,
                                         is_lossless_operator)
from repro_torch.core.operators import lemon_operator        # noqa: E402
from repro_torch.launch import serve                         # noqa: E402
from repro_torch.serving import (HopController, HopError,    # noqa: E402
                                 HopWatchdog, ServingEngine)
from repro_torch.serving import speculative as tspec         # noqa: E402
from torch_parity import jax_cfg, to_numpy                   # noqa: E402

TINY = BERT_SMALL.scaled(
    name="srv-tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
    d_head=8, d_ff=64, vocab_size=64, max_seq=64, dtype="float32",
    objective="clm", encoder_only=False, causal=True)
# lemon-compatible target: width-only (heads + ffn), MHA on both sides
WIDE = TINY.scaled(name="srv-wide", n_heads=8, n_kv_heads=8, d_ff=96)
# general LiGO target (depth + width): cache migration must re-prefill
BIG = TINY.scaled(name="srv-big", n_layers=4, d_model=48, d_head=12,
                  d_ff=96)
# depth-only target: the new layers replay over the kept residual stream
DEEP = TINY.scaled(name="srv-deep", n_layers=4)
# RoPE, GQA, RMSNorm, SwiGLU
ROPE = smoke_config(get_config("llama3-8b"))

GEN = 12


def _jax_params(cfg, seed=0):
    return jax_init_params(jax_cfg(cfg), jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def jparams():
    return _jax_params(TINY)


@pytest.fixture(scope="module")
def tparams(jparams):
    return bridge.to_torch(to_numpy(jparams))


def _prompts(cfg, n=4):
    rng = np.random.RandomState(0)
    return [list(rng.randint(0, cfg.vocab_size, 4 + i % 4)) for i in range(n)]


def _port_engine(params, cfg, gen=GEN, **kw):
    eng = ServingEngine(params, cfg, slots=2, prompt_budget=8,
                        gen_budget=gen, device="cpu", **kw)
    reqs = [eng.submit(p, max_new=gen) for p in _prompts(cfg)]
    return eng, reqs


def _jax_engine(params, cfg, gen=GEN, **kw):
    eng = JaxEngine(params, jax_cfg(cfg), slots=2, prompt_budget=8,
                    gen_budget=gen, mesh=None, **kw)
    reqs = [eng.submit(p, max_new=gen) for p in _prompts(cfg)]
    return eng, reqs


def _drain(eng, reqs):
    eng.run()
    assert all(r.status == "done" for r in reqs)
    return [list(r.tokens) for r in reqs]


# ---------------------------------------------------------------------------
# The engine alone
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [TINY, ROPE], ids=["learned-pos", "rope-gqa"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_engine_greedy_tokens_match_jax(cfg, layout):
    jp = _jax_params(cfg)
    tp = bridge.to_torch(to_numpy(jp))
    want = _drain(*_jax_engine(jp, cfg, kv_layout=layout))
    eng, reqs = _port_engine(tp, cfg, kv_layout=layout)
    assert _drain(eng, reqs) == want
    assert eng.kv_layout == layout and eng.counts()["dropped"] == 0


def test_engine_sampled_tokens_match_jax(jparams, tparams):
    kw = dict(temperature=0.8, top_p=0.9, seed=3)
    want = _drain(*_jax_engine(jparams, TINY, **kw))
    got = _drain(*_port_engine(tparams, TINY, **kw))
    assert got == want
    greedy = _drain(*_port_engine(tparams, TINY))
    assert got != greedy                   # the sampler really sampled


def test_sampling_primitives_match_jax():
    rng = np.random.RandomState(5)
    for _ in range(5):
        logits = rng.randn(64).astype(np.float32) * 3
        for t, p in ((0.8, 0.9), (1.0, 1.0), (0.5, 0.3)):
            np.testing.assert_array_equal(tspec.adjust_probs(logits, t, p),
                                          jspec.adjust_probs(logits, t, p))
    assert (tspec.philox(3, 1, 7).integers(0, 1 << 30, 4).tolist()
            == jspec.philox(3, 1, 7).integers(0, 1 << 30, 4).tolist())


def test_paged_and_dense_tokens_equal(tparams):
    paged = _drain(*_port_engine(tparams, TINY, kv_layout="paged"))
    dense = _drain(*_port_engine(tparams, TINY, kv_layout="dense"))
    assert paged == dense


def test_admission_control(tparams):
    eng = ServingEngine(tparams, TINY, slots=2, prompt_budget=8,
                        gen_budget=4, queue_capacity=3, device="cpu")
    over = eng.submit(list(range(20)), max_new=4)    # prompt > budget
    assert over.status == "rejected"
    reqs = [eng.submit([1, 2, 3], max_new=4) for _ in range(5)]
    assert sum(r.status == "rejected" for r in reqs) == 2   # queue cap 3
    eng.run()
    c = eng.counts()
    assert c["done"] == 3 and c["rejected"] == 3 and c["dropped"] == 0


def test_engine_refuses_what_is_not_ported(tparams):
    with pytest.raises(ValueError, match="lie on cpu"):
        ServingEngine(tparams, TINY, device="meta")
    win = TINY.scaled(name="srv-win", window=4)
    with pytest.warns(UserWarning, match="paged KV layout unsupported"):
        eng = ServingEngine(tparams, win, slots=2, prompt_budget=8,
                            gen_budget=4, device="cpu")
    assert eng.kv_layout == "dense" and eng.kv_fallback


# ---------------------------------------------------------------------------
# Cache growth rules
# ---------------------------------------------------------------------------
def test_lossless_detector_matches_jax(jparams):
    jl = jax_init_ligo(jax.random.PRNGKey(0), jax_cfg(TINY), jax_cfg(WIDE))
    for jop, cfg2 in ((jl, WIDE), (jax_lemon(jax_cfg(TINY), jax_cfg(WIDE)),
                                   WIDE),
                      (jax_stack(jax_cfg(TINY), jax_cfg(DEEP)), DEEP)):
        top = bridge.to_torch(to_numpy(jop))
        assert (is_lossless_operator(top, TINY, cfg2)
                == jax_lossless(jop, jax_cfg(TINY), jax_cfg(cfg2)))
    assert is_lossless_operator(lemon_operator(TINY, WIDE, device="cpu"),
                                TINY, WIDE)
    assert not can_grow_cache(TINY, TINY.scaled(name="w", window=8))


def test_grow_decode_state_refuses_depth_blends(tparams):
    op = bridge.to_torch(to_numpy(jax_init_ligo(
        jax.random.PRNGKey(0), jax_cfg(TINY), jax_cfg(BIG))))
    eng, _ = _port_engine(tparams, TINY)
    eng.step()
    with pytest.raises(CacheGrowthError):
        grow_decode_state(eng.state, op, TINY, BIG)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_lemon_migrated_cache_matches_jax(jparams, tparams, layout):
    """Both engines three steps into the same sessions, then the in-place
    LEMON growth of each one's live decode state: the grown caches agree
    (the pools' real blocks, the port's spare block left out)."""
    jeng, _ = _jax_engine(jparams, TINY, kv_layout=layout)
    teng, _ = _port_engine(tparams, TINY, kv_layout=layout)
    for _ in range(3):
        jeng.step()
        teng.step()
    want = jax_grow_state(jeng.state, jax_lemon(jax_cfg(TINY), jax_cfg(WIDE)),
                          jax_cfg(TINY), jax_cfg(WIDE))
    got = grow_decode_state(teng.state, lemon_operator(TINY, WIDE,
                                                       device="cpu"),
                            TINY, WIDE)
    for kk in ("k", "v"):
        a = got["caches"][kk].numpy()
        b = np.asarray(want["caches"][kk])
        if layout == "paged":
            assert a.shape[1] == b.shape[1] + 1          # the spare block
            a = a[:, :-1]
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


# ---------------------------------------------------------------------------
# The live hop against the JAX hop
# ---------------------------------------------------------------------------
def _hop_run(eng, reqs, hop, hop_at=2):
    def on_step(e):
        if e.decode_steps >= hop_at and hop.attempts == 0:
            hop.begin()
        if hop.attempts:
            hop.poll()

    eng.run(on_step=on_step)
    while not hop.poll():
        time.sleep(0.002)      # a busy poll would starve the grow thread
    assert all(r.status == "done" for r in reqs)
    return [list(r.tokens) for r in reqs]


def _both_hops(jparams, tparams, cfg2, jop, *, cache_mode="auto",
               gen=16, **kw):
    jeng, jreqs = _jax_engine(jparams, TINY, gen=gen, **kw)
    jhop = JaxHop(jeng, jax_cfg(cfg2), jop, cache_mode=cache_mode,
                  background=False)
    want = _hop_run(jeng, jreqs, jhop)
    teng, treqs = _port_engine(tparams, TINY, gen=gen, **kw)
    thop = HopController(teng, cfg2, bridge.to_torch(to_numpy(jop)),
                         cache_mode=cache_mode, background=False)
    got = _hop_run(teng, treqs, thop)
    assert thop.completed and jhop.completed
    assert thop.cache_path == jhop.cache_path
    assert thop.swap_at_step == jhop.swap_at_step
    assert teng.cfg.name == cfg2.name and teng.counts()["dropped"] == 0
    assert got == want
    return teng, thop


def test_lemon_hop_grows_the_cache_in_place_like_jax(jparams, tparams):
    _, hop = _both_hops(jparams, tparams, WIDE,
                        jax_lemon(jax_cfg(TINY), jax_cfg(WIDE)))
    assert hop.cache_path == "grow"


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_ligo_hop_reprefills_like_jax(jparams, tparams, layout):
    jop = jax_init_ligo(jax.random.PRNGKey(7), jax_cfg(TINY), jax_cfg(BIG))
    eng, hop = _both_hops(jparams, tparams, BIG, jop, kv_layout=layout)
    assert hop.cache_path == "reprefill"
    assert eng.prefill_counts[(BIG.name, "reprefill")] == 2   # both slots


def test_depth_replay_hop_matches_jax(jparams, tparams):
    _, hop = _both_hops(jparams, tparams, DEEP,
                        jax_stack(jax_cfg(TINY), jax_cfg(DEEP)),
                        cache_mode="replay")
    assert hop.cache_path == "replay"


# ---------------------------------------------------------------------------
# Chaos, give-up, watchdog, background grow
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def big_op():
    return bridge.to_torch(to_numpy(jax_init_ligo(
        jax.random.PRNGKey(7), jax_cfg(TINY), jax_cfg(BIG))))


@pytest.mark.parametrize("stage", ["grow", "cache-grow", "swap", "hang"])
def test_hop_chaos_rolls_back_and_retry_succeeds(tparams, big_op, stage):
    """A failure injected at every hop stage rolls back (engine keeps
    decoding old weights, zero dropped sessions), its cause is the injected
    one, and the retry lands. (No ``warm()``: the hang case's watchdog
    stays at its hard 0.5 s timeout, as in the reference test.)"""
    eng, reqs = _port_engine(tparams, TINY, gen=16)
    hop = HopController(eng, BIG, big_op, fail_at=stage, backoff=0.01,
                        background=(stage == "hang"),
                        timeout=(0.5 if stage == "hang" else 120.0))
    _hop_run(eng, reqs, hop)
    assert hop.completed and hop.attempts == 2, stage
    ((where, cause),) = hop.rollbacks
    assert isinstance(cause, HopError)
    if stage == "hang":
        assert where == "grow" and "watchdog" in str(cause)
    else:
        assert where == stage and "injected" in str(cause)
    c = eng.counts()
    assert c["done"] == 4 and c["dropped"] == 0, (stage, c)
    assert all(len(r.tokens) == r.max_new for r in reqs)


def test_hop_gives_up_and_engine_survives_on_old_weights(tparams, big_op):
    eng, reqs = _port_engine(tparams, TINY, gen=16)
    hop = HopController(eng, BIG, big_op, fail_at="grow", retries=0,
                        background=False)
    _hop_run(eng, reqs, hop)
    assert hop.failed and not hop.completed
    assert eng.cfg.name == TINY.name
    c = eng.counts()
    assert c["done"] == 4 and c["dropped"] == 0


def test_hang_needs_a_background_grow(tparams, big_op):
    eng, _ = _port_engine(tparams, TINY)
    with pytest.raises(ValueError, match="background"):
        HopController(eng, BIG, big_op, fail_at="hang", background=False)


def test_background_grow_completes_between_decode_steps(tparams):
    eng, reqs = _port_engine(tparams, TINY, gen=24)
    hop = HopController(eng, WIDE, lemon_operator(TINY, WIDE, device="cpu"),
                        background=True)
    _hop_run(eng, reqs, hop)
    assert hop.completed and hop.cache_path == "grow"
    assert eng.counts()["done"] == 4
    assert hop.swap_at_step >= hop.begin_at_step


def test_warm_seed_leaves_out_the_first_grows_one_time_work(
        tparams, big_op, monkeypatch):
    """``warm()``'s first grow is untimed: a first grow made slow on
    purpose (0.5 s, as a first build or cache fill would be) raises
    neither the watchdog's seed nor its floor; the second grow, timed,
    seeds both. One ``hop.warm`` span covers the two grows."""
    from repro_torch import obs
    from repro_torch.core.plan import GrowthPlan
    apply, calls = GrowthPlan.apply, []

    def slow_first(self, *a, **kw):
        calls.append(time.perf_counter())
        if len(calls) == 1:
            time.sleep(0.5)
        return apply(self, *a, **kw)
    monkeypatch.setattr(GrowthPlan, "apply", slow_first)
    obs.set_enabled(True)
    obs.FLIGHT.clear()
    eng, _ = _port_engine(tparams, TINY)
    hop = HopController(eng, BIG, big_op)
    dt = hop.warm()
    assert len(calls) == 2 and set(hop.warm_ms) == {"fill", "seed"}
    assert hop.warm_ms["fill"] >= 500.0 > hop.warm_ms["seed"]
    assert dt == hop.warm_ms["seed"] / 1e3
    assert hop.watchdog.ewma == hop.watchdog.floor == dt < 0.5
    assert hop.watchdog.budget() == max(dt, min(120.0, max(0.05, 5 * dt)))
    warms = [r for r in obs.FLIGHT.events(type="span")
             if r["name"] == "hop.warm"]
    assert len(warms) == 1 and warms[0]["dur_ms"] >= 500.0
    assert hop.captures == 0               # no CUDA graph on the CPU


@pytest.mark.parametrize("background", [True, False])
def test_a_hop_never_warmed_grows_eagerly_and_completes(tparams, big_op,
                                                        background):
    """A controller whose ``warm()`` never ran grows eagerly at the hop
    (the reference then pays its first trace there) against a cold
    watchdog, and serves the tree a plan apply gives, bit for bit."""
    from repro_torch.core.ligo import _flatten
    from repro_torch.core.plan import plan_for
    eng, reqs = _port_engine(tparams, TINY, gen=16)
    hop = HopController(eng, BIG, big_op, background=background)
    assert hop.watchdog.ewma is None and hop.watchdog.budget() == 120.0
    _hop_run(eng, reqs, hop)
    assert hop.completed and hop.attempts == 1 and not hop.rollbacks
    assert hop.captures == 0 and hop.warm_ms == {}
    assert "warm" not in hop.timings and "grow" in hop.timings
    with torch.no_grad():
        want = _flatten(plan_for(TINY, BIG, tparams).apply(big_op, tparams))
    got = _flatten(eng.params)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert eng.counts()["done"] == 4 and eng.counts()["dropped"] == 0


def test_watchdog_budget_matches_reference():
    ours, theirs = (HopWatchdog(timeout=100.0, mult=5.0),
                    JaxWatchdog(timeout=100.0, mult=5.0))
    assert ours.budget() == theirs.budget() == 100.0
    for dt in (0.2, 100.0, 0.001, 3.0):
        ours.observe(dt)
        theirs.observe(dt)
        assert ours.budget() == theirs.budget()
    ours, theirs = HopWatchdog(timeout=0.01), JaxWatchdog(timeout=0.01)
    ours.seed(0.3)
    theirs.seed(0.3)
    assert ours.budget() == theirs.budget() == 0.3   # the seeded floor


# ---------------------------------------------------------------------------
# serve --live-grow-at
# ---------------------------------------------------------------------------
LIVE = ["--arch", "llama3-8b", "--smoke", "--live-grow-at", "2",
        "--grow-to", "2x", "--batch", "2", "--prompt-len", "8", "--gen", "6"]


def test_serve_live_grow_cli_on_cpu(capsys):
    """The CLI live path: a chaos-injected hop rolls back, retries, and the
    run reports zero drops and throughput through the hop."""
    res = serve.main(LIVE + ["--fail-at-hop", "cache-grow", "--hop-sync",
                             "--device", "cpu"])
    out = capsys.readouterr().out
    assert "rolled back" in out and "hop complete" in out
    assert "0 dropped" in out and "tok/s" in out and "p99" in out
    assert "[paged] peak" in out and "kernel launches: K1 0, K3 0" in out
    assert res["hop"].completed and res["hop"].attempts == 2
    assert res["engine"].counts()["done"] == 4


def test_serve_live_refuses_without_cuda_and_unported_options(capsys):
    """Without ``--device cpu`` the live path raises (no CUDA here);
    ``--hop-operator upcycle`` hops the dense smoke model to its MoE twin
    with the cache grown in place and no request dropped."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(LIVE)
    argv = [a for a in LIVE if a not in ("--grow-to", "2x")]
    res = serve.main(argv + ["--hop-operator", "upcycle", "--device", "cpu"])
    out = capsys.readouterr().out
    assert res["hop"].completed and res["hop"].cache_path == "grow"
    assert res["cfg2"].name == "llama3-8b-smoke-moe"
    assert res["cfg2"].family == "moe" and res["engine"].cfg == res["cfg2"]
    assert "0 dropped" in out and "cache: grow" in out
    assert res["engine"].counts()["done"] == 4


def test_serve_live_ledger_records_the_hop_and_the_decode_flops(tmp_path):
    """``--ledger`` on the live path: the hop's lifecycle events, and the
    decode step's operations counted at each install against 2N a token."""
    from repro_torch.obs import costs, read_ledger
    path = str(tmp_path / "ledger.jsonl")
    costs.clear_measurements()
    res = serve.main(["--arch", "gpt2-base", "--smoke", "--live-grow-at", "2",
                      "--batch", "2", "--prompt-len", "8", "--gen", "6",
                      "--device", "cpu", "--ledger", path])
    names = [r["name"] for r in read_ledger(path) if r["type"] == "event"]
    assert names == ["hop.begin", "hop.complete"]
    for cfg in (res["small_cfg"], res["cfg2"]):
        m = costs.measurement(f"decode_step[{cfg.name}]")
        assert m is not None and 0.5 <= m["ratio"] <= 2.0, m


def test_counter_group_loses_no_increment_across_threads():
    """Eight threads increment one key of a counter group with the
    interpreter switching threads as often as it can: no increment lost."""
    import sys
    import threading
    from repro_torch.obs import counter_group
    group = counter_group("test.counter_group.stress")
    group.clear()
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [group.inc("n") for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert group["n"] == 16000 and group["absent"] == 0
