"""The port's speculative decoding against the JAX package's on the CPU, at
the reference tests' sizes (``tests/test_spec_decode.py``'s TINY, WIDE and
DEEP and ``tests/test_torch_serving.py``'s BIG, float32), params and
operators carried across with ``repro_torch.bridge``.

- Greedy, through a LEMON hop (the cache grown in place), a LiGO hop
  (re-prefill) and a depth-append hop (new-layer replay), paged and dense:
  the port's speculative tokens equal its own vanilla greedy tokens and the
  JAX engine's speculative tokens, request for request, and ``spec_stats``
  (rounds, accepted, drafted, first-round acceptance) equal JAX's.
- Sampled (temperature 0.8, top-p 0.9, seed 42), with the drafter's noise
  replaced by JAX's own Gumbel draws of ``draft_keys``: the tokens equal the
  JAX engine's, and every round's drafts and returned distributions equal
  JAX's (the distributions within 1e-6) on the live slots.
- The primitives: ``device_adjust_probs`` within 1e-6 of JAX's over a grid
  of temperature and top-p, the acceptance rules exactly, memoised builds.
- The reference tests' own checks on the port: LEMON first-round
  acceptance 1.0, the declined drafters, the auto-disable, a second hop
  aborted mid-draft at each stage dropping nothing, a retry landing while
  drafting; and two of the port's own: no round writes the paged pools'
  spare block while every slot is live, and the drafter's and the grown
  model's caches share no storage after every hop path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import init_ligo_params as jax_init_ligo     # noqa: E402
from repro.core.operators import lemon_operator as jax_lemon  # noqa: E402
from repro.core.operators import stackbert_operator as jax_stack  # noqa: E402
from repro.models import init_params as jax_init_params      # noqa: E402
from repro.serving import HopController as JaxHop            # noqa: E402
from repro.serving import ServingEngine as JaxEngine         # noqa: E402
from repro.serving import speculative as jspec               # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.configs.paper_models import BERT_SMALL      # noqa: E402
from repro_torch.core.operators import lemon_operator        # noqa: E402
from repro_torch.launch import serve                         # noqa: E402
from repro_torch.serving import HopController, ServingEngine  # noqa: E402
from repro_torch.serving import speculative as tspec         # noqa: E402
from torch_parity import jax_cfg, to_numpy                   # noqa: E402

TINY = BERT_SMALL.scaled(
    name="spec-tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
    d_head=8, d_ff=64, vocab_size=64, max_seq=96, dtype="float32",
    objective="clm", encoder_only=False, causal=True)
# width-only, lossless from TINY by LEMON: the cache grows in place
WIDE = TINY.scaled(name="spec-wide", n_heads=8, n_kv_heads=8, d_ff=96)
# depth-append: the new layers replay over the kept residual stream
DEEP = TINY.scaled(name="spec-deep", n_layers=4)
# depth + width, a LiGO operator: the caches are re-prefilled
BIG = TINY.scaled(name="spec-big", n_layers=4, d_model=48, d_head=12,
                  d_ff=96)
# a second hop from WIDE
WIDER = WIDE.scaled(name="spec-wider", n_heads=16, n_kv_heads=16, d_ff=128)

SAMPLED = dict(temperature=0.8, top_p=0.9, seed=42)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engine runs many tiny eager ops: one intra-op thread each, so
    parallel test workers do not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jparams():
    return jax_init_params(jax_cfg(TINY), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return bridge.to_torch(to_numpy(jparams))


def _jax_op(hop):
    """The JAX operator of each hop kind: (target config, operator)."""
    if hop == "lemon":
        return WIDE, jax_lemon(jax_cfg(TINY), jax_cfg(WIDE))
    if hop == "ligo":
        return BIG, jax_init_ligo(jax.random.PRNGKey(7), jax_cfg(TINY),
                                  jax_cfg(BIG))
    return DEEP, jax_stack(jax_cfg(TINY), jax_cfg(DEEP))


HOP_PATHS = {"lemon": "grow", "ligo": "reprefill", "replay": "replay"}


def _prompts(n):
    rng = np.random.RandomState(0)
    return [list(rng.randint(0, TINY.vocab_size, 4 + i % 4))
            for i in range(n)]


def _drive(eng, hop, reqs, *, hop_at=3, second=None):
    """The reference test's loop: step, begin the hop at step ``hop_at``,
    poll; ``second`` builds a second controller once the first completed.
    Returns (second controller, uids admitted after the first hop)."""
    hop2, after = None, None
    step = 0
    for _ in range(600):
        if not eng.has_work():
            break
        eng.step()
        step += 1
        if step == hop_at:
            hop.begin()
        hop.poll()
        if hop.completed and after is None:
            after = {r.uid for r in reqs if r.status == "queued"}
        if second is not None and hop.completed and hop2 is None:
            hop2 = second(eng)
            hop2.begin()
        if hop2 is not None:
            hop2.poll()
    assert hop.completed and not eng.has_work()
    return hop2, after or set()


def _port(params, cfg2, op, *, spec_k, kv_layout="paged", gen=24, n_req=4,
          temperature=0.0, top_p=1.0, seed=0, block_size=16, fail_at=None,
          retries=2, second_hop=False, spy=None):
    """Serve the reference test's requests through a synchronous hop TINY ->
    ``cfg2`` at step 3. ``spy(eng)`` runs after the engine is made."""
    eng = ServingEngine(params, TINY, slots=2, prompt_budget=8,
                        gen_budget=gen, kv_layout=kv_layout, spec_k=spec_k,
                        temperature=temperature, top_p=top_p, seed=seed,
                        block_size=block_size, spec_autodisable=False,
                        device="cpu")
    if spy is not None:
        spy(eng)
    hop = HopController(eng, cfg2, op, retries=retries, backoff=0.01,
                        background=False)
    reqs = [eng.submit(p, max_new=gen) for p in _prompts(n_req)]
    second = None
    if second_hop:
        def second(e):
            return HopController(e, WIDER,
                                 lemon_operator(WIDE, WIDER, device="cpu"),
                                 fail_at=fail_at, retries=retries,
                                 backoff=0.01, background=False)
    hop2, after = _drive(eng, hop, reqs, second=second)
    return eng, hop, hop2, reqs, after


def _jax(params, cfg2, op, *, spec_k, kv_layout="paged", gen=24, n_req=4,
         spy=None, **kw):
    eng = JaxEngine(params, jax_cfg(TINY), slots=2, prompt_budget=8,
                    gen_budget=gen, kv_layout=kv_layout, spec_k=spec_k,
                    mesh=None, spec_autodisable=False, **kw)
    if spy is not None:
        spy(eng)
    hop = JaxHop(eng, jax_cfg(cfg2), op, background=False)
    reqs = [eng.submit(p, max_new=gen) for p in _prompts(n_req)]
    _drive(eng, hop, reqs)
    return eng, hop, reqs


def _lemon():
    return lemon_operator(TINY, WIDE, device="cpu")


def _stats(eng):
    st = eng.spec_stats
    return (st["rounds"], st["accepted"], st["drafted"],
            st["first_round_acc"])


# ---------------------------------------------------------------------------
# Greedy: bit-equal to vanilla and to the JAX engine, through every hop path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_layout", ["paged", "dense"])
@pytest.mark.parametrize("hop", ["lemon", "ligo", "replay"])
def test_greedy_spec_equals_vanilla_and_jax(jparams, tparams, kv_layout, hop):
    cfg2, jop = _jax_op(hop)
    top = bridge.to_torch(to_numpy(jop))
    _, hv, _, vanilla, _ = _port(tparams, cfg2, top, spec_k=0,
                                 kv_layout=kv_layout)
    eng, hs, _, spec, _ = _port(tparams, cfg2, top, spec_k=4,
                                kv_layout=kv_layout)
    jeng, jhop, jreqs = _jax(jparams, cfg2, jop, spec_k=4,
                             kv_layout=kv_layout)
    assert hv.cache_path == hs.cache_path == jhop.cache_path \
        == HOP_PATHS[hop]
    assert all(r.status == "done" for r in vanilla + spec)
    got = [r.tokens for r in spec]
    assert got == [r.tokens for r in vanilla]
    assert got == [list(r.tokens) for r in jreqs]
    for r, v in zip(spec, vanilla):
        # the last token's logits: a verify column is the vanilla step
        np.testing.assert_array_equal(r.last_logits, v.last_logits)
    assert eng.spec_stats["rounds"] > 0
    assert eng.spec_stats["drafter"] == TINY.name
    assert _stats(eng) == _stats(jeng)
    if hop == "lemon":
        assert eng.spec_stats["first_round_acc"] == 1.0


def test_lemon_first_round_acceptance_is_total(tparams):
    """A lossless hop: drafter and verifier are the same function, so the
    first round accepts every draft, and so does every round of a request
    admitted after the hop (its drafter prefill ran)."""
    eng, _, _, reqs, after = _port(tparams, WIDE, _lemon(), spec_k=4)
    assert eng.spec_stats["first_round_acc"] == 1.0
    assert after, "no request was admitted after the hop"
    assert all(r.acc_ema == 1.0 for r in reqs if r.uid in after)
    assert eng.prefill_counts[(TINY.name, "draft")] == len(after)
    assert all(r.status == "done" for r in reqs)


# ---------------------------------------------------------------------------
# Sampled: the JAX engine's tokens under JAX's Gumbel draws
# ---------------------------------------------------------------------------
def _jax_noise(seed, round_idx, K1, slots, V, device):
    """JAX's noise for one round: ``jax.random.categorical(k, l)`` is
    ``argmax(jax.random.gumbel(k, l.shape) + l)``, one key per (step,
    slot) from ``draft_keys``."""
    keys = jspec.draft_keys(seed, round_idx, K1, slots)
    g = jax.vmap(jax.vmap(lambda k: jax.random.gumbel(k, (V,))))(keys)
    return torch.as_tensor(np.array(g), device=device)


def _draft_spy(module, sink):
    """Make each engine record, per speculative round, its live slots and
    its drafter's tokens and distributions."""
    make = module.make_sampled_draft_fn

    def spy(eng):
        round_ = eng._spec_round

        def watched(active):
            sink.append({"live": [i for i, _ in active]})
            round_(active)
        eng._spec_round = watched

    def made(*args):
        fn = make(*args)

        def draft(*a):
            out = fn(*a)
            sink[-1]["toks"] = np.asarray(out[0])
            sink[-1]["probs"] = np.asarray(out[1])
            return out
        return draft

    return spy, made


@pytest.mark.parametrize("hop", ["lemon", "ligo"])
def test_sampled_spec_equals_jax_under_jax_noise(jparams, tparams,
                                                 monkeypatch, hop):
    cfg2, jop = _jax_op(hop)
    jrounds, trounds = [], []
    jspy, jmade = _draft_spy(jspec, jrounds)
    tspy, tmade = _draft_spy(tspec, trounds)
    monkeypatch.setattr(jspec, "make_sampled_draft_fn", jmade)
    monkeypatch.setattr(tspec, "make_sampled_draft_fn", tmade)
    monkeypatch.setattr(tspec, "draft_noise", _jax_noise)
    jeng, _, jreqs = _jax(jparams, cfg2, jop, spec_k=4, gen=16, spy=jspy,
                          **SAMPLED)
    eng, _, _, reqs, _ = _port(tparams, cfg2, bridge.to_torch(to_numpy(jop)),
                               spec_k=4, gen=16, spy=tspy, **SAMPLED)
    assert all(r.status == "done" for r in reqs)
    assert [r.tokens for r in reqs] == [list(r.tokens) for r in jreqs]
    assert _stats(eng) == _stats(jeng)
    assert len(trounds) == len(jrounds) == eng.spec_stats["rounds"] > 0
    for t, j in zip(trounds, jrounds):
        assert t["live"] == j["live"]
        live = t["live"]
        np.testing.assert_array_equal(t["toks"][live], j["toks"][live])
        assert np.abs(t["probs"][live] - j["probs"][live]).max() <= 1e-6
    if hop == "ligo":               # a learned-looking operator: rejections
        assert 0 < eng.spec_stats["accepted"] < eng.spec_stats["drafted"]
    greedy = _port(tparams, cfg2, bridge.to_torch(to_numpy(jop)), spec_k=4,
                   gen=16)[3]
    assert [r.tokens for r in reqs] != [r.tokens for r in greedy]


def test_sampled_spec_reproducible_and_seed_sensitive(tparams):
    """The port's own noise (``draft_noise``, a generator seeded from the
    seed and the round): one seed repeats, another changes the tokens."""
    kw = dict(spec_k=4, gen=16, **SAMPLED)
    a = _port(tparams, WIDE, _lemon(), **kw)[3]
    b = _port(tparams, WIDE, _lemon(), **kw)[3]
    assert [r.tokens for r in a] == [r.tokens for r in b]
    c = _port(tparams, WIDE, _lemon(), **{**kw, "seed": 7})[3]
    assert [r.tokens for r in a] != [r.tokens for r in c]
    n = tspec.draft_noise(42, 3, 5, 2, 64, "cpu")
    assert n.shape == (5, 2, 64) and n.dtype == torch.float32
    assert torch.isfinite(n).all()
    assert torch.equal(n, tspec.draft_noise(42, 3, 5, 2, 64, "cpu"))
    assert not torch.equal(n, tspec.draft_noise(42, 4, 5, 2, 64, "cpu"))


# ---------------------------------------------------------------------------
# The primitives against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("temperature", [0.5, 0.8, 1.0, 1.7])
@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9, 1.0])
def test_device_adjust_probs_matches_jax(temperature, top_p):
    # normal draws: no ties, so both sorts keep the same top-p set
    logits = np.random.RandomState(2).randn(6, 64).astype(np.float32) * 3
    got = tspec.device_adjust_probs(torch.as_tensor(logits), temperature,
                                    top_p).numpy()
    want = np.asarray(jspec.device_adjust_probs(jnp.asarray(logits),
                                                temperature, top_p))
    assert np.abs(got - want).max() <= 1e-6
    assert ((got > 0) == (want > 0)).all()     # the same top-p set


def test_accept_rules_match_jax():
    rng = np.random.RandomState(1)
    K, V = 4, 64
    for trial in range(40):
        logits = rng.randn(K + 1, V).astype(np.float32) * 3
        g = np.argmax(logits, -1)
        a = trial % (K + 1)                    # first a drafts accepted
        draft = g[:K].copy()
        if a < K:
            draft[a] = (draft[a] + 1) % V
        assert tspec.accept_greedy(draft, logits) == jspec.accept_greedy(
            draft, logits)
        probs = rng.dirichlet(np.ones(V), size=K)
        draft = rng.randint(0, V, K)
        kw = dict(temperature=(0.8, 1.0)[trial % 2],
                  top_p=(0.9, 1.0)[trial % 3 > 0], seed=7, uid=trial,
                  counter=3)
        assert (tspec.accept_sampled(draft, probs, logits, **kw)
                == jspec.accept_sampled(draft, probs, logits, **kw))


def test_draft_and_verify_builds_are_memoised(tparams):
    tspec.make_draft_fn.cache_clear()
    tspec.make_verify_fn.cache_clear()
    tspec.BUILD_COUNTS.clear()
    eng = _port(tparams, WIDE, _lemon(), spec_k=3)[0]
    _port(tparams, WIDE, _lemon(), spec_k=3)
    assert eng.spec_stats["rounds"] > 1
    assert tspec.BUILD_COUNTS["draft"] == 1
    assert tspec.BUILD_COUNTS["verify"] == 1
    assert tspec.BUILD_COUNTS["sampled_draft"] == 0


# ---------------------------------------------------------------------------
# The paged pools and the drafter's storage
# ---------------------------------------------------------------------------
def test_spec_round_writes_no_spare_block(tparams):
    """Paged, blocks of 4 so every round crosses a block edge: the round
    maps pos..pos+K of every live slot before its draft and verify steps
    write there, so with every slot live no write of a round lands in
    either pool's spare block (the last one)."""
    checked = []

    def spy(eng):
        round_ = eng._spec_round

        def watched(active):
            pools = [st["caches"][kk] for st in (eng.state, eng.d_state)
                     for kk in ("k", "v")]
            for pool in pools:
                pool[:, -1] = 0.0
            round_(active)
            if len(active) == eng.slots:
                checked.append(all(bool((pool[:, -1] == 0).all())
                                   for pool in pools))
        eng._spec_round = watched

    eng, _, _, reqs, _ = _port(tparams, WIDE, _lemon(), spec_k=4,
                               block_size=4, spy=spy)
    assert len(checked) >= 3 and all(checked)
    assert all(r.status == "done" for r in reqs)


def _storage(t):
    s = t.untyped_storage()
    return s.data_ptr(), s.data_ptr() + s.nbytes()


@pytest.mark.parametrize("kv_layout", ["paged", "dense"])
@pytest.mark.parametrize("hop", ["lemon", "ligo", "replay"])
def test_drafter_and_target_caches_share_no_storage(tparams, kv_layout, hop):
    """The drafter decodes on the pre-hop state in place and the grown
    model on the migrated one: after every hop path their caches' storages
    are disjoint, and stay so through the rounds."""
    cfg2, jop = _jax_op(hop)
    seen = []

    def spy(eng):
        round_ = eng._spec_round

        def watched(active):
            d = [_storage(eng.d_state["caches"][kk]) for kk in ("k", "v")]
            t = [_storage(eng.state["caches"][kk]) for kk in ("k", "v")]
            seen.append(all(a1 <= b0 or b1 <= a0
                            for a0, a1 in d for b0, b1 in t))
            round_(active)
        eng._spec_round = watched

    _, hop_, _, reqs, _ = _port(tparams, cfg2,
                                bridge.to_torch(to_numpy(jop)), spec_k=3,
                                kv_layout=kv_layout, spy=spy)
    assert hop_.cache_path == HOP_PATHS[hop]
    assert seen and all(seen)
    assert all(r.status == "done" for r in reqs)


# ---------------------------------------------------------------------------
# Telemetry, auto-disable, refusals
# ---------------------------------------------------------------------------
def test_auto_disable_when_drafting_cannot_pay(tparams):
    eng = ServingEngine(tparams, TINY, slots=2, prompt_budget=8,
                        gen_budget=8, spec_k=4, device="cpu")
    assert eng.adopt_drafter(TINY, tparams, eng.state)
    for _ in range(3):
        # 0 of K accepted, draft as slow as verify: the estimate is < 1
        eng._spec_telemetry(2, 0, t_draft=0.04, t_verify=0.01)
    assert not eng.spec_enabled
    assert "est speedup" in eng.spec_stats["disabled"]
    assert not eng._spec_ready([])            # sticky


def test_drafter_declined_for_windowed_mismatched_or_other_cap(tparams):
    eng = ServingEngine(tparams, TINY, slots=2, prompt_budget=8,
                        gen_budget=8, spec_k=4, device="cpu")
    win = TINY.scaled(name="spec-win", window=8)
    assert not eng.adopt_drafter(win, tparams, eng.state)
    other = TINY.scaled(name="spec-vocab", vocab_size=32)
    assert not eng.adopt_drafter(other, tparams, eng.state)
    plain = ServingEngine(tparams, TINY, slots=2, prompt_budget=8,
                          gen_budget=8, device="cpu")
    assert not plain.adopt_drafter(TINY, tparams, plain.state)  # spec_k 0
    eng.cap += 4                  # the served model's capacity moved
    assert not eng.adopt_drafter(TINY, tparams, eng.state)
    assert not eng.spec_enabled and eng.d_cfg is None
    eng.cap -= 4
    assert eng.adopt_drafter(TINY, tparams, eng.state)
    eng.drop_drafter("test")
    assert not eng.spec_enabled and eng.spec_stats["disabled"] == "test"
    assert eng.d_cfg is None and eng.d_state is None


# ---------------------------------------------------------------------------
# Chaos: a second hop aborted while rounds are speculative
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fail_at", ["grow", "cache-grow", "swap"])
def test_hop_abort_mid_draft_drops_nothing(tparams, fail_at):
    eng, _, hop2, reqs, _ = _port(tparams, WIDE, _lemon(), spec_k=4, gen=32,
                                  retries=0, fail_at=fail_at,
                                  second_hop=True)
    assert hop2 is not None and hop2.failed
    ((where, cause),) = hop2.rollbacks
    assert where == fail_at and "injected" in str(cause)
    assert eng.cfg.name == WIDE.name                 # rolled back
    assert eng.spec_stats["rounds"] > 0 and eng.spec_enabled
    assert eng.spec_stats["drafter"] == TINY.name
    assert all(r.status == "done" for r in reqs)
    assert eng.counts()["dropped"] == 0
    a = eng.alloc
    assert len(a.free) == a.n_blocks and (a.table == -1).all()
    assert (a.allocated == 0).all() and (a.reserved == 0).all()


def test_hop_retry_succeeds_while_drafting(tparams):
    eng, _, hop2, reqs, _ = _port(tparams, WIDE, _lemon(), spec_k=4, gen=32,
                                  retries=2, fail_at="swap", second_hop=True)
    assert hop2 is not None and hop2.completed and hop2.attempts == 2
    assert eng.cfg.name == WIDER.name
    assert eng.spec_stats["drafter"] == WIDE.name
    assert eng.spec_stats["rounds"] > 0
    assert all(r.status == "done" for r in reqs)
    assert eng.counts()["dropped"] == 0


# ---------------------------------------------------------------------------
# serve --speculative
# ---------------------------------------------------------------------------
def test_serve_speculative_prints_the_acceptance_line(capsys):
    res = serve.main(["--arch", "gpt2-base", "--smoke", "--live-grow-at", "2",
                      "--hop-operator", "lemon", "--hop-sync", "--batch",
                      "2", "--prompt-len", "8", "--gen", "6",
                      "--speculative", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[spec] drafter resident:" in out and "K=2" in out
    assert "[spec] acceptance " in out and "K=2 drafter=" in out
    eng = res["engine"]
    assert eng.spec_stats["rounds"] > 0
    assert eng.counts()["done"] == 4 and eng.counts()["dropped"] == 0
