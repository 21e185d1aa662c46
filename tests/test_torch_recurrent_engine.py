"""The port's live serving engine on the recurrent families, against the JAX
package's lock-step ``prefill`` + ``decode_step`` at each request's true
length, on the CPU at smoke sizes (``smoke_config`` of xlstm-125m and
zamba2-2.7b, float32), on bridged parameters and operators.

The JAX engine is not the oracle here: it right-pads every prompt to the
prompt budget and every re-prefill to ``max_len``, and a recurrent state
absorbs the pads, so its tokens equal its own package's ``prefill`` +
``decode_step`` only for a prompt that fills the budget. The port's engine
prefills at the true length and is held to the lock-step path.

- Tokens, greedy and sampled (the picks through the port's sampling
  primitives, which ``test_torch_serving.py`` holds to JAX's, applied to
  the JAX logits), for prompts of 1, 2, 5, 9 and 16 tokens under a budget
  of 16 through 3 slots: 1 and 2 are shorter than the conv kernel's tail.
- Through a LiGO hop that re-prefills: the tokens after the swap equal the
  JAX grown model's (``apply_ligo`` of the same operator, then ``prefill``
  over each session's history and ``decode_step``).
- The oracle has teeth: with the port's prefill right-padded to the budget,
  as the JAX engine pads, the 5- and 9-token prompts' tokens differ.
- Chaos at every hop stage rolls back with the engine's state bitwise as it
  was before the failing poll, and the retry lands.
- ``write_slot`` against the JAX prefill's state (a 2-token prompt's zero
  conv tail, the sLSTM's -1e30 stabiliser; a 150-token prompt past the
  mLSTM's 128-token chunk), ``slot_bytes``.
- Refusals: ``cache_mode`` grow and replay, ``spec_k > 0`` (naming their
  ROADMAP items), the paged layout (a loud fallback to dense).
- ``serve``: the lock-step path and ``--live-grow-at`` for both archs on the
  CPU, the refusals through the flags, and no run without ``--device cpu``
  when no card is present.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import apply_ligo as jax_apply_ligo          # noqa: E402
from repro.core import init_ligo_params as jax_init_ligo     # noqa: E402
from repro.models import model as jmodel                     # noqa: E402
import repro_torch.configs as tc                             # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.launch import serve                         # noqa: E402
from repro_torch.models import model as tmodel               # noqa: E402
from repro_torch.serving import (HopController, HopError,    # noqa: E402
                                 ServingEngine, make_serving_fns)
from repro_torch.serving import engine as engine_mod         # noqa: E402
from repro_torch.serving import speculative as tspec         # noqa: E402
from repro_torch.tree import tree_leaves                     # noqa: E402
from torch_parity import jax_cfg, to_numpy                   # noqa: E402

XLSTM = tc.smoke_config(tc.get_config("xlstm-125m"))
ZAMBA = tc.smoke_config(tc.get_config("zamba2-2.7b"))
ARCHS = {"xlstm": XLSTM, "zamba2": ZAMBA}
LENS = (1, 2, 5, 9, 16)
BUDGET = 16
GEN = 6
SLOTS = 3
SAMPLED = dict(temperature=0.8, top_p=0.9, seed=3)
STATE_TOL = 1e-4          # per-leaf scale-normalised, as the model tests


def _bridge(tree):
    return bridge.to_torch(to_numpy(tree))


@pytest.fixture(scope="module")
def models():
    """Each arch's JAX params, their bridged copy, the LiGO operator to
    ``grow_target`` (JAX's, bridged) and the JAX grown params."""
    out = {}
    for name, cfg in ARCHS.items():
        c1, c2 = jax_cfg(cfg), jax_cfg(tc.grow_target(cfg))
        jp = jax.jit(lambda k, c=c1: jmodel.init_params(c, k))(
            jax.random.PRNGKey(0))
        jop = jax_init_ligo(jax.random.PRNGKey(7), c1, c2)
        jbig = jax_apply_ligo(jop, jp, c1, c2, engine="legacy")
        out[name] = {"jp": jp, "tp": _bridge(jp), "top": _bridge(jop),
                     "jbig": jbig}
    return out


def _prompts(cfg, lens=LENS):
    rng = np.random.RandomState(4)
    return [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
            for n in lens]


class _Lockstep:
    """The JAX package's lock-step path for one request at its true length:
    ``prefill`` of the (1, T) prompt with room for ``max_len``, then one
    jitted ``decode_step`` a token."""

    def __init__(self, params, cfg, max_len):
        self.params, self.cfg, self.max_len = params, jax_cfg(cfg), max_len
        c = self.cfg
        self.decode = jax.jit(
            lambda p, s, t: jmodel.decode_step(p, c, s, {"tokens": t}))

    def prefill(self, hist):
        lg, st = jmodel.prefill(self.params, self.cfg,
                                {"tokens": jnp.asarray([hist], jnp.int32)},
                                max_len=self.max_len)
        return np.asarray(lg[0]), st

    def step(self, st, tok):
        lg, st = self.decode(self.params, st,
                             jnp.asarray([[tok]], jnp.int32))
        return np.asarray(lg[0]), st


def _picker(temperature=0.0, top_p=1.0, seed=0):
    """The engine's pick (``ServingEngine._pick_token``) on the oracle's
    logits: argmax, or the port's sampling primitives on the request's
    Philox chain."""
    def pick(logits, key, draw):
        if temperature <= 0:
            return int(np.argmax(logits))
        p = tspec.adjust_probs(logits, temperature, top_p)
        return int(tspec.philox(seed, key, draw).choice(len(p), p=p))
    return pick


def _oracle(small, big, prompt, n, swap_k, pick, key):
    """A request's tokens on the lock-step path: ``small`` makes tokens
    0..swap_k-1, then ``big`` re-prefills the history (prompt and every
    token but the newest) and decodes on. ``swap_k`` None: no hop reached
    the request; 0: admitted after it."""
    def model(i):
        return big if swap_k is not None and i >= swap_k else small
    logits, st = model(0).prefill(prompt)
    toks = [pick(logits, key, 0)]
    for i in range(1, n):
        m = model(i)
        if m is not model(i - 1):
            _, st = m.prefill(prompt + toks[:-1])
        logits, st = m.step(st, toks[-1])
        toks.append(pick(logits, key, i))
    return toks


def _engine(tp, cfg, **kw):
    return ServingEngine(tp, cfg, slots=SLOTS, prompt_budget=BUDGET,
                         gen_budget=GEN, kv_layout="dense", device="cpu",
                         **kw)


def _drive(eng, hop=None, hop_at=2, on_poll=None):
    """Run the engine to the end, the hop begun after ``hop_at`` decode
    steps; returns each request's token count at the swap (None: done
    before it, 0: not yet admitted)."""
    at_swap = {}

    def poll(e):
        (on_poll or (lambda _, h: h.poll()))(e, hop)
        if hop.completed and not at_swap:
            for r in e.requests:
                at_swap[r.uid] = (len(r.tokens) if r.status == "running"
                                  else 0 if r.status == "queued" else None)

    def on_step(e):
        if hop is None:
            return
        if e.decode_steps >= hop_at and hop.attempts == 0:
            hop.begin()
        if hop.attempts and not hop.completed:
            poll(e)

    eng.run(on_step=on_step)
    if hop is not None and hop.attempts == 0:   # drained before the trigger
        hop.begin()
    while hop is not None and not (hop.completed or hop.failed):
        time.sleep(0.002)      # a busy poll would starve the grow thread
        poll(eng)
    assert all(r.status == "done" for r in eng.requests)
    return at_swap


# ---------------------------------------------------------------------------
# The engine alone
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_engine_tokens_match_jax_lockstep(models, arch, mode):
    """Every request's tokens equal the JAX lock-step path's at the
    request's true length (prompts of 1, 2, 5, 9 and 16 tokens through 3
    slots, so two requests wait and take a freed slot)."""
    cfg, m = ARCHS[arch], models[arch]
    kw = SAMPLED if mode == "sampled" else {}
    eng = _engine(m["tp"], cfg, **kw)
    reqs = [eng.submit(p, max_new=GEN) for p in _prompts(cfg)]
    _drive(eng)
    small = _Lockstep(m["jp"], cfg, eng.max_len)
    pick = _picker(**kw)
    for r in reqs:
        want = _oracle(small, None, r.prompt, GEN, None, pick, r.sample_key)
        assert r.tokens == want, (arch, mode, len(r.prompt))
    assert sorted(eng.prefill_lengths.elements()) == sorted(
        (cfg.name, "admit", n) for n in LENS)          # no pad, no re-run
    if mode == "sampled":
        greedy = _engine(m["tp"], cfg)
        g = [greedy.submit(p, max_new=GEN) for p in _prompts(cfg)]
        _drive(greedy)
        assert [r.tokens for r in reqs] != [r.tokens for r in g]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_ligo_hop_reprefills_like_the_jax_grown_model(models, arch):
    """A LiGO hop after 2 decode steps re-prefills every live history at
    its length; each request's tokens equal the lock-step path's: the
    source model's before the swap, the JAX grown model's after it."""
    cfg, m = ARCHS[arch], models[arch]
    cfg2 = tc.grow_target(cfg)
    eng = _engine(m["tp"], cfg)
    reqs = [eng.submit(p, max_new=GEN) for p in _prompts(cfg)]
    hop = HopController(eng, cfg2, m["top"], background=False)
    at_swap = _drive(eng, hop)
    assert hop.completed and hop.cache_path == "reprefill"
    assert eng.cfg.name == cfg2.name and eng.counts()["dropped"] == 0
    hists = sorted(len(r.prompt) + at_swap[r.uid] - 1 for r in reqs
                   if at_swap[r.uid])
    assert len(hists) > 0 and sorted(
        n for (name, kind, n) in eng.prefill_lengths.elements()
        if kind == "reprefill") == hists               # each at its length
    assert any(k == 0 for k in at_swap.values())      # admitted after it
    small = _Lockstep(m["jp"], cfg, eng.max_len)
    big = _Lockstep(m["jbig"], cfg2, eng.max_len)
    pick = _picker()
    for r in reqs:
        want = _oracle(small, big, r.prompt, GEN, at_swap[r.uid], pick,
                       r.sample_key)
        assert r.tokens == want, (arch, len(r.prompt), at_swap[r.uid])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_padded_prefill_breaks_the_oracle(models, arch, monkeypatch):
    """The oracle has teeth: right-padded to the budget, as the JAX engine
    pads, the port's prefill leaves the pads in the recurrent state, and
    the 5- and 9-token prompts' tokens leave the lock-step path's; the
    16-token prompt, which fills the budget, keeps them."""
    cfg, m = ARCHS[arch], models[arch]
    monkeypatch.setattr(engine_mod, "exact_length_prefill", lambda c: False)
    eng = _engine(m["tp"], cfg)
    reqs = [eng.submit(p, max_new=GEN) for p in _prompts(cfg)]
    _drive(eng)
    small = _Lockstep(m["jp"], cfg, eng.max_len)
    pick = _picker()
    same = {len(r.prompt): r.tokens == _oracle(small, None, r.prompt, GEN,
                                               None, pick, r.sample_key)
            for r in reqs}
    assert not same[5] and not same[9] and same[16], same


# ---------------------------------------------------------------------------
# Chaos
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stage", ["grow", "cache-grow", "swap", "hang"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_chaos_rolls_back_with_the_state_bitwise(models, arch, stage):
    """A failure injected at each hop stage rolls back: the poll that fails
    leaves the engine's config, params and every state leaf bitwise as
    they were before it, and the retry lands, 0 dropped. ("hang" wedges
    the background grow until the watchdog, seeded by ``warm()``, aborts
    it.)"""
    cfg, m = ARCHS[arch], models[arch]
    eng = _engine(m["tp"], cfg)
    for p in _prompts(cfg):
        eng.submit(p, max_new=GEN)
    hop = HopController(eng, tc.grow_target(cfg), m["top"], fail_at=stage,
                        backoff=0.01, background=(stage == "hang"))
    hop.warm()      # the watchdog's budget: 5x a measured grow, not 120 s
    checked = []

    def on_poll(e, h):
        before = [t.clone() for t in tree_leaves(e.state["caches"])]
        cfg0, params0 = e.cfg, e.params
        n = len(h.rollbacks)
        h.poll()
        if len(h.rollbacks) > n:
            assert e.cfg is cfg0 and e.params is params0
            after = tree_leaves(e.state["caches"])
            assert len(after) == len(before)
            assert all(torch.equal(a, b) for a, b in zip(after, before))
            checked.append(h.rollbacks[-1][0])

    _drive(eng, hop, on_poll=on_poll)
    assert hop.completed and hop.attempts == 2
    assert checked == [("grow" if stage == "hang" else stage)]
    ((where, cause),) = hop.rollbacks
    assert isinstance(cause, HopError)
    c = eng.counts()
    assert c["done"] == len(LENS) and c["dropped"] == 0


# ---------------------------------------------------------------------------
# The slot helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tree_helpers_walk_the_tuple_state_as_jax_tree(arch):
    """The port's tree helpers descend into the decode state's tuples:
    ``sorted_leaves`` gives JAX's flatten order of the JAX package's state,
    ``tree_map`` keeps the tuple structure, and ``tree_unflatten`` inverts
    ``tree_leaves``."""
    from repro_torch.tree import (same_structure, sorted_leaves, tree_map,
                                  tree_unflatten)
    cfg = ARCHS[arch]
    st = tmodel.init_decode_state(cfg, 2, 8, device="cpu")["caches"]
    want = jax.tree.leaves(jmodel.init_decode_state(jax_cfg(cfg), 2, 8)[
        "caches"])
    got = sorted_leaves(st)
    assert [tuple(x.shape) for x in got] == [x.shape for x in want]
    assert all(np.array_equal(bridge.to_numpy(a), np.asarray(b))
               for a, b in zip(got, want))
    plus = tree_map(lambda x, y: x + y, st, st)
    assert isinstance(plus, tuple) and same_structure(plus, st)
    assert not same_structure(plus, list(st))
    back = tree_unflatten(st, tree_leaves(plus))
    assert all(a is b for a, b in zip(tree_leaves(back), tree_leaves(plus)))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_write_slot_takes_the_jax_prefill_state(models, arch):
    """The engine's exact-length prefill of a 2-token prompt (shorter than
    the conv tail) and of a 150-token one (past the mLSTM's 128-token
    chunk), written into slot 1 of a state whose rows hold another
    session's values: row 1 equals the JAX prefill's state (its conv tail
    zero on the left, the sLSTM stabiliser at its start value), the other
    rows are untouched; ``slot_bytes`` counts one row."""
    cfg, m = ARCHS[arch], models[arch]
    cap = 160
    prefill_one, _, insert = make_serving_fns(cfg, cap, "dense")
    for T in (2, 150):
        toks = _prompts(cfg, (T,))[0]
        logits, caches1 = prefill_one(m["tp"], torch.tensor([toks]), T)
        jl, jst = jmodel.prefill(m["jp"], jax_cfg(cfg),
                                 {"tokens": jnp.asarray([toks])}, max_len=cap)
        got = bridge.to_numpy(caches1)
        want = to_numpy(jst["caches"])
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= STATE_TOL * max(np.abs(b).max(),
                                                          1e-30)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl[0]),
                                   atol=STATE_TOL * np.abs(jl).max())
        state = {"caches": tmodel.init_decode_state(
            cfg, SLOTS, cap, device="cpu")["caches"],
            "pos": torch.zeros((SLOTS,), dtype=torch.long)}
        gen = torch.Generator().manual_seed(T)
        for leaf in tree_leaves(state["caches"]):
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
        old = [t.clone() for t in tree_leaves(state["caches"])]
        state = insert(state, caches1, T, 1)
        assert int(state["pos"][1]) == T
        for a, b, c in zip(tree_leaves(state["caches"]), old,
                           tree_leaves(caches1)):
            assert torch.equal(a[:, 1], c[:, 0])
            assert torch.equal(a[:, [0, 2]], b[:, [0, 2]])
        if T == 2:
            conv = (state["caches"][0]["conv"][:, 1])
            assert conv.shape[1] == cfg.conv_kernel - 1
            assert not conv[:, 0].any() and conv[:, -1].any()
            if arch == "xlstm":
                assert bool((state["caches"][1]["m"][:, 1] > -1e29).all())
    sizes = tmodel.slot_bytes(state["caches"])
    full = tmodel.init_decode_state(cfg, 1, cap, device="cpu")["caches"]
    total = sum(t.numel() * t.element_size() for t in tree_leaves(full))
    assert sizes["recurrent"] + sizes["attention"] == total
    assert (sizes["attention"] > 0) == (arch == "zamba2")
    with pytest.raises(ValueError, match="does not fit"):
        tmodel.write_slot(state["caches"],
                          tmodel.init_decode_state(cfg, 1, cap + 1,
                                                   device="cpu")["caches"]
                          if arch == "zamba2" else
                          tmodel.init_decode_state(cfg, 2, cap,
                                                   device="cpu")["caches"],
                          0)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_refusals_name_their_roadmap_items(models, arch):
    cfg, m = ARCHS[arch], models[arch]
    with pytest.raises(NotImplementedError,
                       match="the other families, e2: speculation for "
                             "recurrent families"):
        _engine(m["tp"], cfg, spec_k=2)
    eng = _engine(m["tp"], cfg)
    for mode, where in (("grow", "can_grow_cache"),
                        ("replay", "depth_replay_plan")):
        with pytest.raises(ValueError, match=where) as err:
            HopController(eng, tc.grow_target(cfg), m["top"],
                          cache_mode=mode)
        assert "the other families, e: the engine for recurrent " \
               "families" in str(err.value)
    with pytest.warns(UserWarning, match="paged KV layout unsupported"):
        paged = ServingEngine(m["tp"], cfg, slots=2, prompt_budget=8,
                              gen_budget=4, device="cpu")
    assert paged.kv_layout == "dense" and paged.kv_fallback
    assert paged.alloc is None and not paged.keep_residual
    with pytest.raises(ValueError, match="no paged layout"):
        make_serving_fns(cfg, 32, "paged")


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------
def _argv(cfg, *extra):
    return ["--arch", cfg.name[:-len("-smoke")], "--smoke", "--batch", "2",
            "--prompt-len", "8", "--gen", "4", *extra]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_launcher_lock_step_and_live(models, arch, capsys):
    """The launcher serves both families lock-step (hot-grown at start) and
    through the engine with a live LiGO hop on the CPU: re-prefill, 0
    dropped, the per-slot state line in place of the paged-KV line."""
    cfg = ARCHS[arch]
    res = serve.main(_argv(cfg, "--grow-to", "2x", "--device", "cpu"))
    assert res["cfg"].name == cfg.name + "-grown"
    assert res["tokens"].shape == (2, 4)
    assert res["launches"]["ligo_blend_expand_grouped"] == 0
    capsys.readouterr()
    res = serve.main(_argv(cfg, "--grow-to", "2x", "--live-grow-at", "2",
                           "--device", "cpu"))
    out = capsys.readouterr().out
    eng, hop = res["engine"], res["hop"]
    assert hop.completed and hop.cache_path == "reprefill"
    assert eng.counts()["done"] == 4 and eng.counts()["dropped"] == 0
    assert "0 dropped" in out and "cache: reprefill" in out
    assert "[state] per slot: " + cfg.name + " recurrent" in out
    assert "[paged]" not in out and "kernel launches: K1 0, K3 0" in out
    b, a = res["slot_bytes"]["before"], res["slot_bytes"]["after"]
    assert a["recurrent"] > b["recurrent"] > 0
    assert a == tmodel.slot_bytes(eng.state["caches"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_live_refusals_and_no_card(arch):
    cfg = ARCHS[arch]
    live = _argv(cfg, "--grow-to", "2x", "--live-grow-at", "2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(live)
    with pytest.raises(NotImplementedError, match="e2: speculation"):
        serve.main(live + ["--device", "cpu", "--speculative", "2"])
    for mode in ("grow", "replay"):
        with pytest.raises(ValueError, match=f"cache_mode='{mode}'"):
            serve.main(live + ["--device", "cpu", "--cache-mode", mode])
