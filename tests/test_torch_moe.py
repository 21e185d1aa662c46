"""The port's MoE family and dense→MoE upcycling against the JAX package's,
on the CPU at smoke sizes, float32, on bridged numpy parameters.

- ``apply_moe``: output, router loss and the capacity's keep mask for smoke
  mixtral and qwen3-moe, drop-free (capacity 8.0), drop-heavy (1.0) and
  with a zero router, where every token ties across the experts and the
  tie order decides which tokens the capacity drops;
- the MoE model: forward, prefill (mixtral past its window: the ring
  cache), decode steps, ``loss_fn`` and its gradients;
- upcycling: the grown tree leaf for leaf on the plan (both routes) and
  legacy engines into the ``MOE`` and ``MOE_PAD`` targets of
  ``tests/test_upcycle.py``, the created router zero and float32, the
  dense model's logits kept, the replicated AdamW moments,
  ``grow(method="upcycle")`` and ``grow(method="ligo")`` across the hop;
- MoE→MoE plan growth (5-D expert stacks on K1's route) and its gradients;
- ``check_growable``'s messages; the lossless-cache gate and the in-place
  cache migration against re-prefill; the trajectory hash of a
  ``"grow": "moe"`` stage and the port's runner resuming a JAX run through
  it; the live upcycle hop's tokens against the JAX engine's.

Tolerances (scale-normalised per leaf unless said): bitwise where both
packages compute the same exact products (identity operators, copies);
1e-5 for one forward or apply; 1e-4 for gradients, LiGO-phase losses and
trained parameters (the reference's train-parity bound).
"""
import dataclasses
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jc                                   # noqa: E402
from repro.core import apply_ligo as jax_apply_ligo          # noqa: E402
from repro.core import init_ligo_params as jax_init_ligo     # noqa: E402
from repro.core import spec as jspec                         # noqa: E402
from repro.core.grow import grow as jax_grow                 # noqa: E402
from repro.core.grow_cache import (grow_decode_state as jax_grow_state,  # noqa: E402
                                   is_lossless_operator as jax_lossless)
from repro.core.upcycle import upcycle_operator as jax_upcycle  # noqa: E402
from repro.models import init_params as jax_init_params      # noqa: E402
from repro.models import loss_fn as jax_loss_fn              # noqa: E402
from repro.models import model as jmodel                     # noqa: E402
from repro.models import moe as jmoe                         # noqa: E402
from repro.optim import adamw_init as jax_adamw_init         # noqa: E402
from repro.optim import adamw_update as jax_adamw_update     # noqa: E402
from repro.optim import grow_adamw_state as jax_grow_adamw   # noqa: E402
from repro.serving import HopController as JaxHop            # noqa: E402
from repro.serving import ServingEngine as JaxEngine         # noqa: E402
import repro_torch.configs as tc                             # noqa: E402
from repro_torch import bridge, optim as to                  # noqa: E402
from repro_torch.configs.paper_models import BERT_SMALL      # noqa: E402
from repro_torch.core import (apply_ligo, grow, plan_for,    # noqa: E402
                              upcycle_operator)
from repro_torch.core import spec as tspec                   # noqa: E402
from repro_torch.core.grow_cache import (can_grow_cache,     # noqa: E402
                                         grow_decode_state,
                                         is_lossless_operator)
from repro_torch.data import batch_for_step                  # noqa: E402
from repro_torch.models import loss_fn, model as tmodel      # noqa: E402
from repro_torch.models import moe as tmoe                   # noqa: E402
from repro_torch.serving import HopController, ServingEngine  # noqa: E402
from repro_torch.serving.engine import make_serving_fns      # noqa: E402
from repro_torch.tree import sorted_leaves, tree_leaves      # noqa: E402
from repro_torch.trajectory import TrajectoryConfig, TrajectoryRunner  # noqa: E402
from torch_parity import assert_close, jax_cfg, to_numpy     # noqa: E402

# tests/test_upcycle.py's dense GQA source and its MoE twins (capacity 8.0:
# the upcycled models drop no token)
DENSE = BERT_SMALL.scaled(
    name="upc-dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
    d_head=8, d_ff=64, vocab_size=64, max_seq=64, dtype="float32",
    norm="rms", objective="clm", encoder_only=False, causal=True,
    capacity_factor=8.0)
MOE = tc.moe_target(DENSE, n_experts=4, top_k=2)
MOE_PAD = tc.moe_target(DENSE, n_experts=4, top_k=2, ff_mult=1.5)

MIX = tc.smoke_config(tc.get_config("mixtral-8x7b"))      # window 32
# qwen3-moe's query width is not its d_model (32 x 128 = 4096 against
# 2048): the smoke twin keeps that with d_head 32 (4 x 32 = 128 against 64)
QWEN = tc.smoke_config(tc.get_config("qwen3-moe-30b-a3b")).scaled(d_head=32)
ARCHS = {"mixtral": MIX, "qwen3-moe": QWEN}


def _bridge(tree):
    return bridge.to_torch(to_numpy(tree))


def _jax_params(cfg, seed=0):
    """The JAX package's init, compiled whole (its eager draws are slow)."""
    jc_ = jax_cfg(cfg)
    return jax.jit(lambda k: jax_init_params(jc_, k))(
        jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def dense():
    jp = _jax_params(DENSE)
    return jp, _bridge(jp)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------
def test_moe_configs_match_the_reference():
    for name in ("mixtral-8x7b", "qwen3-moe-30b-a3b"):
        ours, theirs = tc.get_config(name), jc.get_config(name)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert (ours.q_dim, ours.kv_dim) == (theirs.q_dim, theirs.kv_dim)
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
    assert tc.get_config("qwen3-moe-30b-a3b").q_dim == 4096 != 2048
    src = tc.smoke_config(tc.get_config("llama3-8b"))
    for kw in ({}, {"n_experts": 8, "top_k": 4, "ff_mult": 1.5}):
        assert dataclasses.asdict(tc.moe_target(src, **kw)) \
            == dataclasses.asdict(jc.moe_target(jax_cfg(src), **kw))
    with pytest.raises(ValueError, match="dense source") as ours:
        tc.moe_target(MIX)
    with pytest.raises(ValueError) as theirs:
        jc.moe_target(jax_cfg(MIX))
    assert str(ours.value) == str(theirs.value)
    for cfg in (MIX, QWEN, MOE):
        p = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        assert sum(x.numel() for x in tree_leaves(p)) == cfg.param_count()
        assert p["layers"]["moe"]["moe"]["router"].dtype == torch.float32
        assert "mlp" not in p["layers"]["moe"]         # mixtral has a d_ff
        want = jax.eval_shape(lambda: _jax_params(cfg))
        assert jax.tree.structure(bridge.to_numpy(p)) \
            == jax.tree.structure(want)
        for a, b in zip(sorted_leaves(p), jax.tree.leaves(want)):
            assert tuple(a.shape) == b.shape


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------
def _jax_keep(p, x, cfg):
    """The JAX layer's keep mask, from its own routing lines."""
    N, D = x.shape[0] * x.shape[1], x.shape[2]
    E, k = cfg.n_experts, cfg.experts_top_k
    C = int(math.ceil(k * N * cfg.capacity_factor / E))
    probs = jax.nn.softmax(x.reshape(N, D).astype(jnp.float32) @ p["router"])
    _, top_e = jax.lax.top_k(probs, k)
    oh = jax.nn.one_hot(top_e.reshape(-1), E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, axis=-1)
    return np.asarray(pos < C)


@pytest.mark.parametrize("case", ["drop-free", "drop-heavy", "zero-router"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_apply_moe_matches_jax(arch, case):
    cfg = ARCHS[arch].scaled(capacity_factor={"drop-free": 8.0,
                                              "drop-heavy": 1.0,
                                              "zero-router": 1.25}[case])
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jax_cfg(cfg))
    if case == "zero-router":
        jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    x = np.random.RandomState(1).randn(2, 12, cfg.d_model).astype(np.float32)
    want, want_aux = jmoe.apply_moe(jp, jnp.asarray(x), jax_cfg(cfg))
    got, aux, keep = tmoe.apply_moe(_bridge(jp), torch.from_numpy(x), cfg,
                                    return_keep=True)
    want_keep = _jax_keep(jp, jnp.asarray(x), cfg)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert_close(got, want, rel=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    n_drop = int((~keep).sum())
    if case == "drop-free":
        assert n_drop == 0
    else:
        assert n_drop > 0, case
    if case == "zero-router":
        # every token ties: the stable top-k picks experts 0..k-1, as
        # jax.lax.top_k does
        _, top_e = tmoe.top_k_stable(torch.full((5, cfg.n_experts), 0.25),
                                     cfg.experts_top_k)
        assert top_e.tolist() == [list(range(cfg.experts_top_k))] * 5


# ---------------------------------------------------------------------------
# The MoE model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_model_matches_jax(arch):
    """forward (hidden and the summed router loss), prefill past mixtral's
    window, three decode steps, loss_fn and (mixtral's) its gradients."""
    cfg = ARCHS[arch]
    assert QWEN.q_dim == 2 * QWEN.d_model
    jp = _jax_params(cfg)
    tp = _bridge(jp)
    T = 40                                  # > mixtral's smoke window of 32
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, T))
    jh, _, jaux = jmodel.forward(jp, jax_cfg(cfg), {"tokens": jnp.asarray(toks)})
    th, _, taux = tmodel.forward(tp, cfg, {"tokens": torch.from_numpy(toks)},
                                 return_aux=True)
    assert_close(th, jh, rel=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)

    jl, jst = jmodel.prefill(jp, jax_cfg(cfg), {"tokens": jnp.asarray(toks)},
                             max_len=T + 3)
    tl, tst = tmodel.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                             max_len=T + 3)
    assert_close(tl, jl, rel=1e-5)
    assert_close(tst["caches"], jst["caches"], rel=1e-5)
    nxt = np.argmax(np.asarray(jl), -1)[:, None]
    for _ in range(3):
        jl, jst = jmodel.decode_step(jp, jax_cfg(cfg), jst,
                                     {"tokens": jnp.asarray(nxt)})
        tl, tst = tmodel.decode_step(tp, cfg, tst,
                                     {"tokens": torch.from_numpy(nxt)})
        assert_close(tl, jl, rel=1e-5)
        nxt = np.argmax(np.asarray(jl), -1)[:, None]

    if arch != "mixtral":
        return
    host = batch_for_step(cfg, 0, 2, 16, seed=3)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jax_cfg(cfg),
                              {k: jnp.asarray(v) for k, v in host.items()}),
        has_aux=True))(jp)
    leaves = sorted_leaves(tp)          # jax.tree.leaves' order
    for x in leaves:
        x.requires_grad_(True)
    tloss, tm = loss_fn(tp, cfg, {k: torch.as_tensor(v)
                                  for k, v in host.items()})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tm["aux"].item(), float(jm["aux"]), rtol=1e-5)
    assert tm["aux"].item() > 0.0
    got_g = jax.tree.unflatten(jax.tree.structure(to_numpy(jg)),
                               [x.grad.numpy() for x in leaves])
    assert_close_np(got_g, jg, rel=1e-4)


def assert_close_np(got, want, rel):
    from conftest import assert_trees_close_normalized
    assert_trees_close_normalized(jax.tree.leaves(got), jax.tree.leaves(
        to_numpy(want)), rel=rel)


# ---------------------------------------------------------------------------
# Upcycling: the grown tree, function preservation, moments, grow()
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route", ["plan-plain", "plan-k1", "legacy"])
@pytest.mark.parametrize("cfg2", [MOE, MOE_PAD], ids=["same-ff", "padded-ff"])
def test_upcycle_grown_tree_matches_jax(dense, cfg2, route):
    """Leaf for leaf, bitwise (every product is a copy through an identity
    or [I; 0] factor); each expert the dense FFN zero-padded; the created
    router zero and float32; the dense model's logits kept (<= 1e-6)."""
    jp, tp = dense
    engine = "legacy" if route == "legacy" else "plan"
    want = jax_apply_ligo(jax_upcycle(jax_cfg(DENSE), jax_cfg(cfg2)), jp,
                          jax_cfg(DENSE), jax_cfg(cfg2), engine=engine)
    op = upcycle_operator(DENSE, cfg2, device="cpu")
    got = apply_ligo(op, tp, DENSE, cfg2, engine=engine,
                     **({} if engine == "legacy"
                        else {"use_kernel": route == "plan-k1"}))
    assert_close(got, want, rel=0)
    moe = got["layers"]["moe"]["moe"]
    assert moe["router"].dtype == torch.float32 and not moe["router"].any()
    src = tp["layers"]["attn"]["mlp"]
    for leaf in sorted(set(src) & {"w1", "w3"}):
        for e in range(cfg2.n_experts):
            assert torch.equal(moe[leaf][:, e, :, :DENSE.d_ff], src[leaf])
    assert not moe["w1"][..., DENSE.d_ff:].any()
    # the copies are whole tensors, not views of one another
    assert moe["w1"].stride(1) != 0
    moe["w1"][:, 0] += 1.0
    assert torch.equal(moe["w1"][:, 1, :, :DENSE.d_ff], src["w1"])
    moe["w1"][:, 0] -= 1.0
    toks = np.random.RandomState(1).randint(0, DENSE.vocab_size, (2, 12))
    lg1, _ = tmodel.prefill(tp, DENSE, {"tokens": torch.from_numpy(toks)})
    lg2, _ = tmodel.prefill(got, cfg2, {"tokens": torch.from_numpy(toks)})
    assert float((lg1 - lg2).abs().max()) <= 1e-6


def _jax_state(jp, seed):
    rng = np.random.RandomState(seed)
    g = jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape), p.dtype), jp)
    _, st = jax_adamw_update(g, jax_adamw_init(jp), jp, lr=1e-3)
    return st


def test_upcycle_grows_adamw_moments_replicated(dense):
    """m and v ride the operator: every expert inherits the dense FFN's
    moments verbatim (1² == 1), the created router's are zero; equal to the
    JAX package's bit for bit; grow() carries them the same way."""
    jp, tp = dense
    js = _jax_state(jp, 0)
    ts = to.AdamWState(m=_bridge(js.m), v=_bridge(js.v), count=int(js.count))
    want = jax_grow_adamw(js, jax_upcycle(jax_cfg(DENSE), jax_cfg(MOE)),
                          jax_cfg(DENSE), jax_cfg(MOE))
    got = to.grow_adamw_state(ts, upcycle_operator(DENSE, MOE, device="cpu"),
                              DENSE, MOE)
    assert got.count == int(want.count) == 1
    assert_close(got.m, want.m, rel=0)
    assert_close(got.v, want.v, rel=0)
    for tree, src in ((got.m, ts.m), (got.v, ts.v)):
        moe = tree["layers"]["moe"]["moe"]
        assert not moe["router"].any()
        for e in range(MOE.n_experts):
            assert torch.equal(moe["w2"][:, e],
                               src["layers"]["attn"]["mlp"]["w2"])
    big, info = grow(tp, DENSE, MOE, method="upcycle", opt_state=ts)
    assert info["method"] == "upcycle"
    assert_close(info["opt_state"].v, want.v, rel=0)
    assert big["layers"]["moe"]["moe"]["w2"].shape == (
        MOE.n_layers, MOE.n_experts, MOE.moe_d_ff, MOE.d_model)


def _batches(cfg, jax_side, n):
    for i in range(n):
        host = batch_for_step(cfg, i, 2, 16, seed=5)
        yield ({k: jnp.asarray(v) for k, v in host.items()} if jax_side
               else {k: torch.as_tensor(v) for k, v in host.items()})


def test_grow_ligo_across_the_hop_matches_jax(dense, monkeypatch):
    """grow(method="ligo") dense -> MoE: a LiGO phase through the hop (its
    operator gradients through the plan's K1/K2 route, plain versions here)
    from the JAX package's own draw: the phase's losses and the grown model
    within 1e-4."""
    import importlib
    tgrow = importlib.import_module("repro_torch.core.grow")
    jp, tp = dense
    key = jax.random.PRNGKey(4)
    jop = jax_init_ligo(key, jax_cfg(DENSE), jax_cfg(MOE_PAD))
    top = _bridge(jop)
    assert sorted(top["depth"]) == ["attn"]
    ours = tgrow.init_ligo_params(torch.Generator().manual_seed(0), DENSE,
                                  MOE_PAD, device="cpu")
    assert jax.tree.structure(bridge.to_numpy(ours)) \
        == jax.tree.structure(to_numpy(jop))
    monkeypatch.setattr(tgrow, "init_ligo_params", lambda *a, **k: top)
    jbig, jinfo = jax_grow(jp, jax_cfg(DENSE), jax_cfg(MOE_PAD), method="ligo",
                           key=key, data_it=_batches(MOE_PAD, True, 3),
                           ligo_steps=3)
    tbig, tinfo = grow(tp, DENSE, MOE_PAD, method="ligo",
                       data_it=_batches(MOE_PAD, False, 3), ligo_steps=3)
    np.testing.assert_allclose(tinfo["ligo_losses"], jinfo["ligo_losses"],
                               rtol=1e-4)
    assert_close(tbig, jbig, rel=1e-4)
    assert tbig["layers"]["moe"]["moe"]["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# MoE -> MoE growth on the plan
# ---------------------------------------------------------------------------
def test_moe_to_moe_plan_growth_matches_jax():
    """smoke mixtral -> its grow_target: the expert stacks (L1, E, a, b) and
    the float32 router ride K1's route as 5-D stacks (plain versions here);
    the apply on both routes and the operator's gradients equal JAX's."""
    c1, c2 = MIX, tc.grow_target(MIX)
    jp = _jax_params(c1)
    tp = _bridge(jp)
    jop = jax_init_ligo(jax.random.PRNGKey(6), jax_cfg(c1), jax_cfg(c2))
    top = _bridge(jop)
    plan = plan_for(c1, c2, tp)
    k1 = {p: g.shape for g in plan.groups if g.kernel_ok for p in g.paths}
    assert k1["moe/w1"] == (c1.n_layers, c1.n_experts, c1.d_model,
                            c1.moe_d_ff)
    assert k1["moe/router"] == (c1.n_layers, c1.d_model, c1.n_experts)
    want = jax_apply_ligo(jop, jp, jax_cfg(c1), jax_cfg(c2), engine="legacy")
    for uk in (False, True):
        assert_close(apply_ligo(top, tp, c1, c2, use_kernel=uk), want,
                     rel=1e-5)
    assert_close(apply_ligo(top, tp, c1, c2, engine="legacy"), want,
                 rel=1e-5)

    host = batch_for_step(c2, 0, 2, 16, seed=3)

    def jloss(op):
        big = jax_apply_ligo(op, jp, jax_cfg(c1), jax_cfg(c2))
        return jax_loss_fn(big, jax_cfg(c2),
                           {k: jnp.asarray(v) for k, v in host.items()})[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jop)
    leaves = sorted_leaves(top)
    for x in leaves:
        x.requires_grad_(True)
    big = apply_ligo(top, tp, c1, c2, use_kernel=True)
    tl, _ = loss_fn(big, c2, {k: torch.as_tensor(v) for k, v in host.items()})
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    # the blends of mixtral's unused dense-MLP leaves take no gradient in
    # the port, a zero one in JAX
    got_g = jax.tree.unflatten(jax.tree.structure(to_numpy(jg)), [
        np.zeros(tuple(x.shape), np.float32) if x.grad is None
        else x.grad.numpy() for x in leaves])
    assert_close_np(got_g, jg, rel=1e-4)


# ---------------------------------------------------------------------------
# check_growable
# ---------------------------------------------------------------------------
GROWABLE = {
    "moe-to-dense": (MOE, DENSE),
    "no-dense-ffn": (DENSE.scaled(name="noff", d_ff=0), MOE),
    "layer-norm": (DENSE.scaled(name="ln", norm="layer"),
                   MOE.scaled(name="ln-moe", norm="layer")),
    "act-change": (DENSE, MOE.scaled(name="swiglu-moe", act="swiglu")),
    "expert-count": (MIX, tc.grow_target(MIX).scaled(name="e8",
                                                    n_experts=8)),
    "pattern": (DENSE, MOE.scaled(name="attn-moe",
                                  block_pattern=("attn",))),
}


@pytest.mark.parametrize("pair", sorted(GROWABLE))
def test_check_growable_messages_match_jax(pair):
    c1, c2 = GROWABLE[pair]
    with pytest.raises(ValueError) as ours:
        tspec.check_growable(c1, c2)
    with pytest.raises(ValueError) as theirs:
        jspec.check_growable(jax_cfg(c1), jax_cfg(c2))
    assert str(ours.value) == str(theirs.value)
    tspec.check_growable(DENSE, MOE)              # the supported hop


# ---------------------------------------------------------------------------
# Cache migration across the upcycle hop
# ---------------------------------------------------------------------------
def _prompts(cfg, n=4):
    rng = np.random.RandomState(0)
    return [list(rng.randint(0, cfg.vocab_size, 4 + i % 4)) for i in range(n)]


def test_upcycle_cache_grows_in_place_like_jax(dense):
    """The upcycle operator is lossless in both packages, the cache grows
    in place across the families, the grown cache equals JAX's, and decode
    from it equals decode from a re-prefill (<= 1e-5) and the dense
    model's own decode (<= 1e-6)."""
    jp, tp = dense
    op = upcycle_operator(DENSE, MOE, device="cpu")
    jop = jax_upcycle(jax_cfg(DENSE), jax_cfg(MOE))
    assert is_lossless_operator(op, DENSE, MOE)
    assert jax_lossless(jop, jax_cfg(DENSE), jax_cfg(MOE))
    assert can_grow_cache(DENSE, MOE)
    assert not is_lossless_operator(_bridge(jax_init_ligo(
        jax.random.PRNGKey(0), jax_cfg(DENSE), jax_cfg(MOE))), DENSE, MOE)
    big = apply_ligo(op, tp, DENSE, MOE)
    eng = ServingEngine(tp, DENSE, slots=2, prompt_budget=8, gen_budget=12,
                        device="cpu", kv_layout="dense")
    jeng = JaxEngine(jp, jax_cfg(DENSE), slots=2, prompt_budget=8,
                     gen_budget=12, mesh=None, kv_layout="dense")
    for e in (eng, jeng):
        for p in _prompts(DENSE):
            e.submit(p, max_new=12)
        for _ in range(3):
            e.step()
    migrated = grow_decode_state(eng.state, op, DENSE, MOE)
    want = jax_grow_state(jeng.state, jop, jax_cfg(DENSE), jax_cfg(MOE))
    assert_close(migrated["caches"], want["caches"], rel=1e-6)
    oracle = eng.reprefill_state(big, MOE)
    _, decode, _ = make_serving_fns(MOE, eng.cap)
    _, decode_small, _ = make_serving_fns(DENSE, eng.cap)
    live = [i for i, r in enumerate(eng.slot_req) if r is not None]
    toks = torch.zeros((eng.slots, 1), dtype=torch.long)
    for i in live:
        toks[i, 0] = eng.slot_req[i].tokens[-1]
    sa, sb, ss = migrated, oracle, eng.state
    with torch.no_grad():
        for _ in range(3):
            la, sa = decode(big, sa, toks)
            lb, sb = decode(big, sb, toks)
            ls, ss = decode_small(tp, ss, toks)
            assert float((la[live] - ls[live]).abs().max()) <= 1e-6
            assert float((la[live] - lb[live]).abs().max()) <= 1e-5
            toks = torch.argmax(la, -1)[:, None]


# ---------------------------------------------------------------------------
# Trajectories through a "grow": "moe" stage
# ---------------------------------------------------------------------------
MOE_SCHEDULE = {
    "arch": "llama3-8b", "smoke": True, "batch": 2, "seq": 16, "lr": 1e-3,
    "checkpoint_every": 3,
    "stages": [{"steps": 3},
               {"steps": 3, "grow": "moe", "method": "upcycle"}]}


def test_moe_trajectory_matches_the_jax_runner(tmp_path):
    """The schedule hashes as in the JAX package; the JAX runner pauses at
    the end of stage 0; the port's runner resumes that directory, upcycles
    (the AdamW moments grown across the hop) and trains the MoE stage, and
    ends within 1e-4 of the JAX package's own resume of a copy."""
    from repro import trajectory as jt
    traj = TrajectoryConfig.from_json(MOE_SCHEDULE)
    jtraj = jt.TrajectoryConfig.from_json(MOE_SCHEDULE)
    assert traj.hash() == jtraj.hash()
    assert [st.cfg.config_hash() for st in traj.stages] \
        == [st.cfg.config_hash() for st in jtraj.stages]
    assert traj.stages[1].cfg.family == "moe"
    d, d2 = str(tmp_path / "ck"), str(tmp_path / "ck_jax")
    paused = jt.TrajectoryRunner(jtraj, ckpt_dir=d, verbose=False).run(
        max_steps=3)
    assert paused["status"] == "paused"
    shutil.copytree(d, d2)
    want = jt.TrajectoryRunner(jtraj, ckpt_dir=d2, verbose=False).run()
    got = TrajectoryRunner(traj, ckpt_dir=d, verbose=False,
                           device="cpu").run()
    assert got["status"] == want["status"] == "done"
    assert got["cfg"].name == want["cfg"].name == traj.stages[1].cfg.name
    np.testing.assert_allclose([l for *_, l in got["history"]],
                               [l for *_, l in want["history"]], rtol=1e-4)
    assert_close(got["params"], want["params"], rel=1e-4)


# ---------------------------------------------------------------------------
# The live upcycle hop
# ---------------------------------------------------------------------------
def _hop_run(eng, reqs, hop, hop_at=2):
    def on_step(e):
        if e.decode_steps >= hop_at and hop.attempts == 0:
            hop.begin()
        if hop.attempts:
            hop.poll()
    eng.run(on_step=on_step)
    while not hop.poll():
        pass
    assert all(r.status == "done" for r in reqs)
    return [list(r.tokens) for r in reqs]


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_live_upcycle_hop_tokens_match_jax(dense, layout):
    """The engine hops DENSE -> MOE mid-serve: the cache grows in place, the
    swap lands at the JAX hop's decode step, and every request's tokens
    equal the JAX engine's."""
    jp, tp = dense
    jeng = JaxEngine(jp, jax_cfg(DENSE), slots=2, prompt_budget=8,
                     gen_budget=16, mesh=None, kv_layout=layout)
    jreqs = [jeng.submit(p, max_new=16) for p in _prompts(DENSE)]
    jhop = JaxHop(jeng, jax_cfg(MOE),
                  jax_upcycle(jax_cfg(DENSE), jax_cfg(MOE)), background=False)
    want = _hop_run(jeng, jreqs, jhop)
    eng = ServingEngine(tp, DENSE, slots=2, prompt_budget=8, gen_budget=16,
                        device="cpu", kv_layout=layout)
    reqs = [eng.submit(p, max_new=16) for p in _prompts(DENSE)]
    hop = HopController(eng, MOE, upcycle_operator(DENSE, MOE, device="cpu"),
                        background=False)
    got = _hop_run(eng, reqs, hop)
    assert hop.completed and jhop.completed
    assert hop.cache_path == jhop.cache_path == "grow"
    assert hop.swap_at_step == jhop.swap_at_step
    assert eng.cfg.name == MOE.name and eng.counts()["dropped"] == 0
    assert got == want
