"""The port's LEMON and MHA→GQA merge operators, direct depth map and LiGO
parameter count against the JAX package's (the oracles of
``tests/test_ligo_operators.py``, ``tests/test_serving.py`` and
``tests/test_upcycle.py``): the LEMON and GQA-merge operators are
deterministic, so both packages build them bit for bit; growing with
LEMON changes no logit bit; a GQA merge grows the JAX package's tree, the
group-mean oracle's K/V and the block-repeated ``wo``, and carries AdamW's
``v`` through the squared (grouped-gamma) operator; the Prop.-1 depth
patterns equal the direct layer rearrangement."""
import jax
import numpy as np
import pytest
import torch

from repro.core import count_ligo_params as jax_count
from repro.core import init_ligo_params as jax_init_ligo
from repro.core import operators as jops
from repro.core.grow import grow as jax_grow
from repro.models.model import init_params as jax_init_params
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import grow_adamw_state as jax_grow_adamw
from repro_torch import bridge, optim as to
from repro_torch.configs.paper_models import BERT_SMALL
from repro_torch.core import (apply_ligo, count_ligo_params, grow,
                              init_ligo_params)
from repro_torch.core import operators as ops
from repro_torch.models.model import prefill

from torch_parity import assert_close, jax_cfg, to_numpy

TINY = BERT_SMALL.scaled(
    name="srv-tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
    d_head=8, d_ff=64, vocab_size=64, max_seq=64, dtype="float32",
    objective="clm", encoder_only=False, causal=True)
WIDE = TINY.scaled(name="srv-wide", n_heads=8, n_kv_heads=8, d_ff=96)
# tests/test_upcycle.py's MHA source and GQA merge target
MHA = BERT_SMALL.scaled(
    name="upc-mha", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
    d_head=8, d_ff=64, vocab_size=64, max_seq=64, dtype="float32",
    norm="rms", objective="clm", encoder_only=False, causal=True,
    capacity_factor=8.0)
GQA = MHA.scaled(name="upc-gqa", n_kv_heads=2)


@pytest.fixture(scope="module")
def small():
    return bridge.to_torch(to_numpy(jax_init_params(jax_cfg(TINY),
                                                    jax.random.PRNGKey(0))))


def test_lemon_operator_is_the_references_bit_for_bit():
    got = bridge.to_numpy(ops.lemon_operator(TINY, WIDE, device="cpu"))
    want = to_numpy(jops.lemon_operator(jax_cfg(TINY), jax_cfg(WIDE)))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_lemon_grow_is_bitwise_function_preserving(small):
    """The exactness oracle: zero-pad growth changes no logit bit."""
    big, info = grow(small, TINY, WIDE, method="lemon")
    assert info["method"] == "lemon"
    toks = torch.as_tensor(np.random.RandomState(1).randint(
        0, TINY.vocab_size, (2, 8)))
    with torch.no_grad():
        lg1, _ = prefill(small, TINY, {"tokens": toks}, max_len=16)
        lg2, _ = prefill(big, WIDE, {"tokens": toks}, max_len=16)
    assert torch.equal(lg1, lg2)


@pytest.mark.parametrize("target", [
    TINY.scaled(name="w", d_model=48, d_head=12),     # d_model changes norms
    TINY.scaled(name="d", n_layers=4),                # depth is never lossless
    TINY.scaled(name="g", n_heads=8, n_kv_heads=4, d_ff=96),  # GQA averages
], ids=["d_model", "depth", "gqa"])
def test_lemon_operator_rejects_lossy_targets(target):
    with pytest.raises(ValueError):
        ops.lemon_operator(TINY, target, device="cpu")
    with pytest.raises(ValueError):
        jops.lemon_operator(jax_cfg(TINY), jax_cfg(target))


@pytest.mark.parametrize("kind,L2,idx", [
    ("stackbert", 6, np.arange(6) % 2),
    ("interpolation", 4, np.arange(4) * 2 // 4),
])
def test_prop1_depth_patterns_equal_direct(small, kind, L2, idx):
    cfg2 = TINY.scaled(name="t2", n_layers=L2)
    make = (ops.stackbert_operator if kind == "stackbert"
            else ops.interpolation_operator)
    with torch.no_grad():
        grown = apply_ligo(make(TINY, cfg2, device="cpu"), small, TINY, cfg2)
    direct = ops.direct_depth_map(small["layers"]["attn"], idx)
    jdirect = jops.direct_depth_map(
        jax.tree.map(np.asarray, bridge.to_numpy(small["layers"]["attn"])),
        idx)
    g, d = bridge.to_numpy(grown["layers"]["attn"]), bridge.to_numpy(direct)
    for a, b, c in zip(jax.tree.leaves(g), jax.tree.leaves(d),
                       jax.tree.leaves(to_numpy(jdirect))):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)


def test_ligo_param_count_matches_and_is_small():
    """LiGO params are O(D₂D₁ + L₂L₁): the same count in both packages,
    a small fraction of Θ at d_model 256 → 384."""
    c1 = BERT_SMALL.scaled(name="w1", n_layers=6, d_model=256, n_heads=8,
                           n_kv_heads=8, d_head=32, d_ff=1024,
                           vocab_size=8192, max_seq=64, dtype="float32")
    c2 = c1.scaled(name="w2", n_layers=12, d_model=384, d_head=48,
                   d_ff=1536)
    n = count_ligo_params(init_ligo_params(torch.Generator().manual_seed(1),
                                           c1, c2, device="cpu"))
    assert n == jax_count(jax_init_ligo(jax.random.PRNGKey(1), jax_cfg(c1),
                                        jax_cfg(c2)))
    assert n < c2.param_count() * 0.15, (n, c2.param_count())


# ---------------------------------------------------------------------------
# MHA -> GQA head merging
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mha():
    jp = jax_init_params(jax_cfg(MHA), jax.random.PRNGKey(3))
    return jp, bridge.to_torch(to_numpy(jp))


def test_gqa_merge_operator_is_the_references_bit_for_bit():
    got = bridge.to_numpy(ops.gqa_merge_operator(MHA, GQA, device="cpu"))
    want = to_numpy(jops.gqa_merge_operator(jax_cfg(MHA), jax_cfg(GQA)))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got["width"]["k"].shape == (GQA.kv_dim, MHA.kv_dim)


@pytest.mark.parametrize("target", [
    (GQA, GQA.scaled(name="gqa-1", n_kv_heads=1)),            # source not MHA
    (MHA, MHA.scaled(name="same-kv")),                        # no merge
    (MHA, GQA.scaled(name="wide", d_model=48, d_head=12)),    # d_model
    (MHA, GQA.scaled(name="deep", n_layers=4)),               # n_layers
    (MHA, GQA.scaled(name="ff", d_ff=96)),                    # d_ff
    (MHA.scaled(name="mha6", n_heads=6, n_kv_heads=6),
     GQA.scaled(name="gqa4", n_heads=6, n_kv_heads=4)),       # not divisible
], ids=["source-gqa", "no-merge", "d_model", "n_layers", "d_ff",
        "indivisible"])
def test_gqa_merge_operator_refusals_match_jax(target):
    c1, c2 = target
    with pytest.raises(ValueError) as ours:
        ops.gqa_merge_operator(c1, c2, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jops.gqa_merge_operator(jax_cfg(c1), jax_cfg(c2))
    assert str(ours.value) == str(theirs.value)


def test_gqa_merge_grow_matches_jax_and_the_group_mean_oracle(mha):
    """grow(method="gqa_merge") on the plan (both routes) and the legacy
    walk: the JAX package's tree bit for bit where both compute the same
    products, within 1e-6 otherwise; each merged K/V head the mean of its
    group's source heads; wo block-repeated over each group's query heads
    with no extra 1/G."""
    jp, tp = mha
    want, _ = jax_grow(jp, jax_cfg(MHA), jax_cfg(GQA), method="gqa_merge")
    big, info = grow(tp, MHA, GQA, method="gqa_merge")
    assert info["method"] == "gqa_merge"
    for got in (big, apply_ligo(info["operator"], tp, MHA, GQA,
                                use_kernel=False),
                apply_ligo(info["operator"], tp, MHA, GQA, engine="legacy")):
        assert_close(got, want, rel=1e-6)
    dh, G = MHA.d_head, MHA.n_heads // GQA.n_kv_heads
    for leaf in ("wk", "wv"):
        src = tp["layers"]["attn"][leaf].numpy()
        dst = big["layers"]["attn"][leaf].numpy()
        for g in range(GQA.n_kv_heads):
            grp = src[..., g * G * dh:(g + 1) * G * dh]
            mean = grp.reshape(grp.shape[:-1] + (G, dh)).mean(-2)
            np.testing.assert_allclose(dst[..., g * dh:(g + 1) * dh], mean,
                                       atol=1e-6)
    E_kv = np.kron(np.repeat(np.eye(GQA.n_kv_heads), G, axis=1) / G,
                   np.eye(dh))
    E_direct = np.repeat(E_kv.reshape(GQA.n_kv_heads, dh, -1), G, axis=0
                         ).reshape(MHA.n_heads * dh, -1)
    np.testing.assert_allclose(
        big["layers"]["attn"]["wo"].numpy(),
        np.einsum("oi,lij->loj", E_direct,
                  tp["layers"]["attn"]["wo"].numpy()), atol=1e-6)


def test_gqa_merge_v_moment_uses_squared_gamma(mha):
    """The hop engages the grouped gamma: v maps through the squared
    expanders, G (1/G)² per merged column over unit v; m and v equal the
    JAX package's grow_adamw_state, and grow() carries them the same."""
    jp, tp = mha
    assert to.hop_uses_grouped_gamma(MHA, GQA)
    rng = np.random.RandomState(0)
    g = jax.tree.map(lambda p: np.asarray(rng.randn(*p.shape), np.float32),
                     jp)
    _, js = jax_adamw_update(g, jax_adamw_init(jp), jp, lr=1e-3)
    ts = to.AdamWState(m=bridge.to_torch(to_numpy(js.m)),
                       v=bridge.to_torch(to_numpy(js.v)), count=int(js.count))
    want = jax_grow_adamw(js, jops.gqa_merge_operator(jax_cfg(MHA),
                                                      jax_cfg(GQA)),
                          jax_cfg(MHA), jax_cfg(GQA))
    _, info = grow(tp, MHA, GQA, method="gqa_merge", opt_state=ts)
    assert_close(info["opt_state"].m, want.m, rel=1e-6)
    assert_close(info["opt_state"].v, want.v, rel=1e-6)
    ones = ts._replace(v=bridge.to_torch(jax.tree.map(
        np.ones_like, bridge.to_numpy(ts.v))))
    got = to.grow_adamw_state(ones, ops.gqa_merge_operator(MHA, GQA,
                                                           device="cpu"),
                              MHA, GQA)
    G = MHA.n_heads // GQA.n_kv_heads
    v_wk = got.v["layers"]["attn"]["wk"].numpy()
    np.testing.assert_allclose(v_wk, np.full_like(v_wk, G * (1 / G) ** 2),
                               atol=1e-6)
