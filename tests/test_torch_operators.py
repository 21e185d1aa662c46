"""The port's LEMON operator, direct depth map and LiGO parameter count
against the JAX package's (the oracles of ``tests/test_ligo_operators.py``
and ``tests/test_serving.py``): the LEMON operator is deterministic, so
both packages build it bit for bit, and growing with it changes no logit
bit; the Prop.-1 depth patterns equal the direct layer rearrangement."""
import jax
import numpy as np
import pytest
import torch

from repro.core import count_ligo_params as jax_count
from repro.core import init_ligo_params as jax_init_ligo
from repro.core import operators as jops
from repro.models.model import init_params as jax_init_params
from repro_torch import bridge
from repro_torch.configs.paper_models import BERT_SMALL
from repro_torch.core import (apply_ligo, count_ligo_params, grow,
                              init_ligo_params)
from repro_torch.core import operators as ops
from repro_torch.models.model import prefill

from torch_parity import jax_cfg, to_numpy

TINY = BERT_SMALL.scaled(
    name="srv-tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
    d_head=8, d_ff=64, vocab_size=64, max_seq=64, dtype="float32",
    objective="clm", encoder_only=False, causal=True)
WIDE = TINY.scaled(name="srv-wide", n_heads=8, n_kv_heads=8, d_ff=96)


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
