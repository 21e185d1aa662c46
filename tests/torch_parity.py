"""Shared pieces of the PyTorch-port parity tests (``test_torch_*.py``).

The same inputs, made from a numpy seed, go through the JAX reference and
the port; trees cross between the two as numpy arrays.
"""
import dataclasses

import jax
import numpy as np

from conftest import assert_trees_close_normalized
from repro.configs.base import ModelConfig as JaxModelConfig
from repro_torch import bridge
from repro_torch.configs import get_config

# A gpt2-shaped pair at test size: 2 -> 4 layers, d 64 -> 96, vocab 256,
# float32, learned positions, LayerNorm with biases, tied embeddings.
TINY1 = get_config("gpt2-base").scaled(
    name="gpt2-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab_size=256, dtype="float32", max_seq=64)
TINY2 = TINY1.scaled(name="gpt2-tiny-grown", n_layers=4, d_model=96,
                     n_heads=6, n_kv_heads=6, d_ff=192)
TINY3 = TINY2.scaled(name="gpt2-tiny-grown2", n_layers=6, d_model=128,
                     n_heads=8, n_kv_heads=8, d_ff=256)


def jax_cfg(cfg) -> JaxModelConfig:
    """The JAX package's ModelConfig with the same field values."""
    return JaxModelConfig(**dataclasses.asdict(cfg))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def assert_close(got_torch, want_jax, rel):
    """Port tree (tensors) vs JAX tree, same structure, per-leaf
    scale-normalised: max |a - b| <= rel * max |b|."""
    got = bridge.to_numpy(got_torch)
    want = to_numpy(want_jax)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    names = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert_trees_close_normalized(got, want, rel=rel, names=names)
