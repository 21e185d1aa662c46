"""Kernel K1's plain version against the JAX package's Pallas kernel (in
interpret mode) and its einsum oracle, and the CPU dispatch in ``ops``.

Tolerance: f32 throughout, ≤ 1e-5 scale-normalised (the
``assert_trees_close_normalized`` rule): only the summation order differs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                      # noqa: E402

from conftest import assert_trees_close_normalized           # noqa: E402
from repro.kernels.ligo_expand import (                      # noqa: E402
    ligo_blend_expand_grouped as jax_k1)
from repro.kernels.ref import ligo_blend_expand_grouped_ref as jax_ref  # noqa: E402
from repro_torch.kernels import ligo_expand, ops, ref         # noqa: E402

# (G, E, L1, L2, I, A, Bd): the ragged shape of the card check, a G = E = 1
# leaf, and the hypothesis-pinned A=50, Bd=45 shape of the JAX suite.
SHAPES = [(3, 2, 3, 5, 200, 50, 130), (1, 1, 2, 4, 24, 16, 40),
          (1, 2, 1, 1, 1, 50, 45)]


def _inputs(G, E, L1, L2, I, A, Bd, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(G, L2, L1).astype(np.float32)
    B = rng.randn(I, A).astype(np.float32)
    W = rng.randn(G, L1, E, A, Bd).astype(np.float32)
    return w, B, W


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k1_plain_matches_jax_kernel_and_oracle(shape):
    w, B, W = _inputs(*shape)
    got = ref.ligo_blend_expand_grouped_ref(
        torch.from_numpy(w), torch.from_numpy(B), torch.from_numpy(W))
    assert got.dtype == torch.float32
    want_kernel = jax_k1(jnp.asarray(w), jnp.asarray(B), jnp.asarray(W),
                         interpret=True)
    want_ref = jax_ref(jnp.asarray(w), jnp.asarray(B), jnp.asarray(W))
    assert tuple(got.shape) == tuple(want_kernel.shape)
    for want in (want_kernel, want_ref):
        assert_trees_close_normalized([got.numpy()], [np.asarray(want)],
                                      rel=1e-5)


def test_k1_plain_keeps_b_dtype_and_accumulates_in_f32():
    w, B, W = _inputs(2, 1, 3, 4, 24, 16, 40, seed=1)
    Bb = torch.from_numpy(B).to(torch.bfloat16)
    Wb = torch.from_numpy(W).to(torch.bfloat16)
    got = ref.ligo_blend_expand_grouped_ref(torch.from_numpy(w), Bb, Wb)
    assert got.dtype == torch.bfloat16
    want = ref.ligo_blend_expand_grouped_ref(
        torch.from_numpy(w).double(), Bb.double(), Wb.double())
    # one bf16 rounding of an f32 sum: within half an ulp (2^-9) of the max
    assert_trees_close_normalized([got.float().numpy()],
                                  [want.float().numpy()], rel=2 ** -8)


def test_ops_dispatches_cpu_tensors_to_the_plain_version():
    w, B, W = (torch.from_numpy(a) for a in _inputs(2, 2, 3, 5, 20, 7, 9))
    ops.reset_launch_counts()
    got = ops.ligo_blend_expand_grouped(w, B, W)
    assert torch.equal(got, ref.ligo_blend_expand_grouped_ref(w, B, W))
    assert ops.launch_counts() == {"ligo_blend_expand_grouped": 0}


def test_kernel_wrapper_refuses_cpu_tensors():
    w, B, W = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 2, 4, 4, 4))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ligo_expand.ligo_blend_expand_grouped(w, B, W)
    assert ops.launch_counts() == {"ligo_blend_expand_grouped": 0}
