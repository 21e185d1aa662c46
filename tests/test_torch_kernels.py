"""Kernels K1 and K2: their plain versions against the JAX package's Pallas
kernels (in interpret mode) and einsum oracles, the CPU dispatch in ``ops``,
and the differentiable ``ligo_blend_expand_grouped_vjp`` (gradcheck).

Tolerance: f32 throughout, ≤ 1e-5 scale-normalised (the
``assert_trees_close_normalized`` rule): only the summation order differs.
K2's ``dw`` is a long sum that cancels, so its error is normalised entry by
entry by the sum of the absolute values of its terms.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                      # noqa: E402

from conftest import assert_trees_close_normalized           # noqa: E402
from repro.kernels.ligo_expand import (                      # noqa: E402
    ligo_blend_expand_grouped as jax_k1)
from repro.kernels.ligo_expand_bwd import (                  # noqa: E402
    ligo_blend_expand_bwd_fused as jax_k2)
from repro.kernels.ref import ligo_blend_expand_bwd_ref as jax_bwd_ref  # noqa: E402
from repro.kernels.ref import ligo_blend_expand_grouped_ref as jax_ref  # noqa: E402
from repro_torch.kernels import ligo_expand, ligo_expand_bwd, ops, ref  # noqa: E402

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
    assert ops.launch_counts() == {"ligo_blend_expand_grouped": 0,
                                   "ligo_blend_expand_bwd_fused": 0,
                                   "flash_attention": 0}


def test_kernel_wrapper_refuses_cpu_tensors():
    w, B, W = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 2, 4, 4, 4))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ligo_expand.ligo_blend_expand_grouped(w, B, W)
    with pytest.raises(ValueError, match="CUDA"):
        ligo_expand_bwd.ligo_blend_expand_bwd(
            w, B, W, torch.zeros((1, 2, 1, 4, 4)))
    assert ops.launch_counts() == {"ligo_blend_expand_grouped": 0,
                                   "ligo_blend_expand_bwd_fused": 0,
                                   "flash_attention": 0}


def _cotangent(G, E, L1, L2, I, A, Bd, seed=0):
    return np.random.RandomState(seed + 1).randn(
        G, L2, E, I, Bd).astype(np.float32)


def _dw_term_scale(w, B, W, dP):
    """Σ_{e,a,b} |(Bᵀ dP)[g,k,e,a,b]| |W[g,l,e,a,b]|: the size of dw's
    terms, which bounds its rounding error entry by entry."""
    T = np.abs(np.einsum("ia,gkeib->gkeab", B.astype(np.float64),
                         dP.astype(np.float64)))
    return np.einsum("gkeab,gleab->gkl", T, np.abs(W.astype(np.float64)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k2_plain_matches_jax_kernel_and_oracle(shape):
    w, B, W = _inputs(*shape)
    dP = _cotangent(*shape)
    got = ref.ligo_blend_expand_bwd_ref(*(torch.from_numpy(a)
                                          for a in (w, B, W, dP)))
    assert [g.dtype for g in got] == [torch.float32] * 3
    args = [jnp.asarray(a) for a in (w, B, W, dP)]
    scale = _dw_term_scale(w, B, W, dP)
    for want in (jax_k2(*args, interpret=True), jax_bwd_ref(*args)):
        assert [tuple(g.shape) for g in got] == [a.shape for a in want]
        dw_err = np.abs(got[0].numpy() - np.asarray(want[0])) / scale
        assert dw_err.max() <= 1e-5, dw_err.max()
        assert_trees_close_normalized([g.numpy() for g in got[1:]],
                                      [np.asarray(a) for a in want[1:]],
                                      rel=1e-5, names=["dB", "dW"])


def test_k2_plain_keeps_operand_dtypes():
    w, B, W = _inputs(2, 1, 3, 4, 24, 16, 40, seed=2)
    dP = _cotangent(2, 1, 3, 4, 24, 16, 40, seed=2)
    bf = torch.bfloat16
    dw, dB, dW = ref.ligo_blend_expand_bwd_ref(
        torch.from_numpy(w), torch.from_numpy(B).to(bf),
        torch.from_numpy(W).to(bf), torch.from_numpy(dP).to(bf))
    assert (dw.dtype, dB.dtype, dW.dtype) == (torch.float32, bf, bf)


def test_vjp_gradcheck_float64():
    rng = np.random.RandomState(3)
    w, B, W = (torch.from_numpy(rng.randn(*s)).requires_grad_(True)
               for s in ((2, 3, 2), (5, 4), (2, 2, 2, 4, 3)))
    assert torch.autograd.gradcheck(
        lambda w, B, W: ops.ligo_blend_expand_grouped_vjp(w, B, W),
        (w, B, W))


def test_vjp_plain_route_gradients_and_launches():
    """The Function's backward on CPU tensors is K2's plain version: its
    gradients equal autograd through K1's plain version, the cotangent may
    arrive strided, and no kernel launches."""
    w, B, W = (torch.from_numpy(a) for a in _inputs(2, 2, 3, 4, 12, 6, 5))
    proj = torch.from_numpy(np.random.RandomState(4).randn(5, 7)
                            .astype(np.float32))
    ops.reset_launch_counts()
    grads = []
    for fn in (ops.ligo_blend_expand_grouped_vjp,
               ref.ligo_blend_expand_grouped_ref):
        xs = [x.clone().requires_grad_(True) for x in (w, B, W)]
        P = fn(*xs)
        (P[:, :, 1] @ proj).sin().sum().backward()    # a strided cotangent
        grads.append([x.grad for x in xs])
    assert_trees_close_normalized([g.numpy() for g in grads[0]],
                                  [g.numpy() for g in grads[1]], rel=1e-5)
    # a frozen operand gets no gradient
    P = ops.ligo_blend_expand_grouped_vjp(w.requires_grad_(True), B, W)
    P.sum().backward()
    assert w.grad is not None and B.grad is None and W.grad is None
    assert ops.launch_counts() == {"ligo_blend_expand_grouped": 0,
                                   "ligo_blend_expand_bwd_fused": 0,
                                   "flash_attention": 0}
    with pytest.raises(ValueError, match="CUDA"):
        ops.ligo_blend_expand_grouped_vjp(w, B, W, use_kernel=True)
