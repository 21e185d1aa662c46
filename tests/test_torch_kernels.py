"""Kernels K1 and K2: their plain versions and the launch schedules of the
hand-written kernels against the JAX package's Pallas kernels (in interpret
mode) and einsum oracles, the routes of the GEMM core they share, the CPU
dispatch in ``ops``, and the differentiable ``ligo_blend_expand_grouped_vjp``
(gradcheck).

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


def _k2_schedule(w, B, W, dP, q_dtype=torch.float32):
    """K2's launch sequence in plain torch, float32 accumulation: the dP
    blend Q (stored in ``q_dtype``), the three products as ``X · Yᵀ`` over
    the K-major (transposed) operands the tensor-core GEMM reads — dB in the
    wrapper's contiguous split parts, reduced in order — and dw by the
    wrapper's chunks of the E·I·Bd axis, reduced in order."""
    G, L2, L1 = w.shape
    I, A = B.shape
    E, Bd = W.shape[2], W.shape[4]
    Z = G * L1 * E
    f = torch.float32
    Q = torch.einsum("gkl,gkeib->gleib", w.to(f), dP.to(f)).to(q_dtype).to(f)
    Qz, Wz = Q.reshape(Z, I, Bd), W.to(f).reshape(Z, A, Bd)
    Bt, Qt, Wt = B.to(f).T, Qz.transpose(1, 2), Wz.transpose(1, 2)
    dW = Bt @ Qt.transpose(1, 2)                        # X = Bᵀ, Y = Qᵀ
    S = ligo_expand_bwd.db_splits(I, A, Z)
    parts = [sum((Qz[r] @ Wz[r].T for r in range(s * Z // S,
                                                  (s + 1) * Z // S)),
                 torch.zeros(I, A)) for s in range(S)]
    dB = sum(parts[1:], parts[0])
    U = B.to(f) @ Wt.transpose(1, 2)                    # X = B, Y = Wᵀ
    n = E * I * Bd
    chunk = ligo_expand_bwd.dw_chunk(L1)
    dPf = dP.to(f).reshape(G, L2, n)
    Uf = U.reshape(G, L1, n)
    dw_parts = [torch.einsum("gkj,glj->gkl", dPf[..., j:j + chunk],
                             Uf[..., j:j + chunk]) for j in range(0, n, chunk)]
    dw = sum(dw_parts[1:], dw_parts[0])
    return (dw, dB.to(B.dtype),
            dW.reshape(G, L1, E, A, Bd).to(W.dtype))


# small ragged shapes with G, E > 1, a leaf with more layers, the pinned one
SCHEDULE_SHAPES = SHAPES + [(2, 3, 4, 6, 72, 40, 56)]


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k2_schedule_matches_plain_and_jax_kernel(shape):
    """The min-FLOP schedule K2 launches (Q blend; dW = BᵀQ, dB = Σ Q Wᵀ and
    U = B W through transposed operands; dw by chunks) against K2's plain
    version and the JAX fused kernel in interpret mode, in float32."""
    w, B, W = _inputs(*shape)
    dP = _cotangent(*shape)
    got = _k2_schedule(*(torch.from_numpy(a) for a in (w, B, W, dP)))
    plain = ref.ligo_blend_expand_bwd_ref(*(torch.from_numpy(a)
                                            for a in (w, B, W, dP)))
    args = [jnp.asarray(a) for a in (w, B, W, dP)]
    scale = _dw_term_scale(w, B, W, dP)
    for want in ([x.numpy() for x in plain], jax_k2(*args, interpret=True)):
        assert [tuple(g.shape) for g in got] == [np.shape(a) for a in want]
        dw_err = np.abs(got[0].numpy() - np.asarray(want[0])) / scale
        assert dw_err.max() <= 1e-5, dw_err.max()
        assert_trees_close_normalized([g.numpy() for g in got[1:]],
                                      [np.asarray(a) for a in want[1:]],
                                      rel=1e-5, names=["dB", "dW"])


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k2_schedule_bf16_q_rounding(shape):
    """The one rounding the schedule adds in bf16: Q stored in bf16 before
    the products. With bf16 operands, dB and dW rounded to bf16 as the
    kernel writes them, the schedule stays within the card's bf16 tolerance
    (1e-2 normalised; dw by Σ|terms|) of the float32 plain version."""
    bf = torch.bfloat16
    w, B, W = _inputs(*shape, seed=5)
    dP = _cotangent(*shape, seed=5)
    B, W, dP = (torch.from_numpy(a).to(bf) for a in (B, W, dP))
    w = torch.from_numpy(w)
    got = _k2_schedule(w, B, W, dP, q_dtype=bf)
    assert [g.dtype for g in got] == [torch.float32, bf, bf]
    want = ref.ligo_blend_expand_bwd_ref(w, B.float(), W.float(), dP.float())
    scale = _dw_term_scale(*(x.float().numpy() for x in (w, B, W, dP)))
    assert (np.abs(got[0].numpy() - want[0].numpy()) / scale).max() <= 1e-2
    for g, r in zip(got[1:], want[1:]):
        err = (g.float() - r).abs().max() / r.abs().max()
        assert float(err) <= 1e-2, float(err)


def _k1_schedule(w, B, W):
    """K1's launch sequence in plain torch, float32 accumulation: the
    product U = B · (Wᵀ)ᵀ of every (g, l, e) slab over the K-major operand
    Wᵀ that the tensor-core GEMM reads, in float32; the blend
    P[g, k, e] = Σ_l w[g, k, l] U[g, l, e] over l in order, in float32; one
    cast to B's dtype at the end."""
    G, L2, L1 = w.shape
    I, A = B.shape
    E, Bd = W.shape[2], W.shape[4]
    f = torch.float32
    Wt = W.to(f).reshape(G * L1 * E, A, Bd).transpose(1, 2)   # (Z, Bd, A)
    U = (B.to(f) @ Wt.transpose(1, 2)).reshape(G, L1, E, I, Bd)
    P = torch.zeros((G, L2, E, I, Bd))
    for l in range(L1):
        P = P + w.to(f)[:, :, l, None, None, None] * U[:, l, None]
    return P.to(B.dtype)


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_schedule_matches_plain_and_jax_kernel(shape):
    """The expand-then-blend schedule K1 launches (U = B W over the L1
    source layers, then the blend over l) against K1's plain version (which
    blends first) and the JAX Pallas kernel in interpret mode, in float32:
    only the order of the sums differs."""
    w, B, W = _inputs(*shape)
    got = _k1_schedule(*(torch.from_numpy(a) for a in (w, B, W)))
    plain = ref.ligo_blend_expand_grouped_ref(
        *(torch.from_numpy(a) for a in (w, B, W)))
    want = jax_k1(jnp.asarray(w), jnp.asarray(B), jnp.asarray(W),
                  interpret=True)
    for r in (plain.numpy(), np.asarray(want)):
        assert tuple(got.shape) == r.shape
        assert_trees_close_normalized([got.numpy()], [r], rel=1e-5)


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_schedule_bf16_rounds_once(shape):
    """In bf16 the schedule adds no rounding that the function's definition
    lacks: the products of bf16 operands are exact in float32, U and the
    blend stay in float32, and P is rounded once. So each entry of its bf16
    result lies within half a bf16 ulp of the float32 plain version (the
    error of rounding that result to bf16 once), plus a margin of 1e-5 of
    the largest |P| for the float32 sums taken in another order, and the
    whole is within the card's bf16 tolerance (1e-2 normalised)."""
    bf = torch.bfloat16
    w, B, W = _inputs(*shape, seed=6)
    w = torch.from_numpy(w)
    B, W = (torch.from_numpy(a).to(bf) for a in (B, W))
    got = _k1_schedule(w, B, W)
    assert got.dtype == bf
    want = ref.ligo_blend_expand_grouped_ref(w, B.float(), W.float())
    top = float(want.abs().max())
    err = (got.float() - want).abs()
    assert float(err.max()) / top <= 1e-2
    _, exp = torch.frexp(want)           # |want| in [2^(exp-1), 2^exp)
    half_ulp = torch.where(want == 0, torch.zeros(()),
                           torch.ldexp(torch.ones_like(want), exp - 9))
    once = (want.to(bf).float() - want).abs()
    assert bool((once <= half_ulp).all())
    excess = float((err - half_ulp).max()) / top
    assert excess <= 1e-5, (excess, float(once.max()) / top)


@pytest.mark.parametrize("dtype,dims,want", [
    (torch.bfloat16, (1024, 768, 768), True),       # K1: wq, wk, wv, wo
    (torch.bfloat16, (1024, 768, 3072), True),      # K1: mlp/w1
    (torch.bfloat16, (4096, 3072, 768), True),      # K1: mlp/w2
    (torch.float32, (200, 50, 130), False),         # K1: ragged f32
    (torch.bfloat16, (200, 136, 72), True),         # K1: aligned ragged
    (torch.bfloat16, (200, 50, 130), False),        # K1: unaligned
])
def test_k1_tensor_core_route(dtype, dims, want):
    """K1 takes the route K2 would take at the same widths: one shared rule
    for the GEMM core, held at K1's shapes on the card."""
    assert ligo_expand.tensor_core_route is ligo_expand_bwd.tensor_core_route
    assert ligo_expand.tma_aligned is ligo_expand_bwd.tma_aligned
    assert ligo_expand.tensor_core_route(dtype, *dims) is want


@pytest.mark.parametrize("dtype,dims,want", [
    (torch.bfloat16, (4096, 3072, 768), True),
    (torch.bfloat16, (200, 136, 72), True),
    (torch.float32, (4096, 3072, 768), False),
    (torch.bfloat16, (200, 50, 130), False),
    (torch.bfloat16, (1, 50, 45), False),
    (torch.bfloat16, (1024, 768, 772), False),
    (torch.bfloat16, (1024, 768, 768), True),
])
def test_k2_tensor_core_route(dtype, dims, want):
    """bf16 with I, A, Bd multiples of 8 takes the tensor-core GEMM; f32 or
    an unaligned width the FMA one."""
    assert ligo_expand_bwd.tensor_core_route(dtype, *dims) is want


@pytest.mark.parametrize("offset", [0, 1, 8])
def test_k2_tma_aligned(offset):
    """A view off a 16-byte boundary comes back as an aligned copy of the
    same values; an aligned one comes back as itself."""
    flat = torch.arange(64 * 64 + 8, dtype=torch.bfloat16)
    x = flat[offset:offset + 64 * 64].view(64, 64)
    y = ligo_expand_bwd.tma_aligned(x)
    assert y.data_ptr() % 16 == 0 and torch.equal(x, y)
    assert (y is x) == (x.data_ptr() % 16 == 0)


def test_k2_launch_geometry():
    """The dB split fills ~2 blocks per SM on small tile grids and never
    exceeds the contraction's entries; the dw chunk keeps the staged U rows
    within 48 KB."""
    assert ligo_expand_bwd.db_splits(1024, 768, 12) == 6     # 48 tiles
    assert ligo_expand_bwd.db_splits(4096, 3072, 12) == 1    # 768 tiles
    assert ligo_expand_bwd.db_splits(200, 50, 3) == 3
    for L1 in (1, 3, 12, 24, 100, 384):
        chunk = ligo_expand_bwd.dw_chunk(L1)
        assert chunk % 32 == 0 and 4 * L1 * chunk <= 48 * 1024
    assert ligo_expand_bwd.dw_chunk(12) == 1024


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_plain_keeps_u_equal_to_b_times_w(shape):
    """``keep_u`` hands back U = B W (float32, (G, L1, E, I, Bd)) beside the
    same P, bit for bit, as without it."""
    w, B, W = (torch.from_numpy(a) for a in _inputs(*shape))
    P, U = ref.ligo_blend_expand_grouped_ref(w, B, W, keep_u=True)
    assert torch.equal(P, ref.ligo_blend_expand_grouped_ref(w, B, W))
    assert U.dtype == torch.float32
    want = np.einsum("ia,gleab->gleib", B.double().numpy(),
                     W.double().numpy())
    assert U.shape == want.shape
    assert_trees_close_normalized([U.numpy()], [want], rel=1e-6)
    Pb, Ub = ref.ligo_blend_expand_grouped_ref(
        w, B.to(torch.bfloat16), W.to(torch.bfloat16), keep_u=True)
    assert (Pb.dtype, Ub.dtype) == (torch.bfloat16, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SCHEDULE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k2_plain_fed_k1s_u_is_bitwise_its_own(shape, dtype):
    """The plain K2 fed the plain K1's U gives the bits of the plain K2
    that computes U itself; without dW it gives the same dw and dB, bit for
    bit, and no dW."""
    w, B, W = _inputs(*shape)
    dP = _cotangent(*shape)
    w = torch.from_numpy(w)
    B, W, dP = (torch.from_numpy(a).to(dtype) for a in (B, W, dP))
    _, U = ref.ligo_blend_expand_grouped_ref(w, B, W, keep_u=True)
    own = ref.ligo_blend_expand_bwd_ref(w, B, W, dP)
    fed = ref.ligo_blend_expand_bwd_ref(w, B, W, dP, U=U)
    assert all(torch.equal(a, b) for a, b in zip(own, fed))
    dw, dB, dW = ref.ligo_blend_expand_bwd_ref(w, B, W, dP, U=U,
                                               need_dW=False)
    assert dW is None and torch.equal(dw, own[0]) and torch.equal(dB, own[1])


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_and_k2_halves_compose_to_the_whole(shape):
    """K1's two steps apart (U, then the blend of U) give K1's function,
    and K2's two halves (the dP blend and dw; dB and dW from Q) give K2's,
    all plain, in float32."""
    w, B, W = (torch.from_numpy(a) for a in _inputs(*shape))
    dP = torch.from_numpy(_cotangent(*shape))
    U = ref.ligo_expand_ref(B, W)
    assert_trees_close_normalized(
        [ref.ligo_blend_ref(w, U, torch.float32).numpy()],
        [ref.ligo_blend_expand_grouped_ref(w, B, W).numpy()], rel=1e-5)
    dw, Q = ref.ligo_blend_bwd_ref(w, dP, U)
    dB, dW = ref.ligo_expand_bwd_ref(B, W, Q)
    whole = ref.ligo_blend_expand_bwd_ref(w, B, W, dP)
    assert all(torch.equal(a, b) for a, b in zip((dw, dB, dW), whole))


def test_operation_counts_with_and_without_u_and_dW():
    """K2's count drops one product for a given U and one for a skipped dW;
    its halves add up to the whole; K1's steps add up to K1; and the custom
    operators' flop formulas count exactly these on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    d = (2, 5, 3, 2, 40, 24, 16)
    G, L2, L1, E, I, A, Bd = d
    prod, blend = 2 * G * E * L1 * I * A * Bd, 2 * G * E * L2 * L1 * I * Bd
    full = ligo_expand_bwd.operation_count(*d)
    assert full == 3 * prod + 2 * blend
    assert ligo_expand_bwd.operation_count(*d, u_given=True) == full - prod
    assert ligo_expand_bwd.operation_count(*d, need_dW=False) == full - prod
    assert ligo_expand_bwd.operation_count(
        *d, u_given=True, need_dW=False) == prod + 2 * blend
    halves = (ligo_expand_bwd.operation_count(*d, u_given=True,
                                              need_dW=False, need_dB=False)
              + ligo_expand_bwd.operation_count(*d, q_given=True,
                                                need_dw=False))
    assert halves == ligo_expand_bwd.operation_count(*d, u_given=True)
    assert (ligo_expand.operation_count(*d, stage="expand")
            + ligo_expand.operation_count(*d, stage="blend")
            == ligo_expand.operation_count(*d) == prod + blend)
    assert ligo_expand.least_operations(*d) <= prod + blend
    assert ligo_expand_bwd.least_operations(*d) <= full

    with FakeTensorMode():
        w, B, W = (torch.empty(s) for s in ((G, L2, L1), (I, A),
                                            (G, L1, E, A, Bd)))
        dP, U = torch.empty((G, L2, E, I, Bd)), torch.empty((G, L1, E, I, Bd))
        calls = [
            (lambda: ops._k1(w, B, W, True),
             ligo_expand.operation_count(*d)),
            (lambda: ops._k1_expand(B, W), prod),
            (lambda: ops._k1_blend(w, U, torch.float32), blend),
            (lambda: ops._k2(w, B, W, dP, None, True), full),
            (lambda: ops._k2(w, B, W, dP, U, False), prod + 2 * blend),
            (lambda: ops._k2_blend(w, dP, U), 2 * blend),
            (lambda: ops._k2_expand(B, W, U, False), prod),
        ]
        for fn, want in calls:
            with FlopCounterMode(display=False) as counter:
                fn()
            assert counter.get_total_flops() == want
