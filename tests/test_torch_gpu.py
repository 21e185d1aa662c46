"""Card-only checks of the port's hand-written kernels against their plain
versions (marker ``gpu``; they skip where there is no CUDA device).

Run on the card with:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Shapes are those of ``chip_smoke.py``'s kernel phase: the six K1 groups of
the gpt2-base -> gpt2-medium hot-grow in bf16 (K2, the backward, runs on the
same groups in the LiGO phase), a ragged f32 shape, a pinned f32 shape
(I * Bd odd: the blends' scalar paths), an aligned ragged bf16
shape (the tensor-core GEMM K1 and K2 share) and an unaligned one (their
FMA GEMM); K1 and K2 each run twice there, to agree bit for bit; for K3, the
gpt2-medium and llama3-8b prefills, a sliding window, bert-large's
bidirectional shape, ragged and f32 shapes, ragged bf16 shapes on the
tensor-core kernel (T off its 128-row tile, S off a multiple of 8), bf16
at head widths it pads to its 64- or 128-wide tile (32, 40, 48, 80, 120;
at T = 1 with S odd too, the edges of TMA's zero fill and of the Vᵀ
pass's dh mask), a profiled dh-80 call that must run on it, bf16 rows it
does not take (unaligned rows at dh 32, 48, 64, 80 and 128), and every
body of the FMA kernel (8, 16 and 32 columns a thread, f32 and bf16).
Tolerance (scale-normalised): 1e-2 for bf16, whose output is rounded once
from an f32 sum on both sides; 1e-5 for f32 with TF32 off, where only the
summation order differs. K2's ``dw`` is a long sum that cancels: its error
is normalised entry by entry by the sum of the absolute values of its terms.
K3 takes the JAX kernel test's elementwise tolerance,
``|kernel - plain| <= tol + tol |plain|`` with tol 2e-2 (bf16), 2e-5 (f32).
The live engine runs on the card too: paged and dense give the same
tokens, and a background hop on its side stream completes while decode
steps land. Speculative decoding through a hop, at smoke size: greedy
speculation gives greedy decoding's tokens (paged and dense, deterministic
algorithms on), and a round maps every live slot's pages up to pos + K + 1
before its drafter launches. The observability layer on the kernel route:
a background hop's spans, and a profiler trace that names K1's and K3's
tensor-core kernels. The MoE family: K1 and K2 on E = 8 expert stacks and
on the float32 router's Bd = 8 group, and the stable top-k on a zero
router, where every token ties, choosing the CPU's experts. The
sequence-mixer families: K1 and K2 on a block-diagonal (``seg``) B with
identity segments and on xLSTM's Bd 8 gates group, bf16; K3 at zamba2's
d_head 80 and its grown d_head 120 (the tensor cores), also at B = 1 and the
odd lengths of the engine's exact-length prefills; the xLSTM and zamba2
smoke models' decode on the card against the CPU, and their live engine
through a LiGO hop on the card, its tokens the CPU engine's. The audio and
VLM families: K3 at hubert-xlarge's encode shapes (bidirectional, d_head
80 and 40) and qwen2-vl-72b's prefill shapes (64/8 heads, d_head 128 and
64); ``apply_mrope`` on the card against the CPU at qwen2-vl's head
shape, three distinct position streams (float32 <= 1e-6, bf16 within one
bf16 ulp); and hubert's encode at full width on the K3 route against the
plain attention route. The JAX package's public kernel wrappers
(``repro_torch.kernels``): ``ligo_blend_expand`` and ``ligo_grow`` launch
K1 once each, ``ligo_blend_expand_vjp`` K1 forward and K2 backward (its
gradients against the plain route's), ``ligo_blend_expand_bwd_fused`` K2
and ``flash_attention`` K3, each against its plain version, counted in
``launch_counts()`` and in the ``LAUNCH_COUNTS`` registry group.
"""
import importlib
import os
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (ligo_expand, ligo_expand_bwd,  # noqa: E402
                                 ops, ref)
from repro_torch.models import layers  # noqa: E402

# K3's wrapper module (the package's ``flash_attention`` is the function)
flash_attention = importlib.import_module(
    "repro_torch.kernels.flash_attention")

# name, dtype, (G, L2, L1, E, I, A, Bd)
LIGO_SHAPES = [
    ("wq", "bfloat16", (1, 24, 12, 1, 1024, 768, 768)),
    ("wk", "bfloat16", (1, 24, 12, 1, 1024, 768, 768)),
    ("wv", "bfloat16", (1, 24, 12, 1, 1024, 768, 768)),
    ("wo", "bfloat16", (1, 24, 12, 1, 1024, 768, 768)),
    ("mlp/w1", "bfloat16", (1, 24, 12, 1, 1024, 768, 3072)),
    ("mlp/w2", "bfloat16", (1, 24, 12, 1, 4096, 3072, 768)),
    ("ragged", "float32", (3, 5, 3, 2, 200, 50, 130)),
    # I * Bd odd: the scalar paths of K1's and K2's blends
    ("pinned", "float32", (1, 1, 1, 2, 1, 50, 45)),
    # the tensor-core GEMM with TMA's zero fill at every edge, and an
    # unaligned bf16 shape on the FMA GEMM
    ("aligned-ragged", "bfloat16", (2, 5, 3, 2, 200, 136, 72)),
    ("unaligned", "bfloat16", (2, 5, 3, 2, 200, 50, 130)),
]
TOL = {"bfloat16": 1e-2, "float32": 1e-5}

# name, dtype, (B, H, KV, T, S, dh, causal, window[, pad]); ``pad`` more
# elements in each row of the (B, T, heads, dh) storage (default 0)
K3_SHAPES = [
    ("gpt2-medium", "bfloat16", (8, 16, 16, 128, 128, 64, True, 0)),
    ("llama3-8b", "bfloat16", (4, 32, 8, 2048, 2048, 128, True, 0)),
    ("window", "bfloat16", (1, 32, 8, 4096, 4096, 128, True, 1024)),
    ("bidir", "bfloat16", (8, 16, 16, 512, 512, 64, False, 0)),
    ("ragged", "float32", (2, 6, 2, 200, 328, 64, True, 0)),
    ("ragged-window", "float32", (2, 6, 2, 200, 328, 64, True, 100)),
    ("gpt2-medium", "float32", (8, 16, 16, 128, 128, 64, True, 0)),
    ("dh48", "bfloat16", (2, 4, 2, 77, 77, 48, True, 0)),
    ("bf16-ragged", "bfloat16", (2, 6, 2, 200, 328, 128, True, 0)),
    ("bf16-ragged-window", "bfloat16", (2, 6, 2, 77, 333, 64, True, 100)),
    ("bf16-unaligned-rows", "bfloat16", (2, 6, 2, 200, 328, 64, True, 0, 4)),
    # zamba2's shared attention block at d_head 80 and, grown, 120: the
    # tensor-core kernel, dh padded to its 128-wide tile
    ("zamba2-dh80", "bfloat16", (2, 32, 32, 256, 256, 80, True, 0)),
    ("zamba2-dh120", "bfloat16", (2, 32, 32, 200, 200, 120, True, 0)),
    # the engine's exact-length prefills of a recurrent family: B = 1, T
    # off the kernel's tiles, at zamba2's d_head 80 and 120
    ("engine-T1-dh80", "bfloat16", (1, 32, 32, 1, 1, 80, True, 0)),
    ("engine-T37-dh80", "bfloat16", (1, 32, 32, 37, 37, 80, True, 0)),
    ("engine-T509-dh80", "bfloat16", (1, 32, 32, 509, 509, 80, True, 0)),
    ("engine-T1-dh120", "bfloat16", (1, 32, 32, 1, 1, 120, True, 0)),
    ("engine-T37-dh120", "bfloat16", (1, 32, 32, 37, 37, 120, True, 0)),
    ("engine-T509-dh120", "bfloat16", (1, 32, 32, 509, 509, 120, True, 0)),
    # hubert-xlarge's autograd-free encode (bidirectional, d_head 80, and 40
    # at its half model) and qwen2-vl-72b's prefill (64 query heads over 8,
    # d_head 128, and 64 at its half model): all on the tensor cores
    ("hubert-encode", "bfloat16", (8, 16, 16, 512, 512, 80, False, 0)),
    ("hubert-half", "bfloat16", (8, 16, 16, 512, 512, 40, False, 0)),
    ("qwen2-vl-prefill", "bfloat16", (4, 64, 8, 2048, 2048, 128, True, 0)),
    ("qwen2-vl-half", "bfloat16", (4, 64, 8, 2048, 2048, 64, True, 0)),
    # the FMA kernel's bodies at 8 and 32 columns a thread (dh <= 32, > 64)
    ("dh32-fma", "float32", (2, 4, 2, 77, 77, 32, True, 0)),
    ("dh32", "bfloat16", (2, 4, 2, 77, 77, 32, True, 0)),
    ("dh128-fma", "float32", (2, 4, 2, 77, 140, 128, False, 0)),
    ("dh128-unaligned-rows", "bfloat16", (2, 4, 2, 77, 140, 128, True, 0, 4)),
    # unaligned bf16 rows (pad 4) keep the FMA kernel's bf16 bodies at 8,
    # 16 and 32 columns a thread on the card
    ("dh32-unaligned-rows", "bfloat16", (2, 4, 2, 77, 140, 32, True, 0, 4)),
    ("dh48-unaligned-rows", "bfloat16", (2, 4, 2, 77, 140, 48, True, 0, 4)),
    ("dh80-unaligned-rows", "bfloat16", (2, 4, 2, 77, 140, 80, False, 0, 4)),
    # one query row against an odd number of keys at padded widths: TMA's
    # zero fill past T, S and dh, and the Vᵀ pass's dh mask, at both tiles
    ("dh80-T1-S333", "bfloat16", (2, 32, 32, 1, 333, 80, True, 0)),
    ("dh40-T1-S77", "bfloat16", (2, 16, 16, 1, 77, 40, False, 0)),
]
K3_TOL = {"bfloat16": 2e-2, "float32": 2e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built for sm_90a)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype,dims", LIGO_SHAPES,
                         ids=[f"{n}-{d}" for n, d, _ in LIGO_SHAPES])
def test_k1_kernel_matches_plain(cuda, name, dtype, dims):
    G, L2, L1, E, I, A, Bd = dims
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn((G, L2, L1), generator=gen, device=cuda) / L1 ** 0.5
    B = (torch.randn((I, A), generator=gen, device=cuda) / A ** 0.5).to(dt)
    W = torch.randn((G, L1, E, A, Bd), generator=gen, device=cuda).to(dt)
    assert ligo_expand.tensor_core_route(dt, I, A, Bd) is (
        dtype == "bfloat16" and name != "unaligned")
    ops.reset_launch_counts()
    got = ops.ligo_blend_expand_grouped(w, B, W)
    assert ops.launch_counts() == {"ligo_blend_expand_grouped": 1,
                                   "ligo_blend_expand_bwd_fused": 0,
                                   "flash_attention": 0}
    want = ref.ligo_blend_expand_grouped_ref(w, B, W)
    again = ligo_expand.ligo_blend_expand_grouped(w, B, W)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert got.dtype == dt and got.shape == want.shape
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= TOL[dtype]


@pytest.mark.gpu
def test_k1_tensor_map_failure_raises(cuda, monkeypatch):
    """A tensor map TMA cannot take (B's 100-byte rows, A = 50 forced onto
    the tensor-core route) makes K1's wrapper raise: no fallback to the FMA
    GEMM or to the plain version, and no launch counted."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    bf = torch.bfloat16
    B = torch.randn((64, 50), generator=gen, device=cuda).to(bf)
    w = torch.randn((1, 2, 2), generator=gen, device=cuda)
    W = torch.randn((1, 2, 1, 50, 64), generator=gen, device=cuda).to(bf)
    assert not ligo_expand.tensor_core_route(bf, 64, 50, 64)
    monkeypatch.setattr(ligo_expand, "tensor_core_route", lambda *args: True)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled"):
        ligo_expand.ligo_blend_expand_grouped(w, B, W)
    assert ops.launch_counts()["ligo_blend_expand_grouped"] == 0


@pytest.mark.gpu
def test_k1_misaligned_operands_match_aligned(cuda):
    """B and W given as views 2 bytes off a 16-byte boundary still take the
    tensor-core route (the wrapper copies them onto one) and give the same
    bits as the same values on aligned storage."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    bf = torch.bfloat16
    flat_B = torch.randn(64 * 64 + 1, generator=gen, device=cuda).to(bf)
    flat_W = torch.randn(2 * 64 * 64 + 1, generator=gen, device=cuda).to(bf)
    B, W = flat_B[1:].view(64, 64), flat_W[1:].view(1, 2, 1, 64, 64)
    assert B.data_ptr() % 16 == 2 and W.data_ptr() % 16 == 2
    w = torch.randn((1, 3, 2), generator=gen, device=cuda)
    assert ligo_expand.tensor_core_route(bf, 64, 64, 64)
    got = ligo_expand.ligo_blend_expand_grouped(w, B, W)
    want = ligo_expand.ligo_blend_expand_grouped(w, B.clone(), W.clone())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_k1_blend_shared_memory_limit_raises(cuda):
    """The blend stages w[g] in 48 KB of shared memory: at L1 = 600 (57.6 KB
    of staged w) the launcher refuses before anything launches, and the
    wrapper raises with the error text."""
    w = torch.randn((1, 24, 600), device=cuda)
    B = torch.randn((8, 8), device=cuda)
    W = torch.randn((1, 600, 1, 8, 8), device=cuda)
    before = ligo_expand.LAUNCHES
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        ligo_expand.ligo_blend_expand_grouped(w, B, W)
    assert ligo_expand.LAUNCHES == before


@pytest.mark.gpu
def test_k1_kernel_refuses_grad_and_mixed_dtypes(cuda):
    w = torch.randn((1, 2, 2), device=cuda)
    B = torch.randn((4, 3), device=cuda)
    W = torch.randn((1, 2, 1, 3, 5), device=cuda)
    with pytest.raises(TypeError):
        ligo_expand.ligo_blend_expand_grouped(w, B.to(torch.bfloat16), W)
    with pytest.raises(NotImplementedError):
        ligo_expand.ligo_blend_expand_grouped(w.requires_grad_(), B, W)


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype,dims", LIGO_SHAPES,
                         ids=[f"{n}-{d}" for n, d, _ in LIGO_SHAPES])
def test_k2_kernel_matches_plain(cuda, name, dtype, dims):
    G, L2, L1, E, I, A, Bd = dims
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(1)
    w = torch.randn((G, L2, L1), generator=gen, device=cuda) / L1 ** 0.5
    B = (torch.randn((I, A), generator=gen, device=cuda) / A ** 0.5).to(dt)
    W = torch.randn((G, L1, E, A, Bd), generator=gen, device=cuda).to(dt)
    dP = torch.randn((G, L2, E, I, Bd), generator=gen, device=cuda).to(dt)
    ops.reset_launch_counts()
    got = ligo_expand_bwd.ligo_blend_expand_bwd(w, B, W, dP)
    assert ops.launch_counts()["ligo_blend_expand_bwd_fused"] == 1
    want = ref.ligo_blend_expand_bwd_ref(w, B, W, dP)
    again = ligo_expand_bwd.ligo_blend_expand_bwd(w, B, W, dP)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert [g.dtype for g in got] == [torch.float32, dt, dt]
    for g, r in zip(got[1:], want[1:]):
        err = (g.float() - r.float()).abs().max() / r.float().abs().max()
        assert float(err) <= TOL[dtype]
    T = torch.einsum("ia,gkeib->gkeab", B.float(), dP.float()).abs()
    terms = torch.einsum("gkeab,gleab->gkl", T, W.float().abs())
    err = ((got[0] - want[0].float()).abs() / terms).max()
    assert float(err) <= TOL[dtype]


@pytest.mark.gpu
def test_k2_tensor_map_failure_raises(cuda, monkeypatch):
    """A tensor map TMA cannot take (here B's 100-byte rows, A = 50 forced
    onto the tensor-core route) makes the wrapper raise: no fallback to the
    FMA GEMM or to the plain version, and no launch counted."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    bf = torch.bfloat16
    B = torch.randn((64, 50), generator=gen, device=cuda).to(bf)
    w = torch.randn((1, 2, 2), generator=gen, device=cuda)
    W = torch.randn((1, 2, 1, 50, 64), generator=gen, device=cuda).to(bf)
    dP = torch.randn((1, 2, 1, 64, 64), generator=gen, device=cuda).to(bf)
    assert not ligo_expand_bwd.tensor_core_route(bf, 64, 50, 64)
    monkeypatch.setattr(ligo_expand_bwd, "tensor_core_route",
                        lambda *args: True)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled"):
        ligo_expand_bwd.ligo_blend_expand_bwd(w, B, W, dP)
    assert ops.launch_counts()["ligo_blend_expand_bwd_fused"] == 0


@pytest.mark.gpu
def test_k2_misaligned_operands_match_aligned(cuda):
    """B and W given as views 2 bytes off a 16-byte boundary still take the
    tensor-core route (the wrapper copies them onto one) and give the same
    bits as the same values on aligned storage."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    bf = torch.bfloat16
    flat_B = torch.randn(64 * 64 + 1, generator=gen, device=cuda).to(bf)
    flat_W = torch.randn(2 * 64 * 64 + 1, generator=gen, device=cuda).to(bf)
    B, W = flat_B[1:].view(64, 64), flat_W[1:].view(1, 2, 1, 64, 64)
    assert B.data_ptr() % 16 == 2 and W.data_ptr() % 16 == 2
    w = torch.randn((1, 2, 2), generator=gen, device=cuda)
    dP = torch.randn((1, 2, 1, 64, 64), generator=gen, device=cuda).to(bf)
    assert ligo_expand_bwd.tensor_core_route(bf, 64, 64, 64)
    got = ligo_expand_bwd.ligo_blend_expand_bwd(w, B, W, dP)
    want = ligo_expand_bwd.ligo_blend_expand_bwd(w, B.clone(), W.clone(), dP)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_vjp_backward_on_the_card_matches_plain_route(cuda):
    """One backward through the autograd Function: K1 forward and K2
    backward on CUDA tensors, against the plain versions on the same
    tensors, with a strided cotangent and a frozen W."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    w = torch.randn((2, 5, 3), generator=gen, device=cuda)
    B = torch.randn((40, 30), generator=gen, device=cuda)
    W = torch.randn((2, 3, 1, 30, 20), generator=gen, device=cuda)
    proj = torch.randn((20, 7), generator=gen, device=cuda)
    grads = []
    for use_kernel in (None, False):
        ops.reset_launch_counts()
        xs = [w.clone().requires_grad_(True), B.clone().requires_grad_(True)]
        P = ops.ligo_blend_expand_grouped_vjp(*xs, W, use_kernel=use_kernel)
        (P[:, :, 0] @ proj).square().sum().backward()
        n = 1 if use_kernel is None else 0
        assert ops.launch_counts() == {"ligo_blend_expand_grouped": n,
                                       "ligo_blend_expand_bwd_fused": n,
                                       "flash_attention": 0}
        grads.append([x.grad for x in xs])
    torch.cuda.synchronize()
    for g, r in zip(*grads):
        assert float((g - r).abs().max() / r.abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype,dims", LIGO_SHAPES,
                         ids=[f"{n}-{d}" for n, d, _ in LIGO_SHAPES])
def test_k1_u_is_k2s_own_u_bit_for_bit(cuda, name, dtype, dims):
    """K1's U (``keep_u``) and the U that K2 computes for itself come from
    the same GEMM with the same arguments: equal bit for bit. So K2 fed
    K1's U gives the bits of K2 on its own, and K2 without dW gives the
    same dw and dB."""
    G, L2, L1, E, I, A, Bd = dims
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn((G, L2, L1), generator=gen, device=cuda) / L1 ** 0.5
    B = (torch.randn((I, A), generator=gen, device=cuda) / A ** 0.5).to(dt)
    W = torch.randn((G, L1, E, A, Bd), generator=gen, device=cuda).to(dt)
    dP = torch.randn((G, L2, E, I, Bd), generator=gen, device=cuda).to(dt)
    P, U1 = ligo_expand.ligo_blend_expand_grouped(w, B, W, keep_u=True)
    *own, U2 = ligo_expand_bwd.ligo_blend_expand_bwd(w, B, W, dP,
                                                     keep_u=True)
    fed = ligo_expand_bwd.ligo_blend_expand_bwd(w, B, W, dP, U=U1)
    dw, dB, dW = ligo_expand_bwd.ligo_blend_expand_bwd(w, B, W, dP, U=U1,
                                                       need_dW=False)
    torch.cuda.synchronize()
    assert U1.dtype == torch.float32 and torch.equal(U1, U2)
    assert torch.equal(P, ligo_expand.ligo_blend_expand_grouped(w, B, W))
    assert all(torch.equal(a, b) for a, b in zip(own, fed))
    assert dW is None and torch.equal(dw, own[0]) and torch.equal(dB, own[1])


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype,dims", LIGO_SHAPES,
                         ids=[f"{n}-{d}" for n, d, _ in LIGO_SHAPES])
def test_k1_and_k2_halves_match_plain(cuda, name, dtype, dims):
    """K1's steps apart (U; the blend of a given U) and K2's halves (the dP
    blend and dw; dB and dW from a given Q) against their plain versions,
    at the card's tolerance; each launch counted once."""
    G, L2, L1, E, I, A, Bd = dims
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(4)
    w = torch.randn((G, L2, L1), generator=gen, device=cuda) / L1 ** 0.5
    B = (torch.randn((I, A), generator=gen, device=cuda) / A ** 0.5).to(dt)
    W = torch.randn((G, L1, E, A, Bd), generator=gen, device=cuda).to(dt)
    dP = torch.randn((G, L2, E, I, Bd), generator=gen, device=cuda).to(dt)
    ops.reset_launch_counts()
    U = ligo_expand.ligo_expand(B, W)
    P = ligo_expand.ligo_blend(w, U, dt)
    dw, Q = ligo_expand_bwd.ligo_blend_bwd(w, dP, U)
    dB, dW = ligo_expand_bwd.ligo_expand_bwd(B, W, Q)
    assert ops.launch_counts() == {"ligo_blend_expand_grouped": 2,
                                   "ligo_blend_expand_bwd_fused": 2,
                                   "flash_attention": 0}
    torch.cuda.synchronize()
    assert torch.equal(U, ligo_expand.ligo_blend_expand_grouped(
        w, B, W, keep_u=True)[1])
    pdw, pQ = ref.ligo_blend_bwd_ref(w, dP, U)
    pdB, pdW = ref.ligo_expand_bwd_ref(B, W, Q)

    def err(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())
    for got, want in ((P, ref.ligo_blend_ref(w, U, dt)), (Q, pQ),
                      (dB, pdB), (dW, pdW)):
        assert got.dtype == want.dtype and err(got, want) <= TOL[dtype]
    terms = torch.einsum("gkeib,gleib->gkl", dP.float().abs(), U.abs())
    assert float(((dw - pdw).abs() / terms).max()) <= TOL[dtype]


@pytest.mark.gpu
def test_vjp_between_on_the_card_matches_plain_route(cuda):
    """One backward through the right expansion between K1's U and its
    blend: K1's two steps forward, K2's two halves backward on CUDA tensors
    (2 launches each), against the plain versions on the same tensors,
    float32, with a frozen W."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    w = torch.randn((2, 5, 3), generator=gen, device=cuda)
    B = torch.randn((40, 30), generator=gen, device=cuda)
    W = torch.randn((2, 3, 1, 30, 20), generator=gen, device=cuda)
    R = torch.randn((28, 20), generator=gen, device=cuda)
    proj = torch.randn((28, 7), generator=gen, device=cuda)
    grads = []
    for use_kernel in (None, False):
        ops.reset_launch_counts()
        xs = [x.clone().requires_grad_(True) for x in (w, B, R)]
        P = ops.ligo_blend_expand_grouped_vjp(xs[0], xs[1], W, xs[2],
                                              use_kernel=use_kernel)
        (P[:, :, 0] @ proj).square().sum().backward()
        n = 2 if use_kernel is None else 0
        assert ops.launch_counts() == {"ligo_blend_expand_grouped": n,
                                       "ligo_blend_expand_bwd_fused": n,
                                       "flash_attention": 0}
        grads.append([x.grad for x in xs])
    torch.cuda.synchronize()
    for g, r in zip(*grads):
        assert float((g - r).abs().max() / r.abs().max()) <= 1e-5


def _qkv(cuda, dtype, B, H, KV, T, S, dh, seed, pad=0):
    """q, k, v made in the model's (B, T, heads, dh) layout (``pad`` more
    elements a row) and handed over as (B, heads, T, dh) views, as
    ``layers.full_attention`` does."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(
        torch.randn((B, n, heads, dh + pad), generator=gen, device=cuda)
        .to(dtype)[..., :dh].transpose(1, 2)
        for n, heads in ((T, H), (S, KV), (S, KV)))


def _finish_or_exit(seconds=60.0):
    """Wait for the device's work so far, at most ``seconds``: a tensor-core
    kernel whose mbarrier never completes spins for ever, and the process
    then ends here, with the message, rather than hang the card."""
    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    while not done.query():
        if time.perf_counter() - t0 > seconds:
            print(f"K3 did not finish in {seconds} s: a barrier waits for "
                  f"bytes that never come", file=sys.stderr, flush=True)
            os._exit(3)
        time.sleep(0.001)


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype,dims", K3_SHAPES,
                         ids=[f"{n}-{d}" for n, d, _ in K3_SHAPES])
def test_k3_kernel_matches_plain(cuda, name, dtype, dims):
    B, H, KV, T, S, dh, causal, window, *pad = dims
    dt = getattr(torch, dtype)
    q, k, v = _qkv(cuda, dt, B, H, KV, T, S, dh, seed=3, pad=sum(pad))
    # bf16 with aligned rows at every dh here (all <= 128, multiples of 8)
    assert flash_attention.uses_tensor_cores(q, k, v) is (
        dtype == "bfloat16" and not pad)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.launch_counts()["flash_attention"] == 1
    _finish_or_exit()
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == want.shape
    tol = K3_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol + tol * want.float().abs()).all()), \
        float(diff.max())


@pytest.mark.gpu
def test_k3_tensor_map_failure_raises(cuda, monkeypatch):
    """A tensor map TMA cannot take (rows of 136 bytes, forced onto the
    tensor-core route) makes K3's wrapper raise: no fallback to the FMA
    kernel or to the plain version, and no launch counted."""
    q, k, v = _qkv(cuda, torch.bfloat16, 1, 4, 2, 64, 64, 64, seed=9, pad=4)
    assert not flash_attention.uses_tensor_cores(q, k, v)
    monkeypatch.setattr(flash_attention, "uses_tensor_cores",
                        lambda *args: True)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled"):
        flash_attention.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.gpu
def test_k3_at_dh_80_runs_on_the_tensor_core_kernel(cuda):
    """A profiled call at zamba2's and hubert's d_head 80 launches the
    tensor-core kernel and its Vᵀ pass, and not the FMA kernel."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _qkv(cuda, torch.bfloat16, 2, 16, 16, 512, 512, 80, seed=12)
    assert flash_attention.uses_tensor_cores(q, k, v)
    flash_attention.flash_attention(q, k, v, causal=False)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = flash_attention.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("flash_fwd_wgmma" in k for k in kernels), kernels
    assert any("k3_vt_transpose_kernel" in k for k in kernels), kernels
    assert not any("flash_fwd_simt" in k for k in kernels), kernels
    want = ref.flash_attention_ref(q, k, v, causal=False)
    tol = K3_TOL["bfloat16"]
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol + tol * want.float().abs()).all())


@pytest.mark.gpu
def test_k3_broadcast_kv_takes_the_fma_kernel(cuda):
    """k and v broadcast over the batch (stride 0) are no layout a tensor
    map describes: the call takes the FMA kernel and matches the plain
    version."""
    q = _qkv(cuda, torch.bfloat16, 2, 4, 2, 77, 140, 64, seed=10)[0]
    _, k, v = _qkv(cuda, torch.bfloat16, 1, 4, 2, 77, 140, 64, seed=11)
    k, v = (x.expand(2, -1, -1, -1) for x in (k, v))
    assert not flash_attention.uses_tensor_cores(q, k, v)
    got = flash_attention.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    tol = K3_TOL["bfloat16"]
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol + tol * want.float().abs()).all())


@pytest.mark.gpu
def test_k3_refuses_recorded_autograd_and_the_route_follows_it(cuda):
    q, k, v = _qkv(cuda, torch.bfloat16, 1, 4, 2, 64, 64, 64, seed=4)
    qg = q.detach().requires_grad_(True)
    with pytest.raises(NotImplementedError):
        flash_attention.flash_attention(qg, k, v)
    qm, km, vm = (x.transpose(1, 2) for x in (qg, k, v))
    ops.reset_launch_counts()
    recorded = layers.full_attention(qm, km, vm, causal=True)
    assert recorded.requires_grad
    assert ops.launch_counts()["flash_attention"] == 0
    with torch.no_grad():
        free = layers.full_attention(qm, km, vm, causal=True)
    assert ops.launch_counts()["flash_attention"] == 1
    torch.cuda.synchronize()
    assert float((free.float() - recorded.detach().float()).abs().max()) \
        <= 2e-2


# ---------------------------------------------------------------------------
# Checkpoints of CUDA tensors and the measured-cost pass on the kernel route
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_bf16_cuda_checkpoint_round_trip_is_bitwise(cuda, tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import AdamWState
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = {"w": torch.randn(64, 48, generator=gen, device=cuda).to(
                  torch.bfloat16),
              "b": {"x": torch.randn(48, generator=gen, device=cuda)}}
    opt = AdamWState(m={"w": torch.randn(64, 48, generator=gen, device=cuda),
                        "b": {"x": torch.randn(48, generator=gen,
                                               device=cuda)}},
                     v={"w": torch.rand(64, 48, generator=gen, device=cuda),
                        "b": {"x": torch.rand(48, generator=gen,
                                              device=cuda)}}, count=5)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"params": params, "opt": opt}, {"arch": "t"}, block=True)
    got, meta = mgr.restore_latest(
        {"params": params, "opt": AdamWState(opt.m, opt.v, 0)})
    assert meta["_dtypes"] == {"params|w": "bfloat16"}
    assert got["opt"].count == 5
    for a, b in ((got["params"]["w"], params["w"]),
                 (got["params"]["b"]["x"], params["b"]["x"]),
                 (got["opt"].m["w"], opt.m["w"]),
                 (got["opt"].v["b"]["x"], opt.v["b"]["x"])):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("snapshot", ["host", "device"])
def test_async_save_of_cuda_tensors_against_an_in_place_update(
        cuda, tmp_path, snapshot):
    """A CUDA tensor changed in place by the next kernel after ``save``
    returns is written as it was at the call."""
    from repro_torch.checkpoint import CheckpointManager, load_step
    w = torch.arange(1 << 24, dtype=torch.float32, device=cuda)
    b = torch.ones(1 << 20, dtype=torch.bfloat16, device=cuda)
    want_w, want_b = w.cpu(), b.cpu()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": w, "b": b}, snapshot=snapshot)
    w.add_(1.0)
    b.mul_(3.0)
    mgr.wait()
    got, _ = load_step(str(tmp_path), 1)
    assert torch.equal(got["w"], want_w) and torch.equal(got["b"], want_b)


@pytest.mark.gpu
def test_measured_flops_of_a_kernel_route_ligo_step(cuda):
    """The measured-cost pass over a LiGO step on CUDA inputs counts K1's
    and K2's work (non-zero), launches nothing, and lands within
    [0.5, 2.0] of the 6ND model at a small gpt2-shaped pair."""
    from repro_torch.configs import get_config
    from repro_torch.core import init_ligo_params
    from repro_torch.core.grow import ligo_loss
    from repro_torch.data import batch_for_step
    from repro_torch.models.model import init_params
    from repro_torch.obs import costs
    from repro_torch.roofline import train_flops_per_step
    from repro_torch.training import to_device, value_and_grad
    c1 = get_config("gpt2-base").scaled(
        name="gpu-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_head=16, d_ff=128, vocab_size=256, max_seq=64)
    c2 = c1.scaled(name="gpu-tiny-grown", n_layers=4, d_model=96, n_heads=6,
                   n_kv_heads=6, d_ff=192)
    gen = torch.Generator(device=cuda).manual_seed(0)
    small = init_params(c1, gen, device=cuda)
    op = init_ligo_params(gen, c1, c2, device=cuda)
    batch = to_device(batch_for_step(c1, 0, 8, 64), cuda)

    def step(o, b, s):
        return value_and_grad(lambda oo, bb: (ligo_loss(oo, s, c1, c2, bb),
                                              {}), o, b)
    ops.reset_launch_counts()
    m = costs.measure_step("ligo_step[gpu-tiny-grown]", step, op, batch,
                           small, modelled_flops=train_flops_per_step(
                               c2, 8, 64))
    assert set(ops.launch_counts().values()) == {0}
    assert m["flops_kernels"] > 0 and m["flops_aten"] > 0
    assert 0.5 <= m["ratio"] <= 2.0, m


# ---------------------------------------------------------------------------
# The live engine on the card
# ---------------------------------------------------------------------------
# bf16 at dh 64: every prefill's attention takes K3's tensor-core kernel
ENGINE_CFG = {"n_layers": 2, "d_model": 256, "n_heads": 4, "n_kv_heads": 4,
              "d_head": 64, "d_ff": 512, "vocab_size": 512, "max_seq": 256}


def _engine_run(params, cfg, layout, n_req=6):
    from repro_torch.launch.serve import live_prompts
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(params, cfg, slots=3, prompt_budget=32,
                        gen_budget=16, kv_layout=layout, device="cuda")
    reqs = [eng.submit(p, max_new=16)
            for p in live_prompts(n_req, 32, cfg.vocab_size)]
    return eng, reqs


@pytest.mark.gpu
def test_engine_paged_and_dense_tokens_equal_on_the_card(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config("gpt2-base").scaled(name="gpt2-engine", **ENGINE_CFG)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    out = {}
    for layout in ("paged", "dense"):
        ops.reset_launch_counts()
        eng, reqs = _engine_run(params, cfg, layout)
        eng.run()
        assert all(r.status == "done" and len(r.tokens) == 16 for r in reqs)
        assert ops.launch_counts()["flash_attention"] == cfg.n_layers * 6
        out[layout] = [r.tokens for r in reqs]
    assert out["paged"] == out["dense"]


@pytest.mark.gpu
def test_background_hop_on_a_side_stream_completes_while_decoding(cuda):
    """The grow runs in a thread on its own stream while the engine keeps
    decoding: decode steps land between the hop's begin and its swap, K1
    launches for warm() and the hop, and every request finishes."""
    from repro_torch.configs import get_config
    from repro_torch.core import init_ligo_params
    from repro_torch.models.model import init_params
    from repro_torch.serving import HopController
    cfg = get_config("gpt2-base").scaled(name="gpt2-engine", **ENGINE_CFG)
    cfg2 = cfg.scaled(name="gpt2-engine-grown", n_layers=4, d_model=384,
                      n_heads=6, n_kv_heads=6, d_ff=768)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    op = init_ligo_params(torch.Generator(cuda).manual_seed(1), cfg, cfg2,
                          device=cuda)
    eng, reqs = _engine_run(params, cfg, "paged", n_req=9)
    hop = HopController(eng, cfg2, op, background=True)
    assert hop._side_stream != torch.cuda.current_stream(cuda)
    ops.reset_launch_counts()
    hop.warm()
    k1_warm = ops.launch_counts()["ligo_blend_expand_grouped"]
    assert k1_warm > 0

    def on_step(e):
        if e.decode_steps >= 3 and hop.attempts == 0:
            hop.begin()
        if hop.attempts:
            hop.poll()

    eng.run(on_step=on_step)
    while not hop.poll():
        time.sleep(0.002)
    assert hop.completed and hop.attempts == 1 and not hop.rollbacks
    assert hop.cache_path == "reprefill"
    assert hop.swap_at_step > hop.begin_at_step      # decode ran meanwhile
    assert ops.launch_counts()["ligo_blend_expand_grouped"] == 2 * k1_warm
    assert all(r.status == "done" and len(r.tokens) == 16 for r in reqs)
    assert eng.cfg.name == cfg2.name


def _spec_run(params, cfg, cfg2, op, *, spec_k, layout="paged", gen=16,
              block_size=16, spy=None):
    """The engine on the card, a synchronous hop at decode step 3, drained;
    ``spy(eng)`` runs after the engine is made. Returns (engine,
    requests)."""
    from repro_torch.launch.serve import live_prompts
    from repro_torch.serving import HopController, ServingEngine
    eng = ServingEngine(params, cfg, slots=3, prompt_budget=32,
                        gen_budget=gen, kv_layout=layout, spec_k=spec_k,
                        block_size=block_size, spec_autodisable=False,
                        device="cuda")
    if spy is not None:
        spy(eng)
    reqs = [eng.submit(p, max_new=gen)
            for p in live_prompts(8, 32, cfg.vocab_size)]
    hop = HopController(eng, cfg2, op, background=False)
    while eng.has_work():
        eng.step()
        if eng.decode_steps >= 3 and hop.attempts == 0:
            hop.begin()
        if hop.attempts:
            hop.poll()
    assert hop.completed and all(r.status == "done" for r in reqs)
    return eng, reqs


def _spec_models(cuda, lemon):
    from repro_torch.configs import get_config
    from repro_torch.core import init_ligo_params
    from repro_torch.core.operators import lemon_operator
    from repro_torch.models.model import init_params
    cfg = get_config("gpt2-base").scaled(name="gpt2-engine", **ENGINE_CFG)
    if lemon:                                   # float32: exact acceptance
        cfg = cfg.scaled(dtype="float32")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    if lemon:
        cfg2 = cfg.scaled(name="gpt2-engine-ff2", d_ff=2 * cfg.d_ff)
        return cfg, cfg2, params, lemon_operator(cfg, cfg2, device=cuda)
    cfg2 = cfg.scaled(name="gpt2-engine-grown", n_layers=4, d_model=384,
                      n_heads=6, n_kv_heads=6, d_ff=768)
    op = init_ligo_params(torch.Generator(cuda).manual_seed(1), cfg, cfg2,
                          device=cuda)
    return cfg, cfg2, params, op


@pytest.mark.gpu
def test_greedy_speculation_equals_greedy_decoding_on_the_card(cuda):
    """Through a LiGO hop (re-prefill), bf16, deterministic algorithms on:
    greedy speculative tokens equal greedy tokens, paged and dense, and K3
    launches once per layer of every prefill, drafter prefill and
    re-prefill."""
    cfg, cfg2, params, op = _spec_models(cuda, lemon=False)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out = {}
        for layout in ("paged", "dense"):
            for k in (0, 3):
                ops.reset_launch_counts()
                eng, reqs = _spec_run(params, cfg, cfg2, op, spec_k=k,
                                      layout=layout)
                pc = eng.prefill_counts
                assert ops.launch_counts()["flash_attention"] == (
                    cfg.n_layers * (pc[(cfg.name, "admit")]
                                    + pc[(cfg.name, "draft")])
                    + cfg2.n_layers * (pc[(cfg2.name, "admit")]
                                       + pc[(cfg2.name, "reprefill")]))
                assert (eng.spec_stats.get("rounds", 0) > 0) == (k > 0)
                assert (pc[(cfg.name, "draft")] > 0) == (k > 0)
                out[layout, k] = [r.tokens for r in reqs]
    finally:
        torch.use_deterministic_algorithms(prev)
    assert out["paged", 3] == out["paged", 0]
    assert out["dense", 3] == out["dense", 0]


@pytest.mark.gpu
def test_spec_round_maps_pos_k_1_before_it_launches(cuda):
    """Paged, blocks of 4: when the drafter launches, every live slot's
    pages back positions up to pos + K + 1, and with every slot live no
    draft or verify write lands in either pool's spare block. Neither the
    draft's nor the verify's K+1 steps synchronise with the host (as far
    as CUDA's sync debug mode sees). The float32 LEMON hop also accepts
    every draft of the first round."""
    cfg, cfg2, params, op = _spec_models(cuda, lemon=True)
    K, checked = 4, []

    def spy(eng):
        round_ = eng._spec_round

        def watched(active):
            draft, verify = eng._draft, eng._verify

            def no_sync(fn, *a):
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return fn(*a)
                finally:
                    torch.cuda.set_sync_debug_mode(prev)

            def checking(*a):
                a_ = eng.alloc
                checked.append(all(
                    a_.allocated[i] * a_.block_size
                    >= min(int(eng.pos_host[i]) + K + 1, eng.cap)
                    for i, _ in active))
                return no_sync(draft, *a)

            pools = [st["caches"][kk] for st in (eng.state, eng.d_state)
                     for kk in ("k", "v")]
            for pool in pools:
                pool[:, -1] = 0.0
            eng._draft = checking
            eng._verify = lambda *a: no_sync(verify, *a)
            try:
                round_(active)
            finally:
                eng._draft, eng._verify = draft, verify
            if len(active) == eng.slots:
                checked.append(all(bool((pool[:, -1] == 0).all())
                                   for pool in pools))
        eng._spec_round = watched

    eng, reqs = _spec_run(params, cfg, cfg2, op, spec_k=K, block_size=4,
                          spy=spy)
    assert eng.spec_stats["rounds"] >= 3 and checked and all(checked)
    assert eng.spec_stats["first_round_acc"] == 1.0



@pytest.mark.gpu
def test_kernel_route_hop_spans_and_profile_name_k1_and_k3(cuda, tmp_path):
    """A background hop on the kernel route with the observability layer
    on, under its profiler gate: the hop's spans (``hop.grow`` on its grow
    thread, the re-prefill in ``hop.cache-grow``) and one ``serve.prefill``
    span per admission, and a Chrome trace that names K1's tensor-core GEMM
    and K3's tensor-core kernel among its CUDA kernels."""
    import json
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core import init_ligo_params
    from repro_torch.models.model import init_params
    from repro_torch.serving import HopController
    cfg = get_config("gpt2-base").scaled(name="gpt2-engine", **ENGINE_CFG)
    cfg2 = cfg.scaled(name="gpt2-engine-grown", n_layers=4, d_model=384,
                      n_heads=6, n_kv_heads=6, d_ff=768)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    op = init_ligo_params(torch.Generator(cuda).manual_seed(1), cfg, cfg2,
                          device=cuda)
    obs.set_enabled(True)
    obs.FLIGHT.clear()
    with obs.profile(str(tmp_path), device=cuda) as path:
        eng, reqs = _engine_run(params, cfg, "paged", n_req=9)
        hop = HopController(eng, cfg2, op, background=True)
        hop.warm()

        def on_step(e):
            if e.decode_steps >= 3 and hop.attempts == 0:
                hop.begin()
            if hop.attempts:
                hop.poll()

        eng.run(on_step=on_step)
        while not hop.poll():
            time.sleep(0.002)
    assert hop.completed and all(r.status == "done" for r in reqs)
    spans = obs.FLIGHT.events(type="span")
    by = {}
    for s in spans:
        by.setdefault(s["name"], []).append(s)
    assert by["hop.grow"][0]["thread"] == "hop-grow-1"
    assert by["hop.cache-grow"][0]["attrs"]["mode"] == "reprefill"
    assert len(by["hop.warm"]) == len(by["hop.swap"]) == 1
    assert len(by["serve.prefill"]) == sum(
        n for (_, kind), n in eng.prefill_counts.items() if kind == "admit")
    assert hop.timings["grow"] == by["hop.grow"][0]["dur_ms"]
    kernels = {e["name"] for e in json.load(open(path))["traceEvents"]
               if e.get("cat") == "kernel"}
    assert any("ligo_wgmma_gemm_kernel<3," in k for k in kernels), kernels
    assert any("flash_fwd_wgmma" in k for k in kernels), kernels


@pytest.mark.gpu
def test_probe_methods_on_the_card_counts_k1_and_k2(cuda):
    """``probe_methods`` at smoke width on the card: the LiGO candidate's
    probe steps launch K1 forward and K2 backward, every candidate's grow
    of the params and both AdamW moments launches K1, in the counts one
    LiGO step and one grow launch alone; the scores are finite, repeat bit
    for bit under deterministic algorithms, and the inputs stay as they
    were."""
    from repro_torch.autogrow import PolicySpec, probe_methods
    from repro_torch.configs import get_config
    from repro_torch.core import grow, init_ligo_params, train_ligo
    from repro_torch.data import batch_for_step
    from repro_torch.training import init_train_state, to_device
    from repro_torch.tree import tree_leaves
    cfg = get_config("gpt2-base").scaled(name="gpt2-engine", **ENGINE_CFG)
    cfg2 = cfg.scaled(name="gpt2-engine-grown", n_layers=4, d_model=384,
                      n_heads=6, n_kv_heads=6, d_ff=768)
    params, opt = init_train_state(cfg, torch.Generator(cuda).manual_seed(0),
                                   device=cuda)
    before = [t.clone() for t in tree_leaves(params)]
    ops.reset_launch_counts()
    grow(params, cfg, cfg2, method="stackbert",
         gen=torch.Generator(cuda).manual_seed(1))
    k1_grow = ops.launch_counts()["ligo_blend_expand_grouped"]
    ops.reset_launch_counts()

    def data():
        t = 0
        while True:
            yield to_device(batch_for_step(cfg, t, 4, 32), cuda)
            t += 1
    train_ligo(init_ligo_params(torch.Generator(cuda).manual_seed(2), cfg,
                                cfg2, device=cuda), params, cfg, cfg2,
               data(), steps=1)
    step = ops.launch_counts()
    assert k1_grow > 0 and step["ligo_blend_expand_bwd_fused"] > 0
    spec = PolicySpec(kind="probe", max_steps=8,
                      probe_candidates=("ligo", "stackbert"), probe_steps=2,
                      probe_ligo_steps=2)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        ops.reset_launch_counts()
        best, scores = probe_methods(params, opt, cfg, cfg2, spec, lr=1e-3,
                                     batch=4, seq=32, seed=0)
        got = ops.launch_counts()
        again = probe_methods(params, opt, cfg, cfg2, spec, lr=1e-3,
                              batch=4, seq=32, seed=0)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert got == {
        "ligo_blend_expand_grouped": (2 * step["ligo_blend_expand_grouped"]
                                      + 2 * 3 * k1_grow),
        "ligo_blend_expand_bwd_fused": 2 * step["ligo_blend_expand_bwd_fused"],
        "flash_attention": 0}, got
    assert all(torch.isfinite(torch.tensor(v)) for v in scores.values())
    assert best == min(scores, key=scores.get)
    assert again == (best, scores)
    for a, b in zip(tree_leaves(params), before):
        assert torch.equal(a, b)


# The MoE family's K1 and K2 shapes: mixtral's expert stacks (E = 8) and its
# float32 router (its expert count, 8, as K1's trailing dim), cut in width
# from chip_smoke.py phase 13's full-width groups; name, dtype, (G, L2, L1,
# E, I, A, Bd)
MOE_SHAPES = [
    ("moe/w1+w3", "bfloat16", (2, 4, 2, 8, 512, 256, 448)),
    ("moe/w2", "bfloat16", (1, 4, 2, 8, 512, 448, 256)),
    ("moe f32", "float32", (2, 4, 2, 8, 200, 96, 130)),
    ("router", "float32", (1, 4, 2, 1, 512, 256, 8)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype,dims", MOE_SHAPES,
                         ids=[n for n, _, _ in MOE_SHAPES])
def test_k1_and_k2_on_expert_stacks_match_plain(cuda, name, dtype, dims):
    """K1 and K2 (fed K1's U) on E = 8 expert stacks and on the router's
    Bd = 8 group, each against its plain version, each twice for bits."""
    G, L2, L1, E, I, A, Bd = dims
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn((G, L2, L1), generator=gen, device=cuda) / L1 ** 0.5
    B = (torch.randn((I, A), generator=gen, device=cuda) / A ** 0.5).to(dt)
    W = torch.randn((G, L1, E, A, Bd), generator=gen, device=cuda).to(dt)
    dP = torch.randn((G, L2, E, I, Bd), generator=gen, device=cuda).to(dt)
    ops.reset_launch_counts()
    P, U = ligo_expand.ligo_blend_expand_grouped(w, B, W, keep_u=True)
    got = ligo_expand_bwd.ligo_blend_expand_bwd(w, B, W, dP, U=U)
    assert ops.launch_counts() == {"ligo_blend_expand_grouped": 1,
                                   "ligo_blend_expand_bwd_fused": 1,
                                   "flash_attention": 0}
    P2 = ligo_expand.ligo_blend_expand_grouped(w, B, W)
    got2 = ligo_expand_bwd.ligo_blend_expand_bwd(w, B, W, dP, U=U)
    torch.cuda.synchronize()
    assert torch.equal(P, P2) and all(torch.equal(a, b)
                                      for a, b in zip(got, got2))
    want = ref.ligo_blend_expand_grouped_ref(w, B, W)
    err = (P.float() - want.float()).abs().max() / want.float().abs().max()
    assert P.dtype == dt and float(err) <= TOL[dtype]
    want = ref.ligo_blend_expand_bwd_ref(w, B, W, dP)
    for g, r in zip(got[1:], want[1:]):
        err = (g.float() - r.float()).abs().max() / r.float().abs().max()
        assert float(err) <= TOL[dtype]
    T = torch.einsum("ia,gkeib->gkeab", B.float(), dP.float()).abs()
    terms = torch.einsum("gkeab,gleab->gkl", T, W.float().abs())
    assert float(((got[0] - want[0].float()).abs() / terms).max()) \
        <= TOL[dtype]


@pytest.mark.gpu
def test_stable_top_k_on_the_card_matches_the_cpu(cuda):
    """A zero router ties every token across the experts: on the card the
    stable top-k picks the CPU's experts (0..k-1), and the MoE layer keeps
    and drops the same rows and computes the same output (<= 1e-5, f32)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import moe
    cfg = smoke_config(get_config("qwen3-moe-30b-a3b")).scaled(
        capacity_factor=1.25, n_experts=16, experts_top_k=4)
    probs = torch.full((64, cfg.n_experts), 1.0 / cfg.n_experts)
    cpu = moe.top_k_stable(probs, cfg.experts_top_k)
    dev = moe.top_k_stable(probs.to(cuda), cfg.experts_top_k)
    assert torch.equal(dev[1].cpu(), cpu[1])
    assert cpu[1].tolist() == [list(range(cfg.experts_top_k))] * 64
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    p["router"].zero_()
    x = torch.randn((4, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    out, aux, keep = moe.apply_moe(p, x, cfg, return_keep=True)
    pd = {k: v.to(cuda) for k, v in p.items()}
    out_d, aux_d, keep_d = moe.apply_moe(pd, x.to(cuda), cfg,
                                         return_keep=True)
    assert torch.equal(keep_d.cpu(), keep) and not bool(keep.all())
    err = (out_d.cpu() - out).abs().max() / out.abs().max()
    assert float(err) <= 1e-5
    assert abs(float(aux_d) - float(aux)) <= 1e-6


# The sequence mixers' K1 and K2 shapes, cut in depth from chip_smoke.py
# phase 14's: name, seg (B block-diagonal with identity segments: Mamba2's
# in_proj expander, [inner, inner, I_N, I_N, mheads], at a cut width), dims
SEQMIX_SHAPES = [
    ("seg-B", True, (1, 4, 2, 1, 2 * 512 + 2 * 64 + 16,
                     2 * 256 + 2 * 64 + 16, 384)),
    ("gates-Bd8", False, (1, 4, 2, 1, 2304, 1536, 8)),
]


def _seg_B(cuda, gen, I, A):
    """A (I, A) block-diagonal expander: two dense (512, 256) segments, two
    64-wide identities, a (16, 16) one — the Mamba2 in_proj layout."""
    blocks = [torch.randn((512, 256), generator=gen, device=cuda) / 16,
              torch.randn((512, 256), generator=gen, device=cuda) / 16,
              torch.eye(64, device=cuda), torch.eye(64, device=cuda),
              torch.randn((16, 16), generator=gen, device=cuda) / 4]
    B = torch.block_diag(*blocks)
    assert tuple(B.shape) == (I, A)
    return B


@pytest.mark.gpu
@pytest.mark.parametrize("name,seg,dims", SEQMIX_SHAPES,
                         ids=[n for n, _, _ in SEQMIX_SHAPES])
def test_k1_and_k2_on_seqmix_groups_match_plain(cuda, name, seg, dims):
    """K1 and K2 (fed K1's U) on a block-diagonal B and on the Bd 8 gates
    group, bf16, each against its plain version, each twice for bits."""
    G, L2, L1, E, I, A, Bd = dims
    dt = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn((G, L2, L1), generator=gen, device=cuda) / L1 ** 0.5
    B = (_seg_B(cuda, gen, I, A) if seg else torch.randn(
        (I, A), generator=gen, device=cuda) / A ** 0.5).to(dt)
    W = torch.randn((G, L1, E, A, Bd), generator=gen, device=cuda).to(dt)
    dP = torch.randn((G, L2, E, I, Bd), generator=gen, device=cuda).to(dt)
    ops.reset_launch_counts()
    P, U = ligo_expand.ligo_blend_expand_grouped(w, B, W, keep_u=True)
    got = ligo_expand_bwd.ligo_blend_expand_bwd(w, B, W, dP, U=U)
    assert ops.launch_counts() == {"ligo_blend_expand_grouped": 1,
                                   "ligo_blend_expand_bwd_fused": 1,
                                   "flash_attention": 0}
    P2 = ligo_expand.ligo_blend_expand_grouped(w, B, W)
    got2 = ligo_expand_bwd.ligo_blend_expand_bwd(w, B, W, dP, U=U)
    torch.cuda.synchronize()
    assert torch.equal(P, P2) and all(torch.equal(a, b)
                                      for a, b in zip(got, got2))
    want = ref.ligo_blend_expand_grouped_ref(w, B, W)
    err = (P.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= TOL["bfloat16"]
    want = ref.ligo_blend_expand_bwd_ref(w, B, W, dP)
    for g, r in zip(got[1:], want[1:]):
        err = (g.float() - r.float()).abs().max() / r.float().abs().max()
        assert float(err) <= TOL["bfloat16"]
    T = torch.einsum("ia,gkeib->gkeab", B.float(), dP.float()).abs()
    terms = torch.einsum("gkeab,gleab->gkl", T, W.float().abs())
    assert float(((got[0] - want[0].float()).abs() / terms).max()) \
        <= TOL["bfloat16"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b"])
def test_seqmix_smoke_models_on_the_card_match_the_cpu(cuda, arch):
    """The smoke model's prefill (K3 for zamba2's shared block) and four
    decode steps on the card against the CPU, float32 (<= 1e-4)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import model
    from repro_torch.tree import tree_map
    cfg = smoke_config(get_config(arch))
    p = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pd = tree_map(lambda t: t.to(cuda), p)
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    ops.reset_launch_counts()
    with torch.no_grad():
        lc, sc = model.prefill(p, cfg, {"tokens": toks[:, :36]}, max_len=40)
        ld, sd = model.prefill(pd, cfg, {"tokens": toks[:, :36].to(cuda)},
                               max_len=40)
        n_attn = (cfg.n_layers // cfg.shared_attn_every
                  if cfg.family == "hybrid" else 0)
        assert ops.launch_counts()["flash_attention"] == n_attn
        for t in range(36, 40):
            err = (ld.cpu() - lc).abs().max() / lc.abs().max()
            assert float(err) <= 1e-4
            lc, sc = model.decode_step(p, cfg, sc, {"tokens": toks[:, t:t + 1]})
            ld, sd = model.decode_step(pd, cfg, sd,
                                       {"tokens": toks[:, t:t + 1].to(cuda)})


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b"])
def test_recurrent_engine_on_the_card_matches_the_cpu(cuda, arch):
    """The smoke model through the live engine with a synchronous LiGO hop
    (re-prefill), prompts of 1, 2, 5, 9 and 16 tokens through 3 slots,
    float32, on the card and on the CPU: the same greedy tokens, first-
    token logits within 1e-4, and K3 once per shared-block insertion of
    every prefill the card's engine counted."""
    import numpy as np
    from repro_torch.configs import get_config, grow_target, smoke_config
    from repro_torch.core import init_ligo_params
    from repro_torch.models import model
    from repro_torch.serving import HopController, ServingEngine
    from repro_torch.tree import tree_map
    cfg = smoke_config(get_config(arch))
    cfg2 = grow_target(cfg)
    p = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    op = init_ligo_params(torch.Generator().manual_seed(1), cfg, cfg2,
                          device="cpu")
    rng = np.random.RandomState(4)
    prompts = [list(rng.randint(0, cfg.vocab_size, n)) for n in
               (1, 2, 5, 9, 16)]
    out = {}
    for dev in ("cpu", cuda):
        eng = ServingEngine(tree_map(lambda t: t.to(dev), p), cfg, slots=3,
                            prompt_budget=16, gen_budget=6,
                            kv_layout="dense", device=dev)
        reqs = [eng.submit(q, max_new=6) for q in prompts]
        hop = HopController(eng, cfg2, tree_map(lambda t: t.to(dev), op),
                            background=False)
        ops.reset_launch_counts()

        def on_step(e):
            if e.decode_steps >= 2 and hop.attempts == 0:
                hop.begin()
            if hop.attempts:
                hop.poll()
        eng.run(on_step=on_step)
        assert hop.completed and hop.cache_path == "reprefill"
        n_attn = {c.name: (c.n_layers // c.shared_attn_every
                           if c.family == "hybrid" else 0)
                  for c in (cfg, cfg2)}
        if dev != "cpu":
            assert ops.launch_counts()["flash_attention"] == sum(
                n * n_attn[name]
                for (name, _, _), n in eng.prefill_lengths.items())
        out[str(dev)] = [(r.tokens, r.first_logits) for r in reqs]
    for (tc_, lc), (td, ld) in zip(out["cpu"], out[str(cuda)]):
        assert td == tc_
        assert np.abs(ld - lc).max() <= 1e-4 * np.abs(lc).max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_on_the_card_matches_the_cpu(cuda, dtype):
    """qwen2-vl-72b's shape (64 heads of 128, sections (16, 24, 24), theta
    1e6) with three distinct position streams: the card against the CPU,
    <= 1e-6 in float32 (sin and cos of two libraries), within one bf16
    ulp in bf16."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-vl-72b")
    gen = torch.Generator().manual_seed(5)
    dt = getattr(torch, dtype)
    x = torch.randn((2, 512, cfg.n_heads, cfg.d_head), generator=gen).to(dt)
    pos = torch.stack([torch.randint(0, 4, (2, 512), generator=gen),
                       torch.randint(0, 64, (2, 512), generator=gen),
                       torch.randint(0, 4096, (2, 512), generator=gen)], -1)
    want = layers.apply_mrope(x, pos, cfg.rope_theta, cfg.mrope_sections)
    got = layers.apply_mrope(x.to(cuda), pos.to(cuda), cfg.rope_theta,
                             cfg.mrope_sections)
    assert got.dtype == dt and got.device.type == "cuda"
    err = (got.cpu().float() - want.float()).abs().max() / want.abs().max()
    assert float(err) <= (1e-6 if dtype == "float32" else 2.0 ** -8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 1e-4)])
def test_hubert_encode_k3_route_matches_plain_route(cuda, dtype, tol):
    """hubert-xlarge at full width (1280, 16 heads of 80) cut to 2 layers:
    an autograd-free encode of 2 x 256 frames, 15 % masked, on the K3
    route (one bidirectional launch a layer, the FMA kernel) against the
    plain attention route; hidden states within ``tol`` (normalised), the
    MLM loss within ``tol`` relative."""
    from repro_torch.configs import get_config
    from repro_torch.models import inputs, model
    from repro_torch.models.losses import loss_fn
    cfg = get_config("hubert-xlarge")
    cfg = cfg.scaled(name=f"{cfg.name}-2l", n_layers=2, dtype=dtype)
    p = model.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    b = inputs.dummy_batch(cfg, 2, 256, "train", seed=1, device=cuda)
    out = {}
    with torch.no_grad():
        for use_kernel in (None, False):
            ops.reset_launch_counts()
            h, _ = model.forward(p, cfg, b, use_kernel=use_kernel)
            loss, _ = loss_fn(p, cfg, b, use_kernel=use_kernel)
            n = ops.launch_counts()["flash_attention"]
            assert n == (2 * cfg.n_layers if use_kernel is None else 0)
            out[use_kernel] = (h.float(), float(loss))
    torch.cuda.synchronize()
    (hk, lk), (hp, lp) = out[None], out[False]
    assert bool(torch.isfinite(hk).all())
    assert float((hk - hp).abs().max() / hp.abs().max()) <= tol
    assert abs(lk - lp) <= tol * abs(lp)


# The JAX package's public kernel wrappers on CUDA tensors, at one gpt2
# leaf cut in width (L2 8, L1 4, I 256, A 192): kernel against plain
# version with the K1/K2 tolerances above, and each call's launches, in
# ``launch_counts()`` and in the ``LAUNCH_COUNTS`` registry group.
WRAPPER_DIMS = (8, 4, 256, 192)


def _wrapper_inputs(cuda, dtype, seed):
    L2, L1, I, A = WRAPPER_DIMS
    gen = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn((L2, L1), generator=gen, device=cuda) / L1
    B, W, R, C = (torch.randn(s, generator=gen, device=cuda).mul(0.05)
                  .to(getattr(torch, dtype))
                  for s in ((I, A), (L1, A, A), (I, A), (L2, I, A)))
    return w, B, W, R, C


def _counted(fn):
    n0, c0 = ops.launch_counts(), dict(ops.LAUNCH_COUNTS)
    out = fn()
    torch.cuda.synchronize()
    n1, c1 = ops.launch_counts(), dict(ops.LAUNCH_COUNTS)
    return out, ([n1[k] - n0[k] for k in ("ligo_blend_expand_grouped",
                                           "ligo_blend_expand_bwd_fused",
                                           "flash_attention")],
                 [c1.get(k, 0) - c0.get(k, 0) for k in ("fwd", "bwd")])


def _norm(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_public_ligo_blend_expand_and_grow_launch_k1(cuda, dtype):
    import repro_torch.kernels as tk
    w, B, W, R, _ = _wrapper_inputs(cuda, dtype, 40)
    P, n = _counted(lambda: tk.ligo_blend_expand(w, B, W))
    assert n == ([1, 0, 0], [1, 0])
    assert _norm(P, tk.ligo_blend_expand_ref(w, B, W)) <= TOL[dtype]
    G, n = _counted(lambda: tk.ligo_grow(w, B, R, W))
    assert n == ([1, 0, 0], [1, 0])
    assert G.shape == (WRAPPER_DIMS[0], WRAPPER_DIMS[2], WRAPPER_DIMS[2])
    assert _norm(G, tk.ligo_grow_ref(w, B, R, W)) <= TOL[dtype]


@pytest.mark.gpu
def test_public_vjp_gradients_launch_k1_and_k2(cuda):
    """``ligo_blend_expand_vjp``: one K1 launch forward, one K2 launch
    backward, its (P, dw, dB, dW) against the plain route's; dw's error
    bounded by the size of its terms, as K2's checks above bound it."""
    import repro_torch.kernels as tk
    w, B, W, _, C = _wrapper_inputs(cuda, "bfloat16", 41)

    def run(use_kernel):
        xs = [x.clone().requires_grad_() for x in (w, B, W)]
        P = tk.ligo_blend_expand_vjp(*xs, use_kernel=use_kernel)
        P.backward(C)
        return [P.detach()] + [x.grad for x in xs]
    got, n = _counted(lambda: run(None))
    want, n_plain = _counted(lambda: run(False))
    assert n == ([1, 1, 0], [1, 1]) and n_plain == ([0, 0, 0], [0, 0])
    for g, p in ((got[0], want[0]), (got[2], want[2]), (got[3], want[3])):
        assert _norm(g, p) <= TOL["bfloat16"]
    U = ref.ligo_expand_ref(B, W[None, :, None])
    terms = torch.einsum("gkeib,gleib->gkl", C[None, :, None].float().abs(),
                         U.abs())[0]
    assert float(((got[1] - want[1]).abs() / terms).max()) <= TOL["bfloat16"]


@pytest.mark.gpu
def test_public_bwd_fused_and_flash_attention_launch_k2_and_k3(cuda):
    import repro_torch.kernels as tk
    w, B, W, _, C = _wrapper_inputs(cuda, "bfloat16", 42)
    args = (w[None], B, W[None, :, None], C[None, :, None])
    got, n = _counted(lambda: tk.ligo_blend_expand_bwd_fused(*args))
    assert n == ([0, 1, 0], [0, 1])
    want = tk.ligo_blend_expand_bwd_ref(*args)
    assert [g.dtype for g in got] == [x.dtype for x in args[:3]]
    for g, p in zip(got[1:], want[1:]):
        assert _norm(g, p) <= TOL["bfloat16"]
    gen = torch.Generator(device=cuda).manual_seed(43)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(torch.bfloat16)
               for s in ((2, 8, 256, 128), (2, 2, 256, 128),
                         (2, 2, 256, 128)))
    o, n = _counted(lambda: tk.flash_attention(q, k, v))
    assert n == ([0, 0, 1], [0, 0])
    p = tk.flash_attention_ref(q, k, v)
    assert bool(((o.float() - p.float()).abs()
                 <= 2e-2 + 2e-2 * p.float().abs()).all())
