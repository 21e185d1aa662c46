"""Card-only checks of the port's hand-written kernels against their plain
versions (marker ``gpu``; they skip where there is no CUDA device).

Run on the card with:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Shapes are those of ``chip_smoke.py``'s kernel phase: the six K1 groups of
the gpt2-base -> gpt2-medium hot-grow in bf16 (K2, the backward, runs on the
same groups in the LiGO phase), and a ragged f32 shape.
Tolerance (scale-normalised): 1e-2 for bf16, whose output is rounded once
from an f32 sum on both sides; 1e-5 for f32 with TF32 off, where only the
summation order differs. K2's ``dw`` is a long sum that cancels: its error
is normalised entry by entry by the sum of the absolute values of its terms.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (ligo_expand, ligo_expand_bwd,  # noqa: E402
                                 ops, ref)

# name, dtype, (G, L2, L1, E, I, A, Bd)
K1_SHAPES = [
    ("wq", "bfloat16", (1, 24, 12, 1, 1024, 768, 768)),
    ("wk", "bfloat16", (1, 24, 12, 1, 1024, 768, 768)),
    ("wv", "bfloat16", (1, 24, 12, 1, 1024, 768, 768)),
    ("wo", "bfloat16", (1, 24, 12, 1, 1024, 768, 768)),
    ("mlp/w1", "bfloat16", (1, 24, 12, 1, 1024, 768, 3072)),
    ("mlp/w2", "bfloat16", (1, 24, 12, 1, 4096, 3072, 768)),
    ("ragged", "float32", (3, 5, 3, 2, 200, 50, 130)),
]
TOL = {"bfloat16": 1e-2, "float32": 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built for sm_90a)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype,dims", K1_SHAPES,
                         ids=[f"{n}-{d}" for n, d, _ in K1_SHAPES])
def test_k1_kernel_matches_plain(cuda, name, dtype, dims):
    G, L2, L1, E, I, A, Bd = dims
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn((G, L2, L1), generator=gen, device=cuda) / L1 ** 0.5
    B = (torch.randn((I, A), generator=gen, device=cuda) / A ** 0.5).to(dt)
    W = torch.randn((G, L1, E, A, Bd), generator=gen, device=cuda).to(dt)
    ops.reset_launch_counts()
    got = ops.ligo_blend_expand_grouped(w, B, W)
    assert ops.launch_counts() == {"ligo_blend_expand_grouped": 1,
                                   "ligo_blend_expand_bwd_fused": 0}
    want = ref.ligo_blend_expand_grouped_ref(w, B, W)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == want.shape
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= TOL[dtype]


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
@pytest.mark.parametrize("name,dtype,dims", K1_SHAPES,
                         ids=[f"{n}-{d}" for n, d, _ in K1_SHAPES])
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
    torch.cuda.synchronize()
    assert [g.dtype for g in got] == [torch.float32, dt, dt]
    for g, r in zip(got[1:], want[1:]):
        err = (g.float() - r.float()).abs().max() / r.float().abs().max()
        assert float(err) <= TOL[dtype]
    T = torch.einsum("ia,gkeib->gkeab", B.float(), dP.float()).abs()
    terms = torch.einsum("gkeab,gleab->gkl", T, W.float().abs())
    err = ((got[0] - want[0].float()).abs() / terms).max()
    assert float(err) <= TOL[dtype]


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
                                       "ligo_blend_expand_bwd_fused": n}
        grads.append([x.grad for x in xs])
    torch.cuda.synchronize()
    for g, r in zip(*grads):
        assert float((g - r).abs().max() / r.abs().max()) <= 1e-5
