"""The float32 GEMM that kernels K1 and K2 share (``csrc/ligo_gemm.cuh``,
``ligo_f32_gemm_kernel``): its host-side plan and its split-sum order.

``kernels/_gemm.py::f32_gemm_plan`` picks each product's tile and split
from its shape alone. Here it is held, at every float32 GEMM shape of the
main paths (the gpt2-base -> gpt2-medium AdamW-moment grow, the quickstart's
LiGO phase, the MoE router's Bd = 8 group, and ``chip_smoke.py``'s ragged
and pinned rows), to the tile the design gives and to enough blocks for the
H100's 132 SMs wherever the sum is deep enough to split. Then a pure-torch
emulation of the kernel's summation structure (16-deep slices in order,
the (r, slice) sequence cut into the plan's contiguous parts, the parts
added in order) runs K1 and K2 in float32 and is held to the plain versions
(``kernels/ref.py``) and to the JAX package's Pallas kernels in interpret
mode, at 1e-5 scale-normalised: only the summation order differs. K2's
``dw`` does not pass through the GEMM (its own chunked sum), so it is not
emulated here.
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
from repro_torch.configs import get_config, half_config      # noqa: E402
from repro_torch.core.ligo import _flatten                   # noqa: E402
from repro_torch.core.plan import _expr_dims, plan_for       # noqa: E402
from repro_torch.examples import quickstart                  # noqa: E402
from repro_torch.kernels import _gemm, ligo_expand_bwd, ref  # noqa: E402
from repro_torch.models.model import init_params             # noqa: E402

f32_gemm_plan = _gemm.f32_gemm_plan


def _groups(cfg1, cfg2, dtype):
    """(G, L1, E, I, A, b, j, right, right_grad) of each kernel-route group
    of the pair's GrowthPlan whose leaves are ``dtype`` (all groups for
    None), as ``chip_smoke.py::_k1_shapes`` reads them."""
    params = init_params(cfg1, torch.Generator().manual_seed(0),
                         device="meta")
    plan = plan_for(cfg1, cfg2, params)
    leaves = {k: _flatten(s) for k, s in params["layers"].items()}
    out = []
    for g in plan.groups:
        if not g.kernel_ok or (dtype is not None and leaves[g.kind][
                g.paths[0]].dtype != dtype):
            continue
        j = (_expr_dims(plan.exprs[g.out_ref], cfg1, cfg2)[0]
             if g.out_ref else None)
        out.append((len(g.paths), g.shape[0],
                    g.shape[1] if len(g.shape) == 4 else 1,
                    _expr_dims(plan.exprs[g.in_ref], cfg1, cfg2)[0],
                    g.shape[-2], g.shape[-1], j, g.right, g.right_grad))
    return out


def _products(cfg1, cfg2, dtype=None, grad=True):
    """The float32 GEMM products (M, N, K, R, Z) of the pair's grow (K1's
    U) and, with ``grad``, of its LiGO step (K1's U and K2's dW and dB),
    each group's right expansion placed as the plan places it."""
    out = set()
    for G, L1, E, I, A, b, j, right, right_grad in _groups(cfg1, cfg2,
                                                           dtype):
        Z = G * L1 * E
        for place, k2 in ((right, False),) + (((right_grad, True),)
                                               if grad else ()):
            Bd = j if (j and place == "before") else b
            out.add((I, Bd, A, 1, Z))                       # K1's U
            if k2:
                out.add((I, A, Bd, Z, 1))                   # K2's dB
                if place == "before":
                    out.add((A, Bd, I, 1, Z))               # K2's dW
    return sorted(out)


def _mixtral_pair():
    mix = get_config("mixtral-8x7b")
    c2 = mix.scaled(name=f"{mix.name}-4l", n_layers=4)
    c1 = half_config(mix)
    return c1.scaled(name=f"{c1.name}-2l", n_layers=2), c2


def _at_depth_cap(plan, K, R):
    """The split is as deep as the plan allows: no part could be cut
    again without falling under F32_MIN_PART slices."""
    slices = R * -(-K // _gemm.F32_SLICE)
    return plan.split == max(1, slices // _gemm.F32_MIN_PART)


def _case_products(case):
    if case == "moment grow":            # both moments: K1's U, f32
        return _products(get_config("gpt2-base"), get_config("gpt2-medium"),
                         grad=False)
    if case == "quickstart":             # the twin's float32 LiGO phase
        return _products(quickstart.SMALL, quickstart.BIG)
    if case == "router":                 # the float32 Bd = 8 group
        return [p for p in _products(*_mixtral_pair(), dtype=torch.float32)
                if p[3] == 1]
    G, L2, L1, E, I, A, Bd = {"ragged": (3, 5, 3, 2, 200, 50, 130),
                              "pinned": (1, 1, 1, 2, 1, 50, 45)}[case]
    return [(I, Bd, A, 1, G * L1 * E)]


# case: (the tile the design gives, the blocks it must reach)
PLAN_CASES = {
    "moment grow": ((128, 128), "a wave"),
    "router": ((128, 16), "a wave"),
    "quickstart": ((64, 64), "a wave or the depth cap"),
    "ragged": ((64, 64), "a wave"),
    "pinned": ((64, 64), "a wave or the depth cap"),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_f32_plan_at_main_path_shapes(case):
    """Each main-path float32 product takes the tile the design gives (128
    x 128 for the large moment-grow products, 128 x 16 for the router's
    N = 8, 64 x 64 where 128 x 128 leaves most SMs idle) and enough blocks
    for the 132 SMs: with a split where the output's blocks alone fall
    short, unless the sum is too shallow to split further."""
    tile, reach = PLAN_CASES[case]
    prods = _case_products(case)
    assert prods
    for M, N, K, R, Z in prods:
        plan = f32_gemm_plan(M, N, K, R, Z)
        assert _gemm.F32_TILES[plan.tile] == tile, (M, N, K, R, Z, plan)
        blocks = plan.blocks(M, N, Z)
        assert Z * plan.split <= _gemm.MAX_GRID_YZ
        if reach == "a wave":
            assert blocks >= _gemm.SMS, (M, N, K, R, Z, plan, blocks)
        else:
            assert blocks >= _gemm.SMS or _at_depth_cap(plan, K, R), (
                M, N, K, R, Z, plan, blocks)
        if plan.split == 1 and blocks < _gemm.SMS:
            assert _at_depth_cap(plan, K, R)
    if case == "moment grow":            # large: no split, no idle SMs
        assert all(f32_gemm_plan(*p).split == 1 for p in prods)
    if case == "router":                 # Bd = 8 and a long sum: split
        assert all(f32_gemm_plan(*p).split > 1 for p in prods)


def test_f32_plan_of_k2_u_is_k1s():
    """K2 computes U with K1's plan (the same product, the same split), so
    the two agree bit for bit; the dB plan sums over the Z = G·L1·E source
    slabs; a split never exceeds the grid's z limit."""
    for G, L1, E, I, A, Bd in ((1, 12, 1, 4096, 3072, 768),
                               (1, 2, 1, 4096, 2048, 8),
                               (3, 3, 2, 200, 50, 130)):
        plans = ligo_expand_bwd.f32_plans(G, L1, E, I, A, Bd)
        assert plans["U"] == f32_gemm_plan(I, Bd, A, 1, G * L1 * E)
        assert plans["dB"] == f32_gemm_plan(I, A, Bd, G * L1 * E, 1)
        assert plans["dW"] == f32_gemm_plan(A, Bd, I, 1, G * L1 * E)
    assert f32_gemm_plan(4096, 8, 1 << 20, 1, 60000).split == 1


def _emulate(A, B, plan):
    """C = Σ_r A[r] B[r] (A (R, M, K), B (R, K, N), float32) in the f32
    GEMM's order: 16-deep slices of the (r, slice) sequence in order within
    each of the plan's contiguous parts, then the parts added in order
    from zero (``ligo_sum_parts_kernel``)."""
    R, M, K = A.shape
    nk = -(-K // _gemm.F32_SLICE)
    T, S = R * nk, plan.split
    out = torch.zeros(M, B.shape[2])
    for s in range(S):
        acc = torch.zeros_like(out)
        for t in range(s * T // S, (s + 1) * T // S):
            r, k0 = divmod(t, nk)
            k0 *= _gemm.F32_SLICE
            acc = acc + A[r, :, k0:k0 + _gemm.F32_SLICE] @ B[
                r, k0:k0 + _gemm.F32_SLICE]
        out = out + acc
    return out


def _k1_emulated(w, B, W):
    G, L1, E, A, Bd = W.shape
    I = B.shape[0]
    Z = G * L1 * E
    plan = f32_gemm_plan(I, Bd, A, 1, Z)
    Wz = W.reshape(Z, A, Bd)
    U = torch.stack([_emulate(B[None], Wz[z][None], plan)
                     for z in range(Z)]).reshape(G, L1, E, I, Bd)
    return ref.ligo_blend_ref(w, U, torch.float32), plan


def _k2_emulated(w, B, W, dP):
    """(dB, dW) of K2's products in the f32 GEMM's order."""
    G, L1, E, A, Bd = W.shape
    I = B.shape[0]
    Z = G * L1 * E
    plans = ligo_expand_bwd.f32_plans(G, L1, E, I, A, Bd)
    Q = torch.einsum("gkl,gkeib->gleib", w, dP).reshape(Z, I, Bd)
    Wz = W.reshape(Z, A, Bd)
    dB = _emulate(Q, Wz.transpose(1, 2), plans["dB"])
    dW = torch.stack([_emulate(B.T[None], Q[z][None], plans["dW"])
                      for z in range(Z)]).reshape(G, L1, E, A, Bd)
    return (dB, dW), plans


# name: (kernel, (G, L2, L1, E, I, A, Bd), the split the plan must give)
EMULATION_CASES = {
    "k1 Bd 8, split": ("k1", (1, 3, 2, 1, 64, 1024, 8), True),
    "k1 ragged": ("k1", (3, 5, 3, 2, 40, 50, 37), False),
    "k2 dB split": ("k2", (1, 3, 4, 2, 64, 64, 256), True),
    "k2 ragged, split": ("k2", (2, 3, 3, 2, 24, 50, 45), True),
}


@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_f32_split_sum_emulation_matches_plain_and_jax(case):
    """The f32 GEMM's summation order, split where the plan splits, gives
    K1's P and K2's dB and dW within 1e-5 (normalised) of the plain
    versions and of the JAX Pallas kernels in interpret mode."""
    kernel, (G, L2, L1, E, I, A, Bd), split = EMULATION_CASES[case]
    rng = np.random.RandomState(5)
    w = rng.randn(G, L2, L1).astype(np.float32)
    B = rng.randn(I, A).astype(np.float32)
    W = rng.randn(G, L1, E, A, Bd).astype(np.float32)
    tw, tB, tW = (torch.from_numpy(x) for x in (w, B, W))
    if kernel == "k1":
        got, plan = _k1_emulated(tw, tB, tW)
        assert (plan.split > 1) is split
        plain = ref.ligo_blend_expand_grouped_ref(tw, tB, tW)
        pallas = jax_k1(jnp.asarray(w), jnp.asarray(B), jnp.asarray(W),
                        interpret=True)
        for want in (plain.numpy(), np.asarray(pallas)):
            assert_trees_close_normalized([got.numpy()], [want], rel=1e-5)
        return
    dP = rng.randn(G, L2, E, I, Bd).astype(np.float32)
    got, plans = _k2_emulated(tw, tB, tW, torch.from_numpy(dP))
    assert (plans["dB"].split > 1) is split
    plain = ref.ligo_blend_expand_bwd_ref(tw, tB, tW, torch.from_numpy(dP))
    pallas = jax_k2(jnp.asarray(w), jnp.asarray(B), jnp.asarray(W),
                    jnp.asarray(dP), interpret=True)
    for want in ([x.numpy() for x in plain[1:]],
                 [np.asarray(x) for x in pallas[1:]]):
        assert_trees_close_normalized([x.numpy() for x in got], want,
                                      rel=1e-5)
