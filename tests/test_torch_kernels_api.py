"""The port's kernel package surface against the JAX package's
(``repro.kernels``) on the CPU: the single-leaf wrappers
``ligo_blend_expand``, ``ligo_grow`` and ``ligo_blend_expand_vjp`` (its
three gradients), ``ligo_blend_expand_bwd_fused``, ``flash_attention`` and
the five references, each against the JAX function of the same name (the
Pallas kernels in interpret mode) on the same numpy inputs, 1e-5 in
float32 and 2e-2 in bf16 (scale-normalised); and ``LAUNCH_COUNTS``, whose
count of one plan apply, and of its gradient, equals the JAX package's for
the same plan, and which ``/metrics`` carries as the JAX package's does;
a CUDA graph's capture tallies its launches instead of counting them, and
each replay counts the tally.
On CPU tensors every wrapper runs its kernel's plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.kernels as jk
import repro_torch.kernels as tk
from repro.obs import prom as jprom
from repro_torch.obs import prom as tprom

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (L2, L1, I, A, Bd): a ragged shape and one with tiles above 128
LEAF_SHAPES = [(4, 2, 100, 72, 90), (3, 2, 200, 136, 130)]
# (G, L2, L1, E, I, A, Bd)
GROUP_SHAPES = [(2, 4, 2, 3, 100, 72, 90), (1, 2, 1, 1, 8, 8, 8)]
# (B, H, KV, T, S, dh, causal, window)
FLASH_CASES = [(1, 8, 2, 128, 256, 64, True, 0),
               (1, 4, 4, 256, 256, 64, True, 128)]


def _pair(a, dtype):
    """The same numpy array as a JAX array and a torch tensor of ``dtype``
    (bf16 rounded once, on the numpy side's float32 values)."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _close(got, want, dtype, name=""):
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape, (name, g.shape, w.shape)
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
    assert err <= TOL[dtype], (name, err)


def _leaf_inputs(shape, dtype, seed=0):
    L2, L1, I, A, Bd = shape
    rng = np.random.RandomState(seed)
    w = rng.randn(L2, L1).astype(np.float32)
    return ((jnp.asarray(w), torch.from_numpy(w)),
            _pair(rng.randn(I, A) * 0.1, dtype),
            _pair(rng.randn(L1, A, Bd) * 0.1, dtype))


@pytest.mark.parametrize("shape", LEAF_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ligo_blend_expand_matches_jax(shape, dtype):
    (wj, wt), (Bj, Bt), (Wj, Wt) = _leaf_inputs(shape, dtype)
    _close(tk.ligo_blend_expand(wt, Bt, Wt), jk.ligo_blend_expand(wj, Bj, Wj),
           dtype, "kernel")
    _close(tk.ligo_blend_expand_ref(wt, Bt, Wt),
           jk.ligo_blend_expand_ref(wj, Bj, Wj), dtype, "ref")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ligo_grow_matches_jax(dtype):
    (wj, wt), (Bj, Bt), (Wj, Wt) = _leaf_inputs((4, 2, 256, 128, 128), dtype,
                                                seed=2)
    Aj, At = _pair(np.random.RandomState(3).randn(192, 128) * 0.1, dtype)
    _close(tk.ligo_grow(wt, Bt, At, Wt), jk.ligo_grow(wj, Bj, Aj, Wj), dtype,
           "kernel")
    _close(tk.ligo_grow_ref(wt, Bt, At, Wt),
           jk.ligo_grow_ref(wj, Bj, Aj, Wj), dtype, "ref")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ligo_blend_expand_vjp_and_its_gradients_match_jax(dtype):
    """Forward and the three cotangents (dw, dB, dW) of a weighted sum of
    the output; the JAX side runs its Pallas forward and fused backward in
    interpret mode."""
    (wj, wt), (Bj, Bt), (Wj, Wt) = _leaf_inputs((4, 2, 100, 72, 90), dtype,
                                                seed=4)
    Cj, Ct = _pair(np.random.RandomState(5).randn(4, 100, 90), dtype)

    def jloss(w, B, W):
        P = jk.ligo_blend_expand_vjp(w, B, W, use_kernel=True)
        return jnp.sum(P.astype(jnp.float32) * Cj.astype(jnp.float32)), P
    (_, Pj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(wj, Bj, Wj)
    leaves = [x.clone().requires_grad_() for x in (wt, Bt, Wt)]
    Pt = tk.ligo_blend_expand_vjp(*leaves)
    (Pt.float() * Ct.float()).sum().backward()
    _close(Pt, Pj, dtype, "P")
    for name, x, g in zip(("dw", "dB", "dW"), leaves, gj):
        assert x.grad.dtype == x.dtype, name
        _close(x.grad, g, dtype, name)


@pytest.mark.parametrize("shape", GROUP_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ligo_blend_expand_bwd_fused_matches_jax(shape, dtype):
    G, L2, L1, E, I, A, Bd = shape
    rng = np.random.RandomState(1)
    w = rng.randn(G, L2, L1).astype(np.float32)
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    Bj, Bt = _pair(rng.randn(I, A) * 0.1, dtype)
    Wj, Wt = _pair(rng.randn(G, L1, E, A, Bd) * 0.1, dtype)
    dPj, dPt = _pair(rng.randn(G, L2, E, I, Bd) * 0.1, dtype)
    got = tk.ligo_blend_expand_bwd_fused(wt, Bt, Wt, dPt)
    want = jk.ligo_blend_expand_bwd_fused(wj, Bj, Wj, dPj)
    ref_t = tk.ligo_blend_expand_bwd_ref(wt, Bt, Wt, dPt)
    ref_j = jk.ligo_blend_expand_bwd_ref(wj, Bj, Wj, dPj)
    for name, g, w_, rt, rj in zip(("dw", "dB", "dW"), got, want, ref_t,
                                   ref_j):
        assert g.dtype == getattr(torch, str(w_.dtype)), name
        _close(g, w_, dtype, name)
        _close(rt, rj, dtype, name + " ref")
    _close(tk.ligo_blend_expand_grouped_ref(wt, Bt, Wt),
           jk.ligo_blend_expand_grouped_ref(wj, Bj, Wj), dtype, "grouped ref")


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(case, dtype):
    B, H, KV, T, S, dh, causal, window = case
    rng = np.random.RandomState(0)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.randn(B, n, t, dh), dtype)
        for n, t in ((H, T), (KV, S), (KV, S)))
    kw = dict(causal=causal, window=window)
    _close(tk.flash_attention(qt, kt, vt, **kw),
           jk.flash_attention(qj, kj, vj, **kw), dtype, "kernel")
    _close(tk.flash_attention_ref(qt, kt, vt, **kw),
           jk.flash_attention_ref(qj, kj, vj, **kw), dtype, "ref")


def _kernel_lines(text):
    return sorted(line for line in text.splitlines()
                  if "kernels_launches" in line)


def test_launch_counts_of_a_plan_apply_match_jax(monkeypatch):
    """One plan apply counts one K1 call per eligible group, and under a
    gradient one K2 call per group too, in both packages: the JAX package
    at trace time (``jax.eval_shape``), the port on fake tensors
    (``FakeTensorMode``, each group's op told to take the kernel route, as
    a CUDA tensor would: the kernels' fake implementations run and nothing
    launches). The mixtral smoke pair has multi-leaf groups and an
    E-expert group, so a per-leaf count would differ. ``/metrics`` then
    carries the same ``kernels_launches`` lines in both packages."""
    from repro.configs import get_config as jget
    from repro.configs import grow_target as jgrow_target
    from repro.configs import smoke_config as jsmoke
    from repro.core import init_ligo_params as jinit_ligo
    from repro.core import plan_for as jplan_for
    from repro.models import init_params as jinit
    from repro_torch import bridge
    from repro_torch.core import plan_for
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves, tree_map

    c1 = jsmoke(jget("mixtral-8x7b"))
    c2 = jgrow_target(c1)
    sp = jinit(c1, jax.random.PRNGKey(0))
    lg = jinit_ligo(jax.random.PRNGKey(1), c1, c2)
    jplan = jplan_for(c1, c2, sp)

    def jloss(lg_):
        return sum(jnp.sum(x * x) for x in jax.tree.leaves(
            jplan.apply(lg_, sp, use_kernel=True)))
    jk.LAUNCH_COUNTS.clear()
    jax.eval_shape(lambda l: jplan.apply(l, sp, use_kernel=True), lg)
    want_apply = dict(jk.LAUNCH_COUNTS)
    jk.LAUNCH_COUNTS.clear()
    jax.eval_shape(jax.grad(jloss), lg)
    want_grad = dict(jk.LAUNCH_COUNTS)
    assert want_apply["fwd"] > 0 and want_grad["bwd"] > 0

    from repro_torch.configs import get_config, grow_target, smoke_config
    t1 = smoke_config(get_config("mixtral-8x7b"))
    t2 = grow_target(t1)
    small = bridge.to_torch(jax.tree.map(np.asarray, sp))
    op = bridge.to_torch(jax.tree.map(np.asarray, lg))
    plan = plan_for(t1, t2, small)
    vjp = ops.ligo_blend_expand_grouped_vjp
    monkeypatch.setattr(ops, "ligo_blend_expand_grouped_vjp",
                        lambda *a, **kw: vjp(*a, **{**kw, "use_kernel": True}))
    launched = tk.launch_counts()
    with FakeTensorMode() as mode:
        small_f = tree_map(mode.from_tensor, small)
        op_f = tree_map(mode.from_tensor, op)
        tk.LAUNCH_COUNTS.clear()
        with torch.no_grad():
            plan.apply(op_f, small_f, use_kernel=True)
        got_apply = dict(tk.LAUNCH_COUNTS)
        for x in tree_leaves(op_f):
            x.requires_grad_()
        tk.LAUNCH_COUNTS.clear()
        sum((x.float() * x.float()).sum()
            for x in tree_leaves(plan.apply(op_f, small_f,
                                            use_kernel=True))).backward()
        got_grad = dict(tk.LAUNCH_COUNTS)
    assert got_apply == want_apply, (got_apply, want_apply)
    assert got_grad == want_grad, (got_grad, want_grad)
    assert tk.launch_counts() == launched   # fake tensors launch nothing
    lines = _kernel_lines(tprom.render())
    assert lines and lines == _kernel_lines(jprom.render()), lines


def test_a_capture_tallies_its_launches_and_each_replay_counts_them(
        monkeypatch):
    """``ops.capture_launches`` holds back the counts of the kernel calls
    made in its block, as a CUDA graph's capture runs nothing, and yields
    them as a tally: a plan apply on fake tensors (the kernel route, as on
    CUDA tensors) tallies what it counts outside the block, and
    ``count_replay`` adds the whole tally at each replay, to
    ``LAUNCH_COUNTS`` and to ``launch_counts()`` alike."""
    from repro_torch.configs import get_config, grow_target, smoke_config
    from repro_torch.core import init_ligo_params, plan_for
    from repro_torch.kernels import ligo_expand, ops
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_map

    c1 = smoke_config(get_config("gpt2-base"))
    c2 = grow_target(c1)
    small = init_params(c1, torch.Generator().manual_seed(0), device="cpu")
    op = init_ligo_params(torch.Generator().manual_seed(1), c1, c2,
                          device="cpu")
    plan = plan_for(c1, c2, small)
    vjp = ops.ligo_blend_expand_grouped_vjp
    monkeypatch.setattr(ops, "ligo_blend_expand_grouped_vjp",
                        lambda *a, **kw: vjp(*a, **{**kw, "use_kernel": True}))

    def apply():
        with FakeTensorMode() as mode, torch.no_grad():
            plan.apply(tree_map(mode.from_tensor, op),
                       tree_map(mode.from_tensor, small), use_kernel=True)
    tk.LAUNCH_COUNTS.clear()
    apply()
    once = dict(tk.LAUNCH_COUNTS)
    assert once["fwd"] > 0
    tk.LAUNCH_COUNTS.clear()
    tk.reset_launch_counts()
    with ops.capture_launches() as tally:
        apply()
        ligo_expand.LAUNCHES += 3       # a wrapper's launches while capturing
    assert dict(tk.LAUNCH_COUNTS) == {} and tk.launch_counts() == {
        "ligo_blend_expand_grouped": 0, "ligo_blend_expand_bwd_fused": 0,
        "flash_attention": 0}
    assert tally.counts == once
    assert tally.launches == {"ligo_blend_expand_grouped": 3}
    for n in (1, 2):
        ops.count_replay(tally)
        assert dict(tk.LAUNCH_COUNTS) == {k: n * v for k, v in once.items()}
        assert tk.launch_counts()["ligo_blend_expand_grouped"] == 3 * n
    tk.reset_launch_counts()
