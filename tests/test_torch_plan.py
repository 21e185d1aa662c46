"""The port's growth engine against the JAX package's: plan structure, plan
apply (K1 route and min-FLOP route), the legacy walk, the squared operator,
and operator composition.

Oracles take ``plan_for(...).executor(mesh=None, ...)`` directly (the
JAX ``hot_grow`` mesh path is broken on jax 0.9.0), with the Pallas K1 in
interpret mode. Tolerance: f32, ≤ 1e-5 scale-normalised per leaf.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jc                                   # noqa: E402
from repro.core import apply_ligo as jax_apply_ligo          # noqa: E402
from repro.core import compose_chain as jax_compose_chain    # noqa: E402
from repro.core import init_ligo_params as jax_init_ligo     # noqa: E402
from repro.core.plan import _build_plan as jax_build_plan    # noqa: E402
from repro.core.plan import _tree_signature as jax_signature  # noqa: E402
from repro.core.plan import plan_for as jax_plan_for         # noqa: E402
from repro.kernels.ligo_expand import fused_vmem_bytes       # noqa: E402
from repro.models import init_params as jax_init_params      # noqa: E402
import repro_torch.configs as tc                             # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.core import (apply_ligo, compose_chain,     # noqa: E402
                              init_ligo_params, plan_for)
from repro_torch.core.plan import _build_plan, _tree_signature  # noqa: E402
from torch_parity import (TINY1, TINY2, TINY3, assert_close,  # noqa: E402
                          jax_cfg, to_numpy)

GROUP_FIELDS = ("kind", "stacked", "paths", "shape", "in_ref", "out_ref",
                "vec", "order")


@pytest.fixture(scope="module")
def small():
    """JAX-initialised TINY1 params, and the same tree bridged to torch."""
    jp = jax_init_params(jax_cfg(TINY1), jax.random.PRNGKey(0))
    return jp, bridge.to_torch(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def operator():
    jop = jax_init_ligo(jax.random.PRNGKey(3), jax_cfg(TINY1), jax_cfg(TINY2))
    return jop, bridge.to_torch(jax.tree.map(np.asarray, jop))


def test_plan_structure_matches_jax(small):
    jp, tp = small
    jplan = jax_plan_for(jax_cfg(TINY1), jax_cfg(TINY2), jp)
    tplan = plan_for(TINY1, TINY2, tp)
    assert len(tplan.groups) == len(jplan.groups)
    for tg, jg in zip(tplan.groups, jplan.groups):
        for f in GROUP_FIELDS:
            assert getattr(tg, f) == getattr(jg, f), (f, tg.paths)
        # at this width the JAX VMEM budget admits every eligible group, so
        # both eligibility rules agree
        assert tg.kernel_ok == jg.kernel_ok, tg.paths
    assert set(tplan.exprs) == set(jplan.exprs)


def test_k1_eligibility_at_gpt2_width():
    """At gpt2-base -> gpt2-medium the JAX plan admits no group to its fused
    kernel (the TPU backward kernel's VMEM state would not fit); the port's
    width-free rule admits the six stacked matrices with an in-expander."""
    j1, j2 = jc.get_config("gpt2-base"), jc.get_config("gpt2-medium")
    shapes = jax.eval_shape(lambda: jax_init_params(j1, jax.random.PRNGKey(0)))
    sig = jax_signature(shapes)
    assert _tree_signature(shapes) == sig
    jplan = jax_build_plan(j1, j2, sig)
    tplan = _build_plan(tc.get_config("gpt2-base"),
                        tc.get_config("gpt2-medium"), sig)
    assert not any(g.kernel_ok for g in jplan.groups)
    # mlp/w2 (L1 12, I 4096, A 3072, Bd 768): ~211 MB against a 10 MiB budget
    assert fused_vmem_bytes(12, 4096, 3072, 768) > 200e6
    ok = sorted(p for g in tplan.groups if g.kernel_ok for p in g.paths)
    assert ok == ["mlp/w1", "mlp/w2", "wk", "wo", "wq", "wv"]
    assert [g.order for g in tplan.groups] == [g.order for g in jplan.groups]


@pytest.mark.parametrize("square", [False, True])
def test_k1_route_places_the_right_expansion_by_cost(square):
    """On the K1 route a group's right expansion runs where its forward (and,
    when the operator takes gradients, its backward) needs the fewest
    operations: before K1 on the L1 source layers, between K1's U and its
    blend, or after K1 on the L2 target layers. At gpt2-base ->
    gpt2-medium mlp/w2 goes between and the other five groups before, with
    or without gradients; the quickstart's pair likewise. Every place gives
    the plain route's tree."""
    from repro_torch.examples import quickstart as qs
    from repro_torch.models.model import init_params
    g1, g2 = tc.get_config("gpt2-base"), tc.get_config("gpt2-medium")
    meta = init_params(g1, torch.Generator().manual_seed(0), device="meta")
    places = {g.paths: (g.right, g.right_grad)
              for g in plan_for(g1, g2, meta).groups if g.kernel_ok}
    assert places == {("mlp/w2",): ("between", "between"),
                      **{(p,): ("before", "before")
                         for p in ("mlp/w1", "wq", "wk", "wv", "wo")}}
    gen = torch.Generator().manual_seed(0)
    sp = init_params(qs.SMALL, gen, device="cpu")
    op = init_ligo_params(gen, qs.SMALL, qs.BIG, device="cpu")
    plan = plan_for(qs.SMALL, qs.BIG, sp)
    assert {g.right for g in plan.groups if g.kernel_ok} == {"before",
                                                             "between"}
    fused = plan.apply(op, sp, use_kernel=True, square=square)
    plain = plan.apply(op, sp, use_kernel=False, square=square)
    assert_close(fused, bridge.to_numpy(plain), rel=1e-5)


def test_right_expansion_costs_at_gpt2_medium():
    """The placement rule's operation counts for mlp/w2 at gpt2-base ->
    gpt2-medium (L1 12, L2 24, a 3072, b 768, i 4096, j 1024): between K1's
    U and its blend saves ~0.35e12 operations of a LiGO step's forward and
    backward against the expansion before K1, and is cheapest for a forward
    alone too."""
    from repro_torch.core.plan import _right_costs
    cost = _right_costs(1, 12, 24, 3072, 768, 4096, 1024)
    fwd = {p: c[0] for p, c in cost.items()}
    both = {p: sum(c) for p, c in cost.items()}
    assert min(fwd, key=fwd.get) == min(both, key=both.get) == "between"
    assert 0.33e12 < both["before"] - both["between"] < 0.37e12
    # the expansion's own matmuls and K1's U at width b, by hand
    mid = 2 * 12 * 4096 * 768 * 1024
    assert fwd["between"] == (2 * 12 * 4096 * 3072 * 768 + mid
                              + 2 * 24 * 12 * 4096 * 1024)


def _forced(plan, place):
    """``plan`` with the right expansion of every K1-route group put at
    ``place``, with or without gradients."""
    groups = tuple(dataclasses.replace(g, right=place, right_grad=place)
                   if g.kernel_ok and g.out_ref else g for g in plan.groups)
    return type(plan)(plan.cfg1, plan.cfg2, groups, plan.exprs)


@pytest.mark.parametrize("place", ["before", "between", "after"])
def test_each_right_placement_matches_jax_apply_and_gradients(
        small, operator, place):
    """Every place of the right expansion on the K1 route (K1's and K2's
    plain versions on CPU tensors) gives the JAX package's apply (its plan
    executor, Pallas K1 in interpret mode) and the gradient of a fixed
    linear read-out of the grown tree with respect to the operator (JAX:
    ``jax.grad`` through its legacy walk), f32, within 1e-5
    scale-normalised per leaf."""
    jp, tp = small
    jop, top = operator
    j1, j2 = jax_cfg(TINY1), jax_cfg(TINY2)
    plan = _forced(plan_for(TINY1, TINY2, tp), place)
    assert any(g.kernel_ok and g.out_ref for g in plan.groups)
    want = jax_plan_for(j1, j2, jp).executor(mesh=None, use_kernel=True)(
        jop, jp)
    with torch.no_grad():
        assert_close(plan.apply(top, tp, use_kernel=True), want, rel=1e-5)

    rng = np.random.RandomState(11)
    readout = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                           to_numpy(want))

    def jax_readout(op):
        grown = jax_apply_ligo(op, jp, j1, j2, engine="legacy")
        return sum(jax.numpy.vdot(a, b) for a, b in zip(
            jax.tree.leaves(grown), jax.tree.leaves(readout)))
    jgrad = jax.grad(jax_readout)(jop)

    from repro_torch.core.ligo import _flatten
    from repro_torch.training import value_and_grad
    tread = _flatten(bridge.to_torch(readout))

    def torch_readout(op):
        grown = _flatten(plan.apply(op, tp, use_kernel=True))
        return sum((grown[k] * tread[k]).sum() for k in sorted(tread)), {}
    _, tgrad = value_and_grad(torch_readout, top)
    assert_close(tgrad, jgrad, rel=1e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("square", [False, True])
def test_plan_apply_matches_jax(small, operator, use_kernel, square):
    jp, tp = small
    jop, top = operator
    j1, j2 = jax_cfg(TINY1), jax_cfg(TINY2)
    want = jax_plan_for(j1, j2, jp).executor(
        mesh=None, use_kernel=True, square=square)(jop, jp)
    got = plan_for(TINY1, TINY2, tp).apply(top, tp, use_kernel=use_kernel,
                                           square=square)
    assert_close(got, want, rel=1e-5)
    legacy = jax_apply_ligo(jop, jp, j1, j2, engine="legacy", square=square)
    assert_close(got, legacy, rel=1e-5)


def test_legacy_walk_matches_jax(small, operator):
    jp, tp = small
    jop, top = operator
    want = jax_apply_ligo(jop, jp, jax_cfg(TINY1), jax_cfg(TINY2),
                          engine="legacy")
    got = apply_ligo(top, tp, TINY1, TINY2, engine="legacy")
    assert_close(got, want, rel=1e-5)
    assert_close(apply_ligo(top, tp, TINY1, TINY2), want, rel=1e-5)


def test_two_hop_compose_chain_matches_jax(small):
    jp, tp = small
    jcfgs = [jax_cfg(c) for c in (TINY1, TINY2, TINY3)]
    jops = [jax_init_ligo(jax.random.PRNGKey(10 + i), a, b)
            for i, (a, b) in enumerate(zip(jcfgs[:-1], jcfgs[1:]))]
    tops = [bridge.to_torch(jax.tree.map(np.asarray, o)) for o in jops]
    jcomp = jax_compose_chain(jops, jcfgs)
    tcomp = compose_chain(tops, [TINY1, TINY2, TINY3])
    assert_close(tcomp, jcomp, rel=1e-6)
    want = jax_plan_for(jcfgs[0], jcfgs[2], jp).executor(
        mesh=None, use_kernel=True)(jcomp, jp)
    got = plan_for(TINY1, TINY3, tp).apply(tcomp, tp)
    assert_close(got, want, rel=1e-5)
    # the composed single apply equals growing hop by hop
    mid = plan_for(TINY1, TINY2, tp).apply(tops[0], tp)
    seq = plan_for(TINY2, TINY3, mid).apply(tops[1], mid)
    assert_close(got, jax.tree.map(np.asarray, bridge.to_numpy(seq)),
                 rel=1e-5)


def test_init_ligo_params_structure_and_patterns():
    gen = torch.Generator().manual_seed(0)
    top = init_ligo_params(gen, TINY1, TINY2, device="cpu")
    jop = jax_init_ligo(jax.random.PRNGKey(0), jax_cfg(TINY1), jax_cfg(TINY2))
    assert (jax.tree.structure(bridge.to_numpy(top))
            == jax.tree.structure(jax.tree.map(np.asarray, jop)))
    for name, m in top["width"].items():
        assert tuple(m.shape) == jop["width"][name].shape
        d2, d1 = m.shape
        # [I; row copies] + 0.01 noise: the identity part survives
        eye = torch.eye(d1)
        assert (m[:d1] - eye).abs().max() < 0.1
    for leaf, blend in top["depth"]["attn"].items():
        np.testing.assert_array_equal(blend.numpy(),
                                      np.asarray(jop["depth"]["attn"][leaf]))
    if not torch.cuda.is_available():      # the default device is "cuda"
        with pytest.raises(RuntimeError, match="CUDA"):
            init_ligo_params(gen, TINY1, TINY2)


def test_cross_family_growth_is_refused_until_ported():
    """The dense→MoE hop matches the JAX package: the
    operator's init (depth blends keyed by the source kind, counted in the
    mapped kind), the plan (target kinds and paths, expert broadcast,
    created router) and the plan and legacy applies of a random LiGO
    operator, both plan routes (<= 1e-5)."""
    src = jc.get_config("llama3-8b")
    jc1 = jc.smoke_config(src)
    jc2 = jc.moe_target(jc1)
    c1, c2 = (tc.base.ModelConfig(**dataclasses.asdict(c)) for c in (jc1, jc2))
    jp = jax_init_params(jc1, jax.random.PRNGKey(0))
    tp = bridge.to_torch(to_numpy(jp))
    gen = torch.Generator().manual_seed(0)
    top0 = init_ligo_params(gen, c1, c2, device="cpu")
    jop = jax_init_ligo(jax.random.PRNGKey(5), jc1, jc2)
    assert (jax.tree.structure(bridge.to_numpy(top0))
            == jax.tree.structure(to_numpy(jop)))
    for leaf, blend in top0["depth"]["attn"].items():
        np.testing.assert_array_equal(blend.numpy(),
                                      np.asarray(jop["depth"]["attn"][leaf]))
    tplan = _build_plan(c1, c2, _tree_signature(tp))
    jplan = jax_build_plan(jc1, jc2, jax_signature(jp))
    assert len(tplan.groups) == len(jplan.groups)
    for tg, jg in zip(tplan.groups, jplan.groups):
        for f in GROUP_FIELDS + ("out_kind", "out_paths", "bcast"):
            assert getattr(tg, f) == getattr(jg, f), (f, tg.paths)
    assert tplan.created == jplan.created == {
        "moe": {"moe/router": ((c2.n_layers, c2.d_model, c2.n_experts),
                               "float32")}}
    top = bridge.to_torch(to_numpy(jop))
    for engine in ("plan", "legacy"):
        want = jax_apply_ligo(jop, jp, jc1, jc2, engine=engine)
        kws = ([{"use_kernel": False}, {"use_kernel": True}]
               if engine == "plan" else [{}])
        for kw in kws:
            got = apply_ligo(top, tp, c1, c2, engine=engine, **kw)
            assert_close(got, want, rel=1e-5)
            assert got["layers"]["moe"]["moe"]["router"].dtype \
                == torch.float32


