"""The port's growth path against the JAX package's, on the CPU: gradients
through the GrowthPlan (the fused route's autograd Function, the plain
route, and ``jax.grad``), the LiGO phase, ``grow`` for each method, and
optimizer-state growth.

Inputs are JAX inits bridged as numpy, and batches of the shared synthetic
corpus. Tolerances (float32, scale-normalised per leaf): plan gradients and
grown moments ≤ 1e-5, where only the summation order differs; the LiGO
phase ≤ 1e-4 per step loss and operator, as each step feeds the next.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.optim as jo                                      # noqa: E402
from repro.core import grow as jax_grow                      # noqa: E402
from repro.core import init_ligo_params as jax_init_ligo     # noqa: E402
from repro.core import train_ligo as jax_train_ligo          # noqa: E402
from repro.core.grow import ligo_loss as jax_ligo_loss       # noqa: E402
from repro.core.plan import plan_for as jax_plan_for         # noqa: E402
from repro.models import init_params as jax_init_params      # noqa: E402
from repro_torch import bridge                               # noqa: E402
import repro_torch.optim as to                               # noqa: E402
from repro_torch.core import (apply_ligo, grow, plan_for,    # noqa: E402
                              train_ligo)
from repro_torch.core.grow import ligo_loss                  # noqa: E402
from repro_torch.core import operators as ops_               # noqa: E402
from repro_torch.data import batch_for_step                  # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.training import value_and_grad             # noqa: E402
from repro_torch.tree import tree_leaves, tree_map           # noqa: E402
from torch_parity import (TINY1, TINY2, TINY3, assert_close,  # noqa: E402
                          jax_cfg, to_numpy)

DEEP = TINY1.scaled(name="gpt2-tiny-deep", n_layers=4)   # depth-only growth


@pytest.fixture(scope="module")
def small():
    jp = jax_init_params(jax_cfg(TINY1), jax.random.PRNGKey(0))
    return jp, bridge.to_torch(to_numpy(jp))


@pytest.fixture(scope="module")
def operator():
    jop = jax_init_ligo(jax.random.PRNGKey(3), jax_cfg(TINY1), jax_cfg(TINY2))
    return jop, bridge.to_torch(to_numpy(jop))


def _scalar(tree):
    """A scalar of every grown leaf, with a gradient that differs entry by
    entry (Σ sin)."""
    return sum(torch.sin(x).sum() for x in tree_leaves(tree))


def _torch_plan_grads(top, tp, use_kernel):
    leaves = [x.clone().requires_grad_(True) for x in tree_leaves(top)]
    it = iter(leaves)
    op = tree_map(lambda _: next(it), top)
    big = plan_for(TINY1, TINY2, tp).apply(op, tp, use_kernel=use_kernel)
    _scalar(big).backward()
    # a leaf the apply does not read gets a zero gradient, as under jax.grad
    it = iter(torch.zeros_like(x) if x.grad is None else x.grad
              for x in leaves)
    return tree_map(lambda _: next(it), top)


def test_plan_gradients_match_jax(small, operator):
    """The fused route's Function (K1's and K2's plain versions on CPU), the
    plain min-FLOP route and jax.grad of the JAX plan apply agree."""
    jp, tp = small
    jop, top = operator
    jfn = jax_plan_for(jax_cfg(TINY1), jax_cfg(TINY2), jp).executor(
        use_kernel=False)
    want = jax.grad(lambda op: sum(jnp.sum(jnp.sin(x))
                                   for x in jax.tree.leaves(jfn(op, jp))))(jop)
    ops.reset_launch_counts()
    fused = _torch_plan_grads(top, tp, use_kernel=True)
    plain = _torch_plan_grads(top, tp, use_kernel=False)
    assert ops.launch_counts() == {"ligo_blend_expand_grouped": 0,
                                   "ligo_blend_expand_bwd_fused": 0,
                                   "flash_attention": 0}
    assert_close(fused, want, rel=1e-5)
    assert_close(plain, want, rel=1e-5)


def test_plan_fused_route_is_eligible_at_tiny_width(small):
    """The fused route really runs in the test above: the stacked matrices
    with an in-expander are kernel groups at this width too."""
    _, tp = small
    ok = sorted(p for g in plan_for(TINY1, TINY2, tp).groups if g.kernel_ok
                for p in g.paths)
    assert ok == ["mlp/w1", "mlp/w2", "wk", "wo", "wq", "wv"]


def _batches(jax_side: bool, n=4):
    for i in range(n):
        host = batch_for_step(TINY1, i, 4, 16, seed=7)
        yield ({k: jnp.asarray(v) for k, v in host.items()} if jax_side
               else {k: torch.as_tensor(v) for k, v in host.items()})


def test_train_ligo_tracks_jax(small, operator):
    jp, tp = small
    jop, top = operator
    kw = dict(steps=4, lr=1e-3, momentum=0.9)
    jlig, jlosses = jax_train_ligo(jop, jp, jax_cfg(TINY1), jax_cfg(TINY2),
                                   _batches(True), **kw)
    ms = []
    tlig, tlosses = train_ligo(top, tp, TINY1, TINY2, _batches(False),
                               step_ms=ms, **kw)
    assert len(ms) == 4 and len(tlosses) == 4
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
    assert_close(tlig, jlig, rel=1e-4)
    # the updates themselves, not only the operator (which is mostly its
    # identity-like start)
    assert_close(tree_map(torch.sub, tlig, top),
                 jax.tree.map(jnp.subtract, jlig, jop), rel=1e-4)
    # the input operator is left as it was
    assert_close(top, jop, rel=0)


def test_bf16_ligo_gradient_gap_is_the_references_own(small, operator):
    """The LiGO-loss gradient with the source model in bf16 lies a few per
    cent from the float32 one in the JAX package too: bf16 arithmetic, not a
    port fault. From the same bridged init and batch (4 x 32 tokens), the
    port's bf16-vs-f32 distance (worst leaf, normalised by the leaf's
    largest float32 entry, floored at 1e-3 of the tree's largest gradient:
    the key bias's gradient is 0 in exact arithmetic) is at most 1.5x the
    JAX package's, and the two float32 gradients agree to 1e-4."""
    jp, tp = small
    jop, top = operator
    j1, j2 = jax_cfg(TINY1), jax_cfg(TINY2)
    host = batch_for_step(TINY1, 0, 4, 32, seed=7)
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in host.items()}

    def jax_grads(params):
        g = jax.grad(lambda op: jax_ligo_loss(op, params, j1, j2, jbatch))(jop)
        return [np.asarray(x, np.float32) for x in jax.tree.leaves(g)]

    def port_grads(params):
        _, g = value_and_grad(lambda op, b: (ligo_loss(op, params, TINY1,
                                                       TINY2, b), {}),
                              top, tbatch)
        return [x.float().numpy() for x in tree_leaves(g)]

    j32 = jax_grads(jp)
    j16 = jax_grads(jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp))
    t32 = port_grads(tp)
    t16 = port_grads(tree_map(lambda x: x.to(torch.bfloat16), tp))
    floor = 1e-3 * max(float(np.abs(b).max()) for b in j32)

    def dist(got, want):
        return max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                     floor)
                   for a, b in zip(got, want))

    jax_gap, port_gap = dist(j16, j32), dist(t16, t32)
    assert 0 < port_gap <= 1.5 * jax_gap, (port_gap, jax_gap)
    assert dist(t32, j32) <= 1e-4


@pytest.mark.parametrize("method", ["stackbert", "interpolation"])
def test_grow_depth_patterns_equal_jax(small, method):
    """Depth-only growth: identity width, so the grown tree is exactly the
    JAX package's."""
    jp, tp = small
    jbig, jinfo = jax_grow(jp, jax_cfg(TINY1), jax_cfg(DEEP), method=method)
    tbig, tinfo = grow(tp, TINY1, DEEP, method=method)
    assert_close(tinfo["operator"], jinfo["operator"], rel=0)
    assert_close(tbig, jbig, rel=1e-6)


@pytest.mark.parametrize("method", ["stackbert", "interpolation", "net2net",
                                    "bert2bert"])
def test_grow_width_operators(small, method):
    """Growth that also widens draws random selections, which differ between
    the packages: the JAX operator, bridged and applied by the port, grows
    the JAX tree; the port's own draw has the JAX operator's structure,
    selection rows that copy one source unit, and the same depth blends."""
    jp, tp = small
    j1, j2 = jax_cfg(TINY1), jax_cfg(TINY2)
    jbig, jinfo = jax_grow(jp, j1, j2, method=method,
                           key=jax.random.PRNGKey(4))
    jop = to_numpy(jinfo["operator"])
    assert_close(apply_ligo(bridge.to_torch(jop), tp, TINY1, TINY2), jbig,
                 rel=1e-5)
    tbig, tinfo = grow(tp, TINY1, TINY2, method=method,
                       gen=torch.Generator().manual_seed(4))
    top = tinfo["operator"]
    assert jax.tree.structure(bridge.to_numpy(top)) == jax.tree.structure(jop)
    assert_close(top["depth"], jop["depth"], rel=0)
    for name, m in top["width"].items():
        assert tuple(m.shape) == jop["width"][name].shape, name
        d2, d1 = m.shape
        if name.endswith("__in") and method in ("net2net", "bert2bert"):
            # count-normalised fan-in: each column sums to 1
            torch.testing.assert_close(m.sum(0), torch.ones(d1))
        else:
            assert set(m.unique().tolist()) <= {0.0, 1.0}
            torch.testing.assert_close(m.sum(1), torch.ones(d2))
            torch.testing.assert_close(m[:d1], torch.eye(d1))
    assert jax.tree.structure(bridge.to_numpy(tbig)) == jax.tree.structure(
        to_numpy(jbig))


def test_grow_random_and_ligo_shapes(small):
    jp, tp = small
    jbig = jax_grow(jp, jax_cfg(TINY1), jax_cfg(TINY2), method="random")[0]
    for method in ("random", "ligo"):
        tbig, info = grow(tp, TINY1, TINY2, method=method, ligo_steps=0)
        got = jax.tree.map(np.shape, bridge.to_numpy(tbig))
        assert got == jax.tree.map(np.shape, to_numpy(jbig)), method
    assert info["operator"] is info["operator_init"]   # no data: untrained
    with pytest.raises(ValueError, match="lemon"):
        grow(tp, TINY1, TINY2, method="lemon")


def _jax_state(jp, seed):
    """An AdamW state with non-zero moments: one update from random grads."""
    rng = np.random.RandomState(seed)
    g = jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape), p.dtype), jp)
    _, st = jo.adamw_update(g, jo.adamw_init(jp), jp, lr=1e-3)
    return st


def _torch_state(js):
    return to.AdamWState(m=bridge.to_torch(to_numpy(js.m)),
                         v=bridge.to_torch(to_numpy(js.v)),
                         count=int(js.count))


def test_grow_adamw_state_matches_jax(small, operator):
    jp, tp = small
    jop, top = operator
    js = _jax_state(jp, 0)
    want = jo.grow_adamw_state(js, jop, jax_cfg(TINY1), jax_cfg(TINY2))
    got = to.grow_adamw_state(_torch_state(js), top, TINY1, TINY2)
    assert got.count == int(want.count) == 1
    assert_close(got.m, want.m, rel=1e-5)
    assert_close(got.v, want.v, rel=1e-5)
    assert min(float(x.min()) for x in tree_leaves(got.v)) >= 0.0
    # grow() with an opt_state carries it the same way
    _, info = grow(tp, TINY1, TINY2, method="ligo", ligo_steps=0,
                   opt_state=_torch_state(js))
    ref = to.grow_adamw_state(_torch_state(js), info["operator"], TINY1,
                              TINY2)
    assert_close(info["opt_state"].v, to_numpy(bridge.to_numpy(ref.v)),
                 rel=0)
    with pytest.raises(ValueError, match="mirror"):
        grow(tp, TINY1, TINY2, method="stackbert",
             opt_state=to.AdamWState(m={}, v={}, count=0))


def test_grow_adamw_state_chain_matches_jax(small):
    jp, tp = small
    jcfgs = [jax_cfg(c) for c in (TINY1, TINY2, TINY3)]
    jops = [jax_init_ligo(jax.random.PRNGKey(20 + i), a, b)
            for i, (a, b) in enumerate(zip(jcfgs[:-1], jcfgs[1:]))]
    js = _jax_state(jp, 1)
    want = jo.grow_adamw_state_chain(js, jops, jcfgs)
    got = to.grow_adamw_state_chain(
        _torch_state(js), [bridge.to_torch(to_numpy(o)) for o in jops],
        [TINY1, TINY2, TINY3])
    assert not to.hop_uses_grouped_gamma(TINY1, TINY2)
    assert_close(got.m, want.m, rel=1e-5)
    assert_close(got.v, want.v, rel=1e-5)


def test_selection_expander_block_copies_whole_heads():
    B, B_norm = ops_._selection(torch.Generator().manual_seed(0), 12, 8,
                                block=4, device="cpu")
    assert tuple(B.shape) == (12, 8)
    # rows 8..11 copy one whole 4-wide source block
    src = B[8:].argmax(dim=1)
    assert int(src[0]) % 4 == 0 and torch.equal(src, src[0] + torch.arange(4))
    torch.testing.assert_close(B_norm.sum(0), torch.ones(8))


def test_grow_options(small, capsys):
    """``apply=False`` returns only the operator, ``engine="legacy"`` grows
    the same tree as the plan, ``grow_optimizer=False`` starts the grown
    moments from zero, and ``log_every`` prints the phase's losses."""
    _, tp = small
    none, info = grow(tp, TINY1, TINY2, method="stackbert", apply=False,
                      gen=torch.Generator().manual_seed(1))
    assert none is None and "operator" in info
    plan_big, _ = grow(tp, TINY1, TINY2, method="stackbert",
                       gen=torch.Generator().manual_seed(1))
    legacy_big, _ = grow(tp, TINY1, TINY2, method="stackbert",
                         engine="legacy",
                         gen=torch.Generator().manual_seed(1))
    assert_close(legacy_big, to_numpy(bridge.to_numpy(plan_big)), rel=1e-6)
    _, info = grow(tp, TINY1, TINY2, method="stackbert",
                   opt_state=to.adamw_init(tp), grow_optimizer=False)
    assert all(float(x.abs().max()) == 0.0
               for x in tree_leaves(info["opt_state"].v))
    train_ligo(info["operator"], tp, TINY1, TINY2, _batches(False, n=2),
               steps=2, log_every=1)
    assert capsys.readouterr().out.count("[ligo] step") == 2
