"""The port's sequence-mixer families against the JAX package's, on the CPU
at smoke sizes, float32, on bridged numpy parameters: xlstm-125m (mLSTM and
sLSTM pairs, ``family="ssm"``) and zamba2-2.7b (Mamba2 groups with one
shared attention block, ``family="hybrid"``).

- ``models.seqmix``: ``gla_chunked`` at T = 48 (one chunk) and T = 200
  (the pad path), with and without ``normalize``, from a zero and from a
  carried-in state, against the JAX package's ``gla_chunked`` and
  ``gla_recurrent_ref``; its gradients against ``jax.grad``; ``gla_step``,
  ``causal_conv`` with a conv state, ``slstm_cell`` and ``slstm_seq``;
- each block's train, prefill and decode outputs and caches;
- the model: the parameter tree (bf16 with Mamba2's float32 leaves too),
  forward, prefill and decode logits and caches, the incremental-decode
  consistency of ``tests/test_models.py``, ``loss_fn`` and its gradients;
- growth: ``init_ligo_params``' tree, ``apply_ligo`` of a bridged operator
  (plan on both routes, legacy), ``grow_adamw_state``, and three
  ``train_ligo`` steps of ``grow(method="ligo")`` into ``grow_target``.
The serving engine's and the launcher's cases of both families are in
``test_torch_recurrent_engine.py``.

Tolerances, scale-normalised per leaf (max |a - b| <= tol * max |b|):
1e-5 for the seqmix ops and single blocks, 1e-4 for the model's outputs,
losses, gradients and grown trees.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jc                                   # noqa: E402
from repro.core import apply_ligo as jax_apply_ligo          # noqa: E402
from repro.core import init_ligo_params as jax_init_ligo     # noqa: E402
from repro.core.grow import grow as jax_grow                 # noqa: E402
from repro.models import blocks as jblocks                   # noqa: E402
from repro.models import loss_fn as jax_loss_fn              # noqa: E402
from repro.models import model as jmodel                     # noqa: E402
from repro.models import seqmix as jseq                      # noqa: E402
from repro.optim import adamw_init as jax_adamw_init         # noqa: E402
from repro.optim import adamw_update as jax_adamw_update     # noqa: E402
from repro.optim import grow_adamw_state as jax_grow_adamw   # noqa: E402
import repro_torch.configs as tc                             # noqa: E402
from repro_torch import bridge, optim as to                  # noqa: E402
from repro_torch.core import (apply_ligo, grow, init_ligo_params,  # noqa: E402
                              plan_for)
from repro_torch.data import batch_for_step                  # noqa: E402
from repro_torch.models import blocks as tblocks             # noqa: E402
from repro_torch.models import loss_fn, model as tmodel      # noqa: E402
from repro_torch.models import seqmix as tseq                # noqa: E402
from repro_torch.tree import sorted_leaves                   # noqa: E402
from torch_parity import assert_close, jax_cfg, to_numpy     # noqa: E402

XLSTM = tc.smoke_config(tc.get_config("xlstm-125m"))
ZAMBA = tc.smoke_config(tc.get_config("zamba2-2.7b"))
ARCHS = {"xlstm": XLSTM, "zamba2": ZAMBA}
SEQ_TOL = 1e-5
MODEL_TOL = 1e-4


def _bridge(tree):
    return bridge.to_torch(to_numpy(tree))


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def models():
    """Each arch's JAX params (compiled init) and their bridged copy."""
    out = {}
    for name, cfg in ARCHS.items():
        jp = jax.jit(lambda k, c=jax_cfg(cfg): jmodel.init_params(c, k))(
            jax.random.PRNGKey(0))
        out[name] = (jp, _bridge(jp))
    return out


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["xlstm-125m", "zamba2-2.7b"])
def test_seqmix_configs_match_the_reference(name):
    ours, theirs = tc.get_config(name), jc.get_config(name)
    for a, b in ((ours, theirs), (tc.grow_target(ours),
                                  jc.grow_target(theirs))):
        assert a.config_hash() == b.config_hash()
        assert a.param_count() == b.param_count()
        assert a.mamba_heads == b.mamba_heads
        assert a.sub_quadratic is b.sub_quadratic is True
    assert tc.get_config("llama3-8b").sub_quadratic is False
    assert tc.get_config("mixtral-8x7b").sub_quadratic is True   # window
    assert name in tc.list_archs()


# ---------------------------------------------------------------------------
# seqmix ops
# ---------------------------------------------------------------------------
def _gla_inputs(T, seed, B=2, H=3, dk=8, dv=6, mamba=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, dk).astype(np.float32)
    k = rng.randn(B, T, H, dk).astype(np.float32)
    v = rng.randn(B, T, H, dv).astype(np.float32)
    if mamba:            # Mamba2's decays: -exp(A_log) dt, no input gate
        dt = np.log1p(np.exp(rng.randn(B, T, H) - 1.0))
        log_f = (-np.linspace(1.0, 16.0, H) * dt).astype(np.float32)
        log_i = np.zeros((B, T, H), np.float32)
    else:                # mLSTM's sigmoid gates
        log_f = -np.log1p(np.exp(-(rng.randn(B, T, H) + 3.0)))
        log_i = -np.log1p(np.exp(-rng.randn(B, T, H)))
        log_f, log_i = log_f.astype(np.float32), log_i.astype(np.float32)
    return q, k, v, log_f, log_i


def _gla_state(seed, B=2, H=3, dk=8, dv=6):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, dk, dv).astype(np.float32),
            rng.randn(B, H, dk).astype(np.float32))


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("normalize", [False, True], ids=["plain", "norm"])
@pytest.mark.parametrize("T", [48, 200])
def test_gla_chunked_matches_jax(T, normalize, carried):
    """Output and final state against the JAX package's gla_chunked and
    its recurrent oracle (T = 200 pads to two chunks of 128)."""
    x = _gla_inputs(T, seed=T + normalize)
    st = _gla_state(7) if carried else None
    jst = None if st is None else jseq.GLAState(*map(jnp.asarray, st))
    tst = None if st is None else tseq.GLAState(*map(_t, st))
    want = jax.jit(lambda *a: jseq.gla_chunked(*a[:5], a[5],
                                               normalize=normalize))(
        *map(jnp.asarray, x), jst)
    oracle = jseq.gla_recurrent_ref(*map(jnp.asarray, x), jst,
                                    normalize=normalize)
    got = tseq.gla_chunked(*map(_t, x), tst, normalize=normalize)
    ref = tseq.gla_recurrent_ref(*map(_t, x), tst, normalize=normalize)
    for g in (got, ref):
        assert_close(g[0], want[0], SEQ_TOL)
        assert_close({"S": g[1].S, "n": g[1].n}, {"S": want[1].S, "n": want[1].n},
               SEQ_TOL)
    assert_close(ref[0], oracle[0], SEQ_TOL)


@pytest.mark.parametrize("gates", ["mlstm", "mamba2"])
def test_gla_chunked_gradients_match_jax(gates):
    """Gradients of a weighted sum of gla_chunked's output and state in
    q, k, v and both gates, against jax.grad of the JAX package's
    gla_chunked (mLSTM gates, where its gradients are finite) and of its
    recurrent oracle (Mamba2 decays, which overflow its masked exponent
    above the diagonal; the port masks before the exp)."""
    x = _gla_inputs(150, seed=11, mamba=gates == "mamba2")
    rng = np.random.RandomState(12)
    wo = rng.randn(2, 150, 3, 6).astype(np.float32)
    ws = rng.randn(2, 3, 8, 6).astype(np.float32)

    def jloss(fn, *a):
        h, st = fn(*a, normalize=gates == "mlstm")
        return jnp.sum(h * wo) + jnp.sum(st.S * ws)

    jfn = jseq.gla_chunked if gates == "mlstm" else jseq.gla_recurrent_ref
    want = jax.jit(jax.grad(lambda *a: jloss(jfn, *a),
                            argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, x))
    ts = [_t(a).requires_grad_(True) for a in x]
    h, st = tseq.gla_chunked(*ts, normalize=gates == "mlstm")
    (torch.sum(h * _t(wo)) + torch.sum(st.S * _t(ws))).backward()
    for t, w in zip(ts, want):
        assert torch.isfinite(t.grad).all()
        assert_close(t.grad, w, SEQ_TOL * 10)


def test_gla_step_and_causal_conv_match_jax():
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 3, 8).astype(np.float32) for _ in range(3))
    lf, li = (-rng.rand(2, 3).astype(np.float32) for _ in range(2))
    S, n = _gla_state(4, H=3, dk=8, dv=8)
    for norm in (False, True):
        want = jseq.gla_step(*map(jnp.asarray, (q, k, v, lf, li)),
                             jseq.GLAState(jnp.asarray(S), jnp.asarray(n)),
                             normalize=norm)
        got = tseq.gla_step(*map(_t, (q, k, v, lf, li)),
                            tseq.GLAState(_t(S), _t(n)), normalize=norm)
        assert_close(got[0], want[0], SEQ_TOL)
        assert_close({"S": got[1].S, "n": got[1].n},
               {"S": want[1].S, "n": want[1].n}, SEQ_TOL)
    x = rng.randn(2, 9, 5).astype(np.float32)
    w = rng.randn(4, 5).astype(np.float32)
    cs = rng.randn(2, 3, 5).astype(np.float32)
    for state in (None, cs):
        want = jseq.causal_conv(jnp.asarray(x), jnp.asarray(w),
                                None if state is None else jnp.asarray(state))
        got = tseq.causal_conv(_t(x), _t(w),
                               None if state is None else _t(state))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_slstm_cell_and_seq_match_jax():
    """One cell from the -1e30 stabiliser start and from a live state, and
    a 20-step sequence from a carried state, float32 throughout."""
    rng = np.random.RandomState(5)
    B, D = 2, 16
    p = {"w": rng.randn(D, 4 * D).astype(np.float32) * 0.3,
         "r": rng.randn(D, 4 * D).astype(np.float32) * 0.3,
         "b": rng.randn(4 * D).astype(np.float32) * 0.1}
    jp, tp = ({k: f(v) for k, v in p.items()} for f in (jnp.asarray, _t))
    xg = rng.randn(B, 4 * D).astype(np.float32)
    live = tuple(rng.randn(B, D).astype(np.float32) for _ in range(4))
    for st in (None, live):
        jst = (jseq.slstm_init_state(B, D) if st is None
               else jseq.SLSTMState(*map(jnp.asarray, st)))
        tst = (tseq.slstm_init_state(B, D) if st is None
               else tseq.SLSTMState(*map(_t, st)))
        want = jseq.slstm_cell(jnp.asarray(xg), jp, jst)
        got = tseq.slstm_cell(_t(xg), tp, tst)
        assert_close(got[0], want[0], SEQ_TOL)
        assert_close(got[1]._asdict(), dict(want[1]._asdict()), SEQ_TOL)
    x = rng.randn(B, 20, D).astype(np.float32)
    want = jax.jit(jseq.slstm_seq)(jnp.asarray(x), jp,
                                   jseq.SLSTMState(*map(jnp.asarray, live)))
    got = tseq.slstm_seq(_t(x), tp, tseq.SLSTMState(*map(_t, live)))
    assert_close(got[0], want[0], SEQ_TOL)
    assert_close(got[1]._asdict(), dict(want[1]._asdict()), SEQ_TOL)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
BLOCKS = {"mlstm": XLSTM, "slstm": XLSTM, "mamba2": ZAMBA}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_train_prefill_decode_match_jax(kind):
    """Train and prefill outputs, the prefill cache, and three decode
    steps' outputs and caches from it."""
    cfg = BLOCKS[kind]
    jc_ = jax_cfg(cfg)
    jp = jblocks.INIT[kind](jax.random.PRNGKey(1), jc_)
    tp = _bridge(jp)
    japply = getattr(jblocks, f"apply_{kind}")
    tapply = getattr(tblocks, f"apply_{kind}")
    x = np.random.RandomState(2).randn(2, 21, cfg.d_model).astype(np.float32)
    for mode in ("train", "prefill"):
        jy, jcache, _ = jax.jit(lambda p, x: japply(p, x, jc_, mode=mode))(
            jp, jnp.asarray(x))
        ty, tcache = tapply(tp, _t(x), cfg, mode=mode)
        assert_close(ty, jy, SEQ_TOL)
        assert_close(tcache, jcache, SEQ_TOL)
    jdec = jax.jit(lambda p, x, c: japply(p, x, jc_, mode="decode", cache=c))
    for i in range(3):
        xt = np.random.RandomState(10 + i).randn(2, 1, cfg.d_model).astype(
            np.float32)
        jy, jcache, _ = jdec(jp, jnp.asarray(xt), jcache)
        ty, tcache = tapply(tp, _t(xt), cfg, mode="decode", cache=tcache)
        assert_close(ty, jy, SEQ_TOL)
        assert_close(tcache, jcache, SEQ_TOL)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_tree_matches_jax(arch, dtype):
    """One stack per kind (zamba2's shared block unstacked), every shape
    and dtype the JAX package's, Mamba2's A_log, Dskip and dt_bias float32
    in a bf16 model; a bf16 tree crosses the bridge with them kept."""
    cfg = ARCHS[arch].scaled(dtype=dtype)
    want = jax.eval_shape(lambda: jmodel.init_params(
        jax_cfg(cfg), jax.random.PRNGKey(0)))
    tp = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert sum(x.numel() for x in sorted_leaves(tp)) == cfg.param_count()
    assert jax.tree.structure(bridge.to_numpy(tp)) == jax.tree.structure(want)
    for a, b in zip(sorted_leaves(tp), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
    if arch == "zamba2":
        assert tp["layers"]["shared_attn"]["wq"].dim() == 2
        back = bridge.to_torch(bridge.to_numpy(tp), dtype=torch.bfloat16)
        assert back["layers"]["mamba2"]["A_log"].dtype == torch.float32
        assert back["layers"]["mamba2"]["in_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_forward_prefill_decode_match_jax(models, arch):
    """forward's hidden states, prefill's logits and state (the tuple
    caches, zamba2's attention caches padded to max_len), three decode
    steps' logits and state; then the incremental-decode consistency of
    tests/test_models.py: prefill(T-1) + one decode step equals the full
    forward at positions T-2 and T-1."""
    cfg = ARCHS[arch]
    jc_ = jax_cfg(cfg)
    jp, tp = models[arch]
    T = 33
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, T))
    jh, _, _ = jax.jit(lambda p, t: jmodel.forward(p, jc_, {"tokens": t}))(
        jp, jnp.asarray(toks))
    th, _ = tmodel.forward(tp, cfg, {"tokens": _t(toks)})
    assert_close(th, jh, MODEL_TOL)

    jl, jst = jmodel.prefill(jp, jc_, {"tokens": jnp.asarray(toks[:, :-1])},
                             max_len=T + 4)
    tl, tst = tmodel.prefill(tp, cfg, {"tokens": _t(toks[:, :-1])},
                             max_len=T + 4)
    assert isinstance(tst["caches"], tuple) and tst["pos"] == T - 1
    assert_close(tl, jl, MODEL_TOL)
    assert_close(tst["caches"], jst["caches"], MODEL_TOL)
    full = tmodel.unembed(tp, cfg, th)
    np.testing.assert_allclose(tl.numpy(), full[:, T - 2].numpy(), atol=2e-4)
    jdec = jax.jit(lambda p, s, t: jmodel.decode_step(p, jc_, s,
                                                      {"tokens": t}))
    nxt = toks[:, -1:]
    for i in range(3):
        jl, jst = jdec(jp, jst, jnp.asarray(nxt))
        tl, tst = tmodel.decode_step(tp, cfg, tst, {"tokens": _t(nxt)})
        assert_close(tl, jl, MODEL_TOL)
        assert_close(tst["caches"], jst["caches"], MODEL_TOL)
        if i == 0:
            np.testing.assert_allclose(tl.numpy(), full[:, T - 1].numpy(),
                                       atol=2e-4)
        nxt = np.argmax(np.asarray(jl), -1)[:, None]
    # a fresh decode state is the JAX package's
    z = bridge.to_numpy(tmodel.init_decode_state(cfg, 2, 16,
                                                 device="cpu")["caches"])
    zj = to_numpy(jmodel.init_decode_state(jc_, 2, 16)["caches"])
    assert jax.tree.structure(z) == jax.tree.structure(zj)
    for a, b in zip(jax.tree.leaves(z), jax.tree.leaves(zj)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_gradients_match_jax(models, arch):
    """loss_fn and its gradients (and the remat forward's loss, bitwise the
    plain forward's)."""
    cfg = ARCHS[arch]
    jp, tp = models[arch]
    host = batch_for_step(cfg, 0, 2, 24, seed=3)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jax_cfg(cfg),
                              {k: jnp.asarray(v) for k, v in host.items()}),
        has_aux=True))(jp)
    tp = bridge.to_torch(bridge.to_numpy(tp))
    leaves = sorted_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    tloss, _ = loss_fn(tp, cfg, {k: torch.as_tensor(v)
                                 for k, v in host.items()})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=MODEL_TOL)
    with torch.no_grad():                   # remat: one pair or group a time
        rl, _ = loss_fn(tp, cfg, {k: torch.as_tensor(v)
                                  for k, v in host.items()}, remat=True)
    assert rl.item() == tloss.item()
    got = jax.tree.unflatten(jax.tree.structure(to_numpy(jg)),
                             [x.grad.numpy() for x in leaves])
    from conftest import assert_trees_close_normalized
    assert_trees_close_normalized(jax.tree.leaves(got),
                                  jax.tree.leaves(to_numpy(jg)),
                                  rel=MODEL_TOL)


# ---------------------------------------------------------------------------
# Growth
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_ligo_apply_and_moments_match_jax(models, arch):
    """init_ligo_params' tree (the seg spaces inner, xheads, mheads),
    apply_ligo of the JAX operator on the plan's K1 route and plain route
    and on the legacy walk, the grown tree's layout (zamba2's shared block
    unstacked, grown by width only), and grow_adamw_state (v through the
    squared operator)."""
    c1 = ARCHS[arch]
    c2 = tc.grow_target(c1)
    jp, tp = models[arch]
    jop = jax_init_ligo(jax.random.PRNGKey(6), jax_cfg(c1), jax_cfg(c2))
    ours = init_ligo_params(torch.Generator().manual_seed(0), c1, c2,
                            device="cpu")
    assert jax.tree.structure(bridge.to_numpy(ours)) \
        == jax.tree.structure(to_numpy(jop))
    for a, b in zip(sorted_leaves(ours), jax.tree.leaves(jop)):
        assert tuple(a.shape) == b.shape
    top = _bridge(jop)
    want = jax_apply_ligo(jop, jp, jax_cfg(c1), jax_cfg(c2), engine="legacy")
    for kw in ({"use_kernel": True}, {"use_kernel": False},
               {"engine": "legacy"}):
        assert_close(apply_ligo(top, tp, c1, c2, **kw), want, MODEL_TOL)
    groups = {p: g for g in plan_for(c1, c2, tp).groups for p in g.paths}
    if arch == "xlstm":
        assert groups["gates"].kernel_ok and groups["gates"].shape[-1] == 8
    else:
        assert groups["in_proj"].kernel_ok
        assert not groups["wq"].stacked and not groups["wq"].kernel_ok
    rng = np.random.RandomState(0)
    g = jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape), p.dtype), jp)
    _, js = jax_adamw_update(g, jax_adamw_init(jp), jp, lr=1e-3)
    ts = to.AdamWState(m=_bridge(js.m), v=_bridge(js.v), count=int(js.count))
    want = jax_grow_adamw(js, jop, jax_cfg(c1), jax_cfg(c2))
    got = to.grow_adamw_state(ts, top, c1, c2)
    assert_close(got.m, want.m, MODEL_TOL)
    assert_close(got.v, want.v, MODEL_TOL)
    assert got.count == int(want.count)


def _batches(cfg, jax_side, n):
    for i in range(n):
        host = batch_for_step(cfg, i, 2, 16, seed=5)
        yield ({k: jnp.asarray(v) for k, v in host.items()} if jax_side
               else {k: torch.as_tensor(v) for k, v in host.items()})


def _gla_chunked_masked(q, k, v, log_f, log_i, state=None, *, chunk=128,
                        normalize=False):
    """The JAX package's gla_chunked with its intra-chunk decay masked
    before the exp, as the port masks it: the oracle of a LiGO phase whose
    Mamba2 decays overflow the reference's exp above the diagonal (there
    its gradients are NaN; ROADMAP.md §3)."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    C = min(chunk, T)
    pad = (-T) % C
    if pad:
        zp = [(0, 0), (0, pad)]
        q, k, v = (jnp.pad(a, zp + [(0, 0)] * 2) for a in (q, k, v))
        log_f = jnp.pad(log_f, zp + [(0, 0)])
        log_i = jnp.pad(log_i, zp + [(0, 0)], constant_values=-1e30)
    NC = (T + pad) // C
    f32 = jnp.float32
    split = [a.reshape((B, NC, C) + a.shape[2:]).astype(f32)
             for a in (q, k, v, log_f, log_i)]
    if state is None:
        state = jseq.gla_init_state(B, H, dk, dv)
    tri = jnp.tril(jnp.ones((C, C), bool))[None, :, :, None]

    def chunk_step(carry, inp):
        S, n = carry
        qb, kb, vb, lfb, lib = inp
        Lf = jnp.cumsum(lfb, axis=1)
        Lf_tot = Lf[:, -1]
        q_dec = qb * jnp.exp(Lf)[..., None]
        diff = Lf[:, :, None] - Lf[:, None, :] + lib[:, None, :]
        A = jnp.einsum("bthk,bshk->btsh", qb, kb) * jnp.exp(
            jnp.where(tri, diff, -jnp.inf))
        w = jnp.exp(Lf_tot[:, None] - Lf + lib)
        k_w = kb * w[..., None]
        S_new = S * jnp.exp(Lf_tot)[..., None, None] + jnp.einsum(
            "bchk,bchv->bhkv", k_w, vb)
        n_new = n * jnp.exp(Lf_tot)[..., None] + jnp.sum(k_w, axis=1)
        h = (jnp.einsum("bchk,bhkv->bchv", q_dec, S)
             + jnp.einsum("btsh,bshv->bthv", A, vb))
        norm = jnp.einsum("bchk,bhk->bch", q_dec, n) + jnp.sum(A, axis=2)
        return (S_new, n_new), (h, norm)

    (S_f, n_f), (h, norm) = jax.lax.scan(
        chunk_step, (state.S.astype(f32), state.n.astype(f32)),
        tuple(jnp.moveaxis(a, 1, 0) for a in split))
    h = jnp.moveaxis(h, 0, 1).reshape(B, NC * C, H, dv)[:, :T]
    if normalize:
        norm = jnp.moveaxis(norm, 0, 1).reshape(B, NC * C, H)[:, :T]
        h = h / jnp.maximum(jnp.abs(norm), 1.0)[..., None]
    return h.astype(v.dtype), jseq.GLAState(S_f, n_f)


def test_masked_oracle_is_the_references_forward():
    x = [jnp.asarray(a) for a in _gla_inputs(200, seed=9, mamba=True)]
    for a, b in zip(jax.tree.leaves(jseq.gla_chunked(*x)),
                    jax.tree.leaves(_gla_chunked_masked(*x))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_ligo_three_steps_match_jax(models, arch, monkeypatch):
    """grow(method="ligo") into grow_target from the JAX package's own
    operator draw: the three LiGO-phase losses (each finite) and the grown
    model, within 1e-4. zamba2's phase overflows the reference's masked
    exponent and its gradients go NaN at the first step (ROADMAP.md §3),
    so it is held to the reference with the decay masked before the exp
    (:func:`_gla_chunked_masked`, the same forward bit for bit)."""
    import importlib
    tgrow = importlib.import_module("repro_torch.core.grow")
    c1 = ARCHS[arch]
    c2 = tc.grow_target(c1)
    jp, tp = models[arch]
    key = jax.random.PRNGKey(4)
    top = _bridge(jax_init_ligo(key, jax_cfg(c1), jax_cfg(c2)))
    monkeypatch.setattr(tgrow, "init_ligo_params", lambda *a, **k: top)
    if arch == "zamba2":
        monkeypatch.setattr(jseq, "gla_chunked", _gla_chunked_masked)
    jbig, jinfo = jax_grow(jp, jax_cfg(c1), jax_cfg(c2), method="ligo",
                           key=key, data_it=_batches(c2, True, 3),
                           ligo_steps=3)
    tbig, tinfo = grow(tp, c1, c2, method="ligo",
                       data_it=_batches(c2, False, 3), ligo_steps=3)
    assert all(math.isfinite(x) for x in tinfo["ligo_losses"])
    np.testing.assert_allclose(tinfo["ligo_losses"], jinfo["ligo_losses"],
                               rtol=MODEL_TOL)
    assert_close(tbig, jbig, MODEL_TOL)
