"""The paper's vision pairs (deit-s -> deit-b, cait-xs -> cait-s) in the
port against the JAX package, on the CPU, at smoke sizes with each pair's
own width ratio and head change (DeiT: d 64 -> 128, 4 -> 8 heads; CaiT:
d 48 -> 64, 3 -> 4 heads; both keep their depth, as the pairs do).

Inputs are JAX inits bridged as numpy and ``dummy_batch`` batches drawn
from a numpy seed. Tolerances (float32, scale-normalised per leaf): the
dummy batches and parameter trees equal; forward hidden states, the cls
loss and its gradients ≤ 1e-4 (a whole forward and backward in another
summation order); a LiGO grow ≤ 1e-5 (only the order of the sums
differs); three ``train_ligo`` steps ≤ 1e-4 per step loss and operator,
as each step feeds the next.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import apply_ligo as jax_apply_ligo          # noqa: E402
from repro.core import init_ligo_params as jax_init_ligo     # noqa: E402
from repro.core import train_ligo as jax_train_ligo          # noqa: E402
from repro.models import forward as jax_forward              # noqa: E402
from repro.models import init_params as jax_init_params      # noqa: E402
from repro.models import inputs as jax_inputs                # noqa: E402
from repro.models.losses import loss_fn as jax_loss_fn       # noqa: E402
import repro_torch.configs as tc                             # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.core import (apply_ligo, grow, plan_for,    # noqa: E402
                              train_ligo)
from repro_torch.core.grow import batch_geometry             # noqa: E402
from repro_torch.models import inputs                        # noqa: E402
from repro_torch.models.losses import loss_fn                # noqa: E402
from repro_torch.models.model import forward, init_params    # noqa: E402
from repro_torch.obs.ledger import RunLedger, read_ledger    # noqa: E402
from repro_torch.training import value_and_grad             # noqa: E402
from repro_torch.tree import tree_map                        # noqa: E402
from torch_parity import assert_close, jax_cfg, to_numpy     # noqa: E402

DEIT1 = tc.smoke_config(tc.get_config("deit-s"))
DEIT2 = DEIT1.scaled(name="deit-b-smoke", d_model=128, n_heads=8,
                     n_kv_heads=8, d_ff=256)
CAIT1 = tc.smoke_config(tc.get_config("cait-xs")).scaled(
    d_model=48, n_heads=3, n_kv_heads=3, d_ff=192)
CAIT2 = tc.smoke_config(tc.get_config("cait-s"))
PAIRS = {"deit": (DEIT1, DEIT2), "cait": (CAIT1, CAIT2)}
CFGS = {"deit-s": DEIT1, "deit-b": DEIT2, "cait-xs": CAIT1, "cait-s": CAIT2}
BATCH = 3


@pytest.fixture(scope="module", params=sorted(PAIRS))
def pair(request):
    """(cfg1, cfg2, JAX source params, the same bridged, JAX operator, the
    same bridged) of one vision pair."""
    c1, c2 = PAIRS[request.param]
    jp = jax_init_params(jax_cfg(c1), jax.random.PRNGKey(0))
    jop = jax_init_ligo(jax.random.PRNGKey(3), jax_cfg(c1), jax_cfg(c2))
    return (c1, c2, jp, bridge.to_torch(to_numpy(jp)), jop,
            bridge.to_torch(to_numpy(jop)))


def _batch(cfg, kind="train", seed=0):
    """The same dummy batch from both packages: (JAX's, the port's)."""
    jb = jax_inputs.dummy_batch(jax_cfg(cfg), BATCH, 16, kind, seed=seed)
    return jb, inputs.dummy_batch(cfg, BATCH, 16, kind, seed=seed,
                                  device="cpu")


def test_vision_pairs_are_the_papers():
    """The smoke pairs keep each published pair's shape: equal depth, the
    width ratio (2 and 4/3), the head change at a fixed head width, 197
    tokens and 1000 classes at full size."""
    for a, b in (("deit-s", "deit-b"), ("cait-xs", "cait-s")):
        c1, c2 = tc.get_config(a), tc.get_config(b)
        s1, s2 = PAIRS[a.split("-")[0]]
        assert c1.n_layers == c2.n_layers and s1.n_layers == s2.n_layers
        assert c2.d_model * s1.d_model == c1.d_model * s2.d_model
        assert (c1.d_head == c2.d_head and s1.d_head == s2.d_head
                and c1.num_patches == 197 and c1.vocab_size == 1000)
        assert (c1.modality, c1.objective, c1.causal) == ("vision", "cls",
                                                          False)


CASES = [(name, kind) for name in sorted(CFGS)
         for kind in ("train", "prefill", "decode")]
TEXT = {"gpt2": tc.smoke_config(tc.get_config("gpt2-base")),
        "bert": tc.smoke_config(tc.get_config("bert-base"))}


@pytest.mark.parametrize("name,kind", CASES + [
    (t, k) for t in sorted(TEXT) for k in ("train", "prefill", "decode")])
def test_dummy_batch_matches_jax(name, kind):
    """Array for array, the JAX package's dummy batch: the same keys,
    shapes, dtypes and values, for the vision models and the text and
    masked-LM ones."""
    cfg = CFGS.get(name) or TEXT[name]
    jb, tb = _batch(cfg, kind, seed=5)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        got = tb[k].numpy()
        want = np.asarray(jb[k])
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("name", sorted(CFGS) + sorted(TEXT))
def test_train_batch_specs_match_jax(name):
    cfg = CFGS.get(name) or TEXT[name]
    want = jax_inputs.train_batch_specs(jax_cfg(cfg), BATCH, 16)
    got = inputs.train_batch_specs(cfg, BATCH, 16)
    assert sorted(got) == sorted(want)
    for k, (shape, dtype) in got.items():
        assert shape == want[k].shape, k
        assert str(dtype).replace("torch.", "") == str(want[k].dtype), k


@pytest.mark.parametrize("modality", ["audio", "vlm"])
def test_audio_and_vlm_inputs_are_refused(modality):
    """Audio and VLM inputs are refused where the JAX package has no path
    for them: the synthetic stream makes tokens only (its train,
    trajectory and autogrow die on the missing key), and the serving
    engine feeds tokens only. Each refusal names that reason; the model's
    own inputs (``dummy_batch``) are served."""
    from repro_torch.data.synthetic import require_token_stream
    from repro_torch.serving.engine import refuse_inputs
    name = {"audio": "hubert-xlarge", "vlm": "qwen2-vl-72b"}[modality]
    cfg = tc.smoke_config(tc.get_config(name))
    with pytest.raises(ValueError, match="synthetic stream"):
        require_token_stream(cfg, "train")
    with pytest.raises(ValueError, match="feeds tokens only"):
        refuse_inputs(cfg)
    b = inputs.dummy_batch(cfg, 2, 8, "train", device="cpu")
    assert sorted(b) == sorted(inputs.train_batch_specs(cfg, 2, 8))
    for c in (TEXT["gpt2"], TEXT["bert"]):
        require_token_stream(c, "train")
        refuse_inputs(c)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_init_params_tree_matches_jax(name):
    """The same tree: a cls token and no token embedding, an untied head
    of one row a class, the stacked layers; every shape and dtype equal."""
    cfg = CFGS[name]
    jp = to_numpy(jax_init_params(jax_cfg(cfg), jax.random.PRNGKey(0)))
    tp = bridge.to_numpy(init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu"))
    assert jax.tree.structure(tp) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert "tok" not in tp["embed"] and tp["embed"]["cls"].shape == (
        cfg.d_model,)
    assert tp["head"].shape == (cfg.d_model, cfg.vocab_size)
    assert sum(x.size for x in jax.tree.leaves(tp)) == cfg.param_count()


def _assert_grads_close(got_torch, want_jax, rel):
    """Per leaf, max |a - b| <= rel * max(max |b|, 1e-3 * the tree's
    largest |b|): the key bias's gradient is 0 in exact arithmetic (softmax
    is shift-invariant for each query) and carries only rounding noise."""
    got, want = bridge.to_numpy(got_torch), to_numpy(want_jax)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    top = max(float(np.abs(b).max()) for b in jax.tree.leaves(want))
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        scale = max(float(np.abs(b).max()), 1e-3 * top)
        err = float(np.abs(a - b).max()) / scale
        assert err <= rel, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_forward_and_cls_loss_with_gradients_match_jax(name):
    """Hidden states of a forward (cls token, patches, learned positions,
    bidirectional attention), the cls loss and its gradient with respect
    to every parameter, through the bridge, ≤ 1e-4 (each gradient leaf
    normalised as :func:`_assert_grads_close` says)."""
    cfg = CFGS[name]
    jp = jax_init_params(jax_cfg(cfg), jax.random.PRNGKey(1))
    tp = bridge.to_torch(to_numpy(jp))
    jb, tb = _batch(cfg, seed=2)
    jh, _, _ = jax_forward(jp, jax_cfg(cfg), jb, mode="train")
    th, _ = forward(tp, cfg, tb, mode="train")
    assert th.shape == (BATCH, cfg.num_patches, cfg.d_model)
    assert_close({"h": th}, {"h": jh}, rel=1e-4)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jax_cfg(cfg), jb), has_aux=True)(jp)
    (tl, _), tg = value_and_grad(lambda p, b: loss_fn(p, cfg, b), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_grads_close(tg, jg, rel=1e-4)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_ligo_grow_matches_jax(pair, use_kernel):
    """One LiGO grow of the pair (K1's route with its plain versions, or
    the min-FLOP contractions) against the JAX package's ``apply_ligo``,
    ≤ 1e-5; the grown tree is the target's."""
    c1, c2, jp, tp, jop, top = pair
    want = jax_apply_ligo(jop, jp, jax_cfg(c1), jax_cfg(c2))
    got = plan_for(c1, c2, tp).apply(top, tp, use_kernel=use_kernel)
    assert_close(got, want, rel=1e-5)
    assert_close(apply_ligo(top, tp, c1, c2, engine="legacy"), want,
                 rel=1e-5)
    shapes = jax.tree.map(np.shape, to_numpy(jax_init_params(
        jax_cfg(c2), jax.random.PRNGKey(0))))
    assert jax.tree.map(np.shape, bridge.to_numpy(got)) == shapes


def _batches(cfg, jax_side, n=3):
    for i in range(n):
        jb, tb = _batch(cfg, seed=10 + i)
        yield jb if jax_side else tb


def test_train_ligo_matches_jax(pair):
    """Three steps of the LiGO phase (SGD with momentum through the
    operator, the target's cls loss on batches of the target's patch
    width) from the same operator and batches:
    each step's loss and the final operator ≤ 1e-4."""
    c1, c2, jp, tp, jop, top = pair
    kw = dict(steps=3, lr=1e-2, momentum=0.9)
    jlig, jlosses = jax_train_ligo(jop, jp, jax_cfg(c1), jax_cfg(c2),
                                   _batches(c2, True), **kw)
    tlig, tlosses = train_ligo(top, tp, c1, c2, _batches(c2, False), **kw)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert_close(tlig, jlig, rel=1e-4)
    # the updates themselves, not only the (identity-like) operator
    assert_close(tree_map(torch.sub, tlig, top),
                 jax.tree.map(jnp.subtract, jlig, jop), rel=1e-4)


def test_grow_runs_the_vision_pipeline(pair):
    """``grow`` with the LiGO method, the moment grow included, on the
    port alone: the grown model's cls loss is finite and the AdamW moments
    come back in the target's tree."""
    from repro_torch.optim import adamw_init
    c1, c2, _, tp, _, _ = pair
    big, info = grow(tp, c1, c2, method="ligo", data_it=_batches(c2, False),
                     ligo_steps=2, opt_state=adamw_init(tp))
    assert len(info["ligo_losses"]) == 2
    with torch.no_grad():
        _, tb = _batch(c2, seed=20)
        loss, _ = loss_fn(big, c2, tb)
    assert np.isfinite(float(loss))
    assert (jax.tree.structure(bridge.to_numpy(info["opt_state"].m))
            == jax.tree.structure(bridge.to_numpy(big)))


def test_ledger_counts_patches_as_tokens(pair, tmp_path):
    """The LiGO phase's ledger records B x (num_patches - 1) tokens a step
    for a vision batch: the JAX package's rule, the leaf with the most
    dimensions (the patches) when there is no ``tokens``."""
    c1, c2, _, tp, _, top = pair
    _, tb = _batch(c1)
    assert batch_geometry(tb) == (BATCH, c1.num_patches - 1)
    jb, _ = _batch(c1)
    leaf = max(jax.tree.leaves(jb), key=lambda x: x.ndim)
    assert batch_geometry(tb) == tuple(leaf.shape[:2])
    led = RunLedger(str(tmp_path / "l.jsonl"))
    train_ligo(top, tp, c1, c2, _batches(c2, False, n=2), steps=2,
               ledger=led)
    led.close()
    steps = [r for r in read_ledger(str(tmp_path / "l.jsonl"))
             if r["type"] == "step"]
    assert len(steps) == 2
    assert all(r["tokens"] == BATCH * (c1.num_patches - 1) for r in steps)
