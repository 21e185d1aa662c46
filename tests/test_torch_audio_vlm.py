"""The audio and VLM architectures (hubert-xlarge; qwen2-vl-72b with
M-RoPE) in the port against the JAX package, on the CPU, at smoke size
(2 layers, d 64, float32; grown 4 x 96).

Inputs are JAX inits bridged as numpy and ``dummy_batch`` batches drawn
from a numpy seed. The VLM batches carry three distinct position streams
(Qwen2-VL's grid layout: the patches at (t 0, h i // 4, w i % 4), the
text counting on from 4 on all three), so a wrong section split of M-RoPE
shows. Tolerances (float32, scale-normalised per leaf unless said): the
dummy batches, their specs and the bridged trees equal; ``apply_mrope``
≤ 1e-6 in float32 and within one bf16 ulp (2^-8) in bf16; forward hidden
states, losses, their gradients, prefill and decode logits ≤ 1e-4 (a
whole forward and backward in another summation order); a plan grow
≤ 1e-5 (only the order of the sums differs); three ``train_ligo`` steps
≤ 1e-4 per step loss and operator; the launcher's greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jc                                   # noqa: E402
from repro.core import apply_ligo as jax_apply_ligo          # noqa: E402
from repro.core import init_ligo_params as jax_init_ligo     # noqa: E402
from repro.core import train_ligo as jax_train_ligo          # noqa: E402
from repro.core.plan import plan_for as jax_plan_for         # noqa: E402
from repro.models import inputs as jax_inputs                # noqa: E402
from repro.models import model as jmodel                     # noqa: E402
from repro.models.layers import apply_mrope as jax_mrope     # noqa: E402
from repro.models.losses import loss_fn as jax_loss_fn       # noqa: E402
import repro_torch.configs as tc                             # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.core import plan_for, train_ligo            # noqa: E402
from repro_torch.core.grow import batch_geometry             # noqa: E402
from repro_torch.models import inputs, model as tmodel       # noqa: E402
from repro_torch.models.layers import apply_mrope, apply_rope  # noqa: E402
from repro_torch.models.losses import loss_fn                # noqa: E402
from repro_torch.training import value_and_grad             # noqa: E402
from repro_torch.tree import tree_map                        # noqa: E402
from torch_parity import assert_close, jax_cfg, to_numpy     # noqa: E402

NAMES = ("hubert-xlarge", "qwen2-vl-72b")
ARCHS = {n: tc.smoke_config(tc.get_config(n)) for n in NAMES}
QWEN = ARCHS["qwen2-vl-72b"]
BATCH, SEQ = 2, 16
MODEL_TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _both(tree):
    """(JAX arrays, torch tensors) of one numpy batch."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: _t(v) for k, v in tree.items()})


def grid_positions(batch, seq, n_patches, side):
    """Qwen2-VL's layout: patch i at (t 0, h i // side, w i % side), the
    text after it counting on from ``side`` on all three streams."""
    pos = np.zeros((batch, seq, 3), np.int32)
    i = np.arange(n_patches)
    pos[:, :n_patches, 1], pos[:, :n_patches, 2] = i // side, i % side
    pos[:, n_patches:, :] = side + np.arange(seq - n_patches)[None, :, None]
    return pos


def _vlm_batch(cfg, seed, seq=SEQ):
    """A VLM training batch with the grid positions (numpy)."""
    host = {k: to_numpy(v) for k, v in jax_inputs.dummy_batch(
        jax_cfg(cfg), BATCH, seq, "train", seed=seed).items()}
    host["positions"] = grid_positions(BATCH, seq, cfg.num_patches, 4)
    return host


def _train_batch(cfg, seed):
    if cfg.modality == "vlm":
        return _vlm_batch(cfg, seed)
    return {k: to_numpy(v) for k, v in jax_inputs.dummy_batch(
        jax_cfg(cfg), BATCH, SEQ, "train", seed=seed).items()}


@pytest.fixture(scope="module")
def models():
    """Each arch's JAX params and their bridged copy."""
    return {n: (jp, bridge.to_torch(to_numpy(jp))) for n, jp in (
        (n, jmodel.init_params(jax_cfg(c), jax.random.PRNGKey(0)))
        for n, c in ARCHS.items())}


# ---------------------------------------------------------------------------
# Configs and inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_configs_match_the_reference(name):
    """The registry entry and its smoke, grow and half configs equal the
    JAX package's, field for field (M-RoPE sections included); the audio
    model counts a mask embedding and no token embedding."""
    ours, theirs = tc.get_config(name), jc.get_config(name)
    assert name in tc.list_archs()
    for a, b in ((ours, theirs),
                 (tc.smoke_config(ours), jc.smoke_config(theirs)),
                 (tc.half_config(ours), jc.half_config(theirs)),
                 (tc.grow_target(tc.smoke_config(ours)),
                  jc.grow_target(jc.smoke_config(theirs)))):
        assert a.config_hash() == b.config_hash()
        assert a.param_count() == b.param_count()
    if name == "qwen2-vl-72b":
        assert tc.smoke_config(ours).mrope_sections == (2, 3, 3)
        g = tc.grow_target(tc.smoke_config(ours))
        assert (g.mrope_sections, g.d_head) == ((3, 4, 5), 24)
        h = tc.half_config(ours)
        assert (h.mrope_sections, h.d_head) == ((8, 12, 12), 64)
    else:
        D, V = ours.d_model, ours.vocab_size
        no_audio = ours.scaled(modality="text")
        # the audio tree: + mask_emb (D), - tok (V x D)
        assert ours.param_count() == no_audio.param_count() + D - V * D


CASES = [(n, k) for n in NAMES for k in ("train", "prefill", "decode")]


@pytest.mark.parametrize("name,kind", CASES)
def test_dummy_batch_matches_jax(name, kind):
    """Array for array, the JAX package's dummy batch: the same keys,
    shapes, dtypes and values (audio: frames, mask, labels, kept in a
    prefill batch; VLM: tokens, targets, patch embeddings, positions)."""
    cfg = ARCHS[name]
    jb = jax_inputs.dummy_batch(jax_cfg(cfg), BATCH, SEQ, kind, seed=5)
    tb = inputs.dummy_batch(cfg, BATCH, SEQ, kind, seed=5, device="cpu")
    assert sorted(jb) == sorted(tb)
    for k in jb:
        got, want = tb[k].numpy(), np.asarray(jb[k])
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    if name == "hubert-xlarge" and kind != "decode":
        assert "labels" in tb
    # the ledger's geometry: the frames' (B, T) where there is no tokens
    if kind == "train":
        assert batch_geometry(tb) == (BATCH, SEQ)


@pytest.mark.parametrize("name,kind", CASES)
def test_batch_specs_match_jax(name, kind):
    cfg = ARCHS[name]
    if kind == "decode":
        want = jax_inputs.decode_batch_specs(jax_cfg(cfg), BATCH)
        got = inputs.decode_batch_specs(cfg, BATCH)
    else:
        fn = f"{kind}_batch_specs"
        want = getattr(jax_inputs, fn)(jax_cfg(cfg), BATCH, SEQ)
        got = getattr(inputs, fn)(cfg, BATCH, SEQ)
    assert sorted(got) == sorted(want)
    for k, (shape, dtype) in got.items():
        assert shape == want[k].shape, k
        assert str(dtype).replace("torch.", "") == str(want[k].dtype), k


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,sections", [(128, (16, 24, 24)),
                                         (16, (2, 3, 3))])
def test_apply_mrope_matches_jax(dh, sections, dtype):
    """Three distinct position streams, qwen2-vl's theta: ≤ 1e-6 in
    float32 (the sin and cos of two libraries), within one bf16 ulp in
    bf16. A split other than ``sections`` gives another result."""
    rng = np.random.RandomState(dh)
    x = rng.randn(2, 40, 3, dh).astype(np.float32)
    pos = np.stack([rng.randint(0, 5, (2, 40)), rng.randint(0, 300, (2, 40)),
                    rng.randint(0, 2000, (2, 40))], -1).astype(np.int32)
    theta = QWEN.rope_theta
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = _t(x).to(getattr(torch, dtype))
    want = np.asarray(jax_mrope(jx, jnp.asarray(pos), theta, sections)
                      .astype(jnp.float32))
    got_t = apply_mrope(tx, _t(pos), theta, sections)
    assert got_t.dtype == tx.dtype and got_t.shape == tx.shape
    got = got_t.float().numpy()
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    assert np.abs(got - want).max() / np.abs(want).max() <= tol
    other = (sections[1], sections[0], sections[2])
    moved = apply_mrope(tx, _t(pos), theta, other).float().numpy()
    assert np.abs(moved - want).max() / np.abs(want).max() > 1e-2
    # equal streams make it plain RoPE
    same = np.repeat(pos[..., :1], 3, -1)
    np.testing.assert_allclose(
        apply_mrope(_t(x), _t(same), theta, sections).numpy(),
        apply_rope(_t(x), _t(same[..., 0]), theta).numpy(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_through_the_bridge(name, dtype):
    """The port's tree is the JAX package's (the audio model: a mask
    embedding, no token embedding, an untied head; the VLM: the dense
    tree), leaf for leaf in shape and dtype; a JAX tree crosses the bridge
    and back bit for bit (bf16 bit for bit through ``ml_dtypes``)."""
    cfg = ARCHS[name].scaled(dtype=dtype)
    jp = jmodel.init_params(jax_cfg(cfg), jax.random.PRNGKey(0))
    tp = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert (jax.tree.structure(bridge.to_numpy(tp))
            == jax.tree.structure(to_numpy(jp)))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
    assert sum(x.numel() for x in jax.tree.leaves(tp)) == cfg.param_count()
    if name == "hubert-xlarge":
        assert sorted(tp["embed"]) == ["mask_emb"] and "head" in tp
    else:
        assert sorted(tp["embed"]) == ["tok"] and "head" in tp
    back = bridge.to_numpy(bridge.to_torch(to_numpy(jp)))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(to_numpy(jp))):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def _assert_grads_close(got_torch, want_jax, rel):
    """Per leaf, max |a - b| <= rel * max(max |b|, 1e-3 * the tree's
    largest |b|): a leaf whose gradient is 0 in exact arithmetic (the key
    bias: softmax is shift-invariant for each query) carries only rounding
    noise."""
    got, want = bridge.to_numpy(got_torch), to_numpy(want_jax)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    top = max(float(np.abs(b).max()) for b in jax.tree.leaves(want))
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        scale = max(float(np.abs(b).max()), 1e-3 * top)
        err = float(np.abs(a - b).max()) / scale
        assert err <= rel, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("name", NAMES)
def test_forward_loss_and_gradients_match_jax(models, name):
    """hubert: the MLM loss over masked frames, ``mask_emb`` in their
    place, bidirectional attention; qwen2-vl: the CLM loss with patch
    embeddings and grid positions. Hidden states, the loss (rtol 1e-5) and
    its gradient with respect to every parameter ≤ 1e-4."""
    cfg = ARCHS[name]
    jp, tp = models[name]
    jb, tb = _both(_train_batch(cfg, 2))
    if name == "hubert-xlarge":
        assert tb["mask"].any() and not tb["mask"].all()
    jh, _, _ = jmodel.forward(jp, jax_cfg(cfg), jb, mode="train")
    th, _ = tmodel.forward(tp, cfg, tb, mode="train")
    assert th.shape == (BATCH, SEQ, cfg.d_model)
    assert_close({"h": th}, {"h": jh}, rel=MODEL_TOL)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jax_cfg(cfg), jb), has_aux=True)(jp)
    (tl, _), tg = value_and_grad(lambda p, b: loss_fn(p, cfg, b), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_grads_close(tg, jg, rel=MODEL_TOL)
    if name == "hubert-xlarge":
        # the masked frames' loss reaches mask_emb, and only through them
        assert float(tg["embed"]["mask_emb"].abs().max()) > 0


def test_prefill_and_decode_with_positions_match_jax(models):
    """qwen2-vl with distinct position streams: ``prefill(T - 1)`` and one
    ``decode_step`` (its positions from the batch, its cache row from the
    state) against the JAX package's (logits and caches ≤ 1e-4), and both
    against one full forward at positions T - 2 and T - 1 (atol 2e-4, the
    twin of tests/test_models.py::test_incremental_decode_consistency);
    three more decode steps with positions against the JAX package's."""
    cfg = QWEN
    jc_ = jax_cfg(cfg)
    jp, tp = models["qwen2-vl-72b"]
    T = 33
    host = _vlm_batch(cfg, 3, seq=T)
    fwd = {k: v for k, v in host.items() if k != "targets"}
    jfull, tfull = _both(fwd)
    th, _ = tmodel.forward(tp, cfg, tfull, mode="train")
    full = tmodel.unembed(tp, cfg, th)
    pre = {k: (v[:, :T - 1] if k in ("tokens", "positions") else v)
           for k, v in fwd.items()}
    jpre, tpre = _both(pre)
    jl, jst = jmodel.prefill(jp, jc_, jpre, max_len=T + 4)
    tl, tst = tmodel.prefill(tp, cfg, tpre, max_len=T + 4)
    assert tst["pos"] == T - 1
    assert_close(tl, jl, MODEL_TOL)
    assert_close(tst["caches"], jst["caches"], MODEL_TOL)
    np.testing.assert_allclose(tl.numpy(), full[:, T - 2].numpy(), atol=2e-4)
    step = {"tokens": host["tokens"][:, T - 1:],
            "positions": host["positions"][:, T - 1:]}
    for i in range(4):
        jd, td = _both(step)
        jl, jst = jmodel.decode_step(jp, jc_, jst, jd)
        tl, tst = tmodel.decode_step(tp, cfg, tst, td)
        assert_close(tl, jl, MODEL_TOL)
        assert_close(tst["caches"], jst["caches"], MODEL_TOL)
        if i == 0:
            np.testing.assert_allclose(tl.numpy(), full[:, T - 1].numpy(),
                                       atol=2e-4)
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
        step = {"tokens": nxt,
                "positions": step["positions"] + 1}
    assert tst["pos"] == T + 3


# ---------------------------------------------------------------------------
# Growth
# ---------------------------------------------------------------------------
def _pairs():
    out = []
    for n in NAMES:
        c = ARCHS[n]
        out.append((n, "grow_target", c, tc.grow_target(c)))
        out.append((n, "half", tc.half_config(c), c))
    return out


PAIRS = {f"{n}-{k}": (c1, c2) for n, k, c1, c2 in _pairs()}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_plan_grow_matches_jax(pair):
    """The plan's groups as the JAX package's plan makes them (paths,
    kernel eligibility; hubert's ``embed/mask_emb`` among the top-level
    leaves); the JAX operator applied by the plan on K1's route (its plain
    versions here) and on the plain route against the JAX package's
    ``apply_ligo`` ≤ 1e-5; the grown tree is the target's."""
    c1, c2 = PAIRS[pair]
    jp = jmodel.init_params(jax_cfg(c1), jax.random.PRNGKey(1))
    tp = bridge.to_torch(to_numpy(jp))
    jop = jax_init_ligo(jax.random.PRNGKey(3), jax_cfg(c1), jax_cfg(c2))
    top = bridge.to_torch(to_numpy(jop))
    ours = plan_for(c1, c2, tp)
    theirs = jax_plan_for(jax_cfg(c1), jax_cfg(c2), jp)
    assert ([(g.kind, g.paths, g.kernel_ok) for g in ours.groups]
            == [(g.kind, g.paths, g.kernel_ok) for g in theirs.groups])
    if c1.modality == "audio":
        assert any("embed/mask_emb" in g.paths for g in ours.groups)
    want = jax_apply_ligo(jop, jp, jax_cfg(c1), jax_cfg(c2))
    for use_kernel in (True, False):
        got = ours.apply(top, tp, use_kernel=use_kernel)
        assert_close(got, want, rel=1e-5)
    shapes = jax.tree.map(np.shape, to_numpy(jmodel.init_params(
        jax_cfg(c2), jax.random.PRNGKey(0))))
    assert jax.tree.map(np.shape, bridge.to_numpy(got)) == shapes


def _ligo_batches(cfg, jax_side, n=3):
    """Target-width batches: hubert's frames and qwen2-vl's patch
    embeddings are the target's d_model wide."""
    for i in range(n):
        jb, tb = _both(_train_batch(cfg, 10 + i))
        yield jb if jax_side else tb


@pytest.mark.parametrize("name", NAMES)
def test_train_ligo_three_steps_match_jax(models, name):
    """Three steps of the LiGO phase into ``grow_target`` (SGD with
    momentum through the operator) on batches of the target's width, from
    the same operator: each step's loss and the final operator and its
    update ≤ 1e-4."""
    c1 = ARCHS[name]
    c2 = tc.grow_target(c1)
    jp, tp = models[name]
    jop = jax_init_ligo(jax.random.PRNGKey(3), jax_cfg(c1), jax_cfg(c2))
    top = bridge.to_torch(to_numpy(jop))
    kw = dict(steps=3, lr=1e-2, momentum=0.9)
    jlig, jlosses = jax_train_ligo(jop, jp, jax_cfg(c1), jax_cfg(c2),
                                   _ligo_batches(c2, True), **kw)
    tlig, tlosses = train_ligo(top, tp, c1, c2, _ligo_batches(c2, False),
                               **kw)
    assert len(tlosses) == 3 and all(np.isfinite(tlosses))
    np.testing.assert_allclose(tlosses, jlosses, rtol=MODEL_TOL)
    assert_close(tlig, jlig, rel=MODEL_TOL)
    assert_close(tree_map(torch.sub, tlig, top),
                 jax.tree.map(jnp.subtract, jlig, jop), rel=MODEL_TOL)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
def _jax_launcher_batch(cfg, prompts, prompt_len):
    """The JAX launcher's ``_serve`` batch (src/repro/launch/serve.py),
    rebuilt here with its own expressions."""
    B = prompts.shape[0]
    batch = {"tokens": jnp.asarray(prompts, jnp.int32)}
    if cfg.modality == "vlm":
        P_ = min(cfg.num_patches, prompt_len)
        batch["patch_embeds"] = jnp.zeros((B, P_, cfg.d_model), jnp.float32)
        pos = np.broadcast_to(np.arange(prompt_len)[None, :, None],
                              (B, prompt_len, 3)).copy()
        batch["positions"] = jnp.asarray(pos, jnp.int32)
    return batch


def test_serve_smoke_grow_tokens_match_jax():
    """``serve --arch qwen2-vl-72b --smoke --grow-to 2x`` on the CPU: the
    launcher's prefill batch is the JAX launcher's, array for array, and
    its greedy tokens equal the JAX package's ``prefill`` + ``decode_step``
    of the same grown parameters (bridged) fed the JAX launcher's
    batches, decode step i at position prompt_len + i; the prefill and
    decode logits ≤ 1e-4."""
    from repro_torch.launch import serve
    P, G = 12, 6
    res = serve.main(["--arch", "qwen2-vl-72b", "--smoke", "--grow-to", "2x",
                      "--device", "cpu", "--batch", "2", "--prompt-len",
                      str(P), "--gen", str(G)])
    cfg = res["cfg"]
    assert cfg.name == "qwen2-vl-72b-smoke-grown" and cfg.n_layers == 4
    assert res["launches"]["flash_attention"] == 0
    prompts = res["prompts"].numpy()
    jb = _jax_launcher_batch(jax_cfg(cfg), prompts, P)
    tb = serve.lockstep_batch(cfg, res["prompts"])
    assert sorted(jb) == sorted(tb)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy().astype(np.int64),
                                      np.asarray(jb[k]).astype(np.int64))
        assert str(tb[k].dtype).replace("torch.", "") == str(jb[k].dtype) \
            or k == "tokens"
    jp = jax.tree.map(jnp.asarray, bridge.to_numpy(res["params"]))
    jc_ = jax_cfg(cfg)
    logits, state = jmodel.prefill(jp, jc_, jb, max_len=P + G)
    assert_close({"l": res["prefill_logits"]}, {"l": logits}, MODEL_TOL)
    tokens = jnp.argmax(logits, -1)[:, None]
    out = [tokens]
    for i in range(G - 1):
        db = {"tokens": tokens,
              "positions": jnp.full((2, 1, 3), P + i, jnp.int32)}
        logits, state = jmodel.decode_step(jp, jc_, state, db)
        assert_close({"l": res["decode_logits"][i]}, {"l": logits},
                     MODEL_TOL)
        tokens = jnp.argmax(logits, -1)[:, None]
        out.append(tokens)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.asarray(jnp.concatenate(out, 1)))


# ---------------------------------------------------------------------------
# Refusals where the JAX package has no path
# ---------------------------------------------------------------------------
def test_serve_refuses_the_encoder_only_model():
    """hubert-xlarge has no decode step: the launcher refuses it, as the
    JAX launcher does; the live path refuses a non-token model."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="encoder-only: no decode step"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit, match="not a token model"):
        serve.main(["--arch", "qwen2-vl-72b", "--smoke", "--device", "cpu",
                    "--live-grow-at", "2"])


@pytest.mark.parametrize("name", NAMES)
def test_train_trajectory_autogrow_and_engine_refuse(name, tmp_path):
    """The synthetic stream makes tokens only, in both packages: ``train``,
    the trajectory runner (``train --trajectory`` and ``--autogrow``) and
    the autogrow probe refuse up front, naming it; the engine feeds tokens
    only, as the JAX package's does, and refuses too."""
    import json
    from repro_torch.autogrow import PolicySpec, probe_methods
    from repro_torch.launch import train
    from repro_torch.serving import ServingEngine
    cfg = ARCHS[name]
    with pytest.raises(SystemExit, match="synthetic stream"):
        train.main(["--arch", name, "--smoke", "--device", "cpu",
                    "--steps", "1"])
    sched = tmp_path / "t.json"
    sched.write_text(json.dumps({
        "arch": name, "smoke": True, "batch": 2, "seq": 16,
        "stages": [{"steps": 1}, {"steps": 1, "method": "ligo",
                                  "ligo_steps": 1}]}))
    for flag in ("--trajectory", "--autogrow"):
        with pytest.raises(ValueError, match="synthetic stream"):
            train.main([flag, str(sched), "--ckpt-dir",
                        str(tmp_path / flag.strip("-")), "--device", "cpu"])
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    with pytest.raises(ValueError, match="synthetic stream"):
        probe_methods(params, None, cfg, tc.grow_target(cfg),
                      PolicySpec(kind="probe", probe_candidates=("ligo",)),
                      lr=1e-3, batch=2, seq=8)
    with pytest.raises(ValueError, match="feeds tokens only"):
        ServingEngine(params, cfg, device="cpu")
