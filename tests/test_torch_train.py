"""The port's training path against the JAX package's, on the CPU: the loss,
the optimizers and schedules, the train step, and the train entry point.

Inputs are made from numpy seeds (or JAX inits bridged as numpy) and fed to
both packages. Tolerances: loss values ≤ 1e-5 and gradients ≤ 1e-4
(float32, only the summation order differs; gradients pass through longer
chains of sums); optimizer updates and schedules ≤ 1e-6 (elementwise
float32 arithmetic); three train steps: params ≤ 1e-4, loss, grad norm and
lr ≤ 1e-5. All scale-normalised per leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.optim as jo                                      # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.models import init_params as jax_init_params      # noqa: E402
from repro.models.losses import loss_fn as jax_loss_fn       # noqa: E402
from repro.training import make_train_step as jax_make_step  # noqa: E402
from repro_torch import bridge                               # noqa: E402
import repro_torch.optim as to                               # noqa: E402
from repro_torch.configs import TrainConfig                  # noqa: E402
from repro_torch.data import batch_for_step                  # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.launch import train as launch_train         # noqa: E402
from repro_torch.models.losses import grad_cast_bf16, loss_fn  # noqa: E402
from repro_torch.training import (make_eval_step, make_train_step,  # noqa: E402
                                  value_and_grad)
from torch_parity import TINY1, assert_close, jax_cfg, to_numpy  # noqa: E402

MLM = TINY1.scaled(name="gpt2-tiny-mlm", objective="mlm", encoder_only=True,
                   causal=False)


def assert_grads_close(got_torch, want_jax, rel):
    """Gradient trees, per leaf scale-normalised, except that a leaf whose
    gradient is zero in exact arithmetic is held to the tree's largest
    gradient instead: the key bias ``bk`` (softmax is shift-invariant for
    each query), whose computed gradient is rounding noise in both
    packages."""
    got = jax.tree.leaves(bridge.to_numpy(got_torch))
    want = jax.tree.leaves(to_numpy(want_jax))
    top = max(float(np.abs(w).max()) for w in want)
    for a, b in zip(got, want):
        scale = max(float(np.abs(b).max()), 1e-3 * top)
        np.testing.assert_allclose(a / scale, b / scale, atol=rel)


def _batch(cfg, step=0, batch=4, seq=16):
    host = batch_for_step(cfg, step, batch, seq, seed=5)
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.as_tensor(v) for k, v in host.items()})


@pytest.fixture(scope="module")
def tiny_params():
    jp = jax_init_params(jax_cfg(TINY1), jax.random.PRNGKey(0))
    return jp, bridge.to_torch(to_numpy(jp))


@pytest.mark.parametrize("cfg,loss_chunk", [(TINY1, 0), (TINY1, 8), (MLM, 0)],
                         ids=["clm", "clm-chunked", "mlm"])
def test_loss_fn_value_and_grads_match_jax(cfg, loss_chunk):
    jp = jax_init_params(jax_cfg(cfg), jax.random.PRNGKey(1))
    tp = bridge.to_torch(to_numpy(jp))
    jb, tb = _batch(cfg)

    def jloss(p):
        return jax_loss_fn(p, jax_cfg(cfg), jb, loss_chunk=loss_chunk)[0]

    jval, jgrads = jax.value_and_grad(jloss)(jp)
    (tval, metrics), tgrads = value_and_grad(
        lambda p, b: loss_fn(p, cfg, b, loss_chunk=loss_chunk), tp, tb)
    assert float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-5)
    assert_grads_close(tgrads, jgrads, rel=1e-4)


def test_remat_changes_nothing_but_memory(tiny_params):
    _, tp = tiny_params
    _, tb = _batch(TINY1, step=1)
    out = [value_and_grad(lambda p, b: loss_fn(p, TINY1, b, remat=r), tp, tb)
           for r in (False, True)]
    assert float(out[0][0][0]) == float(out[1][0][0])
    assert_close(out[1][1], to_numpy(bridge.to_numpy(out[0][1])), rel=1e-6)


def test_bf16_cotangent_changes_only_the_gradient_dtype_path():
    cfg = TINY1.scaled(dtype="bfloat16")
    jp = jax_init_params(jax_cfg(cfg), jax.random.PRNGKey(3))
    tp = bridge.to_torch(to_numpy(jp))
    _, tb = _batch(cfg, step=2)
    out = [value_and_grad(lambda p, b: loss_fn(p, cfg, b, bf16_cotangent=c),
                          tp, tb) for c in (False, True)]
    assert float(out[0][0][0]) == float(out[1][0][0])
    for a, b in zip(jax.tree.leaves(bridge.to_numpy(out[1][1])),
                    jax.tree.leaves(bridge.to_numpy(out[0][1]))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2 * np.abs(b).max()
                                   + 1e-30)


def test_grad_cast_bf16_is_identity_with_bf16_cotangent():
    x = torch.randn(3, 4).to(torch.bfloat16).requires_grad_(True)
    y = grad_cast_bf16(x)
    assert torch.equal(y, x)
    (y.float() * 3.0).sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert torch.equal(x.grad, torch.full((3, 4), 3.0, dtype=torch.bfloat16))


@pytest.mark.parametrize("name", ["warmup_cosine", "warmup_linear",
                                  "constant"])
def test_schedules_match_jax(name):
    kw = dict(base_lr=3e-4, warmup_steps=4, total_steps=20)
    for step in range(0, 24):
        want = float(jo.SCHEDULES[name](step, **kw))
        got = to.SCHEDULES[name](step, **kw)
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-6 * 3e-4, (step, got, want)


def _opt_trees(seed):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(6, 5).astype(np.float32),
              "stack": {"k": rng.randn(2, 4, 3).astype(np.float32),
                        "scale": rng.randn(2, 4).astype(np.float32)},
              "b": rng.randn(5).astype(np.float32)}
    grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32),
                         params)
    return params, grads


def test_adamw_update_matches_jax():
    params, g1 = _opt_trees(0)
    _, g2 = _opt_trees(1)
    js, ts = jo.adamw_init(params), to.adamw_init(bridge.to_torch(params))
    jp, tp = params, bridge.to_torch(params)
    for g, lr in ((g1, 1e-2), (g2, 3e-3)):
        jp, js = jo.adamw_update(g, js, jp, lr=lr, weight_decay=0.1)
        tp, ts = to.adamw_update(bridge.to_torch(g), ts, tp, lr=lr,
                                 weight_decay=0.1)
    assert ts.count == int(js.count) == 2
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        assert_close(got, want, rel=1e-6)
    mask = to.decay_mask(tp)
    assert mask["w"] and mask["stack"]["k"] and mask["stack"]["scale"]
    assert not mask["b"]


def test_sgd_update_matches_jax():
    params, g = _opt_trees(2)
    jp, js = jo.sgd_update(g, jo.sgd_init(params), params, lr=0.1)
    jp, js = jo.sgd_update(g, js, jp, lr=0.1)
    tp, ts = to.sgd_update(bridge.to_torch(g),
                           to.sgd_init(bridge.to_torch(params)),
                           bridge.to_torch(params), lr=0.1)
    tp, ts = to.sgd_update(bridge.to_torch(g), ts, tp, lr=0.1)
    assert_close(tp, jp, rel=1e-6)
    assert_close(ts.mom, js.mom, rel=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_jax(max_norm):
    _, g = _opt_trees(3)
    jg, jn = jo.clip_by_global_norm(g, max_norm)
    tg, tn = to.clip_by_global_norm(bridge.to_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(to.global_norm(bridge.to_torch(g))),
                               float(jo.global_norm(g)), rtol=1e-6)
    assert_close(tg, jg, rel=1e-6)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_jax(tiny_params, microbatches):
    jp, tp = (dict(t, layers={"attn": dict(t["layers"]["attn"])})
              for t in tiny_params)
    kw = dict(steps=10, warmup_steps=2, lr=1e-3, microbatches=microbatches)
    jstep = jax.jit(jax_make_step(jax_cfg(TINY1), JaxTrainConfig(**kw)))
    tstep = make_train_step(TINY1, TrainConfig(**kw))
    js, ts = jo.adamw_init(jp), to.adamw_init(tp)
    for i in range(3):
        jb, tb = _batch(TINY1, step=i)
        jp, js, jm = jstep(jp, js, jb, jnp.asarray(i))
        tp, ts, tm = tstep(tp, ts, tb, i)
        for key in ("total", "loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-12, err_msg=key)
    assert ts.count == 3
    # bk's exact gradient is 0 (see assert_grads_close), so AdamW turns each
    # package's rounding noise into steps of up to ~lr: hold it to that
    # bound, and every other leaf to the other package
    for bk in (tp["layers"]["attn"].pop("bk"),
               jnp.asarray(jp["layers"]["attn"].pop("bk"))):
        assert float(abs(bk).max()) <= 10 * 1e-3
    assert_close(tp, jp, rel=1e-4)
    assert_grads_close(ts.m, js.m, rel=1e-4)


def test_eval_step_matches_loss(tiny_params):
    _, tp = tiny_params
    _, tb = _batch(TINY1, step=4)
    metrics = make_eval_step(TINY1)(tp, tb)
    assert float(metrics["loss"]) == float(loss_fn(tp, TINY1, tb)[1]["loss"])


def test_train_refuses_to_run_without_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "gpt2-base", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("method", ["ligo", "random"])
def test_train_cpu_smoke(capsys, method):
    res = launch_train.main([
        "--arch", "gpt2-base", "--smoke", "--grow-from", "half", "--method",
        method, "--device", "cpu", "--pretrain-steps", "2", "--ligo-steps",
        "3", "--steps", "3", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "source loss" in out and "tokens/s" in out
    assert res["launches"] == {"ligo_blend_expand_grouped": 0,
                               "ligo_blend_expand_bwd_fused": 0,
                               "flash_attention": 0}
    losses = res["source_losses"] + res["ligo_losses"] + res["train_losses"]
    assert len(losses) == 2 + (3 if method == "ligo" else 0) + 3
    assert all(np.isfinite(losses))
    if method == "ligo":
        assert "LiGO phase" in out and len(res["ligo_step_ms"]) == 3
    cfg = res["cfg"]
    assert res["params"]["layers"]["attn"]["wq"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.d_head)
    assert res["train_ms"] > 0 and res["tok_s"] > 0
    assert ops.launch_counts()["ligo_blend_expand_bwd_fused"] == 0
