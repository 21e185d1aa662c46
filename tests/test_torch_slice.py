"""The whole serving slice on the CPU, port against JAX: bridged JAX params
and a bridged JAX LiGO operator, grown, prefilled and decoded greedily —
the tokens must be identical. Also the serve entry point: it refuses to run
without CUDA unless ``--device cpu`` is given, and its multi-hop grow is one
composed apply equal to growing hop by hop."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import init_ligo_params as jax_init_ligo     # noqa: E402
from repro.core.plan import plan_for as jax_plan_for         # noqa: E402
from repro.data import gen_tokens as jax_gen_tokens          # noqa: E402
from repro.models import model as jm                         # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.configs import get_config, grow_target, smoke_config  # noqa: E402
from repro_torch.core import apply_ligo, init_ligo_params, plan_for  # noqa: E402
from repro_torch.data import gen_tokens                      # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.launch import serve                         # noqa: E402
from repro_torch.models import model as tm                   # noqa: E402
from torch_parity import (TINY1, TINY2, assert_close, jax_cfg,  # noqa: E402
                          to_numpy)

N_GEN = 8


def _jax_slice(jp, jop, prompts):
    j1, j2 = jax_cfg(TINY1), jax_cfg(TINY2)
    grown = jax_plan_for(j1, j2, jp).executor(mesh=None)(jop, jp)
    max_len = prompts.shape[1] + N_GEN
    logits, state = jm.prefill(grown, j2, {"tokens": jnp.asarray(prompts)},
                               max_len=max_len)
    step = jax.jit(lambda p, s, b: jm.decode_step(p, j2, s, b))
    tok = jnp.argmax(logits, axis=-1)[:, None]
    out = [tok]
    for _ in range(N_GEN - 1):
        logits, state = step(grown, state, {"tokens": tok})
        tok = jnp.argmax(logits, axis=-1)[:, None]
        out.append(tok)
    return grown, np.asarray(jnp.concatenate(out, axis=1))


def _port_slice(tp, top, prompts):
    grown = plan_for(TINY1, TINY2, tp).apply(top, tp)
    max_len = prompts.shape[1] + N_GEN
    logits, state = tm.prefill(grown, TINY2,
                               {"tokens": torch.from_numpy(prompts)},
                               max_len=max_len)
    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [tok]
    for _ in range(N_GEN - 1):
        logits, state = tm.decode_step(grown, TINY2, state, {"tokens": tok})
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    return grown, torch.cat(out, dim=1).numpy()


def test_whole_slice_greedy_tokens_identical_to_jax():
    jp = jm.init_params(jax_cfg(TINY1), jax.random.PRNGKey(0))
    jop = jax_init_ligo(jax.random.PRNGKey(1), jax_cfg(TINY1), jax_cfg(TINY2))
    prompts = gen_tokens(0, 0, 4, 12, TINY1.vocab_size)[:, :12]
    np.testing.assert_array_equal(
        prompts, jax_gen_tokens(0, 0, 4, 12, TINY1.vocab_size)[:, :12])
    jgrown, jtoks = _jax_slice(jp, jop, prompts)
    tgrown, ttoks = _port_slice(bridge.to_torch(to_numpy(jp)),
                                bridge.to_torch(to_numpy(jop)), prompts)
    assert_close(tgrown, jgrown, rel=1e-5)
    assert ttoks.shape == (4, N_GEN)
    np.testing.assert_array_equal(ttoks, jtoks)


def test_serve_refuses_to_run_without_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "gpt2-base", "--smoke", "--batch", "1",
                    "--prompt-len", "4", "--gen", "2"])


def test_serve_cpu_hot_grow_smoke(capsys):
    ops.reset_launch_counts()
    res = serve.main(["--arch", "gpt2-base", "--smoke", "--grow-to", "2x",
                      "--batch", "2", "--prompt-len", "8", "--gen", "4",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "hot-grew gpt2-base-smoke -> gpt2-base-smoke-grown" in out
    assert "tok/s" in out
    cfg = res["cfg"]
    assert cfg == grow_target(smoke_config(get_config("gpt2-base")))
    assert res["k1_launches"] == 0           # CPU: the plain version ran
    assert tuple(res["tokens"].shape) == (2, 4)
    assert bool(torch.isfinite(res["prefill_logits"]).all())
    assert bool(torch.isfinite(res["decode_logits"]).all())
    assert int(res["tokens"].max()) < cfg.vocab_size
    # the grown tree is the legacy walk of the same operator
    want = apply_ligo(res["ligo"], res["small"], res["small_cfg"], cfg,
                      engine="legacy")
    assert_close(res["params"], to_numpy(bridge.to_numpy(want)), rel=1e-5)


def test_hot_grow_multihop_is_one_composed_apply(capsys):
    cfg = smoke_config(get_config("gpt2-base"))
    params = tm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    grown, cfg2, info = serve.hot_grow(params, cfg, "2x,4x", smoke=True,
                                       seed=1, device="cpu")
    assert "via 2 composed hops (one plan apply)" in capsys.readouterr().out
    mid_cfg = grow_target(cfg)
    assert cfg2 == grow_target(mid_cfg)
    op1 = init_ligo_params(torch.Generator().manual_seed(1), cfg, mid_cfg,
                           device="cpu")
    op2 = init_ligo_params(torch.Generator().manual_seed(2), mid_cfg, cfg2,
                           device="cpu")
    mid = apply_ligo(op1, params, cfg, mid_cfg)
    want = apply_ligo(op2, mid, mid_cfg, cfg2)
    assert_close(grown, to_numpy(bridge.to_numpy(want)), rel=2e-5)


def test_bridge_carries_bf16_bit_for_bit_and_casts_on_request():
    jp = jm.init_params(jax_cfg(TINY1.scaled(dtype="bfloat16")),
                        jax.random.PRNGKey(2))
    tp = bridge.to_torch(to_numpy(jp))
    wq = tp["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    back = bridge.to_numpy(tp)          # bf16 comes back as exact float32
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b.astype(jnp.float32)))
    tree = {"w": np.linspace(-1, 1, 7, dtype=np.float32),
            "ids": np.arange(3, dtype=np.int32)}
    cast = bridge.to_torch(tree, dtype=torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16 and cast["ids"].dtype == torch.int32
    assert torch.equal(cast["w"], torch.from_numpy(tree["w"]).bfloat16())
