"""The JAX registry's dense-family architectures in the port, at smoke size:
llama3-8b, phi4-mini-3.8b, starcoder2-7b and deepseek-coder-33b.

For each: the port's ``smoke_config`` equals the JAX one field by field; JAX
parameters cross through ``bridge.py`` into the port's own tree (SwiGLU's
``w3``, RMS norms with a scale only, LayerNorm biases, phi4-mini's tied
embeddings); prefill logits hold to the JAX ``prefill`` and 8 greedy decode
tokens are identical. Also the serve launcher on llama3-8b's smoke config:
it runs with ``--device cpu`` and raises without it (there is no CUDA here).

Tolerance: float32 logits ≤ 1e-4 scale-normalised, as in
``test_torch_model.py`` (the chunked attention sums in another order than
the JAX one, and the error grows over layers and steps).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jc                                   # noqa: E402
from conftest import assert_trees_close_normalized           # noqa: E402
from repro.models import model as jm                         # noqa: E402
import repro_torch.configs as tc                             # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.launch import serve                         # noqa: E402
from repro_torch.models import model as tm                   # noqa: E402
from torch_parity import to_numpy                            # noqa: E402

ARCHS = ["llama3-8b", "phi4-mini-3.8b", "starcoder2-7b", "deepseek-coder-33b"]
N_GEN = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(port smoke config, JAX smoke config, JAX params, bridged params)."""
    tcfg = tc.smoke_config(tc.get_config(request.param))
    jcfg = jc.smoke_config(jc.get_config(request.param))
    jp = jm.init_params(jcfg, jax.random.PRNGKey(11))
    return tcfg, jcfg, jp, bridge.to_torch(to_numpy(jp))


def _prompts(cfg):
    return np.random.RandomState(12).randint(0, cfg.vocab_size, (3, 10))


def test_smoke_config_equals_jax(arch):
    tcfg, jcfg, _, _ = arch
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()


def test_bridge_carries_the_dense_leaves(arch):
    tcfg, _, jp, tp = arch
    own = tm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)),
                          bridge.to_numpy(tp))
    assert shapes == jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)),
                                  bridge.to_numpy(own))
    attn = tp["layers"]["attn"]
    assert ("w3" in attn["mlp"]) == (tcfg.act == "swiglu")
    assert ("bias" in attn["ln1"]) == (tcfg.norm == "layer")
    assert ("head" in tp) == (not tcfg.tie_embeddings)
    for a, b in zip(jax.tree.leaves(bridge.to_numpy(tp)), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_prefill_logits_match_jax(arch):
    tcfg, jcfg, jp, tp = arch
    prompt = _prompts(tcfg)
    got, _ = tm.prefill(tp, tcfg, {"tokens": torch.from_numpy(prompt)},
                        max_len=prompt.shape[1] + N_GEN)
    want, _ = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                         max_len=prompt.shape[1] + N_GEN)
    assert_trees_close_normalized([got.numpy()], [np.asarray(want)],
                                  rel=1e-4)


def test_greedy_tokens_match_jax(arch):
    tcfg, jcfg, jp, tp = arch
    prompt = _prompts(tcfg)
    max_len = prompt.shape[1] + N_GEN
    logits, state = tm.prefill(tp, tcfg, {"tokens": torch.from_numpy(prompt)},
                               max_len=max_len)
    tok = torch.argmax(logits, dim=-1)[:, None]
    got = [tok]
    for _ in range(N_GEN - 1):
        logits, state = tm.decode_step(tp, tcfg, state, {"tokens": tok})
        tok = torch.argmax(logits, dim=-1)[:, None]
        got.append(tok)

    jlogits, jstate = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                                 max_len=max_len)
    step = jax.jit(lambda p, s, b: jm.decode_step(p, jcfg, s, b))
    jtok = jnp.argmax(jlogits, axis=-1)[:, None]
    want = [jtok]
    for _ in range(N_GEN - 1):
        jlogits, jstate = step(jp, jstate, {"tokens": jtok})
        jtok = jnp.argmax(jlogits, axis=-1)[:, None]
        want.append(jtok)
    np.testing.assert_array_equal(torch.cat(got, dim=1).numpy(),
                                  np.concatenate(want, axis=1))


def test_serve_launcher_runs_llama3_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama3-8b", "--smoke", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "arch=llama3-8b-smoke" in proc.stdout
    assert "kernel launches: K1 0, K3 0" in proc.stdout
    if not torch.cuda.is_available():       # the default device is "cuda"
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", "llama3-8b", "--smoke"])
