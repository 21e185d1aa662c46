"""The port's dense model against the JAX package's on bridged weights:
layers, the parameter tree, training-mode forward, prefill and teacher-forced
decode.

Tolerance: f32, ≤ 1e-4 scale-normalised (the chunked attention sums in
another order than the JAX one, and the error grows over layers and steps);
single layers hold ≤ 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import assert_trees_close_normalized           # noqa: E402
from repro.models import layers as jl                        # noqa: E402
from repro.models import model as jm                         # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.models import layers as tl                  # noqa: E402
from repro_torch.models import model as tm                   # noqa: E402
from torch_parity import TINY1, TINY2, jax_cfg, to_numpy     # noqa: E402


def _close(got, want, rel):
    assert_trees_close_normalized([got.detach().float().numpy()],
                                  [np.asarray(want, np.float32)], rel=rel)


@pytest.fixture(scope="module")
def weights():
    """JAX params for TINY2 (the grown shape) and the bridged torch copy."""
    jp = jm.init_params(jax_cfg(TINY2), jax.random.PRNGKey(5))
    return jp, bridge.to_torch(to_numpy(jp))


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_apply_norm(kind):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 32).astype(np.float32) * 3 + 1
    p = {"scale": rng.randn(32).astype(np.float32),
         "bias": rng.randn(32).astype(np.float32)}
    got = tl.apply_norm(bridge.to_torch(p), torch.from_numpy(x), kind)
    _close(got, jl.apply_norm(p, jnp.asarray(x), kind), 1e-5)


def test_apply_rope():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    pos = np.arange(7)[None] + np.array([[0], [5]])
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    _close(got, jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0), 1e-5)


@pytest.mark.parametrize("causal,window,chunk", [
    (True, 0, 2048), (True, 0, 4), (False, 0, 8), (True, 3, 4)])
def test_chunked_attention(causal, window, chunk):
    rng = np.random.RandomState(2)
    q = rng.randn(2, 11, 4, 8).astype(np.float32)
    k = rng.randn(2, 11, 2, 8).astype(np.float32)
    v = rng.randn(2, 11, 2, 8).astype(np.float32)
    got = tl.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                       window=window, chunk_q=chunk, chunk_k=chunk)
    want = jl.attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                        window=window, chunk_q=chunk, chunk_k=chunk)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("window,ring", [(0, False), (3, False), (6, True)])
def test_decode_attention(window, ring):
    rng = np.random.RandomState(3)
    q = rng.randn(2, 1, 4, 8).astype(np.float32)
    kc = rng.randn(2, 6, 2, 8).astype(np.float32)
    vc = rng.randn(2, 6, 2, 8).astype(np.float32)
    got = tl.decode_attention(*map(torch.from_numpy, (q, kc, vc)), 5,
                              window=window, ring=ring)
    want = jl.decode_attention(*map(jnp.asarray, (q, kc, vc)), jnp.int32(5),
                               window=window, ring=ring)
    _close(got, want, 1e-5)


def test_mlp_gelu_is_tanh_approximation():
    rng = np.random.RandomState(4)
    p = {"w1": rng.randn(8, 16).astype(np.float32),
         "w2": rng.randn(16, 8).astype(np.float32),
         "b1": rng.randn(16).astype(np.float32),
         "b2": rng.randn(8).astype(np.float32)}
    x = rng.randn(3, 8).astype(np.float32)
    got = tl.apply_mlp(bridge.to_torch(p), torch.from_numpy(x), "gelu")
    _close(got, jl.apply_mlp(p, jnp.asarray(x), "gelu"), 1e-5)


def test_init_params_tree_matches_jax():
    gen = torch.Generator().manual_seed(0)
    got = tm.init_params(TINY2, gen, device="cpu")
    want = jax.eval_shape(lambda: jm.init_params(jax_cfg(TINY2),
                                                 jax.random.PRNGKey(0)))
    got_shapes = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)),
                              bridge.to_numpy(got))
    want_shapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), want)
    assert got_shapes == want_shapes
    # the JAX init scales: 0.02 · N(0,1) truncated at ±3σ (std 0.98658)
    # for embeddings, 1/sqrt(in) for dense weights
    tok = got["embed"]["tok"]
    assert abs(float(tok.std()) - 0.02 * 0.98658) < 5e-4
    wq = got["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) - 0.98658 / TINY2.d_model ** 0.5) < 2e-3
    assert float(tok.abs().max()) <= 0.02 * 3
    if not torch.cuda.is_available():       # the default device is "cuda"
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.init_params(TINY2, gen)


def test_train_forward_matches_jax(weights):
    jp, tp = weights
    toks = np.random.RandomState(6).randint(0, TINY2.vocab_size, (2, 12))
    got, _ = tm.forward(tp, TINY2, {"tokens": torch.from_numpy(toks)})
    want, _, _ = jm.forward(jp, jax_cfg(TINY2), {"tokens": jnp.asarray(toks)})
    _close(got, want, 1e-4)


def test_prefill_and_teacher_forced_decode_match_jax(weights):
    jp, tp = weights
    jcfg = jax_cfg(TINY2)
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, TINY2.vocab_size, (3, 10))
    forced = rng.randint(0, TINY2.vocab_size, (3, 8))
    max_len = 10 + 8
    got, tstate = tm.prefill(tp, TINY2, {"tokens": torch.from_numpy(prompt)},
                             max_len=max_len)
    want, jstate = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                              max_len=max_len)
    _close(got, want, 1e-4)
    assert tuple(tstate["caches"]["k"].shape) == jstate["caches"]["k"].shape
    jstep = jax.jit(lambda p, s, b: jm.decode_step(p, jcfg, s, b))
    for t in range(forced.shape[1]):
        col = forced[:, t:t + 1]
        got, tstate = tm.decode_step(tp, TINY2, tstate,
                                     {"tokens": torch.from_numpy(col)})
        want, jstate = jstep(jp, jstate, {"tokens": jnp.asarray(col)})
        _close(got, want, 1e-4)
    assert tstate["pos"] == int(jstate["pos"]) == max_len
