"""The port's serving example (``repro_torch.examples.serve_decode``)
against the JAX package's ``examples/serve_decode.py``, model by model:
from the JAX script's own parameters (its ``init_params(cfg,
PRNGKey(0))``, bridged across) and prompts, the port's prefill logits and
every decode step's, teacher-forced on the JAX script's tokens, lie within
1e-4 of the JAX script's (relative to the largest |logit|); the greedy
tokens agree wherever the JAX script's top-two gap exceeds 1e-3, and the
printed cache type is the same. The script's ``main`` runs end to end on
the CPU."""
import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.examples import serve_decode as ts
from repro_torch.models import model as tm

from torch_parity import to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL, GAP = 1e-4, 1e-3


@pytest.fixture(scope="module")
def js():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_decode", os.path.join(REPO, "examples", "serve_decode.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _RecordingJax:
    """The JAX script's ``jax`` module, with ``jit`` recording the logits
    of every call of the jitted prefill and decode step."""

    def __init__(self):
        self.logits = []

    def jit(self, fn):
        jf = jax.jit(fn)

        def run(*args):
            out = jf(*args)
            self.logits.append(np.asarray(out[0]))
            return out
        return run

    def __getattr__(self, name):
        return getattr(jax, name)


def _run_jax_script(js, arch, monkeypatch, capsys):
    """The JAX script's ``serve(arch)`` as it stands; returns (params,
    logits (gen, B, V): the prefill's then each decode step's, the printed
    cache type and sample)."""
    rec, params = _RecordingJax(), {}
    init = js.init_params

    def recording_init(cfg, key):
        params["p"] = init(cfg, key)
        return params["p"]
    monkeypatch.setattr(js, "jax", rec)
    monkeypatch.setattr(js, "init_params", recording_init)
    capsys.readouterr()
    js.serve(arch)
    line = capsys.readouterr().out
    cache = re.search(r"cache=(\w+)", line).group(1)
    sample = [int(t) for t in re.search(r"sample=\[([^\]]*)\]",
                                        line).group(1).split()]
    return params["p"], np.stack(rec.logits), cache, sample


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)
    return top[..., -1] - top[..., -2]


@pytest.mark.parametrize("arch", ts.ARCHS)
def test_serve_matches_the_jax_script(js, arch, monkeypatch, capsys):
    params_j, logits_j, cache_j, sample_j = _run_jax_script(
        js, arch, monkeypatch, capsys)
    toks_j = np.argmax(logits_j, -1).T                     # (B, gen)
    gap_j = _top2_gap(logits_j).T
    params_t = bridge.to_torch(to_numpy(params_j))
    monkeypatch.setattr(ts, "init_params", lambda cfg, gen, device: params_t)
    res = ts.serve(arch, device="cpu")
    assert res["cache"] == cache_j
    B, gen = toks_j.shape
    assert tuple(res["tokens"].shape) == (B, gen)

    # teacher-forced on the JAX script's tokens: the port's prefill and
    # decode steps, the functions the example calls
    cfg = res["cfg"]
    with torch.no_grad():
        lg, state = tm.prefill(params_t, cfg, res["batch"],
                               max_len=res["batch"]["tokens"].shape[1] + gen)
        got = [lg]
        for i in range(gen - 1):
            lg, state = tm.decode_step(
                params_t, cfg, state,
                {"tokens": torch.as_tensor(toks_j[:, i:i + 1])})
            got.append(lg)
    got = torch.stack(got).numpy()
    for i, (g, w) in enumerate(zip(got, logits_j)):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= REL, (arch, i, err)
    clear = gap_j > GAP
    assert clear.mean() > 0.5, (arch, gap_j)
    np.testing.assert_array_equal(np.argmax(got, -1).T[clear], toks_j[clear])

    # the example's own greedy run: JAX's tokens and logits up to the first
    # step whose JAX top-two gap is within the tolerance (past it the two
    # runs may feed different tokens)
    mine = res["tokens"].numpy()
    logits_t = torch.cat([res["prefill_logits"][None],
                          res["decode_logits"]]).numpy()
    for b in range(B):
        n = int(np.argmin(clear[b])) if not clear[b].all() else gen
        np.testing.assert_array_equal(mine[b, :n], toks_j[b, :n])
        for i in range(n):
            err = (np.abs(logits_t[i, b] - logits_j[i, b]).max()
                   / np.abs(logits_j[i, b]).max())
            assert err <= REL, (arch, b, i, err)
    n0 = int(np.argmin(clear[0])) if not clear[0].all() else gen
    assert sample_j[:min(n0, 8)] == mine[0, :min(n0, 8)].tolist()


def test_main_runs_end_to_end_on_the_cpu(capsys):
    out = ts.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert list(out) == list(ts.ARCHS)
    assert {a: r["cache"] for a, r in out.items()} == {
        "llama3-8b": "dict", "mixtral-8x7b": "dict",
        "zamba2-2.7b": "tuple", "xlstm-125m": "tuple"}
    for arch, r in out.items():
        assert tuple(r["tokens"].shape) == (2, 12)
        assert bool(torch.isfinite(r["decode_logits"]).all())
        assert f"{arch:20s} cache={r['cache']}" in printed
    # mixtral's smoke window (32) is shorter than the 48-token prompt: its
    # ring holds the window
    assert out["mixtral-8x7b"]["cfg"].window == 32
    assert out["mixtral-8x7b"]["state"]["caches"]["k"].shape[2] == 32
