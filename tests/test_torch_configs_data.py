"""Port configs and synthetic data against the JAX package: every registry
entry and every derived config equal field by field, token streams bit-equal."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.configs as jc                                   # noqa: E402
from repro.data import synthetic as jsyn                     # noqa: E402
import repro_torch.configs as tc                             # noqa: E402
from repro_torch.data import synthetic as tsyn               # noqa: E402

NAMES = sorted(tc.REGISTRY)


DENSE = {n for n, c in jc.ASSIGNED.items() if c.family == "dense"}
MOE = {n for n, c in jc.ASSIGNED.items() if c.family == "moe"}
SEQMIX = {n for n, c in jc.ASSIGNED.items() if c.family in ("ssm", "hybrid")}
OTHER = {n for n, c in jc.ASSIGNED.items() if c.family in ("audio", "vlm")}


def test_registry_is_the_paper_models():
    """The paper models and every one of the JAX registry's assigned
    architectures: the dense, MoE, xLSTM and hybrid families, the audio
    encoder and the VLM."""
    assert DENSE == {"llama3-8b", "phi4-mini-3.8b", "starcoder2-7b",
                     "deepseek-coder-33b"}
    assert MOE == {"mixtral-8x7b", "qwen3-moe-30b-a3b"}
    assert SEQMIX == {"xlstm-125m", "zamba2-2.7b"}
    assert OTHER == {"hubert-xlarge", "qwen2-vl-72b"}
    assert set(tc.ASSIGNED) == set(jc.ASSIGNED) == DENSE | MOE | SEQMIX | OTHER
    assert list(tc.ASSIGNED) == list(jc.ASSIGNED)
    assert set(tc.REGISTRY) == set(jc.REGISTRY)
    assert sorted(tc.GROWTH_PAIRS) == sorted(jc.GROWTH_PAIRS)
    for key, (a, b) in tc.GROWTH_PAIRS.items():
        ja, jb = jc.GROWTH_PAIRS[key]
        assert (a.name, b.name) == (ja.name, jb.name)


@pytest.mark.parametrize("derive", ["identity", "smoke_config", "grow_target",
                                    "half_config"])
@pytest.mark.parametrize("name", NAMES)
def test_config_fields_equal(name, derive):
    t, j = tc.get_config(name), jc.get_config(name)
    if derive != "identity":
        t, j = getattr(tc, derive)(t), getattr(jc, derive)(j)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.blocks == j.blocks
    assert t.param_count() == j.param_count()
    assert t.config_hash() == j.config_hash()


@pytest.mark.parametrize("seed,step,batch,seq,vocab,offset", [
    (0, 0, 4, 33, 256, 0), (7, 123, 3, 17, 50257, 5), (2**31 - 1, 9, 2, 8, 97, 0)])
def test_gen_tokens_bit_equal(seed, step, batch, seq, vocab, offset):
    a = tsyn.gen_tokens(seed, step, batch, seq, vocab, row_offset=offset)
    b = jsyn.gen_tokens(seed, step, batch, seq, vocab, row_offset=offset)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", ["gpt2-base", "bert-small"])
def test_batch_for_step_and_optimal_loss_equal(name):
    tcfg, jcfg = tc.get_config(name), jc.get_config(name)
    a = tsyn.batch_for_step(tcfg, 3, 2, 16, seed=4)
    b = jsyn.batch_for_step(jcfg, 3, 2, 16, seed=4)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert tsyn.optimal_loss(tcfg.vocab_size) == jsyn.optimal_loss(
        jcfg.vocab_size)
