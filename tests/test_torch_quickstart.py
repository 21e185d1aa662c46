"""The port's quickstart (``repro_torch.examples.quickstart``) against the
JAX package's ``examples/quickstart.py`` at reduced step counts: from the
same small model (the JAX script's init, bridged across) and the
same starting LiGO operator, the port's LiGO losses and initial
big-model losses match the JAX script's within 1e-4 (f32); and the
script's ``main`` runs end to end on the CPU."""
import importlib
import importlib.util
import math
import os

import jax
import numpy as np
import pytest

from repro_torch import bridge
from repro_torch.examples import quickstart as tq

from torch_parity import to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jq():
    spec = importlib.util.spec_from_file_location(
        "jax_quickstart", os.path.join(REPO, "examples", "quickstart.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_configs_are_the_scripts(jq):
    import dataclasses
    for ours, theirs in ((tq.SMALL, jq.SMALL), (tq.BIG, jq.BIG)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (tq.BATCH, tq.SEQ) == (jq.BATCH, jq.SEQ)


def test_ligo_and_initial_losses_match_the_jax_script(jq, monkeypatch):
    from repro.core import grow as jgrow
    from repro.core import init_ligo_params as jinit
    small_j = jq.init_params(jq.SMALL, jax.random.PRNGKey(0))
    small_t = bridge.to_torch(to_numpy(small_j))
    steps = 3

    # the JAX script's step 2, at reduced steps
    inits_j = {"scratch": jq.init_params(jq.BIG, jax.random.PRNGKey(1))}
    inits_j["stackbert"], _ = jgrow(small_j, jq.SMALL, jq.BIG,
                                    method="bert2bert",
                                    key=jax.random.PRNGKey(2))
    inits_j["ligo"], info = jgrow(small_j, jq.SMALL, jq.BIG, method="ligo",
                                  key=jax.random.PRNGKey(3),
                                  data_it=jq.batches(jq.SMALL, 500_000),
                                  ligo_steps=steps, ligo_lr=3e-3)
    # the port's, from the JAX script's starting operator (the two
    # packages draw random operators differently)
    op0 = bridge.to_torch(to_numpy(jinit(jax.random.PRNGKey(3), jq.SMALL,
                                         jq.BIG)))
    monkeypatch.setattr(importlib.import_module("repro_torch.core.grow"),
                        "init_ligo_params",
                        lambda *a, **k: op0)
    inits_t, ligo_losses = tq.grown_inits(small_t, "cpu", steps)
    np.testing.assert_allclose(ligo_losses, info["ligo_losses"], rtol=1e-4)

    # step 3: the initial big-model losses; the port's own LiGO grow, and
    # the JAX script's scratch and stackbert inits bridged across (random
    # draws differ between the packages)
    got = {"ligo": tq.eval_loss(tq.BIG, inits_t["ligo"], "cpu")}
    for name in ("scratch", "stackbert"):
        got[name] = tq.eval_loss(
            tq.BIG, bridge.to_torch(to_numpy(inits_j[name])), "cpu")
    for name, p in inits_j.items():
        np.testing.assert_allclose(got[name], jq.eval_loss(jq.BIG, p),
                                   rtol=1e-4, err_msg=name)


def test_main_runs_end_to_end_on_the_cpu():
    out = tq.main(["--device", "cpu", "--small-steps", "2", "--ligo-steps",
                   "2", "--finetune-steps", "1"])
    assert len(out["ligo_losses"]) == 2
    assert set(out["initial"]) == set(out["finetuned"]) \
        == {"scratch", "stackbert", "ligo"}
    values = [out["small_loss"], *out["ligo_losses"],
              *out["initial"].values(), *out["finetuned"].values()]
    assert all(math.isfinite(v) for v in values)
