"""The reference against the program, the control against the reference,
and runs with the program broken underneath, each at smoke size on the
CPU (the program takes its kernels' plain versions there).

- An unbroken run in float32, weight decay on as the cells configure it,
  has its program and reference agreeing to rounding, in both families
  and both entries, on every leaf on which the program's rule of which
  leaves decay agrees with the reference's.
- On the other leaves, the stacked (L, d) norm scales and biases, the
  program decays what AdamW leaves alone (``optim/adamw.py::decay_mask``
  takes every leaf of two dimensions, against its docstring): that test
  is marked as the program's known fault, and passes once it is mended.
- The control, the reference in float8 in the program's place at the
  configuration's bfloat16, fails the cell's limits.
- A run whose step returns its state unchanged, or leaves out half of
  every batch, comes out not correct.

The module runs torch on one thread (set back afterwards): the suite's
parallel workers would otherwise oversubscribe the cores many times.
"""
import importlib
import json
import statistics
import time

import pytest
import torch

from perfbench import harness, judge, smoke, weights
from perfbench.reference import common

CELLS = ["gpt2m.ligo", "phi4mini.ligo", "gpt2m.train", "phi4mini.train"]
SEED = 2**31 + 11
CPU = torch.device("cpu")
# float32 limits; LiGO's first gradient is read back from the operator
# after one step, (op0 - op1) / lr: float32 rounding of op1 (entries near
# 1) over lr 1e-3 leaves ~1e-3 of a leaf's norm
AGREE = {"ligo": {"loss": 1e-5, "grad1": 1e-2, "change": 1e-4},
         "train": {"loss": 1e-5, "grad1": 1e-5, "change": 1e-4}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    cell = smoke.cell(name, "bfloat16")
    mod = cell.entry()
    ref = mod.reference(cell, SEED, CPU)
    control = mod.reference(cell, SEED, CPU, precision="fp8")
    ok, compared = judge.verdict(control, ref, cell.workload["limits"], {})
    assert not ok, compared


def _unchanged(monkeypatch, entry):
    if entry == "ligo":
        import repro_torch.training as training
        real = training.value_and_grad

        def no_grad(*a, **k):
            out, grads = real(*a, **k)
            return out, {"width": {n: g * 0 for n, g in grads["width"]
                                   .items()},
                         "depth": {kind: {p: g * 0 for p, g in d.items()}
                                   for kind, d in grads["depth"].items()}}
        monkeypatch.setattr(training, "value_and_grad", no_grad)
    else:
        from repro_torch.training import trainer
        monkeypatch.setattr(trainer, "adamw_update",
                            lambda grads, state, params, **k: (params, state))


def _half_batch(monkeypatch, entry):
    module = importlib.import_module("repro_torch.core.grow"
                                     if entry == "ligo" else
                                     "repro_torch.training.trainer")
    real = module.loss_fn

    def half(params, cfg, batch, **k):
        return real(params, cfg, {n: v[: v.shape[0] // 2]
                                  for n, v in batch.items()}, **k)
    monkeypatch.setattr(module, "loss_fn", half)


def _run(cell):
    class Args:
        workload, seed, seconds, trace = cell.name, SEED, 0.2, 0
    return harness.run(Args, time.perf_counter(), device="cpu", cell=cell)


def _agreeing_run(name, capsys):
    """A float32 run of ``name`` at smoke size, decay as configured: its
    result, the program's and the reference's readings (from the run's
    standard error), and the leaves on which the program's decay rule and
    the reference's differ."""
    entry = harness.load_cell(smoke.bench(), name).workload["entry"]
    cell = smoke.cell(name, "float32", limits=AGREE[entry])
    result = _run(cell)
    line = next(x for x in capsys.readouterr().err.splitlines()
                if x.startswith("perfbench: readings "))
    readings = json.loads(line[len("perfbench: readings "):])
    differ = set()
    if entry == "train":
        from repro_torch.optim.adamw import decay_mask
        params = weights.flatten(weights.params(cell.geom, SEED, CPU))
        program = weights.flatten(decay_mask(weights.unflatten(params)))
        differ = {k for k, p in params.items()
                  if bool(program[k]) != common.decays(k, p)}
    return entry, result, readings["program"], readings["reference"], differ


def _change_gap(got, ref, leaves):
    """The judge's ``change`` over ``leaves`` (of those it compares)."""
    med = statistics.median(ref["grad1"].values())
    gaps = judge.leaf_gaps(got, ref)["change"]
    return max((gaps[k] for k in leaves
                if ref["grad1"][k] >= judge.MOVED * med), default=0.0)


@pytest.mark.parametrize("name", CELLS)
def test_an_unbroken_run_agrees_with_the_reference(name, capsys):
    """Every number within limits of float32 rounding (each tighter than
    the cell's own); the change over the leaves whose decay both sides
    agree on (all, in the LiGO cells)."""
    entry, result, got, ref, differ = _agreeing_run(name, capsys)
    assert list(result)[-1] == "compared"
    assert set(AGREE[entry]) <= set(result["compared"])
    if not differ:
        assert result["correct"] is True, result["compared"]
        return
    for number in ("loss", "grad1"):
        c = result["compared"][number]
        assert c["value"] <= c["limit"], result["compared"]
    agree = set(ref["change"]) - differ
    assert _change_gap(got, ref, agree) <= AGREE[entry]["change"]


@pytest.mark.xfail(reason="the program's fault: optim/adamw.py::decay_mask "
                          "decays the stacked (L, d) norm scales and biases")
@pytest.mark.parametrize("name", ["gpt2m.train", "phi4mini.train"])
def test_the_program_decays_as_the_reference_does(name, capsys):
    entry, result, got, ref, differ = _agreeing_run(name, capsys)
    assert differ
    assert _change_gap(got, ref, differ) <= AGREE[entry]["change"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_run_with_the_program_broken_is_not_correct(name, fault,
                                                      monkeypatch):
    cell = smoke.cell(name, "float32")
    if fault == "unchanged":
        _unchanged(monkeypatch, cell.workload["entry"])
    else:
        _half_batch(monkeypatch, cell.workload["entry"])
    result = _run(cell)
    assert result["correct"] is False, result["compared"]
