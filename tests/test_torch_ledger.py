"""The port's compute ledger (``repro_torch.obs``) against the JAX
package's: the ports of ``tests/test_ledger.py``'s ledger, savings and
trajectory cases, run through the port's runner on the CPU, plus the
cross-package checks — the same record written by both ``RunLedger``s is
the same bytes, and both packages' ``savings_report`` give equal dicts on
the same records.

The contract: an append-only JSONL ledger whose cursor rides checkpoint
meta, so a trajectory killed mid-stage or mid-LiGO-phase and resumed
writes a ledger record for record equal to the uninterrupted run's
(``wall_ms``/``run_id`` masked); and the measured-cost pass
(``FlopCounterMode`` on meta tensors) reconciles with the 6ND model
within [0.5, 2.0] for the train step and the LiGO step.
"""
import os

import pytest

from repro.obs import ledger as jledger
from repro_torch.configs.paper_models import BERT_SMALL
from repro_torch.obs import costs
from repro_torch.obs.ledger import (NONDETERMINISTIC_FIELDS, RunLedger,
                                    active_ledger, attach_ledger,
                                    detach_ledger, normalize_records,
                                    read_ledger, savings_report)
from repro_torch.trajectory import (GrowthSpec, Stage, TrajectoryConfig,
                                    TrajectoryRunner)

# tests/test_trajectory.py's T0 -> T1 -> T2, built from the port's configs
T0 = BERT_SMALL.scaled(name="tr0", n_layers=2, d_model=32, n_heads=4,
                       n_kv_heads=4, d_head=8, d_ff=64, vocab_size=64,
                       max_seq=64, dtype="float32", objective="clm",
                       encoder_only=False, causal=True)
T1 = T0.scaled(name="tr1", n_layers=3, d_model=48, n_heads=6, n_kv_heads=6,
               d_ff=96)
T2 = T1.scaled(name="tr2", n_layers=4, d_model=64, n_heads=8, n_kv_heads=8,
               d_ff=128)

# LiGO phase long enough to checkpoint mid-phase (ligo_fail_at=2 lands on
# the chunk boundary after the first 2-step chunk)
TRAJ_L = TrajectoryConfig(stages=(
    Stage(T0, 5),
    Stage(T1, 5, GrowthSpec(method="ligo", ligo_steps=4, ligo_scan_chunk=2)),
    Stage(T2, 5, GrowthSpec(method="stackbert"))),
    batch=4, seq=16, lr=1e-3, checkpoint_every=3)


def _emit(led, lo, hi):
    for i in range(lo, hi):
        led.record_step(stage=0, arch="a", step=i, loss=4.0 - 0.1 * i,
                        tokens=64.0, wall_ms=1.0 + i,
                        flops_modelled=100.0, flops_measured=90.0)


# ---------------------------------------------------------------------------
# RunLedger durability mechanics
# ---------------------------------------------------------------------------
def test_ledger_snapshot_restore_truncates_to_cursor(tmp_path):
    """Records after the checkpointed cursor — a torn partial line
    included — are dropped on restore, and re-appending the same records
    reproduces the file byte for byte."""
    path = str(tmp_path / "run.jsonl")
    led = RunLedger(path, run_id="r")
    led.restore(None)
    _emit(led, 0, 3)
    cursor = led.snapshot()
    assert cursor["n_records"] == 3
    assert cursor["cum_flops_modelled"] == pytest.approx(300.0)
    assert cursor["cum_flops_measured"] == pytest.approx(270.0)
    _emit(led, 3, 5)                      # post-checkpoint tail
    led.record_event("hop.begin", stage=1, step=5, src="a", dst="b")
    led.close()
    full = open(path, "rb").read()
    with open(path, "ab") as fh:          # torn line from a mid-write kill
        fh.write(b'{"type": "step", "par')
    want = read_ledger(path)[:3]

    led2 = RunLedger(path)
    led2.restore(cursor)
    assert led2.run_id == "r"             # the cursor carries the run id
    assert os.path.getsize(path) == cursor["byte_offset"]
    _emit(led2, 3, 5)                     # deterministic re-execution
    led2.record_event("hop.begin", stage=1, step=5, src="a", dst="b")
    led2.close()
    assert open(path, "rb").read() == full
    recs = read_ledger(path)
    assert len(recs) == 6 and recs[:3] == want
    assert [r["step"] for r in recs] == [0, 1, 2, 3, 4, 5]
    cm = [r["cum_flops_modelled"] for r in recs if r["type"] == "step"]
    assert cm == sorted(cm) and cm[-1] == pytest.approx(500.0)
    norm = normalize_records(recs)
    assert all(f not in r for r in norm for f in NONDETERMINISTIC_FIELDS)


def test_ledger_restore_rejects_missing_bytes(tmp_path):
    path = str(tmp_path / "run.jsonl")
    led = RunLedger(path)
    led.restore(None)
    led.record_step(stage=0, arch="a", step=0, loss=1.0, tokens=1.0,
                    wall_ms=0.0, flops_modelled=1.0)
    cursor = led.snapshot()
    led.close()
    os.truncate(path, cursor["byte_offset"] // 2)
    with pytest.raises(ValueError, match="truncated"):
        RunLedger(path).restore(cursor)


def test_read_ledger_skips_torn_tail(tmp_path):
    path = str(tmp_path / "torn.jsonl")
    with open(path, "w") as fh:
        fh.write('{"type": "step", "step": 0}\n{"type": "st')
    recs = read_ledger(path)
    assert len(recs) == 1 and recs[0]["step"] == 0


def test_attach_ledger_is_exclusive(tmp_path):
    led = attach_ledger(str(tmp_path / "a.jsonl"))
    try:
        assert active_ledger() is led
        with pytest.raises(RuntimeError, match="already attached"):
            attach_ledger(str(tmp_path / "b.jsonl"))
    finally:
        assert detach_ledger() is led
    assert active_ledger() is None


@pytest.mark.parametrize("measured", [False, True])
def test_same_records_same_bytes_in_both_packages(tmp_path, measured):
    """The same steps and events written by both packages' ``RunLedger``s
    give byte-identical files and cursors."""
    paths = []
    for name, cls in (("jax", jledger.RunLedger), ("torch", RunLedger)):
        path = str(tmp_path / f"{name}.jsonl")
        led = cls(path, run_id="same")
        led.restore(None)
        for i in range(3):
            led.record_step(phase="ligo" if i else "train", stage=i,
                            arch="tr1", step=i, loss=4.0 / (i + 1) + 1e-7,
                            tokens=64.0, wall_ms=0.1234567 * i,
                            flops_modelled=6.0e9 + i,
                            flops_measured=5.5e9 if measured else None)
        led.record_event("hop.begin", stage=1, step=3, src="tr0",
                         dst="tr1", method="ligo")
        paths.append((path, led.snapshot()))
        led.close()
    (pj, cj), (pt, ct) = paths
    assert open(pj, "rb").read() == open(pt, "rb").read()
    assert cj == ct


# ---------------------------------------------------------------------------
# savings_report
# ---------------------------------------------------------------------------
def _synthetic_ledger(flops_per_step, losses, *, measured=False):
    led = []
    cum = 0.0
    for i, (f, l) in enumerate(zip(flops_per_step, losses)):
        cum += f
        led.append({"type": "step", "step": i, "stage": 0, "arch": "x",
                    "loss": l, "cum_flops_modelled": cum,
                    "cum_flops_measured": cum * 0.9,
                    "measured": measured})
    return led


def test_savings_report_synthetic():
    run = _synthetic_ledger([1.0] * 5, [5.0, 4.0, 3.0, 2.0, 1.0])
    base = _synthetic_ledger([2.0] * 5, [5.0, 4.0, 3.0, 2.0, 1.0])
    rep = savings_report(3.0, run, baseline=base)
    assert rep["basis"] == "modelled"
    assert rep["run"]["flops"] == pytest.approx(3.0)
    assert rep["baseline"]["flops"] == pytest.approx(6.0)
    assert rep["savings_frac"] == pytest.approx(0.5)
    assert not rep["censored_baseline"]

    # measured basis only when BOTH crossings carry measured numbers
    rep_m = savings_report(
        3.0, _synthetic_ledger([1.0] * 5, [5, 4, 3, 2, 1], measured=True),
        baseline=_synthetic_ledger([2.0] * 5, [5, 4, 3, 2, 1],
                                   measured=True))
    assert rep_m["basis"] == "measured"
    rep_mix = savings_report(
        3.0, _synthetic_ledger([1.0] * 5, [5, 4, 3, 2, 1], measured=True),
        baseline=base)
    assert rep_mix["basis"] == "modelled"

    # baseline that never reaches the target: censored lower bound
    rep_c = savings_report(
        1.0, run, baseline=_synthetic_ledger([2.0] * 3, [5.0, 4.5, 4.0]))
    assert rep_c["censored_baseline"]
    assert not rep_c["baseline"]["reached"]
    assert rep_c["savings_flops"] == pytest.approx(6.0 - 5.0)

    # the run itself must reach the target
    with pytest.raises(ValueError, match="never reached"):
        savings_report(0.5, run, baseline=base)


@pytest.mark.parametrize("target,measured", [(3.0, False), (3.0, True),
                                             (1.0, False), (4.5, True)])
def test_savings_report_equals_the_references(target, measured):
    run = _synthetic_ledger([1.0, 2.0, 1.0, 3.0, 1.0],
                            [5.0, 4.0, 3.0, 2.0, 1.0], measured=measured)
    base = _synthetic_ledger([2.0] * 4, [5.0, 4.5, 3.0, 2.5],
                             measured=measured)
    assert (savings_report(target, run, baseline=base)
            == jledger.savings_report(target, run, baseline=base))


# ---------------------------------------------------------------------------
# The ledger through the port's trajectory runner
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    d = tmp_path_factory.mktemp("ledger_ref")
    path = str(d / "ref.jsonl")
    led = RunLedger(path, run_id="ref")
    res = TrajectoryRunner(TRAJ_L, ckpt_dir=str(d / "ck"), verbose=False,
                           ledger=led, device="cpu").run()
    led.close()
    assert res["status"] == "done"
    keys = ("train_step[tr0]", "ligo_step[tr1]", "train_step[tr1]",
            "train_step[tr2]")
    meas = {k: dict(costs.measurement(k)) for k in keys
            if costs.measurement(k) is not None}
    return {"records": read_ledger(path), "measurements": meas,
            "path": path}


def test_ledger_records_cover_the_whole_run(uninterrupted):
    recs = uninterrupted["records"]
    steps = [r for r in recs if r["type"] == "step"]
    events = [r for r in recs if r["type"] == "event"]
    assert len(steps) == 15 + 4           # 3x5 train + 4 LiGO-phase steps
    assert {r["phase"] for r in steps} == {"train", "ligo"}
    assert [r["arch"] for r in steps if r["phase"] == "train"] \
        == ["tr0"] * 5 + ["tr1"] * 5 + ["tr2"] * 5
    cm = [r["cum_flops_modelled"] for r in steps]
    assert all(b > a for a, b in zip(cm, cm[1:])), "cum FLOPs not monotone"
    cms = [r["cum_flops_measured"] for r in steps]
    assert all(b > a for a, b in zip(cms, cms[1:]))
    assert all(r["measured"] for r in steps)
    names = [e["name"] for e in events]
    assert names.count("hop.begin") == 2 and names.count("hop.complete") == 2
    hops = [e for e in events if e["name"] == "hop.begin"]
    assert (hops[0]["attrs"]["src"], hops[0]["attrs"]["dst"]) == ("tr0",
                                                                  "tr1")
    assert (hops[1]["attrs"]["src"], hops[1]["attrs"]["dst"]) == ("tr1",
                                                                  "tr2")


def test_measured_vs_modelled_reconciles_within_2x(uninterrupted):
    """The measured FLOPs (FlopCounterMode, plain route on the CPU) agree
    with the 6ND model within [0.5, 2.0] for every train step and the
    LiGO step, and feed the ledger's measured column."""
    meas = uninterrupted["measurements"]
    for key in ("train_step[tr0]", "ligo_step[tr1]", "train_step[tr1]",
                "train_step[tr2]"):
        m = meas.get(key)
        assert m is not None, f"no measurement recorded for {key}"
        assert m["flops"] > 0 and m["modelled_flops"] > 0
        assert 0.5 <= m["ratio"] <= 2.0, (key, m["ratio"])
    ligo = [r for r in uninterrupted["records"]
            if r["type"] == "step" and r["phase"] == "ligo"]
    assert all(r["flops_measured"] == meas["ligo_step[tr1]"]["flops"]
               for r in ligo)
    # the CPU route runs the kernels' plain versions: aten counts them all
    assert meas["ligo_step[tr1]"]["flops_kernels"] == 0.0


def test_kill_mid_stage_resumes_record_identical(tmp_path, uninterrupted):
    """Kill at global step 8 (stage 1 step 3), resume: the ledger is
    record for record the uninterrupted run's."""
    path, ck = str(tmp_path / "b.jsonl"), str(tmp_path / "ck")
    lb = RunLedger(path, run_id="b")
    r1 = TrajectoryRunner(TRAJ_L, ckpt_dir=ck, verbose=False, ledger=lb,
                          device="cpu").run(max_steps=8)
    assert r1["status"] == "paused"
    assert (r1["stage"], r1["stage_step"]) == (1, 3)
    lb.close()
    lb2 = RunLedger(path, run_id="b2")    # fresh process: new ledger object
    r2 = TrajectoryRunner(TRAJ_L, ckpt_dir=ck, verbose=False, ledger=lb2,
                          device="cpu").run()
    assert r2["status"] == "done" and r2["resumed_at"] == (1, 3)
    lb2.close()
    assert (normalize_records(uninterrupted["records"])
            == normalize_records(read_ledger(path)))


def test_kill_mid_ligo_phase_resumes_record_identical(tmp_path,
                                                      uninterrupted):
    """The harder kill point: inside the LiGO phase, after its checkpoint at
    step 2 of 4. The resumed phase replays its pre-kill records from the
    checkpointed losses (wall_ms 0) and runs the rest."""
    path, ck = str(tmp_path / "b.jsonl"), str(tmp_path / "ck")
    lb = RunLedger(path, run_id="b")
    with pytest.raises(RuntimeError, match="LiGO"):
        TrajectoryRunner(TRAJ_L, ckpt_dir=ck, verbose=False, ledger=lb,
                         device="cpu", ligo_fail_at=2).run()
    lb.close()
    lb2 = RunLedger(path, run_id="b2")
    r2 = TrajectoryRunner(TRAJ_L, ckpt_dir=ck, verbose=False, ledger=lb2,
                          device="cpu").run()
    assert r2["status"] == "done"
    lb2.close()
    assert (normalize_records(uninterrupted["records"])
            == normalize_records(read_ledger(path)))
    ligo_b = [r for r in read_ledger(path)
              if r["type"] == "step" and r["phase"] == "ligo"]
    assert len(ligo_b) == 4
    assert all(r["wall_ms"] == 0.0 for r in ligo_b[:2])


def test_kernel_route_count_adds_the_kernels_operation_counts(monkeypatch):
    """The measured-cost pass on the kernel route launches nothing, and
    counts exactly K1's and K2's operation counts (their custom operators'
    flop formulas) for every group the plan sends through them, K2 taking
    K1's U and skipping dW where W takes no gradient; its total
    stays within [0.5, 2] of the 6ND model at the reference's CI shape. The
    CPU cannot launch the kernels, so the plan and the K1/K2 entry point are
    made to take the route they take on CUDA inputs; the pass's fake
    tensors never reach a kernel."""
    import torch
    from repro_torch.core import init_ligo_params
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.grow import ligo_loss
    from repro_torch.data import batch_for_step
    from repro_torch.kernels import ligo_expand, ligo_expand_bwd, ops
    from repro_torch.models.model import init_params
    from repro_torch.obs import costs
    from repro_torch.roofline import train_flops_per_step
    from repro_torch.training import to_device, value_and_grad
    calls = []
    vjp, apply = ops.ligo_blend_expand_grouped_vjp, plan_mod.GrowthPlan.apply

    def spy(w, B, W, R=None, **kw):
        calls.append(((*w.shape, W.shape[2], *B.shape, W.shape[4]),
                      None if R is None else R.shape[0], W.requires_grad))
        return vjp(w, B, W, R, use_kernel=True)
    monkeypatch.setattr(ops, "ligo_blend_expand_grouped_vjp", spy)
    monkeypatch.setattr(plan_mod.GrowthPlan, "apply",
                        lambda self, *a, **kw: apply(
                            self, *a, **{**kw, "use_kernel": True}))
    gen = torch.Generator().manual_seed(0)
    small = init_params(T0, gen, device="cpu")
    op = init_ligo_params(gen, T0, T1, device="cpu")
    batch = to_device(batch_for_step(T0, 0, 4, 16), "cpu")

    def step(o, b, sp):
        return value_and_grad(
            lambda oo, bb: (ligo_loss(oo, sp, T0, T1, bb), {}), o, b)
    ops.reset_launch_counts()
    m = costs.measure_step("ligo_step[tr1, kernel route]", step, op, batch,
                           small,
                           modelled_flops=train_flops_per_step(T1, 4, 16))
    assert calls and set(ops.launch_counts().values()) == {0}
    # K2 takes K1's U, and computes dW only where W takes a gradient; a
    # right expansion between K1's U and its blend (width j) splits K1 and
    # K2 into their halves
    want = 0
    for d, j, grad_W in calls:
        if j is None:
            want += (ligo_expand.operation_count(*d)
                     + ligo_expand_bwd.operation_count(*d, u_given=True,
                                                       need_dW=grad_W))
            continue
        dj = d[:6] + (j,)
        want += (ligo_expand.operation_count(*d, stage="expand")
                 + ligo_expand.operation_count(*dj, stage="blend")
                 + ligo_expand_bwd.operation_count(
                     *dj, u_given=True, need_dW=False, need_dB=False)
                 + ligo_expand_bwd.operation_count(
                     *d, q_given=True, need_dW=grad_W, need_dw=False))
    assert any(j is not None for _, j, _ in calls)
    assert m["flops_kernels"] == want > 0 and m["flops_aten"] > 0
    assert 0.5 <= m["ratio"] <= 2.0, m["ratio"]
