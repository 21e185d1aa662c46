"""The port's adaptive growth controller (``repro_torch.autogrow``) against
the JAX package's, on the CPU.

- ``Telemetry`` and every policy on identical loss streams: every signal,
  ``should_grow`` and ``why`` equal exactly at every step (both are host
  Python with the same float operations in the same order); snapshots
  restore across packages; the ``autogrow.*`` gauges' Prometheus text is
  the JAX package's.
- The twins of ``tests/test_autogrow.py``'s policy acceptance cases.
- ``PolicySpec`` and auto-stage validation with the JAX messages; an auto
  schedule hashes to the JAX package's value.
- The runner: a ``step_budget`` auto stage equals the static schedule
  bitwise; an auto stage ends before its cap, and a pause and resume
  equals the uninterrupted run bitwise; the cross-package resume — the JAX
  runner pauses one step before its own decision step, and the port's
  runner resumes the directory and fires at the same step (params within
  1e-4, the decision margin asserted against the packages' loss gap).
- ``probe_methods`` against the JAX package's with the JAX draws bridged
  in (scores within rtol 1e-4, the same pick), on the port's own draws,
  and leaving its inputs bit for bit.
- ``train --autogrow`` on ``--device cpu`` with ``--ledger``: the probe
  and ``hop.begin`` records equal to the JAX runner's, the decision lines,
  and the launcher's refusals.

Shapes are ``tests/test_autogrow.py``'s: T0 (2 layers, d 32) -> T1 (3
layers, d 48), batch 4 x 16, float32.
"""
import dataclasses
import json
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.autogrow as jag
import repro.obs as jobs
import repro_torch.autogrow as tag
import repro_torch.obs as tobs
from conftest import assert_trees_close_normalized
from repro import trajectory as jt
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import init_ligo_params as jax_init_ligo
from repro.data import batch_for_step as jax_batch_for_step
from repro.models import init_params as jax_init_params
from repro.obs.ledger import RunLedger as JaxRunLedger
from repro.training import init_train_state as jax_init_train_state
from repro.training import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.checkpoint import flatten_tree
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.paper_models import BERT_SMALL
from repro_torch.data import batch_for_step
from repro_torch.obs.ledger import normalize_records, read_ledger
from repro_torch.roofline import train_flops_per_step
from repro_torch.training import init_train_state, make_train_step, to_device
from repro_torch.trajectory import (GrowthSpec, Stage, TrajectoryConfig,
                                    TrajectoryRunner)
from torch_parity import jax_cfg, to_numpy

T0 = BERT_SMALL.scaled(name="ag0", n_layers=2, d_model=32, n_heads=4,
                       n_kv_heads=4, d_head=8, d_ff=64, vocab_size=64,
                       max_seq=64, dtype="float32", objective="clm",
                       encoder_only=False, causal=True)
T1 = T0.scaled(name="ag1", n_layers=3, d_model=48, n_heads=6, n_kv_heads=6,
               d_ff=96)
T0_DEEP = T0.scaled(name="ag0-deep", n_layers=4)     # width map: identity
T0_WIDE_FF = T0.scaled(name="ag0-ff", d_ff=128)      # LEMON-growable

AUTO_TRAJ = TrajectoryConfig(stages=(
    Stage(T0, 4),
    Stage(T1, None, GrowthSpec(method="ligo", ligo_steps=4,
                               ligo_scan_chunk=2),
          policy=tag.PolicySpec(kind="loss_plateau", max_steps=12,
                                min_steps=2, window=3, tol=5e-3,
                                ema_halflife=2))),
    batch=4, seq=16, checkpoint_every=3)


def _jax_traj(traj):
    """The JAX package's TrajectoryConfig of the same schedule."""
    return jt.TrajectoryConfig(
        stages=tuple(jt.Stage(
            jax_cfg(st.cfg), st.steps,
            None if st.growth is None else jt.GrowthSpec(**vars(st.growth)),
            policy=None if st.policy is None else
            jag.PolicySpec(**dataclasses.asdict(st.policy)))
            for st in traj.stages),
        batch=traj.batch, seq=traj.seq, lr=traj.lr,
        checkpoint_every=traj.checkpoint_every, seed=traj.seed)


def _runner(traj, d, **kw):
    return TrajectoryRunner(traj, ckpt_dir=d, verbose=False, device="cpu",
                            **kw)


def _assert_equal(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def _params_close_to_jax(got, want, lr):
    """Port params vs JAX params within 1e-4, scale-normalised; the key
    bias, whose exact gradient is 0, held to its AdamW noise bound as
    ``tests/test_torch_trajectory.py`` holds it."""
    got_p = bridge.to_numpy(got)
    want_p = jax.tree.map(np.asarray, want)
    for bk in (got_p["layers"]["attn"].pop("bk"),
               want_p["layers"]["attn"].pop("bk")):
        assert float(abs(bk).max()) <= 10 * lr
    assert_trees_close_normalized(got_p, want_p, rel=1e-4)


# ---------------------------------------------------------------------------
# (a) Telemetry and the policies on identical streams
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_run_losses():
    """The losses of a real JAX training run of T0 (30 steps)."""
    params, opt = jax_init_train_state(jax_cfg(T0), jax.random.PRNGKey(0))
    step = jax.jit(jax_make_train_step(
        jax_cfg(T0), JaxTrainConfig(steps=30, warmup_steps=2, lr=1e-3)))
    out = []
    for i in range(30):
        b = {k: jnp.asarray(v) for k, v in
             jax_batch_for_step(jax_cfg(T0), i, 4, 16, seed=0).items()}
        params, opt, m = step(params, opt, b, jnp.asarray(i))
        out.append(float(m["total"]))
    return out


def _stream(name, losses):
    if name == "decay":
        return [1.0 + math.exp(-t / 15.0) for t in range(120)]
    if name == "linear":
        return [10.0 - 1e-3 * t for t in range(120)]
    return list(losses)


SPECS = {
    "step_budget": dict(kind="step_budget", max_steps=20),
    "loss_plateau": dict(kind="loss_plateau", max_steps=10_000, min_steps=10,
                         window=8, tol=2e-3, ema_halflife=8),
    "rpf_decay": dict(kind="rpf_decay", max_steps=10_000, min_steps=10,
                      window=8, decay=0.25),
    "probe": dict(kind="probe", max_steps=100, min_steps=5, window=6,
                  tol=5e-3, ema_halflife=3, probe_candidates=("ligo",)),
}


def _signals(tele):
    return (tele.improvement(), tele.rpf(), tele.rpf_decay(), tele.peak_rpf,
            tele.loss_ema, tele.last_loss, tele.cum_flops, tele.cum_tokens,
            tele.total_steps, len(tele), tele.full)


@pytest.mark.parametrize("fps", [0.0, 1.5e9], ids=["step_axis",
                                                   "flops_axis"])
@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("stream", ["decay", "linear", "jax_run"])
def test_telemetry_and_policy_equal_jax_on_identical_streams(
        stream, kind, fps, jax_run_losses):
    jpol = jag.make_policy(jag.PolicySpec(**SPECS[kind]))
    tpol = tag.make_policy(tag.PolicySpec(**SPECS[kind]))
    assert type(tpol).__name__ == type(jpol).__name__
    jt_, tt = (p.telemetry(flops_per_step=fps, tokens_per_step=64.0)
               for p in (jpol, tpol))
    assert _signals(tt) == _signals(jt_)
    fired = []
    for t, loss in enumerate(_stream(stream, jax_run_losses)):
        jt_.record(t, loss)
        tt.record(t, loss)
        assert _signals(tt) == _signals(jt_), t
        assert tt.snapshot() == jt_.snapshot(), t
        g = tpol.should_grow(t, tt)
        assert g == jpol.should_grow(t, jt_), t
        assert tpol.why(t, tt) == jpol.why(t, jt_), t
        if g:
            fired.append(t)
    if kind == "step_budget":
        assert fired and fired[0] == SPECS[kind]["max_steps"]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_telemetry_snapshot_restores_across_packages(direction):
    spec = dict(kind="loss_plateau", max_steps=500, min_steps=10, window=8,
                tol=2e-3)
    src_pkg, dst_pkg = ((jag, tag) if direction == "jax_to_port"
                        else (tag, jag))
    src = src_pkg.make_policy(src_pkg.PolicySpec(**spec)).telemetry(
        flops_per_step=1e9, tokens_per_step=64.0)
    for t in range(40):
        src.record(t, 1.0 + math.exp(-t / 15.0))
    snap = json.loads(json.dumps(src.snapshot()))    # through checkpoint meta
    dst = dst_pkg.Telemetry.restore(snap, flops_per_step=1e9,
                                    tokens_per_step=64.0)
    assert isinstance(dst, dst_pkg.Telemetry)
    assert _signals(dst) == _signals(src)
    assert dst.snapshot() == src.snapshot()
    pol_s = src_pkg.make_policy(src_pkg.PolicySpec(**spec))
    pol_d = dst_pkg.make_policy(dst_pkg.PolicySpec(**spec))
    for t in range(40, 300):
        loss = 1.0 + math.exp(-t / 15.0)
        src.record(t, loss)
        dst.record(t, loss)
        assert _signals(dst) == _signals(src), t
        assert pol_d.should_grow(t, dst) == pol_s.should_grow(t, src), t


def test_autogrow_gauges_prometheus_text_equals_jax():
    texts = []
    for pkg, ob in ((jag, jobs), (tag, tobs)):
        ob.REGISTRY.reset()
        tele = pkg.Telemetry(window=6, flops_per_step=2.5e9,
                             tokens_per_step=64.0)
        for t in range(30):
            tele.record(t, 3.0 + math.exp(-t / 7.0))
        texts.append([ln for ln in ob.prom.render(ob.REGISTRY).splitlines()
                      if "autogrow" in ln])
        assert ob.REGISTRY.snapshot()["autogrow.cum_flops"]["value"] \
            == tele.cum_flops
        ob.REGISTRY.reset()
    want, got = texts
    assert got == want
    assert len([ln for ln in got if not ln.startswith("#")]) == 5


# ---------------------------------------------------------------------------
# (b) Twins of the JAX package's policy acceptance cases
# ---------------------------------------------------------------------------
def _decaying_stream(tau=15.0, plateau=1.0, amp=1.0):
    t = 0
    while True:
        yield plateau + amp * math.exp(-t / tau)
        t += 1


def test_telemetry_ring_and_signals():
    tele = tag.Telemetry(window=8, flops_per_step=1e9, tokens_per_step=64)
    stream = _decaying_stream()
    for t in range(30):
        tele.record(t, next(stream))
    assert len(tele) == 8 and tele.full
    assert tele.total_steps == 30
    assert tele.cum_flops == pytest.approx(30e9)
    assert tele.cum_tokens == pytest.approx(30 * 64)
    assert tele.improvement() > 0
    assert tele.rpf() > 0
    assert tele.peak_rpf >= tele.rpf()
    assert 0 < tele.rpf_decay() <= 1.0
    with pytest.raises(ValueError, match="window must be >= 2"):
        tag.Telemetry(window=1)


def test_loss_plateau_fires_at_the_plateau():
    spec = tag.PolicySpec(kind="loss_plateau", max_steps=10_000,
                          min_steps=10, window=8, tol=2e-3, ema_halflife=8)
    pol = tag.make_policy(spec)
    tele = pol.telemetry()
    fired = None
    stream = _decaying_stream(tau=15.0)
    for t in range(10_000):
        tele.record(t, next(stream))
        if pol.should_grow(t, tele):
            fired = t
            break
    analytic = 15.0 * math.log((1 - math.exp(-8 / 15.0)) / 2e-3)
    assert fired is not None
    assert analytic < fired < analytic + 3 * (spec.window
                                              + spec.ema_halflife), \
        (fired, analytic)


def test_rpf_decay_fires_on_decay_not_on_steady_progress():
    spec = tag.PolicySpec(kind="rpf_decay", max_steps=10_000, min_steps=10,
                          window=8, decay=0.25)
    pol = tag.make_policy(spec)
    tele = pol.telemetry(flops_per_step=1e9)
    fired = None
    stream = _decaying_stream(tau=15.0)
    for t in range(10_000):
        tele.record(t, next(stream))
        if pol.should_grow(t, tele):
            fired = t
            break
    assert fired is not None and 10 <= fired < 80, fired
    tele_lin = pol.telemetry(flops_per_step=1e9)
    for t in range(300):
        tele_lin.record(t, 10.0 - 1e-3 * t)
        assert not pol.should_grow(t, tele_lin), t


@pytest.mark.parametrize("kind", ["loss_plateau", "rpf_decay", "probe"])
def test_min_steps_guard(kind):
    """No policy but ``step_budget`` fires before ``min_steps``, whatever
    the stream says; at ``min_steps`` a plateaued stream fires."""
    extra = {"probe_candidates": ("stackbert",)} if kind == "probe" else {}
    spec = tag.PolicySpec(kind=kind, max_steps=100, min_steps=12, window=4,
                          tol=1.0, decay=2.0, **extra)
    pol = tag.make_policy(spec)
    tele = pol.telemetry(flops_per_step=1e9)
    for t in range(20):
        tele.record(t, 5.0 + 0.5 * math.exp(-t / 4.0))
        assert pol.should_grow(t, tele) == (t >= 12), t


# ---------------------------------------------------------------------------
# (c) Validation messages, JSON and the schedule hash
# ---------------------------------------------------------------------------
def _both(build):
    """Run ``build(pkg_autogrow, pkg_trajectory, cfg_of)`` in both packages;
    each must raise ValueError with the same message."""
    import repro_torch.trajectory as ptraj
    msgs = []
    for ag, tr, cfg_of in ((jag, jt, jax_cfg), (tag, ptraj, lambda c: c)):
        with pytest.raises(ValueError) as e:
            build(ag, tr, cfg_of)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    return msgs[1]


VALIDATION = {
    "no_policy": (lambda ag, tr, c: tr.TrajectoryConfig(
        stages=(tr.Stage(c(T0), None),)), "no policy"),
    "no_cap": (lambda ag, tr, c: tr.TrajectoryConfig(stages=(
        tr.Stage(c(T0), None, policy=ag.PolicySpec(kind="loss_plateau")),)),
        "max_steps"),
    "both": (lambda ag, tr, c: tr.TrajectoryConfig(stages=(
        tr.Stage(c(T0), 5, policy=ag.PolicySpec(kind="loss_plateau",
                                                max_steps=9)),)), "both"),
    "unknown_kind": (lambda ag, tr, c: ag.PolicySpec(kind="nope"),
                     "unknown policy kind"),
    "probe_candidates": (lambda ag, tr, c: ag.PolicySpec(kind="probe",
                                                         max_steps=5),
                         "probe_candidates"),
    "probe_steps": (lambda ag, tr, c: ag.PolicySpec(
        kind="probe", max_steps=5, probe_candidates=("ligo",),
        probe_steps=0), "probe_steps >= 1"),
    "unknown_keys": (lambda ag, tr, c: ag.PolicySpec.from_json(
        {"kind": "loss_plateau", "max_stepz": 5}), "unknown policy keys"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_messages_equal_jax(case):
    build, match = VALIDATION[case]
    assert match in _both(build)


AUTO_SCHEDULE = {
    "arch": "llama3-8b", "smoke": True, "batch": 4, "seq": 32,
    "stages": [
        {"steps": 10, "arch": "half"},
        {"steps": "auto", "grow": "2x", "method": "ligo",
         "ligo_steps": 0, "ligo_scan_chunk": 2,
         "policy": {"kind": "rpf_decay", "max_steps": 40,
                    "min_steps": 5, "window": 6, "decay": 0.3}},
    ]}


def test_from_json_auto_stage_and_hash_equal_jax():
    traj = TrajectoryConfig.from_json(AUTO_SCHEDULE)
    want = jt.TrajectoryConfig.from_json(AUTO_SCHEDULE)
    st = traj.stages[1]
    assert st.auto and st.steps is None and st.budget == 40
    assert st.policy.kind == "rpf_decay" and st.policy.decay == 0.3
    assert dataclasses.asdict(st.policy) \
        == dataclasses.asdict(want.stages[1].policy)
    assert traj.has_auto_stages and traj.total_steps == 50
    assert traj.stage_bounds() == want.stage_bounds() == ((0, 10), (10, 50))
    assert traj.hash() == want.hash()
    assert AUTO_TRAJ.hash() == _jax_traj(AUTO_TRAJ).hash()
    obj2 = json.loads(json.dumps(AUTO_SCHEDULE))
    obj2["stages"][1]["policy"]["decay"] = 0.5
    assert TrajectoryConfig.from_json(obj2).hash() != traj.hash()
    assert TrajectoryConfig.from_json(obj2).hash() \
        == jt.TrajectoryConfig.from_json(obj2).hash()
    # an auto stage followed by a dense -> MoE upcycle stage
    obj3 = json.loads(json.dumps(AUTO_SCHEDULE))
    obj3["stages"].append({"steps": 5, "grow": "moe", "method": "upcycle"})
    ours3, want3 = (TrajectoryConfig.from_json(obj3),
                    jt.TrajectoryConfig.from_json(obj3))
    assert ours3.stages[2].cfg.family == "moe"
    assert ours3.stages[2].cfg.name == ours3.stages[1].cfg.name + "-moe"
    assert ours3.hash() == want3.hash() != traj.hash()
    assert ours3.stage_bounds() == want3.stage_bounds() \
        == ((0, 10), (10, 50), (50, 55))


# ---------------------------------------------------------------------------
# (d), (e) The runner's auto stages, in the port
# ---------------------------------------------------------------------------
def test_step_budget_auto_stage_equals_static_schedule_bitwise(tmp_path):
    static = TrajectoryConfig(stages=(
        Stage(T0, 4),
        Stage(T1, 3, GrowthSpec(method="stackbert"))),
        batch=4, seq=16, checkpoint_every=10)
    auto = TrajectoryConfig(stages=(
        Stage(T0, None, policy=tag.PolicySpec(kind="step_budget",
                                              max_steps=4)),
        Stage(T1, 3, GrowthSpec(method="stackbert"))),
        batch=4, seq=16, checkpoint_every=10)
    r_s = _runner(static, str(tmp_path / "s")).run()
    r_a = _runner(auto, str(tmp_path / "a")).run()
    assert r_s["global_step"] == r_a["global_step"] == 7
    assert [h[2] for h in r_s["history"]] == [h[2] for h in r_a["history"]]
    _assert_equal(r_s["params"], r_a["params"])
    _assert_equal(r_s["opt"].m, r_a["opt"].m)
    # the stage loop ends at the budget before the policy is asked at it,
    # so a step_budget stage records no decision, as in the JAX runner
    assert r_a["decisions"] == []


@pytest.fixture(scope="module")
def port_full(tmp_path_factory):
    return _runner(AUTO_TRAJ, str(tmp_path_factory.mktemp("full"))).run()


def test_runner_auto_stage_ends_before_cap_and_resumes_bitwise(tmp_path,
                                                               port_full):
    full = port_full
    assert full["status"] == "done"
    dec = full["decisions"][-1]
    assert dec["kind"] == "loss_plateau"
    assert 2 <= dec["stage_step"] < 12
    assert full["stage_step"] == dec["stage_step"]
    g = dec["global_step"]
    d = str(tmp_path / "ck")
    r1 = _runner(AUTO_TRAJ, d).run(max_steps=g - 1)
    assert r1["status"] == "paused" and r1["global_step"] == g - 1
    from repro_torch.checkpoint import CheckpointManager
    meta = CheckpointManager(d).latest_meta()
    assert meta["stage"] == 1 and meta["autogrow"]["ring"]
    assert meta["autogrow"]["total_steps"] == g - 1 - 4
    r2 = _runner(AUTO_TRAJ, d).run()
    assert r2["decisions"] == [dec]
    assert r2["global_step"] == full["global_step"]
    _assert_equal(r2["params"], full["params"])
    _assert_equal(r2["opt"].v, full["opt"].v)
    # a pause on the decision step itself: the policy is asked first, so
    # the stage ends and the run is done
    r3 = _runner(AUTO_TRAJ, str(tmp_path / "at")).run(max_steps=g)
    assert r3["status"] == "done" and r3["decisions"] == [dec]


# ---------------------------------------------------------------------------
# (f) Cross-package resume of a paused auto stage
# ---------------------------------------------------------------------------
def test_port_resumes_an_auto_stage_the_jax_runner_paused(tmp_path):
    """The JAX runner pauses AUTO_TRAJ one step before its own decision
    step; the port resumes the directory and fires where the JAX
    package's resume of a copy fires."""
    jtraj = _jax_traj(AUTO_TRAJ)
    want_full = jt.TrajectoryRunner(jtraj, ckpt_dir=str(tmp_path / "jf"),
                                    verbose=False).run()
    jdec = want_full["decisions"][-1]
    g = jdec["global_step"]
    assert jdec["stage"] == 1 and jdec["stage_step"] >= 1
    d = str(tmp_path / "ck")
    r1 = jt.TrajectoryRunner(jtraj, ckpt_dir=d, verbose=False).run(
        max_steps=g - 1)
    assert r1["status"] == "paused"
    snap = JaxCheckpointManager(d).latest_meta()["autogrow"]
    d2 = str(tmp_path / "ck_jax")
    shutil.copytree(d, d2)
    want = jt.TrajectoryRunner(jtraj, ckpt_dir=d2, verbose=False).run()
    got = _runner(AUTO_TRAJ, d).run()
    assert got["resumed_at"] == tuple(want["resumed_at"])
    assert got["status"] == want["status"] == "done"
    gd, wd = got["decisions"][-1], want["decisions"][-1]
    assert (gd["stage_step"], gd["global_step"]) \
        == (wd["stage_step"], wd["global_step"]) \
        == (jdec["stage_step"], jdec["global_step"])
    assert gd["kind"] == wd["kind"]
    _params_close_to_jax(got["params"], want["params"], AUTO_TRAJ.lr)
    # the margin: replay both streams from the JAX snapshot; at the firing
    # step and the one before, |improvement - tol| must be >= 100x the
    # largest loss gap the two packages showed
    gl = [h[2] for h in got["history"]]
    wl = [h[2] for h in want["history"]]
    assert len(gl) == len(wl) >= 1
    gap = max(abs(a - b) for a, b in zip(gl, wl))
    tol = AUTO_TRAJ.stages[1].policy.tol
    tele = tag.Telemetry.restore(snap)
    imps = [tele.improvement()]
    for i, loss in enumerate(gl):
        tele.record(g + i, loss)
        imps.append(tele.improvement())
    # imps[j] is the signal the policy read after j resumed steps: the
    # stage fired on the last one and not on the one before (None while
    # the ring was not yet full)
    fire, before = imps[len(gl)], imps[len(gl) - 1]
    assert fire < tol and (before is None or before >= tol)
    for imp in (fire, before):
        if imp is not None:
            assert abs(imp - tol) >= 100 * gap, (imp, tol, gap)


# ---------------------------------------------------------------------------
# (g) probe_methods
# ---------------------------------------------------------------------------
def _bridge_draws(monkeypatch):
    """The port's LiGO and random inits, as ``grow`` sees them, return the
    JAX draws of ``PRNGKey(<the generator's seed>)``."""
    import sys
    pgrow = sys.modules["repro_torch.core.grow"]   # the package exports grow()
    pmodel = sys.modules["repro_torch.models.model"]

    def ligo(gen, cfg1, cfg2, *, device="cuda", depth_init="stack"):
        jop = jax_init_ligo(jax.random.PRNGKey(gen.initial_seed()),
                            jax_cfg(cfg1), jax_cfg(cfg2),
                            depth_init=depth_init)
        return bridge.to_torch(to_numpy(jop), device)

    def params(cfg, gen, *, device="cuda"):
        jp = jax_init_params(jax_cfg(cfg), jax.random.PRNGKey(
            gen.initial_seed()))
        return bridge.to_torch(to_numpy(jp), device)

    monkeypatch.setattr(pgrow, "init_ligo_params", ligo)
    monkeypatch.setattr(pmodel, "init_params", params)


@pytest.fixture(scope="module")
def jax_pretrained():
    """T0 after 6 JAX AdamW steps: params and optimizer state."""
    params, opt = jax_init_train_state(jax_cfg(T0), jax.random.PRNGKey(0))
    step = jax.jit(jax_make_train_step(
        jax_cfg(T0), JaxTrainConfig(steps=6, warmup_steps=2, lr=1e-3)))
    for i in range(6):
        b = {k: jnp.asarray(v) for k, v in
             jax_batch_for_step(jax_cfg(T0), i, 4, 16, seed=0).items()}
        params, opt, _ = step(params, opt, b, jnp.asarray(i))
    return params, opt


def _port_opt(jopt):
    from repro_torch.optim import AdamWState
    return AdamWState(m=bridge.to_torch(to_numpy(jopt.m)),
                      v=bridge.to_torch(to_numpy(jopt.v)),
                      count=int(jopt.count))


@pytest.mark.parametrize("pair,candidates", [
    ("depth", ("stackbert", "interpolation", "ligo")),
    ("ffn", ("lemon", "random")),
])
def test_probe_methods_equal_jax_with_bridged_draws(monkeypatch, pair,
                                                    candidates,
                                                    jax_pretrained):
    cfg2 = T0_DEEP if pair == "depth" else T0_WIDE_FF
    jp, jopt = jax_pretrained
    kw = dict(kind="probe", max_steps=10, probe_candidates=candidates,
              probe_steps=4, probe_ligo_steps=2)
    want_best, want = jag.probe_methods(
        jp, jopt, jax_cfg(T0), jax_cfg(cfg2), jag.PolicySpec(**kw),
        lr=1e-3, batch=4, seq=16, seed=5)
    _bridge_draws(monkeypatch)
    got_best, got = tag.probe_methods(
        bridge.to_torch(to_numpy(jp)), _port_opt(jopt), T0, cfg2,
        tag.PolicySpec(**kw), lr=1e-3, batch=4, seq=16, seed=5)
    assert list(got) == list(want) == list(candidates)
    gap = 0.0
    for m in candidates:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-4, err_msg=m)
        gap = max(gap, abs(got[m] - want[m]))
    assert got_best == want_best
    ranked = sorted(want.values())
    assert ranked[1] - ranked[0] > 10 * gap, (want, gap)


def _port_pretrained(cfg, steps):
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    step = make_train_step(cfg, TrainConfig(steps=steps, warmup_steps=2,
                                            lr=1e-3))
    for i in range(steps):
        b = to_device(batch_for_step(cfg, i, 4, 16, seed=0), "cpu")
        params, opt, _ = step(params, opt, b, i)
    return params, opt


def test_probe_picks_the_best_candidate_and_leaves_inputs_untouched():
    """The twin of the JAX package's case on the port's own draws: a warm
    stackbert growth of a pretrained source out-probes a cold random
    re-init; and the probe leaves ``params`` and ``opt_state`` bit for
    bit, since the runner goes on with them."""
    params, opt = _port_pretrained(T0, 80)
    before_p = {k: v.clone() for k, v in flatten_tree(params).items()}
    before_o = {k: v.clone() for k, v in flatten_tree(
        {"m": opt.m, "v": opt.v}).items()}
    spec = tag.PolicySpec(kind="probe", max_steps=100,
                          probe_candidates=("stackbert", "random", "ligo"),
                          probe_steps=6, probe_ligo_steps=2)
    best, scores = tag.probe_methods(params, opt, T0, T1, spec, lr=1e-3,
                                     batch=4, seq=16, seed=0)
    assert set(scores) == {"stackbert", "random", "ligo"}
    assert all(np.isfinite(s) for s in scores.values())
    assert scores["stackbert"] < scores["random"]
    assert best == min(scores, key=scores.get) != "random"
    again = tag.probe_methods(params, opt, T0, T1, spec, lr=1e-3, batch=4,
                              seq=16, seed=0)
    assert again == (best, scores)                  # bit for bit
    for k, v in flatten_tree(params).items():
        assert torch.equal(v, before_p[k]), k
    for k, v in flatten_tree({"m": opt.m, "v": opt.v}).items():
        assert torch.equal(v, before_o[k]), k
    assert opt.count == 80


# ---------------------------------------------------------------------------
# (h) train --autogrow, with the ledger
# ---------------------------------------------------------------------------
PROBE_SCHEDULE = {
    "arch": "gpt2-base", "smoke": True, "batch": 2, "seq": 16, "lr": 1e-3,
    "checkpoint_every": 2,
    "stages": [
        {"steps": "auto", "arch": "half",
         "policy": {"kind": "probe", "max_steps": 6, "min_steps": 2,
                    "window": 3, "tol": 1.0,
                    "probe_candidates": ["ligo", "random"],
                    "probe_steps": 2, "probe_ligo_steps": 2}},
        {"steps": "auto", "method": "ligo", "ligo_steps": 2,
         "policy": {"kind": "rpf_decay", "max_steps": 2, "window": 2}},
    ]}


def test_train_autogrow_ledger_probe_equals_jax(tmp_path, monkeypatch,
                                                capsys):
    """JAX's runner pauses the probe stage one step before its decision;
    the port's launcher (``--autogrow --device cpu --ledger``) resumes the
    directory with the JAX draws bridged in. Its probe and hop.begin
    records equal those of the JAX package's resume of a copy (scores
    within rtol 1e-4), and every decision is printed."""
    from repro_torch.launch import train
    cfg = str(tmp_path / "auto.json")
    with open(cfg, "w") as f:
        json.dump(PROBE_SCHEDULE, f)
    jtraj = jt.TrajectoryConfig.from_json(cfg)
    # tol 1.0 fires as soon as the ring is full: stage step 3
    d, path = str(tmp_path / "ck"), str(tmp_path / "led.jsonl")
    led = JaxRunLedger(path, run_id="j")
    r1 = jt.TrajectoryRunner(jtraj, ckpt_dir=d, verbose=False,
                             ledger=led).run(max_steps=2)
    led.close()
    assert r1["status"] == "paused"
    d2, path2 = str(tmp_path / "ck_jax"), str(tmp_path / "led_jax.jsonl")
    shutil.copytree(d, d2)
    shutil.copy(path, path2)
    led = JaxRunLedger(path2, run_id="j2")
    want = jt.TrajectoryRunner(jtraj, ckpt_dir=d2, verbose=False,
                               ledger=led).run()
    led.close()
    _bridge_draws(monkeypatch)
    capsys.readouterr()
    got = train.main(["--autogrow", cfg, "--ckpt-dir", d, "--device", "cpu",
                      "--ledger", path])
    out = capsys.readouterr().out
    assert got["status"] == want["status"] == "done"
    lines = [ln for ln in out.splitlines()
             if ln.startswith("[train] autogrow decision: ")]
    # the plateau rule fires, then the probe picks; the rpf_decay stage
    # runs to its cap (rpf needs four points), which is no decision
    assert len(lines) == len(got["decisions"]) == len(want["decisions"]) == 2
    assert [d_["kind"] for d_ in got["decisions"]] \
        == [d_["kind"] for d_ in want["decisions"]] == ["probe", "probe"]
    assert got["decisions"][0]["stage_step"] == 3
    for a, b in zip(got["decisions"], want["decisions"]):
        assert (a["stage"], a["stage_step"], a["global_step"]) \
            == (b["stage"], b["stage_step"], b["global_step"])
    assert got["launches"] == {"ligo_blend_expand_grouped": 0,
                               "ligo_blend_expand_bwd_fused": 0,
                               "flash_attention": 0}

    def events(p):
        return [r for r in normalize_records(read_ledger(p))
                if r["type"] == "event"
                and r["name"] in ("probe", "hop.begin")]
    ge, we = events(path), events(path2)
    assert [r["name"] for r in ge] == [r["name"] for r in we] \
        == ["probe", "hop.begin"]
    gp, wp = ge[0]["attrs"], we[0]["attrs"]
    assert gp["picked"] == wp["picked"]
    assert list(gp["scores"]) == list(wp["scores"]) == ["ligo", "random"]
    for m in wp["scores"]:
        np.testing.assert_allclose(gp["scores"][m], wp["scores"][m],
                                   rtol=1e-4)
    assert abs(wp["scores"]["ligo"] - wp["scores"]["random"]) > 1e-3
    ge[0]["attrs"].pop("scores")
    we[0]["attrs"].pop("scores")
    assert ge == we
    assert ge[1]["attrs"]["method"] == gp["picked"]


def test_train_autogrow_refusals(tmp_path):
    from repro_torch.launch import train
    cfg = str(tmp_path / "auto.json")
    with open(cfg, "w") as f:
        json.dump(PROBE_SCHEDULE, f)
    d = str(tmp_path / "ck")
    with pytest.raises(SystemExit, match="exclusive"):
        train.main(["--autogrow", cfg, "--trajectory", cfg, "--ckpt-dir", d,
                    "--device", "cpu"])
    with pytest.raises(SystemExit, match="run it with --autogrow"):
        train.main(["--trajectory", cfg, "--ckpt-dir", d, "--device", "cpu"])
    with pytest.raises(SystemExit, match="--autogrow needs --ckpt-dir"):
        train.main(["--autogrow", cfg, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--autogrow", cfg, "--ckpt-dir", d])


def test_flops_per_step_equal_jax():
    """Without a ledger both packages' telemetry axes are 6·N·tokens; the
    roofline model agrees, so cross-package decisions read one axis."""
    from repro.roofline import train_flops_per_step as jax_fps
    for cfg in (T0, T1):
        assert train_flops_per_step(cfg, 4, 16) \
            == jax_fps(jax_cfg(cfg), 4, 16)
