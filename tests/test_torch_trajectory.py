"""The port's growth trajectories (``repro_torch.trajectory``) and
supervisor (``repro_torch.distributed``) against the JAX package's: the
ports of ``tests/test_trajectory.py``'s runner and config cases and of
``tests/test_fault_tolerance.py``'s supervisor cases, on the CPU; the
trajectory hash equal to the JAX package's for the same schedule; and the
cross-package resume — the JAX runner dies mid-LiGO-phase, the port's
runner resumes its checkpoint directory and ends where the JAX package's
own resume of a copy ends (losses and parameters within 1e-4, f32).
"""
import json
import shutil

import numpy as np
import pytest
import torch

from conftest import assert_trees_close_normalized
from repro_torch import bridge
from repro_torch.checkpoint import (CheckpointManager, flatten_tree,
                                    list_steps, load_meta)
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.paper_models import BERT_SMALL
from repro_torch.core import apply_ligo, compose_chain, init_ligo_params
from repro_torch.data import batch_for_step
from repro_torch.distributed import StragglerWatchdog, Supervisor
from repro_torch.obs.ledger import RunLedger, normalize_records, read_ledger
from repro_torch.training import init_train_state, make_train_step, to_device
from repro_torch.trajectory import (GrowthSpec, Stage, TrajectoryConfig,
                                    TrajectoryRunner)

T0 = BERT_SMALL.scaled(name="tr0", n_layers=2, d_model=32, n_heads=4,
                       n_kv_heads=4, d_head=8, d_ff=64, vocab_size=64,
                       max_seq=64, dtype="float32", objective="clm",
                       encoder_only=False, causal=True)
T1 = T0.scaled(name="tr1", n_layers=3, d_model=48, n_heads=6, n_kv_heads=6,
               d_ff=96)
T2 = T1.scaled(name="tr2", n_layers=4, d_model=64, n_heads=8, n_kv_heads=8,
               d_ff=128)

TRAJ = TrajectoryConfig(stages=(
    Stage(T0, 5),
    Stage(T1, 5, GrowthSpec(method="ligo", ligo_steps=2)),
    Stage(T2, 5, GrowthSpec(method="stackbert"))),
    batch=4, seq=16, lr=1e-3, checkpoint_every=3)


def _runner(traj, d, **kw):
    return TrajectoryRunner(traj, ckpt_dir=d, verbose=False, device="cpu",
                            **kw)


def _np(tree):
    return bridge.to_numpy(tree)


def _assert_equal(a, b):
    """Two tensor trees hold the same keys and bit-equal leaves."""
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


# ---------------------------------------------------------------------------
# Trajectory runner: kill mid-stage → resume at the correct (stage, step)
# ---------------------------------------------------------------------------
def test_trajectory_kill_and_resume_deterministic(tmp_path):
    """A 3-stage trajectory killed mid-stage resumes at the right
    stage/step and reproduces the uninterrupted run exactly."""
    d = str(tmp_path / "a")
    r1 = _runner(TRAJ, d).run(max_steps=8)
    assert r1["status"] == "paused"
    assert (r1["stage"], r1["stage_step"]) == (1, 3)
    meta = CheckpointManager(d).latest_meta()
    assert meta["trajectory"] == TRAJ.hash()
    assert (meta["stage"], meta["stage_step"]) == (1, 3)
    assert meta["arch"] == T1.name
    r2 = _runner(TRAJ, d).run()
    assert r2["resumed_at"] == (1, 3)
    assert r2["status"] == "done" and r2["cfg"].name == T2.name
    assert r2["global_step"] == TRAJ.total_steps
    assert all(np.isfinite(l) for _, _, l in r2["history"])

    full = _runner(TRAJ, str(tmp_path / "b")).run()
    assert full["history"][-1][2] == r2["history"][-1][2]
    _assert_equal(r2["params"], full["params"])


def test_trajectory_refuses_foreign_checkpoint(tmp_path):
    other = TrajectoryConfig(stages=(Stage(T0, 3),), batch=4, seq=16,
                             checkpoint_every=2)
    d = str(tmp_path)
    _runner(other, d).run()
    with pytest.raises(ValueError, match="trajectory"):
        _runner(TRAJ, d).run()


def test_trajectory_config_validation_and_hash():
    with pytest.raises(ValueError):
        TrajectoryConfig(stages=())
    with pytest.raises(ValueError):            # stage 0 must not grow
        TrajectoryConfig(stages=(Stage(T0, 3, GrowthSpec()),))
    with pytest.raises(ValueError):            # later stages must grow
        TrajectoryConfig(stages=(Stage(T0, 3), Stage(T1, 3)))
    with pytest.raises(ValueError):            # non-growable pair
        TrajectoryConfig(stages=(Stage(T1, 3),
                                 Stage(T0, 3, GrowthSpec())))
    a = TRAJ.hash()
    b = TrajectoryConfig(stages=TRAJ.stages, batch=TRAJ.batch, seq=TRAJ.seq,
                         lr=TRAJ.lr,
                         checkpoint_every=TRAJ.checkpoint_every).hash()
    assert a == b                              # hash is pure data
    c = TrajectoryConfig(stages=TRAJ.stages, batch=8, seq=TRAJ.seq).hash()
    assert a != c


SCHEDULE = {
    "arch": "llama3-8b", "smoke": True, "batch": 4, "seq": 32,
    "checkpoint_every": 5,
    "stages": [
        {"steps": 10, "arch": "half"},
        {"steps": 10, "grow": "2x", "method": "ligo", "ligo_steps": 4},
        {"steps": 10, "grow": "2x", "method": "bert2bert"},
    ]}


def test_trajectory_from_json_resolution():
    traj = TrajectoryConfig.from_json(SCHEDULE)
    names = [st.cfg.name for st in traj.stages]
    assert names[0].endswith("-half")
    assert names[1].endswith("-half-grown")
    assert names[2].endswith("-half-grown-grown")
    assert traj.stages[1].growth.ligo_steps == 4
    assert traj.stages[2].growth.method == "bert2bert"
    assert traj.total_steps == 30
    assert traj.stage_bounds() == ((0, 10), (10, 20), (20, 30))


def _jax_twin(traj):
    """The JAX package's TrajectoryConfig of the same schedule."""
    from repro import trajectory as jt
    from torch_parity import jax_cfg
    return jt.TrajectoryConfig(
        stages=tuple(jt.Stage(jax_cfg(st.cfg), st.steps,
                              None if st.growth is None else
                              jt.GrowthSpec(**vars(st.growth)))
                     for st in traj.stages),
        batch=traj.batch, seq=traj.seq, lr=traj.lr,
        checkpoint_every=traj.checkpoint_every, seed=traj.seed)


@pytest.mark.parametrize("source", ["json", "stages"])
def test_trajectory_hash_equals_the_references(tmp_path, source):
    """The same schedule hashes alike in both packages, from a JSON file
    and from stages built in code, so either resumes the other's
    checkpoints."""
    from repro import trajectory as jt
    if source == "json":
        path = str(tmp_path / "traj.json")
        with open(path, "w") as f:
            json.dump(SCHEDULE, f)
        ours, theirs = (TrajectoryConfig.from_json(path),
                        jt.TrajectoryConfig.from_json(path))
    else:
        ours, theirs = TRAJ, _jax_twin(TRAJ)
    assert ours.hash() == theirs.hash()
    assert [st.cfg.config_hash() for st in ours.stages] \
        == [st.cfg.config_hash() for st in theirs.stages]


@pytest.mark.parametrize("change", [
    {"grow": "moe"},
])
def test_trajectory_later_slice_features_raise(change, tmp_path):
    """A ``"grow": "moe"`` stage (the dense→MoE hop, entered by LiGO here,
    then MoE→MoE growth) resolves and hashes as in the JAX package; so does
    a ``gqa_merge`` stage (MHA → GQA head merging), which also grows as in
    the JAX package: the JAX runner pauses in stage 0, and the port's
    runner resumes that directory through the merge hop to the end within
    1e-4 of the JAX package's own resume of a copy (losses and params)."""
    from repro import trajectory as jt
    from repro.trajectory import TrajectoryRunner as JaxRunner
    obj = json.loads(json.dumps(SCHEDULE))
    obj["stages"][1].update(change)
    ours, theirs = (TrajectoryConfig.from_json(obj),
                    jt.TrajectoryConfig.from_json(obj))
    assert [st.cfg.family for st in ours.stages] == ["dense", "moe", "moe"]
    assert ours.hash() == theirs.hash() != TRAJ.hash()
    assert [st.cfg.config_hash() for st in ours.stages] \
        == [st.cfg.config_hash() for st in theirs.stages]

    mha = T0.scaled(name="tr0-mha", norm="rms")      # no biases
    gqa = mha.scaled(name="tr0-gqa", n_kv_heads=2)
    traj = TrajectoryConfig(stages=(
        Stage(mha, 3), Stage(gqa, 3, GrowthSpec(method="gqa_merge"))),
        batch=4, seq=16, lr=1e-3, checkpoint_every=2)
    jtraj = _jax_twin(traj)
    assert traj.hash() == jtraj.hash()
    d = str(tmp_path / "ck")
    assert JaxRunner(jtraj, ckpt_dir=d, verbose=False).run(
        max_steps=2)["status"] == "paused"
    d2 = str(tmp_path / "ck_jax")
    shutil.copytree(d, d2)
    want = JaxRunner(jtraj, ckpt_dir=d2, verbose=False).run()
    got = _runner(traj, d).run()
    assert got["status"] == want["status"] == "done"
    assert got["resumed_at"] == tuple(want["resumed_at"]) == (0, 2)
    assert got["cfg"].n_kv_heads == 2
    np.testing.assert_allclose([h[2] for h in got["history"]],
                               [float(h[2]) for h in want["history"]],
                               rtol=1e-4)
    assert_trees_close_normalized(_np(got["params"]),
                                  _jax_np(want["params"]), rel=1e-4)


@pytest.mark.parametrize("change", [
    {"steps": "auto", "policy": {"kind": "loss_plateau", "max_steps": 8}},
    {"policy": {"kind": "loss_plateau", "max_steps": 8}},
], ids=["auto_stage", "policy_on_a_fixed_stage"])
def test_trajectory_auto_and_policy_schedules_match_the_reference(change):
    """An auto stage parses and hashes as in the JAX package; a policy on
    a fixed-count stage is refused with the JAX package's message."""
    from repro import trajectory as jt
    obj = json.loads(json.dumps(SCHEDULE))
    obj["stages"][1].update(change)
    if change.get("steps") == "auto":
        ours, theirs = (TrajectoryConfig.from_json(obj),
                        jt.TrajectoryConfig.from_json(obj))
        assert ours.stages[1].auto and ours.stages[1].budget == 8
        assert ours.hash() == theirs.hash() != TrajectoryConfig.from_json(
            SCHEDULE).hash()
        assert ours.stage_bounds() == theirs.stage_bounds()
        return
    msgs = []
    for cls in (TrajectoryConfig, jt.TrajectoryConfig):
        with pytest.raises(ValueError, match="both a fixed step count") as e:
            cls.from_json(obj)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# Zero-step stages collapse into one composed hop (GQA second-moment rule)
# ---------------------------------------------------------------------------
G0 = BERT_SMALL.scaled(name="gq0", n_layers=2, d_model=32, n_heads=4,
                       n_kv_heads=2, d_head=8, d_ff=64, vocab_size=64,
                       max_seq=64, dtype="float32", objective="clm",
                       encoder_only=False, causal=True)
G1 = G0.scaled(name="gq1", n_layers=3, d_model=48, n_heads=6, n_kv_heads=2,
               d_ff=96)
G2 = G1.scaled(name="gq2", n_layers=4, d_model=64, n_heads=8, n_kv_heads=4,
               d_ff=128)


def test_runner_collapses_zero_step_stages_lemon_exact(tmp_path):
    """Consecutive zero-step stages run as one composed hop: the stage-2
    entry snapshot equals the analytic oracle (params and m through the
    composed operator, v hop by hop), and no stage-1 checkpoint exists."""
    traj = TrajectoryConfig(stages=(
        Stage(G0, 2),
        Stage(G1, 0, GrowthSpec(method="ligo", ligo_steps=0)),
        Stage(G2, 2, GrowthSpec(method="ligo", ligo_steps=0))),
        batch=4, seq=16, lr=1e-3, checkpoint_every=3)
    d = str(tmp_path)
    r = _runner(traj, d).run()
    assert r["status"] == "done"
    assert 1 not in r["timings"]
    assert all(load_meta(d, s)["stage"] != 1 for s in list_steps(d))
    tmpl = init_train_state(G2, torch.Generator().manual_seed(0),
                            device="meta")
    snap, meta = CheckpointManager(d).restore(
        2, {"params": tmpl[0], "opt": tmpl[1]}, "cpu")
    assert meta["stage"] == 2 and meta["stage_step"] == 0

    def gen(seed):
        return torch.Generator().manual_seed(seed)
    p0, opt0 = init_train_state(G0, gen(traj.seed), device="cpu")
    step = make_train_step(G0, TrainConfig(steps=2, warmup_steps=1,
                                           lr=traj.lr, seq_len=traj.seq,
                                           global_batch=traj.batch))
    for i in range(2):
        b = to_device(batch_for_step(G0, i, traj.batch, traj.seq,
                                     seed=traj.seed), "cpu")
        p0, opt0, _ = step(p0, opt0, b, i)
    ops_list = [init_ligo_params(gen(traj.seed + 7), G0, G1, device="cpu"),
                init_ligo_params(gen(traj.seed + 14), G1, G2, device="cpu")]
    comp = compose_chain(ops_list, [G0, G1, G2])
    with torch.no_grad():
        want_p = apply_ligo(comp, p0, G0, G2)
        want_m = apply_ligo(comp, opt0.m, G0, G2)
        want_v = opt0.v
        for op, a, b in zip(ops_list, [G0, G1], [G1, G2]):
            want_v = apply_ligo(op, want_v, a, b, engine="legacy",
                                square=True)
    assert_trees_close_normalized(_np(snap["params"]), _np(want_p), rel=1e-5)
    assert_trees_close_normalized(_np(snap["opt"].m), _np(want_m), rel=1e-5)
    assert_trees_close_normalized(_np(snap["opt"].v), _np(want_v), rel=1e-5)
    assert snap["opt"].count == opt0.count == 2


# ---------------------------------------------------------------------------
# Supervisor (tests/test_fault_tolerance.py and the meta case)
# ---------------------------------------------------------------------------
def _sup_run(steps, fail_at=None, ckpt_dir=None, checkpoint_every=5,
             max_restarts=5, cfg=T0):
    tcfg = TrainConfig(steps=steps, warmup_steps=2, lr=1e-3)
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")

    def batch_at(s):
        return to_device(batch_for_step(cfg, s, 4, 16, seed=0), "cpu")
    sup = Supervisor(ckpt_dir=ckpt_dir, checkpoint_every=checkpoint_every,
                     max_restarts=max_restarts)
    state = sup.run({"params": params, "opt": opt},
                    make_train_step(cfg, tcfg), batch_at, start_step=0,
                    steps=steps, fail_at=fail_at,
                    meta={"arch": cfg.name, "config": cfg.config_hash()})
    return sup, state


def test_recovery_is_deterministic(tmp_path):
    """A crash and restore replays the identical loss trajectory."""
    sup1, s1 = _sup_run(12, ckpt_dir=str(tmp_path / "a"))
    sup2, s2 = _sup_run(12, fail_at={8: RuntimeError("boom")},
                        ckpt_dir=str(tmp_path / "b"))
    assert sup2.restarts == 1
    clean = {s: l for s, l, _ in sup1.history}
    recovered = {s: l for s, l, _ in sup2.history}   # last occurrence wins
    assert clean == recovered
    _assert_equal(s1, s2)


def test_restart_cap(tmp_path):
    with pytest.raises(RuntimeError, match="restarts"):
        _sup_run(10, ckpt_dir=str(tmp_path), checkpoint_every=100,
                 max_restarts=2,
                 fail_at={3: RuntimeError("a"), 4: RuntimeError("b"),
                          5: RuntimeError("c")})


def test_straggler_watchdog_flags_outliers():
    wd = StragglerWatchdog(z=3.0, warmup=3)
    for i in range(10):
        wd.observe(i, 0.10 + 0.001 * (i % 2))
    assert not wd.flagged
    assert wd.observe(10, 1.0)                   # 10x step time: flagged
    assert wd.flagged and wd.flagged[0][0] == 10
    assert wd.ewma < 0.2                         # the EWMA skips it


def test_supervisor_threads_meta_into_checkpoints(tmp_path):
    """``Supervisor.run(meta=...)`` stamps the run identity on every
    checkpoint; a fault's restored meta does not leak into later saves."""
    d = str(tmp_path)
    sup, _ = _sup_run(4, ckpt_dir=d, checkpoint_every=2,
                      fail_at={3: RuntimeError("boom")})
    for s in list_steps(d):
        meta = load_meta(d, s)
        assert meta["step"] == s, (s, meta)
        assert meta["arch"] == T0.name
        assert meta["config"] == T0.config_hash()
    assert sup.mgr.latest_meta()["step"] == 4


# ---------------------------------------------------------------------------
# Cross-package resume: the JAX runner dies mid-LiGO-phase, the port resumes
# ---------------------------------------------------------------------------
TRAJ_X = TrajectoryConfig(stages=(
    Stage(T0, 3),
    Stage(T1, 3, GrowthSpec(method="ligo", ligo_steps=4, ligo_scan_chunk=2))),
    batch=4, seq=16, lr=1e-3, checkpoint_every=2)


def test_port_resumes_a_trajectory_the_jax_runner_killed(tmp_path, capsys):
    """JAX's runner dies after its LiGO-phase checkpoint at step 2 of 4;
    the port's runner resumes that directory (phase included) and ends
    within 1e-4 of the JAX package's own resume of a copy: final params,
    every ledger loss (the key bias to its noise bound, as in
    tests/test_torch_train.py); the other ledger fields equal, but the measured
    FLOPs, which each package counts its own way (each held to [0.5, 2]
    of the modelled count)."""
    from repro.obs.ledger import RunLedger as JaxRunLedger
    from repro.trajectory import TrajectoryRunner as JaxRunner
    jtraj = _jax_twin(TRAJ_X)
    assert jtraj.hash() == TRAJ_X.hash()
    d, path = str(tmp_path / "ck"), str(tmp_path / "led.jsonl")
    led = JaxRunLedger(path, run_id="x")
    with pytest.raises(RuntimeError, match="LiGO"):
        JaxRunner(jtraj, ckpt_dir=d, verbose=False, ligo_fail_at=2,
                  ledger=led).run()
    led.close()
    d2, path2 = str(tmp_path / "ck_jax"), str(tmp_path / "led_jax.jsonl")
    shutil.copytree(d, d2)
    shutil.copy(path, path2)

    led = JaxRunLedger(path2, run_id="x2")
    want = JaxRunner(jtraj, ckpt_dir=d2, verbose=False, ledger=led).run()
    led.close()
    capsys.readouterr()
    led = RunLedger(path, run_id="x3")
    got = _runner(TRAJ_X, d, ledger=led).run()
    led.close()
    assert "resumed LiGO phase at step 2/4" in capsys.readouterr().out
    assert got["status"] == want["status"] == "done"
    assert got["resumed_at"] == tuple(want["resumed_at"]) == (0, 3)
    got_p, want_p = _np(got["params"]), _jax_np(want["params"])
    # bk's exact gradient is 0 (tests/test_torch_train.py), so AdamW turns
    # each package's rounding noise into steps of up to ~lr: hold it to
    # that bound, and every other leaf to the other package
    for bk in (got_p["layers"]["attn"].pop("bk"),
               want_p["layers"]["attn"].pop("bk")):
        assert float(abs(bk).max()) <= 10 * TRAJ_X.lr
    assert_trees_close_normalized(got_p, want_p, rel=1e-4)

    rg = normalize_records(read_ledger(path))
    rw = normalize_records(read_ledger(path2))
    assert [r["type"] for r in rg] == [r["type"] for r in rw]
    assert len([r for r in rg if r.get("phase") == "ligo"]) == 4
    measured = ("flops_measured", "cum_flops_measured")
    for a, b in zip(rg, rw):
        assert set(a) == set(b)
        for k in set(a) - {"loss", *measured}:
            assert a[k] == b[k], (k, a, b)
        if a["type"] == "step":
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
            for r in (a, b):
                assert 0.5 <= r["flops_measured"] / r["flops_modelled"] \
                    <= 2.0, r


def _jax_np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# The launchers: checkpoints, resume, refusals, serve --ckpt
# ---------------------------------------------------------------------------
def test_train_launcher_resumes_and_refuses_foreign_checkpoints(tmp_path):
    from repro_torch.launch import train
    d = str(tmp_path / "ck")
    base = ["--arch", "gpt2-base", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "16", "--ckpt-dir", d, "--checkpoint-every", "2"]
    first = train.main(base + ["--steps", "3"])
    assert load_meta(d, 3)["arch"] == "gpt2-base-smoke"
    again = train.main(base + ["--steps", "5"])
    assert len(first["train_losses"]) == 3 and len(again["train_losses"]) == 2
    with pytest.raises(SystemExit, match="refusing to resume"):
        train.main(["--arch", "gpt2-medium", "--smoke", "--device", "cpu",
                    "--steps", "2", "--ckpt-dir", d])
    with pytest.raises(SystemExit, match="requires --trajectory"):
        train.main(base + ["--ledger", str(tmp_path / "l.jsonl")])
    with pytest.raises(SystemExit, match="exclusive"):
        train.main(["--autogrow", "x.json", "--trajectory", "x.json",
                    "--device", "cpu"])

    traj = str(tmp_path / "t.json")
    with open(traj, "w") as f:
        json.dump({"arch": "gpt2-base", "smoke": True, "batch": 2,
                   "seq": 16, "checkpoint_every": 2,
                   "stages": [{"steps": 2}]}, f)
    dt = str(tmp_path / "traj")
    train.main(["--trajectory", traj, "--ckpt-dir", dt, "--device", "cpu"])
    with pytest.raises(SystemExit, match="trajectory checkpoint"):
        train.main(base[:-4] + ["--steps", "2", "--ckpt-dir", dt])


def test_serve_ckpt_serves_the_trajectorys_params(tmp_path):
    """``serve --ckpt`` of a trajectory's directory prefills the newest
    checkpoint's params: logits equal to the run's final params'."""
    from repro_torch.launch import serve, train
    from repro_torch.models.model import prefill
    traj = str(tmp_path / "t.json")
    with open(traj, "w") as f:
        json.dump({"arch": "gpt2-base", "smoke": True, "batch": 2,
                   "seq": 16, "checkpoint_every": 2,
                   "stages": [{"steps": 3}]}, f)
    d = str(tmp_path / "ck")
    res = train.main(["--trajectory", traj, "--ckpt-dir", d, "--device",
                      "cpu"])
    out = serve.main(["--arch", "gpt2-base", "--smoke", "--ckpt", d,
                      "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                      "--gen", "2"])
    with torch.no_grad():
        want, _ = prefill(res["params"], out["cfg"],
                          {"tokens": out["prompts"]}, max_len=10)
    assert torch.equal(out["prefill_logits"], want)
