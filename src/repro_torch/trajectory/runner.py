"""TrajectoryRunner: train→grow→train… as one resumable job (the twin of
the JAX package's ``trajectory/runner.py``, for schedules of the dense
family on one device).

One runner call drives a whole :class:`~repro_torch.trajectory.config.
TrajectoryConfig`: train stage 0, grow into stage 1 (the operator learned
or built per the stage's :class:`GrowthSpec`, parameters and AdamW moments
carried through it), train stage 1, grow again, …

Resumability: every checkpoint carries ``{trajectory, stage, stage_step,
global_step, arch, config}`` (and the ledger cursor) in its meta. A fresh
runner on the same directory reads the meta first, checks the trajectory
hash, builds the stage's template and restores into it, so a job killed
mid-stage resumes at the (stage, step) it died on. A post-growth snapshot
is written at every stage entry, so a finished growth is never redone. The
LiGO phase inside a hop is elastic too: its ``(ligo, mom)`` carry is
checkpointed under ``<ckpt_dir>/ligo_phase`` at chunk boundaries
(:func:`repro_torch.core.grow.train_ligo`), so a kill during the phase
resumes mid-phase. The checkpoints, the hash and the phase identity are
the JAX package's, so either package resumes the other's directory.

Adaptive scheduling (:mod:`repro_torch.autogrow`): a stage with
``steps="auto"`` ends when its growth policy fires on the stage's telemetry
stream (loss EMA / return-per-FLOP over a ring buffer) instead of at a
fixed count; the policy is asked before each step, and before the
``max_steps`` pause, as in the JAX runner. The telemetry ring rides every
checkpoint's meta (``meta["autogrow"]``, the JAX package's snapshot), so a
resumed stage replays the identical decision sequence. A ``probe`` policy
also short-trains the candidate growth operators at the hop
(:func:`repro_torch.autogrow.probe_methods`) and commits the winner.
Every decision lands in the result's ``decisions``.

Consecutive zero-step stages whose hops need no intermediate model
(classical operators, LiGO without steps) run as one composed hop:
parameters and first moments through the composed operator, second moments
by the GQA rule (:func:`repro_torch.optim.grow_adamw_state_chain`).

``run(max_steps=N)`` stops after N global train steps (checkpointing
first), the deterministic "kill" of the tests; ``run()`` on a new runner
finishes the job. The JAX package's meshes are not ported.

Spans (the JAX package's): ``traj.train`` (``stage``, ``arch``, ``start``)
around each stage's train leg and ``traj.grow`` (``stage``, ``src``,
``dst``) around each hop; the legs' walls also feed the
``traj.stage.train_ms`` and ``traj.stage.grow_ms`` histograms.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.autogrow import Telemetry, make_policy, probe_methods
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.core import apply_ligo, compose_chain, grow
from repro_torch.data import GlobalBatchLoader
from repro_torch.data.synthetic import require_token_stream
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.optim import adamw_init, grow_adamw_state_chain
from repro_torch.roofline import train_flops_per_step
from repro_torch.training import make_train_step
from repro_torch.trajectory.config import TrajectoryConfig

LIGO_PHASE_DIR = "ligo_phase"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class TrajectoryRunner:
    def __init__(self, traj: TrajectoryConfig, *, ckpt_dir: str,
                 keep: int = 3, verbose: bool = True,
                 ligo_fail_at: Optional[int] = None, ledger=None,
                 device="cuda"):
        from repro_torch.obs.ledger import active_ledger
        for st in traj.stages:
            require_token_stream(st.cfg, "trajectory")
        self.traj = traj
        self.mgr = CheckpointManager(ckpt_dir, keep=keep)
        self.verbose = verbose
        self.dev = resolve_device(device)
        self.resumed_at: Optional[Tuple[int, int]] = None
        # chaos knob: fail after the LiGO-phase checkpoint at this phase
        # step (threaded into train_ligo)
        self.ligo_fail_at = ligo_fail_at
        self.decisions: List[Dict[str, Any]] = []
        self._tele_restore: Optional[Dict] = None
        # the compute ledger (explicit, or what --ledger attached): its
        # cursor rides every checkpoint meta
        self.ledger = ledger if ledger is not None else active_ledger()

    # ------------------------------------------------------------------
    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[traj] {msg}", flush=True)

    def _meta(self, stage: int, stage_step: int, global_step: int,
              tele: Optional[Telemetry] = None) -> Dict:
        cfg = self.traj.stages[stage].cfg
        meta = {"trajectory": self.traj.hash(), "stage": stage,
                "stage_step": stage_step, "global_step": global_step,
                "arch": cfg.name, "config": cfg.config_hash()}
        if tele is not None:
            # the controller's signal state rides the checkpoint, so a
            # resumed auto stage replays the same growth decision
            meta["autogrow"] = tele.snapshot()
        if self.ledger is not None:
            # snapshot() fsyncs first: every record up to the cursor is
            # durable before the checkpoint carrying it lands
            meta["ledger"] = self.ledger.snapshot()
        return meta

    def _template(self, stage: int):
        """Shapes and dtypes of a stage's state, on the ``meta`` device."""
        cfg = self.traj.stages[stage].cfg
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="meta")
        return {"params": params, "opt": adamw_init(params)}

    @property
    def _phase_dir(self) -> str:
        return os.path.join(self.mgr.dir, LIGO_PHASE_DIR)

    # ------------------------------------------------------------------
    def _restore_or_init(self):
        meta = self.mgr.latest_meta()
        if meta is None:
            if self.ledger is not None:
                self.ledger.restore(None)      # fresh run: empty ledger
            cfg0 = self.traj.stages[0].cfg
            with torch.no_grad():
                params = init_params(
                    cfg0, torch.Generator(device=self.dev).manual_seed(
                        self.traj.seed), device=self.dev)
            return 0, 0, 0, params, adamw_init(params)
        if meta.get("trajectory") != self.traj.hash():
            raise ValueError(
                f"checkpoint dir {self.mgr.dir!r} belongs to trajectory "
                f"{meta.get('trajectory')!r}, not {self.traj.hash()!r} — "
                "refusing to resume a different schedule")
        stage, k = int(meta["stage"]), int(meta["stage_step"])
        g = int(meta["global_step"])
        try:
            state, _ = self.mgr.restore(self.mgr.latest_step(),
                                        self._template(stage), self.dev)
        except KeyError as e:
            if "opt" in str(e):
                raise ValueError(
                    f"checkpoint in {self.mgr.dir!r} has no optimizer state "
                    "— a growth trajectory cannot resume from it: the AdamW "
                    "moments must ride every hop. Delete the directory to "
                    f"restart. (missing leaf: {e})") from e
            raise
        self._tele_restore = meta.get("autogrow")
        if self.ledger is not None:
            # truncate the ledger back to this checkpoint's cursor; the
            # re-executed steps append the same records again
            self.ledger.restore(meta.get("ledger"))
        self.resumed_at = (stage, k)
        self._log(f"resumed trajectory {self.traj.hash()} at stage {stage} "
                  f"step {k} ({meta['arch']})")
        return stage, k, g, state["params"], state["opt"]

    # ------------------------------------------------------------------
    def _stage_step_fn(self, stage: int, params, opt):
        """(step function, loader, measurement) of one stage's train leg.
        The measurement (None without a ledger) counts one step's FLOPs
        (:func:`repro_torch.obs.costs.measure_step`)."""
        st = self.traj.stages[stage]
        tcfg = TrainConfig(steps=st.budget,
                           warmup_steps=max(st.budget // 10, 1),
                           lr=self.traj.lr, seq_len=self.traj.seq,
                           global_batch=self.traj.batch)
        step_fn = make_train_step(st.cfg, tcfg)
        loader = GlobalBatchLoader(st.cfg, self.traj.batch, self.traj.seq,
                                   seed=self.traj.seed + 101 * stage,
                                   device=self.dev)
        meas = None
        if self.ledger is not None:
            from repro_torch.obs import costs
            meas = costs.measure_step(
                f"train_step[{st.cfg.name}]", step_fn, params, opt,
                loader.batch_at(0), 0,
                modelled_flops=train_flops_per_step(
                    st.cfg, self.traj.batch, self.traj.seq))
        return step_fn, loader, meas

    def _stage_controller(self, stage: int):
        """(policy, telemetry) for an auto stage; (None, None) for static
        stages — a static budget needs no per-step decision."""
        st = self.traj.stages[stage]
        if not st.auto:
            return None, None
        pol = make_policy(st.policy)
        fps = train_flops_per_step(st.cfg, self.traj.batch, self.traj.seq)
        tokens = float(self.traj.batch * self.traj.seq)
        if self._tele_restore is not None:
            tele = Telemetry.restore(self._tele_restore,
                                     flops_per_step=fps,
                                     tokens_per_step=tokens)
            self._tele_restore = None
        else:
            tele = pol.telemetry(flops_per_step=fps, tokens_per_step=tokens)
        return pol, tele

    # ------------------------------------------------------------------
    def _chain_end(self, stage: int) -> int:
        """Last stage of the composable hop run starting at ``stage``:
        through following zero-step stages whose entry operators need no
        intermediate model (classical methods, LiGO without steps)."""
        stages = self.traj.stages
        if stages[stage].growth.method == "random":
            return stage
        last = stage
        while last < len(stages) - 1 and stages[last].budget == 0:
            g = stages[last + 1].growth
            if g.method == "random" or (g.method == "ligo"
                                        and g.ligo_steps > 0):
                break
            last += 1
        return last

    def _hop_operator(self, stage: int, params, *, method=None):
        """Build (for LiGO, train) the operator entering ``stage``; the LiGO
        phase checkpoints its carry under ``<ckpt_dir>/ligo_phase``.
        ``method`` replaces the stage's growth method (a probe's pick)."""
        st = self.traj.stages[stage]
        gs = st.growth
        if method is not None and method != gs.method:
            gs = dataclasses.replace(gs, method=method)
        prev_cfg = self.traj.stages[stage - 1].cfg
        data_it = ligo_ckpt = None
        if gs.method == "ligo" and gs.ligo_steps > 0:
            data_it = iter(GlobalBatchLoader(
                prev_cfg, self.traj.batch, self.traj.seq,
                seed=self.traj.seed + 101 * stage + 53, device=self.dev))
            ligo_ckpt = CheckpointManager(self._phase_dir, keep=2)
        _, info = grow(
            params, prev_cfg, st.cfg, method=gs.method,
            gen=torch.Generator(device=self.dev).manual_seed(
                self.traj.seed + 7 * stage),
            data_it=data_it, ligo_steps=gs.ligo_steps, ligo_lr=gs.ligo_lr,
            ligo_momentum=gs.ligo_momentum, apply=False,
            ligo_ckpt=ligo_ckpt,
            ligo_meta={"trajectory": self.traj.hash(), "stage": stage},
            ligo_scan_chunk=gs.ligo_scan_chunk,
            ligo_fail_at=self.ligo_fail_at, ligo_ledger=self.ledger,
            ligo_ledger_ctx=None if self.ledger is None else {
                "stage": stage, "n_devices": 1})
        return info["operator"], gs

    def _grow_into(self, stage: int, params, opt, *, method=None):
        """Hop stage-1 → stage (a run of zero-step stages collapsed into
        one composed hop): params and AdamW moments through the
        operator(s), fresh moments otherwise. ``method`` replaces the
        growth method of the first hop only (a probe's pick; ``random``
        takes the fresh-init path). Returns
        ``(landed_stage, params, opt, grow_ms)``."""
        stages = self.traj.stages
        t0 = time.perf_counter()
        if (method or stages[stage].growth.method) == "random":
            st = stages[stage]
            params, info = grow(
                params, stages[stage - 1].cfg, st.cfg, method="random",
                gen=torch.Generator(device=self.dev).manual_seed(
                    self.traj.seed + 7 * stage), opt_state=opt)
            _sync(self.dev)
            grow_ms = (time.perf_counter() - t0) * 1e3
            self._log(f"stage {stage}: fresh init of {st.cfg.name} "
                      f"(method=random) in {grow_ms:.0f} ms")
            return stage, params, info["opt_state"], grow_ms

        last = self._chain_end(stage)
        cfg_chain = [stages[j].cfg for j in range(stage - 1, last + 1)]
        ops_chain, specs = [], []
        for idx, j in enumerate(range(stage, last + 1)):
            op, gs = self._hop_operator(j, params,
                                        method=method if idx == 0 else None)
            ops_chain.append(op)
            specs.append(gs)
        composed = (ops_chain[0] if len(ops_chain) == 1
                    else compose_chain(ops_chain, cfg_chain))
        with torch.no_grad():
            params = apply_ligo(composed, params, cfg_chain[0],
                                cfg_chain[-1])
        carry = all(gs.grow_optimizer for gs in specs)
        opt = (grow_adamw_state_chain(opt, ops_chain, cfg_chain) if carry
               else adamw_init(params))
        _sync(self.dev)
        grow_ms = (time.perf_counter() - t0) * 1e3
        hops = " -> ".join(c.name for c in cfg_chain)
        self._log(f"grew {hops} "
                  f"({'composed, ' if len(ops_chain) > 1 else ''}"
                  f"method={'+'.join(gs.method for gs in specs)}, "
                  f"opt moments {'carried' if carry else 'reset'}) "
                  f"in {grow_ms:.0f} ms")
        return last, params, opt, grow_ms

    # ------------------------------------------------------------------
    def run(self, *, max_steps: Optional[int] = None,
            on_metrics=None) -> Dict[str, Any]:
        """Drive the trajectory to completion (or to ``max_steps`` global
        train steps). Returns the final state and bookkeeping; ``status``
        is ``"done"`` or ``"paused"``."""
        stages = self.traj.stages
        stage, k, global_step, params, opt = self._restore_or_init()
        history: list = []
        timings: Dict[int, Dict[str, float]] = {}

        def timing(s: int) -> Dict[str, float]:
            return timings.setdefault(s, {"train_ms": 0.0, "grow_ms": 0.0})

        # the legs' walls also land in the obs registry (the spans
        # "traj.train" / "traj.grow" carry them in the flight recorder)
        h_train = obs.histogram("traj.stage.train_ms")
        h_grow = obs.histogram("traj.stage.grow_ms")

        # the identity of the last checkpoint written (or restored from),
        # so stage-end and done saves don't rewrite a step just written
        last_saved = [self.resumed_at + (global_step,)
                      if self.resumed_at is not None else None]

        def save(s: int, kk: int, g: int, *, tele=None,
                 block: bool = False) -> None:
            self.mgr.save(g, {"params": params, "opt": opt},
                          self._meta(s, kk, g, tele), block=block)
            last_saved[0] = (s, kk, g)

        def save_once(s: int, kk: int, g: int, *, tele=None,
                      block: bool = False) -> None:
            if last_saved[0] != (s, kk, g):
                save(s, kk, g, tele=tele, block=block)
            elif block:
                self.mgr.wait()

        def result(status: str) -> Dict[str, Any]:
            self.mgr.wait()
            return {"params": params, "opt": opt,
                    "cfg": stages[stage].cfg, "stage": stage,
                    "stage_step": k, "global_step": global_step,
                    "history": history, "status": status,
                    "resumed_at": self.resumed_at, "timings": timings,
                    "decisions": self.decisions}

        while True:
            st = stages[stage]
            pol, tele = self._stage_controller(stage)
            if k < st.budget:
                self._log(f"stage {stage + 1}/{len(stages)}: {st.cfg.name} "
                          f"({st.cfg.param_count() / 1e6:.1f}M) "
                          f"steps [{k}, "
                          f"{'auto<=' if st.auto else ''}{st.budget})")
                t_train = time.perf_counter()
                with obs.span("traj.train", stage=stage, arch=st.cfg.name,
                              start=k):
                    step_fn, loader, meas = self._stage_step_fn(stage, params,
                                                                opt)
                    if self.ledger is not None:
                        fps_model = train_flops_per_step(
                            st.cfg, self.traj.batch, self.traj.seq)
                        tokens_step = float(self.traj.batch * self.traj.seq)
                        meas_fps = meas["flops_per_unit"]
                        if tele is not None:
                            # the controller's cum-FLOPs axis follows the
                            # measured number; deterministic across resume
                            # because the resumed process re-measures the
                            # same step before its first record
                            tele.set_flops_per_step(meas_fps)
                    while k < st.budget:
                        # the policy is asked before the pause, as in the
                        # JAX runner: a pause on the decision step ends
                        # the stage instead
                        if pol is not None and pol.should_grow(k, tele):
                            self.decisions.append(
                                {"stage": stage, "stage_step": k,
                                 "global_step": global_step,
                                 "kind": st.policy.kind,
                                 "why": pol.why(k, tele)})
                            self._log(f"stage {stage + 1} policy fired at "
                                      f"step {k}: {pol.why(k, tele)}")
                            break
                        if max_steps is not None and global_step >= max_steps:
                            dt = (time.perf_counter() - t_train) * 1e3
                            timing(stage)["train_ms"] += dt
                            h_train.observe(dt)
                            save_once(stage, k, global_step, tele=tele,
                                      block=True)
                            self._log(f"paused at global step {global_step} "
                                      f"(stage {stage} step {k})")
                            return result("paused")
                        batch = loader.batch_at(k)
                        t_step = time.perf_counter()
                        params, opt, m = step_fn(params, opt, batch, k)
                        k += 1
                        global_step += 1
                        loss = float(m["total"])      # host sync point
                        history.append((global_step, stage, loss))
                        if self.ledger is not None:
                            self.ledger.record_step(
                                stage=stage, arch=st.cfg.name,
                                step=global_step, loss=loss,
                                tokens=tokens_step,
                                wall_ms=(time.perf_counter() - t_step) * 1e3,
                                flops_modelled=fps_model,
                                flops_measured=meas_fps)
                        if tele is not None:
                            tele.record(global_step, loss)
                        if on_metrics is not None:
                            on_metrics(global_step, stage, m)
                        if k % self.traj.checkpoint_every == 0:
                            save(stage, k, global_step, tele=tele)
                    dt = (time.perf_counter() - t_train) * 1e3
                    timing(stage)["train_ms"] += dt
                    h_train.observe(dt)
                # the stage-end save: a kill during the following hop
                # resumes here (the LiGO-phase checkpoints carry the rest)
                save_once(stage, k, global_step, tele=tele)
                # history holds only this process's steps: a resumed stage
                # whose policy fires at once has run none of them
                self._log(f"stage {stage + 1} done ({k} steps)"
                          + (f": loss {history[-1][2]:.4f}" if history
                             else ""))
            if stage + 1 == len(stages):
                save_once(stage, k, global_step, block=True)
                return result("done")
            method = None
            nxt = stages[stage + 1]
            if (st.auto and st.policy.kind == "probe"
                    and nxt.growth.method != "random"):
                method, scores = probe_methods(
                    params, opt, st.cfg, nxt.cfg, st.policy,
                    lr=self.traj.lr, batch=self.traj.batch,
                    seq=self.traj.seq,
                    seed=self.traj.seed + 1009 * (stage + 1),
                    verbose=self.verbose)
                self.decisions.append(
                    {"stage": stage, "stage_step": k,
                     "global_step": global_step, "kind": "probe",
                     "picked": method, "scores": scores})
                if self.ledger is not None:
                    self.ledger.record_event(
                        "probe", stage=stage, step=global_step,
                        picked=method,
                        scores={m: float(sc) for m, sc in sorted(
                            scores.items())})
                self._log(f"probe picked method={method} ("
                          + ", ".join(f"{m}={sc:.4f}" for m, sc in
                                      sorted(scores.items())) + ")")
            if self.ledger is not None:
                self.ledger.record_event(
                    "hop.begin", stage=stage + 1, step=global_step,
                    src=st.cfg.name, dst=nxt.cfg.name,
                    method=method or nxt.growth.method)
            with obs.span("traj.grow", stage=stage + 1, src=st.cfg.name,
                          dst=nxt.cfg.name):
                stage, params, opt, grow_ms = self._grow_into(
                    stage + 1, params, opt, method=method)
            if self.ledger is not None:
                self.ledger.record_event(
                    "hop.complete", stage=stage, step=global_step,
                    src=st.cfg.name, dst=stages[stage].cfg.name)
            timing(stage)["grow_ms"] = grow_ms
            h_grow.observe(grow_ms)
            k = 0
            # post-growth snapshot (same global step, new stage meta): a
            # restart never redoes the hop
            save(stage, 0, global_step, block=True)
            shutil.rmtree(self._phase_dir, ignore_errors=True)


def run_trajectory(traj: TrajectoryConfig, *, ckpt_dir: str,
                   max_steps: Optional[int] = None, verbose: bool = True,
                   device="cuda") -> Dict[str, Any]:
    """One-shot convenience wrapper around :class:`TrajectoryRunner`."""
    return TrajectoryRunner(traj, ckpt_dir=ckpt_dir, verbose=verbose,
                            device=device).run(max_steps=max_steps)
