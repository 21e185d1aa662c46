"""Training driver: pretrain a small source model, grow it (LiGO by
default), then train the grown model with AdamW; or run a whole multi-stage
growth trajectory.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-medium \\
        --grow-from gpt2-base --method ligo --pretrain-steps 2 \\
        --ligo-steps 4 --steps 4 --batch 8 --seq 128

    # on the CPU, at smoke size:
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-base \\
        --smoke --grow-from half --device cpu

    # a resumable train→grow→train schedule with the compute ledger:
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --trajectory traj.json --ckpt-dir ckpt --ledger run.jsonl

    # the same under the adaptive growth controller ("steps": "auto"
    # stages with a policy block):
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --autogrow auto.json --ckpt-dir ckpt --ledger run.jsonl

The twin of the JAX launcher. With ``--grow-from`` (``half`` or an arch
name), the source model is initialised from ``--seed``, pretrained for
``--pretrain-steps`` AdamW steps, and grown by ``--method``; for LiGO the
operator is first trained for ``--ligo-steps`` SGD-momentum steps through
the GrowthPlan, so on the card every eligible leaf group runs kernel K1
forward and kernel K2 backward on every step. Without ``--grow-from`` the
model starts from a random init. Then ``--steps`` AdamW steps train it
under the :class:`~repro_torch.distributed.Supervisor`: with ``--ckpt-dir``
it checkpoints every ``--checkpoint-every`` steps and a relaunch resumes
from the newest checkpoint (refusing one of another arch or of a
trajectory). Batches are the synthetic corpus of ``data.batch_for_step``
(seed ``--seed`` for pretraining, ``+1`` for the LiGO phase, ``+10`` for the
main loop), made on the host and copied to the device.

``--trajectory cfg.json`` hands the run to
:class:`repro_torch.trajectory.TrajectoryRunner` (schema in
:mod:`repro_torch.trajectory.config`): its checkpoints under ``--ckpt-dir``
carry (trajectory hash, stage, stage step), so the same command relaunched
after a kill resumes where it stopped, mid-LiGO-phase included.
``--max-steps`` pauses after that many global train steps;
``--fail-at-ligo-step N`` kills the LiGO phase after its checkpoint at
phase step N (chaos testing). ``--ledger FILE`` (trajectories only: its
cursor rides the checkpoints) appends the compute ledger, one JSONL record
per train and LiGO step with modelled and measured FLOPs;
:func:`repro_torch.obs.savings_report` compares two of them.

``--autogrow cfg.json`` runs a schedule the same way under the adaptive
growth controller (:mod:`repro_torch.autogrow`): a ``"steps": "auto"``
stage ends when its ``policy`` block fires (``loss_plateau``,
``rpf_decay``, ``step_budget``) or at the policy's ``max_steps``, and a
``probe`` policy short-trains each candidate operator at the hop and
commits the best. One ``[train] autogrow decision: {...}`` line is printed
per decision. ``--trajectory`` and ``--autogrow`` are exclusive, and
``--trajectory`` refuses a schedule with auto stages.

The single-arch run prints the source loss, the LiGO losses (first →
last), ms per LiGO step, ms per train step, tokens/s and the K1/K2
launches; ``main`` returns them (or the runner's result).

Observability, as in the JAX launcher: ``--obs-log FILE`` streams the
``ligo.chunk`` / ``ligo.checkpoint`` spans and the ``traj.train`` /
``traj.grow`` stage walls as JSONL, closed by the final metric snapshot;
``--obs-report`` prints the summary at exit; ``--obs-profile DIR`` runs
under ``torch.profiler`` (CUDA activity on the card) and writes its Chrome
trace into DIR; ``--timeline FILE`` exports the span tree, with the
ledger's loss/FLOPs track when ``--ledger`` is set, as Chrome trace-event
JSON; ``--metrics-port N`` serves the registry at ``GET /metrics``.

Runs on CUDA unless ``--device cpu`` is given, and raises when there is no
CUDA device and no ``--device cpu``. Meshes are not ported.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import obs
from repro_torch.configs import (TrainConfig, get_config, half_config,
                                 smoke_config)
from repro_torch.core.grow import grow
from repro_torch.data import GlobalBatchLoader, batch_for_step
from repro_torch.data.synthetic import require_token_stream
from repro_torch.device import resolve_device
from repro_torch.distributed import Supervisor
from repro_torch.kernels import _build, ops
from repro_torch.launch import _obs
from repro_torch.models.model import init_params
from repro_torch.optim import adamw_init
from repro_torch.training import make_train_step, to_device

METHODS = ("ligo", "stackbert", "interpolation", "net2net", "bert2bert",
           "random")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _batches(cfg, batch: int, seq: int, seed: int, dev, start: int = 0):
    step = start
    while True:
        yield to_device(batch_for_step(cfg, step, batch, seq, seed=seed), dev)
        step += 1


def _run_steps(step_fn, params, opt, cfg, args, seed: int, n: int, dev,
               label: str):
    """``n`` timed train steps; returns (params, opt, losses, step ms)."""
    losses: List[float] = []
    times: List[float] = []
    data = _batches(cfg, args.batch, args.seq, seed, dev)
    for i in range(n):
        batch = next(data)
        _sync(dev)
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch, i)
        losses.append(float(m["total"]))
        times.append((time.perf_counter() - t0) * 1e3)
        if i % 20 == 0 or i == n - 1:
            print(f"[train] {label} step {i:5d} loss {losses[-1]:.4f} "
                  f"lr {m['lr']:.2e} gnorm {float(m['grad_norm']):.2f}",
                  flush=True)
    return params, opt, losses, times


def _steady_ms(times: List[float]) -> float:
    """Median step time, leaving out the first step (warm-up) when there
    are others."""
    return statistics.median(times[1:] if len(times) > 1 else times)


def _trajectory(args) -> Dict[str, Any]:
    from repro_torch.trajectory import TrajectoryConfig, TrajectoryRunner
    if not args.ckpt_dir:
        flag = "--autogrow" if args.autogrow else "--trajectory"
        raise SystemExit(f"{flag} needs --ckpt-dir: its checkpoints are "
                         "what a relaunch resumes from")
    traj = TrajectoryConfig.from_json(args.trajectory or args.autogrow)
    if args.trajectory and traj.has_auto_stages:
        raise SystemExit(
            "the schedule has steps='auto' stages — run it with "
            "--autogrow (the adaptive controller) instead of "
            "--trajectory")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        _build.build()
    print(f"[train] trajectory {traj.hash()}: "
          f"{' -> '.join(st.cfg.name for st in traj.stages)} "
          f"({'<=' if traj.has_auto_stages else ''}{traj.total_steps} "
          f"steps) device={dev}", flush=True)
    launches0 = ops.launch_counts()
    res = TrajectoryRunner(traj, ckpt_dir=args.ckpt_dir,
                           keep=args.keep_checkpoints,
                           ligo_fail_at=args.fail_at_ligo_step,
                           device=dev).run(max_steps=args.max_steps)
    counts = ops.launch_counts()
    res["launches"] = {k: counts[k] - launches0[k] for k in counts}
    for d in res["decisions"]:
        print(f"[train] autogrow decision: {d}", flush=True)
    print(f"[train] trajectory {res['status']}: stage "
          f"{res['stage'] + 1}/{len(traj.stages)} ({res['cfg'].name}) "
          f"global_step={res['global_step']} "
          f"final_loss={res['history'][-1][2]:.4f}"
          if res["history"] else
          f"[train] trajectory {res['status']} (no steps run)", flush=True)
    return res


def _resume_meta(sup: Supervisor, cfg) -> None:
    """Refuse a ``--ckpt-dir`` that holds a trajectory or another arch,
    before any restore (which would die on shapes first)."""
    meta = sup.mgr.latest_meta()
    if meta is None:
        return
    if "trajectory" in meta:
        raise SystemExit(
            f"--ckpt-dir holds a trajectory checkpoint (stage "
            f"{meta.get('stage')}); resume it with --trajectory")
    if meta.get("config", cfg.config_hash()) != cfg.config_hash():
        raise SystemExit(
            f"--ckpt-dir holds a checkpoint of {meta.get('arch', '?')} "
            f"({meta.get('config')}), not {cfg.name} ({cfg.config_hash()}) "
            f"— refusing to resume")


def _train(args) -> Dict[str, Any]:
    if args.trajectory and args.autogrow:
        raise SystemExit("--trajectory and --autogrow are exclusive "
                         "(they name the same schedule file)")
    if args.trajectory or args.autogrow:
        return _trajectory(args)
    if not args.arch:
        raise SystemExit("--arch is required (or pass --trajectory)")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    try:
        require_token_stream(cfg, "train")
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if cfg.objective != "clm":
        raise SystemExit("the train driver runs CLM archs")
    tcfg = TrainConfig(steps=args.steps, warmup_steps=max(args.steps // 20, 5),
                       lr=args.lr, seq_len=args.seq, global_batch=args.batch,
                       checkpoint_every=args.checkpoint_every,
                       keep_checkpoints=args.keep_checkpoints)
    if dev.type == "cuda":
        _build.build()
    print(f"[train] arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"device={dev}", flush=True)
    res: Dict[str, Any] = {"device": str(dev), "cfg": cfg}
    launches0 = ops.launch_counts()

    if args.grow_from:
        small_cfg = (half_config(cfg) if args.grow_from == "half"
                     else smoke_config(get_config(args.grow_from))
                     if args.smoke else get_config(args.grow_from))
        print(f"[train] pretraining source {small_cfg.name} "
              f"({small_cfg.param_count() / 1e6:.1f}M) for "
              f"{args.pretrain_steps} steps", flush=True)
        with torch.no_grad():
            sp = init_params(small_cfg,
                             torch.Generator(device=dev).manual_seed(args.seed),
                             device=dev)
        sp, _, s_losses, _ = _run_steps(
            make_train_step(small_cfg, tcfg), sp, adamw_init(sp), small_cfg,
            args, args.seed, args.pretrain_steps, dev, "source")
        if s_losses:
            print(f"[train] source loss {s_losses[-1]:.4f}")
        ligo_ms: List[float] = []
        params, info = grow(
            sp, small_cfg, cfg, method=args.method,
            gen=torch.Generator(device=dev).manual_seed(args.seed + 2),
            data_it=_batches(small_cfg, args.batch, args.seq, args.seed + 1,
                             dev),
            ligo_steps=args.ligo_steps, ligo_step_ms=ligo_ms)
        res.update(small_cfg=small_cfg, small=sp, source_losses=s_losses,
                   grow_info=info, ligo_losses=info.get("ligo_losses", []),
                   ligo_step_ms=ligo_ms)
        if ligo_ms:
            ll = info["ligo_losses"]
            print(f"[train] LiGO phase: {ll[0]:.4f} -> {ll[-1]:.4f} "
                  f"({len(ll)} steps) | {_steady_ms(ligo_ms):.1f} ms per "
                  f"LiGO step (median, first step left out)", flush=True)
    else:
        with torch.no_grad():
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(args.seed),
                device=dev)

    # checkpoints carry the run's identity; a relaunch refuses another
    # arch's or a trajectory's, and lands on the recorded step
    run_meta = {"arch": cfg.name, "config": cfg.config_hash()}
    sup = Supervisor(ckpt_dir=args.ckpt_dir,
                     checkpoint_every=args.checkpoint_every,
                     keep=args.keep_checkpoints)
    state = {"params": params, "opt": adamw_init(params)}
    start = 0
    if sup.mgr is not None:
        _resume_meta(sup, cfg)
        restored = sup.resume(state)
        if restored is not None:
            state, meta = restored
            start = int(meta.get("step", 0))
            print(f"[train] resumed {meta.get('arch', cfg.name)} from step "
                  f"{start}", flush=True)

    def on_metrics(step, m):
        if step % 20 == 0 or step == args.steps - 1:
            print(f"[train] main step {step:5d} loss {float(m['total']):.4f} "
                  f"lr {m['lr']:.2e} gnorm {float(m['grad_norm']):.2f}",
                  flush=True)

    loader = GlobalBatchLoader(cfg, args.batch, args.seq,
                               seed=args.seed + 10, device=dev)
    state = sup.run(state, make_train_step(cfg, tcfg), loader.batch_at,
                    start_step=start, steps=args.steps,
                    on_metrics=on_metrics, meta=run_meta)
    losses = [h[1] for h in sup.history]
    times = [h[2] * 1e3 for h in sup.history]
    counts = ops.launch_counts()
    launches = {k: counts[k] - launches0[k] for k in counts}
    res.update(params=state["params"], train_losses=losses,
               train_step_ms=times, launches=launches,
               stragglers=len(sup.watchdog.flagged), restarts=sup.restarts)
    if times:
        ms = _steady_ms(times)
        res.update(train_ms=ms, tok_s=args.batch * args.seq / (ms / 1e3))
        print(f"[train] {len(times)} steps of {cfg.name}: final loss "
              f"{losses[-1]:.4f} | {ms:.1f} ms per train step (median, first "
              f"step left out) | {res['tok_s']:.0f} tokens/s | stragglers "
              f"{res['stragglers']}, restarts {sup.restarts}", flush=True)
    print(f"[train] kernel launches: K1 "
          f"{launches['ligo_blend_expand_grouped']}, K2 "
          f"{launches['ligo_blend_expand_bwd_fused']}, K3 "
          f"{launches['flash_attention']}", flush=True)
    return res


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="train the smoke-reduced config of --arch")
    ap.add_argument("--trajectory", default=None, metavar="CFG_JSON",
                    help="run a multi-stage growth trajectory from a JSON "
                         "stage schedule; resumable via --ckpt-dir")
    ap.add_argument("--autogrow", default=None, metavar="CFG_JSON",
                    help="like --trajectory, with the adaptive growth "
                         "controller enabled: stages may use steps='auto' "
                         "+ a policy block (loss_plateau / rpf_decay / "
                         "probe) and the LiGO phase checkpoints its own "
                         "carry, so a kill mid-hop resumes mid-phase")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="trajectory only: stop (checkpointing) after this "
                         "many global train steps; a relaunch resumes")
    ap.add_argument("--fail-at-ligo-step", type=int, default=None,
                    help="chaos testing: raise after the LiGO-phase "
                         "checkpoint at this phase step")
    ap.add_argument("--grow-from", default=None,
                    help="'half' or an arch name: grow instead of cold start")
    ap.add_argument("--method", default="ligo", choices=METHODS)
    ap.add_argument("--ligo-steps", type=int, default=100)
    ap.add_argument("--pretrain-steps", type=int, default=100,
                    help="AdamW steps that pretrain the small source")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (required with --trajectory; "
                         "without it a single-arch run writes none)")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--keep-checkpoints", type=int, default=3,
                    help="how many of the newest checkpoints stay on disk")
    ap.add_argument("--ledger", default=None, metavar="FILE",
                    help="append the compute ledger to FILE: one JSONL "
                         "record per train/LiGO step (loss, tokens, modelled "
                         "and measured cumulative FLOPs) plus hop/probe "
                         "events. Requires --trajectory/--autogrow: the "
                         "ledger cursor rides the checkpoints, so a killed "
                         "run resumes record-identical")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for explicitly")
    _obs.add_args(ap, "stream span/event records as JSONL to FILE "
                      "(ligo.chunk/checkpoint spans, traj.train/grow stage "
                      "walls), closed by the final metric snapshot")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train once; returns the results (trees, losses, times, launches).
    With ``--metrics-port`` the result's ``metrics_server`` is the running
    ``/metrics`` server, which the caller stops with ``shutdown()``."""
    args = parse_args(argv)
    if args.ledger and not (args.trajectory or args.autogrow):
        raise SystemExit("--ledger requires --trajectory/--autogrow: the "
                         "trajectory runner owns the cursor-in-checkpoint "
                         "contract that makes the ledger crash-safe")
    srv = _obs.start_metrics(args)
    if args.ledger:
        obs.attach_ledger(args.ledger)
    if args.obs_log:
        obs.attach_jsonl(args.obs_log)
    try:
        with obs.profile(args.obs_profile, device=args.device):
            res = _train(args)
    finally:
        _obs.close(args)
    res["metrics_server"] = srv
    return res


if __name__ == "__main__":
    main()
