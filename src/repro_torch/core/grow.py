"""High-level growth API and the LiGO training phase (paper §3.2,
"Training"), the twin of the JAX package's ``core/grow.py``.

``grow(...)`` covers the methods the paper compares:

- ``"ligo"``: initialise the LiGO operator, run ``ligo_steps`` of
  SGD-with-momentum on the task loss *through* the growth operator (Θ_small
  frozen), materialise Θ_large;
- ``"stackbert"``, ``"interpolation"``, ``"net2net"``, ``"bert2bert"``,
  ``"lemon"``: classical operators, no learning;
- ``"upcycle"``: dense→MoE sparse upcycling (``core/upcycle.py``), every
  expert a copy of the dense FFN and the router zero;
- ``"random"``: a fresh init of the large model (the from-scratch baseline).

The LiGO phase is a Python loop of (loss, backward, momentum, SGD) over the
operator tree alone. The growth operator runs through the GrowthPlan, so on
CUDA tensors every kernel-eligible leaf group goes forward through kernel K1
and backward through kernel K2 on every step. The JAX package compiles the
phase into ``lax.scan`` chunks; the port keeps its Python loop but the
chunk boundaries, phase checkpoints, injected failures and compute ledger
follow the JAX package's: see :func:`train_ligo`.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import operators as ops
from repro_torch.core.ligo import apply_ligo, init_ligo_params
from repro_torch.models.losses import loss_fn
from repro_torch.tree import same_structure, tree_leaves, tree_map


def ligo_loss(ligo, small_params, cfg1: ModelConfig, cfg2: ModelConfig,
              batch, *, loss_chunk: int = 0, engine: str = "plan",
              use_kernel: Optional[bool] = None) -> torch.Tensor:
    big = apply_ligo(ligo, small_params, cfg1, cfg2, engine=engine,
                     use_kernel=use_kernel)
    loss, _ = loss_fn(big, cfg2, batch, loss_chunk=loss_chunk)
    return loss


def batch_geometry(batch: Dict[str, torch.Tensor]) -> Tuple[int, int]:
    """(batch size, tokens a row) of a batch, as the JAX package's ledger
    reads them: from ``tokens``, else from the leaf with the most
    dimensions in key order (a vision batch's patches: B x num_patches - 1).
    """
    leaf = batch.get("tokens")
    if leaf is None:
        leaf = max((batch[k] for k in sorted(batch)), key=lambda x: x.dim())
    return int(leaf.shape[0]), int(leaf.shape[1])


def _ligo_phase_id(cfg1: ModelConfig, cfg2: ModelConfig, steps: int,
                   lr: float, momentum: float,
                   phase_meta: Optional[Dict]) -> Dict:
    """Identity stamped on (and validated against) every phase checkpoint:
    a carry from another hop, budget or schedule is never resumed into this
    phase (it is ignored, and the phase starts fresh). The same fields as
    the JAX package's, so either package resumes the other's phase."""
    pid = {"ligo_cfg1": cfg1.config_hash(), "ligo_cfg2": cfg2.config_hash(),
           "ligo_steps": int(steps), "ligo_lr": float(lr),
           "ligo_momentum": float(momentum)}
    pid.update(phase_meta or {})
    return pid


def ligo_chunk(steps: int, scan_chunk: int = 0) -> int:
    """Steps per chunk of the phase: ``scan_chunk`` when given, else the
    JAX package's rule (its scan length): the largest divisor of ``steps``
    in [16, 32], or 32 with a ragged tail when there is none. Chunk
    boundaries are where the phase checkpoints, fails on request and
    resumes."""
    if scan_chunk > 0:
        return scan_chunk
    chunk = min(steps, 32)
    while chunk > 16 and steps % chunk:
        chunk -= 1
    if steps % chunk:
        chunk = min(steps, 32)
    return chunk


def train_ligo(ligo, small_params, cfg1: ModelConfig, cfg2: ModelConfig,
               data_it: Iterator[Dict[str, torch.Tensor]], *,
               steps: int = 100, lr: float = 1e-3, momentum: float = 0.9,
               loss_chunk: int = 0, log_every: int = 0, engine: str = "plan",
               scan_chunk: int = 0, phase_ckpt=None,
               phase_meta: Optional[Dict] = None,
               checkpoint_every_chunks: int = 1,
               fail_at: Optional[int] = None, ledger=None,
               ledger_ctx: Optional[Dict] = None,
               step_ms: Optional[List[float]] = None
               ) -> Tuple[Dict, List[float]]:
    """The SGD phase that optimises only the LiGO operator.

    Returns ``(ligo, losses)``: a new operator tree (the input is left as it
    was) and each step's loss. When ``step_ms`` is a list, each step's wall
    time (host clock, from the batch in hand to the updated operator,
    synchronised by reading the loss) is appended to it.

    The steps run in a Python loop, grouped in chunks of
    :func:`ligo_chunk` steps, the JAX package's scan chunks, whose
    boundaries this phase keeps:

    - **elastic phase** (``phase_ckpt``, a :class:`repro_torch.checkpoint.
      CheckpointManager`): the ``(ligo, mom)`` carry is checkpointed (async,
      one device copy) every ``checkpoint_every_chunks`` chunk boundaries,
      stamped with the phase identity (:func:`_ligo_phase_id`: the config
      pair, budget, schedule and the caller's ``phase_meta``). A later call
      with the same arguments restores the carry and goes on from the last
      checkpointed step; a checkpoint of another identity is ignored. The
      resume draws and discards the spent batches, so step k sees the same
      batch as in an uninterrupted run.
    - ``fail_at``: after the first chunk boundary ``>= fail_at`` the phase
      checkpoints (off cadence too), waits for the write, then raises: the
      deterministic mid-phase kill of the tests and ``chip_smoke.py``.
    - **ledger** (a :class:`repro_torch.obs.ledger.RunLedger`): every step
      lands as a ``phase="ligo"`` record, with FLOPs from the measured-cost
      pass over one step (:func:`repro_torch.obs.costs.measure_step`). On a
      resume the spent steps' records are re-emitted from the checkpoint's
      losses with ``wall_ms`` 0, so the ledger ends record for record equal
      to an uninterrupted run's. ``ledger_ctx`` carries ``{"stage"}``.
    - **spans** (the JAX package's): one ``ligo.chunk`` span (``start``,
      ``n``) a chunk, feeding the ``ligo.chunk_ms`` histogram; one
      ``ligo.checkpoint`` span (``step``) a phase checkpoint, feeding
      ``ligo.checkpoint_ms``; a ``ligo.resume`` event on a resume.
    """
    from repro_torch.training import value_and_grad

    def sgd_step(op, mom, batch, small):
        def step_loss(o, b):
            return ligo_loss(o, small, cfg1, cfg2, b, loss_chunk=loss_chunk,
                             engine=engine), {}
        (loss, _), grads = value_and_grad(step_loss, op, batch)
        with torch.no_grad():
            mom = tree_map(lambda m, g: momentum * m + g, mom, grads)
            op = tree_map(lambda p, m: p - lr * m, op, mom)
        return op, mom, loss

    if steps <= 0:
        return ligo, []
    chunk = ligo_chunk(steps, scan_chunk)

    # ---- elastic-phase restore ------------------------------------------
    mom = tree_map(torch.zeros_like, ligo)
    losses: List[float] = []
    start = 0
    pid = _ligo_phase_id(cfg1, cfg2, steps, lr, momentum, phase_meta)
    if phase_ckpt is not None:
        saved = phase_ckpt.latest_meta()
        if saved is not None and all(saved.get(k) == v
                                     for k, v in pid.items()):
            state, _ = phase_ckpt.restore(phase_ckpt.latest_step(),
                                          {"ligo": ligo, "mom": mom})
            ligo, mom = state["ligo"], state["mom"]
            start = int(saved["phase_step"])
            losses = [float(x) for x in saved.get("losses", [])][:start]
            print(f"[ligo] resumed LiGO phase at step {start}/{steps}",
                  flush=True)
            obs.event("ligo.resume", step=start, steps=steps)

    peek = None
    for _ in range(start):          # deterministic resume: skip spent batches
        b = next(data_it)
        if peek is None:
            peek = b                # shape witness for the measured pass

    # ---- compute ledger: measured-cost pass + per-step records ----------
    led_stage = int((ledger_ctx or {}).get("stage", 0))
    led: Dict[str, Any] = {"tokens": None}

    def ledger_prepare(batch) -> None:
        """Model and measure one LiGO step, once per phase."""
        from repro_torch.obs import costs
        from repro_torch.roofline import train_flops_per_step
        bsz, seq = batch_geometry(batch)
        led["tokens"] = float(bsz * seq)
        led["fps_model"] = train_flops_per_step(cfg2, bsz, seq)
        led["meas_fps"] = costs.measure_step(
            f"ligo_step[{cfg2.name}]", sgd_step, ligo, mom, batch,
            small_params, modelled_flops=led["fps_model"])["flops_per_unit"]

    def ledger_step(step: int, loss: float, wall_ms: float) -> None:
        ledger.record_step(
            phase="ligo", stage=led_stage, arch=cfg2.name, step=step,
            loss=loss, tokens=led["tokens"], wall_ms=wall_ms,
            flops_modelled=led["fps_model"], flops_measured=led["meas_fps"])

    if ledger is not None and start > 0:
        # the trajectory runner truncated the ledger to its last checkpoint
        # (before this hop): rebuild the spent steps' records
        ledger_prepare(peek)
        for s, lv in enumerate(losses):
            ledger_step(s, lv, 0.0)

    done = start
    chunks_done = 0
    h_chunk = obs.histogram("ligo.chunk_ms")
    h_ckpt = obs.histogram("ligo.checkpoint_ms")
    while done < steps:
        n = min(chunk, steps - done)
        # a host wall: each float(loss) waits for its step, so the span
        # closes after the chunk's last step has finished on the device
        with obs.span("ligo.chunk", start=done, n=n) as sp_chunk:
            for s in range(done, done + n):
                batch = next(data_it)
                if ledger is not None and led["tokens"] is None:
                    ledger_prepare(batch)
                t0 = time.perf_counter()
                ligo, mom, loss = sgd_step(ligo, mom, batch, small_params)
                losses.append(float(loss))
                ms = (time.perf_counter() - t0) * 1e3
                if step_ms is not None:
                    step_ms.append(ms)
                if ledger is not None:
                    ledger_step(s, losses[-1], ms)
                if log_every and s % log_every == 0:
                    print(f"[ligo] step {s:4d} loss {losses[-1]:.4f}")
        h_chunk.observe(sp_chunk.dur_ms or 0.0)
        done += n
        chunks_done += 1
        failing = fail_at is not None and fail_at <= done < steps
        if (phase_ckpt is not None and done < steps
                and (chunks_done % max(checkpoint_every_chunks, 1) == 0
                     or failing)):
            # the span covers the enqueue: the device copy and the write
            # run behind it
            with obs.span("ligo.checkpoint", step=done) as sp_ckpt:
                phase_ckpt.save(done, {"ligo": ligo, "mom": mom},
                                {**pid, "phase_step": done,
                                 "losses": list(losses)}, snapshot="device")
            h_ckpt.observe(sp_ckpt.dur_ms or 0.0)
        if failing:
            if phase_ckpt is not None:
                phase_ckpt.wait()          # the injected kill is durable
            raise RuntimeError(
                f"injected LiGO-phase failure at step {done}/{steps}")
    if phase_ckpt is not None:
        phase_ckpt.wait()
    return ligo, losses


def _validate_opt_state(opt_state, small_params) -> None:
    """Refuse optimizer state that cannot ride a growth operator, with a
    message rather than a shape error inside the growth plan."""
    if opt_state is None:
        return
    missing = [f for f in ("m", "v", "count")
               if getattr(opt_state, f, None) is None]
    if missing:
        raise ValueError(f"opt_state is missing {missing}: not a "
                         f"grow-compatible AdamWState; start the grown stage "
                         f"fresh with grow_optimizer=False / opt_state=None")
    for name in ("m", "v"):
        if not same_structure(getattr(opt_state, name), small_params):
            raise ValueError(f"opt_state.{name} does not mirror the source "
                             f"parameter tree; pass grow_optimizer=False to "
                             f"reset the moments after the hop")


def grow(small_params, cfg1: ModelConfig, cfg2: ModelConfig, *,
         method: str = "ligo", gen: Optional[torch.Generator] = None,
         data_it: Optional[Iterator] = None, ligo_steps: int = 100,
         ligo_lr: float = 1e-3, ligo_momentum: float = 0.9,
         loss_chunk: int = 0, depth_init: str = "stack",
         engine: str = "plan", opt_state=None, grow_optimizer: bool = True,
         apply: bool = True, ligo_ckpt=None,
         ligo_meta: Optional[Dict] = None, ligo_scan_chunk: int = 0,
         ligo_fail_at: Optional[int] = None, ligo_ledger=None,
         ligo_ledger_ctx: Optional[Dict] = None,
         ligo_step_ms: Optional[List[float]] = None,
         ) -> Tuple[Optional[Dict], Dict[str, Any]]:
    """Grow Θ_small → Θ_large. Returns ``(big_params, info)``.

    Everything is made on the device of ``small_params``; random draws come
    from ``gen`` (a generator on that device; seed 0 when None). ``info``
    holds ``"method"``, the ``"operator"`` applied, and for LiGO the
    starting operator (``"operator_init"``) and the phase's
    ``"ligo_losses"``. An AdamW ``opt_state`` of the small model comes back
    grown in ``info["opt_state"]`` (:func:`repro_torch.optim.
    grow_adamw_state`); ``method="random"`` or ``grow_optimizer=False``
    gives a fresh ``adamw_init`` instead. ``apply=False`` builds (and for
    LiGO trains) the operator and returns ``(None, info)``.

    ``ligo_ckpt``/``ligo_meta``/``ligo_scan_chunk``/``ligo_fail_at`` make
    the LiGO phase elastic and ``ligo_ledger``/``ligo_ledger_ctx`` give its
    steps to the compute ledger: they are :func:`train_ligo`'s
    ``phase_ckpt``, ``phase_meta``, ``scan_chunk``, ``fail_at``, ``ledger``
    and ``ledger_ctx``.
    """
    from repro_torch.optim import adamw_init, grow_adamw_state
    dev = tree_leaves(small_params)[0].device
    gen = gen if gen is not None else torch.Generator(device=dev).manual_seed(0)
    info: Dict[str, Any] = {"method": method}
    _validate_opt_state(opt_state, small_params)
    if method == "random":
        from repro_torch.models.model import init_params
        with torch.no_grad():
            big = init_params(cfg2, gen, device=dev)
        if opt_state is not None:
            info["opt_state"] = adamw_init(big)
        return big, info
    if method == "stackbert":
        op = ops.stackbert_operator(cfg1, cfg2, gen, device=dev)
    elif method == "interpolation":
        op = ops.interpolation_operator(cfg1, cfg2, gen, device=dev)
    elif method == "net2net":
        op = ops.net2net_operator(gen, cfg1, cfg2, device=dev)
    elif method == "bert2bert":
        op = ops.bert2bert_operator(gen, cfg1, cfg2, device=dev)
    elif method == "lemon":
        op = ops.lemon_operator(cfg1, cfg2, device=dev)
    elif method == "upcycle":
        from repro_torch.core.upcycle import upcycle_operator
        op = upcycle_operator(cfg1, cfg2, device=dev)
    elif method == "gqa_merge":
        op = ops.gqa_merge_operator(cfg1, cfg2, device=dev)
    elif method == "ligo":
        op = init_ligo_params(gen, cfg1, cfg2, device=dev,
                              depth_init=depth_init)
        info["operator_init"] = op
        if ligo_steps and data_it is not None:
            op, info["ligo_losses"] = train_ligo(
                op, small_params, cfg1, cfg2, data_it, steps=ligo_steps,
                lr=ligo_lr, momentum=ligo_momentum, loss_chunk=loss_chunk,
                engine=engine, scan_chunk=ligo_scan_chunk,
                phase_ckpt=ligo_ckpt, phase_meta=ligo_meta,
                fail_at=ligo_fail_at, ledger=ligo_ledger,
                ledger_ctx=ligo_ledger_ctx, step_ms=ligo_step_ms)
    else:
        raise ValueError(f"unknown or unported growth method {method!r}")
    info["operator"] = op
    if not apply:
        return None, info
    with torch.no_grad():
        big = apply_ligo(op, small_params, cfg1, cfg2, engine=engine)
    if opt_state is not None:
        info["opt_state"] = (grow_adamw_state(opt_state, op, cfg1, cfg2,
                                              engine=engine)
                             if grow_optimizer else adamw_init(big))
    return big, info
