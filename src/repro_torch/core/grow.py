"""High-level growth API and the LiGO training phase (paper §3.2,
"Training"), the twin of the JAX package's ``core/grow.py``.

``grow(...)`` covers the methods the paper compares:

- ``"ligo"``: initialise the LiGO operator, run ``ligo_steps`` of
  SGD-with-momentum on the task loss *through* the growth operator (Θ_small
  frozen), materialise Θ_large;
- ``"stackbert"``, ``"interpolation"``, ``"net2net"``, ``"bert2bert"``:
  classical operators, no learning;
- ``"random"``: a fresh init of the large model (the from-scratch baseline).

The LiGO phase is a Python loop of (loss, backward, momentum, SGD) over the
operator tree alone. The growth operator runs through the GrowthPlan, so on
CUDA tensors every kernel-eligible leaf group goes forward through kernel K1
and backward through kernel K2 on every step. The JAX package's compiled
``lax.scan`` chunks, phase checkpoints, injected failures and compute
ledger are not ported yet.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

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


def train_ligo(ligo, small_params, cfg1: ModelConfig, cfg2: ModelConfig,
               data_it: Iterator[Dict[str, torch.Tensor]], *,
               steps: int = 100, lr: float = 1e-3, momentum: float = 0.9,
               loss_chunk: int = 0, log_every: int = 0, engine: str = "plan",
               step_ms: Optional[List[float]] = None
               ) -> Tuple[Dict, List[float]]:
    """The SGD phase that optimises only the LiGO operator.

    Returns ``(ligo, losses)``: a new operator tree (the input is left as it
    was) and each step's loss. When ``step_ms`` is a list, each step's wall
    time (host clock, from the batch in hand to the updated operator,
    synchronised by reading the loss) is appended to it.
    """
    from repro_torch.training import value_and_grad

    def step_loss(op, batch):
        return ligo_loss(op, small_params, cfg1, cfg2, batch,
                         loss_chunk=loss_chunk, engine=engine), {}

    if steps <= 0:
        return ligo, []
    mom = tree_map(torch.zeros_like, ligo)
    losses: List[float] = []
    for s in range(steps):
        batch = next(data_it)
        t0 = time.perf_counter()
        (loss, _), grads = value_and_grad(step_loss, ligo, batch)
        with torch.no_grad():
            mom = tree_map(lambda m, g: momentum * m + g, mom, grads)
            ligo = tree_map(lambda p, m: p - lr * m, ligo, mom)
        losses.append(float(loss))
        if step_ms is not None:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if log_every and s % log_every == 0:
            print(f"[ligo] step {s:4d} loss {losses[-1]:.4f}")
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
         apply: bool = True, ligo_step_ms: Optional[List[float]] = None,
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
    elif method == "ligo":
        op = init_ligo_params(gen, cfg1, cfg2, device=dev,
                              depth_init=depth_init)
        info["operator_init"] = op
        if ligo_steps and data_it is not None:
            op, info["ligo_losses"] = train_ligo(
                op, small_params, cfg1, cfg2, data_it, steps=ligo_steps,
                lr=ligo_lr, momentum=ligo_momentum, loss_chunk=loss_chunk,
                engine=engine, step_ms=ligo_step_ms)
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
