"""Measured-cost pass: reconcile the 6ND model against the operations a step
really runs (the twin of the JAX package's ``obs/costs.py``).

The JAX package reads XLA's ``cost_analysis()`` of the compiled program.
The port has no compiled program, so it counts one call of the step
function under ``torch.utils.flop_counter.FlopCounterMode``, once per
program and outside the timed steps: the call runs on fake copies of the
inputs (``FakeTensorMode``: shape, dtype and device, no storage), so it
takes no device time, launches nothing and changes no state. A fake tensor
keeps its device, so the step takes the route its real inputs take:
kernels K1 and K2 for CUDA inputs, whose custom operators count their
operations in the min-FLOP order their bounds use
(:mod:`repro_torch.kernels.ops`), and the plain versions, counted op by op,
for CPU inputs.

Every measurement lands in :data:`MEASUREMENTS` and sets the
``ledger.flops.measured`` / ``ledger.flops.modelled`` /
``ledger.flops.ratio`` gauges. Consumers (the trajectory runner, the LiGO
phase) use ``flops_per_unit`` as the per-step increment of the ledger's
measured column. The same program on the same shapes gives the same count,
so a resumed run reproduces the measured column exactly.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_map_only
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.obs import metrics as _metrics

__all__ = ["measure_step", "measurement", "MEASUREMENTS",
           "clear_measurements"]

_LOCK = threading.Lock()

#: name -> latest measurement dict for that program.
MEASUREMENTS: Dict[str, Dict[str, Any]] = {}


def clear_measurements() -> None:
    with _LOCK:
        MEASUREMENTS.clear()


def measurement(name: str) -> Optional[Dict[str, Any]]:
    with _LOCK:
        return MEASUREMENTS.get(name)


def measure_step(name: str, fn, *args,
                 modelled_flops: Optional[float] = None,
                 per_call_units: float = 1.0) -> Dict[str, Any]:
    """Count the operations of one call ``fn(*args)``; ``args`` are the
    step's real inputs (not changed: the call runs on fake copies).

    ``per_call_units`` is how many ledger units (train or LiGO steps) one
    call advances; ``modelled_flops`` is the 6ND prediction for one call,
    which gives the reconciliation ratio. Returns the measurement dict.
    """
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    with FakeTensorMode() as fake:
        fake_args = tree_map_only(torch.Tensor, fake.from_tensor, args)
        with FlopCounterMode(display=False) as counter:
            fn(*fake_args)
    pass_ms = (time.perf_counter() - t0) * 1e3
    flops = float(counter.get_total_flops())
    by_op = counter.get_flop_counts().get("Global", {})
    kernels = float(sum(by_op.get(k, 0) for k in ops.KERNEL_OPS))
    units = max(float(per_call_units), 1e-12)
    rec: Dict[str, Any] = {
        "name": name, "flops": flops, "flops_aten": flops - kernels,
        "flops_kernels": kernels,
        "per_call_units": float(per_call_units),
        "flops_per_unit": flops / units, "pass_ms": pass_ms,
    }
    if modelled_flops is not None and modelled_flops > 0:
        rec["modelled_flops"] = float(modelled_flops)
        rec["ratio"] = flops / float(modelled_flops)
    with _LOCK:
        MEASUREMENTS[name] = rec
    _metrics.gauge("ledger.flops.measured").set(rec["flops_per_unit"])
    if "ratio" in rec:
        _metrics.gauge("ledger.flops.modelled").set(
            float(modelled_flops) / units)
        _metrics.gauge("ledger.flops.ratio").set(rec["ratio"])
    return rec
