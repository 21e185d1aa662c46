"""The training-FLOP model of the JAX package's ``roofline/analysis.py``.

Only :func:`train_flops_per_step` is ported: the compute ledger integrates
it as its ``modelled`` column. The HLO walker and the per-cell roofline are
XLA machinery with no counterpart here.
"""
from __future__ import annotations


def train_flops_per_step(cfg, global_batch: int, seq_len: int) -> float:
    """``6·N_active·tokens`` for one optimizer step."""
    return 6.0 * cfg.active_param_count() * global_batch * seq_len
