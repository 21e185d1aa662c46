"""Global on/off switch for the observability layer (the JAX package's
``obs/_state.py``).

One module so :mod:`repro_torch.obs.trace` and
:mod:`repro_torch.obs.metrics` can share it without importing each other.
Disabling turns ``span()`` into a fresh no-op context manager and makes
counter, gauge and histogram writes return early.

:class:`repro_torch.obs.metrics.CounterGroup` increments are *not* gated:
the counter groups are functional instrumentation that tests assert on,
so they keep counting when the layer is switched off.
"""
from __future__ import annotations

_ENABLED = True


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED
