"""The compute ledger: durable loss-vs-FLOPs accounting for a whole run
(the twin of the JAX package's ``obs/ledger.py``; records are byte for byte
the reference's for the same values).

The paper's headline metric, FLOPs to reach a target loss for a grown run
against one trained from scratch, is a statement about two curves: loss
against cumulative compute. A :class:`RunLedger` makes one such curve a
durable artifact: an append-only JSONL file with one record per train or
LiGO step::

    {"type": "step", "run_id": ..., "phase": "train"|"ligo", "stage": 0,
     "arch": "tr0", "step": 12, "loss": 3.21, "tokens": 512.0,
     "wall_ms": 1.8, "flops_modelled": 6.1e9, "flops_measured": 5.8e9,
     "cum_flops_modelled": 7.3e10, "cum_flops_measured": 7.0e10,
     "measured": true}

plus event records (``hop.begin``, ``hop.complete``), each a line of
``json.dumps(rec, sort_keys=True, separators=(",", ":"))``.

Crash safety: the ledger's *cursor* (byte offset, record count, cumulative
sums; :meth:`RunLedger.snapshot`, which flushes and fsyncs first) rides in
every trajectory checkpoint's meta. On resume :meth:`RunLedger.restore`
truncates the file back to the checkpointed offset, dropping any tail
written after the checkpoint (a torn line included), and the re-executed
steps append the same records, so the file ends record for record equal
to an uninterrupted run's. ``wall_ms`` and ``run_id`` are the only fields
that differ by design; compare ledgers with :func:`normalize_records`.

``cum_flops_modelled`` integrates the 6ND model
(:func:`repro_torch.roofline.train_flops_per_step`); ``cum_flops_measured``
integrates the per-step FLOPs of the measured-cost pass
(:mod:`repro_torch.obs.costs`) where there is one, the modelled number
otherwise (``"measured"`` says which).

:func:`savings_report` computes the paper's metric from two ledgers. A
baseline that never reaches the target is *censored*: its total spend is a
lower bound on its cost, and the report says so.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Union

from repro_torch.obs import metrics as _metrics

__all__ = [
    "RunLedger", "attach_ledger", "active_ledger", "detach_ledger",
    "read_ledger", "normalize_records", "savings_report",
]

_LOCK = threading.Lock()
_ACTIVE: Optional["RunLedger"] = None

#: Fields that are measurements of the host environment rather than run
#: state — masked by :func:`normalize_records` before identity checks.
NONDETERMINISTIC_FIELDS = ("wall_ms", "run_id")


class RunLedger:
    """Append-only JSONL ledger with a checkpoint-portable cursor.

    The file is only ever touched by :meth:`restore` (truncate to the
    cursor) and the ``record_*`` appends; creating a ``RunLedger`` does
    not modify an existing file. Call ``restore(None)`` to start clean,
    or ``restore(state)`` with a cursor from checkpoint meta to resume.
    """

    def __init__(self, path: str, *, run_id: Optional[str] = None):
        self.path = str(path)
        self.run_id = run_id or "run-%s" % (
            os.path.splitext(os.path.basename(self.path))[0])
        self._lock = threading.RLock()
        self._fh = None                 # lazy binary append handle
        self._bytes = 0                 # logical end-of-ledger offset
        self.n_records = 0
        self.cum_flops_modelled = 0.0
        self.cum_flops_measured = 0.0
        self.cum_tokens = 0.0
        self._g_mod = _metrics.gauge("ledger.cum_flops.modelled")
        self._g_meas = _metrics.gauge("ledger.cum_flops.measured")
        self._h_flops = _metrics.histogram("ledger.step.flops",
                                           buckets=_metrics.LOG10_BUCKETS)
        self._h_tokens = _metrics.histogram("ledger.step.tokens",
                                            buckets=_metrics.LOG10_BUCKETS)

    # -- lifecycle ---------------------------------------------------------
    def restore(self, state: Optional[Dict[str, Any]]) -> None:
        """Reset to a checkpointed cursor (or to empty with ``None``).

        Truncates the on-disk file back to the cursor's byte offset, so
        any records appended after the checkpoint that carried this
        cursor — including a partial line from a mid-write kill — are
        discarded and will be re-appended by the re-executed steps.
        """
        with self._lock:
            self._close_handle()
            if state is None:
                offset, n = 0, 0
                self.cum_flops_modelled = 0.0
                self.cum_flops_measured = 0.0
                self.cum_tokens = 0.0
            else:
                offset = int(state["byte_offset"])
                n = int(state["n_records"])
                self.run_id = str(state.get("run_id", self.run_id))
                self.cum_flops_modelled = float(state["cum_flops_modelled"])
                self.cum_flops_measured = float(state["cum_flops_measured"])
                self.cum_tokens = float(state.get("cum_tokens", 0.0))
            have = (os.path.getsize(self.path)
                    if os.path.exists(self.path) else 0)
            if have < offset:
                raise ValueError(
                    f"ledger {self.path} has {have} bytes but the "
                    f"checkpointed cursor says {offset} — the ledger file "
                    "was moved or truncated out from under the checkpoint")
            if have > offset:
                with open(self.path, "rb+") as fh:
                    fh.truncate(offset)
            self._bytes = offset
            self.n_records = n
            self._g_mod.set(self.cum_flops_modelled)
            self._g_meas.set(self.cum_flops_measured)

    def snapshot(self) -> Dict[str, Any]:
        """Durable cursor for checkpoint meta (flushes + fsyncs first)."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
            return {
                "run_id": self.run_id,
                "byte_offset": self._bytes,
                "n_records": self.n_records,
                "cum_flops_modelled": self.cum_flops_modelled,
                "cum_flops_measured": self.cum_flops_measured,
                "cum_tokens": self.cum_tokens,
            }

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
            self._close_handle()

    def _close_handle(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            finally:
                self._fh = None

    # -- appends -----------------------------------------------------------
    def record_step(self, *, phase: str = "train", stage: int, arch: str,
                    step: int, loss: float, tokens: float, wall_ms: float,
                    flops_modelled: float,
                    flops_measured: Optional[float] = None) -> Dict[str, Any]:
        """One train/LiGO optimisation step. Returns the appended record."""
        measured = flops_measured is not None
        fm = float(flops_measured if measured else flops_modelled)
        fmod = float(flops_modelled)
        with self._lock:
            self.cum_flops_modelled += fmod
            self.cum_flops_measured += fm
            self.cum_tokens += float(tokens)
            rec = {
                "type": "step", "run_id": self.run_id, "phase": phase,
                "stage": int(stage), "arch": str(arch), "step": int(step),
                "loss": float(loss), "tokens": float(tokens),
                "wall_ms": round(float(wall_ms), 3),
                "flops_modelled": fmod, "flops_measured": fm,
                "cum_flops_modelled": self.cum_flops_modelled,
                "cum_flops_measured": self.cum_flops_measured,
                "measured": measured,
            }
            self._append(rec)
        self._g_mod.set(self.cum_flops_modelled)
        self._g_meas.set(self.cum_flops_measured)
        self._h_flops.observe(fm)
        self._h_tokens.observe(float(tokens))
        return rec

    def record_event(self, name: str, *, stage: Optional[int] = None,
                     step: Optional[int] = None, **attrs) -> Dict[str, Any]:
        """A point event (``hop.begin``, ``hop.rollback``, ``probe``…)."""
        with self._lock:
            rec = {"type": "event", "run_id": self.run_id,
                   "name": str(name), "stage": stage, "step": step,
                   "attrs": attrs}
            self._append(rec)
        return rec

    def _append(self, rec: Dict[str, Any]) -> None:
        # sorted keys + compact separators -> a byte-stable layout, so the
        # cursor's byte offset is reproducible across resume re-execution
        line = (json.dumps(rec, sort_keys=True,
                           separators=(",", ":")) + "\n").encode("utf-8")
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "ab")
        self._fh.write(line)
        self._bytes += len(line)
        self.n_records += 1


# ---------------------------------------------------------------------------
# Module-level active ledger (what --ledger on the launch CLIs attaches;
# the hop controller and the trajectory runner pick it up by default)
# ---------------------------------------------------------------------------
def attach_ledger(path: str, *, run_id: Optional[str] = None) -> RunLedger:
    """Create a :class:`RunLedger` and make it the process-wide active one.

    Does not touch the file — the consumer decides between
    ``restore(None)`` (start clean) and ``restore(cursor)`` (resume).
    """
    global _ACTIVE
    with _LOCK:
        if _ACTIVE is not None:
            raise RuntimeError(
                f"a ledger is already attached ({_ACTIVE.path}); "
                "detach_ledger() first")
        _ACTIVE = RunLedger(path, run_id=run_id)
        return _ACTIVE


def active_ledger() -> Optional[RunLedger]:
    return _ACTIVE


def detach_ledger() -> Optional[RunLedger]:
    """Close and clear the active ledger; returns it (or ``None``)."""
    global _ACTIVE
    with _LOCK:
        led, _ACTIVE = _ACTIVE, None
    if led is not None:
        led.close()
    return led


# ---------------------------------------------------------------------------
# Readers + the savings report
# ---------------------------------------------------------------------------
LedgerLike = Union[str, "RunLedger", Iterable[Dict[str, Any]]]


def read_ledger(path: str) -> List[Dict[str, Any]]:
    """Parse a ledger file, skipping a trailing partial line if present."""
    out: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                break                   # torn tail from a mid-write kill
    return out


def _records(src: LedgerLike) -> List[Dict[str, Any]]:
    if isinstance(src, RunLedger):
        src.close()
        return read_ledger(src.path)
    if isinstance(src, (str, os.PathLike)):
        return read_ledger(str(src))
    return list(src)


def normalize_records(records: Iterable[Dict[str, Any]],
                      drop=NONDETERMINISTIC_FIELDS) -> List[Dict[str, Any]]:
    """Strip the intentionally non-deterministic fields (wall clock,
    run id) so two ledgers can be compared record-for-record."""
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in drop}
        out.append(r)
    return out


def _first_crossing(records: List[Dict[str, Any]], target_loss: float):
    for r in records:
        if r.get("type") == "step" and float(r["loss"]) <= target_loss:
            return r
    return None


def savings_report(target_loss: float, ledger: LedgerLike, *,
                   baseline: LedgerLike) -> Dict[str, Any]:
    """FLOPs-to-target-loss for a (grown) run vs a from-scratch baseline.

    Finds the first step record at or below ``target_loss`` in each
    ledger and compares cumulative FLOPs there. The FLOPs basis is
    ``measured`` only when *both* crossing records carry measured
    numbers (comparing a measured run against a modelled baseline would
    mix units); otherwise ``modelled``.

    The run itself must reach the target (``ValueError`` otherwise — pick
    a target the run achieved). A baseline that never reaches it is
    *censored*: its total spend is used as a lower bound on the baseline
    cost, so the reported savings are themselves a lower bound.
    """
    run_recs = _records(ledger)
    base_recs = _records(baseline)
    run_x = _first_crossing(run_recs, target_loss)
    if run_x is None:
        raise ValueError(
            f"run never reached target loss {target_loss}; best was "
            f"{min((r['loss'] for r in run_recs if r.get('type') == 'step'), default=None)}")
    base_x = _first_crossing(base_recs, target_loss)
    base_steps = [r for r in base_recs if r.get("type") == "step"]
    if not base_steps:
        raise ValueError("baseline ledger has no step records")
    censored = base_x is None
    base_end = base_x if base_x is not None else base_steps[-1]
    basis = ("measured"
             if run_x.get("measured") and base_end.get("measured")
             else "modelled")
    run_flops = float(run_x[f"cum_flops_{basis}"])
    base_flops = float(base_end[f"cum_flops_{basis}"])
    savings = base_flops - run_flops
    return {
        "target_loss": float(target_loss),
        "basis": basis,
        "run": {"step": run_x["step"], "stage": run_x["stage"],
                "arch": run_x["arch"], "loss": run_x["loss"],
                "flops": run_flops},
        "baseline": {"step": base_end["step"], "loss": base_end["loss"],
                     "flops": base_flops, "reached": not censored},
        "censored_baseline": censored,
        "savings_flops": savings,
        "savings_frac": (savings / base_flops) if base_flops > 0 else 0.0,
    }
