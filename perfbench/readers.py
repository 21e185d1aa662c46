"""What the per-layer metrics share: a kernel's share of its roofline,
the step's share of the chip's peak, the device's idle share and the
launches a step makes.

A traced run holds three windows of the same steps, one after another:
one the profiler does not watch (the step's share of the peak is read
from its host clock, so that the profiler's own cost is not in it), one
in which it traces the device alone (the idle share and the launches;
the host pays little for it), and one in which it also records the
host's ops with their operand shapes (the kernels' rooflines; that costs
the host microseconds an op, which stretches the idle time, but not the
kernels' own device time).

A reader returns None where its window holds nothing to read (no device
record of the kernel), and the harness then leaves the metric out.
"""
from __future__ import annotations

from typing import Optional

from perfbench import flops

K1_OPS = ("repro_torch::ligo_blend_expand_grouped", "repro_torch::ligo_expand",
          "repro_torch::ligo_blend")
K2_OPS = ("repro_torch::ligo_blend_expand_bwd_fused",
          "repro_torch::ligo_blend_bwd", "repro_torch::ligo_expand_bwd")


class TracedRun:
    """The windows of one traced run: ``trace`` and ``shapes`` (each a
    :class:`perfbench.trace.TraceView`, of the device alone and with the
    host's ops and shapes), each of ``steps`` steps; the untraced window's
    ``timed_steps`` in ``timed_wall_s`` host seconds; and the operations
    each step requires, ``step_ops``."""

    def __init__(self, trace, shapes, steps: int, step_ops: float,
                 timed_steps: int, timed_wall_s: float):
        self.trace, self.shapes = trace, shapes
        self.steps, self.step_ops = steps, step_ops
        self.timed_steps, self.timed_wall_s = timed_steps, timed_wall_s


def kernel_roofline(run: TracedRun, names) -> Optional[float]:
    """100 × the least time of the calls of the ops ``names`` (from their
    recorded operand shapes, :func:`perfbench.flops.kernel_call_seconds`)
    over the device time of the kernels they launched."""
    device_s, by_op = run.shapes.kernel_time_under(names)
    if device_s <= 0:
        return None
    least = 0.0
    for i in by_op:
        op = run.shapes.ops[i]
        args = op.get("args", {})
        secs = flops.kernel_call_seconds(op["name"], args.get("Input Dims"),
                                         args.get("Input type"))
        if secs is None:
            return None
        least += secs
    return 100.0 * least / device_s


def mfu(run: TracedRun) -> Optional[float]:
    """100 × the operations the untraced window's steps require over its
    host seconds at the bf16 peak."""
    if run.timed_steps <= 0 or run.timed_wall_s <= 0:
        return None
    return 100.0 * run.step_ops * run.timed_steps / (
        run.timed_wall_s * flops.PEAK_OPS["bfloat16"])


def idle(run: TracedRun) -> Optional[float]:
    """100 × the share of the device-only traced window with nothing on
    the device."""
    busy = run.trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / run.trace.wall_s)


def launches(run: TracedRun) -> Optional[float]:
    """Kernels the device-only trace records, a step."""
    if not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.steps
