"""Dispatch between the port's kernels and their plain versions.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
PyTorch version in :mod:`repro_torch.kernels.ref`. The choice follows the
device of the tensors alone: there is no ``try`` and no environment switch,
and on a CUDA tensor the kernel launches or raises.

:func:`ligo_blend_expand_grouped_vjp` is the differentiable entry point the
GrowthPlan uses (:mod:`repro_torch.core.plan`), the twin of the JAX
package's ``custom_vjp``: a ``torch.autograd.Function`` whose forward is
kernel K1 and whose backward is kernel K2, which emits the cotangents
(dw, dB, and dW where W takes a gradient) of one leaf group in one call,
from the U that K1 kept. Given a right expander, the expansion runs between
K1's two steps, and K2's two halves run around its backward.

:func:`flash_attention` is kernel K3 (forward only: it serves the attention
of every forward that records no autograd graph, see
:func:`repro_torch.models.layers.full_attention`).

:func:`launch_counts` reads the kernels' plain-integer launch counters and
:func:`reset_launch_counts` sets them to 0. :data:`LAUNCH_COUNTS` is the
JAX package's registry twin ("kernels.launches", keys ``fwd`` and ``bwd``,
see its comment). Both count the kernels the device runs: a CUDA graph's
capture (:func:`capture_launches`) counts nothing, since it runs nothing,
and each replay adds the launches the capture recorded
(:func:`count_replay`).

The JAX package's public wrappers sit on the same ops:
:func:`ligo_blend_expand` and :func:`ligo_blend_expand_vjp` (one leaf, K1
with G = E = 1, the second differentiable through K2), :func:`ligo_grow`
(K1, then the right expansion as a plain product),
:func:`ligo_blend_expand_bwd_fused` (K2 alone, (dw, dB, dW) in the JAX
order), and the plain versions under the JAX names (``*_ref``).

K1 and K2 are registered as the custom operators
``torch.ops.repro_torch.ligo_blend_expand_grouped`` and
``torch.ops.repro_torch.ligo_blend_expand_bwd_fused``, and their halves as
``ligo_expand``, ``ligo_blend``, ``ligo_blend_bwd`` and ``ligo_expand_bwd``
(:data:`KERNEL_OPS`), each with a fake
(shape-only) implementation and its operation count as a
``torch.utils.flop_counter`` formula: the measured-cost pass
(:mod:`repro_torch.obs.costs`) runs a step on fake tensors under
``FlopCounterMode`` and counts the kernels' work without launching them.
"""
from __future__ import annotations

import contextlib
import importlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ligo_expand, ligo_expand_bwd, ref
from repro_torch.obs import CounterGroup, counter_group

# K3's wrapper module; the package exports the function ``flash_attention``
# under the module's own name, as the JAX package does
_flash = importlib.import_module("repro_torch.kernels.flash_attention")

# The JAX package counts the fused ops at trace time, once per traced call;
# the port's ops run eagerly, so it counts every call that takes a kernel:
# on CUDA tensors each is one launch of K1 (``fwd``: a group whose right
# expansion runs between K1's two steps counts once) or of K2 (``bwd``), and
# on fake tensors (the measured-cost pass, ``obs/costs.py``), where nothing
# launches, the call counts as a JAX trace does. A locked counter group, so
# the hop's grow thread and the engine thread count together; the registry
# exports it to ``/metrics`` as ``kernels_launches_total``.
LAUNCH_COUNTS: CounterGroup = counter_group("kernels.launches")

# the wrappers' plain-integer counters, by ``launch_counts()`` key
_COUNTERS = {"ligo_blend_expand_grouped": ligo_expand,
             "ligo_blend_expand_bwd_fused": ligo_expand_bwd,
             "flash_attention": _flash}

# the tally of a CUDA-graph capture running in this thread, if any
_CAPTURE = threading.local()


@dataclass
class GraphLaunches:
    """The kernel launches a CUDA graph holds, tallied at its capture:
    ``counts`` by :data:`LAUNCH_COUNTS` key, ``launches`` by
    :func:`launch_counts` key."""
    counts: Dict[str, int] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)


def _count(key: str) -> None:
    """One kernel call for ``LAUNCH_COUNTS[key]``, or for the tally of the
    capture running in this thread."""
    tally = getattr(_CAPTURE, "tally", None)
    if tally is None:
        LAUNCH_COUNTS.inc(key)
    else:
        tally.counts[key] = tally.counts.get(key, 0) + 1


@contextlib.contextmanager
def capture_launches() -> Iterator[GraphLaunches]:
    """Tally, instead of counting, the kernel calls made in this thread
    while a CUDA graph captures them: a capture launches nothing. Yields
    the tally, complete when the block ends; :func:`count_replay` adds it
    to the counts at each replay. The wrappers' plain-integer counters are
    read before and after the block and set back, so no other thread may
    launch a kernel while it runs (the hop captures in the engine thread
    before any grow thread starts)."""
    tally = GraphLaunches()
    before = launch_counts()
    _CAPTURE.tally = tally
    try:
        yield tally
    finally:
        _CAPTURE.tally = None
        for name, n in launch_counts().items():
            if n != before[name]:
                tally.launches[name] = n - before[name]
            _COUNTERS[name].LAUNCHES = before[name]


def count_replay(tally: GraphLaunches) -> None:
    """Count one replay of a captured graph: every launch it holds."""
    for key, n in tally.counts.items():
        LAUNCH_COUNTS.inc(key, n)
    for name, n in tally.launches.items():
        _COUNTERS[name].LAUNCHES += n


def ligo_blend_expand_grouped(w: torch.Tensor, B: torch.Tensor,
                              W: torch.Tensor) -> torch.Tensor:
    """Grouped ``P[g,k,e] = B @ (Σ_l w[g,k,l] W[g,l,e])``.

    w: (G, L2, L1); B: (I, A); W: (G, L1, E, A, Bd) → (G, L2, E, I, Bd).
    """
    if W.is_cuda:
        _count("fwd")
        return ligo_expand.ligo_blend_expand_grouped(w, B, W)
    return ref.ligo_blend_expand_grouped_ref(w, B, W)


def _dims(w, B, W):
    """(G, L2, L1, E, I, A, Bd) of K1's operands, given as tensors or, as
    a flop formula gets them, as shapes."""
    (G, L2, L1), (I, A), Ws = (tuple(getattr(x, "shape", x))
                               for x in (w, B, W))
    return G, L2, L1, Ws[2], I, A, Ws[4]


def _slab_dims(w, S):
    """(G, L2, L1, E, I, 1, Bd) of a call that takes w and a (G, L1|L2, E,
    I, Bd) slab stack (U or dP) but no B: the products' A is not used."""
    (G, L2, L1), Ss = (tuple(getattr(x, "shape", x)) for x in (w, S))
    return G, L2, L1, Ss[2], Ss[3], 1, Ss[4]


def _prod_dims(B, W):
    """(G, 1, L1, E, I, A, Bd) of a call that takes B and W but no w."""
    (I, A), (G, L1, E, _, Bd) = (tuple(getattr(x, "shape", x))
                                 for x in (B, W))
    return G, 1, L1, E, I, A, Bd


# -- K1: both steps, and each step alone ------------------------------------
@torch.library.custom_op("repro_torch::ligo_blend_expand_grouped",
                         mutates_args=())
def _k1(w: torch.Tensor, B: torch.Tensor, W: torch.Tensor,
        keep_u: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1 (raises on tensors that are not on CUDA): (P, U), U empty
    unless ``keep_u``."""
    if keep_u:
        return ligo_expand.ligo_blend_expand_grouped(w, B, W, keep_u=True)
    P = ligo_expand.ligo_blend_expand_grouped(w, B, W)
    return P, P.new_empty((0,), dtype=torch.float32)


@_k1.register_fake
def _k1_fake(w, B, W, keep_u):
    G, L2, L1, E, I, _, Bd = _dims(w, B, W)
    return (W.new_empty((G, L2, E, I, Bd)),
            W.new_empty((G, L1, E, I, Bd) if keep_u else (0,),
                        dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ligo_blend_expand_grouped)
def _k1_flops(w, B, W, *args, **kwargs) -> int:
    return ligo_expand.operation_count(*_dims(w, B, W))


@torch.library.custom_op("repro_torch::ligo_expand", mutates_args=())
def _k1_expand(B: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """K1's first step: U = B W in float32."""
    return ligo_expand.ligo_expand(B, W)


@_k1_expand.register_fake
def _k1_expand_fake(B, W):
    G, _, L1, E, I, _, Bd = _prod_dims(B, W)
    return W.new_empty((G, L1, E, I, Bd), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.ligo_expand)
def _k1_expand_flops(B, W, *args, **kwargs) -> int:
    return ligo_expand.operation_count(*_prod_dims(B, W), stage="expand")


@torch.library.custom_op("repro_torch::ligo_blend", mutates_args=())
def _k1_blend(w: torch.Tensor, U: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """K1's second step: the blend of a float32 U, rounded to ``dtype``."""
    return ligo_expand.ligo_blend(w, U, dtype)


@_k1_blend.register_fake
def _k1_blend_fake(w, U, dtype):
    G, L2, _, E, I, _, Bd = _slab_dims(w, U)
    return U.new_empty((G, L2, E, I, Bd), dtype=dtype)


@register_flop_formula(torch.ops.repro_torch.ligo_blend)
def _k1_blend_flops(w, U, *args, **kwargs) -> int:
    return ligo_expand.operation_count(*_slab_dims(w, U), stage="blend")


# -- K2: the whole backward, and its two halves -----------------------------
@torch.library.custom_op("repro_torch::ligo_blend_expand_bwd_fused",
                         mutates_args=())
def _k2(w: torch.Tensor, B: torch.Tensor, W: torch.Tensor, dP: torch.Tensor,
        U: Optional[torch.Tensor], need_dW: bool
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K2: dw (float32), dB, dW (empty unless ``need_dW``), from K1's
    U where it is given (raises off CUDA)."""
    dw, dB, dW = ligo_expand_bwd.ligo_blend_expand_bwd(w, B, W, dP, U=U,
                                                       need_dW=need_dW)
    return dw, dB, dW if need_dW else W.new_empty((0,))


@_k2.register_fake
def _k2_fake(w, B, W, dP, U, need_dW):
    return (w.new_empty(w.shape, dtype=torch.float32), torch.empty_like(B),
            torch.empty_like(W) if need_dW else W.new_empty((0,)))


@register_flop_formula(torch.ops.repro_torch.ligo_blend_expand_bwd_fused)
def _k2_flops(w, B, W, dP, U, need_dW, *args, **kwargs) -> int:
    return ligo_expand_bwd.operation_count(
        *_dims(w, B, W), u_given=U is not None, need_dW=need_dW)


@torch.library.custom_op("repro_torch::ligo_blend_bwd", mutates_args=())
def _k2_blend(w: torch.Tensor, dP: torch.Tensor,
              U: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's first half: (dw, Q)."""
    return ligo_expand_bwd.ligo_blend_bwd(w, dP, U)


@_k2_blend.register_fake
def _k2_blend_fake(w, dP, U):
    return (w.new_empty(w.shape, dtype=torch.float32),
            dP.new_empty(U.shape))


@register_flop_formula(torch.ops.repro_torch.ligo_blend_bwd)
def _k2_blend_flops(w, dP, U, *args, **kwargs) -> int:
    return ligo_expand_bwd.operation_count(
        *_slab_dims(w, dP), u_given=True, need_dW=False, need_dB=False)


@torch.library.custom_op("repro_torch::ligo_expand_bwd", mutates_args=())
def _k2_expand(B: torch.Tensor, W: torch.Tensor, Q: torch.Tensor,
               need_dW: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's second half from a given Q: (dB, dW), dW empty unless
    ``need_dW``."""
    dB, dW = ligo_expand_bwd.ligo_expand_bwd(B, W, Q, need_dW=need_dW)
    return dB, dW if need_dW else W.new_empty((0,))


@_k2_expand.register_fake
def _k2_expand_fake(B, W, Q, need_dW):
    return (torch.empty_like(B),
            torch.empty_like(W) if need_dW else W.new_empty((0,)))


@register_flop_formula(torch.ops.repro_torch.ligo_expand_bwd)
def _k2_expand_flops(B, W, Q, need_dW, *args, **kwargs) -> int:
    return ligo_expand_bwd.operation_count(
        *_prod_dims(B, W), q_given=True, need_dW=need_dW, need_dw=False)


#: the custom operators of the kernels, as ``FlopCounterMode`` keys them
KERNEL_OPS = (torch.ops.repro_torch.ligo_blend_expand_grouped,
              torch.ops.repro_torch.ligo_expand,
              torch.ops.repro_torch.ligo_blend,
              torch.ops.repro_torch.ligo_blend_expand_bwd_fused,
              torch.ops.repro_torch.ligo_blend_bwd,
              torch.ops.repro_torch.ligo_expand_bwd)


def _keeps_u(*xs) -> bool:
    """Whether a forward will be differentiated: grad mode on and an
    operand that takes a gradient (decided before ``Function.apply``, whose
    forward runs with grad mode off)."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class _BlendExpandGrouped(torch.autograd.Function):
    """K1 forward and K2 backward, or both plain versions (``plain``). A
    forward that will be differentiated keeps K1's U for K2."""

    @staticmethod
    def forward(ctx, w, B, W, plain: bool, keep_u: bool):
        ctx.plain = plain
        # the raw kernel wrapper refuses tensors that require grad
        w, B, W = w.detach(), B.detach(), W.detach()
        if plain:
            out = ref.ligo_blend_expand_grouped_ref(w, B, W, keep_u=keep_u)
        else:
            _count("fwd")
            out = _k1(w, B, W, keep_u)
        P, U = out if keep_u or not plain else (out, None)
        ctx.save_for_backward(w, B, W, U if keep_u else None)
        return P

    @staticmethod
    @once_differentiable
    def backward(ctx, dP):
        w, B, W, U = ctx.saved_tensors
        need = ctx.needs_input_grad
        # dP arrives strided after the plan's slicing and right expansion
        dP = dP.contiguous()
        if ctx.plain:
            dw, dB, dW = ref.ligo_blend_expand_bwd_ref(w, B, W, dP, U=U,
                                                       need_dW=need[2])
        else:
            _count("bwd")
            dw, dB, dW = _k2(w, B, W, dP, U, need[2])
            dw = dw.to(w.dtype)
        return (dw if need[0] else None, dB if need[1] else None,
                dW if need[2] else None, None, None)


class _BlendExpandBetween(torch.autograd.Function):
    """``P[g,k,e] = Σ_l w[g,k,l] (B W[g,l,e]) Rᵀ``: K1's U, the right
    expansion by R (j, b) as a matmul, then K1's blend; its backward is K2's
    blend half (Q = wᵀ·dP and dw against the expanded U), the expansion's
    backward as two matmuls (dR = Σ Qᵀ U, dU = Q R), then K2's products
    half (dB, and dW where W takes a gradient) from the narrow dU. U and
    its expansion are rounded to the working dtype before the matmul and
    read back in float32 by the blend; or all of it through the plain
    versions (``plain``)."""

    @staticmethod
    def forward(ctx, w, B, W, R, plain: bool):
        ctx.plain = plain
        w, B, W, R = (x.detach() for x in (w, B, W, R))
        dt = W.dtype
        if not plain:
            _count("fwd")
        U = (ref.ligo_expand_ref(B, W) if plain
             else _k1_expand(B, W)).to(dt)
        UR = (U.reshape(-1, U.shape[-1]) @ R.to(dt).T).reshape(
            U.shape[:-1] + (R.shape[0],)).to(
                torch.promote_types(dt, torch.float32))
        P = (ref.ligo_blend_ref(w, UR, dt) if plain
             else _k1_blend(w, UR, dt))
        ctx.save_for_backward(w, B, W, R, U, UR)
        return P

    @staticmethod
    @once_differentiable
    def backward(ctx, dP):
        w, B, W, R, U, UR = ctx.saved_tensors
        need = ctx.needs_input_grad
        dP = dP.contiguous()
        if ctx.plain:
            dw, Q = ref.ligo_blend_bwd_ref(w, dP, UR)
        else:
            _count("bwd")
            dw, Q = _k2_blend(w, dP, UR)
        Rd = R.to(Q.dtype)
        dR = (Q.reshape(-1, Q.shape[-1]).T @ U.reshape(-1, U.shape[-1])
              if need[3] else None)
        dU = (Q.reshape(-1, Q.shape[-1]) @ Rd).reshape(U.shape).contiguous()
        dB = dW = None
        if need[1] or need[2]:
            if ctx.plain:
                dB, dW = ref.ligo_expand_bwd_ref(B, W, dU, need_dW=need[2])
            else:
                dB, dW = _k2_expand(B, W, dU, need[2])
        return (dw.to(w.dtype) if need[0] else None,
                dB if need[1] else None, dW if need[2] else None,
                dR.to(R.dtype) if dR is not None else None, None)


def ligo_blend_expand_grouped_vjp(w: torch.Tensor, B: torch.Tensor,
                                  W: torch.Tensor,
                                  R: Optional[torch.Tensor] = None, *,
                                  use_kernel: Optional[bool] = None
                                  ) -> torch.Tensor:
    """Differentiable grouped ``P[g,k,e] = B @ (Σ_l w[g,k,l] W[g,l,e])``,
    or with a right expander ``R`` (j, Bd), ``P[g,k,e] = B @ (Σ_l w[g,k,l]
    W[g,l,e]) @ Rᵀ`` with the right expansion between K1's U and its blend.

    w: (G, L2, L1); B: (I, A); W: (G, L1, E, A, Bd) → (G, L2, E, I, Bd) (Bd
    → j with ``R``). ``use_kernel=None`` follows the tensors' device (CUDA:
    K1 forward, K2 backward; CPU: their plain versions); ``False`` asks for
    the plain versions on any device; ``True`` asks for the kernels, which
    raise on CPU tensors.
    """
    if use_kernel is None:
        use_kernel = W.is_cuda
    if R is not None:
        return _BlendExpandBetween.apply(w, B, W, R, not use_kernel)
    if (use_kernel and not torch.is_grad_enabled()
            and _get_current_dispatch_mode() is None):
        # a grow without gradients and without a mode that counts or fakes
        # the call (a serve's hot-grow, a hop's eager grow and the capture
        # of its graph): K1 from its wrapper, the launch
        # counted as the custom op counts it, without the op's Python
        # dispatch (the most of a grow's host time on the card)
        _count("fwd")
        return ligo_expand.ligo_blend_expand_grouped(w.detach(), B.detach(),
                                                     W.detach())
    return _BlendExpandGrouped.apply(w, B, W, not use_kernel,
                                     _keeps_u(w, B, W))


def ligo_blend_expand(w: torch.Tensor, B: torch.Tensor,
                      W: torch.Tensor) -> torch.Tensor:
    """``P[l2] = B @ (Σ_l w[l2, l] W[l])``, one leaf: K1 with G = E = 1.

    w: (L2, L1); B: (I, A); W: (L1, A, Bd) → (L2, I, Bd). Kernel K1 on CUDA
    tensors, its plain version on CPU tensors.
    """
    return ligo_blend_expand_grouped(w[None], B, W[None, :, None])[0, :, 0]


def ligo_grow(w: torch.Tensor, B: torch.Tensor, A: torch.Tensor,
              W: torch.Tensor) -> torch.Tensor:
    """The full growth ``Ω[l2] = B (Σ_l w[l2, l] W_l) Aᵀ`` of one leaf:
    the depth blend and left expansion in K1, the right expansion by A
    (j, Bd) a plain product on K1's output, as the JAX package leaves it to
    XLA. → (L2, I, j)."""
    P = ligo_blend_expand(w, B, W)
    dt = torch.promote_types(P.dtype, A.dtype)
    return P.to(dt) @ A.to(dt).T


def ligo_blend_expand_vjp(w: torch.Tensor, B: torch.Tensor, W: torch.Tensor,
                          *, use_kernel: Optional[bool] = None
                          ) -> torch.Tensor:
    """Differentiable :func:`ligo_blend_expand`: the single-leaf form of
    :func:`ligo_blend_expand_grouped_vjp` (G = E = 1), so its forward is
    K1 and its backward K2 on the kernel route. ``use_kernel`` as there."""
    return ligo_blend_expand_grouped_vjp(w[None], B, W[None, :, None],
                                         use_kernel=use_kernel)[0, :, 0]


def ligo_blend_expand_bwd_fused(w: torch.Tensor, B: torch.Tensor,
                                W: torch.Tensor, dP: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """All three cotangents of :func:`ligo_blend_expand_grouped` in one
    call: w (G, L2, L1), B (I, A), W (G, L1, E, A, Bd), dP (G, L2, E, I, Bd)
    → (dw, dB, dW) in the dtypes of (w, B, W), the JAX package's order.
    Kernel K2 on CUDA tensors (it computes U = B W itself), its plain
    version on CPU tensors."""
    if not W.is_cuda:
        return ref.ligo_blend_expand_bwd_ref(w, B, W, dP)
    _count("bwd")
    dw, dB, dW = _k2(w, B, W, dP.contiguous(), None, True)
    return dw.to(w.dtype), dB, dW


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """(B, H, T, dh) × (B, KV, S, dh)² → (B, H, T, dh); GQA by index.

    ``use_kernel=None`` follows the tensors' device (CUDA: kernel K3; CPU:
    its plain version); ``False`` asks for the plain version on any device;
    ``True`` asks for the kernel, which raises on CPU tensors.
    """
    plain = (not q.is_cuda) if use_kernel is None else not use_kernel
    if plain:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def launch_counts() -> Dict[str, int]:
    return {name: mod.LAUNCHES for name, mod in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod in _COUNTERS.values():
        mod.LAUNCHES = 0


# the plain versions under the JAX package's names
ligo_blend_expand_ref = ref.ligo_blend_expand_ref
ligo_blend_expand_grouped_ref = ref.ligo_blend_expand_grouped_ref
ligo_blend_expand_bwd_ref = ref.ligo_blend_expand_bwd_ref
ligo_grow_ref = ref.ligo_grow_ref
flash_attention_ref = ref.flash_attention_ref
