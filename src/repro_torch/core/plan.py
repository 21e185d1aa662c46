"""GrowthPlan: the compiled growth engine behind ``apply_ligo``.

A :class:`GrowthPlan` is built once per ``(cfg1, cfg2, tree shape)`` and
fixes, ahead of time:

1. the distinct ``(expander expression, role)`` pairs, resolved once per
   apply and shared by every leaf;
2. a grouping of leaves by ``(module family, shape, in/out expander pair)``,
   each group run as one stacked contraction;
3. a min-FLOP contraction order per group (:func:`_best_order`), and whether
   the group may run on kernel K1, the fused depth-blend + left-expansion,
   with kernel K2 as its backward
   (:func:`repro_torch.kernels.ops.ligo_blend_expand_grouped_vjp`); on that
   route, where the group's right expansion runs (:func:`_right_costs`):
   before K1, on the L1 source layers; between K1's U product and its
   blend, on the L1 expanded slabs; or after K1, on the L2 target layers,
   whichever needs the fewest operations, once for a forward alone and
   once for a forward and its backward.

Kernel eligibility. The JAX package gates its fused path on
``fused_vmem_bytes``: the resident VMEM state of its *backward* TPU kernel
(B whole, an (I, A) dB accumulator, an (L1, A, TB) dW accumulator) against a
10 MiB budget — at GPT-2 widths that rejects every group. That check sizes a
TPU dataflow and is not ported. K1 on Hopper streams B through shared memory
in tiles and keeps no state between blocks, so its eligibility does not
depend on width: a stacked ``(L1, a, b)`` or ``(L1, E, a, b)`` leaf with an
in-expander and no empty dim qualifies. The fused route is differentiable
(``ops.ligo_blend_expand_grouped_vjp``): its backward is kernel K2, which
also keeps no state between blocks (its dB and dw sums are split into
per-block partials and reduced in a second pass), so it takes every group
K1 takes, at any width. Both kernels raise on grids beyond CUDA's limits
(such as more than 65535 (g, k, e) slabs).

A family-changing hop (dense→MoE upcycling, :func:`repro_torch.core.spec.
family_hop`) lands each group under its target kind and paths
(``LeafGroup.out_kind`` / ``out_paths``), replicates the expert leaves E
times after the group runs (``bcast``; the copies are materialised, as JAX
arrays are values) and makes the target-only leaves, the router, as zeros
(``GrowthPlan.created``).

``compose_ligo`` / ``compose_chain`` fold successive hops' operators into one
``cfg_A→cfg_C`` operator analytically (width factors as matrix products,
depth patterns as chained blends), so a multi-hop ``--grow-to`` runs as one
plan apply. The JAX package's mesh, shardings and ``place_operator`` are left
out: the port grows on one card.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from itertools import permutations
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import spec as S
from repro_torch.core.ligo import (_flatten, _kind_counts, _unflatten,
                                   replicate_experts, resolve_expander)
from repro_torch.kernels import ops

ExprRef = Tuple[Any, str]          # (hashable expr key, role) — plan.exprs key


def _expr_key(expr) -> Any:
    """Canonical hashable key for a spec expander expression."""
    if expr is None or isinstance(expr, str):
        return expr
    kind = expr[0]
    if kind == "gamma":
        return ("gamma", _expr_key(expr[1]))
    if kind == "seg":
        return ("seg", tuple((_expr_key(sub), n1, n2)
                             for (sub, n1, n2) in expr[1]))
    raise ValueError(expr)


def _expr_dims(expr, cfg1: ModelConfig, cfg2: ModelConfig) -> Tuple[int, int]:
    """Static (d2, d1) shape of a resolved expander expression."""
    if isinstance(expr, str):
        return S.width_dims(cfg2)[expr], S.width_dims(cfg1)[expr]
    if expr[0] == "gamma":
        return (cfg2.n_heads * cfg2.d_head, cfg1.n_heads * cfg1.d_head)
    if expr[0] == "seg":
        return (sum(n2 for (_, _, n2) in expr[1]),
                sum(n1 for (_, n1, _) in expr[1]))
    raise ValueError(expr)


@dataclass(frozen=True)
class LeafGroup:
    """A batch of same-shaped leaves sharing one (in, out) expander pair."""
    kind: str                      # layer-stack kind; "" for top-level params
    stacked: bool                  # leading L1 layer dim present
    paths: Tuple[str, ...]
    shape: Tuple[int, ...]         # per-leaf shape (incl. L1 when stacked)
    in_ref: Optional[ExprRef]
    out_ref: Optional[ExprRef]
    vec: bool                      # per-layer vector leaf (out-expander only)
    order: Tuple[str, ...]         # op sequence drawn from {in, out, blend}
    kernel_ok: bool                # may run on kernels K1 and K2
    right: str = "after"           # K1 route: where the right expansion
    right_grad: str = "after"      # runs without / with gradients
    # Family-changing hops (dense→MoE upcycling): where the grown leaves
    # land. Defaults mean "same kind / same paths" (every same-family plan).
    out_kind: str = ""             # target stack kind when it differs
    out_paths: Tuple[str, ...] = ()  # target leaf paths when renamed
    bcast: int = 0                 # expert-replication count (0 = none)

    @property
    def dst_kind(self) -> str:
        return self.out_kind or self.kind

    @property
    def dst_paths(self) -> Tuple[str, ...]:
        return self.out_paths or self.paths


def _best_order(ops_present, L1: int, L2: int, extra: int, a: int, b: int,
                i: int, j: int) -> Tuple[str, ...]:
    """Min-FLOP ordering of the (commuting) expand/blend contractions,
    searched exhaustively over the ≤ 3! arrangements."""
    best, best_cost = None, None
    for perm in dict.fromkeys(permutations(ops_present)):
        l, ca, cb = L1, a, b
        cost = 0
        for op in perm:
            if op == "in":
                cost += extra * l * i * ca * cb
                ca = i
            elif op == "out":
                cost += extra * l * ca * cb * j
                cb = j
            else:  # blend
                cost += extra * L2 * L1 * ca * cb
                l = L2
        if best_cost is None or cost < best_cost:
            best, best_cost = perm, cost
    return best if best is not None else ()


RIGHT_PLACES = ("before", "after", "between")   # ties go to the first


def _right_costs(extra: int, L1: int, L2: int, a: int, b: int, i: int,
                 j: int) -> Dict[str, Tuple[int, int]]:
    """Operations of a K1-route group's forward and of its backward, for
    each place of its right expansion (b → j), with the operator taking
    gradients and the source leaves not (the LiGO phase):

    - ``before``: X Rᵀ on the L1 source layers, then K1 and K2 at width j;
      W takes a gradient through R, so K2 computes dW;
    - ``between``: K1's U at width b, U Rᵀ, K1's blend at width j; K2's
      blend half (Q, dw) at j, dR = Σ Qᵀ U and dU = Q R, K2's dB at b;
    - ``after``: K1 at width b, then P Rᵀ on the L2 target layers; its
      backward dR and dP, then K2 (dB, Q, dw) at width b.

    K2 takes K1's U in every place, so it never recomputes it."""
    def prod(bd):          # one L1-batched product: K1's U, K2's dW or dB
        return 2 * extra * L1 * i * a * bd

    def blend(bd):         # K1's blend, K2's dP blend or its dw
        return 2 * extra * L2 * L1 * i * bd
    src, mid, tgt = (2 * extra * n * b * j for n in (L1 * a, L1 * i, L2 * i))
    return {
        "before": (src + prod(j) + blend(j), src + 2 * prod(j) + 2 * blend(j)),
        "between": (prod(b) + mid + blend(j), 2 * blend(j) + 2 * mid + prod(b)),
        "after": (prod(b) + blend(b) + tgt, 2 * tgt + prod(b) + 2 * blend(b)),
    }


def _plan_group(kind: str, stacked: bool, paths, shape, in_e, out_e,
                vec: bool, L2: int, cfg1, cfg2) -> LeafGroup:
    """Choose contraction order + kernel eligibility from static shapes."""
    in_ref = None if in_e is None else (_expr_key(in_e), "in")
    out_ref = None if out_e is None else (_expr_key(out_e), "out")
    blended = stacked
    L1 = shape[0] if stacked else 1
    if vec:
        n = shape[-1]
        j = _expr_dims(out_e, cfg1, cfg2)[0] if out_e is not None else n
        ops_present = tuple(op for op, c in (("out", out_e is not None),
                                             ("blend", blended)) if c)
        order = _best_order(ops_present, L1, L2, 1, 1, n, 1, j)
        return LeafGroup(kind, stacked, tuple(paths), tuple(shape), None,
                         out_ref, True, order, False)

    a, b = shape[-2], shape[-1]
    extra = 1
    for d in shape[(1 if stacked else 0):-2]:
        extra *= d
    i = _expr_dims(in_e, cfg1, cfg2)[0] if in_e is not None else a
    j = _expr_dims(out_e, cfg1, cfg2)[0] if out_e is not None else b
    ops_present = tuple(op for op, c in (("in", in_e is not None),
                                         ("out", out_e is not None),
                                         ("blend", blended)) if c)
    order = _best_order(ops_present, L1, L2, extra, a, b, i, j)
    kernel_ok = (blended and in_e is not None and len(shape) in (3, 4)
                 and min(L1, L2, extra, i, a, b) >= 1)
    right = right_grad = "after"
    if kernel_ok and out_e is not None:
        cost = _right_costs(extra, L1, L2, a, b, i, j)
        right = min(RIGHT_PLACES, key=lambda p: cost[p][0])
        right_grad = min(RIGHT_PLACES, key=lambda p: sum(cost[p]))
    return LeafGroup(kind, stacked, tuple(paths), tuple(shape), in_ref,
                     out_ref, False, order, kernel_ok, right, right_grad)


class GrowthPlan:
    """Static execution plan for growing Θ_small → Θ_large.

    Built once per ``(cfg1, cfg2, parameter-tree signature)`` via
    :func:`plan_for`; ``apply`` has the legacy ``apply_ligo`` walk's
    semantics.
    """

    def __init__(self, cfg1: ModelConfig, cfg2: ModelConfig,
                 groups: Tuple[LeafGroup, ...],
                 exprs: Dict[ExprRef, Any],
                 created: Optional[Dict[str, Dict[str, Tuple]]] = None):
        self.cfg1, self.cfg2 = cfg1, cfg2
        self.groups = groups
        self.exprs = exprs
        # Target-only leaves with no source (family hops): kind → {path:
        # (full stacked shape, dtype name)}, made as zeros by ``apply``
        # (zeros are the function-preserving router init and the right
        # created value for both AdamW moment maps).
        self.created = created or {}

    def _expander_table(self, width) -> Dict[ExprRef, torch.Tensor]:
        return {ref_: resolve_expander(expr, width, self.cfg1, self.cfg2,
                                       ref_[1])
                for ref_, expr in self.exprs.items()}

    # -- group execution ----------------------------------------------------
    @staticmethod
    def _expand_out(X: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
        """(..., b) · Eᵀ → (..., j) as one (prod(...), b)×(b, j) GEMM."""
        s = X.shape
        out = X.reshape(-1, s[-1]) @ E.to(X.dtype).T
        return out.reshape(s[:-1] + (E.shape[0],))

    @staticmethod
    def _expand_in(X: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
        """E · (..., a, b) → (..., i, b) as one (i, a)×(a, prod(·)) GEMM."""
        a = X.shape[-2]
        Xm = torch.movedim(X, -2, 0)                      # (a, ..., b)
        s = Xm.shape
        out = E.to(X.dtype) @ Xm.reshape(a, -1)
        return torch.movedim(out.reshape((E.shape[0],) + s[1:]), 0, -2)

    @staticmethod
    def _run_group(g: LeafGroup, X: torch.Tensor, E_in, E_out, w_g):
        """X: (G, ...) stacked leaves; w_g: (G, L2, L1) blends or None.

        Executes the group's static min-FLOP op sequence; the blend op is
        skipped when the operator tree carries no depth blends for this kind.
        """
        for op in g.order:
            if op == "in":
                X = GrowthPlan._expand_in(X, E_in)
            elif op == "out":
                X = GrowthPlan._expand_out(X, E_out)
            elif w_g is not None:
                X = torch.einsum("gkl,gl...->gk...", w_g.to(X.dtype), X)
        return X

    @staticmethod
    def _run_group_fused(g: LeafGroup, X: torch.Tensor, E_in, E_out, w_g):
        """Blend + left-expand for the *whole group* in one K1 launch (the G
        leaves and any MoE expert dim E are the kernel's batch); the right
        expansion is a plain matmul on K1's input, between K1's two steps
        or on its output, as ``g.right`` (forward only) or ``g.right_grad``
        (when the operator takes gradients) says. Differentiable in ``w_g``,
        ``E_in``, ``E_out`` and ``X``: the backward is K2."""
        place = None
        if E_out is not None:
            grad = torch.is_grad_enabled() and any(
                t.requires_grad for t in (w_g, E_in, E_out, X))
            place = g.right_grad if grad else g.right
        if place == "before":
            X = GrowthPlan._expand_out(X, E_out)
        moe = X.dim() == 5                     # (G, L1, E, a, b) expert stack
        Xg = X if moe else X[:, :, None]       # insert E=1 for plain leaves
        P = ops.ligo_blend_expand_grouped_vjp(
            w_g, E_in, Xg.contiguous(),
            E_out if place == "between" else None)
        if not moe:
            P = P[:, :, 0]
        if place == "after":
            P = GrowthPlan._expand_out(P, E_out)
        return P

    def apply(self, ligo, small, *, use_kernel: Optional[bool] = None,
              square: bool = False, cache: Optional[Dict] = None):
        """Θ_large = M(Θ_small).

        ``use_kernel`` routes kernel-eligible groups through K1, and their
        gradients through K2 (the default: yes when the small tree lies on a
        CUDA device). On CPU tensors the same route runs the kernels' plain
        versions. ``square=True`` squares every
        resolved expander and depth blend elementwise after resolution — the
        AdamW second-moment map. ``cache``: a dict the caller keeps for this
        plan and this one operator ``ligo`` (a live hop's controller does);
        a grow without gradients keeps there what it derives from the
        operator alone (the resolved expanders, the left ones cast to each
        leaf dtype, and the stacked depth blends), so that the next grow
        makes none of those ops again: the same values, fewer launches on
        the host.
        """
        flat_stacks = {kind: _flatten(stack)
                       for kind, stack in small["layers"].items()}
        flat_top = _flatten({k: v for k, v in small.items() if k != "layers"})
        if use_kernel is None:
            some = next(iter(flat_top.values()))
            use_kernel = some.is_cuda
        width = ligo["width"]
        depth = ligo.get("depth", {})
        memo = cache if cache is not None and not torch.is_grad_enabled() \
            else {}

        def kept(key, make):
            if key not in memo:
                memo[key] = make()
            return memo[key]

        def resolved():
            table = self._expander_table(width)
            return ({ref_: E * E for ref_, E in table.items()} if square
                    else table)
        table = kept(("table", square), resolved)

        grown_stacks: Dict[str, Dict[str, torch.Tensor]] = {
            g.dst_kind: {} for g in self.groups if g.kind}
        for kind in self.created:
            grown_stacks.setdefault(kind, {})
        grown_top: Dict[str, torch.Tensor] = {}

        for gi_, g in enumerate(self.groups):
            src = flat_stacks[g.kind] if g.kind else flat_top
            leaves = [src[p] for p in g.paths]
            blend_tree = depth.get(g.kind) if (g.stacked and g.kind) else None

            def blends():
                w = torch.stack([blend_tree[p] for p in g.paths])
                return w * w if square else w
            w_g = (kept(("w", gi_, square), blends)
                   if blend_tree is not None else None)
            X = leaves[0][None] if len(leaves) == 1 else torch.stack(leaves)
            # the left expander in the leaves' dtype; the right one stays
            # in the operator's (K1's between-split casts it, and returns
            # its gradient in that dtype)
            E_in = (None if g.in_ref is None else
                    kept(("E", g.in_ref, square, X.dtype),
                         lambda r=g.in_ref: table[r].to(X.dtype)
                         .contiguous()))
            E_out = table[g.out_ref] if g.out_ref is not None else None
            if use_kernel and g.kernel_ok and w_g is not None:
                out = self._run_group_fused(g, X, E_in, E_out, w_g)
            else:
                if w_g is not None:                     # its blend's cast
                    w_g = kept(("wd", gi_, square, X.dtype),
                               lambda w=w_g: w.to(X.dtype))
                out = self._run_group(g, X, E_in, E_out, w_g)
            dst = grown_stacks[g.dst_kind] if g.kind else grown_top
            for gi, p in enumerate(g.dst_paths):
                dst[p] = (replicate_experts(out[gi], g.bcast) if g.bcast
                          else out[gi])

        dev = next(iter(flat_top.values())).device
        for kind, leaves_c in self.created.items():
            for path, (shape, dt) in leaves_c.items():
                grown_stacks[kind][path] = torch.zeros(
                    shape, dtype=getattr(torch, dt), device=dev)

        out_tree: Dict[str, Any] = {"layers": {
            kind: _unflatten(grown) for kind, grown in grown_stacks.items()}}
        out_tree.update(_unflatten(grown_top))
        return out_tree


# ---------------------------------------------------------------------------
# Plan construction (memoised on config pair + tree signature)
# ---------------------------------------------------------------------------
def _tree_signature(small) -> Tuple:
    layers = tuple(sorted(
        (kind, tuple(sorted((p, tuple(v.shape))
                            for p, v in _flatten(stack).items())))
        for kind, stack in small["layers"].items()))
    top = tuple(sorted((p, tuple(v.shape)) for p, v in _flatten(
        {k: v for k, v in small.items() if k != "layers"}).items()))
    return (layers, top)


@functools.lru_cache(maxsize=128)
def _build_plan(cfg1: ModelConfig, cfg2: ModelConfig, sig) -> GrowthPlan:
    layers_sig, top_sig = sig
    c2 = _kind_counts(cfg2)
    groups = []
    exprs: Dict[ExprRef, Any] = {}
    hop = S.family_hop(cfg1, cfg2)
    kmap = hop["kind_map"] if hop else {}
    renames = hop["renames"] if hop else {}
    bcast_map = hop["broadcast"] if hop else {}

    def register(expr, role: str) -> Optional[ExprRef]:
        if expr is None:
            return None
        ref_ = (_expr_key(expr), role)
        exprs.setdefault(ref_, expr)
        return ref_

    for kind, leaves in layers_sig:
        lspec = S.layer_spec(kind, cfg1, cfg2)
        stacked = kind != "shared_attn"
        tgt_kind = kmap.get(kind, kind)
        L2 = c2.get(tgt_kind, 0)
        buckets: Dict[Tuple, list] = {}
        for path, shape in leaves:
            in_e, out_e = lspec[path]
            vec = len(shape) == (2 if stacked else 1)
            dst = renames.get(path, path)
            bc = bcast_map.get(dst, 0)
            key = (shape, _expr_key(in_e) if not vec else None,
                   _expr_key(out_e), vec, bc)
            buckets.setdefault(key, []).append((path, dst, in_e, out_e))
        for (shape, _ik, _ok, vec, bc), members in sorted(buckets.items(),
                                                          key=str):
            paths = tuple(p for p, _, _, _ in members)
            dsts = tuple(d for _, d, _, _ in members)
            in_e, out_e = members[0][2], members[0][3]
            g = _plan_group(kind, stacked, paths, shape,
                            None if vec else in_e, out_e, vec, L2, cfg1, cfg2)
            if hop is not None:
                g = dataclasses.replace(
                    g, out_kind=tgt_kind if tgt_kind != kind else "",
                    out_paths=dsts if dsts != paths else (), bcast=bc)
            if not vec:
                register(in_e, "in")
            register(out_e, "out")
            groups.append(g)

    tspec = S.top_spec()
    buckets = {}
    for path, shape in top_sig:
        in_e, out_e = tspec[path]
        vec = len(shape) == 1
        key = (shape, _expr_key(in_e) if not vec else None,
               _expr_key(out_e), vec)
        buckets.setdefault(key, []).append((path, in_e, out_e))
    for (shape, _ik, _ok, vec), members in sorted(buckets.items(), key=str):
        paths = tuple(p for p, _, _ in members)
        in_e, out_e = members[0][1], members[0][2]
        g = _plan_group("", False, paths, shape, None if vec else in_e,
                        out_e, vec, 0, cfg1, cfg2)
        if not vec:
            register(in_e, "in")
        register(out_e, "out")
        groups.append(g)

    created: Dict[str, Dict[str, Tuple]] = {}
    if hop is not None:
        for kind, leaves_c in hop.get("created", {}).items():
            created[kind] = {
                path: ((c2[kind],) + tuple(shape), dt)
                for path, (shape, dt) in leaves_c.items()}
    return GrowthPlan(cfg1, cfg2, tuple(groups), exprs, created)


def plan_for(cfg1: ModelConfig, cfg2: ModelConfig, small) -> GrowthPlan:
    """The (memoised) GrowthPlan for growing ``small`` from cfg1 to cfg2."""
    return _build_plan(cfg1, cfg2, _tree_signature(small))


# ---------------------------------------------------------------------------
# Operator composition: stage-A→B ∘ stage-B→C as a single A→C operator
# ---------------------------------------------------------------------------
# Every hop is linear in Θ, the depth blend acts on the layer axis and the
# width expanders on the matrix axes, so successive hops compose:
#   P₃ = w_B·(E_B P₂ F_Bᵀ),  P₂ = w_A·(E_A W F_Aᵀ)
#      = (w_B w_A)·((E_B E_A) W (F_B F_A)ᵀ)
# The tying registry commutes with this (Γ₂₃(B)·Γ₁₂(A) = Γ₁₃(B·A)), so only
# the *named* width matrices compose. This exactness holds for the linear map
# (parameters, first moments), not for the squared second-moment operator.
def _chain_matmul(B: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """``B @ A`` for two operator factors, computed in float64 and rounded
    once to the storage dtype, so the composed operator carries no
    accumulation error of its own."""
    out = B.to(torch.float64) @ A.to(torch.float64)
    return out.to(torch.promote_types(B.dtype, A.dtype))


def compose_ligo(op_a: Dict, op_b: Dict, cfg1: ModelConfig,
                 cfg2: ModelConfig, cfg3: ModelConfig) -> Dict:
    """Compose LiGO operators ``op_a: cfg1→cfg2`` and ``op_b: cfg2→cfg3``
    into the equivalent single-hop ``cfg1→cfg3`` operator.

    Untied in-expanders (``<name>__in``) compose role-wise, falling back to
    the tied matrix when a hop has no override.
    """
    S.check_growable(cfg1, cfg2)
    S.check_growable(cfg2, cfg3)
    wa, wb = op_a["width"], op_b["width"]
    width: Dict[str, torch.Tensor] = {}
    for name in sorted(n for n in wb if not n.endswith("__in")):
        if name not in wa:
            raise KeyError(f"width expander {name!r} missing from the "
                           f"first-hop operator")
        A, B = wa[name], wb[name]
        if A.shape[0] != B.shape[1]:
            raise ValueError(f"{name}: hop dims do not chain "
                             f"({tuple(A.shape)} then {tuple(B.shape)})")
        width[name] = _chain_matmul(B, A)
        if f"{name}__in" in wa or f"{name}__in" in wb:
            Ai = wa.get(f"{name}__in", A)
            Bi = wb.get(f"{name}__in", B)
            width[f"{name}__in"] = _chain_matmul(Bi, Ai)
    depth: Dict[str, Any] = {}
    da, db = op_a.get("depth", {}), op_b.get("depth", {})
    c1, c2_, c3 = (_kind_counts(cfg1), _kind_counts(cfg2),
                   _kind_counts(cfg3))
    for kind in sorted(set(da) | set(db)):
        ta, tb = da.get(kind), db.get(kind)
        if ta is None or tb is None:
            # one hop carries no blend for this kind — an implicit identity,
            # only sound when that hop does not change the layer count
            lo, hi = ((c1, c2_) if ta is None else (c2_, c3))
            if lo.get(kind, 0) != hi.get(kind, 0):
                raise ValueError(
                    f"hop without a depth blend for kind {kind!r} changes "
                    f"its layer count {lo.get(kind, 0)} -> "
                    f"{hi.get(kind, 0)} — cannot compose through an "
                    f"implicit identity")
            depth[kind] = dict(tb if ta is None else ta)
            continue
        if sorted(ta) != sorted(tb):
            raise ValueError(f"depth leaf sets differ for kind {kind!r}")
        depth[kind] = {leaf: _chain_matmul(tb[leaf], ta[leaf])
                       for leaf in ta}
    return {"width": width, "depth": depth}


def compose_chain(ops_, cfgs) -> Dict:
    """Fold a whole trajectory's operators ``[op₁₂, op₂₃, …]`` over the
    config chain ``[cfg₁, cfg₂, …, cfg_N]`` into one ``cfg₁→cfg_N``
    operator (a single-entry chain passes through unchanged)."""
    if len(ops_) != len(cfgs) - 1:
        raise ValueError(f"{len(ops_)} operators need {len(ops_) + 1} "
                         f"configs, got {len(cfgs)}")
    if not ops_:
        raise ValueError("empty operator chain")
    out = ops_[0]
    for i in range(1, len(ops_)):
        out = compose_ligo(out, ops_[i], cfgs[0], cfgs[i], cfgs[i + 1])
    return out
