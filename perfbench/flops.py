"""The yardstick's arithmetic: peaks, the operations a step requires, and
the least time of a call of kernels K1 and K2.

Frozen here so that a later change to the program cannot move it:

- ``PEAK_OPS`` and ``PEAK_BYTES``: one H100 SXM's published dense peaks
  (NVIDIA's data sheet; the same table as ``chip_smoke.py``'s ``bound_ms``).
- ``k1_*`` and ``k2_*``: copies of ``operation_count`` and
  ``least_operations`` of ``repro_torch/kernels/ligo_expand.py`` and
  ``ligo_expand_bwd.py`` as they stood when this benchmark was written.
- :func:`model_step_ops`: the operations one training step of a dense
  transformer requires, ``6 · N · tokens`` over the matmul parameters
  (the unembedding included) plus causal attention's ``6 · L · T · d``
  a token (``d`` the query width: QKᵀ and PV each ``2 · T · d`` a token
  over the full square, halved by the causal mask, and the backward
  twice the forward). Nothing recomputed is counted.
- :func:`grow_step_ops`: the LiGO operator's forward, in the order of
  fewest operations for each leaf, and its backward at twice that.
"""
from __future__ import annotations

from itertools import permutations
from typing import Dict, Optional, Tuple

PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


# -- K1 and K2 (copies of the kernels' own arithmetic) ----------------------
def k1_operation_count(G, L2, L1, E, I, A, Bd, stage="both"):
    expand = 2 * G * E * L1 * I * A * Bd
    blend = 2 * G * E * L2 * L1 * I * Bd
    return {"both": expand + blend, "expand": expand, "blend": blend}[stage]


def k1_least_operations(G, L2, L1, E, I, A, Bd):
    fused = 2 * G * E * L2 * (L1 * A * Bd + I * A * Bd)
    return min(fused, k1_operation_count(G, L2, L1, E, I, A, Bd))


def k2_operation_count(G, L2, L1, E, I, A, Bd, *, u_given=False,
                       need_dW=True, q_given=False, need_dB=True,
                       need_dw=True):
    prod = 2 * G * E * L1 * I * A * Bd
    blend = 2 * G * E * L2 * L1 * I * Bd
    return ((0 if q_given else blend) + (prod if need_dW else 0)
            + (prod if need_dB else 0)
            + ((blend + (0 if u_given else prod)) if need_dw else 0))


def k2_least_operations(G, L2, L1, E, I, A, Bd, *, u_given=False,
                        need_dW=True):
    fused = ((2 if need_dW else 1) * 2 * G * E * L2 * I * A * Bd
             + (3 if need_dW else 2) * 2 * G * E * L2 * L1 * A * Bd)
    own = k2_operation_count(G, L2, L1, E, I, A, Bd, u_given=u_given,
                             need_dW=need_dW)
    return min(fused, own)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def kernel_call_seconds(op: str, dims, types) -> Optional[float]:
    """The least time of one call of a K1 or K2 custom op, from its
    recorded operand shapes ``dims`` and element types ``types`` (the
    profiler's ``Input Dims`` and ``Input type``): the larger of its
    fewest operations at the peak of its inputs' type (bf16 where any
    operand is bf16) and its fewest bytes at the memory's peak, every
    operand read once and every result written once. None for an op this
    table does not know."""
    bound = kernel_call_bound(op, dims, types)
    if bound is None:
        return None
    dtype = "bfloat16" if any("BFloat16" in t for t in types) else "float32"
    return least_seconds(*bound, dtype=dtype)


def kernel_call_bound(op: str, dims, types) -> Optional[Tuple[int, int]]:
    """(fewest operations, fewest bytes) of one call of a K1 or K2 custom
    op; see :func:`kernel_call_seconds`."""
    name = op.split("::")[-1]
    dt = [("bfloat16" if "BFloat16" in t else "float32") for t in types]

    def nbytes(i):
        return _numel(dims[i]) * ELEMENT_BYTES[dt[i]]

    if name == "ligo_blend_expand_grouped":            # w, B, W -> P
        (G, L2, L1), (I, A), (_, _, E, _, Bd) = dims[:3]
        ops = k1_least_operations(G, L2, L1, E, I, A, Bd)
        out = G * L2 * E * I * Bd * ELEMENT_BYTES[dt[2]]
        return ops, nbytes(0) + nbytes(1) + nbytes(2) + out
    if name == "ligo_expand":                          # B, W -> U (f32)
        (I, A), (G, L1, E, _, Bd) = dims[:2]
        ops = k1_operation_count(G, 1, L1, E, I, A, Bd, stage="expand")
        return ops, nbytes(0) + nbytes(1) + 4 * G * L1 * E * I * Bd
    if name == "ligo_blend":                           # w, U -> P
        (G, L2, L1), (_, _, E, I, Bd) = dims[:2]
        ops = k1_operation_count(G, L2, L1, E, I, 1, Bd, stage="blend")
        return ops, nbytes(0) + nbytes(1) + 2 * G * L2 * E * I * Bd
    if name == "ligo_blend_expand_bwd_fused":          # w, B, W, dP, U
        (G, L2, L1), (I, A), (_, _, E, _, Bd) = dims[:3]
        u_given = len(dims) > 4 and len(dims[4]) > 0
        need_dW = False          # the LiGO phase freezes the source tree
        ops = k2_least_operations(G, L2, L1, E, I, A, Bd, u_given=u_given,
                                  need_dW=need_dW)
        read = sum(nbytes(i) for i in range(4)) + (nbytes(4) if u_given
                                                   else 0)
        return ops, read + 4 * _numel(dims[0]) + nbytes(1)
    if name == "ligo_blend_bwd":                       # w, dP, U -> dw, Q
        (G, L2, L1), _, (_, _, E, I, Bd) = dims[:3]
        ops = k2_operation_count(G, L2, L1, E, I, 1, Bd, u_given=True,
                                 need_dW=False, need_dB=False)
        q = G * L1 * E * I * Bd * ELEMENT_BYTES[dt[1]]
        return ops, nbytes(0) + nbytes(1) + nbytes(2) + 4 * _numel(dims[0]) + q
    if name == "ligo_expand_bwd":                      # B, W, Q -> dB
        (I, A), (G, L1, E, _, Bd) = dims[:2]
        ops = k2_operation_count(G, 1, L1, E, I, A, Bd, q_given=True,
                                 need_dW=False, need_dw=False)
        return ops, nbytes(0) + nbytes(1) + nbytes(2) + nbytes(0)
    return None


def least_seconds(ops: float, nbytes: float, dtype: str = "bfloat16"
                  ) -> float:
    return max(ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES)


# -- whole steps -------------------------------------------------------------
def matmul_params(geom: Dict) -> int:
    """Parameters that enter a matmul each token: every layer's
    projections and MLP, and the (tied) unembedding."""
    D, F = geom["d_model"], geom["d_ff"]
    q = geom["n_heads"] * geom["d_head"]
    kv = geom["n_kv_heads"] * geom["d_head"]
    mlp = (3 if geom["act"] == "swiglu" else 2) * D * F
    return geom["n_layers"] * (2 * D * q + 2 * D * kv + mlp) \
        + geom["vocab"] * D


def model_step_ops(geom: Dict, rows: int, seq: int) -> float:
    """Operations one forward and backward of the model requires."""
    tokens = rows * seq
    q = geom["n_heads"] * geom["d_head"]
    return (6.0 * matmul_params(geom) * tokens
            + 6.0 * geom["n_layers"] * seq * q * tokens)


def _fewest(L1: int, L2: int, a: int, b: int, I: Optional[int],
            J: Optional[int], stacked: bool) -> int:
    """Fewest operations to grow one leaf (L1, a, b) into (L2, I, J): the
    depth blend and the two width expansions in their cheapest order."""
    best = None
    steps = [s for s, on in (("blend", stacked), ("in", I is not None),
                             ("out", J is not None)) if on]
    for order in permutations(steps):
        n, r, c, cost = L1, a, b, 0
        for s in order:
            if s == "blend":
                cost += 2 * L2 * n * r * c
                n = L2
            elif s == "in":
                cost += 2 * n * I * r * c
                r = I
            else:
                cost += 2 * n * r * c * J
                c = J
        best = cost if best is None else min(best, cost)
    return best or 0


def grow_step_ops(geom1: Dict, geom2: Dict) -> float:
    """The LiGO operator's forward at its fewest operations, plus its
    backward at twice that, for the dense attention block's leaves."""
    from perfbench.weights import leaf_specs, width_dims
    d2 = width_dims(geom2)
    out_of = {"wq": "q", "wk": "k", "wv": "v", "wo": "emb", "w1": "fc",
              "w3": "fc", "w2": "emb", "bq": "q", "bk": "k", "bv": "v",
              "bo": "emb", "b1": "fc", "b2": "emb"}
    in_of = {"wq": "emb", "wk": "emb", "wv": "emb", "wo": "q", "w1": "emb",
             "w3": "emb", "w2": "fc"}
    L1, L2 = geom1["n_layers"], geom2["n_layers"]
    total = 0
    for path, shape, _ in leaf_specs(geom1):
        leaf = path.split("/")[-1]
        if path.startswith("layers/"):
            if leaf in ("scale", "bias"):
                total += _fewest(L1, L2, 1, shape[-1], None, d2["emb"], True)
            elif leaf in in_of:
                total += _fewest(L1, L2, shape[1], shape[2], d2[in_of[leaf]],
                                 d2[out_of[leaf]], True)
            else:
                total += _fewest(L1, L2, 1, shape[-1], None,
                                 d2[out_of[leaf]], True)
        elif len(shape) == 2:                    # embeddings: (rows, D)
            total += _fewest(1, 1, shape[0], shape[1], None, d2["emb"], False)
        else:                                    # final norm vectors
            total += _fewest(1, 1, 1, shape[0], None, d2["emb"], False)
    return 3.0 * total
