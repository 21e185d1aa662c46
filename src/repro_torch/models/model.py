"""Model API over the ported families: init, forward, prefill, decode.

The families: dense attention and MoE (text, vision, audio or VLM
input), xLSTM (``family="ssm"``: (mLSTM, sLSTM) pairs) and the Mamba2
hybrid (``family="hybrid"``: groups of ``shared_attn_every`` Mamba2
layers, each group followed by the one shared, parameter-tied attention
block). Text models embed tokens; vision models (DeiT, CaiT:
``modality="vision"``) take precomputed patch embeddings behind a learned
cls token; audio models (hubert-xlarge) take precomputed frame
embeddings, a learned ``mask_emb`` in place of each masked frame; VLM
models (qwen2-vl-72b) embed tokens and put precomputed patch embeddings
in place of the first ones, with (t, h, w) M-RoPE position ids read from
the batch. The frontends are the JAX package's stubs.

``init_params(cfg, gen, device=...)`` returns the JAX package's parameter
tree: ``params["layers"][kind][leaf]`` stacked over a leading L dim, one
stack per block kind (``"attn"``, ``"moe"``, ``"mlstm"`` and ``"slstm"``,
``"mamba2"``), the hybrid's shared block unstacked under
``params["layers"]["shared_attn"]``, weights ``(in, out)``. An MoE forward
also sums its layers' router auxiliary losses (``return_aux``). ``forward``
loops over the layers in Python where the JAX package scans;
``remat=True`` checkpoints each layer (each xLSTM pair, each hybrid group)
in training (the JAX package's ``jax.checkpoint``).

Decode state. The attention families' caches are ``{"k", "v"}: (L, B, S,
KV, dh)``; the xLSTM family's a tuple ``(mLSTM {"conv", "S", "n"}, sLSTM
{"h", "c", "n", "m"})`` stacked over the L/2 pairs; the hybrid's a tuple
``(Mamba2 {"conv", "S", "n"}`` over L, ``{"k", "v"}`` over the G = L/k
insertions of the shared block). ``decode_step`` writes each new token's
cache and state into them in place. The decode position ``state["pos"]``
is a Python int when all rows of a batch step in lock step (``prefill``
and ``init_decode_state`` make it so), or a (B,) int64 tensor when each
row is at its own position (the serving engine's continuous batching; a
recurrent leaf needs no position, the hybrid's attention caches write each
row at its own); a ``state["pages"]`` (B, P) page table switches the
caches to the paged block pools of ``serving.kv_pages`` (attention
families only). ``write_slot`` overwrites one batch row of every leaf from
a batch-1 prefill, ``slot_bytes`` counts the bytes of one row.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.layers import apply_norm, embed_init, init_norm
from repro_torch.tree import tree_leaves, tree_map

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(cfg):
    return DTYPES[cfg.dtype]


# block-kind sets of the ported layer stacks, by family dispatch
_STACKS = ({"attn"}, {"moe"}, {"mlstm", "slstm"}, {"mamba2"})


def _check_ported(cfg: ModelConfig) -> None:
    if (cfg.modality not in ("text", "vision", "audio", "vlm")
            or set(cfg.blocks) not in _STACKS
            or (cfg.family == "hybrid") != (set(cfg.blocks) == {"mamba2"})
            or (cfg.family == "ssm") != ("mlstm" in cfg.blocks)
            or cfg.rope not in ("learned", "rope", "mrope", "none")):
        raise NotImplementedError(
            f"{cfg.name}: the JAX package's models have no such "
            f"configuration (family={cfg.family!r}, "
            f"modality={cfg.modality!r}, rope={cfg.rope!r}, "
            f"blocks={sorted(set(cfg.blocks))})")


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device="cuda") -> Dict[str, Any]:
    """Random parameters drawn from ``gen``, which must live on ``device``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    params: Dict[str, Any] = {"embed": {}, "layers": {}}
    if cfg.modality in ("audio", "vision"):
        # hubert's mask embedding, the vision models' cls token
        name = "mask_emb" if cfg.modality == "audio" else "cls"
        params["embed"][name] = (torch.randn(
            (cfg.d_model,), generator=gen, device=dev) * 0.02).to(dtype)
    else:
        params["embed"]["tok"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                            dtype=dtype, device=dev)
    if cfg.rope == "learned":
        params["embed"]["pos"] = embed_init(gen, cfg.max_seq, cfg.d_model,
                                            dtype=dtype, device=dev)
    counts: Dict[str, int] = {}
    for kind in cfg.blocks:
        counts[kind] = counts.get(kind, 0) + 1
    for kind in sorted(counts):           # the JAX package's stack order
        params["layers"][kind] = B.INIT[kind](gen, cfg, dtype=dtype,
                                              device=dev,
                                              lead=(counts[kind],))
    if cfg.family == "hybrid":
        # the single shared attention block, parameter-tied across its G
        # insertions: unstacked
        params["layers"]["shared_attn"] = B.init_attn(gen, cfg, dtype=dtype,
                                                      device=dev)
    params["final_norm"] = init_norm(cfg.norm, cfg.d_model, dtype=dtype,
                                     device=dev)
    if not (cfg.tie_embeddings and "tok" in params["embed"]):
        params["head"] = embed_init(gen, cfg.d_model, cfg.vocab_size,
                                    dtype=dtype, device=dev)
    return params


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
          offset=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,T,D), positions). A vision batch's ``patches`` (B, P,
    D) follow the cls token: T = P + 1. An audio batch's ``frames`` (B, T,
    D) are cast to the model's dtype, ``mask_emb`` in place of each frame
    whose ``mask`` is set. A VLM batch's ``patch_embeds`` (B, P, D), cast
    to the embedding's dtype, replace the first P token embeddings.
    ``offset`` is an int (positions (1, T), every row from the same start)
    or a (B,) tensor (positions (B, T), each row from its own start:
    continuous batching); with M-RoPE the positions are the batch's own
    ``positions`` (B, T, 3) and ``offset`` is not read."""
    emb = params["embed"]
    if cfg.modality == "audio":
        x = batch["frames"].to(_dtype(cfg))
        if "mask" in batch:
            x = torch.where(batch["mask"][..., None], emb["mask_emb"], x)
    elif cfg.modality == "vision":
        patches = batch["patches"].to(_dtype(cfg))
        cls = emb["cls"].expand(patches.shape[0], 1, cfg.d_model)
        x = torch.cat([cls, patches], dim=1)
    else:
        x = emb["tok"][batch["tokens"]]
        if cfg.modality == "vlm" and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(x.dtype)
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    T = x.shape[1]
    if cfg.rope == "mrope":
        return x, batch["positions"]
    if isinstance(offset, torch.Tensor) and offset.dim():
        positions = torch.arange(T, device=x.device)[None] + offset[:, None]
        if cfg.rope == "learned":
            x = x + emb["pos"][positions]
        return x, positions
    positions = torch.arange(T, device=x.device)[None] + offset
    if cfg.rope == "learned":
        x = x + emb["pos"][positions[0]]
    return x, positions


def unembed(params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings and "tok" in params["embed"]:
        return hidden @ params["embed"]["tok"].T
    return hidden @ params["head"]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _apply_layer(p, x, cfg, positions, **kw):
    """One layer of either kind: (x, new_cache, aux); an attention layer's
    aux is None."""
    if "moe" in p:
        return B.apply_moe_block(p, x, cfg, positions, **kw)
    return B.apply_attn(p, x, cfg, positions, **kw) + (None,)


def _train_layer(p, x, cfg, positions):
    out, _, aux = _apply_layer(p, x, cfg, positions, mode="train")
    return out if aux is None else (out, aux)


def _fwd_homogeneous(params, x, cfg, positions, *, mode, caches, cur_len,
                     remat, use_kernel, pages=None):
    """Returns (x, caches, aux): the layers' router losses summed in layer
    order in float32 (0 for the dense family), as the JAX package's scan
    carries them."""
    stack = params["layers"][cfg.blocks[0]]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new = []
    for i in range(cfg.n_layers):
        if mode == "train" and remat:
            # the twin of the JAX package's _maybe_remat: keep only the
            # layer's input; recompute its activations in the backward pass
            out = checkpoint(_train_layer, _index(stack, i), x, cfg,
                             positions, use_reentrant=False)
            if isinstance(out, tuple):
                x, a = out
                aux = aux + a
            else:
                x = out
            continue
        c = _index(caches, i) if caches is not None else None
        x, nc, a = _apply_layer(_index(stack, i), x, cfg, positions,
                                mode=mode, cache=c, cur_len=cur_len,
                                use_kernel=use_kernel, pages=pages)
        if a is not None:
            aux = aux + a
        new.append(nc)
    if mode == "train":
        return x, None, aux
    if mode == "decode":
        return x, caches, aux                 # written in place
    return x, {kk: torch.stack([c[kk] for c in new])
               for kk in ("k", "v")}, aux


def _stack_trees(trees):
    """Per-layer cache dicts → one dict of stacked leaves."""
    return {kk: torch.stack([t[kk] for t in trees]) for kk in trees[0]}


def _write_state(stacked, i: int, new) -> None:
    """Layer ``i``'s new recurrent state, written in place into the
    stacked decode state."""
    for kk, vv in new.items():
        stacked[kk][i].copy_(vv)


def _xlstm_pair(pm, ps, x, cfg, mode, cm=None, cs=None):
    x, ncm = B.apply_mlstm(pm, x, cfg, mode=mode, cache=cm)
    x, ncs = B.apply_slstm(ps, x, cfg, mode=mode, cache=cs)
    return x, ncm, ncs


def _xlstm_pair_train(pm, ps, x, cfg):
    return _xlstm_pair(pm, ps, x, cfg, "train")[0]


def _fwd_xlstm(params, x, cfg, *, mode, caches, remat):
    """(mLSTM, sLSTM) pairs over the L/2 super-blocks. Returns (x, caches):
    None in train mode, the caches updated in place in decode mode, the
    stacked prefill state otherwise."""
    pm_all, ps_all = params["layers"]["mlstm"], params["layers"]["slstm"]
    new_m, new_s = [], []
    for i in range(cfg.n_layers // 2):
        pm, ps = _index(pm_all, i), _index(ps_all, i)
        if mode == "train":
            x = (checkpoint(_xlstm_pair_train, pm, ps, x, cfg,
                            use_reentrant=False) if remat
                 else _xlstm_pair_train(pm, ps, x, cfg))
            continue
        cm = cs = None
        if caches is not None:
            cm, cs = _index(caches[0], i), _index(caches[1], i)
        x, ncm, ncs = _xlstm_pair(pm, ps, x, cfg, mode, cm, cs)
        if mode == "decode":
            _write_state(caches[0], i, ncm)
            _write_state(caches[1], i, ncs)
        else:
            new_m.append(ncm)
            new_s.append(ncs)
    if mode == "train":
        return x, None
    if mode == "decode":
        return x, caches
    return x, (_stack_trees(new_m), _stack_trees(new_s))


def _zamba_group(pms, p_a, x, cfg, positions, mode, cms=None, ca=None, *,
                 cur_len=None, use_kernel=None):
    """One group: ``len(pms)`` Mamba2 layers, then the shared attention
    block. Returns (x, the Mamba2 layers' new caches, the attention
    cache)."""
    ncs = []
    for j, pm in enumerate(pms):
        x, nc = B.apply_mamba2(pm, x, cfg, mode=mode,
                               cache=None if cms is None else cms[j])
        ncs.append(nc)
    x, nca = B.apply_attn(p_a, x, cfg, positions, mode=mode, cache=ca,
                          cur_len=cur_len, use_kernel=use_kernel)
    return x, ncs, nca


def _zamba_group_train(pms, p_a, x, cfg, positions, use_kernel):
    return _zamba_group(pms, p_a, x, cfg, positions, "train",
                        use_kernel=use_kernel)[0]


def _fwd_zamba(params, x, cfg, positions, *, mode, caches, cur_len, remat,
               use_kernel):
    """Groups of ``shared_attn_every`` Mamba2 layers, each followed by the
    one shared attention block (its K/V caches stacked over the G
    groups). Returns (x, caches) as :func:`_fwd_xlstm` does."""
    k = cfg.shared_attn_every
    L = cfg.n_layers
    if L % k:
        raise ValueError(f"{cfg.name}: n_layers {L} is not a multiple of "
                         f"shared_attn_every {k}")
    p_a = params["layers"]["shared_attn"]
    pm_all = params["layers"]["mamba2"]
    new_m, new_a = [], []
    for g in range(L // k):
        pms = [_index(pm_all, g * k + j) for j in range(k)]
        if mode == "train":
            x = (checkpoint(_zamba_group_train, pms, p_a, x, cfg, positions,
                            use_kernel, use_reentrant=False) if remat
                 else _zamba_group_train(pms, p_a, x, cfg, positions,
                                         use_kernel))
            continue
        cms = ca = None
        if caches is not None:
            cms = [_index(caches[0], g * k + j) for j in range(k)]
            ca = _index(caches[1], g)
        x, ncs, nca = _zamba_group(pms, p_a, x, cfg, positions, mode, cms,
                                   ca, cur_len=cur_len, use_kernel=use_kernel)
        if mode == "decode":
            for j, nc in enumerate(ncs):
                _write_state(caches[0], g * k + j, nc)
        else:
            new_m += ncs
            new_a.append(nca)
    if mode == "train":
        return x, None
    if mode == "decode":
        return x, caches             # attention caches written in place
    return x, (_stack_trees(new_m), _stack_trees(new_a))


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            mode: str = "train", caches=None, cur_len=None,
            remat: bool = False, use_kernel: Optional[bool] = None,
            pages: Optional[torch.Tensor] = None,
            return_prenorm: bool = False, return_aux: bool = False):
    """Returns (hidden (B,T,D), new_caches), then the layers' summed router
    auxiliary loss (a float32 scalar, 0 for the dense family) when
    ``return_aux=True``, then the pre-final-norm residual stream when
    ``return_prenorm=True`` (the serving engine keeps it, so a depth-only
    hop can replay just the new layers;
    ``core.grow_cache.replay_grow_state``).

    ``remat`` (train mode only) recomputes each layer's activations in the
    backward pass instead of keeping them, one layer at a time (an xLSTM
    pair, a hybrid group of Mamba2 layers and the shared block).
    ``use_kernel`` picks the train and prefill attention route: ``None``
    takes kernel K3 on CUDA where autograd records nothing, ``False`` the
    chunked attention (``layers.full_attention``). ``pages`` (decode mode):
    the (B, P) page table of the paged cache layout."""
    _check_ported(cfg)
    offset = cur_len - 1 if mode == "decode" else 0
    x, positions = embed(params, cfg, batch, offset=offset)
    if cfg.family in ("ssm", "hybrid"):
        if pages is not None:
            raise ValueError("paged KV: attention-cache families only")
        if cfg.family == "ssm":
            x, new_caches = _fwd_xlstm(params, x, cfg, mode=mode,
                                       caches=caches, remat=remat)
        else:
            x, new_caches = _fwd_zamba(params, x, cfg, positions, mode=mode,
                                       caches=caches, cur_len=cur_len,
                                       remat=remat, use_kernel=use_kernel)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x, new_caches, aux = _fwd_homogeneous(
            params, x, cfg, positions, mode=mode, caches=caches,
            cur_len=cur_len, remat=remat, use_kernel=use_kernel, pages=pages)
    prenorm = x
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return ((x, new_caches) + ((aux,) if return_aux else ())
            + ((prenorm,) if return_prenorm else ()))


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ModelConfig, batch_size: int, seq_len: int, *,
                      device="cuda"):
    """Zero-initialised per-layer caches + position counter (the sLSTM
    stabiliser ``m`` at -1e30)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    S = min(cfg.window, seq_len) if cfg.window else seq_len

    def zeros(shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=dev)

    def attn_cache(n):
        shape = (n, batch_size, S, cfg.n_kv_heads, cfg.d_head)
        return {kk: zeros(shape, dtype) for kk in ("k", "v")}

    di = cfg.ssm_expand * cfg.d_model
    K1 = cfg.conv_kernel - 1
    if cfg.family == "ssm":
        n, H = cfg.n_layers // 2, cfg.n_heads
        dh = di // H
        m = {"conv": zeros((n, batch_size, K1, di), dtype),
             "S": zeros((n, batch_size, H, dh, dh)),
             "n": zeros((n, batch_size, H, dh))}
        s = {kk: zeros((n, batch_size, cfg.d_model)) for kk in ("h", "c", "n")}
        s["m"] = torch.full((n, batch_size, cfg.d_model), -1e30,
                            dtype=torch.float32, device=dev)
        caches = (m, s)
    elif cfg.family == "hybrid":
        L, H, N = cfg.n_layers, cfg.mamba_heads, cfg.ssm_state
        m = {"conv": zeros((L, batch_size, K1, di + 2 * N), dtype),
             "S": zeros((L, batch_size, H, N, di // H)),
             "n": zeros((L, batch_size, H, N))}
        caches = (m, attn_cache(L // cfg.shared_attn_every))
    else:
        caches = attn_cache(cfg.n_layers)
    return {"caches": caches, "pos": 0}


def decode_step(params, cfg: ModelConfig, state, batch: Dict[str, torch.Tensor],
                *, return_prenorm: bool = False) -> Tuple[torch.Tensor, Any]:
    """One-token decode: batch["tokens"]: (B, 1), and with M-RoPE its
    ``positions`` (B, 1, 3), which set the rotary angles (the cache row
    still comes from ``state["pos"]``). Returns (logits (B,V),
    state); the state's caches are updated in place. A ``state["pages"]``
    entry switches to the paged layout and rides through unchanged (the
    host owns the table). With ``return_prenorm`` the result is (logits,
    state, prenorm (B, 1, D))."""
    cur_len = state["pos"] + 1
    out = forward(params, cfg, batch, mode="decode", caches=state["caches"],
                  cur_len=cur_len, pages=state.get("pages"),
                  return_prenorm=return_prenorm)
    logits = unembed(params, cfg, out[0][:, -1])
    new_state = {"caches": out[1], "pos": cur_len}
    if "pages" in state:
        new_state["pages"] = state["pages"]
    if return_prenorm:
        return logits, new_state, out[2]
    return logits, new_state


def write_slot(caches, caches1, slot: int) -> None:
    """Write row ``slot`` of every leaf of the decode-state tree ``caches``
    from the batch-1 tree ``caches1`` of the same structure, in place.
    Every leaf carries the batch at axis 1 (the attention K/V caches, the
    recurrent ``conv``, ``S``, ``n`` and the sLSTM's ``h``, ``c``, ``n``,
    ``m``), so one rule covers the whole tree: a slot's row is overwritten
    completely, the sLSTM stabiliser's -1e30 start and the zero conv tail
    included, whatever its previous session left there."""
    def write(leaf, row):
        if row.shape != leaf.shape[:1] + (1,) + leaf.shape[2:]:
            # no silent broadcast of a short row
            raise ValueError(f"a slot row of shape {tuple(row.shape)} does "
                             f"not fit the state leaf {tuple(leaf.shape)}")
        leaf[:, slot] = row[:, 0]
    tree_map(write, caches, caches1)


def slot_bytes(caches) -> Dict[str, int]:
    """Bytes one batch row of the decode-state tree ``caches`` holds,
    split into ``"attention"`` (every ``{"k", "v"}`` block of the tree:
    the whole of an attention family's, the hybrid's second) and
    ``"recurrent"`` (every other leaf): each leaf's bytes over its batch
    axis (axis 1)."""
    def row(tree):
        return sum(x.numel() // x.shape[1] * x.element_size()
                   for x in tree_leaves(tree))
    blocks = caches if isinstance(caches, tuple) else (caches,)
    attn = sum(row(b) for b in blocks if set(b) == {"k", "v"})
    return {"recurrent": row(caches) - attn, "attention": attn}


def _pad_attn_caches(caches, S_target: int):
    """Grow the attention K/V caches (seq axis = -3) to the decode budget:
    every ``{"k", "v"}`` dict of the cache tree, also inside the recurrent
    families' tuples; recurrent state is left as it is."""
    def pad(leaf):
        S = leaf.shape[-3]
        if S >= S_target:
            return leaf
        return F.pad(leaf, (0, 0, 0, 0, 0, S_target - S))
    if isinstance(caches, tuple):
        return tuple(_pad_attn_caches(c, S_target) for c in caches)
    if isinstance(caches, dict) and set(caches) == {"k", "v"}:
        return {kk: pad(vv) for kk, vv in caches.items()}
    return caches


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            max_len: Optional[int] = None, use_kernel: Optional[bool] = None):
    """Full-sequence forward building decode caches. Returns
    (logits of the last position (B, V), state).

    ``max_len`` reserves cache space for subsequent decode steps (defaults to
    the prompt length — no room to decode). ``use_kernel`` as in
    :func:`forward` (``False``: the plain attention route on the card).
    """
    T = (batch["tokens"] if "tokens" in batch else batch["frames"]).shape[1]
    hidden, caches = forward(params, cfg, batch, mode="prefill",
                             use_kernel=use_kernel)
    if max_len is not None and max_len > T:
        S_target = min(cfg.window, max_len) if cfg.window else max_len
        caches = _pad_attn_caches(caches, S_target)
    logits = unembed(params, cfg, hidden[:, -1])
    return logits, {"caches": caches, "pos": T}
