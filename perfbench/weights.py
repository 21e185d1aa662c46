"""Weights, the LiGO operator and sub-seeds, made from the run's seed.

Both sides of a comparison take their inputs from here: the program
receives the trees this module makes, and the reference makes the same
trees again from the same seed. The trees have the layout the program
reads (``params["layers"]["attn"][leaf]`` stacked over a leading layer
axis, weights ``(in, out)``), which is also the layout the reference
reads. Everything is drawn on the device in a few large calls: one normal
draw for every weight matrix of a model, in the type it is trained in.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

STD = 0.02          # GPT-2's init scale, for every matrix and embedding
OPERATOR_NOISE = 0.01


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (``tag``) of the run's ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def leaf_specs(geom: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(path, shape, init) of every leaf, in the program's tree order;
    init is ``normal``, ``ones`` or ``zeros``."""
    L, D, F = geom["n_layers"], geom["d_model"], geom["d_ff"]
    q = geom["n_heads"] * geom["d_head"]
    kv = geom["n_kv_heads"] * geom["d_head"]
    bias = geom["norm"] == "layer"
    specs = [("embed/tok", (geom["vocab"], D), "normal")]
    if geom["positions"] == "learned":
        specs.append(("embed/pos", (geom["max_pos"], D), "normal"))

    def norm(path, lead):
        out = [(f"{path}/scale", lead + (D,), "ones")]
        if bias:
            out.append((f"{path}/bias", lead + (D,), "zeros"))
        return out

    a = "layers/attn"
    specs += norm(f"{a}/ln1", (L,))
    specs += [(f"{a}/wq", (L, D, q), "normal"),
              (f"{a}/wk", (L, D, kv), "normal"),
              (f"{a}/wv", (L, D, kv), "normal"),
              (f"{a}/wo", (L, q, D), "normal")]
    specs += norm(f"{a}/ln2", (L,))
    if bias:
        specs += [(f"{a}/bq", (L, q), "zeros"), (f"{a}/bk", (L, kv), "zeros"),
                  (f"{a}/bv", (L, kv), "zeros"), (f"{a}/bo", (L, D), "zeros")]
    specs += [(f"{a}/mlp/w1", (L, D, F), "normal"),
              (f"{a}/mlp/w2", (L, F, D), "normal")]
    if geom["act"] == "swiglu":
        specs.append((f"{a}/mlp/w3", (L, D, F), "normal"))
    if bias:
        specs += [(f"{a}/mlp/b1", (L, F), "zeros"),
                  (f"{a}/mlp/b2", (L, D), "zeros")]
    specs += norm("final_norm", ())
    return specs


def unflatten(flat: Dict[str, object]) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def flatten(tree: Dict, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def dtype_of(geom: Dict):
    import torch
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[geom["dtype"]]


def params(geom: Dict, seed: int, device) -> Dict:
    """The model's parameter tree: every matrix and embedding drawn from
    one normal draw of ``sub_seed(seed, "weights")`` (std ``STD``), norm
    scales 1, biases 0, all in the model's dtype."""
    import torch
    dt = dtype_of(geom)
    specs = leaf_specs(geom)
    sizes = [int(torch.Size(s).numel()) for _, s, init in specs
             if init == "normal"]
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "weights"))
    flat_normal = torch.randn(sum(sizes), generator=gen, device=device,
                              dtype=dt).mul_(STD)
    leaves, off = {}, 0
    for path, shape, init in specs:
        if init == "normal":
            n = int(torch.Size(shape).numel())
            leaves[path] = flat_normal[off:off + n].view(shape)
            off += n
        elif init == "ones":
            leaves[path] = torch.ones(shape, dtype=dt, device=device)
        else:
            leaves[path] = torch.zeros(shape, dtype=dt, device=device)
    return unflatten(leaves)


def width_dims(geom: Dict) -> Dict[str, int]:
    """The spaces LiGO's width expanders map between (paper §3.3)."""
    return {"emb": geom["d_model"],
            "q": geom["n_heads"] * geom["d_head"],
            "k": geom["n_kv_heads"] * geom["d_head"],
            "v": geom["n_kv_heads"] * geom["d_head"],
            "fc": geom["d_ff"]}


def operator(geom1: Dict, geom2: Dict, seed: int, device) -> Dict:
    """A LiGO operator from ``sub_seed(seed, "operator")``, float32: each
    width expander ``[I; copies of random source rows] + noise`` (Net2Net's
    start, as the paper initialises), each depth blend the StackBERT
    pattern (layer k copies layer k mod L1), one blend per stacked leaf of
    the source tree."""
    import torch
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "operator"))
    d1s, d2s = width_dims(geom1), width_dims(geom2)
    width = {}
    for name in sorted(d2s):
        d1, d2 = d1s[name], d2s[name]
        rows = torch.randint(0, d1, (d2 - d1,), generator=gen, device=device)
        eye = torch.cat([torch.eye(d1, device=device),
                         torch.nn.functional.one_hot(rows, d1).float()])
        width[name] = eye + OPERATOR_NOISE * torch.randn(
            (d2, d1), generator=gen, device=device)
    L1, L2 = geom1["n_layers"], geom2["n_layers"]
    pattern = torch.nn.functional.one_hot(
        torch.arange(L2, device=device) % L1, L1).float()
    stacked = [p[len("layers/attn/"):] for p, _, _ in leaf_specs(geom1)
               if p.startswith("layers/attn/")]
    return {"width": width,
            "depth": {"attn": {p: pattern.clone() for p in stacked}}}
