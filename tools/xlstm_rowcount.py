#!/usr/bin/env python3
"""Where xlstm-125m-grown's float32 forward parts by batch shape, on the
card.

    PYTHONPATH=src python3 tools/xlstm_rowcount.py [--short 512 --long 543]

Serves xlstm-125m hot-grown 2x as ``chip_smoke.py`` phase 14 (b) does
(random weights from seed 0, bf16, 4 prompts), takes a float32 copy, and
runs ``models.model.forward`` on the same 4 rows at two lengths: the first
``--short`` tokens, and ``--long`` tokens whose first ``--short`` are the
same. A causal model gives the first ``--short`` positions the same hidden
states either way, up to the arithmetic.

1. Each block's output (24: mLSTM, sLSTM in turn), the short run against
   the long run's first positions: normalised max error, and the first
   block that parts.
2. Inside that block, every aten op that computes (in the short run's
   order, keyed by op and occurrence; ops that only move values are
   skipped), with ``TorchDispatchMode``: the first op whose inputs agree
   bit for bit on the shared positions and whose output does not.
   Its operands are then rerun alone at both row counts, under
   ``torch.profiler``, and the CUDA kernels each row count ran are printed.

TF32 off, a fixed cuBLAS workspace and deterministic algorithms, as in
``chip_smoke.py`` phase 14. Needs one CUDA card.
"""
import argparse
import os
import sys

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


# ops that only move or pick values: no rounding can start in them, and
# some pick a sequence's last positions (the conv's carried state), which
# the shared positions do not hold
MOVES = {"slice", "select", "view", "_unsafe_view", "reshape", "expand",
         "permute", "transpose", "t", "unsqueeze", "squeeze", "cat", "stack",
         "clone", "copy_", "_to_copy", "narrow", "split", "split_with_sizes",
         "chunk", "unbind", "alias", "detach", "as_strided", "index",
         "index_select", "constant_pad_nd", "zeros_like", "new_zeros",
         "zeros", "empty", "empty_like", "new_empty", "full", "fill_",
         "lift_fresh", "_reshape_alias"}


def _prefix(b, a_shape, n_rows, t_short, t_long):
    """``b`` (a long-run tensor) cut to the positions the short run has:
    a dim of the sequence's length (or its padded length, or its chunk
    count) is cut to the short run's size, and a dim of rows x length, as
    a product flattens it, keeps each row's first positions. None where no
    such cut gives ``a_shape``."""
    if b.dim() != len(a_shape):
        return None
    for d, (sb, sa) in enumerate(zip(b.shape, a_shape)):
        if sb == sa:
            continue
        if sb == n_rows * t_long and sa == n_rows * t_short:
            b = b.unflatten(d, (n_rows, t_long)).narrow(
                d + 1, 0, t_short).flatten(d, d + 1)
        elif sb > sa:
            b = b.narrow(d, 0, sa)
        else:
            return None
    return b


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--short", type=int, default=512)
    ap.add_argument("--long", type=int, default=543)
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config (a rehearsal with --device cpu)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten, tree_map_only
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("xlstm_rowcount: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.data import gen_tokens
    from repro_torch.launch import serve
    from repro_torch.models import blocks, model
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    res = serve.main(["--arch", "xlstm-125m", "--grow-to", "2x", "--batch",
                      "4", "--prompt-len", str(args.short), "--gen", "2",
                      "--device", args.device]
                     + (["--smoke"] if args.smoke else []))
    cfg = res["cfg"].scaled(dtype="float32")
    params = tree_map(lambda t: t.float(), res["params"])
    del res
    n_rows, ts, tl = 4, args.short, args.long
    toks = torch.as_tensor(gen_tokens(0, 0, n_rows, tl, cfg.vocab_size)
                           [:, :tl], device=dev)
    runs = {ts: toks[:, :ts], tl: toks}

    def err(a, b):
        return ((a - b).abs().max() / a.abs().max().clamp(min=1e-30)).item()

    # 1. block by block
    orig = {n: getattr(blocks, n) for n in ("apply_mlstm", "apply_slstm")}
    outs = {}

    def recording(name, store):
        def run(*a, **kw):
            y, cache = orig[name](*a, **kw)
            store.append((name, y))
            return y, cache
        return run
    for T, tk in runs.items():
        outs[T] = []
        for n in orig:
            setattr(blocks, n, recording(n, outs[T]))
        with torch.no_grad():
            hidden, _ = model.forward(params, cfg, {"tokens": tk})
        outs[T].append(("final norm", hidden))
    for n, f in orig.items():
        setattr(blocks, n, f)
    first = None
    print(f"[rowcount] xlstm-125m-grown float32, {n_rows} rows: forward of "
          f"{ts} tokens against the first {ts} of {tl}, block by block "
          f"(normalised max error; 'bitwise' where equal)")
    for i, ((name, a), (_, b)) in enumerate(zip(outs[ts], outs[tl])):
        bp = b[:, :ts]
        eq = bool(torch.equal(a, bp))
        print(f"[rowcount]   block {i:2d} {name:11s} "
              f"{'bitwise' if eq else f'{err(a, bp):.3e}'}")
        if not eq and first is None:
            first = i
    del outs
    if first is None:
        print("[rowcount] the two forwards agree bit for bit")
        return 0

    # 2. op by op inside the first block that parts
    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.seen = {}, {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func.overloadpacket.__name__)
            k = self.seen.get(name, 0)
            self.seen[name] = k + 1
            ins = [x for x in tree_flatten((args, kwargs))[0]
                   if isinstance(x, torch.Tensor) and x.is_floating_point()]
            outs_ = [x for x in tree_flatten(out)[0]
                     if isinstance(x, torch.Tensor) and x.is_floating_point()]
            if outs_:
                call = tree_map_only(torch.Tensor, torch.clone,
                                     (args, kwargs or {}))
                self.ops[(name, k)] = ([x.clone() for x in ins],
                                       [x.clone() for x in outs_], func, call)
            return out

    rec = {}
    for T, tk in runs.items():
        count = {"i": 0}

        def gated(name):
            def run(*a, **kw):
                i = count["i"]
                count["i"] += 1
                if i != first:
                    return orig[name](*a, **kw)
                rec[T] = Recorder()
                with rec[T]:
                    return orig[name](*a, **kw)
            return run
        for n in orig:
            setattr(blocks, n, gated(n))
        with torch.no_grad():
            model.forward(params, cfg, {"tokens": tk})
    for n, f in orig.items():
        setattr(blocks, n, f)

    def same(a_list, b_list):
        for a, b in zip(a_list, b_list):
            bp = _prefix(b, a.shape, n_rows, ts, tl)
            if bp is None or not torch.equal(a, bp):
                return False, (None if bp is None else err(a, bp))
        return len(a_list) == len(b_list), 0.0

    culprit = None
    for key, (ins_a, outs_a, func, call_a) in rec[ts].ops.items():
        if key not in rec[tl].ops or key[0] in MOVES:
            continue
        ins_b, outs_b, _, call_b = rec[tl].ops[key]
        ok_in, _ = same(ins_a, ins_b)
        ok_out, e = same(outs_a, outs_b)
        if ok_in and not ok_out:
            culprit = (key, ins_a, ins_b, e, func, call_a, call_b)
            break
    if culprit is None:
        print(f"[rowcount] block {first}: no single op parts on equal "
              f"inputs (the parting comes in through an op whose inputs "
              f"already differ)")
        return 0
    (name, k), ins_a, ins_b, e, func, call_a, call_b = culprit
    print(f"[rowcount] block {first}: the first op whose inputs agree bit "
          f"for bit on the shared positions and whose output does not: "
          f"aten.{name} (occurrence {k}), inputs "
          f"{[tuple(x.shape) for x in ins_a]} ({ts} tokens) / "
          f"{[tuple(x.shape) for x in ins_b]} ({tl} tokens); output "
          f"normalised max error {e:.3e}")

    # the op alone at both row counts, profiled: which kernels ran
    for T, ins, (a, kw) in ((ts, ins_a, call_a), (tl, ins_b, call_b)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            func(*a, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        kernels = sorted({ev.name for ev in prof.events()
                          if ev.device_type.name == "CUDA"})
        print(f"[rowcount]   {func} at {T} tokens "
              f"({[tuple(x.shape) for x in ins]}): CUDA kernels {kernels}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
