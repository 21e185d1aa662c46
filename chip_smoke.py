#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc; it exits non-zero without a card, and when the port's
sources are not beside it. Phases, each fatal on failure:

1. build the kernel from ``src/repro_torch/csrc`` and print the build
   seconds and ptxas report;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it and at a ragged float32 shape, and time
   the kernel, the plain version and one library call computing the same
   function, beside the least time the card could take (``bound_ms``);
3. drive the serving path at full width through its entry point —
   gpt2-base initialised on the card, hot-grown to gpt2-medium, 8 prompts of
   128 tokens prefilled and 31 tokens decoded greedily — with the launch
   counters set to 0 just before and read just after; check that every
   kernel of the path launched, that the kernel-grown tree matches a grow
   through the plain path, and that logits and tokens are sane;
4. print the kernels' JSON line, the card's name and power limit, and the
   result line ``{"ok": true, "device": {...}}`` last.

Float32 matrix products run in full float32 here
(``torch.backends.cuda.matmul.allow_tf32 = False``).
"""
import json
import os
import subprocess
import sys
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")

# Peak rates of one H100 SXM (data sheet, dense): bf16 tensor cores, f32 FMA
# pipes, HBM3. Used only to compute bound_ms.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Normalised tolerance (max |kernel - plain| / max |plain|): bf16 output is
# rounded once from an f32 sum on both sides, so the two may differ by an
# ulp of bf16 (2^-8 relative) where the sums round differently; f32 differs
# only by summation order.
TOL = {"bfloat16": 1e-2, "float32": 1e-5}

MAIN_ARGS = ["--arch", "gpt2-base", "--grow-to", "gpt2-medium", "--batch", "8",
             "--prompt-len", "128", "--gen", "32"]


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _k1_shapes(torch, cfg1, cfg2):
    """(name, G, L2, L1, E, I, A, Bd) of every K1 launch of one hot-grow,
    read from the port's own GrowthPlan for the pair."""
    from repro_torch.core.ligo import _kind_counts
    from repro_torch.core.plan import _expr_dims, plan_for
    from repro_torch.models.model import init_params
    with torch.no_grad():
        params = init_params(cfg1, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
    plan = plan_for(cfg1, cfg2, params)
    shapes = []
    for g in plan.groups:
        if not g.kernel_ok:
            continue
        E = g.shape[1] if len(g.shape) == 4 else 1
        I = _expr_dims(plan.exprs[g.in_ref], cfg1, cfg2)[0]
        L2 = _kind_counts(cfg2)[g.kind]
        shapes.append(("+".join(g.paths), len(g.paths), L2, g.shape[0], E, I,
                       g.shape[-2], g.shape[-1]))
    del params
    return shapes


def _check_k1(torch, name, dtype, G, L2, L1, E, I, A, Bd, seed):
    from repro_torch.kernels import ligo_expand, ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # unit-scale output: blend rows and expander rows of norm ~1
    w = torch.randn((G, L2, L1), generator=gen, device="cuda") / L1 ** 0.5
    B = (torch.randn((I, A), generator=gen, device="cuda") / A ** 0.5
         ).to(dtype)
    W = torch.randn((G, L1, E, A, Bd), generator=gen, device="cuda").to(dtype)

    def kernel():
        return ligo_expand.ligo_blend_expand_grouped(w, B, W)

    def plain():
        return ref.ligo_blend_expand_grouped_ref(w, B, W)

    def library():   # einsum blend in the working dtype, then one matmul
        bl = torch.einsum("gkl,gleab->gkeab", w.to(dtype), W)
        return torch.matmul(B, bl)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs().max().item()
    norm = diff / (want.float().abs().max().item() + 1e-30)
    tname = str(dtype).replace("torch.", "")
    ok = norm <= TOL[tname] and bool(torch.isfinite(got).all())
    # The bound counts the fewest operations the function needs: the least
    # of blend-then-expand (the kernel's fused order, L2 expansions) and
    # expand-then-blend (L1 expansions, then the blend in the large space).
    fused_flops = 2 * G * E * L2 * (L1 * A * Bd + I * A * Bd)
    flops = min(fused_flops, 2 * G * E * (L1 * I * A * Bd + L2 * L1 * I * Bd))
    elt = got.element_size()
    nbytes = (4 * G * L2 * L1 + elt * (I * A + G * L1 * E * A * Bd
                                       + G * L2 * E * I * Bd))
    t_ops, t_bytes = flops / PEAK_OPS[tname], nbytes / PEAK_BYTES
    reps = 3 if flops > 1e11 else 10
    row = {
        "shape": name, "dtype": tname,
        "G": G, "L2": L2, "L1": L1, "E": E, "I": I, "A": A, "Bd": Bd,
        "max_abs_err": diff, "max_norm_err": norm, "tol": TOL[tname],
        "ms": _time_ms(torch, kernel, reps),
        "plain_ms": _time_ms(torch, plain, reps),
        "library_ms": _time_ms(torch, library, reps),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "gflop": flops / 1e9, "kernel_gflop": fused_flops / 1e9,
        "mbytes": nbytes / 1e6,
    }
    print(f"[k1] {name:>8} {tname:>8} G={G} L2={L2} L1={L1} E={E} I={I} "
          f"A={A} Bd={Bd}: norm err {norm:.2e} (tol {TOL[tname]:.0e}) | "
          f"kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
          f"library {row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} "
          f"ms ({row['bound_by']}) {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version at {name} "
                             f"({tname}): normalised error {norm:.3e}")
    del got, want
    return row


def _check_trees(torch, got, want, tol):
    from repro_torch.core.ligo import _flatten
    fg, fw = _flatten(got), _flatten(want)
    if sorted(fg) != sorted(fw):
        raise AssertionError("grown trees differ in structure")
    worst = 0.0
    for path in sorted(fw):
        a, b = fg[path].float(), fw[path].float()
        if a.shape != b.shape:
            raise AssertionError(f"{path}: shape {tuple(a.shape)} vs "
                                 f"{tuple(b.shape)}")
        err = ((a - b).abs().max() / (b.abs().max() + 1e-30)).item()
        if not err <= tol:
            raise AssertionError(f"{path}: kernel grow vs plain grow "
                                 f"normalised error {err:.3e} > {tol:.0e}")
        worst = max(worst, err)
    return worst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on "
              "the card only", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's sources are missing ({SRC}/repro_torch)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.core.plan import plan_for
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import serve

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
          f"allow_tf32=False (f32 matmuls in full f32)", flush=True)

    # -- phase 1: build -----------------------------------------------------
    secs = _build.build("ligo_expand")
    print("[build] ligo_expand.cu: "
          + ("current build reused" if secs is None
             else f"compiled in {secs:.1f} s"), flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[ptxas] {name}: {line.strip()}")

    # -- phase 2: each kernel against its plain version -----------------------
    cfg1, cfg2 = get_config("gpt2-base"), get_config("gpt2-medium")
    shapes = _k1_shapes(torch, cfg1, cfg2)
    rows = [_check_k1(torch, name, torch.bfloat16, *dims, seed=100 + i)
            for i, (name, *dims) in enumerate(shapes)]
    rows.append(_check_k1(torch, "ragged", torch.float32,
                          3, 5, 3, 2, 200, 50, 130, seed=99))
    main_rows = rows[:len(shapes)]

    # -- phase 3: the serving main path at full width ------------------------
    ops.reset_launch_counts()
    res = serve.main(MAIN_ARGS)
    launches = ops.launch_counts()
    print(f"[main] launches during the main path: {launches}", flush=True)
    if launches["ligo_blend_expand_grouped"] != len(shapes):
        raise AssertionError(f"K1 launched {launches} times on the main path, "
                             f"want {len(shapes)} (one per eligible group)")
    with torch.no_grad():
        plan = plan_for(res["small_cfg"], res["cfg"], res["small"])
        plain = plan.apply(res["ligo"], res["small"], use_kernel=False)
        worst = _check_trees(torch, res["params"], plain, 1e-2)
        print(f"[main] kernel grow vs plain grow: worst per-leaf normalised "
              f"error {worst:.2e} (tol 1e-02, bf16)", flush=True)
        V = res["cfg"].vocab_size
        pl, dl, toks = (res["prefill_logits"], res["decode_logits"],
                        res["tokens"])
        if tuple(pl.shape) != (8, V) or tuple(dl.shape) != (31, 8, V):
            raise AssertionError(f"logit shapes {tuple(pl.shape)}, "
                                 f"{tuple(dl.shape)}")
        if not (torch.isfinite(pl).all() and torch.isfinite(dl).all()):
            raise AssertionError("non-finite logits")
        if tuple(toks.shape) != (8, 32) or not (
                (toks >= 0).all() and (toks < V).all()):
            raise AssertionError(f"bad tokens {tuple(toks.shape)}")
        # warm hot-grow, kernel path and plain path in turns
        small, ligo = res["small"], res["ligo"]
        warm = {"kernel": [], "plain": []}
        for route in ("kernel", "plain", "plain", "kernel"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan.apply(ligo, small, use_kernel=(route == "kernel"))
            torch.cuda.synchronize()
            warm[route].append((time.perf_counter() - t0) * 1e3)
    print(f"[k1] one hot-grow: {sum(r['gflop'] for r in main_rows):.1f} GFLOP "
          f"needed at least (min-FLOP order), "
          f"{sum(r['kernel_gflop'] for r in main_rows):.1f} GFLOP done by K1 "
          f"(fused order), {sum(r['mbytes'] for r in main_rows):.1f} MB moved "
          f"at least", flush=True)
    print(f"[main] hot-grow {res['hot_grow_ms']:.1f} ms (first call) | warm "
          f"kernel path {warm['kernel']} ms, plain path {warm['plain']} ms | "
          f"prefill {res['prefill_ms']:.1f} ms | decode "
          f"{res['decode_tok_s']:.1f} tok/s", flush=True)

    # -- phase 4: report ------------------------------------------------------
    def total(key):
        return sum(r[key] for r in main_rows)

    t_ops = sum(r["gflop"] * 1e9 for r in main_rows) / PEAK_OPS["bfloat16"]
    t_bytes = sum(r["mbytes"] * 1e6 for r in main_rows) / PEAK_BYTES
    kernels = [{
        "name": "ligo_blend_expand_grouped",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ligo_expand.cu",
        "replaces": "src/repro/kernels/ligo_expand.py:116",
        "launches": launches["ligo_blend_expand_grouped"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": total("library_ms"),
    }]
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
