#!/usr/bin/env python3
"""Times K1's and K2's float32 route on the card at the main paths' float32
shapes, beside the plain version, one library call and the bound.

    PYTHONPATH=src python3 tools/f32_gemm_times.py [--src DIR] [--reps 5]
        [--json OUT] [--sweep] [--host-profile]

Rows (kernel ms, plain ms, library ms, bound ms, each the mean of
``--reps`` calls after a warm-up, by CUDA events):

- ``moment <pair>``: one float32 grow of both AdamW moments (m through the
  operator, v through its square), K1's launches group by group as the
  GrowthPlan makes them (``chip_smoke.py``'s phase-2 line), for
  gpt2-base -> gpt2-medium and hubert-xlarge's half model -> hubert-xlarge;
- ``router``: the MoE router's float32 Bd = 8 group of mixtral cut to 2 ->
  4 layers (phase 13 (c)): K1, and K2 fed K1's U;
- ``quickstart``: the quickstart twin's float32 LiGO step, K1 and K2 of
  each of its six groups, placed as a step with gradients places them;
- ``recurrent <model>``: the recurrent engine's float32 hops (phase 15
  (c)): one grow of xlstm-125m and of zamba2-2.7b cut to 12 layers, each
  to its ``grow_target``, K1's launches group by group.

Rows of the small products (router, quickstart, recurrent) also give
``device_ms``, the card's kernel time a call, summed from a
``torch.profiler`` trace of ``--reps`` calls, and ``host_ms``, the host's
wall a call to return from ``--reps`` calls in a row, so that a row whose
events time is host-bound shows how much of it the card spends. ``--sweep``
times each of those K1 rows again with every tile of the float32 GEMM
forced (unsplit), on a tree that has ``f32_gemm_plan``. ``--host-profile``
prints, for the router's and the quickstart's rows, where 200 calls
spend the host's time (``cProfile``, the functions with the most time of
their own).

``--src`` puts another checkout's ``src/`` first on the path (the kernels
it imports are built from that checkout's sources), so that two versions
are timed in one call on one card. The inputs, the library calls and the
bound are ``chip_smoke.py``'s (bound: the larger of the fewest operations
at 67 TFLOP/s and the bytes at 3.35 TB/s). Needs one CUDA card.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--host-profile", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("f32_gemm_times: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.configs import get_config, half_config
    from repro_torch.examples import quickstart
    from repro_torch.kernels import _build, ligo_expand, ligo_expand_bwd
    import repro_torch
    print(f"[f32] repro_torch from {os.path.dirname(repro_torch.__file__)}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    _build.build()
    f32 = torch.float32
    reps = args.reps

    def t(fn):
        return cs._time_ms(torch, fn, reps)

    def device_ms(fn):
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   ) / 1e3 / reps

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt * 1e3 / reps

    def host_profile(label, fn):
        import cProfile
        import io
        import pstats
        fn()
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(200):
            fn()
        prof.disable()
        torch.cuda.synchronize()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(10)
        print(f"[f32] host profile of {label}, 200 calls:\n{out.getvalue()}",
              flush=True)

    def sweep(fn):
        """{tile code: kernel ms} with every float32 tile forced."""
        from repro_torch.kernels import _gemm
        planned = ligo_expand.f32_gemm_plan
        out = {}
        try:
            for tile in range(len(_gemm.F32_TILES)):
                ligo_expand.f32_gemm_plan = (
                    lambda *a, tile=tile: _gemm.F32Plan(tile, 1))
                out[tile] = t(fn)
        finally:
            ligo_expand.f32_gemm_plan = planned
        return out

    small = ("router", "quickstart", "recurrent")

    def k1_row(label, d, j, seed, square):
        """K1 at one of the grow's checks (chip_smoke.py::_check_k1's
        kernel and library calls)."""
        G, L2, L1, E, I, A, Bd = d
        w, B, W = cs._ligo_inputs(torch, f32, *d, seed, False)
        if square:
            w, B, W = w * w, B * B, W * W
        if j:
            gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
            R = torch.randn((j, Bd), generator=gen, device="cuda") / Bd ** .5
            if square:
                R = R * R
            UR = cs._expanded(torch, ligo_expand.ligo_expand(B, W), R, f32)

            def kernel():
                return (ligo_expand.ligo_expand(B, W),
                        ligo_expand.ligo_blend(w, UR, f32))

            def library():
                return (torch.matmul(B, W),
                        torch.einsum("gkl,gleib->gkeib", w, UR))
            from repro_torch.kernels import ref

            def plain():
                return (ref.ligo_expand_ref(B, W),
                        ref.ligo_blend_ref(w, UR, f32))
            flops = (ligo_expand.operation_count(*d, stage="expand")
                     + ligo_expand.operation_count(G, L2, L1, E, I, A, j,
                                                   stage="blend"))
            nbytes = 4 * (G * L2 * L1 + I * A + G * L1 * E * A * Bd
                          + G * L2 * E * I * j + G * L1 * E * I * (Bd + j))
        else:
            from repro_torch.kernels import ref

            def kernel():
                return ligo_expand.ligo_blend_expand_grouped(w, B, W)

            def library():
                bl = torch.einsum("gkl,gleab->gkeab", w, W)
                return torch.matmul(B, bl)

            def plain():
                return ref.ligo_blend_expand_grouped_ref(w, B, W)
            flops = ligo_expand.least_operations(*d)
            nbytes = 4 * (G * L2 * L1 + I * A + G * L1 * E * A * Bd
                          + G * L2 * E * I * Bd)
        row = {"row": label, "kernel": "K1", "dims": d, "j": j,
               "ms": t(kernel), "plain_ms": t(plain),
               "library_ms": t(library),
               "bound_ms": max(flops / cs.PEAK_OPS["float32"],
                               nbytes / cs.PEAK_BYTES) * 1e3}
        if label.startswith(small):
            row["device_ms"] = device_ms(kernel)
            row["host_ms"] = host_ms(kernel)
            if args.host_profile and not label.startswith("recurrent"):
                host_profile(f"K1 {label}", kernel)
            if args.sweep and hasattr(ligo_expand, "f32_gemm_plan"):
                row["sweep_ms"] = sweep(kernel)
        del w, B, W
        return row

    def k2_row(label, d, j, need_dW, seed):
        """K2 fed K1's U (chip_smoke.py::_check_k2's kernel and library
        calls; a between-split group as its two halves)."""
        from repro_torch.kernels import ref
        G, L2, L1, E, I, A, Bd = d
        w, B, W = cs._ligo_inputs(torch, f32, *d, seed, False)
        gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
        _, U = ligo_expand.ligo_blend_expand_grouped(w, B, W, keep_u=True)
        if j:
            R = torch.randn((j, Bd), generator=gen, device="cuda") / Bd ** .5
            UR = cs._expanded(torch, U, R, f32)
            dP = torch.randn((G, L2, E, I, j), generator=gen, device="cuda")
            dU = (ligo_expand_bwd.ligo_blend_bwd(w, dP, UR)[1].reshape(-1, j)
                  @ R).reshape(G, L1, E, I, Bd).contiguous()

            def kernel():
                return (ligo_expand_bwd.ligo_blend_bwd(w, dP, UR)
                        + ligo_expand_bwd.ligo_expand_bwd(B, W, dU,
                                                          need_dW=need_dW))

            def plain():
                return (ref.ligo_blend_bwd_ref(w, dP, UR)
                        + ref.ligo_expand_bwd_ref(B, W, dU, need_dW=need_dW))

            def library():
                Q = torch.einsum("gkl,gkeib->gleib", w, dP)
                return (torch.einsum("gkeib,gleib->gkl", dP, UR), Q,
                        torch.einsum("gleib,gleab->ia", dU, W))
            flops = (ligo_expand_bwd.operation_count(
                G, L2, L1, E, I, A, j, u_given=True, need_dW=False,
                need_dB=False) + ligo_expand_bwd.operation_count(
                *d, q_given=True, need_dW=need_dW, need_dw=False))
        else:
            dP = torch.randn((G, L2, E, I, Bd), generator=gen, device="cuda")

            def kernel():
                return ligo_expand_bwd.ligo_blend_expand_bwd(
                    w, B, W, dP, U=U, need_dW=need_dW)

            def plain():
                return ref.ligo_blend_expand_bwd_ref(w, B, W, dP,
                                                     need_dW=need_dW)

            def library():
                T = torch.einsum("ia,gkeib->gkeab", B, dP)
                bl = torch.einsum("gkl,gleab->gkeab", w, W)
                return (torch.einsum("gkeab,gleab->gkl", T, W),
                        torch.einsum("gkeib,gkeab->ia", dP, bl),
                        torch.einsum("gkl,gkeab->gleab", w, T)
                        if need_dW else None)
            flops = ligo_expand_bwd.least_operations(
                *d, u_given=True, need_dW=need_dW)
        Bj = j or Bd
        nbytes = 4 * (2 * G * L2 * L1 + 2 * I * A + G * L1 * E * A * Bd
                      + G * L2 * E * I * Bj + G * L1 * E * I * Bj
                      + (G * L1 * E * A * Bd if need_dW else 0))
        row = {"row": label, "kernel": "K2", "dims": d, "j": j,
               "ms": t(kernel), "plain_ms": t(plain),
               "library_ms": t(library),
               "bound_ms": max(flops / cs.PEAK_OPS["float32"],
                               nbytes / cs.PEAK_BYTES) * 1e3}
        if label.startswith(small):
            row["device_ms"] = device_ms(kernel)
            row["host_ms"] = host_ms(kernel)
            if args.host_profile:
                host_profile(f"K2 {label}", kernel)
        del w, B, W, U, dP
        return row

    rows = []
    hub = get_config("hubert-xlarge")
    for label, c1, c2 in (("moment gpt2", get_config("gpt2-base"),
                           get_config("gpt2-medium")),
                          ("moment hubert", half_config(hub), hub)):
        shapes = cs._k1_shapes(torch, c1, c2)
        for mom, seed in (("m", 110), ("v", 120)):
            for i, sh in enumerate(shapes):
                calls = cs._k1_calls(sh, False)
                j = calls[1][1][-1] if len(calls) == 2 else None
                rows.append(k1_row(f"{label} {mom} {sh['name']}",
                                   calls[0][1], j, seed + i, mom == "v"))
    mix = get_config("mixtral-8x7b")
    m2 = mix.scaled(name=f"{mix.name}-4l", n_layers=4)
    m1 = half_config(mix).scaled(name="mixtral-half-2l", n_layers=2)
    router = [sh for sh in cs._k1_shapes(torch, m1, m2)
              if sh["dtype"] == f32]
    qs = cs._k1_shapes(torch, quickstart.SMALL, quickstart.BIG)
    for label, shapes in (("router", router), ("quickstart", qs)):
        for i, sh in enumerate(shapes):       # the LiGO step's K1 launches
            calls = cs._k1_calls(sh, True)
            j = calls[1][1][-1] if len(calls) == 2 else None
            rows.append(k1_row(f"{label} {sh['name']}", calls[0][1], j,
                               130 + i, False))
        for i, (name, d, j, need) in enumerate(cs._k2_checks(shapes)):
            rows.append(k2_row(f"{label} {name}", d, j, need, 230 + i))
    from repro_torch.configs import grow_target
    xl = get_config("xlstm-125m").scaled(dtype="float32")
    z = get_config("zamba2-2.7b")
    z = z.scaled(name=f"{z.name}-{cs.RECUR_F32_ZAMBA}l",
                 n_layers=cs.RECUR_F32_ZAMBA, dtype="float32")
    for label, c1 in (("recurrent xlstm", xl), ("recurrent zamba2", z)):
        for i, sh in enumerate(cs._k1_shapes(torch, c1, grow_target(c1))):
            calls = cs._k1_calls(sh, False)
            j = calls[1][1][-1] if len(calls) == 2 else None
            rows.append(k1_row(f"{label} {sh['name']}", calls[0][1], j,
                               330 + i, False))
    for r in rows:
        dev = (f", device {r['device_ms']:.4f}, host {r['host_ms']:.4f}"
               if "device_ms" in r else "")
        swp = (", tiles " + " ".join(f"{k}:{v:.4f}" for k, v in
                                     r["sweep_ms"].items())
               if "sweep_ms" in r else "")
        print(f"[f32] {r['row']:>28} {r['kernel']} {r['dims']} j={r['j']}: "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f}{dev}{swp}",
              flush=True)
    for prefix in ("moment gpt2", "moment hubert", "router", "quickstart",
                   "recurrent xlstm", "recurrent zamba2"):
        for kern in ("K1", "K2", None):
            sel = [r for r in rows if r["row"].startswith(prefix)
                   and kern in (None, r["kernel"])]
            if not sel or (kern and prefix.startswith(("moment",
                                                       "recurrent"))):
                continue
            dev = (f", device {sum(r['device_ms'] for r in sel):.3f}, host "
                   f"{sum(r['host_ms'] for r in sel):.3f}"
                   if all("device_ms" in r for r in sel) else "")
            print(f"[f32] {prefix}{' ' + kern if kern else ''}: {len(sel)} "
                  f"rows, kernel {sum(r['ms'] for r in sel):.3f} ms, plain "
                  f"{sum(r['plain_ms'] for r in sel):.3f}, library "
                  f"{sum(r['library_ms'] for r in sel):.3f}, bound "
                  f"{sum(r['bound_ms'] for r in sel):.3f}{dev}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
