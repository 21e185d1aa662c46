"""The readings a cell's limits are set from, on the card, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1-12 \\
        --control-seeds 101-103

For each of ``--seeds``: the program's first steps (the entry's set-up,
the same code a run drives) against the float32 reference: the lower
readings. For each of ``--control-seeds``: the control (the reference in
float8, in the program's place) and the fault of half the batch left out
(the reference on the first half of every batch), each against the
float32 reference: the upper readings. A step that returns its state
unchanged reads 1 on ``grad1`` and ``change`` by the judge's measure and
needs no run. One JSON line a reading, then a summary line: the largest
lower and the smallest upper reading of each number.

The benchmark's own runs do not run this.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def _seeds(text: str):
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main() -> int:
    import argparse
    import gc
    import json

    import torch

    from perfbench import harness, judge

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    cell = harness.load_cell(harness._json(harness.ROOT / "BENCHMARK.json"),
                             args.workload)
    dev = torch.device("cuda")
    from repro_torch.kernels import _build
    _build.build()
    mod = cell.entry()
    lower, upper = {}, {}

    def emit(kind, seed, got, ref, t0, t_ref):
        nums = judge.numbers(got, ref)
        print(json.dumps({
            "cell": cell.name, "kind": kind, "seed": seed,
            "seconds": time.perf_counter() - t0, "reference_s": t_ref,
            **{k: v["value"] for k, v in nums.items()},
            "at": {k: v["at"] for k, v in nums.items()},
            "leaves": judge.leaf_gaps(got, ref)}), flush=True)
        return nums

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def reference(seed, **kw):
        t = time.perf_counter()
        out = mod.reference(cell, seed, dev, **kw)
        free()
        return out, time.perf_counter() - t

    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        entry = mod.Entry(cell, seed, dev, harness.Clock(t0))
        prog = entry.readings
        entry.release()
        del entry
        free()
        ref, t_ref = reference(seed)
        for k, v in emit("program", seed, prog, ref, t0, t_ref).items():
            lower[k] = max(lower.get(k, 0.0), v["value"])
    rows = cell.traffic["rows"]
    for seed in _seeds(args.control_seeds) if args.control_seeds else []:
        ref, _ = reference(seed)
        for kind, kw in (("control_fp8", {"precision": "fp8"}),
                         ("fault_half_batch", {"rows": rows // 2})):
            t0 = time.perf_counter()
            got, t_ref = reference(seed, **kw)
            up = upper.setdefault(kind, {})
            for k, v in emit(kind, seed, got, ref, t0, t_ref).items():
                up[k] = min(up.get(k, float("inf")), v["value"])
    print(json.dumps({"cell": cell.name, "summary": True,
                      "lower_max": lower, "upper_min": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
