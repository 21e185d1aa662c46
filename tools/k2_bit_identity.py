#!/usr/bin/env python3
"""Kernel K2 against another version of its CUDA source, bit for bit.

    python3 tools/k2_bit_identity.py DIR

DIR holds the other version's ``ligo_expand_bwd.cu`` and the headers it
includes (for example, the files of an earlier commit, from ``git show
<commit>:src/repro_torch/csrc/<file>``); its C interface must be this
checkout's. Needs one CUDA card and nvcc. The script builds DIR's source
with the port's nvcc flags into DIR, runs this checkout's K2 wrapper at
``chip_smoke.py``'s K2 shapes (the six gpt2-base -> gpt2-medium groups and
``K2_EXTRA_SHAPES``, from the same inputs and seeds) once with this
checkout's library and once with DIR's, and requires ``torch.equal`` on dw,
dB and dW at every shape. It exits 1 on any difference, 2 without a card.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke  # noqa: E402


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k2_bit_identity: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ligo_expand_bwd as k2
    main_path = chip_smoke._k1_shapes(torch, get_config("gpt2-base"),
                                      get_config("gpt2-medium"))
    shapes = [(name, "bfloat16", dims, 200 + i)
              for i, (name, dims, _, _) in enumerate(
                  chip_smoke._k2_checks(main_path))]
    shapes += chip_smoke.K2_EXTRA_SHAPES
    other_dir = os.path.abspath(sys.argv[1])
    so = os.path.join(other_dir, "libligo_expand_bwd_other.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so,
                    os.path.join(other_dir, "ligo_expand_bwd.cu")],
                   check=True, capture_output=True, text=True)
    other = ctypes.CDLL(so)
    own = k2._lib()
    for name in ("ligo_blend_expand_bwd", "ligo_bwd_error_string"):
        fn, ref_fn = getattr(other, name), getattr(own, name)
        fn.argtypes, fn.restype = ref_fn.argtypes, ref_fn.restype

    same = True
    for name, dtype, dims, seed in shapes:
        dt = getattr(torch, dtype)
        w, B, W, dP = chip_smoke._ligo_inputs(torch, dt, *dims, seed, True)
        outs = []
        for lib in (own, other):
            k2._lib = lambda lib=lib: lib
            outs.append(k2.ligo_blend_expand_bwd(w, B, W, dP))
        torch.cuda.synchronize()
        eq = [torch.equal(a, b) for a, b in zip(*outs)]
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(*outs))
        same &= all(eq)
        print(f"[k2 identity] {name:>14} {dtype:>8} "
              f"{tuple(dims)} route "
              f"{'wgmma' if k2.tensor_core_route(dt, *dims[4:]) else 'fma'}: "
              f"torch.equal dw {eq[0]}, dB {eq[1]}, dW {eq[2]}; max abs "
              f"difference {diff:.3e}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "")
    print(f"[k2 identity] {'bit-identical at all' if same else 'DIFFERS at'} "
          f"{len(shapes) if same else 'some of the'} shapes")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
