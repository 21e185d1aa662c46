"""Kernel K3's plain version and its route on the CPU, port against JAX.

- The port's ``flash_attention_ref`` and the op's CPU route against the JAX
  Pallas kernel (interpret mode, as ``tests/test_kernels.py`` runs it) and
  the JAX oracle, at the JAX ``FLASH_CASES`` shapes, and against the oracle
  alone at a ragged shape (the JAX kernel needs T and S to divide its tiles).
- The plain version against the port's chunked model attention after the
  ``(B, T, H, dh) <-> (B, H, T, dh)`` transpose (the twin of
  ``test_flash_matches_model_attention_layout``).
- The tensor-core kernel's schedule (128-row blocks of two 64-row
  warpgroups, 128-key tiles with TMA's zero fill past S, kv tiles outside
  the causal range or window skipped, masks only on tiles that straddle an
  edge, the exp2-domain online softmax with base 0 for a row that has seen
  no key, P rounded to bf16 in bf16, dh zero-padded to the 64- or 128-wide
  tile and scaled by the true dh) in plain torch, against the JAX oracle
  at the shapes above, at the card check's ragged bf16 shapes and at the
  registry's padded head widths (40, 48, 80, 120), and against the JAX
  Pallas kernel in interpret mode at those widths where T and S divide its
  tiles.
- The route: on the CPU nothing launches K3, and asking for the kernel with
  CPU tensors raises; bf16 with aligned rows takes the tensor-core kernel
  at every dh up to 128, f32, unaligned and broadcast rows the FMA kernel,
  and the wrapper refuses dh > 128.

Tolerance: the JAX kernel test's, elementwise ``rtol = atol`` = 2e-5 in
float32 and 2e-2 in bfloat16 (the output is rounded to bf16 on both sides).
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops                        # noqa: E402
from repro.kernels import ref as jref                        # noqa: E402
from repro_torch.kernels import ops, ref                     # noqa: E402
from repro_torch.models import layers as tl                  # noqa: E402
from repro_torch.models import model as tm                   # noqa: E402
from torch_parity import TINY2                               # noqa: E402

# K3's wrapper module (the package's ``flash_attention`` is the function)
tflash = importlib.import_module("repro_torch.kernels.flash_attention")

# (B, H, KV, T, S, dh, causal, window) — the JAX test's FLASH_CASES
FLASH_CASES = [
    (2, 4, 4, 256, 256, 64, True, 0),
    (1, 8, 2, 128, 256, 64, True, 0),        # GQA + longer KV
    (2, 4, 2, 256, 256, 32, False, 0),       # bidirectional
    (1, 4, 4, 256, 256, 64, True, 128),      # sliding window
    (1, 2, 1, 128, 128, 128, True, 0),       # dh = 128
]
RAGGED_CASES = [
    (2, 6, 2, 200, 328, 64, True, 0),
    (2, 6, 2, 200, 328, 64, True, 100),
]
# the ragged bf16 shapes of the card check (T off the 128-row block, S off
# a multiple of 8) and ragged bidirectional ones, with and without a window
KERNEL_CASES = [
    (2, 6, 2, 200, 328, 128, True, 0),
    (2, 6, 2, 77, 333, 64, True, 100),
    (1, 4, 2, 77, 133, 64, False, 0),
    (1, 4, 2, 130, 130, 64, False, 40),
]
# head widths off the tensor-core kernel's 64- and 128-wide tiles, which it
# pads with zeros: hubert-xlarge's half model (40), cait (48), zamba2-2.7b
# and hubert-xlarge (80), zamba2 grown 2x (120)
PADDED_DH = (40, 48, 80, 120)
PADDED_CASES = [case for dh in PADDED_DH for case in (
    (2, 6, 2, 77, 333, dh, True, 0),       # causal, ragged T != S, S odd
    (1, 4, 2, 130, 201, dh, True, 64),     # a window, S odd
    (2, 4, 4, 197, 197, dh, False, 0),     # bidirectional, T off the tiles
)]
# T and S divide the JAX kernel's tiles: the Pallas kernel in interpret mode
PADDED_PALLAS_CASES = [case for dh in PADDED_DH for case in (
    (1, 4, 2, 128, 256, dh, True, 0),      # GQA, causal, S > T
    (1, 2, 2, 256, 256, dh, False, 0),     # bidirectional
)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(case, seed):
    B, H, KV, T, S, dh = case[:6]
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, T, dh).astype(np.float32),
            rng.randn(B, KV, S, dh).astype(np.float32),
            rng.randn(B, KV, S, dh).astype(np.float32))


def _assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _port(case, arrays, dtype):
    """The plain version and the op's CPU route, which must be the same."""
    causal, window = case[6:]
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    ops.reset_launch_counts()
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal,
                                           window=window), got)
    assert ops.launch_counts()["flash_attention"] == 0
    return got


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES + PADDED_PALLAS_CASES)
def test_plain_flash_matches_jax_kernel_and_oracle(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(case, seed=0)
    causal, window = case[6:]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    got = _port(case, arrays, tdt)
    _assert_close(got, jops.flash_attention(jq, jk, jv, causal=causal,
                                            window=window), tol)
    _assert_close(got, jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                window=window), tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", RAGGED_CASES)
def test_plain_flash_matches_jax_oracle_ragged(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(case, seed=1)
    causal, window = case[6:]
    got = _port(case, arrays, tdt)
    _assert_close(got, jref.flash_attention_ref(
        *(jnp.asarray(a, jdt) for a in arrays), causal=causal, window=window),
        tol)


def _k3_schedule(q, k, v, causal, window, bk=128, rows=128):
    """``flash_fwd_wgmma``'s loop in plain torch, float32: q, k and v
    zero-padded from dh to the kernel's tile width (64 for dh <= 64, else
    128, as TMA fills the boxes past dh), the scale that of the true dh; per
    block of ``rows`` query rows, the kv tiles of ``bk`` keys from the first
    that a row of the block can see to the last; per 64-row warpgroup with a
    row below T, S = Q Kᵀ on K zero-filled past S, the mask only where the
    tile straddles S, the causal diagonal or the window edge, and the online
    softmax in the exp2 domain (base 0 while a row has seen no key), with P
    rounded to q's dtype before P V; the first dh columns stored."""
    B, H, T, dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    G, off = H // KV, S - T
    sl = math.log2(math.e) / math.sqrt(dh)
    DH = 64 if dh <= 64 else 128
    q = torch.nn.functional.pad(q, (0, DH - dh))
    n_keys = -(-S // bk) * bk
    kp, vp = (torch.zeros((B, KV, n_keys, DH)) for _ in range(2))
    kp[:, :, :S, :dh], vp[:, :, :S, :dh] = k.float(), v.float()
    kp, vp = (x.repeat_interleave(G, dim=1) for x in (kp, vp))
    out = torch.zeros((B, H, T, DH))
    for q0 in range(0, T, rows):
        r1 = min(q0 + rows, T) - 1
        hi = min(S, r1 + off + 1) if causal else S
        lo = max(0, q0 + off - window + 1) if window else 0
        for r_lo in range(q0, r1 + 1, 64):
            r_hi = min(r_lo + 63, T - 1)
            qpos = torch.arange(r_lo, r_hi + 1)[:, None] + off
            qq = q[:, :, r_lo:r_hi + 1].float()
            m = torch.full(qq.shape[:3], -math.inf)
            l = torch.zeros(qq.shape[:3])
            acc = torch.zeros(qq.shape)
            for k0 in range(lo // bk * bk, hi, bk):
                s = qq @ kp[:, :, k0:k0 + bk].transpose(2, 3)
                if (k0 + bk > S or (causal and k0 + bk - 1 > r_lo + off)
                        or (window and k0 <= r_hi + off - window)):
                    kpos = torch.arange(k0, k0 + bk)[None, :]
                    vis = kpos < S
                    if causal:
                        vis = vis & (kpos <= qpos)
                    if window:
                        vis = vis & (kpos > qpos - window)
                    s = s.masked_fill(~vis, -math.inf)
                mn = torch.maximum(m, s.amax(-1))
                base = torch.where(mn == -math.inf, 0.0, mn * sl)
                corr = torch.exp2(m * sl - base)
                p = torch.exp2(s * sl - base[..., None])
                l = l * corr + p.sum(-1)
                acc = (acc * corr[..., None]
                       + p.to(q.dtype).float() @ vp[:, :, k0:k0 + bk])
                m = mn
            out[:, :, r_lo:r_hi + 1] = acc / l.clamp_min(1e-30)[..., None]
    assert not out[..., dh:].any()    # padded columns stay exactly 0
    return out[..., :dh].to(q.dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES + RAGGED_CASES + KERNEL_CASES
                         + PADDED_CASES + PADDED_PALLAS_CASES)
def test_k3_schedule_matches_jax_oracle(case, dtype):
    """The tensor-core kernel's schedule gives the JAX oracle's attention:
    in float32 to the float32 tolerance (only the order of the sums
    differs), in bf16 (P rounded to bf16, as the kernel feeds it to the
    tensor cores) to the bf16 one. At the padded head widths whose T and S
    divide the JAX kernel's tiles, it also gives the Pallas kernel's
    (interpret mode)."""
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(case, seed=6)
    causal, window = case[6:]
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = _k3_schedule(q, k, v, causal, window)
    assert got.dtype == tdt and got.shape == q.shape
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    _assert_close(got, jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                window=window), tol)
    if case in PADDED_PALLAS_CASES:
        _assert_close(got, jops.flash_attention(jq, jk, jv, causal=causal,
                                                window=window), tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48)])
def test_plain_flash_matches_model_attention_layout(causal, window):
    """Plain K3 (B,H,T,dh) vs the chunked model attention (B,T,H,dh)."""
    rng = np.random.RandomState(4)
    B, T, H, KV, dh = 2, 128, 4, 2, 32
    q, k, v = (torch.from_numpy(rng.randn(B, T, n, dh).astype(np.float32))
               for n in (H, KV, KV))
    out_model = tl.attention(q, k, v, causal=causal, window=window,
                             chunk_q=64, chunk_k=64)
    out_flash = ref.flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window)
    _assert_close(out_flash.transpose(1, 2), out_model.numpy(), 2e-5)


def test_cpu_route_never_launches_k3():
    params = tm.init_params(TINY2, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.from_numpy(
        np.random.RandomState(5).randint(0, TINY2.vocab_size, (2, 9)))
    ops.reset_launch_counts()
    with torch.no_grad():
        auto, _ = tm.prefill(params, TINY2, {"tokens": toks})
        plain, _ = tm.prefill(params, TINY2, {"tokens": toks},
                              use_kernel=False)
    assert ops.launch_counts()["flash_attention"] == 0
    assert torch.equal(auto, plain)


def test_asking_for_k3_on_cpu_tensors_raises():
    q, k, v = (torch.from_numpy(a) for a in _inputs(FLASH_CASES[1], seed=2))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tl.full_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True, use_kernel=True)
    params = tm.init_params(TINY2, torch.Generator().manual_seed(0),
                            device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tm.prefill(params, TINY2, {"tokens": torch.zeros((1, 4), dtype=int)},
                   use_kernel=True)
    assert ops.launch_counts()["flash_attention"] == 0


def _route_qkv(dtype, dh, T=16, S=16):
    """q, k and v as the model hands them to K3: (B, heads, T, dh) views of
    (B, T, heads, dh) storage."""
    q = torch.zeros((2, T, 4, dh), dtype=dtype).transpose(1, 2)
    kv = torch.zeros((2, S, 2, dh), dtype=dtype).transpose(1, 2)
    return q, kv, kv


@pytest.mark.parametrize("dh", [8, 32, 40, 48, 64, 80, 120, 128])
def test_tensor_core_kernel_takes_bf16_aligned_rows_at_every_dh_to_128(dh):
    """The wrapper's choice between K3's two CUDA kernels (pure shape and
    stride logic, so it runs here): bf16 with aligned rows takes the tensor
    cores at every head width up to 128, the kernel padding dh to its 64-
    or 128-wide tile; f32 at the same width takes the FMA kernel."""
    assert tflash.uses_tensor_cores(*_route_qkv(torch.bfloat16, dh))
    # any T and S: T off the kernel's 128-row tile, S off a multiple of 8
    # (the wrapper pads the Vᵀ scratch, TMA reads only S keys of it)
    assert tflash.uses_tensor_cores(*_route_qkv(torch.bfloat16, dh, T=77,
                                                S=333))
    assert tflash.uses_tensor_cores(*_route_qkv(torch.bfloat16, dh, T=200,
                                                S=201))
    assert not tflash.uses_tensor_cores(*_route_qkv(torch.float32, dh))


def test_fma_kernel_takes_unaligned_and_broadcast_bf16_rows():
    q, k, v = _route_qkv(torch.bfloat16, 64)
    assert not tflash.uses_tensor_cores(*_route_qkv(torch.float32, 128))
    # rows off a 16-byte boundary take the FMA kernel
    shifted = torch.zeros(2 * 16 * 2 * 64 + 1, dtype=torch.bfloat16)[1:]
    shifted = shifted.view(2, 16, 2, 64).transpose(1, 2)
    assert not tflash.uses_tensor_cores(q, shifted, v)
    odd = torch.zeros((2, 4, 16, 68), dtype=torch.bfloat16)[..., :64]
    assert not tflash.uses_tensor_cores(odd, k, v)
    # rows of 136 bytes at dh 48 and 80, as the card check's unaligned rows
    for dh in (48, 80):
        rows = torch.zeros((2, 16, 4, dh + 4), dtype=torch.bfloat16)
        assert not tflash.uses_tensor_cores(
            rows[..., :dh].transpose(1, 2), *_route_qkv(torch.bfloat16,
                                                        dh)[1:])
    # aligned strides but a head width off a multiple of 8: a pair of the
    # epilogue's stores would straddle dh
    wide = torch.zeros((2, 16, 4, 16), dtype=torch.bfloat16)
    q12 = wide[..., :12].transpose(1, 2)
    assert all(s % 8 == 0 for s in q12.stride()[:-1])
    kv12 = torch.zeros((2, 16, 2, 16), dtype=torch.bfloat16)[..., :12]
    kv12 = kv12.transpose(1, 2)
    assert not tflash.uses_tensor_cores(q12, kv12, kv12)
    # a kv head broadcast over the batch (stride 0) takes the FMA kernel
    shared = torch.zeros((1, 2, 16, 64), dtype=torch.bfloat16).expand(2, -1,
                                                                      -1, -1)
    assert shared.stride(0) == 0
    assert not tflash.uses_tensor_cores(q, shared, shared)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k3_wrapper_refuses_dh_over_128(dtype):
    """dh 136 is past both kernels' widths: no route takes it, and the
    wrapper refuses it before it looks at the device."""
    q, k, v = _route_qkv(dtype, 136)
    assert not tflash.uses_tensor_cores(q, k, v)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="dh <= 128"):
        tflash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="dh <= 128"):
        ops.flash_attention(q, k, v, use_kernel=True)
    assert ops.launch_counts()["flash_attention"] == 0
