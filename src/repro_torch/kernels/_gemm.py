"""The host side of the GEMM core that kernels K1 and K2 share
(``csrc/ligo_gemm.cuh``): which GEMM a call takes, the float32 GEMM's tile
and split for each product's shape, and what the tensor-core GEMM's TMA
loads need of an operand's storage."""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the C launchers' dtype codes
MAX_GRID_YZ = 65535                              # CUDA's y and z grid limit
TILE = 128                                       # the tensor-core GEMM's tile
SMS = 132                                        # H100 SXM

# The float32 GEMM's tiles (``F32Tile<code>`` in csrc/ligo_gemm.cuh): output
# rows x cols a block, by code
F32_TILES = ((128, 128), (64, 64), (128, 16))
F32_SLICE = 16            # contraction depth of one ring stage (kFk)
F32_MIN_PART = 16         # slices a split part keeps at least (256 deep)


class F32Plan(NamedTuple):
    """A float32 GEMM launch: ``tile`` (the code of an F32_TILES entry) and
    ``split``, the contiguous parts its (r, k-slice) sum is cut into."""
    tile: int
    split: int

    def blocks(self, M: int, N: int, Z: int = 1) -> int:
        bm, bn = F32_TILES[self.tile]
        return -(-M // bm) * -(-N // bn) * Z * self.split


@functools.lru_cache(maxsize=1024)
def f32_gemm_plan(M: int, N: int, K: int, R: int = 1,
                  Z: int = 1) -> F32Plan:
    """The tile and split of ``C[z] (M x N) = Σ_r Σ_k A_r B_r`` over ``Z``
    outputs on the float32 GEMM: 128 x 16 for N <= 16 (the MoE router's
    Bd = 8), else 128 x 128 where it gives a wave of blocks on the 132 SMs
    and 64 x 64 where it does not. Where the blocks
    still fall short of the SMs, the sum of R x ceil(K / 16) slices is cut
    into contiguous parts, up to two blocks an SM, each part at least
    F32_MIN_PART slices deep (a shorter sum is too little work to repay the
    second pass), and Z times the parts within the grid's z limit. A pure
    function of the shape, so that K1's and K2's U, the same product,
    take the same plan and agree bit for bit."""
    if N <= 16:
        tile = 2
    else:
        tile = 0 if F32Plan(0, 1).blocks(M, N, Z) >= SMS else 1
    blocks = F32Plan(tile, 1).blocks(M, N, Z)
    split = 1
    if blocks < SMS:
        slices = R * -(-K // F32_SLICE)
        split = max(1, min(-(-2 * SMS // blocks), slices // F32_MIN_PART,
                           MAX_GRID_YZ // Z))
    return F32Plan(tile, split)


def tensor_core_route(dtype: torch.dtype, I: int, A: int, Bd: int) -> bool:
    """Whether a call's products run on the tensor-core GEMM (else the float32
    one): bf16, and I, A and Bd multiples of 8 — TMA's 16-byte rule for row
    strides. Its rule for base addresses is :func:`tma_aligned`'s."""
    return (dtype == torch.bfloat16 and I % 8 == 0 and A % 8 == 0
            and Bd % 8 == 0)


def tma_aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it on a 16-byte boundary (TMA's rule for base
    addresses) where ``x`` is a view that starts off one."""
    return x if x.data_ptr() % 16 == 0 else x.clone()
