"""The host side of the GEMM core that kernels K1 and K2 share
(``csrc/ligo_gemm.cuh``): which GEMM a call takes, and what the tensor-core
GEMM's TMA loads need of an operand's storage."""
from __future__ import annotations

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the C launchers' dtype codes
MAX_GRID_YZ = 65535                              # CUDA's y and z grid limit
TILE = 128                                       # output tile edge of both GEMMs


def tensor_core_route(dtype: torch.dtype, I: int, A: int, Bd: int) -> bool:
    """Whether a call's products run on the tensor-core GEMM (else the FMA
    one): bf16, and I, A and Bd multiples of 8 — TMA's 16-byte rule for row
    strides. Its rule for base addresses is :func:`tma_aligned`'s."""
    return (dtype == torch.bfloat16 and I % 8 == 0 and A % 8 == 0
            and Bd % 8 == 0)


def tma_aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it on a 16-byte boundary (TMA's rule for base
    addresses) where ``x`` is a view that starts off one."""
    return x if x.data_ptr() % 16 == 0 else x.clone()
