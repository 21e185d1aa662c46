"""Paged KV-cache allocation: fixed-size blocks + per-slot page tables (the
port of the JAX package's ``serving/kv_pages.py``).

The dense serving layout charges every slot a full ``max_len`` cache row.
Paged allocation replaces the row with fixed-size blocks drawn from a shared
pool: each slot holds a page table (``(max_pages,)`` block ids, ``-1`` =
unmapped) and pages are allocated lazily as its sequence grows, so a slot
two tokens into a short prompt pays one block, not ``max_len``.

Split of responsibilities:

- :class:`PageAllocator` is **host-side** bookkeeping (free list, page
  tables, per-slot worst-case reservations), pure Python and numpy. The
  engine consults it between decode launches; its device copy of the table
  is refreshed only when the table changed.
- The device ops below (:func:`gather_pages`, :func:`write_token_paged`,
  :func:`scatter_row_blocks`) work in place on pools shaped
  ``(n_blocks + 1, block_size, KV, dh)`` (stacked over layers in the
  decode state) through a device copy of the page table.

**The spare block.** A pool holds one block more than the allocator hands
out: the last, which no page table maps. The JAX package sends a write
through an unmapped page one past the pool, where XLA's scatter drops it;
on CUDA an index past the pool is a device-side assert, not a drop. So
every write through an unmapped page lands in the spare block instead, and
no index outside the pool reaches the card. Reads through an unmapped page
(-1) wrap, in both packages, to the pool's last block (here the spare):
harmless, because those positions are ``>= cur_len`` and decode attention
masks them.

Growth interacts trivially: a hop changes the per-position feature shape
``(KV, dh)`` but never the block geometry, so the allocator and page tables
survive every hop unchanged; migration builds new *pools*, and an aborted
hop discards them without touching the tables.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import paged_targets, write_token_paged

__all__ = ["paged_supported", "PageOOM", "PageAllocator",
           "init_paged_caches", "gather_pages", "write_token_paged",
           "scatter_row_blocks", "gathered_dense_view"]


def paged_supported(cfg: ModelConfig) -> bool:
    """Families whose whole decode state is one stacked attention K/V cache
    and whose attention is full-context (a sliding window wants a ring
    buffer, which the dense layout already provides)."""
    return cfg.family in ("dense", "moe", "vlm") and cfg.window == 0


class PageOOM(RuntimeError):
    """The pool cannot back a request's worst-case page demand."""


class PageAllocator:
    """Host-side block allocator: free list + per-slot page tables.

    ``pool_blocks`` defaults to ``slots * max_pages`` (every slot can reach
    ``max_len``: no admission pressure, memory savings show up as *peak
    allocated* blocks). A smaller pool creates real pressure: admission then
    reserves each request's worst-case page count up front, so an admitted
    request can always finish; backpressure is a deferred admission, never
    a mid-flight OOM (the engine's zero-drop guarantee). ``device`` is
    where :meth:`device_table` puts the table.
    """

    def __init__(self, slots: int, max_len: int, block_size: int,
                 pool_blocks: Optional[int] = None, *, device="cpu"):
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.slots = slots
        self.block_size = block_size
        self.device = torch.device(device)
        self.max_pages = -(-max_len // block_size)          # ceil
        self.padded_len = self.max_pages * block_size       # >= max_len
        self.n_blocks = (slots * self.max_pages if pool_blocks is None
                         else int(pool_blocks))
        if self.n_blocks < self.max_pages:
            raise ValueError("pool smaller than one slot's worst case")
        self.table = np.full((slots, self.max_pages), -1, np.int32)
        self.free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self.reserved = np.zeros((slots,), np.int64)   # admission worst case
        self.allocated = np.zeros((slots,), np.int64)
        self.peak_blocks = 0
        self.dirty = True                              # device table stale
        self._device_table: Optional[torch.Tensor] = None
        self._g_in_use = obs.gauge("serve.kv.pool_in_use_blocks")
        self._g_peak = obs.gauge("serve.kv.pool_peak_blocks")
        obs.gauge("serve.kv.pool_total_blocks").set(self.n_blocks)
        self._g_in_use.set(0)
        self._g_peak.set(0)

    # -- accounting ---------------------------------------------------------
    def pages_for(self, length: int) -> int:
        return -(-max(0, int(length)) // self.block_size)

    @property
    def in_use(self) -> int:
        return self.n_blocks - len(self.free)

    def _headroom(self) -> int:
        outstanding = int((self.reserved - self.allocated).sum())
        return len(self.free) - outstanding

    # -- lifecycle ----------------------------------------------------------
    def can_admit(self, worst_len: int) -> bool:
        return self._headroom() >= self.pages_for(worst_len)

    def admit(self, slot: int, cur_len: int, worst_len: int) -> None:
        """Reserve ``worst_len`` worth of pages for ``slot`` and back the
        first ``cur_len`` positions now (the prompt insert writes them)."""
        assert self.allocated[slot] == 0, f"slot {slot} not released"
        need = self.pages_for(worst_len)
        if self._headroom() < need:
            raise PageOOM(f"slot {slot}: need {need} pages, "
                          f"headroom {self._headroom()}")
        self.reserved[slot] = need
        self.ensure(slot, cur_len)

    def ensure(self, slot: int, upto: int) -> None:
        """Back positions ``[0, upto)`` of ``slot`` with real blocks."""
        need = min(self.pages_for(upto), self.max_pages)
        while self.allocated[slot] < need:
            if not self.free:
                raise PageOOM(f"slot {slot}: free list empty at "
                              f"{self.allocated[slot]}/{need} pages")
            self.table[slot, self.allocated[slot]] = self.free.pop()
            self.allocated[slot] += 1
            self.dirty = True
        self.peak_blocks = max(self.peak_blocks, self.in_use)
        self._g_in_use.set(self.in_use)
        self._g_peak.set(self.peak_blocks)

    def release(self, slot: int) -> None:
        for j in range(int(self.allocated[slot])):
            self.free.append(int(self.table[slot, j]))
        self.table[slot] = -1
        self.allocated[slot] = 0
        self.reserved[slot] = 0
        self.dirty = True
        self._g_in_use.set(self.in_use)

    # -- device view --------------------------------------------------------
    def device_table(self) -> torch.Tensor:
        """The page table as an int64 tensor on ``device``, copied anew only
        when the table changed since the last call."""
        if self.dirty or self._device_table is None:
            self._device_table = torch.as_tensor(
                self.table, dtype=torch.long, device=self.device)
            self.dirty = False
        return self._device_table

    def bytes_per_slot(self, block_bytes: int) -> float:
        """Peak cache bytes per slot for this run."""
        return self.peak_blocks * block_bytes / max(1, self.slots)


# ---------------------------------------------------------------------------
# Device ops (in place on the pools)
# ---------------------------------------------------------------------------
def init_paged_caches(cfg: ModelConfig, n_blocks: int, block_size: int, *,
                      device="cpu") -> Dict[str, torch.Tensor]:
    """Zeroed K/V pools ``(L, n_blocks + 1, block_size, KV, dh)``: the
    allocator's ``n_blocks`` and the spare block last."""
    from repro_torch.models.model import DTYPES
    shape = (cfg.n_layers, n_blocks + 1, block_size, cfg.n_kv_heads,
             cfg.d_head)
    return {kk: torch.zeros(shape, dtype=DTYPES[cfg.dtype], device=device)
            for kk in ("k", "v")}


def gather_pages(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """(n_blocks + 1, bs, KV, dh) gathered through (B, P) → (B, P*bs, KV, dh).

    Unmapped (-1) pages wrap to the pool's last block, the spare: harmless,
    those positions are ``>= cur_len`` and masked by decode attention."""
    B, P = pages.shape
    bs = pool.shape[1]
    return pool[pages].reshape(B, P * bs, *pool.shape[2:])


def scatter_row_blocks(pool: torch.Tensor, pages_row: torch.Tensor,
                       row: torch.Tensor) -> torch.Tensor:
    """Insert a dense cache row into the pool via one slot's page table, in
    place, and return the pool.

    pool: (L, n_blocks + 1, bs, KV, dh); pages_row: (P,); row: (L, P*bs,
    KV, dh), the prefill-produced row padded to the page-aligned length.
    The row's unmapped pages land in the spare block.
    """
    L, n_pool, bs = pool.shape[:3]
    P = pages_row.shape[0]
    blocks = row.reshape(L, P, bs, *row.shape[2:])
    pool[:, paged_targets(pages_row, n_pool)] = blocks
    return pool


def gathered_dense_view(pool: torch.Tensor,
                        table: torch.Tensor) -> torch.Tensor:
    """Materialise the dense ``(L, B, P*bs, KV, dh)`` view of a pool, the
    bridge back to every dense-layout consumer (cache growth oracles,
    parity tests). Unmapped pages come back as the spare block; callers
    mask by position exactly like decode attention does."""
    L, _, bs = pool.shape[:3]
    B, P = table.shape
    return pool[:, table].reshape(L, B, P * bs, *pool.shape[3:])
