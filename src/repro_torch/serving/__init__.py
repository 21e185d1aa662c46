"""Serving: continuous batching with zero-downtime live growth (the port of
the JAX package's ``serving``).

``ServingEngine`` batches sessions at independent sequence positions into
one decode step; ``HopController`` grows the model mid-serve: params
double-buffered through the GrowthPlan (kernel K1 on the card, on a side
stream in a background thread), live KV caches migrated by
``core.grow_cache`` (lossless in-place growth, depth-only new-layer replay,
or re-prefill through kernel K3), buffers swapped between decode steps,
with chaos hooks, rollback, bounded retry and a watchdog around the whole
hop. The KV cache defaults to a *paged* block-pool layout (``kv_pages``).
Speculative decoding (``serving.speculative``) runs through the hop: the
pre-hop model drafts, the grown model verifies. The recurrent families
(xLSTM, the Mamba2 hybrid) serve on a dense per-slot state, prefilled at
each request's true length and migrated by re-prefill; speculation
refuses them.
"""
from repro_torch.serving.admission import AdmissionQueue, Request
from repro_torch.serving.engine import ServingEngine, make_serving_fns
from repro_torch.serving.hotswap import (HopController, HopError, HopWatchdog,
                                         STAGES)
from repro_torch.serving.kv_pages import (PageAllocator, PageOOM,
                                          paged_supported)

__all__ = ["AdmissionQueue", "Request", "ServingEngine", "make_serving_fns",
           "HopController", "HopError", "HopWatchdog", "STAGES",
           "PageAllocator", "PageOOM", "paged_supported"]
