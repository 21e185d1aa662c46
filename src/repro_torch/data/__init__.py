from repro_torch.data.pipeline import GlobalBatchLoader, Prefetcher
from repro_torch.data.synthetic import (batch_for_step, data_iterator,
                                        gen_tokens, optimal_loss)

__all__ = ["GlobalBatchLoader", "Prefetcher", "batch_for_step",
           "data_iterator", "gen_tokens", "optimal_loss"]
