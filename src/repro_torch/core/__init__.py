from repro_torch.core.grow import grow, ligo_loss, train_ligo
from repro_torch.core.ligo import (apply_ligo, count_ligo_params,
                                  gamma_expand, init_ligo_params,
                                  interp_pattern, resolve_expander,
                                  stack_pattern)
from repro_torch.core.plan import (GrowthPlan, LeafGroup, compose_chain,
                                   compose_ligo, plan_for)
from repro_torch.core.spec import check_growable, family_hop, width_dims
from repro_torch.core.grow_cache import (CacheGrowthError, grow_decode_state,
                                         is_lossless_operator)
from repro_torch.core.upcycle import upcycle_operator
from repro_torch.core import grow_cache, operators, spec, upcycle

__all__ = ["apply_ligo", "count_ligo_params", "gamma_expand",
           "init_ligo_params", "interp_pattern", "resolve_expander",
           "stack_pattern", "GrowthPlan", "LeafGroup", "compose_chain",
           "compose_ligo", "plan_for", "check_growable", "family_hop",
           "width_dims", "grow", "ligo_loss", "train_ligo", "operators", "spec",
           "grow_cache", "CacheGrowthError", "grow_decode_state",
           "is_lossless_operator", "upcycle", "upcycle_operator"]
