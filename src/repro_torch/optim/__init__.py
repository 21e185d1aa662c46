from repro_torch.optim.adamw import (AdamWState, SGDState, adamw_init,
                                    adamw_update, clip_by_global_norm,
                                    decay_mask, global_norm, sgd_init,
                                    sgd_update)
from repro_torch.optim.grow_state import (grow_adamw_state,
                                         grow_adamw_state_chain,
                                         hop_uses_grouped_gamma)
from repro_torch.optim.schedules import (SCHEDULES, constant, warmup_cosine,
                                        warmup_linear)

__all__ = ["AdamWState", "SGDState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "decay_mask", "global_norm", "sgd_init",
           "sgd_update", "grow_adamw_state", "grow_adamw_state_chain",
           "hop_uses_grouped_gamma", "SCHEDULES", "constant", "warmup_cosine",
           "warmup_linear"]
