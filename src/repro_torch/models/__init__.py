from repro_torch.models.model import (decode_step, embed, forward,
                                      init_decode_state, init_params, prefill,
                                      unembed)
from repro_torch.models.losses import loss_fn
from repro_torch.models import inputs

__all__ = ["init_params", "forward", "decode_step", "prefill", "unembed",
           "embed", "init_decode_state", "loss_fn", "inputs"]
