from repro_torch.checkpoint.io import (flatten_tree, list_steps, load_meta,
                                       load_step, save_step, unflatten_into)
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager", "save_step", "load_step", "load_meta",
           "list_steps", "flatten_tree", "unflatten_into"]
