"""The port's kernels: hand-written Hopper kernels beside their plain
PyTorch versions. Importing this package builds and loads nothing; a
kernel's library is built at its first launch (see ``_build``).
``repro_torch.kernels.flash_attention`` is K3's wrapper module; its op is
``ops.flash_attention``."""
from repro_torch.kernels.ops import (launch_counts, ligo_blend_expand_grouped,
                                     ligo_blend_expand_grouped_vjp,
                                     reset_launch_counts)

__all__ = ["ligo_blend_expand_grouped", "ligo_blend_expand_grouped_vjp",
           "launch_counts", "reset_launch_counts"]
