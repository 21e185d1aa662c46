"""The port's kernels: hand-written Hopper kernels beside their plain
PyTorch versions, under the JAX package's public names. Importing this
package builds and loads nothing; a kernel's library is built at its first
launch (see ``_build``).

As in the JAX package, the name ``flash_attention`` here is K3's function
(``ops.flash_attention``), which shadows the wrapper module of the same
name: reach the module through
``importlib.import_module("repro_torch.kernels.flash_attention")``."""
from repro_torch.kernels.ops import (LAUNCH_COUNTS, flash_attention,
                                     flash_attention_ref, launch_counts,
                                     ligo_blend_expand,
                                     ligo_blend_expand_bwd_fused,
                                     ligo_blend_expand_bwd_ref,
                                     ligo_blend_expand_grouped,
                                     ligo_blend_expand_grouped_ref,
                                     ligo_blend_expand_grouped_vjp,
                                     ligo_blend_expand_ref,
                                     ligo_blend_expand_vjp, ligo_grow,
                                     ligo_grow_ref, reset_launch_counts)

__all__ = ["LAUNCH_COUNTS", "flash_attention", "flash_attention_ref",
           "ligo_blend_expand", "ligo_blend_expand_bwd_fused",
           "ligo_blend_expand_bwd_ref", "ligo_blend_expand_grouped",
           "ligo_blend_expand_grouped_ref", "ligo_blend_expand_grouped_vjp",
           "ligo_blend_expand_ref", "ligo_blend_expand_vjp", "ligo_grow",
           "ligo_grow_ref", "launch_counts", "reset_launch_counts"]
