"""PyTorch + CUDA port of the LiGO reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors it module
for module, keeps its parameter tree exactly (nested dicts, layer stacks with
a leading L dim, weights ``(in, out)`` in the ``y = x @ W`` convention), and
replaces each Pallas TPU kernel with a hand-written Hopper kernel
(``csrc/``). It imports torch and numpy, never jax and nothing of ``repro``.
"""
