"""Input specifications and dummy batches (the twin of the JAX package's
``models/inputs.py``) for every modality the port runs.

The modality frontends are the JAX package's stubs: audio models receive
precomputed frame embeddings (with a mask and cluster labels), VLM models
precomputed patch embeddings and 3-axis (t, h, w) M-RoPE position ids
beside their tokens, vision models precomputed patch embeddings.
:func:`dummy_batch` makes each batch from ``np.random.RandomState(seed)``
with the JAX package's draws, in its order, so the two packages see the
same arrays.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import DTYPES

Spec = Tuple[Tuple[int, ...], torch.dtype]


def train_batch_specs(cfg: ModelConfig, batch: int, seq: int
                      ) -> Dict[str, Spec]:
    """``{name: (shape, dtype)}`` of a training batch."""
    dt = DTYPES[cfg.dtype]
    i32 = torch.int32
    if cfg.modality == "audio":
        return {"frames": ((batch, seq, cfg.d_model), dt),
                "mask": ((batch, seq), torch.bool),
                "labels": ((batch, seq), i32)}
    if cfg.modality == "vision":
        return {"patches": ((batch, cfg.num_patches - 1, cfg.d_model), dt),
                "labels": ((batch,), i32)}
    if cfg.objective == "mlm":
        return {"tokens": ((batch, seq), i32),
                "mask": ((batch, seq), torch.bool),
                "labels": ((batch, seq), i32)}
    spec = {"tokens": ((batch, seq), i32), "targets": ((batch, seq), i32)}
    if cfg.modality == "vlm":
        spec["patch_embeds"] = ((batch, min(cfg.num_patches, seq),
                                 cfg.d_model), dt)
        spec["positions"] = ((batch, seq, 3), i32)
    return spec


def prefill_batch_specs(cfg: ModelConfig, batch: int, seq: int
                        ) -> Dict[str, Spec]:
    """A training batch's specs less its targets and labels."""
    spec = train_batch_specs(cfg, batch, seq)
    spec.pop("targets", None)
    spec.pop("labels", None)
    return spec


def decode_batch_specs(cfg: ModelConfig, batch: int) -> Dict[str, Spec]:
    """One token a row, and with M-RoPE its (t, h, w) positions."""
    spec = {"tokens": ((batch, 1), torch.int32)}
    if cfg.modality == "vlm":
        spec["positions"] = ((batch, 1, 3), torch.int32)
    return spec


def dummy_batch(cfg: ModelConfig, batch: int, seq: int, kind: str,
                seed: int = 0, *, device="cuda") -> Dict[str, torch.Tensor]:
    """A random batch of ``kind`` "train", "prefill" or "decode" on
    ``device``: the arrays of the JAX package's ``dummy_batch`` with the
    same arguments (float inputs drawn in float64 and cast to the model's
    dtype). A VLM batch's positions are ``arange(seq)`` on all three
    streams (zeros in a decode batch); a prefill batch keeps an audio
    batch's labels, as the JAX package's does."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    dt = DTYPES[cfg.dtype]

    def toks(shape):
        return torch.from_numpy(
            rng.randint(0, cfg.vocab_size, shape).astype(np.int32))

    if kind == "decode":
        b = {"tokens": toks((batch, 1))}
        if cfg.modality == "vlm":
            b["positions"] = torch.zeros((batch, 1, 3), dtype=torch.int32)
    elif cfg.modality == "audio":
        b = {"frames": torch.from_numpy(
                 rng.randn(batch, seq, cfg.d_model)).to(dt),
             "mask": torch.from_numpy(rng.rand(batch, seq) < 0.15),
             "labels": toks((batch, seq))}
    elif cfg.modality == "vision":
        b = {"patches": torch.from_numpy(rng.randn(
                 batch, cfg.num_patches - 1, cfg.d_model)).to(dt),
             "labels": toks((batch,))}
    elif cfg.objective == "mlm":
        b = {"tokens": toks((batch, seq)),
             "mask": torch.from_numpy(rng.rand(batch, seq) < 0.15),
             "labels": toks((batch, seq))}
    else:
        t = toks((batch, seq + 1))
        b = {"tokens": t[:, :-1].contiguous(), "targets": t[:, 1:].contiguous()}
        if cfg.modality == "vlm":
            P = min(cfg.num_patches, seq)
            b["patch_embeds"] = torch.from_numpy(
                rng.randn(batch, P, cfg.d_model)).to(dt)
            b["positions"] = torch.arange(seq, dtype=torch.int32)[
                None, :, None].expand(batch, seq, 3).contiguous()
    if kind == "prefill":
        b.pop("targets", None)
        if cfg.modality != "audio":
            b.pop("labels", None)
    return {k: v.to(dev) for k, v in b.items()}
