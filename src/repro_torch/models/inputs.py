"""Input specifications and dummy batches (the twin of the JAX package's
``models/inputs.py``) for the text, masked-LM and vision models the port
runs.

Vision models receive precomputed patch embeddings, as in the JAX package
(its frontends are stubs). :func:`dummy_batch` makes each batch from
``np.random.RandomState(seed)`` with the JAX package's draws, in its order,
so the two packages see the same arrays. The audio and VLM inputs come
with their model families ("the other families, d" in ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import DTYPES

Spec = Tuple[Tuple[int, ...], torch.dtype]


def _refuse(cfg: ModelConfig) -> None:
    if cfg.modality in ("audio", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.modality} inputs are not ported yet; they "
            f"come with their model families (ROADMAP.md, 'the other "
            f"families, d: audio and VLM')")


def train_batch_specs(cfg: ModelConfig, batch: int, seq: int
                      ) -> Dict[str, Spec]:
    """``{name: (shape, dtype)}`` of a training batch."""
    _refuse(cfg)
    i32 = torch.int32
    if cfg.modality == "vision":
        return {"patches": ((batch, cfg.num_patches - 1, cfg.d_model),
                            DTYPES[cfg.dtype]),
                "labels": ((batch,), i32)}
    if cfg.objective == "mlm":
        return {"tokens": ((batch, seq), i32),
                "mask": ((batch, seq), torch.bool),
                "labels": ((batch, seq), i32)}
    return {"tokens": ((batch, seq), i32), "targets": ((batch, seq), i32)}


def dummy_batch(cfg: ModelConfig, batch: int, seq: int, kind: str,
                seed: int = 0, *, device="cuda") -> Dict[str, torch.Tensor]:
    """A random batch of ``kind`` "train", "prefill" or "decode" on
    ``device``: the arrays of the JAX package's ``dummy_batch`` with the
    same arguments (float inputs drawn in float64 and cast to the model's
    dtype)."""
    _refuse(cfg)
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    dt = DTYPES[cfg.dtype]

    def toks(shape):
        return torch.from_numpy(
            rng.randint(0, cfg.vocab_size, shape).astype(np.int32))

    if kind == "decode":
        b = {"tokens": toks((batch, 1))}
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
    if kind == "prefill":
        b.pop("targets", None)
        b.pop("labels", None)
    return {k: v.to(dev) for k, v in b.items()}
