"""Model registry: config → model instance (dense, audio, vlm, MoE, SSM and
hybrid families), and one input batch of a config: its shapes and dtypes
(:func:`batch_specs`) and random contents (:func:`make_batch`)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.mamba import MambaModel
from repro_torch.models.mamba2 import Zamba2Model
from repro_torch.models.moe import MoEModel
from repro_torch.models.transformer import DenseModel
from repro_torch.sharding import NO_RULES, ShardingRules

_FAMILY = {"dense": DenseModel, "audio": DenseModel, "vlm": DenseModel,
           "moe": MoEModel, "ssm": MambaModel, "hybrid": Zamba2Model}

# the port's token dtype, as its data pipeline gives tokens and labels
TOKEN_DTYPE = torch.int64
# the stub frontends' precomputed embeddings, as the reference gives them
EMBED_DTYPE = torch.bfloat16


def build_model(cfg: ModelConfig, rules: ShardingRules = NO_RULES,
                remat: bool = True):
    """The model of ``cfg``'s family; ``rules`` places its logical-axis
    hints on a mesh (no-ops with ``NO_RULES``); ``remat`` recomputes each
    block in backward (the reference's ``build_model(cfg, rules,
    remat=...)``)."""
    if cfg.family not in _FAMILY:
        raise ValueError(f"family {cfg.family!r} is not ported; ported: "
                         f"{', '.join(_FAMILY)}")
    return _FAMILY[cfg.family](cfg, remat=remat, rules=rules)


def batch_specs(cfg: ModelConfig, batch: int,
                seq: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """``{name: (shape, dtype)}`` of one input batch, the reference's
    ``batch_specs``: tokens and labels; an audio config's frames in place
    of tokens; a vlm config's ``num_patches`` patches ahead of
    ``max(seq - num_patches, 1)`` tokens, with labels on the tokens."""
    if cfg.frontend == "audio_frames":
        return {"frames": ((batch, seq, cfg.d_model), EMBED_DTYPE),
                "labels": ((batch, seq), TOKEN_DTYPE)}
    if cfg.frontend == "vision_patches":
        text = max(seq - cfg.num_patches, 1)
        return {"tokens": ((batch, text), TOKEN_DTYPE),
                "patches": ((batch, cfg.num_patches, cfg.d_model),
                            EMBED_DTYPE),
                "labels": ((batch, text), TOKEN_DTYPE)}
    return {"tokens": ((batch, seq), TOKEN_DTYPE),
            "labels": ((batch, seq), TOKEN_DTYPE)}


def make_batch(cfg: ModelConfig, gen: torch.Generator, batch: int, seq: int,
               *, device="cuda") -> Dict[str, torch.Tensor]:
    """A random batch of :func:`batch_specs`' shapes from ``gen`` (a
    generator on ``device``): tokens and labels uniform over the
    vocabulary, embeddings standard normal drawn in f32 and rounded to
    bf16. The port's own numbers, not JAX's."""
    dev = resolve_device(device)
    out = {}
    for name, (shape, dtype) in batch_specs(cfg, batch, seq).items():
        if dtype == TOKEN_DTYPE:
            out[name] = torch.randint(0, cfg.vocab_size, shape,
                                      generator=gen, device=dev)
        else:
            out[name] = torch.randn(shape, generator=gen,
                                    device=dev).to(dtype)
    return out


__all__ = ["batch_specs", "build_model", "make_batch"]
