"""Per-request token sampling inside the serving steps (the port of
``repro/serving/sampling.py``).

Each slot carries its own (temperature, top_k, seed) as tensors, so one
step serves any mix of greedy and sampled requests, and decode still moves
one int32 per slot to the host.

Greedy rows (temperature 0) are exactly ``argmax``. Sampled rows draw
by Gumbel-max from a stateless, counter-based key: the uniform of vocab
entry ``i`` for a request's n-th generated token is a 32-bit integer hash
of ``(seed, n, i)``, computed on the device for the whole batch in one
call. A token therefore depends only on the request's seed and index,
never on its slot or on the rest of the batch. PyTorch has no counterpart
of JAX's ``fold_in``/threefry, so the sampled streams differ from the
reference's; greedy streams are identical.
"""
from __future__ import annotations

import dataclasses

import torch

_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy. ``temperature == 0`` → greedy (argmax);
    ``top_k == 0`` → no truncation. ``top_k`` is truncated to the engine's
    ``max_top_k``."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xor-shift-multiply) on int64 tensors
    holding values in [0, 2^32); multipliers below 2^31 keep every product
    inside int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _MASK
    return x ^ (x >> 16)


def _uniforms(seeds: torch.Tensor, steps: torch.Tensor, v: int) -> torch.Tensor:
    """(B, V) uniforms in (0, 1) from the counters (seed, step, vocab
    index): the same triple gives the same number on any row."""
    idx = torch.arange(v, device=seeds.device, dtype=torch.int64)
    s = _mix32(seeds.to(torch.int64) & _MASK)
    n = _mix32((steps.to(torch.int64) & _MASK) ^ 0x5BD1E995)
    x = _mix32((s[:, None] * 0x27D4EB2F + n[:, None]) & _MASK)
    x = _mix32((x ^ idx[None, :]) & _MASK)
    # 24 random bits → (0, 1), never 0 or 1
    return ((x >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                  top_ks: torch.Tensor, seeds: torch.Tensor,
                  steps: torch.Tensor, *, max_top_k: int = 64
                  ) -> torch.Tensor:
    """logits (B, V) → (B,) int64 tokens under per-row sampling params.

    temps/top_ks/seeds/steps are (B,) tensors on the logits' device;
    ``steps`` is the request's generated-token index. Rows with temp <= 0
    take the argmax."""
    b, v = logits.shape
    kk = min(max_top_k, v)
    greedy = torch.argmax(logits, dim=-1)
    temps = temps.to(torch.float32)
    scaled = logits.to(torch.float32) / torch.clamp(temps, min=1e-6)[:, None]
    if kk > 0:
        vals = torch.topk(scaled, kk, dim=-1).values                # (B, kk)
        k = top_ks.to(torch.int64)
        thr = torch.gather(vals, 1, torch.clamp(k - 1, 0, kk - 1)[:, None])
        cut = (k[:, None] > 0) & (scaled < thr)
        scaled = scaled.masked_fill(cut, float("-inf"))
    gumbel = -torch.log(-torch.log(_uniforms(seeds, steps, v)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled)


__all__ = ["SamplingParams", "sample_tokens"]
