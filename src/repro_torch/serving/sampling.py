"""Per-request token sampling inside the serving steps (the port of
``repro/serving/sampling.py``).

Each slot carries its own (temperature, top_k, seed) as tensors, so one
step serves any mix of greedy and sampled requests, and decode still moves
one int32 per slot to the host.

Greedy rows (temperature 0) are exactly ``argmax``. Sampled rows draw
what the reference's ``jax.random.categorical(fold_in(PRNGKey(seed), n),
scaled)`` draws, bit for bit: Threefry-2x32 (JAX's default PRNG, with
``jax_threefry_partitionable`` on) written in int64 tensor ops, computed
on the device for the whole batch in one call. ``PRNGKey(s)`` is the key
``(0, s)``, ``fold_in(k, n)`` is ``threefry(k, (0, n))``, vocab entry ``i``
takes the xor of the two words of ``threefry(key, (0, i))``, and the
token is ``argmax(scaled + gumbel)`` with JAX's uniform-to-Gumbel map. A
token therefore depends only on the request's seed and index, never on
its slot or on the rest of the batch.
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


_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 words;
    keys and counters broadcast against each other."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _uniforms(seeds: torch.Tensor, steps: torch.Tensor, v: int) -> torch.Tensor:
    """(B, V) f32 uniforms in [tiny, 1) as ``jax.random.uniform(
    fold_in(PRNGKey(seed), step), (V,), minval=tiny)`` gives them."""
    zero = torch.zeros_like(seeds, dtype=torch.int64)
    k0, k1 = _threefry2x32(zero, seeds.to(torch.int64) & _MASK,
                           zero, steps.to(torch.int64) & _MASK)
    idx = torch.arange(v, device=seeds.device, dtype=torch.int64)[None, :]
    b0, b1 = _threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(idx),
                           idx)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    return torch.clamp(floats * (1.0 - tiny) + tiny, min=tiny)


def sample_scores(logits: torch.Tensor, temps: torch.Tensor,
                  top_ks: torch.Tensor, seeds: torch.Tensor,
                  steps: torch.Tensor, *, max_top_k: int = 64
                  ) -> torch.Tensor:
    """(B, V) f32 scores whose argmax is a sampled row's token: the logits
    over the row's temperature, those below its top-k cut at −inf, plus
    the Gumbel noise ``jax.random.categorical`` adds."""
    v = logits.shape[-1]
    kk = min(max_top_k, v)
    temps = temps.to(torch.float32)
    scaled = logits.to(torch.float32) / torch.clamp(temps, min=1e-6)[:, None]
    if kk > 0:
        vals = torch.topk(scaled, kk, dim=-1).values                # (B, kk)
        k = top_ks.to(torch.int64)
        thr = torch.gather(vals, 1, torch.clamp(k - 1, 0, kk - 1)[:, None])
        cut = (k[:, None] > 0) & (scaled < thr)
        scaled = scaled.masked_fill(cut, float("-inf"))
    u = _uniforms(seeds, steps, v)
    return -torch.log(-torch.log(u)) + scaled


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                  top_ks: torch.Tensor, seeds: torch.Tensor,
                  steps: torch.Tensor, *, max_top_k: int = 64
                  ) -> torch.Tensor:
    """logits (B, V) → (B,) int64 tokens under per-row sampling params.

    temps/top_ks/seeds/steps are (B,) tensors on the logits' device;
    ``steps`` is the request's generated-token index. Rows with temp <= 0
    take the argmax."""
    greedy = torch.argmax(logits, dim=-1)
    sampled = torch.argmax(sample_scores(logits, temps, top_ks, seeds, steps,
                                         max_top_k=max_top_k), dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled)


__all__ = ["SamplingParams", "sample_scores", "sample_tokens"]
