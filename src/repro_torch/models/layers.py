"""Dense-family model building blocks.

Conventions (as ``repro/models/layers.py``):
- Linear weights are stored ``(d_in, d_out)`` (activation @ weight); the
  compression library works in paper orientation ``(d_out, d_in)``.
- ``capture`` dicts collect pre-matmul activations for calibration.
- Attention is plain f32 (scores, masked softmax, weighted sum); the
  reference's chunked online-softmax scan is arithmetic, not a kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.quant import QTensor


# ---------------------------------------------------------------------------
# linear dispatch: dense tensor or packed QTensor, one entry point
# ---------------------------------------------------------------------------

def linear_apply(w, x: torch.Tensor) -> torch.Tensor:
    """y = x @ w for a dense ``(d_in, d_out)`` weight, or the same product
    read from a packed :class:`QTensor` (paper orientation) through
    ``QTensor.matmul_dispatch`` — K4 on the card."""
    if isinstance(w, QTensor):
        lead = x.shape[:-1]
        y = w.matmul_dispatch(x.reshape(-1, x.shape[-1]))
        return y.reshape(*lead, y.shape[-1]).to(x.dtype)
    return x @ w


# ---------------------------------------------------------------------------
# init helpers (torch.Generator streams; not the JAX package's numbers)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, lead=(),
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    w = torch.randn(tuple(lead) + (d_in, d_out), generator=gen,
                    dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / rope / activations
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D) with even D; positions: (B, S)."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    ang = positions[..., None].to(torch.float32) * freqs        # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return x * torch.sigmoid(x)
    if kind == "gelu":                       # jax.nn.gelu's default form
        return torch.nn.functional.gelu(x, approximate="tanh")
    if kind == "relu2":
        r = torch.relu(x)
        return r * r
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _scores(q: torch.Tensor, k: torch.Tensor, g: int) -> torch.Tensor:
    """(B, Sq, H, D) × (B, Skv, Hk, D) → (B, H, Sq, Skv), GQA groups."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    qh = q.reshape(b, sq, hk, g, d).to(torch.float32)
    s = torch.einsum("bqkgd,bnkd->bkgqn", qh, k.to(torch.float32))
    return s.reshape(b, h, sq, k.shape[1])


def _pv(p: torch.Tensor, v: torch.Tensor, g: int) -> torch.Tensor:
    """(B, H, Sq, Skv) × (B, Skv, Hk, D) → (B, Sq, H, D), f32."""
    b, h, sq, skv = p.shape
    hk = h // g
    out = torch.einsum("bkgqn,bnkd->bqkgd", p.reshape(b, hk, g, sq, skv),
                       v.to(torch.float32))
    return out.reshape(b, sq, h, v.shape[-1])


def causal_attention(q, k, v) -> torch.Tensor:
    """Prefill attention of fresh tokens on themselves (positions 0..S-1):
    max-subtracted exponentials, then the weighted sum divided by the row
    sum — the reference's online-softmax arithmetic over a single chunk."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    sc = _scores(q, k, g) * (1.0 / math.sqrt(d))
    idx = torch.arange(s, device=q.device)
    mask = idx[None, :] <= idx[:, None]                         # (Sq, Skv)
    sc = torch.where(mask, sc, torch.tensor(float("-inf"), device=q.device))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1)                                           # (B, H, Sq)
    out = _pv(p, v, g)                                          # (B, Sq, H, D)
    l = torch.clamp(l, min=1e-30).permute(0, 2, 1)[..., None]   # (B, Sq, H, 1)
    return (out / l).to(q.dtype)


def decode_attention(q, k_cache, v_cache, q_positions) -> torch.Tensor:
    """New tokens against a slot cache (B, Smax, Hk, D): key index ≤ each
    query's absolute position (the new K/V are already written)."""
    b, sq, h, d = q.shape
    g = h // k_cache.shape[2]
    sc = _scores(q, k_cache, g) / math.sqrt(d)
    k_idx = torch.arange(k_cache.shape[1], device=q.device)
    valid = k_idx[None, None, :] <= q_positions[:, :, None]     # (B, Sq, Smax)
    sc = torch.where(valid[:, None], sc,
                     torch.tensor(float("-inf"), device=q.device))
    p = torch.softmax(sc, dim=-1)
    return _pv(p, v_cache, g).to(q.dtype)


# ---------------------------------------------------------------------------
# attention + MLP blocks (dense family)
# ---------------------------------------------------------------------------

def attn_params(gen, cfg, *, lead=(), dtype=torch.float32, device="cpu"):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {
        "wq": dense_init(gen, d, cfg.num_heads * hd, **kw),
        "wk": dense_init(gen, d, cfg.num_kv_heads * hd, **kw),
        "wv": dense_init(gen, d, cfg.num_kv_heads * hd, **kw),
        "wo": dense_init(gen, cfg.num_heads * hd, d, **kw),
        "norm": torch.ones(tuple(lead) + (d,), dtype=dtype, device=device),
    }


def mlp_params(gen, cfg, *, lead=(), dtype=torch.float32, device="cpu",
               d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(lead=lead, dtype=dtype, device=device)
    p = {"wu": dense_init(gen, d, f, **kw),
         "wd": dense_init(gen, f, d, **kw),
         "norm": torch.ones(tuple(lead) + (d,), dtype=dtype, device=device)}
    if cfg.mlp_act == "silu":                        # gated
        p["wg"] = dense_init(gen, d, f, **kw)
    return p


def attn_apply(p, x, cfg, *, positions=None, capture=None, kv_cache=None,
               cache_pos: int = 0):
    """Pre-norm attention block (residual added by the caller).

    Without ``kv_cache``: causal self-attention over x, returns
    ``(out, (k, v))``. With ``kv_cache=(k_cache, v_cache)`` (B, Smax, Hk, D)
    — the static slot cache — this call's K/V are written in place at
    ``[cache_pos, cache_pos + S)``; a prefill (S > 1, ``cache_pos`` 0)
    attends its own tokens, a decode step (S == 1) attends the cache.
    """
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    h, hk = cfg.num_heads, cfg.num_kv_heads
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    if capture is not None:
        capture["attn_in"] = xn
    q = linear_apply(p["wq"], xn).reshape(b, s, h, hd)
    k = linear_apply(p["wk"], xn).reshape(b, s, hk, hd)
    v = linear_apply(p["wv"], xn).reshape(b, s, hk, hd)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        out = causal_attention(q, k, v)
        new_kv = (k, v)
    else:
        k_cache, v_cache = kv_cache
        k_cache[:, cache_pos:cache_pos + s] = k.to(k_cache.dtype)
        v_cache[:, cache_pos:cache_pos + s] = v.to(v_cache.dtype)
        if s > 1:
            out = causal_attention(q, k, v)
        else:
            out = decode_attention(q, k_cache, v_cache, positions)
        new_kv = (k_cache, v_cache)

    out = out.reshape(b, s, h * hd)
    if capture is not None:
        capture["attn_out_in"] = out
    return linear_apply(p["wo"], out).to(x.dtype), new_kv


def mlp_apply(p, x, cfg, *, capture=None):
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    if capture is not None:
        capture["mlp_in"] = xn
    if cfg.mlp_act == "silu":
        hdn = mlp_act(linear_apply(p["wg"], xn), "silu") * linear_apply(p["wu"], xn)
    else:
        hdn = mlp_act(linear_apply(p["wu"], xn), cfg.mlp_act)
    if capture is not None:
        capture["mlp_down_in"] = hdn
    return linear_apply(p["wd"], hdn).to(x.dtype)


__all__ = ["linear_apply", "dense_init", "embed_init", "rmsnorm", "rope",
           "mlp_act", "causal_attention", "decode_attention", "attn_params",
           "mlp_params", "attn_apply", "mlp_apply"]
