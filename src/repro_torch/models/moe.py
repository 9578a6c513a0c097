"""Mixture-of-Experts FFN and decoder (the single-device path of
``repro/models/moe.py``).

On one device the reference runs the masked all-expert compute: every
token goes through every expert, and the top-k renormalized softmax gates
(zero for the experts a token was not routed to) weight the outputs. Every
expert weight is read once a step whatever the routing, so decode reads
the same bytes as ideal routing; packed (stacked QTensor) experts read
them at about 4 bits a weight through K4x, one launch for each of wg, wu
and wd. The capture pass also returns the routing mask and each expert's
inputs, from which ``compress_model`` builds per-expert calibration
statistics. The reference's all-to-all path (``moe_apply_a2a``) needs a
device mesh and is not ported.

Training takes the gradient through the same arithmetic (the router's
stable top-k sort, the renormalization, the scatter into the (T, E) gate
matrix, every expert's products): when a graph is being built the
up-projections are stacked out of place and silu(g)·up is not written
into g, and nothing else changes, so the loss has the inference form's
bits. Autograd then keeps six (T, E, f) f32 tensors a block: up, g,
sigmoid(g), silu(g), silu(g)·up, and the gate-weighted factors of the
down projection's products. At qwen3-moe's width and a 16 × 64 batch
(1,024 tokens) each is 805 MB, 4.8 GB a block, held for one block at a
time under remat (each block is recomputed in backward, as the
reference's ``jax.checkpoint`` around its scan body); the masked path
computes every expert for every token, E/k = 16 times the routed work.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.quant import QTensor


def moe_params(gen, cfg: ModelConfig, *, lead=(), dtype=torch.float32,
               device="cpu"):
    """Router (d, E), expert stacks wu, wg (E, d, f) and wd (E, f, d), and
    the FFN's norm, with ``lead`` dims in front (torch.Generator streams;
    not the JAX package's numbers)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = tuple(lead)

    def normal(shape, fan_in):
        w = torch.randn(lead + shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * (1.0 / math.sqrt(fan_in))).to(dtype)

    p = {"router": L.dense_init(gen, d, e, lead=lead, dtype=dtype,
                                device=device),
         "wu": normal((e, d, f), d),
         "wd": normal((e, f, d), f),
         "norm": torch.ones(lead + (d,), dtype=dtype, device=device)}
    if cfg.mlp_act == "silu":
        p["wg"] = normal((e, d, f), d)
    return p


def _gates(xn: torch.Tensor, router_w: torch.Tensor, k: int):
    """Top-k renormalized softmax gates. xn: (T, d) → (T, k) gates and
    expert indices, ranked as ``jax.lax.top_k`` ranks: by probability,
    a tie going to the lower index (a stable descending sort; ``torch.topk``
    promises no order on ties)."""
    logits = xn.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_i


def moe_apply_dense(p, x: torch.Tensor, cfg: ModelConfig, *,
                    capture: Optional[dict] = None) -> torch.Tensor:
    """Masked all-expert compute. x (B, S, d) → (B, S, d). ``capture``
    receives ``moe_in`` (T, d), ``moe_mask`` (T, E) bool (routed) and
    ``moe_up`` (T, E, f), the down projection's inputs."""
    b, s, d = x.shape
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    t = b * s
    xf = xn.reshape(t, d)
    gates, idx = _gates(xf, p["router"], cfg.experts_per_token)
    # dense gate matrix (T, E): the gate if routed, else 0
    ge = torch.zeros((t, cfg.num_experts), dtype=torch.float32,
                     device=x.device).scatter_(1, idx, gates)
    graph = T.needs_graph(p) or (torch.is_grad_enabled() and x.requires_grad)
    # the (T, E, f) activations are the forward's largest tensors (3.2 GB
    # each at qwen3-moe's width and 4,096 tokens): without a graph,
    # silu(g)·up in place
    up = L.expert_apply(p["wu"], xf)
    if cfg.mlp_act == "silu":
        g = L.expert_apply(p["wg"], xf)
        if graph:
            up = L.mlp_act(g, "silu") * up
        else:
            up = g.mul_(torch.sigmoid(g)).mul_(up)
    else:
        up = L.mlp_act(up, cfg.mlp_act)
    if capture is not None:
        capture["moe_in"] = xf
        capture["moe_mask"] = ge > 0
        capture["moe_up"] = up          # (T, E, f) pre-down activations
    wd = p["wd"]
    if isinstance(wd, QTensor):
        # packed experts: one K4x launch on the (E, T, f) view of up
        ye = L.expert_apply(wd, up.transpose(0, 1), per_expert=True)
        # y[t] = Σ_e ge[t, e] · ye[e, t]: a (1, E) × (E, d) product a token
        y = torch.bmm(ge.to(ye.dtype)[:, None, :], ye.transpose(0, 1))[:, 0]
    else:
        # y = Σ_e (ge[:, e] · up[:, e]) wd[e], accumulated expert by expert
        # (in place, which autograd differentiates too: addmm_ keeps its
        # two factors, not y)
        y = up.new_zeros((t, d))
        gu = ge.to(up.dtype)
        for e, wd_e in enumerate(wd.unbind(0)):
            y.addmm_(up[:, e] * gu[:, e, None], wd_e)
    return y.reshape(b, s, d).to(x.dtype)


def moe_apply(p, x, cfg: ModelConfig, *, capture: Optional[dict] = None):
    """The MoE FFN. On one device the reference's ``moe_apply`` takes the
    masked all-expert path, and so does this one."""
    return moe_apply_dense(p, x, cfg, capture=capture)


def moe_block_params(gen, cfg: ModelConfig, *, lead=(), dtype=torch.float32,
                     device="cpu"):
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {"attn": L.attn_params(gen, cfg, **kw),
            "moe": moe_params(gen, cfg, **kw)}


def moe_block_apply(p, x, cfg, *, positions=None, capture=None,
                    kv_cache=None, cache_pos=0, attend_cache: bool = False,
                    block_table=None, fused_decode: bool = False,
                    attn_chunk: int = 1024):
    """Attention then the MoE FFN, each as a residual; the arguments of
    :func:`repro_torch.models.transformer.block_apply`."""
    a, new_kv = L.attn_apply(p["attn"], x, cfg, positions=positions,
                             capture=capture, kv_cache=kv_cache,
                             cache_pos=cache_pos, attend_cache=attend_cache,
                             block_table=block_table,
                             fused_decode=fused_decode,
                             attn_chunk=attn_chunk)
    x = x + a
    x = x + moe_apply(p["moe"], x, cfg, capture=capture)
    return x, new_kv


class MoEModel(T.DenseModel):
    """Decoder LM with the MoE FFN (the ``moe`` family: qwen3-moe)."""

    FAMILY = "moe"

    def _block_params(self, gen, lead, dtype, dev):
        return moe_block_params(gen, self.cfg, lead=lead, dtype=dtype,
                                device=dev)

    def _block(self, p, x, **kw):
        return moe_block_apply(p, x, self.cfg, **kw)

    def block_linears(self, i: int):
        """(name, param_path, capture_key) of block i's linears: attention,
        then wg, wu, wd of each expert; an expert's path ends in its index
        into the stacked leaf."""
        specs = [
            ("wq", ("blocks", "attn", "wq"), "attn_in"),
            ("wk", ("blocks", "attn", "wk"), "attn_in"),
            ("wv", ("blocks", "attn", "wv"), "attn_in"),
            ("wo", ("blocks", "attn", "wo"), "attn_out_in"),
        ]
        for e in range(self.cfg.num_experts):
            if self.cfg.mlp_act == "silu":
                specs.append((f"moe_wg_{e}", ("blocks", "moe", "wg", e),
                              "moe"))
            specs.append((f"moe_wu_{e}", ("blocks", "moe", "wu", e), "moe"))
            specs.append((f"moe_wd_{e}", ("blocks", "moe", "wd", e),
                          "moe_down"))
        return specs


__all__ = ["MoEModel", "moe_apply", "moe_apply_dense", "moe_block_apply",
           "moe_block_params", "moe_params"]
