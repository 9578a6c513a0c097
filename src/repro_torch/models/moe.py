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
statistics.

On a device mesh (``rules.mesh``) :func:`moe_apply` takes the reference's
expert-parallel path :func:`moe_apply_a2a`: each rank routes its own
(batch, sequence) block of tokens into per-expert capacity buffers, one
``all_to_all_single`` over the "model" group sends each buffer to the rank
holding its experts, the local experts run their FFN (K4x on packed
experts), and a second all-to-all brings the outputs back. When the
experts do not tile the model axis (grok-1's 8 on 16), each expert is
split into r slots along d_ff (:func:`_slot_weights`) whose partial sums
the combine adds. The all-to-alls are the autograd-aware forms of
``torch.distributed.nn.functional``, so the path trains.

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
from repro_torch.sharding import (NO_RULES, P, ShardingRules, axes_group,
                                  hint, is_dtensor,
                                  local_block, mesh_axis_names, mesh_coord)


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


def moe_logical_axes(cfg: ModelConfig):
    """(L, E, d, f) expert-weight sharding: experts on TP when there are
    enough of them to tile the 16-wide production axis; otherwise (grok-1's
    8 experts) TP moves to the d_ff dim."""
    e_on_tp = cfg.num_experts >= 16
    if e_on_tp:
        up, down = (None, "tp", "fsdp", None), (None, "tp", None, "fsdp")
    else:
        up, down = (None, None, "fsdp", "tp"), (None, None, "tp", "fsdp")
    ax = {"router": (None, None, None),        # (L, d, E) replicated
          "wu": up, "wd": down, "norm": (None, None)}
    if cfg.mlp_act == "silu":
        ax["wg"] = up
    return ax


def moe_apply_dense(p, x: torch.Tensor, cfg: ModelConfig,
                    rules: ShardingRules = NO_RULES, *,
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
    # out of place: on a mesh idx and gates are DTensors, which scatter
    # into a plain tensor in place refuses
    ge = torch.zeros((t, cfg.num_experts), dtype=torch.float32,
                     device=x.device).scatter(1, idx, gates)
    ge = hint(ge, rules, ("batch", None))
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
    elif is_dtensor(wd):
        # experts sharded on a mesh: each rank's experts, then their sum
        y = torch.einsum("tef,efd->td", up * ge.to(up.dtype)[..., None], wd)
    else:
        # y = Σ_e (ge[:, e] · up[:, e]) wd[e], accumulated expert by expert
        # (in place, which autograd differentiates too: addmm_ keeps its
        # two factors, not y)
        y = up.new_zeros((t, d))
        gu = ge.to(up.dtype)
        for e, wd_e in enumerate(wd.unbind(0)):
            y.addmm_(up[:, e] * gu[:, e, None], wd_e)
    return y.reshape(b, s, d).to(x.dtype)


def _expert_mm(w, xe: torch.Tensor) -> torch.Tensor:
    """(E, C, d_in) through a per-expert weight → (E, C, d_out): a batched
    product, or K4x on a stacked QTensor."""
    return L.expert_apply(w, xe, per_expert=True)


def _expert_ffn(xe: torch.Tensor, wg, wu, wd, act: str) -> torch.Tensor:
    """xe: (E, C, d) per-expert token buffers, expert-batched products."""
    up = _expert_mm(wu, xe)
    if wg is not None:
        up = L.mlp_act(_expert_mm(wg, xe), "silu") * up
    else:
        up = L.mlp_act(up, act)
    return _expert_mm(wd, up)


def _slot_factor(cfg: ModelConfig, n_shards: int) -> int:
    """EP×TP slot replication: when the expert count does not cover the TP
    axis (grok-1: 8 experts on 16 shards), each expert is split into
    r = n_shards // E slots along d_ff, whose outputs are partial sums the
    combine step adds back. r = 1 when E % n_shards == 0."""
    e = cfg.num_experts
    if e % n_shards == 0:
        return 1
    assert n_shards % e == 0 and cfg.d_ff % (n_shards // e) == 0, \
        f"experts={e} cannot tile TP axis {n_shards}"
    return n_shards // e


def _slot_weights(p, cfg: ModelConfig, r: int, rules: ShardingRules):
    """Re-layout (E, d, f) expert weights into (E·r, d, f/r) slots (and
    (E·r, f/r, d) for the down projection); (wg, wu, wd), wg None without
    a gate."""
    wu, wd, wg = p["wu"], p["wd"], p.get("wg")
    if r == 1:
        return wg, wu, wd
    assert not any(isinstance(w, QTensor) for w in (wu, wd, wg)), \
        "EP×TP slot re-layout (r>1) reshapes raw weights; packed experts " \
        "take the masked-dense path (moe_apply guards this)"
    # the re-layout reads each expert's whole d_ff: gathered whole here;
    # each rank uses its own slots on its own tokens, so the gradient is a
    # partial sum over every mesh dim
    def whole(w):
        if not is_dtensor(w):
            return w
        from torch.distributed.tensor import Partial
        return w.full_tensor(
            grad_placements=[Partial()] * w.device_mesh.ndim)
    wu, wd, wg = (whole(w) if w is not None else None
                  for w in (wu, wd, wg))
    e, d, f = wu.shape
    fr = f // r

    def split_up(w):
        w2 = w.reshape(e, d, r, fr).permute(0, 2, 1, 3).reshape(e * r, d, fr)
        return hint(w2, rules, ("tp", None, None))
    wu2 = split_up(wu)
    wg2 = split_up(wg) if wg is not None else None
    wd2 = hint(wd.reshape(e, r, fr, d).reshape(e * r, fr, d),
               rules, ("tp", None, None))
    return wg2, wu2, wd2


def _local_slots(w, rules: ShardingRules):
    """This rank's share of an (E_eff, …) expert stack (a stacked QTensor
    per child): the stack's dim 0 split over the model axis. A DTensor is
    redistributed to that layout, so each rank receives only its own
    experts (autograd-aware: the batch axes' ranks route different tokens
    through them, so their gradient is summed there); a plain tensor is
    held whole by every rank and sliced."""
    def one(t):
        return local_block(t, rules.mesh,
                           P(rules.tp_axis, *[None] * (t.dim() - 1)),
                           partial_axes=tuple(rules.batch_axes))
    if w is None:
        return None
    if isinstance(w, QTensor):
        return w.map(one)
    return one(w)


def _a2a_layout(x_shape, cfg: ModelConfig, rules: ShardingRules):
    """(b_loc, s_loc, capacity) of the a2a path for x of ``x_shape``."""
    b, s, _ = x_shape
    n_shards = rules.axis_size(rules.tp_axis)
    b_loc, s_loc = b // rules.axis_size(rules.batch_axes), s // n_shards
    t_loc = b_loc * s_loc
    cap = max(8, int(t_loc * cfg.experts_per_token / cfg.num_experts
                     * cfg.capacity_factor))
    return b_loc, s_loc, -(-cap // 8) * 8                # round up to 8


def _token_block(xn, rules: ShardingRules, b_loc: int, s_loc: int, pl):
    """This rank's (b_loc, s_loc, d) block of the normed tokens."""
    mesh, tp = rules.mesh, rules.tp_axis
    if is_dtensor(xn):
        return xn.redistribute(mesh, pl).to_local()
    bi = mesh_coord(mesh, tuple(rules.batch_axes))
    si = mesh_coord(mesh, (tp,))
    return xn[bi * b_loc:(bi + 1) * b_loc, si * s_loc:(si + 1) * s_loc]


def _token_placements(rules: ShardingRules):
    """The a2a token layout: batch over the batch axes, sequence over
    "model"."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axis_names(rules.mesh)
    pl = [Replicate() for _ in names]
    for a in rules.batch_axes:
        pl[names.index(a)] = Shard(0)
    pl[names.index(rules.tp_axis)] = Shard(1)
    return pl


def a2a_dropped(p, x, cfg: ModelConfig, rules: ShardingRules) -> int:
    """How many (token, expert) assignments of this rank's block the a2a
    path's capacity drops for x (a host count, for checks)."""
    b_loc, s_loc, cap = _a2a_layout(x.shape, cfg, rules)
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    x3 = _token_block(xn, rules, b_loc, s_loc, _token_placements(rules))
    router_w = p["router"]
    if is_dtensor(router_w):
        router_w = router_w.full_tensor()
    _, idx = _gates(x3.reshape(b_loc * s_loc, -1), router_w,
                    cfg.experts_per_token)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
    return int(torch.clamp(counts - cap, min=0).sum())


def moe_apply_a2a(p, x, cfg: ModelConfig, rules: ShardingRules):
    """Expert-parallel MoE FFN over ``rules.mesh``. x (B, S, d): a DTensor
    (the result is one, sharded ("batch", "tp"-on-seq, None)) or a plain
    tensor every rank holds whole (the result is whole on every rank).
    Each rank flattens its own (B/dp, S/tp) token block, fills per-expert
    buffers of ``capacity`` rows (tokens past it are dropped, as in the
    reference), and dispatches and returns them with one all-to-all each
    over the model group."""
    import torch.distributed.nn.functional as dfn
    from torch.distributed.tensor import DTensor
    mesh = rules.mesh
    assert mesh is not None and rules.tp_axis is not None
    tp = rules.tp_axis
    n_shards = rules.axis_size(tp)
    d = x.shape[-1]
    e, k = cfg.num_experts, cfg.experts_per_token
    r = _slot_factor(cfg, n_shards)   # EP×TP slots (grok: 8e → r=2)
    e_eff = e * r
    e_loc = e_eff // n_shards
    b_loc, s_loc, cap = _a2a_layout(x.shape, cfg, rules)
    t_loc = b_loc * s_loc
    pl = _token_placements(rules)
    xn = hint(L.rmsnorm(x, p["norm"], cfg.norm_eps), rules,
              ("batch", "tp", None))
    x3 = _token_block(xn, rules, b_loc, s_loc, pl)
    # every rank routes its own token block: the router's gradient is a
    # partial sum over the batch axes and "model"
    router_w = local_block(p["router"], mesh, P(None, None),
                           partial_axes=(*rules.batch_axes, tp))
    wg, wu, wd = (_local_slots(w, rules)
                  for w in _slot_weights(p, cfg, r, rules))
    group = axes_group(mesh, (tp,))

    xt = x3.reshape(t_loc, d)
    gates, idx = _gates(xt, router_w, k)                 # (t_loc, k)
    flat_e = idx.reshape(-1)                             # (t_loc·k,)
    onehot = torch.nn.functional.one_hot(flat_e, e)
    pos = (torch.cumsum(onehot, dim=0) * onehot - 1).amax(dim=-1)
    keep = pos < cap
    tok_idx = torch.arange(t_loc, device=xt.device).repeat_interleave(k)
    src = torch.where(keep[:, None], xt[tok_idx], 0.0)
    buf = xt.new_zeros((e, cap, d)).index_put(
        (flat_e, torch.where(keep, pos, cap - 1)), src, accumulate=True)
    if r > 1:                                            # duplicate to slots
        buf = buf.repeat_interleave(r, dim=0)            # (e_eff, cap, d)
    send = buf.reshape(n_shards, e_loc, cap, d).contiguous()
    recv = dfn.all_to_all_single(torch.empty_like(send), send, group=group)
    # recv: (n_shards, e_loc, cap, d), tokens from every source rank
    xe = recv.transpose(0, 1).reshape(e_loc, n_shards * cap, d)
    ye = _expert_ffn(xe, wg, wu, wd, cfg.mlp_act)        # partial over slots
    back = ye.reshape(e_loc, n_shards, cap, d).transpose(0, 1).contiguous()
    ret = dfn.all_to_all_single(torch.empty_like(back), back, group=group)
    ret = ret.reshape(e_eff, cap, d)                     # source-layout
    if r > 1:                                            # sum slot partials
        ret = ret.reshape(e, r, cap, d).sum(dim=1)
    out_k = ret[flat_e, torch.clamp(pos, 0, cap - 1)]    # (t_loc·k, d)
    out_k = torch.where(keep[:, None], out_k, 0.0)
    y = (out_k.reshape(t_loc, k, d)
         * gates[..., None].to(out_k.dtype)).sum(dim=1)
    y = DTensor.from_local(y.reshape(b_loc, s_loc, d).to(x.dtype), mesh, pl,
                           run_check=False)
    return y if is_dtensor(x) else y.full_tensor()


def moe_apply(p, x, cfg: ModelConfig, rules: ShardingRules = NO_RULES, *,
              capture: Optional[dict] = None):
    """The MoE FFN, on the reference's path: the masked all-expert compute
    on one device (or with ``capture``); on a mesh the all-to-all path
    whenever the experts tile the model axis and each rank gets at least
    64 tokens. Packed experts ride a2a only when the slot factor is 1."""
    packed = any(isinstance(p.get(k), QTensor) for k in ("wu", "wd", "wg"))
    if rules.mesh is None or capture is not None:
        return moe_apply_dense(p, x, cfg, rules, capture=capture)
    b, s, _ = x.shape
    tp = rules.axis_size(rules.tp_axis or ())
    dp = rules.axis_size(rules.batch_axes)
    e = cfg.num_experts
    tileable = (e % tp == 0) or (tp % e == 0 and cfg.d_ff % (tp // e) == 0)
    if packed:
        tileable = e % tp == 0          # packed codes can't slot-split (r>1)
    ok = (tp > 1 and tileable and b % dp == 0
          and s % tp == 0 and (b // dp) * (s // tp) >= 64)
    if ok:
        return moe_apply_a2a(p, x, cfg, rules)
    return moe_apply_dense(p, x, cfg, rules)


def moe_block_params(gen, cfg: ModelConfig, *, lead=(), dtype=torch.float32,
                     device="cpu"):
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {"attn": L.attn_params(gen, cfg, **kw),
            "moe": moe_params(gen, cfg, **kw)}


def moe_block_apply(p, x, cfg, rules: ShardingRules = NO_RULES, *,
                    positions=None, capture=None,
                    kv_cache=None, cache_pos=0, attend_cache: bool = False,
                    block_table=None, fused_decode: bool = False,
                    attn_chunk: int = 1024):
    """Attention then the MoE FFN, each as a residual; the arguments of
    :func:`repro_torch.models.transformer.block_apply`."""
    a, new_kv = L.attn_apply(p["attn"], x, cfg, rules, positions=positions,
                             capture=capture, kv_cache=kv_cache,
                             cache_pos=cache_pos, attend_cache=attend_cache,
                             block_table=block_table,
                             fused_decode=fused_decode,
                             attn_chunk=attn_chunk)
    x = x + a
    x = x + moe_apply(p["moe"], x, cfg, rules, capture=capture)
    return x, new_kv


class MoEModel(T.DenseModel):
    """Decoder LM with the MoE FFN (the ``moe`` family: qwen3-moe)."""

    FAMILY = "moe"

    def _block_params(self, gen, lead, dtype, dev):
        return moe_block_params(gen, self.cfg, lead=lead, dtype=dtype,
                                device=dev)

    def _block(self, p, x, **kw):  # lint: hotpath
        return moe_block_apply(p, x, self.cfg, self.rules, **kw)

    def param_logical_axes(self):
        ax = super().param_logical_axes()
        ax["blocks"] = {"attn": ax["blocks"]["attn"],
                        "moe": moe_logical_axes(self.cfg)}
        return ax

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


__all__ = ["MoEModel", "a2a_dropped", "moe_apply", "moe_apply_a2a",
           "moe_apply_dense", "moe_block_apply", "moe_block_params",
           "moe_logical_axes", "moe_params"]
