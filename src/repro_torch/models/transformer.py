"""Dense decoder LM (the port of ``repro/models/transformer.py::DenseModel``).

Parameters are a nested dict of tensors that mirrors the JAX tree: blocks
stacked on a leading layer dim, weights stored ``(d_in, d_out)``, packed
layers as stacked :class:`~repro_torch.quant.QTensor` leaves — so
compression paths, policy names and checkpoint keys carry over unchanged.
The model object holds only its config; every method takes the params.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.quant import QTensor
from repro_torch.serving.kv_cache import QuantizedKV

Params = Dict[str, Any]


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a params tree (QTensor fields
    included), keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.map(fn)
    return fn(tree)


def block_apply(p, x, cfg, *, positions=None, capture=None, kv_cache=None,
                cache_pos=0, attend_cache: bool = False, block_table=None,
                fused_decode: bool = False, attn_chunk: int = 1024):
    a, new_kv = L.attn_apply(p["attn"], x, cfg, positions=positions,
                             capture=capture, kv_cache=kv_cache,
                             cache_pos=cache_pos, attend_cache=attend_cache,
                             block_table=block_table,
                             fused_decode=fused_decode,
                             attn_chunk=attn_chunk)
    x = x + a
    x = x + L.mlp_apply(p["mlp"], x, cfg, capture=capture)
    return x, new_kv


def _layer(entry, i: int):
    """Layer ``i`` of stacked cache storage (a view; dense or quantized)."""
    if isinstance(entry, QuantizedKV):
        return QuantizedKV(entry.codes[i], entry.scale[i], entry.zero[i],
                           entry.group_size)
    return entry[i]


class DenseModel(nn.Module):
    """Dense-family decoder LM; holds its config, no parameters of its own.

    ``attn_chunk`` is the query and KV chunk of the prefill's
    :func:`~repro_torch.models.layers.flash_attention` (the reference's
    ``DenseModel.attn_chunk``). ``use_fused_decode`` routes the s == 1
    cache read through K6 instead of the expand-then-attend reference; off
    by default, as in the reference, and the serving engine sets it per
    ``EngineConfig.use_fused_decode``.
    """

    def __init__(self, cfg: ModelConfig, *, attn_chunk: int = 1024,
                 use_fused_decode: bool = False):
        super().__init__()
        if cfg.family != "dense" or cfg.frontend is not None:
            raise ValueError(f"DenseModel runs the plain dense family, got "
                             f"{cfg.family}/{cfg.frontend}")
        self.cfg = cfg
        self.attn_chunk = attn_chunk
        self.use_fused_decode = use_fused_decode

    # -- params ------------------------------------------------------------
    def init(self, seed: int = 0, *, device="cuda",
             dtype=torch.float32) -> Params:
        """Random parameters from ``seed`` (a ``torch.Generator`` on the
        target device; not the JAX package's numbers — the tests carry JAX
        weights across with :mod:`repro_torch.bridge`)."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        lead = (cfg.num_layers,)
        params = {
            "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                  dtype=dtype, device=dev),
            "blocks": {
                "attn": L.attn_params(gen, cfg, lead=lead, dtype=dtype,
                                      device=dev),
                "mlp": L.mlp_params(gen, cfg, lead=lead, dtype=dtype,
                                    device=dev)},
            "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(gen, cfg.d_model,
                                             cfg.padded_vocab, dtype=dtype,
                                             device=dev)
        return params

    # -- forward -----------------------------------------------------------
    def embed(self, params: Params, batch: Dict[str, torch.Tensor]):
        return params["embed"][batch["tokens"].to(torch.int64)]

    def _head_w(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def _mask_pad(self, logits: torch.Tensor) -> torch.Tensor:
        """Padded vocab columns → the dtype's lowest value."""
        v = self.cfg.vocab_size
        if logits.shape[-1] == v:
            return logits
        iota = torch.arange(logits.shape[-1], device=logits.device)
        return logits.masked_fill(iota >= v, torch.finfo(logits.dtype).min)

    def _head(self, params, h):
        h = L.rmsnorm(h, params["final_norm"], self.cfg.norm_eps)
        return self._mask_pad(L.linear_apply(self._head_w(params), h))

    def hidden_states(self, params, batch) -> torch.Tensor:
        h = self.embed(params, batch)
        for i in range(self.num_blocks()):
            h, _ = block_apply(self.block_slice(params, i), h, self.cfg,
                               attn_chunk=self.attn_chunk)
        return L.rmsnorm(h, params["final_norm"], self.cfg.norm_eps)

    def logits(self, params, batch) -> torch.Tensor:
        return self._mask_pad(L.linear_apply(self._head_w(params),
                                             self.hidden_states(params, batch)))

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.float32, *,
                   device="cuda"):
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        dev = resolve_device(device)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "pos": 0}

    def _cached_pass(self, params, h, cache, positions, *,
                     attend_cache: bool = False):
        """Every block against its layer of the cache. Cache storage (dense
        (L, B, T, Hk, D) tensors or :class:`QuantizedKV`) is written in
        place; ``cache["pos"]`` is a host int (uniform batch) or a (B,)
        tensor of per-slot positions (the engine's decode)."""
        for i in range(self.num_blocks()):
            layer_kv = tuple(_layer(cache[n], i) for n in ("k", "v"))
            h, _ = block_apply(self.block_slice(params, i), h, self.cfg,
                               positions=positions, kv_cache=layer_kv,
                               cache_pos=cache["pos"],
                               attend_cache=attend_cache,
                               block_table=cache.get("table"),
                               fused_decode=self.use_fused_decode,
                               attn_chunk=self.attn_chunk)
        return h, dict(cache, pos=cache["pos"] + positions.shape[1])

    @staticmethod
    def _positions(h, pos):
        """(B, S) absolute positions from a host-int or per-slot base."""
        b, s = h.shape[0], h.shape[1]
        base = pos[:, None] if torch.is_tensor(pos) and pos.dim() == 1 \
            else pos
        return torch.arange(s, device=h.device)[None, :].expand(b, s) + base

    def prefill(self, params, batch, cache):
        """Teacher-forced pass that fills the cache; returns last logits."""
        h = self.embed(params, batch)
        h, cache = self._cached_pass(params, h, cache,
                                     self._positions(h, cache["pos"]))
        return self._head(params, h[:, -1:, :]), cache

    def _prefill_rows(self, params, batch, cache, lengths, attend_cache):
        h = self.embed(params, batch)
        h, cache = self._cached_pass(params, h, cache,
                                     self._positions(h, cache["pos"]),
                                     attend_cache=attend_cache)
        s = h.shape[1]
        idx = torch.clamp(lengths.to(torch.int64) - 1, 0, s - 1)
        h_last = torch.gather(h, 1, idx[:, None, None].expand(-1, 1,
                                                              h.shape[2]))
        return self._head(params, h_last), cache

    def prefill_at(self, params, batch, cache, lengths):
        """Prefill right-padded prompts with per-row true ``lengths`` (B,)
        tensor: the same cache fill as :meth:`prefill`, logits gathered at
        each row's last real token. The engine's bucketed prefill."""
        return self._prefill_rows(params, batch, cache, lengths, False)

    def prefill_chunk(self, params, batch, cache, lengths):
        """One fixed-width chunk of a longer prompt against a cache that
        holds the earlier chunks below ``cache["pos"]`` (a host int): the
        chunk's K/V is written at [pos, pos + W) — columns past the cache
        edge dropped — and the queries attend the cache under the offset
        causal mask. Logits at the chunk-local ``lengths - 1`` (meaningful
        on the final chunk only)."""
        return self._prefill_rows(params, batch, cache, lengths, True)

    def decode_step(self, params, tokens, cache):
        """One decode step. tokens: (B, 1) int. ``cache["pos"]`` is a host
        int (uniform batch) or a per-slot (B,) tensor (engine path)."""
        h = params["embed"][tokens.to(torch.int64)]
        pos = cache["pos"]
        if torch.is_tensor(pos) and pos.dim() == 1:
            positions = pos.to(torch.int64)[:, None]
        else:
            positions = torch.full((h.shape[0], 1), int(pos),
                                   device=h.device, dtype=torch.int64)
        h, cache = self._cached_pass(params, h, cache, positions)
        return self._head(params, h), cache

    # -- compression protocol ------------------------------------------------
    def num_blocks(self) -> int:
        return self.cfg.num_layers

    def block_slice(self, params, i: int):
        return tree_map(lambda x: x[i], params["blocks"])

    def block_apply_one(self, params, i: int, h, *, capture=False):
        cap: Optional[dict] = {} if capture else None
        out, _ = block_apply(self.block_slice(params, i), h, self.cfg,
                             capture=cap)
        return out, (cap or {})

    def block_linears(self, i: int):
        """(name, param_path, capture_key) of block i's linears."""
        specs = [
            ("wq", ("blocks", "attn", "wq"), "attn_in"),
            ("wk", ("blocks", "attn", "wk"), "attn_in"),
            ("wv", ("blocks", "attn", "wv"), "attn_in"),
            ("wo", ("blocks", "attn", "wo"), "attn_out_in"),
            ("wu", ("blocks", "mlp", "wu"), "mlp_in"),
            ("wd", ("blocks", "mlp", "wd"), "mlp_down_in"),
        ]
        if self.cfg.mlp_act == "silu":
            specs.insert(4, ("wg", ("blocks", "mlp", "wg"), "mlp_in"))
        return specs


__all__ = ["DenseModel", "block_apply", "tree_map"]
