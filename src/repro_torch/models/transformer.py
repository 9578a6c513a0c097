"""Dense decoder LM (the port of ``repro/models/transformer.py::DenseModel``).

Parameters are a nested dict of tensors that mirrors the JAX tree: blocks
stacked on a leading layer dim, weights stored ``(d_in, d_out)``, packed
layers as stacked :class:`~repro_torch.quant.QTensor` leaves — so
compression paths, policy names and checkpoint keys carry over unchanged.
The model object holds only its config; every method takes the params.
The audio and vlm families run the same blocks behind a stub frontend, as
in the reference: an audio batch holds precomputed frame embeddings
(``"frames"``, (B, S, d_model)) in place of tokens, a vlm batch
precomputed patch embeddings (``"patches"``, (B, P, d_model)) placed ahead
of its token embeddings, with rope positions over patches and text
together and the loss on the text positions only. Decode steps embed
tokens in every family.
:meth:`DenseModel.loss` is the reference's chunked softmax cross-entropy
(:func:`chunked_xent`): the (B, S, V) logits are never built whole. It
takes a gradient as the reference's does: when a params leaf requires grad
(the train step's), the stacked leaves are unbound once (their backward is
one stack, not a full-size write a layer), each block runs under
``torch.utils.checkpoint`` with ``remat`` (the reference's
``jax.checkpoint`` around the block body) and each logit chunk is
recomputed in backward. Without such a leaf (inference: engines,
calibration capture, perplexity) no graph is built and the forward is the
same code as before.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.quant import QTensor
from repro_torch.serving.kv_cache import QuantizedKV
from repro_torch.sharding import NO_RULES, ShardingRules, hint

Params = Dict[str, Any]

# the families that run the dense blocks behind a stub frontend, and the
# batch key each frontend reads
FRONTENDS = {"audio": "audio_frames", "vlm": "vision_patches"}
FRONTEND_KEYS = {"audio_frames": "frames", "vision_patches": "patches"}


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a params tree (QTensor fields
    included), keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.map(fn)
    return fn(tree)


def block_apply(p, x, cfg, rules: ShardingRules = NO_RULES, *,
                positions=None, capture=None, kv_cache=None,
                cache_pos=0, attend_cache: bool = False, block_table=None,
                fused_decode: bool = False, attn_chunk: int = 1024):
    a, new_kv = L.attn_apply(p["attn"], x, cfg, rules, positions=positions,
                             capture=capture, kv_cache=kv_cache,
                             cache_pos=cache_pos, attend_cache=attend_cache,
                             block_table=block_table,
                             fused_decode=fused_decode,
                             attn_chunk=attn_chunk)
    x = x + a
    x = x + L.mlp_apply(p["mlp"], x, cfg, rules, capture=capture)
    return x, new_kv


def needs_graph(params) -> bool:
    """True when autograd is on and some dense leaf of ``params`` requires
    grad: the training forward (unbound stacks, remat, recomputed logit
    chunks)."""
    if not torch.is_grad_enabled():
        return False
    if isinstance(params, dict):
        return any(needs_graph(v) for v in params.values())
    return isinstance(params, torch.Tensor) and params.requires_grad


def unstack(tree, n: int) -> list:
    """The ``n`` per-layer trees of a dense stacked tree, each leaf
    unbound once along its layer axis (views, the same as ``x[i]``)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _layer(entry, i: int):
    """Layer ``i`` of stacked cache storage (a view; dense or quantized)."""
    if isinstance(entry, QuantizedKV):
        return QuantizedKV(entry.codes[i], entry.scale[i], entry.zero[i],
                           entry.group_size)
    return entry[i]


class DenseModel(nn.Module):
    """Dense-family decoder LM; holds its config, no parameters of its own.
    A family that swaps the block's FFN (``models/moe.py::MoEModel``)
    subclasses it with its own ``FAMILY``, :meth:`_block_params` and
    :meth:`_block`.

    ``attn_chunk`` is the query and KV chunk of the prefill's
    :func:`~repro_torch.models.layers.flash_attention` (the reference's
    ``DenseModel.attn_chunk``); ``LOGIT_CHUNK`` the sequence chunk of
    :meth:`loss` (the reference's ``DenseModel.logit_chunk``).
    ``use_fused_decode`` routes the s == 1 cache read through K6 instead
    of the expand-then-attend reference; off by default, as in the
    reference, and the serving engine sets it per
    ``EngineConfig.use_fused_decode``. ``remat`` recomputes each block in
    backward (the reference's ``DenseModel.remat``); it only acts when a
    graph is built. ``rules`` (:mod:`repro_torch.sharding`) places the
    reference's logical-axis constraints on the activations: with
    ``NO_RULES`` or plain tensors they are no-ops; with DTensor params on
    a mesh each :func:`~repro_torch.sharding.hint` redistributes.
    """

    FAMILY = "dense"
    LOGIT_CHUNK = 512
    # the block carry's logical axes (the reference's sequence-parallel
    # carry; the SSM families keep the sequence local and shard channels)
    CARRY_AXES = ("batch", "tp", None)

    def __init__(self, cfg: ModelConfig, *, attn_chunk: int = 1024,
                 use_fused_decode: bool = False, remat: bool = True,
                 rules: ShardingRules = NO_RULES):
        super().__init__()
        plain = cfg.family == self.FAMILY and cfg.frontend is None
        stub = (self.FAMILY == "dense" and cfg.frontend is not None
                and FRONTENDS.get(cfg.family) == cfg.frontend)
        if not (plain or stub):
            raise ValueError(f"{type(self).__name__} runs the plain "
                             f"{self.FAMILY} family"
                             + (" and the audio/audio_frames and "
                                "vlm/vision_patches pairs"
                                if self.FAMILY == "dense" else "")
                             + f", got {cfg.family}/{cfg.frontend}")
        self.cfg = cfg
        self.attn_chunk = attn_chunk
        self.use_fused_decode = use_fused_decode
        self.remat = remat
        self.rules = rules

    # -- params ------------------------------------------------------------
    def init(self, seed: int = 0, *, device="cuda",
             dtype=torch.float32) -> Params:
        """Random parameters from ``seed`` (a ``torch.Generator`` on the
        target device; not the JAX package's numbers — the tests carry JAX
        weights across with :mod:`repro_torch.bridge`). ``device="meta"``
        gives the shapes and dtypes alone (the dry run's)."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = L.generator(dev).manual_seed(seed)
        params = {
            "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                  dtype=dtype, device=dev),
            "blocks": self._block_params(gen, (cfg.num_layers,), dtype, dev),
            "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(gen, cfg.d_model,
                                             cfg.padded_vocab, dtype=dtype,
                                             device=dev)
        return params

    def _block_params(self, gen, lead, dtype, dev) -> Params:
        kw = dict(lead=lead, dtype=dtype, device=dev)
        return {"attn": L.attn_params(gen, self.cfg, **kw),
                "mlp": L.mlp_params(gen, self.cfg, **kw)}

    def _block(self, p, x, **kw):
        """One block of this family (:func:`block_apply` here)."""
        return block_apply(p, x, self.cfg, self.rules, **kw)

    def param_logical_axes(self):
        """Logical axis names per param (stacked blocks lead with
        layer=None), the reference's."""
        cfg = self.cfg
        ax = {
            "embed": (None, "tp"),          # vocab replicated, d_model TP
            "final_norm": (None,),
            "blocks": {
                "attn": {"wq": (None, "fsdp", "tp"),
                         "wk": (None, "fsdp", "tp"),
                         "wv": (None, "fsdp", "tp"),
                         "wo": (None, "tp", "fsdp"),
                         "norm": (None, None)},
                "mlp": {"wu": (None, "fsdp", "tp"),
                        "wd": (None, "tp", "fsdp"),
                        "norm": (None, None)},
            },
        }
        if cfg.mlp_act == "silu":
            ax["blocks"]["mlp"]["wg"] = (None, "fsdp", "tp")
        if not cfg.tie_embeddings:
            ax["lm_head"] = ("fsdp", "tp")  # vocab TP for chunked loss
        return ax

    def cache_logical_axes(self):
        return {"k": (None, "batch", "seq_kv", None, None),
                "v": (None, "batch", "seq_kv", None, None),
                "pos": ()}

    # -- forward -----------------------------------------------------------
    def embed(self, params: Params, batch: Dict[str, torch.Tensor]):
        """(B, S, d_model) inputs of the first block: token embeddings;
        an audio batch's frames cast to the params' dtype; a vlm batch's
        patches cast to the embedding's dtype, ahead of its tokens'."""
        frontend = self.cfg.frontend
        if frontend == "audio_frames":
            return self._frontend_input(batch).to(params["embed"].dtype)
        h = params["embed"][batch["tokens"].to(torch.int64)]
        if frontend == "vision_patches":
            h = torch.cat([self._frontend_input(batch).to(h.dtype), h], dim=1)
        return hint(h, self.rules, ("batch", None, None))

    def _frontend_input(self, batch) -> torch.Tensor:
        key = FRONTEND_KEYS[self.cfg.frontend]
        if key not in batch:
            raise ValueError(
                f"{self.cfg.name}: the {self.cfg.frontend} frontend is a stub "
                f"that reads precomputed embeddings from batch[{key!r}], and "
                f"this batch has only {sorted(batch)}")
        return batch[key]

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

    def _block_out(self, p, h):
        return hint(self._block(p, h, attn_chunk=self.attn_chunk)[0],
                    self.rules, self.CARRY_AXES)

    def hidden_states(self, params, batch) -> torch.Tensor:
        h = self.embed(params, batch)
        if needs_graph(params):
            for bp in unstack(params["blocks"], self.num_blocks()):
                if self.remat:
                    h = checkpoint(self._block_out, bp, h,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    h = self._block_out(bp, h)
        else:
            for i in range(self.num_blocks()):
                h = self._block_out(self.block_slice(params, i), h)
        return L.rmsnorm(h, params["final_norm"], self.cfg.norm_eps)

    def logits(self, params, batch) -> torch.Tensor:
        return self._mask_pad(L.linear_apply(self._head_w(params),
                                             self.hidden_states(params, batch)))

    # -- loss (chunked xent, full logits never built) -----------------------
    def loss(self, params, batch) -> tuple:
        """Mean token NLL of ``batch["labels"]`` (−1 = padding, ignored;
        a vlm batch's labels cover its text positions) and
        ``{"sum_nll", "tokens"}``, the reference's ``DenseModel.loss``:
        differentiable in ``params`` when its leaves require grad."""
        h = self.hidden_states(params, batch)
        if self.cfg.frontend == "vision_patches" and self.cfg.num_patches:
            h = h[:, self.cfg.num_patches:, :]     # the text positions only
        nll, cnt = chunked_xent(h, self._head_w(params), batch["labels"],
                                chunk=self.LOGIT_CHUNK,
                                vocab=self.cfg.vocab_size, rules=self.rules)
        return (nll / torch.clamp(cnt.to(torch.float32), min=1.0),
                {"sum_nll": nll, "tokens": cnt})

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.float32, *,
                   device="cuda"):
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        dev = resolve_device(device)
        k = hint(torch.zeros(shape, dtype=dtype, device=dev), self.rules,
                 (None, "batch", "seq_kv", None, None))
        return {"k": k, "v": torch.zeros_like(k), "pos": 0}

    def _cached_pass(self, params, h, cache, positions, *,
                     attend_cache: bool = False):
        """Every block against its layer of the cache. Cache storage (dense
        (L, B, T, Hk, D) tensors or :class:`QuantizedKV`) is written in
        place; ``cache["pos"]`` is a host int (uniform batch) or a (B,)
        tensor of per-slot positions (the engine's decode). With
        ``cache["table"]`` (B, n_pages) int32 the storage is the paged
        layout's (L, P, page, Hk, D) pools and every access routes through
        the table, which has no layer dim and goes to every block as it
        is (the returned cache keeps it)."""
        for i in range(self.num_blocks()):
            layer_kv = tuple(_layer(cache[n], i) for n in ("k", "v"))
            h, _ = self._block(self.block_slice(params, i), h,
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

    def prefill_at(self, params, batch, cache, lengths):  # lint: hotpath
        """Prefill right-padded prompts with per-row true ``lengths`` (B,)
        tensor: the same cache fill as :meth:`prefill`, logits gathered at
        each row's last real token. The engine's bucketed prefill."""
        return self._prefill_rows(params, batch, cache, lengths, False)

    def prefill_chunk(self, params, batch, cache, lengths):  # lint: hotpath
        """One fixed-width chunk of a longer prompt against a cache that
        holds the earlier chunks below ``cache["pos"]`` (a host int): the
        chunk's K/V is written at [pos, pos + W) — columns past the cache
        edge dropped — and the queries attend the cache under the offset
        causal mask. Logits at the chunk-local ``lengths - 1`` (meaningful
        on the final chunk only). With ``cache["table"]`` (1, n_pages) the
        chunk writes and reads the page pools through that table row (a
        prefix hit's suffix, or a prompt beyond the largest bucket)."""
        return self._prefill_rows(params, batch, cache, lengths, True)

    def decode_step(self, params, tokens, cache):  # lint: hotpath
        """One decode step. tokens: (B, 1) int. ``cache["pos"]`` is a host
        int (uniform batch) or a per-slot (B,) tensor (engine path); with
        ``cache["table"]`` (B, n_pages) the read is K6p through it."""
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
        out, _ = self._block(self.block_slice(params, i), h, capture=cap)
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


def chunked_xent(h: torch.Tensor, w_head, labels: torch.Tensor, *,
                 chunk: int = 512, vocab: int = 0,
                 rules: ShardingRules = NO_RULES):
    """(Σ NLL, token count) over (B, S) without building (B, S, V) logits,
    in the reference's order: the sequence in chunks of ``chunk``, each
    chunk's NLL summed and added to an f32 running sum. ``labels == -1``
    are padding and ignored; with ``vocab`` the padded head columns get
    −1e30 inside the logsumexp. The head goes through
    :func:`~repro_torch.models.layers.linear_apply` (K4 for a packed head);
    the gold logit is an iota-compare sum, as in the reference. Each
    chunk's logits are vocab-sharded over the TP axis (``rules``)."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    w32 = w_head if isinstance(w_head, QTensor) else w_head.to(torch.float32)
    # a graph is being built: each chunk's logits are recomputed in
    # backward (the reference's @jax.checkpoint body), never kept
    remat = torch.is_grad_enabled() and (
        h.requires_grad or (isinstance(w32, torch.Tensor)
                            and w32.requires_grad))
    nll_acc = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt_acc = torch.zeros((), dtype=torch.int32, device=h.device)
    for i in range(0, h.shape[1], chunk):
        lx = labels[:, i:i + chunk].to(torch.int64)
        hx = h[:, i:i + chunk]
        if remat:
            nll, cnt = checkpoint(_xent_chunk, hx, w32, lx, vocab, rules,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            nll, cnt = _xent_chunk(hx, w32, lx, vocab, rules)
        nll_acc = nll_acc + nll
        cnt_acc = cnt_acc + cnt
    return nll_acc, cnt_acc


def _xent_chunk(hx, w32, lx, vocab: int, rules: ShardingRules = NO_RULES):
    """One chunk's (Σ NLL, valid count)."""
    logits = hint(L.linear_apply(w32, hx.to(torch.float32)), rules,
                  ("batch", None, "tp"))
    iota = torch.arange(logits.shape[-1], device=logits.device)
    if vocab and logits.shape[-1] != vocab:
        logits = logits.masked_fill(iota >= vocab, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.where(iota == torch.clamp(lx, min=0)[..., None],
                       logits, 0.0).sum(dim=-1)
    valid = lx >= 0
    nll = torch.where(valid, lse - gold, 0.0)
    return nll.sum(), valid.sum(dtype=torch.int32)


__all__ = ["DenseModel", "block_apply", "chunked_xent", "tree_map"]
