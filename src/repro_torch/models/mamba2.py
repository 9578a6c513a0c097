"""Mamba-2 (SSD) blocks and the Zamba2 hybrid model (the port of
``repro/models/mamba2.py``: the ``hybrid`` family, zamba2-1.2b).

SSD's decay is one scalar a head, which makes the selective scan the
chunked matmul algorithm of :func:`_ssd_chunked`: attention-like products
inside each chunk and a recurrence over chunks that carries the
(n_heads, head_dim, N) state. Plain PyTorch, as the reference computes it
in ``jnp`` with no Pallas kernel.

Zamba2 is a stack of Mamba-2 blocks with ONE shared attention + MLP block
(unstacked params ``params["shared"]``) invoked before every group of
``attn_every`` Mamba-2 blocks, in the forward and in the cached pass, each
invocation with its own K/V cache. Its compression protocol is the
reference's: ``num_blocks() = L + 1``, the Mamba-2 blocks then the shared
block once, as block L. ``compress_model`` propagates the calibration
activations through :meth:`Zamba2Model.block_apply_one` alone, so the
shared block never runs between groups there (a fault of the reference,
reproduced so that codes and masks equal JAX's).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import NO_RULES, ShardingRules, hint
from repro_torch.models.mamba import (_causal_conv, cached_block, conv_init,
                                      dt_bias_init, softplus)


def mamba2_params(gen, cfg: ModelConfig, *, lead=(), dtype=torch.float32,
                  device="cpu"):
    """One Mamba-2 block's params with ``lead`` dims in front (torch.Generator
    streams), in the reference's structure: ``A_log`` zeros, ``D`` ones,
    ``dt_bias`` the inverse softplus of a log-uniform draw, one a head."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    lead = tuple(lead)
    kw = dict(lead=lead, dtype=dtype, device=device)

    def const(value, width):
        return torch.full(lead + (width,), value, dtype=dtype, device=device)

    return {
        "norm": const(1.0, d),
        "wz": L.dense_init(gen, d, di, **kw),
        "wx": L.dense_init(gen, d, di, **kw),
        "wbc": L.dense_init(gen, d, 2 * n, **kw),
        "wdt": L.dense_init(gen, d, nh, **kw),
        "dt_bias": dt_bias_init(gen, lead + (nh,), device).to(dtype),
        "conv_w": conv_init(gen, lead + (cfg.ssm_conv, di), device).to(dtype),
        "conv_b": const(0.0, di),
        "A_log": const(0.0, nh),
        "D": const(1.0, nh),
        "out_norm": const(1.0, di),
        "out_proj": L.dense_init(gen, di, d, **kw),
    }


def _ssd_chunked(xh, dtv, a_log, bc, cc, h0, chunk: int):
    """Chunked SSD, with the reference's einsums and padding. xh: (B, L,
    nh, hd); dtv, a_log: (B, L, nh); bc, cc: (B, L, N); h0: (B, nh, hd, N).
    Returns y (B, L, nh, hd) and the last state. Padded tokens have dt 0
    and decay 1, so they leave the state as it is."""
    b, l, nh, hd = xh.shape
    n = bc.shape[-1]
    chunk = min(chunk, l)
    pad = (-l) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dtv, a_log, bc, cc = (F.pad(t, (0, 0, 0, pad))
                              for t in (dtv, a_log, bc, cc))
    nc = xh.shape[1] // chunk
    xg = xh.reshape(b, nc, chunk, nh, hd)
    dg = dtv.reshape(b, nc, chunk, nh)
    ag = a_log.reshape(b, nc, chunk, nh)
    bg = bc.reshape(b, nc, chunk, n)
    cg = cc.reshape(b, nc, chunk, n)

    la = torch.cumsum(ag, dim=2)                       # (B,nc,cl,nh)
    # intra-chunk: decay matrix per head, causal. The reference takes
    # where(causal, exp(seg), 0): above the diagonal seg is a sum of
    # decays (≥ 0), whose exp overflows once a chunk's dt sums past 88,
    # and the gradient there is 0·inf = NaN in every leaf. Masking seg
    # to −inf before the exp gives the same forward bits and gradient
    # wherever the reference's is finite.
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]  # (B,nc,t,s,nh)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xh.device))
    lmat = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                     float("-inf")))
    scores = torch.einsum("bctn,bcsn->bcts", cg, bg)   # (B,nc,t,s)
    m = scores[..., None] * lmat * dg[:, :, None, :, :]
    del seg, lmat
    y_intra = torch.einsum("bctsh,bcshp->bcthp", m, xg)

    # chunk states: S_c = Σ_s exp(la_end − la_s)·dt_s·(x_s ⊗ B_s)
    decay_end = torch.exp(la[:, :, -1:, :] - la)       # (B,nc,cl,nh)
    s_c = torch.einsum("bcsh,bcsn,bcshp->bchpn", decay_end * dg, bg, xg)

    # inter-chunk recurrence over nc, each state emitted before its chunk
    chunk_decay = torch.exp(la[:, :, -1, :])           # (B,nc,nh)
    h, h_prev = h0, []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + s_c[:, c]
    y_inter = torch.einsum("bcth,bctn,bchpn->bcthp", torch.exp(la), cg,
                           torch.stack(h_prev, 1))
    y = (y_intra + y_inter).reshape(b, nc * chunk, nh, hd)
    return y[:, :l], h


def mamba2_logical_axes(cfg: ModelConfig):
    return {"norm": (None, None), "wz": (None, "fsdp", "tp"),
            "wx": (None, "fsdp", "tp"), "wbc": (None, "fsdp", None),
            "wdt": (None, "fsdp", None), "dt_bias": (None, None),
            "conv_w": (None, None, "tp"), "conv_b": (None, "tp"),
            "A_log": (None, None), "D": (None, None),
            "out_norm": (None, "tp"), "out_proj": (None, "tp", "fsdp")}


def mamba2_apply(p, x: torch.Tensor, cfg: ModelConfig,
                 rules: ShardingRules = NO_RULES, *, capture=None,
                 state=None, chunk: int = 128):
    """Full-sequence Mamba-2 block (residual added by the caller), with the
    gated RMSNorm before ``out_proj``. ``state`` as in
    :func:`~repro_torch.models.mamba.mamba_apply` (``ssm`` (B, nh, hd, N));
    ``capture`` receives ``mamba2_in`` (the input of wz and wx) and
    ``mamba2_out_in`` (out_proj's). ``wbc`` and ``wdt`` are plain
    products, not compressed."""
    di, n = cfg.d_inner, cfg.ssm_state
    hd = cfg.ssm_head_dim
    nh = di // hd
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    if capture is not None:
        capture["mamba2_in"] = xn
    z = L.linear_apply(p["wz"], xn)
    xs = L.linear_apply(p["wx"], xn)
    xs = hint(xs, rules, ("batch", None, "tp"))
    bc_all = xn @ p["wbc"]
    bcv, ccv = bc_all[..., :n], bc_all[..., n:]
    dtv = softplus(xn @ p["wdt"] + p["dt_bias"])       # (B,L,nh)
    a_log = dtv * (-torch.exp(p["A_log"].to(torch.float32)))

    if state is not None:
        hist = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)
        new_conv = hist[:, -(cfg.ssm_conv - 1):]
        k = p["conv_w"].shape[0]
        xc = _causal_conv(hist, p["conv_w"], p["conv_b"])[:, k - 1:]
        xc = xc[:, -xs.shape[1]:]
        h0 = state["ssm"]
    else:
        xc = _causal_conv(xs, p["conv_w"], p["conv_b"])
        h0 = torch.zeros((x.shape[0], nh, hd, n), dtype=torch.float32,
                         device=x.device)
    xc = L.mlp_act(xc, "silu")
    xh = xc.reshape(*xc.shape[:2], nh, hd)
    y, h_last = _ssd_chunked(xh, dtv, a_log, bcv, ccv, h0, chunk)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(*x.shape[:2], di)
    y = L.rmsnorm(y * L.mlp_act(z, "silu"), p["out_norm"], cfg.norm_eps)
    if capture is not None:
        capture["mamba2_out_in"] = y
    out = L.linear_apply(p["out_proj"], y).to(x.dtype)
    new_state = None if state is None else {"conv": new_conv, "ssm": h_last}
    return out, new_state


class Zamba2Model(T.DenseModel):
    """Mamba-2 backbone + one shared attention+MLP block (the ``hybrid``
    family: zamba2-1.2b). The forward and the cached pass are its own: the
    dense model's iterate ``num_blocks()``, which is L + 1 here, and would
    run the shared block once at the end instead of before every group."""

    FAMILY = "hybrid"
    scan_chunk = 128
    CARRY_AXES = ("batch", None, "tp")   # d_model-sharded; seq stays local

    def init(self, seed: int = 0, *, device="cuda", dtype=torch.float32):
        """The dense model's init over Mamba-2 blocks, plus the shared
        block's unstacked params from a second stream (``seed + 1``)."""
        params = super().init(seed, device=device, dtype=dtype)
        dev = params["embed"].device
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        kw = dict(dtype=dtype, device=dev)
        params["shared"] = {"attn": L.attn_params(gen, self.cfg, **kw),
                            "mlp": L.mlp_params(gen, self.cfg, **kw)}
        return params

    def param_logical_axes(self):
        dense_ax = T.DenseModel.param_logical_axes(self)
        shared = {k: v[1:] for k, v in
                  dense_ax["blocks"]["attn"].items()}   # unstacked
        shared_mlp = {k: v[1:] for k, v in dense_ax["blocks"]["mlp"].items()}
        ax = {"embed": (None, "tp"), "final_norm": (None,),
              "blocks": mamba2_logical_axes(self.cfg),
              "shared": {"attn": shared, "mlp": shared_mlp}}
        if not self.cfg.tie_embeddings:
            ax["lm_head"] = ("fsdp", "tp")
        return ax

    def cache_logical_axes(self):
        return {"conv": (None, "batch", None, "tp"),
                "ssm": (None, "batch", None, None, None),
                "k": (None, "batch", "seq_kv", None, None),
                "v": (None, "batch", "seq_kv", None, None),
                "pos": ()}

    def _block_params(self, gen, lead, dtype, dev):
        return mamba2_params(gen, self.cfg, lead=lead, dtype=dtype,
                             device=dev)

    def _block(self, p, x, *, capture=None, state=None, **_):
        y, st = mamba2_apply(p, x, self.cfg, self.rules, capture=capture,
                             state=state, chunk=self.scan_chunk)
        return x + y, st

    def _groups(self):
        """(lo, hi) of each group of Mamba-2 blocks; the shared block runs
        before each (at the blocks i with i % attn_every == 0)."""
        cfg = self.cfg
        pos = list(range(0, cfg.num_layers, cfg.attn_every)) \
            + [cfg.num_layers]
        return list(zip(pos[:-1], pos[1:]))

    def hidden_states(self, params, batch) -> torch.Tensor:
        h = self.embed(params, batch)
        positions = self._positions(h, 0)
        graph = T.needs_graph(params)
        remat = self.remat and graph
        # under a graph the stacked leaves are unbound once, as the dense
        # model's are; the shared block is not recomputed (the reference
        # remats the Mamba-2 bodies only)
        blocks = T.unstack(params["blocks"], self.cfg.num_layers) \
            if graph else None
        for lo, hi in self._groups():
            h, _ = T.block_apply(params["shared"], h, self.cfg,
                                 rules=self.rules, positions=positions,
                                 attn_chunk=self.attn_chunk)
            h = hint(h, self.rules, self.CARRY_AXES)
            for i in range(lo, hi):
                bp = blocks[i] if graph else self.block_slice(params, i)
                if remat:
                    h = checkpoint(self._block_out, bp, h,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    h = self._block_out(bp, h)
        return L.rmsnorm(h, params["final_norm"], self.cfg.norm_eps)

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.float32, *,
                   device="cuda"):
        """The recurrent state of every Mamba-2 block (``conv`` (L, B, K−1,
        d_inner) in ``dtype``, ``ssm`` (L, B, nh, hd, N) in f32) and one
        dense K/V of (n_shared, B, max_len, Hk, D) for the shared block's
        invocations, and ``pos``."""
        cfg = self.cfg
        dev = resolve_device(device)
        nh = cfg.d_inner // cfg.ssm_head_dim
        kv = (len(self._groups()), batch, max_len, cfg.num_kv_heads,
              cfg.resolved_head_dim)
        k = hint(torch.zeros(kv, dtype=dtype, device=dev), self.rules,
                 (None, "batch", "seq_kv", None, None))
        return {"conv": torch.zeros((cfg.num_layers, batch, cfg.ssm_conv - 1,
                                     cfg.d_inner), dtype=dtype, device=dev),
                "ssm": torch.zeros((cfg.num_layers, batch, nh,
                                    cfg.ssm_head_dim, cfg.ssm_state),
                                   dtype=torch.float32, device=dev),
                "k": k, "v": torch.zeros_like(k), "pos": 0}

    def _cached_pass(self, params, h, cache, positions, *,
                     attend_cache: bool = False):
        """The shared block against its invocation's K/V, then the group's
        Mamba-2 blocks against their states; all written in place."""
        for gi, (lo, hi) in enumerate(self._groups()):
            h, _ = T.block_apply(params["shared"], h, self.cfg,
                                 positions=positions,
                                 kv_cache=(cache["k"][gi], cache["v"][gi]),
                                 cache_pos=cache["pos"],
                                 attn_chunk=self.attn_chunk)
            for i in range(lo, hi):
                h = cached_block(self._block, self.block_slice(params, i), h,
                                 cache["conv"][i], cache["ssm"][i])
        return h, dict(cache, pos=cache["pos"] + positions.shape[1])

    # -- compression protocol: mamba blocks + the shared block (id = L) -----
    def num_blocks(self) -> int:
        return self.cfg.num_layers + 1     # + shared block (compressed once)

    def block_apply_one(self, params, i: int, h, *, capture=False):
        if i < self.cfg.num_layers:
            return super().block_apply_one(params, i, h, capture=capture)
        cap = {} if capture else None
        out, _ = T.block_apply(params["shared"], h, self.cfg,
                               positions=self._positions(h, 0), capture=cap)
        return out, (cap or {})

    def block_linears(self, i: int):
        if i < self.cfg.num_layers:
            return [("wz", ("blocks", "wz"), "mamba2_in"),
                    ("wx", ("blocks", "wx"), "mamba2_in"),
                    ("out_proj", ("blocks", "out_proj"), "mamba2_out_in")]
        return [(name, ("shared",) + path[1:], key)
                for name, path, key in super().block_linears(i)]


__all__ = ["Zamba2Model", "mamba2_apply", "mamba2_logical_axes",
           "mamba2_params"]
