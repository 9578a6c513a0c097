"""Mamba-1 selective SSM (the port of ``repro/models/mamba.py``: the ``ssm``
family, falcon-mamba-7b).

Prefill, calibration and the full forward run the chunked selective scan
(:func:`_mamba_scan_y`): the sequence in chunks of ``scan_chunk`` tokens
with the (B, d_inner, N) state carried across chunks; within a chunk the
recurrence inputs a and bu are built for the chunk alone, the state is
advanced token by token (the reference runs an associative scan there: the
same recurrence in another order of f32 operations) and contracted with C
once a chunk, so only (B, chunk, d_inner, N) tensors are ever resident and
no (chunk × chunk) matrix is built. Decode is the same scan over one token
against the recurrent state cache. The scans are plain PyTorch: the
reference computes them in ``jnp``, with no Pallas kernel. ``in_proj`` and
``out_proj`` go through :func:`~repro_torch.models.layers.linear_apply`
(K4 when packed); ``x_proj`` and ``dt_proj`` are plain products and are
not compressed, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(−|x|)).
    ``torch.nn.functional.softplus`` returns x itself above its threshold
    of 20, which is not the reference's value there."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def dt_bias_init(gen, shape, device) -> torch.Tensor:
    """Inverse softplus of a log-uniform draw in [1e-3, 1e-1] (mamba's
    init: softplus(dt_bias) spans that range)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return dt0 + torch.log(-torch.expm1(-dt0))


def conv_init(gen, shape, device) -> torch.Tensor:
    """Depthwise conv weights (…, K, d_inner): normal / √K."""
    k = shape[-2]
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) / math.sqrt(k)


def mamba_params(gen, cfg: ModelConfig, *, lead=(), dtype=torch.float32,
                 device="cpu"):
    """One Mamba-1 block's params with ``lead`` dims in front (torch.Generator
    streams; not the JAX package's numbers), in the reference's structure:
    ``A_log = log(1..N)`` over d_inner, ``D`` ones, ``dt_bias`` the inverse
    softplus of a log-uniform draw (a plain normal A_log makes the
    recurrence blow up)."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dt_rank = max(1, math.ceil(d / 16))
    lead = tuple(lead)
    kw = dict(lead=lead, dtype=dtype, device=device)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device)).expand(lead + (di, n))
    return {
        "norm": torch.ones(lead + (d,), dtype=dtype, device=device),
        "in_proj": L.dense_init(gen, d, 2 * di, **kw),
        "conv_w": conv_init(gen, lead + (cfg.ssm_conv, di), device).to(dtype),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=device),
        "x_proj": L.dense_init(gen, di, dt_rank + 2 * n, **kw),
        "dt_proj": L.dense_init(gen, dt_rank, di, **kw),
        "dt_bias": dt_bias_init(gen, lead + (di,), device).to(dtype),
        "A_log": a_log.to(dtype).contiguous(),
        "D": torch.ones(lead + (di,), dtype=dtype, device=device),
        "out_proj": L.dense_init(gen, di, d, **kw),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds, in the reference's order.
    x: (B, L, di); w: (K, di)."""
    k = w.shape[0]
    y = x * w[-1]
    for j in range(1, k):
        y = y + F.pad(x, (0, 0, j, 0))[:, :-j] * w[k - 1 - j]
    return y + b


def _ssm_coeffs(p, xc: torch.Tensor, cfg: ModelConfig):
    """xc: (B, L, di) post-conv. Returns a, bu (B, L, di, N) f32 and C
    (B, L, N): the recurrence h_t = a_t·h_{t−1} + bu_t, y_t = h_t·C_t."""
    n = cfg.ssm_state
    dt_rank = p["dt_proj"].shape[0]
    x_dbl = xc @ p["x_proj"]                          # (B, L, R+2N)
    dt = softplus(x_dbl[..., :dt_rank] @ p["dt_proj"] + p["dt_bias"])
    bc = x_dbl[..., dt_rank:dt_rank + n]              # (B, L, N)
    cc = x_dbl[..., dt_rank + n:]                     # (B, L, N)
    a_mat = -torch.exp(p["A_log"].to(torch.float32))  # (di, N)
    dt = dt.to(torch.float32)                         # f32 recurrence state
    a = torch.exp(dt[..., None] * a_mat)              # (B, L, di, N)
    bu = ((dt * xc.to(torch.float32))[..., None]
          * bc.to(torch.float32)[:, :, None, :])      # (B, L, di, N)
    return a, bu, cc


def _scan_chunk(p, x_i: torch.Tensor, h: torch.Tensor, cfg: ModelConfig):
    """One chunk of the scan: its coefficients, the state advanced token
    by token from h, and the trajectory contracted with C. x_i: (B,
    chunk, di) → y_i (B, chunk, di) f32 and the chunk's last state."""
    a, bu, cc = _ssm_coeffs(p, x_i, cfg)
    hs = []
    for t in range(x_i.shape[1]):
        h = torch.addcmul(bu[:, t], a[:, t], h)
        hs.append(h)
    del a, bu
    return torch.einsum("bldn,bln->bld", torch.stack(hs, 1),
                        cc.to(torch.float32)), h


def _mamba_scan_y(p, xc: torch.Tensor, cfg: ModelConfig, h0: torch.Tensor,
                  chunk: int):
    """The selective scan, chunk by chunk. xc: (B, L, di) post-conv; h0:
    (B, di, N) f32. Returns y (B, L, di) f32 and the last state.

    When a graph is being built each chunk runs under
    ``torch.utils.checkpoint`` (the reference's ``@jax.checkpoint`` on the
    scan body): backward keeps the carried h and the chunk's input, and
    recomputes a, bu and the state trajectory, three (B, chunk, d_inner,
    N) f32 tensors (537 MB each at falcon-mamba-7b's width and a 16 × 64
    batch), one chunk at a time.

    As in the reference the last chunk is zero-padded to a whole chunk,
    and the padded tokens still advance the state: their dt is
    softplus(dt_bias) > 0, so they decay it (a < 1) and add nothing. The
    returned state is the padded chunk's last, which equals the true one
    only when L is a multiple of the chunk (a fault of the reference,
    reproduced so that the cached paths agree with it)."""
    b, l, di = xc.shape
    chunk = min(chunk, l)
    pad = (-l) % chunk
    if pad:
        xc = F.pad(xc, (0, 0, 0, pad))
    remat = T.needs_graph(p) or (torch.is_grad_enabled()
                                 and xc.requires_grad)
    h, ys = h0, []
    for c0 in range(0, xc.shape[1], chunk):
        x_i = xc[:, c0:c0 + chunk]
        if remat:
            y_i, h = checkpoint(_scan_chunk, p, x_i, h, cfg,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            y_i, h = _scan_chunk(p, x_i, h, cfg)
        ys.append(y_i)
    return torch.cat(ys, 1)[:, :l], h


def mamba_apply(p, x: torch.Tensor, cfg: ModelConfig, *, capture=None,
                state=None, chunk: int = 256):
    """Full-sequence Mamba-1 block (residual added by the caller).

    ``state``: None for the forward; ``{"conv": (B, K−1, di), "ssm":
    (B, di, N)}`` for the cached paths, which then also return the new
    state (fresh tensors, never views of ``state``). ``capture`` receives
    ``mamba_in`` (in_proj's input) and ``mamba_out_in`` (out_proj's)."""
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    if capture is not None:
        capture["mamba_in"] = xn
    xz = L.linear_apply(p["in_proj"], xn)
    xs, z = torch.chunk(xz, 2, dim=-1)                # (B, L, di) each
    if state is not None:
        hist = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)
        new_conv = hist[:, -(cfg.ssm_conv - 1):]
        k = p["conv_w"].shape[0]
        xc = _causal_conv(hist, p["conv_w"], p["conv_b"])[:, k - 1:]
        xc = L.mlp_act(xc[:, -xs.shape[1]:], "silu")
        y_ssm, h_last = _mamba_scan_y(p, xc, cfg, state["ssm"], chunk)
        new_state = {"conv": new_conv, "ssm": h_last}
    else:
        xc = L.mlp_act(_causal_conv(xs, p["conv_w"], p["conv_b"]), "silu")
        h0 = torch.zeros((x.shape[0], cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=x.device)
        y_ssm, _ = _mamba_scan_y(p, xc, cfg, h0, chunk)
        new_state = None
    y = y_ssm.to(xc.dtype) + p["D"] * xc
    y = y * L.mlp_act(z, "silu")
    if capture is not None:
        capture["mamba_out_in"] = y
    out = L.linear_apply(p["out_proj"], y).to(x.dtype)
    return out, new_state


def cached_block(block, p, h: torch.Tensor, conv: torch.Tensor,
                 ssm: torch.Tensor) -> torch.Tensor:
    """``block`` (a recurrent model's ``_block``) with params ``p`` on h
    against one layer's recurrent state, whose ``conv`` and ``ssm`` storage
    is overwritten in place with the new state."""
    h, st = block(p, h, state={"conv": conv, "ssm": ssm})
    conv.copy_(st["conv"])
    ssm.copy_(st["ssm"])
    return h


class MambaModel(T.DenseModel):
    """Attention-free Mamba-1 LM (the ``ssm`` family: falcon-mamba-7b).
    The forward, the loss, prefill and decode are the dense model's over
    Mamba blocks; the serving cache is the recurrent state: per layer the
    last K−1 conv inputs and the (d_inner, N) SSM state."""

    FAMILY = "ssm"
    scan_chunk = 256

    def _block_params(self, gen, lead, dtype, dev):
        return mamba_params(gen, self.cfg, lead=lead, dtype=dtype, device=dev)

    def _block(self, p, x, *, capture=None, state=None, **_):
        y, st = mamba_apply(p, x, self.cfg, capture=capture, state=state,
                            chunk=self.scan_chunk)
        return x + y, st

    # -- serving: recurrent state cache -------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.float32, *,
                   device="cuda"):
        """``conv`` (L, B, K−1, d_inner) in ``dtype``, ``ssm`` (L, B,
        d_inner, N) in f32 and ``pos``; ``max_len`` sizes nothing (the
        state does not grow)."""
        cfg = self.cfg
        dev = resolve_device(device)
        return {"conv": torch.zeros((cfg.num_layers, batch, cfg.ssm_conv - 1,
                                     cfg.d_inner), dtype=dtype, device=dev),
                "ssm": torch.zeros((cfg.num_layers, batch, cfg.d_inner,
                                    cfg.ssm_state), dtype=torch.float32,
                                   device=dev),
                "pos": 0}

    def _cached_pass(self, params, h, cache, positions, *,
                     attend_cache: bool = False):
        """Every block against its layer of the state cache, written in
        place."""
        for i in range(self.cfg.num_layers):
            h = cached_block(self._block, self.block_slice(params, i), h,
                             cache["conv"][i], cache["ssm"][i])
        return h, dict(cache, pos=cache["pos"] + positions.shape[1])

    # -- compression protocol ------------------------------------------------
    def block_linears(self, i: int):
        return [("in_proj", ("blocks", "in_proj"), "mamba_in"),
                ("out_proj", ("blocks", "out_proj"), "mamba_out_in")]


__all__ = ["MambaModel", "cached_block", "mamba_apply", "mamba_params",
           "softplus"]
