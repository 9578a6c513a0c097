"""Wrappers of the hand-written kernels K1–K6 (``csrc/*.cu``).

Every wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on ``torch.cuda.current_stream()``
and raises if the launch reports an error. A tensor on the CPU takes the
plain version in :mod:`repro_torch.kernels.ref` (that is the only reason
the plain version runs); a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches per wrapper, so a run can show that its
main path went through the kernels; a batched (3-D) call of
:func:`awp_pgd_step` is K1b and counts under ``awp_pgd_step_batched``.

TF32 is switched off for the whole port at import: the PGD stop rule sits
at tol 1e-4 on ‖∇f‖/‖W‖ (``repro/core/awp.py:46``) and TF32's 10-bit
mantissa would move iteration counts and pruning masks, so every f32
product stays IEEE f32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KERNELS = ("awp_pgd_step", "topk_row", "quant_project", "dequant_matmul",
           "kv_dequant", "decode_attn")
# launches per kernel: K1b (a 3-D awp_pgd_step) has its own count
LAUNCHES = dict.fromkeys(("awp_pgd_step", "awp_pgd_step_batched")
                         + KERNELS[1:], 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or
    on any other device."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"{name}: operands on {sorted(str(t.device) for t in tensors)}"
                     f" — need all on the CPU or all on one CUDA device")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous")


def _launch(name: str, fn, *args) -> None:
    from repro_torch.kernels import _build
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn)(*args, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
    LAUNCHES[name] += 1


def awp_pgd_step(w, theta, c, eta):
    """K1: Z = Θ + η (W − Θ) C, and ‖(W − Θ) C‖_F summed from the kernel's
    per-tile f32 partials.

    (M, K) operands with a scalar η (K1), or batched (B, M, K) / (B, K, K)
    with η of shape (B,) or scalar and a norm per item (K1b: the same
    kernel over a batch grid dimension). η is a tensor on the operands'
    device, read by the kernel from device memory (no host sync)."""
    eta = torch.as_tensor(eta, dtype=torch.float32, device=w.device)
    if not _on_card("awp_pgd_step", w, theta, c, eta):
        return ref.awp_pgd_step(w, theta, c, eta)
    batched = w.dim() == 3
    if not batched and w.dim() != 2:
        raise ValueError(f"awp_pgd_step: w must be 2-D or 3-D, got {w.dim()}")
    b = w.shape[0] if batched else 1
    m, k = w.shape[-2:]
    _check("awp_pgd_step.w", w, torch.float32, w.shape)
    _check("awp_pgd_step.theta", theta, torch.float32, w.shape)
    _check("awp_pgd_step.c", c, torch.float32,
           (b, k, k) if batched else (k, k))
    if eta.numel() not in (1, b):
        raise ValueError(f"awp_pgd_step: eta must be scalar or ({b},)")
    eta_b = eta.reshape(-1).expand(b).contiguous()
    from repro_torch.kernels import _build
    lib = _build.library()
    bm, bn = lib.awp_pgd_tile_m(), lib.awp_pgd_tile_n()
    z = torch.empty_like(w)
    partials = torch.empty((b, -(-m // bm), -(-k // bn)),
                           dtype=torch.float32, device=w.device)
    _launch("awp_pgd_step_batched" if batched else "awp_pgd_step",
            "awp_pgd_step_f32", w.data_ptr(),
            theta.data_ptr(), c.data_ptr(), eta_b.data_ptr(), z.data_ptr(),
            partials.data_ptr(), b, m, k)
    norm = torch.sqrt(partials.sum(dim=(-2, -1)))
    return z, (norm if batched else norm[0])


def _rows(name: str, z):
    """(rows, d) of ``z`` (…, d): leading dims are rows. A non-contiguous
    ``z`` raises rather than being copied."""
    if z.dim() < 2:
        raise ValueError(f"{name}: z must have 2 or more dims, got {z.dim()}")
    _check(f"{name}.z", z, torch.float32, z.shape)
    return z.numel() // z.shape[-1], z.shape[-1]


def topk_row(z, k: int):
    """K2: keep the k largest |z| of each row (exactly k, lower index wins
    ties), zero the rest. z: (…, d) f32, contiguous; leading dims are rows
    (a (B, M, d) stack runs as B·M rows in one launch)."""
    if not _on_card("topk_row", z):
        return ref.topk_row(z, k)
    rows, d = _rows("topk_row", z)
    if k >= d:
        return z
    if k <= 0:
        return torch.zeros_like(z)
    out = torch.empty_like(z)
    _launch("topk_row", "topk_row_f32", z.data_ptr(), out.data_ptr(), rows,
            d, k)
    return out


def quant_project(z, bits: int, group_size: int = 128):
    """K3: group-wise asymmetric INT-``bits`` quantize-dequantize of z
    (…, d) f32, contiguous, with groups of ``group_size`` along d; leading
    dims are rows."""
    if not _on_card("quant_project", z):
        return ref.quant_project(z, bits, group_size)
    rows, d = _rows("quant_project", z)
    if d % group_size or not 1 <= bits <= 16:
        raise ValueError(f"quant_project: d={d}, group={group_size}, "
                         f"bits={bits} not supported")
    out = torch.empty_like(z)
    _launch("quant_project", "quant_project_f32", z.data_ptr(),
            out.data_ptr(), rows, d, group_size, bits)
    return out


def dequant_matmul(x, packed, scale, zero, group_size: int = 128):
    """K4: y (M, N) = x (M, K) · dequant(W)ᵀ for nibble-packed W (N, K/2)
    uint8 (low nibble = even k) with scale, zero (N, K/group) f32."""
    if not _on_card("dequant_matmul", x, packed, scale, zero):
        return ref.dequant_matmul(x, packed, scale, zero, group_size)
    if x.dim() != 2 or packed.dim() != 2:
        raise ValueError("dequant_matmul: x and packed must be 2-D")
    m, k = x.shape
    n = packed.shape[0]
    if k % 2 or k % group_size:
        raise ValueError(f"dequant_matmul: K={k} must be even and a multiple "
                         f"of group {group_size}")
    _check("dequant_matmul.x", x, torch.float32, (m, k))
    _check("dequant_matmul.packed", packed, torch.uint8, (n, k // 2))
    _check("dequant_matmul.scale", scale, torch.float32, (n, k // group_size))
    _check("dequant_matmul.zero", zero, torch.float32, (n, k // group_size))
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _launch("dequant_matmul", "dequant_matmul_f32", x.data_ptr(),
            packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
            y.data_ptr(), m, n, k, group_size)
    return y


def kv_dequant(codes, scale, zero, group_size: int):
    """K5: (R, K) uint8 codes + per-group (R, K/g) f16 scale and zero →
    (R, K) f32 ``(code − zero)·scale``, bit-exact with its plain version."""
    if not _on_card("kv_dequant", codes, scale, zero):
        return ref.kv_dequant(codes, scale, zero, group_size)
    if codes.dim() != 2:
        raise ValueError(f"kv_dequant: codes must be 2-D, got {codes.dim()}")
    r, k = codes.shape
    if group_size <= 0 or k % group_size or group_size % 4:
        raise ValueError(f"kv_dequant: K={k}, group={group_size}: need a "
                         f"group that divides K and is a multiple of 4")
    _check("kv_dequant.codes", codes, torch.uint8, (r, k))
    _check("kv_dequant.scale", scale, torch.float16, (r, k // group_size))
    _check("kv_dequant.zero", zero, torch.float16, (r, k // group_size))
    if codes.data_ptr() % 4:
        raise ValueError("kv_dequant: codes must be 4-byte aligned")
    out = torch.empty((r, k), dtype=torch.float32, device=codes.device)
    if out.numel():
        _launch("kv_dequant", "kv_dequant_u8", codes.data_ptr(),
                scale.data_ptr(), zero.data_ptr(), out.data_ptr(), r, k,
                group_size)
    return out


_KV_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def decode_attn(q, k, v, lengths, k_scale=None, k_zero=None, v_scale=None,
                v_zero=None, group_size: int = 0, block_t: int = 256):
    """K6: one-token GQA decode attention over a slot cache. q (B, H, D)
    f32; k/v (B, T, Hk, D) f32 or bf16, or uint8 codes with (B, T, Hk, D/g)
    f16 ``*_scale``/``*_zero`` planes (dequantized in the tile); lengths
    (B,) int32 on the device — row b attends [0, lengths[b]), clamped to
    T. Online softmax over tiles of ``block_t`` tokens. A row of length 0
    gives exact zeros; a NaN row propagates. Returns (B, H, D) f32."""
    quant = k_scale is not None
    planes = (k_scale, k_zero, v_scale, v_zero) if quant else ()
    if not _on_card("decode_attn", q, k, v, lengths, *planes):
        return ref.decode_attn(q, k, v, lengths, k_scale, k_zero, v_scale,
                               v_zero, group_size, block_t)
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("decode_attn: q must be (B, H, D), k/v (B, T, Hk, D)")
    b, h, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hk:
        raise ValueError(f"decode_attn: q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)}")
    g = h // hk
    bt = max(1, min(block_t, t))
    if d % 4 or g > 32 or g * d > 1024:
        raise ValueError(f"decode_attn: D={d}, {g} query heads per KV head "
                         f"not supported (D % 4 == 0, g <= 32, g*D <= 1024)")
    _check("decode_attn.q", q, torch.float32, (b, h, d))
    _check("decode_attn.lengths", lengths, torch.int32, (b,))
    kind = _KV_KINDS.get(k.dtype)
    if kind is None or (kind == 2) != quant:
        raise TypeError(f"decode_attn: k/v {k.dtype} "
                        f"{'with' if quant else 'without'} scale planes")
    _check("decode_attn.k", k, k.dtype, (b, t, hk, d))
    _check("decode_attn.v", v, k.dtype, (b, t, hk, d))
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attn: k/v must be 16-byte aligned")
    ptrs = [0] * 4
    if quant:
        if group_size <= 0 or d % group_size or group_size % 4:
            raise ValueError(f"decode_attn: group {group_size} for D={d}")
        for i, (name, pl) in enumerate(zip(
                ("k_scale", "k_zero", "v_scale", "v_zero"), planes)):
            _check(f"decode_attn.{name}", pl, torch.float16,
                   (b, t, hk, d // group_size))
            ptrs[i] = pl.data_ptr()
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    _launch("decode_attn", "decode_attn", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), lengths.data_ptr(), *ptrs, out.data_ptr(), b, t, h,
            hk, d, group_size if quant else 0, bt, kind)
    return out


__all__ = ["KERNELS", "LAUNCHES", "awp_pgd_step", "decode_attn",
           "dequant_matmul", "kv_dequant", "quant_project", "reset_launches",
           "topk_row"]
