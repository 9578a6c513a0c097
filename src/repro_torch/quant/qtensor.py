"""Packed quantized-weight storage — the serving payoff of compression.

``QTensor`` stores quantized weights as packed integers (int4 → two nibbles
per uint8, low nibble = even index; other widths ≤ 8 bits as uint8 codes)
plus per-(row, group) scale and zero, byte-for-byte the layout of
``repro/quant/qtensor.py``. Stacked per-block leaves carry leading dims on
their tensors while ``shape`` stays the per-layer logical ``(d_out, d_in)``;
:meth:`QTensor.map` slices them.

The matmul switch is the port's one kernel-vs-plain switch
(:mod:`repro_torch.kernels`), under the JAX package's names
:func:`matmul_impl` and :func:`set_matmul_impl`: ``"auto"`` runs the fused
kernel K4 on a CUDA tensor and the reference dequant-matmul on a CPU
tensor; ``"kernel"`` always goes through the K4 wrapper (its plain version
on the CPU); ``"reference"`` always dequantizes then multiplies.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import projections as proj
from repro_torch.kernels import impl, resolved_impl, ref
from repro_torch.kernels import set_impl as set_matmul_impl
from repro_torch.kernels import use_impl as matmul_impl
from repro_torch.kernels.ref import unpack_int4


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(…, n) int codes in [0, 15] → (…, n/2) uint8, low nibble first."""
    if q.shape[-1] % 2:
        raise ValueError("pack_int4 needs an even last dim")
    q = q.to(torch.uint8)
    return q[..., 0::2] | (q[..., 1::2] << 4)


class QTensor(NamedTuple):
    """Quantized (d_out, d_in) weight, paper orientation."""
    packed: torch.Tensor   # (d_out, d_in/2) uint8 for bits=4; else codes
    scale: torch.Tensor    # (d_out, n_groups) f32
    zero: torch.Tensor     # (d_out, n_groups) f32
    bits: int
    group_size: int
    shape: Tuple[int, int]              # logical (d_out, d_in)
    col_scale: Optional[torch.Tensor] = None   # (d_in,) f32 — AWQ-style s

    @staticmethod
    def from_codes(codes: torch.Tensor, scale: torch.Tensor,
                   zero: torch.Tensor, bits: int, group_size: int,
                   col_scale: Optional[torch.Tensor] = None) -> "QTensor":
        """Pack integer codes (d_out, d_in) with their scale and zero."""
        shape = tuple(codes.shape)
        if bits == 4 and shape[1] % 2 == 0:
            packed = pack_int4(codes)
        elif bits <= 8:
            packed = codes.to(torch.uint8)
        else:
            packed = codes.to(torch.int32)
        return QTensor(packed=packed, scale=scale, zero=zero, bits=bits,
                       group_size=group_size, shape=shape,
                       col_scale=col_scale)

    @staticmethod
    def from_dense(w: torch.Tensor, bits: int = 4, group_size: int = 128,
                   col_scale: Optional[torch.Tensor] = None) -> "QTensor":
        """Quantize ``w`` (or ``w·diag(col_scale)``) onto the per-(row,
        group) min/max grid and pack the codes."""
        ws = w if col_scale is None else w * col_scale[None, :]
        qp = proj.quant_params(ws, bits, group_size)
        codes = qp.q.reshape(w.shape[0], -1)
        return QTensor.from_codes(codes, qp.scale[..., 0], qp.zero[..., 0],
                                  bits, group_size, col_scale=col_scale)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "QTensor":
        """Apply ``fn`` to every tensor field (slicing a stacked leaf,
        moving devices); the static metadata is kept."""
        return self._replace(
            packed=fn(self.packed), scale=fn(self.scale), zero=fn(self.zero),
            col_scale=None if self.col_scale is None else fn(self.col_scale))

    def _nibble_packed(self) -> bool:
        return self.bits == 4 and self.packed.shape[-1] * 2 == self.shape[1]

    def codes(self) -> torch.Tensor:
        """Unpacked integer codes, (d_out, d_in)."""
        return unpack_int4(self.packed) if self._nibble_packed() else self.packed

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        deq = ref.dequant(self.codes(), self.scale, self.zero,
                          self.group_size)
        if self.col_scale is not None:
            deq = deq / self.col_scale[None, :]
        return deq.to(dtype)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """x @ Wᵀ with a materialized dequant (the reference)."""
        return x @ self.dequant(x.dtype).T

    def kernel_matmul(self, x: torch.Tensor) -> torch.Tensor:
        """x @ Wᵀ through K4 for nibble-packed int4; a ``col_scale`` layer
        runs on pre-scaled activations (x / s), since dequant divides by s
        per input column. Other widths take the reference ``matmul``."""
        if not self._nibble_packed():
            return self.matmul(x)
        if self.col_scale is not None:
            x = (x / self.col_scale).to(x.dtype)
        return impl("dequant_matmul")(x.contiguous(), self.packed,
                                      self.scale, self.zero, self.group_size)

    def matmul_dispatch(self, x: torch.Tensor) -> torch.Tensor:
        """x @ Wᵀ on the active implementation (see :func:`matmul_impl`)."""
        if resolved_impl(x.device) == "reference":
            return self.matmul(x)
        return self.kernel_matmul(x)

    def nbytes(self) -> int:
        n = self.packed.numel() * self.packed.element_size()
        n += self.scale.numel() * 4 + self.zero.numel() * 4
        if self.col_scale is not None:
            n += self.col_scale.numel() * 4
        return n


__all__ = ["QTensor", "matmul_impl", "pack_int4", "resolved_impl",
           "set_matmul_impl", "unpack_int4"]
