"""Round-To-Nearest group quantization — the activation-blind quant baseline
and AWP's quantization initializer (§4.2)."""
from __future__ import annotations

import torch

from repro_torch.core import registry
from repro_torch.core.specs import QuantSpec
from repro_torch.kernels import impl


def quantize_weight(w: torch.Tensor, bits: int,
                    group_size: int = 128) -> torch.Tensor:
    """Group-wise asymmetric min/max quantize-dequantize of W itself (K3 on
    the card)."""
    return impl("quant_project")(w, bits, group_size)


@registry.register("rtn", spec_cls=QuantSpec)
def _compress(w, stats, spec):
    from repro_torch.quant import QTensor
    g = spec.group_for(w.shape[1])
    # from_dense(w) computes the same min/max grid as quantize_weight, so
    # qt.dequant() is the RTN weight: the codes are the source of truth
    qt = QTensor.from_dense(w, spec.bits, g)
    return registry.CompressResult(theta=qt.dequant(), qtensor=qt)


__all__ = ["quantize_weight"]
