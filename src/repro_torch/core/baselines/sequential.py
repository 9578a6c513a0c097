"""Sequential prune→quant / quant→prune pipelines — Table 4/5 baselines.

Wanda+AWQ  = prune first with Wanda, then AWQ-quantize the pruned weight and
             re-apply the sparsity mask (quantization can perturb zeros).
AWQ+Wanda  = quantize first with AWQ, then Wanda-prune the quantized weight.
"""
from __future__ import annotations

import torch

from repro_torch.core import calibration as calib, registry
from repro_torch.core.baselines import awq, wanda
from repro_torch.core.specs import JointSpec


def wanda_then_awq(w, c, act_mean_abs, k: int, bits: int = 4,
                   group_size: int = 128):
    pruned = wanda.prune_weight(w, c, k)
    q = awq.quantize_weight(pruned, c, act_mean_abs, bits, group_size)
    return torch.where(pruned != 0, q, torch.zeros_like(q))


def awq_then_wanda(w, c, act_mean_abs, k: int, bits: int = 4,
                   group_size: int = 128):
    q = awq.quantize_weight(w, c, act_mean_abs, bits, group_size)
    return wanda.prune_weight(q, c, k)


def _adapter(pipeline):
    def _compress(w, stats, spec):
        c = calib.covariance(stats, damp=spec.damp)
        theta = pipeline(w, c, calib.act_mean_abs(stats),
                         spec.k_for(w.shape[1]), spec.bits,
                         spec.group_for(w.shape[1]))
        # AWQ's per-channel scale is folded into theta, so a plain-grid
        # repack would undo it: these baselines stay dense (mask only)
        return registry.CompressResult(theta=theta, mask=theta != 0,
                                       aux={"covariance": c})
    return _compress


registry.register("wanda_awq", spec_cls=JointSpec)(_adapter(wanda_then_awq))
registry.register("awq_wanda", spec_cls=JointSpec)(_adapter(awq_then_wanda))


__all__ = ["wanda_then_awq", "awq_then_wanda"]
