"""Roofline of one dry-run cell on NVIDIA H100 SXM cards (the port of
``repro/analysis/roofline.py``; no hardware is touched).

Three terms per (arch × shape × mesh), each a per-device count over a
published per-card rate:

    compute    = flops / 989e12 FLOP/s (dense bf16 tensor cores)
    memory     = bytes / 3.35e12 B/s (HBM3)
    collective = collective bytes / 50e9 B/s

The first two are the H100 SXM data sheet's. The collective rate is the
link between hosts: a 16-wide ``"model"`` axis spans two 8-card hosts and
a 256-rank mesh 32, and NVLink (450 GB/s each way) joins only the cards of
one host, so a collective over such an axis runs at the rate of the
card's own network port, one 400 Gb/s NDR InfiniBand link (ConnectX-7) a
card in NVIDIA's DGX H100 data sheet: 50e9 B/s each way.

The counts come from the dry run (:mod:`repro_torch.launch.dryrun`), which
runs the step on meta tensors: flops from ``torch.utils.flop_counter``'s
formulas on every local op, bytes as each local op's input and output
bytes (unfused, so an upper bound), and the collectives the port issued
(:func:`collective_bytes`). There is no compiler analysis to read, so
:func:`from_counts` takes the counts themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Union

PEAK_FLOPS = 989e12          # bf16 dense per card (H100 SXM)
HBM_BW = 3.35e12             # B/s per card (H100 SXM, HBM3)
LINK_BW = 50e9               # B/s per card: one 400 Gb/s NDR link
DEVICE_BYTES = 80e9          # device memory per card (H100 SXM)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# substrings of the torch.distributed / functional-collective op names, by
# kind (``_c10d_functional.all_gather_into_tensor``, ``c10d.allreduce_``,
# ``c10d.alltoall_base_``, DTensor's ``shard_dim_alltoall``, ...)
_NAME_KINDS = (("reduce_scatter", "reduce-scatter"),
               ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
               ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
               ("all_gather", "all-gather"), ("allgather", "all-gather"),
               ("permute", "collective-permute"),
               ("send", "collective-permute"), ("recv", "collective-permute"))


def collective_kind(name: str):
    """The kind of a collective op's name, or None for a name that moves
    no data (``wait_tensor``, ``_wrap_tensor_autograd``)."""
    low = name.lower()
    for key, kind in _NAME_KINDS:
        if key in low:
            return kind
    return None


def _tensor_bytes(out) -> int:
    if isinstance(out, (list, tuple)):
        return sum(_tensor_bytes(o) for o in out)
    if hasattr(out, "element_size") and hasattr(out, "numel"):
        return int(out.numel()) * int(out.element_size())
    return 0                                  # a Work handle, an int, ...


def collective_bytes(records: Iterable) -> Dict[str, int]:
    """Sum the *output* bytes of every collective in ``records``, by kind.

    ``records`` are ``(op_name, output)`` pairs as the dry run records them:
    the op's name and what it returned, a tensor or a (nested) tuple or
    list of them, every element of which counts. The tensors are each
    rank's local ones, so the sum is per-device traffic, the convention of
    the reference's HLO count (per-partition output shapes). Names of no
    kind are skipped."""
    out: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    for name, result in records:
        kind = collective_kind(name)
        if kind is not None:
            out[kind] += _tensor_bytes(result)
    return out


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_per_device: float
    chips: int
    model_flops: float = 0.0      # 6·N·D or 2·N·D (useful-work model)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / total counted FLOPs (remat/redundancy waste)."""
        tot = self.flops_per_device * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def roofline_frac(self) -> float:
        """Useful-model-FLOPs throughput achievable at the bound, as a
        fraction of pure-compute peak: (model_flops/chips/peak) / t_bound."""
        ideal = self.model_flops / self.chips / PEAK_FLOPS
        return ideal / self.t_bound if self.t_bound else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_per_device": self.collective_per_device,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
        }


def from_counts(flops: float, nbytes: float,
                collective: Union[float, Mapping[str, float]], chips: int,
                model_flops: float) -> Roofline:
    """The roofline of per-device counts: ``collective`` is a byte total
    or a dict of bytes by kind (:func:`collective_bytes`), summed."""
    if isinstance(collective, Mapping):
        collective = sum(collective.values())
    return Roofline(flops_per_device=float(flops),
                    bytes_per_device=float(nbytes),
                    collective_per_device=float(collective), chips=chips,
                    model_flops=model_flops)


__all__ = ["COLLECTIVES", "DEVICE_BYTES", "HBM_BW", "LINK_BW", "PEAK_FLOPS",
           "Roofline", "collective_bytes", "collective_kind", "from_counts"]
