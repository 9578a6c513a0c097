"""Baseline compression methods: Wanda (also AWP's pruning initializer)
and magnitude pruning. RTN, AWQ, SparseGPT and GPTQ are not ported yet."""
from repro_torch.core.baselines import magnitude, wanda  # noqa: F401  (register)
