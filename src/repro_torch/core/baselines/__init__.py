"""Baseline compression methods. The port has Wanda, AWP's pruning
initializer; magnitude, RTN and AWQ are not ported yet."""
from repro_torch.core.baselines import wanda  # noqa: F401  (registers wanda)
