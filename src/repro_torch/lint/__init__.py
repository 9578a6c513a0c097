"""repro_torch.lint — PyTorch/CUDA-aware static analysis of the port (the
twin of ``repro.lint``, which scans ``src/repro``).

Seven rules over ``src/repro_torch`` (host-sync, rebuild-hazard,
graph-leak, kernel-abi, dtype-drift, register-contract,
metrics-contract), a content-fingerprinted baseline, and ``python -m
repro_torch.lint`` as the CLI. The README's "Static analysis" section has
the catalog and the workflow. Only the standard library: the analyzer
touches no device.
"""
from .core import (Finding, LintConfig, available, load_baseline,
                   partition, register, run_lint, save_baseline)

__all__ = ["Finding", "LintConfig", "available", "load_baseline",
           "partition", "register", "run_lint", "save_baseline"]
