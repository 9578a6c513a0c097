"""Baselines the paper compares against (Tables 1-5):

- magnitude  — activation-blind row-wise magnitude pruning (Eq. 1)
- wanda      — |W|·‖X‖₂ scoring (Sun et al. 2023); also AWP's pruning init
- sparsegpt  — OBS-based one-shot pruning (Frantar & Alistarh 2023)
- rtn        — round-to-nearest group quantization; AWP's quant init
- awq        — activation-aware scale search (Lin et al. 2024)
- gptq       — OBS-based quantization with error propagation (Frantar 2022)
- sequential — Wanda+AWQ and AWQ+Wanda pipelines (Table 4/5 baselines)
"""
from repro_torch.core.baselines import (awq, gptq, magnitude, rtn,  # noqa: F401
                                        sequential, sparsegpt, wanda)
