"""Deterministic, sharded, resumable data pipeline (the port's numpy-only
copy of ``repro/data/pipeline.py``: same tokens for the same config and
seed).

Synthetic Zipf–Markov language corpus: next-token depends on the previous
token (Markov) with Zipfian innovations, so a small LM trained on it learns
non-trivial structure and its activations develop the correlated /
outlier-channel statistics that activation-aware compression methods exploit
(the paper's regime, reproduced without external datasets).

Determinism/fault tolerance: batch(step, shard) is a pure function of
(seed, step, shard) — restarting from a checkpointed step reproduces the
exact stream on any number of shards; no iterator state to persist.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3          # Zipf exponent for innovations
    markov_p: float = 0.75       # prob of Markov continuation vs innovation


class ZipfMarkov:
    """token_{t+1} = (a·token_t + b) mod V   w.p. markov_p   (deterministic map)
                   = Zipf(V)                 otherwise."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        v = cfg.vocab_size
        # fixed affine permutation of the vocab (odd multiplier → bijective)
        rng = np.random.default_rng(cfg.seed)
        self._a = int(rng.integers(1, v // 2) * 2 + 1)
        self._b = int(rng.integers(0, v))
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._cdf = np.cumsum(probs / probs.sum())
        self._perm = rng.permutation(v)       # zipf mass over shuffled ids

    def _zipf(self, u: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self._cdf, u, side="right")
        return self._perm[np.clip(idx, 0, self.cfg.vocab_size - 1)]

    def batch(self, step: int, shard: int = 0, num_shards: int = 1):
        """Return (tokens, labels) for this step/shard: pure function."""
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        b_loc = cfg.global_batch // num_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        v = cfg.vocab_size
        toks = np.empty((b_loc, cfg.seq_len + 1), np.int64)
        toks[:, 0] = self._zipf(rng.random(b_loc))
        cont = rng.random((b_loc, cfg.seq_len)) < cfg.markov_p
        innov = self._zipf(rng.random((b_loc, cfg.seq_len)))
        for t in range(cfg.seq_len):
            markov_next = (self._a * toks[:, t] + self._b) % v
            toks[:, t + 1] = np.where(cont[:, t], markov_next, innov[:, t])
        return (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32))

    def batches(self, start_step: int, num: int, shard: int = 0,
                num_shards: int = 1):
        for s in range(start_step, start_step + num):
            yield self.batch(s, shard, num_shards)


def calibration_batches(cfg: DataConfig, num: int, shard: int = 0,
                        num_shards: int = 1, seed_offset: int = 1_000_000):
    """Held-out calibration split (disjoint seed range from training)."""
    calib_cfg = dataclasses.replace(cfg, seed=cfg.seed + seed_offset)
    gen = ZipfMarkov(calib_cfg)
    return [gen.batch(i, shard, num_shards) for i in range(num)]


__all__ = ["DataConfig", "ZipfMarkov", "calibration_batches"]
