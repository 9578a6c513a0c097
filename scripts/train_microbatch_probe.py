"""How far microbatching moves llama32-1b's gradient on one CUDA card.

  python scripts/train_microbatch_probe.py STEPS
  CUBLAS_WORKSPACE_CONFIG=:0:0 python scripts/train_microbatch_probe.py STEPS

Trains llama32-1b at full width for STEPS AdamW steps (the training phase
of ``chip_smoke.py``: batch 16 x 64, lr 1e-3, 20 warmup steps of 200),
then takes the gradient of batch 200 four ways: as one batch, as 2 and as
4 interleaved microbatches, and as one batch with its rows permuted (the
same sums in another order). Prints, leaf by leaf, each one's distance
from the single batch's gradient over that gradient's norm. Under
cuBLAS's default configuration a product over 512 or 256 tokens is summed
in another grouping than one over 1024 (split-K); with
``CUBLAS_WORKSPACE_CONFIG=:0:0`` nothing is split. Needs a card; imports
nothing of JAX.
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import repro_torch.kernels.ops  # noqa: E402,F401  (TF32 off, as the port runs)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, ZipfMarkov  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training.train_loop import (TrainConfig,  # noqa: E402
                                             compute_grads,
                                             init_train_state,
                                             make_train_step)

PERM = [3, 0, 7, 12, 1, 9, 15, 4, 2, 14, 6, 11, 8, 5, 13, 10]


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def main():
    if not torch.cuda.is_available():
        sys.exit("train_microbatch_probe: needs a CUDA card")
    steps = int(sys.argv[1])
    dev = torch.device("cuda")
    cfg = get_config("llama32-1b")
    model = build_model(cfg)
    tcfg = train_cli.train_config(argparse.Namespace(
        optimizer="adamw", lr=1e-3, steps=200, microbatches=1))
    step, _ = make_train_step(model, tcfg)
    state = init_train_state(model, 0, device=dev, tcfg=tcfg)
    gen = ZipfMarkov(DataConfig(cfg.vocab_size, 64, 16))
    state, _ = train_cli.run_steps(step, state, gen, 0, steps, dev,
                                   log_every=100)
    params = state["params"]
    del state
    tag = os.environ.get("CUBLAS_WORKSPACE_CONFIG", "default")
    print("tf32", torch.backends.cuda.matmul.allow_tf32,
          torch.get_float32_matmul_precision())
    batch = train_cli.device_batch(gen, 200, dev)
    _, g1 = compute_grads(model, tcfg, params, batch)
    _, g2 = compute_grads(model, TrainConfig(microbatches=2), params, batch)
    _, g4 = compute_grads(model, TrainConfig(microbatches=4), params, batch)
    perm = torch.tensor(PERM, device=dev)
    _, gp = compute_grads(model, tcfg, params,
                          {k: v[perm] for k, v in batch.items()})
    for (k, a), (_, b), (_, c), (_, d) in zip(_paths(g1), _paths(g2),
                                              _paths(g4), _paths(gp)):
        n = torch.linalg.vector_norm(a)

        def rel(x, y=a):
            return float(torch.linalg.vector_norm(y - x) / n)
        print(f"[micro {tag} steps={steps}] {k}: micro2 {rel(b):.2e} "
              f"micro4 {rel(c):.2e} micro2-vs-4 {rel(c, b):.2e} permuted "
              f"{rel(d):.2e} |g| {float(n):.3e}", flush=True)


if __name__ == "__main__":
    main()
