"""Compression launcher — the paper's pipeline as a CLI.

  PYTHONPATH=src python -m repro_torch.launch.compress --tiny \
      --arch llama32-1b --method awp_quant --bits 4 --out DIR --save-packed

Per-layer policies come from ``--policy`` (inline JSON or @file), in the
JSON of ``Policy.to_dict`` that both packages read, e.g.

  --policy '{"rules": [["*.attn.wo", {"kind": "PruneSpec", "ratio": 0.5}]],
             "default": {"kind": "QuantSpec", "bits": 4}}'

Restores the newest checkpoint under ``--ckpt`` (one written by either
package: ``{"params": ...}``; without one it compresses the random init of
``--seed``), measures perplexity on four held-out Zipf-Markov batches,
compresses with the batched engine (``--engine sequential`` for the
layer-at-a-time reference driver), prints the per-layer losses and the
perplexity before and after, and saves the compressed params: packed
QTensor codes included with ``--save-packed``, in the checkpoint format of
the JAX package.

``--metrics-json PATH`` writes the compression telemetry
(``repro_torch.obs``: per-layer iterations, residuals and seconds, per-bucket
and per-block seconds) there and its Prometheus text at ``PATH.prom``;
``--profile-dir DIR --profile-block I`` wraps block I in a
``torch.profiler`` window written to ``DIR/block-<i>.trace.json``.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.checkpoint import (CheckpointManager, save_checkpoint,
                                    save_packed_checkpoint)
from repro_torch.configs import get_config, get_tiny_config, list_archs
from repro_torch.core import metrics, registry
from repro_torch.core.compress import CompressionConfig, compress_model
from repro_torch.core.specs import Policy
from repro_torch.data import DataConfig, ZipfMarkov, calibration_batches
from repro_torch.models import build_model
from repro_torch.obs import MetricsRegistry


def build_policy(args) -> "Policy | CompressionConfig":
    if args.policy:
        text = args.policy
        if text.startswith("@"):
            with open(text[1:]) as f:
                text = f.read()
        return Policy.from_dict(json.loads(text))
    return CompressionConfig(method=args.method, ratio=args.ratio,
                             bits=args.bits, group_size=args.group_size,
                             skip=tuple(args.skip))


def perplexity(model, params, batches) -> float:
    """exp(mean token NLL) of ``model.loss`` over (tokens, labels) pairs."""
    def loss_fn(p, tokens, labels):
        _, m = model.loss(p, {"tokens": tokens, "labels": labels})
        return m["sum_nll"], m["tokens"]
    return metrics.perplexity(loss_fn, params, batches)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32-1b", choices=list_archs())
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--method", default="awp_prune",
                    choices=list(registry.available()))
    ap.add_argument("--ratio", type=float, default=0.5)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--skip", nargs="*", default=(),
                    help="layer-name patterns to leave dense")
    ap.add_argument("--policy", default="",
                    help="per-layer policy as JSON (or @file.json); "
                         "overrides --method/--ratio/--bits")
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default="results/train_ckpt",
                    help="restore the newest checkpoint here (none: the "
                         "random init of --seed)")
    ap.add_argument("--out", default="results/compressed_ckpt_torch")
    ap.add_argument("--save-packed", action="store_true",
                    help="store quantized layers as packed QTensor codes")
    ap.add_argument("--engine", default="batched",
                    choices=("batched", "sequential"),
                    help="shape-bucketed batched engine (default) or the "
                         "layer-at-a-time reference driver")
    ap.add_argument("--metrics-json", default="",
                    help="write the compression telemetry snapshot as JSON "
                         "here (plus Prometheus text exposition at "
                         "PATH.prom)")
    ap.add_argument("--profile-dir", default="",
                    help="directory for torch.profiler traces")
    ap.add_argument("--profile-block", type=int, default=-1,
                    help="block index to wrap in a torch.profiler trace "
                         "window (needs --profile-dir; -1 -> off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    model = build_model(cfg)
    params = model.init(args.seed, device=args.device)
    dev = params["embed"].device
    restored, step = CheckpointManager(args.ckpt).restore_latest(
        {"params": params})
    if restored is not None:
        params = restored["params"]
        print(f"[compress] loaded checkpoint step {step}")
    else:
        print("[compress] no checkpoint found — compressing random init "
              "(train first with repro.launch.train for meaningful numbers)")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=8)
    calib = [{"tokens": torch.as_tensor(t, device=dev)}
             for t, _ in calibration_batches(dc, args.calib_batches)]
    eval_batches = [
        tuple(torch.as_tensor(a, device=dev) for a in
              ZipfMarkov(dc).batch(9000 + i)) for i in range(4)]
    before = perplexity(model, params, eval_batches)
    policy = build_policy(args)
    reg = MetricsRegistry()
    cp, report = compress_model(model, params, calib, policy, verbose=True,
                                engine=args.engine, metrics=reg,
                                profile_dir=args.profile_dir,
                                profile_block=args.profile_block)
    after = perplexity(model, cp, eval_batches)
    print("[compress] " + report.summary().replace("\n", "\n[compress] "))
    if args.metrics_json:
        reg.dump_json(args.metrics_json, meta={
            "source": "compress", "arch": args.arch, "engine": args.engine,
            "method": args.method})
        with open(args.metrics_json + ".prom", "w") as f:
            f.write(reg.to_prometheus())
        print(f"[compress] metrics snapshot -> {args.metrics_json} "
              f"(+ {args.metrics_json}.prom)")
    print(f"[compress] perplexity {before:.3f} -> {after:.3f}")
    if args.save_packed and report.packed_layers():
        path = save_packed_checkpoint(args.out, 0, cp, report)
        print(f"[compress] wrote packed checkpoint {path} "
              f"(serve with --packed)")
    else:
        if args.save_packed:
            print("[compress] WARNING: no quantized artifacts to pack "
                  "(pruning-only policy?) — writing a dense checkpoint")
        path = save_checkpoint(args.out, 0, {"params": cp})
        print(f"[compress] wrote {path}")
    return cp, report


if __name__ == "__main__":
    main()
