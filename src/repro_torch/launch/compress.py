"""Compression launcher — the paper's pipeline as a CLI.

  PYTHONPATH=src python -m repro_torch.launch.compress --tiny \
      --arch llama32-1b --method awp_quant --bits 4 --out DIR --save-packed

Per-layer policies come from ``--policy`` (inline JSON or @file), in the
JSON of ``Policy.to_dict`` that both packages read, e.g.

  --policy '{"rules": [["*.attn.wo", {"kind": "PruneSpec", "ratio": 0.5}]],
             "default": {"kind": "QuantSpec", "bits": 4}}'

Compresses the random init of ``--seed`` (loading a trained checkpoint is
not ported) with the batched engine (``--engine sequential`` for the
layer-at-a-time reference driver), prints the per-layer losses and
saves the compressed params: packed QTensor codes included with
``--save-packed``, in the checkpoint format of the JAX package.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.checkpoint import save_checkpoint, save_packed_checkpoint
from repro_torch.configs import get_config, get_tiny_config, list_archs
from repro_torch.core import registry
from repro_torch.core.compress import compress_model
from repro_torch.core.specs import Policy
from repro_torch.data import DataConfig, calibration_batches
from repro_torch.models import build_model


def build_policy(args) -> Policy:
    if args.policy:
        text = args.policy
        if text.startswith("@"):
            with open(text[1:]) as f:
                text = f.read()
        return Policy.from_dict(json.loads(text))
    cls = registry.spec_cls_for(args.method)
    fields = {f for f in ("ratio", "bits", "group_size")
              if hasattr(cls, f)}
    return Policy(default=cls(method=args.method,
                              **{f: getattr(args, f) for f in fields}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32-1b", choices=list_archs())
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--method", default="awp_prune",
                    choices=list(registry.available()))
    ap.add_argument("--ratio", type=float, default=0.5)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--policy", default="",
                    help="per-layer policy as JSON (or @file.json); "
                         "overrides --method/--ratio/--bits")
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--out", default="results/compressed_ckpt_torch")
    ap.add_argument("--save-packed", action="store_true",
                    help="store quantized layers as packed QTensor codes")
    ap.add_argument("--engine", default="batched",
                    choices=("batched", "sequential"),
                    help="shape-bucketed batched engine (default) or the "
                         "layer-at-a-time reference driver")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    model = build_model(cfg)
    params = model.init(args.seed, device=args.device)
    dev = params["embed"].device
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=8)
    calib = [{"tokens": torch.as_tensor(t, device=dev)}
             for t, _ in calibration_batches(dc, args.calib_batches)]
    policy = build_policy(args)
    cp, report = compress_model(model, params, calib, policy, verbose=True,
                                engine=args.engine)
    print("[compress] " + report.summary().replace("\n", "\n[compress] "))
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
