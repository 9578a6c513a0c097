"""Serving launcher, static path: one prefill and a fixed-length greedy
decode of a uniform batch, optionally from a packed checkpoint.

  PYTHONPATH=src python -m repro_torch.launch.serve --tiny --arch llama32-1b \
      --batch 4 --prompt-len 16 --gen 8 [--ckpt DIR --packed] [--device cpu]

With ``--packed`` the checkpoint is a packed QTensor checkpoint (written by
``repro_torch.launch.compress --save-packed`` or by the JAX package's
``repro.launch.compress --save-packed``; the format is shared). Quantized
leaves stay packed ``QTensor`` leaves of the params, and every packed
linear reads its codes through the fused dequant-matmul kernel K4 on the
card. Token selection happens right after each step, so only the chosen
tokens leave the device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import latest_path, load_packed_checkpoint
from repro_torch.configs import get_config, get_tiny_config, list_archs
from repro_torch.data import DataConfig, ZipfMarkov
from repro_torch.models import build_model


def make_step_fns(model):
    """(prefill_fn, decode_fn) with greedy token selection folded in: each
    returns ``(tokens (B, 1) int64, cache)``."""
    def prefill_fn(params, batch, cache):
        logits, cache = model.prefill(params, batch, cache)
        return torch.argmax(logits[:, -1], -1)[:, None], cache

    def decode_fn(params, tok, cache):
        logits, cache = model.decode_step(params, tok, cache)
        return torch.argmax(logits[:, -1], -1)[:, None], cache

    return prefill_fn, decode_fn


def greedy_decode(model, params, prompts, gen: int, max_len: int = 0,
                  step_fns=None):
    """Greedy continuation of ``prompts`` (B, S) on the static slot cache
    (length ``max_len``, default S + gen). Returns ``(tokens, seconds)``:
    (B, gen) int tokens and the wall times of the prefill and of the
    decode steps (each ends in a device sync)."""
    prefill, decode = step_fns or make_step_fns(model)
    dev = params["embed"].device
    prompts = torch.as_tensor(np.asarray(prompts), device=dev)
    b, s = prompts.shape
    cache = model.init_cache(b, max_len or s + gen, torch.float32, device=dev)
    t0 = time.time()
    tok, cache = prefill(params, {"tokens": prompts}, cache)
    _sync(dev)
    t1 = time.time()
    out = [tok]
    for _ in range(gen - 1):
        tok, cache = decode(params, tok, cache)
        out.append(tok)
    tokens = torch.cat(out, dim=1).cpu().numpy()     # syncs the device
    return tokens, {"prefill": t1 - t0, "decode": time.time() - t1}


def static_greedy_reference(model, params, req, max_len,
                            step_fns=None) -> list:
    """One request on the static path: batch 1, the exact prompt
    (``req.prompt``), ``req.max_new_tokens`` greedy tokens, a cache of
    ``max_len`` — the per-request greedy oracle."""
    toks, _ = greedy_decode(model, params, np.asarray(req.prompt)[None, :],
                            req.max_new_tokens, max_len, step_fns)
    return [int(t) for t in toks[0]]


def _load_params(args, model):
    if not args.packed:
        return model.init(args.seed, device=args.device)
    path = latest_path(args.ckpt)
    if path is None:
        raise SystemExit(f"[serve] no checkpoint under {args.ckpt}")
    target = model.init(args.seed, device=args.device)
    params, qts, manifest = load_packed_checkpoint(path, target,
                                                   device=args.device)
    packed_b = sum(qt.nbytes() for qt in qts.values())
    dense_b = sum(int(np.prod(qt.shape)) * 4 for qt in qts.values())
    print(f"[serve] loaded packed checkpoint step {manifest['step']}: "
          f"{len(qts)} QTensor layers, {dense_b / 1e6:.1f}MB dense -> "
          f"{packed_b / 1e6:.1f}MB packed")
    return params


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_static(args, cfg, model, params):
    gen = ZipfMarkov(DataConfig(vocab_size=cfg.vocab_size,
                                seq_len=args.prompt_len,
                                global_batch=args.batch))
    prompts, _ = gen.batch(0)
    seqs, secs = greedy_decode(model, params, prompts, args.gen)
    print(f"[serve] batch={args.batch} prompt={args.prompt_len} gen={args.gen} "
          f"device={params['embed'].device}")
    print(f"[serve] prefill {args.batch * args.prompt_len / secs['prefill']:.0f}"
          f" tok/s, decode "
          f"{args.batch * (args.gen - 1) / max(secs['decode'], 1e-9):.0f} tok/s")
    print(f"[serve] sample continuation (req 0): {seqs[0][:16].tolist()}")
    return seqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32-1b", choices=list_archs())
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--packed", action="store_true",
                    help="--ckpt is a packed QTensor checkpoint")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random init (and of the load target)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.packed != bool(args.ckpt):
        ap.error("--ckpt takes a packed checkpoint and needs --packed "
                 "(dense checkpoints are not ported)")

    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    model = build_model(cfg)
    params = _load_params(args, model)
    return _serve_static(args, cfg, model, params)


if __name__ == "__main__":
    main()
