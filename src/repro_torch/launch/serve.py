"""Serving launcher: a static batch, or the continuous-batching engine,
optionally from a packed checkpoint.

Static path (one prefill and a fixed-length greedy decode, uniform batch):

  PYTHONPATH=src python -m repro_torch.launch.serve --tiny --arch llama32-1b \
      --batch 4 --prompt-len 16 --gen 8 [--ckpt DIR --packed] [--device cpu]

Engine path (slot continuous batching over a mixed-length trace, batched
same-bucket admissions, chunked prefill beyond the largest bucket,
per-request sampling, optional INT8 KV cache; K6 reads the decode cache and
K5 expands INT8 rows for the chunked prefill):

  PYTHONPATH=src python -m repro_torch.launch.serve --tiny --engine continuous \
      --requests 32 --slots 8 --gen 32 [--buckets 8,16] [--kv-quant] \
      [--mixed-admission] [--verify] [--device cpu]

``--kv paged`` is the paging slice's and errors here.

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


def build_trace(cfg, *, num_requests: int, max_prompt: int, max_new: int,
                seed: int = 0, temperature: float = 0.0, top_k: int = 0):
    """Mixed-length request trace off the Zipf-Markov corpus: Zipf-ish
    prompt and output lengths (many short, a heavy tail), FIFO order — the
    reference's trace, token for token."""
    from repro_torch.serving import GenerationRequest, SamplingParams
    gen = ZipfMarkov(DataConfig(vocab_size=cfg.vocab_size, seq_len=max_prompt,
                                global_batch=1, seed=seed))
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(num_requests):
        plen = int(np.clip(rng.zipf(1.6), 1, max_prompt))
        nnew = int(np.clip(rng.zipf(1.4), 1, max_new))
        toks, _ = gen.batch(i)
        reqs.append(GenerationRequest(
            rid=i, prompt=toks[0, :plen].astype(np.int32),
            max_new_tokens=nnew,
            sampling=SamplingParams(temperature=temperature, top_k=top_k,
                                    seed=seed + i)))
    return reqs


def _verify_against_static(model, params, reqs, results, max_len) -> tuple:
    """Greedy engine outputs against the static path run per request (same
    cache length); requests that did not complete are skipped. Returns
    (mismatches, checked)."""
    step_fns = make_step_fns(model)
    by_rid = {r.rid: r.tokens for r in results if r.ok}
    bad = checked = 0
    for req in reqs:
        if req.rid not in by_rid:
            continue
        checked += 1
        ref = static_greedy_reference(model, params, req, max_len, step_fns)
        if by_rid[req.rid] != ref:
            bad += 1
            print(f"[serve]   MISMATCH rid={req.rid}: {by_rid[req.rid]} != {ref}")
    return bad, checked


def _serve_engine(args, cfg, model, params):
    from repro_torch.serving import Engine, EngineConfig

    max_len = min(args.max_len, args.prompt_len + args.gen) \
        if args.max_len else args.prompt_len + args.gen
    if max_len <= args.gen:
        raise SystemExit(f"[serve] --max-len {max_len} leaves no room for "
                         f"prompts at --gen {args.gen}")
    buckets = tuple(int(b) for b in args.buckets.split(",")) \
        if args.buckets else ()
    ecfg = EngineConfig(num_slots=args.slots, max_len=max_len,
                        prompt_buckets=buckets, kv_quantized=args.kv_quant,
                        kv_layout=args.kv,
                        mixed_admission=args.mixed_admission,
                        max_queue=args.max_queue,
                        use_fused_decode=not args.no_fused_decode)
    engine = Engine(model, params, ecfg)
    reqs = build_trace(cfg, num_requests=args.requests,
                       max_prompt=min(args.prompt_len, max_len - args.gen),
                       max_new=args.gen, seed=args.seed,
                       temperature=args.temperature, top_k=args.top_k)
    engine.warmup(reqs)
    dev = params["embed"].device
    _sync(dev)
    t0 = time.time()
    for r in reqs:
        engine.try_submit(r)           # --max-queue sheds, never raises
    results = engine.run()
    _sync(dev)
    wall = time.time() - t0

    done = [r for r in results if r.ok]
    statuses = {}
    for r in results:
        statuses[r.status] = statuses.get(r.status, 0) + 1
    n_tok = sum(len(r.tokens) for r in results)
    lats = sorted(r.latency for r in done) or [0.0]
    p50 = lats[len(lats) // 2]
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
    print(f"[serve] engine on {dev}: {len(results)} requests, {n_tok} tokens "
          f"in {wall:.2f}s -> {n_tok / wall:.0f} tok/s, "
          f"{engine.decode_steps} decode steps")
    qs = engine.queue_stats()
    print(f"[serve] statuses {statuses}, queue depth peak {qs['peak']} "
          f"mean {qs['mean']:.1f}"
          + (f", {qs['rejected']} shed at --max-queue {args.max_queue}"
             if args.max_queue else ""))
    print(f"[serve] latency p50 {p50 * 1e3:.1f}ms p99 {p99 * 1e3:.1f}ms, "
          f"slot utilization {engine.utilization():.2f}")
    note = (f"[serve] admissions: {engine.prefill_admitted} requests via "
            f"{engine.prefill_dispatches} batched prefills")
    if engine.chunked_admitted:
        note += (f", {engine.chunked_admitted} chunked prompts via "
                 f"{engine.chunk_dispatches} chunks")
    print(note)
    print(f"[serve] kv cache resident {engine.kv_cache_bytes() / 1e6:.2f}MB "
          f"({'int8' if args.kv_quant else 'dense'}, {args.kv})")
    if args.verify:
        if args.temperature > 0:
            print("[serve] --verify needs greedy (temperature 0); skipping")
        elif args.kv_quant:
            print("[serve] --verify compares dense-KV greedy; skipping "
                  "under --kv-quant")
        else:
            bad, checked = _verify_against_static(model, params, reqs,
                                                  results, max_len)
            print(f"[serve] verify vs static path: {checked - bad}/{checked} "
                  f"completed requests identical "
                  f"({len(reqs) - checked} not completed)")
            if bad:
                raise SystemExit(1)
    return results


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
    ap.add_argument("--engine", choices=("static", "continuous"),
                    default="static",
                    help="static: uniform batch, one prefill + N decodes; "
                         "continuous: slot continuous batching")
    ap.add_argument("--slots", type=int, default=8,
                    help="engine: device slots (concurrent requests)")
    ap.add_argument("--requests", type=int, default=32,
                    help="engine: trace length (mixed-length requests)")
    ap.add_argument("--max-len", type=int, default=0,
                    help="engine: slot KV length (0 -> prompt+gen)")
    ap.add_argument("--buckets", default="",
                    help="engine: comma-separated prompt buckets (empty -> "
                         "pow2 buckets covering max-len); prompts beyond "
                         "the largest bucket stream via chunked prefill")
    ap.add_argument("--kv-quant", action="store_true",
                    help="engine: INT8 per-head-group KV cache")
    ap.add_argument("--kv", choices=("slots", "paged"), default="slots",
                    help="engine KV layout (paged is not ported yet)")
    ap.add_argument("--mixed-admission", action="store_true",
                    help="engine: admit mixed-bucket FIFO head-runs in one "
                         "right-padded prefill")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="engine: bound the admission queue; submissions "
                         "past it shed as 'rejected' (0 -> unbounded)")
    ap.add_argument("--no-fused-decode", action="store_true",
                    help="engine: decode cache reads by expand-then-attend "
                         "instead of the flash-decode kernel K6")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="engine: check greedy outputs against the static "
                         "path per request")
    args = ap.parse_args(argv)
    if args.kv == "paged":
        ap.error("--kv paged: the paged KV layout is not ported yet")
    if args.packed != bool(args.ckpt):
        ap.error("--ckpt takes a packed checkpoint and needs --packed "
                 "(dense checkpoints are not ported)")

    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    model = build_model(cfg)
    params = _load_params(args, model)
    if args.engine == "continuous":
        return _serve_engine(args, cfg, model, params)
    return _serve_static(args, cfg, model, params)


if __name__ == "__main__":
    main()
