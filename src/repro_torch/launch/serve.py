"""Serving launcher: a static batch, or the continuous-batching engine,
optionally from a dense or a packed checkpoint.

Static path (one prefill and a fixed-length greedy decode, uniform batch):

  PYTHONPATH=src python -m repro_torch.launch.serve --tiny --arch llama32-1b \
      --batch 4 --prompt-len 16 --gen 8 [--ckpt DIR [--packed]] [--device cpu]

Engine path (continuous batching over a mixed-length trace, batched
same-bucket admissions, chunked prefill beyond the largest bucket,
per-request sampling, optional INT8 KV cache; K6 reads the decode cache and
K5 expands INT8 rows for the chunked prefill). ``--kv paged`` serves from a
pool of ``--page-size``-token pages through block tables (K6p reads the
decode cache), with shared-prefix reuse (off with ``--no-prefix-cache``)
and preemption when ``--pages`` oversubscribes the pool:

  PYTHONPATH=src python -m repro_torch.launch.serve --tiny --engine continuous \
      --requests 32 --slots 8 --gen 32 [--buckets 8,16] [--kv-quant] \
      [--kv paged --page-size 16 --pages N --no-prefix-cache] \
      [--mixed-admission] [--verify] [--device cpu]

Telemetry (engine path): ``--metrics-json PATH`` writes the engine's
registry snapshot (``repro_torch.obs``) there and its Prometheus text at
``PATH.prom``; ``--metrics-interval N`` prints one line of engine stats
every N steps; ``--profile-steps N --profile-dir DIR`` wraps the first N
engine steps in a ``torch.profiler`` window written to
``DIR/steps-<i>.trace.json`` (Chrome-trace JSON, one ``ProfilerStep#k``
span a step); with ``--verify`` each request's queue, TTFT and TPOT are
printed.

``--ckpt DIR`` serves the newest checkpoint there: a dense one (written by
either package's compress CLI without ``--save-packed``, or by the JAX
package's trainer: ``{"params": ...}``) as it is, or with ``--packed`` a
packed QTensor checkpoint (written by
``repro_torch.launch.compress --save-packed`` or by the JAX package's
``repro.launch.compress --save-packed``; the format is shared). Quantized
leaves stay packed ``QTensor`` leaves of the params, and every packed
linear reads its codes through the fused dequant-matmul kernel K4 on the
card (``--materialize`` restores the legacy path: quantized layers are
expanded to dense floats at load). Token selection happens right after
each step, so only the chosen tokens leave the device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_tiny_config, list_archs
from repro_torch.data import DataConfig, ZipfMarkov
from repro_torch.models import build_model
from repro_torch.quant import QTensor


def _tree_leaves(tree) -> list:
    """Leaves of nested dicts and lists in ``jax.tree.leaves``' order
    (dict keys sorted), a QTensor counting as one leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, QTensor):
        return [x for t in tree for x in _tree_leaves(t)]
    return [tree]


def qtensor_leaves(params) -> list:
    """The QTensor leaves of a params tree; a stacked leaf counts once
    (its children carry the block/expert dims)."""
    return [leaf for leaf in _tree_leaves(params)
            if isinstance(leaf, QTensor)]


def dense_itemsize(params) -> int:
    """Bytes per element of the tree's dense serving dtype: the first
    floating dense leaf decides (bf16 trees → 2, f32 → 4; QTensor children
    are skipped — their f32 scales are not the serving dtype). 4 when the
    tree has no dense float leaf."""
    for leaf in _tree_leaves(params):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            return leaf.element_size()
    return 4


def packed_weight_bytes(params) -> tuple:
    """(packed_bytes, dense_equiv_bytes) over the QTensor leaves of params.
    The dense equivalent is counted at the tree's actual dense dtype (a
    bf16 serving tree compares against 2-byte floats)."""
    itemsize = dense_itemsize(params)
    packed = dense = 0
    for leaf in qtensor_leaves(params):
        packed += leaf.nbytes()
        nibble = leaf.bits == 4 and leaf.packed.shape[-1] * 2 == leaf.shape[1]
        dense += leaf.packed.numel() * (2 if nibble else 1) * itemsize
    return packed, dense


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
                  step_fns=None, inputs=None):
    """Greedy continuation of ``prompts`` (B, S) on the static slot cache
    (length ``max_len``, default P + S + gen). ``inputs`` joins the
    prefill batch: a vlm config's ``"patches"`` (B, P, d_model) on the
    params' device, ahead of the prompts in the cache (P = 0 without).
    Returns ``(tokens, seconds)``: (B, gen) int tokens and the wall times
    of the prefill and of the decode steps (each ends in a device sync)."""
    prefill, decode = step_fns or make_step_fns(model)
    dev = params["embed"].device
    if not torch.is_tensor(prompts):
        prompts = np.asarray(prompts)
    prompts = torch.as_tensor(prompts, device=dev)
    batch = {"tokens": prompts, **(inputs or {})}
    b, s = prompts.shape
    s += batch["patches"].shape[1] if "patches" in batch else 0
    cache = model.init_cache(b, max_len or s + gen, torch.float32, device=dev)
    t0 = time.time()
    tok, cache = prefill(params, batch, cache)
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


def _interval_printer(every: int):
    """Step hook: one line of engine stats every ``every`` steps."""
    t0 = time.time()
    n = 0

    def on_step(eng):
        nonlocal n
        n += 1
        if n % every:
            return
        print(f"[serve] step {n}: active "
              f"{eng.scheduler.num_active}/{eng.cfg.num_slots}, queue "
              f"{len(eng.scheduler.queue)}, decode steps {eng.decode_steps}, "
              f"util {eng.utilization():.2f}, {time.time() - t0:.1f}s")

    return on_step


def _serve_engine(args, cfg, model, params):
    from repro_torch.obs import StepTraceWindow
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
                        kv_layout=args.kv, page_size=args.page_size,
                        num_pages=args.pages,
                        prefix_caching=not args.no_prefix_cache,
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

    hooks = []
    prof = StepTraceWindow(args.profile_dir, args.profile_steps)
    if prof.enabled:
        print(f"[serve] profiling first {args.profile_steps} steps -> "
              f"{args.profile_dir}")
    if args.metrics_interval > 0:
        hooks.append(_interval_printer(args.metrics_interval))
    hook = None
    if prof.enabled or hooks:
        def hook(eng, _hooks=tuple(hooks)):
            prof.on_step(eng)
            for h in _hooks:
                h(eng)

    _sync(dev)
    prof.start()
    t0 = time.time()
    for r in reqs:
        engine.try_submit(r)           # --max-queue sheds, never raises
    results = engine.run(step_hook=hook)
    _sync(dev)
    wall = time.time() - t0
    prof.stop()                        # no-op unless still inside the window
    if prof.path:
        print(f"[serve] profiler trace -> {prof.path}")

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
    ps = engine.page_stats()
    if ps:
        print(f"[serve] pages: {ps['pages_in_use']}/{ps['num_pages']} in use "
              f"(peak {ps['peak_pages_in_use']}, size {ps['page_size']}), "
              f"{ps['prefix_cached_pages']} prefix-cached")
        hits, misses = ps["prefix_hits"], ps["prefix_misses"]
        rate = hits / max(hits + misses, 1)
        print(f"[serve] prefix cache: {hits} hits / {misses} misses "
              f"({rate:.0%}), {ps['prefix_hit_tokens']} prompt tokens reused")
        print(f"[serve] preemptions {ps['preemptions']}, resumes "
              f"{ps['resumes']}, pages spilled {ps['pages_spilled']}")
    if args.verify:
        if args.temperature > 0:
            print("[serve] --verify needs greedy (temperature 0); skipping")
        elif args.kv_quant:
            print("[serve] --verify compares dense-KV greedy; skipping "
                  "under --kv-quant")
        else:
            bad, checked = _verify_against_static(model, params, reqs,
                                                  results, max_len)
            for r in sorted(results, key=lambda r: r.rid):
                print(f"[serve]   rid={r.rid} status={r.status} "
                      f"queue {r.queue_time * 1e3:.1f}ms "
                      f"ttft {r.ttft * 1e3:.1f}ms "
                      f"tpot {r.tpot * 1e3:.2f}ms "
                      f"({len(r.tokens)} tok)")
            print(f"[serve] verify vs static path: {checked - bad}/{checked} "
                  f"completed requests identical "
                  f"({len(reqs) - checked} not completed)")
            if bad:
                raise SystemExit(1)
    if args.metrics_json:
        engine.metrics_snapshot()      # refresh the state gauges
        engine.metrics.dump_json(args.metrics_json, meta={
            "source": "serve", "engine": "continuous", "arch": args.arch,
            "layout": args.kv, "requests": len(reqs), "wall_s": wall})
        prom = args.metrics_json + ".prom"
        with open(prom, "w") as f:
            f.write(engine.metrics.to_prometheus())
        print(f"[serve] metrics snapshot -> {args.metrics_json} (+ {prom})")
    return results


def _load_params(args, model):
    params = model.init(args.seed, device=args.device)
    if not args.ckpt:
        return params
    mgr = CheckpointManager(args.ckpt)
    if not args.packed:
        restored, step = mgr.restore_latest({"params": params})
        if restored is not None:
            params = restored["params"]
            print(f"[serve] loaded checkpoint step {step}")
        return params
    params, qts, manifest = mgr.restore_latest_packed(
        params, materialize=args.materialize, device=args.device)
    if params is None:
        raise SystemExit(f"[serve] no checkpoint under {args.ckpt}")
    packed_b = sum(qt.nbytes() for qt in qts.values())
    dense_b = sum(int(np.prod(qt.shape)) * 4 for qt in qts.values())
    print(f"[serve] loaded packed checkpoint step {manifest['step']}: "
          f"{len(qts)} QTensor layers, {dense_b / 1e6:.1f}MB dense -> "
          f"{packed_b / 1e6:.1f}MB packed"
          + (" (materialized dense — legacy path)" if args.materialize
             else ""))
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
    ap.add_argument("--materialize", action="store_true",
                    help="with --packed: expand quantized layers to dense "
                         "floats (legacy path) instead of serving packed")
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
                    help="engine KV layout: slots (one contiguous max-len "
                         "row per slot) or paged (a pool of fixed-size "
                         "pages with shared-prefix reuse and preemption)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="engine --kv paged: tokens per KV page (greedy "
                         "tokens equal the slot layout's when it divides "
                         "max-len)")
    ap.add_argument("--pages", type=int, default=0,
                    help="engine --kv paged: page-pool size (0 -> "
                         "slots * ceil(max-len / page-size), the slot "
                         "layout's footprint; smaller pools oversubscribe "
                         "and preempt)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="engine --kv paged: no shared-prefix page reuse")
    ap.add_argument("--mixed-admission", action="store_true",
                    help="engine: admit mixed-bucket FIFO head-runs in one "
                         "right-padded prefill")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="engine: bound the admission queue; submissions "
                         "past it shed as 'rejected' (0 -> unbounded)")
    ap.add_argument("--no-fused-decode", action="store_true",
                    help="engine: decode cache reads by expand-then-attend "
                         "instead of the flash-decode kernel K6")
    ap.add_argument("--metrics-json", default="",
                    help="engine: write the registry snapshot as JSON here "
                         "(plus Prometheus text exposition at PATH.prom)")
    ap.add_argument("--metrics-interval", type=int, default=0,
                    help="engine: print one-line stats every N steps "
                         "(0 -> off)")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="engine: torch.profiler trace window around the "
                         "first N steps (needs --profile-dir)")
    ap.add_argument("--profile-dir", default="",
                    help="directory for torch.profiler traces")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="engine: check greedy outputs against the static "
                         "path per request")
    args = ap.parse_args(argv)
    if args.packed and not args.ckpt:
        ap.error("--packed needs --ckpt")

    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    model = build_model(cfg)
    params = _load_params(args, model)
    if args.engine == "continuous":
        return _serve_engine(args, cfg, model, params)
    return _serve_static(args, cfg, model, params)


if __name__ == "__main__":
    main()
