#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Builds the hand-written kernels K1–K6 (and K1b, K1 over a batch) from
``src/repro_torch/kernels/csrc``, holds each against its plain PyTorch
version at the shapes of the main paths (and a few edge cases), timing
both, then drives the port at the full width of llama32-1b (16 layers,
d_model 2048, d_ff 8192, padded vocab 129024, random weights from a seed):

  1. calibrate (Zipf-Markov, 32 x 512 tokens) -> compress_model with the
     batched engine, the default (every attn.wo pruned to 50% by AWP,
     every other linear AWP-quantized to int4, group 128: {wk, wv} and
     {wg, wu} run as buckets of 2 through K1b, wq, wo and wd alone through
     K1) -> pack in memory -> static greedy decode (4 prompts of 128
     tokens, 32 new tokens each). The sequential driver compresses the
     same model on the kernels and is held to the batched engine, and one
     more batched compression in PyTorch's sync-debug mode counts the
     host's waits on the card per block;
  2. the paper's Table-1 prune policy (every linear AWP-pruned to 50%) on
     blocks 0 and 1 with both engines on the kernels, the sequential one
     held to the batched one: buckets {wq, wo}, {wk, wv}, {wg, wu} through
     the compacting batched prune, wd alone;
  3. the continuous-batching engine on the packed model of 1: 8 slots of
     2048 tokens, an INT8 KV cache, prompt buckets 64..512, a 24-request
     Zipf trace plus two long prompts (1536 and 1900 tokens) that stream
     through the chunked prefill. Every packed linear runs K4, every
     decode step K6, every chunk of a long prompt K5.

Each path runs through the kernels, with every launch count set to 0 just
before and read just after, and the script checks that every kernel of
the path was launched, that no other was, and that the outputs are finite
and well-formed. Every path also runs through the kernels' plain
versions, held to the repo's parity bars (and paths 1 and 3 timed). One more
engine run through the kernels, in sync-debug mode and apart from the
timed ones, must show the host waiting on the card exactly once a decode
step, batched prefill and chunked prompt. This first process, with every
time in its JSON line, runs cuBLAS in its default configuration, as the
port's CLIs do.

cuBLAS splits K for short products (measured on the H100: 256-, 512- and
1024-row f32 products), so the plain K1 sums each output in another order
than the kernel's one FMA chain, and PGD turns those last-ulp differences
into code and mask flips. A second process (``chip_smoke.py --parity``,
started by the first) therefore runs paths 1 and 3 again with
``CUBLAS_WORKSPACE_CONFIG=:0:0``: with no workspace cuBLAS cannot split, so
every product sums in K1's and K4's order, and there the kernels' path must
equal the plain one with the sequential driver — same iteration counts,
same greedy tokens on the static path — and the same first token of every
engine request (prefill is K4's tile path and K5, which is exact; K6 sums
in tile order, so later engine tokens may part). With the batched engine
the plain K1b is cuBLAS's strided-batched product: if it also sums in
K1b's order the two paths must agree as well; if not, the first differing
layer is printed and the pair held to the bars.

Exits non-zero on any failed check, without a CUDA card, and outside a
checkout of the repository. Prints the card, a JSON line of per-kernel
numbers, and last ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

PARITY = "--parity"
UNSPLIT_CUBLAS = ":0:0"   # no cuBLAS workspace: no split-K

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH = "llama32-1b"
SEED = 0
CALIB_BATCHES, CALIB_BATCH, CALIB_SEQ = 4, 8, 512   # 16,384 tokens
BATCH, PROMPT_LEN, GEN = 4, 128, 32
# the engine phase
ENGINE = dict(num_slots=8, max_len=2048, prompt_buckets=(64, 128, 256, 512),
              kv_quantized=True)
TRACE = dict(num_requests=24, max_prompt=1024, max_new=32, seed=SEED)
LONG = ((1536, 32), (1900, 16))      # (prompt, new tokens): chunked prefill
# what PyTorch's sync-debug mode warns at each wait of the host on the card
# (its other warning, that the mode is a prototype, is not a wait)
SYNC_WARNING = "called a synchronizing CUDA operation"
# K4's rows: static decode, engine decode (8 slots), one prompt, 8 prompts
K4_M = (4, 8, 512, 8 * 512)
# K6 at the engine's decode shape: 8 slots, 32 heads over 8 KV heads, D 64
K6_LENGTHS = (0, 1, 255, 256, 1000, 1536, 2047, 2048)

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): f32 outside the
# tensor cores and HBM3 bandwidth — the bounds every kernel is held to.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

KERNELS = {   # wrapper name -> (CUDA source, the TPU kernel it replaces)
    "awp_pgd_step": ("src/repro_torch/kernels/csrc/awp_pgd.cu",
                     "src/repro/kernels/awp_pgd.py:115"),
    "awp_pgd_step_batched": ("src/repro_torch/kernels/csrc/awp_pgd.cu",
                             "src/repro/kernels/awp_pgd.py:71"),
    "topk_row": ("src/repro_torch/kernels/csrc/topk_mask.cu",
                 "src/repro/kernels/topk_mask.py:53"),
    "quant_project": ("src/repro_torch/kernels/csrc/quant_proj.cu",
                      "src/repro/kernels/quant_proj.py:33"),
    "dequant_matmul": ("src/repro_torch/kernels/csrc/dequant_matmul.cu",
                       "src/repro/kernels/dequant_matmul.py:51"),
    "kv_dequant": ("src/repro_torch/kernels/csrc/kv_dequant.cu",
                   "src/repro/kernels/kv_dequant.py:29"),
    "decode_attn": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                    "src/repro/kernels/decode_attn.py:134"),
}
COMPRESS_PATH = ("awp_pgd_step", "awp_pgd_step_batched", "topk_row",
                 "quant_project", "dequant_matmul")
PRUNE_PATH = ("awp_pgd_step", "awp_pgd_step_batched", "topk_row")
ENGINE_PATH = ("dequant_matmul", "kv_dequant", "decode_attn")
# K1b at the batched engine's buckets: {wk, wv}, {wg, wu} and {wq, wo}
K1B_SHAPES = ((2, 512, 2048), (2, 8192, 2048), (2, 2048, 2048),
              (3, 512, 2048))
# the main path's buckets at B = 2: 16 blocks x {wk, wv} and {wg, wu} x 10
# quantization steps
K1B_MAIN_LAUNCHES = 16 * 2 * 10
# the engines' parity bars (tests/test_torch_compress.py,
# tests/test_torch_batched.py): per-layer loss, share of equal entries
LOSS_BAR, AGREE_BAR = 1e-5, 0.999


def check_path(launches: dict, path: tuple, label: str) -> None:
    """Every kernel of ``path`` launched on it, and no other kernel."""
    for name, n in launches.items():
        if name in path:
            check(n > 0, f"{name} was not launched on {label}")
        else:
            check(n == 0, f"{name} was launched {n} times on {label}, "
                          f"which should not run it")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def bound_ms(flops: float, nbytes: float):
    """Least time the card could take: the larger of the operations over
    the f32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn(i)`` over ``reps`` calls. The calls are
    captured into one CUDA graph (after warm-up calls on the capture
    stream) and one replay is timed with CUDA events, so the host's cost
    of issuing a call — the wrappers' checks and ``ctypes`` — is not in
    the number: timed call by call, a kernel shorter than that cost
    measures the host. Callers rotate ``i`` over enough input copies to
    keep a memory-bound kernel's working set out of the 50 MB L2."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def copies_for(nbytes: int) -> int:
    return max(1, math.ceil(2 * 50e6 / nbytes))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"python {sys.version.split()[0]}")
    return card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.time()
    lib = _build.build()
    log(f"[build] {lib.name} in {time.time() - t0:.1f}s "
        f"({len(_build.sources())} sources, one nvcc each, in parallel)")
    for src, text in sorted(_build.build_log().items()):
        fn = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                raw = m.group(1)
                k = re.search(r"([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?", raw)
                fn = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
                      if k else raw)
                spills = ""
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and fn:
                spills = f"spills {m.group(1)}/{m.group(2)} B"
            m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)
            if m and fn:
                log(f"[build] {src}: {fn}: {m.group(1)} registers, "
                    f"{m.group(2) or 0} B smem, {spills}")
                fn = None
    _build.library()


def phase_kernels(torch, dev):
    """Each kernel against its plain version on the same inputs, with the
    kernel's time, the plain version's time and the bound."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rows = {}   # kernel -> representative (main-path) measurement

    # -- K1: Z = Θ + η(W−Θ)C at the four linear shapes --
    # cuBLAS (the plain version) may split K into partial sums, another
    # order than the kernel's one FMA chain an output; the tolerance, 1e-5
    # of max|Z|, admits that
    k1_err = 0.0
    for m, k in ((2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)):
        w, theta = randn(m, k), randn(m, k)
        c = randn(k, k) / math.sqrt(k)
        # the prune recipe's η = 2/‖C‖_F: not a power of two, so a fused
        # multiply-add in the epilogue would show
        eta = 2.0 / torch.linalg.matrix_norm(c)
        z, nrm = ops.awp_pgd_step(w, theta, c, eta)
        z_ref, nrm_ref = ref.awp_pgd_step(w, theta, c, eta)
        err = float((z - z_ref).abs().max())
        scale = float(z_ref.abs().max())
        nerr = float((nrm - nrm_ref).abs() / nrm_ref)
        check(err <= 1e-5 * scale and nerr <= 1e-5,
              f"K1 {(m, k)}: max|dZ| {err:.3e} (|Z| {scale:.3e}), "
              f"norm rel err {nerr:.3e}")
        k1_err = max(k1_err, err)
        ms = time_ms(torch, lambda i: ops.awp_pgd_step(w, theta, c, eta), 5)
        plain = time_ms(torch, lambda i: ref.awp_pgd_step(w, theta, c, eta),
                        5)
        bnd, by = bound_ms(2.0 * m * k * k, 4.0 * (3 * m * k + k * k))
        eta_f = float(eta)
        lib_ms = time_ms(torch, lambda i: torch.addmm(
            theta, w - theta, c, alpha=eta_f), 5)
        log(f"[K1] awp_pgd_step {(m, k)}: max|dZ| {err:.2e} "
            f"(|Z|max {scale:.2f}), kernel {ms:.3f} ms, plain {plain:.3f} ms, "
            f"addmm {lib_ms:.3f} ms, bound {bnd:.3f} ms ({by}), "
            f"{2.0 * m * k * k / ms / 1e9:.1f} TFLOP/s")
        if (m, k) == (2048, 8192):
            rows["awp_pgd_step"] = dict(shape="M=2048,K=8192", ms=ms,
                                        plain_ms=plain, bound_ms=bnd,
                                        bound_by=by, library_ms=lib_ms)
    rows["awp_pgd_step"]["max_abs_err"] = k1_err
    rows["awp_pgd_step_batched"] = check_k1b(torch, randn)

    # -- K2: exact top-k per row: the wo shape, ties, the Table-1 prune's
    # wd rows (d_in 8192) and a bucket's (B, M, d) stack as the batched
    # engine hands it over, one 73728-wide row --
    for name, z, k in (
            ("wo (2048, 2048)", randn(2048, 2048), 1024),
            ("wd (2048, 8192)", randn(2048, 8192), 4096),
            ("stack (2, 2048, 2048)", randn(2, 2048, 2048), 1024),
            ("ties (2048, 2048)", torch.randint(-8, 9, (2048, 2048),
                                                generator=gen, device=dev
                                                ).float(), 1024),
            ("row (1, 73728)", randn(1, 73728), 36864)):
        out = ops.topk_row(z, k)
        exact = torch.equal(out, ref.topk_row(z, k))
        check(exact and int((out != 0).sum(-1).max()) <= k,
              f"K2 {name} k={k}: kernel differs from the plain version")
        zs = [z.clone() for _ in range(copies_for(8 * z.numel()))]
        ms = time_ms(torch, lambda i: ops.topk_row(zs[i % len(zs)], k), 20)
        plain = time_ms(torch, lambda i: ref.topk_row(zs[i % len(zs)], k), 20)
        bnd, by = bound_ms(0.0, 8.0 * z.numel())
        log(f"[K2] topk_row {name} k={k}: exact, kernel {ms:.3f} ms, "
            f"plain {plain:.3f} ms, bound {bnd:.4f} ms ({by})")
        if name.startswith("wo"):
            rows["topk_row"] = dict(shape="rows=2048,d=2048,k=1024", ms=ms,
                                    plain_ms=plain, bound_ms=bnd, bound_by=by,
                                    library_ms=None, max_abs_err=0.0)

    # -- K3: exact quantize-dequantize at the four shapes, bits 4 and 8 --
    for r, d, bits in ((8192, 2048, 4), (8192, 2048, 8), (2048, 8192, 4),
                       (2048, 8192, 8), (2048, 2048, 4), (512, 2048, 4)):
        z = randn(r, d)
        exact = torch.equal(ops.quant_project(z, bits, 128),
                            ref.quant_project(z, bits, 128))
        check(exact, f"K3 ({r}, {d}) bits={bits}: kernel differs from the "
                     f"plain version")
        zs = [z.clone() for _ in range(copies_for(8 * z.numel()))]
        ms = time_ms(torch, lambda i: ops.quant_project(
            zs[i % len(zs)], bits, 128), 20)
        plain = time_ms(torch, lambda i: ref.quant_project(
            zs[i % len(zs)], bits, 128), 20)
        bnd, by = bound_ms(0.0, 8.0 * z.numel())
        log(f"[K3] quant_project ({r}, {d}) bits={bits}: exact, kernel "
            f"{ms:.3f} ms, plain {plain:.3f} ms, bound {bnd:.4f} ms ({by})")
        if (r, d, bits) == (8192, 2048, 4):
            rows["quant_project"] = dict(shape="rows=8192,d=2048,bits=4",
                                         ms=ms, plain_ms=plain, bound_ms=bnd,
                                         bound_by=by, library_ms=None,
                                         max_abs_err=0.0)

    # -- K4: packed int4 matmul at every M the two paths give it: the
    # static decode (M=4), the engine's decode with all slots busy (M=8,
    # the top of the GEMV branch), a prefill or chunk of one 512-token
    # prompt (M=512) and the engine's largest batched prefill (8 x 512) --
    # tolerance: the dequantized weight is bit-equal, the f32 sum over K
    # runs in another order
    k4_err, k4_shapes = 0.0, []
    group = 128
    for n, k in ((2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)):
        packed = torch.randint(0, 256, (n, k // 2), generator=gen,
                               device=dev, dtype=torch.uint8)
        scale = torch.rand((n, k // group), generator=gen, device=dev) * 0.02
        zero = torch.randint(0, 16, (n, k // group), generator=gen,
                             device=dev).float()
        wbytes = n * k / 2 + 8.0 * n * k / group
        ws = [(packed.clone(), scale.clone(), zero.clone())
              for _ in range(copies_for(wbytes))]
        for m in K4_M:
            x = randn(m, k)
            y = ops.dequant_matmul(x, packed, scale, zero, group)
            y_ref = ref.dequant_matmul(x, packed, scale, zero, group)
            err = float((y - y_ref).abs().max())
            ymax = float(y_ref.abs().max())
            check(err <= 1e-5 * ymax, f"K4 M={m} (N={n}, K={k}): max|dy| "
                                      f"{err:.3e} (|y| {ymax:.3e})")
            k4_err = max(k4_err, err)
            ms = time_ms(torch, lambda i: ops.dequant_matmul(
                x, *ws[i % len(ws)], group), 20)
            plain = time_ms(torch, lambda i: ref.dequant_matmul(
                x, *ws[i % len(ws)], group), 20)
            bnd, by = bound_ms(2.0 * m * n * k,
                               wbytes + 4.0 * m * k + 4.0 * m * n)
            log(f"[K4] dequant_matmul M={m} N={n} K={k}: max|dy| {err:.2e} "
                f"(|y|max {ymax:.1f}), kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, bound {bnd:.4f} ms ({by})")
            k4_shapes.append(dict(shape=f"M={m},N={n},K={k}", ms=ms,
                                  plain_ms=plain, bound_ms=bnd, bound_by=by,
                                  max_abs_err=err))
            if (m, n, k) == (4, 8192, 2048):
                rows["dequant_matmul"] = dict(shape="M=4,N=8192,K=2048",
                                              ms=ms, plain_ms=plain,
                                              bound_ms=bnd, bound_by=by,
                                              library_ms=None)
    rows["dequant_matmul"]["max_abs_err"] = k4_err
    rows["dequant_matmul"]["by_shape"] = k4_shapes
    rows["kv_dequant"] = check_k5(torch, dev, gen)
    rows["decode_attn"] = check_k6(torch, dev, gen)
    return rows


def check_k1b(torch, randn):
    """K1b, the batched step, at the batched engine's buckets (B = 2) and
    at B = 3, with a different η per item (the second item's C is scaled,
    so an item that read another's η or C would show): Z within 1e-5 of
    max|Z| and each norm within 1e-5 relative of the plain version's.
    Timed beside its plain version and ``torch.baddbmm`` with one shared η
    (the same work; a yardstick the port never calls)."""
    from repro_torch.kernels import ops, ref
    err_all, by_shape, row = 0.0, [], None
    for b, m, k in K1B_SHAPES:
        w, theta = randn(b, m, k), randn(b, m, k)
        c = randn(b, k, k) / math.sqrt(k)
        c[1] *= 1.7
        eta = 2.0 / torch.linalg.matrix_norm(c)                   # (B,)
        check(len(set(eta.tolist())) == b, f"K1b {(b, m, k)}: η not distinct")
        z, nrm = ops.awp_pgd_step(w, theta, c, eta)            # K1b: 3-D
        z_ref, nrm_ref = ref.awp_pgd_step(w, theta, c, eta)
        err = float((z - z_ref).abs().max())
        scale = float(z_ref.abs().max())
        nerr = float(((nrm - nrm_ref).abs() / nrm_ref).max())
        check(err <= 1e-5 * scale and nerr <= 1e-5,
              f"K1b {(b, m, k)}: max|dZ| {err:.3e} (|Z| {scale:.3e}), "
              f"norm rel err {nerr:.3e}")
        err_all = max(err_all, err)
        ms = time_ms(torch, lambda i: ops.awp_pgd_step(w, theta, c, eta), 5)
        plain = time_ms(torch, lambda i: ref.awp_pgd_step(w, theta, c, eta),
                        5)
        eta_f = float(eta[0])
        lib = time_ms(torch, lambda i: torch.baddbmm(
            theta, w - theta, c, alpha=eta_f), 5)
        bnd, by = bound_ms(2.0 * b * m * k * k,
                           4.0 * b * (3 * m * k + k * k))
        log(f"[K1b] awp_pgd_step {(b, m, k)}, η {eta.tolist()}: "
            f"max|dZ| {err:.2e} (|Z|max {scale:.2f}), norm rel err "
            f"{nerr:.1e}, kernel {ms:.3f} ms, plain {plain:.3f} ms, baddbmm "
            f"{lib:.3f} ms, bound {bnd:.3f} ms ({by}), "
            f"{2.0 * b * m * k * k / ms / 1e9:.1f} TFLOP/s")
        entry = dict(shape=f"B={b},M={m},K={k}", ms=ms, plain_ms=plain,
                     bound_ms=bnd, bound_by=by, library_ms=lib,
                     max_abs_err=err)
        by_shape.append(entry)
        if (b, m, k) == (2, 8192, 2048):
            row = dict(entry)
    row["max_abs_err"] = err_all
    row["by_shape"] = by_shape
    return row


def check_k5(torch, dev, gen):
    """K5 at the chunked prefill's shape: one slot's layer rows of the
    INT8 cache, R = T = 2048 tokens, K = Hk·D = 512, group 64. Exact."""
    from repro_torch.kernels import ops, ref
    r, k, group = 2048, 512, 64
    codes = torch.randint(0, 256, (r, k), generator=gen, device=dev,
                          dtype=torch.uint8)
    scale = (torch.rand((r, k // group), generator=gen, device=dev) * 0.05
             + 1e-4).half()
    zero = torch.randint(0, 256, (r, k // group), generator=gen,
                         device=dev).half()
    out = ops.kv_dequant(codes, scale, zero, group)
    check(torch.equal(out, ref.kv_dequant(codes, scale, zero, group)),
          "K5: kernel differs from the plain version")
    nbytes = r * k + 4.0 * r * k / group + 4.0 * r * k
    ins = [(codes.clone(), scale.clone(), zero.clone())
           for _ in range(copies_for(nbytes))]
    ms = time_ms(torch, lambda i: ops.kv_dequant(*ins[i % len(ins)], group),
                 50)
    plain = time_ms(torch, lambda i: ref.kv_dequant(*ins[i % len(ins)],
                                                    group), 50)
    bnd, by = bound_ms(0.0, nbytes)
    log(f"[K5] kv_dequant R={r} K={k} group={group}: exact, kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms ({by})")
    return dict(shape=f"R={r},K={k},group={group}", ms=ms, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=None, max_abs_err=0.0)


def check_k6(torch, dev, gen):
    """K6 at the engine's decode shape, dense f32 and INT8 (group 64), with
    ragged lengths, a length-0 row and a NaN-poisoned row. Within 1e-5 of
    the plain version (one softmax over the row against the kernel's
    online softmax over 256-token tiles). The dense variant is also timed
    against ``scaled_dot_product_attention`` (K/V repeated to every query
    head, a boolean length mask) as a yardstick the port never calls."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.kv_cache import kv_quantize
    b, h, hk, d, t, group = len(K6_LENGTHS), 32, 8, 64, 2048, 64
    q = torch.randn((b, h, d), generator=gen, device=dev)
    k = torch.randn((b, t, hk, d), generator=gen, device=dev)
    v = torch.randn((b, t, hk, d), generator=gen, device=dev)
    lengths = torch.tensor(K6_LENGTHS, dtype=torch.int32, device=dev)
    qk, qv = kv_quantize(k, group), kv_quantize(v, group)
    variants = {
        "dense": ((k, v), {}),
        "int8": ((qk.codes, qv.codes),
                 dict(k_scale=qk.scale, k_zero=qk.zero, v_scale=qv.scale,
                      v_zero=qv.zero, group_size=group))}
    live = sum(K6_LENGTHS)
    io = 4.0 * 2 * b * h * d + 4 * b
    tok_bytes = {"dense": 2 * hk * d * 4.0,
                 "int8": 2 * hk * (d + 4.0 * d / group)}
    res = {}
    for name, ((kk, vv), kw) in variants.items():
        out = ops.decode_attn(q, kk, vv, lengths, **kw)
        want = ref.decode_attn(q, kk, vv, lengths, **kw)
        err = float((out - want).abs().max())
        rel = float(((out - want).abs() / (want.abs() + 1.0)).max())
        check(err <= 1e-5 or rel <= 1e-5,
              f"K6 {name}: max|d| {err:.3e} against the plain version")
        check(torch.equal(out[0], torch.zeros_like(out[0])),
              f"K6 {name}: the length-0 row is not exactly zero")
        # one poisoned token in row 4 (length 1000): only that row is NaN
        if name == "dense":
            bad_k = kk.clone()
            bad_k[4, 10, 3] = float("nan")
            bad = ops.decode_attn(q, bad_k, vv, lengths)
        else:
            bad_kw = dict(kw, k_scale=kw["k_scale"].clone())
            bad_kw["k_scale"][4, 10, 3] = float("nan")
            bad = ops.decode_attn(q, kk, vv, lengths, **bad_kw)
        others = [i for i in range(b) if i != 4]
        check(bool(torch.isnan(bad[4, 3 * 4:3 * 4 + 4]).all())
              and bool(torch.isfinite(bad[others]).all())
              and torch.equal(bad[others], out[others]),
              f"K6 {name}: the NaN row does not propagate alone")
        nbytes = live * tok_bytes[name] + io
        ins = [tuple(x.clone() for x in (kk, vv)) + (
               {n: x.clone() if hasattr(x, "clone") else x
                for n, x in kw.items()},)
               for _ in range(copies_for(b * t * tok_bytes[name]))]
        ms = time_ms(torch, lambda i: ops.decode_attn(
            q, ins[i % len(ins)][0], ins[i % len(ins)][1], lengths,
            **ins[i % len(ins)][2]), 50)
        plain = time_ms(torch, lambda i: ref.decode_attn(
            q, ins[i % len(ins)][0], ins[i % len(ins)][1], lengths,
            **ins[i % len(ins)][2]), 20)
        bnd, by = bound_ms(4.0 * h * d * live, nbytes)
        lib = None
        if name == "dense":
            qs = q[:, :, None, :]                         # (B, H, 1, D)
            reps = [tuple(x.permute(0, 2, 1, 3).repeat_interleave(h // hk, 1)
                          for x in pair[:2]) for pair in ins]
            mask = (torch.arange(t, device=dev)[None, :]
                    < lengths[:, None].long())[:, None, None, :]
            lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                qs, reps[i % len(reps)][0], reps[i % len(reps)][1],
                attn_mask=mask), 50)
            del reps
        lib_txt = "n/a" if lib is None else f"{lib:.4f} ms"
        log(f"[K6] decode_attn {name} B={b} H={h} Hk={hk} D={d} T={t} "
            f"lengths {list(K6_LENGTHS)}: max|d| {err:.2e}, zero row exact, "
            f"NaN row alone, kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"sdpa {lib_txt}, bound {bnd:.4f} ms ({by}), "
            f"{nbytes / ms / 1e9:.2f} TB/s of live bytes")
        res[name] = dict(shape=f"B={b},H={h},Hk={hk},D={d},T={t},{name}",
                         ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                         library_ms=lib, max_abs_err=err)
    row = dict(res["int8"])              # the engine path's variant
    row["dense"] = res["dense"]
    return row


def policy_for(name: str):
    """The main path's policy ("mixed": every attn.wo AWP-pruned to 50%,
    every other linear AWP-int4, group 128) or the paper's Table-1 prune
    policy on blocks 0 and 1 ("table1": every linear AWP-pruned to 50%,
    the other 14 blocks left dense)."""
    from repro_torch.core.specs import Policy, PruneSpec, QuantSpec
    if name == "mixed":
        return Policy({"*.attn.wo": PruneSpec(ratio=0.5)},
                      default=QuantSpec(bits=4, group_size=128))
    return Policy({"blocks.0.*": PruneSpec(ratio=0.5),
                   "blocks.1.*": PruneSpec(ratio=0.5)}, default=None)


def compress(torch, data, policy, engine):
    """``compress_model`` once, timed to the card's end of it. Returns the
    compressed params, the report and the seconds."""
    from repro_torch.core.compress import compress_model
    model, params, calib, _ = data
    torch.cuda.synchronize()
    t0 = time.time()
    cp, report = compress_model(model, params, calib, policy, engine=engine)
    torch.cuda.synchronize()
    return cp, report, time.time() - t0


def run_path(torch, dev, data, label, engine):
    """The main path once: compress, pack, greedy decode."""
    from repro_torch.checkpoint import pack_params
    from repro_torch.launch.serve import greedy_decode

    model, _, _, prompts = data
    cp, report, t_comp = compress(torch, data, policy_for("mixed"), engine)
    packed = pack_params(cp, report)
    del cp
    logits, _ = model.prefill(
        packed, {"tokens": torch.as_tensor(prompts, device=dev)},
        model.init_cache(BATCH, PROMPT_LEN + GEN, torch.float32, device=dev))
    tokens, secs = greedy_decode(model, packed, prompts, GEN)
    log(f"[{label}] {engine} compress {t_comp:.1f}s, prefill "
        f"{secs['prefill']:.3f}s, {GEN - 1} decode steps "
        f"{secs['decode']:.3f}s")
    return report, packed, logits, tokens, t_comp


def setup(torch, dev, cfg):
    """Random full-width model from the seed, calibration batches and
    prompts."""
    from repro_torch.data import DataConfig, ZipfMarkov, calibration_batches
    from repro_torch.models import build_model

    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    log(f"[model] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), "
        f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f}e9 f32 "
        f"parameters from seed {SEED} (full depth, no cut)")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=CALIB_SEQ,
                    global_batch=CALIB_BATCH)
    calib = [{"tokens": torch.as_tensor(t, device=dev)}
             for t, _ in calibration_batches(dc, CALIB_BATCHES)]
    prompts, _ = ZipfMarkov(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=PROMPT_LEN,
                                       global_batch=BATCH)).batch(0)
    return model, params, calib, prompts


def engine_path(engine: str) -> tuple:
    """The kernels the main path launches with ``engine``: the sequential
    driver never runs K1b."""
    if engine == "batched":
        return COMPRESS_PATH
    return tuple(k for k in COMPRESS_PATH if k != "awp_pgd_step_batched")


def both_paths(torch, dev, data, tag, engine):
    """The main path through the kernels (launch counts set to 0 just
    before and read just after), then through the plain versions. Returns
    the kernels' counts and both runs' outputs."""
    from repro_torch import kernels
    from repro_torch.kernels import ops

    ops.reset_launches()
    out_k = run_path(torch, dev, data, f"{tag}kernels", engine)
    launches = dict(ops.LAUNCHES)
    log(f"[{tag}kernels] launches on the main path: {launches}")
    check_path(launches, engine_path(engine),
               f"the compress and decode path ({engine})")
    if engine == "batched":
        check(launches["awp_pgd_step_batched"] == K1B_MAIN_LAUNCHES,
              f"K1b launched {launches['awp_pgd_step_batched']} times, "
              f"expected {K1B_MAIN_LAUNCHES} (16 blocks x 2 buckets x 10)")

    ops.reset_launches()
    with kernels.use_impl("reference"):
        out_p = run_path(torch, dev, data, f"{tag}plain", engine)
    log(f"[{tag}plain] launches: {dict(ops.LAUNCHES)}")
    check(not any(ops.LAUNCHES.values()), "the plain run launched a kernel")
    return launches, out_k, out_p


def hold_reports(torch, rep_a, rep_b, tag, n_layers, iters_equal,
                 show_all=False):
    """Two compressions of one model, layer by layer: both well-formed
    (losses finite in (0, 1), AWP prune at exactly 50%), per-layer losses
    within ``LOSS_BAR``, masks and codes equal on >= ``AGREE_BAR`` of
    entries, and with ``iters_equal`` equal iteration counts. Prints every
    layer with ``show_all``, else the layers that differ. Returns the
    summary, with the first differing layer and its count of differing
    entries."""
    check(len(rep_a) == len(rep_b) == n_layers,
          f"{tag}: {len(rep_a)} and {len(rep_b)} layers, expected {n_layers}")
    max_dloss, min_agree, iters_differ = 0.0, 1.0, 0
    first, differing = None, 0
    for r_a, r_b in zip(rep_a, rep_b):
        check(r_a.qualname == r_b.qualname, f"{tag}: layer order")
        res_a = rep_a.artifacts[r_a.qualname].result
        res_b = rep_b.artifacts[r_b.qualname].result
        if res_a.qtensor is not None:
            same = (res_a.qtensor.codes() == res_b.qtensor.codes()).cpu()
        else:
            same = torch.from_numpy(res_a.mask == res_b.mask)
        n_diff = int((~same).sum())
        agree = float(same.float().mean())
        dloss = abs(r_a.loss_after - r_b.loss_after)
        if show_all or n_diff or res_a.iters != res_b.iters or dloss:
            log(f"[{tag}] {r_a.qualname:18s} {r_a.method:9s} loss "
                f"{r_a.loss_after:.6f}/{r_b.loss_after:.6f} iters "
                f"{res_a.iters}/{res_b.iters} sparsity {r_a.sparsity:.4f} "
                f"{'codes' if res_a.qtensor is not None else 'mask'} differ "
                f"{n_diff}/{same.numel()}")
        for r in (r_a, r_b):
            check(math.isfinite(r.loss_after) and 0.0 < r.loss_after < 1.0,
                  f"{r.qualname}: loss {r.loss_after}")
            if r.method == "awp_prune":
                check(r.sparsity == 0.5, f"{r.qualname}: sparsity {r.sparsity}")
        if n_diff or res_a.iters != res_b.iters:
            differing += 1
            if first is None:
                first = (r_a.qualname, n_diff, same.numel())
        iters_differ += res_a.iters != res_b.iters
        max_dloss = max(max_dloss, dloss)
        min_agree = min(min_agree, agree)
    log(f"[{tag}] {len(rep_a)} layers; max |loss difference| "
        f"{max_dloss:.3e}; least share of equal codes/mask entries "
        f"{min_agree:.6f}; layers with other iteration counts "
        f"{iters_differ}; layers that differ {differing}, the first "
        f"{first}; mean loss {rep_a.mean_loss():.6f} / "
        f"{rep_b.mean_loss():.6f}")
    check(max_dloss <= LOSS_BAR and min_agree >= AGREE_BAR,
          f"{tag}: the two compressions differ beyond the repo's bars")
    check(not iters_equal or iters_differ == 0,
          f"{tag}: iteration counts differ")
    return dict(max_dloss=max_dloss, min_agree=min_agree,
                iters_differ=iters_differ, layers_differ=differing,
                first_diff=first, identical=differing == 0)


def compare(torch, dev, cfg, model, prompts, out_k, out_p, tag, mode):
    """Both runs' outputs well-formed and held to the repo's parity bars
    (tests/test_torch_compress.py): per-layer loss within 1e-5, masks and
    codes equal on >= 99.9% of entries. ``mode``: "bars" shows iteration
    counts and greedy tokens; "bits" also requires equal iteration counts
    and greedy tokens; "bits_if_same" requires equal tokens only when the
    two compressions came out bit for bit the same, and otherwise records
    the first differing layer. Returns the compression summary."""
    import numpy as np
    from repro_torch.quant import QTensor

    rep_k, packed_k, logits_k, tok_k = out_k[:4]
    rep_p, packed_p, logits_p, tok_p = out_p[:4]
    summary = hold_reports(torch, rep_k, rep_p, f"{tag}layer",
                           7 * cfg.num_layers, iters_equal=mode == "bits",
                           show_all=mode == "bars" and not tag)
    packed_leaves = [n for n, g in (("wq", "attn"), ("wk", "attn"),
                                    ("wv", "attn"), ("wg", "mlp"),
                                    ("wu", "mlp"), ("wd", "mlp"))
                     if isinstance(packed_k["blocks"][g][n], QTensor)]
    check(len(packed_leaves) == 6, f"packed leaves {packed_leaves}")

    v, vp = cfg.vocab_size, cfg.padded_vocab
    for lg in (logits_k, logits_p):
        check(tuple(lg.shape) == (BATCH, 1, vp), f"logits shape {lg.shape}")
        check(bool(torch.isfinite(lg[..., :v]).all()), "non-finite logits")
        check(bool((lg[..., v:] == torch.finfo(lg.dtype).min).all()),
              "padded vocab columns not masked")
    dlog = float((logits_k - logits_p).abs().max())
    summary["logits_dmax"] = dlog
    log(f"[{tag}decode] prefill logits max |kernels - plain| {dlog:.3e} "
        f"(|logit|max {float(logits_p[..., :v].abs().max()):.3f})")
    exact = mode == "bits" or (mode == "bits_if_same" and summary["identical"])
    if mode == "bits_if_same":
        log(f"[{tag}compress] kernels against plain: "
            + ("the same bits in every layer" if summary["identical"] else
               f"{summary['layers_differ']} layers differ, the first "
               f"{summary['first_diff']} (layer, differing entries, "
               f"entries); held to the bars instead"))
    for tok in (tok_k, tok_p):
        check(tok.shape == (BATCH, GEN) and tok.min() >= 0 and tok.max() < v,
              "greedy tokens malformed")
    summary["tokens_identical"] = bool((tok_k == tok_p).all())
    if not summary["tokens_identical"]:
        b, t = [int(i[0]) for i in (tok_k != tok_p).nonzero()]
        seq = torch.as_tensor(np.concatenate([prompts, tok_k], 1)
                              [b:b + 1, :PROMPT_LEN + t], device=dev)
        for label, p in (("kernels", packed_k), ("plain", packed_p)):
            top2 = model.logits(p, {"tokens": seq})[0, -1].topk(2).values
            log(f"[{tag}decode] greedy tokens differ at row {b} position "
                f"{t}: {label} top-2 gap {float(top2[0] - top2[1]):.3e}")
        check(not exact, f"greedy tokens differ at row {b}, position {t}")
    else:
        log(f"[{tag}decode] greedy tokens identical on both paths: "
            f"{BATCH} x {GEN}; row 0: {tok_k[0][:12].tolist()}")
    return summary


class _BlockMarks:
    """The model, recording how many host waits had happened when
    ``compress_model`` began each block (its first capture pass)."""

    def __init__(self, model, waits_so_far):
        self._model, self._waits_so_far = model, waits_so_far
        self.starts = {}

    def __getattr__(self, name):
        return getattr(self._model, name)

    def block_apply_one(self, params, i, h, *, capture=False):
        if capture and i not in self.starts:
            self.starts[i] = self._waits_so_far()
        return self._model.block_apply_one(params, i, h, capture=capture)


def count_waits(torch, data, policy, tag):
    """One batched compression, untimed, in PyTorch's sync-debug mode: the
    host's waits on the card per block and where each comes from (file and
    line of the call that waited)."""
    from collections import Counter
    from repro_torch.core import awp
    from repro_torch.core.compress import compress_model
    model, params, calib, _ = data
    torch.cuda.synchronize()
    with host_waits(torch, True) as waits:
        caught = waits["caught"]

        def so_far():
            return sum(SYNC_WARNING in str(w.message) for w in caught)
        marked = _BlockMarks(model, so_far)
        cp, report = compress_model(marked, params, calib, policy)
        del cp
    syncs = waits["syncs"]
    starts = [marked.starts[i] for i in range(model.num_blocks())]
    ends = starts[1:] + [len(syncs)]
    per_block = []
    for i, (a, b) in enumerate(zip(starts, ends)):
        where = Counter(f"{Path(w.filename).name}:{w.lineno}"
                        for w in syncs[a:b])
        per_block.append(b - a)
        log(f"[{tag}waits] block {i}: {b - a} waits "
            f"{dict(sorted(where.items()))}")
    log(f"[{tag}waits] {len(syncs)} host waits in one batched compression "
        f"({starts[0]} before block 0); per block {per_block}; "
        f"{waits['other']} other warnings")
    # expected: the block's token counts and its end-of-block transfer,
    # plus one read after each chunk of a prune that runs alone (the
    # sequential loop; none after the chunk that ends at the cap)
    chunk, cap = awp.PGD_CHUNK_ITERS, awp.PRUNE_CONFIG.max_iters
    expect = [2] * model.num_blocks()
    buckets = {}
    for r in report:
        buckets.setdefault((r.block, r.method), []).append(r)
    for (block, method), layers in buckets.items():
        if method == "awp_prune" and len(layers) == 1:
            its = report.artifacts[layers[0].qualname].result.iters
            expect[block] += min(-(-its // chunk), -(-cap // chunk) - 1)
    check(per_block == expect, f"host waits per block {per_block}, "
                               f"expected {expect}")
    return per_block, report


def phase_main_path(torch, dev, cfg, data):
    """The main path as the port's users run it (the batched engine):
    through the kernels (counted), and through the plain versions for
    their times; then the reference driver on the kernels, held to the
    batched engine's compression, and the host's waits in one batched
    compression. Returns the counts, the kernels' packed params (the
    engine's) and the numbers."""
    from repro_torch.kernels import ops
    model, _, _, prompts = data
    launches, out_k, out_p = both_paths(torch, dev, data, "", "batched")
    summary = compare(torch, dev, cfg, model, prompts, out_k, out_p, "",
                      mode="bars")
    t_plain = out_p[4]
    del out_p
    ops.reset_launches()
    cp, rep_s, t_seq = compress(torch, data, policy_for("mixed"),
                                "sequential")
    del cp
    seq_launches = dict(ops.LAUNCHES)
    check_path(seq_launches, ("awp_pgd_step", "topk_row", "quant_project"),
               "the sequential compression")
    engines = hold_reports(torch, out_k[0], rep_s, "engines mixed",
                           7 * cfg.num_layers, iters_equal=True)
    log(f"[engines mixed] compression on the kernels: batched "
        f"{out_k[4]:.2f}s, sequential {t_seq:.2f}s; batched plain "
        f"{t_plain:.2f}s; launches batched {launches}, sequential "
        f"{seq_launches}")
    per_block, _ = count_waits(torch, data, policy_for("mixed"), "mixed ")
    return launches, out_k[1], dict(
        batched_s=out_k[4], sequential_s=t_seq, batched_plain_s=t_plain,
        kernels_vs_plain=summary, engines=engines, waits_per_block=per_block)


def phase_prune_path(torch, cfg, data):
    """The Table-1 prune policy on blocks 0 and 1 at full width, which
    reaches ``prune_batched_compacted`` with buckets {wq, wo}, {wk, wv},
    {wg, wu} at B = 2 (wd alone): the batched engine on the kernels
    (counted), the same through the plain versions, held to it, then the
    sequential driver on the kernels (counted), held to the batched one."""
    from repro_torch import kernels
    from repro_torch.kernels import ops
    pol = policy_for("table1")
    ops.reset_launches()
    cp, rep_b, t_b = compress(torch, data, pol, "batched")
    del cp
    launches = dict(ops.LAUNCHES)
    log(f"[prune] launches on the prune path: {launches}")
    check_path(launches, PRUNE_PATH, "the prune path")
    ops.reset_launches()
    with kernels.use_impl("reference"):
        cp, rep_p, t_p = compress(torch, data, pol, "batched")
    del cp
    check(not any(ops.LAUNCHES.values()), "the plain prune run launched a "
                                          "kernel")
    plain = hold_reports(torch, rep_b, rep_p, "prune kernels-plain", 14,
                         iters_equal=False)
    ops.reset_launches()
    cp, rep_s, t_s = compress(torch, data, pol, "sequential")
    del cp
    seq_launches = dict(ops.LAUNCHES)
    check_path(seq_launches, ("awp_pgd_step", "topk_row"),
               "the sequential prune")
    held = hold_reports(torch, rep_b, rep_s, "engines table1", 14,
                        iters_equal=True)
    iters = {r.qualname: rep_b.artifacts[r.qualname].result.iters
             for r in rep_b}
    log(f"[prune] Table-1 policy, blocks 0-1: batched {t_b:.2f}s, "
        f"sequential {t_s:.2f}s on the kernels, batched plain {t_p:.2f}s; "
        f"iterations {iters}; sequential launches {seq_launches}")
    return launches, dict(batched_s=t_b, sequential_s=t_s,
                          batched_plain_s=t_p, kernels_vs_plain=plain,
                          engines=held, iters=iters)


def engine_trace(cfg):
    """The engine's requests: the serve CLI's Zipf trace and two long
    prompts beyond the largest bucket."""
    from repro_torch.data import DataConfig, ZipfMarkov
    from repro_torch.launch.serve import build_trace
    from repro_torch.serving import GenerationRequest
    reqs = build_trace(cfg, **TRACE)
    longest = max(p for p, _ in LONG)
    toks, _ = ZipfMarkov(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=longest, global_batch=len(LONG),
                                    seed=SEED + 1)).batch(0)
    for i, (plen, new) in enumerate(LONG):
        reqs.append(GenerationRequest(
            rid=len(reqs), prompt=toks[i, :plen].astype("int32"),
            max_new_tokens=new))
    return reqs


@contextlib.contextmanager
def host_waits(torch, on: bool):
    """With ``on``, PyTorch's sync-debug mode warns at every wait of the
    host on the card; the waits (and the count of other warnings) are in
    the yielded dict when the block ends (``caught`` is every warning so
    far, while it runs). Off, nothing changes."""
    out = {"syncs": [], "other": 0, "caught": []}
    if not on:
        yield out
        return
    with warnings.catch_warnings(record=True) as caught:
        out["caught"] = caught
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out["syncs"] = [w for w in caught if SYNC_WARNING in str(w.message)]
    out["other"] = len(caught) - len(out["syncs"])


def run_engine(torch, model, packed, reqs, label, watch_waits=False):
    """One engine run over ``reqs`` (warm-up first, uncounted): launch
    counts set to 0 just before the run and read just after,
    ``check_invariants`` after every step, and the time of every step.
    ``watch_waits`` also counts the host's waits on the card and fails
    unless there is exactly one a step."""
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine, EngineConfig, cache_is_finite
    engine = Engine(model, packed, EngineConfig(**ENGINE))
    engine.warmup(reqs)
    torch.cuda.synchronize()
    steps = []          # (seconds, admitted in the step)
    last = [0.0, 0]     # end of the previous step, admissions so far

    def hook(eng):
        # every step ends in a host read of its tokens, so the host clock
        # sees the device's work done
        eng.check_invariants()
        now = time.perf_counter()
        admits = eng.prefill_dispatches + eng.chunk_dispatches
        steps.append((now - last[0], admits != last[1]))
        last[0], last[1] = now, admits

    ops.reset_launches()
    with host_waits(torch, watch_waits) as waits:
        t0 = last[0] = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        results = engine.run(step_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if watch_waits:
        # one wait a step: the decode step's (S, 2) read, a prefill's
        # first tokens, a chunked prompt's last token
        reads = (engine.decode_steps + engine.prefill_dispatches
                 + engine.chunked_admitted)
        where = sorted({f"{Path(w.filename).name}:{w.lineno}"
                        for w in waits["syncs"]})
        log(f"[{label}] host waits on the card: {len(waits['syncs'])} for "
            f"{reads} steps and admissions, at {where}; "
            f"{waits['other']} other warnings")
        check(len(waits["syncs"]) == reads,
              f"{label}: {len(waits['syncs'])} host waits, expected one a "
              f"step or admission ({reads})")
    by_rid = {r.rid: r for r in results}
    check(sorted(by_rid) == [r.rid for r in reqs], f"{label}: results")
    for r in reqs:
        res = by_rid[r.rid]
        check(res.status == "ok" and len(res.tokens) == r.max_new_tokens,
              f"{label}: rid {r.rid} ended {res.status} with "
              f"{len(res.tokens)}/{r.max_new_tokens} tokens {res.error}")
        check(all(0 <= t < model.cfg.vocab_size for t in res.tokens),
              f"{label}: rid {r.rid} tokens out of the vocabulary")
    check(cache_is_finite(engine.kv), f"{label}: non-finite KV cache")
    n_tok = sum(len(r.tokens) for r in results)
    dec = [t for t, admitted in steps if not admitted]
    stats = dict(wall_s=wall, steps=len(steps),
                 decode_steps=engine.decode_steps, tokens=n_tok,
                 tok_s=n_tok / wall,
                 step_ms=1e3 * wall / max(engine.decode_steps, 1),
                 decode_only_step_ms=1e3 * sum(dec) / max(len(dec), 1),
                 decode_only_steps=len(dec),
                 admission_s=sum(t for t, a in steps if a),
                 kv_bytes=engine.kv_cache_bytes(),
                 prefills=engine.prefill_dispatches,
                 chunks=engine.chunk_dispatches,
                 chunked=engine.chunked_admitted,
                 utilization=engine.utilization())
    log(f"[{label}] {len(reqs)} requests, {n_tok} tokens in {wall:.3f}s "
        f"({stats['tok_s']:.1f} tok/s); {engine.decode_steps} decode steps, "
        f"{stats['step_ms']:.2f} ms a step overall, "
        f"{stats['decode_only_step_ms']:.2f} ms a decode-only step "
        f"({len(dec)} steps), {stats['admission_s']:.3f}s in steps with "
        f"admissions ({engine.prefill_dispatches} prefills, "
        f"{engine.chunk_dispatches} chunks for {engine.chunked_admitted} "
        f"long prompts); slot utilization {stats['utilization']:.3f}; "
        f"KV cache {stats['kv_bytes'] / 1e6:.1f} MB (INT8)")
    log(f"[{label}] launches: {launches}")
    del engine
    torch.cuda.empty_cache()
    return launches, {r.rid: r.tokens for r in results}, stats


def phase_engine(torch, cfg, model, packed, tag, exact_first):
    """The engine through the kernels (K4, K5 and K6 must launch), then
    through the plain versions (nothing may launch), on the same packed
    model and trace. Greedy tokens are compared; with ``exact_first`` the
    first token of every request must be equal on both paths."""
    from repro_torch import kernels
    reqs = engine_trace(cfg)
    plens = sorted(r.prompt_len for r in reqs)
    log(f"[{tag}engine] {len(reqs)} requests, prompts {plens[0]}.."
        f"{plens[-1]} tokens ({sum(p > ENGINE['prompt_buckets'][-1] for p in plens)}"
        f" beyond the largest bucket), {sum(r.max_new_tokens for r in reqs)}"
        f" new tokens; {ENGINE}")
    launches, tok_k, st_k = run_engine(torch, model, packed, reqs,
                                       f"{tag}engine kernels")
    check_path(launches, ENGINE_PATH, "the engine path")
    # the same run again, untimed by the numbers above, with every wait of
    # the host on the card counted (sync-debug mode)
    _, tok_w, st_w = run_engine(torch, model, packed, reqs,
                                f"{tag}engine kernels, waits counted",
                                watch_waits=True)
    check(tok_w == tok_k, "the engine's tokens differ between two runs")
    with kernels.use_impl("reference"):
        plain_launches, tok_p, st_p = run_engine(torch, model, packed, reqs,
                                                 f"{tag}engine plain")
    check(not any(plain_launches.values()),
          "the plain engine run launched a kernel")
    same = [rid for rid in tok_k if tok_k[rid] == tok_p[rid]]
    parts = {rid: next(i for i, (a, b) in enumerate(zip(tok_k[rid],
                                                         tok_p[rid]))
                       if a != b)
             for rid in tok_k if rid not in same}
    first_equal = sum(tok_k[rid][0] == tok_p[rid][0] for rid in tok_k)
    log(f"[{tag}engine] kernels against plain: {len(same)}/{len(tok_k)} "
        f"requests with identical tokens; first parting position of the "
        f"others {parts}; first tokens equal in {first_equal}/{len(tok_k)}")
    check(not exact_first or first_equal == len(tok_k),
          "first tokens differ between the kernel and plain engine paths")
    return launches, dict(kernels=st_k, waits_counted=st_w, plain=st_p,
                          identical=len(same),
                          requests=len(tok_k), parts=parts,
                          first_equal=first_equal)


def phase_parity():
    """Both paths again in a second process with unsplit cuBLAS, where
    they must agree bit for bit (see the module docstring)."""
    log(f"[parity] chip_smoke.py {PARITY} with "
        f"CUBLAS_WORKSPACE_CONFIG={UNSPLIT_CUBLAS}")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=UNSPLIT_CUBLAS)
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           PARITY], env=env, timeout=900)
    check(proc.returncode == 0,
          f"the parity run failed with exit code {proc.returncode}")


def parity_main(torch, dev, cfg):
    """Under unsplit cuBLAS: the sequential driver's kernel and plain paths
    must give the same bits and tokens; the batched
    engine's must too if cuBLAS's strided-batched product sums in the
    plain K1b's order as K1b does — if not, the first differing layer is
    recorded and the pair held to the bars; then the engine."""
    check(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == UNSPLIT_CUBLAS,
          f"{PARITY} needs CUBLAS_WORKSPACE_CONFIG={UNSPLIT_CUBLAS}")
    data = setup(torch, dev, cfg)
    model, _, _, prompts = data
    for engine, mode in (("sequential", "bits"), ("batched", "bits_if_same")):
        tag = f"parity {engine} "
        _, out_k, out_p = both_paths(torch, dev, data, tag, engine)
        compare(torch, dev, cfg, model, prompts, out_k, out_p, tag, mode)
        packed = out_k[1]
        del out_k, out_p
        torch.cuda.empty_cache()
    del data
    torch.cuda.empty_cache()
    phase_engine(torch, cfg, model, packed, "parity ", exact_first=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "script needs a CUDA card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        sys.exit(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}"
                 f" — run it from a checkout of the repository")
    args = sys.argv[1:]
    check(args in ([], [PARITY]), f"unknown arguments {args}")
    sys.path.insert(0, str(SRC))
    t_start = time.time()
    dev = torch.device("cuda")

    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    if args:
        parity_main(torch, dev, cfg)
        return

    card = phase_card(torch)
    phase_build()
    rows = phase_kernels(torch, dev)
    data = setup(torch, dev, cfg)
    launches, packed, comp = phase_main_path(torch, dev, cfg, data)
    prune_launches, prune = phase_prune_path(torch, cfg, data)
    model = data[0]
    del data
    torch.cuda.empty_cache()
    eng_launches, eng = phase_engine(torch, cfg, model, packed, "",
                                     exact_first=False)
    del model, packed
    torch.cuda.empty_cache()
    phase_parity()

    out = []
    for name, (source, replaces) in KERNELS.items():
        row = rows[name]
        by_path = {"compress_decode": launches[name],
                   "prune": prune_launches[name],
                   "engine": eng_launches[name]}
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"], "shape": row["shape"]}
        for extra in ("dense", "by_shape"):
            if extra in row:
                entry[extra] = row[extra]
        out.append(entry)
    log(f"[compress] summary: {json.dumps(comp)}")
    log(f"[prune] summary: {json.dumps(prune)}")
    log(f"[engine] summary: {json.dumps(eng)}")
    log(f"[done] {time.time() - t_start:.1f}s; card {card}")
    log(json.dumps({"kernels": out}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
