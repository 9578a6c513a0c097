#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Builds the hand-written kernels K1–K6 (and K1b, K1 over a batch, K4x, K4
over a stack of experts, and K6p, K6 through a block table) from
``src/repro_torch/kernels/csrc``, holds each against its plain PyTorch
version at the shapes of the main paths (and a few edge cases), timing
both (K1 and K4 at every tile variant, K4's GEMV at every split, K2 at
every form, with a NaN/±inf matrix, ties, a 73728-wide row and a
misaligned view), then runs the MoE phase (:func:`phase_moe`):
qwen3-moe-235b-a22b at its published widths cut to 2 of its 94 layers
(d_model 4096, 64 heads over 4 KV heads of 128, 128 experts of d_ff 1536,
top-8, padded vocab 153600; 6.23e9 f32 parameters from the seed). K4x is
held to its plain version at E 8 and 128, both projections' (N, K), M
1-512, groups 128 and 64, shared and per-expert (strided, and misaligned)
x and every variant (at M <= 8 the expert GEMV also bit-equal to the
tile, with zeros off the integers too), and timed beside ``torch.matmul``
on the stack dequantized beforehand; K6 at its decode shape (g = 16, D =
128). The
model is compressed (batched engine, the mixed policy below, 16,384
calibration tokens), packed in memory and decoded statically through the
kernels and through the plain versions, the two held to the parity bars,
then served by the slot engine of 3 below on the kernels' packed model
(kernels, sync-debug, plain): only K4, K4x, K5 and K6 may launch, K4x
three times a layer in every forward, and K4x's census is timed key by
key (at the expert GEMV's keys beside the unsplit GEMV it replaced).
Then the evaluation phase (:func:`phase_methods`): llama2-7b at its
published widths cut to 1 of its 32 layers (d_model 4096, 32 MHA heads of
128, d_ff 11008, vocab 32000 padded to 32768, untied; 0.47e9 f32
parameters from the seed). The params go through the port's
``CheckpointManager`` and back bit for bit, and ``restore_checkpoint``
must refuse a packed checkpoint; perplexity on the compress CLI's four
held-out batches; then RTN, AWQ, Wanda+AWQ, AWQ+Wanda, AWP-S, SparseGPT,
GPTQ and AWP prune (ratio 0.5, 4 bits, group 128) each compress the model
through the batched engine on the kernels, with the host's waits counted a
block in sync-debug mode (only the method's kernels may launch), and
through the plain versions, the two held to the repo's bars, each with its
perplexity after; the four with packed artifacts are packed and their
perplexity through K4 held to the dense Θ's within 1e-4. SparseGPT and
GPTQ on block 0's wq run on the card and, the same f64 function, on the
CPU, held to each other; Fig. 1's loss trace of block 0's wo runs on the
kernels and plain; and K1, K1b and K3 are held and timed at llama2-7b's
linears (K2's and K4's new shapes join their censuses below, as the path
``methods``). Then the training phase (:func:`phase_train`): llama32-1b at
full depth and width from the seed trains 100 AdamW steps (batch 16 x 64,
lr 1e-3, 10 warmup steps, remat on; the train CLI's loop) in sync-debug
mode, the loss printed every 20 steps and required to fall, with the step
time, tokens/s, FLOP share, peak memory, host waits a step and the
gradient/update split; a save at step 10 restored by a fresh manager and
continued is held to the uninterrupted run's bits; microbatches 2 against
1; three Adafactor steps; the trained model is compressed by the main
path on the kernels and plain (held at the bars, each layer's PGD
iterations printed) and pruned by the Table-1 policy on blocks 0-1, with
perplexity at init, trained and compressed. Then the training phase of
the other families (:func:`phase_train_families`): qwen3-moe-235b-a22b
(2 layers, Adafactor), zamba2-1.2b (6 blocks), falcon-mamba-7b (2
layers), musicgen-medium (24 layers) and internvl2-1b (full depth) at
full width
from the seed, 12 steps each of the train step with the CLI's recipe in
sync-debug mode: the loss falling from step 0 to step 11, no host wait
between, the step time, tokens/s, FLOP share and peak memory; the MoE's
and zamba2's gradient as two microbatches against one; zamba2 resumed
from a save at step 6 and held to the uninterrupted run. Then the SSM
phase (:func:`phase_ssm`): zamba2-1.2b at full width over 6 of its 38
Mamba-2 blocks (and the shared attention + MLP block invoked before
them) and falcon-mamba-7b at full width over 2 of its 64 Mamba-1
layers (0.747e9 f32 parameters from the seed), each through the main
path: the mixed-policy compression with the batched engine on the
kernels in sync-debug mode (its host waits a block counted, only its path's
kernels launched), packing, prefill logits and the static greedy decode
over the recurrent state cache (K4 at every packed linear of every
forward), the kernels' packed model decoded again through the plain
versions (the same first tokens), the same main path through the plain
versions held at the bars with equal iterations, and the sequential
driver on blocks 0-1 held to the batched engine; K1, K1b and K3 at the
SSM linears; an ``ssm`` path in K4's and K2's censuses; and, after every
timed run of the process, one ``torch.profiler`` window over a prefill
and four decode steps of each arch (:func:`phase_ssm_profile`) splitting
the device time into the scans, K4 and the rest. Then the frontends
phase (:func:`phase_frontends`): musicgen-medium (audio: 24 of its 48
layers, frame embeddings in place of tokens) and internvl2-1b (vlm: 12
of its 24 layers, 256 patch embeddings ahead of the tokens) at full
width, and
starcoder2-7b at full width over 2 of its 32 layers, each calibrated on
16,384 positions from the port's ``make_batch`` and through the main
path on the kernels (the compression in sync-debug mode with its waits
counted a block; the packed loss and perplexity against the dense
result, a prefill of 4 x 128 frames or 4 x (256 patches + 128 tokens) or
4 x 128 tokens and, where the arch decodes tokens, 31 greedy steps; K4 at
every packed linear of every forward), the kernels' packed model served
again through the plain versions (the same first tokens), the first four
blocks (starcoder2-7b's two) compressed through the plain versions and
held to the kernels' at
the bars with equal iterations, the sequential driver on blocks 0-1 held
to the batched engine, and starcoder2-7b's packed model on the slot
engine of 3 below with every request's first token equal on the kernels
and plain (K5, and K6 at g = 9, D = 128); then K1, K1b and K3 at the new
linears and K6/K6p at starcoder2-7b's heads, and a ``frontends`` path in
K4's and K2's censuses. K6 and K6p are also
held and timed at nemotron-4-340b's heads (g = 12, D = 192) among the
kernel checks. Then it drives the port at the full width of llama32-1b (16 layers,
d_model 2048, d_ff 8192, padded vocab 129024, random weights from a
seed):

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
     decode step K6, every chunk of a long prompt K5;
  4. the paged engine on the same model: the engine of 3 over a pool of
     144 pages of 16 tokens (fewer than 8 slots of 2048 tokens need),
     serving the requests of 3 and 8 more behind one shared 256-token
     system prompt. Every decode step reads through the block tables with
     K6p, every chunk (long prompts and prefix-hit suffixes) expands its
     gathered pages with K5; requests are preempted (their pages spill to
     host memory) and resumed, and the prefix cache is hit. A spill and
     restore of a 97-page request must give back the same bytes.

Each path runs through the kernels, with every launch count set to 0 just
before and read just after, and the script checks that every kernel of
the path was launched, that no other was, and that the outputs are finite
and well-formed. K4's census (``ops.K4_CENSUS``: launches by M, N, K and
variant) of the static decode and the two engines is then checked (every
variant within 1e-5 of its plain version) and timed shape by shape —
kernel, plain version, and ``torch.mm`` on the weight dequantized
beforehand — and each path's K4 device seconds printed. K2's census
(``ops.K2_CENSUS``: launches by rows, d, k and variant) of both engines on
paths 1 and 2 is held the same way: every form equal to the plain version
(``torch.equal``) at every key, timed beside the plain version and
``torch.topk``, and each path's K2 device seconds printed. Every path also
runs through the kernels' plain versions, held to the repo's parity bars
(and paths 1, 3 and 4 timed).
One more run of each engine through the kernels, in sync-debug mode and
apart from the timed ones, must show the host waiting on the card exactly
once a decode step, batched prefill, chunked prompt and preemption. A third
kernel run of each engine, timed by nothing, records K6's and K6p's census
(``ops.K6_CENSUS``: each launch's shapes and device clones of its lengths
and table); every decode step's lengths are then replayed on the kernel,
and each path's K6/K6p device seconds printed. Every engine run holds its
``metrics_snapshot()`` (the port's ``repro_torch.obs`` registry) to its
counters and prints it on an ``[obs]`` line. Last, after every timed run
and census, the profile phase: a fourth kernel run of the slot engine
(the paged engine's profiled run was cut for the dry-run phase), timed
by nothing, inside the port's ``StepTraceWindow`` (``torch.profiler``,
CPU and CUDA activity) from its first step to its last, whose tokens must
equal the timed run's and whose trace must hold K4's and K6's (K6p's)
kernel events at their launch counts; ``[profile]`` lines print the
device idle share of decode-only and admission steps, busy ms and kernels
a step, the top device and host ops, the longest idle gaps and what the
host was in at each; then one batched compression with block 1 in a
``trace_window``, whose codes and masks must equal the timed run's; after
the SSM profile the MoE slot engine once more in a ``StepTraceWindow``
(:func:`phase_moe_profile`): its tokens the timed run's, the expert
GEMV's kernel events K4x's launches of it, and a ``[moe profile]`` line
with the decode-only steps' idle share and K4x's share of their kernel
time. Then
sampled tokens (:func:`check_sampling`): the reference's probe tokens
from the card's Threefry-2x32 sampler, and the slot and paged engines on
a sampled trace with every ``sample_tokens`` call held to the same
function on the CPU over a host copy of its inputs (a differing token
fails unless the card's top-two margin is under 1e-5, relative; near-ties
are counted). Then the dry-run phase (:func:`phase_dryrun`):
``repro_torch.launch.dryrun`` on this host (a fake process group, meta
tensors) predicts llama32-1b's bf16 train step at 8 × 1024 on one rank,
and the same step runs on the card: its FlopCounterMode count must equal
the prediction and its peak memory be within 1% of it; the step time is
printed beside the roofline's bound, and the cheapest production cell
(granite-8b decode_32k on 256 ranks) runs on this host too. Right after
the kernel checks ``awp_prune_fused`` (K1 then K2, 20 iterations at
llama32-1b's wd) is held to its plain loop, bit for bit in the parity
process; its launches are the ``prune_fused`` path. Last, the
multi-device phase (:func:`phase_distributed`),
after every timed host-bound run: one one-rank NCCL process group on the
card (NCCL refuses two ranks on one device, so every collective is the
identity; no fallback to gloo), a (1, 1) ("data", "model") mesh, the
row-sharded AWP loop at llama32-1b's wd shape (K1, K2) bit-equal to the
unsharded loop, the column-sharded loop (K2) bit-equal to the unsharded
plain loop, ``calib_c_distributed`` held to XᵀX/n, and llama32-1b at full
width for 3 steps each of the plain step, ``make_train_step_ddp`` (plain
sync bit-equal to the plain step; int8 sync bit-equal to the plain step
fed int8 round-tripped gradients) and the DTensor-sharded step (within
tests/test_distribution.py's bars), with step times. The MoE phase adds
``moe_apply_a2a`` on one qwen3-moe layer of its packed model, with its own
one-rank NCCL group: packed experts through K4x and the experts
dequantized once, each held to the masked dense path within 2e-4, no
token dropped. These launches (K1, K2, K4x) are the ``distributed`` path
of ``launches_by_path``. This first process, with every time in its JSON
line, runs cuBLAS in its default configuration, as the port's CLIs do.

cuBLAS splits K for short products (measured on the H100: 256-, 512- and
1024-row f32 products), so the plain K1 sums each output in another order
than the kernel's one FMA chain, and PGD turns those last-ulp differences
into code and mask flips. A second process (``chip_smoke.py --parity``,
started by the first) therefore runs with ``CUBLAS_WORKSPACE_CONFIG=:0:0``:
with no workspace cuBLAS cannot split, so every product sums in K1's and
K4's order. There K1's Z must equal its plain version bit for bit at its
four shapes with every tile variant (K1b at its four shapes as the batched
engine below), K4's tile its plain version's y at the four packed linears'
(N, K), M 64, 512 and 4096, with every tile variant, then paths 1, 3 and 4
run again, and the kernels' path must
equal the plain one with the sequential driver — same iteration counts,
same greedy tokens on the static path — and the same first token of every
engine request (prefill is K4's tile path and K5, which is exact; K6 and K6p sum
in tile order, so later engine tokens may part). With the batched engine
the plain K1b is cuBLAS's strided-batched product: if it also sums in
K1b's order the two paths must agree as well; if not, the first differing
layer is printed and the pair held to the bars. Before them the MoE phase
runs again: K4x's tile bit-equal to its plain version (the expert GEMV
bit-equal to the tile at M <= 8), the MoE
compression with its host waits counted a block in sync-debug mode, its
codes, masks and static tokens the same bits on both paths if the
compressions agree, and every slot-engine request's first token equal;
and after the training parity the SSM parity (:func:`parity_ssm`): each
arch's packed model gives the same greedy tokens through K4 and through
the plain versions, and its compression on the kernels and plain is held
at the bars (the same bits, then the same tokens, if it agrees); then the
frontends parity (:func:`parity_frontends`): each arch's packed model
gives the same loss, prefill logits and greedy tokens through K4 and
through the plain versions, its first four blocks compress to the same
bits on both, and every starcoder2-7b slot-engine request gets the same
first token. The parity process runs no engine in sync-debug mode: the
first process counts those waits.

Exits non-zero on any failed check, without a CUDA card, and outside a
checkout of the repository. Prints the card, a JSON line of per-kernel
numbers, and last ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
# the paged engine phase: the slot phase's engine over a pool of 16-token
# pages, too small for every request at once and big enough for one
# max_len request (128 pages). The page decisions depend only on token
# counts and prompt tokens; at 144 pages the trace below preempts twice in
# decode extension and hits the prefix cache 7 times (a narrow model with
# the same vocabulary and trace on the CPU makes the same decisions)
PAGED_ENGINE = dict(ENGINE, kv_layout="paged", page_size=16, num_pages=144)
# its traffic beyond the slot phase's: requests behind one shared system
# prompt (16 full pages), Zipf tails of 1..200 tokens, 16 new tokens each
PREFIX = dict(requests=8, prefix=256, max_tail=200, new=16)
# what PyTorch's sync-debug mode warns at each wait of the host on the card
# (its other warning, that the mode is a prototype, is not a wait)
SYNC_WARNING = "called a synchronizing CUDA operation"
# K4's rows: static decode, engine decode (8 slots), one short prompt, one
# prompt of 512, 8 prompts of 512; at the four packed linears' (N, K): wq;
# wk and wv; wg and wu; wd (wo is pruned and stays dense)
K4_M = (4, 8, 64, 512, 8 * 512)
K4_NK = ((2048, 2048), (512, 2048), (8192, 2048), (2048, 8192))
# the MoE phase: qwen3-moe-235b-a22b at its published widths, 2 of its 94
# layers; K4x at its expert counts (E 8 and qwen3-moe's 128), its rows
# (decode 1-8, a short prompt, a prompt of 512) and (N, K) of wg/wu and wd,
# and K4x's row in the JSON line: the slot engine's decode (M = 8) at wg/wu,
# shared x
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 2
# the parity process's repeat of the MoE main path and slot engine: one
# layer (its 2 layers cost about 30 s there; 2 until the multi-device
# phase came)
PARITY_MOE_LAYERS = 1
K4X_E = (8, 128)
K4X_M = (1, 4, 8, 64, 512)
K4X_NK = ((1536, 4096), (4096, 1536))
K4X_ROW = (128, 8, 1536, 4096, False)
# K4's representative row in the JSON line: the static decode at wg, wu
K4_ROW = (4, 8192, 2048)
# the serving paths whose K4 launches the census counts
K4_PATHS = ("static", "slot", "paged")
# K6 at the engine's decode shape: 8 slots, 32 heads over 8 KV heads, D 64
K6_LENGTHS = (0, 1, 255, 256, 1000, 1536, 2047, 2048)
# the length sets K6 and K6p are timed at: the census above; rows like the
# engines' traffic (prompts of 1-281 tokens plus their new tokens, so every
# split past the first two is empty); rows of a few tokens, where the fixed
# cost of the split and the merge weighs most; one row of 2048 tokens alone
K6_SETS = {"census": K6_LENGTHS,
           "short rows": (0, 1, 17, 64, 130, 200, 281, 300),
           "few-token rows": (1, 2, 3, 4, 5, 6, 7, 8),
           "one long row": (2048,)}

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
    "dequant_matmul_experts": ("src/repro_torch/kernels/csrc/dequant_matmul.cu",
                               "src/repro/models/layers.py:58"),
    "kv_dequant": ("src/repro_torch/kernels/csrc/kv_dequant.cu",
                   "src/repro/kernels/kv_dequant.py:29"),
    "decode_attn": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                    "src/repro/kernels/decode_attn.py:134"),
    "decode_attn_paged": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                          "src/repro/kernels/decode_attn.py:163"),
}
COMPRESS_PATH = ("awp_pgd_step", "awp_pgd_step_batched", "topk_row",
                 "quant_project", "dequant_matmul")
PRUNE_PATH = ("awp_pgd_step", "awp_pgd_step_batched", "topk_row")
ENGINE_PATH = ("dequant_matmul", "kv_dequant", "decode_attn")
# the MoE phase: compress (K1, K1b, K2, K3) then static decode (K4 for the
# attention's packed linears, K4x for the experts'); its slot engine
MOE_PATH = ("awp_pgd_step", "awp_pgd_step_batched", "topk_row",
            "quant_project", "dequant_matmul", "dequant_matmul_experts")
MOE_ENGINE_PATH = ("dequant_matmul", "dequant_matmul_experts", "kv_dequant",
                   "decode_attn")
PAGED_PATH = ("dequant_matmul", "kv_dequant", "decode_attn_paged")
# K6p at the paged engine's decode shape: pages of 16 tokens, tables of
# 128 pages (max_len 2048) into a pool of 512 pages
K6P_PAGE, K6P_PAGES, K6P_POOL = 16, 128, 512
# K1 at the four linears' shapes: wq and wo, wk and wv, wg and wu, wd
K1_SHAPES = ((2048, 2048), (512, 2048), (8192, 2048), (2048, 8192))
# K1b at the batched engine's buckets: {wk, wv}, {wg, wu} and {wq, wo}
K1B_SHAPES = ((2, 512, 2048), (2, 8192, 2048), (2, 2048, 2048),
              (3, 512, 2048))
# the main path's buckets at B = 2: 16 blocks x {wk, wv} and {wg, wu} x 10
# quantization steps
K1B_MAIN_LAUNCHES = 16 * 2 * 10
# the compression block wrapped in a torch.profiler window
PROFILE_BLOCK = 1
# the engines' parity bars (tests/test_torch_compress.py,
# tests/test_torch_batched.py): per-layer loss, share of equal entries
LOSS_BAR, AGREE_BAR = 1e-5, 0.999
# the evaluation phase: llama2-7b at its published widths, 1 of its 32
# layers (2 until the training phase of the other families came: each
# method's compression takes time in proportion to the depth, and the
# script must finish inside its budget); the compress CLI's defaults (4 calibration and 4 held-out batches
# of 8 x 64 tokens); the methods the port added and AWP prune, each at
# ratio 0.5, 4 bits, group 128, with the kernels it launches in
# compression (the four with packed artifacts add K4 in their packed
# perplexity pass)
METHODS_ARCH, METHODS_LAYERS = "llama2-7b", 1
EVAL_BATCH, EVAL_SEQ, EVAL_BATCHES = 8, 64, 4
METHODS = {"rtn": (), "awq": ("quant_project",),
           "wanda_awq": ("quant_project",), "awq_wanda": ("quant_project",),
           "awp_quant_scaled": ("awp_pgd_step", "quant_project"),
           "sparsegpt": (), "gptq": (),
           "awp_prune": ("awp_pgd_step", "awp_pgd_step_batched", "topk_row")}
PACKED_METHODS = ("rtn", "awq", "awp_quant_scaled", "gptq")
METHODS_PATH = ("awp_pgd_step", "awp_pgd_step_batched", "topk_row",
                "quant_project", "dequant_matmul")
# K1, K1b and K3 at llama2-7b's linears: {wq, wk, wv, wo}, {wg, wu}, wd
LLAMA2_K1 = ((4096, 4096), (11008, 4096), (4096, 11008))
LLAMA2_K1B = ((4, 4096, 4096), (2, 11008, 4096))
# the packed model's perplexity against the dense Θ's, relative; the Fig.-1
# loss traces, kernels against plain, and their largest rise a step
# (tests/test_awp.py:74-80)
PPL_BAR, TRACE_BAR, TRACE_RISE = 1e-4, 2e-4, 1e-4
# K6 and K6p at nemotron-4-340b's heads (H, Hk, D) at the engines' T and
# INT8 group: g = 12 at D = 192, the generic form's 32 accumulators a lane
NEMOTRON_HEADS = (96, 8, 192, 2048, 64)
# the training phase: llama32-1b at full width with the train CLI's
# defaults (batch 16 x 64, AdamW) and benchmarks/common.py's recipe (lr
# 1e-3, a tenth of the steps to warm up), cut from the recipe's 200 steps
# to 100 to make room for the multi-device phase; the loss printed every
# 20 steps; the median step time over the steps from TRAIN_WARMUP on
TRAIN = dict(steps=100, batch=16, seq=64, lr=1e-3, log_every=20)
TRAIN_WARMUP = 5
# the resume check: save at step RESUME_K, RESUME_K more steps after the
# restore against 2·RESUME_K uninterrupted ones. Bit-equal is the goal; if
# bits part, each differing entry is bounded by a near-zero gradient whose
# sign flipped every step, 2·lr a step
RESUME_K = 10
RESUME_BOUND = 2 * TRAIN["lr"] * RESUME_K
# microbatches 2 against 1 on one batch: the accumulated gradient equals
# the mean of the two interleaved halves' own gradients bit for bit, and
# differs from the single batch's, leaf by leaf, by at most MICRO_BAR of
# the leaf's norm. cuBLAS's default (split-K) sums a 512-token product in
# another grouping than a 1024-token one, and on the trained model a
# step's gradient is the small mean of much larger per-token terms: up to
# 2.4e-4 there on an H100 (scripts/train_microbatch_probe.py), and the
# rounding floor (reordered rows) under unsplit cuBLAS, where the --parity
# process holds the pair at MICRO_PARITY_BAR
MICRO_BAR, MICRO_PARITY_BAR = 1e-3, 1e-5
# the trained model's compression (no packed linear runs there)
TRAIN_COMPRESS_PATH = ("awp_pgd_step", "awp_pgd_step_batched", "topk_row",
                       "quant_project")
# the SSM phase: zamba2-1.2b and falcon-mamba-7b at full width, each with
# one cut: falcon's depth 64 -> 2 layers (one block's AWP-int4 step is 2 x
# 5.5e11 operations: 64 blocks on the kernels and again plain would take
# over 10 minutes of the 1200 s limit; 4 layers until the training phase
# of the other families came); zamba2's 38 -> 6 Mamba-2 blocks (one
# invocation of the shared attention block; 12 until the multi-device
# phase came), which keeps the whole script under its time budget beside
# the frontends phase (PERF.md keeps the 38-, 12- and 4-layer numbers)
SSM_ARCHS = ("zamba2-1.2b", "falcon-mamba-7b")
SSM_LAYERS = {"falcon-mamba-7b": 2, "zamba2-1.2b": 6}
# the kernels each arch's mixed-policy compression and static decode run:
# falcon-mamba-7b has no attention (nothing pruned, so no K2) and no two
# linears of one shape (no K1b)
SSM_PATH = {"zamba2-1.2b": COMPRESS_PATH,
            "falcon-mamba-7b": ("awp_pgd_step", "quant_project",
                                "dequant_matmul")}
# K1, K1b and K3 at the SSM linears: falcon's in_proj and out_proj,
# zamba2's out_proj; K1b at zamba2's {wz, wx}
SSM_K1 = ((16384, 4096), (4096, 8192), (2048, 4096))
SSM_K1B = ((2, 4096, 2048),)
# the profiled window: a prefill and four decode steps
SSM_PROFILE_STEPS = 4
SSM_SCAN = "ssm_scan"
# the frontends phase: musicgen-medium (audio: frame embeddings in place of
# tokens) and internvl2-1b (vlm: 256 patch embeddings ahead of the tokens)
# at full width, at 24 of 48 and 12 of 24 layers since the multi-device
# phase came (full depth before), and starcoder2-7b at full width with one
# cut,
# depth 32 -> 2 layers (one block's compression is about 8e13 operations,
# 1.7 s on the kernels: 32 blocks on the kernels and again plain would take
# about two minutes of the 1200 s limit; 4 layers until the training phase
# of the other families came). starcoder2-7b also serves the slot engine
# (K5, and K6 at g = 9, D = 128)
FRONTEND_ARCHS = ("musicgen-medium", "internvl2-1b", "starcoder2-7b")
FRONTEND_LAYERS = {"starcoder2-7b": 2, "musicgen-medium": 24,
                   "internvl2-1b": 12}
ENGINE_ARCH = "starcoder2-7b"
# the blocks the plain compression runs (at most the arch's depth), held to
# the kernels' first blocks (at the bars, and under unsplit cuBLAS bit for
# bit). Over all of
# musicgen-medium's 48 blocks the plain run takes 13.6 s (22.5 s under
# unsplit cuBLAS), past the phase's budget; and under cuBLAS's default
# (split-K) sums a pruned wo's mask parts by a few entries from block 5 on,
# and the drift that follows passes the 1e-5 loss bar by block 43
# (PERF.md, the frontends phase)
FRONTEND_PLAIN_BLOCKS = 4
# the sequential driver with the mixed policy: K1 alone, K2 at the pruned wo
PRUNE_QUANT_PATH = ("awp_pgd_step", "topk_row", "quant_project")
# K1 and K3 at the new linears, K1b at the new buckets: musicgen-medium's
# wq-wo, wu, wd and {wq, wk, wv}; internvl2-1b's wq and wo, wd, {wk, wv},
# {wg, wu}; starcoder2-7b's wq and wo, wu, wd, {wk, wv}
FRONTEND_K1 = ((1536, 1536), (6144, 1536), (1536, 6144), (896, 896),
               (896, 4864), (4608, 4608), (18432, 4608), (4608, 18432))
FRONTEND_K1B = ((3, 1536, 1536), (2, 128, 896), (2, 4864, 896),
                (2, 512, 4608))
# K6 and K6p at starcoder2-7b's heads (H, Hk, D) at the engines' T and INT8
# group: g = 9 at D = 128, the generic form
STARCODER_HEADS = (36, 4, 128, 2048, 64)
# the training phase of the other families: each arch through
# make_train_step with the train CLI's recipe (batch 16 x 64, lr 1e-3,
# warmup a tenth of the steps, remat on, seed 0) for FAMILY_STEPS steps
# in sync-debug mode; the median step time over the steps from
# FAMILY_WARMUP on. (arch, optimizer): qwen3-moe at MOE_LAYERS layers with
# Adafactor (AdamW's moments would add 49.9 GB to 24.9 GB of params and as
# much of gradients); zamba2-1.2b and falcon-mamba-7b at SSM_LAYERS' depth;
# musicgen-medium at 24 of its 48 layers and internvl2-1b at full depth
# (256 patches ahead of 64 tokens a row)
TRAIN_FAMILIES = (("qwen3-moe-235b-a22b", "adafactor"),
                  ("zamba2-1.2b", "adamw"), ("falcon-mamba-7b", "adamw"),
                  ("musicgen-medium", "adamw"), ("internvl2-1b", "adamw"))
FAMILY_STEPS, FAMILY_WARMUP = 12, 2
# the families' depths: the SSM phase's, and musicgen-medium at the
# frontends phase's 24 of 48 layers (full depth until the multi-device
# phase came)
FAMILY_LAYERS = {**SSM_LAYERS,
                 "musicgen-medium": FRONTEND_LAYERS["musicgen-medium"]}
# the archs whose microbatched gradient is held to the single batch's at
# MICRO_BAR, and the one resumed: saved at step FAMILY_RESUME_K, restored
# and continued to 2·FAMILY_RESUME_K (zamba2's state is 5.9 GB; the
# others' 7-16 GB would cost the budget in disk writes)
FAMILY_MICRO = ("qwen3-moe-235b-a22b", "zamba2-1.2b")
FAMILY_RESUME, FAMILY_RESUME_K = "zamba2-1.2b", FAMILY_STEPS // 2
FAMILY_RESUME_BOUND = 2 * TRAIN["lr"] * FAMILY_RESUME_K


# sampled tokens on the card (:func:`check_sampling`): the reference's
# probe tokens (logits default_rng(0) (8, 1000) x 3, temperature 1, seeds
# and steps 0-7); a sampled trace for both engines, its (temperature,
# top-k) cycled over the requests (one greedy); a token the card samples
# differently from the CPU on the same logits fails the run unless the
# card's top-two margin is under NEAR_TIE, relative
SAMPLE_PROBE = [403, 615, 175, 801, 251, 427, 83, 543]
SAMPLED_TRACE = dict(num_requests=12, max_prompt=256, max_new=16,
                     seed=SEED + 3)
SAMPLED_PARAMS = ((0.8, 40), (1.0, 0), (1.3, 8), (0.0, 0), (0.7, 1))
NEAR_TIE = 1e-5
# the multi-device phase (:func:`phase_distributed`): one one-rank NCCL
# group after the profile phase. Sharded AWP at llama32-1b's wd shape
# (d_out 2048, d_in 8192, k = d_in / 2, C from 4096 seeded activations);
# DIST_STEPS steps of each train step at full width, the sharded one held
# to the plain one at tests/test_distribution.py's bars; the MoE phase's
# a2a check on one layer, 4 x 128 tokens, capacity factor 8 (no token
# dropped), held to the masked dense path at A2A_BAR
DIST_AWP = dict(d_out=2048, d_in=8192, tokens=4096, iters=20)
DIST_STEPS = 3
DIST_LOSS_BAR, DIST_RTOL, DIST_ATOL = 2e-4, 2e-3, 2e-4
DIST_PATH = ("awp_pgd_step", "topk_row", "dequant_matmul_experts")
# awp_prune_fused (K1 then K2 an iteration) at llama32-1b's wd, as the
# reference's test_kernels.py holds it against its plain loop
FUSED_SHAPE, FUSED_ITERS = (2048, 8192), 20
FUSED_PATH = ("awp_pgd_step", "topk_row")
# the dry run on the card's host: llama32-1b's train_4k cell cut to a
# batch and sequence one card holds (one rank, a (1, 1) mesh), bf16
# params, AdamW, remat, one microbatch; then the same step for real
DRYRUN_BATCH, DRYRUN_SEQ, DRYRUN_STEPS = 8, 1024, 3
# the production cell run on the card's host (the cheapest decode cell)
DRYRUN_PRODUCTION = ("granite-8b", "decode_32k", "single")
# the card's peak over the predicted total: +0.0013 measured (one H100 at
# 700 W); the gap is the caching allocator's rounding of each block and
# the cuBLAS workspace the first product allocates, which the meta run
# has not got
DRYRUN_MEM_TOL = 0.01
A2A_TOKENS, A2A_CAPACITY, A2A_BAR = (4, 128), 8.0, 2e-4


def k1_variant(torch, b: int, m: int, k: int) -> int:
    """The tile variant K1's wrapper picks for a (b, m, k) step on card 0."""
    from repro_torch.kernels import ops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return ops.awp_pgd_tiles(b, m, k, sms)[2]


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
# reading a torch.profiler Chrome trace
# ---------------------------------------------------------------------------

# what the card does (CUPTI's activity records) and what the host does
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
STEP_SPAN = "ProfilerStep#"


def _union(intervals):
    """Sorted, disjoint [start, end] lists covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(merged, start, end):
    """How much of [start, end] the sorted, disjoint ``merged`` covers."""
    i = max(bisect.bisect_right(merged, [start, math.inf]) - 1, 0)
    got = 0.0
    while i < len(merged) and merged[i][0] < end:
        got += max(0.0, min(merged[i][1], end) - max(merged[i][0], start))
        i += 1
    return got


def _inside(windows):
    """A test of whether a time lies inside one of the sorted, disjoint
    ``windows``."""
    starts = [w["start"] for w in windows]

    def test(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts < windows[i]["end"]
    return test


def read_profile(events):
    """A Chrome trace's events, read once: its step windows (one a
    ``ProfilerStep#N`` span on the host; without any, one window over the
    whole trace, step -1), each with its length, the union of the card's
    kernel, copy and memset intervals clipped to it (``busy_ms``), the
    device idle share (1 - busy / length), the kernels that start in it,
    the union of the host ops on the stepping thread (``host_ms``: the
    rest of the window is Python outside any op), and the window cut at
    that thread's first and last kernel launch call (``lead_ms`` before
    the first, ``dispatch_ms`` from the first to the end of the last,
    ``tail_ms`` after it); the count of every
    kernel by name; and the device and host spans and the card's merged
    busy intervals, for :func:`device_ops`, :func:`host_ops` and
    :func:`idle_gaps`."""
    marks, dev, host = {}, [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat"), e.get("name", "")
        if name.startswith(STEP_SPAN):
            if cat == "user_annotation":
                marks[int(name[len(STEP_SPAN):])] = e
        elif cat in DEVICE_CATS:
            dev.append(e)
        elif cat in HOST_CATS:
            host.append(e)
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    if marks:
        wins = [(k, marks[k]["ts"], marks[k]["ts"] + marks[k]["dur"])
                for k in sorted(marks)]
        first = marks[min(marks)]
        thread = (first.get("pid"), first.get("tid"))
        mine = [e for e in host if (e.get("pid"), e.get("tid")) == thread]
    else:
        wins = [(-1, min(e["ts"] for e in dev + host),
                 max(e["ts"] + e["dur"] for e in dev + host))]
        mine = host
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in mine
                   if e["cat"] != "cpu_op" and "Launch" in e["name"])
    mine = _union([(e["ts"], e["ts"] + e["dur"]) for e in mine])
    windows = [dict(step=step, start=start, end=end, ms=(end - start) / 1e3,
                    busy_ms=_covered(busy, start, end) / 1e3,
                    host_ms=_covered(mine, start, end) / 1e3, kernels=0)
               for step, start, end in wins]
    for w in windows:
        w["idle"] = 1.0 - w["busy_ms"] / w["ms"]
        i = bisect.bisect_left(calls, (w["start"],))
        j = bisect.bisect_left(calls, (w["end"],))
        first, last = ((calls[i][0], calls[j - 1][1]) if j > i
                       else (w["end"], w["end"]))
        w["lead_ms"] = (first - w["start"]) / 1e3
        w["dispatch_ms"] = (last - first) / 1e3
        w["tail_ms"] = (w["end"] - last) / 1e3
    starts = [w["start"] for w in windows]
    kernels = {}
    for e in dev:
        if e["cat"] == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
            i = bisect.bisect_right(starts, e["ts"]) - 1
            if i >= 0 and e["ts"] < windows[i]["end"]:
                windows[i]["kernels"] += 1
    return dict(windows=windows, kernels=kernels, device=dev, host=host,
                busy=busy)


def device_ops(prof, windows, n):
    """The ``n`` device ops with the most total time among those that
    start inside ``windows``: (name, ms, count)."""
    tot, inside = {}, _inside(windows)
    for e in prof["device"]:
        if inside(e["ts"]):
            ms, cnt = tot.get(e["name"], (0.0, 0))
            tot[e["name"]] = (ms + e["dur"] / 1e3, cnt + 1)
    return sorted(((k, ms, c) for k, (ms, c) in tot.items()),
                  key=lambda r: -r[1])[:n]


def host_ops(prof, windows, n):
    """The ``n`` host ops with the most self time (their length less their
    nested ops', on one thread) among those that start inside
    ``windows``: (name, ms, count)."""
    threads, inside = {}, _inside(windows)
    for e in prof["host"]:
        if inside(e["ts"]):
            threads.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    own, tot = {}, {}
    for evs in threads.values():
        stack = []
        for e in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            own[id(e)] = e["dur"]
            if stack:
                own[id(stack[-1])] -= e["dur"]
            stack.append(e)
        for e in evs:
            ms, cnt = tot.get(e["name"], (0.0, 0))
            tot[e["name"]] = (ms + own[id(e)] / 1e3, cnt + 1)
    return sorted(((k, ms, c) for k, (ms, c) in tot.items()),
                  key=lambda r: -r[1])[:n]


def idle_gaps(prof, windows, n):
    """The ``n`` longest stretches inside ``windows`` where the card runs
    nothing, each with the innermost host op open at its start ("" when
    none is: Python between ops): dicts of step, at_us (from the window's
    start), ms and host_op."""
    busy, gaps = prof["busy"], []
    for w in windows:
        t, end = w["start"], w["end"]
        i = max(bisect.bisect_right(busy, [t, math.inf]) - 1, 0)
        while t < end:
            if i == len(busy) or busy[i][0] >= end:
                gaps.append((end - t, t, w))
                break
            a, b = busy[i]
            i += 1
            if a > t:
                gaps.append((a - t, t, w))
            t = max(t, b)
    gaps.sort(key=lambda g: -g[0])
    out = []
    for length, t, w in gaps[:n]:
        inner = max((e for e in prof["host"]
                     if e["ts"] <= t < e["ts"] + e["dur"]),
                    key=lambda e: (e["ts"], -e["dur"]), default=None)
        out.append(dict(step=w["step"], at_us=t - w["start"],
                        ms=length / 1e3,
                        host_op=inner["name"] if inner else ""))
    return out


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
    from repro_torch.kernels import _build, ops
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
                k = re.search(r"[a-z][a-z_]*_kernel", raw)
                fn = k.group(0) if k else raw
                if k and raw[k.end():].startswith("I"):
                    # template arguments: integers (a leading n is a
                    # minus sign) and bools, in order
                    args = re.findall(r"L[ib](n?\d+)E",
                                      raw[k.end():].split("Ev", 1)[0])
                    fn += "<" + ", ".join(a.replace("n", "-")
                                          for a in args) + ">"
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
    lib = _build.library()
    for v, (bm, bn) in enumerate(ops.AWP_PGD_TILES):
        log(f"[build] awp_pgd.cu: variant {v} ({bm} x {bn} tile): "
            f"{lib.awp_pgd_smem_bytes(v)} B dynamic shared memory")
    for v in ops.dequant_matmul_variants(ops.GEMV_MAX_M, 2048):
        log(f"[build] dequant_matmul.cu: variant {v} "
            f"({ops.dequant_matmul_variant_name(v)}): "
            f"{lib.dequant_matmul_smem_bytes(v, ops.GEMV_MAX_M)} B dynamic "
            f"shared memory" + (
                f" at M = {ops.GEMV_MAX_M}" if len(ops.DEQUANT_TILES) <= v
                < ops.GEMVX else f" at M = {ops.GEMV_MAX_M}, group 32"
                if v == ops.GEMVX else ""))


def phase_kernels(torch, dev):
    """Each kernel against its plain version on the same inputs, with the
    kernel's time, the plain version's time and the bound."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rows = {}   # kernel -> representative (main-path) measurement

    # -- K1: Z = Θ + η(W−Θ)C at the four linear shapes --
    k1_shapes = [check_k1(torch, randn, m, k) for m, k in K1_SHAPES]
    rows["awp_pgd_step"] = dict(next(e for e in k1_shapes
                                     if e["shape"] == "M=2048,K=8192"))
    rows["awp_pgd_step"]["max_abs_err"] = max(e["max_abs_err"]
                                              for e in k1_shapes)
    rows["awp_pgd_step"]["by_shape"] = k1_shapes
    rows["awp_pgd_step_batched"] = check_k1b(torch, randn)

    rows["topk_row"] = check_k2(torch, dev, gen, randn)

    # -- K3: exact quantize-dequantize at the four shapes, bits 4 and 8 --
    for r, d, bits in ((8192, 2048, 4), (8192, 2048, 8), (2048, 8192, 4),
                       (2048, 8192, 8), (2048, 2048, 4), (512, 2048, 4)):
        entry = check_k3(torch, randn, r, d, bits)
        if (r, d, bits) == (8192, 2048, 4):
            rows["quant_project"] = entry

    rows["dequant_matmul"] = check_k4(torch, dev, gen, randn)
    rows["kv_dequant"] = check_k5(torch, dev, gen)
    rows["decode_attn"] = check_k6(torch, dev, gen)
    rows["decode_attn_paged"] = check_k6p(torch, dev, gen)
    for name, entries in check_k6_heads(torch, dev, NEMOTRON_HEADS,
                                        "nemotron", 22).items():
        rows[name]["by_lengths"] += entries
    return rows


def check_k1(torch, randn, m, k):
    """K1 at one (M, K): every tile variant within 1e-5 of max|Z| of the
    plain version (cuBLAS may split K into partial sums, another order
    than the kernel's one FMA chain an output) and its norm within 1e-5
    relative; the variant the wrapper picks timed beside the others, the
    plain version and ``torch.addmm`` (a yardstick the port never calls).
    Returns the JSON entry."""
    from repro_torch.kernels import ops, ref
    w, theta = randn(m, k), randn(m, k)
    c = randn(k, k) / math.sqrt(k)
    # the prune recipe's η = 2/‖C‖_F: not a power of two, so a fused
    # multiply-add in the epilogue would show
    eta = 2.0 / torch.linalg.matrix_norm(c)
    z_ref, nrm_ref = ref.awp_pgd_step(w, theta, c, eta)
    scale = float(z_ref.abs().max())
    chosen = k1_variant(torch, 1, m, k)
    times, err = {}, 0.0
    for v in range(len(ops.AWP_PGD_TILES)):
        z, nrm = ops.awp_pgd_step(w, theta, c, eta, variant=v)
        err_v = float((z - z_ref).abs().max())
        nerr = float((nrm - nrm_ref).abs() / nrm_ref)
        check(err_v <= 1e-5 * scale and nerr <= 1e-5,
              f"K1 {(m, k)} variant {v}: max|dZ| {err_v:.3e} "
              f"(|Z| {scale:.3e}), norm rel err {nerr:.3e}")
        err = max(err, err_v)
        times[v] = time_ms(torch, lambda i: ops.awp_pgd_step(
            w, theta, c, eta, variant=v), 5)
    ms = times[chosen]
    plain = time_ms(torch, lambda i: ref.awp_pgd_step(w, theta, c, eta), 5)
    flops = 2.0 * m * k * k
    bnd, by = bound_ms(flops, 4.0 * (3 * m * k + k * k))
    eta_f = float(eta)
    lib_ms = time_ms(torch, lambda i: torch.addmm(
        theta, w - theta, c, alpha=eta_f), 5)
    log(f"[K1] awp_pgd_step {(m, k)}: variant {chosen} "
        f"{ops.AWP_PGD_TILES[chosen]}, max|dZ| {err:.2e} "
        f"(|Z|max {scale:.2f}), kernel {ms:.3f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s, {bnd / ms:.0%} of the bound), "
        f"addmm {lib_ms:.3f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s), "
        f"plain {plain:.3f} ms, bound {bnd:.3f} ms ({by}); variants "
        + ", ".join(f"{v}: {t:.3f} ms" for v, t in times.items()))
    return dict(shape=f"M={m},K={k}", variant=chosen, ms=ms, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                max_abs_err=err, variant_ms=times)


def check_prune_fused(torch, dev):
    """``ops.awp_prune_fused`` (the reference's fused pruning loop: K1's
    step then K2's top-k, ``FUSED_ITERS`` times from Θ₀ = topk(W)) at
    llama32-1b's wd against its plain loop (``use_pallas=False``) on the
    same inputs: under default cuBLAS the plain loop's split-K sums may
    put a few row entries on the other side of the k-th magnitude, so the
    two are held at the reference's per-layer loss bar (the Fig.-1 loss
    within 1e-5 relative) and the differing mask entries are printed; the
    parity process holds the bits (:func:`parity_kernels`). Returns the
    kernel loop's K1 and K2 launches."""
    from repro_torch.core.awp import activation_loss
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    m, k = FUSED_SHAPE
    w, c, eta, keep = fused_inputs(torch, dev, gen, m, k)
    theta0 = ops.topk_row(w, keep)
    before = dict(ops.LAUNCHES)
    th, ms = _event_ms(torch, lambda: ops.awp_prune_fused(
        w, c, keep, eta, FUSED_ITERS, theta0=theta0))
    launches = {n: ops.LAUNCHES[n] - before[n] for n in ops.LAUNCHES}
    th_p, plain = _event_ms(torch, lambda: ops.awp_prune_fused(
        w, c, keep, eta, FUSED_ITERS, theta0=ref.topk_row(w, keep),
        use_pallas=False))
    check_path(launches, FUSED_PATH, "awp_prune_fused")
    check(launches["awp_pgd_step"] == FUSED_ITERS
          and launches["topk_row"] == FUSED_ITERS,
          f"awp_prune_fused launched {launches}")
    loss, loss_p = (float(activation_loss(w, t, c)) for t in (th, th_p))
    rel = abs(loss - loss_p) / loss_p
    n_mask = int(((th != 0) != (th_p != 0)).sum())
    check(rel <= 1e-5 and bool((th != 0).sum(-1).eq(keep).all()),
          f"awp_prune_fused: loss {loss:.9f} against the plain loop's "
          f"{loss_p:.9f} ({rel:.2e} relative)")
    log(f"[K1+K2] awp_prune_fused {FUSED_SHAPE} x {FUSED_ITERS} iterations:"
        f" {ms:.2f} ms (plain loop {plain:.2f} ms), loss {loss:.9f} against "
        f"the plain loop's {loss_p:.9f} ({rel:.2e} relative), {n_mask} of "
        f"{th.numel()} mask entries differ; launches {launches}")
    return launches


def fused_inputs(torch, dev, gen, m, k):
    """W, C (a scaled XᵀX), η = 2/‖C‖_F and k = d_in / 2 of the fused
    loop's check."""
    w = torch.randn((m, k), generator=gen, device=dev)
    x = torch.randn((2 * k, k), generator=gen, device=dev)
    c = x.T @ x / (2 * k)
    return w, c, 2.0 / torch.linalg.matrix_norm(c), k // 2


def check_k3(torch, randn, r, d, bits):
    """K3 at one (rows, d, bits), group 128: the same bits as the plain
    version; timed beside it. Returns the JSON entry."""
    from repro_torch.kernels import ops, ref
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
    return dict(shape=f"rows={r},d={d},bits={bits}", ms=ms, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=None, max_abs_err=0.0)


def k2_nan_matrix(torch, dev, gen, rows, d):
    """Normal rows where row r holds r % 12 NaNs (either sign, several
    payloads), every third row also +inf and -inf, every fifth a run of
    -0.0; K2 must keep none of the NaNs."""
    z = torch.randn((rows, d), generator=gen, device=dev)
    bits = torch.tensor([0x7FC00000, -0x00400000, 0x7F800001, 0x7FFFFFFF,
                         -0x007FFEDD, 0x7FC01234], dtype=torch.int32)
    payloads = bits.view(torch.float32).to(dev)
    for r in range(rows):
        n = r % 12
        cols = torch.randperm(d, generator=gen, device=dev)[:n + 2]
        z[r, cols[:n]] = payloads[torch.arange(n, device=dev) % 6]
        if r % 3 == 0:
            z[r, cols[n:]] = torch.tensor([math.inf, -math.inf], device=dev)
        if r % 5 == 0:
            z[r, : d // 8] = -0.0
    return z


def check_k2(torch, dev, gen, randn):
    """K2, exact: at the wo shape, ties, the Table-1 prune's wd rows, a
    bucket's (B, M, d) stack as the batched engine hands it over, one
    73728-wide row (nemotron-4-340b's d_ff, the streaming form), a NaN/±inf
    matrix and a view 4 bytes past a 16-byte boundary (the scalar-copy
    instantiation): every variant of ``ops.topk_row_variants`` equal to the
    plain version (``torch.equal``, at most k kept a row) and timed; the
    NaN matrix also at k at, below and above its rows' NaN counts. Returns
    the wo shape's row for the JSON line, with every case in ``by_shape``."""
    from repro_torch.kernels import ops, ref
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ties = torch.randint(-8, 9, (2048, 2048), generator=gen,
                         device=dev).float()
    nan = k2_nan_matrix(torch, dev, gen, 2048, 2048)
    shifted = torch.empty(2048 * 2048 + 1, device=dev)[1:].view(2048, 2048)
    shifted.copy_(randn(2048, 2048))
    check(not ops.topk_row_vector_copies(2048, shifted),
          "K2: the shifted view would take 16-byte copies")
    for k in (1, 2, 3, 5, 8, 11, 12, 1024, 2047):
        want = ref.topk_row(nan, k)
        check(not bool(torch.isnan(want).any()), "K2: the plain version "
                                                 "kept a NaN")
        for v in ops.topk_row_variants(2048):
            check(torch.equal(ops.topk_row(nan, k, variant=v), want),
                  f"K2 NaN matrix k={k} {ops.topk_row_variant_name(v)}: "
                  f"differs from the plain version")
    log("[K2] NaN/±inf matrix (2048, 2048), k in 1, 2, 3, 5, 8, 11, 12, "
        "1024, 2047: every variant equal to the plain version")
    row, by_shape = None, []
    for name, z, k in (
            ("wo (2048, 2048)", randn(2048, 2048), 1024),
            ("wd (2048, 8192)", randn(2048, 8192), 4096),
            ("stack (2, 2048, 2048)", randn(2, 2048, 2048), 1024),
            ("ties (2048, 2048)", ties, 1024),
            ("NaN/±inf (2048, 2048)", nan, 1024),
            ("shifted view (2048, 2048)", shifted, 1024),
            ("row (1, 73728)", randn(1, 73728), 36864)):
        d = z.shape[-1]
        pick = ops.topk_row_variant(z.numel() // d, d, sms)
        want = ref.topk_row(z, k)
        zs = [z] + [z.clone() for _ in range(copies_for(8 * z.numel()) - 1)]
        if name.startswith("shifted"):   # keep every copy off the boundary
            zs = [z] + [torch.empty(z.numel() + 1, device=dev)[1:].view(
                z.shape).copy_(z) for _ in zs[1:]]
        times = {}
        for v in ops.topk_row_variants(d):
            out = ops.topk_row(z, k, variant=v)
            check(torch.equal(out, want)
                  and int((out != 0).sum(-1).max()) <= k,
                  f"K2 {name} k={k} {ops.topk_row_variant_name(v)}: "
                  f"differs from the plain version")
            times[ops.topk_row_variant_name(v)] = time_ms(
                torch, lambda i: ops.topk_row(zs[i % len(zs)], k, variant=v),
                20)
        ms = times[ops.topk_row_variant_name(pick)]
        plain = time_ms(torch, lambda i: ref.topk_row(zs[i % len(zs)], k), 20)
        # the census's yardstick, torch.topk(|z|, k, sorted=False), at the
        # one row no path's census holds
        lib = (time_ms(torch, lambda i: torch.topk(
            zs[i % len(zs)].abs(), k, dim=-1, sorted=False), 20)
            if name.startswith("row") else None)
        bnd, by = bound_ms(0.0, 8.0 * z.numel())
        log(f"[K2] topk_row {name} k={k}: every variant exact; the pick "
            f"{ops.topk_row_variant_name(pick)} {ms:.4f} ms "
            f"({bnd / ms:.0%} of the bound), plain {plain:.4f} ms, "
            + (f"torch.topk {lib:.4f} ms, " if lib is not None else "")
            + f"bound {bnd:.4f} ms ({by}); variants "
            + ", ".join(f"{n} {t:.4f} ms" for n, t in times.items()))
        entry = dict(shape=f"{name},k={k}",
                     variant=ops.topk_row_variant_name(pick), ms=ms,
                     plain_ms=plain, bound_ms=bnd, bound_by=by,
                     variant_ms=times, topk_ms=lib)
        by_shape.append(entry)
        if row is None:
            row = dict(entry, shape="rows=2048,d=2048,k=1024",
                       library_ms=None, max_abs_err=0.0)
        del zs, want
    row["by_shape"] = by_shape
    return row


def k4_weight(torch, dev, gen, n, k, group):
    """Random packed int4 weight (N, K/2) with its (N, K/group) scale and
    integer-valued zero, as the quantizer makes them."""
    packed = torch.randint(0, 256, (n, k // 2), generator=gen, device=dev,
                           dtype=torch.uint8)
    scale = torch.rand((n, k // group), generator=gen, device=dev) * 0.02
    zero = torch.randint(0, 16, (n, k // group), generator=gen,
                         device=dev).float()
    return packed, scale, zero


def k4_timers(torch, packed, scale, zero, group):
    """Input copies for timing K4 at one (N, K): enough packed weights to
    keep them out of the L2, and the dequantized f32 weight for the
    library yardstick ``torch.mm(x, w.T)`` — the product the packed weight
    replaces, which the port never calls."""
    from repro_torch.kernels import ref
    n, k = packed.shape[0], 2 * packed.shape[1]
    wbytes = n * k / 2 + 8.0 * n * k / group
    ws = [(packed.clone(), scale.clone(), zero.clone())
          for _ in range(copies_for(wbytes))]
    w32 = ref.dequant(ref.unpack_int4(packed), scale, zero, group)
    w32s = [w32.clone() for _ in range(copies_for(4.0 * n * k))]
    return ws, w32s, wbytes


def k4_time(torch, x, ws, w32s, group, variant):
    """(kernel, plain, torch.mm) ms of one K4 product at ``variant``."""
    from repro_torch.kernels import ops, ref
    reps = 20 if x.shape[0] <= 512 else 5
    ms = time_ms(torch, lambda i: ops.dequant_matmul(
        x, *ws[i % len(ws)], group, variant=variant), reps)
    plain = time_ms(torch, lambda i: ref.dequant_matmul(
        x, *ws[i % len(ws)], group), reps)
    lib = time_ms(torch, lambda i: torch.mm(x, w32s[i % len(w32s)].T), reps)
    return ms, plain, lib


def check_k4(torch, dev, gen, randn):
    """K4 at the four packed linears' (N, K) and every M of ``K4_M``, with
    every variant the wrapper can run there (each tile forced through
    ``variant=``, and the GEMV's splits at M <= 8), at groups 128 and 64:
    within 1e-5 of max|y| of the plain version (the dequantized weight is
    bit-equal; the f32 sum may run in another order than cuBLAS's), and two
    launches on the same inputs give the same bits. At group 128 every
    variant is timed; the one the wrapper picks is timed beside the plain
    version and ``torch.mm`` on the weight dequantized beforehand."""
    from repro_torch.kernels import ops, ref
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err_all, by_shape, row = 0.0, [], None
    for group in (128, 64):
        for n, k in K4_NK:
            packed, scale, zero = k4_weight(torch, dev, gen, n, k, group)
            if group == 128:
                ws, w32s, wbytes = k4_timers(torch, packed, scale, zero,
                                             group)
            for m in K4_M:
                x = randn(m, k)
                y_ref = ref.dequant_matmul(x, packed, scale, zero, group)
                ymax = float(y_ref.abs().max())
                vec = ops.dequant_matmul_vector_copies(k, n, group, x, packed)
                chosen = ops.dequant_matmul_tiles(m, n, k, vec, sms)
                err, times = 0.0, {}
                for v in ops.dequant_matmul_variants(m, k, vec):
                    name = ops.dequant_matmul_variant_name(v)
                    y = ops.dequant_matmul(x, packed, scale, zero, group,
                                           variant=v)
                    again = ops.dequant_matmul(x, packed, scale, zero, group,
                                               variant=v)
                    e = float((y - y_ref).abs().max())
                    check(e <= 1e-5 * ymax,
                          f"K4 M={m} N={n} K={k} group={group} {name}: "
                          f"max|dy| {e:.3e} (|y| {ymax:.3e})")
                    check(torch.equal(y, again),
                          f"K4 M={m} N={n} K={k} group={group} {name}: two "
                          f"launches give different bits")
                    err = max(err, e)
                    if group == 128:
                        times[name] = time_ms(torch, lambda i: (
                            ops.dequant_matmul(x, *ws[i % len(ws)], group,
                                               variant=v)), 5)
                err_all = max(err_all, err)
                if group != 128:
                    continue
                ms, plain, lib = k4_time(torch, x, ws, w32s, group, chosen)
                flops = 2.0 * m * n * k
                bnd, by = bound_ms(flops, wbytes + 4.0 * m * k + 4.0 * m * n)
                name = ops.dequant_matmul_variant_name(chosen)
                log(f"[K4] dequant_matmul M={m} N={n} K={k}: {name}, max|dy| "
                    f"{err:.2e} (|y|max {ymax:.1f}), kernel {ms:.4f} ms "
                    f"({flops / ms / 1e9:.2f} TFLOP/s, {bnd / ms:.0%} of the "
                    f"bound), plain {plain:.4f} ms, torch.mm {lib:.4f} ms, "
                    f"bound {bnd:.4f} ms ({by}); variants "
                    + ", ".join(f"{v}: {t:.4f} ms" for v, t in times.items()))
                entry = dict(shape=f"M={m},N={n},K={k}", variant=name, ms=ms,
                             plain_ms=plain, bound_ms=bnd, bound_by=by,
                             library_ms=lib, max_abs_err=err,
                             variant_ms=times)
                by_shape.append(entry)
                if (m, n, k) == K4_ROW:
                    row = dict(entry)
            log(f"[K4] N={n} K={k} group={group}: every variant within 1e-5 "
                f"of max|y| at M {list(K4_M)}, two launches the same bits")
            if group == 128:
                del ws, w32s
    row["max_abs_err"] = err_all
    row["by_shape"] = by_shape
    return row


def phase_k4_census(torch, dev, census):
    """K4 at every (M, N, K) that the serving paths launched (``census``:
    each path's ``ops.K4_CENSUS`` from its kernel run): every variant the
    wrapper can run there within 1e-5 of max|y| of the plain version, and
    the variant the path ran timed beside the plain version and
    ``torch.mm`` on the weight dequantized beforehand; then each path's K4
    device seconds (launches x time at each shape) and its launches by
    branch and variant."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    keys = sorted({key for c in census.values() for key in c})
    times = {}
    for n, k in sorted({(n, k) for _, n, k, _ in keys}):
        packed, scale, zero = k4_weight(torch, dev, gen, n, k, 128)
        ms_here = sorted({key[0] for key in keys if key[1:3] == (n, k)})
        for m in ms_here:
            x = torch.randn((m, k), generator=gen, device=dev)
            y_ref = ref.dequant_matmul(x, packed, scale, zero, 128)
            ymax = float(y_ref.abs().max())
            for v in ops.dequant_matmul_variants(m, k):
                err = float((ops.dequant_matmul(x, packed, scale, zero, 128,
                                                variant=v) - y_ref)
                            .abs().max())
                check(err <= 1e-5 * ymax,
                      f"K4 census M={m} N={n} K={k} "
                      f"{ops.dequant_matmul_variant_name(v)}: max|dy| "
                      f"{err:.3e} (|y| {ymax:.3e})")
        log(f"[K4 census] N={n} K={k}: every variant within 1e-5 of max|y| "
            f"at M {ms_here}")
        ws, w32s, _ = k4_timers(torch, packed, scale, zero, 128)
        for key in [key for key in keys if key[1:3] == (n, k)]:
            m, v = key[0], key[3]
            x = torch.randn((m, k), generator=gen, device=dev)
            times[key] = k4_time(torch, x, ws, w32s, 128, v)
            ms, plain, lib = times[key]
            log(f"[K4 census] M={m} N={n} K={k} "
                f"{ops.dequant_matmul_variant_name(v)}: launches "
                + ", ".join(f"{p} {c.get(key, 0)}" for p, c in census.items())
                + f"; kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.mm "
                f"{lib:.4f} ms")
        del ws, w32s
    out = {}
    for path, c in census.items():
        secs = [sum(cnt * times[key][i] for key, cnt in c.items()) / 1e3
                for i in range(3)]
        by_variant = {}
        for key, cnt in c.items():
            name = ops.dequant_matmul_variant_name(key[3])
            by_variant[name] = by_variant.get(name, 0) + cnt
        gemv = sum(cnt for key, cnt in c.items()
                   if key[3] >= len(ops.DEQUANT_TILES))
        gemv_s = sum(cnt * times[key][0] for key, cnt in c.items()
                     if key[3] >= len(ops.DEQUANT_TILES)) / 1e3
        log(f"[K4 census] {path}: {sum(c.values())} launches at "
            f"{len(c)} shapes (GEMV {gemv}, tile {sum(c.values()) - gemv}; "
            f"{by_variant}); K4 device seconds {secs[0]:.4f} s, the plain "
            f"version's {secs[1]:.4f} s, torch.mm's {secs[2]:.4f} s")
        out[path] = dict(launches=sum(c.values()), shapes=len(c),
                         gemv=gemv, tile=sum(c.values()) - gemv,
                         by_variant=by_variant, device_s=secs[0],
                         gemv_device_s=gemv_s,
                         plain_s=secs[1], library_s=secs[2])
    out["by_shape"] = [dict(shape=f"M={m},N={n},K={k}",
                            variant=ops.dequant_matmul_variant_name(v),
                            launches={p: c.get((m, n, k, v), 0)
                                      for p, c in census.items()},
                            ms=t[0], plain_ms=t[1], library_ms=t[2])
                       for (m, n, k, v), t in sorted(times.items())]
    return out


def phase_k2_census(torch, dev, census):
    """K2 at every (rows, d, k) that the compression paths launched
    (``census``: each path's ``ops.K2_CENSUS`` from its kernel run), on
    random rows: every variant the wrapper can run there equal to the plain
    version (``torch.equal``) and timed, beside the plain version, the
    bytes bound and, as a yardstick, ``torch.topk(|z|, k, sorted=False)``
    — the selection alone: it writes no masked row and breaks ties its own
    way, so it is not the same function and stands in no ``library_ms``.
    Then each path's K2 device seconds (launches x time at each key)."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    keys = sorted({key for c in census.values() for key in c})
    times, by_shape = {}, []
    for rows, d, k in sorted({key[:3] for key in keys}):
        z = torch.randn((rows, d), generator=gen, device=dev)
        want = ref.topk_row(z, k)
        zs = [z] + [z.clone() for _ in range(copies_for(8 * z.numel()) - 1)]
        variant_ms = {}
        for v in ops.topk_row_variants(d):
            name = ops.topk_row_variant_name(v)
            check(torch.equal(ops.topk_row(z, k, variant=v), want),
                  f"K2 census rows={rows} d={d} k={k} {name}: differs from "
                  f"the plain version")
            variant_ms[name] = time_ms(torch, lambda i: ops.topk_row(
                zs[i % len(zs)], k, variant=v), 20)
        plain = time_ms(torch, lambda i: ref.topk_row(zs[i % len(zs)], k), 20)
        lib = time_ms(torch, lambda i: torch.topk(
            zs[i % len(zs)].abs(), k, dim=-1, sorted=False), 20)
        bnd, by = bound_ms(0.0, 8.0 * z.numel())
        log(f"[K2 census] rows={rows} d={d} k={k}: every variant equal to "
            f"the plain version; variants " + ", ".join(
                f"{n} {t:.4f} ms" for n, t in variant_ms.items()))
        for key in [key for key in keys if key[:3] == (rows, d, k)]:
            name = ops.topk_row_variant_name(key[3])
            ms = variant_ms[name]
            times[key] = (ms, plain, lib)
            launches = {p: c.get(key, 0) for p, c in census.items()}
            log(f"[K2 census] rows={rows} d={d} k={k} {name}: launches "
                + ", ".join(f"{p} {n}" for p, n in launches.items())
                + f"; kernel {ms:.4f} ms ({bnd / ms:.0%} of the bound), "
                f"plain {plain:.4f} ms, torch.topk {lib:.4f} ms, bound "
                f"{bnd:.4f} ms ({by})")
            by_shape.append(dict(shape=f"rows={rows},d={d},k={k}",
                                 variant=name, launches=launches, ms=ms,
                                 plain_ms=plain, topk_ms=lib, bound_ms=bnd,
                                 bound_by=by, variant_ms=variant_ms))
        del z, zs, want
    out = {}
    for path, c in census.items():
        secs = [sum(cnt * times[key][i] for key, cnt in c.items()) / 1e3
                for i in range(3)]
        log(f"[K2 census] {path}: {sum(c.values())} launches at {len(c)} "
            f"keys; K2 device seconds {secs[0]:.4f} s, the plain version's "
            f"{secs[1]:.4f} s, torch.topk's {secs[2]:.4f} s")
        out[path] = dict(launches=sum(c.values()), keys=len(c),
                         device_s=secs[0], plain_s=secs[1], topk_s=secs[2])
    out["by_shape"] = by_shape
    return out


def phase_k6_census(torch, dev, census, n_layers):
    """K6 and K6p at every decode step the engines ran (``census``: each
    path's ``ops.K6_CENSUS`` records from its kernel run, ``n_layers``
    launches a step with the same lengths): each step's recorded lengths
    (and block table) replayed once on a fresh random INT8 cache of the
    recorded shape, the kernel timed there (the first and the longest step
    also held to the plain version within 1e-5); then each path's
    launches, kernel ms a step and K6/K6p device seconds (launches × the
    step's time). The records are read on the host only here, after the
    runs."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    out = {}
    for path, recs in census.items():
        check(len(recs) % n_layers == 0,
              f"K6 census {path}: {len(recs)} launches, not whole steps")
        steps = [recs[i:i + n_layers] for i in range(0, len(recs), n_layers)]
        for step in steps:
            check(all(torch.equal(r["lengths"], step[0]["lengths"])
                      for r in step),
                  f"K6 census {path}: the lengths differ inside a step")
        r0 = steps[0][0]
        paged = r0["kernel"] == "decode_attn_paged"
        b, h, hk, d, group = r0["b"], r0["h"], r0["hk"], r0["d"], r0["group"]
        rows = r0["pool"] * r0["page"] if paged else b * r0["t"]
        shape = ((r0["pool"], r0["page"]) if paged else (b, r0["t"])) + (hk,
                                                                          d)
        q = torch.randn((b, h, d), generator=gen, device=dev)
        kk, vv = (torch.randn(shape, generator=gen, device=dev)
                  for _ in range(2))
        (kk, vv), kw = k6_kinds(kk, vv, group)["int8"]
        ins = k6_copies(kk, vv, kw, rows * 2 * hk * (d + 4.0 * d / group))
        fn = getattr(ops, r0["kernel"])
        plain_fn = getattr(ref, r0["kernel"])

        def call(f, i, step):
            lengths, table = step[0]["lengths"], step[0]["table"]
            args = (q, ins[i % len(ins)][0], ins[i % len(ins)][1])
            args += (table, lengths) if paged else (lengths,)
            return f(*args, block_t=r0["block_t"], **ins[i % len(ins)][2])

        maxlen = [int(st[0]["lengths"].max()) for st in steps]
        for st in {0, maxlen.index(max(maxlen))}:
            err = float((call(fn, 0, steps[st])
                         - call(plain_fn, 0, steps[st])).abs().max())
            check(err <= 1e-5, f"K6 census {path} step {st}: max|d| "
                               f"{err:.3e} against the plain version")
        ms = [time_ms(torch, lambda i: call(fn, i, st), 20) for st in steps]
        launches = sum(len(st) for st in steps)
        secs = sum(len(st) * t for st, t in zip(steps, ms)) / 1e3
        live = [int(st[0]["lengths"].clamp(min=0).sum()) for st in steps]
        log(f"[K6 census] {path}: {r0['kernel']} {launches} launches over "
            f"{len(steps)} decode steps ({n_layers} a step), B={b} H={h} "
            f"Hk={hk} D={d} " + (f"page={r0['page']} pool={r0['pool']} "
                                 f"n_pages={r0['t'] // r0['page']}"
                                 if paged else f"T={r0['t']}")
            + f", INT8 group {group}; rows up to {max(maxlen)} tokens, "
            f"{min(live)}..{max(live)} live tokens a step; kernel ms a step "
            f"{sum(ms) / len(ms):.4f} mean, {min(ms):.4f} min, "
            f"{max(ms):.4f} max; {r0['kernel']} device seconds "
            f"{secs:.4f} s")
        out[path] = dict(kernel=r0["kernel"], launches=launches,
                         steps=len(steps), device_s=secs,
                         ms_mean=sum(ms) / len(ms), ms_min=min(ms),
                         ms_max=max(ms), max_len=max(maxlen))
        del ins
    return out


def check_k1b(torch, randn):
    """K1b, the batched step, at the batched engine's buckets (B = 2) and
    at B = 3, with a different η per item (the second item's C is scaled,
    so an item that read another's η or C would show): Z within 1e-5 of
    max|Z| and each norm within 1e-5 relative of the plain version's.
    Timed beside its plain version and ``torch.baddbmm`` with one shared η
    (the same work; a yardstick the port never calls). Returns the row of
    (2, 8192, 2048) with every shape's entry under ``by_shape``."""
    by_shape = [k1b_entry(torch, randn, *shape) for shape in K1B_SHAPES]
    row = dict(next(e for e in by_shape if e["shape"] == "B=2,M=8192,K=2048"))
    row["max_abs_err"] = max(e["max_abs_err"] for e in by_shape)
    row["by_shape"] = by_shape
    return row


def k1b_entry(torch, randn, b, m, k):
    """K1b at one (B, M, K) (see :func:`check_k1b`); its JSON entry."""
    from repro_torch.kernels import ops, ref
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
    ms = time_ms(torch, lambda i: ops.awp_pgd_step(w, theta, c, eta), 5)
    plain = time_ms(torch, lambda i: ref.awp_pgd_step(w, theta, c, eta), 5)
    eta_f = float(eta[0])
    lib = time_ms(torch, lambda i: torch.baddbmm(
        theta, w - theta, c, alpha=eta_f), 5)
    flops = 2.0 * b * m * k * k
    bnd, by = bound_ms(flops, 4.0 * b * (3 * m * k + k * k))
    chosen = k1_variant(torch, b, m, k)
    log(f"[K1b] awp_pgd_step {(b, m, k)}, η {eta.tolist()}: variant "
        f"{chosen} {ops.AWP_PGD_TILES[chosen]}, max|dZ| {err:.2e} "
        f"(|Z|max {scale:.2f}), norm rel err {nerr:.1e}, kernel "
        f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {bnd / ms:.0%} of "
        f"the bound), baddbmm {lib:.3f} ms ({flops / lib / 1e9:.1f} "
        f"TFLOP/s), plain {plain:.3f} ms, bound {bnd:.3f} ms ({by})")
    return dict(shape=f"B={b},M={m},K={k}", variant=chosen, ms=ms,
                plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
                max_abs_err=err)


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


def k6_kinds(k, v, group):
    """K6's two kinds on the engine's path: dense f32 and INT8 codes with
    their planes (group ``group``) — (name, (k, v), keyword arguments)."""
    from repro_torch.serving.kv_cache import kv_quantize
    qk, qv = kv_quantize(k, group), kv_quantize(v, group)
    return {"dense": ((k, v), {}),
            "int8": ((qk.codes, qv.codes),
                     dict(k_scale=qk.scale, k_zero=qk.zero, v_scale=qv.scale,
                          v_zero=qv.zero, group_size=group))}


def k6_copies(kk, vv, kw, nbytes):
    """Copies of a K6 operand set, enough to keep the L2 cold."""
    return [tuple(x.clone() for x in (kk, vv)) + (
            {n: x.clone() if hasattr(x, "clone") else x
             for n, x in kw.items()},) for _ in range(copies_for(nbytes))]


def check_k6(torch, dev, gen):
    """K6 at the engine's decode shape, dense f32 and INT8 (group 64), at
    each length set of ``K6_SETS``: within 1e-5 of the plain version (one
    softmax over the row against the kernel's splits, each an online
    softmax, merged in split order), two launches the same bits, a
    length-0 row exactly zero, and (census) a NaN-poisoned row alone. The
    dense variant is also timed against ``scaled_dot_product_attention``
    (K/V repeated to every query head, a boolean length mask) as a
    yardstick the port never calls. The census row is the JSON line's."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    h, hk, d, t, group = 32, 8, 64, 2048, 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tok_bytes = {"dense": 2 * hk * d * 4.0,
                 "int8": 2 * hk * (d + 4.0 * d / group)}
    res, by_lengths = {}, []
    for set_name, lens in K6_SETS.items():
        b = len(lens)
        q = torch.randn((b, h, d), generator=gen, device=dev)
        k = torch.randn((b, t, hk, d), generator=gen, device=dev)
        v = torch.randn((b, t, hk, d), generator=gen, device=dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        live = sum(lens)
        io = 4.0 * 2 * b * h * d + 4 * b
        chunk, splits = ops.decode_attn_splits(b, hk, t, sms=sms)
        for name, ((kk, vv), kw) in k6_kinds(k, v, group).items():
            out = ops.decode_attn(q, kk, vv, lengths, **kw)
            want = ref.decode_attn(q, kk, vv, lengths, **kw)
            err = float((out - want).abs().max())
            rel = float(((out - want).abs() / (want.abs() + 1.0)).max())
            check(err <= 1e-5 or rel <= 1e-5,
                  f"K6 {name} {set_name}: max|d| {err:.3e} against the "
                  f"plain version")
            check(torch.equal(out.view(torch.int32), ops.decode_attn(
                q, kk, vv, lengths, **kw).view(torch.int32)),
                  f"K6 {name} {set_name}: two launches differ")
            for i in (i for i, n in enumerate(lens) if n == 0):
                check(torch.equal(out[i], torch.zeros_like(out[i])),
                      f"K6 {name} {set_name}: a length-0 row is not "
                      f"exactly zero")
            if set_name == "census":
                # one poisoned token in row 4 (length 1000), KV head 3:
                # only that row's query heads 12..15 become NaN
                if name == "dense":
                    bad_k = kk.clone()
                    bad_k[4, 10, 3] = float("nan")
                    bad = ops.decode_attn(q, bad_k, vv, lengths)
                else:
                    bad_kw = dict(kw, k_scale=kw["k_scale"].clone())
                    bad_kw["k_scale"][4, 10, 3] = float("nan")
                    bad = ops.decode_attn(q, kk, vv, lengths, **bad_kw)
                keep = torch.ones((b, h), dtype=torch.bool, device=dev)
                keep[4, 12:16] = False
                check(bool(torch.isnan(bad[4, 12:16]).all())
                      and torch.equal(bad[keep], out[keep]),
                      f"K6 {name}: the NaN row does not propagate alone")
            nbytes = live * tok_bytes[name] + io
            ins = k6_copies(kk, vv, kw, b * t * tok_bytes[name])
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
                reps = [tuple(x.permute(0, 2, 1, 3).repeat_interleave(
                    h // hk, 1) for x in pair[:2]) for pair in ins]
                mask = (torch.arange(t, device=dev)[None, :]
                        < lengths[:, None].long())[:, None, None, :]
                lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                    qs, reps[i % len(reps)][0], reps[i % len(reps)][1],
                    attn_mask=mask), 50)
                del reps
            del ins
            lib_txt = "n/a" if lib is None else f"{lib:.4f} ms"
            log(f"[K6] decode_attn {name} {set_name} B={b} H={h} Hk={hk} "
                f"D={d} T={t} lengths {list(lens)}: {splits} splits of "
                f"{chunk}, max|d| {err:.2e}, two launches the same bits, "
                + ("zero row exact, NaN row alone, "
                   if set_name == "census" else "")
                + f"kernel {ms:.4f} ms ({bnd / ms:.1%} of the bound), plain "
                f"{plain:.4f} ms, sdpa {lib_txt}, bound {bnd:.4f} ms ({by}), "
                f"{nbytes / ms / 1e9:.2f} TB/s of live bytes")
            entry = dict(shape=f"B={b},H={h},Hk={hk},D={d},T={t},{name}",
                         lengths=set_name, ms=ms, plain_ms=plain,
                         bound_ms=bnd, bound_by=by, library_ms=lib,
                         max_abs_err=err, splits=splits, chunk=chunk)
            by_lengths.append(entry)
            if set_name == "census":
                res[name] = entry
    row = dict(res["int8"])              # the engine path's variant
    row["dense"] = res["dense"]
    row["by_lengths"] = by_lengths
    return row


def k6p_tables(torch, dev, gen, lens):
    """Block tables for rows of ``lens`` tokens over a pool of K6P_POOL
    pages: each row's live pages drawn from a shuffle of the pool, rows 2
    and 3 sharing their first pages (a shared prefix, up to 4), every entry
    past a row's live pages the sentinel K6P_POOL. Row 4 (the NaN check's)
    shares nothing."""
    perm = torch.randperm(K6P_POOL, generator=gen, device=dev).to(torch.int32)
    table = torch.full((len(lens), K6P_PAGES), K6P_POOL,
                       dtype=torch.int32, device=dev)
    used, live = 0, []
    for i, n in enumerate(lens):
        live.append(-(-n // K6P_PAGE))
        table[i, :live[i]] = perm[used:used + live[i]]
        used += live[i]
    if len(lens) > 3:
        shared = min(4, live[2], live[3])
        table[3, :shared] = table[2, :shared]
    return table


def check_k6p(torch, dev, gen):
    """K6p at the paged engine's decode shape, dense f32 and INT8 (group
    64), at each length set of ``K6_SETS``: shuffled pool pages, pages
    shared between rows, sentinel tails, a pool larger than the tables
    use. Within 1e-5 of the plain version (one softmax over the gathered
    row), equal to the slot kernel K6 on the same tokens laid out
    contiguously (the same splits and pieces in the same order: the same
    bits), two launches the same bits, a length-0 row exactly zero and
    (census) a NaN token poisoning only its row's heads of that KV head.
    No single PyTorch call reads through a block table, so there is no
    library time."""
    from repro_torch.kernels import ops, ref
    h, hk, d, group = 32, 8, 64, 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k = torch.randn((K6P_POOL, K6P_PAGE, hk, d), generator=gen, device=dev)
    v = torch.randn((K6P_POOL, K6P_PAGE, hk, d), generator=gen, device=dev)
    tok_bytes = {"dense": 2 * hk * d * 4.0,
                 "int8": 2 * hk * (d + 4.0 * d / group)}
    kinds = k6_kinds(k, v, group)
    res, by_lengths = {}, []
    for set_name, lens in K6_SETS.items():
        b = len(lens)
        q = torch.randn((b, h, d), generator=gen, device=dev)
        table = k6p_tables(torch, dev, gen, lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        live = sum(lens)
        io = 4.0 * 2 * b * h * d + 4 * b + 4.0 * table.numel()
        chunk, splits = ops.decode_attn_splits(b, hk, K6P_PAGES * K6P_PAGE,
                                               sms=sms)
        for name, ((kk, vv), kw) in kinds.items():
            out = ops.decode_attn_paged(q, kk, vv, table, lengths, **kw)
            want = ref.decode_attn_paged(q, kk, vv, table, lengths, **kw)
            err = float((out - want).abs().max())
            rel = float(((out - want).abs() / (want.abs() + 1.0)).max())
            check(err <= 1e-5 or rel <= 1e-5,
                  f"K6p {name} {set_name}: max|d| {err:.3e} against the "
                  f"plain version")
            slot_kw = {n: (ref.gather_pages(x, table) if torch.is_tensor(x)
                           else x) for n, x in kw.items()}
            slot = ops.decode_attn(q, ref.gather_pages(kk, table),
                                   ref.gather_pages(vv, table), lengths,
                                   **slot_kw)
            check(torch.equal(out, slot), f"K6p {name} {set_name}: differs "
                  f"from K6 on the same tokens laid out in slot rows (max|d| "
                  f"{float((out - slot).abs().max()):.3e})")
            check(torch.equal(out.view(torch.int32), ops.decode_attn_paged(
                q, kk, vv, table, lengths, **kw).view(torch.int32)),
                  f"K6p {name} {set_name}: two launches differ")
            for i in (i for i, n in enumerate(lens) if n == 0):
                check(torch.equal(out[i], torch.zeros_like(out[i])),
                      f"K6p {name} {set_name}: a length-0 row is not "
                      f"exactly zero")
            if set_name == "census":
                # one poisoned token of row 4 (length 1000), KV head 3:
                # only that row's heads 12..15 become NaN
                page = int(table[4, 10 // K6P_PAGE])
                if name == "dense":
                    bad_k = kk.clone()
                    bad_k[page, 10 % K6P_PAGE, 3] = float("nan")
                    bad = ops.decode_attn_paged(q, bad_k, vv, table, lengths)
                else:
                    bad_kw = dict(kw, k_scale=kw["k_scale"].clone())
                    bad_kw["k_scale"][page, 10 % K6P_PAGE, 3] = float("nan")
                    bad = ops.decode_attn_paged(q, kk, vv, table, lengths,
                                                **bad_kw)
                keep = torch.ones((b, h), dtype=torch.bool, device=dev)
                keep[4, 12:16] = False
                check(bool(torch.isnan(bad[4, 12:16]).all())
                      and torch.equal(bad[keep], out[keep]),
                      f"K6p {name}: the NaN token does not propagate alone")
            nbytes = live * tok_bytes[name] + io
            ins = k6_copies(kk, vv, kw, K6P_POOL * K6P_PAGE * tok_bytes[name])
            ms = time_ms(torch, lambda i: ops.decode_attn_paged(
                q, ins[i % len(ins)][0], ins[i % len(ins)][1], table,
                lengths, **ins[i % len(ins)][2]), 50)
            plain = time_ms(torch, lambda i: ref.decode_attn_paged(
                q, ins[i % len(ins)][0], ins[i % len(ins)][1], table,
                lengths, **ins[i % len(ins)][2]), 20)
            del ins
            bnd, by = bound_ms(4.0 * h * d * live, nbytes)
            log(f"[K6p] decode_attn_paged {name} {set_name} B={b} H={h} "
                f"Hk={hk} D={d} page={K6P_PAGE} n_pages={K6P_PAGES} "
                f"pool={K6P_POOL} lengths {list(lens)}: {splits} splits of "
                f"{chunk}, max|d| {err:.2e}, equal to K6 on slot rows, two "
                f"launches the same bits, "
                + ("zero row exact, NaN head group alone, "
                   if set_name == "census" else "")
                + f"kernel {ms:.4f} ms ({bnd / ms:.1%} of the bound), plain "
                f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}), "
                f"{nbytes / ms / 1e9:.2f} TB/s of live bytes")
            entry = dict(shape=f"B={b},H={h},Hk={hk},D={d},page={K6P_PAGE},"
                               f"n_pages={K6P_PAGES},{name}",
                         lengths=set_name, ms=ms, plain_ms=plain,
                         bound_ms=bnd, bound_by=by, library_ms=None,
                         max_abs_err=err, splits=splits, chunk=chunk)
            by_lengths.append(entry)
            if set_name == "census":
                res[name] = entry
    row = dict(res["int8"])              # the engine path's variant
    row["dense"] = res["dense"]
    row["by_lengths"] = by_lengths
    return row


def check_k6_heads(torch, dev, heads, tag, seed):
    """K6 and K6p at one arch's decode head shape (``heads``: H, Hk, D, T
    and the INT8 group; nemotron-4-340b's g = 12 at D = 192 takes the
    generic form's 32-accumulator instantiation, starcoder2-7b's g = 9 at
    D = 128 its 16-accumulator one) at the engines' batch, cache and census
    lengths (8 rows, T = 2048; K6p through 16-token pages of K6P_POOL),
    dense f32 and INT8: within 1e-5 of the plain version, two launches the
    same bits, K6p equal to K6 on the gathered rows, a length-0 row
    exactly zero; timed beside the plain version (and, dense, SDPA) at the
    bound. Returns the K6 and K6p entries (the kernel table's rows at
    these heads), printed as ``[K6 <tag>]`` lines."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + seed)
    h, hk, d, t, group = heads
    at = f"g = {h // hk}, D = {d}"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lens = K6_LENGTHS
    b, live = len(lens), sum(K6_LENGTHS)
    tok_bytes = {"dense": 2 * hk * d * 4.0,
                 "int8": 2 * hk * (d + 4.0 * d / group)}
    q = torch.randn((b, h, d), generator=gen, device=dev)
    k = torch.randn((b, t, hk, d), generator=gen, device=dev)
    v = torch.randn((b, t, hk, d), generator=gen, device=dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    table = k6p_tables(torch, dev, gen, lens)
    chunk, splits = ops.decode_attn_splits(b, hk, t, sms=sms)
    out_rows = {"decode_attn": [], "decode_attn_paged": []}
    for name, ((kk, vv), kw) in k6_kinds(k, v, group).items():
        # the paged pools: each row's tokens scattered to its table's pages
        # (rows 2 and 3 share their first pages: row 3's tokens land there)
        pools = {}
        for n, x in [("k", kk), ("v", vv)] + [
                (n, x) for n, x in kw.items() if torch.is_tensor(x)]:
            pool = x.new_zeros((K6P_POOL, K6P_PAGE) + tuple(x.shape[2:]))
            for i, n_tok in enumerate(lens):
                npg = -(-n_tok // K6P_PAGE)
                if npg:
                    pool[table[i, :npg].long()] = x[i, :npg * K6P_PAGE] \
                        .reshape((npg, K6P_PAGE) + tuple(x.shape[2:]))
            pools[n] = pool
        pkw = {n: pools.get(n, x) for n, x in kw.items()}
        gkw = {n: (ref.gather_pages(x, table) if torch.is_tensor(x) else x)
               for n, x in pkw.items()}
        slot_of_pages = ops.decode_attn(q, ref.gather_pages(pools["k"], table),
                                        ref.gather_pages(pools["v"], table),
                                        lengths, **gkw)
        for kernel in ("decode_attn", "decode_attn_paged"):
            if kernel == "decode_attn":
                args, call_kw = (q, kk, vv, lengths), kw
                call, plain_fn = ops.decode_attn, ref.decode_attn
            else:
                args = (q, pools["k"], pools["v"], table, lengths)
                call_kw = pkw
                call, plain_fn = ops.decode_attn_paged, ref.decode_attn_paged
            out = call(*args, **call_kw)
            want = plain_fn(*args, **call_kw)
            err = float((out - want).abs().max())
            rel = float(((out - want).abs() / (want.abs() + 1.0)).max())
            check(err <= 1e-5 or rel <= 1e-5,
                  f"{kernel} {name} at {at}: max|d| {err:.3e} "
                  f"against the plain version")
            check(torch.equal(out.view(torch.int32),
                              call(*args, **call_kw).view(torch.int32)),
                  f"{kernel} {name} at {at}: two launches differ")
            check(torch.equal(out[0], torch.zeros_like(out[0])),
                  f"{kernel} {name} at {at}: the length-0 row")
            if kernel != "decode_attn":
                check(torch.equal(out, slot_of_pages), f"K6p {name} at {at} "
                      f"differs from K6 on the gathered rows")
            io = 4.0 * 2 * b * h * d + 4 * b + (
                4.0 * table.numel() if kernel != "decode_attn" else 0)
            nbytes = live * tok_bytes[name] + io
            ms = time_ms(torch, lambda i: call(*args, **call_kw), 50)
            plain = time_ms(torch, lambda i: plain_fn(*args, **call_kw), 10)
            bnd, by = bound_ms(4.0 * h * d * live, nbytes)
            lib = None
            if name == "dense" and kernel == "decode_attn":
                qs = q[:, :, None, :]
                kr, vr = (x.permute(0, 2, 1, 3).repeat_interleave(h // hk, 1)
                          for x in (kk, vv))
                mask = (torch.arange(t, device=dev)[None, :]
                        < lengths[:, None].long())[:, None, None, :]
                lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                    qs, kr, vr, attn_mask=mask), 50)
                del kr, vr
            log(f"[K6 {tag}] {kernel} {name} B={b} H={h} Hk={hk} D={d} "
                f"T={t} census lengths: {splits} splits of {chunk}, max|d| "
                f"{err:.2e}, two launches the same bits"
                + (", equal to K6" if kernel != "decode_attn" else "")
                + f"; kernel {ms:.4f} ms ({bnd / ms:.1%} of the bound), "
                f"plain {plain:.4f} ms, sdpa "
                f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
                f"{bnd:.4f} ms ({by})")
            out_rows[kernel].append(dict(
                shape=f"B={b},H={h},Hk={hk},D={d},T={t},{name}",
                lengths=f"census ({tag} heads)", ms=ms,
                plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
                max_abs_err=err, splits=splits, chunk=chunk))
        del pools, slot_of_pages
    return out_rows


# ---------------------------------------------------------------------------
# the MoE family: qwen3-moe-235b-a22b at full width, two layers
# ---------------------------------------------------------------------------

def k4x_stack(torch, dev, gen, e, n, k, group):
    """Random packed int4 expert stack (E, N, K/2) with (E, N, K/group)
    scale and integer-valued zero."""
    packed = torch.randint(0, 256, (e, n, k // 2), generator=gen, device=dev,
                           dtype=torch.uint8)
    scale = torch.rand((e, n, k // group), generator=gen, device=dev) * 0.02
    zero = torch.randint(0, 16, (e, n, k // group), generator=gen,
                         device=dev).float()
    return packed, scale, zero


def k4x_bound(e, m, n, k, group, per_expert):
    """K4x's bound: each code, scale and zero read once, x once (once a
    stack when shared), y written once; 2·E·M·N·K operations."""
    nbytes = (e * n * k / 2 + 8.0 * e * n * k / group
              + 4.0 * (e if per_expert else 1) * m * k + 4.0 * e * m * n)
    return bound_ms(2.0 * e * m * n * k, nbytes)


def k4x_x(torch, dev, gen, e, m, k, per_expert):
    """K4x's input: shared (M, K), or per expert the (E, M, K) view of an
    (M, E, K) tensor, as the MoE down projection hands it over."""
    if per_expert:
        return torch.randn((m, e, k), generator=gen, device=dev).transpose(0,
                                                                           1)
    return torch.randn((m, k), generator=gen, device=dev)


def k4x_times(torch, x, stack, group, per_expert, variant, w32t):
    """(kernel, plain, bmm) ms of one K4x call; the yardstick is
    ``torch.matmul`` of x with the stack dequantized beforehand, (E, K, N),
    which the port never calls."""
    from repro_torch.kernels import ops, ref
    reps = 10 if x.shape[-2] <= 64 else 3
    ms = time_ms(torch, lambda i: ops.dequant_matmul_experts(
        x, *stack, group, per_expert, variant=variant), reps)
    plain = time_ms(torch, lambda i: ref.dequant_matmul_experts(
        x, *stack, group, per_expert), 2)
    lib = time_ms(torch, lambda i: torch.matmul(x, w32t), reps)
    return ms, plain, lib


def check_k4x(torch, dev):
    """K4x against its plain version (K4's plain version expert by expert)
    at E 8 and 128, qwen3-moe's (N, K) of wg/wu (1536, 4096) and wd (4096,
    1536), M in ``K4X_M``, groups 128 and 64, shared and per-expert x (the
    per-expert x a transposed view, as the model hands it over), with every
    variant the wrapper can run: within 1e-5 of max|y|, and two launches
    the same bits; a per-expert view 4 bytes past a 16-byte boundary at
    every tile variant. At E = 128 and group 128 each variant is timed and
    the pick timed beside the plain version and the bmm yardstick."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err_all, by_shape, row, checked, checked_chain = 0.0, [], None, 0, 0
    for e in K4X_E:
        for group in (128, 64):
            for n, k in K4X_NK:
                stack = k4x_stack(torch, dev, gen, e, n, k, group)
                timed = e == K4X_E[-1] and group == 128
                w32t = None
                if timed:
                    w32t = torch.stack([ref.dequant(
                        ref.unpack_int4(stack[0][i]), stack[1][i],
                        stack[2][i], group) for i in range(e)]).transpose(1,
                                                                          2)
                for m in K4X_M:
                    for per_expert in (False, True):
                        x = k4x_x(torch, dev, gen, e, m, k, per_expert)
                        y_ref = ref.dequant_matmul_experts(
                            x, *stack, group, per_expert)
                        ymax = float(y_ref.abs().max())
                        vec = ops.dequant_matmul_vector_copies(
                            k, n, group, x, stack[0])
                        chosen = ops.dequant_matmul_tiles(m, n, k, vec, sms,
                                                          e)
                        err, times, chain = 0.0, {}, {}
                        form = "per-expert" if per_expert else "shared"
                        for v in ops.dequant_matmul_variants(m, k, vec):
                            name = ops.dequant_matmul_variant_name(v)
                            y = ops.dequant_matmul_experts(
                                x, *stack, group, per_expert, variant=v)
                            again = ops.dequant_matmul_experts(
                                x, *stack, group, per_expert, variant=v)
                            if m <= ops.GEMV_MAX_M and v in (
                                    len(ops.DEQUANT_TILES) - 1, ops.GEMVX):
                                chain[v] = y
                            d = float((y - y_ref).abs().max())
                            check(d <= 1e-5 * ymax,
                                  f"K4x E={e} M={m} N={n} K={k} group="
                                  f"{group} {form} {name}: max|dy| {d:.3e} "
                                  f"(|y| {ymax:.3e})")
                            check(torch.equal(y, again),
                                  f"K4x E={e} M={m} N={n} K={k} {form} "
                                  f"{name}: two launches differ")
                            err = max(err, d)
                            checked += 1
                            if timed:
                                times[name] = time_ms(
                                    torch, lambda i: ops.dequant_matmul_experts(
                                        x, *stack, group, per_expert,
                                        variant=v), 3 if m > 64 else 10)
                        # the expert GEMV sums each output in one k-order
                        # chain from +0, the tile's: the tile's bits
                        if ops.GEMVX in chain:
                            check(torch.equal(chain[ops.GEMVX], chain[
                                len(ops.DEQUANT_TILES) - 1]),
                                f"K4x E={e} M={m} N={n} K={k} group={group} "
                                f"{form}: gemvx differs from the tile")
                            checked_chain += 1
                        del chain
                        err_all = max(err_all, err)
                        if not timed:
                            continue
                        ms, plain, lib = k4x_times(torch, x, stack, group,
                                                   per_expert, chosen, w32t)
                        bnd, by = k4x_bound(e, m, n, k, group, per_expert)
                        name = ops.dequant_matmul_variant_name(chosen)
                        log(f"[K4x] E={e} M={m} N={n} K={k} {form}: {name}, "
                            f"max|dy| {err:.2e}, kernel {ms:.4f} ms "
                            f"({bnd / ms:.1%} of the bound), plain "
                            f"{plain:.4f} ms, bmm {lib:.4f} ms, bound "
                            f"{bnd:.4f} ms ({by}); variants " + ", ".join(
                                f"{v}: {t:.4f} ms" for v, t in times.items()))
                        entry = dict(shape=f"E={e},M={m},N={n},K={k},{form}",
                                     variant=name, ms=ms, plain_ms=plain,
                                     bound_ms=bnd, bound_by=by,
                                     library_ms=lib, max_abs_err=err,
                                     variant_ms=times)
                        by_shape.append(entry)
                        if (e, m, n, k, per_expert) == K4X_ROW:
                            row = dict(entry)
                del stack, w32t
                torch.cuda.empty_cache()
            log(f"[K4x] E={e} group={group}: every variant within 1e-5 of "
                f"max|y| at (N, K) {list(K4X_NK)}, M {list(K4X_M)}, shared "
                f"and per-expert x, two launches the same bits")
    # a per-expert view off a 16-byte boundary: the tile's scalar copies
    e, n, k, m = K4X_E[0], 4096, 1536, 64
    stack = k4x_stack(torch, dev, gen, e, n, k, 128)
    raw = torch.randn(m * e * k + 1, generator=gen, device=dev)
    x = raw[1:].view(m, e, k).transpose(0, 1)
    check(not ops.dequant_matmul_vector_copies(k, n, 128, x, stack[0]),
          "K4x: the shifted view should take the scalar copies")
    y_ref = ref.dequant_matmul_experts(x, *stack, 128, True)
    for v in range(len(ops.DEQUANT_TILES)):
        d = float((ops.dequant_matmul_experts(x, *stack, 128, True,
                                              variant=v) - y_ref).abs().max())
        check(d <= 1e-5 * float(y_ref.abs().max()),
              f"K4x misaligned view, tile variant {v}: max|dy| {d:.3e}")
        checked += 1
    # zeros off the integers take the expert GEMV's three-operation
    # dequantize: still the tile's bits
    e, n, k, m = K4X_E[0], 1536, 4096, 8
    stack = k4x_stack(torch, dev, gen, e, n, k, 128)
    stack = (stack[0], stack[1], stack[2] + 0.25)
    for per_expert in (False, True):
        x = k4x_x(torch, dev, gen, e, m, k, per_expert)
        y = ops.dequant_matmul_experts(x, *stack, 128, per_expert,
                                       variant=ops.GEMVX)
        check(torch.equal(y, ops.dequant_matmul_experts(
            x, *stack, 128, per_expert, variant=len(ops.DEQUANT_TILES) - 1)),
            "K4x: gemvx with fractional zeros differs from the tile")
        y_ref = ref.dequant_matmul_experts(x, *stack, 128, per_expert)
        d = float((y - y_ref).abs().max())
        check(d <= 1e-5 * float(y_ref.abs().max()),
              f"K4x gemvx, fractional zeros: max|dy| {d:.3e}")
        checked_chain += 1
    log(f"[K4x] {checked} (shape, variant) checks within 1e-5 of max|y|, "
        f"the misaligned view at every tile variant included; gemvx the "
        f"tile's bits at all {checked_chain} (shape, group, form) cases at "
        f"M <= 8, fractional zeros included")
    row["max_abs_err"] = err_all
    row["by_shape"] = by_shape
    return row


def check_k6_moe(torch, dev):
    """K6 at qwen3-moe's slot-engine decode shape (8 rows, 64 query heads
    over 4 KV heads, g = 16, D = 128, T = 2048, INT8, group 64), which no
    earlier phase runs: within 1e-5 of the plain version, two launches the
    same bits."""
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.kv_cache import kv_quantize
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    b, h, hk, d, t, group = 8, 64, 4, 128, 2048, 64
    q = torch.randn((b, h, d), generator=gen, device=dev)
    kq = kv_quantize(torch.randn((b, t, hk, d), generator=gen, device=dev),
                     group)
    vq = kv_quantize(torch.randn((b, t, hk, d), generator=gen, device=dev),
                     group)
    kw = dict(k_scale=kq.scale, k_zero=kq.zero, v_scale=vq.scale,
              v_zero=vq.zero, group_size=group)
    lengths = torch.tensor(K6_LENGTHS, dtype=torch.int32, device=dev)
    out = ops.decode_attn(q, kq.codes, vq.codes, lengths, **kw)
    want = ref.decode_attn(q, kq.codes, vq.codes, lengths, **kw)
    err = float((out - want).abs().max())
    rel = float(((out - want).abs() / (want.abs() + 1.0)).max())
    check(err <= 1e-5 or rel <= 1e-5,
          f"K6 at the MoE shape: max|d| {err:.3e} against the plain version")
    check(torch.equal(out.view(torch.int32), ops.decode_attn(
        q, kq.codes, vq.codes, lengths, **kw).view(torch.int32)),
          "K6 at the MoE shape: two launches differ")
    log(f"[K6] decode_attn int8 at the MoE shape B={b} H={h} Hk={hk} D={d} "
        f"T={t}: max|d| {err:.2e}, two launches the same bits")


def moe_config():
    """qwen3-moe-235b-a22b at its published widths, cut to MOE_LAYERS
    layers (the one cut: 94 layers are 940 GB in f32)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)


def model_setup(torch, dev, cfg):
    """The model of ``cfg``, its calibration batches and prompts (the llama
    phase's sizes at ``cfg``'s vocabulary). Each run makes the weights
    from the seed itself (:func:`moe_run`, :func:`ssm_run`), so the card
    holds one set."""
    from repro_torch.data import DataConfig, ZipfMarkov, calibration_batches
    from repro_torch.models import build_model
    model = build_model(cfg)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=CALIB_SEQ,
                    global_batch=CALIB_BATCH)
    calib = [{"tokens": torch.as_tensor(t, device=dev)}
             for t, _ in calibration_batches(dc, CALIB_BATCHES)]
    prompts, _ = ZipfMarkov(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=PROMPT_LEN,
                                       global_batch=BATCH)).batch(0)
    return model, calib, prompts


def moe_run(torch, dev, cfg, model, calib, prompts, label, count=False):
    """The MoE main path once, on the active implementation: weights from
    the seed, compress (batched engine, mixed policy), pack in memory,
    prefill logits and a static greedy decode; launch counts and K4x's
    census from 0 just before. With ``count`` the compression runs in
    sync-debug mode and its host waits a block are counted
    (:func:`count_waits`); otherwise it is timed. Returns the report, the
    packed params, logits, tokens, seconds, launches and K4x's census."""
    from repro_torch.checkpoint import pack_params
    from repro_torch.core.compress import compress_model
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import greedy_decode
    params = model.init(SEED, device=dev)
    if label.endswith("kernels") and not count:
        log(f"[model] {cfg.name}: {cfg.num_layers} of 94 layers (the one "
            f"cut), d_model {cfg.d_model}, {cfg.num_heads} heads over "
            f"{cfg.num_kv_heads} KV heads of {cfg.resolved_head_dim}, "
            f"{cfg.num_experts} experts of d_ff {cfg.d_ff}, top-"
            f"{cfg.experts_per_token}, vocab {cfg.vocab_size} (padded "
            f"{cfg.padded_vocab}), {sum(t.numel() for t in _leaves(params)) / 1e9:.3f}"
            f"e9 f32 parameters from seed {SEED}")
    ops.reset_launches()
    waits = None
    if count:
        waits, report, cp = count_waits(
            torch, (model, params, calib, None), policy_for("mixed"),
            f"{label} ", keep=True)
        t_comp = float("nan")
    else:
        torch.cuda.synchronize()
        t0 = time.time()
        cp, report = compress_model(model, params, calib,
                                    policy_for("mixed"))
        torch.cuda.synchronize()
        t_comp = time.time() - t0
    del params
    comp_launches = dict(ops.LAUNCHES)
    packed = pack_params(cp, report)
    del cp
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 1e9
    for res in (a.result for a in report.artifacts.values()):
        res.qtensor = None               # the packed leaves hold the codes
    logits, _ = model.prefill(
        packed, {"tokens": torch.as_tensor(prompts, device=dev)},
        model.init_cache(BATCH, PROMPT_LEN + GEN, torch.float32, device=dev))
    tokens, secs = greedy_decode(model, packed, prompts, GEN)
    launches = dict(ops.LAUNCHES)
    log(f"[{label}] compress {t_comp:.1f}s (peak {peak:.1f} GB allocated), "
        f"prefill {secs['prefill']:.3f}s, {GEN - 1} decode steps "
        f"{secs['decode']:.3f}s; launches in compression {comp_launches}, "
        f"in all {launches}")
    return dict(report=report, packed=packed, logits=logits, tokens=tokens,
                compress_s=t_comp, decode=secs, launches=launches,
                compress_launches=comp_launches, waits=waits,
                k4x=dict(ops.K4X_CENSUS))


def to_host_tree(tree):
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda t: t.cpu(), tree)


def to_card_tree(tree, dev):
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda t: t.to(dev), tree)


MOE_PACKED = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("moe", "wg"),
              ("moe", "wu"), ("moe", "wd"))


def moe_hold(torch, cfg, run_k, run_p, tag, exact):
    """Two MoE runs held to each other: every layer's loss within
    ``LOSS_BAR``, its codes (from the packed leaves, one (L[, E]) count of
    differing codes a leaf) or its mask equal on >= ``AGREE_BAR`` of
    entries, losses finite in (0, 1), pruned layers at 50%; with ``exact``
    equal iteration counts. Then the logits and static tokens. Returns the
    summary, ``identical`` when no layer differs."""
    from repro_torch.core.compress import resolve_path
    from repro_torch.quant import QTensor
    rep_k, rep_p = run_k["report"], run_p["report"]
    n_layers = cfg.num_layers * (4 + 3 * cfg.num_experts)
    check(len(rep_k) == len(rep_p) == n_layers,
          f"{tag}: {len(rep_k)} and {len(rep_p)} layers, expected {n_layers}")
    diff = {}
    for group, name in MOE_PACKED:
        a, b = (r["packed"]["blocks"][group][name] for r in (run_k, run_p))
        check(isinstance(a, QTensor) and isinstance(b, QTensor),
              f"{tag}: {group}.{name} is not a packed leaf")
        x = (a.packed ^ b.packed)
        diff[name] = ((x & 0xF) != 0).sum((-2, -1)) + ((x >> 4) != 0).sum(
            (-2, -1))
    host = {k: v.cpu() for k, v in diff.items()}
    max_dloss, min_agree, iters_differ, first, differing = 0.0, 1.0, 0, None, 0
    for r_k, r_p in zip(rep_k, rep_p):
        check(r_k.qualname == r_p.qualname, f"{tag}: layer order")
        res_k = rep_k.artifacts[r_k.qualname].result
        res_p = rep_p.artifacts[r_p.qualname].result
        art = rep_k.artifacts[r_k.qualname]
        dict_path, idx = resolve_path(art.path, art.layer)
        if res_k.mask is not None:
            n_diff = int((res_k.mask != res_p.mask).sum())
            total = res_k.mask.size
        else:
            n_diff = int(host[dict_path[-1]][idx])
            total = cfg.d_model * (cfg.d_ff if "moe" in dict_path
                                   else cfg.num_heads * cfg.resolved_head_dim
                                   if dict_path[-1] == "wq"
                                   else cfg.num_kv_heads
                                   * cfg.resolved_head_dim)
        for r in (r_k, r_p):
            check(math.isfinite(r.loss_after) and 0.0 <= r.loss_after < 1.0,
                  f"{r.qualname}: loss {r.loss_after}")
            if r.method == "awp_prune":
                check(r.sparsity == 0.5, f"{r.qualname}: sparsity "
                                         f"{r.sparsity}")
        dloss = abs(r_k.loss_after - r_p.loss_after)
        if n_diff or res_k.iters != res_p.iters:
            differing += 1
            first = first or (r_k.qualname, n_diff, total)
        iters_differ += res_k.iters != res_p.iters
        max_dloss = max(max_dloss, dloss)
        min_agree = min(min_agree, 1.0 - n_diff / total)
    log(f"[{tag}] {n_layers} layers; max |loss difference| {max_dloss:.3e}; "
        f"least share of equal codes/mask entries {min_agree:.6f}; layers "
        f"with other iteration counts {iters_differ}; layers that differ "
        f"{differing}, the first {first}; mean loss {rep_k.mean_loss():.6f} "
        f"/ {rep_p.mean_loss():.6f}")
    check(max_dloss <= LOSS_BAR and min_agree >= AGREE_BAR,
          f"{tag}: the two compressions differ beyond the repo's bars")
    check(not exact or iters_differ == 0, f"{tag}: iteration counts differ")
    for run in (run_k, run_p):
        check_decode(torch, cfg, run["logits"], run["tokens"], tag)
    dlog = float((run_k["logits"] - run_p["logits"].to(
        run_k["logits"].device)).abs().max())
    same_tok = bool((run_k["tokens"] == run_p["tokens"]).all())
    parts = [int(i) for i in (run_k["tokens"] != run_p["tokens"]).nonzero()[0][:1]]
    log(f"[{tag}] prefill logits max |kernels - plain| {dlog:.3e}; greedy "
        f"tokens " + ("identical on both paths" if same_tok else
                      f"differ (first at row {parts})")
        + f"; row 0: {run_k['tokens'][0][:12].tolist()}")
    return dict(max_dloss=max_dloss, min_agree=min_agree,
                iters_differ=iters_differ, layers_differ=differing,
                first_diff=first, identical=differing == 0,
                logits_dmax=dlog, tokens_identical=same_tok)


def moe_engine_check(launches, stats, label):
    """Only K4, K4x, K5 and K6 launch in the MoE engine, and K4x three
    times a layer in every forward (decode steps, prefills, chunks)."""
    check_path(launches, MOE_ENGINE_PATH, label)
    forwards = stats["decode_steps"] + stats["prefills"] + stats["chunks"]
    check(launches["dequant_matmul_experts"]
          == 3 * MOE_LAYERS * forwards,
          f"{label}: K4x launched {launches['dequant_matmul_experts']} "
          f"times in {forwards} forwards, expected {3 * MOE_LAYERS} a "
          f"forward")


def phase_k4x_census(torch, dev, census):
    """K4x at every key the MoE paths launched (``census``: each path's
    ``ops.K4X_CENSUS``): every variant the wrapper can run there within
    1e-5 of max|y| of the plain version, the variant the path ran timed
    beside the plain version and the bmm yardstick, and each path's K4x
    device seconds (launches x time at each key)."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    keys = sorted({key for c in census.values() for key in c})
    times, gemv = {}, {}
    for e, n, k in sorted({key[:1] + key[2:4] for key in keys}):
        stack = k4x_stack(torch, dev, gen, e, n, k, 128)
        w32t = torch.stack([ref.dequant(ref.unpack_int4(stack[0][i]),
                                        stack[1][i], stack[2][i], 128)
                            for i in range(e)]).transpose(1, 2)
        for key in [key for key in keys if (key[0],) + key[2:4] == (e, n, k)]:
            m, v, per_expert = key[1], key[4], key[5]
            x = k4x_x(torch, dev, gen, e, m, k, per_expert)
            y_ref = ref.dequant_matmul_experts(x, *stack, 128, per_expert)
            ymax = float(y_ref.abs().max())
            for vv in ops.dequant_matmul_variants(m, k):
                d = float((ops.dequant_matmul_experts(
                    x, *stack, 128, per_expert, variant=vv) - y_ref)
                    .abs().max())
                check(d <= 1e-5 * ymax,
                      f"K4x census {key} variant {vv}: max|dy| {d:.3e}")
            times[key] = k4x_times(torch, x, stack, 128, per_expert, v, w32t)
            ms, plain, lib = times[key]
            # the GEMV the expert GEMV replaced (unsplit, its pick at E = 128)
            gemv[key] = (time_ms(torch, lambda i: ops.dequant_matmul_experts(
                x, *stack, 128, per_expert, variant=len(ops.DEQUANT_TILES)),
                10) if v == ops.GEMVX else ms)
            bnd, by = k4x_bound(e, m, n, k, 128, per_expert)
            log(f"[K4x census] E={e} M={m} N={n} K={k} "
                f"{'per-expert' if per_expert else 'shared'} "
                f"{ops.dequant_matmul_variant_name(v)}: launches "
                + ", ".join(f"{p} {c.get(key, 0)}" for p, c in census.items())
                + f"; every variant within 1e-5; kernel {ms:.4f} ms "
                f"({bnd / ms:.1%} of the bound)"
                + (f", gemv split 1 {gemv[key]:.4f} ms"
                   if v == ops.GEMVX else "")
                + f", plain {plain:.4f} ms, bmm {lib:.4f} ms, bound "
                f"{bnd:.4f} ms ({by})")
        del stack, w32t
        torch.cuda.empty_cache()
    out = {}
    for path, c in census.items():
        secs = [sum(cnt * times[key][i] for key, cnt in c.items()) / 1e3
                for i in range(3)]
        gemv_s = sum(cnt * gemv[key] for key, cnt in c.items()) / 1e3
        log(f"[K4x census] {path}: {sum(c.values())} launches at {len(c)} "
            f"keys; K4x device seconds {secs[0]:.4f} s (with the GEMV of "
            f"split 1 at the gemvx keys {gemv_s:.4f} s), the plain "
            f"version's {secs[1]:.4f} s, bmm's {secs[2]:.4f} s")
        out[path] = dict(launches=sum(c.values()), keys=len(c),
                         device_s=secs[0], gemv_device_s=gemv_s,
                         plain_s=secs[1], library_s=secs[2])
    out["by_key"] = [dict(key=list(key), ms=t[0], gemv_ms=gemv[key],
                          plain_ms=t[1], library_ms=t[2])
                     for key, t in sorted(times.items())]
    return out


def phase_moe(torch, dev):
    """The MoE family at full width (two layers): K4x and K6 at its shapes,
    then the main path through the kernels (counted, timed) and through
    the plain versions, held to each other at the parity bars; the slot
    engine on the kernels' packed model (kernels, sync-debug, plain); K4x's
    census. Nothing else is on the card meanwhile: each run makes its
    weights from the seed, and the kernel run's packed model waits in host
    memory while the plain run compresses. Returns the JSON row of K4x,
    the launches by path, the numbers and what :func:`phase_moe_profile`
    needs (the packed model in host memory, the engine's timed run)."""
    from repro_torch import kernels
    t0 = time.time()
    row = check_k4x(torch, dev)
    check_k6_moe(torch, dev)
    cfg = moe_config()
    model, calib, prompts = model_setup(torch, dev, cfg)
    torch.cuda.reset_peak_memory_stats()
    run_k = moe_run(torch, dev, cfg, model, calib, prompts, "moe kernels")
    check_path(run_k["launches"], MOE_PATH, "the MoE compress and decode path")
    check(run_k["compress_launches"]["dequant_matmul_experts"] == 0,
          "K4x launched during compression (no packed linear there)")
    forwards = 1 + GEN        # the logits prefill, greedy's prefill, steps
    check(run_k["launches"]["dequant_matmul_experts"]
          == 3 * MOE_LAYERS * forwards,
          f"K4x launched {run_k['launches']['dequant_matmul_experts']} "
          f"times on the static path, expected {3 * MOE_LAYERS} a forward")
    run_k["packed"] = to_host_tree(run_k["packed"])
    torch.cuda.empty_cache()
    with kernels.use_impl("reference"):
        from repro_torch.kernels import ops
        run_p = moe_run(torch, dev, cfg, model, calib, prompts, "moe plain")
        check(not any(ops.LAUNCHES.values()), "the plain MoE run launched a "
                                              "kernel")
    run_k["packed"] = to_card_tree(run_k["packed"], dev)
    held = moe_hold(torch, cfg, run_k, run_p, "moe layer", exact=False)
    plain_s = run_p["compress_s"]
    del run_p
    torch.cuda.empty_cache()
    packed = run_k["packed"]
    launches_e, tokens_e, eng, _, _ = phase_engine(
        torch, cfg, model, packed, "moe ", exact_first=False,
        path=MOE_ENGINE_PATH)
    k4x_slot = eng["kernels"]["k4x"]
    for run in ("kernels", "waits_counted", "plain"):
        eng[run].pop("k4x")
    moe_engine_check(launches_e, eng["kernels"], "the MoE engine")
    a2a_launches, a2a = check_a2a_moe(torch, dev, cfg, model, packed)
    # for the profile after every timed run (phase_moe_profile)
    keep = dict(cfg=cfg, model=model, packed=to_host_tree(packed),
                tokens=tokens_e, stats=eng["kernels"])
    del packed, run_k["packed"]
    torch.cuda.empty_cache()
    census = phase_k4x_census(torch, dev, {"static": run_k["k4x"],
                                           "slot": k4x_slot})
    row["census"] = census
    secs = time.time() - t0
    log(f"[moe] phase {secs:.1f}s; compression kernels "
        f"{run_k['compress_s']:.1f}s")
    summary = dict(seconds=secs, compress_s=run_k["compress_s"],
                   compress_plain_s=plain_s, decode=run_k["decode"],
                   kernels_vs_plain=held, engine=eng, a2a=a2a,
                   a2a_launches=a2a_launches)
    return row, {"moe_compress_decode": run_k["launches"],
                 "moe_engine": launches_e}, summary, keep


def phase_moe_profile(torch, dev, keep):
    """After every timed run: the MoE slot engine's kernel run once more in
    a ``StepTraceWindow`` (``keep``: :func:`phase_moe`'s packed model and
    timed run). Its tokens must be the timed run's, the trace's expert
    GEMV events K4x's launches of that variant, and its K4 and K4x GEMV
    and tile events the other launches of both. Prints the decode-only
    steps' device idle share and busy time, K4x's device time a step and
    its share of the steps' kernel time, and returns them."""
    from repro_torch.kernels import ops
    cfg, model, st_timed = keep["cfg"], keep["model"], keep["stats"]
    packed = to_card_tree(keep["packed"], dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, tokens, st, _, _ = run_engine(
            torch, model, packed, engine_trace(cfg),
            "moe engine kernels, profiled", profile=(tmp, st_timed["steps"]))
        with open(st["trace"]) as f:
            prof = read_profile(json.load(f)["traceEvents"])
    del packed
    torch.cuda.empty_cache()
    check(tokens == keep["tokens"],
          "moe profile: the profiled run's tokens differ")
    wins, kernels = prof["windows"], prof["kernels"]
    check(len(wins) == st["steps"] == st_timed["steps"],
          f"moe profile: {len(wins)} ProfilerStep windows for {st['steps']} "
          f"steps")
    n_gx = sum(c for key, c in st["k4x"].items() if key[4] == ops.GEMVX)
    gx = sum(c for k, c in kernels.items() if "dequant_gemvx_kernel" in k)
    rest = sum(c for k, c in kernels.items()
               if "dequant_gemv_kernel" in k or "dequant_gemm_kernel" in k)
    check(gx == n_gx > 0, f"moe profile: {gx} expert GEMV kernel events, "
                          f"{n_gx} launches")
    check(rest == launches["dequant_matmul"]
          + launches["dequant_matmul_experts"] - n_gx,
          f"moe profile: {rest} K4 and K4x GEMV and tile kernel events")
    decode = [w for w, a in zip(wins, st["admitted"]) if not a]
    out = profile_summary(prof, "moe engine", {
        "decode-only": decode,
        "admission": [w for w, a in zip(wins, st["admitted"]) if a]})
    inside = _inside(decode)
    k4x_ms = kern_ms = 0.0
    for e in prof["device"]:
        if e["cat"] == "kernel" and inside(e["ts"]):
            kern_ms += e["dur"] / 1e3
            if "dequant_gemvx_kernel" in e["name"]:
                k4x_ms += e["dur"] / 1e3
    n = max(len(decode), 1)
    o = out["decode-only"]
    o.update(k4x_ms=k4x_ms / n, kernel_ms=kern_ms / n,
             k4x_share=k4x_ms / kern_ms if kern_ms else 0.0,
             timed_step_ms=st_timed["decode_only_step_ms"])
    log(f"[moe profile] decode-only steps: {len(decode)}; device idle share "
        f"{o['idle_mean']:.4f} ({o['idle_min']:.4f}-{o['idle_max']:.4f}); "
        f"device busy {o['busy_ms']:.3f} ms of a {o['step_ms']:.3f} ms "
        f"profiled step ({o['timed_step_ms']:.3f} ms timed); kernel time "
        f"{o['kernel_ms']:.3f} ms a step, K4x (gemvx) {o['k4x_ms']:.3f} ms "
        f"of it ({o['k4x_share']:.1%}), {o['kernels']:.1f} kernels a step")
    return out


def parity_moe(torch, dev):
    """Under unsplit cuBLAS: K4x's tile bit-equal to its plain version at
    qwen3-moe's (N, K), M 64 and 512, E 8, both forms, every tile variant;
    at M 4 and 8 the expert GEMV bit-equal to the tile (both one k-order
    chain an output), and the entries where the tile, the expert GEMV and
    the GEMV differ from the plain version printed (a record: cuBLAS's
    kernels at M <= 8 sum in another order); then the MoE main path
    through the kernels, its compression in sync-debug mode with the
    host's waits counted a block, and through the plain versions: the same
    bits and static tokens if the compressions agree bit for bit (else the
    first differing layer is printed and the pair held to the bars), and
    every slot-engine request the same first token."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    checked, checked_chain, gemv = 0, 0, {}
    for n, k in K4X_NK:
        stack = k4x_stack(torch, dev, gen, 8, n, k, 128)
        for m in (4, 8, 64, 512):
            for per_expert in (False, True):
                x = k4x_x(torch, dev, gen, 8, m, k, per_expert)
                y_ref = ref.dequant_matmul_experts(x, *stack, 128, per_expert)
                tile = None
                for v in ops.dequant_matmul_variants(m, k):
                    y = ops.dequant_matmul_experts(x, *stack, 128, per_expert,
                                                   variant=v)
                    n_diff = int((y != y_ref).sum())
                    if v == 0:
                        tile = y
                    if m <= ops.GEMV_MAX_M:
                        if v in (0, len(ops.DEQUANT_TILES), ops.GEMVX):
                            gemv[(m, n, k, per_expert,
                                  ops.dequant_matmul_variant_name(v))] = n_diff
                        if v == ops.GEMVX:
                            checked_chain += 1
                            check(torch.equal(y, tile),
                                  f"K4x M={m} N={n} K={k}: gemvx differs from "
                                  f"the tile under unsplit cuBLAS")
                        continue
                    if v >= len(ops.DEQUANT_TILES):
                        continue
                    checked += 1
                    check(n_diff == 0, f"K4x M={m} N={n} K={k} variant {v}: "
                                       f"{n_diff} entries differ from the "
                                       f"plain version under unsplit cuBLAS")
    log(f"[parity K4x] tile bit-equal to the plain version at all {checked} "
        f"(shape, form, variant) triples at M > 8; gemvx bit-equal to the "
        f"tile at all {checked_chain} at M <= 8; entries differing from the "
        f"plain version at M <= 8 (a record): "
        + ", ".join(f"{key}: {d}" for key, d in gemv.items()))
    cfg = dataclasses.replace(moe_config(), num_layers=PARITY_MOE_LAYERS)
    model, calib, prompts = model_setup(torch, dev, cfg)
    run_k = moe_run(torch, dev, cfg, model, calib, prompts,
                    "parity moe kernels", count=True)
    run_k["packed"] = to_host_tree(run_k["packed"])
    torch.cuda.empty_cache()
    with kernels.use_impl("reference"):
        run_p = moe_run(torch, dev, cfg, model, calib, prompts,
                        "parity moe plain")
    run_k["packed"] = to_card_tree(run_k["packed"], dev)
    held = moe_hold(torch, cfg, run_k, run_p, "parity moe layer",
                    exact=False)
    log("[parity moe] kernels against plain: " + (
        "the same bits in every layer" if held["identical"] else
        f"{held['layers_differ']} layers differ, the first "
        f"{held['first_diff']}; held to the bars instead"))
    check(not held["identical"] or held["tokens_identical"],
          "parity moe: the same compression bits but other greedy tokens")
    del run_p
    torch.cuda.empty_cache()
    phase_engine(torch, cfg, model, run_k["packed"], "parity moe ",
                 exact_first=True, path=MOE_ENGINE_PATH, count_waits=False)
    del run_k
    torch.cuda.empty_cache()


def methods_config():
    """llama2-7b at its published widths, cut to METHODS_LAYERS layers
    (the one cut: 32 blocks of PGD for eight methods would take hours)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(METHODS_ARCH),
                               num_layers=METHODS_LAYERS)


def method_policy(method: str):
    """Every linear compressed with ``method`` at ratio 0.5, 4 bits, group
    128 (the fields its spec class has)."""
    from repro_torch.core import registry
    from repro_torch.core.specs import Policy
    cls = registry.spec_cls_for(method)
    kw = {f: v for f, v in dict(ratio=0.5, bits=4, group_size=128).items()
          if hasattr(cls, f)}
    return Policy(default=cls(method=method, **kw))


def check_checkpoint(torch, dev, params):
    """The port's ``CheckpointManager`` on the full-width params: save,
    then ``restore_latest`` onto the card, every leaf bit-equal; and
    ``restore_checkpoint`` refusing a packed checkpoint (a tiny llama2
    compressed with RTN, made here), which ``restore_latest_packed``
    loads. Returns the seconds."""
    from repro_torch.checkpoint import (CheckpointManager,
                                        restore_checkpoint,
                                        save_packed_checkpoint)
    from repro_torch.configs import get_tiny_config
    from repro_torch.core.compress import compress_model
    from repro_torch.models import build_model
    from repro_torch.quant import QTensor
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        mgr = CheckpointManager(os.path.join(tmp, "dense"))
        torch.cuda.synchronize()
        t0 = time.time()
        mgr.save(0, {"params": params})
        t_save = time.time() - t0
        t0 = time.time()
        restored, step = mgr.restore_latest({"params": params})
        torch.cuda.synchronize()
        t_restore = time.time() - t0
        check(step == 0, f"restore_latest gave step {step}")
        got = list(_leaves(restored["params"]))
        want = list(_leaves(params))
        check(len(got) == len(want) and all(
            a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(got, want)),
            "the restored checkpoint differs from the saved params")
        nbytes = sum(t.numel() * t.element_size() for t in want)
        del restored, got
        tiny = get_tiny_config(METHODS_ARCH)
        model_t = build_model(tiny)
        params_t = model_t.init(SEED, device=dev)
        cal = [{"tokens": torch.randint(0, tiny.vocab_size, (2, 16),
                                        device=dev)}]
        cp_t, rep_t = compress_model(model_t, params_t, cal,
                                     method_policy("rtn"))
        save_packed_checkpoint(os.path.join(tmp, "packed"), 0, cp_t, rep_t)
        path = CheckpointManager(os.path.join(tmp, "packed")).latest_path()
        try:
            restore_checkpoint(path, {"params": params_t})
            refused = False
        except ValueError:
            refused = True
        check(refused, "restore_checkpoint loaded a packed checkpoint")
        loaded, qts, _ = CheckpointManager(os.path.join(
            tmp, "packed")).restore_latest_packed(params_t, device=dev)
        check(isinstance(loaded["blocks"]["mlp"]["wd"], QTensor)
              and len(qts) == 7 * tiny.num_layers,
              "restore_latest_packed did not give packed leaves")
    log(f"[methods checkpoint] {nbytes / 1e9:.2f} GB of f32 params: save "
        f"{t_save:.2f}s, restore_latest onto the card {t_restore:.2f}s, "
        f"every leaf bit-equal; restore_checkpoint refused a packed "
        f"checkpoint, restore_latest_packed loaded it")
    return dict(save_s=t_save, restore_s=t_restore, gigabytes=nbytes / 1e9)


def block0_stats(model, params, calib):
    """Block 0's calibration statistics by capture key, as
    ``compress_model`` folds them (block 0's input is the embedding)."""
    from repro_torch.core.compress import _fold_captures
    stats = {}
    for b in calib:
        _, caps = model.block_apply_one(params, 0, model.embed(params, b),
                                        capture=True)
        _fold_captures(stats, caps, 0)
    return stats


def check_obs_on_host(torch, model, params, calib):
    """SparseGPT and GPTQ on block 0's wq (4096 x 4096) on the card and,
    the same f64 function, on the CPU: masks equal and Θ within 1e-5,
    GPTQ's codes equal on >= 99.99% of entries with each differing code
    one step off, its grids within 1e-6, each loss within 1e-5 relative
    (cuSOLVER's inverse and Cholesky differ from LAPACK's in the last
    bits). Returns the seconds and counts."""
    from repro_torch.core import awp, calibration as cal
    from repro_torch.core.baselines import gptq, sparsegpt
    from repro_torch.core.compress import get_linear
    stats = block0_stats(model, params, calib)
    w = get_linear(params, ("blocks", "attn", "wq"), 0)
    c32 = cal.covariance(stats["attn_in"], damp=0.01)
    c = c32.double()
    w_h, c_h, c32_h = w.cpu(), c.cpu(), c32.cpu()
    k = w.shape[1] // 2
    out = {}
    for name, fn in (("sparsegpt", lambda w_, c_: sparsegpt.prune_weight(
                         w_, c_, k)),
                     ("gptq", lambda w_, c_: gptq.quantize_weight(
                         w_, c_, 4, 128, return_qparams=True))):
        torch.cuda.synchronize()
        t0 = time.time()
        card = fn(w, c)
        torch.cuda.synchronize()
        t_card = time.time() - t0
        t0 = time.time()
        host = fn(w_h, c_h)
        t_host = time.time() - t0
        th, th_h = (card[0] if name == "gptq" else card).cpu(), \
            host[0] if name == "gptq" else host
        mask_diff = int(((th != 0) != (th_h != 0)).sum())
        dtheta = float((th - th_h).abs().max())
        l_card = float(awp.activation_loss(w_h, th, c32_h))
        l_host = float(awp.activation_loss(w_h, th_h, c32_h))
        row = dict(card_s=t_card, host_s=t_host, mask_diff=mask_diff,
                   max_dtheta=dtheta, loss_card=l_card, loss_host=l_host)
        msg = ""
        if name == "gptq":
            codes, codes_h = card[1].cpu(), host[1]
            row["codes_agree"] = float((codes == codes_h).double().mean())
            row["codes_max_step"] = float((codes - codes_h).abs().max())
            row["grid_rel"] = float(((card[2].cpu() - host[2]).abs()
                                     / host[2]).max())
            msg = (f", codes equal on {row['codes_agree']:.6f} (largest "
                   f"step {row['codes_max_step']:.0f}), grids within "
                   f"{row['grid_rel']:.1e}")
            check(row["codes_agree"] >= 0.9999 and row["codes_max_step"] <= 1
                  and row["grid_rel"] <= 1e-6,
                  f"GPTQ on the card against the CPU: {row}")
        else:
            check(mask_diff == 0 and dtheta <= 1e-5 * float(
                th_h.abs().max()), f"SparseGPT on the card against the CPU: "
                                   f"{row}")
        check(abs(l_card - l_host) <= 1e-5 * l_host,
              f"{name} on the card against the CPU: loss {l_card} / "
              f"{l_host}")
        log(f"[methods host] {name} block 0 wq {tuple(w.shape)}: card "
            f"{t_card:.2f}s, CPU {t_host:.2f}s (f64 on both); mask entries "
            f"differ {mask_diff}, max|dΘ| {dtheta:.2e}, loss {l_card:.6f} / "
            f"{l_host:.6f}" + msg)
        out[name] = row
    return out


def check_trace_loss(torch, model, params, calib):
    """Fig. 1's mode on block 0's wo: ``awp.prune(..., trace_loss=True,
    max_iters=60)`` on the kernels and plain, the traces within
    ``TRACE_BAR`` and neither rising more than ``TRACE_RISE`` a step.
    Returns the traces' ends and the kernels' launches."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core import awp, calibration as cal
    from repro_torch.core.compress import get_linear
    from repro_torch.kernels import ops
    w = get_linear(params, ("blocks", "attn", "wo"), 0)
    c = cal.covariance(block0_stats(model, params, calib)["attn_out_in"],
                       damp=0.01)
    k = w.shape[1] // 2
    ops.reset_launches()
    res_k = awp.prune(w, c, k, trace_loss=True, max_iters=60)
    tr_k = res_k.loss_trace.cpu().numpy()
    launches = {n: c_ for n, c_ in ops.LAUNCHES.items() if c_}
    with kernels.use_impl("reference"):
        tr_p = awp.prune(w, c, k, trace_loss=True,
                         max_iters=60).loss_trace.cpu().numpy()
    dmax = float(np.abs(tr_k - tr_p).max())
    rise = float(max(np.diff(tr_k).max(), np.diff(tr_p).max()))
    log(f"[methods trace] awp.prune block 0 wo, 60 steps: loss "
        f"{tr_k[0]:.6f} -> {tr_k[-1]:.6f} (plain {tr_p[0]:.6f} -> "
        f"{tr_p[-1]:.6f}); max|kernels - plain| {dmax:.2e}, largest rise "
        f"a step {rise:.2e}; launches {launches}")
    check(int(res_k.iters) == 60 and tr_k.shape == (60,), "trace length")
    check(dmax <= TRACE_BAR and rise <= TRACE_RISE and tr_k[-1] <= tr_k[0],
          f"loss traces: max|dtrace| {dmax:.2e}, largest rise {rise:.2e}")
    check(launches == {"awp_pgd_step": 60, "topk_row": 60},
          f"the traced prune's launches {launches}")
    return dict(first=float(tr_k[0]), last=float(tr_k[-1]), max_diff=dmax,
                max_rise=rise, launches=launches)


def check_methods_shapes(torch, dev):
    """K1 (every tile variant), K1b and K3 (bits 4) at llama2-7b's linears,
    each held to its plain version and timed beside it and its bound (K1
    and K1b also beside ``addmm``/``baddbmm``). Returns the JSON entries
    by kernel."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    out = {"awp_pgd_step": [check_k1(torch, randn, m, k)
                            for m, k in LLAMA2_K1],
           "awp_pgd_step_batched": [k1b_entry(torch, randn, *shape)
                                    for shape in LLAMA2_K1B],
           "quant_project": [check_k3(torch, randn, r, d, 4)
                             for r, d in LLAMA2_K1]}
    torch.cuda.empty_cache()
    return out


def phase_methods(torch, dev):
    """The paper's evaluation path on llama2-7b at its published widths
    (``METHODS_LAYERS`` layers): the checkpoint round trip, perplexity
    before, then each method of ``METHODS`` through the batched engine on
    the kernels (its host waits counted a block in sync-debug mode, which
    is also the run timed; only its kernels may launch) and, where its
    compression launches a kernel, through the plain versions, held to
    each other at the repo's bars (RTN, SparseGPT and GPTQ launch none, so
    their plain run would be the same code: they run once),
    with its perplexity after; for
    the methods with packed artifacts the packed model's perplexity
    through K4, held to the dense Θ's. Then SparseGPT and GPTQ on the card
    against the CPU, Fig. 1's trace, and K1, K1b and K3 at llama2-7b's
    shapes. Returns the kernels' new JSON entries, the launches, K4's and
    K2's census and the numbers."""
    from repro_torch import kernels
    from repro_torch.checkpoint import pack_params
    from repro_torch.core.compress import compress_model
    from repro_torch.data import DataConfig, ZipfMarkov, calibration_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.compress import perplexity
    from repro_torch.models import build_model
    from repro_torch.quant import QTensor
    t_phase = time.time()
    cfg = methods_config()
    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    log(f"[methods] {cfg.name}: {cfg.num_layers} of 32 layers (the one "
        f"cut), d_model {cfg.d_model}, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads} KV heads of {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), "
        f"untied, {sum(t.numel() for t in _leaves(params)) / 1e9:.3f}e9 f32 "
        f"parameters from seed {SEED}")
    summary = dict(checkpoint=check_checkpoint(torch, dev, params))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=EVAL_SEQ,
                    global_batch=EVAL_BATCH)
    calib = [{"tokens": torch.as_tensor(t, device=dev)}
             for t, _ in calibration_batches(dc, EVAL_BATCHES)]
    evals = [tuple(torch.as_tensor(a, device=dev)
                   for a in ZipfMarkov(dc).batch(9000 + i))
             for i in range(EVAL_BATCHES)]
    before = perplexity(model, params, evals)
    log(f"[methods] perplexity before {before:.3f} ({EVAL_BATCHES} held-out "
        f"batches of {EVAL_BATCH} x {EVAL_SEQ}; random weights)")
    check(math.isfinite(before), f"perplexity before {before}")
    summary["perplexity_before"] = before
    data = (model, params, calib, None)
    n_layers = 7 * cfg.num_layers
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    k4_census, k2_census, runs = {}, {}, {}
    for method, kernels_used in METHODS.items():
        policy = method_policy(method)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        waits, rep_k, cp = count_waits(torch, data, policy,
                                       f"methods {method} ", keep=True)
        torch.cuda.synchronize()
        t_k = time.time() - t0
        comp = dict(ops.LAUNCHES)
        check_path(comp, kernels_used, f"{method}'s compression")
        for key, n in ops.K2_CENSUS.items():
            k2_census[key] = k2_census.get(key, 0) + n
        after = perplexity(model, cp, evals)
        row = dict(kernels_s=t_k, waits_per_block=waits, perplexity=after,
                   sparsity=rep_k.mean_sparsity(),
                   mean_loss=rep_k.mean_loss(), compress_launches=comp)
        if method in PACKED_METHODS:
            packed = pack_params(cp, rep_k)
            leaves = [(g, n) for g, n in (("attn", "wq"), ("attn", "wk"),
                                          ("attn", "wv"), ("attn", "wo"),
                                          ("mlp", "wg"), ("mlp", "wu"),
                                          ("mlp", "wd"))
                      if isinstance(packed["blocks"][g][n], QTensor)]
            check(len(leaves) == 7, f"{method}: packed leaves {leaves}")
            row["perplexity_packed"] = perplexity(model, packed, evals)
            k4 = ops.LAUNCHES["dequant_matmul"]
            check(k4 == n_layers * EVAL_BATCHES,
                  f"{method}: K4 launched {k4} times in the packed pass, "
                  f"expected {n_layers * EVAL_BATCHES}")
            rel = abs(row["perplexity_packed"] - after) / after
            check(rel <= PPL_BAR, f"{method}: packed perplexity "
                                  f"{row['perplexity_packed']} against the "
                                  f"dense Θ's {after} ({rel:.1e})")
            for key, n in ops.K4_CENSUS.items():
                k4_census[key] = k4_census.get(key, 0) + n
            del packed
        for name, n in ops.LAUNCHES.items():
            launches[name] += n
        del cp
        torch.cuda.empty_cache()
        ops.reset_launches()
        if kernels_used:
            with kernels.use_impl("reference"):
                torch.cuda.synchronize()
                t0 = time.time()
                cp_p, rep_p = compress_model(model, params, calib, policy)
                torch.cuda.synchronize()
                row["plain_s"] = time.time() - t0
                row["perplexity_plain"] = perplexity(model, cp_p, evals)
            check(not any(ops.LAUNCHES.values()), f"{method}'s plain run "
                                                  f"launched a kernel")
            del cp_p
            torch.cuda.empty_cache()
            row["kernels_vs_plain"] = hold_reports(
                torch, rep_k, rep_p, f"methods {method}", n_layers,
                iters_equal=False, show_all=True)
        else:
            row["plain_s"], row["perplexity_plain"] = t_k, after
        check(math.isfinite(after) and math.isfinite(row["perplexity_plain"]),
              f"{method}: perplexity {after} / {row['perplexity_plain']}")
        log(f"[methods] {method}: compression on the kernels {t_k:.2f}s "
            f"(sync-debug mode), plain "
            + (f"{row['plain_s']:.2f}s" if kernels_used else
               "the same code (no kernel launched)")
            + f"; sparsity "
            f"{row['sparsity']:.4f}, mean loss {row['mean_loss']:.6f}; "
            f"perplexity {before:.3f} -> {after:.3f} (plain "
            f"{row['perplexity_plain']:.3f}"
            + (f", packed through K4 {row['perplexity_packed']:.3f}"
               if "perplexity_packed" in row else "")
            + f"); host waits a block {waits}; launches {comp}")
        runs[method] = row
    check_path(launches, METHODS_PATH, "the methods path")
    summary["methods"] = runs
    summary["obs_on_host"] = check_obs_on_host(torch, model, params, calib)
    summary["trace"] = check_trace_loss(torch, model, params, calib)
    del data, params, calib, evals
    torch.cuda.empty_cache()
    shapes = check_methods_shapes(torch, dev)
    summary["seconds"] = time.time() - t_phase
    log(f"[methods] phase {summary['seconds']:.1f}s; launches {launches}")
    return shapes, launches, k4_census, k2_census, summary


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
    the kernels' counts, both runs' outputs and K4's and K2's census."""
    from repro_torch import kernels
    from repro_torch.kernels import ops

    ops.reset_launches()
    out_k = run_path(torch, dev, data, f"{tag}kernels", engine)
    launches = dict(ops.LAUNCHES)
    census = dict(ops.K4_CENSUS), dict(ops.K2_CENSUS)
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
    return launches, out_k, out_p, census


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


def count_waits(torch, data, policy, tag, keep=False):
    """One batched compression, untimed, in PyTorch's sync-debug mode: the
    host's waits on the card per block and where each comes from (file and
    line of the call that waited). Returns the waits a block and the
    report, and with ``keep`` the compressed params too."""
    from collections import Counter
    from repro_torch.core.compress import compress_model
    model, params, calib, _ = data
    torch.cuda.synchronize()
    with host_waits(torch, True) as waits:
        caught = waits["caught"]

        def so_far():
            return sum(SYNC_WARNING in str(w.message) for w in caught)
        marked = _BlockMarks(model, so_far)
        cp, report = compress_model(marked, params, calib, policy)
        if not keep:
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
    expect = expected_waits(params, report, model.num_blocks())
    check(per_block == expect, f"host waits per block {per_block}, "
                               f"expected {expect}")
    return (per_block, report, cp) if keep else (per_block, report)


def expected_waits(params, report, n_blocks):
    """The host's waits a block of one batched compression: the block's
    token counts and its end-of-block transfer, plus for an AWP prune one
    read after each chunk of ``awp.PGD_CHUNK_ITERS`` steps — of ``pgd``'s
    loop when the layer runs alone (none after the chunk that ends at the
    cap), of ``prune_batched_compacted``'s when a bucket (same block,
    method and shape) holds several, until its last item stops. Every
    other method reads nothing on the host."""
    from repro_torch.core import awp
    from repro_torch.core.compress import _linear_view
    chunk, cap = awp.PGD_CHUNK_ITERS, awp.PRUNE_CONFIG.max_iters
    expect = [2] * n_blocks
    buckets = {}
    for r in report:
        art = report.artifacts[r.qualname]
        shape = tuple(_linear_view(params, art.path, art.layer).shape)
        buckets.setdefault((r.block, r.method, shape), []).append(
            art.result.iters)
    for (block, method, _), its in buckets.items():
        if method == "awp_prune":
            alone = len(its) == 1
            expect[block] += min(-(-max(its) // chunk),
                                 -(-cap // chunk) - alone)
    return expect


def profile_compression(torch, data, report, n_layers):
    """One batched mixed-policy compression, timed by nothing, with block
    ``PROFILE_BLOCK`` wrapped in the port's ``trace_window``
    (``torch.profiler``, CPU and CUDA activity) and a registry of its own:
    its codes, masks and iteration counts must equal ``report``'s (the
    timed kernel run's), the window must hold K1's, K2's and K3's kernel
    events, and the block's device idle share, top device and host ops
    and longest idle gaps are printed, with one ``[obs]`` line of the
    registry."""
    from repro_torch.core.compress import compress_model
    from repro_torch.obs import MetricsRegistry, hist_quantile
    model, params, calib, _ = data
    reg = MetricsRegistry()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cp, rep = compress_model(model, params, calib, policy_for("mixed"),
                                 metrics=reg, profile_dir=tmp,
                                 profile_block=PROFILE_BLOCK)
        del cp
        path = Path(tmp) / "block-0.trace.json"
        check(path.is_file(), "the profiled compression block wrote no "
                              "trace (the profiler did not start)")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    prof = read_profile(events)
    kernels = prof["kernels"]
    check(sum(kernels.values()) > 0, "the profiled compression block's "
                                     "trace holds no CUDA kernel event")
    by_kernel = {name: sum(c for k, c in kernels.items() if name in k)
                 for name in ("awp_pgd_step_kernel", "topk_row_kernel",
                              "quant_project_kernel")}
    log(f"[profile] compression block {PROFILE_BLOCK}: {len(events)} trace "
        f"events; kernel events {by_kernel}, {sum(kernels.values())} in all")
    check(all(by_kernel.values()), f"the profiled compression block lacks "
                                   f"a kernel: {by_kernel}")
    held = hold_reports(torch, report, rep, "profiled compression",
                        n_layers, iters_equal=True)
    check(held["identical"], "the profiled compression's codes, masks or "
                             "iteration counts differ from the timed run's")
    out = profile_summary(prof, f"compression block {PROFILE_BLOCK}",
                          {"block": prof["windows"]})
    snap = reg.snapshot()
    layers = {s["labels"]["method"]: s["value"] for s in
              snap["counters"]["compress_layers_total"]["series"]}
    (blocks,) = snap["histograms"]["compress_block_seconds"]["series"]
    iters = snap["histograms"]["compress_pgd_iters"]["series"]
    check(sum(layers.values()) == n_layers and blocks["count"]
          == model.num_blocks(), f"compression registry: layers {layers}, "
                                 f"{blocks['count']} block samples")
    log(f"[obs] profiled compression: layers {layers}; block seconds "
        f"{blocks['sum'] / blocks['count']:.3f} mean over "
        f"{blocks['count']} blocks; PGD iterations p50 " + ", ".join(
            f"{s['labels']['method']} {hist_quantile(s, 0.5):.0f}"
            for s in iters))
    out["kernel_events"] = by_kernel
    return out


def phase_main_path(torch, dev, cfg, data):
    """The main path as the port's users run it (the batched engine):
    through the kernels (counted), and through the plain versions for
    their times; then the reference driver on the kernels, held to the
    batched engine's compression, and the host's waits in one batched
    compression. Returns the counts, the kernels' packed params (the
    engine's), K4's census, K2's census of both engines, the numbers and
    the kernel run's report (the profiled compression is held to it)."""
    from repro_torch.kernels import ops
    model, _, _, prompts = data
    launches, out_k, out_p, (census, k2_batched) = both_paths(
        torch, dev, data, "", "batched")
    summary = compare(torch, dev, cfg, model, prompts, out_k, out_p, "",
                      mode="bars")
    t_plain = out_p[4]
    del out_p
    ops.reset_launches()
    cp, rep_s, t_seq = compress(torch, data, policy_for("mixed"),
                                "sequential")
    del cp
    seq_launches = dict(ops.LAUNCHES)
    k2_seq = dict(ops.K2_CENSUS)
    check_path(seq_launches, ("awp_pgd_step", "topk_row", "quant_project"),
               "the sequential compression")
    # compression runs no packed linear (check_path above): every K4
    # launch of the main path is the static decode's
    check(launches["dequant_matmul"] == sum(census.values()),
          "K4's census does not match its launches on the main path")
    engines = hold_reports(torch, out_k[0], rep_s, "engines mixed",
                           7 * cfg.num_layers, iters_equal=True)
    log(f"[engines mixed] compression on the kernels: batched "
        f"{out_k[4]:.2f}s, sequential {t_seq:.2f}s; batched plain "
        f"{t_plain:.2f}s; launches batched {launches}, sequential "
        f"{seq_launches}")
    per_block, _ = count_waits(torch, data, policy_for("mixed"), "mixed ")
    k2 = {"compress batched": k2_batched, "compress sequential": k2_seq}
    return launches, out_k[1], census, k2, dict(
        batched_s=out_k[4], sequential_s=t_seq, batched_plain_s=t_plain,
        kernels_vs_plain=summary, engines=engines,
        waits_per_block=per_block), out_k[0]


def phase_prune_path(torch, cfg, data):
    """The Table-1 prune policy on blocks 0 and 1 at full width, which
    reaches ``prune_batched_compacted`` with buckets {wq, wo}, {wk, wv},
    {wg, wu} at B = 2 (wd alone): the batched engine on the kernels
    (counted), the same through the plain versions, held to it, then the
    sequential driver on the kernels (counted), held to the batched one.
    Returns the batched run's counts, K2's census of both engines and the
    numbers."""
    from repro_torch import kernels
    from repro_torch.kernels import ops
    pol = policy_for("table1")
    ops.reset_launches()
    cp, rep_b, t_b = compress(torch, data, pol, "batched")
    del cp
    launches = dict(ops.LAUNCHES)
    k2 = {"prune batched": dict(ops.K2_CENSUS)}
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
    k2["prune sequential"] = dict(ops.K2_CENSUS)
    check_path(seq_launches, ("awp_pgd_step", "topk_row"),
               "the sequential prune")
    held = hold_reports(torch, rep_b, rep_s, "engines table1", 14,
                        iters_equal=True)
    iters = {r.qualname: rep_b.artifacts[r.qualname].result.iters
             for r in rep_b}
    log(f"[prune] Table-1 policy, blocks 0-1: batched {t_b:.2f}s, "
        f"sequential {t_s:.2f}s on the kernels, batched plain {t_p:.2f}s; "
        f"iterations {iters}; sequential launches {seq_launches}")
    return launches, k2, dict(batched_s=t_b, sequential_s=t_s,
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


def paged_trace(cfg):
    """The paged phase's requests: :func:`engine_trace`, then
    ``PREFIX["requests"]`` requests that share one system prompt of
    ``PREFIX["prefix"]`` tokens, each with its own Zipf-length tail."""
    import numpy as np
    from repro_torch.data import DataConfig, ZipfMarkov
    from repro_torch.serving import GenerationRequest
    reqs = engine_trace(cfg)
    n, pre, tail = PREFIX["requests"], PREFIX["prefix"], PREFIX["max_tail"]
    toks, _ = ZipfMarkov(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=pre + tail, global_batch=n,
                                    seed=SEED + 2)).batch(0)
    rng = np.random.default_rng(SEED + 2)
    for i in range(n):
        k = int(np.clip(rng.zipf(1.6), 1, tail))
        reqs.append(GenerationRequest(
            rid=len(reqs), prompt=np.concatenate(
                [toks[0, :pre], toks[i, pre:pre + k]]).astype("int32"),
            max_new_tokens=PREFIX["new"]))
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


def run_engine(torch, model, packed, reqs, label, watch_waits=False,
               ecfg=None, k6_census=False, profile=None):
    """One engine run over ``reqs`` (warm-up first, uncounted) with
    ``ecfg`` (the slot phase's ``ENGINE`` by default): launch counts set
    to 0 just before the run and read just after (and K4's census),
    ``check_invariants`` after every step, and the time of every step.
    ``watch_waits`` also counts the host's waits on the card and fails
    unless there is exactly one a decode step, batched prefill, chunked
    prompt and preemption. ``k6_census`` arms ``ops.K6_CENSUS`` for the
    run (device clones of each K6/K6p launch's lengths and table, read
    after it); its records are the last value returned. ``profile`` (a
    directory and the run's step count) wraps the run in the port's
    ``StepTraceWindow`` from its first step to its last; the trace's path
    is ``stats["trace"]``. Every run checks the engine's registry snapshot
    against its counters (:func:`check_snapshot`)."""
    from repro_torch.kernels import ops
    from repro_torch.obs import StepTraceWindow
    from repro_torch.serving import Engine, EngineConfig, cache_is_finite
    engine = Engine(model, packed, EngineConfig(**(ecfg or ENGINE)))
    engine.warmup(reqs)
    torch.cuda.synchronize()
    steps = []          # (seconds, admitted in the step)
    last = [0.0, 0]     # end of the previous step, admissions so far
    window = StepTraceWindow(*(profile or ("", 0)))

    def hook(eng):
        # every step ends in a host read of its tokens, so the host clock
        # sees the device's work done
        eng.check_invariants()
        now = time.perf_counter()
        window.on_step(eng)           # the step's ProfilerStep span ends
        admits = eng.prefill_dispatches + eng.chunk_dispatches + eng.resumes
        steps.append((now - last[0], admits != last[1]))
        last[0], last[1] = now, admits

    ops.reset_launches()
    armed = ops.arm_k6_census(k6_census)
    try:
        with host_waits(torch, watch_waits) as waits:
            window.start()
            check(window.active or not window.enabled,
                  f"{label}: the profiler window did not start")
            t0 = last[0] = time.perf_counter()
            for r in reqs:
                engine.submit(r)
            results = engine.run(step_hook=hook)
        torch.cuda.synchronize()
    finally:
        ops.arm_k6_census(armed)
    wall = time.perf_counter() - t0
    check(not window.active, f"{label}: the profiler window outlived the "
                             f"run ({window.steps} steps asked)")
    check(window.path or not window.enabled,
          f"{label}: the profiler window wrote no trace")
    launches = dict(ops.LAUNCHES)
    census = dict(ops.K4_CENSUS)
    k4x = dict(ops.K4X_CENSUS)
    k6 = list(ops.K6_CENSUS)
    if watch_waits:
        # one wait each: a decode step's (S, 2) read, a prefill's first
        # tokens, a chunked prompt's last token, a spill's one transfer
        reads = (engine.decode_steps + engine.prefill_dispatches
                 + engine.chunked_admitted + engine.preemptions)
        where = sorted({f"{Path(w.filename).name}:{w.lineno}"
                        for w in waits["syncs"]})
        log(f"[{label}] host waits on the card: {len(waits['syncs'])} for "
            f"{reads} decode steps, prefills, chunked prompts and "
            f"preemptions, at {where}; {waits['other']} other warnings")
        check(len(waits["syncs"]) == reads,
              f"{label}: {len(waits['syncs'])} host waits, expected one a "
              f"decode step, prefill, chunked prompt or preemption ({reads})")
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
                 admission_steps=len(steps) - len(dec),
                 admitted=[a for _, a in steps], trace=window.path,
                 kv_bytes=engine.kv_cache_bytes(),
                 prefills=engine.prefill_dispatches,
                 chunks=engine.chunk_dispatches,
                 chunked=engine.chunked_admitted,
                 utilization=engine.utilization(),
                 page_stats=engine.page_stats(), k4x=k4x)
    log(f"[{label}] {len(reqs)} requests, {n_tok} tokens in {wall:.3f}s "
        f"({stats['tok_s']:.1f} tok/s); {engine.decode_steps} decode steps, "
        f"{stats['step_ms']:.2f} ms a step overall, "
        f"{stats['decode_only_step_ms']:.2f} ms a decode-only step "
        f"({len(dec)} steps), {stats['admission_s']:.3f}s in steps with "
        f"admissions or resumes ({engine.prefill_dispatches} prefills, "
        f"{engine.chunk_dispatches} chunks for {engine.chunked_admitted} "
        f"chunked prompts); slot utilization {stats['utilization']:.3f}; "
        f"KV cache {stats['kv_bytes'] / 1e6:.1f} MB (INT8)")
    if stats["page_stats"]:
        log(f"[{label}] pages: {stats['page_stats']}")
    log(f"[{label}] launches: {launches}")
    check_snapshot(engine, label, len(reqs))
    del engine
    torch.cuda.empty_cache()
    check(sum(census.values()) == launches["dequant_matmul"],
          f"{label}: K4's census does not match its launches")
    check(not k6_census or len(k6) == launches["decode_attn"]
          + launches["decode_attn_paged"],
          f"{label}: K6's census does not match its launches")
    return launches, {r.rid: r.tokens for r in results}, stats, census, k6


def check_snapshot(engine, label, n_requests):
    """One ``[obs]`` line from the engine's registry snapshot, held to the
    engine's own counters: its decode steps, one TTFT sample and one ``ok``
    result a request and, on the paged layout, the preemption, resume and
    prefix-hit counters of ``page_stats()``."""
    from repro_torch.obs import hist_quantile, snapshot_series
    snap = engine.metrics_snapshot()

    def series(kind, name, **labels):
        entry = snapshot_series(snap, kind, name, labels or None)
        check(entry is not None, f"{label}: no {name} {labels} in the "
                                 f"registry snapshot")
        return entry

    dec = series("counters", "engine_decode_steps_total")["value"]
    ok = series("counters", "engine_requests_total", status="ok")["value"]
    hists = {k: series("histograms", f"request_{k}_seconds")
             for k in ("queue", "ttft", "tpot", "latency")}
    check(dec == engine.decode_steps,
          f"{label}: engine_decode_steps_total {dec}, decode_steps "
          f"{engine.decode_steps}")
    check(hists["ttft"]["count"] == n_requests,
          f"{label}: {hists['ttft']['count']} TTFT samples for "
          f"{n_requests} requests")
    check(ok == n_requests, f"{label}: {ok} ok results of {n_requests}")
    line = (f"decode steps {dec:.0f}, requests ok {ok:.0f}, queue depth "
            f"peak {series('gauges', 'engine_queue_depth')['peak']:.0f}; "
            + ", ".join(f"{k} p50 {1e3 * hist_quantile(h, 0.5):.1f} ms p99 "
                        f"{1e3 * hist_quantile(h, 0.99):.1f} ms"
                        for k, h in hists.items()))
    ps = engine.page_stats()
    if ps:
        got = {k: series("counters", f"engine_{k}_total")["value"]
               for k in ("preemptions", "resumes", "prefix_hits")}
        check(got == {k: ps[k] for k in got},
              f"{label}: registry {got}, page_stats {ps}")
        line += "; " + ", ".join(f"{k} {v:.0f}" for k, v in got.items())
    log(f"[obs] {label}: {line}")


def profile_summary(prof, label, classes):
    """Idle share, busy and step ms and kernels of each class of step
    windows (``classes``: name -> windows of :func:`read_profile`'s
    ``prof``), then the top device and host ops and the longest idle gaps
    of the first class. Prints them and returns the numbers."""
    out = {}
    for name, wins in classes.items():
        if not wins:
            continue
        idle = [w["idle"] for w in wins]
        out[name] = dict(
            steps=len(wins), idle_mean=sum(idle) / len(idle),
            idle_min=min(idle), idle_max=max(idle),
            busy_ms=sum(w["busy_ms"] for w in wins) / len(wins),
            step_ms=sum(w["ms"] for w in wins) / len(wins),
            host_ops_ms=sum(w["host_ms"] for w in wins) / len(wins),
            kernels=sum(w["kernels"] for w in wins) / len(wins),
            **{k: sum(w[k] for w in wins) / len(wins)
               for k in ("lead_ms", "dispatch_ms", "tail_ms")})
        o = out[name]
        log(f"[profile] {label}, {name}: {o['steps']} windows; device idle "
            f"share {o['idle_mean']:.4f} mean ({o['idle_min']:.4f} min, "
            f"{o['idle_max']:.4f} max); device busy {o['busy_ms']:.3f} ms "
            f"a step of {o['step_ms']:.3f} ms profiled, {o['kernels']:.1f} "
            f"kernels a step; host inside ops {o['host_ops_ms']:.3f} ms a "
            f"step (the rest is Python between ops); before the first "
            f"launch {o['lead_ms']:.3f} ms, first to last launch "
            f"{o['dispatch_ms']:.3f} ms, after the last {o['tail_ms']:.3f} "
            f"ms")
    first = next(iter(classes.values()))
    dev = device_ops(prof, first, 10)
    host = host_ops(prof, first, 10)
    gaps = idle_gaps(prof, first, 5)
    n = max(len(first), 1)
    log(f"[profile] {label}: top device ops by total time (ms and count a "
        f"window): " + "; ".join(f"{k[:90]} {ms / n:.4f} ({c / n:.1f})"
                                 for k, ms, c in dev))
    log(f"[profile] {label}: top host ops by self time (ms and count a "
        f"window): " + "; ".join(f"{k[:60]} {ms / n:.4f} ({c / n:.1f})"
                                 for k, ms, c in host))
    log(f"[profile] {label}: longest idle gaps: " + "; ".join(
        f"{g['ms']:.3f} ms at step {g['step']} +{g['at_us'] / 1e3:.3f} ms "
        f"under {g['host_op'] or '(no op: Python)'}" for g in gaps))
    return dict(out, device_ops=dev, host_ops=host, gaps=gaps)


def profile_engine(torch, model, packed, reqs, label, tokens, st_timed,
                   k6_name, ecfg=None):
    """One more kernel run of an engine, timed by nothing, wrapped in the
    port's ``StepTraceWindow`` (``torch.profiler``, CPU and CUDA activity)
    from its first step to its last. It must give the timed run's tokens,
    one ``ProfilerStep`` window a step, and kernel events at its launch
    counts: K4's GEMV and tile kernels at ``dequant_matmul``'s, K6's or
    K6p's split kernel at ``k6_name``'s. Prints the device idle share of
    the decode-only steps and of the steps that admit or resume, the top
    device and host ops and the longest idle gaps of the decode-only
    steps, and the profiled step time beside the timed run's."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, tok, st, _, _ = run_engine(
            torch, model, packed, reqs, f"{label} kernels, profiled",
            ecfg=ecfg, profile=(tmp, st_timed["steps"]))
        t0 = time.perf_counter()
        with open(st["trace"]) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(st["trace"])
    t_read = time.perf_counter() - t0
    check(tok == tokens, f"{label}: the profiled run's tokens differ")
    prof = read_profile(events)
    wins, kernels = prof["windows"], prof["kernels"]
    check(sum(kernels.values()) > 0,
          f"{label}: the profiler trace holds no CUDA kernel event")
    check(len(wins) == st["steps"] == st_timed["steps"],
          f"{label}: {len(wins)} ProfilerStep windows for {st['steps']} "
          f"steps")
    n_k4 = sum(c for k, c in kernels.items()
               if "dequant_gemv_kernel" in k or "dequant_gemm_kernel" in k)
    n_k6 = sum(c for k, c in kernels.items() if "decode_split_kernel" in k)
    log(f"[profile] {label}: {len(events)} trace events ({size / 1e6:.1f} "
        f"MB); kernel events: K4 {n_k4} (launches "
        f"{launches['dequant_matmul']}), {k6_name} split {n_k6} (launches "
        f"{launches[k6_name]}), {sum(kernels.values())} in all")
    check(n_k4 == launches["dequant_matmul"],
          f"{label}: {n_k4} K4 kernel events, {launches['dequant_matmul']} "
          f"launches")
    check(n_k6 == launches[k6_name],
          f"{label}: {n_k6} split kernel events, {launches[k6_name]} "
          f"{k6_name} launches")
    classes = {"decode-only": [w for w, a in zip(wins, st["admitted"])
                               if not a],
               "admission": [w for w, a in zip(wins, st["admitted"]) if a]}
    out = profile_summary(prof, label, classes)
    timed = {"decode-only": st_timed["decode_only_step_ms"],
             "admission": 1e3 * st_timed["admission_s"]
             / max(st_timed["admission_steps"], 1)}
    for name, ms in timed.items():
        o = out[name]
        o["timed_step_ms"] = ms
        log(f"[profile] {label}, {name}: profiled step {o['step_ms']:.3f} "
            f"ms against {ms:.3f} ms in the timed run: the profiler adds "
            f"{o['step_ms'] - ms:.3f} ms ({o['step_ms'] / ms:.2f}x) on the "
            f"host")
    t_total = time.perf_counter() - t0
    log(f"[profile] {label}: the profiled run {st['wall_s']:.1f} s (the "
        f"timed run {st_timed['wall_s']:.1f} s; the trace's export is in "
        f"its last step), reading the trace {t_read:.1f} s, its analysis "
        f"{t_total - t_read:.1f} s")
    out["trace_events"], out["trace_mb"] = len(events), size / 1e6
    out["cost_s"] = dict(run=st["wall_s"], timed_run=st_timed["wall_s"],
                         read=t_read, analysis=t_total - t_read)
    return out


def k6_census_run(torch, model, packed, reqs, label, tokens, launches,
                  ecfg=None):
    """A third kernel run of an engine, timed by nothing, with
    ``ops.K6_CENSUS`` armed: its K6/K6p records (the timed run and the
    sync-debug run carry no census). It must give the timed run's tokens
    and K6/K6p launches."""
    got, tok_c, _, _, k6 = run_engine(torch, model, packed, reqs,
                                      f"{label} kernels, K6 census",
                                      ecfg=ecfg, k6_census=True)
    check(tok_c == tokens, f"{label}: the census run's tokens differ")
    for name in ("decode_attn", "decode_attn_paged"):
        check(got[name] == launches[name],
              f"{label}: the census run launched {name} {got[name]} times, "
              f"the timed run {launches[name]}")
    return k6


def phase_engine(torch, cfg, model, packed, tag, exact_first,
                 k6_census=False, path=ENGINE_PATH, count_waits=True):
    """The engine through the kernels (K4, K5 and K6 must launch), with
    ``count_waits`` again in sync-debug mode, then through the plain
    versions (nothing may launch), on the same packed model and trace;
    with ``k6_census`` another kernel run records K6's census
    (:func:`k6_census_run`). Greedy tokens are compared; with
    ``exact_first`` the first token of every request must be equal on both
    paths. The parity process passes ``count_waits=False``: the main
    process counts the same run's waits."""
    from repro_torch import kernels
    reqs = engine_trace(cfg)
    plens = sorted(r.prompt_len for r in reqs)
    log(f"[{tag}engine] {len(reqs)} requests, prompts {plens[0]}.."
        f"{plens[-1]} tokens ({sum(p > ENGINE['prompt_buckets'][-1] for p in plens)}"
        f" beyond the largest bucket), {sum(r.max_new_tokens for r in reqs)}"
        f" new tokens; {ENGINE}")
    launches, tok_k, st_k, census, _ = run_engine(
        torch, model, packed, reqs, f"{tag}engine kernels")
    check_path(launches, path, f"the {tag}engine path")
    # the same run again, untimed by the numbers above, with every wait of
    # the host on the card counted (sync-debug mode)
    st_w = None
    if count_waits:
        _, tok_w, st_w, _, _ = run_engine(
            torch, model, packed, reqs, f"{tag}engine kernels, waits counted",
            watch_waits=True)
        check(tok_w == tok_k, "the engine's tokens differ between two runs")
    k6 = (k6_census_run(torch, model, packed, reqs, f"{tag}engine", tok_k,
                        launches) if k6_census else [])
    with kernels.use_impl("reference"):
        plain_launches, tok_p, st_p, _, _ = run_engine(
            torch, model, packed, reqs, f"{tag}engine plain")
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
    return launches, tok_k, dict(kernels=st_k, waits_counted=st_w,
                                 plain=st_p, identical=len(same),
                                 requests=len(tok_k), parts=parts,
                                 first_equal=first_equal), census, k6


def check_spill_restore(torch, model, packed, reqs):
    """The preemption round trip at full width on the paged engine: admit
    the 1536-token prompt (96 pages of the INT8 pools) and one decode
    step, then preempt it (its pages spill to host memory in one transfer)
    and resume it (one upload into other pages): every code, scale and
    zero of its pages must come back with the same bytes."""
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.kv_cache import take_pages
    eng = Engine(model, packed, EngineConfig(**dict(
        PAGED_ENGINE, prefix_caching=False)))
    req = next(r for r in reqs if r.prompt_len == LONG[0][0])
    eng.submit(req)
    eng.step()
    (slot,) = eng.scheduler.active_slots()
    pages = list(eng._slot_pages[slot])
    before = [t.clone() for name in ("k", "v")
              for t in take_pages(eng.kv[name], pages)]
    # the free list hands out the pages past the request's first, so the
    # resume lands on other pages
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._preempt(slot)
    t1 = time.perf_counter()
    check(eng._try_resume(), "spill/restore: the ticket did not resume")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    (slot,) = eng.scheduler.active_slots()
    moved = list(eng._slot_pages[slot])
    after = [t for name in ("k", "v") for t in take_pages(eng.kv[name],
                                                          moved)]
    same = all(torch.equal(a, b) for a, b in zip(before, after))
    nbytes = sum(t.numel() * t.element_size() for t in before)
    log(f"[spill] {len(pages)} pages ({nbytes / 1e6:.2f} MB of codes and "
        f"planes, {model.cfg.num_layers} layers, K and V) spilled in "
        f"{1e3 * (t1 - t0):.2f} ms "
        f"and restored into {sum(p != q for p, q in zip(pages, moved))} "
        f"other pages in {1e3 * (t2 - t1):.2f} ms: "
        f"{'the same bytes' if same else 'BYTES DIFFER'}")
    check(same and moved != pages, "spill/restore round trip not byte-exact")
    out = {r.rid: r for r in eng.run()}
    check(out[req.rid].status == "ok", "spill/restore: the request failed")
    return dict(pages=len(pages), bytes=nbytes, spill_ms=1e3 * (t1 - t0),
                restore_ms=1e3 * (t2 - t1), byte_exact=same)


def phase_paged_engine(torch, cfg, model, packed, tag, exact_first,
                       slot_tokens=None, k6_census=False, count_waits=True):
    """The paged engine (``PAGED_ENGINE``) over ``paged_trace``: through
    the kernels (K4, K5 and K6p must launch, K6p once a layer a decode
    step, nothing else), with ``count_waits`` once more in sync-debug mode
    (one host wait a decode step, prefill, chunked prompt and preemption;
    the parity process leaves it to the main one), then through the plain
    versions (nothing may launch), ``check_invariants`` after every
    step. It must preempt and resume, hit the prefix cache, end with no
    page in use and count the same in every run. Its tokens are held
    to the kernels' slot-engine run (``slot_tokens``) on the requests the
    two traces share; with ``exact_first`` every request's first token
    must equal on the kernel and plain paths; with ``k6_census`` a fourth
    run records K6p's census (:func:`k6_census_run`). Then the
    spill/restore round trip at full width. Returns the kernel run's
    tokens last."""
    from repro_torch import kernels
    reqs = paged_trace(cfg)
    log(f"[{tag}paged] {len(reqs)} requests ({PREFIX['requests']} behind a "
        f"{PREFIX['prefix']}-token shared prefix), "
        f"{sum(r.max_new_tokens for r in reqs)} new tokens; {PAGED_ENGINE}")
    launches, tok_k, st_k, census, _ = run_engine(
        torch, model, packed, reqs, f"{tag}paged kernels", ecfg=PAGED_ENGINE)
    check_path(launches, PAGED_PATH, "the paged engine path")
    per_step = model.cfg.num_layers * st_k["decode_steps"]
    check(launches["decode_attn_paged"] == per_step,
          f"K6p launched {launches['decode_attn_paged']} times, expected "
          f"{per_step} (one a layer a decode step)")
    st_w = None
    if count_waits:
        _, tok_w, st_w, _, _ = run_engine(
            torch, model, packed, reqs, f"{tag}paged kernels, waits counted",
            watch_waits=True, ecfg=PAGED_ENGINE)
        check(tok_w == tok_k, "the paged engine's tokens differ between runs")
    k6 = (k6_census_run(torch, model, packed, reqs, f"{tag}paged", tok_k,
                        launches, ecfg=PAGED_ENGINE) if k6_census else [])
    with kernels.use_impl("reference"):
        plain_launches, tok_p, st_p, _, _ = run_engine(
            torch, model, packed, reqs, f"{tag}paged plain",
            ecfg=PAGED_ENGINE)
    check(not any(plain_launches.values()),
          "the plain paged engine run launched a kernel")
    ps = st_k["page_stats"]
    check(ps["preemptions"] >= 1 and ps["resumes"] == ps["preemptions"],
          f"paged engine: {ps['preemptions']} preemptions, "
          f"{ps['resumes']} resumes")
    check(ps["prefix_hits"] >= 1, "paged engine: no prefix-cache hit")
    check(ps["pages_in_use"] == ps["prefix_cached_pages"],
          f"paged engine: {ps['pages_in_use']} pages in use at the end, "
          f"{ps['prefix_cached_pages']} held by the prefix cache")
    check((st_w is None or st_w["page_stats"] == ps)
          and st_p["page_stats"] == ps,
          "page_stats differ between the paged engine's runs")
    same = [rid for rid in tok_k if tok_k[rid] == tok_p[rid]]
    parts = {rid: next(i for i, (a, b) in enumerate(zip(tok_k[rid],
                                                         tok_p[rid]))
                       if a != b)
             for rid in tok_k if rid not in same}
    first_equal = sum(tok_k[rid][0] == tok_p[rid][0] for rid in tok_k)
    log(f"[{tag}paged] kernels against plain: {len(same)}/{len(tok_k)} "
        f"requests with identical tokens; first parting position of the "
        f"others {parts}; first tokens equal in {first_equal}/{len(tok_k)}")
    check(not exact_first or first_equal == len(tok_k),
          "first tokens differ between the kernel and plain paged paths")
    vs_slot = {}
    if slot_tokens is not None:
        shared = sorted(set(slot_tokens) & set(tok_k))
        eq = [rid for rid in shared if slot_tokens[rid] == tok_k[rid]]
        slot_parts = {rid: next(i for i, (a, b) in enumerate(
            zip(tok_k[rid], slot_tokens[rid])) if a != b)
            for rid in shared if rid not in eq}
        log(f"[{tag}paged] against the slot engine's kernel run: {len(eq)}"
            f"/{len(shared)} shared requests with identical tokens; first "
            f"parting position of the others {slot_parts}")
        vs_slot = dict(identical=len(eq), shared=len(shared),
                       parts=slot_parts)
    spill = check_spill_restore(torch, model, packed, reqs)
    return launches, dict(kernels=st_k, waits_counted=st_w, plain=st_p,
                          identical=len(same), requests=len(tok_k),
                          parts=parts, first_equal=first_equal,
                          vs_slot=vs_slot,
                          spill_restore=spill), census, k6, tok_k


# ---------------------------------------------------------------------------
# the training phase: llama32-1b at full width, then its compression
# ---------------------------------------------------------------------------

def train_flops(cfg, b: int, s: int, head_tokens=None) -> dict:
    """Model operations of one train step on (b, s) positions, counted
    apart: the forward (every linear at 2 operations a weight and
    position, the head over the padded vocabulary at ``head_tokens``
    positions (all of them by default; a vlm's text), and the chunked
    attention's full S × S scores and P·V, 4·B·H·S²·D a layer), the
    backward (twice the forward) and the remat recompute (the blocks'
    forward again, and each logit chunk's head product). The MoE's FFN is
    counted as the masked path computes it: every expert for every token
    (E/k times the routed work) and the router."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    ffn = (3 if cfg.mlp_act == "silu" else 2) * d * cfg.d_ff
    if cfg.family == "moe":
        ffn = ffn * cfg.num_experts + d * cfg.num_experts
    lin = cfg.num_layers * (2 * d * cfg.num_heads * hd
                            + 2 * d * cfg.num_kv_heads * hd + ffn)
    head = d * cfg.padded_vocab
    tokens = b * s
    heads = tokens if head_tokens is None else head_tokens
    attn = cfg.num_layers * 4.0 * b * cfg.num_heads * s * s * hd
    fwd = 2.0 * tokens * lin + 2.0 * heads * head + attn
    return dict(forward=fwd, backward=2.0 * fwd,
                recompute=2.0 * tokens * lin + attn + 2.0 * heads * head)


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.clone()


def hold_states(torch, want, got, tag, bound):
    """Two train states leaf by leaf: the same bits, or else the largest
    difference, the differing entries and the leaf, held to ``bound``."""
    worst, n_diff, n_all, where = 0.0, 0, 0, None
    for (key, a), (_, b) in zip(_paths(want), _paths(got)):
        n_all += a.numel()
        if torch.equal(a, b):
            continue
        d = (a.to(torch.float64) - b.to(torch.float64)).abs()
        n_diff += int((d > 0).sum())
        if float(d.max()) > worst:
            worst, where = float(d.max()), "/".join(key)
    log(f"[{tag}] {'the same bits' if n_diff == 0 else 'bits part'}: "
        f"{n_diff} of {n_all} entries differ, largest {worst:.3e}"
        + (f" (in {where})" if where else ""))
    check(worst <= bound, f"{tag}: largest difference {worst:.3e} over the "
                          f"bound {bound:.1e}")
    return dict(same_bits=n_diff == 0, entries_differ=n_diff,
                max_abs_diff=worst, leaf=where)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def iteration_census(report, tag):
    """Each layer's PGD iterations and its method's cap (AWP prune's stop
    rule caps at 200; the quantization recipe runs its 10 steps with no
    stop rule): the layers that stopped early and the distribution."""
    from collections import Counter
    from repro_torch.core import awp
    caps = {"awp_prune": awp.PRUNE_CONFIG.max_iters, "awp_quant": 10}
    by = {}
    for r in report:
        its = int(report.artifacts[r.qualname].result.iters)
        by.setdefault(r.method, []).append(its)
    out = {}
    for method, its in sorted(by.items()):
        cap = caps.get(method)
        early = sum(n < cap for n in its) if cap else 0
        dist = dict(sorted(Counter(its).items()))
        log(f"[{tag}] {method}: {len(its)} layers, cap {cap}, {early} "
            f"stopped before it; iterations {dist}")
        out[method] = dict(layers=len(its), cap=cap, early=early,
                           iterations=its)
    return out


def hold_microbatches(torch, model, tcfg, params, batch, bar, tag):
    """One batch's gradient as two interleaved microbatches against one:
    the accumulated gradient must equal the mean of the two halves' own
    gradients bit for bit (the split and the accumulation), the loss within
    1e-6 relative, and every leaf's |dg| / |g| within ``bar``."""
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.training.train_loop import (TrainConfig, compute_grads,
                                                 split_microbatches)
    l1, g1 = compute_grads(model, tcfg, params, batch)
    l2, g2 = compute_grads(model, TrainConfig(microbatches=2), params, batch)
    halves = [compute_grads(model, tcfg, params, mb)[1]
              for mb in split_microbatches(batch, 2)]
    mean = tree_map(lambda a, b: a / 2 + b / 2, *halves)
    del halves
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(_paths(mean),
                                                            _paths(g2)))
    del mean
    rel = {"/".join(k): float(torch.linalg.vector_norm(a - b)
                              / torch.linalg.vector_norm(a))
           for (k, a), (_, b) in zip(_paths(g1), _paths(g2))}
    del g1, g2
    worst = max(rel.values())
    dl = abs(float(l1) - float(l2)) / abs(float(l1))
    log(f"[{tag}] microbatches 2 against 1 on one batch: the accumulated "
        f"gradient {'equals' if same else 'DIFFERS FROM'} the mean of the "
        f"two halves' own, bit for bit; loss {float(l1):.6f} / "
        f"{float(l2):.6f} (relative {dl:.2e}); |dg| / |g| per leaf "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f" (bar {bar:.0e})")
    check(same, f"{tag}: the microbatched gradient is not the mean of its "
                f"halves'")
    check(worst <= bar and dl <= 1e-6, f"{tag}: microbatched gradients "
                                       f"differ beyond the bar: {worst:.2e}")
    return dict(halves_mean_bits=same, max_rel=worst, loss_rel=dl,
                per_leaf=rel)


def step_split(torch, model, tcfg, state, batch, reps=3):
    """A train step's device time split between the gradient (forward,
    backward and recompute) and the optimizer's update (norm, clip and
    AdamW), each timed by CUDA events, the median of ``reps`` (the update
    runs in place on ``state``)."""
    import statistics
    from repro_torch.optim import make_optimizer
    from repro_torch.training.train_loop import compute_grads
    _, update = make_optimizer(tcfg.optimizer)
    grads_ms, update_ms = [], []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        _, grads = compute_grads(model, tcfg, state["params"], batch)
        ev[1].record()
        update(grads, state["opt"], state["params"])
        ev[2].record()
        del grads
        torch.cuda.synchronize()
        grads_ms.append(ev[0].elapsed_time(ev[1]))
        update_ms.append(ev[1].elapsed_time(ev[2]))
    out = dict(grads_ms=statistics.median(grads_ms),
               update_ms=statistics.median(update_ms))
    log(f"[train] a step's split: gradients {out['grads_ms']:.2f} ms "
        f"(forward, backward, recompute), optimizer update "
        f"{out['update_ms']:.2f} ms (norm, clip, AdamW); medians of {reps}")
    return out


def phase_train(torch, dev, cfg):
    """Training on the card (:mod:`repro_torch.launch.train`'s loop and
    recipe), then the main path's compression of the trained model.

    llama32-1b at full depth and width from seed 0 (1.237e9 f32
    parameters, about 20 GB with gradients and AdamW's state), AdamW with
    the train CLI's defaults and ``benchmarks/common.py``'s recipe: batch
    16 × 64, lr 1e-3, 10 warmup steps, 100 steps, remat on. The loss is
    printed at step 0, every 20 steps and at the end, and must fall. Every
    step runs in PyTorch's sync-debug mode, its waits counted apart from
    the print's reads (and from the checkpoint's host copy): none is
    allowed outside a print step after the first. Step times come from
    CUDA events recorded after each step. At step ``RESUME_K`` the state
    is saved by ``CheckpointManager.save_async`` and at 2·``RESUME_K``
    cloned; after the run a fresh manager restores the save and
    ``RESUME_K`` more steps are held to the clone (bit-equal is the goal;
    otherwise the largest difference is printed and held to
    ``RESUME_BOUND``). Then: the gradient of one batch as two interleaved
    microbatches against one (:func:`hold_microbatches` at ``MICRO_BAR``);
    three
    Adafactor steps from the trained params; the trained model compressed
    by the main path (batched engine, mixed policy, 16,384 calibration
    tokens) on the kernels (counted) and through the plain versions, held
    at the repo's bars, with each layer's iterations; the Table-1 prune
    policy on blocks 0–1 on the kernels (every linear through the stop
    rule, ``prune_batched_compacted``'s retire-and-restack); perplexity on
    the compress CLI's held-out batches before training, after it and
    after compression. Returns the launches of the compression and the
    numbers."""
    import argparse
    import statistics
    from repro_torch import kernels
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, ZipfMarkov, calibration_batches
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.compress import perplexity
    from repro_torch.models import build_model
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    t_phase = time.time()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, remat=True)
    recipe = argparse.Namespace(optimizer="adamw", lr=TRAIN["lr"],
                                steps=TRAIN["steps"], microbatches=1)
    tcfg = train_cli.train_config(recipe)
    check(tcfg.optimizer.warmup_steps == TRAIN["steps"] // 10,
          "the recipe's warmup")
    step_fn, _ = make_train_step(model, tcfg)
    state = init_train_state(model, SEED, device=dev, tcfg=tcfg)
    gen = ZipfMarkov(DataConfig(vocab_size=cfg.vocab_size,
                                seq_len=TRAIN["seq"],
                                global_batch=TRAIN["batch"]))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=EVAL_SEQ,
                    global_batch=EVAL_BATCH)
    evals = [tuple(torch.as_tensor(a, device=dev)
                   for a in ZipfMarkov(dc).batch(9000 + i))
             for i in range(EVAL_BATCHES)]
    ppl_init = perplexity(model, state["params"], evals)
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    log(f"[train] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab}),"
        f" {n_params / 1e9:.3f}e9 f32 parameters from seed {SEED} (full "
        f"depth and width), AdamW, batch {TRAIN['batch']} x {TRAIN['seq']},"
        f" lr {TRAIN['lr']}, warmup {tcfg.optimizer.warmup_steps}, "
        f"{TRAIN['steps']} steps, remat on; perplexity at init "
        f"{ppl_init:.3f}")

    k = RESUME_K
    events, waits, marks, losses = [], [], {"exit": 0}, {}
    held = {}
    ops.reset_launches()
    ckpt = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    ckdir = ckpt.name
    with host_waits(torch, True) as hw:
        caught = hw["caught"]

        def n_waits():
            return sum(SYNC_WARNING in str(w.message) for w in caught)

        mgr = CheckpointManager(ckdir, keep_n=1)

        def on_step(i, st, m):
            waits.append(n_waits() - marks["exit"])
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            if i % TRAIN["log_every"] == 0 or i + 1 == TRAIN["steps"]:
                losses[i] = m["loss"]
            if i + 1 == k:
                t0 = time.time()
                mgr.save_async(k, st)
                held["save_host_s"] = time.time() - t0
            elif i + 1 == 2 * k:
                # the train step's own peak, before the clone below
                held["peak"] = torch.cuda.max_memory_allocated()
                held["snapshot"] = _tree_clone(st)
            marks["exit"] = n_waits()

        torch.cuda.synchronize()
        t0 = time.time()
        state, metrics = train_cli.run_steps(
            step_fn, state, gen, 0, TRAIN["steps"], dev,
            log_every=TRAIN["log_every"], on_step=on_step)
        torch.cuda.synchronize()
        wall = time.time() - t0
        t0 = time.time()
        mgr.wait()
        held["save_wait_s"] = time.time() - t0
    peak_train = held["peak"]
    train_launches = dict(ops.LAUNCHES)
    check(not any(train_launches.values()),
          f"training launched a kernel: {train_launches}")

    loss_vals = {i: float(v) for i, v in losses.items()}
    first, last = loss_vals[0], loss_vals[TRAIN["steps"] - 1]
    check(all(math.isfinite(v) for v in loss_vals.values())
          and last < first,
          f"the training loss did not fall: {loss_vals}")
    step_ms = [events[i - 1].elapsed_time(events[i])
               for i in range(1, len(events))]
    timed = step_ms[TRAIN_WARMUP - 1:]
    med = statistics.median(timed)
    fl = train_flops(cfg, TRAIN["batch"], TRAIN["seq"])
    share = sum(fl.values()) / (med * 1e-3) / PEAK_F32_FLOPS
    print_steps = {i for i in range(TRAIN["steps"])
                   if i % TRAIN["log_every"] == 0
                   or i + 1 == TRAIN["steps"]}
    quiet = [w for i, w in enumerate(waits) if i not in print_steps]
    loud = [w for i, w in enumerate(waits) if i in print_steps]
    log(f"[train] loss {json.dumps({str(i): round(v, 4) for i, v in loss_vals.items()})}")
    log(f"[train] {TRAIN['steps']} steps in {wall:.2f}s; step "
        f"{med:.2f} ms (median of steps {TRAIN_WARMUP}-"
        f"{TRAIN['steps'] - 1}, CUDA events; min {min(timed):.2f}, max "
        f"{max(timed):.2f}); {TRAIN['batch'] * TRAIN['seq'] / med * 1e3:.0f}"
        f" tokens/s; model operations a step: forward "
        f"{fl['forward'] / 1e12:.3f}e12, backward "
        f"{fl['backward'] / 1e12:.3f}e12, remat recompute "
        f"{fl['recompute'] / 1e12:.3f}e12 = {share:.1%} of "
        f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s f32; peak "
        f"{peak_train / 1e9:.2f} GB allocated (steps 0-{2 * k - 1})")
    log(f"[train] host waits a step (sync-debug): step 0 {waits[0]}, "
        f"other print steps {sorted(set(loud[1:]))}, the "
        f"{len(quiet)} other steps {sum(quiet)} in all (max "
        f"{max(quiet)}); checkpoint host copy {held['save_host_s']:.2f}s"
        f" inside the run, writer waited {held['save_wait_s']:.2f}s "
        f"after it")
    check(sum(quiet) == 0,
          f"train steps outside the print steps waited on the card: "
          f"{[(i, w) for i, w in enumerate(waits) if w and i not in print_steps]}")

    # the later checks need the trained params only
    params = state["params"]
    del state, metrics
    torch.cuda.empty_cache()

    # -- resume: restore the step-k save in a fresh manager, k steps
    snapshot = held.pop("snapshot")
    t0 = time.time()
    restored, at = CheckpointManager(ckdir).restore_latest(snapshot)
    t_restore = time.time() - t0
    ckpt.cleanup()
    check(at == k and int(restored["step"]) == k,
          f"restored step {at}, expected {k}")
    resumed, _ = train_cli.run_steps(step_fn, restored, gen, k, 2 * k, dev,
                                     log_every=10 * k)
    del restored
    resume = hold_states(torch, snapshot, resumed, "train resume",
                         RESUME_BOUND)
    resume.update(restore_s=t_restore, save_host_s=held["save_host_s"],
                  save_wait_s=held["save_wait_s"])
    del snapshot
    split = step_split(torch, model, tcfg, resumed,
                       train_cli.device_batch(gen, 0, dev))
    del resumed
    torch.cuda.empty_cache()

    # -- microbatches 2 against 1 on one batch
    micro = hold_microbatches(torch, model, tcfg, params,
                              train_cli.device_batch(gen, TRAIN["steps"],
                                                     dev),
                              MICRO_BAR, "train")
    torch.cuda.empty_cache()

    # -- three Adafactor steps from (a copy of) the trained params
    recipe.optimizer = "adafactor"
    af_step, af_init = make_train_step(model, train_cli.train_config(recipe))
    af_params = _tree_clone(params)
    af = {"params": af_params, "opt": af_init(af_params),
          "step": torch.zeros((), dtype=torch.int32, device=dev)}
    af_losses = []
    for i in range(3):
        af, am = af_step(af, train_cli.device_batch(gen, TRAIN["steps"] + i,
                                                    dev))
        af_losses.append((float(am["loss"]), float(am["grad_norm"])))
    opt_bytes = sum(t.numel() * 4 for t in _leaves(af["opt"]["v"]))
    check(all(math.isfinite(a) and math.isfinite(b) for a, b in af_losses)
          and int(af["step"]) == 3, f"Adafactor steps: {af_losses}")
    log(f"[train] Adafactor, 3 steps from the trained params: (loss, "
        f"grad_norm) {[(round(a, 4), round(b, 4)) for a, b in af_losses]}; "
        f"factored state {opt_bytes / 1e6:.1f} MB against AdamW's "
        f"{2 * 4 * n_params / 1e9:.2f} GB")
    del af, af_params
    torch.cuda.empty_cache()

    # -- the trained model's compression: the main path, kernels and plain
    ppl_trained = perplexity(model, params, evals)
    cdc = DataConfig(vocab_size=cfg.vocab_size, seq_len=CALIB_SEQ,
                     global_batch=CALIB_BATCH)
    calib = [{"tokens": torch.as_tensor(t, device=dev)}
             for t, _ in calibration_batches(cdc, CALIB_BATCHES)]
    data = (model, params, calib, None)
    ops.reset_launches()
    cp, rep_k, t_k = compress(torch, data, policy_for("mixed"), "batched")
    launches = dict(ops.LAUNCHES)
    check_path(launches, TRAIN_COMPRESS_PATH,
               "the trained model's compression")
    ppl_after = perplexity(model, cp, evals)
    del cp
    with kernels.use_impl("reference"):
        cp_p, rep_p, t_p = compress(torch, data, policy_for("mixed"),
                                    "batched")
        check(not any(ops.LAUNCHES[n] != launches[n] for n in launches),
              "the plain compression launched a kernel")
    ppl_plain = perplexity(model, cp_p, evals)
    del cp_p
    bars = hold_reports(torch, rep_k, rep_p, "train compress",
                        7 * cfg.num_layers, iters_equal=False)
    iters = iteration_census(rep_k, "train compress iterations")
    log(f"[train compress] mixed policy, batched engine: kernels "
        f"{t_k:.2f}s, plain {t_p:.2f}s; perplexity {ppl_init:.3f} at init,"
        f" {ppl_trained:.3f} trained, {ppl_after:.3f} compressed "
        f"({ppl_plain:.3f} plain); launches {launches}")
    check(ppl_trained < ppl_init and math.isfinite(ppl_after),
          f"perplexity {ppl_init} -> {ppl_trained} -> {ppl_after}")

    # -- the Table-1 prune policy on blocks 0-1: every linear's stop rule
    ops.reset_launches()
    cp, rep_t, t_t = compress(torch, data, policy_for("table1"), "batched")
    t1_launches = dict(ops.LAUNCHES)
    check_path(t1_launches, PRUNE_PATH, "the trained model's Table-1 prune")
    for r in rep_t:
        if r.method == "awp_prune":
            check(r.sparsity == 0.5, f"{r.qualname}: sparsity {r.sparsity}")
    t1_iters = iteration_census(rep_t, "train table1 iterations")
    del cp, data, params, calib
    torch.cuda.empty_cache()
    secs = time.time() - t_phase
    log(f"[train] Table-1 prune of blocks 0-1 {t_t:.2f}s; phase "
        f"{secs:.1f}s")
    summary = dict(
        seconds=secs, wall_s=wall, step_ms=med, step_ms_all=step_ms,
        tokens_per_s=TRAIN["batch"] * TRAIN["seq"] / med * 1e3,
        flops=fl, flop_share=share, peak_bytes=peak_train,
        losses=loss_vals, waits=waits, resume=resume, split=split,
        micro=micro,
        adafactor=af_losses,
        perplexity=dict(init=ppl_init, trained=ppl_trained,
                        compressed=ppl_after, compressed_plain=ppl_plain),
        compress_s=t_k, compress_plain_s=t_p, kernels_vs_plain=bars,
        iterations=iters, table1_s=t_t, table1_iterations=t1_iters)
    for n, c in t1_launches.items():
        launches[n] += c
    return launches, summary


# ---------------------------------------------------------------------------
# the training phase of the other families: MoE, SSM, hybrid, audio, vlm
# ---------------------------------------------------------------------------

def family_config(arch):
    """``arch`` as the other phases run it: qwen3-moe at ``MOE_LAYERS``
    layers, the SSM and hybrid archs and musicgen-medium at
    ``FAMILY_LAYERS``' depth, internvl2-1b at full depth; every width as
    published."""
    return moe_config() if arch == MOE_ARCH else cut_config(arch,
                                                            FAMILY_LAYERS)


def family_batches(torch, dev, cfg):
    """Step i's batch of the train CLI's data (``ZipfMarkov``, batch 16 x
    64): its tokens and labels; an audio config's frames and a vlm
    config's patches from the port's ``make_batch`` (a generator on the
    card seeded from ``SEED`` + i; bf16 standard normals) in their place
    or ahead of them. Nothing is read on the host."""
    from repro_torch.data import DataConfig, ZipfMarkov
    from repro_torch.launch import train as train_cli
    from repro_torch.models import make_batch
    from repro_torch.models.transformer import FRONTEND_KEYS
    gen = ZipfMarkov(DataConfig(vocab_size=cfg.vocab_size,
                                seq_len=TRAIN["seq"],
                                global_batch=TRAIN["batch"]))

    def batch(i):
        b = train_cli.device_batch(gen, i, dev)
        if cfg.frontend is None:
            return b
        key = FRONTEND_KEYS[cfg.frontend]
        tgen = torch.Generator(device=dev).manual_seed(SEED + i)
        emb = make_batch(cfg, tgen, TRAIN["batch"],
                         TRAIN["seq"] + cfg.num_patches, device=dev)[key]
        if key == "frames":
            return {"frames": emb, "labels": b["labels"]}
        return dict(b, patches=emb)

    return batch


def hold_microbatches_streamed(torch, model, params, batch, bar, tag):
    """:func:`hold_microbatches`' gradient check for a model whose params
    and two gradient trees do not fit the card together (the MoE: 24.9 GB
    each): the gradient as two interleaved microbatches comes first
    (``compute_grads``), then the single batch's backward holds each leaf
    to it as soon as that leaf's gradient is ready (a post-accumulate-grad
    hook) and drops it. The loss within 1e-6 relative, every leaf's
    |dg| / |g| within ``bar``."""
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.training.train_loop import TrainConfig, compute_grads
    l2, g2 = compute_grads(model, TrainConfig(microbatches=2), params, batch)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    rel, flat, hooks = {}, [], []
    for (key, leaf), (_, want) in zip(_paths(leaves), _paths(g2)):
        def hold(p, name="/".join(key), want=want):
            rel[name] = float(torch.linalg.vector_norm(p.grad - want)
                              / torch.linalg.vector_norm(p.grad))
            p.grad = None
        flat.append(leaf)
        hooks.append(leaf.register_post_accumulate_grad_hook(hold))
    with torch.enable_grad():
        l1, _ = model.loss(leaves, batch)
        torch.autograd.backward(l1, inputs=flat)
    for h in hooks:
        h.remove()
    peak = torch.cuda.max_memory_allocated()
    del g2, leaves, flat
    check(len(rel) == len(hooks), f"{tag}: {len(hooks) - len(rel)} leaves "
                                  f"got no gradient")
    worst = max(rel.values())
    l1 = l1.detach()
    dl = abs(float(l1) - float(l2)) / abs(float(l1))
    log(f"[{tag}] microbatches 2 against 1 on one batch (each leaf of the "
        f"single batch's gradient held to the microbatched one as backward "
        f"gives it): loss {float(l1):.6f} / {float(l2):.6f} (relative "
        f"{dl:.2e}); |dg| / |g| per leaf "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(rel.items()))
        + f" (bar {bar:.0e}); peak {peak / 1e9:.2f} GB allocated")
    check(worst <= bar and dl <= 1e-6, f"{tag}: microbatched gradients "
                                       f"differ beyond the bar: {worst:.2e}")
    return dict(max_rel=worst, loss_rel=dl, per_leaf=rel, peak_bytes=peak)


def train_family(torch, dev, arch, optimizer):
    """One arch of :func:`phase_train_families`: ``FAMILY_STEPS`` steps of
    ``make_train_step`` in sync-debug mode (the loss read at the first and
    the last step only), then the microbatch check and the resume where
    the arch takes them. Returns the arch's numbers."""
    import argparse
    import statistics
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    cfg = family_config(arch)
    t_arch = time.time()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, remat=True)
    tcfg = train_cli.train_config(argparse.Namespace(
        optimizer=optimizer, lr=TRAIN["lr"], steps=FAMILY_STEPS,
        microbatches=1))
    step_fn, _ = make_train_step(model, tcfg)
    state = init_train_state(model, SEED, device=dev, tcfg=tcfg)
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    batch = family_batches(torch, dev, cfg)
    steps, k = FAMILY_STEPS, FAMILY_RESUME_K
    last = steps - 1
    events, waits, losses = [], [], {}
    ops.reset_launches()
    ckpt = tempfile.TemporaryDirectory(prefix="chip_smoke_families_")
    mgr = CheckpointManager(ckpt.name, keep_n=1)
    resume = arch == FAMILY_RESUME
    with host_waits(torch, True) as hw:
        caught = hw["caught"]

        def n_waits():
            return sum(SYNC_WARNING in str(w.message) for w in caught)

        torch.cuda.synchronize()
        mark = n_waits()
        t0 = time.time()
        for i in range(steps):
            state, m = step_fn(state, batch(i))
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            if i in (0, last):
                losses[i] = float(m["loss"])
            waits.append(n_waits() - mark)
            if resume and i + 1 == k:
                # the save's host copy waits on the card; not a step's wait
                mgr.save_async(k, state)
            mark = n_waits()
        torch.cuda.synchronize()
        wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(ops.LAUNCHES)
    check(not any(launches.values()),
          f"{arch}: training launched a kernel: {launches}")
    first, end = losses[0], losses[last]
    check(math.isfinite(first) and math.isfinite(end) and end < first,
          f"{arch}: the training loss did not fall: {losses}")
    quiet = [w for i, w in enumerate(waits) if i not in (0, last)]
    check(sum(quiet) == 0,
          f"{arch}: train steps outside the print steps waited on the "
          f"card: {waits}")
    step_ms = [events[i - 1].elapsed_time(events[i])
               for i in range(1, len(events))]
    timed = step_ms[FAMILY_WARMUP - 1:]
    med = statistics.median(timed)
    positions = TRAIN["seq"] + cfg.num_patches
    tokens = TRAIN["batch"] * TRAIN["seq"]
    fl, share = None, None
    if cfg.family in ("moe", "audio", "vlm"):
        fl = train_flops(cfg, TRAIN["batch"], positions, head_tokens=tokens)
        share = sum(fl.values()) / (med * 1e-3) / PEAK_F32_FLOPS
    out = dict(
        layers=cfg.num_layers, optimizer=optimizer, params=n_params,
        steps=steps, loss_first=first, loss_last=end, step_ms=med,
        step_ms_all=step_ms, tokens_per_s=tokens / med * 1e3,
        positions_per_s=TRAIN["batch"] * positions / med * 1e3,
        flops=fl, flop_share=share, peak_bytes=peak, waits=waits,
        wall_s=wall)
    log(f"[train families] {arch}: {cfg.num_layers} layers at full width, "
        f"{n_params / 1e9:.3f}e9 f32 parameters from seed {SEED}, "
        f"{optimizer}, batch {TRAIN['batch']} x {TRAIN['seq']}"
        + (f" + {cfg.num_patches} patches" if cfg.num_patches else "")
        + f", lr {TRAIN['lr']}, warmup {tcfg.optimizer.warmup_steps}, "
        f"remat on; loss {first:.4f} at step 0 -> {end:.4f} at step {last};"
        f" step {med:.2f} ms (median of steps {FAMILY_WARMUP}-{last}, CUDA "
        f"events; min {min(timed):.2f}, max {max(timed):.2f}); "
        f"{out['tokens_per_s']:.0f} tokens/s"
        + (f" ({out['positions_per_s']:.0f} positions/s)"
           if cfg.num_patches else "")
        + (f"; model operations {sum(fl.values()) / 1e12:.2f}e12 a step = "
           f"{share:.1%} of {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s f32"
           if fl else "; model operations not counted (the scans are "
                      "elementwise)")
        + f"; peak {peak / 1e9:.2f} GB allocated; host waits a step "
        f"{waits} (print steps 0 and {last})")
    if arch in FAMILY_MICRO:
        # (zamba2's save is written meanwhile)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mb, tag = batch(steps), f"train families {arch}"
        hold = (hold_microbatches_streamed if cfg.family == "moe" else
                functools.partial(hold_microbatches, tcfg=tcfg))
        out["micro"] = hold(torch, model, params=state["params"], batch=mb,
                            bar=MICRO_BAR, tag=tag)
    if resume:
        t0 = time.time()
        mgr.wait()
        restored, at = CheckpointManager(ckpt.name).restore_latest(state)
        check(at == k and int(restored["step"]) == k,
              f"{arch}: restored step {at}, expected {k}")
        for i in range(k, steps):
            restored, _ = step_fn(restored, batch(i))
        out["resume"] = hold_states(torch, state, restored,
                                    f"train families {arch} resume",
                                    FAMILY_RESUME_BOUND)
        out["resume"]["seconds"] = time.time() - t0
        del restored
    ckpt.cleanup()
    state = None
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t_arch
    return out


def phase_train_families(torch, dev):
    """Training on the card for every family the reference trains beyond
    the dense one: the MoE (qwen3-moe-235b-a22b, ``MOE_LAYERS`` layers,
    Adafactor one layer at a time), the hybrid (zamba2-1.2b) and the SSM
    (falcon-mamba-7b) at ``SSM_LAYERS``' depth, the audio
    (musicgen-medium, frames in place of tokens, 24 layers) and vlm
    (internvl2-1b, 256 patches ahead of 64 tokens, full depth) frontends;
    every width
    as published, weights from ``SEED``. Each arch takes ``FAMILY_STEPS``
    steps of ``make_train_step`` with the train CLI's recipe in sync-debug
    mode (:func:`train_family`): the loss at the first and last step,
    finite and falling; no host wait outside those two steps; the median
    step time from CUDA events, tokens/s, the model-FLOP share where the
    work is counted, and peak memory. The MoE and zamba2 hold one batch's
    gradient as two interleaved microbatches to the single batch's at
    ``MICRO_BAR``; zamba2 resumes from a save at step ``FAMILY_RESUME_K``
    and is held to the uninterrupted run. No kernel of the repo launches.
    Returns each arch's numbers."""
    t_phase = time.time()
    out = {}
    for arch, optimizer in TRAIN_FAMILIES:
        out[arch] = train_family(torch, dev, arch, optimizer)
    secs = time.time() - t_phase
    log(f"[train families] {len(out)} archs in {secs:.1f}s: "
        + "; ".join(f"{a} {r['step_ms']:.1f} ms a step, "
                    f"{r['peak_bytes'] / 1e9:.1f} GB, {r['seconds']:.1f}s"
                    for a, r in out.items()))
    out["seconds"] = secs
    return out


class _FirstBlocks:
    """The model with its compression protocol cut to its first ``n``
    blocks: ``compress_model`` compresses and propagates through those
    alone, on the same inputs as the whole model's first blocks."""

    def __init__(self, model, n):
        self._model, self._n = model, n

    def __getattr__(self, name):
        return getattr(self._model, name)

    def num_blocks(self):
        return self._n


def cut_config(arch, layers):
    """``arch`` at its published widths, cut in depth to ``layers[arch]``
    where ``layers`` holds it (``SSM_LAYERS``, ``FRONTEND_LAYERS``), else
    at full depth."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, num_layers=layers.get(arch, cfg.num_layers))


def ssm_counts(cfg):
    """(linears compressed, K4 launches a forward) of the mixed policy: a
    Mamba-1 block's in_proj and out_proj; a Mamba-2 block's wz, wx and
    out_proj and the shared block's linears once, all packed but its
    pruned wo, which runs densely at each of its invocations."""
    if cfg.family == "ssm":
        return 2 * cfg.num_layers, 2 * cfg.num_layers
    shared = 6 + (cfg.mlp_act == "silu")
    invocations = -(-cfg.num_layers // cfg.attn_every)
    return (3 * cfg.num_layers + shared,
            3 * cfg.num_layers + (shared - 1) * invocations)


def check_decode(torch, cfg, logits, tokens, tag):
    """Static-path outputs well-formed: (B, 1, padded vocab) logits, finite
    over the vocabulary and masked past it; (B, GEN) tokens in range."""
    v, vp = cfg.vocab_size, cfg.padded_vocab
    check(tuple(logits.shape) == (BATCH, 1, vp),
          f"{tag}: logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits[..., :v]).all()),
          f"{tag}: non-finite logits")
    check(bool((logits[..., v:] == torch.finfo(logits.dtype).min).all()),
          f"{tag}: padded vocab columns not masked")
    check(tokens.shape == (BATCH, GEN) and tokens.min() >= 0
          and tokens.max() < v, f"{tag}: greedy tokens malformed")


def ssm_run(torch, dev, cfg, model, calib, prompts, label, count=False):
    """An SSM or hybrid model's main path once, on the active
    implementation: weights from the seed, compress (batched engine, mixed
    policy; with ``count`` in sync-debug mode with the host's waits counted
    a block, timed all the same), pack in memory, prefill logits and the
    static greedy decode; launch counts and K4's and K2's census from 0
    just before. Returns the report, the packed params, logits, tokens,
    seconds, peak memory, launches and censuses."""
    from repro_torch.checkpoint import pack_params
    from repro_torch.core.compress import compress_model
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import greedy_decode
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(SEED, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    waits = None
    if count:
        waits, report, cp = count_waits(
            torch, (model, params, calib, None), policy_for("mixed"),
            f"{label} ", keep=True)
    else:
        cp, report = compress_model(model, params, calib,
                                    policy_for("mixed"))
    torch.cuda.synchronize()
    t_comp = time.time() - t0
    del params
    comp_launches, k2 = dict(ops.LAUNCHES), dict(ops.K2_CENSUS)
    packed = pack_params(cp, report)
    del cp
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    logits, _ = model.prefill(
        packed, {"tokens": torch.as_tensor(prompts, device=dev)},
        model.init_cache(BATCH, PROMPT_LEN + GEN, torch.float32, device=dev))
    tokens, secs = greedy_decode(model, packed, prompts, GEN)
    launches = dict(ops.LAUNCHES)
    log(f"[{label}] compress {t_comp:.2f}s"
        + (" (sync-debug mode)" if count else "")
        + f", peak {peak / 1e9:.1f} GB allocated; prefill "
        f"{secs['prefill']:.3f}s ({BATCH * PROMPT_LEN / secs['prefill']:.0f}"
        f" tok/s), {GEN - 1} decode steps {secs['decode']:.3f}s "
        f"({BATCH * (GEN - 1) / secs['decode']:.1f} tok/s); launches in "
        f"compression {comp_launches}, in all {launches}")
    return dict(report=report, packed=packed, logits=logits, tokens=tokens,
                compress_s=t_comp, decode=secs, peak_bytes=peak,
                n_params=n_params, launches=launches,
                compress_launches=comp_launches, waits=waits, k2=k2,
                k4=dict(ops.K4_CENSUS))


def hold_sequential_blocks(torch, dev, cfg, model, calib, report, tag,
                           path=("awp_pgd_step", "quant_project")):
    """The sequential driver on the kernels over blocks 0-1 (the mixed
    policy; only ``path``'s kernels launched), held to the batched
    engine's first two blocks in ``report`` at the bars with equal
    iterations."""
    from repro_torch.core.compress import CompressionReport, compress_model
    from repro_torch.kernels import ops
    params = model.init(SEED, device=dev)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    cp, rep_s = compress_model(_FirstBlocks(model, 2), params, calib,
                               policy_for("mixed"), engine="sequential")
    torch.cuda.synchronize()
    secs = time.time() - t0
    del cp, params
    check_path(dict(ops.LAUNCHES), path, f"{tag}'s sequential compression")
    n = len(rep_s)
    first = CompressionReport(
        layers=report.layers[:n],
        artifacts={r.qualname: report.artifacts[r.qualname]
                   for r in report.layers[:n]})
    held = hold_reports(torch, first, rep_s, f"{tag} engines", n,
                        iters_equal=True)
    held["sequential_s"] = secs
    return held


def check_ssm_shapes(torch, dev):
    """K1 (every tile variant), K1b and K3 (bits 4) at the SSM linears,
    each held to its plain version and timed beside it, its bound and
    ``addmm``/``baddbmm``. Returns the JSON entries by kernel."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    out = {"awp_pgd_step": [check_k1(torch, randn, m, k)
                            for m, k in SSM_K1],
           "awp_pgd_step_batched": [k1b_entry(torch, randn, *shape)
                                    for shape in SSM_K1B],
           "quant_project": [check_k3(torch, randn, r, d, 4)
                             for r, d in SSM_K1 + (SSM_K1B[0][1:],)]}
    torch.cuda.empty_cache()
    return out


def phase_ssm(torch, dev):
    """The SSM and hybrid families at full width, zamba2-1.2b and
    falcon-mamba-7b each over ``SSM_LAYERS`` of its layers. For each:
    the main path on the kernels (compression counted in sync-debug mode
    and timed, every kernel of its path launched, K4 at every packed
    linear of every forward), the kernels' packed model decoded again
    through the plain versions (the same first tokens), the main path
    through the plain versions held to the kernels' at the bars with
    equal iterations, and the sequential driver on blocks 0-1 held to the
    batched engine. Then K1, K1b and K3 at the SSM linears. Returns the
    kernels' new JSON entries, the launches, K4's and K2's census, the
    numbers, and each arch's packed model (on the host) for the profile
    at the end of the run (:func:`phase_ssm_profile`)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import greedy_decode
    t_phase = time.time()
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    k4, k2, summary, keep = {}, {}, {}, {}
    for arch in SSM_ARCHS:
        cfg = cut_config(arch, SSM_LAYERS)
        tag = f"ssm {arch}"
        n_layers, k4_forward = ssm_counts(cfg)
        model, calib, prompts = model_setup(torch, dev, cfg)
        run_k = ssm_run(torch, dev, cfg, model, calib, prompts,
                        f"{tag} kernels", count=True)
        published = get_config(arch).num_layers
        log(f"[model] {cfg.name}: {cfg.num_layers} layers"
            + (" (full depth, no cut)" if cfg.num_layers == published else
               f" of {published} (the one cut)")
            + f", d_model {cfg.d_model}, d_inner {cfg.d_inner}, SSM state "
            f"{cfg.ssm_state}"
            + (f", {cfg.num_heads} heads of {cfg.resolved_head_dim} in the "
               f"shared block (before every {cfg.attn_every} blocks), d_ff "
               f"{cfg.d_ff}" if cfg.family == "hybrid" else "")
            + f", vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), "
            f"{run_k['n_params'] / 1e9:.3f}e9 f32 parameters from seed "
            f"{SEED}")
        check_path(run_k["launches"], SSM_PATH[arch],
                   f"{tag}'s compress and decode path")
        check(run_k["compress_launches"]["dequant_matmul"] == 0,
              f"{tag}: K4 launched during compression")
        forwards = 1 + GEN        # the logits prefill, greedy's prefill, steps
        check(run_k["launches"]["dequant_matmul"] == k4_forward * forwards,
              f"{tag}: K4 launched {run_k['launches']['dequant_matmul']} "
              f"times, expected {k4_forward} a forward")
        check_decode(torch, cfg, run_k["logits"], run_k["tokens"],
                     f"{tag} kernels")
        for name, n in run_k["launches"].items():
            launches[name] += n
        for key, n in run_k["k4"].items():
            k4[key] = k4.get(key, 0) + n
        for key, n in run_k["k2"].items():
            k2[key] = k2.get(key, 0) + n
        with kernels.use_impl("reference"):
            tok_kp, _ = greedy_decode(model, run_k["packed"], prompts, GEN)
        first_equal = bool((tok_kp[:, 0] == run_k["tokens"][:, 0]).all())
        log(f"[{tag}] the kernels' packed model decoded through the plain "
            f"versions: first tokens "
            + ("equal" if first_equal else "DIFFER") + ", all tokens "
            + ("identical" if (tok_kp == run_k["tokens"]).all() else
               "differ") + f"; row 0: {run_k['tokens'][0][:12].tolist()}")
        check(first_equal, f"{tag}: first tokens differ between K4 and the "
                           f"plain version on one packed model")
        keep[arch] = dict(cfg=cfg, model=model, prompts=prompts,
                          tokens=run_k["tokens"],
                          packed=to_host_tree(run_k["packed"]))
        del run_k["packed"]
        torch.cuda.empty_cache()
        ops.reset_launches()
        with kernels.use_impl("reference"):
            run_p = ssm_run(torch, dev, cfg, model, calib, prompts,
                            f"{tag} plain")
        check(not any(ops.LAUNCHES.values()),
              f"{tag}: the plain run launched a kernel")
        check_decode(torch, cfg, run_p["logits"], run_p["tokens"],
                     f"{tag} plain")
        held = hold_reports(torch, run_k["report"], run_p["report"],
                            f"{tag} layer", n_layers, iters_equal=True)
        held["tokens_identical"] = bool(
            (run_k["tokens"] == run_p["tokens"]).all())
        held["logits_dmax"] = float((run_k["logits"]
                                     - run_p["logits"]).abs().max())
        log(f"[{tag}] kernels against plain: prefill logits max |dlogit| "
            f"{held['logits_dmax']:.3e}; greedy tokens "
            + ("identical" if held["tokens_identical"] else "differ"))
        del run_p["packed"], run_p["report"]
        torch.cuda.empty_cache()
        engines = hold_sequential_blocks(torch, dev, cfg, model, calib,
                                         run_k["report"], tag)
        del run_k["report"]
        torch.cuda.empty_cache()
        dec = run_k["decode"]
        summary[arch] = dict(
            layers=cfg.num_layers, n_params=run_k["n_params"],
            compress_s=run_k["compress_s"],
            compress_plain_s=run_p["compress_s"],
            waits_per_block=run_k["waits"],
            peak_gb=run_k["peak_bytes"] / 1e9,
            prefill_s=dec["prefill"], decode_s=dec["decode"],
            prefill_tok_s=BATCH * PROMPT_LEN / dec["prefill"],
            decode_tok_s=BATCH * (GEN - 1) / dec["decode"],
            plain_prefill_s=run_p["decode"]["prefill"],
            plain_decode_s=run_p["decode"]["decode"],
            first_tokens_equal=first_equal, kernels_vs_plain=held,
            engines=engines)
        log(f"[{tag}] summary: {json.dumps(summary[arch])}")
        del run_k, run_p, calib
        torch.cuda.empty_cache()
    shapes = check_ssm_shapes(torch, dev)
    summary["seconds"] = time.time() - t_phase
    log(f"[ssm] phase {summary['seconds']:.1f}s; launches {launches}")
    return shapes, launches, k4, k2, summary, keep


def _annotated(torch, fn):
    """``fn`` inside a ``record_function`` span named ``SSM_SCAN``."""
    def wrapped(*args, **kw):
        with torch.profiler.record_function(SSM_SCAN):
            return fn(*args, **kw)
    return wrapped


def split_device_time(prof, windows):
    """Device ms and kernel counts inside ``windows`` split three ways:
    kernels launched inside a ``SSM_SCAN`` span (the scans), K4's kernels,
    the rest."""
    scans = _union([(e["ts"], e["ts"] + e["dur"]) for e in prof["host"]
                    if e["name"] == SSM_SCAN])
    in_scan = _inside([dict(start=a, end=b) for a, b in scans])
    scan_ids = {e["args"]["correlation"] for e in prof["host"]
                if e["cat"] in ("cuda_runtime", "cuda_driver")
                and "Launch" in e["name"]
                and "correlation" in e.get("args", {}) and in_scan(e["ts"])}
    inside = _inside(windows)
    out = {f"{c}_{u}": 0.0 for c in ("scan", "k4", "other")
           for u in ("ms", "kernels")}
    for e in prof["device"]:
        if e["cat"] != "kernel" or not inside(e["ts"]):
            continue
        if e.get("args", {}).get("correlation") in scan_ids:
            c = "scan"
        elif "dequant_gemv_kernel" in e["name"] or \
                "dequant_gemm_kernel" in e["name"]:
            c = "k4"
        else:
            c = "other"
        out[f"{c}_ms"] += e["dur"] / 1e3
        out[f"{c}_kernels"] += 1
    return out


def phase_ssm_profile(torch, dev, keep):
    """After every timed run: for each arch one ``torch.profiler`` window
    (the port's ``StepTraceWindow``) over a prefill of the phase's prompts
    and ``SSM_PROFILE_STEPS`` decode steps of its packed model, each step
    ended by a synchronize, with the scans (``_mamba_scan_y``,
    ``_ssd_chunked``) in ``record_function`` spans. The tokens must be the
    timed run's and the trace's K4 kernel events K4's launches. Prints the
    device time of the scans, K4 and the rest, and the decode steps'
    device idle share. Returns the numbers by arch."""
    from repro_torch.kernels import ops
    from repro_torch.models import mamba, mamba2
    from repro_torch.obs import StepTraceWindow
    scan_fns = {(mamba, "_mamba_scan_y"): mamba._mamba_scan_y,
                (mamba2, "_ssd_chunked"): mamba2._ssd_chunked}
    out = {}
    try:
        for (mod, name), fn in scan_fns.items():
            setattr(mod, name, _annotated(torch, fn))
        for arch, k in keep.items():
            model, packed = k["model"], to_card_tree(k["packed"], dev)
            toks = torch.as_tensor(k["prompts"], device=dev)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                win = StepTraceWindow(tmp, 1 + SSM_PROFILE_STEPS)
                ops.reset_launches()
                torch.cuda.synchronize()
                win.start()
                cache = model.init_cache(BATCH, PROMPT_LEN + GEN,
                                         torch.float32, device=dev)
                logits, cache = model.prefill(packed, {"tokens": toks},
                                              cache)
                got = [torch.argmax(logits[:, -1], -1)[:, None]]
                torch.cuda.synchronize()
                win.on_step()
                for _ in range(SSM_PROFILE_STEPS):
                    logits, cache = model.decode_step(packed, got[-1], cache)
                    got.append(torch.argmax(logits[:, -1], -1)[:, None])
                    torch.cuda.synchronize()
                    win.on_step()
                check(bool(win.path), f"ssm profile {arch}: no trace written")
                with open(win.path) as f:
                    prof = read_profile(json.load(f)["traceEvents"])
            tokens = torch.cat(got, 1).cpu().numpy()
            check((tokens == k["tokens"][:, :1 + SSM_PROFILE_STEPS]).all(),
                  f"ssm profile {arch}: tokens differ from the timed run's")
            n_k4 = sum(c for name, c in prof["kernels"].items()
                       if "dequant_gemv_kernel" in name
                       or "dequant_gemm_kernel" in name)
            check(n_k4 == ops.LAUNCHES["dequant_matmul"],
                  f"ssm profile {arch}: {n_k4} K4 kernel events, "
                  f"{ops.LAUNCHES['dequant_matmul']} launches")
            wins = prof["windows"]
            check(len(wins) == 1 + SSM_PROFILE_STEPS,
                  f"ssm profile {arch}: {len(wins)} step windows")
            res = {}
            for label, ws in (("prefill", wins[:1]), ("decode", wins[1:])):
                split = split_device_time(prof, ws)
                busy = sum(w["busy_ms"] for w in ws) / len(ws)
                kern = sum(v for k, v in split.items() if k.endswith("_ms"))
                res[label] = dict(
                    steps=len(ws), step_ms=sum(w["ms"] for w in ws) / len(ws),
                    busy_ms=busy,
                    idle_mean=sum(w["idle"] for w in ws) / len(ws),
                    kernels=sum(w["kernels"] for w in ws) / len(ws),
                    **{key: v / len(ws) for key, v in split.items()},
                    scan_share=split["scan_ms"] / kern if kern else 0.0)
                r = res[label]
                log(f"[ssm profile] {arch}, {label}: {r['steps']} windows, "
                    f"{r['step_ms']:.3f} ms a step profiled, device busy "
                    f"{r['busy_ms']:.3f} ms, idle share {r['idle_mean']:.4f}"
                    f", {r['kernels']:.0f} kernels a step; kernel time "
                    f"(kernels) a step: scans {r['scan_ms']:.3f} ms "
                    f"({r['scan_share']:.1%}; {r['scan_kernels']:.0f}), K4 "
                    f"{r['k4_ms']:.3f} ms ({r['k4_kernels']:.0f}), the rest "
                    f"{r['other_ms']:.3f} ms ({r['other_kernels']:.0f})")
            res["device_ops"] = device_ops(prof, wins[1:], 8)
            log(f"[ssm profile] {arch}, decode: top device ops (ms and "
                f"count a window): " + "; ".join(
                    f"{name[:80]} {ms / SSM_PROFILE_STEPS:.4f} "
                    f"({c / SSM_PROFILE_STEPS:.1f})"
                    for name, ms, c in res["device_ops"]))
            out[arch] = res
            del packed, cache
            torch.cuda.empty_cache()
    finally:
        for (mod, name), fn in scan_fns.items():
            setattr(mod, name, fn)
    return out


def parity_ssm(torch, dev):
    """Under unsplit cuBLAS, each SSM arch's main path through the kernels
    and through the plain versions: the kernels' packed model decoded
    through the plain versions gives every greedy token of the kernels'
    decode; the two compressions held at the bars with equal iterations,
    and, if they came out the same bits, the same greedy tokens."""
    from repro_torch import kernels
    from repro_torch.launch.serve import greedy_decode
    for arch in SSM_ARCHS:
        cfg = cut_config(arch, SSM_LAYERS)
        tag = f"parity ssm {arch}"
        model, calib, prompts = model_setup(torch, dev, cfg)
        run_k = ssm_run(torch, dev, cfg, model, calib, prompts,
                        f"{tag} kernels")
        with kernels.use_impl("reference"):
            tok_kp, _ = greedy_decode(model, run_k["packed"], prompts, GEN)
        same = bool((tok_kp == run_k["tokens"]).all())
        log(f"[{tag}] the kernels' packed model through the plain versions:"
            f" greedy tokens " + ("identical" if same else "DIFFER"))
        check(same, f"{tag}: greedy tokens differ between K4 and the plain "
                    f"version on one packed model under unsplit cuBLAS")
        del run_k["packed"]
        torch.cuda.empty_cache()
        with kernels.use_impl("reference"):
            run_p = ssm_run(torch, dev, cfg, model, calib, prompts,
                            f"{tag} plain")
        held = hold_reports(torch, run_k["report"], run_p["report"],
                            f"{tag} layer", ssm_counts(cfg)[0],
                            iters_equal=True)
        same = bool((run_k["tokens"] == run_p["tokens"]).all())
        log(f"[{tag}] kernels against plain: "
            + ("the same bits in every layer" if held["identical"] else
               f"{held['layers_differ']} layers differ, the first "
               f"{held['first_diff']}; held to the bars instead")
            + "; greedy tokens " + ("identical" if same else "differ"))
        check(not held["identical"] or same,
              f"{tag}: the same compression bits but other greedy tokens")
        del run_k, run_p, calib
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the frontends phase: musicgen-medium, internvl2-1b, starcoder2-7b
# ---------------------------------------------------------------------------

def frontend_setup(torch, dev, cfg):
    """The model of ``cfg`` and its inputs from the port's ``make_batch``
    (a generator seeded from ``SEED`` on the card): ``CALIB_BATCHES``
    calibration batches of ``CALIB_BATCH`` x ``CALIB_SEQ`` positions
    (16,384; internvl2-1b's count its 256 patches), and one batch of
    ``BATCH`` x ``PROMPT_LEN`` frames or tokens (internvl2-1b: the patches
    ahead of them) for the loss, the prefill and the static decode."""
    from repro_torch.models import build_model, make_batch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    calib = []
    for _ in range(CALIB_BATCHES):
        b = make_batch(cfg, gen, CALIB_BATCH, CALIB_SEQ, device=dev)
        del b["labels"]
        calib.append(b)
    batch = make_batch(cfg, gen, BATCH, PROMPT_LEN + cfg.num_patches,
                       device=dev)
    return build_model(cfg), dict(calib=calib, batch=batch)


def k4_per_forward(cfg, model):
    """K4's launches a forward after the mixed policy: every block linear
    is packed but the pruned wo."""
    return (len(model.block_linears(0)) - 1) * cfg.num_layers


def frontend_forwards(torch, dev, cfg, model, params, batch):
    """The served outputs of ``params`` on the active implementation: the
    loss and perplexity of ``batch`` (a vlm batch's on its text positions),
    the prefill logits of its frames or tokens (and patches), timed, and,
    where the arch decodes tokens, the static greedy decode of ``GEN``
    tokens. Returns them, with the number of forwards run."""
    from repro_torch.launch.serve import greedy_decode
    loss, m = model.loss(params, batch)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    s = inputs["frames" if "frames" in inputs else "tokens"].shape[1]
    torch.cuda.synchronize()
    t0 = time.time()
    logits, _ = model.prefill(params, inputs, model.init_cache(
        BATCH, cfg.num_patches + s + GEN, torch.float32, device=dev))
    torch.cuda.synchronize()
    out = dict(loss=float(loss), tokens_scored=int(m["tokens"]),
               ppl=math.exp(float(loss)), logits=logits,
               prefill_s=time.time() - t0, tokens=None, decode=None)
    forwards = 2
    if cfg.frontend != "audio_frames":       # the frame stub decodes nothing
        extra = {"patches": inputs["patches"]} if cfg.num_patches else None
        out["tokens"], out["decode"] = greedy_decode(
            model, params, inputs["tokens"], GEN, inputs=extra)
        forwards += GEN
    return out, forwards


def check_frontend_outputs(torch, cfg, out, tag):
    """Well-formed outputs: a finite loss over every label, (B, 1, padded
    vocab) prefill logits finite over the vocabulary and masked past it,
    and (B, GEN) greedy tokens in range where the arch decodes."""
    v, vp = cfg.vocab_size, cfg.padded_vocab
    logits = out["logits"]
    check(math.isfinite(out["loss"]) and out["tokens_scored"] == BATCH
          * PROMPT_LEN, f"{tag}: loss {out['loss']} over "
                        f"{out['tokens_scored']} labels")
    check(tuple(logits.shape) == (BATCH, 1, vp),
          f"{tag}: logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits[..., :v]).all()),
          f"{tag}: non-finite logits")
    check(bool((logits[..., v:] == torch.finfo(logits.dtype).min).all()),
          f"{tag}: padded vocab columns not masked")
    toks = out["tokens"]
    check(toks is None or (toks.shape == (BATCH, GEN) and toks.min() >= 0
                           and toks.max() < v),
          f"{tag}: greedy tokens malformed")


def frontend_run(torch, dev, cfg, model, data, label, count=False):
    """One arch's main path once, on the kernels: weights from the seed,
    compress (batched engine, mixed policy; with ``count`` in sync-debug
    mode with the host's waits counted a block, timed all the same), the
    dense result's loss, pack in memory, then the packed model's loss,
    prefill and static decode (:func:`frontend_forwards`); launch counts
    and K4's and K2's census from 0 just before. Returns the report, the
    packed params, the outputs, seconds, peak memory, launches and
    censuses."""
    from repro_torch.checkpoint import pack_params
    from repro_torch.core.compress import compress_model
    from repro_torch.kernels import ops
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(SEED, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    waits = None
    if count:
        waits, report, cp = count_waits(
            torch, (model, params, data["calib"], None),
            policy_for("mixed"), f"{label} ", keep=True)
    else:
        cp, report = compress_model(model, params, data["calib"],
                                    policy_for("mixed"))
    torch.cuda.synchronize()
    t_comp = time.time() - t0
    del params
    comp_launches, k2 = dict(ops.LAUNCHES), dict(ops.K2_CENSUS)
    dense_loss = float(model.loss(cp, data["batch"])[0])
    packed = pack_params(cp, report)
    del cp
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    out, forwards = frontend_forwards(torch, dev, cfg, model, packed,
                                      data["batch"])
    launches = dict(ops.LAUNCHES)
    dec = out["decode"]
    log(f"[{label}] compress {t_comp:.2f}s"
        + (" (sync-debug mode)" if count else "")
        + f", peak {peak / 1e9:.1f} GB allocated; loss {out['loss']:.6f} "
        f"(perplexity {out['ppl']:.3f}; the dense result's "
        f"{dense_loss:.6f}) over {out['tokens_scored']} labels; prefill "
        f"{out['prefill_s']:.3f}s"
        + (f", {GEN - 1} decode steps {dec['decode']:.3f}s "
           f"({BATCH * (GEN - 1) / dec['decode']:.1f} tok/s)" if dec else "")
        + f"; launches in compression {comp_launches}, in all {launches}")
    return dict(report=report, packed=packed, out=out, forwards=forwards,
                dense_loss=dense_loss, compress_s=t_comp, peak_bytes=peak,
                n_params=n_params, launches=launches,
                compress_launches=comp_launches, waits=waits, k2=k2,
                k4=dict(ops.K4_CENSUS))


def hold_plain_blocks(torch, dev, model, data, report, tag):
    """The mixed-policy compression of the first ``FRONTEND_PLAIN_BLOCKS``
    blocks (at most the model's) through the plain versions (weights from
    the seed, no kernel launched), timed, and held to the same blocks of
    the kernels' ``report`` at the bars with equal iterations. Returns the
    summary with the plain run's seconds and the block count."""
    from repro_torch import kernels
    from repro_torch.core.compress import CompressionReport, compress_model
    from repro_torch.kernels import ops
    n = min(FRONTEND_PLAIN_BLOCKS, model.num_blocks())
    params = model.init(SEED, device=dev)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    with kernels.use_impl("reference"):
        cp, rep_p = compress_model(_FirstBlocks(model, n), params,
                                   data["calib"], policy_for("mixed"))
    torch.cuda.synchronize()
    secs = time.time() - t0
    del cp, params
    check(not any(ops.LAUNCHES.values()),
          f"{tag}: the plain run launched a kernel")
    log(f"[{tag} plain] compress of blocks 0-{n - 1} {secs:.2f}s")
    layers = [r for r in report.layers if r.block < n]
    first = CompressionReport(
        layers=layers,
        artifacts={r.qualname: report.artifacts[r.qualname] for r in layers})
    held = hold_reports(torch, first, rep_p, f"{tag} layer",
                        n * len(model.block_linears(0)), iters_equal=True)
    held.update(plain_s=secs, blocks=n)
    return held


def check_frontend_shapes(torch, dev):
    """K1 (every tile variant), K1b and K3 (bits 4) at the new linears,
    each held to its plain version and timed beside it, its bound and
    ``addmm``/``baddbmm``; K6 and K6p at starcoder2-7b's heads. Returns
    the JSON entries by kernel."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    out = {"awp_pgd_step": [], "quant_project": []}
    for m, k in FRONTEND_K1:
        out["awp_pgd_step"].append(check_k1(torch, randn, m, k))
        out["quant_project"].append(check_k3(torch, randn, m, k, 4))
        torch.cuda.empty_cache()
    out["awp_pgd_step_batched"] = [k1b_entry(torch, randn, *shape)
                                   for shape in FRONTEND_K1B]
    out.update(check_k6_heads(torch, dev, STARCODER_HEADS, "starcoder2-7b",
                              44))
    torch.cuda.empty_cache()
    return out


def phase_frontends(torch, dev):
    """The audio and vlm frontends and the last dense configs at full
    width: musicgen-medium (frames in place of tokens) and internvl2-1b
    (256 patches ahead of the tokens) at full depth, starcoder2-7b over
    ``FRONTEND_LAYERS`` of its layers. For each: the main path on the
    kernels (compression counted in sync-debug mode and timed, every
    kernel of its path launched, K4 at every packed linear of every
    forward), the kernels' packed model served again through the plain
    versions (the same first tokens, the loss within ``PPL_BAR``), the
    compression of the first ``FRONTEND_PLAIN_BLOCKS`` blocks through the
    plain versions held to the kernels' at the bars with equal iterations
    (:func:`hold_plain_blocks`), and the sequential driver on blocks 0-1
    held to the batched engine. starcoder2-7b's packed model then serves
    the slot engine of the llama phase on its trace at its vocabulary,
    every request's first token equal on the kernels and plain (K6 at
    g = 9, D = 128). Then K1, K1b and K3 at the new linears and K6/K6p at
    starcoder2-7b's heads. Returns the kernels' new JSON entries, the
    launches, K4's and K2's census and the numbers."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    t_phase = time.time()
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    k4, k2, summary = {}, {}, {}

    def add(counts, into):
        for key, n in counts.items():
            into[key] = into.get(key, 0) + n

    for arch in FRONTEND_ARCHS:
        cfg = cut_config(arch, FRONTEND_LAYERS)
        tag = f"frontends {arch}"
        model, data = frontend_setup(torch, dev, cfg)
        k4_forward = k4_per_forward(cfg, model)
        run_k = frontend_run(torch, dev, cfg, model, data,
                             f"{tag} kernels", count=True)
        published = get_config(arch).num_layers
        log(f"[model] {cfg.name} ({cfg.family}"
            + (f", {cfg.frontend} stub" if cfg.frontend else "") + "): "
            + f"{cfg.num_layers} layers"
            + (" (full depth, no cut)" if cfg.num_layers == published else
               f" of {published} (the one cut)")
            + f", d_model {cfg.d_model}, {cfg.num_heads} heads over "
            f"{cfg.num_kv_heads} KV heads of {cfg.resolved_head_dim}, "
            f"{cfg.mlp_act} d_ff {cfg.d_ff}"
            + (f", {cfg.num_patches} patches" if cfg.num_patches else "")
            + f", vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), "
            f"{run_k['n_params'] / 1e9:.3f}e9 f32 parameters from seed "
            f"{SEED}")
        check_path(run_k["launches"], COMPRESS_PATH,
                   f"{tag}'s compress and serve path")
        check(run_k["compress_launches"]["dequant_matmul"] == 0,
              f"{tag}: K4 launched during compression")
        check(run_k["launches"]["dequant_matmul"]
              == k4_forward * run_k["forwards"],
              f"{tag}: K4 launched {run_k['launches']['dequant_matmul']} "
              f"times, expected {k4_forward} a forward")
        out_k = run_k["out"]
        check_frontend_outputs(torch, cfg, out_k, f"{tag} kernels")
        check(abs(out_k["loss"] - run_k["dense_loss"])
              <= PPL_BAR * run_k["dense_loss"],
              f"{tag}: the packed loss {out_k['loss']} against the dense "
              f"result's {run_k['dense_loss']}")
        add(run_k["launches"], launches)
        add(run_k["k4"], k4)
        add(run_k["k2"], k2)
        with kernels.use_impl("reference"):
            out_kp, _ = frontend_forwards(torch, dev, cfg, model,
                                          run_k["packed"], data["batch"])
        dlogit = float((out_kp["logits"] - out_k["logits"]).abs().max())
        check(abs(out_kp["loss"] - out_k["loss"])
              <= PPL_BAR * out_k["loss"],
              f"{tag}: the packed loss through the plain versions "
              f"{out_kp['loss']} against the kernels' {out_k['loss']}")
        first_equal = all_equal = None
        if out_k["tokens"] is not None:
            first_equal = bool((out_kp["tokens"][:, 0]
                                == out_k["tokens"][:, 0]).all())
            all_equal = bool((out_kp["tokens"] == out_k["tokens"]).all())
            check(first_equal, f"{tag}: first tokens differ between K4 and "
                               f"the plain version on one packed model")
        log(f"[{tag}] the kernels' packed model through the plain versions:"
            f" loss {out_kp['loss']:.6f} against {out_k['loss']:.6f}, "
            f"prefill max |dlogit| {dlogit:.3e}"
            + ("" if first_equal is None else
               f", first tokens {'equal' if first_equal else 'DIFFER'}, all "
               f"tokens {'identical' if all_equal else 'differ'}; row 0: "
               f"{out_k['tokens'][0][:12].tolist()}"))
        engine = None
        packed = run_k.pop("packed")
        if arch != ENGINE_ARCH:
            packed = None
        del out_kp
        torch.cuda.empty_cache()
        held = hold_plain_blocks(torch, dev, model, data, run_k["report"],
                                 tag)
        torch.cuda.empty_cache()
        engines = hold_sequential_blocks(torch, dev, cfg, model,
                                         data["calib"], run_k["report"], tag,
                                         path=PRUNE_QUANT_PATH)
        del run_k["report"]
        torch.cuda.empty_cache()
        if packed is not None:
            eng_launches, _, engine, census, _ = phase_engine(
                torch, cfg, model, packed, f"{arch} ", exact_first=True)
            add(eng_launches, launches)
            add(census, k4)
            del packed
            torch.cuda.empty_cache()
        dec = out_k["decode"]
        summary[arch] = dict(
            layers=cfg.num_layers, n_params=run_k["n_params"],
            compress_s=run_k["compress_s"],
            plain_blocks=held["blocks"],
            waits_per_block=run_k["waits"],
            peak_gb=run_k["peak_bytes"] / 1e9, loss=out_k["loss"],
            ppl=out_k["ppl"], dense_loss=run_k["dense_loss"],
            prefill_s=out_k["prefill_s"],
            prefill_tok_s=BATCH * (PROMPT_LEN + cfg.num_patches)
            / out_k["prefill_s"],
            decode_s=dec and dec["decode"],
            decode_tok_s=dec and BATCH * (GEN - 1) / dec["decode"],
            first_tokens_equal=first_equal, kernels_vs_plain=held,
            engines=engines, engine=engine)
        log(f"[{tag}] summary: {json.dumps(summary[arch])}")
        del run_k, data, out_k
        torch.cuda.empty_cache()
    shapes = check_frontend_shapes(torch, dev)
    summary["seconds"] = time.time() - t_phase
    log(f"[frontends] phase {summary['seconds']:.1f}s; launches {launches}")
    return shapes, launches, k4, k2, summary


def parity_frontends(torch, dev):
    """Under unsplit cuBLAS, each arch of the frontends phase through the
    kernels and through the plain versions: the same bits with equal
    iterations in every compressed layer of the first
    ``FRONTEND_PLAIN_BLOCKS`` blocks, the kernels' packed model (every
    block) giving the same loss, prefill logits and greedy tokens through
    the plain versions, and starcoder2-7b's slot engine every request's
    first token."""
    from repro_torch import kernels
    for arch in FRONTEND_ARCHS:
        cfg = cut_config(arch, FRONTEND_LAYERS)
        tag = f"parity frontends {arch}"
        model, data = frontend_setup(torch, dev, cfg)
        run_k = frontend_run(torch, dev, cfg, model, data, f"{tag} kernels")
        out_k = run_k["out"]
        with kernels.use_impl("reference"):
            out_kp, _ = frontend_forwards(torch, dev, cfg, model,
                                          run_k["packed"], data["batch"])
        same_logits = torch.equal(out_kp["logits"], out_k["logits"])
        same_tokens = out_k["tokens"] is None or bool(
            (out_kp["tokens"] == out_k["tokens"]).all())
        log(f"[{tag}] the kernels' packed model through the plain versions:"
            f" loss {out_kp['loss']:.9f} / {out_k['loss']:.9f}, prefill "
            f"logits " + ("the same bits" if same_logits else "DIFFER")
            + ("" if out_k["tokens"] is None else ", greedy tokens "
               + ("identical" if same_tokens else "DIFFER")))
        check(same_logits and same_tokens and out_kp["loss"] == out_k["loss"],
              f"{tag}: K4 and the plain version serve one packed model "
              f"differently under unsplit cuBLAS")
        packed = run_k.pop("packed")
        if arch != ENGINE_ARCH:
            packed = None
        del out_kp
        torch.cuda.empty_cache()
        held = hold_plain_blocks(torch, dev, model, data, run_k["report"],
                                 tag)
        log(f"[{tag}] kernels against plain over blocks 0-"
            f"{held['blocks'] - 1}: "
            + ("the same bits in every layer" if held["identical"] else
               f"{held['layers_differ']} layers differ, the first "
               f"{held['first_diff']}"))
        check(held["identical"], f"{tag}: the kernels and the plain versions "
                                 f"compress differently under unsplit cuBLAS")
        del run_k, data
        torch.cuda.empty_cache()
        if packed is not None:
            phase_engine(torch, cfg, model, packed, f"parity {arch} ",
                         exact_first=True, count_waits=False)
            del packed
            torch.cuda.empty_cache()


def phase_profile(torch, cfg, data, report, packed, timed):
    """The profile phase: the slot engine's fourth kernel run in a
    ``StepTraceWindow`` (:func:`profile_engine`; ``timed``: its tokens and
    stats from its timed run), then one compression with a profiled block
    (:func:`profile_compression`). The paged engine's profiled run, the
    longest, was cut to give the dry-run phase its time. It comes after every
    timed run and census of this process: a ``torch.profiler`` session
    with CUDA activity slows the later host-bound runs of the same process
    (``PERF.md``), so nothing this process times follows it; the parity
    process is another process."""
    model = data[0]
    slot = profile_engine(torch, model, packed, engine_trace(cfg), "engine",
                          *timed["slot"], "decode_attn")
    comp = profile_compression(torch, data, report, 7 * cfg.num_layers)
    return slot, comp


def check_busy_floor(engines, k4_census, k6_census):
    """A sanity floor on the profiles: a decode-only step's mean device
    busy time is at least what the censuses put in every decode step, K4's
    GEMVs (the engines' M = 8 linears) and K6/K6p, in ms a step."""
    for path, summary in engines.items():
        steps = summary["kernels"]["decode_steps"]
        floor = 1e3 * (k4_census[path]["gemv_device_s"] / steps
                       + k6_census[path]["device_s"]
                       / k6_census[path]["steps"])
        busy = summary["profile"]["decode-only"]["busy_ms"]
        log(f"[profile] {path} engine: decode-only device busy {busy:.3f} "
            f"ms a step; the censuses' K4 GEMV + {k6_census[path]['kernel']}"
            f" {floor:.3f} ms a decode step")
        check(busy >= floor, f"{path} engine: device busy {busy:.3f} ms a "
                             f"decode-only step, below the censuses' "
                             f"{floor:.3f} ms")
        summary["profile"]["census_floor_ms"] = floor


# ---------------------------------------------------------------------------
# sampled tokens on the card, and the multi-device phase
# ---------------------------------------------------------------------------

def _near_tie_report(torch, args, row, tok_card, tok_cpu, tag):
    """A token the card and the CPU sampled differently from the same
    logits: both devices' scores of the two tokens and the card's top-two
    margin (relative). A near-tie is a margin under ``NEAR_TIE``."""
    from repro_torch.serving.sampling import sample_scores
    logits, temps, top_ks, seeds, steps, kk = args
    one = [t[row:row + 1] for t in (logits, temps, top_ks, seeds, steps)]
    s_cpu = sample_scores(*one, max_top_k=kk)[0]
    s_card = sample_scores(*(t.cuda() for t in one), max_top_k=kk)[0].cpu()
    if float(temps[row]) <= 0.0:          # greedy rows: the logits
        s_cpu = s_card = logits[row].to(torch.float32)
    top2 = torch.topk(s_card, 2).values
    margin = float((top2[0] - top2[1]).abs()
                   / top2[0].abs().clamp(min=1e-30))
    log(f"[sampling {tag}] row {row}: card token {tok_card} (scores card "
        f"{float(s_card[tok_card])!r}, CPU {float(s_cpu[tok_card])!r}), CPU "
        f"token {tok_cpu} (card {float(s_card[tok_cpu])!r}, CPU "
        f"{float(s_cpu[tok_cpu])!r}); card top-two margin {margin:.3e}")
    return margin < NEAR_TIE


def hold_samples(torch, calls, tag):
    """Every recorded ``sample_tokens`` call's card tokens against the
    same function on the CPU over a host copy of the same inputs. Returns
    (tokens, differing, the near-ties' (call, row) pairs); a difference
    that is not a near-tie fails the run."""
    from repro_torch.serving.sampling import sample_tokens
    n = differ = 0
    ties = []
    for i, (args, out) in enumerate(calls):
        cpu = sample_tokens(*args[:5], max_top_k=args[5])
        for row in torch.nonzero(cpu != out).flatten().tolist():
            differ += 1
            tie = _near_tie_report(torch, args, row, int(out[row]),
                                   int(cpu[row]), tag)
            check(tie, f"sampling {tag}: row {row} parts from the CPU's "
                       f"token outside a near-tie")
            ties.append((i, row))
        n += out.numel()
    log(f"[sampling {tag}] {n} rows from {len(calls)} calls: {differ} "
        f"differ from the CPU's, {len(ties)} of them near-ties")
    return n, differ, ties


def check_sampling(torch, dev, cfg, model, packed):
    """Sampled tokens on the card (Threefry-2x32, JAX's categorical):
    the probe (``default_rng(0)`` logits × 3, seeds and steps 0–7) gives
    the reference's tokens; then the slot and paged engines serve a
    sampled trace on the packed llama32-1b (temperatures 0.7–1.3, top-k
    0–40, one greedy request), every ``sample_tokens`` call recorded and
    held to the CPU's on a host copy of its inputs. Untimed; after every
    timed engine run."""
    import dataclasses
    import numpy as np
    import repro_torch.serving.engine as engine_mod
    from repro_torch.launch.serve import build_trace
    from repro_torch.serving import Engine, EngineConfig, sample_tokens
    t0 = time.time()
    logits = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (8, 1000)) * 3).astype(np.float32))
    probe_args = (logits, torch.ones(8), torch.zeros(8, dtype=torch.int64),
                  torch.arange(8), torch.arange(8))
    card = sample_tokens(*(t.to(dev) for t in probe_args)).cpu()
    cpu = sample_tokens(*probe_args).tolist()
    check(cpu == SAMPLE_PROBE, f"sampling probe on the CPU: {cpu}, the "
                               f"reference's {SAMPLE_PROBE}")
    _, _, ties = hold_samples(torch, [(probe_args + (64,), card)], "probe")
    tie_rows = {row for _, row in ties}
    for row, (a, b) in enumerate(zip(card.tolist(), SAMPLE_PROBE)):
        check(a == b or row in tie_rows, f"sampling probe row {row}: "
                                         f"{a}, the reference's {b}")
    log(f"[sampling probe] {card.tolist()} (the reference's {SAMPLE_PROBE})")
    reqs = [dataclasses.replace(r, sampling=dataclasses.replace(
        r.sampling, temperature=t, top_k=k))
        for r, (t, k) in zip(build_trace(cfg, **SAMPLED_TRACE),
                             SAMPLED_PARAMS * SAMPLED_TRACE["num_requests"])]
    real = engine_mod.sample_tokens
    out = {"probe": card.tolist()}
    for name, ecfg in (("slot", ENGINE), ("paged", PAGED_ENGINE)):
        calls = []

        def recording(logits, temps, top_ks, seeds, steps, *, max_top_k=64):
            tok = real(logits, temps, top_ks, seeds, steps,
                       max_top_k=max_top_k)
            calls.append((tuple(t.detach().cpu() for t in
                                (logits, temps, top_ks, seeds, steps))
                          + (max_top_k,), tok.detach().cpu()))
            return tok
        engine_mod.sample_tokens = recording
        try:
            eng = Engine(model, packed, EngineConfig(**ecfg))
            for r in reqs:
                eng.submit(dataclasses.replace(r))
            done = eng.run()
        finally:
            engine_mod.sample_tokens = real
        check(len(done) == len(reqs) and all(r.ok for r in done),
              f"sampled {name} engine: not every request completed")
        n, differ, ties = hold_samples(torch, calls, name)
        out[name] = dict(rows=n, differ=differ, near_ties=len(ties))
    out["seconds"] = time.time() - t0
    log(f"[sampling] {json.dumps(out)}")
    return out


@contextlib.contextmanager
def nccl_group(torch, tag):
    """A one-rank NCCL process group on card 0 (a ``FileStore`` rendezvous
    in a temporary directory), destroyed on the way out. NCCL refuses two
    ranks on one device, so one card holds one rank, and every collective
    is the identity. No fallback: without NCCL, or if its init fails, the
    run fails."""
    import torch.distributed as dist
    check(dist.is_available() and dist.is_nccl_available(),
          f"{tag}: torch.distributed has no NCCL")
    check(not dist.is_initialized(), f"{tag}: a process group is up")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            check(dist.get_backend() == "nccl", f"{tag}: backend "
                                                f"{dist.get_backend()}")
            probe = torch.ones(4, device="cuda")
            dist.all_reduce(probe)
            torch.cuda.synchronize()
            check(float(probe.sum()) == 4.0, f"{tag}: all_reduce")
            log(f"[{tag}] one-rank NCCL group (NCCL "
                f"{'.'.join(map(str, torch.cuda.nccl.version()))}) up in "
                f"{time.time() - t0:.2f}s")
            yield
        finally:
            dist.destroy_process_group()


def _event_ms(torch, fn):
    """(result, ms) of one call of ``fn`` between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _saved_counts(ops):
    return {k: getattr(ops, k).copy() for k in
            ("LAUNCHES", "K4_CENSUS", "K4X_CENSUS", "K2_CENSUS", "K6_CENSUS")}


def _restore_counts(ops, saved):
    for k, v in saved.items():
        held = getattr(ops, k)
        held.clear()
        if isinstance(held, dict):
            held.update(v)
        else:
            held.extend(v)


def check_a2a_moe(torch, dev, cfg, model, packed):
    """``moe_apply_a2a`` on layer 0 of the MoE phase's packed model (128
    experts of d_ff 1536 at d_model 4096, top-8) on a one-rank NCCL group,
    4 × 128 tokens from the seed: its packed experts through K4x (one
    launch for each of wg, wu and wd, counted as the ``distributed``
    path) and its experts dequantized once (9.7 GB) as dense stacks, each
    held to the masked dense path on the same weights within
    ``A2A_BAR``. The capacity factor ``A2A_CAPACITY`` drops no token; the
    count dropped is printed. Returns the launches and the numbers."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import ShardingRules
    acfg = dataclasses.replace(cfg, capacity_factor=A2A_CAPACITY)
    p_packed = model.block_slice(packed, 0)["moe"]

    def dense(qt):     # stacked (E, d_out, d_in) codes -> (E, d_in, d_out)
        return torch.stack([qt.map(lambda t, e=e: t[e]).dequant()
                            for e in range(qt.packed.shape[0])]
                           ).transpose(1, 2).contiguous()
    p_dense = dict(p_packed, **{k: dense(p_packed[k])
                                for k in ("wg", "wu", "wd")})
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    x = torch.randn(A2A_TOKENS + (cfg.d_model,), generator=gen, device=dev)
    saved = _saved_counts(ops)
    out = {}
    with nccl_group(torch, "moe a2a"):
        rules = ShardingRules.for_mesh(
            make_mesh((1, 1), ("data", "model"), device=dev))
        for kind, p in (("dense", p_dense), ("packed", p_packed)):
            # one untimed call of each first (NCCL's all-to-all
            # communicator and cuBLAS's handles are made on first use)
            moe.moe_apply_dense(p, x, acfg)
            moe.moe_apply_a2a(p, x, acfg, rules)
            ref, ref_ms = _event_ms(
                torch, lambda: moe.moe_apply_dense(p, x, acfg))
            ops.reset_launches()
            y, ms = _event_ms(
                torch, lambda: moe.moe_apply_a2a(p, x, acfg, rules))
            launches = dict(ops.LAUNCHES)
            err = float((y - ref).abs().max())
            dropped = moe.a2a_dropped(p, x, acfg, rules)
            log(f"[moe a2a {kind}] {A2A_TOKENS[0]} x {A2A_TOKENS[1]} tokens "
                f"on a (1, 1) mesh: a2a {ms:.3f} ms, masked dense "
                f"{ref_ms:.3f} ms, max |a2a - dense| {err:.3e}, "
                f"{dropped} of {A2A_TOKENS[0] * A2A_TOKENS[1] * cfg.experts_per_token}"
                f" assignments dropped (capacity factor {A2A_CAPACITY}); "
                f"launches {launches}")
            check(torch.isfinite(y).all(), f"moe a2a {kind}: not finite")
            check(torch.allclose(y, ref, rtol=A2A_BAR, atol=A2A_BAR),
                  f"moe a2a {kind}: {err:.3e} from the masked dense path")
            check(dropped == 0, f"moe a2a {kind}: {dropped} dropped")
            out[kind] = dict(a2a_ms=ms, dense_ms=ref_ms, max_abs_err=err,
                             dropped=dropped)
            if kind == "packed":
                check(launches["dequant_matmul_experts"] == 3
                      and sum(launches.values()) == 3,
                      f"moe a2a packed: launches {launches}, expected K4x "
                      f"three times")
                dist_launches = launches
            else:
                check(not any(launches.values()),
                      f"moe a2a dense launched {launches}")
    _restore_counts(ops, saved)
    del p_dense
    torch.cuda.empty_cache()
    return dist_launches, out


def dist_awp(torch, dev, rules, card):
    """Sharded AWP at llama32-1b's wd shape on the one-rank mesh: C from
    seeded activations by ``calib_c_distributed`` (held to XᵀX/n), the
    row-sharded loop (K1, K2) bit-equal to the compression path's own
    unsharded loop (``core.awp.pgd`` with the prune projection, tol 0) on
    the kernels, the column-sharded loop (K2, the partial product in
    ``torch.matmul``, as the reference's is outside any kernel) bit-equal
    to that loop through the plain versions, and the two unsharded loops
    held to each other (mask agreement). Returns the sharded loops'
    launches and the numbers."""
    from repro_torch import kernels
    from repro_torch.core import awp
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    a = DIST_AWP
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    w = torch.randn((a["d_out"], a["d_in"]), generator=gen, device=dev)
    acts = torch.randn((a["tokens"], a["d_in"]), generator=gen, device=dev)
    c, c_ms = _event_ms(torch, lambda: D.calib_c_distributed(acts, rules))
    c_ref = acts.T @ acts / a["tokens"]
    c_err = float(((c - c_ref).abs().max() / c_ref.abs().max()))
    log(f"[dist calib] C = XᵀX/n from {a['tokens']} x {a['d_in']} "
        f"activations: {c_ms:.3f} ms, max relative difference to XᵀX/n "
        f"{c_err:.3e}{' (the same bits)' if torch.equal(c, c_ref) else ''}")
    check(c_err <= 1e-6, f"calib_c_distributed: {c_err:.3e} from XᵀX/n")
    k, iters = a["d_in"] // 2, a["iters"]
    eta = float(awp._eta(c, 2.0))
    loop = awp.PGDConfig(max_iters=iters, tol=0.0, eta_scale=2.0)

    def unsharded():
        theta0 = kernels.impl("topk_row")(w, k)
        return awp.pgd(w, c, awp.prune_projection(k), theta0, loop).theta
    ops.reset_launches()
    theta_u, u_ms = _event_ms(torch, unsharded)
    ops.reset_launches()
    theta_r, r_ms = _event_ms(
        torch, lambda: D.awp_prune_rowsharded(w, c, k, eta, iters, rules))
    row_launches = dict(ops.LAUNCHES)
    with kernels.use_impl("reference"):
        theta_p, p_ms = _event_ms(torch, unsharded)
    ops.reset_launches()
    col = D.awp_prune_colsharded_fn(k, eta, iters, rules)
    theta_c, c_loop_ms = _event_ms(torch, lambda: col(w, c))
    col_launches = dict(ops.LAUNCHES)
    agree = float(((theta_u != 0) == (theta_p != 0)).float().mean())
    log(f"[dist awp] ({a['d_out']}, {a['d_in']}), k {k}, {iters} iterations "
        f"on a (1, 1) mesh: unsharded (K1, K2) {u_ms:.2f} ms, row-sharded "
        f"{r_ms:.2f} ms (launches {row_launches}), unsharded plain "
        f"{p_ms:.2f} ms, column-sharded {c_loop_ms:.2f} ms (launches "
        f"{col_launches}); row-sharded == unsharded: "
        f"{torch.equal(theta_r, theta_u)}, column-sharded == unsharded "
        f"plain: {torch.equal(theta_c, theta_p)}; kernels against plain: "
        f"{agree:.6f} of the mask equal; {card}")
    check(torch.equal(theta_r, theta_u), "row-sharded AWP parts from the "
                                         "unsharded loop at one rank")
    check(torch.equal(theta_c, theta_p), "column-sharded AWP parts from the "
                                         "unsharded plain loop at one rank")
    check(agree >= AGREE_BAR, f"AWP kernels against plain: {agree:.6f} of "
                              f"the mask equal")
    check(row_launches["awp_pgd_step"] == iters
          and row_launches["topk_row"] == iters + 1
          and col_launches["topk_row"] == iters + 1
          and col_launches["awp_pgd_step"] == 0,
          f"sharded AWP launches: row {row_launches}, column {col_launches}")
    launches = {n: row_launches[n] + col_launches[n] for n in row_launches}
    return launches, dict(calib_ms=c_ms, calib_rel_err=c_err,
                          unsharded_ms=u_ms, rowsharded_ms=r_ms,
                          plain_ms=p_ms, colsharded_ms=c_loop_ms,
                          mask_agree=agree)


def dist_train(torch, dev, cfg, rules, card):
    """llama32-1b at full width from the seed, ``DIST_STEPS`` steps each of
    the plain train step, ``make_train_step_ddp`` with ``compress=None``
    (bit-equal to the plain step at one rank), the plain step fed
    gradients through ``int8_compress``/``int8_decompress`` and
    ``make_train_step_ddp`` with ``"int8"`` (bit-equal to it), and the
    DTensor-sharded step (``shard_train_state`` + ``sharded_step``, held
    to the plain step within the reference's bars). Step times from CUDA
    events. Returns the numbers."""
    import argparse
    import statistics
    from repro_torch.data import DataConfig, ZipfMarkov
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    from repro_torch.optim.grad_compress import int8_compress, int8_decompress
    from repro_torch.optim.optimizers import make_optimizer, tree_map
    from repro_torch.sharding import NamedSharding, distribute, full_tensor
    from repro_torch.training.train_loop import (
        compute_grads, init_train_state, make_train_step,
        make_train_step_ddp, shard_train_state, sharded_step)
    model = build_model(cfg, remat=True)
    tcfg = train_cli.train_config(argparse.Namespace(
        optimizer="adamw", lr=TRAIN["lr"], steps=TRAIN["steps"],
        microbatches=1))
    state0 = init_train_state(model, SEED, device=dev, tcfg=tcfg)
    gen = ZipfMarkov(DataConfig(vocab_size=cfg.vocab_size,
                                seq_len=TRAIN["seq"],
                                global_batch=TRAIN["batch"]))
    batches = [train_cli.device_batch(gen, i, dev) for i in range(DIST_STEPS)]

    def run(step_fn, state, feed):
        losses, ms = [], []
        for b in feed:
            (state, m), t = _event_ms(torch, lambda: step_fn(state, b))
            losses.append(m["loss"])
            ms.append(t)
        return state, [float(full_tensor(v)) for v in losses], ms

    _, opt_update = make_optimizer(tcfg.optimizer)

    def int8_ref_step(state, batch):
        loss, grads = compute_grads(model, tcfg, state["params"], batch)
        grads = tree_map(lambda g: int8_decompress(*int8_compress(g)), grads)
        params, opt, om = opt_update(grads, state["opt"], state["params"])
        return ({"params": params, "opt": opt, "step": state["step"] + 1},
                {"loss": loss, **om})

    out, held = {}, {}
    plain, _ = make_train_step(model, tcfg)
    st, out["plain_loss"], out["plain_ms"] = run(plain, _tree_clone(state0),
                                                 batches)
    plain_params = st["params"]
    del st
    ddp, _ = make_train_step_ddp(model, tcfg, rules, compress=None)
    st, out["ddp_loss"], out["ddp_ms"] = run(ddp, _tree_clone(state0),
                                             batches)
    held["ddp"] = hold_states(torch, plain_params, st["params"],
                              "dist ddp against plain", 0.0)
    check(out["ddp_loss"] == out["plain_loss"], "DDP losses part")
    del st
    st, out["int8_ref_loss"], _ = run(int8_ref_step, _tree_clone(state0),
                                      batches)
    ref_params = st["params"]
    del st
    ddp8, _ = make_train_step_ddp(model, tcfg, rules, compress="int8")
    st, out["int8_loss"], out["int8_ms"] = run(ddp8, _tree_clone(state0),
                                               batches)
    held["int8"] = hold_states(torch, ref_params, st["params"],
                               "dist ddp int8 against plain+int8", 0.0)
    check(out["int8_loss"] == out["int8_ref_loss"], "DDP int8 losses part")
    del st, ref_params
    torch.cuda.empty_cache()
    m_sh = build_model(cfg, rules, remat=True)
    step_s, _ = make_train_step(m_sh, tcfg)
    st = shard_train_state(_tree_clone(state0), m_sh, rules)
    del state0
    feed = [{k: distribute(v, NamedSharding(
        rules.mesh, rules.spec(("batch", None), v.shape)))
        for k, v in b.items()} for b in batches]
    st, out["sharded_loss"], out["sharded_ms"] = run(sharded_step(step_s),
                                                     st, feed)
    worst = 0.0
    for (key, a), (_, b) in zip(_paths(plain_params), _paths(st["params"])):
        b = full_tensor(b)
        check(torch.allclose(b, a, rtol=DIST_RTOL, atol=DIST_ATOL),
              f"sharded step: {'/'.join(key)} outside the bars")
        worst = max(worst, float((b - a).abs().max()))
    loss_d = max(abs(x - y) for x, y in zip(out["sharded_loss"],
                                            out["plain_loss"]))
    check(loss_d < DIST_LOSS_BAR, f"sharded step loss {loss_d:.3e} off")
    held["sharded"] = dict(max_abs_diff=worst, loss_diff=loss_d)
    del st, plain_params
    torch.cuda.empty_cache()
    med = {k: statistics.median(out[f"{k}_ms"][1:]) for k in
           ("plain", "ddp", "int8", "sharded")}
    log(f"[dist train] {cfg.name} at full width, batch {TRAIN['batch']} x "
        f"{TRAIN['seq']}, {DIST_STEPS} steps each on a (1, 1) mesh; median "
        f"step (steps 2-{DIST_STEPS}) plain {med['plain']:.2f} ms, ddp "
        f"{med['ddp']:.2f} ms, ddp int8 {med['int8']:.2f} ms, DTensor "
        f"sharded {med['sharded']:.2f} ms (first step "
        f"{out['sharded_ms'][0]:.2f} ms); losses plain {out['plain_loss']}, "
        f"sharded {out['sharded_loss']}; ddp bit-equal "
        f"{held['ddp']['same_bits']}, int8 bit-equal "
        f"{held['int8']['same_bits']}, sharded max |diff| {worst:.3e}, loss "
        f"{loss_d:.3e}; {card}")
    return dict(out, median_ms=med, held=held)


def phase_distributed(torch, dev, cfg, card):
    """The multi-device slice on one card: one one-rank NCCL group, a
    (1, 1) ("data", "model") mesh, sharded AWP and ``calib_c_distributed``
    (:func:`dist_awp`) and the DDP and DTensor train steps
    (:func:`dist_train`). After every timed host-bound run and the profile
    phase, so NCCL's threads slow none of them; the group is destroyed at
    the end. Returns the sharded AWP loops' launches and the numbers."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import ShardingRules
    t0 = time.time()
    with nccl_group(torch, "dist"):
        rules = ShardingRules.for_mesh(
            make_mesh((1, 1), ("data", "model"), device=dev))
        launches, awp = dist_awp(torch, dev, rules, card)
        torch.cuda.empty_cache()
        train = dist_train(torch, dev, cfg, rules, card)
    secs = time.time() - t0
    log(f"[dist] phase {secs:.1f}s")
    return launches, dict(seconds=secs, awp=awp, train=train)


def dryrun_cell(arch, shape, mesh, out_dir, extra=()):
    """The dry run of one cell in its own process (``python -m
    repro_torch.launch.dryrun``; a fake process group, meta tensors, no
    device), started and returned unwaited."""
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--results-dir", out_dir,
         *extra], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def dryrun_result(proc, out_dir, arch, shape, mesh, tag):
    """The JSON a :func:`dryrun_cell` process wrote, once it has ended."""
    out, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"{tag}: the dry run of {arch} {shape} "
                                f"{mesh} failed:\n{out[-2000:]}{err[-3000:]}")
    with open(Path(out_dir) / mesh / f"{arch}__{shape}.json") as f:
        return json.load(f)


def phase_dryrun(torch, dev, card):
    """The dry run (``repro_torch.launch.dryrun``) against the card.

    llama32-1b's ``train_4k`` cell cut to ``DRYRUN_BATCH`` ×
    ``DRYRUN_SEQ`` on one rank (a (1, 1) mesh), bf16 params, AdamW, remat,
    runs in its own process on the card's host while the same step runs
    for real on the card (plain tensors, the train CLI's step): the real
    step's FlopCounterMode count must equal the dry run's fitted count,
    and the card's peak (``max_memory_allocated`` over the step, less what
    other phases left allocated) must be within ``DRYRUN_MEM_TOL`` of the
    dry run's ``total_per_device_bytes``. The measured step time (CUDA
    events, the median of ``DRYRUN_STEPS`` steps after the first) is
    printed beside the roofline's ``t_bound``. Beside them the cheapest
    production decode cell (``DRYRUN_PRODUCTION``, 256 ranks) runs on this
    host's PyTorch, which has no JAX."""
    import tempfile
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.models import build_model, make_batch
    from repro_torch.optim import OptimizerConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    t0 = time.time()
    out_dir = tempfile.mkdtemp(prefix="dryrun_")
    cut = ("--batch", str(DRYRUN_BATCH), "--seq", str(DRYRUN_SEQ))
    one = dryrun_cell(ARCH, "train_4k", "1x1", out_dir, cut)
    prod = dryrun_cell(*DRYRUN_PRODUCTION, out_dir)

    cfg = get_config(ARCH)
    model = build_model(cfg, remat=True)
    step, opt_init = make_train_step(model, TrainConfig(
        optimizer=OptimizerConfig(name="adamw")))
    params = model.init(SEED, device=dev, dtype=torch.bfloat16)
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = make_batch(cfg, gen, DRYRUN_BATCH, DRYRUN_SEQ, device=dev)
    args = float(local_bytes((state, batch)))
    torch.cuda.synchronize()
    others = torch.cuda.memory_allocated() - args
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    flops = fc.get_total_flops()
    peak = torch.cuda.max_memory_allocated() - others
    times = []
    for _ in range(DRYRUN_STEPS):
        (state, _), ms = _event_ms(torch, lambda: step(state, batch))
        times.append(ms)
    step_ms = sorted(times)[len(times) // 2]
    del state, params, batch
    torch.cuda.empty_cache()

    pred = dryrun_result(one, out_dir, ARCH, "train_4k", "1x1", "dryrun")
    prodr = dryrun_result(prod, out_dir, *DRYRUN_PRODUCTION, "dryrun")
    pf = pred["cost_fit"]["flops"]
    mem = pred["memory"]["total_per_device_bytes"]
    gap = (peak - mem) / mem
    roof = pred["roofline"]
    t_bound = max(roof["t_compute_s"], roof["t_memory_s"],
                  roof["t_collective_s"]) * 1e3
    log(f"[dryrun] {ARCH} train {DRYRUN_BATCH}x{DRYRUN_SEQ} on one rank: "
        f"flops counted on the card {flops} against the dry run's "
        f"{pf:.1f} (fit over depths {pred['cost_fit']['fit_depths']}); "
        f"peak {peak / 1e9:.3f} GB (arguments {args / 1e9:.3f} GB) against "
        f"the dry run's {mem / 1e9:.3f} GB (arguments "
        f"{pred['memory']['argument_size_in_bytes'] / 1e9:.3f} GB, "
        f"transient {pred['memory']['temp_size_in_bytes'] / 1e9:.3f} GB), "
        f"gap {gap:+.4f}; step {step_ms:.2f} ms (steps {times}) against "
        f"t_bound {t_bound:.2f} ms ({roof['bottleneck']}-bound, "
        f"{roof['t_compute_s'] * 1e3:.2f} ms compute at 989 TFLOP/s bf16; "
        f"a bound from published peaks); card {card}")
    check(flops == round(pf), f"dryrun: the card's step counted {flops} "
                              f"flops, the dry run {pf}")
    check(abs(gap) <= DRYRUN_MEM_TOL,
          f"dryrun: peak {peak} B against the predicted {mem} B "
          f"({gap:+.4f}, tolerance {DRYRUN_MEM_TOL})")
    pm, pr = prodr["memory"], prodr["roofline"]
    log(f"[dryrun] production cell {' '.join(DRYRUN_PRODUCTION)} "
        f"({prodr['chips']} ranks) on this host: "
        f"{pm['total_per_device_bytes'] / 1e9:.3f} GB/device, bounds "
        f"compute {pr['t_compute_s']:.6f} s memory {pr['t_memory_s']:.6f} "
        f"s collective {pr['t_collective_s']:.6f} s -> {pr['bottleneck']} "
        f"(in {prodr['compile_seconds']:.1f}s)")
    secs = time.time() - t0
    log(f"[dryrun] phase {secs:.1f}s")
    return dict(seconds=secs, flops=flops, flops_predicted=pf,
                peak_bytes=peak, predicted_bytes=mem, gap=gap,
                step_ms=step_ms, t_bound_ms=t_bound,
                production=dict(cell=list(DRYRUN_PRODUCTION),
                                total_per_device_bytes=pm[
                                    "total_per_device_bytes"],
                                roofline=pr))


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


def parity_kernels(torch, dev):
    """Under unsplit cuBLAS, the PGD step's sum order held directly: K1's Z
    bit-equal to the plain version at its four shapes with every tile
    variant (a reordered sum shows here, not only as a compression
    mismatch); K1b at its four shapes the same bits if cuBLAS's
    strided-batched product sums in K1b's order — if not, the first
    differing shape is printed and the pair held to 1e-5 of max|Z|."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for m, k in K1_SHAPES:
        w, theta = randn(m, k), randn(m, k)
        c = randn(k, k) / math.sqrt(k)
        eta = 2.0 / torch.linalg.matrix_norm(c)
        z_ref, _ = ref.awp_pgd_step(w, theta, c, eta)
        for v in range(len(ops.AWP_PGD_TILES)):
            z, _ = ops.awp_pgd_step(w, theta, c, eta, variant=v)
            n_diff = int((z != z_ref).sum())
            check(n_diff == 0, f"K1 {(m, k)} variant {v}: {n_diff} entries "
                               f"of Z differ from the plain version under "
                               f"unsplit cuBLAS")
        log(f"[parity K1] {(m, k)}: Z bit-equal to the plain version with "
            f"every tile variant (the wrapper picks "
            f"{k1_variant(torch, 1, m, k)})")
    first = None
    for b, m, k in K1B_SHAPES:
        w, theta = randn(b, m, k), randn(b, m, k)
        c = randn(b, k, k) / math.sqrt(k)
        c[1] *= 1.7
        eta = 2.0 / torch.linalg.matrix_norm(c)
        z, _ = ops.awp_pgd_step(w, theta, c, eta)
        z_ref, _ = ref.awp_pgd_step(w, theta, c, eta)
        n_diff = int((z != z_ref).sum())
        if n_diff:
            err = float((z - z_ref).abs().max())
            check(err <= 1e-5 * float(z_ref.abs().max()),
                  f"K1b {(b, m, k)}: max|dZ| {err:.3e} under unsplit cuBLAS")
            first = first or ((b, m, k), n_diff, z.numel())
    log("[parity K1b] " + (
        f"Z bit-equal to the plain version at all {len(K1B_SHAPES)} shapes"
        if first is None else
        f"first differing shape {first} (shape, differing entries, "
        f"entries); held to 1e-5 of max|Z| instead"))
    parity_k4(torch, dev, gen, randn)
    parity_prune_fused(torch, dev)


def parity_prune_fused(torch, dev):
    """Under unsplit cuBLAS, ``awp_prune_fused`` on the kernels gives its
    plain loop's bits (K1's Z is the plain version's, so every top-k sees
    the same row)."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    m, k = FUSED_SHAPE
    w, c, eta, keep = fused_inputs(torch, dev, gen, m, k)
    th = ops.awp_prune_fused(w, c, keep, eta, FUSED_ITERS,
                             theta0=ops.topk_row(w, keep))
    th_p = ops.awp_prune_fused(w, c, keep, eta, FUSED_ITERS,
                               theta0=ref.topk_row(w, keep),
                               use_pallas=False)
    n_diff = int((th != th_p).sum())
    check(n_diff == 0, f"awp_prune_fused: {n_diff} entries of theta differ "
                       f"from the plain loop under unsplit cuBLAS")
    log(f"[parity K1+K2] awp_prune_fused {FUSED_SHAPE} x {FUSED_ITERS}: "
        f"theta bit-equal to the plain loop")


def parity_k4(torch, dev, gen, randn):
    """Under unsplit cuBLAS, K4's tile at the four packed linears' (N, K),
    M in {64, 512, 4096}, every tile variant, bit-equal to the plain
    version (dequantize, then cuBLAS; the earlier 64 x 64 tile was too).
    Whether the GEMV (M = 4, 8, every split) gives the plain version's bits
    is printed: a record, not a gate (it sums in another order)."""
    from repro_torch.kernels import ops, ref
    checked, gemv = 0, {}
    for n, k in K4_NK:
        packed, scale, zero = k4_weight(torch, dev, gen, n, k, 128)
        for m in (4, 8, 64, 512, 4096):
            x = randn(m, k)
            y_ref = ref.dequant_matmul(x, packed, scale, zero, 128)
            for v in ops.dequant_matmul_variants(m, k):
                y = ops.dequant_matmul(x, packed, scale, zero, 128, variant=v)
                n_diff = int((y != y_ref).sum())
                if m <= ops.GEMV_MAX_M:
                    if v >= len(ops.DEQUANT_TILES):
                        name = ops.dequant_matmul_variant_name(v)
                        gemv[(m, n, k, name)] = n_diff
                    continue
                checked += 1
                check(n_diff == 0, f"K4 M={m} N={n} K={k} "
                                   f"{ops.dequant_matmul_variant_name(v)}: "
                                   f"{n_diff} entries of y differ from the "
                                   f"plain version under unsplit cuBLAS")
    log(f"[parity K4] tile bit-equal to the plain version at all {checked} "
        f"(shape, variant) pairs")
    log("[parity K4] GEMV entries differing from the plain version (a "
        "record): " + ", ".join(f"M={m} N={n} K={k} {name}: {d}"
                                for (m, n, k, name), d in gemv.items()))


def parity_train(torch, dev, cfg):
    """Under unsplit cuBLAS, llama32-1b's gradient at its init (seed 0)
    on the training phase's batch 200 as two microbatches against one:
    within ``MICRO_PARITY_BAR`` of each leaf's norm (the phase's
    ``MICRO_BAR`` covers the default configuration's split-K sums)."""
    import argparse
    from repro_torch.data import DataConfig, ZipfMarkov
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    model = build_model(cfg)
    tcfg = train_cli.train_config(argparse.Namespace(
        optimizer="adamw", lr=TRAIN["lr"], steps=TRAIN["steps"],
        microbatches=1))
    params = model.init(SEED, device=dev)
    gen = ZipfMarkov(DataConfig(vocab_size=cfg.vocab_size,
                                seq_len=TRAIN["seq"],
                                global_batch=TRAIN["batch"]))
    hold_microbatches(torch, model, tcfg, params,
                      train_cli.device_batch(gen, TRAIN["steps"], dev),
                      MICRO_PARITY_BAR, "parity train")
    del params


def parity_main(torch, dev, cfg):
    """Under unsplit cuBLAS: K1 and K1b against their plain versions
    (:func:`parity_kernels`); the sequential driver's kernel and plain paths
    must give the same bits and tokens; the batched
    engine's must too if cuBLAS's strided-batched product sums in the
    plain K1b's order as K1b does — if not, the first differing layer is
    recorded and the pair held to the bars; then the engine."""
    check(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == UNSPLIT_CUBLAS,
          f"{PARITY} needs CUBLAS_WORKSPACE_CONFIG={UNSPLIT_CUBLAS}")
    parity_kernels(torch, dev)
    parity_moe(torch, dev)
    torch.cuda.empty_cache()
    parity_train(torch, dev, cfg)
    torch.cuda.empty_cache()
    parity_ssm(torch, dev)
    torch.cuda.empty_cache()
    parity_frontends(torch, dev)
    torch.cuda.empty_cache()
    data = setup(torch, dev, cfg)
    model, _, _, prompts = data
    for engine, mode in (("sequential", "bits"), ("batched", "bits_if_same")):
        tag = f"parity {engine} "
        _, out_k, out_p, _ = both_paths(torch, dev, data, tag, engine)
        compare(torch, dev, cfg, model, prompts, out_k, out_p, tag, mode)
        packed = out_k[1]
        del out_k, out_p
        torch.cuda.empty_cache()
    del data
    torch.cuda.empty_cache()
    phase_engine(torch, cfg, model, packed, "parity ", exact_first=True,
                 count_waits=False)
    phase_paged_engine(torch, cfg, model, packed, "parity ",
                       exact_first=True, count_waits=False)


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
    fused_launches = check_prune_fused(torch, dev)
    rows["dequant_matmul_experts"], moe_launches, moe, moe_keep = phase_moe(
        torch, dev)
    torch.cuda.empty_cache()
    shapes, methods_launches, methods_k4, methods_k2, methods = \
        phase_methods(torch, dev)
    for name, entries in shapes.items():
        rows[name].setdefault("by_shape", [dict(rows[name])])
        rows[name]["by_shape"] += entries
    torch.cuda.empty_cache()
    train_launches, train = phase_train(torch, dev, cfg)
    torch.cuda.empty_cache()
    train_families = phase_train_families(torch, dev)
    torch.cuda.empty_cache()
    ssm_shapes, ssm_launches, ssm_k4, ssm_k2, ssm, ssm_keep = phase_ssm(
        torch, dev)
    for name, entries in ssm_shapes.items():
        rows[name].setdefault("by_shape", [dict(rows[name])])
        rows[name]["by_shape"] += entries
    torch.cuda.empty_cache()
    fe_shapes, fe_launches, fe_k4, fe_k2, fe = phase_frontends(torch, dev)
    for name, entries in fe_shapes.items():
        key = "by_lengths" if name.startswith("decode_attn") else "by_shape"
        rows[name].setdefault(key, [dict(rows[name])])
        rows[name][key] += entries
    torch.cuda.empty_cache()
    data = setup(torch, dev, cfg)
    launches, packed, census, k2_main, comp, report = phase_main_path(
        torch, dev, cfg, data)
    log(f"[train compress] the trained model's compression (mixed policy, "
        f"batched engine, kernels) {train['compress_s']:.2f}s against the "
        f"random-weight model's {comp['batched_s']:.2f}s; plain "
        f"{train['compress_plain_s']:.2f}s against "
        f"{comp['batched_plain_s']:.2f}s")
    prune_launches, k2_prune, prune = phase_prune_path(torch, cfg, data)
    model = data[0]
    eng_launches, slot_tokens, eng, slot_census, slot_k6 = phase_engine(
        torch, cfg, model, packed, "", exact_first=False, k6_census=True)
    paged_launches, paged, paged_census, paged_k6, _ = \
        phase_paged_engine(torch, cfg, model, packed, "", exact_first=False,
                           slot_tokens=slot_tokens, k6_census=True)
    k6_census = phase_k6_census(torch, dev, {"slot": slot_k6,
                                             "paged": paged_k6},
                                cfg.num_layers)
    rows["decode_attn"]["census"] = k6_census["slot"]
    rows["decode_attn_paged"]["census"] = k6_census["paged"]
    k4_census = phase_k4_census(torch, dev, {
        **dict(zip(K4_PATHS, (census, slot_census, paged_census))),
        "methods": methods_k4, "ssm": ssm_k4, "frontends": fe_k4})
    rows["dequant_matmul"]["census"] = k4_census
    rows["topk_row"]["census"] = phase_k2_census(
        torch, dev, {**k2_main, **k2_prune, "methods": methods_k2,
                     "ssm": ssm_k2, "frontends": fe_k2})
    eng["profile"], comp["profile"] = phase_profile(
        torch, cfg, data, report, packed,
        {"slot": (slot_tokens, eng["kernels"])})
    check_busy_floor({"slot": eng}, k4_census, k6_census)
    ssm["profile"] = phase_ssm_profile(torch, dev, ssm_keep)
    moe["profile"] = phase_moe_profile(torch, dev, moe_keep)
    sampling = check_sampling(torch, dev, cfg, model, packed)
    del data, model, packed, report, ssm_keep, moe_keep
    torch.cuda.empty_cache()
    dryrun = phase_dryrun(torch, dev, card)
    torch.cuda.empty_cache()
    dist_launches, dist = phase_distributed(torch, dev, cfg, card)
    a2a_launches = moe.pop("a2a_launches")
    dist_launches = {n: dist_launches[n] + a2a_launches[n]
                     for n in dist_launches}
    check_path(dist_launches, DIST_PATH, "the distributed path")
    torch.cuda.empty_cache()
    phase_parity()

    out = []
    for name, (source, replaces) in KERNELS.items():
        row = rows[name]
        by_path = {"compress_decode": launches[name],
                   "prune": prune_launches[name],
                   "engine": eng_launches[name],
                   "paged_engine": paged_launches[name],
                   **{path: n[name] for path, n in moe_launches.items()},
                   "methods": methods_launches[name],
                   "train_compress": train_launches[name],
                   "ssm": ssm_launches[name],
                   "frontends": fe_launches[name],
                   "distributed": dist_launches[name],
                   "prune_fused": fused_launches[name]}
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"], "shape": row["shape"]}
        for extra in ("dense", "by_shape", "by_lengths", "census"):
            if extra in row:
                entry[extra] = row[extra]
        out.append(entry)
    log(f"[compress] summary: {json.dumps(comp)}")
    log(f"[prune] summary: {json.dumps(prune)}")
    log(f"[engine] summary: {json.dumps(eng)}")
    log(f"[paged] summary: {json.dumps(paged)}")
    log(f"[moe] summary: {json.dumps(moe)}")
    log(f"[methods] summary: {json.dumps(methods)}")
    log(f"[train] summary: {json.dumps(train)}")
    log(f"[train families] summary: {json.dumps(train_families)}")
    log(f"[ssm] summary: {json.dumps(ssm)}")
    log(f"[frontends] summary: {json.dumps(fe)}")
    log(f"[sampling] summary: {json.dumps(sampling)}")
    log(f"[dist] summary: {json.dumps(dist)}")
    log(f"[dryrun] summary: {json.dumps(dryrun)}")
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
