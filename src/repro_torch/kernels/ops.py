"""Wrappers of the hand-written kernels K1–K6, K4x and K6p (``csrc/*.cu``).

Every wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on ``torch.cuda.current_stream()``
and raises if the launch reports an error. A tensor on the CPU takes the
plain version in :mod:`repro_torch.kernels.ref` (that is the only reason
the plain version runs); a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches per wrapper, so a run can show that its
main path went through the kernels; a batched (3-D) call of
:func:`awp_pgd_step` is K1b and counts under ``awp_pgd_step_batched``.
``K4_CENSUS`` counts K4's launches by (M, N, K, variant), ``K4X_CENSUS``
K4x's by (E, M, N, K, variant, per_expert), ``K2_CENSUS``
K2's by (rows, d, k, variant); while :func:`arm_k6_census` is on,
``K6_CENSUS`` records each K6 and K6p launch's shapes with device-side
clones of its lengths (and table), read on the host only afterwards.

TF32 is switched off for the whole port at import: the PGD stop rule sits
at tol 1e-4 on ‖∇f‖/‖W‖ (``repro/core/awp.py:46``) and TF32's 10-bit
mantissa would move iteration counts and pruning masks, so every f32
product stays IEEE f32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KERNELS = ("awp_pgd_step", "topk_row", "quant_project", "dequant_matmul",
           "dequant_matmul_experts", "kv_dequant", "decode_attn",
           "decode_attn_paged")
# launches per kernel: K1b (a 3-D awp_pgd_step) has its own count
LAUNCHES = dict.fromkeys(("awp_pgd_step", "awp_pgd_step_batched")
                         + KERNELS[1:], 0)
# K4's card launches by (M, N, K, variant)
K4_CENSUS: dict = {}
# K4x's card launches by (E, M, N, K, variant, per_expert)
K4X_CENSUS: dict = {}
# K2's card launches by (rows, d, k, variant)
K2_CENSUS: dict = {}
# K6's and K6p's card launches while armed: one dict a launch (kernel,
# shapes, device clones of lengths and table)
K6_CENSUS: list = []
_K6_ARMED = False


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    K4_CENSUS.clear()
    K4X_CENSUS.clear()
    K2_CENSUS.clear()
    K6_CENSUS.clear()


def arm_k6_census(on: bool = True) -> bool:
    """Record (``on``) or stop recording K6/K6p launches in
    ``K6_CENSUS``; returns the previous setting. A record clones lengths
    and table on the device, so arming adds no host wait."""
    global _K6_ARMED
    prev, _K6_ARMED = _K6_ARMED, bool(on)
    return prev


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or
    on any other device."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"{name}: operands on {sorted(str(t.device) for t in tensors)}"
                     f" — need all on the CPU or all on one CUDA device")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous")


def _launch(name: str, fn, *args) -> None:
    from repro_torch.kernels import _build
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn)(*args, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
    LAUNCHES[name] += 1


# K1/K1b tile variants, by the index the C entry point takes: (rows,
# columns) of a block's output tile (csrc/awp_pgd.cu)
AWP_PGD_TILES = ((128, 128), (64, 128))
H100_SMS = 132


def awp_pgd_tiles(b: int, m: int, k: int, sms: int = H100_SMS):
    """(bm, bn, variant) of K1/K1b for a (b, m, k) step on a card with
    ``sms`` SMs: the 128 × 128 tile (variant 0) unless the 64 × 128 tile
    (variant 1) leaves the busiest SM less work. A variant's time goes as
    the blocks on the busiest SM, ⌈blocks / sms⌉, times one block's time,
    and a 64 × 128 block takes 0.575 of a 128 × 128 one (half the outputs
    at 0.87 of the rate, measured on an H100). So M = 512 takes variant 1
    at B = 1 (1 block an SM against 1) and B = 3 (3 against 2), variant 0
    at B = 2 (2 against 1)."""
    def busiest(variant):
        bm, bn = AWP_PGD_TILES[variant]
        return -(-(b * -(-m // bm) * -(-k // bn)) // sms)
    variant = 1 if 23 * busiest(1) < 40 * busiest(0) else 0
    return AWP_PGD_TILES[variant] + (variant,)


def awp_pgd_grid(b: int, m: int, k: int, variant: int):
    """(B, tiles_m, tiles_n) of a variant's grid: the shape of the
    per-tile partials of the residual norm."""
    bm, bn = AWP_PGD_TILES[variant]
    return b, -(-m // bm), -(-k // bn)


def awp_pgd_vector_copies(k: int, *tensors: torch.Tensor) -> bool:
    """True when K1 can copy 16 bytes at a time: K % 4 == 0 and every
    operand 16-byte aligned; else it runs its scalar-copy instantiation."""
    return k % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def awp_pgd_step(w, theta, c, eta, variant=None):
    """K1: Z = Θ + η (W − Θ) C, and ‖(W − Θ) C‖_F summed from the kernel's
    per-tile f32 partials.

    (M, K) operands with a scalar η (K1), or batched (B, M, K) / (B, K, K)
    with η of shape (B,) or scalar and a norm per item (K1b: the same
    kernel over a batch grid dimension). η is a tensor on the operands'
    device, read by the kernel from device memory (no host sync). The tile
    is :func:`awp_pgd_tiles`'s unless ``variant`` names one. Operands with
    K % 4 ≠ 0 or not 16-byte aligned take the kernel's scalar-copy
    instantiation (same tiles and sum order)."""
    eta = torch.as_tensor(eta, dtype=torch.float32, device=w.device)
    if not _on_card("awp_pgd_step", w, theta, c, eta):
        return ref.awp_pgd_step(w, theta, c, eta)
    batched = w.dim() == 3
    if not batched and w.dim() != 2:
        raise ValueError(f"awp_pgd_step: w must be 2-D or 3-D, got {w.dim()}")
    b = w.shape[0] if batched else 1
    m, k = w.shape[-2:]
    _check("awp_pgd_step.w", w, torch.float32, w.shape)
    _check("awp_pgd_step.theta", theta, torch.float32, w.shape)
    _check("awp_pgd_step.c", c, torch.float32,
           (b, k, k) if batched else (k, k))
    if eta.numel() not in (1, b):
        raise ValueError(f"awp_pgd_step: eta must be scalar or ({b},)")
    eta_b = eta.reshape(-1).expand(b).contiguous()
    if variant is None:
        variant = awp_pgd_tiles(b, m, k, _sms(w.device))[2]
    elif variant not in range(len(AWP_PGD_TILES)):
        raise ValueError(f"awp_pgd_step: no tile variant {variant}")
    z = torch.empty_like(w)
    partials = torch.empty(awp_pgd_grid(b, m, k, variant),
                           dtype=torch.float32, device=w.device)
    vec = awp_pgd_vector_copies(k, w, theta, c, z)
    _launch("awp_pgd_step_batched" if batched else "awp_pgd_step",
            "awp_pgd_step_f32", w.data_ptr(),
            theta.data_ptr(), c.data_ptr(), eta_b.data_ptr(), z.data_ptr(),
            partials.data_ptr(), b, m, k, variant, int(vec))
    norm = torch.sqrt(partials.sum(dim=(-2, -1)))
    return z, (norm if batched else norm[0])


def _rows(name: str, z):
    """(rows, d) of ``z`` (…, d): leading dims are rows. A non-contiguous
    ``z`` raises rather than being copied."""
    if z.dim() < 2:
        raise ValueError(f"{name}: z must have 2 or more dims, got {z.dim()}")
    _check(f"{name}.z", z, torch.float32, z.shape)
    return z.numel() // z.shape[-1], z.shape[-1]


# K2 forms, by the index the C entry point takes: (threads a row, 16-byte
# slots a thread, held). A held form keeps the row in registers for every
# pass and takes rows of up to 4 · slots · threads floats; the streaming
# form reads the row from L2 chunk by chunk at each pass and takes any d
# (csrc/topk_mask.cu)
TOPK_FORMS = ((64, 8, True), (256, 8, True), (512, 4, False))


def topk_row_capacity(variant: int):
    """The longest row a K2 form holds, or None (streaming: any d)."""
    threads, slots, held = TOPK_FORMS[variant]
    return 4 * slots * threads if held else None


def topk_row_variant_name(variant: int) -> str:
    threads, slots, held = TOPK_FORMS[variant]
    return f"{'held' if held else 'streaming'} {threads}x{slots}"


def topk_row_variants(d: int):
    """The K2 forms that can run rows of d: every held form that holds d,
    and the streaming form."""
    return tuple(v for v in range(len(TOPK_FORMS))
                 if topk_row_capacity(v) is None or topk_row_capacity(v) >= d)


def topk_row_variant(rows: int, d: int, sms: int = H100_SMS) -> int:
    """The K2 form for ``rows`` rows of d on a card with ``sms`` SMs: the
    held form with the least capacity that holds d, else the streaming
    form. Neither the row count nor the SM count moves the pick on an
    H100: the 64-thread form beat the 256-thread one at d = 2048 at every
    census row count (``chip_smoke.py``'s ``[K2 census]`` lines); a row
    longer than 8192 fits no held form."""
    held = [v for v in topk_row_variants(d) if TOPK_FORMS[v][2]]
    if not held:
        return len(TOPK_FORMS) - 1
    return min(held, key=topk_row_capacity)


def topk_row_vector_copies(d: int, *tensors: torch.Tensor) -> bool:
    """True when K2 can copy 16 bytes at a time: d % 4 == 0 and every
    operand 16-byte aligned; else it runs its scalar-copy instantiation."""
    return d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def topk_row(z, k: int, variant=None):
    """K2: keep the k largest |z| of each row (exactly k, lower index wins
    ties; NaN ranks above inf and is never kept), zero the rest. z: (…, d)
    f32, contiguous; leading dims are rows (a (B, M, d) stack runs as B·M
    rows in one launch). The form is :func:`topk_row_variant`'s unless
    ``variant`` names one of :func:`topk_row_variants`; a launch counts in
    ``K2_CENSUS``."""
    if not _on_card("topk_row", z):
        return ref.topk_row(z, k)
    rows, d = _rows("topk_row", z)
    if k >= d:
        return z
    if k <= 0:
        return torch.zeros_like(z)
    if variant is None:
        variant = topk_row_variant(rows, d, _sms(z.device))
    elif variant not in topk_row_variants(d):
        raise ValueError(f"topk_row: no variant {variant} for rows of {d}")
    out = torch.empty_like(z)
    vec = topk_row_vector_copies(d, z, out)
    _launch("topk_row", "topk_row_f32", z.data_ptr(), out.data_ptr(), rows,
            d, k, variant, int(vec))
    key = (rows, d, k, variant)
    K2_CENSUS[key] = K2_CENSUS.get(key, 0) + 1
    return out


def quant_project(z, bits: int, group_size: int = 128):
    """K3: group-wise asymmetric INT-``bits`` quantize-dequantize of z
    (…, d) f32, contiguous, with groups of ``group_size`` along d; leading
    dims are rows."""
    if not _on_card("quant_project", z):
        return ref.quant_project(z, bits, group_size)
    rows, d = _rows("quant_project", z)
    if d % group_size or not 1 <= bits <= 16:
        raise ValueError(f"quant_project: d={d}, group={group_size}, "
                         f"bits={bits} not supported")
    out = torch.empty_like(z)
    _launch("quant_project", "quant_project_f32", z.data_ptr(),
            out.data_ptr(), rows, d, group_size, bits)
    return out


# K4 variants, by the index the C entry point takes: first the tile's
# (rows, columns) of a block's output tile, then the GEMV (M <= GEMV_MAX_M)
# with K split over a thread-block cluster of that many blocks, then the
# expert GEMV (``GEMVX``: a persistent block an SM, a warp's 64 columns
# over all of K)
# (csrc/dequant_matmul.cu)
DEQUANT_TILES = ((128, 128), (64, 128), (64, 64), (32, 32))
DEQUANT_SPLITS = (1, 2, 4, 8)
GEMV_MAX_M = 8
GEMV_COLS = 64          # output columns of a GEMV block
GEMVX_COLS = 64         # output columns of a GEMVX task, a warp's
GEMVX = len(DEQUANT_TILES) + len(DEQUANT_SPLITS)
GEMVX_WARPS = 8         # warps (tasks a round) of a GEMVX block
# a tile variant's time on the busiest SM: TILE_COST (one block alone on
# an SM, relative to variant 0's) × (1 + TILE_SHARE × (blocks there − 1)),
# fitted to every variant's time at the serving paths' shapes on an H100
# (a 32 × 32 block has 2 warps, so a few share an SM almost for free)
TILE_COST = (1.0, 0.58, 0.40, 0.27)
TILE_SHARE = (0.85, 0.85, 0.85, 0.3)


def dequant_matmul_variant_name(variant: int) -> str:
    if variant < len(DEQUANT_TILES):
        return "tile %dx%d" % DEQUANT_TILES[variant]
    if variant == GEMVX:
        return "gemvx"
    return "gemv split %d" % DEQUANT_SPLITS[variant - len(DEQUANT_TILES)]


def dequant_matmul_variants(m: int, k: int, vec: bool = True):
    """The variants K4 can run for M rows and K: every tile, and at M <=
    GEMV_MAX_M with vector copies the GEMV at every split that divides K
    into whole 32-code chunks, and GEMVX."""
    tiles = tuple(range(len(DEQUANT_TILES)))
    if not (1 <= m <= GEMV_MAX_M and vec):
        return tiles
    return tiles + tuple(len(DEQUANT_TILES) + i
                         for i, s in enumerate(DEQUANT_SPLITS)
                         if k % (32 * s) == 0) + (GEMVX,)


def gemvx_tasks(e: int, n: int, shared: bool, sms: int = H100_SMS):
    """GEMVX's work as the kernel walks it (``GxPlan``): for each of its
    persistent blocks (one an SM, no more than there are units) the
    rounds, each a list of (warp, expert, first column) tasks. A task is
    64 columns of one expert over all of K, a warp's. With shared x the
    units are the tasks, flattened expert-major, and block b takes
    [U·b / B, U·(b + 1) / B) of them in rounds of ``GEMVX_WARPS`` from its
    first; with per-expert x they are rounds, ⌈⌈N/64⌉ / GEMVX_WARPS⌉ an
    expert, so a round's warps read one x. Warp w takes task w of a
    round."""
    t = -(-n // GEMVX_COLS)
    per_e = -(-t // GEMVX_WARPS)
    units = e * t if shared else e * per_e
    blocks = min(units, sms)
    out = []
    for b in range(blocks):
        u0, u1 = units * b // blocks, units * (b + 1) // blocks
        rounds = -(-(u1 - u0) // GEMVX_WARPS) if shared else u1 - u0
        block = []
        for i in range(rounds):
            if shared:
                tasks = range(u0 + GEMVX_WARPS * i,
                              min(u0 + GEMVX_WARPS * (i + 1), u1))
            else:
                r = u0 + i
                first = r % per_e * GEMVX_WARPS
                tasks = range(r // per_e * t + first,
                              r // per_e * t + min(first + GEMVX_WARPS, t))
            block.append([(w, task // t, task % t * GEMVX_COLS)
                          for w, task in enumerate(tasks)])
        out.append(block)
    return out


def dequant_matmul_tiles(m: int, n: int, k: int, vec: bool = True,
                         sms: int = H100_SMS, experts: int = 1) -> int:
    """The variant K4 runs for an (M, N, K) product on a card with ``sms``
    SMs, and K4x for ``experts`` such products in one launch (its grid is
    the experts times one product's). M <= GEMV_MAX_M with vector copies:
    the GEMV, at the least split that gives a block to every SM, within
    what K allows (whole 32-code chunks, 256 codes a block or more).
    Otherwise the tile variant with the least time on the busiest
    SM, which holds b = ⌈blocks / sms⌉ blocks: ``TILE_COST`` × (1 +
    ``TILE_SHARE`` × (b − 1)); a tie keeps the larger tile. A stack of
    experts whose 64-column tasks give every warp of a GEMVX block on every
    SM one or more (E·⌈N/64⌉ >= 8·sms: qwen3-moe's 128 experts) takes
    GEMVX; one expert (K4) never does."""
    if (experts > 1 and 1 <= m <= GEMV_MAX_M and vec
            and experts * -(-n // GEMVX_COLS) >= GEMVX_WARPS * sms):
        return GEMVX
    if 1 <= m <= GEMV_MAX_M and vec:
        cols = experts * -(-n // GEMV_COLS)
        best = 0
        for i, s in enumerate(DEQUANT_SPLITS):
            if k % (32 * s) or k // s < 256:
                break
            best = i
            if cols * s >= sms:
                break
        return len(DEQUANT_TILES) + best

    def busiest(v):
        bm, bn = DEQUANT_TILES[v]
        b = -(-(experts * -(-m // bm) * -(-n // bn)) // sms)
        return TILE_COST[v] * (1 + TILE_SHARE[v] * (b - 1))
    return min(range(len(DEQUANT_TILES)), key=busiest)


def dequant_matmul_grid(m: int, n: int, variant: int):
    """(tiles_m, tiles_n) of a tile variant's grid, (column blocks, split)
    of a GEMV variant's, or (column tasks an expert, 1) of GEMVX's (its
    grid is :func:`gemvx_tasks`'s blocks)."""
    if variant < len(DEQUANT_TILES):
        bm, bn = DEQUANT_TILES[variant]
        return -(-m // bm), -(-n // bn)
    if variant == GEMVX:
        return -(-n // GEMVX_COLS), 1
    return -(-n // GEMV_COLS), DEQUANT_SPLITS[variant - len(DEQUANT_TILES)]


def dequant_matmul_vector_copies(k: int, n: int, group: int,
                                 *tensors: torch.Tensor) -> bool:
    """True when K4 can copy 16 bytes at a time: K and the group multiples
    of 32 (a 16-byte copy is 32 codes of one group), N % 4 == 0 (float4
    stores) and every operand 16-byte aligned; else the tile's scalar-copy
    instantiation runs (same tiles and sum order; no GEMV)."""
    return (k % 32 == 0 and group % 32 == 0 and n % 4 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def dequant_matmul(x, packed, scale, zero, group_size: int = 128,
                   variant=None):
    """K4: y (M, N) = x (M, K) · dequant(W)ᵀ for nibble-packed W (N, K/2)
    uint8 (low nibble = even k) with scale, zero (N, K/group) f32. The
    variant is :func:`dequant_matmul_tiles`'s unless ``variant`` names one
    of :func:`dequant_matmul_variants`; a launch counts in ``K4_CENSUS``."""
    if not _on_card("dequant_matmul", x, packed, scale, zero):
        return ref.dequant_matmul(x, packed, scale, zero, group_size)
    if x.dim() != 2 or packed.dim() != 2:
        raise ValueError("dequant_matmul: x and packed must be 2-D")
    m, k = x.shape
    n = packed.shape[0]
    if k % 2 or k % group_size:
        raise ValueError(f"dequant_matmul: K={k} must be even and a multiple "
                         f"of group {group_size}")
    _check("dequant_matmul.x", x, torch.float32, (m, k))
    _check("dequant_matmul.packed", packed, torch.uint8, (n, k // 2))
    _check("dequant_matmul.scale", scale, torch.float32, (n, k // group_size))
    _check("dequant_matmul.zero", zero, torch.float32, (n, k // group_size))
    vec = dequant_matmul_vector_copies(k, n, group_size, x, packed)
    if variant is None:
        variant = dequant_matmul_tiles(m, n, k, vec, _sms(x.device))
    elif variant not in dequant_matmul_variants(m, k, vec):
        raise ValueError(f"dequant_matmul: no variant {variant} at M={m}, "
                         f"K={k}{'' if vec else ' with scalar copies'}")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _launch("dequant_matmul", "dequant_matmul_f32", x.data_ptr(),
            packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
            y.data_ptr(), m, n, k, group_size, variant, int(vec))
    key = (m, n, k, variant)
    K4_CENSUS[key] = K4_CENSUS.get(key, 0) + 1
    return y


def dequant_matmul_experts(x, packed, scale, zero, group_size: int = 128,
                           per_expert: bool = False, variant=None):
    """K4x: K4 over a stack of E experts in one launch. packed (E, N, K/2)
    uint8, scale and zero (E, N, K/group) f32, contiguous; x (M, K) f32
    shared by every expert, or with ``per_expert`` (E, M, K) f32 at any
    row and expert stride (the MoE down projection's transposed view of
    its (M, E, K) activations is read as it is, not copied); the last dim
    of x contiguous. Returns y (M, E, N) shared and (E, M, N) per expert,
    the reference's layouts, written by the kernel. The variant is
    :func:`dequant_matmul_tiles`'s for E products unless ``variant`` names
    one of :func:`dequant_matmul_variants`; a launch counts in
    ``K4X_CENSUS``."""
    if not _on_card("dequant_matmul_experts", x, packed, scale, zero):
        return ref.dequant_matmul_experts(x, packed, scale, zero, group_size,
                                          per_expert)
    if packed.dim() != 3 or x.dim() != (3 if per_expert else 2):
        raise ValueError("dequant_matmul_experts: packed must be (E, N, K/2),"
                         " x (E, M, K) per expert or (M, K) shared")
    e, n, half = packed.shape
    k = 2 * half
    m = x.shape[-2]
    if k % group_size:
        raise ValueError(f"dequant_matmul_experts: K={k} must be a multiple "
                         f"of group {group_size}")
    if x.dtype != torch.float32 or x.shape[-1] != k or (
            per_expert and x.shape[0] != e):
        raise ValueError(f"dequant_matmul_experts: x {x.dtype} "
                         f"{tuple(x.shape)} against packed {tuple(packed.shape)}")
    if x.stride(-1) != 1 and k > 1:
        raise ValueError("dequant_matmul_experts: x's last dim must be "
                         "contiguous")
    _check("dequant_matmul_experts.packed", packed, torch.uint8, (e, n, half))
    g = k // group_size
    _check("dequant_matmul_experts.scale", scale, torch.float32, (e, n, g))
    _check("dequant_matmul_experts.zero", zero, torch.float32, (e, n, g))
    ldx, sx = x.stride(-2), (x.stride(0) if per_expert else 0)
    if per_expert:
        y = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
        ldy, sy = n, m * n
    else:
        y = torch.empty((m, e, n), dtype=torch.float32, device=x.device)
        ldy, sy = e * n, n
    vec = (dequant_matmul_vector_copies(k, n, group_size, x, packed)
           and ldx % 4 == 0 and sx % 4 == 0)
    if variant is None:
        variant = dequant_matmul_tiles(m, n, k, vec, _sms(x.device), e)
    elif variant not in dequant_matmul_variants(m, k, vec):
        raise ValueError(f"dequant_matmul_experts: no variant {variant} at "
                         f"M={m}, K={k}{'' if vec else ' with scalar copies'}")
    if y.numel():
        _launch("dequant_matmul_experts", "dequant_matmul_experts_f32",
                x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                zero.data_ptr(), y.data_ptr(), e, m, n, k, group_size, ldx,
                sx, ldy, sy, variant, int(vec))
        key = (e, m, n, k, variant, bool(per_expert))
        K4X_CENSUS[key] = K4X_CENSUS.get(key, 0) + 1
    return y


def kv_dequant(codes, scale, zero, group_size: int):
    """K5: (R, K) uint8 codes + per-group (R, K/g) f16 scale and zero →
    (R, K) f32 ``(code − zero)·scale``, bit-exact with its plain version."""
    if not _on_card("kv_dequant", codes, scale, zero):
        return ref.kv_dequant(codes, scale, zero, group_size)
    if codes.dim() != 2:
        raise ValueError(f"kv_dequant: codes must be 2-D, got {codes.dim()}")
    r, k = codes.shape
    if group_size <= 0 or k % group_size or group_size % 4:
        raise ValueError(f"kv_dequant: K={k}, group={group_size}: need a "
                         f"group that divides K and is a multiple of 4")
    _check("kv_dequant.codes", codes, torch.uint8, (r, k))
    _check("kv_dequant.scale", scale, torch.float16, (r, k // group_size))
    _check("kv_dequant.zero", zero, torch.float16, (r, k // group_size))
    if codes.data_ptr() % 4:
        raise ValueError("kv_dequant: codes must be 4-byte aligned")
    out = torch.empty((r, k), dtype=torch.float32, device=codes.device)
    if out.numel():
        _launch("kv_dequant", "kv_dequant_u8", codes.data_ptr(),
                scale.data_ptr(), zero.data_ptr(), out.data_ptr(), r, k,
                group_size)
    return out


_KV_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
# (head, 4-dim) accumulators a lane of K6/K6p's wider generic form
DECODE_MAX_ACCUMULATORS = 32


def decode_attn_supported(g: int, d: int) -> bool:
    """True when K6/K6p take g query heads a KV head at head dim d: d % 4
    == 0, g <= 32, and the generic form's P·V plan (csrc/decode_attn.cu,
    ``layout``) fits the 32 accumulators a lane of its wider instantiation
    (16 in the other, which takes every plan that fits it): with nl =
    min(32, d/4 rounded up to a power of two) dim lanes of 4 dims each, a
    lane holds ⌈d/4 / nl⌉ dim quads of ⌈g / (32 / nl)⌉ heads. So g·D up
    to 4096 at D = 64 or 128 (qwen3-moe: g = 16, D = 128), 3072 at D = 192
    (nemotron-4-340b: g = 12), 2048 at D = 256 — every head shape of the
    JAX package's arch configs."""
    if d % 4 or d < 4 or not 1 <= g <= 32:
        return False
    d4 = d // 4
    nl = 32 if d4 >= 32 else 1 << (d4 - 1).bit_length()
    return -(-d4 // nl) * -(-g // (32 // nl)) <= DECODE_MAX_ACCUMULATORS


def _decode_checks(name, q, k, v, lengths, planes, group_size, rows):
    """Checks shared by K6 and K6p: q (B, H, D) f32, k/v (rows, T, Hk, D)
    of one kind — f32, bf16, or uint8 with four f16 (rows, T, Hk, D/g)
    planes — and lengths (B,) int32. Returns (kind, plane pointers)."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"{name}: q must be (B, H, D), k/v 4-D")
    b, h, d = q.shape
    hk = k.shape[2]
    if k.shape[3] != d or h % hk:
        raise ValueError(f"{name}: q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)}")
    g = h // hk
    if not decode_attn_supported(g, d):
        raise ValueError(f"{name}: D={d}, {g} query heads per KV head "
                         f"not supported (D % 4 == 0, g <= 32, and a lane's "
                         f"P·V outputs within {DECODE_MAX_ACCUMULATORS} "
                         f"(4-dim, head) quads)")
    _check(f"{name}.q", q, torch.float32, (b, h, d))
    _check(f"{name}.lengths", lengths, torch.int32, (b,))
    quant = bool(planes)
    kind = _KV_KINDS.get(k.dtype)
    if kind is None or (kind == 2) != quant:
        raise TypeError(f"{name}: k/v {k.dtype} "
                        f"{'with' if quant else 'without'} scale planes")
    shape = (rows,) + tuple(k.shape[1:])
    _check(f"{name}.k", k, k.dtype, shape)
    _check(f"{name}.v", v, k.dtype, shape)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: k/v must be 16-byte aligned")
    ptrs = [0] * 4
    if quant:
        if group_size <= 0 or d % group_size or group_size % 4:
            raise ValueError(f"{name}: group {group_size} for D={d}")
        for i, (pname, pl) in enumerate(zip(
                ("k_scale", "k_zero", "v_scale", "v_zero"), planes)):
            _check(f"{name}.{pname}", pl, torch.float16,
                   shape[:3] + (d // group_size,))
            ptrs[i] = pl.data_ptr()
    return kind, ptrs


# K6/K6p's split plan: at most DECODE_MAX_SPLITS chunks a row, and no
# more than it takes to give every SM DECODE_BLOCKS_PER_SM blocks
DECODE_MAX_SPLITS = 64
DECODE_BLOCKS_PER_SM = 4


def decode_attn_splits(b: int, hk: int, t: int, block_t: int = 256,
                       sms: int = H100_SMS):
    """(chunk, splits) of K6/K6p over rows of ``t`` cache positions (K6p:
    n_pages·page) for ``b`` rows and ``hk`` KV heads, from these host-known
    sizes only (never the lengths): split s covers tokens
    [s·chunk, (s + 1)·chunk) ∩ [0, t), one block each per (row, KV head).
    The chunk is ``block_t`` (at most t), grown by whole multiples until
    there are at most ``DECODE_MAX_SPLITS`` splits and at most the splits
    that give ``sms`` SMs ``DECODE_BLOCKS_PER_SM`` blocks each. So the
    engines' shape (8 rows, 8 KV heads, t = 2048) runs 8 splits of 256
    tokens: 512 blocks on 132 SMs. (splits − 1)·chunk < max(t, 1), so no
    split starts past t."""
    base = max(1, min(block_t, t))
    cap = max(1, min(DECODE_MAX_SPLITS,
                     -(-DECODE_BLOCKS_PER_SM * sms // max(1, b * hk))))
    chunk = base * max(1, -(-(-(-t // base)) // cap))
    return chunk, max(1, -(-t // chunk))


def _k6_workspace(q, b, hk, splits):
    """The merge pass's partials (m, l, acc a split) when the plan splits,
    else None."""
    if splits == 1:
        return None
    g, d = q.shape[1] // hk, q.shape[2]
    return torch.empty(b * hk * splits * (2 * g + g * d),
                       dtype=torch.float32, device=q.device)


def _k6_record(kernel, lengths, table=None, **shape):
    if _K6_ARMED:
        # lint: allow[graph-leak] a census armed only around engine runs, which build no graph
        K6_CENSUS.append(dict(shape, kernel=kernel, lengths=lengths.clone(),
                              table=None if table is None else table.clone()))


def decode_attn(q, k, v, lengths, k_scale=None, k_zero=None, v_scale=None,
                v_zero=None, group_size: int = 0, block_t: int = 256):
    """K6: one-token GQA decode attention over a slot cache. q (B, H, D)
    f32; k/v (B, T, Hk, D) f32 or bf16, or uint8 codes with (B, T, Hk, D/g)
    f16 ``*_scale``/``*_zero`` planes (dequantized by the kernel); lengths
    (B,) int32 on the device — row b attends [0, lengths[b]), clamped to
    T. Each row is split over its tokens by :func:`decode_attn_splits`
    (chunks of ``block_t``, grown for long T), each split an online softmax,
    and the splits merged in split order (one launch count; a merge pass
    runs when there is more than one split). A row of length 0 gives exact
    zeros; a NaN row propagates. Returns (B, H, D) f32."""
    quant = k_scale is not None
    planes = (k_scale, k_zero, v_scale, v_zero) if quant else ()
    if not _on_card("decode_attn", q, k, v, lengths, *planes):
        return ref.decode_attn(q, k, v, lengths, k_scale, k_zero, v_scale,
                               v_zero, group_size, block_t)
    b = q.shape[0] if q.dim() == 3 else -1
    kind, ptrs = _decode_checks("decode_attn", q, k, v, lengths, planes,
                                group_size, b)
    _, h, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    chunk, splits = decode_attn_splits(b, hk, t, block_t, _sms(q.device))
    ws = _k6_workspace(q, b, hk, splits)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    _launch("decode_attn", "decode_attn", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), lengths.data_ptr(), *ptrs, out.data_ptr(),
            0 if ws is None else ws.data_ptr(), b, t, h, hk, d,
            group_size if quant else 0, chunk, splits, kind)
    _k6_record("decode_attn", lengths, b=b, t=t, h=h, hk=hk, d=d,
               group=group_size if quant else 0, block_t=block_t)
    return out


def decode_attn_paged(q, k_pool, v_pool, table, lengths, k_scale=None,
                      k_zero=None, v_scale=None, v_zero=None,
                      group_size: int = 0, block_t: int = 256):
    """K6p: :func:`decode_attn` over one layer's page pools (P, page, Hk,
    D) — f32, bf16, or uint8 codes with (P, page, Hk, D/g) f16 planes —
    through a block table (B, n_pages) int32 in device memory: position t
    of row b is page ``table[b, t // page]`` (clipped to [0, P − 1]; the
    sentinel P is never read), offset ``t % page``. Row b attends
    [0, min(lengths[b], n_pages·page)), split as K6 splits rows of
    n_pages·page positions, so the two give the same bits on the same
    tokens. Returns (B, H, D) f32."""
    quant = k_scale is not None
    planes = (k_scale, k_zero, v_scale, v_zero) if quant else ()
    if not _on_card("decode_attn_paged", q, k_pool, v_pool, table, lengths,
                    *planes):
        return ref.decode_attn_paged(q, k_pool, v_pool, table, lengths,
                                     k_scale, k_zero, v_scale, v_zero,
                                     group_size, block_t)
    if table.dim() != 2 or k_pool.dim() != 4:
        raise ValueError("decode_attn_paged: table must be (B, n_pages), "
                         "k/v pools (P, page, Hk, D)")
    kind, ptrs = _decode_checks("decode_attn_paged", q, k_pool, v_pool,
                                lengths, planes, group_size, k_pool.shape[0])
    b, h, d = q.shape
    p_num, page, hk = k_pool.shape[:3]
    npg = table.shape[1]
    _check("decode_attn_paged.table", table, torch.int32, (b, npg))
    if p_num < 1 or npg < 1:
        raise ValueError(f"decode_attn_paged: {p_num} pages, {npg} table "
                         f"columns")
    chunk, splits = decode_attn_splits(b, hk, npg * page, block_t,
                                       _sms(q.device))
    ws = _k6_workspace(q, b, hk, splits)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    _launch("decode_attn_paged", "decode_attn_paged", q.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), *ptrs, out.data_ptr(),
            0 if ws is None else ws.data_ptr(), b, p_num, page, npg, h, hk,
            d, group_size if quant else 0, chunk, splits, kind)
    _k6_record("decode_attn_paged", lengths, table, b=b, t=npg * page, h=h,
               hk=hk, d=d, group=group_size if quant else 0,
               block_t=block_t, pool=p_num, page=page)
    return out


def awp_prune_fused(w, c, k: int, eta, iters: int, theta0=None,
                    use_pallas: bool = True):
    """The whole AWP pruning loop on the kernels (the reference's
    ``kernels/ops.py::awp_prune_fused``, its ``lax.scan`` as a loop): each
    iteration K1's step Z = Θ + η (W − Θ) C, then K2's row top-k of Z;
    ``iters`` iterations from ``theta0`` (default W itself). A CPU tensor
    takes the plain versions, as every wrapper does; ``use_pallas=False``
    takes them on any device."""
    step, topk = ((awp_pgd_step, topk_row) if use_pallas
                  else (ref.awp_pgd_step, ref.topk_row))
    theta = w if theta0 is None else theta0
    for _ in range(iters):
        z, _ = step(w, theta, c, eta)
        theta = topk(z, k)
    return theta


__all__ = ["AWP_PGD_TILES", "DECODE_BLOCKS_PER_SM", "DECODE_MAX_ACCUMULATORS",
           "DECODE_MAX_SPLITS",
           "DEQUANT_SPLITS", "DEQUANT_TILES", "GEMV_COLS", "GEMV_MAX_M",
           "GEMVX", "GEMVX_COLS", "GEMVX_WARPS",
           "K2_CENSUS", "K4_CENSUS", "K4X_CENSUS", "K6_CENSUS", "KERNELS", "LAUNCHES",
           "TILE_COST", "TILE_SHARE", "TOPK_FORMS", "arm_k6_census",
           "awp_pgd_grid", "awp_pgd_step", "awp_pgd_tiles",
           "awp_prune_fused",
           "awp_pgd_vector_copies", "decode_attn", "decode_attn_paged",
           "decode_attn_splits", "decode_attn_supported", "dequant_matmul",
           "dequant_matmul_experts",
           "dequant_matmul_grid", "dequant_matmul_tiles",
           "dequant_matmul_variant_name", "dequant_matmul_variants",
           "dequant_matmul_vector_copies", "gemvx_tasks", "kv_dequant",
           "quant_project",
           "reset_launches", "topk_row", "topk_row_capacity",
           "topk_row_variant", "topk_row_variant_name", "topk_row_variants",
           "topk_row_vector_copies"]
