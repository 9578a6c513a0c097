"""The tile choice of K1/K1b (``kernels.ops.awp_pgd_tiles``) and the shapes
the wrapper derives from it, in plain Python: the variant and the shape of
the per-tile norm partials at the main paths' shapes and at the card tests'
small shapes, that every variant's grid covers M and K, and when the kernel
takes its scalar-copy instantiation. No card needed."""
import pytest
import torch

from repro_torch.kernels import ops

# (B, M, K) -> the variant picked on a 132-SM H100: the eight shapes of the
# compression paths (K1: wq/wo, wk/wv, wg/wu, wd; K1b: {wk, wv}, B = 3,
# {wg, wu}, {wq, wo}) and the small shapes of tests/test_torch_gpu.py
PICKS = {
    (1, 2048, 2048): 0, (1, 512, 2048): 1, (1, 8192, 2048): 0,
    (1, 2048, 8192): 0, (2, 512, 2048): 0, (3, 512, 2048): 1,
    (2, 8192, 2048): 0, (2, 2048, 2048): 0,
    (1, 128, 128): 1, (1, 200, 136): 1, (1, 64, 300): 1, (3, 96, 160): 1,
    (2, 96, 160): 1, (2, 70, 150): 1, (4, 96, 256): 1,
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: more gain them
    nothing, and under pytest-xdist their spin-waits take the cores from
    the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", sorted(PICKS))
def test_awp_pgd_tiles_pick_and_partials(shape):
    b, m, k = shape
    bm, bn, variant = ops.awp_pgd_tiles(b, m, k)
    assert variant == PICKS[shape]
    assert (bm, bn) == ops.AWP_PGD_TILES[variant]
    assert ops.awp_pgd_grid(b, m, k, variant) == (b, -(-m // bm),
                                                  -(-k // bn))


def test_awp_pgd_tiles_by_busiest_sm():
    """Variant 1 exactly when its busiest SM has less work, a 64 × 128
    block counting 0.575 of a 128 × 128 one; the SM count moves the pick
    (M = 512, B = 2: variant 1 puts 2 blocks on the busiest of 132 SMs
    against variant 0's 1, and 1 against 1 on 256 SMs)."""
    assert ops.awp_pgd_tiles(2, 512, 2048)[2] == 0
    assert ops.awp_pgd_tiles(2, 512, 2048, sms=256)[2] == 1
    for b, m, k in [(1, 512, 2048), (2, 512, 2048), (3, 512, 2048),
                    (1, 1024, 2048), (1, 1536, 2048), (4, 512, 2048)]:
        busiest = [-(-b * -(-m // bm) * -(-k // bn) // 132)
                   for bm, bn in ops.AWP_PGD_TILES]
        want = 1 if 0.575 * busiest[1] < busiest[0] else 0
        assert ops.awp_pgd_tiles(b, m, k)[2] == want


@pytest.mark.parametrize("variant", range(len(ops.AWP_PGD_TILES)))
@pytest.mark.parametrize("m,k", [(1, 1), (127, 129), (128, 128), (129, 4),
                                 (512, 2048), (2048, 8192), (8193, 2050)])
def test_awp_pgd_grid_covers_m_and_k(variant, m, k):
    bm, bn = ops.AWP_PGD_TILES[variant]
    _, tm, tn = ops.awp_pgd_grid(3, m, k, variant)
    assert (tm - 1) * bm < m <= tm * bm
    assert (tn - 1) * bn < k <= tn * bn


def test_awp_pgd_vector_copies():
    buf = torch.zeros(4 * 96 * 160 + 4)
    aligned = buf[: 96 * 160].view(96, 160)
    assert aligned.data_ptr() % 16 == 0
    assert ops.awp_pgd_vector_copies(160, aligned, aligned)
    assert not ops.awp_pgd_vector_copies(150, aligned, aligned)
    # a contiguous stack slice 4 bytes past a 16-byte boundary
    shifted = buf[1: 1 + 96 * 160].view(96, 160)
    assert shifted.is_contiguous()
    assert not ops.awp_pgd_vector_copies(160, aligned, shifted)


# K4 (``kernels.ops.dequant_matmul_tiles``): the variant at the serving
# paths' (M, N, K) on a 132-SM H100 — the GEMV's split at M <= 8, the tile
# above — at the four packed linears' (N, K): wq; wk, wv; wg, wu; wd. Each
# is the variant a chip run timed fastest there
K4_PICKS = {
    (4, 2048, 2048): "gemv split 8",
    (8, 2048, 2048): "gemv split 8",
    (64, 2048, 2048): "tile 32x32",
    (128, 2048, 2048): "tile 32x32",
    (256, 2048, 2048): "tile 64x64",
    (512, 2048, 2048): "tile 64x128",
    (4096, 2048, 2048): "tile 128x128",
    (4, 512, 2048): "gemv split 8",
    (8, 512, 2048): "gemv split 8",
    (64, 512, 2048): "tile 32x32",
    (128, 512, 2048): "tile 32x32",
    (256, 512, 2048): "tile 32x32",
    (512, 512, 2048): "tile 32x32",
    (4096, 512, 2048): "tile 128x128",
    (4, 8192, 2048): "gemv split 2",
    (8, 8192, 2048): "gemv split 2",
    (64, 8192, 2048): "tile 64x64",
    (128, 8192, 2048): "tile 64x128",
    (256, 8192, 2048): "tile 128x128",
    (512, 8192, 2048): "tile 128x128",
    (4096, 8192, 2048): "tile 128x128",
    (4, 2048, 8192): "gemv split 8",
    (8, 2048, 8192): "gemv split 8",
    (64, 2048, 8192): "tile 32x32",
    (128, 2048, 8192): "tile 32x32",
    (256, 2048, 8192): "tile 64x64",
    (512, 2048, 8192): "tile 64x128",
    (4096, 2048, 8192): "tile 128x128",
}


@pytest.mark.parametrize("shape", sorted(K4_PICKS))
def test_dequant_matmul_tiles_pick(shape):
    m, n, k = shape
    assert ops.dequant_matmul_variant_name(
        ops.dequant_matmul_tiles(m, n, k)) == K4_PICKS[shape]


@pytest.mark.parametrize("n", [512, 2048, 8192])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_dequant_matmul_gemv_fills_the_card(m, n):
    """The GEMV's split gives every one of 132 SMs a block where K allows
    it (K = 2048: 256 codes a block at split 8), else the largest split."""
    v = ops.dequant_matmul_tiles(m, n, 2048)
    assert v >= len(ops.DEQUANT_TILES)
    cols, split = ops.dequant_matmul_grid(m, n, v)
    assert cols * split >= 132 or split == ops.DEQUANT_SPLITS[-1]
    smaller = [s for s in ops.DEQUANT_SPLITS if s < split]
    assert all(cols * s < 132 for s in smaller)


def test_dequant_matmul_tiles_by_busiest_sm():
    """Above GEMV_MAX_M the tile with the least time on the busiest SM
    (``TILE_COST``, ``TILE_SHARE``); fewer SMs move the pick to the largest
    tile."""
    for m, n in [(9, 512), (64, 2048), (512, 8192), (4096, 8192),
                 (1024, 512), (96, 2048)]:
        cost = [c * (1 + f * (-(-(-(-m // bm) * -(-n // bn)) // 132) - 1))
                for (bm, bn), c, f in zip(ops.DEQUANT_TILES, ops.TILE_COST,
                                          ops.TILE_SHARE)]
        assert ops.dequant_matmul_tiles(m, n, 2048) == cost.index(min(cost))
    assert ops.dequant_matmul_tiles(1024, 1024, 2048, sms=1) == 0


@pytest.mark.parametrize("m,n,k", [(1, 1, 32), (8, 65, 2048), (9, 63, 2048),
                                   (127, 129, 256), (128, 128, 8192),
                                   (4096, 8192, 2048), (4097, 513, 64)])
def test_dequant_matmul_grid_covers_m_and_n(m, n, k):
    for v in ops.dequant_matmul_variants(m, k):
        a, b = ops.dequant_matmul_grid(m, n, v)
        if v < len(ops.DEQUANT_TILES):
            bm, bn = ops.DEQUANT_TILES[v]
            assert (a - 1) * bm < m <= a * bm
            assert (b - 1) * bn < n <= b * bn
        else:
            assert (a - 1) * ops.GEMV_COLS < n <= a * ops.GEMV_COLS
            assert b in ops.DEQUANT_SPLITS and k % (32 * b) == 0


def test_dequant_matmul_variants():
    tiles = tuple(range(len(ops.DEQUANT_TILES)))
    gemv = tuple(len(tiles) + i for i in range(len(ops.DEQUANT_SPLITS)))
    assert ops.dequant_matmul_variants(8, 2048) == tiles + gemv + (ops.GEMVX,)
    assert ops.dequant_matmul_variants(9, 2048) == tiles
    assert ops.dequant_matmul_variants(4, 2048, vec=False) == tiles
    # splits leave whole 32-code chunks a block; GEMVX takes any such K
    assert ops.dequant_matmul_variants(1, 64) == tiles + gemv[:2] + (
        ops.GEMVX,)
    assert [ops.dequant_matmul_variant_name(v) for v in (0, 4, 7, 8)] == [
        "tile 128x128", "gemv split 1", "gemv split 8", "gemvx"]


# K4x's expert GEMV (``ops.GEMVX``): listed wherever it can run (M <= 8
# with vector copies, any K the wrapper takes), at no other M
@pytest.mark.parametrize("vec", [True, False], ids=["vec", "scalar"])
@pytest.mark.parametrize("m", [1, 2, 5, 8, 9, 64, 4096])
@pytest.mark.parametrize("k", [32, 96, 1536, 4096, 18432])
def test_gemvx_listed_only_where_it_runs(vec, m, k):
    listed = ops.GEMVX in ops.dequant_matmul_variants(m, k, vec)
    assert listed == (1 <= m <= ops.GEMV_MAX_M and vec)


# picked for qwen3-moe's decode stacks (E = 128, both forms' (N, K), M up
# to 8): 8·132 warps of 64 columns each take a task or more; one expert
# (K4) and the 8-expert stacks of the small checks keep the GEMV
@pytest.mark.parametrize("n,k", [(1536, 4096), (4096, 1536)])
@pytest.mark.parametrize("m", range(1, ops.GEMV_MAX_M + 1))
def test_dequant_matmul_tiles_picks_gemvx_at_qwen3_moe(m, n, k):
    assert ops.dequant_matmul_tiles(m, n, k, experts=128) == ops.GEMVX
    assert len(ops.DEQUANT_TILES) <= ops.dequant_matmul_tiles(
        m, n, k, experts=1) < ops.GEMVX
    assert len(ops.DEQUANT_TILES) <= ops.dequant_matmul_tiles(
        m, n, k, experts=8) < ops.GEMVX
    assert ops.dequant_matmul_tiles(m, n, k, vec=False, experts=128) < len(
        ops.DEQUANT_TILES)
    assert ops.dequant_matmul_tiles(9, n, k, experts=128) < len(
        ops.DEQUANT_TILES)


# every (M, N, K) that K4's census held on the card (the llama32-1b serving
# paths, llama2-7b's evaluation, the SSM and frontends paths) and the
# variant its picker gave it there: K4 (one expert) keeps it
K4_CENSUS_PICKS = {
    (4, 128, 896): "gemv split 2", (4, 16384, 4096): "gemv split 1",
    (4, 18432, 4608): "gemv split 1", (4, 2048, 2048): "gemv split 8",
    (4, 2048, 4096): "gemv split 8", (4, 2048, 8192): "gemv split 8",
    (4, 4096, 2048): "gemv split 4", (4, 4096, 8192): "gemv split 4",
    (4, 4608, 18432): "gemv split 2", (4, 4608, 4608): "gemv split 2",
    (4, 4864, 896): "gemv split 2", (4, 512, 2048): "gemv split 8",
    (4, 512, 4608): "gemv split 8", (4, 8192, 2048): "gemv split 2",
    (4, 896, 4864): "gemv split 8", (4, 896, 896): "gemv split 2",
    (8, 18432, 4608): "gemv split 1", (8, 2048, 2048): "gemv split 8",
    (8, 2048, 8192): "gemv split 8", (8, 4608, 18432): "gemv split 2",
    (8, 4608, 4608): "gemv split 2", (8, 512, 2048): "gemv split 8",
    (8, 512, 4608): "gemv split 8", (8, 8192, 2048): "gemv split 2",
    (64, 18432, 4608): "tile 32x32", (64, 2048, 2048): "tile 32x32",
    (64, 2048, 8192): "tile 32x32", (64, 4608, 18432): "tile 64x64",
    (64, 4608, 4608): "tile 64x64", (64, 512, 2048): "tile 32x32",
    (64, 512, 4608): "tile 32x32", (64, 8192, 2048): "tile 64x64",
    (128, 18432, 4608): "tile 64x128", (128, 2048, 2048): "tile 32x32",
    (128, 2048, 8192): "tile 32x32", (128, 4608, 18432): "tile 64x128",
    (128, 4608, 4608): "tile 64x128", (128, 512, 2048): "tile 32x32",
    (128, 512, 4608): "tile 32x32", (128, 8192, 2048): "tile 64x128",
    (256, 18432, 4608): "tile 64x128", (256, 2048, 2048): "tile 64x64",
    (256, 2048, 8192): "tile 64x64", (256, 4608, 18432): "tile 32x32",
    (256, 4608, 4608): "tile 32x32", (256, 512, 2048): "tile 32x32",
    (256, 512, 4608): "tile 32x32", (256, 8192, 2048): "tile 128x128",
    (512, 11008, 4096): "tile 128x128", (512, 1536, 1536): "tile 64x128",
    (512, 1536, 6144): "tile 64x128", (512, 16384, 4096): "tile 128x128",
    (512, 18432, 4608): "tile 128x128", (512, 2048, 2048): "tile 64x128",
    (512, 2048, 4096): "tile 64x128", (512, 2048, 8192): "tile 64x128",
    (512, 4096, 11008): "tile 128x128", (512, 4096, 2048): "tile 128x128",
    (512, 4096, 4096): "tile 128x128", (512, 4096, 8192): "tile 128x128",
    (512, 4608, 18432): "tile 64x128", (512, 4608, 4608): "tile 64x128",
    (512, 512, 2048): "tile 32x32", (512, 512, 4608): "tile 32x32",
    (512, 6144, 1536): "tile 64x128", (512, 8192, 2048): "tile 128x128",
    (1536, 128, 896): "tile 32x32", (1536, 4864, 896): "tile 64x128",
    (1536, 896, 4864): "tile 128x128", (1536, 896, 896): "tile 128x128",
}


@pytest.mark.parametrize("shape", sorted(K4_CENSUS_PICKS))
def test_k4_census_keys_keep_their_variant(shape):
    m, n, k = shape
    assert ops.dequant_matmul_variant_name(
        ops.dequant_matmul_tiles(m, n, k)) == K4_CENSUS_PICKS[shape]


def _gemvx_columns(e, n, shared):
    """Every (expert, column) GEMVX's tasks write, as its blocks walk
    them, and the rounds."""
    rounds = [rnd for block in ops.gemvx_tasks(e, n, shared)
              for rnd in block]
    cols = [(ex, c) for rnd in rounds for _, ex, n0 in rnd
            for c in range(n0, min(n0 + ops.GEMVX_COLS, n))]
    return cols, rounds


# the tasks cover every (expert, column) exactly once, at qwen3-moe's
# stacks and at ragged N and small E, in both forms; a round's warps are
# distinct, and with per-expert x they read one expert's x
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_expert"])
@pytest.mark.parametrize("e,n", [(128, 1536), (128, 4096), (1, 1), (1, 64),
                                 (2, 65), (3, 68), (4, 132), (5, 132),
                                 (7, 4100), (9, 1000), (128, 130),
                                 (1, 8192)])
def test_gemvx_tasks_cover_every_column_once(shared, e, n):
    cols, rounds = _gemvx_columns(e, n, shared)
    assert len(cols) == len(set(cols)) == e * n
    assert set(cols) == {(ex, c) for ex in range(e) for c in range(n)}
    for rnd in rounds:
        warps = [w for w, _, _ in rnd]
        assert len(set(warps)) == len(warps) <= ops.GEMVX_WARPS
        if not shared:
            assert len({ex for _, ex, _ in rnd}) == 1
    assert len(ops.gemvx_tasks(e, n, shared)) <= ops.H100_SMS


# at qwen3-moe's decode shapes the 132 persistent blocks share the work
# within one task (shared x, wg/wu) or one round (per-expert x, wd) of
# each other
@pytest.mark.parametrize("n,shared,spread", [(1536, True, 1),
                                             (4096, False, 8)])
def test_gemvx_blocks_share_the_stack_evenly(n, shared, spread):
    blocks = ops.gemvx_tasks(128, n, shared)
    assert len(blocks) == ops.H100_SMS
    tasks = [sum(len(rnd) for rnd in block) for block in blocks]
    assert max(tasks) - min(tasks) <= spread
    assert sum(tasks) == 128 * -(-n // ops.GEMVX_COLS)


def test_dequant_matmul_vector_copies():
    buf = torch.zeros(4 * 8 * 2048 + 4)
    x = buf[: 8 * 2048].view(8, 2048)
    packed = torch.zeros((512, 1024), dtype=torch.uint8)
    assert x.data_ptr() % 16 == 0 and packed.data_ptr() % 16 == 0
    assert ops.dequant_matmul_vector_copies(2048, 512, 128, x, packed)
    assert not ops.dequant_matmul_vector_copies(2048, 512, 16, x, packed)
    assert not ops.dequant_matmul_vector_copies(2064, 512, 16, x, packed)
    assert not ops.dequant_matmul_vector_copies(2048, 514, 128, x, packed)
    # a contiguous slice 4 bytes past a 16-byte boundary
    shifted = buf[1: 1 + 8 * 2048].view(8, 2048)
    assert shifted.is_contiguous()
    assert not ops.dequant_matmul_vector_copies(2048, 512, 128, shifted,
                                                packed)


# K2 (``kernels.ops.topk_row_variant``): one block a row; a held form keeps
# the row in registers and holds 4 · slots · threads floats, the streaming
# form any d. The census (rows, d) of the compression paths: {wk, wv},
# wk/wv, {wq, wo}, wq/wo, wg/wu, {wg, wu} at d_in 2048, and wd at 8192
K2_CENSUS_SHAPES = [(512, 2048), (1024, 2048), (2048, 2048), (4096, 2048),
                    (8192, 2048), (16384, 2048), (2048, 8192)]


@pytest.mark.parametrize("rows,d", K2_CENSUS_SHAPES
                         + [(r, d) for d in (1, 3, 33, 2047, 2048, 8192,
                                             73728) for r in (1, 2048)])
def test_topk_row_variant_holds_the_row(rows, d):
    v = ops.topk_row_variant(rows, d)
    assert v in ops.topk_row_variants(d)
    cap = ops.topk_row_capacity(v)
    held = ops.TOPK_FORMS[v][2]
    assert held == (cap is not None)
    # a held form whenever one holds the row; streaming only beyond them
    assert held == (d <= max(c for c in map(ops.topk_row_capacity,
                                            range(len(ops.TOPK_FORMS)))
                             if c is not None))
    assert cap is None or cap >= d


@pytest.mark.parametrize("d", [1, 3, 33, 2047, 2048, 8192])
def test_topk_row_fills_the_card_at_2048_rows(d):
    """At 2048 rows, one block a row, the picked form gives every one of
    the H100's SMs at least one warp for each of its four schedulers."""
    threads = ops.TOPK_FORMS[ops.topk_row_variant(2048, d)][0]
    assert 2048 * threads // 32 >= 4 * ops.H100_SMS


def test_topk_row_variants():
    every = tuple(range(len(ops.TOPK_FORMS)))
    stream = every[-1]
    assert ops.TOPK_FORMS[stream][2] is False
    assert ops.topk_row_variants(1) == every
    assert ops.topk_row_variants(2048) == every
    assert ops.topk_row_variants(2049) == tuple(
        v for v in every if ops.topk_row_capacity(v) is None
        or ops.topk_row_capacity(v) >= 2049)
    assert ops.topk_row_variants(73728) == (stream,)
    assert [ops.topk_row_capacity(v) for v in every] == [2048, 8192, None]
    assert ops.topk_row_variant_name(0) == "held 64x8"
    assert ops.topk_row_variant_name(stream) == "streaming 512x4"


def test_topk_row_vector_copies():
    buf = torch.zeros(4 * 2048 + 4)
    aligned = buf[: 4 * 2048].view(4, 2048)
    assert aligned.data_ptr() % 16 == 0
    assert ops.topk_row_vector_copies(2048, aligned, aligned)
    odd = buf[: 4 * 2047].view(4, 2047)
    assert not ops.topk_row_vector_copies(2047, odd, odd)
    # a contiguous view 4 bytes past a 16-byte boundary
    shifted = buf[1: 1 + 4 * 2048].view(4, 2048)
    assert shifted.is_contiguous()
    assert not ops.topk_row_vector_copies(2048, aligned, shifted)


# K6/K6p (``kernels.ops.decode_attn_splits``): each row's [0, T) cut into
# splits of ``chunk`` tokens, one block each per (row, KV head), planned
# from B, Hk, T and block_t alone. The engines' shape: 8 rows (slots), 8
# KV heads, T = 2048
K6_ENGINE = (8, 8, 2048)


@pytest.mark.parametrize("b,hk,t,block_t", [
    (8, 8, 2048, 256), (1, 8, 2048, 256), (1, 1, 2048, 256),
    (8, 8, 300, 256), (6, 2, 40, 16), (6, 2, 40, 7), (7, 2, 300, 1),
    (1, 1, 320, 1), (64, 8, 2048, 256), (8, 8, 131072, 256),
    (1, 1, 131072, 256), (1, 8, 1 << 20, 256), (3, 2, 0, 256)])
def test_decode_attn_splits_cover_the_row(b, hk, t, block_t):
    """The splits cover [0, T) and no split starts at or past T; the chunk
    is a whole multiple of block_t (or T itself, when shorter); at most
    DECODE_MAX_SPLITS splits, and no more than give every SM
    DECODE_BLOCKS_PER_SM blocks."""
    chunk, splits = ops.decode_attn_splits(b, hk, t, block_t)
    assert chunk >= 1 and splits >= 1
    assert (splits - 1) * chunk < max(t, 1) <= splits * chunk
    assert chunk % max(1, min(block_t, t)) == 0
    assert splits <= ops.DECODE_MAX_SPLITS
    assert (splits == 1 or b * hk * (splits - 1)
            < ops.DECODE_BLOCKS_PER_SM * ops.H100_SMS)


def test_decode_attn_splits_every_short_row():
    """Every T from 1 to 300 at the engines' batch and at B = 1: covered,
    with no empty tail split past T."""
    for b, hk in ((8, 8), (1, 8), (1, 1)):
        for block_t in (256, 64, 7):
            for t in range(1, 301):
                chunk, splits = ops.decode_attn_splits(b, hk, t, block_t)
                assert (splits - 1) * chunk < t <= splits * chunk, (
                    b, hk, block_t, t)


def test_decode_attn_splits_census_fills_the_card():
    """The engines' shape takes 8 splits of 256 tokens: 512 blocks, more
    than 3 for each of the H100's 132 SMs."""
    b, hk, t = K6_ENGINE
    assert ops.decode_attn_splits(b, hk, t) == (256, 8)
    assert b * hk * 8 >= 3 * ops.H100_SMS


def test_decode_attn_splits_same_for_both_layouts():
    """K6p plans rows of n_pages·page positions as K6 plans rows of T: the
    plan depends on that count, never on the page size (80 positions as
    20 pages of 4, 16 of 5, 10 of 8 and 5 of 16)."""
    want = ops.decode_attn_splits(6, 2, 80, 16)
    for page, n_pages in ((4, 20), (5, 16), (8, 10), (16, 5)):
        assert ops.decode_attn_splits(6, 2, n_pages * page, 16) == want
    b, hk, t = K6_ENGINE
    assert (ops.decode_attn_splits(b, hk, 128 * 16)
            == ops.decode_attn_splits(b, hk, t))


def test_decode_attn_splits_long_rows_stay_bounded():
    """Long rows grow the chunk, not the split count: at B = 1, Hk = 1 the
    cap is DECODE_MAX_SPLITS; at the engines' batch 9 splits already give
    each SM 4 blocks."""
    assert ops.decode_attn_splits(1, 1, 131072) == (2048, 64)
    chunk, splits = ops.decode_attn_splits(8, 8, 131072)
    assert splits == 9 and chunk % 256 == 0
    assert ops.decode_attn_splits(128, 8, 2048) == (2048, 1)


def test_decode_attn_supported_head_groups():
    """K6/K6p take every (g, D) whose P·V plan fits the wider generic
    form's 32 accumulators a lane: qwen3-moe's 16 query heads a KV head at
    D = 128, nemotron-4-340b's 12 at D = 192 (24 accumulators), the
    earlier cases and the plans that needed more than 16 (g = 30 at D =
    68, g = 8 at D = 512, g = 32 at D = 128); not a group past 32, D not a
    multiple of 4, or a plan past 32 (g = 32 at D = 192, g = 16 at D =
    512, g = 12 at D = 384)."""
    for g, d in ((16, 128), (32, 64), (8, 128), (4, 256), (32, 32), (1, 16),
                 (2, 20), (12, 64), (12, 192), (30, 68), (8, 512),
                 (32, 128)):
        assert ops.decode_attn_supported(g, d), (g, d)
    for g, d in ((33, 32), (4, 30), (32, 192), (16, 512), (12, 384)):
        assert not ops.decode_attn_supported(g, d), (g, d)
