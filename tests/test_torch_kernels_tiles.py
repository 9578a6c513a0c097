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
