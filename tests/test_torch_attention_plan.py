"""The plan of the attention block's forward kernel (``forward_plan``), on
the CPU.

``csrc/attention_block.cu`` walks tiles of ``samples`` samples (their
rows padded to a multiple of 16), a block taking tiles blockIdx.x,
blockIdx.x + grid, ... ; the grid is a block a tile, at most
``blocks_per_sm`` an SM. The plan takes two blocks an SM where they hold as
many core warps as one block, else one; its shared memory must fit the
block's share of an SM. The launch recomputes the plan and refuses a
mismatch; the compiled kernel's blocks an SM are held to the plan's on the
card by chip_smoke.py.
"""

import pytest

from deepfm_tpu_torch.ops.kernels.attention import (
    SMEM_PER_BLOCK,
    SMEM_PER_SM,
    SMEM_RESERVED,
    ForwardPlan,
    forward_plan,
    plan,
)

BENCH = dict(d=16, a=64, num_heads=4)
SMS = 132  # an H100 SXM


def test_bench_plan():
    """bench.py's AttentionDeepFM shape: two samples (54 rows, padded to
    64) a tile, all 8 warps in the core, two blocks an SM."""
    fp = forward_plan(27, **BENCH)
    assert fp == ForwardPlan(samples=2, core_warps=8, rows=64, smem=115_168,
                             blocks_per_sm=2)
    assert plan(27, 16, 64, 4, backward=False) == fp.smem
    assert fp.grid(16384, SMS) == 264 and fp.grid(1, SMS) == 1


def test_every_field_count_fits_or_is_refused():
    """F from 1 to 64 at bench.py's widths: a plan within a block's share of
    an SM's shared memory, with the core warps and rows it names, or a
    ValueError that says why."""
    for f in range(1, 65):
        try:
            fp = forward_plan(f, **BENCH)
        except ValueError as err:
            assert "shared memory" in str(err), f
            continue
        share = min(SMEM_PER_BLOCK,
                    SMEM_PER_SM // fp.blocks_per_sm - SMEM_RESERVED)
        assert fp.smem <= share <= SMEM_PER_BLOCK, f
        assert fp.blocks_per_sm in (1, 2), f
        assert 1 <= fp.core_warps <= min(8, fp.samples * 4), f
        assert 1 <= fp.samples <= 8, f
        assert fp.rows == -(-fp.samples * f // 16) * 16, f


def test_refuses_a_shape_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        forward_plan(200, **BENCH)


@pytest.mark.parametrize("f", [27, 33, 5])
def test_tiles_cover_each_sample_once(f):
    """The kernel's walk over tiles at B = 1, 3, 1000 and 16384: every
    sample in exactly one tile of one block, a tile's valid rows within
    its padded rows, no block without a tile."""
    fp = forward_plan(f, **BENCH)
    for bsz in (1, 3, 1000, 16384):
        grid = fp.grid(bsz, SMS)
        assert 1 <= grid <= min(fp.tiles(bsz), fp.blocks_per_sm * SMS)
        seen = [0] * bsz
        for block in range(grid):
            tiles = range(block, fp.tiles(bsz), grid)
            assert len(tiles) >= 1
            for tile in tiles:
                b0 = tile * fp.samples
                sv = min(fp.samples, bsz - b0)
                assert 1 <= sv and sv * f <= fp.rows
                for b in range(b0, b0 + sv):
                    seen[b] += 1
        assert seen == [1] * bsz, bsz
