"""The tile plan of the densify kernels (``grad.densify_plan``, read by
``csrc/densify_tile.cuh``), on the CPU: over both layouts and ragged
shapes, the blocks' tiles cover every output row exactly once, every tile
is bulk-stored in 16-byte units at 16-byte offsets but for the last
floats of the last tile, and a block's shared memory stays within
Hopper's 232,448 bytes (with BLOCKS_PER_SM blocks on one SM's 228 KB).
Then the kernel's tile schedule, emulated in numpy (tile ranges by
searchsorted, windows of staged pairs that run on across a block's tiles,
run heads, each run added in stream order into a zeroed tile, the tile's
stores), equals the plain version bit for bit, also where runs are longer
than a window."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from deepfm_tpu_torch.ops.kernels import grad
from deepfm_tpu_torch.ops.kernels.grad import densify_plan, segment_rows_plain
from deepfm_tpu_torch.ops.kernels.packed_grad import LANES, pack_rows

torch.set_num_threads(1)

SM_SHARED = 233_472  # one H100 SM's shared memory, bytes
BLOCK_RESERVED = 1024  # reserved per resident block


def _layout(dcol, pack):
    """(pack, width) of the logical (pack None) or the packed layout."""
    return (1, dcol) if pack is None else (pack, LANES)


def _check_plan(num_rows, dcol, pack, width, sms):
    plan = densify_plan(num_rows, dcol, pack, width, sms)
    assert plan.phys == -(-num_rows // pack)
    assert plan.tile_phys % 4 == 0 and plan.tile_phys >= 4
    assert plan.smem_bytes <= grad.SMEM_PER_BLOCK
    assert (grad.BLOCKS_PER_SM * (plan.smem_bytes + BLOCK_RESERVED)
            <= SM_SHARED)
    assert plan.chunk_pairs >= 1
    assert plan.grid <= grad.WAVES * grad.BLOCKS_PER_SM * sms
    if num_rows == 0:
        assert plan.tiles == 0 and plan.grid == 0
        return plan
    assert 1 <= plan.grid <= plan.tiles
    tiles = [t for b in range(plan.grid) for t in plan.block_tiles(b)]
    assert tiles == list(range(plan.tiles))  # each tile once, in order
    end = 0  # the tiles' stores, in order, tile the output's bytes
    for t in tiles:
        offset, bulk, plain = plan.tile_store(t)
        assert offset == end
        assert offset % 16 == 0 and bulk % 16 == 0
        assert 0 <= plain < 16
        if t < plan.tiles - 1:
            assert plain == 0 and bulk == 4 * plan.tile_phys * plan.width
        end = offset + bulk + plain
    assert end == 4 * plan.phys * plan.width
    # the last tile's logical rows end at num_rows
    assert (plan.tiles - 1) * plan.tile_phys * pack < num_rows
    return plan


@settings(max_examples=100, deadline=None)
@given(num_rows=st.integers(0, 3_000_000), dcol=st.integers(1, 128),
       packed=st.booleans(), sms=st.sampled_from([1, 8, 132]),
       data=st.data())
def test_plan_covers_every_row_once(num_rows, dcol, packed, sms, data):
    pack = (data.draw(st.integers(1, LANES // dcol), label="pack")
            if packed else None)
    pack, width = _layout(dcol, pack)
    _check_plan(num_rows, dcol, pack, width, sms)


@pytest.mark.parametrize("num_rows,dcol,pack", [
    (10_400_000, 17, None),  # bench.py's fused table
    (1_485_824 * 7, 17, 7),  # the same, packed
    (0, 17, None), (0, 17, 7), (1, 1, None), (3, 5, None), (257, 33, None),
    (1001, 1, None), (999, 128, 1), (1000, 1, 128), (6001, 5, 25),
    (5, 17, 7),  # the last tile ends inside a physical row
])
def test_plan_at_the_shapes_the_kernels_take(num_rows, dcol, pack):
    pack, width = _layout(dcol, pack)
    plan = _check_plan(num_rows, dcol, pack, width, 132)
    if num_rows == 10_400_000:
        assert plan.tile_phys * width * 4 <= grad.TILE_BYTES
        assert plan.grid == grad.WAVES * grad.BLOCKS_PER_SM * 132


def test_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="do not fit"):
        densify_plan(100, 20, 7, LANES)
    with pytest.raises(ValueError, match="shared memory"):
        densify_plan(100, 40_000)


def _emulate(sids, cts, num_rows, dcol, pack, plan):
    """The kernel's schedule in numpy f32 (csrc/densify_tile.cuh)."""
    out = np.full(plan.phys * plan.width, np.nan, np.float32)
    rows_per_tile = plan.tile_phys * pack

    def bound(t):
        return int(np.searchsorted(sids, min(t * rows_per_tile, num_rows)))

    for block in range(plan.grid):
        tiles = plan.block_tiles(block)
        w0 = w1 = 0  # the staged window
        for first in range(tiles.start, tiles.stop, grad.BOUND_BATCH):
            last = min(first + grad.BOUND_BATCH, tiles.stop)
            batch_end = bound(last)
            for t in range(first, last):
                buf = np.zeros(plan.tile_phys * plan.width, np.float32)
                s, s1 = bound(t), bound(t + 1)
                while s < s1:
                    if s >= w1:
                        w0, w1 = s, min(s + plan.chunk_pairs, batch_end)
                    e = min(s1, w1)
                    heads = [i for i in range(s, e)
                             if i == s or sids[i] != sids[i - 1]] + [e]
                    for a, b in zip(heads[:-1], heads[1:]):
                        r = int(sids[a]) - t * rows_per_tile
                        off = (r // pack) * plan.width + (r % pack) * dcol
                        acc = buf[off: off + dcol].copy()
                        for i in range(a, b):
                            acc = acc + cts[i]  # f32, one rounding per add
                        buf[off: off + dcol] = acc
                    s = e
                offset, bulk, plain = plan.tile_store(t)
                out[offset // 4: (offset + bulk + plain) // 4] = \
                    buf[: (bulk + plain) // 4]
    assert not np.isnan(out).any()
    return out.reshape(plan.phys, plan.width)


@pytest.mark.parametrize("num_rows,dcol,pack,n,vocab", [
    (1000, 17, None, 3000, 1000),
    (257, 5, None, 37, 300),  # ids past the table
    (3001, 1, None, 2000, 3),  # runs longer than a window
    (1001, 33, None, 0, 1),  # no pairs: all zeros
    (6000, 17, 7, 4000, 6000),
    (600, 1, 128, 2000, 5),  # pack 128: one column a row
    (300, 128, 1, 500, 400),  # pack 1, a whole 128-float row
    (233, 5, 25, 400, 240),  # the last tile ends inside a physical row
])
def test_emulated_tile_schedule_equals_plain(monkeypatch, num_rows, dcol,
                                             pack, n, vocab):
    # small tiles, windows and bound batches, so a table has many tiles, a
    # run spans several windows and a block several batches
    monkeypatch.setattr(grad, "TILE_BYTES", 2048)
    monkeypatch.setattr(grad, "CHUNK_BYTES", 256)
    monkeypatch.setattr(grad, "BOUND_BATCH", 3)
    rng = np.random.default_rng(num_rows + dcol)
    ids = rng.integers(-2, vocab, n).astype(np.int32)  # some out of range
    cts = (rng.integers(-4096, 4096, (n, dcol)) / 1024 * 3.3).astype(np.float32)
    order = np.argsort(ids, kind="stable")
    sids, cts = ids[order], cts[order]
    pack_, width = _layout(dcol, pack)
    plan = _check_plan(num_rows, dcol, pack_, width, 2)
    assert plan.tiles > 1
    got = _emulate(sids, cts, num_rows, dcol, pack_, plan)
    want = segment_rows_plain(torch.from_numpy(sids), torch.from_numpy(cts),
                              num_rows)
    if pack is not None:
        want = pack_rows(want, pack)
    assert np.array_equal(got, want.numpy())
    if n > 100 and vocab < 10:
        assert np.bincount(sids[sids >= 0]).max() > plan.chunk_pairs
