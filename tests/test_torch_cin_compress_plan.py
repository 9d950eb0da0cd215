"""The per-layer CIN kernel's plan, on the CPU.

``compress_plan`` (deepfm_tpu_torch/ops/kernels/cin.py) sets the map tile,
the column tile, the block and the grid of ``cin_compress``; the C launch
(csrc/cin_compress.cu) recomputes it and refuses a mismatch, so what is
checked here is what the kernel launches. ``_cell``, ``_position_column``,
``_product_rows`` and ``_row_copies`` below repeat the kernel's index
arithmetic (a thread's 8 x 8 cell, the shared-memory positions of a
tile's columns, the rows of a chunk's outer product a warp forms, the x0
rows a thread copies); ``_chunks`` its walk over K = H*F. Each must cover
its domain exactly once. The kernel itself runs only on the card
(tests/test_torch_cin_compress.py, marker ``cuda``).
"""

import numpy as np
import pytest

from deepfm_tpu_torch.ops.kernels.cin import (
    CHUNK,
    MAX_GROUPS,
    ROW_PITCH,
    SMEM_PER_BLOCK,
    THREADS,
    compress_plan,
    compress_smem,
    x0_resident,
)


def _cell(plan, t):
    """(maps, columns) of thread t's cell within its tile, or None for a
    thread with no cell: map group t // cx, columns 4c..4c+3 and
    4*cx + 4c..4*cx + 4c + 3 for c = t % cx."""
    if t >= (plan.tile_maps // 8) * plan.cx:
        return None
    g, c = divmod(t, plan.cx)
    cols = [4 * c + j for j in range(4)]
    return range(8 * g, 8 * g + 8), cols + [4 * plan.cx + x for x in cols]


def _position_column(plan, s):
    """The tile column that position s of an x0, hidden or product row
    holds (s below ROW_PITCH / 2: column s; ROW_PITCH / 2 + j: column
    4*cx + j), or None."""
    j = s % (ROW_PITCH // 2)
    if j >= 4 * plan.cx:
        return None
    return j if s < ROW_PITCH // 2 else 4 * plan.cx + j


def _row_copies(plan, t, rows):
    """(position, rows) of ``rows`` x0 rows that thread t copies: position
    t % ROW_PITCH of rows t // ROW_PITCH + i * step, step = threads //
    ROW_PITCH."""
    step = plan.threads // ROW_PITCH
    r, s = divmod(t, ROW_PITCH)
    return s, (list(range(r, rows, step)) if r < step else [])


def _product_rows(plan, t, rows):
    """(row, position) of a chunk's outer product that thread t forms: warp
    w takes rows w, w + warps, ..., lane l positions l, l + 32, ..."""
    w, lane = divmod(t, 32)
    return [(r, s) for r in range(w, rows, plan.threads // 32)
            for s in range(lane, ROW_PITCH, 32)]


def _chunks(h, f):
    """The kernel's walk over K = H*F: (h, f0, rows) a chunk, F cut into
    ceil(F / CHUNK) blocks of ceil(F / blocks) fields but the last."""
    blocks = -(-f // CHUNK)
    fchunk = -(-f // blocks)
    return [(hh, b * fchunk, min(fchunk, f - b * fchunk))
            for hh in range(h) for b in range(blocks)]

# (B, F, D, M): the xDeepFM paper's three layers (F=27, D=10, 200 maps; H
# does not enter the plan), chip_smoke.py's ragged layer, bench.py's CIN
# width, and shapes off every tile
SHAPES = [
    (4096, 27, 10, 200),
    (1000, 13, 10, 7),
    (16384, 27, 16, 128),
    (129, 27, 10, 200),
    (37, 7, 10, 257),
    (50, 130, 3, 30),
    (1, 1, 1, 1),
    (3, 70, 7, 300),
]


def test_maps_are_padded_by_at_most_7_up_to_256():
    """For M = 1..300: one map tile (all maps, padded to the weight's 8)
    while M <= 256, with at most 7 padded maps; beyond, equal tiles of
    whole 8-map groups, at most 256 maps each; the tiles cover maps
    0..M-1 exactly once."""
    for m in range(1, 301):
        plan = compress_plan(4096, 27, 10, m)
        assert plan.tile_maps % 8 == 0 and plan.tile_maps <= 8 * MAX_GROUPS
        if m <= 256:
            assert plan.map_tiles == 1 and plan.padded_maps <= 7, (m, plan)
        seen = np.zeros(m, dtype=int)
        for y in range(plan.map_tiles):
            lo = y * plan.tile_maps
            seen[lo:min(lo + plan.tile_maps, m)] += 1
        assert (seen == 1).all(), (m, plan)
        assert plan.mp == -(-m // 8) * 8


@pytest.mark.parametrize("bsz,f,d,m", SHAPES)
def test_tiles_and_cells_cover_the_output_once(bsz, f, d, m):
    """The column tiles cover columns 0..B*D-1 once; a block's cells cover
    its map tile by its column tile once, 8 x 8 each, within the block's
    threads; the column of each shared-memory position is the cell's."""
    plan = compress_plan(bsz, f, d, m)
    n = bsz * d
    assert plan.col_tiles == -(-n // plan.tile_cols)
    assert plan.grid == (plan.col_tiles, plan.map_tiles)
    assert plan.threads % 32 == 0 and plan.threads <= THREADS
    assert 8 <= plan.cx <= ROW_PITCH // 8
    seen = np.zeros((plan.tile_maps, plan.tile_cols), dtype=int)
    for t in range(plan.threads):
        cell = _cell(plan, t)
        if cell is None:
            continue
        maps, cols = cell
        for c in cols:
            seen[maps.start:maps.stop, c] += 1
    assert (seen == 1).all()
    cols = [_position_column(plan, s) for s in range(ROW_PITCH)]
    assert sorted(c for c in cols if c is not None) == list(range(plan.tile_cols))
    for t in range(plan.threads):
        cell = _cell(plan, t)
        if cell is not None:
            c = (t % plan.cx) * 4
            assert [_position_column(plan, c + j) for j in range(4)] \
                == cell[1][:4]
            assert [_position_column(plan, ROW_PITCH // 2 + c + j)
                    for j in range(4)] == cell[1][4:]


@pytest.mark.parametrize("bsz,f,d,m", SHAPES)
def test_chunk_rows_are_formed_and_copied_once(bsz, f, d, m):
    """Every (row, position) of a chunk's outer product is formed by one
    thread, for each chunk length; every (row, position) of the x0 rows a
    block stages (all F when resident, else a chunk's) is copied by one
    thread."""
    plan = compress_plan(bsz, f, d, m)
    sizes = sorted({rows for _, _, rows in _chunks(1, f)})
    for rows in sizes:
        seen = np.zeros((rows, ROW_PITCH), dtype=int)
        for t in range(plan.threads):
            for r, s in _product_rows(plan, t, rows):
                seen[r, s] += 1
        assert (seen == 1).all(), rows
    for rows in sizes + ([f] if x0_resident(f) else []):
        seen = np.zeros((rows, ROW_PITCH), dtype=int)
        for t in range(plan.threads):
            s, rs = _row_copies(plan, t, rows)
            seen[rs, s] += 1
        assert (seen == 1).all(), rows


@pytest.mark.parametrize("h,f", [(27, 27), (200, 27), (13, 13), (3, 1),
                                 (2, 32), (2, 33), (4, 64), (3, 65),
                                 (2, 70), (1, 300)])
def test_chunks_walk_k_once_in_order(h, f):
    """Chunks are one hidden row by a block of at most CHUNK fields, the
    blocks of near-equal size; together they walk k = 0..H*F-1 once, in
    order (the fixed order of every output's sum)."""
    chunks = _chunks(h, f)
    blocks = -(-f // CHUNK)
    fchunk = -(-f // blocks)
    assert len(chunks) == h * blocks
    ks = [hh * f + f0 + r for hh, f0, rows in chunks for r in range(rows)]
    assert ks == list(range(h * f))
    assert fchunk <= CHUNK
    for hh in range(h):
        rows = [r for c, _, r in chunks if c == hh]
        assert rows == [fchunk] * (blocks - 1) + [f - (blocks - 1) * fchunk]
        assert 0 < rows[-1] <= fchunk and fchunk - rows[-1] < blocks


def test_shared_memory_fits_two_blocks_for_every_f():
    """Shared memory depends on F alone, stays within a block's limit and
    lets two blocks share an SM for every F (none is refused)."""
    for f in range(1, 1001):
        smem = compress_smem(f)
        assert smem <= SMEM_PER_BLOCK
        assert compress_plan(4096, f, 10, 200).blocks_per_sm == 2


def test_paper_layers_fill_the_card():
    """The paper's layers (B=4096, F=27, D=10, 200 maps) on 132 SMs: one
    tile of all 200 maps (no padded map), 80-column tiles of 256 threads
    (250 cells), two blocks an SM, 512 blocks in 1.94 waves with 97 % of
    the slots filled."""
    plan = compress_plan(4096, 27, 10, 200)
    assert (plan.map_tiles, plan.tile_maps, plan.padded_maps) == (1, 200, 0)
    assert (plan.tile_cols, plan.threads, plan.blocks_per_sm) == (80, 256, 2)
    assert plan.grid == (512, 1)
    assert plan.waves == pytest.approx(512 / 264)
    assert plan.wave_fill >= 0.95
