"""The plan of the sparse table Adam kernel (``sparse_adam_plan``) and a
Python model of the kernel's partition, on the CPU.

``csrc/sparse_table_adam.cu`` gives a block one tile of ``tile_phys``
physical rows; the tile's elements are a scalar head, 16-byte vectors of 8
and a scalar tail, cut at the first element where p, mu and nu are all
16-byte aligned (``aligned_head``); the tile's pairs are
``[bounds[t], bounds[t+1])`` (a searchsorted of its first logical row,
clipped at the table's end), staged ``window_pairs`` at a time; the
segmented row sum (``add_runs`` in csrc/table_update.cuh) gives each run
of a window, found where the id changes, to the warp whose eighth of the
window holds its first pair, and adds it in stream order onto what its
slot holds, so a run longer than a window goes on from its sum in the
next. The model below follows the kernel's index arithmetic with numpy
and PyTorch's CPU ops and is held against the plain version bit for bit:
every pair in the table is read once, by the tile that owns its row, in
stream order; every element is updated once; a run cut by a window's end
goes on from its carried sum. The kernel itself is held against the plain
version on the card by tests/test_torch_train_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.ops.kernels.adam import adam_scalars, adam_update_plain
from deepfm_tpu_torch.ops.kernels.grad import sort_pairs
from deepfm_tpu_torch.ops.kernels.sparse_adam import (
    TILE_ELEMENTS,
    sparse_adam_plan,
    sparse_table_adam_plain,
    tile_rows,
    window_pairs,
)
from deepfm_tpu_torch.utils.layout import pack_table

torch.set_num_threads(1)

D = 17
BASE = 1 << 20  # a 16-byte aligned address


def _addresses(p_off, m_off, moment_size):
    """(address, element size) of p, mu and nu, each ``off`` elements past
    a 16-byte boundary."""
    return [(BASE + 4 * p_off, 4), (2 * BASE + moment_size * m_off, moment_size),
            (3 * BASE + moment_size * m_off, moment_size)]


def _elements(plan):
    """Every tile's (scalar elements, vector starts) as the kernel walks
    them."""
    for t in range(plan.tiles):
        start, head, vectors, tail = plan.tile_split(t)
        vec0 = start + head
        scalars = list(range(start, vec0)) + list(
            range(vec0 + 8 * vectors, vec0 + 8 * vectors + tail))
        yield t, scalars, [vec0 + 8 * v for v in range(vectors)]


@pytest.mark.parametrize("width,pack", [(17, 1), (128, 7), (5, 1), (1, 1),
                                        (128, 128), (33, 1), (128, 1)])
def test_tile_rows_hold_whole_vectors(width, pack):
    t = tile_rows(width)
    assert t >= 1 and (t * width) % 8 == 0
    step = next(q for q in range(1, 9) if q * width % 8 == 0)
    assert t * width <= TILE_ELEMENTS or t == step
    # the largest such tile
    assert (t + step) * width > TILE_ELEMENTS
    plan = sparse_adam_plan(1000, width, width // pack, pack,
                            _addresses(0, 0, 2))
    assert plan.tile_phys == t


def test_bench_plans():
    logical = sparse_adam_plan(26 * 400_000, D, D, 1, _addresses(0, 0, 2))
    assert (logical.tile_phys, logical.head, logical.tiles) == (240, 0, 43_334)
    assert logical.tile_split(0) == (0, 0, 510, 0)
    packed = sparse_adam_plan(1_485_824, 128, D, 7, _addresses(0, 0, 2))
    assert (packed.tile_phys, packed.head, packed.tiles) == (32, 0, 46_432)
    assert packed.tile_split(5) == (5 * 32 * 128, 0, 512, 0)


def test_shared_memory_needs_no_opt_in():
    """Every plan of logical rows of 1 to 512 columns and of packed rows of
    every pack stays within the 48 KB a block gets without an opt-in (the
    launch sets the attribute only past it), and a window holds at least
    one pair."""
    shapes = [(w, w, 1) for w in range(1, 513)]
    shapes += [(128, 128 // p, p) for p in range(2, 129)]
    for width, dcol, pack in shapes:
        plan = sparse_adam_plan(10_000, width, dcol, pack,
                                _addresses(0, 0, 2))
        assert plan.smem <= 48 * 1024, (width, pack)
        assert window_pairs(plan.dcol) >= 1


def test_plan_refuses_too_wide_rows():
    """Rows of more than 512 * gcd(width, 8) floats, whose tile of whole
    vectors would pass TILE_ELEMENTS, are refused with a message; the
    widest rows at each gcd are planned, within 48 KB, a window holding at
    least one pair."""
    for width in (511, 512, 1022, 2044, 4096):
        plan = sparse_adam_plan(10, width, width, 1, _addresses(0, 0, 4))
        assert plan.tile_phys * width <= TILE_ELEMENTS
        assert window_pairs(width) >= 1 and plan.smem <= 48 * 1024
    for width in (513, 1026, 2052, 4104):
        with pytest.raises(ValueError, match="512 \\* gcd"):
            sparse_adam_plan(10, width, width, 1, _addresses(0, 0, 4))
    with pytest.raises(ValueError, match="columns"):
        sparse_adam_plan(10, 128, 17, 8, _addresses(0, 0, 4))


@pytest.mark.parametrize("width,dcol,pack", [(17, 17, 1), (128, 17, 7)])
@pytest.mark.parametrize("moment_size", [2, 4])
@pytest.mark.parametrize("offset", range(8))
def test_tiles_cover_each_element_once(width, dcol, pack, moment_size, offset):
    """Head, vectors and tail of every tile cover the table once, at every
    offset of the arrays from a 16-byte boundary, and every vector is
    16-byte aligned in p, mu and nu; a table whose last tile is partial."""
    rows = 3 * tile_rows(width) + 5
    addrs = _addresses(offset, offset, moment_size)
    plan = sparse_adam_plan(rows, width, dcol, pack, addrs)
    seen = np.zeros(rows * width, dtype=np.int64)
    for _, scalars, vectors in _elements(plan):
        seen[scalars] += 1
        for v in vectors:
            seen[v:v + 8] += 1
            assert all((a + v * size) % 16 == 0 for a, size in addrs)
    assert (seen == 1).all()
    assert plan.head == (next(h for h in range(8)
                              if (BASE + 4 * (offset + h)) % 16 == 0
                              and (moment_size * (offset + h)) % 16 == 0))


def test_arrays_without_a_common_boundary_are_all_scalar():
    plan = sparse_adam_plan(1000, D, D, 1, _addresses(1, 0, 2))
    assert plan.head is None
    for _, scalars, vectors in _elements(plan):
        assert not vectors
    assert sum(len(s) for _, s, _ in _elements(plan)) == 1000 * D


def _bounds(plan, sids):
    rows_per_tile = plan.tile_phys * plan.pack
    limit = plan.rows * plan.pack
    return np.searchsorted(sids, [min(t * rows_per_tile, limit)
                                  for t in range(plan.tiles + 1)], "left")


def _add_runs(ids, lo, hi):
    """The runs add_runs adds from the staged pairs [lo, hi), (start, end):
    a run starts at lo and wherever the id changes and is taken by the warp
    whose eighth of [lo, hi) holds its start; it ends where the id changes
    or at hi."""
    per = -(-(hi - lo) // 8)
    runs = []
    for warp in range(8):
        p0 = lo + warp * per
        for a in range(p0, min(p0 + per, hi)):
            if a == lo or ids[a] != ids[a - 1]:
                b = a + 1
                while b < hi and ids[b] == ids[a]:
                    b += 1
                runs.append((a, b))
    return runs


def _model_kernel(plan, p, mu, nu, sids, cts, sc):
    """The kernel's work in PyTorch CPU ops, tile by tile: the tile's pairs
    a window at a time, each run of a window added in stream order onto
    its slot of the zeroed gradient, then the shared update over the tile's
    elements. p, mu, nu flat, updated in place; returns (pairs read per
    position, logical rows whose run was cut by a window's end)."""
    read = np.zeros(len(sids), dtype=np.int64)
    carried = set()
    bounds = _bounds(plan, sids)
    window = window_pairs(plan.dcol)
    for t, scalars, vectors in _elements(plan):
        start = t * plan.tile_phys * plan.width
        n = min(plan.tile_phys, plan.rows - t * plan.tile_phys) * plan.width
        grad = torch.zeros(plan.tile_phys * plan.width)
        lo = t * plan.tile_phys * plan.pack  # the tile's logical rows
        logical = range(lo, min(lo + plan.tile_phys * plan.pack,
                                plan.rows * plan.pack))
        s0, s1 = bounds[t], bounds[t + 1]
        for w0 in range(s0, s1, window):
            for a, b in _add_runs(sids, w0, min(w0 + window, s1)):
                r = int(sids[a]) - lo
                assert lo + r in logical  # the tile owns the row
                if a > s0 and sids[a - 1] == sids[a]:
                    carried.add(lo + r)
                read[a:b] += 1
                off = ((r // plan.pack) * plan.width
                       + (r % plan.pack) * plan.dcol)
                acc = grad[off:off + plan.dcol]
                for k in range(a, b):  # stream order, onto the slot
                    acc = acc + cts[k]
                grad[off:off + plan.dcol] = acc
        idx = torch.tensor(sorted(scalars + [v + e for v in vectors
                                             for e in range(8)]),
                           dtype=torch.long)
        assert idx.tolist() == list(range(start, start + n))
        p2, m2, v2 = adam_update_plain(p[idx], grad[idx - start], mu[idx],
                                       nu[idx], sc)
        p[idx], mu[idx], nu[idx] = p2, m2, v2
    return read, carried


@pytest.mark.parametrize("pack", [1, 7])
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_model_of_the_kernel_matches_the_plain_version(pack, moments):
    """Runs of many lengths, one longer than a window (cut by its end and
    carried into the next), one in the table's last row, ids outside the
    table on both sides, a ragged last tile, the arrays 3 elements off a
    16-byte boundary: the model reads each in-range pair once, in its row's
    tile, and gives the plain version's p, mu and nu bit for bit."""
    rng = np.random.default_rng(pack)
    tile = tile_rows(128 if pack > 1 else D)
    phys = 2 * tile + 3
    rows = phys * pack  # logical
    window = window_pairs(D)
    ids = rng.integers(-3, rows + 3, 900)
    ids[:window + 10] = 5
    ids[window + 10:window + 80] = rows - 1
    ids[400:430] = tile * pack  # the first row of the second tile
    ct = rng.normal(size=(len(ids), D)).astype(np.float32)
    sids, cts = sort_pairs(torch.from_numpy(ids.astype(np.int32)),
                           torch.from_numpy(ct))
    p0 = torch.from_numpy(rng.normal(size=(rows, D)).astype(np.float32)) * 0.05
    m0 = (torch.from_numpy(rng.normal(size=(rows, D)).astype(np.float32))
          * 0.01).to(moments)
    v0 = (torch.from_numpy(rng.normal(size=(rows, D)).astype(np.float32))
          * 0.01).square().to(moments)
    state = [p0, m0, v0]
    if pack > 1:
        state = [pack_table(t, D, pack, phys) for t in state]
    width = state[0].shape[1]
    size = state[1].element_size()
    plan = sparse_adam_plan(phys, width, D, pack, _addresses(3, 3, size))
    args = (1e-3, 2e-5, torch.tensor(3.0), 1.0, torch.tensor(2))
    sc = adam_scalars(*args)
    got = [t.clone().reshape(-1) for t in state]
    read, carried = _model_kernel(plan, *got, sids.numpy(), cts, sc)
    inside = (sids.numpy() >= 0) & (sids.numpy() < rows)
    assert (read == inside.astype(np.int64)).all()
    assert 5 in carried
    want = [t.clone() for t in state]
    sparse_table_adam_plain(*want, sids, cts, *args, pack=pack)
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w.shape), w)

