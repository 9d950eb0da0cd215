"""The plan of the segment_sumsq kernel (``segment_sumsq_plan``) and a
Python replay of its order of summation, on the CPU.

``csrc/sparse_table_adam.cu`` cuts the sorted pairs into chunks of CHUNK
(32, a lane each); each warp of the grid takes a contiguous range of
chunks (``chunk_range`` below), staging a chunk's ids and rows in shared memory
(the next chunk's while it sums this one). A run belongs to the chunk
holding its first pair. A run that ends in its chunk is summed by its
head's lane; one that goes on past the chunk by the warp from device
memory when it ends within SCAN pairs after the chunk, else it is long
and summed by the whole block after its warps. Rows too wide to stage
are read from device memory by the lanes. Every path takes each column in
stream order from 0 and adds its square column after column; a lane adds
its runs' squares in chunk order, a warp its lanes' by a shuffle tree, a
block its warps' in order and then its long runs' in the order of their
heads, and the last block the blocks' partials (a thread its strided
share in order, a shuffle tree in each warp, the warps in order).

The replay below follows the kernel's index arithmetic and classification
with numpy float32 (every operation rounded as the kernel's explicitly
rounded intrinsics round it), asserts that every read of a staged chunk
stays inside it, and is held against ``segment_sumsq_plain`` within rel
1e-5 (another summation order) on uniform ids, runs crossing a chunk's
end, runs longer than SCAN, a warp's range and a block's, and rows too
wide to stage. On the card (the ``cuda`` marker; it skips here) the kernel
must give the replay's bits, be within rel 1e-5 of the plain version,
repeat its bits and launch once a call:

    python -m pytest --noconftest tests/test_torch_segment_sumsq_plan.py -m cuda
"""

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.ops.kernels.sparse_adam import (
    CHUNK,
    SCAN,
    SSQ_SMEM_LIMIT,
    SSQ_WARPS,
    WARP_CHUNKS,
    SegmentSumsqPlan,
    segment_sumsq,
    segment_sumsq_plain,
    segment_sumsq_plan,
)

torch.set_num_threads(1)

F32 = np.float32
REL = 1e-5


def _run_square(rows: np.ndarray) -> np.float32:
    """A run's square as every path of the kernel takes it."""
    g = np.zeros(rows.shape[1], F32)
    for r in rows:
        g = g + r  # float32 elementwise: each column in stream order
    sq = F32(0)
    for v in g:
        sq = F32(sq + F32(v * v))
    return sq


def _warp_tree(lanes: np.ndarray) -> np.float32:
    """The shuffle-down tree of 32 lanes' floats; lane 0's result."""
    lanes = lanes.astype(F32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + np.concatenate([lanes[o:], lanes[32 - o:]])
    return lanes[0]


def _block_total(v: np.ndarray) -> np.float32:
    """table_update.cuh's block_total of one float a thread (256)."""
    s = F32(0)
    for w, warp in enumerate(v.astype(F32).reshape(-1, 32)):
        t = _warp_tree(warp)
        s = t if w == 0 else F32(s + t)
    return s


def _thread_sums(values: np.ndarray, threads: int) -> np.ndarray:
    """Thread t's sequential sum of values[t], values[t + threads], ..."""
    out = np.zeros(threads, F32)
    for k in range(0, len(values), threads):
        part = values[k:k + threads]
        out[:len(part)] = out[:len(part)] + part
    return out


def chunk_range(plan: SegmentSumsqPlan, w: int) -> range:
    """Warp w's chunks: q of them, one more for w < r."""
    q, r = plan.warp_chunks
    first = w * q + min(w, r)
    return range(first, first + q + (1 if w < r else 0))


def replay(ids: np.ndarray, cts: np.ndarray, plan: SegmentSumsqPlan):
    """The kernel's result and the runs each path summed."""
    n = len(ids)
    paths = {"lane": 0, "warp": 0, "block": 0}
    partials = np.zeros(plan.grid, F32)
    for b in range(plan.grid):
        warp_sums, long_heads = [], []
        for w in range(b * plan.warps, (b + 1) * plan.warps):
            acc = np.zeros(CHUNK, F32)
            for c in chunk_range(plan, w):
                p0 = c * CHUNK
                nv = min(CHUNK, n - p0)
                sid = ids[max(p0 - 1, 0):p0 + CHUNK + 1]  # the staged ids
                off = 1 if p0 > 0 else 0
                rows = cts[p0:p0 + nv] if plan.staged else None
                heads = [p0 + k == 0 or sid[off + k - 1] != sid[off + k]
                         for k in range(nv)]
                for lane in range(nv):
                    if not heads[lane]:
                        continue
                    key = sid[off + lane]
                    e = next((k for k in range(lane + 1, nv) if heads[k]), nv)
                    goes_on = (e == nv and p0 + nv < n
                               and sid[off + nv] == key)
                    if not goes_on:
                        assert e <= nv
                        src = rows[lane:e] if plan.staged else \
                            cts[p0 + lane:p0 + e]
                        acc[lane] = F32(acc[lane] + _run_square(src))
                        paths["lane"] += 1
                        continue
                    a = p0 + lane
                    later = ids[p0 + CHUNK:p0 + CHUNK + SCAN]
                    stop = np.flatnonzero(later != key)
                    if stop.size or p0 + CHUNK + SCAN >= n:
                        end = p0 + CHUNK + (stop[0] if stop.size
                                            else n - p0 - CHUNK)
                        acc[lane] = F32(acc[lane] + _run_square(cts[a:end]))
                        paths["warp"] += 1
                    else:
                        long_heads.append(a)
            warp_sums.append(_warp_tree(acc))
        assert len(long_heads) <= plan.cap
        part = F32(0)
        for s in warp_sums:
            part = F32(part + s)
        for a in sorted(long_heads):
            end = a + 1 + int(np.searchsorted(ids[a + 1:], ids[a] + 1))
            part = F32(part + _run_square(cts[a:end]))
            paths["block"] += 1
        partials[b] = part
    return _block_total(_thread_sums(partials, plan.threads)), paths


def _pairs(n, d, vocab, seed, runs=()):
    """Sorted ids drawn from [0, vocab) with the (start, length) spans of
    ``runs`` set to one id each, and seeded rows."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, vocab, n)).astype(np.int32)
    for start, length in runs:
        ids[start:start + length] = ids[start]
    ids = np.maximum.accumulate(ids)  # sorted again after the spans
    cts = rng.normal(size=(n, d)).astype(F32)
    return ids, cts


def _plain(ids, cts):
    return float(segment_sumsq_plain(torch.from_numpy(ids),
                                     torch.from_numpy(cts)))


def test_plans_at_the_main_shapes():
    """bench.py's table phase (425,984 pairs of 17 columns), the paper
    xDeepFM's width 10 (11 columns) and the MovieLens configs' widths
    (4, 8 and 16: 5, 9 and 17 columns) at batch 4096: rows staged, two
    stage buffers a warp within 48 KB, a grid of one H100 wave at most,
    the warps' chunk ranges one apart at most."""
    plan = segment_sumsq_plan(425_984, 17)
    assert (plan.staged, plan.threads, plan.chunks) == (True, 256, 13_312)
    assert (plan.grid, plan.warp_chunks) == (SSQ_WARPS // 8, (3, 640))
    assert plan.smem == 37_232 and plan.scratch == 529 and plan.cap == 16
    for n, d in ((425_984, 11), (4096 * 6, 5), (4096 * 3, 9), (4096 * 2, 17)):
        plan = segment_sumsq_plan(n, d)
        assert plan.staged and plan.smem <= SSQ_SMEM_LIMIT, (n, d)
        assert plan.grid == min(-(-plan.chunks // 8), SSQ_WARPS // 8)


@pytest.mark.parametrize("n", [0, 1, 31, 33, 5000, 425_984, 10 ** 8,
                               2 ** 31 - 1])
def test_warps_cover_the_chunks_once(n):
    """The warps' chunk ranges cover [0, chunks) in order, each chunk
    once, at most WARP_CHUNKS a warp (the grid grows past a wave), and the
    long-run list fits: every plan within 48 KB."""
    plan = segment_sumsq_plan(n, 17)
    q, r = plan.warp_chunks
    assert q + (r > 0) <= WARP_CHUNKS
    ranges = [chunk_range(plan, w) for w in (0, 1, plan.grid * 8 - 1)]
    assert ranges[0].start == 0 and ranges[-1].stop == plan.chunks
    assert ranges[0].stop == ranges[1].start
    total = q * plan.grid * 8 + r
    assert total == plan.chunks and plan.smem <= SSQ_SMEM_LIMIT
    if n <= 5000:
        got = [c for w in range(plan.grid * 8) for c in chunk_range(plan, w)]
        assert got == list(range(plan.chunks))


def test_every_width_is_planned_within_shared_memory():
    """Rows of 1 to 4096 columns: staged while two stage buffers a warp fit
    48 KB (up to 22 columns), else read from device memory."""
    for d in range(1, 4097):
        plan = segment_sumsq_plan(10_000, d)
        assert plan.smem <= SSQ_SMEM_LIMIT, d
        assert plan.staged == (d <= 22), d
    empty = segment_sumsq_plan(0, 17)
    assert (empty.chunks, empty.grid, empty.scratch) == (0, 1, 2)


@pytest.mark.parametrize("n,d", [(0, 17), (-1, 17), (2 ** 31, 17), (10, 0)])
def test_plan_refuses_what_the_kernel_cannot_take(n, d):
    if n == 0:
        assert segment_sumsq_plan(n, d).grid == 1
        return
    with pytest.raises(ValueError, match="segment_sumsq takes"):
        segment_sumsq_plan(n, d)


# (n, d, vocab, runs): uniform ids; runs crossing a chunk's end, one
# within SCAN and one past it; a run over several warps' ranges; a run
# ending the stream; a short stream; rows too wide to stage; more chunks
# than a wave's warps; more long runs a block than a warp; a batch of 4096
# rows of the MovieLens configs' tables: three fields of 2-21 ids (runs of
# hundreds of pairs, every one long), and two fields of 943 and 1682 ids
CASES = {
    "uniform": (3000, 17, 2000, ()),
    "crossing": (3000, 17, 400, ((30, 5), (60, 40), (250, 100), (1530, 60))),
    "long": (6000, 17, 300, ((700, 3900),)),
    "stream_end": (1100, 17, 900, ((1000, 100),)),
    "short": (37, 5, 10, ()),
    "one_pair": (1, 17, 5, ()),
    "unstaged": (1500, 40, 200, ((400, 200), (31, 3))),
    "many_chunks": (150_000, 5, 100_000, ((1000, 300), (140_000, 2000))),
    "many_long": (4000, 9, 20, ()),
    "movielens_fields": (3 * 4096, 5, 30, ()),
    "movielens_ids": (2 * 4096, 17, 943 + 1682, ()),
}
ALL_LONG = ("many_long", "movielens_fields")


@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_matches_the_plain_version(case):
    n, d, vocab, runs = CASES[case]
    ids, cts = _pairs(n, d, vocab, seed=len(case), runs=runs)
    plan = segment_sumsq_plan(n, d)
    got, paths = replay(ids, cts, plan)
    want = _plain(ids, cts)
    assert float(got) == pytest.approx(want, rel=REL), paths
    assert sum(paths.values()) == len(np.unique(ids))  # each run once
    if case == "unstaged":
        assert not plan.staged
    if case in ("crossing", "long", "unstaged"):
        assert paths["block"] >= 1 and paths["warp"] >= 1, paths
    if case in ALL_LONG:
        assert paths["block"] == len(np.unique(ids)) - paths["warp"], paths
    if case not in (*ALL_LONG, "one_pair"):
        assert paths["lane"] > 0, paths


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_replay_on_cuda(case):
    """The kernel against its replay (bit for bit: the same roundings in
    the same order) and its plain version (rel 1e-5) at every replayed
    shape, the same bits twice, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU launch")
    n, d, vocab, runs = CASES[case]
    ids, cts = _pairs(n, d, vocab, seed=len(case), runs=runs)
    sids = torch.from_numpy(ids).cuda()
    rows = torch.from_numpy(cts).cuda()
    before = segment_sumsq.launches
    got = segment_sumsq(sids, rows)
    again = segment_sumsq(sids, rows)
    assert segment_sumsq.launches == before + 2
    want, _ = replay(ids, cts, segment_sumsq_plan(n, d))
    assert float(got) == float(want)
    assert float(got) == pytest.approx(_plain(ids, cts), rel=REL)
    assert torch.equal(got, again)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_calls_on_two_streams_keep_their_own_sums_on_cuda():
    """Calls queued at once on two streams (each with its own ticket) give
    each stream's inputs their own sum, the bits of a call on one stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU launch")
    inputs = []
    for case in ("many_chunks", "movielens_ids"):
        n, d, vocab, runs = CASES[case]
        ids, cts = _pairs(n, d, vocab, seed=len(case), runs=runs)
        inputs.append((torch.from_numpy(ids).cuda(),
                       torch.from_numpy(cts).cuda()))
    want = [segment_sumsq(*pair) for pair in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    for stream in streams:
        stream.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(50):
        for k, (stream, pair) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(stream):
                got[k].append(segment_sumsq(*pair))
    torch.cuda.synchronize()
    for sums, w in zip(got, want):
        assert all(torch.equal(s, w) for s in sums)
