"""The f32 CIN-stack kernels on the FP32 pipes: their plans and their order
of work, on the CPU.

``fp32_forward_plan`` and ``fp32_backward_plan`` (ops/kernels/cin_stack.py)
set the tiles, threads, chunks and shared memory of csrc/cin_stack_fwd.cu
and csrc/cin_stack_bwd.cu; the C launches recompute them. They must take
every shape that ``stack_route`` sends down the "stack" route. The replays
below repeat the kernels' order of work in PyTorch on the CPU, with each
fmaf taken as one f64 multiply-add rounded to f32 (exact for these
operands but for a double rounding):

  * ``layer_product`` (csrc/cin_stack.cuh), the forward's layer and the
    backward's remat: passes of map groups by column windows, chunks of up
    to 32 rows k = h*F + f of K, each comp summed over k in order from 0
    with its product rounded first, then the bias and ReLU;
    pooled sums over d in column order, window by window. Since the order
    of k does not depend on the plan, the forward's comps and the remat's
    (a different tile, threads and chunk) must be the same bits;
  * A = W^T dcomp by chunks of hc hidden rows, each output summed over the
    maps in order; dhid and dx0 from each chunk in the kernel's order;
  * dW by the split-K partition of ``dw_splits`` (each split summed in
    column order, the partials added in split order), db by tiles then a
    fixed tree.

The replays are held against ``cin_stack_plain`` / ``cin_stack_backward_
plain`` at chip_smoke.py's f32 tolerances: CIN_TOL["float32"] (rtol 2e-4 /
atol 1e-5) and CIN_BWD_TOL["float32"]'s element rule (rtol 2e-4, atol 1e-5
of the output's largest magnitude): the same f32 sums in another order.
The kernels themselves run only on the card (marker ``cuda``).
"""

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.ops.cin import cin_layer_sizes
from deepfm_tpu_torch.ops.kernels.cin_stack import (
    F32_CHUNK,
    F32_THREADS,
    SMEM_PER_BLOCK,
    _passes,
    cin_stack_backward,
    cin_stack_backward_plain,
    cin_stack_forward,
    cin_stack_plain,
    dw_splits,
    fp32_backward_plan,
    fp32_forward_plan,
    stack_route,
)

torch.set_num_threads(1)

FWD_TOL = dict(rtol=2e-4, atol=1e-5)
BWD_RTOL, BWD_ATOL_REL = 2e-4, 1e-5

# chip_smoke.py's f32 shapes: (name, batch, F, D, layer_sizes, split_half)
MAIN_SHAPES = [
    ("serving", 4096, 16, 16, (128, 128, 64), True),  # and movielens_f32
    ("bench_f32", 16384, 27, 16, (128, 128), True),
    ("ragged", 1000, 13, 16, (10, 7), True),
    ("paper_f32", 1024, 27, 10, (200, 200, 200), False),
]

# shapes on either side of the stack route's edge, and odd ones (the bf16
# plan's, tests/test_torch_cin_plan.py)
EDGE_SHAPES = [
    (16, 4, 4, (224, 224, 224), False),
    (1024, 27, 16, (512,), False),
    (8, 27, 16, (256, 256, 256), False),
    (3, 13, 16, (10, 7), True),
    (5, 4, 300, (8,), False),
    (1, 40, 64, (300, 300), True),
    (4096, 27, 10, (256, 128), True),
    (7, 1, 19000, (1,), False),
    (64, 450, 16, (228,), False),
    (64, 16, 16, (446, 446), False),
    (64, 200, 1, (300, 300, 300), True),
    (2, 2, 100, (200, 200), False),
]


def _check_forward_plan(p, batch, f, d, layers, split):
    _, nxt = cin_layer_sizes(layers, split)
    assert 1 <= p.tile_b <= batch and p.nt == -(-p.tile_b * d // 8) * 8
    assert 32 <= p.threads <= F32_THREADS and p.threads % 32 == 0
    assert p.kc in (32, 16, 8, 4, 2, 1) and p.kc <= F32_CHUNK
    assert p.smem == 4 * (f * p.nt + p.nbuf * p.hn * p.nt + p.stage)
    assert p.smem <= SMEM_PER_BLOCK and p.blocks_per_sm >= 1
    assert p.hn == max(nxt[:-1], default=0)
    # a middle layer of more than one pass writes into a second buffer
    cx = p.nt // 8
    multi = [_passes(-(-m // 8), cx, p.threads)[0] > 1 for m in layers]
    assert p.nbuf == (0 if len(layers) == 1 else 2 if any(multi[1:-1]) else 1)


def _check_backward_plan(p, batch, f, d, layers, split):
    assert 1 <= p.tile_b <= batch and p.nt == -(-p.tile_b * d // 8) * 8
    assert 32 <= p.threads <= F32_THREADS and p.threads % 32 == 0
    assert p.kc in (32, 16, 8, 4, 2, 1) and 1 <= p.hc <= 8
    assert p.mc in (32, 16, 8, 4, 2, 1)
    assert p.arows == -(-p.hc * f // 8) * 8
    assert p.smem <= SMEM_PER_BLOCK and p.blocks_per_sm >= 1
    _, nxt = cin_layer_sizes(layers, split)
    hs = [f, *nxt[:-1]]
    assert p.splits == tuple(dw_splits(m, h * f, batch * d)[0]
                             for m, h in zip(layers, hs))


@pytest.mark.parametrize("name,batch,f,d,layers,split", MAIN_SHAPES)
def test_fp32_plans_at_the_main_shapes(name, batch, f, d, layers, split):
    fwd = fp32_forward_plan(batch, f, d, layers, split)
    _check_forward_plan(fwd, batch, f, d, layers, split)
    # (tile_b, nt, threads, kc, blocks an SM) of the forward
    want = {"serving": (8, 128, 256, 32, 2), "bench_f32": (8, 128, 256, 32, 2),
            "ragged": (8, 128, 32, 32, 4), "paper_f32": (6, 64, 224, 16, 2)}[name]
    assert (fwd.tile_b, fwd.nt, fwd.threads, fwd.kc, fwd.blocks_per_sm) == want
    if name == "paper_f32":  # the backward takes the layers route there
        assert stack_route(batch, f, d, layers, split, True) == "layers"
        return
    bwd = fp32_backward_plan(batch, f, d, layers, split)
    _check_backward_plan(bwd, batch, f, d, layers, split)
    # (tile_b, nt, threads, kc, hc, mc, blocks an SM, splits of dW)
    want = {"serving": (8, 128, 256, 32, 6, 32, 1, (64, 33, 33)),
            "bench_f32": (8, 128, 256, 32, 4, 32, 1, (44, 56)),
            "ragged": (8, 128, 224, 32, 8, 32, 1, (30, 30))}[name]
    assert (bwd.tile_b, bwd.nt, bwd.threads, bwd.kc, bwd.hc, bwd.mc,
            bwd.blocks_per_sm, bwd.splits) == want


@pytest.mark.parametrize("batch,f,d,layers,split", EDGE_SHAPES)
def test_fp32_plans_take_every_stack_shape(batch, f, d, layers, split):
    for backward, plan, check in (
            (False, fp32_forward_plan, _check_forward_plan),
            (True, fp32_backward_plan, _check_backward_plan)):
        if stack_route(batch, f, d, layers, split, backward) == "stack":
            check(plan(batch, f, d, layers, split), batch, f, d, layers, split)


@pytest.mark.parametrize("seed", range(4))
def test_fp32_plans_take_random_stack_shapes(seed):
    rng = np.random.default_rng(seed)
    taken = [0, 0]
    for _ in range(300):
        n = int(rng.integers(1, 5))
        layers = tuple(int(m) for m in rng.integers(1, 480, n))
        split = bool(rng.integers(0, 2))
        f = int(rng.integers(1, 500))
        d = int(rng.choice([1, 4, 10, 16, 33, 64, 100, 300, 2000]))
        batch = int(rng.integers(1, 5000))
        if stack_route(batch, f, d, layers, split, False) == "stack":
            taken[0] += 1
            _check_forward_plan(fp32_forward_plan(batch, f, d, layers, split),
                                batch, f, d, layers, split)
        if stack_route(batch, f, d, layers, split, True) == "stack":
            taken[1] += 1
            _check_backward_plan(
                fp32_backward_plan(batch, f, d, layers, split),
                batch, f, d, layers, split)
    assert taken[0] > 20 and taken[1] > 5


def test_fp32_plans_refuse_what_does_not_fit_naming_its_bytes():
    with pytest.raises(ValueError, match=r"needs \d+ bytes of shared memory"):
        fp32_forward_plan(64, 4000, 16, (1000, 1000), False)
    with pytest.raises(ValueError, match=r"needs \d+ bytes of shared memory"):
        fp32_backward_plan(64, 2000, 16, (1000, 1000), False)


@pytest.mark.parametrize("k,hf,m", [(16000, 169, 10), (262144, 1728, 128),
                                    (65536, 256, 128), (20, 30, 8), (1, 1, 1)])
def test_dw_splits_cover_k_once_in_steps_of_32(k, hf, m):
    splits, chunk = dw_splits(m, hf, k)
    assert 1 <= splits <= 64 and chunk % 32 == 0
    assert (splits - 1) * chunk < k <= splits * chunk
    assert splits == 1 or chunk >= 512
    # the least rounds of the dW grid (tiles of 128 maps by 128 outer
    # rows, times the splits, over 2 blocks on each of 132 SMs) times a
    # split's columns
    tiles = -(-hf // 128) * -(-m // 128)

    def cost(c):
        return -(-tiles * -(-k // c) // (2 * 132)) * c

    assert all(cost(chunk) <= cost(-(-(-(-k // s)) // 32) * 32)
               for s in range(1, min(64, max(1, k // 512)) + 1))


# ---------------------------------------------------------------- replays


def _fma(acc, a, b):
    """fmaf(a, b, acc) elementwise, as one f64 multiply-add rounded to f32."""
    return (acc.double() + a.double() * b.double()).float()


def _tile_columns(x0, b0, tile_b, nt):
    """x0 of one tile as (F, nt) rows, zero past its samples."""
    bsz, f, d = x0.shape
    xs = torch.zeros(f, nt)
    nb = min(tile_b, bsz - b0)
    xs[:, : nb * d] = x0[b0:b0 + nb].permute(1, 0, 2).reshape(f, nb * d)
    return xs


def _layer_replay(xs, hid, w, b, nt, threads, kc):
    """layer_product's comps (M, nt) of one tile: its passes and chunks of
    ``kc`` rows of K."""
    m_maps, _ = w.shape
    f, h_rows = xs.shape[0], hid.shape[0]
    mp = -(-m_maps // 8) * 8
    wt = torch.zeros(h_rows * f, mp)
    wt[:, :m_maps] = w.t()
    bias = torch.zeros(mp)
    bias[:m_maps] = b
    cx = nt // 8
    _, groups, cols = _passes(mp // 8, cx, threads)
    comp = torch.empty(mp, nt)
    for g0 in range(0, mp // 8, groups):
        ng = min(groups, mp // 8 - g0)
        maps = slice(8 * g0, 8 * (g0 + ng))
        for c0 in range(0, cx, cols):
            win = slice(8 * c0, 8 * min(cx, c0 + cols))
            acc = torch.zeros(8 * ng, win.stop - win.start)
            for k0 in range(0, h_rows * f, kc):
                for k in range(k0, min(k0 + kc, h_rows * f)):
                    h, ff = divmod(k, f)
                    prod = hid[h, win] * xs[ff, win]  # rounded to f32
                    acc = _fma(acc, wt[k, maps][:, None], prod[None, :])
            comp[maps, win] = torch.relu(acc + bias[maps][:, None])
    return comp[:m_maps]


def _forward_replay(x0, ws, bs, layers, split, plan=None, tile=None):
    """The forward kernel's output (B, sum(direct)) and every layer's comps
    of every tile (for the bit-for-bit check), under ``tile`` = (tile_b, nt,
    threads, fc) or the forward plan's."""
    bsz, f, d = x0.shape
    direct, nxt = cin_layer_sizes(layers, split)
    if tile is None:
        p = plan or fp32_forward_plan(bsz, f, d, layers, split)
        tile = (p.tile_b, p.nt, p.threads, p.kc)
    tile_b, nt, threads, kc = tile
    out = torch.zeros(bsz, sum(direct))
    comps = []
    for b0 in range(0, bsz, tile_b):
        nb = min(tile_b, bsz - b0)
        xs = _tile_columns(x0, b0, tile_b, nt)
        hid, col, tile_comps = xs, 0, []
        for i, m in enumerate(layers):
            comp = _layer_replay(xs, hid, ws[i], bs[i], nt, threads, kc)
            tile_comps.append(comp)
            for bl in range(nb):  # pooled in column order
                s = torch.zeros(direct[i])
                for dd in range(d):
                    s = s + comp[: direct[i], bl * d + dd]
                out[b0 + bl, col:col + direct[i]] = s
            col += direct[i]
            hid = comp[m - nxt[i]:]
        comps.append(tile_comps)
    return out, comps


def _inputs(seed, batch, f, d, layers, split):
    rng = np.random.default_rng(seed)
    direct, nxt = cin_layer_sizes(layers, split)
    ws, bs, h = [], [], f
    for i, m in enumerate(layers):
        bound = 1.0 / np.sqrt(h * f)
        ws.append(torch.from_numpy(
            rng.uniform(-bound, bound, (m, h * f)).astype(np.float32)))
        bs.append(torch.from_numpy(
            rng.uniform(-bound, bound, (m,)).astype(np.float32)))
        h = nxt[i]
    x0 = torch.from_numpy(rng.normal(size=(batch, f, d)).astype(np.float32))
    g = torch.from_numpy(
        rng.normal(size=(batch, sum(direct))).astype(np.float32))
    return x0, ws, bs, g


# (batch, F, D, layers, split): two and three layers, odd F, D and maps, a
# ragged last tile
REPLAY_SHAPES = [
    (5, 5, 4, (12, 6), True),
    (7, 3, 10, (9, 16, 5), False),
    (3, 13, 16, (10, 7), True),
]


@pytest.mark.parametrize("batch,f,d,layers,split", REPLAY_SHAPES)
def test_forward_order_of_work_matches_plain(batch, f, d, layers, split):
    x0, ws, bs, _ = _inputs(0, batch, f, d, layers, split)
    got, _ = _forward_replay(x0, ws, bs, layers, split)
    torch.testing.assert_close(
        got, cin_stack_plain(x0, ws, bs, layers, split), **FWD_TOL)
    # column windows and a pass a map group (one cell a pass), chunks of 2
    # rows of K: the same comps, so the same output bits
    nt = -(-d // 8) * 8
    narrow, _ = _forward_replay(x0, ws, bs, layers, split, tile=(1, nt, 1, 2))
    wide, _ = _forward_replay(x0, ws, bs, layers, split, tile=(1, nt, 256, 32))
    assert torch.equal(narrow, wide)


@pytest.mark.parametrize("batch,f,d,layers,split", REPLAY_SHAPES)
def test_forward_and_remat_give_the_same_comps(batch, f, d, layers, split):
    """The remat runs layer_product under the backward plan's tile,
    threads and chunk: every comp of every sample equals the forward's."""
    x0, ws, bs, _ = _inputs(1, batch, f, d, layers, split)
    fp = fp32_forward_plan(batch, f, d, layers, split)
    bp = fp32_backward_plan(batch, f, d, layers, split)
    for tile in ((bp.tile_b, bp.nt, bp.threads, bp.kc),
                 (2, 8 * -(-2 * d // 8), 32, 1)):
        _, fwd = _forward_replay(x0, ws, bs, layers, split, plan=fp)
        _, remat = _forward_replay(x0, ws, bs, layers, split, tile=tile)

        def per_sample(comps, tile_b):
            return [torch.cat([c[:, j * d:(j + 1) * d] for c in t], dim=0)
                    for t in comps for j in range(tile_b)][:batch]

        a = per_sample(fwd, fp.tile_b)
        b = per_sample(remat, tile[0])
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def _backward_replay(x0, ws, bs, g, layers, split, dw_chunk=None):
    """The backward kernels' (dx0, dWs, dbs) in their order of work."""
    bsz, f, d = x0.shape
    direct, nxt = cin_layer_sizes(layers, split)
    p = fp32_backward_plan(bsz, f, d, layers, split)
    n, k_cols = len(layers), bsz * d
    hs = [f, *nxt[:-1]]
    dx0 = torch.zeros(bsz, f, d)
    dcomp_all = [torch.zeros(m, k_cols) for m in layers]
    hid_all = [None] * n
    db_parts = []
    for b0 in range(0, bsz, p.tile_b):
        nb = min(p.tile_b, bsz - b0)
        ncol = nb * d
        xs = _tile_columns(x0, b0, p.tile_b, p.nt)
        hid, comps, hids = xs, [], []
        for i, m in enumerate(layers):  # the remat
            comp = _layer_replay(xs, hid, ws[i], bs[i], p.nt, p.threads, p.kc)
            comps.append(comp)
            hids.append(hid)
            hid = comp[m - nxt[i]:]
        dx0s = torch.zeros(f, p.nt)
        dhid = None
        db_tile = [None] * n
        for i in reversed(range(n)):
            m, h = layers[i], hs[i]
            gcol = torch.zeros(direct[i], p.nt)
            gcol[:, :ncol] = g[b0:b0 + nb, sum(direct[:i]):sum(direct[:i + 1])
                               ].repeat_interleave(d, dim=0).t()
            if split and i < n - 1:
                dc = torch.cat([gcol, dhid])
            else:
                dc = gcol + dhid if dhid is not None else gcol
            dc = dc * (comps[i] > 0)
            dc[:, ncol:] = 0
            dcomp_all[i][:, b0 * d:b0 * d + ncol] = dc[:, :ncol]
            if i > 0:
                if hid_all[i] is None:
                    hid_all[i] = torch.zeros(h, k_cols)
                hid_all[i][:, b0 * d:b0 * d + ncol] = hids[i][:, :ncol]
            s = torch.zeros(m)
            for nn in range(ncol):
                s = s + dc[:, nn]
            db_tile[i] = s
            # A = W^T dcomp by chunks of hc hidden rows, maps in order; from
            # each chunk dx0's share, then dhid (at layer 0 added to dx0)
            w3 = ws[i].reshape(m, h, f)
            dhid = torch.zeros(h, p.nt)
            for h0 in range(0, h, p.hc):
                hc = min(p.hc, h - h0)
                a = torch.zeros(hc, f, p.nt)
                for mm in range(m):
                    a = _fma(a, w3[mm, h0:h0 + hc, :, None], dc[mm][None, None])
                s = torch.zeros(f, p.nt)
                for hl in range(hc):
                    s = _fma(s, a[hl], hids[i][h0 + hl][None])
                dx0s = dx0s + s
                for hl in range(hc):
                    s = torch.zeros(p.nt)
                    for ff in range(f):
                        s = _fma(s, a[hl, ff], xs[ff])
                    dhid[h0 + hl] = s
                    if i == 0:
                        dx0s[h0 + hl] = dx0s[h0 + hl] + s
        dx0[b0:b0 + nb] = dx0s[:, :ncol].reshape(f, nb, d).permute(1, 0, 2)
        db_parts.append(torch.cat(db_tile))
    # dW: the split-K partition, each split in column order, then the
    # partials in split order
    dws = []
    for i, (m, h) in enumerate(zip(layers, hs)):
        hid_k = x0.permute(1, 0, 2).reshape(f, k_cols) if i == 0 else hid_all[i]
        x_k = x0.permute(1, 0, 2).reshape(f, k_cols)
        outer = (hid_k[:, None] * x_k[None]).reshape(h * f, k_cols)
        chunk = dw_chunk or dw_splits(m, h * f, k_cols)[1]
        total = torch.zeros(m, h * f)
        for k0 in range(0, k_cols, chunk):
            part = torch.zeros(m, h * f)
            for kk in range(k0, min(k_cols, k0 + chunk)):
                part = _fma(part, dcomp_all[i][:, kk, None], outer[None, :, kk])
            total = total + part
        dws.append(total)
    # db: each thread of 256 a strided share of the tiles, then a tree
    parts = torch.stack(db_parts)
    shares = torch.zeros(256, parts.shape[1])
    for t in range(parts.shape[0]):
        shares[t % 256] = shares[t % 256] + parts[t]
    width = 128
    while width:
        shares[:width] = shares[:width] + shares[width:2 * width]
        width //= 2
    dbs = torch.split(shares[0], list(layers))
    return dx0, dws, list(dbs)


@pytest.mark.parametrize("batch,f,d,layers,split", REPLAY_SHAPES)
@pytest.mark.parametrize("dw_chunk", [None, 32])
def test_backward_order_of_work_matches_plain(batch, f, d, layers, split,
                                              dw_chunk):
    x0, ws, bs, g = _inputs(2, batch, f, d, layers, split)
    got = _backward_replay(x0, ws, bs, g, layers, split, dw_chunk)
    want = cin_stack_backward_plain(x0, ws, bs, g, layers, split)
    for name, a, w in zip(
            ["dx0", *[f"dW{i}" for i in range(len(layers))],
             *[f"db{i}" for i in range(len(layers))]],
            [got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]]):
        torch.testing.assert_close(
            a, w, rtol=BWD_RTOL, atol=BWD_ATOL_REL * w.abs().max().item(),
            msg=name)


# f32 shapes of both kernels on the card: a small bench-like shape, a
# ragged three-layer one, one layer of two passes of map groups in the
# backward (27 fields at D=33), and three layers of 2, 3 and 1 passes in
# the backward whose middle layer takes several passes in the forward too
# (two hidden buffers)
CUDA_SHAPES = [
    (257, 27, 16, (128, 128), True),
    (45, 9, 10, (40, 60, 24), False),
    (9, 27, 33, (244,), True),
    (7, 28, 64, (241, 294, 114), True),
]
# a forward-only edge (its backward takes the layers route): a sample wider
# than a block's cells, cut into column windows
CUDA_FORWARD_SHAPES = [
    (5, 5, 2100, (5,), True),
]


def _cuda_inputs(seed, batch, f, d, layers, split):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU launch")
    torch.backends.cuda.matmul.allow_tf32 = False
    x0, ws, bs, g = _inputs(seed, batch, f, d, layers, split)
    return x0.cuda(), [t.cuda() for t in ws], [t.cuda() for t in bs], g.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("batch,f,d,layers,split", CUDA_SHAPES)
def test_fp32_kernels_match_plain_on_cuda(batch, f, d, layers, split):
    """Both f32 kernels against their plain versions on the card
    (CIN_TOL / CIN_BWD_TOL's element rule on all but 0.1 %, mean relative
    error 1e-4), the same bits on a second launch, and their own launch
    counters."""
    x0, ws, bs, g = _cuda_inputs(3, batch, f, d, layers, split)
    assert stack_route(batch, f, d, layers, split, True) == "stack"
    before = (cin_stack_forward.launches, cin_stack_backward.launches)
    out = cin_stack_forward(x0, ws, bs, layers, split)
    again = cin_stack_forward(x0, ws, bs, layers, split)
    assert torch.equal(out, again)
    torch.testing.assert_close(out, cin_stack_plain(x0, ws, bs, layers, split),
                               **FWD_TOL)
    got = cin_stack_backward(x0, ws, bs, g, layers, split)
    got2 = cin_stack_backward(x0, ws, bs, g, layers, split)
    torch.cuda.synchronize()
    assert (cin_stack_forward.launches - before[0],
            cin_stack_backward.launches - before[1]) == (2, 2)
    want = cin_stack_backward_plain(x0, ws, bs, g, layers, split)
    for a, a2, w in zip([got[0], *got[1], *got[2]],
                        [got2[0], *got2[1], *got2[2]],
                        [want[0], *want[1], *want[2]]):
        assert torch.equal(a, a2)
        err = (a - w).abs()
        outside = err > BWD_ATOL_REL * w.abs().max() + BWD_RTOL * w.abs()
        assert outside.float().mean().item() <= 1e-3
        assert (err.sum() / w.abs().sum()).item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("batch,f,d,layers,split", CUDA_FORWARD_SHAPES)
def test_fp32_forward_edges_on_cuda(batch, f, d, layers, split):
    """The f32 forward where a sample's columns are cut into windows
    (pooled window by window): within CIN_TOL of the plain version, the
    same bits twice."""
    x0, ws, bs, _ = _cuda_inputs(4, batch, f, d, layers, split)
    assert stack_route(batch, f, d, layers, split, False) == "stack"
    before = cin_stack_forward.launches
    out = cin_stack_forward(x0, ws, bs, layers, split)
    again = cin_stack_forward(x0, ws, bs, layers, split)
    torch.cuda.synchronize()
    assert cin_stack_forward.launches - before == 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out, cin_stack_plain(x0, ws, bs, layers, split),
                               **FWD_TOL)
