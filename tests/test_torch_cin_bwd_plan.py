"""The bf16 CIN-stack backward on the tensor cores: its plan, its reads of
the re-laid weight and its order of work, on the CPU.

``mma_backward_plan`` (ops/kernels/cin_stack.py) sets the tile kernel's
layout (resident or streamed), tile, passes, stages and shared memory, the
dW kernel's shared memory and the split of K; the C launch
(csrc/cin_stack_bwd_mma.cu) recomputes it. It must take every shape that
``stack_route`` sends down the "stack" route in the backward, in either
operand mode, and keep the resident plan of every shape that the f32 count
(``stack_smem``) sends there. ``_ldmatrix_x4_trans`` below repeats what one
``ldmatrix.x4.trans`` gives each lane, from the kernel's addresses, and
shows that the A product reads W^T from the forward's re-laid weight
(``mma_weight``) and dcomp as its B operand. ``_kernel_order_backward``
repeats the kernel's order of work in PyTorch: the remat by the forward's
k16 steps, A by map steps of 16 each from zero, its row tiles f-chunk
first, with the group sums after each tile, dW split-K over a bf16 workspace, each k16 step from zero. It
is held against the plain bf16 version under chip_smoke.py's
``CIN_BWD_TOL["bfloat16"]`` rule: the same rounded operands summed in
another order. The kernel itself runs only on the card
(tests/test_torch_cin_grad.py, marker ``cuda``).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from deepfm_tpu_torch.ops.cin import cin_layer_sizes
from deepfm_tpu_torch.ops.kernels.cin_stack import (
    SMEM_PER_BLOCK,
    _mma_layout_plan,
    cin_stack_backward,
    cin_stack_backward_plain,
    cin_stack_bwd_mma,
    mma_backward_plan,
    mma_weight,
    stack_route,
    stack_smem,
)

torch.set_num_threads(1)

# chip_smoke.py's CIN_BWD_TOL["bfloat16"]
BWD_TOL = {"rtol": 2.0 ** -7, "atol_rel": 1e-3, "outside_share": 1e-2,
           "mean_rel": 1e-3, "differ_share": 1e-2}

# (name, batch, F, D, layer_sizes, split_half)
MAIN_SHAPES = [
    ("bench", 16384, 27, 16, (128, 128), True),
    ("ragged", 1000, 13, 16, (10, 7), True),
    ("three_d10", 4096, 27, 10, (64, 64, 64), False),
]


def _r16(n):
    return -(-n // 16) * 16


def _full_rows(plan, layers):
    """One remat pass of every map, as many as the plan's warps take."""
    return min(_r16(max(layers)), 8 // (plan.columns // 32) * 16 * 4)


def _check_plan(plan, batch, f, d, layers, split):
    direct, nxt = cin_layer_sizes(layers, split)
    hs = [f, *nxt[:-1]]
    # the resident layout on every shape the f32 count fits and wherever
    # it fits with one remat pass of every map; else the streamed one
    # where it fits
    resident = _mma_layout_plan(batch, f, d, layers, split, False)
    streamed = _mma_layout_plan(batch, f, d, layers, split, True)
    keep = (stack_smem(batch, f, d, layers, split, True)[2] <= SMEM_PER_BLOCK
            or resident is not None and resident.rows == _full_rows(
                resident, layers))
    assert plan == (resident if keep or streamed is None else streamed)
    assert plan.columns in (32, 64, 128)
    assert plan.chunk * 16 == plan.columns
    assert plan.ntp % plan.columns == 0 and plan.ntp % 32 == 0
    assert 1 <= plan.tile_b <= batch
    assert plan.tile_b * d <= plan.ntp
    assert plan.tile_b == 1 or plan.tile_b * d <= plan.columns
    # the blocks cover the batch
    assert -(-batch // plan.tile_b) * plan.tile_b >= batch
    # remat passes: whole m16 tiles, at most 4 a warp; streamed, one pass
    # of every map (as many as the warps take)
    mp16 = _r16(max(layers))
    assert plan.rows % 16 == 0 and 16 <= plan.rows <= mp16
    assert plan.rows <= 8 // (plan.columns // 32) * 16 * 4
    if plan.streamed:
        assert plan.rows == _full_rows(plan, layers)
    # A stages: whole map steps of 16
    assert plan.a_tiles in (1, 2, 4, 8)
    # A's warps split a stage's row tiles (f-chunk first) by the parity of
    # h: neither group may get more than the kernel's 5
    for h in hs:
        r = h * (-(-f // 16))
        for r0 in range(0, min(r, 64 * plan.a_tiles), plan.a_tiles):
            for parity in (0, 1):
                assert sum((rt % h) % 2 == parity for rt in
                           range(r0, min(r0 + plan.a_tiles, r))) <= 5
    assert 1 <= plan.a_steps <= mp16 // 16
    ntp = plan.ntp
    remat = 4 * plan.rows * plan.columns
    adj = 2 * plan.a_steps * 16 * (32 * plan.a_tiles + 16)
    # streamed: the f32 hidden rows, dhid and the dx0 sums in device memory;
    # the remat's bf16 input rows before its stages, A's stages over both
    want = (_r16(2 * f * ntp) + _r16(sum(layers) * ntp // 8)
            + _r16(2 * mp16 * (ntp + 8)) + 4 * f * (ntp + 8)
            + _r16(4 * plan.tile_b * sum(direct)) * plan.g_staged
            + (max(_r16(2 * max(hs[1:], default=0) * ntp) + remat, adj)
               if plan.streamed else
               4 * sum(hs[1:]) * ntp + 4 * max(hs) * ntp
               + 2 * 4 * f * (ntp + 8) + max(remat, adj)))
    assert plan.smem == want <= SMEM_PER_BLOCK
    # every region starts on 16 bytes (cp.async and ldmatrix need it)
    assert want % 16 == 0
    assert 1 <= plan.splits <= 64
    assert plan.splits == max(1, min(64, -(-batch * d // 4096)))
    rows = [128 + min(h, 127 // f + 2) + min(f, 128) for h in hs]
    assert plan.dw_smem == 2 * max(rows) * 72 * 2 <= SMEM_PER_BLOCK


@pytest.mark.parametrize("name,batch,f,d,layers,split", MAIN_SHAPES)
def test_backward_plan_at_the_main_shapes(name, batch, f, d, layers, split):
    assert stack_route(batch, f, d, layers, split, True) == "stack"
    assert stack_route(batch, f, d, layers, split, True, bf16=True) == "stack"
    plan = mma_backward_plan(batch, f, d, layers, split)
    _check_plan(plan, batch, f, d, layers, split)
    # 128 columns a block: each weight byte read from L2 feeds twice the
    # columns of the f32 kernel's 64
    assert plan.columns == 128 and plan.ntp == 128 and plan.g_staged
    expected = {"bench": (8, 128, 8, 8, 64), "ragged": (8, 16, 8, 1, 4),
                "three_d10": (12, 64, 8, 4, 10)}[name]
    assert (plan.tile_b, plan.rows, plan.a_tiles, plan.a_steps,
            plan.splits) == expected
    if name == "bench":
        # one remat pass of all 128 maps, A's stage all 8 map steps
        assert plan.smem == 231_200
    # the plan the stack route had before the streamed layout, field for
    # field, in the resident layout
    assert tuple(plan) == {
        "bench": (8, 128, 128, True, 128, 8, 8, 8, 231_200, 64, 46_368,
                  False),
        "ragged": (8, 128, 128, True, 16, 8, 8, 1, 47_472, 4, 43_776, False),
        "three_d10": (12, 128, 128, True, 64, 8, 8, 4, 213_792, 10, 46_368,
                      False)}[name]


# the xDeepFM paper's Criteo CIN (Lian et al.: 3 x 200 maps, no split, D=10)
# on Criteo's 39 fields and on 27; a batch of 12 has the batch of 4096's
# tile
PAPER_SHAPES = [(batch, f, 10, (200, 200, 200), False)
                for f in (39, 27) for batch in (4096, 12)]


@pytest.mark.parametrize("batch,f,d,layers,split", PAPER_SHAPES)
def test_paper_cin_backward_fits_the_streamed_layout(batch, f, d, layers,
                                                     split):
    """Off the f32 count, the bf16 plan keeps each layer's f32 hidden rows,
    dhid and A's dx0 sums in device memory, so a tile holds 128 columns (12
    samples): remat passes of 128 maps, the most its warps take (the
    resident layout fit 64 columns and 16 maps a pass at F=39), in weight
    stages of 8 k16 steps, and A's stage 8 tiles by all 13 map steps (4 by
    1 before), so that all of A's warps find columns."""
    assert stack_smem(batch, f, d, layers, split, True)[2] > SMEM_PER_BLOCK
    assert stack_route(batch, f, d, layers, split, True) == "layers"
    assert stack_route(batch, f, d, layers, split, True, bf16=True) == "stack"
    plan = mma_backward_plan(batch, f, d, layers, split)
    _check_plan(plan, batch, f, d, layers, split)
    assert plan.streamed
    assert plan.rows >= 64 and plan.rows == 128
    assert (plan.tile_b, plan.ntp, plan.columns, plan.chunk) == (12, 128,
                                                                 128, 8)
    assert (plan.a_tiles, plan.a_steps, plan.g_staged) == (8, 13, False)
    assert plan.splits == (10 if batch == 4096 else 1)


# shapes on either side of the backward route's edge, and odd ones
EDGE_SHAPES = [
    (16, 4, 4, (224, 224, 224), False),
    (1024, 27, 16, (512,), False),
    (8, 27, 16, (256, 256, 256), False),
    (3, 13, 16, (10, 7), True),
    (5, 4, 300, (8,), False),
    (1, 40, 64, (300, 300), True),
    (4096, 27, 10, (256, 128), True),
    (7, 1, 19000, (1,), False),
    (64, 200, 16, (60,), False),
    (64, 16, 16, (300, 300), False),
    (64, 200, 1, (300, 300, 300), True),
    (2, 2, 100, (200, 200), False),
    (50, 13, 16, (200, 200), True),
    (5, 5, 300, (24, 16), True),
    (4096, 27, 10, (200, 200, 200), False),
]


@pytest.mark.parametrize("batch,f,d,layers,split", EDGE_SHAPES)
def test_backward_plan_takes_every_stack_shape(batch, f, d, layers, split):
    """Wherever the backward takes the stack route, the plan fits; in the
    bf16 mode the route is "stack" exactly where the forward's count and
    the bf16 plan fit."""
    if stack_route(batch, f, d, layers, split, True) == "stack":
        _check_plan(mma_backward_plan(batch, f, d, layers, split),
                    batch, f, d, layers, split)
        assert stack_route(batch, f, d, layers, split, True, True) == "stack"
    else:
        assert stack_smem(batch, f, d, layers, split, True)[2] > SMEM_PER_BLOCK \
            or stack_smem(batch, f, d, layers, split, False)[2] > SMEM_PER_BLOCK
    try:
        plan = mma_backward_plan(batch, f, d, layers, split)
    except ValueError:
        plan = None
    fwd = stack_smem(batch, f, d, layers, split, False)[2] <= SMEM_PER_BLOCK
    assert (stack_route(batch, f, d, layers, split, True, True) == "stack") \
        is (fwd and plan is not None)
    if plan is not None:
        _check_plan(plan, batch, f, d, layers, split)


@settings(max_examples=150, deadline=None)
@given(layers=st.lists(st.integers(1, 480), min_size=1, max_size=4),
       split=st.booleans(), f=st.integers(1, 300),
       d=st.sampled_from([1, 4, 10, 16, 33, 64, 100, 300, 2000]),
       batch=st.integers(1, 5000))
def test_backward_plan_takes_random_stack_shapes(layers, split, f, d, batch):
    layers = tuple(layers)
    if stack_route(batch, f, d, layers, split, True, bf16=True) != "stack":
        assert stack_route(batch, f, d, layers, split, True) == "layers"
        return
    _check_plan(mma_backward_plan(batch, f, d, layers, split),
                batch, f, d, layers, split)


def test_backward_plan_reads_g_from_device_memory_where_it_must():
    """A wide tile of short samples whose cotangent does not fit beside the
    rest: the plan keeps 128 columns and leaves g in device memory."""
    plan = mma_backward_plan(40, 50, 4, (345,), False)
    assert stack_route(40, 50, 4, (345,), False, True) == "stack"
    assert plan.columns == 128 and not plan.g_staged
    _check_plan(plan, 40, 50, 4, (345,), False)


def test_backward_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        mma_backward_plan(64, 2000, 16, (1000, 1000), False)
    assert stack_route(64, 2000, 16, (1000, 1000), False, True,
                       bf16=True) == "layers"
    # the paper's CIN: its f32 backward takes the layers route, its bf16
    # backward the stack (the streamed layout)
    assert stack_route(4096, 27, 10, (200,) * 3, False, True) == "layers"
    assert stack_route(4096, 27, 10, (200,) * 3, False, True,
                       bf16=True) == "stack"


def _ldmatrix_x4_trans(mem, addr):
    """What one ldmatrix.x4.trans gives each lane: ``addr(lane)`` is the
    (row, column) in ``mem`` of the first of the 8 elements of the row that
    lane supplies (matrix lane // 8, its row lane % 8). Lane T receives of
    matrix q the elements at (2 (T % 4), T // 4) and (2 (T % 4) + 1,
    T // 4) of that matrix: returns regs[lane][q] = (lo, hi)."""
    regs = [[None] * 4 for _ in range(32)]
    for q in range(4):
        rows = [addr(8 * q + r) for r in range(8)]
        for lane in range(32):
            g, t = lane // 4, lane % 4
            lo = mem[rows[2 * t][0], rows[2 * t][1] + g]
            hi = mem[rows[2 * t + 1][0], rows[2 * t + 1][1] + g]
            regs[lane][q] = (lo, hi)
    return regs


@pytest.mark.parametrize("m,h,f", [(128, 64, 27), (10, 13, 13), (7, 3, 5)])
def test_transposed_reads_of_the_relaid_weight_give_wt(m, h, f):
    """The A product's fragments: the kernel stages rows k0*16 .. of
    mma_weight(W) (maps) and T tiles of 16 of its columns, and reads tile i
    of map step s with ldmatrix.x4.trans from lane l at stage row s*16 +
    ((l >> 3) >> 1) * 8 + (l & 7), granule 2i + ((l >> 3) & 1). Each lane
    must then hold the m16n8k16 A fragment of W^T: a0 = (row g, k 2t, 2t+1),
    a1 = (g + 8, 2t), a2 = (g, 2t + 8), a3 = (g + 8, 2t + 8), the row (h, f)
    of the tile and k the map."""
    rng = np.random.default_rng(m + h + f)
    w = torch.from_numpy(rng.normal(size=(m, h * f)).astype(np.float32))
    wr = mma_weight(w, f).float()
    fp = _r16(f)
    w3 = torch.zeros(wr.shape[0], h, fp)
    w3[:m, :, :f] = w.bfloat16().float().reshape(m, h, f)
    n_tiles, steps = h * fp // 16, wr.shape[0] // 16
    T = 4
    for r0 in range(0, n_tiles, T):
        for s in range(steps):
            # the stage as the kernel fills it: row r = map s*16 + r,
            # granule q = columns r0*16 + q*8 .. + 8
            for i in range(min(T, n_tiles - r0)):
                def addr(lane):
                    q = lane >> 3
                    row = s * 16 + (q >> 1) * 8 + (lane & 7)
                    col = (r0 + i) * 16 + (q & 1) * 8
                    return row, col
                regs = _ldmatrix_x4_trans(wr, addr)
                tile = (r0 + i) * 16  # the tile's first re-laid column
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                        for e in range(2):
                            row, k = g + dr, 2 * t + dk + e
                            col = tile + row
                            want = w3[s * 16 + k, col // fp, col % fp]
                            assert regs[lane][reg][e] == want


def test_transposed_reads_of_dcomp_give_the_b_fragments():
    """B of the A product: dcomp[maps, columns] in shared memory, rows
    ntp + 8 long, read by ldmatrix.x4.trans from lane l at row map step +
    ((l >> 3) & 1) * 8 + (l & 7), column cb + ((l >> 3) >> 1) * 8; registers
    0, 1 must be the B fragment (k = 2t, 2t+1 and 2t+8, 2t+9; n = g) of the
    warp's first n8 tile, registers 2, 3 of its second."""
    dcs = torch.arange(32 * 40, dtype=torch.float32).reshape(32, 40)
    for k0, cb in ((0, 0), (16, 16)):
        regs = _ldmatrix_x4_trans(
            dcs, lambda lane: (k0 + ((lane >> 3) & 1) * 8 + (lane & 7),
                               cb + ((lane >> 3) >> 1) * 8))
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for nt in range(2):
                for half in range(2):
                    lo, hi = regs[lane][2 * nt + half]
                    k = k0 + 2 * t + 8 * half
                    assert lo == dcs[k, cb + nt * 8 + g]
                    assert hi == dcs[k + 1, cb + nt * 8 + g]


def _op(t):
    return t.to(torch.bfloat16).float()


def _kernel_order_backward(x0, ws, bs, g, layers, split):
    """The kernel's order of work on the CPU (csrc/cin_stack_bwd_mma.cu),
    on columns k = b*D + d: returns (dx0, dWs, dbs) as the wrapper does."""
    bsz, f, d = x0.shape
    plan = mma_backward_plan(bsz, f, d, layers, split)
    direct, nxt = cin_layer_sizes(layers, split)
    n = len(layers)
    fp = _r16(f)
    K = bsz * d
    x = x0.float().permute(1, 0, 2).reshape(f, K)
    xp = torch.zeros(fp, K)
    xp[:f] = x
    hs = [f, *nxt[:-1]]
    wrs = [mma_weight(w, f).float() for w in ws]
    # remat: the forward's k16 steps, f-chunk outer, h inner, each from zero
    hid, hids, comps = x, [], []
    for i, m in enumerate(layers):
        hids.append(hid)
        acc = torch.zeros(wrs[i].shape[0], K)
        for fc in range(fp // 16):
            for hh in range(hs[i]):
                k = hh * fp + fc * 16
                acc += wrs[i][:, k:k + 16] @ _op(
                    _op(hid[hh])[None] * xp[fc * 16:fc * 16 + 16])
        comp = torch.relu(acc[:m] + bs[i].float()[:, None])
        comps.append(comp)
        hid = comp[m - nxt[i]:]
    cols = torch.split(g.float(), list(direct), dim=1)
    dx0 = torch.zeros(2, f, K)
    dws, dbs = [None] * n, [None] * n
    dhid_next = None
    for i in reversed(range(n)):
        m, h, hid = layers[i], hs[i], hids[i]
        gi = cols[i].T.repeat_interleave(d, dim=1)
        if split and i < n - 1:
            dc = torch.cat([gi, dhid_next])
        elif dhid_next is not None:
            dc = gi + dhid_next
        else:
            dc = gi
        dc = dc * (comps[i] > 0)
        # db: each tile's columns, then the tiles
        tw = plan.tile_b * d
        dbs[i] = torch.stack([dc[:, k0:k0 + tw].sum(1)
                              for k0 in range(0, K, tw)]).sum(0)
        dcb = _op(dc)
        mp = wrs[i].shape[0]
        dcp = torch.zeros(mp, K)
        dcp[:m] = dcb
        # A by row tiles (h, f-chunk), f-chunk first, map steps from zero;
        # dhid added over the f-chunks in order; dx0 summed over the even
        # and over the odd h of each f-chunk (two groups of warps), each
        # sum added to its group's dx0
        dhid = torch.zeros(h, K)
        for fc in range(fp // 16):
            dsum = torch.zeros(2, 16, K)
            for hh in range(h):
                c0 = hh * fp + fc * 16
                a = torch.zeros(16, K)
                for s in range(mp // 16):
                    a += wrs[i][s * 16:s * 16 + 16, c0:c0 + 16].T @ dcp[s * 16:s * 16 + 16]
                dhid[hh] += (a * xp[fc * 16:fc * 16 + 16]).sum(0)
                dsum[hh % 2] += a * hid[hh]
            nf = min(16, f - fc * 16)
            dx0[:, fc * 16:fc * 16 + nf] += dsum[:, :nf]
        dhid_next = dhid
        # dW: split-K over the bf16 workspace, k16 steps from zero, the
        # splits added in order
        chunk = -(-(-(-K // plan.splits)) // 64) * 64
        outer = _op(_op(hid)[:, None, :] * x[None]).reshape(h * f, K)
        dw = torch.zeros(m, h * f)
        for k0 in range(0, K, chunk):
            part = torch.zeros(m, h * f)
            for s in range(k0, min(k0 + chunk, K), 16):
                part += dcb[:, s:s + 16] @ outer[:, s:s + 16].T
            dw += part
        dws[i] = dw
    dx0 = dx0[0] + dx0[1] + dhid_next
    return (dx0.reshape(f, bsz, d).permute(1, 0, 2).to(torch.bfloat16), dws,
            dbs)


def _within_bwd_tol(got, want, low):
    a, w = got.float(), want.float()
    err = (a - w).abs()
    scale = w.abs().max().clamp_min(1e-30)
    outside = (err > BWD_TOL["atol_rel"] * scale + BWD_TOL["rtol"] * w.abs())
    assert outside.float().mean().item() <= BWD_TOL["outside_share"]
    assert (err.mean() / w.abs().mean()).item() <= BWD_TOL["mean_rel"]
    if low:
        assert (err > 0).float().mean().item() <= BWD_TOL["differ_share"]


@pytest.mark.parametrize("batch,f,d,layers,split", [
    (9, 13, 16, (10, 7), True),
    (10, 27, 16, (40, 24), True),
    (7, 27, 10, (16, 12, 8), False),
    (3, 5, 40, (20,), False),
    # the paper's Criteo CIN: the streamed layout
    (6, 39, 10, (200, 200, 200), False),
    # the streamed layout at a tile of 64 columns
    (4, 40, 8, (256, 256), False),
])
def test_kernel_order_of_work_matches_plain(batch, f, d, layers, split):
    rng = np.random.default_rng(batch * 7 + f)
    direct, nxt = cin_layer_sizes(layers, split)
    x0 = torch.from_numpy(rng.normal(size=(batch, f, d)).astype(np.float32))
    x0 = x0.to(torch.bfloat16)
    ws, bs, h = [], [], f
    for i, m in enumerate(layers):
        bound = (h * f) ** -0.5
        ws.append(torch.from_numpy(rng.uniform(-bound, bound, (m, h * f))
                                   .astype(np.float32)))
        bs.append(torch.from_numpy(rng.uniform(-bound, bound, (m,))
                                   .astype(np.float32)))
        h = nxt[i]
    g = torch.from_numpy(rng.normal(size=(batch, sum(direct)))
                         .astype(np.float32))
    want = cin_stack_backward_plain(x0, ws, bs, g, layers, split, True)
    got = _kernel_order_backward(x0, ws, bs, g, layers, split)
    _within_bwd_tol(got[0], want[0], low=True)
    for a, w in zip(got[1] + got[2], want[1] + want[2]):
        _within_bwd_tol(a, w, low=False)


@pytest.mark.parametrize("split", [True, False])
def test_plain_backward_under_given_masks(split):
    """``masks`` stand in for the plain remat's comp > 0 (chip_smoke.py
    passes the tensor-core kernel's): its own masks give its own bits, and
    the last layer masked out gives that layer's dW and db as 0 and no
    gradient below it, while the masks before it still hold."""
    from deepfm_tpu_torch.ops.cin import cin_compress

    layers = (8, 6)
    rng = np.random.default_rng(11)
    x0 = torch.from_numpy(rng.normal(size=(5, 4, 8)).astype(np.float32))
    x0 = x0.to(torch.bfloat16)
    direct, nxt = cin_layer_sizes(layers, split)
    ws = [torch.randn(8, 16), torch.randn(6, nxt[0] * 4)]
    bs = [torch.randn(8), torch.randn(6)]
    g = torch.randn(5, sum(direct))

    def op(t):
        return t.to(torch.bfloat16).float()

    own, hidden = [], x0.float()
    for i in range(len(layers)):
        pre = cin_compress(op(hidden), x0.float(), op(ws[i]), bs[i], op)
        own.append(pre > 0)
        hidden = torch.relu(pre)[:, direct[i]:] if split and i == 0 \
            else torch.relu(pre)
    want = cin_stack_backward_plain(x0, ws, bs, g, layers, split, True)
    got = cin_stack_backward_plain(x0, ws, bs, g, layers, split, True,
                                   masks=own)
    for a, b in zip([got[0], *got[1], *got[2]],
                    [want[0], *want[1], *want[2]]):
        assert torch.equal(a, b)
    cut = cin_stack_backward_plain(x0, ws, bs, g, layers, split, True,
                                   masks=[own[0], torch.zeros_like(own[1])])
    assert not cut[1][1].any() and not cut[2][1].any()
    # layer 0 takes only its own columns' cotangent: its db is the sum of
    # g's first direct columns over d under its mask
    gd = g[:, :direct[0], None].expand(-1, -1, 8)
    if split:
        gd = torch.cat([gd, torch.zeros(5, 8 - direct[0], 8)], dim=1)
    torch.testing.assert_close(cut[2][0], (gd * own[0]).sum(dim=(0, 2)))


def test_cin_stack_bwd_mma_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(6)
    x0 = torch.from_numpy(rng.normal(size=(6, 5, 8)).astype(np.float32))
    x0 = x0.to(torch.bfloat16)
    ws = [torch.randn(8, 25), torch.randn(6, 20)]
    bs = [torch.randn(8), torch.randn(6)]
    g = torch.randn(6, 4 + 6)
    before = (cin_stack_bwd_mma.launches, cin_stack_backward.launches)
    got = cin_stack_backward(x0, ws, bs, g, (8, 6), True, True)
    want = cin_stack_backward_plain(x0, ws, bs, g, (8, 6), True, True)
    mine = cin_stack_bwd_mma(x0, ws, bs, g, (8, 6), True)
    for a, b, c in zip([got[0], *got[1], *got[2]],
                       [want[0], *want[1], *want[2]],
                       [mine[0], *mine[1], *mine[2]]):
        assert torch.equal(a, b) and torch.equal(c, b)
    # no kernel ran on the CPU
    assert (cin_stack_bwd_mma.launches, cin_stack_backward.launches) == before
    with pytest.raises(TypeError, match="bfloat16"):
        cin_stack_bwd_mma(x0.float(), ws, bs, g, (8, 6), True)
