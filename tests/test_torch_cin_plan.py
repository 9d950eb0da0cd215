"""The bf16 CIN-stack forward on the tensor cores: its plan, its weight
re-layout and its order of work, on the CPU.

``forward_plan`` (ops/kernels/cin_stack.py) sets the kernel's tile and
shared memory; the C launch recomputes it. It must take every shape that
``stack_route`` sends down the "stack" route in the forward. ``mma_weight``
re-lays each weight out as (round_up(M, 16), H * round_up(F, 16)) bf16
with zeros in the pads. ``_blocked_forward`` below repeats the kernel's
order of work (csrc/cin_stack_fwd_mma.cu) in PyTorch on that re-layout:
k16 steps f-chunk first, passes of ``rows`` maps and ``columns`` columns,
pooled sums added in column-pass order. It is held against the plain bf16
version at rtol 2^-7 / atol 1e-3, the element-wise part of chip_smoke.py's
``CIN_TOL["bfloat16"]``: the same rounded operands, summed in another
order. The kernel itself runs only on the card
(tests/test_torch_cin.py, marker ``cuda``).
"""

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.ops.cin import cin_layer_sizes
from deepfm_tpu_torch.ops.kernels.cin_stack import (
    SMEM_PER_BLOCK,
    cin_stack_forward,
    cin_stack_mma,
    cin_stack_plain,
    forward_plan,
    mma_weight,
    stack_route,
    stack_smem,
)

torch.set_num_threads(1)

BF16_KERNEL_TOL = dict(rtol=2.0 ** -7, atol=1e-3)

# (name, batch, F, D, layer_sizes, split_half): chip_smoke.py's CIN shapes
MAIN_SHAPES = [
    ("bench", 16384, 27, 16, (128, 128), True),
    ("paper", 4096, 27, 10, (200, 200, 200), False),
    ("serving", 4096, 16, 16, (128, 128, 64), True),
    ("ragged", 1000, 13, 16, (10, 7), True),
]

# shapes on either side of the stack route's edge, and odd ones
EDGE_SHAPES = [
    (16, 4, 4, (224, 224, 224), False),
    (1024, 27, 16, (512,), False),
    (8, 27, 16, (256, 256, 256), False),
    (3, 13, 16, (10, 7), True),
    (5, 4, 300, (8,), False),
    (1, 40, 64, (300, 300), True),
    (4096, 27, 10, (256, 128), True),
    (7, 1, 19000, (1,), False),            # one field, one map, wide d
    (64, 450, 16, (228,), False),          # wide F at the edge
    (64, 16, 16, (446, 446), False),       # wide hidden state at the edge
    (64, 200, 1, (300, 300, 300), True),
    (2, 2, 100, (200, 200), False),
]


def _check_plan(plan, batch, f, d, layers, split):
    direct, nxt = cin_layer_sizes(layers, split)
    assert plan.columns in (32, 64, 128)
    assert (plan.warps, plan.warp_tiles) in ((8, 4), (12, 5))
    assert plan.ntp % plan.columns == 0
    assert plan.tile_b >= 1 and plan.tile_b * d <= plan.ntp
    assert plan.tile_b == 1 or plan.tile_b * d <= plan.columns
    assert plan.tile_b <= batch
    assert plan.rows % 16 == 0 and 16 <= plan.rows
    assert plan.rows <= plan.warps // (plan.columns // 32) * 16 * plan.warp_tiles
    if plan.warps == 8:  # two blocks an SM, every layer in one pass
        assert plan.smem <= 115_712 and plan.columns == 128
        assert plan.rows >= max(layers)
    assert plan.chunk * 16 == plan.columns
    hn = max(nxt[:-1], default=0)
    r16 = lambda n: -(-n // 16) * 16  # noqa: E731
    want = (r16(2 * f * plan.ntp) + 2 * r16(2 * hn * plan.ntp)
            + 4 * plan.rows * plan.columns + r16(4 * plan.tile_b * max(direct)))
    assert plan.smem == want <= SMEM_PER_BLOCK


@pytest.mark.parametrize("name,batch,f,d,layers,split", MAIN_SHAPES)
def test_forward_plan_at_the_main_shapes(name, batch, f, d, layers, split):
    plan = forward_plan(batch, f, d, layers, split)
    _check_plan(plan, batch, f, d, layers, split)
    # the blocks cover the batch
    assert -(-batch // plan.tile_b) * plan.tile_b >= batch
    # the widest pass fits these shapes: 128 columns, every map in one pass
    assert plan.columns == 128
    assert plan.rows == -(-max(layers) // 16) * 16
    assert stack_route(batch, f, d, layers, split, False) == "stack"
    expected = {"bench": (8, 128, 8), "paper": (12, 128, 12),
                "serving": (8, 128, 8), "ragged": (8, 128, 8)}[name]
    assert (plan.tile_b, plan.ntp, plan.warps) == expected


@pytest.mark.parametrize("batch,f,d,layers,split", EDGE_SHAPES)
def test_forward_plan_takes_every_stack_shape(batch, f, d, layers, split):
    """Wherever stack_smem's forward count fits, forward_plan fits."""
    fits = stack_smem(batch, f, d, layers, split, False)[2] <= SMEM_PER_BLOCK
    if fits:
        _check_plan(forward_plan(batch, f, d, layers, split),
                    batch, f, d, layers, split)
    else:
        assert stack_route(batch, f, d, layers, split, False) == "layers"


@pytest.mark.parametrize("seed", range(4))
def test_forward_plan_takes_random_stack_shapes(seed):
    rng = np.random.default_rng(seed)
    taken = 0
    for _ in range(300):
        n = int(rng.integers(1, 5))
        layers = tuple(int(m) for m in rng.integers(1, 480, n))
        split = bool(rng.integers(0, 2))
        f = int(rng.integers(1, 500))
        d = int(rng.choice([1, 4, 10, 16, 33, 64, 100, 300, 2000]))
        batch = int(rng.integers(1, 5000))
        if stack_route(batch, f, d, layers, split, False) != "stack":
            continue
        taken += 1
        _check_plan(forward_plan(batch, f, d, layers, split),
                    batch, f, d, layers, split)
    assert taken > 20


def test_forward_plan_refuses_what_does_not_fit_and_routes_stay():
    with pytest.raises(ValueError, match="shared memory"):
        forward_plan(64, 2000, 16, (1000, 1000), False)
    # the paper's CIN: the forward on the stack; the backward by layers in
    # f32, on the stack in the bf16 operand mode
    assert stack_route(4096, 27, 10, (200,) * 3, False, False) == "stack"
    assert stack_route(4096, 27, 10, (200,) * 3, False, True) == "layers"
    assert stack_route(4096, 27, 10, (200,) * 3, False, False,
                       bf16=True) == "stack"
    assert stack_route(4096, 27, 10, (200,) * 3, False, True,
                       bf16=True) == "stack"


@pytest.mark.parametrize("m,h,f", [(200, 27, 27), (128, 64, 27), (7, 13, 13),
                                   (16, 5, 16), (33, 3, 1)])
def test_mma_weight_round_trips_with_zero_pads(m, h, f):
    w = torch.from_numpy(
        np.random.default_rng(m + h + f).normal(size=(m, h * f))
        .astype(np.float32))
    r = mma_weight(w, f)
    mp, fp = -(-m // 16) * 16, -(-f // 16) * 16
    assert r.dtype == torch.bfloat16 and tuple(r.shape) == (mp, h * fp)
    r3 = r.reshape(mp, h, fp)
    assert torch.equal(r3[:m, :, :f].reshape(m, h * f),
                       w.to(torch.bfloat16))
    assert not r3[m:].any() and not r3[:, :, f:].any()


def test_mma_weight_is_cached_until_the_weight_changes():
    w = torch.randn(20, 3 * 5)
    a = mma_weight(w, 5)
    assert mma_weight(w, 5) is a
    with torch.no_grad():
        w.mul_(2)  # an optimizer step
    b = mma_weight(w, 5)
    assert b is not a
    assert torch.equal(b.reshape(32, 3, 16)[:20, :, :5].reshape(20, 15),
                       w.to(torch.bfloat16))


def _op(t):
    return t.to(torch.bfloat16).float()


def _blocked_forward(x0, weights, biases, layers, split):
    """The kernel's order of work on the CPU: per block of plan.tile_b
    samples, per column pass and pass of plan.rows maps, the f32 sum over
    k16 steps f-chunk first of W's stage rows times op(hid[h] * x0[f])."""
    bsz, f, d = x0.shape
    plan = forward_plan(bsz, f, d, layers, split)
    direct, nxt = cin_layer_sizes(layers, split)
    fp = -(-f // 16) * 16
    out = torch.zeros(bsz, sum(direct))
    for b0 in range(0, bsz, plan.tile_b):
        nb = min(plan.tile_b, bsz - b0)
        xs = torch.zeros(fp, plan.ntp)  # x0 of the tile, zero pads
        xs[:f, : nb * d] = x0[b0:b0 + nb].float().permute(1, 0, 2).reshape(f, -1)
        hid, h, col = xs[:f], f, 0
        for i, m in enumerate(layers):
            wr = mma_weight(weights[i], f).float()
            mp = wr.shape[0]
            bias = torch.zeros(mp)
            bias[:m] = biases[i].float()
            comp = torch.zeros(mp, plan.ntp)
            pool = torch.zeros(nb, direct[i])
            for cp0 in range(0, plan.ntp, plan.columns):
                cols = slice(cp0, cp0 + plan.columns)
                for m0 in range(0, mp, plan.rows):
                    rows = slice(m0, min(m0 + plan.rows, mp))
                    acc = torch.zeros(rows.stop - m0, plan.columns)
                    for fc in range(fp // 16):
                        for hh in range(h):
                            k = hh * fp + fc * 16
                            bmat = _op(hid[hh, cols][None]
                                       * xs[fc * 16:fc * 16 + 16, cols])
                            acc += wr[rows, k:k + 16] @ bmat
                    comp[rows, cols] = torch.relu(acc + bias[rows, None])
                # each sample's columns in this pass, added in pass order
                for bl in range(nb):
                    lo, hi = max(bl * d, cp0), min(bl * d + d, cp0 + plan.columns)
                    if lo < hi:
                        pool[bl] += comp[: direct[i], lo:hi].sum(dim=1)
            out[b0:b0 + nb, col:col + direct[i]] = pool
            col += direct[i]
            hid = _op(comp[m - nxt[i]:m])
            h = nxt[i]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("batch,f,d,layers,split", [
    (10, 27, 16, (40, 24), True),
    (13, 27, 10, (40, 40), False),
    (9, 13, 16, (10, 7), True),
    (3, 5, 300, (20,), False),
    (5, 3, 4, (16, 8, 6), True),
])
def test_kernel_order_of_work_matches_plain(batch, f, d, layers, split):
    rng = np.random.default_rng(batch * 7 + f)
    x0 = torch.from_numpy(rng.normal(size=(batch, f, d)).astype(np.float32))
    x0 = x0.to(torch.bfloat16)
    _, nxt = cin_layer_sizes(layers, split)
    ws, bs, h = [], [], f
    for i, m in enumerate(layers):
        bound = (h * f) ** -0.5
        ws.append(torch.from_numpy(rng.uniform(-bound, bound, (m, h * f))
                                   .astype(np.float32)))
        bs.append(torch.from_numpy(rng.uniform(-bound, bound, (m,))
                                   .astype(np.float32)))
        h = nxt[i]
    want = cin_stack_plain(x0, ws, bs, layers, split, bf16_operands=True)
    got = _blocked_forward(x0, ws, bs, layers, split)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **BF16_KERNEL_TOL)


def test_cin_stack_mma_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.normal(size=(6, 5, 8)).astype(np.float32))
    x0 = x0.to(torch.bfloat16)
    ws = [torch.randn(8, 25), torch.randn(6, 20)]
    bs = [torch.randn(8), torch.randn(6)]
    before = (cin_stack_mma.launches, cin_stack_forward.launches)
    got = cin_stack_forward(x0, ws, bs, (8, 6), True, bf16_operands=True)
    want = cin_stack_plain(x0, ws, bs, (8, 6), True, bf16_operands=True)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(cin_stack_mma(x0, ws, bs, (8, 6), True), want)
    # no kernel ran on the CPU
    assert (cin_stack_mma.launches, cin_stack_forward.launches) == before
    with pytest.raises(TypeError, match="bfloat16"):
        cin_stack_mma(x0.float(), ws, bs, (8, 6), True)
