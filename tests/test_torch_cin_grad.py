"""The port's CIN-stack backward against the JAX package's.

On the CPU the port's ``cin_stack_backward`` runs its plain version; it is
held against ``jax.vjp`` of the JAX fused stack (``make_cin_stack_pallas``,
whose backward Pallas kernel runs in interpret mode on the CPU, where
``stack_tile`` takes the whole batch). Inputs, weights and the output
cotangent are made with numpy from a seed and handed to both packages.

Tolerances:
  * f32: each gradient within rtol 2e-4 / atol 1e-5 * max|JAX gradient|,
    the forward's f32 tolerance (tests/test_torch_cin.py) on the gradient's
    own scale: the same f32 sums (up to B*D*H*F terms) in another order;
    measured here at most 4e-6 relative to the largest element.
  * bf16 (layers (32, 32), D=16: a geometry the JAX kernel runs in bf16):
    max|port - JAX| <= 1e-3 * max|JAX| for each gradient. The two round at
    the same points and accumulate in f32 in another order; measured here
    2e-7. The f32 gradient lies 7e-2 to 1.4e-1 away, so the check sees a
    missing rounding point.
  * ``CinStackFn`` against autograd through the plain forward, f32: rtol
    1e-5 / atol 1e-7 (the same arithmetic written as explicit adjoints).

The CUDA kernel against its plain version (marker ``cuda``; it skips
here), and bit for bit on a second launch:
``python -m pytest --noconftest tests/test_torch_cin_grad.py -m cuda``.
The rule of chip_smoke.py's CIN_BWD_TOL: in f32 each output within rtol
2e-4 / atol 1e-5 * scale on all but 0.1 % of its elements, with a mean
relative error sum|diff| / sum|plain| <= 1e-4; in bf16 within 2^-7 / 1e-3 *
scale (an ulp of the bf16 operands) on all but 1 %, mean relative error
<= 1e-3, and at most 1 % of the bf16 dx0 elements differing at all. The
kernel and the plain version recompute comp in another summation order, so
a comp within rounding of 0 may take the other side of the ReLU mask,
which moves a whole row of dW: at (128, 128), B=257 on an H100, 18 of
111,024 bf16 dx0 elements fell outside and dW0's mean relative error read
1.9e-4.
"""

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.ops.cin import CIN, cin_layer_sizes
from deepfm_tpu_torch.ops.kernels.cin_stack import (
    cin_stack_backward,
    cin_stack_backward_plain,
    cin_stack_forward,
    cin_stack_plain,
    plan_backward,
)

torch.set_num_threads(1)

# (layer_sizes, split_half, B, F, D), as tests/test_torch_cin.py
CASES = [
    ((8,), False, 6, 5, 16),
    ((8, 6), True, 6, 5, 16),
    ((8, 6), False, 5, 5, 8),
    ((16, 8, 8), True, 7, 6, 16),
    ((16, 8, 4), False, 4, 7, 4),
    ((7, 10), True, 9, 13, 16),
]
F32_RTOL, F32_ATOL_REL = 2e-4, 1e-5
BF16_REL = 1e-3


def _inputs(seed, layers, split, b, f, d):
    rng = np.random.default_rng(seed)
    direct, next_sizes = cin_layer_sizes(layers, split)
    ws, bs, h = [], [], f
    for i, m in enumerate(layers):
        bound = 1.0 / np.sqrt(h * f)
        ws.append(rng.uniform(-bound, bound, (m, h * f)).astype(np.float32))
        bs.append(rng.uniform(-bound, bound, (m,)).astype(np.float32))
        h = next_sizes[i]
    x0 = rng.normal(size=(b, f, d)).astype(np.float32)
    g = rng.normal(size=(b, sum(direct))).astype(np.float32)
    return x0, ws, bs, g


def _jax_grads(x0, ws, bs, g, layers, split, bf16=False):
    import jax
    import jax.numpy as jnp

    from deepfm_tpu.ops.pallas.cin_stack_kernel import make_cin_stack_pallas

    dt = jnp.bfloat16 if bf16 else jnp.float32
    fn = make_cin_stack_pallas(layers, split, bf16_operands=bf16)
    _, vjp = jax.vjp(fn, jnp.asarray(x0, dt), [jnp.asarray(w) for w in ws],
                     [jnp.asarray(v) for v in bs])
    dx0, dws, dbs = vjp(jnp.asarray(g, dt))
    as32 = lambda t: np.asarray(t.astype(jnp.float32))  # noqa: E731
    return as32(dx0), [as32(t) for t in dws], [as32(t) for t in dbs]


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _assert_close(got, want, rtol, atol_rel, what):
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * max(np.abs(want).max(), 1e-30),
        err_msg=what)


def _max_rel(got, want):
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("layers,split,b,f,d", CASES)
def test_plain_backward_matches_jax_stack_kernel(layers, split, b, f, d):
    x0, ws, bs, g = _inputs(0, layers, split, b, f, d)
    jdx, jdws, jdbs = _jax_grads(x0, ws, bs, g, layers, split)
    dx0, dws, dbs = cin_stack_backward(
        torch.from_numpy(x0), _torch(ws), _torch(bs), torch.from_numpy(g),
        layers, split)
    assert dx0.shape == x0.shape and dx0.dtype == torch.float32
    _assert_close(dx0.numpy(), jdx, F32_RTOL, F32_ATOL_REL, "dx0")
    for i, (got, want) in enumerate(zip(dws, jdws)):
        assert got.shape == ws[i].shape
        _assert_close(got.numpy(), want, F32_RTOL, F32_ATOL_REL, f"dW{i}")
    for i, (got, want) in enumerate(zip(dbs, jdbs)):
        _assert_close(got.numpy(), want, F32_RTOL, F32_ATOL_REL, f"db{i}")


def test_plain_backward_bf16_matches_jax():
    layers, split, b, f, d = (32, 32), True, 8, 5, 16
    x0, ws, bs, g = _inputs(2, layers, split, b, f, d)
    # both sides see the same bf16 inputs and cotangent
    x0 = np.asarray(torch.from_numpy(x0).bfloat16().float())
    g = np.asarray(torch.from_numpy(g).bfloat16().float())
    jdx, jdws, jdbs = _jax_grads(x0, ws, bs, g, layers, split, bf16=True)
    xb = torch.from_numpy(x0).bfloat16()
    dx0, dws, dbs = cin_stack_backward_plain(
        xb, _torch(ws), _torch(bs), torch.from_numpy(g), layers, split, True)
    assert dx0.dtype == torch.bfloat16
    assert dws[0].dtype == dbs[0].dtype == torch.float32
    got = [dx0.float().numpy(), *[t.numpy() for t in dws + dbs]]
    want = [jdx, *jdws, *jdbs]
    for k, (a, w) in enumerate(zip(got, want)):
        assert _max_rel(a, w) <= BF16_REL, (k, _max_rel(a, w))
    # and the bf16 rounding points matter: the f32 gradients are far off
    f32 = cin_stack_backward_plain(
        xb.float(), _torch(ws), _torch(bs), torch.from_numpy(g), layers,
        split)
    assert _max_rel(f32[0].numpy(), jdx) > 10 * BF16_REL
    assert _max_rel(f32[1][1].numpy(), jdws[1]) > 10 * BF16_REL


@pytest.mark.parametrize("layers,split,b,f,d", CASES[:4])
def test_cin_stack_fn_matches_autograd_through_plain(layers, split, b, f, d):
    x0, ws, bs, g = _inputs(1, layers, split, b, f, d)

    def leaves():
        return [t.requires_grad_() for t in _torch([x0, *ws, *bs])]

    n = len(layers)
    mine = leaves()
    out = cin_stack_forward(mine[0], mine[1:1 + n], mine[1 + n:], layers,
                            split)
    assert "CinStackFn" in out.grad_fn.name()
    out.backward(torch.from_numpy(g))
    ref = leaves()
    want = torch.autograd.grad(
        cin_stack_plain(ref[0], ref[1:1 + n], ref[1 + n:], layers, split),
        ref, torch.from_numpy(g))
    for t, w in zip(mine, want):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_cin_module_trains_through_the_stack_function():
    """CIN in train mode: the gradient reaches the conv leaves through
    CinStackFn, and is the plain backward's."""
    layers, split, b, f, d = (8, 6), True, 6, 5, 16
    x0, ws, bs, g = _inputs(3, layers, split, b, f, d)
    cin = CIN(num_fields=f, layer_sizes=layers, split_half=split)
    cin.load_state_dict({
        **{f"conv_{i}_kernel": torch.from_numpy(w) for i, w in enumerate(ws)},
        **{f"conv_{i}_bias": torch.from_numpy(v) for i, v in enumerate(bs)},
    })
    cin.train()
    x = torch.from_numpy(x0).requires_grad_()
    cin(x).backward(torch.from_numpy(g))
    dx0, dws, dbs = cin_stack_backward_plain(
        torch.from_numpy(x0), _torch(ws), _torch(bs), torch.from_numpy(g),
        layers, split)
    assert torch.equal(x.grad, dx0)
    for i in range(len(layers)):
        assert torch.equal(getattr(cin, f"conv_{i}_kernel").grad, dws[i])
        assert torch.equal(getattr(cin, f"conv_{i}_bias").grad, dbs[i])


def test_cin_flag_off_refuses_non_cpu_tensors_in_training():
    cin = CIN(num_fields=3, layer_sizes=(4,), split_half=False,
              use_kernel=False)
    cin.train()
    x = torch.zeros(2, 3, 4, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="only on the CPU"):
        cin(x)
    with pytest.raises(ValueError, match="unsupported device"):
        cin_stack_backward(torch.zeros(2, 3, 4, device="meta"),
                           [torch.zeros(4, 9, device="meta")],
                           [torch.zeros(4, device="meta")],
                           torch.zeros(2, 4, device="meta"), (4,), False)


def test_plan_backward_fits_the_bench_shape_and_refuses_oversize():
    tile_b, ntp, smem, splits = plan_backward(16384, 27, 16, (128, 128), True)
    assert (tile_b, ntp) == (8, 128)
    # x0, the hidden state (dhid is written over it), dcomp and dx0 as f32
    # rows of 128 columns, a sign bit per element of layer 0's comp, and
    # one region for the remat's stages (32 rows of K by 128 maps and by
    # 128 columns, two of each) or a chunk of A (4 hidden rows: 112 rows)
    # with its two weight stages of 32 maps by 14 row groups: one block an
    # SM
    region = max(2 * 32 * (128 + 128), 112 * 128 + 2 * 32 * 8 * 14)
    assert smem == 4 * (128 * (27 + 64 + 128 + 27) + 128 * 4 + region)
    assert smem + 1024 <= 233_472 < 2 * (smem + 1024)
    # dW: each layer's grid (6 and 14 tiles of 128 maps by 128 outer rows)
    # times its splits in the fewest rounds of 2 blocks on each of 132 SMs
    # for their columns
    assert splits == (44, 56)
    assert plan_backward(3, 13, 16, (10, 7), True)[3] == (1, 1)
    with pytest.raises(ValueError, match="shared memory"):
        plan_backward(8, 27, 16, (256, 256, 256), False)


def test_empty_batch_gives_zero_gradients():
    x0, ws, bs, g = _inputs(4, (8, 6), True, 3, 5, 16)
    dx0, dws, dbs = cin_stack_backward(
        torch.zeros(0, 5, 16), _torch(ws), _torch(bs), torch.zeros(0, 10),
        (8, 6), True)
    assert dx0.shape == (0, 5, 16)
    assert all(not t.any() for t in dws + dbs)


# bf16 shapes of the tensor-core backward on the card, beside CASES: a
# small bench-like shape, the ragged shape, a three-layer no-split D=10
# shape, and plans off the main path (three remat passes of maps, a sample
# wider than a column pass, 1 and 3 hidden rows, g not staged)
CUDA_BF16_CASES = [
    ((128, 128), True, 257, 27, 16),
    ((10, 7), True, 1000, 13, 16),
    ((64, 48, 32), False, 100, 27, 10),
    ((200, 200), True, 50, 13, 16),
    ((24, 16), True, 5, 5, 300),
    ((6, 4), True, 20, 3, 16),   # 3 fields: A's stages of 4 row tiles
    ((4,), False, 33, 1, 8),     # one field
    ((345,), False, 40, 50, 4),  # the cotangent read from device memory
]


@pytest.mark.cuda
def test_cin_stack_backward_kernel_matches_plain_on_cuda():
    """Kernels against their plain version on the card, f32 and bf16, ragged
    batches and odd splits; a second launch gives the same bits, and each
    call launches its own kernel (bf16: cin_stack_bwd_mma, f32:
    cin_stack_backward's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU launch")
    from deepfm_tpu_torch.ops.kernels.cin_stack import cin_stack_bwd_mma

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [(c, bf16) for c in CASES + [((32, 32), True, 33, 5, 16),
                                         ((128, 128), True, 257, 27, 16)]
             for bf16 in (False, True)]
    cases += [(c, True) for c in CUDA_BF16_CASES]
    for (layers, split, b, f, d), bf16 in cases:
        x0, ws, bs, g = _inputs(5, layers, split, b, f, d)
        ws = [t.cuda() for t in _torch(ws)]
        bs = [t.cuda() for t in _torch(bs)]
        gg = torch.from_numpy(g).cuda()
        x = torch.from_numpy(x0).cuda()
        x = x.bfloat16() if bf16 else x
        rtol, atol_rel = (2.0 ** -7, 1e-3) if bf16 else (2e-4, 1e-5)
        rtol_share, mean_rel = (1e-2, 1e-3) if bf16 else (1e-3, 1e-4)
        want = cin_stack_backward_plain(x, ws, bs, gg, layers, split, bf16)
        before = (cin_stack_bwd_mma.launches, cin_stack_backward.launches)
        got = cin_stack_backward(x, ws, bs, gg, layers, split, bf16)
        again = cin_stack_backward(x, ws, bs, gg, layers, split, bf16)
        torch.cuda.synchronize()
        launched = (cin_stack_bwd_mma.launches - before[0],
                    cin_stack_backward.launches - before[1])
        what = f"{layers} split={split} B={b} F={f} D={d} bf16={bf16}"
        assert launched == ((2, 0) if bf16 else (0, 2)), (what, launched)
        for k, (a, w, a2) in enumerate(zip(
                [got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]],
                [again[0], *again[1], *again[2]])):
            out = f"{what} out {k}"
            assert torch.equal(a, a2), out
            a, w = a.float(), w.float()
            err = (a - w).abs()
            outside = err > atol_rel * w.abs().max() + rtol * w.abs()
            assert outside.float().mean().item() <= rtol_share, out
            assert (err.sum() / w.abs().sum()).item() <= mean_rel, out
            if bf16 and k == 0:  # dx0, in bf16
                assert (err > 0).float().mean().item() <= 1e-2, out


def test_backward_weight_chunks_are_aligned_and_padded():
    """The f32 kernel's m-major weight copy: chunks of HIDDEN_CHUNK hidden
    rows (HIDDEN_CHUNK * F columns), each zero-padded to a multiple of 8."""
    from deepfm_tpu_torch.ops.kernels.cin_stack import HIDDEN_CHUNK, _chunked

    m, h, f = 5, 7, 13
    w = torch.arange(m * h * f, dtype=torch.float32).reshape(m, h * f) + 1
    out = _chunked(w, h, f)
    width = HIDDEN_CHUNK * f
    padded = -(-width // 8) * 8
    chunks = -(-h // HIDDEN_CHUNK)
    assert out.shape == (m, chunks * padded) and out.dtype == torch.float32
    blocks = out.reshape(m, chunks, padded)
    assert not blocks[:, :, width:].any()
    flat = blocks[:, :, :width].reshape(m, -1)
    assert torch.equal(flat[:, : h * f], w)
    assert not flat[:, h * f:].any()
