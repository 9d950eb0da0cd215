"""The port's CIN stack against the JAX package's.

On the CPU the port's ``cin_stack_forward`` runs its plain version; it is
held against the JAX fused-stack forward (``make_cin_stack_pallas``, whose
Pallas kernel runs in interpret mode on the CPU) and against the JAX
``CIN`` on its per-layer ``cin_compress`` path. Inputs and weights are
made with numpy from a seed and handed to both packages.

The JAX package is imported inside the tests that use it, so the CUDA
tests also run on a GPU machine without JAX:
``python -m pytest --noconftest tests/test_torch_cin.py -m cuda``. In bf16
they run the tensor-core kernel (csrc/cin_stack_fwd_mma.cu), held there
also to chip_smoke.py's CIN_TOL["bfloat16"] (element-wise and mean).

Tolerances: f32 at rtol 2e-4 / atol 1e-5, the tolerance of
tests/test_torch_parity.py (sums taken in another order). The port's bf16
mode against the JAX kernel's at rtol 2e-2 / atol 2e-2: the two round
their operands at the same points but accumulate in another order, and
the JAX interpret-mode kernel came within 0.4% of the f32 oracle. The CUDA
kernel against the port's own plain version in bf16 at rtol 2^-7 (one to two
ulps of the bf16 output) / atol 1e-3 (outputs near zero), the element-wise
bound chip_smoke.py holds it to (at least one ulp: an ulp of v is at
most 2^-7 |v|).
"""

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.ops.cin import CIN, cin_layer_sizes
from deepfm_tpu_torch.ops.kernels.cin_stack import (
    COLUMN_CHUNK,
    _relayout,
    cin_stack_forward,
    cin_stack_plain,
    plan_tile,
)

torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_KERNEL_TOL = dict(rtol=2.0 ** -7, atol=1e-3)

# (layer_sizes, split_half, B, F, D)
CASES = [
    ((8,), False, 6, 5, 16),
    ((8,), True, 3, 4, 8),
    ((8, 6), True, 6, 5, 16),
    ((8, 6), False, 5, 5, 8),
    ((16, 8, 8), True, 7, 6, 16),
    ((16, 8, 4), False, 4, 7, 4),
    ((7, 10), True, 9, 13, 16),
]


def _params(seed, f, layer_sizes, split_half):
    rng = np.random.default_rng(seed)
    _, next_sizes = cin_layer_sizes(layer_sizes, split_half)
    ws, bs = [], []
    h = f
    for i, m in enumerate(layer_sizes):
        bound = 1.0 / np.sqrt(h * f)
        ws.append(rng.uniform(-bound, bound, (m, h * f)).astype(np.float32))
        bs.append(rng.uniform(-bound, bound, (m,)).astype(np.float32))
        h = next_sizes[i]
    return ws, bs


def _jax():
    import jax.numpy as jnp

    from deepfm_tpu.ops.cin import CIN as JaxCIN
    from deepfm_tpu.ops.pallas.cin_stack_kernel import make_cin_stack_pallas

    return jnp, JaxCIN, make_cin_stack_pallas


def _x0(seed, b, f, d):
    return np.random.default_rng(seed + 100).normal(size=(b, f, d)).astype(
        np.float32
    )


@pytest.mark.parametrize("layers,split,b,f,d", CASES)
def test_cin_stack_matches_jax_stack_kernel(layers, split, b, f, d):
    jnp, _, make_cin_stack_pallas = _jax()
    x0 = _x0(0, b, f, d)
    ws, bs = _params(0, f, layers, split)
    jfn = make_cin_stack_pallas(layers, split)
    want = np.asarray(
        jfn(jnp.asarray(x0), [jnp.asarray(w) for w in ws],
            [jnp.asarray(v) for v in bs])
    )
    got = cin_stack_forward(
        torch.from_numpy(x0), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(v) for v in bs], layers, split,
    )
    assert got.shape == (b, sum(cin_layer_sizes(layers, split)[0]))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("layers,split,b,f,d", CASES)
def test_cin_module_matches_jax_cin_compress_path(
    layers, split, b, f, d, use_kernel
):
    """Port CIN vs JAX CIN on its per-layer cin_compress path, with the
    same carried-over weights. On the CPU both settings of the kernel flag
    run the port's plain version."""
    jnp, JaxCIN, _ = _jax()
    x0 = _x0(1, b, f, d)
    ws, bs = _params(1, f, layers, split)
    params = {}
    for i, (w, v) in enumerate(zip(ws, bs)):
        params[f"conv_{i}_kernel"] = jnp.asarray(w)
        params[f"conv_{i}_bias"] = jnp.asarray(v)
    jcin = JaxCIN(num_fields=f, embed_dim=d, layer_sizes=layers,
                  split_half=split, use_pallas_stack=False)
    want = np.asarray(jcin.apply({"params": params}, jnp.asarray(x0)))

    cin = CIN(num_fields=f, layer_sizes=layers, split_half=split,
              use_kernel=use_kernel)
    cin.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in params.items()})
    with torch.inference_mode():
        got = cin(torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_cin_stack_bf16_operands_match_jax():
    """bf16 operands on a geometry the JAX kernel runs in bf16 ([32,32]
    split, D=16: every hidden height a multiple of 16)."""
    jnp, _, make_cin_stack_pallas = _jax()
    layers, split, b, f, d = (32, 32), True, 8, 5, 16
    x0 = _x0(2, b, f, d)
    ws, bs = _params(2, f, layers, split)
    jfn = make_cin_stack_pallas(layers, split, bf16_operands=True)
    want = jfn(jnp.asarray(x0, jnp.bfloat16), [jnp.asarray(w) for w in ws],
               [jnp.asarray(v) for v in bs])
    assert want.dtype == jnp.bfloat16
    got = cin_stack_forward(
        torch.from_numpy(x0).to(torch.bfloat16),
        [torch.from_numpy(w) for w in ws], [torch.from_numpy(v) for v in bs],
        layers, split, bf16_operands=True,
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL
    )
    # and bf16 rounding really happened: the f32 answer is further away
    f32 = cin_stack_plain(
        torch.from_numpy(x0), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(v) for v in bs], layers, split,
    )
    assert not torch.equal(got.float(), f32)


def test_plan_tile_covers_shapes_and_refuses_oversize():
    # serving shape: 4 samples of 16 columns fill one column chunk
    tile_b, ntp, smem = plan_tile(4096, 16, 16, (128, 128, 64))
    assert (tile_b, ntp) == (4, COLUMN_CHUNK)
    assert smem == 4 * (16 + 2 * 128) * COLUMN_CHUNK
    # a tiny ragged batch still gets a plan, with one tile
    assert plan_tile(3, 13, 16, (10, 7))[0] == 3
    # D wider than a column chunk: one sample per tile
    assert plan_tile(5, 4, 300, (8,))[:2] == (1, 320)
    with pytest.raises(ValueError, match="shared memory"):
        plan_tile(8, 27, 16, (1024,))


def test_cin_refuses_non_cpu_tensors_with_the_kernel_flag_off():
    """use_cin_kernel=false means the plain version, which the port runs
    on the CPU only; on another device CIN raises instead of falling
    back."""
    cin = CIN(num_fields=3, layer_sizes=(4,), split_half=False,
              use_kernel=False)
    with pytest.raises(ValueError, match="only on the CPU"):
        cin(torch.zeros(2, 3, 4, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        CIN(num_fields=3, layer_sizes=(4,), split_half=False)(
            torch.zeros(2, 3, 4, device="meta"))


def test_relayout_is_cached_until_the_tensor_changes():
    w = torch.arange(6.0).reshape(2, 3)
    calls = []

    def make():
        calls.append(1)
        return w.t().clone()

    a = _relayout(w, ("k",), make)
    assert _relayout(w, ("k",), make) is a and len(calls) == 1
    assert _relayout(w, ("other",), make) is not a and len(calls) == 2
    with torch.no_grad():
        w.mul_(2)  # an in-place update (an optimizer step, load_state_dict)
    b = _relayout(w, ("other",), make)
    assert len(calls) == 3 and torch.equal(b, w.t())
    with torch.inference_mode():
        t = torch.ones(2)  # inference tensors have no version counter
    _relayout(t, ("k",), make)
    _relayout(t, ("k",), make)
    assert len(calls) == 5


def test_cin_stack_wrapper_rejects_bad_shapes():
    x0 = torch.zeros(2, 3, 4)
    ws = [torch.zeros(4, 9)]
    bs = [torch.zeros(4)]
    # the CPU path computes; the shape checks guard the CUDA launch
    from deepfm_tpu_torch.ops.kernels.cin_stack import _check_shapes

    _check_shapes(x0, ws, bs, (4,), [4])
    with pytest.raises(ValueError, match="weight shape"):
        _check_shapes(x0, [torch.zeros(4, 8)], bs, (4,), [4])
    with pytest.raises(ValueError, match="bias shape"):
        _check_shapes(x0, ws, [torch.zeros(5)], (4,), [4])
    with pytest.raises(ValueError, match="CIN layers"):
        _check_shapes(x0, ws * 9, bs * 9, (4,) * 9, [4] * 9)


@pytest.mark.cuda
def test_cin_stack_kernel_matches_plain_on_cuda():
    """Kernel against its plain version on the card, f32 and bf16, ragged
    batches and odd splits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU launch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = CASES + [((32, 32), True, 33, 5, 16), ((128, 128), True, 257, 27, 16)]
    for layers, split, b, f, d in cases:
        x0 = torch.from_numpy(_x0(3, b, f, d)).cuda()
        ws, bs = _params(3, f, layers, split)
        ws = [torch.from_numpy(w).cuda() for w in ws]
        bs = [torch.from_numpy(v).cuda() for v in bs]
        for bf16 in (False, True):
            x = x0.to(torch.bfloat16) if bf16 else x0
            tol = BF16_KERNEL_TOL if bf16 else F32_TOL
            want = cin_stack_plain(x, ws, bs, layers, split, bf16).float()
            got = cin_stack_forward(x, ws, bs, layers, split, bf16)
            torch.cuda.synchronize()
            np.testing.assert_allclose(
                got.float().cpu().numpy(), want.cpu().numpy(), **tol,
                err_msg=f"{layers} split={split} B={b} F={f} D={d} bf16={bf16}",
            )
    # inputs that need a gradient go through CinStackFn and its backward
    w0 = ws[0].clone().requires_grad_()
    out = cin_stack_forward(x0, [w0, *ws[1:]], bs, layers, split)
    assert out.grad_fn is not None and "CinStackFn" in out.grad_fn.name()


# (layer_sizes, split_half, B, F, D): bench.py's CIN at a small batch off
# the 8-sample tile, the ragged shape, the paper's 3 x 200 CIN at D=10;
# then plans off the main path (forward_plan): a sample wider than a column
# pass (3 passes), two passes of maps, 64-column passes, passes of 16 maps
MMA_CASES = [
    ((128, 128), True, 300, 27, 16),
    ((10, 7), True, 1000, 13, 16),
    ((200, 200, 200), False, 100, 27, 10),
    ((20,), False, 3, 5, 300),
    ((300,), False, 40, 27, 16),
    ((446, 446), False, 64, 16, 16),
    ((400, 400), False, 12, 16, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("layers,split,b,f,d", MMA_CASES)
def test_cin_stack_mma_kernel_matches_plain_on_cuda(layers, split, b, f, d):
    """The bf16 tensor-core kernel against the plain bf16 version under
    chip_smoke.py's CIN_TOL["bfloat16"], launched twice with the same bits;
    every launch goes through the bf16 kernel, none through the f32 one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU launch")
    from chip_smoke import CIN_TOL, compare
    from deepfm_tpu_torch.ops.kernels.cin_stack import cin_stack_mma

    torch.backends.cuda.matmul.allow_tf32 = False
    x0 = torch.from_numpy(_x0(4, b, f, d)).cuda().to(torch.bfloat16)
    ws, bs = _params(4, f, layers, split)
    ws = [torch.from_numpy(w).cuda() for w in ws]
    bs = [torch.from_numpy(v).cuda() for v in bs]
    before = (cin_stack_mma.launches, cin_stack_forward.launches)
    got = cin_stack_forward(x0, ws, bs, layers, split, bf16_operands=True)
    again = cin_stack_forward(x0, ws, bs, layers, split, bf16_operands=True)
    torch.cuda.synchronize()
    assert (cin_stack_mma.launches - before[0],
            cin_stack_forward.launches - before[1]) == (2, 0)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    want = cin_stack_plain(x0, ws, bs, layers, split, bf16_operands=True)
    stats = compare(got, want, CIN_TOL["bfloat16"])
    assert stats["ok"], stats
