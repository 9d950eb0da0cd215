"""The port's per-layer CIN compression against the JAX package's
``cin_compress_pallas``.

On the CPU the port's ``cin_compress_layer`` runs its plain version; the
JAX kernel runs in interpret mode (its CPU tile is the whole batch), as
tests/test_pallas.py runs it. Inputs, weights and the output cotangent are
made with numpy from a seed and handed to both packages.

Tolerances: the forward at rtol 1e-4 / atol 1e-5, tests/test_pallas.py's
for this kernel against its oracle (the same f32 sums in another order);
the gradients of ``CinCompressFn`` against ``jax.vjp`` of the JAX kernel
at rtol 2e-4 / atol 1e-5 * max|JAX gradient| (f32 sums of up to B*D*M
terms, in another order), the port's gradient tolerance
(tests/test_torch_cin_grad.py).

The CUDA kernel against its plain version (marker ``cuda``; it skips
here), twice for the same bits:
``python -m pytest --noconftest tests/test_torch_cin_compress.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.ops.kernels.cin import (
    CinCompressFn,
    cin_compress_layer,
    cin_compress_plain,
    kmajor_weight,
)

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL, GRAD_ATOL_REL = 2e-4, 1e-5

# (B, H, F, D, M): H = F (a first layer), H != F, ragged H / F / M, D = 1
SHAPES = [
    (8, 5, 5, 16, 8),
    (6, 12, 5, 10, 9),
    (5, 13, 13, 10, 7),
    (7, 3, 11, 4, 20),
    (3, 7, 2, 1, 5),
]


def _inputs(seed, b, h, f, d, m):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(h * f)
    hid = rng.normal(size=(b, h, d)).astype(np.float32)
    x0 = rng.normal(size=(b, f, d)).astype(np.float32)
    w = rng.uniform(-bound, bound, (m, h * f)).astype(np.float32)
    bias = rng.uniform(-bound, bound, (m,)).astype(np.float32)
    g = rng.normal(size=(b, m, d)).astype(np.float32)
    return hid, x0, w, bias, g


def _jax_kernel():
    import jax.numpy as jnp

    from deepfm_tpu.ops.pallas.cin_kernel import cin_compress_pallas

    return jnp, cin_compress_pallas


@pytest.mark.parametrize("b,h,f,d,m", SHAPES)
def test_plain_layer_matches_jax_kernel(b, h, f, d, m):
    jnp, cin_compress_pallas = _jax_kernel()
    hid, x0, w, bias, _ = _inputs(0, b, h, f, d, m)
    want = np.asarray(cin_compress_pallas(
        jnp.asarray(hid), jnp.asarray(x0), jnp.asarray(w), jnp.asarray(bias)))
    got = cin_compress_layer(*map(torch.from_numpy, (hid, x0, w, bias)))
    assert got.shape == (b, m, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("b,h,f,d,m", SHAPES)
def test_gradients_match_jax_kernel(b, h, f, d, m):
    import jax

    jnp, cin_compress_pallas = _jax_kernel()
    hid, x0, w, bias, g = _inputs(1, b, h, f, d, m)
    _, vjp = jax.vjp(cin_compress_pallas, *map(jnp.asarray, (hid, x0, w, bias)))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (hid, x0, w, bias)]
    out = cin_compress_layer(*leaves)
    assert "CinCompressFn" in out.grad_fn.name()
    out.backward(torch.from_numpy(g))
    for name, t, wv in zip(("dhid", "dx0", "dW", "db"), leaves, want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(
            t.grad.numpy(), wv, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_REL * np.abs(wv).max(), err_msg=name)


def test_bf16_hidden_is_computed_in_f32_and_returned_in_bf16():
    """As cin_compress_pallas: inputs cast to f32, f32 sums and bias, the
    result cast back to hidden's dtype; gradients in each input's dtype."""
    hid, x0, w, bias, g = _inputs(2, 4, 6, 5, 8, 7)
    hb = torch.from_numpy(hid).bfloat16()
    got = cin_compress_layer(hb, torch.from_numpy(x0), torch.from_numpy(w),
                             torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    want = cin_compress_plain(hb.float(), torch.from_numpy(x0),
                              torch.from_numpy(w), torch.from_numpy(bias))
    assert torch.equal(got, want.bfloat16())
    leaves = [hb.clone().requires_grad_(),
              *[torch.from_numpy(a).requires_grad_() for a in (x0, w, bias)]]
    CinCompressFn.apply(*leaves).backward(torch.from_numpy(g).bfloat16())
    assert [t.grad.dtype for t in leaves] == [torch.bfloat16] + [torch.float32] * 3


def test_wrapper_refuses_other_devices_and_bad_shapes():
    def meta(*shape):
        return torch.zeros(*shape, device="meta")

    with pytest.raises(ValueError, match="unsupported device"):
        cin_compress_layer(meta(2, 3, 4), meta(2, 5, 4), meta(6, 15), meta(6))
    hid, x0, w, bias = (torch.zeros(2, 3, 4), torch.zeros(2, 5, 4),
                        torch.zeros(6, 15), torch.zeros(6))
    with pytest.raises(ValueError, match="weight shape"):
        cin_compress_layer(hid, x0, torch.zeros(6, 14), bias)
    with pytest.raises(ValueError, match="bias shape"):
        cin_compress_layer(hid, x0, w, torch.zeros(5))
    with pytest.raises(ValueError, match="does not match"):
        cin_compress_layer(hid, torch.zeros(3, 5, 4), w, bias)


def test_kmajor_weight_is_padded_and_cached():
    w = torch.arange(5 * 6, dtype=torch.float32).reshape(5, 6) + 1
    wt = kmajor_weight(w, torch.float32)
    assert wt.shape == (6, 8) and not wt[:, 5:].any()
    assert torch.equal(wt[:, :5], w.t())
    assert kmajor_weight(w, torch.float32) is wt
    with torch.no_grad():
        w.add_(1)
    assert torch.equal(kmajor_weight(w, torch.float32)[:, :5], w.t())


# On the card besides SHAPES: one of the paper's layers at a small batch,
# chip_smoke.py's ragged layer, M at and around the plan's 8-map groups and
# 256-map tiles, F past one chunk of fields (33, 40: two blocks; 70: three
# of 24, 24, 22 and x0 staged by chunk), and B*D a multiple of no column
# tile (370 = 37 * 10)
CUDA_SHAPES = SHAPES + [
    (129, 200, 27, 10, 200), (1000, 13, 13, 10, 7),
    *[(37, 9, 7, 10, m) for m in (1, 8, 9, 129, 256, 257)],
    (37, 4, 33, 10, 24), (21, 6, 40, 7, 200), (50, 3, 70, 3, 30),
]


@pytest.mark.cuda
def test_cin_compress_kernel_matches_plain_on_cuda():
    """Kernel against its plain version on the card, f32 in and out and
    bf16 hidden, at CUDA_SHAPES (f32 rtol 2e-4 / atol 1e-5, the CIN
    forward's); a second launch gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU launch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for b, h, f, d, m in CUDA_SHAPES:
        hid, x0, w, bias, _ = (torch.from_numpy(a).cuda()
                               for a in _inputs(3, b, h, f, d, m))
        for dt in (torch.float32, torch.bfloat16):
            hd = hid.to(dt)
            before = cin_compress_layer.launches
            got = cin_compress_layer(hd, x0, w, bias)
            again = cin_compress_layer(hd, x0, w, bias)
            want = cin_compress_plain(hd, x0, w, bias)
            torch.cuda.synchronize()
            assert cin_compress_layer.launches == before + 2
            assert got.dtype == dt and torch.equal(got, again)
            tol = dict(rtol=2e-4, atol=1e-5) if dt == torch.float32 \
                else dict(rtol=2.0 ** -7, atol=1e-3)
            np.testing.assert_allclose(
                got.float().cpu().numpy(), want.float().cpu().numpy(), **tol,
                err_msg=f"B={b} H={h} F={f} D={d} M={m} {dt}")
