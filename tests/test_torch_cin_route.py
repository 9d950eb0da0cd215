"""The CIN stack's two routes: the stack kernels, and layer by layer for a
stack too large for one block's shared memory.

``stack_route`` is one shape predicate shared with the stack kernels'
plans: it says "stack" exactly where ``plan_tile`` (forward) and
``plan_backward`` (backward) do not raise. In the bf16 operand mode the
backward goes by the forward's count and the bf16 kernel's own plan
(``mma_backward_plan``), which fits stacks (the xDeepFM paper's CIN among them) whose f32 count
does not; the f32 mode's route is unchanged. Where it says "layers", the port
runs each layer through ``cin_compress_layer`` (forward) and the JAX
package's ``backward_xla`` algorithm (backward); on the CPU each layer runs
the plain version. That route is held against the JAX ``CIN`` with
``use_pallas_stack=True`` whose ``stack_tile`` is patched to find no tile,
so that the JAX package takes its own TPU fallbacks on the CPU: the jnp
oracle forward, and ``backward_xla`` through ``cin_compress_pallas`` in
interpret mode. Inputs, weights and the output cotangent are made with
numpy from a seed. Tolerance: f32, rtol 2e-4 / atol 1e-5 (the port's CIN
tolerance, tests/test_torch_cin.py): the same sums in another order.
"""

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.ops.cin import CIN, cin_layer_sizes
from deepfm_tpu_torch.ops.kernels import cin_stack
from deepfm_tpu_torch.ops.kernels.cin import cin_compress_plain
from deepfm_tpu_torch.ops.kernels.cin_stack import (
    cin_stack_backward_plain,
    cin_stack_forward,
    cin_stack_plain,
    mma_backward_plan,
    plan_backward,
    plan_tile,
    stack_route,
)

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=1e-5)
PAPER = (27, 10, (200, 200, 200), False)  # F, D, layers, split: Lian et al.

# (batch, F, D, layer_sizes, split_half)
GRID = [
    (4096, *PAPER),
    (16384, 27, 16, (128, 128), True),       # bench.py's xDeepFM
    (4096, 16, 16, (128, 128, 64), True),    # the serving config
    (4096, 27, 10, (256, 128), True),        # DeepCTR's default
    (16, 4, 4, (224, 224, 224), False),      # backward just too large
    (1024, 27, 16, (512,), False),           # forward too large
    (8, 27, 16, (256, 256, 256), False),
    (3, 13, 16, (10, 7), True),
    (5, 4, 300, (8,), False),                # one sample per tile
    (1, 40, 64, (300, 300), True),
]


def _fits(plan, *args) -> bool:
    try:
        plan(*args)
    except ValueError as err:
        assert "shared memory" in str(err)
        return False
    return True


@pytest.mark.parametrize("batch,f,d,layers,split", GRID)
def test_route_is_stack_exactly_where_the_plans_fit(batch, f, d, layers, split):
    fwd = stack_route(batch, f, d, layers, split, backward=False)
    bwd = stack_route(batch, f, d, layers, split, backward=True)
    assert (fwd == "stack") is _fits(plan_tile, batch, f, d, layers)
    assert (bwd == "stack") is _fits(plan_backward, batch, f, d, layers, split)
    assert {fwd, bwd} <= {"stack", "layers"}
    # the bf16 operand mode: the same forward; the backward by the
    # forward's tile and its own plan, "stack" wherever the f32 backward is
    assert stack_route(batch, f, d, layers, split, False, bf16=True) == fwd
    bwd16 = stack_route(batch, f, d, layers, split, True, bf16=True)
    assert (bwd16 == "stack") is (
        _fits(plan_tile, batch, f, d, layers)
        and _fits(mma_backward_plan, batch, f, d, layers, split))
    assert bwd == "layers" or bwd16 == "stack"


def test_paper_cin_forward_fits_and_backward_takes_the_layers_route():
    """In f32; in the bf16 operand mode the backward takes the stack, its
    plan's streamed layout."""
    f, d, layers, split = PAPER
    assert plan_tile(4096, f, d, layers)[2] == 109_312
    assert cin_stack.stack_smem(4096, f, d, layers, split, True)[2] == 250_496
    assert stack_route(4096, f, d, layers, split, False) == "stack"
    assert stack_route(4096, f, d, layers, split, True) == "layers"
    assert stack_route(4096, f, d, layers, split, False, bf16=True) == "stack"
    assert stack_route(4096, f, d, layers, split, True, bf16=True) == "stack"
    plan = mma_backward_plan(4096, f, d, layers, split)
    assert (plan.tile_b, plan.ntp, plan.smem, plan.splits) == (12, 128,
                                                               204_512, 10)
    assert plan.streamed
    # Criteo's 39 fields (the benchmark's xdeepfm-paper configuration)
    assert cin_stack.stack_smem(4096, 39, d, layers, split, True)[2] == 268_928
    assert stack_route(4096, 39, d, layers, split, True) == "layers"
    assert stack_route(4096, 39, d, layers, split, True, bf16=True) == "stack"


@pytest.fixture
def layer_calls(monkeypatch):
    """Counts the stack's calls of the per-layer compression."""
    calls = []
    real = cin_stack.cin_compress_layer

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(cin_stack, "cin_compress_layer", spy)
    return calls


def _inputs(seed, b, f, d, layers, split):
    rng = np.random.default_rng(seed)
    direct, next_sizes = cin_layer_sizes(layers, split)
    params, h = {}, f
    for i, m in enumerate(layers):
        bound = 1.0 / np.sqrt(h * f)
        params[f"conv_{i}_kernel"] = rng.uniform(
            -bound, bound, (m, h * f)).astype(np.float32)
        params[f"conv_{i}_bias"] = rng.uniform(
            -bound, bound, (m,)).astype(np.float32)
        h = next_sizes[i]
    x0 = rng.normal(size=(b, f, d)).astype(np.float32)
    g = rng.normal(size=(b, sum(direct))).astype(np.float32)
    return x0, params, g


def _jax_cin_without_stack_tiles(monkeypatch, x0, params, g, layers, split):
    """Output and gradients (x0, then each parameter) of the JAX CIN on the
    stack kernel's path with no tile found: its TPU fallbacks."""
    import jax
    import jax.numpy as jnp

    import deepfm_tpu.ops.pallas.cin_stack_kernel as jstack
    from deepfm_tpu.ops.cin import CIN as JaxCIN

    monkeypatch.setattr(jstack, "stack_tile", lambda *a, **k: None)
    b, f, d = x0.shape
    jcin = JaxCIN(num_fields=f, embed_dim=d, layer_sizes=layers,
                  split_half=split, use_pallas_stack=True)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    out, vjp = jax.vjp(lambda x, p: jcin.apply({"params": p}, x),
                       jnp.asarray(x0), jparams)
    dx0, dparams = vjp(jnp.asarray(g))
    return (np.asarray(out), np.asarray(dx0),
            {k: np.asarray(v) for k, v in dparams.items()})


def _port_cin(x0, params, g, layers, split):
    f = x0.shape[1]
    cin = CIN(num_fields=f, layer_sizes=layers, split_half=split)
    cin.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    cin.train()
    x = torch.from_numpy(x0).requires_grad_()
    out = cin(x)
    out.backward(torch.from_numpy(g))
    grads = {k: p.grad.numpy() for k, p in cin.named_parameters()}
    return out.detach().numpy(), x.grad.numpy(), grads


@pytest.mark.parametrize("b,f,d,layers,split,fwd_route,calls", [
    # the backward does not fit (plan_backward: 239,104 bytes): the forward
    # runs the stack, the backward recomputes three layers
    (16, 4, 4, (224, 224, 224), False, "stack", 3),
    # the forward does not fit either: one layer forward, one remat
    (8, 27, 4, (512,), False, "layers", 2),
])
def test_layers_route_matches_jax_fallbacks(b, f, d, layers, split, fwd_route,
                                            calls, layer_calls, monkeypatch):
    assert stack_route(b, f, d, layers, split, False) == fwd_route
    assert stack_route(b, f, d, layers, split, True) == "layers"
    x0, params, g = _inputs(0, b, f, d, layers, split)
    want_out, want_dx0, want_grads = _jax_cin_without_stack_tiles(
        monkeypatch, x0, params, g, layers, split)
    out, dx0, grads = _port_cin(x0, params, g, layers, split)
    assert len(layer_calls) == calls
    np.testing.assert_allclose(out, want_out, **TOL)
    np.testing.assert_allclose(dx0, want_dx0, **TOL, err_msg="dx0")
    assert set(grads) == set(want_grads)
    for name, w in want_grads.items():
        np.testing.assert_allclose(grads[name], w, **TOL, err_msg=name)


def test_paper_cin_trains_through_the_layers_route(layer_calls):
    """CinStackFn at the paper's geometry (a batch of 4 has the same tile,
    so the same routes): no ValueError where the stack backward raised; the
    gradients are the plain stack backward's, in f32."""
    f, d, layers, split = PAPER
    x0, params, g = _inputs(1, 4, f, d, layers, split)
    n = len(layers)
    leaves = [torch.from_numpy(x0).requires_grad_(),
              *[torch.from_numpy(params[f"conv_{i}_kernel"]).requires_grad_()
                for i in range(n)],
              *[torch.from_numpy(params[f"conv_{i}_bias"]).requires_grad_()
                for i in range(n)]]
    with pytest.raises(ValueError, match="shared memory"):
        plan_backward(4, f, d, layers, split)
    out = cin_stack_forward(leaves[0], leaves[1:1 + n], leaves[1 + n:],
                            layers, split)
    assert "CinStackFn" in out.grad_fn.name()
    assert not layer_calls  # the forward ran the stack
    x, ws, bs = (torch.from_numpy(x0),
                 [t.detach() for t in leaves[1:1 + n]],
                 [t.detach() for t in leaves[1 + n:]])
    torch.testing.assert_close(out, cin_stack_plain(x, ws, bs, layers, split),
                               **TOL)
    out.backward(torch.from_numpy(g))
    assert len(layer_calls) == n  # one remat per layer
    dx0, dws, dbs = cin_stack_backward_plain(x, ws, bs, torch.from_numpy(g),
                                             layers, split)
    for got, want in zip(leaves, [dx0, *dws, *dbs]):
        torch.testing.assert_close(got.grad, want, **TOL)


@pytest.mark.parametrize("f", [27, 39])
def test_paper_cin_trains_bf16_through_the_stack_backward(f, layer_calls):
    """CinStackFn at the paper's geometry in the bf16 operand mode (a batch
    of 4 has the batch of 4096's tile): the stack route both ways, no
    per-layer call, and the gradients are the plain bf16 stack backward's
    bit for bit on the CPU, where the f32 mode takes the layers route."""
    d, layers, split = PAPER[1:]
    x0, params, g = _inputs(3, 4, f, d, layers, split)
    n = len(layers)
    assert stack_route(4, f, d, layers, split, True) == "layers"
    assert stack_route(4, f, d, layers, split, True, bf16=True) == "stack"
    x = torch.from_numpy(x0).bfloat16()
    ws = [torch.from_numpy(params[f"conv_{i}_kernel"]) for i in range(n)]
    bs = [torch.from_numpy(params[f"conv_{i}_bias"]) for i in range(n)]
    leaves = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
    out = cin_stack_forward(leaves[0], leaves[1:1 + n], leaves[1 + n:],
                            layers, split, bf16_operands=True)
    assert "CinStackFn" in out.grad_fn.name()
    gb = torch.from_numpy(g).bfloat16()
    out.backward(gb)
    assert not layer_calls
    want = cin_stack_backward_plain(x, ws, bs, gb, layers, split,
                                    bf16_operands=True)
    for got, w in zip(leaves, [want[0], *want[1], *want[2]]):
        assert torch.equal(got.grad, w)


def test_layers_forward_hands_on_the_hidden_state_in_x0_dtype(layer_calls):
    """bf16 x0 on the forward's layers route: each layer computed in f32
    and returned in bf16, as cin_compress_pallas does; no bf16 operand
    rounding."""
    x0, params, _ = _inputs(2, 3, 27, 16, (512,), False)
    w, b = (torch.from_numpy(params[k]) for k in ("conv_0_kernel", "conv_0_bias"))
    xb = torch.from_numpy(x0).bfloat16()
    got = cin_stack_forward(xb, [w], [b], (512,), False, bf16_operands=True)
    assert len(layer_calls) == 1 and got.dtype == torch.bfloat16
    comp = cin_compress_plain(xb, xb, w, b)
    assert torch.equal(got, torch.relu(comp).sum(dim=2))
