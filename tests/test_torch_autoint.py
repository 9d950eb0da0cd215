"""The port's AutoInt (``models/autoint.py``, the interacting layers of
``ops/attention.py`` and ``ops/kernels/attention.py``) against the plain
reference of ``tests/autoint_reference.py``, on the CPU.

AutoInt is the port's own model: the JAX package has none, so the
reference is written from the paper and imports nothing of either
package. Tiny shapes: 3 numeric and 4 categorical fields (F = 7),
embedding width 4 (layer 1's input, not the attention width 8), 2 heads
of 4, three layers.

Tolerances, each with its reason:
  * f32 logits: max|port - reference| <= 1e-5 * max|reference|: the same
    f32 arithmetic, its sums in another order (the port concatenates the
    four projections into one product; measured ~1e-7).
  * f32 first gradients, every leaf: max|port - reference| <= 1e-4 *
    max|reference| of the leaf; leaves the logit never reads (the
    first-order weights) are exactly 0 on both sides. Three layers of
    softmax and ReLU adjoints in another order; measured ~1e-6. Dropping
    the softmax adjoint's row-sum term or the projected residual's weight
    gradient moves some leaf by O(1) of its scale: both are refused.
  * bf16 (the kernels' rounding points, the reference rounding where the
    kernels round): a layer output and dx at one bf16 step, 2^-7 of their
    scale; weight gradients (f32 sums of bf16 products) at 1e-4 of their
    scale. Leaving out the rounding of [dq|dk|dv|dres] moves the weight
    gradients by more and is refused.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import autoint_reference as ref
from deepfm_tpu_torch.config import config_from_dict
from deepfm_tpu_torch.data.packing import pack_features, pack_schema
from deepfm_tpu_torch.data.schema import DatasetSchema, FeatureType, FieldSchema
from deepfm_tpu_torch.models import create_model
from deepfm_tpu_torch.ops import attention as attn_mod
from deepfm_tpu_torch.ops.kernels import attention as kattn
from deepfm_tpu_torch.ops.kernels.attention import (
    INTERACT_NAMES,
    BackwardPlan,
    ForwardPlan,
    backward_plan,
    interacting_backward_plan,
    interacting_backward_plain,
    interacting_forward_plan,
    interacting_plain,
)

torch.set_num_threads(1)

D, HEADS, A, LAYERS = 4, 2, 8, 3
NUMERIC = 3
VOCABS = (11, 7, 5, 3)  # each with the reserved id 0
B = 24
LOGIT_REL = 1e-5
GRAD_REL = 1e-4
BF16_STEP = 2.0 ** -7
BF16_GRAD_REL = 1e-4


def _model(compute_dtype="float32"):
    fields = {f"I{i}": FieldSchema(f"I{i}", FeatureType.DENSE, 0, D, "c")
              for i in range(NUMERIC)}
    fields.update({f"C{i}": FieldSchema(f"C{i}", FeatureType.SPARSE, v, D,
                                        "i") for i, v in enumerate(VOCABS)})
    packed = pack_schema(DatasetSchema(fields=fields))
    config = config_from_dict({
        "model_name": "autoint", "device": "cpu", "seed": 3,
        "feature": {"fm_embed_dim": D},
        "attention": {"num_heads": HEADS, "attention_dim": A,
                      "num_layers": LAYERS},
        "dnn": {"hidden_units": []},
        "training": {"batch_size": B, "compute_dtype": compute_dtype}})
    model = create_model("autoint", packed, config, device="cpu")
    rng = np.random.default_rng(9)
    feats = {f"I{i}": rng.normal(size=B).astype(np.float32)
             for i in range(NUMERIC)}
    feats.update({f"C{i}": rng.integers(0, v, B)
                  for i, v in enumerate(VOCABS)})
    labels = rng.integers(0, 2, B).astype(np.float32)
    arr = pack_features(packed, feats, labels)
    with torch.no_grad():
        # scores and ReLU outputs of order 1, so that the softmax and the
        # masks do real work
        for name, p in model.named_parameters():
            if name.startswith("attention."):
                p.mul_(2.0)
            if name.endswith("dense_b4"):
                p.uniform_(-0.3, 0.3)
    return (model, packed, torch.from_numpy(arr.ids),
            torch.from_numpy(arr.dense), torch.from_numpy(labels))


def _reference_weights(model) -> dict:
    """The port's leaves under the reference's names (the same tensors)."""
    params = dict(model.named_parameters())
    w = {"table": params[f"embedding.table_w{D}"],
         "dense_w": params[f"embedding.dense_w{D}"],
         "dense_b": params[f"embedding.dense_b{D}"],
         "head.w": params["output_linear.weight"],
         "head.b": params["output_linear.bias"]}
    for layer in range(LAYERS):
        for n in INTERACT_NAMES:
            w[f"layer{layer}.{n}"] = params[f"attention.layer_{layer}.{n}"]
    return w


def _port_and_reference():
    """(port logits, reference logits, {leaf: (port grad, reference grad)})
    of the first step's loss."""
    model, packed, ids, dense, labels = _model()
    model.train()
    params = dict(model.named_parameters())
    got = model(ids, dense)[:, 0]
    port_grads = torch.autograd.grad(
        ref.bce(got, labels), list(params.values()), allow_unused=True)
    w = _reference_weights(model)
    leaves = {k: v.detach().clone().requires_grad_() for k, v in w.items()}
    offsets = torch.from_numpy(packed.lookup_groups[0].local_offsets)
    want = ref.logits(leaves, ids, dense, offsets, HEADS, LAYERS)
    ref_grads = dict(zip(leaves, torch.autograd.grad(
        ref.bce(want, labels), list(leaves.values()))))
    names = {id(v): k for k, v in w.items()}
    pairs = {}
    for (name, p), g in zip(params.items(), port_grads):
        g = torch.zeros_like(p) if g is None else g
        pairs[name] = (g, ref_grads[names[id(p)]] if id(p) in names
                       else torch.zeros_like(p))
    return got.detach(), want.detach(), pairs


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = want.abs().max().item()
    diff = (got - want).abs().max().item()
    return diff / scale if scale > 0 else (0.0 if diff == 0 else np.inf)


def _worst_gradient(pairs: dict) -> tuple[str, float]:
    worst = max(pairs, key=lambda n: _rel(*pairs[n]))
    return worst, _rel(*pairs[worst])


def test_autoint_matches_the_reference_in_f32():
    got, want, pairs = _port_and_reference()
    assert _rel(got, want) <= LOGIT_REL
    for name, (g, r) in pairs.items():
        if not torch.any(r != 0):
            # a leaf the logit never reads: exactly 0 on both sides
            assert torch.equal(g, torch.zeros_like(g)), name
            continue
        assert _rel(g, r) <= GRAD_REL, name
    # the masks and the softmax do work: some ReLU outputs are 0 and the
    # scores are not flat
    model, _, ids, dense, _ = _model()
    _, x0, _ = model.embedding(ids, dense)
    out = model.attention(x0)
    assert 0.2 < (out > 0).float().mean().item() < 0.9
    zero = ["embedding.dense_fo_w", "embedding.dense_fo_b"]
    assert all(not torch.any(pairs[n][0] != 0) for n in zero)
    assert not torch.any(pairs[f"embedding.table_w{D}"][0][:, D] != 0)


def _without_row_sum(w, dw):
    return w * dw


def _without_dwres(plain):
    def backward(*args, **kwargs):
        dx, grads = plain(*args, **kwargs)
        return dx, {**grads, "wres": torch.zeros_like(grads["wres"])}
    return backward


@pytest.mark.parametrize("fault", ["row_sum", "dwres"])
def test_the_comparison_refuses_a_planted_fault(fault, monkeypatch):
    if fault == "row_sum":
        monkeypatch.setattr(kattn, "softmax_backward", _without_row_sum)
    else:
        monkeypatch.setattr(kattn, "interacting_backward_plain",
                            _without_dwres(interacting_backward_plain))
    got, want, pairs = _port_and_reference()
    assert _rel(got, want) <= LOGIT_REL  # the forward is untouched
    name, worst = _worst_gradient(pairs)
    assert worst > 100 * GRAD_REL, (name, worst)
    if fault == "dwres":
        assert name.endswith(".wres")


def _layer_inputs(seed, bsz=5, f=7):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.rand(bsz, f, D, generator=gen) - 0.5)
    ws = []
    d = D
    for _ in range(LAYERS):
        ws.append({n: (torch.rand(d, A, generator=gen) * 2 - 1)
                   * (1.2 / d ** 0.5) for n in INTERACT_NAMES})
        d = A
    g = torch.randn(bsz, f, A, generator=gen) * 1e-2
    return x, ws, g


def _port_stack_bf16(x, ws, g):
    """The plain kernel versions layer by layer in bf16: (out, dx, [grads
    of each layer])."""
    xs, h = [], x.to(torch.bfloat16)
    for lw in ws:
        xs.append(h)
        h = interacting_plain(h, lw, HEADS)
    out, grads, gg = h, [None] * LAYERS, g.to(torch.bfloat16)
    for layer in reversed(range(LAYERS)):
        gg, grads[layer] = interacting_backward_plain(xs[layer], ws[layer],
                                                      gg, HEADS)
    return out, gg, grads


def _reference_stack(x, ws, g, qg):
    bf = torch.bfloat16
    leaves = [{n: t.clone().requires_grad_() for n, t in lw.items()}
              for lw in ws]
    xx = x.clone().requires_grad_()
    w = {f"layer{i}.{n}": t for i, lw in enumerate(leaves)
         for n, t in lw.items()}
    out = ref.stack(xx, w, HEADS, LAYERS, q=ref.round_both(bf),
                    qw=ref.round_value(bf), qg=qg)
    flat = [xx] + [t for lw in leaves for t in lw.values()]
    got = torch.autograd.grad(out, flat, g.to(bf).float())
    grads = [dict(zip(INTERACT_NAMES, got[1 + 4 * i:5 + 4 * i]))
             for i in range(LAYERS)]
    return out.detach(), got[0], grads


def test_plain_kernel_versions_meet_the_reference_at_bf16_rounding():
    x, ws, g = _layer_inputs(5)
    out, dx, grads = _port_stack_bf16(x, ws, g)
    rout, rdx, rgrads = _reference_stack(x, ws, g,
                                         ref.round_grad(torch.bfloat16))
    assert _rel(out.float(), rout) <= BF16_STEP
    assert _rel(dx.float(), rdx) <= BF16_STEP
    for layer in range(LAYERS):
        for n in INTERACT_NAMES:
            assert _rel(grads[layer][n], rgrads[layer][n]) <= BF16_GRAD_REL, \
                (layer, n)
    # without the rounding of [dq|dk|dv|dres] the weight gradients part
    _, _, loose = _reference_stack(x, ws, g, ref.identity)
    worst = max(_rel(grads[i][n], loose[i][n])
                for i in range(LAYERS) for n in INTERACT_NAMES)
    assert worst > 10 * BF16_GRAD_REL


def test_the_stack_reads_each_layers_width():
    """Layer 1 reads the embedding width, later layers the attention width;
    the stack returns (B, F, a) in the compute dtype."""
    stack = attn_mod.InteractingStack(D, HEADS, A, LAYERS,
                                      compute_dtype=torch.bfloat16)
    assert [tuple(getattr(stack, f"layer_{i}").wq.shape)
            for i in range(LAYERS)] == [(D, A), (A, A), (A, A)]
    out = stack(torch.zeros(2, 7, D))
    assert out.shape == (2, 7, A) and out.dtype == torch.bfloat16


# ---- plans at the paper's shapes (F = 39, H = 2 of 32, a = 64) ---------


@pytest.mark.parametrize("d,forward,backward", [
    (16, ForwardPlan(samples=3, core_warps=6, rows=128, smem=198_552,
                     blocks_per_sm=1),
     BackwardPlan(samples=2, core_warps=8, rows=80, smem=170_272, tiled=True)),
    (64, ForwardPlan(samples=2, core_warps=4, rows=80, smem=197_136,
                     blocks_per_sm=1),
     BackwardPlan(samples=2, core_warps=8, rows=80, smem=220_192, tiled=True)),
])
def test_interacting_plans_at_the_paper_shapes(d, forward, backward):
    """Layer 1 (d = 16) and layers 2-3 (d = 64): both fit a block, where
    the attention block's backward at d = 64 does not; the backward takes
    the tiled core on all 8 warps, 2 samples (4 pairs) a tile."""
    assert interacting_forward_plan(39, d, 64, 2) == forward
    assert interacting_backward_plan(39, d, 64, 2) == backward
    assert backward.grid(16384) == 132 and backward.grid(3) == 2
    if d == 64:
        with pytest.raises(ValueError, match="243968 bytes"):
            backward_plan(39, 64, 64, 2)


@pytest.mark.parametrize("f", [5, 33, 39, 40, 48])
@pytest.mark.parametrize("d,a,heads", [(16, 64, 2), (64, 64, 2), (16, 24, 3),
                                       (64, 24, 3)])
def test_interacting_backward_plan_invariants(f, d, a, heads):
    """The tiled layout at field counts on and off a 5-row register tile's
    edge (5 and 40 on it, 33, 39 and 48 past it) and heads of 32 and of 8
    (a = 24 of 3: 4 or 8 columns a thread, chunks of 8 floats): it fits a
    block, its core gets every warp, it takes the most samples that fit,
    and its grid is a block a tile up to the fixed 132."""
    bp = interacting_backward_plan(f, d, a, heads)
    assert bp.tiled and bp.core_warps == kattn.WARPS
    assert bp.smem <= kattn.SMEM_PER_BLOCK == 232_448
    assert bp.rows == -(-bp.samples * f // 16) * 16
    assert bp.samples == kattn.MAX_SAMPLES or 4 * kattn._interact_tiled_floats(
        f, d, a, heads, bp.samples + 1) > kattn.SMEM_PER_BLOCK
    assert bp.grid(3) == -(-3 // bp.samples)
    assert bp.grid(16384) == kattn.BWD_BLOCKS == 132


def test_interacting_backward_plan_falls_back_to_the_lane_per_query_core():
    """Where even one sample's pairs' two F x F matrices do not fit beside
    the tile (F = 66, d = 64, 2 heads), the plan keeps the lane-per-query
    core's layout, which still fits, rather than refusing the shape."""
    bp = interacting_backward_plan(66, 64, 64, 2)
    assert not bp.tiled
    assert bp == BackwardPlan(samples=1, core_warps=1, rows=80, smem=228_656)
    assert 4 * kattn._interact_tiled_floats(66, 64, 64, 2, 1) \
        > kattn.SMEM_PER_BLOCK


def test_interacting_plans_refuse_a_shape_no_block_holds():
    with pytest.raises(ValueError, match="interacting layer forward"):
        interacting_forward_plan(200, 64, 64, 2)
    with pytest.raises(ValueError, match="interacting layer backward"):
        interacting_backward_plan(200, 64, 64, 2)


def test_autoint_trains_and_scores_on_the_sparse_fused_path():
    from deepfm_tpu_torch.training.trainer import Trainer

    from deepfm_tpu_torch.data.packing import PackedArrays

    model, packed, ids, dense, labels = _model("bfloat16")
    data = PackedArrays(ids=ids.numpy(), dense=dense.numpy(),
                        labels=labels.numpy(),
                        weights=np.ones(B, np.float32))
    trainer = Trainer(model, packed, model.config, data, data, data)
    assert trainer.path == "sparse_fused"
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    loss, n = trainer._train_epoch()
    assert np.isfinite(loss) and n == B
    moved = {k for k, v in model.named_parameters()
             if not torch.equal(v, before[k])}
    assert {f"attention.layer_{i}.{n}" for i in range(LAYERS)
            for n in INTERACT_NAMES} <= moved
    scores = trainer.predictor.predict(data)
    assert scores.shape == (B,) and np.all((scores > 0) & (scores < 1))


@pytest.mark.cuda
def test_interacting_kernels_match_plain_on_cuda():
    """The interacting layer's forward and backward kernels against their
    plain versions on the card, f32 and bf16, at both layer widths, ragged
    batches and padded heads (a = 24 of 3 heads of 8 pads d to 16 and the
    sections to 32), F = 40 and 48 (on and past the tiled core's 5-row
    edge) and F = 66 (the lane-per-query fallback); a second launch gives
    the same bits, and the tiled launches are counted. Elements whose
    ReLU mask parts between the two (ctx + res within rounding of 0) are
    held by share: at most 1e-3 of dx outside one bf16 step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU launch")
    from deepfm_tpu_torch.ops.kernels.attention import (
        interacting_backward,
        interacting_forward,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    for b, f, d, a, heads in ((6, 7, 4, 8, 2), (1001, 39, 16, 64, 2),
                              (300, 39, 64, 64, 2), (33, 5, 12, 24, 3),
                              (1, 39, 64, 64, 2), (3, 33, 16, 64, 2),
                              (257, 40, 16, 64, 2), (257, 40, 64, 64, 2),
                              (129, 48, 16, 64, 2), (129, 48, 64, 64, 2),
                              (100, 66, 64, 64, 2)):
        gen = torch.Generator().manual_seed(b + d)
        p = {n: ((torch.rand(d, a, generator=gen) * 2 - 1)
                 * (1.2 / d ** 0.5)).cuda() for n in INTERACT_NAMES}
        x = torch.rand(b, f, d, generator=gen).cuda() - 0.3
        g = torch.randn(b, f, a, generator=gen).cuda() * 1e-2
        tiled = interacting_backward_plan(f, d, a, heads).tiled
        for dt in (torch.float32, torch.bfloat16):
            xx, gg = x.to(dt), g.to(dt)
            out, out2 = (interacting_forward(xx, p, heads) for _ in range(2))
            before = interacting_backward.tiled_launches
            (dx, dp), (dx2, dp2) = (interacting_backward(xx, p, gg, heads)
                                    for _ in range(2))
            assert interacting_backward.tiled_launches - before == 2 * tiled
            ref = interacting_plain(xx, p, heads)
            rdx, rdp = interacting_backward_plain(xx, p, gg, heads)
            torch.cuda.synchronize()
            what = f"B={b} F={f} d={d} a={a} H={heads} {dt}"
            step = BF16_STEP if dt == torch.bfloat16 else 1e-5
            assert torch.equal(out, out2) and torch.equal(dx, dx2), what
            assert _rel(out.float(), ref.float()) <= step, what
            off = (dx.float() - rdx.float()).abs() > step * rdx.float().abs(
            ).max()
            assert off.float().mean().item() <= 1e-3, what
            for n in INTERACT_NAMES:
                assert torch.equal(dp[n], dp2[n]), (what, n)
                assert _rel(dp[n], rdp[n]) <= 1e-2, (what, n)


@pytest.mark.cuda
def test_interacting_backward_masks_are_the_forward_kernels():
    """The backward recomputes the forward, and its ReLU mask must be the
    forward kernel's bit for bit. With x's rows one-hot (row i = e_i, F <=
    d) and a cotangent of ones, dW_res[i, c] = dres[i, c], which is exactly
    1 where the backward's ctx + res > 0 and 0 elsewhere, in either dtype:
    it must be nonzero exactly where interacting_forward(x) > 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU launch")
    from deepfm_tpu_torch.ops.kernels.attention import (
        interacting_backward,
        interacting_forward,
    )

    for f, d, a, heads in ((39, 64, 64, 2), (40, 64, 64, 2), (64, 64, 64, 2),
                           (5, 16, 24, 3)):
        for seed in range(4):
            gen = torch.Generator().manual_seed(100 * f + seed)
            p = {n: ((torch.rand(d, a, generator=gen) * 2 - 1) * 0.8).cuda()
                 for n in INTERACT_NAMES}
            x = torch.zeros(1, f, d)
            x[0, torch.arange(f), torch.arange(f)] = 1.0
            for dt in (torch.float32, torch.bfloat16):
                xx = x.to(dt).cuda()
                out = interacting_forward(xx, p, heads)[0]
                _, dp = interacting_backward(
                    xx, p, torch.ones(1, f, a, dtype=dt, device="cuda"), heads)
                mask = dp["wres"][:f]
                what = f"F={f} d={d} H={heads} seed {seed} {dt}"
                assert 0.1 < (out > 0).float().mean().item() < 0.9, what
                assert torch.equal(mask != 0, out > 0), what
                assert torch.all((mask == 0) | (mask == 1)), what
                assert torch.all(dp["wres"][f:] == 0), what
