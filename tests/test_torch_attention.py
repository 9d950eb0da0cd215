"""The port's attention block and AttentionDeepFM against the JAX package's.

On the CPU the port's attention kernels run their plain versions; they are
held against the JAX package's f-major Pallas kernels
(``make_attention_block_fmajor``) in interpret mode, with gradients from
``jax.vjp``. ``DEEPFM_TPU_FORCE_ATTN_KERNEL=1`` (set by tests/conftest.py)
makes the JAX module take those kernels on the CPU; the shapes are ones
their gate takes (hd % 8 == 0, d % 8 == 0): a=16, H=2, d=8. Inputs and
weights are made with numpy from a seed and handed to both packages.

Tolerances:
  * f32 forward: rtol 1e-5 / atol 1e-6 (the same f32 arithmetic, sums in
    another order; measured 2.4e-7). Gradients: max|port - JAX| <= 1e-5 *
    max|JAX| per leaf (measured <= 5e-7). The key bias ``bk`` has an exact
    gradient of 0 (the softmax ignores a shift every key shares): both sides
    are rounding noise, held to 1e-5 of ``wk``'s gradient scale instead.
  * bf16 (the kernel's rounding points, weights cast to bf16, q/k/v,
    softmax and context in f32): forward and dx at 2^-7 relative (one bf16
    ulp; measured 0), parameter gradients at 1e-4 of their scale (f32
    accumulations in another order; measured <= 1.4e-7). Leaving out the
    cast of [dq|dk|dv] moves dWq by 2e-3 of its scale and computing in f32
    moves dWo by more: both are refused.
  * ``AttentionBlockFn`` against autograd through the plain forward, f32:
    rtol 1e-5 / atol 1e-6.
  * AttentionDeepFM eval-mode scores: rtol 2e-4 / atol 1e-5, the model
    tests' tolerance (tests/test_torch_model.py).

The CUDA kernels against their plain versions (marker ``cuda``; they skip
here), and bit for bit on a second launch:
``python -m pytest --noconftest tests/test_torch_attention.py -m cuda``.
"""

import sys

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.config import config_from_dict
from deepfm_tpu_torch.convert import params_from_jax, torch_name
from deepfm_tpu_torch.data.packing import pack_features, pack_schema
from deepfm_tpu_torch.models import create_model
from deepfm_tpu_torch.ops.attention import MultiHeadSelfAttention
from deepfm_tpu_torch.ops.kernels.attention import (
    attention_block,
    attention_block_backward,
    attention_block_backward_plain,
    attention_block_forward,
    attention_block_plain,
    BackwardPlan,
    backward_plan,
    plan,
)
from deepfm_tpu_torch.training.optim import leaf_order

torch.set_num_threads(1)

B, F, D, A, H = 6, 5, 8, 16, 2
F32_TOL = dict(rtol=1e-5, atol=1e-6)
F32_GRAD_REL = 1e-5
BF16_GRAD_REL = 1e-4
MODEL_TOL = dict(rtol=2e-4, atol=1e-5)


def _params(seed, residual, d=D, a=A):
    rng = np.random.default_rng(seed)
    p = {}
    for n in ("q", "k", "v"):
        p[f"w{n}"] = rng.uniform(-0.4, 0.4, (d, a)).astype(np.float32)
        p[f"b{n}"] = rng.uniform(-0.4, 0.4, (a,)).astype(np.float32)
    p["wo"] = rng.uniform(-0.4, 0.4, (a, d)).astype(np.float32)
    p["bo"] = rng.uniform(-0.4, 0.4, (d,)).astype(np.float32)
    if residual:
        p["ln_scale"] = rng.uniform(0.5, 1.5, (d,)).astype(np.float32)
        p["ln_bias"] = rng.uniform(-0.4, 0.4, (d,)).astype(np.float32)
    return p


def _xg(seed, b=B, f=F, d=D):
    rng = np.random.default_rng(seed + 50)
    return (rng.normal(size=(b, f, d)).astype(np.float32),
            rng.normal(size=(b, f, d)).astype(np.float32))


def _jax_block(x, p, g, residual, bf16, heads=H):
    """(out, dx, dp) of the JAX f-major kernels, back in (B, F, d), f32."""
    import jax
    import jax.numpy as jnp

    from deepfm_tpu.ops.pallas.attention_fmajor_kernel import (
        make_attention_block_fmajor,
    )

    dt = jnp.bfloat16 if bf16 else jnp.float32
    fn = make_attention_block_fmajor(heads, residual)
    xf = jnp.asarray(x, dt).transpose(1, 2, 0)
    out, vjp = jax.vjp(fn, xf, {k: jnp.asarray(v) for k, v in p.items()})
    dx, dp = vjp(jnp.asarray(g, dt).transpose(1, 2, 0))
    back = lambda t: np.asarray(t.astype(jnp.float32)).transpose(2, 0, 1)  # noqa: E731
    return back(out), back(dx), {k: np.asarray(v) for k, v in dp.items()}


def _helpers():
    """tests/torch_port_helpers.py, which imports JAX: loaded inside the
    tests that compare with the JAX package, so the CUDA test also runs on
    a GPU machine without JAX."""
    sys.path.insert(0, "tests")
    import torch_port_helpers

    return torch_port_helpers


def _rel(got, want, scale=None):
    got = np.asarray(got, np.float32)
    ref = np.abs(want if scale is None else scale).max()
    return float(np.abs(got - want).max() / max(ref, 1e-30))


def _bf16(a):
    return np.asarray(torch.from_numpy(a).bfloat16().float())


# (bf16, residual, (F, d, attention_dim, heads)): the base shape in both
# dtypes with and without residual; F = 33 (more fields than a warp has
# lanes: the backward kernel's lanes wrap) and four heads of 8
_BLOCK_CASES = [
    pytest.param(bf16, residual, (F, D, A, H),
                 id=f"{'bf16' if bf16 else 'f32'}-{residual}")
    for bf16 in (False, True) for residual in (True, False)
] + [
    pytest.param(bf16, True, shape, id=f"{name}-{'bf16' if bf16 else 'f32'}")
    for name, shape in (("F33", (33, D, A, H)), ("hd8", (F, D, 32, 4)))
    for bf16 in (False, True)
]


@pytest.mark.parametrize("bf16,residual,shape", _BLOCK_CASES)
def test_plain_block_matches_jax_fmajor_kernels(bf16, residual, shape):
    f, d, a, heads = shape
    p = _params(0, residual, d, a)
    x, g = _xg(0, f=f, d=d)
    if bf16:
        x, g = _bf16(x), _bf16(g)
    jout, jdx, jdp = _jax_block(x, p, g, residual, bf16, heads)
    dt = torch.bfloat16 if bf16 else torch.float32
    xt = torch.from_numpy(x).to(dt)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    out = attention_block_forward(xt, pt, heads, residual)
    dx, dp = attention_block_backward(xt, pt, torch.from_numpy(g).to(dt),
                                      heads, residual)
    assert out.dtype == dx.dtype == dt
    assert sorted(dp) == sorted(p)
    if bf16:
        assert _rel(out.float().numpy(), jout) <= 2.0 ** -7
        assert _rel(dx.float().numpy(), jdx) <= 2.0 ** -7
    else:
        np.testing.assert_allclose(out.numpy(), jout, **F32_TOL)
        np.testing.assert_allclose(dx.numpy(), jdx, **F32_TOL)
    limit = BF16_GRAD_REL if bf16 else F32_GRAD_REL
    for name, want in jdp.items():
        got = dp[name]
        assert got.dtype == torch.float32 and got.shape == want.shape
        scale = jdp["wk"] if name == "bk" else want
        assert _rel(got.numpy(), want, scale) <= limit, name


def test_bf16_rounding_points_matter():
    """The f32 block lies far from the JAX bf16 kernel, and so does the plain
    backward without the cast of [dq|dk|dv] (chip_smoke.py's control); the
    plain forward without the cast of the context (the forward's control)
    moves bf16 outputs that the plain forward gives as the JAX kernel
    does."""
    p = _params(1, True)
    x, g = _xg(1)
    x, g = _bf16(x), _bf16(g)
    jout, _, jdp = _jax_block(x, p, g, True, bf16=True)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    xb, gb = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    plain = attention_block_plain(xb, pt, H, True).float().numpy()
    control = attention_block_plain(xb, pt, H, True,
                                    ctx_round=False).float().numpy()
    assert (control != jout).sum() > (plain != jout).sum()
    _, control = attention_block_backward_plain(xb, pt, gb, H, True,
                                                dall_round=False)
    _, f32 = attention_block_backward_plain(xb.float(), pt, gb.float(), H,
                                            True)
    assert _rel(control["wq"].numpy(), jdp["wq"]) > 10 * BF16_GRAD_REL
    assert _rel(f32["wo"].numpy(), jdp["wo"]) > 10 * BF16_GRAD_REL


@pytest.mark.parametrize("residual", [True, False])
def test_block_fn_matches_autograd_through_plain(residual):
    p = _params(2, residual)
    x, g = _xg(2)

    def leaves():
        xt = torch.from_numpy(x).requires_grad_()
        return xt, {k: torch.from_numpy(v).requires_grad_()
                    for k, v in p.items()}

    xt, pt = leaves()
    out = attention_block(xt, pt, H, residual)
    assert "AttentionBlockFn" in out.grad_fn.name()
    out.backward(torch.from_numpy(g))
    xr, pr = leaves()
    attention_block_plain(xr, pr, H, residual).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), **F32_TOL)
    for k in p:
        np.testing.assert_allclose(pt[k].grad.numpy(), pr[k].grad.numpy(),
                                   **F32_TOL, err_msg=k)


def test_module_matches_jax_module():
    """Two stacked blocks with residual, through both modules."""
    import jax.numpy as jnp

    from deepfm_tpu.ops.attention import MultiHeadSelfAttention as JaxMHSA

    x, _ = _xg(3)
    params = {f"block_{i}": {k: jnp.asarray(v)
                             for k, v in _params(10 + i, True).items()}
              for i in range(2)}
    jmod = JaxMHSA(embed_dim=D, num_heads=H, attention_dim=A, num_layers=2,
                   use_residual=True, use_pallas=True)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    mod = MultiHeadSelfAttention(D, H, A, num_layers=2, use_residual=True)
    mod.load_state_dict({f"{blk}.{k}": torch.from_numpy(np.asarray(v))
                         for blk, leaves in params.items()
                         for k, v in leaves.items()})
    with torch.inference_mode():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_kernel_flag_off_refuses_non_cpu_tensors():
    """use_attention_kernel=false means the plain version, which the port
    runs on the CPU only; with the flag on, a device that is neither CPU
    nor CUDA is refused by the wrappers."""
    off = MultiHeadSelfAttention(D, H, A, use_kernel=False)
    assert off(torch.zeros(2, F, D)).shape == (2, F, D)
    off.train()
    with pytest.raises(ValueError, match="only on the CPU"):
        off(torch.zeros(2, F, D, device="meta", requires_grad=True))
    on = MultiHeadSelfAttention(D, H, A).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        on(torch.zeros(2, F, D, device="meta"))
    with pytest.raises(ValueError, match="divisible"):
        MultiHeadSelfAttention(D, num_heads=3, attention_dim=A)


def test_plan_fits_the_bench_shape_and_refuses_oversize():
    fwd = plan(27, 16, 64, 4, backward=False)
    bwd = plan(27, 16, 64, 4, backward=True)
    assert fwd < bwd <= 232_448
    # bench.py's shape: 4 samples (108 rows, padded to 112) a tile, all 8
    # warps in the core (16 (sample, head) pairs a tile), one block an SM
    bp = backward_plan(27, 16, 64, 4)
    assert bp == BackwardPlan(samples=4, core_warps=8, rows=112, smem=bwd)
    assert bp.smem == 228_992
    assert bp.grid(16384) == 132 and bp.grid(5) == 2 and bp.grid(1000) == 132
    with pytest.raises(ValueError, match="shared memory"):
        plan(100, 16, 64, 4, backward=True)


def _old_backward_smem(f, d, a, h):
    """Bytes of the backward's first design (one block a sample, every
    stage in shared memory): what the plan accepted before."""
    weights = d * 3 * a + a * d + 3 * a
    scores = f * h * (f | 1)
    n_grad = d * 3 * a + 3 * a + a * d + 3 * d
    return 4 * (2 * weights - 3 * a + 2 * d + n_grad + 4 * f * d
                + f * ((3 * a) | 1) + f * 3 * a + 2 * scores + 2 * f * a)


@pytest.mark.parametrize("d,a,heads", [(16, 64, 4), (8, 16, 2), (16, 128, 1),
                                       (12, 24, 3), (16, 64, 8), (32, 128, 4),
                                       (5, 15, 3)])
def test_backward_plan_refuses_no_shape_the_first_design_took(d, a, heads):
    """Every F that the first design's shared memory took still runs (F > 32
    included: lanes wrap), and the plan's tile and warps stay in range."""
    for f in range(1, 130):
        if _old_backward_smem(f, d, a, heads) > 232_448:
            continue
        bp = backward_plan(f, d, a, heads)
        assert 1 <= bp.samples <= 8 and 1 <= bp.core_warps <= 8
        assert bp.core_warps <= bp.samples * heads
        assert bp.rows == -(-bp.samples * f // 16) * 16
        assert bp.smem <= 232_448


def test_backward_plan_takes_more_than_a_warp_of_fields():
    bp = backward_plan(33, 16, 64, 4)
    assert (bp.samples, bp.core_warps, bp.rows) == (2, 8, 80)
    assert backward_plan(47, 16, 64, 4).samples >= 1
    # the first design refused F = 48 at bench.py's widths; this one does not
    assert _old_backward_smem(48, 16, 64, 4) > 232_448
    assert backward_plan(48, 16, 64, 4).smem <= 232_448


def _model_data(model, **extra):
    from deepfm_tpu.config import config_from_dict as jax_config
    from deepfm_tpu.data.packing import pack_features as jax_pack
    from deepfm_tpu.data.packing import pack_schema as jax_pack_schema

    h = _helpers()
    jschema, tschema = h.schema_pair(h.SYNTH_SPEC)
    feats = h.random_features(h.SYNTH_SPEC, 16, seed=5)
    labels = np.random.default_rng(6).integers(0, 2, 16).astype(np.float32)
    raw = {"model_name": model,
           "dnn": {"hidden_units": [16, 8], "dropout": 0.0},
           "cin": {"layer_sizes": [8, 8]},
           "attention": {"num_heads": 2, "attention_dim": 16}, **extra}
    jpacked, tpacked = jax_pack_schema(jschema), pack_schema(tschema)
    return (jax_config(raw), jpacked, jax_pack(jpacked, feats, labels),
            config_from_dict({**raw, "device": "cpu"}), tpacked,
            pack_features(tpacked, feats, labels))


def test_attention_deepfm_forward_matches_jax():
    """Eval-mode scores with carried weights and moved BN statistics; the
    DNN's first layer takes F*d + the flat width."""
    from deepfm_tpu.models import create_model as jax_create_model

    jconfig, jpacked, jarr, tconfig, tpacked, tarr = _model_data(
        "attention_deepfm")
    h = _helpers()
    jmodel = jax_create_model("attention_deepfm", jpacked, jconfig)
    params, stats = h.init_jax_model(jmodel, jarr.ids, jarr.dense)
    want = h.jax_predict(jmodel, params, stats, jarr.ids, jarr.dense)
    model = create_model("attention_deepfm", tpacked, tconfig, device="cpu")
    model.load_state_dict(params_from_jax(params, stats, tpacked, tconfig))
    width = tpacked.num_fields * 16 + tpacked.schema.total_embedding_dim
    assert model.dnn.dense_0.weight.shape == (16, width)
    assert model.output_linear.weight.shape == (1, 8)
    assert model.attention.block_0.wq.shape == (16, 16)
    model.eval()
    with torch.inference_mode():
        got = model.predict(torch.from_numpy(tarr.ids),
                            torch.from_numpy(tarr.dense))[:, 0].numpy()
    np.testing.assert_allclose(got, want, **MODEL_TOL)


@pytest.mark.parametrize("model", ["xdeepfm", "attention_deepfm"])
def test_leaf_order_is_the_jax_tree_order(model):
    """The clip norm folds the leaves' sums of squares in the JAX tree's
    leaf order; the port's names must sort the same way."""
    import jax

    from deepfm_tpu.models import create_model as jax_create_model

    jconfig, jpacked, jarr, tconfig, tpacked, _ = _model_data(model)
    params, _ = _helpers().init_jax_model(
        jax_create_model(model, jpacked, jconfig), jarr.ids, jarr.dense)
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    port = create_model(model, tpacked, tconfig, device="cpu")
    names = [n for n, _ in port.named_parameters()]
    assert leaf_order(names) == [torch_name(p) for p in paths]


def test_attention_deepfm_served_from_its_config(tmp_path):
    """configs/attention_deepfm_movielens.yaml through the port's serving
    prologue and ScoringService on the CPU (dropout 0.1 is inert in eval
    mode), its scores held against the JAX model with the same weights."""
    import yaml

    from deepfm_tpu.data.movielens import MovieLensAdapter as JaxAdapter
    from deepfm_tpu.data.packing import pack_schema as jax_pack_schema
    from deepfm_tpu.data.synthetic import generate_movielens_like as jax_gen
    from deepfm_tpu.models import create_model as jax_create_model
    from deepfm_tpu_torch.cli import _build_data, _restore_predictor
    from deepfm_tpu_torch.data.synthetic import generate_movielens_like
    from deepfm_tpu_torch.serving import ScoringService
    from deepfm_tpu_torch.training.persistence import save_best

    h = _helpers()
    kw = dict(num_users=30, num_items=40, num_rows=1200, seed=3)
    jax_gen(tmp_path / "jax", **kw)
    generate_movielens_like(tmp_path / "port", **kw)
    with open("configs/attention_deepfm_movielens.yaml") as fh:
        raw = yaml.safe_load(fh)
    raw["data"].update(data_dir=str(tmp_path / "port"), num_neg_train=1,
                       num_neg_eval=5, use_native_sampler=False)
    raw.update(device="cpu", output_dir=str(tmp_path / "run"))
    jconfig, tconfig = h.config_pair(raw)
    assert tconfig.dnn.dropout == 0.1 and tconfig.attention.attention_dim == 64
    jadapter = JaxAdapter(jconfig.data, seed=jconfig.seed)
    jsplits = jadapter.build()
    jpacked = jax_pack_schema(jsplits[0])
    jval = jsplits[2].pack(jpacked)
    jmodel = jax_create_model("attention_deepfm", jpacked, jconfig)
    params, stats = h.init_jax_model(jmodel, jval.ids[:8], jval.dense[:8])

    _, _, packed0, _, _, _ = _build_data(tconfig)
    model = create_model("attention_deepfm", packed0, tconfig, device="cpu")
    model.load_state_dict(params_from_jax(params, stats, packed0, tconfig))
    save_best(model, tconfig.output_dir, epoch=1, best_metric=0.5)
    adapter, packed, _, _, _, predictor, _ = _restore_predictor(tconfig)
    service = ScoringService(adapter, packed, predictor, "attention_deepfm")
    service.warmup()
    raw_rows = np.loadtxt(tmp_path / "port" / "u.data", dtype=np.int64)[:20]
    users, items = raw_rows[:, 0], raw_rows[:, 1]
    ds, kept = adapter.score_id_pairs(users, items)
    got = predictor.predict(ds.pack(packed))
    jds, jkept = jadapter.score_id_pairs(users, items)
    assert list(kept) == list(jkept)
    jarr = jds.pack(jpacked)
    want = h.jax_predict(jmodel, params, stats, jarr.ids, jarr.dense)
    np.testing.assert_allclose(got, want, **MODEL_TOL)


@pytest.mark.cuda
def test_attention_kernels_match_plain_on_cuda():
    """Forward and backward kernels against their plain versions on the
    card, f32 and bf16, residual on and off, ragged batches and the bench
    geometry; a second launch gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU launch")
    torch.backends.cuda.matmul.allow_tf32 = False
    # (B=1001 is not a multiple of the bench plan's 4 samples a tile; F=33
    # wraps the core's lanes; d=12, a=24, H=3 pads d, the heads and the
    # [q|k|v] sections; B=16384 is bench.py's shape; B=1 and B=3, as
    # serving sends them, leave a forward tile part empty, also at F=33)
    for b, f, d, a, heads in ((6, 5, 8, 16, 2), (1001, 27, 16, 64, 4),
                              (33, 7, 12, 24, 3), (300, 33, 16, 64, 4),
                              (16384, 27, 16, 64, 4), (1, 27, 16, 64, 4),
                              (3, 27, 16, 64, 4), (3, 33, 16, 64, 4)):
        for residual in (True, False):
            p = {k: torch.from_numpy(v).cuda()
                 for k, v in _params(7, residual, d, a).items()}
            x, g = (torch.from_numpy(t).cuda() for t in _xg(7, b, f, d))
            for dt in (torch.float32, torch.bfloat16):
                xx, gg = x.to(dt), g.to(dt)
                out = attention_block_forward(xx, p, heads, residual)
                out2 = attention_block_forward(xx, p, heads, residual)
                ref = attention_block_plain(xx, p, heads, residual)
                dx, dp = attention_block_backward(xx, p, gg, heads, residual)
                dx2, dp2 = attention_block_backward(xx, p, gg, heads, residual)
                rdx, rdp = attention_block_backward_plain(xx, p, gg, heads,
                                                          residual)
                torch.cuda.synchronize()
                tol = 2.0 ** -7 if dt == torch.bfloat16 else 1e-5
                what = f"B={b} F={f} d={d} a={a} H={heads} {dt} res={residual}"
                assert _rel(out.float().cpu().numpy(),
                            ref.float().cpu().numpy()) <= tol, what
                assert torch.equal(out, out2), what
                assert torch.equal(dx, dx2), what
                assert _rel(dx.float().cpu().numpy(),
                            rdx.float().cpu().numpy()) <= tol, what
                for k in rdp:
                    assert torch.equal(dp[k], dp2[k]), (what, k)
                    scale = rdp["wk" if k == "bk" else k].cpu().numpy()
                    assert _rel(dp[k].cpu().numpy(), rdp[k].cpu().numpy(),
                                scale) <= 1e-3, (what, k)


@pytest.mark.cuda
def test_kernel_flags_off_raise_on_cuda():
    """use_attention_kernel / use_cin_kernel false select the plain
    versions, which the port runs only on the CPU: on the card both raise
    (train mode, an input that needs a gradient)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from deepfm_tpu_torch.ops.cin import CIN

    attn = MultiHeadSelfAttention(D, H, A, use_kernel=False).cuda()
    cin = CIN(num_fields=F, layer_sizes=(4,), split_half=False,
              use_kernel=False).cuda()
    x = torch.zeros(2, F, D, device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="only on the CPU"):
        attn(x)
    with pytest.raises(ValueError, match="only on the CPU"):
        cin(x)
