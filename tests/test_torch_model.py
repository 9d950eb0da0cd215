"""The port's embedding engine and xDeepFM against the JAX package's.

The JAX model is initialised, its parameters (and BatchNorm statistics,
moved off their init) are carried over with
``deepfm_tpu_torch.convert.params_from_jax``, and both packages score the
same numpy batch. Covered schemas: the conftest synthetic schema (sparse,
mean-pooled sequence and dense fields) and the MovieLens 16-field schema
at small vocabularies (widths 16, 8 and 4, projection to fm_d).

Tolerance: f32 rtol 2e-4 / atol 1e-5, the tolerance of
tests/test_torch_parity.py; the two packages sum in another order.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    MOVIELENS_SPEC,
    SYNTH_SPEC,
    config_pair,
    count_params,
    init_jax_model,
    jax_predict,
    random_features,
    schema_pair,
)

from deepfm_tpu.data.packing import pack_features as jax_pack  # noqa: E402
from deepfm_tpu.data.packing import pack_schema as jax_pack_schema  # noqa: E402
from deepfm_tpu.models import create_model as jax_create_model  # noqa: E402
from deepfm_tpu.ops.embedding import FeatureEmbedding as JaxEmbedding  # noqa: E402
from deepfm_tpu_torch.convert import params_from_jax  # noqa: E402
from deepfm_tpu_torch.data.packing import pack_features, pack_schema  # noqa: E402
from deepfm_tpu_torch.models import create_model, resolve_table_layout  # noqa: E402
from deepfm_tpu_torch.ops.embedding import FeatureEmbedding  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=1e-5)
SPECS = {"synth": SYNTH_SPEC, "movielens": MOVIELENS_SPEC}


def _config(use_cin_kernel=True, **extra):
    raw = {
        "model_name": "xdeepfm",
        "device": "cpu",
        "feature": {"fm_embed_dim": 16},
        "dnn": {"hidden_units": [32, 16], "dropout": 0.0},
        "cin": {"layer_sizes": [16, 16, 8], "split_half": True},
        "pallas": {"use_cin_kernel": use_cin_kernel},
        "training": {"batch_size": 32},
    }
    raw.update(extra)
    return config_pair(raw)


def _batch(spec, n=24, seed=0):
    jschema, tschema = schema_pair(spec)
    feats = random_features(spec, n, seed)
    labels = np.zeros(n, np.float32)
    jpacked, tpacked = jax_pack_schema(jschema), pack_schema(tschema)
    jarr = jax_pack(jpacked, feats, labels)
    tarr = pack_features(tpacked, feats, labels)
    np.testing.assert_array_equal(jarr.ids, tarr.ids)
    np.testing.assert_array_equal(jarr.dense, tarr.dense)
    return jpacked, tpacked, tarr.ids, tarr.dense


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_feature_embedding_three_views_match_jax(spec):
    jpacked, tpacked, ids, dense = _batch(SPECS[spec])
    jemb = JaxEmbedding(packed=jpacked, fm_embed_dim=16)
    params = jemb.init(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(dense)
    )["params"]
    want = jemb.apply({"params": params}, jnp.asarray(ids),
                      jnp.asarray(dense))

    emb = FeatureEmbedding(tpacked, fm_embed_dim=16)
    sd = params_from_jax({"embedding": params}, None, tpacked,
                         _config()[1])
    emb.load_state_dict({k[len("embedding."):]: v for k, v in sd.items()})
    with torch.inference_mode():
        got = emb(torch.from_numpy(ids), torch.from_numpy(dense))
    for g, w, name in zip(got, want, ("first_order", "field", "flat")):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_table_init_zeroes_row0_and_padding(spec):
    """Every field's row 0 and the padding tail start at exactly zero, and
    the other rows stay inside the field's xavier bounds."""
    _, tpacked, _, _ = _batch(SPECS[spec])
    emb = FeatureEmbedding(tpacked, generator=torch.Generator().manual_seed(3))
    for group in tpacked.lookup_groups:
        table = getattr(emb, f"table_w{group.width}").detach().numpy()
        assert table.shape[0] % 128 == 0
        assert not table[group.total_rows :].any()
        starts = np.unique(group.local_offsets)
        assert not table[starts].any()
        vocab = [tpacked.schema.fields[n].vocabulary_size
                 for n in group.field_names]
        bound = np.sqrt(6.0 / (1 + max(min(vocab) - 1, 1)))
        assert np.abs(table).max() <= bound


@pytest.mark.parametrize("use_cin_kernel", [True, False])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_xdeepfm_logits_and_predict_match_jax(spec, use_cin_kernel):
    jconfig, tconfig = _config(use_cin_kernel)
    jpacked, tpacked, ids, dense = _batch(SPECS[spec], n=40, seed=1)
    jmodel = jax_create_model("xdeepfm", jpacked, jconfig)
    params, stats = init_jax_model(jmodel, ids, dense)
    variables = {"params": params, "batch_stats": stats}
    want_logit = np.asarray(
        jmodel.apply(variables, jnp.asarray(ids), jnp.asarray(dense))
    )
    want_prob = jax_predict(jmodel, params, stats, ids, dense)

    model = create_model("xdeepfm", tpacked, tconfig, device="cpu")
    model.load_state_dict(params_from_jax(params, stats, tpacked, tconfig))
    assert sum(p.numel() for p in model.parameters()) == count_params(params)
    model.eval()
    with torch.inference_mode():
        t_ids, t_dense = torch.from_numpy(ids), torch.from_numpy(dense)
        logit = model(t_ids, t_dense)
        prob = model.predict(t_ids, t_dense)[:, 0]
    assert logit.dtype == torch.float32 and logit.shape == (40, 1)
    np.testing.assert_allclose(logit.numpy(), want_logit, **TOL)
    np.testing.assert_allclose(prob.numpy(), want_prob, **TOL)


def test_xdeepfm_bf16_compute_tracks_jax():
    """training.compute_dtype=bfloat16 (bf16 embeddings, CIN operands and
    DNN): at 1e-2 on probabilities, a few bf16 roundings (2^-8 relative
    each) through the towers (1.1e-3 seen on this input); the JAX CIN runs f32 here because [16,16,8]
    misses its 16-row bf16 alignment, the port's kernel path has no gate."""
    jconfig, tconfig = _config(training={"batch_size": 32,
                                         "compute_dtype": "bfloat16"})
    jpacked, tpacked, ids, dense = _batch(MOVIELENS_SPEC, n=40, seed=2)
    jmodel = jax_create_model("xdeepfm", jpacked, jconfig)
    params, stats = init_jax_model(jmodel, ids, dense)
    want = jax_predict(jmodel, params, stats, ids, dense)
    model = create_model("xdeepfm", tpacked, tconfig, device="cpu")
    model.load_state_dict(params_from_jax(params, stats, tpacked, tconfig))
    model.eval()
    with torch.inference_mode():
        got = model.predict(torch.from_numpy(ids), torch.from_numpy(dense))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=0, atol=1e-2)


def test_paper_cin_leaves_carry_across_unchanged():
    """params_from_jax at the xDeepFM paper's CIN (27 fields of width 10,
    3 x 200 maps, no split): the conv kernels of H*F = 729, 5400 and 5400
    columns and their biases reach the port's model bit for bit."""
    spec = ([(f"cat_{i}", "sparse", 30, 10, 1) for i in range(26)]
            + [("dense_0", "dense", 0, 10, 1)])
    jconfig, tconfig = _config(
        use_cin_kernel=False, feature={"fm_embed_dim": 10},
        cin={"layer_sizes": [200, 200, 200], "split_half": False},
        dnn={"hidden_units": [400, 400], "dropout": 0.0})
    jpacked, tpacked, ids, dense = _batch(spec, n=2, seed=3)
    jmodel = jax_create_model("xdeepfm", jpacked, jconfig)
    params, stats = init_jax_model(jmodel, ids, dense)
    model = create_model("xdeepfm", tpacked, tconfig, device="cpu")
    model.load_state_dict(params_from_jax(params, stats, tpacked, tconfig))
    for i, cols in enumerate((729, 5400, 5400)):
        for leaf, shape in ((f"conv_{i}_kernel", (200, cols)),
                            (f"conv_{i}_bias", (200,))):
            want = np.asarray(params["cin"][leaf])
            got = getattr(model.cin, leaf).detach().numpy()
            assert got.shape == want.shape == shape
            np.testing.assert_array_equal(got, want)


def test_create_model_refuses_what_later_slices_bring():
    """Every model of the JAX registry is ported (the baselines last), and
    the port has one of its own after them, ``autoint``, so only a name
    outside both is refused."""
    from deepfm_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from deepfm_tpu_torch.models import MODEL_REGISTRY

    _, tconfig = _config()
    _, tpacked, _, _ = _batch(SYNTH_SPEC)
    assert list(MODEL_REGISTRY) == [*JAX_REGISTRY, "autoint"]
    assert "autoint" not in JAX_REGISTRY
    model = create_model("autoint", tpacked, tconfig, device="cpu")
    assert type(model).__name__ == "AutoInt"
    for name in ("lr", "fm", "dnn"):
        model = create_model(name, tpacked, tconfig, device="cpu")
        assert type(model).__name__ == JAX_REGISTRY[name].__name__
    with pytest.raises(ValueError, match="Unknown model"):
        create_model("nope", tpacked, tconfig, device="cpu")
    _, packed_cfg = _config(pallas={"table_layout": "packed"})
    assert resolve_table_layout(packed_cfg) is True
    _, auto_cfg = _config(pallas={"table_layout": "auto"})
    assert resolve_table_layout(auto_cfg) is False


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a GPU")
    _, tconfig = _config()
    _, tpacked, _, _ = _batch(SYNTH_SPEC)
    with pytest.raises(RuntimeError, match="cuda"):
        create_model("xdeepfm", tpacked, tconfig)


def test_seeded_init_is_reproducible():
    _, tconfig = _config()
    _, tpacked, _, _ = _batch(MOVIELENS_SPEC)
    a = create_model("xdeepfm", tpacked, tconfig, device="cpu", seed=5)
    b = create_model("xdeepfm", tpacked, tconfig, device="cpu", seed=5)
    c = create_model("xdeepfm", tpacked, tconfig, device="cpu", seed=6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["cin.conv_0_kernel"], sc["cin.conv_0_kernel"])
