"""The packed table layout and the row-gather lookup against the JAX package.

Every check runs on the same numpy arrays in both packages, at a small size:

  * ``deepfm_tpu_torch/utils/layout.py`` against ``deepfm_tpu/utils/layout.py``:
    ``pack_table`` / ``unpack_table``, ``convert_table_tree`` and
    ``tree_layout``, exact in both directions;
  * the packed init: dead lanes, padding and every field's row 0 are 0, and
    unpacking gives the logical model of the same seed;
  * DeepFM, xDeepFM and AttentionDeepFM scores on packed tables against the
    JAX models with ``table_layout: packed``, the JAX weights carried over
    without unpacking: rtol 2e-4 / atol 1e-5 (tests/test_torch_model.py's);
  * ``densify_rows_grad_packed``'s plain version against the JAX kernel
    (interpret mode) with the JAX package's own tolerance, rtol / atol 1e-5
    (tests/test_pallas.py), bit for bit against ``np.add.at`` packed, and
    dead lanes exactly 0;
  * the packed ``sparse_table_adam`` plain version against the JAX
    ``sparse_table_adam_packed`` (interpret) at the tolerances
    tests/test_torch_train_kernels.py holds the logical one to, and against
    the logical plain version on the unpacked state: p, mu, nu bit for bit,
    psq rel 1e-6 (another summation order);
  * ``row_gather``'s plain version against the JAX ``pallas_lookup`` with
    ``FORCE_INTERPRET`` set (tests/test_pallas.py): exact values, gradients
    rtol 1e-5; a width-17 table against ``jnp.take``;
  * a best checkpoint written in one layout served under a config of the
    other: equal scores, and the metadata names the layout.

The kernels are held against these plain versions on the card by
tests/test_torch_train_cuda.py and chip_smoke.py.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from test_torch_train_kernels import (  # noqa: E402
    _assert_moment_near_jax,
    _literal_adam,
)
from torch_port_helpers import (  # noqa: E402
    SYNTH_SPEC,
    config_pair,
    init_jax_model,
    jax_predict,
    random_features,
    schema_pair,
)

from deepfm_tpu.data.packing import pack_features as jax_pack  # noqa: E402
from deepfm_tpu.data.packing import pack_schema as jax_pack_schema  # noqa: E402
from deepfm_tpu.models import create_model as jax_create_model  # noqa: E402
from deepfm_tpu.ops.pallas import embedding_kernel  # noqa: E402
from deepfm_tpu.ops.pallas.packed_grad_kernel import (  # noqa: E402
    densify_rows_grad_packed as jax_densify_packed,
)
from deepfm_tpu.ops.pallas.sparse_adam_kernel import (  # noqa: E402
    sort_pairs as jax_sort_pairs,
)
from deepfm_tpu.ops.pallas.sparse_adam_kernel import (  # noqa: E402
    sparse_table_adam_packed,
)
from deepfm_tpu.utils import layout as jax_layout  # noqa: E402
from deepfm_tpu_torch.config import ConfigError  # noqa: E402
from deepfm_tpu_torch.convert import params_from_jax  # noqa: E402
from deepfm_tpu_torch.data.packing import pack_features, pack_schema  # noqa: E402
from deepfm_tpu_torch.models import (  # noqa: E402
    create_model,
    resolve_table_layout,
    tables_packed,
)
from deepfm_tpu_torch.ops.kernels import gather as gather_mod  # noqa: E402
from deepfm_tpu_torch.ops.kernels import packed_grad as packed_mod  # noqa: E402
from deepfm_tpu_torch.ops.kernels.gather import (  # noqa: E402
    row_gather,
    row_gather_lookup,
    row_gather_plain,
)
from deepfm_tpu_torch.ops.kernels.grad import sort_pairs  # noqa: E402
from deepfm_tpu_torch.ops.kernels.packed_grad import (  # noqa: E402
    densify_rows_grad_packed,
    packed_lookup,
)
from deepfm_tpu_torch.ops.kernels.sparse_adam import (  # noqa: E402
    sparse_table_adam,
    sparse_table_adam_plain,
)
from deepfm_tpu_torch.training.persistence import (  # noqa: E402
    load_best,
    save_best,
)
from deepfm_tpu_torch.training.trainer import Trainer  # noqa: E402
from deepfm_tpu_torch.utils import layout  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=1e-5)
LR, WD = 1e-3, 2e-5
MODELS = {
    "deepfm": {},
    "xdeepfm": {"cin": {"layer_sizes": [8, 8], "split_half": True}},
    "attention_deepfm": {"attention": {"num_heads": 2, "attention_dim": 16}},
}


def _raw(model="deepfm", layout_name="packed", **extra):
    raw = {
        "model_name": model,
        "device": "cpu",
        "dnn": {"hidden_units": [16, 8], "dropout": 0.0},
        "training": {"batch_size": 32},
        "pallas": {"table_layout": layout_name},
        **MODELS[model],
    }
    raw.update(extra)
    return raw


def _batch(n=24, seed=0):
    jschema, tschema = schema_pair(SYNTH_SPEC)
    feats = random_features(SYNTH_SPEC, n, seed)
    labels = np.zeros(n, np.float32)
    jpacked, tpacked = jax_pack_schema(jschema), pack_schema(tschema)
    return (jpacked, tpacked, jax_pack(jpacked, feats, labels),
            pack_features(tpacked, feats, labels))


def _tables(rng, tpacked):
    """A random logical table per width group, zero past its rows."""
    out = {}
    for group in tpacked.lookup_groups:
        spec = layout.table_specs(tpacked)[f"table_w{group.width}"]
        t = rng.normal(size=spec["logical_shape"]).astype(np.float32)
        t[group.total_rows:] = 0.0
        out[f"table_w{group.width}"] = t
    return out


# --- utils/layout.py -----------------------------------------------------


@pytest.mark.parametrize("dcol,pack,rows", [(17, 7, 1000), (9, 14, 333),
                                            (5, 25, 640), (65, 1, 50)])
def test_pack_and_unpack_match_jax(dcol, pack, rows):
    logical = np.random.default_rng(dcol).normal(size=(rows, dcol)).astype(
        np.float32)
    phys = -(-rows // pack)
    got = layout.pack_table(logical, dcol, pack, phys)
    want = jax_layout.pack_table(logical, dcol, pack, phys)
    np.testing.assert_array_equal(got, want)
    assert not got[:, pack * dcol:].any()
    back = layout.unpack_table(got, dcol, pack, rows)
    np.testing.assert_array_equal(back, logical)
    np.testing.assert_array_equal(
        back, jax_layout.unpack_table(want, dcol, pack, rows))
    # torch tensors in, torch tensors out, the same values
    t = layout.pack_table(torch.from_numpy(logical), dcol, pack, phys)
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), want)
    np.testing.assert_array_equal(
        layout.unpack_table(t, dcol, pack, rows).numpy(), logical)


def test_convert_table_tree_and_tree_layout_match_jax():
    _, tpacked, _, _ = _batch()
    jschema = schema_pair(SYNTH_SPEC)[0]
    jpacked = jax_pack_schema(jschema)
    logical = _tables(np.random.default_rng(1), tpacked)
    nested = {"embedding": {**logical, "proj_w8": np.ones((1, 8, 16))},
              "dnn": {"x": np.zeros(3)}}
    for to_packed in (True, False):
        got = layout.convert_table_tree(nested, tpacked, to_packed)
        want = jax_layout.convert_table_tree(nested, jpacked, to_packed)
        assert got.keys() == want.keys()
        for k in want["embedding"]:
            np.testing.assert_array_equal(got["embedding"][k],
                                          want["embedding"][k])
        assert got["dnn"] is nested["dnn"]
        assert (layout.tree_layout(got, tpacked)
                == jax_layout.tree_layout(want, jpacked)
                == ("packed" if to_packed else "logical"))
    packed_tree = layout.convert_table_tree(nested, tpacked, True)
    back = layout.convert_table_tree(packed_tree, tpacked, False)
    for k, v in logical.items():
        np.testing.assert_array_equal(back["embedding"][k], v)
    # the port's flat state_dict form, with torch tensors
    flat = {f"embedding.{k}": torch.from_numpy(v) for k, v in logical.items()}
    flat["dnn.bias"] = torch.zeros(2)
    fp = layout.convert_table_tree(flat, tpacked, True)
    assert layout.tree_layout(fp, tpacked) == "packed"
    for k in logical:
        np.testing.assert_array_equal(
            fp[f"embedding.{k}"].numpy(), packed_tree["embedding"][k])
    bad = {"embedding": {"table_w16": np.zeros((5, 5))}}
    with pytest.raises(ValueError, match="neither packed"):
        layout.tree_layout(bad, tpacked)


def test_layout_resolution():
    _, cfg = config_pair(_raw(layout_name="packed"))
    assert resolve_table_layout(cfg) is True and tables_packed(cfg) is True
    for name in ("auto", "logical"):
        _, cfg = config_pair(_raw(layout_name=name))
        assert resolve_table_layout(cfg) is False
    _, cfg = config_pair(_raw(layout_name="packed",
                              pallas={"table_layout": "packed",
                                      "use_embedding_kernel": True}))
    assert resolve_table_layout(cfg) is True and tables_packed(cfg) is False
    _, cfg = config_pair(_raw(layout_name="sideways"))
    with pytest.raises(ConfigError, match="table_layout"):
        resolve_table_layout(cfg)


# --- the packed model --------------------------------------------------------


@pytest.mark.parametrize("model", sorted(MODELS))
def test_packed_init_is_the_logical_init_packed(model):
    _, tpacked, _, _ = _batch()
    _, pcfg = config_pair(_raw(model, "packed"))
    _, lcfg = config_pair(_raw(model, "logical"))
    mp = create_model(model, tpacked, pcfg, device="cpu", seed=4)
    ml = create_model(model, tpacked, lcfg, device="cpu", seed=4)
    assert mp.table_layout == "packed" and ml.table_layout == "logical"
    specs = layout.table_specs(tpacked)
    sp, sl = mp.state_dict(), ml.state_dict()
    for group in tpacked.lookup_groups:
        name = f"table_w{group.width}"
        spec = specs[name]
        table = sp[f"embedding.{name}"]
        assert tuple(table.shape) == spec["packed_shape"]
        dcol, pack = spec["dcol"], spec["pack"]
        assert pack > 1 and mp.embedding.table_pack[name] == pack
        assert not table[:, pack * dcol:].any()  # dead lanes
        logical = layout.unpack_table(table, dcol, pack,
                                      spec["logical_shape"][0])
        assert not logical[group.total_rows:].any()  # padding
        assert not logical[np.unique(group.local_offsets)].any()  # row 0s
        assert torch.equal(logical, sl[f"embedding.{name}"])
    for k in sl:
        if "table_w" not in k:
            assert torch.equal(sp[k], sl[k]), k


@pytest.mark.parametrize("model", sorted(MODELS))
def test_packed_forward_matches_jax_packed(model):
    """Scores with carried weights, packed on both sides (no unpacking)."""
    jconfig, tconfig = config_pair(_raw(model, "packed"))
    jpacked, tpacked, jarr, tarr = _batch(n=40, seed=1)
    jmodel = jax_create_model(model, jpacked, jconfig)
    assert jmodel.packed_tables
    params, stats = init_jax_model(jmodel, jarr.ids, jarr.dense)
    assert jax_layout.tree_layout(params, jpacked) == "packed"
    want = jax_predict(jmodel, params, stats, jarr.ids, jarr.dense)
    sd = params_from_jax(params, stats, tpacked, tconfig)
    for name, w in params["embedding"].items():
        if name.startswith("table_w"):
            np.testing.assert_array_equal(sd[f"embedding.{name}"].numpy(),
                                          np.asarray(w))
    port = create_model(model, tpacked, tconfig, device="cpu")
    port.load_state_dict(sd)
    port.eval()
    with torch.inference_mode():
        got = port.predict(torch.from_numpy(tarr.ids),
                           torch.from_numpy(tarr.dense))[:, 0].numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_packed_gather_backward_is_the_packed_densify(monkeypatch):
    """The packed lookup's backward is always the densify wrapper, and the
    table's gradient is the logical gradient packed."""
    _, tpacked, _, tarr = _batch(n=32, seed=2)
    _, pcfg = config_pair(_raw("deepfm", "packed"))
    _, lcfg = config_pair(_raw("deepfm", "logical"))
    calls = []

    def counted(ct, ids, num_rows, pack):
        calls.append((num_rows, pack))
        return densify_rows_grad_packed(ct, ids, num_rows, pack)

    monkeypatch.setattr(packed_mod, "densify_rows_grad_packed", counted)
    ids, dense = torch.from_numpy(tarr.ids), torch.from_numpy(tarr.dense)
    grads = {}
    for name, cfg in (("packed", pcfg), ("logical", lcfg)):
        m = create_model("deepfm", tpacked, cfg, device="cpu", seed=2)
        m.train()
        m(ids, dense).sum().backward()
        grads[name] = {n: p.grad for n, p in m.named_parameters()}
    emb = create_model("deepfm", tpacked, pcfg, device="cpu").embedding
    assert sorted(calls) == sorted(
        (getattr(emb, n).shape[0] * pk, pk) for n, pk in emb.table_pack.items())
    specs = layout.table_specs(tpacked)
    for n, g in grads["logical"].items():
        got = grads["packed"][n]
        if "table_w" in n:
            spec = specs[n.split(".")[-1]]
            got = layout.unpack_table(got, spec["dcol"], spec["pack"],
                                      spec["logical_shape"][0])
        torch.testing.assert_close(got, g, rtol=1e-6, atol=1e-7)


# --- the kernels' plain versions ----------------------------------------------


@pytest.mark.parametrize("d,pack", [(17, 7), (9, 14), (5, 25)])
def test_densify_packed_matches_jax(d, pack):
    rng = np.random.default_rng(5)
    num_rows, n = 6000, 900
    ids = rng.integers(0, num_rows, n).astype(np.int32)
    ids[:40] = 0
    ids[40:80] = 777  # duplicates across one physical-row boundary
    ids[80:120] = 777 + pack - 777 % pack  # the first row of the next one
    ct = rng.normal(size=(n, d)).astype(np.float32)
    got = densify_rows_grad_packed(torch.from_numpy(ct),
                                   torch.from_numpy(ids), num_rows, pack)
    phys = -(-num_rows // pack)
    assert tuple(got.shape) == (phys, 128)
    logical = np.zeros((phys * pack, d), np.float32)
    np.add.at(logical, ids, ct)
    np.testing.assert_array_equal(
        got.numpy(), layout.pack_table(logical, d, pack, phys))
    want = np.asarray(jax_densify_packed(jnp.asarray(ct), jnp.asarray(ids),
                                         num_rows, pack))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.abs(got.numpy()[:, pack * d:]).max() == 0.0


def test_packed_lookup_forward_and_gradient():
    rng = np.random.default_rng(6)
    d, pack, phys, n = 17, 7, 300, 600
    logical = rng.normal(size=(phys * pack, d)).astype(np.float32)
    table = torch.from_numpy(layout.pack_table(logical, d, pack, phys))
    table.requires_grad_()
    ids = torch.from_numpy(rng.integers(0, phys * pack, n))
    up = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    rows = packed_lookup(table, ids, d, pack)
    assert torch.equal(rows, torch.from_numpy(logical)[ids])
    (g,) = torch.autograd.grad((rows * up).sum(), table)
    want = np.zeros((phys * pack, d), np.float32)
    np.add.at(want, ids.numpy(), up.numpy())
    np.testing.assert_array_equal(g.numpy(),
                                  layout.pack_table(want, d, pack, phys))


MOMENT_DTYPES = {"float32": (np.float32, torch.float32),
                 "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("moments", sorted(MOMENT_DTYPES))
@pytest.mark.parametrize("clip", [0.0, 5.0])
def test_packed_sparse_table_adam_matches_jax_and_logical(clip, moments):
    """The packed plain version against the JAX packed kernel (interpret),
    both on packed state, and against the logical plain version on the
    unpacked state."""
    d, pack, phys = 17, 7, 640
    rows = phys * pack
    jdt, tdt = MOMENT_DTYPES[moments]
    rng = np.random.default_rng(0)
    ids = rng.integers(0, rows, 3000).astype(np.int32)
    # multiples of 2^-12 in (-2, 2): their f32 sums are exact in any order
    ct = rng.integers(-8192, 8192, (3000, d)).astype(np.float32) / 4096.0
    logical = [rng.normal(size=(rows, d)).astype(np.float32) * s
               for s in (0.05, 0.01, 0.01)]
    logical[2] = logical[2] ** 2
    logical[1:] = [np.asarray(jnp.asarray(m).astype(jdt)) for m in logical[1:]]
    packed = [layout.pack_table(a, d, pack, phys) for a in logical]
    gnorm, step = 7.5, 3

    jsids, jcts = jax_sort_pairs(jnp.asarray(ids), jnp.asarray(ct))
    jp, jmu, jnu, jpsq = sparse_table_adam_packed(
        *(jnp.asarray(a) for a in packed), jsids, jcts, LR, WD, gnorm, clip,
        jnp.asarray(step, jnp.int32), pack,
    )
    sids, cts = sort_pairs(torch.from_numpy(ids), torch.from_numpy(ct))
    tstep = torch.tensor(step, dtype=torch.int32)
    tp = [_to_torch(a) for a in packed]
    assert tp[1].dtype == tdt
    *_, psq = sparse_table_adam(*tp, sids, cts, LR, WD, gnorm, clip, tstep,
                                pack=pack)
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    g = np.zeros((rows, d), np.float32)
    np.add.at(g, ids, ct)
    *_, mterms, vterms = _literal_adam(*logical[:1], g, *logical[1:], gnorm,
                                       clip, step, jdt)
    for got, want, terms in ((tp[1], jmu, mterms), (tp[2], jnu, vterms)):
        _assert_moment_near_jax(
            layout.unpack_table(got.float(), d, pack, rows).numpy(),
            layout.unpack_table(np.asarray(want).astype(np.float32), d,
                                pack, rows), terms, jdt)
    assert float(psq) == pytest.approx(float(jpsq), rel=1e-5)
    for t in tp:  # dead lanes stay 0
        assert not t[:, pack * d:].float().any()

    tl = [_to_torch(a) for a in logical]
    *_, lpsq = sparse_table_adam_plain(*tl, sids, cts, LR, WD, gnorm, clip,
                                       tstep)
    for a, b in zip(tp, tl):
        assert torch.equal(layout.unpack_table(a, d, pack, rows), b)
    assert float(psq) == pytest.approx(float(lpsq), rel=1e-6)


def test_row_gather_matches_pallas_lookup(monkeypatch):
    monkeypatch.setattr(embedding_kernel, "FORCE_INTERPRET", True)
    rng = np.random.default_rng(4)
    V, D, N = 1024, 16, 256
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, N).astype(np.int32)
    want = np.asarray(embedding_kernel.pallas_lookup(jnp.asarray(table),
                                                     jnp.asarray(ids)))
    got = row_gather(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)

    # gradients, with duplicates (tests/test_pallas.py's case)
    V, N = 512, 128
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, 8, N).astype(np.int32)
    jg = jax.grad(lambda t: jnp.sum(
        embedding_kernel.pallas_lookup(t, jnp.asarray(ids)) ** 2))(
        jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    (tg,) = torch.autograd.grad(
        (row_gather_lookup(t, torch.from_numpy(ids)) ** 2).sum(), t)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5)


def test_row_gather_width_17_and_out_of_range():
    rng = np.random.default_rng(8)
    table = rng.normal(size=(333, 17)).astype(np.float32)
    ids = rng.integers(0, 333, 500)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    got = row_gather(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    bad = torch.tensor([-1, 0, 333, 5])
    out = row_gather_plain(torch.from_numpy(table), bad)
    assert not out[0].any() and not out[2].any()
    assert torch.equal(out[1], torch.from_numpy(table[0]))
    assert torch.equal(out[3], torch.from_numpy(table[5]))


def test_gather_operands_are_what_the_kernel_takes():
    """The wrapper's host-side check: a contiguous 2-D float32 table and
    contiguous int64 ids on its device, anything else refused."""
    table = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    ids = torch.tensor([3, 1, 4, 1, 5], dtype=torch.int32)
    t, i = gather_mod.gather_operands(table.t().contiguous().t(), ids[::1])
    assert t.is_contiguous() and torch.equal(t, table)
    assert i.dtype == torch.int64 and torch.equal(i, ids.long())
    t2, i2 = gather_mod.gather_operands(table, ids.long())
    assert t2 is table
    with pytest.raises(TypeError, match="2-D float32"):
        gather_mod.gather_operands(table.double(), ids)
    with pytest.raises(TypeError, match="2-D float32"):
        gather_mod.gather_operands(table[0], ids)
    with pytest.raises(ValueError, match="1-D"):
        gather_mod.gather_operands(table, ids[None])
    with pytest.raises(ValueError, match="1-D"):
        gather_mod.gather_operands(table, ids.to("meta"))


def test_embedding_kernel_config_gathers_with_the_kernel(monkeypatch):
    """use_embedding_kernel: logical tables even under table_layout packed,
    the row-gather lookup in the forward, and a two-pass train step."""
    _, tpacked, _, tarr = _batch(n=32, seed=3)
    _, cfg = config_pair(_raw("deepfm", "packed",
                              pallas={"table_layout": "packed",
                                      "use_embedding_kernel": True}))
    model = create_model("deepfm", tpacked, cfg, device="cpu")
    assert model.table_layout == "logical"
    assert model.embedding.gather_kernel
    calls = []

    def counted(table, ids):
        calls.append(tuple(table.shape))
        return row_gather(table, ids)

    monkeypatch.setattr(gather_mod, "row_gather", counted)
    trainer = Trainer(model, tpacked, cfg)
    assert trainer.path == "two_pass" and not trainer.sparse_fused
    trainer._train_step(tarr.ids, tarr.dense, tarr.labels,
                        np.ones(32, np.float32))
    assert sorted(calls) == [(128, 9), (256, 17)]


# --- checkpoints across layouts ---------------------------------------------------


@pytest.mark.parametrize("saved,served", [("packed", "logical"),
                                          ("logical", "packed")])
def test_checkpoint_serves_under_the_other_layout(saved, served, tmp_path):
    _, tpacked, _, tarr = _batch(n=40, seed=5)
    _, scfg = config_pair(_raw("xdeepfm", saved))
    _, lcfg = config_pair(_raw("xdeepfm", served))
    a = create_model("xdeepfm", tpacked, scfg, device="cpu", seed=1)
    save_best(a, tmp_path, epoch=2, best_metric=0.5)
    b = create_model("xdeepfm", tpacked, lcfg, device="cpu", seed=9)
    meta = load_best(b, tmp_path)
    assert meta == {"epoch": 2, "best_metric": 0.5, "table_layout": saved}
    assert b.table_layout == served
    ids, dense = torch.from_numpy(tarr.ids), torch.from_numpy(tarr.dense)
    a.eval()
    b.eval()
    with torch.inference_mode():
        np.testing.assert_array_equal(b.predict(ids, dense).numpy(),
                                      a.predict(ids, dense).numpy())


def test_trainer_load_best_recomputes_the_carried_psq(tmp_path):
    _, tpacked, _, _ = _batch()
    _, pcfg = config_pair(_raw("deepfm", "packed"))
    _, lcfg = config_pair(_raw("deepfm", "logical"))
    save_best(create_model("deepfm", tpacked, lcfg, device="cpu", seed=3),
              tmp_path)
    trainer = Trainer(create_model("deepfm", tpacked, pcfg, device="cpu",
                                   seed=4), tpacked, pcfg)
    before = dict(trainer.state.table_psq)
    assert trainer.load_best(tmp_path)["table_layout"] == "logical"
    for name, p in trainer.params.items():
        if name in before:
            assert float(trainer.state.table_psq[name]) == pytest.approx(
                float(torch.sum(p.detach() ** 2)), rel=1e-6)
            assert float(trainer.state.table_psq[name]) != float(before[name])
