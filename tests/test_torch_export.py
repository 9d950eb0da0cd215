"""The port's serving export (``deepfm_tpu_torch/utils/export.py``) against
the JAX package's (``deepfm_tpu/utils/export.py``), on the CPU.

For each of the six models, and for DeepFM and xDeepFM restored from a
packed checkpoint (the port's model trained on packed tables, saved with
``save_best`` and restored into the logical serving model by
``load_best``), one set of JAX weights is initialised under the JAX
``serving_config`` and carried over with ``params_from_jax``. Held:

  * the port's artifact (``export_scoring`` -> ``save_scoring`` ->
    ``load_scoring``) scores within rtol 2e-4 / atol 1e-5 of the JAX
    artifact (``jax.export`` of the same weights) at batch 1 and 7, and a
    pinned-batch artifact at its batch (and refuses another);
  * the int8 tables and scales equal JAX's ``quantize_embedding_tables``
    bit for bit, within scale/2 of the f32 rows, the OOV row exact, and
    the int8 artifact scores within rtol 2e-4 / atol 1e-5 of JAX's int8
    artifact (``quantized_scoring_model``) at batch 1 and 7;
  * the quantized artifact holds no f32 table (by name and by bytes), is
    at least 2.5x smaller than the f32 one (the tables dominate at the
    vocabularies below; JAX's docstring reckons 3.2x for width 17) and, a
    bound on quality, scores within 0.05 of it
    (tests/test_torch_cli_export.py loads an artifact in a process
    without the package);
  * ``serving_config`` turns every kernel toggle, the packed layout and
    the mesh off and traces on the CPU.

Tolerance: rtol 2e-4 / atol 1e-5, as tests/test_torch_serving.py (sums in
another order).
"""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    config_pair,
    init_jax_model,
    random_features,
    schema_pair,
)

from deepfm_tpu.data.packing import pack_features as jax_pack  # noqa: E402
from deepfm_tpu.data.packing import pack_schema as jax_pack_schema  # noqa: E402
from deepfm_tpu.models import create_model as jax_create_model  # noqa: E402
from deepfm_tpu.utils import export as jexport  # noqa: E402
from deepfm_tpu_torch.config import config_from_dict  # noqa: E402
from deepfm_tpu_torch.convert import params_from_jax  # noqa: E402
from deepfm_tpu_torch.data.packing import pack_schema  # noqa: E402
from deepfm_tpu_torch.models import create_model  # noqa: E402
from deepfm_tpu_torch.training.persistence import load_best, save_best  # noqa: E402
from deepfm_tpu_torch.utils import export as texport  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=1e-5)
PINNED = 5
QUANT_TOL = 0.05
MIN_SHRINK = 2.5
# large vocabularies on the width-16 table, so the tables dominate the
# artifact as in a CTR deployment
SPEC = [
    ("user", "sparse", 30000, 16, 1),
    ("item", "sparse", 20000, 16, 1),
    ("tags", "sequence", 12, 8, 4),
    ("price", "dense", 0, 8, 1),
    ("hour", "dense", 0, 4, 1),
]
RAW = {
    "feature": {"fm_embed_dim": 8},
    "dnn": {"hidden_units": [16, 8], "dropout": 0.0},
    "cin": {"layer_sizes": [8, 8]},
    "attention": {"num_heads": 2, "attention_dim": 8},
    "device": "cpu",
}
MODELS = ["deepfm", "xdeepfm", "attention_deepfm", "lr", "fm", "dnn"]
CASES = [(m, "logical") for m in MODELS] + [("deepfm", "packed"),
                                            ("xdeepfm", "packed")]


def _batch(jpacked, n, seed):
    arr = jax_pack(jpacked, random_features(SPEC, n, seed),
                   np.zeros(n, np.float32))
    return np.asarray(arr.ids, np.int32), np.asarray(arr.dense, np.float32)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def case(request, tmp_path_factory):
    """Both packages' artifacts of one model's weights."""
    name, checkpoint = request.param
    tmp = tmp_path_factory.mktemp(f"export_{name}_{checkpoint}")
    jschema, tschema = schema_pair(SPEC)
    jpacked, tpacked = jax_pack_schema(jschema), pack_schema(tschema)
    jcfg, tcfg = config_pair({"model_name": name, **RAW})

    jmodel = jax_create_model(name, jpacked, jexport.serving_config(jcfg))
    ids, dense = _batch(jpacked, 8, seed=1)
    params, stats = init_jax_model(jmodel, ids, dense)
    jpath, jqpath = tmp / "jax.stablehlo", tmp / "jax_int8.stablehlo"
    jexport.save_scoring(jpath, jexport.export_scoring(
        jmodel, params, stats, jpacked.num_slots, jpacked.num_dense))
    jexport.save_scoring(jqpath, jexport.export_scoring(
        jexport.quantized_scoring_model(jcfg, jpacked, params), params,
        stats, jpacked.num_slots, jpacked.num_dense))

    scfg = texport.serving_config(tcfg)
    model = create_model(name, tpacked, scfg, device="cpu")
    if checkpoint == "packed":
        train_cfg = config_from_dict({"model_name": name, **RAW,
                                      "pallas": {"table_layout": "packed"}})
        trained = create_model(name, tpacked, train_cfg, device="cpu")
        trained.load_state_dict(params_from_jax(params, stats, tpacked,
                                                train_cfg))
        assert trained.table_layout == "packed"
        save_best(trained, tmp / "run")
        load_best(model, tmp / "run")
    else:
        model.load_state_dict(params_from_jax(params, stats, tpacked, scfg))
    assert model.table_layout == "logical"

    paths = {k: tmp / f"{k}.pt2" for k in ("f32", "pinned", "int8")}
    sizes = {
        "f32": texport.save_scoring(paths["f32"], texport.export_scoring(
            model, tpacked.num_slots, tpacked.num_dense)),
        "pinned": texport.save_scoring(paths["pinned"], texport.export_scoring(
            model, tpacked.num_slots, tpacked.num_dense,
            batch_size=PINNED)),
    }
    qmodel = texport.quantized_scoring_model(tcfg, tpacked, model)
    sizes["int8"] = texport.save_scoring(paths["int8"], texport.export_scoring(
        qmodel, tpacked.num_slots, tpacked.num_dense))
    return {
        "name": name, "jpacked": jpacked, "tpacked": tpacked,
        "params": params, "model": model, "qmodel": qmodel,
        "jax": jexport.load_scoring(jpath),
        "jax_int8": jexport.load_scoring(jqpath), "paths": paths,
        "sizes": sizes,
        "port": {k: texport.load_scoring(p) for k, p in paths.items()},
    }


@pytest.mark.parametrize("b", [1, 7])
def test_artifact_scores_as_jax(case, b):
    ids, dense = _batch(case["jpacked"], b, seed=10 + b)
    got = case["port"]["f32"](ids, dense)
    assert got.shape == (b,) and got.dtype == np.float32
    np.testing.assert_allclose(got, case["jax"](ids, dense), **TOL)


def test_artifact_matches_the_eager_model(case):
    ids, dense = _batch(case["jpacked"], 7, seed=3)
    with torch.no_grad():
        want = case["model"].predict(torch.from_numpy(ids),
                                     torch.from_numpy(dense))[:, 0].numpy()
    np.testing.assert_array_equal(case["port"]["f32"](ids, dense), want)


def test_pinned_batch(case):
    program = case["port"]["pinned"].program
    assert texport.input_shapes(program) == [
        (str(PINNED), str(case["tpacked"].num_slots)),
        (str(PINNED), str(case["tpacked"].num_dense))]
    ids, dense = _batch(case["jpacked"], PINNED, seed=5)
    np.testing.assert_allclose(case["port"]["pinned"](ids, dense),
                               case["jax"](ids, dense), **TOL)
    with pytest.raises(AssertionError, match="Guard failed"):
        case["port"]["pinned"](ids[:3], dense[:3])
    symbolic = texport.input_shapes(case["port"]["f32"].program)
    assert symbolic[0][0] == symbolic[1][0] and not symbolic[0][0].isdigit()


def test_int8_tables_equal_jax(case):
    want = jexport.quantize_embedding_tables(case["params"])
    got = texport.quantize_embedding_tables(case["model"])
    assert sorted(got) == sorted(want)
    for dcol, (q, scale) in want.items():
        assert got[dcol][0].dtype == np.int8
        assert got[dcol][1].dtype == np.float32
        np.testing.assert_array_equal(got[dcol][0], q)
        np.testing.assert_array_equal(got[dcol][1], scale)


@pytest.mark.parametrize("b", [1, 7])
def test_int8_artifact_scores_as_jax(case, b):
    ids, dense = _batch(case["jpacked"], b, seed=20 + b)
    got = case["port"]["int8"](ids, dense)
    assert got.shape == (b,) and got.dtype == np.float32
    np.testing.assert_allclose(got, case["jax_int8"](ids, dense), **TOL)


def test_int8_error_bound(case):
    tables = {n: p.detach().numpy() for n, p in case["model"].state_dict()
              .items() if n.startswith("embedding.table_w")}
    qtabs = texport.quantize_embedding_tables(case["model"])
    for t in tables.values():
        q, scale = qtabs[t.shape[1]]
        deq = q.astype(np.float32) * scale[:, None]
        assert np.all(np.abs(deq - t) <= scale[:, None] / 2 + 1e-7)
        np.testing.assert_array_equal(deq[0], 0.0)  # the OOV row


def test_quantized_artifact_holds_no_f32_table(case):
    program = case["port"]["int8"].program
    tensors = {**program.state_dict, **program.constants}
    assert not [n for n in tensors if "table_w" in n]
    assert not [n for n, _ in case["qmodel"].named_parameters()
                if "table_w" in n]
    table_shapes = {tuple(p.shape) for n, p in case["model"].state_dict()
                    .items() if n.startswith("embedding.table_w")}
    f32 = [n for n, t in tensors.items()
           if t.dtype == torch.float32 and tuple(t.shape) in table_shapes]
    assert not f32
    int8 = [t for t in tensors.values() if t.dtype == torch.int8]
    assert {tuple(t.shape) for t in int8} == table_shapes
    # by bytes: the program's tensors take no more than the f32 program's
    # less its f32 tables plus the int8 tables and f32 scales
    f32_program = case["port"]["f32"].program
    f32_bytes = sum(t.numel() * t.element_size() for t in
                    {**f32_program.state_dict,
                     **f32_program.constants}.values())
    table_bytes = sum(4 * r * c for r, c in table_shapes)
    q_bytes = sum(r * c + 4 * r for r, c in table_shapes)
    assert sum(t.numel() * t.element_size() for t in tensors.values()) \
        <= f32_bytes - table_bytes + q_bytes


def test_quantized_artifact_is_smaller_and_close(case):
    sizes = case["sizes"]
    assert sizes["f32"] >= MIN_SHRINK * sizes["int8"], sizes
    ids, dense = _batch(case["jpacked"], 64, seed=7)
    got = case["port"]["int8"](ids, dense)
    assert got.shape == (64,)
    assert np.abs(got - case["port"]["f32"](ids, dense)).max() < QUANT_TOL


def test_serving_config_turns_off_kernels_and_mesh():
    cfg = config_from_dict({
        "device": "auto",
        "pallas": {"table_layout": "packed", "use_embedding_kernel": True},
        "mesh": {"data_axis": -1, "model_axis": 2}})
    scfg = texport.serving_config(cfg)
    p = scfg.pallas
    assert not (p.use_embedding_kernel or p.use_cin_kernel
                or p.use_attention_kernel or p.use_grad_kernel)
    assert p.table_layout == "logical"
    assert (scfg.mesh.data_axis, scfg.mesh.model_axis) == (1, 1)
    assert scfg.device == "cpu"
    # the original is untouched
    assert cfg.pallas.table_layout == "packed" and cfg.device == "auto"


def test_export_refuses_what_it_cannot_trace():
    _, tschema = schema_pair(SPEC)
    tpacked = pack_schema(tschema)
    cfg = texport.serving_config(config_from_dict(RAW))
    model = create_model("deepfm", tpacked, cfg, device="cpu")
    with pytest.raises(ValueError, match="platform must be one of"):
        texport.export_scoring(model, tpacked.num_slots, tpacked.num_dense,
                               platform="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="move_to_device_pass"):
            texport.export_scoring(model, tpacked.num_slots,
                                   tpacked.num_dense, platform="cuda")
    with pytest.raises(ValueError, match="int8 table"):
        model.embedding.quantize_tables(
            {17: (np.zeros((3, 17), np.int8), np.ones(3, np.float32)),
             9: (np.zeros((3, 9), np.int8), np.ones(3, np.float32))})
