"""The port's train step against the JAX package's, for DeepFM, xDeepFM and
AttentionDeepFM.

Both packages build the model on the synthetic schema of the port's tests
(widths 16 and 8: two tables, a projection and two dense groups), the JAX
parameters are carried over with ``params_from_jax``, and both take two
steps on the same numpy batch at dropout 0 and f32 compute. Each of the
port's three paths is held against the JAX path with the same semantics:

  * the plain chain (``fused_table_adam: false``) against JAX's CPU
    default, the plain optax chain;
  * two-pass (``fused_backward: false``) against JAX with
    ``DEEPFM_TPU_FORCE_FUSED_ADAM=1`` and ``table_layout=logical``;
  * sparse-fused (the defaults) against JAX with
    ``DEEPFM_TPU_FORCE_FUSED_ADAM=1`` and ``table_layout=packed``, its
    packed tables and moments unpacked for the comparison;

with clip on (1.0, active) and off, for each model; and on packed tables
(``table_layout: packed`` in both packages, the tables and their moments
compared packed, with no unpacking): DeepFM on the three paths with clip
on and off, xDeepFM and AttentionDeepFM sparse-fused with clip on, and
DeepFM two-pass with ``use_embedding_kernel`` (the row-gather lookup; the
JAX package then takes two-pass too). xDeepFM runs with a
[8, 8] split-half CIN (the JAX CIN stack's Pallas kernels run in interpret
mode, the port's through ``CinStackFn`` and its plain backward), and
AttentionDeepFM with 2 heads of 8 (a=16, d=16: the shapes the JAX f-major
kernels take; ``DEEPFM_TPU_FORCE_ATTN_KERNEL=1``, set by tests/conftest.py,
runs them in interpret mode; the port's through ``AttentionBlockFn``).
Tolerances: those of the JAX
package's own two-path test (tests/test_sparse_fused.py) — losses rel
1e-6; parameters, table moments and BatchNorm statistics rtol 1e-5 / atol
1e-7; psq rel 1e-5 — with the two allowances of
``deepfm_tpu_torch/training/parity.py`` (Adam's normalisation turns the
last-bit differences of two summation orders into steps of up to lr; a
Dense bias feeding a train-mode BatchNorm has an exact gradient of 0).
Within the JAX package both paths share one model gradient and never see
this. Measured here on the CPU: at most 1 of 4352 table elements and 1 of
1152 bf16 moments lie outside rtol / atol.
"""

import gc
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    SYNTH_SPEC,
    init_jax_model,
    jax_predict,
    random_features,
    schema_pair,
)

from deepfm_tpu.config import config_from_dict as jax_config  # noqa: E402
from deepfm_tpu.data.packing import pack_features as jax_pack  # noqa: E402
from deepfm_tpu.data.packing import pack_schema as jax_pack_schema  # noqa: E402
from deepfm_tpu.models import create_model as jax_create_model  # noqa: E402
from deepfm_tpu.ops.dnn import DNN as JaxDNN  # noqa: E402
from deepfm_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from deepfm_tpu_torch.config import config_from_dict  # noqa: E402
from deepfm_tpu_torch.convert import (  # noqa: E402
    layout_table,
    params_from_jax,
    train_state_from_jax,
)
from deepfm_tpu_torch.data.packing import pack_features, pack_schema  # noqa: E402
from deepfm_tpu_torch.models import create_model  # noqa: E402
from deepfm_tpu_torch.ops.dnn import DNN  # noqa: E402
from deepfm_tpu_torch.ops.kernels import cin_stack  # noqa: E402
from deepfm_tpu_torch.training.parity import compare_leaves  # noqa: E402
from deepfm_tpu_torch.training.predict import Predictor  # noqa: E402
from deepfm_tpu_torch.training.trainer import (  # noqa: E402
    Trainer,
    sparse_fused_eligible,
)

torch.set_num_threads(1)

B = 32
LR = 1e-3
HIDDEN = [16, 8]
# model -> its config sections at the tests' small size
MODELS = {
    "deepfm": {},
    "xdeepfm": {"cin": {"layer_sizes": [8, 8], "split_half": True}},
    "attention_deepfm": {"attention": {"num_heads": 2, "attention_dim": 16}},
}
# path -> (port training overrides, JAX training overrides, JAX layout,
# JAX fused-kernel env)
PATHS = {
    "plain": ({"fused_table_adam": False}, {"fused_table_adam": False},
              "logical", False),
    "two_pass": ({"fused_backward": False}, {}, "logical", True),
    "sparse_fused": ({}, {}, "packed", True),
}


def _data():
    jschema, tschema = schema_pair(SYNTH_SPEC)
    feats = random_features(SYNTH_SPEC, B, seed=3)
    labels = np.random.default_rng(4).integers(0, 2, B).astype(np.float32)
    jpacked, tpacked = jax_pack_schema(jschema), pack_schema(tschema)
    return (jpacked, jax_pack(jpacked, feats, labels),
            tpacked, pack_features(tpacked, feats, labels))


def _raw(training, model="deepfm", **extra):
    tr = {"batch_size": B, "scheduler": "none", "lr": LR}
    tr.update(training)
    raw = {"model_name": model,
           "dnn": {"hidden_units": HIDDEN, "dropout": 0.0},
           "training": tr, **MODELS.get(model, {})}
    raw.update(extra)
    return raw


def _port_trainer(tpacked, training, model="deepfm", pallas=None, **extra):
    config = config_from_dict(_raw(training, model, device="cpu",
                                   pallas=pallas or {}, **extra))
    return Trainer(create_model(model, tpacked, config, device="cpu"),
                   tpacked, config)


def _jax_run(path, clip, tmp_path, monkeypatch, optimizer="adam",
             model="deepfm", pallas=None, training=None, **extra):
    """Two JAX steps; returns the JAX trainer, the states after steps 1
    and 2 (host copies) and the losses. ``pallas`` replaces the path's
    table layout (and then the JAX trainer takes the port's training
    overrides of the path); ``training`` adds training overrides; ``extra``
    replaces config sections."""
    port_tr, jax_tr, layout, force = PATHS[path]
    if pallas is not None:
        jax_tr = port_tr
    else:
        pallas = {"table_layout": layout}
    if force:
        monkeypatch.setenv("DEEPFM_TPU_FORCE_FUSED_ADAM", "1")
    jpacked, jarr, _, _ = _data()
    config = jax_config(_raw(
        {**jax_tr, "gradient_clip_norm": clip, "optimizer": optimizer,
         **(training or {})},
        model, output_dir=str(tmp_path), pallas=pallas, **extra,
    ))
    trainer = JaxTrainer(jax_create_model(model, jpacked, config),
                         jpacked, config, jarr, jarr, jarr)
    assert trainer.sparse_fused is (path == "sparse_fused")
    assert trainer.fused_tables is (path != "plain")
    batch = (jnp.asarray(jarr.ids), jnp.asarray(jarr.dense),
             jnp.asarray(jarr.labels), jnp.ones((B,), jnp.float32))
    states, losses = [jax.device_get(trainer.state)], []
    state = trainer.state
    for _ in range(2):
        state, loss = trainer._train_step(state, *batch)
        states.append(jax.device_get(state))
        losses.append(float(loss))
    return trainer, states, losses


def _port_step(trainer, tarr):
    return float(trainer._train_step(tarr.ids, tarr.dense, tarr.labels,
                                     np.ones(B, np.float32)))


def _assert_state_matches(trainer, jstate, tpacked, steps):
    """The port's parameters, BN statistics, table moments and psq against
    a JAX state (see the module docstring for the tolerances)."""
    want = params_from_jax(jstate.params, jstate.batch_stats, tpacked,
                           trainer.config)
    got = dict(trainer.model.state_dict())
    to_packed = trainer.model.table_layout == "packed"
    if jstate.table_opt is not None:
        for name, s in jstate.table_opt.items():
            mine = trainer.state.table_opt[f"embedding.{name}"]
            for m in ("mu", "nu"):
                w = layout_table(name, getattr(s, m), tpacked, to_packed)
                g = getattr(mine, m)
                assert str(g.dtype).endswith(str(w.dtype))
                want[f"{name}.{m}"] = w.astype(np.float32)
                got[f"{name}.{m}"] = g
    failed = compare_leaves(got, want, LR, steps, zero_gradient=(
        trainer.model.zero_gradient_leaves))["failed_leaves"]
    assert not failed, failed
    if jstate.table_psq is not None:
        for name, v in jstate.table_psq.items():
            got_psq = float(trainer.state.table_psq[f"embedding.{name}"])
            assert got_psq == pytest.approx(float(v), rel=1e-5)


def test_deepfm_forward_matches_jax():
    """Eval-mode scores with carried weights and moved BN statistics."""
    jpacked, jarr, tpacked, tarr = _data()
    jconfig = jax_config(_raw({}))
    jmodel = jax_create_model("deepfm", jpacked, jconfig)
    params, stats = init_jax_model(jmodel, jarr.ids, jarr.dense)
    want = jax_predict(jmodel, params, stats, jarr.ids, jarr.dense)
    config = config_from_dict(_raw({}, device="cpu"))
    model = create_model("deepfm", tpacked, config, device="cpu")
    model.load_state_dict(params_from_jax(params, stats, tpacked, config))
    model.eval()
    with torch.inference_mode():
        got = model.predict(torch.from_numpy(tarr.ids),
                            torch.from_numpy(tarr.dense))[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_batchnorm_train_statistics_match_flax():
    """One train-mode forward: outputs and batch_stats against flax's
    BatchNorm (biased variance E[x^2] - E[x]^2, 0.9 * old + 0.1 * new).
    ``nn.BatchNorm1d`` would carry the unbiased variance, 32/31 of it."""
    rng = np.random.default_rng(11)
    x = rng.normal(1.0, 2.0, size=(B, 10)).astype(np.float32)
    jdnn = JaxDNN(hidden_units=(12, 6), dropout=0.0, use_batch_norm=True)
    variables = jdnn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, mutated = jdnn.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    dnn = DNN(10, (12, 6), dropout=0.0, use_batch_norm=True)
    sd = params_from_jax(variables["params"], variables["batch_stats"],
                         None, None)
    dnn.load_state_dict(sd)
    dnn.train()
    got = dnn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for name, stats in mutated["batch_stats"].items():
        bn = getattr(dnn, name)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats["mean"]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats["var"]), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_two_steps_match_jax(path, clip, tmp_path, monkeypatch):
    _two_steps_match_jax("deepfm", path, clip, tmp_path, monkeypatch)


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("model", sorted(set(MODELS) - {"deepfm"}))
def test_two_steps_match_jax_per_model(model, path, clip, tmp_path,
                                       monkeypatch):
    _two_steps_match_jax(model, path, clip, tmp_path, monkeypatch)


def _two_steps_match_jax(model, path, clip, tmp_path, monkeypatch):
    _, jstates, jlosses = _jax_run(path, clip, tmp_path, monkeypatch,
                                   model=model)
    _, _, tpacked, tarr = _data()
    trainer = _port_trainer(tpacked, {**PATHS[path][0],
                                      "gradient_clip_norm": clip}, model)
    assert trainer.path == path
    train_state_from_jax(jstates[0], trainer)  # the same initial state
    losses = [_port_step(trainer, tarr) for _ in range(2)]
    assert losses == pytest.approx(jlosses, rel=1e-6)
    assert int(trainer.state.step) == 2
    _assert_state_matches(trainer, jstates[2], tpacked, steps=2)


PACKED_CASES = ([("deepfm", path, clip) for path in sorted(PATHS)
                 for clip in (1.0, 0.0)]
                + [(m, "sparse_fused", 1.0) for m in sorted(MODELS)
                   if m != "deepfm"])


@pytest.mark.parametrize("model,path,clip", PACKED_CASES)
def test_two_steps_on_packed_tables_match_jax(model, path, clip, tmp_path,
                                              monkeypatch):
    """Both packages on packed (phys, 128) tables; nothing is unpacked."""
    _packed_two_steps(model, path, clip, {"table_layout": "packed"},
                      tmp_path, monkeypatch)


def test_embedding_kernel_two_pass_matches_jax(tmp_path, monkeypatch):
    """use_embedding_kernel: the row-gather lookup forces logical tables,
    and the step takes two-pass in both packages."""
    _packed_two_steps("deepfm", "two_pass", 1.0,
                      {"table_layout": "packed", "use_embedding_kernel": True},
                      tmp_path, monkeypatch, port_training={})


def _packed_two_steps(model, path, clip, pallas, tmp_path, monkeypatch,
                      port_training=None):
    jtrainer, jstates, jlosses = _jax_run(path, clip, tmp_path, monkeypatch,
                                          model=model, pallas=pallas)
    _, _, tpacked, tarr = _data()
    training = PATHS[path][0] if port_training is None else port_training
    trainer = _port_trainer(tpacked, {**training, "gradient_clip_norm": clip},
                            model, pallas)
    assert trainer.path == path
    layout = ("logical" if pallas.get("use_embedding_kernel")
              else "packed")
    assert trainer.model.table_layout == jtrainer._table_layout == layout
    train_state_from_jax(jstates[0], trainer)
    for name, table in jstates[2].params["embedding"].items():
        if name.startswith("table_w"):
            mine = trainer.params[f"embedding.{name}"]
            assert tuple(mine.shape) == np.asarray(table).shape
            assert (mine.shape[1] == 128) is (layout == "packed")
    losses = [_port_step(trainer, tarr) for _ in range(2)]
    assert losses == pytest.approx(jlosses, rel=1e-6)
    _assert_state_matches(trainer, jstates[2], tpacked, steps=2)


# xDeepFM whose CIN backward does not fit one block of the stack kernel
# (239,104 bytes at F=5, D=16): the port takes the "layers" route
# (stack_route); the JAX package, with stack_tile patched to find no tile,
# takes its TPU fallbacks (the oracle forward, and backward_xla through
# cin_compress_pallas in interpret mode)
WIDE_CIN = {"cin": {"layer_sizes": [224, 224, 224], "split_half": False}}


@pytest.mark.parametrize("path", ["sparse_fused", "two_pass"])
def test_two_steps_match_jax_on_the_cin_layers_route(path, tmp_path,
                                                     monkeypatch):
    import deepfm_tpu.ops.pallas.cin_stack_kernel as jstack

    monkeypatch.setattr(jstack, "stack_tile", lambda *a, **k: None)
    _, jstates, jlosses = _jax_run(path, 1.0, tmp_path, monkeypatch,
                                   model="xdeepfm", **WIDE_CIN)
    _, _, tpacked, tarr = _data()
    trainer = _port_trainer(tpacked, {**PATHS[path][0],
                                      "gradient_clip_norm": 1.0},
                            "xdeepfm", **WIDE_CIN)
    assert trainer.path == path
    f, d = tpacked.num_fields, trainer.config.feature.fm_embed_dim
    layers = tuple(WIDE_CIN["cin"]["layer_sizes"])
    assert cin_stack.stack_route(B, f, d, layers, False, False) == "stack"
    assert cin_stack.stack_route(B, f, d, layers, False, True) == "layers"
    # the route of this f32 train step; the bf16 operand mode's backward
    # would take the stack
    assert trainer.config.training.compute_dtype == "float32"
    assert cin_stack.stack_route(B, f, d, layers, False, True,
                                 bf16=True) == "stack"
    calls = []
    real = cin_stack.cin_compress_layer
    monkeypatch.setattr(cin_stack, "cin_compress_layer",
                        lambda *a: calls.append(1) or real(*a))
    train_state_from_jax(jstates[0], trainer)
    losses = [_port_step(trainer, tarr) for _ in range(2)]
    assert len(calls) == 2 * len(layers)  # one remat per layer and step
    assert losses == pytest.approx(jlosses, rel=1e-6)
    _assert_state_matches(trainer, jstates[2], tpacked, steps=2)


def test_deleted_trainer_is_freed_without_the_cycle_collector():
    """The step closure does not hold its trainer, so a deleted trainer
    (and its model, tables and optimizer state) goes by reference count."""
    _, _, tpacked, tarr = _data()
    gc.disable()
    try:
        trainer = _port_trainer(tpacked, {}, "xdeepfm")
        _port_step(trainer, tarr)
        refs = [weakref.ref(o) for o in (
            trainer, trainer.model, trainer.state,
            trainer.params["embedding.table_w16"])]
        del trainer
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


WARMUP = {"scheduler": "warmup_cosine", "warmup_epochs": 2, "num_epochs": 4}


def test_warmup_schedule_matches_jax(tmp_path, monkeypatch):
    """warmup_cosine: both trainers start epoch 1 at lr / warmup, and the
    port takes its two steps there as JAX does."""
    jtrainer, jstates, jlosses = _jax_run("sparse_fused", 1.0, tmp_path,
                                          monkeypatch, training=WARMUP)
    _, _, tpacked, tarr = _data()
    trainer = _port_trainer(tpacked, {"gradient_clip_norm": 1.0, **WARMUP})
    assert trainer.scheduler.lr == jtrainer.scheduler.lr == LR / 2
    lr = trainer.state.opt_state.lr.clone()
    train_state_from_jax(jstates[0], trainer)
    assert torch.equal(trainer.state.opt_state.lr, lr)  # JAX's starting lr
    losses = [_port_step(trainer, tarr) for _ in range(2)]
    assert losses == pytest.approx(jlosses, rel=1e-6)
    _assert_state_matches(trainer, jstates[2], tpacked, steps=2)


def test_unknown_scheduler_raises_in_both_packages(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="Unknown scheduler: cyclic"):
        _jax_run("plain", 1.0, tmp_path, monkeypatch,
                 training={"scheduler": "cyclic"})
    _, _, tpacked, _ = _data()
    with pytest.raises(ValueError, match="Unknown scheduler: cyclic"):
        _port_trainer(tpacked, {"scheduler": "cyclic"})


def test_predictor_stages_within_the_budget(monkeypatch):
    """A 1 MiB staging budget splits the split into 3+ chunks of whole
    batches; the scores equal one chunk's, and no staged tensor is larger
    than the budget."""
    jschema, tschema = schema_pair(SYNTH_SPEC)
    tpacked = pack_schema(tschema)
    n, bs = 60_000, 4096
    feats = random_features(SYNTH_SPEC, n, seed=5)
    arrays = pack_features(tpacked, feats, np.zeros(n, np.float32))

    def predictor(budget_mb):
        config = config_from_dict(_raw({"batch_size": bs,
                                        "stage_budget_mb": budget_mb},
                                       device="cpu"))
        torch.manual_seed(0)
        model = create_model("deepfm", tpacked, config, device="cpu")
        return Predictor(model, tpacked, config, device="cpu")

    whole = predictor(1024)
    assert whole.budget_batches(arrays, bs) * bs >= n
    want = whole.predict(arrays)
    small = predictor(1)
    per_chunk = small.budget_batches(arrays, bs)
    assert -(-n // (per_chunk * bs)) >= 3
    staged = {}
    real = small.model.predict

    def recording(ids, dense):
        for t in (ids, dense):
            staged[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
        return real(ids, dense)

    monkeypatch.setattr(small.model, "predict", recording)
    got = small.predict(arrays)
    assert got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    assert len(staged) >= 2 * 3  # ids and dense of each chunk
    assert max(staged.values()) <= 1 << 20


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_plain_chain_optimizers_match_jax(optimizer, tmp_path, monkeypatch):
    _, jstates, jlosses = _jax_run("plain", 1.0, tmp_path, monkeypatch,
                                   optimizer=optimizer)
    _, _, tpacked, tarr = _data()
    trainer = _port_trainer(tpacked, {"optimizer": optimizer})
    assert trainer.path == "plain"
    train_state_from_jax(jstates[0], trainer)
    losses = [_port_step(trainer, tarr) for _ in range(2)]
    assert losses == pytest.approx(jlosses, rel=1e-6)
    _assert_state_matches(trainer, jstates[2], tpacked, steps=2)


def test_step_two_from_a_carried_jax_state(tmp_path, monkeypatch):
    """JAX takes step 1 (sparse-fused, packed tables, bf16 moments); its
    state is carried into the port, which takes step 2 as JAX does."""
    _, jstates, jlosses = _jax_run("sparse_fused", 1.0, tmp_path,
                                   monkeypatch)
    _, _, tpacked, tarr = _data()
    trainer = _port_trainer(tpacked, {})
    train_state_from_jax(jstates[1], trainer)
    assert int(trainer.state.step) == 1
    assert trainer.state.table_opt["embedding.table_w16"].mu.dtype \
        == torch.bfloat16
    _assert_state_matches(trainer, jstates[1], tpacked, steps=0)
    assert _port_step(trainer, tarr) == pytest.approx(jlosses[1], rel=1e-6)
    _assert_state_matches(trainer, jstates[2], tpacked, steps=1)


def test_paths_resolve_from_the_config():
    _, _, tpacked, _ = _data()
    cases = {
        (): "sparse_fused",
        (("fused_backward", False),): "two_pass",
        (("fused_table_adam", False),): "plain",
        (("optimizer", "adamw"),): "plain",
        (("optimizer", "sgd"),): "plain",
        (("optimizer", "lazy_adam"),): "lazy",
    }
    for overrides, path in cases.items():
        trainer = _port_trainer(tpacked, dict(overrides))
        assert trainer.path == path, overrides
        assert (trainer.state.table_psq is not None) is (path == "sparse_fused")
        assert (trainer.state.table_opt is not None) is (path != "plain")
    default = config_from_dict(_raw({}, device="cpu"))
    assert sparse_fused_eligible(default, tpacked)
    mu = _port_trainer(tpacked, {}).state.table_opt["embedding.table_w8"].mu
    assert mu.dtype == torch.bfloat16
    f32 = _port_trainer(tpacked, {"moments_dtype": "float32"})
    assert f32.state.table_opt["embedding.table_w8"].mu.dtype == torch.float32


def test_lazy_adam_is_refused():
    """lazy_adam is refused by the fused table paths, as in the JAX
    package: it takes its own lazy path, with f32 table moments whatever
    ``moments_dtype`` says (tests/test_torch_lazy_adam.py holds the path
    against JAX)."""
    _, _, tpacked, _ = _data()
    config = config_from_dict(_raw({"optimizer": "lazy_adam"}, device="cpu"))
    assert not sparse_fused_eligible(config, tpacked)
    trainer = _port_trainer(tpacked, {"optimizer": "lazy_adam",
                                      "moments_dtype": "bfloat16"})
    assert trainer.path == "lazy"
    assert not trainer.fused_tables and not trainer.sparse_fused
    assert trainer.state.table_psq is None
    assert all(s.mu.dtype == torch.float32
               for s in trainer.state.table_opt.values())


def test_trainer_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a GPU")
    _, _, tpacked, _ = _data()
    config = config_from_dict(_raw({}))
    model = create_model("deepfm", tpacked, config, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(model, tpacked, config)
