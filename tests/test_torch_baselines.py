"""The port's ablation baselines (``lr``, ``fm``, ``dnn``) against the JAX
package's: the eval-mode forward from converted JAX parameters on logical
and packed tables, and two ``Trainer`` steps on the plain and sparse-fused
paths, on both table layouts, by test_torch_train.py's harness (the same
seeded numpy batch; the paths' JAX configurations).

Every run starts from one initial state, the JAX model's logical-layout
initialisation (its tables packed where a run uses packed tables): the
port initialises a packed table as the logical table of its seed, packed,
and the JAX package's own layout test (tests/test_sparse_opt.py) starts
both layouts from one state the same way. (The JAX packed initialisation
draws other weights, from which DNNOnly's first Dense kernel has one
element whose first-step gradient cancels to 1.5e-8 against a leaf median
of 6.9e-3: both packages compute it within their f32 summation noise
(-1.55e-8 and -1.71e-8), and Adam's normalisation turns that into steps
that differ by 0.024 lr, one element of 832 outside rtol.) Each step is
taken by the port from the JAX state before it (carried over with
``train_state_from_jax``) and held against the JAX state after it:
DNNOnly's dense-field biases have an exact gradient of 0 (its first
train-mode BatchNorm removes them), so Adam turns their rounding noise
into steps of up to lr that differ between the packages, and a second
step carried on from them would move single elements of the first Dense
kernel past rtol.

Tolerances: the forward at f32 rtol 2e-4 / atol 1e-5, as every served
score of the port (tests/test_torch_parity.py); each step by
``deepfm_tpu_torch/training/parity.py``'s rule (with the model's
``zero_gradient_leaves``) and losses rel 1e-6, as every train path of the
port.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from test_torch_train import (  # noqa: E402
    B,
    PATHS,
    _assert_state_matches,
    _data,
    _port_step,
    _port_trainer,
    _raw,
)
from torch_port_helpers import init_jax_model, jax_predict  # noqa: E402

from deepfm_tpu.config import config_from_dict as jax_config  # noqa: E402
from deepfm_tpu.models import create_model as jax_create_model  # noqa: E402
from deepfm_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from deepfm_tpu.utils.layout import pack_table  # noqa: E402
from deepfm_tpu_torch.config import config_from_dict  # noqa: E402
from deepfm_tpu_torch.convert import (  # noqa: E402
    params_from_jax,
    train_state_from_jax,
)
from deepfm_tpu_torch.models import (  # noqa: E402
    DNNOnly,
    FM,
    LogisticRegression,
    create_model,
)

torch.set_num_threads(1)

BASELINES = {"lr": LogisticRegression, "fm": FM, "dnn": DNNOnly}
LAYOUTS = ("logical", "packed")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("model", sorted(BASELINES))
def test_baseline_forward_matches_jax(model, layout):
    jpacked, jarr, tpacked, tarr = _data()
    pallas = {"table_layout": layout}
    jmodel = jax_create_model(model, jpacked, jax_config(
        _raw({}, model, pallas=pallas)))
    params, stats = init_jax_model(jmodel, jarr.ids, jarr.dense)
    want = jax_predict(jmodel, params, stats, jarr.ids, jarr.dense)
    config = config_from_dict(_raw({}, model, device="cpu", pallas=pallas))
    tmodel = create_model(model, tpacked, config, device="cpu")
    assert isinstance(tmodel, BASELINES[model])
    assert tmodel.table_layout == layout
    sd = params_from_jax(params, stats, tpacked, config)
    assert set(sd) == set(tmodel.state_dict())
    tmodel.load_state_dict(sd)
    tmodel.eval()
    with torch.inference_mode():
        got = tmodel.predict(torch.from_numpy(tarr.ids),
                             torch.from_numpy(tarr.dense))[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_baseline_parameters_are_the_jax_ones():
    """lr's only own parameter is a top-level bias (zeros, f32); fm has
    none; dnn has the DNN and its output head and no first-order term
    (its first-order column takes no gradient)."""
    _, jarr, tpacked, tarr = _data()
    own = {}
    for model in sorted(BASELINES):
        config = config_from_dict(_raw({}, model, device="cpu"))
        m = create_model(model, tpacked, config, device="cpu")
        own[model] = sorted({n.split(".")[0] for n, _ in m.named_parameters()}
                            - {"embedding"})
    assert own == {"dnn": ["dnn", "output_linear"], "fm": [], "lr": ["bias"]}
    config = config_from_dict(_raw({}, "lr", device="cpu"))
    lr = create_model("lr", tpacked, config, device="cpu")
    assert lr.bias.dtype == torch.float32 and torch.all(lr.bias == 0)
    dnn = create_model("dnn", tpacked, config_from_dict(
        _raw({}, "dnn", device="cpu")), device="cpu")
    dnn.train()
    loss = dnn(torch.from_numpy(tarr.ids), torch.from_numpy(tarr.dense)).sum()
    (grad,) = torch.autograd.grad(loss, [dnn.embedding.table_w16])
    assert torch.all(grad[:, -1] == 0)  # the first-order column
    assert torch.any(grad[:, :-1] != 0)


def _jax_run(model, path, clip, layout, tmp_path, monkeypatch):
    """Two JAX steps of ``path`` on ``layout`` (None: the path's JAX
    layout) from the logical initialisation; returns the JAX trainer, the
    states before and after each step (host copies) and the losses."""
    port_tr, jax_tr, jlayout, force = PATHS[path]
    if layout is not None:
        jax_tr, jlayout = port_tr, layout
    if force:
        monkeypatch.setenv("DEEPFM_TPU_FORCE_FUSED_ADAM", "1")
    jpacked, jarr, _, _ = _data()

    def trainer(lay):
        config = jax_config(_raw(
            {**jax_tr, "gradient_clip_norm": clip}, model,
            output_dir=str(tmp_path / lay), pallas={"table_layout": lay}))
        return JaxTrainer(jax_create_model(model, jpacked, config), jpacked,
                          config, jarr, jarr, jarr)

    jtrainer = trainer(jlayout)
    assert jtrainer.sparse_fused is (path == "sparse_fused")
    if jlayout == "packed":
        params = jax.device_get(trainer("logical").state.params)
        emb = dict(params["embedding"])
        for g in jpacked.lookup_groups:
            name, pack = f"table_w{g.width}", 128 // (g.width + 1)
            phys = jtrainer.state.params["embedding"][name].shape[0]
            emb[name] = jnp.asarray(
                pack_table(emb[name], g.width + 1, pack, phys))
        jtrainer.state = jtrainer.state.replace(
            params={**params, "embedding": emb})
        jtrainer._recompute_table_psq()
    batch = (jnp.asarray(jarr.ids), jnp.asarray(jarr.dense),
             jnp.asarray(jarr.labels), jnp.ones((B,), jnp.float32))
    states, losses = [jax.device_get(jtrainer.state)], []
    state = jtrainer.state
    for _ in range(2):
        state, loss = jtrainer._train_step(state, *batch)
        states.append(jax.device_get(state))
        losses.append(float(loss))
    return jtrainer, states, losses


def _steps_match_jax(model, path, clip, layout, tmp_path, monkeypatch):
    """Two steps, each from the JAX state before it (module docstring).
    ``layout`` None: the port's default logical tables against the path's
    JAX layout; else both packages on ``layout``."""
    jtrainer, jstates, jlosses = _jax_run(model, path, clip, layout,
                                          tmp_path, monkeypatch)
    _, _, tpacked, tarr = _data()
    pallas = None if layout is None else {"table_layout": layout}
    trainer = _port_trainer(tpacked, {**PATHS[path][0],
                                      "gradient_clip_norm": clip},
                            model, pallas)
    assert trainer.path == path
    assert trainer.model.table_layout == (layout or "logical")
    if layout is not None:
        assert jtrainer._table_layout == layout
    for k in range(2):
        train_state_from_jax(jstates[k], trainer)
        assert _port_step(trainer, tarr) == pytest.approx(jlosses[k],
                                                          rel=1e-6)
        assert int(trainer.state.step) == k + 1
        _assert_state_matches(trainer, jstates[k + 1], tpacked, steps=1)


# (path, clip) pairs each baseline takes on the port's default layout
STEP_CASES = [("plain", 1.0), ("sparse_fused", 1.0), ("sparse_fused", 0.0)]


@pytest.mark.parametrize("path,clip", STEP_CASES)
@pytest.mark.parametrize("model", sorted(BASELINES))
def test_baseline_two_steps_match_jax(model, path, clip, tmp_path,
                                      monkeypatch):
    """Logical tables in the port; the JAX sparse-fused path runs on packed
    tables, which are unpacked for the comparison."""
    _steps_match_jax(model, path, clip, None, tmp_path, monkeypatch)


@pytest.mark.parametrize("path", ["plain", "sparse_fused"])
@pytest.mark.parametrize("model", sorted(BASELINES))
def test_baseline_two_steps_on_packed_tables_match_jax(model, path, tmp_path,
                                                       monkeypatch):
    """Both packages on packed (phys, 128) tables; nothing is unpacked."""
    _steps_match_jax(model, path, 1.0, "packed", tmp_path, monkeypatch)
