"""The port's ``predict`` and ``recommend`` commands against the JAX CLI's,
on the CPU.

A small MovieLens-format dataset (the port's ``synth-data``, plus one user
who has rated every item) is fitted by both CLIs with their defaults (the
native negative sampler on). A JAX xDeepFM of
``configs/xdeepfm_movielens_cin_tuned.yaml`` at small widths is built by
the JAX trainer and saved as the JAX run's best checkpoint; the same
weights, carried over with ``params_from_jax``, are the port's best
checkpoint. Held:

  * ``predict`` over a u.data file with rows of unknown ids writes the
    JAX command's kept rows, in order, with scores within the serving
    rule (rtol 2e-4 / atol 1e-5 of JAX, tests/test_torch_serving.py), and
    warns that it dropped the others;
  * ``recommend`` prints the JAX command's table: the same header, the
    same top-K items (ties of equal printed score in either order) with
    scores within the serving rule;
  * its refusals (``--k`` below 1, an unknown user, a user with no unseen
    item) are the JAX command's ``SystemExit`` messages.
"""

import contextlib
import logging

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.cli import _build_data as jax_build_data
from deepfm_tpu.cli import main as jax_main
from deepfm_tpu.config import load_config as jax_load_config
from deepfm_tpu.models import create_model as jax_create_model
from deepfm_tpu.training import persistence as jax_persistence
from deepfm_tpu.training.trainer import Trainer as JaxTrainer
from deepfm_tpu_torch.cli import main as port_main
from deepfm_tpu_torch.config import load_config
from deepfm_tpu_torch.convert import params_from_jax
from deepfm_tpu_torch.data.packing import pack_schema
from deepfm_tpu_torch.data.synthetic import build_adapter
from deepfm_tpu_torch.models import create_model
from deepfm_tpu_torch.training.persistence import save_best

torch.set_num_threads(1)

CONFIG = "configs/xdeepfm_movielens_cin_tuned.yaml"
TOL = dict(rtol=2e-4, atol=1e-5)
ITEMS = 40
ALL_SEEN_USER = 1


@contextlib.contextmanager
def _warnings_of(name):
    """The WARNING messages logged to ``name`` meanwhile (a handler on the
    logger itself: the package logger does not propagate to pytest's)."""
    messages = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: messages.append(record.getMessage())
    logger = logging.getLogger(name)
    logger.addHandler(handler)
    try:
        yield messages
    finally:
        logger.removeHandler(handler)


def _overrides(root, run):
    return [
        f"data.data_dir={root / 'data'}", "data.num_neg_train=1",
        "data.num_neg_eval=5", "feature.fm_embed_dim=8",
        "cin.layer_sizes=[8,8]", "dnn.hidden_units=[16,8]",
        "training.batch_size=64", "device=cpu", f"output_dir={root / run}",
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_predict")
    port_main(["synth-data", "--dir", str(root / "data"), "--users", "30",
               "--items", str(ITEMS), "--rows", "900", "--seed", "3"])
    u_data = root / "data" / "u.data"
    rows = np.loadtxt(u_data, dtype=np.int64).reshape(-1, 4)
    everything = np.stack([
        np.full(ITEMS, ALL_SEEN_USER), np.arange(1, ITEMS + 1),
        np.full(ITEMS, 4), rows[:, 3].max() - np.arange(ITEMS)], axis=1)
    np.savetxt(u_data, np.concatenate([rows, everything]), fmt="%d",
               delimiter="\t")
    # a scoring file: known rows, then rows of an unknown user and item
    score_rows = np.concatenate([rows[::7], [[9999, 1, 0, rows[0, 3]],
                                             [2, 9999, 0, rows[0, 3]]]])
    np.savetxt(root / "score.tsv", score_rows, fmt="%d", delimiter="\t")

    jconfig = jax_load_config(CONFIG, _overrides(root, "jax"))
    _, _, jpacked, train_d, val_d, test_d = jax_build_data(jconfig)
    jtrainer = JaxTrainer(jax_create_model("xdeepfm", jpacked, jconfig),
                          jpacked, jconfig, train_d, val_d, test_d)
    jax_persistence.save_best(jtrainer, 1, 0.5)

    tconfig = load_config(CONFIG, _overrides(root, "port"))
    adapter = build_adapter(tconfig.data, seed=tconfig.seed)
    packed = pack_schema(adapter.build()[0])
    model = create_model("xdeepfm", packed, tconfig, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.device_get(jtrainer.state.params),
        jax.device_get(jtrainer.state.batch_stats), packed, tconfig))
    save_best(model, tconfig.output_dir, epoch=1, best_metric=0.5)
    return root


def _cli(main, root, run, *args):
    main([args[0], "--config", CONFIG, "--override", *_overrides(root, run),
          *args[1:]])


def _tsv(path):
    rows = [line.split("\t") for line in path.read_text().splitlines()]
    return ([(int(u), int(i)) for u, i, _ in rows],
            np.array([float(s) for *_, s in rows]))


def test_predict_writes_the_jax_rows_and_scores(runs):
    _cli(jax_main, runs, "jax", "predict", "--input",
         str(runs / "score.tsv"), "--output", str(runs / "jax.tsv"))
    with _warnings_of("deepfm_tpu_torch") as warned:
        _cli(port_main, runs, "port", "predict", "--input",
             str(runs / "score.tsv"), "--output", str(runs / "port.tsv"))
    jkeys, jscores = _tsv(runs / "jax.tsv")
    tkeys, tscores = _tsv(runs / "port.tsv")
    total = len(np.loadtxt(runs / "score.tsv"))
    assert tkeys == jkeys and len(tkeys) == total - 2
    assert (9999, 1) not in tkeys and (2, 9999) not in tkeys
    np.testing.assert_allclose(tscores, jscores, **TOL)
    assert ((tscores > 0) & (tscores < 1)).all()
    assert f"dropped 2/{total} rows with unknown user/item ids" in warned
    line = (runs / "port.tsv").read_text().splitlines()[0]
    assert len(line.split("\t")[2].split(".")[1]) == 6  # %.6f


def _table(capsys):
    out = capsys.readouterr().out.splitlines()
    start = next(i for i, line in enumerate(out) if line.startswith("Top-"))
    rows = [line.split() for line in out[start + 2:] if line.strip()]
    return out[start:start + 2], [(int(r[1]), float(r[2])) for r in rows]


@pytest.mark.parametrize("user,k,seen", [(2, 5, False), (7, 50, False),
                                         (ALL_SEEN_USER, 3, True)])
def test_recommend_prints_the_jax_table(runs, capsys, user, k, seen):
    extra = ["--user", str(user), "--k", str(k)] + (
        ["--include-seen"] if seen else [])
    _cli(jax_main, runs, "jax", "recommend", *extra)
    jhead, jrows = _table(capsys)
    _cli(port_main, runs, "port", "recommend", *extra)
    thead, trows = _table(capsys)
    assert thead == jhead
    assert len(trows) == len(jrows) == min(k, len(trows))
    np.testing.assert_allclose([s for _, s in trows], [s for _, s in jrows],
                               **TOL)
    # the same items in the same order, ties of equal printed score aside
    for score in {s for _, s in jrows}:
        assert ({i for i, s in trows if s == score}
                == {i for i, s in jrows if s == score})


@pytest.mark.parametrize("args,message", [
    (["--user", "2", "--k", "0"], "recommend: --k must be >= 1, got 0"),
    (["--user", "99999"], "recommend: "),
    (["--user", str(ALL_SEEN_USER)],
     f"recommend: user {ALL_SEEN_USER} has no unseen items"),
])
def test_recommend_refuses_as_jax_does(runs, args, message):
    with pytest.raises(SystemExit) as jexit:
        _cli(jax_main, runs, "jax", "recommend", *args)
    with pytest.raises(SystemExit) as texit:
        _cli(port_main, runs, "port", "recommend", *args)
    assert str(texit.value) == str(jexit.value)
    assert str(texit.value).startswith(message)
