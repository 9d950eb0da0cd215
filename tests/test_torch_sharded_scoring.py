"""The port's serving commands on two gloo ranks (sharded batch scoring),
against one process and against the JAX CLI on its 8-device CPU mesh.

A small MovieLens set (the port's ``synth-data``) and
configs/xdeepfm_movielens_cin_tuned.yaml at small widths
(``tests/torch_scoring_worker.py::scoring_config``). One process trains it
for one epoch and scores it: ``predict`` over a u.data file with rows of
unknown ids, ``recommend``, a ``ScoringService`` and ``export``. Then one
spawn of two ranks (``tests/torch_dp_worker.py::spawn``) runs the same
commands on every rank (``torch_scoring_worker.sharded_scoring``), each
building its mesh from its config: ``predict`` at (1, 2) with the
all_to_all and psum lookups (each table in two slabs) and at (2, 1);
``recommend`` at (1, 2); a ``ScoringService`` on rank 0 over a
``RankScorer`` while rank 1 follows, at (1, 2) and at (2, 1), where a
request of one row leaves rank 1 no row to score; ``serve`` stopped by
SIGINT sent to both ranks; ``export``. Held:

  * ``predict`` writes, on rank 0 alone, the one process's rows, and the
    scores are its bits on every mesh; at (1, 2) they are within 1e-5 of
    the JAX ``predict`` at ``mesh.model_axis=2`` on the same weights (a
    (4, 2) mesh over the conftest's 8 CPU devices);
  * ``recommend`` prints, on rank 0 alone, the one process's table;
  * the service answers as one process's (scores, unknown ids null,
    recommend, /health's whole-model count, which the slabs alone would
    undercount); rank 1 runs each dispatch and ends on the stop op, after
    which rank 0 refuses to dispatch; ``serve`` answers the same over HTTP
    and every rank returns after SIGINT (the spawn requires exit code 0);
  * an idle service keeps its ranks: with every collective's timeout cut
    to a few seconds, rank 1 waits past it and still scores the next
    request (rank 0's heartbeat);
  * a dispatch that fails on rank 0 after its broadcast (an error on a
    request, a SIGINT in the warmup) ends ``serve`` with ``RankFailure``
    and sends nothing more, not even the stop (in one process, the
    broadcasts recorded);
  * ``export`` on two ranks writes one artifact, whose scores are the one
    process's artifact's.
"""

import contextlib
import io
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_dp_worker  # noqa: E402
import torch_scoring_worker as worker  # noqa: E402
from torch_port_helpers import init_jax_model  # noqa: E402

from deepfm_tpu.cli import _build_data as jax_build_data  # noqa: E402
from deepfm_tpu.cli import main as jax_main  # noqa: E402
from deepfm_tpu.config import load_config as jax_load_config  # noqa: E402
from deepfm_tpu.models import create_model as jax_create_model  # noqa: E402
from deepfm_tpu.training import persistence as jax_persistence  # noqa: E402
from deepfm_tpu_torch.cli import (  # noqa: E402
    _restore_predictor,
    export_command,
    predict_command,
    recommend_command,
    train_command,
)
from deepfm_tpu_torch.cli import main as port_main  # noqa: E402
from deepfm_tpu_torch.convert import (  # noqa: E402
    _leaves,
    params_from_jax,
    torch_name,
)
from deepfm_tpu_torch import cli, serving  # noqa: E402
from deepfm_tpu_torch.parallel import build_mesh  # noqa: E402
from deepfm_tpu_torch.serving import (  # noqa: E402
    OP_PREDICT,
    RankFailure,
    RankScorer,
    ScoringService,
)
from deepfm_tpu_torch.training.predict import Predictor  # noqa: E402
from deepfm_tpu_torch.utils.export import load_scoring  # noqa: E402

torch.set_num_threads(1)

CONFIG = "configs/xdeepfm_movielens_cin_tuned.yaml"
JAX_TOL = dict(rtol=0, atol=1e-5)


def _jax_tree(template, sd: dict, stats: bool) -> dict:
    """A JAX params (or batch_stats) tree shaped as ``template`` holding
    the port's ``state_dict`` ``sd``: ``params_from_jax`` backwards (2-D
    kernels transposed back, logical tables as they are)."""
    out = {}
    for path, value in _leaves(template):
        if stats:
            t = sd[".".join(path[:-1]) + f".running_{path[-1]}"]
        else:
            t = sd[torch_name(path)]
            if path[-1] == "kernel" and t.dim() == 2:
                t = t.t()
        arr = t.detach().float().numpy().astype(np.asarray(value).dtype)
        assert arr.shape == np.shape(value), path
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return out


def _jax_checkpoint(root: Path, packed) -> None:
    """The port's best checkpoint under ``root / "run"`` saved as the JAX
    package's best checkpoint under ``root / "jax_run"``."""
    from types import SimpleNamespace

    jconfig = jax_load_config(CONFIG, _jax_overrides(root))
    _, _, jpacked, _, val_d, _ = jax_build_data(jconfig)
    jmodel = jax_create_model("xdeepfm", jpacked, jconfig)
    params, stats = init_jax_model(jmodel, val_d.ids[:8], val_d.dense[:8])
    sd = torch.load(root / "run" / "best_model.pt", weights_only=True)
    jparams = _jax_tree(params, sd, stats=False)
    jstats = _jax_tree(stats, sd, stats=True)
    back = params_from_jax(jparams, jstats, packed,
                           worker.scoring_config(root))
    assert all(torch.equal(back[k], sd[k]) for k in back
               if not k.endswith("num_batches_tracked"))
    jax_persistence.save_best(SimpleNamespace(
        state=SimpleNamespace(params=jparams, batch_stats=jstats),
        output_dir=root / "jax_run", _table_layout="logical"), 1, 0.5)


def _jax_overrides(root: Path, *extra) -> list:
    return [f"data.data_dir={root / 'data'}", "data.num_neg_train=1",
            "data.num_neg_eval=5", "data.use_native_sampler=false",
            "feature.fm_embed_dim=8", "cin.layer_sizes=[8,8]",
            "dnn.hidden_units=[16,8]", "training.batch_size=64",
            f"output_dir={root / 'jax_run'}", *extra]


def _table(text: str) -> list:
    lines = text.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("Top-"))
    return lines[start:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_scoring")
    port_main(["synth-data", "--dir", str(root / "data"), "--users", "30",
               "--items", "40", "--rows", "900", "--seed", "3"])
    rows = np.loadtxt(root / "data" / "u.data", dtype=np.int64)
    score_rows = np.concatenate([rows[::5], [[9999, 1, 0, rows[0, 3]],
                                             [2, 9999, 0, rows[0, 3]]]])
    np.savetxt(root / "score.tsv", score_rows, fmt="%d", delimiter="\t")

    config = worker.scoring_config(root)
    train_command(config)
    one = {}
    with worker.recorded_scores(Predictor) as scores:
        predict_command(config, str(root / "score.tsv"),
                        str(root / "one.tsv"))
    one["scores"], = scores
    one["predict"] = (root / "one.tsv").read_text()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        recommend_command(config, worker.USER, worker.K, include_seen=False)
    one["recommend"] = text.getvalue()
    adapter, packed, val_d, _, _, predictor, _ = _restore_predictor(config)
    one["n_params"] = predictor.n_params
    service = ScoringService(adapter, packed, predictor, config.model_name)
    service.warmup()
    one["service"] = worker.drive_service(service, adapter)
    export_command(config, str(root / "one.pt2"), "cpu", None)
    one["val"] = val_d

    ranks = torch_dp_worker.spawn(2, worker.sharded_scoring, (str(root),),
                                  root / "ranks")

    _jax_checkpoint(root, packed)
    jax_main(["predict", "--config", CONFIG, "--override",
              *_jax_overrides(root, "mesh.model_axis=2"), "--input",
              str(root / "score.tsv"), "--output", str(root / "jax.tsv")])
    return root, one, ranks


def _tsv(text: str):
    rows = [line.split("\t") for line in text.splitlines()]
    return [(int(u), int(i)) for u, i, _ in rows], np.array(
        [float(s) for *_, s in rows])


@pytest.mark.parametrize("mesh", list(worker.MESHES))
def test_predict_writes_the_one_process_rows_on_rank_0_alone(runs, mesh):
    root, one, ranks = runs
    assert ranks[0]["predict"][mesh] == one["predict"]
    assert ranks[1]["predict"][mesh] is None
    assert not (root / f"{mesh}_rank1.tsv").exists()
    keys, _ = _tsv(one["predict"])
    assert len(keys) == len(np.loadtxt(root / "score.tsv")) - 2


@pytest.mark.parametrize("mesh", list(worker.MESHES))
def test_sharded_scores_are_the_one_process_bits(runs, mesh):
    _, one, ranks = runs
    want = one["scores"]
    for r in ranks:
        assert r["scores"][mesh].dtype == want.dtype
        np.testing.assert_array_equal(r["scores"][mesh], want)


def test_predict_at_1x2_is_within_1e_5_of_the_jax_mesh_predict(runs):
    root, _, ranks = runs
    jkeys, jscores = _tsv((root / "jax.tsv").read_text())
    for mesh in ("a2a_1x2", "psum_1x2"):
        keys, scores = _tsv(ranks[0]["predict"][mesh])
        assert keys == jkeys
        np.testing.assert_allclose(scores, jscores, **JAX_TOL)


def test_recommend_prints_the_one_process_table_on_rank_0_alone(runs):
    _, one, ranks = runs
    table = _table(one["recommend"])
    assert len(table) == 2 + worker.K
    assert _table(ranks[0]["recommend"]) == table
    assert ranks[1]["recommend"] == ""


@pytest.mark.parametrize("mesh", ["a2a_1x2", "dp_2x1"])
def test_the_service_on_rank_0_answers_as_one_process(runs, mesh):
    _, one, ranks = runs
    got = ranks[0]["service"][mesh]
    assert got == one["service"]
    assert got["many"]["scores"][1] is None and got["many"]["n_scored"] == 4
    # the warmup, two /score dispatches and a /recommend, then the stop
    assert ranks[1]["follower_dispatches"][mesh] == 4
    assert "stopped" in ranks[0]["after_stop"][mesh]


def test_health_counts_the_whole_model_not_the_slabs(runs):
    _, one, ranks = runs
    assert ranks[0]["service"]["a2a_1x2"]["health"]["n_params"] == one[
        "n_params"]
    assert ranks[0]["serve"]["health"]["n_params"] == one["n_params"]
    assert all(r["slab_numel"] < one["n_params"] for r in ranks)


def test_serve_answers_and_every_rank_returns_after_sigint(runs):
    _, one, ranks = runs
    assert ranks[0]["serve"]["many"] == one["service"]["many"]
    assert ranks[1]["serve"] == {}


def test_export_on_two_ranks_writes_one_artifact(runs):
    root, one, ranks = runs
    assert [r["export_written"] for r in ranks] == [True, False]
    assert ranks[1]["export"] == {} and ranks[0]["export"]["max_abs_err"] \
        <= 1e-4
    val = one["val"]
    want = load_scoring(root / "one.pt2")(val.ids, val.dense)
    got = load_scoring(root / "export_rank0.pt2")(val.ids, val.dense)
    np.testing.assert_array_equal(got, want)


def test_an_idle_service_keeps_its_ranks_past_the_group_timeout(runs):
    _, one, ranks = runs
    assert worker.IDLE_S > 2 * worker.IDLE_TIMEOUT_S
    assert ranks[0]["idle"]["heartbeat_s"] == worker.IDLE_TIMEOUT_S / 4
    assert ranks[0]["idle"]["many"] == one["service"]["many"]
    assert ranks[1]["idle"] == {"dispatches": 1}


class _FailingTrainer:
    """A Trainer on a mesh of one rank whose ``fail_at``-th predict raises
    ``error``; the others score through the one-process predictor."""

    def __init__(self, predictor, fail_at: int, error: BaseException):
        self.mesh = build_mesh(1, 1, n=1, device="cpu")
        self.model = predictor.model
        self.predictor, self.fail_at, self.error = predictor, fail_at, error
        self.calls = 0

    def predict(self, data):
        self.calls += 1
        if self.calls == self.fail_at:
            raise self.error
        return self.predictor.predict(data)


@pytest.mark.parametrize("fail_at, error", [
    (1, KeyboardInterrupt()), (2, RuntimeError("CUDA out of memory"))],
    ids=["sigint_in_warmup", "error_on_a_request"])
def test_a_dispatch_that_fails_after_its_broadcast_ends_serve(
        runs, monkeypatch, fail_at, error):
    root, _, _ = runs
    config = worker.scoring_config(root)
    *head, predictor, _ = _restore_predictor(config)
    trainer = _FailingTrainer(predictor, fail_at, error)
    monkeypatch.setattr(cli, "_restore_predictor",
                        lambda *a, **k: (*head, trainer, trainer.mesh))
    sent = []
    monkeypatch.setattr(RankScorer, "_send",
                        lambda self, op, arrays=None: sent.append(op))
    replies, clients, done = [], [], threading.Event()
    make = serving.make_http_server

    def client(server):
        base = "http://%s:%d" % server.server_address
        try:
            worker._http(f"{base}/score", {"rows": [[2, 3]]})
        except Exception as e:  # the 500
            replies.append(getattr(e, "code", e))
        if not done.wait(60):
            replies.append("still serving")
            server.shutdown()

    def make_and_call(service, host, port):
        server = make(service, host, 0)
        clients.append(threading.Thread(target=client, args=(server,)))
        clients[-1].start()
        return server

    monkeypatch.setattr(serving, "make_http_server", make_and_call)
    try:
        with pytest.raises(RankFailure, match="out of step") as info:
            cli.serve_command(config, "127.0.0.1", 0)
    finally:
        done.set()
        for c in clients:
            c.join(60)
    assert info.value.__cause__ is error
    assert trainer.calls == fail_at
    # the failed dispatch's broadcast, and no stop after it
    assert sent == [OP_PREDICT] * fail_at
    assert replies == ([] if fail_at == 1 else [500])
