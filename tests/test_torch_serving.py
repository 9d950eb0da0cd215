"""The port's serving slice end to end on the CPU, against the JAX package.

A small MovieLens-format dataset is generated, both packages fit their
adapters on it (the JAX one with ``data.use_native_sampler=false``), a JAX
xDeepFM at small widths is initialised and its weights carried over to the
port, saved with ``save_best``, and served through the port's ``serve``
prologue and HTTP server on an ephemeral port. /score, /recommend and
/health must agree with the JAX model on the same rows.

Tolerance: probabilities at f32 rtol 2e-4 / atol 1e-5, as in
tests/test_torch_parity.py (sums taken in another order).
"""

import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    config_pair,
    count_params,
    init_jax_model,
    jax_predict,
)

from deepfm_tpu.data.movielens import MovieLensAdapter as JaxAdapter  # noqa: E402
from deepfm_tpu.data.packing import pack_schema as jax_pack_schema  # noqa: E402
from deepfm_tpu.data.synthetic import (  # noqa: E402
    generate_movielens_like as jax_generate,
)
from deepfm_tpu.models import create_model as jax_create_model  # noqa: E402
from deepfm_tpu_torch.cli import _restore_predictor  # noqa: E402
from deepfm_tpu_torch.convert import params_from_jax  # noqa: E402
from deepfm_tpu_torch.data.movielens import MovieLensAdapter  # noqa: E402
from deepfm_tpu_torch.data.packing import pack_schema  # noqa: E402
from deepfm_tpu_torch.data.synthetic import generate_movielens_like  # noqa: E402
from deepfm_tpu_torch.models import create_model  # noqa: E402
from deepfm_tpu_torch.serving import (  # noqa: E402
    ScoringService,
    make_http_server,
)
from deepfm_tpu_torch.training.persistence import load_best, save_best  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=1e-5)
FILES = ("u.data", "u.user", "u.item")


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve")
    kw = dict(num_users=50, num_items=60, num_rows=2500, seed=11)
    jax_generate(root / "jax", **kw)
    generate_movielens_like(root / "port", **kw)
    return root


def _raw(root):
    return {
        "model_name": "xdeepfm",
        "seed": 42,
        "device": "cpu",
        "output_dir": str(root / "run"),
        "data": {
            "data_dir": str(root / "port"),
            "num_neg_train": 1,
            "num_neg_eval": 5,
            "use_native_sampler": False,
        },
        "feature": {"fm_embed_dim": 16},
        "dnn": {"hidden_units": [16, 8], "dropout": 0.0},
        "cin": {"layer_sizes": [16, 16, 8], "split_half": True},
        "training": {"batch_size": 64},
    }


@pytest.fixture(scope="module")
def fitted(data_dirs):
    jconfig, tconfig = config_pair(_raw(data_dirs))
    jadapter = JaxAdapter(jconfig.data, seed=jconfig.seed)
    tadapter = MovieLensAdapter(tconfig.data, seed=tconfig.seed)
    return jconfig, tconfig, jadapter, jadapter.build(), tadapter.build()


@pytest.fixture(scope="module")
def served(data_dirs, fitted):
    jconfig, tconfig, jadapter, jsplits, _ = fitted
    jpacked = jax_pack_schema(jsplits[0])
    jval = jsplits[2].pack(jpacked)
    jmodel = jax_create_model("xdeepfm", jpacked, jconfig)
    params, stats = init_jax_model(jmodel, jval.ids[:8], jval.dense[:8])

    model = create_model("xdeepfm", pack_schema(fitted[4][0]), tconfig,
                         device="cpu")
    model.load_state_dict(
        params_from_jax(params, stats, model.packed, tconfig)
    )
    save_best(model, tconfig.output_dir, epoch=1, best_metric=0.5)

    adapter, packed, _, _, _, predictor, _ = _restore_predictor(tconfig)
    service = ScoringService(adapter, packed, predictor, "xdeepfm")
    service.warmup()
    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address
    yield {
        "base": f"http://{host}:{port}",
        "jmodel": jmodel,
        "params": params,
        "stats": stats,
        "jadapter": jadapter,
        "jpacked": jpacked,
    }
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_generator_writes_the_same_files(data_dirs):
    for name in FILES:
        assert (data_dirs / "port" / name).read_bytes() == (
            data_dirs / "jax" / name
        ).read_bytes(), name


@pytest.mark.parametrize("split", [1, 2, 3], ids=["train", "val", "test"])
def test_adapter_packs_the_same_arrays(fitted, split):
    _, _, _, jsplits, tsplits = fitted
    jarr = jsplits[split].pack(jax_pack_schema(jsplits[0]))
    tarr = tsplits[split].pack(pack_schema(tsplits[0]))
    for name in ("ids", "dense", "labels", "weights", "user_ids"):
        np.testing.assert_array_equal(
            getattr(tarr, name), getattr(jarr, name), err_msg=name
        )


def test_score_matches_jax(served, data_dirs):
    raw = np.loadtxt(data_dirs / "port" / "u.data", dtype=np.int64)[:40]
    rows = [[int(u), int(m)] for u, m in raw[:, :2]]
    rows += [[10**9, int(raw[0, 1])], [int(raw[0, 0]), 10**9]]
    status, body = _post(f"{served['base']}/score", {"rows": rows})
    assert status == 200
    scores = body["scores"]
    assert scores[-2:] == [None, None] and body["n_scored"] == 40

    users = np.asarray([r[0] for r in rows], np.int64)
    items = np.asarray([r[1] for r in rows], np.int64)
    ds, kept = served["jadapter"].score_id_pairs(users, items)
    assert list(kept) == list(range(40))
    want = jax_predict(served["jmodel"], served["params"], served["stats"],
                       *_ids_dense(ds.pack(served["jpacked"])))
    np.testing.assert_allclose(np.asarray(scores[:40]), want, **TOL)


def _ids_dense(arrays):
    return arrays.ids, arrays.dense


def test_recommend_matches_jax(served, data_dirs):
    user = int(np.loadtxt(data_dirs / "port" / "u.data", dtype=np.int64)[0, 0])
    status, body = _get(f"{served['base']}/recommend?user={user}&k=5")
    assert status == 200 and body["user"] == user
    items = body["items"]

    ds, item_ids = served["jadapter"].recommend_candidates(user)
    assert len(items) == min(5, len(item_ids))
    want = jax_predict(served["jmodel"], served["params"], served["stats"],
                       *_ids_dense(ds.pack(served["jpacked"])))
    by_item = dict(zip(item_ids.tolist(), want.tolist()))
    got_scores = [it["score"] for it in items]
    assert got_scores == sorted(got_scores, reverse=True)
    np.testing.assert_allclose(
        got_scores, [by_item[it["item"]] for it in items], **TOL
    )
    np.testing.assert_allclose(got_scores, np.sort(want)[::-1][: len(items)], **TOL)


def test_health_counts_the_jax_parameters(served):
    status, body = _get(f"{served['base']}/health")
    assert status == 200
    assert body["status"] == "ok" and body["model"] == "xdeepfm"
    assert body["n_params"] == count_params(served["params"])


def test_client_errors(served):
    status, body = _post(f"{served['base']}/score", {"rows": "nope"})
    assert status == 400 and "rows" in body["error"]
    status, _ = _get(f"{served['base']}/recommend?user=999999999&k=3")
    assert status == 404
    status, _ = _get(f"{served['base']}/nope")
    assert status == 404


def test_best_checkpoint_round_trip(fitted, tmp_path):
    _, tconfig, _, _, tsplits = fitted
    packed = pack_schema(tsplits[0])
    a = create_model("xdeepfm", packed, tconfig, device="cpu", seed=1)
    b = create_model("xdeepfm", packed, tconfig, device="cpu", seed=2)
    save_best(a, tmp_path, epoch=3, best_metric=0.75)
    meta = load_best(b, tmp_path)
    assert meta == {"epoch": 3, "best_metric": 0.75, "table_layout": "logical"}
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    with pytest.raises(FileNotFoundError):
        load_best(b, tmp_path / "missing")


def test_cli_synth_data_writes_the_generator_files(tmp_path):
    from deepfm_tpu_torch.cli import main

    main(["synth-data", "--dir", str(tmp_path / "cli"), "--users", "20",
          "--items", "30", "--rows", "200", "--seed", "3"])
    jax_generate(tmp_path / "ref", num_users=20, num_items=30, num_rows=200,
                 seed=3)
    for name in FILES:
        assert (tmp_path / "cli" / name).read_bytes() == (
            tmp_path / "ref" / name
        ).read_bytes(), name


def test_serve_refuses_a_dataset_without_a_serving_path(tmp_path):
    from deepfm_tpu_torch.cli import serve_command
    from deepfm_tpu_torch.config import config_from_dict

    config = config_from_dict({
        "model_name": "xdeepfm", "device": "cpu",
        "output_dir": str(tmp_path),
        "data": {"dataset_name": "criteo_synthetic",
                 "synthetic_num_rows": 50, "synthetic_num_fields": 3,
                 "synthetic_vocab_size": 20},
    })
    with pytest.raises(SystemExit, match="serve: dataset"):
        serve_command(config, "127.0.0.1", 0)
    # an on-disk packed store has no serving path either
    from deepfm_tpu_torch.cli import main

    main(["synth-packed", "--dir", str(tmp_path / "store"), "--rows", "40",
          "--fields", "3", "--vocab", "20"])
    packed_cfg = config_from_dict({
        "model_name": "xdeepfm", "device": "cpu",
        "output_dir": str(tmp_path),
        "data": {"dataset_name": "packed",
                 "data_dir": str(tmp_path / "store")}})
    with pytest.raises(SystemExit, match="serve: dataset 'packed'"):
        serve_command(packed_cfg, "127.0.0.1", 0)


class _CountingPredictor:
    """Stand-in predictor: score = mean of the packed ids, scaled."""

    def __init__(self):
        self.calls = 0
        self.model = torch.nn.Linear(3, 4)  # 16 parameters

    @property
    def n_params(self):
        return sum(p.numel() for p in self.model.parameters())

    def predict(self, arrays):
        self.calls += 1
        return (np.asarray(arrays.ids, np.float64).mean(axis=1) % 997) / 997


def test_micro_batcher_coalesces_concurrent_scores(fitted):
    """Two /score calls inside one window share one predictor call and
    each gets exactly its own rows' scores."""
    tadapter_schema = fitted[4][0]
    adapter = MovieLensAdapter(fitted[1].data, seed=fitted[1].seed)
    adapter.build()
    packed = pack_schema(tadapter_schema)
    u, m = adapter.known_pair()
    solo = ScoringService(adapter, packed, _CountingPredictor(), "xdeepfm")
    want_a = solo.score({"rows": [[u, m]]})["scores"]
    want_b = solo.score({"rows": [[u, m], [10**9, m]]})["scores"]
    pred = _CountingPredictor()
    svc = ScoringService(adapter, packed, pred, "xdeepfm",
                         batch_window_ms=300.0)
    results = {}

    def call(key, rows):
        results[key] = svc.score({"rows": rows})

    threads = [
        threading.Thread(target=call, args=("a", [[u, m]])),
        threading.Thread(target=call, args=("b", [[u, m], [10**9, m]])),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert pred.calls == 1
    assert results["a"]["scores"] == want_a
    assert results["b"]["scores"] == want_b
    assert svc.health()["n_params"] == 16


def test_request_guards(fitted):
    from deepfm_tpu_torch.serving import ServingError

    adapter = MovieLensAdapter(fitted[1].data, seed=fitted[1].seed)
    adapter.build()
    packed = pack_schema(fitted[4][0])
    svc = ScoringService(adapter, packed, _CountingPredictor(), "xdeepfm",
                         max_rows=4)
    with pytest.raises(ServingError, match="too many rows"):
        svc.score({"rows": [[1, 1]] * 5})
    with pytest.raises(ServingError, match="timestamps"):
        svc.score({"rows": [[1, 1, -1]]})
    server = make_http_server(svc, "127.0.0.1", 0, max_body_bytes=64)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address
        status, body = _post(f"http://{host}:{port}/score",
                             {"rows": [[1, 2]] * 50})
        assert status == 413 and "too large" in body["error"]
        assert server.request_queue_size == 128
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
