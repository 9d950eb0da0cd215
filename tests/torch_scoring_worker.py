"""Rank target of the port's sharded-scoring CPU test
(tests/test_torch_sharded_scoring.py), spawned by
``tests/torch_dp_worker.py::spawn`` on two gloo ranks. It drives the CLI's
serving commands on every rank, each building its own mesh from its
config. This module imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import signal
import threading
import time
import urllib.request
from pathlib import Path

# (data, model) mesh -> the overrides that ask for it on two ranks
MESHES = {
    "a2a_1x2": ("mesh.model_axis=2", "mesh.embedding_strategy=all_to_all"),
    "psum_1x2": ("mesh.model_axis=2", "mesh.embedding_strategy=psum"),
    "dp_2x1": (),
}
USER, K = 2, 5
# the group timeout an idle server is held to, and how long it idles
IDLE_TIMEOUT_S, IDLE_S = 3.0, 8.0


def scoring_config(root: Path, extra=()):
    """configs/xdeepfm_movielens_cin_tuned.yaml cut to small widths on the
    small MovieLens set under ``root``, its run in ``root / "run"``."""
    from deepfm_tpu_torch.config import load_config

    return load_config("configs/xdeepfm_movielens_cin_tuned.yaml", [
        f"data.data_dir={root / 'data'}", "data.num_neg_train=1",
        "data.num_neg_eval=5", "data.use_native_sampler=false",
        "feature.fm_embed_dim=8", "cin.layer_sizes=[8,8]",
        "dnn.hidden_units=[16,8]", "training.num_epochs=1",
        "training.batch_size=64", "device=cpu",
        f"output_dir={root / 'run'}", *extra])


def request_rows(adapter) -> dict:
    """The service's requests: one known pair, and several rows with an
    unknown user among them."""
    u, m = adapter.known_pair()
    return {"one": [[int(u), int(m)]],
            "many": [[int(u), int(m)], [10**9, int(m)], [USER, 3],
                     [USER, 7, 886400000], [5, 11]]}


def drive_service(service, adapter) -> dict:
    """A ScoringService's answers to the requests, its recommend and its
    health."""
    rows = request_rows(adapter)
    return {"one": service.score({"rows": rows["one"]}),
            "many": service.score({"rows": rows["many"]}),
            "recommend": service.recommend(USER, K),
            "health": service.health()}


def _http(url: str, payload=None) -> dict:
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=(
        "GET" if payload is None else "POST"),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def serve_until_sigint(mesh, root: Path, config) -> dict:
    """``serve_command`` on every rank: rank 0's server (on an ephemeral
    port) answers /health and /score, then SIGINT goes to every rank, as
    ``torch.distributed.run`` sends it; every rank must return."""
    from deepfm_tpu_torch import serving
    from deepfm_tpu_torch.cli import serve_command

    pids = root / "pids"
    pids.mkdir(exist_ok=True)
    (pids / f"{mesh.rank}").write_text(str(os.getpid()))
    answers = {}
    make = serving.make_http_server

    def client(server):
        base = "http://%s:%d" % server.server_address
        answers["health"] = _http(f"{base}/health")
        answers["many"] = _http(f"{base}/score", {
            "rows": request_rows(server.service.adapter)["many"]})
        for r in range(mesh.world):
            while not (pids / f"{r}").exists():
                time.sleep(0.05)
            os.kill(int((pids / f"{r}").read_text()), signal.SIGINT)

    def make_and_call(service, host, port):
        server = make(service, host, 0)
        server.service = service
        threading.Thread(target=client, args=(server,), daemon=True).start()
        return server

    serving.make_http_server = make_and_call
    try:
        serve_command(config, "127.0.0.1", 0)
    finally:
        serving.make_http_server = make
        signal.signal(signal.SIGINT, signal.default_int_handler)
    return answers


def idle_past_the_timeout(mesh, root: Path) -> dict:
    """A ScoringService over a ``RankScorer`` at (1, 2) with every
    collective's timeout cut to IDLE_TIMEOUT_S: rank 0 idles IDLE_S before
    it scores a request, while rank 1 waits in its broadcast, kept by rank
    0's heartbeat; then rank 0 stops it."""
    from datetime import timedelta

    from torch.distributed.distributed_c10d import _set_pg_timeout

    from deepfm_tpu_torch.cli import _restore_predictor
    from deepfm_tpu_torch.parallel import mesh as tmesh
    from deepfm_tpu_torch.serving import RankScorer, ScoringService

    config = scoring_config(root, MESHES["a2a_1x2"])
    adapter, packed, _, _, _, trainer, _ = _restore_predictor(config)
    saved = tmesh.group_timeout_s()
    _set_pg_timeout(timedelta(seconds=IDLE_TIMEOUT_S))
    tmesh._TIMEOUT_S[0] = IDLE_TIMEOUT_S
    try:
        scorer = RankScorer(trainer)
        if mesh.rank != 0:
            return {"dispatches": scorer.follow()}
        service = ScoringService(adapter, packed, scorer, config.model_name)
        time.sleep(IDLE_S)
        many = service.score({"rows": request_rows(adapter)["many"]})
        service.close()
        return {"many": many, "heartbeat_s": scorer.heartbeat_s}
    finally:
        _set_pg_timeout(timedelta(seconds=saved))
        tmesh._TIMEOUT_S[0] = saved


@contextlib.contextmanager
def recorded_scores(cls):
    """Meanwhile, every score array ``cls.predict`` returns, in call
    order."""
    real = cls.predict
    seen = []

    def predict(self, data):
        scores = real(self, data)
        seen.append(scores)
        return scores

    cls.predict = predict
    try:
        yield seen
    finally:
        cls.predict = real


def sharded_scoring(mesh, root: str) -> dict:
    """On each rank: ``predict`` at every mesh of MESHES into its own file
    (rank 1 must write none), ``recommend`` at (1, 2) (rank 1 must print
    nothing), a ScoringService over a ``RankScorer`` on rank 0 with the
    other rank following until the stop, the same idling past the group's
    timeout, ``serve`` stopped by SIGINT, and
    ``export`` into its own file (rank 1 must write none)."""
    from deepfm_tpu_torch.cli import (
        _restore_predictor,
        export_command,
        predict_command,
        recommend_command,
    )
    from deepfm_tpu_torch.serving import RankScorer, ScoringService
    from deepfm_tpu_torch.training.trainer import Trainer

    root = Path(root)
    r = mesh.rank
    out = {"rank": r, "predict": {}, "scores": {}}
    for name, extra in MESHES.items():
        path = root / f"{name}_rank{r}.tsv"
        with recorded_scores(Trainer) as scores:
            predict_command(scoring_config(root, extra),
                            str(root / "score.tsv"), str(path))
        out["predict"][name] = path.read_text() if path.exists() else None
        out["scores"][name], = scores
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        recommend_command(scoring_config(root, MESHES["a2a_1x2"]), USER, K,
                          include_seen=False)
    out["recommend"] = text.getvalue()

    # at (2, 1) a request of one row is one data index's share: the other
    # scores nothing and takes part only in the scores' all-gather
    out.update(service={}, follower_dispatches={}, after_stop={})
    for name in ("a2a_1x2", "dp_2x1"):
        config = scoring_config(root, MESHES[name])
        adapter, packed, _, _, _, trainer, _ = _restore_predictor(config)
        scorer = RankScorer(trainer)
        if name == "a2a_1x2":
            out["slab_numel"] = sum(p.numel()
                                    for p in trainer.model.parameters())
        if r == 0:
            service = ScoringService(adapter, packed, scorer,
                                     config.model_name)
            service.warmup()
            out["service"][name] = drive_service(service, adapter)
            service.close()
            try:
                scorer.predict(trainer.val_data)
            except RuntimeError as e:
                out["after_stop"][name] = str(e)
        else:
            out["follower_dispatches"][name] = scorer.follow()
    out["idle"] = idle_past_the_timeout(mesh, root)
    out["serve"] = serve_until_sigint(
        mesh, root, scoring_config(root, MESHES["a2a_1x2"]))

    artifact = root / f"export_rank{r}.pt2"
    out["export"] = export_command(scoring_config(root), str(artifact),
                                   "cpu", None)
    out["export_written"] = artifact.exists()
    return out
