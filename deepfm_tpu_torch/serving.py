"""Online scoring service: JSON-over-HTTP serving for a trained model.

Port of ``deepfm_tpu/serving.py``. The fitted adapter's ``score_id_pairs``
and ``recommend_candidates`` feed a ``Predictor``
(``training/predict.py``) behind a dependency-free stdlib HTTP server:

  GET  /health              -> model/checkpoint metadata
  POST /score               -> {"rows": [[user, item, ts?], ...]}
                               => per-row pCTR (null for unknown ids)
  GET  /recommend?user=U&k=K[&include_seen=1]
                            -> top-K items for one user

Concurrency model: the HTTP layer is a ThreadingHTTPServer; device work
serializes behind one lock. An optional micro-batching window
(``batch_window_ms``) coalesces concurrent /score requests into one
device dispatch. Request bodies above ``max_body_bytes`` are rejected 413
before allocation; /score requests above ``max_rows`` rows are rejected
400.

On N ranks (``serve`` under ``python -m torch.distributed.run``) rank 0
holds the HTTP server and the service, whose predictor is a
``RankScorer`` around the ``Trainer``: every device dispatch (the warmup,
each /score dispatch, coalesced or not, and each /recommend) first
broadcasts its rows from rank 0 over the world, and then every rank runs
the same ``Trainer.predict`` (each data index scores its share; the model
peers of a data row serve its lookups together), both inside the
service's device lock, so that two HTTP threads never interleave their
collectives. The other ranks wait in ``RankScorer.follow`` for the next
dispatch, kept from the group's timeout while the server idles by rank
0's no-op heartbeat; ``ScoringService.close`` (after any dispatch in
flight) sends the stop that ends their wait. A dispatch that fails on
rank 0 after its broadcast ends the run (``RankScorer.failed``): ranks
out of step must not go on answering.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

DEFAULT_MAX_ROWS = 16384
DEFAULT_MAX_BODY_BYTES = 8 << 20  # 8 MB


class ServingError(ValueError):
    """Client error (HTTP 4xx): bad request shape or unknown entity."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


class MicroBatcher:
    """Coalesce concurrent submissions into one backend call.

    The first arrival in an empty window becomes the LEADER: it sleeps
    ``window_s``, swaps out everything that queued up meanwhile, runs
    ``fn`` once on the concatenated arrays, and distributes per-request
    slices. Followers block on an event. Exceptions propagate to every
    request in the batch (they share the failed dispatch).
    """

    def __init__(self, fn, window_s: float):
        self._fn = fn
        self._window = window_s
        self._lock = threading.Lock()
        self._pending: list[tuple[tuple, threading.Event, dict]] = []

    def submit(self, users, items, ts):
        ev = threading.Event()
        slot: dict = {}
        with self._lock:
            self._pending.append(((users, items, ts), ev, slot))
            leader = len(self._pending) == 1
        if leader:
            time.sleep(self._window)
            with self._lock:
                batch, self._pending = self._pending, []
            arrays = [b[0] for b in batch]
            try:
                out = self._fn(
                    np.concatenate([a[0] for a in arrays]),
                    np.concatenate([a[1] for a in arrays]),
                    np.concatenate([a[2] for a in arrays]),
                )
                off = 0
                for (u, _, _), bev, bslot in batch:
                    bslot["res"] = out[off : off + len(u)]
                    off += len(u)
                    bev.set()
            except Exception as e:  # pragma: no cover - device failure
                for _, bev, bslot in batch:
                    bslot["err"] = e
                    bev.set()
        else:
            # the leader's dispatch bounds the wait; 120 s covers a
            # first kernel build on a cold start
            if not ev.wait(timeout=self._window + 120.0):
                raise ServingError("scoring backend timed out", 503)
        if "err" in slot:
            raise slot["err"]
        return slot["res"]


# what rank 0 broadcasts ahead of each dispatch (``RankScorer``)
OP_STOP, OP_PREDICT, OP_NOOP = 0, 1, 2


class RankFailure(RuntimeError):
    """A dispatch failed on rank 0 after its broadcast: the other ranks may
    wait in its collectives, so no rank may dispatch again."""


class RankScorer:
    """The predictor of a ``ScoringService`` on N ranks: ``predict`` on
    rank 0 broadcasts the rows over the world (an op code and the row
    count, then the ids and dense values in one int32 buffer, the dense
    floats' bits as they are) and runs ``Trainer.predict``, whose scores
    every rank gets; ``follow`` on every other rank receives each
    broadcast and runs the same ``Trainer.predict``, until ``stop``.

    The followers wait for the next dispatch inside a broadcast, which
    raises after the group's timeout (``mesh.group_timeout_s``). So rank
    0 broadcasts a no-op whenever it has sent nothing for ``heartbeat_s``,
    a quarter of that timeout, from a thread of its own, and an idle
    server keeps its ranks. Anything that fails on rank 0 between a
    broadcast and the end of its dispatch (an error, a SIGINT) leaves the
    ranks out of step: the scorer is then ``failed``, dispatches and
    stops nothing more, calls ``on_failure`` and raises ``RankFailure``
    from ``raise_if_failed``."""

    def __init__(self, trainer):
        from deepfm_tpu_torch.parallel.mesh import group_timeout_s

        self.trainer = trainer
        self.mesh = trainer.mesh
        self.heartbeat_s = group_timeout_s() / 4
        # called once, on rank 0, when a dispatch fails (serve stops)
        self.on_failure = None
        self.failed: BaseException | None = None
        self._stopped = False
        # one broadcast and its dispatch at a time, the heartbeat's too
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._done = threading.Event()
        if self.mesh.rank == 0:
            threading.Thread(target=self._beat, daemon=True).start()

    @property
    def n_params(self) -> int:
        """The whole model's parameter count, as ``Predictor.n_params``
        counts one process's: a table cut into slabs over a model axis of
        m (``FeatureEmbedding.shard_tables``) counts m slabs, its whole
        rows, as the JAX package counts a global array."""
        from deepfm_tpu_torch.parallel.sharding import is_table_path

        model = self.trainer.model
        shard = getattr(getattr(model, "embedding", None), "shard", None)
        m = 1 if shard is None else shard[1]
        return sum(p.numel() * (m if is_table_path(n) else 1)
                   for n, p in model.named_parameters())

    def _send(self, op: int, arrays=None) -> None:
        import torch

        from deepfm_tpu_torch.parallel import collectives

        n, slots, dense = (0, 0, 0) if arrays is None else (
            len(arrays), arrays.ids.shape[1], arrays.dense.shape[1])
        self._last = time.monotonic()
        collectives.broadcast_(self.mesh, torch.tensor([op, n, slots, dense],
                                                       dtype=torch.int64))
        if arrays is not None:
            rows = np.concatenate([
                np.ascontiguousarray(arrays.ids, np.int32),
                np.ascontiguousarray(arrays.dense, np.float32).view(np.int32),
            ], axis=1)
            collectives.broadcast_(self.mesh, torch.from_numpy(rows))

    def _receive(self):
        """Rank 0's next op and, for a dispatch, its rows."""
        import torch

        from deepfm_tpu_torch.data.packing import PackedArrays
        from deepfm_tpu_torch.parallel import collectives

        head = collectives.broadcast_(self.mesh,
                                      torch.zeros(4, dtype=torch.int64))
        op, n, slots, dense = (int(x) for x in head)
        if op != OP_PREDICT:
            return op, None
        rows = collectives.broadcast_(
            self.mesh, torch.empty((n, slots + dense), dtype=torch.int32)
        ).numpy()
        return op, PackedArrays(
            rows[:, :slots], rows[:, slots:].view(np.float32),
            np.zeros(n, np.float32), np.ones(n, np.float32))

    def _fail(self, e: BaseException) -> None:
        self.failed = e
        self._done.set()
        if self.on_failure is not None:
            self.on_failure()

    def raise_if_failed(self) -> None:
        if self.failed is not None:
            raise RankFailure(
                "a dispatch failed on rank 0 after its broadcast, so the "
                "other ranks are out of step: the run ends") from self.failed

    def _run(self, op: int, arrays=None):
        """Broadcast ``op`` and run its dispatch (rank 0, under the lock)."""
        self.raise_if_failed()
        if self._stopped:
            raise RuntimeError("the ranks were stopped: no more dispatches")
        try:
            self._send(op, arrays)
            return None if arrays is None else self.trainer.predict(arrays)
        except BaseException as e:
            self._fail(e)
            raise

    def predict(self, arrays) -> np.ndarray:
        """Every rank's scores of ``arrays`` (rank 0; under the service's
        device lock)."""
        with self._lock:
            return self._run(OP_PREDICT, arrays)

    def _beat(self) -> None:
        while not self._done.wait(self.heartbeat_s / 4):
            with self._lock:
                if (self.failed is None and not self._stopped and
                        time.monotonic() - self._last >= self.heartbeat_s):
                    try:
                        self._run(OP_NOOP)
                    except BaseException:
                        return

    def stop(self) -> None:
        """End the other ranks' ``follow`` (rank 0, once); after a failure,
        send nothing."""
        with self._lock:
            try:
                if not self._stopped and self.failed is None:
                    self._run(OP_STOP)
            finally:
                self._stopped = True
                self._done.set()

    def follow(self) -> int:
        """Run each of rank 0's dispatches until its stop (every rank but
        0); returns the number of dispatches run."""
        runs = 0
        while True:
            op, arrays = self._receive()
            if op == OP_STOP:
                return runs
            if arrays is not None:
                self.trainer.predict(arrays)
                runs += 1


class ScoringService:
    """Request-level serving logic, transport-agnostic (the HTTP layer
    below and the tests call these methods directly)."""

    def __init__(
        self,
        adapter,
        packed_schema,
        predictor,
        model_name: str,
        max_rows: int = DEFAULT_MAX_ROWS,
        batch_window_ms: float = 0.0,
    ):
        self.adapter = adapter
        self.packed = packed_schema
        self.predictor = predictor
        self.model_name = model_name
        self.max_rows = max_rows
        self._requests = 0
        # device work is the shared resource — one dispatch at a time
        self._device_lock = threading.Lock()
        self._batcher = (
            MicroBatcher(self._score_arrays, batch_window_ms / 1000.0)
            if batch_window_ms > 0
            else None
        )

    def warmup(self) -> None:
        """Score one known pair before the first request, so one-time
        costs (the CUDA kernel's build and load, the first launches) are
        not paid on live traffic."""
        uid, mid = self.adapter.known_pair()
        ds, _ = self.adapter.score_id_pairs(
            np.asarray([uid]), np.asarray([mid])
        )
        with self._device_lock:
            self.predictor.predict(ds.pack(self.packed))

    def close(self) -> None:
        """Stop the other ranks of a sharded predictor (``RankScorer.stop``),
        once the dispatch in flight, if any, is done; nothing for a
        predictor of one process."""
        stop = getattr(self.predictor, "stop", None)
        if stop is not None:
            with self._device_lock:
                stop()

    def health(self) -> dict:
        return {
            "status": "ok",
            "model": self.model_name,
            "n_params": self.predictor.n_params,
            "requests": self._requests,
        }

    def _parse_rows(self, body: dict):
        rows = body.get("rows")
        if not isinstance(rows, list) or not rows:
            raise ServingError('expected {"rows": [[user, item, ts?], ...]}')
        if len(rows) > self.max_rows:
            raise ServingError(
                f"too many rows: {len(rows)} > max {self.max_rows} "
                f"(split the request)"
            )
        try:
            arr = [[int(v) for v in r] for r in rows]
        except (TypeError, ValueError):
            raise ServingError("rows must be arrays of integers") from None
        if any(len(r) not in (2, 3) for r in arr):
            raise ServingError("each row is [user, item] or [user, item, ts]")
        # per-row PRESENCE (len == 3) decides timestamp handling — a
        # sentinel value would swallow legitimate client data; negative
        # timestamps are rejected rather than silently replaced (the
        # fitted time features assume the epoch-seconds domain)
        if any(len(r) == 3 and r[2] < 0 for r in arr):
            raise ServingError("timestamps must be >= 0")
        now = int(self.adapter.now_timestamp())
        users = np.asarray([r[0] for r in arr], np.int64)
        items = np.asarray([r[1] for r in arr], np.int64)
        ts = np.asarray(
            [r[2] if len(r) == 3 else now for r in arr], np.int64
        )
        return users, items, ts

    def _score_arrays(self, users, items, ts) -> list[float | None]:
        """One adapter transform + one device dispatch; the unit the
        micro-batcher coalesces. Unknown pairs score None."""
        ds, kept = self.adapter.score_id_pairs(users, items, None, ts)
        scores: list[float | None] = [None] * len(users)
        if len(kept):
            with self._device_lock:
                vals = self.predictor.predict(ds.pack(self.packed))
            for i, v in zip(kept, vals):
                scores[int(i)] = float(v)
        return scores

    def score(self, body: dict) -> dict:
        """Score [user, item] or [user, item, timestamp] rows. Unknown
        user/item pairs score null (dropped by the pipeline's metadata
        contract) rather than failing the batch."""
        users, items, ts = self._parse_rows(body)
        if self._batcher is not None:
            scores = self._batcher.submit(users, items, ts)
        else:
            scores = self._score_arrays(users, items, ts)
        self._requests += 1
        return {
            "scores": list(scores),
            "n_scored": sum(1 for s in scores if s is not None),
        }

    def recommend(
        self, user: int, k: int, include_seen: bool = False
    ) -> dict:
        if k < 1:
            raise ServingError(f"k must be >= 1, got {k}")
        try:
            ds, item_ids = self.adapter.recommend_candidates(
                user, exclude_seen=not include_seen
            )
        except ValueError as e:
            raise ServingError(str(e), status=404) from None
        if len(item_ids) == 0:
            raise ServingError(f"user {user} has no unseen items", 404)
        with self._device_lock:
            scores = self.predictor.predict(ds.pack(self.packed))
        top = np.argsort(-scores)[:k]
        self._requests += 1
        return {
            "user": int(user),
            "items": [
                {"item": int(item_ids[i]), "score": float(scores[i])}
                for i in top
            ],
        }


def make_http_server(
    service: ScoringService,
    host: str = "127.0.0.1",
    port: int = 8080,
    max_body_bytes: int = DEFAULT_MAX_BODY_BYTES,
) -> ThreadingHTTPServer:
    """Bind a ThreadingHTTPServer routing to ``service`` (``port=0``
    picks an ephemeral port — the tests use that). Caller runs
    serve_forever(). Requests handle concurrently; device dispatches
    serialize inside the service (or coalesce via its micro-batcher)."""

    class Handler(BaseHTTPRequestHandler):
        # quiet the default per-request stderr lines
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _reply(self, status: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _dispatch(self, fn) -> None:
            try:
                self._reply(200, fn())
            except ServingError as e:
                self._reply(e.status, {"error": str(e)})
            except Exception as e:  # serving must not kill the process
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def do_GET(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path == "/health":
                self._dispatch(service.health)
            elif url.path == "/recommend":
                q = parse_qs(url.query)

                def run():
                    if "user" not in q:
                        raise ServingError("missing ?user=")
                    try:
                        user = int(q["user"][0])
                        k = int(q.get("k", ["10"])[0])
                    except ValueError:
                        raise ServingError(
                            "user/k must be integers"
                        ) from None
                    include = q.get("include_seen", ["0"])[0] not in (
                        "0",
                        "false",
                        "",
                    )
                    return service.recommend(user, k, include)

                self._dispatch(run)
            else:
                self._reply(404, {"error": f"no route {url.path}"})

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path != "/score":
                self._reply(404, {"error": f"no route {url.path}"})
                return

            def run():
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    raise ServingError("empty body")
                if length > max_body_bytes:
                    raise ServingError(
                        f"body too large: {length} > {max_body_bytes} bytes",
                        413,
                    )
                try:
                    body = json.loads(self.rfile.read(length))
                except json.JSONDecodeError:
                    raise ServingError("body is not valid JSON") from None
                return service.score(body)

            self._dispatch(run)

    class Server(ThreadingHTTPServer):
        # socketserver's default listen backlog is 5: a burst of more
        # simultaneous connects overflows the accept queue and the OS
        # resets the excess; a scorer must absorb connection bursts and
        # let latency, not resets, signal load.
        request_queue_size = 128

    return Server((host, port), Handler)
