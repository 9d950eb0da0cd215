"""The score window: batch scoring through the port's ``Predictor``.

The ``predict`` command's path on one device (``cli.py``'s
``_restore_predictor`` builds a ``Predictor``): set-up builds the model on
the benchmark's weights and scores the whole pool ``warmup_passes`` times;
the window then calls ``Predictor.predict`` on the pool again and again
until ``--seconds`` have passed. Each call stages the rows in chunks of
``stage_budget_mb``, scores them in batches of ``batch`` rows and returns
every score to the host. The rate is the rows scored and returned over
all the window's time.

After the window the program is freed and the reference scores the
checked rows: ``checked_rows_per_batch`` rows of every batch, drawn from
the seed, and each call's scores there are compared.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import check, counts, port, seeds, weights
from portbench.reference import ctr
from portbench.spans import Spans
from portbench.trace import DeviceTrace, mark_operations


def checked_rows(seed: int, n: int, batch: int, per_batch: int) -> np.ndarray:
    """Sorted row indices: ``per_batch`` distinct rows of every batch."""
    rng = np.random.default_rng(seeds.derive(seed, "checked rows"))
    out = []
    for lo in range(0, n, batch):
        size = min(batch, n - lo)
        out.append(lo + np.sort(rng.choice(size, min(per_batch, size),
                                           replace=False)))
    return np.concatenate(out)


def run(ctx) -> dict:
    kind, config, mix, dev = ctx.kind, ctx.config, ctx.mix, ctx.device
    pool = ctx.registry.generator(mix["generator"]).make_pool(
        config, mix, ctx.seed, dev)
    n, batch = len(pool["labels"]), mix["batch"]
    ctx.mark("pool")
    w = weights.make_weights(kind, config, ctx.seed, dev)
    cfg, packed, model = port.build_model(kind, config, mix, w, dev,
                                          seeds.derive(ctx.seed, "port"))
    del w
    ctx.mark("model")
    predictor = port.predictor(cfg, packed, model, dev)
    data = port.packed_arrays(pool)
    rows = checked_rows(ctx.seed, n, batch, mix["checked_rows_per_batch"])
    for _ in range(mix["warmup_passes"]):
        predictor.predict(data)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    ctx.mark("warmup")

    spans = Spans()
    if ctx.trace:
        spans.wrap(predictor, "_stage", "stage")
        mark_operations(spans, model, ctx.registry.opmaps())
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    window_start = time.time()
    t0 = time.perf_counter()
    calls, failed, kept, traced, ends = 0, 0, [], None, []
    traced_wall = 0.0
    while True:
        if ctx.trace and calls == 1 and torch.device(dev).type == "cuda":
            spans.paused, t_in = True, time.perf_counter()
            with DeviceTrace() as traced:
                scores = predictor.predict(data)
            spans.paused, traced_wall = False, time.perf_counter() - t_in
        else:
            scores = predictor.predict(data)
        ends.append(time.perf_counter() - t0)
        calls += 1
        if scores.shape[0] == n:
            failed += int((~np.isfinite(scores)).sum())
            kept.append(scores[rows])
        else:
            failed += n
            kept.append(scores[:0])
        if time.perf_counter() - t0 >= ctx.seconds and (
                not ctx.trace or calls >= 2):
            break
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(dev).type == "cuda" else None)
    spans.restore()
    summary = traced.summary() if traced is not None else None

    del predictor, model
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    w0 = weights.make_weights(kind, config, ctx.seed, dev)
    ref = ctr.probabilities(
        kind, config, w0, torch.from_numpy(pool["ids"][rows]).to(dev).long(),
        torch.from_numpy(pool["dense"][rows]).to(dev)).cpu().numpy()
    numbers = check.score_numbers(kept, ref)

    return {
        "end_to_end": {"score_rows_per_s": calls * n / window_s},
        "window_start": window_start,
        "attempted": calls * n,
        "failed": failed,
        "memory_peak_bytes": peak,
        "numbers": numbers,
        "where": {"checked_rows": int(rows.size), "call_ends_s": ends},
        "readings": {
            "window_s": window_s,
            "span_window_s": window_s - traced_wall,
            "batches": calls * -(-n // batch),
            "spans": dict(spans.seconds),
            "span_counts": dict(spans.count),
            "trace": summary,
            "traced_steps": -(-n // batch),
            "ops": counts.step_ops(kind, config, batch, train=False),
        },
    }
