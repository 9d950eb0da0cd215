"""The port's spans and counters: where the host's time goes inside the
train step, the epoch loop and the ``Predictor``.

Process-global, like the kernel wrappers' ``launches`` counters, and off
by default. Off, ``span(name)`` returns one shared no-op object: it reads
no clock, opens no profiler range and allocates nothing; ``count`` does
nothing. ``enable()`` turns both on: each span then opens the profiler
range ``deepfm.<name>`` (seen by any running ``torch.profiler`` on the
clock of its device records, and written to ``profile.trace_dir``'s chrome
trace, where the ranges' nesting shows each span's parent), and adds its
``time.perf_counter`` duration and one to the name's totals; ``count``
adds to a counter. ``snapshot()`` returns the totals, ``{"spans": {name:
{"seconds", "count"}}, "counters": {name: n}}``, and ``since(before)``
what was recorded after an earlier snapshot. Nothing is written to disk.

``Trainer.train`` turns tracing on for as long as ``profile.trace_dir``
runs its profiler; while tracing is on it puts each epoch's ``since`` (the
epoch and its val evaluation) under ``Trainer.timings["spans"]`` and logs
it as one line (``describe``): each span's seconds, count and mean, and
the GB/s of each ``<span>_bytes`` counter over its span's seconds.

Spans (each ``deepfm.<name>`` in a trace):

* ``train.plan``: each ``next()`` of ``Trainer._chunk_plan`` in
  ``_train_epoch``, the epoch's shuffle and the gather of a chunk's rows;
* ``train.stage``: ``Trainer._stage``, a chunk's host arrays copied to
  the device;
* ``train.wait``: the epoch loop's blocking reads of the losses (the last
  chunk's before the next is staged, and the epoch's sum at its end);
* ``step.forward``: a train step's lookup, model and loss
  (``training/steps.py``: the sparse-fused path's row gather, the loss,
  the lazy path's L2 term);
* ``step.backward``: the step's ``torch.autograd.grad`` call;
* ``step.update``: the rest of the step: the gradients' all-reduce under a
  mesh, the global norm, clip, the dense update, the pairs' sort and the
  table update;
* ``score.stage``: ``Predictor._stage``, twice a chunk (ids, dense);
* ``score.forward``: each batch's ``model.predict`` in
  ``Predictor.predict``;
* ``score.fetch``: each chunk's scores copied back to the host, which
  waits for the chunk's forwards;
* ``model.attention``: each forward of an attention stack
  (``ops/attention.py``: AttentionDeepFM's blocks, AutoInt's interacting
  layers), in training (inside ``step.forward``) and in scoring (inside
  ``score.forward``);
* ``model.attention_backward``: each attention layer's autograd backward
  (``AttentionBlockFn``, ``InteractingLayerFn``), once a layer a step,
  inside ``step.backward``.

Counters: ``train.stage_bytes`` and ``score.stage_bytes``, the host bytes
each staging copies; ``attention.rows``, the B·F rows each attention layer
takes in its forward; ``attention.tiled_core_rows``, the B·F rows of each
interacting layer's backward launch that took the tiled core
(``ops/kernels/attention.py``; in a training epoch with no evaluation it
equals ``attention.rows`` where every backward took it).
"""

from __future__ import annotations

import threading
import time

# ``record_function`` without its Python wrapper (0.4 us a range against 18
# on an H100's host, no profiler running), and without a mirror on the
# device's track of a trace
from torch._C._profiler import _RecordFunctionFast as _Range

PREFIX = "deepfm."

_on = False
_lock = threading.Lock()
# name -> [seconds, count]
_spans: dict[str, list] = {}
_counters: dict[str, int] = {}


class _Off:
    """What ``span`` gives while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self._range = _Range(PREFIX + self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        with _lock:
            rec = _spans.setdefault(self.name, [0.0, 0])
            rec[0] += seconds
            rec[1] += 1
        return False


def span(name: str):
    """A context manager around one piece of the program's work, recorded
    as ``name`` while tracing is on."""
    return _Span(name) if _on else _OFF


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def enabled() -> bool:
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def snapshot() -> dict:
    """A copy of the totals: ``{"spans": {name: {"seconds", "count"}},
    "counters": {name: n}}``."""
    with _lock:
        return {"spans": {k: {"seconds": s, "count": c}
                          for k, (s, c) in _spans.items()},
                "counters": dict(_counters)}


def since(before: dict) -> dict:
    """What was recorded after ``before`` (a ``snapshot()``), in its shape;
    names with nothing new are left out."""
    now = snapshot()
    spans = {}
    for k, v in now["spans"].items():
        old = before["spans"].get(k, {"seconds": 0.0, "count": 0})
        if v["count"] > old["count"]:
            spans[k] = {"seconds": v["seconds"] - old["seconds"],
                        "count": v["count"] - old["count"]}
    counters = {k: n - before["counters"].get(k, 0)
                for k, n in now["counters"].items()
                if n != before["counters"].get(k, 0)}
    return {"spans": spans, "counters": counters}


def describe(recorded: dict) -> str:
    """``since``'s result as one line: each span's seconds, count and mean
    ms, and the GB/s of its ``<span>_bytes`` counter where it has one."""
    parts = []
    for name, s in sorted(recorded["spans"].items()):
        part = (f"{name} {s['seconds']:.3f}s/{s['count']} "
                f"({1e3 * s['seconds'] / s['count']:.2f} ms)")
        nbytes = recorded["counters"].get(name + "_bytes")
        if nbytes is not None and s["seconds"] > 0:
            part += f" {nbytes / s['seconds'] / 1e9:.2f} GB/s"
        parts.append(part)
    return ", ".join(parts)
