"""Host spans the benchmark records around its calls into the program.

``Spans.wrap`` replaces a bound method on one object by a timed copy (an
instance attribute that shadows the method) and ``Spans.restore`` takes
it off again; nothing of the program is edited. Each span also opens a
``torch.profiler.record_function`` range, so a traced run can say what the
host was doing while the device idled. Spans are kept in memory: a total
and a count by name.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self) -> None:
        self.seconds: dict[str, float] = defaultdict(float)
        self.count: dict[str, int] = defaultdict(int)
        self.paused = False  # while a device trace slows the host
        self._wrapped: list[tuple[object, str]] = []

    def add(self, name: str, seconds: float) -> None:
        if not self.paused:
            self.seconds[name] += seconds
            self.count[name] += 1

    def wrap(self, obj, attr: str, name: str) -> None:
        """Time every call of ``obj.attr`` as span ``name``."""
        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            with torch.profiler.record_function(f"bench.{name}"):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.add(name, time.perf_counter() - t0)

        setattr(obj, attr, timed)
        self._wrapped.append((obj, attr))

    def wrap_iter(self, obj, attr: str, name: str) -> None:
        """Time every ``next()`` of the iterators ``obj.attr`` returns as
        span ``name``."""
        fn = getattr(obj, attr)
        spans = self

        def timed(*args, **kwargs):
            it = fn(*args, **kwargs)
            while True:
                with torch.profiler.record_function(f"bench.{name}"):
                    t0 = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    finally:
                        spans.add(name, time.perf_counter() - t0)
                yield item

        setattr(obj, attr, timed)
        self._wrapped.append((obj, attr))

    def restore(self) -> None:
        for obj, attr in reversed(self._wrapped):
            delattr(obj, attr)
        self._wrapped.clear()
