"""A device trace of a bounded steady part of a window, reduced in memory.

``DeviceTrace`` runs ``torch.profiler`` over the CPU and the card around
the traced part, padded on either side by ``PAD`` kernels of
``torch.cuda._sleep`` (copied from ``chip_smoke.py``'s ``profile_pad``:
the profiler loses the device records of a session's first, and now and
then its last, kernels; the pads take the loss and are left out). It
writes nothing to disk. ``summary`` reads the raw Kineto events (no
per-event Python objects of the profiler's own) into:

* ``busy_s``: the union of the device's kernel, copy and fill intervals;
* ``window_s``: the host clock over the traced part (it ends in a
  ``torch.cuda.synchronize()``);
* ``kernels``: device kernels launched (copies and fills not counted);
* ``by_name``: device seconds by kernel or copy name;
* ``idle_by_host``: the device's idle gaps, each named by the benchmark
  span and the host operation that overlap it most, seconds by name;
* ``by_op``: device seconds by operation of ``opmap/*.json`` that names
  a ``module``: the kernels, copies and fills launched inside the
  benchmark's range ``bench.op.<map>`` around that module's forward, and
  inside the backward of every autograd node that forward recorded
  (matched by the profiler's forward thread and sequence number);
* ``whole``: whether every kernel launched kept its device record.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

PAD = 256
PAD_NAME = "spin_kernel"
TOP = 10
OP_RANGE = "bench.op."
BACKWARD = "autograd::engine::evaluate_function: "


def _pad() -> None:
    torch.cuda.synchronize()
    for _ in range(PAD):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


class DeviceTrace:
    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        _pad()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        _pad()
        self._prof.__exit__(*exc)
        return False

    def summary(self) -> dict:
        from torch.autograd import DeviceType

        events = self._prof.profiler.kineto_results.events()
        device, host, launches, runtime = [], [], [], []
        op_ranges, forward_ops, backward_ops = [], [], []
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                # the benchmark's record_function ranges are mirrored on
                # the device's track: not device work
                if PAD_NAME not in name and not name.startswith("bench."):
                    device.append((e.start_ns(), e.start_ns()
                                   + e.duration_ns(), name,
                                   e.correlation_id()))
                continue
            span = (e.start_ns(), e.start_ns() + e.duration_ns())
            if name.startswith(OP_RANGE):
                op_ranges.append((*span, name[len(OP_RANGE):]))
            elif name.startswith(BACKWARD):
                backward_ops.append((*span, e.fwd_thread_id(),
                                     e.sequence_nr()))
            elif e.sequence_nr() >= 0:
                forward_ops.append((span[0], e.start_thread_id(),
                                    e.sequence_nr()))
            if name.startswith("bench.") or name.startswith("aten::") \
                    or name.startswith("autograd::"):
                host.append((*span, name))
            elif name.startswith("cu") and e.correlation_id():
                runtime.append((span[0], e.correlation_id()))
                if "Launch" in name and "Kernel" in name:
                    launches.append((span[0], e.correlation_id()))
        device.sort()
        by_name: dict[str, float] = defaultdict(float)
        kernels = 0
        for s, t, name, _ in device:
            by_name[name] += (t - s) / 1e9
            if not name.startswith(("Memcpy", "Memset")):
                kernels += 1
        busy, gaps = 0, []
        cur_s = cur_t = None
        for s, t, _, _ in device:
            if cur_t is None or s > cur_t:
                if cur_t is not None:
                    busy += cur_t - cur_s
                    gaps.append((cur_t, s))
                cur_s, cur_t = s, t
            else:
                cur_t = max(cur_t, t)
        if cur_t is not None:
            busy += cur_t - cur_s
        launches.sort()
        recorded = {c for *_, c in device}
        whole = all(c in recorded for _, c in launches[PAD:len(launches) - PAD])
        by_corr = _op_of_launches(op_ranges, forward_ops, backward_ops,
                                  runtime)
        by_op: dict[str, float] = defaultdict(float)
        for s, t, _, c in device:
            if c in by_corr:
                by_op[by_corr[c]] += (t - s) / 1e9
        return {"busy_s": busy / 1e9, "window_s": self.window_s,
                "kernels": kernels, "by_name": dict(by_name),
                "by_op": dict(by_op),
                "idle_by_host": _idle_by_host(gaps, host),
                "whole": whole}


def _op_of_launches(op_ranges, forward_ops, backward_ops, runtime):
    """Correlation id -> operation, for every runtime call (a launch, copy
    or fill) made inside an operation's forward range or inside the
    backward of an autograd node that the forward range recorded. The
    backward runs on the engine's thread while the thread that called it
    waits, so a call is placed by its time alone."""
    if not op_ranges:
        return {}
    op_ranges.sort()
    starts = [r[0] for r in op_ranges]
    node_op = {}
    for ts, thread, seq in forward_ops:
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts < op_ranges[i][1]:
            node_op[(thread, seq)] = op_ranges[i][2]
    ranges = list(op_ranges)
    for s, t, thread, seq in backward_ops:
        op = node_op.get((thread, seq))
        if op is not None:
            ranges.append((s, t, op))
    # the forward ranges and the backward nodes' never overlap in time
    ranges.sort()
    starts = [r[0] for r in ranges]
    out = {}
    for ts, corr in runtime:
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts < ranges[i][1]:
            out[corr] = ranges[i][2]
    return out


def _idle_by_host(gaps, host) -> dict[str, float]:
    """Idle seconds by what the host was doing: the benchmark span and the
    host operation overlapping each gap the most."""
    host.sort()
    starts = [h[0] for h in host]
    out: dict[str, float] = defaultdict(float)
    for gs, gt in gaps:
        best = {"bench": ("", 0), "op": ("", 0)}
        # host events that start before the gap ends; the longest ones
        # open before it are found by scanning back a bounded distance
        hi = bisect.bisect_right(starts, gt)
        for hs, ht, name in host[max(0, hi - 400):hi]:
            ov = min(ht, gt) - max(hs, gs)
            if ov <= 0:
                continue
            kind = "bench" if name.startswith("bench.") else "op"
            if ov > best[kind][1]:
                best[kind] = (name, ov)
        label = "/".join(n for n in (best["bench"][0], best["op"][0]) if n)
        out[label or "no host span"] += (gt - gs) / 1e9
    return dict(out)


def mark_operations(spans, model, opmaps: dict) -> None:
    """Open the range ``bench.op.<map>`` around every call of the forward
    of the module that a kernel map names (``"module"``, a path under the
    model); a model without that module is left as it is."""
    for name, opmap in opmaps.items():
        path = opmap.get("module")
        if path is None:
            continue
        try:
            module = model.get_submodule(path)
        except AttributeError:
            continue
        spans.wrap(module, "forward", f"op.{name}")


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the idle seconds by host activity, at most ``TOP``
    each."""
    def top(d):
        return [[k[:120], v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(summary["by_name"]),
            "idle_gaps": top(summary["idle_by_host"])}
