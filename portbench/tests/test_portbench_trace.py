"""A kernel map that names a module is given every launch of that
module's forward and of the backward of the autograd nodes its forward
recorded, and no other."""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile

from portbench.spans import Spans
from portbench.trace import BACKWARD, OP_RANGE, _op_of_launches, \
    mark_operations


def test_launches_in_the_forward_range_and_its_nodes_backward():
    # (start, end, name) of the forward range; forward ops (start, thread,
    # sequence number); backward nodes (start, end, forward thread,
    # sequence number); runtime calls (start, correlation id)
    ranges = [(100, 200, "cin")]
    forward = [(110, 1, 7), (150, 1, 8), (250, 1, 9)]
    backward = [(400, 450, 1, 9), (500, 560, 1, 8), (600, 650, 1, 7),
                (700, 720, 2, 7)]
    runtime = [(120, 1), (210, 2), (420, 3), (510, 4), (610, 5), (705, 6)]
    got = _op_of_launches(ranges, forward, backward, runtime)
    assert got == {1: "cin", 4: "cin", 5: "cin"}


def test_no_named_module_attributes_nothing():
    assert _op_of_launches([], [(1, 1, 1)], [(2, 3, 1, 1)], [(2, 9)]) == {}


class _Twice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return 2 * x

    @staticmethod
    def backward(ctx, g):
        return 2 * g


class _Inner(torch.nn.Module):
    def forward(self, x):
        return _Twice.apply(x * x)


class _Model(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.inner = _Inner()

    def forward(self, x):
        return self.inner(x).sum() + torch.sin(x).sum()


def test_the_profilers_sequence_numbers_tie_the_backward_to_the_range():
    model, spans = _Model(), Spans()
    mark_operations(spans, model, {"inner": {"module": "inner"},
                                   "other": {"kernels": ["x"]},
                                   "absent": {"module": "no_such"}})
    x = torch.randn(64, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x).backward()
    spans.restore()
    ranges, forward, nodes = [], [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns(), e.start_ns() + e.duration_ns())
        if e.name().startswith(OP_RANGE):
            ranges.append((*span, e.name()[len(OP_RANGE):]))
        elif e.name().startswith(BACKWARD):
            nodes.append((e.name()[len(BACKWARD):], (
                *span, e.fwd_thread_id(), e.sequence_nr())))
        elif e.sequence_nr() >= 0:
            forward.append((span[0], e.start_thread_id(), e.sequence_nr()))
    assert [r[2] for r in ranges] == ["inner"]
    # a runtime call placed inside each backward node
    runtime = [((s + t) // 2, i) for i, (_, (s, t, *_)) in enumerate(nodes)]
    got = _op_of_launches(ranges, forward, [n for _, n in nodes], runtime)
    hit = sorted(name for i, (name, _) in enumerate(nodes) if i in got)
    assert hit == ["MulBackward0", "_TwiceBackward"], nodes
    assert "SinBackward0" in [name for name, _ in nodes]
    assert "forward" not in vars(model.inner)
