"""The comparison that decides ``correct``.

Training (the first three steps of the object the window then drives):

* ``grad_diff``: the first step's gradient as the optimizer takes it
  (decayed and clipped; the program's read from its Adam first moment
  after one step, mu / (1 - b1)): the largest ||g - g_ref|| / ||g_ref||
  over the leaves of at least ``WIDE_LEAF`` elements;
* ``change_gap``: the largest gap of a leaf's change ||p3 - p0|| after
  three steps, |program's norm - reference's| over the larger of the
  reference's norm of that leaf and of the median leaf, over the leaves
  whose reference gradient is at least ``MOVED_SHARE`` of the median
  leaf's (a leaf whose gradient is nought but for rounding, as a bias
  under BatchNorm, moves under Adam by round-off alone).

Reported beside them and not compared, because neither the control nor
a fault separates them from sound bf16 runs on every seed: the first
step's loss gap and the three steps' largest, and the largest gap of a
leaf's gradient norm, over the wide leaves and over every leaf. A loss
or a norm averages fp8's per-element rounding away; rounding the weights
to bf16 offsets every logit by a few 1e-3, which moves the gradients of
the narrow leaves (biases and heads carry the batch's mean residual, a
sum that can cancel) and, through Adam's first sign-like step, the later
losses. The port in f32 meets the reference to 1e-5 on the same seeds.

Scoring: ``score_gap``, the largest |score - reference score| over the
checked rows of every call, and ``score_missing``, the checked rows that
came back missing or not finite (limit 0).

A cell compares the numbers its file gives limits for
(``workloads/<cell>.json``); a number that is not finite fails. The
others are reported in the result's ``where`` and not compared.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

MOVED_SHARE = 1e-3
WIDE_LEAF = 10_000


def _gaps(prog: dict, ref: dict, names) -> dict[str, float]:
    names = list(names)
    median = statistics.median(ref[n] for n in names)
    return {n: (abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
                if math.isfinite(prog[n]) else math.inf) for n in names}


def _rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p) else math.inf


def train_numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """(numbers, where): ``prog`` and ``ref`` hold ``losses`` (3 floats),
    ``grad_norms`` and ``change_norms`` (leaf -> float) and
    ``first_grads`` (wide leaf -> tensor, on one device); ``ref`` also
    ``sizes`` (leaf -> elements)."""
    g = ref["grad_norms"]
    wide = [n for n in g if ref["sizes"][n] >= WIDE_LEAF]
    diff = {}
    for n in wide:
        d = float(torch.linalg.vector_norm(
            prog["first_grads"][n] - ref["first_grads"][n])
            / torch.linalg.vector_norm(ref["first_grads"][n]))
        diff[n] = d if math.isfinite(d) else math.inf
    median = statistics.median(g.values())
    moved = [n for n in g if g[n] >= MOVED_SHARE * median]
    change = _gaps(prog["change_norms"], ref["change_norms"], moved)
    norms_wide = _gaps(prog["grad_norms"], g, wide)
    norms = _gaps(prog["grad_norms"], g, g)
    diff_at = max(diff, key=diff.get)
    change_at = max(change, key=change.get)
    numbers = {"grad_diff": diff[diff_at], "change_gap": change[change_at],
               "loss1_gap": _rel(prog["losses"][0], ref["losses"][0]),
               "loss_gap": max(_rel(p, r) for p, r in zip(prog["losses"],
                                                          ref["losses"])),
               "grad_gap_wide": max(norms_wide.values()),
               "grad_gap": max(norms.values())}
    where = {"grad_diff_leaf": diff_at, "change_gap_leaf": change_at,
             "grad_gap_leaf": max(norms, key=norms.get),
             "left_out_of_change": sorted(set(g) - set(moved))}
    return numbers, where


def score_numbers(calls, ref) -> dict:
    """``calls``: each call's scores at the checked rows (numpy arrays);
    ``ref``: the reference's scores there."""
    gap, missing = 0.0, 0
    for got in calls:
        if got.shape != ref.shape:
            missing += ref.size
            continue
        finite = np.isfinite(got)
        missing += int((~finite).sum())
        if finite.any():
            gap = max(gap, float(np.abs(got[finite] - ref[finite]).max()))
    return {"score_gap": gap, "score_missing": float(missing)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell
    limits: each at or under its limit and finite. A limit on a number the
    run did not produce fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        if not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks
