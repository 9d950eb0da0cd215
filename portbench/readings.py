"""What the per-layer metric readers (``metrics/<metric>.py``) share.

A reader takes the run's readings: the host ``spans`` (seconds and
``span_counts`` by name) over the window but for its traced part, and
``span_window_s``, the window's time but for that part; ``trace``, the
summary of a device trace of ``traced_steps`` steps (``trace.py``; None
where no card was traced); ``ops``, the step's operations counted from shapes
(``counts``); ``config``, ``mix`` and ``opmaps``. It returns a number, or
None where it finds nothing to read, and never 0 for a share of a
roofline or a peak.
"""

from __future__ import annotations

import re

from portbench import counts


def share(part: float, whole: float):
    return 100.0 * part / whole if whole > 0 else None


def least_step_seconds(r: dict, names=None) -> float:
    return counts.least_seconds(r["ops"], r["config"]["compute_dtype"],
                                names)


def kernel_seconds(r: dict, opmap: str) -> float:
    """Device seconds of the traced kernels that ``opmap/<opmap>.json``
    assigns to its operations: those launched by the forward and the
    backward of the module it names (``"module"``), or else those whose
    names match its patterns (``"kernels"``)."""
    if "module" in r["opmaps"][opmap]:
        return r["trace"]["by_op"].get(opmap, 0.0)
    pats = [re.compile(p) for p in r["opmaps"][opmap]["kernels"]]
    return sum(s for name, s in r["trace"]["by_name"].items()
               if any(p.search(name) for p in pats))


def roofline(r: dict, opmap: str):
    """The least time of the map's operations over the device time of its
    kernels, in the traced steps."""
    t = r["trace"]
    if t is None:
        return None
    ops = [n for n in r["opmaps"][opmap]["operations"] if n in r["ops"]]
    least = least_step_seconds(r, ops) * r["traced_steps"]
    spent = kernel_seconds(r, opmap)
    if not ops or least <= 0 or spent <= 0:
        return None
    return share(least, spent)


def mfu(r: dict):
    """The whole step's least time over the traced time a step took."""
    t = r["trace"]
    if t is None:
        return None
    return share(least_step_seconds(r) * r["traced_steps"], t["window_s"])


def device_idle(r: dict):
    t = r["trace"]
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 - share(t["busy_s"], t["window_s"])


def kernels_per_step(r: dict):
    t = r["trace"]
    if t is None or t["kernels"] == 0:
        return None
    return t["kernels"] / r["traced_steps"]


def host_enqueue_ms(r: dict):
    """The mean host time of a ``_train_step`` call over the window."""
    n = r["span_counts"].get("step", 0)
    return 1e3 * r["spans"]["step"] / n if n else None


def stage_share(r: dict, spans=("plan", "stage")):
    """The window's share of host time in the named spans."""
    if not all(s in r["spans"] for s in spans):
        return None
    return share(sum(r["spans"][s] for s in spans), r["span_window_s"])
