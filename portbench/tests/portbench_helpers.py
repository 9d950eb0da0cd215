"""Shared set-up of the benchmark's CPU tests: a registry that finds the
CPU-size cells of ``tests/data`` before the benchmark's own, with each
tiny cell listed beside the full cell it stands for."""

from __future__ import annotations

import copy
import time
from pathlib import Path

from portbench import run
from portbench.registry import HERE, Registry

DATA = Path(__file__).resolve().parent / "data"
SEED = 123456789012
TINY = {"tiny-xdeepfm.train": "xdeepfm-paper.train",
        "tiny-deepfm.train": "xdeepfm-paper.train",
        "tiny-xdeepfm.score": "xdeepfm-paper.score-b16k"}


def tiny_benchmark(extra_roots=()) -> Registry:
    reg = Registry(roots=[*extra_roots, DATA, HERE])
    bench = copy.deepcopy(reg.benchmark)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [t for t, c in TINY.items()
                               if c in m["workloads"]]
    reg._benchmark = bench
    return reg


def run_tiny(reg: Registry, cell: str, trace: bool = False,
             seconds: float = 2.0, seed: int = SEED) -> dict:
    return run.run_cell(reg, cell, seed, seconds, trace, "cpu", time.time())
