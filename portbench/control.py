"""Readings of the control and of the planted faults, which set the upper
ends of a cell's limits. The benchmark's own runs never run this.

    python3 -m portbench.control --workload <cell> --mode <mode> --seeds <n> ...

Each mode puts the reference, changed, in the program's place and compares
it with the reference itself exactly as a run compares the program
(``check.py``), on the cell's own inputs and weights for each seed:

* ``control`` (both entries): the reference computed in float8 e4m3 with
  one scale a tensor, the precision below the configuration's bf16;
* ``half_batch`` (train): each step on the first half of its rows, the
  mean taken over them;
* ``altered`` (score): one row of every batch answered with the next
  row's score.

A step that returns its state unchanged reads a change gap of 1 and
needs no run. Prints one JSON line a seed, then the smallest and the
largest of each number.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench import check, seeds, weights
from portbench.entries.score import checked_rows
from portbench.entries.train import epoch_order
from portbench.reference import ctr
from portbench.registry import Registry

MODES = {"train": ("control", "half_batch"), "score": ("control", "altered")}


def inputs(registry, cell: dict, seed: int, device):
    config = registry.config(cell["config"])
    kind = registry.model(config["model"])
    mix = registry.traffic(cell["traffic"])
    gen = registry.generator(mix["generator"])
    pool = gen.make_pool(config, mix, seed, device)
    return (kind, config, mix, pool,
            weights.make_weights(kind, config, seed, device))


def train_numbers(registry, cell, seed, mode, device) -> dict:
    kind, config, mix, pool, w0 = inputs(registry, cell, seed, device)
    order = epoch_order(seed, len(pool["labels"]))
    b = mix["batch"]
    batches = []
    for k in range(3):
        rows = order[k * b:(k + 1) * b]
        batches.append((torch.from_numpy(pool["ids"][rows]).to(device).long(),
                        torch.from_numpy(pool["dense"][rows]).to(device),
                        torch.from_numpy(pool["labels"][rows]).to(device)))
    wide = [k for k, v in w0.items() if v.numel() >= check.WIDE_LEAF]
    ref = ctr.train_steps(kind, config, w0, batches, keep=wide)
    if mode == "control":
        got = ctr.train_steps(kind, config, w0, batches, q=ctr.fp8,
                              keep=wide)
    else:
        halves = [tuple(t[:b // 2] for t in bt) for bt in batches]
        got = ctr.train_steps(kind, config, w0, halves, keep=wide)
    numbers, where = check.train_numbers(got, ref)
    return {**numbers, "where": where}


def score_numbers(registry, cell, seed, mode, device) -> dict:
    kind, config, mix, pool, w0 = inputs(registry, cell, seed, device)
    n, b = len(pool["labels"]), mix["batch"]
    rows = checked_rows(seed, n, b, mix["checked_rows_per_batch"])

    def scores(idx, q=ctr.identity):
        return ctr.probabilities(
            kind, config, w0,
            torch.from_numpy(pool["ids"][idx]).to(device).long(),
            torch.from_numpy(pool["dense"][idx]).to(device), q).cpu().numpy()

    ref = scores(rows)
    if mode == "control":
        got = scores(rows, ctr.fp8)
    else:
        # the altered row of each batch, drawn from the seed
        rng = np.random.default_rng(seeds.derive(seed, "altered row"))
        altered = np.array([lo + rng.integers(0, min(b, n - lo) - 1)
                            for lo in range(0, n, b)])
        got = ref.copy()
        hit = np.isin(rows, altered)
        got[hit] = scores(rows[hit] + 1)
    return check.score_numbers([got], ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    registry = Registry()
    cell = registry.cell(args.workload)
    if args.mode not in MODES[cell["entry"]]:
        p.error(f"modes of a {cell['entry']} cell: {MODES[cell['entry']]}")
    fn = train_numbers if cell["entry"] == "train" else score_numbers
    least: dict[str, float] = {}
    most: dict[str, float] = {}
    for seed in args.seeds:
        got = fn(registry, cell, seed, args.mode, args.device)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, **got}), flush=True)
        for k, v in got.items():
            if isinstance(v, float):
                least[k] = min(least.get(k, v), v)
                most[k] = max(most.get(k, v), v)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "mode": args.mode,
                      "smallest": least, "largest": most,
                      "limits": cell["limits"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
