"""Times phases of ``chip_smoke.py`` in two checkouts on one card.

Usage (from the root of a checkout; needs CUDA):

    git archive <parent commit> | tar -x -C build/parent
    python3 scripts/chip_smoke_ab.py build/parent --out logs \
        --phases table_kernels train dp_steps --extra model_sharded

Runs the phases in the order parent, change, change, parent, each run in a
process of its own from its checkout's root (each builds its kernels
there first), so that a difference between the trees is read against the
spread of one tree on the same card. ``dp_steps`` is the data_parallel
phase's full-width part (``spawn_ranks(DP_WORLD, "steps")``); ``--extra``
phases run only in the first run of the change. Prints the card's name and
power limit, then one line a run: its index, tree, exit code, wall
seconds and a JSON object of seconds by phase; each run's output goes to
``<out>/ab_<index>_<tree>.log``. Exits non-zero if a run failed.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUN = r'''
import json, sys, tempfile, time
from pathlib import Path
sys.path.insert(0, ".")
import chip_smoke as cs
t0 = time.perf_counter()
gpu = cs.phase_build()
out = {"build": time.perf_counter() - t0}
for name in sys.argv[1:]:
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if name == "dp_steps":
            cs.spawn_ranks(cs.DP_WORLD, "steps", Path(tmp))
        elif name in ("model_sharded", "data_parallel"):
            getattr(cs, "phase_" + name)(Path(tmp), gpu)
        else:
            getattr(cs, "phase_" + name)()
    out[name] = time.perf_counter() - t0
print("AB_SECONDS " + json.dumps(out), flush=True)
'''


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="the parent's checkout")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ab")
    ap.add_argument("--phases", nargs="+",
                    default=["table_kernels", "train", "dp_steps"])
    ap.add_argument("--extra", nargs="*", default=[])
    ap.add_argument("--timeout", type=int, default=1200,
                    help="seconds a run may take")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    rc = 0
    order = (("parent", []), ("change", args.extra), ("change", []),
             ("parent", []))
    for i, (tree, extra) in enumerate(order):
        cwd = args.parent.resolve() if tree == "parent" else ROOT
        log_path = args.out / f"ab_{i}_{tree}.log"
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            proc = subprocess.run(
                [sys.executable, "-c", RUN, *args.phases, *extra], cwd=cwd,
                stdout=log, stderr=subprocess.STDOUT, timeout=args.timeout)
        lines = log_path.read_text().splitlines()
        seconds = [ln for ln in lines if ln.startswith("AB_SECONDS ")]
        print(i, tree, proc.returncode, time.perf_counter() - t0,
              seconds[-1][len("AB_SECONDS "):] if seconds else lines[-5:],
              flush=True)
        rc |= proc.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
