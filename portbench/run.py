"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from host spans around the
calls into the program and from a device trace of a steady part of the
window. The last line of standard output is the result, a JSON object;
the numbers compared for ``correct``, each beside its limit, are the last
lines of standard error and the result's last key, ``checks``. Exits 4,
printing no result, without as many CUDA devices as the cell asks for, and
5 when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "deepfm_tpu"})


def process_start() -> float:
    """The wall-clock time this process started (its age from /proc, so
    that set-up counts the interpreter's start and every import)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def device_info(device: str, cell: dict, peak) -> dict:
    import torch

    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": cell["chips"], "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": None}


def run_cell(registry, workload: str, seed: int, seconds: float,
             trace: bool, device: str, started: float) -> dict:
    """One run of ``workload``; returns the result object (``checks``
    last)."""
    from portbench import check

    marks = [("start", started), ("imports", time.time())]
    cell = registry.cell(workload)
    config = registry.config(cell["config"])
    ctx = SimpleNamespace(registry=registry, cell=cell, config=config,
                          kind=registry.model(config["model"]),
                          mix=registry.traffic(cell["traffic"]),
                          seed=seed, seconds=seconds, trace=trace,
                          device=device,
                          mark=lambda name: marks.append((name, time.time())))
    out = registry.entry(cell["entry"]).run(ctx)
    setup_s = out["window_start"] - started
    split = {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])
             if t <= out["window_start"]}
    metrics = {}
    if not trace:
        values = dict(out["end_to_end"], setup_s=setup_s)
        for m in registry.end_to_end(workload):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        readings = dict(out["readings"], config=ctx.config, mix=ctx.mix,
                        opmaps=registry.opmaps())
        for m in registry.per_layer(workload):
            value = registry.metric(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    ok, checks = check.judge(out["numbers"], cell["limits"])
    out["where"]["not_compared"] = dict(
        out["where"].get("not_compared", {}),
        **{k: v for k, v in out["numbers"].items() if k not in checks})
    result = {"correct": ok and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": device_info(device, cell, out["memory_peak_bytes"])}
    summary = out["readings"].get("trace")
    if trace and summary is not None:
        from portbench.trace import breakdown

        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = breakdown(summary)
        out["where"]["trace_whole"] = summary["whole"]
    result["where"] = out["where"]
    result["setup_split"] = split
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.registry import Registry

    registry = Registry()
    cell = registry.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 4
    result = run_cell(registry, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", started)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}: the benchmark runs "
              f"without JAX and without the JAX package", file=sys.stderr)
        return 5
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
