"""A short run of each entry at a CPU size prints the contract's line; a
CPU run writes no device metric; without a card, or without the port, the
command prints no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
from portbench_helpers import SEED, run_tiny, tiny_benchmark

from portbench.registry import HERE

DEVICE_METRICS = ("mfu", "roofline", "device_idle", "kernels_per_step")


@pytest.mark.parametrize("cell", ["tiny-xdeepfm.train", "tiny-deepfm.train",
                                  "tiny-xdeepfm.score"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_short_cpu_run_prints_the_contract_keys(cell, trace):
    reg = tiny_benchmark()
    out = run_tiny(reg, cell, trace=trace)
    json.loads(json.dumps(out))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    names = set(out["metrics"])
    if trace:
        wanted = {m["name"] for m in reg.per_layer(cell)}
        assert names <= wanted and names
        assert not [n for n in names if n.startswith(DEVICE_METRICS)]
        assert "busy_s" not in out["device"]
    else:
        assert names == {m["name"] for m in reg.end_to_end(cell)}
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name


def test_the_same_seed_reads_the_same_numbers():
    reg = tiny_benchmark()
    a = run_tiny(reg, "tiny-deepfm.train", seconds=0.2)
    b = run_tiny(reg, "tiny-deepfm.train", seconds=0.2, seed=SEED)
    assert a["checks"] == b["checks"]


def test_without_a_card_the_command_prints_no_result(tmp_path):
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (HERE.parent, tmp_path):
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload",
             "xdeepfm-paper.train", "--seed", "1", "--seconds", "1",
             "--trace", "0"], capture_output=True, text=True, timeout=300,
            cwd=cwd, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert out.stdout.strip() == ""
