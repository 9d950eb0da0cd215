"""Everything the benchmark names is found by name, and a new
configuration, cell, mix, generator, metric and kernel map are found from
files of their own alone."""

from __future__ import annotations

import json
import shutil

from portbench_helpers import DATA, run_tiny, tiny_benchmark

from portbench.registry import Registry


def test_every_name_in_benchmark_json_loads():
    reg = Registry()
    bench = reg.benchmark
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        cfg = reg.config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert all(k in cfg for k in cfg["reduced"])
        assert c["source"] == cfg["source"]
    for w in bench["workloads"]:
        cell = reg.cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert w["config"] in configs
        mix = reg.traffic(w["traffic"])
        assert hasattr(reg.generator(mix["generator"]), "make_pool")
        assert hasattr(reg.entry(cell["entry"]), "run")
        assert reg.end_to_end(w["name"]) and reg.per_layer(w["name"])
        assert set(cell["limits"])
    for name in reg.names("workloads", ".json"):
        cell = reg.cell(name)
        assert reg.config(cell["config"])["name"] == cell["config"]
        assert reg.traffic(cell["traffic"])["generator"]
    for m in bench["per_layer"]:
        assert callable(reg.metric(m["name"]).read)
    for name, opmap in reg.opmaps().items():
        assert opmap["operations"], name
        assert bool(opmap.get("kernels")) != bool(opmap.get("module")), name


def test_throwaway_files_are_found_without_edits(tmp_path):
    for kind in ("configs", "workloads", "traffic", "metrics", "opmap"):
        (tmp_path / kind).mkdir()
    cfg = json.loads((DATA / "configs" / "tiny-deepfm.json").read_text())
    cfg["name"] = "throwaway"
    (tmp_path / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    mix = json.loads((DATA / "traffic" / "tiny-train.json").read_text())
    mix["generator"] = "throwaway_gen"
    (tmp_path / "traffic" / "throwaway-mix.json").write_text(json.dumps(mix))
    (tmp_path / "traffic" / "throwaway_gen.py").write_text(
        "from portbench.registry import HERE, Registry\n"
        "_base = Registry().generator('ctr_rows')\n"
        "CALLS = []\n"
        "def make_pool(config, mix, seed, device):\n"
        "    CALLS.append(seed)\n"
        "    return _base.make_pool(config, mix, seed, device)\n")
    cell = json.loads((DATA / "workloads" / "tiny-deepfm.train.json")
                      .read_text())
    cell.update(config="throwaway", traffic="throwaway-mix")
    (tmp_path / "workloads" / "throwaway.train.json").write_text(
        json.dumps(cell))
    (tmp_path / "metrics" / "throwaway_steps.train.py").write_text(
        "def read(r):\n    return float(r['steps'])\n")
    (tmp_path / "opmap" / "throwaway-op.json").write_text(json.dumps(
        {"operations": ["dnn.forward"], "kernels": ["gemm"]}))

    reg = tiny_benchmark([tmp_path])
    reg.benchmark["workloads"].append(
        {"name": "throwaway.train", "config": "throwaway",
         "traffic": "throwaway-mix", "chips": 1, "why": "a test"})
    for m in reg.benchmark["end_to_end"]:
        if m["name"] == "train_examples_per_s":
            m["workloads"].append("throwaway.train")
    reg.benchmark["per_layer"].append(
        {"name": "throwaway_steps.train", "unit": "steps", "better": "higher",
         "source": "host_clock", "layer": "train loop",
         "moves": "train_examples_per_s", "workloads": ["throwaway.train"]})
    assert "throwaway-op" in reg.opmaps()
    out = run_tiny(reg, "throwaway.train", trace=True, seconds=0.5)
    assert out["metrics"]["throwaway_steps.train"]["value"] > 0
    assert reg.generator("throwaway_gen").CALLS
    out = run_tiny(reg, "throwaway.train", seconds=0.5)
    assert set(out["metrics"]) == {"train_examples_per_s", "setup_s"}
    assert out["correct"] is True
    shutil.rmtree(tmp_path)
