"""Everything the benchmark names is found by name, and a new
configuration, model kind, cell, mix, generator, metric and kernel map are
found from files of their own alone."""

from __future__ import annotations

import json
import shutil

import pytest
from portbench_helpers import DATA, run_tiny, tiny_benchmark

from portbench.registry import MODEL_FUNCTIONS, Registry, RegistryError


def test_every_name_in_benchmark_json_loads():
    reg = Registry()
    bench = reg.benchmark
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        cfg = reg.config(c["name"])
        assert reg.model(cfg["model"])
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
    for name in reg.names("configs", ".json"):
        kind = reg.model(reg.config(name)["model"])
        assert all(callable(getattr(kind, f)) for f in MODEL_FUNCTIONS)
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


# The port's factorization machine (first order + FM, no DNN, no head), a
# kind the harness has no file for.
FM_KIND = """
from portbench.counts import Op
from portbench.reference import ctr


def port_config(config):
    return {}


def port_names(config):
    return {}


def specs(config):
    return []


def dnn_width(config):
    return None


def heads(config):
    return []


def logit(config, w, first, x0, training, q=ctr.identity):
    s = x0.sum(1)
    return first + q(0.5 * (s * s - (x0 * x0).sum(1)).sum(1))


def _n(config, b):
    return b * (config["dense_fields"] + config["sparse_fields"]) \\
        * config["embed_dim"]


def forward_ops(config, b, es):
    return {"fm.forward": Op(3 * _n(config, b), _n(config, b) * es + b * es)}


def backward_ops(config, b, es):
    return {"fm.backward": Op(3 * _n(config, b), 2 * _n(config, b) * es)}
"""


def _copy(src, dst, **changes):
    data = json.loads(src.read_text())
    data.update(changes)
    dst.write_text(json.dumps(data))


def test_a_model_kind_joins_by_files_alone(tmp_path):
    for kind in ("configs", "models", "workloads", "metrics", "opmap"):
        (tmp_path / kind).mkdir()
    (tmp_path / "models" / "fm.py").write_text(FM_KIND)
    _copy(DATA / "configs" / "tiny-deepfm.json",
          tmp_path / "configs" / "tiny-fm.json", name="tiny-fm", model="fm")
    cells = {"tiny-fm.train": ("tiny-deepfm.train", "train_examples_per_s"),
             "tiny-fm.score": ("tiny-xdeepfm.score", "score_rows_per_s")}
    for cell, (like, _) in cells.items():
        _copy(DATA / "workloads" / f"{like}.json",
              tmp_path / "workloads" / f"{cell}.json", config="tiny-fm")
    (tmp_path / "metrics" / "fm_flops.py").write_text(
        "def read(r):\n"
        "    return sum(op.flops for n, op in r['ops'].items()\n"
        "               if n.startswith('fm.'))\n")
    (tmp_path / "metrics" / "roofline.fm.py").write_text(
        "from portbench.readings import roofline\n"
        "def read(r):\n    return roofline(r, 'fm')\n")
    (tmp_path / "opmap" / "fm.json").write_text(json.dumps(
        {"operations": ["fm.forward", "fm.backward"], "kernels": ["fm"]}))

    reg = tiny_benchmark([tmp_path])
    bench = reg.benchmark
    for cell, (_, rate) in cells.items():
        next(m for m in bench["end_to_end"]
             if m["name"] == rate)["workloads"].append(cell)
    for name in ("fm_flops", "roofline.fm"):
        bench["per_layer"].append(
            {"name": name, "unit": "%", "better": "higher",
             "source": "device_trace", "layer": "kernels: FM",
             "moves": "train_examples_per_s", "workloads": list(cells)})
    assert "fm" in reg.opmaps()
    fm_flops = 3 * 64 * 7 * 4  # B x F x D of the tiny mixes, 3 a term
    for cell, want in (("tiny-fm.train", 2 * fm_flops),
                       ("tiny-fm.score", fm_flops)):
        out = run_tiny(reg, cell, trace=True, seconds=0.5)
        assert out["correct"] is True, out["checks"]
        assert out["metrics"]["fm_flops"]["value"] == want
        # no device trace on the CPU, so no roofline share
        assert "roofline.fm" not in out["metrics"]
        out = run_tiny(reg, cell, seconds=0.5)
        assert out["correct"] is True, out["checks"]
        assert "setup_s" in out["metrics"]
    shutil.rmtree(tmp_path)


def test_a_config_of_an_unknown_kind_fails_at_set_up(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "workloads").mkdir()
    _copy(DATA / "configs" / "tiny-deepfm.json",
          tmp_path / "configs" / "tiny-lr.json", name="tiny-lr", model="lr")
    _copy(DATA / "workloads" / "tiny-deepfm.train.json",
          tmp_path / "workloads" / "tiny-lr.train.json", config="tiny-lr",
          traffic="no-such-mix")
    with pytest.raises(RegistryError, match="models/lr.py"):
        run_tiny(tiny_benchmark([tmp_path]), "tiny-lr.train")
    shutil.rmtree(tmp_path)
