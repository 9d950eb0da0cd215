"""Find configurations, model kinds, cells, traffic mixes, entries, metric
readers and kernel maps by name.

A ``Registry`` searches its roots in order; each root is laid out as this
folder is (``configs/``, ``models/``, ``workloads/``, ``traffic/``,
``entries/``, ``metrics/``, ``opmap/``). A later change adds a
configuration, a model kind, a cell, a mix, a generator, a metric or a map
by adding a file under one of them and an entry in ``BENCHMARK.json``; no
file that exists is edited.

A model kind is ``models/<kind>.py``, found by a configuration's
``"model"`` (the port's model name). Beside the leaves every kind shares
(the embedding table and the dense fields' weights; the DNN and the
output heads, where the kind has them), it says what is its own, with
the functions of ``MODEL_FUNCTIONS``, each of the configuration:

* ``port_config(config)``: the sections it adds to the port's
  configuration (``port.experiment_config``);
* ``port_names(config)``: benchmark name -> the port's ``state_dict`` key
  of each of its own leaves (``port.port_names``);
* ``specs(config)``: (name, shape, low, high) of its own leaves, in draw
  order (``weights.specs``);
* ``logit(config, w, first, x0, training, q)``: the reference's logit
  from the first-order term and the (B, F, D) field embeddings, in plain
  float32, every rounding through ``q`` (``reference/ctr.py``);
* ``forward_ops(config, b, es)``, ``backward_ops(config, b, es)``: its own
  operations of a step of ``b`` rows at ``es`` bytes an element, by name
  (``counts.step_ops``);
* ``dnn_width(config)``: the DNN's input width, or None without a DNN;
* ``heads(config)``: (name, input width, the port's ``Linear``) of each
  output head, in draw order.

It imports ``torch`` and ``portbench``'s shared modules, and nothing of
the port.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
BENCHMARK_FILE = HERE.parent / "BENCHMARK.json"
MODEL_FUNCTIONS = ("port_config", "port_names", "specs", "logit",
                   "forward_ops", "backward_ops", "dnn_width", "heads")


class RegistryError(LookupError):
    pass


class Registry:
    def __init__(self, roots=(HERE,), benchmark: dict | None = None):
        self.roots = [Path(r) for r in roots]
        self._benchmark = benchmark
        self._modules: dict[Path, ModuleType] = {}

    # ---------------------------------------------------------------- files

    def _find(self, kind: str, name: str, suffix: str) -> Path:
        for root in self.roots:
            path = root / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise RegistryError(
            f"no {kind}/{name}{suffix} under {[str(r) for r in self.roots]}")

    def _json(self, kind: str, name: str) -> dict:
        return json.loads(self._find(kind, name, ".json").read_text())

    def _module(self, kind: str, name: str) -> ModuleType:
        path = self._find(kind, name, ".py")
        mod = self._modules.get(path)
        if mod is None:
            tag = re.sub(r"\W", "_", f"{kind}_{name}")
            spec = importlib.util.spec_from_file_location(
                f"portbench_{tag}_{len(self._modules)}", path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = mod
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return mod

    def names(self, kind: str, suffix: str) -> list[str]:
        """Every name of ``kind`` found under the roots."""
        out = set()
        for root in self.roots:
            for p in (root / kind).glob(f"*{suffix}"):
                if not p.name.startswith("_"):
                    out.add(p.name[: -len(suffix)])
        return sorted(out)

    # ---------------------------------------------------------------- kinds

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def cell(self, name: str) -> dict:
        return self._json("workloads", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def generator(self, name: str) -> ModuleType:
        return self._module("traffic", name)

    def entry(self, name: str) -> ModuleType:
        return self._module("entries", name)

    def metric(self, name: str) -> ModuleType:
        return self._module("metrics", name)

    def model(self, name: str) -> ModuleType:
        """The model kind ``name`` (a configuration's ``"model"``)."""
        mod = self._module("models", name)
        missing = [f for f in MODEL_FUNCTIONS if not callable(
            getattr(mod, f, None))]
        if missing:
            raise RegistryError(f"models/{name}.py lacks {missing}")
        return mod

    def opmap(self, name: str) -> dict:
        return self._json("opmap", name)

    def opmaps(self) -> dict[str, dict]:
        return {n: self.opmap(n) for n in self.names("opmap", ".json")}

    # ------------------------------------------------------- BENCHMARK.json

    @property
    def benchmark(self) -> dict:
        if self._benchmark is None:
            self._benchmark = json.loads(BENCHMARK_FILE.read_text())
        return self._benchmark

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics ``cell`` reports (``setup_s`` and those
        that list it, or list no cells)."""
        return [m for m in self.benchmark["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics ``cell`` reports: those that list it, and
        those without a list that move one of its end-to-end metrics."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.benchmark["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]
