"""Finding a cell's parts by name: BENCHMARK.json at the checkout's root,
configs/<name>.json (and the plain reference of its AIR beside it,
configs/<name>.py), traffic/<name>.json and metrics/<metric>.py."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Spec:
    """BENCHMARK.json and the folder that holds the benchmark's files."""

    def __init__(self, bench_path: str = os.path.join(ROOT, "BENCHMARK.json"), base: str = HERE):
        with open(bench_path) as f:
            self.bench = json.load(f)
        self.base = base

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       + ", ".join(w["name"] for w in self.bench["workloads"]))

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def air(self, name: str):
        """The plain reference of a configuration's AIR."""
        return self._module("configs", name)

    def reader(self, metric: str):
        """The reader of a metric: metrics/<metric>.py, whose read(ctx)
        returns the value, or None where it finds nothing to read."""
        return self._module("metrics", metric).read

    def metrics(self, cell: str, trace: bool):
        """The metric entries this cell reports: its end-to-end metrics
        untraced, its per-layer metrics traced."""
        entries = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in entries if cell in m.get("workloads", [cell])]

    def _json(self, kind: str, name: str) -> dict:
        with open(os.path.join(self.base, kind, name + ".json")) as f:
            return json.load(f)

    def _module(self, kind: str, name: str):
        path = os.path.join(self.base, kind, name + ".py")
        key = f"stark_bench._{kind}_{name.replace('.', '_')}_{abs(hash(path))}"
        if key not in sys.modules:
            spec = importlib.util.spec_from_file_location(key, path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            sys.modules[key] = module
        return sys.modules[key]
