"""Everything a run needs, found by name: the cell in BENCHMARK.json, its
configuration (configs/<config>.json), its traffic mix
(traffic/<traffic>.json) and the per-layer metrics' readers
(metrics/<metric>.py, each with read(run) -> number or None). A new
configuration, mix or metric is a new file and a new entry, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]       # the benchmark's folder


class Bench:
    def __init__(self, bench_dir: Path = HERE, spec_path: Path | None = None):
        self.dir = Path(bench_dir)
        self.root = self.dir.parent
        path = spec_path or self.root / "BENCHMARK.json"
        self.spec = json.loads(Path(path).read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return json.loads((self.dir / "configs" / f"{name}.json").read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, kind: str, cell: str) -> list:
        """The entries of `kind` (end_to_end or per_layer) that this cell
        reports."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
