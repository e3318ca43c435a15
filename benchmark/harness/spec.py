"""Everything a run needs, found by name: the cell in BENCHMARK.json, its
configuration (configs/<config>.json), the pipeline the configuration names
as its `mode` (modes/<mode>.py), its traffic mix (traffic/<traffic>.json)
and the per-layer metrics' readers (metrics/<metric>.py, each with
read(run) -> number or None). A new configuration, pipeline, mix or metric
is a new file and a new entry, never an edit.

A mode file holds what differs between pipelines:

  ANNOTATION                   whether the configuration's annotation is
                               made (and handed to build and reference)
  build(conf, genome, txs, device) -> engine
  call(engine, fastq, out_sam, tap, log=None) -> records
                               one library call as a user runs it; the tap
                               (harness/system.py::SamTap) keeps the records
                               the judge reads, and may keep more
  reference(genome, params, txs, tap) -> an object with sam_lines(codes,
                               lengths, names, qual), filled_share, packed
                               and s_fwd (harness/reference.py::Reference):
                               the reference that judges the call; tap is
                               None where no call ran (the control, which
                               scores with its s_fwd in int8)
  traced(n_batches) -> (first, stop)
                               the dispatches of one call, counted from 0,
                               that a traced run profiles on the device
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]       # the benchmark's folder


def load(path: Path, prefix: str):
    """The module in the file `path`, under a name made from `prefix` and
    the file's stem."""
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mode(name: str, bench_dir: Path = HERE):
    """The mode file modes/<name>.py of the benchmark's folder (module
    docstring)."""
    return load(Path(bench_dir) / "modes" / f"{name}.py", "bench_mode_")


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

    def mode(self, name: str):
        return mode(name, self.dir)

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, kind: str, cell: str) -> list:
        """The entries of `kind` (end_to_end or per_layer) that this cell
        reports."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        return load(self.dir / "metrics" / f"{metric}.py",
                    "bench_metric_").read
