"""Spans and counters of the port's streaming calls (utils/runlog.py), on
the CPU at a tiny size: the benchmark's cells, cut to a 600 kbp genome and
4 batches of 512 reads (the generator of benchmark/harness/world.py).

A recording run log gets one span of each stage a batch, on its thread and
with its batch index, each child inside its parent; the counters add up to
what the batches hold; the SAM bytes do not depend on recording; a log
that does not record keeps nothing; `align --log` writes the spans; and
each span's total agrees with the benchmark's timer of the same stage
(benchmark/harness/probe.py, wrapped from outside)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import probe as hprobe, system, world  # noqa: E402
from harness.spec import Bench  # noqa: E402

from parasuite_tpu_torch.pipeline.stream import streaming_align  # noqa: E402
from parasuite_tpu_torch.utils import runlog  # noqa: E402
from parasuite_tpu_torch.utils.runlog import RunLog  # noqa: E402

SEED = 2**31 + 4_321
N_READS, BATCH = 2048, 512
N_BATCHES = N_READS // BATCH

THREAD = {"reader.parse": "reader", "reader.wait": "reader",
          "main.wait_reads": "main", "step.dispatch": "main",
          "step.pack": "main", "step.upload": "main", "step.replay": "main",
          "engine.to_host": "main", "engine.fetch": "main",
          "main.wait_writer": "main", "writer.wait": "writer",
          "writer.emit": "writer", "writer.commit": "writer"}
PARENT = {"step.pack": "step.dispatch", "step.upload": "step.dispatch",
          "step.replay": "step.dispatch", "engine.fetch": "engine.to_host",
          "engine.rows": "engine.to_host",
          "engine.slow_path": "engine.to_host",
          "engine.junction_cigars": "engine.to_host",
          "engine.tracebacks.native": "engine.tracebacks",
          "engine.tracebacks.dp": "engine.tracebacks",
          "engine.tracebacks.walk": "engine.tracebacks"}
# the children of engine.tracebacks: the native library's one call, or the
# numpy DP and walk where the library is unavailable
TB_KIDS = {"native": ["engine.tracebacks.native"],
           "numpy": ["engine.tracebacks.dp", "engine.tracebacks.walk"]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Cell:
    """A benchmark cell at the tiny size: its engine on the CPU and its
    library as FASTQ."""

    def __init__(self, name: str, d: Path):
        b = Bench(BENCH)
        w = b.cell(name)
        conf, mix = b.config(w["config"]), b.traffic(w["traffic"])
        conf["genome"].update(length=600_000, n_gap_lead=100_000,
                              n_gap_internal=1, satellite_bases=2_000,
                              segdup_blocks=1)
        conf["genome"]["families"] = [
            [f[0], f[1], max(1, f[2] // 100), f[3], f[4]]
            for f in conf["genome"]["families"]]
        conf["align"]["batch_size"] = BATCH
        if "annotation" in conf:
            conf["annotation"]["genes"] = 20
        self.genome = world.make_genome(conf["genome"], SEED)
        txs = (world.make_annotation(conf["annotation"], self.genome, SEED)
               if conf["mode"] == "combined" else [])
        self.lib = world.make_library(mix, N_READS, self.genome, txs, SEED)
        self.fastq = d / "reads.fastq"
        world.write_fastq(self.fastq, self.lib)
        self.engine = system.build_engine(conf, self.genome, txs, "cpu")
        self.dir = d

    def stream(self, out: str, log=runlog.NULL_LOG) -> bytes:
        path = self.dir / out
        for suffix in ("", ".progress.json"):
            Path(str(path) + suffix).unlink(missing_ok=True)
        n, _c, _p = streaming_align(self.engine, self.fastq, path, log=log)
        assert n == N_READS
        return path.read_bytes()


CELLS = {"plain": "chr22_align.parclip50",
         "combined": "chr22_combined.junction50",
         "gapless": "chr22_align.gapless50"}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    made: dict = {}

    def get(kind: str) -> Cell:
        if kind not in made:
            made[kind] = Cell(CELLS[kind], tmp_path_factory.mktemp(kind))
        return made[kind]

    return get


def _by_id(spans):
    return {s.sid: s for s in spans}


def _library(monkeypatch, lib: str) -> None:
    """lib "numpy": the native library unavailable, every numpy path."""
    from parasuite_tpu_torch import native

    assert native.available()
    if lib == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)


@pytest.mark.parametrize("lib", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["plain", "combined"])
def test_one_span_of_each_stage_a_batch(cells, kind, lib, monkeypatch):
    """Every stage of the table has one span a batch, on its thread, with
    the batch's index; every engine span sits in the span its layer says,
    inside it in time, on the same thread and batch; the host tracebacks'
    children are the native call, or the numpy DP and walk without the
    library; the SAM is the same bytes with recording on and off."""
    _library(monkeypatch, lib)
    cell = cells(kind)
    log = RunLog(record=True)
    recorded = cell.stream("rec.sam", log)
    assert recorded == cell.stream("plain.sam")
    assert log.calls == 1 and {s.call for s in log.spans} == {1}
    by_id = _by_id(log.spans)
    want = set(range(1, N_BATCHES + 1))
    for name, thread in THREAD.items():
        mine = [s for s in log.spans if s.name == name]
        assert sorted(s.batch for s in mine) == sorted(want), name
        assert {s.thread for s in mine} == {thread}, name
    drain = [s for s in log.spans if s.name == "main.wait_drain"]
    assert [(s.thread, s.batch, s.parent) for s in drain] == \
        [("main", N_BATCHES, None)]
    names = {s.name for s in log.spans}
    assert {"engine.tracebacks", "engine.rows", *TB_KIDS[lib]} <= names
    other = "numpy" if lib == "native" else "native"
    assert not set(TB_KIDS[other]) & names
    if kind == "combined":
        assert "engine.slow_path" in names
    for s in log.spans:
        assert s.t1 >= s.t0, s
        if s.name in THREAD and s.name not in PARENT:
            assert s.parent is None, s        # a root opens each stage
        if s.parent is None:
            continue
        p = by_id[s.parent]
        assert (p.thread, p.batch, p.call) == (s.thread, s.batch, s.call)
        assert p.t0 <= s.t0 <= s.t1 <= p.t1, (s, p)
        if s.name in PARENT:
            assert p.name == PARENT[s.name], (s, p)
    tb = [s for s in log.spans if s.name == "engine.tracebacks"]
    assert all(by_id[s.parent].name in ("engine.to_host", "engine.slow_path")
               for s in tb)
    for s in tb:
        kids = sorted(k.name for k in log.spans if k.parent == s.sid)
        assert kids == TB_KIDS[lib]


@pytest.mark.parametrize("lib", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["plain", "combined"])
def test_counters_add_up(cells, kind, lib, monkeypatch):
    """reads sums to the library, per batch to its real reads;
    engine.gapped_rows to the rows handed to the host tracebacks (in the
    plain engine, the records with mapped & ~ug_equal), all of them
    finished by the native library (engine.tracebacks_native) when it is
    there and none without it; the combined
    engine's slow-path rows, wire entries and junction winners to what its
    slow path and its own counters saw; bytes up and down to the wire's
    22 and 13 bytes a read (plain); writer.sam_bytes to the SAM body."""
    import parasuite_tpu_torch.pipeline.align as palign
    import parasuite_tpu_torch.pipeline.combined as pcombined

    _library(monkeypatch, lib)
    cell = cells(kind)
    eng = cell.engine
    hosts, tb_rows, tx_rows = [], [], []
    to_host, tbs = eng.to_host, palign.host_tracebacks_batch

    def keep_host(batch, res):
        host = to_host(batch, res)
        hosts.append((batch.n_real, host))
        return host

    def keep_rows(*a, **kw):
        tb_rows.append(a[4].shape[0])
        return tbs(*a, **kw)

    monkeypatch.setattr(eng, "to_host", keep_host)
    for mod in (palign, pcombined):
        monkeypatch.setattr(mod, "host_tracebacks_batch", keep_rows)
    if kind == "combined":
        slow = eng._slow_path

        def keep_tx(batch, rows, *a, **kw):
            tx_rows.append(rows.shape[0])
            return slow(batch, rows, *a, **kw)

        monkeypatch.setattr(eng, "_slow_path", keep_tx)
        before = (eng.packed_entries, eng.packed_junctions)
    log = RunLog(record=True)
    sam = cell.stream("count.sam", log)
    c = log.summary()["counters"]
    per_batch = {(b, name): n for (_c, b, name), n in log.counters.items()}
    assert c["reads"] == N_READS
    assert [per_batch[(k, "reads")] for k in range(1, N_BATCHES + 1)] == \
        [n for n, _h in hosts]
    assert c["engine.gapped_rows"] == sum(tb_rows) > 0
    assert c.get("engine.tracebacks_native", 0) == (
        c["engine.gapped_rows"] if lib == "native" else 0)
    if kind == "plain":
        assert c["engine.gapped_rows"] == sum(
            int((h.mapped[:n] & ~h.ug_equal[:n]).sum()) for n, h in hosts)
        assert c["step.bytes_up"] == N_READS * (13 + 7 + 2)
        assert c["engine.bytes_down"] == N_READS * 13
    else:
        assert c["engine.slow_path_rows"] == sum(tx_rows) > 0
        assert (c["engine.wire_entries"], c["engine.junction_winners"]) == (
            eng.packed_entries - before[0], eng.packed_junctions - before[1])
        assert c.get("engine.overflow_reruns", 0) == 0
        assert c["step.bytes_up"] >= N_READS * (13 + 7 + 2)
    body = sum(len(ln) + 1 for ln in sam.split(b"\n")
               if ln and not ln.startswith(b"@"))
    assert c["writer.sam_bytes"] == body
    # no span or counter outside a batch
    assert all(b is not None for (_c, b, _n) in log.counters)
    assert all(s.batch is not None for s in log.spans)


def test_nothing_recorded_when_off(cells):
    """A log that does not record keeps no span and no counter, and on a
    thread bound to none span() is the one shared null context and count()
    does nothing; a recording call leaves its threads unbound."""
    cell = cells("plain")
    log = RunLog()
    cell.stream("off.sam", log)
    assert log.spans == [] and log.counters == {} and log.calls == 0
    assert runlog.span("step.pack") is runlog.NULL_SPAN
    assert runlog.span("x", batch=3) is runlog.NULL_SPAN
    assert runlog.count("reads", 5) is None
    assert runlog.bind(log, "main") is runlog.NULL_SPAN
    assert runlog.bind(system.CommitLog(), "main") is runlog.NULL_SPAN
    with runlog.span("x") as s:
        s.drop()
    rec = RunLog(record=True)
    cell.stream("on.sam", rec)
    assert rec.spans and runlog.span("x") is runlog.NULL_SPAN
    with runlog.bind(rec, "main"):
        with runlog.span("outer", batch=7):
            with runlog.span("inner"):
                runlog.count("k", 2)
            with runlog.span("gone") as g:
                g.drop()
    assert runlog.span("x") is runlog.NULL_SPAN
    inner, outer = rec.spans[-2:]
    assert (outer.name, inner.name) == ("outer", "inner")
    assert (inner.batch, inner.parent, inner.thread) == (7, outer.sid, "main")
    assert rec.counters[(rec.calls, 7, "k")] == 2
    summ = rec.summary()["spans"]
    assert summ["outer"]["self_seconds"] == pytest.approx(
        summ["outer"]["seconds"] - summ["inner"]["seconds"], abs=1e-9)
    assert "gone" not in summ


def test_cli_align_log_writes_spans(tmp_path):
    """`align --log` appends each span and each batch's counters to the
    log's JSONL at the end, beside the align.batch events."""
    from parasuite_tpu_torch import cli
    from parasuite_tpu_torch.io.fasta import write_fasta

    flags = ["--max-read-len", "50", "--kmer-size", "8", "--band-width",
             "3", "--batch-size", "64"]
    rng = np.random.default_rng(5)
    write_fasta(tmp_path / "ref.fa",
                {"c1": rng.integers(0, 4, 6000).astype(np.int8)})
    for argv in (["index", tmp_path / "ref.fa", tmp_path / "idx"],
                 ["simulate", tmp_path / "idx", tmp_path / "r.fastq",
                  "--n-reads", "200", "--del-rate", "0.001"],
                 ["align", tmp_path / "idx", tmp_path / "r.fastq",
                  tmp_path / "out.sam", "--log", tmp_path / "run.jsonl",
                  "--device", "cpu"]):
        assert cli.main([str(a) for a in argv] + flags) == 0
    events = [json.loads(x) for x in
              (tmp_path / "run.jsonl").read_text().splitlines()]
    stages = [e["stage"] for e in events]
    assert stages.count("align.batch") == 4              # 200 / 64
    spans = [e for e in events if e["stage"] == "span"]
    assert stages.index("align.done") < stages.index("span")
    for name in THREAD:
        assert sorted(e["batch"] for e in spans if e["name"] == name) == \
            [1, 2, 3, 4], name
    assert {"name", "thread", "call", "batch", "t0_ns", "t1_ns", "id",
            "parent"} <= set(spans[0])
    counters = [e for e in events if e["stage"] == "counters"]
    assert sum(e["reads"] for e in counters) == 200


@pytest.mark.parametrize("kind", ["plain", "combined", "gapless"])
def test_spans_agree_with_the_probe(cells, kind):
    """One recorded library call of each tiny cell under the benchmark's
    probe: each span's total is the probe's timer of the same stage within
    10% plus 1 ms a batch."""
    cell = cells(kind)
    eng = cell.engine
    p = hprobe.Probe(eng)
    try:
        log = RunLog(record=True)
        cell.stream("probe.sam", log)
    finally:
        p.restore()
    timers = p.acc.report()
    spans = log.summary()["spans"]
    pairs = [("reader.parse", "reader.next_batch"),
             ("step.dispatch", "main.dispatch"),
             ("engine.to_host", "main.to_host"),
             ("writer.emit", "writer.emit")]
    if kind != "gapless":
        pairs.append(("engine.tracebacks",
                      "main.to_host.host_tracebacks_batch"))
    if kind == "combined":
        pairs.append(("engine.slow_path", "main.to_host.slow_path"))
    for span_name, timer in pairs:
        got = spans[span_name]["seconds"]
        want = timers[timer]["seconds"]
        assert timers[timer]["calls"] > 0, timer
        assert abs(got - want) <= 0.10 * want + 1e-3 * N_BATCHES, \
            (span_name, got, timer, want)


def test_trace_cell_tool_on_a_tiny_cell(tmp_path, capsys):
    """tools/torch_trace_cell.py on a tiny copy of the junction50 cell on
    the CPU: the recorded window's per-layer numbers, every span against
    the probe's timer of its stage, and the off / on windows; no profiled
    call without a card."""
    import shutil

    sys.path.insert(0, str(ROOT / "tools"))
    import torch_trace_cell as tool

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((BENCH / "configs" / "chr22_combined.json").read_text())
    conf["genome"].update(length=600_000, n_gap_lead=100_000,
                          n_gap_internal=1, satellite_bases=2_000,
                          segdup_blocks=1)
    conf["genome"]["families"] = [[f[0], f[1], max(1, f[2] // 100), f[3],
                                   f[4]] for f in conf["genome"]["families"]]
    conf["align"]["batch_size"] = BATCH
    conf["library_reads"] = N_READS
    conf["annotation"]["genes"] = 20
    (tmp_path / "benchmark" / "configs" / "tiny.json").write_text(
        json.dumps(conf))
    spec["workloads"] = [{"name": "tiny.junction50", "config": "tiny",
                          "traffic": "junction50", "chips": 1, "why": "t"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    assert tool.main(["--workload", "tiny.junction50", "--seed", str(SEED),
                      "--seconds", "2", "--cost-pairs", "1", "--device",
                      "cpu", "--bench", str(tmp_path / "benchmark")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rec = out["recorded"]
    assert rec["batches"] == N_BATCHES * rec["calls"]
    assert set(rec["metrics"]) == set(tool.SPAN_MS) | set(tool.PER_KREAD)
    assert rec["metrics"]["engine.slow_rows_per_kread"] > 0
    assert rec["counters"]["reads"] == N_READS * rec["calls"]
    assert set(rec["agreement"]) == set(tool.PROBE)
    for name, a in rec["agreement"].items():
        assert abs(a["span_ms"] - a["probe_ms"]) <= \
            0.10 * a["probe_ms"] + 1.0, name
    assert "profiled" not in out and out["gpu"] == "cpu"
    assert len(out["cost"]["off_reads_per_s"]) == 1
    assert len(out["cost"]["on_reads_per_s"]) == 1
    assert "median_on_over_off" in out["cost"]


def _step_memory_tiny(tmp_path, capsys, config: str, traffic: str,
                      **update) -> dict:
    """tools/torch_step_memory.py on the CPU on a tiny copy of the cell of
    configuration `config` and mix `traffic` (600 kbp, batches of 512 and
    64 reads) -> its JSON line; `update` goes into the configuration's
    groups."""
    import shutil

    sys.path.insert(0, str(ROOT / "tools"))
    import torch_step_memory as tool

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    conf["genome"].update(length=600_000, n_gap_lead=100_000,
                          n_gap_internal=1, satellite_bases=2_000,
                          segdup_blocks=1)
    conf["genome"]["families"] = [[f[0], f[1], max(1, f[2] // 100), f[3],
                                   f[4]] for f in conf["genome"]["families"]]
    conf["align"]["batch_size"] = BATCH
    conf["library_reads"] = N_READS
    for key, value in update.items():
        conf[key].update(value)
    (tmp_path / "benchmark" / "configs" / "tiny.json").write_text(
        json.dumps(conf))
    spec["workloads"] = [{"name": f"tiny.{traffic}", "config": "tiny",
                          "traffic": traffic, "chips": 1, "why": "t"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    assert tool.main(["--workload", f"tiny.{traffic}", "--seed", str(SEED),
                      "--batches", f"{BATCH},64", "--device", "cpu",
                      "--bench", str(tmp_path / "benchmark")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["device"], out["gpu"], out["engine_allocated"]) == \
        ("cpu", "cpu", 0)
    assert out["program"] == str(ROOT)
    assert list(out["batches"]) == [str(BATCH), "64"]
    for rec in out["batches"].values():
        assert rec["peak_stage"] in rec["stages"]
        assert rec["eager_peak_above_step"] == 0
        assert rec["graphed_peak_above_step"] == 0
    return out


def test_step_memory_tool_on_a_tiny_cell(tmp_path, capsys):
    """tools/torch_step_memory.py on a tiny copy of the parclip50 cell on
    the CPU: the wire step cut at its stages, seed and select as one
    (seed_select), finalize as its entries' preamble and the selection
    (finalize_select), each batch size's eager, staged and graphed record;
    no byte is counted without a card, and the gpu field says cpu."""
    out = _step_memory_tiny(tmp_path, capsys, "chr22_align", "parclip50")
    assert not out["with_counts"]
    for rec in out["batches"].values():
        assert list(rec["stages"]) == ["unpack", "orient", "seed_select",
                                       "extend", "finalize_entries",
                                       "finalize_select", "pack"]


def test_step_memory_tool_on_a_tiny_combined_cell(tmp_path, capsys):
    """The same tool on a tiny copy of the junction50 cell: the combined
    engine's projected step (align_batch_combined_packed) cut at its
    stages, its finalize with src, nm_pos and nm_strand between the genome
    projection and the compactions."""
    out = _step_memory_tiny(tmp_path, capsys, "chr22_combined",
                            "junction50", annotation={"genes": 20})
    for rec in out["batches"].values():
        assert list(rec["stages"]) == ["unpack", "orient", "seed_select",
                                       "extend", "table", "project",
                                       "finalize", "compact", "pack"]


def test_step_memory_tool_on_a_tiny_twopass_cell(tmp_path, capsys):
    """The same tool on a tiny copy of the twopass50 cell: pass 1's wire
    step with its fused profile counts, cut as the plain step's stages and
    the counts."""
    out = _step_memory_tiny(tmp_path, capsys, "chr22_twopass", "parclip50")
    assert out["with_counts"]
    for rec in out["batches"].values():
        assert list(rec["stages"]) == ["unpack", "orient", "seed_select",
                                       "extend", "finalize_entries",
                                       "finalize_select", "pack", "counts"]
