"""CPU tests of the benchmark harness, at a tiny size: the harness finds its
cells, configurations, modes, mixes and metrics by name (and picks up added
files with no edit, a pipeline too), the plain reference agrees with the
program's records, with the flat scores and with a learned score tensor, a
changed or missing record fails the comparison, a traced run hands the
readers the program's spans and counters, index_to_sam_s is clocked from
the build to the first call's end, the result line has its keys, and a
measurement run without a card prints nothing.

    python -m pytest benchmark/tests -q

The case marked `cuda` runs one tiny cell on the card and skips elsewhere.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import run  # noqa: E402
from harness import judge  # noqa: E402
from harness.spec import Bench  # noqa: E402

SEED = 2**31 + 12_345


def tiny_bench(dst: Path) -> Bench:
    """A copy of the benchmark's folder with a tiny cell beside each real
    one, and one on the combined configuration for each mix that no cell
    uses yet: the same mixes, a 600 kbp genome, 4 batches of 512 reads."""
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in ("chr22_align", "chr22_combined"):
        c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        c["genome"].update(length=600_000, n_gap_lead=100_000,
                           n_gap_internal=1, satellite_bases=2_000,
                           segdup_blocks=1)
        c["genome"]["families"] = [[f[0], f[1], max(1, f[2] // 100), f[3],
                                    f[4]] for f in c["genome"]["families"]]
        c["align"]["batch_size"] = 512
        c["library_reads"] = 2048
        c["sample_reads"] = 512
        if "annotation" in c:
            c["annotation"]["genes"] = 20
        (dst / "benchmark" / "configs" / f"tiny_{name}.json").write_text(
            json.dumps(c))
    used = {w["traffic"] for w in spec["workloads"]}
    for f in sorted((BENCH / "traffic").glob("*.json")):
        if f.stem not in used:    # a mix kept for a later cell
            spec["workloads"].append({
                "name": f"chr22_combined.{f.stem}", "config": "chr22_combined",
                "traffic": f.stem, "chips": 1, "why": "a mix with no cell"})
    for w in spec["workloads"]:
        w["name"], w["config"] = "tiny_" + w["name"], "tiny_" + w["config"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny_" + x for x in m["workloads"]]
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(dst / "benchmark")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> Bench:
    return tiny_bench(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", [
    "tiny_chr22_align.parclip50", "tiny_chr22_combined.junction50",
    "tiny_chr22_align.gapless50", "tiny_chr22_combined.intronic50"])
def test_reference_agrees_with_the_program(tiny, cell, monkeypatch):
    """The whole run on the CPU, through the mode file the configuration
    names: the program's sampled records equal the plain reference's, and
    every call wrote the whole library."""
    found = []
    mode = tiny.mode
    monkeypatch.setattr(tiny, "mode",
                        lambda name: found.append(name) or mode(name))
    res = run.run_cell(tiny, cell, SEED, 0.5, False, device="cpu")
    assert found == [tiny.config(tiny.cell(cell)["config"])["mode"]]
    assert res["correct"], res["checks"]
    assert res["checks"] == {"records_differ": {"value": 0, "limit": 0},
                             "calls_short": {"value": 0, "limit": 0}}
    # a CPU run has no device memory to report
    assert set(res["metrics"]) == {
        m["name"] for m in tiny.metrics("end_to_end", cell)} - {
        "device_mem_peak_mib"}
    assert res["attempted"] >= 2048 and res["failed"] == 0


def test_added_files_are_found_by_name(tmp_path):
    """A new configuration, mix, cell and per-layer metric are new files
    and new entries; nothing that was there is edited."""
    b = tiny_bench(tmp_path)
    d = b.dir
    conf = json.loads((d / "configs" / "tiny_chr22_align.json").read_text())
    conf["genome"]["length"] = 500_000
    (d / "configs" / "other.json").write_text(json.dumps(conf))
    mix = json.loads((d / "traffic" / "parclip50.json").read_text())
    mix["deletion_rate"] = 0.05
    (d / "traffic" / "indel50.json").write_text(json.dumps(mix))
    (d / "metrics" / "stream.batches.py").write_text(
        "def read(run):\n    return float(run.batches)\n")
    spec = json.loads((b.root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "other.indel50", "config": "other",
                              "traffic": "indel50", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "stream.batches", "unit": "batches",
                              "better": "higher", "source": "program_span",
                              "layer": "stream", "moves": "reads_per_s",
                              "workloads": ["other.indel50"]})
    (b.root / "BENCHMARK.json").write_text(json.dumps(spec))
    b = Bench(d)
    assert b.config("other")["genome"]["length"] == 500_000
    assert b.traffic("indel50")["deletion_rate"] == 0.05
    res = run.run_cell(b, "other.indel50", SEED, 0.5, True, device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["stream.batches"]["value"] >= 4
    # the cell's per-layer metrics that a CPU run can read are there too
    for name in ("stream.reader_ms", "stream.emit_ms", "engine.to_host_ms",
                 "step.dispatch_ms"):
        assert name not in res["metrics"]   # listed for other cells only
    res = run.run_cell(b, "tiny_chr22_align.parclip50", SEED, 0.5, True,
                       device="cpu")
    assert {"stream.reader_ms", "stream.emit_ms", "engine.to_host_ms",
            "engine.tracebacks_ms", "step.dispatch_ms"} <= set(res["metrics"])
    assert "stream.batches" not in res["metrics"]
    assert "engine.slow_path_ms" not in res["metrics"]


# A pipeline that no mode file of the benchmark runs: profile-aware align,
# with a score tensor S[cycle, ref, read] drawn from a seed (position-
# dependent, and T read as C cheap where A read as G is not, so the strands
# score differently) swapped into the engine; `reference` scores with S, or
# with the flat tensor in the control's copy.
LEARNED_MODE = '''"""Profile-aware align: mode align with a learned score tensor."""

from pathlib import Path

import numpy as np

from harness import reference as plain, spec

ANNOTATION = False
ALIGN = spec.mode("align", Path(__file__).resolve().parents[1])
call, traced = ALIGN.call, ALIGN.traced


def learned(params):
    L = params["max_read_len"]
    rng = np.random.default_rng({seed})
    s = np.full((L, 5, 5), params["n_score"], dtype=np.int32)
    s[:, :4, :4] = rng.integers(-30, -14, (L, 4, 4))
    s[:, np.arange(4), np.arange(4)] = rng.integers(4, 9, (L, 4))
    s[:, 3, 1] = rng.integers(-8, 1, L)
    return s


def build(conf, genome, txs, device):
    engine = ALIGN.build(conf, genome, txs, device)
    engine.set_profile(learned(conf["align"]))
    return engine


def reference(genome, params, txs, tap):
    return plain.Reference(genome, params, txs, s_fwd={s_fwd})
'''


def learned_bench(dst: Path) -> Bench:
    """tiny_bench with two added modes, configurations and cells, as a
    later pipeline adds them (new files and entries): `align_learned`, and
    `align_learned_flat`, whose reference keeps the flat scores."""
    b = tiny_bench(dst)
    spec = json.loads((b.root / "BENCHMARK.json").read_text())
    conf = b.config("tiny_chr22_align")
    for name, s_fwd in (("align_learned", "learned(params)"),
                        ("align_learned_flat", "None")):
        (b.dir / "modes" / f"{name}.py").write_text(
            LEARNED_MODE.format(seed=SEED, s_fwd=s_fwd))
        conf["mode"] = name
        (b.dir / "configs" / f"tiny_{name}.json").write_text(
            json.dumps(conf))
        spec["workloads"].append({
            "name": f"tiny_{name}.parclip50", "config": f"tiny_{name}",
            "traffic": "parclip50", "chips": 1, "why": "t"})
    (b.root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(b.dir)


@pytest.fixture(scope="module")
def learned(tmp_path_factory) -> Bench:
    return learned_bench(tmp_path_factory.mktemp("learned"))


@pytest.mark.parametrize("mode", ["align_learned", "align_learned_flat"])
def test_added_mode_is_found_by_name(learned, mode):
    """A pipeline added as a mode file, a configuration naming it and a
    cell, with no edit of the harness: the program, its engine scoring with
    the learned S, agrees with the reference given S on every sampled
    record; against the flat reference (the control) records differ, so S
    did work."""
    cell = f"tiny_{mode}.parclip50"
    res = run.run_cell(learned, cell, SEED, 0.5, False, device="cpu")
    assert res["checks"]["calls_short"]["value"] == 0
    if mode == "align_learned":
        assert res["correct"], res["checks"]
    else:
        assert not res["correct"]
        assert res["checks"]["records_differ"]["value"] > 0


def test_reference_takes_a_score_tensor(learned, tmp_path):
    """Reference(s_fwd=the flat tensor) is the default reference; with a
    cycle-varying S it writes the port's records after set_profile(S) for
    every read of a batch, the reverse-strand and gapped ones too; a tensor
    of another shape or a float one is refused."""
    from harness import reference, world
    from parasuite_tpu_torch.pipeline.stream import streaming_align

    conf = learned.config("tiny_align_learned")
    p = conf["align"]
    mix = learned.traffic("parclip50")
    genome = world.make_genome(conf["genome"], SEED)
    lib = world.make_library(mix, p["batch_size"], genome, [], SEED)
    names = [world.read_name(i) for i in range(p["batch_size"])]
    args = (lib.codes, lib.lengths, names, lib.qual)
    flat = reference.Reference(genome, p).sam_lines(*args)
    assert reference.Reference(genome, p, s_fwd=reference.score_tensor(
        p, p["max_read_len"])).sam_lines(*args) == flat

    mode = learned.mode("align_learned")
    S = mode.learned(p)
    want = reference.Reference(genome, p, s_fwd=S).sam_lines(*args)
    fastq, out = tmp_path / "r.fastq", tmp_path / "out.sam"
    world.write_fastq(fastq, lib)
    streaming_align(mode.build(conf, genome, [], "cpu"), fastq, out)
    got = [ln for ln in out.read_bytes().split(b"\n")
           if ln and not ln.startswith(b"@")]
    assert got == want
    rows = [ln.split(b"\t") for ln in want]
    assert sum(r[1] == b"16" for r in rows) > len(rows) // 4
    assert any(b"D" in r[5] for r in rows if r[1] == b"16")
    assert sum(a != b for a, b in zip(want, flat)) > len(rows) // 2
    for bad in (S[:-1], S.astype(np.float64)):
        with pytest.raises(ValueError):
            reference.Reference(genome, p, s_fwd=bad)


def test_traced_run_reads_spans(tiny, monkeypatch):
    """A traced run hands the readers the program's spans and counters of
    its window (step.pack_ms reads them); an untraced run hands
    streaming_align a CommitLog, which records nothing, in its window."""
    import parasuite_tpu_torch.pipeline.stream as pstream
    from harness import system

    logs, runs = [], []
    stream = pstream.streaming_align

    def spy(*a, **kw):
        logs.append(kw.get("log"))
        return stream(*a, **kw)

    monkeypatch.setattr(pstream, "streaming_align", spy)
    per_layer = run.per_layer
    monkeypatch.setattr(run, "per_layer", lambda bench, cell, r: (
        runs.append(r) or per_layer(bench, cell, r)))
    cell = "tiny_chr22_align.parclip50"
    res = run.run_cell(tiny, cell, SEED, 0.5, False, device="cpu")
    assert res["correct"] and not runs
    assert logs[0] is None                       # the warm-up call
    assert len(logs) > 1 and all(type(x) is system.CommitLog
                                 for x in logs[1:])
    logs.clear()
    res = run.run_cell(tiny, cell, SEED, 0.5, True, device="cpu")
    assert res["correct"]
    r, = runs
    window = [x for x in logs if getattr(x, "recording", False)]
    assert len(window) > 0 and len(set(map(id, window))) == 1
    assert r.spans["step.pack"]["calls"] == r.batches
    assert r.spans["step.dispatch"]["calls"] == r.batches
    assert r.counters["reads"] == r.window_reads
    assert {s.name for s in r.span_records} == set(r.spans)
    assert res["metrics"]["step.pack_ms"]["value"] > 0


def test_the_clock_starts_at_the_build(tiny, monkeypatch):
    """index_to_sam_s, reported by a cell whose end_to_end lists it (as an
    added entry would; BENCHMARK.json lists it for no cell, since on the
    card it spreads at least as widely as setup_s), runs from the build to
    the end of the first library call, after the sync that follows it, and
    setup_s holds it: every such result has 0 < index_to_sam_s < setup_s,
    and on the host's clock index_to_sam_s lies between the first call's
    end less the build's start and the run's end less the FASTQ's end. A
    FASTQ written 1.5 s slower (the harness's work) grows setup_s by at
    least 1 s more than index_to_sam_s; a build 1 s slower grows both by
    it. The growth is read from setup_s - index_to_sam_s, the harness's
    part, because one CPU library call's time swings by a second between
    runs of a loaded host; setup_s is read from each run's start (the test
    process started long before), and the first run warms the harness."""
    import time

    from harness import world

    cell = "tiny_chr22_align.parclip50"
    extra = {"write_fastq": 0.0, "build": 0.0}
    marks: dict = {}
    write_fastq, mode = world.write_fastq, tiny.mode

    def slow_write(*a, **kw):
        time.sleep(extra["write_fastq"])
        n = write_fastq(*a, **kw)
        marks["fastq_written"] = time.perf_counter()
        return n

    def timed_mode(name):
        m = mode(name)
        build, call = m.build, m.call

        def slow_build(*a, **kw):
            marks["build"] = time.perf_counter()
            time.sleep(extra["build"])
            return build(*a, **kw)

        def first_call(*a, **kw):
            n = call(*a, **kw)
            marks.setdefault("first_call_done", time.perf_counter())
            return n

        m.build, m.call = slow_build, first_call
        return m

    monkeypatch.setattr(world, "write_fastq", slow_write)
    monkeypatch.setattr(tiny, "mode", timed_mode)
    monkeypatch.setattr(tiny, "spec", dict(tiny.spec, end_to_end=tiny.spec[
        "end_to_end"] + [{"name": "index_to_sam_s", "unit": "s",
                          "better": "lower", "bound": 0.25,
                          "source": "host_clock", "workloads": [cell]}]))

    def clocks(**slower) -> tuple:
        """-> (setup_s, index_to_sam_s) of one run."""
        extra.update(dict.fromkeys(extra, 0.0), **slower)
        marks.clear()
        t0 = time.perf_counter()
        monkeypatch.setattr(run, "since_process_start",
                            lambda: time.perf_counter() - t0)
        res = run.run_cell(tiny, cell, SEED, 0.3, False, device="cpu")
        t1 = time.perf_counter()
        assert res["correct"], res["checks"]
        setup, i2s = (res["metrics"][k]["value"]
                      for k in ("setup_s", "index_to_sam_s"))
        assert 0 < i2s < setup
        assert (marks["first_call_done"] - marks["build"] <= i2s
                <= t1 - marks["fastq_written"])
        return setup, i2s

    clocks()
    setup, i2s = clocks()
    setup_f, i2s_f = clocks(write_fastq=1.5)
    assert (setup_f - i2s_f) - (setup - i2s) >= 1.0
    setup_b, i2s_b = clocks(build=1.0)
    assert i2s_b >= 1.0 and (setup_b - i2s_b) - (setup - i2s) < 0.5


def _altered_answers(monkeypatch):
    from parasuite_tpu_torch.pipeline.align import AlignerEngine
    from parasuite_tpu_torch.pipeline.combined import CombinedEngine

    for cls in (AlignerEngine, CombinedEngine):
        def altered(self, batch, res, _to_host=cls.to_host):
            host = _to_host(self, batch, res)
            host.pos[::5] += 1
            return host

        monkeypatch.setattr(cls, "to_host", altered)


def _half_batch_left_out(monkeypatch):
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    emit = AlignerEngine.emit_sam

    def half(self, batch, host, writer):
        class Half:
            def write(self, line):
                writer.write(line)

            def write_block(self, data):
                lines = data.split(b"\n")
                writer.write_block(b"\n".join(lines[:len(lines) // 2])
                                   + b"\n")

            def flush(self):
                writer.flush()

        emit(self, batch, host, Half())

    monkeypatch.setattr(AlignerEngine, "emit_sam", half)


@pytest.mark.parametrize("fault", [_altered_answers, _half_batch_left_out])
@pytest.mark.parametrize("cell", ["tiny_chr22_align.parclip50",
                                  "tiny_chr22_combined.junction50"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault, cell):
    """The run with the path broken underneath: answers altered where they
    are produced, or half of each batch's records left out."""
    fault(monkeypatch)
    res = run.run_cell(tiny, cell, SEED, 0.5, False, device="cpu")
    assert not res["correct"]
    assert res["checks"]["records_differ"]["value"] > 0


def test_a_changed_record_fails_the_comparison():
    want = [b"r0\t0\tchr\t11\t37\t50M", b"r1\t4\t*\t0\t0\t*"]
    idx = np.asarray([0, 2])
    recs = [want[0], b"x", want[1]]
    assert judge.judge(recs, want, idx)[0] == 0
    recs[2] = recs[2].replace(b"\t0\t0", b"\t0\t1")
    n, ex = judge.judge(recs, want, idx)
    assert n == 1 and ex[0][0] == 2
    assert judge.judge(recs[:2], want, idx)[0] == 1   # a missing record


@pytest.mark.parametrize("cell", ["tiny_chr22_align.parclip50",
                                  "tiny_chr22_combined.junction50"])
def test_the_control_fails(tiny, cell):
    """The control, the reference with its DP in int8 (saturating), put in
    the program's place: most sampled records differ from the exact
    reference's, so records_differ separates it from a sound run."""
    import control

    r = control.control_reading(tiny, cell, SEED)
    assert not r["correct"]
    assert r["records_differ"] > r["sample"] // 2


def test_result_line_keys():
    res = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
           "device": {}, "checks": {}}
    assert list(json.loads(run.result_line(dict(res)))) == [
        "correct", "attempted", "failed", "metrics", "device", "checks"]
    res["breakdown"] = {"device_ops": [], "idle_gaps": []}
    assert list(json.loads(run.result_line(dict(res)))) == [
        "correct", "attempted", "failed", "metrics", "device", "breakdown",
        "checks"]


def test_no_card_no_result():
    """A measurement run that finds no CUDA device exits non-zero and
    prints no result (it never falls back to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "chr22_align.parclip50", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_imports(tmp_path):
    """Nothing a run loads is jax, jaxlib, flax or the JAX package (top-level
    module names compared whole: the port's name begins with the JAX
    package's), and the plain reference loads nothing of the port."""
    code = f"""
import json, sys
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
from harness import reference, world, judge, spec, bounds
ref_mods = {{m.split('.')[0] for m in sys.modules}}
import run
sys.path.insert(0, {str(BENCH / 'tests')!r})
from test_bench_harness import tiny_bench
from pathlib import Path
b = tiny_bench(Path({str(tmp_path)!r}))
res = run.run_cell(b, 'tiny_chr22_combined.junction50', 7, 0.3, True,
                   device='cpu')
print(json.dumps({{'ref': sorted(ref_mods), 'run': run.forbidden_modules(),
                  'all': sorted({{m.split('.')[0] for m in sys.modules}}),
                  'correct': res['correct']}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["run"] == []
    assert not {"jax", "jaxlib", "flax", "parasuite_tpu"} & set(out["all"])
    assert "parasuite_tpu_torch" in out["all"]
    assert not {"parasuite_tpu_torch", "torch", "jax",
                "parasuite_tpu"} & set(out["ref"])


def test_bounds_match_the_smoke_counts():
    """The frozen counts are chip_smoke.py's (select at 65,536 reads: the
    bytes bound it printed, 0.019093 ms; extend: 6 operations a cell)."""
    from harness import bounds

    s = bounds.select_bound(2 * 65536, 7 * 16, 8)
    assert s["by"] == "bytes"
    assert abs(s["ms"] - 0.019093473432835822) < 1e-12
    e = bounds.extend_bound(65536, 8, 50, 5, 20_000_512)
    assert e["by"] == "operations"
    assert e["ops"] == 6 * 2 * 65536 * 8 * 11 * 50


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(tiny):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = run.run_cell(tiny, "tiny_chr22_combined.junction50", SEED, 1.0,
                       True)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["extend_roofline"]["value"] < 105
