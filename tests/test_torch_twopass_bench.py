"""The two-pass deployment of the benchmark (configs/chr22_twopass.json,
modes/twopass.py) and parasuite_tpu_torch's streaming_two_pass, on the CPU
at a tiny size: a copy of the benchmark's folder with a tiny chr22_twopass
(a 600 kbp genome, 4 batches of 512 reads) and its parclip50 cell.

The whole run is correct on two seeds; a learned S entry changed, a gapped
row's counts dropped in pass 1, or a pass-1 record changed in the tap each
make it not correct, and so does the control; the mode's counts from pass-1
records are the program's profile; two calls on one engine write the same
bytes; pass 1 records one engine.profile span a batch, with counters that
add up to the profile, and one twopass.switch a call; and the mode's
reference loads nothing of the program, torch or jax."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import run  # noqa: E402
from harness import system, world  # noqa: E402
from harness.spec import Bench  # noqa: E402

from parasuite_tpu_torch.pipeline.stream import streaming_align  # noqa: E402
from parasuite_tpu_torch.pipeline.two_pass import (  # noqa: E402
    streaming_two_pass)
from parasuite_tpu_torch.utils.runlog import RunLog  # noqa: E402

SEEDS = [2**31 + 2_016, 2**33 + 7]
CELL = "tiny_chr22_twopass.parclip50"
N_READS, BATCH = 2048, 512


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config() -> dict:
    conf = json.loads((BENCH / "configs" / "chr22_twopass.json").read_text())
    conf["genome"].update(length=600_000, n_gap_lead=100_000,
                          n_gap_internal=1, satellite_bases=2_000,
                          segdup_blocks=1)
    conf["genome"]["families"] = [[f[0], f[1], max(1, f[2] // 100), f[3],
                                   f[4]] for f in conf["genome"]["families"]]
    conf["align"]["batch_size"] = BATCH
    conf["library_reads"] = N_READS
    conf["sample_reads"] = 512
    return conf


def tiny_twopass_bench(dst: Path) -> Bench:
    """A copy of the benchmark's folder with the tiny cell added (a new
    configuration file and entry)."""
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (dst / "benchmark" / "configs" / "tiny_chr22_twopass.json").write_text(
        json.dumps(tiny_config()))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": CELL, "config": "tiny_chr22_twopass",
                              "traffic": "parclip50", "chips": 1,
                              "why": "t"})
    for m in spec["per_layer"]:
        if "chr22_twopass.parclip50" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(dst / "benchmark")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> Bench:
    return tiny_twopass_bench(tmp_path_factory.mktemp("twopass"))


class World:
    """The tiny configuration's genome, engine (mode twopass's build) and a
    library as FASTQ, from a seed and a read mix."""

    def __init__(self, d: Path, seed: int, **mix):
        b = Bench(BENCH)
        self.conf = tiny_config()
        self.mode = b.mode("twopass")
        self.mix = dict(b.traffic("parclip50"), **mix)
        self.genome = world.make_genome(self.conf["genome"], seed)
        self.lib = world.make_library(self.mix, N_READS, self.genome, [],
                                      seed)
        self.fastq = d / "reads.fastq"
        world.write_fastq(self.fastq, self.lib)
        self.engine = self.mode.build(self.conf, self.genome, [], "cpu")
        self.dir = d


@pytest.fixture(scope="module")
def tw(tmp_path_factory) -> World:
    return World(tmp_path_factory.mktemp("tw"), SEEDS[0])


@pytest.mark.parametrize("seed,trace", [(SEEDS[0], False),
                                        (SEEDS[1], True)])
def test_the_cell_is_correct(tiny, seed, trace):
    """The whole run on the CPU: every sampled pass-2 record is the
    reference's with S learned from pass 1's records, every call wrote the
    whole library, and no sampled pass-1 record or profile entry differs; a
    traced run reports the cell's three per-layer metrics."""
    # a traced window that holds whole calls of the CPU's (4-6 s each on a
    # loaded host), so that batches commit in it
    res = run.run_cell(tiny, CELL, seed, 15.0 if trace else 0.5, trace,
                       device="cpu")
    assert res["checks"] == {"records_differ": {"value": 0, "limit": 0},
                             "calls_short": {"value": 0, "limit": 0}}
    assert res["correct"] and res["failed"] == 0
    if not trace:
        assert set(res["metrics"]) == {"setup_s"}
        return
    m = res["metrics"]
    assert set(m) == {"twopass.reads_per_s", "twopass.profile_ms",
                      "twopass.switch_ms"}
    assert m["twopass.reads_per_s"]["value"] > 0
    assert m["twopass.profile_ms"]["value"] > 0
    assert m["twopass.switch_ms"]["value"] > 0


def _perturbed_s(monkeypatch, mode):
    """One entry of the learned S changed after counts_to_profile."""
    import parasuite_tpu_torch.pipeline.two_pass as tp

    learned = tp.counts_to_profile

    def perturbed(profile, cfg):
        s = learned(profile, cfg).copy()
        s[17, 3, 1] -= 1
        return s

    monkeypatch.setattr(tp, "counts_to_profile", perturbed)
    return mode


def _gapped_row_dropped(monkeypatch, mode):
    """The substitution counts of one gapped row (the first one counted,
    found by its position) left out of every pass 1."""
    import parasuite_tpu_torch.errormodel.infer as infer

    count = infer.count_substitutions_from_cigar
    first = []

    def dropped(ref_seq, packed_pos, *a, **kw):
        first.append(packed_pos)
        if packed_pos != first[0]:
            count(ref_seq, packed_pos, *a, **kw)

    monkeypatch.setattr(infer, "count_substitutions_from_cigar", dropped)
    return mode


def _pass1_record_changed(monkeypatch, mode):
    """One sampled read's pass-1 record given another MAPQ in the tap."""
    from harness import judge

    call = mode.call

    def changed(engine, fastq, out_sam, tap, log=None):
        n = call(engine, fastq, out_sam, tap, log)
        i = int(judge.sample(N_READS, 512, SEEDS[0])[0])
        lines = b"".join(tap.pass1).split(b"\n")
        f = lines[i].split(b"\t")
        f[4] = b"1" if f[4] != b"1" else b"2"
        lines[i] = b"\t".join(f)
        tap.pass1[:] = [b"\n".join(lines)]
        return n

    mode.call = changed
    return mode


@pytest.mark.parametrize("fault", [_perturbed_s, _gapped_row_dropped,
                                   _pass1_record_changed])
def test_a_planted_fault_is_not_correct(tiny, monkeypatch, fault):
    """Each fault makes the run not correct: the judged lines come back
    marked where the program's profile, S or pass-1 record is not the
    reference's."""
    mode = tiny.mode
    monkeypatch.setattr(tiny, "mode",
                        lambda name: fault(monkeypatch, mode(name)))
    res = run.run_cell(tiny, CELL, SEEDS[0], 0.5, False, device="cpu")
    assert not res["correct"]
    assert res["checks"]["records_differ"]["value"] > 0
    assert res["checks"]["calls_short"]["value"] == 0


def test_the_control_fails(tiny):
    """The control (the reference's DP in int8, scoring with the read
    model's S, no call) is not correct."""
    import control

    r = control.control_reading(tiny, CELL, SEEDS[0])
    assert not r["correct"]
    assert r["records_differ"] > r["sample"] // 2
    S = tiny.mode("twopass").reference(world.make_genome(
        tiny_config()["genome"], 1), tiny_config()["align"], [], None).s_fwd
    assert len({S[i].tobytes() for i in range(S.shape[0])}) > 1
    assert S[0, 3, 1] > S[0, 0, 2]          # T read as C, not A read as G


def test_counts_from_records_are_the_programs(tmp_path):
    """The mode's counts from the SAM records of one profile pass are the
    program's ErrorProfile, entry for entry, on a library with
    reverse-strand, gapped and all-N reads."""
    w = World(tmp_path, SEEDS[1], all_n_share=0.02, deletion_rate=0.05)
    indels: dict = {}
    out = tmp_path / "p1.sam"
    _n, counts, n_reads = streaming_align(
        w.engine, w.fastq, out, with_profile_counts=True, indel_out=indels)
    lines = [ln for ln in out.read_bytes().split(b"\n")
             if ln and not ln.startswith(b"@")]
    from harness import reference

    packed = reference.Packed(w.genome, w.conf["align"]["chrom_spacer"])
    got = w.mode.profile_from_records(lines, packed, 50)
    rows = [ln.split(b"\t") for ln in lines]
    assert sum(r[1] == b"16" for r in rows) > len(rows) // 4
    assert sum(r[1] == b"4" for r in rows) >= 0.02 * N_READS
    assert got["n_gapped"] > 10
    assert np.array_equal(got["counts"], counts)
    assert got["n_reads"] == n_reads
    assert np.array_equal(got["ins"], indels["ins"])
    assert np.array_equal(got["dels"], indels["dels"])
    assert got["n_gapped"] == indels["n_gapped"]


def _two_pass(w: World, tag: str, log=None) -> dict:
    out = w.dir / f"{tag}.sam"
    kw = {"log": log} if log is not None else {}
    n, profile, n1 = streaming_two_pass(
        w.engine, w.fastq, out, pass1_out=str(out) + ".pass1.sam",
        profile_out=str(out) + ".errorprofile", **kw)
    assert n == n1 == N_READS
    return {"profile": profile, **{s: Path(str(out) + s).read_bytes()
                                   for s in ("", ".pass1.sam",
                                             ".errorprofile")}}


def test_two_calls_on_one_engine_write_the_same_bytes(tw):
    """The second call's pass 1 starts from the flat tensor again, though
    the first left the learned one set: the pass-1 SAM, the profile file
    and the pass-2 SAM are the same bytes."""
    first = _two_pass(tw, "a")
    second = _two_pass(tw, "b")
    for k in ("", ".pass1.sam", ".errorprofile"):
        assert first[k] == second[k], k
    assert first[""] != first[".pass1.sam"]


def test_spans_of_the_two_passes(tw):
    """One engine.profile span a pass-1 batch (main thread, after the
    batch's engine.to_host), none in pass 2 or in a plain streaming call;
    one twopass.switch a call, between the passes; profile.reads and
    profile.gapped_rows add up to the profile's n_reads and n_gapped."""
    log = RunLog(record=True)
    res = _two_pass(tw, "spans", log)
    streaming_align(tw.engine, tw.fastq, tw.dir / "plain.sam", log=log)
    assert log.calls == 3                # pass 1, pass 2, the plain call
    prof = [s for s in log.spans if s.name == "engine.profile"]
    assert sorted(s.batch for s in prof) == [1, 2, 3, 4]
    assert {(s.call, s.thread, s.parent) for s in prof} == {(1, "main",
                                                             None)}
    to_host = {s.batch: s for s in log.spans
               if s.name == "engine.to_host" and s.call == 1}
    assert all(to_host[s.batch].t1 <= s.t0 for s in prof)
    sw, = [s for s in log.spans if s.name == "twopass.switch"]
    assert (sw.call, sw.thread, sw.parent) == (1, "main", None)
    pass1 = [s for s in log.spans if s.call == 1]
    pass2 = [s for s in log.spans if s.call == 2]
    assert max(s.t1 for s in pass1 if s is not sw) <= sw.t0
    assert sw.t1 <= min(s.t0 for s in pass2)
    totals: dict = {}
    for (c, _b, name), n in log.counters.items():
        if name.startswith("profile."):
            assert c == 1
            totals[name] = totals.get(name, 0) + n
    p = res["profile"]
    assert totals == {"profile.reads": p.n_reads,
                      "profile.gapped_rows": p.n_gapped}
    assert p.n_gapped > 0


def test_the_reference_loads_nothing_of_the_program(tmp_path, tw):
    """The mode's reference, judging a call from a tap made of plain
    data and as the control does with none, loads nothing of
    parasuite_tpu_torch, torch, jax or parasuite_tpu."""
    res = _two_pass(tw, "ref")
    p = res["profile"]
    body = b"\n".join(ln for ln in res[".pass1.sam"].split(b"\n")
                      if not ln.startswith(b"@"))
    np.savez(tmp_path / "tap.npz", pass1=np.frombuffer(body, np.uint8),
             counts=p.counts, ins=p.ins_counts, dels=p.del_counts,
             n_reads=p.n_reads, n_gapped=p.n_gapped,
             s=tw.engine.s_tensor)
    code = f"""
import json, sys
from types import SimpleNamespace
import numpy as np
sys.path[:0] = [{str(BENCH)!r}]
from harness import spec, world
mode = spec.mode("twopass")
conf = json.loads({json.dumps(json.dumps(tiny_config()))})
genome = world.make_genome(conf["genome"], {SEEDS[0]})
lib = world.make_library(json.loads(open({str(BENCH / 'traffic' /
                                            'parclip50.json')!r}).read()),
                         {N_READS}, genome, [], {SEEDS[0]})
z = np.load({str(tmp_path / 'tap.npz')!r})
tap = SimpleNamespace(pass1=[z["pass1"].tobytes()], learned_s=z["s"],
                      profile={{k: z[k] for k in ("counts", "ins", "dels",
                                                 "n_reads", "n_gapped")}})
idx = np.arange(0, {N_READS}, 64)
names = [world.read_name(int(i)) for i in idx]
for t in (tap, None):
    ref = mode.reference(genome, conf["align"], [], t)
    lines = ref.sam_lines(lib.codes[idx], lib.lengths[idx], names, lib.qual)
    assert len(lines) == len(idx)
    if t is not None:
        assert not any(ln.startswith(mode.MARK) for ln in lines)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not {"parasuite_tpu_torch", "torch", "jax", "jaxlib",
                "parasuite_tpu"} & mods
