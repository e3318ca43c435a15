"""The port's measurement scripts (tools/torch_*.py, tools/_torch_bench.py)
against the JAX package's (bench.py, tools/*.py) on the CPU, at tiny sizes,
and the repairs that landed with them. The same seeded worlds go through
both sides; every compared value is an integer count or a fraction of
integer counts rounded the same way, so every tolerance is 0. Rates and
times are never compared: a CPU's say nothing about the card.

Where the JAX side reaches a Pallas kernel it runs as tests/test_pallas.py
runs it on the CPU: AlignConfig's extend_impl / select_impl at "auto" take
the jnp reference there."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import bench                                    # noqa: E402
import bench_genome as j_genome                 # noqa: E402
import bench_rescue as j_rescue                 # noqa: E402
import _torch_bench as tb                       # noqa: E402
import torch_bench_genome as t_genome           # noqa: E402
import torch_bench_rescue as t_rescue           # noqa: E402
import torch_profile_e2e as t_profile           # noqa: E402
import torch_sweep_lengths as t_lengths         # noqa: E402
import torch_sweep_seeds as t_seeds             # noqa: E402
import torch_sweep_twopass as t_twopass         # noqa: E402

from _torch_helpers import to_port              # noqa: E402

torch.set_num_threads(1)

REF_LEN = 200_000
BATCH = 1024
N = 2048


@pytest.fixture(scope="module")
def j_base():
    """bench.make_cfg() at a CPU-sized batch."""
    return dataclasses.replace(bench.make_cfg(), batch_size=BATCH)


@pytest.fixture
def one_round(monkeypatch):
    monkeypatch.setattr(bench, "TIMED_ROUNDS", 1)
    monkeypatch.setattr(tb, "TIMED_ROUNDS", 1)


def _j_world(cfg, n, read_len=50, seed=2):
    from parasuite_tpu.sim import simulate_reads

    state = bench.build_state(cfg, REF_LEN)
    codes, lengths, truth = simulate_reads(state[0], n, read_len, cfg,
                                           seed=seed, tc_rate=0.12)
    return state, np.asarray(codes), np.asarray(lengths), truth


def test_run_throughput_accuracy_equals_bench(j_base, one_round):
    _best, want, j_rates = bench.run_throughput(
        j_base, N, BATCH, REF_LEN, check_accuracy=True)
    best, got, rates = tb.run_throughput(
        to_port(j_base), N, BATCH, REF_LEN, check_accuracy=True,
        device="cpu", rounds=1)
    assert got == want                       # tolerance 0
    assert want["n_unmapped"] + want["n_mismapped"] < N // 10
    assert len(rates) == len(j_rates) == 1 and best == max(rates)
    assert tb.spread_of([2.0, 3.0, 4.0]) == 1.0
    assert tb.make_cfg().to_json() == bench.make_cfg().to_json()


def test_run_end_to_end_streams_every_read(j_base, tmp_path):
    """The FASTQ -> SAM leg: one warm-up and `rounds` timed runs of
    streaming_align on simulate_reads(seed=3); best, median and the list
    they were taken from."""
    cfg = to_port(j_base)
    state = tb.build_state(cfg, REF_LEN, device="cpu")
    best, median, rates = tb.run_end_to_end(cfg, state, N, tmp_path,
                                            rounds=2)
    assert len(rates) == 2 and best == max(rates)
    assert min(rates) <= median <= best
    assert (tmp_path / "bench_e2e.fastq").read_bytes().count(b"\n") == 4 * N
    assert not (tmp_path / "bench_e2e.sam").exists()     # cleaned up


def test_census_equals_bench_genome(j_base):
    (j_ref, j_index, _d, _s), _codes, lengths, truth = _j_world(j_base, N,
                                                                seed=5)
    cfg, ref, index = to_port(j_base), to_port(j_ref), to_port(j_index)
    for max_occ in (16, 2):
        jc = j_base.replace(max_occ=max_occ)
        tc = cfg.replace(max_occ=max_occ)
        assert t_genome.index_census(index, tc) == \
            j_genome.index_census(j_index, jc)
        assert t_genome.seed_drop_census(ref, index, truth, lengths, tc) == \
            j_genome.seed_drop_census(j_ref, j_index, truth, lengths, jc)
    assert t_genome.index_census(index, cfg)["kmers_total"] > REF_LEN // 2


def test_genome_world_record_equals_bench_genome(j_base, one_round):
    """run_world on a shrunk chr22-class chromosome: every field the two
    tools share that is no rate, time or device size is equal."""
    from parasuite_tpu.index import PackedReference
    from parasuite_tpu.sim.genome import chr22_like

    seqs, stats = chr22_like(scale=0.004)
    want = j_genome.run_world("w", seqs, stats, j_base, N, with_e2e=False)
    cfg = to_port(j_base)
    ref = to_port(PackedReference.from_dict(seqs, spacer=cfg.chrom_spacer))
    got = t_genome.run_world("w", ref, stats, cfg, N, False, "cpu")
    skip = {"index_build_seconds", "device_reads_per_s", "device_rounds",
            "packed_words_live_bytes", "device_bytes_in_use",
            "device_peak_bytes"}
    shared = sorted((set(want) & set(got)) - skip)
    assert len(shared) >= 25 and "sensitivity_unique" in shared
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert "packed_words_live_bytes" not in got
    assert got["select_row_width"] == 112


@pytest.mark.parametrize("L", t_lengths.LENGTHS)
def test_sweep_lengths_equals_jax_tool(L, j_base, one_round):
    """Both placements at one length: the JAX tool's loop body (tools/
    sweep_lengths.py main) on a 200 kbp reference against the port's
    sweep_line; every field but the rate is equal, and the fixed placement
    refuses the same lengths with the same message. Past 50 bp the fixed
    placement, which the configs of both packages accept there, is not run
    a second time: it differs from the 50 bp run in nothing but L."""
    base = to_port(j_base)
    for placement in ("adaptive", "fixed"):
        if placement == "fixed" and L > 50:
            for cfg in (j_base, base):
                assert dataclasses.replace(
                    cfg, max_read_len=L, seed_placement="fixed"
                ).seed_stride_for(L) == 6
            continue
        got = t_lengths.sweep_line(base, placement, L, N, REF_LEN, "cpu")
        try:
            cfg = dataclasses.replace(j_base, max_read_len=L,
                                      seed_placement=placement)
        except ValueError as e:
            assert got == {"placement": placement, "read_len": L,
                           "error": str(e)}
            assert (placement, L) == ("fixed", 36)
            continue
        _rps, extras, _r = bench.run_throughput(
            cfg, N, BATCH, REF_LEN, check_accuracy=True,
            state=bench.build_state(cfg, REF_LEN), read_len=L)
        rate = got.pop("reads_per_s")
        assert rate > 0
        assert got == {"placement": placement, "read_len": L,
                       "stride_eff": cfg.seed_stride_for(L), **extras}


def test_sweep_seeds_and_twopass_lines(j_base, one_round):
    """One grid point of each operating-point sweep against the JAX
    package's counts on the same reads."""
    import functools

    import jax

    from parasuite_tpu.benchkit import evaluate_against_truth
    from parasuite_tpu.errormodel.infer import (ErrorProfile,
                                                counts_to_profile)
    from parasuite_tpu.ops.aligner import align_batch_packed, \
        min_score_table, pack_codes_host, unpack_result_host
    from parasuite_tpu.ops.device_index import ScoreParams

    base = to_port(j_base)
    ms, stride = t_seeds.GRID[0]
    cfg = dataclasses.replace(j_base, max_seeds=ms, seed_stride=stride)
    _rps, extras, _r = bench.run_throughput(
        cfg, N, BATCH, REF_LEN, check_accuracy=True,
        state=bench.build_state(cfg, REF_LEN))
    got = t_seeds.sweep_line(base, ms, stride, N, REF_LEN, "cpu")
    got.pop("reads_per_s")
    assert got == {"max_seeds": ms, "stride": stride, **extras}

    # tools/sweep_twopass.py's loop body at its k = 11 grid point
    k, ms, stride = t_twopass.GRID[1]
    cfg = dataclasses.replace(j_base, kmer_size=k, max_seeds=ms,
                              seed_stride=stride)
    (ref, _i, didx, sprof), codes, lengths, truth = _j_world(cfg, N)
    l16 = lengths.astype(np.uint16)
    table = jax.device_put(min_score_table(cfg))
    fn = jax.jit(functools.partial(align_batch_packed, cfg=cfg),
                 static_argnames=("with_counts",))

    def run_pass(sp, with_counts):
        outs, csum = [], None
        for i in range(0, N, BATCH):
            two, nm = pack_codes_host(codes[i:i + BATCH])
            o = fn(didx, sp, two, nm, l16[i:i + BATCH], table,
                   with_counts=with_counts)
            if with_counts:
                o, c = o
                csum = c if csum is None else csum + c
            outs.append(unpack_result_host(jax.device_get(o),
                                           cfg.band_width))
        cat = lambda f: np.concatenate([np.asarray(getattr(r, f))
                                        for r in outs])
        return (evaluate_against_truth(truth, cat("mapped"), cat("strand"),
                                       cat("pos")),
                None if csum is None else np.asarray(csum),
                int(cat("mapped").sum()))

    rep1, counts, n_prof = run_pass(sprof, True)
    learned = ScoreParams.from_tensor(counts_to_profile(
        ErrorProfile(counts=counts.astype(np.int64), n_reads=n_prof), cfg),
        cfg)
    rep2, _c, _n = run_pass(learned, False)
    assert t_twopass.sweep_line(base, k, ms, stride, N, REF_LEN, "cpu") == {
        "kmer_size": k, "max_seeds": ms, "stride": stride,
        "pass1_sensitivity": round(rep1.sensitivity, 4),
        "pass1_unmapped": rep1.n_reads - rep1.n_mapped,
        "pass1_mismapped": rep1.n_mapped - rep1.n_correct,
        "pass2_sensitivity": round(rep2.sensitivity, 4),
        "pass2_unmapped": rep2.n_reads - rep2.n_mapped,
        "pass2_mismapped": rep2.n_mapped - rep2.n_correct,
        "precision2": round(rep2.precision, 4)}


def test_rescue_accuracy_equals_jax_engine(j_base):
    """36 bp, rescue_kmer 10, 2,048 reads: the three fractions of the JAX
    engine (tools/bench_rescue.py engine_accuracy), and its counters."""
    from parasuite_tpu.pipeline.align import AlignerEngine as JEngine
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    cfg = j_base.replace(max_read_len=36, rescue_kmer=10)
    (ref, index, _d, _s), codes, lengths, truth = _j_world(cfg, N, 36)
    j_eng = JEngine(ref, index, cfg)
    want, n = j_rescue.engine_accuracy(j_eng, codes, lengths, truth)
    eng = AlignerEngine(to_port(ref), to_port(index), to_port(cfg),
                        device="cpu")
    got, n_got = t_rescue.engine_accuracy(eng, codes, lengths, truth)
    assert (got, n_got) == (want, n) and n == N
    assert (eng.rescue_mapped, eng.rescue_overflow) == \
        (j_eng.rescue_mapped, j_eng.rescue_overflow)
    assert eng.rescue_mapped > 0


@pytest.mark.parametrize("mode", ["plain", "xa", "rescue"])
def test_profile_e2e_times_without_changing_the_output(mode, j_base,
                                                       tmp_path):
    """4,096 reads through streaming_align with its spans recorded: every
    record there, every named span present and non-negative, the self
    times of one thread within the wall, the bytes counted, nothing of the
    program patched, and the SAM byte-identical to an unrecorded run."""
    import parasuite_tpu_torch.pipeline.align as palign
    import parasuite_tpu_torch.pipeline.stream as pstream
    from parasuite_tpu_torch.io.fastq import write_fastq
    from parasuite_tpu_torch.pipeline.align import AlignerEngine
    from parasuite_tpu_torch.sim.generate import simulate_reads

    n = 4096 if mode == "plain" else 2048    # XA's host path is slow
    cfg = to_port(j_base).replace(rescue_kmer=10 if mode == "rescue" else 0)
    ref, index, _e = tb.build_state(cfg, REF_LEN, device="cpu")
    engine = AlignerEngine(ref, index, cfg, xa_tags=mode == "xa",
                           device="cpu")
    codes, lengths, _ = simulate_reads(ref, n, 50, cfg, seed=3, tc_rate=0.12,
                                       del_rate=0.02)
    write_fastq(tmp_path / "r.fastq", [f"r{i}" for i in range(n)],
                np.asarray(codes), np.asarray(lengths))
    before = (pstream.iter_fastq_batches, palign.fetch_host,
              palign.orient_rows, palign.host_tracebacks_batch,
              palign.tc_count_from_cigar)
    rec = t_profile.profile_stream(engine, tmp_path / "r.fastq",
                                   tmp_path / "probed.sam", rounds=1)
    assert before == (pstream.iter_fastq_batches, palign.fetch_host,
                      palign.orient_rows, palign.host_tracebacks_batch,
                      palign.tc_count_from_cigar)
    assert "to_host" not in vars(engine) and "_upload" not in vars(engine)
    assert rec["reads"] == n and rec["batches"] == n // BATCH
    assert rec["device_busy_ms"] is None and rec["device_busy_share"] is None
    timers = rec["timers"]
    named = {"reader.parse", "reader.wait", "main.wait_reads",
             "step.dispatch", "step.pack", "step.upload", "step.replay",
             "engine.to_host", "engine.fetch", "engine.tracebacks",
             "engine.tracebacks.native", "engine.rows", "main.wait_writer",
             "writer.wait", "writer.emit", "writer.commit"}
    if mode == "xa":
        named |= {"engine.xa"}
        named -= {"step.pack"}                  # the unpacked step
    if mode == "rescue":
        named |= {"engine.rescue"}
    assert named <= set(timers)
    for name, t in timers.items():
        assert t["seconds"] >= t["self_seconds"] >= 0, name
    threads = {"reader.": "reader", "main.": "main", "step.": "main",
               "engine.": "main", "writer.": "writer"}
    for thread in ("reader", "main", "writer"):
        own = sum(t["self_seconds"] for k, t in timers.items()
                  if threads[k.split(".")[0] + "."] == thread)
        assert 0 < own <= rec["wall_seconds"], thread
    assert timers["engine.tracebacks"]["calls"] >= 1
    assert timers["engine.rows"]["calls"] >= 1
    assert timers["writer.emit"]["calls"] == n // BATCH
    assert rec["counters"]["reads"] == n
    # what one batch moves. The wire step (plain, rescue): 2-bit codes,
    # N mask and uint16 lengths up (13 + 7 + 2 B/read at L = 50), the
    # 13 B/read PackedResult down, more with a rescue step. With XA the
    # unpacked step: int8 codes + int32 lengths up, the AlignResult (10
    # int32 and 2 bool fields) and the candidate table (2C = 16 entries of
    # 4 int32 and 2 bool fields) down
    if mode == "xa":
        assert rec["bytes_up_per_batch"] == BATCH * (50 + 4)
        assert rec["bytes_down_per_batch"] == BATCH * (42 + 16 * 18)
    else:
        assert rec["bytes_up_per_batch"] >= BATCH * (13 + 7 + 2)
        assert rec["bytes_down_per_batch"] >= BATCH * 13
    if mode == "plain":
        assert rec["bytes_up_per_batch"] == BATCH * (13 + 7 + 2)
        assert rec["bytes_down_per_batch"] == BATCH * 13
        assert rec["uploads"] == rec["fetches"] == n // BATCH

    fresh = AlignerEngine(ref, index, cfg, xa_tags=mode == "xa",
                          device="cpu")
    n_rec, _c, _p = pstream.streaming_align(fresh, tmp_path / "r.fastq",
                                            tmp_path / "plain.sam")
    assert n_rec == n
    assert (tmp_path / "probed.sam").read_bytes() == \
        (tmp_path / "plain.sam").read_bytes()


def test_scale_run_kill_and_resume(tmp_path):
    """torch_scale_run.py at 20,000 reads on a shrunk reference, on the
    CPU: the kill lands mid-run, the resumed BAM and .errorprofile equal
    the control's bytes, the native cluster scan equals the Python oracle,
    and the run calls more than one cluster."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PARASUITE_SCALE_READS="20000", PARASUITE_SCALE_REFSCALE="0.01",
               PARASUITE_SCALE_SITES="300", PARASUITE_BENCH_BATCH="2048",
               PARASUITE_SCALE_DIR=str(tmp_path / "scale"),
               OMP_NUM_THREADS="2")
    env.pop("PARASUITE_SCALE_KILL_AFTER", None)
    p = subprocess.run([sys.executable,
                        str(REPO / "tools" / "torch_scale_run.py"),
                        "--device", "cpu"], env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    stats = json.loads(p.stdout.strip().splitlines()[-1])
    killed = stats["twopass_killed"]
    assert killed["killed_by"] == "batches"
    assert 0 < killed["batches_done_at_kill"] < 2 * killed["batches_per_pass"]
    assert stats["resume_byte_identical"] is True
    assert stats["twopass_resumed"]["result"]["reads"] == 20000
    assert stats["cluster"]["result"]["clusters"] > 1
    assert stats["cluster_spotcheck"]["parity"] is True
    assert stats["sort"]["spill_bytes_peak"] >= 0
    assert stats["gpu"] == "cpu" and stats["device"] == "cpu"
    assert json.loads((tmp_path / "scale" / "SCALE_torch.json").read_text()) \
        == stats


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seeds,max_occ", [(17, 64), (30, 128)])
def test_wide_rows_give_the_jax_candidates(seeds, max_occ, tiny_ref):
    """Rows wider than 1,024 diagonals (1,088 and 3,840: the select
    kernel's shared-memory widths on a card): seeding and selection equal
    the JAX package's jnp functions, and the engine takes the config."""
    from parasuite_tpu.config import AlignConfig as JConfig
    from parasuite_tpu.index import KmerIndex as JIndex
    from parasuite_tpu.index import PackedReference as JRef
    from parasuite_tpu.ops import aligner as jx
    from parasuite_tpu.ops.device_index import DeviceIndex as JDeviceIndex
    from parasuite_tpu_torch.ops import aligner as tx
    from parasuite_tpu_torch.ops import cuda_seed
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    from conftest import sample_reads

    cfg = JConfig(max_read_len=100, batch_size=32, kmer_size=6,
                  max_seeds=seeds, max_occ=max_occ, max_candidates=16,
                  chrom_spacer=128)
    ref = JRef.from_dict({n: tiny_ref.seq[tiny_ref.starts[i]:tiny_ref.ends[i]]
                          for i, n in enumerate(tiny_ref.names)}, spacer=128)
    index = JIndex.build(ref.seq, cfg.kmer_size)
    codes, lengths, _ = sample_reads(np.random.default_rng(77), ref, 32, 100,
                                     mutate=3, indel=True)
    j_diags = jx.seed_diagonals(jx.orient_reads(codes, lengths), lengths,
                                JDeviceIndex.from_host(ref, index), cfg)
    j_cand, j_valid = jx.select_candidates(j_diags, cfg)

    t_cfg = to_port(cfg)
    assert cuda_seed.row_width(t_cfg) == seeds * max_occ > 1024
    engine = AlignerEngine(to_port(ref), to_port(index), t_cfg, device="cpu")
    tc, tl = engine._upload(codes, lengths)
    diags = tx.seed_diagonals(tx.orient_reads(tc, tl), tl, engine.didx, t_cfg)
    np.testing.assert_array_equal(diags.numpy(), np.asarray(j_diags))
    cand, valid = cuda_seed.select_candidates(diags, t_cfg)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(j_cand))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    # k = 6 on 8 kbp: buckets of a few positions, so rows hold more valid
    # diagonals than the C = 16 that are kept
    assert int((diags != cuda_seed.I32MAX).sum(dim=1).max()) > 32
    assert bool(valid.any())


@pytest.mark.parametrize("kw,flags", [
    (dict(max_seeds=65, max_occ=64), ("--max-seeds", "--max-occ", "4160")),
    (dict(max_seeds=7, max_occ=512, kmer_size=8, rescue_kmer=6,
          rescue_seeds=13),
     ("--rescue-seeds", "--max-occ", "6656"))])
def test_engine_refuses_rows_past_the_kernel(kw, flags, tiny_ref, tiny_index,
                                             small_cfg):
    """Past 4,096 diagonals a row the engine refuses when it is built,
    naming the flags and the width, before any index is uploaded."""
    from parasuite_tpu_torch.ops import cuda_seed
    from parasuite_tpu_torch.ops.device_index import DeviceIndex
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    cfg = to_port(small_cfg).replace(**kw)
    uploads = []
    orig = DeviceIndex.from_host
    DeviceIndex.from_host = classmethod(
        lambda cls, *a, **k: uploads.append(a) or orig(*a, **k))
    try:
        with pytest.raises(ValueError) as err:
            AlignerEngine(to_port(tiny_ref), to_port(tiny_index), cfg,
                          device="cpu")
    finally:
        DeviceIndex.from_host = orig
    assert uploads == []
    for word in flags:
        assert word in str(err.value)
    assert str(cuda_seed.MAX_PAD) in str(err.value)
    # at the limit it is taken
    ok = to_port(small_cfg).replace(max_seeds=64, max_occ=64)
    assert cuda_seed.row_width(ok) == cuda_seed.MAX_PAD
    cuda_seed.check_row_width(ok)


def test_engine_refuses_more_entries_than_the_finalize_kernel(
        tiny_ref, tiny_index, small_cfg):
    """Past 256 candidate entries a read (max_candidates 129) the engine
    refuses when it is built, naming the flag and the kernel's limit; at
    128 candidates it is taken."""
    from parasuite_tpu_torch.ops import cuda_finalize
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    cfg = to_port(small_cfg).replace(max_candidates=129)
    with pytest.raises(ValueError, match="--max-candidates 129 gives 258") \
            as err:
        AlignerEngine(to_port(tiny_ref), to_port(tiny_index), cfg,
                      device="cpu")
    assert str(cuda_finalize.MAX_ENTRIES) in str(err.value)
    cuda_finalize.check_entry_width(cfg.replace(max_candidates=128))


def test_two_processes_build_the_native_library_together(tmp_path):
    """Two processes started together on a copy of native/ with no built
    library both end with available() true: each builds under a name of its
    own and renames the result into place."""
    import shutil

    src = REPO / "parasuite_tpu_torch" / "native"
    pkg = tmp_path / "nativecopy"
    pkg.mkdir()
    for name in ("__init__.py", "Makefile", "parasuite_native.cpp"):
        shutil.copy(src / name, pkg / name)
    code = ("import sys, nativecopy\n"
            "ok = nativecopy.available()\n"
            "print(ok, nativecopy._LIB_PATH.exists())\n"
            "sys.exit(0 if ok else 1)\n")
    env = {**os.environ, "PYTHONPATH": str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.split() == ["True", "True"], err
        assert err == ""                     # nothing went wrong, no word
    assert sorted(f.name for f in pkg.glob("*.so")) == \
        ["libparasuite_native.so"]


def test_failed_native_build_is_loud_once(tmp_path):
    """A build that fails says so once on stderr, and the numpy paths take
    over (available() false, no exception)."""
    import shutil

    src = REPO / "parasuite_tpu_torch" / "native"
    pkg = tmp_path / "brokencopy"
    pkg.mkdir()
    shutil.copy(src / "__init__.py", pkg / "__init__.py")
    shutil.copy(src / "Makefile", pkg / "Makefile")
    (pkg / "parasuite_native.cpp").write_text("this is not C++\n")
    code = ("import brokencopy\n"
            "print(brokencopy.available(), brokencopy.available())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env={**os.environ, "PYTHONPATH": str(tmp_path)},
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split() == ["False", "False"]
    assert p.stderr.count("taking the numpy paths") == 1
    assert list(pkg.glob("*.so")) == []


def test_pyproject_requires_neither_framework():
    import tomllib

    proj = tomllib.loads((REPO / "pyproject.toml").read_text())
    assert proj["project"]["dependencies"] == ["numpy"]
    assert proj["project"]["optional-dependencies"] == {"jax": ["jax"],
                                                        "torch": ["torch"]}
    found = proj["tool"]["setuptools"]["packages"]["find"]["include"]
    assert "parasuite_tpu_torch" in found and "parasuite_tpu" in found
    data = proj["tool"]["setuptools"]["package-data"]["parasuite_tpu_torch"]
    assert "csrc/*.cu" in data and any(d.startswith("native/") for d in data)
