"""Config-5 scale run of the port (BASELINE.json configs[4]; counterpart of
tools/scale_run.py): one end-to-end production run through the port's CLI in
subprocesses — simulate (binding-site mode) -> twopass (profile -> realign,
direct .bam out) -> coordinate sort (the C++ external sort) -> binding-site
clusters — with a SIGKILL in the middle of twopass, a `--resume`
continuation held byte-identical (BAM and .errorprofile) to an uninterrupted
control, per-stage wall clock and peak RSS, and a spot-check of the native
BAM cluster scan against the Python oracle on the first 1 M records.

The reference is the repeat-structured chr22-class 51 Mbp chromosome
(sim/genome.py); reads are simulated around PARASUITE_SCALE_SITES crosslink
sites, so the cluster stage emits a real cluster set.

The kill: a process on a card spends seconds starting and then aligns
hundreds of thousands of reads a second, so a kill after a fixed number of
seconds can land before the first checkpoint or after the end. By default
the drill watches the run's two checkpoint manifests (pass 1's and pass
2's) and kills once they show PARASUITE_SCALE_KILL_BATCHES batches done
together (default: half of pass 1). PARASUITE_SCALE_KILL_AFTER (seconds)
takes the original's rule instead. Either way the run fails loudly when the
killed process had already finished.

The external sort spills its runs to tmpfile() in the system temp
directory; the sort stage reports the peak bytes of those unlinked files
(`spill_bytes_peak`, read from /proc/<pid>/fd while it runs).

    python tools/torch_scale_run.py [--device cuda|cpu]

Defaults to 50 M reads. PARASUITE_SCALE_READS, PARASUITE_SCALE_REFSCALE,
PARASUITE_SCALE_SITES, PARASUITE_SCALE_SPOTCHECK (records the Python oracle
checks, default 1 M: ~60 s), PARASUITE_BENCH_BATCH and PARASUITE_SCALE_DIR
(default .scale_run_torch/) shrink and place the run. Prints one JSON line
per stage and the whole record as the last line (also written to
<dir>/SCALE_torch.json), with `gpu`.
"""

from __future__ import annotations

import json
import os
import resource
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_bench as tb

REPO = tb.REPO
N_READS = int(os.environ.get("PARASUITE_SCALE_READS", 50_000_000))
READ_LEN = 50
N_SITES = int(os.environ.get("PARASUITE_SCALE_SITES", 30_000))
SCALE = float(os.environ.get("PARASUITE_SCALE_REFSCALE", 1.0))
BATCH = int(os.environ.get("PARASUITE_BENCH_BATCH", 65536))
SIM_CHUNK = 2_000_000
WORK = Path(os.environ.get("PARASUITE_SCALE_DIR", REPO / ".scale_run_torch"))
KILL_AFTER = os.environ.get("PARASUITE_SCALE_KILL_AFTER")
N_BATCHES = -(-N_READS // BATCH)          # per pass
KILL_BATCHES = int(os.environ.get("PARASUITE_SCALE_KILL_BATCHES",
                                   max(1, N_BATCHES // 2)))
N_SPOTCHECK = int(os.environ.get("PARASUITE_SCALE_SPOTCHECK", 1_000_000))

CFG_FLAGS = ["--kmer-size", "12", "--max-read-len", str(READ_LEN),
             "--batch-size", str(BATCH), "--max-candidates", "8",
             "--max-occ", "16"]


def _batches_done(out_bam: Path) -> int:
    """Batches the run's checkpoints show, pass 1's and pass 2's together."""
    done = 0
    for manifest in (f"{out_bam}.pass1.sam.progress.json",
                     f"{out_bam}.progress.json"):
        try:
            done += int(json.loads(Path(manifest).read_text())
                        ["batches_done"])
        except (OSError, ValueError, KeyError):
            pass
    return done


def _spill_bytes(pid: int) -> int:
    """Bytes of the unlinked files the process holds open (tmpfile())."""
    total = 0
    fd_dir = f"/proc/{pid}/fd"
    try:
        for fd in os.listdir(fd_dir):
            path = os.path.join(fd_dir, fd)
            try:
                if os.readlink(path).endswith("(deleted)"):
                    total += os.stat(path).st_size
            except OSError:
                pass
    except OSError:
        pass
    return total


def run_stage(name, argv, stats, kill=None, cwd=None, watch_spill=False):
    """Run a CLI stage in a subprocess; record wall seconds + peak child
    RSS. kill=("seconds", s) sends SIGKILL after s seconds, kill=("batches",
    n, out_bam) once the checkpoints of out_bam show n batches done (the
    crash drill) -> whether the process was killed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (
        (":" + env["PYTHONPATH"]) if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    rss0 = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    p = subprocess.Popen([sys.executable, "-m", "parasuite_tpu_torch.cli"]
                         + argv, env=env, cwd=cwd or WORK,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    killed, spill, seen = False, 0, None
    try:
        if kill is not None and kill[0] == "seconds":
            try:
                p.wait(timeout=kill[1])
            except subprocess.TimeoutExpired:
                p.send_signal(signal.SIGKILL)
                killed = True
        elif kill is not None:
            while p.poll() is None:
                seen = _batches_done(kill[2])
                if seen >= kill[1]:
                    p.send_signal(signal.SIGKILL)
                    killed = True
                    break
                time.sleep(0.01)
        elif watch_spill:
            while p.poll() is None:
                spill = max(spill, _spill_bytes(p.pid))
                time.sleep(0.05)
        out, err = p.communicate()
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    dt = time.perf_counter() - t0
    rss1 = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    if not killed and p.returncode != 0:
        sys.stderr.write(err[-4000:])
        raise SystemExit(f"stage {name} failed rc={p.returncode}")
    rec = {"seconds": round(dt, 1),
           "peak_rss_mb": round(max(rss0, rss1) / 1024, 0)}
    if killed:
        rec["killed_after_s"] = round(dt, 2)
        rec["killed_by"] = kill[0]
        if kill[0] == "batches":
            rec["batches_done_at_kill"] = seen
            rec["batches_per_pass"] = N_BATCHES
    if watch_spill:
        rec["spill_bytes_peak"] = spill
        rec["spill_dir"] = os.environ.get("TMPDIR", "/tmp")
    if out.strip():
        try:
            rec["result"] = json.loads(out.strip().splitlines()[-1])
        except json.JSONDecodeError:
            pass
    stats[name] = rec
    print(json.dumps({name: rec}), flush=True)
    return killed


def make_sites(ref) -> np.ndarray:
    """Deterministic crosslink-site positions: N_SITES packed coordinates
    whose +-READ_LEN window is N-free (binding-site mode reads always cover
    their site; a site near an N gap would only make unmappable reads)."""
    rng = np.random.default_rng(404)
    seq = ref.seq
    ok = np.ones(seq.shape[0], dtype=bool)
    isn = seq == 4
    # a site at p needs [p - L, p + L] N-free; dilate the N mask by L
    W = READ_LEN
    bad = np.convolve(isn.astype(np.int8), np.ones(2 * W + 1, np.int8),
                      "same") > 0
    ok &= ~bad
    ok[:W] = False
    ok[-W:] = False
    cand = np.flatnonzero(ok)
    return np.sort(rng.choice(cand, size=N_SITES, replace=False))


def simulate_fastq(path, stats):
    """Chunked simulation with the decay-model quality strings. Binding-site
    mode: every read overlaps one of the N_SITES crosslink sites,
    conversions +-2 around it — the cluster stage's real workload."""
    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.index import PackedReference
    from parasuite_tpu_torch.sim.generate import (simulate_quality,
                                                  simulate_reads)

    cfg = AlignConfig(max_read_len=READ_LEN, kmer_size=12, batch_size=BATCH,
                      max_candidates=8, max_occ=16)
    ref = PackedReference.load(WORK / "idx")
    sites = make_sites(ref)
    stats["n_sites"] = int(sites.shape[0])
    t0 = time.perf_counter()
    with open(path, "wb") as out:
        done = 0
        chunk_i = 0
        while done < N_READS:
            n = min(SIM_CHUNK, N_READS - done)
            codes, _lengths, _truth = simulate_reads(
                ref, n, READ_LEN, cfg, seed=1000 + chunk_i, tc_rate=0.12,
                site_positions=sites)
            quals = simulate_quality(n, READ_LEN, seed=chunk_i)
            # fixed-width records, assembled as one array:
            # "@r<9 digits>\n<seq 50>\n+\n<qual 50>\n"
            L = READ_LEN
            R = 2 + 9 + 1 + L + 3 + L + 1
            rec = np.empty((n, R), dtype=np.uint8)
            rec[:, 0] = ord("@")
            rec[:, 1] = ord("r")
            idx = np.arange(done, done + n, dtype=np.int64)
            for p in range(9):
                rec[:, 2 + p] = (idx // 10 ** (8 - p)) % 10 + 48
            rec[:, 11] = 10
            base_lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
            rec[:, 12 : 12 + L] = base_lut[np.clip(codes, 0, 4)]
            rec[:, 12 + L] = 10
            rec[:, 13 + L] = ord("+")
            rec[:, 14 + L] = 10
            rec[:, 15 + L : 15 + 2 * L] = quals
            rec[:, 15 + 2 * L] = 10
            out.write(rec.tobytes())
            done += n
            chunk_i += 1
            print(json.dumps({"simulate_progress": done}), flush=True)
    dt = time.perf_counter() - t0
    stats["simulate"] = {
        "seconds": round(dt, 1), "reads": N_READS,
        "peak_rss_mb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 0)}
    print(json.dumps({"simulate": stats["simulate"]}), flush=True)


def _files_equal(a: Path, b: Path, chunk: int = 64 << 20) -> bool:
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            ca = fa.read(chunk)
            cb = fb.read(chunk)
            if ca != cb:
                return False
            if not ca:
                return True


def cluster_parity_spotcheck(sorted_bam, stats, n_check=N_SPOTCHECK):
    """Native BAM cluster-scan columns vs the Python oracle on the first
    n_check records of the sorted BAM."""
    from parasuite_tpu_torch import native
    from parasuite_tpu_torch.cli import cluster_columns_python
    from parasuite_tpu_torch.index import PackedReference
    from parasuite_tpu_torch.io.bam import (decode_bam_record,
                                            iter_bam_records)

    ref = PackedReference.load(WORK / "idx")
    t0 = time.perf_counter()
    pos_n, span_n, tc_n, _sk = native.bam_cluster_columns(sorted_bam, ref)
    text, names, _lens, recs = iter_bam_records(sorted_bam)
    tmp_sam = WORK / "spotcheck.sam"
    n_written = 0
    with open(tmp_sam, "w") as out:
        out.write(text)
        for body in recs:
            out.write(decode_bam_record(body, names) + "\n")
            n_written += 1
            if n_written >= n_check:
                break
    pos_p, span_p, tc_p = cluster_columns_python(tmp_sam, ref)
    tmp_sam.unlink()
    m = pos_p.shape[0]  # oracle skips unmapped; native columns align 1:1
    same = (np.array_equal(pos_n[:m], pos_p)
            and np.array_equal(span_n[:m], span_p)
            and np.array_equal(tc_n[:m], tc_p))
    stats["cluster_spotcheck"] = {
        "records_checked": int(m), "parity": bool(same),
        "seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps({"cluster_spotcheck": stats["cluster_spotcheck"]}),
          flush=True)
    if not same:
        raise SystemExit("cluster column spot-check FAILED")


def main(argv=None) -> int:
    device, _ = tb.device_arg(argv, __doc__.split("\n\n")[0])
    WORK.mkdir(exist_ok=True)
    stats: dict = {"n_reads": N_READS, "batch": BATCH, "device": device,
                   "world": "chr22_class_repeat_structured",
                   "gpu": tb.gpu_line(device)}

    # reference + index: repeat-structured chr22-class chromosome
    fa = WORK / "ref.fa"
    if not (WORK / "idx.ref.json").exists():
        from parasuite_tpu_torch.io.fasta import write_fasta
        from parasuite_tpu_torch.sim.genome import chr22_like

        seqs, gstats = chr22_like(scale=SCALE)
        stats["repeat_fraction"] = round(gstats.repeat_fraction, 4)
        write_fasta(fa, seqs)
        run_stage("index", ["index", str(fa), str(WORK / "idx")] + CFG_FLAGS,
                  stats)

    fq = WORK / "reads.fastq"
    if not fq.exists() or fq.stat().st_size < N_READS * 100:
        simulate_fastq(fq, stats)

    # --- control twopass (uninterrupted) ---
    # identical RELATIVE argv per run (only --resume differs on the
    # continuation, and a resumed run never rewrites the header) so the
    # @PG CL: header line cannot differ between control and drill
    cdir = WORK / "ctrl"
    rdir = WORK / "run"
    for d in (cdir, rdir):
        d.mkdir(exist_ok=True)
        for f in d.glob("out.bam*"):
            f.unlink()
    argv = (["twopass", "../idx", "../reads.fastq", "out.bam",
             "--pg-cl", "scale_torch", "--device", device] + CFG_FLAGS)
    run_stage("twopass_control", argv, stats, cwd=cdir)
    ctrl = cdir / "out.bam"

    # --- crash drill: kill mid-run, then --resume; bytes must match ---
    out = rdir / "out.bam"
    kill = (("seconds", float(KILL_AFTER)) if KILL_AFTER is not None
            else ("batches", KILL_BATCHES, out))
    killed = run_stage("twopass_killed", argv, stats, kill=kill, cwd=rdir)
    if not killed:
        raise SystemExit("kill drill did not trigger: the run had finished "
                         "before the kill — lower "
                         "PARASUITE_SCALE_KILL_BATCHES (or "
                         "PARASUITE_SCALE_KILL_AFTER)")
    if kill[0] == "batches" and \
            stats["twopass_killed"]["batches_done_at_kill"] >= 2 * N_BATCHES:
        raise SystemExit("kill drill landed after the last batch")
    run_stage("twopass_resumed", argv + ["--resume"], stats, cwd=rdir)
    same_bam = _files_equal(out, ctrl)
    same_prof = ((Path(str(out) + ".errorprofile").read_bytes())
                 == Path(str(ctrl) + ".errorprofile").read_bytes())
    stats["resume_byte_identical"] = bool(same_bam and same_prof)
    print(json.dumps({"resume_byte_identical": stats["resume_byte_identical"],
                      "bam": same_bam, "profile": same_prof}), flush=True)

    # --- sort (external merge) + cluster (BGZF scan, no temp SAM) ---
    sortd = WORK / "sorted.bam"
    run_stage("sort", ["sort", str(out), str(sortd), "--min-mapq", "1"],
              stats, watch_spill=True)
    run_stage("cluster", ["cluster", str(WORK / "idx"), str(sortd),
                          str(WORK / "clusters.tsv")] + CFG_FLAGS
              + ["--cluster-min-reads", "2"], stats)
    cluster_parity_spotcheck(sortd, stats)

    stats["artifacts_bytes"] = {
        "fastq": fq.stat().st_size, "bam": out.stat().st_size,
        "sorted_bam": sortd.stat().st_size,
        "clusters_tsv": (WORK / "clusters.tsv").stat().st_size}
    e2e = (stats["twopass_control"]["seconds"] + stats["sort"]["seconds"]
           + stats["cluster"]["seconds"])
    stats["pipeline_seconds_ex_sim"] = round(e2e, 1)
    stats["pipeline_reads_per_s"] = round(N_READS / e2e, 0)
    (WORK / "SCALE_torch.json").write_text(json.dumps(stats, indent=2))
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
