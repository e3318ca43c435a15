"""The port never imports jax nor anything of parasuite_tpu: whole index +
twopass, combine + twopass + align --xa --rescue-kmer, simulate /
benchmark / cluster / sort / convert plus a combined align on the projected
step, and the multi-device layer (dist-align in both modes, merge-shards,
benchmark --scaling, the entry points), and the port's benchmark and its
distributed and sharded-scale tools leave both out of sys.modules, and no
source file of the port (nor chip_smoke.py, nor the card tests, nor
bench_torch.py, nor the measurement scripts tools/torch_*.py and
tools/_torch_bench.py, nor the benchmark's files) imports either."""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
# the end of every subprocess run: neither jax nor the JAX package came in
ALONE = (
    "foreign = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'parasuite_tpu'))\n"
    "assert not foreign, f'imported {foreign[:5]}'\n")


def test_index_and_twopass_run_without_jax(tmp_path, tiny_ref):
    from parasuite_tpu.io.fasta import write_fasta
    from parasuite_tpu.io.fastq import write_fastq

    from conftest import sample_reads

    write_fasta(tmp_path / "ref.fa",
                {name: tiny_ref.seq[tiny_ref.starts[i]:tiny_ref.ends[i]]
                 for i, name in enumerate(tiny_ref.names)})
    rng = np.random.default_rng(5)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 40, 50, mutate=1,
                                     indel=True)
    write_fastq(tmp_path / "r.fastq", [f"q{i}" for i in range(40)], codes,
                lengths)
    flags = ["--max-read-len", "50", "--kmer-size", "8", "--band-width", "3",
             "--batch-size", "16"]
    code = (
        "import sys\n"
        "from parasuite_tpu_torch.cli import main\n"
        f"flags = {flags!r}\n"
        "assert main(['index', 'ref.fa', 'idx', *flags]) == 0\n"
        "assert main(['twopass', 'idx', 'r.fastq', 'out.sam', "
        "'--learned-gaps', '--device', 'cpu', *flags]) == 0\n"
        f"{ALONE}"
        "print('no-jax-ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO)
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "no-jax-ok"
    sam = (tmp_path / "out.sam").read_text().splitlines()
    assert sum(1 for line in sam if not line.startswith("@")) == 40


def test_combine_twopass_xa_rescue_run_without_jax(tmp_path, tiny_ref):
    """combine -> twopass --learned-gaps on the combined index, and index ->
    align --xa --rescue-kmer on the genome: no jax in sys.modules, and the
    combined SAM carries junction (N) CIGARs."""
    from parasuite_tpu.io.fasta import write_fasta
    from parasuite_tpu.io.fastq import write_fastq
    from parasuite_tpu.utils.dna import revcomp_codes

    from conftest import sample_reads

    genome = {name: tiny_ref.seq[tiny_ref.starts[i]:tiny_ref.ends[i]]
              for i, name in enumerate(tiny_ref.names)}
    write_fasta(tmp_path / "ref.fa", genome)
    (tmp_path / "exons.tsv").write_text(
        "t1\tchrA\t+\t2000,2600\t2200,2800\n"
        "t2\tchrB\t-\t500,1500\t700,1700\n")
    rng = np.random.default_rng(6)
    codes, lengths, _ = sample_reads(rng, tiny_ref, 40, 50, mutate=1,
                                     indel=True)
    junction = np.concatenate([genome["chrA"][2175:2200],
                               genome["chrA"][2600:2625]])
    codes[:4] = [junction, revcomp_codes(junction), junction, junction]
    codes[4:12, 36:] = 4
    lengths[4:12] = 36
    write_fastq(tmp_path / "r.fastq", [f"q{i}" for i in range(40)], codes,
                lengths)
    flags = ["--max-read-len", "50", "--kmer-size", "8", "--band-width", "3",
             "--batch-size", "16"]
    code = (
        "import sys\n"
        "from parasuite_tpu_torch.cli import main\n"
        f"flags = {flags!r}\n"
        "assert main(['combine', 'ref.fa', 'exons.tsv', 'cidx', *flags]) == 0\n"
        "assert main(['twopass', 'cidx', 'r.fastq', 'c.sam', "
        "'--learned-gaps', '--device', 'cpu', *flags]) == 0\n"
        "assert main(['index', 'ref.fa', 'idx', *flags]) == 0\n"
        "assert main(['align', 'idx', 'r.fastq', 'x.sam', '--xa', "
        "'--rescue-kmer', '6', '--device', 'cpu', *flags]) == 0\n"
        f"{ALONE}"
        "print('no-jax-ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO)
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "no-jax-ok"
    recs = {sam: [line.split("\t") for line in
                  (tmp_path / sam).read_text().splitlines()
                  if not line.startswith("@")] for sam in ("c.sam", "x.sam")}
    assert len(recs["c.sam"]) == len(recs["x.sam"]) == 40
    assert recs["c.sam"][0][5] == "25M400N25M"


def test_host_tools_and_projected_combined_run_without_jax(tmp_path,
                                                           tiny_ref):
    """simulate (flat, --profile --learned-indels, on a combined index),
    benchmark --device cpu, cluster on SAM and BAM, sort and convert, and a
    combined align through the projected step (its counters in the JSON
    line): no jax in sys.modules."""
    from parasuite_tpu.io.fasta import write_fasta

    write_fasta(tmp_path / "ref.fa",
                {name: tiny_ref.seq[tiny_ref.starts[i]:tiny_ref.ends[i]]
                 for i, name in enumerate(tiny_ref.names)})
    (tmp_path / "exons.tsv").write_text(
        "t1\tchrA\t+\t2000,2600\t2200,2800\n")
    flags = ["--max-read-len", "50", "--kmer-size", "8", "--band-width", "3",
             "--batch-size", "32"]
    code = (
        "import contextlib, io, json, sys\n"
        "from parasuite_tpu_torch.cli import main\n"
        f"flags = {flags!r}\n"
        "def run(*argv):\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        assert main(list(argv)) == 0, argv\n"
        "    return json.loads(buf.getvalue().strip().splitlines()[-1])\n"
        "run('index', 'ref.fa', 'idx', *flags)\n"
        "run('combine', 'ref.fa', 'exons.tsv', 'cidx', *flags)\n"
        "run('simulate', 'idx', 's.fastq', '--n-reads', '96', *flags)\n"
        "run('simulate', 'cidx', 'c.fastq', '--n-reads', '96', *flags)\n"
        "run('twopass', 'idx', 's.fastq', 'tp.sam', '--device', 'cpu',"
        " *flags)\n"
        "run('simulate', 'idx', 'p.fastq', '--n-reads', '64', '--profile',"
        " 'tp.sam.errorprofile', '--learned-indels', *flags)\n"
        "run('align', 'idx', 's.fastq', 'al.bam', '--device', 'cpu', *flags)\n"
        "b = run('benchmark', 'idx', '--n-reads', '64', '--device', 'cpu',"
        " *flags)\n"
        "assert b['n_correct'] > 50, b\n"
        "for src, out in (('tp.sam', 'cs.tsv'), ('al.bam', 'cb.tsv')):\n"
        "    run('cluster', 'idx', src, out, '--cluster-min-reads', '1',"
        " *flags)\n"
        "run('sort', 'al.bam', 'sorted.bam')\n"
        "run('convert', 'sorted.bam', 'sorted.sam')\n"
        "c = run('align', 'cidx', 'c.fastq', 'c.sam', '--device', 'cpu',"
        " *flags)\n"
        "assert c['packed_batches'] == 3 and c['packed_overflow'] == 0, c\n"
        f"{ALONE}"
        "print('no-jax-ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO)
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "no-jax-ok"
    recs = [line for line in (tmp_path / "sorted.sam").read_text()
            .splitlines() if not line.startswith("@")]
    assert len(recs) == 96


def test_multi_device_layer_runs_without_jax(tmp_path, tiny_ref):
    """dist-align file-side over two hosts and as a torch.distributed group
    of one, merge-shards on both, benchmark --scaling, and the entry points
    (entry(), the 1-D and 2-D dry run on explicit CPU devices), whose
    multi-device steps are compiled (ops/compiled.py, one CompiledStep a
    mesh slot and a row merge): no jax in sys.modules, and both merges give
    the same bytes."""
    from parasuite_tpu.io.fasta import write_fasta

    write_fasta(tmp_path / "ref.fa",
                {name: tiny_ref.seq[tiny_ref.starts[i]:tiny_ref.ends[i]]
                 for i, name in enumerate(tiny_ref.names)})
    flags = ["--max-read-len", "50", "--kmer-size", "8", "--band-width", "3",
             "--batch-size", "32"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = (
        "import contextlib, io, json, sys\n"
        "import torch\n"
        "from parasuite_tpu_torch.cli import main\n"
        "from parasuite_tpu_torch import entry\n"
        f"flags = {flags!r}\n"
        "def run(*argv, rc=0):\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        assert main(list(argv)) == rc, argv\n"
        "    lines = buf.getvalue().strip().splitlines()\n"
        "    return json.loads(lines[-1]) if lines else None\n"
        "run('index', 'ref.fa', 'idx', *flags)\n"
        "run('simulate', 'idx', 's.fastq', '--n-reads', '96', *flags)\n"
        "for h in ('0', '1'):\n"
        "    run('dist-align', 'idx', 's.fastq', 'two', '--host-index', h,"
        " '--n-hosts', '2', '--device', 'cpu', *flags)\n"
        "m = run('merge-shards', 'idx', 'two', 'two.sam', '--n-hosts', '2',"
        " '--pg-cl', 'x', '--profile-out', 'two.errorprofile', *flags)\n"
        "assert m['records'] == 96, m\n"
        "c = run('dist-align', 'idx', 's.fastq', 'grp', '--coordinator',"
        f" '127.0.0.1:{port}', '--num-processes', '1', '--process-id', '0',"
        " '--device', 'cpu', *flags)\n"
        "assert c['mode'] == 'torch.distributed' and c['backend'] == 'gloo', c\n"
        "run('merge-shards', 'idx', 'grp', 'grp.sam', '--n-hosts', '1',"
        " '--pg-cl', 'x', '--profile-out', 'grp.errorprofile', *flags)\n"
        "for ext in ('.sam', '.errorprofile'):\n"
        "    assert open('two' + ext, 'rb').read() == "
        "open('grp' + ext, 'rb').read(), ext\n"
        "s = run('benchmark', 'idx', '--scaling', '1', '--n-reads', '32',"
        " '--device', 'cpu', *flags)\n"
        "assert s['backend'] == 'cpu' and s['points'][0]['efficiency'] == 1.0\n"
        "assert s['graphs'] == [{'n_devices': 1, 'compiled_steps': 1, "
        "'keys': 1, 'graphs': 0, 'capture_ms': 0.0}], s\n"
        "run('benchmark', 'idx', '--scaling', '1,2', '--n-reads', '32',"
        " '--device', 'cpu', *flags, rc=2)\n"
        "fn, args = entry.entry('cpu')\n"
        "assert int(fn(*args).mapped.sum()) > 200\n"
        "entry.dryrun_multichip(4, devices=[torch.device('cpu')] * 4)\n"
        f"{ALONE}"
        "print('no-jax-ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stdout.strip().splitlines()
    assert lines[-1] == "no-jax-ok"
    assert lines[-3].startswith("dryrun_multichip(4): 1-D data ok")
    assert lines[-2].startswith("dryrun_multichip 2-D (2x2 data x index): ok")
    assert lines[-3].endswith("compiled 4 steps, 4 keys, 0 graphs, "
                              "capture 0.0 ms")
    assert lines[-2].endswith("compiled 6 steps, 6 keys, 0 graphs, "
                              "capture 0.0 ms")
    assert "requested 2 devices, have 1" in p.stderr


def test_bench_scripts_run_without_jax(tmp_path):
    """bench_torch.py's main, tools/torch_bench_distributed.py's measurement
    (one and two processes of the port's CLI) and
    tools/torch_bench_shards_scale.py's, on the CPU at tiny sizes, in one
    process: neither jax nor the JAX package comes in."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO / 'tools')!r})\n"
        "import bench_torch\n"
        "import torch_bench_distributed as dist\n"
        "import torch_bench_shards_scale as shards\n"
        "assert bench_torch.main(['--device', 'cpu'], n_reads=512, "
        "batch=256, ref_len=100_000, cpu_reads=256, cpu_batch=256, "
        "device_rounds=1, e2e_rounds=1) == 0\n"
        "assert dist.measure(1024, 'cpu', rounds=1)['same_output']\n"
        "assert shards.measure('cpu', 1_000_000, 64)['dominance_ok']\n"
        f"{ALONE}"
        "print('no-jax-ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=400)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stdout.strip().splitlines()
    assert lines[-1] == "no-jax-ok"
    assert json.loads(lines[0])["metric"] == "reads_per_second_per_chip"


def test_no_source_file_imports_jax():
    """No `import` / `from` of jax or of parasuite_tpu (parasuite_tpu_torch
    is the port itself), anywhere in a line: a docstring recipe counts."""
    pattern = re.compile(
        r"\b(import|from)\s+(jax|parasuite_tpu)([\s.,]|$)", re.MULTILINE)
    files = sorted((REPO / "parasuite_tpu_torch").rglob("*.py"))
    assert REPO / "parasuite_tpu_torch" / "ops" / "cuda_finalize.py" in files
    tools = sorted((REPO / "tools").glob("torch_*.py"))
    tools.append(REPO / "tools" / "_torch_bench.py")
    assert len(tools) == 16
    tools.append(REPO / "bench_torch.py")
    files += [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py",
              REPO / "tests" / "_torch_helpers.py", *tools]
    # the benchmark: its harness, modes, metric readers and tests
    bench_files = sorted((REPO / "benchmark").rglob("*.py"))
    assert {REPO / "benchmark" / "modes" / "twopass.py",
            REPO / "benchmark" / "metrics" / "twopass.profile_ms.py"} <= \
        set(bench_files)
    files += bench_files
    assert len(files) > 70
    offenders = [str(f.relative_to(REPO)) for f in files
                 if pattern.search(f.read_text())]
    assert offenders == []
    # the port's measurement scripts do not import bench.py either: it
    # drives the JAX package
    bench = re.compile(r"^\s*(import|from)\s+bench\b", re.MULTILINE)
    assert [f.name for f in [*tools, REPO / "chip_smoke.py"]
            if bench.search(f.read_text())] == []
