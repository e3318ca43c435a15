"""The port never imports jax: a whole index + twopass run leaves it out of
sys.modules, and no source file of the port (or chip_smoke.py) imports it."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


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
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('no-jax-ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO)
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "no-jax-ok"
    sam = (tmp_path / "out.sam").read_text().splitlines()
    assert sum(1 for line in sam if not line.startswith("@")) == 40


def test_no_source_file_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.MULTILINE)
    files = sorted((REPO / "parasuite_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files
                 if pattern.search(f.read_text())]
    assert offenders == []
