#!/usr/bin/env python3
"""`cli align` and `cli twopass --learned-gaps` FASTQ -> SAM of this tree of
the port against another tree of it, in turns on one card.

    python tools/torch_cli_turns.py --other OTHER_TREE [--rounds 2]
        [--repeat N]

OTHER_TREE is an unpacked copy of the repo at another commit, for example
`git archive HEAD~1 | tar -x -C .proof/parent` (a git-ignored directory).
Each tree's CLI runs as a subprocess with PYTHONPATH at the tree, on
chip_smoke.py's bench world (built under .smoke/ when it is missing): the
bench index and the 262,144 reads of all.fastq at batch 65,536, or with
--repeat N that file N times over in one FASTQ (N x 4 batches: a longer
stream, over which a one-time cost a run pays spreads). One warm-up
run a tree builds its kernels and native library; then, per round and
command, the order is other, this, this, other. A run's rates are its JSON
line's `reads_per_second` (`align`: the stream alone; `twopass` prints
none) and the reads over the subprocess's wall seconds (start-up and index
loads included). The output
files of the two trees must be byte-equal. One JSON line after the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import _torch_bench as tb

sys.path.insert(0, str(tb.REPO))
import chip_smoke  # noqa: E402


def run_cli(tree: Path, cmd: str, out: Path, fastq: Path) -> dict:
    """One CLI run of tree on the bench world -> its rates."""
    extra = ["--learned-gaps"] if cmd == "twopass" else []
    argv = [sys.executable, "-m", "parasuite_tpu_torch.cli", cmd,
            str(chip_smoke.WORK / "idx"), str(fastq), str(out), *extra,
            "--pg-cl", "smoke", "--batch-size", str(chip_smoke.BATCH),
            *chip_smoke.FLAGS, "--device", "cuda"]
    env = dict(os.environ, PYTHONPATH=str(tree))
    t0 = time.perf_counter()
    p = subprocess.run(argv, cwd=tree, env=env, capture_output=True,
                       text=True, timeout=900)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise RuntimeError(f"{tree} {cmd}: exit {p.returncode}\n"
                           f"{p.stderr[-3000:]}")
    line = json.loads(p.stdout.strip().splitlines()[-1])
    return {"reads_per_s_in_cli": line.get("reads_per_second"),
            "wall_seconds": round(wall, 3),
            "reads_per_s_wall": round(line["reads"] / wall, 1)}


def median(runs: list, key: str):
    """The median of a rate over runs; None where the CLI prints none
    (`twopass` prints no rate of its own)."""
    vals = [r[key] for r in runs if r[key] is not None]
    return float(np.median(vals)) if vals else None


def outputs(out: Path, cmd: str) -> list:
    names = [out] + ([Path(f"{out}.pass1.sam"), Path(f"{out}.errorprofile")]
                     if cmd == "twopass" else [])
    return [chip_smoke.sha256(n) for n in names]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)
    trees = {"other": args.other.resolve(), "this": tb.REPO}
    work = chip_smoke.WORK
    if not (work / "all.fastq").exists() or \
            not (work / "idx.config.json").exists():
        chip_smoke.world()
    fastq = work / "all.fastq"
    if args.repeat > 1:
        fastq = work / f"turns_x{args.repeat}.fastq"
        fastq.write_bytes((work / "all.fastq").read_bytes() * args.repeat)
    for name, tree in trees.items():         # builds, not timed
        run_cli(tree, "align", work / f"turns_warm_{name}.sam",
                work / "pin.fastq")
    runs = {cmd: {name: [] for name in trees}
            for cmd in ("align", "twopass")}
    digests = {}
    for _ in range(args.rounds):
        for cmd in runs:
            for name in ("other", "this", "this", "other"):
                out = work / f"turns_{cmd}_{name}.sam"
                runs[cmd][name].append(run_cli(trees[name], cmd, out,
                                               fastq))
                digests.setdefault(cmd, {})[name] = outputs(out, cmd)
    for cmd, d in digests.items():
        if d["this"] != d["other"]:
            raise AssertionError(f"{cmd}: the trees' outputs differ")
    medians = {cmd: {name: {k: median(rs, k) for k in (
        "reads_per_s_in_cli", "reads_per_s_wall")} for name, rs in r2.items()}
        for cmd, r2 in runs.items()}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(json.dumps({"other": str(args.other),
                      "reads": tb.SMOKE_READS * args.repeat,
                      "batch": chip_smoke.BATCH, "runs": runs,
                      "medians": medians,
                      "outputs_equal": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
