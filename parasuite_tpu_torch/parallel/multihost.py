"""Multi-host pipeline orchestration, file-side (host-only: numpy and
files, no framework).

A copy of parasuite_tpu/parallel/multihost.py over the port's own engine,
stream and SAM merge; the shard files, .done.json manifests, .counts.npy and
.indels.npz keep that module's layout byte for byte, so shards written by
either package merge under the other.

Design (BASELINE.json config 5): host h of H takes whole read batches
round-robin (io.fastq.iter_fastq_batches stride sharding), aligns them
against its replicated index, writes a HEADERLESS per-host SAM shard, and
accumulates its int64 profile count matrix. Merging is then:

  * SAM: header + shard bodies interleaved by GLOBAL batch index (global
    batch g = shard g % H, local batch g // H) — SAM text never crosses the
    network, and the merged bytes are byte-identical at any host count
    because batch->host assignment is a pure function of the record index
    and the merge restores global batch order (enforced byte-exactly by
    tests/test_torch_multihost.py);
  * profile counts: an integer matrix sum (what a torch.distributed run
    does in-step with an all_reduce, parallel/distributed.py);
  * clusters: called once on the merged SAM (they need global context).

The local simulation (run_local_hosts) spawns N subprocesses to
exercise the exact per-host code on one machine.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.errormodel.infer import ErrorProfile
from parasuite_tpu_torch.io.sam import merge_shards_interleaved
from parasuite_tpu_torch.pipeline.stream import StreamCheckpoint, streaming_align
from parasuite_tpu_torch.utils.runlog import NULL_LOG


def shard_paths(out_prefix, n_hosts: int) -> list[str]:
    return [f"{out_prefix}.shard{h:04d}.sam" for h in range(n_hosts)]


def run_host_shard(engine, fastq, out_prefix, host_index: int, n_hosts: int,
                   *, resume: bool = False, with_profile_counts: bool = True,
                   log=NULL_LOG):
    """One host's work: align its round-robin batches to a headerless shard."""
    shard = shard_paths(out_prefix, n_hosts)[host_index]
    indels: dict = {}
    n, counts, n_prof = streaming_align(
        engine, fastq, shard, resume=resume,
        with_profile_counts=with_profile_counts, log=log, write_header=False,
        stride_shards=n_hosts, shard_index=host_index, indel_out=indels)
    if counts is not None:
        np.save(shard + ".counts.npy", counts)
        np.savez(shard + ".indels.npz", ins=indels["ins"],
                 dels=indels["dels"], n_gapped=np.int64(indels["n_gapped"]))
    # per-local-batch record counts (from the stream manifest) let the merge
    # interleave shards by GLOBAL batch index -> byte-identical merged SAM
    state = StreamCheckpoint(shard, engine.cfg).load() or {}
    Path(shard + ".done.json").write_text(json.dumps(
        {"records": n, "profiled": n_prof,
         "batch_records": state.get("batch_records", [])}))
    return n, counts, n_prof


def merge_host_outputs(ref, out_prefix, out_sam, n_hosts: int,
                       profile_out=None, command_line: str = ""):
    """Deterministic merge of all host shards -> (n_records, ErrorProfile)."""
    shards = shard_paths(out_prefix, n_hosts)
    metas = []
    for s in shards:
        if not Path(s + ".done.json").exists():
            raise RuntimeError(f"shard not finished: {s}")
        metas.append(json.loads(Path(s + ".done.json").read_text()))
    merge_shards_interleaved(out_sam, shards,
                             [m["batch_records"] for m in metas], ref,
                             command_line=command_line)
    total = None
    ins = dels = None
    n_records = 0
    n_prof = 0
    n_gapped = 0
    for s, meta in zip(shards, metas):
        n_records += meta["records"]
        n_prof += meta.get("profiled", 0)
        cp = Path(s + ".counts.npy")
        if cp.exists():
            c = np.load(cp)
            total = c if total is None else total + c
        ip = Path(s + ".indels.npz")
        if ip.exists():
            z = np.load(ip)
            ins = z["ins"] if ins is None else ins + z["ins"]
            dels = z["dels"] if dels is None else dels + z["dels"]
            n_gapped += int(z["n_gapped"])
            if "gsub" in z and total is not None:
                # shards of a coordinator run: gapped M-segment substitution
                # counts are local host work outside the in-step sum
                total = total + z["gsub"]
    profile = (ErrorProfile(counts=total, n_reads=n_prof, ins_counts=ins,
                            del_counts=dels, n_gapped=n_gapped)
               if total is not None else None)
    if profile is not None and profile_out:
        profile.save(profile_out)
    return n_records, profile


def run_local_hosts(index_prefix, fastq, out_prefix, n_hosts: int,
                    cfg: AlignConfig, extra_args: list | None = None,
                    timeout: int = 1800, device: str = "cuda"):
    """Spawn n_hosts subprocesses, each running one host shard via the CLI
    on `device`. A host that fails or outlasts `timeout` ends the run: the
    others are killed, never left behind."""
    procs = []
    repo = Path(__file__).resolve().parents[2]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo)
    try:
        for h in range(n_hosts):
            argv = [sys.executable, "-m", "parasuite_tpu_torch.cli",
                    "dist-align", str(index_prefix), str(fastq),
                    str(out_prefix), "--host-index", str(h), "--n-hosts",
                    str(n_hosts), "--device", device]
            argv += [str(a) for a in (extra_args or [])]
            procs.append(subprocess.Popen(argv, env=env,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE))
        outs = []
        for h, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"host {h} failed:\n{err.decode()[-2000:]}")
            outs.append(json.loads(out.decode().strip().splitlines()[-1]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
