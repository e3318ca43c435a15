"""The port's benchmark (bench_torch.py), its distributed and sharded-scale
tools (tools/torch_bench_distributed.py, tools/torch_bench_shards_scale.py)
and the spill of the port's native sort, on the CPU at small sizes.

The same seeded worlds go through the JAX package's bench.py and tools and
through the port's; every compared value is an integer count or a fraction
of integer counts rounded the same way, so every tolerance is 0. Rates and
times are never compared. Where the JAX side reaches a Pallas kernel it
runs the jnp reference, as tests/test_pallas.py runs it on the CPU."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import bench                                    # noqa: E402
import bench_torch                              # noqa: E402
import torch_bench_shards_scale as t_shards     # noqa: E402

from _torch_helpers import to_port              # noqa: E402

torch.set_num_threads(1)

REF_LEN = 200_000
BATCH = 1024
N = 2048
ENV_KEYS = {"device", "gpu", "torch", "cuda", "nvcc"}


def _dict_keys(path: Path, func: str, target: str | None = None) -> set:
    """The string keys of the dict literal that `func` in `path` assigns to
    `target` (or passes to json.dumps), and the keys bench.py's `**extras`
    stands for: what the JAX script's one line holds."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        value = None
        if target and isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == target
                for t in node.targets):
            value = node.value
        elif not target and isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "dumps":
            value = node.args[0]
        if isinstance(value, ast.Dict):
            keys = {k.value for k in value.keys if k is not None}
            if any(k is None for k in value.keys):     # **extras
                keys |= {"sensitivity", "precision", "n_unmapped",
                         "n_mismapped"}
            return keys
    raise AssertionError(f"no dict literal in {path.name}:{func}")


def test_run_throughput_equals_bench(monkeypatch):
    """bench_torch.run_throughput against bench.run_throughput on the same
    world: the accuracy extras are equal; the constants are bench.py's."""
    assert (bench_torch.N_READS, bench_torch.BATCH, bench_torch.REF_LEN,
            bench_torch.N_READS_CPU, bench_torch.BATCH_CPU,
            bench_torch.TIMED_ROUNDS, bench_torch.E2E_ROUNDS) == (
        bench.N_READS_TPU, bench.BATCH_TPU, bench.REF_LEN, bench.N_READS_CPU,
        bench.BATCH_CPU, bench.TIMED_ROUNDS, bench.E2E_ROUNDS)
    monkeypatch.setattr(bench, "TIMED_ROUNDS", 1)
    j_cfg = dataclasses.replace(bench.make_cfg(), batch_size=BATCH)
    _b, want, _r = bench.run_throughput(j_cfg, N, BATCH, REF_LEN,
                                        check_accuracy=True)
    best, got, rates = bench_torch.run_throughput(
        to_port(j_cfg), N, BATCH, REF_LEN, check_accuracy=True,
        device="cpu", rounds=1)
    assert got == want                       # tolerance 0
    assert want["n_unmapped"] + want["n_mismapped"] < N // 10
    assert rates == [best]
    assert bench_torch.make_cfg().to_json() == bench.make_cfg().to_json()


def test_main_prints_one_line_with_the_keys_of_bench(capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the CPU leg's process
    rc = bench_torch.main(["--device", "cpu"], n_reads=N, batch=BATCH,
                          ref_len=REF_LEN, cpu_reads=512, cpu_batch=256,
                          device_rounds=1, e2e_rounds=2)
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    want = _dict_keys(REPO / "bench.py", "main", "out")
    assert len(want) == 20
    assert set(line) == want | ENV_KEYS | {"n_reads", "batch", "ref_len"}
    assert line["metric"] == "reads_per_second_per_chip"
    assert line["unit"] == "reads/s/chip (50bp PAR-CLIP, 20Mbp ref)"
    assert (line["device"], line["gpu"]) == ("cpu", "cpu")
    assert len(line["device_rounds"]) in (1, 2)
    assert len(line["e2e_rounds"]) == 2
    assert line["cpu_reads_per_s"] > 0 and line["vs_baseline"] > 0
    assert line["n_unmapped"] + line["n_mismapped"] < N // 10


# (device rounds, e2e median, rerun rounds) -> (rerun, suspect, value,
# rounds listed, spread judged)
GUARD_CASES = {
    "steady": ([100.0, 105.0, 110.0], 10.0, None,
               (False, False, 110.0, 3, 0.1)),
    "spread_then_steady": ([100.0, 120.0, 110.0], 10.0, [118.0, 119.0, 120.0],
                           (True, False, 120.0, 6, 2.0 / 118.0)),
    "e2e_above_device": ([100.0, 101.0, 102.0], 103.0, [130.0, 131.0, 132.0],
                         (True, False, 132.0, 6, 2.0 / 130.0)),
    "still_spread": ([100.0, 130.0, 110.0], 10.0, [100.0, 140.0, 120.0],
                     (True, True, 140.0, 6, 0.4)),
    "e2e_above_both": ([100.0, 101.0, 102.0], 200.0, [110.0, 111.0, 112.0],
                       (True, True, 112.0, 6, 2.0 / 110.0)),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_variance_guard_reruns_once_and_flags_suspect(case):
    """bench.py's rules on injected rounds: one rerun when the spread is
    over 0.15 or the end-to-end median is above the best round, the spread
    then judged on the fresh rounds; suspect when either still holds."""
    rounds, e2e, again, (rerun, suspect, value, n, spread) = \
        GUARD_CASES[case]
    calls = []

    def fresh():
        calls.append(1)
        return max(again), list(again)

    got = bench_torch.variance_guard(max(rounds), list(rounds), e2e, fresh)
    assert len(calls) == int(rerun)
    assert (got["rerun_triggered"], got["suspect"], got["value"]) == (
        rerun, suspect, value)
    assert got["device_rounds"] == rounds + (again if rerun else [])
    assert len(got["device_rounds"]) == n
    assert got["device_spread"] == pytest.approx(spread, rel=1e-12)


def test_failed_cpu_leg_exits_nonzero_without_a_line(capsys, monkeypatch):
    """The CPU leg's process fails: the script says why on stderr, prints
    no line and exits 1 (bench.py would record 0.0)."""
    monkeypatch.setattr(bench_torch, "CPU_LEG",
                        "import sys\nsys.exit('the cpu leg broke')\n")
    rc = bench_torch.main(["--device", "cpu"], n_reads=256, batch=256,
                          ref_len=REF_LEN, device_rounds=1, e2e_rounds=1)
    out, err = capsys.readouterr()
    assert rc == 1 and out == ""
    assert "cpu leg exited 1" in err and "the cpu leg broke" in err


def test_cuda_is_never_replaced_by_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main([]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "torch.cuda.is_available() is false" in err


def test_distributed_tool_two_processes_equal_one(tmp_path):
    """tools/torch_bench_distributed.py on the CPU: two gloo processes, one
    core each, against one; the keys of the JAX tool's line and the port's
    own, the records of both runs, and equal merged outputs. The tool kills
    a sibling when a process fails; the test's own timeout ends a hang."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable,
                        str(REPO / "tools" / "torch_bench_distributed.py"),
                        "4096", "--rounds", "1", "--device", "cpu"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=400)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    want = _dict_keys(REPO / "tools" / "bench_distributed.py", "main")
    assert len(want) == 13 and want <= set(line)
    assert set(line) - want == {
        "device", "cards", "backend", "backend_1proc", "launches",
        "sam_sha256_1proc", "sam_sha256_2proc", "errorprofile_sha256",
        "same_output", "gpu"}
    assert (line["n_reads"], line["batch"], line["device"], line["cards"]) \
        == (4096, 8192, "cpu", 0)
    assert (line["backend"], line["backend_1proc"]) == ("gloo", "gloo")
    assert len(line["rounds_1proc"]) == 1 + line["remeasure_rounds"]
    assert line["same_output"]
    assert line["sam_sha256_1proc"] == line["sam_sha256_2proc"]
    assert line["launches"] == {"seed_select": 0, "select_candidates": 0,
                                "extend_candidates": 0,
                                "finalize_select": 0}     # plain on the CPU
    assert list(tmp_path.iterdir()) == []                 # its world is gone


def _run_tool(script: Path, extra_env: dict, *args: str,
              timeout: int = 600) -> dict:
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "PARASUITE_SHARDS_LEN": "2000000", "PARASUITE_SHARDS_READS": "256",
           **extra_env}
    p = subprocess.run([sys.executable, str(script), *args], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_shards_scale_counts_equal_the_jax_tool():
    """Both tools at 2 Mbp and 256 reads, each in its own process (the JAX
    one on four of eight virtual CPU devices, the port on four CPU
    devices): every count of the dominance contract, the sensitivity, the
    world's census and the slab bytes are equal. At this size nothing
    saturates; the 200 Mbp counts are pinned in the tool (PINNED)."""
    want = _run_tool(REPO / "tools" / "bench_shards_scale.py",
                     {"JAX_PLATFORMS": "cpu", "XLA_FLAGS":
                      "--xla_force_host_platform_device_count=8"})
    got = _run_tool(REPO / "tools" / "torch_bench_shards_scale.py", {},
                    "--device", "cpu")
    same = [*t_shards.PINNED, "dominance_ok", "total_ref_len", "n_chroms",
            "repeat_fraction", "mesh", "n_reads", "per_shard_slab_bytes",
            "per_shard_total_bytes"]
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    assert set(want) - {"projected_3gbp_8chip_per_chip_bytes"} <= set(got)
    assert (got["n_reads"], got["total_ref_len"]) == (256, 2_000_768)
    assert got["dominance_ok"] and got["equal_score_reads_checked"] > 200
    assert got["mesh_devices"] == ["cpu"] * 4
    assert got["pinned"] is False            # the pins hold at full size
    # the pins are checked at the full size only, and every one of them
    full = {**got, **t_shards.PINNED, "total_ref_len": 200_000_768,
            "n_reads": 2048}
    assert t_shards.pin_check(full) == {}
    assert t_shards.pin_check({**full, "x0_grew": 2}) == {
        "x0_grew": {"got": 2, "jax": 1}}
    assert t_shards.pin_check(got) == {}


# ---------------------------------------------------------------------------
# the native sort's spill
# ---------------------------------------------------------------------------

N_SORT = 30_000
MAX_IN_MEMORY = 7_000           # 5 runs


def _sort_input(tmp: Path) -> Path:
    """A BAM of N_SORT records over three references, in no order, some
    unmapped and some with equal keys (the sort is stable)."""
    from parasuite_tpu_torch.io.bam import sam_to_bam

    rng = np.random.default_rng(8)
    seq = "".join(rng.choice(list("ACGT"), 50))
    lines = ["@HD\tVN:1.6\tSO:unsorted"] + [
        f"@SQ\tSN:chr{c}\tLN:1000000" for c in range(3)]
    chrom = rng.integers(0, 3, N_SORT)
    pos = rng.integers(1, 5_000, N_SORT)
    unmapped = rng.random(N_SORT) < 0.05
    for i in range(N_SORT):
        if unmapped[i]:
            lines.append(f"r{i}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t*")
        else:
            lines.append(f"r{i}\t0\tchr{chrom[i]}\t{pos[i]}\t{i % 60}\t50M"
                         f"\t*\t0\t0\t{seq}\t*")
    (tmp / "in.sam").write_text("\n".join(lines) + "\n")
    sam_to_bam(tmp / "in.sam", tmp / "in.bam")
    return tmp / "in.bam"


def _open_fds() -> dict:
    out = {}
    for fd in os.listdir("/proc/self/fd"):
        try:
            out[fd] = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            pass                         # the listing's own descriptor
    return out


def test_native_sort_spills_beside_its_output(tmp_path):
    """At a max_in_memory that makes five runs, the port's native sort
    keeps its run files in the output's directory (seen, while it runs, as
    unlinked files the process holds open), leaves nothing there but the
    output, and writes the bytes of the JAX package's sort and of the
    port's Python path."""
    from parasuite_tpu.io import bam as j_bam

    from parasuite_tpu_torch import native
    from parasuite_tpu_torch.io import bam as t_bam

    assert native.available()
    src = _sort_input(tmp_path)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    seen: set = set()
    done = threading.Event()
    result = {}

    def sort():
        result["n"] = t_bam.coordinate_sort(src, out_dir / "s.bam",
                                            max_in_memory=MAX_IN_MEMORY)
        done.set()

    worker = threading.Thread(target=sort)
    worker.start()
    while not done.is_set():
        seen |= {t for t in _open_fds().values() if "sortrun" in t}
    worker.join()
    assert result["n"] == N_SORT
    # a probe between mkstemp and unlink reads a run's link before it
    # gains " (deleted)": such a name must be gone by now
    deleted = " (deleted)"
    live = {t for t in seen if not t.endswith(deleted)}
    assert not [t for t in live if os.path.lexists(t)], live
    runs = {t.removesuffix(deleted) for t in seen}
    assert len(runs) >= 3, seen
    prefix = str(out_dir / ".s.bam.sortrun.")
    assert all(t.startswith(prefix) for t in runs), seen
    assert sorted(p.name for p in out_dir.iterdir()) == ["s.bam"]
    assert not [t for t in _open_fds().values() if "sortrun" in t]

    j_bam.coordinate_sort(src, tmp_path / "j.bam",
                          max_in_memory=MAX_IN_MEMORY)
    t_bam.coordinate_sort(src, tmp_path / "p.bam",
                          max_in_memory=MAX_IN_MEMORY, native_ok=False)
    got = (out_dir / "s.bam").read_bytes()
    assert got == (tmp_path / "j.bam").read_bytes()
    assert got == (tmp_path / "p.bam").read_bytes()


# a spill that fails half-way: the run file's writes pass a file-size limit
# set after the library is loaded and the input written
WRITE_FAILS = """
import os, resource, signal, sys
from parasuite_tpu_torch import native
assert native.available()
signal.signal(signal.SIGXFSZ, signal.SIG_IGN)
blob = b"BAM\\x01" + bytes(8)
before = sorted(os.listdir("/proc/self/fd"))
resource.setrlimit(resource.RLIMIT_FSIZE, (1 << 20, resource.RLIM_INFINITY))
try:
    native.bam_sort(sys.argv[1], sys.argv[2], blob, max_in_memory=20000)
except RuntimeError as e:
    print("raised", e)
after = sorted(os.listdir("/proc/self/fd"))
print("fds", before == after, len(before), len(after))
"""


@pytest.mark.parametrize("how", ["missing_directory", "write_fails"])
def test_native_sort_spill_failure_raises_and_closes_every_run(how,
                                                               tmp_path):
    """A directory that cannot take the runs makes the sort raise, and the
    process holds no descriptor afterwards that it did not hold before: the
    run files opened before the failure and the one that failed are
    closed."""
    from parasuite_tpu_torch import native

    src = _sort_input(tmp_path)
    if how == "missing_directory":
        blob = b"BAM\x01" + bytes(8)
        before = set(_open_fds().items())
        with pytest.raises(RuntimeError, match="I/O failure"):
            native.bam_sort(src, tmp_path / "nowhere" / "s.bam", blob,
                            max_in_memory=MAX_IN_MEMORY)
        assert set(_open_fds().items()) - before == set()   # none left open
        return
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    p = subprocess.run([sys.executable, "-c", WRITE_FAILS, str(src),
                        str(out_dir / "s.bam")], env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "raised ps_bam_sort I/O failure" in p.stdout
    assert "fds True" in p.stdout, p.stdout
    assert list(out_dir.iterdir()) == []
