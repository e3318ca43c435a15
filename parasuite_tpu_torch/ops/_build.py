"""Build and load the port's CUDA kernels.

The sources under parasuite_tpu_torch/csrc/*.cu are compiled by nvcc for
sm_90a (one nvcc per source, all started together) and linked into one
shared library with a plain C interface,
parasuite_tpu_torch/build/libparasuite_cuda.so, loaded with ctypes. The
build runs at first use (never at import) and again whenever the sources or
flags change: a SHA-256 of both is stored beside the library.

Every C entry point takes its pointers and the CUDA stream as void*, launches
on that stream, and returns cudaGetLastError() so a refused launch is
reported where it happened.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
LIB = BUILD / "libparasuite_cuda.so"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_log = ""   # nvcc's output from the last build (ptxas register report)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def build() -> Path:
    """Compile the kernels unless an up-to-date library exists. -> path."""
    global build_log
    stamp = BUILD / "libparasuite_cuda.sha256"
    digest = _digest()
    if LIB.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIB
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc, pid = nvcc_path(), os.getpid()
    objs = [BUILD / f"{src.stem}.{pid}.o" for src in _sources()]
    tmp = BUILD / f"libparasuite_cuda.{pid}.so"
    procs = []
    try:
        procs += [subprocess.Popen([nvcc, *FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_sources(), objs)]
        logs = [p.communicate(timeout=900)[0] for p in procs]
        build_log = "".join(logs)
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True, timeout=900)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{build_log}")
        os.replace(tmp, LIB)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    stamp.write_text(digest)
    return LIB


def ptxas_report(log: str) -> dict:
    """nvcc's -Xptxas -v output -> {kernel symbol: {registers, stack,
    spill_stores, spill_loads}}."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def sass_opcodes(lib: Path = LIB) -> dict:
    """cuobjdump -sass of the built library -> {kernel symbol: {opcode:
    count}}, the opcode without its modifiers (VIADDMNMX.U32 -> VIADDMNMX).
    cuobjdump sits beside nvcc."""
    tool = Path(nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and name:
            op = m.group(1).split(".")[0]
            out[name][op] = out[name].get(op, 0) + 1
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (building it first if needed)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ps_select_candidates.restype = i32
    lib.ps_select_candidates.argtypes = [ptr, i32, i32, i32, i32, ptr, ptr,
                                         ptr]
    lib.ps_seed_select.restype = i32
    lib.ps_seed_select.argtypes = [ptr] * 4 + [i32] * 9 + [ptr] * 3
    lib.ps_extend_candidates.restype = i32
    lib.ps_extend_candidates.argtypes = [ptr] * 6 + [i32] * 7 + [ptr] * 5
    lib.ps_extend_occupancy.restype = i32
    lib.ps_extend_occupancy.argtypes = [i32, i32, i32, ptr]
    table = ctypes.POINTER(ctypes.c_void_p)
    lib.ps_finalize_select.restype = i32
    lib.ps_finalize_select.argtypes = [table, table] + [i32] * 7 + [ptr]
    _lib = lib
    return lib
