#!/usr/bin/env python3
"""Integer instruction rates of the card, for the bound of the extend
kernel.

    python tools/torch_int_rates.py

Times a kernel whose threads run eight independent chains of one operation
(4,096 iterations, 128 threads a block, 8 to 32 blocks an SM) and prints the
lane-operations per second of each: the DPX add-max (__viaddmax_s32 ->
VIADDMNMX) and three-way max (__vimax3_s32 -> VIMNMX3) that
csrc/extend_candidates.cu is built on, a plain add (which the compiler
emits as IADD3 or as IMAD on the FMA pipe) and an IMAD. chip_smoke.py's
extend_bound counts 6 operations a DP cell, three of them DPX max
operations, at the instruction rate (INSTR_OPS_PER_S = 33.5 T/s); these
rates show whether that is a lower bound. The SASS of each kernel is
checked for its instruction. One JSON line, after the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import _torch_bench as tb

sys.path.insert(0, str(tb.REPO))

SOURCE = r"""
#include <cuda_runtime.h>
template <int OP>
__global__ void chains(int* out, int iters, int b, int c) {
  int x[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = threadIdx.x * 8 + j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (OP == 0) x[j] = __viaddmax_s32(x[j], b, x[(j + 1) & 7]);
      if (OP == 1) x[j] = __vimax3_s32(x[j], x[(j + 1) & 7], x[(j + 2) & 7]);
      if (OP == 2) x[j] = x[j] + x[(j + 1) & 7];
      if (OP == 3) x[j] = x[j] * c + b;
    }
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s ^= x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// lane-operations per second of OP (8 per iteration and thread), the
// second of two launches
extern "C" double rate(int op, int blocks, int threads, int iters) {
  int* out;
  if (cudaMalloc(&out, sizeof(int) * blocks * threads) != cudaSuccess)
    return -1;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = 0;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    switch (op) {
      case 0: chains<0><<<blocks, threads>>>(out, iters, -3, 7); break;
      case 1: chains<1><<<blocks, threads>>>(out, iters, -3, 7); break;
      case 2: chains<2><<<blocks, threads>>>(out, iters, -3, 7); break;
      case 3: chains<3><<<blocks, threads>>>(out, iters, -3, 7); break;
    }
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  if (cudaGetLastError() != cudaSuccess) return -1;
  return 8.0 * iters * blocks * (double)threads / (ms * 1e-3);
}
"""
OPS = {"viaddmax_s32": ("VIADDMNMX",), "vimax3_s32": ("VIMNMX3",),
       "add": ("IADD3", "IMAD"), "imad": ("IMAD",)}


def main() -> int:
    import torch

    from parasuite_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("torch_int_rates: needs an NVIDIA GPU")
    gpu = tb.gpu_line()
    print(gpu, flush=True)
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        src, lib = Path(tmp) / "rates.cu", Path(tmp) / "rates.so"
        src.write_text(SOURCE)
        subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-shared", "-o",
                        str(lib), str(src)], check=True, capture_output=True,
                       timeout=600)
        sass = _build.sass_opcodes(lib)
        dll = ctypes.CDLL(str(lib))
        dll.rate.restype = ctypes.c_double
        dll.rate.argtypes = [ctypes.c_int] * 4
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rates = {}
        for op, (name, want) in enumerate(OPS.items()):
            sym = next(s for s in sass if f"chainsILi{op}E" in s)
            if not any(sass[sym].get(w, 0) >= 8 for w in want):
                raise AssertionError(f"{name}: no {want} in {sass[sym]}")
            rates[name] = {f"{b}_blocks_per_sm": dll.rate(op, b * sms, 128,
                                                          4096)
                           for b in (8, 16, 32)}
    print(json.dumps({"lane_ops_per_s": rates, "sms": sms,
                      "int32_ops_per_s_table": 67e12 / 4,
                      "instr_ops_per_s_table": 67e12 / 2, "gpu": gpu}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
