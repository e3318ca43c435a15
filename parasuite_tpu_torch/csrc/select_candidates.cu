// Candidate selection, one warp per oriented read.
//
// Replaces parasuite_tpu/ops/pallas_seed.py::_select_kernel. Contract:
// parasuite_tpu/ops/aligner.py select_candidates — top C unique diagonals
// per row by (votes desc, diag asc); exhausted slots are (I32MAX, false).
//
// Per warp: the row is copied into shared memory padded with I32MAX to
// n_pad (a power of two >= 32), bitonic-sorted in place, and every sorted
// entry gets the key (negv, diag) packed into one int64 — negv = -run length
// at the first entry of a run of a valid diagonal, else (1, I32MAX), exactly
// the reference's sort keys. C rounds of a warp-shuffle min over the keys
// then emit the winners in order, each knocked out after its round; valid
// keys are unique (one per distinct diagonal), so one knock-out per round.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kI32Max = 0x7fffffff;
constexpr int kWarps = 4;  // warps (rows) per block

__device__ __forceinline__ long long pack_key(int32_t negv, int32_t diag) {
  // signed order of (negv, diag): the low word is diag with its sign bit
  // flipped, so it orders as unsigned exactly like diag does as signed
  return (long long)negv * 4294967296LL +
         (long long)(uint32_t)((uint32_t)diag ^ 0x80000000u);
}

__global__ void select_kernel(const int32_t* __restrict__ diags, int rows,
                              int n, int n_pad, int C,
                              int32_t* __restrict__ cand,
                              uint8_t* __restrict__ valid) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  // per-warp buffers: n_pad int64 keys, then n_pad int32 diagonals
  long long* keys = reinterpret_cast<long long*>(smem) + (size_t)warp * n_pad;
  int32_t* d = reinterpret_cast<int32_t*>(
                   reinterpret_cast<long long*>(smem) + (size_t)kWarps * n_pad) +
               (size_t)warp * n_pad;
  if (row >= rows) return;  // whole warp exits together

  const int32_t* src = diags + (size_t)row * n;
  for (int k = lane; k < n_pad; k += 32) d[k] = k < n ? src[k] : kI32Max;
  __syncwarp();

  // bitonic sort, ascending
  for (int size = 2; size <= n_pad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (n_pad >> 1); t += 32) {
        const int i = 2 * stride * (t / stride) + (t % stride);
        const int j = i + stride;
        const bool up = (i & size) == 0;
        const int32_t a = d[i], b = d[j];
        if ((a > b) == up) {
          d[i] = b;
          d[j] = a;
        }
      }
      __syncwarp();
    }
  }

  // keys: run start of a valid diagonal -> (-run length, diag)
  for (int k = lane; k < n_pad; k += 32) {
    const int32_t v = d[k];
    const bool first = (k == 0) || (d[k - 1] != v);
    long long key = pack_key(1, kI32Max);
    if (first && v != kI32Max) {
      int e = k + 1;
      while (e < n_pad && d[e] == v) ++e;
      key = pack_key(k - e, v);
    }
    keys[k] = key;
  }
  __syncwarp();

  int32_t* out_c = cand + (size_t)row * C;
  uint8_t* out_v = valid + (size_t)row * C;
  bool exhausted = false;
  for (int c = 0; c < C; ++c) {
    if (!exhausted) {
      long long best = LLONG_MAX;
      for (int k = lane; k < n_pad; k += 32) best = min(best, keys[k]);
      for (int off = 16; off > 0; off >>= 1)
        best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
      // high word = negv (floor of key / 2^32), low word = diag ^ sign bit
      const int32_t negv = (int32_t)(best >> 32);
      exhausted = negv >= 1;
      if (!exhausted) {
        for (int k = lane; k < n_pad; k += 32)
          if (keys[k] == best) keys[k] = LLONG_MAX;
        __syncwarp();
        if (lane == 0) {
          out_c[c] = (int32_t)((uint32_t)best ^ 0x80000000u);
          out_v[c] = 1;
        }
        continue;
      }
    }
    if (lane == 0) {
      out_c[c] = kI32Max;
      out_v[c] = 0;
    }
  }
}

}  // namespace

extern "C" int ps_select_candidates(const void* diags, int rows, int n,
                                    int n_pad, int C, void* cand, void* valid,
                                    void* stream) {
  const size_t smem =
      (size_t)kWarps * n_pad * (sizeof(long long) + sizeof(int32_t));
  const int blocks = (rows + kWarps - 1) / kWarps;
  select_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(diags), rows, n, n_pad, C,
      static_cast<int32_t*>(cand), static_cast<uint8_t*>(valid));
  return (int)cudaGetLastError();
}
