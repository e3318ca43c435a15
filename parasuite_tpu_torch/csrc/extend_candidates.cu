// Banded glocal affine-gap extension for the H100 (sm_90a), one thread per
// (oriented read, candidate diagonal) pair.
//
// Replaces parasuite_tpu/ops/pallas_extend.py::_extend_kernel. Contract:
// parasuite_tpu/ops/aligner.py extend_candidates (= oracle.banded_dp):
//   band j in [0, 2W], read base i sits at packed position diag - W + i + j;
//   M[i][j]  = sub(i, j) + (i == 0 ? 0 : max(M, Ix, Iy)[i-1][j])
//   Ix[i][j] = max(M[i-1][j+1] - go, Ix[i-1][j+1] - ge)   (NEG at i == 0)
//   Iy[i][j] = max_{u<j} (M[i][u] - go - (j-1-u) * ge)    (NEG at j == 0)
//   ug[j]   += sub(i, j)
// sub(i, j) = S[strand][prof(i)][ref base][read base], prof(i) = i on the
// forward strand and len-1-i on the reverse one; reference positions outside
// [0, G) read as N (4). Steps i >= len leave M and ug unchanged, so a thread
// stops at its read's length. Out: (max_j M, smallest such j, max_j ug,
// smallest such j), bit-equal to ops/cuda_extend.py extend_candidates_plain.
//
// What bounds it on the H100: integer instructions. A cell needs six int32
// operations once Hopper's DPX instructions fold each add-then-max into one
// (chip_smoke.py extend_bound), and a block of pairs reads only a few kB.
// Per cell of row i, with T = max(M, Ix, Iy) of row i-1 carried in:
//   M   = s + T                       (IADD)
//   ug += s                           (IADD)
//   mg  = M - go                      (IADD)
//   Iy[j]     = max(Iy[j-1] - ge, mg[j-1])       __viaddmax_s32 (VIADDMNMX)
//   Ix'[j]    = max(Ix[j+1] - ge, mg[j+1])       __viaddmax_s32, row i+1's Ix
//   T'[j]     = max(M, Ix, Iy)                   __vimax3_s32   (VIMNMX3)
// mg is computed once a cell and serves both gap states; Iy[1] = mg[0] and
// the Ix of the band's last diagonal is the constant max(NEG - go, NEG - ge).
// Every value stays exact in int32: NEG = -2^28 less at most L * ge.
//
// What the design does about it:
//  - Each input is staged once per block. The block's pairs are consecutive,
//    so the C candidates of one oriented read share one score row in shared
//    memory, int32 [L][5]: S[strand][prof(i)][ref base][read base] for every
//    ref base (pallas_extend.py's build_score_rows, kept in int32), built
//    from the read (read once per oriented read, not once per candidate,
//    with coalesced loads) and the strand's table. No thread does the prof
//    arithmetic or reads its read in the DP loop.
//  - Each pair's reference window (L + 2W bytes) is copied raw, as the
//    aligned words it overlaps, by cp.async: each warp puts all its 32
//    pairs' windows in flight at once, and they land while the score rows
//    are built. A window that leaves [0, G) is written byte by byte with N
//    there, so the DP loop has no bounds test and no global load. Staging
//    is bounded by round trips to L2 and device memory, not by bytes or
//    operations: a first version of this design, which waited on each of
//    its loads, lost most of its time there (PERF.md).
//  - The thread keeps a register window of BAND shared-memory offsets,
//    w(t) = row + 20 t + 4 code(t): the substitution of cell (i, j) is the
//    int32 at w(i + j) - 20 j, one LDS with an immediate offset and no
//    address arithmetic. The read loop is unrolled BAND times, so the window
//    slides by register renaming (slot t mod BAND), as do M and the gap
//    states; each step loads one new base and stops at the read's length.
//  - The state carried from row to row is T, Ix and ug (3 BAND registers)
//    plus the window: 4 * BAND + temporaries. __launch_bounds__ fixes the
//    blocks each band width keeps resident (min_blocks), for the register
//    budget that leaves: 7 blocks of 128 at W = 5, so the 16,384-read batch
//    (2,048 blocks) takes 2.2 waves; 8 blocks (1.94 waves) forced
//    recomputation and measured slower (PERF.md).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kNeg = -(1 << 28);
constexpr int kThreads = 128;          // pairs of a block (fewer if too long)
constexpr size_t kMaxSmem = 232448;    // dynamic shared memory of a block

// blocks of kThreads resident per SM for each band width, which leaves
// 65,536 / (kThreads * n) registers a thread: 64 up to W = 4 (the staging
// spills under fewer), 72 at W = 5 (under 64 ptxas recomputes part of the
// Iy walk, 27 add-max a row for 19, and the kernel ran slower), then 80, 96
__host__ __device__ constexpr int min_blocks(int band) {
  return band <= 9 ? 8 : band <= 11 ? 7 : band <= 13 ? 6 : 5;
}

// int32 words of one score row: >= 5 L and = 8 (mod 32), so the rows of the
// four oriented reads of a warp (C = 8) sit on disjoint banks
int row_words(int L) { return (5 * L + 23) / 32 * 32 + 8; }

int rows_per_block(int T, int C) {
  return T % C == 0 ? T / C : (T - 1) / C + 2;
}

// int32 words of one pair's window: the aligned words it overlaps, odd
int window_words(int win) { return ((win + 3) / 4 + 1) | 1; }

struct Plan {
  int threads, n_rows, rs, wpw;
  size_t smem;
};

// the largest block (128, 64 or 32 pairs) whose rows and windows fit
Plan plan_for(int C, int L, int W) {
  Plan pl{kThreads, 0, row_words(L), window_words(L + 2 * W), 0};
  for (;;) {
    pl.n_rows = rows_per_block(pl.threads, C);
    pl.smem = ((size_t)pl.n_rows * pl.rs + (size_t)pl.threads * pl.wpw) * 4;
    if (pl.smem <= kMaxSmem || pl.threads == 32) return pl;
    pl.threads /= 2;
  }
}

__device__ __forceinline__ int32_t lds(const unsigned char* smem, int off) {
  return *reinterpret_cast<const int32_t*>(smem + off);
}

template <int BAND>
__device__ __forceinline__ void finish(const int32_t (&m)[BAND],
                                       const int32_t (&ug)[BAND], int p,
                                       int32_t* dp_score, int32_t* dp_j,
                                       int32_t* ug_score, int32_t* ug_j) {
  int32_t best_m = m[0], best_u = ug[0];
  int jm = 0, ju = 0;
#pragma unroll
  for (int j = 1; j < BAND; ++j) {
    if (m[j] > best_m) {
      best_m = m[j];
      jm = j;
    }
    if (ug[j] > best_u) {
      best_u = ug[j];
      ju = j;
    }
  }
  dp_score[p] = best_m;
  dp_j[p] = jm;
  ug_score[p] = best_u;
  ug_j[p] = ju;
}

template <int BAND>
__global__ void __launch_bounds__(kThreads, min_blocks(BAND))
extend_kernel(const int32_t* __restrict__ reads2,
              const int32_t* __restrict__ lengths,
              const int32_t* __restrict__ cand_diag,
              const int8_t* __restrict__ ref, int G,
              const int32_t* __restrict__ s_fwd,
              const int32_t* __restrict__ s_comp, int P, int C, int L,
              int rs, int n_rows, int wpw, int go, int ge,
              int32_t* __restrict__ dp_score, int32_t* __restrict__ dp_j,
              int32_t* __restrict__ ug_score, int32_t* __restrict__ ug_j) {
  constexpr int W = BAND / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* rows = reinterpret_cast<int32_t*>(smem);      // [n_rows][rs]
  unsigned char* wins = smem + (size_t)n_rows * rs * 4;  // [T][wpw * 4]
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * T;
  const int p_end = P - p0 < T ? P : p0 + T;
  const int b2_first = p0 / C;
  const int win = L + 2 * W;

  // 1. reference windows: each warp puts its 32 pairs' windows in flight
  // at once with cp.async, item f = lane + 32 n taking word f % nw1 of pair
  // f / nw1: the nw1 aligned words a pair's window overlaps, raw, into wpw
  // words of shared memory (wpw odd: the threads' byte loads of one step
  // fall on distinct banks); the window then starts at byte base & 3. A
  // window that leaves [0, G) (or a reference not 4-byte aligned) is
  // written byte by byte by its own thread, N outside [0, G).
  const int p = p0 + tid;
  const int lane = tid & 31, warp0 = tid & ~31;
  const int nw1 = ((win + 3) >> 2) + 1;           // words a window overlaps
  const bool aligned = (reinterpret_cast<uintptr_t>(ref) & 3) == 0;
  int my_base = 0;
  if (p < P) my_base = min(max(cand_diag[p], -(win + 1)), G) - W;
  const bool my_fast = p < P && aligned && my_base >= 0 &&
                       (my_base & ~3) <= G - 4 * nw1;
  const uint32_t win_s = static_cast<uint32_t>(__cvta_generic_to_shared(wins));
  for (int f = lane; f < 32 * nw1; f += 32) {
    const int q = f / nw1, k = f - q * nw1;
    const int base = __shfl_sync(0xffffffffu, my_base, q);
    const int fast = __shfl_sync(0xffffffffu, (int)my_fast, q);
    if (fast) {
      const int8_t* src = ref + (base & ~3) + 4 * k;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       win_s + ((warp0 + q) * wpw + k) * 4),
                   "l"(src));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  unsigned char* my_win = wins + tid * wpw * 4;
  if (p < P && !my_fast) {
    for (int t = 0; t < win; ++t) {
      const int r = my_base + t;
      my_win[t] = (unsigned char)((r >= 0 && r < G) ? ref[r] : 4);
    }
  }

  // 2. score rows of the block's oriented reads, while the windows arrive:
  // eight items a thread at a time, each round's loads in flight together
  // (the read codes, coalesced, then the table entries they select)
  const int rows_here = (p_end - 1) / C - b2_first + 1;
  const int n_items = rows_here * L;
  const int32_t* rd = reads2 + (size_t)b2_first * L;
  for (int k0 = tid; k0 < n_items; k0 += 8 * T) {
    int code[8], len[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = k0 + u * T;
      code[u] = k < n_items ? rd[k] : 0;
      len[u] = k < n_items ? lengths[(b2_first + k / L) >> 1] : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = k0 + u * T;
      const int r = k / L, i = k - r * L;
      if (k >= n_items || i >= len[u]) continue;
      const int strand = (b2_first + r) & 1;
      const int prof = strand == 0 ? i : min(max(len[u] - 1 - i, 0), L - 1);
      const int32_t* t = (strand ? s_comp : s_fwd) + prof * 25 + code[u];
      int32_t* row = rows + r * rs + i * 5;
#pragma unroll
      for (int c = 0; c < 5; ++c) row[c] = __ldg(t + c * 5);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (p >= P) return;

  const int b2 = p / C;
  const int steps = min(lengths[b2 >> 1], L);
  if (steps <= 0) {
    dp_score[p] = kNeg;
    dp_j[p] = 0;
    ug_score[p] = 0;
    ug_j[p] = 0;
    return;
  }
  const int row = (b2 - b2_first) * rs * 4;  // byte offset of the score row
  const unsigned char* wp = my_win + (my_fast ? my_base & 3 : 0);
  int32_t w[BAND];  // w[t % BAND] = row + 20 t + 4 code(t)
#pragma unroll
  for (int k = 0; k < BAND; ++k) w[k] = row + 20 * k + 4 * wp[k];
  wp += BAND;
  int wrow = row + 20 * BAND;  // row + 20 t of the block's first reload
  int rem = steps;             // rows left from the block's first row

  const int32_t nge = -ge;
  // Ix of the band's last diagonal: max(NEG - go, NEG - ge)
  const int32_t ix_last = __viaddmax_s32(kNeg, nge, kNeg - go);
  int32_t tt[BAND], ix[BAND], ug[BAND];
#pragma unroll
  for (int j = 0; j < BAND; ++j) {
    tt[j] = 0;      // row 0: M = sub
    ix[j] = kNeg;   // Ix of row 0
    ug[j] = 0;
  }

  for (;;) {
#pragma unroll
    for (int r = 0; r < BAND; ++r) {  // row i = first row + r
      int32_t m[BAND], mg[BAND], iy[BAND];
#pragma unroll
      for (int j = 0; j < BAND; ++j) {
        const int32_t s = lds(smem, w[(r + j) % BAND] - 20 * j);
        m[j] = s + tt[j];
        ug[j] += s;
      }
      if (rem <= r + 1) {
        finish<BAND>(m, ug, p, dp_score, dp_j, ug_score, ug_j);
        return;
      }
#pragma unroll
      for (int j = 0; j < BAND; ++j) mg[j] = m[j] - go;
      iy[0] = kNeg;
      if constexpr (BAND > 1) iy[1] = mg[0];
#pragma unroll
      for (int j = 2; j < BAND; ++j)
        iy[j] = __viaddmax_s32(iy[j - 1], nge, mg[j - 1]);
#pragma unroll
      for (int j = 0; j < BAND; ++j) tt[j] = __vimax3_s32(m[j], ix[j], iy[j]);
#pragma unroll
      for (int j = 0; j + 1 < BAND; ++j)
        ix[j] = __viaddmax_s32(ix[j + 1], nge, mg[j + 1]);
      ix[BAND - 1] = ix_last;
      // slot r held t = i; it takes t = i + BAND (< L + 2W: i + 1 < steps)
      w[r] = wrow + 20 * r + 4 * wp[r];
    }
    rem -= BAND;
    wp += BAND;
    wrow += 20 * BAND;
  }
}

template <int BAND>
cudaError_t set_smem(const Plan& pl) {
  if (pl.smem > kMaxSmem) return cudaErrorInvalidValue;
  if (pl.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(extend_kernel<BAND>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)pl.smem);
}

template <int BAND>
cudaError_t launch(const int32_t* reads2, const int32_t* lengths,
                   const int32_t* cand_diag, const int8_t* ref, int G,
                   const int32_t* s_fwd, const int32_t* s_comp, int P, int C,
                   int L, int go, int ge, int32_t* dp_score, int32_t* dp_j,
                   int32_t* ug_score, int32_t* ug_j, cudaStream_t stream) {
  const Plan pl = plan_for(C, L, BAND / 2);
  const cudaError_t e = set_smem<BAND>(pl);
  if (e != cudaSuccess) return e;
  const int blocks = (int)(((long long)P + pl.threads - 1) / pl.threads);
  extend_kernel<BAND><<<blocks, pl.threads, pl.smem, stream>>>(
      reads2, lengths, cand_diag, ref, G, s_fwd, s_comp, P, C, L, pl.rs,
      pl.n_rows, pl.wpw, go, ge, dp_score, dp_j, ug_score, ug_j);
  return cudaGetLastError();
}

template <int BAND>
cudaError_t occupancy(int C, int L, int* out) {
  const Plan pl = plan_for(C, L, BAND / 2);
  cudaError_t e = set_smem<BAND>(pl);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, extend_kernel<BAND>, pl.threads, pl.smem);
  out[0] = pl.threads;
  out[1] = (int)pl.smem;
  out[2] = blocks;
  return e;
}

}  // namespace

extern "C" int ps_extend_candidates(const void* reads2, const void* lengths,
                                    const void* cand_diag, const void* ref,
                                    const void* s_fwd, const void* s_comp,
                                    int G, int B2, int C, int L, int W, int go,
                                    int ge, void* dp_score, void* dp_j,
                                    void* ug_score, void* ug_j, void* stream) {
  const auto* r = static_cast<const int32_t*>(reads2);
  const auto* ln = static_cast<const int32_t*>(lengths);
  const auto* cd = static_cast<const int32_t*>(cand_diag);
  const auto* rf = static_cast<const int8_t*>(ref);
  const auto* sf = static_cast<const int32_t*>(s_fwd);
  const auto* sc = static_cast<const int32_t*>(s_comp);
  auto* o0 = static_cast<int32_t*>(dp_score);
  auto* o1 = static_cast<int32_t*>(dp_j);
  auto* o2 = static_cast<int32_t*>(ug_score);
  auto* o3 = static_cast<int32_t*>(ug_j);
  const int P = B2 * C;
  const auto st = static_cast<cudaStream_t>(stream);
#define PS_EXTEND_CASE(w)                                                   \
  case w:                                                                   \
    return (int)launch<2 * (w) + 1>(r, ln, cd, rf, G, sf, sc, P, C, L, go, \
                                    ge, o0, o1, o2, o3, st);
  switch (W) {
    PS_EXTEND_CASE(0)
    PS_EXTEND_CASE(1)
    PS_EXTEND_CASE(2)
    PS_EXTEND_CASE(3)
    PS_EXTEND_CASE(4)
    PS_EXTEND_CASE(5)
    PS_EXTEND_CASE(6)
    PS_EXTEND_CASE(7)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PS_EXTEND_CASE
}

// The launch shape of a (C, L, W) call -> out[0] threads a block, out[1]
// dynamic shared memory bytes, out[2] blocks resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t.
extern "C" int ps_extend_occupancy(int C, int L, int W, int* out) {
#define PS_EXTEND_OCC(w) \
  case w:                \
    return (int)occupancy<2 * (w) + 1>(C, L, out);
  switch (W) {
    PS_EXTEND_OCC(0)
    PS_EXTEND_OCC(1)
    PS_EXTEND_OCC(2)
    PS_EXTEND_OCC(3)
    PS_EXTEND_OCC(4)
    PS_EXTEND_OCC(5)
    PS_EXTEND_OCC(6)
    PS_EXTEND_OCC(7)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PS_EXTEND_OCC
}
