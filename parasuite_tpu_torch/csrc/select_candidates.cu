// Candidate selection, one warp per oriented read, the row in registers
// (rows of up to 1,024 diagonals), or one block per read, the row in shared
// memory (2,048 and 4,096: select_wide_kernel below).
//
// Replaces parasuite_tpu/ops/pallas_seed.py::_select_kernel (line 40; launched
// by select_candidates_pallas, pl.pallas_call at line 103) and, on the main
// path, the seeding before it (parasuite_tpu/ops/aligner.py seed_diagonals).
// Contract: parasuite_tpu/ops/aligner.py select_candidates over
// seed_diagonals' rows — top C unique diagonals per row by (votes desc, diag
// asc); exhausted slots are (I32MAX, false).
//
// Where a row comes from is the kernels' template policy:
//   * SeedRows (the main path, ps_seed_select): the kernel builds the row of
//     oriented read r itself, from the read's codes (int32 [rows, L]), its
//     length and the k-mer index (bucket_starts, positions), exactly as
//     seed_diagonals does: seed s at offset min(s * step, L - 1) with the
//     read's adaptive step max((len - k) / (S - 1), 1), or at s * stride;
//     skipped when the k-mer overruns the read, holds an N (a position past
//     L counts as one) or has 0 or more than M occurrences; else entry
//     s * M + j is positions[lo + j] - offset for j < count. Entries past
//     S * M, and empty ones, are I32MAX. The row never exists in device
//     memory: in registers (a warp's lanes make one seed each and hand
//     (lo, count, offset) round by __shfl_sync) or in the block's shared
//     memory;
//   * DiagRows (ps_select_candidates): a row of n diagonals read from an
//     int32 [rows, n] matrix (chip_smoke.py's kernel table, the width
//     tests).
// A sort needs no order, so both give the same results from the same
// multiset; the sorting network, the votes and the top-C rounds are written
// once.
//
// What bounds it on an H100: the function is bound by bytes. With SeedRows a
// row is the read's codes (4 * L bytes), S bucket pairs and the filled
// positions (at most 4 * S * M bytes) in and 5 * C bytes out; with DiagRows
// n * 4 bytes in (131,072 rows of 112 diagonals: 64 MB, ~0.02 ms at
// 3.35 TB/s). A comparison sort of the row needs about n * log2(n) compares,
// less time than the bytes at every width here. What this kernel spends
// above that bound is instructions: its sorting network takes
// n_pad/2 * log2(n_pad) * (log2(n_pad)+1)/2 compare-exchanges (1,792 at
// n_pad = 128), each a min and a max on the int32 pipe (64 lanes per SM per
// clock), and the strides that cross lanes go through the shuffle unit
// (32 lanes per SM per clock); the positions are gathers of 16 neighbouring
// int32 a seed.
//
// What the design does to keep those instructions few and cheap:
//   * The row never touches shared memory. Each lane holds E = n_pad / 32
//     entries in registers (a template parameter, E in {1, 2, 4, 8, 16, 32});
//     entry r of a lane sits at sorted position lane * E + r. The row is
//     loaded striped across the warp (register r of lane l holds entry
//     r * 32 + l; DiagRows with 128-bit loads; order does not matter before
//     a sort) and padded with I32MAX.
//   * The bitonic network is written so that every compare-exchange is
//     ascending: a merge of size k first pairs p with p ^ (k - 1), then with
//     p ^ j for j = k/4 .. 1. Pairs inside a lane are a min and a max between
//     two registers; pairs across lanes are one __shfl_xor_sync per entry.
//     Every loop is unrolled, so register indices, strides and directions
//     are constants: no barrier, no dynamic indexing.
//   * Votes need no walk: a run starts where an entry differs from its
//     predecessor (the previous lane's last entry by __shfl_up_sync), and
//     its length is the next run start minus its own position — a suffix
//     minimum of run-start positions inside the lane and then over lanes
//     (5 shuffle steps), the formula of the plain version.
//   * The top C need no scan of the row and no 64-bit key. Entries are in
//     diagonal order inside a lane and over lanes, so the winner of a round
//     is the smallest -votes (one __reduce_min_sync over each lane's own
//     minimum), in the lowest lane that holds it (__ballot_sync + __ffs), at
//     that lane's lowest register; only that lane rescans its E registers.
//     Lane c keeps result c, so a row's results leave in one store per
//     output array.
//
// ptxas -v (nvcc 12.9, sm_90a) at E = 1 .. 32: DiagRows 28 / 30 / 32 / 37 /
// 55 / 80 registers, an 8-byte stack frame at E = 32 alone; SeedRows 28 /
// 31 / 32 / 39 / 48 / 80, an 8-byte frame at E = 16 and 32 (the main path's
// E = 4 spills nothing).
//
// Rows wider than 1,024 (max_seeds x max_occ past the bench operating point,
// e.g. 17 seeds x 64 occurrences) do not fit a warp's registers. They take
// select_wide_kernel: one block of 256 threads per row, the row padded to
// NP = 2,048 or 4,096 entries in shared memory (8 or 16 KB, plus as much for
// the keys; SeedRows makes 256 seeds at a time into the keys' space first),
// the same all-ascending network with a __syncthreads() between stages,
// votes by a binary search for the end of each run in the sorted row, and
// the top C by C block-wide minima of one int32 key per entry,
// (NP - votes) * NP + position, which orders by (votes desc, diagonal asc)
// because the row is in diagonal order. A simple kernel that is right: its
// time is written down, not tuned.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kI32Max = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps (rows) per block

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x >> 1);
}

__device__ __forceinline__ void order(int32_t& a, int32_t& b) {
  const int32_t lo = min(a, b), hi = max(a, b);
  a = lo;
  b = hi;
}

// ---------------------------------------------------------------------------
// row sources
// ---------------------------------------------------------------------------

constexpr int kWideThreads = 256;

// A row of n diagonals from an int32 [rows, n] matrix.
struct DiagRows {
  const int32_t* diags;
  int n;

  // register r of `lane` <- entry r * 32 + lane (I32MAX past n)
  template <int E>
  __device__ __forceinline__ void load(int row, int lane,
                                       int32_t (&v)[E]) const {
    const int32_t* src = diags + (size_t)row * n;
    if constexpr (E >= 4) {
      if ((n & 3) == 0) {  // rows start on 16-byte boundaries
#pragma unroll
        for (int g = 0; g < E / 4; ++g) {
          const int q = (g * 32 + lane) * 4;
          int4 x = make_int4(kI32Max, kI32Max, kI32Max, kI32Max);
          if (q < n) x = __ldg(reinterpret_cast<const int4*>(src + q));
          v[4 * g] = x.x;
          v[4 * g + 1] = x.y;
          v[4 * g + 2] = x.z;
          v[4 * g + 3] = x.w;
        }
        return;
      }
    }
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int q = r * 32 + lane;
      v[r] = q < n ? __ldg(src + q) : kI32Max;
    }
  }

  // s[p] <- entry p for p < NP (I32MAX past n), by the block's threads
  template <int NP>
  __device__ __forceinline__ void fill(size_t row, int t, int32_t* s,
                                       int32_t* /*scratch*/) const {
    const int32_t* src = diags + row * n;
    for (int p = t; p < NP; p += kWideThreads)
      s[p] = p < n ? __ldg(src + p) : kI32Max;
  }
};

// The row of oriented read `row` (two rows a read: forward, reverse
// complement), made from its codes and the k-mer index as seed_diagonals
// makes it: entry s * M + j is seed s's j-th occurrence minus its offset.
struct SeedRows {
  const int32_t* oriented;       // [rows, L] codes 0..4
  const int32_t* lengths;        // [rows / 2]
  const int32_t* bucket_starts;  // [4^k + 1]
  const int32_t* positions;      // [n_pos]
  int L, k, S, M;
  int stride;    // the fixed offset step (used when !adaptive)
  int adaptive;  // offsets min(s * max((len - k) / (S - 1), 1), L - 1)

  __device__ __forceinline__ int step(int len) const {
    // (len - k) / (S - 1) truncates where torch floors; both are below 1
    // exactly when the other is, and the step is at least 1
    return adaptive ? max((len - k) / (S - 1), 1) : stride;
  }

  // seed s of a read -> (lo, count, offset); count 0 unless the seed is used
  __device__ __forceinline__ void seed(const int32_t* read, int len, int st,
                                       int s, int32_t& lo, int32_t& cnt,
                                       int32_t& off) const {
    off = adaptive ? min(s * st, L - 1) : s * st;
    lo = 0;
    cnt = 0;
    if (off + k > len) return;  // the k-mer overruns the read
    uint32_t code = 0;
    for (int q = 0; q < k; ++q) {
      const int p = off + q;
      const int32_t c = p < L ? __ldg(read + p) : 4;
      if ((uint32_t)c > 3u) return;  // N
      code = code * 4u + (uint32_t)c;
    }
    lo = __ldg(bucket_starts + code);
    const int32_t n = __ldg(bucket_starts + code + 1) - lo;
    if (n > 0 && n <= M) cnt = n;
  }

  // lane l makes seeds l, l + 32, ...; register r of every lane takes entry
  // e = r * 32 + lane from the lane that made seed e / M
  template <int E>
  __device__ __forceinline__ void load(int row, int lane,
                                       int32_t (&v)[E]) const {
    const int32_t* read = oriented + (size_t)row * L;
    const int len = __ldg(lengths + (row >> 1));
    const int st = step(len);
    const int n = S * M;
#pragma unroll
    for (int r = 0; r < E; ++r) v[r] = kI32Max;
    for (int g = 0; g * 32 < S; ++g) {  // seeds 32g .. 32g + 31
      int32_t lo = 0, cnt = 0, off = 0;
      if (g * 32 + lane < S) seed(read, len, st, g * 32 + lane, lo, cnt, off);
      const int e0 = g * 32 * M, e1 = min(e0 + 32 * M, n);
#pragma unroll
      for (int r = 0; r < E; ++r) {
        if (r * 32 >= e1 || r * 32 + 32 <= e0) continue;  // warp-uniform
        const int e = r * 32 + lane;
        const int sd = e / M;
        const int j = e - sd * M;
        const int from = (sd - g * 32) & 31;
        const int32_t s_lo = __shfl_sync(kFull, lo, from);
        const int32_t s_cnt = __shfl_sync(kFull, cnt, from);
        const int32_t s_off = __shfl_sync(kFull, off, from);
        if (e >= e0 && e < e1 && j < s_cnt)
          v[r] = __ldg(positions + s_lo + j) - s_off;
      }
    }
  }

  // kWideThreads seeds at a time into scratch (3 * kWideThreads int32),
  // then their entries into s
  template <int NP>
  __device__ __forceinline__ void fill(size_t row, int t, int32_t* s,
                                       int32_t* scratch) const {
    constexpr int T = kWideThreads;
    const int32_t* read = oriented + row * L;
    const int len = __ldg(lengths + (row >> 1));
    const int st = step(len);
    const int n = S * M;
    for (int p = t; p < NP; p += T) s[p] = kI32Max;
    for (int g = 0; g * T < S; ++g) {
      int32_t lo = 0, cnt = 0, off = 0;
      if (g * T + t < S) seed(read, len, st, g * T + t, lo, cnt, off);
      __syncthreads();  // the last round's entries are written
      scratch[t] = lo;
      scratch[T + t] = cnt;
      scratch[2 * T + t] = off;
      __syncthreads();
      const int e0 = g * T * M, e1 = min(e0 + T * M, n);
      for (int e = e0 + t; e < e1; e += T) {
        const int sl = (e - e0) / M;
        const int j = (e - e0) - sl * M;
        if (j < scratch[T + sl])
          s[e] = __ldg(positions + scratch[sl] + j) - scratch[2 * T + sl];
      }
    }
  }
};

// ---------------------------------------------------------------------------
// rows of up to 1,024 entries: one warp a row, the row in registers
// ---------------------------------------------------------------------------

template <int E, class Src>
__global__ void __launch_bounds__(kWarps * 32)
    select_kernel(const Src src, int rows, int C, int32_t* __restrict__ cand,
                  uint8_t* __restrict__ valid) {
  constexpr int NP = 32 * E;
  constexpr int LOG_E = ilog2(E);
  constexpr int LOG_NP = 5 + LOG_E;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp exits together

  int32_t v[E];
  src.template load<E>(row, lane, v);

  // bitonic sort, every compare-exchange ascending; position = lane * E + r
#pragma unroll
  for (int lk = 1; lk <= LOG_NP; ++lk) {
    // merge of size k = 2^lk: position p against p ^ (k - 1) ...
    if (lk <= LOG_E) {
      const int k = 1 << lk;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const int q = r ^ (k - 1);
        if (q > r) order(v[r], v[q]);
      }
    } else {
      const int lanes = 1 << (lk - LOG_E);  // lanes in one merge
      const bool lower = (lane & (lanes >> 1)) == 0;
      int32_t o[E];
#pragma unroll
      for (int r = 0; r < E; ++r)
        o[r] = __shfl_xor_sync(kFull, v[E - 1 - r], lanes - 1);
#pragma unroll
      for (int r = 0; r < E; ++r)
        v[r] = lower ? min(v[r], o[r]) : max(v[r], o[r]);
    }
    // ... then against p ^ j for j = k/4 .. 1
#pragma unroll
    for (int lj = lk - 2; lj >= 0; --lj) {
      if (lj >= LOG_E) {
        const int lm = 1 << (lj - LOG_E);
        const bool lower = (lane & lm) == 0;
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const int32_t o = __shfl_xor_sync(kFull, v[r], lm);
          v[r] = lower ? min(v[r], o) : max(v[r], o);
        }
      } else {
        const int j = 1 << lj;
#pragma unroll
        for (int r = 0; r < E; ++r)
          if ((r & j) == 0) order(v[r], v[r | j]);
      }
    }
  }

  // run starts; fidx = own position at a run start, else NP
  const int p0 = lane * E;
  const int32_t before = __shfl_up_sync(kFull, v[E - 1], 1);
  int32_t fidx[E];
  fidx[0] = (lane == 0 || v[0] != before) ? p0 : NP;
#pragma unroll
  for (int r = 1; r < E; ++r) fidx[r] = v[r] != v[r - 1] ? p0 + r : NP;
  int32_t lane_first = fidx[0];
#pragma unroll
  for (int r = 1; r < E; ++r) lane_first = min(lane_first, fidx[r]);
  // next run start after this lane: suffix minimum over the lanes above
  int32_t suffix = lane_first;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t t = __shfl_down_sync(kFull, suffix, off);
    if (lane + off < 32) suffix = min(suffix, t);
  }
  int32_t next_first = __shfl_down_sync(kFull, suffix, 1);
  if (lane == 31) next_first = NP;
  // negv = -votes at the run start of a valid diagonal, else 1 (as the
  // reference's sort key); walk the lane's entries from the top
  int32_t negv[E];
#pragma unroll
  for (int r = E - 1; r >= 0; --r) {
    const bool first = fidx[r] != NP;
    negv[r] = (first && v[r] != kI32Max) ? (p0 + r) - next_first : 1;
    next_first = min(next_first, fidx[r]);
  }

  // the lane's best: smallest negv, at its lowest register (smallest diag)
  int32_t bn = 1, bd = kI32Max;
#pragma unroll
  for (int r = 0; r < E; ++r)
    if (negv[r] < bn) {
      bn = negv[r];
      bd = v[r];
    }

  int32_t* out_c = cand + (size_t)row * C;
  uint8_t* out_v = valid + (size_t)row * C;
  int32_t my_c = kI32Max;
  uint8_t my_v = 0;
  bool exhausted = false;  // warp-uniform
  for (int c = 0; c < C; ++c) {
    int32_t win_d = kI32Max;
    uint8_t win_v = 0;
    if (!exhausted) {
      const int32_t m = __reduce_min_sync(kFull, bn);
      if (m >= 1) {
        exhausted = true;
      } else {
        const int w = __ffs(__ballot_sync(kFull, bn == m)) - 1;
        win_d = __shfl_sync(kFull, bd, w);
        win_v = 1;
        if (lane == w) {  // knock the winner out, find the lane's next best
          bool done = false;
          bn = 1;
          bd = kI32Max;
#pragma unroll
          for (int r = 0; r < E; ++r) {
            if (!done && negv[r] == m) {
              negv[r] = 1;
              done = true;
            }
            if (negv[r] < bn) {
              bn = negv[r];
              bd = v[r];
            }
          }
        }
      }
    }
    if (lane == (c & 31)) {
      my_c = win_d;
      my_v = win_v;
    }
    if ((c & 31) == 31 || c == C - 1) {
      const int slot = (c & ~31) + lane;
      if (slot <= c) {
        out_c[slot] = my_c;
        out_v[slot] = my_v;
      }
    }
  }
}

template <int E, class Src>
cudaError_t launch(const Src& src, int rows, int C, int32_t* cand,
                   uint8_t* valid, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  select_kernel<E, Src><<<blocks, kWarps * 32, 0, stream>>>(src, rows, C,
                                                            cand, valid);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wide rows: one block per row, the row in shared memory
// ---------------------------------------------------------------------------

template <int NP, class Src>
__global__ void __launch_bounds__(kWideThreads)
    select_wide_kernel(const Src src, int C, int32_t* __restrict__ cand,
                       uint8_t* __restrict__ valid) {
  constexpr int T = kWideThreads;
  constexpr int kNone = (NP + 1) * NP;  // key of an entry that is no result
  __shared__ int32_t s[NP];             // the row, then sorted
  __shared__ int32_t key[NP];           // (NP - votes) * NP + position
  __shared__ int32_t warp_min[T / 32];
  __shared__ int32_t winner;
  const int t = threadIdx.x;
  const size_t row = blockIdx.x;
  static_assert(3 * T <= NP, "the seeds' scratch lives in key");

  src.template fill<NP>(row, t, s, key);
  __syncthreads();

  // bitonic sort, every compare-exchange ascending: a merge of size k pairs
  // p with p ^ (k - 1), then with p ^ j for j = k/4 .. 1
  for (int k = 2; k <= NP; k <<= 1) {
    const int half = k >> 1;
    for (int i = t; i < NP / 2; i += T) {
      const int base = (i / half) * k, off = i % half;
      const int lo = base + off, hi = base + k - 1 - off;
      const int32_t a = s[lo], b = s[hi];
      if (a > b) {
        s[lo] = b;
        s[hi] = a;
      }
    }
    __syncthreads();
    for (int j = k >> 2; j >= 1; j >>= 1) {
      for (int i = t; i < NP / 2; i += T) {
        const int lo = 2 * j * (i / j) + (i % j), hi = lo + j;
        const int32_t a = s[lo], b = s[hi];
        if (a > b) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  // votes of the run that starts at p: the first position after p whose
  // diagonal is larger, minus p (binary search in the sorted row)
  int32_t best = kNone;  // this thread's smallest key, positions t, t+T, ...
  for (int p = t; p < NP; p += T) {
    const int32_t d = s[p];
    int32_t kv = kNone;
    if (d != kI32Max && (p == 0 || s[p - 1] != d)) {
      int lo = p + 1, hi = NP;  // first q in [p + 1, NP] with s[q] > d
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s[mid] > d) hi = mid; else lo = mid + 1;
      }
      kv = (NP - (lo - p)) * NP + p;
    }
    key[p] = kv;
    best = min(best, kv);
  }

  int32_t* out_c = cand + row * C;
  uint8_t* out_v = valid + row * C;
  for (int c = 0; c < C; ++c) {
    const int32_t wm = __reduce_min_sync(kFull, best);
    if ((t & 31) == 0) warp_min[t >> 5] = wm;
    __syncthreads();
    if (t == 0) {
      int32_t m = warp_min[0];
#pragma unroll
      for (int w = 1; w < T / 32; ++w) m = min(m, warp_min[w]);
      winner = m;
      const bool found = m < kNone;
      out_c[c] = found ? s[m % NP] : kI32Max;
      out_v[c] = found ? 1 : 0;
    }
    __syncthreads();
    const int32_t m = winner;
    if (m < kNone && (m % NP) % T == t) {  // the owner knocks it out
      key[m % NP] = kNone;
      best = kNone;
      for (int p = t; p < NP; p += T) best = min(best, key[p]);
    }
  }
}

template <int NP, class Src>
cudaError_t launch_wide(const Src& src, int rows, int C, int32_t* cand,
                        uint8_t* valid, cudaStream_t stream) {
  select_wide_kernel<NP, Src><<<rows, kWideThreads, 0, stream>>>(src, C, cand,
                                                                 valid);
  return cudaGetLastError();
}

// one launch of the kernel of width n_pad over `rows` rows from src
template <class Src>
cudaError_t dispatch(const Src& src, int rows, int n_pad, int C, int32_t* cand,
                     uint8_t* valid, cudaStream_t stream) {
  switch (n_pad) {
    case 32:
      return launch<1>(src, rows, C, cand, valid, stream);
    case 64:
      return launch<2>(src, rows, C, cand, valid, stream);
    case 128:
      return launch<4>(src, rows, C, cand, valid, stream);
    case 256:
      return launch<8>(src, rows, C, cand, valid, stream);
    case 512:
      return launch<16>(src, rows, C, cand, valid, stream);
    case 1024:
      return launch<32>(src, rows, C, cand, valid, stream);
    case 2048:
      return launch_wide<2048>(src, rows, C, cand, valid, stream);
    case 4096:
      return launch_wide<4096>(src, rows, C, cand, valid, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ps_select_candidates(const void* diags, int rows, int n,
                                    int n_pad, int C, void* cand, void* valid,
                                    void* stream) {
  if (n < 1 || n > n_pad || C < 1) return (int)cudaErrorInvalidValue;
  const DiagRows src{static_cast<const int32_t*>(diags), n};
  return (int)dispatch(src, rows, n_pad, C, static_cast<int32_t*>(cand),
                       static_cast<uint8_t*>(valid),
                       static_cast<cudaStream_t>(stream));
}

// rows = 2 x reads of oriented int32 [rows, L]; rows of S * M entries
extern "C" int ps_seed_select(const void* oriented, const void* lengths,
                              const void* bucket_starts, const void* positions,
                              int rows, int L, int k, int S, int M, int stride,
                              int adaptive, int n_pad, int C, void* cand,
                              void* valid, void* stream) {
  if (L < 1 || k < 1 || k > 15 || S < 1 || M < 1 || S * M > n_pad ||
      C < 1 || (adaptive && S < 2))
    return (int)cudaErrorInvalidValue;
  const SeedRows src{static_cast<const int32_t*>(oriented),
                     static_cast<const int32_t*>(lengths),
                     static_cast<const int32_t*>(bucket_starts),
                     static_cast<const int32_t*>(positions),
                     L, k, S, M, stride, adaptive};
  return (int)dispatch(src, rows, n_pad, C, static_cast<int32_t*>(cand),
                       static_cast<uint8_t*>(valid),
                       static_cast<cudaStream_t>(stream));
}
