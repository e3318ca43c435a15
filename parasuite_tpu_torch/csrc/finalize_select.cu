// Finalize's selection half (ops/aligner.py finalize_core), one warp per
// read, the read's n = 2C entries in registers.
//
// Replaces no Pallas kernel: the JAX package leaves finalize_core
// (parasuite_tpu/ops/aligner.py:368) to XLA, which fuses its [B, n, n]
// dedupe compares and its [B, L] window into loops that hold neither. Run op
// by op in PyTorch, finalize_core writes each of them to device memory: at
// 65,536 reads [B, 16, 16] bool masks of 16.8 MB each (same, better, tie's
// products, same & better & valid) and the window's int32 and int64 [B, 50]
// indexes and bases, ~184 MB above the step, the step's memory peak. This
// kernel computes the same function bit for bit and writes only its outputs.
//
// Contract (finalize_core; src, nm_pos and nm_strand optional):
//   * dedupe: entry i is a duplicate when a valid entry j with the same
//     (strand, pos_key) is strictly better: dps[j] > dps[i], or equal and a
//     lower tier, (src[j], j) < (src[i], i) with src and j < i without;
//   * uv = valid & !dup. The best score is the largest of (uv ? dps : NEG)
//     over the row; then the least strand among uv entries at it (2 if none),
//     the least pos_key among those (I32MAX if none) and the first such
//     index (0 if none): best_idx;
//   * has = any uv, X0 = uv entries at the best score, X1 = uv entries below
//     it; MAPQ 0 if X0 > 1, 37 if X1 == 0, else
//     max(23 - mapq_sub[min(X1, 255)], 0);
//   * the picks at best_idx; the chromosome of the picked pos (the last
//     start <= pos, clamped to the first), mapped = has & the read's span
//     inside it & length > 0;
//   * the ungapped NM and machine-frame T->C over min(L, length) bases from
//     nm_pos on oriented strand nm_strand: a base mismatches where the
//     reference base (N outside [0, G)) differs from the read's or either is
//     N; T->C is reference T (3) under read C (1) on strand 0, reference A
//     (0) under read G (2) on strand 1;
//   * every AlignResult field under its where(mapped, ...) mask, and
//     best_idx. int32 sums wrap, as PyTorch's do.
//
// What bounds it on an H100: bytes. A read is its n entries' valid (a
// byte), pos_key and dps (4 bytes each), strand (4, unless it is the plain
// step's one broadcast row) and, in the combined step, src (4); ug_eq,
// diag, nm_pos and nm_strand at the pick; min(L, length) int32 bases of one
// oriented strand and as many bytes of ref_seq; its length; and 42 bytes
// out: ~450 bytes at n = 16, L = 50. Its arithmetic, ~n^2 compares (256 at
// n = 16), is far below the bytes' time.
//
// What the design does about it:
//   * One warp a read, eight reads a block. Lane l holds entries l, l + 32,
//     ... in E registers (a template on E in {1, 2, 4, 8}: n up to 256),
//     loaded striped, so a warp's loads of a field are coalesced. At n <= 16
//     half the lanes hold nothing. A read is a chain of dependent steps
//     (its entries, the dedupe, the reductions, the picks, the chromosome,
//     the window), and that chain's latency, not the bytes, sets the time:
//     at 65,536 reads back to back the kernel reaches a tenth of its bytes'
//     bound on an H100, ~0.09 ms against finalize_core's ~2.1 ms. Two reads
//     a warp would halve the warps; the step does not wait on it.
//   * Dedupe by broadcast: for each valid entry j (a warp-uniform loop), one
//     __shfl_sync a field hands (strand, pos_key, dps[, src]) to every lane,
//     and each lane tests its own entries against it: no shared memory, no
//     [n, n] tensor.
//   * The selection is four warp reductions (__reduce_max_sync,
//     __reduce_min_sync), X0 and X1 are __ballot_sync + __popc.
//   * The picks are read once at best_idx (a warp-uniform broadcast load of
//     fields the warp has just read).
//   * The window: lanes stride over i < min(L, length), each reading its
//     base of ref_seq and of the picked strand; NM and T->C are ballots. An
//     unmapped read skips it (its outputs are 0).
//   * Lane 0 writes the read's outputs once; nothing else is written.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;               // warps (reads) per block
constexpr int kMaxEntries = 256;        // E = 8 registers a lane
constexpr int32_t kNeg = -(1 << 28);    // ops/cuda_extend.py NEG
constexpr int32_t kI32Max = INT32_MAX;
constexpr int32_t kI32Min = INT32_MIN;

// int32 a + b wrapping, as a PyTorch int32 add does
__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// ps_finalize_select's input table, in order; [B, n] arrays are row-major
// with row stride n, but strand and nm_strand, whose row stride is given
// (0: the plain step's one row of strands, broadcast)
struct In {
  const int32_t* oriented;      // [B, 2, L]
  const int32_t* lengths;       // [B]
  const uint8_t* valid;         // bool [B, n]
  const int32_t* strand;        // [B, n]
  const int32_t* pos_key;       // [B, n]
  const int32_t* dps;           // [B, n]
  const uint8_t* ug_eq;         // bool [B, n]
  const int32_t* diag;          // [B, n]
  const int32_t* src;           // [B, n], or null
  const int32_t* nm_pos;        // [B, n], or null: pos_key
  const int32_t* nm_strand;     // [B, n], or null: strand
  const int8_t* ref_seq;        // [G]
  const int32_t* chrom_starts;  // [nc]
  const int32_t* chrom_ends;    // [nc]
  const int32_t* mapq_sub;      // [256]
};

// ps_finalize_select's output table, in order, each [B]
struct Out {
  uint8_t* mapped;
  int32_t* strand;
  int32_t* pos;
  int32_t* score;
  int32_t* mapq;
  int32_t* x0;
  int32_t* x1;
  uint8_t* ug_equal;
  int32_t* nm;
  int32_t* diag;
  int32_t* tc_count;
  int32_t* best_idx;
};

struct Dims {
  int B, n, L, G, nc, strand_stride, nm_strand_stride;
};

template <int E, bool kSrc>
__global__ void __launch_bounds__(kWarps * 32)
    finalize_kernel(const In in, const Out out, const Dims d) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= d.B) return;  // whole warp exits together
  const int n = d.n;
  const size_t row = (size_t)b * n;
  const int32_t* strand_row = in.strand + (size_t)b * d.strand_stride;

  // entry r * 32 + lane in register r
  bool ok[E];
  int32_t st[E], pk[E], sc[E], sr[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int e = r * 32 + lane;
    const bool in_row = e < n;
    ok[r] = in_row && in.valid[row + e] != 0;
    st[r] = in_row ? strand_row[e] : 0;
    pk[r] = in_row ? in.pos_key[row + e] : 0;
    sc[r] = in_row ? in.dps[row + e] : 0;
    sr[r] = (kSrc && in_row) ? in.src[row + e] : 0;
  }

  // dedupe: each valid entry j in turn, broadcast, against every lane's own
  bool dup[E];
#pragma unroll
  for (int r = 0; r < E; ++r) dup[r] = false;
#pragma unroll
  for (int r2 = 0; r2 < E; ++r2) {
    const int lanes = min(32, n - r2 * 32);  // entries in register r2
    for (int j = 0; j < lanes; ++j) {
      if (!__shfl_sync(kFull, (int)ok[r2], j)) continue;  // warp-uniform
      const int e2 = r2 * 32 + j;
      const int32_t st2 = __shfl_sync(kFull, st[r2], j);
      const int32_t pk2 = __shfl_sync(kFull, pk[r2], j);
      const int32_t sc2 = __shfl_sync(kFull, sc[r2], j);
      const int32_t sr2 = kSrc ? __shfl_sync(kFull, sr[r2], j) : 0;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const int e = r * 32 + lane;
        const bool tie =
            kSrc ? (sr2 < sr[r] || (sr2 == sr[r] && e2 < e)) : e2 < e;
        const bool better = sc2 > sc[r] || (sc2 == sc[r] && tie);
        dup[r] = dup[r] || (st2 == st[r] && pk2 == pk[r] && better);
      }
    }
  }

  // selection: best score, then strand, then pos_key, then first index
  bool uv[E];
  bool lane_has = false;
  int32_t lane_best = kI32Min;  // entries past n take no part
#pragma unroll
  for (int r = 0; r < E; ++r) {
    uv[r] = ok[r] && !dup[r];
    lane_has = lane_has || uv[r];
    if (r * 32 + lane < n) lane_best = max(lane_best, uv[r] ? sc[r] : kNeg);
  }
  const bool has = __any_sync(kFull, lane_has);
  const int32_t best = __reduce_max_sync(kFull, lane_best);

  bool at_best[E];
  int32_t lane_strand = kI32Max;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    at_best[r] = uv[r] && sc[r] == best;
    if (r * 32 + lane < n)
      lane_strand = min(lane_strand, at_best[r] ? st[r] : 2);
  }
  const int32_t best_strand = __reduce_min_sync(kFull, lane_strand);

  bool at_bs[E];
  int32_t lane_pos = kI32Max;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    at_bs[r] = at_best[r] && st[r] == best_strand;
    if (at_bs[r]) lane_pos = min(lane_pos, pk[r]);
  }
  const int32_t best_pos = __reduce_min_sync(kFull, lane_pos);

  int32_t lane_first = kI32Max;
#pragma unroll
  for (int r = E - 1; r >= 0; --r)
    if (at_bs[r] && pk[r] == best_pos) lane_first = r * 32 + lane;
  const int32_t first = __reduce_min_sync(kFull, lane_first);
  const int bi = first == kI32Max ? 0 : first;

  int32_t x0 = 0, x1 = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    x0 += __popc(__ballot_sync(kFull, at_best[r]));
    x1 += __popc(__ballot_sync(kFull, uv[r] && sc[r] < best));
  }
  const int32_t mapq =
      x0 > 1 ? 0
             : (x1 == 0 ? 37
                        : max(23 - in.mapq_sub[min(max(x1, 0), 255)], 0));

  // the picks at best_idx
  const size_t at = row + bi;
  const int32_t sel_strand = strand_row[bi];
  const int32_t sel_pos = in.pos_key[at];
  const int32_t sel_diag = in.diag[at];
  const bool sel_ug = in.ug_eq[at] != 0;
  const int32_t sel_score = in.dps[at];
  const int32_t sel_nm_pos = in.nm_pos ? in.nm_pos[at] : sel_pos;
  const int32_t sel_nm_strand =
      in.nm_strand ? in.nm_strand[(size_t)b * d.nm_strand_stride + bi]
                   : sel_strand;

  // chromosome-boundary policy: searchsorted(starts, pos, right) - 1,
  // clamped; the whole ungapped span inside that chromosome
  int lo = 0, hi = d.nc;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (in.chrom_starts[mid] <= sel_pos) lo = mid + 1; else hi = mid;
  }
  const int ci = min(max(lo - 1, 0), d.nc - 1);
  const int32_t len = in.lengths[b];
  const bool mapped = has && sel_pos >= in.chrom_starts[ci] &&
                      add32(add32(sel_pos, len), -1) < in.chrom_ends[ci] &&
                      len > 0;

  // ungapped NM and machine-frame T->C over the picked window
  int32_t nm = 0, tc = 0;
  if (mapped) {  // warp-uniform
    const int span = min(d.L, len);
    const int32_t* read =
        in.oriented + ((size_t)b * 2 + (sel_nm_strand != 0)) * d.L;
    for (int i0 = 0; i0 < span; i0 += 32) {
      const int i = i0 + lane;
      bool mm = false, hit = false;
      if (i < span) {
        const int32_t ridx = add32(sel_nm_pos, i);
        const int32_t rb =
            (ridx >= 0 && ridx < d.G) ? (int32_t)in.ref_seq[ridx] : 4;
        const int32_t rd = read[i];
        mm = rb != rd || rb == 4 || rd == 4;
        hit = sel_nm_strand == 1 ? (rb == 0 && rd == 2) : (rb == 3 && rd == 1);
      }
      nm += __popc(__ballot_sync(kFull, mm));
      tc += __popc(__ballot_sync(kFull, hit));
    }
  }

  if (lane == 0) {
    out.mapped[b] = mapped;
    out.strand[b] = mapped ? sel_strand : 0;
    out.pos[b] = mapped ? sel_pos : -1;
    out.score[b] = mapped ? sel_score : kNeg;
    out.mapq[b] = mapped ? mapq : 0;
    out.x0[b] = mapped ? x0 : 0;
    out.x1[b] = mapped ? x1 : 0;
    out.ug_equal[b] = mapped ? sel_ug : true;
    out.nm[b] = mapped ? nm : 0;
    out.diag[b] = mapped ? sel_diag : 0;
    out.tc_count[b] = (mapped && sel_ug) ? tc : 0;
    out.best_idx[b] = bi;
  }
}

template <int E>
cudaError_t launch(const In& in, const Out& out, const Dims& d,
                   cudaStream_t stream) {
  const int blocks = (d.B + kWarps - 1) / kWarps;
  if (in.src)
    finalize_kernel<E, true><<<blocks, kWarps * 32, 0, stream>>>(in, out, d);
  else
    finalize_kernel<E, false><<<blocks, kWarps * 32, 0, stream>>>(in, out, d);
  return cudaGetLastError();
}

}  // namespace

// in: the 15 pointers of In, in order (src, nm_pos, nm_strand may be null);
// out: the 12 pointers of Out, in order. 1 <= n <= 256 entries a read.
extern "C" int ps_finalize_select(const void* const* in, void* const* out,
                                  int B, int n, int L, int G, int nc,
                                  int strand_stride, int nm_strand_stride,
                                  void* stream) {
  if (B < 1 || n < 1 || n > kMaxEntries || L < 1 || G < 0 || nc < 1)
    return (int)cudaErrorInvalidValue;
  const In i{static_cast<const int32_t*>(in[0]),
             static_cast<const int32_t*>(in[1]),
             static_cast<const uint8_t*>(in[2]),
             static_cast<const int32_t*>(in[3]),
             static_cast<const int32_t*>(in[4]),
             static_cast<const int32_t*>(in[5]),
             static_cast<const uint8_t*>(in[6]),
             static_cast<const int32_t*>(in[7]),
             static_cast<const int32_t*>(in[8]),
             static_cast<const int32_t*>(in[9]),
             static_cast<const int32_t*>(in[10]),
             static_cast<const int8_t*>(in[11]),
             static_cast<const int32_t*>(in[12]),
             static_cast<const int32_t*>(in[13]),
             static_cast<const int32_t*>(in[14])};
  const Out o{static_cast<uint8_t*>(out[0]),  static_cast<int32_t*>(out[1]),
              static_cast<int32_t*>(out[2]),  static_cast<int32_t*>(out[3]),
              static_cast<int32_t*>(out[4]),  static_cast<int32_t*>(out[5]),
              static_cast<int32_t*>(out[6]),  static_cast<uint8_t*>(out[7]),
              static_cast<int32_t*>(out[8]),  static_cast<int32_t*>(out[9]),
              static_cast<int32_t*>(out[10]), static_cast<int32_t*>(out[11])};
  const Dims d{B, n, L, G, nc, strand_stride, nm_strand_stride};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 32) return (int)launch<1>(i, o, d, s);
  if (n <= 64) return (int)launch<2>(i, o, d, s);
  if (n <= 128) return (int)launch<4>(i, o, d, s);
  return (int)launch<8>(i, o, d, s);
}
