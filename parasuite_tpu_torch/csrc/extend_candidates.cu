// Banded glocal affine-gap extension, one thread per (oriented read,
// candidate diagonal) pair.
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
// [0, G) read as N (4). Steps i >= len leave M and ug unchanged, so the loop
// stops at the read's length. Out: (max_j M, smallest such j, max_j ug,
// smallest such j).
//
// Iy is computed as the sequential walk Iy[1] = M[0] - go,
// Iy[j] = max(M[j-1] - go, Iy[j-1] - ge): the same maximum over the same
// terms as the reference's cummax form, exact in int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kNeg = -(1 << 28);
constexpr int kThreads = 128;

template <int BAND>
__global__ void extend_kernel(const int32_t* __restrict__ reads2,
                              const int32_t* __restrict__ lengths,
                              const int32_t* __restrict__ cand_diag,
                              const int8_t* __restrict__ ref, int G,
                              const int32_t* __restrict__ s_fwd,
                              const int32_t* __restrict__ s_comp, int P,
                              int C, int L, int go, int ge,
                              int32_t* __restrict__ dp_score,
                              int32_t* __restrict__ dp_j,
                              int32_t* __restrict__ ug_score,
                              int32_t* __restrict__ ug_j) {
  constexpr int W = BAND / 2;
  extern __shared__ int32_t s_all[];  // [2][L][5][5]: s_fwd then s_comp
  const int n_tab = L * 25;
  for (int k = threadIdx.x; k < n_tab; k += blockDim.x) {
    s_all[k] = s_fwd[k];
    s_all[n_tab + k] = s_comp[k];
  }
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int b2 = p / C;
  const int strand = b2 & 1;
  const int len = lengths[b2 >> 1];
  const int win = L + 2 * W;
  const int diag = min(max(cand_diag[p], -(win + 1)), G);
  const int base = diag - W;
  const int32_t* read = reads2 + (size_t)b2 * L;
  const int32_t* s_str = s_all + strand * n_tab;

  int32_t m[BAND], ix[BAND], iy[BAND], ug[BAND], rb[BAND];
#pragma unroll
  for (int j = 0; j < BAND; ++j) {
    m[j] = kNeg;
    ix[j] = kNeg;
    iy[j] = kNeg;
    ug[j] = 0;
    const int r = base + j;
    rb[j] = (r >= 0 && r < G) ? ref[r] : 4;  // window for i = 0
  }

  const int steps = min(len, L);
  for (int i = 0; i < steps; ++i) {
    if (i > 0) {  // slide the reference window by one base
#pragma unroll
      for (int j = 0; j < BAND - 1; ++j) rb[j] = rb[j + 1];
      const int r = base + i + BAND - 1;
      rb[BAND - 1] = (r >= 0 && r < G) ? ref[r] : 4;
    }
    const int prof = strand == 0 ? i : min(max(len - 1 - i, 0), L - 1);
    const int32_t* srow = s_str + prof * 25 + read[i];  // + ref base * 5
    int32_t m_new[BAND];
#pragma unroll
    for (int j = 0; j < BAND; ++j) {
      const int32_t sub = srow[rb[j] * 5];
      const int32_t best = max(m[j], max(ix[j], iy[j]));
      m_new[j] = sub + (i == 0 ? 0 : best);
      ug[j] += sub;
    }
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < BAND; ++j) ix[j] = kNeg;
    } else {
#pragma unroll
      for (int j = 0; j < BAND; ++j) {
        const int32_t m_up = j + 1 < BAND ? m[j + 1] : kNeg;
        const int32_t ix_up = j + 1 < BAND ? ix[j + 1] : kNeg;
        ix[j] = max(m_up - go, ix_up - ge);
      }
    }
    iy[0] = kNeg;
    if constexpr (BAND > 1) iy[1] = m_new[0] - go;
#pragma unroll
    for (int j = 2; j < BAND; ++j)
      iy[j] = max(m_new[j - 1] - go, iy[j - 1] - ge);
#pragma unroll
    for (int j = 0; j < BAND; ++j) m[j] = m_new[j];
  }

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
cudaError_t launch(const int32_t* reads2, const int32_t* lengths,
                   const int32_t* cand_diag, const int8_t* ref, int G,
                   const int32_t* s_fwd, const int32_t* s_comp, int P, int C,
                   int L, int go, int ge, int32_t* dp_score, int32_t* dp_j,
                   int32_t* ug_score, int32_t* ug_j, cudaStream_t stream) {
  const size_t smem = (size_t)2 * L * 25 * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        extend_kernel<BAND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (P + kThreads - 1) / kThreads;
  extend_kernel<BAND><<<blocks, kThreads, smem, stream>>>(
      reads2, lengths, cand_diag, ref, G, s_fwd, s_comp, P, C, L, go, ge,
      dp_score, dp_j, ug_score, ug_j);
  return cudaGetLastError();
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
