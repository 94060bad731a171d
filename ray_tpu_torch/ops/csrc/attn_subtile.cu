// Subtiled causal attention forward (K10).
//
// Replaces benchmarks/profile_attn_subtile.py::make_subtiled (:21,
// pallas_call at :48): causal attention WITHOUT sm_scale on q, k, v
// [BH, S, D] bf16. The rows are cut into T chunks of C = S / T rows; chunk t
// scores keys [0, (t + 1) C) only, masked with -1e30 past each row's
// diagonal. m is the row's exact max (one pass over all of its keys, no
// running max), p = exp(s - m) in f32, l = sum(p) unrounded,
// O = (bf16(p) V) / l in bf16 and lse = m + log(l) in f32 [BH, S] (the
// script's 8 sublane copies of lse are a TPU layout and are dropped). The
// result does not depend on T: T sets only how many masked keys past the
// diagonal are computed (at T = 4, 37.5% of the square's products are
// skipped; the diagonal chunk's masked part is still computed).
//
// Bound on this card, at the script's shape B24 S1024 H12 D64: bytes (q, k,
// v, O and lse once each, 152 MB, 0.0455 ms at 3.35 TB/s) over the causal
// pairs' operations (38.7 GFLOP, 0.0391 ms at 989 TFLOP/s).
//
// Design (attn_tiles.cuh): the script's one program per head becomes one
// block of 4 warps per (head, tile of 64 query rows), heaviest tiles
// first, whose key loop ends at its chunk's edge (t + 1) C, so C must be a
// multiple of 64. P is rounded against the exact max, so the block takes
// two passes: Q K^T alone for the row max, then Q K^T again with p, l and
// O += bf16(p) V, through the same two-stage cp.async ring and mma.sync
// tiles as the bf16 forward.
#include "attn_tiles.cuh"

using namespace rtt;

namespace {

constexpr int BM = 64, BN = 64;
constexpr int THREADS = 2 * BM;
constexpr float MASKED = -1e30f;

template <int D>
__global__ void __launch_bounds__(THREADS)
    attn_subtile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        float* __restrict__ lse, int S, int C) {
  constexpr int LD = tile_ld<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + BM * LD;
  bf16* v_s = k_s + 2 * BN * LD;

  const int bh = blockIdx.x;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = i0 + warp * 16 + (lane >> 2);
  const int n_tiles = (i0 / C + 1) * C / BN;  // keys [0, chunk edge)
  const size_t base = (size_t)bh * S * D;
  const KVRows kv{k + base, v + base, D, D, S};
  // The first pass's tile 0 is in flight while q is staged.
  start_tile_copy<BN, D, THREADS, false>(kv, 0, 0, k_s, v_s);
  cp_async_commit();
  uint32_t qf[D / 16][4];
  load_q_frags<BM, D, THREADS>(qf, q_s, q + base, D, i0, S, 1.f, warp, lane);

  // Pass 1: each row's exact max over its chunk's keys.
  float m[2] = {NEG_INF, NEG_INF};
  sweep_tiles<BN, D, THREADS, false>(
      kv, n_tiles, k_s, v_s, true,
      [&](int tile, const bf16* ks, const bf16*) {
        float s[BN / 8][4];
        qk_tile<D, BN>(s, qf, ks, lane);
        if (tile * BN + BN > i0 + 1)
          mask_tile<BN>(s, tile * BN, row0, lane, S, 1, MASKED);
        row_max<BN>(m, s);
      });

  // Pass 2: p = exp(s - m), l = sum(p), O += bf16(p) V.
  float o[D / 8][4], l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  sweep_tiles<BN, D, THREADS, true>(
      kv, n_tiles, k_s, v_s, false,
      [&](int tile, const bf16* ks, const bf16* vs) {
        float s[BN / 8][4], rs[2];
        qk_tile<D, BN>(s, qf, ks, lane);
        if (tile * BN + BN > i0 + 1)
          mask_tile<BN>(s, tile * BN, row0, lane, S, 1, MASKED);
        exp_rows<BN>(s, m, rs);
        l[0] += rs[0];
        l[1] += rs[1];
        pv_tile<D, BN>(o, s, vs, lane);
      });
  finish_row_sums(l);
  store_rows<D>(out + base + (size_t)(i0 + warp * 16) * D, D, 16, o, l,
                q_s + warp * 16 * LD, lane);
  store_lse(lse + (size_t)bh * S, row0, S, m, l, lane);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BH, int S, int C, cudaStream_t stream) {
  constexpr size_t smem = tiles_smem_bytes<BM, BN, D>();
  const cudaError_t err = allow_smem(attn_subtile_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, S / BM);
  attn_subtile_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), S, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: contiguous [BH, S, D] bf16, D in {32, 64}; lse: [BH, S]
// f32. T must divide S, and the chunk C = S / T must be a multiple of 64.
// Returns cudaGetLastError().
extern "C" int attn_subtile_launch(int T, const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int BH, int S, int D, void* stream) {
  if (BH < 1 || T < 1 || S < 1 || S % T || (S / T) % BM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear a stale non-sticky error from earlier work
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = S / T;
  switch (D) {
    case 32: return launch<32>(q, k, v, out, lse, BH, S, C, s);
    case 64: return launch<64>(q, k, v, out, lse, BH, S, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
