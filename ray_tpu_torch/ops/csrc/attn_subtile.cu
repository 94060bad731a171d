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
// Design (wgmma_tiles.cuh): the script's one program per head becomes one
// block per (head, tile of 128 query rows), taken 16 heads at a time
// (block_tile: their K and V stay in L2), heaviest tiles first: two
// consumer warpgroups of 64 rows, each in one chunk (C is a multiple of
// 64), share the 128-key K and V tiles a producer warpgroup brings in by
// TMA. Each warpgroup's key loop ends at its own chunk's edge (t + 1) C;
// the block loads up to the larger edge, and the warpgroup with the nearer
// one releases the rest untouched. An edge that is a multiple of 64 but not of
// 128 ends in a half tile, whose keys past the edge lie past every row of
// the chunk and are masked as causal. P is rounded against the exact max,
// so the block takes two passes: Q K^T alone for the row max, then Q K^T
// again with p, l and O += bf16(p) V, both products on wgmma.
#include "wgmma_tiles.cuh"

using namespace rtt;

namespace {

constexpr int BM = 128, BN = 128;
constexpr int STAGES = 4;
constexpr int CONSUMER_WARPS = 2 * WG_THREADS / 32;
constexpr int THREADS = 3 * WG_THREADS;  // two consumers, one producer
constexpr float MASKED = -1e30f;

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    attn_subtile_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        bf16* __restrict__ out, float* __restrict__ lse,
                        int BH, int S, int C) {
  extern __shared__ unsigned char smem_raw[];
  const WgSmem<BM, BN, D, STAGES, 1> sm(smem_raw);
  const TileRing<STAGES> ring{sm.full, sm.empty};

  const BlockTile bt = block_tile(BH, (S + BM - 1) / BM, true);
  const int bh = bt.head, i0 = bt.qt * BM;
  // Key tiles up to the chunk edge of the 64 rows from r (none past S).
  auto edge_tiles = [&](int r) {
    return r < S ? ((r / C + 1) * C + BN - 1) / BN : 0;
  };
  const int n_tiles = max(edge_tiles(i0), edge_tiles(i0 + 64));
  const int wg = warpgroup_index();
  if (threadIdx.x == 0) sm.init(CONSUMER_WARPS);
  __syncthreads();

  if (wg == 2) {  // the producer: one thread issues every copy
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG_THREADS) {
      produce_q<BM, D>(&tq, sm.q, &sm.q_full[0], i0, bh);
      int it = 0;
      produce_tiles<BN, D>(ring, it, &tk, &tv, sm.k, sm.v, bh, n_tiles, false);
      produce_tiles<BN, D>(ring, it, &tk, &tv, sm.k, sm.v, bh, n_tiles, true);
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31;
  const int r0 = i0 + wg * 64;
  const int row0 = r0 + (threadIdx.x / 32 % 4) * 16 + lane / 4;  // and + 8
  const int mine = edge_tiles(r0);
  const bf16* q_wg = sm.q + wg * 64 * D;
  if (mine > 0) mbar_wait(&sm.q_full[0], 0);
  int it = 0;

  // Pass 1: each row's exact max over its chunk's keys.
  float m[2] = {-INFINITY, -INFINITY};
  sweep_scores<D, BN>(ring, it, n_tiles, mine, q_wg, sm.k,
                      [&](int j, float (&s)[BN / 2]) {
                        if (j * BN + BN - 1 > r0)
                          frag_mask<BN>(s, j * BN, row0, MASKED);
                        frag_row_max<BN>(m, s);
                      });

  // Pass 2: p = exp(s - m), l = sum(p), O += bf16(p) V.
  float o[D / 2], l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  sweep_attention<D, BN>(ring, it, n_tiles, mine, q_wg, sm.k, sm.v, o,
                         [&](int j, float (&s)[BN / 2]) {
                           if (j * BN + BN - 1 > r0)
                             frag_mask<BN>(s, j * BN, row0, MASKED);
                           float rs[2];
                           frag_exp_rows<BN>(s, m, rs);
                           l[0] += rs[0];
                           l[1] += rs[1];
                         });
  frag_finish_sums(l);
  store_o_frag<D>(out + (size_t)bh * S * D, row0, S, o, l);
  store_lse_frag(lse + (size_t)bh * S, row0, S, m, l);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BH, int S, int C, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_rows_map(&tq, q, BH, S, D, BM) ||
      !make_rows_map(&tk, k, BH, S, D, BN) ||
      !make_rows_map(&tv, v, BH, S, D, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = WgSmem<BM, BN, D, STAGES, 1>::BYTES;
  const cudaError_t err = opt_in_smem(attn_subtile_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH * ((S + BM - 1) / BM));
  attn_subtile_kernel<D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), BH, S,
      C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: contiguous [BH, S, D] bf16, D in {32, 64}; lse: [BH, S]
// f32. T must divide S, and the chunk C = S / T must be a multiple of 64.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for what the kernel
// does not take or a tensor map the driver refuses.
extern "C" int attn_subtile_launch(int T, const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int BH, int S, int D, void* stream) {
  if (BH < 1 || T < 1 || S < 1 || S % T || (S / T) % 64)
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
