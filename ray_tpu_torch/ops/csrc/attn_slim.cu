// Slim flash attention forward (K9), in its tile sizes.
//
// Replaces benchmarks/profile_attn_variants.py::_fwd_kernel_slim (:27,
// pallas_call at :101, reached through slim_fwd :90): causal flash
// attention on q that arrives prescaled by sm_scale and rounded to bf16 (the
// wrapper does it, as slim_fwd does before its call), with a running max per
// key tile, the mask applied only on the tiles that cross the diagonal and
// the tiles above it skipped. O [BH, S, D] bf16 and lse [BH, S] f32 (the
// script's 8 sublane copies of lse are a TPU layout and are dropped).
//
// The script sweeps 1024-, 512- and 256-row VMEM blocks. Those do not carry
// over: one 1024-key bf16 K and V tile pair at D = 64 is 256 KB, more than
// an SM's 227 KB of shared memory. The H100's counterpart of that sweep is
// flash_fwd_slim_kernel<BM, BN> over query tiles BM and key tiles BN in
// {64, 128} (BM / 16 warps of 16 rows). P is rounded against the running max
// of BN-key tiles, so the plain version takes block_k = BN.
//
// Bound on this card, at the script's shape B24 S1024 H12 D64: bytes (q, k,
// v, O and lse once each, 152 MB, 0.0455 ms at 3.35 TB/s) over the causal
// pairs' operations (38.7 GFLOP, 0.0391 ms at 989 TFLOP/s).
//
// Design: the bf16 forward's (flash_fwd_mma_kernel, flash_fwd.cu) through
// the shared tiles of attn_tiles.cuh: q in registers as A fragments, a
// two-stage cp.async ring of K and V tiles, mma.sync for both products, an
// online softmax on the accumulator fragments with masked scores at -inf
// (every row's max is finite from the first tile on: key 0 is visible to
// every row), P packed to bf16 in registers, heaviest query tiles first.
#include "attn_tiles.cuh"

using namespace rtt;

namespace {

template <int BM, int BN, int D>
__global__ void __launch_bounds__(2 * BM)
    flash_fwd_slim_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          float* __restrict__ lse, int S) {
  constexpr int THREADS = 2 * BM;
  constexpr int LD = tile_ld<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + BM * LD;
  bf16* v_s = k_s + 2 * BN * LD;

  const int bh = blockIdx.x;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = i0 + warp * 16 + (lane >> 2);
  // Tiles wholly above the block's last row are skipped.
  const int n_tiles = (i0 + BM + BN - 1) / BN;
  const size_t base = (size_t)bh * S * D;
  const KVRows kv{k + base, v + base, D, D, S};
  // Tile 0 of K and V is in flight while q is staged.
  start_tile_copy<BN, D, THREADS, true>(kv, 0, 0, k_s, v_s);
  cp_async_commit();
  uint32_t qf[D / 16][4];
  load_q_frags<BM, D, THREADS>(qf, q_s, q + base, D, i0, S, 1.f, warp, lane);

  float o[D / 8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  sweep_tiles<BN, D, THREADS, true>(
      kv, n_tiles, k_s, v_s, true,
      [&](int tile, const bf16* ks, const bf16* vs) {
        float s[BN / 8][4];
        qk_tile<D, BN>(s, qf, ks, lane);
        // Only tiles that cross the diagonal pay for the mask.
        if (tile * BN + BN > i0 + 1)
          mask_tile<BN>(s, tile * BN, row0, lane, S, 1, -INFINITY);
        online_softmax_tile<D, BN>(s, m, l, o);
        pv_tile<D, BN>(o, s, vs, lane);
      });
  finish_row_sums(l);
  store_rows<D>(out + base + (size_t)(i0 + warp * 16) * D, D, 16, o, l,
                q_s + warp * 16 * LD, lane);
  store_lse(lse + (size_t)bh * S, row0, S, m, l, lane);
}

template <int BM, int BN, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BH, int S, cudaStream_t stream) {
  constexpr size_t smem = tiles_smem_bytes<BM, BN, D>();
  const cudaError_t err = allow_smem(flash_fwd_slim_kernel<BM, BN, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, S / BM);
  flash_fwd_slim_kernel<BM, BN, D><<<grid, 2 * BM, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), S);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_tiles(int block_q, int block_k, const void* q, const void* k,
                   const void* v, void* out, void* lse, int BH, int S,
                   cudaStream_t s) {
  if (block_q == 64 && block_k == 64)
    return launch<64, 64, D>(q, k, v, out, lse, BH, S, s);
  if (block_q == 64 && block_k == 128)
    return launch<64, 128, D>(q, k, v, out, lse, BH, S, s);
  if (block_q == 128 && block_k == 64)
    return launch<128, 64, D>(q, k, v, out, lse, BH, S, s);
  if (block_q == 128 && block_k == 128)
    return launch<128, 128, D>(q, k, v, out, lse, BH, S, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (prescaled), k, v, out: contiguous [BH, S, D] bf16, D in {32, 64};
// lse: [BH, S] f32; block_q, block_k in {64, 128}, each dividing S.
// Returns cudaGetLastError().
extern "C" int attn_slim_launch(int block_q, int block_k, const void* q,
                                const void* k, const void* v, void* out,
                                void* lse, int BH, int S, int D,
                                void* stream) {
  if (BH < 1 || S < 1 || block_q < 1 || block_k < 1 || S % block_q ||
      S % block_k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear a stale non-sticky error from earlier work
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return dispatch_tiles<32>(block_q, block_k, q, k, v, out, lse, BH, S, s);
    case 64:
      return dispatch_tiles<64>(block_q, block_k, q, k, v, out, lse, BH, S, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
