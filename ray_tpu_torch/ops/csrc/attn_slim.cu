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
// {64, 128}. P is rounded against the running max of BN-key tiles, so the
// plain version takes block_k = BN.
//
// Bound on this card, at the script's shape B24 S1024 H12 D64: bytes (q, k,
// v, O and lse once each, 152 MB, 0.0455 ms at 3.35 TB/s) over the causal
// pairs' operations (38.7 GFLOP, 0.0391 ms at 989 TFLOP/s).
//
// Design (wgmma_tiles.cuh, as K8 and K10): one block per (head, tile of BM
// query rows), taken 16 heads at a time (block_tile: their K and V stay in
// L2), heaviest tiles first; BM / 64 consumer warpgroups of 64 rows share
// the BN-key K and V tiles that a producer warpgroup brings in by TMA
// through a ring of mbarrier'd stages; q is loaded once by TMA and read by
// wgmma from shared memory. S = Q K^T (m64nBNk16) and O += bf16(P) V
// (m64nDk16, P in registers) run on wgmma. The kernel is the only one-pass
// profiling kernel (an online softmax), so each consumer warpgroup overlaps
// its own exps with its products (FlashAttention-3's overlap inside one
// warpgroup); for tile j:
//   1. S_j = Q K_j^T and P_{j-1} V_{j-1} are issued back to back, O first
//      rescaled to the running max of tile j - 1;
//   2. once S_j has landed, its softmax runs (mask on the diagonal tiles,
//      the running max, 2^(s log2(e) - m log2(e)) in one FFMA and one
//      MUFU.EX2, the row sums) while P_{j-1} V_{j-1} is in flight;
//   3. once P_{j-1} V_{j-1} has landed, P_j is packed to bf16 in registers.
// The two consumer warpgroups of a 128-row block (or the two 64-row blocks
// that share an SM) fill the tensor cores while the other waits on S_j.
// With S_{j+1} issued ahead of the softmax of S_j instead (a second score
// fragment in flight), the kernel ran as fast at 64-key tiles and slower at
// 128 (PERF.md §6). Every branch around a wgmma wait is outside the loop
// bodies: with the first and last tiles handled by conditions inside the
// loop, ptxas serialised every wgmma (C7514). Masked scores are -inf;
// every row's max is finite from the first tile (key 0 is visible to every
// row), so a masked P is exactly 0. The tiles past a warpgroup's last row
// are released untouched.
#include "wgmma_tiles.cuh"

using namespace rtt;

namespace {

// p = exp(s - m) in place as 2^(s log2(e) - m log2(e)): one FFMA and one
// MUFU.EX2 by ex2.approx.ftz, without the fixup for results below 2^-126
// that exp2f carries (those flush to zero; a masked -inf score still gives
// exactly 0), and this thread's part of each row's sum. wgmma_tiles.cuh's
// frag_exp_rows with exp2f ran slower here at every tile (PERF.md §6).
template <int N>
__device__ __forceinline__ void frag_exp2_ftz(float (&s)[N / 2],
                                              const float (&m)[2],
                                              float (&rs)[2]) {
  const float ms[2] = {m[0] * LOG2E, m[1] * LOG2E};
  rs[0] = rs[1] = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float x = fmaf(s[i], LOG2E, -ms[r]);
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(s[i]) : "f"(x));
    rs[r] += s[i];
  }
}

// A block of BM query rows: its consumer warpgroups, threads and ring.
template <int BM, int BN, int D>
struct Slim {
  static constexpr int NWG = BM / 64;  // consumer warpgroups
  static constexpr int THREADS = (NWG + 1) * WG_THREADS;
  // One consumer warpgroup: two blocks share an SM (128 registers a
  // thread at launch, the producer's handed to the consumer), so the ring
  // is cut to three stages where four would not fit twice.
  static constexpr int MIN_BLOCKS = NWG == 1 ? 2 : 1;
  static constexpr int STAGES = (NWG == 1 && BN * D > 64 * 64) ? 3 : 4;
  using Smem = WgSmem<BM, BN, D, STAGES, 1>;
};

template <int BM, int BN, int D>
__global__ void __launch_bounds__(Slim<BM, BN, D>::THREADS,
                                  Slim<BM, BN, D>::MIN_BLOCKS)
    flash_fwd_slim_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          int BH, int S) {
  using K = Slim<BM, BN, D>;
  constexpr int STAGES = K::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const typename K::Smem sm(smem_raw);
  const TileRing<STAGES> ring{sm.full, sm.empty};

  const BlockTile bt = block_tile(BH, S / BM, true);
  const int i0 = bt.qt * BM;
  const int n_tiles = (i0 + BM + BN - 1) / BN;  // up to the block's last row
  const int wg = warpgroup_index();
  if (threadIdx.x == 0) sm.init(K::NWG * WG_THREADS / 32);
  __syncthreads();

  if (wg == K::NWG) {  // the producer: one thread issues every copy
    if constexpr (K::NWG == 1)
      setmaxnreg_dec<24>();
    else
      setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == K::NWG * WG_THREADS) {
      produce_q<BM, D>(&tq, sm.q, &sm.q_full[0], i0, bt.head);
      int it = 0;
      produce_tiles<BN, D>(ring, it, &tk, &tv, sm.k, sm.v, bt.head, n_tiles,
                           true);
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31;
  const int r0 = i0 + wg * 64;  // the warpgroup's first row
  const int row0 = r0 + (threadIdx.x / 32 % 4) * 16 + lane / 4;  // and + 8
  const int mine = (r0 + 64 + BN - 1) / BN;  // tiles up to its last row
  const bf16* q_wg = sm.q + wg * 64 * D;
  mbar_wait(&sm.q_full[0], 0);

  float o[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t p[BN / 16][4];
  float alpha[2];

  auto issue_qk = [&](int j, float(&s)[BN / 2]) {
    ring.wait_full(j);
    fence_regs(s);
    wgmma_fence();
    wg_qk<D, BN>(s, q_wg, sm.k + (j % STAGES) * BN * D);
    wgmma_commit();
  };
  auto issue_pv = [&](int j) {
    fence_regs(p);
    fence_regs(o);
    wgmma_fence();
    wg_pv<D, BN>(o, p, sm.v + (j % STAGES) * BN * D);
    wgmma_commit();
  };
  // The online softmax of tile j's scores, in place: the causal mask on a
  // tile that crosses the warpgroup's first row, the running max, P, the
  // row sums rescaled, and alpha, O's factor for the new max.
  auto softmax = [&](int j, float(&s)[BN / 2]) {
    if (j * BN + BN - 1 > r0) frag_mask<BN>(s, j * BN, row0, -INFINITY);
    float mx[2] = {m[0], m[1]}, rs[2];
    frag_row_max<BN>(mx, s);
    frag_exp2_ftz<BN>(s, mx, rs);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f((m[r] - mx[r]) * LOG2E);
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }
  };
  // P V of tile j has landed: O and P are free, its stage is released.
  auto landed_pv = [&](int j) {
    fence_regs(o);
    fence_regs(p);
    ring.release(j);
  };

  float s[BN / 2];
  issue_qk(0, s);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0, s);
  frag_pack<BN>(p, s);
  for (int j = 1; j < mine; ++j) {
    issue_qk(j, s);
    frag_rows_op<D, false>(o, alpha);
    issue_pv(j - 1);
    wgmma_wait<1>();  // S_j; P_{j-1} V_{j-1} stays in flight
    fence_regs(s);
    softmax(j, s);
    wgmma_wait<0>();
    landed_pv(j - 1);
    frag_pack<BN>(p, s);
  }
  frag_rows_op<D, false>(o, alpha);
  issue_pv(mine - 1);
  wgmma_wait<0>();
  landed_pv(mine - 1);
  for (int j = mine; j < n_tiles; ++j) {  // the other warpgroup's last tile
    ring.wait_full(j);
    ring.release(j);
  }

  frag_finish_sums(l);
  store_o_frag<D>(out + (size_t)bt.head * S * D, row0, S, o, l);
  store_lse_frag(lse + (size_t)bt.head * S, row0, S, m, l);
}

template <int BM, int BN, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BH, int S, cudaStream_t stream) {
  using K = Slim<BM, BN, D>;
  CUtensorMap tq, tk, tv;
  if (!make_rows_map(&tq, q, BH, S, D, BM) ||
      !make_rows_map(&tk, k, BH, S, D, BN) ||
      !make_rows_map(&tv, v, BH, S, D, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = K::Smem::BYTES;
  const cudaError_t err = opt_in_smem(flash_fwd_slim_kernel<BM, BN, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH * (S / BM));
  flash_fwd_slim_kernel<BM, BN, D><<<grid, K::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), BH, S);
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
// Returns cudaGetLastError(), or cudaErrorInvalidValue for what the kernel
// does not take or a tensor map cuTensorMapEncodeTiled refuses.
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
