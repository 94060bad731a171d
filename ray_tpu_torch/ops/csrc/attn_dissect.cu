// Dissected attention forward (K8): the bf16 forward's tile machinery with
// the softmax pieces added one level at a time, to see what each costs.
//
// Replaces benchmarks/profile_attn_dissect.py::make (:17, pallas_call at
// :42), levels 0-4, and ::make2h (:53, pallas_call at :77) at level 3, two
// heads per program. Each level computes exactly the script's function on
// q, k, v [BH, S, D] bf16, which is NOT attention below level 4:
//   L0: s = q k^T in f32, with no sm_scale;
//   L1: s = where(i >= j, s, -1e30);
//   L2: s -= the row's max over all its keys;
//   L3: s = exp(s);
//   L4: s /= the row's sum;
//   O = bf16(s) v, accumulated in f32 and rounded to bf16.
// make2h(3) is make(4)'s function with two heads per program: here two
// heads per block, one after the other on the same query tile.
//
// Bound on this card, at the script's shape B24 S1024 H12 D64: bytes, q, k,
// v and O once each (151 MB, 0.0451 ms at 3.35 TB/s), at every level. The
// operations: levels 0-2 compute every (query, key) pair, 4 S^2 D flops a
// head (77.3 GFLOP, 0.0782 ms at 989 TFLOP/s, above the bytes); levels 3-4
// and the two-head variant skip the tiles above the diagonal (38.7 GFLOP,
// 0.0391 ms), so the bytes bound them.
//
// Design (wgmma_tiles.cuh): one block per (head, tile of 128 query rows),
// taken 16 heads at a time (block_tile: their K and V stay in L2), heaviest
// tiles first where tiles are skipped: two consumer warpgroups of 64 rows
// share each 128-key K (and V) tile that a producer warpgroup brings in by
// TMA through a four-stage ring; q is loaded once by TMA and read by wgmma
// from shared memory. S = Q K^T and O += bf16(P) V run on wgmma, P
// packed to bf16 in registers as the A operand. What each level adds:
//   * -1e30, not -inf: at levels 1-2 masked scores are not zero. They add
//     -1e30 v to O, whose values reach ~1e31 (bf16 holds 3.4e38), so no
//     tile above the diagonal may be skipped at levels 0-2. Only at levels
//     3-4 (and 2h), where exp(-1e30 - m) = 0 exactly, are they skipped;
//   * from level 2 on, P is rounded against the exact row max (and at level
//     4 scaled by the exact row sum), which must be known before any P is
//     formed. So these levels take two passes: the first computes Q K^T
//     alone, over the tiles up to the diagonal (masked scores never reach
//     the max), for the max and, at level 4, an online rescaled sum; the
//     second recomputes Q K^T and forms P and P V. The flash forward takes
//     one pass with a running max instead; the second pass is part of what
//     these levels' times measure;
//   * level 4 scales each P by one correctly rounded reciprocal of its row's
//     sum, where the script divides: one reciprocal a row and a multiply a
//     P instead of an IEEE divide a P, at most one f32 rounding step apart
//     before P is rounded to bf16;
//   * keys past S come in as zeros; they lie past every row, so the causal
//     mask covers them where a level masks, and at level 0 their zero
//     scores meet zero V rows.
#include "wgmma_tiles.cuh"

using namespace rtt;

namespace {

constexpr int BM = 128, BN = 128;  // query rows per block, keys per tile
constexpr int STAGES = 4;
constexpr int CONSUMER_WARPS = 2 * WG_THREADS / 32;
constexpr int THREADS = 3 * WG_THREADS;  // two consumers, one producer
constexpr float MASKED = -1e30f;  // the script's mask value

template <int LEVEL, int HEADS, int D>
__global__ void __launch_bounds__(THREADS, 1)
    attn_dissect_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        bf16* __restrict__ out, int n_blocks_h, int S) {
  // Full softmax from level 4, or in the two-head variant (make2h(3)).
  constexpr bool FULL_SOFTMAX = LEVEL >= 4 || HEADS == 2;
  constexpr bool EXP = LEVEL >= 3 || HEADS == 2;
  constexpr bool MASK = LEVEL >= 1;
  constexpr bool ROW_MAX = LEVEL >= 2 || HEADS == 2;
  extern __shared__ unsigned char smem_raw[];
  const WgSmem<BM, BN, D, STAGES, HEADS> sm(smem_raw);
  const TileRing<STAGES> ring{sm.full, sm.empty};

  const BlockTile bt = block_tile(n_blocks_h, (S + BM - 1) / BM, EXP);
  const int i0 = bt.qt * BM;
  const int n_diag = (min(i0 + BM, S) - 1) / BN + 1;  // tiles up to the diagonal
  const int n1 = ROW_MAX ? n_diag : 0;
  const int n2 = EXP ? n_diag : (S + BN - 1) / BN;
  const int wg = warpgroup_index();
  if (threadIdx.x == 0) sm.init(CONSUMER_WARPS);
  __syncthreads();

  if (wg == 2) {  // the producer: one thread issues every copy
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG_THREADS) {
      for (int hh = 0; hh < HEADS; ++hh)
        produce_q<BM, D>(&tq, sm.q + hh * BM * D, &sm.q_full[hh], i0,
                         bt.head * HEADS + hh);
      int it = 0;
      for (int hh = 0; hh < HEADS; ++hh) {
        const int head = bt.head * HEADS + hh;
        produce_tiles<BN, D>(ring, it, &tk, &tv, sm.k, sm.v, head, n1, false);
        produce_tiles<BN, D>(ring, it, &tk, &tv, sm.k, sm.v, head, n2, true);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31;
  const int r0 = i0 + wg * 64;                // the warpgroup's first row
  const int row0 = r0 + (threadIdx.x / 32 % 4) * 16 + lane / 4;  // and + 8
  const bool live = r0 < S;                   // rows past S: tiles untouched
  const int mine_diag = live ? (min(r0 + 64, S) - 1) / BN + 1 : 0;
  const int mine1 = ROW_MAX ? mine_diag : 0;
  const int mine2 = live ? (EXP ? mine_diag : n2) : 0;
  int it = 0;
  for (int hh = 0; hh < HEADS; ++hh) {
    const int head = bt.head * HEADS + hh;
    const bf16* q_wg = sm.q + hh * BM * D + wg * 64 * D;
    if (live) mbar_wait(&sm.q_full[hh], 0);

    // Pass 1 (levels >= 2): the exact row max, and at level 4 the row sum
    // (online, rescaled to each new max).
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    if (ROW_MAX)
      sweep_scores<D, BN>(
          ring, it, n1, mine1, q_wg, sm.k, [&](int j, float (&s)[BN / 2]) {
            if (j * BN + BN - 1 > r0) frag_mask<BN>(s, j * BN, row0, MASKED);
            float mx[2] = {m[0], m[1]};
            frag_row_max<BN>(mx, s);
            if (FULL_SOFTMAX) {
              float rs[2];
              frag_exp_rows<BN>(s, mx, rs);
#pragma unroll
              for (int r = 0; r < 2; ++r)
                l[r] = l[r] * exp2f((m[r] - mx[r]) * LOG2E) + rs[r];
            }
            m[0] = mx[0];
            m[1] = mx[1];
          });
    float inv_l[2] = {1.f, 1.f};
    if (FULL_SOFTMAX) {
#pragma unroll
      for (int r = 0; r < 2; ++r) inv_l[r] = __frcp_rn(quad_sum(l[r]));
    }

    // Pass 2: P at this level, O += bf16(P) V.
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    sweep_attention<D, BN>(
        ring, it, n2, mine2, q_wg, sm.k, sm.v, o,
        [&](int j, float (&s)[BN / 2]) {
          if (MASK && j * BN + BN - 1 > r0)
            frag_mask<BN>(s, j * BN, row0, MASKED);
          if (EXP) {
            float rs[2];
            frag_exp_rows<BN>(s, m, rs);
          } else if (ROW_MAX) {
            frag_rows_op<BN, true>(s, m);
          }
          if (FULL_SOFTMAX) frag_rows_op<BN, false>(s, inv_l);
        });
    const float one[2] = {1.f, 1.f};
    store_o_frag<D>(out + (size_t)head * S * D, row0, S, o, one);
  }
}

template <int LEVEL, int HEADS, int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_rows_map(&tq, q, BH, S, D, BM) ||
      !make_rows_map(&tk, k, BH, S, D, BN) ||
      !make_rows_map(&tv, v, BH, S, D, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = WgSmem<BM, BN, D, STAGES, HEADS>::BYTES;
  const cudaError_t err =
      opt_in_smem(attn_dissect_kernel<LEVEL, HEADS, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks_h = BH / HEADS;  // a block's heads: HEADS of them
  const dim3 grid(n_blocks_h * ((S + BM - 1) / BM));
  attn_dissect_kernel<LEVEL, HEADS, D><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), n_blocks_h, S);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_level(int level, int two_heads, const void* q, const void* k,
                   const void* v, void* out, int BH, int S,
                   cudaStream_t stream) {
  if (two_heads) {
    if (level != 3 || BH % 2) return static_cast<int>(cudaErrorInvalidValue);
    return launch<3, 2, D>(q, k, v, out, BH, S, stream);
  }
  switch (level) {
    case 0: return launch<0, 1, D>(q, k, v, out, BH, S, stream);
    case 1: return launch<1, 1, D>(q, k, v, out, BH, S, stream);
    case 2: return launch<2, 1, D>(q, k, v, out, BH, S, stream);
    case 3: return launch<3, 1, D>(q, k, v, out, BH, S, stream);
    case 4: return launch<4, 1, D>(q, k, v, out, BH, S, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, out: contiguous [BH, S, D] bf16 with S a multiple of 64 and D in
// {32, 64}; level 0-4, or two_heads = 1 with level 3 (the script's
// make2h(3)) and BH even. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what the kernel does not take or a tensor map
// the driver refuses.
extern "C" int attn_dissect_launch(int level, int two_heads, const void* q,
                                   const void* k, const void* v, void* out,
                                   int BH, int S, int D, void* stream) {
  if (BH < 1 || S < 64 || S % 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear a stale non-sticky error from earlier work
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dispatch_level<32>(level, two_heads, q, k, v, out, BH, S, s);
    case 64: return dispatch_level<64>(level, two_heads, q, k, v, out, BH, S, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
