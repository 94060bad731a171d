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
// Design (attn_tiles.cuh): one block of 4 warps per (head, tile of 64 query
// rows), heaviest tiles first where tiles are skipped; 64-key K and V tiles
// in a two-stage cp.async ring; both products on mma.sync m16n8k16; P packed
// to bf16 in registers. What each level adds to the forward kernel's cost:
//   * -1e30, not -inf: at levels 1-2 masked scores are not zero. They add
//     -1e30 v to O, whose values reach ~1e31 (bf16 holds 3.4e38), so no
//     tile above the diagonal may be skipped at levels 0-2. Only at levels
//     3-4 (and 2h), where exp(-1e30 - m) = 0 exactly, are they skipped;
//   * from level 2 on, P is rounded against the exact row max (and at level
//     4 divided by the exact row sum), which must be known before any P is
//     formed. So these levels take two passes: the first computes Q K^T
//     alone, over the tiles up to the diagonal (masked scores never reach
//     the max), for the max and, at level 4, an online rescaled sum; the
//     second recomputes Q K^T and forms P and P V. The flash forward takes
//     one pass with a running max instead; the second pass is part of what
//     these levels' times measure.
#include "attn_tiles.cuh"

using namespace rtt;

namespace {

constexpr int BM = 64, BN = 64;  // query rows per block, keys per tile
constexpr int THREADS = 2 * BM;  // 4 warps of 16 rows
constexpr float MASKED = -1e30f;  // the script's mask value

template <int LEVEL, int HEADS, int D>
__global__ void __launch_bounds__(THREADS)
    attn_dissect_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        int S) {
  // Full softmax from level 4, or in the two-head variant (make2h(3)).
  constexpr bool FULL_SOFTMAX = LEVEL >= 4 || HEADS == 2;
  constexpr bool EXP = LEVEL >= 3 || HEADS == 2;
  constexpr bool MASK = LEVEL >= 1;
  constexpr bool ROW_MAX = LEVEL >= 2 || HEADS == 2;
  constexpr int LD = tile_ld<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]
  bf16* k_s = q_s + BM * LD;                      // [2][BN][LD]
  bf16* v_s = k_s + 2 * BN * LD;                  // [2][BN][LD]

  const int qt = EXP ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int i0 = qt * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = i0 + warp * 16 + (lane >> 2);  // rows row0, row0 + 8
  const int diag_tiles = (i0 + BM) / BN;  // tiles up to the diagonal
  const int n_out = EXP ? diag_tiles : S / BN;

  for (int hh = 0; hh < HEADS; ++hh) {
    const size_t base = (size_t)(blockIdx.x * HEADS + hh) * S * D;
    const KVRows kv{k + base, v + base, D, D, S};
    if (hh > 0) __syncthreads();  // the last head's O rows left q_s
    // The first pass's tile 0 is in flight while q is staged.
    start_tile_copy<BN, D, THREADS, !ROW_MAX>(kv, 0, 0, k_s, v_s);
    cp_async_commit();
    uint32_t qf[D / 16][4];
    load_q_frags<BM, D, THREADS>(qf, q_s, q + base, D, i0, S, 1.f, warp, lane);

    // Pass 1 (levels >= 2): the exact row max, and at level 4 the row sum
    // (online, rescaled to each new max).
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    if (ROW_MAX) {
      sweep_tiles<BN, D, THREADS, false>(
          kv, diag_tiles, k_s, v_s, true,
          [&](int tile, const bf16* ks, const bf16*) {
            float s[BN / 8][4];
            qk_tile<D, BN>(s, qf, ks, lane);
            if (tile * BN + BN > i0 + 1)
              mask_tile<BN>(s, tile * BN, row0, lane, S, 1, MASKED);
            float mx[2] = {m[0], m[1]};
            row_max<BN>(mx, s);
            if (FULL_SOFTMAX) {
              float rs[2];
              exp_rows<BN>(s, mx, rs);
#pragma unroll
              for (int r = 0; r < 2; ++r)
                l[r] = l[r] * exp2f((m[r] - mx[r]) * LOG2E) + rs[r];
            }
            m[0] = mx[0];
            m[1] = mx[1];
          });
      if (FULL_SOFTMAX) {
        l[0] = quad_sum(l[0]);
        l[1] = quad_sum(l[1]);
      }
    }

    // Pass 2: P at this level, O += bf16(P) V.
    float o[D / 8][4];
#pragma unroll
    for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
    sweep_tiles<BN, D, THREADS, true>(
        kv, n_out, k_s, v_s, !ROW_MAX,
        [&](int tile, const bf16* ks, const bf16* vs) {
          float s[BN / 8][4];
          qk_tile<D, BN>(s, qf, ks, lane);
          if (MASK && tile * BN + BN > i0 + 1)
            mask_tile<BN>(s, tile * BN, row0, lane, S, 1, MASKED);
          if (EXP) {
            float rs[2];
            exp_rows<BN>(s, m, rs);
          } else if (ROW_MAX) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[j][e] -= m[e >> 1];
          }
          if (FULL_SOFTMAX) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[j][e] /= l[e >> 1];
          }
          pv_tile<D, BN>(o, s, vs, lane);
        });
    const float one[2] = {1.f, 1.f};
    store_rows<D>(out + base + (size_t)(i0 + warp * 16) * D, D, 16, o, one,
                  q_s + warp * 16 * LD, lane);
  }
}

template <int LEVEL, int HEADS, int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, cudaStream_t stream) {
  constexpr size_t smem = tiles_smem_bytes<BM, BN, D>();
  const cudaError_t err =
      allow_smem(attn_dissect_kernel<LEVEL, HEADS, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH / HEADS, S / BM);
  attn_dissect_kernel<LEVEL, HEADS, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S);
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
// make2h(3)) and BH even. Returns cudaGetLastError().
extern "C" int attn_dissect_launch(int level, int two_heads, const void* q,
                                   const void* k, const void* v, void* out,
                                   int BH, int S, int D, void* stream) {
  if (BH < 1 || S < BM || S % BM) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear a stale non-sticky error from earlier work
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dispatch_level<32>(level, two_heads, q, k, v, out, BH, S, s);
    case 64: return dispatch_level<64>(level, two_heads, q, k, v, out, BH, S, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
