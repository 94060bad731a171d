// Flash attention backward: dQ, dK and dV from the forward's per-row
// logsumexp, causal or not, with no S x S matrix in device memory.
//
// Replaces:
//   * ray_tpu/ops/flash_attention.py::_dq_kernel (pallas_call at :375) with
//     flash_bwd_dq_mma_kernel<D> in bf16, dq_kernel in f32 (entry
//     flash_bwd_dq_launch);
//   * ::_dkv_kernel (pallas_call at :397) with flash_bwd_dkv_mma_kernel<D>
//     in bf16, dkv_kernel in f32 (entry flash_bwd_dkv_launch);
//   * ::_packed_bwd_kernel (pallas_call at :587): the same kernels, run by
//     the Python wrapper flash_attention_packed_bwd on the strides of a
//     packed [B, S, 3E] qkv, writing dq, dk and dv straight into the column
//     ranges [0, E), [E, 2E), [2E, 3E) of one dqkv tensor.
// delta_kernel (entry flash_bwd_delta_launch) is the pre-pass both need:
// delta = rowsum(dO * O) in f32, which the reference computes in XLA (:681)
// or inside the packed kernel (:503).
//
// Bound on this card: operations. The two kernels do 14 * D flops per
// (query, key) pair below the diagonal (dq: S, dP, dQ; dkv: S^T, dP^T, dV,
// dK) against a few bytes per row, far above the card's flops-per-byte
// balance, so all five products have to run on the tensor cores.
// Both precisions share the split: two kernels with disjoint outputs and no
// atomics (every output is the same bit for bit from run to run). One block
// per (tile of 64 query rows, batch * head) walks the key tiles up to the
// causal diagonal and accumulates dQ; one block per (tile of 64 key rows,
// batch * head) walks the query tiles from the diagonal on and accumulates
// dK and dV. Each recomputes P = exp(q k^T - lse) for its pairs (the price
// of no atomics: the scores are computed twice). q is prescaled by sm_scale
// and rounded to the input type, as the reference rounds it, so dK =
// dS^T q_scaled carries the scale and dQ is scaled once at the end; masked
// pairs get P = 0 exactly; P and dS are rounded to the input type before
// their products, dS from the unrounded f32 P; every operand and output is
// read and written through (batch, seq, head) strides, so the packed
// layout needs no split, transpose or concatenation.
//
// bf16 (D in {32, 64, 128}): FlashAttention-2's backward on mma.sync
// m16n8k16 (bf16 in, f32 accumulate), ldmatrix and cp.async, built from the
// tile steps of attn_tiles.cuh that the forward uses. A block is 4 warps,
// each owning 16 of the block's 64 rows. Each of the five products is one
// of the two tile steps:
//   dq:  S = Q K^T and dP = dO V^T (qk_tile, Q and dO the A fragments, K
//        and V tiles streamed through the two-stage cp.async ring); P =
//        exp2(s log2(e) - lse log2(e)) against each row's saved lse, dS =
//        P (dP - delta); dQ += bf16(dS) K (pv_tile, K's B fragments by
//        ldmatrix.trans);
//   dkv: S^T = K q^T and dP^T = V dO^T (qk_tile, K and V the A fragments,
//        q and dO tiles streamed through the ring, each query tile's lse and
//        delta beside it by 4-byte cp.async), a transposed mask (query <
//        key or query >= S gives P = 0), P^T against each column's lse;
//        dV += bf16(P^T) dO and dK += bf16(dS^T) q_scaled (pv_tile).
//        Computed in this orientation, no P or dS tile is transposed through
//        shared memory.
// P and dS never leave registers: the m16n8 accumulator layout is the
// m16n8k16 A layout. The dkv kernel's q streams raw (cp.async cannot scale),
// so each staged q tile is prescaled in place after it lands (one pass over
// the tile and one barrier per tile) rather than making a prescaled copy
// of q per call. At D <= 64 each warp holds its A operands (Q and dO, or K
// and V) in registers for the whole sweep; at D = 128 the accumulators take
// 64 (dq) and 128 (dkv) registers a thread, so the A fragments are loaded
// from the block's shared copy at every tile instead. The dkv kernel
// streams 32-query tiles, the dq kernel 64-key tiles. Causal grids launch
// the heaviest tiles first: the last query tiles for dq, the first key
// tiles for dkv. dQ, dK and dV are staged through the warp's own rows of its
// A operand's shared copy and written with 16-byte stores. Still to come:
// wgmma with TMA, as in the forward.
//
// f32 (dq_kernel, dkv_kernel): the products stay on the CUDA cores in f32,
// since TF32 tensor cores keep about three decimal digits, which the f32
// paths (held to ~1e-6 against the plain versions) cannot take. A warp owns
// 8 rows of the tile and its lanes the 32 rows of the staged chunk, as in
// the forward's fold (attn_common.cuh): lane j scores chunk row j against
// all 8 rows, then every lane updates the output dimensions it owns with
// the chunk's dS (and P) broadcast one row at a time.
// The one-block backward (K3) is flash_bwd_fused.cu, on the same tile steps
// in bf16 and on the f32 helpers (flash_bwd_common.cuh) in f32.
#include "attn_tiles.cuh"
#include "flash_bwd_common.cuh"

using namespace rtt;

namespace {

// delta[bh * S + i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: one warp per row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, long long rows, int S, int H,
                 int D, View ov, View dov) {
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const int i = static_cast<int>(row % S);
  const long long bh = row / S;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const T* orow = row_ptr(o, ov, b, i, h);
  const T* drow = row_ptr(dout, dov, b, i, h);
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_f32(drow[d]) * to_f32(orow[d]);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// ------------------------------------------------- f32: CUDA-core kernels

// dQ (the reference's _dq_kernel): block (query tile, batch * head).
__global__ void __launch_bounds__(THREADS) dq_kernel(Args<float> a) {
  extern __shared__ float smem[];
  const int S = a.S, H = a.H, D = a.D;
  float* q_s = smem;                 // [TILE][D] prescaled queries
  float* do_s = q_s + TILE * D;      // [TILE][D] dO rows
  float* k_c = do_s + TILE * D;      // [KC][D + 1] key chunk
  float* v_c = k_c + KC * (D + 1);   // [KC][D + 1] value chunk

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int i0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  stage_tile(a.q, a.qv, b, h, i0, S, D, q_s, Prescale<float>{a.scale});
  stage_tile(a.dout, a.dov, b, h, i0, S, D, do_s, ToF32());

  int row[RPW];
  float lse[RPW], delta[RPW], acc[RPW][MAXE];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int lr = warp * RPW + r, i = i0 + lr;
    row[r] = i < S ? lr : -1;
    lse[r] = i < S ? a.lse[(size_t)bh * S + i] : 0.f;
    delta[r] = i < S ? a.delta[(size_t)bh * S + i] : 0.f;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) acc[r][e] = 0.f;
  }

  const float* kb = row_ptr(a.k, a.kv, b, 0, h);
  const float* vb = row_ptr(a.v, a.vv, b, 0, h);
  const int k_end = a.causal ? min(S, i0 + TILE) : S;
  for (int k0 = 0; k0 < k_end; k0 += KC) {
    __syncthreads();  // the previous chunk is consumed (the tiles are staged)
    auto k_row = [&](int j) -> long long {
      return k0 + j < k_end ? (k0 + j) * a.kv.ss : -1;
    };
    auto v_row = [&](int j) -> long long {
      return k0 + j < k_end ? (k0 + j) * a.vv.ss : -1;
    };
    stage_rows<THREADS>(kb, k_row, D, tid, k_c, D + 1);
    stage_rows<THREADS>(vb, v_row, D, tid, v_c, D + 1);
    __syncthreads();
    // Lane j: key k0 + j against the warp's rows. s = q_s . k, dp = dO . v.
    float s[RPW], dp[RPW], ds[RPW];
    two_scores(k_c + lane * (D + 1), v_c + lane * (D + 1), q_s, do_s, row, D,
               s, dp);
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = i0 + row[r];
      const bool valid = row[r] >= 0 && key < k_end && (!a.causal || key <= i);
      const float p = valid ? expf(s[r] - lse[r]) : 0.f;
      ds[r] = p * (dp[r] - delta[r]);
    }
    // dQ += dS . K, one key row at a time.
    const int nk = min(KC, k_end - k0);
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float kj[MAXE];
#pragma unroll
      for (int e = 0; e < MAXE; ++e) {
        const int d = lane + 32 * e;
        kj[e] = d < D ? k_c[j * (D + 1) + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float dsj = __shfl_sync(FULL, ds[r], j);
#pragma unroll
        for (int e = 0; e < MAXE; ++e) acc[r][e] = fmaf(dsj, kj[e], acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (row[r] < 0) continue;
    float* out = a.dq + b * a.dqv.sb + (i0 + row[r]) * a.dqv.ss + h * a.dqv.sh;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) out[d] = acc[r][e] * a.scale;
    }
  }
}

// dK and dV (the reference's _dkv_kernel): block (key tile, batch * head).
__global__ void __launch_bounds__(THREADS) dkv_kernel(Args<float> a) {
  extern __shared__ float smem[];
  const int S = a.S, H = a.H, D = a.D;
  float* k_s = smem;                 // [TILE][D] the block's keys
  float* v_s = k_s + TILE * D;       // [TILE][D] its values
  float* q_c = v_s + TILE * D;       // [KC][D + 1] prescaled query chunk
  float* do_c = q_c + KC * (D + 1);  // [KC][D + 1] dO chunk

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int j0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  stage_tile(a.k, a.kv, b, h, j0, S, D, k_s, ToF32());
  stage_tile(a.v, a.vv, b, h, j0, S, D, v_s, ToF32());

  int row[RPW];
  float dk[RPW][MAXE], dv[RPW][MAXE];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int lr = warp * RPW + r;
    row[r] = j0 + lr < S ? lr : -1;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) dk[r][e] = dv[r][e] = 0.f;
  }

  const float* qb = row_ptr(a.q, a.qv, b, 0, h);
  const float* db = row_ptr(a.dout, a.dov, b, 0, h);
  const Prescale<float> prescale{a.scale};
  // Causal: query chunks wholly above the tile's first key see none of it.
  for (int q0 = a.causal ? j0 : 0; q0 < S; q0 += KC) {
    __syncthreads();
    auto q_row = [&](int j) -> long long {
      return q0 + j < S ? (q0 + j) * a.qv.ss : -1;
    };
    auto do_row = [&](int j) -> long long {
      return q0 + j < S ? (q0 + j) * a.dov.ss : -1;
    };
    stage_rows<THREADS>(qb, q_row, D, tid, q_c, D + 1, prescale);
    stage_rows<THREADS>(db, do_row, D, tid, do_c, D + 1);
    __syncthreads();
    // Lane i: query q0 + i against the warp's keys. s = q . k, dp = dO . v.
    const int qi = q0 + lane;
    const float lse = qi < S ? a.lse[(size_t)bh * S + qi] : 0.f;
    const float delta = qi < S ? a.delta[(size_t)bh * S + qi] : 0.f;
    float s[RPW], dp[RPW], p[RPW], ds[RPW];
    two_scores(q_c + lane * (D + 1), do_c + lane * (D + 1), k_s, v_s, row, D,
               s, dp);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int key = j0 + row[r];
      const bool valid = row[r] >= 0 && qi < S && (!a.causal || qi >= key);
      p[r] = valid ? expf(s[r] - lse) : 0.f;
      ds[r] = p[r] * (dp[r] - delta);
    }
    // dV += P^T dO and dK += dS^T q_scaled, one query row at a time.
    const int nq = min(KC, S - q0);
#pragma unroll 4
    for (int i = 0; i < nq; ++i) {
      float qv[MAXE], gv[MAXE];
#pragma unroll
      for (int e = 0; e < MAXE; ++e) {
        const int d = lane + 32 * e;
        qv[e] = d < D ? q_c[i * (D + 1) + d] : 0.f;
        gv[e] = d < D ? do_c[i * (D + 1) + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pi = __shfl_sync(FULL, p[r], i);
        const float dsi = __shfl_sync(FULL, ds[r], i);
#pragma unroll
        for (int e = 0; e < MAXE; ++e) {
          dv[r][e] = fmaf(pi, gv[e], dv[r][e]);
          dk[r][e] = fmaf(dsi, qv[e], dk[r][e]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (row[r] < 0) continue;
    const int j = j0 + row[r];
    float* ko = a.dk + b * a.dkv.sb + j * a.dkv.ss + h * a.dkv.sh;
    float* vo = a.dv + b * a.dvv.sb + j * a.dvv.ss + h * a.dvv.sh;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) {
        ko[d] = dk[r][e];
        vo[d] = dv[r][e];
      }
    }
  }
}

// ----------------------------------------- bf16: tensor-core kernels

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int BM = 16 * MMA_WARPS;  // a block's rows: queries (dq), keys (dkv)
constexpr int DQ_BN = 64;           // keys per K / V tile of the dq kernel
// Queries per q / dO tile of the dkv kernel. Its dK and dV accumulators take
// D registers a thread and K and V's fragments D / 2 more, so 32-query
// tiles keep the score fragments beside them small. At D = 64, with a
// register cap for three blocks per SM, they ran faster on an H100 than
// 64-query tiles, uncapped (two blocks per SM) or capped to three (which
// spills), and than 32-query tiles capped to four.
constexpr int DKV_BQ = 32;

// Blocks per SM asked of __launch_bounds__ by both kernels: three at
// D <= 64 (left to itself, ptxas gives the dq kernel 182 registers at
// D = 64, two blocks per SM); at D = 128 registers allow two whatever the
// cap, and a cap would spill.
template <int D>
__host__ __device__ constexpr int min_blocks() {
  return D <= 64 ? 3 : 1;
}

// Whether a warp holds its A operands in registers for the whole sweep
// (D <= 64) or loads them from the block's shared copy at every tile.
template <int D>
__host__ __device__ constexpr bool hold_a() {
  return D <= 64;
}

template <int D>
using AFrags = uint32_t[hold_a<D>() ? D / 16 : 1][4];

// Scores of this warp's 16 rows of A against a staged tile of BN rows:
// A's fragments held in `held`, or loaded from rows a_row0 .. a_row0 + 15
// of A's staged tile `a_s`.
template <int D, int BN>
__device__ __forceinline__ void tile_scores(float (&s)[BN / 8][4],
                                            const AFrags<D>& held,
                                            const bf16* a_s, int a_row0,
                                            const bf16* tile, int lane) {
  if constexpr (hold_a<D>()) {
    qk_tile<D, BN>(s, held, tile, lane);
  } else {
    uint32_t af[D / 16][4];
    warp_a_frags<D>(af, a_s, a_row0, lane);
    qk_tile<D, BN>(s, af, tile, lane);
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (2 * BM + 4 * DQ_BN) * tile_ld<D>();
}
template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * (2 * BM + 4 * DKV_BQ) * tile_ld<D>() +
         sizeof(float) * 4 * DKV_BQ;
}

// dQ: block (batch * head, query tile; causal grids count the tiles down
// from the last).
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, min_blocks<D>())
    flash_bwd_dq_mma_kernel(Args<bf16> a) {
  constexpr int LD = tile_ld<D>(), BN = DQ_BN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD] prescaled q
  bf16* do_s = q_s + BM * LD;                     // [BM][LD] dO
  bf16* k_s = do_s + BM * LD;                     // [2][BN][LD]
  bf16* v_s = k_s + 2 * BN * LD;                  // [2][BN][LD]

  const int S = a.S, H = a.H, causal = a.causal;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int i0 = qt * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = i0 + warp * 16 + (lane >> 2);  // rows row0, row0 + 8
  const KVRows kv{row_ptr(a.k, a.kv, b, 0, h), row_ptr(a.v, a.vv, b, 0, h),
                  a.kv.ss, a.vv.ss, S};
  const int k_end = causal ? min(S, i0 + BM) : S;
  const int n_tiles = (k_end + BN - 1) / BN;

  // K / V tile 0 is in flight while q (prescaled) and dO are staged.
  start_tile_copy<BN, D, MMA_THREADS, true>(kv, 0, 0, k_s, v_s);
  cp_async_commit();
  stage_tile_rows<BM, D, MMA_THREADS>(q_s, row_ptr(a.q, a.qv, b, 0, h),
                                      a.qv.ss, i0, S, a.scale);
  stage_tile_rows<BM, D, MMA_THREADS>(do_s, row_ptr(a.dout, a.dov, b, 0, h),
                                      a.dov.ss, i0, S, 1.f);
  __syncthreads();
  const int w_row = warp * 16;  // this warp's first row of the block
  AFrags<D> qf, dof;
  if constexpr (hold_a<D>()) {
    warp_a_frags<D>(qf, q_s, w_row, lane);
    warp_a_frags<D>(dof, do_s, w_row, lane);
  }
  float lse2[2], delta[2];  // lse * log2(e) and delta of rows row0, row0 + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    lse2[r] = i < S ? a.lse[(size_t)bh * S + i] * LOG2E : 0.f;
    delta[r] = i < S ? a.delta[(size_t)bh * S + i] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  sweep_tiles<BN, D, MMA_THREADS, true>(
      kv, n_tiles, k_s, v_s, true,
      [&](int tile, const bf16* ks, const bf16* vs) {
        float s[BN / 8][4], dp[BN / 8][4];
        tile_scores<D, BN>(s, qf, q_s, w_row, ks, lane);
        // Only the diagonal tiles and the ragged end are masked: a masked
        // score becomes -inf, so its P is exp2(-inf) = 0 exactly.
        const int k0 = tile * BN;
        if ((causal && k0 + BN > i0 + 1) || k0 + BN > S)
          mask_tile<BN>(s, k0, row0, lane, S, causal, -INFINITY);
        tile_scores<D, BN>(dp, dof, do_s, w_row, vs, lane);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(fmaf(s[j][e], LOG2E, -lse2[e >> 1]));
            s[j][e] = p * (dp[j][e] - delta[e >> 1]);  // dS, f32
          }
        pv_tile<D, BN>(acc, s, ks, lane);  // dQ += bf16(dS) K
      });

#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] *= a.scale;
  const int w0 = i0 + w_row;
  const float one[2] = {1.f, 1.f};
  store_rows<D>(a.dq + b * a.dqv.sb + (long long)w0 * a.dqv.ss + h * a.dqv.sh,
                a.dqv.ss, S - w0, acc, one, q_s + w_row * LD, lane);
}

// dK and dV: block (batch * head, key tile; the first key tiles, which see
// the most queries, start first).
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, min_blocks<D>())
    flash_bwd_dkv_mma_kernel(Args<bf16> a) {
  constexpr int LD = tile_ld<D>(), BQ = DKV_BQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD] the block's K
  bf16* v_s = k_s + BM * LD;                      // [BM][LD] its V
  bf16* q_r = v_s + BM * LD;                      // [2][BQ][LD] q tiles
  bf16* do_r = q_r + 2 * BQ * LD;                 // [2][BQ][LD] dO tiles
  float* lse_r = reinterpret_cast<float*>(do_r + 2 * BQ * LD);  // [2][BQ]
  float* delta_r = lse_r + 2 * BQ;                              // [2][BQ]

  const int S = a.S, H = a.H, causal = a.causal;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j0 = blockIdx.y * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int key0 = j0 + warp * 16 + (lane >> 2);  // keys key0, key0 + 8
  // Causal: queries before the block's first key see none of its keys.
  const int q_start = causal ? j0 : 0;
  const int n_q = S - q_start;
  const int n_tiles = (n_q + BQ - 1) / BQ;
  const KVRows qd{row_ptr(a.q, a.qv, b, q_start, h),
                  row_ptr(a.dout, a.dov, b, q_start, h), a.qv.ss, a.dov.ss,
                  n_q};
  const float* lse_h = a.lse + (size_t)bh * S + q_start;
  const float* delta_h = a.delta + (size_t)bh * S + q_start;
  // Each query tile's lse and delta, one float a thread, beside its rows.
  auto stage_lse_delta = [&](int tile, int stage) {
    const int c = threadIdx.x;
    if (c < 2 * BQ) {
      const int r = c % BQ, i = tile * BQ + r;
      const bool valid = i < n_q;
      const float* src = (c < BQ ? lse_h : delta_h) + (valid ? i : 0);
      cp_async4((c < BQ ? lse_r : delta_r) + stage * BQ + r, src, valid);
    }
  };

  // Query tile 0 is in flight while K and V are staged.
  start_tile_copy<BQ, D, MMA_THREADS, true>(qd, 0, 0, q_r, do_r);
  stage_lse_delta(0, 0);
  cp_async_commit();
  stage_tile_rows<BM, D, MMA_THREADS>(k_s, row_ptr(a.k, a.kv, b, 0, h),
                                      a.kv.ss, j0, S, 1.f);
  stage_tile_rows<BM, D, MMA_THREADS>(v_s, row_ptr(a.v, a.vv, b, 0, h),
                                      a.vv.ss, j0, S, 1.f);
  __syncthreads();
  const int w_row = warp * 16;  // this warp's first row of the block
  AFrags<D> kf, vf;
  if constexpr (hold_a<D>()) {
    warp_a_frags<D>(kf, k_s, w_row, lane);
    warp_a_frags<D>(vf, v_s, w_row, lane);
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  const int t2 = 2 * (lane & 3);  // this lane's first column of each n8 tile
  sweep_tiles<BQ, D, MMA_THREADS, true>(
      qd, n_tiles, q_r, do_r, true, stage_lse_delta,
      [&](int tile, bf16* qs, const bf16* dos) {
        // q streams raw: prescale the landed tile in place (the
        // reference's rounding), then let every warp read it.
        scale_tile<BQ, D, MMA_THREADS>(qs, a.scale);
        __syncthreads();
        const float* lse_t = lse_r + (tile & 1) * BQ;
        const float* delta_t = delta_r + (tile & 1) * BQ;
        float st[BQ / 8][4], dpt[BQ / 8][4];
        tile_scores<D, BQ>(st, kf, k_s, w_row, qs, lane);  // S^T = K q_scaled^T
        const int q0 = q_start + tile * BQ;
        if ((causal && q0 < j0 + BM - 1) || q0 + BQ > S)
          mask_queries<BQ>(st, q0, key0, lane, S, causal);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lse_t + j * 8 + t2);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[j][e] = exp2f(fmaf(st[j][e], LOG2E, -(e & 1 ? l.y : l.x) * LOG2E));
        }
        pv_tile<D, BQ>(dv, st, dos, lane);  // dV += bf16(P^T) dO
        tile_scores<D, BQ>(dpt, vf, v_s, w_row, dos, lane);  // dP^T = V dO^T
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(delta_t + j * 8 + t2);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[j][e] *= dpt[j][e] - (e & 1 ? dl.y : dl.x);  // dS^T, f32
        }
        pv_tile<D, BQ>(dk, st, qs, lane);  // dK += bf16(dS^T) q_scaled
      });

  const int w0 = j0 + w_row;
  const float one[2] = {1.f, 1.f};
  store_rows<D>(a.dk + b * a.dkv.sb + (long long)w0 * a.dkv.ss + h * a.dkv.sh,
                a.dkv.ss, S - w0, dk, one, k_s + w_row * LD, lane);
  store_rows<D>(a.dv + b * a.dvv.sb + (long long)w0 * a.dvv.ss + h * a.dvv.sh,
                a.dvv.ss, S - w0, dv, one, v_s + w_row * LD, lane);
}

// Fill Args from the C arguments; st holds the (batch, seq, head) element
// strides of q, k, v, dout, dq, dk, dv in that order (21 values).
template <typename T>
Args<T> make_args(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, void* dk, void* dv, int S, int H, int D,
                  const long long* st, float scale, int causal) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.dout = static_cast<const T*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  View* views[7] = {&a.qv, &a.kv, &a.vv, &a.dov, &a.dqv, &a.dkv, &a.dvv};
  for (int i = 0; i < 7; ++i) *views[i] = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.S = S;
  a.H = H;
  a.D = D;
  a.scale = scale;
  a.causal = causal;
  return a;
}

// which: 0 launches dq_kernel, 1 dkv_kernel (same grid, same shared memory).
int launch_f32(int which, const Args<float>& a, int B, cudaStream_t stream) {
  void (*kernel)(Args<float>) = which == 0 ? dq_kernel : dkv_kernel;
  const size_t smem = sizeof(float) * (2 * TILE * a.D + 2 * KC * (a.D + 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.S + TILE - 1) / TILE, B * a.H);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// which: 0 launches flash_bwd_dq_mma_kernel<D>, 1 flash_bwd_dkv_mma_kernel<D>;
// both on the grid (batch * head, tiles of BM rows).
template <int D>
int launch_mma(int which, const Args<bf16>& a, int B, cudaStream_t stream) {
  void (*kernel)(Args<bf16>) =
      which == 0 ? flash_bwd_dq_mma_kernel<D> : flash_bwd_dkv_mma_kernel<D>;
  const size_t smem = which == 0 ? dq_smem_bytes<D>() : dkv_smem_bytes<D>();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * a.H, (a.S + BM - 1) / BM);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The dtype picks the kernels: f32 keeps full f32 math on the CUDA cores,
// bf16 runs on the tensor cores for the head_dims it is instantiated for
// (the wrappers refuse the others before launching).
int grad_entry(int which, int dtype, const void* q, const void* k,
               const void* v, const void* dout, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, int B, int S,
               int H, int D, const long long* st, float scale, int causal,
               void* stream) {
  if (D < 4 || D > 32 * MAXE || D % 4 || B < 1 || S < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear a stale non-sticky error from earlier work
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(which,
                      make_args<float>(q, k, v, dout, lse, delta, dq, dk, dv,
                                       S, H, D, st, scale, causal),
                      B, s);
  if (dtype == 1) {
    const Args<bf16> a = make_args<bf16>(q, k, v, dout, lse, delta, dq, dk,
                                         dv, S, H, D, st, scale, causal);
    switch (D) {
      case 32:
        return launch_mma<32>(which, a, B, s);
      case 64:
        return launch_mma<64>(which, a, B, s);
      case 128:
        return launch_mma<128>(which, a, B, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. o, dout: [B, S, H, D] with element
// strides st = (o: batch, seq, head; dout: batch, seq, head) and a unit
// last-dim stride; delta is [B*H, S] f32. Returns cudaGetLastError().
extern "C" int flash_bwd_delta_launch(int dtype, const void* o,
                                      const void* dout, void* delta, int B,
                                      int S, int H, int D,
                                      const long long* st, void* stream) {
  if (D < 1 || B < 1 || S < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  const long long rows = static_cast<long long>(B) * H * S;
  const View ov{st[0], st[1], st[2]}, dov{st[3], st[4], st[5]};
  const dim3 grid(static_cast<unsigned>((rows + WARPS - 1) / WARPS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(delta);
  if (dtype == 0) {
    delta_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), d,
        rows, S, H, D, ov, dov);
  } else if (dtype == 1) {
    delta_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), d, rows, S, H, D, ov, dov);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16 (head_dim 32, 64 or 128). q (not
// prescaled), k, v, dout: [B, S, H, D] inputs; lse, delta: [B*H, S] f32;
// dq (this entry) or dk and dv (the next) are written through their
// strides. st: 21 element strides, (batch, seq, head) of q, k, v, dout, dq,
// dk, dv. Returns cudaGetLastError().
extern "C" int flash_bwd_dq_launch(int dtype, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, int B, int S,
                                   int H, int D, const long long* st,
                                   float scale, int causal, void* stream) {
  return grad_entry(0, dtype, q, k, v, dout, lse, delta, dq, dk, dv, B, S, H,
                    D, st, scale, causal, stream);
}

extern "C" int flash_bwd_dkv_launch(int dtype, const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, void* dk, void* dv, int B, int S,
                                    int H, int D, const long long* st,
                                    float scale, int causal, void* stream) {
  return grad_entry(1, dtype, q, k, v, dout, lse, delta, dq, dk, dv, B, S, H,
                    D, st, scale, causal, stream);
}
