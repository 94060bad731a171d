// One-pass flash attention backward (K3): dQ, dK and dV from the forward's
// per-row logsumexp in one sweep over the (query, key) pairs, with
// delta = rowsum(dO * O) computed inside the kernel (no pre-pass launch).
//
// Replaces ray_tpu/ops/flash_attention.py::_bwd_fused_kernel (:288,
// pallas_call at :334), which the reference runs when one block covers the
// whole sequence (:674): one TPU program holds the [S, S] score tile in VMEM
// and does five products on it (S, dP, dV, dK, dQ). An SM holds no [S, S]
// tile at S = 1024, so the design here tiles the keys: one block per (tile
// of key rows, batch * head) walks the query tiles from the causal diagonal
// on, keeps its dK and dV in f32 registers, recomputes P = exp(q k^T - lse)
// once per pair for all three gradients, and stores its key tile's partial
// dQ of every query row it sees in the tile's own slice of an f32
// workspace. A second small launch (dq_finish_kernel) sums each dQ
// element's partials in key-tile order, scales by sm_scale once and writes
// dQ in the input type through its strides. The order of every sum is
// fixed, so dQ, like dK and dV, is the same bit for bit from run to run
// (the reference's one program per head is deterministic too); atomics
// would order the adds as the blocks happen to be scheduled.
//
// Rounding points are the reference's: q is prescaled and rounded to its
// type as it is staged, so dK carries sm_scale; P is rounded to dO's type
// before dV = P^T dO; dS = P * (dP - delta), from the unrounded f32 P, is
// rounded to q's type before dK = dS^T q_scaled and dQ = dS K; dQ is scaled
// once at the end. Masked pairs get P = 0 exactly.
//
// Bound on this card: operations. The five products are 10 * D flops per
// causal pair (32.2 GFLOP at B8 S1024 H12 D64, 0.033 ms at the tensor
// cores' 989 TFLOP/s) against a few bytes per row, so they have to run on
// the tensor cores. The design's own cost beside them is the workspace:
// per (batch * head), S^2 / (2 BM) rows of D f32 when causal (BM keys a
// block), written once and read once.
//
// bf16 (D in {32, 64, 128}): flash_bwd_fused_mma_kernel<D> is
// flash_bwd.cu's dK/dV kernel with three additions, all on attn_tiles.cuh's
// tile steps (mma.sync m16n8k16, ldmatrix, the two-stage cp.async ring).
// Eight warps own 16 keys each (BM = 128); each 32-query tile of q and dO
// streams through the ring with its lse (4-byte cp.async) and its O tile
// beside it (the `extra` hook). Per tile:
//   1. q is prescaled in place, and delta of the tile's rows is computed
//      from the staged dO and O (a warp per 4 rows, lanes over D);
//   2. S^T = K q_scaled^T and dP^T = V dO^T (qk_tile, K and V the A
//      operands), P^T against each column's lse, dV += bf16(P^T) dO and
//      dK += bf16(dS^T) q_scaled (pv_tile): P^T and dS^T are already the A
//      fragments, nothing is transposed;
//   3. each warp stores its bf16(dS^T) fragment, 16 keys x 32 queries, in a
//      shared [BM][32] tile; after a barrier the warps split the tile's
//      [32 x D] partial dQ = dS K into two halves of the queries by four
//      parts of D. dS's A fragments come from that tile and K's B fragments
//      from the block's staged K, both by ldmatrix.trans, 32 columns of D
//      at a time (the accumulators live only in this step), and the f32
//      result goes to the workspace with 16-byte stores after one quad
//      shuffle.
// dq_finish_kernel reads the partials with 16-byte loads and writes dQ with
// 16-byte stores. K and V's A fragments are reloaded from shared memory at
// every tile, so that 128 registers a thread fit two blocks per SM at
// D <= 64. A block of 128 keys halves the workspace of 64 keys (4 warps,
// A fragments held in registers, three blocks per SM); on an H100 at the
// trainer's shape its pass over the pairs also ran faster, and its finish
// in about half the time (PERF.md).
//
// f32 (fused_bwd_f32_kernel): the products stay on the CUDA cores in f32,
// since TF32 tensor cores keep about three decimal digits, which the f32
// path (held to ~1e-6 against the plain version) cannot take. One block per
// 64 key rows (a warp owns 8), 32-query chunks staged as f32; lane i scores
// query i against the warp's keys, dV and dK take the chunk's P and dS one
// query at a time, and every thread sums dS K for D / 8 (query, dim)
// outputs of the chunk.
#include "attn_tiles.cuh"
#include "flash_bwd_common.cuh"

using namespace rtt;

namespace {

// First row of key tile t's slice in one (batch * head)'s part of the
// partial-dQ workspace, for key tiles of `bm` rows: causal tile u holds the
// S - u * bm query rows from its first key on, a non-causal tile all S rows.
__host__ __device__ __forceinline__ long long part_offset(int t, int S,
                                                          int causal, int bm) {
  const long long tl = t;
  return causal ? tl * S - bm * tl * (tl - 1) / 2 : tl * S;
}

template <typename T>
struct FusedArgs {
  const T *q, *k, *v, *o, *dout;
  const float* lse;  // [B*H, S] f32
  float* dq_part;    // [B*H, part_offset(n_tiles), D] f32 partial dQ sums
  T *dk, *dv;
  View qv, kv, vv, ov, dov, dkv, dvv;
  int S, H, D;
  float scale;
  int causal;
};

// ------------------------------------------------- f32: CUDA-core kernel

__global__ void __launch_bounds__(THREADS)
    fused_bwd_f32_kernel(FusedArgs<float> a) {
  extern __shared__ float smem[];
  const int S = a.S, H = a.H, D = a.D;
  float* k_s = smem;                    // [TILE][D] the block's keys
  float* v_s = k_s + TILE * D;          // [TILE][D] its values
  float* q_c = v_s + TILE * D;          // [KC][D + 1] prescaled query chunk
  float* do_c = q_c + KC * (D + 1);     // [KC][D + 1] dO chunk
  float* ds_c = do_c + KC * (D + 1);    // [KC][TILE + 1] dS of the chunk
  float* delta_c = ds_c + KC * (TILE + 1);  // [KC] delta of the chunk

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
  // dQ outputs of this thread in a chunk: query qo, dims dd, dd + 8, ...
  const int qo = tid >> 3, dd = tid & 7;
  const int n_keys = min(TILE, S - j0);

  const float* qb = row_ptr(a.q, a.qv, b, 0, h);
  const float* db = row_ptr(a.dout, a.dov, b, 0, h);
  const Prescale<float> prescale{a.scale};
  // This tile's slice of partial dQ sums: query rows first_q .. S - 1.
  // Causal: query chunks wholly above the tile's first key see none of it.
  const int first_q = a.causal ? j0 : 0;
  const int n_tiles = (S + TILE - 1) / TILE;
  float* dq_rows = a.dq_part +
                   ((size_t)bh * part_offset(n_tiles, S, a.causal, TILE) +
                    part_offset(blockIdx.x, S, a.causal, TILE)) * D;
  for (int q0 = first_q; q0 < S; q0 += KC) {
    __syncthreads();  // the previous chunk's dS and delta are consumed
    auto q_row = [&](int j) -> long long {
      return q0 + j < S ? (q0 + j) * a.qv.ss : -1;
    };
    auto do_row = [&](int j) -> long long {
      return q0 + j < S ? (q0 + j) * a.dov.ss : -1;
    };
    stage_rows<THREADS>(qb, q_row, D, tid, q_c, D + 1, prescale);
    stage_rows<THREADS>(db, do_row, D, tid, do_c, D + 1);
    __syncthreads();
    // delta of the chunk's rows: warp w takes rows 4w .. 4w + 3.
#pragma unroll
    for (int x = 0; x < KC / WARPS; ++x) {
      const int i = warp * (KC / WARPS) + x, qi = q0 + i;
      float acc = 0.f;
      if (qi < S) {
        const float* orow = row_ptr(a.o, a.ov, b, qi, h);
        for (int d = lane; d < D; d += 32) acc += do_c[i * (D + 1) + d] * orow[d];
      }
      acc = warp_sum(acc);
      if (lane == 0) delta_c[i] = acc;
    }
    __syncthreads();
    // Lane i: query q0 + i against the warp's keys. s = q . k, dp = dO . v.
    const int qi = q0 + lane;
    const float lse = qi < S ? a.lse[(size_t)bh * S + qi] : 0.f;
    const float delta = delta_c[lane];
    float s[RPW], dp[RPW], p[RPW], ds[RPW];
    two_scores(q_c + lane * (D + 1), do_c + lane * (D + 1), k_s, v_s, row, D,
               s, dp);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int key = j0 + row[r];
      const bool valid = row[r] >= 0 && qi < S && (!a.causal || qi >= key);
      p[r] = valid ? expf(s[r] - lse) : 0.f;
      ds[r] = p[r] * (dp[r] - delta);
      ds_c[lane * (TILE + 1) + warp * RPW + r] = ds[r];
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
    __syncthreads();  // the chunk's dS is in shared memory
    // This tile's part of dQ[q0 + qo] = dS[qo, :] K over the tile's keys,
    // for dims dd + 8 e, stored in its slice.
    if (qo < nq) {
      const float* ds_row = ds_c + qo * (TILE + 1);
      float* out = dq_rows + (size_t)(q0 + qo - first_q) * D;
      for (int d = dd; d < D; d += 8) {
        float acc = 0.f;
        for (int j = 0; j < n_keys; ++j) acc = fmaf(ds_row[j], k_s[j * D + d], acc);
        out[d] = acc;
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

// ----------------------------------------- bf16: tensor-core kernel

constexpr int NW = 8;           // warps of a block, 16 keys each
constexpr int BM = 16 * NW;     // keys of a block
constexpr int BQ = 32;          // queries per streamed q / dO / O tile
constexpr int DS_LD = BQ + 8;   // row stride of the shared dS^T tile: 80
                                // bytes put ldmatrix's 8 rows in distinct banks

// Dynamic shared memory: K and V [BM], two stages each of q, dO and O
// [BQ] (rows padded to tile_ld<D>()), the dS^T tile [BM][DS_LD], two stages
// of lse [BQ] and delta [BQ].
template <int D>
constexpr size_t fused_smem_bytes() {
  return sizeof(bf16) * ((2 * BM + 6 * BQ) * tile_ld<D>() + BM * DS_LD) +
         sizeof(float) * 3 * BQ;
}

// Scores of this warp's 16 rows of A (rows a_row0 .. a_row0 + 15 of the
// block's staged A, loaded as fragments at every tile) against a staged
// tile of BQ rows.
template <int D>
__device__ __forceinline__ void tile_scores(float (&s)[BQ / 8][4],
                                            const bf16* a_s, int a_row0,
                                            const bf16* tile, int lane) {
  uint32_t af[D / 16][4];
  warp_a_frags<D>(af, a_s, a_row0, lane);
  qk_tile<D, BQ>(s, af, tile, lane);
}

// delta[i] = sum_d dO[i, d] O[i, d] in f32 of the BQ rows of a staged tile:
// warp w takes rows (BQ / NW) w onwards, its lanes bf16 pairs along D.
template <int D>
__device__ __forceinline__ void tile_deltas(float* delta, const bf16* dos,
                                            const bf16* os, int warp,
                                            int lane) {
  constexpr int LD = tile_ld<D>(), R = BQ / NW;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = warp * R + r;
    float acc = 0.f;
#pragma unroll
    for (int d = 2 * lane; d < D; d += 64) {
      const float2 g = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dos + i * LD + d));
      const float2 o = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(os + i * LD + d));
      acc = fmaf(g.x, o.x, acc);
      acc = fmaf(g.y, o.y, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) delta[i] = acc;
  }
}

// This warp's bf16(dS^T) fragment (keys w_row .. w_row + 15, the tile's BQ
// queries) into the shared [BM][DS_LD] tile, rounded as pv_tile rounds it
// for dK.
__device__ __forceinline__ void store_ds(bf16* ds_s, const float (&st)[BQ / 8][4],
                                         int w_row, int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    *reinterpret_cast<uint32_t*>(ds_s + (w_row + g) * DS_LD + j * 8 + t2) =
        pack_bf16(st[j][0], st[j][1]);
    *reinterpret_cast<uint32_t*>(ds_s + (w_row + g + 8) * DS_LD + j * 8 + t2) =
        pack_bf16(st[j][2], st[j][3]);
  }
}

// The block's partial dQ of one query tile, dS [BQ x BM] K [BM x D], by
// this warp: queries 16 (warp % 2) .. + 15, columns DW (warp / 2) .. + DW -
// 1 of D, 32 at a time. dS's A fragments are read transposed from the
// shared dS^T tile, K's B fragments from the block's staged K (as pv_tile
// reads V). Rows at or past n_rows are not stored; `out` is the tile's
// first row in the workspace (row stride D).
template <int D>
__device__ __forceinline__ void dq_partial(float* out, int n_rows,
                                           const bf16* ds_s, const bf16* k_s,
                                           int warp, int lane) {
  constexpr int LD = tile_ld<D>(), DW = D / (NW / 2);
  constexpr int CW = DW < 32 ? DW : 32;
  const int m0 = (warp & 1) * 16, g = lane >> 2, t4 = lane & 3;
  const bool odd = t4 & 1;
  // After the exchange: row g (even lanes) or g + 8 (odd), 4 columns from
  // 4 (t4 / 2) of each n8 tile.
  const int row = m0 + g + (odd ? 8 : 0);
#pragma unroll
  for (int c0 = (warp >> 1) * DW; c0 < (warp >> 1) * DW + DW; c0 += CW) {
    float acc[CW / 8][4];
#pragma unroll
    for (int n = 0; n < CW / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4_trans(af, ds_s + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * DS_LD +
                                m0 + ((lane >> 3) & 1) * 8);
      if constexpr (CW >= 16) {
#pragma unroll
        for (int jd = 0; jd < CW / 16; ++jd) {
          uint32_t kf[4];
          ldmatrix_x4_trans(kf, k_s + (kk * 16 + (lane & 15)) * LD + c0 + jd * 16 +
                                    (lane >> 4) * 8);
          mma_bf16(acc[2 * jd], af, kf[0], kf[1]);
          mma_bf16(acc[2 * jd + 1], af, kf[2], kf[3]);
        }
      } else {
        uint32_t kf[2];
        ldmatrix_x2_trans(kf, k_s + (kk * 16 + (lane & 15)) * LD + c0);
        mma_bf16(acc[0], af, kf[0], kf[1]);
      }
    }
    // Lanes 2u and 2u + 1 of a quad swap a pair, so that each holds four
    // consecutive columns of one row: one 16-byte store.
#pragma unroll
    for (int n = 0; n < CW / 8; ++n) {
      const float r0 = __shfl_xor_sync(FULL, odd ? acc[n][0] : acc[n][2], 1);
      const float r1 = __shfl_xor_sync(FULL, odd ? acc[n][1] : acc[n][3], 1);
      const float4 v = odd ? make_float4(r0, r1, acc[n][2], acc[n][3])
                           : make_float4(acc[n][0], acc[n][1], r0, r1);
      if (row < n_rows)
        *reinterpret_cast<float4*>(out + (size_t)row * D + c0 + n * 8 + 2 * (t4 & 2)) = v;
    }
  }
}

// dK, dV and the partial dQ of one key tile: block (batch * head, key tile;
// the first key tiles, which see the most queries, start first). Two
// blocks an SM at D <= 64; at D = 128 what the registers allow.
template <int D>
__global__ void __launch_bounds__(32 * NW, D <= 64 ? 2 : 1)
    flash_bwd_fused_mma_kernel(FusedArgs<bf16> a) {
  constexpr int NT = 32 * NW, LD = tile_ld<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD] the block's K
  bf16* v_s = k_s + BM * LD;                      // [BM][LD] its V
  bf16* q_r = v_s + BM * LD;                      // [2][BQ][LD] q tiles
  bf16* do_r = q_r + 2 * BQ * LD;                 // [2][BQ][LD] dO tiles
  bf16* o_r = do_r + 2 * BQ * LD;                 // [2][BQ][LD] O tiles
  bf16* ds_s = o_r + 2 * BQ * LD;                 // [BM][DS_LD] bf16(dS^T)
  float* lse_r = reinterpret_cast<float*>(ds_s + BM * DS_LD);  // [2][BQ]
  float* delta_s = lse_r + 2 * BQ;                             // [BQ]

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
  const bf16* o_h = row_ptr(a.o, a.ov, b, q_start, h);
  const KVRows orows{o_h, o_h, a.ov.ss, a.ov.ss, n_q};
  const float* lse_h = a.lse + (size_t)bh * S + q_start;
  // This key tile's slice of the workspace: query rows q_start .. S - 1.
  float* dq_rows = a.dq_part +
                   ((size_t)bh * part_offset(gridDim.y, S, causal, BM) +
                    part_offset(blockIdx.y, S, causal, BM)) * D;
  // Each query tile's lse (one float a thread) and O rows beside q and dO.
  auto stage_lse_o = [&](int tile, int stage) {
    const int c = threadIdx.x;
    if (c < BQ) {
      const int i = tile * BQ + c;
      const bool valid = i < n_q;
      cp_async4(lse_r + stage * BQ + c, lse_h + (valid ? i : 0), valid);
    }
    start_tile_copy<BQ, D, NT, false>(orows, tile, stage, o_r, o_r);
  };

  // Query tile 0 is in flight while K and V are staged.
  start_tile_copy<BQ, D, NT, true>(qd, 0, 0, q_r, do_r);
  stage_lse_o(0, 0);
  cp_async_commit();
  stage_tile_rows<BM, D, NT>(k_s, row_ptr(a.k, a.kv, b, 0, h), a.kv.ss, j0, S, 1.f);
  stage_tile_rows<BM, D, NT>(v_s, row_ptr(a.v, a.vv, b, 0, h), a.vv.ss, j0, S, 1.f);
  __syncthreads();
  const int w_row = warp * 16;  // this warp's first row of the block

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  const int t2 = 2 * (lane & 3);  // this lane's first column of each n8 tile
  // Keys past S (the last tile's zero rows) get P = 0 like masked pairs.
  const bool key_tail = j0 + BM > S;
  sweep_tiles<BQ, D, NT, true>(
      qd, n_tiles, q_r, do_r, true, stage_lse_o,
      [&](int tile, bf16* qs, const bf16* dos) {
        // q streams raw: prescale the landed tile in place (the
        // reference's rounding); delta of its rows from dO and O.
        scale_tile<BQ, D, NT>(qs, a.scale);
        tile_deltas<D>(delta_s, dos, o_r + (tile & 1) * BQ * LD, warp, lane);
        __syncthreads();
        const float* lse_t = lse_r + (tile & 1) * BQ;
        float st[BQ / 8][4], dpt[BQ / 8][4];
        tile_scores<D>(st, k_s, w_row, qs, lane);  // S^T = K q_scaled^T
        const int q0 = q_start + tile * BQ;
        if ((causal && q0 < j0 + BM - 1) || q0 + BQ > S)
          mask_queries<BQ>(st, q0, key0, lane, S, causal);
        if (key_tail) {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (key0 + (e >> 1) * 8 >= S) st[j][e] = -INFINITY;
        }
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lse_t + j * 8 + t2);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[j][e] = exp2f(fmaf(st[j][e], LOG2E, -(e & 1 ? l.y : l.x) * LOG2E));
        }
        pv_tile<D, BQ>(dv, st, dos, lane);  // dV += bf16(P^T) dO
        tile_scores<D>(dpt, v_s, w_row, dos, lane);  // dP^T = V dO^T
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(delta_s + j * 8 + t2);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[j][e] *= dpt[j][e] - (e & 1 ? dl.y : dl.x);  // dS^T, f32
        }
        pv_tile<D, BQ>(dk, st, qs, lane);  // dK += bf16(dS^T) q_scaled
        store_ds(ds_s, st, w_row, lane);
        __syncthreads();  // every warp's dS^T is in the tile
        dq_partial<D>(dq_rows + (size_t)(q0 - q_start) * D, S - q0, ds_s,
                          k_s, warp, lane);
      });

  const int w0 = j0 + w_row;
  const float one[2] = {1.f, 1.f};
  store_rows<D>(a.dk + b * a.dkv.sb + (long long)w0 * a.dkv.ss + h * a.dkv.sh,
                a.dkv.ss, S - w0, dk, one, k_s + w_row * LD, lane);
  store_rows<D>(a.dv + b * a.dvv.sb + (long long)w0 * a.dvv.ss + h * a.dvv.sh,
                a.dvv.ss, S - w0, dv, one, v_s + w_row * LD, lane);
}

// dQ = sm_scale * (the sum of the key tiles' partials, in tile order), in
// the input type, through dQ's strides: each thread sums 16 / sizeof(T)
// consecutive elements of a row with 16-byte loads and writes them with one
// 16-byte store.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    dq_finish_kernel(const float* __restrict__ dq_part, T* __restrict__ dq,
                     long long total, int S, int H, int D, View w,
                     float scale, int causal, int bm) {
  constexpr int V = 16 / sizeof(T);
  const int n_tiles = (S + bm - 1) / bm;
  const long long per_bh = part_offset(n_tiles, S, causal, bm);
  const int vpr = D / V;  // vectors per row
  for (long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * THREADS) {
    const int d = static_cast<int>(idx % vpr) * V;
    const long long row = idx / vpr;
    const int i = static_cast<int>(row % S);
    const long long bh = row / S;
    const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
    const float* part = dq_part + bh * per_bh * D + d;
    const int last = causal ? i / bm : n_tiles - 1;
    float acc[V];
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.f;
    for (int t = 0; t <= last; ++t) {
      const float* p = part + (part_offset(t, S, causal, bm) + i - (causal ? t * bm : 0)) * D;
#pragma unroll
      for (int u = 0; u < V; u += 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p + u));
        acc[u] += x.x;
        acc[u + 1] += x.y;
        acc[u + 2] += x.z;
        acc[u + 3] += x.w;
      }
    }
    alignas(16) T out[V];
#pragma unroll
    for (int u = 0; u < V; ++u) out[u] = from_f32<T>(acc[u] * scale);
    *reinterpret_cast<uint4*>(dq + b * w.sb + i * w.ss + h * w.sh + d) =
        *reinterpret_cast<const uint4*>(out);
  }
}

template <typename T>
FusedArgs<T> make_args(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lse,
                       float* dq_part, void* dk, void* dv, int S, int H,
                       int D, const long long* st, float scale, int causal) {
  FusedArgs<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.o = static_cast<const T*>(o);
  a.dout = static_cast<const T*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dq_part = dq_part;
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  View* views[7] = {&a.qv, &a.kv, &a.vv, &a.ov, &a.dov, &a.dkv, &a.dvv};
  for (int i = 0; i < 7; ++i) *views[i] = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.S = S;
  a.H = H;
  a.D = D;
  a.scale = scale;
  a.causal = causal;
  return a;
}

int launch_f32(const FusedArgs<float>& a, int B, cudaStream_t stream) {
  const int D = a.D;
  const size_t smem = sizeof(float) * (2 * TILE * D + 2 * KC * (D + 1) +
                                       KC * (TILE + 1) + KC);
  const cudaError_t err = allow_smem(fused_bwd_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + TILE - 1) / TILE, B * a.H);
  fused_bwd_f32_kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const FusedArgs<bf16>& a, int B, cudaStream_t stream) {
  constexpr size_t smem = fused_smem_bytes<D>();
  const cudaError_t err = allow_smem(flash_bwd_fused_mma_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * a.H, (a.S + BM - 1) / BM);
  flash_bwd_fused_mma_kernel<D><<<grid, 32 * NW, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const FusedArgs<bf16>& a, int B, cudaStream_t stream) {
  switch (a.D) {
    case 32:
      return launch_mma<32>(a, B, stream);
    case 64:
      return launch_mma<64>(a, B, stream);
    case 128:
      return launch_mma<128>(a, B, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Keys a block of the dtype's kernel takes: TILE (64) for the f32 kernel,
// BM (128) for the bf16 one.
int key_tile(int dtype) { return dtype == 0 ? TILE : BM; }

template <typename T>
int launch_finish(const float* dq_part, void* dq, int B, int S, int H, int D,
                  const View& w, float scale, int causal, int bm,
                  cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * H * S * D / (16 / sizeof(T));
  const long long blocks = (total + THREADS - 1) / THREADS;
  dq_finish_kernel<T><<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535),
                        THREADS, 0, stream>>>(dq_part, static_cast<T*>(dq),
                                              total, S, H, D, w, scale,
                                              causal, bm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows of the partial-dQ workspace per (batch * head) of the dtype's
// kernel (dtype as flash_bwd_fused_launch takes it): the wrapper allocates
// B*H times this many rows of D f32.
extern "C" long long flash_bwd_fused_workspace_rows(int S, int causal,
                                                    int dtype) {
  const int kt = key_tile(dtype);
  return part_offset((S + kt - 1) / kt, S, causal, kt);
}

// dtype: 0 = float32, 1 = bfloat16 (head_dim 32, 64 or 128). q (not
// prescaled), k, v, o, dout: [B, S, H, D] inputs with a unit last-dim
// stride and 16-byte rows; lse: [B*H, S] f32; dq_part: an f32 workspace of
// B*H*flash_bwd_fused_workspace_rows(S, causal, dtype)*D elements (every
// element is written before it is read); dq, dk, dv are written through
// their strides. st: 24 element strides, (batch, seq, head) of q, k, v, o,
// dout, dk, dv, dq in that order. Two launches on `stream` (the pass over
// the pairs, then the sum of dQ's partials with its scale and cast).
// Returns cudaGetLastError().
extern "C" int flash_bwd_fused_launch(int dtype, const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* dq_part, void* dq, void* dk,
                                      void* dv, int B, int S, int H, int D,
                                      const long long* st, float scale,
                                      int causal, void* stream) {
  if (D < 4 || D > 32 * MAXE || D % 4 || B < 1 || S < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear a stale non-sticky error from earlier work
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(dq_part);
  const View dqv{st[21], st[22], st[23]};
  int err;
  if (dtype == 0) {
    err = launch_f32(make_args<float>(q, k, v, o, dout, lse, part, dk, dv, S,
                                      H, D, st, scale, causal),
                     B, s);
    if (err) return err;
    return launch_finish<float>(part, dq, B, S, H, D, dqv, scale, causal,
                                TILE, s);
  }
  if (dtype == 1) {
    const FusedArgs<bf16> a = make_args<bf16>(q, k, v, o, dout, lse, part, dk,
                                              dv, S, H, D, st, scale, causal);
    err = launch_mma(a, B, s);
    if (err) return err;
    return launch_finish<bf16>(part, dq, B, S, H, D, dqv, scale, causal, BM,
                               s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
