// The bf16 attention kernels' tile machinery, in one place: the forward
// flash_fwd_mma_kernel (flash_fwd.cu: K2, K6), the blockwise backward
// (flash_bwd.cu: K4, K5, K7), the one-block backward (flash_bwd_fused.cu:
// K3) and the profiling kernels (attn_dissect.cu: K8, attn_slim.cu: K9,
// attn_subtile.cu: K10) are built from it. Warps of
// 16 query rows keep q in registers as m16n8k16 A fragments; K and V tiles
// pass through a two-stage cp.async ring of rows padded by 16 bytes;
// S = Q K^T and O += P V run on mma.sync with f32 accumulators, and P is
// packed to bf16 in registers as the A fragment of P V. The backward runs
// its five products as these two, on other operands.
//
// Operands are read through a row stride (the [B, S, H, D] layouts of the
// forward, the packed qkv, or the profiling scripts' contiguous [BH, S, D])
// with a unit stride along D; rows at or past the operand's length read as
// zeros and are never loaded or stored.
#pragma once

#include "attn_common.cuh"
#include "mma_common.cuh"

namespace rtt {

// Row stride, in elements, of a staged [rows][D] tile: 16 bytes of padding
// put the eight rows of each ldmatrix in distinct banks.
template <int D>
__host__ __device__ constexpr int tile_ld() {
  return D + 8;
}

// One head's K and V as a sweep reads them: pointers to row 0, row strides
// in elements, and the number of rows (keys at or past it read as zeros).
struct KVRows {
  const bf16* k;
  const bf16* v;
  long long k_ld, v_ld;
  int n;
};

// Eight bf16 values multiplied by `scale` and rounded to nearest-even bf16:
// the reference's prescale of q, (q.f32 * scale).astype(bf16).
__device__ __forceinline__ void scale_bf16x8(uint4& raw, float scale) {
  bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int x = 0; x < 8; ++x)
    e[x] = __float2bfloat16(__bfloat162float(e[x]) * scale);
}

// Stage the block's BM rows i0 .. i0 + BM - 1 of `qb` (row stride `ld`;
// rows at or past n_rows are zeros) in q_s, each multiplied by `scale` and
// rounded to bf16 (scale 1 leaves them as they are). The caller syncs.
template <int BM, int D, int THREADS>
__device__ __forceinline__ void stage_tile_rows(bf16* q_s, const bf16* qb,
                                                long long ld, int i0,
                                                int n_rows, float scale) {
  constexpr int LD = tile_ld<D>(), CPR = D / 8;
#pragma unroll
  for (int c = threadIdx.x; c < BM * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8, i = i0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (i < n_rows)
      raw = __ldg(reinterpret_cast<const uint4*>(qb + i * ld + col));
    scale_bf16x8(raw, scale);
    *reinterpret_cast<uint4*>(q_s + r * LD + col) = raw;
  }
}

// The m16n8k16 A fragments of every k-step over D of the 16 rows from
// `row0` of a staged tile (row stride tile_ld<D>()), by ldmatrix.
template <int D>
__device__ __forceinline__ void warp_a_frags(uint32_t (&af)[D / 16][4],
                                             const bf16* tile, int row0,
                                             int lane) {
  constexpr int LD = tile_ld<D>();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(af[kk], tile + (row0 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
}

// Stage the block's BM query rows in q_s (stage_tile_rows, prescaled by
// `scale`) and load this warp's 16 rows as the A fragments of every k-step
// of Q K^T.
template <int BM, int D, int THREADS>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4],
                                             bf16* q_s, const bf16* qb,
                                             long long ld, int i0, int n_rows,
                                             float scale, int warp, int lane) {
  stage_tile_rows<BM, D, THREADS>(q_s, qb, ld, i0, n_rows, scale);
  __syncthreads();
  warp_a_frags<D>(qf, q_s, warp * 16, lane);
}

// Start the asynchronous copy, 16 bytes a copy, of key tile `tile` (and its
// V tile, WITH_V) into ring stage `stage`; the caller commits it.
template <int BN, int D, int THREADS, bool WITH_V>
__device__ __forceinline__ void start_tile_copy(const KVRows& kv, int tile,
                                                int stage, bf16* k_s,
                                                bf16* v_s) {
  constexpr int LD = tile_ld<D>(), CPR = D / 8;
  bf16* ks = k_s + stage * BN * LD;
  bf16* vs = v_s + stage * BN * LD;
#pragma unroll
  for (int c = threadIdx.x; c < BN * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8, j = tile * BN + r;
    const bool valid = j < kv.n;
    const long long jr = valid ? j : 0;
    cp_async16(ks + r * LD + col, kv.k + jr * kv.k_ld + col, valid);
    if (WITH_V) cp_async16(vs + r * LD + col, kv.v + jr * kv.v_ld + col, valid);
  }
}

// A sweep's copy beside each tile: none.
struct NoExtraCopy {
  __device__ __forceinline__ void operator()(int, int) const {}
};

// One pass over key tiles 0 .. n_tiles - 1 of BN keys through the
// two-stage ring: tile j + 1 is in flight while `body(j, k_tile, v_tile)`
// computes on tile j. V is staged only WITH_V (a pass that takes a row's
// max or sum needs K alone). `extra(j, stage)` starts the caller's own
// asynchronous copies of tile j into ring stage `stage` (the backward's
// per-query lse and delta), in the same commit group as the tile. With
// `first_in_flight`, tile 0 is already in flight in stage 0 (started and
// committed before q was staged, so the two overlap). Every thread of the
// block calls it.
template <int BN, int D, int THREADS, bool WITH_V, typename Extra,
          typename Body>
__device__ __forceinline__ void sweep_tiles(const KVRows& kv, int n_tiles,
                                            bf16* k_s, bf16* v_s,
                                            bool first_in_flight,
                                            Extra&& extra, Body&& body) {
  constexpr int STAGE = BN * tile_ld<D>();
  if (!first_in_flight) {
    start_tile_copy<BN, D, THREADS, WITH_V>(kv, 0, 0, k_s, v_s);
    extra(0, 0);
    cp_async_commit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      start_tile_copy<BN, D, THREADS, WITH_V>(kv, tile + 1, (tile + 1) & 1,
                                              k_s, v_s);
      extra(tile + 1, (tile + 1) & 1);
    }
    cp_async_commit();   // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    body(tile, k_s + (tile & 1) * STAGE, v_s + (tile & 1) * STAGE);
    __syncthreads();  // this stage is consumed before it is refilled
  }
}

template <int BN, int D, int THREADS, bool WITH_V, typename Body>
__device__ __forceinline__ void sweep_tiles(const KVRows& kv, int n_tiles,
                                            bf16* k_s, bf16* v_s,
                                            bool first_in_flight,
                                            Body&& body) {
  sweep_tiles<BN, D, THREADS, WITH_V>(kv, n_tiles, k_s, v_s, first_in_flight,
                                      NoExtraCopy{}, body);
}

// S = Q K^T for this warp's 16 rows against a staged tile of BN keys.
template <int D, int BN>
__device__ __forceinline__ void qk_tile(float (&s)[BN / 8][4],
                                        const uint32_t (&qf)[D / 16][4],
                                        const bf16* ks, int lane) {
  constexpr int LD = tile_ld<D>();
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int jn = 0; jn < BN / 16; ++jn) {
      uint32_t kf[4];
      ldmatrix_x4(kf, ks + (jn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * jn], qf[kk], kf[0], kf[1]);
      mma_bf16(s[2 * jn + 1], qf[kk], kf[2], kf[3]);
    }
  }
}

// O += bf16(P) V for this warp's 16 rows: P is rounded to nearest-even bf16
// in registers and used as the A fragment; V's B fragments by
// ldmatrix.trans.
template <int D, int BN>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4],
                                        const float (&p)[BN / 8][4],
                                        const bf16* vs, int lane) {
  constexpr int LD = tile_ld<D>();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vs + (kk * 16 + (lane & 15)) * LD + jd * 16 +
                                (lane >> 4) * 8);
      mma_bf16(o[2 * jd], pa, vf[0], vf[1]);
      mma_bf16(o[2 * jd + 1], pa, vf[2], vf[3]);
    }
  }
}

// Scores set to `value` where the key lies at or past n_keys or, causal,
// past its row; row0 is this lane's first row (its second is row0 + 8), k0
// the tile's first key.
template <int BN>
__device__ __forceinline__ void mask_tile(float (&s)[BN / 8][4], int k0,
                                          int row0, int lane, int n_keys,
                                          int causal, float value) {
  const int t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + j * 8 + 2 * t4 + (e & 1);
      const int row = row0 + (e >> 1) * 8;
      if (key >= n_keys || (causal && key > row)) s[j][e] = value;
    }
}

// Transposed scores S^T (rows: this lane's keys key0 and key0 + 8; columns:
// the tile's queries from q0) set to -inf where the query lies at or past
// n_q or, causal, before its key.
template <int BQ>
__device__ __forceinline__ void mask_queries(float (&s)[BQ / 8][4], int q0,
                                             int key0, int lane, int n_q,
                                             int causal) {
  const int t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int query = q0 + j * 8 + 2 * t4 + (e & 1);
      const int key = key0 + (e >> 1) * 8;
      if (query >= n_q || (causal && query < key)) s[j][e] = -INFINITY;
    }
}

// Multiply a staged tile of BR rows by `scale` in place, rounded to bf16.
template <int BR, int D, int THREADS>
__device__ __forceinline__ void scale_tile(bf16* t, float scale) {
  constexpr int LD = tile_ld<D>(), CPR = D / 8;
#pragma unroll
  for (int c = threadIdx.x; c < BR * CPR; c += THREADS) {
    uint4* p = reinterpret_cast<uint4*>(t + (c / CPR) * LD + (c % CPR) * 8);
    uint4 raw = *p;
    scale_bf16x8(raw, scale);
    *p = raw;
  }
}

// The running max of this lane's two rows over one tile, reduced across
// the quad that holds each row.
template <int BN>
__device__ __forceinline__ void row_max(float (&m)[2],
                                        const float (&s)[BN / 8][4]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
    m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
}

// p = exp(s - m) in place as exp2(s log2(e) - m log2(e)) (one FFMA and one
// MUFU.EX2, as the forward kernel), and this lane's part of each row's sum.
template <int BN>
__device__ __forceinline__ void exp_rows(float (&s)[BN / 8][4],
                                         const float (&m)[2],
                                         float (&rs)[2]) {
  const float ms[2] = {m[0] * LOG2E, m[1] * LOG2E};
  rs[0] = rs[1] = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[j][e], LOG2E, -ms[e >> 1]));
      s[j][e] = p;
      rs[e >> 1] += p;
    }
}

// One tile's step of the online softmax (a running max per row): m rises to
// the tile's max, s becomes p = exp(s - m) in place, and l and O are
// rescaled to the new max before l adds the tile's sum of p.
template <int D, int BN>
__device__ __forceinline__ void online_softmax_tile(float (&s)[BN / 8][4],
                                                    float (&m)[2],
                                                    float (&l)[2],
                                                    float (&o)[D / 8][4]) {
  float mx[2] = {m[0], m[1]}, alpha[2], rs[2];
  row_max<BN>(mx, s);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    alpha[r] = exp2f((m[r] - mx[r]) * LOG2E);
    m[r] = mx[r];
  }
  exp_rows<BN>(s, m, rs);
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    o[d][0] *= alpha[0];
    o[d][1] *= alpha[0];
    o[d][2] *= alpha[1];
    o[d][3] *= alpha[1];
  }
}

// Each row's sum l, reduced across the quad that holds it; 0 (a row that
// saw no key) becomes 1, so O / l and log(l) stay finite.
__device__ __forceinline__ void finish_row_sums(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if (l[r] == 0.f) l[r] = 1.f;
  }
}

// Epilogue: O / div of this warp's 16 rows, rounded to bf16, staged in the
// warp's own rows of q_s (`os`, read into registers long before) and
// written with 16-byte stores to `ob` (the warp's first row, row stride
// `ld`); only the first n_rows rows are written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* ob, long long ld,
                                           int n_rows,
                                           const float (&o)[D / 8][4],
                                           const float (&div)[2], bf16* os,
                                           int lane) {
  constexpr int LD = tile_ld<D>(), CPR = D / 8;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    const int col = d * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(os + g * LD + col) =
        __floats2bfloat162_rn(o[d][0] / div[0], o[d][1] / div[0]);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * LD + col) =
        __floats2bfloat162_rn(o[d][2] / div[1], o[d][3] / div[1]);
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, col = (c % CPR) * 8;
    if (r < n_rows)
      *reinterpret_cast<uint4*>(ob + r * ld + col) =
          *reinterpret_cast<const uint4*>(os + r * LD + col);
  }
}

// lse = m + log(l) of this lane's two rows (row0, row0 + 8) into one head's
// [S] row of lse, by the first lane of each quad; rows at or past n_rows
// are not written.
__device__ __forceinline__ void store_lse(float* lse_head, int row0,
                                          int n_rows, const float (&m)[2],
                                          const float (&l)[2], int lane) {
  if (lane & 3) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    if (i < n_rows) lse_head[i] = m[r] + logf(l[r]);
  }
}

// Dynamic shared memory of a block: q [BM] and two stages each of K and V
// [BN], rows padded to tile_ld<D>().
template <int BM, int BN, int D>
constexpr size_t tiles_smem_bytes() {
  return sizeof(bf16) * (BM + 4 * BN) * tile_ld<D>();
}

// Opt a kernel into more than 48 KB of dynamic shared memory where needed.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rtt
