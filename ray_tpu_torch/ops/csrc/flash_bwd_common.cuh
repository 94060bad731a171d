// Shared device code of the backward kernels (flash_bwd.cu: K4, K5, K7;
// flash_bwd_fused.cu: K3): the block shape, strided row access, tile
// staging and the two-operand chunk scores.
#pragma once

#include "attn_common.cuh"

namespace rtt {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = 8;
constexpr int TILE = WARPS * RPW;  // 64 rows per block

// Element strides of a [B, S, H, D] view with a unit last-dim stride.
struct View {
  long long sb, ss, sh;
};

template <typename T>
struct Args {
  const T *q, *k, *v, *dout;
  const float *lse, *delta;  // [B*H, S] f32
  T *dq, *dk, *dv;
  View qv, kv, vv, dov, dqv, dkv, dvv;
  int S, H, D;
  float scale;
  int causal;
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const T* base, const View& w,
                                            int b, int i, int h) {
  return base + b * w.sb + i * w.ss + h * w.sh;
}

// Scores of this lane's chunk row against the warp's 8 tile rows, for two
// operand pairs at once: s[r] = a_row . x_tile[r], t[r] = b_row . y_tile[r].
// a_row / b_row are padded chunk rows (stride D + 1), the tiles [TILE][D].
__device__ __forceinline__ void two_scores(
    const float* __restrict__ a_row, const float* __restrict__ b_row,
    const float* __restrict__ x_tile, const float* __restrict__ y_tile,
    const int (&row)[RPW], int D, float (&s)[RPW], float (&t)[RPW]) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) s[r] = t[r] = 0.f;
  for (int d = 0; d < D; d += 4) {
    const float a0 = a_row[d], a1 = a_row[d + 1], a2 = a_row[d + 2], a3 = a_row[d + 3];
    const float b0 = b_row[d], b1 = b_row[d + 1], b2 = b_row[d + 2], b3 = b_row[d + 3];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int lr = max(row[r], 0);
      const float4 x = *reinterpret_cast<const float4*>(x_tile + lr * D + d);
      const float4 y = *reinterpret_cast<const float4*>(y_tile + lr * D + d);
      s[r] = fmaf(x.w, a3, fmaf(x.z, a2, fmaf(x.y, a1, fmaf(x.x, a0, s[r]))));
      t[r] = fmaf(y.w, b3, fmaf(y.z, b2, fmaf(y.y, b1, fmaf(y.x, b0, t[r]))));
    }
  }
}

// Stage TILE rows starting at row r0 of a strided operand into a [TILE][D]
// f32 tile (zeros past S), element by element, once per block.
template <typename T, typename C>
__device__ __forceinline__ void stage_tile(const T* __restrict__ base,
                                           const View& w, int b, int h,
                                           int r0, int S, int D,
                                           float* __restrict__ dst, C cvt) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, i = r0 + r;
    dst[idx] = i < S ? cvt(row_ptr(base, w, b, i, h)[d]) : 0.f;
  }
}

}  // namespace rtt
