// Shared device code of the attention kernels: storage-type loads, chunk
// staging, and the warp-level online-softmax step over one staged chunk.
//
// The unit of work is one warp folding one chunk of KC = 32 keys, staged in
// shared memory as f32, into the running softmax state of RPW query rows.
// Lane j scores key j of the chunk against every row (each K element is read
// once for all rows), the warp reduces each row's max and sum with shuffles,
// and every lane updates the output dimensions it owns (d = lane, lane + 32,
// ...) with the chunk's softmax weights, broadcast one key at a time (each V
// element read once for all rows). m, l and acc stay in f32 registers for the
// whole key loop. How the warps of a block share the work differs: the flash
// kernel gives each warp its own query rows, the paged kernel its own keys.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

// Finite, as in the plain version: masked logits never produce inf - inf.
constexpr float NEG_INF = -1e30f;
constexpr int KC = 32;       // keys per staged chunk: one per lane
constexpr int MAXE = 4;      // head_dim <= 128: dims owned per lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// Staging conversions: the plain one, and q's prescale by sm_scale rounded to
// its storage type, (q.f32 * scale).to(T), the reference's order.
struct ToF32 {
  template <typename KV>
  __device__ __forceinline__ float operator()(KV x) const { return to_f32(x); }
};
template <typename T>
struct Prescale {
  float scale;
  __device__ __forceinline__ float operator()(T x) const {
    return to_f32(from_f32<T>(to_f32(x) * scale));
  }
};

// Round an f32 value to storage type T and back (the reference rounds P and
// dS to the input type before the backward's products; exact for f32).
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Stage the KC rows of one chunk (D elements each) into shared memory as f32,
// row j at dst + j * dst_stride. The rows are read in 16-byte units; the G
// threads of the group (a warp, or the whole block) take units t, t + G, ...,
// and each thread has eight loads in flight before it converts and stores
// them, so a chunk costs a few memory latencies, not one per element.
// row_off(j) is the element offset of row j, or -1 for a row past the end
// (staged as zeros); every thread calls it for every slot, so it may shuffle.
// cvt turns each staged element into f32 (ToF32, or Prescale for queries).
// The wrappers check that D * sizeof(KV) is a multiple of 16 and that every
// row starts 16-byte aligned.
template <int G, typename KV, typename F, typename C = ToF32>
__device__ __forceinline__ void stage_rows(const KV* __restrict__ src,
                                           F row_off, int D, int t,
                                           float* __restrict__ dst,
                                           int dst_stride, C cvt = C()) {
  constexpr int EPU = 16 / sizeof(KV);  // elements per 16-byte unit
  const int upr = D / EPU;              // units per row
  const int total = KC * upr;
  for (int u0 = 0; u0 < total; u0 += 8 * G) {
    uint4 buf[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int u = u0 + i * G + t;
      const long long ro = row_off(min(u / upr, KC - 1));
      buf[i] = (u < total && ro >= 0)
                   ? __ldg(reinterpret_cast<const uint4*>(src + ro) + u % upr)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int u = u0 + i * G + t;
      if (u < total) {
        const KV* e = reinterpret_cast<const KV*>(&buf[i]);
        float* o = dst + (u / upr) * dst_stride + (u % upr) * EPU;
#pragma unroll
        for (int x = 0; x < EPU; ++x) o[x] = cvt(e[x]);
      }
    }
  }
}

// Fold one staged chunk into the running softmax state of this warp's rows.
//   q_s   [rows][D]   the block's query rows (f32, prescaled; D % 4 == 0)
//   k_s   [KC][D + 1] keys (padded row: lane j reads row j without bank
//                     conflicts)
//   v_s   [KC][D]     values
//   ksc/vsc           the dequant scales of this lane's key (int8 pools;
//                     1 otherwise, which multiplies exactly)
//   row[r]            local query row of slot r, or -1 (warp-uniform)
//   lim[r]            keys 0..lim[r]-1 of the chunk are visible to row r
//   PT                the type P is rounded to before P·V, after V's int8
//                     scale, as the reference rounds it (`p.astype(v.dtype)`
//                     in _fwd_kernel, `p.astype(out_dtype)` in
//                     _online_update); l sums the unrounded P. float is exact.
// Keys at or past lim get probability exactly 0, so a row whose every key
// so far was masked keeps l == 0 (and comes out as zeros), never the
// uniform average that exp(NEG_INF - NEG_INF) = 1 would give.
template <int RPW, typename PT>
__device__ __forceinline__ void fold_chunk(
    const float* __restrict__ q_s, const float* __restrict__ k_s,
    const float* __restrict__ v_s, float ksc, float vsc, int D, int lane,
    const int (&row)[RPW], const int (&lim)[RPW], float (&m)[RPW],
    float (&l)[RPW], float (&acc)[RPW][MAXE]) {
  // Scores of this lane's key against every row: one pass over K.
  float s[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) s[r] = 0.f;
  const float* kr = k_s + lane * (D + 1);
  for (int d = 0; d < D; d += 4) {
    const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float4 qv =
          *reinterpret_cast<const float4*>(q_s + max(row[r], 0) * D + d);
      s[r] = fmaf(qv.w, k3, fmaf(qv.z, k2, fmaf(qv.y, k1, fmaf(qv.x, k0, s[r]))));
    }
  }
  // Online-softmax update per row; p = 0 past each row's visible keys.
  float p[RPW];
  int nk = 0;  // keys visible to any row of the warp (warp-uniform)
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    p[r] = 0.f;
    if (row[r] < 0 || lim[r] <= 0) continue;  // no visible key: a no-op
    nk = max(nk, min(lim[r], KC));
    const bool valid = lane < lim[r];
    const float sc = valid ? s[r] * ksc : NEG_INF;  // int8: K's scale
    const float m_new = fmaxf(m[r], warp_max(sc));
    const float pr = valid ? expf(sc - m_new) : 0.f;
    const float alpha = expf(m[r] - m_new);
    l[r] = l[r] * alpha + warp_sum(pr);
    m[r] = m_new;
    p[r] = round_to<PT>(pr * vsc);  // int8: V's scale on P, then rounded
#pragma unroll
    for (int e = 0; e < MAXE; ++e) acc[r][e] *= alpha;
  }
  // P·V: one pass over V, each value row applied to every row of the warp.
#pragma unroll 4
  for (int j = 0; j < nk; ++j) {
    float vj[MAXE];
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      const int d = lane + 32 * e;
      vj[e] = d < D ? v_s[j * D + d] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float pj = __shfl_sync(FULL, p[r], j);
#pragma unroll
      for (int e = 0; e < MAXE; ++e) acc[r][e] = fmaf(pj, vj[e], acc[r][e]);
    }
  }
}

}  // namespace rtt
