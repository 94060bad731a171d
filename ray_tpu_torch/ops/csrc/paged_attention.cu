// Paged attention over a block-table KV cache: decode (S == 1) and
// prefix-aware partial prefill (S > 1) for the serving engine.
//
// Replaces: ray_tpu/ops/paged_flash.py::_paged_kernel (pallas_call at :299,
// wrapper paged_flash_attention at :206).
//
// Bound on this card: bytes. Every step reads each live sequence's cached K
// and V once (2 * ctx * H * D elements per slot) and does about 4 flops per
// element read, far below the ~295 flops per byte at which an H100 stops
// waiting on memory. So the design reads each cached byte exactly once and
// only up to the context length, and keeps as many loads in flight as it
// can:
//   * one thread block per (batch slot, head, tile of query rows: 1 row at
//     decode, 8 for longer suffixes). The block loads its own block-table
//     row and context length (no scalar prefetch);
//   * the keys are cut into chunks of 32 (the cached prefix, token t through
//     table[t / bs], then the S new tokens) and the block's four warps take
//     disjoint chunks (warp w: chunks w, w + 4, ...). Each warp stages its
//     chunk into its own shared-memory slice with 16-byte loads, eight in
//     flight per lane and one table lookup per row, and folds it into its
//     own f32 m / l / acc for every query row of the tile (attn_common.cuh),
//     with no block barrier inside the loop; the four partial softmax states
//     are merged once at the end. Nothing past the context is read, so the
//     TPU kernel's copies of null blocks past the context are gone;
//   * int8 pools: K's per-token scale multiplies the score, V's the softmax
//     weight, as in the TPU kernel; no dequantized block is built;
//   * the new tokens are masked causally; rows with no valid key come out
//     as exact zeros.
// Still simple: CUDA-core f32 math, no wgmma, no TMA, no split of one
// context across blocks (flash-decoding), no double-buffered staging.
#include "attn_common.cuh"

using namespace rtt;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

// Shared-memory floats: the query tile, then one staging slice per warp.
__host__ __device__ constexpr int warp_slice(int D) {
  return KC * (D + 1) + KC * D;
}

template <typename T, typename KV, int RPW>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(
    const T* __restrict__ q, const KV* __restrict__ kc,
    const KV* __restrict__ vc, const __nv_bfloat16* __restrict__ kscale,
    const __nv_bfloat16* __restrict__ vscale, const int* __restrict__ tables,
    const int* __restrict__ lens, const T* __restrict__ nk,
    const T* __restrict__ nv, T* __restrict__ out, int S, int H, int D,
    int bs, int nb) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* q_s = smem;                                    // [RPW][D]
  float* k_s = q_s + RPW * D + warp * warp_slice(D);    // [KC][D + 1]
  float* v_s = k_s + KC * (D + 1);                      // [KC][D]
  const bool quantized = kscale != nullptr;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int i0 = blockIdx.y * RPW;  // first query row of this tile
  const int* table = tables + (size_t)b * nb;
  const int ctx = max(0, min(lens[b], nb * bs));

  for (int idx = tid; idx < RPW * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, i = i0 + r;
    q_s[idx] = i < S ? to_f32(q[(((size_t)b * S + i) * H + h) * D + d]) : 0.f;
  }
  __syncthreads();
  int row[RPW], lim[RPW];
  float m[RPW], l[RPW], acc[RPW][MAXE];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    row[r] = i0 + r < S ? r : -1;
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) acc[r][e] = 0.f;
  }

  // Chunks 0..n_cache-1 cover the cached prefix; the rest the new tokens
  // that this tile's rows can see (rows i0.. see new keys 0..i).
  const int n_cache = (ctx + KC - 1) / KC;
  const int n_new = min(S, i0 + RPW);
  const int n_chunks = n_cache + (n_new + KC - 1) / KC;
  for (int g = warp; g < n_chunks; g += WARPS) {
    float ksc = 1.f, vsc = 1.f;
    if (g < n_cache) {
      // One block-table lookup per chunk row: lane j resolves token
      // t0 + j, and the lanes loading that row's units shuffle it in.
      const int t0 = g * KC, t = t0 + lane;
      long long slot = -1;
      if (t < ctx) slot = (long long)table[t / bs] * bs + t % bs;
      const long long my_row = slot < 0 ? -1 : (slot * H + h) * D;
      auto cache_row = [&](int j) { return __shfl_sync(FULL, my_row, j); };
      stage_rows<32>(kc, cache_row, D, lane, k_s, D + 1);
      stage_rows<32>(vc, cache_row, D, lane, v_s, D);
      if (quantized && slot >= 0) {
        ksc = __bfloat162float(kscale[slot * H + h]);
        vsc = __bfloat162float(vscale[slot * H + h]);
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) lim[r] = ctx - t0;
    } else {
      const int c0 = (g - n_cache) * KC;
      auto new_row = [&](int j) -> long long {
        const int t = c0 + j;
        return t < n_new ? (((long long)b * S + t) * H + h) * D : -1;
      };
      stage_rows<32>(nk, new_row, D, lane, k_s, D + 1);
      stage_rows<32>(nv, new_row, D, lane, v_s, D);
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        lim[r] = row[r] >= 0 ? i0 + r + 1 - c0 : 0;
    }
    __syncwarp();
    fold_chunk<RPW, T>(q_s, k_s, v_s, ksc, vsc, D, lane, row, lim, m, l, acc);
    __syncwarp();  // the slice is consumed before the next chunk lands
  }

  // Merge the warps' partial softmax states: warp w's (m, l, acc) for each
  // row goes to its own slice; warp r % WARPS then combines row r.
  __syncthreads();
  float* part = q_s + RPW * D + warp * warp_slice(D);  // [RPW][D + 2]
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    float* pr = part + r * (D + 2);
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) pr[d] = acc[r][e];
    }
    if (lane == 0) {
      pr[D] = m[r];
      pr[D + 1] = l[r];
    }
  }
  __syncthreads();
  for (int r = warp; r < RPW; r += WARPS) {
    if (i0 + r >= S) continue;
    float mw[WARPS], m_all = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mw[w] = q_s[RPW * D + w * warp_slice(D) + r * (D + 2) + D];
      m_all = fmaxf(m_all, mw[w]);
    }
    float l_all = 0.f, o[MAXE] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* pr = q_s + RPW * D + w * warp_slice(D) + r * (D + 2);
      const float a = expf(mw[w] - m_all);
      l_all += pr[D + 1] * a;
#pragma unroll
      for (int e = 0; e < MAXE; ++e) {
        const int d = lane + 32 * e;
        if (d < D) o[e] += pr[d] * a;
      }
    }
    const size_t base = (((size_t)b * S + i0 + r) * H + h) * D;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) out[base + d] = from_f32<T>(l_all == 0.f ? 0.f : o[e] / l_all);
    }
  }
}

template <typename T, typename KV, int RPW>
cudaError_t launch_rpw(const void* q, const void* kc, const void* vc,
                       const void* ks, const void* vs, const int* tables,
                       const int* lens, const void* nk, const void* nv,
                       void* out, int B, int S, int H, int D, int bs, int nb,
                       cudaStream_t stream) {
  const dim3 grid(B * H, (S + RPW - 1) / RPW);
  const size_t smem = sizeof(float) * (RPW * D + WARPS * warp_slice(D));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, KV, RPW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  paged_attention_kernel<T, KV, RPW><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kc),
      static_cast<const KV*>(vc), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), tables, lens,
      static_cast<const T*>(nk), static_cast<const T*>(nv),
      static_cast<T*>(out), S, H, D, bs, nb);
  return cudaSuccess;
}

template <typename T, typename KV>
cudaError_t launch_typed(const void* q, const void* kc, const void* vc,
                         const void* ks, const void* vs, const int* tables,
                         const int* lens, const void* nk, const void* nv,
                         void* out, int B, int S, int H, int D, int bs, int nb,
                         cudaStream_t stream) {
  // Decode: one query row per block; longer suffixes: tiles of eight.
  if (S == 1)
    return launch_rpw<T, KV, 1>(q, kc, vc, ks, vs, tables, lens, nk, nv, out,
                                B, S, H, D, bs, nb, stream);
  return launch_rpw<T, KV, 8>(q, kc, vc, ks, vs, tables, lens, nk, nv, out, B,
                              S, H, D, bs, nb, stream);
}

template <typename T>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* kc,
                      const void* vc, const void* ks, const void* vs,
                      const int* tables, const int* lens, const void* nk,
                      const void* nv, void* out, int B, int S, int H, int D,
                      int bs, int nb, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_typed<T, float>(q, kc, vc, ks, vs, tables, lens, nk, nv,
                                    out, B, S, H, D, bs, nb, stream);
    case 1:
      return launch_typed<T, __nv_bfloat16>(q, kc, vc, ks, vs, tables, lens,
                                            nk, nv, out, B, S, H, D, bs, nb,
                                            stream);
    case 2:
      return launch_typed<T, int8_t>(q, kc, vc, ks, vs, tables, lens, nk, nv,
                                     out, B, S, H, D, bs, nb, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8. q / new_k / new_v / out
// share q_dtype; the pools are kv_dtype; scales are bf16 (int8 pools only,
// else null). Returns cudaGetLastError() after the launch.
extern "C" int paged_attention_launch(
    int q_dtype, int kv_dtype, const void* q, const void* k_cache,
    const void* v_cache, const void* k_scale, const void* v_scale,
    const void* block_tables, const void* context_lens, const void* new_k,
    const void* new_v, void* out, int B, int S, int H, int D, int bs, int nb,
    void* stream) {
  if (D < 1 || D > 32 * MAXE || B < 1 || S < 1 || H < 1 || bs < 1 || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear a stale non-sticky error from earlier work
  const int* tables = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(context_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0)
    err = launch_kv<float>(kv_dtype, q, k_cache, v_cache, k_scale, v_scale,
                           tables, lens, new_k, new_v, out, B, S, H, D, bs,
                           nb, st);
  else if (q_dtype == 1)
    err = launch_kv<__nv_bfloat16>(kv_dtype, q, k_cache, v_cache, k_scale,
                                   v_scale, tables, lens, new_k, new_v, out,
                                   B, S, H, D, bs, nb, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
