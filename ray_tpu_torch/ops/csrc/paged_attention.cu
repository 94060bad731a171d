// Paged attention over a block-table KV cache: decode (S == 1), verify
// (a few rows) and prefix-aware partial prefill (a longer suffix) for the
// serving engine.
//
// Replaces: ray_tpu/ops/paged_flash.py::_paged_kernel (:108, pallas_call at
// :299, wrapper paged_flash_attention at :206).
//
// The function: q [B, S, H, D], prescaled by sm_scale and rounded to its
// type as the reference does (each kernel does it as it stages q), attends
// every cached token of its slot, read through the slot's row of the block
// table up to its context length, then the S new tokens (new_k / new_v, not
// yet in the pool) causally. With int8 pools K's per-token scale multiplies the
// score columns and V's multiplies P. A row with no visible key comes out
// as exact zeros.
//
// Bound on this card: bytes. Every step reads each live sequence's cached K
// and V once (2 * ctx * H * D elements per slot) and does about 4 flops per
// element read at decode, far below the ~295 flops per byte at which an
// H100 stops waiting on memory. The TPU kernel walks a slot's blocks in
// order on one core; here the work is cut so that enough blocks, each with
// enough loads in flight, cover the card. Three kernels, chosen by the
// shape:
//
//   * decode and verify (S <= SPLIT_MAX_ROWS, every dtype): split across the
//     context, as flash-decoding does (paged_split_kernel). The context is
//     cut into partitions of `part_pages` pages; the grid is (slot x head,
//     partition), the partition count taken from the table's width nb, never
//     from the context lengths, so the host reads nothing back. A block
//     past its slot's context exits at once. The block's warps take
//     disjoint 32-key chunks of its partition, each streaming its chunks
//     into its own two-stage shared-memory ring with 16-byte cp.async (the
//     partition's table entries staged once), the next chunk in flight
//     while it folds the one before into its f32 softmax state (the scores
//     lane per key, P V lane per output dimension). The warps' states are
//     merged in the block; partition 0 also folds the new tokens. A slot
//     whose context fits in one partition is written directly; otherwise
//     each block writes its rows' (m, l, acc) to a workspace and
//     paged_merge_kernel folds the partitions in partition order and
//     normalises: no atomics, so the result is the same bit for bit on
//     every run;
//   * a longer suffix with bf16 q and bf16 or int8 pools
//     (paged_suffix_mma_kernel<KV, D>, D in {32, 64, 128}): the bf16
//     forward's tile machinery (attn_tiles.cuh) on tiles of 64 query rows,
//     one warp per 16 rows, S = Q K^T and O += P V on mma.sync. K and V
//     tiles of 64 keys are gathered page by page through the table (staged
//     once in shared memory) into a two-stage cp.async ring; int8 rows land
//     raw and are widened to bf16 in shared memory (exact: |x| <= 127), K's
//     scale then multiplies the score fragment and V's the P fragment. The
//     new tokens come last, as causally masked tiles;
//   * a longer suffix otherwise (f32 q or f32 pools; paged_attention_kernel):
//     CUDA-core f32 math, as the f32 flash kernels keep. One block per (slot,
//     head, tile of 8 rows); its four warps take disjoint 32-key chunks,
//     staged into f32 shared memory and folded by attn_common.cuh's
//     fold_chunk, and merge at the end.
// Every path rounds P to the output type before P V, after V's int8 scale,
// as the reference does; l sums the unrounded P. Each kernel's shared-
// memory limit is raised once (a function-local static per instantiation,
// for the current device), not on every launch.
#include <type_traits>

#include "attn_tiles.cuh"

using namespace rtt;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

// The largest dynamic shared memory a block of this card may take; each
// kernel is opted in to it once.
constexpr int SMEM_OPT_IN = 227 * 1024;

template <typename Kernel>
cudaError_t opt_in(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_OPT_IN);
}

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// --------------------------------------------- f32 suffix: CUDA-core kernel

constexpr int RPW = 8;  // query rows a block

// Shared-memory floats: the query tile, then one staging slice per warp.
__host__ __device__ constexpr int warp_slice(int D) {
  return KC * (D + 1) + KC * D;
}

template <typename T, typename KV>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(
    const T* __restrict__ q, const KV* __restrict__ kc,
    const KV* __restrict__ vc, const bf16* __restrict__ kscale,
    const bf16* __restrict__ vscale, const int* __restrict__ tables,
    const int* __restrict__ lens, const T* __restrict__ nk,
    const T* __restrict__ nv, T* __restrict__ out, int S, int H, int D,
    int bs, int nb, float scale) {
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

  const Prescale<T> prescale{scale};
  for (int idx = tid; idx < RPW * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, i = i0 + r;
    q_s[idx] = i < S ? prescale(q[(((size_t)b * S + i) * H + h) * D + d]) : 0.f;
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

template <typename T, typename KV>
cudaError_t launch_f32_suffix(const void* q, const void* kc, const void* vc,
                              const void* ks, const void* vs,
                              const int* tables, const int* lens,
                              const void* nk, const void* nv, void* out, int B,
                              int S, int H, int D, int bs, int nb,
                              float scale, cudaStream_t stream) {
  static const cudaError_t attr = opt_in(paged_attention_kernel<T, KV>);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (S + RPW - 1) / RPW);
  const size_t smem = sizeof(float) * (RPW * D + WARPS * warp_slice(D));
  paged_attention_kernel<T, KV><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kc),
      static_cast<const KV*>(vc), static_cast<const bf16*>(ks),
      static_cast<const bf16*>(vs), tables, lens, static_cast<const T*>(nk),
      static_cast<const T*>(nv), static_cast<T*>(out), S, H, D, bs, nb, scale);
  return cudaSuccess;
}

// ------------------------------------- decode and verify: split kernel

constexpr int SPLIT_MAX_ROWS = 8;  // the most query rows the split kernel takes
// Shared memory a split block may take: two blocks or more share an SM.
constexpr int SPLIT_SMEM = 80 * 1024;

// Bytes between two staged rows: the wider of the pool's and the new
// tokens' rows plus 16, so that lane j reading row j in 16-byte units hits
// distinct banks.
template <typename T, typename KV>
__host__ __device__ constexpr int split_ld(int D) {
  return D * (int)(sizeof(KV) > sizeof(T) ? sizeof(KV) : sizeof(T)) + 16;
}
// One warp's ring: two stages of a K and a V chunk of KC rows.
template <typename T, typename KV>
__host__ __device__ constexpr int split_ring(int D) {
  return 2 * 2 * KC * split_ld<T, KV>(D);
}
// The query rows (f32) and the partition's table entries, before the rings.
template <int R>
__host__ __device__ constexpr int split_head(int D, int part_pages) {
  return align16(R * D * 4) + align16(part_pages * 4);
}

// Fold one staged chunk of raw rows (KV elements, `ld` bytes apart) into
// the running softmax state of this warp's rows: fold_chunk's arithmetic
// (attn_common.cuh) on rows read in their storage type. Lane j scores key
// j against every row (the K row in 16-byte units, q broadcast from f32
// shared memory), the rows' max and sum reduce across the warp, and each
// lane accumulates its output dimensions (d = lane, lane + 32, ...) over
// the chunk's keys, P broadcast one key at a time. ksc / vsc: this lane's
// key's int8 scales (1 otherwise). PT: the type P is rounded to.
template <int R, typename KV, typename PT>
__device__ __forceinline__ void fold_raw(
    const float* __restrict__ q_s, const unsigned char* __restrict__ k_raw,
    const unsigned char* __restrict__ v_raw, int ld, float ksc, float vsc,
    int D, int lane, const int (&row)[R], const int (&lim)[R], float (&m)[R],
    float (&l)[R], float (&acc)[R][MAXE]) {
  constexpr int EPU = 16 / sizeof(KV);
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
  const unsigned char* kr = k_raw + lane * ld;
  for (int d0 = 0; d0 < D; d0 += EPU) {
    const uint4 raw = *reinterpret_cast<const uint4*>(kr + d0 * sizeof(KV));
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int x = 0; x < EPU; x += 4) {
      const float k0 = to_f32(e[x]), k1 = to_f32(e[x + 1]);
      const float k2 = to_f32(e[x + 2]), k3 = to_f32(e[x + 3]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(
            q_s + max(row[r], 0) * D + d0 + x);
        s[r] = fmaf(qv.w, k3,
                    fmaf(qv.z, k2, fmaf(qv.y, k1, fmaf(qv.x, k0, s[r]))));
      }
    }
  }
  float p[R];
  int nk = 0;  // keys visible to any row of the warp (warp-uniform)
#pragma unroll
  for (int r = 0; r < R; ++r) {
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
#pragma unroll 4
  for (int j = 0; j < nk; ++j) {
    const KV* vr = reinterpret_cast<const KV*>(v_raw + j * ld);
    float vj[MAXE];
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      const int d = lane + 32 * e;
      vj[e] = d < D ? to_f32(vr[d]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float pj = __shfl_sync(FULL, p[r], j);
#pragma unroll
      for (int e = 0; e < MAXE; ++e) acc[r][e] = fmaf(pj, vj[e], acc[r][e]);
    }
  }
}

// Start the 16-byte asynchronous copies of a chunk's KC K and V rows of E
// elements into k_dst and v_dst, `ld` bytes apart. Lane j gives row j's
// element offset in `off` (-1: zero-filled, nothing read); the lanes share
// the units, each taking its row's offset from lane j by a shuffle (the
// loop runs D / EPU times on every lane).
template <typename E>
__device__ __forceinline__ void copy_rows(unsigned char* k_dst,
                                          unsigned char* v_dst, int ld,
                                          const E* __restrict__ k_src,
                                          const E* __restrict__ v_src,
                                          long long off, int D, int lane) {
  constexpr int EPU = 16 / sizeof(E);
  const int upr = D / EPU;
  for (int i = 0; i < upr; ++i) {
    const int u = lane + 32 * i, j = u / upr, c = u % upr;
    const long long o = __shfl_sync(FULL, off, j);
    const long long src = (o < 0 ? 0 : o) + c * EPU;
    cp_async16(k_dst + j * ld + c * 16, k_src + src, o >= 0);
    cp_async16(v_dst + j * ld + c * 16, v_src + src, o >= 0);
  }
}

// Grid (B * H, n_part), blockDim.x = 32 * W (W <= WARPS). Partition `part`
// holds context tokens [part * part_pages * bs, ...); partition 0 also the
// S new tokens. ws: [B, H, n_part, S, D + 2] f32 (acc, m, l per row), read
// by paged_merge_kernel; unused when n_part == 1. DC: the head_dim when it
// is known at compile time (the loops over D unroll), 0 to read it from
// d_arg.
template <typename T, typename KV, int R, int DC>
__global__ void __launch_bounds__(THREADS) paged_split_kernel(
    const T* __restrict__ q, const KV* __restrict__ kc,
    const KV* __restrict__ vc, const bf16* __restrict__ kscale,
    const bf16* __restrict__ vscale, const int* __restrict__ tables,
    const int* __restrict__ lens, const T* __restrict__ nk,
    const T* __restrict__ nv, T* __restrict__ out, float* __restrict__ ws,
    int S, int H, int d_arg, int bs, int nb, int part_pages, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  const int D = DC ? DC : d_arg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = blockDim.x / 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H, part = blockIdx.y;
  const int ld = split_ld<T, KV>(D);
  float* q_s = reinterpret_cast<float*>(smem);  // [R][D]
  int* table_s = reinterpret_cast<int*>(smem + align16(R * D * 4));
  unsigned char* ring = smem + split_head<R>(D, part_pages);
  unsigned char* mine = ring + warp * split_ring<T, KV>(D);  // [2][K|V][KC][ld]

  // The context length, q and the partition's table entries are loaded
  // together; a block past its slot's context then exits.
  const int len = lens[b];
  const Prescale<T> prescale{scale};
  for (int idx = tid; idx < R * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    q_s[idx] = r < S ? prescale(q[(((size_t)b * S + r) * H + h) * D + d]) : 0.f;
  }
  for (int i = tid; i < part_pages; i += blockDim.x) {
    const int page = part * part_pages + i;
    table_s[i] = page < nb ? tables[(size_t)b * nb + page] : 0;
  }
  const int ctx = max(0, min(len, nb * bs));
  const int pt = part_pages * bs;  // tokens a partition
  const int t_begin = part * pt, t_end = min(t_begin + pt, ctx);
  if (part > 0 && t_begin >= ctx) return;  // past the slot's context
  __syncthreads();

  int row[R], lim[R];
  float m[R], l[R], acc[R][MAXE];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = r < S ? r : -1;
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) acc[r][e] = 0.f;
  }
  const bool quantized = kscale != nullptr;
  const int n_cache = (t_end - t_begin + KC - 1) / KC;
  const int n_chunks = n_cache + (part == 0 ? 1 : 0);  // S <= R <= KC new keys

  // Chunk g into ring stage st; with int8 pools this lane's key's scales
  // come back in ksc / vsc (loads in flight until the chunk is folded).
  auto start = [&](int g, int st, float& ksc, float& vsc) {
    unsigned char* k_st = mine + st * 2 * KC * ld;
    unsigned char* v_st = k_st + KC * ld;
    ksc = vsc = 1.f;
    if (g < n_cache) {
      const int t = t_begin + g * KC + lane;  // this lane's row's token
      long long sl = -1;  // its (slot, head) row of the pools
      if (t < t_end)
        sl = ((long long)table_s[(t - t_begin) / bs] * bs + t % bs) * H + h;
      copy_rows(k_st, v_st, ld, kc, vc, sl < 0 ? -1 : sl * D, D, lane);
      if (quantized && sl >= 0) {
        ksc = __bfloat162float(kscale[sl]);
        vsc = __bfloat162float(vscale[sl]);
      }
    } else {
      const long long off =
          lane < S ? (((long long)b * S + lane) * H + h) * D : -1;
      copy_rows(k_st, v_st, ld, nk, nv, off, D, lane);
    }
  };

  float ksc = 1.f, vsc = 1.f, ksc_next = 1.f, vsc_next = 1.f;
  int g = warp;
  if (g < n_chunks) start(g, 0, ksc, vsc);
  cp_async_commit();
  for (int i = 0; g < n_chunks; ++i, g += W) {
    const int st = i & 1;
    if (g + W < n_chunks) start(g + W, st ^ 1, ksc_next, vsc_next);
    cp_async_commit();   // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // chunk g has landed
    __syncwarp();
    const unsigned char* k_st = mine + st * 2 * KC * ld;
    const unsigned char* v_st = k_st + KC * ld;
    if (g < n_cache) {
#pragma unroll
      for (int r = 0; r < R; ++r) lim[r] = t_end - (t_begin + g * KC);
      fold_raw<R, KV, T>(q_s, k_st, v_st, ld, ksc, vsc, D, lane, row, lim, m,
                         l, acc);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) lim[r] = row[r] >= 0 ? r + 1 : 0;
      fold_raw<R, T, T>(q_s, k_st, v_st, ld, 1.f, 1.f, D, lane, row, lim, m,
                        l, acc);
    }
    __syncwarp();  // the stage is consumed before it is refilled
    ksc = ksc_next;
    vsc = vsc_next;
  }

  // Merge the warps' states (each warp's [R][D + 2] in its own ring), then
  // warp r % W takes row r: written out if one partition covers the
  // context, else to the workspace for paged_merge_kernel.
  cp_async_wait<0>();
  __syncthreads();
  float* st_w = reinterpret_cast<float*>(mine);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* pr = st_w + r * (D + 2);
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
  const bool direct = ctx <= pt;
  for (int r = warp; r < R && r < S; r += W) {
    float m_all = NEG_INF;
    for (int w = 0; w < W; ++w) {
      const float* pr = reinterpret_cast<const float*>(
          ring + w * split_ring<T, KV>(D)) + r * (D + 2);
      m_all = fmaxf(m_all, pr[D]);
    }
    float l_all = 0.f, o[MAXE] = {0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < W; ++w) {
      const float* pr = reinterpret_cast<const float*>(
          ring + w * split_ring<T, KV>(D)) + r * (D + 2);
      const float a = expf(pr[D] - m_all);
      l_all += pr[D + 1] * a;
#pragma unroll
      for (int e = 0; e < MAXE; ++e) {
        const int d = lane + 32 * e;
        if (d < D) o[e] += pr[d] * a;
      }
    }
    if (direct) {
      const size_t base = (((size_t)b * S + r) * H + h) * D;
#pragma unroll
      for (int e = 0; e < MAXE; ++e) {
        const int d = lane + 32 * e;
        if (d < D)
          out[base + d] = from_f32<T>(l_all == 0.f ? 0.f : o[e] / l_all);
      }
    } else {
      float* wr =
          ws + (((size_t)blockIdx.x * gridDim.y + part) * S + r) * (D + 2);
#pragma unroll
      for (int e = 0; e < MAXE; ++e) {
        const int d = lane + 32 * e;
        if (d < D) wr[d] = o[e];
      }
      if (lane == 0) {
        wr[D] = m_all;
        wr[D + 1] = l_all;
      }
    }
  }
}

// One warp per (slot, head, row): the partitions' (m, l, acc) of a slot
// whose context spans more than one, merged in partition order (the
// reference's merge_partials) and normalised (finalize_partial: l == 0
// gives zeros).
template <typename T>
__global__ void __launch_bounds__(THREADS) paged_merge_kernel(
    const float* __restrict__ ws, const int* __restrict__ lens,
    T* __restrict__ out, int B, int S, int H, int D, int bs, int nb,
    int part_pages, int n_part) {
  const int gw = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (gw >= B * H * S) return;
  const int r = gw % S, bh = gw / S, b = bh / H, h = bh % H;
  const int pt = part_pages * bs;
  const int ctx = max(0, min(lens[b], nb * bs));
  const int n_live = max(1, (ctx + pt - 1) / pt);
  if (n_live == 1) return;  // written by the split kernel
  const float* pr = ws + ((size_t)bh * n_part * S + r) * (D + 2);
  float m = pr[D], l = pr[D + 1], o[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    const int d = lane + 32 * e;
    o[e] = d < D ? pr[d] : 0.f;
  }
  for (int p = 1; p < n_live; ++p) {
    pr += (size_t)S * (D + 2);
    const float m2 = pr[D], m_new = fmaxf(m, m2);
    const float a1 = expf(m - m_new), a2 = expf(m2 - m_new);
    l = l * a1 + pr[D + 1] * a2;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) o[e] = o[e] * a1 + pr[d] * a2;
    }
    m = m_new;
  }
  const size_t base = (((size_t)b * S + r) * H + h) * D;
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    const int d = lane + 32 * e;
    if (d < D) out[base + d] = from_f32<T>(l == 0.f ? 0.f : o[e] / l);
  }
}

template <typename T, typename KV, int R, int DC>
cudaError_t launch_split_d(const void* q, const void* kc, const void* vc,
                              const void* ks, const void* vs,
                              const int* tables, const int* lens,
                              const void* nk, const void* nv, void* out,
                              float* ws, int B, int S, int H, int D, int bs,
                              int nb, int part_pages, float scale,
                              cudaStream_t stream) {
  static const cudaError_t attr = opt_in(paged_split_kernel<T, KV, R, DC>);
  if (attr != cudaSuccess) return attr;
  const int head = split_head<R>(D, part_pages);
  const int per_warp = split_ring<T, KV>(D);
  const int warps = max(1, min(WARPS, (SPLIT_SMEM - head) / per_warp));
  const size_t smem = head + warps * per_warp;
  if (smem > SMEM_OPT_IN) return cudaErrorInvalidValue;
  const int n_part = (nb + part_pages - 1) / part_pages;
  if (n_part > 1 && ws == nullptr) return cudaErrorInvalidValue;
  const dim3 grid(B * H, n_part);
  paged_split_kernel<T, KV, R, DC><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kc),
      static_cast<const KV*>(vc), static_cast<const bf16*>(ks),
      static_cast<const bf16*>(vs), tables, lens, static_cast<const T*>(nk),
      static_cast<const T*>(nv), static_cast<T*>(out), ws, S, H, D, bs, nb,
      part_pages, scale);
  if (n_part == 1) return cudaSuccess;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = B * H * S;  // one warp each
  paged_merge_kernel<T><<<(rows + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      ws, lens, static_cast<T*>(out), B, S, H, D, bs, nb, part_pages, n_part);
  return cudaSuccess;
}

// The head_dims the split kernel is compiled for; others read D at run time.
template <typename T, typename KV, int R>
cudaError_t launch_split_rows(const void* q, const void* kc, const void* vc,
                              const void* ks, const void* vs,
                              const int* tables, const int* lens,
                              const void* nk, const void* nv, void* out,
                              float* ws, int B, int S, int H, int D, int bs,
                              int nb, int part_pages, float scale,
                              cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_split_d<T, KV, R, 32>(q, kc, vc, ks, vs, tables, lens, nk,
                                          nv, out, ws, B, S, H, D, bs, nb,
                                          part_pages, scale, stream);
    case 64:
      return launch_split_d<T, KV, R, 64>(q, kc, vc, ks, vs, tables, lens, nk,
                                          nv, out, ws, B, S, H, D, bs, nb,
                                          part_pages, scale, stream);
    case 128:
      return launch_split_d<T, KV, R, 128>(q, kc, vc, ks, vs, tables, lens,
                                           nk, nv, out, ws, B, S, H, D, bs,
                                           nb, part_pages, scale, stream);
  }
  return launch_split_d<T, KV, R, 0>(q, kc, vc, ks, vs, tables, lens, nk, nv,
                                     out, ws, B, S, H, D, bs, nb, part_pages,
                                     scale, stream);
}

template <typename T, typename KV>
cudaError_t launch_split(const void* q, const void* kc, const void* vc,
                         const void* ks, const void* vs, const int* tables,
                         const int* lens, const void* nk, const void* nv,
                         void* out, float* ws, int B, int S, int H, int D,
                         int bs, int nb, int part_pages, float scale,
                         cudaStream_t stream) {
  if (S == 1)
    return launch_split_rows<T, KV, 1>(q, kc, vc, ks, vs, tables, lens, nk,
                                       nv, out, ws, B, S, H, D, bs, nb,
                                       part_pages, scale, stream);
  return launch_split_rows<T, KV, SPLIT_MAX_ROWS>(
      q, kc, vc, ks, vs, tables, lens, nk, nv, out, ws, B, S, H, D, bs, nb,
      part_pages, scale, stream);
}

// ------------------------------------------ bf16 suffix: tensor-core kernel

constexpr int BM = 16 * WARPS;  // query rows a block: 16 a warp
constexpr int BN = 64;          // keys a tile

// Dynamic shared memory of paged_suffix_mma_kernel<KV, D>: q [BM] and two
// stages each of K and V [BN] (bf16 rows padded to tile_ld<D>()), the
// tile's int8 scales [2][BN] f32, the raw int8 rows [2 stages][K|V][BN][D]
// (int8 pools only), the slot's table row [nb].
template <typename KV, int D>
__host__ __device__ constexpr int suffix_fixed_bytes() {
  return 2 * (BM + 4 * BN) * tile_ld<D>() + 2 * BN * 4 +
         (std::is_same<KV, int8_t>::value ? 2 * 2 * BN * D : 0);
}

// Sixteen int8 values widened to bf16 (exact: |x| <= 127), as two 16-byte
// units.
__device__ __forceinline__ void widen_int8x16(uint4 raw, uint4* dst) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int x = 0; x < 8; ++x)
    w[x] = pack_bf16(static_cast<float>(e[2 * x]),
                     static_cast<float>(e[2 * x + 1]));
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// Grid (B * H, ceil(S / BM)), the heaviest (last) query tiles first. Key
// tiles 0 .. n_ct - 1 are the cached context (keys past ctx masked), the
// rest the new tokens (keys past the row or past S masked).
template <typename KV, int D>
__global__ void __launch_bounds__(THREADS) paged_suffix_mma_kernel(
    const bf16* __restrict__ q, const KV* __restrict__ kc,
    const KV* __restrict__ vc, const bf16* __restrict__ kscale,
    const bf16* __restrict__ vscale, const int* __restrict__ tables,
    const int* __restrict__ lens, const bf16* __restrict__ nk,
    const bf16* __restrict__ nv, bf16* __restrict__ out, int S, int H,
    int bs, int nb, float scale) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  constexpr int LD = tile_ld<D>(), CPR = D / 8, UPR = D / 16;
  constexpr int STAGE = BN * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]
  bf16* k_s = q_s + BM * LD;                      // [2][BN][LD]
  bf16* v_s = k_s + 2 * STAGE;                    // [2][BN][LD]
  float* ks_s = reinterpret_cast<float*>(v_s + 2 * STAGE);  // [BN]
  float* vs_s = ks_s + BN;                                  // [BN]
  int8_t* raw = reinterpret_cast<int8_t*>(vs_s + BN);  // [2][K|V][BN][D]
  int* table_s = reinterpret_cast<int*>(smem_raw + suffix_fixed_bytes<KV, D>());

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int row0 = i0 + warp * 16 + (lane >> 2);  // rows row0, row0 + 8
  const int ctx = max(0, min(lens[b], nb * bs));
  for (int i = tid; i < nb; i += THREADS)
    table_s[i] = tables[(size_t)b * nb + i];
  __syncthreads();
  const int n_ct = (ctx + BN - 1) / BN;
  const int n_tiles = n_ct + (min(S, i0 + BM) + BN - 1) / BN;
  const long long ld = (long long)H * D;  // elements between two tokens' rows
  const bf16* nkb = nk + ((size_t)b * S * H + h) * D;
  const bf16* nvb = nv + ((size_t)b * S * H + h) * D;
  auto cache_row = [&](int j) -> long long {  // key j < ctx of the slot
    return ((long long)table_s[j / bs] * bs + j % bs) * ld + (long long)h * D;
  };

  // Tile tt into ring stage st: a cache tile page by page through the
  // table (int8: raw rows, and key tid's scales into ksc / vsc), a tile of
  // new tokens from new_k / new_v.
  float ksc_next = 1.f, vsc_next = 1.f;
  auto start = [&](int tt, int st) {
    if (tt < n_ct) {
      if constexpr (INT8) {
        int8_t* kr = raw + (st * 2) * BN * D;
        int8_t* vr = kr + BN * D;
#pragma unroll
        for (int c = tid; c < BN * UPR; c += THREADS) {
          const int r = c / UPR, col = (c % UPR) * 16, j = tt * BN + r;
          const bool valid = j < ctx;
          const long long off = valid ? cache_row(j) + col : 0;
          cp_async16(kr + r * D + col, kc + off, valid);
          cp_async16(vr + r * D + col, vc + off, valid);
        }
        const int j = tt * BN + tid;
        ksc_next = vsc_next = 1.f;
        if (tid < BN && j < ctx) {
          const long long sl = cache_row(j) / D;  // (slot * H + h)
          ksc_next = __bfloat162float(kscale[sl]);
          vsc_next = __bfloat162float(vscale[sl]);
        }
      } else {
#pragma unroll
        for (int c = tid; c < BN * CPR; c += THREADS) {
          const int r = c / CPR, col = (c % CPR) * 8, j = tt * BN + r;
          const bool valid = j < ctx;
          const long long off = valid ? cache_row(j) + col : 0;
          cp_async16(k_s + st * STAGE + r * LD + col, kc + off, valid);
          cp_async16(v_s + st * STAGE + r * LD + col, vc + off, valid);
        }
      }
    } else {
      const int t0 = (tt - n_ct) * BN;
#pragma unroll
      for (int c = tid; c < BN * CPR; c += THREADS) {
        const int r = c / CPR, col = (c % CPR) * 8, t = t0 + r;
        const bool valid = t < S;
        const long long off = (valid ? t : 0) * ld + col;
        cp_async16(k_s + st * STAGE + r * LD + col, nkb + off, valid);
        cp_async16(v_s + st * STAGE + r * LD + col, nvb + off, valid);
      }
    }
  };

  // Tile 0 is in flight while q is staged.
  start(0, 0);
  cp_async_commit();
  uint32_t qf[D / 16][4];
  load_q_frags<BM, D, THREADS>(qf, q_s, q + ((size_t)b * S * H + h) * D, ld,
                               i0, S, scale, warp, lane);

  float o[D / 8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  const int t4 = lane & 3;
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int st = tt & 1;
    const bool cache = tt < n_ct;
    const float ksc = ksc_next, vsc = vsc_next;  // this tile's, key tid
    if (tt + 1 < n_tiles) start(tt + 1, st ^ 1);
    cp_async_commit();   // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // tile tt has landed
    __syncthreads();
    if (INT8 && cache) {  // widen the raw rows into the stage
      const int8_t* kr = raw + (st * 2) * BN * D;
      const int8_t* vr = kr + BN * D;
#pragma unroll
      for (int c = tid; c < BN * UPR; c += THREADS) {
        const int r = c / UPR, col = (c % UPR) * 16;
        const int at = st * STAGE + r * LD + col;
        widen_int8x16(*reinterpret_cast<const uint4*>(kr + r * D + col),
                      reinterpret_cast<uint4*>(k_s + at));
        widen_int8x16(*reinterpret_cast<const uint4*>(vr + r * D + col),
                      reinterpret_cast<uint4*>(v_s + at));
      }
      if (tid < BN) {
        ks_s[tid] = ksc;
        vs_s[tid] = vsc;
      }
      __syncthreads();
    }
    float s[BN / 8][4];
    qk_tile<D, BN>(s, qf, k_s + st * STAGE, lane);
    if (INT8 && cache) {  // K's scale on the score columns
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= ks_s[j * 8 + 2 * t4 + (e & 1)];
    }
    if (cache) {
      if ((tt + 1) * BN > ctx)
        mask_tile<BN>(s, tt * BN, row0, lane, ctx, 0, -INFINITY);
    } else {
      const int k0 = (tt - n_ct) * BN;
      if (k0 + BN > i0 + 1 || k0 + BN > S)
        mask_tile<BN>(s, k0, row0, lane, S, 1, -INFINITY);
    }
    online_softmax_tile<D, BN>(s, m, l, o);
    if (INT8 && cache) {  // V's scale on P, before P is rounded
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= vs_s[j * 8 + 2 * t4 + (e & 1)];
    }
    pv_tile<D, BN>(o, s, v_s + st * STAGE, lane);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  finish_row_sums(l);
  const int w0 = i0 + warp * 16;  // this warp's first row
  store_rows<D>(out + (((size_t)b * S + w0) * H + h) * D, ld, S - w0, o, l,
                q_s + warp * 16 * LD, lane);
}

template <typename KV, int D>
cudaError_t launch_suffix_d(const void* q, const void* kc, const void* vc,
                            const void* ks, const void* vs, const int* tables,
                            const int* lens, const void* nk, const void* nv,
                            void* out, int B, int S, int H, int bs, int nb,
                            float scale, cudaStream_t stream) {
  static const cudaError_t attr = opt_in(paged_suffix_mma_kernel<KV, D>);
  if (attr != cudaSuccess) return attr;
  const size_t smem = suffix_fixed_bytes<KV, D>() + align16(nb * 4);
  if (smem > SMEM_OPT_IN) return cudaErrorInvalidValue;
  const dim3 grid(B * H, (S + BM - 1) / BM);
  paged_suffix_mma_kernel<KV, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const KV*>(kc),
      static_cast<const KV*>(vc), static_cast<const bf16*>(ks),
      static_cast<const bf16*>(vs), tables, lens, static_cast<const bf16*>(nk),
      static_cast<const bf16*>(nv), static_cast<bf16*>(out), S, H, bs, nb,
      scale);
  return cudaSuccess;
}

template <typename KV>
cudaError_t launch_suffix(const void* q, const void* kc, const void* vc,
                          const void* ks, const void* vs, const int* tables,
                          const int* lens, const void* nk, const void* nv,
                          void* out, int B, int S, int H, int D, int bs,
                          int nb, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_suffix_d<KV, 32>(q, kc, vc, ks, vs, tables, lens, nk, nv,
                                     out, B, S, H, bs, nb, scale, stream);
    case 64:
      return launch_suffix_d<KV, 64>(q, kc, vc, ks, vs, tables, lens, nk, nv,
                                     out, B, S, H, bs, nb, scale, stream);
    case 128:
      return launch_suffix_d<KV, 128>(q, kc, vc, ks, vs, tables, lens, nk,
                                      nv, out, B, S, H, bs, nb, scale, stream);
  }
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------ dispatch

template <typename T, typename KV>
cudaError_t launch_typed(const void* q, const void* kc, const void* vc,
                         const void* ks, const void* vs, const int* tables,
                         const int* lens, const void* nk, const void* nv,
                         void* out, float* ws, int B, int S, int H, int D,
                         int bs, int nb, int part_pages,
                         float scale, cudaStream_t stream) {
  if (part_pages > 0) {
    if (S > SPLIT_MAX_ROWS) return cudaErrorInvalidValue;
    return launch_split<T, KV>(q, kc, vc, ks, vs, tables, lens, nk, nv, out,
                               ws, B, S, H, D, bs, nb, part_pages, scale,
                               stream);
  }
  if constexpr (std::is_same<T, bf16>::value && !std::is_same<KV, float>::value)
    return launch_suffix<KV>(q, kc, vc, ks, vs, tables, lens, nk, nv, out, B,
                             S, H, D, bs, nb, scale, stream);
  else
    return launch_f32_suffix<T, KV>(q, kc, vc, ks, vs, tables, lens, nk, nv,
                                    out, B, S, H, D, bs, nb, scale, stream);
}

template <typename T>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* kc,
                      const void* vc, const void* ks, const void* vs,
                      const int* tables, const int* lens, const void* nk,
                      const void* nv, void* out, float* ws, int B, int S,
                      int H, int D, int bs, int nb, int part_pages,
                      float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_typed<T, float>(q, kc, vc, ks, vs, tables, lens, nk, nv,
                                    out, ws, B, S, H, D, bs, nb, part_pages,
                                    scale, stream);
    case 1:
      return launch_typed<T, bf16>(q, kc, vc, ks, vs, tables, lens, nk, nv,
                                   out, ws, B, S, H, D, bs, nb, part_pages,
                                   scale, stream);
    case 2:
      return launch_typed<T, int8_t>(q, kc, vc, ks, vs, tables, lens, nk, nv,
                                     out, ws, B, S, H, D, bs, nb, part_pages,
                                     scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8. q / new_k / new_v / out
// share q_dtype; q is multiplied by `scale` (sm_scale) and rounded to its
// type as it is staged; the pools are kv_dtype; k_scale / v_scale are bf16
// (int8 pools only, else null). part_pages > 0 takes the split path
// (S <= SPLIT_MAX_ROWS), with workspace [B, H, ceil(nb / part_pages), S,
// D + 2] f32 when that count is above 1 (else it may be null);
// part_pages == 0 the suffix kernels (bf16 q with bf16 or int8 pools: D in
// {32, 64, 128}). Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for what the kernels do not take.
extern "C" int paged_attention_launch(
    int q_dtype, int kv_dtype, const void* q, const void* k_cache,
    const void* v_cache, const void* k_scale, const void* v_scale,
    const void* block_tables, const void* context_lens, const void* new_k,
    const void* new_v, void* out, void* workspace, int B, int S, int H, int D,
    int bs, int nb, int part_pages, float scale, void* stream) {
  if (D < 1 || D > 32 * MAXE || B < 1 || S < 1 || H < 1 || bs < 1 || nb < 1 ||
      part_pages < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear a stale non-sticky error from earlier work
  const int* tables = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(context_lens);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0)
    err = launch_kv<float>(kv_dtype, q, k_cache, v_cache, k_scale, v_scale,
                           tables, lens, new_k, new_v, out, ws, B, S, H, D,
                           bs, nb, part_pages, scale, st);
  else if (q_dtype == 1)
    err = launch_kv<bf16>(kv_dtype, q, k_cache, v_cache, k_scale, v_scale,
                          tables, lens, new_k, new_v, out, ws, B, S, H, D, bs,
                          nb, part_pages, scale, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
