// One-pass flash attention backward (K3): dQ, dK and dV from the forward's
// per-row logsumexp in one sweep over the (query, key) pairs, with
// delta = rowsum(dO * O) computed inside the kernel (no pre-pass launch).
//
// Replaces ray_tpu/ops/flash_attention.py::_bwd_fused_kernel (:288,
// pallas_call at :334), which the reference runs when one block covers the
// whole sequence (:674): one TPU program holds the [S, S] score tile in VMEM
// and does five products on it. An SM holds no [S, S] tile at S = 1024, so
// the design here tiles the keys instead:
//   * one block per (tile of 64 key rows, batch * head) walks the query
//     chunks of 32 rows from the causal diagonal on, keeping its dK and dV in
//     f32 registers (a warp owns 8 key rows, as in flash_bwd.cu's dkv_kernel);
//   * for each chunk the block computes delta of its 32 query rows from the
//     staged dO and O rows (one warp per 4 rows, lanes over the head dims);
//   * P = exp(q k^T - lse) is recomputed once per pair and feeds all three
//     products: dV += P^T dO and dK += dS^T q_scaled in registers, and the
//     chunk's dS [32 x 64] goes through shared memory so that every thread
//     sums dS K for D / 8 (query, dim) outputs, one after another (holding
//     all D / 8 sums at once ran 8% slower on an H100), and stores them in
//     the key tile's own slice of an f32 workspace of partial dQ sums: the
//     tile's partial dQ of every query row it can see (rows from the tile's
//     first key on when causal, all rows otherwise), one store per output;
//   * a second small launch (dq_finish_kernel) sums each dQ element's
//     partials in key-tile order, scales by sm_scale once and writes dQ in
//     the input type through its strides. The order of every sum is fixed,
//     so dQ, like dK and dV, is the same bit for bit from run to run (the
//     reference's one program per head is deterministic too); atomics
//     would order the adds as the blocks happen to be scheduled.
// Rounding points are the reference's: P is rounded to dO's type before
// dV = P^T dO; dS = P * (dP - delta) to q's type before dK and dQ; q is
// prescaled as it is staged (its storage rounding), so dK carries sm_scale;
// dQ is scaled once at the end. Masked pairs get P = 0 explicitly.
//
// Bound on this card: operations (10 * D flops per causal pair, as K7). This
// first version runs its products on the CUDA cores in f32 (no wgmma, no
// TMA), like K4 and K5; the partial dQ sums replace K4's second recompute of
// the scores. Their workspace holds, per batch * head, 8,704 rows of D f32
// at S = 1024 causal (16,384 non-causal): 214 MB at the training shape B8
// H12 D64, written once and read once.
#include "flash_bwd_common.cuh"

using namespace rtt;

namespace {

// First row of key tile t's slice in one (batch * head)'s part of the
// partial-dQ workspace: causal tile u holds the S - u * TILE query rows from
// its first key on, a non-causal tile all S rows.
__host__ __device__ __forceinline__ long long part_offset(int t, int S,
                                                          int causal) {
  const long long tl = t;
  return causal ? tl * S - TILE * tl * (tl - 1) / 2 : tl * S;
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

template <typename T>
__global__ void __launch_bounds__(THREADS) fused_bwd_kernel(FusedArgs<T> a) {
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

  const T* qb = row_ptr(a.q, a.qv, b, 0, h);
  const T* db = row_ptr(a.dout, a.dov, b, 0, h);
  const Prescale<T> prescale{a.scale};
  // This tile's slice of partial dQ sums: query rows first_q .. S - 1.
  // Causal: query chunks wholly above the tile's first key see none of it.
  const int first_q = a.causal ? j0 : 0;
  const int n_tiles = (S + TILE - 1) / TILE;
  float* dq_rows = a.dq_part +
                   ((size_t)bh * part_offset(n_tiles, S, a.causal) +
                    part_offset(blockIdx.x, S, a.causal)) * D;
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
        const T* orow = row_ptr(a.o, a.ov, b, qi, h);
        for (int d = lane; d < D; d += 32)
          acc += do_c[i * (D + 1) + d] * to_f32(orow[d]);
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
      const float pf = valid ? expf(s[r] - lse) : 0.f;
      p[r] = round_to<T>(pf);
      ds[r] = round_to<T>(pf * (dp[r] - delta));
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
    T* ko = a.dk + b * a.dkv.sb + j * a.dkv.ss + h * a.dkv.sh;
    T* vo = a.dv + b * a.dvv.sb + j * a.dvv.ss + h * a.dvv.sh;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) {
        ko[d] = from_f32<T>(dk[r][e]);
        vo[d] = from_f32<T>(dv[r][e]);
      }
    }
  }
}

// dQ = sm_scale * (the sum of the key tiles' partials, in tile order), in
// the input type, through dQ's strides.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    dq_finish_kernel(const float* __restrict__ dq_part, T* __restrict__ dq,
                     long long total, int S, int H, int D, View w,
                     float scale, int causal) {
  const int n_tiles = (S + TILE - 1) / TILE;
  const long long per_bh = part_offset(n_tiles, S, causal);
  for (long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * THREADS) {
    const int d = static_cast<int>(idx % D);
    const long long row = idx / D;
    const int i = static_cast<int>(row % S);
    const long long bh = row / S;
    const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
    const float* part = dq_part + bh * per_bh * D + d;
    const int last = causal ? i / TILE : n_tiles - 1;
    float acc = 0.f;
    for (int t = 0; t <= last; ++t)
      acc += part[(part_offset(t, S, causal) + i - (causal ? t * TILE : 0)) * D];
    dq[b * w.sb + i * w.ss + h * w.sh + d] = from_f32<T>(acc * scale);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, float* dq_part, void* dq,
           void* dk, void* dv, int B, int S, int H, int D,
           const long long* st, float scale, int causal, cudaStream_t stream) {
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
  const View dqv{st[21], st[22], st[23]};
  a.S = S;
  a.H = H;
  a.D = D;
  a.scale = scale;
  a.causal = causal;

  const long long total = static_cast<long long>(B) * H * S * D;
  cudaError_t err;
  const size_t smem = sizeof(float) * (2 * TILE * D + 2 * KC * (D + 1) +
                                       KC * (TILE + 1) + KC);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_bwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + TILE - 1) / TILE, B * H);
  fused_bwd_kernel<T><<<grid, THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (total + THREADS - 1) / THREADS;
  dq_finish_kernel<T><<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535),
                        THREADS, 0, stream>>>(dq_part, static_cast<T*>(dq),
                                              total, S, H, D, dqv, scale,
                                              causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows of the partial-dQ workspace per (batch * head): the wrapper
// allocates B*H times this many rows of D f32.
extern "C" long long flash_bwd_fused_workspace_rows(int S, int causal) {
  return part_offset((S + TILE - 1) / TILE, S, causal);
}

// dtype: 0 = float32, 1 = bfloat16. q (not prescaled), k, v, o, dout:
// [B, S, H, D] inputs with a unit last-dim stride; lse: [B*H, S] f32;
// dq_part: an f32 workspace of B*H*flash_bwd_fused_workspace_rows(S,
// causal)*D elements (every element is written before it is read); dq, dk,
// dv are written through their strides. st: 24 element strides, (batch,
// seq, head) of q, k, v, o, dout, dk, dv, dq in that order. Two launches on
// `stream` (the pass over the pairs, then the sum of dQ's partials with its
// scale and cast). Returns cudaGetLastError().
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
  if (dtype == 0)
    return launch<float>(q, k, v, o, dout, lse, part, dq, dk, dv, B, S, H, D,
                         st, scale, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, dout, lse, part, dq, dk, dv, B,
                                 S, H, D, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
