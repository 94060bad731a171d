// Flash attention backward: dQ, dK and dV from the forward's per-row
// logsumexp, causal or not, with no S x S matrix in device memory.
//
// Replaces:
//   * ray_tpu/ops/flash_attention.py::_dq_kernel (pallas_call at :375) with
//     dq_kernel (entry flash_bwd_dq_launch);
//   * ::_dkv_kernel (pallas_call at :397) with dkv_kernel (entry
//     flash_bwd_dkv_launch);
//   * ::_packed_bwd_kernel (pallas_call at :587): the same two kernels, run
//     by the Python wrapper flash_attention_packed_bwd on the strides of a
//     packed [B, S, 3E] qkv, writing dq, dk and dv straight into the column
//     ranges [0, E), [E, 2E), [2E, 3E) of one dqkv tensor.
// delta_kernel (entry flash_bwd_delta_launch) is the pre-pass both need:
// delta = rowsum(dO * O) in f32, which the reference computes in XLA (:681)
// or inside the packed kernel (:503).
//
// Bound on this card: operations. The backward does 10 * D flops per
// (query, key) pair below the diagonal against a few bytes per row, far above
// the card's flops-per-byte balance. This first version runs its products on
// the CUDA cores in f32 (no wgmma, no TMA), as the forward does. The design:
//   * two kernels with disjoint outputs and no atomics: one block per (tile
//     of 64 query rows, batch * head) walks the key chunks up to the causal
//     diagonal and accumulates dQ; one block per (tile of 64 key rows,
//     batch * head) walks the query chunks from the diagonal on and
//     accumulates dK and dV. Each recomputes P = exp(q k^T - lse) for its
//     pairs (the price of no atomics: the scores are computed twice);
//   * a warp owns 8 rows of the tile, its lanes the 32 rows of the staged
//     chunk, as in the forward's fold (attn_common.cuh): lane j scores chunk
//     row j against all 8 rows, then every lane updates the output
//     dimensions it owns with the chunk's dS (and P) broadcast one row at a
//     time, so every staged element is read once per warp;
//   * accumulators stay in f32 registers; P and dS are rounded to the input
//     type before the products, as the reference rounds them;
//   * q is prescaled by sm_scale as it is staged (the reference's rounding),
//     so dK = dS^T q_scaled carries the scale and dQ is scaled once at the
//     end;
//   * masked pairs get P = 0 explicitly, never exp(NEG_INF - lse);
//   * every operand is read through (batch, seq, head) strides, so the
//     packed layout needs no split, transpose or concatenation.
// The one-block backward (K3) is flash_bwd_fused.cu, on the same helpers
// (flash_bwd_common.cuh).
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

// dQ (the reference's _dq_kernel): block (query tile, batch * head).
template <typename T>
__global__ void __launch_bounds__(THREADS) dq_kernel(Args<T> a) {
  extern __shared__ float smem[];
  const int S = a.S, H = a.H, D = a.D;
  float* q_s = smem;                 // [TILE][D] prescaled queries
  float* do_s = q_s + TILE * D;      // [TILE][D] dO rows
  float* k_c = do_s + TILE * D;      // [KC][D + 1] key chunk
  float* v_c = k_c + KC * (D + 1);   // [KC][D + 1] value chunk

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int i0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  stage_tile(a.q, a.qv, b, h, i0, S, D, q_s, Prescale<T>{a.scale});
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

  const T* kb = row_ptr(a.k, a.kv, b, 0, h);
  const T* vb = row_ptr(a.v, a.vv, b, 0, h);
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
      ds[r] = round_to<T>(p * (dp[r] - delta[r]));
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
    T* out = a.dq + b * a.dqv.sb + (i0 + row[r]) * a.dqv.ss + h * a.dqv.sh;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) out[d] = from_f32<T>(acc[r][e] * a.scale);
    }
  }
}

// dK and dV (the reference's _dkv_kernel): block (key tile, batch * head).
template <typename T>
__global__ void __launch_bounds__(THREADS) dkv_kernel(Args<T> a) {
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

  const T* qb = row_ptr(a.q, a.qv, b, 0, h);
  const T* db = row_ptr(a.dout, a.dov, b, 0, h);
  const Prescale<T> prescale{a.scale};
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
      const float pf = valid ? expf(s[r] - lse) : 0.f;
      p[r] = round_to<T>(pf);
      ds[r] = round_to<T>(pf * (dp[r] - delta));
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
template <typename T>
int launch_grad(int which, const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta, void* dq,
                void* dk, void* dv, int B, int S, int H, int D,
                const long long* st, float scale, int causal,
                cudaStream_t stream) {
  const Args<T> a = make_args<T>(q, k, v, dout, lse, delta, dq, dk, dv, S, H,
                                 D, st, scale, causal);
  void (*kernel)(Args<T>) = which == 0 ? dq_kernel<T> : dkv_kernel<T>;
  const size_t smem = sizeof(float) * (2 * TILE * D + 2 * KC * (D + 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + TILE - 1) / TILE, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

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
    return launch_grad<float>(which, q, k, v, dout, lse, delta, dq, dk, dv, B,
                              S, H, D, st, scale, causal, s);
  if (dtype == 1)
    return launch_grad<__nv_bfloat16>(which, q, k, v, dout, lse, delta, dq,
                                      dk, dv, B, S, H, D, st, scale, causal, s);
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

// q (not prescaled), k, v, dout: [B, S, H, D] inputs; lse, delta: [B*H, S]
// f32; dq (this entry) or dk and dv (the next) are written through their
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
