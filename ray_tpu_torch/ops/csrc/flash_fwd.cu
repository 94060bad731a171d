// Flash attention forward: blockwise online-softmax attention, causal or not,
// for the full-prefill program (the first chunk of every prompt), the
// long-context training forward, and the packed training forward.
//
// Replaces: ray_tpu/ops/flash_attention.py::_fwd_kernel (pallas_call at :149,
// reached through _flash_fwd_pallas :125) through flash_fwd_launch, and
// ::_packed_fwd_kernel (pallas_call at :560) through flash_fwd_packed_launch,
// which runs the same device code on the strides of a packed [B, S, 3E] qkv.
//
// Bound on this card: operations. At S >= 128 and D = 64 the kernel does
// ~2 * S * D flops per query row against 2 * D bytes of K/V per key, well
// above the card's flops-per-byte balance, so the tensor cores would set the
// bound. This first version is simple and right and runs its products on
// the CUDA cores in f32 (no wgmma, no TMA); moving the two products onto
// wgmma tiles is the next step. What the design does do:
//   * one thread block per (tile of 64 query rows, batch * head); the block
//     reads q / k / v [B, S, H, D] through their strides, so the head split
//     of the packed qkv projection needs no transpose;
//   * q is prescaled by sm_scale as it is staged, rounded to its storage
//     type as the reference rounds it, so no prescale pass runs before;
//   * the key loop stops at the causal diagonal (tiles above it are never
//     read, not just skipped), staging 32 keys of K and V at a time in
//     shared memory with 16-byte loads; each warp folds every staged key
//     into its 8 query rows with m / l / acc in f32 registers
//     (attn_common.cuh);
//   * masked keys get probability exactly 0, so a row whose first keys are
//     all masked never averages garbage;
//   * O is written as [B, S, H, D] and the per-row logsumexp as [B*H, S]
//     f32 (the TPU kernel's 8 padded rows are gone).
#include "attn_common.cuh"

using namespace rtt;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = 8;
constexpr int QT = WARPS * RPW;  // 64 query rows per block

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int S, int H, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, float scale,
    int causal) {
  extern __shared__ float smem[];
  float* q_s = smem;                // [QT][D]
  float* k_s = q_s + QT * D;        // [KC][D + 1]
  float* v_s = k_s + KC * (D + 1);  // [KC][D]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int i0 = blockIdx.x * QT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  const Prescale<T> prescale{scale};
  for (int idx = tid; idx < QT * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, i = i0 + r;
    q_s[idx] = i < S ? prescale(qb[i * qss + d]) : 0.f;
  }
  int row[RPW], lim[RPW];
  float m[RPW], l[RPW], acc[RPW][MAXE];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int lr = warp * RPW + r;
    row[r] = i0 + lr < S ? lr : -1;
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) acc[r][e] = 0.f;
  }

  const int k_end = causal ? min(S, i0 + QT) : S;
  for (int k0 = 0; k0 < k_end; k0 += KC) {
    __syncthreads();  // the previous chunk is consumed (q is staged)
    auto k_row = [&](int j) -> long long {
      return k0 + j < k_end ? (k0 + j) * kss : -1;
    };
    auto v_row = [&](int j) -> long long {
      return k0 + j < k_end ? (k0 + j) * vss : -1;
    };
    stage_rows<THREADS>(kb, k_row, D, tid, k_s, D + 1);
    stage_rows<THREADS>(vb, v_row, D, tid, v_s, D);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int limit = causal ? min(i0 + row[r] + 1, S) : S;
      lim[r] = row[r] >= 0 ? limit - k0 : 0;
    }
    fold_chunk<RPW>(q_s, k_s, v_s, 1.f, 1.f, D, lane, row, lim, m, l, acc);
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (row[r] < 0) continue;
    const int i = i0 + row[r];
    const float safe = l[r] == 0.f ? 1.f : l[r];
    const size_t base = (((size_t)b * S + i) * H + h) * D;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) out[base + d] = from_f32<T>(acc[r][e] / safe);
    }
    if (lane == 0) lse[(size_t)bh * S + i] = m[r] + logf(safe);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int S, int H, int D, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (QT * D + KC * (D + 1) + KC * D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + QT - 1) / QT, B * H);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// Typed dispatch of one launch; k and v start k_off and v_off elements past
// their pointers (the packed layout's column offsets E and 2E, or 0).
int dispatch(int dtype, const void* q, const void* k, const void* v,
             long long k_off, long long v_off, void* out, void* lse, int B,
             int S, int H, int D, const long long* st, float scale,
             int causal, void* stream) {
  if (D < 1 || D > 32 * MAXE || B < 1 || S < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear a stale non-sticky error from earlier work
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    const float* base_k = static_cast<const float*>(k) + k_off;
    const float* base_v = static_cast<const float*>(v) + v_off;
    return launch<float>(q, base_k, base_v, out, l, B, S, H, D, st, scale,
                         causal, s);
  }
  if (dtype == 1) {
    const __nv_bfloat16* base_k = static_cast<const __nv_bfloat16*>(k) + k_off;
    const __nv_bfloat16* base_v = static_cast<const __nv_bfloat16*>(v) + v_off;
    return launch<__nv_bfloat16>(q, base_k, base_v, out, l, B, S, H, D, st,
                                 scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v: [B, S, H, D] with element
// strides (batch, seq, head) each and a unit last-dim stride; q is prescaled
// by `scale` in-kernel; out is contiguous [B, S, H, D]; lse is [B*H, S] f32.
// Returns cudaGetLastError().
extern "C" int flash_fwd_launch(
    int dtype, const void* q, const void* k, const void* v, void* out,
    void* lse, int B, int S, int H, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, float scale, int causal, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  return dispatch(dtype, q, k, v, 0, 0, out, lse, B, S, H, D, st, scale,
                  causal, stream);
}

// The packed entry (K6): qkv is contiguous [B, S, 3E] with E = H * D, q, k
// and v its column ranges [0, E), [E, 2E), [2E, 3E); out is [B, S, E] and
// lse [B, H, S] f32, the layouts of the reference's packed kernel.
extern "C" int flash_fwd_packed_launch(int dtype, const void* qkv, void* out,
                                       void* lse, int B, int S, int H, int D,
                                       float scale, int causal, void* stream) {
  const long long E = static_cast<long long>(H) * D;
  const long long sb = S * 3 * E, ss = 3 * E, sh = D;
  const long long st[9] = {sb, ss, sh, sb, ss, sh, sb, ss, sh};
  return dispatch(dtype, qkv, qkv, qkv, E, 2 * E, out, lse, B, S, H, D, st,
                  scale, causal, stream);
}
