// Flash attention forward: blockwise online-softmax attention, causal or not,
// for the full-prefill program (the first chunk of every prompt), the
// training forward of attention_impl="auto" and of the long-context branch,
// and the packed training forward.
//
// Replaces: ray_tpu/ops/flash_attention.py::_fwd_kernel (:66, pallas_call at
// :149, reached through _flash_fwd_pallas :125) through flash_fwd_launch, and
// ::_packed_fwd_kernel (:443, pallas_call at :560) through
// flash_fwd_packed_launch, which runs the same device code on the strides of
// a packed [B, S, 3E] qkv.
//
// Bound on this card, at the training shape B8 S1024 H12 D64 bf16 causal:
// bytes, 0.0151 ms (q, k, v read once, O written once, lse: 50.7 MB at
// 3.35 TB/s), with the operations close behind (4 * D flops per causal
// pair, 12.9 GFLOP: 0.0130 ms at 989 TFLOP/s). Both products have to run on
// the tensor cores to come near either, and the loads have to overlap them.
//
// bf16 (flash_fwd_mma_kernel<D>, D in {32, 64, 128}): a FlashAttention-2
// style kernel on mma.sync, ldmatrix and cp.async.
//   * one block of 4 warps per (batch * head, tile of 64 query rows); each
//     warp owns 16 rows. Causal grids launch the heaviest (last) query tiles
//     first: blockIdx.x walks batch * head fastest, and blockIdx.y counts the
//     query tiles down from the last. At D <= 64 four blocks share an SM
//     (128 registers a thread, 46 KB of shared memory a block);
//   * q is staged once, prescaled by sm_scale and rounded to bf16 as the
//     reference rounds it, and kept in registers as the m16n8k16 A fragments
//     of every k-step (ldmatrix);
//   * K and V tiles of 64 keys stay bf16 in a two-stage shared-memory ring
//     filled by 16-byte cp.async.cg copies: tile j + 1 is in flight while
//     tile j is computed. Rows are padded by 16 bytes, so the eight rows of
//     each ldmatrix fall in distinct banks. Rows past S are zero-filled by
//     the copy and never read from memory;
//   * S = Q K^T on mma.sync.m16n8k16 (bf16 in, f32 accumulate), K's B
//     fragments by ldmatrix; the online softmax runs on the f32 accumulator
//     fragments, each row's max and sum across the four threads of a quad
//     (__shfl_xor_sync), with exp2f(s log2(e) - m log2(e)) (the plain
//     version's exp(s - m) to within ~1e-6 relative);
//   * P is rounded to bf16 in registers (round to nearest even, the
//     reference's p.astype(v.dtype)) and used directly as the A fragment of
//     P V: the m16n8 accumulator layout is the m16n8k16 A layout, so P never
//     touches shared memory. V's B fragments come by ldmatrix.trans. l sums
//     the unrounded P in f32, as the reference does;
//   * only the tiles on the causal diagonal and at the ragged end of S are
//     masked; masked keys get P exactly 0, and the key loop stops at the
//     diagonal (tiles above it are never read);
//   * O /= l in f32 (l == 0 -> 1), rounded to bf16, staged through the warp's
//     own rows of the q buffer and written with 16-byte stores.
// Still to come: wgmma with TMA and a producer warp (Hopper's full
// tensor-core rate).
//
// f32 (flash_fwd_kernel): the products stay on the CUDA cores in f32. TF32
// tensor cores keep about three decimal digits, which the f32 paths (held
// token-identical and to ~1e-6 against the plain versions) cannot take. One
// block per (tile of 64 query rows, batch * head), 32-key chunks of K and V
// staged in shared memory as f32 with 16-byte loads, each warp folding every
// staged key into its 8 query rows (attn_common.cuh).
//
// Both read q / k / v [B, S, H, D] through their strides, so the head split
// of the packed qkv projection needs no transpose, write O as [B, S, H, D]
// and the per-row logsumexp as [B*H, S] f32 (the TPU kernel's 8 padded rows
// are gone).
#include "attn_common.cuh"

using namespace rtt;

namespace {

// ------------------------------------------------- f32: CUDA-core kernel

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = 8;
constexpr int QT = WARPS * RPW;  // 64 query rows per block

__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int S, int H, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, float scale, int causal) {
  extern __shared__ float smem[];
  float* q_s = smem;                // [QT][D]
  float* k_s = q_s + QT * D;        // [KC][D + 1]
  float* v_s = k_s + KC * (D + 1);  // [KC][D]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int i0 = blockIdx.x * QT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;

  const Prescale<float> prescale{scale};
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
    fold_chunk<RPW, float>(q_s, k_s, v_s, 1.f, 1.f, D, lane, row, lim, m, l,
                           acc);
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
      if (d < D) out[base + d] = acc[r][e] / safe;
    }
    if (lane == 0) lse[(size_t)bh * S + i] = m[r] + logf(safe);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int H, int D, const long long* st,
               float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (QT * D + KC * (D + 1) + KC * D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + QT - 1) / QT, B * H);
  flash_fwd_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, H, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- bf16: tensor-core kernel

using bf16 = __nv_bfloat16;

constexpr int MMA_WARPS = 4;
constexpr int BM = 16 * MMA_WARPS;  // query rows per block: 16 per warp
constexpr int BN = 64;              // keys per K / V tile
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy from global to shared memory; with `valid`
// false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and receives row (l / 4), elements 2 (l % 4) and + 1 of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// The same, transposed: lane l receives rows 2 (l % 4) and + 1, column l / 4.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a b for one m16n8k16 tile: bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to nearest-even bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

template <int D>
constexpr size_t mma_smem_bytes() {
  // q [BM][D + 8], then two stages each of K and V [BN][D + 8].
  return sizeof(bf16) * (BM + 4 * BN) * (D + 8);
}

// Fragment layouts (m16n8k16, per lane: g = lane / 4, t = lane % 4): an
// accumulator tile holds rows g (elements 0, 1) and g + 8 (2, 3), columns
// 2t and 2t + 1; an A fragment holds rows g, g + 8 and columns 2t, 2t + 1,
// 2t + 8, 2t + 9 of its 16 x 16 tile. Blocks per SM asked of
// __launch_bounds__: at D <= 64 four (16 warps), which holds ptxas to 128
// registers a thread; at D = 128 shared memory (87 KB a block) allows two,
// and a register cap would spill.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, (D <= 64 ? 4 : 1))
    flash_fwd_mma_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, bf16* __restrict__ out,
        float* __restrict__ lse, int S, int H, long long qsb, long long qss,
        long long qsh, long long ksb, long long kss, long long ksh,
        long long vsb, long long vss, long long vsh, float scale, int causal) {
  constexpr int LD = D + 8;      // padded row, in elements (16 bytes more)
  constexpr int CPR = D / 8;     // 16-byte chunks per row
  constexpr int KSTEPS = D / 16;  // k-steps of Q K^T
  constexpr int NT = BN / 8;     // 8-key accumulator tiles of S
  constexpr int DT = D / 8;      // 8-wide accumulator tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]
  bf16* k_s = q_s + BM * LD;                      // [2][BN][LD]
  bf16* v_s = k_s + 2 * BN * LD;                  // [2][BN][LD]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int i0 = qt * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;

  const int k_end = causal ? min(S, i0 + BM) : S;
  const int n_tiles = (k_end + BN - 1) / BN;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * BN;
    bf16* ks = k_s + stage * BN * LD;
    bf16* vs = v_s + stage * BN * LD;
#pragma unroll
    for (int c = tid; c < BN * CPR; c += MMA_THREADS) {
      const int r = c / CPR, col = (c % CPR) * 8, j = k0 + r;
      const bool valid = j < S;
      const long long jr = valid ? j : 0;
      cp_async16(ks + r * LD + col, kb + jr * kss + col, valid);
      cp_async16(vs + r * LD + col, vb + jr * vss + col, valid);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  // q, prescaled and rounded to bf16 as it is staged (rows past S: zeros).
#pragma unroll
  for (int c = tid; c < BM * CPR; c += MMA_THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8, i = i0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (i < S)
      raw = __ldg(reinterpret_cast<const uint4*>(qb + i * qss + col));
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int x = 0; x < 8; ++x)
      e[x] = __float2bfloat16(__bfloat162float(e[x]) * scale);
    *reinterpret_cast<uint4*>(q_s + r * LD + col) = raw;
  }
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk],
                q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row0 = i0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_kv(tile + 1, (tile + 1) & 1);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const bf16* ks = k_s + (tile & 1) * BN * LD;
    const bf16* vs = v_s + (tile & 1) * BN * LD;

    // S = Q K^T: 16 rows x 64 keys per warp.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int jn = 0; jn < NT / 2; ++jn) {
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + (jn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jn], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jn + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // Only tiles that reach past the block's first row (the causal
    // diagonal) or past S are masked: a masked score becomes -inf, and
    // since every row's max is finite from the first tile on (key 0 is
    // visible to every row), its P is exp2(-inf) = 0 exactly.
    const int k0 = tile * BN;
    if ((causal && k0 + BN > i0 + 1) || k0 + BN > S) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * t4 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= S || (causal && key > row)) s[j][e] = -INFINITY;
        }
    }

    // Online softmax on the accumulator fragments: P = exp2(s log2(e) -
    // m log2(e)), one FFMA and one MUFU.EX2 per element.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f((m[r] - mx[r]) * LOG2E);
      m[r] = mx[r];
      ms[r] = mx[r] * LOG2E;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[j][e], LOG2E, -ms[e >> 1]));
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 in registers as the A fragment.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (kk * 16 + (lane & 15)) * LD + jd * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(o[2 * jd], pa, vf[0], vf[1]);
        mma_bf16(o[2 * jd + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // Epilogue: l summed across the quad, O / l rounded to bf16, staged in
  // this warp's own rows of q_s (read into registers before the loop).
  float safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    safe[r] = l[r] == 0.f ? 1.f : l[r];
  }
  bf16* os = q_s + warp * 16 * LD;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(os + g * LD + col) =
        __floats2bfloat162_rn(o[d][0] / safe[0], o[d][1] / safe[0]);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * LD + col) =
        __floats2bfloat162_rn(o[d][2] / safe[1], o[d][3] / safe[1]);
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, col = (c % CPR) * 8, i = i0 + warp * 16 + r;
    if (i < S)
      *reinterpret_cast<uint4*>(out + (((size_t)b * S + i) * H + h) * D + col) =
          *reinterpret_cast<const uint4*>(os + r * LD + col);
  }
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r;
      if (i < S) lse[(size_t)bh * S + i] = m[r] + logf(safe[r]);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int H, const long long* st,
               float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (S + BM - 1) / BM);
  flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, H, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// Typed dispatch of one launch; k and v start k_off and v_off elements past
// their pointers (the packed layout's column offsets E and 2E, or 0). The
// dtype picks the kernel: f32 keeps full f32 math on the CUDA cores, bf16
// runs on the tensor cores, for the head_dims it is instantiated for (the
// wrappers refuse the others before launching).
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
    return launch_f32(q, base_k, base_v, out, l, B, S, H, D, st, scale,
                      causal, s);
  }
  if (dtype == 1) {
    const bf16* base_k = static_cast<const bf16*>(k) + k_off;
    const bf16* base_v = static_cast<const bf16*>(v) + v_off;
    switch (D) {
      case 32:
        return launch_mma<32>(q, base_k, base_v, out, l, B, S, H, st, scale,
                              causal, s);
      case 64:
        return launch_mma<64>(q, base_k, base_v, out, l, B, S, H, st, scale,
                              causal, s);
      case 128:
        return launch_mma<128>(q, base_k, base_v, out, l, B, S, H, st, scale,
                               causal, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (head_dim 32, 64 or 128). q, k, v:
// [B, S, H, D] with element strides (batch, seq, head) each and a unit
// last-dim stride; q is prescaled by `scale` in-kernel; out is contiguous
// [B, S, H, D]; lse is [B*H, S] f32. Returns cudaGetLastError().
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
