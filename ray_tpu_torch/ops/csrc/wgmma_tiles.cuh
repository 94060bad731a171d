// The warpgroup tile machinery of the Hopper attention kernels: TMA loads of
// q, k and v tiles into shared memory, a ring of key tiles fed by a
// producer warpgroup through mbarriers, S = Q K^T and O += P V on wgmma,
// and the softmax pieces on wgmma's fragment layout. The profiling kernels
// attn_dissect.cu (K8), attn_slim.cu (K9) and attn_subtile.cu (K10) are
// built from it; the others still use attn_tiles.cuh's mma.sync machinery.
//
// Operands are contiguous [heads][rows][D] bf16 with D in {32, 64}. Each is
// read through a 3-D tensor map (make_rows_map) whose box is a tile of whole
// D-wide rows of one head: rows at or past the head's length come in as
// zeros, never as the next head's rows. A row is 2 D bytes, so the tiles
// land 128-byte swizzled at D = 64 and 64-byte swizzled at D = 32, which is
// the canonical wgmma layout of both operand orders: K-major (q and k rows,
// the A and B of Q K^T) and MN-major (v rows, the B of P V, read with the
// transpose bit set).
//
// Roles in a block: warpgroups of 64 query rows consume; one more
// warpgroup produces, one thread of it issuing every copy. setmaxnreg hands
// the producer's registers to the consumers (PRODUCER_REGS, CONSUMER_REGS:
// two consumer warpgroups and a producer fill the register file), and the
// roles branch on a warpgroup index that the compiler knows to be uniform
// (warpgroup_index), so that no wgmma sits on a path it counts as divergent
// (ptxas would serialise every wgmma there). The producer loads q once per
// head (its own barrier) and then every key tile the block's passes sweep,
// in order, into a ring of STAGES stages, waiting on each stage's `empty`
// barrier (one arrival per consumer warp) before refilling it; the
// consumers wait on `full` (the producer's expected bytes, completed by the
// copies). Every consumer warpgroup walks the whole sequence; one that
// needs fewer tiles than the block (a shorter causal or chunk edge, or rows
// past the end) waits for and releases the rest untouched.
//
// Fragment layout of an m64nNk16 f32 accumulator (N / 2 values a thread):
// warp w of the warpgroup holds rows 16 w + g and 16 w + g + 8 (g = lane /
// 4); value 4 i + e lies in row 16 w + g + 8 (e / 2), column 8 i + 2 (lane %
// 4) + e % 2. That is mma.sync's m16n8 accumulator N / 8 times over, so a
// row's max and sum reduce over the quad that holds it, and the values of
// columns 16 j .. 16 j + 15 are, rounded to bf16 in pairs, the register A
// fragment of k-slice j of P V.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver's encoder is looked up at run time

#include "mma_common.cuh"

namespace rtt {

constexpr int WG_THREADS = 128;  // a warpgroup: four warps
// Registers a thread of two consumer warpgroups and of the producer
// warpgroup: 2 x 128 x 232 + 128 x 40 = 64512 of the SM's 65536.
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

// This thread's warpgroup, as a value the compiler knows every thread of a
// warp shares (a branch on it is not divergent).
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / WG_THREADS,
                     0);
}
// Shrink (producer) or grow (consumers) this warpgroup's registers; every
// thread of the warpgroup executes it.
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---------------------------------------------------------------- barriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// The barriers' initialisation visible to the copy engine (the async proxy)
// before any copy completes on them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` more of copies to complete.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// Wait until the barrier's phase of this parity has completed (a fresh
// barrier counts its phase of parity 1 as complete).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------- TMA

// Copy the box at (c0, c1, c2) (innermost first) of a 3-D tensor map into
// shared memory; the bytes complete on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers in place: the compiler may not move a read of them above,
// or a write below, this point (a wgmma writes its accumulator behind the
// compiler's back between its issue and the wait that lands it).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// The shared-memory matrix descriptor of a tile of D-wide bf16 rows as TMA
// lays it out (make_rows_map): 128-byte swizzle at D = 64, 64-byte at D =
// 32, groups of 8 rows 16 D bytes apart. The tile starts on a 1024-byte
// boundary or a whole number of 8-row groups past one. The leading offset
// is unused: one swizzle row spans a k-step's 16 columns (K-major) and all
// D columns (MN-major).
template <int D>
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  static_assert(D == 32 || D == 64, "tiles of 32 or 64 bf16 columns");
  constexpr uint64_t SWIZZLE = D == 64 ? 1 : 2;  // 128-byte, 64-byte
  constexpr uint64_t GROUP = 8 * 2 * D;          // bytes between 8-row groups
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         ((GROUP >> 4) << 32) | (SWIZZLE << 62);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

// d (+)= A B^T, m64n128k16: A and B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B^T, m64n64k16: A and B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16: A in registers, B MN-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, m64n32k16: A in registers, B MN-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S = Q K^T of a warpgroup's 64 query rows (q_wg) against a tile of BN keys:
// D / 16 k-steps of 32 bytes each along both operands' rows; the first
// overwrites S. The caller fences before and commits after.
template <int D, int BN>
__device__ __forceinline__ void wg_qk(float (&s)[BN / 2], const bf16* q_wg,
                                      const bf16* k_tile) {
  const uint64_t dq = smem_desc<D>(q_wg), dk = smem_desc<D>(k_tile);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BN>(s, dq + 2 * kk, dk + 2 * kk, kk);
}

// O += P V of a warpgroup's 64 rows: P's k-slices in registers, V's tile of
// BN keys MN-major (16 keys, 32 D bytes, a k-step). The caller fences
// before and commits after.
template <int D, int BN>
__device__ __forceinline__ void wg_pv(float (&o)[D / 2],
                                      const uint32_t (&p)[BN / 16][4],
                                      const bf16* v_tile) {
  const uint64_t dv = smem_desc<D>(v_tile);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<D>(o, p[kk], dv + kk * 2 * D);
}

// ---------------------------------------------------------------- fragments

// Scores set to `value` where the key lies past its row (causal), on an
// accumulator fragment of keys k0 .. k0 + N - 1; row0 is this thread's
// first row (its second is row0 + 8). Keys past the operand's end are past
// every row, so this masks the zeros TMA filled them with as well.
template <int N>
__device__ __forceinline__ void frag_mask(float (&s)[N / 2], int k0, int row0,
                                          float value) {
  const int key0 = k0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key0 + 8 * i + (e & 1) > row0 + 8 * (e >> 1)) s[4 * i + e] = value;
}

// The running max of this thread's two rows over one fragment, reduced
// across the quad that holds each row.
template <int N>
__device__ __forceinline__ void frag_row_max(float (&m)[2],
                                             const float (&s)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    m[0] = fmaxf(m[0], fmaxf(s[4 * i], s[4 * i + 1]));
    m[1] = fmaxf(m[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
}

// p = exp(s - m) in place as exp2(s log2(e) - m log2(e)) (one FFMA and one
// MUFU.EX2, as attn_tiles.cuh's exp_rows), and this thread's part of each
// row's sum.
template <int N>
__device__ __forceinline__ void frag_exp_rows(float (&s)[N / 2],
                                              const float (&m)[2],
                                              float (&rs)[2]) {
  const float ms[2] = {m[0] * LOG2E, m[1] * LOG2E};
  rs[0] = rs[1] = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2f(fmaf(s[i], LOG2E, -ms[r]));
    rs[r] += s[i];
  }
}

// s = s - a (SUB) or s * a, with a per row.
template <int N, bool SUB>
__device__ __forceinline__ void frag_rows_op(float (&s)[N / 2],
                                             const float (&a)[2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = SUB ? s[i] - a[r] : s[i] * a[r];
  }
}

// P rounded to nearest-even bf16 in pairs as the register A fragments of
// P V's k-slices (16 keys each).
template <int N>
__device__ __forceinline__ void frag_pack(uint32_t (&p)[N / 16][4],
                                          const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const float* c = s + 8 * kk;
    p[kk][0] = pack_bf16(c[0], c[1]);
    p[kk][1] = pack_bf16(c[2], c[3]);
    p[kk][2] = pack_bf16(c[4], c[5]);
    p[kk][3] = pack_bf16(c[6], c[7]);
  }
}

// Each row's sum l, reduced across the quad that holds it; 0 (a row that
// saw no key) becomes 1, so O / l and log(l) stay finite.
__device__ __forceinline__ void frag_finish_sums(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if (l[r] == 0.f) l[r] = 1.f;
  }
}

// Epilogue: O / div of this thread's two rows (row0, row0 + 8) rounded to
// bf16 into one head's [n_rows][D] rows, two columns a store; rows at or
// past n_rows are not written.
template <int D>
__device__ __forceinline__ void store_o_frag(bf16* o_head, int row0,
                                             int n_rows,
                                             const float (&o)[D / 2],
                                             const float (&div)[2]) {
  const int col0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(o_head + (size_t)row * D + 8 * i +
                                         col0) =
          __floats2bfloat162_rn(o[4 * i + 2 * r] / div[r],
                                o[4 * i + 2 * r + 1] / div[r]);
  }
}

// lse = m + log(l) of this thread's two rows into one head's [n_rows] lse,
// by the first thread of each quad; rows at or past n_rows are not written.
__device__ __forceinline__ void store_lse_frag(float* lse_head, int row0,
                                               int n_rows, const float (&m)[2],
                                               const float (&l)[2]) {
  if (threadIdx.x & 3) return;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (row0 + 8 * r < n_rows) lse_head[row0 + 8 * r] = m[r] + logf(l[r]);
}

// ---------------------------------------------------------------- the grid

// A block's (head, query tile) on a one-dimensional grid of n_heads x n_qt
// blocks. Blocks start in index order, so the order below is the order the
// card takes them in: HEAD_GROUP heads at a time, every query tile of the
// group before the next group, so that the group's K and V (each head's
// read once per query tile) stay in L2 while its tiles run; within a group,
// from the last query tile to the first when `heaviest_first` (causal work,
// the longest blocks started first). With the heads walked fastest over the
// whole grid instead, each head's query tiles ran a wave apart, K and V
// were read from device memory once per tile, and level 0 of K8 took 0.238
// ms at B24 S1024 H12 D64 against 0.123 at the same work in 18 heads of
// S4096, whose K and V fit in L2 (PERF.md §6).
constexpr int HEAD_GROUP = 16;

struct BlockTile {
  int head, qt;
};

__device__ __forceinline__ BlockTile block_tile(int n_heads, int n_qt,
                                                bool heaviest_first) {
  const int per_group = HEAD_GROUP * n_qt;
  const int g = blockIdx.x / per_group, r = blockIdx.x % per_group;
  const int heads = min(HEAD_GROUP, n_heads - g * HEAD_GROUP);
  const int t = r / heads;
  return {g * HEAD_GROUP + r % heads, heaviest_first ? n_qt - 1 - t : t};
}

// ---------------------------------------------------------------- the ring

// Shared memory of a block: QBUFS q tiles of BM rows, STAGES stages each of
// a K and a V tile of BN rows (every tile on a 1024-byte boundary, as the
// swizzle needs), then the barriers. BYTES includes the slack to align the
// dynamic allocation's start.
template <int BM, int BN, int D, int STAGES, int QBUFS>
struct WgSmem {
  static constexpr unsigned Q_BYTES = BM * D * 2, TILE_BYTES = BN * D * 2;
  static_assert(Q_BYTES % 1024 == 0 && TILE_BYTES % 1024 == 0,
                "tiles of whole swizzle atoms");
  static constexpr size_t BYTES = 1024 + QBUFS * Q_BYTES +
                                  2 * STAGES * TILE_BYTES +
                                  8 * (2 * STAGES + QBUFS);
  bf16* q;          // [QBUFS][BM][D]
  bf16* k;          // [STAGES][BN][D]
  bf16* v;          // [STAGES][BN][D]
  uint64_t* full;   // [STAGES]: the producer's arrival and the copies' bytes
  uint64_t* empty;  // [STAGES]: one arrival per consumer warp
  uint64_t* q_full;  // [QBUFS]

  __device__ explicit WgSmem(unsigned char* raw) {
    unsigned char* p = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    q = reinterpret_cast<bf16*>(p);
    k = q + QBUFS * BM * D;
    v = k + STAGES * BN * D;
    full = reinterpret_cast<uint64_t*>(v + STAGES * BN * D);
    empty = full + STAGES;
    q_full = empty + STAGES;
  }
  // By one thread, before the block's __syncthreads().
  __device__ void init(unsigned consumer_warps) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
    for (int b = 0; b < QBUFS; ++b) mbar_init(&q_full[b], 1);
    mbar_fence_init();
  }
};

// The ring's stages as a sequence: the block's it-th tile load goes into
// stage it % STAGES in round it / STAGES, and each barrier completes one
// phase a round.
template <int STAGES>
struct TileRing {
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ void wait_full(int it) const {
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
  }
  __device__ __forceinline__ void wait_empty(int it) const {
    mbar_wait(&empty[it % STAGES], ((it / STAGES) & 1) ^ 1);
  }
  // A consumer warp is done with tile `it`.
  __device__ __forceinline__ void release(int it) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[it % STAGES]);
  }
};

// The producer's side (one thread): rows row0 .. row0 + BM - 1 of `head`'s
// q into q_s, completing on q_bar.
template <int BM, int D>
__device__ __forceinline__ void produce_q(const CUtensorMap* tq, bf16* q_s,
                                          uint64_t* q_bar, int row0, int head) {
  mbar_expect_tx(q_bar, BM * D * 2);
  tma_load_3d(q_s, tq, q_bar, 0, row0, head);
}

// The producer's side of one pass: key tiles 0 .. n_tiles - 1 of `head`
// (K, and V WITH_V) into the ring, each stage refilled once every consumer
// warp has released it. `it` advances by n_tiles.
template <int BN, int D, int STAGES>
__device__ __forceinline__ void produce_tiles(const TileRing<STAGES>& ring,
                                              int& it, const CUtensorMap* tk,
                                              const CUtensorMap* tv,
                                              bf16* k_s, bf16* v_s, int head,
                                              int n_tiles, bool with_v) {
  constexpr unsigned TILE = BN * D * 2;
  for (int j = 0; j < n_tiles; ++j, ++it) {
    const int st = it % STAGES;
    ring.wait_empty(it);
    mbar_expect_tx(&ring.full[st], with_v ? 2 * TILE : TILE);
    tma_load_3d(k_s + st * BN * D, tk, &ring.full[st], 0, j * BN, head);
    if (with_v)
      tma_load_3d(v_s + st * BN * D, tv, &ring.full[st], 0, j * BN, head);
  }
}

// A consumer warpgroup's side of a pass that reads K alone (a row's max or
// sum): S = Q K^T of its rows (q_wg) against key tiles 0 .. n_tiles - 1,
// and `body(j, s)` on each of the first n_mine, each stage released as soon
// as its product has landed. The other consumer warpgroup's products fill
// the tensor cores while body runs: with the next tile's product in flight
// over body instead, ptxas serialised every wgmma of the kernel (C7515,
// body writing one score fragment while the other's product ran) and K8
// and K10 ran ~10% slower (PERF.md §6). Tiles past n_mine are waited for
// and released untouched. `it` advances by n_tiles.
template <int D, int BN, int STAGES, typename Body>
__device__ __forceinline__ void sweep_scores(const TileRing<STAGES>& ring,
                                             int& it, int n_tiles, int n_mine,
                                             const bf16* q_wg,
                                             const bf16* k_s, Body&& body) {
  for (int j = 0; j < n_mine; ++j) {
    float s[BN / 2];
    ring.wait_full(it + j);
    fence_regs(s);
    wgmma_fence();
    wg_qk<D, BN>(s, q_wg, k_s + ((it + j) % STAGES) * BN * D);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    ring.release(it + j);
    body(j, s);
  }
  for (int j = n_mine; j < n_tiles; ++j) {
    ring.wait_full(it + j);
    ring.release(it + j);
  }
  it += n_tiles;
}

// A consumer warpgroup's side of a pass that reads K and V: for each of key
// tiles 0 .. n_mine - 1, S = Q K^T, `to_p(j, s)` turns the scores into P in
// place (f32), and O += bf16(P) V. FlashAttention-3's order: tile j's S
// and tile j - 1's P V are issued back to back (each after its own
// wgmma.fence), to_p runs on tile j while P V is in flight, and tile j -
// 1's stage is released when P V lands. Tiles past n_mine are waited for
// and released untouched. `it` advances by n_tiles.
template <int D, int BN, int STAGES, typename ToP>
__device__ __forceinline__ void sweep_attention(const TileRing<STAGES>& ring,
                                                int& it, int n_tiles,
                                                int n_mine, const bf16* q_wg,
                                                const bf16* k_s,
                                                const bf16* v_s,
                                                float (&o)[D / 2], ToP&& to_p) {
  uint32_t p[BN / 16][4];
  auto stage = [&](int j) { return ((it + j) % STAGES) * BN * D; };
  auto issue_pv = [&](int j) {
    fence_regs(p);
    fence_regs(o);
    wgmma_fence();
    wg_pv<D, BN>(o, p, v_s + stage(j));
    wgmma_commit();
  };
  for (int j = 0; j < n_mine; ++j) {
    float s[BN / 2];
    ring.wait_full(it + j);
    fence_regs(s);
    wgmma_fence();
    wg_qk<D, BN>(s, q_wg, k_s + stage(j));
    wgmma_commit();
    if (j > 0) {
      issue_pv(j - 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);
    to_p(j, s);
    if (j > 0) {
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      ring.release(it + j - 1);
    }
    frag_pack<BN>(p, s);
  }
  if (n_mine > 0) {
    issue_pv(n_mine - 1);
    wgmma_wait<0>();
    fence_regs(o);
    ring.release(it + n_mine - 1);
  }
  for (int j = n_mine; j < n_tiles; ++j) {
    ring.wait_full(it + j);
    ring.release(it + j);
  }
  it += n_tiles;
}

// ---------------------------------------------------------------- host

// A 3-D tensor map of contiguous [heads][rows][D] bf16 whose box is
// box_rows whole rows of one head, swizzled as smem_desc<D> reads it; rows
// past `rows` read as zeros. The driver's encoder is looked up once through
// the runtime (the libraries link no -lcuda). False if it is missing or
// refuses the map (a base not 16-byte aligned, say).
inline bool make_rows_map(CUtensorMap* map, const void* base, int heads,
                          int rows, int D, int box_rows) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(fn)
               : nullptr;
  }();
  if (encode == nullptr || (D != 32 && D != 64)) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opt a kernel into more than 48 KB of dynamic shared memory where needed.
template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rtt
