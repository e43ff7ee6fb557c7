// The tensor-core main loop of the port's dequant-matmuls, y = x @ w with
// w dequantized from a 32-row-group quantized plane, shared by q4_0
// (csrc/int4_matmul_tc.cu), q4_1 and q8_0 (csrc/lowbit_matmul_tc.cu).
// Each source instantiates it with a format trait and keeps its own C
// entries.
//
// Layout: the JAX package's k-major layout: x (M, K) bf16; q (K / R, N)
// bytes, R = Fmt::K_PER_BYTE K rows a byte (2 for the nibble formats,
// low nibble = row 2i, high = row 2i+1; 1 for q8_0); scale (and the
// q4_1 zero) (K/32, N) f32, or one (1, N) row shared by every group
// (a per-channel scale: the wrapper's row stride 0); out (M, N) bf16 or
// f32.
//
// What bounds it on the H100: the arithmetic at the shapes it serves.
// 2*M*N*K bf16 operations against at most one byte a weight: at M = 512
// that is ~1000 operations a byte, far above the ~295 where the tensor
// cores, not the memory, become the limit.
//
// Design (one BM x BN output tile per block, one warpgroup of 128
// threads per 64 rows; K walked in tiles of BK = 64 or 128 columns, two
// or four quantization groups). Three block shapes, picked by the
// wrapper from the shape (tc_block_shape in llm/kernels/int4_matmul.py):
// 128 x 128 for large products, 64 x 64 and 64 x 128 (two blocks a SM)
// so that a small product still spreads over the card:
// - staging: x tiles (BM x BK bf16), the q bytes (BK / R x BN), the
//   scales (and zeros) of each K tile go into a ring in shared memory by
//   TMA (one thread issues the copies of a stage and an mbarrier counts
//   their bytes); x lands in the 128-byte swizzled K-major layout `wgmma`
//   reads. Not cp.async: the proxy fence that makes the dequantized tile
//   visible to `wgmma` also waited for every cp.async still in flight,
//   so each K step took a memory latency (measured on the H100,
//   PERF.md); TMA writes through the async proxy and leaves that fence
//   nothing to wait for. The ring holds 384 columns of K ahead, fewer
//   where a 64-row block would no longer fit two a SM (Tile::STAGES);
// - dequant: the threads unpack 16-byte chunks of q (Fmt::dequant_chunk)
//   into exact bf16 integers (q - 8, q, or the int8 q), written into a
//   double-buffered B tile (BK x BN bf16) in the 128-byte swizzled
//   MN-major layout (N is contiguous in q, so B is read with the
//   transpose flag);
// - product: `wgmma.m64nBNk16` per warpgroup, both operands from shared
//   memory. Each 32-row quantization group g gives the f32 partial
//   P_g = sum_{k in g} x_k * q_k, its first k16 step issued with
//   scale-d = 0 (no zeroing); each group of a tile has its own partial
//   fragment, so a group's rescale runs while the later groups' products
//   are in flight. A format with a zero point (q4_1: w = s*q + z) also
//   needs each row's sum of x over the group, X_g = sum_{k in g} x_k: one
//   `wgmma.m64n8k16` a k16 step against a constant tile of bf16 ones
//   (the TPU kernel's (xe + xo) @ z_exp dot), which leaves X_g in f32 in
//   the accumulator layout, for the rows each thread rescales. The
//   epilogue of a group is acc = fma(P_g, s[g, n], acc), then
//   acc = fma(X_g, z[g, n], acc), in f32: the scale is never folded
//   into bf16 weights, the weights the tensor cores see are exact;
// - overlap: while the tensor cores run tile t, the threads dequantize
//   tile t + 1 into the other B buffer, and TMA brings the next tiles;
// - no split-K: an output element's sum runs over K in one fixed order,
//   whatever M, the other rows or the block shape are (a row gives the
//   same bits in any batch that takes this route). Ragged M and N edges
//   are zero-filled on load and masked on store. Every warpgroup issues
//   every product, also on rows past M and on a K tile's zero-filled
//   groups: a `wgmma` under a branch makes ptxas serialise all of them
//   (its C7520 warning), which costs more than the wasted products. So
//   does reading a partial while a `wgmma` of the next tile is in flight
//   (C7514): every group is rescaled in its own tile.
//
// A format trait gives: K_PER_BYTE (K rows of q a byte), ZERO (whether a
// zero plane and the row-sum product exist), PER_CHANNEL (false; true in
// its PerChannel<> variant, which stages the one scale / zero row of
// every K tile and rescales every group with it: TMA cannot describe the
// row stride 0) and dequant_chunk<BN, B_ATOM>(raw, b, r, ch), which
// unpacks the 16 bytes at q row r, chunk ch of BN / 16, of a stage into
// the B tile at b. launch_shape picks the variant from the row stride.
//
// Preconditions (checked by the Python wrappers): N % 16 == 0 (16-byte
// rows of q for TMA), K % 32 == 0, x and q contiguous, every tensor
// 16-byte aligned.
//
// The mbarrier, TMA and `wgmma` wrappers and the descriptors below also
// serve the tensor-core attention kernel (csrc/ragged_prefill_tc.cu):
// K-major B (transpose flag 0) for Q K^T, A from registers for P V, and
// TMA boxes of rank 4.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace tc {

// x is staged in boxes of 64 columns (128 bytes, the swizzle's width)
constexpr int XBOX = 64;
// dynamic shared memory a block may use and still fit two a SM: the
// SM's 228 KiB less two blocks' 1 KiB reserve, the mbarriers and slack
constexpr int SMEM_TWO_A_SM = 115648;
constexpr int SMEM_ONE_A_SM = 232448;   // the most one block may use
constexpr int ONES_BYTES = 1024;        // 8 x 64 bf16 ones, one atom

__host__ __device__ constexpr int cmin(int a, int b) {
  return a < b ? a : b;
}

// a format's per-channel variant: one (1, N) scale (and zero) row
template <class Fmt>
struct PerChannel : Fmt {
  static constexpr bool PER_CHANNEL = true;
};

template <class Fmt, int WG, int BN>
struct Tile {
  static constexpr int BM = 64 * WG, THREADS = 128 * WG;
  // K per tile: 64 (two groups), or 128 (four) for 64-column tiles, whose
  // four partial fragments fit the registers and halve the barriers
  static constexpr int BK = BN == 64 ? 128 : 64, G = BK / 32;
  static constexpr int COLS = BN, Q_ROWS = BK / Fmt::K_PER_BYTE;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int Q_BYTES = Q_ROWS * BN;
  static constexpr int S_BYTES = G * BN * 4;   // one plane's rows
  // rows of a plane staged a K tile, and the stride between groups' rows
  static constexpr int S_ROWS = Fmt::PER_CHANNEL ? 1 : G;
  static constexpr int S_STRIDE = Fmt::PER_CHANNEL ? 0 : BN;
  static constexpr int STAGE_BYTES =
      A_BYTES + Q_BYTES + S_BYTES * (Fmt::ZERO ? 2 : 1);
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int B_ATOM = BK * 128;   // one 64-column swizzle atom
  static constexpr int FIXED =
      2 * B_BYTES + (Fmt::ZERO ? ONES_BYTES : 0) + 1024;
  // the TMA ring: 384 columns of K ahead, or as many stages as fit two
  // 64-row blocks a SM (q4_0: 6 / 6 / 3 stages in 159 / 111 / 96 KiB for
  // 128 x 128 / 64 x 128 / 64 x 64; q8_0 64 x 128 gets 4, q4_1 5)
  static constexpr int STAGES = cmin(
      384 / BK, ((WG == 1 ? SMEM_TWO_A_SM : SMEM_ONE_A_SM) - FIXED) /
                    STAGE_BYTES);
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + FIXED;
  static constexpr int FRAG = BN / 2;   // f32 of a 64 x BN tile a thread
  static_assert(STAGES >= 2, "the ring needs two stages");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a 2-D tile of ``map`` at (c0 innermost, c1) into shared memory at dst
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// a 4-D tile of ``map`` at (c0 innermost, c1, c2, c3)
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, int c3,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
// generic-proxy writes (st.shared) made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D (64 x 128 f32, this thread's 64 values) = A * B (+ D if SCALE_D);
// A K-major, B MN-major (transpose flag 1), both bf16 in shared memory
template <int SCALE_D>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(SCALE_D));
}

// the same for a 64 x 64 tile (32 values a thread); TB = 0 reads B
// K-major (each of its 64 columns a row of K in shared memory)
template <int SCALE_D, int TB = 1>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(SCALE_D), "n"(TB));
}

// A from registers: D (64 x 64 f32) += A * B, A this thread's 8 bf16 of a
// 64 x 16 tile in the accumulator's row layout (a[0]: row lane / 4 of the
// warp's 16, columns 2 (lane % 4) + {0, 1}; a[1]: that row + 8; a[2],
// a[3]: the same rows, columns + 8), B MN-major in shared memory
template <int SCALE_D>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "n"(SCALE_D));
}

// the same for a 64 x 128 tile (64 values a thread)
template <int SCALE_D>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "n"(SCALE_D));
}

// the row sums: D (64 x 8 f32, 4 a thread) = A * ones (+ D if SCALE_D),
// B K-major (transpose flag 0): every column of D is the row's sum, in
// the rows of the wide products' fragments (d[0]: row lane / 4 of the
// warp's 16, d[2]: that row + 8)
template <int SCALE_D>
__device__ __forceinline__ void wgmma(float (&d)[4], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "n"(SCALE_D));
}

// one thread: TMA of K tile ``kt`` (x, q, scales and zeros) into the
// stage at ``st``, its bytes counted on the stage's mbarrier ``bar``.
// Rows and columns past the tensors' edges are zero-filled by the copy;
// a per-channel scale (and zero) is its one row, at every K tile.
template <class T, bool ZERO>
__device__ __forceinline__ void load_stage(uint32_t st, uint32_t bar,
                                           const CUtensorMap* tx,
                                           const CUtensorMap* tq,
                                           const CUtensorMap* ts,
                                           const CUtensorMap* tz, int m0,
                                           int n0, int kt) {
  constexpr int PLANE = T::S_ROWS * T::COLS * 4;   // S_ROWS x BN f32
  mbar_expect_tx(bar, T::A_BYTES + T::Q_BYTES + PLANE * (ZERO ? 2 : 1));
#pragma unroll
  for (int h = 0; h < T::BK / XBOX; ++h)
    tma_2d(st + h * T::BM * 128, tx, kt * T::BK + h * XBOX, m0, bar);
  tma_2d(st + T::A_BYTES, tq, n0, kt * T::Q_ROWS, bar);
  const int g0 = T::S_STRIDE ? kt * T::G : 0;
  tma_2d(st + T::A_BYTES + T::Q_BYTES, ts, n0, g0, bar);
  if constexpr (ZERO)
    tma_2d(st + T::A_BYTES + T::Q_BYTES + T::S_BYTES, tz, n0, g0, bar);
}

// 16 bytes (8 bf16) at 8-column chunk nc, k-row kr of the B tile at b,
// in the 128-byte swizzled MN-major layout
template <int B_ATOM>
__device__ __forceinline__ void put_b(uint8_t* b, int kr, int nc,
                                      uint4 v) {
  *reinterpret_cast<uint4*>(b + (nc / 8) * B_ATOM + kr * 128 +
                            (((nc % 8) ^ (kr & 7)) << 4)) = v;
}

// (128 + n, 128 + n') as a bf16 pair (the nibble becomes the bf16's
// mantissa by a byte permute), minus OFF: (n + 128 - OFF, ...) exactly
template <int OFF>
__device__ __forceinline__ uint32_t nibble_pair(uint32_t nib, uint32_t sel) {
  const uint32_t v = __byte_perm(nib, 0x43434343u, sel);
  __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
  b = __hsub2(b, __floats2bfloat162_rn((float)OFF, (float)OFF));
  return *reinterpret_cast<const uint32_t*>(&b);
}

// the nibble formats: unpack 16 bytes of the packed q of a stage at
// ``raw`` (packed row r, chunk ch of BN / 16) into two k-rows of the B
// tile at ``b``, each nibble n as the bf16 n + 128 - OFF
template <int OFF, int BN, int B_ATOM>
__device__ __forceinline__ void nibble_chunk(const uint8_t* raw, uint8_t* b,
                                             int r, int ch) {
  const uint4 v = *reinterpret_cast<const uint4*>(raw + r * BN + ch * 16);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t lo[8], hi[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t l = w[i] & 0x0F0F0F0Fu, h = (w[i] >> 4) & 0x0F0F0F0Fu;
    lo[2 * i] = nibble_pair<OFF>(l, 0x4140);
    lo[2 * i + 1] = nibble_pair<OFF>(l, 0x4342);
    hi[2 * i] = nibble_pair<OFF>(h, 0x4140);
    hi[2 * i + 1] = nibble_pair<OFF>(h, 0x4342);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int e = 0; e < 2; ++e) {          // k-row 2r (low) or 2r+1 (high)
      const uint32_t* src = e ? hi : lo;
      put_b<B_ATOM>(b, 2 * r + e, ch * 2 + half,
                    make_uint4(src[4 * half], src[4 * half + 1],
                               src[4 * half + 2], src[4 * half + 3]));
    }
}

// the whole stage's q (BK / K_PER_BYTE rows x BN / 16 chunks of 16 bytes)
template <class Fmt, class T, int BN>
__device__ __forceinline__ void dequant(const uint8_t* raw, uint8_t* b) {
  constexpr int CH = BN / 16;
#pragma unroll
  for (int c = threadIdx.x; c < T::Q_ROWS * CH; c += T::THREADS)
    Fmt::template dequant_chunk<BN, T::B_ATOM>(raw, b, c / CH, c % CH);
}

// acc += s[n] * p, then (with a zero point) acc += z[n] * xg[row], over
// this thread's fragment (columns 8c + 2(lane%4) + j; rows r0 and r0 + 8)
template <bool ZERO, int F>
__device__ __forceinline__ void rescale(float (&acc)[F], const float (&p)[F],
                                        const float (&xg)[4], const float* s,
                                        const float* z) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < F / 4; ++c) {
    const int col = 8 * c + 2 * (lane % 4);
    const float2 s2 = *reinterpret_cast<const float2*>(s + col);
    acc[4 * c + 0] = fmaf(p[4 * c + 0], s2.x, acc[4 * c + 0]);
    acc[4 * c + 1] = fmaf(p[4 * c + 1], s2.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(p[4 * c + 2], s2.x, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(p[4 * c + 3], s2.y, acc[4 * c + 3]);
    if constexpr (ZERO) {
      const float2 z2 = *reinterpret_cast<const float2*>(z + col);
      acc[4 * c + 0] = fmaf(xg[0], z2.x, acc[4 * c + 0]);
      acc[4 * c + 1] = fmaf(xg[0], z2.y, acc[4 * c + 1]);
      acc[4 * c + 2] = fmaf(xg[2], z2.x, acc[4 * c + 2]);
      acc[4 * c + 3] = fmaf(xg[2], z2.y, acc[4 * c + 3]);
    }
  }
}

// wait for the products of groups g.. of the tile (G - 1 - g commit
// groups may stay in flight) and fold each partial into acc in group
// order; a group past K (zero-filled) is skipped. Group g's scales are
// at sc + g * GS (GS = 0 for a per-channel scale), its zeros at the
// same offset from zc.
template <bool ZERO, int G, int GS, int g = 0, int F, int XG>
__device__ __forceinline__ void fold(float (&acc)[F], float (&p)[G][F],
                                     float (&xs)[XG][4], const float* sc,
                                     const float* zc, int groups_left) {
  if constexpr (g < G) {
    wgmma_wait<G - 1 - g>();
    if (g < groups_left)
      rescale<ZERO>(acc, p[g], xs[ZERO ? g : 0], sc + g * GS, zc + g * GS);
    fold<ZERO, G, GS, g + 1>(acc, p, xs, sc, zc, groups_left);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <class Fmt, int WG, int BN, typename OutT>
__global__ void __launch_bounds__(Tile<Fmt, WG, BN>::THREADS, 2 / WG)
tc_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_s,
               const __grid_constant__ CUtensorMap tm_z,
               OutT* __restrict__ out, int M, int K, int N) {
  using T = Tile<Fmt, WG, BN>;
  constexpr bool ZERO = Fmt::ZERO;
  constexpr int STAGES = T::STAGES, STAGE_BYTES = T::STAGE_BYTES,
                A_BYTES = T::A_BYTES, B_BYTES = T::B_BYTES, F = T::FRAG;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];   // a stage has landed
  // the swizzled tiles need 1024-byte alignment
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t pad = (1024u - (raw_addr & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + pad;
  const uint32_t base = raw_addr + pad;
  uint8_t* bbuf = smem + STAGES * STAGE_BYTES;
  // the row-sum product's B: bf16 ones after the two B buffers
  const uint32_t ones = base + STAGES * STAGE_BYTES + 2 * B_BYTES;

  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * BN;
  const int wg = threadIdx.x / 128;
  const int KT = (K + T::BK - 1) / T::BK;

  const uint32_t bar0 = smem_addr(full);
  const bool producer = threadIdx.x == 0;

  float acc[F], p[T::G][F], xs[ZERO ? T::G : 1][4];
#pragma unroll
  for (int i = 0; i < F; ++i) acc[i] = 0.f;

  if (producer) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    fence_async_smem();
  }
  if constexpr (ZERO)
    for (int i = threadIdx.x; i < ONES_BYTES / 4; i += T::THREADS)
      reinterpret_cast<uint32_t*>(bbuf + 2 * B_BYTES)[i] = 0x3F803F80u;
  __syncthreads();
  if (producer)
    for (int s = 0; s < STAGES && s < KT; ++s)
      load_stage<T, ZERO>(base + s * STAGE_BYTES, bar0 + 8 * s, &tm_x,
                          &tm_q, &tm_s, &tm_z, m0, n0, s);
  mbar_wait(bar0, 0);
  dequant<Fmt, T, BN>(smem + A_BYTES, bbuf);
  fence_async_smem();
  __syncthreads();

  for (int kt = 0; kt < KT; ++kt) {
    const int slot = kt % STAGES, buf = kt & 1;
    // this warpgroup's 64 rows of each 64-column box of x
    const uint32_t sa = base + slot * STAGE_BYTES + wg * 64 * 128;
    const uint32_t sb = base + STAGES * STAGE_BYTES + buf * B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int g = 0; g < T::G; ++g) {        // two k16 steps a group
      const int j = 2 * g;
      const uint32_t a0 = sa + (j / 4) * T::BM * 128 + (j % 4) * 32;
      wgmma<0>(p[g], desc(a0, 16, 1024),
               desc(sb + j * 16 * 128, T::B_ATOM, 1024));
      wgmma<1>(p[g], desc(a0 + 32, 16, 1024),
               desc(sb + (j + 1) * 16 * 128, T::B_ATOM, 1024));
      if constexpr (ZERO) {
        wgmma<0>(xs[g], desc(a0, 16, 1024), desc(ones, 16, 1024));
        wgmma<1>(xs[g], desc(a0 + 32, 16, 1024), desc(ones, 16, 1024));
      }
      wgmma_commit();
    }
    if (kt + 1 < KT) {
      const int s1 = (kt + 1) % STAGES;
      mbar_wait(bar0 + 8 * s1, ((kt + 1) / STAGES) & 1);
      dequant<Fmt, T, BN>(smem + s1 * STAGE_BYTES + A_BYTES,
                          bbuf + (buf ^ 1) * B_BYTES);
    }
    // group g's rescale runs while the later groups' products are in
    // flight; groups past K are zero-filled and skipped (block-uniform)
    const float* sc = reinterpret_cast<const float*>(
        smem + slot * STAGE_BYTES + A_BYTES + T::Q_BYTES);
    fold<ZERO, T::G, T::S_STRIDE>(acc, p, xs, sc, sc + T::S_BYTES / 4,
                                  (K - kt * T::BK) / 32);
    fence_async_smem();
    __syncthreads();
    // refill the stage tile kt used: every read of it is complete
    const int nk = kt + STAGES;
    if (producer && nk < KT)
      load_stage<T, ZERO>(base + (nk % STAGES) * STAGE_BYTES,
                          bar0 + 8 * (nk % STAGES), &tm_x, &tm_q, &tm_s,
                          &tm_z, m0, n0, nk);
  }

  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int c = 0; c < F / 4; ++c) {
    const int n = n0 + 8 * c + 2 * (lane % 4);
    if (n < N) {
      if (r0 < M)
        store2(out + (size_t)r0 * N + n, acc[4 * c], acc[4 * c + 1]);
      if (r0 + 8 < M)
        store2(out + (size_t)(r0 + 8) * N + n, acc[4 * c + 2],
               acc[4 * c + 3]);
    }
  }
}

// cuTensorMapEncodeTiled of libcuda, found through the CUDA runtime (no
// link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a tensor of ``rank`` dims (innermost first; strides in bytes of dims 1..)
// read in ``box`` tiles; out-of-range elements read as zero
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                       const void* base, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return encoder()(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims,
                   strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a row-major (outer, inner) tensor read in (box_outer, box_inner) tiles
inline bool tile_map(CUtensorMap* map, CUtensorMapDataType type,
                     const void* base, long long inner, long long outer,
                     long long row_bytes, int box_inner, int box_outer,
                     CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  return tensor_map(map, type, 2, base, dims, strides, box, swizzle);
}

// a contiguous (K/32, N) f32 plane, or its one row (per channel)
template <class T>
bool plane_map(CUtensorMap* map, const void* p, long long K, long long N) {
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p, N,
                  T::S_STRIDE ? K / 32 : 1, N * 4, T::COLS, T::S_ROWS,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
}

// returned when the tensors cannot be described for TMA
constexpr int TENSOR_MAP_FAILED = 10000;

template <class Fmt, int WG, int BN, typename OutT>
int launch(const void* x, const void* q, const void* scale, const void* zero,
           void* out, long long M, long long K, long long N, void* stream) {
  using T = Tile<Fmt, WG, BN>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        tc_gemm_kernel<Fmt, WG, BN, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap tx, tq, ts, tz;
  if (encoder() == nullptr ||
      !tile_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, K * 2, XBOX,
                T::BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tile_map(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N,
                K / Fmt::K_PER_BYTE, N, BN, T::Q_ROWS,
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !plane_map<T>(&ts, scale, K, N) ||
      (Fmt::ZERO && !plane_map<T>(&tz, zero, K, N)))
    return TENSOR_MAP_FAILED;
  if (!Fmt::ZERO) tz = ts;   // never read
  dim3 grid((unsigned)((M + T::BM - 1) / T::BM),
            (unsigned)((N + BN - 1) / BN));
  tc_gemm_kernel<Fmt, WG, BN, OutT>
      <<<grid, T::THREADS, T::SMEM_BYTES, (cudaStream_t)stream>>>(
          tx, tq, ts, tz, reinterpret_cast<OutT*>(out), (int)M, (int)K,
          (int)N);
  return (int)cudaGetLastError();
}

// the block shape (rows x cols of the output tile) picks the instance
template <class Fmt, typename OutT>
int launch_tile(const void* x, const void* q, const void* scale,
                const void* zero, void* out, long long M, long long K,
                long long N, long long rows, long long cols, void* stream) {
  if (rows == 128 && cols == 128)
    return launch<Fmt, 2, 128, OutT>(x, q, scale, zero, out, M, K, N,
                                     stream);
  if (rows == 64 && cols == 128)
    return launch<Fmt, 1, 128, OutT>(x, q, scale, zero, out, M, K, N,
                                     stream);
  if (rows == 64 && cols == 64)
    return launch<Fmt, 1, 64, OutT>(x, q, scale, zero, out, M, K, N, stream);
  return (int)cudaErrorInvalidValue;
}

// ... and the planes' row stride the variant: lds = N per group, 0 per
// channel
template <class Fmt, typename OutT>
int launch_shape(const void* x, const void* q, const void* scale,
                 const void* zero, void* out, long long M, long long K,
                 long long N, long long lds, long long rows, long long cols,
                 void* stream) {
  if (lds == N)
    return launch_tile<Fmt, OutT>(x, q, scale, zero, out, M, K, N, rows,
                                  cols, stream);
  if (lds == 0)
    return launch_tile<PerChannel<Fmt>, OutT>(x, q, scale, zero, out, M, K,
                                              N, rows, cols, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
