// Small-M dequant-matmul of the three block formats on the tensor cores:
// the split-K GEMV of every decode step (llm/kernels/int4_matmul.py,
// matmul_route "gemv": M < TC_MIN_M, or N % 16 != 0 at any M).
//   q4_0: y = x @ (scale * (q - 8)), q a nibble in [0, 15];
//   q4_1: y = x @ (scale * q + zero);
//   q8_0: y = x @ (scale * q), q an int8 in [-127, 127].
//
// Replaces: bigdl_tpu/llm/kernels/int4_matmul.py
//   int4_matmul (pl.pallas_call of _int4_kernel), asym_int4_matmul
//   (_asym_int4_kernel) and int8_matmul (_int8_kernel), at small M.
//
// Layout (the JAX package's k-major layout): x (M, K) bf16; q4: q (K/2, N)
// uint8, low nibble = row 2i, high nibble = row 2i+1; q8_0: q (K, N) int8;
// scale and zero (K/32, N) f32 with row stride ``lds`` (N, or 0 for one
// row shared by every group: nn.quantized's per-channel scale); out
// (M, N) bf16 or f32.
//
// What bounds it on the H100: the weight stream. At M <= 8 a q4 weight is
// 0.5 B of nibble and 4/32 B of scale for 2M operations, far below the
// card's ~295 operations a byte. The CUDA cores would not keep up either:
// a 7B step at M = 8 is ~53 G multiply-adds, ~1.6 ms at 67 TFLOP/s f32,
// above the ~1.2 ms its weights take at 3.35 TB/s.
//
// Design:
// - mma.sync m16n8k16 (bf16 in, f32 accumulate) with the operands
//   swapped: 16 output columns are the rows of A, 8 rows of x the columns
//   of B (rows past M read as zero). A block takes 8 rows of x; more rows
//   are more blocks (grid y), each element summed alike.
// - Staging by TMA: a warp owns 128 columns and a ring of 4 stages in
//   shared memory; lane 0 asks for one group a stage (its q rows of the
//   128 columns, 128 bytes a row, 128-byte swizzled; the 128 scales (and
//   zeros); the group's x), an mbarrier counts the bytes, and 3 groups
//   are in flight while one is multiplied. Each lane then reads 16
//   contiguous bytes (columns 16 c .. 16 c + 15) of 4 rows: exactly its A
//   fragments of 8 column tiles (tile j: columns 16 c + 2 j, A row g, and
//   16 c + 2 j + 1, A row g + 8; the chunk c of lane (g, t) is chosen so
//   that a quarter-warp's reads hit 8 bank groups). The sum over k is
//   free to pair any two k of one column in a register, so a register
//   pairs row kp and row kp + 4 of packed q: one byte permute, a shift
//   and a lop3 give bf16 128 + q, and a bf16 fma with -136 gives q - 8
//   exactly (-128 for q4_1's q; q8_0 goes through the f32 2^23 + byte
//   trick); B pairs the x of the same two k. TMA, not 16-byte cp.async
//   a lane: one request a stage keeps the stream in flight without a
//   load slot or a register a lane, and per-lane copies fell well short
//   of the HBM rate on the H100.
// - Per 32-row group g the f32 partial P_g = x_g @ (q_g - 8) of exact
//   products, then acc = fma(s_g, P_g, acc) in group order (the
//   tensor-core route's algebra); q4_1 adds fma(z_g, X_g, acc) with X_g
//   the group's row sums of x from one more mma against bf16 ones.
// - Split over K by a number of slices S chosen from (K, N) alone
//   (gemv_slices): 4 warps a block, one slice each, and a thread-block
//   cluster of S / 4 blocks along K. Each warp leaves its partial in
//   shared memory; after a cluster barrier every output is summed over
//   the slices 0..S-1 in order through distributed shared memory. One
//   kernel, no workspace, no atomics: an element's sum depends on K and N
//   only, never on M or on other rows (served alone == batched).
// - Any N: where TMA cannot describe the planes (N % 16 != 0, as BERT's
//   N = 2, 3, 770, or an unaligned plane) the lanes fill the same stages
//   themselves by byte loads, columns past N as zero. Same arithmetic,
//   same bits.

#include <cooperative_groups.h>

#include "tc_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

using tc::mbar_expect_tx;
using tc::mbar_init;
using tc::mbar_wait;
using tc::smem_addr;
using tc::tma_2d;

constexpr int WARPS = 4;              // warps a block: K slices
constexpr int THREADS = 32 * WARPS;
constexpr int WN = 128;               // output columns a warp (and block)
constexpr int MR = 8;                 // rows of x a block: the mma's n8
constexpr int MAX_CLUSTER = 8;        // blocks a cluster (portable size)
constexpr int STAGES = 4;             // a warp's ring: 3 groups in flight

enum class Fmt { Q4_0, Q4_1, Q8_0 };

// One group's operands of one warp in shared memory, as TMA lands them
// (a stage of the warp's ring): the q rows of the group (16 packed rows
// for q4, 32 rows for q8_0) of the warp's 128 columns, 128 bytes a row in
// the 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)); the 128
// scales (and zeros); 8 rows of the group's 32 x, 64 bytes a row.
template <Fmt F>
struct Stage {
  static constexpr int Q_ROWS = F == Fmt::Q8_0 ? 32 : 16;
  static constexpr int LOADS = Q_ROWS / 4;   // 16-byte chunks a lane
  static constexpr int S = Q_ROWS * 128;
  static constexpr int Z = S + WN * 4;
  static constexpr int X = Z + (F == Fmt::Q4_1 ? WN * 4 : 0);
  static constexpr int TX = X + MR * 64;     // bytes TMA brings a stage
  static constexpr int BYTES = (TX + 1023) / 1024 * 1024;
  static constexpr int RING = STAGES * BYTES;
  static constexpr int SMEM = WARPS * RING + 1024;   // + alignment
};

constexpr uint32_t BF16_128 = 0x43004300u;  // bf16 pair (128, 128)
constexpr uint32_t BF16_ONES = 0x3F803F80u;
constexpr uint32_t NIBBLES = 0x000F000Fu;

// (a & b) | c in one lop3 (the compiler splits it when b and c are both
// immediates)
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the cluster's barrier: the partials written before it are seen after
// it (release / acquire); the second one only waits for every block's
// reads, which completed when their sums were stored (relaxed)
__device__ __forceinline__ void cluster_sync_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
               "barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// byte ``sel`` of w (already ^ 0x80) as the f32 2^23 + byte, minus
// 2^23 + 128: the signed byte, exactly
__device__ __forceinline__ float byte_f32(uint32_t w, uint32_t sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | sel)) -
         8388736.f;
}

// two f32 integers of at most 8 bits as a bf16 pair: their high halves
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632u);
}

// The 16-byte column chunk (of the warp's 8) that lanes (g, *) own: the
// two g of a quarter-warp 4 chunks apart, so that their reads of 4
// swizzled rows hit 8 distinct bank groups
__device__ __forceinline__ int chunk_of(int g) {
  return ((g & 1) << 2) | (g >> 1);
}

// stage row of the lane's 16-byte weight chunk i: q4 packed rows
// kb + t and kb + t + 4 of k16 step i / 2; q8_0 rows kb + 2t, +1, +8, +9
// of step i / 4
template <Fmt F>
__device__ __forceinline__ int q_row(int i, int t) {
  if constexpr (F == Fmt::Q8_0)
    return (i / 4) * 16 + 2 * t + (i % 2) + ((i / 2) % 2) * 8;
  else
    return (i / 2) * 8 + t + (i % 2) * 4;
}

// What one lane reads of a landed stage: its weight chunks, its 16
// columns' scales (and zeros), its x words (B fragments before pairing).
template <Fmt F>
struct Group {
  uint4 q[Stage<F>::LOADS];
  float4 s[4];
  float4 z[4];
  uint32_t x[4];
};

template <Fmt F>
__device__ __forceinline__ void read_stage(Group<F>& gr, const uint8_t* st,
                                           int cg, int g, int t) {
  using L = Stage<F>;
#pragma unroll
  for (int i = 0; i < L::LOADS; ++i) {
    const int r = q_row<F>(i, t);
    gr.q[i] = *reinterpret_cast<const uint4*>(st + r * 128 +
                                              ((cg ^ (r & 7)) * 16));
  }
  const float4* s4 = reinterpret_cast<const float4*>(st + L::S) + 4 * cg;
  const float4* z4 = reinterpret_cast<const float4*>(st + L::Z) + 4 * cg;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    gr.s[j] = s4[j];
    if constexpr (F == Fmt::Q4_1) gr.z[j] = z4[j];
  }
  // x words of the lane's B fragments, two k16 steps: q4 pairs k and
  // k + 8 (the bf16 of packed rows kp and kp + 4), q8_0 k and k + 1
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(st + L::X);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    gr.x[i] = xw[g * 16 + (i / 2) * 8 + t + (i % 2) * 4];
}

// The same stage filled by the lanes themselves, for the planes TMA
// cannot describe (N % 16 != 0, or unaligned): loads by byte, columns
// past N and rows past M as zeros
template <Fmt F>
__device__ __forceinline__ void fill_stage(
    uint8_t* st, int grp, const uint8_t* __restrict__ q,
    const float* __restrict__ scale, const float* __restrict__ zero,
    const __nv_bfloat16* __restrict__ x, int m0, int M, int K, int col0,
    int N, int lds, int cg, int g, int t) {
  using L = Stage<F>;
#pragma unroll 1
  for (int i = 0; i < L::LOADS; ++i) {
    const int r = q_row<F>(i, t);
    const uint8_t* p = q + (size_t)(grp * L::Q_ROWS + r) * N + col0;
    uint32_t w[4] = {0, 0, 0, 0};
    for (int c = 0; c < 16; ++c)
      if (col0 + c < N) w[c / 4] |= (uint32_t)__ldg(p + c) << (8 * (c % 4));
    *reinterpret_cast<uint4*>(st + r * 128 + ((cg ^ (r & 7)) * 16)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  const int c4 = col0 + 4 * t;       // this lane's 4 of the 16 columns
#pragma unroll
  for (int h = 0; h < (F == Fmt::Q4_1 ? 2 : 1); ++h) {
    const float* src = (h ? zero : scale) + (size_t)grp * lds + c4;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = c4 + c < N ? __ldg(src + c) : 0.f;
    *reinterpret_cast<float4*>(st + (h ? L::Z : L::S) + (16 * cg + 4 * t) * 4) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
  const uint4 xv = m0 + g < M ? __ldg(reinterpret_cast<const uint4*>(
                                    x + (size_t)(m0 + g) * K + grp * 32) + t)
                              : make_uint4(0, 0, 0, 0);
  *reinterpret_cast<uint4*>(st + L::X + g * 64 + 16 * t) = xv;
}

// A fragments of column tile j at k16 step st: a[0] / a[2] column
// 16 g + 2 j (A row g), a[1] / a[3] column 16 g + 2 j + 1 (A row g + 8);
// a[0] / a[1] hold the B fragment b0's two k, a[2] / a[3] b1's
template <Fmt F>
__device__ __forceinline__ void a_frag(const Group<F>& gr, int st, int j,
                                       uint32_t a[4]) {
  const uint32_t sel = (j % 2) ? 0x7632u : 0x5410u;
  if constexpr (F == Fmt::Q8_0) {
    // rows (kb + 2t, kb + 2t + 1) pair for b0, (+8, +9) for b1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t r0 = word(gr.q[4 * st + 2 * h], j / 2) ^ 0x80808080u;
      const uint32_t r1 =
          word(gr.q[4 * st + 2 * h + 1], j / 2) ^ 0x80808080u;
      const uint32_t b = (j % 2) * 2;        // byte of column 2j in a word
      a[2 * h] = bf16_pair(byte_f32(r0, b), byte_f32(r1, b));
      a[2 * h + 1] = bf16_pair(byte_f32(r0, b + 1), byte_f32(r1, b + 1));
    }
  } else {
    // r = [row kp col 2j, row kp col 2j+1, row kp+4 col 2j, ... col 2j+1]
    const uint32_t r = __byte_perm(word(gr.q[2 * st], j / 2),
                                   word(gr.q[2 * st + 1], j / 2), sel);
    a[0] = and_or(r, NIBBLES, BF16_128);         // low nibbles: k = 2 kp
    a[2] = and_or(r >> 4, NIBBLES, BF16_128);    // high: k = 2 kp + 1
    a[1] = and_or(r >> 8, NIBBLES, BF16_128);
    a[3] = and_or(r >> 12, NIBBLES, BF16_128);
    // bf16 (128 + q) * 1 - 136 (q4_0) or - 128 (q4_1): exact
    const uint32_t bias = F == Fmt::Q4_0 ? 0xC308C308u : 0xC300C300u;
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = bf16x2_fma(a[i], BF16_ONES, bias);
  }
}

// B fragments of k16 step st from the lane's x words
template <Fmt F>
__device__ __forceinline__ void b_frag(const Group<F>& gr, int st,
                                       uint32_t& b0, uint32_t& b1) {
  const uint32_t u = gr.x[2 * st], v = gr.x[2 * st + 1];
  if constexpr (F == Fmt::Q8_0) {
    b0 = u, b1 = v;                        // (k, k + 1) and (k + 8, k + 9)
  } else {
    b0 = __byte_perm(u, v, 0x5410u);       // x[2 kp], x[2 (kp + 4)]
    b1 = __byte_perm(u, v, 0x7632u);       // x[2 kp + 1], x[2 kp + 9]
  }
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <Fmt F>
__device__ __forceinline__ void mma_group(const Group<F>& gr,
                                          float acc[8][4]) {
  uint32_t b[2][2];
#pragma unroll
  for (int st = 0; st < 2; ++st) b_frag<F>(gr, st, b[st][0], b[st][1]);
  float xs[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (F == Fmt::Q4_1) {
    const uint32_t ones[4] = {BF16_ONES, BF16_ONES, BF16_ONES, BF16_ONES};
#pragma unroll
    for (int st = 0; st < 2; ++st) mma(xs, ones, b[st][0], b[st][1]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      uint32_t a[4];
      a_frag<F>(gr, st, j, a);
      mma(p, a, b[st][0], b[st][1]);
    }
    // p: (column 2j, rows 2t, 2t+1), (column 2j+1, rows 2t, 2t+1)
    const float s0 = comp(gr.s[j / 2], (j % 2) * 2);
    const float s1 = comp(gr.s[j / 2], (j % 2) * 2 + 1);
    acc[j][0] = fmaf(s0, p[0], acc[j][0]);
    acc[j][1] = fmaf(s0, p[1], acc[j][1]);
    acc[j][2] = fmaf(s1, p[2], acc[j][2]);
    acc[j][3] = fmaf(s1, p[3], acc[j][3]);
    if constexpr (F == Fmt::Q4_1) {
      const float z0 = comp(gr.z[j / 2], (j % 2) * 2);
      const float z1 = comp(gr.z[j / 2], (j % 2) * 2 + 1);
      acc[j][0] = fmaf(z0, xs[0], acc[j][0]);
      acc[j][1] = fmaf(z0, xs[1], acc[j][1]);
      acc[j][2] = fmaf(z1, xs[0], acc[j][2]);
      acc[j][3] = fmaf(z1, xs[1], acc[j][3]);
    }
  }
}

template <Fmt F, typename OutT, bool TMA>
// three blocks a SM for q4_0 (168 registers), two for the others
__global__ void __launch_bounds__(THREADS, F == Fmt::Q4_0 ? 3 : 2)
lowbit_gemv_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_s,
                   const __grid_constant__ CUtensorMap tm_z,
                   const __grid_constant__ CUtensorMap tm_x,
                   const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ q,
                   const float* __restrict__ scale,
                   const float* __restrict__ zero, OutT* __restrict__ out,
                   int M, int K, int N, int lds) {
  using L = Stage<F>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[WARPS][STAGES];
  // the swizzled rows need 1024-byte alignment; the same offset in
  // every block of the cluster
  const uint32_t pad = (1024u - (smem_addr(smem_raw) & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + pad;
  cg::cluster_group cluster = cg::this_cluster();
  const int nrank = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / nrank;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, cg = chunk_of(g);
  const int col0 = tile * WN + 16 * cg;
  const int groups = K / 32;
  const int nslice = nrank * WARPS, slice = rank * WARPS + warp;
  const int gbeg = (int)((long long)slice * groups / nslice);
  const int gend = (int)((long long)(slice + 1) * groups / nslice);
  uint8_t* ring = smem + warp * L::RING;
  const uint32_t bar0 = smem_addr(&full[warp][0]);
  // the warp's partial (rows 2t, 2t+1 of columns 16 cg + 2j, + 1) goes
  // where its ring was: [MR][WN] f32
  float* part = reinterpret_cast<float*>(ring);
  if (TMA && lane == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bar0 + 8 * i, 1);
    tc::fence_async_smem();
  }
  __syncwarp();
  int it = 0;                             // groups through the ring

  for (int m0 = blockIdx.y * MR; m0 < M; m0 += gridDim.y * MR) {
    const int mrows = min(MR, M - m0);
    // start group ``grp`` into ring slot ``i``
    auto fetch = [&](int grp, int i) {
      uint8_t* st = ring + i * L::BYTES;
      if constexpr (TMA) {
        if (lane == 0) {
          const uint32_t bar = bar0 + 8 * i, d = smem_addr(st);
          mbar_expect_tx(bar, L::TX);
          tma_2d(d, &tm_q, tile * WN, grp * L::Q_ROWS, bar);
          tma_2d(d + L::S, &tm_s, tile * WN, lds ? grp : 0, bar);
          if constexpr (F == Fmt::Q4_1)
            tma_2d(d + L::Z, &tm_z, tile * WN, lds ? grp : 0, bar);
          tma_2d(d + L::X, &tm_x, grp * 32, m0, bar);
        }
      } else {
        fill_stage<F>(st, grp, q, scale, zero, x, m0, M, K, col0, N, lds,
                      cg, g, t);
      }
    };

    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

    for (int i = 0; i < STAGES - 1 && gbeg + i < gend; ++i)
      fetch(gbeg + i, (it + i) % STAGES);
#pragma unroll 1
    for (int grp = gbeg; grp < gend; ++grp, ++it) {
      if (grp + STAGES - 1 < gend)
        fetch(grp + STAGES - 1, (it + STAGES - 1) % STAGES);
      const int slot = it % STAGES;
      if constexpr (TMA)
        mbar_wait(bar0 + 8 * slot, (it / STAGES) & 1);
      else
        __syncwarp();                      // every lane's stores
      Group<F> cur;
      read_stage<F>(cur, ring + slot * L::BYTES, cg, g, t);
      __syncwarp();                        // read before it is refilled
      mma_group<F>(cur, acc);
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 16 * cg + 2 * j;
      *reinterpret_cast<float2*>(&part[(2 * t) * WN + c]) =
          make_float2(acc[j][0], acc[j][2]);
      *reinterpret_cast<float2*>(&part[(2 * t + 1) * WN + c]) =
          make_float2(acc[j][1], acc[j][3]);
    }
    cluster_sync_release();
    // each output: the slices' partials summed in slice order
    for (int e = rank * THREADS + threadIdx.x; e < mrows * WN;
         e += nrank * THREADS) {
      const int m = e / WN, c = e % WN, n = tile * WN + c;
      if (n >= N) continue;
      float v[MAX_CLUSTER][WARPS];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) {
        if (r < nrank) {
          const uint8_t* base = cluster.map_shared_rank(smem, r);
#pragma unroll
          for (int w = 0; w < WARPS; ++w)
            v[r][w] = reinterpret_cast<const float*>(
                base + w * L::RING)[m * WN + c];
        }
      }
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < nrank) {
#pragma unroll
          for (int w = 0; w < WARPS; ++w) sum += v[r][w];
        }
      bigdl::store(out + (size_t)(m0 + m) * N + n, sum);
    }
    cluster_sync_relaxed();                // partials read before reuse
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <Fmt F, typename OutT, bool TMA>
cudaError_t start(const cudaLaunchConfig_t& base, const CUtensorMap* maps,
                  const void* x, const void* q, const void* scale,
                  const void* zero, void* out, int M, int K, int N,
                  int lds) {
  auto kernel = lowbit_gemv_kernel<F, OutT, TMA>;
  static bool ready = false;             // opt in to > 48 KB once
  if (!ready) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Stage<F>::SMEM);
    if (rc != cudaSuccess) return rc;
    ready = true;
  }
  cudaLaunchConfig_t cfg = base;
  cfg.dynamicSmemBytes = Stage<F>::SMEM;
  return cudaLaunchKernelEx(
      &cfg, kernel, maps[0], maps[1], maps[2], maps[3],
      reinterpret_cast<const __nv_bfloat16*>(x),
      reinterpret_cast<const uint8_t*>(q),
      reinterpret_cast<const float*>(scale),
      reinterpret_cast<const float*>(zero), reinterpret_cast<OutT*>(out), M,
      K, N, lds);
}

// the TMA descriptions of q, the scale (and zero) plane (per group, or
// its one row when lds = 0) and x; false where TMA cannot read them
template <Fmt F>
bool tensor_maps(CUtensorMap maps[4], const void* x, const void* q,
                 const void* scale, const void* zero, long long M,
                 long long K, long long N, long long lds) {
  if (N % 16 || !aligned16(x) || !aligned16(q) || !aligned16(scale) ||
      !aligned16(zero) || tc::encoder() == nullptr)
    return false;
  const long long prow = lds ? K / 32 : 1;
  return tc::tile_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N,
                      K / (F == Fmt::Q8_0 ? 1 : 2), N, WN,
                      Stage<F>::Q_ROWS, CU_TENSOR_MAP_SWIZZLE_128B) &&
         tc::tile_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, N,
                      prow, N * 4, WN, 1, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         (F != Fmt::Q4_1 ||
          tc::tile_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, zero, N,
                       prow, N * 4, WN, 1, CU_TENSOR_MAP_SWIZZLE_NONE)) &&
         tc::tile_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                      K * 2, 32, MR, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <Fmt F, typename OutT>
int launch(const void* x, const void* q, const void* scale, const void* zero,
           void* out, long long M, long long K, long long N, long long lds,
           long long slices, void* stream) {
  const long long nrank = slices / WARPS;
  if (slices % WARPS || nrank < 1 || nrank > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4] = {};
  const bool tma = tensor_maps<F>(maps, x, q, scale, zero, M, K, N, lds);
  const long long tiles = (N + WN - 1) / WN;
  const long long mt = (M + MR - 1) / MR;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * nrank),
                     (unsigned)(mt < 65535 ? mt : 65535));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nrank;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc =
      tma ? start<F, OutT, true>(cfg, maps, x, q, scale, zero, out, (int)M,
                                 (int)K, (int)N, (int)lds)
          : start<F, OutT, false>(cfg, maps, x, q, scale, zero, out, (int)M,
                                  (int)K, (int)N, (int)lds);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). Preconditions, checked by the Python
// wrappers: K % 32 == 0; x contiguous and 16-byte aligned; q contiguous;
// scale (and zero) with unit column stride and row stride lds (N or 0;
// q4_0 takes contiguous scales); M, K, N > 0; slices = 4 * (cluster
// size), 4..32 (gemv_slices).
extern "C" int int4_matmul_gemv_bf16out(const void* x, const void* q,
                                        const void* scale, void* out,
                                        long long M, long long K, long long N,
                                        long long slices, void* stream) {
  return launch<Fmt::Q4_0, __nv_bfloat16>(x, q, scale, nullptr, out, M, K,
                                          N, N, slices, stream);
}

extern "C" int int4_matmul_gemv_f32out(const void* x, const void* q,
                                       const void* scale, void* out,
                                       long long M, long long K, long long N,
                                       long long slices, void* stream) {
  return launch<Fmt::Q4_0, float>(x, q, scale, nullptr, out, M, K, N, N,
                                  slices, stream);
}

extern "C" int asym_int4_matmul_gemv_bf16out(
    const void* x, const void* q, const void* scale, const void* zero,
    void* out, long long M, long long K, long long N, long long lds,
    long long slices, void* stream) {
  return launch<Fmt::Q4_1, __nv_bfloat16>(x, q, scale, zero, out, M, K, N,
                                          lds, slices, stream);
}

extern "C" int asym_int4_matmul_gemv_f32out(
    const void* x, const void* q, const void* scale, const void* zero,
    void* out, long long M, long long K, long long N, long long lds,
    long long slices, void* stream) {
  return launch<Fmt::Q4_1, float>(x, q, scale, zero, out, M, K, N, lds,
                                  slices, stream);
}

extern "C" int int8_matmul_gemv_bf16out(const void* x, const void* q,
                                        const void* scale, void* out,
                                        long long M, long long K, long long N,
                                        long long lds, long long slices,
                                        void* stream) {
  return launch<Fmt::Q8_0, __nv_bfloat16>(x, q, scale, nullptr, out, M, K,
                                          N, lds, slices, stream);
}

extern "C" int int8_matmul_gemv_f32out(const void* x, const void* q,
                                       const void* scale, void* out,
                                       long long M, long long K, long long N,
                                       long long lds, long long slices,
                                       void* stream) {
  return launch<Fmt::Q8_0, float>(x, q, scale, nullptr, out, M, K, N, lds,
                                  slices, stream);
}
