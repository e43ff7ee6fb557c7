// Paged decode attention: the flash-state ("stats") variant and the
// normalised variant, one kernel for both (runtime flag `normalize`).
//
// Replaces: bigdl_tpu/llm/kernels/paged_attention.py,
//   paged_attention_decode_stats (pl.pallas_call of
//   _paged_decode_kernel_pm_stats, page-major, and of
//   _paged_decode_kernel_stats, head-minor) with normalize = 0, and
//   paged_attention_decode (pl.pallas_call of _paged_decode_kernel_pm and
//   _paged_decode_kernel) with normalize = 1. The page_major flag chose
//   a TPU DMA layout, not a different result: this one kernel computes the
//   function of all four bodies.
//
// Contract: one query token per row b. q (B, Hq, D) f32; pools
// (P, Hkv, page, D) bf16 or f32 (a flat (L*P) view with the block table
// offset by l*P, or one layer's view of an (L, P, ...) pool: the pointer
// need not be the start of an allocation, every load is one element);
// block_tables (B, pages_max) int32; lengths (B,) int32 = tokens to
// attend. The window covers positions pos < len and pos >= len - window
// (window >= 0). The caller decides what len counts: the stats entry is
// called with the current token EXCLUDED (and the window shrunk by one),
// the normalised entry with it INCLUDED (the token already written to its
// page).
//   stats:      acc (B, Hq, D) f32 unnormalised, m (B, Hq) f32,
//               l (B, Hq) f32; a row with no valid position writes
//               (0, -1e30, 0), the identity of the combine.
//   normalised: out (B, Hq, D) f32 = acc / max(l, 1e-30); a row with no
//               valid position writes 0, as the Pallas kernel does.
//
// What bounds it on the H100: the K/V bytes of the live tokens,
// 2 * len * D * sizeof(kv) per (row, kv head) — memory, not arithmetic
// (2 * D FLOPs per key per query head).
//
// Simple design and what it does about that bound:
// - one block per (row b, kv head h) handles the g = Hq/Hkv query heads
//   that share the head, so each K/V row is read from device memory once
//   per block and reused for all g queries (GQA);
// - keys are walked in chunks of 32 positions, each position's physical
//   page looked up in the block table; only positions inside
//   [start, len) are read — nothing past a row's length is fetched, and
//   there is no padding of the table to a lane multiple;
// - scores: each warp takes 8 keys of the chunk; its 32 lanes split D,
//   read the key row coalesced and reduce the g dot products with
//   shuffles; then one warp per query head runs the online-softmax update
//   (running max, rescale, sum) with one lane per key, and all threads
//   update the f32 accumulators, reading V rows coalesced;
// - masked keys are never read and contribute exactly 0 (p is set to 0
//   for them, not exp of a large negative number);
// - the flag is a runtime argument, not a template parameter: as a
//   template flag, nvcc compiled the normalised instance with a stack
//   frame and register spills, and it ran markedly slower than the stats
//   instance of the same body (measured on an H100, PERF.md); one
//   instance per pool type runs both at the same speed.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int CHUNK = 32;
constexpr int MAXG = 8;               // query heads per kv head
constexpr int MAXD = 128;
constexpr int DPL = MAXD / 32;        // head-dim elements per lane
constexpr int ACC_PER_THREAD = MAXG * MAXD / THREADS;

template <typename KV>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const float* __restrict__ q,
                    const KV* __restrict__ k_pages,
                    const KV* __restrict__ v_pages,
                    const int* __restrict__ bt, const int* __restrict__ lens,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int Hq, int Hkv, int page,
                    int D, int pages_max, int window, float scale,
                    int normalize) {
  __shared__ float s_p[MAXG][CHUNK];
  __shared__ float s_m[MAXG], s_l[MAXG], s_alpha[MAXG];
  __shared__ long long s_row[CHUNK];

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int g = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = lens[b];
  const int start = window >= 0 ? max(0, len - window) : 0;

  // this lane's slice of the g queries (d = lane + 32 j)
  float qr[MAXG][DPL];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      qr[gi][j] = (gi < g && d < D)
                      ? q[((size_t)b * Hq + h * g + gi) * D + d]
                      : 0.f;
    }
  float acc[ACC_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ACC_PER_THREAD; ++i) acc[i] = 0.f;
  if (threadIdx.x < MAXG) {
    s_m[threadIdx.x] = bigdl::NEG_BIG;
    s_l[threadIdx.x] = 0.f;
  }

  for (int t0 = start; t0 < len; t0 += CHUNK) {
    if (threadIdx.x < CHUNK) {
      const int pos = t0 + threadIdx.x;
      long long row = -1;
      if (pos < len) {
        const long long phys = bt[(size_t)b * pages_max + pos / page];
        row = ((phys * Hkv + h) * page + pos % page) * (long long)D;
      }
      s_row[threadIdx.x] = row;
    }
    __syncthreads();
    // scores: warp w takes keys w, w + NW, ...
    for (int t = warp; t < CHUNK; t += NW) {
      const long long row = s_row[t];
      if (row < 0) continue;                     // warp-uniform
      float kv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        kv[j] = d < D ? bigdl::to_f32(k_pages[row + d]) : 0.f;
      }
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) {
        if (gi >= g) break;
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) dot = fmaf(qr[gi][j], kv[j], dot);
        dot = bigdl::warp_sum(dot);
        if (lane == 0) s_p[gi][t] = dot * scale;
      }
    }
    __syncthreads();
    // online softmax: one warp per query head, one lane per key
    for (int gi = warp; gi < g; gi += NW) {
      const bool valid = s_row[lane] >= 0;
      const float s = valid ? s_p[gi][lane] : -INFINITY;
      const float m_cur = bigdl::warp_max(s);    // t0 < len: one is valid
      const float m_old = s_m[gi];
      const float m_new = fmaxf(m_old, m_cur);
      const float p = valid ? expf(s - m_new) : 0.f;
      const float psum = bigdl::warp_sum(p);
      s_p[gi][lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        s_alpha[gi] = alpha;
        s_l[gi] = s_l[gi] * alpha + psum;
        s_m[gi] = m_new;
      }
    }
    __syncthreads();
    // accumulators: element e = (gi, d), read V rows coalesced
#pragma unroll
    for (int i = 0; i < ACC_PER_THREAD; ++i) {
      const int e = threadIdx.x + THREADS * i;
      if (e < g * D) {
        const int gi = e / D, d = e % D;
        float a = acc[i] * s_alpha[gi];
        for (int t = 0; t < CHUNK; ++t) {
          const long long row = s_row[t];
          if (row >= 0)
            a = fmaf(s_p[gi][t], bigdl::to_f32(v_pages[row + d]), a);
        }
        acc[i] = a;
      }
    }
    __syncthreads();
  }
  // a row with no chunk never passed a barrier after the init of s_l
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ACC_PER_THREAD; ++i) {
    const int e = threadIdx.x + THREADS * i;
    if (e < g * D) {
      const int gi = e / D, d = e % D;
      const float v = normalize ? acc[i] / fmaxf(s_l[gi], 1e-30f) : acc[i];
      acc_out[((size_t)b * Hq + h * g + gi) * D + d] = v;
    }
  }
  if (!normalize && threadIdx.x < g) {
    m_out[(size_t)b * Hq + h * g + threadIdx.x] = s_m[threadIdx.x];
    l_out[(size_t)b * Hq + h * g + threadIdx.x] = s_l[threadIdx.x];
  }
}

template <typename KV>
int launch(const void* q, const void* kp, const void* vp, const void* bt,
           const void* lens, void* acc, void* m, void* l, long long B,
           long long Hq, long long Hkv, long long page, long long D,
           long long pages_max, long long window, float scale,
           bool normalize, void* stream) {
  paged_decode_kernel<KV>
      <<<(unsigned)(B * Hkv), THREADS, 0, (cudaStream_t)stream>>>(
          reinterpret_cast<const float*>(q), reinterpret_cast<const KV*>(kp),
          reinterpret_cast<const KV*>(vp), reinterpret_cast<const int*>(bt),
          reinterpret_cast<const int*>(lens), reinterpret_cast<float*>(acc),
          reinterpret_cast<float*>(m), reinterpret_cast<float*>(l), (int)Hq,
          (int)Hkv, (int)page, (int)D, (int)pages_max, (int)window, scale,
          (int)normalize);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface. Preconditions, checked by the Python wrapper: Hq % Hkv ==
// 0 with Hq / Hkv <= 8, D <= 128, contiguous tensors, B * Hkv > 0;
// window < 0 means no sliding window.
#define BIGDL_PAGED_STATS_ENTRY(NAME, KV)                                  \
  extern "C" int NAME(const void* q, const void* kp, const void* vp,       \
                      const void* bt, const void* lens, void* acc,         \
                      void* m, void* l, long long B, long long Hq,         \
                      long long Hkv, long long page, long long D,          \
                      long long pages_max, long long window, float scale,  \
                      void* stream) {                                      \
    return launch<KV>(q, kp, vp, bt, lens, acc, m, l, B, Hq, Hkv, page,    \
                      D, pages_max, window, scale, false, stream);         \
  }

#define BIGDL_PAGED_ENTRY(NAME, KV)                                        \
  extern "C" int NAME(const void* q, const void* kp, const void* vp,       \
                      const void* bt, const void* lens, void* out,         \
                      long long B, long long Hq, long long Hkv,            \
                      long long page, long long D, long long pages_max,    \
                      long long window, float scale, void* stream) {       \
    return launch<KV>(q, kp, vp, bt, lens, out, nullptr, nullptr, B, Hq,   \
                      Hkv, page, D, pages_max, window, scale, true,        \
                      stream);                                             \
  }

BIGDL_PAGED_STATS_ENTRY(paged_decode_stats_bf16, __nv_bfloat16)
BIGDL_PAGED_STATS_ENTRY(paged_decode_stats_f32, float)
BIGDL_PAGED_ENTRY(paged_decode_bf16, __nv_bfloat16)
BIGDL_PAGED_ENTRY(paged_decode_f32, float)
