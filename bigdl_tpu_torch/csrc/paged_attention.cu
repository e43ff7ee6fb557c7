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
// offset by l*P, or one layer's view of an (L, P, ...) pool), 16-byte
// aligned, D a multiple of 8 up to 256 on bf16 pools, a multiple of 4
// up to 128 or of 8 up to 256 on f32 pools; any group
// g = Hq / Hkv >= 1; block_tables (B, pages_max) int32; lengths (B,)
// int32 = tokens to attend. The window
// covers positions pos < len and pos >= len - window (window >= 0). The
// caller decides what len counts: the stats entry is called with the
// current token EXCLUDED (and the window shrunk by one), the normalised
// entry with it INCLUDED (the token already written to its page).
//   stats:      acc (B, Hq, D) f32 unnormalised, m (B, Hq) f32,
//               l (B, Hq) f32; a row with no valid position writes
//               (0, -1e30, 0), the identity of the combine.
//   normalised: out (B, Hq, D) f32 = acc / max(l, 1e-30); a row with no
//               valid position writes 0, as the Pallas kernel does.
//
// What bounds it on the H100: the K/V bytes of the live tokens,
// 2 * len * D * sizeof(kv) per (row, kv head) — memory, not arithmetic
// (2 * D operations per key per query head).
//
// Design (split-sequence, "flash-decoding"):
// - a row's live range [start, len) is cut at the multiples of `split`
//   keys (SPLIT_KEYS in llm/kernels/paged_attention.py, a multiple of the
//   page size): the cut depends on the row's own start and len only,
//   never on the batch, Hkv or the card, so a row's result does not
//   depend on its neighbours;
// - the g = Hq / Hkv query heads of a kv head are cut into chunks of at
//   most MAXG = 8 (the shared arrays are sized by it); the grid is
//   (B * Hkv * ceil(g / 8), splits); block (row b, kv head h, chunk c,
//   split j) computes the flash state of its keys for the chunk's query
//   heads, reading each K/V row once for all of them (GQA; a group of 16
//   reads its rows twice, the second time mostly from L2); a split
//   outside the row's range exits at once. A head's arithmetic is the
//   same in every chunk and every position of a chunk, so its result
//   depends on neither;
// - inside a block, K and V rows are read as vectors of E elements, 8
//   bf16 (16 bytes) or 4 f32 (16 bytes; 8, as two 16-byte loads, for f32
//   rows wider than 128), a 128-wide bf16 row on 16 lanes, 8 vectors in
//   flight a lane;
//   a row takes the power of two of lanes at or above its vectors (an
//   80-wide bf16 row: 10 lanes of 16), the lanes past its end hold zeros;
//   three passes over the split with one barrier each: the scores of all
//   its keys into shared memory, then per head the max, exp and sum, then
//   P @ V with each thread summing its own keys in order, and the threads'
//   sums added in a fixed order;
// - the splits of a (row, kv head) are combined in split order by the
//   block that arrives last (an arrival counter zeroed by the wrapper,
//   __threadfence before the arrival); the scratch states are allocated
//   by the wrapper. No float atomics, so the result does not depend on
//   the order the blocks ran in. A row with one split writes its result
//   directly;
// - masked keys are never read;
// - the flag is a runtime argument, not a template parameter: as a
//   template flag, nvcc compiled the normalised instance of the earlier
//   one-block-per-head kernel with a stack frame and register spills, and
//   it ran markedly slower (measured on an H100, PERF.md).

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int MAXG = 8;          // query heads a block (a chunk of g)
constexpr int MAX_SPLIT = 512;   // keys per split
constexpr int U = 8;             // 16-byte loads in flight per lane

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&f)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// E f32: one 16-byte load a 4 (E = 4), two for 8 (E = 8)
template <int E>
__device__ __forceinline__ void load_vec(const float* p, float (&f)[E]) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
    f[4 * i] = v.x, f[4 * i + 1] = v.y, f[4 * i + 2] = v.z,
    f[4 * i + 3] = v.w;
  }
}

// E: the elements a lane reads of a row at once (8 bf16; 4 or 8 f32)
template <typename KV, int E>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const float* __restrict__ q,
                    const KV* __restrict__ k_pages,
                    const KV* __restrict__ v_pages,
                    const int* __restrict__ bt, const int* __restrict__ lens,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int* __restrict__ arrivals,
                    int Hq, int Hkv, int page, int D, int pages_max,
                    int window, float scale, int normalize, int split,
                    int nsplit) {
  __shared__ long long s_row[MAX_SPLIT];
  // the scores (MAXG x MAX_SPLIT), then the threads' P @ V sums
  __shared__ float s_buf[(THREADS * E * MAXG > MAXG * MAX_SPLIT)
                             ? THREADS * E * MAXG
                             : MAXG * MAX_SPLIT];
  __shared__ float s_m[MAXG], s_l[MAXG];
  __shared__ int s_last;

  // block x = (row b, kv head h, chunk c); the scratch of a (b, h, c) is
  // indexed by x, its heads strided by GC, the chunks' largest size
  const int bhc = blockIdx.x, j = blockIdx.y;
  const int G = Hq / Hkv, nchunk = (G + MAXG - 1) / MAXG;
  const int GC = min(G, MAXG), c = bhc % nchunk, bh = bhc / nchunk;
  const int b = bh / Hkv, h = bh % Hkv;
  const int g = min(MAXG, G - c * MAXG);           // heads of this chunk
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = lens[b];
  const int start = window >= 0 ? max(0, len - window) : 0;
  const int first = start / split;
  const int nsr = len > start ? (len + split - 1) / split - first : 0;
  // the chunk's first query head
  const size_t head0 = (size_t)b * Hq + h * G + c * MAXG;

  if (nsr == 0) {                  // nothing to attend
    if (j == 0) {
      for (int e = tid; e < g * D; e += THREADS)
        acc_out[head0 * D + e] = 0.f;
      if (!normalize && tid < g) {
        m_out[head0 + tid] = bigdl::NEG_BIG;
        l_out[head0 + tid] = 0.f;
      }
    }
    return;
  }
  const int js = j - first;        // this block's split of the row
  if (js < 0 || js >= nsr) return;
  const int t_lo = max(start, j * split);
  const int n = min(len, (j + 1) * split) - t_lo;   // >= 1

  for (int t = tid; t < n; t += THREADS) {
    const int pos = t_lo + t;
    const long long phys = bt[(size_t)b * pages_max + pos / page];
    s_row[t] = ((phys * Hkv + h) * page + pos % page) * (long long)D;
  }
  __syncthreads();

  // pass 1: scores. A key row is LPK vectors of E elements on LP2 lanes
  // (the power of two at or above LPK; lanes sub >= LPK hold zeros); a
  // warp reads KPW keys per load
  const int LPK = D / E;
  int LP2 = 1;
  while (LP2 < LPK) LP2 <<= 1;
  const int KPW = 32 / LP2;
  float* s_p = s_buf;
  {
    const int sub = lane % LP2, kl = lane / LP2;
    const bool in_row = sub < LPK;
    float qr[MAXG][E];
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
      for (int e = 0; e < E; ++e)
        qr[gi][e] = gi < g && in_row ? q[(head0 + gi) * D + sub * E + e]
                                     : 0.f;
    for (int t0 = warp * KPW; t0 < n; t0 += NW * KPW * U) {
      float kf[U][E];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * NW * KPW + kl;
        if (t < n && in_row) {
          load_vec(k_pages + s_row[t] + sub * E, kf[u]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kf[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * NW * KPW + kl;
#pragma unroll
        for (int gi = 0; gi < MAXG; ++gi) {
          if (gi >= g) break;
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qr[gi][e], kf[u][e], dot);
          for (int o = LP2 / 2; o > 0; o >>= 1)
            dot += __shfl_xor_sync(bigdl::FULL_MASK, dot, o);
          if (sub == 0 && t < n) s_p[gi * MAX_SPLIT + t] = dot * scale;
        }
      }
    }
  }
  __syncthreads();

  // pass 2: per query head, the split's max, p = exp(s - max) and sum
  for (int gi = warp; gi < g; gi += NW) {
    float* s = s_p + gi * MAX_SPLIT;
    float mx = -INFINITY;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, s[t]);
    mx = bigdl::warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(s[t] - mx);
      s[t] = p;
      sum += p;
    }
    sum = bigdl::warp_sum(sum);
    if (lane == 0) {
      s_m[gi] = mx;
      s_l[gi] = sum;
    }
  }
  __syncthreads();

  // pass 3: P @ V. Thread = (slot, d-vector); a slot sums keys slot,
  // slot + NSLOT, ... in order
  const int NSLOT = THREADS / LP2;
  const int slot = tid / LP2, dsub = tid % LP2;
  const bool d_in = dsub < LPK;
  float a[MAXG][E];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
    for (int e = 0; e < E; ++e) a[gi][e] = 0.f;
  for (int t0 = slot; t0 < n; t0 += NSLOT * U) {
    float vf[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * NSLOT;
      if (t < n && d_in) {
        load_vec(v_pages + s_row[t] + dsub * E, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * NSLOT;
      if (t < n) {
#pragma unroll
        for (int gi = 0; gi < MAXG; ++gi) {
          if (gi >= g) break;
          const float p = s_p[gi * MAX_SPLIT + t];
#pragma unroll
          for (int e = 0; e < E; ++e) a[gi][e] = fmaf(p, vf[u][e], a[gi][e]);
        }
      }
    }
  }
  __syncthreads();                 // the scores are read for the last time
  float* red = s_buf;              // (NSLOT, MAXG, D)
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    if (gi >= g || !d_in) break;
#pragma unroll
    for (int e = 0; e < E; ++e)
      red[(slot * MAXG + gi) * D + dsub * E + e] = a[gi][e];
  }
  __syncthreads();

  float* pa = part_acc + ((size_t)bhc * nsplit + js) * GC * D;
  for (int e = tid; e < g * D; e += THREADS) {
    const int gi = e / D, d = e % D;
    float v = 0.f;
    for (int s = 0; s < NSLOT; ++s) v += red[(s * MAXG + gi) * D + d];
    if (nsr == 1)
      acc_out[head0 * D + e] =
          normalize ? v / fmaxf(s_l[gi], 1e-30f) : v;
    else
      pa[e] = v;
  }
  if (nsr == 1) {
    if (!normalize && tid < g) {
      m_out[head0 + tid] = s_m[tid];
      l_out[head0 + tid] = s_l[tid];
    }
    return;
  }
  float* ml = part_ml + (size_t)bhc * nsplit * 2 * GC;
  if (tid < g) {
    ml[js * 2 * GC + tid] = s_m[tid];
    ml[js * 2 * GC + GC + tid] = s_l[tid];
  }
  // the last block of (row, kv head) to arrive combines the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(arrivals + bhc, 1) == nsr - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* pa0 = part_acc + (size_t)bhc * nsplit * GC * D;
  for (int e = tid; e < g * D; e += THREADS) {
    const int gi = e / D;
    float mx = bigdl::NEG_BIG;
    for (int s = 0; s < nsr; ++s)
      mx = fmaxf(mx, __ldcg(ml + s * 2 * GC + gi));
    float l = 0.f, v = 0.f;
    for (int s = 0; s < nsr; ++s) {
      const float w = expf(__ldcg(ml + s * 2 * GC + gi) - mx);
      l = fmaf(__ldcg(ml + s * 2 * GC + GC + gi), w, l);
      v = fmaf(__ldcg(pa0 + (size_t)s * GC * D + e), w, v);
    }
    acc_out[head0 * D + e] = normalize ? v / fmaxf(l, 1e-30f) : v;
    if (!normalize && e % D == 0) {
      m_out[head0 + gi] = mx;
      l_out[head0 + gi] = l;
    }
  }
}

template <typename KV, int E>
int launch(const void* q, const void* kp, const void* vp, const void* bt,
           const void* lens, void* acc, void* m, void* l, void* part_acc,
           void* part_ml, void* arrivals, long long B, long long Hq,
           long long Hkv, long long page, long long D, long long pages_max,
           long long window, float scale, bool normalize, long long split,
           long long nsplit, void* stream) {
  const long long nchunk = (Hq / Hkv + MAXG - 1) / MAXG;
  paged_decode_kernel<KV, E>
      <<<dim3((unsigned)(B * Hkv * nchunk), (unsigned)nsplit), THREADS, 0,
         (cudaStream_t)stream>>>(
          reinterpret_cast<const float*>(q), reinterpret_cast<const KV*>(kp),
          reinterpret_cast<const KV*>(vp), reinterpret_cast<const int*>(bt),
          reinterpret_cast<const int*>(lens), reinterpret_cast<float*>(acc),
          reinterpret_cast<float*>(m), reinterpret_cast<float*>(l),
          reinterpret_cast<float*>(part_acc),
          reinterpret_cast<float*>(part_ml), reinterpret_cast<int*>(arrivals),
          (int)Hq, (int)Hkv, (int)page, (int)D, (int)pages_max, (int)window,
          scale, (int)normalize, (int)split, (int)nsplit);
  return (int)cudaGetLastError();
}

// a row of D f32 takes vectors of 4 up to D = 128 (32 lanes), of 8 beyond
template <typename KV>
int launch_d(const void* q, const void* kp, const void* vp, const void* bt,
             const void* lens, void* acc, void* m, void* l, void* part_acc,
             void* part_ml, void* arrivals, long long B, long long Hq,
             long long Hkv, long long page, long long D, long long pages_max,
             long long window, float scale, bool normalize, long long split,
             long long nsplit, void* stream) {
  if (sizeof(KV) == 2 || D <= 128)
    return launch<KV, 16 / sizeof(KV)>(
        q, kp, vp, bt, lens, acc, m, l, part_acc, part_ml, arrivals, B, Hq,
        Hkv, page, D, pages_max, window, scale, normalize, split, nsplit,
        stream);
  return launch<KV, 8>(q, kp, vp, bt, lens, acc, m, l, part_acc, part_ml,
                       arrivals, B, Hq, Hkv, page, D, pages_max, window,
                       scale, normalize, split, nsplit, stream);
}

}  // namespace

// C interface. Preconditions, checked by the Python wrapper: Hq % Hkv ==
// 0; D as in the contract above; contiguous tensors,
// pools 16-byte aligned; B * Hkv > 0; split a multiple of the page size,
// <= 512; nsplit * split >= pages_max * page; with g = Hq / Hkv, C =
// ceil(g / 8) chunks and GC = min(g, 8): part_acc (B * Hkv * C, nsplit,
// GC, D) f32, part_ml (B * Hkv * C, nsplit, 2, GC) f32, arrivals
// (B * Hkv * C,) int32 zeros; window < 0 means no sliding window.
#define BIGDL_PAGED_STATS_ENTRY(NAME, KV)                                  \
  extern "C" int NAME(const void* q, const void* kp, const void* vp,       \
                      const void* bt, const void* lens, void* acc,         \
                      void* m, void* l, void* part_acc, void* part_ml,     \
                      void* arrivals, long long B, long long Hq,           \
                      long long Hkv, long long page, long long D,          \
                      long long pages_max, long long window, float scale,  \
                      long long split, long long nsplit, void* stream) {   \
    return launch_d<KV>(q, kp, vp, bt, lens, acc, m, l, part_acc, part_ml, \
                        arrivals, B, Hq, Hkv, page, D, pages_max, window,  \
                        scale, false, split, nsplit, stream);              \
  }

#define BIGDL_PAGED_ENTRY(NAME, KV)                                        \
  extern "C" int NAME(const void* q, const void* kp, const void* vp,       \
                      const void* bt, const void* lens, void* out,         \
                      void* part_acc, void* part_ml, void* arrivals,       \
                      long long B, long long Hq, long long Hkv,            \
                      long long page, long long D, long long pages_max,    \
                      long long window, float scale, long long split,      \
                      long long nsplit, void* stream) {                    \
    return launch_d<KV>(q, kp, vp, bt, lens, out, nullptr, nullptr,        \
                        part_acc, part_ml, arrivals, B, Hq, Hkv, page, D,  \
                        pages_max, window, scale, true, split, nsplit,     \
                        stream);                                           \
  }

BIGDL_PAGED_STATS_ENTRY(paged_decode_stats_bf16, __nv_bfloat16)
BIGDL_PAGED_STATS_ENTRY(paged_decode_stats_f32, float)
BIGDL_PAGED_ENTRY(paged_decode_bf16, __nv_bfloat16)
BIGDL_PAGED_ENTRY(paged_decode_f32, float)
