// Paged-attention decode for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py::
// paged_attention (body _kernel): flash-decoding over a paged KV pool, one
// query token per row, fp32 online softmax across pages, kv_len = pos + 1.
//
// Design. The TPU kernel runs the page axis as a sequential grid dimension
// with m, l and acc carried in VMEM scratch between grid steps. Blocks on
// Hopper run in no order, so the page axis becomes a loop inside ONE block
// per (row, kv-head); m, l and acc live in shared memory and registers for
// the whole loop. The block handles all rep = Hq / Hkv query heads of its
// kv-head (query head h reads kv-head h / rep: consecutive heads share one,
// as q.reshape(B, Hkv, rep, D) does in the reference), so each K/V row is
// read once for rep heads. The block reads its own page ids from the table
// row and never touches a page at or past kv_len; on the ragged last page
// the positions past kv_len are left out of every sum (never loaded, never
// multiplied by 0), so garbage or poison there cannot leak, bit for bit.
// Scores are q.k * (1/sqrt(D)) in fp32; p stays fp32 for P.V (the Pallas
// kernel upcasts V to fp32 first); the output is written in q's dtype with
// l == 0 guarded. NEG_INF = -1e30 initialises m, as in the reference.
//
// Bound. One decode row reads kv_len * Hkv * D * 2 K/V elements and does
// 4 * Hq * D * kv_len flops: about 2.5 flop per byte in bf16, far below the
// ~295 flop/byte ridge, so the card's 3.35 TB/s bounds it (count each live
// page's K/V once per step: rows of one slot share pages). This simple
// kernel does not reach that bound: each block walks its pages serially with
// scalar loads and a block barrier per page, rows of one prefill chunk each
// re-read their slot's pages (from L2), and a few long decode rows set the
// tail of the step. Split-KV, wgmma and TMA belong to later work.
//
// Shapes: q (B, Hq, D), pools (n_pages, page_size, Hkv, D), table (B, P)
// int32, pos (B,) int32, out (B, Hq, D). Limits: Hq % Hkv == 0,
// Hq/Hkv <= MAX_REP, D <= MAX_D, page_size <= MAX_PAGE; the C entry checks
// them and returns cudaErrorInvalidValue, launching nothing, otherwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int MAX_REP = 16;
constexpr int MAX_D = 256;
constexpr int MAX_PAGE = 128;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int DIMS_PER_THREAD = MAX_D / THREADS;   // P.V: thread owns dims
constexpr int DIMS_PER_LANE = MAX_D / 32;          // Q.K: lane owns dims
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ table,
                       const int* __restrict__ pos, T* __restrict__ out,
                       int hq, int hkv, int d, int page_size, int n_blocks) {
  __shared__ float q_s[MAX_REP][MAX_D];
  __shared__ float p_s[MAX_REP][MAX_PAGE + 1];   // scores, then probs
  __shared__ float m_s[MAX_REP], l_s[MAX_REP], corr_s[MAX_REP];

  const int row = blockIdx.x / hkv;
  const int kvh = blockIdx.x % hkv;
  const int rep = hq / hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float scale = (float)(1.0 / sqrt((double)d));

  const T* qrow = q + ((size_t)row * hq + (size_t)kvh * rep) * d;
  for (int i = tid; i < rep * d; i += THREADS)
    q_s[i / d][i % d] = to_f32(qrow[i]);
  if (tid < rep) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[MAX_REP][DIMS_PER_THREAD];
#pragma unroll
  for (int h = 0; h < MAX_REP; ++h)
#pragma unroll
    for (int i = 0; i < DIMS_PER_THREAD; ++i) acc[h][i] = 0.f;

  const int kv_len = pos[row] + 1;
  int live = (kv_len + page_size - 1) / page_size;
  if (live > n_blocks) live = n_blocks;
  const size_t tok_stride = (size_t)hkv * d;     // one pool position
  __syncthreads();

  for (int blk = 0; blk < live; ++blk) {
    const size_t page = (size_t)table[(size_t)row * n_blocks + blk];
    const int valid = min(page_size, kv_len - blk * page_size);
    const size_t base = page * page_size * tok_stride + (size_t)kvh * d;

    // scores: warp w takes positions w, w + WARPS, ...; lanes split D
    for (int t = warp; t < valid; t += WARPS) {
      const T* kt = kp + base + (size_t)t * tok_stride;
      float kr[DIMS_PER_LANE];
#pragma unroll
      for (int i = 0; i < DIMS_PER_LANE; ++i) {
        const int dd = lane + 32 * i;
        kr[i] = dd < d ? to_f32(kt[dd]) : 0.f;
      }
#pragma unroll
      for (int h = 0; h < MAX_REP; ++h) {
        if (h >= rep) break;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DIMS_PER_LANE; ++i) {
          const int dd = lane + 32 * i;
          if (dd < d) part += q_s[h][dd] * kr[i];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0) p_s[h][t] = part * scale;
      }
    }
    __syncthreads();

    // online softmax over this page's valid positions, one head a thread
    if (tid < rep) {
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int t = 0; t < valid; ++t) m_new = fmaxf(m_new, p_s[tid][t]);
      float sum = 0.f;
      for (int t = 0; t < valid; ++t) {
        const float e = expf(p_s[tid][t] - m_new);
        p_s[tid][t] = e;
        sum += e;
      }
      const float corr = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = m_new;
      corr_s[tid] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P.V; thread owns dims tid, tid + THREADS, ...
#pragma unroll
    for (int i = 0; i < DIMS_PER_THREAD; ++i) {
      const int dd = tid + THREADS * i;
      if (dd >= d) continue;
#pragma unroll
      for (int h = 0; h < MAX_REP; ++h)
        if (h < rep) acc[h][i] *= corr_s[h];
      for (int t = 0; t < valid; ++t) {
        const float v = to_f32(vp[base + (size_t)t * tok_stride + dd]);
#pragma unroll
        for (int h = 0; h < MAX_REP; ++h)
          if (h < rep) acc[h][i] += p_s[h][t] * v;
      }
    }
    __syncthreads();
  }

  T* orow = out + ((size_t)row * hq + (size_t)kvh * rep) * d;
#pragma unroll
  for (int i = 0; i < DIMS_PER_THREAD; ++i) {
    const int dd = tid + THREADS * i;
    if (dd >= d) continue;
#pragma unroll
    for (int h = 0; h < MAX_REP; ++h) {
      if (h < rep) {
        const float l = l_s[h];
        orow[(size_t)h * d + dd] = from_f32<T>(acc[h][i] / (l == 0.f ? 1.f : l));
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* pos, void* out, int b, int hq, int hkv, int d,
           int page_size, int n_blocks, void* stream) {
  // q_s, p_s and acc are sized by these limits
  if (hkv < 1 || hq % hkv != 0 || hq / hkv > MAX_REP || d < 1 || d > MAX_D ||
      page_size < 1 || page_size > MAX_PAGE)
    return (int)cudaErrorInvalidValue;
  if (b > 0) {
    paged_attention_kernel<T><<<b * hkv, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)table,
        (const int*)pos, (T*)out, hq, hkv, d, page_size, n_blocks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_f32(const void* q, const void* k,
                                   const void* v, const void* table,
                                   const void* pos, void* out, int b, int hq,
                                   int hkv, int d, int page_size,
                                   int n_blocks, void* stream) {
  return launch<float>(q, k, v, table, pos, out, b, hq, hkv, d, page_size,
                       n_blocks, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* table,
                                    const void* pos, void* out, int b,
                                    int hq, int hkv, int d, int page_size,
                                    int n_blocks, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, table, pos, out, b, hq, hkv, d,
                               page_size, n_blocks, stream);
}
