// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _kernel): causal, windowed or non-causal GQA
// attention over a full sequence with an fp32 online softmax.
//
// Design. The TPU kernel runs the kv axis as the sequential third grid
// dimension with m, l and acc carried in VMEM scratch between grid steps.
// Blocks on Hopper run in no order, so the kv axis becomes a loop inside ONE
// block per (batch * query head, q tile of BQ rows); m and l live in
// registers (replicated over the 8 lanes that share a row), acc in
// registers, and the K or V tile, the Q tile and the probabilities in
// shared memory, all in fp32. Query head h reads kv head h / (Hq / Hkv)
// straight from the (B, T, Hkv, D) layout: K/V are never repeated in HBM,
// and the rep query heads of one kv head are neighbouring blocks, so their
// K/V tiles hit in L2. Per kv tile:
//   1. load K (fp32) into the kv buffer; rows past T are zero-filled;
//   2. S = Q K^T * (1/sqrt(D)) in registers, 4 rows x 8 columns a thread;
//   3. mask: kpos < T, causal kpos <= qpos, window kpos > qpos - window;
//      a masked entry takes p = 0 (never exp(-1e30 - m));
//   4. online softmax: m_new = max(m, max live s), p = exp(s - m_new),
//      corr = exp(m - m_new), l = l * corr + sum p;
//   5. load V into the same buffer; acc = acc * corr + P V with P in fp32
//      (the Pallas body upcasts V to fp32 and keeps p fp32, :87-89, :110).
// Tiles wholly past the causal edge or before the window are never visited
// (the Pallas kernel's pl.when(relevant)). The output is acc / l with
// l == 0 read as 1 (safe_l, :117-119), so a row with no live key writes 0.
// q tiles are issued heaviest first (the last causal tile visits the most kv
// tiles) so the long blocks start early.
//
// Bound. At the training shape (B = 1, S = T = 4096, Hq/Hkv = 40/8, D = 128,
// causal, bf16) the function does 4 * S * T * Hq * D / 2 = 172 GFLOP against
// 2 * 4096 * (40 + 8 + 8 + 40) * 128 bytes = 101 MB: far above the
// ~295 flop/byte ridge, so the tensor cores' 989 TFLOP/s bound it (0.17 ms).
// This simple kernel does both products with fp32 FMAs on the CUDA cores
// from shared memory, not with wgmma: it is bounded by the fp32 FMA rate
// (67 TFLOP/s peak) and shared-memory loads. wgmma for Q K^T, TMA and a
// pipelined K/V ring belong to later work.
//
// Shapes: q (B, S, Hq, D), k and v (B, T, Hkv, D), out (B, S, Hq, D), all
// contiguous. Limits: Hq % Hkv == 0, 1 <= D <= MAX_D, ceil(S / BQ) <= 65535
// (grid y); the C entry checks
// them and returns cudaErrorInvalidValue, launching nothing, otherwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;                 // query rows a block
constexpr int BK = 64;                 // keys a kv tile
constexpr int THREADS = 128;
constexpr int MAX_D = 128;
// S tile: thread (sr, sc) owns rows sr*4 .. sr*4+3, columns sc + 8*j
constexpr int S_ROWS = 4, S_COLS = 8, S_COL_THREADS = 8;
// P V: thread (pr, pc) owns rows pr*8 .. pr*8+7, dims pc + 16*j
constexpr int O_ROWS = 8, O_COL_THREADS = 16, O_COLS = MAX_D / O_COL_THREADS;
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

size_t smem_bytes(int d) {
  const int ld = d + 1;                // +1 column: rows fall in other banks
  return sizeof(float) * ((size_t)BQ * ld + (size_t)BK * ld
                          + (size_t)BQ * (BK + 1) + 2 * BQ);
}

// Load rows [row0, row0 + n) of one head of a (B, L, H, D) tensor into a
// (n, ld) fp32 tile; rows at or past `len` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t row_stride, int row0,
                                          int n, int len, int d, int ld) {
  for (int i = threadIdx.x; i < n * d; i += THREADS) {
    const int r = i / d, c = i % d;
    const int row = row0 + r;
    dst[r * ld + c] = row < len ? to_f32(src[(size_t)row * row_stride + c])
                                : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int s, int t,
                 int hq, int hkv, int d, int causal, int window,
                 float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* q_s = smem;                          // (BQ, ld)
  float* kv_s = q_s + BQ * ld;                // (BK, ld): K, then V
  float* p_s = kv_s + BK * ld;                // (BQ, BK + 1)
  float* corr_s = p_s + BQ * (BK + 1);        // (BQ)
  float* l_s = corr_s + BQ;                   // (BQ)

  const int bh = blockIdx.x;                  // batch * hq + query head
  const int b = bh / hq, h = bh % hq;
  const int g = h / (hq / hkv);               // its kv head
  const int qi = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int q_start = qi * BQ;
  const int tid = threadIdx.x;

  const size_t q_row = (size_t)hq * d;        // stride of one position
  const size_t kv_row = (size_t)hkv * d;
  const T* qh = q + ((size_t)b * s * hq + h) * d;
  const T* kh = k + ((size_t)b * t * hkv + g) * d;
  const T* vh = v + ((size_t)b * t * hkv + g) * d;
  load_tile(q_s, qh, q_row, q_start, BQ, s, d, ld);

  const int sr = tid / S_COL_THREADS, sc = tid % S_COL_THREADS;
  const int pr = tid / O_COL_THREADS, pc = tid % O_COL_THREADS;
  float m[S_ROWS], l[S_ROWS];
#pragma unroll
  for (int i = 0; i < S_ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  float acc[O_ROWS][O_COLS];
#pragma unroll
  for (int i = 0; i < O_ROWS; ++i)
#pragma unroll
    for (int j = 0; j < O_COLS; ++j) acc[i][j] = 0.f;

  // kv tiles that hold a live key for some row of this q tile
  int k_end = t;
  if (causal) k_end = min(t, q_start + BQ);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_start - window + 1) / BK * BK;

  for (int k_start = k_begin; k_start < k_end; k_start += BK) {
    __syncthreads();                          // kv_s / p_s free again
    load_tile(kv_s, kh, kv_row, k_start, BK, t, d, ld);
    __syncthreads();

    float sv[S_ROWS][S_COLS];
#pragma unroll
    for (int i = 0; i < S_ROWS; ++i)
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) sv[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[S_ROWS], kv[S_COLS];
#pragma unroll
      for (int i = 0; i < S_ROWS; ++i) qv[i] = q_s[(sr * S_ROWS + i) * ld + c];
#pragma unroll
      for (int j = 0; j < S_COLS; ++j)
        kv[j] = kv_s[(sc + S_COL_THREADS * j) * ld + c];
#pragma unroll
      for (int i = 0; i < S_ROWS; ++i)
#pragma unroll
        for (int j = 0; j < S_COLS; ++j) sv[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < S_ROWS; ++i) {
      const int row = sr * S_ROWS + i;
      const int qpos = q_start + row;
      bool live[S_COLS];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) {
        const int kpos = k_start + sc + S_COL_THREADS * j;
        bool ok = kpos < t;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        live[j] = ok;
        sv[i][j] *= scale;
        if (ok) mx = fmaxf(mx, sv[i][j]);
      }
      // the 8 lanes sharing this row are consecutive lanes of one warp
#pragma unroll
      for (int o = 1; o < S_COL_THREADS; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < S_COLS; ++j) {
        const float p = live[j] ? expf(sv[i][j] - m_new) : 0.f;
        p_s[row * (BK + 1) + sc + S_COL_THREADS * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < S_COL_THREADS; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
      if (sc == 0) corr_s[row] = corr;
    }
    __syncthreads();                          // every read of K is done
    load_tile(kv_s, vh, kv_row, k_start, BK, t, d, ld);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < O_ROWS; ++i) {
      const float corr = corr_s[pr * O_ROWS + i];
#pragma unroll
      for (int j = 0; j < O_COLS; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[O_COLS];
#pragma unroll
      for (int j = 0; j < O_COLS; ++j) {
        const int c = pc + O_COL_THREADS * j;
        vv[j] = c < d ? kv_s[kk * ld + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < O_ROWS; ++i) {
        const float p = p_s[(pr * O_ROWS + i) * (BK + 1) + kk];
#pragma unroll
        for (int j = 0; j < O_COLS; ++j) acc[i][j] += p * vv[j];
      }
    }
  }

  if (sc == 0) {
#pragma unroll
    for (int i = 0; i < S_ROWS; ++i) l_s[sr * S_ROWS + i] = l[i];
  }
  __syncthreads();
  T* oh = out + ((size_t)b * s * hq + h) * d;
#pragma unroll
  for (int i = 0; i < O_ROWS; ++i) {
    const int row = pr * O_ROWS + i;
    if (q_start + row >= s) continue;
    const float li = l_s[row];
    const float inv = 1.f / (li == 0.f ? 1.f : li);
#pragma unroll
    for (int j = 0; j < O_COLS; ++j) {
      const int c = pc + O_COL_THREADS * j;
      if (c < d)
        oh[(size_t)(q_start + row) * q_row + c] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int t, int hq, int hkv, int d, int causal, int window,
           void* stream) {
  // acc and the shared tiles are sized by MAX_D
  if (b < 0 || s < 0 || t < 0 || hkv < 1 || hq < 1 || hq % hkv != 0 ||
      d < 1 || d > MAX_D || (s + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0) return (int)cudaGetLastError();
  const size_t bytes = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)d));
  dim3 grid(b * hq, (s + BQ - 1) / BQ);
  flash_fwd_kernel<T><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, s, t, hq, hkv, d,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int b, int s,
                                   int t, int hq, int hkv, int d, int causal,
                                   int window, void* stream) {
  return launch<float>(q, k, v, out, b, s, t, hq, hkv, d, causal, window,
                       stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int b, int s,
                                    int t, int hq, int hkv, int d,
                                    int causal, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, b, s, t, hq, hkv, d, causal,
                               window, stream);
}
