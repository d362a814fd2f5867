// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (:124, pallas_call :163, body _kernel :62-120): causal,
// windowed or non-causal GQA attention over a full sequence with an fp32
// online softmax. The TPU kernel runs the kv axis as the sequential third
// grid dimension with m, l and acc carried in VMEM scratch; Hopper's
// blocks run in no order, so here the kv axis is a loop inside one block.
//
// Bound. At the training shape (B = 1, S = T = 4096, Hq/Hkv = 40/8, D = 128,
// causal, bf16) the function does 4 * Hq * D * S (S + 1) / 2 = 172 GFLOP
// against 101 MB of q, k, v and out: far above the ~295 flop/byte ridge, so
// the tensor cores bound it, 0.174 ms at 989 TFLOP/s. Under this design's
// split of P (below) the tensor cores do 1.5x that work: 0.26 ms.
//
// bf16 path (flash_fwd_wgmma_kernel). The earlier design ran both
// products as fp32 FMAs on the CUDA cores out of shared memory, bounded by
// the 67 TFLOP/s fp32 rate: 9.68-9.77 ms at the training shape on an NVIDIA
// H100 80GB HBM3 at 700.00 W, 31.5x behind SDPA's 0.31 ms. Now:
//   - one block per (batch * query head, 128-row q tile): two consumer
//     warpgroups of 64 rows each and one producer warpgroup whose one
//     thread issues TMA (its registers handed to the consumers with
//     setmaxnreg);
//   - Q arrives once; K and V tiles of 128 keys arrive by TMA into a ring
//     of 3 stages (a full barrier each for K and V, one empty barrier freed
//     by both consumers), 128-byte swizzled, D padded to the compile-time
//     tile (64 or 128) by TMA's zero fill past D (hopper.cuh's layouts);
//   - the consumers take turns on the tensor cores (two named barriers):
//     a turn issues S of tile j + 1 and P.V of tile j back to back, and
//     the softmax of tile j + 1 runs while the other warpgroup's turn keeps
//     the tensor cores busy (no register of an in-flight wgmma is read:
//     ptxas would serialize every wgmma otherwise);
//   - S = Q K^T on wgmma, both operands K-major in shared memory, fp32
//     accumulators in registers (bf16 x bf16 products are exact in fp32);
//   - online softmax on the accumulator's registers: each row lives in the
//     4 lanes of a quad, so row max and sum reduce over 2 shuffles; masks
//     (T tail, causal edge, window edge) only on tiles that cross one;
//   - P stays fp32 for P.V, as the Pallas body keeps it (p.astype(v.dtype)
//     with v upcast, :87-89, :110-113): P = P_hi + P_lo with P_hi = bf16(P)
//     and P_lo = bf16(P - P_hi), and two register-A wgmmas P_hi.V + P_lo.V
//     into one accumulator, V MN-major in shared memory. That leaves ~2^-17
//     of P's relative error, inside the one-ulp bf16 check; it costs the
//     1.5x above. bf16(P) alone would round P to 8 bits;
//   - tiles wholly past the causal edge or before the window are never
//     loaded; q tiles go heaviest first; the rep query heads of one kv head
//     are neighbouring blocks, so their K/V tiles come from L2;
//   - a row with no live key writes 0 (the Pallas safe_l, :117-119).
// Shared memory at D = 128: Q 32 KB + 3 stages x (K + V) 192 KB = 225 KB
// with the 1 KB of alignment slack.
//
// fp32 path (flash_fwd_kernel<float>, the parity runs): the earlier
// design, one block per (batch * query head, 64-row q tile), fp32 FMAs from
// shared memory, m and l in registers, the K then V tile through one
// buffer.
//
// Shapes: q (B, S, Hq, D), k and v (B, T, Hkv, D), out (B, S, Hq, D), all
// contiguous; query head h reads kv head h / (Hq / Hkv) in place (no repeat
// in HBM). Limits, checked by the C entries, which return
// cudaErrorInvalidValue and launch nothing past them: Hq % Hkv == 0, the
// grid's y extent ceil(S / rows a block) <= 65535; fp32 1 <= D <= 128;
// bf16 D a multiple of 8 in [8, 128] and 16-byte aligned bases (TMA's
// stride and address rules).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

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
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

namespace tc {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int BM = 128;                // q rows a block, 64 a warpgroup
constexpr int BN = 128;                // keys a kv tile
constexpr int STAGES = 3;
constexpr int THREADS = 384;           // 2 consumer warpgroups + producer
constexpr int TURN = 1;                // named barriers TURN + warpgroup
constexpr int Q_BOX = 64 * 128;        // bytes: 64 rows x 64 bf16
constexpr int KV_BOX = BN * 128;       // bytes: BN rows x 64 bf16

template <int DT>                      // D tile: 64 or 128
struct Layout {
  static constexpr int NC = DT / 64;                   // 64-wide D boxes
  static constexpr int Q_BYTES = 2 * NC * Q_BOX;
  static constexpr int KV_BYTES = NC * KV_BOX;         // one K or V stage
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int R>
__device__ __forceinline__ void zero(float (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = 0.f;
}

// S (64 x BN) = Q K^T: 16-deep slices of D, 4 to a 64-wide box; both
// operands K-major
template <int DT>
__device__ __forceinline__ void issue_s(float (&sacc)[BN / 2],
                                        const uint8_t* q_s,
                                        const uint8_t* k_s) {
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk) {
    const int c = kk / 4, w = kk % 4;
    wgmma_ss_n128<0>(sacc, desc_sw128(q_s + c * Q_BOX + 32 * w, 16, 1024),
                     desc_sw128(k_s + c * KV_BOX + 32 * w, 16, 1024));
  }
}

// O (64 x DT) += P_hi V + P_lo V: 16-key slices of the V tile (MN-major)
template <int DT>
__device__ __forceinline__ void issue_pv(float (&o)[DT / 2],
                                         const uint32_t (&p_hi)[BN / 16][4],
                                         const uint32_t (&p_lo)[BN / 16][4],
                                         const uint8_t* v_s) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t dv = desc_sw128(v_s + 2048 * kk, KV_BOX, 1024);
    if constexpr (DT == 128) {
      wgmma_rs_n128(o, p_hi[kk], dv);
      wgmma_rs_n128(o, p_lo[kk], dv);
    } else {
      wgmma_rs_n64(o, p_hi[kk], dv);
      wgmma_rs_n64(o, p_lo[kk], dv);
    }
  }
}

// P = P_hi + P_lo as bf16 register fragments (the accumulator's pattern)
__device__ __forceinline__ void split_p(const float (&p)[BN / 2],
                                        uint32_t (&p_hi)[BN / 16][4],
                                        uint32_t (&p_lo)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float x = p[8 * kk + 2 * w], y = p[8 * kk + 2 * w + 1];
      const uint32_t hi = pack_bf16(x, y);
      const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&hi);
      p_hi[kk][w] = hi;
      p_lo[kk][w] = pack_bf16(x - __low2float(hb), y - __high2float(hb));
    }
}

// keep fragments in their registers until the wgmmas reading them are done
__device__ __forceinline__ void keep_regs(uint32_t (&a)[BN / 16][4],
                                          uint32_t (&b)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w)
      asm volatile("" : "+r"(a[kk][w]), "+r"(b[kk][w]));
}

// One thread's rows (row0, row0 + 8) of a warpgroup's 64 q rows.
struct Tile {
  int row0, col0, qmin, t, causal, window;
  float scale_log2;

  // Online softmax of the S tile at keys k0 .. k0 + BN - 1, in place (S ->
  // P) and in the log2 domain: m and l updated, corr = exp2(m_old - m_new)
  // for the caller's O. Each row lives in the 4 lanes of a quad; masks
  // only where the tile crosses the T tail, the causal or the window edge.
  __device__ __forceinline__ void softmax(float (&s)[BN / 2], float (&m)[2],
                                          float (&l)[2], float (&corr)[2],
                                          int k0) const {
    const bool edge = k0 + BN > t || (causal && k0 + BN - 1 > qmin) ||
                      (window > 0 && k0 <= qmin + 63 - window);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = row0 + 8 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sv = s[4 * j + 2 * i + e] * scale_log2;
          if (edge) {
            const int kpos = k0 + 8 * j + col0 + e;
            bool ok = kpos < t;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            sv = ok ? sv : -INFINITY;            // p = exp2(-inf) = 0
          }
          s[4 * j + 2 * i + e] = sv;
          mx = fmaxf(mx, sv);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[i] = exp2f(m[i] - mx);                // m starts finite: no NaN
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * j + 2 * i + e] - mx);
          s[4 * j + 2 * i + e] = p;
          sum += p;
        }
      l[i] = l[i] * corr[i] + sum;
      m[i] = mx;
    }
  }
};

template <int DT>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       bf16* __restrict__ out, int s, int t, int hq, int hkv,
                       int d, int causal, int window, float scale_log2) {
  using L = Layout<DT>;
  constexpr int NC = L::NC;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms repeat every 1024 bytes: align the tiles to it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;                           // [wg][chunk] 8 KB boxes
  uint8_t* k_s = q_s + L::Q_BYTES;               // [stage][chunk] 16 KB
  uint8_t* v_s = k_s + STAGES * L::KV_BYTES;
  __shared__ __align__(8) uint64_t q_full, k_full[STAGES], v_full[STAGES],
      kv_empty[STAGES];

  const int bh = blockIdx.x;                     // batch * hq + query head
  const int b = bh / hq, h = bh % hq;
  const int g = h / (hq / hkv);                  // its kv head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest first
  // kv tiles holding a live key for some row of this q tile
  const int k_end = causal ? min(t, q0 + BM) : t;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BN * BN : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&kv_empty[i], 2);                // one arrival a consumer
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------ producer
    reg_dealloc<40>();
    if (threadIdx.x == 256) {
      mbar_expect(&q_full, L::Q_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NC; ++c)
          tma_load_4d(q_s + (w * NC + c) * Q_BOX, &map_q, &q_full, c * 64, h,
                      q0 + 64 * w, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int k0 = k_begin + it * BN;
        mbar_wait(&kv_empty[st], ph ^ 1);        // round 0 passes at once
        mbar_expect(&k_full[st], L::KV_BYTES);
        for (int c = 0; c < NC; ++c)
          tma_load_4d(k_s + st * L::KV_BYTES + c * KV_BOX, &map_k,
                      &k_full[st], c * 64, g, k0, b);
        mbar_expect(&v_full[st], L::KV_BYTES);
        for (int c = 0; c < NC; ++c)
          tma_load_4d(v_s + st * L::KV_BYTES + c * KV_BOX, &map_v,
                      &v_full[st], c * 64, g, k0, b);
      }
    }
  } else {
    // ----------------------------------------------------- consumers
    reg_alloc<232>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int qmin = q0 + 64 * wg;               // this warpgroup's rows
    const int row0 = qmin + 16 * (tid / 32) + lane / 4;   // and row0 + 8
    const int col0 = 2 * (lane % 4);             // + 8 j + e
    const Tile tile{row0, col0, qmin, t, causal, window, scale_log2};
    float o[DT / 2];
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) o[i] = 0.f;
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};   // l: this lane's
    float sacc[BN / 2], corr[2];
    uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];
    mbar_wait(&q_full, 0);
    if (n_tiles > 0) {
      // The two warpgroups take turns on the tensor cores: a turn issues
      // S of the next tile and P.V of this one, then hands over, and the
      // softmax runs while the other warpgroup's turn keeps the tensor
      // cores busy. Warpgroup 0 goes first.
      const int other = 1 - wg;
      if (wg == 1) bar_arrive(TURN, 256);
      bar_sync(TURN + wg, 256);
      zero(sacc);
      mbar_wait(&k_full[0], 0);
      fence_regs(sacc);
      wgmma_fence();
      issue_s<DT>(sacc, q_s + wg * NC * Q_BOX, k_s);
      wgmma_commit();
      bar_arrive(TURN + other, 256);
      wgmma_wait<0>();
      fence_regs(sacc);
      tile.softmax(sacc, m, l, corr, k_begin);
      split_p(sacc, p_hi, p_lo);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        const bool next = it + 1 < n_tiles;
        const int st1 = (it + 1) % STAGES;
        bar_sync(TURN + wg, 256);
        if (next) {                              // S = Q K^T, tile it + 1
          zero(sacc);
          mbar_wait(&k_full[st1], ((it + 1) / STAGES) & 1);
          fence_regs(sacc);
          wgmma_fence();
          issue_s<DT>(sacc, q_s + wg * NC * Q_BOX, k_s + st1 * L::KV_BYTES);
          wgmma_commit();
        }
        mbar_wait(&v_full[st], (it / STAGES) & 1);   // O += P V, tile it
        fence_regs(o);
        wgmma_fence();
        issue_pv<DT>(o, p_hi, p_lo, v_s + st * L::KV_BYTES);
        wgmma_commit();
        if (wg == 0 || next) bar_arrive(TURN + other, 256);  // pairs up
        // both groups done before any register of theirs is read: reading
        // S while P V is in flight would make ptxas serialize every wgmma
        wgmma_wait<0>();
        fence_regs(sacc);
        fence_regs(o);
        keep_regs(p_hi, p_lo);                   // read by the P V wgmmas
        if (tid == 0) mbar_arrive(&kv_empty[st]);  // this warpgroup is done
        if (next) {
          tile.softmax(sacc, m, l, corr, k_begin + (it + 1) * BN);
#pragma unroll
          for (int j = 0; j < DT / 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              o[4 * j + 2 * i] *= corr[i];
              o[4 * j + 2 * i + 1] *= corr[i];
            }
          split_p(sacc, p_hi, p_lo);
        }
      }
    }

    // out = acc / l, l == 0 read as 1 (safe_l): a row with no live key
    // writes 0; columns past D are never stored
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const float inv = 1.f / (li == 0.f ? 1.f : li);
      const int qpos = row0 + 8 * i;
      if (qpos >= s) continue;
      bf16* orow = out + (((size_t)b * s + qpos) * hq + h) * d;
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        const int c = 8 * j + col0;
        if (c < d)
          *reinterpret_cast<uint32_t*>(orow + c) =
              pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

template <int DT>
int launch_dt(const void* q, const void* k, const void* v, void* out, int b,
           int s, int t, int hq, int hkv, int d, int causal, int window,
           cudaStream_t stream) {
  const uint64_t e = sizeof(bf16);
  CUtensorMap mq, mk, mv;
  // (D, heads, positions, batch), innermost first; boxes of 64 D-values
  // by one head by 64 (q) or BN (k, v) positions
  const uint64_t qd[4] = {(uint64_t)d, (uint64_t)hq, (uint64_t)s,
                          (uint64_t)b};
  const uint64_t qs[3] = {d * e, hq * d * e, (uint64_t)s * hq * d * e};
  const uint64_t kd[4] = {(uint64_t)d, (uint64_t)hkv, (uint64_t)t,
                          (uint64_t)b};
  const uint64_t ks[3] = {d * e, hkv * d * e, (uint64_t)t * hkv * d * e};
  const uint32_t qbox[4] = {64, 1, 64, 1}, kbox[4] = {64, 1, BN, 1};
  if (!make_map(&mq, q, 4, qd, qs, qbox) ||
      !make_map(&mk, k, 4, kd, ks, kbox) ||
      !make_map(&mv, v, 4, kd, ks, kbox))
    return (int)cudaErrorInvalidValue;
  const int bytes = Layout<DT>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)d));
  dim3 grid(b * hq, (s + BM - 1) / BM);
  flash_fwd_wgmma_kernel<DT><<<grid, THREADS, bytes, stream>>>(
      mq, mk, mv, (bf16*)out, s, t, hq, hkv, d, causal, window, scale_log2);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int b, int s, int t, int hq, int hkv, int d, int causal,
                int window, void* stream) {
  if (b < 0 || s < 0 || t < 0 || hkv < 1 || hq < 1 || hq % hkv != 0 ||
      d < 8 || d > 128 || d % 8 != 0 || (s + BM - 1) / BM > 65535 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (t == 0) {                       // no key at all: every row writes 0
    cudaMemsetAsync(out, 0, (size_t)b * s * hq * d * sizeof(bf16), st);
    return (int)cudaGetLastError();
  }
  return d <= 64 ? launch_dt<64>(q, k, v, out, b, s, t, hq, hkv, d, causal,
                                 window, st)
                 : launch_dt<128>(q, k, v, out, b, s, t, hq, hkv, d,
                                  causal, window, st);
}

}  // namespace tc

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
  return tc::launch_bf16(q, k, v, out, b, s, t, hq, hkv, d, causal, window,
                         stream);
}
