// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _kernel): per (batch, head), walk the chunks of q rows in order and, per
// chunk, with la = dt * A and cum = cumsum(la) over the chunk,
//   intra:  y  = (tril(C B^T) o exp(cum_i - cum_j)) . (x o dt)
//   inter:  y += exp(cum) o (C . h)
//   state:  h  = exp(cum_last) h + sum_j exp(cum_last - cum_j) B_j (x o dt)_j
// with one B/C group shared by all heads, every product and sum in fp32, and
// y cast to x's dtype. The final state h is also written out, transposed to
// (b, h, p, n) fp32: ssd_chunked's second result, which prefill stores in
// the decode cache (the Pallas kernel keeps it in VMEM scratch only).
//
// Design. The Pallas grid is (b * h, chunks) with the chunk axis sequential
// and the (n, p) state carried in VMEM between grid steps. Blocks on Hopper
// run in no order, so the chunk axis becomes a loop inside ONE block per
// (batch, head), with the state resident in shared memory (32.5 KB at
// n = 128, p = 64, one padded column so the transposed write-out hits
// distinct banks). Per chunk the block stages B and C in their input dtype
// (bf16: 65 KB for both at q = n = 128), x * dt in fp32 and the chunk's
// cumulative log-decay; the (q, q) masked score matrix is never held whole:
// it is built 32 rows at a time (16.5 KB), each row tile immediately
// consumed by its y rows. Per row tile:
//   1. scores: thread (ty, tx) computes rows ty*4 .. ty*4+3 of the tile and
//      columns tx + 32 c of C . B^T; column groups wholly past the tile's
//      last row are skipped (warp-uniform);
//   2. mask: entry (i, j) is exp(cum_i - cum_j) * score for j <= i and 0
//      otherwise, by select (never a 0/1 multiply: for i < j the exponent is
//      positive and exp may overflow, and inf * 0 is NaN);
//   3. y rows: the intra term over j <= the tile's last row, plus exp(cum_i)
//      times C_i . h from the state of the previous chunks.
// Then the state update over the whole chunk, and the next chunk. cumsum is
// taken by one thread in row order, so it rounds exactly as a sequential
// fp32 cumsum does. Every tile is bounded by q, so a ragged chunk (q = 77
// for a 77-token prompt) needs no padding. x, B, C and dt are read in place
// through their strides: x may be the (b, s, h, p) view of the conv output
// (row stride din + 2n), B and C its (b, s, n) column slices; nothing is
// transposed or broadcast per head in HBM.
//
// Bound. At the serving path's prefill (b = 1, s = 1024, h = 48, p = 64,
// n = 128, q = 128, bf16) the function reads x, B, C, dt once and writes y
// and the final state once, ~15 MB: ~4.5 us at 3.35 TB/s, against ~2 GFLOP
// (~2 us at the bf16 tensor-core peak), so bytes bound it. This simple
// kernel does every product with fp32 FMAs from shared memory on the CUDA
// cores, and one block per (batch, head) puts only b * h = 48 blocks on the
// 132 SMs at b = 1: it is bounded by one SM's fp32 FMA and shared-memory
// rate per head. Splitting it into chunk-state, state-passing and
// chunk-scan passes (parallel over chunks) and wgmma for the products are
// later work.
//
// Shapes: x (b, s, h, p) with channel stride 1 and head stride p; dt (b, s, h)
// fp32 with head stride 1; A (h,) fp32; B and C (b, s, n) with stride 1 along
// n; y (b, s, h, p) contiguous in x's dtype; h_last (b, h, p, n) contiguous
// fp32. Limits: 1 <= q <= MAX_Q, s % q == 0, 1 <= n <= MAX_N, 1 <= p <= MAX_P;
// the C entry checks them and returns cudaErrorInvalidValue, launching
// nothing, otherwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;           // 8 warps
constexpr int MAX_Q = 128;             // rows a chunk
constexpr int MAX_N = 128;             // state size
constexpr int MAX_P = 64;              // channels a head
constexpr int R = 32;                  // rows of a score tile
constexpr int ROWS_T = 4;              // tile rows a thread: ty * 4 + a
constexpr int COLS_T = MAX_Q / 32;     // score columns a thread: tx + 32 c
constexpr int P_T = MAX_P / 32;        // channels a thread: tx + 32 c
constexpr int N_T = MAX_N / 8;         // state rows a thread: ty + 8 i

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

// Row stride of the staged B and C tiles, in elements: an odd number of
// 32-bit words, so the 32 lanes reading 32 different rows hit 32 banks.
__host__ __device__ __forceinline__ int bc_ld(int n, int esize) {
  return n + (esize == 2 ? 2 : 1);
}

size_t smem_bytes(int q, int n, int p, int esize) {
  return sizeof(float) * ((size_t)n * (p + 1)       // state h
                          + (size_t)q * p           // x * dt
                          + (size_t)R * (q + 1)     // a row tile of scores
                          + 2 * (size_t)q)          // cum, decay weights
         + (size_t)esize * 2 * q * bc_ld(n, esize); // B, C
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ C, T* __restrict__ y,
                float* __restrict__ h_last, int s, int h, int p, int n, int q,
                long long sxb, long long sxs, long long sdb, long long sds,
                long long sbb, long long sbs, long long scb, long long scs) {
  extern __shared__ float smem[];
  const int ldh = p + 1;
  const int lds = q + 1;
  const int ldbc = bc_ld(n, (int)sizeof(T));
  float* h_s = smem;                          // (n, ldh): h_s[k * ldh + c]
  float* xdt_s = h_s + n * ldh;               // (q, p)
  float* s_s = xdt_s + q * p;                 // (R, lds)
  float* cum_s = s_s + R * lds;               // (q)
  float* w_s = cum_s + q;                     // (q): dt, then exp(cl - cum)
  T* b_s = reinterpret_cast<T*>(w_s + q);     // (q, ldbc)
  T* c_s = b_s + q * ldbc;                    // (q, ldbc)

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
  const float a_h = A[hh];
  const T* xb = x + b * sxb + (long long)hh * p;
  const float* dtb = dt + b * sdb + hh;
  const T* bb = B + b * sbb;
  const T* cb = C + b * scb;
  const long long y_row = (long long)h * p;
  T* yb = y + ((long long)b * s * h + hh) * p;

  for (int i = tid; i < n * ldh; i += THREADS) h_s[i] = 0.f;

  for (int t0 = 0; t0 < s; t0 += q) {
    __syncthreads();          // the previous chunk is done with every tile
    for (int i = tid; i < q; i += THREADS)
      w_s[i] = dtb[(long long)(t0 + i) * sds];
    for (int i = tid; i < q * n; i += THREADS) {
      const int r = i / n, k = i % n;
      b_s[r * ldbc + k] = bb[(long long)(t0 + r) * sbs + k];
      c_s[r * ldbc + k] = cb[(long long)(t0 + r) * scs + k];
    }
    __syncthreads();
    for (int i = tid; i < q * p; i += THREADS) {
      const int r = i / p, c = i % p;
      xdt_s[i] = to_f32(xb[(long long)(t0 + r) * sxs + c]) * w_s[r];
    }
    if (tid == 0) {                           // sequential fp32 cumsum
      float acc = 0.f;
      for (int r = 0; r < q; ++r) {
        acc += w_s[r] * a_h;
        cum_s[r] = acc;
      }
    }
    __syncthreads();
    const float cum_last = cum_s[q - 1];
    for (int i = tid; i < q; i += THREADS) w_s[i] = expf(cum_last - cum_s[i]);

    for (int r0 = 0; r0 < q; r0 += R) {
      const int cols = min(q, r0 + R);        // columns live for these rows
      __syncthreads();                        // s_s is free again
      {
        int rowc[ROWS_T], colc[COLS_T];
#pragma unroll
        for (int a = 0; a < ROWS_T; ++a)
          rowc[a] = min(r0 + ty * ROWS_T + a, q - 1);
#pragma unroll
        for (int c = 0; c < COLS_T; ++c) colc[c] = min(tx + 32 * c, q - 1);
        float acc[ROWS_T][COLS_T];
#pragma unroll
        for (int a = 0; a < ROWS_T; ++a)
#pragma unroll
          for (int c = 0; c < COLS_T; ++c) acc[a][c] = 0.f;
#pragma unroll 2
        for (int k = 0; k < n; ++k) {
          float cv[ROWS_T];
#pragma unroll
          for (int a = 0; a < ROWS_T; ++a) cv[a] = to_f32(c_s[rowc[a] * ldbc + k]);
#pragma unroll
          for (int c = 0; c < COLS_T; ++c) {
            if (32 * c < cols) {              // warp-uniform
              const float bv = to_f32(b_s[colc[c] * ldbc + k]);
#pragma unroll
              for (int a = 0; a < ROWS_T; ++a) acc[a][c] += cv[a] * bv;
            }
          }
        }
#pragma unroll
        for (int a = 0; a < ROWS_T; ++a) {
          const int rr = ty * ROWS_T + a, row = r0 + rr;
#pragma unroll
          for (int c = 0; c < COLS_T; ++c) {
            const int j = tx + 32 * c;
            if (j < cols)
              s_s[rr * lds + j] = (row < q && j <= row)
                  ? acc[a][c] * expf(cum_s[row] - cum_s[j]) : 0.f;
          }
        }
      }
      __syncthreads();
      {
        int chc[P_T];
#pragma unroll
        for (int c = 0; c < P_T; ++c) chc[c] = min(tx + 32 * c, p - 1);
        float intra[ROWS_T][P_T], inter[ROWS_T][P_T];
#pragma unroll
        for (int a = 0; a < ROWS_T; ++a)
#pragma unroll
          for (int c = 0; c < P_T; ++c) intra[a][c] = inter[a][c] = 0.f;
#pragma unroll 2
        for (int j = 0; j < cols; ++j) {
          float xv[P_T];
#pragma unroll
          for (int c = 0; c < P_T; ++c) xv[c] = xdt_s[j * p + chc[c]];
#pragma unroll
          for (int a = 0; a < ROWS_T; ++a) {
            const float sv = s_s[(ty * ROWS_T + a) * lds + j];
#pragma unroll
            for (int c = 0; c < P_T; ++c) intra[a][c] += sv * xv[c];
          }
        }
        int rowc[ROWS_T];
#pragma unroll
        for (int a = 0; a < ROWS_T; ++a)
          rowc[a] = min(r0 + ty * ROWS_T + a, q - 1);
#pragma unroll 2
        for (int k = 0; k < n; ++k) {
          float hv[P_T];
#pragma unroll
          for (int c = 0; c < P_T; ++c) hv[c] = h_s[k * ldh + chc[c]];
#pragma unroll
          for (int a = 0; a < ROWS_T; ++a) {
            const float cv = to_f32(c_s[rowc[a] * ldbc + k]);
#pragma unroll
            for (int c = 0; c < P_T; ++c) inter[a][c] += cv * hv[c];
          }
        }
#pragma unroll
        for (int a = 0; a < ROWS_T; ++a) {
          const int row = r0 + ty * ROWS_T + a;
          if (row >= q) continue;
          const float e = expf(cum_s[row]);
#pragma unroll
          for (int c = 0; c < P_T; ++c) {
            const int ch = tx + 32 * c;
            if (ch < p)
              yb[(long long)(t0 + row) * y_row + ch] =
                  from_f32<T>(intra[a][c] + e * inter[a][c]);
          }
        }
      }
    }

    __syncthreads();          // every read of the old state is done
    {
      const float decay = expf(cum_last);
      int chc[P_T];
#pragma unroll
      for (int c = 0; c < P_T; ++c) chc[c] = min(tx + 32 * c, p - 1);
      float acc[N_T][P_T];
#pragma unroll
      for (int i = 0; i < N_T; ++i)
#pragma unroll
        for (int c = 0; c < P_T; ++c) acc[i][c] = 0.f;
#pragma unroll 2
      for (int j = 0; j < q; ++j) {
        const float wj = w_s[j];
        float xv[P_T];
#pragma unroll
        for (int c = 0; c < P_T; ++c) xv[c] = wj * xdt_s[j * p + chc[c]];
#pragma unroll
        for (int i = 0; i < N_T; ++i) {
          const int k = ty + 8 * i;
          if (k < n) {
            const float bv = to_f32(b_s[j * ldbc + k]);
#pragma unroll
            for (int c = 0; c < P_T; ++c) acc[i][c] += bv * xv[c];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < N_T; ++i) {
        const int k = ty + 8 * i;
#pragma unroll
        for (int c = 0; c < P_T; ++c) {
          const int ch = tx + 32 * c;
          if (k < n && ch < p)
            h_s[k * ldh + ch] = decay * h_s[k * ldh + ch] + acc[i][c];
        }
      }
    }
  }

  __syncthreads();
  float* hl = h_last + (long long)bh * p * n;  // (p, n) of this (b, h)
  for (int i = tid; i < p * n; i += THREADS) {
    const int c = i / n, k = i % n;
    hl[i] = h_s[k * ldh + c];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* h_last, int b, int s, int h, int p,
           int n, int q, long long sxb, long long sxs, long long sdb,
           long long sds, long long sbb, long long sbs, long long scb,
           long long scs, void* stream) {
  // the register tiles and the shared-memory budget are sized by MAX_*
  if (b < 0 || s < 0 || h < 1 || p < 1 || p > MAX_P || n < 1 || n > MAX_N ||
      q < 1 || q > MAX_Q || (s > 0 && s % q != 0) ||
      (long long)b * h > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0) return (int)cudaGetLastError();
  const size_t bytes = smem_bytes(q, n, p, (int)sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<b * h, THREADS, bytes, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B,
      (const T*)C, (T*)y, (float*)h_last, s, h, p, n, q, sxb, sxs, sdb, sds,
      sbb, sbs, scb, scs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, void* y,
                            void* h_last, int b, int s, int h, int p, int n,
                            int q, long long sxb, long long sxs,
                            long long sdb, long long sds, long long sbb,
                            long long sbs, long long scb, long long scs,
                            void* stream) {
  return launch<float>(x, dt, A, B, C, y, h_last, b, s, h, p, n, q, sxb, sxs,
                       sdb, sds, sbb, sbs, scb, scs, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, void* y,
                             void* h_last, int b, int s, int h, int p, int n,
                             int q, long long sxb, long long sxs,
                             long long sdb, long long sds, long long sbb,
                             long long sbs, long long scb, long long scs,
                             void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, B, C, y, h_last, b, s, h, p, n, q,
                               sxb, sxs, sdb, sds, sbb, sbs, scb, scs, stream);
}
