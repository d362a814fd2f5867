// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan (:65,
// pallas_call :80, body _kernel): per (batch, head), walk the chunks of q
// rows in order and, per chunk, with la = dt * A and cum = cumsum(la) over
// the chunk,
//   intra:  y  = (tril(C B^T) o exp(cum_i - cum_j)) . (x o dt)
//   inter:  y += exp(cum) o (C . h)
//   state:  h  = exp(cum_last) h + sum_j exp(cum_last - cum_j) B_j (x o dt)_j
// with one B/C group shared by all heads, every product and sum in fp32, and
// y cast to x's dtype. The final state h is also written out as (b, h, p, n)
// fp32: ssd_chunked's second result, which prefill stores in the decode
// cache (the Pallas kernel keeps it in VMEM scratch only).
//
// Design. The earlier kernel ran the chunk axis as a loop in ONE block per
// (batch, head), the Pallas grid's sequential axis: 48 blocks on 132 SMs at
// the serving path's prefill, every product an fp32 FMA, C B^T recomputed by
// each of the 48 heads; 1.10 ms, slower than its plain version (0.86 ms;
// NVIDIA H100 80GB HBM3, 700.00 W). Now the chunk-parallel passes of the SSD
// algorithm (Mamba2, arXiv:2405.21060 section 6), four launches on one
// stream, with fp32 scratch in HBM (L2 at these sizes):
//   1. ssd_prep_kernel, grid (b, chunk, 32 x 32 tile): C B^T of the chunk,
//      once for all heads, (q, q) fp32, tiles past the diagonal skipped;
//      and, in the first tile's block, the cumulative log-decay of every
//      head, one thread a head walking the chunk in row order with
//      round-to-nearest products and sums, so it rounds exactly as a
//      sequential fp32 cumsum of dt * A does;
//   2. ssd_state_kernel, grid (b, chunk, head): the chunk's own state
//      sum_j exp(cum_last - cum_j) (x o dt)_j B_j^T, (p, n), each half of
//      the block summing half of the chunk's rows with 8 x 8 a thread in
//      registers, the halves added in a fixed order;
//   3. ssd_pass_kernel, grid (b, head, state elements): per element, the
//      short sequential scan over the chunks, h_in(c + 1) = exp(cum_last)
//      h_in(c) + state(c) (two roundings, as the plain version's mul then
//      add); it overwrites each chunk state with the state entering that
//      chunk and writes the final state;
//   4. ssd_chunk_scan_kernel, grid (b, chunk, head): the intra term from
//      the masked scores exp(cum_i - cum_j) C_i.B_j (by select for j > i:
//      there the exponent is positive and exp may overflow, and inf * 0 is
//      NaN), then the inter term exp(cum_i) C_i . h_in. Each thread holds 4
//      rows x 8 channels; the scores are staged transposed and the
//      channels padded to 8, so a step of the intra sum reads one float4 of
//      rows and two of channels for 32 FMAs (the inter sum: C's rows as
//      float4 over 4 state columns); causal columns past a warp's last row
//      are skipped.
// Each block stages its tiles in shared memory as fp32 with 16 loads of a
// thread in flight (one at a time, each store waits for its load), four
// elements a load where x, B and C start every row on a 16-byte (fp32) or
// 8-byte (bf16) boundary, as the conv output's views do; one element a
// load otherwise.
// Every product stays an fp32 FMA on the CUDA cores: the scores C B^T are
// 2q^2n flops a chunk, not a head, and the other products have an fp32
// operand (x o dt, the masked scores, the state; no tf32: the final state
// is held to 1e-4 of its largest value). Every sum has a fixed order: the
// same call gives the same bits. x, B, C and dt are read in place through
// their strides: x may be the (b, s, h, p) view of the conv output (row
// stride din + 2n), B and C its (b, s, n) column slices. Every tile is
// bounded by q, so a ragged chunk (q = 77 for a 77-token prompt) needs no
// padding.
//
// Bound. At the serving path's prefill (b = 1, s = 1024, h = 48, p = 64,
// n = 128, q = 128, bf16) the function reads x, B, C, dt once and writes y
// and the final state once, 14.9 MB: 4.4 us at 3.35 TB/s, against 2.0
// GFLOP (2.1 us at the bf16 tensor-core peak, 30 us at the 67 TFLOP/s fp32
// CUDA-core peak this design runs at); the chunk states and C B^T add ~13
// MB of scratch traffic, most of it in L2. Staging and the FMA loops,
// not bytes, set its time.
//
// Shapes: x (b, s, h, p) with channel stride 1 and head stride p; dt (b, s,
// h) fp32 with head stride 1; A (h,) fp32; B and C (b, s, n) with stride 1
// along n; y (b, s, h, p) contiguous in x's dtype; h_last (b, h, p, n)
// contiguous fp32; scratch fp32 of ssd_scan_scratch's size. Limits: 1 <= q
// <= MAX_Q, s % q == 0, 1 <= n <= MAX_N, 1 <= p <= MAX_P, each grid's blocks
// b * chunks * heads (and b * heads * state tiles) < 2^31; the C entries
// check them and return cudaErrorInvalidValue, launching nothing,
// otherwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;           // 8 warps
constexpr int MAX_Q = 128;             // rows a chunk
constexpr int MAX_N = 128;             // state size
constexpr int MAX_P = 64;              // channels a head
constexpr int RT = 32;                 // rows of a C B^T tile (pass 1)
constexpr int HG = 64;                 // heads a cumsum round (pass 1)

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

// an odd row stride >= n: 32 consecutive rows read at one column hit 32
// banks
__host__ __device__ __forceinline__ int odd_ld(int n) { return n | 1; }

// fp32 scratch: C B^T (b, nc, q, q), cum (b, s, h), chunk states (b, nc,
// h, p, n); returns the offsets of the last two and the total
__host__ __device__ __forceinline__ long long scratch_layout(
    int b, int s, int h, int p, int n, int q, long long* at_cum,
    long long* at_states) {
  const long long nc = s / q;
  *at_cum = (long long)b * nc * q * q;
  *at_states = *at_cum + (long long)b * s * h;
  return *at_states + (long long)b * nc * h * p * n;
}

size_t prep_smem(int q, int n) {
  return sizeof(float) * ((size_t)2 * RT * odd_ld(n) + (size_t)q * HG);
}
// channels padded to 8 (two float4 a thread), rows to 16 (a warp's rows)
__host__ __device__ __forceinline__ int pad8(int p) { return (p + 7) & ~7; }
__host__ __device__ __forceinline__ int pad16(int q) { return (q + 15) & ~15; }

// the state kernel's columns: n padded to 64 or 128
__host__ __device__ __forceinline__ int state_cols(int n) {
  return n <= 64 ? 64 : 128;
}

size_t state_smem(int q, int p, int n) {
  return sizeof(float) * ((size_t)q * pad8(p)
                          + (size_t)(q * state_cols(n) > 128 * 64
                                         ? q * state_cols(n) : 128 * 64)
                          + q);
}
// rows + 4 floats: a transposing write of 32 lanes falls in 8 banks, not
// 1, and rows stay 16-byte aligned
size_t scan_smem(int q, int p, int n) {
  const size_t n4 = (n + 3) & ~3;
  return sizeof(float) * ((size_t)q * (pad16(q) + 4) + (size_t)q * pad8(p)
                          + n4 * (pad8(p) + 4) + pad16(q) * (n4 + 4) + q);
}

// Copy a (rows x cols) tile, cols <= 128, global -> shared without an
// integer division: thread (ty, tx) of the 8 x 32 block takes rows ty + 8 a
// and columns tx + 32 m, 16 loads in flight (one at a time, each store
// would wait for its load before the next load issues). load(r, c) and
// store(r, c, v).
template <typename Load, typename Store>
__device__ __forceinline__ void stage(int rows, int cols, Load load,
                                      Store store) {
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  // column groups of 32 in use: 1, 2 or 4 (2^lg)
  const int lg = cols <= 32 ? 0 : cols <= 64 ? 1 : 2;
  const int mask = (1 << lg) - 1;
  for (int r0 = ty; r0 < rows; r0 += 8 * (16 >> lg)) {
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = r0 + 8 * (i >> lg), c = tx + 32 * (i & mask);
      v[i] = r < rows && c < cols ? load(r, c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = r0 + 8 * (i >> lg), c = tx + 32 * (i & mask);
      if (r < rows && c < cols) store(r, c, v[i]);
    }
  }
}

// As stage, 4 consecutive columns at a time (cols % 4 == 0, cols <= 128,
// each group of 4 aligned in global and shared memory): 8 vector loads of
// a thread in flight. load(r, c) -> float4 of columns c .. c + 3; store(r,
// c, v).
template <typename Load, typename Store>
__device__ __forceinline__ void stage4(int rows, int cols, Load load,
                                       Store store) {
  const int groups = cols / 4;                  // <= 32 a row
  const int lg = groups <= 1 ? 0 : 32 - __clz(groups - 1);
  const int per = 32 >> lg;                     // rows a warp takes a step
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int c = 4 * (lane & ((1 << lg) - 1));
  const int step = 8 * per;                     // rows the block takes
  for (int r0 = w * per + (lane >> lg); r0 < rows; r0 += 8 * step) {
    float4 v[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int r = r0 + a * step;
      v[a] = r < rows && c < cols ? load(r, c)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int r = r0 + a * step;
      if (r < rows && c < cols) store(r, c, v[a]);
    }
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// ---- pass 1: C B^T a (batch, chunk), the cumulative log-decay
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_prep_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                const T* __restrict__ B, const T* __restrict__ C,
                float* __restrict__ cb, float* __restrict__ cum, int s, int h,
                int n, int q, long long sdb, long long sds, long long sbb,
                long long sbs, long long scb, long long scs) {
  extern __shared__ __align__(16) float smem[];
  const int ld = odd_ld(n);
  float* c_s = smem;                          // (RT, ld)
  float* b_s = c_s + RT * ld;                 // (RT, ld)
  const int nc = s / q;
  const int tiles = (q + RT - 1) / RT;
  const int ct = blockIdx.x % tiles;          // column tile (j)
  const int rt = (blockIdx.x / tiles) % tiles;  // row tile (i)
  const int c = (blockIdx.x / (tiles * tiles)) % nc;
  const int bb = blockIdx.x / (tiles * tiles * nc);
  const int t0 = c * q, i0 = rt * RT, j0 = ct * RT;
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;

  if (rt == 0 && ct == 0) {
    // dt of HG heads at a time into shared memory (coalesced), then one
    // thread a head walks the chunk from there
    float* dt_s = b_s + RT * ld;              // (q, HG)
    for (int h0 = 0; h0 < h; h0 += HG) {
      const int hn = min(HG, h - h0);
      stage(q, hn,
            [&](int r, int k) {
              return dt[bb * sdb + (long long)(t0 + r) * sds + h0 + k];
            },
            [&](int r, int k, float v) { dt_s[r * HG + k] = v; });
      __syncthreads();
      if (tid < hn) {
        const float a = A[h0 + tid];
        float* out = cum + ((long long)bb * s + t0) * h + h0 + tid;
        float acc = 0.f;
#pragma unroll 8
        for (int r = 0; r < q; ++r) {
          acc = __fadd_rn(acc, __fmul_rn(dt_s[r * HG + tid], a));
          out[(long long)r * h] = acc;
        }
      }
      __syncthreads();
    }
  }
  if (ct > rt) return;                        // j > i: never read
  const int rows = min(RT, q - i0), cols = min(RT, q - j0);
  const T* cg = C + bb * scb + (long long)(t0 + i0) * scs;
  const T* bg = B + bb * sbb + (long long)(t0 + j0) * sbs;
  stage(rows, n, [&](int r, int k) { return to_f32(cg[r * scs + k]); },
        [&](int r, int k, float v) { c_s[r * ld + k] = v; });
  stage(cols, n, [&](int r, int k) { return to_f32(bg[r * sbs + k]); },
        [&](int r, int k, float v) { b_s[r * ld + k] = v; });
  __syncthreads();
  // thread: rows ty * 4 + a (a warp's, broadcast), column tx
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int rc[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) rc[a] = min(ty * 4 + a, rows - 1);
  const int cc = min(tx, cols - 1);
#pragma unroll 8
  for (int k = 0; k < n; ++k) {
    const float bv = b_s[cc * ld + k];
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[a] += c_s[rc[a] * ld + k] * bv;
  }
  // stored transposed, (j, i): the chunk scan reads 4 rows i as one float4
  float* out = cb + ((long long)bb * nc + c) * q * q + (long long)j0 * q + i0;
  if (tx < cols) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (ty * 4 + a < rows) out[(long long)tx * q + ty * 4 + a] = acc[a];
  }
}

// ---- pass 2: each chunk's own state, (p, n). Thread (g, cg, ng) of the
// block sums rows j of half g of the chunk for channels cg * 8 + a and
// state columns ng * 4 + k and 64 + ng * 4 + k (of state_cols(n)): 4
// float4 loads a row for 64 FMAs; the two halves are added in a fixed
// order at the end.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const T* __restrict__ B, const float* __restrict__ cum,
                 float* __restrict__ states, int s, int h, int p, int n,
                 int q, long long sxb, long long sxs, long long sdb,
                 long long sds, long long sbb, long long sbs, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int p8 = pad8(p), nb = state_cols(n);
  float* xw_s = smem;                         // (q, p8): exp(cl - cum) x dt
  float* b_s = xw_s + q * p8;                 // (q, nb), later the halves'
  float* w_s = b_s + max(q * nb, 128 * 64);   // (q)          sum
  const int nc = s / q;
  const int hh = blockIdx.x % h;
  const int c = (blockIdx.x / h) % nc;
  const int bb = blockIdx.x / (h * nc);
  const int t0 = c * q;
  const int tid = threadIdx.x;
  const float* cumc = cum + ((long long)bb * s + t0) * h + hh;
  const float cl = cumc[(long long)(q - 1) * h];
  for (int j = tid; j < q; j += THREADS)
    w_s[j] = expf(cl - cumc[(long long)j * h]) *
             dt[bb * sdb + (long long)(t0 + j) * sds + hh];
  const T* bg = B + bb * sbb + (long long)t0 * sbs;
  __syncthreads();
  const T* xg = x + bb * sxb + (long long)t0 * sxs + (long long)hh * p;
  if (vec) {
    stage4(q, nb,
           [&](int j, int k) {
             return k < n ? load4(bg + j * sbs + k)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
           },
           [&](int j, int k, float4 v) { store4(b_s + j * nb + k, v); });
    stage4(q, p8,
           [&](int j, int ch) {
             return ch < p ? load4(xg + j * sxs + ch)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
           },
           [&](int j, int ch, float4 v) {
             const float w = w_s[j];
             store4(xw_s + j * p8 + ch,
                    make_float4(v.x * w, v.y * w, v.z * w, v.w * w));
           });
  } else {
    stage(q, nb,
          [&](int j, int k) { return k < n ? to_f32(bg[j * sbs + k]) : 0.f; },
          [&](int j, int k, float v) { b_s[j * nb + k] = v; });
    stage(q, p8,
          [&](int j, int ch) {
            return ch < p ? to_f32(xg[j * sxs + ch]) : 0.f;
          },
          [&](int j, int ch, float v) { xw_s[j * p8 + ch] = v * w_s[j]; });
  }
  __syncthreads();
  const int g = tid / 128, t = tid % 128;
  const int cg8 = (t / 16) * 8, n4 = (t % 16) * 4;
  const int jh = (q + 1) / 2, ja = g ? jh : 0, jb = g ? q : jh;
  const bool live = cg8 < p8, wide = nb > 64;
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[a][k] = 0.f;
  if (live) {
#pragma unroll 2
    for (int j = ja; j < jb; ++j) {
      const float4 x0 = *reinterpret_cast<const float4*>(xw_s + j * p8 + cg8);
      const float4 x1 =
          *reinterpret_cast<const float4*>(xw_s + j * p8 + cg8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + j * nb + n4);
      const float4 b1 = wide
          ? *reinterpret_cast<const float4*>(b_s + j * nb + 64 + n4)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[a][k] += xv[a] * bv[k];
    }
  }
  __syncthreads();                            // b_s is free: the halves' sum
  float* red = b_s;                           // (64, 128 threads)
  if (g == 1 && live) {
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int k = 0; k < 8; ++k) red[(a * 8 + k) * 128 + t] = acc[a][k];
  }
  __syncthreads();
  if (g == 1 || !live) return;
  float* out = states + (((long long)bb * nc + c) * h + hh) * p * n;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int ch = cg8 + a, col = (k < 4 ? 0 : 64) + n4 + k % 4;
      if (ch < p && col < n)
        out[(long long)ch * n + col] = acc[a][k] + red[(a * 8 + k) * 128 + t];
    }
}

// ---- pass 3: the state entering each chunk, and the final state; 4
// elements a thread, 8 chunks' loads in flight
constexpr int PASS_E = 4;
__global__ void __launch_bounds__(THREADS)
ssd_pass_kernel(const float* __restrict__ cum, float* __restrict__ states,
                float* __restrict__ h_last, int s, int h, int p, int n,
                int q) {
  const int pn = p * n;
  const int per = (pn + THREADS * PASS_E - 1) / (THREADS * PASS_E);
  const int e0 = ((blockIdx.x % per) * THREADS + threadIdx.x) * PASS_E;
  const int hh = (blockIdx.x / per) % h;
  const int bb = blockIdx.x / (per * h);
  if (e0 >= pn) return;
  const int nc = s / q;
  float hs[PASS_E] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float v[8][PASS_E], cl[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long long c = c0 + k;
      const float* st = states + (((long long)bb * nc + c) * h + hh) * pn + e0;
#pragma unroll
      for (int e = 0; e < PASS_E; ++e)
        v[k][e] = c < nc && e0 + e < pn ? st[e] : 0.f;
      cl[k] = c < nc ? cum[((long long)bb * s + c * q + q - 1) * h + hh]
                     : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long long c = c0 + k;
      if (c >= nc) break;
      float* st = states + (((long long)bb * nc + c) * h + hh) * pn + e0;
      const float decay = expf(cl[k]);
#pragma unroll
      for (int e = 0; e < PASS_E; ++e)
        if (e0 + e < pn) {
          st[e] = hs[e];
          hs[e] = __fadd_rn(__fmul_rn(decay, hs[e]), v[k][e]);
        }
    }
  }
  float* out = h_last + ((long long)bb * h + hh) * pn + e0;
#pragma unroll
  for (int e = 0; e < PASS_E; ++e)
    if (e0 + e < pn) out[e] = hs[e];
}

// ---- pass 4: y of a (batch, chunk, head)
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ C, const float* __restrict__ cbt,
                      const float* __restrict__ cum,
                      const float* __restrict__ states, T* __restrict__ y,
                      int s, int h, int p, int n, int q, long long sxb,
                      long long sxs, long long sdb, long long sds,
                      long long scb, long long scs, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int lq = pad16(q) + 4, p8 = pad8(p), lh = p8 + 4;
  const int n4 = (n + 3) & ~3, ldc = n4 + 4;
  float* att_s = smem;                        // (j, lq): masked scores^T
  float* xdt_s = att_s + q * lq;              // (q, p8)
  float* ht_s = xdt_s + q * p8;               // (n4, lh): entering state^T
  float* c_s = ht_s + n4 * lh;                // (pad16(q), ldc): C
  float* cum_s = c_s + pad16(q) * ldc;        // (q)
  const int nc = s / q;
  const int hh = blockIdx.x % h;
  const int c = (blockIdx.x / h) % nc;
  const int bb = blockIdx.x / (h * nc);
  const int t0 = c * q;
  const int tid = threadIdx.x;

  const float* cumc = cum + ((long long)bb * s + t0) * h + hh;
  for (int j = tid; j < q; j += THREADS) cum_s[j] = cumc[(long long)j * h];
  const float* st = states + (((long long)bb * nc + c) * h + hh) * p * n;
  stage(p8, n4,
        [&](int ch, int k) { return ch < p && k < n ? st[ch * n + k] : 0.f; },
        [&](int ch, int k, float v) { ht_s[k * lh + ch] = v; });
  const T* cg = C + bb * scb + (long long)t0 * scs;
  const T* xg = x + bb * sxb + (long long)t0 * sxs + (long long)hh * p;
  const float* dtg = dt + bb * sdb + (long long)t0 * sds + hh;
  if (vec) {
    stage4(pad16(q), n,
           [&](int r, int k) {
             return r < q ? load4(cg + r * scs + k)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
           },
           [&](int r, int k, float4 v) { store4(c_s + r * ldc + k, v); });
    stage4(q, p8,
           [&](int j, int ch) {
             return ch < p ? load4(xg + j * sxs + ch)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
           },
           [&](int j, int ch, float4 v) {
             const float d = dtg[j * sds];
             store4(xdt_s + j * p8 + ch,
                    make_float4(v.x * d, v.y * d, v.z * d, v.w * d));
           });
  } else {
    stage(pad16(q), n4,
          [&](int r, int k) {
            return r < q && k < n ? to_f32(cg[r * scs + k]) : 0.f;
          },
          [&](int r, int k, float v) { c_s[r * ldc + k] = v; });
    stage(q, p8,
          [&](int j, int ch) {
            return ch < p ? to_f32(xg[j * sxs + ch]) * dtg[j * sds] : 0.f;
          },
          [&](int j, int ch, float v) { xdt_s[j * p8 + ch] = v; });
  }
  __syncthreads();
  const float* cbc = cbt + ((long long)bb * nc + c) * q * q;
  const auto masked = [&](int j, int r, float v) {
    return r < q && j <= r ? v * expf(cum_s[r] - cum_s[j]) : 0.f;
  };
  if (vec) {                                  // columns past pad16(q): unread
    stage4(q, pad16(q),
           [&](int j, int r) {
             return r < q ? load4(cbc + j * q + r)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
           },
           [&](int j, int r, float4 v) {
             store4(att_s + j * lq + r,
                    make_float4(masked(j, r, v.x), masked(j, r + 1, v.y),
                                masked(j, r + 2, v.z), masked(j, r + 3, v.w)));
           });
  } else {
    stage(q, pad16(q),
          [&](int j, int r) { return r < q ? cbc[j * q + r] : 0.f; },
          [&](int j, int r, float v) { att_s[j * lq + r] = masked(j, r, v); });
  }
  __syncthreads();

  // thread: rows rg * 4 + a (one float4 of a transposed row), channels
  // cg * 8 + e (two float4); warp w holds rows 16 w .. 16 w + 15
  const int rg = tid / 8, cg8 = (tid % 8) * 8;
  const int w16 = 16 * (tid / 32);
  if (w16 >= q || cg8 >= p8) return;
  const int jmax = min(q, w16 + 16);
  float intra[4][8], inter[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 8; ++e) intra[a][e] = inter[a][e] = 0.f;
#pragma unroll 2
  for (int j = 0; j < jmax; ++j) {
    const float4 a4 = *reinterpret_cast<const float4*>(att_s + j * lq + rg * 4);
    const float4 x0 = *reinterpret_cast<const float4*>(xdt_s + j * p8 + cg8);
    const float4 x1 =
        *reinterpret_cast<const float4*>(xdt_s + j * p8 + cg8 + 4);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) intra[a][e] += av[a] * xv[e];
  }
  // C . h: 4 state columns a step, C's rows read as float4 (the 8 lanes of
  // a quarter warp share a row: one broadcast)
  for (int k0 = 0; k0 < n4; k0 += 4) {
    float cv[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 c4 =
          *reinterpret_cast<const float4*>(c_s + (rg * 4 + a) * ldc + k0);
      cv[a][0] = c4.x;
      cv[a][1] = c4.y;
      cv[a][2] = c4.z;
      cv[a][3] = c4.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 h0 =
          *reinterpret_cast<const float4*>(ht_s + (k0 + i) * lh + cg8);
      const float4 h1 =
          *reinterpret_cast<const float4*>(ht_s + (k0 + i) * lh + cg8 + 4);
      const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 8; ++e) inter[a][e] += cv[a][i] * hv[e];
    }
  }
  const long long y_row = (long long)h * p;
  T* yg = y + ((long long)bb * s + t0) * y_row + (long long)hh * p;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = rg * 4 + a;
    if (r >= q) continue;
    const float ec = expf(cum_s[r]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int ch = cg8 + e;
      if (ch < p)
        yg[(long long)r * y_row + ch] =
            from_f32<T>(intra[a][e] + ec * inter[a][e]);
    }
  }
}

template <typename K>
cudaError_t smem_limit(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* h_last, void* scratch, int b, int s,
           int h, int p, int n, int q, long long sxb, long long sxs,
           long long sdb, long long sds, long long sbb, long long sbs,
           long long scb, long long scs, void* stream) {
  // the register tiles and the shared-memory budget are sized by MAX_*
  if (b < 0 || s < 0 || h < 1 || p < 1 || p > MAX_P || n < 1 || n > MAX_N ||
      q < 1 || q > MAX_Q || (s > 0 && s % q != 0))
    return (int)cudaErrorInvalidValue;
  const long long nc = s > 0 ? s / q : 0;
  const long long per = (p * n + THREADS * PASS_E - 1) / (THREADS * PASS_E);
  if ((long long)b * nc * h > 2147483647LL ||
      (long long)b * h * per > 2147483647LL ||
      (long long)b * nc * ((q + RT - 1) / RT) * ((q + RT - 1) / RT) >
          2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  long long at_cum, at_states;
  scratch_layout(b, s, h, p, n, q, &at_cum, &at_states);
  // x, B and C in groups of 4 elements (vector loads) where every row of
  // them starts on such a group
  const auto al4 = [](const void* ptr, long long s1, long long s2) {
    return ((uintptr_t)ptr % (4 * sizeof(T))) == 0 && s1 % 4 == 0 &&
           s2 % 4 == 0;
  };
  const int vec = al4(x, sxb, sxs) && al4(B, sbb, sbs) && al4(C, scb, scs) &&
                  p % 4 == 0 && n % 4 == 0 && q % 4 == 0;
  float* cb = (float*)scratch;
  float* cum = cb + at_cum;
  float* states = cb + at_states;
  cudaError_t err;
  if ((err = smem_limit(ssd_prep_kernel<T>, prep_smem(q, n))) != cudaSuccess ||
      (err = smem_limit(ssd_state_kernel<T>, state_smem(q, p, n))) !=
          cudaSuccess ||
      (err = smem_limit(ssd_chunk_scan_kernel<T>, scan_smem(q, p, n))) !=
          cudaSuccess)
    return (int)err;
  const long long tiles = (q + RT - 1) / RT;
  ssd_prep_kernel<T><<<(unsigned)(b * nc * tiles * tiles), THREADS,
                       prep_smem(q, n), st>>>(
      (const float*)dt, (const float*)A, (const T*)B, (const T*)C, cb, cum, s,
      h, n, q, sdb, sds, sbb, sbs, scb, scs);
  ssd_state_kernel<T><<<(unsigned)(b * nc * h), THREADS, state_smem(q, p, n),
                        st>>>((const T*)x, (const float*)dt, (const T*)B, cum,
                              states, s, h, p, n, q, sxb, sxs, sdb, sds, sbb,
                              sbs, vec);
  ssd_pass_kernel<<<(unsigned)(b * h * per), THREADS, 0, st>>>(
      cum, states, (float*)h_last, s, h, p, n, q);
  ssd_chunk_scan_kernel<T><<<(unsigned)(b * nc * h), THREADS,
                             scan_smem(q, p, n), st>>>(
      (const T*)x, (const float*)dt, (const T*)C, cb, cum, states, (T*)y, s,
      h, p, n, q, sxb, sxs, sdb, sds, scb, scs, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// size[0] = fp32 words of scratch the entries need at this shape (0 where
// the shape has no chunk)
extern "C" int ssd_scan_scratch(int b, int s, int h, int p, int n, int q,
                                long long* size) {
  long long at_cum, at_states;
  size[0] = (b < 1 || s < 1 || h < 1 || p < 1 || n < 1 || q < 1 ||
             s % q != 0)
                ? 0
                : scratch_layout(b, s, h, p, n, q, &at_cum, &at_states);
  return 0;
}

extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, void* y,
                            void* h_last, void* scratch, int b, int s, int h,
                            int p, int n, int q, long long sxb, long long sxs,
                            long long sdb, long long sds, long long sbb,
                            long long sbs, long long scb, long long scs,
                            void* stream) {
  return launch<float>(x, dt, A, B, C, y, h_last, scratch, b, s, h, p, n, q,
                       sxb, sxs, sdb, sds, sbb, sbs, scb, scs, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, void* y,
                             void* h_last, void* scratch, int b, int s, int h,
                             int p, int n, int q, long long sxb,
                             long long sxs, long long sdb, long long sds,
                             long long sbb, long long sbs, long long scb,
                             long long scs, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, B, C, y, h_last, scratch, b, s, h,
                               p, n, q, sxb, sxs, sdb, sds, sbb, sbs, scb,
                               scs, stream);
}
