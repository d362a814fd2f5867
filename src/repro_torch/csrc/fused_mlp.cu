// Fused SwiGLU MLP for Hopper (sm_90a), plain C interface for ctypes:
// out = (silu(x . Wg) * (x . Wu)) . Wd with fp32 accumulation, the gated h
// rounded to Wd's dtype before the down-projection.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_mlp.py::fused_mlp
// (:47, pallas_call :57, body _kernel :23-43). That kernel keeps a
// (block_m, d) fp32 accumulator in VMEM across the d_ff axis so h never
// reaches HBM. At d = 5120 the accumulator is 20 KB a row, which does not
// fit a Hopper block's 227 KB of shared memory at a useful block_m, and
// carrying it across blocks would need float atomics (run-to-run
// nondeterminism). So the design is (i): two GEMMs with h (T x f, Wd's
// dtype) in a scratch buffer that stays in the 50 MB L2 between them
// (8.9 MB at T = 256, f = 17408).
//
// Bound. At T = 256, d = 5120, f = 17408 the three bf16 weights are 535 MB
// and the work 6 T d f = 137 GFLOP: max(137e9 / 989e12, 535e6 / 3.35e12) =
// 0.161 ms, bound by the weight stream.
//
// bf16 path. The earlier design used WMMA 16x16x16 with one
// register-prefetch stage and 64-row M tiles: every weight tile was read 4
// times at T = 256, and the down GEMM ran a full 17,408-deep K loop in each
// of 320 small blocks: 1.21-1.23 ms on an NVIDIA H100 80GB HBM3 at 700.00 W,
// 4.9x behind three cuBLAS matmuls (0.25 ms); neither used TMA nor wgmma.
// Now both GEMMs are one kernel (mlp_tma_wgmma_kernel): a block of two
// consumer warpgroups (64 rows each, 128 rows) and one producer warpgroup
// whose one thread issues TMA into a
// 4-stage ring of 48 KB stages (an A tile of 128 rows x 64 K-values and two
// B tiles of 64 K-values x 128 columns), guarded by full and empty
// mbarriers; the consumers run m64n128k16 wgmmas on it with fp32
// accumulators in registers, one wgmma group kept in flight.
//   1. gate/up: A = x (K-major), B0 = Wg and B1 = Wu at the same 128
//      columns (MN-major); the epilogue applies silu(g) * u and stores h.
//      The two 128-row M tiles of one column strip are neighbouring blocks,
//      so at T = 256 each weight byte comes from HBM about once.
//   2. down: A = h, B0 and B1 = Wd's columns n0 .. n0 + 127 and n0 + 128 ..
//      n0 + 255.
// Waves. Blocks hold 193 KB of shared memory, so one runs on an SM and a
// GEMM runs in waves of 132 units (output tiles) on an H100. At T = 256:
//   - gate/up has 2 x 136 = 272 units of 128 x 128 (f = 17408 = 136 x
//     128): two full waves and a third of 8 units that leaves 124 SMs
//     idle as long as a full one. So a last wave that would leave most
//     SMs idle is split in K instead: its units take `gate_splits` (16)
//     short blocks each, which write fp32 sums of g and u to a scratch,
//     and mlp_tail_sum_kernel adds them in split order and applies
//     silu(g) * u (on the H100 above, chip_smoke.py's serving profile:
//     0.197 ms a gate/up GEMM before, 0.157 ms after);
//   - down has M = 256, N = 5120, K = 17408: only 40 units of 128 x 256, so
//     every unit is split in K 3 ways (120 blocks, one wave); each split
//     writes its fp32 sums to the scratch and mlp_split_sum_kernel adds
//     them in split order and rounds once.
// kernels/fused_mlp.py::mlp_plan chooses the splits and sizes the scratch.
// No atomics anywhere: the same call gives the same bits.
// Ragged T, d and f: TMA fills rows and columns past every edge with zeros
// and the epilogues store nothing past them. TMA needs 16-byte-aligned
// bases and row strides, so the bf16 entry returns cudaErrorInvalidValue,
// launching nothing, when d % 8 or f % 8 is non-zero or a base is
// misaligned.
//
// fp32 path (the parity runs): the earlier design, a SIMT tiled GEMM
// pair in full fp32, no TF32; every output summed by one thread in a fixed
// order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

// -------------------------------------------------- bf16 / TMA + wgmma

using namespace hopper;

constexpr int BM = 128;                // rows a block, 64 a warpgroup
constexpr int BN = 128;                // columns of each B tile
constexpr int BK = 64;                 // K-values a stage
constexpr int STAGES = 4;
constexpr int THREADS = 384;           // 2 consumer warpgroups + producer
constexpr int A_BYTES = BM * BK * 2;               // 16 KB
constexpr int B_BOX = BK * 64 * 2;                 // 8 KB: 64 columns
constexpr int B_BYTES = 2 * B_BOX;                 // 16 KB: BN columns
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES; // 48 KB
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// Output units are BM x n_span tiles, M tiles fastest. The last `tail`
// units are split in K into `splits` blocks each (tail units of a split
// neighbouring); the others take one block each. A whole unit writes bf16
// to `out`: GATED, h = silu(A . B0) * (A . B1) with B0 and B1 at the same
// columns; otherwise C = A . [B0 | B1], B0 at columns n0 and B1 at
// n0 + BN. A split writes its fp32 sums to `partials`: GATED, g and u of
// tail unit ti at ((split * tail + ti) * 2 + {0, 1}) * BM * BN, row-major
// BM x BN tiles (mlp_tail_sum_kernel finishes them); otherwise C's
// columns at partials[split] (M x N, mlp_split_sum_kernel adds them).
template <bool GATED>
__global__ void __launch_bounds__(THREADS, 1)
mlp_tma_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b0,
                     const __grid_constant__ CUtensorMap map_b1,
                     bf16* __restrict__ out, float* __restrict__ partials,
                     int M, int N, int K, int tail, int splits) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];

  // M tiles fastest: the blocks of one column strip run side by side and
  // share its weight tiles through L2
  const int m_tiles = (M + BM - 1) / BM;
  const int n_span = GATED ? BN : 2 * BN;
  const int whole = m_tiles * ((N + n_span - 1) / n_span) - tail;
  const int bid = blockIdx.x;
  const bool part = bid >= whole;                 // one split of a tail unit
  const int ti = part ? (bid - whole) % tail : 0;
  const int split = part ? (bid - whole) / tail : 0;
  const int nsplit = part ? splits : 1;
  const int unit = part ? whole + ti : bid;
  const int m0 = unit % m_tiles * BM;
  const int n0 = unit / m_tiles * n_span;
  const int nk = (K + BK - 1) / BK;
  const int kb0 = (int)((long long)split * nk / nsplit);
  const int n_kb = (int)((long long)(split + 1) * nk / nsplit) - kb0;
  const int n1 = GATED ? n0 : n0 + BN;            // B1's first column

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);                    // one arrival a consumer
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------ producer
    reg_dealloc<40>();
    if (threadIdx.x == 256) {
      for (int it = 0; it < n_kb; ++it) {
        const int st = it % STAGES;
        const int k0 = (kb0 + it) * BK;
        uint8_t* a_s = smem + st * STAGE_BYTES;
        uint8_t* b0_s = a_s + A_BYTES;
        uint8_t* b1_s = b0_s + B_BYTES;
        mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
        mbar_expect(&full[st], STAGE_BYTES);
        tma_load_2d(a_s, &map_a, &full[st], k0, m0);
        for (int c = 0; c < 2; ++c) {
          tma_load_2d(b0_s + c * B_BOX, &map_b0, &full[st], n0 + 64 * c, k0);
          tma_load_2d(b1_s + c * B_BOX, &map_b1, &full[st], n1 + 64 * c, k0);
        }
      }
    }
  } else {
    // ----------------------------------------------------- consumers
    reg_alloc<232>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    float acc0[BN / 2], acc1[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0.f;
    for (int it = 0; it < n_kb; ++it) {
      const int st = it % STAGES;
      const uint8_t* a_s = smem + st * STAGE_BYTES + wg * (A_BYTES / 2);
      const uint8_t* b0_s = smem + st * STAGE_BYTES + A_BYTES;
      const uint8_t* b1_s = b0_s + B_BYTES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = desc_sw128(a_s + 32 * kk, 16, 1024);
        wgmma_ss_n128<1>(acc0, da, desc_sw128(b0_s + 2048 * kk, B_BOX, 1024));
        wgmma_ss_n128<1>(acc1, da, desc_sw128(b1_s + 2048 * kk, B_BOX, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();                   // the previous stage's group is done
      fence_regs(acc0);
      fence_regs(acc1);
      if (it > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);

    const int r_in = 64 * wg + 16 * (tid / 32) + lane / 4;  // + 8 i
    const int col0 = 2 * (lane % 4);                        // + 8 j
    if (GATED && part) {
      float* g_p = partials + (size_t)(split * tail + ti) * 2 * BM * BN;
      float* u_p = g_p + BM * BN;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int e = (r_in + 8 * i) * BN + 8 * j + col0;
          *reinterpret_cast<float2*>(g_p + e) =
              make_float2(acc0[4 * j + 2 * i], acc0[4 * j + 2 * i + 1]);
          *reinterpret_cast<float2*>(u_p + e) =
              make_float2(acc1[4 * j + 2 * i], acc1[4 * j + 2 * i + 1]);
        }
      return;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + r_in + 8 * i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float* a = acc0 + 4 * j + 2 * i;
        const float* u = acc1 + 4 * j + 2 * i;
        const int c = n0 + 8 * j + col0;         // N % 8 == 0: c + 1 < N too
        if constexpr (GATED) {
          if (c < N)
            *reinterpret_cast<uint32_t*>(out + (size_t)row * N + c) =
                pack_bf16(silu(a[0]) * u[0], silu(a[1]) * u[1]);
        } else if (!part) {
          if (c < N)
            *reinterpret_cast<uint32_t*>(out + (size_t)row * N + c) =
                pack_bf16(a[0], a[1]);
          if (c + BN < N)
            *reinterpret_cast<uint32_t*>(out + (size_t)row * N + c + BN) =
                pack_bf16(u[0], u[1]);
        } else {
          float* p = partials + ((size_t)split * M + row) * N;
          if (c < N)
            *reinterpret_cast<float2*>(p + c) = make_float2(a[0], a[1]);
          if (c + BN < N)
            *reinterpret_cast<float2*>(p + c + BN) = make_float2(u[0], u[1]);
        }
      }
    }
  }
}

// The tail units of the gate/up GEMM: h = silu(sum of g) * (sum of u),
// each sum over the splits in order 0, 1, ...; one thread a column pair.
__global__ void __launch_bounds__(256)
mlp_tail_sum_kernel(const float* __restrict__ partials, bf16* __restrict__ h,
                    int M, int N, int whole, int tail, int splits) {
  const int m_tiles = (M + BM - 1) / BM;
  const size_t pairs = (size_t)tail * BM * BN / 2;
  for (size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x; p < pairs;
       p += (size_t)gridDim.x * blockDim.x) {
    const int ti = (int)(p / (BM * BN / 2));
    const int e = (int)(p % (BM * BN / 2)) * 2;       // in the BM x BN tile
    const int unit = whole + ti;
    const int row = unit % m_tiles * BM + e / BN;
    const int col = unit / m_tiles * BN + e % BN;
    if (row >= M || col >= N) continue;
    float2 g = make_float2(0.f, 0.f), u = make_float2(0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float* q = partials + (size_t)(s * tail + ti) * 2 * BM * BN + e;
      const float2 gs = *reinterpret_cast<const float2*>(q);
      const float2 us = *reinterpret_cast<const float2*>(q + BM * BN);
      g.x += gs.x;
      g.y += gs.y;
      u.x += us.x;
      u.y += us.y;
    }
    *reinterpret_cast<uint32_t*>(h + (size_t)row * N + col) =
        pack_bf16(silu(g.x) * u.x, silu(g.y) * u.y);
  }
}

// out = bf16(sum over s of partials[s]), s = 0, 1, ... in order; n % 4 == 0
__global__ void __launch_bounds__(256)
mlp_split_sum_kernel(const float* __restrict__ partials,
                     bf16* __restrict__ out, size_t n, int splits) {
  for (size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += 4 * (size_t)gridDim.x * blockDim.x) {
    float4 acc = *reinterpret_cast<const float4*>(partials + i);
    for (int s = 1; s < splits; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(partials + s * n + i);
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    *reinterpret_cast<uint2*>(out + i) =
        make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
  }
}

// a (rows x cols) bf16 row-major matrix, boxes of 64 columns x box_rows
bool map_2d(CUtensorMap* map, const void* base, int rows, int cols,
            int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * sizeof(bf16)};
  const uint32_t box[2] = {64, (uint32_t)box_rows};
  return make_map(map, base, 2, dims, strides, box);
}

int grid_for(size_t threads) {
  const size_t want = (threads + 255) / 256;
  return want < 1024 ? (int)want : 1024;
}

int launch_bf16(const void* x, const void* wg, const void* wu,
                const void* wd, void* h, void* partials, void* out, int t,
                int d, int f, int down_splits, int gate_tail, int gate_splits,
                cudaStream_t s) {
  CUtensorMap mx, mwg, mwu, mh, mwd;
  if (!map_2d(&mx, x, t, d, BM) || !map_2d(&mwg, wg, d, f, BK) ||
      !map_2d(&mwu, wu, d, f, BK) || !map_2d(&mh, h, t, f, BM) ||
      !map_2d(&mwd, wd, f, d, BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_tma_wgmma_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlp_tma_wgmma_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
  if (err != cudaSuccess) return (int)err;
  float* p = (float*)partials;
  const int m_tiles = (t + BM - 1) / BM;
  // 1. gate/up: whole units, then the tail units' K splits
  const int whole = m_tiles * ((f + BN - 1) / BN) - gate_tail;
  mlp_tma_wgmma_kernel<true><<<whole + gate_tail * gate_splits, THREADS,
                               SMEM, s>>>(mx, mwg, mwu, (bf16*)h, p, t, f, d,
                                          gate_tail, gate_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (gate_tail > 0) {
    mlp_tail_sum_kernel<<<grid_for((size_t)gate_tail * BM * BN / 2), 256, 0,
                          s>>>(p, (bf16*)h, t, f, whole, gate_tail,
                               gate_splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // 2. down: every unit split in K when down_splits > 1
  const int units = m_tiles * ((d + 2 * BN - 1) / (2 * BN));
  mlp_tma_wgmma_kernel<false><<<units * down_splits, THREADS, SMEM, s>>>(
      mh, mwd, mwd, (bf16*)out, p, t, d, f, down_splits > 1 ? units : 0,
      down_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || down_splits == 1) return (int)err;
  const size_t n = (size_t)t * d;
  mlp_split_sum_kernel<<<grid_for(n / 4), 256, 0, s>>>(p, (bf16*)out, n,
                                                       down_splits);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- fp32 / SIMT

constexpr int FT = 64;     // fp32 block tile (rows and cols)
constexpr int FK = 16;     // fp32 K tile

// Each GEMM of the bf16 path's contract in full fp32: 16 x 16 threads,
// 4 x 4 outputs each (rows ty + 16 i, cols tx + 16 j).
template <bool GATED>
__global__ void __launch_bounds__(256)
gemm_f32(const float* __restrict__ A, const float* __restrict__ B0,
         const float* __restrict__ B1, float* __restrict__ C, int M, int N,
         int K) {
  constexpr int NB = GATED ? 2 : 1;
  __shared__ float As[FK][FT + 4];
  __shared__ float Bs[NB][FK][FT + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * FT, n0 = blockIdx.y * FT;
  const float* Bp[2] = {B0, B1};
  float acc[NB][4][4] = {};

  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int idx = tid; idx < FT * FK; idx += 256) {
      const int r = idx / FK, c = idx % FK;          // A tile, transposed
      As[c][r] = (m0 + r < M && k0 + c < K)
                     ? A[(size_t)(m0 + r) * K + k0 + c] : 0.f;
      const int br = idx / FT, bc = idx % FT;         // B tiles
#pragma unroll
      for (int b = 0; b < NB; ++b)
        Bs[b][br][bc] = (k0 + br < K && n0 + bc < N)
                            ? Bp[b][(size_t)(k0 + br) * N + n0 + bc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bv = Bs[b][kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[b][i][j] += a[i] * bv;
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = m0 + ty + 16 * i, gc = n0 + tx + 16 * j;
      if (gr >= M || gc >= N) continue;
      float y = acc[0][i][j];
      if constexpr (GATED) y = y / (1.f + expf(-y)) * acc[NB - 1][i][j];
      C[(size_t)gr * N + gc] = y;
    }
}

}  // namespace

// x (T, d), w_gate / w_up (d, f), w_down (f, d); h (T, f) scratch; out
// (T, d). The plan (kernels/fused_mlp.py::mlp_plan): the down GEMM's K
// splits, and the gate/up GEMM's last `gate_tail` units split in K
// `gate_splits` ways; partials is fp32 scratch for both (max of
// down_splits * T * d and gate_tail * gate_splits * 2 * 128 * 128 floats),
// unused when down_splits == 1 and gate_tail == 0.
extern "C" int fused_mlp_bf16(const void* x, const void* wg, const void* wu,
                              const void* wd, void* h, void* partials,
                              void* out, int t, int d, int f, int down_splits,
                              int gate_tail, int gate_splits, void* stream) {
  const int gate_units = (t + BM - 1) / BM * ((f + BN - 1) / BN);
  if (t < 0 || d < 8 || f < 8 || d % 8 != 0 || f % 8 != 0 ||
      down_splits < 1 || gate_splits < 1 || gate_tail < 0 ||
      gate_tail > gate_units || !hopper::aligned16(x) ||
      !hopper::aligned16(wg) || !hopper::aligned16(wu) ||
      !hopper::aligned16(wd) || !hopper::aligned16(h) ||
      !hopper::aligned16(out) ||
      ((down_splits > 1 || gate_tail > 0) && !hopper::aligned16(partials)))
    return (int)cudaErrorInvalidValue;
  if (t == 0) return (int)cudaGetLastError();
  return launch_bf16(x, wg, wu, wd, h, partials, out, t, d, f, down_splits,
                     gate_tail, gate_splits, (cudaStream_t)stream);
}

extern "C" int fused_mlp_f32(const void* x, const void* wg, const void* wu,
                             const void* wd, void* h, void* out, int t, int d,
                             int f, void* stream) {
  if (t <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  dim3 g1((t + FT - 1) / FT, (f + FT - 1) / FT);
  gemm_f32<true><<<g1, 256, 0, s>>>((const float*)x, (const float*)wg,
                                     (const float*)wu, (float*)h, t, f, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g2((t + FT - 1) / FT, (d + FT - 1) / FT);
  gemm_f32<false><<<g2, 256, 0, s>>>((const float*)h, (const float*)wd,
                                      nullptr, (float*)out, t, d, f);
  return (int)cudaGetLastError();
}
