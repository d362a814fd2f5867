// Fused SwiGLU MLP for Hopper (sm_90a), plain C interface for ctypes:
// out = (silu(x . Wg) * (x . Wu)) . Wd with fp32 accumulation, the gated h
// rounded to Wd's dtype before the down-projection.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_mlp.py::fused_mlp
// (body _kernel). That kernel keeps a (block_m, d) fp32 accumulator in VMEM
// across the d_ff axis so h never reaches HBM. At d = 5120 the accumulator
// is 20 KB per row, which does not fit a Hopper block's 227 KB of shared
// memory at a useful block_m, and carrying it across blocks would need
// float atomics (run-to-run nondeterminism) or a second pass anyway. So the
// design is (i): two hand-written tiled tensor-core GEMMs.
//   1. gate/up: one block computes the same (64 x 128) tile of x.Wg and x.Wu
//      and applies silu(g) * u in its epilogue, writing h (T x f) in Wd's
//      dtype to a scratch buffer. At the serving batch (T = 256, f = 17408)
//      h is 8.9 MB and stays in the 50 MB L2 for step 2.
//   2. down: h . Wd, (64 x 64) tiles, full-K loop per block.
// Every output element is summed by one thread in a fixed order: results are
// deterministic, greedy serving reproducible. Ragged T, d and f tails are
// masked on load (zero fill) and store; 16-byte vector loads are used where
// the row stride and base allow them, element loads elsewhere.
//
// bf16 runs on the tensor cores through WMMA (16x16x16, fp32 accumulate),
// with a register prefetch of the next K tile overlapping the current MMA.
// fp32 (the parity runs) runs a SIMT tiled GEMM in full fp32, no TF32.
//
// Bound. At T = 256 the three (d x f) bf16 weights are 535 MB per layer and
// the work 6.T.d.f = 137 GFLOP: max(137e9 / 989e12, 535e6 / 3.35e12) =
// 0.16 ms, memory-bound by the weight stream. This first kernel uses
// neither TMA nor wgmma nor a multi-stage smem ring, so it is expected to
// sit well above that bound; the weights are read once per 64-row M tile
// (4 times at T = 256, the later reads mostly from L2 because blockIdx.x
// walks M fastest).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

// ------------------------------------------------------------ bf16 / WMMA

constexpr int BM = 64;     // block rows (tokens)
constexpr int BK = 32;     // K tile
constexpr int WM = 32;     // warp tile rows (2 fragments)
constexpr int WN = 32;     // warp tile cols (2 fragments)

// ROWS x COLS bf16 tile of a row-major matrix, staged through registers as
// 16-byte chunks so the next tile's global loads overlap the current MMA.
template <int ROWS, int COLS, int THREADS>
struct Tile {
  static constexpr int CPR = COLS / 8;                  // chunks per row
  static constexpr int N = ROWS * CPR / THREADS;        // chunks per thread
  static_assert(ROWS * CPR % THREADS == 0, "tile/threads mismatch");
  uint4 r[N];

  __device__ __forceinline__ void load(const bf16* __restrict__ src, int ld,
                                       int r0, int c0, int nr, int nc,
                                       bool vec) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int gr = r0 + idx / CPR;
      const int gc = c0 + (idx % CPR) * 8;
      const bf16* p = src + (size_t)gr * ld + gc;
      if (vec && gr < nr && gc + 8 <= nc) {
        r[i] = *reinterpret_cast<const uint4*>(p);
      } else {
        unsigned short h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = (gr < nr && gc + e < nc) ? __bfloat16_as_ushort(p[e]) : 0;
        unsigned w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = (unsigned)h[2 * e] | ((unsigned)h[2 * e + 1] << 16);
        r[i] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }

  __device__ __forceinline__ void store(bf16* dst, int lds) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      *reinterpret_cast<uint4*>(dst + (idx / CPR) * lds + (idx % CPR) * 8) =
          r[i];
    }
  }
};

// C (M x N, bf16) = A (M x K) . B0 (K x N), or with GATED
// C = silu(A . B0) * (A . B1). Warps are laid out 2 x WARPS_N.
template <bool GATED, int WARPS_N>
__global__ void __launch_bounds__(64 * WARPS_N)
gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B0,
          const bf16* __restrict__ B1, bf16* __restrict__ C, int M, int N,
          int K, bool vec_a, bool vec_b) {
  constexpr int BN = WN * WARPS_N;
  constexpr int THREADS = 64 * WARPS_N;
  constexpr int NB = GATED ? 2 : 1;
  constexpr int LDA = BK + 8;          // bf16 elements, keeps 32-B alignment
  constexpr int LDB = BN + 8;
  constexpr int LDC = BN + 4;          // floats
  constexpr int A_ELEMS = BM * LDA;
  constexpr int B_ELEMS = BK * LDB;
  constexpr int LOAD_BYTES = (A_ELEMS + NB * B_ELEMS) * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  constexpr int SMEM = LOAD_BYTES > C_BYTES ? LOAD_BYTES : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + A_ELEMS;
  float* Cs = reinterpret_cast<float*>(smem);   // epilogue reuse

  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const bf16* Bp[2] = {B0, B1};

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][2][2];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[b][i][j], 0.f);

  Tile<BM, BK, THREADS> ta;
  Tile<BK, BN, THREADS> tb[NB];
  ta.load(A, K, m0, 0, M, K, vec_a);
#pragma unroll
  for (int b = 0; b < NB; ++b) tb[b].load(Bp[b], N, 0, n0, K, N, vec_b);

  const int nk = (K + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    ta.store(As, LDA);
#pragma unroll
    for (int b = 0; b < NB; ++b) tb[b].store(Bs + b * B_ELEMS, LDB);
    __syncthreads();
    if (kt + 1 < nk) {
      const int k0 = (kt + 1) * BK;
      ta.load(A, K, m0, k0, M, K, vec_a);
#pragma unroll
      for (int b = 0; b < NB; ++b) tb[b].load(Bp[b], N, k0, n0, K, N, vec_b);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(
              fb, Bs + b * B_ELEMS + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(acc[b][i][j], fa[i], fb, acc[b][i][j]);
        }
      }
    }
    __syncthreads();
  }

  if constexpr (GATED) {
    // fragments of one type share their element -> (row, col) mapping
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < acc[0][i][j].num_elements; ++e) {
          const float g = acc[0][i][j].x[e];
          acc[0][i][j].x[e] = g / (1.f + expf(-g)) * acc[NB - 1][i][j].x[e];
        }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * WM + i * 16) * LDC + wn * WN + j * 16,
                              acc[0][i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N)
      C[(size_t)gr * N + gc] = __float2bfloat16(Cs[r * LDC + c]);
  }
}

// ----------------------------------------------------------- fp32 / SIMT

constexpr int FT = 64;     // fp32 block tile (rows and cols)
constexpr int FK = 16;     // fp32 K tile

// Same contract as gemm_bf16 in full fp32: 16 x 16 threads, 4 x 4 outputs
// each (rows ty + 16 i, cols tx + 16 j).
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x (T, d), w_gate / w_up (d, f), w_down (f, d); h (T, f) scratch; out (T, d)
extern "C" int fused_mlp_bf16(const void* x, const void* wg, const void* wu,
                              const void* wd, void* h, void* out, int t,
                              int d, int f, void* stream) {
  if (t <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const bool vx = aligned16(x) && d % 8 == 0;
  const bool vw = aligned16(wg) && aligned16(wu) && f % 8 == 0;
  dim3 g1((t + BM - 1) / BM, (f + 4 * WN - 1) / (4 * WN));
  gemm_bf16<true, 4><<<g1, 256, 0, s>>>(
      (const bf16*)x, (const bf16*)wg, (const bf16*)wu, (bf16*)h, t, f, d,
      vx, vw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool vh = aligned16(h) && f % 8 == 0;
  const bool vd = aligned16(wd) && d % 8 == 0;
  dim3 g2((t + BM - 1) / BM, (d + 2 * WN - 1) / (2 * WN));
  gemm_bf16<false, 2><<<g2, 128, 0, s>>>(
      (const bf16*)h, (const bf16*)wd, nullptr, (bf16*)out, t, d, f, vh, vd);
  return (int)cudaGetLastError();
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
