// Paged-attention decode for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py::
// paged_attention (:99, pallas_call :140, body _kernel :44-96):
// flash-decoding over a paged KV pool, one query token per row, fp32 online
// softmax across pages, kv_len = pos + 1, page 0 the null page. Every row
// reads through its own table row and is masked by its own kv_len.
//
// Bound. A row reads its live pages' K and V (2 * kv_len * Hkv * D
// elements) and does 4 * Hq * D * kv_len flops, ~2.5 flop a byte in bf16,
// far below the ~295 flop/byte ridge: the card's 3.35 TB/s bounds it, with
// each live page counted once a call, since the rows of one slot (a
// prefill chunk's rows, a decode row) share their pages. At the serving
// path's 256-row mix (phase 3 of chip_smoke.py) that is 13.6 MB (8.4 MB of
// live K and V, 5.2 MB of q and out), 4.1 us.
//
// bf16 path (tc::). The earlier design ran one block per (row, kv head),
// each walking its pages with scalar loads, a block barrier and a 5-thread
// softmax a page: the 253 rows of a prefill chunk read their slot's pages
// 48x over, and a decode-only step spent 252 x 8 blocks on padding rows.
// 0.61 ms at the 256-row mix (NVIDIA H100 80GB HBM3, 700.00 W). Now:
//   - a plan kernel (one block) finds, on the device, runs of consecutive
//     rows that share pages: row r joins row r - 1 when it holds at least
//     as many live pages and the two table rows agree over row r - 1's.
//     Then every row of a run agrees with the run's last row over its own
//     live pages, and a tile reads the pages through the last row's table
//     row. Rows of other slots, rows whose tables part after the first
//     pages, a shorter row after a longer one: each starts a new run, so
//     any table is right. Runs are cut into tiles of 64 / rep rows (12 at
//     rep 5): a tile's M = rows x the rep query heads of one kv head;
//   - key segments are fixed in absolute units: segment s holds the keys
//     [256 s, 256 s + 256) (4 kv tiles of 64). A tile (or a lone row)
//     whose last row has keys in one segment is one work item and writes
//     its output; one with more is split, one work item a segment, each
//     writing every row's (m, l, o) of that segment, and
//     paged_combine_kernel folds each row's own segments in segment
//     order. Every row keeps one fp32 online softmax a segment and every
//     output comes from the same fold (fold_ml / fold_o from the empty
//     state, then o / l). So a row's bits are a function of its own q,
//     table row and kv_len alone, whether it is lone, in a run of its
//     slot's rows or in a tile beside another slot's rows (chip_smoke.py
//     phase 3 holds it bit for bit), and no item walks more than 4 kv
//     tiles;
//   - a persistent grid (2 blocks an SM) walks the work units (item, kv
//     head) in a fixed stride. A producer warp brings the tile's Q (one
//     TMA box of 64 D-values x rep heads x rows) and, kv tile by kv tile,
//     each live page of K and V as one TMA box (64 D-values x one head x
//     page_size positions) into a 2-stage ring, 128-byte swizzled: pages
//     lie back to back, so a 64-key tile has the layout of one 64-row box
//     (hopper.cuh). TMA fits here (a page of one head is a strided 3-D
//     box); cp.async is not needed. D pads to 64 or 128 by TMA's zero fill;
//   - one consumer warpgroup runs S = Q K^T (m64n64k16) and O += P V on
//     wgmma, the online softmax in registers in the log2 domain, each M
//     row masked by its own kv_len by select (p = 0 exactly past it, as
//     the Pallas body's where), so poison past a cursor or in a page no row
//     references leaves every output bit unchanged;
//   - P stays fp32 for P V, as the Pallas body keeps it (p_exp with v
//     upcast, :86-89): P_hi V + P_lo V in one accumulator, as in
//     flash_attention.cu;
//   - determinism: the plan, the work units and every sum order are fixed
//     by the call's inputs, so the same call gives the same bits. Each M
//     row of a wgmma is its own dot products, and kv tiles wholly past a
//     row's kv_len leave its m, l and o bit for bit as they were; the
//     folds and o / l use round-to-nearest intrinsics, which the compiler
//     does not contract into FMAs, so the attention kernel and the
//     combine kernel compute a one-segment row the same way.
// Shared memory at D = 128: Q 16 KB + 2 stages x (K + V) 64 KB + 1 KB of
// alignment slack = 81 KB, two blocks an SM. Split partials: rows x
// segments x Hq x (D + 2) fp32, segments = ceil(table keys / 256).
// Cost of the fixed segments: the rows of a prefill chunk past 256 keys
// go through the partials and the combine (10.5 MB each way at the T =
// 256 mix), where a plan that splits lone rows only would walk them in
// one block.
//
// fp32 path (paged_attention_kernel<float>, the parity runs): the earlier
// design, one block per (row, kv head), fp32 FMAs, pages in a loop; on the
// ragged last page the positions past kv_len are left out of every sum.
//
// Shapes: q (B, Hq, D), pools (n_pages, page_size, Hkv, D), table (B, P)
// int32, pos (B,) int32, out (B, Hq, D); query head h reads kv head
// h / (Hq / Hkv). Limits, checked by the C entries, which return
// cudaErrorInvalidValue and launch nothing past them: Hq % Hkv == 0,
// Hq / Hkv <= 16; fp32 D <= 256, page_size <= 128; bf16 D a multiple of 8
// in [8, 128], page_size a power of two in [8, 64], 16-byte aligned bases
// (TMA's stride, box and address rules).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

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
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

namespace tc {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int BM = 64;                 // tile rows: rows x rep query heads
constexpr int BN = 64;                 // keys a kv tile
constexpr int STAGES = 2;              // K/V ring depth (2 blocks an SM)
constexpr int SPLIT_TILES = 4;         // kv tiles a key segment (256 keys)
constexpr int CONSUMERS = 128;         // one consumer warpgroup
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int PLAN_THREADS = 1024;
constexpr int COMBINE_THREADS = 128;
constexpr int Q_BOX = BM * 128;        // bytes: 64 rows x 64 bf16
constexpr int KV_BOX = BN * 128;       // bytes: 64 keys x 64 bf16
constexpr int MAX_REP = 16;
constexpr float NEG_INF = -1e30f;

template <int DT>                      // D tile: 64 or 128
struct Layout {
  static constexpr int NC = DT / 64;                   // 64-wide D boxes
  static constexpr int Q_BYTES = NC * Q_BOX;
  static constexpr int KV_BYTES = NC * KV_BOX;         // one K or V stage
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};

// ------------------------------------------------------------------ plan
// The plan (int32 scratch, written by paged_plan_kernel on the device):
//   [0]                 number of work items
//   [4, 4 + b)          each row's segments that paged_combine_kernel
//                       folds, for a row of a split tile; -1 for a row
//                       whose work item writes its output
//   [4 + b, 4 + 2b)     1 where a row starts a tile
//   [items_at(b), ...)  items, int4 {first row, rows, segment (-1: whole),
//                       0}
__host__ __device__ __forceinline__ int items_at(int b) {
  return (4 + 2 * b + 3) & ~3;
}
// key segments a row of a table of n_blocks pages can have
__host__ __device__ __forceinline__ int max_segments(int n_blocks,
                                                     int page_size) {
  const long long keys = (long long)n_blocks * page_size;
  const long long seg = (long long)SPLIT_TILES * BN;
  return (int)((keys + seg - 1) / seg);
}
__host__ __device__ __forceinline__ long long plan_ints(int b, int segs) {
  return items_at(b) + 4LL * b * segs;
}

// keys a row attends, clamped to its table (as the SIMT kernel's page loop)
__device__ __forceinline__ int kv_len_of(const int* pos, int r, int cap) {
  return min(max(pos[r] + 1, 0), cap);
}

// Work items of a tile whose last row has n_tiles kv tiles: one a key
// segment when it has more than one, else 1 (whole).
__host__ __device__ __forceinline__ int split_count(int n_tiles) {
  return n_tiles <= SPLIT_TILES ? 1
                                : (n_tiles + SPLIT_TILES - 1) / SPLIT_TILES;
}

// inclusive scan over the block (sum, or max when is_max)
__device__ __forceinline__ int block_scan(int v, bool is_max, int* buf) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = is_max ? max(v, n) : v + n;
  }
  if (lane == 31) buf[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? buf[lane] : (is_max ? -1 : 0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = is_max ? max(w, n) : w + n;
    }
    buf[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = is_max ? max(v, buf[warp - 1]) : v + buf[warp - 1];
  __syncthreads();                       // buf may be reused
  return v;
}

// One block. Row r joins row r - 1's run when it holds at least as many
// live pages and the two table rows agree over row r - 1's live pages:
// then every row of a run agrees with the run's last row over its own live
// pages, so a tile reads its pages through the last row's table. Runs are
// cut into tiles of rows_per_tile rows; a tile whose last row's keys span
// more than one segment is split into its segments.
__global__ void __launch_bounds__(PLAN_THREADS)
paged_plan_kernel(const int* __restrict__ table, const int* __restrict__ pos,
                  int* __restrict__ plan, int b, int n_blocks, int page_size,
                  int rows_per_tile) {
  __shared__ int buf[32];
  __shared__ int carry;
  __shared__ int start_s[PLAN_THREADS + BM];  // a chunk's tile starts + BM
  int* fold = plan + 4;
  int* start = plan + 4 + b;
  int4* items = reinterpret_cast<int4*>(plan + items_at(b));
  const int cap = n_blocks * page_size;
  const int tid = threadIdx.x;
  if (tid == 0) carry = -1;
  __syncthreads();
  // pass 1: runs and tile starts, PLAN_THREADS / 4 rows at a time; the 4
  // threads of a row compare its table row with row r - 1's, interleaved
  // (thread seg takes pages seg, seg + 4, ...: a warp's load touches 8
  // rows, not 32), 16 pages each a round, all loads of a round in flight
  for (int base = 0; base < b; base += PLAN_THREADS / 4) {
    const int r = base + tid / 4, seg = tid % 4;
    bool joins = false;
    if (r > 0 && r < b) {
      const int live_prev =
          (kv_len_of(pos, r - 1, cap) + page_size - 1) / page_size;
      const int live = (kv_len_of(pos, r, cap) + page_size - 1) / page_size;
      joins = live_prev > 0 && live >= live_prev;
      const int* a = table + (size_t)r * n_blocks;
      const int* p = a - n_blocks;
      for (int j0 = seg; joins && j0 < live_prev; j0 += 64) {
        int x[16], y[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int k = j0 + 4 * j;
          x[j] = k < live_prev ? a[k] : 0;
          y[j] = k < live_prev ? p[k] : 0;
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) joins = joins && x[j] == y[j];
      }
    }
    // the row joins when all four segments agree (lanes 4k .. 4k + 3)
    joins = __shfl_xor_sync(0xffffffffu, (int)joins, 1) && joins;
    joins = __shfl_xor_sync(0xffffffffu, (int)joins, 2) && joins;
    int rs = block_scan(r < b && !joins && seg == 0 ? r : -1, true, buf);
    rs = max(rs, carry);
    if (r < b && seg == 0) start[r] = (r - rs) % rows_per_tile == 0;
    __syncthreads();
    if (tid == PLAN_THREADS - 1) carry = rs;
    __syncthreads();
  }
  if (tid == 0) carry = 0;
  __syncthreads();
  // pass 2: items, in row order
  for (int base = 0; base < b; base += PLAN_THREADS) {
    const int r = base + tid;
    for (int i = tid; i < PLAN_THREADS + BM; i += PLAN_THREADS)
      start_s[i] = base + i < b ? start[base + i] : 1;
    __syncthreads();
    int n_rows = 0, count = 0;
    if (r < b && start_s[tid]) {
      n_rows = 1;
      while (n_rows < rows_per_tile && !start_s[tid + n_rows]) ++n_rows;
      count = split_count((kv_len_of(pos, r + n_rows - 1, cap) + BN - 1) /
                          BN);
    }
    const int incl = block_scan(count, false, buf);
    const int first = carry + incl - count;
    for (int s = 0; s < count; ++s)
      items[first + s] = make_int4(r, n_rows, count > 1 ? s : -1, 0);
    for (int i = 0; i < n_rows; ++i)
      fold[r + i] = count > 1 ? (kv_len_of(pos, r + i, cap) +
                                 SPLIT_TILES * BN - 1) / (SPLIT_TILES * BN)
                              : -1;
    __syncthreads();
    if (tid == PLAN_THREADS - 1) carry = first + count;
    __syncthreads();
  }
  if (tid == 0) plan[0] = carry;
}

// ------------------------------------------------------------ attention

// as hopper::mbar_wait, but traps after ~2 s instead of hanging the card
__device__ __forceinline__ void wait_or_trap(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint64_t t0 = 0;
  for (uint32_t i = 0;; ++i) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if ((i & 1023) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (i == 0) t0 = now;
      else if (now - t0 > 2000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int R>
__device__ __forceinline__ void zero(float (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = 0.f;
}

// Fold a segment's (m, l) into the running (M, L) and return the weights of
// the running o and of the segment's o. Round-to-nearest intrinsics: never
// contracted into FMAs, so both kernels compute the same bits.
__device__ __forceinline__ float2 fold_ml(float& M, float& L, float m,
                                          float l) {
  const float mn = fmaxf(M, m);
  const float a = exp2f(M - mn), b = exp2f(m - mn);
  L = __fadd_rn(__fmul_rn(L, a), __fmul_rn(l, b));
  M = mn;
  return make_float2(a, b);
}
__device__ __forceinline__ float fold_o(float O, float o, float2 w) {
  return __fadd_rn(__fmul_rn(O, w.x), __fmul_rn(o, w.y));
}
// 1 / l, with l == 0 (no live key) read as 1: such a row writes 0
__device__ __forceinline__ float inv_of(float L) {
  return __frcp_rn(L == 0.f ? 1.f : L);
}
// a row's l from the partial sums of the 4 lanes of its quad
__device__ __forceinline__ float quad_sum(float l) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  return l;
}

// The kv tiles of an item: a whole item reads every tile its last row
// holds (at most one segment's), a split the tiles of its segment.
struct Span {
  int row0, n_rows, split, tb, te, live_last;
  __device__ Span(int4 it, const int* pos, int cap, int page_size)
      : row0(it.x), n_rows(it.y), split(it.z) {
    const int kv = kv_len_of(pos, row0 + n_rows - 1, cap);
    live_last = (kv + page_size - 1) / page_size;
    const int n_tiles = (kv + BN - 1) / BN;
    tb = 0;
    te = n_tiles;
    if (split >= 0) {
      tb = split * SPLIT_TILES;
      te = min(n_tiles, tb + SPLIT_TILES);
    }
  }
};

// S (64 x BN) = Q K^T: 16-deep slices of D, 4 to a 64-wide box; both
// operands K-major
template <int DT>
__device__ __forceinline__ void issue_s(float (&sacc)[BN / 2],
                                        const uint8_t* q_s,
                                        const uint8_t* k_s) {
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk) {
    const int c = kk / 4, w = kk % 4;
    wgmma_ss_n64<0>(sacc, desc_sw128(q_s + c * Q_BOX + 32 * w, 16, 1024),
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

__device__ __forceinline__ void keep_regs(uint32_t (&a)[BN / 16][4],
                                          uint32_t (&b)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w)
      asm volatile("" : "+r"(a[kk][w]), "+r"(b[kk][w]));
}

// A persistent grid walks the work units (item, kv head) in a fixed
// stride. Per unit the producer warp brings the tile's Q rows (rows x rep
// heads of one kv head, one TMA box) and then, kv tile by kv tile, the live
// pages of K and V through the last row's table (one TMA box a page and 64
// D-values); the consumer warpgroup runs S = Q K^T and O += P V on wgmma
// with an fp32 online softmax in registers, each M row masked by its own
// kv_len.
template <int DT>
__global__ void __launch_bounds__(THREADS, 2)
paged_attn_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const int* __restrict__ table,
                        const int* __restrict__ pos,
                        const int* __restrict__ plan, bf16* __restrict__ out,
                        float* __restrict__ part, int b, int hq, int hkv,
                        int d, int page_size, int n_blocks,
                        int rows_per_tile, int segs, float scale_log2) {
  using L = Layout<DT>;
  constexpr int NC = L::NC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;                           // [chunk] 8 KB boxes
  uint8_t* k_s = q_s + L::Q_BYTES;               // [stage][chunk] 8 KB
  uint8_t* v_s = k_s + STAGES * L::KV_BYTES;
  __shared__ __align__(8) uint64_t q_full, q_empty, k_full[STAGES],
      v_full[STAGES], kv_empty[STAGES];

  const int rep = hq / hkv;
  const int cap = n_blocks * page_size;
  const int units = plan[0] * hkv;
  const int4* items = reinterpret_cast<const int4*>(plan + items_at(b));

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&kv_empty[i], 1);
    }
    mbar_fence_init();
  }
  // A tile's last kv tile may hold fewer live pages than it has room for;
  // the rest of the stage keeps what an earlier tile left there (finite
  // K/V values, masked to p = 0 as past-cursor positions are). Zero the
  // ring once so that nothing else can be read, then order these writes
  // before the async proxy's reads.
  for (int i = threadIdx.x; i < 2 * STAGES * L::KV_BYTES / 16;
       i += blockDim.x)
    reinterpret_cast<uint4*>(k_s)[i] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // -------------------------------------------------------- producer
    if (threadIdx.x == CONSUMERS) {
      const uint32_t page_bytes = (uint32_t)page_size * 128;
      const int per_tile = BN / page_size;
      int it = 0, uc = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++uc) {
        const Span sp(items[u / hkv], pos, cap, page_size);
        const int g = u % hkv;
        const int* trow = table + (size_t)(sp.row0 + sp.n_rows - 1) * n_blocks;
        wait_or_trap(&q_empty, (uc & 1) ^ 1);    // unit 0 passes at once
        mbar_expect(&q_full, NC * rows_per_tile * rep * 128);
        for (int c = 0; c < NC; ++c)
          tma_load_3d(q_s + c * Q_BOX, &map_q, &q_full, c * 64, g * rep,
                      sp.row0);
        for (int t = sp.tb; t < sp.te; ++t, ++it) {
          const int st = it % STAGES;
          const uint32_t ph = (it / STAGES) & 1;
          const int lp0 = t * per_tile;
          const int np = min(per_tile, sp.live_last - lp0);
          // the tile's page ids first: a load after a TMA issue would wait
          // for it (the asm's memory clobber), one L2 round trip a page
          int pages[BN / 8];
#pragma unroll
          for (int i = 0; i < BN / 8; ++i)
            pages[i] = i < np ? trow[lp0 + i] : 0;
          wait_or_trap(&kv_empty[st], ph ^ 1);
          mbar_expect(&k_full[st], np * NC * page_bytes);
#pragma unroll
          for (int i = 0; i < BN / 8; ++i)
            if (i < np)
              for (int c = 0; c < NC; ++c)
                tma_load_4d(k_s + st * L::KV_BYTES + c * KV_BOX +
                                i * page_bytes,
                            &map_k, &k_full[st], c * 64, g, 0, pages[i]);
          mbar_expect(&v_full[st], np * NC * page_bytes);
#pragma unroll
          for (int i = 0; i < BN / 8; ++i)
            if (i < np)
              for (int c = 0; c < NC; ++c)
                tma_load_4d(v_s + st * L::KV_BYTES + c * KV_BOX +
                                i * page_bytes,
                            &map_v, &v_full[st], c * 64, g, 0, pages[i]);
        }
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumer
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int mrow0 = 16 * (tid / 32) + lane / 4;  // and mrow0 + 8
  const int col0 = 2 * (lane % 4);               // + 8 j + e
  int it = 0, uc = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++uc) {
    const Span sp(items[u / hkv], pos, cap, page_size);
    const int g = u % hkv;
    // M row m is query head g * rep + m % rep of row row0 + m / rep
    int kvl[2], rowi[2], head[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = mrow0 + 8 * i;
      const int rl = m / rep;
      const bool real = rl < sp.n_rows && rl < rows_per_tile;
      rowi[i] = real ? sp.row0 + rl : -1;
      head[i] = g * rep + m % rep;
      kvl[i] = real ? kv_len_of(pos, sp.row0 + rl, cap) : 0;
    }
    float o[DT / 2];
    zero(o);
    float m_run[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this lane's
    float sacc[BN / 2];
    uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];
    wait_or_trap(&q_full, uc & 1);
    if (sp.te <= sp.tb && tid == 0) mbar_arrive(&q_empty);
    for (int t = sp.tb; t < sp.te; ++t, ++it) {
      const int st = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      zero(sacc);
      wait_or_trap(&k_full[st], ph);
      fence_regs(sacc);
      wgmma_fence();
      issue_s<DT>(sacc, q_s, k_s + st * L::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      if (t + 1 == sp.te && tid == 0) mbar_arrive(&q_empty);   // Q read
      // online softmax in the log2 domain; each row lives in the 4 lanes
      // of a quad; a key at or past the row's kv_len gets p = 0 exactly
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m_run[i];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = t * BN + 8 * j + col0 + e;
            float sv = sacc[4 * j + 2 * i + e] * scale_log2;
            sv = kpos < kvl[i] ? sv : -INFINITY;
            sacc[4 * j + 2 * i + e] = sv;
            mx = fmaxf(mx, sv);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        corr[i] = exp2f(m_run[i] - mx);          // m starts finite: no NaN
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(sacc[4 * j + 2 * i + e] - mx);
            sacc[4 * j + 2 * i + e] = p;
            sum += p;
          }
        l[i] = l[i] * corr[i] + sum;
        m_run[i] = mx;
      }
#pragma unroll
      for (int j = 0; j < DT / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * j + 2 * i] *= corr[i];
          o[4 * j + 2 * i + 1] *= corr[i];
        }
      split_p(sacc, p_hi, p_lo);
      wait_or_trap(&v_full[st], ph);
      fence_regs(o);
      wgmma_fence();
      issue_pv<DT>(o, p_hi, p_lo, v_s + st * L::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      keep_regs(p_hi, p_lo);
      if (tid == 0) mbar_arrive(&kv_empty[st]);
    }
    // a whole item writes its one segment folded from the empty state,
    // o / l, as paged_combine_kernel folds; a split writes its segment's
    // unnormalised o, m and l
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float li = quad_sum(l[i]);
      if (rowi[i] < 0) continue;
      if (sp.split < 0) {
        float M = NEG_INF, L = 0.f;
        const float2 w = fold_ml(M, L, m_run[i], li);
        const float inv = inv_of(L);
        bf16* orow = out + ((size_t)rowi[i] * hq + head[i]) * d;
#pragma unroll
        for (int j = 0; j < DT / 8; ++j) {
          const int c = 8 * j + col0;
          if (c < d)
            *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(
                __fmul_rn(fold_o(0.f, o[4 * j + 2 * i], w), inv),
                __fmul_rn(fold_o(0.f, o[4 * j + 2 * i + 1], w), inv));
        }
      } else {
        const size_t slot =
            ((size_t)rowi[i] * segs + sp.split) * hq + head[i];
        float* prow = part + slot * (d + 2);
#pragma unroll
        for (int j = 0; j < DT / 8; ++j) {
          const int c = 8 * j + col0;
          if (c < d)
            *reinterpret_cast<float2*>(prow + c) =
                make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
        }
        if (lane % 4 == 0) {
          prow[d] = m_run[i];
          prow[d + 1] = li;
        }
      }
    }
  }
}

// The rows of split tiles: each row's own segments' partials folded in
// segment order by the attention kernel's fold (fold_ml, fold_o, inv_of),
// then o / l; a row with no key writes 0. One thread 4 output columns
// (D is a multiple of 8), blocks (column quads / COMBINE_THREADS, rows);
// each thread loads 4 segments at a time, then folds them, and every
// thread of a head computes the same (M, L).
__global__ void __launch_bounds__(COMBINE_THREADS)
paged_combine_kernel(const int* __restrict__ plan,
                     const float* __restrict__ part, bf16* __restrict__ out,
                     int hq, int d, int segs) {
  const int r = blockIdx.y;
  const int n = plan[4 + r];
  const int i = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (n < 0 || i >= hq * d / 4) return;
  const int h = 4 * i / d, c = 4 * i % d;
  const size_t step = (size_t)hq * (d + 2);     // one segment's partials
  const float* ph = part + (size_t)r * segs * step + (size_t)h * (d + 2);
  float M = NEG_INF, L = 0.f;
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < n; s0 += 4) {
    float m[4], l[4];
    float4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* ps = ph + (size_t)(s0 + k) * step;
      const bool in = s0 + k < n;
      m[k] = in ? ps[d] : 0.f;
      l[k] = in ? ps[d + 1] : 0.f;
      // a head's (D + 2) floats start 8-byte aligned: two float2 loads
      const float2 a = in ? *reinterpret_cast<const float2*>(ps + c)
                          : make_float2(0.f, 0.f);
      const float2 b = in ? *reinterpret_cast<const float2*>(ps + c + 2)
                          : make_float2(0.f, 0.f);
      v[k] = make_float4(a.x, a.y, b.x, b.y);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (s0 + k < n) {
        const float2 w = fold_ml(M, L, m[k], l[k]);
        x.x = fold_o(x.x, v[k].x, w);
        x.y = fold_o(x.y, v[k].y, w);
        x.z = fold_o(x.z, v[k].z, w);
        x.w = fold_o(x.w, v[k].w, w);
      }
  }
  const float inv = inv_of(L);
  uint2 packed;
  packed.x = pack_bf16(__fmul_rn(x.x, inv), __fmul_rn(x.y, inv));
  packed.y = pack_bf16(__fmul_rn(x.z, inv), __fmul_rn(x.w, inv));
  *reinterpret_cast<uint2*>(out + ((size_t)r * hq + h) * d + c) = packed;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n < 1) n = 1;
  }
  return n;
}

template <int DT>
int launch_dt(const void* q, const void* k, const void* v, const void* table,
              const void* pos, void* out, int* plan, float* part, int b,
              int hq, int hkv, int d, int page_size, int n_pages,
              int n_blocks, cudaStream_t stream) {
  const uint64_t e = sizeof(bf16);
  const int rep = hq / hkv;
  const int rows_per_tile = BM / rep;
  CUtensorMap mq, mk, mv;
  // q (D, Hq, B), innermost first: a box is 64 D-values x rep heads x
  // rows_per_tile rows, one tile's M rows in row-major (row, head) order
  const uint64_t qd[3] = {(uint64_t)d, (uint64_t)hq, (uint64_t)b};
  const uint64_t qs[2] = {d * e, (uint64_t)hq * d * e};
  const uint32_t qbox[3] = {64, (uint32_t)rep, (uint32_t)rows_per_tile};
  // pools (D, Hkv, page position, page): a box is one page of one head
  const uint64_t kd[4] = {(uint64_t)d, (uint64_t)hkv, (uint64_t)page_size,
                          (uint64_t)n_pages};
  const uint64_t ks[3] = {d * e, (uint64_t)hkv * d * e,
                          (uint64_t)page_size * hkv * d * e};
  const uint32_t kbox[4] = {64, 1, (uint32_t)page_size, 1};
  if (!make_map(&mq, q, 3, qd, qs, qbox) ||
      !make_map(&mk, k, 4, kd, ks, kbox) ||
      !make_map(&mv, v, 4, kd, ks, kbox))
    return (int)cudaErrorInvalidValue;
  const int bytes = Layout<DT>::SMEM;
  static bool smem_set = false;               // once a process and D tile
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attn_wgmma_kernel<DT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  paged_plan_kernel<<<1, PLAN_THREADS, 0, stream>>>(
      (const int*)table, (const int*)pos, plan, b, n_blocks, page_size,
      rows_per_tile);
  const int segs = max_segments(n_blocks, page_size);
  const long long most = (long long)b * segs * hkv;
  const int grid = (int)(most < 2LL * sm_count() ? most : 2LL * sm_count());
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)d));
  paged_attn_wgmma_kernel<DT><<<grid, THREADS, bytes, stream>>>(
      mq, mk, mv, (const int*)table, (const int*)pos, plan, (bf16*)out, part,
      b, hq, hkv, d, page_size, n_blocks, rows_per_tile, segs, scale_log2);
  const dim3 cgrid((hq * d / 4 + COMBINE_THREADS - 1) / COMBINE_THREADS, b);
  paged_combine_kernel<<<cgrid, COMBINE_THREADS, 0, stream>>>(
      plan, part, (bf16*)out, hq, d, segs);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v,
                const void* table, const void* pos, void* out, void* plan,
                void* part, int b, int hq, int hkv, int d, int page_size,
                int n_pages, int n_blocks, void* stream) {
  // TMA: 16-byte strides and bases; a page a power of two of 8..BN
  // positions (whole 1024-byte swizzle atoms, whole pages a kv tile)
  const bool page_ok = page_size >= 8 && page_size <= BN &&
                       (page_size & (page_size - 1)) == 0;
  if (b < 0 || hkv < 1 || hq < 1 || hq % hkv != 0 || hq / hkv > MAX_REP ||
      d < 8 || d > 128 || d % 8 != 0 || !page_ok || n_pages < 1 ||
      n_blocks < 1 || (long long)n_blocks * page_size > (1 << 30) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) ||
      !aligned16(plan))
    return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  return d <= 64
      ? launch_dt<64>(q, k, v, table, pos, out, (int*)plan, (float*)part, b,
                      hq, hkv, d, page_size, n_pages, n_blocks, st)
      : launch_dt<128>(q, k, v, table, pos, out, (int*)plan, (float*)part, b,
                       hq, hkv, d, page_size, n_pages, n_blocks, st);
}

}  // namespace tc

extern "C" int paged_attention_f32(const void* q, const void* k,
                                   const void* v, const void* table,
                                   const void* pos, void* out, int b, int hq,
                                   int hkv, int d, int page_size,
                                   int n_blocks, void* stream) {
  return launch<float>(q, k, v, table, pos, out, b, hq, hkv, d, page_size,
                       n_blocks, stream);
}

// the bf16 entry's scratch for a (b, n_blocks) table: sizes[0] int32 plan
// words, sizes[1] fp32 words of split partials (rows x segments x Hq x
// (D + 2))
extern "C" int paged_attention_bf16_scratch(int b, int hq, int d,
                                            int n_blocks, int page_size,
                                            long long* sizes) {
  const int segs = tc::max_segments(n_blocks, page_size);
  sizes[0] = tc::plan_ints(b, segs);
  sizes[1] = (long long)b * segs * hq * (d + 2);
  return 0;
}

extern "C" int paged_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* table,
                                    const void* pos, void* out, void* plan,
                                    void* part, int b, int hq, int hkv,
                                    int d, int page_size, int n_pages,
                                    int n_blocks, void* stream) {
  return tc::launch_bf16(q, k, v, table, pos, out, plan, part, b, hq, hkv, d,
                         page_size, n_pages, n_blocks, stream);
}

// the plan alone (tests compare it with kernels/paged_attention.py::
// tile_plan): plan as the bf16 entry's scratch, rep = Hq / Hkv
extern "C" int paged_attention_plan(const void* table, const void* pos,
                                    void* plan, int b, int n_blocks,
                                    int page_size, int rep, void* stream) {
  if (b < 1 || rep < 1 || rep > tc::MAX_REP || n_blocks < 1 || page_size < 1)
    return (int)cudaErrorInvalidValue;
  tc::paged_plan_kernel<<<1, tc::PLAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)table, (const int*)pos, (int*)plan, b, n_blocks, page_size,
      tc::BM / rep);
  return (int)cudaGetLastError();
}
