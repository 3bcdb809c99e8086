// Modified-EllPack SpMV for Hopper (sm_90a), every rank in one launch:
//   y[q, i] = diag[q, i] * x[q, base + own_rel[q, i]]
//             + sum_j vals[q, i, j] * x[q, base + cols_rel[q, i, j]],
//   base = win_blk[q, i / rows_per_block] * window,
// summed in float32 from float32 or bfloat16 diag/vals and x; y in the
// matrix's type.
//
// Replaces the Pallas TPU kernel ellpack_spmv_windowed of
// src/repro/kernels/ellpack_spmv.py (pallas_call at :79), reached through
// repro.kernels.ops._spmv_call, make_spmv_on_copy_sharded and both partials
// of make_spmv_overlap_sharded.
//
// What bounds it on this card: bytes, and among them the gathers of x.  Per
// row it streams r_nz values and column indices, the diagonal and the own
// index, writes one value, and gathers r_nz + 1 values of x, for
// 2 * (r_nz + 1) flops: well under one flop per byte.  At the main path's
// matrix (a band of 2 * n / 64 columns) a row's gathers land in r_nz
// different 32-byte sectors of L2, four times the streamed bytes in sector
// traffic: gathered in row order they alone take 0.45 ms of the row-order
// kernel's 0.52 (tools/spmv_kernel_bench.py).
//
// The TPU kernel DMA'd a planned column window of x (two adjacent window
// tiles) into VMEM for each row block, so the irregular gather stayed on
// chip, and the caller padded every x_copy to a whole number of windows for
// it.  Here x is read in place at the same absolute positions
// win_blk * window + cols_rel (a rank's band of x, a few MB, stays in the
// 50 MB L2), and no padded copy of x is made.  The caller guarantees, from
// the host-side plan, that every position lies inside x.
//
// Column-sorted kernel (r_nz a multiple of 4, at most 32): a block takes
// kSortRows consecutive rows of one rank.  An order table built once per
// plan (kernels/ellpack_spmv.py order_table) lists the group's entries
// sorted by the x position they read, each with its slot (row in group *
// r_nz + j).  Phase A: the block walks the sorted list, gathers x[pos] --
// neighbouring entries now read neighbouring columns, so a warp's 32 reads
// touch a few sectors rather than 32 -- and parks each value at its slot in
// shared memory.  Phase B: each row's lanes read its values back from
// shared memory, 16 bytes a lane, and compute as the row-order kernel does.
// The table costs 6 bytes a streamed entry; the gathers' sector traffic
// falls by some 3x.  Two blocks fill an SM (64 KB of shared memory each at
// r_nz 16), so one block's gathers overlap the other's stream.
//
// Row-order kernel (every other shape): a group of `lanes` threads (a power
// of two, at most 32) works on a row; where r_nz is a multiple of 4 and the
// rows are aligned, lane j reads entries 4j..4j+3 with one 16- (float32) or
// 8-byte (bfloat16) load of vals and one 16-byte load of cols_rel, else entry
// j.  A lane's streamed loads (its entries, the window, and for lane 0 the
// diagonal and own index) are issued before any of its gathers.
//
// Both kernels add the same way: each lane sums its entries in j order with
// fused multiply-adds, the group's partial sums meet through warp shuffles
// (xor lanes/2, ..., 1), and lane 0 adds diag * own with one more fused
// multiply-add.  No atomics: the result is the same, bit for bit, from call
// to call.  `diag` may be null (the foreign partial of the overlap rung has
// no diagonal term); then `own_rel` is not read.
//
// Every entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;        // the row-order kernel's block
constexpr int kSortThreads = 1024;   // the column-sorted kernel's block
constexpr int kSortRows = 1024;      // SORT_ROWS in kernels/ellpack_spmv.py
constexpr int kSortBatch = 8;        // gathers a thread issues at once

struct Spmv {
  const void* diag;           // (P, rows) TM or null
  const void* vals;           // (P, rows, r_nz) TM
  const int32_t* cols_rel;    // (P, rows, r_nz); unused by the sorted kernel
  const int32_t* own_rel;     // (P, rows)
  const int32_t* win_blk;     // (P, rows / rows_per_block)
  const void* x;              // (P, x_stride) TX
  void* y;                    // (P, rows) TM
  unsigned rows;
  int r_nz;
  unsigned rows_per_block;
  long long window, x_stride;
};

__device__ __forceinline__ float gather(const float* p) { return __ldg(p); }
__device__ __forceinline__ float gather(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four consecutive matrix values as floats: one 16- or 8-byte load.
template <typename TM>
__device__ __forceinline__ void load_vals4(const TM* p, float (&v)[4]) {
  if constexpr (sizeof(TM) == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    const uint2 b = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(b.x << 16), v[1] = __uint_as_float(b.x & 0xffff0000u);
    v[2] = __uint_as_float(b.y << 16), v[3] = __uint_as_float(b.y & 0xffff0000u);
  }
}

// Lane 0's part of row `row`: the diagonal and the own value of x.
template <typename TM, typename TX>
__device__ __forceinline__ void own_term(const Spmv& a, size_t rank,
                                         unsigned row, const TX* xr,
                                         float& d, float& own) {
  const unsigned nblk = a.rows / a.rows_per_block;
  const size_t i = rank * a.rows + row;
  const long long base =
      static_cast<long long>(__ldg(a.win_blk + rank * nblk +
                                   row / a.rows_per_block)) * a.window;
  d = to_float(static_cast<const TM*>(a.diag)[i]);
  own = gather(xr + base + __ldg(a.own_rel + i));
}

// The partial sums of a row's `lanes` lanes, then y.
template <typename TM>
__device__ __forceinline__ void finish_row(const Spmv& a, size_t i, int lanes,
                                           bool active, bool lead, float acc,
                                           float d, float own) {
  // every lane of the warp takes part, inactive rows with acc = 0
  for (int s = lanes >> 1; s > 0; s >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, s, lanes);
  }
  if (active && (threadIdx.x & (lanes - 1)) == 0) {
    store(static_cast<TM*>(a.y) + i, lead ? __fmaf_rn(d, own, acc) : acc);
  }
}

// Row order: one row a lane group, kVec entries a lane and load.
template <typename TM, typename TX, int kVec>
__global__ void __launch_bounds__(kThreads)
    ellpack_spmv_kernel(const Spmv a, int lanes) {
  // 32-bit row math inside a rank (rows < 2^31, checked by the host): a
  // 64-bit division is a long software routine on the GPU
  const size_t rank = blockIdx.y;
  const int sub = threadIdx.x & (lanes - 1);
  const unsigned row = blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  const bool active = row < a.rows;
  const bool lead = a.diag != nullptr;
  const TM* vals = static_cast<const TM*>(a.vals);
  const TX* xr = static_cast<const TX*>(a.x) + rank * a.x_stride;
  const size_t i = rank * a.rows + row;
  float acc = 0.0f, d = 0.0f, own = 0.0f;
  if (active) {
    const unsigned nblk = a.rows / a.rows_per_block;
    const TX* xb = xr + static_cast<long long>(__ldg(
                            a.win_blk + rank * nblk + row / a.rows_per_block)) *
                            a.window;
    if (lead && sub == 0) own_term<TM>(a, rank, row, xr, d, own);
    for (int j = sub; j < a.r_nz / kVec; j += lanes) {
      const size_t off = i * a.r_nz + static_cast<size_t>(j) * kVec;
      float v[kVec], g[kVec];
      if constexpr (kVec == 4) {
        load_vals4<TM>(vals + off, v);
        const int4 c = __ldg(reinterpret_cast<const int4*>(a.cols_rel + off));
        g[0] = gather(xb + c.x), g[1] = gather(xb + c.y);
        g[2] = gather(xb + c.z), g[3] = gather(xb + c.w);
      } else {
        v[0] = to_float(vals[off]);
        g[0] = gather(xb + __ldg(a.cols_rel + off));
      }
#pragma unroll
      for (int u = 0; u < kVec; ++u) acc = __fmaf_rn(v[u], g[u], acc);
    }
  }
  finish_row<TM>(a, i, lanes, active, lead, acc, d, own);
}

// Column-sorted: one group of kSortRows rows a block (see the note above).
template <typename TM, typename TX>
__global__ void __launch_bounds__(kSortThreads)
    ellpack_spmv_sorted_kernel(const Spmv a, const int32_t* __restrict__ pos,
                               const uint16_t* __restrict__ slot, int lanes,
                               unsigned groups_per_rank) {
  extern __shared__ __align__(16) float parked[];
  const size_t rank = blockIdx.x / groups_per_rank;
  const unsigned row0 = (blockIdx.x - rank * groups_per_rank) * kSortRows;
  const unsigned rows = min(a.rows - row0, static_cast<unsigned>(kSortRows));
  const unsigned r_nz = a.r_nz;
  const TX* xr = static_cast<const TX*>(a.x) + rank * a.x_stride;
  // phase A: the group's entries in column order
  const unsigned n = rows * r_nz;
  const size_t e0 = (rank * a.rows + row0) * r_nz;
  for (unsigned u0 = threadIdx.x; u0 < n; u0 += kSortBatch * kSortThreads) {
    int p[kSortBatch];
    unsigned sl[kSortBatch];
    float v[kSortBatch];
#pragma unroll
    for (int k = 0; k < kSortBatch; ++k) {
      const unsigned u = u0 + k * kSortThreads;
      p[k] = u < n ? __ldcs(pos + e0 + u) : 0;
      sl[k] = u < n ? __ldcs(reinterpret_cast<const unsigned short*>(slot) +
                             e0 + u)
                    : 0u;
    }
#pragma unroll
    for (int k = 0; k < kSortBatch; ++k) {
      v[k] = u0 + k * kSortThreads < n ? gather(xr + p[k]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kSortBatch; ++k) {
      if (u0 + k * kSortThreads < n) parked[sl[k]] = v[k];
    }
  }
  __syncthreads();
  // phase B: the rows, x from shared memory
  const int sub = threadIdx.x & (lanes - 1);
  const unsigned groups = kSortThreads / lanes;
  const int per_row = static_cast<int>(r_nz) / 4;
  const TM* vals = static_cast<const TM*>(a.vals);
  const bool lead = a.diag != nullptr;
  for (unsigned r0 = 0; r0 < rows; r0 += groups) {
    const unsigned r = r0 + threadIdx.x / lanes;
    const bool active = r < rows;
    const size_t i = rank * a.rows + row0 + r;
    float acc = 0.0f, d = 0.0f, own = 0.0f;
    if (active) {
      if (lead && sub == 0) own_term<TM>(a, rank, row0 + r, xr, d, own);
      for (int j = sub; j < per_row; j += lanes) {
        float v[4];
        load_vals4<TM>(vals + i * r_nz + 4 * j, v);
        const float4 g =
            *reinterpret_cast<const float4*>(parked + r * r_nz + 4 * j);
        acc = __fmaf_rn(v[0], g.x, acc);
        acc = __fmaf_rn(v[1], g.y, acc);
        acc = __fmaf_rn(v[2], g.z, acc);
        acc = __fmaf_rn(v[3], g.w, acc);
      }
    }
    finish_row<TM>(a, i, lanes, active, lead, acc, d, own);
  }
}

int lanes_for(long long per_row) {
  int lanes = 1;
  while (lanes < per_row && lanes < 32) lanes <<= 1;
  return lanes;
}

template <typename TM, typename TX>
int launch(const Spmv& a, long long p, int vec4, cudaStream_t s) {
  const int lanes = lanes_for(vec4 ? a.r_nz / 4 : a.r_nz);
  const long long rows_per_cta = kThreads / lanes;
  const dim3 grid(
      static_cast<unsigned>((a.rows + rows_per_cta - 1) / rows_per_cta),
      static_cast<unsigned>(p));
  if (vec4) ellpack_spmv_kernel<TM, TX, 4><<<grid, kThreads, 0, s>>>(a, lanes);
  else ellpack_spmv_kernel<TM, TX, 1><<<grid, kThreads, 0, s>>>(a, lanes);
  return static_cast<int>(cudaGetLastError());
}

template <typename TM, typename TX>
int launch_sorted(const Spmv& a, long long p, const void* pos,
                  const void* slot, cudaStream_t s) {
  auto kernel = ellpack_spmv_sorted_kernel<TM, TX>;
  const int smem = kSortRows * a.r_nz * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_rank = (a.rows + kSortRows - 1) / kSortRows;
  kernel<<<static_cast<unsigned>(per_rank * p), kSortThreads, smem, s>>>(
      a, static_cast<const int32_t*>(pos), static_cast<const uint16_t*>(slot),
      lanes_for(a.r_nz / 4), static_cast<unsigned>(per_rank));
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(long long p, long long rows, long long r_nz,
              long long rows_per_block, int tm, int tx) {
  return rows >= (1LL << 31) || rows_per_block <= 0 || rows % rows_per_block ||
         r_nz < 1 || r_nz >= (1LL << 31) || p > 65535 || (tm != 0 && tm != 1) ||
         (tx != 0 && tx != 1);
}

Spmv make(const void* diag, const void* vals, const void* cols_rel,
          const void* own_rel, const void* win_blk, const void* x, void* y,
          long long rows, long long r_nz, long long rows_per_block,
          long long window, long long x_stride) {
  return Spmv{diag, vals, static_cast<const int32_t*>(cols_rel),
              static_cast<const int32_t*>(own_rel),
              static_cast<const int32_t*>(win_blk), x, y,
              static_cast<unsigned>(rows), static_cast<int>(r_nz),
              static_cast<unsigned>(rows_per_block), window, x_stride};
}

}  // namespace

extern "C" {

// The row-order kernel.  dtypes: 0 = float32, 1 = bfloat16 (tm: diag, vals
// and y; tx: x).
int rt_ellpack_spmv(const void* diag, const void* vals, const void* cols_rel,
                    const void* own_rel, const void* win_blk, const void* x,
                    void* y, long long p, long long rows, long long r_nz,
                    long long rows_per_block, long long window,
                    long long x_stride, int tm, int tx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 0 || rows == 0) return cudaGetLastError();
  if (bad_args(p, rows, r_nz, rows_per_block, tm, tx))
    return static_cast<int>(cudaErrorInvalidValue);
  // rows of a multiple of 4 entries, aligned: vector loads
  const int vec4 = r_nz % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % (tm == 0 ? 16 : 8) == 0 &&
                   reinterpret_cast<uintptr_t>(cols_rel) % 16 == 0;
  const Spmv a = make(diag, vals, cols_rel, own_rel, win_blk, x, y, rows, r_nz,
                      rows_per_block, window, x_stride);
  if (tm == 0 && tx == 0) return launch<float, float>(a, p, vec4, s);
  if (tm == 0) return launch<float, __nv_bfloat16>(a, p, vec4, s);
  if (tx == 0) return launch<__nv_bfloat16, float>(a, p, vec4, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(a, p, vec4, s);
}

// The column-sorted kernel: pos (P, rows * r_nz) int32 and slot (P, rows *
// r_nz) uint16, the order table for groups of 1024 rows; r_nz a multiple
// of 4 and at most 32, vals aligned to 16 (float32) or 8 (bfloat16) bytes.
int rt_ellpack_spmv_sorted(const void* diag, const void* vals, const void* pos,
                           const void* slot, const void* own_rel,
                           const void* win_blk, const void* x, void* y,
                           long long p, long long rows, long long r_nz,
                           long long rows_per_block, long long window,
                           long long x_stride, int tm, int tx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 0 || rows == 0) return cudaGetLastError();
  if (bad_args(p, rows, r_nz, rows_per_block, tm, tx) || r_nz % 4 ||
      r_nz > 32 || p * rows * r_nz >= (1LL << 40) ||
      reinterpret_cast<uintptr_t>(vals) % (tm == 0 ? 16 : 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Spmv a = make(diag, vals, nullptr, own_rel, win_blk, x, y, rows, r_nz,
                      rows_per_block, window, x_stride);
  if (tm == 0 && tx == 0) return launch_sorted<float, float>(a, p, pos, slot, s);
  if (tm == 0) return launch_sorted<float, __nv_bfloat16>(a, p, pos, slot, s);
  if (tx == 0) return launch_sorted<__nv_bfloat16, float>(a, p, pos, slot, s);
  return launch_sorted<__nv_bfloat16, __nv_bfloat16>(a, p, pos, slot, s);
}

}  // extern "C"
