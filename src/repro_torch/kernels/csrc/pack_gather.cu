// Exchange fast path for Hopper (sm_90a): the pack and the two unpacks that
// surround the strategy ladder's all_to_all, and the dest rungs' unpack
// fused with their slot product.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/pack_gather.py:
//   * rt_pack_gather          <- pack_gather        (pallas_call at :119)
//   * rt_unpack_scatter_set,
//     rt_unpack_scatter_tiles <- unpack_scatter_set (pallas_call at :240)
//   * rt_unpack_dest,
//     rt_unpack_dest_sorted   <- unpack_dest        (pallas_call at :185)
//   * rt_unpack_dest_spmv_sorted <- unpack_dest followed by the dest rungs'
//                               EllPack slot product (the reference leaves
//                               the product to XLA)
//
// What bounds them on this card: bytes.  Each moves every element once and
// does at most two multiplies and an add per element, far below the card's
// ~20 flops per byte of device memory bandwidth.  The TPU kernels kept the
// whole shard resident in VMEM so that the irregular reads stayed on chip;
// an H100 block has 227 KB of shared memory, less than one shard, so these
// kernels read the irregular side straight from device memory and keep the
// regular side coalesced:
//   * one item per (row, 16/8/4/2/1-byte chunk) — consecutive threads
//     touch consecutive bytes of the output (pack, unpack_dest) or of the
//     landed message (scatter), the widest vector the row width and the
//     pointers' alignment allow; the data is copied as raw bits, so every
//     dtype of a given width shares one instantiation and bf16 rides the
//     2-byte path;
//   * each thread takes four items and issues all their loads before any
//     store, so the dependent index -> value reads of several items are in
//     flight at once (latency, not bandwidth, limits a one-item thread);
//   * every kernel takes the leading rank axis as grid.y (or folds it into
//     grid.x), so one launch serves all P virtual ranks of the loopback
//     communicator.
//
// unpack_scatter_set, with the plan's tile table (rt_unpack_scatter_tiles):
// one pass in which a block owns a tile of about 16 KB of one rank's
// output.  The table (kernels/pack_gather.py tile_table, built once per plan)
// lists the rank's landed rows sorted by target, with each tile's first entry,
// so a block finds the landed rows of its tile as one contiguous stretch.  Of
// the rows that share a target the table keeps only the last: the padding of
// every message targets the one dump row, and a block that placed all of it
// would hold up the whole launch.  The block fills the tile in shared memory
// with zeros, or with the own rows where the tile meets the own range, places
// the landed rows whose target is not an own row (the own rows win, as in the
// reference where the own memcpy lands last), and writes the tile once,
// coalesced.  A tile that no landed row targets, or that lies wholly in the own
// range, goes straight to the output.  Rows of a tile or more (the table then
// gives each row a tile of its own, and keeps at most one landed row for it)
// skip shared memory: a block copies a chunk of one row from its one source —
// the own row, the landed row or zeros — straight to the output (Heat2D's
// blockwise rung lands whole 8 MB blocks).  So every output element is written
// once, where the three-phase kernel below wrote the own rows and the landed
// rows twice and the landed ones out of order.
//
// Without a table (rt_unpack_scatter_set) it runs as stream-ordered phases: a
// zero fill of the whole output (cudaMemsetAsync), the own rows copied from
// x_own to the rank's offset, and the scatter of the landed rows, which skips
// any target inside the own range.  The rows after the dump row (the zero
// slots) are never scatter targets.
//
// unpack_dest computes recv[src]*float(rem) + x[own]*float(own) with both
// products and the add rounded separately (__fmul_rn/__fadd_rn, no fused
// multiply-add), as the reference does, and reads both sources even where a
// mask is 0 — so -0.0, inf and NaN come out bit-identical.  Its slots read recv
// and x at random, one 32-byte L2 sector for 4 useful bytes, and stream 14
// bytes a slot of plan arrays.  With the plan's dest table
// (rt_unpack_dest_sorted; kernels/pack_gather.py dest_table, built once per
// plan where the arrays have their planner's structure) a block takes a group
// of slots of one rank (49,152 in the planners' tables: 192 KB of shared
// memory, one block an SM) and walks them sorted by the position their
// selected source reads, so that neighbouring threads read neighbouring
// positions and share sectors; the larger the group, the more of a band's
// reads share a sector (tools/spmv_kernel_bench.py b3_group).  Each entry is
// one int32 code in place of src, own and the two masks (a foreign slot: its
// recv position; an owned slot: ~ its x position; a zero slot: INT_MIN) and
// the uint16 slot it lands in.  The kernel rebuilds both operands and both
// masks from the code (the unselected index is 0, or for the replicate rung's
// owned slots the same element's recv position, own + shift[q]), computes a*ma
// + b*mb exactly as above, parks the value in shared memory at its slot and
// writes the group's slots out in slot order, coalesced: 6 bytes a slot of
// table where the plan's arrays took 10.
//
// unpack_dest_spmv: y[q, i] = diag[q, i] * x[q, i] + sum_j vals[q, i, j] *
// slot[q, i * r + j], where slot is unpack_dest's value (rounded to the slot
// type), computed in registers or parked in shared memory and never written to
// device memory.  It runs through the dest table only
// (rt_unpack_dest_spmv_sorted): a block stages a group of whole rows as above
// and then sums each row from shared memory as the column-sorted SpMV kernel
// (csrc/ellpack_spmv.cu) does: a group of lanes a row, fused multiply-adds in
// j order, the lanes' sums met by a butterfly, then fma(diag, x, sum).  Sums
// in float32; no atomics, so the same bits from call to call.
//
// Every entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Each thread handles kUnroll items of a tile, kThreads apart (so every
// load instruction of a warp stays coalesced), and issues all their loads
// before any store: several independent reads in flight per thread.
constexpr int kUnroll = 4;
constexpr unsigned kTile = kThreads * kUnroll;
constexpr long long kMaxBlocks = 1LL << 20;
// Per-rank extents stay below 2^31 (the host functions check), so the index
// math inside a rank is 32-bit: a 64-bit division is a long software
// routine on the GPU and dominated these kernels' first version.  Rows of
// one vector (kUnit) skip the division altogether.
constexpr long long kMaxPerRank = 1LL << 31;

dim3 grid_for(long long work_per_rank, long long p) {
  long long blocks = (work_per_rank + kTile - 1) / kTile;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(p));
}

// Largest vector width (bytes) dividing the row width and every address.
int vec_bytes(long long row_bytes, const void* a, const void* b,
              const void* c) {
  int v = 16;
  auto fits = [&](int w) {
    return row_bytes % w == 0 &&
           reinterpret_cast<uintptr_t>(a) % w == 0 &&
           reinterpret_cast<uintptr_t>(b) % w == 0 &&
           reinterpret_cast<uintptr_t>(c) % w == 0;
  };
  while (v > 1 && !fits(v)) v >>= 1;
  return v;
}

// The tiles of one rank's `total` items that this block visits.
#define FOR_TILES(start, total)                                   \
  for (unsigned start = blockIdx.x * kTile; start < (total);      \
       start += gridDim.x * kTile)

__device__ __forceinline__ unsigned item(unsigned start, int u) {
  return start + u * kThreads + threadIdx.x;
}

template <typename V, bool kUnit>
__global__ void pack_gather_kernel(const V* __restrict__ x,
                                   const int32_t* __restrict__ idx,
                                   V* __restrict__ out, unsigned shard_rows,
                                   unsigned m, unsigned row_vecs) {
  const size_t rank = blockIdx.y;
  const unsigned total = m * row_vecs;
  const V* xr = x + rank * shard_rows * row_vecs;
  const int32_t* ir = idx + rank * m;
  V* outr = out + rank * total;
  FOR_TILES(start, total) {
    size_t from[kUnroll];
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned t = item(start, u);
      if (t < total) {
        const unsigned k = kUnit ? t : t / row_vecs;
        from[u] = static_cast<size_t>(ir[k]) * row_vecs + (t - k * row_vecs);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (item(start, u) < total) v[u] = xr[from[u]];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned t = item(start, u);
      if (t < total) outr[t] = v[u];
    }
  }
}

// After the zero fill: the own rows from x_own at offsets[rank].
template <typename V>
__global__ void copy_own_kernel(const V* __restrict__ x_own,
                                const int32_t* __restrict__ offsets,
                                V* __restrict__ out, unsigned rows_own,
                                unsigned out_len, unsigned row_vecs) {
  const size_t rank = blockIdx.y;
  const unsigned total = rows_own * row_vecs;
  const V* xr = x_own + rank * total;
  V* outr = out + (rank * out_len + static_cast<unsigned>(offsets[rank])) *
                      row_vecs;
  FOR_TILES(start, total) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned t = item(start, u);
      if (t < total) v[u] = xr[t];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned t = item(start, u);
      if (t < total) outr[t] = v[u];
    }
  }
}

// The landed rows to their targets, own-range targets skipped.
template <typename V, bool kUnit>
__global__ void scatter_kernel(const V* __restrict__ recv,
                               const int32_t* __restrict__ idx,
                               const int32_t* __restrict__ offsets,
                               V* __restrict__ out, unsigned n_recv,
                               unsigned rows_own, unsigned out_len,
                               unsigned row_vecs, int copy_own) {
  const size_t rank = blockIdx.y;
  const unsigned total = n_recv * row_vecs;
  const unsigned off = copy_own ? offsets[rank] : 0u;
  const V* rr = recv + rank * total;
  const int32_t* ir = idx + rank * n_recv;
  V* outr = out + rank * static_cast<size_t>(out_len) * row_vecs;
  FOR_TILES(start, total) {
    size_t to[kUnroll];
    bool keep[kUnroll];
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned t = item(start, u);
      keep[u] = false;
      if (t < total) {
        const unsigned k = kUnit ? t : t / row_vecs;
        const unsigned d = ir[k];
        // unsigned: d - off < rows_own means off <= d < off + rows_own
        keep[u] = !(copy_own && d - off < rows_own);
        to[u] = static_cast<size_t>(d) * row_vecs + (t - k * row_vecs);
        v[u] = rr[t];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (keep[u]) outr[to[u]] = v[u];
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, bool kUnit>
__global__ void unpack_dest_kernel(const T* __restrict__ recv,
                                   const T* __restrict__ x,
                                   const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ own,
                                   const int8_t* __restrict__ own_mask,
                                   const int8_t* __restrict__ rem_mask,
                                   T* __restrict__ out, unsigned n_recv,
                                   unsigned shard, unsigned slots,
                                   unsigned feat) {
  const size_t rank = blockIdx.y;
  const unsigned total = slots * feat;
  const T* rr = recv + rank * n_recv * feat;
  const T* xr = x + rank * shard * feat;
  const size_t mo = rank * slots;
  T* outr = out + rank * total;
  FOR_TILES(start, total) {
    size_t ia[kUnroll], ib[kUnroll];
    float ma[kUnroll], mb[kUnroll], a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned t = item(start, u);
      if (t < total) {
        const unsigned l = kUnit ? t : t / feat;
        const unsigned f = t - l * feat;
        ia[u] = static_cast<size_t>(src[mo + l]) * feat + f;
        ib[u] = static_cast<size_t>(own[mo + l]) * feat + f;
        ma[u] = static_cast<float>(rem_mask[mo + l]);
        mb[u] = static_cast<float>(own_mask[mo + l]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (item(start, u) < total) {
        a[u] = to_f32(rr[ia[u]]);
        b[u] = to_f32(xr[ib[u]]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned t = item(start, u);
      if (t < total) {
        outr[t] = from_f32<T>(
            __fadd_rn(__fmul_rn(a[u], ma[u]), __fmul_rn(b[u], mb[u])));
      }
    }
  }
}

// ---- unpack_dest and unpack_dest_spmv through the plan's dest table ----

constexpr int kDestThreads = 1024;
// the most slots a group may have: its values in shared memory, its slots
// in uint16 (GROUP_SLOTS in kernels/pack_gather.py is the planners' size)
constexpr int kDestSlots = 57344;
constexpr int kDestBatch = 8;       // entries a thread stages at once
constexpr int kZeroCode = INT_MIN;  // the code of a zero slot

// One rank's inputs of the table kernels.
template <typename T>
struct DestTab {
  const T* recv;          // (P, n_recv)
  const T* x;             // (P, shard)
  const int32_t* code;    // (P, slots), sorted within each group
  const uint16_t* slot;   // (P, slots): the entry's slot in its group
  const int32_t* shift;   // (P,) or null
  long long n_recv, shard, slots;
};

// Stage the entries [e0, e0 + n) of rank `rank` (one group): rebuild each
// entry's operands and masks from its code, compute the slot value as
// unpack_dest does (rounded to T) and park it at its slot.
template <typename T>
__device__ __forceinline__ void stage_group(const DestTab<T>& d, size_t rank,
                                            size_t e0, unsigned n,
                                            float* parked) {
  const T* rr = d.recv + rank * d.n_recv;
  const T* xr = d.x + rank * d.shard;
  const int shift = d.shift == nullptr ? -1 : __ldg(d.shift + rank);
  for (unsigned u0 = threadIdx.x; u0 < n; u0 += kDestBatch * kDestThreads) {
    int c[kDestBatch];
    unsigned sl[kDestBatch];
    float a[kDestBatch], b[kDestBatch];
#pragma unroll
    for (int k = 0; k < kDestBatch; ++k) {
      const unsigned u = u0 + k * kDestThreads;
      c[k] = u < n ? __ldcs(d.code + e0 + u) : kZeroCode;
      sl[k] = u < n ? __ldcs(reinterpret_cast<const unsigned short*>(d.slot) +
                             e0 + u)
                    : 0u;
    }
#pragma unroll
    for (int k = 0; k < kDestBatch; ++k) {
      // foreign: recv[c]; owned: x[~c] and recv[~c + shift] (recv[0]
      // without a shift); zero: recv[0] and x[0]
      const bool rem = c[k] >= 0, own = !rem && c[k] != kZeroCode;
      const int ia = rem ? c[k] : (own && shift >= 0 ? ~c[k] + shift : 0);
      const int ib = own ? ~c[k] : 0;
      a[k] = to_f32(rr[ia]);
      b[k] = to_f32(xr[ib]);
    }
#pragma unroll
    for (int k = 0; k < kDestBatch; ++k) {
      if (u0 + k * kDestThreads < n) {
        const bool rem = c[k] >= 0, own = !rem && c[k] != kZeroCode;
        const float v = __fadd_rn(__fmul_rn(a[k], rem ? 1.0f : 0.0f),
                                  __fmul_rn(b[k], own ? 1.0f : 0.0f));
        parked[sl[k]] = to_f32(from_f32<T>(v));
      }
    }
  }
}

// unpack_dest: one group of `group` slots a block, written in slot order.
template <typename T>
__global__ void __launch_bounds__(kDestThreads)
    unpack_dest_sorted_kernel(const DestTab<T> d, T* __restrict__ out,
                              unsigned group, unsigned groups_per_rank,
                              int vec4) {
  extern __shared__ __align__(16) float parked[];
  const size_t rank = blockIdx.x / groups_per_rank;
  const size_t g0 =
      static_cast<size_t>(blockIdx.x - rank * groups_per_rank) * group;
  const size_t left = static_cast<size_t>(d.slots) - g0;
  const unsigned n = left < group ? static_cast<unsigned>(left) : group;
  const size_t e0 = rank * d.slots + g0;
  stage_group(d, rank, e0, n, parked);
  __syncthreads();
  T* o = out + e0;
  unsigned s = threadIdx.x;
  if constexpr (sizeof(T) == 4) {
    if (vec4) {   // 16-byte stores; the host checked the alignment
      for (; 4 * s + 3 < n; s += kDestThreads) {
        reinterpret_cast<float4*>(o)[s] =
            reinterpret_cast<const float4*>(parked)[s];
      }
      s = (n & ~3u) + threadIdx.x;
    }
  }
  for (; s < n; s += kDestThreads) o[s] = from_f32<T>(parked[s]);
}

// The lane groups' sums of a row, then y (every lane of the warp takes part).
template <typename T>
__device__ __forceinline__ void dest_row_out(T* y, size_t i, int lanes,
                                             bool active, const T* diag,
                                             const T* xr, unsigned row,
                                             float acc) {
  for (int s = lanes >> 1; s > 0; s >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, s, lanes);
  }
  if (active && (threadIdx.x & (lanes - 1)) == 0) {
    if (diag != nullptr) {
      acc = __fmaf_rn(to_f32(diag[i]), to_f32(xr[row]), acc);
    }
    y[i] = from_f32<T>(acc);
  }
}

// unpack_dest_spmv: one group of group_rows rows (group_rows * r slots) a
// block.  vec4: r a multiple of 4 and vals aligned to four elements.
template <typename T>
__global__ void __launch_bounds__(kDestThreads)
    dest_spmv_sorted_kernel(const DestTab<T> d, const T* __restrict__ vals,
                            const T* __restrict__ diag, T* __restrict__ y,
                            unsigned rows, int r, unsigned group_rows,
                            unsigned groups_per_rank, int lanes, int vec4) {
  extern __shared__ __align__(16) float parked[];
  const size_t rank = blockIdx.x / groups_per_rank;
  const unsigned row0 = (blockIdx.x - rank * groups_per_rank) * group_rows;
  const unsigned nrows = min(rows - row0, group_rows);
  const size_t e0 = rank * d.slots + static_cast<size_t>(row0) * r;
  stage_group(d, rank, e0, nrows * r, parked);
  __syncthreads();
  const T* xr = d.x + rank * d.shard;
  const int sub = threadIdx.x & (lanes - 1);
  const int step = vec4 ? 4 : 1;
  for (unsigned q0 = 0; q0 < nrows; q0 += kDestThreads / lanes) {
    const unsigned rr = q0 + threadIdx.x / lanes;
    const bool active = rr < nrows;
    const size_t i = rank * rows + row0 + rr;
    float acc = 0.0f;
    if (active) {
      const T* v = vals + i * r;
      const float* g = parked + rr * r;
      for (int j = sub * step; j < r; j += lanes * step) {
        if (vec4) {
          float w[4];
          if constexpr (sizeof(T) == 4) {
            const float4 f = __ldcs(reinterpret_cast<const float4*>(v + j));
            w[0] = f.x, w[1] = f.y, w[2] = f.z, w[3] = f.w;
          } else {
            const uint2 h = __ldcs(reinterpret_cast<const uint2*>(v + j));
            w[0] = __uint_as_float(h.x << 16);
            w[1] = __uint_as_float(h.x & 0xffff0000u);
            w[2] = __uint_as_float(h.y << 16);
            w[3] = __uint_as_float(h.y & 0xffff0000u);
          }
          const float4 s4 = *reinterpret_cast<const float4*>(g + j);
          acc = __fmaf_rn(w[0], s4.x, acc);
          acc = __fmaf_rn(w[1], s4.y, acc);
          acc = __fmaf_rn(w[2], s4.z, acc);
          acc = __fmaf_rn(w[3], s4.w, acc);
        } else {
          acc = __fmaf_rn(to_f32(v[j]), g[j], acc);
        }
      }
    }
    dest_row_out(y, i, lanes, active, diag, xr, row0 + rr, acc);
  }
}

// ---- unpack_scatter_set through the plan's tile table ----

constexpr int kTileThreads = 512;
constexpr unsigned kWideVecs = 4096;   // a wide-row block's vectors of a row

// Rows of a tile each (tile_rows == 1): block (row, chunk, rank) copies
// vectors [chunk * kWideVecs, ...) of one output row from its source.
template <typename V>
__global__ void __launch_bounds__(kTileThreads)
    scatter_wide_rows_kernel(const V* __restrict__ recv,
                             const V* __restrict__ x_own,
                             const int32_t* __restrict__ offsets,
                             const int32_t* __restrict__ perm,
                             const int32_t* __restrict__ tile_ptr,
                             V* __restrict__ out, unsigned n_recv,
                             unsigned rows_own, unsigned out_len,
                             unsigned row_vecs, int copy_own) {
  const size_t rank = blockIdx.z;
  const unsigned row = blockIdx.x;
  const unsigned off = copy_own ? static_cast<unsigned>(offsets[rank]) : 0u;
  const unsigned own_rows = copy_own ? rows_own : 0u;
  const int32_t* ptr = tile_ptr + rank * (out_len + 1) + row;
  const V* from = nullptr;
  if (row - off < own_rows) {
    from = x_own + (rank * rows_own + (row - off)) *
                       static_cast<size_t>(row_vecs);
  } else if (ptr[1] > ptr[0]) {
    const size_t k = perm[rank * n_recv + ptr[0]];
    from = recv + (rank * n_recv + k) * static_cast<size_t>(row_vecs);
  }
  V* o = out + (rank * out_len + row) * static_cast<size_t>(row_vecs);
  const unsigned end = min(row_vecs, (blockIdx.y + 1) * kWideVecs);
#pragma unroll 4
  for (unsigned v = blockIdx.y * kWideVecs + threadIdx.x; v < end;
       v += kTileThreads) {
    o[v] = from != nullptr ? from[v] : V{};
  }
}

// Tile t of rank blockIdx.y: rows [t * tile_rows, ...) of the output.
template <typename V, bool kUnit>
__global__ void __launch_bounds__(kTileThreads)
    scatter_tiles_kernel(const V* __restrict__ recv,
                         const V* __restrict__ x_own,
                         const int32_t* __restrict__ offsets,
                         const int32_t* __restrict__ tgt,
                         const int32_t* __restrict__ perm,
                         const int32_t* __restrict__ tile_ptr,
                         V* __restrict__ out, unsigned n_recv,
                         unsigned rows_own, unsigned out_len,
                         unsigned row_vecs, unsigned tile_rows,
                         unsigned tiles, int copy_own) {
  extern __shared__ __align__(16) unsigned char tile_raw[];
  V* tile = reinterpret_cast<V*>(tile_raw);
  const size_t rank = blockIdx.y;
  const unsigned t0 = blockIdx.x * tile_rows;
  const unsigned nrows = min(tile_rows, out_len - t0);
  const unsigned total = nrows * row_vecs;
  const unsigned off = copy_own ? static_cast<unsigned>(offsets[rank]) : 0u;
  const unsigned own_rows = copy_own ? rows_own : 0u;
  const V* xr = x_own + rank * static_cast<size_t>(rows_own) * row_vecs;
  V* o = out + (rank * out_len + t0) * static_cast<size_t>(row_vecs);
  const int32_t* ptr = tile_ptr + rank * (tiles + 1) + blockIdx.x;
  const unsigned e0 = ptr[0], e1 = ptr[1];
  // unsigned: row - off < own_rows means off <= row < off + own_rows
  const bool all_own = t0 - off < own_rows && t0 + nrows - off <= own_rows;
  // the tile's value before any landed row: an own row or zero
  auto base = [&](unsigned v) {
    const unsigned row = kUnit ? v : v / row_vecs;
    const unsigned o_row = t0 + row - off;
    return o_row < own_rows
               ? xr[static_cast<size_t>(o_row) * row_vecs + (v - row * row_vecs)]
               : V{};
  };
  if (e0 == e1 || all_own) {   // nothing lands here: straight to the output
    for (unsigned v0 = threadIdx.x; v0 < total; v0 += kUnroll * kTileThreads) {
      V w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned v = v0 + u * kTileThreads;
        if (v < total) w[u] = base(v);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned v = v0 + u * kTileThreads;
        if (v < total) o[v] = w[u];
      }
    }
    return;
  }
  for (unsigned v0 = threadIdx.x; v0 < total; v0 += kUnroll * kTileThreads) {
    V w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned v = v0 + u * kTileThreads;
      if (v < total) w[u] = base(v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned v = v0 + u * kTileThreads;
      if (v < total) tile[v] = w[u];
    }
  }
  __syncthreads();
  // the tile's landed rows, own-range targets skipped
  const size_t rb = rank * static_cast<size_t>(n_recv);
  const unsigned items = (e1 - e0) * row_vecs;
  const V* rr = recv + rb * row_vecs;
  for (unsigned v0 = threadIdx.x; v0 < items; v0 += kUnroll * kTileThreads) {
    V w[kUnroll];
    unsigned to[kUnroll];
    bool keep[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned v = v0 + u * kTileThreads;
      keep[u] = false;
      if (v < items) {
        const unsigned k = kUnit ? v : v / row_vecs;
        const unsigned f = v - k * row_vecs;
        const unsigned dst = __ldcs(tgt + rb + e0 + k);
        keep[u] = !(dst - off < own_rows);
        to[u] = (dst - t0) * row_vecs + f;
        w[u] = rr[static_cast<size_t>(__ldcs(perm + rb + e0 + k)) * row_vecs +
                  f];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (keep[u]) tile[to[u]] = w[u];
    }
  }
  __syncthreads();
  for (unsigned v = threadIdx.x; v < total; v += kTileThreads) o[v] = tile[v];
}

template <typename V>
void launch_pack(const void* x, const void* idx, void* out, long long p,
                 long long shard_rows, long long m, long long row_bytes,
                 int vb, cudaStream_t s) {
  const long long row_vecs = row_bytes / vb;
  const dim3 grid = grid_for(m * row_vecs, p);
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const V*>(x), static_cast<const int32_t*>(idx),
        static_cast<V*>(out), static_cast<unsigned>(shard_rows),
        static_cast<unsigned>(m), static_cast<unsigned>(row_vecs));
  };
  if (row_vecs == 1) go(pack_gather_kernel<V, true>);
  else go(pack_gather_kernel<V, false>);
}

template <typename V>
void launch_unpack_set(const void* recv, const void* idx, const void* x_own,
                       const void* offsets, void* out, long long p,
                       long long n_recv, long long rows_own, long long out_len,
                       long long row_bytes, int copy_own, int vb,
                       cudaStream_t s) {
  const long long row_vecs = row_bytes / vb;
  cudaMemsetAsync(out, 0, static_cast<size_t>(p * out_len * row_bytes), s);
  if (copy_own && rows_own > 0) {
    copy_own_kernel<V><<<grid_for(rows_own * row_vecs, p), kThreads, 0, s>>>(
        static_cast<const V*>(x_own), static_cast<const int32_t*>(offsets),
        static_cast<V*>(out), static_cast<unsigned>(rows_own),
        static_cast<unsigned>(out_len), static_cast<unsigned>(row_vecs));
  }
  if (n_recv * row_vecs == 0) return;
  const dim3 grid = grid_for(n_recv * row_vecs, p);
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const V*>(recv), static_cast<const int32_t*>(idx),
        static_cast<const int32_t*>(offsets), static_cast<V*>(out),
        static_cast<unsigned>(n_recv), static_cast<unsigned>(rows_own),
        static_cast<unsigned>(out_len), static_cast<unsigned>(row_vecs),
        copy_own);
  };
  if (row_vecs == 1) go(scatter_kernel<V, true>);
  else go(scatter_kernel<V, false>);
}

template <typename T>
void launch_dest(const void* recv, const void* x, const void* src,
                 const void* own, const void* own_mask, const void* rem_mask,
                 void* out, long long p, long long n_recv, long long shard,
                 long long slots, long long feat, cudaStream_t s) {
  const dim3 grid = grid_for(slots * feat, p);
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(recv), static_cast<const T*>(x),
        static_cast<const int32_t*>(src), static_cast<const int32_t*>(own),
        static_cast<const int8_t*>(own_mask),
        static_cast<const int8_t*>(rem_mask), static_cast<T*>(out),
        static_cast<unsigned>(n_recv), static_cast<unsigned>(shard),
        static_cast<unsigned>(slots), static_cast<unsigned>(feat));
  };
  if (feat == 1) go(unpack_dest_kernel<T, true>);
  else go(unpack_dest_kernel<T, false>);
}

template <typename T>
DestTab<T> dest_tab(const void* recv, const void* x, const void* code,
                    const void* slot, const void* shift, long long n_recv,
                    long long shard, long long slots) {
  return DestTab<T>{static_cast<const T*>(recv), static_cast<const T*>(x),
                    static_cast<const int32_t*>(code),
                    static_cast<const uint16_t*>(slot),
                    static_cast<const int32_t*>(shift), n_recv, shard, slots};
}

template <typename K>
int with_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <typename T>
int launch_dest_sorted(const DestTab<T>& d, void* out, long long p,
                       long long group, cudaStream_t s) {
  const long long per_rank = (d.slots + group - 1) / group;
  const int smem =
      static_cast<int>((group < d.slots ? group : d.slots) * sizeof(float));
  const int vec4 = d.slots % 4 == 0 && group % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto kernel = unpack_dest_sorted_kernel<T>;
  if (const int err = with_smem(kernel, smem)) return err;
  kernel<<<static_cast<unsigned>(per_rank * p), kDestThreads, smem, s>>>(
      d, static_cast<T*>(out), static_cast<unsigned>(group),
      static_cast<unsigned>(per_rank), vec4);
  return static_cast<int>(cudaGetLastError());
}

int lanes_for(long long per_row) {
  int lanes = 1;
  while (lanes < per_row && lanes < 32) lanes <<= 1;
  return lanes;
}

template <typename T>
int launch_dest_spmv_sorted(const DestTab<T>& d, const void* vals,
                            const void* diag, void* y, long long p,
                            long long rows, long long r, long long group_rows,
                            cudaStream_t s) {
  const long long per_rank = (rows + group_rows - 1) / group_rows;
  const int smem = static_cast<int>((group_rows < rows ? group_rows : rows) *
                                    r * sizeof(float));
  const int vec4 = r % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % (4 * sizeof(T)) == 0;
  auto kernel = dest_spmv_sorted_kernel<T>;
  if (const int err = with_smem(kernel, smem)) return err;
  kernel<<<static_cast<unsigned>(per_rank * p), kDestThreads, smem, s>>>(
      d, static_cast<const T*>(vals), static_cast<const T*>(diag),
      static_cast<T*>(y), static_cast<unsigned>(rows), static_cast<int>(r),
      static_cast<unsigned>(group_rows), static_cast<unsigned>(per_rank),
      lanes_for(vec4 ? r / 4 : r), vec4);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_tiles(const void* recv, const void* x_own, const void* offsets,
                 const void* tgt, const void* perm, const void* tile_ptr,
                 void* out, long long p, long long n_recv, long long rows_own,
                 long long out_len, long long row_bytes, long long tile_rows,
                 int copy_own, int vb, cudaStream_t s) {
  const long long row_vecs = row_bytes / vb;
  if (tile_rows == 1) {
    const dim3 grid(static_cast<unsigned>(out_len),
                    static_cast<unsigned>((row_vecs + kWideVecs - 1) /
                                          kWideVecs),
                    static_cast<unsigned>(p));
    scatter_wide_rows_kernel<V><<<grid, kTileThreads, 0, s>>>(
        static_cast<const V*>(recv), static_cast<const V*>(x_own),
        static_cast<const int32_t*>(offsets),
        static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(tile_ptr), static_cast<V*>(out),
        static_cast<unsigned>(n_recv), static_cast<unsigned>(rows_own),
        static_cast<unsigned>(out_len), static_cast<unsigned>(row_vecs),
        copy_own);
    return static_cast<int>(cudaGetLastError());
  }
  const long long tiles = (out_len + tile_rows - 1) / tile_rows;
  const int smem = static_cast<int>(tile_rows * row_bytes);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(p));
  auto go = [&](auto kernel) {
    if (const int err = with_smem(kernel, smem)) return err;
    kernel<<<grid, kTileThreads, smem, s>>>(
        static_cast<const V*>(recv), static_cast<const V*>(x_own),
        static_cast<const int32_t*>(offsets),
        static_cast<const int32_t*>(tgt), static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(tile_ptr), static_cast<V*>(out),
        static_cast<unsigned>(n_recv), static_cast<unsigned>(rows_own),
        static_cast<unsigned>(out_len), static_cast<unsigned>(row_vecs),
        static_cast<unsigned>(tile_rows), static_cast<unsigned>(tiles),
        copy_own);
    return static_cast<int>(cudaGetLastError());
  };
  return row_vecs == 1 ? go(scatter_tiles_kernel<V, true>)
                       : go(scatter_tiles_kernel<V, false>);
}

}  // namespace

extern "C" {

// out[q, k, :] = x[q, idx[q, k], :] for every rank q; rows are row_bytes wide.
int rt_pack_gather(const void* x, const void* idx, void* out, long long p,
                   long long shard_rows, long long m, long long row_bytes,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 0 || m == 0 || row_bytes == 0) return cudaGetLastError();
  if (shard_rows * row_bytes >= kMaxPerRank || m * row_bytes >= kMaxPerRank)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vb = vec_bytes(row_bytes, x, out, out);
  switch (vb) {
    case 16: launch_pack<uint4>(x, idx, out, p, shard_rows, m, row_bytes, vb, s); break;
    case 8: launch_pack<uint2>(x, idx, out, p, shard_rows, m, row_bytes, vb, s); break;
    case 4: launch_pack<uint32_t>(x, idx, out, p, shard_rows, m, row_bytes, vb, s); break;
    case 2: launch_pack<uint16_t>(x, idx, out, p, shard_rows, m, row_bytes, vb, s); break;
    default: launch_pack<uint8_t>(x, idx, out, p, shard_rows, m, row_bytes, vb, s); break;
  }
  return cudaGetLastError();
}

// out[q] = zeros(out_len rows); out[q, idx[q, k]] = recv[q, k]; then, with
// copy_own, out[q, offsets[q] + i] = x_own[q, i] (the own rows win).
int rt_unpack_scatter_set(const void* recv, const void* idx, const void* x_own,
                          const void* offsets, void* out, long long p,
                          long long n_recv, long long rows_own,
                          long long out_len, long long row_bytes, int copy_own,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 0 || out_len == 0 || row_bytes == 0) return cudaGetLastError();
  if (out_len * row_bytes >= kMaxPerRank || n_recv * row_bytes >= kMaxPerRank)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vb = vec_bytes(row_bytes, recv, x_own, out);
  switch (vb) {
    case 16: launch_unpack_set<uint4>(recv, idx, x_own, offsets, out, p, n_recv, rows_own, out_len, row_bytes, copy_own, vb, s); break;
    case 8: launch_unpack_set<uint2>(recv, idx, x_own, offsets, out, p, n_recv, rows_own, out_len, row_bytes, copy_own, vb, s); break;
    case 4: launch_unpack_set<uint32_t>(recv, idx, x_own, offsets, out, p, n_recv, rows_own, out_len, row_bytes, copy_own, vb, s); break;
    case 2: launch_unpack_set<uint16_t>(recv, idx, x_own, offsets, out, p, n_recv, rows_own, out_len, row_bytes, copy_own, vb, s); break;
    default: launch_unpack_set<uint8_t>(recv, idx, x_own, offsets, out, p, n_recv, rows_own, out_len, row_bytes, copy_own, vb, s); break;
  }
  return cudaGetLastError();
}

// out[q, l, f] = recv[q, src[q, l], f] * rem[q, l] + x[q, own[q, l], f] * own_m[q, l]
// dtype: 0 = float32, 1 = bfloat16.
int rt_unpack_dest(const void* recv, const void* x, const void* src,
                   const void* own, const void* own_mask, const void* rem_mask,
                   void* out, long long p, long long n_recv, long long shard,
                   long long slots, long long feat, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 0 || slots == 0 || feat == 0) return cudaGetLastError();
  if (slots * feat >= kMaxPerRank || n_recv * feat >= kMaxPerRank ||
      shard * feat >= kMaxPerRank)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    launch_dest<float>(recv, x, src, own, own_mask, rem_mask, out, p, n_recv,
                       shard, slots, feat, s);
  } else if (dtype == 1) {
    launch_dest<__nv_bfloat16>(recv, x, src, own, own_mask, rem_mask, out, p,
                               n_recv, shard, slots, feat, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return cudaGetLastError();
}

// unpack_dest through the plan's dest table: code (P, slots) int32 and slot
// (P, slots) uint16 in groups of `group` slots (at most kDestSlots), shift
// (P,) int32 or null; feat 1.  dtype: 0 = float32, 1 = bfloat16.
int rt_unpack_dest_sorted(const void* recv, const void* x, const void* code,
                          const void* slot, const void* shift, void* out,
                          long long p, long long n_recv, long long shard,
                          long long slots, long long group, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 0 || slots == 0) return cudaGetLastError();
  if (group < 1 || group > kDestSlots || n_recv >= kMaxPerRank ||
      shard >= kMaxPerRank || p * slots >= (1LL << 40) ||
      (slots + group - 1) / group * p >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return launch_dest_sorted(dest_tab<float>(recv, x, code, slot, shift,
                                              n_recv, shard, slots),
                              out, p, group, s);
  }
  if (dtype == 1) {
    return launch_dest_sorted(dest_tab<__nv_bfloat16>(recv, x, code, slot,
                                                      shift, n_recv, shard,
                                                      slots),
                              out, p, group, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// y[q, i] = diag[q, i] * x[q, i] + sum_j vals[q, i, j] * slot[q, i * r + j]
// with slot as rt_unpack_dest computes it, through the plan's dest table in
// groups of group_rows whole rows (group_rows * r slots, at most
// kDestSlots); diag may be null.  vals (P, rows, r), y (P, rows); one dtype
// for recv, x, vals, diag and y (0 = float32, 1 = bfloat16).
int rt_unpack_dest_spmv_sorted(const void* recv, const void* x,
                               const void* code, const void* slot,
                               const void* shift, const void* vals,
                               const void* diag, void* y, long long p,
                               long long n_recv, long long shard,
                               long long rows, long long r,
                               long long group_rows, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 0 || rows == 0) return cudaGetLastError();
  if (r < 1 || group_rows < 1 || group_rows * r > kDestSlots ||
      rows * r >= kMaxPerRank || n_recv >= kMaxPerRank ||
      shard >= kMaxPerRank ||
      (rows + group_rows - 1) / group_rows * p >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return launch_dest_spmv_sorted(
        dest_tab<float>(recv, x, code, slot, shift, n_recv, shard, rows * r),
        vals, diag, y, p, rows, r, group_rows, s);
  }
  if (dtype == 1) {
    return launch_dest_spmv_sorted(
        dest_tab<__nv_bfloat16>(recv, x, code, slot, shift, n_recv, shard,
                                rows * r),
        vals, diag, y, p, rows, r, group_rows, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// unpack_scatter_set in one pass through the plan's tile table: tgt and
// perm (P, n_recv) int32 (each rank's landed rows sorted by target, and
// where each sits in recv), tile_ptr (P, tiles + 1) int32 (tile t's
// entries are [tile_ptr[t], tile_ptr[t + 1])), tiles of tile_rows rows
// (tile_rows 1: rows of any width, at most one entry a tile).
int rt_unpack_scatter_tiles(const void* recv, const void* x_own,
                            const void* offsets, const void* tgt,
                            const void* perm, const void* tile_ptr, void* out,
                            long long p, long long n_recv, long long rows_own,
                            long long out_len, long long row_bytes,
                            long long tile_rows, int copy_own, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 0 || out_len == 0 || row_bytes == 0) return cudaGetLastError();
  if (out_len * row_bytes >= kMaxPerRank || n_recv * row_bytes >= kMaxPerRank ||
      tile_rows < 1 || (tile_rows > 1 && tile_rows * row_bytes > 48 * 1024) ||
      p > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vb = vec_bytes(row_bytes, recv, x_own, out);
  switch (vb) {
    case 16: return launch_tiles<uint4>(recv, x_own, offsets, tgt, perm, tile_ptr, out, p, n_recv, rows_own, out_len, row_bytes, tile_rows, copy_own, vb, s);
    case 8: return launch_tiles<uint2>(recv, x_own, offsets, tgt, perm, tile_ptr, out, p, n_recv, rows_own, out_len, row_bytes, tile_rows, copy_own, vb, s);
    case 4: return launch_tiles<uint32_t>(recv, x_own, offsets, tgt, perm, tile_ptr, out, p, n_recv, rows_own, out_len, row_bytes, tile_rows, copy_own, vb, s);
    case 2: return launch_tiles<uint16_t>(recv, x_own, offsets, tgt, perm, tile_ptr, out, p, n_recv, rows_own, out_len, row_bytes, tile_rows, copy_own, vb, s);
    default: return launch_tiles<uint8_t>(recv, x_own, offsets, tgt, perm, tile_ptr, out, p, n_recv, rows_own, out_len, row_bytes, tile_rows, copy_own, vb, s);
  }
}

}  // extern "C"
