// Exchange fast path for Hopper (sm_90a): the pack and the two unpacks that
// surround the strategy ladder's all_to_all.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/pack_gather.py:
//   * rt_pack_gather         <- pack_gather        (pallas_call at :119)
//   * rt_unpack_scatter_set  <- unpack_scatter_set (pallas_call at :240)
//   * rt_unpack_dest         <- unpack_dest        (pallas_call at :185)
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
//   * every kernel takes the leading rank axis as grid.y, so one launch
//     serves all P virtual ranks of the loopback communicator.
//
// unpack_scatter_set runs as stream-ordered phases: a zero fill of the whole
// output (cudaMemsetAsync, the card's fastest store), the own rows copied
// from x_own to the rank's offset, and the scatter of the landed rows,
// which skips any target inside the own range.  The own rows therefore win
// over the scatter, as in the reference where the own memcpy lands last.
// Several landed rows may target the dump row concurrently; its contents
// are never read, and the rows after it (the zero slots) are never scatter
// targets.
//
// unpack_dest computes recv[src]*float(rem) + x[own]*float(own) with both
// products and the add rounded separately (__fmul_rn/__fadd_rn, no fused
// multiply-add), as the reference does, and reads both sources even where a
// mask is 0 — so -0.0, inf and NaN come out bit-identical.
//
// Every entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // extern "C"
