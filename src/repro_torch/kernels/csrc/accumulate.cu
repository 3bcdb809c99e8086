// Push-direction segment fold for Hopper (sm_90a): the combines that the
// put side of the strategy ladder runs around its all_to_all.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/pack_gather.py:
//   * rt_accumulate_segments <- accumulate_segments (pallas_call at :277)
//   * rt_accumulate_into     <- accumulate_into     (pallas_call at :301)
//
// Both compute, per rank q, out[q, t] = init[q, t] (or the reduce identity)
// combined with every vals[q, k] whose idx[q, k] == t, in ascending k order,
// under add or max.  The TPU kernels ran one program (grid=(1,)) over a
// resident array, so the combines happened in order.  Atomics would fix no
// order, and a float sum in another order has other bits, so these kernels
// fold instead, through a segment table built once per static index array
// (kernels/pack_gather.py segment_table): the stable sort of the lanes by
// target, perm[], each target's first lane, seg_ptr[], and the runs below.
// Every row folds its lanes in ascending order, each add rounded on its own
// (__fadd_rn; bfloat16 is rounded back after every add): exactly the
// reference's sequential scatter, bit for bit.
//
// What bounds them on this card: bytes (one read of vals and idx, one write
// of the live output rows; at most one add per element read) and, for a
// row with very many lanes, the chain of its dependent adds.  The lanes of a
// scalar fold (feat == 1) sit at random rows of vals: at the main path's
// matrix every value is a 4-byte read of its own 32-byte sector, so what
// the card can do is keep many of those reads in flight.
//   * Short scalar rows (run_fold_kernel): the table cuts the sorted lanes
//     of the rows with at most LONG_LANES lanes into runs: up to 2048
//     consecutive target rows whose lanes form one contiguous range of
//     perm of fewer than kRunLanes lanes.  A block takes one run: it parks
//     the run's slice of seg_ptr in shared memory, reads that range of perm
//     coalesced, issues the value reads eight a thread with no dependent
//     load between them, parks the values beside it, and then lets each
//     thread fold its rows' lanes from there, in order.
//     That is two round trips to memory per run instead of two per four
//     lanes of a row, consecutive threads write consecutive rows, and a
//     stretch of empty rows (most of the replicate fold's n targets) costs
//     one block per 2048 rows.
//   * Long scalar rows (long_fold_kernel), more than LONG_LANES lanes: a
//     block of their own, whose warps stage the row's values in shared
//     memory while one thread folds them: the fold of one row is a chain of
//     dependent adds that no order-preserving design can split, so the
//     kernel keeps it at the add's latency rather than a gather's.  At the
//     main path's matrix the band clipping at the vector's ends piles some
//     2^18 lanes onto columns 0 and n-1; their chains, not the bytes, set
//     the time of the replicate and own-target folds.  The host launches
//     them first, on a stream of higher priority, so that they find empty
//     SMs, and the short rows beside them.
//   * Wide rows (segment_fold_kernel, feat > 1): one thread per (row,
//     feature element), consecutive threads on consecutive elements, so the
//     1024-float rows of the blockwise block combine are read coalesced;
//     each thread issues the loads of four lanes before it folds them.
//
// Rows at or above live_len (the dump rows the callers slice off) are never
// folded, and their contents are unspecified: at the main path's shapes
// 93% of a rank's condensed-pack lanes target one dump row, which one thread
// would fold for milliseconds.  Padding lanes that the table dropped carry
// the reduce identity by construction; pad_rows marks the rows they targeted
// and, under add, such a row gets one +0.0 at the end, which gives the same
// bits as any number of +0.0 anywhere in the sum (it only turns a -0.0
// result into +0.0).  Under max an identity lane is a no-op.
//
// max follows XLA's semantics: a NaN propagates, and +0.0 beats -0.0.
//
// Every entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;
// Per-rank extents stay below 2^31 (the host functions check), so the index
// math inside a rank is 32-bit; only the rank offsets are 64-bit.
constexpr long long kMaxPerRank = 1LL << 31;
constexpr int kLanes = 4;   // lanes whose loads one thread issues together
constexpr int kStage = 32;    // lanes a stager thread loads at once
constexpr int kRunBatch = 8;  // value reads a run_fold_kernel thread issues
                              // before it parks any
constexpr int kRunRows = 8;   // kRunRows * kThreads rows a run holds at
                              // most (RUN_ROWS in kernels/pack_gather.py)
constexpr int kRunLanes = 2048;  // a run holds fewer lanes (RUN_LANES in
                                 // kernels/pack_gather.py)

enum Reduce : int { kAdd = 0, kMax = 1 };

__device__ __forceinline__ float xla_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) return __float_as_int(a) < 0 ? b : a;   // +0.0 beats -0.0
  return a > b ? a : b;
}

// How each element type loads, stores and combines.  Acc is what a thread
// carries between lanes; it always holds a value of the element type.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Acc = float;
  __device__ static Acc load(float v) { return v; }
  __device__ static float store(Acc a) { return a; }
  __device__ static Acc add(Acc a, Acc v) { return __fadd_rn(a, v); }
  __device__ static Acc larger(Acc a, Acc v) { return xla_max(a, v); }
  __device__ static Acc zero() { return 0.0f; }
  __device__ static Acc lowest() { return -__int_as_float(0x7f800000); }
};

template <>
struct Elem<__nv_bfloat16> {
  using Acc = float;
  __device__ static Acc load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 store(Acc a) {
    return __float2bfloat16_rn(a);
  }
  // the reference adds in float32 and rounds back to bfloat16 every step
  __device__ static Acc add(Acc a, Acc v) {
    return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, v)));
  }
  __device__ static Acc larger(Acc a, Acc v) { return xla_max(a, v); }
  __device__ static Acc zero() { return 0.0f; }
  __device__ static Acc lowest() { return -__int_as_float(0x7f800000); }
};

template <>
struct Elem<int32_t> {
  using Acc = int32_t;
  __device__ static Acc load(int32_t v) { return v; }
  __device__ static int32_t store(Acc a) { return a; }
  // two's-complement wrap-around, as XLA's integer add
  __device__ static Acc add(Acc a, Acc v) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                static_cast<uint32_t>(v));
  }
  __device__ static Acc larger(Acc a, Acc v) { return a > v ? a : v; }
  __device__ static Acc zero() { return 0; }
  __device__ static Acc lowest() { return INT_MIN; }
};

template <typename T, int kReduce>
__device__ __forceinline__ typename Elem<T>::Acc combine(
    typename Elem<T>::Acc acc, typename Elem<T>::Acc v) {
  return kReduce == kAdd ? Elem<T>::add(acc, v) : Elem<T>::larger(acc, v);
}

template <typename T, int kReduce>
__device__ __forceinline__ typename Elem<T>::Acc start_value(const T* init,
                                                             size_t at) {
  using E = Elem<T>;
  if (init) return E::load(init[at]);
  return kReduce == kAdd ? E::zero() : E::lowest();
}

template <typename T>
struct Fold {
  const T* vals;            // (P, k_lanes, feat)
  const int32_t* perm;      // (P, k_lanes): lanes sorted by target, stably
  const int32_t* seg_ptr;   // (P, live_len + 1)
  const int8_t* pad_rows;   // (P, live_len) or null
  const T* init;            // (P, out_len, feat) or null
  T* out;                   // (P, out_len, feat); rows >= live_len untouched
  const int32_t* long_rows; // (n_long,) rank * live_len + row
  const int4* runs;         // (n_runs,) {first row, end row, first lane,
                            // end lane}: rows as rank * live_len + row,
                            // lanes as positions in the rank's perm
  unsigned k_lanes, live_len, out_len, feat;
  unsigned blocks;          // blocks per rank of the wide-row kernel
};

// Four accumulators' worth of shared memory in one load.
template <typename A>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<int32_t> {
  using type = int4;
};

// Stage the row's values [from, from + n) into dst with nthreads loader
// threads (tid counts from 0): each issues the index loads of kStage lanes,
// then their value loads, before it stores any, so a chunk costs a couple
// of dependent round trips to memory rather than one per lane.
template <typename T>
__device__ __forceinline__ void stage_chunk(typename Elem<T>::Acc* dst,
                                            const T* vr, const int32_t* pr,
                                            int from, int n, int tid,
                                            int nthreads) {
  for (int u0 = tid; u0 < n; u0 += kStage * nthreads) {
    int k[kStage];
    T v[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int u = u0 + s * nthreads;
      k[s] = u < n ? pr[from + u] : 0;
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      if (u0 + s * nthreads < n) v[s] = vr[k[s]];
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int u = u0 + s * nthreads;
      if (u < n) dst[u] = Elem<T>::load(v[s]);
    }
  }
}

// One block folds one long row (feat == 1): warps 1.. stage the next chunk
// of the row's values in shared memory while thread 0 folds the current
// one in order, reading four values per shared-memory load, so the serial
// chain runs at the combine's latency instead of a dependent gather's.  The
// block takes all the shared memory a block may have, so no other block
// shares its SM's issue slots and memory pipeline with the chain (beside
// short-row blocks the chain runs some 55% slower).  Such a block starts
// only on an empty SM, so the short rows' thousands of blocks must not be
// dispatched before it: the host launches it first, on a stream of higher
// priority, and holds the short-row kernel behind gate_kernel until every
// long-row block has counted itself in `started`.
template <typename T, int kReduce>
__global__ void long_fold_kernel(const Fold<T> a, int chunk,
                                 unsigned long long* started) {
  if (threadIdx.x == 0 && started != nullptr) atomicAdd(started, 1ULL);
  using E = Elem<T>;
  using Acc = typename E::Acc;
  using V4 = typename Vec4<Acc>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* const buf0 = reinterpret_cast<Acc*>(smem);
  Acc* const buf1 = buf0 + chunk;
  const unsigned id = a.long_rows[blockIdx.x];
  const size_t rank = id / a.live_len;
  const unsigned t = id - rank * a.live_len;
  const T* vr = a.vals + rank * a.k_lanes;
  const int32_t* pr = a.perm + rank * a.k_lanes;
  const int32_t* sp = a.seg_ptr + rank * (a.live_len + 1);
  const int lo = sp[t], hi = sp[t + 1];
  const size_t at = rank * a.out_len + t;
  stage_chunk<T>(buf0, vr, pr, lo, min(chunk, hi - lo), threadIdx.x,
                 blockDim.x);
  __syncthreads();
  Acc acc = start_value<T, kReduce>(a.init, at);
  int b = 0;
  for (int c = lo; c < hi; c += chunk, b ^= 1) {
    const int next = c + chunk;
    if (threadIdx.x >= 32) {
      stage_chunk<T>(b == 0 ? buf1 : buf0, vr, pr, next,
                     min(chunk, hi - next), threadIdx.x - 32,
                     blockDim.x - 32);
    } else if (threadIdx.x == 0) {
      // software-pipelined: the next 16 values are loaded before the
      // current 16 are folded, so the loads hide under the chain
      const int n = min(chunk, hi - c);
      const int whole = n / 16 * 16;
      const Acc* cur_buf = b == 0 ? buf0 : buf1;
      const V4* v4 = reinterpret_cast<const V4*>(cur_buf);
      V4 cur[4], nxt[4];
      if (whole > 0) {
#pragma unroll
        for (int s = 0; s < 4; ++s) cur[s] = v4[s];
      }
      for (int u = 0; u < whole; u += 16) {
        const int ahead = u + 16 < whole ? u + 16 : u;
#pragma unroll
        for (int s = 0; s < 4; ++s) nxt[s] = v4[ahead / 4 + s];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          acc = combine<T, kReduce>(acc, cur[s].x);
          acc = combine<T, kReduce>(acc, cur[s].y);
          acc = combine<T, kReduce>(acc, cur[s].z);
          acc = combine<T, kReduce>(acc, cur[s].w);
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) cur[s] = nxt[s];
      }
      for (int u = whole; u < n; ++u) {
        acc = combine<T, kReduce>(acc, cur_buf[u]);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (kReduce == kAdd && a.pad_rows && a.pad_rows[id]) {
      acc = E::add(acc, E::zero());
    }
    a.out[at] = E::store(acc);
  }
}

// Short scalar rows (feat == 1), one run a block: the run's lanes are one
// contiguous range of the rank's perm (fewer than kRunLanes of them, at most
// kRunRows * kThreads rows).  The block parks the run's slice of seg_ptr in
// shared memory, reads the run's range of perm coalesced and the lanes'
// values kRunBatch a thread with no dependent load between them, and parks
// the values beside it; after the barrier thread i folds rows first + i,
// first + i + kThreads, ... from there in ascending lane order, each from
// its start value.  Long rows belong to no run.  Little state a thread (40
// registers): six blocks fill an SM.
template <typename T, int kReduce>
__global__ void __launch_bounds__(kThreads) run_fold_kernel(const Fold<T> a) {
  using E = Elem<T>;
  using Acc = typename E::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  int* const spp = reinterpret_cast<int*>(smem);          // rows + 1
  Acc* const parked = reinterpret_cast<Acc*>(smem) + kRunRows * kThreads + 4;
  static_assert(sizeof(Acc) == sizeof(int), "the parked values follow spp");
  const int4 run = a.runs[blockIdx.x];
  const unsigned rank = static_cast<unsigned>(run.x) / a.live_len;
  const unsigned t0 = static_cast<unsigned>(run.x) - rank * a.live_len;
  const int rows = run.y - run.x;
  const T* vr = a.vals + static_cast<size_t>(rank) * a.k_lanes;
  const int32_t* pr = a.perm + static_cast<size_t>(rank) * a.k_lanes + run.z;
  const int32_t* sp = a.seg_ptr + static_cast<size_t>(rank) *
                                      (a.live_len + 1) + t0;
  const size_t out0 = static_cast<size_t>(rank) * a.out_len + t0;
  const int n = run.w - run.z;
  for (int i = threadIdx.x; i <= rows; i += kThreads) spp[i] = sp[i] - run.z;
  for (int u0 = threadIdx.x; u0 < n; u0 += kRunBatch * kThreads) {
    int k[kRunBatch];
    T v[kRunBatch];
#pragma unroll
    for (int s = 0; s < kRunBatch; ++s) {
      const int u = u0 + s * kThreads;
      k[s] = u < n ? pr[u] : 0;
    }
#pragma unroll
    for (int s = 0; s < kRunBatch; ++s) {
      if (u0 + s * kThreads < n) v[s] = vr[k[s]];
    }
#pragma unroll
    for (int s = 0; s < kRunBatch; ++s) {
      const int u = u0 + s * kThreads;
      if (u < n) parked[u] = E::load(v[s]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    Acc acc = start_value<T, kReduce>(a.init, out0 + i);
    const bool padded = kReduce == kAdd && a.pad_rows &&
        a.pad_rows[static_cast<size_t>(rank) * a.live_len + t0 + i];
    for (int j = spp[i]; j < spp[i + 1]; ++j) {
      acc = combine<T, kReduce>(acc, parked[j]);
    }
    if (padded) acc = E::add(acc, E::zero());
    a.out[out0 + i] = E::store(acc);
  }
}

// Wide rows (feat > 1): one thread per (row, feature element), consecutive
// threads on consecutive elements; each thread issues the loads of kLanes
// lanes before it folds them.
template <typename T, int kReduce>
__global__ void segment_fold_kernel(const Fold<T> a) {
  const size_t rank = blockIdx.y;
  const unsigned feat = a.feat;
  const unsigned total = a.live_len * feat;
  const T* vr = a.vals + rank * a.k_lanes * feat;
  const int32_t* pr = a.perm + rank * a.k_lanes;
  const int32_t* sp = a.seg_ptr + rank * (a.live_len + 1);
  const int8_t* padr = a.pad_rows ? a.pad_rows + rank * a.live_len : nullptr;
  const size_t base = rank * a.out_len * feat;
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += a.blocks * kThreads) {
    const unsigned t = i / feat;
    const unsigned f = i - t * feat;
    const int hi = sp[t + 1];
    int j = sp[t];
    typename Elem<T>::Acc acc = start_value<T, kReduce>(a.init, base + i);
    for (; j + kLanes <= hi; j += kLanes) {
      T v[kLanes];
#pragma unroll
      for (int u = 0; u < kLanes; ++u) {
        v[u] = vr[static_cast<unsigned>(pr[j + u]) * feat + f];
      }
#pragma unroll
      for (int u = 0; u < kLanes; ++u) {
        acc = combine<T, kReduce>(acc, Elem<T>::load(v[u]));
      }
    }
    for (; j < hi; ++j) {
      acc = combine<T, kReduce>(
          acc, Elem<T>::load(vr[static_cast<unsigned>(pr[j]) * feat + f]));
    }
    if (kReduce == kAdd && padr && padr[t]) {
      acc = Elem<T>::add(acc, Elem<T>::zero());
    }
    a.out[base + i] = Elem<T>::store(acc);
  }
}

template <typename T>
Fold<T> make_fold(const void* vals, const void* perm, const void* seg_ptr,
                  const void* pad_rows, const void* long_rows,
                  const void* runs, const void* init, void* out,
                  long long p, long long k_lanes, long long live_len,
                  long long out_len, long long feat) {
  long long blocks = (live_len * feat + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  return Fold<T>{static_cast<const T*>(vals),
                 static_cast<const int32_t*>(perm),
                 static_cast<const int32_t*>(seg_ptr),
                 static_cast<const int8_t*>(pad_rows),
                 static_cast<const T*>(init),
                 static_cast<T*>(out),
                 static_cast<const int32_t*>(long_rows),
                 static_cast<const int4*>(runs),
                 static_cast<unsigned>(k_lanes),
                 static_cast<unsigned>(live_len),
                 static_cast<unsigned>(out_len),
                 static_cast<unsigned>(feat),
                 static_cast<unsigned>(blocks)};
}

template <typename T>
int launch_short(const Fold<T>& a, long long p, long long n_runs,
                 int reduce, cudaStream_t s) {
  using Acc = typename Elem<T>::Acc;
  if (a.feat == 1) {
    if (n_runs == 0) return static_cast<int>(cudaGetLastError());
    // seg_ptr's slice and the run's lanes, 4 bytes each: 16 KB, under the
    // 48 KB a block may take without opting in
    const size_t smem = (kRunRows * kThreads + 4) * sizeof(int) +
                        kRunLanes * sizeof(Acc);
    const unsigned grid = static_cast<unsigned>(n_runs);
    if (reduce == kAdd) run_fold_kernel<T, kAdd><<<grid, kThreads, smem, s>>>(a);
    else run_fold_kernel<T, kMax><<<grid, kThreads, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(a.blocks, static_cast<unsigned>(p));
  if (reduce == kAdd) segment_fold_kernel<T, kAdd><<<grid, kThreads, 0, s>>>(a);
  else segment_fold_kernel<T, kMax><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_long(const Fold<T>& a, long long n_long, int reduce,
                unsigned long long* started, cudaStream_t s) {
  using Acc = typename Elem<T>::Acc;
  int device = 0, smem = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  // two staging buffers, each a multiple of 16 values
  const int chunk = smem / static_cast<int>(2 * sizeof(Acc)) / 16 * 16;
  auto go = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(n_long), kThreads, smem, s>>>(a, chunk,
                                                               started);
    return static_cast<int>(cudaGetLastError());
  };
  return reduce == kAdd ? go(long_fold_kernel<T, kAdd>)
                        : go(long_fold_kernel<T, kMax>);
}

bool bad_extents(long long p, long long k_lanes, long long live_len,
                 long long out_len, long long feat, int reduce) {
  return k_lanes * feat >= kMaxPerRank || out_len * feat >= kMaxPerRank ||
         p * live_len >= kMaxPerRank || live_len > out_len || p > 65535 ||
         (reduce != kAdd && reduce != kMax);
}

// dtype: 0 = float32, 1 = bfloat16, 2 = int32; reduce: 0 = add, 1 = max.
int fold(const void* vals, const void* perm, const void* seg_ptr,
         const void* pad_rows, const void* runs, const void* init, void* out,
         long long p, long long k_lanes, long long live_len,
         long long out_len, long long feat, long long n_runs, int dtype,
         int reduce, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 0 || live_len == 0 || feat == 0) return cudaGetLastError();
  if (bad_extents(p, k_lanes, live_len, out_len, feat, reduce) ||
      n_runs < 0 || n_runs > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
#define FOLD_SHORT(T)                                                       \
  return launch_short<T>(make_fold<T>(vals, perm, seg_ptr, pad_rows,        \
                                      nullptr, runs, init, out, p, k_lanes, \
                                      live_len, out_len, feat),             \
                         p, n_runs, reduce, s)
  switch (dtype) {
    case 0: FOLD_SHORT(float);
    case 1: FOLD_SHORT(__nv_bfloat16);
    case 2: FOLD_SHORT(int32_t);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FOLD_SHORT
}

int fold_long(const void* vals, const void* perm, const void* seg_ptr,
              const void* pad_rows, const void* long_rows, const void* init,
              void* out, long long p, long long k_lanes, long long live_len,
              long long out_len, long long n_long, int dtype, int reduce,
              void* started, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_long == 0) return cudaGetLastError();
  if (bad_extents(p, k_lanes, live_len, out_len, 1, reduce) || n_long < 0 ||
      n_long > kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
#define FOLD_LONG(T)                                                         \
  return launch_long<T>(make_fold<T>(vals, perm, seg_ptr, pad_rows,          \
                                     long_rows, nullptr, init, out, p,       \
                                     k_lanes, live_len, out_len, 1),         \
                        n_long, reduce,                                       \
                        static_cast<unsigned long long*>(started), s)
  switch (dtype) {
    case 0: FOLD_LONG(float);
    case 1: FOLD_LONG(__nv_bfloat16);
    case 2: FOLD_LONG(int32_t);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FOLD_LONG
}

// Holds its stream until *started reaches target: one thread, asleep
// between reads, so it keeps nothing of its SM from the long-row blocks it
// waits for.
__global__ void gate_kernel(const unsigned long long* started,
                            unsigned long long target) {
  while (*static_cast<const volatile unsigned long long*>(started) < target) {
    __nanosleep(500);
  }
}

}  // namespace

extern "C" {

// out[q, t] = identity (+)= vals[q, perm[q, j]] for j in [seg_ptr[q, t],
// seg_ptr[q, t + 1]), rows feat elements wide: for feat == 1 over the rows
// of the n_runs runs (fewer than kRunLanes lanes each), for feat > 1 over
// every live row t < live_len.  pad_rows may be null.
int rt_accumulate_segments(const void* vals, const void* perm,
                           const void* seg_ptr, const void* pad_rows,
                           const void* runs, void* out, long long p,
                           long long k_lanes, long long live_len,
                           long long out_len, long long feat,
                           long long n_runs, int dtype, int reduce,
                           void* stream) {
  return fold(vals, perm, seg_ptr, pad_rows, runs, nullptr, out, p, k_lanes,
              live_len, out_len, feat, n_runs, dtype, reduce, stream);
}

// The same fold, starting from init[q, t] (out_len rows, like out).
int rt_accumulate_into(const void* init, const void* vals, const void* perm,
                       const void* seg_ptr, const void* pad_rows,
                       const void* runs, void* out, long long p,
                       long long k_lanes, long long live_len,
                       long long out_len, long long feat, long long n_runs,
                       int dtype, int reduce, void* stream) {
  return fold(vals, perm, seg_ptr, pad_rows, runs, init, out, p, k_lanes,
              live_len, out_len, feat, n_runs, dtype, reduce, stream);
}

// The long rows of either fold (feat == 1): long_rows lists n_long rows as
// rank * live_len + row; init may be null (start from the identity).  Each
// block adds one to *started (a device counter, or null) as it starts.
int rt_fold_long_rows(const void* init, const void* vals, const void* perm,
                      const void* seg_ptr, const void* pad_rows,
                      const void* long_rows, void* out, long long p,
                      long long k_lanes, long long live_len,
                      long long out_len, long long n_long, int dtype,
                      int reduce, void* started, void* stream) {
  return fold_long(vals, perm, seg_ptr, pad_rows, long_rows, init, out, p,
                   k_lanes, live_len, out_len, n_long, dtype, reduce,
                   started, stream);
}

// Holds the stream until the device counter *started reaches target.
int rt_fold_gate(const void* started, long long target, void* stream) {
  gate_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(started),
      static_cast<unsigned long long>(target));
  return cudaGetLastError();
}

}  // extern "C"
