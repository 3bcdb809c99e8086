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
// fold instead:
//   * the caller hands in a segment table built once per static index array
//     (kernels/pack_gather.py segment_table): the stable sort of the lanes by
//     target, perm[], and each target's first lane, seg_ptr[];
//   * one thread per (target row, feature element) folds its row's lanes in
//     ascending order, each add rounded on its own (__fadd_rn; bfloat16 is
//     rounded back after every add), which is exactly the reference's
//     sequential scatter, bit for bit;
//   * consecutive threads take consecutive feature elements of a row, so the
//     1024-float rows of the blockwise block combine are read coalesced;
//     each thread issues the loads of four lanes before it folds them;
//   * a row with more than long_lanes lanes (scalar rows only) gets a block
//     of its own, whose warps stage the row's values in shared memory while
//     one thread folds them: the fold of one row is a chain of dependent
//     adds that no order-preserving design can split, so the kernel keeps
//     it at the add's latency rather than a gather's.  At the main path's
//     matrix the band clipping at the vector's ends piles some 2^18 lanes
//     onto columns 0 and n-1; their chains, not the bytes, set the time of
//     the replicate and own-target folds.
// What bounds them on this card otherwise: bytes (one read of vals and idx,
// one write of the live output rows; at most one add per element read).
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
  unsigned k_lanes, live_len, out_len, feat;
  int long_lanes;           // rows with more lanes are the long ones
  unsigned blocks;          // blocks per rank of the short-row kernel
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
// shares its SM and its memory pipeline with the chain; the host launches it
// first, so that it finds empty SMs, and the short-row kernel beside it on a
// second stream.
template <typename T, int kReduce>
__global__ void long_fold_kernel(const Fold<T> a, int chunk) {
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

// Short rows: one thread per (row, feature element), consecutive threads on
// consecutive elements; each thread issues the loads of kLanes lanes before
// it folds them.  Rows with more than long_lanes lanes are left to
// long_fold_kernel.
template <typename T, int kReduce, bool kUnit>
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
    const unsigned t = kUnit ? i : i / feat;
    const unsigned f = i - t * feat;
    const int hi = sp[t + 1];
    int j = sp[t];
    if (hi - j > a.long_lanes) continue;
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
                  const void* init, void* out, long long p,
                  long long k_lanes, long long live_len, long long out_len,
                  long long feat, long long long_lanes) {
  long long blocks = (live_len * feat + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  return Fold<T>{static_cast<const T*>(vals),
                 static_cast<const int32_t*>(perm),
                 static_cast<const int32_t*>(seg_ptr),
                 static_cast<const int8_t*>(pad_rows),
                 static_cast<const T*>(init),
                 static_cast<T*>(out),
                 static_cast<const int32_t*>(long_rows),
                 static_cast<unsigned>(k_lanes),
                 static_cast<unsigned>(live_len),
                 static_cast<unsigned>(out_len),
                 static_cast<unsigned>(feat),
                 static_cast<int>(long_lanes),
                 static_cast<unsigned>(blocks)};
}

template <typename T>
void launch_short(const Fold<T>& a, long long p, int reduce,
                  cudaStream_t s) {
  const dim3 grid(a.blocks, static_cast<unsigned>(p));
  auto go = [&](auto kernel) { kernel<<<grid, kThreads, 0, s>>>(a); };
  if (reduce == kAdd) {
    if (a.feat == 1) go(segment_fold_kernel<T, kAdd, true>);
    else go(segment_fold_kernel<T, kAdd, false>);
  } else {
    if (a.feat == 1) go(segment_fold_kernel<T, kMax, true>);
    else go(segment_fold_kernel<T, kMax, false>);
  }
}

template <typename T>
int launch_long(const Fold<T>& a, long long n_long, int reduce,
                cudaStream_t s) {
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
    kernel<<<static_cast<unsigned>(n_long), kThreads, smem, s>>>(a, chunk);
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
         const void* pad_rows, const void* init, void* out, long long p,
         long long k_lanes, long long live_len, long long out_len,
         long long feat, long long long_lanes, int dtype, int reduce,
         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 0 || live_len == 0 || feat == 0) return cudaGetLastError();
  if (bad_extents(p, k_lanes, live_len, out_len, feat, reduce) ||
      long_lanes < 0 || long_lanes > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
#define FOLD_SHORT(T)                                                       \
  launch_short<T>(make_fold<T>(vals, perm, seg_ptr, pad_rows, nullptr,     \
                               init, out, p, k_lanes, live_len, out_len,   \
                               feat, long_lanes),                          \
                  p, reduce, s)
  switch (dtype) {
    case 0: FOLD_SHORT(float); break;
    case 1: FOLD_SHORT(__nv_bfloat16); break;
    case 2: FOLD_SHORT(int32_t); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FOLD_SHORT
  return cudaGetLastError();
}

int fold_long(const void* vals, const void* perm, const void* seg_ptr,
              const void* pad_rows, const void* long_rows, const void* init,
              void* out, long long p, long long k_lanes, long long live_len,
              long long out_len, long long n_long, int dtype, int reduce,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_long == 0) return cudaGetLastError();
  if (bad_extents(p, k_lanes, live_len, out_len, 1, reduce) || n_long < 0 ||
      n_long > kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
#define FOLD_LONG(T)                                                         \
  return launch_long<T>(make_fold<T>(vals, perm, seg_ptr, pad_rows,          \
                                     long_rows, init, out, p, k_lanes,       \
                                     live_len, out_len, 1, 0),               \
                        n_long, reduce, s)
  switch (dtype) {
    case 0: FOLD_LONG(float);
    case 1: FOLD_LONG(__nv_bfloat16);
    case 2: FOLD_LONG(int32_t);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FOLD_LONG
}

}  // namespace

extern "C" {

// out[q, t] = identity (+)= vals[q, perm[q, j]] for j in [seg_ptr[q, t],
// seg_ptr[q, t + 1]), for every live row t < live_len with at most
// long_lanes lanes; rows are feat elements wide.  pad_rows may be null.
int rt_accumulate_segments(const void* vals, const void* perm,
                           const void* seg_ptr, const void* pad_rows,
                           void* out, long long p, long long k_lanes,
                           long long live_len, long long out_len,
                           long long feat, long long long_lanes, int dtype,
                           int reduce, void* stream) {
  return fold(vals, perm, seg_ptr, pad_rows, nullptr, out, p, k_lanes,
              live_len, out_len, feat, long_lanes, dtype, reduce, stream);
}

// The same fold, starting from init[q, t] (out_len rows, like out).
int rt_accumulate_into(const void* init, const void* vals, const void* perm,
                       const void* seg_ptr, const void* pad_rows, void* out,
                       long long p, long long k_lanes, long long live_len,
                       long long out_len, long long feat,
                       long long long_lanes, int dtype, int reduce,
                       void* stream) {
  return fold(vals, perm, seg_ptr, pad_rows, init, out, p, k_lanes, live_len,
              out_len, feat, long_lanes, dtype, reduce, stream);
}

// The long rows of either fold (feat == 1): long_rows lists n_long rows as
// rank * live_len + row; init may be null (start from the identity).
int rt_fold_long_rows(const void* init, const void* vals, const void* perm,
                      const void* seg_ptr, const void* pad_rows,
                      const void* long_rows, void* out, long long p,
                      long long k_lanes, long long live_len,
                      long long out_len, long long n_long, int dtype,
                      int reduce, void* stream) {
  return fold_long(vals, perm, seg_ptr, pad_rows, long_rows, init, out, p,
                   k_lanes, live_len, out_len, n_long, dtype, reduce,
                   stream);
}

}  // extern "C"
