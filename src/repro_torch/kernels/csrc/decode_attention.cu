// Single-token (decode) GQA attention over the valid prefix of a KV cache,
// for Hopper (sm_90a):
//   out[b, h] = softmax_s(q[b, h] . k[b, s, h / G] * scale) . v[b, s, h / G]
// over the slots s < lengths[b] of lane b, float32 dot products and softmax,
// the output in q's type; q and the cache float32 or bfloat16 (a float32
// query may read a bfloat16 cache), D <= 128.
//
// Replaces the Pallas TPU kernel decode_attention of
// src/repro/kernels/decode_attention.py (pallas_call at :95), reached
// through repro.kernels.ops.decode_attention; in the port it is the
// attention of every layer of every decode step (models/transformer.py).
//
// What bounds it on this card: bytes.  Each valid slot's K and V rows are
// read once (2 * Hkv * D elements) for about 4 * H * D flops: at bf16 that
// is one flop per byte, far under the card's ratio.
//
// The TPU kernel walked the KV axis as the sequential innermost grid axis
// and carried the running (max, sum, accumulator) in VMEM from chunk to
// chunk, over one grid row per lane.  Blocks on this card run in no order
// and one lane times eight KV heads is only 64 blocks, so the KV axis is
// split instead (flash-decoding): the grid is (lane x KV head, split, head
// group).  A block of kThreads threads owns `chunk` slots of one (lane, KV
// head) and serves kG of its G = H / Hkv query heads (all four of
// llama3-8b's; more run as further head groups), so K and V are read once
// for them.  Eight lanes share a slot: lane j holds elements [j * kPer,
// (j + 1) * kPer) of the head dimension and reads them with 16-byte loads
// (D = 8 * kPer), so a warp works on four slots at once, the dot products
// meet in three shuffles, and the group's next slot is loaded ahead.  Each
// group keeps a running (max, sum, accumulator) per query head; the
// block's groups merge through shared memory into one partial per split,
// and a second small launch merges the splits by log-sum-exp and divides
// by max(sum, 1e-30), as the TPU kernel's finish does.
//
// Masking: slots at or past lengths[b] are never read (the TPU kernel
// masked them with -1e30, which gives them weight exactly 0 once a valid
// slot is seen, and a valid prefix always starts at slot 0).  A length of
// 0 or less is the one case where that differs: there every slot was
// masked alike, and the TPU kernel returns the mean of V over all S slots.
// This kernel does the same by reading all S slots with every logit set to
// -1e30.  Lengths past S count as S.  Any S works.
//
// Launches on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGroupLanes = 8;                  // lanes that share a slot
constexpr int kGroups = kThreads / kGroupLanes; // slots a block takes at once
constexpr float kMasked = -1e30f;     // the TPU kernel's mask and start

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the 16-byte word's elements as floats: 4 float32 or 8 bfloat16 (a
// bfloat16 is the top half of its float32)
__device__ __forceinline__ void unpack(const uint4& u, float* r, float) {
  r[0] = __uint_as_float(u.x);
  r[1] = __uint_as_float(u.y);
  r[2] = __uint_as_float(u.z);
  r[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* r,
                                       __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[2 * i] = __uint_as_float(w[i] << 16);
    r[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Lane j of a group holds elements [j * kPer, (j + 1) * kPer) of a row:
// 16-byte loads where the row allows (`vec`: d == 8 * kPer, rows 16-byte
// aligned), else one element at a time, past d read as 0.
template <typename T, int kPer>
__device__ __forceinline__ void load_part(const T* __restrict__ row, int j,
                                          int d, bool vec, float (&r)[kPer]) {
  const T* p = row + j * kPer;
  constexpr int kWords = kPer * static_cast<int>(sizeof(T)) / 16;
  if constexpr (kWords > 0 && kPer * sizeof(T) % 16 == 0) {
    if (vec) {
      constexpr int kEach = 16 / static_cast<int>(sizeof(T));
#pragma unroll
      for (int c = 0; c < kWords; ++c) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + c);
        float e[kEach];
        unpack(u, e, T());
#pragma unroll
        for (int i = 0; i < kEach; ++i) r[c * kEach + i] = e[i];
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    r[i] = j * kPer + i < d ? to_f32(p[i]) : 0.0f;
}

// slots [0, n) of lane b are attended; n = S when every slot is masked
__device__ __forceinline__ int attended(int len, int s) {
  return len <= 0 ? s : min(len, s);
}

// One partial (max, sum, accumulator) per (lane x KV head, split, query
// head): part_m / part_l (B * Hkv, nsplit, G), part_acc (..., G, D).
// kG query heads a block (q and the accumulators of kG heads x kPer
// elements live in registers).
template <typename TQ, typename T, int kPer, int kG>
__global__ void __launch_bounds__(kThreads) decode_partial_kernel(
    const TQ* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ lengths,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int s_len, int hkv, int g_all, int d,
    int chunk, float scale, bool vec) {
  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int kvh = bh - b * hkv;
  const int split = blockIdx.y;
  const int g0 = blockIdx.z * kG;
  const int gn = min(kG, g_all - g0);
  const int len = lengths[b];
  const bool masked = len <= 0;
  const int n = attended(len, s_len);
  const int s0 = split * chunk;
  if (s0 >= n) return;                 // the merge skips this split
  const int s1 = min(s0 + chunk, n);
  const int group = threadIdx.x / kGroupLanes;
  const int j = threadIdx.x % kGroupLanes;

  float qr[kG][kPer];
  const TQ* qb = q + (static_cast<long long>(b) * hkv * g_all +
                      static_cast<long long>(kvh) * g_all + g0) * d;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = j * kPer + i;
      qr[g][i] = g < gn && e < d ? to_f32(qb[g * d + e]) : 0.0f;
    }
  }
  float m[kG], l[kG], acc[kG][kPer];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kMasked;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[g][i] = 0.0f;
  }

  const long long row = static_cast<long long>(hkv) * d;   // slot stride
  const long long base = (static_cast<long long>(b) * s_len * hkv + kvh) * d;
  // every lane runs the same rounds (the shuffles need the whole warp); a
  // group whose slot lies past s1 computes on zeros and keeps its state
  const int rounds = (s1 - s0 + kGroups - 1) / kGroups;
  int s = s0 + group;
  float kr[kPer], vr[kPer];
  if (s < s1) {
    load_part<T, kPer>(k + base + s * row, j, d, vec, kr);
    load_part<T, kPer>(v + base + s * row, j, d, vec, vr);
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) kr[i] = vr[i] = 0.0f;
  }
  for (int r = 0; r < rounds; ++r, s += kGroups) {
    float kn[kPer], vn[kPer];        // the group's next slot, loaded ahead
    const int sn = s + kGroups;
    if (sn < s1) {
      load_part<T, kPer>(k + base + sn * row, j, d, vec, kn);
      load_part<T, kPer>(v + base + sn * row, j, d, vec, vn);
    }
    const bool live = s < s1;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) dot = fmaf(qr[g][i], kr[i], dot);
#pragma unroll
      for (int off = kGroupLanes / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off, kGroupLanes);
      if (live) {
        const float logit = masked ? kMasked : dot * scale;
        const float m_new = fmaxf(m[g], logit);
        const float corr = expf(m[g] - m_new);
        const float p = expf(logit - m_new);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          acc[g][i] = acc[g][i] * corr + p * vr[i];
        m[g] = m_new;
      }
    }
    if (sn < s1) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        kr[i] = kn[i];
        vr[i] = vn[i];
      }
    }
  }

  // merge the groups, one query head at a time (the lanes of a group hold
  // the same m and l: the butterfly sums are bitwise equal on all of them)
  __shared__ float sm_m[kGroups][kG];
  __shared__ float sm_l[kGroups][kG];
  __shared__ float sm_acc[kGroups][kGroupLanes * kPer];
  if (j == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      sm_m[group][g] = m[g];
      sm_l[group][g] = l[g];
    }
  }
  const int nsplit = gridDim.y;
  const long long pbase =
      (static_cast<long long>(bh) * nsplit + split) * g_all + g0;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g < gn) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPer; ++i) sm_acc[group][j * kPer + i] = acc[g][i];
      __syncthreads();
      float mx = kMasked;
#pragma unroll
      for (int w = 0; w < kGroups; ++w) mx = fmaxf(mx, sm_m[w][g]);
      for (int e = threadIdx.x; e < d; e += kThreads) {
        float a = 0.0f, sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kGroups; ++w) {
          const float c = expf(sm_m[w][g] - mx);
          a += c * sm_acc[w][e];
          sum += c * sm_l[w][g];
        }
        part_acc[(pbase + g) * d + e] = a;
        if (e == 0) {
          part_m[pbase + g] = mx;
          part_l[pbase + g] = sum;
        }
      }
    }
  }
}

// out[b, h, :] from the splits that hold slots of lane b.
template <typename T>
__global__ void decode_merge_kernel(
    const int32_t* __restrict__ lengths, const float* __restrict__ part_m,
    const float* __restrict__ part_l, const float* __restrict__ part_acc,
    T* __restrict__ out, int s_len, int h_all, int hkv, int d, int chunk,
    int nsplit) {
  const int bhq = blockIdx.x;             // b * H + h
  const int b = bhq / h_all;
  const int h = bhq - b * h_all;
  const int g_all = h_all / hkv;
  const int kvh = h / g_all;
  const int g = h - kvh * g_all;
  const int n = attended(lengths[b], s_len);
  const int live = (n + chunk - 1) / chunk;
  const long long p0 =
      (static_cast<long long>(b) * hkv + kvh) * nsplit * g_all + g;
  float mx = kMasked;
  for (int j = 0; j < live; ++j) mx = fmaxf(mx, part_m[p0 + j * g_all]);
  float sum = 0.0f;
  for (int j = 0; j < live; ++j)
    sum += expf(part_m[p0 + j * g_all] - mx) * part_l[p0 + j * g_all];
  const float norm = fmaxf(sum, 1e-30f);
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    float a = 0.0f;
    for (int j = 0; j < live; ++j) {
      const long long p = p0 + j * g_all;
      a += expf(part_m[p] - mx) * part_acc[p * d + e];
    }
    out[static_cast<long long>(bhq) * d + e] = from_f32<T>(a / norm);
  }
}

struct Args {
  const void *q, *k, *v, *lengths;
  void *out, *part_m, *part_l, *part_acc;
  int b, s_len, h_all, hkv, d, chunk;
  float scale;
  bool vec;
  cudaStream_t stream;
};

template <typename TQ, typename T, int kPer>
int launch(const Args& a) {
  constexpr int kG = kPer >= 16 ? 64 / kPer : 8;
  const int g_all = a.h_all / a.hkv;
  const int nsplit = (a.s_len + a.chunk - 1) / a.chunk;
  const dim3 grid(static_cast<unsigned>(a.b * a.hkv),
                  static_cast<unsigned>(nsplit),
                  static_cast<unsigned>((g_all + kG - 1) / kG));
  decode_partial_kernel<TQ, T, kPer, kG><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int32_t*>(a.lengths),
      static_cast<float*>(a.part_m), static_cast<float*>(a.part_l),
      static_cast<float*>(a.part_acc), a.s_len, a.hkv, g_all, a.d, a.chunk,
      a.scale, a.vec && a.d == kGroupLanes * kPer);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<TQ><<<a.b * a.h_all, 128, 0, a.stream>>>(
      static_cast<const int32_t*>(a.lengths),
      static_cast<const float*>(a.part_m),
      static_cast<const float*>(a.part_l),
      static_cast<const float*>(a.part_acc), static_cast<TQ*>(a.out),
      a.s_len, a.h_all, a.hkv, a.d, a.chunk, nsplit);
  return static_cast<int>(cudaGetLastError());
}

// The head widths of the configs: 16 (the reduced ones), 64 and 128; a
// width between them runs in the next one up, its tail read as 0.
template <typename TQ, typename T>
int by_width(const Args& a) {
  const int per = (a.d + kGroupLanes - 1) / kGroupLanes;
  if (per <= 2) return launch<TQ, T, 2>(a);
  if (per <= 8) return launch<TQ, T, 8>(a);
  return launch<TQ, T, 16>(a);
}

}  // namespace

extern "C" {

// q (b, h, d), k/v (b, s, hkv, d), lengths (b,) int32, out (b, h, d) of q's
// type, all contiguous; part_m/part_l (b * hkv, ceil(s / chunk), h / hkv)
// and part_acc (..., d) float32 scratch.  q_dtype, kv_dtype: 0 = float32,
// 1 = bfloat16.  The model's query and cache share a type; a float32 query
// on a bfloat16 cache gives float32 outputs, which is how the bfloat16
// cache is held to its plain version at float32 tolerances.  A bfloat16
// query on a float32 cache is refused.
int rt_decode_attention(const void* q, const void* k, const void* v,
                        const void* lengths, void* out, void* part_m,
                        void* part_l, void* part_acc, long long b,
                        long long s_len, long long h_all, long long hkv,
                        long long d, long long chunk, int q_dtype,
                        int kv_dtype, float scale, void* stream) {
  if (b == 0 || h_all == 0) return static_cast<int>(cudaGetLastError());
  if (s_len < 1 || hkv < 1 || h_all % hkv != 0 || d < 1 || d > 128 ||
      chunk < 1 || b * hkv >= (1LL << 31) || b * h_all >= (1LL << 31) ||
      s_len >= (1LL << 31) || (s_len + chunk - 1) / chunk > 65535 ||
      h_all / hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads need 16-byte aligned rows
  const bool vec = (reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const Args a{q, k, v, lengths, out, part_m, part_l, part_acc,
               static_cast<int>(b), static_cast<int>(s_len),
               static_cast<int>(h_all), static_cast<int>(hkv),
               static_cast<int>(d), static_cast<int>(chunk), scale, vec,
               static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && kv_dtype == 0) return by_width<float, float>(a);
  if (q_dtype == 0 && kv_dtype == 1)
    return by_width<float, __nv_bfloat16>(a);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_width<__nv_bfloat16, __nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
